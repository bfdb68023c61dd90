"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` inside
the package (listed in .gitignore), then loaded with ctypes. The hash covers
the source, every header of ``csrc/`` it includes (``#include "x.cuh"``,
followed recursively) and the flags, so an edited source or shared header
is rebuilt and a stale library is never loaded. Nothing here runs when a
module is imported: the CPU tests import every module on a machine without
nvcc.

A library may also be built from another source directory, such as an
older checkout's ``csrc``: ``load(name, csrc=...)``. It has the same C
interface and its own hash. The wrappers launch the library cached under
``name``, looked up at every launch (``entry``), so
``scripts/fused_blend_ab.py`` can swap another build in under that name and
time the two against each other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false: no multiply-add contraction, so each kernel rounds every
# product and sum exactly as its plain PyTorch version does (elementwise
# torch ops round each step); kernel and plain version then agree bit for
# bit on every keep/stop decision at the 1/255 and T_EPS edges.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: dict = {}
_lock = threading.Lock()
build_logs: dict = {}  # name -> nvcc's output (ptxas register/smem report)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(name: str, csrc: str = CSRC) -> list:
    """csrc/<name>.cu and the csrc headers it includes, recursively."""
    files, todo = [], [f"{name}.cu"]
    while todo:
        path = os.path.join(csrc, todo.pop())
        if path in files:
            continue
        files.append(path)
        with open(path, "rb") as f:
            todo += [m.decode() for m in _LOCAL_INCLUDE.findall(f.read())]
    return files


def nvcc_command(name: str, out: str, csrc: str = CSRC) -> list:
    """The nvcc command line that builds csrc/<name>.cu into `out`."""
    return [_nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(csrc, f"{name}.cu")]


def library_path(name: str, csrc: str = CSRC) -> str:
    """_build/lib<name>-<hash>.so, the hash over the flags and the source
    with its headers (paths relative to csrc)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name, csrc):
        with open(path, "rb") as f:
            digest.update(path[len(csrc):].encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _build(name: str, csrc: str = CSRC) -> str:
    """Build csrc/<name>.cu unless its library exists; nvcc's output goes to
    build_logs and beside the library (lib<name>-<hash>.log), whence a later
    process that finds the library built reads it."""
    so = library_path(name, csrc)
    key = _key(name, csrc)
    log = so[:-3] + ".log"
    if os.path.exists(so):
        if key not in build_logs and os.path.exists(log):
            with open(log) as f:
                build_logs[key] = f.read()
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # one name per process and thread: two builds of equal sources (another
    # tree's copy) may run at once, and the last to finish wins
    tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(nvcc_command(name, f"{so}.{tag}", csrc),
                          capture_output=True, text=True)
    build_logs[key] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{build_logs[key]}")
    with open(f"{log}.{tag}", "w") as f:
        f.write(build_logs[key])
    os.replace(f"{log}.{tag}", log)
    os.replace(f"{so}.{tag}", so)  # atomic: a loader sees all or nothing
    return so


def _key(name: str, csrc: str = CSRC):
    """name for this package's source, else (name, csrc)."""
    return name if csrc == CSRC else (name, csrc)


def load(name: str, csrc: str = CSRC) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu (built on first call)."""
    key = _key(name, csrc)
    with _lock:
        if key not in _libs:
            _libs[key] = ctypes.CDLL(_build(name, csrc))
        return _libs[key]


def entry(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of csrc/<name>.cu with its argument types
    set (pointers and the stream as c_void_p); it returns the CUDA error of
    the launch. The library is looked up (``load(name)``) at every call, and
    the wrappers call this at every launch: a library put in ``_libs[name]``
    is the one they launch next (``scripts/fused_blend_ab.py`` relies on
    it)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(err: int, what: str):
    """Raise if a launch returned a CUDA error: nothing falls back."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def build_all(builds=None) -> list:
    """Build in parallel (one nvcc each) the given (name,) or (name, csrc)
    argument tuples of load, by default (name,) of every csrc/*.cu; returns
    the tuples."""
    if builds is None:
        builds = [(f[:-3],) for f in sorted(os.listdir(CSRC))
                  if f.endswith(".cu")]
    with ThreadPoolExecutor(max(1, len(builds))) as ex:
        list(ex.map(lambda b: _build(*b), builds))
    return builds
