"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` inside
the package (listed in .gitignore), then loaded with ctypes. The hash covers
the source, every header of ``csrc/`` it includes (``#include "x.cuh"``,
followed recursively) and the flags, so an edited source or shared header
is rebuilt and a stale library is never loaded. Nothing here runs when a module is imported: the
CPU tests import every module on a machine without nvcc.
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


def source_files(name: str) -> list:
    """csrc/<name>.cu and the csrc headers it includes, recursively."""
    files, todo = [], [f"{name}.cu"]
    while todo:
        path = os.path.join(CSRC, todo.pop())
        if path in files:
            continue
        files.append(path)
        with open(path, "rb") as f:
            todo += [m.decode() for m in _LOCAL_INCLUDE.findall(f.read())]
    return files


def _build(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        with open(path, "rb") as f:
            digest.update(path[len(CSRC):].encode() + f.read())
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{build_logs[name]}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu (built on first call)."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_build(name))
        return _libs[name]


def entry(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of csrc/<name>.cu with its argument types
    set (pointers and the stream as c_void_p); it returns the CUDA error of
    the launch."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(err: int, what: str):
    """Raise if a launch returned a CUDA error: nothing falls back."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def build_all() -> list:
    """Build every csrc/*.cu in parallel (one nvcc each); returns names."""
    names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    with ThreadPoolExecutor(max(1, len(names))) as ex:
        list(ex.map(_build, names))
    return names
