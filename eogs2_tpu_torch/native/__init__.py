"""Native (C++/OpenMP) host code: the DSM registration of ``dsmr.cpp``.

Counterpart of ``eogs2_tpu/native``. ``dsmr.cpp`` is compiled by ``g++ -O3
-fopenmp`` at first use into ``eogs2_tpu_torch/_build/libdsmr-<hash>.so``
(``ops/cuda_build.hashed_library``: the hash covers the source and the
flags; ``build_library`` builds under a temporary name and renames, so
concurrent builds never load a half-written library) and loaded with
ctypes. If the build fails with ``-march=native``, it is retried without
(no result depends on it).

Departure from JAX: JAX's loader falls back to the numpy registration when
g++ fails. Here a failed build raises with g++'s output; the numpy version
(``eval/registration.py``) is the plain version the tests hold this one
against, and no path falls back to it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from eogs2_tpu_torch.ops import cuda_build

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "dsmr.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")
_lock = threading.Lock()
_lib = None


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the DSM registration is built "
                           "from eogs2_tpu_torch/native/dsmr.cpp at first use")
    return gxx


def _build() -> str:
    """Build dsmr.cpp (first with GXX_FLAGS, then without -march=native);
    returns the library's path or raises with both compilers' output."""
    errors = []
    for flags in (GXX_FLAGS, tuple(f for f in GXX_FLAGS
                                   if f != "-march=native")):
        so = cuda_build.hashed_library("dsmr", [SOURCE], flags, _HERE)
        try:
            cuda_build.build_library(
                so, lambda out: [_gxx(), *flags, SOURCE, "-o", out],
                "g++ on dsmr.cpp")
            return so
        except RuntimeError as e:
            errors.append(f"{' '.join(flags)}: {e}")
    raise RuntimeError("the DSM registration did not build:\n"
                       + "\n".join(errors))


def get_lib() -> ctypes.CDLL:
    """The native library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            dp = ctypes.POINTER(ctypes.c_double)
            lib.compute_shift.argtypes = [dp, dp, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_int, dp]
            lib.compute_shift.restype = None
            lib.apply_shift.argtypes = [dp, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_double, ctypes.c_double,
                                        ctypes.c_double, ctypes.c_double, dp]
            lib.apply_shift.restype = None
            _lib = lib
        return _lib


def _as_c(arr):
    """A C-contiguous float64 [H, W] copy (or view) and its pointer."""
    a = np.ascontiguousarray(arr, np.float64)
    if a.ndim != 2:
        raise ValueError(f"a DSM must be 2-D, got shape {a.shape}")
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def compute_shift(dsm_ref, dsm_sec, scaling=True):
    """(dx, dy, a, b) registering dsm_sec onto dsm_ref (dsmr.py:198-225);
    eval/registration.compute_shift is its plain version."""
    ref, ref_p = _as_c(dsm_ref)
    sec, sec_p = _as_c(dsm_sec)
    if ref.shape != sec.shape:
        raise ValueError(f"DSM shapes differ: {ref.shape} and {sec.shape}")
    out = np.zeros(4, np.float64)
    get_lib().compute_shift(ref_p, sec_p, ref.shape[0], ref.shape[1],
                            1 if scaling else 0,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return int(out[0]), int(out[1]), float(out[2]), float(out[3])


def apply_shift(in_dsm, dx=0, dy=0, a=1.0, b=0.0, c=0.0, d=0.0):
    """out[j, i] = a * in[j + dy, i + dx] + b + c i + d j, NaN outside
    (dsmr.py:183-194); eval/registration.apply_shift is its plain
    version."""
    v, v_p = _as_c(in_dsm)
    out = np.zeros_like(v)
    get_lib().apply_shift(v_p, v.shape[0], v.shape[1], int(dx), int(dy),
                          float(a), float(b), float(c), float(d),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out
