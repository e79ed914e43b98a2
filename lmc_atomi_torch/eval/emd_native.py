"""ctypes binding to the native exact-EMD network simplex (native/emd.cpp);
the port's own copy of ``lmc_atomi_tpu/eval/emd_native.py`` (the port imports
nothing of the JAX package).

Replaces the reference's POT ``ot.emd2`` (C++ network simplex, OpenMP;
reference lmc.py:403-406). The shared library is built on first use from
``native/emd.cpp`` with ``native/Makefile``'s flags, by calling the compiler
directly, into the git-ignored ``lmc_atomi_torch/_build/`` (the JAX package
builds its own ``native/libemd.so``; the two never share a file). Concurrent
first uses (pytest workers) serialise on a file lock, and the library is
compiled under a temporary name and moved into place with ``os.replace``, so
no process loads a half-written file. Without a C++ toolchain the caller
should fall back to
:func:`lmc_atomi_torch.eval.wasserstein.exact_w2_assignment` (equal weights)
or Sinkhorn.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_ROOT, "native", "emd.cpp")
_BUILD_DIR = os.path.join(_ROOT, "lmc_atomi_torch", "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libemd.so")
# native/Makefile's CXXFLAGS
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-Wall"]
_lib = None


def _compile() -> bool:
    """Compile the library unless it is there, under an exclusive lock."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(_LIB_PATH + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_LIB_PATH):
            return True
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        try:
            subprocess.run([os.environ.get("CXX", "g++"), *_CXXFLAGS, "-shared", "-o", tmp,
                            _SOURCE], check=True, capture_output=True, timeout=120)
            os.replace(tmp, _LIB_PATH)
        except (subprocess.SubprocessError, OSError):
            if os.path.exists(tmp):
                os.remove(tmp)
            return False
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not _compile():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.emd_exact.restype = ctypes.c_int
    lib.emd_exact.argtypes = [
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.emd_num_threads.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def emd2(
    a: np.ndarray,
    b: np.ndarray,
    cost: np.ndarray,
    max_pivots: int = 0,
    return_flow: bool = False,
) -> Tuple[float, Optional[np.ndarray]]:
    """Exact optimal-transport cost <G*, C> for histograms a (n,), b (m,)
    and cost matrix C (n, m). ``max_pivots<=0`` means unlimited."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native EMD library unavailable (no C++ toolchain?)")
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    cost = np.ascontiguousarray(cost, np.float64)
    n, m = cost.shape
    assert a.shape == (n,) and b.shape == (m,)
    out = ctypes.c_double(0.0)
    flow = np.zeros((n, m), np.float64) if return_flow else None
    dptr = ctypes.POINTER(ctypes.c_double)
    rc = lib.emd_exact(
        n,
        m,
        a.ctypes.data_as(dptr),
        b.ctypes.data_as(dptr),
        cost.ctypes.data_as(dptr),
        max_pivots,
        ctypes.byref(out),
        flow.ctypes.data_as(dptr) if return_flow else None,
    )
    if rc != 0:
        raise RuntimeError(f"emd_exact failed with code {rc}")
    return out.value, flow


def exact_w2(x: np.ndarray, y: np.ndarray) -> float:
    """Exact squared W2 between uniform empirical measures (any sizes).

    1-D inputs of shape (n,) are treated as n samples in d=1 (matching the
    POT ``ot.dist`` convention this replaces)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if y.ndim == 1:
        y = y[:, None]
    c = ((x[:, None, :] - y[None, :, :]) ** 2).sum(-1)
    a = np.full(x.shape[0], 1.0 / x.shape[0])
    b = np.full(y.shape[0], 1.0 / y.shape[0])
    val, _ = emd2(a, b, c)
    return float(val)
