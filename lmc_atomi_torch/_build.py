"""Build and bind the port's CUDA kernels.

``csrc/*.cu`` compile with one ``nvcc`` process per source, all started
together, and link into a shared library with a plain C interface, loaded
with ``ctypes``. The library lands in ``_build/``
beside this file (git-ignored), named by a hash of the sources and of
``nvcc --version``, so an edited source or another toolkit builds anew and an
unchanged tree reuses its build. The build runs the first time a CUDA entry
point is called, never on import. There is no fallback: a missing ``nvcc`` or a
failed compile raises with the compiler's output.

``--fmad=false`` keeps ``a * b + c`` as two rounded operations, the way the
plain torch versions compute them, so kernels and plain versions agree bit
for bit (see ``csrc/tv_common.cuh``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "find_nvcc", "build", "library", "card_limits", "require_cuda_f32", "check_steps",
    "check", "NVCC_FLAGS",
]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "--fmad=false", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_U = ctypes.c_uint

# argtypes of each extern "C" launcher; every one returns a cudaError_t as int
_SIGNATURES = {
    "lmc_tv_prox": (
        _P, _P, _P, _P, _I, _I,  # x, grad, out, dual, ny, nx
        _I, _F, _P, _I, _I,  # niter, step, coef, tail, with_noise
        _U, _U, _U,  # seed, chain, step
        _I, _I, _I, _I, _I,  # route, ty, tx, k, threads
        _P,  # stream
    ),
    "lmc_myula_block": (
        _P, _P, _P, _P, _P, _P, _P,  # x, parity, atbs, mean, m2, qh, qn
        _P, _P, _P, _P, _P,  # grad, tmp, duals, aux, plan
        _I, _I, _I, _P,  # ny, nx, n_chains, chains
        _P, _I, _I, _I, _I, _I,  # taps, rank, ky, kx, oy, ox
        _I, _I, _F, _I, _P,  # n_steps, niter_tv, tv_step, fgp, fgp_coef
        _I, _I, _I,  # tv_warm, mode, niter_inner
        _I, _I,  # with_noise, with_stats
        _P, _I, _I,  # qcoef, n_q, thin
        _P,  # coef
        _U, _U, _LL, _LL, _LL,  # seed, chain, step0, burn, cnt0
        _P,  # stream
    ),
    "lmc_ulpda_block": (
        _P, _P, _P, _P, _P, _P, _P, _P,  # x, parity, py, px, xbar, atb, mean, m2
        _P, _P, _P, _P, _P, _P, _P,  # v, rhs, u, d, gu, tmp, aux
        _I, _I, _I, _P,  # ny, nx, n_chains, chains
        _P, _I, _I, _I, _I, _I,  # taps, rank, ky, kx, oy, ox
        _I, _I, _P,  # n_steps, niter_solve, cheb
        _I, _I, _I, _I, _I,  # gfirst, dual, levels, rh, rw
        _I, _I,  # mode, niter_inner
        _F, _I, _P, _I,  # tv_step, fgp, fgp_coef, env_warm
        _I, _I, _P,  # with_noise, with_stats, coef
        _U, _U, _LL, _LL, _LL,  # seed, chain, step0, burn, cnt0
        _I, _I, _I, _P,  # ty, tx, per, ub (the resident route)
        _P,  # stream
    ),
    "lmc_wavelet_block": (
        _P, _P, _P, _P, _P, _P, _P, _P,  # x, y, m, mean, m2, qh, qn, bufs
        _I, _I, _I, _P,  # ny, nx, n_chains, chains
        _I, _P,  # taps, filt
        _I, _I, _I, _I, _I, _I,  # levels, route, gh, gw, per, n_steps
        _I, _I,  # with_noise, with_stats
        _P, _I, _I, _P,  # qcoef, n_q, thin, coef
        _U, _U, _LL, _LL, _LL,  # seed, chain, step0, burn, cnt0
        _P,  # stream
    ),
    "lmc_ulpda_wavelet_block": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P,  # x, c, xbar, y, m, mean, m2, qh, qn
        _P, _I, _I, _I, _P,  # bufs, ny, nx, n_chains, chains
        _I, _P,  # taps, filt
        _I, _I, _I, _I, _I, _I, _I,  # levels, route, gh, gw, per, n_steps, gfirst
        _I, _I,  # with_noise, with_stats
        _P, _I, _I, _P,  # qcoef, n_q, thin, coef
        _U, _U, _LL, _LL, _LL,  # seed, chain, step0, burn, cnt0
        _P,  # stream
    ),
    "lmc_myula_tiled": (
        _P, _P, _P, _P, _P, _P, _P,  # x, parity, atbs, mean, m2, qh, qn
        _I, _I, _I, _P,  # ny, nx, n_chains, chains
        _P, _I, _I, _I, _I, _I,  # taps, rank, ky, kx, oy, ox
        _I, _I, _F, _I, _P,  # n_steps, niter_tv, tv_step, fgp, fgp_coef
        _I, _I, _I,  # mode, niter_inner, with_noise
        _P, _I, _I, _P,  # qcoef, n_q, thin, coef
        _U, _U, _LL, _LL, _LL,  # seed, chain, step0, burn, cnt0
        _I, _I, _I, _P,  # ty, tx, threads, stream
    ),
    "lmc_card_limits": (_P,),  # out: SMs, opt-in shared memory a CTA
    "lmc_ulpda_tiled": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P,  # x, xp, py, px, atb, mean, m2, qh, qn
        _I, _I, _I, _P,  # ny, nx, n_chains, chains
        _P, _I, _I, _I, _I, _I,  # taps, rank, ky, kx, oy, ox
        _I, _I, _P,  # n_steps, niter_solve, cheb
        _I, _I, _I, _I, _I,  # gfirst, dual, mode, niter_inner, with_noise
        _P, _I, _I, _P,  # qcoef, n_q, thin, coef
        _U, _U, _LL, _LL, _LL,  # seed, chain, step0, burn, cnt0
        _I, _I, _I, _P,  # ty, tx, threads, stream
    ),
}


def find_nvcc() -> str:
    """Path of ``nvcc`` from ``PATH`` or ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``); raises ``RuntimeError`` when there is none."""
    cuda_bin = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
    search = os.pathsep.join([os.environ.get("PATH", ""), str(cuda_bin)])
    nvcc = shutil.which("nvcc", path=search)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or in $CUDA_HOME/bin: the CUDA kernels of "
            "lmc_atomi_torch are built from csrc/ at first use and need the "
            "CUDA toolkit"
        )
    return nvcc


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile ``csrc/*.cu`` (once per source hash and toolkit) and return the
    path of the shared library."""
    nvcc = find_nvcc()
    version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout
    h = hashlib.sha256(version.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"liblmc_atomi_torch_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    tmp = BUILD_DIR / f"{tag}_{lib.name}"
    jobs = []
    try:
        for src in sorted(CSRC.glob("*.cu")):
            obj = BUILD_DIR / f"{tag}_{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for cmd, _, job in jobs:
            _, err = job.communicate()
            if job.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({job.returncode}): {' '.join(cmd)}\n{err}")
        cmd = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
               "-o", str(tmp), *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for _, obj, job in jobs:
            if job.poll() is None:
                job.kill()
                job.wait()
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


_CARD_LIMITS = {}  # device index -> (SMs, opt-in shared memory a CTA)


def card_limits(device: torch.device):
    """The SM count and the opt-in shared memory of a CTA of ``device``, as
    the CUDA runtime reports them (the planners of kernels 1, 3 and 6-8)."""
    if device.index not in _CARD_LIMITS:
        out = np.zeros(2, np.int32)
        with torch.cuda.device(device):
            check(library().lmc_card_limits(out.ctypes.data), "lmc_card_limits")
        _CARD_LIMITS[device.index] = tuple(int(v) for v in out)
    return _CARD_LIMITS[device.index]


def require_cuda_f32(shape, **tensors) -> None:
    """Raise unless every tensor is a contiguous float32 CUDA tensor of
    ``shape`` (``None`` skips the shape check) on one device."""
    devices = set()
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(
                f"{name} lies on {t.device}: the CUDA kernel takes CUDA "
                "tensors (CPU tensors go to the plain version)"
            )
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


def check_steps(scal_i, n_steps: int):
    """``(step0, burn_in, count0)`` from ``scal_i``; raises when the steps
    ``[step0, step0 + n_steps)`` or the burn-in leave the kernels' uint32
    step counter."""
    step0, burn, cnt0 = (int(v) for v in scal_i)
    if step0 < 0 or burn < 0 or step0 + n_steps > 0xFFFFFFFF:
        raise ValueError(f"steps [{step0}, {step0 + n_steps}) or burn-in {burn} "
                         "outside the kernel's uint32 step counter")
    return step0, burn, cnt0


def check(rc: int, name: str) -> None:
    """Raise on a launcher's nonzero return (a cudaError_t, or -1 for
    arguments the launcher refuses)."""
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: error {rc}")
