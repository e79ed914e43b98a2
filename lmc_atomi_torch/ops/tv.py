"""Total-variation values and proxes (counterpart of
``lmc_atomi_tpu/ops/tv.py``).

Forward differences with a zeroed last slot (Neumann boundary, in roll+mask
form) and their negative adjoint. ``prox_tv_iso`` dispatches by the tensor's
device: the hand-written CUDA Chambolle kernel for a CUDA tensor, its plain
torch version otherwise (``ops/tv_cuda.py``); an image split over ranks
(``parallel.shard_image``) runs the same dispatch on each rank's block
extended by a halo (``ops/sharded.py``).
"""
from __future__ import annotations

import torch

from lmc_atomi_torch.ops.tv_cuda import prox_tv_iso_cuda, prox_tv_iso_ref
from lmc_atomi_torch.ops.sharded import halo_map, is_sharded

__all__ = [
    "grad2d",
    "div2d",
    "tv_iso",
    "tv_aniso",
    "tv1d",
    "prox_tv_iso",
    "prox_tv_iso_proj",
    "fgp_momentum",
    "prox_tv_aniso",
    "prox_tv1d",
]


def _last_mask(x, axis):
    """1.0 everywhere except the last slot along ``axis``, shaped to
    broadcast against ``x``."""
    n = x.shape[axis]
    m = (torch.arange(n, device=x.device) < n - 1).to(x.dtype)
    shape = [1] * x.ndim
    shape[axis] = n
    return m.reshape(shape)


def _fwd_diff(x, axis):
    return (torch.roll(x, -1, axis) - x) * _last_mask(x, axis)


def _fwd_diff_adjoint_neg(p, axis):
    pm = p * _last_mask(p, axis)
    return pm - torch.roll(pm, 1, axis)


def grad2d(x):
    """Forward differences, Neumann boundary: shape (2, ny, nx)."""
    return torch.stack([_fwd_diff(x, 0), _fwd_diff(x, 1)])


def div2d(p):
    """Discrete divergence, the negative adjoint of :func:`grad2d`."""
    return _fwd_diff_adjoint_neg(p[0], 0) + _fwd_diff_adjoint_neg(p[1], 1)


def tv_iso(x):
    """Isotropic TV value: sum of per-pixel gradient-vector norms."""
    g = grad2d(x)
    return torch.sum(torch.sqrt(torch.sum(g * g, dim=0)))


def tv_aniso(x):
    """Anisotropic TV value: l1 norm of all forward differences."""
    return torch.sum(torch.abs(grad2d(x)))


def tv1d(x):
    """1-D TV of a flattened signal (the ME-TV anisotropic mode's prior,
    reference algs.py:169-170)."""
    return torch.sum(torch.abs(x[1:] - x[:-1]))


def prox_tv_iso(x, gamma, niter: int = 10, step: float = 0.25,
                backend: str = "auto"):
    """Prox of ``gamma * TV_iso`` via Chambolle's dual projection:
    ``p <- (p + step grad(div p - x/gamma)) / (1 + step |...|)``, then
    ``x - gamma div p``.

    ``backend`` as in the JAX package: ``"auto"`` sends a CUDA tensor to the
    hand kernel (``prox_tv_iso_cuda``) and any other to its plain version,
    ``"xla"`` forces the plain version (``prox_tv_iso_ref``), ``"pallas"``
    the kernel, which raises on a CPU tensor. A sharded image (a DTensor of
    ``parallel.shard_image``) runs that choice on each rank's block extended
    by ``niter + 1`` rows and columns of its neighbours (the depth a trip's
    error travels, ``kernels/myula_tiled.py::_halo_need``) and keeps the
    block: the whole-image prox, pixel for pixel."""
    if backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"backend must be 'auto', 'xla' or 'pallas', got {backend!r}")
    if is_sharded(x):
        return halo_map(lambda b: prox_tv_iso(b, gamma, niter, step, backend), x,
                        max(int(niter), 0) + 1)
    if backend == "pallas" or (backend == "auto" and x.is_cuda):
        return prox_tv_iso_cuda(x, gamma, niter=niter, step=step)
    return prox_tv_iso_ref(x, gamma, niter=niter, step=step)


def fgp_momentum(niter: int):
    """FGP (FISTA) momentum coefficients ``(t_k - 1) / t_{k+1}`` for a fixed
    trip count, as Python floats (Beck & Teboulle 2009, eq. 4.2-4.3)."""
    t, out = 1.0, []
    for _ in range(niter):
        t_next = 0.5 * (1.0 + (1.0 + 4.0 * t * t) ** 0.5)
        out.append((t - 1.0) / t_next)
        t = t_next
    return tuple(out)


def prox_tv_iso_proj(x, gamma, niter: int = 10, step: float = 0.125,
                     accel: bool = True):
    """Prox of ``gamma * TV_iso`` via projected dual ascent
    ``p <- p~ * min(1, 1/|p~|)``, with FGP momentum when ``accel``."""
    xg = x / gamma

    def proj(p):
        s = torch.sum(p * p, dim=0, keepdim=True)
        return p * torch.rsqrt(s).clamp(max=1.0)

    def ascend(r):
        return proj(r + step * grad2d(div2d(r) - xg))

    p = torch.zeros((2,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    if accel:
        r = p
        for c in fgp_momentum(niter):
            q = ascend(r)
            r = q + c * (q - p)
            p = q
    else:
        for _ in range(niter):
            p = ascend(p)
    return x - gamma * div2d(p)


def prox_tv_aniso(x, gamma, niter: int = 10, step: float = 0.25):
    """Prox of ``gamma * TV_aniso`` via the dual projection with the
    per-component box ``|p_i| <= 1`` (the anisotropic dual ball)."""
    p = torch.zeros((2,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    for _ in range(niter):
        g = grad2d(div2d(p) - x / gamma)
        p = (p + step * g) / (1.0 + step * torch.abs(g))
    return x - gamma * div2d(p)


def _grad1d(x):
    return _fwd_diff(x, 0)


def _div1d(p):
    return _fwd_diff_adjoint_neg(p, 0)


def prox_tv1d(x, gamma, niter: int = 10, step: float = 0.25):
    """Prox of 1-D TV on a flat vector (dual projection, fixed trips)."""
    p = torch.zeros_like(x)
    for _ in range(niter):
        g = _grad1d(_div1d(p) - x / gamma)
        p = (p + step * g) / (1.0 + step * torch.abs(g))
    return x - gamma * _div1d(p)
