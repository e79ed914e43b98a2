"""Kernel 1: the Chambolle isotropic TV prox on the H100 (counterpart of
``lmc_atomi_tpu/ops/tv_pallas.py``), and its plain torch version.

``prox_tv_iso_cuda`` launches ``csrc/tv_prox.cu`` (one launch per dual trip
plus one for ``x - gamma div p``); ``prox_tv_iso_ref`` computes the same
function in torch ops, term for term, and is what a CPU tensor gets.
"""
from __future__ import annotations

import torch

from lmc_atomi_torch import _build

__all__ = ["prox_tv_iso_cuda", "prox_tv_iso_ref"]


def _stencils(x, masks=None):
    """Forward differences and divergence of tv_pallas.py (roll + mask
    multiply, zeroed last row/column) for fields shaped like ``x``.
    ``masks = (my, mx)`` replaces the zeroed last row/column, as for a halo
    tile (``myula_tiled._band_masks``)."""
    ny, nx = x.shape
    if masks is not None:
        my, mx = masks
    else:
        my = (torch.arange(ny, device=x.device) < ny - 1).to(x.dtype)[:, None]
        mx = (torch.arange(nx, device=x.device) < nx - 1).to(x.dtype)[None, :]

    def fwd_y(a):
        return (torch.roll(a, -1, 0) - a) * my

    def fwd_x(a):
        return (torch.roll(a, -1, 1) - a) * mx

    def div(py, px):
        pym = py * my
        pxm = px * mx
        return (pym - torch.roll(pym, 1, 0)) + (pxm - torch.roll(pxm, 1, 1))

    return fwd_y, fwd_x, div


def prox_tv_iso_ref(x, gamma, niter: int = 10, step: float = 0.25):
    """Plain torch version of kernel 1: ``niter`` Chambolle trips
    ``p <- (p + s grad u) / (1 + s |grad u|)``, ``u = div p - x/gamma``, from a
    zero dual; returns ``x - gamma div p``."""
    fwd_y, fwd_x, div = _stencils(x)
    xg = x / gamma
    py = torch.zeros_like(x)
    px = torch.zeros_like(x)
    for _ in range(niter):
        u = div(py, px) - xg
        gy = fwd_y(u)
        gx = fwd_x(u)
        mag = torch.sqrt(gy * gy + gx * gx)
        denom = 1.0 + step * mag
        py, px = (py + step * gy) / denom, (px + step * gx) / denom
    return x - gamma * div(py, px)


def prox_tv_iso_cuda(x, gamma, niter: int = 10, step: float = 0.25):
    """Kernel 1 on a contiguous float32 CUDA image of shape (ny, nx), both
    >= 2. Raises on anything else, a CPU tensor included."""
    _build.require_cuda_f32(None, x=x)
    if x.ndim != 2 or min(x.shape) < 2:
        raise ValueError(f"prox_tv_iso_cuda takes an (ny, nx) image, got {tuple(x.shape)}")
    ny, nx = x.shape
    lib = _build.library()
    out = torch.empty_like(x)
    dual = torch.empty((4, ny, nx), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmc_tv_prox_chambolle(
            x.data_ptr(), out.data_ptr(), dual[0].data_ptr(),
            dual[1].data_ptr(), dual[2].data_ptr(), dual[3].data_ptr(),
            ny, nx, float(gamma), int(niter), float(step), stream,
        )
    _build.check(rc, "lmc_tv_prox_chambolle")
    prox_tv_iso_cuda.launches += 1
    return out


prox_tv_iso_cuda.launches = 0  # calls that launched the kernel
