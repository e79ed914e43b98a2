"""Kernel 1: the Chambolle isotropic TV prox on the H100 (counterpart of
``lmc_atomi_tpu/ops/tv_pallas.py``), its plain torch version, and the host
planner of its tile kernel, which kernel 8 (``kernels/myula_cuda.py``)
shares.

``prox_tv_iso_cuda`` launches ``csrc/tv_prox.cu``: each CTA holds a halo tile
of the image in shared memory and runs the trips on the cone its interior
reads, on the geometry and route ``prox_plan`` names; ``prox_tv_iso_ref``
computes the same function in torch ops, term for term, and is what a CPU
tensor gets.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from lmc_atomi_torch import _build

__all__ = ["prox_plan", "prox_tv_iso_cuda", "prox_tv_iso_ref", "ROUTES"]

ROUTES = ("cone", "resident", "launches")  # csrc/tv_prox.cu's route codes
_RESERVED_SMEM = 1024  # shared memory the card reserves for each CTA
_SM_THREADS = 1024  # an SM's threads of a tile kernel: 2 CTAs of 512 or 1 of 1024
# A grid barrier (or a launch boundary) in pixel passes: about 1.2 us at about
# 0.47 ns a pixel pass of a 1024-thread CTA, both measured on the H100
# (PERF.md, section 6)
_BARRIER_PASSES = 2500


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


def _trip_work(ty: int, tx: int, h: int, niter: int) -> int:
    """Pixel passes of ``niter`` trips on the cone (``csrc/block_common.cuh::
    rs_trips``): the dual's zeroing or load over the tile, then two passes a
    trip on the interior grown by ``niter - trip``."""
    w = (ty + 2 * h) * (tx + 2 * h)
    for e in range(1, niter + 1):
        g = min(e, h)
        w += 2 * (ty + 2 * g) * (tx + 2 * g)
    return w


def _free_lines(n: int, t: int, h: int) -> int:
    """Rows (or columns) of tiles of side ``t`` whose halo tile avoids image
    row ``n - 1`` without wrapping."""
    return sum(b * t - h >= 0 and (b + 1) * t + h <= n - 1
               for b in range(-(-n // t)))


def _segments(niter: int, k: int) -> int:
    """Segments of at most ``k`` trips (``csrc/tv_prox.cu::tv_segments``)."""
    return -(-niter // k) if k else 1


def _prox_work(ty: int, tx: int, k: int, niter: int, tail: bool) -> int:
    """Pixel passes of one CTA's call (``csrc/tv_prox.cu::tv_prox_tile``): x
    on the interior grown by ``k``, each segment's trips on its cone
    (``_trip_work``), the dual written on the interior after each segment but
    the last, and the finish on the interior (with the tail one more pass:
    the Philox normal)."""
    h = k + 1
    full, rest = divmod(niter, k) if k else (0, 0)
    w = (ty + 2 * k) * (tx + 2 * k) + (_segments(niter, k) + int(tail)) * ty * tx
    w += full * _trip_work(ty, tx, h, k)
    if rest or not k:
        w += _trip_work(ty, tx, h, rest)
    return w


def _tile_fits(sy: int, sx: int, per_sm: int, smem_limit: int) -> bool:
    """Whether ``per_sm`` CTAs of an ``sy x sx`` tile (x, u and the dual, the
    row and column indices) fit an SM, each reserving 1 KiB."""
    cta = 4 * 4 * sy * sx + 4 * (sy + sx)
    return cta <= smem_limit and per_sm * (cta + _RESERVED_SMEM) <= smem_limit + _RESERVED_SMEM


@functools.lru_cache(maxsize=64)
def _prox_ranking(ny: int, nx: int, niter: int, tail: bool, n_sm: int, smem_limit: int):
    """Every geometry ``prox_plan`` weighs, in the order of its ranking."""
    cands = []
    for k in range(1, niter + 1) if niter else (0,):
        h, n_seg = k + 1, _segments(niter, k)
        for threads in (512, 1024):
            per_sm = _SM_THREADS // threads
            for ty in range(8, ny + 8, 8):
                if not _tile_fits(ty + 2 * h, 8 + 2 * h, per_sm, smem_limit):
                    break  # the tile only grows with ty and tx
                for tx in range(8, nx + 8, 8):
                    if not _tile_fits(ty + 2 * h, tx + 2 * h, per_sm, smem_limit):
                        break
                    tiles = -(-ny // ty) * -(-nx // tx)
                    waves = -(-tiles // (n_sm * per_sm))
                    route = "resident" if waves == 1 else "cone" if n_seg == 1 else "launches"
                    cost = (waves * per_sm * _prox_work(ty, tx, k, niter, tail)
                            + (n_seg - 1) * _BARRIER_PASSES)
                    cands.append((route == "launches", cost, threads, ty, tx, k, route, tiles))
        if not _tile_fits(8 + 2 * h, 8 + 2 * h, 1, smem_limit):
            break  # a deeper halo fits nowhere either
    return tuple((route, ty, tx, k + 1, k, threads,
                  tiles - _free_lines(ny, ty, k + 1) * _free_lines(nx, tx, k + 1), tiles)
                 for _, _, threads, ty, tx, k, route, tiles in sorted(cands))


def prox_plan(shape, niter: int, tail: bool, n_sm: int, smem_limit: int):
    """The geometry and route of kernel 1 (``tail`` false) or kernel 8
    (``tail`` true) on a card of ``n_sm`` SMs whose CTA takes at most
    ``smem_limit`` bytes of shared memory: ``(route, ty, tx, h, k, threads,
    edge_tiles, tiles)``, or ``None`` when no tile fits.

    The trips run in segments of at most ``k`` on tiles of halo ``h = k + 1``.
    Candidates are the interiors ``ty x tx`` (multiples of 8) at 512 threads
    a CTA (two CTAs an SM) or 1024 (one) and every ``k`` from 1 to ``niter``,
    whose shared memory (x, u and the dual on the tile, the row and column
    indices) fits, each CTA reserving 1 KiB of the SM's ``smem_limit +
    1024``. A candidate whose tiles fit on the card at once (one wave) takes
    the ``"resident"`` route: one cooperative launch, the dual exchanged
    through device memory and a grid barrier between two segments. Otherwise
    ``k = niter`` takes the ``"cone"`` route, one plain launch, and a
    smaller ``k`` the ``"launches"`` route, one launch a segment. A call
    costs the waves ``ceil(tiles / (n_sm * per_sm))`` times the CTAs of a
    wave on an SM times one CTA's pixel passes (``_prox_work``), plus
    ``_BARRIER_PASSES`` for each barrier or launch between two segments.
    The one-launch routes rank before ``"launches"``, then the least cost
    wins, ties to fewer threads, then the smaller ``ty``, ``tx`` and ``k``.
    ``edge_tiles`` counts the tiles that are not edge-free. Computed once per
    shape and options: the wrappers ask on every call."""
    ranking = _prox_ranking(int(shape[0]), int(shape[1]), int(niter), bool(tail),
                            int(n_sm), int(smem_limit))
    return ranking[0] if ranking else None


def _launch_prox_tile(x, grad, niter: int, step: float, coef, with_noise: bool = False,
                      key=(0, 0, 0)):
    """``csrc/tv_prox.cu`` on ``x`` (kernel 1; kernel 8 with ``grad``) on
    ``prox_plan``'s geometry for the card: ``coef`` the launcher's 5 floats,
    ``key`` the noise's ``(seed, chain, step)``. Returns ``(out, plan)``;
    raises when no tile fits or the launch fails."""
    ny, nx = x.shape
    tail = grad is not None
    n_sm, smem_limit = _build.card_limits(x.device)
    plan = prox_plan((ny, nx), niter, tail, n_sm, smem_limit)
    if plan is None:
        raise ValueError(f"no TV prox tile fits {smem_limit} bytes of shared memory")
    route, ty, tx, _, k, threads = plan[:6]
    n_seg = _segments(niter, k)
    # the dual between two segments: one (y, x) pair of planes, two with more
    # than one exchange
    dual = (torch.empty((2 * min(n_seg - 1, 2), ny, nx), dtype=x.dtype, device=x.device)
            if n_seg > 1 else None)
    out = torch.empty_like(x)
    coef = np.array(coef, np.float32)
    seed, chain, g = (int(v) & 0xFFFFFFFF for v in key)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmc_tv_prox(
            x.data_ptr(), None if grad is None else grad.data_ptr(), out.data_ptr(),
            None if dual is None else dual.data_ptr(), ny, nx, int(niter), float(step),
            coef.ctypes.data, int(tail), int(bool(with_noise)), seed, chain, g,
            ROUTES.index(route), ty, tx, k, threads, stream)
    _build.check(rc, "lmc_tv_prox")
    return out, plan


def prox_tv_iso_cuda(x, gamma, niter: int = 10, step: float = 0.25):
    """Kernel 1 on a contiguous float32 CUDA image of shape (ny, nx), both
    >= 2, on the route ``prox_plan`` names (counted in ``routes``, the plan
    in ``last_plan``). Raises on anything else, a CPU tensor included, and
    when no tile fits the card."""
    _build.require_cuda_f32(None, x=x)
    if x.ndim != 2 or min(x.shape) < 2:
        raise ValueError(f"prox_tv_iso_cuda takes an (ny, nx) image, got {tuple(x.shape)}")
    # a negative trip count runs no trip, as in the plain version
    out, plan = _launch_prox_tile(x, None, max(int(niter), 0), step,
                                  (float(gamma), 0.0, 0.0, 0.0, 0.0))
    prox_tv_iso_cuda.launches += 1
    prox_tv_iso_cuda.routes[plan[0]] += 1
    prox_tv_iso_cuda.last_plan = plan
    return out


prox_tv_iso_cuda.launches = 0  # calls that launched the kernel
prox_tv_iso_cuda.routes = dict.fromkeys(ROUTES, 0)  # calls per route
prox_tv_iso_cuda.last_plan = None  # the last call's prox_plan
