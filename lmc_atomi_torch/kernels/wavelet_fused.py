"""Fused wavelet-l1 MYULA and wavelet-dual ULPDA for the inpainting posterior
(counterpart of ``lmc_atomi_tpu/kernels/wavelet_fused.py``): kernels 4 and
5, their plain torch versions, the interleaved transforms, and the host-side
block loops.

Kernel 4 (``wavelet_block_update``) runs ``n_steps`` MYULA steps of
``kernels/imaging.py::myula_imaging`` on ``L2Data(Mask)`` with the prior
``OrthogonalL1``:

    x <- (1 - tau/gamma) x - tau (sig m)(m x - y)
         + (tau/gamma) W^T soft(W x, epsg gamma lam) + noise_scale sqrt(2 tau) xi

Kernel 5 (``ulpda_wavelet_block_update``) runs ``n_steps`` ULPDA steps with
the dual ``c`` in the wavelet coefficient domain (its prox the l-inf clip)
and the closed-form mask prox ``(v + ts m y) / (1 + ts m)``, ``ts = tau sig``:

    x' = (x - tau W^T c + ts m y) / (1 + ts m) + noise_scale sqrt(2 tau) xi
    xbar = x' + theta (x' - x);  c <- clip(c + mu W xbar, -g_sigma, g_sigma)

(the dual update first with ``gfirst``). ``W`` is the orthogonal multi-level
DWT in INTERLEAVED layout: level-l coefficients stay on the stride-2^l
lattice instead of Mallat subband blocks. Interleaved ``W`` is a fixed
permutation of ``ops/wavelet.py``'s, and the soft threshold and the clip
commute with it, so the primal chains are those of the unfused samplers.
Both kernels keep burn-in-masked Welford moments and per-pixel P^2 quantile
markers; an observation is recorded at steps ``g >= burn_in`` with
``(g + 1) % quantile_thin == 0``. Noise is the Philox normal at
``(seed, chain, pixel, step)`` (``core/random.py::normal_field``), so fused
and unfused chains draw one stream.

Each dispatches by device: ``csrc/wavelet_block.cu`` for CUDA tensors, the
``_ref`` plain version (the same function in torch ops, term for term) for
CPU tensors. On the card ``wavelet_plan`` names one of four routes (see the
CUDA source). The Haar transform is tile-local (``levels`` levels never
leave an aligned ``2^levels`` square), so a Haar block is one launch: up to
``_WARP_LEVELS`` levels on sides that split into 8 x 8 squares one warp a
square with the butterflies in registers (``"warp"``), up to
``_TILE_LEVELS`` levels a CTA a region of whole tiles in shared memory
(``"tile"``). D4/D8 wrap around the whole image at every level: where every
tile of the image fits co-resident on the card, one cooperative launch a
block with a grid barrier between passes (``"resident"``); elsewhere, and
for Haar past ``_TILE_LEVELS`` levels, one launch per level and axis
(``"passes"``).

A call takes one chain ``(ny, nx)`` or ``C`` chains of one posterior
``(C, ny, nx)`` under ``C`` chain keys sharing one seed, as kernel 2 does
(``myula_fused.py``): every launch carries every chain as a grid layer, but
the resident route, which runs them in groups of ``G`` co-resident chains
(``wavelet_plan``), one cooperative launch a group; chain ``c`` is bit for
bit the one-chain call under key ``c``. The plain versions run the chains
one after another. The runners take ``x0`` of shape ``(C, ny, nx)`` and
return what the JAX runner returns under ``jax.vmap``.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from lmc_atomi_torch import _build
from lmc_atomi_torch.core.random import normal_field
from lmc_atomi_torch.kernels.imaging import ULPDAExtras
from lmc_atomi_torch.kernels.myula_fused import (
    H100_SMS,
    FusedChainResult,
    _BlockStats,
    _align_block,
    _chain_result,
    _chain_words,
    _marker_state,
    _p2_coefs,
    chain_seeds,
    chains_per_launch,
    per_chain,
    runner_keys,
)
from lmc_atomi_torch.ops.wavelet import daubechies_filters
from lmc_atomi_torch.run.runner import base_key

__all__ = [
    "dwt_interleaved",
    "dwt_interleaved_inv",
    "haar_interleaved",
    "haar_interleaved_inv",
    "run_myula_wavelet_fused",
    "run_ulpda_wavelet_fused",
    "ulpda_wavelet_block_update",
    "ulpda_wavelet_block_update_cuda",
    "ulpda_wavelet_block_update_ref",
    "wavelet_block_update",
    "wavelet_block_update_cuda",
    "wavelet_block_update_ref",
    "wavelet_plan",
]

_SQRT1_2 = 0.7071067811865476
TAPS = (2, 4, 8)
_MAX_QUANTILES = 4  # csrc/block_common.cuh: LMC_MAXQ
_TILE_SIDE = 32  # csrc/block_common.cuh: LMC_TILE_SIDE, the side of a CTA's region
_TILE_LEVELS = 5  # the most Haar levels whose 2^levels square fits _TILE_SIDE
# csrc/wavelet_block.cu: the routes in the order of its RT_* codes; a warp's
# square (WV_SQ) and the most Haar levels it holds (WV_WARP_LEVELS); a
# resident CTA's threads (WV_RS_THREADS) and the most pixels of its tile
# (WV_RS_THREADS * WV_RS_PPT)
ROUTES = ("passes", "tile", "warp", "resident")
_WARP_SIDE = 8
_WARP_LEVELS = 3
_RS_THREADS = 512
_RS_MAX_PIXELS = _RS_THREADS * 8


def _haar_pass(x, s, axis, iy, ix, roll):
    """One Haar butterfly at stride ``s`` along ``axis`` on the level's
    lattice (``other % s == 0``): slots ``p`` (``idx % 2s == 0``) and
    ``q = p + s`` become ``(x[p] + x[q]) / sqrt2`` and
    ``(x[p] - x[q]) / sqrt2``. An involution: it serves forward and inverse.
    The periodic rolls never wrap onto a selected slot (``n % 2s == 0``)."""
    n = x.shape[axis]
    idx = iy if axis == 0 else ix
    other = ix if axis == 0 else iy
    r = idx & (2 * s - 1)
    x_fwd = roll(x, n - s, axis)  # reads x[i + s]
    x_bwd = roll(x, s, axis)  # reads x[i - s]
    new = torch.where(r == 0, (x + x_fwd) * _SQRT1_2,
                      torch.where(r == s, (x_bwd - x) * _SQRT1_2, x))
    return new if s == 1 else torch.where((other & (s - 1)) == 0, new, x)


def _iotas(shape, device):
    ny, nx = shape
    iy = torch.arange(ny, device=device)[:, None]
    ix = torch.arange(nx, device=device)[None, :]
    return iy, ix


def haar_levels(shape, levels: int) -> int:
    """Levels the interleaved Haar applies: it stops at the first level
    ``l`` whose stride ``2^(l+1)`` does not divide both sides."""
    n = 0
    while n < levels and shape[0] % (2 << n) == 0 and shape[1] % (2 << n) == 0:
        n += 1
    return n


def _db_level_ok(shape, s, taps):
    # DaubechiesDWT2D's guard: the sub-lattice even and at least taps long
    return (shape[0] % (2 * s) == 0 and shape[1] % (2 * s) == 0
            and shape[0] // s >= taps and shape[1] // s >= taps)


def dwt_levels(shape, taps: int, levels: int) -> int:
    """Levels ``dwt_interleaved`` applies (``haar_levels`` for ``taps=2``)."""
    if taps == 2:
        return haar_levels(shape, levels)
    n = 0
    while n < levels and _db_level_ok(shape, 1 << n, taps):
        n += 1
    return n


def haar_interleaved(x, levels: int, roll=torch.roll, iotas=None):
    """Multi-level orthogonal 2-D Haar DWT in interleaved layout
    (``ops/wavelet.py::HaarDWT2D.matvec`` up to a fixed permutation)."""
    iy, ix = _iotas(x.shape, x.device) if iotas is None else iotas
    for lv in range(haar_levels(x.shape, levels)):
        s = 1 << lv
        x = _haar_pass(x, s, 0, iy, ix, roll)
        x = _haar_pass(x, s, 1, iy, ix, roll)
    return x


def haar_interleaved_inv(c, levels: int, roll=torch.roll, iotas=None):
    """Inverse (the transpose: ``W`` is orthogonal) of ``haar_interleaved``."""
    iy, ix = _iotas(c.shape, c.device) if iotas is None else iotas
    for lv in reversed(range(haar_levels(c.shape, levels))):
        s = 1 << lv
        c = _haar_pass(c, s, 1, iy, ix, roll)
        c = _haar_pass(c, s, 0, iy, ix, roll)
    return c


def _db_pass(x, h, g, s, axis, iy, ix, roll, inverse: bool):
    """One periodic Daubechies analysis (synthesis) step at stride ``s``
    along ``axis`` in interleaved layout, on the lattice ``other % s == 0``.
    With ``rd(k) = x[(q + k s) mod n]``:
      analysis:  even slot ``a = sum_i h[i] rd(i)``, odd ``d = sum_i g[i] rd(i-1)``;
      synthesis: even ``sum_i h[2i] rd(-2i) + g[2i] rd(1-2i)``,
                 odd  ``sum_i h[2i+1] rd(-2i-1) + g[2i+1] rd(-2i)``,
    summed as Python's ``sum`` does. Lattice positions wrap onto lattice
    positions (``n % 2s == 0``), so the rolls realize the periodic bank."""
    n = x.shape[axis]
    idx = iy if axis == 0 else ix
    other = ix if axis == 0 else iy
    r = idx & (2 * s - 1)
    reads = {}

    def rd(k):
        if k not in reads:
            sh = (-k * s) % n
            reads[k] = x if sh == 0 else roll(x, sh, axis)
        return reads[k]

    half = len(h) // 2
    if inverse:
        ev = sum(h[2 * i] * rd(-2 * i) + g[2 * i] * rd(1 - 2 * i) for i in range(half))
        od = sum(h[2 * i + 1] * rd(-2 * i - 1) + g[2 * i + 1] * rd(-2 * i)
                 for i in range(half))
    else:
        ev = sum(h[i] * rd(i) for i in range(len(h)))
        od = sum(g[i] * rd(i - 1) for i in range(len(h)))
    new = torch.where(r == 0, ev, torch.where(r == s, od, x))
    return new if s == 1 else torch.where((other & (s - 1)) == 0, new, x)


def dwt_interleaved(x, taps: int, levels: int, roll=torch.roll, iotas=None):
    """Multi-level orthogonal 2-D Daubechies DWT in interleaved layout
    (``taps=2`` is ``haar_interleaved``): the coefficient values of
    ``DaubechiesDWT2D(taps, levels).matvec`` up to a fixed permutation."""
    if taps == 2:
        return haar_interleaved(x, levels, roll, iotas)
    h, g = daubechies_filters(taps)
    iy, ix = _iotas(x.shape, x.device) if iotas is None else iotas
    for lv in range(dwt_levels(x.shape, taps, levels)):
        s = 1 << lv
        x = _db_pass(x, h, g, s, 0, iy, ix, roll, inverse=False)
        x = _db_pass(x, h, g, s, 1, iy, ix, roll, inverse=False)
    return x


def dwt_interleaved_inv(c, taps: int, levels: int, roll=torch.roll, iotas=None):
    """Inverse (the transpose) of :func:`dwt_interleaved`."""
    if taps == 2:
        return haar_interleaved_inv(c, levels, roll, iotas)
    h, g = daubechies_filters(taps)
    iy, ix = _iotas(c.shape, c.device) if iotas is None else iotas
    for lv in reversed(range(dwt_levels(c.shape, taps, levels))):
        s = 1 << lv
        c = _db_pass(c, h, g, s, 1, iy, ix, roll, inverse=True)
        c = _db_pass(c, h, g, s, 0, iy, ix, roll, inverse=True)
    return c


def tile_region(shape, levels: int) -> Tuple[int, int]:
    """``(rh, rw)``, the region of the image one CTA of the Haar kernels
    owns: multiples of the tile side ``2^levels`` (the applied levels) that
    divide the image, at most ``_TILE_SIDE`` each. Raises when a tile is
    larger than a CTA holds."""
    t = 1 << levels
    if t > _TILE_SIDE:
        raise ValueError(
            f"{levels} Haar levels make {t}x{t} tiles; a CTA of the CUDA "
            f"kernel holds at most {_TILE_SIDE}x{_TILE_SIDE}")

    def side(n):
        q = n // t
        return t * max(a for a in range(1, _TILE_SIDE // t + 1) if q % a == 0)

    return side(shape[0]), side(shape[1])


def resident_tile(shape, levels: int, n_sm: int = H100_SMS, n_chains: int = 1):
    """``(ty, tx)``, the tile of one CTA of the D4/D8 ``"resident"`` route,
    or None where no tiling fits: sides multiples of ``2^levels`` that
    divide the image, at most ``_RS_MAX_PIXELS`` pixels, at most ``n_sm``
    tiles (one CTA an SM, all resident at once). Among those the least
    launches in turn x pixels a thread carries (``n_chains`` chains in
    groups of ``chains_per_launch``'s ``G``; a CTA's ``_RS_THREADS`` threads
    step a tile in ``ceil(area / _RS_THREADS)`` pixel rounds), then the
    fewer launches, the least area (one chain: the least area, the most
    CTAs), the least perimeter and the wider tile (rows of a pass's reads
    coalesce). The launcher asks the occupancy API too."""
    ny, nx = shape
    if levels < 1:
        return None
    t = 1 << levels
    best = None
    for ty in range(t, ny + 1, t):
        if ty * t > _RS_MAX_PIXELS:
            break
        for tx in range(t, nx + 1, t):
            if ty * tx > _RS_MAX_PIXELS:
                break
            count = (ny // ty) * (nx // tx)
            if ny % ty or nx % tx or count > n_sm:
                continue
            launches = chains_per_launch(count, n_chains, n_sm)[1]
            rounds = -(-ty * tx // _RS_THREADS)
            key = (launches * rounds, launches, ty * tx, ty + tx, -tx)
            if best is None or key < best[0]:
                best = (key, ty, tx)
    return None if best is None else best[1:]


@functools.lru_cache(maxsize=64)
def wavelet_plan(shape, taps: int, levels: int, n_sm: int = H100_SMS, n_chains: int = 1):
    """Kernels 4 and 5's route for ``n_chains`` chains a call on a card of
    ``n_sm`` SMs: ``(l_eff, route, (gh, gw), (G, launches))``, the applied
    levels, one of ``ROUTES``, its geometry, and the chains a launch carries
    with the launches that take the chains in turn. Haar: ``"warp"`` (8 x 8
    squares) up to ``_WARP_LEVELS`` levels on sides that are multiples of 8,
    else ``"tile"`` (``tile_region``) up to ``_TILE_LEVELS``, else
    ``"passes"``; their launches carry every chain as a grid layer (``G =
    n_chains``, one launch in turn). D4/D8: ``"resident"`` on
    ``resident_tile``'s tile where one exists, the chains in groups of
    ``chains_per_launch``'s ``G``, one cooperative launch a group; else
    ``"passes"``. The geometry of ``"passes"`` is ``(0, 0)``. Computed once
    per shape and chain count."""
    ny, nx = shape
    l_eff = dwt_levels(shape, taps, levels)
    every = (n_chains, 1)
    if taps == 2:
        if l_eff <= _WARP_LEVELS and ny % _WARP_SIDE == 0 and nx % _WARP_SIDE == 0:
            return l_eff, "warp", (_WARP_SIDE, _WARP_SIDE), every
        if l_eff <= _TILE_LEVELS:
            return l_eff, "tile", tile_region(shape, l_eff), every
        return l_eff, "passes", (0, 0), every
    tile = resident_tile(shape, l_eff, n_sm, n_chains)
    if tile is None:
        return l_eff, "passes", (0, 0), every
    count = (ny // tile[0]) * (nx // tile[1])
    return l_eff, "resident", tile, chains_per_launch(count, n_chains, n_sm)


def _check_args(taps, quantiles, quantile_thin):
    if taps not in TAPS:
        raise ValueError(f"taps={taps}: the kernels take {TAPS} (Haar, D4, D8)")
    if len(quantiles) > _MAX_QUANTILES:
        raise ValueError(f"at most {_MAX_QUANTILES} quantiles")
    if quantile_thin < 1:
        raise ValueError("quantile_thin must be >= 1")


def _myula_coefs(scal_f):
    """``(1 - tau/gamma, tau, tau/gamma, noise_scale sqrt(2 tau), sig, thr)``
    as Python floats from ``scal_f = (tau, gamma, sig, thr, noise_scale)``."""
    tau, gamma, sig, thr, noise_scale = (float(v) for v in scal_f)
    return (1.0 - tau / gamma, tau, tau / gamma,
            noise_scale * math.sqrt(2.0 * tau), sig, thr)


def _ulpda_coefs(scal_f):
    """``(tau, mu, theta, noise_scale sqrt(2 tau), tau sig, g_sigma)`` from
    ``scal_f = (tau, mu, theta, noise_scale, sig, g_sigma)``."""
    tau, mu, theta, noise_scale, sig, g_sigma = (float(v) for v in scal_f)
    return (tau, mu, theta, noise_scale * math.sqrt(2.0 * tau), tau * sig,
            g_sigma)


def wavelet_block_update_ref(
    x, y, mask, mean, m2, seed, scal_f, scal_i, qh=None, qn=None, *,
    levels: int = 3, taps: int = 2, n_steps: int = 1, with_noise: bool = True,
    with_stats: bool = True, quantiles: Tuple[float, ...] = (),
    quantile_thin: int = 1,
):
    """Plain torch version of kernel 4 (see ``wavelet_block_update``); a
    chain axis runs its chains one after another."""
    if x.ndim == 3:
        chain_seeds(seed, x)
        kw = dict(levels=levels, taps=taps, n_steps=n_steps, with_noise=with_noise,
                  with_stats=with_stats, quantiles=quantiles,
                  quantile_thin=quantile_thin)

        def one(xc, mc, m2c, qhc, qnc, key):
            return wavelet_block_update_ref(xc, y, mask, mc, m2c, key, scal_f, scal_i,
                                            qhc, qnc, **kw)
        return per_chain(one, x, seed, (mean, m2, qh, qn))
    _check_args(taps, quantiles, quantile_thin)
    c_keep, c_grad, c_prox, noise_amp, sig, thr = _myula_coefs(scal_f)
    seed, chain = base_key(seed)
    iotas = _iotas(x.shape, x.device)
    rec = _BlockStats(scal_i, mean, m2, qh, qn, quantiles, quantile_thin,
                      with_stats)
    for i in range(n_steps):
        g = rec.step0 + i
        grad = sig * mask * (mask * x - y)
        c = dwt_interleaved(x, taps, levels, iotas=iotas)
        c = torch.sign(c) * torch.clamp(torch.abs(c) - thr, min=0.0)
        p = dwt_interleaved_inv(c, taps, levels, iotas=iotas)
        x_new = c_keep * x - c_grad * grad + c_prox * p
        if with_noise:
            x_new = x_new + noise_amp * normal_field(
                seed, chain, g, x.shape, x.dtype, x.device)
        rec(x_new, g)
        x = x_new
    return (x, *rec.result())


def _filters(taps):
    """``h`` then ``g`` as the kernels' float32 array (8 taps, zero padded)."""
    h, g = daubechies_filters(taps)
    out = np.zeros(16, np.float32)
    out[:taps] = h
    out[8:8 + taps] = g
    return out


def _prepare(x, taps, levels, n_steps, scal_i, quantiles, qh, qn, fields, shared=None):
    """Checks shared by the CUDA wrappers; returns ``wavelet_plan`` for the
    card of ``x`` and its chains, the step counters and the P^2 inputs.
    ``fields`` have ``x``'s shape (one chain ``(ny, nx)`` or a chain axis
    ``(C, ny, nx)``), ``shared`` (y and the mask) one chain's."""
    if x.ndim not in (2, 3) or min(x.shape[-2:]) < 2:
        raise ValueError(f"x must be an (ny, nx) image or a (C, ny, nx) chain axis, "
                         f"got {tuple(x.shape)}")
    ny, nx = x.shape[-2:]
    lead = tuple(x.shape[:-2])
    n_q = len(quantiles)
    _build.require_cuda_f32(x.shape, **fields)
    _build.require_cuda_f32((ny, nx), **(shared or {}))
    if n_q:
        _build.require_cuda_f32(lead + (5 * n_q, ny, nx), qh=qh)
        _build.require_cuda_f32(lead + (3 * n_q, ny, nx), qn=qn)
    if any(t.device != x.device for t in (*(shared or {}).values(), qh, qn)
           if t is not None):
        raise ValueError("y, the mask and the marker state must lie on x's device")
    step0, burn, cnt0 = _build.check_steps(scal_i, n_steps)
    # the H100's SMs for a CPU tensor, which only a planning test hands in
    # (the checks above refuse it)
    n_sm = _build.card_limits(x.device)[0] if x.is_cuda else H100_SMS
    n_chains = lead[0] if lead else 1
    plan = wavelet_plan((ny, nx), int(taps), int(levels), n_sm, n_chains)
    qcoef = np.array([_p2_coefs(p) for p in quantiles] or [(0.0,) * 3], np.float32)
    return plan, (step0, burn, cnt0), qcoef


def _ptr(t, used):
    return t.data_ptr() if used else None


def wavelet_block_update_cuda(
    x, y, mask, mean, m2, seed, scal_f, scal_i, qh=None, qn=None, *,
    levels: int = 3, taps: int = 2, n_steps: int = 1, with_noise: bool = True,
    with_stats: bool = True, quantiles: Tuple[float, ...] = (),
    quantile_thin: int = 1,
):
    """Kernel 4 (``csrc/wavelet_block.cu``) on contiguous float32 CUDA
    tensors, one chain ``(ny, nx)`` or a chain axis ``(C, ny, nx)``, on the
    route ``wavelet_plan`` names (counted in ``routes``, the last call's
    ``(route, levels, gh, gw, G)`` in ``last_plan``). Works on copies of
    ``x, mean, m2, qh, qn`` and returns them; raises on a CPU tensor, on
    shapes and options the kernel does not take, or when a resident grid
    does not fit the card."""
    _check_args(taps, quantiles, quantile_thin)
    fields = {"x": x}
    if with_stats:
        fields.update(mean=mean, m2=m2)
    (l_eff, route, (gh, gw), (per, _)), (step0, burn, cnt0), qcoef = _prepare(
        x, taps, levels, n_steps, scal_i, quantiles, qh, qn, fields,
        {"y": y, "mask": mask})
    ny, nx = x.shape[-2:]
    n_q = len(quantiles)
    seed, words = chain_seeds(seed, x)
    chains = _chain_words(words, x.device)
    x = x.clone()
    if with_stats:
        mean, m2 = mean.clone(), m2.clone()
    if n_q:
        qh, qn = qh.clone(), qn.clone()
    # the resident and passes routes' scratch, plane-major: (2, C, ny, nx)
    bufs = None if route in ("warp", "tile") else torch.empty(
        (2, len(words), ny, nx), dtype=x.dtype, device=x.device)
    coef = np.array(_myula_coefs(scal_f), np.float32)
    filt = _filters(taps)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmc_wavelet_block(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), _ptr(mean, with_stats),
            _ptr(m2, with_stats), _ptr(qh, n_q), _ptr(qn, n_q),
            _ptr(bufs, bufs is not None), ny, nx, len(words),
            _ptr(chains, chains is not None), taps, filt.ctypes.data, l_eff,
            ROUTES.index(route), gh, gw, per, int(n_steps), int(bool(with_noise)),
            int(bool(with_stats)), qcoef.ctypes.data, n_q, int(quantile_thin),
            coef.ctypes.data, seed & 0xFFFFFFFF, words[0] & 0xFFFFFFFF, step0,
            burn, cnt0, stream,
        )
    _build.check(rc, "lmc_wavelet_block")
    wavelet_block_update_cuda.launches += 1
    wavelet_block_update_cuda.routes[route] += 1
    wavelet_block_update_cuda.last_plan = (route, l_eff, gh, gw, per)
    return x, mean, m2, qh, qn


wavelet_block_update_cuda.launches = 0  # calls that launched the kernel
# calls per route, and the last call's (route, levels, gh, gw, G): G chains a
# launch
wavelet_block_update_cuda.routes = dict.fromkeys(ROUTES, 0)
wavelet_block_update_cuda.last_plan = None


def wavelet_block_update(x, *args, **kwargs):
    """``n_steps`` fused wavelet-l1 MYULA steps (+ Welford / P^2), kernel 4.

    ``y`` the masked observation, ``mask`` the 0/1 mask; ``seed`` is a seed
    or ``(seed, chain)``; ``scal_f = (tau, gamma, sig, thr, noise_scale)``
    with ``sig`` the data term's ``1/sigma_noise^2`` and ``thr = epsg gamma
    lam`` the soft threshold; ``scal_i = (step0, burn_in, count0)``: the
    global step of the first step, the burn-in in steps, and the Welford
    count entering the call. ``levels`` DWT levels of the ``taps``-tap
    filter (2 Haar, 4 D4, 8 D8). ``quantiles`` adds the P^2 markers ``qh``
    (5 heights per quantile) and ``qn`` (3 interior positions), each
    ``(k * len(quantiles), ny, nx)``. Returns ``(x', mean', m2', qh', qn')``.
    ``x`` may be ``C`` chains ``(C, ny, nx)`` (``mean``/``m2`` alike, the
    markers ``(C, k n_q, ny, nx)``) under ``C`` keys ``(seed, chain_c)`` of
    ``core.random.chain_keys``, sharing ``y`` and ``mask``: chain ``c`` is
    bit for bit the one-chain call under key ``c``.
    CUDA tensors run the hand kernel, CPU tensors its plain version.
    """
    if x.is_cuda:
        return wavelet_block_update_cuda(x, *args, **kwargs)
    return wavelet_block_update_ref(x, *args, **kwargs)


def ulpda_wavelet_block_update_ref(
    x, c, xbar, y, mask, mean, m2, seed, scal_f, scal_i, qh=None, qn=None, *,
    levels: int = 3, taps: int = 2, n_steps: int = 1, gfirst: bool = False,
    with_noise: bool = True, with_stats: bool = True,
    quantiles: Tuple[float, ...] = (), quantile_thin: int = 1,
):
    """Plain torch version of kernel 5 (see ``ulpda_wavelet_block_update``);
    a chain axis runs its chains one after another."""
    if x.ndim == 3:
        chain_seeds(seed, x)
        kw = dict(levels=levels, taps=taps, n_steps=n_steps, gfirst=gfirst,
                  with_noise=with_noise, with_stats=with_stats, quantiles=quantiles,
                  quantile_thin=quantile_thin)

        def one(xk, ck, xbk, mk, m2k, qhk, qnk, key):
            return ulpda_wavelet_block_update_ref(xk, ck, xbk, y, mask, mk, m2k, key,
                                                  scal_f, scal_i, qhk, qnk, **kw)
        return per_chain(one, x, seed, (c, xbar, mean, m2, qh, qn))
    _check_args(taps, quantiles, quantile_thin)
    tau, mu, theta, noise_amp, ts, g_sigma = _ulpda_coefs(scal_f)
    seed, chain = base_key(seed)
    iotas = _iotas(x.shape, x.device)
    rec = _BlockStats(scal_i, mean, m2, qh, qn, quantiles, quantile_thin,
                      with_stats)
    # L2Data(Mask).prox in closed form: (v + ts m y) / (1 + ts m)
    prox_den = 1.0 / (1.0 + ts * mask)
    atb = ts * mask * y

    def dual(c, xbar):
        w = dwt_interleaved(xbar, taps, levels, iotas=iotas)
        return torch.clamp(c + mu * w, -g_sigma, g_sigma)

    if not gfirst:
        xbar = x  # never read: each step rebuilds it before the dual update
    for i in range(n_steps):
        g = rec.step0 + i
        if gfirst:
            c = dual(c, xbar)
        p = dwt_interleaved_inv(c, taps, levels, iotas=iotas)
        x_new = (x - tau * p + atb) * prox_den
        if with_noise:
            x_new = x_new + noise_amp * normal_field(
                seed, chain, g, x.shape, x.dtype, x.device)
        xbar = x_new + theta * (x_new - x)
        if not gfirst:
            c = dual(c, xbar)
        rec(x_new, g)
        x = x_new
    return (x, c, xbar, *rec.result())


def ulpda_wavelet_block_update_cuda(
    x, c, xbar, y, mask, mean, m2, seed, scal_f, scal_i, qh=None, qn=None, *,
    levels: int = 3, taps: int = 2, n_steps: int = 1, gfirst: bool = False,
    with_noise: bool = True, with_stats: bool = True,
    quantiles: Tuple[float, ...] = (), quantile_thin: int = 1,
):
    """Kernel 5 (``csrc/wavelet_block.cu``) on contiguous float32 CUDA
    tensors, one chain or a chain axis as kernel 4's, on the route
    ``wavelet_plan`` names (``routes`` and ``last_plan`` as kernel 4's).
    Works on copies of ``x, c, xbar, mean, m2, qh, qn`` and returns them
    (``xbar`` may be None for ``gfirst=False``, which never reads it);
    raises on a CPU tensor, on shapes and options the kernel does not take,
    or when a resident grid does not fit the card."""
    _check_args(taps, quantiles, quantile_thin)
    fields = {"x": x, "c": c}
    if gfirst:
        fields["xbar"] = xbar
    if with_stats:
        fields.update(mean=mean, m2=m2)
    (l_eff, route, (gh, gw), (per, _)), (step0, burn, cnt0), qcoef = _prepare(
        x, taps, levels, n_steps, scal_i, quantiles, qh, qn, fields,
        {"y": y, "mask": mask})
    ny, nx = x.shape[-2:]
    n_q = len(quantiles)
    seed, words = chain_seeds(seed, x)
    chains = _chain_words(words, x.device)
    x, c = x.clone(), c.clone()
    xbar = xbar.clone() if gfirst else torch.empty_like(x)
    if with_stats:
        mean, m2 = mean.clone(), m2.clone()
    if n_q:
        qh, qn = qh.clone(), qn.clone()
    bufs = None if route in ("warp", "tile") else torch.empty(
        (2, len(words), ny, nx), dtype=x.dtype, device=x.device)
    coef = np.array(_ulpda_coefs(scal_f), np.float32)
    filt = _filters(taps)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmc_ulpda_wavelet_block(
            x.data_ptr(), c.data_ptr(), xbar.data_ptr(), y.data_ptr(),
            mask.data_ptr(), _ptr(mean, with_stats), _ptr(m2, with_stats),
            _ptr(qh, n_q), _ptr(qn, n_q), _ptr(bufs, bufs is not None), ny, nx,
            len(words), _ptr(chains, chains is not None), taps, filt.ctypes.data,
            l_eff, ROUTES.index(route), gh, gw, per, int(n_steps),
            int(bool(gfirst)), int(bool(with_noise)), int(bool(with_stats)),
            qcoef.ctypes.data, n_q, int(quantile_thin), coef.ctypes.data,
            seed & 0xFFFFFFFF, words[0] & 0xFFFFFFFF, step0, burn, cnt0, stream,
        )
    _build.check(rc, "lmc_ulpda_wavelet_block")
    ulpda_wavelet_block_update_cuda.launches += 1
    ulpda_wavelet_block_update_cuda.routes[route] += 1
    ulpda_wavelet_block_update_cuda.last_plan = (route, l_eff, gh, gw, per)
    return x, c, xbar, mean, m2, qh, qn


ulpda_wavelet_block_update_cuda.launches = 0  # calls that launched the kernel
ulpda_wavelet_block_update_cuda.routes = dict.fromkeys(ROUTES, 0)
ulpda_wavelet_block_update_cuda.last_plan = None


def ulpda_wavelet_block_update(x, *args, **kwargs):
    """``n_steps`` fused wavelet-dual ULPDA steps (+ Welford / P^2), kernel 5.

    ``c`` the dual in the interleaved coefficient layout, ``xbar`` the
    extrapolated iterate (read only with ``gfirst``), ``y`` and ``mask`` the
    observation and its 0/1 mask; ``scal_f = (tau, mu, theta, noise_scale,
    sig, g_sigma)`` with ``g_sigma`` the dual's l-inf radius (the wavelet-l1
    weight); ``scal_i``, ``quantiles`` and the markers as in
    ``wavelet_block_update``, a chain axis too (``c`` and ``xbar`` as
    ``x``). Returns ``(x', c', xbar', mean', m2', qh', qn')``; ``xbar'`` is
    the genuine ``x' + theta (x' - x)`` in both orders.
    CUDA tensors run the hand kernel, CPU tensors its plain version.
    """
    if x.is_cuda:
        return ulpda_wavelet_block_update_cuda(x, *args, **kwargs)
    return ulpda_wavelet_block_update_ref(x, *args, **kwargs)


def run_myula_wavelet_fused(
    l2,
    lam: float,
    tau: float,
    gamma: float,
    x0,
    key,
    n_steps: int,
    *,
    levels: int = 3,
    taps: int = 2,
    epsg: float = 1.0,
    block: Optional[int] = None,
    burn_in: int = 0,
    noise_scale: float = 1.0,
    step_offset: int = 0,
    quantiles: Tuple[float, ...] = (),
    quantile_thin: int = 1,
    quantile_state=None,
    interpret: bool = False,
) -> FusedChainResult:
    """Block-fused wavelet-l1 MYULA chain: a host loop over blocks of
    ``block`` fused steps (kernel 4 per block on CUDA) with Welford posterior
    moments and, with ``quantiles``, per-pixel P^2 maps. ``l2`` is an
    ``L2Data`` over a ``Mask``; the prior is ``lam ||W x||_1`` with the
    ``levels``-level orthogonal DWT of ``taps`` taps (2 Haar, 4 D4, 8 D8).

    ``key`` is a seed or ``(seed, chain)``. ``step_offset`` is this run's
    global first step, so burn-in masking, the P^2 count and the noise
    continue across segmented runs (resume with ``quantile_state``; the
    Welford count restarts per run, merge with ``RunningMoments.merge``).
    An ``x0`` of shape ``(C, ny, nx)`` runs ``C`` chains in each kernel
    call, chain ``c`` under ``chain_keys(key, C)[c]`` (or ``key`` a list of
    ``C`` chain keys); every field of the result then has the chain axis
    but ``moments.count``: the JAX runner under ``jax.vmap``.
    ``interpret`` is the JAX package's (Pallas interpret mode) and takes no
    effect: a CPU tensor runs the plain version.
    """
    x0 = torch.as_tensor(x0)
    key = runner_keys(x0, key)
    quantiles = tuple(float(p) for p in quantiles)
    step_offset = int(step_offset)
    block = _align_block(n_steps, min(n_steps, 500) if block is None else block,
                         quantiles, quantile_thin, noise_scale, step_offset)
    scal_f = (float(tau), float(gamma), float(l2.sigma),
              float(epsg * gamma * lam), float(noise_scale))
    x, mean, m2 = x0, torch.zeros_like(x0), torch.zeros_like(x0)
    qh, qn = _marker_state(x0, len(quantiles), quantile_state)
    for b in range(n_steps // block):
        step0 = step_offset + b * block
        cnt0 = max(step0 - max(burn_in, step_offset), 0)
        x, mean, m2, qh, qn = wavelet_block_update(
            x, l2.b, l2.op.mask, mean, m2, key, scal_f, (step0, burn_in, cnt0),
            qh, qn, levels=levels, taps=taps, n_steps=block,
            with_noise=noise_scale != 0.0, with_stats=True,
            quantiles=quantiles, quantile_thin=quantile_thin,
        )
    count = (max(step_offset + n_steps - burn_in, 0)
             - max(step_offset - burn_in, 0))
    return _chain_result(x, mean, m2, count, quantiles, qh, qn)


def run_ulpda_wavelet_fused(
    l2,
    g_sigma: float,
    tau,
    mu,
    x0,
    key,
    n_steps: int,
    *,
    theta: float = 1.0,
    gfirst: bool = False,
    levels: int = 3,
    taps: int = 2,
    block: Optional[int] = None,
    burn_in: int = 0,
    noise_scale: float = 1.0,
    quantiles: Tuple[float, ...] = (),
    quantile_thin: int = 1,
    quantile_state=None,
    y0=None,
    xbar0=None,
    step_offset: int = 0,
    interpret: bool = False,
) -> FusedChainResult:
    """Block-fused wavelet-dual ULPDA chain (kernel 5 per block on CUDA)
    with Welford moments and optional P^2 ``quantiles``: the primal chain of
    ``kernels/imaging.py::ulpda(L2Data(Mask), L1Norm(g_sigma), W)``.

    The returned dual ``final_state.extras.y`` is an ``(ny, nx)`` field in
    the INTERLEAVED layout: continue it only with this runner (``y0``,
    ``xbar0`` and ``step_offset``, the global step this run starts at), not
    with the unfused ``ulpda``, whose dual is in the Mallat layout.
    ``extras.xbar`` is the genuine extrapolated iterate in both orders.
    A chain axis ``x0`` ``(C, ny, nx)`` runs as ``run_myula_wavelet_fused``'s
    (``y0``, ``xbar0`` and the extras then ``(C, ny, nx)``).
    ``interpret`` is the JAX package's (Pallas interpret mode) and takes no
    effect: a CPU tensor runs the plain version.
    """
    x0 = torch.as_tensor(x0)
    key = runner_keys(x0, key)
    quantiles = tuple(float(p) for p in quantiles)
    step_offset = int(step_offset)
    block = _align_block(n_steps, min(n_steps, 250) if block is None else block,
                         quantiles, quantile_thin, noise_scale, step_offset)
    scal_f = (float(tau), float(mu), float(theta), float(noise_scale),
              float(l2.sigma), float(g_sigma))
    zeros = torch.zeros_like(x0)
    x, mean, m2 = x0, zeros, zeros
    c = zeros if y0 is None else torch.as_tensor(y0)
    xbar = x0 if xbar0 is None else torch.as_tensor(xbar0)
    qh, qn = _marker_state(x0, len(quantiles), quantile_state)
    for b in range(n_steps // block):
        step0 = step_offset + b * block
        cnt0 = max(step0 - max(burn_in, step_offset), 0)
        x, c, xbar, mean, m2, qh, qn = ulpda_wavelet_block_update(
            x, c, xbar, l2.b, l2.op.mask, mean, m2, key, scal_f,
            (step0, burn_in, cnt0), qh, qn, levels=levels, taps=taps,
            n_steps=block, gfirst=gfirst, with_noise=noise_scale != 0.0,
            with_stats=True, quantiles=quantiles, quantile_thin=quantile_thin,
        )
    count = (max(step_offset + n_steps - burn_in, 0)
             - max(step_offset - burn_in, 0))
    return _chain_result(x, mean, m2, count, quantiles, qh, qn,
                         extras=ULPDAExtras(y=c, xbar=xbar))
