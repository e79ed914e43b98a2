"""Tiled fused MYULA TV for large images (counterpart of
``lmc_atomi_tpu/kernels/myula_tiled.py``): kernel 6, its plain torch
version, and the host-side block loop.

A step of MYULA is local: the separable gram reaches ``oy`` rows (``ox``
columns), each TV dual trip one more, the MC-TV clamp two, the ME-TV
envelope ``niter_inner + 1``. So a tile of the image read with a halo of at
least that depth (``_halo_need``), with image-periodic wrap (exact for the
circulant gram) and forward-difference masks at the image's last row and
column wherever they fall in the tile (``_band_masks``, exact for the
Neumann TV boundary), computes the step of its interior exactly. x
ping-pongs between two buffers (steps alternate A -> B, B -> A), since a
tile reads its neighbours' rows of the previous step.

- ``myula_tv_tiled_update_ref`` computes band by band as the TPU kernel
  does: full-width row bands of ``band`` rows read with ``halo`` rows on
  each side (``_read_tile``), the stencils rolled within the tile, the
  interior kept.
- ``myula_tv_tiled_update_cuda`` runs ``csrc/tiled_block.cu``: one launch
  per step, each CTA a 2-D tile with the least exact halo in rows AND
  columns, held in shared memory, on which it computes only the cone its
  interior's result reads. The interior and the CTA size are
  ``tiled_plan``'s, the geometry of least cone work per step on the card,
  which the wrapper picks and keeps in ``last_plan``. ``band`` and
  ``halo`` are checked as the JAX package checks them; the result does not
  depend on the tiling.

Noise is the Philox normal at the global pixel and step
(``core/random.py``), so a tiled chain draws the same noise as
``run_myula_tv_fused`` and, in the same per-pixel operation order, is the
same chain: bit for bit against kernel 2 without ``tv_warm``. The TV prox
and the ME-TV envelope start cold every step. Not ported: the TPU's
``stream_x`` layout and its VMEM budget logic.

A call takes one chain ``(ny, nx)`` or ``C`` chains of one posterior
``(C, ny, nx)`` under ``C`` chain keys sharing one seed, as kernel 2 does:
on the card each step's launch carries every chain as a grid layer, the
plain version runs the chains one after another, and chain ``c`` is bit for
bit the one-chain call under key ``c``.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import numpy as np
import torch

from lmc_atomi_torch import _build
from lmc_atomi_torch.core.random import normal_field
from lmc_atomi_torch.kernels.myula_fused import (
    _MAX_TRIPS,
    H100_SMEM_OPTIN,
    H100_SMS,
    MODES,
    FusedChainResult,
    Taps,
    _BlockStats,
    _chain_result,
    _chain_words,
    _check_block_args,
    _fgp_coef,
    _fused_mode,
    _fused_params,
    _marker_state,
    _mctv_clamp,
    _p2_coefs,
    _pack_scal_f,
    _sep_gram,
    _tile_halo,
    _tv_prox_any,
    _update_coefs,
    chain_seeds,
    per_chain,
    runner_keys,
)
from lmc_atomi_torch.ops.tv_cuda import (
    _RESERVED_SMEM,
    _SM_THREADS,
    _free_lines,
    _stencils,
    _trip_work,
)
from lmc_atomi_torch.run.runner import base_key

__all__ = [
    "tiled_plan",
    "pick_band",
    "myula_tv_tiled_update",
    "myula_tv_tiled_update_cuda",
    "myula_tv_tiled_update_ref",
    "run_myula_tv_tiled",
]


def _tile_work(ty, tx, h, ry, rank, niter_tv, mode, niter_inner) -> int:
    """Pixel passes of one CTA's step on its cone: the tile's load, the gram's row pass on the interior's columns within the
    row taps' reach ``ry`` and its column pass on the interior, per rank, the
    MC-TV clamp on the interior grown by 1 or the envelope trips, the
    gradient, the TV trips and the update."""
    area = ty * tx
    w = (ty + 2 * h) * (tx + 2 * h) + rank * ((ty + 2 * ry) * tx + area)
    if mode == "mctv":
        w += (ty + 2) * (tx + 2)
    elif mode == "metv":
        w += _trip_work(ty, tx, h, niter_inner)
    return w + 2 * area + _trip_work(ty, tx, h, niter_tv)


@functools.lru_cache(maxsize=64)
def _ranking(ny, nx, h, ry, n_taps, niter_tv, fields, mode, niter_inner, n_sm, smem_limit,
             n_chains=1):
    """``_tiled_ranking`` on the numbers it depends on, computed once per
    shape, options and chain count: the wrapper asks on every call."""
    cands = []
    for threads in (512, 1024):
        per_sm = _SM_THREADS // threads
        for ty in range(8, ny + 8, 8):
            for tx in range(8, nx + 8, 8):
                sy, sx = ty + 2 * h, tx + 2 * h
                cta = 4 * (fields * sy * sx + ty * tx) + 4 * (sy + sx) + 4 * _MAX_TRIPS
                if (cta > smem_limit
                        or per_sm * (cta + _RESERVED_SMEM) > smem_limit + _RESERVED_SMEM):
                    break
                tiles = -(-ny // ty) * -(-nx // tx)
                # the launch's CTAs: every chain's tiles
                waves = -(-tiles * n_chains // (n_sm * per_sm))
                cost = waves * per_sm * _tile_work(ty, tx, h, ry, n_taps, niter_tv,
                                                   mode, niter_inner)
                cands.append((cost, threads, ty, tx, tiles))
    return tuple((ty, tx, h, threads, tiles - _free_lines(ny, ty, h) * _free_lines(nx, tx, h),
                  tiles) for _, threads, ty, tx, tiles in sorted(cands))


def _tiled_ranking(shape, taps: Taps, oy: int, ox: int, *, niter_tv: int = 10,
                   tv_solver: str = "chambolle", mode: str = "tv",
                   niter_inner: int = 10, n_sm: int = H100_SMS,
                   smem_limit: int = H100_SMEM_OPTIN, n_chains: int = 1):
    """Every geometry ``tiled_plan`` weighs, as its ``(ty, tx, h, threads,
    edge_tiles, tiles)``, in the order of its ranking: least cost first."""
    if not 0 <= niter_tv <= _MAX_TRIPS or not 0 <= niter_inner <= _MAX_TRIPS:
        return ()
    ry = max(oy, len(taps[0][0]) - 1 - oy)
    h = _tile_halo(taps, oy, ox, niter_tv, mode, niter_inner)
    return _ranking(*shape, h, ry, len(taps), niter_tv, 6 if tv_solver == "fgp" else 4,
                    mode, niter_inner, n_sm, smem_limit, n_chains)


def tiled_plan(shape, taps: Taps, oy: int, ox: int, *, niter_tv: int = 10,
               tv_solver: str = "chambolle", mode: str = "tv",
               niter_inner: int = 10, n_sm: int = H100_SMS,
               smem_limit: int = H100_SMEM_OPTIN, n_chains: int = 1):
    """Kernel 6's geometry for ``n_chains`` chains a call on a card of
    ``n_sm`` SMs whose CTA takes at most ``smem_limit`` bytes of shared
    memory, the one the wrapper launches: ``(ty, tx, h, threads,
    edge_tiles, tiles)`` (tiles a chain), or ``None`` when nothing fits.
    A step is one launch of every chain's tiles (grid layer z chain z: all
    ``n_chains`` chains a launch, one launch in turn).

    The halo ``h`` is the least exact one (``myula_fused._tile_halo``, as
    the resident route's). Candidates are the
    interiors ``ty x tx`` (multiples of 8) at 512 threads a CTA (two CTAs an
    SM) or 1024 (one), whose shared memory (x, u and the dual on the tile,
    with FGP also its point, the gradient on the interior, the row and
    column indices, 64 floats of FGP momentum) fits, each CTA reserving 1 KiB
    of the SM's ``smem_limit + 1024`` (as on sm_80 and sm_90). A step costs
    the waves ``ceil(tiles / (n_sm * per_sm))`` times the CTAs of a wave on
    an SM times one CTA's cone work (``_tile_work``), ragged tiles at full
    cost; the waves count every chain's tiles. The least cost wins, ties to
    fewer threads, then the smaller ``ty`` and ``tx``. ``edge_tiles``
    counts the tiles that are not edge-free."""
    ranking = _tiled_ranking(shape, taps, oy, ox, niter_tv=niter_tv, tv_solver=tv_solver,
                             mode=mode, niter_inner=niter_inner, n_sm=n_sm,
                             smem_limit=smem_limit, n_chains=n_chains)
    return ranking[0] if ranking else None


def pick_band(ny: int, halo: int) -> int:
    """Largest power-of-two band <= 512 dividing ``ny`` with >= 2 bands
    and a tile (band + 2 halo) no taller than the image."""
    band = 512
    while band > 8 and (ny % band or ny // band < 2 or band + 2 * halo > ny):
        band //= 2
    return band


def _round8(v: int) -> int:
    return (v + 7) // 8 * 8


def _halo_need(niter_tv: int, oy: int, mode: str, niter_inner: int) -> int:
    """Rows a tile seam's wrap contamination can travel in one step: the
    step's operators all read the same tile, so the need is the largest of
    their depths: TV prox ``niter_tv + 1``, gram ``oy``, MC-TV 2, ME-TV
    ``niter_inner + 1``."""
    need = max(niter_tv + 1, oy)
    if mode == "mctv":
        need = max(need, 2)
    elif mode == "metv":
        need = max(need, niter_inner + 1)
    return need


def _read_tile(x, b: int, band: int, halo: int):
    """Rows ``[b*band - halo, (b+1)*band + halo)`` of ``x``, wrapping
    periodically at the image edges."""
    ny = x.shape[0]
    rows = torch.arange(b * band - halo, (b + 1) * band + halo,
                        device=x.device) % ny
    return x[rows]


def _band_masks(b: int, n_bands: int, band: int, halo: int, nx: int, dtype,
                device):
    """Forward-difference masks of band ``b``'s tile, ``(my, mx)`` shaped
    ``(tile, 1)`` and ``(1, nx)``. The row mask zeroes the difference at
    image row ``ny - 1`` WHEREVER it falls in the tile (tile rows map to
    image rows with periodic wrap); masking only the edge bands' halos
    breaks when ``halo >= band`` puts the image boundary inside an interior
    band's halo."""
    tile = band + 2 * halo
    ny = n_bands * band
    img_row = (torch.arange(tile, device=device) + (b * band - halo)) % ny
    my = (img_row != ny - 1).to(dtype)[:, None]
    mx = (torch.arange(nx, device=device) < nx - 1).to(dtype)[None, :]
    return my, mx


def _check_tiles(shape, n_steps: int, band: int, halo: int, halo_need: int,
                 need_what: str) -> None:
    """The JAX package's checks of a tiled call, with its messages."""
    ny = shape[0]
    if n_steps % 2:
        raise ValueError("tiled kernel runs steps in parity pairs: "
                         f"n_steps={n_steps} must be even")
    if ny % band or ny // band < 2:
        raise ValueError(f"band={band} must divide ny={ny} with >= 2 bands")
    if band % 8:
        raise ValueError(f"band={band} must be a multiple of 8")
    if halo % 8 or halo < halo_need:
        raise ValueError(f"halo={halo} must be a multiple of 8 and >= "
                         f"{halo_need} ({need_what})")
    if band + 2 * halo > ny:
        raise ValueError(
            f"tile = band + 2*halo = {band + 2 * halo} exceeds ny={ny}: "
            "a tile may wrap the image at most once")


def _check_myula_tiled(x, taps, oy, n_steps, band, halo, niter_tv, mode,
                       niter_inner, quantiles, quantile_thin, tv_solver):
    _check_block_args(taps, quantiles, quantile_thin, tv_solver, mode)
    if x.ndim not in (2, 3):
        raise ValueError(f"x must be an (ny, nx) image or a (C, ny, nx) chain axis, "
                         f"got {tuple(x.shape)}")
    _check_tiles(x.shape[-2:], n_steps, band, halo,
                 _halo_need(niter_tv, oy, mode, niter_inner),
                 "the TV prox's niter_tv + 1, the gram radius oy"
                 + (", the ME-TV inner prox's niter_inner + 1"
                    if mode == "metv" else ""))


def _tile_rows(b: int, band: int, halo: int):
    """The band's image rows and its interior rows within the tile."""
    return slice(b * band, (b + 1) * band), slice(halo, halo + band)


def myula_tv_tiled_update_ref(
    x, atbs, mean, m2, seed, scal_f, scal_i, qh=None, qn=None, *,
    taps: Taps, oy: int, ox: int, n_steps: int, niter_tv: int = 10,
    tv_step: float = 0.25, band: int, halo: int, with_noise: bool = True,
    tv_solver: str = "chambolle", quantiles: Tuple[float, ...] = (),
    quantile_thin: int = 1, mode: str = "tv", niter_inner: int = 0,
):
    """Plain torch version of kernel 6 (see ``myula_tv_tiled_update``),
    band by band: each band's step is computed on its halo tile and its
    interior kept; a chain axis runs its chains one after another."""
    _check_myula_tiled(x, taps, oy, n_steps, band, halo, niter_tv, mode,
                       niter_inner, quantiles, quantile_thin, tv_solver)
    if x.ndim == 3:
        chain_seeds(seed, x)
        kw = dict(taps=taps, oy=oy, ox=ox, n_steps=n_steps, niter_tv=niter_tv,
                  tv_step=tv_step, band=band, halo=halo, with_noise=with_noise,
                  tv_solver=tv_solver, quantiles=quantiles, quantile_thin=quantile_thin,
                  mode=mode, niter_inner=niter_inner)

        def one(xc, mc, m2c, qhc, qnc, key):
            return myula_tv_tiled_update_ref(xc, atbs, mc, m2c, key, scal_f, scal_i,
                                             qhc, qnc, **kw)
        return per_chain(one, x, seed, (mean, m2, qh, qn))
    (c_keep, c_grad, c_prox, noise_amp, sigma, tv_gamma, lamda, gamma_mc, _,
     c_env) = _update_coefs(scal_f)
    seed, chain = base_key(seed)
    ny, nx = x.shape
    n_bands = ny // band
    masks = [_band_masks(b, n_bands, band, halo, nx, x.dtype, x.device)
             for b in range(n_bands)]
    rec = _BlockStats(scal_i, mean, m2, qh, qn, quantiles, quantile_thin, True)
    for i in range(n_steps):
        g = rec.step0 + i
        noise = (normal_field(seed, chain, g, x.shape, x.dtype, x.device)
                 if with_noise else None)
        bands = []
        for b in range(n_bands):
            rows, inner = _tile_rows(b, band, halo)
            xt = _read_tile(x, b, band, halo)
            stencils = _stencils(xt, masks[b])
            grad = sigma * _sep_gram(xt, taps, oy, ox)[inner] - atbs[rows]
            if mode == "mctv":
                grad = grad + lamda * stencils[2](
                    *_mctv_clamp(xt, gamma_mc, stencils))[inner]
            elif mode == "metv":
                p_env, _ = _tv_prox_any(xt, gamma_mc, niter_inner, tv_solver,
                                        tv_step, stencils)
                grad = grad - c_env * (xt[inner] - p_env[inner])
            prox, _ = _tv_prox_any(xt, tv_gamma, niter_tv, tv_solver, tv_step,
                                   stencils)
            x_new = c_keep * xt[inner] - c_grad * grad + c_prox * prox[inner]
            if noise is not None:
                x_new = x_new + noise_amp * noise[rows]
            bands.append(x_new)
        x = torch.cat(bands)
        rec(x, g)
    return (x, *rec.result())


def myula_tv_tiled_update_cuda(
    x, atbs, mean, m2, seed, scal_f, scal_i, qh=None, qn=None, *,
    taps: Taps, oy: int, ox: int, n_steps: int, niter_tv: int = 10,
    tv_step: float = 0.25, band: int, halo: int, with_noise: bool = True,
    tv_solver: str = "chambolle", quantiles: Tuple[float, ...] = (),
    quantile_thin: int = 1, mode: str = "tv", niter_inner: int = 0,
):
    """Kernel 6 (``csrc/tiled_block.cu``) on contiguous float32 CUDA tensors,
    one chain or a chain axis: one launch per step carrying every chain, on
    ``tiled_plan``'s geometry for the card and the chains, kept in
    ``last_plan``. Works on copies of
    ``x, mean, m2, qh, qn`` and returns them; raises on a CPU tensor, on
    options the kernel does not take, or when no geometry fits."""
    _check_myula_tiled(x, taps, oy, n_steps, band, halo, niter_tv, mode,
                       niter_inner, quantiles, quantile_thin, tv_solver)
    ny, nx = x.shape[-2:]
    lead = tuple(x.shape[:-2])
    n_q = len(quantiles)
    _build.require_cuda_f32(x.shape, x=x, mean=mean, m2=m2)
    _build.require_cuda_f32((ny, nx), atbs=atbs)
    if n_q:
        _build.require_cuda_f32(lead + (5 * n_q, ny, nx), qh=qh)
        _build.require_cuda_f32(lead + (3 * n_q, ny, nx), qn=qn)
    if any(t.device != x.device for t in (atbs, qh, qn) if t is not None):
        raise ValueError("atbs and the marker state must lie on x's device")
    step0, burn, cnt0 = _build.check_steps(scal_i, n_steps)
    seed, words = chain_seeds(seed, x)
    chains = _chain_words(words, x.device)

    x, mean, m2 = x.clone(), mean.clone(), m2.clone()
    if n_q:
        qh, qn = qh.clone(), qn.clone()
    parity = torch.empty_like(x)
    rank, ky, kx = len(taps), len(taps[0][0]), len(taps[0][1])
    tap_arr = np.array([v for wy, wx in taps for v in (*wy, *wx)], np.float32)
    coef = np.array(_update_coefs(scal_f), np.float32)
    fgp_coef = _fgp_coef(max(niter_tv, niter_inner if mode == "metv" else 0))
    qcoef = np.array([_p2_coefs(p) for p in quantiles] or [(0.0,) * 3], np.float32)

    n_sm, smem_limit = _build.card_limits(x.device)
    plan = tiled_plan((ny, nx), taps, oy, ox, niter_tv=niter_tv, tv_solver=tv_solver,
                      mode=mode, niter_inner=niter_inner, n_sm=n_sm, smem_limit=smem_limit,
                      n_chains=len(words))
    if plan is None:
        raise ValueError(f"no kernel-6 tile fits {smem_limit} bytes of shared memory")
    ty, tx, _, threads, _, _ = plan

    def ptr(t, used):
        return t.data_ptr() if used else None

    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmc_myula_tiled(
            x.data_ptr(), parity.data_ptr(), atbs.data_ptr(), mean.data_ptr(),
            m2.data_ptr(), ptr(qh, n_q), ptr(qn, n_q), ny, nx, len(words),
            ptr(chains, chains is not None), tap_arr.ctypes.data, rank, ky, kx,
            int(oy), int(ox),
            int(n_steps), int(niter_tv), float(tv_step),
            int(tv_solver == "fgp"), fgp_coef.ctypes.data, MODES.index(mode),
            int(niter_inner), int(bool(with_noise)), qcoef.ctypes.data, n_q,
            int(quantile_thin), coef.ctypes.data, seed & 0xFFFFFFFF,
            words[0] & 0xFFFFFFFF, step0, burn, cnt0, ty, tx, threads, stream,
        )
    _build.check(rc, "lmc_myula_tiled")
    myula_tv_tiled_update_cuda.launches += 1
    myula_tv_tiled_update_cuda.last_plan = plan
    return x, mean, m2, qh, qn


myula_tv_tiled_update_cuda.launches = 0  # calls that launched the kernel
myula_tv_tiled_update_cuda.last_plan = None  # the last launch's tiled_plan


def myula_tv_tiled_update(x, *args, **kwargs):
    """``n_steps`` (even) tiled fused MYULA steps + Welford / P^2, kernel 6.

    Arguments as ``myula_fused.myula_tv_block_update``'s (``atbs = sigma
    A^T b``, ``seed`` a seed or ``(seed, chain)``, ``scal_f``, ``scal_i``,
    the P^2 state ``qh``/``qn``), plus the row ``band`` and ``halo`` of the
    tiling, checked as the JAX package checks them; a chain axis ``(C, ny,
    nx)`` as kernel 2's. No warm dual: the TV prox and the ME-TV envelope
    start cold every step. Returns ``(x', mean', m2', qh', qn')``. CUDA
    tensors run the hand kernel, CPU tensors its plain version.
    """
    if x.is_cuda:
        return myula_tv_tiled_update_cuda(x, *args, **kwargs)
    return myula_tv_tiled_update_ref(x, *args, **kwargs)


def _tiled_block(n_steps: int, block: Optional[int]) -> int:
    """The largest even divisor of ``n_steps`` up to ``block`` (default
    ``min(n_steps, 256)``), as the JAX runners pick it."""
    block = min(n_steps, 256) if block is None else block
    block -= block % 2
    while block > 0 and n_steps % block:
        block -= 2
    if block <= 0:
        raise ValueError(f"n_steps={n_steps} must be even")
    return block


def _check_thin(quantiles, block: int, quantile_thin: int) -> None:
    if quantiles and block % quantile_thin:
        # record steps follow (g + 1) % thin == 0 with a dynamic guard, so
        # only the block boundaries need aligning
        raise ValueError(f"block={block} must be a multiple of "
                         f"quantile_thin={quantile_thin}")


def run_myula_tv_tiled(
    l2: Any,
    tv_sigma: float,
    tau,
    gamma,
    x0,
    key,
    n_steps: int,
    *,
    niter_tv: int = 10,
    burn_in: int = 0,
    block: Optional[int] = None,
    noise_scale: float = 1.0,
    tv_solver: str = "chambolle",
    band: Optional[int] = None,
    halo: Optional[int] = None,
    quantiles: Tuple[float, ...] = (),
    quantile_thin: int = 1,
    quantile_state=None,
    step_offset: int = 0,
    interpret: bool = False,
    stream_x: Optional[bool] = None,
) -> FusedChainResult:
    """Tiled fused MYULA chain for large images (2048^2 and up): a host loop
    over blocks of ``block`` (even) steps, kernel 6 per block on CUDA.

    Same chain as ``run_myula_tv_fused`` without ``tv_warm``: weighted
    Welford with ``burn_in``, optional P^2 ``quantiles`` thinned by
    ``quantile_thin`` (any thin that divides the block), ``quantile_state``
    and ``step_offset`` to continue a run. ``band``/``halo`` default as in
    the JAX package (``halo`` the need rounded up to 8, ``band`` from
    ``pick_band``). ``interpret`` and ``stream_x`` are the JAX package's
    (Pallas interpret mode; streaming the position from HBM past its VMEM
    ceiling) and take no effect: kernel 6 reads every band from device
    memory, and a CPU tensor runs the plain version. A chain axis ``x0``
    ``(C, ny, nx)`` runs as ``run_myula_tv_fused``'s, ``C`` chains a kernel
    call."""
    taps, (oy, ox), atbs = _fused_params(l2)
    mode, lamda, gamma_mc, niter_inner = _fused_mode(l2)
    x0 = torch.as_tensor(x0)
    key = runner_keys(x0, key)
    if halo is None:
        halo = _round8(max(_halo_need(niter_tv, oy, mode, niter_inner), 8))
    if band is None:
        band = pick_band(x0.shape[-2], halo)
    block = _tiled_block(n_steps, block)
    quantiles = tuple(float(p) for p in quantiles)
    _check_thin(quantiles, block, quantile_thin)
    scal_f = _pack_scal_f(l2, tau, gamma, tv_sigma, noise_scale, lamda,
                          gamma_mc)
    step_offset = int(step_offset)
    x, mean, m2 = x0, torch.zeros_like(x0), torch.zeros_like(x0)
    qh, qn = _marker_state(x0, len(quantiles), quantile_state)
    for b in range(n_steps // block):
        step0 = step_offset + b * block
        cnt0 = max(step0 - max(burn_in, step_offset), 0)
        x, mean, m2, qh, qn = myula_tv_tiled_update(
            x, atbs, mean, m2, key, scal_f, (step0, burn_in, cnt0), qh, qn,
            taps=taps, oy=oy, ox=ox, n_steps=block, niter_tv=niter_tv,
            band=band, halo=halo, with_noise=noise_scale != 0.0,
            tv_solver=tv_solver, quantiles=quantiles,
            quantile_thin=quantile_thin, mode=mode, niter_inner=niter_inner,
        )
    count = (max(step_offset + n_steps - burn_in, 0)
             - max(step_offset - burn_in, 0))
    return _chain_result(x, mean, m2, count, quantiles, qh, qn)
