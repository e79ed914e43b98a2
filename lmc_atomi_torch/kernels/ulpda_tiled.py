"""Tiled fused ULPDA TV for large images (counterpart of
``lmc_atomi_tpu/kernels/ulpda_tiled.py``): kernel 7, its plain torch
version, and the host-side block loop.

The tiling of ``myula_tiled.py`` applied to the primal-dual step of
``ulpda_fused.py``, in two passes:

- the dual pass ``p <- proj(p + mu grad xbar)`` is row-local: it reads only
  its own pixel's dual and xbar one row and one column on, so it updates the
  dual in place. ``xbar = x_new + theta (x_new - x_old)`` is recomputed from
  the two x parity buffers, never stored: with ``gfirst=False`` the pass
  runs after the primal on ``(new, old)``; with ``gfirst=True`` before it on
  ``(current, stale partner)``, the partner being x from one step back,
  which is what the previous step's extrapolation used. A stored-zero dual
  at the image's last row (py) and column (px) stays zero;
- the primal pass is a halo tile: ``v = x + tau div p``, the MC-TV or ME-TV
  correction (the envelope a cold Chambolle prox at step 0.25), ``rhs = v +
  tau sigma A^T b`` and ``niter_solve`` Chebyshev sweeps of the gram solve
  warm started at x, so the halo must absorb ``niter_solve`` gram radii on
  top of the correction (``_ulpda_halo_need``).

``ulpda_tv_tiled_update_ref`` computes band by band as the TPU kernel does;
``ulpda_tv_tiled_update_cuda`` runs ``csrc/tiled_block.cu``, two launches a
step (the dual pass one thread per pixel, the primal pass 2-D tiles in
shared memory, each CTA computing only the cone its interior reads, without
the boundary masks on edge-free tiles), on ``ulpda_tiled_plan``'s geometry,
the one of least cone work per step on the card, kept in ``last_plan``.
The noise is the Philox normal at the global pixel and step, and each
pixel's operations come in kernel 3's order, so a tiled chain equals
``run_ulpda_fused`` (``env_warm=False``, Chambolle envelope) bit for bit. Not
ported: the TPU's ``stream_x`` layout and its VMEM budget.

A call takes one chain ``(ny, nx)`` or ``C`` chains of one posterior
``(C, ny, nx)`` (``x``, ``xp``, ``py``, ``px``, the moments; the markers
``(C, k n_q, ny, nx)``) under ``C`` chain keys sharing one seed, as kernel
3 does: on the card the dual and the primal launch of a step each carry
every chain as a grid layer, the plain version runs the chains one after
another, and chain ``c`` is bit for bit the one-chain call under key ``c``.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import numpy as np
import torch

from lmc_atomi_torch import _build
from lmc_atomi_torch.core.random import normal_field
from lmc_atomi_torch.kernels.imaging import ULPDAExtras
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
    _marker_state,
    _mctv_clamp,
    _p2_coefs,
    _tv_prox,
    chain_seeds,
    per_chain,
    runner_keys,
)
from lmc_atomi_torch.kernels.myula_tiled import (
    _RESERVED_SMEM,
    _SM_THREADS,
    _band_masks,
    _check_thin,
    _check_tiles,
    _free_lines,
    _read_tile,
    _round8,
    _tile_rows,
    _tiled_block,
    pick_band,
)
from lmc_atomi_torch.kernels.ulpda_fused import (
    DUALS,
    _block_coefs,
    _chebyshev_coefs,
    _chebyshev_gram_solve,
    _dual_project,
    _pack_ulpda_scal,
    _ulpda_halo,
    _ulpda_setup,
)
from lmc_atomi_torch.ops.tv_cuda import _stencils
from lmc_atomi_torch.run.runner import base_key

__all__ = [
    "ulpda_tiled_plan",
    "ulpda_tv_tiled_update",
    "ulpda_tv_tiled_update_cuda",
    "ulpda_tv_tiled_update_ref",
    "run_ulpda_tv_tiled",
]

_ENV_STEP = 0.25  # the tiled envelope prox: cold Chambolle at this step


def _ulpda_halo_need(niter_solve: int, oy: int, mode: str,
                     niter_inner: int) -> int:
    """One primal pass's seam-contamination depth: the nonconvex correction
    composes with the divergence (depth 1) before the Chebyshev solve's
    ``niter_solve`` gram applications (depth ``oy`` each)."""
    corr = {"tv": 0, "mctv": 2}.get(mode, niter_inner + 1)
    return niter_solve * oy + 1 + corr


def _ulpda_tile_work(ty, tx, h, reach, ry, rank, niter_solve, mode, niter_inner) -> int:
    """Pixel passes of one CTA's primal step on its cone
    (``csrc/block_common.cuh::ul_primal_cone``): the loads of x and the
    dual, v, the MC-TV clamp and rhs or the envelope trips (a zeroing pass
    over the tile, two passes a trip) and rhs, per sweep and rank the gram's
    row pass (the rows within ``ry`` of the sweep's rectangle) and its
    column pass fused with the update, and the finish on the interior
    (counted twice: the Philox normal)."""
    def area(e):
        return (ty + 2 * e) * (tx + 2 * e)

    e = reach * max(niter_solve - 1, 0)
    ev = e + {"tv": 0, "mctv": 2}.get(mode, niter_inner)
    w = area(max(e + reach if niter_solve else 0, ev)) + area(ev + 1) + area(ev)
    if mode == "mctv":
        w += area(e + 1) + area(e)
    elif mode == "metv":
        w += area(h) + 2 * sum(area(e + k) for k in range(1, niter_inner + 1)) + area(e)
    for k in range(niter_solve):
        g = reach * (niter_solve - 1 - k)
        w += rank * ((ty + 2 * g + 2 * ry) * (tx + 2 * g) + area(g))
    return w + 2 * ty * tx


@functools.lru_cache(maxsize=64)
def _ulpda_tiled_ranking(shape, taps: Taps, oy: int, ox: int, *, niter_solve: int = 3,
                         mode: str = "tv", niter_inner: int = 10, n_sm: int = H100_SMS,
                         smem_limit: int = H100_SMEM_OPTIN, n_chains: int = 1):
    """Every geometry ``ulpda_tiled_plan`` weighs, as its ``(ty, tx, h,
    threads, edge_tiles, tiles)``, in the order of its ranking: least cost
    first. Computed once per shape, options and chain count: the wrapper
    asks on every call."""
    if not 0 <= niter_solve <= _MAX_TRIPS or not 0 <= niter_inner <= _MAX_TRIPS:
        return ()
    ny, nx = shape
    ky, kx = len(taps[0][0]), len(taps[0][1])
    ry = max(oy, ky - 1 - oy)
    reach = max(ry, ox, kx - 1 - ox)
    h = _ulpda_halo(taps, oy, ox, niter_solve, mode, niter_inner)
    cands = []
    for threads in (512, 1024):
        per_sm = _SM_THREADS // threads
        for ty in range(8, ny + 8, 8):
            for tx in range(8, nx + 8, 8):
                sy, sx = ty + 2 * h, tx + 2 * h
                cta = 4 * 5 * sy * sx + 4 * (sy + sx) + 4 * 2 * _MAX_TRIPS
                if (cta > smem_limit
                        or per_sm * (cta + _RESERVED_SMEM) > smem_limit + _RESERVED_SMEM):
                    break
                tiles = -(-ny // ty) * -(-nx // tx)
                # the primal launch's CTAs: every chain's tiles
                waves = -(-tiles * n_chains // (n_sm * per_sm))
                cost = waves * per_sm * _ulpda_tile_work(ty, tx, h, reach, ry, len(taps),
                                                         niter_solve, mode, niter_inner)
                cands.append((cost, threads, ty, tx, tiles))
    return tuple((ty, tx, h, threads, tiles - _free_lines(ny, ty, h) * _free_lines(nx, tx, h),
                  tiles) for _, threads, ty, tx, tiles in sorted(cands))


def ulpda_tiled_plan(shape, taps: Taps, oy: int, ox: int, *, niter_solve: int = 3,
                     mode: str = "tv", niter_inner: int = 10, n_sm: int = H100_SMS,
                     smem_limit: int = H100_SMEM_OPTIN, n_chains: int = 1):
    """Kernel 7's primal geometry for ``n_chains`` chains a call on a card
    of ``n_sm`` SMs whose CTA takes at most ``smem_limit`` bytes of shared
    memory, the one the wrapper launches: ``(ty, tx, h, threads,
    edge_tiles, tiles)`` (tiles a chain), or ``None`` when nothing fits. A
    step is a dual and a primal launch, each carrying every chain as a grid
    layer (all ``n_chains`` chains a launch, one launch of each in turn).

    Kernel 6's rule (``myula_tiled.tiled_plan``) on kernel 7's cone: the
    halo ``h`` is the cone's (``ulpda_fused._ulpda_halo``, each sweep on its
    cone); candidates are the interiors ``ty x tx`` (multiples of 8) at 512
    threads a CTA (two CTAs an SM) or 1024 (one) whose shared memory (5
    tile fields, the row and column indices, 128 floats of Chebyshev
    coefficients) fits, 1 KiB reserved a CTA; a step costs the waves
    ``ceil(tiles / (n_sm *
    per_sm))`` times the CTAs of a wave on an SM times one CTA's cone work
    (``_ulpda_tile_work``), the waves over every chain's tiles; the least
    cost wins, ties to fewer threads, then the smaller ``ty`` and ``tx``.
    ``edge_tiles`` counts the tiles that are not edge-free."""
    ranking = _ulpda_tiled_ranking(tuple(shape), taps, oy, ox, niter_solve=niter_solve,
                                   mode=mode, niter_inner=niter_inner, n_sm=n_sm,
                                   smem_limit=smem_limit, n_chains=n_chains)
    return ranking[0] if ranking else None


def _check_ulpda_tiled(x, taps, oy, n_steps, band, halo, niter_solve, mode,
                       niter_inner, dual, quantiles, quantile_thin):
    _check_block_args(taps, quantiles, quantile_thin, "chambolle", mode)
    if dual not in DUALS[:2]:
        raise ValueError(f"dual {dual!r}: the tiled ULPDA takes {DUALS[:2]}")
    if niter_solve < 0:
        raise ValueError("niter_solve must be >= 0")
    if x.ndim not in (2, 3):
        raise ValueError(f"x must be an (ny, nx) image or a (C, ny, nx) chain axis, "
                         f"got {tuple(x.shape)}")
    _check_tiles(x.shape[-2:], n_steps, band, halo,
                 _ulpda_halo_need(niter_solve, oy, mode, niter_inner),
                 "niter_solve * oy + 1, plus the nonconvex correction's "
                 f"depth for mode={mode!r}")


def ulpda_tv_tiled_update_ref(
    x, xp, py, px, atb, mean, m2, seed, scal_f, scal_i, qh=None, qn=None, *,
    taps: Taps, oy: int, ox: int, lam: float, n_steps: int,
    niter_solve: int = 3, band: int, halo: int, gfirst: bool = False,
    dual: str = "l21", with_noise: bool = True,
    quantiles: Tuple[float, ...] = (), quantile_thin: int = 1,
    mode: str = "tv", niter_inner: int = 0,
):
    """Plain torch version of kernel 7 (see ``ulpda_tv_tiled_update``), band
    by band in both passes; a chain axis runs its chains one after
    another."""
    _check_ulpda_tiled(x, taps, oy, n_steps, band, halo, niter_solve, mode,
                       niter_inner, dual, quantiles, quantile_thin)
    if x.ndim == 3:
        chain_seeds(seed, x)
        kw = dict(taps=taps, oy=oy, ox=ox, lam=lam, n_steps=n_steps,
                  niter_solve=niter_solve, band=band, halo=halo, gfirst=gfirst,
                  dual=dual, with_noise=with_noise, quantiles=quantiles,
                  quantile_thin=quantile_thin, mode=mode, niter_inner=niter_inner)

        def one(xc, xpc, pyc, pxc, mc, m2c, qhc, qnc, key):
            return ulpda_tv_tiled_update_ref(xc, xpc, pyc, pxc, atb, mc, m2c, key,
                                             scal_f, scal_i, qhc, qnc, **kw)
        return per_chain(one, x, seed, (xp, py, px, mean, m2, qh, qn))
    (tau, mu, theta, noise_amp, ts, g_sigma, c_mc, gamma_mc, _,
     c_me) = _block_coefs(scal_f)
    seed, chain = base_key(seed)
    ny, nx = x.shape
    n_bands = ny // band
    masks = [_band_masks(b, n_bands, band, halo, nx, x.dtype, x.device)
             for b in range(n_bands)]
    rec = _BlockStats(scal_i, mean, m2, qh, qn, quantiles, quantile_thin, True)

    def tile(f, b):
        return _read_tile(f, b, band, halo)

    def dual_pass(py, px, x_new, x_old):
        ys, xs = [], []
        for b in range(n_bands):
            rows, inner = _tile_rows(b, band, halo)
            xn = tile(x_new, b)
            xbar = xn + theta * (xn - tile(x_old, b))
            fwd_y, fwd_x, _ = _stencils(xbar, masks[b])
            cy, cx = _dual_project(py[rows] + mu * fwd_y(xbar)[inner],
                                   px[rows] + mu * fwd_x(xbar)[inner],
                                   dual, g_sigma)
            ys.append(cy)
            xs.append(cx)
        return torch.cat(ys), torch.cat(xs)

    def primal_pass(g, x):
        noise = (normal_field(seed, chain, g, x.shape, x.dtype, x.device)
                 if with_noise else None)
        bands = []
        for b in range(n_bands):
            rows, inner = _tile_rows(b, band, halo)
            xt = tile(x, b)
            stencils = _stencils(xt, masks[b])
            div = stencils[2]
            aty = -div(tile(py, b), tile(px, b))
            v = xt - tau * aty
            if mode == "mctv":
                v = v - c_mc * div(*_mctv_clamp(v, gamma_mc, stencils))
            elif mode == "metv":
                p, _ = _tv_prox(v, gamma_mc, niter_inner, _ENV_STEP, stencils)
                v = v + c_me * (v - p)
            rhs = v + ts * tile(atb, b)
            u = _chebyshev_gram_solve(rhs, xt, ts, lam, taps, oy, ox,
                                      niter_solve)[inner]
            if noise is not None:
                u = u + noise_amp * noise[rows]
            bands.append(u)
        return torch.cat(bands)

    for i in range(n_steps):
        g = rec.step0 + i
        if gfirst:
            py, px = dual_pass(py, px, x, xp)
        x_new = primal_pass(g, x)
        if not gfirst:
            py, px = dual_pass(py, px, x_new, x)
        rec(x_new, g)
        xp, x = x, x_new
    mean, m2, qh, qn = rec.result()
    return x, xp, py, px, mean, m2, qh, qn


def ulpda_tv_tiled_update_cuda(
    x, xp, py, px, atb, mean, m2, seed, scal_f, scal_i, qh=None, qn=None, *,
    taps: Taps, oy: int, ox: int, lam: float, n_steps: int,
    niter_solve: int = 3, band: int, halo: int, gfirst: bool = False,
    dual: str = "l21", with_noise: bool = True,
    quantiles: Tuple[float, ...] = (), quantile_thin: int = 1,
    mode: str = "tv", niter_inner: int = 0,
):
    """Kernel 7 (``csrc/tiled_block.cu``) on contiguous float32 CUDA tensors,
    one chain or a chain axis: two launches per step, each carrying every
    chain, the primal pass on ``ulpda_tiled_plan``'s geometry for the card
    and the chains, kept in ``last_plan``. Works on copies of ``x, xp, py,
    px, mean, m2, qh, qn`` and returns them; raises on a CPU tensor, on
    options the kernel does not take, or when no geometry fits."""
    _check_ulpda_tiled(x, taps, oy, n_steps, band, halo, niter_solve, mode,
                       niter_inner, dual, quantiles, quantile_thin)
    ny, nx = x.shape[-2:]
    lead = tuple(x.shape[:-2])
    n_q = len(quantiles)
    _build.require_cuda_f32(x.shape, x=x, xp=xp, py=py, px=px, mean=mean, m2=m2)
    _build.require_cuda_f32((ny, nx), atb=atb)
    if n_q:
        _build.require_cuda_f32(lead + (5 * n_q, ny, nx), qh=qh)
        _build.require_cuda_f32(lead + (3 * n_q, ny, nx), qn=qn)
    if any(t.device != x.device for t in (atb, qh, qn) if t is not None):
        raise ValueError("atb and the marker state must lie on x's device")
    step0, burn, cnt0 = _build.check_steps(scal_i, n_steps)
    seed, words = chain_seeds(seed, x)
    chains = _chain_words(words, x.device)

    x, xp, py, px = x.clone(), xp.clone(), py.clone(), px.clone()
    mean, m2 = mean.clone(), m2.clone()
    if n_q:
        qh, qn = qh.clone(), qn.clone()
    rank, ky, kx = len(taps), len(taps[0][0]), len(taps[0][1])
    tap_arr = np.array([v for wy, wx in taps for v in (*wy, *wx)], np.float32)
    coefs = _block_coefs(scal_f)
    coef = np.array(coefs, np.float32)
    cheb = np.array(_chebyshev_coefs(coefs[4], lam, niter_solve) or [(0.0, 0.0)],
                    np.float32)
    qcoef = np.array([_p2_coefs(p) for p in quantiles] or [(0.0,) * 3], np.float32)

    n_sm, smem_limit = _build.card_limits(x.device)
    plan = ulpda_tiled_plan((ny, nx), taps, int(oy), int(ox), niter_solve=int(niter_solve),
                            mode=mode, niter_inner=int(niter_inner), n_sm=n_sm,
                            smem_limit=smem_limit, n_chains=len(words))
    if plan is None:
        raise ValueError(f"no kernel-7 tile fits {smem_limit} bytes of shared memory")
    ty, tx, _, threads, _, _ = plan

    def ptr(t, used):
        return t.data_ptr() if used else None

    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmc_ulpda_tiled(
            x.data_ptr(), xp.data_ptr(), py.data_ptr(), px.data_ptr(),
            atb.data_ptr(), mean.data_ptr(), m2.data_ptr(), ptr(qh, n_q),
            ptr(qn, n_q), ny, nx, len(words), ptr(chains, chains is not None),
            tap_arr.ctypes.data, rank, ky, kx, int(oy),
            int(ox), int(n_steps), int(niter_solve), cheb.ctypes.data,
            int(bool(gfirst)), DUALS.index(dual), MODES.index(mode),
            int(niter_inner), int(bool(with_noise)), qcoef.ctypes.data, n_q,
            int(quantile_thin), coef.ctypes.data, seed & 0xFFFFFFFF,
            words[0] & 0xFFFFFFFF, step0, burn, cnt0, ty, tx, threads, stream,
        )
    _build.check(rc, "lmc_ulpda_tiled")
    ulpda_tv_tiled_update_cuda.launches += 1
    ulpda_tv_tiled_update_cuda.last_plan = plan
    return x, xp, py, px, mean, m2, qh, qn


ulpda_tv_tiled_update_cuda.launches = 0  # calls that launched the kernel
ulpda_tv_tiled_update_cuda.last_plan = None  # the last launch's ulpda_tiled_plan


def ulpda_tv_tiled_update(x, *args, **kwargs):
    """``n_steps`` (even) tiled fused ULPDA steps + Welford / P^2, kernel 7.

    ``xp`` is the previous sample (the x parity partner); ``(py, px)`` the
    Gradient2D dual (``"l21"`` or ``"l1"``), ``atb = A^T b`` (unscaled);
    ``seed``, ``scal_f`` and ``scal_i`` as ``ulpda_fused.ulpda_block_update``'s;
    ``lam`` bounds ``lambda_max(A^T A)``; ``niter_solve`` Chebyshev sweeps;
    ``mode`` ``"tv"``/``"mctv"``/``"metv"`` (a cold Chambolle envelope of
    ``niter_inner`` trips); ``band``/``halo`` checked as the JAX package
    checks them; a chain axis ``(C, ny, nx)`` (every field but ``atb``) as
    kernel 3's. Returns ``(x', xp', py', px', mean', m2', qh', qn')``. CUDA
    tensors run the hand kernel, CPU tensors its plain version.
    """
    if x.is_cuda:
        return ulpda_tv_tiled_update_cuda(x, *args, **kwargs)
    return ulpda_tv_tiled_update_ref(x, *args, **kwargs)


def run_ulpda_tv_tiled(
    proxf: Any,
    proxg: Any,
    a_op: Any,
    tau,
    mu,
    x0,
    key,
    n_steps: int,
    *,
    theta: float = 1.0,
    gfirst: bool = False,
    niter_solve: int = 3,
    burn_in: int = 0,
    block: Optional[int] = None,
    noise_scale: float = 1.0,
    band: Optional[int] = None,
    halo: Optional[int] = None,
    quantiles: Tuple[float, ...] = (),
    quantile_thin: int = 1,
    quantile_state=None,
    step_offset: int = 0,
    y0=None,
    xbar0=None,
    xprev0=None,
    interpret: bool = False,
    stream_x: Optional[bool] = None,
) -> FusedChainResult:
    """Tiled fused ULPDA chain for large images: a host loop over blocks of
    ``block`` (even) steps, kernel 7 per block on CUDA, with Welford moments
    and optional P^2 ``quantiles``.

    Same chain as ``run_ulpda_fused`` with a ``Gradient2D`` dual
    (``L21Norm``/``L1Norm``) and ``proxf`` an ``L2Data`` or isotropic
    ``L2NcvxTV``. ``y0``/``xbar0`` resume a dual and extrapolation state;
    ``xprev0`` (the returned ``extras.xprev``) takes precedence over
    ``xbar0`` and resumes bit for bit (inverting xbar costs a rounding that
    the extrapolation amplifies). ``final_state.extras`` holds ``y``,
    ``xbar = x + theta (x - xprev)`` and ``xprev``. ``interpret`` and
    ``stream_x`` are the JAX package's (Pallas interpret mode; streaming the
    position from HBM) and take no effect: kernel 7 reads every band from
    device memory, and a CPU tensor runs the plain version. A chain axis
    ``x0`` ``(C, ny, nx)`` runs ``C`` chains a kernel call, as
    ``run_ulpda_fused``'s; ``y0`` and ``extras.y`` are then ``(C, 2, ny,
    nx)``, the other fields ``(C, ny, nx)``."""
    (taps, (oy, ox), atb, mode, lamda, gamma_mc, niter_inner, dual,
     lam, _) = _ulpda_setup(proxf, proxg, a_op)
    if dual == "wl1":
        raise ValueError("tiled fused ULPDA supports Gradient2D duals only")
    x0 = torch.as_tensor(x0)
    key = runner_keys(x0, key)
    if halo is None:
        halo = _round8(max(_ulpda_halo_need(niter_solve, oy, mode, niter_inner), 8))
    if band is None:
        band = pick_band(x0.shape[-2], halo)
    block = _tiled_block(n_steps, block)
    quantiles = tuple(float(p) for p in quantiles)
    _check_thin(quantiles, block, quantile_thin)
    scal_f = _pack_ulpda_scal(proxf, proxg, tau, mu, theta, noise_scale, lamda,
                              gamma_mc)
    step_offset = int(step_offset)
    zeros = torch.zeros_like(x0)
    py, px = ((zeros, zeros) if y0 is None
              else tuple(p.contiguous() for p in torch.as_tensor(y0).unbind(-3)))
    if xprev0 is not None:
        xp = torch.as_tensor(xprev0)
    elif xbar0 is None or theta == 0.0:
        xp = x0
    else:
        # invert xbar = (1 + theta) x - theta x_prev for the parity partner
        xp = ((1.0 + theta) * x0 - torch.as_tensor(xbar0)) / theta
    x, mean, m2 = x0, zeros, zeros
    qh, qn = _marker_state(x0, len(quantiles), quantile_state)
    for b in range(n_steps // block):
        step0 = step_offset + b * block
        cnt0 = max(step0 - max(burn_in, step_offset), 0)
        x, xp, py, px, mean, m2, qh, qn = ulpda_tv_tiled_update(
            x, xp, py, px, atb, mean, m2, key, scal_f, (step0, burn_in, cnt0),
            qh, qn, taps=taps, oy=oy, ox=ox, lam=lam, n_steps=block,
            niter_solve=niter_solve, band=band, halo=halo, gfirst=gfirst,
            dual=dual, with_noise=noise_scale != 0.0, quantiles=quantiles,
            quantile_thin=quantile_thin, mode=mode, niter_inner=niter_inner,
        )
    count = (max(step_offset + n_steps - burn_in, 0)
             - max(step_offset - burn_in, 0))
    extras = ULPDAExtras(y=torch.stack([py, px], dim=-3), xbar=x + theta * (x - xp),
                         xprev=xp)
    return _chain_result(x, mean, m2, count, quantiles, qh, qn, extras)
