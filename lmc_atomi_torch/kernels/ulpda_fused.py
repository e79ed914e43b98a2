"""Fused ULPDA, the Langevin primal-dual sampler (counterpart of
``lmc_atomi_tpu/kernels/ulpda_fused.py``): kernel 3, its plain torch
version, and the host-side block loop.

One block call runs ``n_steps`` steps of ``kernels/imaging.py::ulpda`` for
the deconvolution posterior: a forward-difference ``Gradient2D`` dual
(``L21Norm``, ``"l21"``, or ``L1Norm``, ``"l1"``) or an orthogonal Haar
wavelet dual (``HaarDWT2D`` with ``L1Norm``, ``"wl1"``: one coefficient
field in the interleaved layout of ``wavelet_fused.py``, clipped to the l-inf
ball, ``A^T y = haar_interleaved_inv(y)``), a data term ``L2Data``
(``mode="tv"``) or an isotropic ``L2NcvxTV`` (``"mctv"``/``"metv"``, the
concave part linearized as in ``ops/ncvx_tv.py::prox``) over a circulant blur
with a small PSF, and in place of the exact spectral solve of
``(I + tau sigma A^T A) u = v + tau sigma A^T b`` a fixed-trip Chebyshev
semi-iteration warm started at the current x, with ``A^T A`` as separable
wrap convolutions (the taps of ``myula_fused.py``). Noise is the Philox
normal at ``(seed, chain, step)`` (``core/random.py::normal_field``), so the
fused and unfused samplers draw one stream. Both ``gfirst`` orders, Welford
moments with burn-in.

``ulpda_block_update`` dispatches by device: ``csrc/ulpda_block.cu`` for CUDA
tensors, ``ulpda_block_update_ref`` (the same function in torch ops, term for
term) for CPU tensors. On the card kernel 3 takes one of two routes, chosen
from the shape, the options and the card before any launch: the resident
route (one cooperative launch per call, every CTA a 2-D halo tile of the
image computing only the cone its interior reads, where
``ulpda_resident_plan`` finds a tiling of at most one CTA an SM whose tile
fits; 512^2 with a Gradient2D dual) or the launch sequence (a few launches
per step, the fields in device memory; 2048^2 and up, and the ``"wl1"``
dual, whose transforms take the route ``_wl1_plan`` names: up to
``_TILE_LEVELS`` levels one launch whose CTAs own whole ``2^levels`` tiles,
past that one launch per level and axis). The wrapper counts the calls of
each route. A Gradient2D dual takes a chain axis as kernel 2 does
(``ulpda_resident_plan`` names the chains a launch); ``run_ulpda_fused_packed``
is the multi-chain runner.
"""
from __future__ import annotations

import functools
import math
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from lmc_atomi_torch import _build
from lmc_atomi_torch.core.random import chain_keys, normal_field
from lmc_atomi_torch.core.state import SamplerState, StepInfo
from lmc_atomi_torch.core.stats import RunningMoments
from lmc_atomi_torch.kernels.base import Kernel
from lmc_atomi_torch.kernels.imaging import ULPDAExtras
from lmc_atomi_torch.kernels.myula_fused import (
    _MAX_TRIPS,
    H100_SMEM_OPTIN,
    H100_SMS,
    MODES,
    FusedChainResult,
    Taps,
    _BlockStats,
    _chain_words,
    _check_block_args,
    _fgp_coef,
    _fused_mode,
    _fused_params,
    _mctv_clamp,
    _offset_seed,
    _sep_gram,
    _map_result,
    _tv_prox_any,
    chain_seeds,
    chains_per_launch,
    pack_lanes,
    per_chain,
    sep_fused_supported,
    unpack_lanes,
)
from lmc_atomi_torch.kernels.wavelet_fused import (
    _TILE_LEVELS,
    _iotas,
    haar_interleaved,
    haar_interleaved_inv,
    haar_levels,
    tile_region,
)
from lmc_atomi_torch.ops.functionals import L1Norm, L21Norm
from lmc_atomi_torch.ops.linops import Gradient2D
from lmc_atomi_torch.ops.tv_cuda import _stencils
from lmc_atomi_torch.ops.wavelet import HaarDWT2D
from lmc_atomi_torch.run.runner import base_key

__all__ = [
    "ulpda_fused_supported",
    "ulpda_block_update",
    "ulpda_block_update_cuda",
    "ulpda_block_update_ref",
    "ulpda_resident_plan",
    "ulpda_sep_fused",
    "run_ulpda_fused",
    "run_ulpda_fused_packed",
]

DUALS = ("l1", "l21", "wl1")  # the kernel's dual index


def ulpda_fused_supported(proxf, proxg, a_op, x) -> bool:
    """Whether the fused ULPDA kernel applies: a ``Gradient2D(sampling=1)``
    dual with ``L21Norm``/``L1Norm`` or a ``HaarDWT2D`` dual with ``L1Norm``,
    a data term the MYULA block takes (``myula_fused._fused_mode``) over an
    operator that ``sep_fused_supported`` accepts for images like ``x`` (on a
    CUDA device)."""
    if isinstance(a_op, Gradient2D) and float(a_op.sampling) == 1.0:
        if not isinstance(proxg, (L21Norm, L1Norm)):
            return False
    elif isinstance(a_op, HaarDWT2D):
        if not isinstance(proxg, L1Norm):
            return False
    else:
        return False
    if not sep_fused_supported(getattr(proxf, "op", None), x):
        return False
    try:
        _fused_mode(proxf)
    except ValueError:
        return False
    return True


def _chebyshev_coefs(ts: float, lam: float, niter: int) -> List[Tuple[float, float]]:
    """Per-sweep ``(c_d, c_r)`` of the Chebyshev semi-iteration on the
    spectrum bound ``[1, 1 + ts lam]``, in Python floats: sweep 0 takes
    ``d = r c_r`` (``c_r = 1/theta``), sweep k > 0
    ``d = c_d d + c_r r`` (``c_d = rho_k rho_{k-1}``,
    ``c_r = 2 rho_k / delta``). Kernel and plain version take the same
    floats, so they round alike."""
    a, b = 1.0, 1.0 + ts * lam
    theta = 0.5 * (b + a)
    delta = 0.5 * (b - a)
    sigma = theta / delta
    out = [(0.0, 1.0 / theta)] if niter > 0 else []
    rho_prev = 1.0 / sigma
    for _ in range(1, niter):
        rho = 1.0 / (2.0 * sigma - rho_prev)
        out.append((rho * rho_prev, 2.0 * rho / delta))
        rho_prev = rho
    return out


def _chebyshev_gram_solve(rhs, u0, ts, lam, taps, oy, ox, niter: int):
    """Fixed-trip Chebyshev semi-iteration for ``(I + ts A^T A) u = rhs``,
    warm started at ``u0``, spectrum bound ``[1, 1 + ts lam]`` (error after
    K sweeps at most ``2 / cosh(K acosh(sigma))`` of the start's)."""
    u, d = u0, None
    for k, (c_d, c_r) in enumerate(_chebyshev_coefs(ts, lam, niter)):
        r = rhs - (u + ts * _sep_gram(u, taps, oy, ox))
        d = r * c_r if k == 0 else c_d * d + c_r * r
        u = u + d
    return u


def _block_coefs(scal_f):
    """``(tau, mu, theta, noise_scale sqrt(2 tau), tau sigma, g_sigma,
    tau lamda, gamma_mc, 1/gamma_mc, tau lamda / gamma_mc)`` as Python floats
    from ``scal_f = (tau, mu, theta, noise_scale, sigma, g_sigma[, lamda,
    gamma_mc])``."""
    tau, mu, theta, noise_scale, sigma, g_sigma = (float(v) for v in scal_f[:6])
    lamda, gamma_mc = ((float(scal_f[6]), float(scal_f[7])) if len(scal_f) > 6
                       else (0.0, 1.0))
    return (tau, mu, theta, noise_scale * math.sqrt(2.0 * tau), tau * sigma,
            g_sigma, tau * lamda, gamma_mc, 1.0 / gamma_mc,
            tau * lamda / gamma_mc)


def _dual_project(cy, cx, dual: str, g_sigma: float):
    """The Gradient2D duals' projection: onto the per-pixel l2 ball of radius
    ``g_sigma`` (``"l21"``) or the l-inf box (``"l1"``)."""
    if dual == "l21":
        nrm = torch.sqrt(cy * cy + cx * cx)
        # g_sigma / n, written as torch computes it: (1 / n) * g_sigma
        scale = torch.clamp(
            torch.reciprocal(torch.clamp(nrm, min=1e-30)) * g_sigma, max=1.0)
        return cy * scale, cx * scale
    return torch.clamp(cy, -g_sigma, g_sigma), torch.clamp(cx, -g_sigma, g_sigma)


def _check_chain_axis(dual):
    if dual == "wl1":
        raise ValueError(
            "a chain axis is unsupported for the wavelet dual (as the JAX "
            "package's lane packing: the fused ULPDA packs Gradient2D duals only)")


def _check_ulpda_args(taps, tv_solver, mode, dual, niter_solve):
    _check_block_args(taps, (), 1, tv_solver, mode)
    if dual not in DUALS:
        raise ValueError(f"dual {dual!r}: the fused ULPDA takes {DUALS}")
    if niter_solve < 0:
        raise ValueError("niter_solve must be >= 0")


def ulpda_block_update_ref(
    x, py, px, xbar, atb, mean, m2, seed, scal_f, scal_i, *,
    taps: Taps, oy: int, ox: int, lam: float = 1.0, n_steps: int = 1,
    niter_solve: int = 3, tv_step: float = 0.25, gfirst: bool = False,
    dual: str = "l21", mode: str = "tv", niter_inner: int = 10,
    with_noise: bool = True, tv_solver: str = "chambolle",
    with_stats: bool = True, env_warm: bool = False, levels: int = 3,
):
    """Plain torch version of kernel 3 (see ``ulpda_block_update``); a
    chain axis runs its chains one after another."""
    _check_ulpda_args(taps, tv_solver, mode, dual, niter_solve)
    if x.ndim == 3:
        _check_chain_axis(dual)
        chain_seeds(seed, x)

        def one(xc, pyc, pxc, xbc, mc, m2c, key):
            return ulpda_block_update_ref(
                xc, pyc, pxc, xbc, atb, mc, m2c, key, scal_f, scal_i, taps=taps,
                oy=oy, ox=ox, lam=lam, n_steps=n_steps, niter_solve=niter_solve,
                tv_step=tv_step, gfirst=gfirst, dual=dual, mode=mode,
                niter_inner=niter_inner, with_noise=with_noise, tv_solver=tv_solver,
                with_stats=with_stats, env_warm=env_warm, levels=levels)
        return per_chain(one, x, seed, (py, px, xbar, mean, m2))
    (tau, mu, theta, noise_amp, ts, g_sigma, c_mc, gamma_mc, _,
     c_me) = _block_coefs(scal_f)
    seed, chain = base_key(seed)
    stencils = _stencils(x)
    fwd_y, fwd_x, div = stencils
    rec = _BlockStats(scal_i, mean, m2, None, None, (), 1, with_stats)

    iotas = _iotas(x.shape, x.device)

    def dual_update(py, px, xbar):
        if dual == "wl1":
            c = py + mu * haar_interleaved(xbar, levels, iotas=iotas)
            return torch.clamp(c, -g_sigma, g_sigma), px
        return _dual_project(py + mu * fwd_y(xbar), px + mu * fwd_x(xbar),
                             dual, g_sigma)

    env = None  # the warm envelope dual starts from zeros at each call
    for i in range(n_steps):
        g = rec.step0 + i
        if gfirst:
            py, px = dual_update(py, px, xbar)
        aty = (haar_interleaved_inv(py, levels, iotas=iotas) if dual == "wl1"
               else -div(py, px))
        v = x - tau * aty
        if mode == "mctv":
            v = v - c_mc * div(*_mctv_clamp(v, gamma_mc, stencils))
        elif mode == "metv":
            p, env = _tv_prox_any(v, gamma_mc, niter_inner, tv_solver, tv_step,
                                  stencils, env if env_warm else None)
            v = v + c_me * (v - p)
        rhs = v + ts * atb
        x_new = _chebyshev_gram_solve(rhs, x, ts, lam, taps, oy, ox, niter_solve)
        if with_noise:
            x_new = x_new + noise_amp * normal_field(
                seed, chain, g, x.shape, x.dtype, x.device)
        xbar = x_new + theta * (x_new - x)
        if not gfirst:
            py, px = dual_update(py, px, xbar)
        rec(x_new, g)
        x = x_new
    mean, m2, _, _ = rec.result()
    return x, py, px, xbar, mean, m2


def _ulpda_halo(taps: Taps, oy: int, ox: int, niter_solve: int, mode: str,
                niter_inner: int, split: bool = False) -> int:
    """The halo of ULPDA's primal step on the cone of a tile's interior
    (``csrc/block_common.cuh::ul_halo``). Kernel 7 runs Chebyshev sweep k
    on the interior grown by ``reach (niter_solve - 1 - k)``, ``reach`` the
    gram's; kernel 3's resident route (``split``) runs every sweep on the
    interior and exchanges u between the CTAs. So rhs is needed on the
    interior grown by ``e = reach (niter_solve - 1)`` (0 split) and x on ``e
    + reach``; v, the correction's input, on ``e`` (tv), ``e + 2`` (mctv) or
    ``e + niter_inner`` (metv), and the dual one pixel further out."""
    ky, kx = len(taps[0][0]), len(taps[0][1])
    reach = max(oy, ky - 1 - oy, ox, kx - 1 - ox)
    e = (0 if split else reach) * max(niter_solve - 1, 0)
    ev = e + {"tv": 0, "mctv": 2}.get(mode, niter_inner)
    return max(e + reach if niter_solve else 0, ev + 1)


@functools.lru_cache(maxsize=64)
def ulpda_resident_plan(shape, taps: Taps, oy: int, ox: int, *, mode: str = "tv",
                        niter_inner: int = 10, niter_solve: int = 3,
                        dual: str = "l21", tv_solver: str = "chambolle",
                        n_chains: int = 1, n_sm: int = H100_SMS,
                        smem_optin: int = H100_SMEM_OPTIN):
    """Kernel 3's resident route on a card of ``n_sm`` SMs and
    ``smem_optin`` bytes of shared memory a CTA: ``(ty, tx, h, G)``, the
    interior of a CTA's tile, its halo (``_ulpda_halo`` with split sweeps)
    and the chains a cooperative launch carries (the ``n_chains`` chains
    run in groups of ``G``), or ``None`` for the launch sequence (the
    ``"wl1"`` dual, or no tiling fits). Among interiors, sides multiples of
    8, whose tiles number at most ``n_sm`` and whose shared memory (5 tile
    fields, 7 with the FGP envelope, the interior's mean and m2, the row and
    column indices and 192 floats of coefficients) fits ``smem_optin``, the
    first in ``(ty, tx)`` order of the least launches in turn x tile area
    ``(ty + 2h)(tx + 2h)``: kernel 2's rule (``myula_fused.resident_plan``).
    The launcher also asks the occupancy API that every CTA of a launch is
    resident at once, and raises if not. Computed once per shape and
    options: the wrapper asks on every call."""
    ny, nx = shape
    if (dual == "wl1" or n_chains < 1 or not 0 <= niter_solve <= _MAX_TRIPS
            or not 0 <= niter_inner <= _MAX_TRIPS):
        return None
    h = _ulpda_halo(taps, oy, ox, niter_solve, mode, niter_inner, split=True)
    fields = 7 if mode == "metv" and tv_solver == "fgp" else 5
    best = None
    for ty in range(8, ny + 8, 8):
        for tx in range(8, nx + 8, 8):
            sy, sx = ty + 2 * h, tx + 2 * h
            smem = 4 * (fields * sy * sx + 2 * ty * tx) + 4 * (sy + sx)
            if smem + 4 * 3 * _MAX_TRIPS > smem_optin:
                break  # the tile only grows with tx
            count = -(-ny // ty) * -(-nx // tx)
            if count > n_sm:
                continue
            g, launches = chains_per_launch(count, n_chains, n_sm)
            if best is None or launches * sy * sx < best[0]:
                best = (launches * sy * sx, ty, tx, g)
    return None if best is None else (best[1], best[2], h, best[3])


def _wl1_plan(shape, levels: int):
    """The ``"wl1"`` dual's applied levels, route and CTA region on the
    card: up to ``_TILE_LEVELS`` levels ``"tile"``, each CTA a region of whole
    ``2^levels`` tiles (``tile_region``); past that ``"passes"``, one launch
    per level and axis over the whole image, region ``(0, 0)``."""
    l_eff = haar_levels(shape, levels)
    if l_eff <= _TILE_LEVELS:
        return l_eff, "tile", tile_region(shape, l_eff)
    return l_eff, "passes", (0, 0)


def ulpda_block_update_cuda(
    x, py, px, xbar, atb, mean, m2, seed, scal_f, scal_i, *,
    taps: Taps, oy: int, ox: int, lam: float = 1.0, n_steps: int = 1,
    niter_solve: int = 3, tv_step: float = 0.25, gfirst: bool = False,
    dual: str = "l21", mode: str = "tv", niter_inner: int = 10,
    with_noise: bool = True, tv_solver: str = "chambolle",
    with_stats: bool = True, env_warm: bool = False, levels: int = 3,
):
    """Kernel 3 (``csrc/ulpda_block.cu``) on contiguous float32 CUDA tensors,
    on the route ``ulpda_resident_plan`` names for the card (counted in
    ``routes``, the last call's ``(route, ty, tx, h, G)`` in ``last_plan``).
    Works on copies of ``x, py, px, xbar, mean, m2`` and returns them
    (``xbar`` may be None for ``gfirst=False``, which never reads it, and
    ``px`` None for the ``"wl1"`` dual); raises on a CPU tensor, on shapes
    and options the kernel does not take, or when a resident tiling fails
    to fit or launch on the card."""
    _check_ulpda_args(taps, tv_solver, mode, dual, niter_solve)
    if x.ndim not in (2, 3) or min(x.shape[-2:]) < 2:
        raise ValueError(f"x must be an (ny, nx) image or a (C, ny, nx) chain axis, "
                         f"got {tuple(x.shape)}")
    if x.ndim == 3:
        _check_chain_axis(dual)
    ny, nx = x.shape[-2:]
    wl1 = dual == "wl1"
    fields = {"x": x, "py": py}
    if not wl1:
        fields["px"] = px
    if gfirst:
        fields["xbar"] = xbar
    if with_stats:
        fields.update(mean=mean, m2=m2)
    _build.require_cuda_f32(x.shape, **fields)
    _build.require_cuda_f32((ny, nx), atb=atb)
    if atb.device != x.device:
        raise ValueError("atb must lie on x's device")
    step0, burn, cnt0 = _build.check_steps(scal_i, n_steps)
    seed, words = chain_seeds(seed, x)
    n_chains = len(words)
    chains = _chain_words(words, x.device)
    l_eff, _, (rh, rw) = _wl1_plan((ny, nx), levels) if wl1 else (0, None, (0, 0))

    x, py = x.clone(), py.clone()
    px = None if wl1 else px.clone()
    xbar = xbar.clone() if gfirst else torch.empty_like(x)
    if with_stats:
        mean, m2 = mean.clone(), m2.clone()
    rank, ky, kx = len(taps), len(taps[0][0]), len(taps[0][1])
    tap_arr = np.array([v for wy, wx in taps for v in (*wy, *wx)], np.float32)
    coefs = _block_coefs(scal_f)
    coef = np.array(coefs, np.float32)
    # padded so the array is never empty
    cheb = np.array(_chebyshev_coefs(coefs[4], lam, niter_solve) or [(0.0, 0.0)],
                    np.float32)
    fgp_coef = _fgp_coef(niter_inner if mode == "metv" else 0)
    n_sm, smem_optin = _build.card_limits(x.device)
    plan = ulpda_resident_plan(
        (ny, nx), taps, int(oy), int(ox), mode=mode, niter_inner=int(niter_inner),
        niter_solve=int(niter_solve), dual=dual, tv_solver=tv_solver,
        n_chains=n_chains, n_sm=n_sm, smem_optin=smem_optin) if n_steps > 0 else None
    ty, tx, h, per = plan or (0, 0, 0, 0)

    def planes(k):
        return torch.empty((k * n_chains, ny, nx), dtype=x.dtype, device=x.device)

    # the resident route's other x parity and the two planes a chain that
    # exchange u between its sweeps, or the launch sequence's scratch (v,
    # rhs, u, d, gu and the row pass's rank planes)
    parity = torch.empty_like(x) if plan else None
    ub = planes(2) if plan else None
    scratch = [None] * 5 if plan else planes(5).view(5, -1, nx)
    tmp = None if plan else planes(rank)
    # the envelope duals (metv) or the clamped gradient (mctv)
    aux = None if mode == "tv" else planes(8 if mode == "metv" else 2)

    def ptr(t, used=True):
        return t.data_ptr() if used and t is not None else None

    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmc_ulpda_block(
            x.data_ptr(), ptr(parity), py.data_ptr(), ptr(px, not wl1),
            xbar.data_ptr(), atb.data_ptr(), ptr(mean, with_stats),
            ptr(m2, with_stats),
            *(ptr(t) for t in scratch), ptr(tmp),
            ptr(aux), ny, nx, n_chains, ptr(chains), tap_arr.ctypes.data, rank, ky,
            kx, int(oy), int(ox),
            int(n_steps), int(niter_solve), cheb.ctypes.data,
            int(bool(gfirst)), DUALS.index(dual), l_eff, rh, rw, MODES.index(mode),
            int(niter_inner), float(tv_step), int(tv_solver == "fgp"),
            fgp_coef.ctypes.data, int(bool(env_warm)),
            int(bool(with_noise)), int(bool(with_stats)), coef.ctypes.data,
            seed & 0xFFFFFFFF, words[0] & 0xFFFFFFFF, step0, burn, cnt0, ty, tx,
            per, ptr(ub), stream,
        )
    _build.check(rc, "lmc_ulpda_block")
    ulpda_block_update_cuda.launches += 1
    route = "resident" if plan else ("wl1" if wl1 else "sequence")
    ulpda_block_update_cuda.routes[route] += 1
    ulpda_block_update_cuda.last_plan = (route, ty, tx, h, per)
    if plan and n_steps % 2:
        x = parity  # the resident route's last step wrote the other buffer
    return x, py, px, xbar, mean, m2


ulpda_block_update_cuda.launches = 0  # calls that launched the kernel
# calls per route ("wl1": the launch sequence of the wl1 dual, which has no
# resident route), and the last call's (route, ty, tx, h, G): G chains a
# resident launch (0 on the sequence)
ulpda_block_update_cuda.routes = {"resident": 0, "sequence": 0, "wl1": 0}
ulpda_block_update_cuda.last_plan = None


def ulpda_block_update(x, *args, **kwargs):
    """``n_steps`` fused ULPDA steps (+ Welford), kernel 3.

    ``x`` is one chain's ``(ny, nx)`` image or ``C`` chains of the same
    posterior ``(C, ny, nx)`` (Gradient2D duals), with ``py, px, xbar,
    mean, m2`` of x's shape, ``atb`` one ``(ny, nx)`` field the chains
    share and ``seed`` the ``C`` keys of ``core.random.chain_keys``; chain
    ``c`` is bit for bit the one-chain call under ``seed[c]``.
    ``(py, px)`` is the Gradient2D dual (``"wl1"``: ``py`` the interleaved
    Haar coefficient dual of ``levels`` levels, ``px`` unused and returned
    as None), ``xbar`` the extrapolated iterate
    (read only with ``gfirst``), ``atb = A^T b`` (unscaled); ``seed`` is a
    seed or ``(seed, chain)``; ``scal_f = (tau, mu, theta, noise_scale,
    sigma, g_sigma[, lamda, gamma_mc])`` with ``sigma`` the data term's and
    ``g_sigma`` the dual norm's radius; ``scal_i = (step0, burn_in,
    count0)``. ``lam`` bounds ``lambda_max(A^T A)`` (``sum |hh|``);
    ``niter_solve`` Chebyshev sweeps; ``dual`` ``"l21"``/``"l1"``/``"wl1"``;
    ``mode``
    ``"tv"``/``"mctv"``/``"metv"`` with ``niter_inner`` envelope trips of
    ``tv_solver``, whose dual carries across this call's steps with
    ``env_warm``. Returns ``(x', py', px', xbar', mean', m2')``; ``xbar'`` is
    the genuine ``x' + theta (x' - x)`` in both orders. CUDA tensors run the
    hand kernel, CPU tensors its plain version.
    """
    if x.is_cuda:
        return ulpda_block_update_cuda(x, *args, **kwargs)
    return ulpda_block_update_ref(x, *args, **kwargs)


def _ulpda_setup(proxf, proxg, a_op):
    """Taps, offsets, ``A^T b``, the mode and its scalars, the dual, the
    spectrum bound ``lam = sum |hh| >= lambda_max(A^T A)`` (exact for a
    nonnegative PSF) and the wavelet dual's levels (0 for Gradient2D)."""
    levels = 0
    if isinstance(a_op, HaarDWT2D):
        dual, levels = "wl1", int(a_op.levels)
    elif isinstance(a_op, Gradient2D) and float(a_op.sampling) == 1.0:
        dual = "l21" if isinstance(proxg, L21Norm) else "l1"
    else:
        raise ValueError(
            "the fused ULPDA takes a Gradient2D(sampling=1) or HaarDWT2D dual")
    taps, (oy, ox), atbs = _fused_params(proxf)
    mode, lamda, gamma_mc, niter_inner = _fused_mode(proxf)
    atb = atbs / proxf.sigma
    lam = float(torch.abs(proxf.op.hh).sum())
    return (taps, (oy, ox), atb, mode, lamda, gamma_mc, niter_inner, dual, lam,
            levels)


def _pack_ulpda_scal(proxf, proxg, tau, mu, theta, noise_scale, lamda,
                     gamma_mc):
    return (float(tau), float(mu), float(theta), float(noise_scale),
            float(proxf.sigma), float(proxg.sigma), float(lamda),
            float(gamma_mc))


def ulpda_sep_fused(proxf: Any, proxg: Any, a_op: Any, tau, mu,
                    theta: float = 1.0, gfirst: bool = False,
                    niter_solve: int = 3, base_seed: int = 0,
                    noise_scale: float = 1.0, interpret: bool = False) -> Kernel:
    """Kernel-protocol wrapper: ONE fused ULPDA step per call, a drop-in for
    ``ulpda(proxf, proxg, a_op, tau, mu, theta, gfirst=...)`` that draws the
    same noise (the step key's ``(seed, chain, step)``).

    ``base_seed`` offsets the seed word of every step key, as the JAX
    package adds it to the key's first word: step ``(seed, chain, step)``
    draws the noise of ``(seed + base_seed, chain, step)``. ``interpret`` is
    the JAX package's (Pallas interpret mode) and takes no effect."""
    (taps, (oy, ox), atb, mode, lamda, gamma_mc, niter_inner, dual,
     lam, levels) = _ulpda_setup(proxf, proxg, a_op)
    scal_f = _pack_ulpda_scal(proxf, proxg, tau, mu, theta, noise_scale, lamda,
                              gamma_mc)
    n_dual = 1 if dual == "wl1" else 2

    def init(x0, y0=None):
        y = torch.zeros((n_dual,) + tuple(x0.shape), dtype=x0.dtype,
                        device=x0.device) if y0 is None else y0
        return SamplerState.init(x0, extras=ULPDAExtras(y=y, xbar=x0))

    def step(state, key):
        seed, chain, g = key
        y = state.extras.y
        x_n, py_n, px_n, xb_n, _, _ = ulpda_block_update(
            state.position, y[0], y[1] if n_dual == 2 else None,
            state.extras.xbar if gfirst else None,
            atb, None, None, (_offset_seed(seed, base_seed), chain), scal_f, (g, 0, 0),
            taps=taps, oy=oy, ox=ox, lam=lam, n_steps=1,
            niter_solve=niter_solve, gfirst=gfirst, dual=dual, mode=mode,
            niter_inner=niter_inner, with_noise=noise_scale != 0.0,
            with_stats=False, levels=levels,
        )
        y_n = py_n[None] if n_dual == 1 else torch.stack([py_n, px_n])
        extras = ULPDAExtras(y=y_n, xbar=xb_n)
        return state.next(x_n, extras=extras), StepInfo()

    return Kernel(init, step)


def run_ulpda_fused(
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
    env_warm: bool = False,
    niter_inner: Optional[int] = None,
    tv_solver: str = "chambolle",
    y0=None,
    xbar0=None,
    step_offset: int = 0,
    chain_nx: int = 0,
    interpret: bool = False,
) -> FusedChainResult:
    """Block-fused ULPDA chain: a host loop over blocks of ``block`` fused
    steps (kernel 3 per block on CUDA), with Welford posterior moments
    (``burn_in`` in steps).

    ``key`` is a seed or ``(seed, chain)``. With a ``HaarDWT2D`` dual the
    dual ``extras.y`` is one interleaved coefficient field, shape
    ``(1, ny, nx)``. ``env_warm`` (ME-TV data terms)
    carries the envelope dual across a block's steps (zeros at each block);
    ``niter_inner`` overrides the data term's envelope trip count. ``y0``,
    ``xbar0`` and ``step_offset`` continue a chain: the dual and xbar of a
    previous result's ``final_state.extras`` and the global step this run
    starts at, so that burn-in masking and the noise continue; merge the
    moments with ``RunningMoments.merge``. ``final_state.extras.xbar`` is the
    genuine extrapolated iterate in both orders; continue a ``gfirst=False``
    state with ``gfirst=False``.

    An ``x0`` of shape ``(C, ny, nx)`` runs ``C`` chains of the posterior in
    each kernel call (``run_ulpda_fused_packed``; Gradient2D duals only),
    chain ``c`` under ``chain_keys(key, C)[c]``: the dual ``y`` (and
    ``y0``) is then ``(2, C, ny, nx)``, the JAX package's packed layout.
    ``chain_nx`` takes the JAX package's lane-packed layout (``x0`` of
    shape ``(ny, C chain_nx)``, ``y0`` ``(2, ny, C chain_nx)``), the result
    packed back so; ``interpret`` is the JAX package's Pallas interpret mode
    and takes no effect (a CPU tensor runs the plain version).
    """
    x0 = torch.as_tensor(x0)
    kw = dict(theta=theta, gfirst=gfirst, niter_solve=niter_solve, burn_in=burn_in,
              block=block, noise_scale=noise_scale, env_warm=env_warm,
              niter_inner=niter_inner, tv_solver=tv_solver, step_offset=step_offset)
    if chain_nx and x0.shape[-1] != chain_nx:
        res = run_ulpda_fused(
            proxf, proxg, a_op, tau, mu, unpack_lanes(x0, chain_nx), key, n_steps,
            y0=None if y0 is None else torch.stack([unpack_lanes(v, chain_nx) for v in y0]),
            xbar0=None if xbar0 is None else unpack_lanes(xbar0, chain_nx), **kw)
        return _map_result(res, pack_lanes)
    (taps, (oy, ox), atb, mode, lamda, gamma_mc, niter_inner_l2, dual,
     lam, levels) = _ulpda_setup(proxf, proxg, a_op)
    if niter_inner is None:
        niter_inner = niter_inner_l2
    if x0.ndim == 3:
        _check_chain_axis(dual)
        key = chain_keys(key, x0.shape[0])
    if block is None:
        block = min(n_steps, 128)
    while n_steps % block:
        block -= 1
    scal_f = _pack_ulpda_scal(proxf, proxg, tau, mu, theta, noise_scale, lamda,
                              gamma_mc)
    step_offset = int(step_offset)
    zeros = torch.zeros_like(x0)
    x, mean, m2 = x0, zeros, zeros
    wl1 = dual == "wl1"
    if y0 is None:
        py, px = zeros, (None if wl1 else zeros)
    else:
        py, px = y0[0], (None if wl1 else y0[1])
    xbar = x0 if xbar0 is None else xbar0
    for b in range(n_steps // block):
        step0 = step_offset + b * block
        cnt0 = max(step0 - max(burn_in, step_offset), 0)
        x, py, px, xbar, mean, m2 = ulpda_block_update(
            x, py, px, xbar, atb, mean, m2, key, scal_f,
            (step0, burn_in, cnt0), taps=taps, oy=oy, ox=ox, lam=lam,
            n_steps=block, niter_solve=niter_solve, gfirst=gfirst, dual=dual,
            mode=mode, niter_inner=niter_inner,
            with_noise=noise_scale != 0.0, with_stats=True,
            env_warm=env_warm and mode == "metv", tv_solver=tv_solver,
            levels=levels,
        )
    count = (max(step_offset + n_steps - burn_in, 0)
             - max(step_offset - burn_in, 0))
    y_fin = py[None] if wl1 else torch.stack([py, px])
    return FusedChainResult(
        final_state=SamplerState.init(
            x, extras=ULPDAExtras(y=y_fin, xbar=xbar)),
        moments=RunningMoments(count=count, mean=mean, m2=m2),
    )


def run_ulpda_fused_packed(proxf: Any, proxg: Any, a_op: Any, tau, mu, x0, key,
                           n_steps: int, **kwargs) -> FusedChainResult:
    """``C`` independent chains of one posterior, ``x0`` of shape ``(C, ny,
    nx)``, every kernel-3 call carrying all of them (a grid axis over the
    chains; Gradient2D duals only): chain ``c`` is bit for bit
    ``run_ulpda_fused`` of ``x0[c]`` under ``chain_keys(key, C)[c]``.
    Returns per-chain positions and moments (one count) and the extras
    ``y`` ``(2, C, ny, nx)`` and ``xbar`` ``(C, ny, nx)``. Takes every
    ``run_ulpda_fused`` keyword."""
    x0 = torch.as_tensor(x0)
    if x0.ndim != 3:
        raise ValueError("packed runner wants x0 of shape (n_chains, ny, nx)")
    return run_ulpda_fused(proxf, proxg, a_op, tau, mu, x0, key, n_steps, **kwargs)
