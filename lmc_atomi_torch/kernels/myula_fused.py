"""Fused MYULA TV-deblurring (counterpart of
``lmc_atomi_tpu/kernels/myula_fused.py``): kernel 2, its plain torch version,
and the host-side block loop.

One block call runs ``n_steps`` MYULA steps

    x <- (1 - tau/gamma) x - tau grad f(x) + (tau/gamma) prox_{tv_gamma TV}(x)
         + noise_scale sqrt(2 tau) xi

with the data gradient ``sigma A^T A x - sigma A^T b`` as separable wrap
convolutions (``A^T A`` is circulant with the autocorrelation ``hh`` of a
small PSF, factored on the host into ``hh = sum_r wy_r wx_r^T``), a
Chambolle or FGP TV prox, Philox noise at the global step
(``core/random.py``), burn-in-masked Welford moments and per-pixel P^2
quantile markers. ``mode`` selects the data term: ``"tv"`` (``L2Data``), or
the isotropic ``L2NcvxTV`` concave corrections ``"mctv"`` (the clamped
gradient ``min(1/gamma, 1/|Gx|) Gx``) and ``"metv"`` (the Moreau envelope of
TV, a second TV prox at ``gamma`` of ``niter_inner`` trips).

``myula_tv_block_update`` dispatches by device: ``csrc/myula_block.cu`` for
CUDA tensors, ``myula_tv_block_update_ref`` (the same function in torch ops,
term for term) for CPU tensors. On the card kernel 2 takes one of two routes,
chosen from the shape, the mode and the card before any launch: the
resident route (one cooperative launch per call, every CTA a 2-D halo tile
of the image with the chain's state in its shared memory, where
``resident_plan`` finds a tiling of at most one CTA an SM whose tile fits;
512^2) or the launch sequence (a few launches per step, the fields in device
memory; 2048^2 and up). The wrapper counts the calls of each route.

A call takes one chain ``(ny, nx)`` or ``C`` chains of one posterior
``(C, ny, nx)`` under ``C`` chain keys, sharing ``atbs``: on the card a grid
axis over the chains, the resident route running them in groups of ``G``
(``resident_plan``), one cooperative launch a group; the plain version runs
them one after another. ``run_myula_tv_fused_packed`` is the multi-chain
runner.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lmc_atomi_torch import _build
from lmc_atomi_torch.core.random import chain_keys, normal_field
from lmc_atomi_torch.core.state import SamplerState, StepInfo
from lmc_atomi_torch.core.stats import RunningMoments
from lmc_atomi_torch.kernels.base import Kernel
from lmc_atomi_torch.ops.linops import Gradient2D
from lmc_atomi_torch.ops.tv import fgp_momentum
from lmc_atomi_torch.ops.tv_cuda import _stencils
from lmc_atomi_torch.run.runner import base_key

__all__ = [
    "separable_gram_taps",
    "sep_fused_supported",
    "myula_tv_block_update",
    "myula_tv_block_update_cuda",
    "myula_tv_block_update_ref",
    "myula_imaging_sep_fused",
    "resident_plan",
    "run_myula_tv_fused",
    "run_myula_tv_fused_packed",
    "FusedChainResult",
]

Taps = Tuple[Tuple[Tuple[float, ...], Tuple[float, ...]], ...]

_MAX_RANK = 4  # csrc/block_common.cuh: LMC_MAXR, LMC_MAXK; myula_block.cu: LMC_MAXQ
_MAX_TAPS = 32
_MAX_QUANTILES = 4
_FGP_STEP = 0.125  # the dual gradient's 1/L
MODES = ("tv", "mctv", "metv")  # the kernels' data-term modes, in their order
# csrc/block_common.cuh: LMC_MAXTRIP; the H100 SXM's SMs and its shared memory
# a CTA can opt into (cudaDevAttrMaxSharedMemoryPerBlockOptin)
_MAX_TRIPS = 64
H100_SMS, H100_SMEM_OPTIN = 132, 232448


def _tile_halo(taps: Taps, oy: int, ox: int, niter_tv: int, mode: str,
               niter_inner: int) -> int:
    """The least exact halo of a tile step (kernel 2's resident route and
    kernel 6): the TV prox's ``niter_tv + 1``, the taps' reach, MC-TV 2,
    ME-TV ``niter_inner + 1``."""
    ky, kx = len(taps[0][0]), len(taps[0][1])
    h = max(niter_tv + 1, oy, ky - 1 - oy, ox, kx - 1 - ox)
    if mode == "mctv":
        h = max(h, 2)
    elif mode == "metv":
        h = max(h, niter_inner + 1)
    return h


def chains_per_launch(count: int, n_chains: int, n_sm: int):
    """``(G, launches)`` of a resident tiling of ``count`` tiles a chain:
    ``G`` chains a cooperative launch (at most one CTA an SM) and the
    launches ``n_chains`` chains take in turn (the resident planners' cost
    is launches x tile area)."""
    g = min(n_chains, n_sm // count)
    return g, -(-n_chains // g)


def resident_plan(shape, taps: Taps, oy: int, ox: int, *, niter_tv: int = 10,
                  tv_solver: str = "chambolle", mode: str = "tv",
                  niter_inner: int = 10, n_steps: int = 1, n_chains: int = 1,
                  n_sm: int = H100_SMS, smem_optin: int = H100_SMEM_OPTIN):
    """Kernel 2's resident route on a card of ``n_sm`` SMs and
    ``smem_optin`` bytes of shared memory a CTA: ``(ty, tx, h, G)``, the
    interior of a CTA's tile, its halo and the chains a launch carries (the
    ``n_chains`` chains run in groups of ``G``, one cooperative launch a
    group), or ``None`` for the launch sequence. The rule of
    ``csrc/myula_block.cu::rs_geometry``: the halo is kernel 6's (the TV
    prox's ``niter_tv + 1``, the taps' reach, MC-TV 2, ME-TV ``niter_inner +
    1``); among interiors, sides multiples of 8, whose tiles number at most
    ``n_sm`` and whose shared memory (5 tile fields, 7 for FGP, 3 interior
    fields, the row and column indices and 64 floats of FGP momentum) fits
    ``smem_optin``, the first in ``(ty, tx)`` order of the least cost:
    launches in turn x tile area ``(ty + 2h)(tx + 2h)`` (one chain: the
    least tile area). The card's launcher also asks the occupancy API that
    every CTA of a launch is resident at once."""
    ny, nx = shape
    if (n_steps < 1 or n_chains < 1 or not 0 <= niter_tv <= _MAX_TRIPS
            or not 0 <= niter_inner <= _MAX_TRIPS):
        return None
    h = _tile_halo(taps, oy, ox, niter_tv, mode, niter_inner)
    fields = 7 if tv_solver == "fgp" else 5
    best = None
    for ty in range(8, ny + 8, 8):
        for tx in range(8, nx + 8, 8):
            count = -(-ny // ty) * -(-nx // tx)
            sy, sx = ty + 2 * h, tx + 2 * h
            smem = 4 * (fields * sy * sx + 3 * ty * tx) + 4 * (sy + sx)
            if count > n_sm or smem + 4 * _MAX_TRIPS > smem_optin:
                continue
            g, launches = chains_per_launch(count, n_chains, n_sm)
            if best is None or launches * sy * sx < best[0]:
                best = (launches * sy * sx, ty, tx, g)
    return None if best is None else (best[1], best[2], h, best[3])


def separable_gram_taps(hh, tol: float = 1e-6) -> Taps:
    """Separable factorization ``hh = sum_r wy_r wx_r^T`` via SVD (host side),
    as nested tuples of Python floats. Uniform and Gaussian PSF
    autocorrelations are exactly rank 1."""
    if isinstance(hh, torch.Tensor):
        hh = hh.detach().cpu().numpy()
    u, s, vt = np.linalg.svd(np.asarray(hh, np.float64))
    keep = s > tol * s[0]
    taps = []
    for i in np.nonzero(keep)[0]:
        scale = np.sqrt(s[i])
        taps.append(
            (tuple((scale * u[:, i]).tolist()), tuple((scale * vt[i, :]).tolist()))
        )
    return tuple(taps)


def sep_fused_supported(op, x, max_rank: int = _MAX_RANK) -> bool:
    """Whether the fused separable kernels apply to images like ``x``: ``x``
    a 2-D float32 tensor on a CUDA device, ``op`` a circulant operator with a
    cached small-PSF autocorrelation of separable rank at most ``max_rank``."""
    hh = getattr(op, "hh", None)
    if hh is None or not isinstance(x, torch.Tensor) or not x.is_cuda:
        return False
    if x.ndim != 2 or x.dtype != torch.float32 or max(hh.shape) > _MAX_TAPS:
        return False
    return len(separable_gram_taps(hh)) <= max_rank


def _p2_coefs(p: float) -> Tuple[float, float, float]:
    """``(dn_i - 1) / 4`` of the interior P^2 markers for quantile ``p``:
    their desired position after ``cnt`` observations is
    ``1 + coef * (cnt - 1)``."""
    return tuple((d - 1.0) / 4.0 for d in (1.0 + 2.0 * p, 1.0 + 4.0 * p, 3.0 + 2.0 * p))


def _sep_gram(x, taps: Taps, oy: int, ox: int):
    """``A^T A x`` as separable wrap convolutions:
    ``y[i,j] = sum_ab hh[a,b] x[(i-a+oy)%ny, (j-b+ox)%nx]``."""
    ny, nx = x.shape

    def conv1d(v, w, off, n, axis):
        out = None
        for i, wi in enumerate(w):
            if wi == 0.0:
                continue
            s = (i - off) % n
            term = v if s == 0 else torch.roll(v, s, axis)
            term = term * wi
            out = term if out is None else out + term
        return out

    out = None
    for wy, wx in taps:
        r = conv1d(conv1d(x, wx, ox, nx, 1), wy, oy, ny, 0)
        out = r if out is None else out + r
    return out


def _tv_prox(x, tv_gamma, niter, step, stencils, p0=None):
    """Chambolle dual TV prox (one reciprocal per trip); returns the prox and
    the final dual."""
    fwd_y, fwd_x, div = stencils
    xg = x / tv_gamma
    py, px = (torch.zeros_like(x), torch.zeros_like(x)) if p0 is None else p0
    for _ in range(niter):
        u = div(py, px) - xg
        gy = fwd_y(u)
        gx = fwd_x(u)
        mag = torch.sqrt(gy * gy + gx * gx)
        inv = 1.0 / (1.0 + step * mag)
        py, px = (py + step * gy) * inv, (px + step * gx) * inv
    return x - tv_gamma * div(py, px), (py, px)


def _tv_prox_fgp(x, tv_gamma, niter, stencils, p0=None):
    """Projected-dual TV prox with FISTA momentum (FGP, Beck & Teboulle
    2009) at step 1/8; returns the prox and the final dual."""
    fwd_y, fwd_x, div = stencils
    xg = x / tv_gamma

    def ascend(ry, rx):
        u = div(ry, rx) - xg
        py = ry + _FGP_STEP * fwd_y(u)
        px = rx + _FGP_STEP * fwd_x(u)
        scale = torch.rsqrt(py * py + px * px).clamp(max=1.0)
        return py * scale, px * scale

    py, px = (torch.zeros_like(x), torch.zeros_like(x)) if p0 is None else p0
    ry, rx = py, px
    for c in fgp_momentum(niter):
        qy, qx = ascend(ry, rx)
        ry = qy + c * (qy - py)
        rx = qx + c * (qx - px)
        py, px = qy, qx
    return x - tv_gamma * div(py, px), (py, px)


def _tv_prox_any(x, tv_gamma, niter, tv_solver, tv_step, stencils, p0=None):
    """The TV prox of the block kernels: Chambolle at ``tv_step`` or FGP."""
    if tv_solver == "fgp":
        return _tv_prox_fgp(x, tv_gamma, niter, stencils, p0)
    return _tv_prox(x, tv_gamma, niter, tv_step, stencils, p0)


def _mctv_clamp(f, gamma_mc, stencils):
    """MC-TV's clamped gradient ``min(1/gamma, 1/|G f|) G f`` (isotropic,
    ``ncvx_tv.py::_grad_moreau``), as the pair (y, x)."""
    fwd_y, fwd_x, _ = stencils
    gy = fwd_y(f)
    gx = fwd_x(f)
    mag = torch.sqrt(gy * gy + gx * gx)
    mag = torch.where(mag != 0.0, mag, 1e-9)
    clamp = torch.clamp(1.0 / mag, max=1.0 / gamma_mc)
    return clamp * gy, clamp * gx


def _fgp_coef(niter: int) -> np.ndarray:
    """FGP momentum for up to ``niter`` trips as the kernels' float32 array,
    padded so it is never empty (Chambolle ignores it)."""
    return np.array(fgp_momentum(niter) + (0.0,), np.float32)


def _sort5(v):
    """Sort 5 fields elementwise (9 compare-exchange network)."""
    v = list(v)
    for i, j in ((0, 1), (3, 4), (2, 4), (2, 3), (0, 3), (0, 2), (1, 4),
                 (1, 3), (1, 2)):
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v


def _p2_update(x, qs, ns, c_prev: int, coef):
    """One recorded P^2 observation (Jain & Chlamtac 1985), elementwise:
    ``qs`` the 5 marker-height fields, ``ns`` the 3 interior positions,
    ``c_prev`` observations absorbed before this one. Bootstrap
    (``c_prev < 5``) stores into slot ``c_prev`` and sorts on the 5th."""
    if c_prev < 5:
        q = list(qs)
        q[c_prev] = x
        return (_sort5(q) if c_prev == 4 else q), list(ns)
    dtype = x.dtype
    q = list(qs)
    q[0] = torch.minimum(q[0], x)
    q[4] = torch.maximum(q[4], x)
    k = (x >= q[1]).to(dtype) + (x >= q[2]).to(dtype) + (x >= q[3]).to(dtype)
    # scalars in the working dtype, so the desired positions round as the
    # kernel's do
    cnt = torch.tensor(float(c_prev + 1), dtype=dtype, device=x.device)
    co = torch.tensor(coef, dtype=dtype, device=x.device)
    n = [1.0, ns[0] + (1.0 > k).to(dtype), ns[1] + (2.0 > k).to(dtype),
         ns[2] + (3.0 > k).to(dtype), cnt]
    for i in (1, 2, 3):
        d = (1.0 + co[i - 1] * (cnt - 1.0)) - n[i]
        move_up = (d >= 1.0) & (n[i + 1] - n[i] > 1.0)
        move_dn = (d <= -1.0) & (n[i - 1] - n[i] < -1.0)
        s = move_up.to(dtype) - (move_dn & ~move_up).to(dtype)
        do_move = s != 0.0
        nm, ni, np_ = n[i - 1], n[i], n[i + 1]
        qm, qi, qp = q[i - 1], q[i], q[i + 1]
        d_t = torch.where(np_ - nm != 0.0, np_ - nm, 1.0)
        d_u = torch.where(np_ - ni != 0.0, np_ - ni, 1.0)
        d_l = torch.where(ni - nm != 0.0, ni - nm, 1.0)
        para = qi + s / d_t * (
            (ni - nm + s) * (qp - qi) / d_u + (np_ - ni - s) * (qi - qm) / d_l
        )
        ok = (qm < para) & (para < qp)
        lin = qi + s * torch.where(s > 0.0, (qp - qi) / d_u, (qi - qm) / d_l)
        q[i] = torch.where(do_move, torch.where(ok, para, lin), qi)
        n[i] = torch.where(do_move, ni + s, ni)
    return q, n[1:4]


def _check_block_args(taps, quantiles, quantile_thin, tv_solver, mode="tv"):
    if tv_solver not in ("chambolle", "fgp"):
        raise ValueError(f"unknown tv_solver {tv_solver!r}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if not 1 <= len(taps) <= _MAX_RANK:
        raise ValueError(f"separable rank {len(taps)} outside 1..{_MAX_RANK}")
    if max(len(taps[0][0]), len(taps[0][1])) > _MAX_TAPS:
        raise ValueError(f"more than {_MAX_TAPS} taps per axis")
    if len(quantiles) > _MAX_QUANTILES:
        raise ValueError(f"at most {_MAX_QUANTILES} quantiles")
    if quantile_thin < 1:
        raise ValueError("quantile_thin must be >= 1")


def _update_coefs(scal_f):
    """``(1 - tau/gamma, tau, tau/gamma, noise_scale sqrt(2 tau), sigma,
    tv_gamma, lamda, gamma_mc, 1/gamma_mc, lamda/gamma_mc)`` as Python
    floats; ``scal_f`` without ``(lamda, gamma_mc)`` is the plain mode's."""
    tau, gamma, tv_gamma, noise_scale, sigma = scal_f[:5]
    lamda, gamma_mc = scal_f[5:7] if len(scal_f) > 5 else (0.0, 1.0)
    return (1.0 - tau / gamma, tau, tau / gamma,
            noise_scale * math.sqrt(2.0 * tau), sigma, tv_gamma,
            lamda, gamma_mc, 1.0 / gamma_mc, lamda / gamma_mc)


class _BlockStats:
    """Burn-in-masked Welford moments and P^2 markers of the plain block
    versions (kernels 2-5), step for step as the kernels update them:
    ``scal_i = (step0, burn_in, count0)``; call with each step's ``x'`` and
    global step ``g``; ``result()`` is ``(mean, m2, qh, qn)``."""

    def __init__(self, scal_i, mean, m2, qh, qn, quantiles, quantile_thin,
                 with_stats):
        self.step0, self.burn, self.cnt0 = (int(v) for v in scal_i)
        self.mean, self.m2 = mean, m2
        self.n_q = len(quantiles)
        self.coefs = [_p2_coefs(p) for p in quantiles]
        self.qh = [qh[i] for i in range(5 * self.n_q)] if self.n_q else []
        self.qn = [qn[i] for i in range(3 * self.n_q)] if self.n_q else []
        self.thin, self.with_stats = quantile_thin, with_stats
        self.qh_in, self.qn_in = qh, qn

    def __call__(self, x_new, g):
        w = g >= self.burn
        if self.with_stats:
            n_new = self.cnt0 + max(g + 1 - max(self.burn, self.step0), 0)
            wf = float(w)
            delta = x_new - self.mean
            self.mean = self.mean + wf * delta / float(max(n_new, 1))
            self.m2 = self.m2 + wf * delta * (x_new - self.mean)
        if self.n_q and w and (g + 1) % self.thin == 0:
            c_prev = max(g // self.thin - self.burn // self.thin, 0)
            for j in range(self.n_q):
                qs, ns = _p2_update(x_new, self.qh[5 * j:5 * j + 5],
                                    self.qn[3 * j:3 * j + 3], c_prev, self.coefs[j])
                self.qh[5 * j:5 * j + 5] = qs
                self.qn[3 * j:3 * j + 3] = ns

    def result(self):
        if not self.n_q:
            return self.mean, self.m2, self.qh_in, self.qn_in
        return self.mean, self.m2, torch.stack(self.qh), torch.stack(self.qn)


def chain_seeds(seed, x):
    """``(seed, chains)`` of a block call on ``x``: an ``(ny, nx)`` image
    takes a seed or ``(seed, chain)`` (one chain word); a chain axis
    ``(C, ny, nx)`` takes the ``C`` keys ``(seed, chain_c)`` of
    ``core.random.chain_keys``, which share their seed."""
    if x.ndim == 2:
        s, c = base_key(seed)
        return s, [c]
    keys = [base_key(k) for k in seed]
    if len(keys) != x.shape[0] or len({s for s, _ in keys}) != 1:
        raise ValueError(f"a chain axis of {x.shape[0]} takes as many (seed, chain) "
                         "keys sharing one seed (core.random.chain_keys)")
    return keys[0][0], [c for _, c in keys]


def _chain_words(words, device):
    """The chain words of a multi-chain call as a device int32 tensor (the
    uint32 bits), or None for one chain (its word rides as a scalar)."""
    if len(words) == 1:
        return None
    bits = np.array([w & 0xFFFFFFFF for w in words], np.uint32).view(np.int32)
    return torch.from_numpy(bits).to(device)


def runner_keys(x0, key):
    """The key of a runner's block calls: ``key`` for one chain; for a chain
    axis ``(C, ny, nx)`` the ``C`` keys ``chain_keys(key, C)``, unless
    ``key`` is already that list (a slice of them, as a rank of a farm runs
    its share)."""
    if x0.ndim == 3 and not isinstance(key, list):
        return chain_keys(key, x0.shape[0])
    return key


def per_chain(fn, x, keys, chained):
    """A plain block version on a chain axis: chain ``c`` is ``fn`` on the
    ``c``-th slice of ``x`` and of each of ``chained`` (None passes
    through) under ``keys[c]``; the outputs stack along the chain axis (None
    stays None)."""
    outs = [fn(x[c], *(None if a is None else a[c] for a in chained), keys[c])
            for c in range(x.shape[0])]
    return tuple(None if o[0] is None else torch.stack(o) for o in zip(*outs))


def myula_tv_block_update_ref(
    x, atbs, mean, m2, seed, scal_f, scal_i, qh=None, qn=None, *,
    taps: Taps, oy: int, ox: int, n_steps: int = 1, niter_tv: int = 10,
    tv_step: float = 0.25, with_noise: bool = True, with_stats: bool = True,
    tv_warm: bool = False, quantiles: Tuple[float, ...] = (),
    quantile_thin: int = 1, tv_solver: str = "chambolle", mode: str = "tv",
    niter_inner: int = 10,
):
    """Plain torch version of kernel 2 (see ``myula_tv_block_update``); a
    chain axis runs its chains one after another."""
    if x.ndim == 3:
        chain_seeds(seed, x)
        kw = dict(taps=taps, oy=oy, ox=ox, n_steps=n_steps, niter_tv=niter_tv,
                  tv_step=tv_step, with_noise=with_noise, with_stats=with_stats,
                  tv_warm=tv_warm, quantiles=quantiles, quantile_thin=quantile_thin,
                  tv_solver=tv_solver, mode=mode, niter_inner=niter_inner)

        def one(xc, mc, m2c, qhc, qnc, key):
            return myula_tv_block_update_ref(xc, atbs, mc, m2c, key, scal_f, scal_i,
                                             qhc, qnc, **kw)
        return per_chain(one, x, seed, (mean, m2, qh, qn))
    _check_block_args(taps, quantiles, quantile_thin, tv_solver, mode)
    (c_keep, c_grad, c_prox, noise_amp, sigma, tv_gamma, lamda, gamma_mc, _,
     c_env) = _update_coefs(scal_f)
    seed, chain = base_key(seed)
    stencils = _stencils(x)
    rec = _BlockStats(scal_i, mean, m2, qh, qn, quantiles, quantile_thin,
                      with_stats)
    _, _, div = stencils
    dual = env = None  # the warm duals start from zeros at each call
    for i in range(n_steps):
        g = rec.step0 + i
        grad = sigma * _sep_gram(x, taps, oy, ox) - atbs
        if mode == "mctv":
            grad = grad + lamda * div(*_mctv_clamp(x, gamma_mc, stencils))
        elif mode == "metv":
            p_env, env = _tv_prox_any(x, gamma_mc, niter_inner, tv_solver,
                                      tv_step, stencils, env if tv_warm else None)
            grad = grad - c_env * (x - p_env)
        prox, dual = _tv_prox_any(x, tv_gamma, niter_tv, tv_solver, tv_step,
                                  stencils, dual if tv_warm else None)
        x_new = c_keep * x - c_grad * grad + c_prox * prox
        if with_noise:
            x_new = x_new + noise_amp * normal_field(
                seed, chain, g, x.shape, x.dtype, x.device)
        rec(x_new, g)
        x = x_new
    return (x, *rec.result())


def myula_tv_block_update_cuda(
    x, atbs, mean, m2, seed, scal_f, scal_i, qh=None, qn=None, *,
    taps: Taps, oy: int, ox: int, n_steps: int = 1, niter_tv: int = 10,
    tv_step: float = 0.25, with_noise: bool = True, with_stats: bool = True,
    tv_warm: bool = False, quantiles: Tuple[float, ...] = (),
    quantile_thin: int = 1, tv_solver: str = "chambolle", mode: str = "tv",
    niter_inner: int = 10,
):
    """Kernel 2 (``csrc/myula_block.cu``) on contiguous float32 CUDA tensors.
    Works on copies of ``x, mean, m2, qh, qn`` and returns them; raises on a
    CPU tensor or on shapes and options the kernel does not take."""
    _check_block_args(taps, quantiles, quantile_thin, tv_solver, mode)
    if x.ndim not in (2, 3) or min(x.shape[-2:]) < 2:
        raise ValueError(f"x must be an (ny, nx) image or a (C, ny, nx) chain axis, "
                         f"got {tuple(x.shape)}")
    ny, nx = x.shape[-2:]
    lead = tuple(x.shape[:-2])
    n_q = len(quantiles)
    fields = {"x": x}
    if with_stats:
        fields.update(mean=mean, m2=m2)
    _build.require_cuda_f32(x.shape, **fields)
    _build.require_cuda_f32((ny, nx), atbs=atbs)
    if n_q:
        _build.require_cuda_f32(lead + (5 * n_q, ny, nx), qh=qh)
        _build.require_cuda_f32(lead + (3 * n_q, ny, nx), qn=qn)
    if any(t.device != x.device for t in (atbs, qh, qn) if t is not None):
        raise ValueError("atbs and the marker state must lie on x's device")
    step0, burn, cnt0 = _build.check_steps(scal_i, n_steps)
    seed, words = chain_seeds(seed, x)
    n_chains = len(words)
    chains = _chain_words(words, x.device)

    x = x.clone()
    parity = torch.empty_like(x)
    if with_stats:
        mean, m2 = mean.clone(), m2.clone()
    if n_q:
        qh, qn = qh.clone(), qn.clone()
    rank, ky, kx = len(taps), len(taps[0][0]), len(taps[0][1])
    tap_arr = np.array([v for wy, wx in taps for v in (*wy, *wx)], np.float32)
    coef = np.array(_update_coefs(scal_f), np.float32)
    fgp = tv_solver == "fgp"
    fgp_coef = _fgp_coef(max(niter_tv, niter_inner if mode == "metv" else 0))
    qcoef = np.array([_p2_coefs(p) for p in quantiles] or [(0.0,) * 3], np.float32)
    grad = torch.empty_like(x)
    tmp = torch.empty((rank * n_chains, ny, nx), dtype=x.dtype, device=x.device)
    duals = torch.empty((8 * n_chains, ny, nx), dtype=x.dtype, device=x.device)
    # the envelope duals (metv) or the clamped gradient (mctv)
    aux = None if mode == "tv" else torch.empty(
        ((8 if mode == "metv" else 2) * n_chains, ny, nx), dtype=x.dtype, device=x.device)
    # the route, the resident tile and the chains a launch carries, from the
    # launcher
    plan = np.zeros(5, np.int32)

    def ptr(t, used):
        return t.data_ptr() if used else None

    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lmc_myula_block(
            x.data_ptr(), parity.data_ptr(), atbs.data_ptr(),
            ptr(mean, with_stats), ptr(m2, with_stats), ptr(qh, n_q),
            ptr(qn, n_q), grad.data_ptr(), tmp.data_ptr(), duals.data_ptr(),
            ptr(aux, aux is not None), plan.ctypes.data, ny, nx, n_chains,
            ptr(chains, chains is not None), tap_arr.ctypes.data, rank, ky, kx,
            int(oy), int(ox),
            int(n_steps), int(niter_tv), float(tv_step), int(fgp),
            fgp_coef.ctypes.data, int(tv_warm), MODES.index(mode),
            int(niter_inner), int(bool(with_noise)),
            int(bool(with_stats)), qcoef.ctypes.data, n_q, int(quantile_thin),
            coef.ctypes.data, seed & 0xFFFFFFFF, words[0] & 0xFFFFFFFF, step0,
            burn, cnt0, stream,
        )
    _build.check(rc, "lmc_myula_block")
    myula_tv_block_update_cuda.launches += 1
    route = "resident" if plan[0] else "sequence"
    myula_tv_block_update_cuda.routes[route] += 1
    myula_tv_block_update_cuda.last_plan = (route, *(int(v) for v in plan[1:]))
    if route == "resident" and n_steps % 2:
        x = parity  # the resident route's last step wrote the other buffer
    return x, mean, m2, qh, qn


myula_tv_block_update_cuda.launches = 0  # calls that launched the kernel
# calls per route, and the last call's (route, ty, tx, h, G): G chains a
# resident launch (0 on the sequence)
myula_tv_block_update_cuda.routes = {"resident": 0, "sequence": 0}
myula_tv_block_update_cuda.last_plan = None


def myula_tv_block_update(x, *args, **kwargs):
    """``n_steps`` fused MYULA steps (+ Welford / P^2), kernel 2.

    ``x`` is one chain's ``(ny, nx)`` image or ``C`` chains of the same
    posterior ``(C, ny, nx)``, with ``mean``/``m2`` of x's shape and the
    markers ``(C, 5 n_q, ny, nx)``/``(C, 3 n_q, ny, nx)``; ``atbs`` is one
    ``(ny, nx)`` field the chains share, and chain ``c`` is bit for bit the
    one-chain call under ``seed[c]``.
    ``atbs = sigma * A^T b``; ``seed`` is a seed or ``(seed, chain)`` (with a
    chain axis the ``C`` keys of ``core.random.chain_keys``);
    ``scal_f = (tau, gamma, tv_gamma, noise_scale, sigma)``;
    ``scal_i = (step0, burn_in, count0)``: the global step of the first step,
    the burn-in in steps, and the Welford count entering the call.
    ``quantiles`` is a tuple of probabilities; their P^2 state rides in
    ``qh`` (5 heights per quantile) and ``qn`` (3 interior positions), each
    ``(k * len(quantiles), ny, nx)``. Observations are recorded at steps
    ``g >= burn_in`` with ``(g + 1) % quantile_thin == 0``. With ``tv_warm``
    the TV dual (and in mode ``"metv"`` the envelope dual) carries across
    this call's steps. The nonconvex modes take ``scal_f`` with
    ``(lamda, gamma_mc)`` appended and ``niter_inner`` envelope trips. Returns
    ``(x', mean', m2', qh', qn')``. CUDA tensors run the hand kernel, CPU
    tensors its plain version.
    """
    if x.is_cuda:
        return myula_tv_block_update_cuda(x, *args, **kwargs)
    return myula_tv_block_update_ref(x, *args, **kwargs)


def _fused_mode(l2) -> Tuple[str, float, float, int]:
    """Classify the data term: ``L2Data`` -> ``"tv"``; isotropic ``L2NcvxTV``
    -> ``"mctv"`` (``op2`` the forward-difference ``Gradient2D``) or
    ``"metv"`` (``op2 is None``). Returns ``(mode, lamda, gamma_mc,
    niter_inner)``; raises ``ValueError`` on a nonconvex term the kernels do
    not take."""
    if not hasattr(l2, "lamda"):
        return "tv", 0.0, 1.0, 0
    if not l2.isotropic:
        raise ValueError("fused nonconvex MYULA supports isotropic TV only")
    if l2.q is not None:
        raise ValueError("fused nonconvex MYULA does not support a q term")
    if l2.op2 is None:
        mode = "metv"
    elif isinstance(l2.op2, Gradient2D) and float(l2.op2.sampling) == 1.0:
        mode = "mctv"
    else:
        raise ValueError("fused MC-TV needs op2 = Gradient2D(sampling=1)")
    return mode, float(l2.lamda), float(l2.gamma), int(l2.niter_inner)


def _fused_params(l2):
    """Taps, offsets and ``sigma A^T b`` from an ``L2Data`` or isotropic
    ``L2NcvxTV`` over a ``CirculantBlur2D`` with a cached small-PSF
    autocorrelation."""
    _fused_mode(l2)
    op = l2.op
    hh = getattr(op, "hh", None)
    if hh is None:
        raise ValueError(
            "fused MYULA needs a CirculantBlur2D with a cached small-PSF "
            "autocorrelation (kernels up to 13x13)"
        )
    taps = separable_gram_taps(hh)
    oy, ox = hh.shape[0] // 2, hh.shape[1] // 2
    atbs = l2.sigma * op.rmatvec(l2.b)
    return taps, (oy, ox), atbs


def _offset_seed(seed: int, base_seed: int) -> int:
    """The seed word ``seed + base_seed`` modulo 2^32 (the JAX package's
    ``_key_seed`` offset of the key's first word)."""
    return (int(seed) + int(base_seed)) & 0xFFFFFFFF


def _pack_scal_f(l2, tau, gamma, tv_sigma, noise_scale, lamda=0.0,
                 gamma_mc=1.0):
    return (float(tau), float(gamma), float(tv_sigma * gamma),
            float(noise_scale), float(l2.sigma), float(lamda), float(gamma_mc))


def myula_imaging_sep_fused(l2: Any, tv_sigma: float, tau, gamma,
                            niter_tv: int = 10, base_seed: int = 0,
                            noise_scale: float = 1.0,
                            interpret: bool = False) -> Kernel:
    """Kernel-protocol wrapper: ONE fused step per call, a drop-in for
    ``myula_imaging(l2, TVNorm(tv_sigma, niter_tv), tau, gamma)`` that draws
    the same noise (the step key's ``(seed, chain, step)``). ``l2`` is an
    ``L2Data`` or an isotropic ``L2NcvxTV``.

    ``base_seed`` offsets the seed word of every step key, as the JAX
    package adds it to the key's first word: step ``(seed, chain, step)``
    draws the noise of ``(seed + base_seed, chain, step)``, so ``base_seed=0``
    is the unfused chain's stream. ``interpret`` is the JAX package's (Pallas
    interpret mode) and takes no effect: a CPU tensor runs the plain
    version."""
    taps, (oy, ox), atbs = _fused_params(l2)
    mode, lamda, gamma_mc, niter_inner = _fused_mode(l2)
    scal_f = _pack_scal_f(l2, tau, gamma, tv_sigma, noise_scale, lamda,
                          gamma_mc)

    def init(x0):
        return SamplerState.init(x0)

    def step(state, key):
        seed, chain, g = key
        x_new, _, _, _, _ = myula_tv_block_update(
            state.position, atbs, None, None, (_offset_seed(seed, base_seed), chain), scal_f,
            (g, 0, 0),
            taps=taps, oy=oy, ox=ox, n_steps=1, niter_tv=niter_tv,
            with_noise=noise_scale != 0.0, with_stats=False, mode=mode,
            niter_inner=niter_inner,
        )
        return state.next(x_new), StepInfo()

    return Kernel(init, step)


class FusedChainResult(NamedTuple):
    """Moments + final state of a fused chain; ``quantiles`` maps each
    requested probability to its P^2 map, ``quantile_state`` is the raw
    marker state ``(qh, qn)`` for continuation."""

    final_state: SamplerState
    moments: RunningMoments
    samples: Any = None
    metrics: Any = None
    quantiles: Any = None
    quantile_state: Any = None


def _align_block(n_steps, block, quantiles, quantile_thin, noise_scale,
                 step_offset):
    """The block size of the fused runners: the largest divisor of
    ``n_steps`` up to ``block``; with thinned quantiles, block boundaries
    (and the run's start step) align to the quantile group, as the JAX
    package's static in-kernel record positions need."""
    while n_steps % block:
        block -= 1
    if quantiles and quantile_thin > 1:
        group = (quantile_thin * 2 if (noise_scale != 0.0 and quantile_thin % 2)
                 else quantile_thin)
        if n_steps % group:
            raise ValueError(
                f"n_steps={n_steps} must be a multiple of the quantile "
                f"group {group} (quantile_thin={quantile_thin})")
        b = max(block - block % group, group)
        while n_steps % b:
            b -= group
        block = b
        if step_offset % quantile_thin:
            raise ValueError(f"step_offset={step_offset} must align to "
                             f"quantile_thin={quantile_thin}")
    return block


def _marker_state(x0, n_q, quantile_state):
    """``(qh, qn)``: ``quantile_state`` to resume, fresh P^2 markers for
    ``n_q`` quantiles of ``x0``'s ``(ny, nx)`` fields (``(C, 5 n_q, ny,
    nx)`` with a chain axis), or ``(None, None)``."""
    if not n_q:
        return None, None
    if quantile_state is not None:
        return quantile_state
    lead, (ny, nx) = tuple(x0.shape[:-2]), tuple(x0.shape[-2:])
    qh = torch.zeros(lead + (5 * n_q, ny, nx), dtype=x0.dtype, device=x0.device)
    # interior marker positions start at (2, 3, 4); the extremes are implicit
    qn = torch.arange(2.0, 5.0, dtype=x0.dtype, device=x0.device)[
        :, None, None].repeat(n_q, ny, nx)
    return qh, qn.expand(lead + qn.shape).contiguous()


def _chain_result(x, mean, m2, count, quantiles, qh, qn, extras=None):
    """The ``FusedChainResult`` of a block-fused runner."""
    n_q = len(quantiles)
    return FusedChainResult(
        final_state=SamplerState.init(x, extras=extras),
        moments=RunningMoments(count=count, mean=mean, m2=m2),
        # marker 2 is the running quantile estimate (valid once count >= 5)
        quantiles=({p: qh[..., 5 * j + 2, :, :] for j, p in enumerate(quantiles)}
                   if n_q else None),
        quantile_state=(qh, qn) if n_q else None,
    )


def run_myula_tv_fused(
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
    tv_warm: bool = False,
    quantiles: Tuple[float, ...] = (),
    quantile_thin: int = 1,
    quantile_state=None,
    step_offset: int = 0,
    tv_solver: str = "chambolle",
    chain_nx: int = 0,
    marker_hbm: Optional[bool] = None,
    interpret: bool = False,
) -> FusedChainResult:
    """Block-fused MYULA chain: a host loop over blocks of ``block`` fused
    steps (kernel 2 per block on CUDA). Returns the posterior mean/variance
    (Welford; ``burn_in`` in steps) and, with ``quantiles``, per-pixel P^2
    maps (e.g. ``(0.025, 0.975)`` for 95% credible intervals).

    An ``x0`` of shape ``(C, ny, nx)`` runs ``C`` chains of the posterior in
    each kernel call (``run_myula_tv_fused_packed``), chain ``c`` under
    ``chain_keys(key, C)[c]``; every field of the result then has the chain
    axis but ``moments.count``, and the marker state is ``(C, 5 n_q, ny,
    nx)``. ``chain_nx`` takes the JAX package's lane-packed layout: an
    ``x0`` of shape ``(ny, C chain_nx)`` holds ``C`` chains side by side,
    and the result (and ``quantile_state``) comes back packed so. The
    chains share the observation, of width ``chain_nx``. ``marker_hbm`` and
    ``interpret`` are the JAX package's (VMEM paging of the markers, Pallas
    interpret mode) and take no effect: the markers live in device memory
    and a CPU tensor runs the plain version.

    ``key`` is a seed or ``(seed, chain)``, or for a chain axis the list of
    the ``C`` chain keys themselves (a slice of ``chain_keys``, as a rank of
    a farm runs its share). ``quantile_state`` resumes from a
    prior result's marker state, with ``step_offset`` the global step this run
    starts at, so burn-in masking, the P^2 observation count and the noise
    continue across segmented runs. ``tv_warm`` carries the TV dual across a
    block's steps (zeros at each block), and for an ME-TV data term the
    envelope dual too; ``tv_solver="fgp"`` selects the projected-dual FGP
    prox for both (pass ``niter_tv=8``). ``l2`` is an ``L2Data`` or an
    isotropic ``L2NcvxTV``.
    """
    x0 = torch.as_tensor(x0)
    kw = dict(niter_tv=niter_tv, burn_in=burn_in, block=block,
              noise_scale=noise_scale, tv_warm=tv_warm, quantiles=quantiles,
              quantile_thin=quantile_thin, step_offset=step_offset,
              tv_solver=tv_solver)
    if chain_nx and x0.shape[-1] != chain_nx:
        qs = quantile_state and tuple(unpack_lanes(q, chain_nx) for q in quantile_state)
        res = run_myula_tv_fused(l2, tv_sigma, tau, gamma, unpack_lanes(x0, chain_nx),
                                 key, n_steps, quantile_state=qs, **kw)
        return _map_result(res, pack_lanes)
    taps, (oy, ox), atbs = _fused_params(l2)
    mode, lamda, gamma_mc, niter_inner = _fused_mode(l2)
    key = runner_keys(x0, key)
    quantiles = tuple(float(p) for p in quantiles)
    step_offset = int(step_offset)
    block = _align_block(n_steps, min(n_steps, 256) if block is None else block,
                         quantiles, quantile_thin, noise_scale, step_offset)
    scal_f = _pack_scal_f(l2, tau, gamma, tv_sigma, noise_scale, lamda,
                          gamma_mc)
    x, mean, m2 = x0, torch.zeros_like(x0), torch.zeros_like(x0)
    qh, qn = _marker_state(x0, len(quantiles), quantile_state)
    for b in range(n_steps // block):
        step0 = step_offset + b * block
        # the Welford count restarts at this run's first recorded step
        # (partial results merge with RunningMoments.merge); the P^2 count
        # is global
        cnt0 = max(step0 - max(burn_in, step_offset), 0)
        x, mean, m2, qh, qn = myula_tv_block_update(
            x, atbs, mean, m2, key, scal_f, (step0, burn_in, cnt0), qh, qn,
            taps=taps, oy=oy, ox=ox, n_steps=block, niter_tv=niter_tv,
            with_noise=noise_scale != 0.0, with_stats=True, tv_warm=tv_warm,
            quantiles=quantiles, quantile_thin=quantile_thin,
            tv_solver=tv_solver, mode=mode, niter_inner=niter_inner,
        )
    count = (max(step_offset + n_steps - burn_in, 0)
             - max(step_offset - burn_in, 0))
    return _chain_result(x, mean, m2, count, quantiles, qh, qn)


def run_myula_tv_fused_packed(l2: Any, tv_sigma: float, tau, gamma, x0, key,
                              n_steps: int, **kwargs) -> FusedChainResult:
    """``C`` independent chains of one posterior, ``x0`` of shape ``(C, ny,
    nx)``, every kernel-2 call carrying all of them (a grid axis over the
    chains): chain ``c`` is bit for bit ``run_myula_tv_fused`` of ``x0[c]``
    under ``chain_keys(key, C)[c]``. Returns per-chain positions, moments
    (one count), quantile maps and marker state ``(C, 5 n_q, ny, nx)``.
    Takes every ``run_myula_tv_fused`` keyword."""
    x0 = torch.as_tensor(x0)
    if x0.ndim != 3:
        raise ValueError("packed runner wants x0 of shape (n_chains, ny, nx)")
    return run_myula_tv_fused(l2, tv_sigma, tau, gamma, x0, key, n_steps, **kwargs)


def unpack_lanes(a, chain_nx: int):
    """The JAX package's lane-packed layout ``(..., ny, C chain_nx)`` as a
    chain axis ``(C, ..., ny, chain_nx)``."""
    c = a.shape[-1] // chain_nx
    if c * chain_nx != a.shape[-1]:
        raise ValueError(f"width {a.shape[-1]} is not a multiple of chain_nx={chain_nx}")
    b = a.reshape(a.shape[:-1] + (c, chain_nx))
    return b.movedim(-2, 0).contiguous()


def pack_lanes(a):
    """``unpack_lanes``' inverse: ``(C, ..., ny, nx)`` side by side as
    ``(..., ny, C nx)``."""
    return a.movedim(0, -2).reshape(a.shape[1:-1] + (a.shape[0] * a.shape[-1],))


def _map_result(res: FusedChainResult, fn) -> FusedChainResult:
    """``res`` with ``fn`` applied to every per-chain field (the count
    stays)."""
    st = res.final_state
    extras = st.extras
    if extras is not None:
        extras = type(extras)(*(None if v is None else
                                (torch.stack([fn(w) for w in v]) if k == "y" else fn(v))
                                for k, v in extras._asdict().items()))
    return FusedChainResult(
        final_state=SamplerState.init(fn(st.position), extras=extras),
        moments=RunningMoments(count=res.moments.count, mean=fn(res.moments.mean),
                               m2=fn(res.moments.m2)),
        quantiles=res.quantiles and {p: fn(v) for p, v in res.quantiles.items()},
        quantile_state=res.quantile_state and tuple(fn(q) for q in res.quantile_state))
