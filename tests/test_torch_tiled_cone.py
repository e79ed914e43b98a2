"""Kernel 6's schedule on the CPU: its tile picker ``tiled_plan`` against a
brute-force search of the same cost, a torch emulation of its tile step held
bit for bit to the plain versions, and its edge-tile rule.

On the card kernel 6 (``csrc/tiled_block.cu::tl_myula_step``) runs one
launch a MYULA step, one CTA a 2-D halo tile of the image on the geometry
``tiled_plan`` names. A CTA computes only the cone its interior's result
reads: the gram on the interior (its row pass on the rows within the row
taps' reach), the MC-TV clamp on the interior grown by 1, and TV trip ``tr``
of ``niter`` (and of the ME-TV envelope) on the interior grown by ``niter -
tr``, from cold duals. A tile whose rows and columns avoid image row ``ny -
1`` and column ``nx - 1`` (no wrap, not the last row or column of tiles)
computes without the forward-difference masks. ``_emulate`` runs that
schedule tile by tile in torch ops on ``tiled_plan``'s geometry, shrunk
through ``smem_limit`` so that a 64^2 image has ragged, edge and edge-free
tiles; it sets every pixel outside the cone to NaN after each pass, so a
read outside the cone, or a mask dropped on a tile that needs it, makes it
differ from the plain versions. With a correct schedule every interior pixel
takes the same operations on the same values, so they agree bit for bit.
"""
import itertools

import numpy as np
import pytest
import torch

from lmc_atomi_torch.core.random import normal_field
from lmc_atomi_torch.kernels import myula_fused as t_fused
from lmc_atomi_torch.kernels import myula_tiled as t_tiled
from lmc_atomi_torch.ops.functionals import L2Data
from lmc_atomi_torch.ops.linops import CirculantBlur2D, Gradient2D, uniform_kernel
from lmc_atomi_torch.ops.ncvx_tv import L2NcvxTV
from lmc_atomi_torch.ops.tv_cuda import _stencils
from lmc_atomi_torch.run.runner import base_key
from lmc_atomi_torch.utils.images import phantom

torch.set_num_threads(2)

N = 64
SIG = 0.75
GAMMA = SIG**2
TAU = 0.2 * GAMMA
STEPS = 4  # two parity pairs


def _free_stencils():
    """The stencils of an edge-free tile: every mask at "keep", so none is
    applied."""
    def fwd_y(a):
        return torch.roll(a, -1, 0) - a

    def fwd_x(a):
        return torch.roll(a, -1, 1) - a

    def div(py, px):
        return (py - torch.roll(py, 1, 0)) + (px - torch.roll(px, 1, 1))

    return fwd_y, fwd_x, div


def _cone_prox(x, gamma, niter, tv_solver, tv_step, stencils, grown):
    """``myula_fused._tv_prox`` / ``_tv_prox_fgp`` op for op from cold duals,
    with the pixels outside trip ``tr``'s cone (the interior grown by ``niter
    - tr``, the mask ``grown(e)``) set to NaN after each pass."""
    fwd_y, fwd_x, div = stencils
    nan = torch.tensor(float("nan"), dtype=x.dtype)

    def keep(a, e):
        return torch.where(grown(e), a, nan)

    xg = x / gamma
    py = px = torch.zeros_like(x)
    ry, rx = py, px
    coefs = t_fused.fgp_momentum(niter) if tv_solver == "fgp" else [None] * niter
    for tr, c in enumerate(coefs):
        e = niter - tr
        if tv_solver == "fgp":
            u = keep(div(ry, rx) - xg, e)
            qy = ry + t_fused._FGP_STEP * fwd_y(u)
            qx = rx + t_fused._FGP_STEP * fwd_x(u)
            scale = torch.rsqrt(qy * qy + qx * qx).clamp(max=1.0)
            qy, qx = qy * scale, qx * scale
            ry, rx = keep(qy + c * (qy - py), e), keep(qx + c * (qx - px), e)
            py, px = keep(qy, e), keep(qx, e)
        else:
            u = keep(div(py, px) - xg, e)
            gy = fwd_y(u)
            gx = fwd_x(u)
            mag = torch.sqrt(gy * gy + gx * gx)
            inv = 1.0 / (1.0 + tv_step * mag)
            py, px = keep((py + tv_step * gy) * inv, e), keep((px + tv_step * gx) * inv, e)
    return x - gamma * div(py, px)


def _conv1d(v, w, off, axis):
    """``myula_fused._sep_gram``'s one-axis pass, wrapping within the tile."""
    out = None
    for i, wi in enumerate(w):
        if wi == 0.0:
            continue
        s = (i - off) % v.shape[axis]
        term = v if s == 0 else torch.roll(v, s, axis)
        term = term * wi
        out = term if out is None else out + term
    return out


def _cone_gram(xt, taps, oy, ox, rows_mask):
    """``_sep_gram`` on a tile with the row pass kept only where the
    interior's column pass reads it (``rows_mask``), NaN elsewhere."""
    nan = torch.tensor(float("nan"), dtype=xt.dtype)
    out = None
    for wy, wx in taps:
        r = _conv1d(torch.where(rows_mask, _conv1d(xt, wx, ox, 1), nan), wy, oy, 0)
        out = r if out is None else out + r
    return out


def _tile_free(by, bx, ty, tx, h, ny, nx):
    """Kernel 6's edge-free rule (``block_common.cuh::lmc_tile_free``)."""
    y0, x0 = by * ty - h, bx * tx - h
    return y0 >= 0 and x0 >= 0 and y0 + ty + 2 * h <= ny - 1 and x0 + tx + 2 * h <= nx - 1


def _emulate(x, atbs, mean, m2, seed, scal_f, scal_i, qh=None, qn=None, *,
             plan, taps, oy, ox, n_steps, niter_tv=10, tv_step=0.25,
             with_noise=True, quantiles=(), quantile_thin=1,
             tv_solver="chambolle", mode="tv", niter_inner=10):
    """Kernel 6's tile schedule on ``plan = (ty, tx, h, ...)``, one launch a
    step, x ping-ponged between two buffers. Returns ``(x, mean, m2, qh, qn)``
    and the number of edge-free tiles a step."""
    ty, tx, h = plan[:3]
    ny, nx = x.shape
    (c_keep, c_grad, c_prox, noise_amp, sigma, tv_gamma, lamda, gamma_mc, _,
     c_env) = t_fused._update_coefs(scal_f)
    seed, chain = base_key(seed)
    ry = max(oy, len(taps[0][0]) - 1 - oy)
    rec = t_fused._BlockStats(scal_i, mean, m2, qh, qn, quantiles, quantile_thin, True)
    nan = torch.tensor(float("nan"), dtype=x.dtype)
    src, n_free = x, 0
    for i in range(n_steps):
        g = rec.step0 + i
        dst = torch.empty_like(x)
        noise = normal_field(seed, chain, g, x.shape, x.dtype, x.device)
        n_free = 0
        for by, bx in itertools.product(range(-(-ny // ty)), range(-(-nx // tx))):
            rows = torch.arange(by * ty - h, (by + 1) * ty + h) % ny
            cols = torch.arange(bx * tx - h, (bx + 1) * tx + h) % nx
            xt = src[rows][:, cols]
            if _tile_free(by, bx, ty, tx, h, ny, nx):
                n_free += 1
                stencils = _free_stencils()
            else:
                my = (rows != ny - 1).to(x.dtype)[:, None]
                mx = (cols != nx - 1).to(x.dtype)[None, :]
                stencils = _stencils(xt, (my, mx))
            r0, c0 = by * ty, bx * tx
            r1, c1 = min(r0 + ty, ny), min(c0 + tx, nx)
            inner = (slice(h, h + r1 - r0), slice(h, h + c1 - c0))
            img = (slice(r0, r1), slice(c0, c1))
            ri = torch.arange(len(rows))[:, None]
            ci = torch.arange(len(cols))[None, :]

            def grown(e):
                return ((ri >= h - e) & (ri < h + ty + e)
                        & (ci >= h - e) & (ci < h + tx + e))

            in_rows = (ri >= h - ry) & (ri < h + ty + ry) & (ci >= h) & (ci < h + tx)
            gram = torch.where(grown(0), _cone_gram(xt, taps, oy, ox, in_rows), nan)
            grad = sigma * gram[inner] - atbs[img]
            if mode == "mctv":
                clamp = [torch.where(grown(1), a, nan)
                         for a in t_fused._mctv_clamp(xt, gamma_mc, stencils)]
                grad = grad + lamda * stencils[2](*clamp)[inner]
            elif mode == "metv":
                p_env = _cone_prox(xt, gamma_mc, niter_inner, tv_solver, tv_step,
                                   stencils, grown)
                grad = grad - c_env * (xt[inner] - p_env[inner])
            prox = _cone_prox(xt, tv_gamma, niter_tv, tv_solver, tv_step, stencils, grown)
            x_new = c_keep * xt[inner] - c_grad * grad + c_prox * prox[inner]
            if with_noise:
                x_new = x_new + noise_amp * noise[img]
            dst[img] = x_new
        rec(dst.clone(), g)
        src = dst
    return (src, *rec.result()), n_free


@pytest.fixture(scope="module")
def terms():
    img = torch.from_numpy(phantom(N, np.float64))
    blur = CirculantBlur2D.from_kernel((N, N), uniform_kernel(5, torch.float64))
    noise = torch.from_numpy(np.random.default_rng(0).normal(size=(N, N)))
    y = blur.matvec(img) + SIG * noise
    out = {"tv": L2Data.create(op=blur, b=y, sigma=1 / SIG**2)}
    for mode, op2 in (("mctv", Gradient2D()), ("metv", None)):
        out[mode] = L2NcvxTV(op=blur, b=y, op2=op2, sigma=1 / SIG**2, lamda=0.3,
                             gamma=15.0, isotropic=True, niter_inner=6)
    return out


# (data term, options, (n_sm, smem_limit)): a card shrunk so that the
# picker's tiles at 64^2 are 24 x 16 (ragged in rows; edge and edge-free)
CASES = {
    "tv_cold10": ("tv", dict(niter_tv=10), (2, 32000)),
    "tv_fgp8": ("tv", dict(niter_tv=8, tv_solver="fgp"), (2, 40000)),
    "tv_cold10_ci95": ("tv", dict(niter_tv=10, quantiles=(0.025, 0.975), quantile_thin=2),
                       (2, 32000)),
    "mctv_cold10": ("mctv", dict(niter_tv=10), (2, 32000)),
    "metv_cold4": ("metv", dict(niter_tv=4), (3, 24000)),
    "metv_fgp5": ("metv", dict(niter_tv=5, tv_solver="fgp"), (3, 30000)),
}


def _block_args(l2, dtype, opts):
    """A mid-chain state (moments, markers past their bootstrap) and the
    block call's keywords for ``l2``."""
    taps, (oy, ox), atbs = t_fused._fused_params(l2)
    mode, lamda, gamma_mc, niter_inner = t_fused._fused_mode(l2)
    rng = np.random.default_rng(1)
    x, mean = (torch.from_numpy(a).to(dtype) for a in rng.normal(size=(2, N, N)) * 20 + 100)
    m2 = torch.from_numpy(rng.uniform(1, 5, size=(N, N)) * 30).to(dtype)
    qh = qn = None
    n_q = len(opts.get("quantiles", ()))
    if n_q:
        q = np.sort(rng.normal(size=(5, N, N)) * 10 + 100, axis=0)
        qh = torch.from_numpy(np.concatenate([q + j for j in range(n_q)])).to(dtype)
        qn = torch.from_numpy(np.tile(np.array([3.0, 6.0, 9.0])[:, None, None],
                                      (n_q, N, N))).to(dtype)
    scal_f = t_fused._pack_scal_f(l2, TAU, GAMMA, 0.3, 1.0, lamda, gamma_mc)
    kw = dict(taps=taps, oy=oy, ox=ox, mode=mode, niter_inner=niter_inner, **opts)
    return (x, atbs.to(dtype), mean, m2, (7, 2), scal_f, (12, 5, 7), qh, qn), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_tiled_cone_schedule_equals_plain_versions(terms, case, dtype):
    """The emulated kernel-6 schedule equals the tiled plain version and the
    whole-image plain version bit for bit over STEPS noisy steps, on
    ``tiled_plan``'s tiles: ragged, edge and edge-free."""
    name, opts, (n_sm, smem) = CASES[case]
    args, kw = _block_args(terms[name], dtype, opts)
    plan = t_tiled.tiled_plan(
        (N, N), kw["taps"], kw["oy"], kw["ox"], niter_tv=opts["niter_tv"],
        tv_solver=opts.get("tv_solver", "chambolle"), mode=kw["mode"],
        niter_inner=kw["niter_inner"], n_sm=n_sm, smem_limit=smem)
    ty, tx, h, _, edge, tiles = plan
    assert (ty, tx) == (24, 16) and N % ty and 0 < edge < tiles, plan
    got, n_free = _emulate(*args, plan=plan, n_steps=STEPS, **kw)
    assert n_free == tiles - edge > 0
    whole = t_fused.myula_tv_block_update_ref(*args, n_steps=STEPS, **kw)
    tiled = t_tiled.myula_tv_tiled_update_ref(*args, n_steps=STEPS, band=16, halo=h + (-h) % 8,
                                              **kw)
    for want in (whole, tiled):
        for field, g, w in zip(("x", "mean", "m2", "qh", "qn"), got, want):
            if w is None:
                assert g is None, field
                continue
            assert g.dtype == dtype and torch.equal(g, w), (
                field, float((g - w).abs().max()))


def _brute_plan(shape, taps, oy, ox, *, niter_tv, tv_solver="chambolle", mode="tv",
                niter_inner=10, n_sm, smem_limit):
    """An independent search of kernel 6's cost (numpy over every interior,
    the trip sums in closed form): ``(ty, tx, h, threads)``."""
    ny, nx = shape
    ky, kx = len(taps[0][0]), len(taps[0][1])
    ry = max(oy, ky - 1 - oy)
    h = max([niter_tv + 1, ry, ox, kx - 1 - ox] + [2] * (mode == "mctv")
            + [niter_inner + 1] * (mode == "metv"))
    ty, tx = (a.astype(np.int64) for a in np.meshgrid(np.arange(8, ny + 8, 8),
                                                       np.arange(8, nx + 8, 8), indexing="ij"))
    sy, sx = ty + 2 * h, tx + 2 * h

    def trips(n):  # sy sx + sum_{e=1..n} 2 (ty + 2e)(tx + 2e)
        return (sy * sx + 2 * (n * ty * tx + (ty + tx) * n * (n + 1)
                               + 4 * n * (n + 1) * (2 * n + 1) // 6))

    work = sy * sx + len(taps) * ((ty + 2 * ry) * tx + ty * tx) + 2 * ty * tx + trips(niter_tv)
    work = work + ((ty + 2) * (tx + 2) if mode == "mctv" else 0)
    work = work + (trips(niter_inner) if mode == "metv" else 0)
    fields = 6 if tv_solver == "fgp" else 4
    cta = 4 * (fields * sy * sx + ty * tx) + 4 * (sy + sx) + 256
    tiles = -(-ny // ty) * -(-nx // tx)
    best = None
    for threads in (512, 1024):
        per_sm = 1024 // threads
        fits = (cta <= smem_limit) & (per_sm * (cta + 1024) <= smem_limit + 1024)
        cost = -(-tiles // (n_sm * per_sm)) * per_sm * work
        for i, j in zip(*np.nonzero(fits)):
            key = (int(cost[i, j]), threads, int(ty[i, j]), int(tx[i, j]))
            best = key if best is None or key < best else best
    return best[2], best[3], h, best[1]


PLAN_MODES = {"tv_cold10": dict(niter_tv=10), "tv_fgp8": dict(niter_tv=8, tv_solver="fgp"),
              "mctv_cold10": dict(niter_tv=10, mode="mctv"),
              "metv_cold10": dict(niter_tv=10, mode="metv", niter_inner=10)}


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("opts", list(PLAN_MODES))
def test_tiled_plan_matches_brute_force(n, opts):
    """On the H100 (132 SMs, 227 KB a CTA) ``tiled_plan`` picks the geometry
    of least cost that an independent search finds, with the launcher's
    tile counts; a 5 x 5 blur's gram (9 taps, offset 4)."""
    kw = PLAN_MODES[opts]
    taps = ((tuple([1.0] * 9), tuple([1.0] * 9)),)
    plan = t_tiled.tiled_plan((n, n), taps, 4, 4, **kw)
    ty, tx, h, threads, edge, tiles = plan
    assert (ty, tx, h, threads) == _brute_plan((n, n), taps, 4, 4, n_sm=132,
                                               smem_limit=232448, **kw)
    assert tiles == -(-n // ty) * -(-n // tx)
    assert edge == sum(not _tile_free(by, bx, ty, tx, h, n, n)
                       for by in range(-(-n // ty)) for bx in range(-(-n // tx)))
    # the wrapper asks on every call: the ranking is computed once
    assert t_tiled.tiled_plan((n, n), taps, 4, 4, **kw) is plan
    # the ranking that measurements walk starts at the pick and goes on past it
    ranking = t_tiled._tiled_ranking((n, n), taps, 4, 4, **kw)
    assert ranking[0] == plan and len(ranking) > 1 and ranking[1][:2] != plan[:2]


@pytest.mark.parametrize("shape, ty, tx, h", [((64, 64), 24, 16, 11), ((64, 64), 16, 16, 7),
                                              ((72, 56), 16, 24, 9), ((2048, 2048), 104, 64, 11),
                                              ((40, 40), 8, 8, 11)])
def test_edge_tile_rule_matches_index_scan(shape, ty, tx, h):
    """A tile is edge-free exactly when the image rows and columns its
    halo tile reads (with wrap, ``lmc_tile_geo``'s gr/gc) miss row ``ny - 1``
    and column ``nx - 1``; ``tiled_plan``'s count of edge tiles follows."""
    ny, nx = shape
    n_free = 0
    for by in range(-(-ny // ty)):
        for bx in range(-(-nx // tx)):
            gr = [(by * ty - h + r) % ny for r in range(ty + 2 * h)]
            gc = [(bx * tx - h + c) % nx for c in range(tx + 2 * h)]
            scan = ny - 1 not in gr and nx - 1 not in gc
            assert _tile_free(by, bx, ty, tx, h, ny, nx) == scan, (by, bx)
            n_free += scan
    assert n_free == t_tiled._free_lines(ny, ty, h) * t_tiled._free_lines(nx, tx, h)
