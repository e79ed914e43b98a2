"""Kernel 7's schedule on the CPU: its tile picker ``ulpda_tiled_plan``
against a brute-force search of the same cost, a torch emulation of its
primal pass on the cone held bit for bit to the plain versions, and its
edge-tile rule.

On the card kernel 7 (``csrc/tiled_block.cu``) runs two launches a ULPDA
step: the dual pass, one thread per pixel, and the primal pass, one CTA a
2-D halo tile of the image on the geometry ``ulpda_tiled_plan`` names. A
CTA computes only the cone its interior's result reads
(``csrc/block_common.cuh::ul_primal_cone``): sweep k of the Chebyshev solve
on the interior grown by the gram's reach times the sweeps left, rhs on the
interior grown by ``e`` (that growth at the first sweep), v on ``e`` plus the
correction's depth (the MC-TV clamp on ``e + 1``, envelope trip ``tr`` on
``e + niter_inner - tr``), the dual loaded one pixel further out. A tile
whose rows and columns avoid image row ``ny - 1`` and column ``nx - 1``
computes without the forward-difference masks. ``_emulate`` runs that
schedule tile by tile in torch ops on ``ulpda_tiled_plan``'s geometry,
shrunk through ``smem_limit`` so that a 64^2 image has ragged, edge and
edge-free tiles; it sets every pixel outside a pass's rectangle to NaN, so a
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
from lmc_atomi_torch.kernels import ulpda_fused as t_ulpda
from lmc_atomi_torch.kernels import ulpda_tiled as t_tiled
from lmc_atomi_torch.kernels.myula_tiled import _free_lines, _round8
from lmc_atomi_torch.ops.functionals import L1Norm, L2Data, L21Norm
from lmc_atomi_torch.ops.linops import CirculantBlur2D, Gradient2D, uniform_kernel
from lmc_atomi_torch.ops.ncvx_tv import L2NcvxTV
from lmc_atomi_torch.ops.tv_cuda import _stencils
from lmc_atomi_torch.run.runner import base_key
from lmc_atomi_torch.utils.images import phantom

torch.set_num_threads(2)

N = 64
SIG = 0.75
TAU = 0.95 * SIG**2
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


def _tile_free(by, bx, ty, tx, h, ny, nx):
    """The edge-free rule (``block_common.cuh::lmc_tile_free``)."""
    y0, x0 = by * ty - h, bx * tx - h
    return y0 >= 0 and x0 >= 0 and y0 + ty + 2 * h <= ny - 1 and x0 + tx + 2 * h <= nx - 1


def _primal(xt, pyt, pxt, atbt, stencils, keep, in_rows, *, taps, oy, ox, lam, ts, tau,
            c_mc, gamma_mc, c_me, niter_solve, mode, niter_inner):
    """One tile's primal pass on its cone (``ul_primal_cone``, Chambolle
    envelope at step 0.25 from zeros); returns u, NaN outside the interior."""
    ky, kx = len(taps[0][0]), len(taps[0][1])
    reach = max(oy, ky - 1 - oy, ox, kx - 1 - ox)
    e = reach * max(niter_solve - 1, 0)
    e_v = e + {"tv": 0, "mctv": 2}.get(mode, niter_inner)
    fwd_y, fwd_x, div = stencils
    x = keep(xt, max(e + reach if niter_solve else 0, e_v))
    v = keep(x - tau * -div(keep(pyt, e_v + 1), keep(pxt, e_v + 1)), e_v)
    if mode == "mctv":
        v = v - c_mc * div(*[keep(a, e + 1) for a in t_fused._mctv_clamp(v, gamma_mc,
                                                                          stencils)])
    elif mode == "metv":
        py = px = torch.zeros_like(v)
        xg = v / gamma_mc
        for tr in range(niter_inner):
            g = e + niter_inner - tr
            u = keep(div(py, px) - xg, g)
            gy, gx = fwd_y(u), fwd_x(u)
            inv = 1.0 / (1.0 + t_tiled._ENV_STEP * torch.sqrt(gy * gy + gx * gx))
            py = keep((py + t_tiled._ENV_STEP * gy) * inv, g)
            px = keep((px + t_tiled._ENV_STEP * gx) * inv, g)
        v = v + c_me * (v - (v - gamma_mc * div(py, px)))
    rhs = keep(v + ts * atbt, e)
    u, d = x, None
    for k, (c_d, c_r) in enumerate(t_ulpda._chebyshev_coefs(ts, lam, niter_solve)):
        g = reach * (niter_solve - 1 - k)
        gu = None
        for wy, wx in taps:
            r = _conv1d(torch.where(in_rows(g), _conv1d(u, wx, ox, 1), torch.nan), wy, oy, 0)
            gu = r if gu is None else gu + r
        res = rhs - (u + ts * gu)
        d = keep(res * c_r if k == 0 else c_d * d + c_r * res, g)
        u = keep(u + d, g)
    return keep(u, 0)


def _emulate(x, xp, py, px, atb, mean, m2, seed, scal_f, scal_i, qh=None, qn=None, *,
             plan, taps, oy, ox, lam, n_steps, niter_solve=3, gfirst=False, dual="l21",
             with_noise=True, quantiles=(), quantile_thin=1, mode="tv", niter_inner=0,
             **_):
    """Kernel 7's schedule on ``plan = (ty, tx, h, ...)``: the dual pass and
    the primal pass on the cone, x ping-ponged. Returns kernel 7's fields and
    the number of edge-free tiles a step."""
    ty, tx, h = plan[:3]
    ny, nx = x.shape
    (tau, mu, theta, noise_amp, ts, g_sigma, c_mc, gamma_mc, _,
     c_me) = t_ulpda._block_coefs(scal_f)
    seed, chain = base_key(seed)
    ry = max(oy, len(taps[0][0]) - 1 - oy)
    rec = t_fused._BlockStats(scal_i, mean, m2, qh, qn, quantiles, quantile_thin, True)
    fwd_y, fwd_x, _ = _stencils(x)

    def dual_pass(py, px, xn, xo):
        xbar = xn + theta * (xn - xo)
        return t_ulpda._dual_project(py + mu * fwd_y(xbar), px + mu * fwd_x(xbar), dual,
                                     g_sigma)

    n_free = 0
    for i in range(n_steps):
        g = rec.step0 + i
        if gfirst:
            py, px = dual_pass(py, px, x, xp)
        noise = normal_field(seed, chain, g, x.shape, x.dtype, x.device)
        dst = torch.empty_like(x)
        n_free = 0
        for by, bx in itertools.product(range(-(-ny // ty)), range(-(-nx // tx))):
            rows = torch.arange(by * ty - h, (by + 1) * ty + h) % ny
            cols = torch.arange(bx * tx - h, (bx + 1) * tx + h) % nx

            def tile(a):
                return a[rows][:, cols]

            if _tile_free(by, bx, ty, tx, h, ny, nx):
                n_free += 1
                stencils = _free_stencils()
            else:
                stencils = _stencils(tile(x), ((rows != ny - 1).to(x.dtype)[:, None],
                                               (cols != nx - 1).to(x.dtype)[None, :]))
            ri, ci = torch.arange(len(rows))[:, None], torch.arange(len(cols))[None, :]

            def grown(e):
                return (ri >= h - e) & (ri < h + ty + e) & (ci >= h - e) & (ci < h + tx + e)

            def keep(a, e):
                return torch.where(grown(e), a, torch.nan)

            def in_rows(e):
                return ((ri >= h - e - ry) & (ri < h + ty + e + ry)
                        & (ci >= h - e) & (ci < h + tx + e))

            u = _primal(tile(x), tile(py), tile(px), tile(atb), stencils, keep, in_rows,
                        taps=taps, oy=oy, ox=ox, lam=lam, ts=ts, tau=tau, c_mc=c_mc,
                        gamma_mc=gamma_mc, c_me=c_me, niter_solve=niter_solve, mode=mode,
                        niter_inner=niter_inner)
            r0, c0 = by * ty, bx * tx
            r1, c1 = min(r0 + ty, ny), min(c0 + tx, nx)
            xn = u[h:h + r1 - r0, h:h + c1 - c0]
            if with_noise:
                xn = xn + noise_amp * noise[r0:r1, c0:c1]
            dst[r0:r1, c0:c1] = xn
        if not gfirst:
            py, px = dual_pass(py, px, dst, x)
        rec(dst.clone(), g)
        xp, x = x, dst
    return (x, xp, py, px, *rec.result()), n_free


@pytest.fixture(scope="module")
def terms():
    img = torch.from_numpy(phantom(N, np.float64))
    blur = CirculantBlur2D.from_kernel((N, N), uniform_kernel(5, torch.float64))
    noise = torch.from_numpy(np.random.default_rng(0).normal(size=(N, N)))
    y = blur.matvec(img) + SIG * noise
    out = {"tv": L2Data.create(op=blur, b=y, sigma=1 / SIG**2)}
    for mode, op2 in (("mctv", Gradient2D()), ("metv", None)):
        out[mode] = L2NcvxTV(op=blur, b=y, op2=op2, sigma=1 / SIG**2, lamda=0.3,
                             gamma=15.0, isotropic=True, niter_inner=4)
    return out


# (data term, dual, options, smem_limit): a card of 2 SMs shrunk so that
# the picker's tiles at 64^2 are ragged, edge and edge-free
CASES = {
    "tv_l21": ("tv", "l21", dict(), 40000),
    "tv_l21_gfirst": ("tv", "l21", dict(gfirst=True), 40000),
    "tv_l1_ci95": ("tv", "l1", dict(quantiles=(0.025, 0.975), quantile_thin=2), 40000),
    "mctv_l1": ("mctv", "l1", dict(), 40000),
    "mctv_l1_gfirst": ("mctv", "l1", dict(gfirst=True), 40000),
    "metv_l21": ("metv", "l21", dict(), 44000),
    "metv_l21_gfirst": ("metv", "l21", dict(gfirst=True), 44000),
    "tv_l21_2sweeps": ("tv", "l21", dict(niter_solve=2), 30000),
}


def _block_args(proxf, dual, dtype, opts):
    """A mid-chain state (moments, markers past their bootstrap) and the
    call's keywords for ``proxf`` with the Gradient2D dual ``dual``."""
    proxg = (L21Norm if dual == "l21" else L1Norm)(sigma=0.3)
    (taps, (oy, ox), atb, mode, lamda, gamma_mc, niter_inner, _,
     lam, _) = t_ulpda._ulpda_setup(proxf, proxg, Gradient2D())
    rng = np.random.default_rng(1)
    x, xp, mean = (torch.from_numpy(a).to(dtype) for a in rng.normal(size=(3, N, N)) * 20 + 100)
    py, px = (torch.from_numpy(a).to(dtype) for a in rng.normal(size=(2, N, N)) * 0.1)
    m2 = torch.from_numpy(rng.uniform(1, 5, size=(N, N)) * 30).to(dtype)
    qh = qn = None
    n_q = len(opts.get("quantiles", ()))
    if n_q:
        q = np.sort(rng.normal(size=(5, N, N)) * 10 + 100, axis=0)
        qh = torch.from_numpy(np.concatenate([q + j for j in range(n_q)])).to(dtype)
        qn = torch.from_numpy(np.tile(np.array([3.0, 6.0, 9.0])[:, None, None],
                                      (n_q, N, N))).to(dtype)
    scal_f = t_ulpda._pack_ulpda_scal(proxf, proxg, TAU, 1.0, 1.0, 1.0, lamda, gamma_mc)
    kw = dict(dict(taps=taps, oy=oy, ox=ox, lam=lam, dual=dual, mode=mode,
                   niter_inner=niter_inner), **opts)
    halo = _round8(max(t_tiled._ulpda_halo_need(kw.get("niter_solve", 3), oy, mode,
                                                niter_inner), 8))
    return (x, xp, py, px, atb.to(dtype), mean, m2, (7, 2), scal_f, (12, 5, 7), qh, qn), kw, halo


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_ulpda_cone_schedule_equals_plain_versions(terms, case, dtype):
    """The emulated kernel-7 schedule equals the tiled plain version and
    (without markers) the whole-image kernel-3 plain version bit for bit
    over STEPS noisy steps, on ``ulpda_tiled_plan``'s tiles: ragged, edge
    and edge-free."""
    name, dual, opts, smem = CASES[case]
    args, kw, halo = _block_args(terms[name], dual, dtype, opts)
    plan = t_tiled.ulpda_tiled_plan((N, N), kw["taps"], kw["oy"], kw["ox"],
                                    niter_solve=kw.get("niter_solve", 3), mode=kw["mode"],
                                    niter_inner=kw["niter_inner"], n_sm=2, smem_limit=smem)
    ty, tx, h, _, edge, tiles = plan
    assert (N % ty or N % tx) and 0 < edge < tiles, plan
    got, n_free = _emulate(*args, plan=plan, n_steps=STEPS, **kw)
    assert n_free == tiles - edge
    tiled = t_tiled.ulpda_tv_tiled_update_ref(*args, n_steps=STEPS, band=16, halo=halo, **kw)
    for field, g, w in zip(("x", "xp", "py", "px", "mean", "m2", "qh", "qn"), got, tiled):
        if w is None:
            assert g is None, field
            continue
        assert g.dtype == dtype and torch.equal(g, w), (field, float((g - w).abs().max()))
    if opts.get("quantiles"):
        return
    x, xp, py, px, atb, mean, m2, seed, scal_f, scal_i = args[:10]
    whole = t_ulpda.ulpda_block_update_ref(
        x, py, px, x + (x - xp), atb, mean, m2, seed, scal_f, scal_i, n_steps=STEPS,
        **{k: v for k, v in kw.items() if k != "quantiles"})
    theta = scal_f[2]
    mine = (got[0], got[2], got[3], got[0] + theta * (got[0] - got[1]), got[4], got[5])
    for field, g, w in zip(("x", "py", "px", "xbar", "mean", "m2"), mine, whole):
        assert torch.equal(g, w), (field, float((g - w).abs().max()))


def _brute_plan(shape, reach, ry, *, niter_solve, mode, niter_inner, n_sm, smem_limit):
    """An independent search of kernel 7's cost (numpy over every interior,
    the envelope's trip sums in closed form): ``(ty, tx, h, threads)``."""
    ny, nx = shape
    e = reach * (niter_solve - 1)
    e_v = e + {"tv": 0, "mctv": 2}.get(mode, niter_inner)
    h = max(e + reach, e_v + 1)
    ty, tx = (a.astype(np.int64) for a in np.meshgrid(np.arange(8, ny + 8, 8),
                                                       np.arange(8, nx + 8, 8), indexing="ij"))

    def area(g):
        return (ty + 2 * g) * (tx + 2 * g)

    work = area(max(e + reach, e_v)) + area(e_v + 1) + area(e_v) + 2 * ty * tx
    work += {"tv": 0, "mctv": area(e + 1) + area(e)}.get(mode, 0)
    if mode == "metv":  # sum_{k=1..n} 2 (ty + 2(e + k))(tx + 2(e + k)), closed form
        n = niter_inner
        s1, s2 = n * (n + 1) // 2, n * (n + 1) * (2 * n + 1) // 6
        a, b = ty + 2 * e, tx + 2 * e
        work += area(h) + 2 * (n * a * b + 2 * (a + b) * s1 + 4 * s2) + area(e)
    for k in range(niter_solve):
        g = reach * (niter_solve - 1 - k)
        work += (ty + 2 * g + 2 * ry) * (tx + 2 * g) + area(g)
    sy, sx = ty + 2 * h, tx + 2 * h
    cta = 4 * 5 * sy * sx + 4 * (sy + sx) + 512
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


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("mode, niter_inner", [("tv", 10), ("mctv", 10), ("metv", 10),
                                               ("metv", 6)])
def test_ulpda_tiled_plan_matches_brute_force(n, mode, niter_inner):
    """On the H100 (132 SMs, 227 KB a CTA) ``ulpda_tiled_plan`` picks the
    geometry of least cost that an independent search finds, with the
    launcher's tile counts; a 5 x 5 blur's gram (9 taps, offset 4), 3
    sweeps."""
    taps = ((tuple([1.0] * 9), tuple([1.0] * 9)),)
    plan = t_tiled.ulpda_tiled_plan((n, n), taps, 4, 4, mode=mode, niter_inner=niter_inner)
    ty, tx, h, threads, edge, tiles = plan
    assert (ty, tx, h, threads) == _brute_plan((n, n), 4, 4, niter_solve=3, mode=mode,
                                               niter_inner=niter_inner, n_sm=132,
                                               smem_limit=232448)
    assert tiles == -(-n // ty) * -(-n // tx)
    assert edge == sum(not _tile_free(by, bx, ty, tx, h, n, n)
                       for by in range(-(-n // ty)) for bx in range(-(-n // tx)))
    # the wrapper asks on every call: the ranking is computed once
    assert t_tiled.ulpda_tiled_plan((n, n), taps, 4, 4, mode=mode,
                                    niter_inner=niter_inner) is plan
    ranking = t_tiled._ulpda_tiled_ranking((n, n), taps, 4, 4, mode=mode,
                                           niter_inner=niter_inner)
    assert ranking[0] == plan and len(ranking) > 1 and ranking[1][:2] != plan[:2]


@pytest.mark.parametrize("shape, ty, tx, h", [((64, 64), 24, 16, 12), ((64, 64), 16, 16, 19),
                                              ((72, 56), 16, 24, 12), ((2048, 2048), 104, 64, 12),
                                              ((1024, 1500), 96, 64, 12), ((40, 40), 8, 8, 12)])
def test_edge_tile_rule_matches_index_scan(shape, ty, tx, h):
    """A tile is edge-free exactly when the image rows and columns its
    halo tile reads (with wrap, ``lmc_tile_geo``'s gr/gc) miss row ``ny - 1``
    and column ``nx - 1``; the planner's count of edge tiles follows."""
    ny, nx = shape
    n_free = 0
    for by in range(-(-ny // ty)):
        for bx in range(-(-nx // tx)):
            gr = [(by * ty - h + r) % ny for r in range(ty + 2 * h)]
            gc = [(bx * tx - h + c) % nx for c in range(tx + 2 * h)]
            scan = ny - 1 not in gr and nx - 1 not in gc
            assert _tile_free(by, bx, ty, tx, h, ny, nx) == scan, (by, bx)
            n_free += scan
    assert n_free == _free_lines(ny, ty, h) * _free_lines(nx, tx, h)


def test_kernel7_halo_and_cuda_wrapper_refuses_cpu(terms):
    """The cone's halo is the resident route's cone halo (12 in TV and
    MC-TV, 19 in ME-TV with 10 envelope trips, for a 5 x 5 blur and 3
    sweeps), below the halo a whole tile needs (``_ulpda_halo_need``: 13,
    15 and 24); a CPU tensor raises in the CUDA wrapper without counting a
    launch."""
    taps = ((tuple([1.0] * 9), tuple([1.0] * 9)),)
    for mode, want in (("tv", 12), ("mctv", 12), ("metv", 19)):
        assert t_ulpda._ulpda_halo(taps, 4, 4, 3, mode, 10) == want
        assert want < t_tiled._ulpda_halo_need(3, 4, mode, 10)
    args, kw, halo = _block_args(terms["tv"], "l21", torch.float32, {})
    wrapper = t_tiled.ulpda_tv_tiled_update_cuda
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(*args, n_steps=2, band=16, halo=halo, **kw)
    assert wrapper.launches == before
