"""Kernel 3's resident route on the CPU: a torch emulation of its tile
schedule held bit for bit to the plain version, and its host-side planner.

On the card the resident route (``csrc/ulpda_block.cu::ul_resident_block``)
runs a whole block call as one cooperative launch: one CTA per 2-D tile of
the image (interior ``ty x tx`` and halo ``h`` from
``ulpda_resident_plan``), every CTA resident at once. A step is a primal
phase and a dual phase with a grid barrier after each (``gfirst`` puts the
dual phase first): the primal phase reads its tile of x from one of two
parity buffers and the dual around it, computes v, the MC-TV / ME-TV
correction and rhs on the cone its interior reads
(``csrc/block_common.cuh::ul_primal_cone``), runs the Chebyshev sweeps on
the interior with u exchanged through two planes in device memory and a
grid barrier after each sweep but the last, and writes its interior's x' to
the other buffer and xbar; the dual phase updates its interior's dual from
xbar. With ``env_warm`` the envelope dual goes through parity buffers.

A CUDA kernel has no CPU mode, and running its CTAs one after another never
passes a grid barrier, so ``_emulate`` stands in: the same schedule, phase by
phase and tile by tile, in torch ops, on the planner's geometry (shrunk
through ``n_sm``). It sets every pixel outside a pass's rectangle to NaN, so
a read outside the cone, a missing exchange or a wrong halo reaches the
interior as NaN or a wrong value. With a correct schedule every interior
pixel takes the plain version's operations on the same values, so the two
agree bit for bit, in f32 as in f64.
"""
import numpy as np
import pytest
import torch

from lmc_atomi_torch.core.random import chain_keys, normal_field
from lmc_atomi_torch.kernels import myula_fused as t_fused
from lmc_atomi_torch.kernels import ulpda_fused as t_ulpda
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


def _cone_dual(f, gamma, niter, tv_solver, tv_step, stencils, p0, keep):
    """The envelope prox's final dual, ``myula_fused._tv_prox`` /
    ``_tv_prox_fgp`` op for op from ``p0`` (or zeros), trip ``tr`` kept on
    the interior grown by ``niter - tr`` (``keep(a, e)``), NaN elsewhere."""
    fwd_y, fwd_x, div = stencils
    xg = f / gamma
    py, px = (torch.zeros_like(f), torch.zeros_like(f)) if p0 is None else p0
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
    return py, px


def _lockstep(schedules):
    """Run the step generators of one cooperative launch's chains in
    lockstep (the grid barriers step them together); their results."""
    out, live = [None] * len(schedules), list(range(len(schedules)))
    while live:
        for i in list(live):
            try:
                next(schedules[i])
            except StopIteration as stop:
                out[i] = stop.value
                live.remove(i)
    return out


def _emulate(*args, **kwargs):
    """Kernel 3's resident schedule on one chain (see ``_schedule``)."""
    return _lockstep([_schedule(*args, **kwargs)])[0]


def _schedule(x, py, px, xbar, atb, mean, m2, seed, scal_f, scal_i, *, plan, taps, oy,
              ox, lam, n_steps, niter_solve=3, tv_step=0.25, gfirst=False, dual="l21",
              mode="tv", niter_inner=10, with_noise=True, tv_solver="chambolle",
              with_stats=True, env_warm=False, levels=3, bufs=None):
    """Kernel 3's resident schedule on ``plan = (ty, tx, h, ...)``, yielding
    at the grid barriers after the u exchanges and after each step; ``bufs`` are the launch's device buffers of this chain,
    ``(xs, ev, ub)``: the x parity pair (x in the first), the envelope
    dual's (y, x) planes of parity 0 and 1 and the exchanged u (fresh ones
    when None)."""
    ty, tx, h = plan[:3]
    ny, nx = x.shape
    (tau, mu, theta, noise_amp, ts, g_sigma, c_mc, gamma_mc, _,
     c_me) = t_ulpda._block_coefs(scal_f)
    seed, chain = base_key(seed)
    ky, kx = len(taps[0][0]), len(taps[0][1])
    ry = max(oy, ky - 1 - oy)
    reach = max(ry, ox, kx - 1 - ox)
    e_v = {"tv": 0, "mctv": 2}.get(mode, niter_inner)
    rec = t_fused._BlockStats(scal_i, mean, m2, None, None, (), 1, with_stats)
    cheb = t_ulpda._chebyshev_coefs(ts, lam, niter_solve)
    fwd_y, fwd_x, _ = _stencils(x)
    nan = torch.tensor(float("nan"), dtype=x.dtype)
    if bufs is None:
        # the exchanged u: two parity planes on the card
        bufs = ([x, torch.empty_like(x)],
                [torch.empty((2, ny, nx), dtype=x.dtype) for _ in range(2)],
                torch.empty_like(x))
    xs, ev, ub = bufs
    tiles = []
    for by in range(-(-ny // ty)):
        for bx in range(-(-nx // tx)):
            rows = torch.arange(by * ty - h, (by + 1) * ty + h) % ny
            cols = torch.arange(bx * tx - h, (bx + 1) * tx + h) % nx
            r0, c0 = by * ty, bx * tx
            r1, c1 = min(r0 + ty, ny), min(c0 + tx, nx)
            ri, ci = torch.arange(len(rows))[:, None], torch.arange(len(cols))[None, :]
            tiles.append(dict(
                rows=rows, cols=cols, img=(slice(r0, r1), slice(c0, c1)),
                inner=(slice(h, h + r1 - r0), slice(h, h + c1 - c0)),
                grown=lambda e, ri=ri, ci=ci: ((ri >= h - e) & (ri < h + ty + e)
                                               & (ci >= h - e) & (ci < h + tx + e)),
                in_rows=(torch.arange(len(rows))[:, None] >= h - ry)
                & (torch.arange(len(rows))[:, None] < h + ty + ry) & (ci >= h) & (ci < h + tx),
                stencils=_stencils(torch.empty(len(rows), len(cols), dtype=x.dtype),
                                   ((rows != ny - 1).to(x.dtype)[:, None],
                                    (cols != nx - 1).to(x.dtype)[None, :]))))

    def tile(t, a):
        return a[..., t["rows"], :][..., t["cols"]]

    def dual_phase(py, px, xbar):  # ul_dual on every interior at once
        return t_ulpda._dual_project(py + mu * fwd_y(xbar), px + mu * fwd_x(xbar), dual,
                                     g_sigma)

    for i in range(n_steps):
        g = rec.step0 + i
        par = i % 2
        src, dst = xs[par], xs[1 - par]
        if gfirst:
            py, px = dual_phase(py, px, xbar)
        noise = normal_field(seed, chain, g, x.shape, x.dtype, x.device)
        for t in tiles:  # v, the correction, rhs
            def keep(a, e, t=t):
                return torch.where(t["grown"](e), a, nan)

            _, _, div = t["stencils"]
            t["X"] = keep(tile(t, src), max(reach if niter_solve else 0, e_v))
            p_y, p_x = keep(tile(t, py), e_v + 1), keep(tile(t, px), e_v + 1)
            v = keep(t["X"] - tau * -div(p_y, p_x), e_v)
            atb_t = tile(t, atb)
            if mode == "mctv":
                clamp = [keep(a, 1) for a in t_fused._mctv_clamp(v, gamma_mc,
                                                                 t["stencils"])]
                v = v - c_mc * div(*clamp)
            elif mode == "metv":
                p0 = tuple(tile(t, ev[1 - par])) if env_warm and i > 0 else None
                env = _cone_dual(v, gamma_mc, niter_inner, tv_solver, tv_step, t["stencils"],
                                 p0, keep)
                v = v + c_me * (v - (v - gamma_mc * div(*env)))
                for k in range(2):
                    ev[par][k][t["img"]] = env[k][t["inner"]]
            t["V"] = keep(v + ts * atb_t, 0)
        for sw, (c_d, c_r) in enumerate(cheb):  # the Chebyshev sweeps, on the interiors
            for t in tiles:
                if sw:  # u of every interior, exchanged
                    t["X"] = torch.where(t["grown"](reach), tile(t, ub), nan)
                gu = None
                for wy, wx in taps:
                    r = torch.where(t["in_rows"], _conv1d(t["X"], wx, ox, 1), nan)
                    r = _conv1d(r, wy, oy, 0)
                    gu = r if gu is None else gu + r
                res = t["V"] - (t["X"] + ts * gu)
                d = res * c_r if sw == 0 else c_d * t["D"] + c_r * res
                t["D"] = torch.where(t["grown"](0), d, nan)
                t["X"] = torch.where(t["grown"](0), t["X"] + d, nan)
            for t in tiles:
                ub[t["img"]] = t["X"][t["inner"]]
            yield  # the grid barrier after an exchange
        for t in tiles:  # ul_finish on the interior
            xn = t["X"][t["inner"]]
            if with_noise:
                xn = xn + noise_amp * noise[t["img"]]
            dst[t["img"]] = xn
        xbar = dst + theta * (dst - src)
        if not gfirst:
            py, px = dual_phase(py, px, xbar)
        rec(dst.clone(), g)
        yield
    mean, m2, _, _ = rec.result()
    return xs[n_steps % 2], py, px, xbar, mean, m2


def _emulate_chains(x, py, px, xbar, atb, mean, m2, keys, scal_f, scal_i, *, plan,
                    n_steps, **kw):
    """Kernel 3's resident route with a chain axis on ``plan = (ty, tx, h,
    G)``: the chains in groups of ``G``, one cooperative launch a group,
    stepping in lockstep, each chain's fields at its offset in the launch's
    device buffers as ``csrc/ulpda_block.cu`` lays them out (x and its
    parity buffer chain-major, the envelope duals 8 planes a chain, u 2
    planes a chain). The parity, envelope and u buffers start as NaN, so a
    chain that reads outside its own fields, or before they are written,
    reaches its interior as NaN."""
    c, ny, nx = x.shape
    g = plan[3]
    xbuf, parity = x.clone(), torch.full_like(x, float("nan"))
    env = torch.full((8 * c, ny, nx), float("nan"), dtype=x.dtype)
    ub = torch.full((2 * c, ny, nx), float("nan"), dtype=x.dtype)
    out = []
    for c0 in range(0, c, g):
        out += _lockstep([_schedule(
            xbuf[z], py[z], px[z], xbar[z], atb, mean[z], m2[z], keys[z], scal_f, scal_i,
            plan=plan, n_steps=n_steps,
            bufs=([xbuf[z], parity[z]], [env[8 * z + 2 * p:8 * z + 2 * p + 2] for p in (0, 1)],
                  ub[2 * z]), **kw)
            for z in range(c0, min(c0 + g, c))])
    return tuple(torch.stack(o) for o in zip(*out))


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


def _block_args(proxf, dual, dtype, opts):
    """A mid-chain state and the block call's keywords for ``proxf`` with
    the Gradient2D dual ``dual``."""
    proxg = (L21Norm if dual == "l21" else L1Norm)(sigma=0.3)
    (taps, (oy, ox), atb, mode, lamda, gamma_mc, niter_inner, dual_,
     lam, _) = t_ulpda._ulpda_setup(proxf, proxg, Gradient2D())
    rng = np.random.default_rng(1)
    x, xbar, mean = (torch.from_numpy(a).to(dtype)
                     for a in rng.normal(size=(3, N, N)) * 20 + 100)
    py, px = (torch.from_numpy(a).to(dtype) for a in rng.normal(size=(2, N, N)) * 0.1)
    m2 = torch.from_numpy(rng.uniform(1, 5, size=(N, N)) * 30).to(dtype)
    scal_f = t_ulpda._pack_ulpda_scal(proxf, proxg, TAU, 1.0, 1.0, 1.0, lamda, gamma_mc)
    kw = dict(dict(taps=taps, oy=oy, ox=ox, lam=lam, dual=dual_, mode=mode,
                   niter_inner=niter_inner), **opts)
    return (x, py, px, xbar, atb.to(dtype), mean, m2, (7, 2), scal_f, (12, 5, 7)), kw


def _plan(kw, n_sm=12):
    return t_ulpda.ulpda_resident_plan(
        (N, N), kw["taps"], kw["oy"], kw["ox"], mode=kw["mode"],
        niter_inner=kw["niter_inner"], niter_solve=kw.get("niter_solve", 3),
        dual=kw["dual"], tv_solver=kw.get("tv_solver", "chambolle"), n_sm=n_sm)


# (data term, dual, options): the deconvolution models' duals in both
# orders, the ME-TV envelope warm (Chambolle and FGP), 2 sweeps
CASES = {
    "tv_l21": ("tv", "l21", dict()),
    "tv_l21_gfirst": ("tv", "l21", dict(gfirst=True)),
    "tv_l1_2sweeps": ("tv", "l1", dict(niter_solve=2)),
    "mctv_l1": ("mctv", "l1", dict()),
    "mctv_l1_gfirst": ("mctv", "l1", dict(gfirst=True)),
    "metv_l21": ("metv", "l21", dict()),
    "metv_l21_gfirst": ("metv", "l21", dict(gfirst=True)),
    "metv_warm": ("metv", "l21", dict(env_warm=True)),
    "metv_fgp_warm": ("metv", "l21", dict(env_warm=True, tv_solver="fgp", niter_inner=4)),
}
STEPS = 3  # odd: the last step ends in the other parity buffer


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_resident_schedule_equals_plain_version(terms, case, dtype):
    """The emulated resident schedule equals the plain version bit for bit
    over STEPS noisy steps, on the planner's tiles for a card of 12 SMs
    (16 x 24 interiors, ragged in columns)."""
    name, dual, opts = CASES[case]
    args, kw = _block_args(terms[name], dual, dtype, opts)
    plan = _plan(kw)
    assert plan[:2] == (16, 24)
    want = t_ulpda.ulpda_block_update_ref(*args, n_steps=STEPS, **kw)
    got = _emulate(*args, plan=plan, n_steps=STEPS, **kw)
    for field, g, w in zip(("x", "py", "px", "xbar", "mean", "m2"), got, want):
        assert g.dtype == dtype and torch.equal(g, w), (field, float((g - w).abs().max()))


@pytest.mark.parametrize("name, dual", [("tv", "l21"), ("mctv", "l1"), ("metv", "l21")])
def test_resident_one_step_without_stats(terms, name, dual):
    """The deconvolution grid's call: one step, no statistics, noise on, the
    incoming xbar unread, on 16 x 16 interiors (16 SMs)."""
    args, kw = _block_args(terms[name], dual, torch.float32, {})
    args = args[:3] + (torch.full_like(args[0], float("nan")),) + args[4:5] + (None, None) \
        + args[7:]
    kw["with_stats"] = False
    want = t_ulpda.ulpda_block_update_ref(*args, n_steps=1, **kw)
    got = _emulate(*args, plan=_plan(kw, n_sm=16), n_steps=1, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got[:4], want[:4]))
    assert got[4] is None and got[5] is None


def _taps(k):
    return ((tuple([1.0] * (2 * k - 1)), tuple([1.0] * (2 * k - 1))),)


@pytest.mark.parametrize("shape, n_sm", [((64, 64), 16), ((64, 64), 12), ((56, 72), 9),
                                         ((512, 512), 132), ((300, 200), 132)])
@pytest.mark.parametrize("mode, opts", [("tv", {}), ("mctv", {}), ("metv", dict(niter_inner=12)),
                                        ("metv", dict(tv_solver="fgp", niter_inner=8)),
                                        ("tv", dict(niter_solve=0))])
def test_resident_plan_tiles_fit_and_halo(shape, n_sm, mode, opts):
    """Every pixel lies in exactly one interior, the tiles number at most
    ``n_sm``, the shared memory fits, and the halo holds the cone with the
    sweeps on the interior: x on the interior grown by the reach, the dual
    on ``e_v + 1``."""
    taps, reach = _taps(5), 4  # a 5x5 blur's autocorrelation: 9 taps, offset 4
    ty, tx, h, g = t_ulpda.ulpda_resident_plan(shape, taps, 4, 4, mode=mode, n_sm=n_sm,
                                               **opts)
    assert g == 1
    ny, nx = shape
    e_v = {"tv": 0, "mctv": 2}.get(mode, opts.get("niter_inner", 10))
    assert ty % 8 == 0 and tx % 8 == 0
    assert -(-ny // ty) * -(-nx // tx) <= n_sm
    assert h == max(reach if opts.get("niter_solve", 3) else 0, e_v + 1)
    fields = 7 if opts.get("tv_solver") == "fgp" else 5
    sy, sx = ty + 2 * h, tx + 2 * h
    assert 4 * (fields * sy * sx + 2 * ty * tx + sy + sx + 192) <= t_fused.H100_SMEM_OPTIN
    cover = torch.zeros(shape, dtype=torch.int64)
    for by in range(-(-ny // ty)):
        for bx in range(-(-nx // tx)):
            cover[by * ty:(by + 1) * ty, bx * tx:(bx + 1) * tx] += 1
    assert bool((cover == 1).all())


def test_resident_route_at_512_not_2048_nor_wl1():
    """On the H100 (132 SMs, 227 KiB a CTA) every mode the deconvolution
    path runs (the k5-k7 models' TV, MC-TV, ME-TV) takes the resident route
    at 512^2 on 32 x 64 interiors; 2048^2 and the wl1 dual keep the launch
    sequence."""
    for k in (5, 6, 7):
        taps, oy = _taps(k), k - 1
        for mode in ("tv", "mctv", "metv"):
            plan = t_ulpda.ulpda_resident_plan((512, 512), taps, oy, oy, mode=mode)
            assert plan is not None and plan[:2] == (32, 64), (k, mode, plan)
            assert t_ulpda.ulpda_resident_plan((2048, 2048), taps, oy, oy, mode=mode) is None
        assert t_ulpda.ulpda_resident_plan((512, 512), taps, oy, oy, dual="wl1") is None
    taps = _taps(5)
    assert t_ulpda.ulpda_resident_plan((512, 512), taps, 4, 4, niter_solve=65) is None
    # the planner is asked on every call: computed once per shape and options
    assert (t_ulpda.ulpda_resident_plan((512, 512), taps, 4, 4)
            is t_ulpda.ulpda_resident_plan((512, 512), taps, 4, 4))


# (data term, dual, options): the chain axis in both orders, the nonconvex
# terms, the warm FGP envelope
CHAIN_CASES = {
    "tv_l21": ("tv", "l21", dict()),
    "tv_l21_gfirst": ("tv", "l21", dict(gfirst=True)),
    "mctv_l1": ("mctv", "l1", dict()),
    "metv_fgp_warm_gfirst": ("metv", "l21", dict(gfirst=True, env_warm=True,
                                                 tv_solver="fgp", niter_inner=4)),
}
CHAINS = 5


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_resident_chain_axis_equals_plain_version(terms, case):
    """The chain axis: 5 chains on the planner's chain-axis tiling for a
    card of 9 SMs and 60000 bytes of shared memory a CTA (3 or 4 tiles a
    chain, ragged in rows in TV and MC-TV; 2 or 3 chains a launch, launches
    in turn), held bit for bit to
    the plain version with the chain axis over STEPS noisy steps, every
    chain under its own key."""
    name, dual, opts = CHAIN_CASES[case]
    args, kw = _block_args(terms[name], dual, torch.float32, opts)
    x, py, px, xbar, atb, mean, m2, _, scal_f, scal_i = args
    x, py, px, xbar, mean, m2 = (torch.stack([a + 0.5 * c for c in range(CHAINS)])
                                 for a in (x, py, px, xbar, mean, m2))
    keys = chain_keys((7, 2), CHAINS)
    plan = t_ulpda.ulpda_resident_plan(
        (N, N), kw["taps"], kw["oy"], kw["ox"], mode=kw["mode"],
        niter_inner=kw["niter_inner"], dual=kw["dual"],
        tv_solver=kw.get("tv_solver", "chambolle"), n_chains=CHAINS, n_sm=9,
        smem_optin=60000)
    tiles = -(-N // plan[0]) * -(-N // plan[1])
    assert tiles > 1 and 1 < plan[3] < CHAINS, plan
    args = (x, py, px, xbar, atb, mean, m2, keys, scal_f, scal_i)
    want = t_ulpda.ulpda_block_update_ref(*args, n_steps=STEPS, **kw)
    got = _emulate_chains(*args, plan=plan, n_steps=STEPS, **kw)
    for field, g, w in zip(("x", "py", "px", "xbar", "mean", "m2"), got, want):
        assert torch.equal(g, w), (field, float((g - w).abs().max()))


@pytest.mark.parametrize("n_chains, want", [(1, (32, 64, 4, 1)), (2, (64, 64, 4, 2)),
                                            (8, (16, 16, 4, 8)), (64, (32, 64, 4, 64)),
                                            (200, (64, 64, 4, 132))])
def test_resident_plan_chains_per_launch(n_chains, want):
    """Kernel 2's chain rule on the H100: 512^2 for 1 and 2 chains, 64^2
    for 8, 64 and 200 (two launches of at most 132)."""
    shape = (512, 512) if n_chains <= 2 else (64, 64)
    assert t_ulpda.ulpda_resident_plan(shape, _taps(5), 4, 4, n_chains=n_chains) == want


def test_cuda_wrapper_refuses_cpu_without_counting(terms):
    """A CPU tensor raises in the CUDA wrapper; no launch or route is
    counted."""
    args, kw = _block_args(terms["tv"], "l21", torch.float32, {})
    wrapper = t_ulpda.ulpda_block_update_cuda
    before = (wrapper.launches, dict(wrapper.routes))
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(*args, n_steps=2, **kw)
    assert (wrapper.launches, wrapper.routes) == before
