"""Kernel 2's resident route on the CPU: a torch emulation of its tile
schedule held bit for bit to the plain version, and its host-side picker.

On the card the resident route runs a whole block call as one cooperative
launch: one CTA per 2-D tile of the image (interior ``ty x tx``, halo ``h``
from ``resident_plan``), every CTA resident at once, x and the warm duals
exchanged each step through parity buffers in device memory, one grid
barrier a step. A CUDA kernel has no CPU mode, and running its CTAs one
after another on the CPU (a g++ shim) never passes a grid barrier, so
``_emulate`` stands in: it runs the same schedule tile by tile in torch
ops, on the picker's own geometry. Each step every tile reads its tile of x
(and of the previous step's duals, with ``tv_warm``) with image-periodic
wrap from one parity buffer, computes the step on it, and publishes its
interior's x and final duals to the other buffer. Like the kernel, each TV
trip computes ``u`` and the dual only on the interior grown by ``niter -
trip``, the cone the interior's prox depends on; the emulation sets every
other pixel to NaN, so a read outside that cone reaches the interior as
NaN. A halo, cone or warm-dual bug makes it differ from
``myula_tv_block_update_ref``; with a correct schedule every interior pixel
takes the same operations on the same values, so the two agree bit for bit,
in f32 as in f64.
"""
import numpy as np
import pytest
import torch

from lmc_atomi_torch.core.random import chain_keys, normal_field
from lmc_atomi_torch.kernels import myula_fused as t_fused
from lmc_atomi_torch.kernels.myula_tiled import _halo_need
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
STEPS = 5  # odd: the last step ends in the other parity buffer


def _cone_prox(x, gamma, niter, tv_solver, tv_step, stencils, p0, grown):
    """``myula_fused._tv_prox`` / ``_tv_prox_fgp`` op for op, with the pixels
    outside the kernel's cone set to NaN after each pass: ``grown(e)`` is
    the mask of the interior grown by ``e``."""
    fwd_y, fwd_x, div = stencils
    nan = torch.tensor(float("nan"), dtype=x.dtype)

    def keep(a, e):
        return torch.where(grown(e), a, nan)

    xg = x / gamma
    py, px = (torch.zeros_like(x), torch.zeros_like(x)) if p0 is None else p0
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
    return x - gamma * div(py, px), (py, px)


def _lockstep(schedules):
    """Run the step generators of one cooperative launch's chains in
    lockstep (a grid barrier steps them together); their results."""
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
    """Kernel 2's resident schedule on one chain (see ``_schedule``)."""
    return _lockstep([_schedule(*args, **kwargs)])[0]


def _schedule(x, atbs, mean, m2, seed, scal_f, scal_i, qh=None, qn=None, *,
              plan, taps, oy, ox, n_steps, niter_tv=10, tv_step=0.25,
              with_noise=True, with_stats=True, tv_warm=False, quantiles=(),
              quantile_thin=1, tv_solver="chambolle", mode="tv", niter_inner=10,
              bufs=None):
    """Kernel 2's resident schedule on tiles ``plan = (ty, tx, h, ...)``,
    yielding after each step; ``bufs`` are the launch's device buffers of
    this chain, ``(xs, dv, ev)``: the x parity pair (x in the first) and the
    (y, x) dual planes of parity 0 and 1 of the TV prox and the envelope
    (fresh ones when None)."""
    ty, tx, h = plan[:3]
    ny, nx = x.shape
    (c_keep, c_grad, c_prox, noise_amp, sigma, tv_gamma, lamda, gamma_mc, _,
     c_env) = t_fused._update_coefs(scal_f)
    seed, chain = base_key(seed)
    rec = t_fused._BlockStats(scal_i, mean, m2, qh, qn, quantiles,
                              quantile_thin, with_stats)
    if bufs is None:
        bufs = ([x, torch.empty_like(x)],
                [torch.empty((2, ny, nx), dtype=x.dtype) for _ in range(2)],
                [torch.empty((2, ny, nx), dtype=x.dtype) for _ in range(2)])
    xs, dv, ev = bufs
    for i in range(n_steps):
        g = rec.step0 + i
        par = i % 2
        src, dst = xs[par], xs[1 - par]
        noise = normal_field(seed, chain, g, x.shape, x.dtype, x.device)
        for by in range(-(-ny // ty)):
            for bx in range(-(-nx // tx)):
                rows = torch.arange(by * ty - h, (by + 1) * ty + h) % ny
                cols = torch.arange(bx * tx - h, (bx + 1) * tx + h) % nx

                def tile(a):
                    return a[..., rows, :][..., cols]

                xt = tile(src)
                # forward-difference masks at the image's last row and column
                my = (rows != ny - 1).to(x.dtype)[:, None]
                mx = (cols != nx - 1).to(x.dtype)[None, :]
                stencils = _stencils(xt, (my, mx))

                # the interior, cut at the image's last row and column
                r0, c0 = by * ty, bx * tx
                r1, c1 = min(r0 + ty, ny), min(c0 + tx, nx)
                inner = (slice(h, h + r1 - r0), slice(h, h + c1 - c0))
                img = (slice(r0, r1), slice(c0, c1))
                ri, ci = torch.arange(len(rows))[:, None], torch.arange(len(cols))[None, :]

                def grown(e):
                    return ((ri >= h - e) & (ri < h + ty + e)
                            & (ci >= h - e) & (ci < h + tx + e))

                grad = sigma * t_fused._sep_gram(xt, taps, oy, ox)[inner] - atbs[img]
                if mode == "mctv":
                    clamp = t_fused._mctv_clamp(xt, gamma_mc, stencils)
                    nan = torch.tensor(float("nan"), dtype=x.dtype)
                    clamp = [torch.where(grown(1), a, nan) for a in clamp]
                    grad = grad + lamda * stencils[2](*clamp)[inner]
                elif mode == "metv":
                    e0 = tuple(tile(ev[1 - par])) if tv_warm and i > 0 else None
                    p_env, env = _cone_prox(xt, gamma_mc, niter_inner, tv_solver, tv_step,
                                            stencils, e0, grown)
                    grad = grad - c_env * (xt[inner] - p_env[inner])
                    for k in range(2):
                        ev[par][k][img] = env[k][inner]
                d0 = tuple(tile(dv[1 - par])) if tv_warm and i > 0 else None
                prox, dual = _cone_prox(xt, tv_gamma, niter_tv, tv_solver, tv_step,
                                        stencils, d0, grown)
                x_new = c_keep * xt[inner] - c_grad * grad + c_prox * prox[inner]
                if with_noise:
                    x_new = x_new + noise_amp * noise[img]
                dst[img] = x_new
                for k in range(2):
                    dv[par][k][img] = dual[k][inner]
        rec(dst.clone(), g)
        yield
    return (xs[n_steps % 2], *rec.result())


def _emulate_chains(x, atbs, mean, m2, keys, scal_f, scal_i, qh=None, qn=None, *,
                    plan, n_steps, **kw):
    """Kernel 2's resident route with a chain axis on ``plan = (ty, tx, h,
    G)``: the chains in groups of ``G``, one cooperative launch a group,
    stepping in lockstep, every field of a chain at its offset in the
    launch's device buffers as ``csrc/myula_block.cu`` lays them out (x and
    its parity buffer chain-major, the duals 8 planes a chain). The parity
    and dual buffers start as NaN, so a chain that reads outside its own
    fields, or before they are written, reaches its interior as NaN."""
    c, ny, nx = x.shape
    g = plan[3]
    xbuf, parity = x.clone(), torch.full_like(x, float("nan"))
    duals = torch.full((8 * c, ny, nx), float("nan"), dtype=x.dtype)
    env = torch.full_like(duals, float("nan"))
    out = []
    for c0 in range(0, c, g):
        out += _lockstep([_schedule(
            xbuf[z], atbs, None if mean is None else mean[z], None if m2 is None else m2[z],
            keys[z], scal_f, scal_i, None if qh is None else qh[z],
            None if qn is None else qn[z], plan=plan, n_steps=n_steps,
            bufs=([xbuf[z], parity[z]], [duals[8 * z + 2 * p:8 * z + 2 * p + 2] for p in (0, 1)],
                  [env[8 * z + 2 * p:8 * z + 2 * p + 2] for p in (0, 1)]), **kw)
            for z in range(c0, min(c0 + g, c))])
    return tuple(None if o[0] is None else torch.stack(o) for o in zip(*out))


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


# (data term, options): TV cold and warm Chambolle and FGP, MC-TV, ME-TV with
# the warm envelope (both solvers), CI markers
CASES = {
    "tv_cold10": ("tv", dict(niter_tv=10)),
    "tv_warm5": ("tv", dict(niter_tv=5, tv_warm=True)),
    "tv_fgp8": ("tv", dict(niter_tv=8, tv_solver="fgp")),
    "tv_fgp8_warm": ("tv", dict(niter_tv=8, tv_solver="fgp", tv_warm=True)),
    "mctv_cold10": ("mctv", dict(niter_tv=10)),
    "metv_warm4": ("metv", dict(niter_tv=4, tv_warm=True)),
    "metv_fgp5_warm": ("metv", dict(niter_tv=5, tv_solver="fgp", tv_warm=True)),
    "tv_cold10_ci95": ("tv", dict(niter_tv=10, quantiles=(0.025, 0.975),
                                  quantile_thin=2)),
}


def _block_args(l2, dtype, opts):
    """A mid-chain state (moments, and markers past their bootstrap) and the
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
@pytest.mark.parametrize("n_sm", [16, 12])
@pytest.mark.parametrize("case", list(CASES))
def test_resident_schedule_equals_plain_version(terms, case, n_sm, dtype):
    """The emulated resident schedule equals the plain version bit for bit
    over STEPS noisy steps, on the picker's tiles for a card of ``n_sm`` SMs
    (16: 16 x 16 interiors; 12: 16 x 24, ragged in columns)."""
    name, opts = CASES[case]
    args, kw = _block_args(terms[name], dtype, opts)
    plan = t_fused.resident_plan(
        (N, N), kw["taps"], kw["oy"], kw["ox"], niter_tv=opts["niter_tv"],
        tv_solver=opts.get("tv_solver", "chambolle"), mode=kw["mode"],
        niter_inner=kw["niter_inner"], n_steps=STEPS, n_sm=n_sm)
    assert plan is not None and plan[:2] == {16: (16, 16), 12: (16, 24)}[n_sm]
    want = t_fused.myula_tv_block_update_ref(*args, n_steps=STEPS, **kw)
    got = _emulate(*args, plan=plan, n_steps=STEPS, **kw)
    for field, g, w in zip(("x", "mean", "m2", "qh", "qn"), got, want):
        if w is None:
            assert g is None, field
            continue
        assert g.dtype == dtype and torch.equal(g, w), (
            field, float((g - w).abs().max()))


def test_resident_one_step_without_stats(terms):
    """The deconvolution path's call: one step, no statistics, noise on."""
    args, kw = _block_args(terms["metv"], torch.float32, dict(niter_tv=10))
    args = args[:2] + (None, None) + args[4:7]
    kw.update(n_steps=1, with_stats=False)
    plan = t_fused.resident_plan((N, N), kw["taps"], kw["oy"], kw["ox"], mode="metv",
                                 niter_inner=kw["niter_inner"], n_sm=16)
    want = t_fused.myula_tv_block_update_ref(*args, **kw)
    got = _emulate(*args, plan=plan, **kw)
    assert torch.equal(got[0], want[0]) and got[1] is None and got[2] is None


def _taps(k):
    return ((tuple([1.0] * (2 * k - 1)), tuple([1.0] * (2 * k - 1))),)


@pytest.mark.parametrize("shape, n_sm", [((64, 64), 16), ((64, 64), 12), ((56, 72), 9),
                                         ((512, 512), 132), ((300, 200), 132)])
@pytest.mark.parametrize("mode, opts", [("tv", dict(niter_tv=10)),
                                        ("tv", dict(niter_tv=8, tv_solver="fgp")),
                                        ("metv", dict(niter_tv=5, niter_inner=12)),
                                        ("mctv", dict(niter_tv=1))])
def test_resident_plan_tiles_and_halo(shape, n_sm, mode, opts):
    """Every pixel lies in exactly one interior, the tiles number at most
    ``n_sm``, and the halo is at least kernel 6's (the TV prox's niter + 1,
    the gram's reach, MC-TV's 2, the envelope's niter_inner + 1)."""
    taps, oy = _taps(5), 4  # a 5x5 blur's autocorrelation: 9 taps, offset 4
    plan = t_fused.resident_plan(shape, taps, oy, oy, mode=mode, n_sm=n_sm, **opts)
    assert plan is not None
    ty, tx, h, g = plan
    assert g == 1
    ny, nx = shape
    assert ty % 8 == 0 and tx % 8 == 0
    assert -(-ny // ty) * -(-nx // tx) <= n_sm
    assert h >= _halo_need(opts["niter_tv"], oy, mode, opts.get("niter_inner", 10))
    assert h >= max(oy, 2 if mode == "mctv" else 0)
    cover = torch.zeros(shape, dtype=torch.int64)
    for by in range(-(-ny // ty)):
        for bx in range(-(-nx // tx)):
            cover[by * ty:(by + 1) * ty, bx * tx:(bx + 1) * tx] += 1
    assert bool((cover == 1).all())


def test_resident_route_at_512_not_2048():
    """On the H100 (132 SMs, 227 KiB a CTA): every main-path and
    deconvolution mode takes the resident route at 512^2, on 32 x 64
    interiors; 2048^2 keeps the launch sequence."""
    taps = _taps(5)
    modes = [dict(niter_tv=8, tv_solver="fgp"), dict(niter_tv=10), dict(niter_tv=5),
             dict(niter_tv=10, mode="mctv"), dict(niter_tv=10, mode="metv"),
             dict(niter_tv=8, tv_solver="fgp", mode="metv")]
    for n_steps in (500, 1):
        for kw in modes:
            plan = t_fused.resident_plan((512, 512), taps, 4, 4, n_steps=n_steps, **kw)
            assert plan is not None and plan[:2] == (32, 64), kw
            assert t_fused.resident_plan((2048, 2048), taps, 4, 4, n_steps=n_steps,
                                         **kw) is None
    assert t_fused.resident_plan((512, 512), taps, 4, 4, n_steps=0) is None
    assert t_fused.resident_plan((512, 512), taps, 4, 4, niter_tv=65) is None


# (data term, options): the chain axis in the modes of multichain_deblur
# and the farm, warm duals and CI markers
CHAIN_CASES = {
    "tv_cold10": ("tv", dict(niter_tv=10)),
    "tv_fgp8_warm": ("tv", dict(niter_tv=8, tv_solver="fgp", tv_warm=True)),
    "metv_warm4": ("metv", dict(niter_tv=4, tv_warm=True)),
    "tv_cold10_ci95": ("tv", dict(niter_tv=10, quantiles=(0.025, 0.975),
                                  quantile_thin=2)),
}
CHAINS = 5


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_resident_chain_axis_equals_plain_version(terms, case):
    """The chain axis: 5 chains on the planner's chain-axis tiling for a
    card of 16 SMs and 60000 bytes of shared memory a CTA (8 tiles of 16 x
    32 a chain, 2 chains a launch, 3 launches in turn), held bit for bit to
    the plain version with the chain axis over STEPS noisy steps, every
    chain under its own key."""
    name, opts = CHAIN_CASES[case]
    args, kw = _block_args(terms[name], torch.float32, opts)
    x, atbs, mean, m2, _, scal_f, scal_i, qh, qn = args
    keys = chain_keys((7, 2), CHAINS)
    x, mean, m2 = (torch.stack([a + 3.0 * c for c in range(CHAINS)]) for a in (x, mean, m2))
    qh, qn = (None if a is None else torch.stack([a] * CHAINS) for a in (qh, qn))
    plan = t_fused.resident_plan(
        (N, N), kw["taps"], kw["oy"], kw["ox"], niter_tv=opts["niter_tv"],
        tv_solver=opts.get("tv_solver", "chambolle"), mode=kw["mode"],
        niter_inner=kw["niter_inner"], n_steps=STEPS, n_chains=CHAINS, n_sm=16,
        smem_optin=60000)
    assert plan[:2] == (16, 32) and plan[3] == 2, plan
    args = (x, atbs, mean, m2, keys, scal_f, scal_i, qh, qn)
    want = t_fused.myula_tv_block_update_ref(*args, n_steps=STEPS, **kw)
    got = _emulate_chains(*args, plan=plan, n_steps=STEPS, **kw)
    for field, g, w in zip(("x", "mean", "m2", "qh", "qn"), got, want):
        if w is None:
            assert g is None, field
            continue
        assert torch.equal(g, w), (field, float((g - w).abs().max()))


@pytest.mark.parametrize("n_chains, n_sm, want", [
    (1, 132, (32, 64, 11, 1)), (2, 132, (64, 64, 11, 2)), (8, 132, (16, 16, 11, 8)),
    (64, 132, (32, 64, 11, 64)), (200, 132, (64, 64, 11, 132)), (5, 40, None)])
def test_resident_plan_chains_per_launch(n_chains, n_sm, want):
    """The chain axis's cost rule, launches in turn x tile area: on the H100
    one 512^2 chain keeps its 32 x 64 tiles, two take 64 x 64 tiles in one
    launch; at 64^2 8 chains take 16 x 16 tiles, 64 chains 32 x 64 tiles,
    200 chains whole-image tiles in two launches of at most 132; the plan
    equals a brute-force search of the rule."""
    taps = _taps(5)
    shape = (512, 512) if n_chains <= 2 else (64, 64)
    plan = t_fused.resident_plan(shape, taps, 4, 4, n_chains=n_chains, n_sm=n_sm)
    if want is not None:
        assert plan == want
    ty, tx, h, g = plan
    tiles = -(-shape[0] // ty) * -(-shape[1] // tx)
    assert g == min(n_chains, n_sm // tiles) and g * tiles <= n_sm
    best = min(-(-n_chains // min(n_chains, n_sm // (-(-shape[0] // a) * -(-shape[1] // b))))
               * (a + 2 * h) * (b + 2 * h)
               for a in range(8, shape[0] + 8, 8) for b in range(8, shape[1] + 8, 8)
               if -(-shape[0] // a) * -(-shape[1] // b) <= n_sm
               and 4 * (5 * (a + 2 * h) * (b + 2 * h) + 3 * a * b + a + b + 4 * h) + 256
               <= t_fused.H100_SMEM_OPTIN)
    assert -(-n_chains // g) * (ty + 2 * h) * (tx + 2 * h) == best


def test_cuda_wrapper_refuses_cpu_without_counting(terms):
    """A CPU tensor raises in the CUDA wrapper; no launch or route is
    counted."""
    args, kw = _block_args(terms["tv"], torch.float32, dict(niter_tv=10))
    wrapper = t_fused.myula_tv_block_update_cuda
    before = (wrapper.launches, dict(wrapper.routes))
    with pytest.raises(ValueError, match="CUDA tensors"):
        wrapper(*args, n_steps=2, **kw)
    assert (wrapper.launches, wrapper.routes) == before
