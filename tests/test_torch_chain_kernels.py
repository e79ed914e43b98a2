"""Kernels 4-7 with a chain axis, on the CPU: the plain versions
(``wavelet_block_update_ref``, ``ulpda_wavelet_block_update_ref``,
``myula_tv_tiled_update_ref``, ``ulpda_tv_tiled_update_ref``) on ``(C, ny,
nx)`` fields against their per-chain calls (noise on, float32 as on the
card, bit for bit) and against the JAX package's ``jax.vmap`` of each Pallas
kernel in interpret mode (noise off, float64, one block); the planners'
chain counts (``wavelet_plan``'s groups, ``tiled_plan`` and
``ulpda_tiled_plan``'s waves over every chain's tiles); the CUDA wrappers'
refusal of CPU tensors with a chain axis, and of keys without a shared
seed. The card's side (each chain of a batched kernel call against the plain
chain axis and its one-chain call) is ``chip_smoke.py``'s."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.core.random import chain_keys
from lmc_atomi_torch.kernels import myula_fused as t_myula
from lmc_atomi_torch.kernels import myula_tiled as t_tiled
from lmc_atomi_torch.kernels import ulpda_fused as t_ulpda
from lmc_atomi_torch.kernels import ulpda_tiled as t_utiled
from lmc_atomi_torch.kernels import wavelet_fused as t_wf
from lmc_atomi_torch.ops import functionals as t_fn
from lmc_atomi_tpu.kernels import myula_fused as j_fused
from lmc_atomi_tpu.kernels import myula_tiled as j_tiled
from lmc_atomi_tpu.kernels import ulpda_fused as j_ulpda
from lmc_atomi_tpu.kernels import ulpda_tiled as j_utiled
from lmc_atomi_tpu.kernels import wavelet_fused as j_wf
from lmc_atomi_tpu.ops.functionals import L21Norm, L2Data
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, Gradient2D, uniform_kernel
from lmc_atomi_tpu.utils.images import phantom

torch.set_num_threads(2)

C = 3  # chains a call
NW = 16  # kernels 4 and 5's side (the single-chain JAX parity tests' size)
NT = 32  # kernels 6 and 7's side: four bands of 8 rows, halo 8
SIG = 0.75
GAMMA = SIG**2
# f64 on both sides, the same operations in the same order: the wavelet
# blocks agree to a few ulp (tests/test_torch_wavelet.py's gate)
TOL = 1e-12
# the tiled blocks: the JAX tiled tests' f64 gates (tests/test_torch_tiled.py)
POS_TOL, M2_TOL, Y_TOL = 1e-11, 1e-9, 1e-12
KEYS = chain_keys((5, 1), C)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)


def _t(*arrays, dtype=torch.float64):
    return [None if a is None else torch.from_numpy(np.array(a)).to(dtype) for a in arrays]


def _jnp(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _equal_per_chain(got, one, names):
    """Chain ``c`` of ``got`` (a chain-axis call) against ``one(c)``, the
    one-chain call under key ``c``, bit for bit."""
    for c in range(C):
        for name, g, w in zip(names, got, one(c)):
            if w is None:
                assert g is None, name
                continue
            assert torch.equal(g[c], w), (name, c)


# --- kernels 4 and 5 -------------------------------------------------------------

def _wavelet_state(seed, n_q):
    """C chains' mid-chain state at NW^2 and the shared observation and mask;
    the markers past their bootstrap with n_q quantiles."""
    rng = np.random.default_rng(seed)
    img = phantom(NW, np.float64) / 255.0
    mask = (rng.uniform(size=(NW, NW)) > 0.4).astype(np.float64)
    y = mask * img + 0.1 * mask * rng.normal(size=(NW, NW))
    x = img + 0.2 * rng.normal(size=(C, NW, NW))
    mean = x + 0.05 * rng.normal(size=(C, NW, NW))
    m2 = rng.uniform(0.1, 1.0, size=(C, NW, NW))
    qh = qn = None
    if n_q:
        qh = np.sort(x[:, None, None] + 0.3 * rng.normal(size=(C, n_q, 5, NW, NW)), axis=2)
        qh = qh.reshape(C, 5 * n_q, NW, NW)
        qn = np.tile(np.array([5.0, 10.0, 15.0])[:, None, None], (C, n_q, NW, NW))
    c = np.clip(rng.normal(size=(C, NW, NW)), -0.4, 0.4)
    xbar = x + 0.1 * rng.normal(size=(C, NW, NW))
    return x, y, mask, mean, m2, qh, qn, c, xbar


# (taps, quantiles, thin, scal_i): moments with the burn-in inside the
# block; P^2 past the bootstrap (c_prev >= 18)
WV_RUNS = [(2, (), 1, (3, 5, 1)), (4, (), 1, (3, 5, 1)), (8, (0.25,), 1, (20, 2, 18)),
           (2, (0.1, 0.9), 1, (20, 2, 18))]
MYULA_F = (0.2 * 0.01, 0.01, 100.0, 0.01 * 5.0)  # tau, gamma, sig, thr
ULPDA_F = (0.95 / 100.0, 1.0, 1.0, None, 100.0, 0.4)  # tau, mu, theta, noise, sig, g_sigma


@pytest.mark.parametrize("taps, qs, thin, scal_i", WV_RUNS)
def test_wavelet_chain_axis_equals_per_chain_calls(taps, qs, thin, scal_i):
    """Noise on, float32: chain ``c`` of kernel 4's plain version on the
    chain axis is its one-chain call under ``KEYS[c]``, bit for bit."""
    x, y, mask, mean, m2, qh, qn, _, _ = _wavelet_state(taps, len(qs))
    x, y, mask, mean, m2, qh, qn = _t(x, y, mask, mean, m2, qh, qn, dtype=torch.float32)
    kw = dict(levels=2, taps=taps, n_steps=6, quantiles=qs, quantile_thin=thin)
    scal_f = MYULA_F + (1.0,)
    got = t_wf.wavelet_block_update(x, y, mask, mean, m2, KEYS, scal_f, scal_i, qh, qn, **kw)
    _equal_per_chain(got, lambda c: t_wf.wavelet_block_update(
        x[c], y, mask, mean[c], m2[c], KEYS[c], scal_f, scal_i,
        *(None if q is None else q[c] for q in (qh, qn)), **kw),
        ("x", "mean", "m2", "qh", "qn"))


@pytest.mark.parametrize("gfirst", [False, True])
@pytest.mark.parametrize("taps", [2, 4])
def test_ulpda_wavelet_chain_axis_equals_per_chain_calls(taps, gfirst):
    """Noise on, float32: kernel 5's plain version on the chain axis, both
    orders, CI markers: chain ``c`` is its one-chain call, the dual and xbar
    too."""
    x, y, mask, mean, m2, qh, qn, cd, xbar = _wavelet_state(10 + taps, 2)
    x, y, mask, mean, m2, qh, qn, cd, xbar = _t(x, y, mask, mean, m2, qh, qn, cd, xbar,
                                                dtype=torch.float32)
    kw = dict(levels=2, taps=taps, n_steps=6, gfirst=gfirst, quantiles=(0.1, 0.9))
    scal_f = ULPDA_F[:3] + (1.0,) + ULPDA_F[4:]
    scal_i = (20, 2, 18)
    got = t_wf.ulpda_wavelet_block_update(x, cd, xbar, y, mask, mean, m2, KEYS, scal_f,
                                          scal_i, qh, qn, **kw)
    _equal_per_chain(got, lambda c: t_wf.ulpda_wavelet_block_update(
        x[c], cd[c], xbar[c], y, mask, mean[c], m2[c], KEYS[c], scal_f, scal_i, qh[c],
        qn[c], **kw), ("x", "c", "xbar", "mean", "m2", "qh", "qn"))


def _seeds():
    """The JAX kernels' per-chain int32 seed pairs (noise off: unread)."""
    return jnp.asarray([[3, c] for c in range(C)], jnp.int32)


@pytest.mark.parametrize("taps, qs, thin, scal_i", WV_RUNS)
def test_wavelet_chain_axis_matches_jax_vmap(taps, qs, thin, scal_i):
    """Noise off, float64, one 6-step block: kernel 4's plain version on the
    chain axis against ``jax.vmap`` of the JAX kernel (interpret mode), the
    observation and mask shared."""
    x, y, mask, mean, m2, qh, qn, _, _ = _wavelet_state(taps, len(qs))
    kw = dict(levels=2, taps=taps, n_steps=6, with_noise=False, quantiles=qs,
              quantile_thin=thin)
    scal_f = MYULA_F + (0.0,)
    q_axis = 0 if qs else None
    want = jax.vmap(
        lambda xc, mc, m2c, sc, qhc, qnc: j_wf.wavelet_block_update(
            xc, jnp.asarray(y), jnp.asarray(mask), mc, m2c, sc, jnp.asarray(scal_f),
            jnp.asarray(scal_i, jnp.int32), qhc, qnc, interpret=True, **kw),
        in_axes=(0, 0, 0, 0, q_axis, q_axis))(*_jnp(x, mean, m2), _seeds(), *_jnp(qh, qn))
    got = t_wf.wavelet_block_update(*_t(x, y, mask, mean, m2), KEYS, scal_f, scal_i,
                                    *_t(qh, qn), **kw)
    for name, g, w in zip(("x", "mean", "m2", "qh", "qn"), got, want):
        if qs or name in ("x", "mean", "m2"):
            _close(g, w, TOL, name)


@pytest.mark.parametrize("gfirst", [False, True])
@pytest.mark.parametrize("taps", [2, 8])
def test_ulpda_wavelet_chain_axis_matches_jax_vmap(taps, gfirst):
    """Noise off, float64, one 6-step block, both orders: kernel 5's plain
    version on the chain axis against ``jax.vmap`` of the JAX kernel."""
    x, y, mask, mean, m2, qh, qn, cd, xbar = _wavelet_state(10 + taps, 1)
    kw = dict(levels=2, taps=taps, n_steps=6, gfirst=gfirst, with_noise=False,
              quantiles=(0.25,))
    scal_f = ULPDA_F[:3] + (0.0,) + ULPDA_F[4:]
    scal_i = (20, 2, 18)
    want = jax.vmap(
        lambda xc, cc, xbc, mc, m2c, sc, qhc, qnc: j_wf.ulpda_wavelet_block_update(
            xc, cc, xbc, jnp.asarray(y), jnp.asarray(mask), mc, m2c, sc,
            jnp.asarray(scal_f), jnp.asarray(scal_i, jnp.int32), qhc, qnc, interpret=True,
            **kw))(*_jnp(x, cd, xbar, mean, m2), _seeds(), *_jnp(qh, qn))
    got = t_wf.ulpda_wavelet_block_update(*_t(x, cd, xbar, y, mask, mean, m2), KEYS, scal_f,
                                          scal_i, *_t(qh, qn), **kw)
    for name, g, w in zip(("x", "c", "xbar", "mean", "m2", "qh", "qn"), got, want):
        _close(g, w, TOL, name)


# --- kernels 6 and 7 -------------------------------------------------------------

@pytest.fixture(scope="module")
def deblur():
    """The NT^2 phantom deblurring posterior in both packages, and C
    chains' mid-chain state with P^2 markers past their bootstrap."""
    img = phantom(NT, np.float64)
    jb = CirculantBlur2D.from_kernel((NT, NT), uniform_kernel(5, jnp.float64))
    rng = np.random.default_rng(0)
    y = np.asarray(jb.matvec(jnp.asarray(img))) + SIG * rng.normal(size=(NT, NT))
    jl2 = L2Data.create(op=jb, b=jnp.asarray(y), sigma=1 / SIG**2)
    tb = interop.blur_from_numpy(np.asarray(jb.eigs_re), np.asarray(jb.eigs_im),
                                 np.asarray(jb.h), np.asarray(jb.hh), jb.offset)
    tl2 = interop.l2data_from_numpy(y, 1 / SIG**2, tb)
    x, mean = rng.normal(size=(2, C, NT, NT)) * 20 + 100
    m2 = rng.uniform(1, 5, size=(C, NT, NT)) * 30
    qh = np.sort(rng.normal(size=(C, 5, NT, NT)) * 10 + 100, axis=1)
    qn = np.tile(np.array([3.0, 6.0, 9.0])[:, None, None], (C, 1, NT, NT))
    # a feasible l21 dual of radius 0.3, zero where the forward differences
    # are (py on the last row, px on the last column), as a chain leaves it
    py, px = rng.normal(size=(2, C, NT, NT)) * 0.1
    py[:, -1, :] = 0.0
    px[:, :, -1] = 0.0
    scale = np.minimum(1.0, 0.3 / np.maximum(np.hypot(py, px), 1e-12))
    py, px = py * scale, px * scale
    xp = x + rng.normal(size=(C, NT, NT))
    return jl2, tl2, dict(x=x, mean=mean, m2=m2, qh=qh, qn=qn, py=py, px=px, xp=xp)


TILED_KW = dict(n_steps=6, band=8, halo=8, quantiles=(0.25,), quantile_thin=2)
# the first recorded step (g = 31) has 13 observations before it, past the
# marker positions (3, 6, 9): a consistent P^2 state
TILED_I = (30, 5, 7)


def _myula_tiled_args(jl2, tl2):
    taps, (oy, ox), atbs = j_fused._fused_params(jl2, 0.3, 0.2 * GAMMA, GAMMA, 3)
    t_atbs = t_myula._fused_params(tl2)[2]
    return dict(taps=taps, oy=oy, ox=ox, niter_tv=3, **TILED_KW), atbs, t_atbs


def test_tiled_chain_axis_equals_per_chain_calls(deblur):
    """Noise on, float32: chain ``c`` of kernel 6's plain version on the
    chain axis (FGP, P^2 thinned by 2) is its one-chain call."""
    jl2, tl2, s = deblur
    kw, _, atbs = _myula_tiled_args(jl2, tl2)
    kw.update(tv_solver="fgp")
    f = dict(zip(s, _t(*s.values(), dtype=torch.float32)))
    atbs = atbs.float()
    scal_f = (0.2 * GAMMA, GAMMA, 0.3 * GAMMA, 1.0, 1 / SIG**2)
    got = t_tiled.myula_tv_tiled_update(f["x"], atbs, f["mean"], f["m2"], KEYS, scal_f,
                                        TILED_I, f["qh"], f["qn"], **kw)
    _equal_per_chain(got, lambda c: t_tiled.myula_tv_tiled_update(
        f["x"][c], atbs, f["mean"][c], f["m2"][c], KEYS[c], scal_f, TILED_I, f["qh"][c],
        f["qn"][c], **kw), ("x", "mean", "m2", "qh", "qn"))


def test_tiled_chain_axis_matches_jax_vmap(deblur):
    """Noise off, float64, one 6-step block from a mid-chain state: kernel
    6's plain version on the chain axis against ``jax.vmap`` of the JAX
    tiled kernel (interpret mode), ``atbs`` shared."""
    jl2, tl2, s = deblur
    kw, j_atbs, t_atbs = _myula_tiled_args(jl2, tl2)
    scal_f = (0.2 * GAMMA, GAMMA, 0.3 * GAMMA, 0.0, 1 / SIG**2)
    want = jax.vmap(lambda xc, mc, m2c, sc, qhc, qnc: j_tiled.myula_tv_tiled_update(
        xc, j_atbs, mc, m2c, sc, jnp.asarray(scal_f + (0.0, 1.0)),
        jnp.asarray(TILED_I, jnp.int32), qhc, qnc, with_noise=False, interpret=True, **kw))(
        *_jnp(s["x"], s["mean"], s["m2"]), _seeds(), *_jnp(s["qh"], s["qn"]))
    got = t_tiled.myula_tv_tiled_update(*_t(s["x"]), t_atbs, *_t(s["mean"], s["m2"]), KEYS,
                                        scal_f, TILED_I, *_t(s["qh"], s["qn"]),
                                        with_noise=False, **kw)
    for name, g, w, tol in zip(("x", "mean", "m2", "qh"), got, want,
                               (POS_TOL, POS_TOL, M2_TOL, M2_TOL)):
        _close(g, w, tol, name)
    np.testing.assert_array_equal(_np(got[4]), np.asarray(want[4]))


def _ulpda_tiled_args(jl2, tl2):
    jsetup = j_ulpda._ulpda_setup(jl2, L21Norm(sigma=0.3), Gradient2D(), 0.95 * GAMMA, 1.0)
    taps, (oy, ox), atb, _, _, _, _, _, lam, _ = jsetup
    t_atb = t_ulpda._ulpda_setup(tl2, t_fn.L21Norm(sigma=0.3),
                                 interop.gradient_from_numpy())[2]
    kw = dict(taps=taps, oy=oy, ox=ox, lam=lam, niter_solve=1, **TILED_KW)
    return kw, atb, t_atb


@pytest.mark.parametrize("gfirst", [False, True])
def test_ulpda_tiled_chain_axis_equals_per_chain_calls(deblur, gfirst):
    """Noise on, float32: chain ``c`` of kernel 7's plain version on the
    chain axis is its one-chain call (x, the parity partner, the dual, the
    moments and the markers)."""
    jl2, tl2, s = deblur
    kw, _, atb = _ulpda_tiled_args(jl2, tl2)
    f = dict(zip(s, _t(*s.values(), dtype=torch.float32)))
    atb = atb.float()
    scal_f = (0.95 * GAMMA, 1.0, 1.0, 1.0, 1 / SIG**2, 0.3)
    names = ("x", "xp", "py", "px", "mean", "m2", "qh", "qn")
    got = t_utiled.ulpda_tv_tiled_update(
        f["x"], f["xp"], f["py"], f["px"], atb, f["mean"], f["m2"], KEYS, scal_f, TILED_I,
        f["qh"], f["qn"], gfirst=gfirst, **kw)
    _equal_per_chain(got, lambda c: t_utiled.ulpda_tv_tiled_update(
        f["x"][c], f["xp"][c], f["py"][c], f["px"][c], atb, f["mean"][c], f["m2"][c],
        KEYS[c], scal_f, TILED_I, f["qh"][c], f["qn"][c], gfirst=gfirst, **kw), names)


@pytest.mark.parametrize("gfirst", [False, True])
def test_ulpda_tiled_chain_axis_matches_jax_vmap(deblur, gfirst):
    """Noise off, float64, one 2-step block (one parity pair: the JAX tiled
    kernel extrapolates as ``(1 + theta) x - theta x_old`` where the port
    takes kernel 3's form, which parts in the dual past 1e-12 by step 4,
    ``tests/test_torch_tiled.py``): kernel 7's plain version on the chain
    axis against ``jax.vmap`` of the JAX kernel, ``atb`` shared."""
    jl2, tl2, s = deblur
    kw, j_atb, t_atb = _ulpda_tiled_args(jl2, tl2)
    kw.update(n_steps=2)
    scal_f = (0.95 * GAMMA, 1.0, 1.0, 0.0, 1 / SIG**2, 0.3)
    fields = ("x", "xp", "py", "px")
    want = jax.vmap(lambda xc, xpc, pyc, pxc, mc, m2c, sc, qhc, qnc:
                    j_utiled.ulpda_tv_tiled_update(
                        xc, xpc, pyc, pxc, j_atb, mc, m2c, sc,
                        jnp.asarray(scal_f + (0.0, 1.0, 0.0)), jnp.asarray(TILED_I, jnp.int32),
                        qhc, qnc, gfirst=gfirst, with_noise=False, interpret=True, **kw))(
        *_jnp(*(s[k] for k in fields), s["mean"], s["m2"]), _seeds(),
        *_jnp(s["qh"], s["qn"]))
    got = t_utiled.ulpda_tv_tiled_update(
        *_t(*(s[k] for k in fields)), t_atb, *_t(s["mean"], s["m2"]), KEYS, scal_f, TILED_I,
        *_t(s["qh"], s["qn"]), gfirst=gfirst, with_noise=False, **kw)
    for name, g, w, tol in zip(fields + ("mean", "m2"), got, want,
                               (POS_TOL, POS_TOL, Y_TOL, Y_TOL, POS_TOL, M2_TOL)):
        _close(g, w, tol, name)


# --- the planners ----------------------------------------------------------------

@pytest.mark.parametrize("n_sm", [16, 132])
@pytest.mark.parametrize("n_chains", [1, 8, 64, 200])
@pytest.mark.parametrize("shape, taps, levels", [((64, 64), 4, 3), ((64, 64), 8, 3),
                                                 ((512, 512), 4, 3), ((96, 160), 8, 2)])
def test_wavelet_plan_groups_resident_chains(shape, taps, levels, n_chains, n_sm):
    """The resident route's tile for ``n_chains`` chains against a scan of
    every tiling (whole ``2^levels`` tiles dividing the image, at most
    ``_RS_MAX_PIXELS`` pixels and ``n_sm`` tiles): the least launches in
    turn x pixel rounds a thread, then fewer launches, the least area,
    perimeter, the wider; its groups are ``chains_per_launch``'s."""
    t = 1 << levels
    best = None
    for ty in range(t, shape[0] + 1, t):
        for tx in range(t, shape[1] + 1, t):
            count = (shape[0] // ty) * (shape[1] // tx)
            if (shape[0] % ty or shape[1] % tx or ty * tx > t_wf._RS_MAX_PIXELS
                    or count > n_sm):
                continue
            g = min(n_chains, n_sm // count)
            launches = -(-n_chains // g)
            key = (launches * -(-ty * tx // 512), launches, ty * tx, ty + tx, -tx)
            if best is None or key < best[0]:
                best = (key, (ty, tx), (g, launches))
    plan = t_wf.wavelet_plan(shape, taps, levels, n_sm, n_chains)
    if best is None:  # no tiling fits n_sm SMs: the per-level launches
        assert plan == (levels, "passes", (0, 0), (n_chains, 1))
        return
    assert plan == (levels, "resident", best[1], best[2])
    count = (shape[0] // plan[2][0]) * (shape[1] // plan[2][1])
    assert plan[3] == t_myula.chains_per_launch(count, n_chains, n_sm)
    assert plan[3][0] * count <= n_sm
    if n_chains == 1:  # one chain: the least area, as before the chain axis
        assert plan[2] == t_wf.resident_tile(shape, levels, n_sm)


@pytest.mark.parametrize("n_chains", [1, 8, 200])
@pytest.mark.parametrize("taps, levels, route", [(2, 3, "warp"), (2, 5, "tile"),
                                                 (2, 6, "passes")])
def test_wavelet_plan_haar_routes_carry_every_chain(taps, levels, route, n_chains):
    """Haar's warp, tile and per-level routes carry every chain in each
    launch (grid layers): one group of ``n_chains``, one launch in turn;
    the chains do not change the route or its geometry."""
    plan = t_wf.wavelet_plan((64, 64), taps, levels, 132, n_chains)
    assert plan[1] == route and plan[3] == (n_chains, 1)
    assert plan[:3] == t_wf.wavelet_plan((64, 64), taps, levels)[:3]


def _brute_tiled(shape, h, fields, work, n_chains, n_sm=132, smem=232448):
    """The least cost ``(ty, tx, threads)`` of a tiled step of ``n_chains``
    chains: waves of every chain's tiles over the SMs x CTAs an SM x one
    CTA's cone ``work(ty, tx)``, ties to fewer threads, smaller ty, tx."""
    best = None
    for threads in (512, 1024):
        per_sm = 1024 // threads
        for ty in range(8, shape[0] + 8, 8):
            for tx in range(8, shape[1] + 8, 8):
                sy, sx = ty + 2 * h, tx + 2 * h
                cta = 4 * (fields(sy, sx, ty, tx)) + 4 * (sy + sx)
                if cta > smem or per_sm * (cta + 1024) > smem + 1024:
                    continue
                tiles = -(-shape[0] // ty) * -(-shape[1] // tx)
                waves = -(-tiles * n_chains // (n_sm * per_sm))
                key = (waves * per_sm * work(ty, tx), threads, ty, tx)
                if best is None or key < best:
                    best = key
    return best[2], best[3], best[1]


@pytest.mark.parametrize("n_chains", [1, 4, 64])
@pytest.mark.parametrize("n", [256, 2048])
def test_tiled_plans_count_every_chain(n, n_chains):
    """``tiled_plan`` and ``ulpda_tiled_plan`` for ``n_chains`` chains (one
    launch a step carrying every chain's tiles) against an independent
    scan whose waves count every chain's tiles (5 x 5 blur, cold-10 TV and
    3 Chebyshev sweeps); one chain keeps the one-chain pick."""
    taps = ((tuple([1.0] * 9), tuple([1.0] * 9)),)
    h6 = t_myula._tile_halo(taps, 4, 4, 10, "tv", 10)
    plan6 = t_tiled.tiled_plan((n, n), taps, 4, 4, n_chains=n_chains)
    want6 = _brute_tiled((n, n), h6, lambda sy, sx, ty, tx: 4 * sy * sx + ty * tx + 64,
                         lambda ty, tx: t_tiled._tile_work(ty, tx, h6, 4, 1, 10, "tv", 10),
                         n_chains)
    assert plan6[:4] == (want6[0], want6[1], h6, want6[2])
    h7 = t_ulpda._ulpda_halo(taps, 4, 4, 3, "tv", 10)
    plan7 = t_utiled.ulpda_tiled_plan((n, n), taps, 4, 4, n_chains=n_chains)
    want7 = _brute_tiled((n, n), h7, lambda sy, sx, ty, tx: 5 * sy * sx + 128,
                         lambda ty, tx: t_utiled._ulpda_tile_work(ty, tx, h7, 4, 4, 1, 3,
                                                                  "tv", 10), n_chains)
    assert plan7[:4] == (want7[0], want7[1], h7, want7[2])
    if n_chains == 1:
        assert plan6 == t_tiled.tiled_plan((n, n), taps, 4, 4)
        assert plan7 == t_utiled.ulpda_tiled_plan((n, n), taps, 4, 4)


# --- the wrappers' refusals ------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_chain_axis(deblur):
    """Kernels 4-7's CUDA wrappers raise on CPU tensors with a chain axis
    (the plain versions take them), counting no launch."""
    _, tl2, _ = deblur
    x = torch.zeros((2, NT, NT), dtype=torch.float32)
    one = torch.zeros((NT, NT), dtype=torch.float32)
    keys = chain_keys(0, 2)
    taps, (oy, ox), _ = t_myula._fused_params(tl2)
    wrappers = (t_wf.wavelet_block_update_cuda, t_wf.ulpda_wavelet_block_update_cuda,
                t_tiled.myula_tv_tiled_update_cuda, t_utiled.ulpda_tv_tiled_update_cuda)
    before = [w.launches for w in wrappers]
    calls = [
        lambda: wrappers[0](x, one, one, x, x, keys, MYULA_F + (1.0,), (0, 0, 0)),
        lambda: wrappers[1](x, x, x, one, one, x, x, keys, (1e-3, 1.0, 1.0, 1.0, 1.0, 0.1),
                            (0, 0, 0)),
        lambda: wrappers[2](x, one, x, x, keys, (0.1, 0.5, 0.1, 1.0, 1.0), (0, 0, 0),
                            taps=taps, oy=oy, ox=ox, n_steps=2, niter_tv=3, band=8, halo=8),
        lambda: wrappers[3](x, x, x, x, one, x, x, keys, (0.1, 1.0, 1.0, 1.0, 1.0, 0.3),
                            (0, 0, 0), taps=taps, oy=oy, ox=ox, lam=1.0, n_steps=2,
                            niter_solve=1, band=8, halo=8),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
    assert [w.launches for w in wrappers] == before


def test_keys_without_a_shared_seed_raise(deblur):
    """A chain axis takes ``C`` keys ``(seed, chain_c)`` sharing one seed
    (``core.random.chain_keys``): other keys, or another count, raise in each
    of the four plain versions."""
    _, tl2, _ = deblur
    x = torch.zeros((2, NT, NT), dtype=torch.float64)
    one = x[0]
    taps, (oy, ox), atbs = t_myula._fused_params(tl2)
    tkw = dict(taps=taps, oy=oy, ox=ox, n_steps=2, band=8, halo=8)
    calls = [
        lambda k: t_wf.wavelet_block_update_ref(x, one, one, x, x, k, MYULA_F + (1.0,),
                                                (0, 0, 0)),
        lambda k: t_wf.ulpda_wavelet_block_update_ref(x, x, x, one, one, x, x, k,
                                                      (1e-3, 1.0, 1.0, 1.0, 1.0, 0.1),
                                                      (0, 0, 0)),
        lambda k: t_tiled.myula_tv_tiled_update_ref(x, atbs, x, x, k, (0.1, 0.5, 0.1, 1.0, 1.0),
                                                    (0, 0, 0), niter_tv=3, **tkw),
        lambda k: t_utiled.ulpda_tv_tiled_update_ref(x, x, x, x, atbs, x, x, k,
                                                     (0.1, 1.0, 1.0, 1.0, 1.0, 0.3),
                                                     (0, 0, 0), lam=1.0, niter_solve=1,
                                                     **tkw),
    ]
    for call in calls:
        for bad in ([(1, 0), (2, 1)], chain_keys(0, 3), 7):
            with pytest.raises((ValueError, TypeError)):
                call(bad)
