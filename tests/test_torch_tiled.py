"""Port parity for the large-image slice: the tiled MYULA and ULPDA kernels'
plain versions (kernels 6 and 7, ``myula_tiled.py``, ``ulpda_tiled.py``) and
their runners against the JAX package's tiled Pallas kernels in interpret
mode (f64, noise off, the JAX tests' own gates: 1e-11 on position and mean,
1e-9 on m2, 1e-12 on the ULPDA dual), against the port's whole-image chains
with noise on (the same Philox stream, so the same chain), quantile maps and
resumes, the checkpointed tiled runners, a JAX tiled chain continued in the
port, and the argument checks. Each JAX reference runs once per module."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.kernels import myula_tiled as t_tiled
from lmc_atomi_torch.kernels import ulpda_tiled as t_utiled
from lmc_atomi_torch.kernels.myula_fused import run_myula_tv_fused
from lmc_atomi_torch.kernels.ulpda_fused import run_ulpda_fused
from lmc_atomi_torch.ops.functionals import L1Norm as TL1, L21Norm as TL21
from lmc_atomi_torch.ops.linops import Gradient2D as TGrad
from lmc_atomi_torch.ops.wavelet import HaarDWT2D
from lmc_atomi_torch.run.longrun import run_resumable_fused
from lmc_atomi_tpu.kernels import myula_fused as j_fused
from lmc_atomi_tpu.kernels import myula_tiled as j_tiled
from lmc_atomi_tpu.kernels import ulpda_tiled as j_utiled
from lmc_atomi_tpu.ops.functionals import L1Norm, L21Norm, L2Data
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, Gradient2D, uniform_kernel
from lmc_atomi_tpu.ops.ncvx_tv import L2NcvxTV
from lmc_atomi_tpu.utils.images import phantom

torch.set_num_threads(2)

N = 64
SIG = 0.75
GAMMA = SIG**2
TAU = 0.2 * GAMMA  # MYULA
TAU_PD = 0.95 * GAMMA  # ULPDA, mu = 1
STEPS, BLOCK, BURN = 8, 4, 2
# ULPDA's extrapolation amplifies the packages' different rounding (the
# port takes kernel 3's x + theta (x - x_old) where the JAX tiled kernel
# takes (1 + theta) x - theta x_old; the dual drifts past 1e-12 by step 4),
# so its JAX comparisons at the JAX gates run 2 steps, one parity pair, and
# the continued chain 2 + 2
PD_STEPS, PD_BLOCK, PD_BURN = 2, 2, 1
POS_TOL, M2_TOL, Y_TOL = 1e-11, 1e-9, 1e-12  # the JAX tiled tests' f64 gates
# over STEPS steps in 2 blocks the TV/l21 dual drifts to 4.3e-12 (|y| <= 0.3)
# while x, mean and m2 stay within the JAX gates; the dual's gate there
PD_Y8_TOL = 2e-11
# port tiled against port whole-image, noise on: both take the same float64
# operations on each pixel, so they agree to the last bit; the gate allows
# roundoff all the same
SAME_TOL = 1e-12


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol, err_msg=name)


@pytest.fixture(scope="module")
def problem():
    """The 64^2 phantom deblurring posterior in both packages: the plain
    data term and the MC-TV / ME-TV ones."""
    img = phantom(N, np.float64)
    jb = CirculantBlur2D.from_kernel((N, N), uniform_kernel(5, jnp.float64))
    noise = np.random.default_rng(0).normal(size=(N, N))
    y = np.asarray(jb.matvec(jnp.asarray(img))) + SIG * noise
    tb = interop.blur_from_numpy(np.asarray(jb.eigs_re), np.asarray(jb.eigs_im),
                                 np.asarray(jb.h), np.asarray(jb.hh), jb.offset)
    terms = {"tv": (L2Data.create(op=jb, b=jnp.asarray(y), sigma=1 / SIG**2),
                    interop.l2data_from_numpy(y, 1 / SIG**2, tb))}
    for mode, op2, top2 in (("mctv", Gradient2D(), TGrad()), ("metv", None, None)):
        fields = dict(sigma=1 / SIG**2, lamda=0.3, gamma=15.0, isotropic=True,
                      niter_inner=10)
        terms[mode] = (L2NcvxTV(op=jb, b=jnp.asarray(y), op2=op2, **fields),
                       interop.l2ncvx_from_numpy(y, tb, op2=top2, **fields))
    return y, terms


@pytest.fixture(scope="module")
def jax_myula(problem):
    """The JAX tiled MYULA chain of STEPS steps for (mode, band, halo,
    solver, niter_tv), memoized."""
    _, terms = problem

    @functools.lru_cache(maxsize=None)
    def run(mode, band, halo, solver, nt, n_steps=STEPS):
        return j_tiled.run_myula_tv_tiled(
            terms[mode][0], 0.3, TAU, GAMMA, jnp.zeros((N, N)), jax.random.PRNGKey(1),
            n_steps, block=BLOCK, burn_in=BURN, noise_scale=0.0, interpret=True,
            band=band, halo=halo, tv_solver=solver, niter_tv=nt)

    return run


def _port_myula(terms, mode, x0=None, **kw):
    kw = dict(dict(block=BLOCK, burn_in=BURN), **kw)
    x0 = torch.zeros((N, N), dtype=torch.float64) if x0 is None else x0
    return t_tiled.run_myula_tv_tiled(terms[mode][1], 0.3, TAU, GAMMA, x0, 1,
                                      kw.pop("n_steps", STEPS), **kw)


def _check_moments(got, want, count=STEPS - BURN):
    _close(got.final_state.position, want.final_state.position, POS_TOL, "x")
    _close(got.moments.mean, want.moments.mean, POS_TOL, "mean")
    _close(got.moments.m2, want.moments.m2, M2_TOL, "m2")
    assert int(got.moments.count) == int(want.moments.count) == count


# the band/halo/solver cases of tests/test_myula_tiled.py at 64^2; the last
# is the halo >= band geometry that puts the image's last row inside an
# interior band's halo
MYULA_CASES = [(32, 16, "chambolle", 10), (16, 16, "chambolle", 10),
               (32, 16, "fgp", 8), (16, 24, "fgp", 8), (16, 24, "chambolle", 16)]


@pytest.mark.parametrize("band,halo,solver,nt", MYULA_CASES)
def test_myula_tiled_matches_jax(problem, jax_myula, band, halo, solver, nt):
    _, terms = problem
    got = _port_myula(terms, "tv", band=band, halo=halo, tv_solver=solver,
                      niter_tv=nt, noise_scale=0.0)
    _check_moments(got, jax_myula("tv", band, halo, solver, nt))


@pytest.mark.parametrize("mode", ["mctv", "metv"])
def test_myula_tiled_ncvx_matches_jax(problem, jax_myula, mode):
    _, terms = problem
    got = _port_myula(terms, mode, band=32, halo=16, noise_scale=0.0)
    _check_moments(got, jax_myula(mode, 32, 16, "chambolle", 10))


def test_tiled_update_ref_matches_jax(problem):
    """One block call of the plain version from a mid-chain state (nonzero
    moments, P^2 markers past their bootstrap, step0/burn/count0 past the
    start) against the JAX kernel, markers thinned by 2."""
    y, terms = problem
    rng = np.random.default_rng(1)
    x, mean = rng.normal(size=(2, N, N)) * 20 + 100
    m2 = rng.uniform(1, 5, size=(N, N)) * 30
    qs = (0.25, 0.75)
    qh = np.sort(rng.normal(size=(5, N, N)) * 10 + 100, axis=0)
    qh = np.concatenate([qh, qh + 1.0])
    qn = np.tile(np.array([3.0, 6.0, 9.0])[:, None, None], (2, N, N))
    taps, (oy, ox), atbs = j_fused._fused_params(terms["tv"][0], 0.3, TAU, GAMMA, 10)
    scal_f = (TAU, GAMMA, 0.3 * GAMMA, 0.0, 1 / SIG**2)
    # the first recorded step (g = 31) has 13 observations before it, past
    # the marker positions (3, 6, 9): a consistent P^2 state
    scal_i = (30, 5, 7)
    kw = dict(taps=taps, oy=oy, ox=ox, n_steps=6, band=32, halo=16,
              with_noise=False, quantiles=qs, quantile_thin=2)
    want = j_tiled.myula_tv_tiled_update(
        *(jnp.asarray(a) for a in (x, atbs, mean, m2)), jnp.zeros(2, jnp.int32),
        jnp.asarray(scal_f + (0.0, 1.0)), jnp.asarray(scal_i, jnp.int32),
        jnp.asarray(qh), jnp.asarray(qn), interpret=True, **kw)
    got = t_tiled.myula_tv_tiled_update(
        *(torch.from_numpy(np.array(a)) for a in (x, atbs, mean, m2)), 0, scal_f,
        scal_i, torch.from_numpy(qh), torch.from_numpy(qn), **kw)
    for name, g, w, tol in zip(("x", "mean", "m2", "qh"), got, want,
                               (POS_TOL, POS_TOL, M2_TOL, 1e-9)):
        _close(g, w, tol, name)
    np.testing.assert_array_equal(_np(got[4]), np.asarray(want[4]))


@pytest.mark.parametrize("mode,solver,nt", [("tv", "chambolle", 10), ("tv", "fgp", 8),
                                            ("mctv", "chambolle", 10),
                                            ("metv", "chambolle", 10)])
def test_myula_tiled_equals_whole_image_with_noise(problem, mode, solver, nt):
    """The tiled chain and ``run_myula_tv_fused`` (no warm dual) draw the
    same Philox stream, so they are the same chain."""
    y, terms = problem
    x0 = torch.from_numpy(y)
    kw = dict(burn_in=BURN, tv_solver=solver, niter_tv=nt)
    got = _port_myula(terms, mode, x0, band=16, halo=16 if nt < 16 else 24, **kw)
    want = run_myula_tv_fused(terms[mode][1], 0.3, TAU, GAMMA, x0, 1, STEPS, block=BLOCK, **kw)
    _close(got.final_state.position, want.final_state.position, SAME_TOL, "x")
    _close(got.moments.mean, want.moments.mean, SAME_TOL, "mean")
    _close(got.moments.m2, want.moments.m2, SAME_TOL, "m2")
    assert got.moments.count == want.moments.count


@pytest.mark.parametrize("thin", [1, 2, 4])
def test_tiled_quantiles_equal_whole_image(problem, thin):
    """P^2 maps of the tiled chain against the whole-image kernel's, noise
    on: marker positions equal, heights to roundoff."""
    y, terms = problem
    x0 = torch.from_numpy(y)
    kw = dict(burn_in=3, quantiles=(0.25, 0.75), quantile_thin=thin)
    got = _port_myula(terms, "tv", x0, n_steps=16, block=8, **kw)
    want = run_myula_tv_fused(terms["tv"][1], 0.3, TAU, GAMMA, x0, 1, 16, block=8, **kw)
    for p in (0.25, 0.75):
        _close(got.quantiles[p], want.quantiles[p], SAME_TOL, f"q{p}")
    _close(got.quantile_state[0], want.quantile_state[0], SAME_TOL, "qh")
    np.testing.assert_array_equal(_np(got.quantile_state[1]), _np(want.quantile_state[1]))


def test_tiled_quantile_resume(problem):
    """8 + 8 steps through ``quantile_state``/``step_offset`` equal 16
    straight (noise on): position and markers bit for bit, the merged
    moments to roundoff."""
    y, terms = problem
    x0 = torch.from_numpy(y)
    kw = dict(burn_in=3, block=8, quantiles=(0.5,), quantile_thin=2)
    full = _port_myula(terms, "tv", x0, n_steps=16, **kw)
    a = _port_myula(terms, "tv", x0, n_steps=8, **kw)
    b = _port_myula(terms, "tv", a.final_state.position, n_steps=8, step_offset=8,
                    quantile_state=a.quantile_state, **kw)
    assert torch.equal(b.final_state.position, full.final_state.position)
    assert torch.equal(b.quantile_state[0], full.quantile_state[0])
    assert torch.equal(b.quantile_state[1], full.quantile_state[1])
    merged = a.moments.merge(b.moments)
    assert merged.count == full.moments.count == 13
    _close(merged.mean, full.moments.mean, 1e-12, "mean")
    _close(merged.m2, full.moments.m2, 1e-9, "m2")


@pytest.fixture(scope="module")
def jax_ulpda(problem):
    """The JAX tiled ULPDA chain, PD_STEPS steps by default, memoized."""
    _, terms = problem

    @functools.lru_cache(maxsize=None)
    def run(mode, dual, gfirst, band, halo, n_steps=PD_STEPS, block=PD_BLOCK,
            burn_in=PD_BURN):
        proxg = (L21Norm if dual == "l21" else L1Norm)(sigma=0.3)
        return j_utiled.run_ulpda_tv_tiled(
            terms[mode][0], proxg, Gradient2D(), TAU_PD, 1.0, jnp.zeros((N, N)),
            jax.random.PRNGKey(1), n_steps, niter_solve=3, block=block,
            burn_in=burn_in, noise_scale=0.0, interpret=True, band=band, halo=halo,
            gfirst=gfirst)

    return run


def _port_ulpda(terms, mode, dual, x0=None, **kw):
    kw = dict(dict(block=BLOCK, burn_in=BURN, niter_solve=3), **kw)
    proxg = (TL21 if dual == "l21" else TL1)(sigma=0.3)
    x0 = torch.zeros((N, N), dtype=torch.float64) if x0 is None else x0
    return t_utiled.run_ulpda_tv_tiled(terms[mode][1], proxg, TGrad(), TAU_PD, 1.0,
                                       x0, 1, kw.pop("n_steps", STEPS), **kw)


# both orders and both Gradient2D duals, and the nonconvex modes at the
# band/halo pairs of tests/test_ulpda_tiled.py
ULPDA_CASES = [("tv", "l21", False, 32, 16), ("tv", "l21", True, 32, 16),
               ("tv", "l1", True, 32, 16), ("mctv", "l1", False, 32, 16),
               ("metv", "l21", False, 16, 24)]


@pytest.mark.parametrize("mode,dual,gfirst,band,halo", ULPDA_CASES)
def test_ulpda_tiled_matches_jax(problem, jax_ulpda, mode, dual, gfirst, band, halo):
    _, terms = problem
    got = _port_ulpda(terms, mode, dual, band=band, halo=halo, gfirst=gfirst,
                      noise_scale=0.0, n_steps=PD_STEPS, block=PD_BLOCK,
                      burn_in=PD_BURN)
    want = jax_ulpda(mode, dual, gfirst, band, halo)
    _check_moments(got, want, PD_STEPS - PD_BURN)
    _close(got.final_state.extras.y, want.final_state.extras.y, Y_TOL, "y")
    _close(got.final_state.extras.xprev, want.final_state.extras.xprev, POS_TOL, "xprev")
    _close(got.final_state.extras.xbar, want.final_state.extras.xbar, POS_TOL, "xbar")


@pytest.mark.parametrize("gfirst", [False, True])
def test_ulpda_tiled_two_blocks_match_jax(problem, jax_ulpda, gfirst):
    """STEPS steps in 2 blocks: the block handoff and, with ``gfirst``, the
    stale parity partner carried across it, held to the JAX kernel."""
    _, terms = problem
    got = _port_ulpda(terms, "tv", "l21", band=32, halo=16, gfirst=gfirst, noise_scale=0.0)
    want = jax_ulpda("tv", "l21", gfirst, 32, 16, STEPS, BLOCK, BURN)
    _check_moments(got, want)
    _close(got.final_state.extras.y, want.final_state.extras.y, PD_Y8_TOL, "y")
    _close(got.final_state.extras.xprev, want.final_state.extras.xprev, POS_TOL, "xprev")
    _close(got.final_state.extras.xbar, want.final_state.extras.xbar, POS_TOL, "xbar")


@pytest.mark.parametrize("mode,dual,gfirst", [("tv", "l21", False), ("tv", "l21", True),
                                              ("mctv", "l1", False), ("metv", "l21", False)])
def test_ulpda_tiled_equals_whole_image_with_noise(problem, mode, dual, gfirst):
    """The tiled chain and ``run_ulpda_fused`` (cold Chambolle envelope) are
    the same chain: dual, xbar and moments too."""
    y, terms = problem
    x0 = torch.from_numpy(y)
    got = _port_ulpda(terms, mode, dual, x0, band=16, halo=24, gfirst=gfirst)
    proxg = (TL21 if dual == "l21" else TL1)(sigma=0.3)
    want = run_ulpda_fused(terms[mode][1], proxg, TGrad(), TAU_PD, 1.0, x0, 1, STEPS,
                           block=BLOCK, burn_in=BURN, niter_solve=3, gfirst=gfirst)
    for name in ("y", "xbar"):
        _close(getattr(got.final_state.extras, name),
               getattr(want.final_state.extras, name), SAME_TOL, name)
    _close(got.final_state.position, want.final_state.position, SAME_TOL, "x")
    _close(got.moments.mean, want.moments.mean, SAME_TOL, "mean")
    _close(got.moments.m2, want.moments.m2, SAME_TOL, "m2")


@pytest.mark.parametrize("runner", ["tiled", "ulpda_tiled"])
def test_resumable_fused_tiled_runners(problem, tmp_path, runner):
    """``run_resumable_fused`` with a tiled runner, 2 segments of 8 through a
    checkpoint (the process stopped after the first), against the straight
    run: position, dual and previous sample and markers bit for bit."""
    y, terms = problem
    x0 = torch.from_numpy(y)
    kw = dict(runner=runner, burn_in=BURN, quantiles=(0.1, 0.9), band=32, halo=16)
    args = (terms["tv"][1], 0.3, TAU_PD if runner == "ulpda_tiled" else TAU,
            1.0 if runner == "ulpda_tiled" else GAMMA, x0, (4, 2))
    straight = run_resumable_fused(*args, 16, 16, **kw)
    ckpt = str(tmp_path / "tiled.ckpt")
    first = run_resumable_fused(*args, 8, 8, ckpt_path=ckpt, **kw)
    assert first["done"] == 8
    resumed = run_resumable_fused(*args, 16, 8, ckpt_path=ckpt, **kw)
    assert resumed["done"] == 16
    assert torch.equal(resumed["position"], straight["position"])
    for p in (0.1, 0.9):
        assert torch.equal(resumed["quantiles"][p], straight["quantiles"][p])
    if runner == "ulpda_tiled":
        for a, b in zip(resumed["ulpda_extras"], straight["ulpda_extras"]):
            assert torch.equal(a, b)
    assert resumed["moments"].count == straight["moments"].count == 16 - BURN
    _close(resumed["moments"].mean, straight["moments"].mean, 1e-12, "mean")


def test_jax_tiled_chains_continue_in_port(problem, jax_myula, jax_ulpda):
    """Half the steps in the JAX package's tiled kernels, carried across
    with ``interop``, the other half in the port: equal to the JAX straight
    runs, moments merged (noise off)."""
    _, terms = problem
    half = STEPS // 2
    jm = j_tiled.run_myula_tv_tiled(
        terms["tv"][0], 0.3, TAU, GAMMA, jnp.zeros((N, N)), jax.random.PRNGKey(1),
        half, block=BLOCK, burn_in=BURN, noise_scale=0.0, interpret=True, band=32,
        halo=16)
    st = interop.fused_state_from_numpy(
        np.asarray(jm.final_state.position), np.asarray(jm.moments.mean),
        np.asarray(jm.moments.m2), int(jm.moments.count))
    got = _port_myula(terms, "tv", st.final_state.position, n_steps=half,
                      band=32, halo=16, noise_scale=0.0, step_offset=half)
    whole = jax_myula("tv", 32, 16, "chambolle", 10)
    _close(got.final_state.position, whole.final_state.position, POS_TOL, "myula x")
    merged = st.moments.merge(got.moments)
    assert merged.count == int(whole.moments.count)
    _close(merged.mean, whole.moments.mean, POS_TOL, "myula mean")
    _close(merged.m2, whole.moments.m2, M2_TOL, "myula m2")

    half = PD_STEPS
    ju = j_utiled.run_ulpda_tv_tiled(
        terms["tv"][0], L21Norm(sigma=0.3), Gradient2D(), TAU_PD, 1.0,
        jnp.zeros((N, N)), jax.random.PRNGKey(1), half, niter_solve=3,
        block=PD_BLOCK, burn_in=PD_BURN, noise_scale=0.0, interpret=True, band=32,
        halo=16)
    ex = ju.final_state.extras
    st = interop.ulpda_tiled_state_from_numpy(
        *(np.asarray(a) for a in (ju.final_state.position, ex.y, ex.xbar, ex.xprev,
                                  ju.moments.mean, ju.moments.m2)),
        int(ju.moments.count))
    got = _port_ulpda(terms, "tv", "l21", st.final_state.position, n_steps=half,
                      block=PD_BLOCK, burn_in=PD_BURN, band=32, halo=16,
                      noise_scale=0.0, step_offset=half, y0=st.final_state.extras.y,
                      xprev0=st.final_state.extras.xprev)
    whole = jax_ulpda("tv", "l21", False, 32, 16, 2 * half)
    _close(got.final_state.position, whole.final_state.position, POS_TOL, "ulpda x")
    _close(got.final_state.extras.y, whole.final_state.extras.y, Y_TOL, "ulpda y")
    merged = st.moments.merge(got.moments)
    assert merged.count == int(whole.moments.count)
    _close(merged.mean, whole.moments.mean, POS_TOL, "ulpda mean")


def test_tiling_helpers_match_jax():
    for ny in (64, 128, 256, 512, 1024, 2048, 4096):
        for halo in (8, 16, 24, 32):
            assert t_tiled.pick_band(ny, halo) == j_tiled.pick_band(ny, halo)
    for args in ((10, 4, "tv", 0), (8, 4, "mctv", 10), (4, 4, "metv", 10), (0, 6, "tv", 0)):
        assert t_tiled._halo_need(*args) == j_tiled._halo_need(*args)
    for args in ((3, 4, "tv", 10), (3, 4, "mctv", 10), (3, 4, "metv", 10), (0, 2, "tv", 0)):
        assert t_utiled._ulpda_halo_need(*args) == j_utiled._ulpda_halo_need(*args)
    for b, n_bands, band, halo in ((0, 4, 16, 24), (2, 4, 16, 24), (3, 4, 16, 24),
                                   (1, 2, 32, 16)):
        jy, jx = j_tiled._band_masks(b, n_bands, band, halo, N, jnp.float64)
        ty, tx = t_tiled._band_masks(b, n_bands, band, halo, N, torch.float64, "cpu")
        np.testing.assert_array_equal(np.broadcast_to(_np(ty), jy.shape), np.asarray(jy))
        np.testing.assert_array_equal(np.broadcast_to(_np(tx), jx.shape), np.asarray(jx))
    x = torch.arange(64 * 3, dtype=torch.float64).reshape(64, 3)
    tile = t_tiled._read_tile(x, 0, 16, 24)
    np.testing.assert_array_equal(_np(tile), np.roll(_np(x), 24, 0)[:64])


def test_argument_checks_mirror_jax(problem):
    """The calls the JAX package refuses, the port refuses with the same
    words; the tiled ULPDA takes Gradient2D duals only."""
    _, terms = problem
    x0 = torch.zeros((N, N), dtype=torch.float64)
    jx0 = jnp.zeros((N, N))
    for kw, word in ((dict(n_steps=13), "even"), (dict(halo=8), "halo"),
                     (dict(band=100), "band"), (dict(band=24), "band"),
                     (dict(band=32, halo=24), "tile")):
        n = kw.pop("n_steps", 12)
        with pytest.raises(ValueError, match=word):
            t_tiled.run_myula_tv_tiled(terms["tv"][1], 0.3, TAU, GAMMA, x0, 0, n,
                                       noise_scale=0.0, **kw)
        with pytest.raises(ValueError, match=word):
            j_tiled.run_myula_tv_tiled(terms["tv"][0], 0.3, TAU, GAMMA, jx0,
                                       jax.random.PRNGKey(0), n, noise_scale=0.0,
                                       interpret=True, **kw)
    with pytest.raises(ValueError, match="halo"):  # ME-TV: niter_inner + 1 > 8
        t_tiled.run_myula_tv_tiled(terms["metv"][1], 0.3, TAU, GAMMA, x0, 0, 12,
                                   niter_tv=4, halo=8, noise_scale=0.0)
    with pytest.raises(ValueError, match="halo"):  # 3 * 4 + 1 + 11 > 16
        _port_ulpda(terms, "metv", "l21", band=32, halo=16, noise_scale=0.0)
    with pytest.raises(ValueError, match="Gradient2D"):
        t_utiled.run_ulpda_tv_tiled(terms["tv"][1], TL1(sigma=0.3), HaarDWT2D(levels=2),
                                    TAU_PD, 1.0, x0, 0, 8)


def test_cuda_wrappers_raise_on_cpu(problem):
    """No fallback: the kernels' wrappers refuse CPU tensors and count no
    launch; the dispatchers send CPU tensors to the plain versions."""
    y, terms = problem
    x = torch.from_numpy(y)
    z = torch.zeros_like(x)
    taps = ((tuple(np.ones(3) / 3), tuple(np.ones(3) / 3)),)
    before = (t_tiled.myula_tv_tiled_update_cuda.launches,
              t_utiled.ulpda_tv_tiled_update_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        t_tiled.myula_tv_tiled_update_cuda(
            x, z, z, z, 0, (TAU, GAMMA, 0.3, 1.0, 1.0), (0, 0, 0), taps=taps, oy=1,
            ox=1, n_steps=2, band=32, halo=16)
    with pytest.raises(ValueError, match="CUDA"):
        t_utiled.ulpda_tv_tiled_update_cuda(
            x, x, z, z, z, z, z, 0, (TAU, 1.0, 1.0, 1.0, 1.0, 0.3), (0, 0, 0),
            taps=taps, oy=1, ox=1, lam=1.0, n_steps=2, band=32, halo=16)
    assert before == (t_tiled.myula_tv_tiled_update_cuda.launches,
                      t_utiled.ulpda_tv_tiled_update_cuda.launches)
