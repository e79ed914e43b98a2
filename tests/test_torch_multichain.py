"""Multi-chain sampling in the port, on the CPU, against the JAX package:
``chain_keys``, ``run_chains``, ``run_chain_segmented``, the packed runners
(the plain versions of kernels 2 and 3 with a chain axis) and their
``chain_nx``/``marker_hbm``/``interpret`` keywords, the chain farm of
``run_resumable_fused``, ``merge_chain_moments`` and the diagnostics,
``multichain_deblur``, and JAX multi-chain state continued in the port.

Noise off and f64 where a result is held to JAX (the noise streams differ
by design), with the tolerance stated; noise on where a chain is held to
the port's own one-chain run under its chain key, bit for bit."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.core.checkpoint import save_checkpoint
from lmc_atomi_torch.core.random import chain_keys
from lmc_atomi_torch.core.stats import RunningMoments
from lmc_atomi_torch.eval import diagnostics as t_diag
from lmc_atomi_torch.experiments import multichain as t_multichain
from lmc_atomi_torch.kernels import imaging as t_imaging
from lmc_atomi_torch.kernels import langevin as t_langevin
from lmc_atomi_torch.kernels import myula_fused as t_myula
from lmc_atomi_torch.kernels import ulpda_fused as t_ulpda
from lmc_atomi_torch.ops import functionals as t_fn
from lmc_atomi_torch.ops.wavelet import HaarDWT2D as THaar
from lmc_atomi_torch.parallel.mesh import merge_chain_moments as t_merge
from lmc_atomi_torch.run import longrun as t_longrun
from lmc_atomi_torch.run import runner as t_runner
from lmc_atomi_torch.utils.cli import auto_cli
from lmc_atomi_tpu.core.stats import RunningMoments as JMoments
from lmc_atomi_tpu.eval import diagnostics as j_diag
from lmc_atomi_tpu.experiments import multichain as j_multichain
from lmc_atomi_tpu.kernels import imaging as j_imaging
from lmc_atomi_tpu.kernels import myula_fused as j_myula
from lmc_atomi_tpu.kernels import ulpda_fused as j_ulpda
from lmc_atomi_tpu.ops.functionals import L1Norm, L21Norm, L2Data
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, Gradient2D, uniform_kernel
from lmc_atomi_tpu.ops.ncvx_tv import L2NcvxTV
from lmc_atomi_tpu.parallel.mesh import merge_chain_moments as j_merge
from lmc_atomi_tpu.run import longrun as j_longrun
from lmc_atomi_tpu.run import runner as j_runner
from lmc_atomi_tpu.utils.images import phantom

torch.set_num_threads(2)

N = 32
SIG = 0.75
SIGMA = 1 / SIG**2
GAMMA = SIG**2
TAU = 0.2 * GAMMA
TAU_PD = 0.95 / SIGMA
# f64 on both sides: the recursions differ in summation order only (the
# tests/test_torch_myula_fused.py and test_torch_ulpda.py gate)
TOL = 1e-9


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=name)


@pytest.fixture(scope="module")
def problem():
    """The 32^2 deconvolution posterior in f64, built in JAX and carried to
    the port: the TV, MC-TV and ME-TV data terms with their dual norms."""
    img = phantom(N, np.float64)
    jb = CirculantBlur2D.from_kernel((N, N), uniform_kernel(5, jnp.float64))
    y = np.asarray(jb.matvec(jnp.asarray(img))) \
        + SIG * np.random.default_rng(0).normal(size=(N, N))
    tb = interop.blur_from_numpy(np.asarray(jb.eigs_re), np.asarray(jb.eigs_im),
                                 np.asarray(jb.h), np.asarray(jb.hh), jb.offset)
    nc = dict(sigma=SIGMA, lamda=0.3, gamma=15.0, isotropic=True, niter_inner=4)
    jy = jnp.asarray(y)
    jax_terms = {
        "tv": (L2Data.create(op=jb, b=jy, sigma=SIGMA), L21Norm(sigma=0.3)),
        "mctv": (L2NcvxTV(op=jb, b=jy, op2=Gradient2D(), **nc), L1Norm(sigma=0.3)),
        "metv": (L2NcvxTV(op=jb, b=jy, op2=None, **nc), L21Norm(sigma=0.3)),
    }
    tgrad = interop.gradient_from_numpy()
    port_terms = {
        "tv": (interop.l2data_from_numpy(y, SIGMA, tb), t_fn.L21Norm(sigma=0.3)),
        "mctv": (interop.l2ncvx_from_numpy(y, tb, op2=tgrad, **nc), t_fn.L1Norm(sigma=0.3)),
        "metv": (interop.l2ncvx_from_numpy(y, tb, op2=None, **nc), t_fn.L21Norm(sigma=0.3)),
    }
    return y, jax_terms, port_terms


def _starts(c, seed=5):
    return np.random.default_rng(seed).normal(size=(c, N, N)) * 20 + 100


# --- chain_keys ----------------------------------------------------------------

def test_chain_keys_distinct_and_deterministic():
    """The words are a pure function of (seed, chain, i), distinct for
    distinct i, and keep the seed; another base chain or seed gives other
    words."""
    keys = chain_keys((7, 3), 4096)
    assert keys == chain_keys((7, 3), 4096) and keys[:5] == chain_keys((7, 3), 5)
    assert {s for s, _ in keys} == {7}
    words = [c for _, c in keys]
    assert len(set(words)) == len(words) and all(0 <= w < 2**32 for w in words)
    assert chain_keys(7, 3) == chain_keys((7, 0), 3)
    assert not set(words[:64]) & {c for _, c in chain_keys((7, 4), 64)}
    assert [c for _, c in chain_keys((8, 3), 64)] != words[:64]


# --- run_chains and run_chain_segmented ----------------------------------------

@pytest.mark.parametrize("collect", ["samples", "both"])
def test_run_chains_equal_run_chain_under_chain_keys(problem, collect):
    """Noise on: chain i of ``run_chains`` is ``run_chain`` under
    ``chain_keys(key, n)[i]`` bit for bit, every field stacked along the
    chain axis (samples, moments and counts, the final state, the extras)."""
    _, _, port = problem
    kern = t_imaging.ulpda(*port["tv"], interop.gradient_from_numpy(), tau=TAU_PD, mu=1.0)
    x0 = torch.from_numpy(_starts(3))
    kw = dict(collect=collect, burn_in=2, thin=2, collect_extras=True)
    got = t_runner.run_chains(kern, x0, (4, 1), 8, 3, **kw)
    for i, key in enumerate(chain_keys((4, 1), 3)):
        one = t_runner.run_chain(kern, x0[i], key, 8, **kw)
        assert torch.equal(got.samples[i], one.samples)
        assert torch.equal(got.final_state.position[i], one.final_state.position)
        assert int(got.final_state.step[i]) == one.final_state.step == 8
        assert torch.equal(got.extras.y[i], one.extras.y)
        if collect == "both":
            assert int(got.moments.count[i]) == one.moments.count == 2
            assert torch.equal(got.moments.mean[i], one.moments.mean)
    assert got.samples.shape == (3, 4, N, N) and got.extras.xprev is None


def test_run_chains_batched_distinct_starts_match_jax(problem):
    """Noise off, f64: 4 chains from distinct starts against the JAX
    package's ``run_chains`` (a vmap of ``run_chain``)."""
    _, jax_terms, port = problem
    x0 = _starts(4)
    jk = j_imaging.ulpda(*jax_terms["tv"], Gradient2D(), tau=TAU_PD, mu=1.0, noise_scale=0.0)
    want = j_runner.run_chains(jk, jnp.asarray(x0), jax.random.PRNGKey(0), 6, 4,
                               collect="both", burn_in=1)
    tk = t_imaging.ulpda(*port["tv"], interop.gradient_from_numpy(), tau=TAU_PD, mu=1.0,
                         noise_scale=0.0)
    got = t_runner.run_chains(tk, torch.from_numpy(x0), 0, 6, 4, collect="both", burn_in=1)
    _close(got.samples, want.samples, name="samples")
    _close(got.moments.mean, want.moments.mean, name="mean")
    _close(got.moments.m2, want.moments.m2, name="m2")
    np.testing.assert_array_equal(_np(got.moments.count), np.asarray(want.moments.count))


@pytest.mark.parametrize("case", ["inferred", "explicit_false", "explicit_true",
                                  "broadcast", "tuple"])
def test_run_chains_batched_corner_cases(case):
    """The ``batched`` rule of ``tests/test_misc_robustness.py:84-160``:
    inferred from a leading dimension of ``n_chains`` (the distinct starts
    stay distinct), ``batched=False`` broadcasting a 4-vector to 4 chains,
    ``batched=True`` splitting it into 4 scalar chains, a position whose
    leading dimension is not ``n_chains`` broadcast, and a tuple state
    batched leaf by leaf; each with the JAX package's sample shape."""
    n = 4
    x0 = {"inferred": np.arange(8.0).reshape(4, 2), "explicit_false": np.arange(4.0),
          "explicit_true": np.arange(4.0), "broadcast": np.arange(3.0),
          "tuple": np.arange(8.0).reshape(4, 2)}[case]
    batched = {"explicit_false": False, "explicit_true": True}.get(case)
    jk = __import__("lmc_atomi_tpu.kernels", fromlist=["ula"]).ula(lambda x: x, 0.1)
    tk = t_langevin.ula(lambda x: x, 0.1)
    want = j_runner.run_chains(jk, jnp.asarray(x0), jax.random.PRNGKey(0), 3, n,
                               batched=batched)
    got = t_runner.run_chains(tk, torch.from_numpy(x0), 0, 3, n, batched=batched)
    assert tuple(got.samples.shape) == tuple(np.asarray(want.samples).shape)
    if case == "inferred":
        drift = (got.samples[:, 0] - 0.9 * torch.from_numpy(x0)).abs()
        assert float(drift.max()) < 2.0 and not torch.equal(got.samples[0], got.samples[1])
    if case == "tuple":
        # a (tensor, tensor) pytree, batched on every leaf
        pair = (torch.from_numpy(x0), torch.from_numpy(x0) + 1.0)
        base = t_langevin.ula(lambda x: x, 0.1)
        kern = base._replace(init=lambda p: base.init(p[0] + p[1]))
        res = t_runner.run_chains(kern, pair, 0, 2, n)
        assert tuple(res.samples.shape) == (n, 2, 2)


def test_run_chains_refuses_another_axis():
    with pytest.raises(ValueError, match="axis 0"):
        t_runner.run_chains(t_langevin.ula(lambda x: x, 0.1), torch.zeros(2), 0, 2, 2,
                            axis=1)


def test_run_chain_segmented_equals_run_chain(problem):
    """Noise on: segments of 3 over 11 steps with P^2 quantiles and the
    progress calls equal one ``run_chain(collect="stats")`` bit for bit."""
    _, _, port = problem
    kern = t_imaging.ulpda(*port["tv"], interop.gradient_from_numpy(), tau=TAU_PD, mu=1.0)
    x0 = torch.from_numpy(_starts(1)[0])
    seen = []
    seg = t_runner.run_chain_segmented(kern, x0, (2, 5), 11, segment_steps=3, burn_in=4,
                                       quantile_ps=(0.5,),
                                       progress=lambda d, m: seen.append((d, m.count)))
    one = t_runner.run_chain(kern, x0, (2, 5), 11, collect="stats", burn_in=4,
                             quantile_ps=(0.5,))
    assert seen == [(3, 0), (6, 2), (9, 5), (11, 7)]
    assert torch.equal(seg.final_state.position, one.final_state.position)
    assert seg.moments.count == one.moments.count == 7
    assert torch.equal(seg.moments.mean, one.moments.mean)
    assert torch.equal(seg.moments.m2, one.moments.m2)
    assert torch.equal(seg.quantiles[0.5].heights, one.quantiles[0.5].heights)
    assert seg.samples is None and seg.infos is None


def test_run_chain_segmented_matches_jax(problem):
    """Noise off, f64: against the JAX package's ``run_chain_segmented``."""
    _, jax_terms, port = problem
    x0 = _starts(1)[0]
    jk = j_imaging.ulpda(*jax_terms["metv"], Gradient2D(), tau=TAU_PD, mu=1.0,
                         noise_scale=0.0)
    want = j_runner.run_chain_segmented(jk, jnp.asarray(x0), jax.random.PRNGKey(0), 7,
                                        segment_steps=3, burn_in=2)
    tk = t_imaging.ulpda(*port["metv"], interop.gradient_from_numpy(), tau=TAU_PD, mu=1.0,
                         noise_scale=0.0)
    got = t_runner.run_chain_segmented(tk, torch.from_numpy(x0), 0, 7, segment_steps=3,
                                       burn_in=2)
    _close(got.final_state.position, want.final_state.position, name="x")
    _close(got.moments.mean, want.moments.mean, name="mean")
    _close(got.moments.m2, want.moments.m2, name="m2")
    assert got.moments.count == int(want.moments.count) == 5


# --- the packed runners against JAX's, noise off --------------------------------

MYULA_PACKED = {
    "tv_cold_c2": ("tv", 2, dict(niter_tv=5)),
    "tv_cold_c4": ("tv", 4, dict(niter_tv=5)),
    "tv_fgp_warm": ("tv", 2, dict(niter_tv=4, tv_solver="fgp", tv_warm=True)),
    "mctv": ("mctv", 2, dict(niter_tv=5)),
    "metv_warm": ("metv", 2, dict(niter_tv=3, tv_warm=True)),
    "quantiles_warm": ("tv", 2, dict(niter_tv=5, quantiles=(0.5,), tv_warm=True)),
}


@pytest.mark.parametrize("case", sorted(MYULA_PACKED))
def test_myula_packed_matches_jax(problem, case):
    """The twins of ``tests/test_myula_fused.py::TestLanePackedChains``:
    per-chain positions, moments and quantile maps of the packed runner
    against the JAX package's (interpret mode), 6 steps in blocks of 3,
    burn-in 1."""
    _, jax_terms, port = problem
    mode, c, opts = MYULA_PACKED[case]
    x0 = _starts(c)
    kw = dict(block=3, noise_scale=0.0, burn_in=1, **opts)
    want = j_myula.run_myula_tv_fused_packed(
        jax_terms[mode][0], 0.3, TAU, GAMMA, jnp.asarray(x0), jax.random.PRNGKey(7), 6,
        interpret=True, **kw)
    got = t_myula.run_myula_tv_fused_packed(port[mode][0], 0.3, TAU, GAMMA,
                                            torch.from_numpy(x0), 7, 6, **kw)
    assert got.final_state.position.shape == (c, N, N)
    _close(got.final_state.position, want.final_state.position, name="x")
    _close(got.moments.mean, want.moments.mean, name="mean")
    _close(got.moments.m2, want.moments.m2, tol=TOL * 10, name="m2")
    assert got.moments.count == int(want.moments.count) == 5
    for p in opts.get("quantiles", ()):
        _close(got.quantiles[p], want.quantiles[p], name=f"q{p}")
        # the JAX runner returns lane-packed markers; the port chain-major
        _close(t_myula.pack_lanes(got.quantile_state[0]), want.quantile_state[0], name="qh")


@pytest.mark.parametrize("which", ["tv", "metv"])
@pytest.mark.parametrize("gfirst", [False, True])
def test_ulpda_packed_matches_jax(problem, which, gfirst):
    """The twin of ``tests/test_ulpda_fused.py::TestLanePackedUlpda::
    test_parity``: 4 chains, 6 steps in blocks of 3, 4 Chebyshev sweeps;
    positions, moments and the extras in JAX's layout (``y`` dual-major)."""
    _, jax_terms, port = problem
    x0 = _starts(4)
    kw = dict(block=3, noise_scale=0.0, burn_in=1, niter_solve=4, gfirst=gfirst)
    want = j_ulpda.run_ulpda_fused_packed(*jax_terms[which], Gradient2D(), TAU_PD, 1.0,
                                          jnp.asarray(x0), jax.random.PRNGKey(9), 6,
                                          interpret=True, **kw)
    got = t_ulpda.run_ulpda_fused_packed(*port[which], interop.gradient_from_numpy(),
                                         TAU_PD, 1.0, torch.from_numpy(x0), 9, 6, **kw)
    _close(got.final_state.position, want.final_state.position, name="x")
    _close(got.moments.mean, want.moments.mean, name="mean")
    assert got.final_state.extras.y.shape == (2, 4, N, N)
    _close(got.final_state.extras.y, want.final_state.extras.y, name="y")
    _close(got.final_state.extras.xbar, want.final_state.extras.xbar, name="xbar")


def test_chain_nx_lane_layout_matches_jax(problem):
    """``chain_nx``: an ``(ny, C chain_nx)`` start unpacked, run and packed
    back, the markers in and out lane-packed, as the JAX package's; and
    the same for ULPDA's ``y`` (2, ny, C chain_nx)."""
    _, jax_terms, port = problem
    xp = np.concatenate(list(_starts(2)), axis=1)
    kw = dict(niter_tv=5, block=3, noise_scale=0.0, burn_in=1, quantiles=(0.1, 0.9))
    want = j_myula.run_myula_tv_fused(jax_terms["tv"][0], 0.3, TAU, GAMMA, jnp.asarray(xp),
                                      jax.random.PRNGKey(1), 6, chain_nx=N, interpret=True,
                                      **kw)
    got = t_myula.run_myula_tv_fused(port["tv"][0], 0.3, TAU, GAMMA, torch.from_numpy(xp),
                                     1, 6, chain_nx=N, **kw)
    assert got.final_state.position.shape == (N, 2 * N)
    assert got.quantile_state[0].shape == (10, N, 2 * N)
    _close(got.final_state.position, want.final_state.position, name="x")
    _close(got.moments.mean, want.moments.mean, name="mean")
    _close(got.quantile_state[0], want.quantile_state[0], name="qh")
    # resumed from the lane-packed markers
    more = t_myula.run_myula_tv_fused(port["tv"][0], 0.3, TAU, GAMMA,
                                      got.final_state.position, 1, 6, chain_nx=N,
                                      quantile_state=got.quantile_state, step_offset=6, **kw)
    want2 = j_myula.run_myula_tv_fused(jax_terms["tv"][0], 0.3, TAU, GAMMA,
                                       want.final_state.position, jax.random.PRNGKey(1), 6,
                                       chain_nx=N, interpret=True, step_offset=6,
                                       quantile_state=want.quantile_state, **kw)
    _close(more.quantile_state[1], want2.quantile_state[1], name="qn")
    uw = j_ulpda.run_ulpda_fused(*jax_terms["tv"], Gradient2D(), TAU_PD, 1.0,
                                 jnp.asarray(xp), jax.random.PRNGKey(1), 4, block=2,
                                 noise_scale=0.0, chain_nx=N, interpret=True)
    ug = t_ulpda.run_ulpda_fused(*port["tv"], interop.gradient_from_numpy(), TAU_PD, 1.0,
                                 torch.from_numpy(xp), 1, 4, block=2, noise_scale=0.0,
                                 chain_nx=N)
    assert ug.final_state.extras.y.shape == (2, N, 2 * N)
    _close(ug.final_state.position, uw.final_state.position, name="ulpda x")
    _close(ug.final_state.extras.y, uw.final_state.extras.y, name="ulpda y")


def test_marker_hbm_and_interpret_take_no_effect(problem):
    """The JAX package's VMEM paging and interpret flags are accepted and
    change nothing."""
    _, _, port = problem
    x0 = torch.from_numpy(_starts(2))
    kw = dict(niter_tv=3, block=2, quantiles=(0.5,), burn_in=1)
    a = t_myula.run_myula_tv_fused_packed(port["tv"][0], 0.3, TAU, GAMMA, x0, 3, 4, **kw)
    b = t_myula.run_myula_tv_fused_packed(port["tv"][0], 0.3, TAU, GAMMA, x0, 3, 4,
                                          marker_hbm=True, interpret=True, **kw)
    assert torch.equal(a.final_state.position, b.final_state.position)
    assert torch.equal(a.quantile_state[0], b.quantile_state[0])
    c = t_ulpda.run_ulpda_fused_packed(*port["tv"], interop.gradient_from_numpy(), TAU_PD,
                                       1.0, x0, 3, 4, block=2)
    d = t_ulpda.run_ulpda_fused_packed(*port["tv"], interop.gradient_from_numpy(), TAU_PD,
                                       1.0, x0, 3, 4, block=2, interpret=True)
    assert torch.equal(c.final_state.extras.y, d.final_state.extras.y)


def test_wavelet_dual_chain_axis_refused(problem):
    """A wl1 dual with a chain axis raises, as the JAX package's lane
    packing does; and both packed runners want a chain axis."""
    _, jax_terms, port = problem
    with pytest.raises(ValueError, match="lane packing"):
        j_ulpda.run_ulpda_fused_packed(jax_terms["tv"][0], L1Norm(sigma=0.3),
                                       __import__("lmc_atomi_tpu.ops.wavelet", fromlist=["x"]
                                                  ).HaarDWT2D(levels=2), TAU_PD, 1.0,
                                       jnp.zeros((2, N, N)), jax.random.PRNGKey(0), 4,
                                       noise_scale=0.0, interpret=True)
    x0 = torch.zeros((2, N, N), dtype=torch.float64)
    for run in (lambda: t_ulpda.run_ulpda_fused_packed(port["tv"][0], t_fn.L1Norm(sigma=0.3),
                                                       THaar(levels=2), TAU_PD, 1.0, x0, 0, 4),
                lambda: t_ulpda.run_ulpda_fused(port["tv"][0], t_fn.L1Norm(sigma=0.3),
                                                THaar(levels=2), TAU_PD, 1.0,
                                                torch.zeros((N, 2 * N), dtype=torch.float64),
                                                0, 4, chain_nx=N)):
        with pytest.raises(ValueError, match="lane packing"):
            run()
    with pytest.raises(ValueError, match="n_chains, ny, nx"):
        t_myula.run_myula_tv_fused_packed(port["tv"][0], 0.3, TAU, GAMMA, x0[0], 0, 4)
    with pytest.raises(ValueError, match="n_chains, ny, nx"):
        t_ulpda.run_ulpda_fused_packed(*port["tv"], interop.gradient_from_numpy(), TAU_PD,
                                       1.0, x0[0], 0, 4)


# --- the packed plain versions with noise on: chain c is its solo run -----------

@pytest.mark.parametrize("mode", ["tv", "mctv", "metv"])
def test_myula_packed_chains_equal_solo_runs(problem, mode):
    """Noise on, in f32 as on the card: chain ``c`` of the packed runner
    (FGP warm, CI markers at thin 2) is ``run_myula_tv_fused`` of its start
    under ``chain_keys(key, C)[c]``, bit for bit."""
    _, _, port = problem
    x0 = torch.from_numpy(_starts(3)).float()
    kw = dict(niter_tv=4, tv_solver="fgp", tv_warm=True, block=4, burn_in=2,
              quantiles=(0.025, 0.975), quantile_thin=2)
    l2 = port[mode][0]
    got = t_myula.run_myula_tv_fused_packed(l2, 0.3, TAU, GAMMA, x0, (6, 2), 8, **kw)
    for c, key in enumerate(chain_keys((6, 2), 3)):
        one = t_myula.run_myula_tv_fused(l2, 0.3, TAU, GAMMA, x0[c], key, 8, **kw)
        assert torch.equal(got.final_state.position[c], one.final_state.position)
        assert torch.equal(got.moments.m2[c], one.moments.m2)
        for a, b in zip(got.quantile_state, one.quantile_state):
            assert torch.equal(a[c], b)


@pytest.mark.parametrize("mode", ["tv", "mctv", "metv"])
@pytest.mark.parametrize("gfirst", [False, True])
def test_ulpda_packed_chains_equal_solo_runs(problem, mode, gfirst):
    """Noise on: chain ``c`` of the packed ULPDA runner is
    ``run_ulpda_fused`` under its chain key, the dual and xbar too."""
    _, _, port = problem
    x0 = torch.from_numpy(_starts(3))
    kw = dict(block=3, burn_in=2, gfirst=gfirst, env_warm=True)
    tg = interop.gradient_from_numpy()
    got = t_ulpda.run_ulpda_fused_packed(*port[mode], tg, TAU_PD, 1.0, x0, 5, 6, **kw)
    for c, key in enumerate(chain_keys(5, 3)):
        one = t_ulpda.run_ulpda_fused(*port[mode], tg, TAU_PD, 1.0, x0[c], key, 6, **kw)
        assert torch.equal(got.final_state.position[c], one.final_state.position)
        assert torch.equal(got.final_state.extras.y[:, c], one.final_state.extras.y)
        assert torch.equal(got.final_state.extras.xbar[c], one.final_state.extras.xbar)
        assert torch.equal(got.moments.mean[c], one.moments.mean)


def test_cuda_wrappers_refuse_cpu_chain_axis(problem):
    """Kernels 2 and 3's CUDA wrappers raise on CPU tensors with a chain
    axis (the plain versions take them), counting no launch."""
    _, _, port = problem
    x = torch.zeros((2, N, N), dtype=torch.float32)
    keys = chain_keys(0, 2)
    taps, (oy, ox), atbs = t_myula._fused_params(port["tv"][0])
    k2, k3 = t_myula.myula_tv_block_update_cuda, t_ulpda.ulpda_block_update_cuda
    before = (k2.launches, dict(k2.routes), k3.launches, dict(k3.routes))
    with pytest.raises(ValueError, match="CUDA tensors"):
        k2(x, atbs.float(), x, x, keys, (TAU, GAMMA, 0.3 * GAMMA, 1.0, SIGMA), (0, 0, 0),
           taps=taps, oy=oy, ox=ox, n_steps=2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        k3(x, x, x, x, atbs.float(), x, x, keys, (TAU_PD, 1.0, 1.0, 1.0, SIGMA, 0.3),
           (0, 0, 0), taps=taps, oy=oy, ox=ox, n_steps=2)
    assert (k2.launches, k2.routes, k3.launches, k3.routes) == before


# --- the chain farm ------------------------------------------------------------

FARM = {  # farm: (data term, options[, runner, when it is not the farm's name])
    "tv": ("tv", dict(quantiles=(0.1, 0.9))),
    "wavelet": ("mask", dict(quantiles=(0.1, 0.9), levels=2)),
    "wavelet_d4": ("mask", dict(quantiles=(0.1, 0.9), levels=2, taps=4), "wavelet"),
    "tiled": ("tv", dict(quantiles=(0.1, 0.9), band=8, halo=8, niter_tv=3)),
    "ulpda_tiled": ("tv", dict(quantiles=(0.1, 0.9), band=8, halo=8, niter_solve=1)),
}


def _mask_problem():
    """The 32^2 inpainting posterior's mask and observation (numpy)."""
    rng = np.random.default_rng(1)
    img = phantom(N, np.float64) / 255.0
    mask = (rng.uniform(size=(N, N)) > 0.5).astype(np.float64)
    return mask, mask * img + 0.1 * mask * rng.normal(size=(N, N))


def _farm_args(problem, name):
    _, _, port = problem
    data, opts, *runner = FARM[name]
    runner = runner[0] if runner else name
    if data == "mask":
        mask, b = _mask_problem()
        l2, lam, gamma = interop.mask_l2_from_numpy(mask, b, 1 / 0.1**2), 5.0, 0.1**2
        tau = 0.2 * gamma
    else:
        l2, lam, gamma, tau = port["tv"][0], 0.3, GAMMA, TAU
        if runner == "ulpda_tiled":
            tau, gamma = TAU_PD, 1.0
    x0 = torch.stack([l2.b, l2.b * 0.5, l2.b + 1.0])
    return (l2, lam, tau, gamma, x0, (4, 1)), dict(runner=runner, burn_in=3, **opts)


@pytest.mark.parametrize("runner", sorted(FARM))
def test_farm_restart_equals_straight_and_chains_their_solo_runs(problem, tmp_path, runner):
    """Noise on: 3 chains, 8 steps in segments of 4. The farm stopped after
    a segment and restarted from its checkpoint equals the straight run bit
    for bit (positions, per-chain moments, markers, ULPDA state), and each
    chain equals ``run_resumable_fused`` of its start under its chain key."""
    args, kw = _farm_args(problem, runner)
    straight = t_longrun.run_resumable_fused(*args, 8, 4, **kw)
    ckpt = str(tmp_path / "farm.ckpt")
    t_longrun.run_resumable_fused(*args, 4, 4, ckpt_path=ckpt, **kw)
    resumed = t_longrun.run_resumable_fused(*args, 8, 4, ckpt_path=ckpt, **kw)
    assert resumed["done"] == 8
    for a, b in ((resumed["position"], straight["position"]),
                 (resumed["moments"].mean, straight["moments"].mean),
                 (resumed["quantile_state"][0], straight["quantile_state"][0])):
        assert torch.equal(a, b)
    x0 = args[4]
    for c, key in enumerate(chain_keys(args[5], 3)):
        one = t_longrun.run_resumable_fused(*args[:4], x0[c], key, 8, 4, **kw)
        assert torch.equal(one["position"], resumed["position"][c])
        assert one["moments"].count == int(resumed["moments"].count[c]) == 5
        assert torch.equal(one["moments"].mean, resumed["moments"].mean[c])
        assert torch.equal(one["moments"].m2, resumed["moments"].m2[c])
        assert torch.equal(one["quantiles"][0.9], resumed["quantiles"][0.9][c])
        if runner == "ulpda_tiled":
            for a, b in zip(one["ulpda_extras"], resumed["ulpda_extras"]):
                assert torch.equal(a, b[c])


def test_tv_farm_matches_jax(problem):
    """Noise off, f64: the ``"tv"`` farm of 2 chains, 8 steps in segments of
    4 with CI markers, against the JAX package's farm (vmapped fused
    chains)."""
    _, jax_terms, port = problem
    x0 = _starts(2)
    kw = dict(burn_in=3, quantiles=(0.025, 0.975), noise_scale=0.0, niter_tv=5)
    want = j_longrun.run_resumable_fused(jax_terms["tv"][0], 0.3, TAU, GAMMA,
                                         jnp.asarray(x0), jax.random.PRNGKey(0), 8, 4,
                                         interpret=True, **kw)
    got = t_longrun.run_resumable_fused(port["tv"][0], 0.3, TAU, GAMMA, torch.from_numpy(x0),
                                        0, 8, 4, **kw)
    _close(got["position"], want["position"], name="x")
    _close(got["moments"].mean, want["moments"].mean, name="mean")
    _close(got["moments"].m2, want["moments"].m2, tol=TOL * 10, name="m2")
    np.testing.assert_array_equal(_np(got["moments"].count), np.asarray(want["moments"].count))
    for p in (0.025, 0.975):
        _close(got["quantiles"][p], want["quantiles"][p], name=f"q{p}")


# the farms whose kernels took a chain axis: (position, dual) tolerances,
# relative to max(1, |want|). The wavelet and MYULA tiled chains take the
# JAX package's operations in its order (TOL, m2 10 TOL, as the "tv" farm;
# measured: at most 1.0e-15 of the scale, m2 8.7e-15). The noise-free ULPDA
# trajectories part through roundoff: the JAX tiled kernel extrapolates as
# (1 + theta) x - theta x_old, the port as kernel 3's x + theta (x - x_old),
# and the primal-dual recursion amplifies the last-bit difference
# (ROADMAP.md queue C). Over these 8 steps x, the moments and the markers
# part by at most 1.7e-14 of their scale (TOL holds them), the dual (|y| <=
# 0.3) by 2.6e-13: gated at 1e-12
FARM_JAX_TOL = {"wavelet": (TOL, None), "wavelet_d4": (TOL, None), "tiled": (TOL, None),
                "ulpda_tiled": (TOL, 1e-12)}


@pytest.mark.parametrize("name", sorted(FARM_JAX_TOL))
def test_chain_axis_farms_match_jax(problem, name):
    """Noise off, f64: the ``"wavelet"`` (Haar and D4), ``"tiled"`` and
    ``"ulpda_tiled"`` farms of 3 chains, 8 steps in segments of 4 with CI
    markers, one kernel call a block on the chain axis, against the JAX
    package's farm (its runners under ``jax.vmap``, interpret mode)."""
    _, jax_terms, _ = problem
    args, kw = _farm_args(problem, name)
    kw = dict(kw, quantiles=(0.025, 0.975), noise_scale=0.0)
    l2, lam, tau, gamma, x0, _ = args
    if FARM[name][0] == "mask":
        from lmc_atomi_tpu.ops.linops import Mask

        mask, b = _mask_problem()
        jl2 = L2Data.create(op=Mask(mask=jnp.asarray(mask)), b=jnp.asarray(b),
                            sigma=1 / 0.1**2)
    else:
        jl2 = jax_terms["tv"][0]
    want = j_longrun.run_resumable_fused(jl2, lam, tau, gamma, jnp.asarray(_np(x0)),
                                         jax.random.PRNGKey(0), 8, 4, interpret=True, **kw)
    got = t_longrun.run_resumable_fused(*args, 8, 4, **kw)
    tol, y_tol = FARM_JAX_TOL[name]
    _close(got["position"], want["position"], tol, name="x")
    _close(got["moments"].mean, want["moments"].mean, tol, name="mean")
    _close(got["moments"].m2, want["moments"].m2, tol * 10, name="m2")
    np.testing.assert_array_equal(_np(got["moments"].count), np.asarray(want["moments"].count))
    for p in (0.025, 0.975):
        _close(got["quantiles"][p], want["quantiles"][p], tol, name=f"q{p}")
    if y_tol is not None:
        for g, w, field in zip(got["ulpda_extras"], want["ulpda_extras"], ("y", "xprev")):
            _close(g, w, y_tol if field == "y" else tol, name=field)


def test_vmapped_ulpda_wavelet_runner_matches_jax():
    """``jax.vmap(run_ulpda_wavelet_fused)`` at the multi-chip dry run's
    settings (2 levels, blocks of 2, the median's P^2 marker, 2 steps) against
    the port's runner on the chain axis: 3 chains at 32^2, noise off, f64,
    the positions, the median maps, the interleaved dual and xbar."""
    from lmc_atomi_tpu.kernels.wavelet_fused import run_ulpda_wavelet_fused as j_run
    from lmc_atomi_tpu.ops.linops import Mask

    from lmc_atomi_torch.kernels.wavelet_fused import run_ulpda_wavelet_fused as t_run

    mask, b = _mask_problem()
    sigma = 1 / 0.1**2
    jl2 = L2Data.create(op=Mask(mask=jnp.asarray(mask)), b=jnp.asarray(b), sigma=sigma)
    tl2 = interop.mask_l2_from_numpy(mask, b, sigma)
    x0 = np.stack([b, 0.5 * b, b + 1.0])
    kw = dict(levels=2, block=2, noise_scale=0.0, quantiles=(0.5,))
    want = jax.vmap(lambda xi, ki: j_run(jl2, 0.25, 0.95 / sigma, 1.0, xi, ki, 2,
                                         interpret=True, **kw))(
        jnp.asarray(x0), jax.random.split(jax.random.PRNGKey(0), 3))
    got = t_run(tl2, 0.25, 0.95 / sigma, 1.0, torch.from_numpy(x0), 0, 2, **kw)
    _close(got.final_state.position, want.final_state.position, name="x")
    _close(got.quantiles[0.5], want.quantiles[0.5], name="q0.5")
    _close(got.final_state.extras.y, want.final_state.extras.y, name="dual")
    _close(got.final_state.extras.xbar, want.final_state.extras.xbar, name="xbar")
    _close(got.moments.mean, want.moments.mean, name="mean")


# --- pooling and diagnostics -----------------------------------------------------

def test_merge_chain_moments_matches_jax():
    """Per-chain moments with distinct counts pool as the JAX package's
    chain-by-chain Chan combine; one shared count broadcasts."""
    rng = np.random.default_rng(0)
    count, mean, m2 = np.array([5, 9, 2, 7]), rng.normal(size=(4, 6)), rng.uniform(1, 2, (4, 6))
    want = j_merge(JMoments(count=jnp.asarray(count), mean=jnp.asarray(mean),
                            m2=jnp.asarray(m2)))
    got = t_merge(RunningMoments(count=torch.from_numpy(count), mean=torch.from_numpy(mean),
                                 m2=torch.from_numpy(m2)))
    assert got.count == int(want.count) == 23
    _close(got.mean, want.mean, tol=1e-12)
    _close(got.m2, want.m2, tol=1e-12)
    shared = t_merge(RunningMoments(count=5, mean=torch.from_numpy(mean),
                                    m2=torch.from_numpy(m2)))
    assert shared.count == 20


def _ar1(n, phi, rng, d=1):
    x = np.zeros((n, d))
    e = rng.normal(size=(n, d))
    for i in range(1, n):
        x[i] = phi * x[i - 1] + e[i]
    return x


@pytest.mark.parametrize("shape", ["1d", "2d"])
def test_autocorrelation_and_ess_match_jax(shape):
    """The twins of ``tests/test_diagnostics.py``: an AR(1) series' FFT
    autocorrelation (and at lag k ~ phi^k) and Geyer ESS (~ n (1 - phi) /
    (1 + phi)) against the JAX package's, f64."""
    rng = np.random.default_rng(1)
    x = _ar1(20000, 0.6, rng, d=1 if shape == "1d" else 3)
    x = x[:, 0] if shape == "1d" else x
    got = t_diag.autocorrelation(torch.from_numpy(x), max_lag=5)
    want = j_diag.autocorrelation(jnp.asarray(x), max_lag=5)
    _close(got, want, tol=1e-10, name="rho")
    np.testing.assert_allclose(_np(got)[3, 0], 0.6**3, atol=0.03)
    ess = t_diag.effective_sample_size(torch.from_numpy(x))
    _close(ess, j_diag.effective_sample_size(jnp.asarray(x)), tol=1e-10, name="ess")
    want_ess = 20000 * 0.4 / 1.6
    assert np.all(np.abs(_np(ess) - want_ess) / want_ess < 0.15)


def test_split_rhat_matches_jax():
    """Converged chains near 1, chains stuck apart far above it, both as
    the JAX package's."""
    rng = np.random.default_rng(4)
    good = rng.normal(size=(4, 5000, 2))
    bad = good + np.array([0.0, 3.0, -3.0, 6.0])[:, None, None]
    for s in (good, bad):
        _close(t_diag.split_rhat(torch.from_numpy(s)), j_diag.split_rhat(jnp.asarray(s)),
               tol=1e-10)
    assert float(t_diag.split_rhat(torch.from_numpy(good)).max()) < 1.02
    assert float(t_diag.split_rhat(torch.from_numpy(bad)).min()) > 1.5


def test_rhat_from_moments_matches_jax_and_the_formula():
    """The twin of ``tests/test_experiments.py::
    test_rhat_from_moments_matches_direct_formula``, per-chain and shared
    counts."""
    rng = np.random.default_rng(0)
    c, t, d = 4, 50, 6
    samples = rng.normal(size=(c, t, d))
    mean, m2 = samples.mean(axis=1), samples.var(axis=1, ddof=1) * (t - 1)
    got = t_diag.rhat_from_moments(RunningMoments(
        count=torch.full((c,), t), mean=torch.from_numpy(mean), m2=torch.from_numpy(m2)))
    want = j_diag.rhat_from_moments(JMoments(count=jnp.full((c,), t, jnp.int32),
                                             mean=jnp.asarray(mean), m2=jnp.asarray(m2)))
    _close(got, want, tol=1e-10)
    w = samples.var(axis=1, ddof=1).mean(axis=0)
    b = t * samples.mean(axis=1).var(axis=0, ddof=1)
    # the JAX package takes the counts in float32: (n - 1) / n rounds there
    np.testing.assert_allclose(_np(got), np.sqrt(((t - 1) / t * w + b / t) / w), rtol=1e-6)
    shared = t_diag.rhat_from_moments(RunningMoments(count=t, mean=torch.from_numpy(mean),
                                                     m2=torch.from_numpy(m2)))
    assert torch.equal(shared, got)


# --- multichain_deblur ----------------------------------------------------------

def test_multichain_deblur_matches_jax(monkeypatch, capsys):
    """At 32^2, 4 chains, 40 steps on the CPU (noise off: identical chains):
    R-hat at most 1 + 1e-5, the pooled mean above the observation's PSNR,
    the report's keys, and the pooled mean against the JAX package's on
    its observation, to f32 roundoff (1e-4 of the image's range: both
    run 40 f32 steps with 10 TV trips each)."""
    kw = dict(size=32, n_chains=4, n_steps=40, burn_in=10)
    jpooled, jrhat, jrep = j_multichain.multichain_deblur(make_plots=False, **kw)
    size = kw["size"]
    jimg = jnp.asarray(phantom(size), jnp.float32)
    jblur = CirculantBlur2D.from_kernel((size, size), uniform_kernel(5, jnp.float32))
    jy = jax.jit(lambda im, k: jblur.matvec(im) + SIG * jax.random.normal(
        k, (size, size), jnp.float32))(jimg, jax.random.PRNGKey(0))
    monkeypatch.setattr(t_multichain, "_observation",
                        lambda img, blur, sigma, seed: torch.from_numpy(np.array(jy)))
    pooled, rhat, rep = t_multichain.multichain_deblur(device="cpu", **kw)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == rep and set(rep) == set(jrep)
    assert rep["pack"] == 4 and rep["psnr_pooled_mean"] > rep["psnr_observed"]
    assert rep["rhat_max"] <= 1.0 + 1e-5 and torch.isfinite(rhat).all()
    assert abs(rep["psnr_observed"] - jrep["psnr_observed"]) < 1e-4
    _close(pooled.mean, jpooled.mean, tol=1e-4, name="pooled mean")
    assert pooled.count == int(jpooled.count) == 4 * 30


def test_multichain_cli_and_guards(capsys, tmp_path):
    """The CLI on the CPU (ULPDA, 2 kernel calls of 2 chains), its figure
    under the JAX package's name, and the kernel and device guards."""
    auto_cli(t_multichain.multichain_deblur,
             ["--size", "16", "--n_chains", "4", "--pack", "2", "--n_steps", "8",
              "--burn_in", "2", "--kernel", "ulpda", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["kernel"] == "ulpda" and rep["pack"] == 2 and rep["n_chains"] == 4
    t_multichain.multichain_deblur(size=16, n_chains=2, n_steps=4, burn_in=1, make_plots=True,
                                   outdir=str(tmp_path), device="cpu")
    assert (tmp_path / "fig_multichain_16_2ch.pdf").stat().st_size > 0
    with pytest.raises(ValueError, match="unknown kernel"):
        t_multichain.multichain_deblur(size=16, kernel="mala", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_multichain.multichain_deblur(size=16)


# --- JAX multi-chain state continued in the port --------------------------------

def test_jax_packed_result_continues_in_port(problem):
    """6 packed steps in JAX (CI markers; ULPDA's dual and xbar), carried
    with ``packed_state_from_numpy``, 6 more in the port: equal to the JAX
    package's own 12-step run, noise off, f64."""
    _, jax_terms, port = problem
    x0 = _starts(2)
    kw = dict(niter_tv=5, block=3, noise_scale=0.0, burn_in=2, quantiles=(0.25, 0.75))
    jl2 = jax_terms["tv"][0]
    first = j_myula.run_myula_tv_fused_packed(jl2, 0.3, TAU, GAMMA, jnp.asarray(x0),
                                              jax.random.PRNGKey(0), 6, interpret=True, **kw)
    whole = j_myula.run_myula_tv_fused_packed(jl2, 0.3, TAU, GAMMA, jnp.asarray(x0),
                                              jax.random.PRNGKey(0), 12, interpret=True, **kw)
    carried = interop.packed_state_from_numpy(
        np.asarray(first.final_state.position), np.asarray(first.moments.mean),
        np.asarray(first.moments.m2), int(first.moments.count),
        *(np.asarray(q) for q in first.quantile_state))
    assert carried.quantile_state[0].shape == (2, 10, N, N)
    more = t_myula.run_myula_tv_fused_packed(port["tv"][0], 0.3, TAU, GAMMA,
                                             carried.final_state.position, 3, 6,
                                             quantile_state=carried.quantile_state,
                                             step_offset=6, **kw)
    _close(more.final_state.position, whole.final_state.position, name="x")
    _close(t_myula.pack_lanes(more.quantile_state[0]), whole.quantile_state[0], name="qh")
    merged = [RunningMoments(carried.moments.count, carried.moments.mean[c],
                             carried.moments.m2[c]).merge(
        RunningMoments(more.moments.count, more.moments.mean[c], more.moments.m2[c]))
        for c in range(2)]
    for c, m in enumerate(merged):
        assert m.count == int(whole.moments.count) == 10
        _close(m.mean, np.asarray(whole.moments.mean)[c], tol=1e-8, name="mean")

    ju = j_ulpda.run_ulpda_fused_packed(*jax_terms["tv"], Gradient2D(), TAU_PD, 1.0,
                                        jnp.asarray(x0), jax.random.PRNGKey(0), 4, block=2,
                                        noise_scale=0.0, interpret=True)
    ju8 = j_ulpda.run_ulpda_fused_packed(*jax_terms["tv"], Gradient2D(), TAU_PD, 1.0,
                                         jnp.asarray(x0), jax.random.PRNGKey(0), 8, block=2,
                                         noise_scale=0.0, interpret=True)
    st = ju.final_state
    cu = interop.packed_state_from_numpy(np.asarray(st.position), np.asarray(ju.moments.mean),
                                         np.asarray(ju.moments.m2), int(ju.moments.count),
                                         y=np.asarray(st.extras.y), xbar=np.asarray(st.extras.xbar))
    mu = t_ulpda.run_ulpda_fused_packed(*port["tv"], interop.gradient_from_numpy(), TAU_PD,
                                        1.0, cu.final_state.position, 3, 4, block=2,
                                        noise_scale=0.0, y0=cu.final_state.extras.y,
                                        xbar0=cu.final_state.extras.xbar, step_offset=4)
    _close(mu.final_state.position, ju8.final_state.position, name="ulpda x")
    _close(mu.final_state.extras.y, ju8.final_state.extras.y, name="ulpda y")


def test_jax_farm_bundle_continues_in_port(problem, tmp_path):
    """A JAX ``"tv"`` farm of 2 chains stopped at 4 steps, carried with
    ``farm_bundle_from_numpy`` into a port checkpoint and run to 8 steps by
    the port's ``run_resumable_fused``: the JAX package's straight 8-step
    farm, noise off, f64."""
    _, jax_terms, port = problem
    x0 = _starts(2)
    kw = dict(burn_in=1, quantiles=(0.5,), noise_scale=0.0, niter_tv=4)
    args = (jax_terms["tv"][0], 0.3, TAU, GAMMA, jnp.asarray(x0), jax.random.PRNGKey(0))
    first = j_longrun.run_resumable_fused(*args, 4, 4, interpret=True, **kw)
    whole = j_longrun.run_resumable_fused(*args, 8, 4, interpret=True, **kw)
    m = first["moments"]
    bundle = interop.farm_bundle_from_numpy(
        np.asarray(first["position"]), np.asarray(m.count), np.asarray(m.mean),
        np.asarray(m.m2), int(first["done"]), (0, 0),
        *(np.asarray(q) for q in first["quantile_state"]))
    ckpt = str(tmp_path / "farm.ckpt")
    save_checkpoint(ckpt, bundle)
    got = t_longrun.run_resumable_fused(port["tv"][0], 0.3, TAU, GAMMA, torch.from_numpy(x0),
                                        (0, 0), 8, 4, ckpt_path=ckpt, **kw)
    assert got["done"] == 8
    _close(got["position"], whole["position"], name="x")
    _close(got["moments"].mean, whole["moments"].mean, tol=1e-8, name="mean")
    np.testing.assert_array_equal(_np(got["moments"].count), np.asarray(whole["moments"].count))
    _close(got["quantiles"][0.5], whole["quantiles"][0.5], name="median")
