"""Port parity: the fused MYULA block (kernel 2's plain version
``myula_tv_block_update_ref``) and its host loop ``run_myula_tv_fused``
against the JAX package's Pallas kernel in interpret mode, f64, noise off.
Covers Chambolle and FGP, the warm dual, burn-in, P^2 quantiles with
``quantile_thin``, and a chain started in JAX and continued in the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.kernels import myula_fused as t_fused
from lmc_atomi_tpu.kernels import myula_fused as j_fused
from lmc_atomi_tpu.ops.functionals import L2Data
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, gaussian_kernel, uniform_kernel
from lmc_atomi_tpu.utils.images import phantom

torch.set_num_threads(2)

N = 32
TOL = 1e-9  # f64; the two recursions differ only in summation roundoff
SIG = 0.75
GAMMA = SIG**2
TAU = 0.2 * GAMMA


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def problem():
    img = phantom(N, np.float64)
    h = uniform_kernel(5, jnp.float64)
    jb = CirculantBlur2D.from_kernel((N, N), h)
    noise = np.random.default_rng(0).normal(size=(N, N))
    y = np.asarray(jb.matvec(jnp.asarray(img))) + SIG * noise
    jl2 = L2Data.create(op=jb, b=jnp.asarray(y), sigma=1 / SIG**2)
    tb = interop.blur_from_numpy(
        np.asarray(jb.eigs_re), np.asarray(jb.eigs_im), np.asarray(jb.h),
        np.asarray(jb.hh), jb.offset)
    tl2 = interop.l2data_from_numpy(y, 1 / SIG**2, tb)
    return img, jl2, tl2


@pytest.mark.parametrize("kind", ["uniform", "gaussian", "random3x3"])
def test_separable_gram_taps_match_jax(kind):
    if kind == "uniform":
        h = np.asarray(uniform_kernel(5, jnp.float64))
    elif kind == "gaussian":
        h = np.asarray(gaussian_kernel(7, 1.3, jnp.float64))
    else:
        h = np.random.default_rng(0).uniform(0.1, 1.0, (3, 3))
    jb = CirculantBlur2D.from_kernel((16, 16), jnp.asarray(h))
    want = j_fused.separable_gram_taps(jb.hh)
    got = t_fused.separable_gram_taps(torch.from_numpy(np.array(jb.hh)))
    assert got == want
    rec = sum(np.outer(wy, wx) for wy, wx in got)
    np.testing.assert_allclose(rec, np.asarray(jb.hh), atol=1e-12)


@pytest.mark.parametrize("solver,niter,warm", [("chambolle", 10, False),
                                               ("fgp", 8, True)])
def test_block_update_ref_matches_jax(problem, solver, niter, warm):
    """One block call from a mid-chain state: nonzero moments and markers,
    step0/burn/count0 past the start, P^2 in its steady state."""
    _, jl2, tl2 = problem
    rng = np.random.default_rng(1)
    x, mean = rng.normal(size=(2, N, N)) * 20 + 100
    m2 = rng.uniform(1, 5, size=(N, N)) * 30
    qs = (0.025, 0.975)
    qh = np.sort(rng.normal(size=(5, N, N)) * 10 + 100, axis=0)
    qh = np.concatenate([qh, qh + 1.0])
    qn = np.tile(np.array([3.0, 6.0, 9.0])[:, None, None], (2, N, N))
    taps, (oy, ox), atbs = j_fused._fused_params(jl2, 0.3, TAU, GAMMA, niter)
    scal_f = (TAU, GAMMA, 0.3 * GAMMA, 0.0, 1 / SIG**2)
    scal_i = (12, 5, 7)
    kw = dict(taps=taps, oy=oy, ox=ox, n_steps=5, niter_tv=niter,
              with_noise=False, tv_warm=warm, quantiles=qs, tv_solver=solver)
    want = j_fused.myula_tv_block_update(
        *(jnp.asarray(a) for a in (x, atbs, mean, m2)),
        jnp.asarray([3, 4], jnp.int32),
        jnp.asarray(scal_f + (0.0, 1.0), jnp.float64),
        jnp.asarray(scal_i, jnp.int32), jnp.asarray(qh), jnp.asarray(qn),
        interpret=True, **kw)
    t = torch.from_numpy
    got = t_fused.myula_tv_block_update(
        t(x), t(np.asarray(atbs)), t(mean), t(m2), (3, 4), scal_f, scal_i,
        t(qh), t(qn), **kw)
    for name, g, w in zip(("x", "mean", "m2", "qh", "qn"), got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0,
                                   atol=TOL * max(1.0, np.abs(np.asarray(w)).max()),
                                   err_msg=name)


CHAINS = {
    "cold10_ci": dict(n_steps=12, block=6, burn_in=2, quantiles=(0.025, 0.975)),
    "fgp8": dict(n_steps=12, block=4, niter_tv=8, tv_solver="fgp",
                 quantiles=(0.5,)),
    "warm5": dict(n_steps=12, block=6, niter_tv=5, tv_warm=True),
    "fgp4_warm": dict(n_steps=9, block=3, niter_tv=4, tv_solver="fgp",
                      tv_warm=True, burn_in=4),
    "ci_thin2": dict(n_steps=16, block=8, burn_in=3, quantiles=(0.025, 0.975),
                     quantile_thin=2),
}


def _compare(got, want):
    np.testing.assert_allclose(_np(got.final_state.position),
                               np.asarray(want.final_state.position),
                               rtol=0, atol=TOL * 255)
    assert got.moments.count == int(want.moments.count)
    scale = max(1.0, float(np.abs(np.asarray(want.moments.m2)).max()))
    np.testing.assert_allclose(_np(got.moments.mean), np.asarray(want.moments.mean),
                               rtol=0, atol=TOL * 255)
    np.testing.assert_allclose(_np(got.moments.m2), np.asarray(want.moments.m2),
                               rtol=0, atol=TOL * scale)
    if want.quantile_state is None:
        assert got.quantile_state is None
        return
    for g, w in zip(got.quantile_state, want.quantile_state):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=TOL * 255)
    assert list(got.quantiles) == list(want.quantiles)
    for j, p in enumerate(want.quantiles):
        np.testing.assert_array_equal(_np(got.quantiles[p]),
                                      _np(got.quantile_state[0][5 * j + 2]))


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_run_myula_tv_fused_matches_jax(problem, case):
    _, jl2, tl2 = problem
    kw = dict(CHAINS[case])
    n = kw.pop("n_steps")
    x0 = np.zeros((N, N))
    want = j_fused.run_myula_tv_fused(
        jl2, 0.3, TAU, GAMMA, jnp.asarray(x0), jax.random.PRNGKey(0), n,
        noise_scale=0.0, interpret=True, **kw)
    got = t_fused.run_myula_tv_fused(
        tl2, 0.3, TAU, GAMMA, torch.from_numpy(x0), 0, n, noise_scale=0.0, **kw)
    _compare(got, want)


def test_chain_started_in_jax_continues_in_port(problem):
    """8 steps in JAX, carried across with ``fused_state_from_numpy``, then 8
    more in the port with ``step_offset`` + ``quantile_state``: equal to the
    JAX package's own continuation, and the merged moments equal one 16-step
    run."""
    _, jl2, tl2 = problem
    kw = dict(block=4, burn_in=3, quantiles=(0.025, 0.975), quantile_thin=2,
              noise_scale=0.0)
    first = j_fused.run_myula_tv_fused(
        jl2, 0.3, TAU, GAMMA, jnp.zeros((N, N)), jax.random.PRNGKey(0), 8,
        interpret=True, **kw)
    carried = interop.fused_state_from_numpy(
        np.asarray(first.final_state.position), np.asarray(first.moments.mean),
        np.asarray(first.moments.m2), int(first.moments.count),
        *(np.asarray(a) for a in first.quantile_state))
    want = j_fused.run_myula_tv_fused(
        jl2, 0.3, TAU, GAMMA, first.final_state.position, jax.random.PRNGKey(0),
        8, quantile_state=first.quantile_state, step_offset=8, interpret=True,
        **kw)
    got = t_fused.run_myula_tv_fused(
        tl2, 0.3, TAU, GAMMA, carried.final_state.position, 0, 8,
        quantile_state=carried.quantile_state, step_offset=8, **kw)
    _compare(got, want)
    whole = t_fused.run_myula_tv_fused(
        tl2, 0.3, TAU, GAMMA, torch.zeros((N, N), dtype=torch.float64), 0, 16,
        **kw)
    merged = carried.moments.merge(got.moments)
    assert merged.count == whole.moments.count == 13
    np.testing.assert_allclose(_np(merged.mean), _np(whole.moments.mean), atol=1e-10)
    np.testing.assert_allclose(_np(merged.variance), _np(whole.moments.variance),
                               rtol=1e-9, atol=1e-9)
    for a, b in zip(got.quantile_state, whole.quantile_state):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-10)


def test_fused_options_validated(problem):
    _, _, tl2 = problem
    x0 = torch.zeros((N, N), dtype=torch.float64)
    with pytest.raises(ValueError, match="quantile group"):
        t_fused.run_myula_tv_fused(tl2, 0.3, TAU, GAMMA, x0, 0, 9,
                                   quantiles=(0.5,), quantile_thin=2)
    with pytest.raises(ValueError, match="step_offset"):
        t_fused.run_myula_tv_fused(tl2, 0.3, TAU, GAMMA, x0, 0, 8,
                                   quantiles=(0.5,), quantile_thin=2,
                                   step_offset=3, noise_scale=0.0)
    with pytest.raises(ValueError, match="tv_solver"):
        t_fused.run_myula_tv_fused(tl2, 0.3, TAU, GAMMA, x0, 0, 2,
                                   tv_solver="admm")

    # the nonconvex data terms the kernel does not take
    b = np.asarray(tl2.b)
    aniso = interop.l2ncvx_from_numpy(b, tl2.op, op2=None, isotropic=False)
    with pytest.raises(ValueError, match="isotropic"):
        t_fused.run_myula_tv_fused(aniso, 0.3, TAU, GAMMA, x0, 0, 2)
    with_q = interop.l2ncvx_from_numpy(b, tl2.op, op2=None, isotropic=True, q=b)
    with pytest.raises(ValueError, match="q term"):
        t_fused.run_myula_tv_fused(with_q, 0.3, TAU, GAMMA, x0, 0, 2)


def test_block_update_cuda_raises_on_cpu_tensors(problem):
    _, jl2, _ = problem
    taps, (oy, ox), _ = j_fused._fused_params(jl2, 0.3, TAU, GAMMA, 10)
    z = torch.zeros((N, N), dtype=torch.float32)
    before = t_fused.myula_tv_block_update_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_fused.myula_tv_block_update_cuda(
            z, z, z, z, 0, (TAU, GAMMA, 0.3 * GAMMA, 1.0, 1.0), (0, 0, 0),
            taps=taps, oy=oy, ox=ox)
    assert t_fused.myula_tv_block_update_cuda.launches == before
