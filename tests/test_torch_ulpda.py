"""Port parity for the ULPDA sampler and the fused blocks of the
deconvolution slice, on the CPU: the unfused ``ulpda`` against the JAX
package's (noise off, f64), kernel 3's plain version ``ulpda_block_update_ref``
and kernel 2's MC-TV/ME-TV modes against the JAX Pallas kernels in interpret
mode (f64, noise off), the fused ULPDA chain against the port's unfused one on
the same Philox stream, and a JAX chain continued in the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.kernels import imaging as t_imaging
from lmc_atomi_torch.kernels import myula_fused as t_myula
from lmc_atomi_torch.kernels import ulpda_fused as t_ulpda
from lmc_atomi_torch.ops import functionals as t_fn
from lmc_atomi_torch.run.runner import run_chain as t_run_chain
from lmc_atomi_tpu.kernels import imaging as j_imaging
from lmc_atomi_tpu.kernels import myula_fused as j_myula
from lmc_atomi_tpu.kernels import ulpda_fused as j_ulpda
from lmc_atomi_tpu.ops.functionals import L1Norm, L21Norm, L2Data
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, Gradient2D, uniform_kernel
from lmc_atomi_tpu.ops.ncvx_tv import L2NcvxTV
from lmc_atomi_tpu.utils.images import phantom

torch.set_num_threads(2)

N = 32
SIG = 0.75
SIGMA = 1 / SIG**2
TAU = 0.95 / SIGMA
MU = 1.0
# f64 on both sides; the recursions differ only in summation order (FFT
# against separable taps, roll orders), ~1e-13 relative after a few steps
TOL = 1e-9


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=name)


@pytest.fixture(scope="module")
def problem():
    """The deconvolution problem at 32^2 in f64, built in JAX and carried to
    the port: the three model types of the workload (k5)."""
    img = phantom(N, np.float64)
    jb = CirculantBlur2D.from_kernel((N, N), uniform_kernel(5, jnp.float64))
    y = np.asarray(jb.matvec(jnp.asarray(img))) \
        + SIG * np.random.default_rng(0).normal(size=(N, N))
    tb = interop.blur_from_numpy(np.asarray(jb.eigs_re), np.asarray(jb.eigs_im),
                                 np.asarray(jb.h), np.asarray(jb.hh), jb.offset)
    tgrad = interop.gradient_from_numpy()
    nc = dict(sigma=SIGMA, lamda=0.3, gamma=15.0, isotropic=True, niter_inner=10)
    jy = jnp.asarray(y)
    jax_terms = {
        "tv": (L2Data.create(op=jb, b=jy, sigma=SIGMA), L21Norm(sigma=0.3)),
        "mctv": (L2NcvxTV(op=jb, b=jy, op2=Gradient2D(), **nc), L1Norm(sigma=0.3)),
        "metv": (L2NcvxTV(op=jb, b=jy, op2=None, **nc), L21Norm(sigma=0.3)),
    }
    port_terms = {
        "tv": (interop.l2data_from_numpy(y, SIGMA, tb), t_fn.L21Norm(sigma=0.3)),
        "mctv": (interop.l2ncvx_from_numpy(y, tb, op2=tgrad, **nc),
                 t_fn.L1Norm(sigma=0.3)),
        "metv": (interop.l2ncvx_from_numpy(y, tb, op2=None, **nc),
                 t_fn.L21Norm(sigma=0.3)),
    }
    return y, jax_terms, port_terms, tgrad


@pytest.mark.parametrize("gfirst", [False, True])
@pytest.mark.parametrize("which", ["tv", "mctv", "metv"])
def test_ulpda_matches_jax(problem, which, gfirst):
    """4 unfused steps from the observation, noise off: x, the dual and
    xbar."""
    y, jax_terms, port_terms, tgrad = problem
    jk = j_imaging.ulpda(*jax_terms[which], Gradient2D(), tau=TAU, mu=MU,
                         gfirst=gfirst, noise_scale=0.0)
    st = jk.init(jnp.asarray(y))
    for i in range(4):
        st, _ = jk.step(st, jax.random.PRNGKey(i))
    tk = t_imaging.ulpda(*port_terms[which], tgrad, tau=TAU, mu=MU,
                         gfirst=gfirst, noise_scale=0.0)
    res = t_run_chain(tk, torch.from_numpy(y), 0, 4, collect="last")
    _close(res.final_state.position, st.position, name="x")
    _close(res.final_state.extras.y, st.extras.y, name="y")
    _close(res.final_state.extras.xbar, st.extras.xbar, name="xbar")
    assert res.final_state.step == 4


def _block_inputs(rng):
    x, xbar, mean = rng.normal(size=(3, N, N)) * 20 + 100
    py, px = rng.normal(size=(2, N, N)) * 0.2
    m2 = rng.uniform(1, 5, size=(N, N)) * 30
    return x, py, px, xbar, mean, m2


# (mode, gfirst, tv_solver, env_warm): every mode in both orders, and the
# envelope prox with both solvers, cold and warm
BLOCK_CASES = [
    ("tv", False, "chambolle", False), ("tv", True, "chambolle", False),
    ("mctv", False, "chambolle", False), ("mctv", True, "chambolle", False),
    ("metv", False, "chambolle", False), ("metv", True, "fgp", True),
    ("metv", False, "fgp", False), ("metv", True, "chambolle", True),
]


@pytest.mark.parametrize("mode,gfirst,solver,warm", BLOCK_CASES)
def test_ulpda_block_update_ref_matches_jax(problem, mode, gfirst, solver, warm):
    """One block call of 3 steps from a mid-chain state (step0, burn-in and
    count past the start), noise off: every output field."""
    _, jax_terms, _, _ = problem
    proxf, proxg = jax_terms[mode]
    (taps, (oy, ox), atb, jmode, lamda, gamma_mc, niter_inner, dual, lam,
     _) = j_ulpda._ulpda_setup(proxf, proxg, Gradient2D(), TAU, MU)
    assert jmode == mode
    fields = _block_inputs(np.random.default_rng(1))
    scal_f = (TAU, MU, 1.0, 0.0, SIGMA, 0.3, lamda, gamma_mc)
    scal_i = (7, 8, 2)
    kw = dict(taps=taps, oy=oy, ox=ox, lam=lam, n_steps=3, niter_solve=3,
              gfirst=gfirst, dual=dual, mode=mode, niter_inner=4,
              with_noise=False, tv_solver=solver, env_warm=warm)
    x, py, px, xbar, mean, m2 = fields
    want = j_ulpda.ulpda_block_update(
        *(jnp.asarray(a) for a in (x, py, px, xbar, atb, mean, m2)),
        jnp.asarray([3, 4], jnp.int32), jnp.asarray(scal_f, jnp.float64),
        jnp.asarray(scal_i, jnp.int32), interpret=True, **kw)
    t = torch.from_numpy
    got = t_ulpda.ulpda_block_update(
        t(x), t(py), t(px), t(xbar), t(np.array(atb)), t(mean), t(m2), (3, 4),
        scal_f, scal_i, **kw)
    for name, g, w in zip(("x", "py", "px", "xbar", "mean", "m2"), got, want):
        _close(g, w, name=name)


@pytest.mark.parametrize("mode,solver,warm", [
    ("mctv", "chambolle", False), ("mctv", "fgp", True),
    ("metv", "chambolle", False), ("metv", "fgp", True),
])
def test_myula_block_modes_match_jax(problem, mode, solver, warm):
    """Kernel 2's MC-TV/ME-TV modes (plain version) against the JAX block in
    interpret mode, 4 steps, noise off, with the warm TV and envelope duals."""
    _, jax_terms, _, _ = problem
    proxf = jax_terms[mode][0]
    gamma = SIG**2
    tau = 0.2 * gamma
    taps, (oy, ox), atbs = j_myula._fused_params(proxf, 0.3, tau, gamma, 10)
    jmode, lamda, gamma_mc, niter_inner = j_myula._fused_mode(proxf)
    assert jmode == mode
    x, _, _, _, mean, m2 = _block_inputs(np.random.default_rng(2))
    scal_f = (tau, gamma, 0.3 * gamma, 0.0, SIGMA, lamda, gamma_mc)
    scal_i = (5, 2, 3)
    niter = 8 if solver == "fgp" else 10
    kw = dict(taps=taps, oy=oy, ox=ox, n_steps=4, niter_tv=niter,
              with_noise=False, tv_warm=warm, tv_solver=solver, mode=mode,
              niter_inner=6)
    want = j_myula.myula_tv_block_update(
        *(jnp.asarray(a) for a in (x, atbs, mean, m2)),
        jnp.asarray([3, 4], jnp.int32), jnp.asarray(scal_f, jnp.float64),
        jnp.asarray(scal_i, jnp.int32), interpret=True, **kw)
    t = torch.from_numpy
    got = t_myula.myula_tv_block_update(
        t(x), t(np.array(atbs)), t(mean), t(m2), (3, 4), scal_f, scal_i, **kw)
    for name, g, w in zip(("x", "mean", "m2"), got[:3], want[:3]):
        _close(g, w, name=name)


@pytest.mark.parametrize("which,gfirst", [("tv", False), ("mctv", False),
                                          ("metv", False), ("metv", True)])
def test_fused_chain_equals_unfused_with_noise(problem, which, gfirst):
    """Same seed and chain, same Philox stream: ``run_ulpda_fused`` with 30
    Chebyshev sweeps (converged to f64 roundoff) against
    ``run_chain(ulpda)`` with the exact spectral solve: final state, dual,
    xbar, Welford moments after burn-in. The one-step wrapper
    ``ulpda_sep_fused`` drives ``run_chain`` to the same chain."""
    y, _, port_terms, tgrad = problem
    proxf, proxg = port_terms[which]
    x0 = torch.from_numpy(y)
    unf = t_run_chain(t_imaging.ulpda(proxf, proxg, tgrad, tau=TAU, mu=MU,
                                      gfirst=gfirst),
                      x0, (5, 2), 12, collect="stats", burn_in=3)
    fus = t_ulpda.run_ulpda_fused(proxf, proxg, tgrad, TAU, MU, x0, (5, 2), 12,
                                  gfirst=gfirst, niter_solve=30, burn_in=3,
                                  block=4)
    one = t_run_chain(t_ulpda.ulpda_sep_fused(proxf, proxg, tgrad, TAU, MU,
                                              gfirst=gfirst, niter_solve=30),
                      x0, (5, 2), 12, collect="last")
    tol = 1e-8  # Chebyshev-30 against the spectral solve, then 12 steps
    for got in (fus.final_state, one.final_state):
        _close(got.position, _np(unf.final_state.position), tol, "x")
        _close(got.extras.y, _np(unf.final_state.extras.y), tol, "y")
        _close(got.extras.xbar, _np(unf.final_state.extras.xbar), tol, "xbar")
    assert fus.moments.count == unf.moments.count == 9
    _close(fus.moments.mean, _np(unf.moments.mean), tol, "mean")
    _close(fus.moments.m2, _np(unf.moments.m2), tol, "m2")


def test_jax_chain_continues_in_port(problem):
    """3 fused steps in JAX, carried across with ``ulpda_state_from_numpy``,
    then 3 more in the port: equal to the JAX package's 6-step run, and the
    merged moments equal its 6-step moments (noise off)."""
    y, jax_terms, port_terms, tgrad = problem
    kw = dict(block=3, noise_scale=0.0, burn_in=1)
    args = (*jax_terms["metv"], Gradient2D(), TAU, MU, jnp.asarray(y),
            jax.random.PRNGKey(0))
    first = j_ulpda.run_ulpda_fused(*args, 3, interpret=True, **kw)
    whole = j_ulpda.run_ulpda_fused(*args, 6, interpret=True, **kw)
    st = first.final_state
    carried = interop.ulpda_state_from_numpy(
        np.asarray(st.position), np.asarray(st.extras.y), np.asarray(st.extras.xbar),
        np.asarray(first.moments.mean), np.asarray(first.moments.m2),
        int(first.moments.count))
    cs = carried.final_state
    got = t_ulpda.run_ulpda_fused(*port_terms["metv"], tgrad, TAU, MU, cs.position,
                                  0, 3, y0=cs.extras.y, xbar0=cs.extras.xbar,
                                  step_offset=3, **kw)
    _close(got.final_state.position, whole.final_state.position, name="x")
    _close(got.final_state.extras.y, whole.final_state.extras.y, name="y")
    _close(got.final_state.extras.xbar, whole.final_state.extras.xbar, name="xbar")
    merged = carried.moments.merge(got.moments)
    assert merged.count == int(whole.moments.count) == 5
    _close(merged.mean, whole.moments.mean, name="mean")
    _close(merged.m2, whole.moments.m2, tol=1e-8, name="m2")


def test_fused_gating_and_guards(problem):
    """On CPU tensors the fused path is not taken; the CUDA wrapper raises
    on them without counting a launch; an unknown dual is refused."""
    y, _, port_terms, tgrad = problem
    proxf, proxg = port_terms["tv"]
    x = torch.from_numpy(y).float()
    assert not t_ulpda.ulpda_fused_supported(proxf, proxg, tgrad, x)
    assert not t_myula.sep_fused_supported(proxf.op, x)
    assert not t_ulpda.ulpda_fused_supported(proxf, proxg, proxf.op, x)
    taps = t_myula.separable_gram_taps(proxf.op.hh)
    z = torch.zeros((N, N), dtype=torch.float32)
    before = t_ulpda.ulpda_block_update_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_ulpda.ulpda_block_update_cuda(
            z, z, z, None, z, z, z, 0, (TAU, MU, 1.0, 1.0, SIGMA, 0.3),
            (0, 0, 0), taps=taps, oy=4, ox=4)
    assert t_ulpda.ulpda_block_update_cuda.launches == before
    with pytest.raises(ValueError, match="dual 'l2'"):
        t_ulpda.ulpda_block_update(z, z, z, None, z, z, z, 0,
                                   (TAU, MU, 1.0, 1.0, SIGMA, 0.3), (0, 0, 0),
                                   taps=taps, oy=4, ox=4, dual="l2")
    bad = t_fn.L2Data.create(op=proxf.op, b=proxf.b)
    nonconvex = interop.l2ncvx_from_numpy(y, proxf.op, op2=None, isotropic=False)
    with pytest.raises(ValueError, match="isotropic"):
        t_myula._fused_mode(nonconvex)
    assert t_myula._fused_mode(bad) == ("tv", 0.0, 1.0, 0)
