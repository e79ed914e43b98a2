"""Faults C3 and C4 of the port, repaired, held to the JAX package on the
CPU in f64 with the noise off.

C3: ``kernels/base.py::stepsize_at`` returned a numpy step-size schedule
whole; the JAX package's indexes it (``jnp.asarray``), so a numpy tau or mu
schedule (the reference's per-iteration arrays) now drives ``ulpda`` as in
JAX. C4: ``run/runner.py::run_chain`` had no ``collect_extras`` (ULPDA's dual
samples, the reference's ``returny``) and no ``unroll``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.kernels import imaging as t_imaging
from lmc_atomi_torch.kernels.base import stepsize_at as t_stepsize_at
from lmc_atomi_torch.ops import functionals as t_fn
from lmc_atomi_torch.run.runner import run_chain as t_run_chain
from lmc_atomi_tpu.kernels import imaging as j_imaging
from lmc_atomi_tpu.kernels.base import stepsize_at as j_stepsize_at
from lmc_atomi_tpu.ops.functionals import L21Norm, L2Data
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, Gradient2D, uniform_kernel
from lmc_atomi_tpu.run.runner import run_chain as j_run_chain
from lmc_atomi_tpu.utils.images import phantom

torch.set_num_threads(2)

N = 16
# f64 on both sides; the recursions differ in summation order only
TOL = 1e-9


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=name)


@pytest.mark.parametrize("spec", ["0d", "1d", "scalar", "list", "tensor"])
@pytest.mark.parametrize("step", [0, 2])
def test_stepsize_at_matches_jax(spec, step):
    """0-d and 1-d numpy arrays (and numpy scalars) resolve as
    ``jnp.asarray`` resolves them: the value itself, or the ``step``-th."""
    sched = np.array([0.1, 0.2, 0.3])
    given = {"0d": np.array(0.25), "1d": sched, "scalar": np.float64(0.25),
             "list": [0.1, 0.2, 0.3], "tensor": torch.from_numpy(sched)}[spec]
    want = float(j_stepsize_at(np.asarray(given) if spec == "tensor" else given, step))
    got = t_stepsize_at(given, step)
    assert float(got) == want


@pytest.fixture(scope="module")
def problem():
    img = phantom(N, np.float64)
    jb = CirculantBlur2D.from_kernel((N, N), uniform_kernel(3, jnp.float64))
    y = np.asarray(jb.matvec(jnp.asarray(img)))
    tb = interop.blur_from_numpy(np.asarray(jb.eigs_re), np.asarray(jb.eigs_im),
                                 np.asarray(jb.h), np.asarray(jb.hh), jb.offset)
    jterms = (L2Data(op=jb, b=jnp.asarray(y), sigma=1.0), L21Norm(sigma=0.3), Gradient2D())
    tterms = (interop.l2data_from_numpy(y, 1.0, tb), t_fn.L21Norm(sigma=0.3),
              interop.gradient_from_numpy())
    return y, jterms, tterms


@pytest.mark.parametrize("gfirst", [True, False])
def test_ulpda_numpy_tau_schedule_matches_jax(problem, gfirst):
    """C3: ``ulpda`` with numpy tau and mu schedules, noise off: 6 steps
    against the JAX package's ``ulpda`` on the same schedules."""
    y, jterms, tterms = problem
    tau = np.linspace(0.02, 0.07, 6)
    mu = np.full(6, 1.0)
    jk = j_imaging.ulpda(*jterms, tau=tau, mu=mu, gfirst=gfirst, noise_scale=0.0)
    want = j_run_chain(jk, jnp.zeros((N, N)), jax.random.PRNGKey(0), 6,
                       collect="samples")
    tk = t_imaging.ulpda(*tterms, tau=tau, mu=mu, gfirst=gfirst, noise_scale=0.0)
    got = t_run_chain(tk, torch.zeros((N, N), dtype=torch.float64), 0, 6,
                      collect="samples")
    _close(got.samples, want.samples, name="x")
    _close(got.final_state.extras.y, want.final_state.extras.y, name="y")


def test_ulpda_dual_samples_collected(problem):
    """C4, the torch twin of ``tests/test_parity_extras.py::
    test_ulpda_dual_samples_collected``: ``collect_extras=True`` stacks the
    dual and xbar of each emitted step, held to the JAX package's (noise
    off)."""
    _, jterms, tterms = problem
    jk = j_imaging.ulpda(*jterms, tau=0.05, mu=1.0, noise_scale=0.0)
    want = j_run_chain(jk, jnp.zeros((N, N)), jax.random.PRNGKey(0), 10,
                       collect="samples", collect_extras=True)
    tk = t_imaging.ulpda(*tterms, tau=0.05, mu=1.0, noise_scale=0.0)
    got = t_run_chain(tk, torch.zeros((N, N), dtype=torch.float64), 0, 10,
                      collect="samples", collect_extras=True)
    # dual samples: (steps, 2, n, n), the reference's returny
    assert got.extras.y.shape == (10, 2, N, N)
    assert got.extras.xbar.shape == (10, N, N) and got.extras.xprev is None
    _close(got.extras.y, want.extras.y, name="y")
    _close(got.extras.xbar, want.extras.xbar, name="xbar")


def test_collect_extras_projection(problem):
    """C4, the projection form (``tests/test_parity_extras.py::
    test_collect_extras_projection``): a function of the extras is stacked
    instead of the extras, with thinning; it equals the projection of the
    full stack and the JAX package's."""
    _, jterms, tterms = problem
    jk = j_imaging.ulpda(*jterms, tau=0.05, mu=1.0, noise_scale=0.0)
    want = j_run_chain(jk, jnp.zeros((N, N)), jax.random.PRNGKey(0), 12, thin=3,
                       collect="last", collect_extras=lambda e: jnp.sum(jnp.abs(e.y)))
    tk = t_imaging.ulpda(*tterms, tau=0.05, mu=1.0, noise_scale=0.0)
    x0 = torch.zeros((N, N), dtype=torch.float64)
    got = t_run_chain(tk, x0, 0, 12, thin=3, collect="last",
                      collect_extras=lambda e: torch.sum(torch.abs(e.y)))
    full = t_run_chain(tk, x0, 0, 12, thin=3, collect="last", collect_extras=True)
    assert got.extras.shape == (4,)
    assert torch.equal(got.extras, torch.abs(full.extras.y).sum(dim=(1, 2, 3)))
    _close(got.extras, want.extras, name="projection")


def test_run_chain_unroll_takes_no_effect(problem):
    """C4: ``unroll`` is accepted and changes nothing (the port's loop is
    eager)."""
    _, _, tterms = problem
    tk = t_imaging.ulpda(*tterms, tau=0.05, mu=1.0)
    x0 = torch.zeros((N, N), dtype=torch.float64)
    a = t_run_chain(tk, x0, (3, 1), 8, collect="stats")
    b = t_run_chain(tk, x0, (3, 1), 8, collect="stats", unroll=4)
    assert torch.equal(a.final_state.position, b.final_state.position)
    assert torch.equal(a.moments.mean, b.moments.mean) and a.extras is None
