"""Port parity for kernel 8, one fused MYULA step given the data gradient
(``kernels/myula_cuda.py``): its plain version against the JAX package's
``myula_tv_fused_update`` in interpret mode (f64, noise off), and
``run_chain(myula_imaging_fused(...))`` against the unfused
``run_chain(myula_imaging(l2, TVNorm(...)))`` on the same keys."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.kernels import myula_cuda as t_step
from lmc_atomi_torch.kernels.imaging import myula_imaging
from lmc_atomi_torch.ops.functionals import TVNorm
from lmc_atomi_torch.run.runner import run_chain
from lmc_atomi_tpu.kernels import myula_pallas as j_step
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, uniform_kernel
from lmc_atomi_tpu.utils.images import phantom

torch.set_num_threads(2)

N = 32
SIG = 0.75
GAMMA = SIG**2
TAU = 0.2 * GAMMA
TOL = 1e-12  # f64: the same Chambolle trips and update in both packages


@pytest.fixture(scope="module")
def problem():
    img = phantom(N, np.float64)
    jb = CirculantBlur2D.from_kernel((N, N), uniform_kernel(5, jnp.float64))
    y = np.asarray(jb.matvec(jnp.asarray(img)))
    y = y + SIG * np.random.default_rng(0).normal(size=(N, N))
    tb = interop.blur_from_numpy(np.asarray(jb.eigs_re), np.asarray(jb.eigs_im),
                                 np.asarray(jb.h), np.asarray(jb.hh), jb.offset)
    return y, interop.l2data_from_numpy(y, 1 / SIG**2, tb)


@pytest.mark.parametrize("niter,step", [(10, 0.25), (4, 0.2)])
def test_fused_update_ref_matches_jax(problem, niter, step):
    y, _ = problem
    rng = np.random.default_rng(niter)
    x = y + rng.normal(size=(N, N)) * 5
    grad = rng.normal(size=(N, N)) * 3
    want = j_step.myula_tv_fused_update(
        jnp.asarray(x), jnp.asarray(grad), jnp.zeros(2, jnp.int32), TAU, GAMMA,
        0.3 * GAMMA, 1.0, niter=niter, step=step, interpret=True, with_noise=False)
    got = t_step.myula_tv_fused_update(
        torch.from_numpy(x), torch.from_numpy(grad), (0, 0, 0), TAU, GAMMA,
        0.3 * GAMMA, 1.0, niter=niter, step=step, with_noise=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_fused_chain_equals_unfused(problem):
    """20 steps with noise on the same keys: the fused tail takes the
    unfused step's operations (the same Chambolle prox, the same update
    order, the same Philox draw), so the chains agree to roundoff."""
    y, l2 = problem
    x0 = torch.from_numpy(y)
    fused = run_chain(t_step.myula_imaging_fused(l2, 0.3, TAU, GAMMA), x0, (3, 1),
                      20, collect="stats")
    unfused = run_chain(myula_imaging(l2, TVNorm(sigma=0.3, niter=10), TAU, GAMMA), x0,
                        (3, 1), 20, collect="stats")
    for got, want in ((fused.final_state.position, unfused.final_state.position),
                      (fused.moments.mean, unfused.moments.mean)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)
    # base_seed shifts the stream
    other = run_chain(t_step.myula_imaging_fused(l2, 0.3, TAU, GAMMA, base_seed=1), x0,
                      (3, 1), 2, collect="last")
    assert not torch.allclose(other.final_state.position,
                              run_chain(t_step.myula_imaging_fused(l2, 0.3, TAU, GAMMA),
                                        x0, (3, 1), 2, collect="last").final_state.position)


def test_noise_is_the_step_keys_normal(problem):
    """With zero gradient weight the noise term is ``noise_scale sqrt(2 tau)``
    times ``normal_field(seed, chain, step)``."""
    from lmc_atomi_torch.core.random import normal_field

    y, _ = problem
    x = torch.from_numpy(y)
    g = torch.zeros_like(x)
    a = t_step.myula_tv_fused_update(x, g, (5, 2, 7), TAU, GAMMA, 0.3 * GAMMA, 0.5)
    b = t_step.myula_tv_fused_update(x, g, (5, 2, 7), TAU, GAMMA, 0.3 * GAMMA, 0.5,
                                     with_noise=False)
    want = 0.5 * np.sqrt(2 * TAU) * normal_field(5, 2, 7, x.shape, x.dtype, x.device)
    np.testing.assert_allclose((a - b).numpy(), want.numpy(), rtol=0, atol=1e-12)


def test_cuda_wrapper_raises_on_cpu(problem):
    y, _ = problem
    x = torch.from_numpy(y)
    before = t_step.myula_tv_fused_update_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        t_step.myula_tv_fused_update_cuda(x, x, (0, 0, 0), TAU, GAMMA, 0.3 * GAMMA)
    assert t_step.myula_tv_fused_update_cuda.launches == before
