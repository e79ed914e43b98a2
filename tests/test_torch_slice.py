"""Port parity for the MYULA TV-deblur slice as a whole, on the CPU in f64:
the unfused sampler against the JAX update rule fed the port's own noise,
the port's unfused chain against its fused chain (same Philox stream), and
the posterior-mean PSNR against the JAX package's threefry chain."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.core.random import normal_field
from lmc_atomi_torch.eval.metrics import psnr as t_psnr
from lmc_atomi_torch.kernels.imaging import myula_imaging as t_myula
from lmc_atomi_torch.kernels.myula_fused import (
    myula_imaging_sep_fused,
    run_myula_tv_fused,
)
from lmc_atomi_torch.ops.functionals import TVNorm as TTVNorm
from lmc_atomi_torch.run.runner import run_chain as t_run_chain
from lmc_atomi_torch.utils.images import phantom as t_phantom
from lmc_atomi_tpu.eval.metrics import psnr
from lmc_atomi_tpu.kernels.imaging import myula_imaging
from lmc_atomi_tpu.ops.functionals import L2Data, TVNorm
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, uniform_kernel
from lmc_atomi_tpu.run.runner import run_chain
from lmc_atomi_tpu.utils.images import phantom

torch.set_num_threads(2)

SIG = 0.75
GAMMA = SIG**2
TAU = 0.2 * GAMMA


def _np(t):
    return t.detach().cpu().numpy()


def _problem(n, img_scale=1.0, noise=SIG, seed=0):
    """Blur problem built in JAX (f64), carried to the port."""
    img = phantom(n, np.float64) * img_scale
    jb = CirculantBlur2D.from_kernel((n, n), uniform_kernel(5, jnp.float64))
    y = np.asarray(jb.matvec(jnp.asarray(img))) \
        + noise * np.random.default_rng(seed).normal(size=(n, n))
    jl2 = L2Data.create(op=jb, b=jnp.asarray(y), sigma=1 / SIG**2)
    tb = interop.blur_from_numpy(
        np.asarray(jb.eigs_re), np.asarray(jb.eigs_im), np.asarray(jb.h),
        np.asarray(jb.hh), jb.offset)
    return img, y, jl2, interop.l2data_from_numpy(y, 1 / SIG**2, tb)


def test_phantom_is_the_jax_packages():
    np.testing.assert_array_equal(t_phantom(48), phantom(48))


def test_myula_imaging_golden_with_port_noise():
    """The port's run_chain(myula_imaging) against the JAX package's update
    rule (its own grad and prox) fed the port's normal_field draws."""
    n = 24
    _, _, jl2, tl2 = _problem(n, img_scale=1 / 255.0, noise=0.02)
    jtv = TVNorm(sigma=0.3, niter=10)
    jgrad = jax.jit(jl2.grad)
    jprox = jax.jit(lambda a: jtv.prox(a, GAMMA))
    kern = t_myula(tl2, TTVNorm(sigma=0.3, niter=10), tau=TAU, gamma=GAMMA)
    res = t_run_chain(kern, torch.zeros((n, n), dtype=torch.float64), (11, 2),
                      20, collect="samples")
    x = np.zeros((n, n))
    want = []
    for i in range(20):
        xi = _np(normal_field(11, 2, i, (n, n), torch.float64, "cpu"))
        gr = np.asarray(jgrad(jnp.asarray(x)))
        px = np.asarray(jprox(jnp.asarray(x)))
        x = (1 - TAU / GAMMA) * x - TAU * gr + (TAU / GAMMA) * px \
            + math.sqrt(2 * TAU) * xi
        want.append(x.copy())
    assert res.final_state.step == 20
    np.testing.assert_allclose(_np(res.samples), np.asarray(want), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("collect,thin", [("samples", 2), ("both", 1), ("last", 4)])
def test_run_chain_collect_modes(collect, thin):
    n = 16
    _, _, _, tl2 = _problem(n)
    kern = t_myula(tl2, TTVNorm(sigma=0.3, niter=3), tau=TAU, gamma=GAMMA)
    x0 = torch.zeros((n, n), dtype=torch.float64)
    res = t_run_chain(kern, x0, 5, 8, collect=collect, thin=thin, burn_in=1,
                      metrics={"mean": lambda x: x.mean()})
    full = t_run_chain(kern, x0, 5, 8, collect="samples")
    np.testing.assert_array_equal(_np(res.final_state.position),
                                  _np(full.final_state.position))
    assert len(res.infos) == 8 // thin and res.metrics["mean"].shape == (8 // thin,)
    if collect in ("samples", "both"):
        np.testing.assert_array_equal(_np(res.samples), _np(full.samples[thin - 1::thin]))
    else:
        assert res.samples is None and res.moments is None
    if collect == "both":
        kept = full.samples[1:]
        assert res.moments.count == 7
        np.testing.assert_allclose(_np(res.moments.mean), _np(kept.mean(0)), atol=1e-10)
    with pytest.raises(ValueError, match="divisible"):
        t_run_chain(kern, x0, 5, 7, thin=2)
    with pytest.raises(ValueError, match="collect"):
        t_run_chain(kern, x0, 5, 2, collect="all")


def test_unfused_chain_equals_fused_chain_with_noise():
    """Same seed, same Philox stream: run_chain(myula_imaging) and the
    fused block loop agree in position, moments and P^2 maps, and the
    one-step fused kernel wrapper drives run_chain identically."""
    n = 32
    _, _, _, tl2 = _problem(n)
    x0 = torch.zeros((n, n), dtype=torch.float64)
    kern = t_myula(tl2, TTVNorm(sigma=0.3, niter=10), tau=TAU, gamma=GAMMA)
    ps = (0.025, 0.975)
    unf = t_run_chain(kern, x0, (9, 1), 20, collect="stats", burn_in=3,
                      quantile_ps=ps)
    fus = run_myula_tv_fused(tl2, 0.3, TAU, GAMMA, x0, (9, 1), 20, block=5,
                             burn_in=3, quantiles=ps)
    step = t_run_chain(myula_imaging_sep_fused(tl2, 0.3, TAU, GAMMA), x0,
                       (9, 1), 20, collect="last")
    tol = 1e-9 * 255
    np.testing.assert_allclose(_np(fus.final_state.position),
                               _np(unf.final_state.position), rtol=0, atol=tol)
    np.testing.assert_allclose(_np(step.final_state.position),
                               _np(unf.final_state.position), rtol=0, atol=tol)
    assert fus.moments.count == unf.moments.count == 17
    np.testing.assert_allclose(_np(fus.moments.mean), _np(unf.moments.mean),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(_np(fus.moments.m2), _np(unf.moments.m2),
                               rtol=1e-9, atol=1e-9)
    for p in ps:
        np.testing.assert_allclose(_np(fus.quantiles[p]),
                                   _np(unf.quantiles[p].value), rtol=0, atol=tol)


def test_segmented_fused_chain_continues_bit_for_bit():
    """Noise is a function of the global step: two segments joined with
    step_offset reproduce one run exactly, whatever the block size."""
    n = 16
    _, _, _, tl2 = _problem(n)
    x0 = torch.zeros((n, n), dtype=torch.float64)
    kw = dict(burn_in=2, quantiles=(0.5,))
    whole = run_myula_tv_fused(tl2, 0.3, TAU, GAMMA, x0, 4, 12, block=4, **kw)
    a = run_myula_tv_fused(tl2, 0.3, TAU, GAMMA, x0, 4, 5, block=5, **kw)
    b = run_myula_tv_fused(tl2, 0.3, TAU, GAMMA, a.final_state.position, 4, 7,
                           block=7, step_offset=5,
                           quantile_state=a.quantile_state, **kw)
    np.testing.assert_array_equal(_np(b.final_state.position),
                                  _np(whole.final_state.position))
    np.testing.assert_array_equal(_np(b.quantiles[0.5]), _np(whole.quantiles[0.5]))
    merged = a.moments.merge(b.moments)
    np.testing.assert_allclose(_np(merged.mean), _np(whole.moments.mean), atol=1e-10)
    arrays = interop.to_numpy(b)
    assert isinstance(arrays["final_state"]["position"], np.ndarray)
    assert arrays["moments"]["count"] == 7


def test_posterior_mean_psnr_matches_jax_threefry_chain():
    """64^2 bench problem, 4000 steps: the port's unfused chain (Philox)
    and the JAX package's (threefry) reach posterior-mean PSNRs within
    0.1 dB, the JAX package's own gate between noise streams."""
    n, steps, burn = 64, 4000, 500
    img, y, jl2, tl2 = _problem(n)
    jk = myula_imaging(jl2, TVNorm(sigma=0.3, niter=10), tau=TAU, gamma=GAMMA)
    jres = jax.jit(lambda x, k: run_chain(jk, x, k, steps, collect="stats",
                                          burn_in=burn))(
        jnp.zeros((n, n)), jax.random.PRNGKey(1))
    tk = t_myula(tl2, TTVNorm(sigma=0.3, niter=10), tau=TAU, gamma=GAMMA)
    tres = t_run_chain(tk, torch.zeros((n, n), dtype=torch.float64), 1, steps,
                       collect="stats", burn_in=burn)
    p_j = float(psnr(jnp.asarray(img), jres.moments.mean))
    p_t = float(t_psnr(torch.from_numpy(img), tres.moments.mean))
    p_blur = float(psnr(jnp.asarray(img), jnp.asarray(y)))
    assert p_t > p_blur + 3.0, (p_t, p_blur)
    assert abs(p_t - p_j) < 0.1, (p_t, p_j)
