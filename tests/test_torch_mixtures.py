"""The mixture workloads in the port, on the CPU, against the JAX package:
the models (``lmc_atomi_torch/models``), the eleven Langevin and proximal
kernels, the chain axis of the noise and of ``run_chains``, and the port's
imports (the workload CLIs: ``tests/test_torch_wasserstein.py``).

f64 where a result is held to JAX, with the noise injected: the JAX modules'
``normal_like`` (and MALA's accept uniform) are patched inside the test to
return the port's ``normal_field`` (``uniform_scalar``) draws, so both
packages take the same steps. Tolerances: 1e-12 of the output's scale;
1e-10 for IHPULA (an eigendecomposition a step) and for the Laplace Hessian
against ``jax.hessian``."""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.core.random import chain_keys, normal_field, uniform_scalar
from lmc_atomi_torch.experiments.configs import gaussian_mixture_config
from lmc_atomi_torch.kernels import langevin as t_lang
from lmc_atomi_torch.kernels import proximal as t_prox
from lmc_atomi_torch.models import GaussianMixture as TGM
from lmc_atomi_torch.models import LaplaceMixture as TLM
from lmc_atomi_torch.models import MultivariateLaplace as TMVL
from lmc_atomi_torch.run import runner as t_runner
from lmc_atomi_tpu.kernels import langevin as j_lang
from lmc_atomi_tpu.kernels import proximal as j_prox
from lmc_atomi_tpu.models import (
    GaussianMixture,
    LaplaceMixture,
    LaplacePrior,
    MixtureWithLaplacePrior,
    MultivariateLaplace,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-12
TOL_EIGH = 1e-10
SEED, CHAIN = 11, 3
STEPS = 20
X0 = np.array([0.3, -0.2])
M_PRE = np.array([[1.0, 0.1], [0.1, 0.5]])
Q_PRE = np.array([[1.0, 0.1], [0.1, 1.5]])
BETA = np.array([0.7, 0.3])
SIGMA_BREG = np.array([0.8, 0.2])


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    got = _np(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.fixture(scope="module")
def targets():
    """The n=3 Gaussian mixture, a Laplacian mixture and the composite
    target in f64, built in JAX and carried to the port."""
    mus, sigmas, omegas = gaussian_mixture_config(3)
    jgm = GaussianMixture.create(mus, sigmas, omegas)
    jlm = LaplaceMixture.create(mus, np.array([0.5, 1.0, 0.7]), np.array([0.5, 0.3, 0.2]), 0.1)
    jtg = MixtureWithLaplacePrior.create(jgm, LaplacePrior.create(np.array([0.2, -0.1]), 0.1),
                                        0.01)
    tgm = interop.gaussian_mixture_from_numpy(
        *(np.asarray(getattr(jgm, f)) for f in
          ("mus", "sigmas", "log_weights", "precs", "log_norms", "chols")))
    tlm = interop.laplace_mixture_from_numpy(
        *(np.asarray(getattr(jlm, f)) for f in ("mus", "alphas", "log_weights", "lam")))
    ttg = interop.composite_from_numpy(tgm, np.asarray(jtg.prior.mu),
                                       np.asarray(jtg.prior.alpha), np.asarray(jtg.lam))
    return {"gm": (jgm, tgm), "lm": (jlm, tlm), "tg": (jtg, ttg)}


THETAS = [np.random.default_rng(1).normal(size=(4, 3, 2)) * 2.5,
          np.array([0.4, -1.3])]
MODEL_METHODS = [
    ("gm", m) for m in ("component_log_densities", "log_density", "density", "potential",
                        "responsibilities", "grad_potential", "hess_potential")
] + [
    ("lm", m) for m in ("component_log_densities", "log_density", "density", "potential",
                        "component_smooth_log_densities", "smooth_log_density",
                        "smooth_density", "smooth_potential", "grad_smooth_potential")
] + [
    ("tg", m) for m in ("log_density", "density", "smooth_potential", "grad_smooth_potential",
                        "hess_smooth_potential", "prior_prox", "grad_moreau_prior")
]


@pytest.mark.parametrize("model,method", MODEL_METHODS,
                         ids=[f"{m}-{f}" for m, f in MODEL_METHODS])
def test_model_methods(targets, model, method):
    jm, tm = targets[model]
    for theta in THETAS:
        _close(getattr(tm, method)(torch.from_numpy(theta)),
               getattr(jm, method)(jnp.asarray(theta)), name=method)
    _close(tm.gd_update(torch.from_numpy(THETAS[0]), 0.05),
           jm.gd_update(jnp.asarray(THETAS[0]), 0.05))


def test_laplace_hessian_against_jax_hessian(targets):
    """torch.func.hessian under vmap over the leading axes against
    jax.hessian of the same smoothed potential."""
    jlm, tlm = targets["lm"]
    flat = jnp.asarray(THETAS[0].reshape(-1, 2))
    want = jax.jit(jax.vmap(jax.hessian(jlm.smooth_potential)))(flat)
    _close(tlm.hess_smooth_potential(torch.from_numpy(THETAS[0])),
           np.asarray(want).reshape(THETAS[0].shape + (2,)), TOL_EIGH)
    _close(tlm.hess_smooth_potential(torch.from_numpy(THETAS[1])),
           jlm.hess_smooth_potential(jnp.asarray(THETAS[1])), TOL_EIGH)


def test_create_matches_jax():
    mus, sigmas, _ = gaussian_mixture_config(3)
    w = np.array([0.5, 0.3, 0.2])
    jgm, tgm = GaussianMixture.create(mus, sigmas, w), TGM.create(mus, sigmas, w)
    for f in ("mus", "sigmas", "log_weights", "precs", "log_norms", "chols"):
        _close(getattr(tgm, f), getattr(jgm, f), name=f)
    jlm, tlm = (c.create(mus, np.array([0.5, 1.0, 0.7]), w, 0.1) for c in (LaplaceMixture, TLM))
    for f in ("mus", "alphas", "log_weights", "lam"):
        _close(getattr(tlm, f), getattr(jlm, f), name=f)
    cov = np.array([[1.0, 0.3], [0.3, 0.5]])
    mean = np.array([0.5, -1.0])
    jmv, tmv = MultivariateLaplace.create(mean, cov), TMVL.create(mean, cov)
    x = np.random.default_rng(2).normal(size=(9, 2))
    _close(tmv.logpdf(torch.from_numpy(x)), jmv.logpdf(jnp.asarray(x)))
    _close(tmv.entropy(), jmv.entropy())
    _close(tmv.log_det_cov, jmv.log_det_cov)


def test_mvlaplace_from_jax_fields():
    jmv = MultivariateLaplace.create(np.array([0.5, -1.0]), np.array([[1.0, 0.3], [0.3, 0.5]]))
    tmv = interop.mvlaplace_from_numpy(*(np.asarray(getattr(jmv, f)) for f in
                                         ("mean", "cov", "prec_u", "log_det_cov", "color")))
    x = np.random.default_rng(3).normal(size=(9, 2))
    for f in ("logpdf", "pdf", "cdf", "logcdf"):
        _close(getattr(tmv, f)(torch.from_numpy(x)), getattr(jmv, f)(jnp.asarray(x)), name=f)


def test_sampling_follows_weights_and_scales():
    """``sample`` draws the component from the weights (the mean of the
    draws is the weighted mean of the components), Laplace draws have
    scale 1/alpha, and ``rvs`` has covariance 2 cov (standard Laplace
    variance 2)."""
    gen = torch.Generator().manual_seed(0)
    mus, sigmas, _ = gaussian_mixture_config(3)
    w = np.array([0.7, 0.2, 0.1])
    n = 40000
    s = TGM.create(mus, sigmas, w).sample(gen, n)
    assert s.shape == (n, 2)
    want = w @ mus
    se = float(s.std(0).max()) / n**0.5
    assert float((s.mean(0) - torch.from_numpy(want)).abs().max()) < 5 * se
    s = TLM.create(np.zeros((1, 2)), [0.5], [1.0], 0.1).sample(gen, n)
    assert float((s.std(0) / (2**0.5 / 0.5) - 1).abs().max()) < 0.05
    cov = np.array([[1.0, 0.3], [0.3, 0.5]])
    s = TMVL.create(np.zeros(2), cov).rvs(gen, n)
    assert np.abs(np.cov(s.numpy().T) / (2 * cov) - 1).max() < 0.1


def _kernels(targets):
    """(port kernel, JAX kernel, tolerance, has an accept test) by name: the
    eleven kernels of the three workloads, and IHPULA also on the
    Laplacian mixture (its Hessian through torch.func)."""
    (jgm, tgm), (jlm, tlm), (jtg, ttg) = targets["gm"], targets["lm"], targets["tg"]
    t = torch.from_numpy
    return {
        "ULA": (t_lang.ula(tgm.grad_potential, 0.05)._replace(chain_axis=True),
                j_lang.ula(jgm.grad_potential, 0.05), TOL, False),
        "MALA": (t_lang.mala(tgm.log_density, tgm.grad_potential, 0.3)._replace(chain_axis=True),
                 j_lang.mala(jgm.log_density, jgm.grad_potential, 0.3), TOL, True),
        "PULA": (t_lang.pula(tgm.grad_potential, 0.05, t(M_PRE)),
                 j_lang.pula(jgm.grad_potential, 0.05, M_PRE), TOL, False),
        "IHPULA": (t_lang.ihpula(tgm.grad_potential, tgm.hess_potential, 0.05),
                   j_lang.ihpula(jgm.grad_potential, jgm.hess_potential, 0.05), TOL_EIGH, False),
        "IHPULA-laplace": (t_lang.ihpula(tlm.grad_smooth_potential, tlm.hess_smooth_potential,
                                         0.05, shift=0.02),
                           j_lang.ihpula(jlm.grad_smooth_potential, jlm.hess_smooth_potential,
                                         0.05, shift=0.02), TOL_EIGH, False),
        "MLA": (t_lang.mla(tgm.grad_potential, 0.05, t(BETA)),
                j_lang.mla(jgm.grad_potential, 0.05, BETA), TOL, False),
        "PGLD": (t_prox.pgld(ttg, 0.05), j_prox.pgld(jtg, 0.05), TOL, False),
        "MYULA": (t_prox.myula(ttg, 0.05), j_prox.myula(jtg, 0.05), TOL, False),
        "MYMALA": (t_prox.mymala(ttg, 0.6), j_prox.mymala(jtg, 0.6), TOL, True),
        "PP-ULA": (t_prox.ppula(ttg, 0.05, t(M_PRE), t(Q_PRE), t=100),
                   j_prox.ppula(jtg, 0.05, M_PRE, Q_PRE, t=100), TOL, False),
        "FBULA": (t_prox.fbula(ttg, 0.05), j_prox.fbula(jtg, 0.05), TOL, False),
        "LBMUMLA": (t_prox.lbmumla(ttg, 0.05, t(BETA), t(SIGMA_BREG)),
                    j_prox.lbmumla(jtg, 0.05, BETA, SIGMA_BREG), TOL, False),
    }


KERNELS = ["ULA", "MALA", "PULA", "IHPULA", "IHPULA-laplace", "MLA", "PGLD", "MYULA",
           "MYMALA", "PP-ULA", "FBULA", "LBMUMLA"]


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_against_jax_same_noise(targets, monkeypatch, name):
    """20 steps in both packages on the same noise: the JAX kernel's
    ``normal_like`` and accept uniform return the port's draws."""
    tk, jk, tol, adjusted = _kernels(targets)[name]
    res = t_runner.run_chain(tk, torch.from_numpy(X0), (SEED, CHAIN), STEPS)
    noise = iter([jnp.asarray(_np(normal_field(SEED, CHAIN, i, (2,), torch.float64, "cpu")))
                  for i in range(STEPS)])
    unif = iter([jnp.asarray(_np(uniform_scalar(SEED, CHAIN, i, torch.float64, "cpu")))
                 for i in range(STEPS)])
    monkeypatch.setattr(j_lang, "normal_like", lambda key, x: next(noise))
    monkeypatch.setattr(j_prox, "normal_like", lambda key, x: next(noise))
    monkeypatch.setattr(jax.random, "uniform", lambda key, *a, **k: next(unif))
    state = jk.init(jnp.asarray(X0))
    key = jax.random.PRNGKey(0)
    want, accepted = [], []
    for _ in range(STEPS):
        state, info = jk.step(state, key)
        want.append(np.asarray(state.position))
        accepted.append(bool(info.accepted) if adjusted else None)
    _close(res.samples, np.stack(want), tol, name)
    if adjusted:
        got = [bool(i.accepted) for i in res.infos]
        assert got == accepted and 0 < sum(got) < STEPS, got


def test_philox_multiply_wraps():
    """One int64 multiply gives both 32-bit words of a 32x32-bit product
    (the tensor wraps it modulo 2^64), as Python's exact integers do."""
    from lmc_atomi_torch.core.random import _M0, _M1, _mulhilo

    vals = [0, 1, 2**31 - 1, 2**31, 2**32 - 1] + np.random.default_rng(6).integers(
        0, 2**32, 4000).tolist()
    for m in (_M0, _M1):
        hi, lo = _mulhilo(m, torch.tensor(vals, dtype=torch.int64))
        assert hi.tolist() == [(v * m) >> 32 for v in vals]
        assert lo.tolist() == [(v * m) & 0xFFFFFFFF for v in vals]
        assert _mulhilo(m, vals[4]) == ((vals[4] * m) >> 32, (vals[4] * m) & 0xFFFFFFFF)


@pytest.mark.parametrize("shape,dtype", [((2,), torch.float64), ((3, 5), torch.float32),
                                         ((7,), torch.float64)])
def test_noise_chain_word_tensor(shape, dtype):
    """A tensor of chain words draws each chain's noise bit for bit as the
    call with its word."""
    keys = chain_keys((5, 2), 300)
    words = torch.tensor([w for _, w in keys])
    got = normal_field(5, words, 17, shape, dtype, "cpu")
    assert got.shape == (300,) + shape
    assert torch.equal(got, torch.stack([normal_field(5, w, 17, shape, dtype, "cpu")
                                         for _, w in keys]))
    u = uniform_scalar(5, words, 9, dtype, "cpu")
    assert u.shape == (300,)
    assert torch.equal(u, torch.stack([uniform_scalar(5, w, 9, dtype, "cpu") for _, w in keys]))


def test_noise_step_tensor_and_step_noise_blocks():
    """A tensor of steps draws each step bit for bit as its own call, and a
    kernel's ``StepNoise`` serves the same numbers as one draw a step: in
    order, out of order, after another chain's words or seed, and for a
    field too large for a block."""
    keys = chain_keys((5, 2), 40)
    words = torch.tensor([w for _, w in keys])
    steps = torch.arange(7, 19)
    got = normal_field(5, words, steps, (3,), torch.float64, "cpu")
    assert got.shape == (12, 40, 3)
    assert torch.equal(got, torch.stack([normal_field(5, words, int(s), (3,), torch.float64,
                                                      "cpu") for s in steps]))
    u = uniform_scalar(5, 9, steps, torch.float32, "cpu")
    assert torch.equal(u, torch.stack([uniform_scalar(5, 9, int(s), torch.float32, "cpu")
                                       for s in steps]))
    noise = t_lang.StepNoise()
    other = torch.tensor([w + 1 for _, w in keys])
    x = torch.zeros(40, 2, dtype=torch.float64)
    for seed, chain, step, y in [(5, words, 0, x), (5, words, 1, x), (5, words, 70, x),
                                 (5, other, 71, x), (5, words, 3, x), (6, words, 3, x),
                                 (5, 11, 2, x[0]), (5, words, 63, x), (5, 11, 4, x)]:
        lead = isinstance(chain, torch.Tensor)
        want = normal_field(seed, chain, step, y.shape[lead:], y.dtype, "cpu")
        assert torch.equal(noise.normal((seed, chain, step), y), want)
        assert torch.equal(noise.uniform((seed, chain, step), torch.float64, "cpu"),
                           uniform_scalar(seed, chain, step, torch.float64, "cpu"))
    big = torch.zeros(t_lang.NOISE_ELEMS)
    assert torch.equal(noise.normal((1, 2, 3), big), normal_field(1, 2, 3, big.shape,
                                                                  big.dtype, "cpu"))


def test_run_chains_twice_on_one_kernel(targets):
    """A kernel reused for a second ``run_chains`` (new chain words) gives
    what a fresh kernel gives: its noise blocks do not leak across runs."""
    tgm = targets["gm"][1]
    kern = t_lang.ula(tgm.grad_potential, 0.05)._replace(chain_axis=True)
    a1 = t_runner.run_chains(kern, torch.from_numpy(X0), (3, 0), 30, 5).samples
    a2 = t_runner.run_chains(kern, torch.from_numpy(X0), (3, 1), 30, 5).samples
    fresh = t_lang.ula(tgm.grad_potential, 0.05)._replace(chain_axis=True)
    assert torch.equal(a2, t_runner.run_chains(fresh, torch.from_numpy(X0), (3, 1), 30,
                                               5).samples)
    assert not torch.equal(a1, a2)


# bit for bit: elementwise steps and sums along one axis; within 1e-12 and
# the same accept decisions: a matrix product (PULA, PP-ULA), an
# eigendecomposition (IHPULA) or an accept test (MALA, MYMALA), which a
# batched call may round otherwise (on this CPU they too come out equal)
EXACT = {"ULA", "MLA", "PGLD", "MYULA", "FBULA", "LBMUMLA"}


@pytest.mark.parametrize("name", KERNELS)
def test_run_chains_batched_step(targets, name):
    """One step over all chains equals ``run_chain`` under each chain's key,
    every field of the result, from one start and from one start a chain."""
    tk = _kernels(targets)[name][0]
    assert tk.chain_axis
    n_chains, key = 6, (4, 1)
    metrics = {"ld": targets["gm"][1].log_density}
    kw = dict(collect="both", quantile_ps=(0.5,), burn_in=2, metrics=metrics)
    starts = torch.from_numpy(np.random.default_rng(5).normal(size=(n_chains, 2)))
    for x0 in (torch.from_numpy(X0), starts):
        got = t_runner.run_chains(tk, x0, key, 12, n_chains, **kw)
        want = t_runner.stack_tree([
            t_runner.run_chain(tk, x0 if x0.ndim == 1 else x0[i], k, 12, **kw)
            for i, k in enumerate(chain_keys(key, n_chains))])
        pairs = [(got.samples, want.samples), (got.final_state.position,
                                               want.final_state.position),
                 (got.moments.mean, want.moments.mean), (got.moments.m2, want.moments.m2),
                 (got.quantiles[0.5].heights, want.quantiles[0.5].heights),
                 (got.quantiles[0.5].positions, want.quantiles[0.5].positions),
                 (got.metrics["ld"], want.metrics["ld"])]
        for a, b in pairs:
            assert a.shape == b.shape
            if name in EXACT:
                assert torch.equal(a, b), name
            else:
                _close(a, _np(b), TOL, name)
        assert torch.equal(got.moments.count, want.moments.count)
        assert torch.equal(got.final_state.step, want.final_state.step)
        assert torch.equal(got.quantiles[0.5].count, want.quantiles[0.5].count)
        if got.infos[0].accepted is not None:
            assert all(torch.equal(a.accepted, b.accepted)
                       for a, b in zip(got.infos, want.infos))


def test_run_chains_without_chain_axis_loops(targets):
    """A kernel that leaves ``chain_axis`` off runs chain after chain, and
    gives the batched step's result."""
    tgm = targets["gm"][1]
    plain = t_lang.mala(tgm.log_density, tgm.grad_potential, 0.3)
    a = t_runner.run_chains(plain, torch.from_numpy(X0), 7, 10, 4)
    b = t_runner.run_chains(plain._replace(chain_axis=True), torch.from_numpy(X0), 7, 10, 4)
    assert torch.equal(a.samples, b.samples)
    assert all(torch.equal(x.accepted, y.accepted) for x, y in zip(a.infos, b.infos))


def test_ihpula_f32_no_divergence_gamma01_n2():
    """The JAX package's regression (tests/test_kernels.py, the RESULTS.md
    r1 NaN cell) in the port: gamma=0.1, n=2, 10000 f32 steps of one
    eigendecomposition a step stay finite."""
    mus, sigmas, omegas = gaussian_mixture_config(2)
    gm = TGM.create(mus, sigmas, omegas, dtype=torch.float32)
    kern = t_lang.ihpula(gm.grad_potential, gm.hess_potential, 0.1)
    x0 = torch.randn(2, generator=torch.Generator().manual_seed(0))
    res = t_runner.run_chain(kern, x0, (0, 3), 10000, collect="samples")
    assert res.samples.dtype == torch.float32
    assert bool(torch.isfinite(res.samples).all())


def test_port_imports_no_jax():
    """No module of the port and not ``chip_smoke.py`` imports ``jax`` or
    ``lmc_atomi_tpu``."""
    files = sorted((ROOT / "lmc_atomi_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "lmc_atomi_tpu", "flax", "optax")]
    assert len(files) > 40 and not bad, bad
