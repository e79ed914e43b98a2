"""The SG-MCMC slice of the port, on the CPU, against the JAX package: the
25-mode grid mixture, the nine SG-MCMC kernels, the minibatch gradient
estimator, CSGLD's importance resampling, the chain axis of every kernel,
the mode finder's solve and the workload CLI.

f64 where a result is held to JAX, with the noise injected: the JAX module's
``normal_like`` (and MSGLD's accept uniform, and the minibatch's
``jax.random.choice``) are patched inside the test to return the port's
draws of the same step, so both packages take the same steps. Tolerance:
1e-12 of the output's scale; the mode finder's Adam 1e-12 a step over 2000
steps, each from the JAX trajectory's state, and its best log-probability
1e-9 free-running; the cyclical schedule float32's. CSGLD's energy
bin is a ``ceil`` that roundoff could flip at a bin edge: the starts here lie
away from the edges (the test asserts the bins agree)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.core.random import chain_keys, normal_field, uniform_field, uniform_scalar
from lmc_atomi_torch.experiments import sgld_runs as t_runs
from lmc_atomi_torch.kernels import sgmcmc as T
from lmc_atomi_torch.models import GridGaussianMixture as TGrid
from lmc_atomi_torch.ops.prox import prox_laplace as t_prox_laplace
from lmc_atomi_torch.run import runner as t_runner
from lmc_atomi_tpu.kernels import sgmcmc as J
from lmc_atomi_tpu.models import GridGaussianMixture as JGrid
from lmc_atomi_tpu.ops.prox import prox_laplace as j_prox_laplace

torch.set_num_threads(2)

TOL = 1e-12
TOL_ADAM = 1e-9
POSITIONS = [-4.0, -2.0, 0.0, 2.0, 4.0]
SIGMA, LAM = 0.03, 1 / 25.0
SEED, CHAIN = 11, 3
STEPS = 30
X0 = np.array([0.7, -1.3])


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    got = _np(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.fixture(scope="module")
def grids():
    """The grid target in both packages, the port's carried across from the
    JAX model's fields."""
    jg = JGrid.create(POSITIONS, sigma=SIGMA, lam=LAM)
    tg = interop.grid_mixture_from_numpy(np.asarray(jg.mus), np.asarray(jg.sigma),
                                         np.asarray(jg.lam))
    return jg, tg


def test_grid_create_matches_jax(grids):
    jg, tg = grids
    made = TGrid.create(POSITIONS, SIGMA, LAM)
    assert made.mus.dtype == torch.float32 and made.dim == 2
    assert torch.equal(made.mus, tg.mus) and (made.sigma, made.lam) == (tg.sigma, tg.lam)


THETAS = [np.random.default_rng(1).normal(size=(4, 3, 2)) * 3.0, np.array([0.4, -1.3]),
          np.array([9.0, -7.5])]


@pytest.mark.parametrize("i", range(len(THETAS)))
def test_grid_log_prob_and_grad(grids, i):
    """``log_prob`` batches over leading axes; ``grad_log_prob``, written
    out, against ``jax.grad`` of the JAX model's ``log_prob``."""
    jg, tg = grids
    theta = THETAS[i]
    _close(tg.log_prob(torch.from_numpy(theta)), jg.log_prob(jnp.asarray(theta)))
    flat = jnp.asarray(theta.reshape(-1, 2))
    want = np.asarray(jax.vmap(jax.grad(jg.log_prob))(flat)).reshape(theta.shape)
    _close(tg.grad_log_prob(torch.from_numpy(theta)), want)
    if theta.ndim == 1:
        _close(tg.grad_log_prob(torch.from_numpy(theta)), jg.grad_log_prob(jnp.asarray(theta)))


def test_grid_sample_statistics(grids):
    """A uniform mode then its Gaussian: mean 0 and variance 8 + sigma a
    coordinate (the modes' own variance is 8), in both packages, and every
    mode drawn about as often."""
    jg, tg = grids
    n = 50000
    s = tg.sample(torch.Generator().manual_seed(0), n).numpy()
    js = np.asarray(jg.sample(jax.random.PRNGKey(0), n))
    for draws in (s, js):
        se = np.sqrt((8 + SIGMA) / n)
        assert np.abs(draws.mean(0)).max() < 5 * se
        assert np.abs(draws.var(0) / (8 + SIGMA) - 1).max() < 0.03
    counts = np.bincount(np.argmin(((s[:, None] - _np(tg.mus)[None]) ** 2).sum(-1), 1),
                         minlength=25)
    assert np.abs(counts / (n / 25) - 1).max() < 0.1
    assert s.dtype == np.float32


# --- the nine kernels against JAX, on injected noise ---------------------------

def _sa(step, lib):
    return lib.minimum(1e-2, (step + 100.0) ** (-0.8)) * 10.0


def _kernels(grids):
    """(port kernel, JAX kernel) by case: the workload's nine samplers at
    the workload's settings (the contour ones on 2000 bins), SPGLD and
    cyclical SPGLD with a one-parameter prox too, CSGLD with its default
    stochastic-approximation schedule and min energy, and the CSGLD
    ``mult_clip`` case of the JAX package's tests on its own (see below)."""
    jg, tg = grids
    csg = dict(num_partitions=2000, energy_gap=0.25, zeta=0.75, temperature=50.0,
               lr_schedule=1e-3)
    t_prox2 = lambda x, g: t_prox_laplace(x, g / 1.0)
    j_prox2 = lambda x, g: j_prox_laplace(x, g / 1.0)
    t_prox1 = lambda x: t_prox_laplace(x, 0.1)
    j_prox1 = lambda x: j_prox_laplace(x, 0.1)
    t_moreau = lambda x: (x - t_prox1(x)) / 0.1
    j_moreau = lambda x: (x - j_prox1(x)) / 0.1
    return {
        "SGLD": (T.sgld(tg.grad_log_prob, T.polynomial_schedule(0.05, -0.55)),
                 J.sgld(jg.grad_log_prob, J.polynomial_schedule(0.05, -0.55))),
        "MSGLD": (T.msgld(tg.log_prob, tg.grad_log_prob, T.polynomial_schedule(0.4, -0.55)),
                  J.msgld(jg.log_prob, jg.grad_log_prob, J.polynomial_schedule(0.4, -0.55))),
        "cyclicalSGLD": (T.cyclical_sgld(tg.grad_log_prob, STEPS, 3, 0.09, 0.25),
                         J.cyclical_sgld(jg.grad_log_prob, STEPS, 3, 0.09, 0.25)),
        "contourSGLD": (T.csgld(tg.log_prob, sa_schedule=lambda s: _sa(s, np), **csg),
                        J.csgld(jg.log_prob, sa_schedule=lambda s: _sa(s, jnp), **csg)),
        "contourSGLD-defaults": (T.csgld(tg.log_prob, num_partitions=64, energy_gap=0.5,
                                         min_energy=-1.0, zeta=0.75),
                                 J.csgld(jg.log_prob, num_partitions=64, energy_gap=0.5,
                                         min_energy=-1.0, zeta=0.75)),
        "SPGLD": (T.spgld(tg.grad_log_prob, t_prox2, T.polynomial_schedule(0.4, -0.55)),
                  J.spgld(jg.grad_log_prob, j_prox2, J.polynomial_schedule(0.4, -0.55))),
        "SPGLD-one-arg-prox": (T.spgld(tg.grad_log_prob, t_prox1, 0.01),
                               J.spgld(jg.grad_log_prob, j_prox1, 0.01)),
        "SSGLD": (T.ssgld(tg.grad_log_prob, t_moreau, T.polynomial_schedule(0.4, -0.55)),
                  J.ssgld(jg.grad_log_prob, j_moreau, J.polynomial_schedule(0.4, -0.55))),
        "MYSGLD": (T.mysgld(tg.grad_log_prob, t_prox1, 0.1, T.polynomial_schedule(0.4, -0.55)),
                   J.mysgld(jg.grad_log_prob, j_prox1, 0.1, J.polynomial_schedule(0.4, -0.55))),
        "cyclicalSPGLD": (T.cyclical_spgld(tg.grad_log_prob, t_prox2, STEPS, 3, 0.09, 0.25),
                          J.cyclical_spgld(jg.grad_log_prob, j_prox2, STEPS, 3, 0.09, 0.25)),
        "cyclicalSPGLD-one-arg-prox": (
            T.cyclical_spgld(tg.grad_log_prob, t_prox1, STEPS, 3, 0.09, 0.25),
            J.cyclical_spgld(jg.grad_log_prob, j_prox1, STEPS, 3, 0.09, 0.25)),
        "contourSPGLD": (T.contour_spgld(tg.log_prob, t_prox2, sa_schedule=lambda s: _sa(s, np),
                                         **csg),
                         J.contour_spgld(jg.log_prob, j_prox2,
                                         sa_schedule=lambda s: _sa(s, jnp), **csg)),
    }


CASES = ["SGLD", "MSGLD", "cyclicalSGLD", "contourSGLD", "contourSGLD-defaults", "SPGLD",
         "SPGLD-one-arg-prox", "SSGLD", "MYSGLD", "cyclicalSPGLD",
         "cyclicalSPGLD-one-arg-prox", "contourSPGLD"]


def _inject(monkeypatch, step_of, dtype=torch.float64):
    """Patch the JAX module's draws to the port's draws of the step that
    ``step_of()`` names."""
    monkeypatch.setattr(J, "normal_like", lambda key, x: jnp.asarray(_np(normal_field(
        SEED, CHAIN, step_of(), tuple(x.shape), dtype, "cpu"))))
    monkeypatch.setattr(jax.random, "uniform", lambda key, *a, **k: jnp.asarray(_np(
        uniform_scalar(SEED, CHAIN, step_of(), dtype, "cpu"))))


def _run_jax(jk, x0, steps, monkeypatch, state=None):
    step = [0]
    _inject(monkeypatch, lambda: step[0])
    state = jk.init(jnp.asarray(x0)) if state is None else state
    out, infos, bins = [], [], []
    for i in range(steps):
        step[0] = i
        state, info = jk.step(state, jax.random.PRNGKey(0))
        out.append(np.asarray(state.position))
        infos.append(info)
        if state.extras is not None:
            bins.append(int(state.extras.energy_idx))
    return np.stack(out), infos, state, bins


@pytest.mark.parametrize("name", CASES)
def test_kernel_against_jax_same_noise(grids, monkeypatch, name):
    """30 steps in both packages on the same noise: the positions, the
    accept decisions and the cyclical phase flags, the energy bins, energies
    and final energy pdf of the contour kernels. The cyclical kernels run
    on the port's schedule in both (the float32 cosine of numpy and of XLA
    may part in the last bit; ``test_cyclical_schedule_matches_jax`` holds
    the schedules to each other)."""
    monkeypatch.setattr(J, "cyclical_cosine_schedule", lambda *a: (
        lambda step: tuple(jnp.asarray(v, jnp.float32 if i == 0 else bool) for i, v in
                           enumerate(T.cyclical_cosine_schedule(*a)(int(step))))))
    tk, jk = _kernels(grids)[name]
    extras = (lambda e: e.energy_idx) if name.startswith("contour") else False
    res = t_runner.run_chain(tk, torch.from_numpy(X0), (SEED, CHAIN), STEPS,
                             collect_extras=extras)
    want, infos, jstate, bins = _run_jax(jk, X0, STEPS, monkeypatch)
    if name.startswith("contour"):
        assert _np(res.extras).tolist() == bins
        _close(torch.stack([i.energy for i in res.infos]),
               np.asarray([i.energy for i in infos]), name=name)
        _close(res.final_state.extras.energy_pdf, jstate.extras.energy_pdf, name=name)
        assert int(res.final_state.extras.energy_idx) == int(jstate.extras.energy_idx)
    _close(res.samples, want, name=name)
    if name == "MSGLD":
        got = [bool(i.accepted) for i in res.infos]
        assert got == [bool(i.accepted) for i in infos] and 0 < sum(got), got
        _close(torch.stack([i.log_accept_ratio for i in res.infos]),
               np.asarray([i.log_accept_ratio for i in infos]))
    if name.startswith("cyclical"):
        flags = [bool(i.accepted) for i in res.infos]
        assert flags == [bool(i.accepted) for i in infos]
        assert 0 < sum(flags) < STEPS


def test_csgld_mult_clip_against_jax(grids, monkeypatch):
    """The JAX package's clip case (tests/test_sgld.py): a pdf with all its
    mass in one bin; 20 steps stay finite and equal JAX's."""
    jg, tg = grids
    kw = dict(num_partitions=64, energy_gap=0.25, zeta=0.75, temperature=50.0,
              lr_schedule=1e-3, mult_clip=100.0)
    tk, jk = T.csgld(tg.log_prob, **kw), J.csgld(jg.log_prob, **kw)
    pdf = np.full(64, 1e-30)
    pdf[1] = 1.0
    st = tk.init(torch.from_numpy(X0))
    st = st.__class__(position=st.position, step=0,
                      extras=st.extras._replace(energy_pdf=torch.from_numpy(pdf)))
    js = jk.init(jnp.asarray(X0))
    js = js.replace(extras=js.extras._replace(energy_pdf=jnp.asarray(pdf)))
    got = []
    for _ in range(20):
        st, _ = tk.step(st, (SEED, CHAIN, st.step))
        got.append(st.position)
    want = _run_jax(jk, X0, 20, monkeypatch, state=js)[0]
    assert bool(torch.isfinite(torch.stack(got)).all())
    _close(torch.stack(got), want)


def test_cyclical_schedule_matches_jax():
    """The cyclical schedule is float32 in both packages (the JAX package's
    int32 step divides to float32): its step sizes agree within
    ``initial_step_size * 2^-22``, the float32 cosines of numpy and XLA
    within 4 units of 2^-24 (the cosine's error carries over as it is, not
    relative to the step size, where ``cos + 1`` cancels), its flags
    exactly."""
    for n, cycles, g0, ratio in ((200, 4, 0.09, 0.25), (50000, 30, 0.09, 0.25), (7, 3, 1.0, 0.5)):
        ts, js = T.cyclical_cosine_schedule(n, cycles, g0, ratio), \
            J.cyclical_cosine_schedule(n, cycles, g0, ratio)
        for step in range(0, n, max(1, n // 97)):
            g, flag = ts(step)
            jg_, jflag = js(jnp.asarray(step, jnp.int32))
            assert jg_.dtype == jnp.float32 and np.float32(g) == g
            assert abs(g - float(jg_)) <= g0 * 2.0**-22 and flag == bool(jflag)
    assert T.polynomial_schedule(0.4, -0.55)(9) == pytest.approx(
        float(J.polynomial_schedule(0.4, -0.55)(jnp.asarray(9))), rel=1e-15)


def test_keyed_grad_and_stepped_prox_arities():
    """JAX's rule of parameters: two or more take the key (the step size),
    one does not; a ``functools.partial`` counts what it leaves, a ``*args``
    counts one."""
    seen = []
    keyed = lambda x, key: seen.append(key) or x
    plain = lambda x: x
    T._as_keyed_grad(keyed)(1.0, "k")
    T._as_keyed_grad(plain)(1.0, "k")
    T._as_keyed_grad(functools.partial(lambda a, x, key: seen.append(key) or x, 0))(1.0, "p")
    assert seen == ["k", "p"]
    assert T._as_keyed_grad(lambda *a: len(a))(1.0, "k") == 1
    assert T._as_stepped_prox(lambda x, g: x * g)(2.0, 3.0) == 6.0
    assert T._as_stepped_prox(lambda x: x + 1)(2.0, 3.0) == 3.0
    assert T._as_stepped_prox(functools.partial(lambda t, x, g: x - t * g, 1))(2.0, 0.5) == 1.5
    for fn in (keyed, plain, lambda *a: a, functools.partial(keyed, 1.0), len):
        assert (T._as_keyed_grad(fn) is fn) == (J._as_keyed_grad(fn) is fn)
        assert (T._as_stepped_prox(fn) is fn) == (J._as_stepped_prox(fn) is fn)


# --- minibatch estimator --------------------------------------------------------

DATA = np.random.default_rng(0).normal(loc=1.5, size=(200, 2))


def _t_prior(x):
    return -0.5 * torch.sum(x * x)


def _t_lik(x, d):
    return -0.5 * torch.sum((d - x) ** 2)


def _j_prior(x):
    return -0.5 * jnp.sum(x * x)


def _j_lik(x, d):
    return -0.5 * jnp.sum((d - x) ** 2)


def test_minibatch_full_batch_exact():
    """``data=None``: the prior's and the scaled likelihood's gradients."""
    x = np.array([0.3, -0.4])
    tl = lambda xx: torch.sum(-0.5 * (torch.from_numpy(DATA) - xx) ** 2)
    jl = lambda xx: jnp.sum(-0.5 * (jnp.asarray(DATA) - xx) ** 2)
    tg = T.minibatch_grad_estimator(_t_prior, tl, None, 200)
    jgf = J.minibatch_grad_estimator(_j_prior, jl, None, 200)
    _close(tg(torch.from_numpy(x), (1, 2, 3)), jgf(jnp.asarray(x), jax.random.PRNGKey(0)))


def test_minibatch_unbiased_and_equal_to_jax_on_its_batch(monkeypatch):
    """The mean of 400 minibatch gradients (keys of 400 steps) is the full
    gradient within 5% (the JAX package's test), and a step's gradient is
    JAX's on the same batch (its ``jax.random.choice`` returns the port's
    draw)."""
    x = np.array([0.3, -0.4])
    tg = T.minibatch_grad_estimator(_t_prior, _t_lik, torch.from_numpy(DATA), 200,
                                    batch_size=20)
    grads = np.stack([_np(tg(torch.from_numpy(x), (0, 5, i))) for i in range(400)])
    full = np.asarray(jax.grad(lambda xx: _j_prior(xx) + jnp.sum(jax.vmap(
        lambda d: _j_lik(xx, d))(jnp.asarray(DATA))))(jnp.asarray(x)))
    np.testing.assert_allclose(grads.mean(0), full, rtol=0.05)
    jgf = J.minibatch_grad_estimator(_j_prior, _j_lik, jnp.asarray(DATA), 200, batch_size=20)
    for step in (0, 7):
        idx = torch.argsort(uniform_field(0, 5, step, (200,), torch.float32, "cpu"),
                            stable=True)[:20]
        assert len(set(idx.tolist())) == 20
        monkeypatch.setattr(jax.random, "choice", lambda *a, **k: jnp.asarray(idx.numpy()))
        _close(tg(torch.from_numpy(x), (0, 5, step)),
               jgf(jnp.asarray(x), jax.random.PRNGKey(0)))


def test_minibatch_chain_axis_draws_each_chains_batch():
    """Over a chain axis each chain draws its own batch: row ``i`` is the
    one-chain gradient under word ``i``."""
    tg = T.minibatch_grad_estimator(_t_prior, _t_lik, torch.from_numpy(DATA), 200,
                                    batch_size=20)
    keys = chain_keys(4, 5)
    words = torch.tensor([w for _, w in keys])
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(5, 2)))
    got = tg(x, (4, words, 9))
    for i, (s, w) in enumerate(keys):
        _close(got[i], _np(tg(x[i], (s, w, 9))))


def test_sgld_with_minibatch_runs_chains(monkeypatch):
    """SGLD on the minibatch estimator under ``run_chains``: each chain
    equals its ``run_chain`` within the tolerance."""
    tg = T.minibatch_grad_estimator(_t_prior, _t_lik, torch.from_numpy(DATA), 200,
                                    batch_size=20)
    kern = T.sgld(tg, 1e-3)
    x0 = torch.from_numpy(X0)
    got = t_runner.run_chains(kern, x0, 2, 10, 3)
    for i, k in enumerate(chain_keys(2, 3)):
        _close(got.samples[i], _np(t_runner.run_chain(kern, x0, k, 10).samples))


# --- resampling, chain axis -----------------------------------------------------

def test_importance_resample_matches_jax():
    rng = np.random.default_rng(3)
    samples = rng.normal(size=(600, 2))
    idx = rng.integers(1, 40, 600)
    pdf = rng.dirichlet(np.ones(40))
    for key in (0, 7):
        want = J.csgld_importance_resample(samples, idx, pdf, zeta=0.75, key=key)
        got = T.csgld_importance_resample(samples, idx, pdf, zeta=0.75, key=key)
        assert got.shape == want.shape and np.array_equal(got, np.asarray(want))
    assert np.array_equal(T.csgld_importance_resample(samples, idx, pdf, key=(7, 3)),
                          T.csgld_importance_resample(samples, idx, pdf, key=7))
    assert T.csgld_importance_resample(samples, idx, np.ones(40), quantile=1.0).shape == (0, 2)


WORKLOAD = ["SGLD", "MSGLD", "cyclicalSGLD", "contourSGLD", "SPGLD", "SSGLD", "MYSGLD",
            "cyclicalSPGLD", "contourSPGLD"]


@pytest.mark.parametrize("name", WORKLOAD)
def test_chain_axis_bit_for_bit(grids, name):
    """``run_chains`` takes one step over all chains; every chain equals its
    one-chain run bit for bit: positions, extras, accept flags and energies,
    from one start and from one start a chain."""
    tg = grids[1]
    tk = t_runs.grid_kernels(tg, 40, num_partitions=500)[name]
    assert tk.chain_axis
    n_chains, key = 5, (6, 2)
    extras = (lambda e: e.energy_idx) if name.startswith("contour") else False
    starts = torch.from_numpy(np.random.default_rng(5).uniform(-6, 6, size=(n_chains, 2)))
    for x0 in (torch.from_numpy(X0), starts):
        got = t_runner.run_chains(tk, x0, key, 40, n_chains, collect="both",
                                  collect_extras=extras)
        for i, k in enumerate(chain_keys(key, n_chains)):
            one = t_runner.run_chain(tk, x0 if x0.ndim == 1 else x0[i], k, 40,
                                     collect="both", collect_extras=extras)
            assert torch.equal(got.samples[i], one.samples), name
            assert torch.equal(got.moments.m2[i], one.moments.m2)
            if extras:
                assert torch.equal(got.extras[i], one.extras)
                assert torch.equal(got.final_state.extras.energy_pdf[i],
                                   one.final_state.extras.energy_pdf)
                assert all(torch.equal(a.energy[i], b.energy)
                           for a, b in zip(got.infos, one.infos))
            if name == "MSGLD":
                assert all(bool(a.accepted[i]) == bool(b.accepted)
                           for a, b in zip(got.infos, one.infos))


# --- mode finder and CLI --------------------------------------------------------

def _jax_solve(jg, x0, steps, optimizer, lr):
    """The JAX CLI's solve (``optimize_grid_mixture``) from given starts,
    with every step's position and optimiser state."""
    opt = {"adam": optax.adam, "sgd": optax.sgd}[optimizer](lr)

    @jax.jit
    def solve(x0):
        def one(x):
            state = opt.init(x)

            def body(carry, _):
                x, state = carry
                g = jax.grad(lambda z: -jg.log_prob(z))(x)
                updates, state = opt.update(g, state, x)
                x = optax.apply_updates(x, updates)
                return (x, state), (x, state)

            (x, _), path = jax.lax.scan(body, (x, state), None, length=steps)
            return x, jg.log_prob(x), path

        return jax.vmap(one)(x0)

    return solve(jnp.asarray(x0))


def _torch_step(tg, x, optimizer, lr, state=None):
    """One ``torch.optim`` step of ``solve_restarts`` from ``x`` and (Adam)
    the moments and count ``state``."""
    p = torch.nn.Parameter(torch.from_numpy(np.array(x)))
    opt = {"adam": torch.optim.Adam, "sgd": torch.optim.SGD}[optimizer]([p], lr=lr)
    if state is not None:
        count, mu, nu = state
        opt.state[p] = {"step": torch.tensor(float(count)), "exp_avg": torch.from_numpy(
            np.array(mu)), "exp_avg_sq": torch.from_numpy(np.array(nu))}
    p.grad = -tg.grad_log_prob(p.detach())
    opt.step()
    return p.detach()


@pytest.mark.parametrize("optimizer,steps", [("adam", 2000), ("sgd", 300)])
def test_mode_finder_solve_matches_optax(grids, optimizer, steps):
    """``solve_restarts`` (torch.optim over one parameter) against optax's
    vmapped restarts from the same 16 starts: every one of the steps, taken
    from the JAX trajectory's state, within 1e-12 (Adam: within ``TOL_ADAM``
    = 1e-9 over the 2000 steps, each held alone), and the free-running
    solves to the same snapped mode for every restart with the best
    log-probability within 1e-9. Free-running, a restart whose gradient
    sits near Adam's eps (1e-8) parts from optax's by up to 1e-3 in the
    coordinate that creeps to its mode (restart 13 here), so the positions
    of the free runs are held through their modes."""
    jg, tg = grids
    x0 = np.random.default_rng(4).uniform(-10, 10, size=(16, 2))
    xs, logps = t_runs.solve_restarts(tg, torch.from_numpy(x0), steps, optimizer, 0.05)
    jxs, jlogps, (path, states) = _jax_solve(jg, x0, steps, optimizer, 0.05)
    path = np.asarray(path)  # (16, steps, 2)
    prev = np.concatenate([x0[:, None], path[:, :-1]], 1)
    for t in range(steps):
        state = None
        if optimizer == "adam":
            adam = states[0]
            state = (t, np.zeros_like(x0), np.zeros_like(x0)) if t == 0 else (
                t, np.asarray(adam.mu)[:, t - 1], np.asarray(adam.nu)[:, t - 1])
        _close(_torch_step(tg, prev[:, t], optimizer, 0.05, state), path[:, t], TOL,
               f"{optimizer} step {t}")
    snap = lambda a: np.round(np.asarray(a) / 2.0) * 2.0
    assert np.array_equal(snap(_np(xs)), snap(jxs))
    assert abs(float(logps.max()) - float(jlogps.max())) <= TOL_ADAM


def test_cli_on_cpu_and_card_default():
    """The CLI at k=200 on the CPU: the nine samplers, the JAX summary's
    keys and ``modes_covered``; the cyclical samplers keep their sampling
    steps. Without a card and without ``device="cpu"`` the CLI and the
    mode finder raise, naming the card."""
    samples, summary = t_runs.sgld_grid_mixture(k=200, device="cpu")
    assert list(samples) == WORKLOAD
    assert {"workload", "k", "iters_per_sec", "retained", "modes_covered"} <= set(summary)
    sampling = sum(((s % (200 // 30)) / (200 // 30)) >= 0.25 for s in range(200))
    assert summary["retained"]["cyclicalSGLD"] == sampling
    for name, s in samples.items():
        assert s.ndim == 2 and s.shape[1] == 2 and np.isfinite(s).all(), name
        assert 0 <= summary["modes_covered"][name] <= 25
        assert summary["modes_covered"][name] == t_runs.modes_covered(s)
    xs, logps, opt = t_runs.optimize_grid_mixture(steps=50, n_restarts=8, device="cpu")
    assert xs.shape == (8, 2) and opt["restarts"] == 8 and 0 <= opt["modes_found"] <= 8
    if not torch.cuda.is_available():
        for fn in (t_runs.sgld_grid_mixture, t_runs.optimize_grid_mixture):
            with pytest.raises(RuntimeError, match="card"):
                fn()


def test_modes_covered_counts_unit_distance():
    pts = np.array([[0.0, 0.0], [0.99, 0.0], [2.0, 2.9], [4.72, -4.72], [10.0, 10.0]])
    assert t_runs.modes_covered(pts) == 2
    assert t_runs.modes_covered(np.zeros((0, 2))) == 0
    chains = np.random.default_rng(3).uniform(-6, 6, size=(70, 40, 2))
    assert t_runs.chain_modes_covered(chains).tolist() == [t_runs.modes_covered(c)
                                                           for c in chains]


def test_grid_modes_and_setup_match_the_target(grids):
    """``GRID_MODES`` are the JAX target's 25 means; ``grid_setup`` builds
    the CLI's target, its start in [-10, 10]^2 and the nine samplers."""
    jg, _ = grids
    got = {tuple(m) for m in t_runs.GRID_MODES}
    assert len(got) == 25 and got == {tuple(m) for m in np.asarray(jg.mus, np.float64)}
    gm, x0, kernels = t_runs.grid_setup(60, 3, torch.device("cpu"))
    assert x0.shape == (2,) and x0.dtype == torch.float32 and bool((x0.abs() <= 10).all())
    assert torch.equal(x0, -10 + 20 * uniform_field(3, 0, 0, (2,), torch.float32, "cpu"))
    assert list(kernels) == ["SGLD", "MSGLD", "cyclicalSGLD", "contourSGLD", "SPGLD", "SSGLD",
                             "MYSGLD", "cyclicalSPGLD", "contourSPGLD"]
    _close(gm.log_prob(x0), jg.log_prob(jnp.asarray(x0.double().numpy())), 1e-6)  # f32


def test_step_key_and_normal_like_are_the_steps_noise():
    """``step_key`` is the key a kernel's step receives (the JAX package's
    ``fold_in(base, step)``) and ``normal_like`` its normal over ``x`` (JAX:
    a standard normal of ``x``'s shape and dtype): an SGLD chain with no
    gradient and step 1/2 adds exactly ``normal_like(step_key(key, i), x)``
    at step ``i``, one chain or a chain axis. The streams differ from
    threefry's by design; both packages give a fresh draw a step."""
    from lmc_atomi_torch.core.random import normal_like, step_key
    from lmc_atomi_tpu.core import random as j_random

    kern = T.sgld(lambda x: torch.zeros_like(x), 0.5)
    x0 = torch.zeros(3, dtype=torch.float64)
    res = t_runner.run_chain(kern, x0, (7, 2), 5)
    x = x0
    for i in range(5):
        assert step_key((7, 2), i) == (7, 2, i)
        x = x + normal_like(step_key((7, 2), i), x)
        assert torch.equal(res.samples[i], x), i
    many = t_runner.run_chains(kern, x0, 7, 5, 4)
    words = torch.tensor([w for _, w in chain_keys(7, 4)])
    xs = torch.zeros(4, 3, dtype=torch.float64)
    for i in range(5):
        xs = xs + normal_like(step_key((7, words), i), xs)
    assert torch.equal(many.samples[:, -1], xs)
    assert torch.equal(xs[1], t_runner.run_chain(kern, x0, chain_keys(7, 4)[1], 5).samples[-1])
    base = jax.random.PRNGKey(7)
    jx = jnp.zeros(3)
    draws = [j_random.normal_like(j_random.step_key(base, i), jx) for i in range(2)]
    assert draws[0].shape == jx.shape and draws[0].dtype == jx.dtype
    assert jnp.array_equal(j_random.step_key(base, 1), jax.random.fold_in(base, 1))
    assert not jnp.array_equal(draws[0], draws[1])
    t0 = normal_like(step_key(7, 0), x0)
    assert t0.shape == x0.shape and t0.dtype == x0.dtype
    assert not torch.equal(t0, normal_like(step_key(7, 1), x0))
