"""The port's Wasserstein evaluation (``lmc_atomi_torch/eval/wasserstein.py``
and its own ``emd_native.py``) against the JAX package's, in f64: Sinkhorn,
its masked prefix curves and the sliced distance within 1e-9, the exact
network simplex equal; and the three mixture workload CLIs, whose quality
metric it is, against the JAX package's: the summary keys, and the pooled
means of 256 chains within 5 standard errors."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch.eval import emd_native as t_emd
from lmc_atomi_torch.eval import wasserstein as t_w
from lmc_atomi_torch.experiments import laplace_mixtures as t_lapmix
from lmc_atomi_torch.experiments import mixtures as t_mix
from lmc_atomi_torch.experiments import prox_mixtures as t_proxmix
from lmc_atomi_torch.utils.cli import auto_cli
from lmc_atomi_tpu.eval import wasserstein as j_w
from lmc_atomi_tpu.experiments import laplace_mixtures as j_lapmix
from lmc_atomi_tpu.experiments import mixtures as j_mix
from lmc_atomi_tpu.experiments import prox_mixtures as j_proxmix

torch.set_num_threads(2)

TOL = 1e-9


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _pts(n, seed, shift=0.0):
    return np.random.default_rng(seed).normal(size=(n, 2)) + shift


def test_pairwise_and_logsumexp_masked():
    """The cost matrix, and torch's logsumexp where -inf log-weights mask
    entries (a whole row too): JAX's values, no NaN."""
    x, y = _pts(30, 0), _pts(20, 1, 0.5)
    _close(t_w.pairwise_sq_dists(torch.from_numpy(x), torch.from_numpy(y)),
           j_w.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(y)))
    a = np.random.default_rng(2).normal(size=(4, 6))
    a[1, :3] = -np.inf
    a[2, :] = -np.inf
    got = torch.logsumexp(torch.from_numpy(a), dim=-1)
    want = np.asarray(jax.scipy.special.logsumexp(jnp.asarray(a), axis=-1))
    assert not bool(torch.isnan(got).any())
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    _close(got[~torch.isinf(got)], want[~np.isinf(want)])


@pytest.mark.parametrize("debias", [True, False])
def test_sinkhorn_w2(debias):
    x, y = _pts(40, 3), _pts(30, 4, 1.0)
    lw = np.log(np.random.default_rng(5).uniform(0.5, 1.5, 30))
    lw -= np.log(np.exp(lw).sum())
    lw[::4] = -np.inf  # masked points
    lw -= np.log(np.exp(lw).sum())
    for log_wy in (None, lw):
        got = t_w.sinkhorn_w2(torch.from_numpy(x), torch.from_numpy(y),
                              log_wy=None if log_wy is None else torch.from_numpy(log_wy),
                              debias=debias, iters=100)
        want = j_w.sinkhorn_w2(jnp.asarray(x), jnp.asarray(y),
                               log_wy=None if log_wy is None else jnp.asarray(log_wy),
                               debias=debias, iters=100)
        assert bool(torch.isfinite(got))
        _close(got, want)


def test_sliced_w2_same_directions(monkeypatch):
    """The port's directions (a torch.Generator's normals) handed to JAX
    through its ``jax.random.normal`` draw."""
    x, y = _pts(50, 6), _pts(50, 7, 0.3)
    got = t_w.sliced_w2(torch.from_numpy(x), torch.from_numpy(y),
                        torch.Generator().manual_seed(3), n_proj=16)
    dirs = torch.randn((16, 2), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(dirs.numpy()))
    _close(got, j_w.sliced_w2(jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0),
                              n_proj=16))


@pytest.mark.parametrize("chunk_bytes", [None, 1])
def test_w2_prefix_curve(monkeypatch, chunk_bytes):
    """Masked-weight prefix curves, strided (max_points below the sizes),
    in one chunk and one prefix a chunk."""
    if chunk_bytes is not None:
        monkeypatch.setattr(t_w, "_CHUNK_BYTES", chunk_bytes)
    true, s = _pts(130, 8), _pts(250, 9, 0.4)
    ks, vals = t_w.w2_prefix_curve(torch.from_numpy(true), torch.from_numpy(s), interval=40,
                                   iters=60, max_points=100)
    jks, jvals = j_w.w2_prefix_curve(jnp.asarray(true), jnp.asarray(s), interval=40,
                                     iters=60, max_points=100)
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    assert bool(torch.isfinite(vals).all())
    _close(vals, jvals)


def test_exact_w2_equals_jax():
    x, y = _pts(60, 10), _pts(45, 11, 0.7)
    assert t_emd.available()
    assert t_w.exact_w2(torch.from_numpy(x), torch.from_numpy(y)) == j_w.exact_w2(x, y)
    assert t_w.exact_w2(x, y[:45]) == j_w.exact_w2(x, y[:45])
    assert t_w.exact_w2_assignment(x[:45], y) == j_w.exact_w2_assignment(x[:45], y)
    ks, vals = t_w.w2_prefix_curve_exact(x, y, interval=20)
    jks, jvals = j_w.w2_prefix_curve_exact(x, y, interval=20)
    np.testing.assert_array_equal(ks, jks)
    np.testing.assert_array_equal(vals, jvals)


def test_exact_w2_multiscale():
    """k >= n: every point its own centroid, the exact distance (JAX's);
    k < n: the certified radius holds."""
    x, y = _pts(40, 12), _pts(30, 13, 0.5)
    got, err = t_w.exact_w2_multiscale(torch.from_numpy(x), torch.from_numpy(y), k=64)
    want, jerr = j_w.exact_w2_multiscale(jnp.asarray(x), jnp.asarray(y), k=64)
    _close(got, want)
    assert err < 1e-7 and jerr < 1e-7
    exact = np.sqrt(t_w.exact_w2(x, y))
    got, err = t_w.exact_w2_multiscale(torch.from_numpy(x), torch.from_numpy(y), k=8,
                                       generator=torch.Generator().manual_seed(1))
    assert err > 0 and abs(np.sqrt(got) - exact) <= err + 1e-12


# -- the workload CLIs ------------------------------------------------------
WORKLOADS = {
    "gaussian": (t_mix.lmc_gaussian_mixture, j_mix.lmc_gaussian_mixture, dict(eval_w2=False)),
    "laplace": (t_lapmix.lmc_laplacian_mixture, j_lapmix.lmc_laplacian_mixture,
                dict(eval_w2=False)),
    "prox": (t_proxmix.prox_lmc_gaussian_mixture, j_proxmix.prox_lmc_gaussian_mixture, {}),
}
POOL_CHAINS, POOL_K = 256, 200
# the JAX package's figure names at k=10, n=3 and the CLIs' default steps
# (lmc_atomi_tpu/experiments/{mixtures,laplace_mixtures,prox_mixtures}.py)
_STEMS = {"gaussian": "fig_n3_gamma0.05_10", "laplace": "fig_laplace_n3_gamma0.05_lambda0.1_10",
          "prox": "fig_prox_n3_gamma0.05_lambda0.01_10"}
FIGURES = {wl: [f"{stem}{s}.pdf" for s in
                (("_1", "_1_smooth", "_2", "_3") if wl == "prox" else
                 ("_1", "_2", "_3", "_wass_dist"))]
           for wl, stem in _STEMS.items()}


@pytest.fixture(scope="module")
def pooled():
    """Each workload at n=3, 256 chains x 200 steps in both packages from
    the same start (the port's ``x0``, handed to the JAX CLI through its
    ``jax.random.normal`` draw of the start): the samples and summaries."""
    out = {}
    orig = jax.random.normal
    for wl, (tfn, jfn, kw) in WORKLOADS.items():
        tsamples, *_, tsummary = tfn(n=3, k=POOL_K, n_chains=POOL_CHAINS, device="cpu", **kw)
        x0 = torch.randn(2, generator=torch.Generator().manual_seed(0)).double().numpy()

        def normal(key, shape=(), *a, **k):
            # the start is the one draw of shape (2,) with no dtype given
            if tuple(shape) == (2,) and not a and not k:
                return jnp.asarray(x0)
            return orig(key, shape, *a, **k)
        jax.random.normal = normal
        try:
            jsamples, *_, jsummary = jfn(n=3, k=POOL_K, n_chains=POOL_CHAINS, make_plots=False,
                                         **kw)
        finally:
            jax.random.normal = orig
        out[wl] = (tsamples, tsummary, jsamples, jsummary)
    return out


@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_pooled_means_against_jax(pooled, workload):
    """Over 256 chains x 200 steps each sampler's pooled mean lies within 5
    standard errors (of the chain means, both packages) of JAX's."""
    tsamples, tsummary, jsamples, jsummary = pooled[workload]
    assert set(tsummary) == set(jsummary)
    assert set(tsummary["iters_per_sec"]) == set(jsummary["iters_per_sec"]) == set(tsamples)
    for name, ts in tsamples.items():
        means = [np.asarray(s, np.float64).reshape(POOL_CHAINS, POOL_K, 2).mean(1)
                 for s in (ts, jsamples[name])]
        se = np.sqrt(sum(m.var(0, ddof=1) / POOL_CHAINS for m in means))
        gap = np.abs(means[0].mean(0) - means[1].mean(0))
        assert np.all(np.isfinite(ts)) and np.all(gap < 5 * se), (name, gap, se)


@pytest.mark.parametrize("n_chains", [1, 4])
@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_cli_summary_keys(pooled, capsys, tmp_path, workload, n_chains):
    """The CLI at k=200, n=3 prints the JAX package's summary keys, every
    sampler's W2 where it has the curve; with ``make_plots`` it writes the
    JAX package's figures; without a card its default device raises."""
    tfn, _, _ = WORKLOADS[workload]
    jsummary = pooled[workload][3]
    auto_cli(tfn, ["--k", "200", "--n", "3", "--n_chains", str(n_chains), "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == set(jsummary)
    assert summary["k"] == 200 and summary["n"] == 3
    for key in ("final_w2", "min_ess"):
        if key in summary:
            assert set(summary[key]) == set(jsummary["iters_per_sec"])
            assert all(np.isfinite(v) for v in summary[key].values())
    tfn(k=10, n=3, n_chains=n_chains, device="cpu", make_plots=True, outdir=str(tmp_path))
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(FIGURES[workload])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            tfn(k=10, n=3)


