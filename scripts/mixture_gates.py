"""Gates of the mixtures path of ``chip_smoke.py``, from the JAX package.

Runs the JAX package's three mixture workloads on the CPU at the path's
configuration (n=5, the CLI defaults, k=1000, 1024 chains, f32) for seeds
0..3 and prints as its last line (the CLIs print their summaries before it)
one JSON object, for each sampler:

  * ``w2``: the final Sinkhorn W2 of ``w2_prefix_curve`` (its last
    prefix, k = 902, computed alone as the curve computes it) of chains 0
    and 1 of every seed against that seed's true samples, and the gate
    ``[0.5 min, 1.5 max]`` over them;
  * ``mean``: the pooled mean of each seed's 1024 chains and the standard
    error of its chain means, and the gate ``[min (mean - 5 se), max (mean +
    5 se)]`` over the seeds, per coordinate.

The seeds move the start (``x0``) and the noise, which the port draws
otherwise, so the gates span what the JAX package does from several starts.

    JAX_PLATFORMS=cpu python scripts/mixture_gates.py | tail -n 1 > gates.json   # ~6 min
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from lmc_atomi_tpu.eval.wasserstein import (  # noqa: E402
    _ot_entropic,
    pairwise_sq_dists,
    sinkhorn_w2,
)
from lmc_atomi_tpu.experiments import laplace_mixtures, mixtures, prox_mixtures  # noqa: E402
from lmc_atomi_tpu.experiments.configs import (  # noqa: E402
    gaussian_mixture_config,
    laplace_mixture_config,
)
from lmc_atomi_tpu.models import GaussianMixture, LaplaceMixture  # noqa: E402

N, K, CHAINS, SEEDS, W2_CHAINS = 5, 1000, 1024, (0, 1, 2, 3), (0, 1)


def truth(workload, seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 123)
    if workload == "gaussian":
        return GaussianMixture.create(*gaussian_mixture_config(N)).sample(key, K)
    mus, alphas, omegas = laplace_mixture_config(N, 0.1)
    return LaplaceMixture.create(mus, alphas, omegas, 0.1).sample(key, K)


@jax.jit
def final_w2(true, s):
    """``w2_prefix_curve(true, s)[1][-1]`` for ``K`` points of each (stride
    1): the prefix k = 902 under the curve's cost scale and OT(true, true)."""
    eps, iters, k = 0.05, 200, (K - 1) // 100 * 100 + 2
    scale = jnp.maximum(jnp.max(pairwise_sq_dists(true, s)), 1e-30)
    log_wt = jnp.full((K,), -jnp.log(K), true.dtype)
    ot_tt = _ot_entropic(true, true, log_wt, log_wt, eps * scale, iters)
    log_w = jnp.where(jnp.arange(K) < k, -jnp.log(float(k)), -jnp.inf).astype(s.dtype)
    val = sinkhorn_w2(true, s, None, log_w, eps=eps, iters=iters, scale=scale, ot_xx=ot_tt)
    return jnp.sqrt(jnp.maximum(val, 0.0))


def main():
    runs = {"gaussian": lambda s: mixtures.lmc_gaussian_mixture(
                n=N, k=K, seed=s, n_chains=CHAINS, make_plots=False, eval_w2=False)[0],
            "laplace": lambda s: laplace_mixtures.lmc_laplacian_mixture(
                n=N, k=K, seed=s, n_chains=CHAINS, make_plots=False, eval_w2=False)[0],
            "prox": lambda s: prox_mixtures.prox_lmc_gaussian_mixture(
                n=N, k=K, seed=s, n_chains=CHAINS, make_plots=False)[0]}
    out = {}
    for workload, run in runs.items():
        rows = {}
        for seed in SEEDS:
            samples = run(seed)
            true = truth(workload, seed) if workload != "prox" else None
            for name, s in samples.items():
                row = rows.setdefault(name, {"w2": [], "mean": [], "se": []})
                chains = np.asarray(s, np.float64).reshape(CHAINS, K, 2)
                cm = chains.mean(1)
                row["mean"].append(cm.mean(0).tolist())
                row["se"].append((cm.std(0, ddof=1) / CHAINS**0.5).tolist())
                if true is not None:
                    for c in W2_CHAINS:
                        row["w2"].append(float(final_w2(
                            true, jnp.asarray(chains[c], jnp.float32))))
                print(workload, seed, name, row["w2"][-len(W2_CHAINS):], row["mean"][-1],
                      file=sys.stderr, flush=True)
        for row in rows.values():
            m, se = np.asarray(row["mean"]), np.asarray(row["se"])
            row["mean_gate"] = [(m - 5 * se).min(0).tolist(), (m + 5 * se).max(0).tolist()]
            if row["w2"]:
                row["w2_gate"] = [0.5 * min(row["w2"]), 1.5 * max(row["w2"])]
        out[workload] = rows
    print(json.dumps(out))


if __name__ == "__main__":
    main()
