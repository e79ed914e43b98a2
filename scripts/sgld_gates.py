"""Gates of the SG-MCMC path of ``chip_smoke.py``, from the JAX package.

Runs the JAX package's workload-5 CLI (``sgld_grid_mixture``, the nine
SG-MCMC samplers on the 25-mode grid, one chain each) at the path's depth
``k`` = 1000 and ``optimize_grid_mixture`` at its defaults, on the CPU, for
seeds 0..15, and prints as its last line one JSON object:

  * ``modes_covered``: for each sampler the modes with a retained draw
    within unit distance (``lmc_atomi_torch.experiments.sgld_runs.
    modes_covered``, RESULTS.md's count) of each seed, their standard
    deviation ``sd``, and the gate ``[max(0, min - ceil(sd)), min(25, max +
    ceil(sd))]`` over them (0 where the seeds read that low: the JAX
    package itself covers no mode on some seeds of the contour samplers);
  * ``modes_found``: ``optimize_grid_mixture``'s distinct recovered modes of
    each seed, ``sd`` and the gate ``[min - ceil(sd), max + ceil(sd)]``;
  * ``batched``: for each sampler, built as the CLI builds it for k = 1000,
    the mean and standard deviation over CHAINS chains of ``run_chains``
    (STEPS steps from the port's CLI start at seed 0) of each chain's modes
    covered (``chain_modes_covered``, every draw). The chip path runs the
    port's kernels from the same start and holds its mean over its own
    chains to this one within 4 standard errors of the difference: a
    distribution against a distribution, where one chain's count spreads
    too widely to tell much.

The seeds move the start and the noise, which the port draws otherwise, so
the gates span what the JAX package does from 16 starts, widened by one
standard deviation of the seeds' readings: past the extremes of 16 seeds,
one more seed of the same sampler falls outside that rarely.

    JAX_PLATFORMS=cpu python scripts/sgld_gates.py | tail -n 1 > gates.json
"""
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from lmc_atomi_torch.experiments.sgld_runs import (  # noqa: E402
    chain_modes_covered,
    grid_setup,
    modes_covered,
)
from lmc_atomi_tpu.experiments.configs import GRID_POSITIONS  # noqa: E402
from lmc_atomi_tpu.experiments.sgld_runs import (  # noqa: E402
    optimize_grid_mixture,
    sgld_grid_mixture,
)
from lmc_atomi_tpu.kernels import sgmcmc as S  # noqa: E402
from lmc_atomi_tpu.models import GridGaussianMixture  # noqa: E402
from lmc_atomi_tpu.ops.prox import prox_laplace  # noqa: E402
from lmc_atomi_tpu.run.runner import run_chains_jit  # noqa: E402

K, SEEDS = 1000, tuple(range(16))
CHAINS, STEPS = 256, 500


def jax_grid_kernels(k):
    """The JAX CLI's nine samplers at its defaults for a run of ``k``
    steps (``lmc_atomi_tpu/experiments/sgld_runs.py``, as it builds them)."""
    gm = GridGaussianMixture.create(GRID_POSITIONS, sigma=0.03, lam=1 / 25.0)
    sched, sched_8 = S.polynomial_schedule(0.05, -0.55), S.polynomial_schedule(0.4, -0.55)
    prox_fn = lambda x, g: prox_laplace(x, g)
    prox_my = lambda x: prox_laplace(x, 0.1)
    moreau_grad = lambda x: (x - prox_my(x)) / 0.1
    contour = dict(num_partitions=100000, energy_gap=0.25, zeta=0.75, temperature=50.0,
                   lr_schedule=1e-3,
                   sa_schedule=lambda step: jnp.minimum(1e-2, (step + 100.0) ** (-0.8)) * 10.0)
    return {
        "SGLD": S.sgld(gm.grad_log_prob, sched),
        "MSGLD": S.msgld(gm.log_prob, gm.grad_log_prob, sched_8),
        "cyclicalSGLD": S.cyclical_sgld(gm.grad_log_prob, k, 30, 0.09, 0.25),
        "contourSGLD": S.csgld(gm.log_prob, **contour),
        "SPGLD": S.spgld(gm.grad_log_prob, prox_fn, sched_8),
        "SSGLD": S.ssgld(gm.grad_log_prob, moreau_grad, sched_8),
        "MYSGLD": S.mysgld(gm.grad_log_prob, prox_my, 0.1, sched_8),
        "cyclicalSPGLD": S.cyclical_spgld(gm.grad_log_prob, prox_fn, k, 30, 0.09, 0.25),
        "contourSPGLD": S.contour_spgld(gm.log_prob, prox_fn, **contour),
    }


def batched():
    """Mean and standard deviation of the per-chain modes covered over
    CHAINS chains x STEPS steps of each sampler from the port's start."""
    x0 = jnp.asarray(grid_setup(K, 0, torch.device("cpu"))[1].numpy())
    out = {}
    for i, (name, kern) in enumerate(jax_grid_kernels(K).items()):
        res = run_chains_jit(kern, x0, jax.random.PRNGKey(1000 + i), STEPS, CHAINS,
                             collect="samples", collect_extras=False)
        cov = chain_modes_covered(np.asarray(res.samples))
        out[name] = {"mean": float(cov.mean()), "sd": float(cov.std(ddof=1))}
        print(name, out[name], file=sys.stderr, flush=True)
    return out


def main():
    batch = batched()
    covered, found = {}, []
    for seed in SEEDS:
        samples, _ = sgld_grid_mixture(k=K, seed=seed, make_plots=False)
        for name, s in samples.items():
            covered.setdefault(name, []).append(modes_covered(s))
        found.append(optimize_grid_mixture(seed=seed)[2]["modes_found"])
        print(seed, {n: v[-1] for n, v in covered.items()}, found[-1], file=sys.stderr,
              flush=True)
    def band(v, lo=-math.inf, hi=math.inf):
        sd = float(np.std(v, ddof=1))
        slack = math.ceil(sd)
        return {"seeds": v, "sd": round(sd, 3),
                "gate": [int(max(lo, min(v) - slack)), int(min(hi, max(v) + slack))]}

    out = {
        "k": K,
        "modes_covered": {n: band(v, 0, 25) for n, v in covered.items()},
        "modes_found": band(found),
        "batched": {"chains": CHAINS, "steps": STEPS, "x0": "the port's CLI start, seed 0",
                    "modes_covered": batch},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
