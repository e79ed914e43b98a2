"""Seed spread of the mixtures section's exact-W2 row, in both packages.

The row (``make_results.py::_mixtures_multiscale`` and its port) runs ONE
ULA chain (gamma=0.05) of 40000 steps on the 3-component mixture from 0 and
takes the exact W2 of every 4th draw against as many true draws. Here that
run is repeated for seeds 0..7 in the JAX package (key ``PRNGKey(seed)``, as
the JAX row's seed 0) and in the port (chain key ``fold_in(seed, 2)``), on
the CPU, with each chain's mode occupancy (the nearest mean) and its number
of mode changes; prints as its last line one JSON object.

    JAX_PLATFORMS=cpu python scripts/mixture_w2_seeds.py | tail -n 1
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

SEEDS = tuple(range(8))
K, GAMMA, N_MODES = 40000, 0.05, 3


def _stats(draws, truth, mus, exact_w2):
    lab = np.argmin(((draws[:, None, :] - mus[None]) ** 2).sum(-1), 1)
    return {"w2_10k": float(np.sqrt(exact_w2(truth[::4], draws[::4]))),
            "occupancy": (np.bincount(lab, minlength=len(mus)) / len(lab)).tolist(),
            "mode_changes": int((lab[1:] != lab[:-1]).sum())}


def jax_rows():
    from lmc_atomi_tpu.eval.wasserstein import exact_w2
    from lmc_atomi_tpu.experiments.configs import gaussian_mixture_config
    from lmc_atomi_tpu.kernels import ula
    from lmc_atomi_tpu.models import GaussianMixture
    from lmc_atomi_tpu.run.runner import run_chain

    mus, sigmas, omegas = gaussian_mixture_config(n=N_MODES)
    model = GaussianMixture.create(mus, sigmas, omegas)
    rows = {}
    for seed in SEEDS:
        key = jax.random.PRNGKey(seed)
        truth = model.sample(jax.random.fold_in(key, 1), K)
        res = run_chain(ula(model.grad_potential, gamma=GAMMA), jnp.zeros((2,)),
                        jax.random.fold_in(key, 2), K, collect="samples")
        rows[seed] = _stats(np.asarray(res.samples), truth, np.asarray(mus),
                            lambda x, y: float(exact_w2(x, y)))
    return rows


def port_rows():
    from lmc_atomi_torch.core.random import fold_in
    from lmc_atomi_torch.eval.wasserstein import exact_w2
    from lmc_atomi_torch.experiments.configs import gaussian_mixture_config
    from lmc_atomi_torch.kernels import ula
    from lmc_atomi_torch.models import GaussianMixture
    from lmc_atomi_torch.run.runner import run_chain

    mus, sigmas, omegas = gaussian_mixture_config(n=N_MODES)
    model = GaussianMixture.create(mus, sigmas, omegas, dtype=torch.float32, device="cpu")
    rows = {}
    for seed in SEEDS:
        truth = model.sample(torch.Generator().manual_seed(seed * 10 + 1), K)
        res = run_chain(ula(model.grad_potential, gamma=GAMMA), torch.zeros(2),
                        fold_in(seed, 2), K, collect="samples")
        rows[seed] = _stats(res.samples.numpy(), truth, np.asarray(mus), exact_w2)
    return rows


def main():
    t0 = time.perf_counter()
    out = {"jax": jax_rows(), "port": port_rows()}
    for pkg in ("jax", "port"):
        w = [r["w2_10k"] for r in out[pkg].values()]
        out[f"{pkg}_w2_mean"], out[f"{pkg}_w2_range"] = float(np.mean(w)), [min(w), max(w)]
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))


if __name__ == "__main__":
    main()
