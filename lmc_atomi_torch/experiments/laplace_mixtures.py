"""Workload 2: Laplacian-mixture LMC on the Moreau-smoothed potential
(counterpart of ``lmc_atomi_tpu/experiments/laplace_mixtures.py``; reference
lmc_laplace.py:220-483).

ULA, MALA, PULA, IHPULA and MLA on the smoothed potential; the truth is
ancestral Laplace sampling; the W2 curves read the first ``min(k, k_eval)``
samples (the reference's truncation, lmc_laplace.py:387-392).

    python -m lmc_atomi_torch.experiments.laplace_mixtures --k 5000 --n 5
    python -m lmc_atomi_torch.experiments.laplace_mixtures --k 200 --n 3 --device cpu
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from lmc_atomi_torch.experiments.mixtures import (
    BETA,
    M_PRE,
    iters_per_sec,
    plot_grid,
    plot_samplers,
    run_samplers,
    w2_curves,
)


def laplace_setup(n: int, alpha: float, lamda: float, seed: int, dev,
                  gamma_ula: float = 5e-2, gamma_mala: float = 5e-2,
                  gamma_pula: float = 5e-2, gamma_ihpula: float = 5e-2,
                  gamma_mla: float = 5e-2):
    """The workload's f32 smoothed target on ``dev``, its generator (seeded
    with ``seed``, past the start's draw), the start and the five kernels."""
    from lmc_atomi_torch.experiments.configs import laplace_mixture_config
    from lmc_atomi_torch.kernels import ihpula, mala, mla, pula, ula
    from lmc_atomi_torch.models import LaplaceMixture

    mus, alphas, omegas = laplace_mixture_config(n, alpha)
    lm = LaplaceMixture.create(mus, alphas, omegas, lamda, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.randn(2, generator=gen, dtype=torch.float32, device=dev)
    kernels = {
        "ULA": ula(lm.grad_smooth_potential, gamma_ula)._replace(chain_axis=True),
        "MALA": mala(lm.smooth_log_density, lm.grad_smooth_potential,
                     gamma_mala)._replace(chain_axis=True),
        "PULA": pula(lm.grad_smooth_potential, gamma_pula, torch.tensor(M_PRE, device=dev)),
        "IHPULA": ihpula(lm.grad_smooth_potential, lm.hess_smooth_potential, gamma_ihpula,
                         shift=0.02),  # reference lmc_laplace.py:186
        "MLA": mla(lm.grad_smooth_potential, gamma_mla, torch.tensor(BETA, device=dev)),
    }
    return lm, gen, x0, kernels


def lmc_laplacian_mixture(
    gamma_ula: float = 5e-2,
    gamma_mala: float = 5e-2,
    gamma_pula: float = 5e-2,
    gamma_ihpula: float = 5e-2,
    gamma_mla: float = 5e-2,
    lamda: float = 1e-1,
    alpha: float = 1e-1,
    n: int = 5,
    k: int = 5000,
    k_eval: int = 10000,
    seed: int = 0,
    n_chains: int = 1,
    outdir: str = "fig",
    make_plots: bool = False,
    eval_w2: bool = True,
    w2_interval: int = 100,
    eval_w2_exact: bool = False,  # exact EMD at the final prefix
    eval_w2_tail: bool = False,  # also exact EMD on the LAST k_eval samples
    device: str = "cuda",
):
    """Sample the smoothed n-component Laplacian mixture with five Langevin
    kernels; returns ``(samples, curves, summary)`` as the JAX package's
    version does (samples as numpy arrays)."""
    from lmc_atomi_torch.eval.wasserstein import exact_w2
    from lmc_atomi_torch.utils.cli import require_device

    dev = require_device(device, "Laplacian-mixture")
    lm, gen, x0, kernels = laplace_setup(n, alpha, lamda, seed, dev, gamma_ula, gamma_mala,
                                         gamma_pula, gamma_ihpula, gamma_mla)
    samples, timings = run_samplers(kernels, x0, seed, k, n_chains, accept_of=("MALA",))
    k_true = min(k, k_eval)
    true = lm.sample(gen, k_true)
    curves = w2_curves(true, samples, w2_interval) if eval_w2 else {}

    def exact(s):
        return float(np.sqrt(max(exact_w2(true, s), 0.0)))

    exact_final = {}
    if eval_w2 and eval_w2_exact:
        # the reference's setting: exact network-simplex EMD on the first
        # k_eval samples (lmc.py:403-406, lmc_laplace.py:442-445)
        for name, s in samples.items():
            exact_final[name] = exact(s[:k_true])
            print(f"{name}: exact W2 at {k_true} samples = {exact_final[name]:.4f}",
                  file=sys.stderr)
    exact_tail = {}
    if eval_w2_exact and eval_w2_tail and k > k_true:
        # the LAST k_eval draws: the converged end a longer K buys, where
        # the first k_eval do not move with K
        for name, s in samples.items():
            exact_tail[name] = exact(s[-k_true:])
            print(f"{name}: exact W2 on last {k_true} samples = {exact_tail[name]:.4f}",
                  file=sys.stderr)
    samples_np = {m: s.cpu().numpy() for m, s in samples.items()}
    if make_plots:
        from lmc_atomi_torch.experiments.figures import ensure_outdir

        ensure_outdir(outdir)
        xg, yg, pos = plot_grid(dev)
        # the histograms cover the target's spread (Laplace scale 1/alpha)
        plot_samplers(f"{outdir}/fig_laplace_n{n}_gamma{gamma_ula}_lambda{lamda}_{k}", xg, yg,
                      lm.density(pos).cpu().numpy(), samples_np, curves,
                      extra_panels={"Smoothed density": lm.smooth_density(pos).cpu().numpy()},
                      lim=max(5.0, 4.0 / alpha))
    summary = {
        "workload": "laplacian_mixture_lmc",
        "n": n,
        "k": k,
        "iters_per_sec": iters_per_sec(timings, k, n_chains),
        "final_w2": {m: float(v[1][-1]) for m, v in curves.items()},
        **({"final_w2_exact": exact_final} if exact_final else {}),
        **({"tail_w2_exact": exact_tail} if exact_tail else {}),
    }
    print(json.dumps(summary))
    return samples_np, curves, summary


def main():
    from lmc_atomi_torch.utils.cli import auto_cli

    auto_cli(lmc_laplacian_mixture)


if __name__ == "__main__":
    main()
