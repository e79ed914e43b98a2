"""Workload 3: proximal LMC on the mixture x Laplace-prior target
(counterpart of ``lmc_atomi_tpu/experiments/prox_mixtures.py``; reference
prox_lmc.py:259-460).

PGLD, MYULA, MYMALA, PP-ULA, FBULA and LBMUMLA on the composite target (the
reference computes no W2 here, prox_lmc.py:385).

    python -m lmc_atomi_torch.experiments.prox_mixtures --k 10000 --n 5
    python -m lmc_atomi_torch.experiments.prox_mixtures --k 200 --n 3 --device cpu
"""
from __future__ import annotations

import json

import torch

from lmc_atomi_torch.experiments.mixtures import (
    BETA,
    M_PRE,
    iters_per_sec,
    plot_grid,
    plot_samplers,
    run_samplers,
)

Q_PRE = [[1.0, 0.1], [0.1, 1.5]]  # PP-ULA's Q, reference prox_lmc.py:375
SIGMA_BREG = [0.8, 0.2]  # LBMUMLA's Bregman scales


def prox_setup(n: int, alpha: float, lamda: float, t: int, seed: int, dev,
               gamma_pgld: float = 5e-2, gamma_myula: float = 5e-2,
               gamma_mymala: float = 5e-2, gamma_ppula: float = 5e-2,
               gamma_fbula: float = 5e-2, gamma_lbmumla: float = 5e-2):
    """The workload's f32 composite target on ``dev``, its generator (seeded
    with ``seed``, past the start's draw), the start and the six kernels."""
    from lmc_atomi_torch.experiments.configs import gaussian_mixture_config
    from lmc_atomi_torch.kernels import fbula, lbmumla, mymala, myula, pgld, ppula
    from lmc_atomi_torch.models import GaussianMixture, LaplacePrior, MixtureWithLaplacePrior

    f32 = dict(dtype=torch.float32, device=dev)
    mus, sigmas, omegas = gaussian_mixture_config(n)
    gm = GaussianMixture.create(mus, sigmas, omegas, **f32)
    tgt = MixtureWithLaplacePrior.create(gm, LaplacePrior.create(torch.zeros(2), alpha, **f32),
                                         lamda)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.randn(2, generator=gen, **f32)
    kernels = {
        "PGLD": pgld(tgt, gamma_pgld),
        "MYULA": myula(tgt, gamma_myula),
        "MYMALA": mymala(tgt, gamma_mymala),
        "PP-ULA": ppula(tgt, gamma_ppula, torch.tensor(M_PRE, **f32),
                        torch.tensor(Q_PRE, **f32), t=t),
        "FBULA": fbula(tgt, gamma_fbula),
        "LBMUMLA": lbmumla(tgt, gamma_lbmumla, torch.tensor(BETA, **f32),
                           torch.tensor(SIGMA_BREG, **f32)),
    }
    return tgt, gen, x0, kernels


def prox_lmc_gaussian_mixture(
    gamma_pgld: float = 5e-2,
    gamma_myula: float = 5e-2,
    gamma_mymala: float = 5e-2,
    gamma_ppula: float = 5e-2,
    gamma_fbula: float = 5e-2,
    gamma_lbmumla: float = 5e-2,
    lamda: float = 0.01,
    alpha: float = 0.1,
    n: int = 5,
    t: int = 100,
    k: int = 10000,
    seed: int = 0,
    n_chains: int = 1,
    outdir: str = "fig",
    make_plots: bool = False,
    device: str = "cuda",
):
    """Sample the Gaussian mixture x Laplace prior with six proximal
    kernels; returns ``(samples, summary)`` as the JAX package's version
    does (samples as numpy arrays)."""
    from lmc_atomi_torch.utils.cli import require_device

    dev = require_device(device, "proximal-mixture")
    tgt, _, x0, kernels = prox_setup(n, alpha, lamda, t, seed, dev, gamma_pgld, gamma_myula,
                                   gamma_mymala, gamma_ppula, gamma_fbula, gamma_lbmumla)
    samples, timings = run_samplers(kernels, x0, seed, k, n_chains, accept_of=("MYMALA",))
    samples_np = {m: s.cpu().numpy() for m, s in samples.items()}
    if make_plots:
        from lmc_atomi_torch.experiments.figures import density_surface, ensure_outdir

        ensure_outdir(outdir)
        xg, yg, pos = plot_grid(dev)
        # the smoothed prior's panel (reference prox_lmc.py:319)
        prox_pos = tgt.prior_prox(pos)
        env = alpha * torch.sum(torch.abs(prox_pos), dim=-1) + torch.sum(
            (prox_pos - pos) ** 2, dim=-1) / (2 * lamda)
        z_smooth = (tgt.mixture.density(pos) * (alpha / 2) ** 2 * torch.exp(-env)).cpu().numpy()
        stem = f"{outdir}/fig_prox_n{n}_gamma{gamma_pgld}_lambda{lamda}_{k}"
        density_surface(xg, yg, z_smooth, f"{stem}_1_smooth.pdf")
        plot_samplers(stem, xg, yg, tgt.density(pos).cpu().numpy(), samples_np,
                      extra_panels={"Smoothed density": z_smooth})
    summary = {
        "workload": "prox_lmc_mixture",
        "n": n,
        "k": k,
        "iters_per_sec": iters_per_sec(timings, k, n_chains),
    }
    print(json.dumps(summary))
    return samples_np, summary


def main():
    from lmc_atomi_torch.utils.cli import auto_cli

    auto_cli(prox_lmc_gaussian_mixture)


if __name__ == "__main__":
    main()
