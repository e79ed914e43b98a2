"""Workload 1: Gaussian-mixture LMC (counterpart of
``lmc_atomi_tpu/experiments/mixtures.py``; reference lmc.py:194-450).

ULA, MALA, PULA, IHPULA and MLA on the n-component benchmark mixture, and the
W2-vs-samples curve against ancestral true samples. With ``n_chains > 1``
``run_chains`` steps every chain at once; as in the JAX package the W2 curve
then reads chain 0's samples and the ESS all chains one after another.
``make_plots`` writes the density, histogram, KDE and W2 figures under
``outdir`` with the reference's names (needs matplotlib).

    python -m lmc_atomi_torch.experiments.mixtures --k 5000 --n 5
    python -m lmc_atomi_torch.experiments.mixtures --k 200 --n 3 --device cpu
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

# warm-up steps before each timed run, under another key
WARM_STEPS = 20
M_PRE = [[1.0, 0.1], [0.1, 0.5]]  # PULA's preconditioner, reference lmc.py:278
BETA = [0.7, 0.3]  # MLA's mirror scales, reference lmc.py:284


def run_samplers(kernels, x0, seed: int, k: int, n_chains: int, accept_of=()):
    """Run each kernel for ``k`` steps from ``x0`` under base key ``(seed,
    i)`` (``i`` its place in ``kernels``), as one chain or ``n_chains``
    through ``run_chains``. Each is timed after a warm-up of ``WARM_STEPS``
    under ``(seed + 1, i)``, with a ``torch.cuda.synchronize`` before each
    clock read on the card. Returns ``(samples, timings)``: the samples
    ``(n_chains * k, d)``, chain after chain, and the seconds of each run;
    the acceptance rate of each kernel named in ``accept_of`` goes to stderr."""
    from lmc_atomi_torch.eval.metrics import acceptance_rate
    from lmc_atomi_torch.run.runner import run_chain, run_chains

    def sync():
        if x0.device.type == "cuda":
            torch.cuda.synchronize(x0.device)

    def run(kern, key, steps):
        if n_chains > 1:
            return run_chains(kern, x0, key, steps, n_chains=n_chains, collect="samples")
        return run_chain(kern, x0, key, steps, collect="samples")

    samples, timings = {}, {}
    for i, (name, kern) in enumerate(kernels.items()):
        run(kern, (seed + 1, i), min(k, WARM_STEPS))
        sync()
        t0 = time.perf_counter()
        res = run(kern, (seed, i), k)
        sync()
        timings[name] = time.perf_counter() - t0
        samples[name] = res.samples.reshape(-1, x0.shape[-1])
        if name in accept_of:
            print(f"{name} percentage of effective samples: "
                  f"{float(acceptance_rate(res.infos)):.4f}", file=sys.stderr)
    return samples, timings


def iters_per_sec(timings, k: int, n_chains: int):
    return {m: round(k * max(1, n_chains) / t, 1) for m, t in timings.items()}


def min_ess(samples):
    from lmc_atomi_torch.eval.diagnostics import effective_sample_size

    return {m: float(effective_sample_size(s).min()) for m, s in samples.items()}


def w2_curves(true, samples, interval: int):
    from lmc_atomi_torch.eval.wasserstein import w2_prefix_curve

    curves = {}
    for name, s in samples.items():
        ks, vals = w2_prefix_curve(true, s[: true.shape[0]], interval=interval)
        curves[name] = (ks.cpu().numpy(), vals.cpu().numpy())
    return curves


def plot_grid(dev):
    """``(xg, yg, pos)``: the figures' 300 x 300 grid over [-5, 5]^2 (numpy)
    and its points as an f32 tensor ``(300, 300, 2)`` on ``dev``."""
    grid = np.linspace(-5, 5, 300)
    xg, yg = np.meshgrid(grid, grid)
    pos = torch.as_tensor(np.stack([xg, yg], axis=-1), dtype=torch.float32, device=dev)
    return xg, yg, pos


def plot_samplers(stem: str, xg, yg, z, samples, curves=None, extra_panels=None,
                  lim: float = 5.0):
    """The density surface ``{stem}_1.pdf``, the samplers' histograms
    ``{stem}_3.pdf`` (over ``[-lim, lim]^2``) and KDEs ``{stem}_2.pdf``, and
    with ``curves`` the W2 curves ``{stem}_wass_dist.pdf``."""
    from lmc_atomi_torch.experiments import figures as F

    F.density_surface(xg, yg, z, f"{stem}_1.pdf")
    F.sample_grid(xg, yg, z, samples, f"{stem}_3.pdf", mode="hist",
                  extra_panels=extra_panels, lim=lim)
    F.sample_grid(xg, yg, z, samples, f"{stem}_2.pdf", mode="kde", extra_panels=extra_panels)
    if curves:
        F.w2_curves(curves, f"{stem}_wass_dist.pdf")


def gaussian_setup(n: int, seed: int, dev, gamma_ula: float = 5e-2,
                   gamma_mala: float = 5e-2, gamma_pula: float = 5e-2,
                   gamma_ihpula: float = 5e-2, gamma_mla: float = 5e-2):
    """The workload's f32 target on ``dev``, its generator (seeded with
    ``seed``, past the start's draw), the start and the five kernels."""
    from lmc_atomi_torch.experiments.configs import gaussian_mixture_config
    from lmc_atomi_torch.kernels import ihpula, mala, mla, pula, ula
    from lmc_atomi_torch.models import GaussianMixture

    mus, sigmas, omegas = gaussian_mixture_config(n)
    gm = GaussianMixture.create(mus, sigmas, omegas, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.randn(2, generator=gen, dtype=torch.float32, device=dev)
    kernels = {
        "ULA": ula(gm.grad_potential, gamma_ula)._replace(chain_axis=True),
        "MALA": mala(gm.log_density, gm.grad_potential, gamma_mala)._replace(chain_axis=True),
        "PULA": pula(gm.grad_potential, gamma_pula, torch.tensor(M_PRE, device=dev)),
        "IHPULA": ihpula(gm.grad_potential, gm.hess_potential, gamma_ihpula),
        "MLA": mla(gm.grad_potential, gamma_mla, torch.tensor(BETA, device=dev)),
    }
    return gm, gen, x0, kernels


def lmc_gaussian_mixture(
    gamma_ula: float = 5e-2,
    gamma_mala: float = 5e-2,
    gamma_pula: float = 5e-2,
    gamma_ihpula: float = 5e-2,
    gamma_mla: float = 5e-2,
    n: int = 5,
    k: int = 5000,
    seed: int = 0,
    n_chains: int = 1,
    outdir: str = "fig",
    make_plots: bool = False,
    eval_w2: bool = True,
    w2_interval: int = 100,
    device: str = "cuda",
):
    """Sample the n-component Gaussian mixture with five Langevin kernels;
    returns ``(samples, curves, summary)`` as the JAX package's version
    does (samples as numpy arrays)."""
    from lmc_atomi_torch.utils.cli import require_device

    dev = require_device(device, "Gaussian-mixture")
    gm, gen, x0, kernels = gaussian_setup(n, seed, dev, gamma_ula, gamma_mala, gamma_pula,
                                          gamma_ihpula, gamma_mla)
    samples, timings = run_samplers(kernels, x0, seed, k, n_chains, accept_of=("MALA",))
    true = gm.sample(gen, k)
    curves = w2_curves(true, samples, w2_interval) if eval_w2 else {}
    samples_np = {m: s.cpu().numpy() for m, s in samples.items()}
    if make_plots:
        from lmc_atomi_torch.experiments.figures import ensure_outdir

        ensure_outdir(outdir)
        xg, yg, pos = plot_grid(dev)
        plot_samplers(f"{outdir}/fig_n{n}_gamma{gamma_ula}_{k}", xg, yg,
                      gm.density(pos).cpu().numpy(), samples_np, curves)
    summary = {
        "workload": "gaussian_mixture_lmc",
        "n": n,
        "k": k,
        "iters_per_sec": iters_per_sec(timings, k, n_chains),
        "final_w2": {m: float(v[1][-1]) for m, v in curves.items()},
        "min_ess": min_ess(samples),
    }
    print(json.dumps(summary))
    return samples_np, curves, summary


def main():
    from lmc_atomi_torch.utils.cli import auto_cli

    auto_cli(lmc_gaussian_mixture)


if __name__ == "__main__":
    main()
