"""Multi-chain uncertainty quantification (counterpart of
``lmc_atomi_tpu/experiments/multichain.py``): many fused MYULA or ULPDA
chains of ONE TV-deblurring posterior, pooled posterior statistics and a
streaming Gelman-Rubin R-hat.

The chains run ``pack`` to a kernel call, the kernels' chain axis
(``run_myula_tv_fused_packed``, ``run_ulpda_fused_packed``): a 64^2 chain
alone fills a few of the card's SMs, so small-image UQ runs many chains in
one launch. Per-chain Welford moments pool into the posterior mean and std
(``parallel/mesh.py::merge_chain_moments``) and R-hat comes from the
moments (``eval/diagnostics.py::rhat_from_moments``): no samples are kept.

    python -m lmc_atomi_torch.experiments.multichain --size 64 --n_chains 64
    python -m lmc_atomi_torch.experiments.multichain --size 32 --n_chains 4 --device cpu

It runs on the card unless ``--device cpu`` is given; there the chains draw
their noise, on the CPU they run noise-free (identical chains), as the JAX
package's run noisy on the TPU only. ``make_plots`` writes the pooled
mean, std and R-hat maps under ``outdir``.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from lmc_atomi_torch.core.random import chain_keys
from lmc_atomi_torch.core.stats import RunningMoments
from lmc_atomi_torch.eval.diagnostics import rhat_from_moments
from lmc_atomi_torch.eval.metrics import psnr as psnr_fn
from lmc_atomi_torch.kernels.myula_fused import (
    run_myula_tv_fused_packed,
    sep_fused_supported,
)
from lmc_atomi_torch.kernels.ulpda_fused import run_ulpda_fused_packed
from lmc_atomi_torch.ops.functionals import L21Norm, L2Data
from lmc_atomi_torch.ops.linops import CirculantBlur2D, Gradient2D, uniform_kernel
from lmc_atomi_torch.parallel.mesh import merge_chain_moments
from lmc_atomi_torch.utils.cli import require_device
from lmc_atomi_torch.utils.images import phantom

__all__ = ["multichain_deblur", "main"]


def _observation(img, blur, sigma: float, seed: int):
    """The blurred observation with N(0, sigma^2) noise from ``seed``."""
    gen = torch.Generator(device=img.device).manual_seed(seed)
    return blur.matvec(img) + sigma * torch.randn(
        img.shape, generator=gen, dtype=img.dtype, device=img.device)


def multichain_deblur(
    size: int = 64,
    n_chains: int = 8,
    pack: int = 0,  # chains a kernel call carries; 0: all of them
    sigma: float = 0.75,
    tau_tv: float = 0.3,
    n_steps: int = 5000,
    burn_in: int = 500,
    niter_tv: int = 10,
    kernel: str = "myula",  # "myula" | "ulpda"
    seed: int = 0,
    outdir: str = "fig",
    make_plots: bool = False,
    device: str = "cuda",
):
    """``n_chains`` chains of the ``size``^2 TV-deblurring posterior of the
    main path (phantom, 5x5 uniform blur, noise ``sigma``, TV weight
    ``tau_tv``), ``pack`` a kernel call (the largest divisor of
    ``n_chains`` up to ``pack``); returns ``(pooled moments, R-hat map,
    report)`` and prints the report as one JSON line."""
    if kernel not in ("myula", "ulpda"):
        raise ValueError(f"unknown kernel {kernel!r}")
    dev = require_device(device, "multichain")
    on_cuda = dev.type == "cuda"
    dtype = torch.float32
    img = torch.from_numpy(phantom(size)).to(dev, dtype)
    blur = CirculantBlur2D.from_kernel((size, size), uniform_kernel(5, dtype, dev))
    y = _observation(img, blur, sigma, seed)
    l2 = L2Data.create(op=blur, b=y, sigma=1.0 / sigma**2)
    gamma = sigma**2
    tau = 0.2 * gamma

    pack = min(n_chains if pack <= 0 else pack, n_chains)
    while n_chains % pack:
        pack -= 1
    groups = n_chains // pack
    x0 = torch.zeros((pack, size, size), dtype=dtype, device=dev)
    if on_cuda and not sep_fused_supported(blur, x0[0]):
        raise ValueError("fused path unsupported for this configuration")
    keys = chain_keys((seed, 1), groups)
    noise_scale = 1.0 if on_cuda else 0.0

    def run(key, steps):
        if kernel == "ulpda":
            return run_ulpda_fused_packed(
                l2, L21Norm(sigma=tau_tv), Gradient2D(), 0.95 * sigma**2, 1.0, x0,
                key, steps, burn_in=burn_in, noise_scale=noise_scale).moments
        return run_myula_tv_fused_packed(
            l2, tau_tv, tau, gamma, x0, key, steps, niter_tv=niter_tv,
            burn_in=burn_in, noise_scale=noise_scale).moments

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    if on_cuda:
        run((seed, 2), min(n_steps, 256))  # builds the kernels; not timed
    sync()
    t0 = time.perf_counter()
    moms = [run(k, n_steps) for k in keys]
    sync()
    dt = time.perf_counter() - t0

    per_chain = RunningMoments(
        count=torch.tensor([m.count for m in moms for _ in range(pack)]),
        mean=torch.cat([m.mean for m in moms]),
        m2=torch.cat([m.m2 for m in moms]))
    pooled = merge_chain_moments(per_chain)
    rhat = rhat_from_moments(per_chain)
    report = {
        "workload": "multichain_deblur",
        "kernel": kernel,
        "size": size,
        "n_chains": n_chains,
        "pack": pack,
        "steps": n_steps,
        "psnr_pooled_mean": float(psnr_fn(img, pooled.mean)),
        "psnr_observed": float(psnr_fn(img, y)),
        "rhat_max": float(torch.max(rhat)),
        "rhat_mean": float(torch.mean(rhat)),
        "aggregate_iters_per_sec": round(n_steps * n_chains / dt, 1),
        "per_chain_iters_per_sec": round(n_steps / dt, 1),
    }
    if make_plots:
        from lmc_atomi_torch.experiments import figures as F

        F.ensure_outdir(outdir)
        F.image_grid({"Ground truth": img.cpu().numpy(), "Observed": y.cpu().numpy(),
                      "Pooled posterior mean": pooled.mean.cpu().numpy(),
                      "Pooled posterior std": pooled.std.cpu().numpy(),
                      "R-hat map": rhat.cpu().numpy()},
                     f"{outdir}/fig_multichain_{size}_{n_chains}ch.pdf")

    print(json.dumps(report))
    return pooled, rhat, report


def main():
    from lmc_atomi_torch.utils.cli import auto_cli

    auto_cli(multichain_deblur)


if __name__ == "__main__":
    main()
