"""Laplace-prior (pixel l1) denoising by MYULA (counterpart of
``lmc_atomi_tpu/experiments/denoise.py``, BASELINE config 2).

Identity forward operator and an l1 prior on the pixels' deviations from the
observation's median: the soft-threshold prox is exact, so this is the
smallest imaging instance of the MYULA recursion. No kernel of its own.

    python -m lmc_atomi_torch.experiments.denoise --size 64
    python -m lmc_atomi_torch.experiments.denoise --size 64 --device cpu

It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass

import torch

from lmc_atomi_torch.eval.metrics import psnr as psnr_fn
from lmc_atomi_torch.kernels.imaging import myula_imaging
from lmc_atomi_torch.ops.functionals import L2Data
from lmc_atomi_torch.ops.linops import Identity
from lmc_atomi_torch.ops.prox import prox_laplace
from lmc_atomi_torch.run.runner import run_chain
from lmc_atomi_torch.utils.cli import require_device
from lmc_atomi_torch.utils.images import phantom

__all__ = ["l1_denoise_myula", "median", "PixelL1", "main"]


def median(x):
    """Median of all elements, averaging the two middle values of an even
    count (``jnp.median``; ``torch.median`` returns the lower one)."""
    s = torch.sort(torch.ravel(x)).values
    n = s.numel()
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) * 0.5


@dataclass
class PixelL1:
    """``alpha ||x - m||_1`` around the observation median ``m``."""

    m: torch.Tensor
    alpha: float

    def __call__(self, x):
        return self.alpha * torch.sum(torch.abs(x - self.m))

    def prox(self, x, tau):
        return self.m + prox_laplace(x - self.m, tau * self.alpha)


def l1_denoise_myula(
    size: int = 64,
    sigma: float = 0.2,
    alpha: float = 5.0,
    n_steps: int = 2000,
    burn_in: int = 200,
    seed: int = 0,
    outdir: str = "fig",
    make_plots: bool = False,
    device: str = "cuda",
):
    """Denoise the phantom (in [0, 1]) by MYULA; returns ``(mean, report)``.
    The noise comes from a ``torch.Generator`` on the device seeded with
    ``seed``, the chain runs under ``(seed, 1)``, timed on a second run
    after a warm-up. ``make_plots`` writes the image grid under
    ``outdir``."""
    dev = require_device(device, "denoising")
    dtype = torch.float32
    img = torch.from_numpy(phantom(size)).to(dev, dtype) / 255.0
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = img + sigma * torch.randn(img.shape, generator=gen, dtype=dtype, device=dev)

    l2 = L2Data(op=Identity(), b=y, sigma=1.0 / sigma**2)
    prior = PixelL1(m=median(y), alpha=alpha)
    gamma = sigma**2
    kern = myula_imaging(l2, prior, tau=0.2 * gamma, gamma=gamma)

    def run():
        return run_chain(kern, y, (seed, 1), n_steps, collect="stats",
                         burn_in=burn_in)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run()  # warm-up
    sync()
    t0 = time.perf_counter()
    res = run()
    sync()
    dt = time.perf_counter() - t0

    mean = res.moments.mean.detach().cpu().numpy()
    report = {
        "psnr_noisy": float(psnr_fn(img, y)),
        "psnr_posterior_mean": float(psnr_fn(img, res.moments.mean)),
        "iters_per_sec": round(n_steps / dt, 1),
    }
    print(json.dumps({"workload": "l1_denoise_myula", "size": size, **report}))
    if make_plots:
        from lmc_atomi_torch.experiments import figures as F

        F.ensure_outdir(outdir)
        F.image_grid({"Ground truth": img.cpu().numpy(), "Noisy": y.cpu().numpy(),
                      "Posterior mean": mean},
                     f"{outdir}/fig_l1_denoise_{size}_{n_steps}.pdf")
    return mean, report


def main():
    from lmc_atomi_torch.utils.cli import auto_cli

    auto_cli(l1_denoise_myula)


if __name__ == "__main__":
    main()
