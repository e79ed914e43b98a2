"""Wavelet-l1 inpainting: MYULA, MALA and wavelet-dual ULPDA at up to 512^2
(counterpart of ``lmc_atomi_tpu/experiments/inpainting.py``, BASELINE config
4).

Observation: a random pixel mask (``mask_frac`` of the pixels missing) and
Gaussian noise of ``sigma``. Prior: ``tau_w ||W x||_1`` with an orthogonal
DWT (Haar, D4 or D8), whose prox is exact. MYULA takes the Moreau-envelope
drift; MALA targets the Moreau-smoothed posterior with accept/reject; ULPDA
dualizes the wavelet term (the dual in the coefficient domain, its prox the
l-inf clip). ``fused=True`` adds the fused chains of kernels 4 and 5.

    python -m lmc_atomi_torch.experiments.inpainting --size 512 --fused true
    python -m lmc_atomi_torch.experiments.inpainting --size 32 --n_steps 200 --device cpu

It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json
import sys
import time

import torch

from lmc_atomi_torch.eval.metrics import acceptance_rate
from lmc_atomi_torch.eval.metrics import psnr as psnr_fn
from lmc_atomi_torch.kernels.imaging import myula_imaging, ulpda
from lmc_atomi_torch.kernels.langevin import mala
from lmc_atomi_torch.kernels.wavelet_fused import (
    run_myula_wavelet_fused,
    run_ulpda_wavelet_fused,
)
from lmc_atomi_torch.ops.functionals import L1Norm, L2Data, OrthogonalL1
from lmc_atomi_torch.ops.linops import Mask
from lmc_atomi_torch.ops.wavelet import make_dwt
from lmc_atomi_torch.run.runner import run_chain
from lmc_atomi_torch.utils.cli import require_device
from lmc_atomi_torch.utils.images import load_image

__all__ = ["wavelet_inpainting", "main"]

WAVELET_TAPS = {"haar": 2, "d4": 4, "db2": 4, "d8": 8, "db4": 8}


def wavelet_inpainting(
    size: int = 512,
    mask_frac: float = 0.5,
    sigma: float = 0.1,
    tau_w: float = 5.0,
    lam_moreau: float = 0.05,
    gamma: float = 0.0,
    mala_step_scale: float = 0.0,  # <= 0: 0.2 (1024 / d)^(1/3)
    n_steps: int = 2000,
    burn_in: int = 200,
    levels: int = 3,
    wavelet: str = "haar",  # 'haar' | 'd4' | 'd8' (ops/wavelet.py)
    image: str = "phantom",
    seed: int = 0,
    outdir: str = "fig",
    make_plots: bool = False,
    fused: bool = False,  # adds the fused MYULA and wavelet-dual ULPDA rows
    device: str = "cuda",
):
    """Sample the inpainting posterior with each sampler; returns
    ``(results, summary)`` as the JAX package's version does.

    The mask and then the observation noise come from a ``torch.Generator``
    on the device seeded with ``seed``. Unfused row ``i`` (MYULA, MALA,
    ULPDA-wavelet) runs under chain ``(seed, i)``. The fused rows run under
    the chain of their unfused counterpart (MYULA-fused under 0,
    ULPDA-wavelet-fused under 2), unlike the JAX package's separate
    ``fold_in(ks, 7/8)`` keys: fused and unfused then draw one Philox
    stream, so their gap is roundoff, not sampling noise. The fused rows
    always sample, and are timed on a second call after a warm-up call.
    ``make_plots`` writes the posterior means' image grid under ``outdir``.
    """
    if wavelet not in WAVELET_TAPS:
        raise ValueError(f"unknown wavelet {wavelet!r}")
    dev = require_device(device, "inpainting")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    dtype = torch.float32
    img = torch.from_numpy(load_image(image, size)).to(dev, dtype) / 255.0
    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = (torch.rand((size, size), generator=gen, device=dev) > mask_frac).to(dtype)
    m_op = Mask(mask=mask)
    y = m_op.matvec(img) + sigma * mask * torch.randn(
        (size, size), generator=gen, dtype=dtype, device=dev)

    l2 = L2Data(op=m_op, b=y, sigma=1.0 / sigma**2)
    wav = OrthogonalL1(op=make_dwt(wavelet, levels=levels), sigma=tau_w)

    lips = 1.0 / sigma**2
    if gamma <= 0:
        gamma = 1.0 / lips
    tau_step = 0.2 * gamma
    x0 = y  # start at the observed (masked) image

    kern_myula = myula_imaging(l2, wav, tau=tau_step, gamma=gamma)

    # MALA on the Moreau-smoothed posterior: exact-target MALA on an l1
    # posterior has an O(d * step) kink penalty in the log ratio
    def log_density_smooth(x):
        return -(l2(x) + wav.moreau_value(x, lam_moreau))

    def smoothed_grad(x):
        return l2.grad(x) + wav.moreau_grad(x, lam_moreau)

    # optimal scaling ~ d^(-1/3), tuned for ~0.5-0.7 acceptance at 512^2
    if mala_step_scale <= 0:
        mala_step_scale = 0.2 * (1024.0 / (size * size)) ** (1.0 / 3.0)
    kern_mala = mala(log_density_smooth, smoothed_grad, mala_step_scale * tau_step)

    # lambda_max(W^T W) = 1, so tau mu < 1 at tau = 0.95 / L, mu = 1
    kern_ulpda = ulpda(l2, L1Norm(sigma=tau_w), wav.op, tau=0.95 / lips, mu=1.0,
                       gfirst=False)

    results, timings, extra = {}, {}, {}
    for i, (name, kern) in enumerate([("MYULA", kern_myula), ("MALA", kern_mala),
                                      ("ULPDA-wavelet", kern_ulpda)]):
        sync()
        t0 = time.perf_counter()
        res = run_chain(kern, x0, (seed, i), n_steps, collect="stats",
                        burn_in=burn_in)
        sync()
        timings[name] = time.perf_counter() - t0
        results[name] = res.moments.mean.detach().cpu().numpy()
        if name == "MALA":
            extra["mala_acceptance"] = float(acceptance_rate(res.infos))
            print(f"MALA acceptance: {extra['mala_acceptance']:.3f}", file=sys.stderr)

    if fused:
        taps = WAVELET_TAPS[wavelet]

        def run_f():
            return run_myula_wavelet_fused(l2, tau_w, tau_step, gamma, x0, (seed, 0),
                                           n_steps, levels=levels, taps=taps,
                                           burn_in=burn_in)

        def run_uf():
            return run_ulpda_wavelet_fused(l2, tau_w, 0.95 / lips, 1.0, x0, (seed, 2),
                                           n_steps, levels=levels, taps=taps,
                                           burn_in=burn_in)

        for fname, frun in (("MYULA-fused", run_f), ("ULPDA-wavelet-fused", run_uf)):
            frun()  # warm-up: the first call builds the kernels
            sync()
            t0 = time.perf_counter()
            res_f = frun()
            sync()
            timings[fname] = time.perf_counter() - t0
            results[fname] = res_f.moments.mean.detach().cpu().numpy()

    report = {name: {"psnr": float(psnr_fn(img, torch.from_numpy(est).to(dev)))}
              for name, est in results.items()}
    report["observed"] = {"psnr": float(psnr_fn(img, y))}
    if make_plots:
        from lmc_atomi_torch.experiments import figures as F

        F.ensure_outdir(outdir)
        panels = {"Ground truth": img.cpu().numpy(), "Observed": y.cpu().numpy()}
        panels.update({f"{k} posterior mean": v for k, v in results.items()})
        F.image_grid(panels, f"{outdir}/fig_inpainting_{size}_{n_steps}.pdf")
    summary = {
        "workload": "wavelet_inpainting",
        "size": size,
        "wavelet": wavelet,
        "image": image,
        "steps": n_steps,
        "report": report,
        "iters_per_sec": {m: round(n_steps / t, 2) for m, t in timings.items()},
        **extra,
    }
    print(json.dumps(summary))
    return results, summary


def main():
    from lmc_atomi_torch.utils.cli import auto_cli

    auto_cli(wavelet_inpainting)


if __name__ == "__main__":
    main()
