"""Workload 4: Bayesian image deconvolution (counterpart of
``lmc_atomi_tpu/experiments/deconv.py``; reference prox_lmc_deconv.py).

One blurred, noisy observation (5x5 uniform blur + N(0, sigma^2) noise) is
deblurred under 9 models, 3 assumed blurs (5/6/7 uniform) x 3 priors
(isotropic TV, MC-TV, ME-TV), by posterior sampling (ULPDA or MYULA, streaming
posterior mean) or by the MAP estimate of residual-balancing adaptive PDHG.
Per-iteration cost / error / SNR / PSNR / MSE series are recorded. On a CUDA
device the samplers run the fused kernels (``ulpda_sep_fused``,
``myula_imaging_sep_fused``); ``fused=False``, or a CPU run, takes the
unfused samplers (``ulpda``, ``myula_imaging``), which draw the same noise.
``wavelet_row`` adds model M10 (``k5-WL1``): the k5 data term with a
wavelet-l1 prior, its dual in the orthogonal Haar coefficient domain (the
``"wl1"`` dual of the fused ULPDA kernel); MYULA samples it with the exact
``OrthogonalL1`` prox, unfused. ``score_row`` adds the learned-prior row
(``k5-SCORE``): annealed score-ULA under a score net trained on the bundled
photographs, in [0, 1] units, segmented by ``segment_steps``.

    python -m lmc_atomi_torch.experiments.deconv --size 512 --alg ULPDA
    python -m lmc_atomi_torch.experiments.deconv --size 64 --device cpu

It runs on the card unless ``--device cpu`` is given. ``show`` prints the
reference's iteration table of each model (f, g(A x), J; first 10, last 10,
every n/10 rows) from the collected metrics; ``make_plots`` writes the image
grid and the metric evolution under ``outdir`` (needs matplotlib).
"""
from __future__ import annotations

import json
import sys
import time

import torch

from lmc_atomi_torch.core.random import fold_in
from lmc_atomi_torch.eval.metrics import mse as mse_fn
from lmc_atomi_torch.eval.metrics import psnr as psnr_fn
from lmc_atomi_torch.eval.metrics import snr as snr_fn
from lmc_atomi_torch.kernels.imaging import myula_imaging, score_ula, ulpda
from lmc_atomi_torch.kernels.myula_fused import (
    myula_imaging_sep_fused,
    sep_fused_supported,
)
from lmc_atomi_torch.kernels.ulpda_fused import (
    ulpda_fused_supported,
    ulpda_sep_fused,
)
from lmc_atomi_torch.ops.functionals import (
    L1Norm,
    L21Norm,
    L2Data,
    OrthogonalL1,
    TVNorm,
)
from lmc_atomi_torch.ops.linops import CirculantBlur2D, Gradient2D, uniform_kernel
from lmc_atomi_torch.ops.ncvx_tv import L2NcvxTV
from lmc_atomi_torch.run.optimize import adaptive_pdhg
from lmc_atomi_torch.ops.wavelet import HaarDWT2D
from lmc_atomi_torch.models.score import geometric_sigmas, make_score_fn, train_score_net
from lmc_atomi_torch.run.runner import run_chain, run_chain_segmented
from lmc_atomi_torch.utils.cli import require_device
from lmc_atomi_torch.utils.images import load_image
from lmc_atomi_torch.utils.trace import print_iteration_table

__all__ = ["prox_lmc_deconv", "deconv_models", "main"]


def _model_name(idx: int) -> str:
    return f"M{idx + 1}"


def deconv_models(y, blurs, sigma: float, tau: float, gamma_mc: float,
                  gamma_me: float, niter_l2: int, niter_tv: int,
                  wavelet_levels: int = 0):
    """The 9 models ``(name, proxf, proxg, a_op)``: for each assumed blur
    ``blurs[k]`` (k = 5, 6, 7) the convex TV (``L2Data`` + ``L21Norm``),
    MC-TV (``L2NcvxTV`` with ``Gradient2D`` + ``L1Norm``) and ME-TV
    (``L2NcvxTV`` + ``L21Norm``) models over the observation ``y``; with
    ``wavelet_levels > 0`` a 10th, ``k5-WL1`` (``L2Data`` + ``L1Norm`` over
    ``HaarDWT2D(wavelet_levels)``)."""
    grad_op = Gradient2D()
    models = []
    for k in (5, 6, 7):
        common = dict(op=blurs[k], b=y, sigma=1.0 / sigma**2, lamda=tau,
                      isotropic=True, niter_inner=niter_tv, niter_solve=niter_l2)
        models.append((f"k{k}-TV", L2Data.create(op=blurs[k], b=y,
                                                 sigma=1.0 / sigma**2,
                                                 niter_solve=niter_l2),
                       L21Norm(sigma=tau), grad_op))
        models.append((f"k{k}-MCTV", L2NcvxTV(op2=grad_op, gamma=gamma_mc, **common),
                       L1Norm(sigma=tau), grad_op))
        models.append((f"k{k}-METV", L2NcvxTV(op2=None, gamma=gamma_me, **common),
                       L21Norm(sigma=tau), grad_op))
    if wavelet_levels > 0:
        models.append(("k5-WL1", L2Data.create(op=blurs[5], b=y, sigma=1.0 / sigma**2,
                                               niter_solve=niter_l2),
                       L1Norm(sigma=tau), HaarDWT2D(levels=wavelet_levels)))
    return models


def prox_lmc_deconv(
    gamma_mc: float = 15.0,
    gamma_me: float = 15.0,
    sigma: float = 0.75,
    tau: float = 0.3,
    n_steps: int = 1000,
    niter_l2: int = 50,
    niter_tv: int = 10,
    niter_map: int = 1000,
    image: str = "phantom",
    size: int = 512,
    alg: str = "ULPDA",
    compute_map: bool = False,
    seed: int = 0,
    collect_metrics: bool = True,
    fused: bool = True,
    device: str = "cuda",
    outdir: str = "fig",
    make_plots: bool = False,
    show: bool = False,
    wavelet_row: bool = False,
    wavelet_levels: int = 4,
    score_row: bool = False,  # learned-prior row: k5 + annealed score-ULA
    score_train_steps: int = 4000,
    score_arch: str = "unet",
    score_class: str = "photo",
    score_alpha: float = 1.0,
    denoiser_sigma: float = 0.03,
    score_burn_frac: float = 0.25,
    segment_steps: int = 1000,
):
    """Deblur one observation under 9 models (10 with ``wavelet_row``, and
    the score row after them); returns ``(results, series, summary)`` as the
    JAX package's version does."""
    if alg not in ("ULPDA", "MYULA"):
        raise ValueError(f"unknown alg {alg!r}")
    dev = require_device(device, "deconvolution")
    on_cuda = dev.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    dtype = torch.float32
    img = torch.from_numpy(load_image(image, size)).to(dev, dtype)
    blurs = {k: CirculantBlur2D.from_kernel((size, size),
                                            uniform_kernel(k, dtype, dev))
             for k in (5, 6, 7)}
    # one observation from the 5x5 blur (reference prox_lmc_deconv.py:59)
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = blurs[5].matvec(img) + sigma * torch.randn(
        (size, size), generator=gen, dtype=dtype, device=dev)

    lips = 1.0 / sigma**2
    tau0 = 0.95 / lips
    mu0 = 1.0
    gamma_myula = 1.0 / lips
    tau_myula = 0.2 * gamma_myula
    tv = TVNorm(sigma=tau, niter=niter_tv)
    models = deconv_models(y, blurs, sigma, tau, gamma_mc, gamma_me, niter_l2,
                           niter_tv, wavelet_levels if wavelet_row else 0)
    x0 = torch.zeros((size, size), dtype=dtype, device=dev)

    def make_metrics(proxf, proxg, pd: bool, a_op=None):
        if not collect_metrics:
            return None
        if pd:
            def cost(x):
                return proxf(x) + proxg(a_op.matvec(x))
        else:
            def cost(x):
                return proxf(x) + proxg(x)
        out = {
            "cost": cost,
            "err": lambda x: torch.linalg.norm(torch.ravel(x - img)),
            "snr": lambda x: snr_fn(img, x),
            "psnr": lambda x: psnr_fn(img, x),
            "mse": lambda x: mse_fn(img, x),
        }
        if show:
            # the reference's show-table terms f and g(A x) (algs.py:459-467
            # for ULPDA, 576-583 for MYULA)
            out["f"] = proxf
            out["gA"] = (lambda x: proxg(a_op.matvec(x))) if pd else proxg
        return out

    results, series, timings = {}, {}, {}
    for idx, (name, proxf, proxg, a_op) in enumerate(models):
        label = f"{_model_name(idx)} ({name})"
        sync()
        t0 = time.perf_counter()
        if compute_map:
            out = adaptive_pdhg(proxf, proxg, a_op, x0, tau0, mu0, niter_map,
                                metrics=make_metrics(proxf, proxg, True, a_op))
            est, met = out.x, out.metrics
        else:
            if alg == "ULPDA":
                if fused and ulpda_fused_supported(proxf, proxg, a_op, x0):
                    kern = ulpda_sep_fused(proxf, proxg, a_op, tau=tau0, mu=mu0,
                                           theta=1.0, gfirst=False)
                else:
                    kern = ulpda(proxf, proxg, a_op, tau=tau0, mu=mu0, theta=1.0,
                                 gfirst=False)
                metrics = make_metrics(proxf, proxg, True, a_op)
            else:  # MYULA: the TV prox regularizer (the wavelet row's below)
                reg = tv
                if not isinstance(a_op, Gradient2D):
                    # the wavelet row: the exact orthogonal-DWT l1 prox
                    reg = OrthogonalL1(op=a_op, sigma=tau)
                    kern = myula_imaging(proxf, reg, tau=tau_myula,
                                         gamma=gamma_myula)
                elif fused and sep_fused_supported(proxf.op, x0):
                    kern = myula_imaging_sep_fused(proxf, tv.sigma, tau_myula,
                                                   gamma_myula, niter_tv=tv.niter)
                else:
                    kern = myula_imaging(proxf, tv, tau=tau_myula,
                                         gamma=gamma_myula)
                metrics = make_metrics(proxf, reg, False)
            res = run_chain(kern, x0, (seed, idx), n_steps, collect="stats",
                            metrics=metrics)
            est, met = res.moments.mean, res.metrics
        sync()
        timings[label] = time.perf_counter() - t0
        results[label] = est.detach().cpu().numpy()
        if met is not None:
            series[label] = {k: v.detach().cpu().numpy() for k, v in met.items()}
            if show:
                print(f"-- {label} --")
                print_iteration_table({"f": series[label]["f"], "g(Ax)": series[label]["gA"],
                                       "J": series[label]["cost"]})

    if score_row and not compute_map:
        # the learned-prior row: annealed score-ULA under the score net
        # trained on the photographs, in [0, 1] units (the net's scale): y/255
        # with sigma/255 noise is the TV rows' posterior up to the rescale
        label = "M_score (k5-SCORE)"
        sync()
        t0 = time.perf_counter()
        s_model, _ = train_score_net(fold_in(seed, 101), sigma_max=0.4,
                                     sigma_min=denoiser_sigma, n_sigmas=8,
                                     steps=score_train_steps, arch=score_arch,
                                     image_class=score_class, dtype=dtype, device=dev)
        score = make_score_fn(s_model)
        sig_d = sigma / 255.0
        l2s = L2Data.create(op=blurs[5], b=y / 255.0, sigma=1.0 / sig_d**2)
        burn = int(score_burn_frac * n_steps)
        ladder = geometric_sigmas(0.4, denoiser_sigma, 8, dtype, dev)
        anneal = ladder.repeat_interleave(max(burn // 8, 1))[:burn]
        sig_sched = torch.cat([anneal, torch.full((n_steps - anneal.shape[0],),
                                                  float(denoiser_sigma), dtype=dtype,
                                                  device=dev)])
        tau_sched = 0.5 / (1.0 / sig_d**2 + score_alpha / sig_sched**2)
        kern_sc = score_ula(l2s.grad, score, sig_sched, tau_sched, alpha=score_alpha,
                            box=(-0.2, 1.2), box_weight=denoiser_sigma**2)
        res = run_chain_segmented(kern_sc, y / 255.0, fold_in(seed, 102), n_steps,
                                  burn_in=burn, segment_steps=segment_steps)
        sync()
        timings[label] = time.perf_counter() - t0
        results[label] = 255.0 * res.moments.mean.detach().cpu().numpy()

    branch = "MAP" if compute_map else alg
    report = {}
    for label, est in results.items():
        est_t = torch.from_numpy(est).to(dev)
        report[label] = {
            "snr": float(snr_fn(img, est_t)),
            "psnr": float(psnr_fn(img, est_t)),
            "mse": float(mse_fn(img, est_t)),
        }
        print(
            f"SNR of {branch} image with {label}: {report[label]['snr']:.3f}  "
            f"PSNR: {report[label]['psnr']:.3f}  MSE: {report[label]['mse']:.5f}",
            file=sys.stderr,
        )
    n_iters = niter_map if compute_map else n_steps
    if make_plots:
        from lmc_atomi_torch.experiments import figures as F

        F.ensure_outdir(outdir)
        panels = {"Ground truth": img.cpu().numpy(), "Blurred": y.cpu().numpy()}
        panels.update(results)
        stem = f"{outdir}/fig_prox_lmc_deconv_{image}_{branch}_{n_iters}"
        F.image_grid(panels, f"{stem}_images.pdf")
        if series:
            F.metric_evolution(series, f"{stem}_snr_psnr_mse.pdf")

    summary = {
        "workload": "deconv",
        "branch": branch,
        "size": size,
        "steps": n_iters,
        "psnr_blurred": float(psnr_fn(img, y)),
        "report": report,
        "iters_per_sec": {m: round(n_iters / t, 2) for m, t in timings.items()},
    }
    print(json.dumps(summary))
    return results, series, summary


def main():
    from lmc_atomi_torch.utils.cli import auto_cli

    auto_cli(prox_lmc_deconv)


if __name__ == "__main__":
    main()
