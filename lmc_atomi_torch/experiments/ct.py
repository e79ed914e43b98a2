"""Sparse-view CT (counterpart of ``lmc_atomi_tpu/experiments/ct.py``): a
parallel-beam sinogram of the phantom with Gaussian noise, reconstructed by

  * backprojection and the Hann-filtered backprojection (the chains' start);
  * the TV MAP: adaptive PDHG (``L21Norm`` over ``Gradient2D``, the data
    prox a 50-trip CG gram solve) on the dense and gather projectors, FISTA
    with a 20-trip Chambolle prox on the shear projector;
  * TV-MYULA posterior sampling (kernel 1 for the TV prox on the card), with
    the per-segment PSNR of the running mean and optional credible bands;
  * PnP-ULA under a DnCNN trained here, and optionally annealed score-ULA
    under a noise-conditional score net (``score_prior``).

    python -m lmc_atomi_torch.experiments.ct
    python -m lmc_atomi_torch.experiments.ct --size 256 --n_angles 90 --tau_tv 15 \\
        --n_steps 20000 --burn_in 4000 --pnp false
    python -m lmc_atomi_torch.experiments.ct --size 32 --n_angles 12 --n_steps 40 \\
        --niter_map 15 --pnp_train_steps 5 --device cpu

It runs on the card unless ``--device cpu`` is given. The Radon mode is
picked by ``Radon2D.create`` (dense at the default 128^2/30, shear at
256^2/90) unless ``radon_mode`` names one. Keys come from ``fold_in(seed,
i)``: the sinogram noise under ``seed``, 1 the power method's probe, 2 the
TV chain, 3 the DnCNN, 4 PnP-ULA, 5 the score net, 6 score-ULA.
``make_plots`` is off by default here (the card's machine has no
matplotlib); with it on, the figure takes the JAX package's file name.
"""
from __future__ import annotations

import json
import time

import torch

from lmc_atomi_torch.core.random import fold_in, normal_field
from lmc_atomi_torch.eval.metrics import psnr as psnr_fn
from lmc_atomi_torch.kernels.imaging import myula_imaging, pnp_ula, score_ula, score_ula_pc
from lmc_atomi_torch.models.dncnn import make_denoiser, train_denoiser
from lmc_atomi_torch.models.score import geometric_sigmas, make_score_fn, train_score_net
from lmc_atomi_torch.ops.functionals import L21Norm, L2Data, TVNorm
from lmc_atomi_torch.ops.linops import Gradient2D, LinOp
from lmc_atomi_torch.ops.radon import Radon2D, fbp
from lmc_atomi_torch.ops.tv import prox_tv_iso
from lmc_atomi_torch.run.optimize import adaptive_pdhg_segmented, fista_segmented
from lmc_atomi_torch.run.runner import run_chain_segmented
from lmc_atomi_torch.utils.cli import require_device
from lmc_atomi_torch.utils.images import phantom

__all__ = ["ct_tv_myula", "main"]

PROBE_ITERS = 20  # power-method trips of the Lipschitz bound
MAP_PDHG_SEGMENT = 50
MAP_FISTA_SEGMENT = 100
MAP_FISTA_TV_ITERS = 20


def ct_tv_myula(
    size: int = 128,
    n_angles: int = 30,
    sigma: float = 2.0,
    tau_tv: float = 5.0,
    n_steps: int = 2000,
    burn_in: int = 200,
    tau_scale: float = 0.2,
    segment_steps: int = 250,
    ci_quantiles: tuple = (),
    niter_tv: int = 10,
    compute_map: bool = True,
    niter_map: int = 500,
    pnp: bool = True,
    pnp_alpha: float = 1.0,
    pnp_train_steps: int = 800,
    score_prior: bool = False,
    score_train_steps: int = 1500,
    score_arch: str = "cnn",  # 'cnn' | 'unet' (models/score.py::ScoreUNet)
    score_class: str = "phantom",  # 'phantom' | 'terrain' | 'photo'
    pc_correctors: int = 0,  # >0: Song-style PC corrector sweeps per step
    denoiser_sigma: float = 0.05,
    seed: int = 0,
    outdir: str = "fig",
    make_plots: bool = False,
    radon_mode: str = "",
    arrays_out: dict = None,
    device: str = "cuda",
    dtype: str = "float32",
):
    """Reconstruct the ``size``^2 phantom (in [0, 1]) from ``n_angles``
    noisy projections; returns ``(mean, std, report)`` (numpy maps of the TV
    posterior and the JSON line's dict, the JAX package's keys)."""
    dev = require_device(device, "CT")
    dt = getattr(torch, dtype)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    img = torch.from_numpy(phantom(size)).to(dev, dt) / 255.0
    op = Radon2D.create((size, size), n_angles=n_angles, dtype=dt, mode=radon_mode or None,
                        device=dev)
    sino_clean = op.matvec(img)
    sino = sino_clean + sigma * normal_field(seed, 0, 0, tuple(sino_clean.shape), dt, dev)

    l2 = L2Data(op=op, b=sino, sigma=1.0 / sigma**2)
    tv = TVNorm(sigma=tau_tv, niter=niter_tv)

    # Lipschitz of the data term: lambda_max(A^T A) / sigma^2, power method
    probe = normal_field(*fold_in(seed, 1), 0, (size, size), dt, dev)
    lmax = float(LinOp.max_gram_eig(op, probe=probe, iters=PROBE_ITERS))
    lips = lmax / sigma**2
    gamma = 1.0 / lips
    tau_step = tau_scale * gamma

    # start at the Hann-filtered backprojection
    bp = op.rmatvec(sino) / max(lmax, 1.0)
    x0 = torch.clamp(fbp(op, sino, filter_name="hann"), min=0.0)
    report = {
        "psnr_backprojection": float(psnr_fn(img, bp)),
        "psnr_fbp": float(psnr_fn(img, x0)),
    }

    map_est = None
    if compute_map:
        if op.mode == "shear":
            # no closed-form gram solve: FISTA solves the same TV-LS problem
            # at one matvec and rmatvec an iteration
            out = fista_segmented(
                l2.grad, lambda x, t: prox_tv_iso(x, t * tau_tv, niter=MAP_FISTA_TV_ITERS),
                x0, gamma, niter_map, segment_steps=MAP_FISTA_SEGMENT)
        else:
            out = adaptive_pdhg_segmented(l2, L21Norm(sigma=tau_tv), Gradient2D(), x0,
                                          0.95 / lips, 1.0, niter_map,
                                          segment_steps=MAP_PDHG_SEGMENT)
        map_est = out.x
        report["psnr_map_tv"] = float(psnr_fn(img, map_est))

    # the chains start at the MAP when there is one (a shorter transient)
    x_init = map_est if map_est is not None else x0

    kern = myula_imaging(l2, tv, tau=tau_step, gamma=gamma)
    trace = []

    def _trace(done, moments):
        if done > burn_in:
            trace.append([int(done), round(float(psnr_fn(img, moments.mean)), 3)])

    sync()
    t0 = time.perf_counter()
    res = run_chain_segmented(kern, x_init, fold_in(seed, 2), n_steps, burn_in=burn_in,
                              segment_steps=segment_steps, quantile_ps=tuple(ci_quantiles),
                              progress=_trace)
    sync()
    dt_chain = time.perf_counter() - t0

    report["psnr_posterior_mean"] = float(psnr_fn(img, res.moments.mean))
    report["iters_per_sec"] = round(n_steps / dt_chain, 1)
    report["psnr_trace"] = trace
    if ci_quantiles:
        lo, hi = min(ci_quantiles), max(ci_quantiles)
        w = res.quantiles[hi].value - res.quantiles[lo].value
        report["mean_ci_width"] = round(float(torch.mean(w)), 4)

    pnp_mean = None
    if pnp:
        # PnP-ULA under the spectral-normalised DnCNN (Laumont et al.)
        model = train_denoiser(fold_in(seed, 3), noise_sigma=denoiser_sigma,
                               steps=pnp_train_steps, spectral_norm=1.1, dtype=dt, device=dev)
        eps = denoiser_sigma**2
        lips_pnp = lips + pnp_alpha / eps
        kern_pnp = pnp_ula(l2.grad, make_denoiser(model), tau=0.5 / lips_pnp, eps=eps,
                           alpha=pnp_alpha, box=(-1.0, 2.0))
        res_pnp = run_chain_segmented(kern_pnp, x_init, fold_in(seed, 4), n_steps,
                                      burn_in=burn_in)
        pnp_mean = res_pnp.moments.mean
        report["psnr_pnp_mean"] = float(psnr_fn(img, pnp_mean))

    score_mean = None
    if score_prior:
        # annealed score-ULA: the sigma ladder over the burn-in, the finest
        # level while the moments collect; tau_i = 0.5 / (L + alpha/sigma_i^2)
        s_model, _ = train_score_net(fold_in(seed, 5), sigma_max=0.4, sigma_min=denoiser_sigma,
                                     n_sigmas=8, steps=score_train_steps, arch=score_arch,
                                     image_class=score_class, dtype=dt, device=dev)
        score = make_score_fn(s_model)
        ladder = geometric_sigmas(0.4, denoiser_sigma, 8, dt, dev)
        # a run of n_steps <= burn_in still records its last step
        bi = min(burn_in, max(n_steps - 1, 0))
        anneal = ladder.repeat_interleave(max(bi // 8, 1))[:bi]
        sig_sched = torch.cat([
            anneal,
            torch.full((n_steps - anneal.shape[0],), float(denoiser_sigma), dtype=dt,
                       device=dev)])
        tau_sched = 0.5 / (lips + pnp_alpha / sig_sched**2)
        kw = dict(alpha=pnp_alpha, box=(-1.0, 2.0), box_weight=denoiser_sigma**2)
        if pc_correctors > 0:
            kern_sc = score_ula_pc(l2.grad, score, sig_sched, tau_sched,
                                   n_corrector=pc_correctors, **kw)
        else:
            kern_sc = score_ula(l2.grad, score, sig_sched, tau_sched, **kw)
        res_sc = run_chain_segmented(kern_sc, x_init, fold_in(seed, 6), n_steps, burn_in=bi)
        score_mean = res_sc.moments.mean
        report["psnr_score_mean"] = float(psnr_fn(img, score_mean))

    def np_(t):
        return None if t is None else t.detach().cpu().numpy()

    mean, std = np_(res.moments.mean), np_(res.moments.std)
    if arrays_out is not None:
        # branch images for callers composing their own panels
        arrays_out.update({"img": np_(img), "sino": np_(sino), "backprojection": np_(bp),
                           "fbp": np_(x0), "mean": mean, "std": std})
        for nm, arr in (("map", map_est), ("pnp_mean", pnp_mean), ("score_mean", score_mean)):
            if arr is not None:
                arrays_out[nm] = np_(arr)

    print(json.dumps({"workload": "ct_tv_myula", "size": size, "n_angles": n_angles,
                      "steps": n_steps, **report}))

    if make_plots:
        from lmc_atomi_torch.experiments import figures as F

        F.ensure_outdir(outdir)
        panels = {"Ground truth": np_(img), "Sinogram": np_(sino), "FBP init (Hann)": np_(x0),
                  "TV posterior mean": mean, "Posterior std": std}
        if map_est is not None:
            panels["TV MAP (aPDHG)"] = np_(map_est)
        if pnp_mean is not None:
            panels["PnP-ULA mean (DnCNN)"] = np_(pnp_mean)
        if score_mean is not None:
            panels["Score-ULA mean (annealed)"] = np_(score_mean)
        F.image_grid(panels, f"{outdir}/fig_ct_{size}_{n_angles}ang_{n_steps}.pdf")
    return mean, std, report


def main():
    from lmc_atomi_torch.utils.cli import auto_cli

    auto_cli(ct_tv_myula)


if __name__ == "__main__":
    main()
