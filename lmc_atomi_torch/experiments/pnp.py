"""PnP-ULA with a trained DnCNN prior, many chains and credible-interval
maps (counterpart of ``lmc_atomi_tpu/experiments/pnp.py``; BASELINE.json
config 5).

Trains the denoiser in the repo on random synthetic phantoms (no weights are
downloaded), then runs Plug-and-Play ULA on a deblurring posterior with
``n_chains`` chains, ``chain_block`` of them in each net call (the samplers'
chain axis); the per-pixel posterior mean, std and credible-interval width
come from pooled streaming moments. Beside it, optionally: the TV anchor,
MYULA on the same observation through the fused kernel 2 with P^2
credible-interval markers, and the annealed score-ULA of a noise-conditional
score net.

A large farm splits into independent invocations: train once with
``--train_only true --params_path p.pt``, run disjoint chain blocks with
``--chain_offset k --moments_out part_k.npz`` (each block reloads the same
denoiser and draws a disjoint key stream), then ``merge`` pools the blocks'
Welford moments. The npz keys are the JAX package's, so block files of
either package merge in either. The farm pools its blocks and segments in
float64, as ``merge`` pools block files, so one invocation and a farm of
blocks give the same moments up to the order of the merges
(``scripts/expt_pnp1024_torch.py`` runs config 5's farm that way).

    python -m lmc_atomi_torch.experiments.pnp --size 256 --n_chains 8
    python -m lmc_atomi_torch.experiments.pnp --size 32 --n_steps 20 --train_steps 20 --device cpu
    python -m lmc_atomi_torch.experiments.pnp merge --pattern 'part_*.npz' --size 256

It runs on the card unless ``--device cpu`` is given. ``make_plots`` writes
the posterior mean, std and baseline means under ``outdir`` (needs
matplotlib).
"""
from __future__ import annotations

import glob
import json
import os
import sys
import time

import numpy as np
import torch

from lmc_atomi_torch.core.checkpoint import restore_checkpoint, save_checkpoint
from lmc_atomi_torch.core.random import chain_keys, fold_in, normal_field
from lmc_atomi_torch.core.stats import RunningMoments
from lmc_atomi_torch.eval.metrics import psnr as psnr_fn
from lmc_atomi_torch.kernels.imaging import myula_imaging, pnp_ula, score_ula, score_ula_pc
from lmc_atomi_torch.kernels.myula_fused import run_myula_tv_fused, sep_fused_supported
from lmc_atomi_torch.models.dncnn import (
    DnCNN,
    conv_operator_norms,
    lipschitz_estimate,
    make_denoiser,
    train_denoiser,
)
from lmc_atomi_torch.models.score import geometric_sigmas, make_score_fn, train_score_net
from lmc_atomi_torch.ops.functionals import L2Data, TVNorm
from lmc_atomi_torch.ops.linops import CirculantBlur2D, uniform_kernel
from lmc_atomi_torch.parallel.mesh import merge_chain_moments
from lmc_atomi_torch.run.runner import run_chain, run_chains
from lmc_atomi_torch.utils.cli import require_device
from lmc_atomi_torch.utils.images import phantom

__all__ = ["pnp_ula_deblur", "pnp_merge", "deblur_problem", "segments", "main"]

SEGMENT_STEPS = 500  # a chain's steps a run_chain(s) call; schedules live in segment 0


def segments(n_steps: int):
    """The farm's segment lengths: ``SEGMENT_STEPS`` each, the rest last."""
    seg = min(n_steps, SEGMENT_STEPS)
    return [seg] * (n_steps // seg) + ([n_steps % seg] if n_steps % seg else [])


def deblur_problem(size: int, sigma: float, blur_size: int, key, device,
                   dtype=torch.float32):
    """``(img, blur, y, l2)``: the ``size``^2 phantom in [0, 1], the uniform
    circulant blur, the observation with N(0, sigma^2) noise under ``key``
    and its data term."""
    img = torch.from_numpy(phantom(size)).to(device, dtype) / 255.0
    blur = CirculantBlur2D.from_kernel((size, size), uniform_kernel(blur_size, dtype, device))
    y = blur.matvec(img) + sigma * normal_field(*key, 0, img.shape, dtype, device)
    return img, blur, y, L2Data.create(op=blur, b=y, sigma=1.0 / sigma**2)


def _f64(m: RunningMoments) -> RunningMoments:
    """``m`` with float64 fields: the farm's pooling precision."""
    return RunningMoments(count=m.count, mean=m.mean.double(), m2=m.m2.double())


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def pnp_ula_deblur(
    size: int = 256,
    sigma: float = 0.03,
    blur_size: int = 5,
    denoiser_sigma: float = 0.05,
    train_steps: int = 1500,
    depth: int = 8,
    features: int = 48,
    spectral_norm: float = 1.1,
    alpha: float = 1.0,
    n_steps: int = 2000,
    burn_in: int = 200,
    n_chains: int = 8,
    chain_block: int = 128,
    ci_z: float = 1.96,
    seed: int = 0,
    outdir: str = "fig",
    make_plots: bool = False,
    device: str = "cuda",
    params_path: str = "",
    train_only: bool = False,
    chain_offset: int = 0,
    moments_out: str = "",
    tv_baseline: bool = True,
    tau_tv_baseline: float = 2.0,
    tv_steps: int = 0,  # 0 -> n_steps; a longer budget converges the anchor
    score_baseline: bool = False,
    score_train_steps: int = 1500,
    score_arch: str = "cnn",  # 'cnn' | 'unet' (models/score.py::ScoreUNet)
    score_class: str = "phantom",  # 'phantom' | 'terrain' | 'photo'
    pc_correctors: int = 0,  # >0: PC corrector sweeps (score_ula_pc)
    score_sigma_max: float = 0.4,
):
    """Train (or load) the denoiser, report its Lipschitz constants, and
    sample the deblurring posterior of the ``size``^2 phantom with PnP-ULA;
    returns ``(mean, std, report)`` (float64 numpy maps and the JSON line's dict),
    ``(None, None, report)`` with ``train_only``. ``report`` has the JAX
    package's keys and ``train_seconds`` (with ``score_baseline``, also
    ``score_train_seconds``)."""
    dev = require_device(device, "PnP")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    dtype = torch.float32
    kd, kn, ks = chain_keys(seed, 3)
    img, blur, y, l2 = deblur_problem(size, sigma, blur_size, kn, dev, dtype)

    if params_path and os.path.exists(params_path):
        model = DnCNN(depth, features).to(dev, dtype)
        model.load_state_dict(restore_checkpoint(params_path, model.state_dict()))
        model.eval()
        train_s = 0.0
        _log(f"loaded denoiser from {params_path}")
    else:
        _log("training DnCNN prior on synthetic phantoms...")
        sync()
        t0 = time.perf_counter()
        model = train_denoiser(kd, noise_sigma=denoiser_sigma, steps=train_steps, depth=depth,
                               features=features,
                               spectral_norm=spectral_norm if spectral_norm > 0 else None,
                               dtype=dtype, device=dev)
        sync()
        train_s = time.perf_counter() - t0
        _log(f"denoiser trained in {train_s:.1f}s")
        if params_path:
            save_checkpoint(params_path, model.state_dict())
            _log(f"saved denoiser to {params_path}")
    denoiser = make_denoiser(model)

    # Lipschitz control (Laumont et al. ergodicity condition): the certified
    # layer-product bound and the measured local constant of D(x) - x
    lip_bound = float(np.prod(list(conv_operator_norms(model).values())))
    n_probe = min(size, 128)
    probe = torch.from_numpy(phantom(n_probe)).to(dev, dtype) / 255.0
    probe = probe + denoiser_sigma * normal_field(*fold_in(kd, 77), 0, probe.shape, dtype, dev)
    lip_measured = lipschitz_estimate(lambda x: model(x) - x, probe, fold_in(kd, 78))
    _log(f"denoiser residual Lipschitz: certified<= {lip_bound:.3f} "
         f"(circular bound), measured {lip_measured:.3f}")
    if train_only:
        report = {"lipschitz_certified_bound": lip_bound,
                  "lipschitz_measured": float(lip_measured), "train_seconds": train_s}
        print(json.dumps({"workload": "pnp_train_denoiser", **report}))
        return None, None, report

    lips = 1.0 / sigma**2 + alpha / denoiser_sigma**2
    tau = 0.5 / lips
    eps = denoiser_sigma**2
    kern = pnp_ula(l2.grad, denoiser, tau=tau, eps=eps, alpha=alpha, box=(-1.0, 2.0))
    segs = segments(n_steps)

    def farm(kern_first, kern_rest, key_base):
        """Blocked multi-chain segmented farm -> pooled moments.
        ``kern_first`` drives segment 0 only: per-step schedules (annealed
        score-ULA ladders) live inside it, since every segment starts its
        kernel's step count anew; ``kern_rest`` must be time-invariant."""
        pooled = None
        if n_chains > 1:
            # chains in blocks of chain_block, each block one net call a step
            for b in range(0, n_chains, chain_block):
                nb = min(chain_block, n_chains - b)
                # chain_offset shifts the key stream, so separate invocations
                # covering disjoint chain ranges never collide
                bkey = fold_in(key_base, chain_offset + b)
                x = y.expand((nb,) + tuple(y.shape)).clone()
                for s, ns in enumerate(segs):
                    res = run_chains(kern_first if s == 0 else kern_rest, x, fold_in(bkey, s),
                                     ns, nb, collect="stats", burn_in=burn_in if s == 0 else 0,
                                     batched=True)
                    x = res.final_state.position
                    part = _f64(merge_chain_moments(res.moments))
                    pooled = part if pooled is None else pooled.merge(part)
            return pooled
        x = y
        for s, ns in enumerate(segs):
            res = run_chain(kern_first if s == 0 else kern_rest, x, fold_in(key_base, s), ns,
                            collect="stats", burn_in=burn_in if s == 0 else 0)
            x = res.final_state.position
            part = _f64(res.moments)
            pooled = part if pooled is None else pooled.merge(part)
        return pooled

    sync()
    t0 = time.perf_counter()
    pooled = farm(kern, kern, ks)
    sync()
    dt = time.perf_counter() - t0
    mean = pooled.mean
    std = pooled.std
    report = {
        "psnr_blurred": float(psnr_fn(img, y)),
        "psnr_posterior_mean": float(psnr_fn(img, mean.to(dtype))),
        "mean_ci_width": float((2 * ci_z * std).mean()),
        "chain_steps_per_sec": round(n_steps * n_chains / dt, 1),
        "lipschitz_certified_bound": lip_bound,
        "lipschitz_measured": float(lip_measured),
        "train_seconds": train_s,
    }

    baselines = {}
    if tv_baseline:
        # the TV anchor: MYULA on the identical observation, blur, noise and
        # step budget, so the PnP mean is read against a hand-crafted prior
        gamma_tv = sigma**2
        tau_step = 0.2 * gamma_tv
        n_tv = tv_steps or n_steps
        sync()
        t0 = time.perf_counter()
        if sep_fused_supported(blur, y):
            res_tv = run_myula_tv_fused(l2, tau_tv_baseline, tau_step, gamma_tv, y,
                                        fold_in(ks, 999), n_tv, burn_in=burn_in,
                                        quantiles=(0.025, 0.975))
            tv_ci = float(torch.mean(res_tv.quantiles[0.975] - res_tv.quantiles[0.025]))
        else:
            res_tv = run_chain(myula_imaging(l2, TVNorm(sigma=tau_tv_baseline, niter=10),
                                             tau=tau_step, gamma=gamma_tv),
                               y, fold_in(ks, 999), n_tv, collect="stats", burn_in=burn_in)
            tv_ci = float(2 * ci_z * torch.mean(res_tv.moments.std))
        sync()
        report["psnr_tv_baseline_mean"] = float(psnr_fn(img, res_tv.moments.mean))
        baselines["TV-MYULA mean (same config)"] = res_tv.moments.mean
        report["tv_baseline_ci_width"] = tv_ci
        report["tv_baseline_steps_per_sec"] = round(n_tv / (time.perf_counter() - t0), 1)

    if score_baseline:
        # the third prior on the same observation and chain protocol: annealed
        # score-ULA, the ladder over burn-in (inside segment 0, see farm()),
        # then the finest level while the moments collect
        sync()
        t0 = time.perf_counter()
        s_model, _ = train_score_net(fold_in(kd, 11), sigma_max=score_sigma_max,
                                     sigma_min=denoiser_sigma, n_sigmas=8,
                                     steps=score_train_steps, arch=score_arch,
                                     image_class=score_class, dtype=dtype, device=dev)
        sync()
        report["score_train_seconds"] = time.perf_counter() - t0
        score = make_score_fn(s_model)
        ladder = geometric_sigmas(score_sigma_max, denoiser_sigma, 8, dtype, dev)
        n0 = segs[0]
        anneal = ladder.repeat_interleave(max(burn_in // 8, 1))[:burn_in]
        fine = torch.full((max(burn_in - anneal.shape[0], 0) + max(n0 - burn_in, 0),),
                          float(denoiser_sigma), dtype=dtype, device=dev)
        sig0 = torch.cat([anneal, fine])[:n0]
        lips_f = 1.0 / sigma**2

        def kern_score(sig_spec):
            # per-level stability: tau_i = 0.5 / (L_data + alpha / sigma_i^2)
            tau_spec = 0.5 / (lips_f + alpha / sig_spec**2)
            kw = dict(alpha=alpha, box=(-1.0, 2.0), box_weight=denoiser_sigma**2)
            if pc_correctors > 0:
                return score_ula_pc(l2.grad, score, sig_spec, tau_spec,
                                    n_corrector=pc_correctors, **kw)
            return score_ula(l2.grad, score, sig_spec, tau_spec, **kw)

        pooled_sc = farm(kern_score(sig0), kern_score(float(denoiser_sigma)),
                         fold_in(ks, 555))
        sync()
        report["psnr_score_mean"] = float(psnr_fn(img, pooled_sc.mean.to(dtype)))
        baselines["Score-ULA mean (same config)"] = pooled_sc.mean
        report["score_ci_width"] = float(2 * ci_z * torch.mean(pooled_sc.std))
        report["score_steps_per_sec"] = round(
            n_steps * n_chains / (time.perf_counter() - t0), 1)

    print(json.dumps({"workload": "pnp_ula_deblur", "size": size, "n_chains": n_chains,
                      "steps": n_steps, **report}))
    mean_np = mean.detach().cpu().numpy()
    std_np = std.detach().cpu().numpy()
    if moments_out:
        np.savez(moments_out, count=np.asarray(pooled.count),
                 mean=mean_np, m2=pooled.m2.detach().cpu().numpy(),
                 size=size, seed=seed, n_chains=n_chains, n_steps=n_steps)
        _log(f"saved pooled moments to {moments_out}")
    if make_plots:
        from lmc_atomi_torch.experiments import figures as F

        F.ensure_outdir(outdir)
        F.image_grid({"Ground truth": img.cpu().numpy(), "Blurred": y.cpu().numpy(),
                      "PnP-ULA posterior mean": mean_np, "Posterior std (CI map)": std_np,
                      **{k: v.detach().cpu().numpy() for k, v in baselines.items()}},
                     f"{outdir}/fig_pnp_ula_{size}_{n_steps}.pdf")
    return mean_np, std_np, report


def pnp_merge(
    pattern: str,
    size: int = 256,
    ci_z: float = 1.96,
    out: str = "",
    device: str = "cuda",
):
    """Pool per-block moment files (``--moments_out``, of either package;
    ``pattern`` a glob, relative to the working directory unless absolute)
    into the full farm's posterior mean / std / credible-interval report;
    ``out`` gets the pooled ``mean``, ``std``, ``m2`` and ``count``."""
    dev = require_device(device, "PnP merge")
    files = sorted(glob.glob(pattern))
    if not files:
        raise FileNotFoundError(f"no moment files match {pattern}")
    pooled, n_chains = None, 0
    for f in files:
        with np.load(f) as d:
            m = RunningMoments(count=int(d["count"]),
                               mean=torch.as_tensor(d["mean"], dtype=torch.float64, device=dev),
                               m2=torch.as_tensor(d["m2"], dtype=torch.float64, device=dev))
            n_chains += int(d["n_chains"]) if "n_chains" in d else 0
        pooled = m if pooled is None else pooled.merge(m)
    img = torch.from_numpy(phantom(size, np.float64)).to(dev) / 255.0
    std = pooled.std
    report = {
        "n_blocks": len(files),
        "n_chains": n_chains,
        "n_chain_draws": int(pooled.count),
        "psnr_posterior_mean": float(psnr_fn(img, pooled.mean)),
        "mean_ci_width": float(2 * ci_z * std.mean()),
        "std_max": float(std.max()),
    }
    print(json.dumps({"workload": "pnp_merge", **report}))
    if out:
        np.savez(out, mean=pooled.mean.cpu().numpy(), std=std.cpu().numpy(),
                 m2=pooled.m2.cpu().numpy(), count=np.asarray(pooled.count))
    return report


def main():
    from lmc_atomi_torch.utils.cli import auto_cli

    if len(sys.argv) > 1 and sys.argv[1] == "merge":
        auto_cli(pnp_merge, sys.argv[2:])
    else:
        auto_cli(pnp_ula_deblur)


if __name__ == "__main__":
    main()
