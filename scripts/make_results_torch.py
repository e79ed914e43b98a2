"""Produce the PyTorch port's RESULTS tables on the card: the counterpart of
``scripts/make_results.py``, section for section, with the port's own
figures (``RESULTS.md`` at the root is the JAX package's record).

Each section runs the port's experiment with the JAX section's arguments and
``device``. When a section ends, its lines go at once to
``<dirname(out)>/results_sections/<section>.md``, and its device (the card's
name and power limit) and wall seconds to ``<section>.json`` beside it; a
section's old files are deleted before it runs. Then ``out`` is put together
from the title and every section file present, in ``DEFAULT_SECTIONS`` order.
So the tables can be built over several runs, and ``--sections ""`` only puts
``out`` together. A section that raises leaves no file; the other sections
still run, and the script exits 1 naming it.

    python3 scripts/make_results_torch.py                          # every section, on the card
    python3 scripts/make_results_torch.py --sections denoise,ci   # some of them
    python3 scripts/make_results_torch.py --sections ""           # put out together

Sections whose inputs are missing (the PnP farm's blocks and report) or that
cost an hour of host EMD (exact Laplace W2) degrade to a note unless asked
for. Everything reads and writes under ``assets/torch/`` (relative paths are
taken from the repo's root). It runs on the card unless ``--device cpu`` is
given.
"""
from __future__ import annotations

import glob
import json
import os
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lmc_atomi_torch.utils.cli import auto_cli, device_label, require_device  # noqa: E402

DEFAULT_SECTIONS = (
    "mixtures,laplace,prox,denoise,deconv,wavelets,pnp,ct,sgld,ci,"
    "multichain,throughput"
)
ASSETS = ROOT / "assets" / "torch"
LAPLACE_JSON = str(ASSETS / "results_laplace_w2.json")
# the score nets of both packages over seeds in the CT chain
# (scripts/ct_score_drift.py --summary): the ct section's note cites it
CT_SCORE_STUDY = str(ASSETS / "ct_score_study.json")
PNP_JSON = str(ASSETS / "results_pnp1024.json")
PNP_PATTERN = "runs/pnp1024/pnp_block_*.npz"  # scripts/expt_pnp1024_torch.py's outdir

# the 512^2 TV-deblur problem of the ci and throughput sections
CI_SIZE, CI_STEPS, CI_BURN, CI_WARM = 512, 20000, 2000, 2500
THROUGHPUT_STEPS, THROUGHPUT_WARM, THROUGHPUT_REPEATS = 5000, 500, 5
BLUR_SIGMA = 0.75
# unrounded figures of the running section, kept in its .json
RAW = {}


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _path(p: str) -> Path:
    return Path(p) if os.path.isabs(p) else ROOT / p


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sec_mixtures(lines, device):
    from lmc_atomi_torch.experiments.mixtures import lmc_gaussian_mixture

    lines += ["## Gaussian-mixture LMC — final W2 vs truth (k=10000)", ""]
    header = "| gamma | n | " + " | ".join(
        ["ULA", "MALA", "PULA", "IHPULA", "MLA"]
    ) + " |"
    lines += [header, "|" + "---|" * 7]
    for g in [0.1, 0.05, 0.01]:
        for n in [1, 2, 3, 4, 5]:
            _, curves, summ = lmc_gaussian_mixture(
                gamma_ula=g, gamma_mala=g, gamma_pula=g, gamma_ihpula=g,
                gamma_mla=g, n=n, k=10000, make_plots=False, eval_w2=True,
                w2_interval=9000, device=device,
            )
            row = " | ".join(
                f"{summ['final_w2'][m]:.3f}"
                for m in ["ULA", "MALA", "PULA", "IHPULA", "MLA"]
            )
            lines.append(f"| {g} | {n} | {row} |")
            _log(f"mixtures gamma={g} n={n} done")
    lines += [
        "",
        "IHPULA inverts a shifted per-step Hessian through one symmetric",
        "eigendecomposition (`kernels/langevin.py::ihpula`), which waits on",
        "the host every step on the card; its 10000-step float32 chain at",
        "gamma=0.1, n=2 is a regression test",
        "(`tests/test_torch_mixtures.py::test_ihpula_f32_no_divergence_gamma01_n2`).",
        "",
    ]
    _mixtures_multiscale(lines, device)


def _mixtures_multiscale(lines, device):
    """Certified exact W2 beyond the reference's 10k-point cap: k-means
    quantization on the device + weighted network-simplex EMD, with the
    triangle-inequality radius (eval/wasserstein.py::exact_w2_multiscale)."""
    from lmc_atomi_torch.core.random import fold_in
    from lmc_atomi_torch.eval.wasserstein import exact_w2, exact_w2_multiscale
    from lmc_atomi_torch.experiments.configs import gaussian_mixture_config
    from lmc_atomi_torch.kernels import ula
    from lmc_atomi_torch.models import GaussianMixture
    from lmc_atomi_torch.run.runner import run_chain

    dev = require_device(device, "results")
    mus, sigmas, omegas = gaussian_mixture_config(n=3)
    model = GaussianMixture.create(mus, sigmas, omegas, dtype=torch.float32, device=dev)
    k = 40000
    truth = model.sample(torch.Generator(device=dev).manual_seed(1), k)
    kern = ula(model.grad_potential, gamma=0.05)
    res = run_chain(kern, torch.zeros((2,), dtype=torch.float32, device=dev),
                    fold_in(0, 2), k, collect="samples")
    draws = res.samples
    v10k = float(exact_w2(truth[::4], draws[::4]))
    t0 = time.perf_counter()
    v, err = exact_w2_multiscale(truth, draws, k=3000)
    dt = time.perf_counter() - t0
    lines += [
        "Exact W2 beyond the 10k cap (ULA, gamma=0.05, n=3): quantized",
        "exact EMD on ALL 40k draws vs 10k-subsampled exact EMD",
        "(the reference protocol):",
        "",
        "| estimator | W2 | certificate |",
        "|---|---|---|",
        f"| 10k-subsample exact (reference cap) | {np.sqrt(v10k):.4f} | — |",
        "| 40k-point multiscale exact (k=3000, {:.0f}s) | {:.4f} "
        "| +-{:.4f} |".format(dt, np.sqrt(v), err),
        "",
    ]
    _log("mixtures multiscale done")


def sec_laplace(lines, device, laplace_exact: bool, laplace_k: int):
    lines += [
        "## Laplace-mixture LMC (smoothed potential) — final exact W2 vs truth",
        "",
    ]
    if laplace_exact:
        from lmc_atomi_torch.experiments.laplace_mixtures import lmc_laplacian_mixture

        _, _, summ = lmc_laplacian_mixture(
            k=laplace_k, k_eval=10000, eval_w2_exact=True, make_plots=False,
            device=device,
        )
        data = {"k": laplace_k, "final_w2_exact": summ["final_w2_exact"],
                "device": device_label(device)}
        Path(LAPLACE_JSON).parent.mkdir(parents=True, exist_ok=True)
        with open(LAPLACE_JSON, "w") as f:
            json.dump(data, f, indent=1)
        _log("laplace exact W2 done")
    elif os.path.exists(LAPLACE_JSON):
        with open(LAPLACE_JSON) as f:
            data = json.load(f)
    else:
        lines += [
            "No cached result — run `python3 scripts/make_results_torch.py",
            "--sections laplace --laplace_exact true` (host EMD, ~1 h).",
            "",
        ]
        return
    lines += [
        f"k={data['k']} steps; exact EMD on the final 10k samples — the",
        "reference's own setting (lmc.py:403-406, numItermax=1e5) via the",
        "native network simplex (`eval/emd_native.py`, multiscale warm start):",
        "",
        "| sampler | final exact W2 |",
        "|---|---|",
    ]
    for m, v in data["final_w2_exact"].items():
        lines.append(f"| {m} | {v:.3f} |")
    lines += [""]


_TABLE_HEAD = [
    "| model | MAP (aPDHG, 1000 it) | ULPDA mean (1000) | MYULA mean (1000) |",
    "|---|---|---|---|",
]
_IMAGE_INTROS = {
    "einstein": [
        "### Natural image (einstein, 512x512 center crop)",
        "",
        "The reference evaluates on real photographs",
        "(prox_lmc_deconv.py:44-50); the table above uses the",
        "synthetic phantom — exactly the image class TV priors",
        "flatter. This table repeats the full 9-model grid on the",
        "bundled `assets/einstein.png` (decoded by the pure-NumPy",
        "reader in `utils/png.py`), the honest benchmark:",
    ],
    "hopper": [
        "### Natural image (hopper, 512x512 center crop)",
        "",
        "Second bundled photograph (`assets/hopper.png`, the",
        "public-domain Grace Hopper portrait): a portrait with a",
        "texture mix — smooth face, sharp flag stripes, dark",
        "uniform — unlike einstein's blackboard scene:",
    ],
    "terrain": [
        "### Textured synthetic (terrain, 1/f^1.6 spectrum)",
        "",
        "A third image class (the reference's camera/ascent ship",
        "inside skimage, absent here): deterministic",
        "spectral-statistics terrain (`utils/images.py::terrain`)",
        "with natural-image power-law texture — no piecewise-flat",
        "structure for TV to exploit:",
    ],
}


def sec_deconv(lines, device):
    from lmc_atomi_torch.experiments.deconv import prox_lmc_deconv

    lines += [
        "## Bayesian deconvolution 512x512 — PSNR (dB) of the estimate",
        "",
        *_TABLE_HEAD,
    ]
    for image in ("phantom", "einstein", "hopper", "terrain"):
        if image in _IMAGE_INTROS:
            lines += ["", *_IMAGE_INTROS[image], "", *_TABLE_HEAD]
        cols = {}
        for branch, kw in [
            ("MAP", dict(compute_map=True, niter_map=1000)),
            ("ULPDA", dict(alg="ULPDA", n_steps=1000)),
            ("MYULA", dict(alg="MYULA", n_steps=1000)),
        ]:
            _, _, summ = prox_lmc_deconv(
                size=512, image=image, make_plots=False,
                collect_metrics=False,
                wavelet_row=(image == "phantom"), device=device, **kw
            )
            cols[branch] = {k: v["psnr"] for k, v in summ["report"].items()}
            blurred = summ["psnr_blurred"]
            _log(f"deconv {image} {branch} done")
        for model in cols["MAP"]:
            lines.append(
                f"| {model} | {cols['MAP'][model]:.2f} | "
                f"{cols['ULPDA'][model]:.2f} | {cols['MYULA'][model]:.2f} |"
            )
        lines += ["", f"Blurred observation (k5): {blurred:.2f} dB.", ""]


def sec_denoise(lines, device):
    from lmc_atomi_torch.experiments.denoise import l1_denoise_myula

    _, rep = l1_denoise_myula(make_plots=False, device=device)
    lines += [
        "## Pixel-l1 denoising 64x64 (BASELINE config 2) — PSNR (dB)",
        "",
        "MYULA with the soft-threshold prox over the Laplace-prior",
        "posterior, 2000 steps:",
        "",
        "| noisy obs | posterior mean | iters/s |",
        "|---|---|---|",
        "| {:.2f} | {:.2f} | {:.0f} |".format(
            rep["psnr_noisy"], rep["psnr_posterior_mean"],
            rep["iters_per_sec"],
        ),
        "",
    ]
    _log("denoise done")


def sec_wavelets(lines, device, wavelet_steps: int):
    from lmc_atomi_torch.experiments.inpainting import wavelet_inpainting

    lines += [
        "## Wavelet-l1 inpainting 512x512 — posterior-mean PSNR (dB)",
        "",
        "50% missing pixels, sigma=0.1, MYULA over the Moreau-smoothed",
        f"wavelet-l1 posterior, {wavelet_steps} steps; Haar vs Daubechies",
        "D4/D8 lifting DWTs (`ops/wavelet.py`):",
        "",
        "| image | Haar | D4 | D8 | masked obs |",
        "|---|---|---|---|---|",
    ]
    mala_note = None
    ulpda_rows = []
    fused_note = None
    for image in ("phantom", "einstein"):
        row, urow = [], []
        obs = None
        for wav in ("haar", "d4", "d8"):
            _, s = wavelet_inpainting(
                size=512, wavelet=wav, image=image, n_steps=wavelet_steps,
                make_plots=False,
                fused=(wav == "haar" and image == "phantom"), device=device,
            )
            row.append(s["report"]["MYULA"]["psnr"])
            urow.append(s["report"].get("ULPDA-wavelet", {}).get("psnr"))
            obs = s["report"]["observed"]["psnr"]
            if image == "phantom" and wav == "haar":
                mala_note = (
                    s["report"].get("MALA", {}).get("psnr"),
                    s.get("mala_acceptance"),
                )
                if "MYULA-fused" in s["report"]:
                    ips = s["iters_per_sec"]
                    fused_note = (
                        s["report"]["MYULA-fused"]["psnr"],
                        ips.get("MYULA-fused"),
                        s["report"].get("ULPDA-wavelet-fused", {}).get("psnr"),
                        ips.get("ULPDA-wavelet-fused"),
                        ips.get("MYULA"),
                        ips.get("ULPDA-wavelet"),
                    )
            _log(f"wavelets {image} {wav} done")
        lines.append(
            f"| {image} | " + " | ".join(f"{p:.2f}" for p in row)
            + f" | {obs:.2f} |"
        )
        if all(p is not None for p in urow):
            ulpda_rows.append((image, urow, obs))
    if mala_note and mala_note[0] is not None:
        acc = (
            f" (acceptance {mala_note[1]:.2f})"
            if mala_note[1] is not None else ""
        )
        lines += [
            "",
            "MYULA vs MALA (BASELINE config 4): on the Haar/phantom",
            "configuration the smooth-target MALA chain reaches",
            f"{mala_note[0]:.2f} dB{acc} — the accept/reject step forces",
            "a d^(-1/3)-scaled step size at d=512^2, so the unadjusted",
            "MYULA drift mixes far faster at equal step budget.",
        ]
    if ulpda_rows:
        lines += [
            "",
            "Wavelet-dual ULPDA (dual variable in the orthogonal-DWT",
            "coefficient domain — the reference's generic-operator ULPDA,",
            "algs.py:436-448 — so the l1 prox is exact, no Moreau",
            "smoothing), same step budget:",
            "",
            "| image | Haar | D4 | D8 |",
            "|---|---|---|---|",
        ]
        for image, urow, _ in ulpda_rows:
            lines.append(
                f"| {image} | " + " | ".join(f"{p:.2f}" for p in urow) + " |"
            )
    if fused_note is not None:
        m_psnr, m_ips, u_psnr, u_ips, m0_ips, u0_ips = fused_note
        lines += [
            "",
            "Fused Haar kernels on the card (kernels 4 and 5,",
            "`csrc/wavelet_block.cu`: the interleaved lifting DWT, a warp an",
            "8 x 8 square) on the phantom/Haar config:",
            f"MYULA-fused {m_psnr:.2f} dB at {m_ips:.0f} iters/s"
            + (f" (unfused {m0_ips:.0f})" if m0_ips else "") + ";",
        ]
        if u_psnr is not None:
            lines += [
                f"wavelet-dual ULPDA-fused {u_psnr:.2f} dB at"
                f" {u_ips:.0f} iters/s"
                + (f" (unfused {u0_ips:.0f})" if u0_ips else "") + ".",
            ]
    lines += [""]


def sec_pnp(lines, device, pnp_pattern: str):
    lines += [
        "## PnP-ULA credible-interval farm (BASELINE config 5, 256x256)",
        "",
    ]
    pattern = str(_path(pnp_pattern))
    if glob.glob(pattern):
        from lmc_atomi_torch.experiments.pnp import pnp_merge

        old = {}
        if os.path.exists(PNP_JSON):  # the farm script's report: its other keys stay
            with open(PNP_JSON) as f:
                old = json.load(f)
        rep = {**old, **pnp_merge(pattern=pattern, size=256, device=device),
               "device": device_label(device)}
        with open(PNP_JSON, "w") as f:
            json.dump(rep, f, indent=1)
    elif os.path.exists(PNP_JSON):
        with open(PNP_JSON) as f:
            rep = json.load(f)
    else:
        lines += [
            "Farm moments not found — run `python3 scripts/expt_pnp1024_torch.py`",
            "(trains the SN-DnCNN prior once, then 16 x 64-chain blocks of 2000",
            "steps each) and re-run this section.",
            "",
        ]
        return
    lines += [
        f"{rep['n_chains']} PnP-ULA chains (SN-DnCNN prior, certified",
        "residual Lipschitz bound via circular-conv operator norms), 2000",
        f"steps each, {rep['n_chain_draws']} pooled post-burn-in draws:",
        "",
        "| quantity | value |",
        "|---|---|",
        f"| posterior-mean PSNR | {rep['psnr_posterior_mean']:.2f} dB |",
        f"| mean 95% CI width | {rep['mean_ci_width']:.4f} |",
        f"| max posterior std | {rep['std_max']:.4f} |",
        "",
    ]
    anchor_json = os.path.join(os.path.dirname(PNP_JSON), "results_pnp_anchor.json")
    if os.path.exists(anchor_json):
        with open(anchor_json) as f:
            a = json.load(f)
        delta = a["psnr_posterior_mean"] - a["psnr_tv_baseline_mean"]
        lines += [
            "TV-MYULA anchor on the IDENTICAL observation (same blur,",
            "noise draw, and seed; fused kernel 2 with in-kernel P^2 CI,",
            f"{a['tv_steps']} steps — the reference reports model",
            "comparisons side-by-side, prox_lmc_deconv.py:707-735;",
            "`scripts/expt_pnp_anchor_torch.py`):",
            "",
            "| prior (same 256^2 observation) | mean PSNR (dB) "
            "| mean 95% CI width |",
            "|---|---|---|",
            "| SN-DnCNN PnP ({} chains x {} steps, alpha=1.0) "
            "| {:.2f} | {:.4f} |".format(
                a["n_chains"], a["n_steps"],
                a["psnr_posterior_mean"], a["mean_ci_width"],
            ),
            "| hand-crafted TV (tau={}) | {:.2f} | {:.4f} |".format(
                a["tau_tv_baseline"], a["psnr_tv_baseline_mean"],
                a["tv_baseline_ci_width"],
            ),
        ]
        if "psnr_score_mean" in a:
            lines.append(
                "| annealed score-ULA ({} chains x {} steps, alpha=1.0) "
                "| {:.2f} | {:.4f} |".format(
                    a["n_chains"], a["n_steps"],
                    a["psnr_score_mean"], a["score_ci_width"],
                )
            )
        lines += [
            "",
            "The TV weight is the one the JAX package's sweep picked on this",
            "observation (`scripts/expt_pnp_anchor.py`).",
            "",
            f"The learned prior buys **{delta:+.2f} dB** over TV at the",
            "matched config. Prior-strength ablation (same observation,",
            "{} chains): alpha=1.0 -> {:.2f} dB, alpha=0.3 -> {:.2f} dB;".format(
                a["ablation_n_chains"], a["psnr_alpha_1.0"],
                a["psnr_alpha_0.3"],
            ),
            "certified residual Lipschitz bound"
            f" {a['lipschitz_certified_bound']:.2f} (circular-conv layer",
            f"product), measured {a['lipschitz_measured']:.2f} — the",
            "alpha=1.0 step size satisfies the Laumont et al. ergodicity",
            "condition with the measured constant.",
            "",
        ]
    _log("pnp farm summary done")


def sec_prox(lines, device):
    from lmc_atomi_torch.eval.wasserstein import sliced_w2
    from lmc_atomi_torch.experiments.prox_mixtures import prox_lmc_gaussian_mixture

    dev = require_device(device, "results")
    samples, summ = prox_lmc_gaussian_mixture(
        k=50000, n=5, make_plots=False, device=device
    )
    names = list(samples)
    drawn = {m: torch.as_tensor(np.asarray(samples[m]), device=dev) for m in names}
    pooled = torch.cat([drawn[m] for m in names])
    # sliced_w2 matches sorted projections 1:1 — equal counts required
    pooled = pooled[:: len(names)]
    lines += [
        "## Proximal LMC — 5-mode mixture x Laplace prior, k=50000",
        "",
        "No closed-form sampler exists for the composite target, so the",
        "diagnostic is cross-kernel consistency (reference prox_lmc.py",
        "validates visually): sliced W2 of each kernel's draws against the",
        "pool of all six.",
        "",
        "| kernel | iters/s | sliced W2 vs pool |",
        "|---|---|---|",
    ]
    for m in names:
        w = float(sliced_w2(drawn[m], pooled,
                            generator=torch.Generator(device=dev).manual_seed(7)))
        lines.append(
            f"| {m} | {summ['iters_per_sec'][m]:.0f} | {w:.3f} |"
        )
    lines += [""]
    _log("prox done")


def sec_ct(lines, device):
    from lmc_atomi_torch.experiments.ct import ct_tv_myula

    lines += [
        "## Sparse-view CT (Radon, sigma=2) — PSNR (dB)",
        "",
        "TV-MYULA posterior vs TV-MAP (adaptive PDHG) vs learned DnCNN",
        "PnP-ULA, from the Hann-FBP analytic start (ops/radon.py::fbp). The",
        "128^2/30-angle config uses the dense-matrix Radon (one cuBLAS",
        "matrix-vector product each way); 256^2/90 angles sits far above",
        "the 512 MiB dense budget and runs on the three-shear FFT projector",
        "(`ops/radon.py`, auto-selected). Score = annealed score-ULA under",
        "the noise-conditional score net (models/score.py), the",
        "beyond-DnCNN learned prior:",
        "",
        "| config | backprojection | FBP (Hann) | TV posterior mean |"
        " TV MAP | DnCNN-PnP mean | score-ULA mean |",
        "|---|---|---|---|---|---|---|",
    ]
    for size, n_angles in ((128, 30), (256, 90)):
        _, _, rep = ct_tv_myula(
            size=size, n_angles=n_angles, make_plots=False,
            score_prior=True, device=device,
        )
        lines.append(
            "| {}^2, {} angles | {:.2f} | {:.2f} | {:.2f} | {:.2f} | {:.2f} |"
            " {:.2f} |".format(
                size, n_angles,
                rep["psnr_backprojection"], rep["psnr_fbp"],
                rep["psnr_posterior_mean"],
                rep.get("psnr_map_tv", float("nan")),
                rep.get("psnr_pnp_mean", float("nan")),
                rep.get("psnr_score_mean", float("nan")),
            )
        )
        _log(f"ct {size} done")
    lines += [""]
    if os.path.exists(CT_SCORE_STUDY):
        lines += _ct_score_note(CT_SCORE_STUDY)


def _ct_score_note(path):
    """The prose under the CT table: how often score nets of either package
    drift in the 128^2 chain, from ``scripts/ct_score_drift.py``'s summary."""
    import textwrap

    with open(path) as f:
        study = json.load(f)
    lines = []
    for stream, v in study["streams"].items():
        (n_port, n_jax), (b_port, b_jax) = v["n"], v["below"]
        seeds = [s for s, *_ in v["port"]]
        spread = ["{:.2f} to {:.2f} dB (median {:.2f}, mean {:.2f})".format(
            min(x for _, x, _ in v[k]), max(x for _, x, _ in v[k]), med, mean)
            for k, med, mean in zip(("port", "jax"), v["median_state_psnr"],
                                    v["mean_state_psnr"])]
        text = (
            "Score-ULA runs no corrector here, and its chain at the finest level "
            f"drifts for some score nets in both packages. Over the nets of seeds "
            f"{min(seeds)}-{max(seeds)}, {b_port} of the port's {n_port} and {b_jax} of the "
            f"JAX package's {n_jax} end the 128^2 chain below {study['drift_db']:g} dB "
            f"(state PSNR at step {study['steps']}, noise stream {stream}): the port's "
            f"states span {spread[0]}, the JAX package's {spread[1]}. One-sided "
            f"Mann-Whitney U {v['mann_whitney_u']:.0f}, p = {v['p_mann_whitney']:.3f}; "
            f"Fisher p = {v['p_fisher']:.3f} (`scripts/ct_score_drift.py`: the chains "
            f"on {study['device']}, JAX's nets fitted on the CPU). The rows above are "
            "seed 0, as the JAX generator "
            "publishes them."
        )
        lines += textwrap.wrap(text, 72, break_on_hyphens=False) + [""]
    return lines


def sec_sgld(lines, device, sgld_k: int):
    from lmc_atomi_torch.experiments.sgld_runs import modes_covered, sgld_grid_mixture

    samples, summ = sgld_grid_mixture(k=sgld_k, make_plots=False, device=device)
    lines += [
        f"## SGLD family — 25-mode grid mixture, k={sgld_k}",
        "",
        "Mode coverage = modes with a retained draw within unit distance",
        "(the multimodal-exploration diagnostic the contour/cyclical",
        "variants exist for; reference jax/sgld.py, jax/prox_sgld.py).",
        "",
        "The prox variants target the mixture TIMES a Laplace(alpha=1)",
        "prior, so their ceiling is NOT 25/25-with-uniform-mass: the",
        "corner modes carry e^-8 of the center's mass. Their prox is",
        "step-scaled, prox_{g|.|/alpha} (kernels/sgmcmc.py), so the prior",
        "weight it implies stays fixed over the decaying schedule.",
        "",
        "| sampler | iters/s | retained draws | modes covered /25 |",
        "|---|---|---|---|",
    ]
    for name, s in samples.items():
        lines.append(
            f"| {name} | {summ['iters_per_sec'][name]:.0f} | "
            f"{summ['retained'][name]} | {modes_covered(s)} |"
        )
    lines += [""]
    _log("sgld done")


def _deblur_problem(dev):
    """The 512^2 phantom TV-deblur problem of the ci and throughput sections
    (the JAX sections' and ``bench.py``'s): 5x5 uniform blur, sigma=0.75,
    the observation's noise from a generator seeded 0 on ``dev``."""
    from lmc_atomi_torch.ops.functionals import L2Data
    from lmc_atomi_torch.ops.linops import CirculantBlur2D, uniform_kernel
    from lmc_atomi_torch.utils.images import phantom

    n = CI_SIZE
    img = torch.from_numpy(phantom(n)).to(dev, torch.float32)
    blur = CirculantBlur2D.from_kernel((n, n), uniform_kernel(5, torch.float32, dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    y = blur.matvec(img) + BLUR_SIGMA * torch.randn(
        (n, n), generator=gen, dtype=torch.float32, device=dev)
    return img, blur, y, L2Data.create(op=blur, b=y, sigma=1 / BLUR_SIGMA**2)


def _timed(run, dev, steps, warm=0):
    """``steps / seconds`` of ``run(key, steps)`` under key 1, after a
    warm-up of ``warm`` steps under key 101 (none for 0), with a sync
    around the timed call; returns ``(iters/s, its result)``."""
    if warm:
        run(101, warm)
    _sync(dev)
    t0 = time.perf_counter()
    out = run(1, steps)
    _sync(dev)
    return steps / (time.perf_counter() - t0), out


def sec_ci(lines, device):
    """512^2 credible-interval maps at fused speed: the P^2 marker state is
    updated inside kernel 2 next to the Welford moments, so the 95% CI costs
    one extra in-kernel recurrence, not a fall-back to the unfused runner."""
    from lmc_atomi_torch.eval.metrics import psnr
    from lmc_atomi_torch.kernels.myula_fused import run_myula_tv_fused
    from lmc_atomi_torch.kernels.wavelet_fused import run_myula_wavelet_fused
    from lmc_atomi_torch.ops.functionals import L2Data
    from lmc_atomi_torch.ops.linops import Mask

    dev = require_device(device, "results")
    n, steps, burn = CI_SIZE, CI_STEPS, CI_BURN
    img, _, _, l2 = _deblur_problem(dev)
    gamma = BLUR_SIGMA**2
    lines += [
        "## Credible intervals at fused speed (512x512 TV-deblur)",
        "",
        "Per-pixel 2.5%/97.5% posterior quantiles from P^2 marker state",
        "updated inside the fused MYULA kernel (kernel 2,",
        "`csrc/myula_block.cu`; cold 10-trip TV prox, reference",
        "semantics), " + f"{steps} steps / {burn} burn-in.",
        "`quantile_thin=k` records every k-th post-burn draw at fixed",
        "in-kernel positions (autocorrelated chains lose almost nothing);",
        "timed after a warm-up under another key:",
        "",
        "| quantile stream | iters/s | mean 95% CI width | mean PSNR (dB) |",
        "|---|---|---|---|",
    ]
    x0 = torch.zeros_like(img)
    for label, thin in (("every draw", 1), ("thin=2", 2), ("thin=4", 4)):
        def run(key, ns, t=thin):
            return run_myula_tv_fused(
                l2, 0.3, 0.2 * gamma, gamma, x0, key, ns, block=500,
                burn_in=burn, quantiles=(0.025, 0.975), quantile_thin=t,
            )

        ips, out = _timed(run, dev, steps, CI_WARM)
        w = float(torch.mean(out.quantiles[0.975] - out.quantiles[0.025]))
        p = float(psnr(img, out.moments.mean))
        lines.append(f"| {label} | {ips:.0f} | {w:.3f} | {p:.2f} |")
        RAW[label] = dict(iters_per_sec=ips, ci_width=w, psnr=p)
        _log(f"ci thin={thin} done")
    # wavelet-l1 inpainting CI at fused speed (kernel 4)
    gen = torch.Generator(device=dev).manual_seed(2)
    imgw = img / 255.0
    maskw = (torch.rand((n, n), generator=gen, device=dev) > 0.5).to(torch.float32)
    yw = maskw * imgw + 0.1 * maskw * torch.randn(
        (n, n), generator=gen, dtype=torch.float32, device=dev)
    l2w = L2Data(op=Mask(mask=maskw), b=yw, sigma=1.0 / 0.1**2)
    gw = 0.1**2

    def runw(key, ns):
        return run_myula_wavelet_fused(
            l2w, 5.0, 0.2 * gw, gw, yw, key, ns, block=500, burn_in=burn,
            quantiles=(0.025, 0.975),
        )

    ipsw, outw = _timed(runw, dev, steps, CI_WARM)
    ww = float(torch.mean(outw.quantiles[0.975] - outw.quantiles[0.025]))
    pw = float(psnr(imgw, outw.moments.mean))
    RAW["wavelet"] = dict(iters_per_sec=ipsw, ci_width=ww, psnr=pw)
    lines += [
        "",
        "Wavelet-l1 inpainting CI at fused speed (Haar, 50% missing,",
        "kernel 4, `csrc/wavelet_block.cu` — the same in-kernel P^2 stream):",
        f"{ipsw:.0f} iters/s, mean 95% CI width {ww:.3f}, posterior-mean",
        f"PSNR {pw:.2f} dB.",
        "",
    ]
    _log("ci wavelet done")


def sec_multichain(lines, device):
    """Multi-chain farm in one kernel call a block vs solo chain."""
    from lmc_atomi_torch.experiments.multichain import multichain_deblur

    lines += [
        "## Multi-chain UQ (fused MYULA and ULPDA, one kernel call for all chains)",
        "",
        "Every chain of a farm is a grid layer of one launch of kernel 2",
        "or 3 (`run_myula_tv_fused_packed` / `run_ulpda_fused_packed`).",
        "Pooled posterior stats and the streaming Gelman-Rubin R-hat come",
        "from per-chain Welford moments",
        "(`eval/diagnostics.py::rhat_from_moments`) — no sample hoarding:",
        "",
        "| config | pack | aggregate iters/s | pooled PSNR | max R-hat |",
        "|---|---|---|---|---|",
    ]
    for size, chains, kernel in (
        (64, 8, "myula"), (64, 8, "ulpda"), (32, 8, "myula")
    ):
        _, _, rep = multichain_deblur(
            size=size, n_chains=chains, n_steps=20000, burn_in=2000,
            kernel=kernel, make_plots=False, device=device,
        )
        lines.append(
            "| {}^2 x {} chains ({}) | {} | {:.0f} | {:.2f} | {:.3f} |"
            .format(
                size, chains, kernel.upper(), rep["pack"],
                rep["aggregate_iters_per_sec"], rep["psnr_pooled_mean"],
                rep["rhat_max"],
            )
        )
        _log(f"multichain {size} {kernel} done")
    lines += [""]


def _throughput_rows(l2, blur, y, x0):
    """``(row label, [run(key, n_steps) per configuration])``: the fused
    512^2 single-chain configurations of the JAX section's table."""
    import dataclasses

    from lmc_atomi_torch.kernels.myula_fused import run_myula_tv_fused
    from lmc_atomi_torch.kernels.ulpda_fused import run_ulpda_fused
    from lmc_atomi_torch.ops.functionals import L21Norm
    from lmc_atomi_torch.ops.linops import Gradient2D
    from lmc_atomi_torch.ops.ncvx_tv import L2NcvxTV

    sigma = 1 / BLUR_SIGMA**2
    gamma = BLUR_SIGMA**2
    tau = 0.2 * gamma
    common = dict(op=blur, b=y, sigma=sigma, lamda=0.3, gamma=15.0, isotropic=True)
    mctv = L2NcvxTV(op2=Gradient2D(), **common)
    metv = L2NcvxTV(op2=None, **common)

    def myula(term, **kw):
        return lambda key, ns: run_myula_tv_fused(term, 0.3, tau, gamma, x0, key, ns,
                                                  block=500, **kw)

    def ulpda(term, **kw):
        return lambda key, ns: run_ulpda_fused(term, L21Norm(sigma=0.3), Gradient2D(),
                                               0.95 / sigma, 1.0, x0, key, ns, block=250,
                                               **kw)

    warm5 = dict(niter_tv=5, tv_warm=True)
    return [
        ("MYULA TV cold (reference semantics)", [myula(l2)]),
        ("MYULA TV warm dual", [myula(l2, **warm5)]),
        ("MYULA MC-TV cold / warm", [myula(mctv), myula(mctv, **warm5)]),
        ("MYULA ME-TV cold / warm",
         [myula(metv), myula(dataclasses.replace(metv, niter_inner=5), **warm5)]),
        ("ULPDA TV (Chebyshev-6 gram solve)", [ulpda(l2, niter_solve=6)]),
        ("ULPDA TV Chebyshev 8 / 4 / 3 sweeps",
         [ulpda(l2, niter_solve=k) for k in (8, 4, 3)]),
        ("ULPDA ME-TV cold / env-warm 5 / env-warm 3",
         [ulpda(metv), ulpda(metv, env_warm=True, niter_inner=5),
          ulpda(metv, env_warm=True, niter_inner=3)]),
    ]


def sec_throughput(lines, device):
    dev = require_device(device, "results")
    label = device_label(device)
    _, blur, y, l2 = _deblur_problem(dev)
    x0 = torch.zeros_like(y)
    lines += [
        f"## Throughput ({label})",
        "",
        f"Timed by this section: each row runs the fused {CI_SIZE}x{CI_SIZE}",
        f"TV-deblur runner of one chain for {THROUGHPUT_STEPS} steps with",
        "streaming posterior moments, after a warm-up under another key, with",
        "`torch.cuda.synchronize()` around each timed call; a cell is the",
        f"median of {THROUGHPUT_REPEATS} timed calls, their range in brackets.",
        "MYULA is kernel 2 (`csrc/myula_block.cu`, blocks of 500 steps), ULPDA kernel 3",
        "(`csrc/ulpda_block.cu`, blocks of 250). 'cold' = the reference's",
        "cold 10-trip TV prox (prox_lmc_deconv.py:122, the headline",
        "semantics), 'warm' = the dual warm-started across steps (5 trips);",
        "ULPDA's gram solve is a fixed-trip Chebyshev semi-iteration (the",
        "port's default: 3 sweeps), ME-TV's envelope 10 inner trips cold or",
        "warm-started with 5 or 3:",
        "",
        f"| config ({CI_SIZE}^2, fused, single chain) | iters/s |",
        "|---|---|",
    ]
    for row, runs in _throughput_rows(l2, blur, y, x0):
        rates = []
        for run in runs:
            run(101, THROUGHPUT_WARM)
            rates.append(sorted(_timed(run, dev, THROUGHPUT_STEPS)[0]
                                for _ in range(THROUGHPUT_REPEATS)))
        lines.append(f"| {row} | " + " / ".join(
            f"{r[len(r) // 2] / 1e3:.1f}k ({r[0] / 1e3:.1f}-{r[-1] / 1e3:.1f}k)"
            for r in rates) + " |")
        RAW[row] = rates
        _log(f"throughput {row}: {rates}")
    lines += [""]


SECTIONS = {
    "mixtures": lambda lines, a: sec_mixtures(lines, a["device"]),
    "laplace": lambda lines, a: sec_laplace(lines, a["device"], a["laplace_exact"],
                                            a["laplace_k"]),
    "prox": lambda lines, a: sec_prox(lines, a["device"]),
    "denoise": lambda lines, a: sec_denoise(lines, a["device"]),
    "deconv": lambda lines, a: sec_deconv(lines, a["device"]),
    "wavelets": lambda lines, a: sec_wavelets(lines, a["device"], a["wavelet_steps"]),
    "pnp": lambda lines, a: sec_pnp(lines, a["device"], a["pnp_pattern"]),
    "ct": lambda lines, a: sec_ct(lines, a["device"]),
    "sgld": lambda lines, a: sec_sgld(lines, a["device"], a["sgld_k"]),
    "ci": lambda lines, a: sec_ci(lines, a["device"]),
    "multichain": lambda lines, a: sec_multichain(lines, a["device"]),
    "throughput": lambda lines, a: sec_throughput(lines, a["device"]),
}
ORDER = DEFAULT_SECTIONS.split(",")


def title_lines(devices):
    cards = "; ".join(f"`{d}`" for d in devices) or "none: no section has run"
    return [
        "# RESULTS — measured benchmark tables",
        "",
        f"Device: {cards} (single card). All numbers produced by",
        "`scripts/make_results_torch.py` on the PyTorch port",
        "(`lmc_atomi_torch`), one section at a time",
        "(`results_sections/`); the reference publishes no numbers to",
        "compare against (BASELINE.md), so these are the port's checked-in",
        "baselines (`RESULTS.md` at the repo's root holds the JAX package's).",
        "",
    ]


def assemble(out: Path) -> list:
    """Write ``out`` from the title and every section file present under
    ``out``'s ``results_sections/``, in ``DEFAULT_SECTIONS`` order; returns
    the sections it took."""
    sec_dir = out.parent / "results_sections"
    present = [s for s in ORDER if (sec_dir / f"{s}.md").exists()]
    devices = []
    for s in present:
        meta = sec_dir / f"{s}.json"
        d = json.loads(meta.read_text())["device"] if meta.exists() else "unknown"
        if d not in devices:
            devices.append(d)
    lines = title_lines(devices)
    for s in present:
        lines += (sec_dir / f"{s}.md").read_text().splitlines()
    out.write_text("\n".join(lines) + "\n")
    return present


def main(
    sections: str = DEFAULT_SECTIONS,
    laplace_exact: bool = False,
    laplace_k: int = 50000,
    wavelet_steps: int = 2000,
    sgld_k: int = 50000,
    pnp_pattern: str = PNP_PATTERN,
    out: str = "assets/torch/RESULTS.md",
    device: str = "cuda",
):
    """Run the named sections, keep each one's lines as it ends, and put
    ``out`` together; exits 1 if a section failed."""
    want = [s.strip() for s in sections.split(",") if s.strip()]
    unknown = [s for s in want if s not in SECTIONS]
    if unknown:
        raise SystemExit(f"unknown sections {unknown}; known: {ORDER}")
    out_path = _path(out)
    sec_dir = out_path.parent / "results_sections"
    sec_dir.mkdir(parents=True, exist_ok=True)
    args = dict(device=device, laplace_exact=laplace_exact, laplace_k=laplace_k,
                wavelet_steps=wavelet_steps, sgld_k=sgld_k, pnp_pattern=pnp_pattern)
    label = None
    if want:
        require_device(device, "results")
        label = device_label(device)
    failed = []
    for name in [s for s in ORDER if s in want]:
        md, meta = sec_dir / f"{name}.md", sec_dir / f"{name}.json"
        md.unlink(missing_ok=True)
        meta.unlink(missing_ok=True)
        lines = []
        RAW.clear()
        t0 = time.perf_counter()
        try:
            SECTIONS[name](lines, args)
        except Exception:
            traceback.print_exc()
            _log(f"section {name} FAILED")
            failed.append(name)
            continue
        seconds = time.perf_counter() - t0
        md.write_text("\n".join(lines) + "\n")
        meta.write_text(json.dumps({"device": label, "seconds": seconds, "raw": RAW}) + "\n")
        _log(f"section {name} done in {seconds:.1f} s [{label}]")
    present = assemble(out_path)
    _log(f"wrote {out_path} ({', '.join(present) or 'no section'})")
    if failed:
        _log(f"failed sections: {', '.join(failed)}")
        raise SystemExit(1)
    return present


if __name__ == "__main__":
    auto_cli(main)
