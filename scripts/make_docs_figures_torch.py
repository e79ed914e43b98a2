"""Generate the PyTorch port's documentation figures
(``docs/figures_torch/*.png``): the counterpart of
``scripts/make_docs_figures.py``, workload for workload at its sizes, with
the JAX figures' file names: mixture histograms and W2 curves, the 9-model
deconvolution image grid, the PnP-ULA uncertainty maps and the sparse-view
CT posterior panels.

It runs in two stages, since the machine with the card need not have
matplotlib:

    python3 scripts/make_docs_figures_torch.py --stage compute   # on the card
    python3 scripts/make_docs_figures_torch.py --stage render    # where matplotlib is

``compute`` runs the four workloads (on the card unless ``--device cpu`` is
given) and writes every panel's arrays to one ``.npz`` at ``--arrays``; it
imports no matplotlib. ``render`` reads that file and draws it with
``experiments/figures.py`` into ``--outdir``. Relative paths are taken from
the repo's root.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from lmc_atomi_torch.utils.cli import auto_cli  # noqa: E402

SEP = "::"  # figure :: panel in the keys of the arrays file


def _path(p: str) -> Path:
    return Path(p) if os.path.isabs(p) else ROOT / p


def compute(device: str = "cuda") -> dict:
    """Every panel's arrays, keyed ``figure::panel`` in panel order."""
    import torch

    from lmc_atomi_torch.utils.cli import require_device

    dev = require_device(device, "figures")
    out = {}

    # --- workload 1: mixtures ------------------------------------------------
    from lmc_atomi_torch.experiments.configs import gaussian_mixture_config
    from lmc_atomi_torch.experiments.mixtures import lmc_gaussian_mixture
    from lmc_atomi_torch.models import GaussianMixture

    samples, curves, _ = lmc_gaussian_mixture(
        n=5, k=10000, make_plots=False, eval_w2=True, w2_interval=500, device=device,
    )
    mus, sigmas, om = gaussian_mixture_config(5)
    gm = GaussianMixture.create(mus, sigmas, om, dtype=torch.float32, device=dev)
    grid = np.linspace(-5, 5, 200)
    xg, yg = np.meshgrid(grid, grid)
    pos = torch.as_tensor(np.stack([xg, yg], -1), dtype=torch.float32, device=dev)
    out.update({f"grid{SEP}xg": xg, f"grid{SEP}yg": yg,
                f"grid{SEP}z": gm.density(pos).cpu().numpy()})
    for name, s in samples.items():
        out[f"samples{SEP}{name}"] = np.asarray(s)
    for name, (ks, vals) in curves.items():
        out[f"w2_k{SEP}{name}"] = np.asarray(ks)
        out[f"w2{SEP}{name}"] = np.asarray(vals)

    # --- workload 4: deconvolution -------------------------------------------
    from lmc_atomi_torch.experiments.deconv import prox_lmc_deconv
    from lmc_atomi_torch.ops.linops import CirculantBlur2D, uniform_kernel
    from lmc_atomi_torch.utils.images import phantom

    results, _, _ = prox_lmc_deconv(
        size=256, n_steps=500, alg="MYULA", make_plots=False,
        collect_metrics=False, device=device,
    )
    img = phantom(256)
    # the observation prox_lmc_deconv deblurred (its seed 0), for display
    blur = CirculantBlur2D.from_kernel((256, 256), uniform_kernel(5, torch.float32, dev))
    gen = torch.Generator(device=dev).manual_seed(0)
    y = blur.matvec(torch.from_numpy(img).to(dev)) + 0.75 * torch.randn(
        (256, 256), generator=gen, dtype=torch.float32, device=dev)
    panels = {"Ground truth": img, "Blurred": y.cpu().numpy(), **results}
    out.update({f"deconv{SEP}{k}": np.asarray(v) for k, v in panels.items()})

    # --- PnP-ULA uncertainty --------------------------------------------------
    from lmc_atomi_torch.experiments.pnp import pnp_ula_deblur

    mean, std, _ = pnp_ula_deblur(
        size=128, train_steps=300, n_steps=800, burn_in=100, n_chains=16,
        chain_block=16, make_plots=False, device=device,
    )
    out[f"pnp{SEP}PnP-ULA posterior mean"] = mean
    out[f"pnp{SEP}Posterior std"] = std

    # --- sparse-view CT -------------------------------------------------------
    # all four reconstruction branches on one panel: TV posterior, TV MAP,
    # DnCNN-PnP, annealed score-ULA
    from lmc_atomi_torch.experiments.ct import ct_tv_myula

    arrays = {}
    ct_tv_myula(
        n_steps=2000, burn_in=200, compute_map=True, pnp=True,
        score_prior=True, make_plots=False, arrays_out=arrays, device=device,
    )
    panels = {
        "Ground truth": arrays["img"],
        "Sinogram (30 angles)": arrays["sino"],
        "TV posterior mean": arrays["mean"],
        "Posterior std": arrays["std"],
        "TV MAP (aPDHG)": arrays["map"],
        "PnP-ULA mean (DnCNN)": arrays["pnp_mean"],
        "Score-ULA mean (annealed)": arrays["score_mean"],
    }
    out.update({f"ct{SEP}{k}": np.asarray(v) for k, v in panels.items()})
    return out


def _figure(arrays, fig: str) -> dict:
    """``{panel: array}`` of figure ``fig``, in the file's order."""
    pre = fig + SEP
    return {k[len(pre):]: arrays[k] for k in arrays.files if k.startswith(pre)}


def render(arrays_path: Path, outdir: Path) -> list:
    """Draw the five figures from the arrays file; returns their paths."""
    from lmc_atomi_torch.experiments import figures as F

    F.ensure_outdir(str(outdir))
    with np.load(arrays_path) as a:
        w2_k = _figure(a, "w2_k")
        curves = {m: (w2_k[m], v) for m, v in _figure(a, "w2").items()}
        paths = [outdir / f for f in ("mixtures_hist.png", "mixtures_w2.png",
                                      "deconv_grid.png", "pnp_uncertainty.png",
                                      "ct_posterior.png")]
        grid = _figure(a, "grid")
        F.sample_grid(grid["xg"], grid["yg"], grid["z"], _figure(a, "samples"), str(paths[0]),
                      mode="hist")
        F.w2_curves(curves, str(paths[1]))
        F.image_grid(_figure(a, "deconv"), str(paths[2]), ncols=4)
        F.image_grid(_figure(a, "pnp"), str(paths[3]), ncols=2)
        F.image_grid(_figure(a, "ct"), str(paths[4]), ncols=4)
    return paths


def main(
    stage: str = "compute",
    arrays: str = "runs/figures_torch/arrays.npz",
    outdir: str = "docs/figures_torch",
    device: str = "cuda",
):
    """``compute``: the panels' arrays to ``arrays``; ``render``: the PNGs
    from them to ``outdir``."""
    path = _path(arrays)
    if stage == "compute":
        panels = compute(device)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **panels)
        print(f"arrays written to {path}")
    elif stage == "render":
        for p in render(path, _path(outdir)):
            print(f"wrote {p}")
    else:
        raise SystemExit(f"unknown stage {stage!r}: compute or render")


if __name__ == "__main__":
    auto_cli(main)
