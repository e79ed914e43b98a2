"""Figures (counterpart of ``lmc_atomi_tpu/experiments/figures.py``): 3-D
density surfaces with top-view contours, 2-D sample histograms and KDE grids
(scipy ``gaussian_kde``), W2-vs-samples curves, image grids and metric
evolution plots, with the reference's file names (lmc.py:249-343,
prox_lmc_deconv.py:301-445). Headless (Agg). matplotlib is imported inside
each function: a machine without it runs every workload with
``make_plots=False``, and a plot asked for there raises an ``ImportError``
that names it. Inputs are numpy arrays (or anything ``np.asarray`` takes).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

__all__ = [
    "ensure_outdir",
    "density_surface",
    "sample_grid",
    "w2_curves",
    "image_grid",
    "metric_evolution",
]


def _plt():
    """``(pyplot, cm)`` on the Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("make_plots needs matplotlib, which is not installed here; "
                          "pass make_plots=False") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm

    return plt, cm


def ensure_outdir(outdir: str) -> str:
    os.makedirs(outdir, exist_ok=True)
    return outdir


def density_surface(xg, yg, z, path: str, title: Optional[str] = None):
    """3-D surface and top-view contour pair (reference lmc.py:249-270)."""
    plt, cm = _plt()
    fig = plt.figure(figsize=(10, 5))
    ax1 = fig.add_subplot(1, 2, 1, projection="3d")
    ax1.plot_surface(xg, yg, z, rstride=3, cstride=3, linewidth=1, antialiased=True,
                     cmap=cm.viridis)
    ax1.view_init(45, -70)
    ax2 = fig.add_subplot(1, 2, 2, projection="3d")
    ax2.contourf(xg, yg, z, zdir="z", offset=0, cmap=cm.viridis)
    ax2.view_init(90, 270)
    ax2.grid(False)
    ax2.set_xticks([])
    ax2.set_yticks([])
    ax2.set_zticks([])
    if title:
        fig.suptitle(title)
    fig.savefig(path, dpi=300)
    plt.close(fig)


def _kde2d(samples, xg, yg):
    from scipy.stats import gaussian_kde

    kde = gaussian_kde(samples.T)
    return kde(np.vstack([xg.ravel(), yg.ravel()])).reshape(xg.shape)


def sample_grid(xg, yg, z_true, sampler_samples: Dict[str, np.ndarray], path: str,
                mode: str = "hist", extra_panels: Optional[Dict[str, np.ndarray]] = None,
                bins: int = 100, lim: float = 5.0):
    """True-density contour and a 2-D histogram or KDE panel per sampler
    (reference lmc.py:288-343)."""
    plt, cm = _plt()
    panels = [("True density", None)]
    if extra_panels:
        panels += [(k, ("field", v)) for k, v in extra_panels.items()]
    panels += [(k, ("samples", v)) for k, v in sampler_samples.items()]
    n = len(panels)
    ncols = 3 if n <= 6 else 4
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(4.4 * ncols, 4.0 * nrows))
    axes = np.atleast_2d(axes)
    for ax in axes.ravel():
        ax.set_visible(False)
    for i, (name, payload) in enumerate(panels):
        ax = axes.ravel()[i]
        ax.set_visible(True)
        if payload is None:
            ax.contourf(xg, yg, z_true, cmap=cm.viridis)
        elif payload[0] == "field":
            ax.contourf(xg, yg, payload[1], cmap=cm.viridis)
        else:
            s = np.asarray(payload[1])
            if mode == "hist":
                ax.hist2d(s[:, 0], s[:, 1], bins=bins, range=[[-lim, lim], [-lim, lim]],
                          cmap=cm.viridis)
            else:
                ax.contourf(xg, yg, _kde2d(s, xg, yg), levels=7, cmap=cm.viridis)
        ax.set_title(name, fontsize=14)
    fig.savefig(path, dpi=300)
    plt.close(fig)


def w2_curves(curves: Dict[str, tuple], path: str):
    """W2-vs-sample-count plot (reference lmc.py:429-444)."""
    plt, _ = _plt()
    fig = plt.figure(figsize=(6, 4))
    for name, (ks, vals) in curves.items():
        plt.plot(np.asarray(ks), np.asarray(vals), label=name)
    plt.xlabel("sample")
    plt.ylabel("2-Wasserstein distance")
    plt.legend()
    fig.savefig(path, dpi=300)
    plt.close(fig)


def image_grid(images: Dict[str, np.ndarray], path: str, ncols: int = 4):
    """Grayscale image panel grid (reference prox_lmc_deconv.py:301-399)."""
    plt, _ = _plt()
    n = len(images)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(3.2 * ncols, 3.2 * nrows))
    axes = np.atleast_1d(axes).ravel()
    for ax in axes:
        ax.set_visible(False)
    for ax, (name, img) in zip(axes, images.items()):
        ax.set_visible(True)
        ax.imshow(np.asarray(img), cmap="gray")
        ax.set_title(name, fontsize=11)
        ax.set_xticks([])
        ax.set_yticks([])
    fig.savefig(path, dpi=250)
    plt.close(fig)


def metric_evolution(series: Dict[str, Dict[str, np.ndarray]], path: str):
    """Per-model metric evolution (reference prox_lmc_deconv.py:799-853):
    one subplot per metric, one line per model."""
    plt, _ = _plt()
    metrics = sorted({m for d in series.values() for m in d})
    fig, axes = plt.subplots(1, len(metrics), figsize=(4.5 * len(metrics), 3.6))
    axes = np.atleast_1d(axes)
    for ax, metric in zip(axes, metrics):
        for model, d in series.items():
            if metric in d:
                ax.plot(np.asarray(d[metric]), label=model, linewidth=1)
        ax.set_title(metric)
        ax.set_xlabel("iteration")
    axes[0].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=250)
    plt.close(fig)
