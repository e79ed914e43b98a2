"""Deterministic synthetic test images. ``phantom`` is copied verbatim from
``lmc_atomi_tpu/utils/images.py``: importing that package would load JAX.

The reference loads skimage's ``camera``/``ascent`` or a bundled
``einstein.png`` (reference prox_lmc_deconv.py:44-50). The deconvolution
workloads use a deterministic piecewise-smooth phantom with sharp edges, texture, and a smooth ramp — the right
structure for TV-regularized deblurring benchmarks. Values in [0, 255] like
the 8-bit reference images.
"""
from __future__ import annotations

import numpy as np

__all__ = ["phantom", "load_image"]


def phantom(n: int = 512, dtype=np.float32) -> np.ndarray:
    """Piecewise-smooth n x n phantom in [0, 255]."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64) / n

    img = 40.0 + 60.0 * xx  # smooth ramp background

    # large disk
    img = np.where((yy - 0.42) ** 2 + (xx - 0.38) ** 2 < 0.06, 210.0, img)
    # inner dark disk (nested contrast)
    img = np.where((yy - 0.42) ** 2 + (xx - 0.38) ** 2 < 0.012, 70.0, img)
    # rectangle block
    img = np.where(
        (yy > 0.62) & (yy < 0.88) & (xx > 0.55) & (xx < 0.92), 160.0, img
    )
    # thin bright bars (resolution test)
    for i, w in enumerate((0.012, 0.008, 0.005)):
        x0 = 0.08 + 0.07 * i
        img = np.where(
            (xx > x0) & (xx < x0 + w) & (yy > 0.65) & (yy < 0.95), 240.0, img
        )
    # diagonal edge
    img = np.where((yy + xx < 0.5) & (yy > 0.05) & (xx > 0.05), 120.0, img)
    # sinusoidal texture patch
    tex = 20.0 * np.sin(40 * np.pi * xx) * np.sin(40 * np.pi * yy)
    mask = (yy > 0.12) & (yy < 0.32) & (xx > 0.6) & (xx < 0.9)
    img = np.where(mask, 140.0 + tex, img)

    return img.astype(dtype)


# the JAX package's other named images; they need utils/png.py, not ported yet
_NOT_PORTED = ("einstein", "hopper", "mri", "terrain")


def load_image(name: str, n: int = 512, dtype=np.float32) -> np.ndarray:
    """Named test image. Only ``'phantom'`` is ported: the photographs and
    ``'terrain'`` wait for the port of ``utils/png.py``."""
    if name == "phantom":
        return phantom(n, dtype)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"test image {name!r} is not ported yet (needs utils/png.py); "
            "use 'phantom'")
    raise ValueError(f"unknown test image {name!r}")
