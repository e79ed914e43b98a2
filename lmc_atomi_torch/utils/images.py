"""Deterministic test images (counterpart of
``lmc_atomi_tpu/utils/images.py``, copied: importing that package would load
JAX). ``phantom`` is a piecewise-smooth synthetic; ``einstein``, ``hopper``
and ``mri`` are the photographs in ``assets/``, decoded by ``utils/png.py``;
``terrain`` is synthesised with natural 1/f spectral statistics from a fixed
seed. Values in [0, 255] like the 8-bit reference images (reference
prox_lmc_deconv.py:44-50).
"""
from __future__ import annotations

import functools
import os

import numpy as np

from lmc_atomi_torch.utils.png import read_png_gray

__all__ = ["phantom", "einstein", "hopper", "mri", "terrain", "load_image"]

_ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets")


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


@functools.lru_cache(maxsize=None)
def _decoded(name: str) -> np.ndarray:
    """``assets/<name>.png`` in gray levels, decoded once (seconds in numpy)."""
    img = read_png_gray(os.path.join(_ASSETS, f"{name}.png"))
    img.flags.writeable = False
    return img


def _photo(name: str, n: int, dtype) -> np.ndarray:
    """The n x n centre crop of ``assets/<name>.png`` in gray levels; a
    request past the source's size raises (no fabricated detail)."""
    img = _decoded(name)
    h, w = img.shape
    if n > min(h, w):
        raise ValueError(f"{name} source is {h}x{w}; cannot crop to {n}")
    y0, x0 = (h - n) // 2, (w - n) // 2
    return np.ascontiguousarray(img[y0:y0 + n, x0:x0 + n]).astype(dtype)


def einstein(n: int = 512, dtype=np.float32) -> np.ndarray:
    """The reference's natural test photograph (667 x 877 source),
    centre-cropped to n x n."""
    return _photo("einstein", n, dtype)


def hopper(n: int = 512, dtype=np.float32) -> np.ndarray:
    """The public-domain Grace Hopper portrait, a 512 x 512 crop,
    centre-cropped to n x n."""
    return _photo("hopper", n, dtype)


def mri(n: int = 256, dtype=np.float32) -> np.ndarray:
    """A real MR brain slice (matplotlib's BSD-licensed s1045 sample, 256 x
    256 native), centre-cropped to n x n."""
    return _photo("mri", n, dtype)


def terrain(n: int = 512, dtype=np.float32) -> np.ndarray:
    """Natural-statistics textured image in [0, 255] from a fixed seed:
    1/f^1.6 spectral shading, a tanh tone curve and a dark ridge along the
    0.62-quantile level set."""
    rng = np.random.default_rng(20260817)
    # spectral synthesis: white noise shaped by a radial 1/f^beta filter
    white = rng.standard_normal((n, n))
    f = np.fft.fftfreq(n)
    rad = np.sqrt(f[:, None] ** 2 + f[None, :] ** 2)
    rad[0, 0] = 1.0 / n
    spec = np.fft.fft2(white) * rad ** (-1.6)
    spec[0, 0] = 0.0
    base = np.real(np.fft.ifft2(spec))
    base = (base - base.mean()) / (base.std() + 1e-12)
    # mild tone curve + a dark ridge along a level set (adds edges)
    img = 128.0 + 52.0 * np.tanh(0.9 * base)
    ridge = np.abs(base - np.quantile(base, 0.62)) < 0.035
    img = np.where(ridge, 0.35 * img, img)
    return np.clip(img, 0.0, 255.0).astype(dtype)


_IMAGES = {"phantom": phantom, "einstein": einstein, "hopper": hopper, "mri": mri,
           "terrain": terrain}


def load_image(name: str, n: int = 512, dtype=np.float32) -> np.ndarray:
    """Named test image: 'phantom', 'einstein', 'hopper', 'mri' (256^2
    native) or 'terrain'."""
    if name not in _IMAGES:
        raise ValueError(f"unknown test image {name!r}")
    return _IMAGES[name](n, dtype)
