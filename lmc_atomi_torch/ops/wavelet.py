"""Orthogonal 2-D multi-level wavelet operators (counterpart of
``lmc_atomi_tpu/ops/wavelet.py``): the sparsifying operators of the
wavelet-l1 inpainting workload.

Periodic boundary and orthonormal filters, so ``rmatvec`` is the exact
inverse (``A^T A = I``). Coefficients sit in the standard pyramid (Mallat)
layout, the approximation in the top-left corner. ``HaarDWT2D`` is the
split/average case; ``DaubechiesDWT2D`` runs the longer D4/D8 filter banks
as rolled periodic convolutions. The filter constants are copied from the
JAX package (importing it would load JAX).

A level is applied only while the current sub-image has even sides (and,
for Daubechies, sides of at least ``taps``): the forward transform stops at
the first level that fails, the inverse skips the levels that fail.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

__all__ = ["HaarDWT2D", "DaubechiesDWT2D", "daubechies_filter", "make_dwt"]

_SQRT2 = 2.0**0.5

# Orthonormal Daubechies low-pass filters (sum h = sqrt(2), sum h^2 = 1).
_D4 = (
    0.48296291314469025,
    0.836516303737469,
    0.22414386804185735,
    -0.12940952255092145,
)
_D8 = (
    0.23037781330885523,
    0.7148465705525415,
    0.6308807679295904,
    -0.02798376941698385,
    -0.18703481171888114,
    0.030841381835986965,
    0.032883011666982945,
    -0.010597401784997278,
)


def daubechies_filter(taps: int) -> Tuple[float, ...]:
    """Orthonormal Daubechies low-pass filter with ``taps`` coefficients
    (2 = Haar, 4 = D4/db2, 8 = D8/db4)."""
    if taps == 2:
        return (1.0 / _SQRT2, 1.0 / _SQRT2)
    if taps == 4:
        return _D4
    if taps == 8:
        return _D8
    raise ValueError(f"no built-in Daubechies filter with {taps} taps")


def daubechies_filters(taps: int):
    """``(h, g)``: the low-pass filter and its quadrature mirror
    ``g[i] = (-1)^i h[T - 1 - i]``."""
    h = daubechies_filter(taps)
    g = tuple((-1.0) ** i * h[len(h) - 1 - i] for i in range(len(h)))
    return h, g


def _fwd_1level(x):
    a = (x[0::2] + x[1::2]) / _SQRT2  # rows
    d = (x[0::2] - x[1::2]) / _SQRT2
    xa = torch.cat([a, d], dim=0)
    a2 = (xa[:, 0::2] + xa[:, 1::2]) / _SQRT2  # columns
    d2 = (xa[:, 0::2] - xa[:, 1::2]) / _SQRT2
    return torch.cat([a2, d2], dim=1)


def _inv_1level(c):
    ny, nx = c.shape
    a2, d2 = c[:, : nx // 2], c[:, nx // 2:]
    xa = torch.empty_like(c)
    xa[:, 0::2] = (a2 + d2) / _SQRT2
    xa[:, 1::2] = (a2 - d2) / _SQRT2
    a, d = xa[: ny // 2], xa[ny // 2:]
    x = torch.empty_like(c)
    x[0::2] = (a + d) / _SQRT2
    x[1::2] = (a - d) / _SQRT2
    return x


@dataclass(frozen=True)
class HaarDWT2D:
    """Multi-level orthogonal 2-D Haar DWT (Mallat layout)."""

    levels: int = 3

    def matvec(self, x):
        ny, nx = x.shape
        for lv in range(self.levels):
            sy, sx = ny >> lv, nx >> lv
            if sy % 2 or sx % 2:
                break
            x = x.clone()
            x[:sy, :sx] = _fwd_1level(x[:sy, :sx])
        return x

    def rmatvec(self, c):
        ny, nx = c.shape
        for lv in reversed(range(self.levels)):
            sy, sx = ny >> lv, nx >> lv
            if sy % 2 or sx % 2:
                continue
            c = c.clone()
            c[:sy, :sx] = _inv_1level(c[:sy, :sx])
        return c

    def gram_solve(self, rho, y, niter: int = 0):
        return y / (1.0 + rho)  # orthogonal: A^T A = I

    def max_gram_eig(self, probe=None, iters: int = 0):
        return torch.tensor(1.0)


def _dwt_step_axis(x, h, g, axis):
    """One periodic analysis step along ``axis``:
    ``a[k] = sum_i h[i] x[(2k + i) mod n]``, ``d`` likewise with ``g``."""
    a = d = None
    for i, (hi, gi) in enumerate(zip(h, g)):
        xs = torch.roll(x, -i, axis) if i else x
        ev = xs[0::2] if axis == 0 else xs[:, 0::2]
        a = hi * ev if a is None else a + hi * ev
        d = gi * ev if d is None else d + gi * ev
    return torch.cat([a, d], dim=axis)


def _idwt_step_axis(c, h, g, axis):
    """Transpose (the inverse: orthogonal) of ``_dwt_step_axis``."""
    half = c.shape[axis] // 2
    a, d = (c[:half], c[half:]) if axis == 0 else (c[:, :half], c[:, half:])
    up_a = torch.zeros_like(c)
    up_d = torch.zeros_like(c)
    if axis == 0:
        up_a[0::2] = a
        up_d[0::2] = d
    else:
        up_a[:, 0::2] = a
        up_d[:, 0::2] = d
    x = None
    for i, (hi, gi) in enumerate(zip(h, g)):
        term = hi * (torch.roll(up_a, i, axis) if i else up_a) + gi * (
            torch.roll(up_d, i, axis) if i else up_d)
        x = term if x is None else x + term
    return x


@dataclass(frozen=True)
class DaubechiesDWT2D:
    """Multi-level orthogonal 2-D Daubechies DWT, periodic boundary
    (``taps=4``: D4 annihilates linear trends in the detail bands,
    ``taps=8``: D8 cubic ones)."""

    taps: int = 4
    levels: int = 3

    def matvec(self, x):
        h, g = daubechies_filters(self.taps)
        ny, nx = x.shape
        for lv in range(self.levels):
            sy, sx = ny >> lv, nx >> lv
            if sy % 2 or sx % 2 or sy < len(h) or sx < len(h):
                break
            sub = _dwt_step_axis(x[:sy, :sx], h, g, 0)
            sub = _dwt_step_axis(sub, h, g, 1)
            x = x.clone()
            x[:sy, :sx] = sub
        return x

    def rmatvec(self, c):
        h, g = daubechies_filters(self.taps)
        ny, nx = c.shape
        for lv in reversed(range(self.levels)):
            sy, sx = ny >> lv, nx >> lv
            if sy % 2 or sx % 2 or sy < len(h) or sx < len(h):
                continue
            sub = _idwt_step_axis(c[:sy, :sx], h, g, 1)
            sub = _idwt_step_axis(sub, h, g, 0)
            c = c.clone()
            c[:sy, :sx] = sub
        return c

    def gram_solve(self, rho, y, niter: int = 0):
        return y / (1.0 + rho)  # orthogonal: A^T A = I

    def max_gram_eig(self, probe=None, iters: int = 0):
        return torch.tensor(1.0)


def make_dwt(name: str, levels: int = 3):
    """Named DWT: ``'haar'``, ``'d4'`` (``'db2'``) or ``'d8'`` (``'db4'``)."""
    if name == "haar":
        return HaarDWT2D(levels=levels)
    if name in ("d4", "db2"):
        return DaubechiesDWT2D(taps=4, levels=levels)
    if name in ("d8", "db4"):
        return DaubechiesDWT2D(taps=8, levels=levels)
    raise ValueError(f"unknown wavelet {name!r}")
