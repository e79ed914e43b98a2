"""Linear operators (counterpart of ``lmc_atomi_tpu/ops/linops.py``): the
blur kernels, the FFT-diagonal ``CirculantBlur2D``, the forward-difference
``Gradient2D`` of the primal-dual samplers, the inpainting ``Mask``, the
``Identity`` of the denoising workload, and the adjoint check ``dot_test``.

Spectra are complex tensors. The JAX package stores them as real/imag float
pairs only because its TPU runtime rejected complex arrays at the transfer
boundary; PyTorch has no such limit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from lmc_atomi_torch.ops.tv import _fwd_diff, _fwd_diff_adjoint_neg

__all__ = [
    "CirculantBlur2D", "Gradient2D", "Identity", "Mask", "uniform_kernel",
    "gaussian_kernel", "dot_test",
]


def uniform_kernel(size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform ``size x size`` blur kernel summing to one."""
    h = torch.ones((size, size), dtype=dtype, device=device)
    return h / h.sum()


def gaussian_kernel(size: int, sigma: float, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    r = torch.arange(size, dtype=dtype, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (r / sigma) ** 2)
    k = torch.outer(g, g)
    return k / k.sum()


@dataclass
class CirculantBlur2D:
    """Periodic 2-D convolution, diagonalized by the 2-D DFT:
    ``A x = real(ifft2(fft2(x) * eigs))``, adjoint by the conjugate spectrum,
    and an exact ``(I + rho A^T A)^{-1}`` as a spectral divide.

    ``hh`` (the autocorrelation of a PSF up to 13x13) is the ``A^T A``
    stencil that the fused block kernel factors into separable taps.
    """

    eigs: torch.Tensor  # complex (ny, nx)
    h: Optional[torch.Tensor] = None
    hh: Optional[torch.Tensor] = None
    offset: Tuple[int, int] = (0, 0)

    _STENCIL_MAX = 13

    @classmethod
    def from_kernel(cls, shape, h, offset=None) -> "CirculantBlur2D":
        """Spectrum (on the host, in numpy) of the PSF ``h`` centred at
        ``offset`` (default: its middle) on a ``shape`` periodic grid."""
        from scipy.signal import correlate2d

        h_t = torch.as_tensor(h)
        h_np = h_t.detach().cpu().numpy()
        if offset is None:
            offset = (h_np.shape[0] // 2, h_np.shape[1] // 2)
        e = np.zeros(tuple(shape), h_np.dtype)
        e[: h_np.shape[0], : h_np.shape[1]] = h_np
        e = np.roll(e, shift=(-offset[0], -offset[1]), axis=(0, 1))
        eigs = torch.from_numpy(np.fft.fft2(e)).to(
            dtype=h_t.dtype.to_complex(), device=h_t.device)
        small = max(h_np.shape) <= cls._STENCIL_MAX
        hh = None
        if small:
            # A^T A is circulant convolution with the autocorrelation of h
            hh = torch.from_numpy(
                correlate2d(h_np, h_np, mode="full").astype(h_np.dtype)
            ).to(h_t.device)
        return cls(
            eigs=eigs,
            h=h_t if small else None,
            hh=hh,
            offset=tuple(int(o) for o in offset),
        )

    def _half(self) -> torch.Tensor:
        """Spectrum restricted to the rfft2 half-plane (real inputs)."""
        return self.eigs[..., : self.eigs.shape[-1] // 2 + 1]

    def matvec(self, x):
        return torch.fft.ifft2(torch.fft.fft2(x) * self.eigs).real

    def rmatvec(self, y):
        return torch.fft.ifft2(torch.fft.fft2(y) * self.eigs.conj()).real

    def gram_matvec(self, x):
        return self.rmatvec(self.matvec(x))

    def gram_solve(self, rho, y, niter: int = 0):
        """``(I + rho A^T A)^{-1} y``; ``niter`` is unused (exact solve)."""
        e = self._half()
        denom = 1.0 + rho * (e.real * e.real + e.imag * e.imag)
        return torch.fft.irfft2(torch.fft.rfft2(y) / denom, s=y.shape[-2:])

    def normal_grad(self, x, b):
        """``A^T(A x - b)`` in one spectral round trip on the half plane:
        ``irfft2(|E|^2 rfft2(x) - conj(E) rfft2(b))``."""
        e = self._half()
        e2 = e.real * e.real + e.imag * e.imag
        spec = e2 * torch.fft.rfft2(x) - e.conj() * torch.fft.rfft2(b)
        return torch.fft.irfft2(spec, s=x.shape[-2:])

    def max_gram_eig(self, probe=None, iters: int = 0):
        return torch.max(self.eigs.real ** 2 + self.eigs.imag ** 2)


@dataclass(frozen=True)
class Gradient2D:
    """Forward-difference gradient with a zeroed last row/column (pylops
    ``Gradient(kind='forward', edge=False)``). Output is stacked
    ``(2, ny, nx)``, d/dy first; the adjoint is the exact negative
    divergence."""

    sampling: float = 1.0

    def matvec(self, x):
        return torch.stack([_fwd_diff(x, 0), _fwd_diff(x, 1)]) / self.sampling

    def rmatvec(self, p):
        return -(_fwd_diff_adjoint_neg(p[0], 0)
                 + _fwd_diff_adjoint_neg(p[1], 1)) / self.sampling

    def max_gram_eig(self, probe=None, iters: int = 0):
        return torch.tensor(8.0 / self.sampling**2)


@dataclass(frozen=True)
class Identity:
    """The identity operator (the denoising workload's forward model)."""

    def matvec(self, x):
        return x

    def rmatvec(self, y):
        return y

    def gram_solve(self, rho, y, niter: int = 0):
        return y / (1.0 + rho)


@dataclass
class Mask:
    """Sampling/inpainting mask: elementwise product with a 0/1 tensor."""

    mask: torch.Tensor

    def matvec(self, x):
        return self.mask * x

    def rmatvec(self, y):
        return self.mask * y

    def gram_solve(self, rho, y, niter: int = 0):
        """``(I + rho M^T M)^{-1} y`` for the binary mask ``M``."""
        return y / (1.0 + rho * self.mask)


def dot_test(op, gen: torch.Generator, x_shape, y_shape=None,
             dtype=torch.float64):
    """``<A x, y>`` and ``<x, A^T y>`` for normal ``x``, ``y`` drawn from
    ``gen`` (on ``gen``'s device); equal up to roundoff for a true adjoint."""
    device = gen.device
    x = torch.randn(tuple(x_shape), generator=gen, dtype=dtype, device=device)
    ax = op.matvec(x)
    y = torch.randn(tuple(ax.shape if y_shape is None else y_shape),
                    generator=gen, dtype=dtype, device=device)
    lhs = torch.sum(ax * y)
    rhs = torch.sum(x * op.rmatvec(y))
    return lhs, rhs
