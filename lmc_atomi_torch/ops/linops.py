"""Linear operators (counterpart of ``lmc_atomi_tpu/ops/linops.py``): the
``LinOp`` base (the normal operator, a conjugate-gradient gram solve and a
power-method bound), the blur kernels, the FFT-diagonal ``CirculantBlur2D``,
the zero-padded ``Convolve2D``, the forward-difference ``Gradient2D`` of the
primal-dual samplers, the inpainting ``Mask``, the ``Identity`` of the
denoising workload, ``Diagonal`` and the dense ``Matrix``, the fixed-trip
``cg_gram_solve`` and the adjoint check ``dot_test``.

``CirculantBlur2D`` also takes an image split over ranks (a DTensor of
``parallel.shard_image``): its four spectral products then run on the
transposed FFT of ``ops/sharded.py`` and return the same placements.

Spectra are complex tensors. The JAX package stores them as real/imag float
pairs only because its TPU runtime rejected complex arrays at the transfer
boundary; PyTorch has no such limit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lmc_atomi_torch.ops.tv import _fwd_diff, _fwd_diff_adjoint_neg
from lmc_atomi_torch.ops.sharded import is_sharded, spectral_map

__all__ = [
    "LinOp", "Identity", "Diagonal", "Matrix", "CirculantBlur2D", "Convolve2D",
    "Gradient2D", "Mask", "uniform_kernel", "gaussian_kernel", "cg_gram_solve",
    "dot_test",
]


def _vdot(a, b):
    """``Re <a, b>`` over all elements (``jnp.vdot(...).real``)."""
    return torch.vdot(a.reshape(-1), b.reshape(-1)).real


class LinOp:
    """Base of the operators: ``matvec`` and ``rmatvec`` are the operator
    and its adjoint; the rest follows from them."""

    def matvec(self, x):
        raise NotImplementedError

    def rmatvec(self, y):
        raise NotImplementedError

    def gram_matvec(self, x):
        return self.rmatvec(self.matvec(x))

    def gram_solve(self, rho, y, niter: int = 50):
        """``(I + rho A^T A)^{-1} y`` by ``niter`` conjugate-gradient trips;
        operators with an exact solve override it."""
        return cg_gram_solve(self, rho, y, niter=niter)

    def max_gram_eig(self, probe=None, iters: int = 50):
        """Power-method estimate of ``lambda_max(A^T A)`` from ``probe``
        (required: the input shape is the operator's own), ``iters``
        normalised gram products, then the Rayleigh quotient. Operators with
        a closed form override it; ``LinOp.max_gram_eig(op, probe=...)``
        runs the power method on any of them."""
        if probe is None:
            raise ValueError("max_gram_eig needs a probe array of the operator's input "
                             "shape for the power method")
        x = probe / torch.linalg.norm(probe.reshape(-1))
        for _ in range(iters):
            x = self.gram_matvec(x)
            x = x / torch.linalg.norm(x.reshape(-1))
        return _vdot(x, self.gram_matvec(x))


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
class CirculantBlur2D(LinOp):
    """Periodic 2-D convolution, diagonalized by the 2-D DFT:
    ``A x = real(ifft2(fft2(x) * eigs))``, adjoint by the conjugate spectrum,
    and an exact ``(I + rho A^T A)^{-1}`` as a spectral divide.

    ``hh`` (the autocorrelation of a PSF up to 13x13) is the ``A^T A``
    stencil that the fused block kernel factors into separable taps.

    ``prefer_stencil`` (off by default) computes ``matvec``, ``rmatvec`` and
    ``gram_matvec`` of a real image as wrap-padded convolutions with ``h``,
    its flip and ``hh`` in place of the FFTs, as the JAX operator's opt-in
    small-PSF path does; an image split over ranks keeps the spectral path.
    """

    eigs: torch.Tensor  # complex (ny, nx)
    h: Optional[torch.Tensor] = None
    hh: Optional[torch.Tensor] = None
    offset: Tuple[int, int] = (0, 0)
    prefer_stencil: bool = False

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

    def _stencil(self, x, kernel) -> bool:
        return (self.prefer_stencil and kernel is not None and not x.is_complex()
                and not is_sharded(x))

    @staticmethod
    def _wrap_conv(x, kernel, oy: int, ox: int):
        """Periodic convolution ``y[i, j] = sum_ab kernel[a, b] x[(i - a + oy)
        mod ny, (j - b + ox) mod nx]`` of the last two axes, in IEEE float32
        on the card (cuDNN's TF32 off, as the JAX path's highest precision)."""
        kh, kw = kernel.shape
        xb = x.reshape((-1, 1) + tuple(x.shape[-2:]))
        xp = F.pad(xb, (kw - 1 - ox, ox, kh - 1 - oy, oy), mode="circular")
        c = torch.backends.cudnn
        with c.flags(enabled=c.enabled, benchmark=c.benchmark, deterministic=c.deterministic,
                     allow_tf32=False):
            out = F.conv2d(xp, kernel.flip(0, 1)[None, None].to(x.dtype))
        return out.reshape(x.shape)

    def matvec(self, x):
        if is_sharded(x):
            return spectral_map(lambda cols, s: s * self._half()[:, cols], x)
        if self._stencil(x, self.h):
            return self._wrap_conv(x, self.h, *self.offset)
        return torch.fft.ifft2(torch.fft.fft2(x) * self.eigs).real

    def rmatvec(self, y):
        if is_sharded(y):
            return spectral_map(lambda cols, s: s * self._half()[:, cols].conj(), y)
        if self._stencil(y, self.h):
            kh, kw = self.h.shape
            oy, ox = self.offset
            return self._wrap_conv(y, self.h.flip(0, 1), kh - 1 - oy, kw - 1 - ox)
        return torch.fft.ifft2(torch.fft.fft2(y) * self.eigs.conj()).real

    def gram_matvec(self, x):
        """``A^T A x``: one (2k-1) x (2k-1) wrap stencil with
        ``prefer_stencil``, else two spectral products."""
        if self._stencil(x, self.hh):
            return self._wrap_conv(x, self.hh, self.hh.shape[0] // 2, self.hh.shape[1] // 2)
        return self.rmatvec(self.matvec(x))

    def gram_solve(self, rho, y, niter: int = 0):
        """``(I + rho A^T A)^{-1} y``; ``niter`` is unused (exact solve)."""
        e = self._half()
        denom = 1.0 + rho * (e.real * e.real + e.imag * e.imag)
        if is_sharded(y):
            return spectral_map(lambda cols, s: s / denom[:, cols], y)
        return torch.fft.irfft2(torch.fft.rfft2(y) / denom, s=y.shape[-2:])

    def normal_grad(self, x, b):
        """``A^T(A x - b)`` in one spectral round trip on the half plane:
        ``irfft2(|E|^2 rfft2(x) - conj(E) rfft2(b))``."""
        e = self._half()
        e2 = e.real * e.real + e.imag * e.imag
        if is_sharded(x):
            return spectral_map(lambda cols, sx, sb: e2[:, cols] * sx - e[:, cols].conj() * sb,
                                x, b)
        spec = e2 * torch.fft.rfft2(x) - e.conj() * torch.fft.rfft2(b)
        return torch.fft.irfft2(spec, s=x.shape[-2:])

    def max_gram_eig(self, probe=None, iters: int = 0):
        return torch.max(self.eigs.real ** 2 + self.eigs.imag ** 2)


def _conv_same(x, kernel, pad):
    """``y[i, j] = sum_ab kernel[a, b] x[i - a + oy, j - b + ox]`` over the
    image ``x`` padded with zeros by ``pad`` = (top, bottom, left, right)."""
    top, bottom, left, right = pad
    xp = F.pad(x[None, None], (left, right, top, bottom))
    return F.conv2d(xp, kernel.flip(0, 1)[None, None].to(x.dtype))[0, 0]


@dataclass
class Convolve2D(LinOp):
    """Zero-padded linear 2-D convolution with a 'same' output, the pylops
    ``Convolve2D`` of the reference (prox_lmc_deconv.py:58-69): taps outside
    the image read zeros, the kernel tap at ``offset`` is the origin. The
    adjoint is the correlation with the flipped kernel; the gram solve is
    ``LinOp``'s conjugate gradient."""

    h: torch.Tensor
    offset: Tuple[int, int] = (0, 0)

    @classmethod
    def from_kernel(cls, h, offset=None) -> "Convolve2D":
        h = torch.as_tensor(h)
        if offset is None:
            offset = (h.shape[0] // 2, h.shape[1] // 2)
        return cls(h=h, offset=tuple(int(o) for o in offset))

    def matvec(self, x):
        kh, kw = self.h.shape
        oy, ox = self.offset
        return _conv_same(x, self.h, (kh - 1 - oy, oy, kw - 1 - ox, ox))

    def rmatvec(self, y):
        kh, kw = self.h.shape
        oy, ox = self.offset
        # the adjoint's origin mirrors within the kernel's support
        return Convolve2D(h=self.h.flip(0, 1), offset=(kh - 1 - oy, kw - 1 - ox)).matvec(y)


@dataclass(frozen=True)
class Gradient2D(LinOp):
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
class Identity(LinOp):
    """The identity operator (the denoising workload's forward model)."""

    def matvec(self, x):
        return x

    def rmatvec(self, y):
        return y

    def gram_solve(self, rho, y, niter: int = 0):
        return y / (1.0 + rho)


@dataclass
class Diagonal(LinOp):
    """Elementwise product with ``diag`` (real or complex)."""

    diag: torch.Tensor

    def matvec(self, x):
        return self.diag * x

    def rmatvec(self, y):
        return self.diag.conj() * y

    def gram_solve(self, rho, y, niter: int = 0):
        return y / (1.0 + rho * torch.abs(self.diag) ** 2)


@dataclass
class Matrix(LinOp):
    """A dense matrix on vectors (or on the columns of a matrix); the gram
    solve is a Cholesky factorisation of ``I + rho A^H A``."""

    a: torch.Tensor

    def matvec(self, x):
        return self.a @ x

    def rmatvec(self, y):
        return self.a.mH @ y

    def gram_solve(self, rho, y, niter: int = 0):
        n = self.a.shape[1]
        m = torch.eye(n, dtype=self.a.dtype, device=self.a.device) + rho * (self.a.mH @ self.a)
        rhs = y[:, None] if y.ndim == 1 else y
        out = torch.cholesky_solve(rhs, torch.linalg.cholesky(m))
        return out[:, 0] if y.ndim == 1 else out


@dataclass
class Mask(LinOp):
    """Sampling/inpainting mask: elementwise product with a 0/1 tensor."""

    mask: torch.Tensor

    def matvec(self, x):
        return self.mask * x

    def rmatvec(self, y):
        return self.mask * y

    def gram_solve(self, rho, y, niter: int = 0):
        """``(I + rho M^T M)^{-1} y`` for the binary mask ``M``."""
        return y / (1.0 + rho * self.mask)


def cg_gram_solve(op: LinOp, rho, b, x0=None, niter: int = 50):
    """Conjugate gradient for ``(I + rho A^T A) x = b`` with a fixed trip
    count and no early exit (the step and the direction update divide by
    their denominators clamped at 1e-30)."""

    def mv(x):
        return x + rho * op.gram_matvec(x)

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - mv(x)
    p = r
    rs = _vdot(r, r)
    for _ in range(niter):
        ap = mv(p)
        alpha = rs / torch.clamp(_vdot(p, ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _vdot(r, r)
        p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
        rs = rs_new
    return x


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
