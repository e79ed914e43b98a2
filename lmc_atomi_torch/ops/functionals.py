"""Functionals (counterpart of ``lmc_atomi_tpu/ops/functionals.py``): the
data term ``L2Data``, the isotropic TV prior ``TVNorm``, the primal-dual
regularizers ``L1Norm``/``L21Norm``, the wavelet-l1 prior ``OrthogonalL1``
and the 1-D TV of the flattened image ``TV1DNorm``, with the
``__call__``/``grad``/``prox``/``proxdual`` protocol of pyproximal."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from lmc_atomi_torch.ops import tv as tv_ops
from lmc_atomi_torch.ops.prox import prox_laplace
from lmc_atomi_torch.ops.sharded import is_sharded, spectral_map

__all__ = ["L2Data", "L1Norm", "L21Norm", "TVNorm", "TV1DNorm", "OrthogonalL1"]


@dataclass
class L2Data:
    """``f(x) = sigma/2 ||Op x - b||^2``. ``prox`` is the exact
    ``(I + tau sigma Op^T Op)^{-1}(x + tau sigma Op^T b)``.

    Build with :meth:`create` over a circulant operator to cache the
    half-plane spectrum ``conj(E) rfft2(b)``, so that ``grad`` costs one
    ``rfft2`` and one ``irfft2``. ``niter_solve`` is the trip count of the
    conjugate-gradient solve of operators without an exact one
    (``LinOp.gram_solve``).

    On an image split over ranks (a DTensor of ``parallel.shard_image``)
    ``grad`` and ``prox`` take the operator's transposed FFT with each
    rank's columns of the cached ``b_spec``; ``b`` stays whole. That needs
    the cache: a data term built without it raises there.

    Over a ``CirculantBlur2D`` with ``prefer_stencil`` and a small PSF,
    :meth:`create` also caches ``atb = A^T b``, and ``grad`` of a whole real
    image is ``sigma (A^T A x - atb)`` by the operator's gram stencil.
    """

    op: Any
    b: torch.Tensor
    sigma: float = 1.0
    niter_solve: int = 50
    b_spec: Optional[torch.Tensor] = None
    atb: Optional[torch.Tensor] = None  # cached A^T b (the stencil-gram path)

    @classmethod
    def create(cls, op, b, sigma: float = 1.0,
               niter_solve: int = 50) -> "L2Data":
        b_spec = atb = None
        if hasattr(op, "_half") and not b.is_complex():
            b_spec = op._half().conj() * torch.fft.rfft2(b)
            if getattr(op, "prefer_stencil", False) and op.hh is not None:
                atb = op.rmatvec(b)
        return cls(op=op, b=b, sigma=sigma, niter_solve=niter_solve,
                   b_spec=b_spec, atb=atb)

    def __call__(self, x):
        return 0.5 * self.sigma * torch.sum(torch.square(self.op.matvec(x) - self.b))

    def _sharded_spec(self):
        if self.b_spec is None:
            raise ValueError("a sharded image needs L2Data.create over a circulant "
                             "operator (the cached b_spec)")
        return self.op._half(), self.b_spec

    def grad(self, x):
        if is_sharded(x):
            e, b_spec = self._sharded_spec()
            e2 = e.real * e.real + e.imag * e.imag
            return self.sigma * spectral_map(
                lambda cols, s: e2[:, cols] * s - b_spec[:, cols], x)
        if self.atb is not None and not x.is_complex():
            return self.sigma * (self.op.gram_matvec(x) - self.atb)
        if self.b_spec is not None and not x.is_complex():
            e = self.op._half()
            e2 = e.real * e.real + e.imag * e.imag
            spec = e2 * torch.fft.rfft2(x) - self.b_spec
            return self.sigma * torch.fft.irfft2(spec, s=x.shape[-2:])
        if hasattr(self.op, "normal_grad"):
            return self.sigma * self.op.normal_grad(x, self.b)
        # operators without a spectrum (Mask, Identity, wavelets, Radon)
        return self.sigma * self.op.rmatvec(self.op.matvec(x) - self.b)

    def prox(self, x, tau):
        if is_sharded(x):
            # (I + ts A^T A)^{-1} (x + ts A^T b), A^T b's spectrum the cached b_spec
            e, b_spec = self._sharded_spec()
            ts = tau * self.sigma
            denom = 1.0 + ts * (e.real * e.real + e.imag * e.imag)
            return spectral_map(lambda cols, s: (s + ts * b_spec[:, cols]) / denom[:, cols], x)
        y = x + tau * self.sigma * self.op.rmatvec(self.b)
        return self.op.gram_solve(tau * self.sigma, y, niter=self.niter_solve)


@dataclass
class L1Norm:
    """``g(z) = sigma ||z||_1``: the anisotropic TV regularizer when composed
    with a gradient operator."""

    sigma: float = 1.0

    def __call__(self, z):
        return self.sigma * torch.sum(torch.abs(z))

    def prox(self, z, tau):
        return prox_laplace(z, tau * self.sigma)

    def proxdual(self, z, mu):
        """Projection onto the l-inf ball of radius sigma (independent of mu)."""
        return torch.clamp(z, -self.sigma, self.sigma)


@dataclass
class L21Norm:
    """``g(z) = sigma sum_i ||z_i||_2`` over the leading axis: the isotropic
    TV regularizer of the primal-dual samplers, ``z`` of shape
    ``(ndim, ...)``."""

    sigma: float = 1.0

    def __call__(self, z):
        return self.sigma * torch.sum(torch.sqrt(torch.sum(z * z, dim=0)))

    def prox(self, z, tau):
        nrm = torch.sqrt(torch.sum(z * z, dim=0, keepdim=True))
        return z * torch.clamp(
            1.0 - tau * self.sigma / torch.clamp(nrm, min=1e-30), min=0.0)

    def proxdual(self, z, mu):
        """Per-group projection onto the l2 ball of radius sigma."""
        nrm = torch.sqrt(torch.sum(z * z, dim=0, keepdim=True))
        return z * torch.clamp(self.sigma / torch.clamp(nrm, min=1e-30), max=1.0)


@dataclass
class TVNorm:
    """``g(x) = sigma TV_iso(x)`` with the Chambolle prox, fixed trip count."""

    sigma: float = 1.0
    niter: int = 10

    def __call__(self, x):
        return self.sigma * tv_ops.tv_iso(x)

    def prox(self, x, tau):
        return tv_ops.prox_tv_iso(x, tau * self.sigma, self.niter)


@dataclass
class OrthogonalL1:
    """``g(x) = sigma ||W x||_1`` for an orthogonal analysis operator ``W``
    (a wavelet of ``ops/wavelet.py``): the prox is exactly
    ``W^T soft(W x, tau sigma)``. The wavelet-l1 prior of the inpainting
    workload."""

    op: Any  # orthogonal operator (rmatvec is the inverse)
    sigma: float = 1.0

    def __call__(self, x):
        return self.sigma * torch.sum(torch.abs(self.op.matvec(x)))

    def prox(self, x, tau):
        c = self.op.matvec(x)
        return self.op.rmatvec(prox_laplace(c, tau * self.sigma))

    def moreau_grad(self, x, lam):
        """Gradient of the ``lam``-Moreau envelope: ``(x - prox_lam(x)) / lam``."""
        return (x - self.prox(x, lam)) / lam

    def moreau_value(self, x, lam):
        """Value of the ``lam``-Moreau envelope, in coefficient space (``W``
        orthogonal): ``sigma ||p||_1 + ||p - c||^2 / (2 lam)`` with
        ``c = W x`` and ``p = soft(c, lam sigma)``."""
        c = self.op.matvec(x)
        p = prox_laplace(c, lam * self.sigma)
        return self.sigma * torch.sum(torch.abs(p)) + torch.sum(
            torch.square(p - c)) / (2.0 * lam)


@dataclass
class TV1DNorm:
    """``g(x) = sigma TV_1d(flatten(x))`` (reference algs.py:169-170), the
    prox by ``niter`` dual-projection trips of ``prox_tv1d``."""

    sigma: float = 1.0
    niter: int = 10

    def __call__(self, x):
        return self.sigma * tv_ops.tv1d(x.reshape(-1))

    def prox(self, x, tau):
        return tv_ops.prox_tv1d(x.reshape(-1), tau * self.sigma, self.niter).reshape(x.shape)
