"""Functionals of the main path (counterpart of
``lmc_atomi_tpu/ops/functionals.py``): the data term ``L2Data`` and the
isotropic TV prior ``TVNorm``, with the ``__call__``/``grad``/``prox``
protocol of pyproximal."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from lmc_atomi_torch.ops import tv as tv_ops

__all__ = ["L2Data", "TVNorm"]


@dataclass
class L2Data:
    """``f(x) = sigma/2 ||Op x - b||^2``. ``prox`` is the exact
    ``(I + tau sigma Op^T Op)^{-1}(x + tau sigma Op^T b)``.

    Build with :meth:`create` over a circulant operator to cache the
    half-plane spectrum ``conj(E) rfft2(b)``, so that ``grad`` costs one
    ``rfft2`` and one ``irfft2``.
    """

    op: Any
    b: torch.Tensor
    sigma: float = 1.0
    b_spec: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, op, b, sigma: float = 1.0) -> "L2Data":
        b_spec = None
        if hasattr(op, "_half") and not b.is_complex():
            b_spec = op._half().conj() * torch.fft.rfft2(b)
        return cls(op=op, b=b, sigma=sigma, b_spec=b_spec)

    def __call__(self, x):
        return 0.5 * self.sigma * torch.sum(torch.square(self.op.matvec(x) - self.b))

    def grad(self, x):
        if self.b_spec is not None and not x.is_complex():
            e = self.op._half()
            e2 = e.real * e.real + e.imag * e.imag
            spec = e2 * torch.fft.rfft2(x) - self.b_spec
            return self.sigma * torch.fft.irfft2(spec, s=x.shape)
        return self.sigma * self.op.normal_grad(x, self.b)

    def prox(self, x, tau):
        y = x + tau * self.sigma * self.op.rmatvec(self.b)
        return self.op.gram_solve(tau * self.sigma, y)


@dataclass
class TVNorm:
    """``g(x) = sigma TV_iso(x)`` with the Chambolle prox, fixed trip count."""

    sigma: float = 1.0
    niter: int = 10

    def __call__(self, x):
        return self.sigma * tv_ops.tv_iso(x)

    def prox(self, x, tau):
        return tv_ops.prox_tv_iso(x, tau * self.sigma, self.niter)
