"""Multivariate Laplace distribution (counterpart of
``lmc_atomi_tpu/models/mvlaplace.py``; reference multivariate_laplace.py).

An elliptically coloured product Laplace:

  * ``logpdf(x) = -(d log 2 + 1/2 logdet(cov) + ||(x - mu) U||_1)`` with
    ``U U^T = cov^{-1}`` the eigen square root of the precision;
  * ``rvs``: iid standard Laplace draws coloured by ``sqrt(s) v`` from the
    SVD of cov, shifted by the mean (the reference's colouring);
  * ``entropy = 1/2 logdet(2 pi e cov)`` (the reference's convention);
  * ``cdf`` on the summed whitened deviation in the standard orientation
    ``F(s) = e^s / 2 (s < 0), 1 - e^{-s} / 2 (s >= 0)`` (the reference's
    branches return ``1 - F``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from lmc_atomi_torch.models.laplace_mixture import laplace_draws

__all__ = ["MultivariateLaplace"]


@dataclass
class MultivariateLaplace:
    mean: torch.Tensor  # (d,)
    cov: torch.Tensor  # (d, d)
    prec_u: torch.Tensor  # (d, d), prec = U U^T
    log_det_cov: torch.Tensor
    color: torch.Tensor  # (d, d), rvs colouring sqrt(s)[:, None] * v

    @classmethod
    def create(cls, mean, cov, dtype=None, device=None) -> "MultivariateLaplace":
        mean = torch.atleast_1d(torch.as_tensor(mean, dtype=dtype, device=device))
        if not mean.is_floating_point():
            mean = mean.to(torch.get_default_dtype())
        d = mean.shape[0]
        cov = torch.as_tensor(cov, dtype=mean.dtype, device=mean.device)
        if cov.ndim == 0:
            cov = cov * torch.eye(d, dtype=mean.dtype, device=mean.device)
        s, u = torch.linalg.eigh(cov)
        s = torch.clamp(s, min=1e-30)
        _, svd_s, svd_vt = torch.linalg.svd(cov)
        return cls(mean=mean, cov=cov, prec_u=u * (1.0 / torch.sqrt(s)),
                   log_det_cov=torch.log(s).sum(),
                   color=torch.sqrt(svd_s)[:, None] * svd_vt)

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    def logpdf(self, x):
        maha = torch.abs((x - self.mean) @ self.prec_u).sum(-1)
        return -(self.dim * math.log(2.0) + 0.5 * self.log_det_cov + maha)

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def cdf(self, x):
        s = ((x - self.mean) @ self.prec_u).sum(-1)
        return torch.where(s < 0, 0.5 * torch.exp(s), 1.0 - 0.5 * torch.exp(-s))

    def logcdf(self, x):
        return torch.log(self.cdf(x))

    def rvs(self, generator: torch.Generator, size: int = 1):
        z = laplace_draws(generator, (size, self.dim), self.mean.dtype, self.mean.device)
        return z @ self.color + self.mean

    def entropy(self):
        return 0.5 * (self.dim * math.log(2 * math.pi * math.e) + self.log_det_cov)
