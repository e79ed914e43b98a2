"""Gaussian-mixture target (counterpart of
``lmc_atomi_tpu/models/gaussian_mixture.py``; reference lmc.py:39-90).

Log space with responsibilities (the softmax of the per-component log
densities), batched over any leading axes. The contractions over the
components and coordinates, ``logsumexp`` and ``softmax`` are
``ops/batched.py``'s, summed in a fixed order, so that a chain's bits do not
depend on how many chains share the call.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from lmc_atomi_torch.ops.batched import fsum, logsumexp, matvec, softmax

__all__ = ["GaussianMixture"]


@dataclass
class GaussianMixture:
    mus: torch.Tensor  # (n, d)
    sigmas: torch.Tensor  # (n, d, d)
    log_weights: torch.Tensor  # (n,)
    precs: torch.Tensor  # (n, d, d) precision matrices
    log_norms: torch.Tensor  # (n,) -log((2 pi)^{d/2} det^{1/2})
    chols: torch.Tensor  # (n, d, d) Cholesky factors of the sigmas (sampling)

    @classmethod
    def create(cls, mus, sigmas, weights, dtype=None, device=None) -> "GaussianMixture":
        mus = torch.as_tensor(mus, dtype=dtype, device=device)
        sigmas = torch.as_tensor(sigmas, dtype=mus.dtype, device=mus.device)
        weights = torch.as_tensor(weights, dtype=mus.dtype, device=mus.device)
        d = mus.shape[-1]
        _, logdet = torch.linalg.slogdet(sigmas)
        return cls(mus=mus, sigmas=sigmas, log_weights=torch.log(weights),
                   precs=torch.linalg.inv(sigmas),
                   log_norms=-0.5 * (d * math.log(2 * math.pi) + logdet),
                   chols=torch.linalg.cholesky(sigmas))

    @property
    def dim(self) -> int:
        return self.mus.shape[-1]

    # -- densities ----------------------------------------------------------

    def component_log_densities(self, theta):
        """(..., n) per-component Gaussian log densities."""
        dev = theta[..., None, :] - self.mus  # (..., n, d)
        maha = fsum(dev * matvec(self.precs, dev), -1)
        return self.log_norms - 0.5 * maha

    def log_density(self, theta):
        return logsumexp(self.component_log_densities(theta) + self.log_weights)

    def density(self, theta):
        return torch.exp(self.log_density(theta))

    def potential(self, theta):
        return -self.log_density(theta)

    # -- analytic derivatives (reference lmc.py:53-75 in responsibility form)

    def responsibilities(self, theta):
        return softmax(self.component_log_densities(theta) + self.log_weights)

    def grad_potential(self, theta):
        r = self.responsibilities(theta)  # (..., n)
        pulls = matvec(self.precs, self.mus - theta[..., None, :])  # (..., n, d)
        return -fsum(r[..., None] * pulls, -2)

    def hess_potential(self, theta):
        """Hess U = E_r[prec_i] - E_r[pdev_i pdev_i^T] + (grad U)(grad U)^T
        with pdev_i = Sigma_i^{-1}(theta - mu_i)."""
        r = self.responsibilities(theta)[..., None, None]  # (..., n, 1, 1)
        pdev = matvec(self.precs, theta[..., None, :] - self.mus)  # (..., n, d)
        grad_u = fsum(r[..., 0] * pdev, -2)
        e_prec = fsum(r * self.precs, -3)
        e_outer = fsum(r * (pdev[..., :, None] * pdev[..., None, :]), -3)
        return e_prec - e_outer + grad_u[..., :, None] * grad_u[..., None, :]

    def gd_update(self, theta, gamma):
        """Gradient-descent step on U (reference lmc.py:77-78)."""
        return theta - gamma * self.grad_potential(theta)

    # -- sampling ------------------------------------------------------------

    def sample(self, generator: torch.Generator, n_samples: int):
        """Ancestral sampling from ``generator``: the component from the
        weights (the reference draws it uniformly, lmc.py:88, which equals
        this for its equal weights), then its Gaussian."""
        idx = torch.multinomial(torch.exp(self.log_weights), n_samples,
                                replacement=True, generator=generator)
        eps = torch.randn((n_samples, self.dim), generator=generator,
                          dtype=self.mus.dtype, device=self.mus.device)
        return self.mus[idx] + matvec(self.chols[idx], eps)
