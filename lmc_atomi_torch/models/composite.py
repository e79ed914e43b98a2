"""Composite targets: smooth potential + nonsmooth prior (counterpart of
``lmc_atomi_tpu/models/composite.py``).

The reference's workload-3 target, a Gaussian-mixture likelihood times an
uncentered Laplace (l1) prior (reference prox_lmc.py:316-319), and the
smooth + prox split every proximal kernel consumes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from lmc_atomi_torch.ops.batched import fsum
from lmc_atomi_torch.ops.prox import prox_uncentered_laplace

__all__ = ["LaplacePrior", "MixtureWithLaplacePrior"]


@dataclass
class LaplacePrior:
    """Uncentered l1 prior ``alpha ||theta - mu||_1`` with density
    ``(alpha/2)^d exp(-alpha ||theta - mu||_1)`` (reference prox_lmc.py:56-57)."""

    mu: torch.Tensor
    alpha: torch.Tensor

    @classmethod
    def create(cls, mu, alpha, dtype=None, device=None) -> "LaplacePrior":
        mu = torch.as_tensor(mu, dtype=dtype, device=device)
        return cls(mu=mu, alpha=torch.as_tensor(alpha, dtype=mu.dtype, device=mu.device))

    @property
    def dim(self) -> int:
        return self.mu.shape[-1]

    def value(self, theta):
        return self.alpha * fsum(torch.abs(theta - self.mu), -1)

    def log_density(self, theta):
        return self.dim * torch.log(self.alpha / 2.0) - self.value(theta)

    def density(self, theta):
        return torch.exp(self.log_density(theta))

    def prox(self, theta, gamma):
        """prox of ``gamma ||. - mu||_1``; the alpha scaling is the caller's
        (the reference passes gamma = lam alpha)."""
        return prox_uncentered_laplace(theta, gamma, self.mu)


@dataclass
class MixtureWithLaplacePrior:
    """Target ``pi(theta) ∝ mixture(theta) laplace_prior(theta)``: the smooth
    part through gradients, the l1 part through its prox and Moreau envelope
    (reference ``ProximalLangevinMonteCarlo``, prox_lmc.py:29-96)."""

    mixture: Any  # GaussianMixture
    prior: LaplacePrior
    lam: torch.Tensor  # Moreau smoothing parameter of the prior

    @classmethod
    def create(cls, mixture, prior, lam) -> "MixtureWithLaplacePrior":
        return cls(mixture=mixture, prior=prior,
                   lam=torch.as_tensor(lam, dtype=prior.mu.dtype, device=prior.mu.device))

    def log_density(self, theta):
        return self.mixture.log_density(theta) + self.prior.log_density(theta)

    def density(self, theta):
        return torch.exp(self.log_density(theta))

    def smooth_potential(self, theta):
        """The differentiable part: the mixture's potential."""
        return self.mixture.potential(theta)

    def grad_smooth_potential(self, theta):
        return self.mixture.grad_potential(theta)

    def hess_smooth_potential(self, theta):
        return self.mixture.hess_potential(theta)

    def prior_prox(self, theta, gamma=None):
        """prox of ``gamma alpha ||. - mu||_1``; gamma defaults to lam."""
        g = self.lam if gamma is None else gamma
        return self.prior.prox(theta, g * self.prior.alpha)

    def grad_moreau_prior(self, theta):
        """Gradient of the prior's lam-Moreau envelope (reference
        prox_lmc.py:114-115): (theta - prox)/lam."""
        return (theta - self.prior_prox(theta)) / self.lam

    def gd_update(self, theta, gamma):
        return theta - gamma * self.grad_smooth_potential(theta)
