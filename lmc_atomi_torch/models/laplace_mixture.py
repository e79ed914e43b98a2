"""Laplacian-mixture target with Moreau-Yosida smoothing (counterpart of
``lmc_atomi_tpu/models/laplace_mixture.py``; reference lmc_laplace.py:31-95).

A mixture of ``(alpha_i/2)^d exp(-alpha_i ||theta - mu_i||_1)``; each
component's l1 term is replaced by its lam-Moreau envelope, whose gradient is
``(theta - prox)/lam``. The Hessian of the smoothed potential is
``torch.func.hessian`` of it, under ``torch.func.vmap`` over leading axes.
Sums over components and coordinates are ``ops/batched.py``'s, in a fixed
order.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from lmc_atomi_torch.ops.batched import fsum, logsumexp, softmax
from lmc_atomi_torch.ops.prox import prox_uncentered_laplace

__all__ = ["LaplaceMixture"]


@dataclass
class LaplaceMixture:
    mus: torch.Tensor  # (n, d)
    alphas: torch.Tensor  # (n,)
    log_weights: torch.Tensor  # (n,)
    lam: torch.Tensor  # Moreau smoothing parameter

    @classmethod
    def create(cls, mus, alphas, weights, lam, dtype=None, device=None) -> "LaplaceMixture":
        mus = torch.as_tensor(mus, dtype=dtype, device=device)

        def t(a):
            return torch.as_tensor(a, dtype=mus.dtype, device=mus.device)
        return cls(mus=mus, alphas=t(alphas), log_weights=torch.log(t(weights)), lam=t(lam))

    @property
    def dim(self) -> int:
        return self.mus.shape[-1]

    # -- exact (nonsmooth) density -------------------------------------------

    def component_log_densities(self, theta):
        l1 = fsum(torch.abs(theta[..., None, :] - self.mus), -1)  # (..., n)
        return self.dim * torch.log(self.alphas / 2.0) - self.alphas * l1

    def log_density(self, theta):
        return logsumexp(self.component_log_densities(theta) + self.log_weights)

    def density(self, theta):
        return torch.exp(self.log_density(theta))

    def potential(self, theta):
        return -self.log_density(theta)

    # -- Moreau-smoothed density ----------------------------------------------

    def _component_prox(self, theta):
        """prox of lam alpha_i ||. - mu_i||_1 at theta for every component:
        (..., n, d) (reference lmc_laplace.py:53-54)."""
        return prox_uncentered_laplace(theta[..., None, :], (self.lam * self.alphas)[..., None],
                                       self.mus)

    def component_smooth_log_densities(self, theta):
        """log of each smoothed component (lmc_laplace.py:56-61)."""
        p = self._component_prox(theta)
        l1 = fsum(torch.abs(p - self.mus), -1)
        quad = fsum(torch.square(p - theta[..., None, :]), -1)
        env = self.alphas * l1 + quad / (2.0 * self.lam)
        return self.dim * torch.log(self.alphas / 2.0) - env

    def smooth_log_density(self, theta):
        return logsumexp(self.component_smooth_log_densities(theta) + self.log_weights)

    def smooth_density(self, theta):
        return torch.exp(self.smooth_log_density(theta))

    def smooth_potential(self, theta):
        return -self.smooth_log_density(theta)

    def grad_smooth_potential(self, theta):
        """Envelope-identity gradient in responsibility form (reference
        lmc_laplace.py:70-78): grad U = sum_i r_i (theta - prox_i)/lam."""
        r = softmax(self.component_smooth_log_densities(theta) + self.log_weights)
        grad_env = (theta[..., None, :] - self._component_prox(theta)) / self.lam
        return fsum(r[..., None] * grad_env, -2)

    def hess_smooth_potential(self, theta):
        hess = torch.func.hessian(self.smooth_potential)
        for _ in range(theta.ndim - 1):
            hess = torch.func.vmap(hess)
        return hess(theta)

    def gd_update(self, theta, gamma):
        return theta - gamma * self.grad_smooth_potential(theta)

    # -- sampling --------------------------------------------------------------

    def sample(self, generator: torch.Generator, n_samples: int):
        """Ancestral samples from ``generator``: the component from the
        weights, then iid Laplace draws of scale ``1/alpha_i``, the
        distribution ``component_log_densities`` defines (the reference's
        ``multivariate_laplace.rvs`` with cov (2/alpha) I gives scale
        sqrt(2/alpha), lmc_laplace.py:41,106; not mirrored)."""
        idx = torch.multinomial(torch.exp(self.log_weights), n_samples,
                                replacement=True, generator=generator)
        return self.mus[idx] + (1.0 / self.alphas)[idx][:, None] * laplace_draws(
            generator, (n_samples, self.dim), self.mus.dtype, self.mus.device)


def laplace_draws(generator, shape, dtype, device):
    """Standard Laplace draws (inverse CDF of a uniform on (-1/2, 1/2))."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device) - 0.5
    tiny = torch.finfo(dtype).tiny
    return -torch.sign(u) * torch.log(torch.clamp(1.0 - 2.0 * torch.abs(u), min=tiny))

