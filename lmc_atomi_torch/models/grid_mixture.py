"""25-mode grid Gaussian mixture, the SG-MCMC target (counterpart of
``lmc_atomi_tpu/models/grid_mixture.py``; reference jax/sgld.py:49-66).

Modes on the Cartesian product ``positions x positions`` with a common
isotropic covariance ``sigma I`` and the tempered, unnormalised
log-probability

    log_prob(x) = lam * logsumexp_i N(x; mu_i, sigma I).logpdf

batched over leading axes. ``grad_log_prob`` is written out, ``lam * sum_i
softmax_i (mu_i - x) / sigma``, in place of autodiff: fewer launches a step.
The sums over the modes are ``ops/batched.py``'s tree sums and over the two
coordinates one add, so a chain's bits do not depend on the batch it runs
in. ``sigma`` and ``lam`` are Python floats, and the modes are f32 by
default, as the JAX model makes them.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import torch

from lmc_atomi_torch.ops.batched import fsum, tsum

__all__ = ["GridGaussianMixture"]


@dataclass
class GridGaussianMixture:
    mus: torch.Tensor  # (n, d)
    sigma: float  # isotropic variance (the reference's name)
    lam: float  # tempering factor

    @classmethod
    def create(cls, positions, sigma, lam, dtype=torch.float32,
               device=None) -> "GridGaussianMixture":
        positions = list(positions)
        mus = torch.tensor([list(p) for p in itertools.product(positions, positions)],
                           dtype=dtype, device=device)
        return cls(mus=mus, sigma=float(sigma), lam=float(lam))

    @property
    def dim(self) -> int:
        return self.mus.shape[-1]

    def _logpdf(self, x):
        """``(..., n)`` component log densities."""
        dev = x[..., None, :] - self.mus
        maha = fsum(dev * dev, -1) / self.sigma
        return -0.5 * (maha + self.dim * math.log(2 * math.pi * self.sigma))

    def log_prob(self, x):
        lp = self._logpdf(x)
        # the max is a constant of the sum: no gradient through it, as
        # jax.scipy.special.logsumexp stops it
        m = lp.detach().amax(-1)
        return self.lam * (m + torch.log(tsum(torch.exp(lp - m[..., None]))))

    def grad_log_prob(self, x):
        lp = self._logpdf(x)
        e = torch.exp(lp - lp.amax(-1, keepdim=True))
        w = e / tsum(e)[..., None]
        return self.lam * tsum(w[..., None] * (self.mus - x[..., None, :]), -2) / self.sigma

    def sample(self, generator: torch.Generator, n_samples: int):
        """A mode uniformly, then its Gaussian (reference jax/sgld.py:59-66)."""
        n = self.mus.shape[0]
        idx = torch.randint(0, n, (n_samples,), generator=generator, device=self.mus.device)
        eps = torch.randn((n_samples, self.dim), generator=generator, dtype=self.mus.dtype,
                          device=self.mus.device)
        return self.mus[idx] + math.sqrt(self.sigma) * eps
