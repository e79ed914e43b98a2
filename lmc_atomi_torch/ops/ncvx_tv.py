"""Nonconvex TV data functional, MC-TV and ME-TV (counterpart of
``lmc_atomi_tpu/ops/ncvx_tv.py``; reference algs.py:22-291):

    f(x) = sigma/2 ||Op x - b||^2 - lamda * MoreauEnv_gamma(g)(.) [+ alpha q.x]

* **MC-TV** (``op2`` a gradient operator): ``g`` is the (an)isotropic l1 of
  the gradient field, with the isotropic per-pixel gradient-norm clamp of
  reference algs.py:213-217.
* **ME-TV** (``op2 is None``): the Moreau envelope of TV on x itself; the
  isotropic mode takes the 2-D Chambolle prox (the CUDA kernel
  ``prox_tv_iso_cuda`` for a CUDA tensor), the anisotropic one the 1-D TV of
  the flattened image.

``prox`` linearizes the concave part and then solves
``(I + tau sigma Op^T Op)^{-1}`` exactly with the operator's ``gram_solve``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from lmc_atomi_torch.ops import tv as tv_ops
from lmc_atomi_torch.ops.prox import prox_laplace

__all__ = ["L2NcvxTV"]


@dataclass
class L2NcvxTV:
    op: Optional[Any]  # data-term operator (None: the identity)
    b: Optional[torch.Tensor]
    op2: Optional[Any] = None  # a gradient operator: MC-TV mode
    q: Optional[torch.Tensor] = None
    sigma: float = 1.0
    alpha: float = 1.0
    lamda: float = 1.0
    gamma: float = 0.5
    isotropic: bool = False
    qgrad: bool = True
    niter_inner: int = 10
    niter_solve: int = 50

    def _tv_prox(self, x):
        if self.isotropic:
            return tv_ops.prox_tv_iso(x, self.gamma, self.niter_inner)
        return tv_ops.prox_tv1d(x.reshape(-1), self.gamma,
                                self.niter_inner).reshape(x.shape)

    def _iso_clamp(self, gx):
        """``min(1/gamma, 1/|gx|) gx`` per pixel, ``|gx|`` over the stacked
        gradient axis."""
        mag = torch.sqrt(torch.sum(gx * gx, dim=0, keepdim=True))
        mag = torch.where(mag != 0, mag, 1e-9)
        return torch.clamp(1.0 / mag, max=1.0 / self.gamma) * gx

    def _grad_moreau(self, x):
        """Gradient of MoreauEnv_gamma(g) at x (reference algs.py:270-282)."""
        if self.op2 is not None:
            gx = self.op2.matvec(x)
            if self.isotropic:
                return self.op2.rmatvec(self._iso_clamp(gx))
            return self.op2.rmatvec(gx - prox_laplace(gx, self.gamma)) / self.gamma
        return (x - self._tv_prox(x)) / self.gamma

    def _moreau_env(self, x):
        """MoreauEnv_gamma(g) value (reference algs.py:173-180)."""
        if self.op2 is not None:
            gx = self.op2.matvec(x)
            if self.isotropic:
                gx = torch.sqrt(torch.sum(gx * gx, dim=0))
            p = prox_laplace(gx, self.gamma)
            return torch.sum(torch.abs(p)) + torch.sum(torch.square(gx - p)) / (
                2.0 * self.gamma)
        p = self._tv_prox(x)
        gval = tv_ops.tv_iso(p) if self.isotropic else tv_ops.tv1d(p.reshape(-1))
        return gval + torch.sum(torch.square(x - p)) / (2.0 * self.gamma)

    def _data(self, x):
        if self.op is not None and self.b is not None:
            return self.op.matvec(x) - self.b
        if self.b is not None:
            return x - self.b
        return x

    def __call__(self, x):
        f = 0.5 * self.sigma * torch.sum(torch.square(self._data(x)))
        if self.q is not None:
            f = f + self.alpha * torch.sum(self.q * x)
        return f - self.lamda * self._moreau_env(x)

    def grad(self, x):
        gm = self._grad_moreau(x)
        if self.op is not None and self.b is not None:
            g = self.sigma * self.op.rmatvec(self._data(x))
        else:
            g = self.sigma * self._data(x)
        if self.q is not None and self.qgrad:
            g = g + self.alpha * self.q
        return g - self.lamda * gm

    def prox(self, x, tau):
        # concave-part linearization (reference algs.py:211-223)
        if self.op2 is not None:
            gx = self.op2.matvec(x)
            if self.isotropic:
                x = x + tau * self.lamda * self.op2.rmatvec(self._iso_clamp(gx))
            else:
                x = x + tau * self.lamda / self.gamma * self.op2.rmatvec(
                    gx - prox_laplace(gx, self.gamma))
        else:
            x = x + tau * self.lamda / self.gamma * (x - self._tv_prox(x))
        # quadratic data-term solve (reference algs.py:224-267)
        if self.op is not None and self.b is not None:
            y = x + tau * self.sigma * self.op.rmatvec(self.b)
            if self.q is not None:
                y = y - tau * self.alpha * self.q
            return self.op.gram_solve(tau * self.sigma, y, niter=self.niter_solve)
        num = x if self.b is None else x + tau * self.sigma * self.b
        if self.q is not None:
            num = num - tau * self.alpha * self.q
        return num / (1.0 + tau * self.sigma)
