"""Imaging-scale samplers (counterpart of ``lmc_atomi_tpu/kernels/imaging.py``):
ULPDA and MYULA over functionals. A step draws ``normal_field`` at its key
``(seed, chain, step)``, so a fused kernel drawing the same Philox stream
runs the same chain."""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from lmc_atomi_torch.core.random import normal_field
from lmc_atomi_torch.core.state import SamplerState, StepInfo
from lmc_atomi_torch.kernels.base import Kernel, stepsize_at

__all__ = ["ulpda", "myula_imaging", "ULPDAExtras"]


def _sqrt(t):
    return torch.sqrt(t) if isinstance(t, torch.Tensor) else math.sqrt(t)


class ULPDAExtras(NamedTuple):
    y: Any  # dual variable
    xbar: Any  # extrapolated primal
    # previous primal iterate (the tiled kernel's exact resume point)
    xprev: Any = None


def ulpda(proxf, proxg, a_op, tau, mu, theta: float = 1.0,
          z: Optional[torch.Tensor] = None, gfirst: bool = True,
          noise_scale: float = 1.0) -> Kernel:
    """Unadjusted Langevin primal-dual (Chambolle-Pock + primal noise).

    gfirst=True recursion (reference algs.py:370-381, 435-441):
        y    <- proxdual_g(y + mu A xbar, mu)
        x    <- prox_f(x - tau (A^T y + z), tau) + sqrt(2 tau) xi
        xbar <- x + theta (x - x_old)
    gfirst=False applies the primal update first (algs.py:383-392, 442-448).
    ``noise_scale=0`` is deterministic Chambolle-Pock.
    """

    def init(x0, y0=None):
        y = a_op.matvec(x0) * 0.0 if y0 is None else y0
        return SamplerState.init(x0, extras=ULPDAExtras(y=y, xbar=x0))

    def step(state, key):
        t = stepsize_at(tau, state.step)
        m = stepsize_at(mu, state.step)
        x_old = state.position
        xi = noise_scale * normal_field(*key, x_old.shape, x_old.dtype,
                                        x_old.device)
        y = state.extras.y
        xbar = state.extras.xbar
        if gfirst:
            y = proxg.proxdual(y + m * a_op.matvec(xbar), m)
        aty = a_op.rmatvec(y)
        if z is not None:
            aty = aty + z
        x = proxf.prox(x_old - t * aty, t) + _sqrt(2 * t) * xi
        xbar = x + theta * (x - x_old)
        if not gfirst:
            y = proxg.proxdual(y + m * a_op.matvec(xbar), m)
        return state.next(x, extras=ULPDAExtras(y=y, xbar=xbar)), StepInfo()

    return Kernel(init, step)


def myula_imaging(proxf, proxg, tau, gamma, epsg: float = 1.0) -> Kernel:
    """Moreau-Yosida ULA over functionals (reference algs.py:528-535, 569):

        x <- (1 - tau/gamma) x - tau grad_f(x)
             + (tau/gamma) prox_g(x, epsg*gamma) + sqrt(2 tau) xi

    ``xi`` is ``normal_field(seed, chain, step)`` of the step's key.
    """

    def init(x0):
        return SamplerState.init(x0)

    def step(state, key):
        t = stepsize_at(tau, state.step)
        g = stepsize_at(gamma, state.step)
        x = state.position
        xi = normal_field(*key, x.shape, x.dtype, x.device)
        x_new = (
            (1.0 - t / g) * x
            - t * proxf.grad(x)
            + (t / g) * proxg.prox(x, epsg * g)
            + _sqrt(2 * t) * xi
        )
        return state.next(x_new), StepInfo()

    return Kernel(init, step)
