"""Imaging-scale samplers (counterpart of ``lmc_atomi_tpu/kernels/imaging.py``);
this slice ports MYULA over functionals."""
from __future__ import annotations

import math

import torch

from lmc_atomi_torch.core.random import normal_field
from lmc_atomi_torch.core.state import SamplerState, StepInfo
from lmc_atomi_torch.kernels.base import Kernel, stepsize_at

__all__ = ["myula_imaging"]


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
        sqrt = torch.sqrt if isinstance(t, torch.Tensor) else math.sqrt
        x_new = (
            (1.0 - t / g) * x
            - t * proxf.grad(x)
            + (t / g) * proxg.prox(x, epsg * g)
            + sqrt(2 * t) * xi
        )
        return state.next(x_new), StepInfo()

    return Kernel(init, step)
