"""Unadjusted and Metropolis-adjusted Langevin kernels on smooth(ed)
potentials (counterpart of ``lmc_atomi_tpu/kernels/langevin.py``): ``ula``
and ``mala``. PULA, IHPULA and MLA come with the mixtures slice.

A step's key is ``(seed, chain, step)``: the proposal noise is
``normal_field`` and MALA's accept draw ``uniform_scalar`` of that key, two
Philox streams that never share a counter. MALA keeps the stay-at-state
chain; the accept decision is a 0-d tensor chosen with ``torch.where`` on the
device, so a step never waits for the card.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from lmc_atomi_torch.core.random import normal_field, uniform_scalar
from lmc_atomi_torch.core.state import SamplerState, StepInfo
from lmc_atomi_torch.kernels.base import Kernel, stepsize_at

__all__ = ["ula", "mala"]


def _sqrt(t):
    return torch.sqrt(t) if isinstance(t, torch.Tensor) else math.sqrt(t)


def _noise(key, x):
    return normal_field(*key, x.shape, x.dtype, x.device)


def ula(grad_fn: Callable, gamma) -> Kernel:
    """Unadjusted Langevin: ``x <- x - g grad U(x) + sqrt(2 g) xi``."""

    def init(x0):
        return SamplerState.init(x0)

    def step(state, key):
        g = stepsize_at(gamma, state.step)
        x = state.position
        x = x - g * grad_fn(x) + _sqrt(2 * g) * _noise(key, x)
        return state.next(x), StepInfo()

    return Kernel(init, step)


def mala(log_density_fn: Callable, grad_fn: Callable, gamma) -> Kernel:
    """Metropolis-adjusted Langevin. Proposal
    ``N(x - g grad U(x), 2 g I)``; the log acceptance ratio is the target
    ratio plus the reverse minus the forward proposal log-density, term for
    term as the JAX package computes it. ``StepInfo`` carries ``accepted``
    and ``min(log_ratio, 0)`` as 0-d tensors."""

    def init(x0):
        return SamplerState.init(x0)

    def log_q(x_to, x_from, g):
        dev = x_to - (x_from - g * grad_fn(x_from))
        # N(mean, 2 g I) log-density up to the common normalizer
        return -torch.sum(dev * dev) / (4.0 * g)

    def step(state, key):
        g = stepsize_at(gamma, state.step)
        x = state.position
        prop = x - g * grad_fn(x) + _sqrt(2 * g) * _noise(key, x)
        log_ratio = (log_density_fn(prop) - log_density_fn(x)
                     + log_q(x, prop, g) - log_q(prop, x, g))
        u = uniform_scalar(*key, log_ratio.dtype, log_ratio.device)
        log_ratio = torch.clamp(log_ratio, max=0.0)
        accept = torch.log(u) <= log_ratio
        x_new = torch.where(accept, prop, x)
        return state.next(x_new), StepInfo(accepted=accept,
                                           log_accept_ratio=log_ratio)

    return Kernel(init, step)
