"""Moreau-Yosida envelope combinators (counterpart of
``lmc_atomi_tpu/ops/moreau.py``).

Given any ``g`` with a prox, the envelope

    env_lam(g)(x) = g(p) + ||p - x||^2 / (2 lam),   p = prox_{lam g}(x)

is smooth with gradient ``(x - p) / lam``, the identity the reference
applies by hand in each sampler (reference prox_lmc.py:114-115,
lmc_laplace.py:70-78).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["MoreauEnvelope", "moreau_envelope"]


class MoreauEnvelope(NamedTuple):
    value: Callable
    grad: Callable
    prox_point: Callable


def moreau_envelope(g_value: Callable, g_prox: Callable, lam) -> MoreauEnvelope:
    """The value, gradient and prox point of the ``lam``-Moreau envelope of
    ``g``: ``g_value(x)`` evaluates g, ``g_prox(x, t)`` is ``prox_{t g}``."""

    def prox_point(x):
        return g_prox(x, lam)

    def value(x):
        p = prox_point(x)
        return g_value(p) + torch.sum(torch.square(p - x)) / (2.0 * lam)

    def grad(x):
        return (x - prox_point(x)) / lam

    return MoreauEnvelope(value=value, grad=grad, prox_point=prox_point)
