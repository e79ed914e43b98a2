"""Kernel protocol (counterpart of ``lmc_atomi_tpu/kernels/base.py``).

Every sampler is a factory returning ``Kernel(init, step)``::

    state = kernel.init(x0, ...)
    state, info = kernel.step(state, key)

In the port ``key`` is the tuple ``(seed, chain, step)`` that the runner
builds from its base key and ``state.step``; a kernel draws its noise from
``core.random.normal_field(*key, ...)``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["Kernel", "stepsize_at"]


class Kernel(NamedTuple):
    init: Callable
    step: Callable


def stepsize_at(gamma, step: int):
    """Resolve a stepsize spec at a step index: a scalar, a sequence or 1-D
    tensor or numpy array of per-iteration values, or a callable ``step ->
    value``. A numpy array or scalar becomes a tensor first (0-d: itself,
    1-d: its ``step``-th value), as ``jnp.asarray`` makes it in the JAX
    package."""
    if callable(gamma):
        return gamma(step)
    if isinstance(gamma, (np.ndarray, np.generic)):
        gamma = torch.as_tensor(gamma)
    if isinstance(gamma, torch.Tensor):
        return gamma if gamma.ndim == 0 else gamma[step]
    if isinstance(gamma, (list, tuple)):
        return gamma[step]
    return gamma
