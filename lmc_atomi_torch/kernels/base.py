"""Kernel protocol (counterpart of ``lmc_atomi_tpu/kernels/base.py``).

Every sampler is a factory returning ``Kernel(init, step)``::

    state = kernel.init(x0, ...)
    state, info = kernel.step(state, key)

In the port ``key`` is the tuple ``(seed, chain, step)`` that the runner
builds from its base key and ``state.step``; a kernel draws its noise from
``core.random.normal_field(*key, ...)``.

A kernel with ``chain_axis`` set also steps ``C`` chains at once: the
position has a leading axis of ``C`` and ``chain`` is an int64 tensor of
their ``C`` words (``run_chains`` builds both), and row ``i`` of the step is
the one-chain step under word ``i``. PULA, IHPULA, MLA, the proximal
samplers and the learned priors' PnP-ULA and score-ULA set it: their
targets and nets batch over leading axes. ``ula`` and ``mala``
leave it off, since the imaging workloads hand them one-image terms; a
caller whose terms batch sets it with ``kernel._replace(chain_axis=True)``,
as the mixture workloads do.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["Kernel", "stepsize_at"]


class Kernel(NamedTuple):
    init: Callable
    step: Callable
    chain_axis: bool = False


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
