"""Chain runner (counterpart of ``lmc_atomi_tpu/run/runner.py``).

A Python loop over steps in place of ``lax.scan``: PyTorch runs eagerly, and
the hot loop of the 512^2 workload lives in the fused block kernel instead.
Collection modes:

  * ``collect="samples"`` - stack the (thinned) positions;
  * ``collect="stats"`` - streaming Welford moments (+ optional P^2
    quantiles) of the position;
  * ``collect="both"`` - thinned samples AND streaming stats in one pass;
  * ``collect="last"`` - final state only.

The base key is a seed or a ``(seed, chain)`` pair; step ``state.step`` of a
chain draws its noise under ``(seed, chain, state.step)``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from lmc_atomi_torch.core.state import SamplerState
from lmc_atomi_torch.core.stats import RunningMoments, RunningQuantile
from lmc_atomi_torch.kernels.base import Kernel

__all__ = ["ChainResult", "run_chain", "base_key"]


class ChainResult(NamedTuple):
    final_state: SamplerState
    samples: Optional[torch.Tensor]  # (n_emitted, *shape) when collected
    infos: Any  # list of the emitted steps' StepInfo
    metrics: Optional[Dict[str, torch.Tensor]]
    moments: Optional[RunningMoments]
    quantiles: Optional[Dict[float, RunningQuantile]]
    extras: Optional[Any] = None


def base_key(key):
    """``(seed, chain)`` from an int seed or a ``(seed, chain)`` pair."""
    if isinstance(key, (tuple, list)):
        seed, chain = key
        return int(seed), int(chain)
    return int(key), 0


def run_chain(
    kernel: Kernel,
    x0,
    key,
    n_steps: int,
    *,
    collect: str = "samples",
    thin: int = 1,
    metrics: Optional[Dict[str, Callable]] = None,
    quantile_ps: tuple = (),
    burn_in: int = 0,
    init_args: tuple = (),
) -> ChainResult:
    """Run one chain for ``n_steps`` kernel steps.

    ``n_steps`` must be divisible by ``thin``; positions/metrics are emitted
    every ``thin`` steps. ``burn_in`` (in *emitted* steps) masks the streaming
    moment/quantile updates.
    """
    if n_steps % thin != 0:
        raise ValueError(f"n_steps={n_steps} not divisible by thin={thin}")
    if collect not in ("samples", "stats", "both", "last"):
        raise ValueError(f"unknown collect mode {collect!r}")
    n_emit = n_steps // thin
    seed, chain = base_key(key)
    state = kernel.init(x0, *init_args)
    want_samples = collect in ("samples", "both")
    want_stats = collect in ("stats", "both")

    pos = state.position
    moments = RunningMoments.init(pos) if want_stats else None
    quants = (
        {p: RunningQuantile.init(pos.shape, p, pos.dtype, pos.device)
         for p in quantile_ps}
        if (want_stats and quantile_ps) else None
    )
    samples, infos = [], []
    series = {name: [] for name in (metrics or {})}
    for idx in range(n_emit):
        for _ in range(thin):
            state, info = kernel.step(state, (seed, chain, state.step))
        infos.append(info)
        if want_samples:
            samples.append(state.position)
        for name, fn in (metrics or {}).items():
            series[name].append(fn(state.position))
        if want_stats:
            w = idx >= burn_in
            moments = moments.update(state.position, weight=w)
            if quants is not None and w:
                quants = {p: q.update(state.position) for p, q in quants.items()}
    return ChainResult(
        final_state=state,
        samples=torch.stack(samples) if want_samples else None,
        infos=infos,
        metrics=(
            {k: torch.stack([torch.as_tensor(v) for v in vs]) for k, vs in series.items()}
            if metrics else None
        ),
        moments=moments,
        quantiles=quants,
    )
