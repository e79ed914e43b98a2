"""Chain runner (counterpart of ``lmc_atomi_tpu/run/runner.py``).

A Python loop over steps in place of ``lax.scan``: PyTorch runs eagerly, and
the hot loop of the 512^2 workload lives in the fused block kernel instead.
Collection modes:

  * ``collect="samples"`` - stack the (thinned) positions;
  * ``collect="stats"`` - streaming Welford moments (+ optional P^2
    quantiles) of the position;
  * ``collect="both"`` - thinned samples AND streaming stats in one pass;
  * ``collect="last"`` - final state only.

``collect_extras`` stacks the kernel's extras (e.g. ULPDA's dual samples)
or a projection of them at each emitted step.

The base key is a seed or a ``(seed, chain)`` pair; step ``state.step`` of a
chain draws its noise under ``(seed, chain, state.step)``. ``run_chains``
runs independent chains under ``core.random.chain_keys`` and stacks their
results along a leading chain axis, as ``jax.vmap`` of ``run_chain`` does in
the JAX package: one step over all chains for a kernel with ``chain_axis``
(``run_chain`` with the chain words as a tensor), chain after chain for the
others; ``run_chain_segmented`` is ``run_chain(collect="stats")`` with a
progress call every ``segment_steps``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable, Dict, NamedTuple, Optional

import torch

from lmc_atomi_torch.core.random import as_key, chain_keys
from lmc_atomi_torch.core.state import SamplerState
from lmc_atomi_torch.core.stats import RunningMoments, RunningQuantile

if TYPE_CHECKING:  # kernels/ imports this module: no import at run time
    from lmc_atomi_torch.kernels.base import Kernel

__all__ = ["ChainResult", "run_chain", "run_chains", "run_keyed_chains",
           "run_chain_segmented", "base_key", "stack_tree"]


class ChainResult(NamedTuple):
    final_state: SamplerState
    samples: Optional[torch.Tensor]  # (n_emitted, *shape) when collected
    infos: Any  # list of the emitted steps' StepInfo
    metrics: Optional[Dict[str, torch.Tensor]]
    moments: Optional[RunningMoments]
    quantiles: Optional[Dict[float, RunningQuantile]]
    extras: Optional[Any] = None


# ``(seed, chain)`` from an int seed or a ``(seed, chain)`` pair; a chain
# given as a tensor of words (a chain axis) stays a tensor
base_key = as_key


def stack_tree(items):
    """Stack equal-structured results along a new leading axis, as
    ``jax.vmap`` stacks its outputs: tensors and Python numbers stack, None
    stays None, and dataclasses, NamedTuples, dicts, tuples and lists stack
    field by field."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, (bool, int, float)):
        return torch.tensor(items)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return type(first)(**{f.name: stack_tree([getattr(i, f.name) for i in items])
                              for f in dataclasses.fields(first)})
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(stack_tree(list(v)) for v in zip(*items)))
    if isinstance(first, dict):
        return {k: stack_tree([i[k] for i in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stack_tree(list(v)) for v in zip(*items))
    raise TypeError(f"cannot stack {type(first).__name__}")


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
    collect_extras: Any = False,
    unroll: int = 1,
) -> ChainResult:
    """Run one chain for ``n_steps`` kernel steps.

    ``n_steps`` must be divisible by ``thin``; positions/metrics are emitted
    every ``thin`` steps. ``burn_in`` (in *emitted* steps) masks the streaming
    moment/quantile updates. ``collect_extras`` (True, or a projection
    ``fn(extras)``) stacks ``state.extras`` (or ``fn(state.extras)``) of each
    emitted step into ``ChainResult.extras``, e.g. ULPDA's dual samples.
    ``unroll`` is the JAX package's scan unrolling; the port's loop is
    eager, so it takes no effect. A key ``(seed, words)`` with ``words`` an
    int64 tensor of ``C`` chain words steps ``C`` chains at once through a
    kernel with ``chain_axis`` (``x0`` of shape ``(C, ...)``); the results
    then keep the chain axis inside each emitted step (``run_chains`` puts
    it first).
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
    samples, infos, extras = [], [], []
    series = {name: [] for name in (metrics or {})}
    for idx in range(n_emit):
        for _ in range(thin):
            state, info = kernel.step(state, (seed, chain, state.step))
        infos.append(info)
        if want_samples:
            samples.append(state.position)
        if collect_extras:
            extras.append(collect_extras(state.extras) if callable(collect_extras)
                          else state.extras)
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
        extras=stack_tree(extras) if collect_extras and extras else None,
    )


def run_chains(
    kernel: Kernel,
    x0,
    key,
    n_steps: int,
    n_chains: int,
    *,
    axis: int = 0,
    batched: Optional[bool] = None,
    **kwargs,
) -> ChainResult:
    """``n_chains`` independent chains: chain ``i`` is ``run_chain`` under
    ``chain_keys(key, n_chains)[i]``, and every field of the results stacks
    along a leading chain axis (``stack_tree``, ``jax.vmap``'s semantics).
    A kernel with ``chain_axis`` runs one step over all chains, its key the
    ``(C,)`` tensor of the chain words; ``metrics`` then take the ``(C,
    ...)`` positions and return one value a chain. Other kernels run chain
    after chain.

    ``x0`` is one position (every chain starts there) or a batch with a
    leading chain axis; ``batched`` settles the case where one position's
    leading dimension equals ``n_chains`` (``True``: the axis is the chains,
    ``False``: broadcast); ``None`` takes ``x0`` as batched when every
    tensor in it has a leading dimension of ``n_chains``. ``axis`` is the
    JAX package's and must be 0."""
    if axis != 0:
        raise ValueError("run_chains stacks its chains along axis 0")
    return run_keyed_chains(kernel, x0, chain_keys(key, n_chains), n_steps,
                            batched=batched, **kwargs)


def run_keyed_chains(kernel: Kernel, x0, keys, n_steps: int, *,
                     batched: Optional[bool] = None, **kwargs) -> ChainResult:
    """``run_chains`` over the given chain keys ``(seed, word)``, which
    share their seed (a slice of ``chain_keys``: ``parallel.mesh`` runs a
    rank's share of a farm so); ``x0`` and ``batched`` as in ``run_chains``
    with ``len(keys)`` chains."""
    n_chains = len(keys)
    leaves = _leaves(x0)
    if batched is None:
        batched = _is_batched(x0, n_chains)
    if kernel.chain_axis:
        words = torch.tensor([w for _, w in keys], dtype=torch.int64,
                             device=leaves[0].device)
        if not batched:
            x0 = _map(lambda l: l.expand((n_chains,) + l.shape).clone(), x0)
        return _chain_major(run_chain(kernel, x0, (keys[0][0], words), n_steps, **kwargs),
                            n_chains)
    results = [
        run_chain(kernel, _map(lambda l: l[i], x0) if batched else x0, k, n_steps,
                  **kwargs)
        for i, k in enumerate(keys)
    ]
    return stack_tree(results)


def _chain_major(res: ChainResult, n_chains: int) -> ChainResult:
    """A batched ``run_chain`` result in ``stack_tree``'s layout of a chain
    after chain run: the chain axis first in the samples, metrics, extras
    and quantile markers, and every count a ``(C,)`` tensor."""
    def per_chain(v):
        return torch.full((n_chains,), v) if isinstance(v, (int, float)) else v

    def first(t):
        return None if t is None else t.movedim(1, 0)

    state = res.final_state
    moments = res.moments
    if moments is not None:
        moments = dataclasses.replace(moments, count=per_chain(moments.count))
    quants = res.quantiles
    if quants is not None:
        quants = {p: dataclasses.replace(q, p=per_chain(q.p), count=per_chain(q.count),
                                         heights=first(q.heights),
                                         positions=first(q.positions))
                  for p, q in quants.items()}
    return ChainResult(
        final_state=dataclasses.replace(state, step=per_chain(state.step)),
        samples=first(res.samples),
        infos=res.infos,
        metrics=None if res.metrics is None else {k: first(v) for k, v in res.metrics.items()},
        moments=moments,
        quantiles=quants,
        extras=None if res.extras is None else _map(first, res.extras),
    )


def _is_batched(x0, n_chains: int) -> bool:
    """Whether every tensor of ``x0`` has a leading axis of ``n_chains``."""
    leaves = _leaves(x0)
    return bool(leaves) and all(
        isinstance(l, torch.Tensor) and l.ndim > 0 and l.shape[0] == n_chains
        for l in leaves)


def _leaves(tree):
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [l for v in tree for l in _leaves(v)]
    return [] if tree is None else [tree]


def _map(fn, tree):
    """``fn`` on every leaf of dicts, NamedTuples, tuples, lists and
    dataclasses; None stays."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def run_chain_segmented(
    kernel: Kernel,
    x0,
    key,
    n_steps: int,
    *,
    segment_steps: int = 250,
    burn_in: int = 0,
    init_args: tuple = (),
    quantile_ps: tuple = (),
    progress: Optional[Callable] = None,
) -> ChainResult:
    """``run_chain(collect="stats")`` in segments of ``segment_steps``,
    calling ``progress(done, moments)`` after each (e.g. a running-mean PSNR
    for long chains). The noise is keyed by the global step and the moments
    and P^2 markers carry across the segments, so the result equals
    ``run_chain``'s bit for bit. ``burn_in`` is in steps."""
    seed, chain = base_key(key)
    state = kernel.init(x0, *init_args)
    pos = state.position
    moments = RunningMoments.init(pos)
    quants = {p: RunningQuantile.init(pos.shape, p, pos.dtype, pos.device)
              for p in quantile_ps} or None
    done = 0
    while done < n_steps:
        ns = min(segment_steps, n_steps - done)
        for i in range(ns):
            state, _ = kernel.step(state, (seed, chain, state.step))
            w = done + i >= burn_in
            moments = moments.update(state.position, weight=w)
            if quants is not None and w:
                quants = {p: q.update(state.position) for p, q in quants.items()}
        done += ns
        if progress is not None:
            progress(done, moments)
    return ChainResult(final_state=state, samples=None, infos=None, metrics=None,
                       moments=moments, quantiles=quants)
