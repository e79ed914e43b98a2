"""Multi-process chain farms (counterpart of
``lmc_atomi_tpu/parallel/multihost.py``).

One process a device, joined in a ``torch.distributed`` process group:
``init_multihost`` starts the group from torch's own launcher variables
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun``
sets them) or from an explicit ``init_method`` or store, and is a no-op at
world size 1, so one farm script runs everywhere. Chains are independent,
so the only traffic is the gather of the per-chain results.

    torchrun --nproc_per_node 4 farm.py   # farm.py: init_multihost(); global_chain_farm(...)
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from lmc_atomi_torch.parallel.mesh import chain_mesh, merge_chain_moments, run_chains_sharded

__all__ = ["init_multihost", "global_chain_farm"]


def _backend(world: int) -> str:
    """NCCL where every rank of a node has a card of its own, else gloo (no
    card, or more ranks on a node than cards: NCCL refuses two ranks on one
    device, gloo moves host copies). A node's ranks are ``LOCAL_WORLD_SIZE``
    (``torchrun`` sets it), else the whole world."""
    if not torch.cuda.is_available():
        return "gloo"
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if per_node <= torch.cuda.device_count() else "gloo"


def init_multihost(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    store=None,
) -> int:
    """Start the process group of a multi-process run; returns the world
    size. ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and
    ``RANK``; at world size 1 nothing starts and it returns 1. The rendezvous
    is ``store`` (e.g. a ``FileStore``), else ``init_method`` (e.g.
    ``tcp://host:port`` or ``file://...``), else ``env://`` (``MASTER_ADDR``
    and ``MASTER_PORT``). The backend is NCCL where each rank of a node has
    a card, each rank then on the card ``LOCAL_RANK`` (else ``rank``) modulo
    the cards, and gloo otherwise (``_backend``)."""
    world = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 1
    rank = int(rank if rank is not None else os.environ.get("RANK", "0"))
    backend = _backend(world)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank, world_size=world)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world)
    return world


def global_chain_farm(kernel, x0, key, n_steps: int, n_chains: int, **kwargs):
    """Run a chain farm over every rank of the process group (one mesh over
    all of them, on ``x0``'s device type) and return ``(per-chain
    ChainResult, pooled RunningMoments or None)``."""
    mesh = chain_mesh(device=torch.as_tensor(x0).device.type)
    res = run_chains_sharded(kernel, x0, key, n_steps, n_chains, mesh=mesh, **kwargs)
    pooled = merge_chain_moments(res.moments) if res.moments is not None else None
    return res, pooled
