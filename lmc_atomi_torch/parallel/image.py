"""A whole image from its blocks: ``gather_image`` brings an image that
``shard_image`` split over ranks back whole, to read a run's result. The
exchanges inside a sharded step (``halo``, ``halo_map``, ``spectral_map``,
``normal_block``) are in ``ops/sharded.py``, below the ops that call them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from lmc_atomi_torch.ops.sharded import block_grid

__all__ = ["gather_image"]


def gather_image(x):
    """The whole image of the DTensor ``x`` on every rank, on its blocks'
    device: an all-gather over the ``col`` group, then over the ``row``
    group, of host copies under gloo. ``DTensor.full_tensor`` gathers card
    tensors through gloo itself, which crashed (a segmentation fault) with
    several ranks on one H100 under torch 2.11."""
    grid = block_grid(x)
    out = x.to_local()
    for group, dim in ((grid.col_group, 1), (grid.row_group, 0)):
        if group is None:
            continue
        where = torch.device("cpu") if dist.get_backend(group) == "gloo" else out.device
        src = out.contiguous().to(where)
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim).to(x.to_local().device)
    return out
