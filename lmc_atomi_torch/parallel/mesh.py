"""Cross-chain reductions (counterpart of ``lmc_atomi_tpu/parallel/mesh.py``).

Only ``merge_chain_moments`` is ported: the pooled posterior statistics of
a chain farm. The device meshes and sharded runners of the JAX module
(``chain_mesh``, ``image_mesh``, ``run_chains_sharded``, ``shard_image``)
wait for their ``torch.distributed`` counterparts (ROADMAP A9).
"""
from __future__ import annotations

import torch

from lmc_atomi_torch.core.stats import RunningMoments

__all__ = ["merge_chain_moments"]


def merge_chain_moments(moments: RunningMoments) -> RunningMoments:
    """Pool per-chain moments (a ``RunningMoments`` with a leading chain
    axis; ``count`` per chain or one count for all) into one, chain by chain
    in order with the Chan et al. combine."""
    n = moments.mean.shape[0]
    counts = torch.as_tensor(moments.count).reshape(-1).tolist()
    counts = counts * n if len(counts) == 1 else counts

    def chain(i):
        return RunningMoments(count=int(counts[i]), mean=moments.mean[i],
                              m2=moments.m2[i])

    pooled = chain(0)
    for i in range(1, n):
        pooled = pooled.merge(chain(i))
    return pooled
