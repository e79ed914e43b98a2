"""Chain farms across processes (counterpart of ``lmc_atomi_tpu/parallel``;
the image-sharding half, ``image_mesh`` and ``shard_image``, is not ported)."""
from lmc_atomi_torch.parallel.mesh import chain_mesh, merge_chain_moments, run_chains_sharded
from lmc_atomi_torch.parallel.multihost import global_chain_farm, init_multihost

__all__ = [
    "chain_mesh",
    "merge_chain_moments",
    "run_chains_sharded",
    "global_chain_farm",
    "init_multihost",
]
