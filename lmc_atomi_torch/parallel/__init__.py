"""Chain farms across processes and images split over them (counterpart of
``lmc_atomi_tpu/parallel``); the exchanges of a sharded step are in
``ops/sharded.py``, ``parallel/image.py`` gathers a split image whole."""
from lmc_atomi_torch.parallel.mesh import (
    chain_mesh,
    image_mesh,
    merge_chain_moments,
    run_chains_sharded,
    shard_image,
)
from lmc_atomi_torch.parallel.multihost import global_chain_farm, init_multihost

__all__ = [
    "chain_mesh",
    "image_mesh",
    "merge_chain_moments",
    "run_chains_sharded",
    "shard_image",
    "global_chain_farm",
    "init_multihost",
]
