"""Chain runners: one chain, chains stacked on a leading axis, segmented and
checkpointed long runs."""
from lmc_atomi_torch.run.longrun import run_resumable, run_resumable_fused
from lmc_atomi_torch.run.runner import (
    ChainResult,
    run_chain,
    run_chain_segmented,
    run_chains,
)

__all__ = [
    "ChainResult",
    "run_chain",
    "run_chain_segmented",
    "run_chains",
    "run_resumable",
    "run_resumable_fused",
]
