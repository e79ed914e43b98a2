"""Sampler state, counter-based noise and streaming statistics."""
from lmc_atomi_torch.core.random import as_key, chain_keys, normal_like, step_key
from lmc_atomi_torch.core.state import SamplerState, StepInfo
from lmc_atomi_torch.core.stats import RunningMoments, RunningQuantile

__all__ = [
    "as_key",
    "chain_keys",
    "normal_like",
    "step_key",
    "SamplerState",
    "StepInfo",
    "RunningMoments",
    "RunningQuantile",
]
