"""Sampler state (counterpart of ``lmc_atomi_tpu/core/state.py``).

Plain dataclasses in place of flax pytrees: the port runs eagerly, so the
step counter is a Python int and the runner folds it into the noise counter
without a device round trip.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

__all__ = ["SamplerState", "StepInfo"]


@dataclass
class SamplerState:
    """Generic Langevin sampler state.

    Attributes:
      position: current chain position (a tensor, typically an image).
      step: iteration counter.
      extras: kernel-specific state; ``None`` for simple kernels.
    """

    position: Any
    step: int = 0
    extras: Optional[Any] = None

    @classmethod
    def init(cls, position, extras=None) -> "SamplerState":
        return cls(position=position, step=0, extras=extras)

    def next(self, position, extras=None) -> "SamplerState":
        return dataclasses.replace(
            self,
            position=position,
            step=self.step + 1,
            extras=self.extras if extras is None else extras,
        )


@dataclass
class StepInfo:
    """Per-step diagnostics emitted by kernels."""

    accepted: Optional[Any] = None
    log_accept_ratio: Optional[Any] = None
    energy: Optional[Any] = None
