"""Iteration logs (counterpart of ``lmc_atomi_tpu/utils/trace.py``):
``should_log`` / ``print_iteration_table`` apply the reference's log-every
policy (first 10, last 10, every n/10, algs.py:460) to metric series
collected by the runner. Timing and profiling on the card live in
``chip_smoke.py`` (``cuda_ms``, ``profile_window``)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["should_log", "print_iteration_table"]


def should_log(i: int, n: int) -> bool:
    """The reference's row policy (algs.py:460): first 10, last 10, every
    n // 10 iterations."""
    return i < 10 or (n - i) < 10 or (n >= 10 and i % (n // 10) == 0)


def print_iteration_table(metrics: Dict[str, Sequence], n: Optional[int] = None,
                          width: int = 12) -> str:
    """Print and return the show=True-style table of collected series."""
    names = list(metrics)
    series = {k: np.asarray(v) for k, v in metrics.items()}
    n = n or len(next(iter(series.values())))
    lines = ["   Itn " + " ".join(f"{k:>{width}s}" for k in names)]
    for i in range(n):
        if should_log(i, n):
            lines.append(f"{i + 1:6d} " + " ".join(
                f"{float(series[k][i]):>{width}.4e}" for k in names))
    out = "\n".join(lines)
    print(out)
    return out
