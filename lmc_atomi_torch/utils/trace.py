"""Timing, profiling and iteration logs (counterpart of
``lmc_atomi_tpu/utils/trace.py``):

  * ``Timer``: wall-clock time and iterations a second of a block, after
    waiting for the card's queued work;
  * ``profile``: a ``torch.profiler`` trace of a block, written to a
    directory (view it in Perfetto or ``chrome://tracing``);
  * ``should_log`` / ``print_iteration_table``: the reference's log-every
    policy (first 10, last 10, every n/10, algs.py:460) applied to metric
    series collected by the runner.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["Timer", "profile", "should_log", "print_iteration_table"]


class Timer:
    """Wall-clock timer that waits for the card's work.

    >>> with Timer("myula", n_iters=1000) as t: ... run ...
    prints "myula: 2.31 s (1000 iters, 433.2 iters/s)".

    With ``sync`` the exit synchronises the current CUDA device (the one the
    timed work ran on) before reading the clock.
    An error of the card surfaces there and propagates: nothing is
    swallowed. Without a card there is nothing to wait for.
    """

    def __init__(self, name: str = "", n_iters: Optional[int] = None, sync: bool = True,
                 quiet: bool = False):
        self.name = name
        self.n_iters = n_iters
        self.sync = sync
        self.quiet = quiet
        self.elapsed = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self._t0
        if not self.quiet and not exc[0]:
            msg = f"{self.name}: {self.elapsed:.2f} s"
            if self.n_iters:
                msg += f" ({self.n_iters} iters, {self.n_iters / self.elapsed:.1f} iters/s)"
            print(msg)
        return False

    @property
    def iters_per_sec(self) -> float:
        return (self.n_iters or 0) / self.elapsed if self.elapsed else 0.0


@contextlib.contextmanager
def profile(logdir: str):
    """Record a ``torch.profiler`` trace (host, and the card's kernels where
    there is one) of everything inside the block into ``logdir``, as a
    Chrome trace ``trace.json``; yields the profiler (its
    ``key_averages()`` tables the same events)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch_profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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
