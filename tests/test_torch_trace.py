"""``utils/trace.py`` of the port on the CPU, against the JAX package's:
``Timer`` (its clock, its message, its wait for the card and the errors it
lets through), ``profile`` (a ``torch.profiler`` trace in a directory), and
the iteration-log policy and table."""
import json

import numpy as np
import pytest
import torch

from lmc_atomi_torch.utils import trace as T
from lmc_atomi_tpu.utils import trace as J


@pytest.mark.parametrize("n_iters", [None, 1000])
def test_timer_reports_like_jax(capsys, n_iters):
    """The same message shape as the JAX package's ``Timer``, and the
    elapsed time and rate of the block."""
    with T.Timer("block", n_iters=n_iters) as t:
        torch.ones(64, 64).sum()
    got = capsys.readouterr().out.strip()
    with J.Timer("block", n_iters=n_iters) as j:
        pass
    want = capsys.readouterr().out.strip()
    assert got.split(":")[0] == want.split(":")[0] == "block"
    assert ("iters/s" in got) == ("iters/s" in want) == bool(n_iters)
    assert t.elapsed > 0 and j.elapsed > 0
    assert t.iters_per_sec == pytest.approx((n_iters or 0) / t.elapsed)


def test_timer_waits_for_the_card_and_lets_its_error_through(monkeypatch, capsys):
    """With a card, the exit synchronises the current device (that of the
    work) before the clock; an error raised there
    propagates (the JAX package's ``except Exception: pass`` would hide
    it), and a quiet timer prints nothing."""
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: seen.append(device))
    with T.Timer("x", quiet=True) as t:
        pass
    assert seen == [None] and t.elapsed is not None
    with T.Timer("x", sync=False, quiet=True):
        pass
    assert len(seen) == 1

    def fail(device=None):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.cuda, "synchronize", fail)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        with T.Timer("x"):
            pass
    assert capsys.readouterr().out == ""


def test_timer_passes_the_blocks_error_on():
    with pytest.raises(ValueError, match="inside"):
        with T.Timer("x", quiet=True):
            raise ValueError("inside")


def test_profile_writes_a_trace(tmp_path):
    """``profile(logdir)`` records the block's operators into
    ``logdir/trace.json`` (a Chrome trace) and yields the profiler."""
    logdir = tmp_path / "prof"
    with T.profile(str(logdir)) as prof:
        torch.fft.rfft2(torch.ones(32, 32)).abs().sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::_fft_r2c" in names
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::_fft_r2c" for e in events)


@pytest.mark.parametrize("n", [5, 10, 37, 200])
def test_should_log_and_table_match_jax(capsys, n):
    assert [T.should_log(i, n) for i in range(n)] == [J.should_log(i, n) for i in range(n)]
    series = {"psnr": np.linspace(10, 30, n), "loss": np.geomspace(1, 1e-3, n)}
    got = T.print_iteration_table({k: torch.from_numpy(v) for k, v in series.items()})
    want = J.print_iteration_table(series)
    assert got == want
    capsys.readouterr()
