"""BASELINE.json config 5 as written, on the PyTorch port: the 1024-chain
PnP-ULA credible-interval farm at 256^2, run as 16 independent 64-chain
processes (each under a time limit, each retried and resumable) that share
one trained SN-DnCNN prior and pool their Welford moments at the end. The
port's counterpart of ``scripts/expt_pnp1024.sh``, step for step:

1. train the prior once (``--train_only true --params_path P``), unless P
   exists;
2. run block b as ``python -m lmc_atomi_torch.experiments.pnp --n_chains 64
   --chain_block 64 --chain_offset b*64 --moments_out ...`` under
   ``BLOCK_TIMEOUT`` seconds, up to ``TRIES`` times; a block whose file
   exists is skipped, so a farm that was cut resumes where it stopped, and a
   block that fails every try ends the farm with a non-zero exit;
3. pool the blocks with ``experiments/pnp.py::pnp_merge``, which prints its
   JSON line; the block files carry a zero-padded index
   (``pnp_block_00.npz``), so the merge pools them in chain order.

The report (``pnp_merge``'s keys, as ``assets/results_pnp1024.json``, and
the card's name and power limit under ``device``, the seconds of the fit,
of each block and of the whole farm, and the chain-steps/s) goes to
``report``, by default ``assets/torch/results_pnp1024.json``. Relative paths
are taken from the repo's root. Each step's seconds are kept beside its file
in ``outdir``, so a farm run over several invocations reports all of them.

    python3 scripts/expt_pnp1024_torch.py                        # config 5, on the card
    python3 scripts/expt_pnp1024_torch.py --outdir runs/pnp1024  # the same: resumes
    python3 scripts/expt_pnp1024_torch.py --size 16 --depth 3 --features 8 \\
        --train_steps 2 --n_blocks 2 --block_chains 2 --n_steps 10 --burn_in 2 \\
        --device cpu --outdir /tmp/farm --report /tmp/farm/report.json

It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lmc_atomi_torch.experiments.pnp import pnp_merge  # noqa: E402
from lmc_atomi_torch.utils.cli import auto_cli, device_label, require_device  # noqa: E402

PNP = ["-m", "lmc_atomi_torch.experiments.pnp"]
# the JAX script's limits: seconds for the fit and for a block, tries of a
# block and seconds between them
TRAIN_TIMEOUT, BLOCK_TIMEOUT, TRIES, RETRY_SLEEP = 1800, 600, 3, 30.0


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _path(p: str) -> Path:
    return Path(p) if os.path.isabs(p) else ROOT / p


def train_args(params, size, depth, features, train_steps, device):
    """The training step's command line (``python`` + these)."""
    return [*PNP, "--train_only", "true", "--params_path", str(params), "--make_plots", "false",
            "--size", str(size), "--depth", str(depth), "--features", str(features),
            "--train_steps", str(train_steps), "--device", device]


def block_args(b, moments_out, params, block_chains, size, n_steps, burn_in, depth, features,
               device):
    """Block ``b``'s command line: chains ``b * block_chains`` onwards."""
    return [*PNP, "--n_chains", str(block_chains), "--chain_block", str(block_chains),
            "--chain_offset", str(b * block_chains), "--params_path", str(params),
            "--moments_out", str(moments_out), "--make_plots", "false", "--size", str(size),
            "--n_steps", str(n_steps), "--burn_in", str(burn_in), "--depth", str(depth),
            "--features", str(features), "--device", device]


def merge_args(pattern, out, size, device):
    """The merge's command line; the farm hands it to ``pnp_merge`` itself."""
    return [*PNP, "merge", "--pattern", str(pattern), "--out", str(out), "--size", str(size),
            "--device", device]


def block_name(b: int, n_blocks: int) -> str:
    return f"pnp_block_{b:0{max(2, len(str(n_blocks - 1)))}d}.npz"


def _run(args, timeout):
    """Run ``python args`` from the repo's root; ``(its last JSON line,
    seconds)``, or ``(None, seconds)`` if it failed or ran out of time (the
    child is killed then)."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, *args], cwd=ROOT, stdout=subprocess.PIPE,
                              text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        _log(f"timed out after {timeout} s: {' '.join(args)}")
        return None, time.perf_counter() - t0
    secs = time.perf_counter() - t0
    _log(proc.stdout.rstrip())
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        _log(f"exit {proc.returncode}: {' '.join(args)}")
        return None, secs
    return json.loads(lines[-1]), secs


def _save(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def farm(
    n_blocks: int = 16,
    block_chains: int = 64,
    size: int = 256,
    n_steps: int = 2000,
    burn_in: int = 200,
    depth: int = 8,
    features: int = 48,
    train_steps: int = 1500,
    device: str = "cuda",
    outdir: str = "runs/pnp1024",
    params_path: str = "",  # "" -> OUTDIR/pnp_params.pt
    report: str = "assets/torch/results_pnp1024.json",  # "" -> none
):
    """Train once, run the blocks that have no file yet, pool them; returns
    the report."""
    require_device(device, "PnP farm")
    label = device_label(device)
    out = _path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    params = _path(params_path) if params_path else out / "pnp_params.pt"
    shape = dict(size=size, depth=depth, features=features)

    if not params.exists():
        line, secs = _run(train_args(params, train_steps=train_steps, device=device, **shape),
                          TRAIN_TIMEOUT)
        if line is None:
            raise SystemExit(f"training the prior failed ({secs:.1f} s)")
        _save(out / "pnp_train.json", {"seconds": secs, "device": label, "line": line})
        _log(f"prior trained in {secs:.1f} s (fit {line['train_seconds']:.1f} s) [{label}]")

    for b in range(n_blocks):
        f = out / block_name(b, n_blocks)
        if f.exists():
            continue
        part = out / f"partial_{f.name}"
        for attempt in range(1, TRIES + 1):
            part.unlink(missing_ok=True)
            line, secs = _run(block_args(b, part, params, block_chains, n_steps=n_steps,
                                         burn_in=burn_in, device=device, **shape), BLOCK_TIMEOUT)
            if line is not None:
                os.replace(part, f)
                _save(f.with_suffix(".json"), {"seconds": secs, "tries": attempt,
                                               "device": label, "line": line})
                _log(f"block {b}: {secs:.1f} s, {line['chain_steps_per_sec']} chain-steps/s "
                     f"[{label}]")
                break
            _log(f"block {b} attempt {attempt} failed")
            if attempt < TRIES:
                time.sleep(RETRY_SLEEP)
        else:
            raise SystemExit(f"block {b} failed {TRIES} tries")

    t0 = time.perf_counter()
    merged = auto_cli(pnp_merge, merge_args(out / "pnp_block_*.npz", out / "pnp_1024_final.npz",
                                            size, device)[3:])
    merge_s = time.perf_counter() - t0
    blocks = [json.loads((out / block_name(b, n_blocks)).with_suffix(".json").read_text())
              for b in range(n_blocks)]
    train = (json.loads((out / "pnp_train.json").read_text())
             if (out / "pnp_train.json").exists() else None)
    block_s = [blk["seconds"] for blk in blocks]
    devices = sorted({label, *(blk["device"] for blk in blocks),
                      *([train["device"]] if train else [])})
    rep = {
        **merged,
        "device": devices[0] if len(devices) == 1 else devices,
        "size": size, "n_steps": n_steps, "burn_in": burn_in, "block_chains": block_chains,
        "depth": depth, "features": features, "train_steps": train_steps,
        "lipschitz_certified_bound": blocks[0]["line"]["lipschitz_certified_bound"],
        "lipschitz_measured": blocks[0]["line"]["lipschitz_measured"],
        "fit_seconds": train["line"]["train_seconds"] if train else None,
        "train_process_seconds": train["seconds"] if train else None,
        "block_seconds": block_s,
        "block_chain_steps_per_sec": [blk["line"]["chain_steps_per_sec"] for blk in blocks],
        "merge_seconds": merge_s,
        "wall_seconds": (train["seconds"] if train else 0.0) + sum(block_s) + merge_s,
        "chain_steps_per_sec": merged["n_chains"] * n_steps / sum(block_s),
    }
    if report:
        path = _path(report)
        path.parent.mkdir(parents=True, exist_ok=True)
        _save(path, rep)
        _log(f"wrote {path}")
    print(json.dumps({"workload": "pnp_farm", **rep}), flush=True)
    return rep


def main(argv=None):
    # a SIGTERM (a time limit around the farm) unwinds through subprocess.run,
    # which kills the running block before the farm exits
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    auto_cli(farm, argv)


if __name__ == "__main__":
    main()
