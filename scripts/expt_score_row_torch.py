"""The learned-prior (score) row of the 512^2 deconvolution on the PyTorch
port: ``experiments/deconv.py``'s CLI with the flags of the JAX package's
recorded run of that row (``scripts/tpu_drive_r4.py:65-69``):

    --size 512 --image hopper --n_steps 20000 --alg MYULA --score_row true
    --collect_metrics false --make_plots false

The report (the TV, ME-TV and score-ULA posterior-mean PSNRs of the k5 blur,
every model's PSNR, the iters/s of each row, the run's seconds and the
card's name and power limit) goes to ``out``, by default
``assets/torch/results_score_hopper.json`` (relative paths are taken from
the repo's root).

    python3 scripts/expt_score_row_torch.py

It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lmc_atomi_torch.experiments.deconv import prox_lmc_deconv  # noqa: E402
from lmc_atomi_torch.utils.cli import auto_cli, device_label, require_device  # noqa: E402

ROWS = {"tv": "M1 (k5-TV)", "metv": "M3 (k5-METV)", "score": "M_score (k5-SCORE)"}
IMAGE, SIZE, N_STEPS = "hopper", 512, 20000
SCORE_TRAIN_STEPS = 4000  # the deconvolution CLI's default
OUT = ROOT / "assets" / "torch" / f"results_score_{IMAGE}.json"


def cli_args(device):
    """The deconvolution CLI's arguments of this run."""
    return ["--size", str(SIZE), "--image", IMAGE, "--n_steps", str(N_STEPS),
            "--alg", "MYULA", "--score_row", "true", "--collect_metrics", "false",
            "--make_plots", "false", "--score_train_steps", str(SCORE_TRAIN_STEPS),
            "--device", device]


def score_row(device: str = "cuda", out: str = ""):
    """Run the row through the CLI and write its report to ``out`` (``""``:
    ``OUT``); returns it."""
    require_device(device, "score row")
    label = device_label(device)
    t0 = time.perf_counter()
    _, _, summ = auto_cli(prox_lmc_deconv, cli_args(device))
    seconds = time.perf_counter() - t0
    psnr = {m: v["psnr"] for m, v in summ["report"].items()}
    rep = {
        "image": IMAGE, "size": SIZE, "n_steps": N_STEPS, "alg": "MYULA",
        "score_train_steps": SCORE_TRAIN_STEPS,
        **{f"psnr_{k}_mean": psnr[m] for k, m in ROWS.items()},
        "psnr_blurred": summ["psnr_blurred"],
        "psnr": psnr,
        "iters_per_sec": summ["iters_per_sec"],
        "seconds": seconds,
        "device": label,
    }
    path = Path(out) if out else OUT
    path = path if path.is_absolute() else ROOT / path
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rep, indent=1) + "\n")
    print(json.dumps({"workload": "score_row", **rep}), flush=True)
    return rep


if __name__ == "__main__":
    auto_cli(score_row)
