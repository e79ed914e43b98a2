"""The PnP-against-TV anchor on ONE shared observation, on the PyTorch port
(the counterpart of ``scripts/expt_pnp_anchor.py``, run for run and key for
key): ``assets/torch/results_pnp_anchor.json``.

Runs, all on the identical 256^2 blurred/noisy observation (same seed):
  1. a 64-chain PnP-ULA posterior (alpha=1.0) WITH the fused TV-MYULA
     baseline on a converged 20k-step budget (kernel 2 with in-kernel P^2
     CI markers) and the score-ULA baseline,
  2. an alpha ablation pair (1.0 vs 0.3) at 8 chains each.
The report has the JAX script's keys and the card's name and power limit
under ``device``. ``size``, ``burn_in``, ``train_steps``,
``score_train_steps``, ``depth``, ``features`` and ``device`` default to the
values the JAX script runs and shrink the run; the prior is trained once and
kept at ``params_path`` (relative paths are taken from the repo's root).

    python3 scripts/expt_pnp_anchor_torch.py      # on the card
    python3 scripts/expt_pnp_anchor_torch.py --size 16 --n_chains 2 --n_steps 10 \\
        --burn_in 2 --tv_steps 20 --ablation_chains 2 --train_steps 2 --score_train_steps 2 \\
        --depth 3 --features 8 --device cpu --out /tmp/anchor.json \\
        --params_path /tmp/anchor.pt

It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lmc_atomi_torch.experiments.pnp import pnp_ula_deblur  # noqa: E402
from lmc_atomi_torch.utils.cli import auto_cli, device_label, require_device  # noqa: E402

PARAMS = "runs/pnp_anchor/dncnn.pt"
OUT = "assets/torch/results_pnp_anchor.json"


def _path(p: str) -> Path:
    return Path(p) if os.path.isabs(p) else ROOT / p


def main(n_chains: int = 64, n_steps: int = 2000, tv_steps: int = 20000,
         tau_tv: float = 15.0, ablation_chains: int = 8, out: str = OUT,
         size: int = 256, burn_in: int = 200, train_steps: int = 1500,
         score_train_steps: int = 1500, depth: int = 8, features: int = 48,
         device: str = "cuda", params_path: str = PARAMS):
    require_device(device, "PnP anchor")
    label = device_label(device)
    params = _path(params_path)
    params.parent.mkdir(parents=True, exist_ok=True)
    net = dict(size=size, burn_in=burn_in, train_steps=train_steps, depth=depth,
               features=features, device=device, params_path=str(params), make_plots=False)
    t0 = time.perf_counter()
    # tau_tv=15 is the sweep winner on this observation (the JAX package's
    # 20k-step posterior-mean PSNR: tau 2/5/8/10/15/20 -> 15.9/23.9/25.7/
    # 26.1/26.2/26.0 dB): the anchor row must show the best TV can do
    _, _, rep = pnp_ula_deblur(
        n_chains=n_chains, n_steps=n_steps, tv_baseline=True, tau_tv_baseline=tau_tv,
        tv_steps=tv_steps, score_baseline=True, score_train_steps=score_train_steps, **net,
    )
    report = {
        "n_chains": n_chains, "n_steps": n_steps, "tv_steps": tv_steps,
        "tau_tv_baseline": tau_tv, "ablation_n_chains": ablation_chains,
        **{k: rep[k] for k in (
            "psnr_posterior_mean", "mean_ci_width",
            "psnr_tv_baseline_mean", "tv_baseline_ci_width",
            "psnr_score_mean", "score_ci_width",
            "lipschitz_certified_bound", "lipschitz_measured",
        )},
    }
    for alpha in (1.0, 0.3):
        _, _, r = pnp_ula_deblur(n_chains=ablation_chains, n_steps=n_steps, alpha=alpha,
                                 tv_baseline=False, **net)
        report[f"psnr_alpha_{alpha}"] = r["psnr_posterior_mean"]
    report.update(
        device=label, size=size, burn_in=burn_in, depth=depth, features=features,
        train_steps=train_steps, score_train_steps=score_train_steps,
        fit_seconds=rep["train_seconds"],
        score_fit_seconds=rep["score_train_seconds"],
        chain_steps_per_sec=rep["chain_steps_per_sec"],
        tv_baseline_steps_per_sec=rep["tv_baseline_steps_per_sec"],
        wall_seconds=time.perf_counter() - t0)
    path = _path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {path}", file=sys.stderr)
    print(json.dumps({"workload": "pnp_anchor", **report}), flush=True)
    return report


if __name__ == "__main__":
    auto_cli(main)
