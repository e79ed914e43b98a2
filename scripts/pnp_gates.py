"""PSNR gates of the PnP phase of ``chip_smoke.py``, from the JAX package.

Runs the JAX package's ``pnp_ula_deblur`` on the CPU at the configuration
``CONFIG`` (128^2, 4 chains, 600 steps, 400 training steps for the DnCNN and
for the score U-Net, TV anchor and score baseline on, every other keyword
its CLI default, f32) for seeds 0..3 and prints as its last line (the CLI
prints its summaries before it) one JSON object: the configuration, the
seconds the run took, and for each prior (``pnp``, ``tv``, ``score``) the
posterior-mean PSNR of every seed and the gate ``[min - 1 dB, max + 1 dB]``
over them; ``blurred`` holds the observations' PSNRs.

The seeds move the training data, the nets' initial weights, the
observation noise and the chains' noise, all of which the port draws from
other streams, so the gates span what the JAX package does from several
draws; the 1 dB margin is the repo's rule for a port PSNR against the JAX
package's.

    JAX_PLATFORMS=cpu python scripts/pnp_gates.py | tail -n 1 > gates.json
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from lmc_atomi_tpu.experiments.pnp import pnp_ula_deblur  # noqa: E402

SEEDS = (0, 1, 2, 3)
MARGIN_DB = 1.0
CONFIG = dict(size=128, n_chains=4, n_steps=600, train_steps=400,
              score_train_steps=400, tv_baseline=True, score_baseline=True,
              score_arch="unet")
KEYS = {"pnp": "psnr_posterior_mean", "tv": "psnr_tv_baseline_mean",
        "score": "psnr_score_mean", "blurred": "psnr_blurred"}


def main():
    t0 = time.perf_counter()
    rows = {k: [] for k in KEYS}
    for seed in SEEDS:
        t = time.perf_counter()
        _, _, report = pnp_ula_deblur(seed=seed, make_plots=False, **CONFIG)
        for k, field in KEYS.items():
            rows[k].append(report[field])
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s",
              {k: v[-1] for k, v in rows.items()}, file=sys.stderr, flush=True)
    out = {"config": CONFIG, "seeds": list(SEEDS),
           "seconds": round(time.perf_counter() - t0, 1), "blurred": rows["blurred"]}
    for k in ("pnp", "tv", "score"):
        out[k] = {"psnr": rows[k],
                  "gate": [min(rows[k]) - MARGIN_DB, max(rows[k]) + MARGIN_DB]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
