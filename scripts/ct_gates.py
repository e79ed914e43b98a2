"""PSNR gate of the CT score branch in ``chip_smoke.py``, from the JAX package.

Runs the JAX package's ``ct_tv_myula`` on the CPU at the configuration
``CONFIG`` (128^2, 30 angles on the dense projector, the FBP start with no
MAP, no PnP, annealed score-ULA with one corrector sweep a step after a
short fit of the score CNN, every other keyword its CLI default, f32) for
seeds 0..3 and prints as its last line (the CLI prints its JSON lines
before it) one JSON object: the configuration, the seconds the run took,
the FBP and score-ULA PSNRs of every seed and the gate
``[min - 1 dB, max + 1 dB]`` of the score-ULA posterior mean over them.

The seeds move the sinogram noise, the training data, the net's initial
weights and the chains' noise, all of which the port draws from other
streams, so the gate spans what the JAX package does from several draws;
the 1 dB margin is the repo's rule for a port PSNR against the JAX
package's.

    JAX_PLATFORMS=cpu python scripts/ct_gates.py | tail -n 1 > gates.json
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from lmc_atomi_tpu.experiments.ct import ct_tv_myula  # noqa: E402

SEEDS = (0, 1, 2, 3)
MARGIN_DB = 1.0
CONFIG = dict(size=128, n_angles=30, n_steps=400, burn_in=200, compute_map=False, pnp=False,
              score_prior=True, score_train_steps=300, pc_correctors=1)


def main():
    seeds = tuple(int(s) for s in sys.argv[1:]) or SEEDS
    t0 = time.perf_counter()
    fbp, score = [], []
    for seed in seeds:
        t = time.perf_counter()
        _, _, report = ct_tv_myula(seed=seed, make_plots=False, **CONFIG)
        fbp.append(report["psnr_fbp"])
        score.append(report["psnr_score_mean"])
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s, FBP {fbp[-1]}, score {score[-1]}",
              file=sys.stderr, flush=True)
    print(json.dumps({"config": CONFIG, "seeds": list(seeds),
                      "seconds": round(time.perf_counter() - t0, 1), "fbp": fbp,
                      "score": {"psnr": score,
                                "gate": [min(score) - MARGIN_DB, max(score) + MARGIN_DB]}}))


if __name__ == "__main__":
    main()
