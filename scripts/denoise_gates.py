"""Tolerance of the denoise-section test in ``tests/test_torch_make_results.py``,
from the JAX package.

Runs the JAX package's ``l1_denoise_myula`` at its published configuration
(64^2, sigma 0.2, 2000 MYULA steps, burn-in 200) on the CPU with float64 on,
as the test suite's ``conftest.py`` runs it, for seeds 0..7, and prints as
its last line one JSON object: the noisy and posterior-mean PSNRs of every
seed, their standard deviations over the seeds and the tolerance
``TOL_SD`` times the larger of the two, rounded up to 0.01 dB.

The seed moves the observation noise and the chain's noise, which the port
draws from other streams, so its PSNRs are one more draw of each: two draws
differ by sqrt(2) sd in law, and 4 sd is 2.8 of those.

    JAX_PLATFORMS=cpu python scripts/denoise_gates.py | tail -n 1
"""
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from lmc_atomi_tpu.experiments.denoise import l1_denoise_myula  # noqa: E402

SEEDS = tuple(range(8))
TOL_SD = 4.0


def main():
    t0 = time.perf_counter()
    rows = {}
    for s in SEEDS:
        _, rep = l1_denoise_myula(seed=s, make_plots=False)
        rows[s] = {k: rep[k] for k in ("psnr_noisy", "psnr_posterior_mean")}
    sd = {k: float(np.std([r[k] for r in rows.values()], ddof=1))
          for k in ("psnr_noisy", "psnr_posterior_mean")}
    tol = math.ceil(TOL_SD * max(sd.values()) * 100) / 100
    print(json.dumps({"seeds": rows, "sd": sd, "tol_sd": TOL_SD, "tol_db": tol,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
