"""The PnP anchor's score-ULA baseline with the JAX package's score net in
place of the port's: whether the anchor's low score reading
(``assets/torch/results_pnp_anchor.json``, ``psnr_score_mean``) is the net's
or the chain's.

``--fit_only`` (JAX on the CPU) fits the flax ``ScoreNet`` that the JAX
anchor (``scripts/expt_pnp_anchor.py``) trains: key ``fold_in(kd, 11)``,
``kd`` the first of ``split(PRNGKey(0), 3)``, ladder 0.4 -> 0.05 in 8
levels, 1500 steps, ``cnn``, ``phantom``; it is carried over by
``interop.score_net_from_numpy`` and saved as a ``state_dict`` at
``--net``. Without it (the card's machine needs no JAX), the anchor's first
run (``scripts/expt_pnp_anchor_torch.py``: 256^2, 64 chains, 2000 steps,
burn-in 200, the DnCNN of depth 8, width 48 at ``--params_path``) runs with
its score baseline under the port's own net and under the saved JAX net
(``experiments.pnp.train_score_net`` patched to return it), the TV baseline
off; one JSON line a net, and the last line both readings.

    JAX_PLATFORMS=cpu python scripts/pnp_anchor_jax_score.py --fit_only
    python3 scripts/pnp_anchor_jax_score.py                 # on the card
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

NET = "runs/pnp_anchor/jax_score.pt"
PARAMS = "runs/pnp_anchor/dncnn.pt"  # the anchor's DnCNN (expt_pnp_anchor_torch.py)
SIGMA_MAX, SIGMA_MIN, N_SIGMAS, STEPS = 0.4, 0.05, 8, 1500


def _path(p: str) -> Path:
    return Path(p) if os.path.isabs(p) else ROOT / p


def fit_jax_net(path: Path) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from lmc_atomi_torch.interop import score_net_from_numpy
    from lmc_atomi_tpu.models.score import train_score_net

    kd, _, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    params, _, _ = train_score_net(jax.random.fold_in(kd, 11), sigma_max=SIGMA_MAX,
                                   sigma_min=SIGMA_MIN, n_sigmas=N_SIGMAS, steps=STEPS,
                                   arch="cnn", image_class="phantom")
    net = score_net_from_numpy(jax.tree_util.tree_map(np.asarray, params), dtype=torch.float32)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(net.state_dict(), path)


def anchor_score(device: str, params_path: Path, net_path: Path = None) -> dict:
    """The anchor's first run with its score baseline, under the saved net
    at ``net_path`` if given, else the port's own fit."""
    import lmc_atomi_torch.experiments.pnp as pnp
    from lmc_atomi_torch.models.score import ScoreNet, geometric_sigmas

    fit = pnp.train_score_net
    if net_path is not None:
        def loaded(key, sigma_max, sigma_min, n_sigmas, dtype, device, **_):
            net = ScoreNet().to(device=device, dtype=dtype)
            net.load_state_dict(torch.load(net_path, map_location=device))
            return net.eval(), geometric_sigmas(sigma_max, sigma_min, n_sigmas, dtype, device)

        pnp.train_score_net = loaded
    try:
        t0 = time.perf_counter()
        _, _, rep = pnp.pnp_ula_deblur(
            size=256, n_chains=64, n_steps=2000, burn_in=200, train_steps=1500, depth=8,
            features=48, tv_baseline=False, score_baseline=True, score_train_steps=STEPS,
            device=device, params_path=str(params_path), make_plots=False)
    finally:
        pnp.train_score_net = fit
    return {k: rep[k] for k in ("psnr_posterior_mean", "psnr_score_mean", "score_ci_width",
                                "score_steps_per_sec")} | {"seconds": time.perf_counter() - t0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fit_only", action="store_true")
    ap.add_argument("--net", default=NET)
    ap.add_argument("--params_path", default=PARAMS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    net_path = _path(args.net)
    if args.fit_only:
        fit_jax_net(net_path)
        return
    from lmc_atomi_torch.utils.cli import device_label, require_device

    require_device(args.device, "PnP anchor")
    params = _path(args.params_path)
    params.parent.mkdir(parents=True, exist_ok=True)
    out = {"device": device_label(args.device)}
    for name, path in (("port", None), ("jax", net_path)):
        out[name] = anchor_score(args.device, params, path)
        print(json.dumps({"net": name, **out[name]}), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
