"""Where the CT score branch's full-depth failure on the card comes from: the
score net's fit or the chain.

Fits the port's ``ScoreNet`` as ``experiments/ct.py`` does (key
``fold_in(0, 5)``, ladder 0.4 -> 0.05 in 8 levels, phantom patches) four
ways: 300 and 1500 steps on the card with the fit's CUDA graph, 1500 steps
on the card eagerly (no graph) and 1500 on the CPU; prints each net's
Tweedie denoising PSNR (``score_to_denoiser``) of the 128^2 phantom at
sigma 0.4 / 0.2 / 0.1 / 0.05 (noisy, denoised, finite). Then runs
``ct_tv_myula`` at its defaults (128^2, 30 angles, 2000 steps) with the score
branch on each 1500-step net, from the FBP start and from the MAP, and
prints the TV-MAP, TV-mean and score-ULA-mean PSNRs.

    python3 scripts/ct_score_nets_torch.py          # on the card
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from lmc_atomi_torch.core.random import fold_in, normal_field  # noqa: E402
from lmc_atomi_torch.eval.metrics import psnr  # noqa: E402
from lmc_atomi_torch.experiments import ct  # noqa: E402
from lmc_atomi_torch.models import dncnn, score as sc  # noqa: E402
from lmc_atomi_torch.utils.images import phantom  # noqa: E402

CUDA = torch.device("cuda", 0)
FIT = sc.train_score_net


def tweedie(model, dev):
    img = torch.from_numpy(phantom(128)).to(dev) / 255
    out = {}
    for s in (0.4, 0.2, 0.1, 0.05):
        y = img + s * normal_field(7, 0, 0, (128, 128), torch.float32, dev)
        d = sc.score_to_denoiser(sc.make_score_fn(model), s)(y)
        out[s] = [round(float(psnr(img, y)), 3), round(float(psnr(img, d)), 3),
                  bool(torch.isfinite(d).all())]
    return out


def fit(dev, steps, graphed=True):
    saved = dncnn.GRAPH_WARMUP
    if not graphed:
        dncnn.GRAPH_WARMUP = 10**9
    t0 = time.time()
    try:
        m, _ = FIT(fold_in(0, 5), sigma_max=0.4, sigma_min=0.05, n_sigmas=8, steps=steps,
                   arch="cnn", image_class="phantom", device=dev)
    finally:
        dncnn.GRAPH_WARMUP = saved
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return m, time.time() - t0


def main():
    nets = {}
    for name, dev, steps, graphed in [("cuda300", CUDA, 300, True),
                                      ("cuda1500", CUDA, 1500, True),
                                      ("cuda1500eager", CUDA, 1500, False),
                                      ("cpu1500", torch.device("cpu"), 1500, True)]:
        m, secs = fit(dev, steps, graphed)
        nets[name] = m.to(CUDA)
        print("NET", name, round(secs, 1), json.dumps(tweedie(nets[name], CUDA)), flush=True)
    for name in ("cuda1500", "cuda1500eager", "cpu1500"):
        ct.train_score_net = lambda *a, _m=nets[name], **k: (_m, None)
        for start in (False, True):
            t0 = time.time()
            _, _, rep = ct.ct_tv_myula(size=128, n_angles=30, compute_map=start, pnp=False,
                                       score_prior=True, device="cuda")
            print("CT", name, "map_start" if start else "fbp_start", rep.get("psnr_map_tv"),
                  rep["psnr_posterior_mean"], rep["psnr_score_mean"], round(time.time() - t0, 1),
                  flush=True)
    ct.train_score_net = FIT


if __name__ == "__main__":
    main()
