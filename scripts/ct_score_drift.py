"""The CT score branch's chain at its finest level, for many score nets
of both packages and several noise streams, and the test that compares the
two packages' nets.

``experiments/ct.py``'s score-ULA (annealed over the 200-step burn-in, then
2000 - 200 steps at sigma = 0.05, no corrector, tau = 0.5 / (L + 1 / sigma^2))
on the 128^2 / 30-angle problem, run by the port from the FBP start, with
each score net of ``--nets`` and each noise stream of ``--streams``. A net
``jax:s`` is the flax ``ScoreNet`` the JAX package trains at
``ct_tv_myula(seed=s)``'s key (carried over by
``interop.score_net_from_numpy``); ``port:s`` is the port's, fitted at the
port's key of that seed, as ``experiments/ct.py`` fits it; ``jaxfit:s`` is
the port's ``ScoreNet`` and ``fit`` started from the flax init of ``jax:s``
and fed the batches JAX's trainer draws for it (the port's training code on
JAX's draws). ``kind:a-b`` names the seeds ``a`` to ``b``. A stream
``port:w`` is the port's Philox ``normal_field`` under chain word ``w``,
``jax:k`` JAX's ``normal`` under key ``k``, injected as the step's normals.

With ``--net_dir`` a fitted net is saved there (``<kind>_<seed>.pt``, a
``state_dict``) and a saved one is loaded instead of fitted, so JAX's nets
fitted on a host with JAX (``--fit_only``) run in the chain on a card whose
machine has none. ``jax`` streams, ``jaxfit`` nets and fitting ``jax`` nets
import JAX (forced to the CPU); nothing else does.

Prints one JSON line a net and stream (``net``, ``stream``, the unrounded
``state_psnr`` and ``mean_psnr`` at the last step, ``trace``: step, state and
running-mean PSNR every 200 steps, ``fit_s``, ``chain_s``), also appended to
``--out``. Then, if ``--out``'s file holds ``jax`` and ``port`` nets under
one stream, the comparison: the one-sided Mann-Whitney U of the state PSNRs
(alternative: the port's lower), the states below ``DRIFT_DB`` of each
package with a one-sided Fisher exact test, and each package's mean;
``--summary`` writes it as JSON with the device
(``assets/torch/ct_score_study.json``, which the ct results section cites).
Which nets and which streams drift tells whether a drift is the net's, the
port's or the sampler's (the two packages' kernels agree under one injected
stream:
``tests/test_torch_learned_priors.py::test_sampler_matches_jax_injected_noise``).

    JAX_PLATFORMS=cpu python scripts/ct_score_drift.py --nets jax:0-31 --fit_only \\
        --net_dir runs/ct_score_nets                    # JAX's nets, on the CPU
    python3 scripts/ct_score_drift.py --nets jax:0-31,port:0-31 --streams port:7 \\
        --net_dir runs/ct_score_nets --device cuda --out runs/ct_score_study.jsonl \\
        --summary assets/torch/ct_score_study.json
    JAX_PLATFORMS=cpu python scripts/ct_score_drift.py --nets port:0,jax:1 --streams port:7
"""
import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

STREAMS = ("port:7", "port:11", "jax:0", "jax:1")
STEPS, BURN, SIGMA_MIN, N_SIGMAS = 2000, 200, 0.05, 8
DRIFT_DB = 17.0  # a state PSNR below this at the last step counts as a drift


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def jax_net(seed, device):
    jax = _jax()
    from lmc_atomi_torch.interop import score_net_from_numpy
    from lmc_atomi_tpu.models.score import train_score_net

    params, _, _ = train_score_net(jax.random.fold_in(jax.random.PRNGKey(seed), 5), sigma_max=0.4,
                                   sigma_min=SIGMA_MIN, n_sigmas=N_SIGMAS, steps=1500,
                                   arch="cnn", image_class="phantom")
    return score_net_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                dtype=torch.float32, device=device).eval()


def port_net(seed, device):
    from lmc_atomi_torch.core.random import fold_in
    from lmc_atomi_torch.models.score import train_score_net

    model, _ = train_score_net(fold_in(seed, 5), sigma_max=0.4, sigma_min=SIGMA_MIN,
                               n_sigmas=N_SIGMAS, steps=1500, arch="cnn", image_class="phantom",
                               device=device)
    return model


def jaxfit_net(seed, device):
    jax = _jax()
    import jax.numpy as jnp

    from lmc_atomi_torch.interop import score_net_from_numpy
    from lmc_atomi_torch.models.dncnn import fit
    from lmc_atomi_torch.models.score import score_loss
    from lmc_atomi_tpu.models.score import ScoreNet, geometric_sigmas
    from lmc_atomi_tpu.utils.synthetic import random_phantom_batch

    k_init, k_train = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 5))
    params = ScoreNet().init(k_init, jnp.zeros((1, 40, 40)), jnp.ones((1,)))
    model = score_net_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                 dtype=torch.float32, device=device)
    sigmas = geometric_sigmas(0.4, SIGMA_MIN, N_SIGMAS)

    @jax.jit
    def draw(i):  # train_score_net's train_step draws, batch 16 of 40 x 40
        k_img, k_lvl, k_noise = jax.random.split(jax.random.fold_in(k_train, i), 3)
        clean = random_phantom_batch(k_img, 16, 40)
        sig = sigmas[jax.random.randint(k_lvl, (16,), 0, N_SIGMAS)]
        return clean, sig, jax.random.normal(k_noise, clean.shape, clean.dtype)

    fit(model, lambda i: tuple(torch.from_numpy(np.array(a)).to(device) for a in draw(i)),
        score_loss, 1500, 1e-3)
    return model.eval()


FITS = {"jax": jax_net, "port": port_net, "jaxfit": jaxfit_net}


def get_net(kind, seed, device, net_dir=None):
    """The net ``kind:seed`` on ``device``: loaded from ``net_dir`` where it
    was saved, else fitted (and saved there)."""
    from lmc_atomi_torch.models.score import ScoreNet

    path = os.path.join(net_dir, f"{kind}_{seed}.pt") if net_dir else None
    if path and os.path.exists(path):
        net = ScoreNet().to(device=device, dtype=torch.float32)
        net.load_state_dict(torch.load(path, map_location=device))
        return net.eval()
    net = FITS[kind](seed, device)
    if path:
        os.makedirs(net_dir, exist_ok=True)
        torch.save(net.state_dict(), path)
    return net


def problem(device="cpu"):
    """The 128^2 / 30-angle problem on the port: image, data term, FBP start
    and the sigma and tau schedules (numpy, float32)."""
    from lmc_atomi_torch.core.random import normal_field
    from lmc_atomi_torch.ops.functionals import L2Data
    from lmc_atomi_torch.ops.linops import LinOp
    from lmc_atomi_torch.ops.radon import Radon2D, fbp
    from lmc_atomi_torch.utils.images import phantom

    img = (torch.from_numpy(phantom(128)) / 255.0).to(device)
    op = Radon2D.create((128, 128), n_angles=30, dtype=torch.float32, device=device)
    clean = op.matvec(img)
    sino = clean + 2.0 * normal_field(0, 0, 0, tuple(clean.shape), torch.float32, device)
    x0 = torch.clamp(fbp(op, sino, filter_name="hann"), min=0.0)
    probe = normal_field(0, 1, 0, (128, 128), torch.float32, device)
    lips = float(LinOp.max_gram_eig(op, probe=probe, iters=20)) / 4.0
    ladder = np.geomspace(0.4, SIGMA_MIN, N_SIGMAS).astype(np.float32)
    sig = np.concatenate([np.repeat(ladder, BURN // N_SIGMAS),
                          np.full(STEPS - BURN, SIGMA_MIN, np.float32)]).astype(np.float32)
    tau = (0.5 / (lips + 1.0 / sig**2)).astype(np.float32)
    return img, L2Data(op=op, b=sino, sigma=0.25), x0, sig, tau


KW = dict(alpha=1.0, box=(-1.0, 2.0), box_weight=SIGMA_MIN**2)


def _psnr(img, x):
    return float(10 * torch.log10(1.0 / torch.mean((img - x) ** 2)))


def run(net, stream, device="cpu", prob=None):
    """``(trace, state PSNR, mean PSNR)`` of the chain under ``net`` and
    ``stream``; ``trace`` every 200 steps, rounded to 0.01 dB."""
    import lmc_atomi_torch.kernels.imaging as t_img
    from lmc_atomi_torch.core.random import normal_field
    from lmc_atomi_torch.models.score import make_score_fn

    img, l2, x0, sig, tau = problem(device) if prob is None else prob
    kern = t_img.score_ula(l2.grad, make_score_fn(net), torch.from_numpy(sig).to(device),
                           torch.from_numpy(tau).to(device), **KW)
    kind, s = stream.split(":")
    if kind == "jax":
        jax = _jax()
        base = jax.random.PRNGKey(int(s))

        def noise(i):
            return torch.from_numpy(np.asarray(jax.random.normal(
                jax.random.fold_in(base, i), (128, 128), jax.numpy.float32))).to(device)
    else:
        def noise(i):
            return normal_field(0, int(s), i, (128, 128), torch.float32, device)
    saved = t_img._noise
    t_img._noise = lambda key, x, stream=0: noise(key[2])
    try:
        st = kern.init(x0.clone())
        mean, n, out = torch.zeros_like(img), 0, []
        for i in range(STEPS):
            st, _ = kern.step(st, (0, 0, st.step))
            if i >= BURN:
                n += 1
                mean += (st.position - mean) / n
            if (i + 1) % 200 == 0:
                out.append((i + 1, round(_psnr(img, st.position), 2),
                            round(_psnr(img, mean), 2) if n else None))
    finally:
        t_img._noise = saved
    return out, _psnr(img, st.position), _psnr(img, mean)


def expand(specs):
    """``kind:s`` and ``kind:a-b`` items of a comma list -> ``(kind, seed)``."""
    nets = []
    for spec in specs.split(","):
        kind, seeds = spec.split(":")
        lo, _, hi = seeds.partition("-")
        nets += [(kind, s) for s in range(int(lo), int(hi or lo) + 1)]
    return nets


def _rankable(v):
    return v if math.isfinite(v) else -math.inf


def decide(lines):
    """The comparison of the ``jax`` and ``port`` nets' state PSNRs under
    each stream (the last line of a net and stream counts): a dict a stream."""
    from scipy.stats import fisher_exact, mannwhitneyu

    last = {(r["net"], r["stream"]): r for r in lines}
    out = {}
    for stream in sorted({s for _, s in last}):
        by = {k: sorted(((int(n.split(":")[1]), _rankable(r["state_psnr"]), r["mean_psnr"])
                         for (n, s), r in last.items() if s == stream and n.startswith(k + ":")))
              for k in ("port", "jax")}
        if not by["port"] or not by["jax"]:
            continue
        port = [v for _, v, _ in by["port"]]
        jx = [v for _, v, _ in by["jax"]]
        u = mannwhitneyu(port, jx, alternative="less")
        below = [sum(v < DRIFT_DB for v in vals) for vals in (port, jx)]
        table = [[below[0], len(port) - below[0]], [below[1], len(jx) - below[1]]]
        out[stream] = {
            "n": [len(port), len(jx)],
            "mann_whitney_u": float(u.statistic), "p_mann_whitney": float(u.pvalue),
            "rejects": bool(u.pvalue < 0.05),
            "below_db": DRIFT_DB, "below": below,
            "p_fisher": float(fisher_exact(table, alternative="greater")[1]),
            "mean_state_psnr": [float(np.mean(port)), float(np.mean(jx))],
            "median_state_psnr": [float(np.median(port)), float(np.median(jx))],
            "mean_mean_psnr": [float(np.mean([m for *_, m in by[k]])) for k in ("port", "jax")],
            "port": by["port"], "jax": by["jax"],
        }
    return out


def _read(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nets", default="jax:0")
    ap.add_argument("--streams", default=",".join(STREAMS))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--net_dir", default=None)
    ap.add_argument("--fit_only", action="store_true", help="fit and save the nets, run no chain")
    ap.add_argument("--out", default=None, help="append each net's JSON line to this file")
    ap.add_argument("--summary", default=None,
                    help="write the comparison and the device here as JSON")
    args = ap.parse_args()
    dev = torch.device(args.device)
    prob = None if args.fit_only else problem(dev)
    for kind, seed in expand(args.nets):
        t0 = time.perf_counter()
        net = get_net(kind, seed, dev, args.net_dir)
        fit_s = time.perf_counter() - t0
        if args.fit_only:
            print(json.dumps({"net": f"{kind}:{seed}", "fit_s": round(fit_s, 1)}), flush=True)
            continue
        for stream in args.streams.split(","):
            t0 = time.perf_counter()
            trace, state, mean = run(net, stream, dev, prob)
            line = {"net": f"{kind}:{seed}", "stream": stream, "state_psnr": state,
                    "mean_psnr": mean, "trace": trace, "fit_s": round(fit_s, 1),
                    "chain_s": round(time.perf_counter() - t0, 1)}
            print(json.dumps(line), flush=True)
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    if args.out:
        verdict = decide(_read(args.out))
        if verdict:
            print(json.dumps(verdict), flush=True)
            _summary(args.summary, verdict, args.device)


def _summary(path, verdict, device):
    """``verdict`` and the chains' device (the card's name and power limit)
    at ``path``: ``scripts/make_results_torch.py``'s ct section cites it."""
    if not path or not verdict:
        return
    from lmc_atomi_torch.utils.cli import device_label

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"device": device_label(device), "drift_db": DRIFT_DB, "steps": STEPS,
                   "streams": verdict}, f, indent=1)


if __name__ == "__main__":
    main()
