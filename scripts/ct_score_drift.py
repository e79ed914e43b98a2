"""The CT score branch's chain at its finest level, under several noise streams.

``experiments/ct.py``'s score-ULA (annealed over the 200-step burn-in, then
2000 - 200 steps at sigma = 0.05, no corrector, tau = 0.5 / (L + 1 / sigma^2))
on the 128^2 / 30-angle problem, run by the port on the CPU from the FBP
start, with each score net of ``--nets`` and each noise stream of
``--streams``. A net ``jax:s`` is the flax ``ScoreNet`` the JAX package
trains at ``ct_tv_myula(seed=s)``'s key (carried over by
``interop.score_net_from_numpy``); ``port:s`` is the port's, fitted on the
CPU at the port's key of that seed, as ``experiments/ct.py`` fits it;
``jaxfit:s`` is the port's ``ScoreNet`` and ``fit`` started from the flax
init of ``jax:s`` and fed the batches JAX's trainer draws for it (the
port's training code on JAX's draws). A stream ``port:w`` is the port's Philox ``normal_field`` under chain word
``w``, ``jax:k`` JAX's ``normal`` under key ``k``, injected as the step's
normals. Prints one line a net and stream: the PSNR of the chain's state
and of its running mean every 200 steps. Which nets and which streams
drift tells whether a drift is the net's, the port's or the sampler's (the
two packages' kernels agree under one injected stream:
``tests/test_torch_learned_priors.py::test_sampler_matches_jax_injected_noise``).

    JAX_PLATFORMS=cpu python scripts/ct_score_drift.py
    JAX_PLATFORMS=cpu python scripts/ct_score_drift.py --nets port:0,jax:1 --streams port:7
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

STREAMS = ("port:7", "port:11", "jax:0", "jax:1")
STEPS, BURN, SIGMA_MIN, N_SIGMAS = 2000, 200, 0.05, 8


def jax_net(seed):
    from lmc_atomi_torch.interop import score_net_from_numpy
    from lmc_atomi_tpu.models.score import train_score_net

    params, _, _ = train_score_net(jax.random.fold_in(jax.random.PRNGKey(seed), 5), sigma_max=0.4,
                                   sigma_min=SIGMA_MIN, n_sigmas=N_SIGMAS, steps=1500,
                                   arch="cnn", image_class="phantom")
    return score_net_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                dtype=torch.float32, device="cpu").eval()


def port_net(seed):
    from lmc_atomi_torch.core.random import fold_in
    from lmc_atomi_torch.models.score import train_score_net

    model, _ = train_score_net(fold_in(seed, 5), sigma_max=0.4, sigma_min=SIGMA_MIN,
                               n_sigmas=N_SIGMAS, steps=1500, arch="cnn", image_class="phantom",
                               device="cpu")
    return model


def jaxfit_net(seed):
    import jax.numpy as jnp

    from lmc_atomi_torch.interop import score_net_from_numpy
    from lmc_atomi_torch.models.dncnn import fit
    from lmc_atomi_torch.models.score import score_loss
    from lmc_atomi_tpu.models.score import ScoreNet, geometric_sigmas
    from lmc_atomi_tpu.utils.synthetic import random_phantom_batch

    k_init, k_train = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 5))
    params = ScoreNet().init(k_init, jnp.zeros((1, 40, 40)), jnp.ones((1,)))
    model = score_net_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                 dtype=torch.float32, device="cpu")
    sigmas = geometric_sigmas(0.4, SIGMA_MIN, N_SIGMAS)

    @jax.jit
    def draw(i):  # train_score_net's train_step draws, batch 16 of 40 x 40
        k_img, k_lvl, k_noise = jax.random.split(jax.random.fold_in(k_train, i), 3)
        clean = random_phantom_batch(k_img, 16, 40)
        sig = sigmas[jax.random.randint(k_lvl, (16,), 0, N_SIGMAS)]
        return clean, sig, jax.random.normal(k_noise, clean.shape, clean.dtype)

    fit(model, lambda i: tuple(torch.from_numpy(np.array(a)) for a in draw(i)), score_loss,
        1500, 1e-3)
    return model.eval()


def problem():
    """The 128^2 / 30-angle problem on the port: image, data term, FBP start
    and the sigma and tau schedules (numpy, float32)."""
    from lmc_atomi_torch.core.random import normal_field
    from lmc_atomi_torch.ops.functionals import L2Data
    from lmc_atomi_torch.ops.linops import LinOp
    from lmc_atomi_torch.ops.radon import Radon2D, fbp
    from lmc_atomi_torch.utils.images import phantom

    img = torch.from_numpy(phantom(128)) / 255.0
    op = Radon2D.create((128, 128), n_angles=30, dtype=torch.float32, device="cpu")
    clean = op.matvec(img)
    sino = clean + 2.0 * normal_field(0, 0, 0, tuple(clean.shape), torch.float32, "cpu")
    x0 = torch.clamp(fbp(op, sino, filter_name="hann"), min=0.0)
    probe = normal_field(0, 1, 0, (128, 128), torch.float32, "cpu")
    lips = float(LinOp.max_gram_eig(op, probe=probe, iters=20)) / 4.0
    ladder = np.geomspace(0.4, SIGMA_MIN, N_SIGMAS).astype(np.float32)
    sig = np.concatenate([np.repeat(ladder, BURN // N_SIGMAS),
                          np.full(STEPS - BURN, SIGMA_MIN, np.float32)]).astype(np.float32)
    tau = (0.5 / (lips + 1.0 / sig**2)).astype(np.float32)
    return img, L2Data(op=op, b=sino, sigma=0.25), x0, sig, tau


KW = dict(alpha=1.0, box=(-1.0, 2.0), box_weight=SIGMA_MIN**2)


def _psnr(img, x):
    return round(float(10 * torch.log10(1.0 / torch.mean((img - x) ** 2))), 2)


def run(net, stream):
    import lmc_atomi_torch.kernels.imaging as t_img
    from lmc_atomi_torch.core.random import normal_field
    from lmc_atomi_torch.models.score import make_score_fn

    img, l2, x0, sig, tau = problem()
    kern = t_img.score_ula(l2.grad, make_score_fn(net), torch.from_numpy(sig),
                           torch.from_numpy(tau), **KW)
    kind, s = stream.split(":")
    if kind == "jax":
        base = jax.random.PRNGKey(int(s))

        def noise(i):
            return torch.from_numpy(np.asarray(jax.random.normal(
                jax.random.fold_in(base, i), (128, 128), jax.numpy.float32)))
    else:
        def noise(i):
            return normal_field(0, int(s), i, (128, 128), torch.float32, "cpu")
    saved = t_img._noise
    t_img._noise = lambda key, x, stream=0: noise(key[2])
    try:
        st = kern.init(x0)
        mean, n, out = torch.zeros_like(img), 0, []
        for i in range(STEPS):
            st, _ = kern.step(st, (0, 0, st.step))
            if i >= BURN:
                n += 1
                mean += (st.position - mean) / n
            if (i + 1) % 200 == 0:
                out.append((i + 1, _psnr(img, st.position), _psnr(img, mean) if n else None))
    finally:
        t_img._noise = saved
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nets", default="jax:0")
    ap.add_argument("--streams", default=",".join(STREAMS))
    args = ap.parse_args()
    for spec in args.nets.split(","):
        kind, seed = spec.split(":")
        net = {"jax": jax_net, "port": port_net, "jaxfit": jaxfit_net}[kind](int(seed))
        for stream in args.streams.split(","):
            print(spec, stream, run(net, stream), flush=True)


if __name__ == "__main__":
    main()
