"""The score net's training draws of the port against the JAX package's, in
distribution (the streams differ by design: Philox against threefry).

Each package draws from its own keys, as its ``train_score_net`` does at
``fold_in(0, 5)``: 256 steps of 16 phantom patches of 16^2 (4096 images),
their ladder levels and their noise, and the LeCun init of a ``ScoreNet``
under 4 keys. Two-sample KS and chi-square tests compare the per-image
mean, the share of pixels each image leaves at its background ramp, the
pixel-value histogram, the level counts, the noise (and its first four
moments), and each layer's init. The keys are fixed, so every statistic is
a fixed number; each threshold below is set from the measured value it
guards, which a draw of another distribution would move past.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from lmc_atomi_torch.core.random import chain_keys, fold_in
from lmc_atomi_torch.interop import score_net_from_numpy
from lmc_atomi_torch.models import score as t_score
from lmc_atomi_torch.models.dncnn import lecun_init
from lmc_atomi_torch.utils import synthetic as t_syn
from lmc_atomi_tpu.models import score as j_score
from lmc_atomi_tpu.utils.synthetic import random_phantom_batch

torch.set_num_threads(2)  # tier-1 runs several pytest workers on few cores

STEPS, BATCH, PATCH, N_SIGMAS, N_SHAPES = 256, 16, 16, 8, 6
# the smallest p-value a test may give (the measured ones are 0.044-0.97)
P_MIN = 1e-3
# the noise's moments: each package's mean, variance, skewness and excess
# kurtosis within Z_MAX standard errors of N(0, 1)'s (measured: |z| <= 1.06)
Z_MAX = 4.0
# a layer's init std, port over JAX (measured: 0.987-1.016 over 16 layers;
# the std of 1728 draws has a relative standard error of 1.7%)
STD_RATIO = 0.05


def _jax_key():
    return jax.random.fold_in(jax.random.PRNGKey(0), 5)


@pytest.fixture(scope="module")
def draws():
    """``{package: (clean (4096, 16, 16), level (4096,), z (4096 * 256,),
    background share (4096,))}``."""
    sigmas = t_score.geometric_sigmas(0.4, 0.05, N_SIGMAS)
    _, k_train = chain_keys(fold_in(0, 5), 2)
    steps = torch.arange(STEPS)
    clean, sig, z = t_score.draw_many(k_train, steps, sigmas, BATCH, PATCH)
    level = torch.searchsorted(-sigmas, -sig.reshape(-1))
    k_img = chain_keys(k_train, 3)[0]
    _, u = t_syn._uniforms((*k_img, steps), BATCH, 3 + 6 * N_SHAPES, torch.float32, None)
    clean = clean.reshape(-1, PATCH, PATCH).numpy()
    port = (clean, level.numpy(), z.reshape(-1).numpy(), _background(u.numpy()[:, :3], clean))

    _, k_train_j = jax.random.split(_jax_key())

    def step(i):  # lmc_atomi_tpu.models.score.train_score_net's train_step draws
        k_img, k_lvl, k_noise = jax.random.split(jax.random.fold_in(k_train_j, i), 3)
        clean = random_phantom_batch(k_img, BATCH, PATCH)
        return (clean, jax.random.randint(k_lvl, (BATCH,), 0, N_SIGMAS),
                jax.random.normal(k_noise, clean.shape, clean.dtype), _jax_ramps(k_img))

    jc, jl, jz, jr = (np.asarray(a) for a in jax.jit(jax.vmap(step))(jnp.arange(STEPS)))
    jc = jc.reshape(-1, PATCH, PATCH)
    return {"port": port,
            "jax": (jc, jl.reshape(-1), jz.reshape(-1), _background(jr.reshape(-1, 3), jc))}


def _jax_ramps(key):
    """The three uniforms of the background ramp that ``random_phantom``
    draws for each image of ``random_phantom_batch(key, BATCH, PATCH)``."""
    def one(k):
        _, kbg = jax.random.split(k)
        return jnp.stack([jax.random.uniform(kb, (), jnp.float32)
                          for kb in jax.random.split(kbg, 3)])

    return jax.vmap(one)(jax.random.split(key, BATCH))


def _background(ramp, clean):
    """Each image's share of pixels at its background ramp ``0.2 + 0.3 u0 +
    0.3 u1 x + 0.3 u2 y`` (clipped to [0, 1]) from its uniforms ``ramp``
    (images, 3): a painted shape holds one value, which meets the ramp at a
    pixel with probability ~0."""
    grid = np.arange(PATCH, dtype=np.float32) / PATCH
    u = [ramp[:, j, None, None] for j in range(3)]
    level = np.clip(0.2 + 0.3 * u[0] + 0.3 * u[1] * grid[None, None, :]
                    + 0.3 * u[2] * grid[None, :, None], 0.0, 1.0)
    return (np.abs(clean - level) < 1e-6).mean(axis=(1, 2))


def _pvalue(a, b):
    return stats.ks_2samp(a, b).pvalue


def test_phantom_means_and_background_share(draws):
    """Per-image mean and the share of pixels left at the background ramp
    (measured KS p: 0.38 and 0.43)."""
    (pc, _, _, pb), (jc, _, _, jb) = draws["port"], draws["jax"]
    assert _pvalue(pc.mean(axis=(1, 2)), jc.mean(axis=(1, 2))) > P_MIN
    assert _pvalue(pb, jb) > P_MIN
    assert abs(pb.mean() - jb.mean()) < 0.02  # measured: 0.4704 against 0.4675


def test_phantom_pixel_histogram(draws):
    """One pixel an image (image i at (7 i, 11 i) mod 16, so the samples are
    independent), in 16 bins over [0, 1]: chi-square (measured p: 0.18)."""
    idx = np.arange(STEPS * BATCH)
    edges = np.linspace(0.0, 1.0, 17)
    edges[-1] = np.nextafter(1.0, 2.0)  # 1.0 (clipped pixels) in the last bin
    counts = [np.histogram(c[idx, (7 * idx) % PATCH, (11 * idx) % PATCH], edges)[0]
              for c, *_ in (draws["port"], draws["jax"])]
    assert stats.chi2_contingency(counts)[1] > P_MIN


def test_noise_levels_uniform_over_ladder(draws):
    """The ladder level of each element: chi-square of the two packages'
    counts (measured p: 0.26), every level drawn."""
    counts = [np.bincount(d[1], minlength=N_SIGMAS) for d in (draws["port"], draws["jax"])]
    assert all(len(c) == N_SIGMAS and c.min() > 0 for c in counts)
    assert stats.chi2_contingency(counts)[1] > P_MIN


def test_noise_moments(draws):
    """The training noise: KS between the packages (measured p: 0.37) and
    the first four moments of each within Z_MAX standard errors of a
    standard normal's."""
    pz, jz = draws["port"][2], draws["jax"][2]
    assert _pvalue(pz, jz) > P_MIN
    for z in (pz, jz):
        n = len(z)
        moments = (z.mean(), z.var() - 1.0, stats.skew(z), stats.kurtosis(z))
        ses = (1.0, np.sqrt(2.0), np.sqrt(6.0), np.sqrt(24.0))
        for m, se in zip(moments, ses):
            assert abs(m) < Z_MAX * se / np.sqrt(n), moments


def test_init_std_of_each_layer():
    """Each layer of a ``ScoreNet`` at its init under 4 keys: the port's
    ``lecun_init`` against flax's ``init`` (carried over by
    ``score_net_from_numpy``), pooled weights by KS (measured p >= 0.044)
    and their standard deviations within STD_RATIO; every bias 0."""
    kinds = (torch.nn.Conv2d, torch.nn.Linear)
    port, jx = {}, {}
    for s in range(4):
        k_init, _ = chain_keys(fold_in(s, 5), 2)
        net = lecun_init(t_score.ScoreNet(), k_init)
        kj, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(s), 5))
        params = j_score.ScoreNet().init(kj, jnp.zeros((1, PATCH, PATCH)), jnp.ones((1,)))
        carried = score_net_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                       dtype=torch.float32)
        for out, model in ((port, net), (jx, carried)):
            for name, m in model.named_modules():
                if isinstance(m, kinds):
                    out.setdefault(name, []).append(m.weight.detach().double().reshape(-1))
                    assert not m.bias.any(), name
    assert len(port) == 16 and port.keys() == jx.keys()
    for name in port:
        a, b = torch.cat(port[name]).numpy(), torch.cat(jx[name]).numpy()
        assert _pvalue(a, b) > P_MIN, name
        assert abs(a.std() / b.std() - 1.0) < STD_RATIO, name
