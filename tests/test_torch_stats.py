"""Port parity: streaming statistics of ``lmc_atomi_torch.core.stats`` against
``lmc_atomi_tpu.core.stats`` on identical f64 input streams, and the port's
counter-based Philox noise (known-answer vectors, distribution, counter
independence)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from lmc_atomi_torch.core.random import normal_field, philox4x32_10
from lmc_atomi_torch.core.stats import RunningMoments as TMoments
from lmc_atomi_torch.core.stats import RunningQuantile as TQuantile
from lmc_atomi_tpu.core.stats import RunningMoments, RunningQuantile

torch.set_num_threads(2)


_jit_update = jax.jit(lambda m, x: m.update(x))


def _stream(n, shape=(6, 5), seed=0):
    return np.random.default_rng(seed).standard_t(3, size=(n,) + shape)


@pytest.mark.parametrize("weights", ["all", "burn_in", "alternate"])
def test_running_moments_update_matches_jax(weights):
    xs = _stream(40)
    w = {"all": [1] * 40, "burn_in": [0] * 7 + [1] * 33,
         "alternate": [i % 2 for i in range(40)]}[weights]
    jm = RunningMoments.init(jnp.asarray(xs[0]))
    tm = TMoments.init(torch.from_numpy(xs[0]))
    update = jax.jit(lambda m, x, wi: m.update(x, weight=wi))
    for x, wi in zip(xs, w):
        jm = update(jm, jnp.asarray(x), wi)
        tm = tm.update(torch.from_numpy(x), weight=wi)
    assert tm.count == int(jm.count)
    np.testing.assert_allclose(tm.mean.numpy(), np.asarray(jm.mean), rtol=0, atol=1e-14)
    np.testing.assert_allclose(tm.m2.numpy(), np.asarray(jm.m2), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(tm.variance.numpy(), np.asarray(jm.variance), rtol=1e-13)
    np.testing.assert_allclose(tm.std.numpy(), np.asarray(jm.std), rtol=1e-13)


@pytest.mark.parametrize("split", [1, 17, 39])
def test_running_moments_merge_matches_jax(split):
    xs = _stream(40, seed=1)
    parts_j, parts_t = [], []
    for seg in (xs[:split], xs[split:]):
        jm = RunningMoments.init(jnp.asarray(xs[0]))
        tm = TMoments.init(torch.from_numpy(xs[0]))
        for x in seg:
            jm = _jit_update(jm, jnp.asarray(x))
            tm = tm.update(torch.from_numpy(x))
        parts_j.append(jm)
        parts_t.append(tm)
    jm = parts_j[0].merge(parts_j[1])
    tm = parts_t[0].merge(parts_t[1])
    assert tm.count == int(jm.count) == 40
    np.testing.assert_allclose(tm.mean.numpy(), np.asarray(jm.mean), atol=1e-14)
    np.testing.assert_allclose(tm.m2.numpy(), np.asarray(jm.m2), rtol=1e-13)
    # and the merge equals one pass over the whole stream
    np.testing.assert_allclose(tm.mean.numpy(), xs.mean(0), atol=1e-12)
    np.testing.assert_allclose(tm.variance.numpy(), xs.var(0, ddof=1), rtol=1e-11)


@pytest.mark.parametrize("p", [0.025, 0.5, 0.975])
def test_running_quantile_matches_jax(p):
    xs = _stream(120, seed=2)
    jq = RunningQuantile.init((6, 5), p, jnp.float64)
    tq = TQuantile.init((6, 5), p, torch.float64)
    update = jax.jit(lambda q, x: q.update(x))
    for x in xs:
        jq = update(jq, jnp.asarray(x))
        tq = tq.update(torch.from_numpy(x))
    assert tq.count == int(jq.count) == 120
    np.testing.assert_allclose(tq.heights.numpy(), np.asarray(jq.heights), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tq.positions.numpy(), np.asarray(jq.positions))
    np.testing.assert_allclose(tq.value.numpy(), np.asarray(jq.value), rtol=0, atol=1e-12)


# --- Philox noise --------------------------------------------------------------

M32 = 0xFFFFFFFF
# Random123 known-answer vectors for Philox4x32-10
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    c = tuple(torch.tensor([v], dtype=torch.int64) for v in ctr)
    got = tuple(int(w) for w in philox4x32_10(c, key))
    assert got == want


def test_normal_field_distribution_and_independence():
    z = normal_field(7, 0, 11, (256, 256), torch.float64, "cpu").ravel().numpy()
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1.0) < 0.02
    assert sps.kstest(z[::7][:8192], "norm").pvalue > 1e-3
    # other step, other chain, other seed: uncorrelated fields
    for args in ((7, 0, 12), (7, 1, 11), (8, 0, 11)):
        o = normal_field(*args, (256, 256), torch.float64, "cpu").ravel().numpy()
        assert abs(np.corrcoef(z, o)[0, 1]) < 0.02
    # pure function of (seed, chain, step, pixel): a sub-shape is a prefix
    again = normal_field(7, 0, 11, (4, 256), torch.float64, "cpu").ravel().numpy()
    np.testing.assert_array_equal(again, z[:1024])
