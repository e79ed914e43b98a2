"""Port parity for the Radon operator and FBP (``ops/radon.py``), on the CPU:
each mode's projection and backprojection against the JAX package on the
same operator (``interop.radon_from_numpy``) and on the port's own
``Radon2D.create`` in f64, the adjoints, dense against gather, mass
preservation, the shear projector against the bilinear one, the automatic
mode, and ``fbp`` (mirrors ``tests/test_wavelet_radon.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.eval.metrics import psnr as t_psnr
from lmc_atomi_torch.ops import radon as t_radon
from lmc_atomi_torch.ops.linops import LinOp
from lmc_atomi_torch.ops.radon import Radon2D, fbp
from lmc_atomi_torch.utils.images import phantom
from lmc_atomi_tpu.ops.radon import Radon2D as JRadon2D
from lmc_atomi_tpu.ops.radon import fbp as j_fbp

torch.set_num_threads(2)

# relative to the largest entry, f64 on both sides: the dense and gather
# projectors sum the same products in another order, the shear projector
# also runs its FFTs in another library (and skips the last shear, whose
# line sums equal its input's)
TOL = {"dense": 1e-12, "gather": 1e-12, "shear": 1e-10}
CASES = [("dense", 24, 12), ("gather", 24, 12), ("shear", 32, 7), ("shear", 24, 13)]


def _t(a):
    return torch.from_numpy(np.array(a, np.float64))


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())


def _from_jax(jop):
    return interop.radon_from_numpy(
        np.asarray(jop.thetas), jop.shape, jop.mode,
        None if jop.dense is None else np.asarray(jop.dense),
        None if jop.shear_phis is None else np.asarray(jop.shear_phis), jop.shear_ks)


def _smooth(n):
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64)
    c = (n - 1) / 2
    img = np.exp(-(((yy - c - 6) / 9) ** 2 + ((xx - c + 4) / 7) ** 2))
    return img + 0.5 * np.exp(-(((yy - c + 10) / 5) ** 2 + ((xx - c - 8) / 6) ** 2))


@pytest.mark.parametrize("mode,n,n_angles", CASES)
def test_against_jax(mode, n, n_angles):
    """``matvec`` and ``rmatvec`` of the JAX operator carried across and of
    the port's own ``create``, against the JAX package's, and the adjoint."""
    jop = JRadon2D.create((n, n), n_angles=n_angles, dtype=jnp.float64, mode=mode)
    mine = Radon2D.create((n, n), n_angles=n_angles, dtype=torch.float64, mode=mode)
    assert mine.mode == mode and mine.shear_ks == jop.shear_ks
    np.testing.assert_allclose(mine.thetas.numpy(), np.asarray(jop.thetas), rtol=0, atol=1e-15)
    rng = np.random.default_rng(n_angles)
    x, y = rng.normal(size=(n, n)), rng.normal(size=(n_angles, n))
    want_x = jax.jit(jop.matvec)(jnp.asarray(x))
    want_y = jax.jit(jop.rmatvec)(jnp.asarray(y))
    for op in (_from_jax(jop), mine):
        ax, aty = op.matvec(_t(x)), op.rmatvec(_t(y))
        assert ax.shape == (n_angles, n) and aty.shape == (n, n)
        assert _rel(ax, want_x) < TOL[mode]
        assert _rel(aty, want_y) < TOL[mode]
        np.testing.assert_allclose(float(torch.sum(ax * _t(y))), float(torch.sum(_t(x) * aty)),
                                   rtol=1e-12)
    if mode == "dense":
        np.testing.assert_array_equal(mine.dense.numpy(), np.asarray(jop.dense))


def test_float32_operator_matches_jax():
    """The f32 angles, residual angles and dense matrix equal the JAX
    package's, and the f32 projections agree to f32 accuracy."""
    for mode in ("dense", "shear"):
        jop = JRadon2D.create((24, 24), n_angles=9, dtype=jnp.float32, mode=mode)
        mine = Radon2D.create((24, 24), n_angles=9, dtype=torch.float32, mode=mode)
        np.testing.assert_array_equal(mine.thetas.numpy(), np.asarray(jop.thetas))
        if mode == "dense":
            np.testing.assert_array_equal(mine.dense.numpy(), np.asarray(jop.dense))
        else:
            np.testing.assert_array_equal(mine.shear_phis.numpy(), np.asarray(jop.shear_phis))
        x = np.random.default_rng(0).normal(size=(24, 24)).astype(np.float32)
        got = mine.matvec(torch.from_numpy(x))
        assert _rel(got, jax.jit(jop.matvec)(jnp.asarray(x))) < 2e-6


def test_dense_equals_gather_and_repeats():
    """The dense matrix is the gather projector's exact linear map (both
    directions), and the gather adjoint gives the same bits twice."""
    rng = np.random.default_rng(0)
    dense = Radon2D.create((24, 24), n_angles=12, dtype=torch.float64, dense=True)
    gather = Radon2D.create((24, 24), n_angles=12, dtype=torch.float64, dense=False)
    assert dense.mode == "dense" and gather.mode == "gather" and gather.dense is None
    x, sino = _t(rng.normal(size=(24, 24))), _t(rng.normal(size=(12, 24)))
    np.testing.assert_allclose(dense.matvec(x).numpy(), gather.matvec(x).numpy(), atol=1e-10)
    np.testing.assert_allclose(dense.rmatvec(sino).numpy(), gather.rmatvec(sino).numpy(),
                               atol=1e-10)
    assert torch.equal(gather.rmatvec(sino), gather.rmatvec(sino))


def test_mass_preservation():
    """Every projection of a centred disc integrates to about its mass
    (bilinear); of a smooth image to its sum up to detector truncation
    (shear)."""
    op = Radon2D.create((33, 33), n_angles=8, dtype=torch.float64)
    yy, xx = np.mgrid[0:33, 0:33]
    disc = ((yy - 16) ** 2 + (xx - 16) ** 2 < 36).astype(np.float64)
    np.testing.assert_allclose(op.matvec(_t(disc)).sum(dim=1).numpy(), disc.sum(), rtol=0.02)
    img = _smooth(48)
    sino = Radon2D.create((48, 48), n_angles=9, dtype=torch.float64, mode="shear").matvec(_t(img))
    np.testing.assert_allclose(sino.sum(dim=1).numpy(), img.sum(), rtol=2e-3)


def test_shear_matches_bilinear_on_smooth_image():
    """Two discretisations of one operator: within 5e-3 of the largest
    projection on a smooth image, and equal at 0 and 90 degrees."""
    n, angles = 64, 12
    img = _t(_smooth(n))
    pg = Radon2D.create((n, n), n_angles=angles, dtype=torch.float64, mode="gather").matvec(img)
    ps = Radon2D.create((n, n), n_angles=angles, dtype=torch.float64, mode="shear").matvec(img)
    scale = float(pg.abs().max())
    assert float((ps - pg).abs().max()) < 5e-3 * scale
    for a in (0, angles // 2):
        np.testing.assert_allclose(ps[a].numpy(), pg[a].numpy(), atol=1e-9 * scale)


def test_auto_mode(monkeypatch):
    """Above the dense budget the shear projector, with no matrix; the
    budget counts the dtype's bytes (128^2 at 30 angles: dense in f32 and
    also in f64, 503 MB <= 512 MiB)."""
    op = Radon2D.create((256, 256), n_angles=90, dtype=torch.float32)
    assert op.mode == "shear" and op.dense is None and op._plan is None
    assert len(op.shear_ks) == 90 and set(op.shear_ks) == {0, 1, 2}
    assert Radon2D.create((64, 64), n_angles=10).mode == "dense"
    built = []
    monkeypatch.setattr(t_radon, "_dense_matrix", lambda *a, **k: built.append(a) or None)
    for dt in (torch.float32, torch.float64):
        assert Radon2D.create((128, 128), n_angles=30, dtype=dt).mode == "dense"
    assert len(built) == 2
    assert Radon2D.create((128, 128), n_angles=33, dtype=torch.float64).mode == "shear"
    with pytest.raises(ValueError, match="mode"):
        Radon2D.create((8, 8), n_angles=3, mode="fan")


@pytest.mark.parametrize("mode,filter_name,calibrate", [
    ("dense", "ramp", False), ("dense", "hann", True), ("gather", "ramp", True),
    ("shear", "hann", True)])
def test_fbp_against_jax(mode, filter_name, calibrate):
    n, n_angles = 32, 15
    jop = JRadon2D.create((n, n), n_angles=n_angles, dtype=jnp.float64, mode=mode)
    img = phantom(n, np.float64) / 255.0
    sino = np.asarray(jop.matvec(jnp.asarray(img))) \
        + 0.5 * np.random.default_rng(1).normal(size=(n_angles, n))
    want = j_fbp(jop, jnp.asarray(sino), filter_name=filter_name, calibrate=calibrate)
    got = fbp(_from_jax(jop), _t(sino), filter_name=filter_name, calibrate=calibrate)
    assert _rel(got, want) < TOL[mode]
    with pytest.raises(ValueError, match="filter"):
        fbp(_from_jax(jop), _t(sino), filter_name="cosine")


class TestFBP:
    """The properties ``tests/test_wavelet_radon.py::TestFBP`` holds the JAX
    package's ``fbp`` to, on the port's (f32)."""

    def _problem(self, n=64, n_angles=60, sigma=0.0, mode=None):
        from lmc_atomi_torch.core.random import normal_field

        img = torch.from_numpy(phantom(n, np.float32)) / 255.0
        op = Radon2D.create((n, n), n_angles=n_angles, mode=mode)
        sino = op.matvec(img)
        if sigma:
            sino = sino + sigma * normal_field(0, 0, 0, tuple(sino.shape), torch.float32, "cpu")
        return img, op, sino

    def test_reconstructs_much_better_than_backprojection(self):
        img, op, sino = self._problem()
        bp = op.rmatvec(sino)
        bp = bp / torch.clamp(LinOp.max_gram_eig(op, probe=bp, iters=20), min=1.0)
        rec = fbp(op, sino, filter_name="hann")
        assert float(t_psnr(img, rec)) > float(t_psnr(img, bp)) + 3.5
        assert float(t_psnr(img, rec)) > 16.0

    def test_hann_beats_ramp_under_noise(self):
        img, op, sino = self._problem(sigma=2.0)
        assert float(t_psnr(img, fbp(op, sino, filter_name="hann"))) > float(
            t_psnr(img, fbp(op, sino, filter_name="ramp")))

    def test_calibration_fixes_scale(self):
        _, op, sino = self._problem()
        r_raw = float(torch.linalg.norm(op.matvec(fbp(op, sino, calibrate=False)) - sino))
        r_cal = float(torch.linalg.norm(op.matvec(fbp(op, sino, calibrate=True)) - sino))
        assert r_cal <= r_raw + 1e-4

    def test_works_in_shear_mode(self):
        img, op, sino = self._problem(n=64, n_angles=45, mode="shear")
        rec = fbp(op, sino, filter_name="hann")
        assert torch.all(torch.isfinite(rec))
        assert float(t_psnr(img, rec)) > 14.0
