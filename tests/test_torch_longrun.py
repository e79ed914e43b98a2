"""Checkpointed long runs in the port (``run/longrun.py``,
``core/checkpoint.py``) on the CPU, f64: a run stopped after its first
segments and restarted from the checkpoint equals the straight run (the
position bit for bit, since the noise is keyed by the global step; the
merged moments to roundoff), a diverging chain raises, and the farm across
devices, not ported yet, raises ``NotImplementedError``. The tiled runners'
checkpointed runs are held in ``tests/test_torch_tiled.py``, the chain
farm's in ``tests/test_torch_multichain.py``."""
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.core.checkpoint import restore_checkpoint, save_checkpoint
from lmc_atomi_torch.core.state import SamplerState
from lmc_atomi_torch.core.stats import RunningMoments
from lmc_atomi_torch.kernels.imaging import ULPDAExtras, myula_imaging
from lmc_atomi_torch.ops.functionals import L2Data, OrthogonalL1, TVNorm
from lmc_atomi_torch.ops.linops import CirculantBlur2D, uniform_kernel
from lmc_atomi_torch.ops.wavelet import HaarDWT2D
from lmc_atomi_torch.run.longrun import run_resumable, run_resumable_fused
from lmc_atomi_tpu.utils.images import phantom

torch.set_num_threads(2)

N = 32
# the Chan merge of per-segment moments against one Welford stream
MOMENT_TOL = 1e-12


def _close(got, want, tol, name=""):
    want = want.numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=name)


def _tv_problem():
    img = torch.from_numpy(phantom(N, np.float64))
    blur = CirculantBlur2D.from_kernel((N, N), uniform_kernel(5, torch.float64))
    rng = np.random.default_rng(0)
    y = blur.matvec(img) + 0.75 * torch.from_numpy(rng.normal(size=(N, N)))
    return L2Data.create(op=blur, b=y, sigma=1 / 0.75**2), 0.3, 0.75**2


def _wavelet_problem():
    rng = np.random.default_rng(1)
    img = phantom(N, np.float64) / 255.0
    mask = (rng.uniform(size=(N, N)) > 0.5).astype(np.float64)
    y = mask * img + 0.1 * mask * rng.normal(size=(N, N))
    return interop.mask_l2_from_numpy(mask, y, 1 / 0.1**2), 5.0, 0.1**2


PROBLEMS = {"tv": _tv_problem, "wavelet": _wavelet_problem}


@pytest.mark.parametrize("runner,quantiles", [("tv", ()), ("tv", (0.1, 0.9)),
                                              ("wavelet", ()),
                                              ("wavelet", (0.025, 0.975))])
def test_resumable_fused_restart_equals_straight_run(tmp_path, runner, quantiles):
    """24 steps in segments of 8: stopped after 2 segments (the checkpoint
    written), restarted from the checkpoint, against one straight call."""
    l2, lam, gamma = PROBLEMS[runner]()
    kw = dict(runner=runner, burn_in=5, quantiles=quantiles)
    if runner == "wavelet":
        kw["levels"] = 2
    args = (l2, lam, 0.2 * gamma, gamma, l2.b, (4, 1))
    straight = run_resumable_fused(*args, 24, 24, **kw)
    ckpt = str(tmp_path / "run.ckpt")
    seen = []
    first = run_resumable_fused(*args, 16, 8, ckpt_path=ckpt,
                                progress=lambda done, b: seen.append(done), **kw)
    assert seen == [8, 16] and first["done"] == 16
    resumed = run_resumable_fused(*args, 24, 8, ckpt_path=ckpt,
                                  progress=lambda done, b: seen.append(done), **kw)
    assert seen == [8, 16, 24] and resumed["done"] == 24
    assert torch.equal(resumed["position"], straight["position"])
    assert resumed["moments"].count == straight["moments"].count == 19
    _close(resumed["moments"].mean, straight["moments"].mean, MOMENT_TOL, "mean")
    _close(resumed["moments"].m2, straight["moments"].m2, MOMENT_TOL, "m2")
    if quantiles:
        for p in quantiles:
            assert torch.equal(resumed["quantiles"][p], straight["quantiles"][p])


def test_run_resumable_kernel_restart_equals_straight_run(tmp_path):
    """``run_resumable`` over the unfused wavelet MYULA kernel: the sampler
    state and moments ride the checkpoint."""
    l2, lam, gamma = _wavelet_problem()
    kern = myula_imaging(l2, OrthogonalL1(op=HaarDWT2D(levels=2), sigma=lam),
                         0.2 * gamma, gamma)
    straight = run_resumable(kern, l2.b, (2, 0), 12, 12, burn_in=3)
    ckpt = str(tmp_path / "k.ckpt")
    run_resumable(kern, l2.b, (2, 0), 6, 3, ckpt_path=ckpt, burn_in=3)
    resumed = run_resumable(kern, l2.b, (2, 0), 12, 3, ckpt_path=ckpt, burn_in=3)
    assert resumed["done"] == 12 and resumed["state"].step == 12
    assert torch.equal(resumed["state"].position, straight["state"].position)
    assert resumed["moments"].count == straight["moments"].count == 9
    _close(resumed["moments"].mean, straight["moments"].mean, MOMENT_TOL, "mean")


def test_checkpoint_round_trip(tmp_path):
    """Dataclasses, NamedTuples, None, tuples and scalars come back in the
    template's types; tensors on the template's device."""
    x = torch.arange(6.0).reshape(2, 3)
    bundle = {"state": SamplerState(position=x, step=4,
                                    extras=ULPDAExtras(y=x + 1, xbar=x * 2)),
              "moments": RunningMoments(count=3, mean=x, m2=x * x),
              "key": (5, 2), "done": 7, "q": None}
    path = str(tmp_path / "b.ckpt")
    save_checkpoint(path, bundle)
    template = {"state": SamplerState(position=torch.zeros(2, 3),
                                      extras=ULPDAExtras(y=None, xbar=None)),
                "moments": RunningMoments.init(torch.zeros(2, 3)),
                "key": (0, 0), "done": 0, "q": None}
    got = restore_checkpoint(path, template)
    assert got["key"] == (5, 2) and got["done"] == 7 and got["q"] is None
    assert got["state"].step == 4 and got["state"].extras.xprev is None
    assert isinstance(got["state"].extras, ULPDAExtras)
    assert torch.equal(got["state"].extras.xbar, x * 2)
    assert got["moments"].count == 3 and torch.equal(got["moments"].m2, x * x)
    assert not list(tmp_path.glob("*.tmp"))


def test_diverging_chain_raises(tmp_path):
    """A step size far past stability overflows; the segment boundary
    raises ``FloatingPointError`` and keeps the last good checkpoint."""
    l2, lam, gamma = _tv_problem()
    ckpt = str(tmp_path / "d.ckpt")
    run_resumable_fused(l2, lam, 0.2 * gamma, gamma, l2.b, 0, 4, 4, ckpt_path=ckpt)
    good = restore_checkpoint(ckpt, {"position": l2.b, "moments":
                                     RunningMoments.init(l2.b), "key": (0, 0),
                                     "done": 0})
    with pytest.raises(FloatingPointError, match="diverged"):
        run_resumable_fused(l2, lam, 1e6, gamma, l2.b, 0, 400, 200, ckpt_path=str(
            tmp_path / "e.ckpt"))
    kern = myula_imaging(l2, TVNorm(sigma=lam, niter=2), 1e6, gamma)
    with pytest.raises(FloatingPointError, match="last checkpoint at 0 steps"):
        run_resumable(kern, l2.b, 0, 400, 400)
    assert good["done"] == 4 and torch.isfinite(good["position"]).all()


@pytest.mark.parametrize("case", ["ulpda_tiled", "mesh"])
def test_not_ported_runners_raise(case):
    """A farm across devices (``chains_mesh``) asked of one chain, with no
    farm axis, raises, also under a tiled runner; an unknown runner raises.
    The chain farm is held in ``tests/test_torch_multichain.py``, the farm
    under a mesh in ``tests/test_torch_parallel.py``."""
    l2, lam, gamma = _tv_problem()
    kw = {"chains_mesh": object()}
    if case == "ulpda_tiled":
        kw["runner"] = case
    with pytest.raises(ValueError, match="chain farm"):
        run_resumable_fused(l2, lam, 0.2 * gamma, gamma, l2.b, 0, 4, 4, **kw)
    with pytest.raises(ValueError, match="unknown runner"):
        run_resumable_fused(l2, lam, 0.2 * gamma, gamma, l2.b, 0, 4, 4, runner="pnp")
