"""Chain farms across processes in the port, on the CPU, against the JAX
package and against the port's own one-process runs: ``chain_mesh``,
``run_chains_sharded``, ``init_multihost``, ``global_chain_farm``, the
``chains_mesh`` farm of ``run_resumable_fused``, and the package surface
(every name the JAX package's subpackages export).

The meshes here are gloo process groups on the CPU: one rank on an
in-process store, or two worker processes on a ``FileStore`` under
``tmp_path`` (no TCP port). A farm is held to the port's one-process run bit
for bit (the noise streams differ from JAX's by design) and to the JAX
package where its noise does not enter: a deterministic kernel's sharded
chains and the pooling of the same per-chain moments within 1e-12 of the
output's scale, the noise-off "tv" farm within 1e-9 (f64; the block
recursions differ in summation order only, as in
``tests/test_torch_multichain.py``)."""
import importlib
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_multihost_worker as W
from lmc_atomi_torch import interop
from lmc_atomi_torch.kernels import sgmcmc as T
from lmc_atomi_torch.parallel import chain_mesh, global_chain_farm, run_chains_sharded
from lmc_atomi_torch.parallel.mesh import merge_chain_moments
from lmc_atomi_torch.run import longrun as t_longrun
from lmc_atomi_torch.run import runner as t_runner
from lmc_atomi_tpu.core.stats import RunningMoments as JMoments
from lmc_atomi_tpu.kernels import sgmcmc as J
from lmc_atomi_tpu.models import GridGaussianMixture as JGrid
from lmc_atomi_tpu.ops.functionals import L2Data
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, uniform_kernel
from lmc_atomi_tpu.parallel import mesh as j_mesh
from lmc_atomi_tpu.run import longrun as j_longrun
from lmc_atomi_tpu.utils.images import phantom

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-12
TOL_FARM = 1e-9


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    got = _np(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.fixture(autouse=True)
def no_group_left():
    """Every test starts without a process group and leaves none."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _same(a, b, name=""):
    """Every tensor of two results equal, bit for bit."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), name
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{name}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k], f"{name}.{k}")
    elif hasattr(a, "__dataclass_fields__"):
        for k in a.__dataclass_fields__:
            _same(getattr(a, k), getattr(b, k), f"{name}.{k}")
    else:
        assert a == b, name


def test_chain_mesh_device_and_world():
    """The card unless ``device="cpu"``; one rank on an in-process store
    (gloo on the CPU); a request past the world size names it; a group
    already started is used as it is."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            chain_mesh()
        assert not dist.is_initialized()
    mesh = chain_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("chains",) and mesh.size() == 1
    assert mesh.device_type == "cpu" and dist.get_backend() == "gloo"
    with pytest.raises(ValueError, match="world size 1"):
        chain_mesh(2, device="cpu")
    assert chain_mesh(1, axis="farm", device="cpu").mesh_dim_names == ("farm",)


@pytest.mark.parametrize("cards,world,per_node,want", [
    (0, 2, None, "gloo"), (1, 2, None, "gloo"), (4, 4, None, "nccl"), (4, 8, "4", "nccl"),
    (1, 4, "2", "gloo")])
def test_multihost_backend_rule(monkeypatch, cards, world, per_node, want):
    """``init_multihost``'s backend: NCCL where every rank of a node
    (``LOCAL_WORLD_SIZE``, else the world) has a card, gloo with no card or
    more ranks than cards."""
    from lmc_atomi_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if per_node is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", per_node)
    assert multihost._backend(world) == want


KERNELS = ["ULA", "MALA-no-chain-axis", "MSGLD"]


def _kernel(name):
    if name == "ULA":
        return W.ula_kernel()
    if name == "MALA-no-chain-axis":
        from lmc_atomi_torch.kernels import mala
        from lmc_atomi_torch.models import GaussianMixture

        gm = GaussianMixture.create(W.MUS, W.SIGMAS, np.ones(2) / 2)
        return mala(gm.log_density, gm.grad_potential, 0.3)
    from lmc_atomi_torch.models import GridGaussianMixture

    gm = GridGaussianMixture.create([-4.0, -2.0, 0.0, 2.0, 4.0], 0.03, 1 / 25.0,
                                    dtype=torch.float64)
    return T.msgld(gm.log_prob, gm.grad_log_prob, T.polynomial_schedule(0.4, -0.55))


@pytest.mark.parametrize("name", KERNELS)
def test_sharded_equals_run_chains(name):
    """On a one-rank gloo mesh, every field of ``run_chains_sharded`` equals
    ``run_chains`` bit for bit, from one start and from one start a chain;
    the pooled moments are the JAX package's ``merge_chain_moments`` of the
    same per-chain moments."""
    kern = _kernel(name)
    mesh = chain_mesh(device="cpu")
    kw = dict(collect="both", quantile_ps=(0.5,), burn_in=3)
    starts = torch.from_numpy(np.random.default_rng(5).normal(size=(8, 2)))
    for x0 in (torch.zeros(2, dtype=torch.float64), starts):
        want = t_runner.run_chains(kern, x0, 3, 40, 8, **kw)
        got = run_chains_sharded(kern, x0, 3, 40, 8, mesh=mesh, **kw)
        _same(got.samples, want.samples)
        _same(got.final_state, want.final_state)
        _same(got.moments, want.moments)
        _same(got.quantiles, want.quantiles)
        _same([i.accepted for i in got.infos], [i.accepted for i in want.infos])
    pooled = merge_chain_moments(got.moments)
    jpooled = j_mesh.merge_chain_moments(JMoments(
        count=jnp.asarray(_np(got.moments.count)), mean=jnp.asarray(_np(got.moments.mean)),
        m2=jnp.asarray(_np(got.moments.m2))))
    assert pooled.count == int(jpooled.count) == 8 * 37
    _close(pooled.mean, jpooled.mean)
    _close(pooled.m2, jpooled.m2)


def test_sharded_deterministic_chains_match_jax(monkeypatch):
    """Cyclical SGLD in its exploration phase alone (gradient ascent, no
    noise) from one start a chain: the port's sharded farm against the JAX
    package's ``run_chains_sharded`` over its 8-device mesh, chain for
    chain, and ``global_chain_farm``'s pooled moments as JAX pools them. Both
    run the port's float32 schedule (``tests/test_torch_sgmcmc.py`` holds
    the schedules to each other)."""
    table = jnp.asarray([T.cyclical_cosine_schedule(60, 1, 0.09, 1.0)(i)[0]
                         for i in range(60)], jnp.float32)
    monkeypatch.setattr(J, "cyclical_cosine_schedule", lambda *a: (
        lambda step: (table[step], jnp.asarray(False))))
    jg = JGrid.create([-4.0, -2.0, 0.0, 2.0, 4.0], sigma=0.03, lam=1 / 25.0)
    tg = interop.grid_mixture_from_numpy(np.asarray(jg.mus), 0.03, 1 / 25.0)
    starts = np.random.default_rng(6).uniform(-5, 5, size=(8, 2))
    tk = T.cyclical_sgld(tg.grad_log_prob, 60, 1, 0.09, 1.0)
    jk = J.cyclical_sgld(jg.grad_log_prob, 60, 1, 0.09, 1.0)
    want = j_mesh.run_chains_sharded(jk, jnp.asarray(starts), jax.random.PRNGKey(0), 60, 8,
                                     collect="both")
    got, pooled = global_chain_farm(tk, torch.from_numpy(starts), 0, 60, 8, collect="both")
    _close(got.samples, want.samples)
    _close(got.moments.mean, want.moments.mean)
    jpooled = j_mesh.merge_chain_moments(want.moments)
    assert pooled.count == int(jpooled.count)
    _close(pooled.mean, jpooled.mean)
    _close(pooled.m2, jpooled.m2, 1e-10)


def test_two_process_farm(tmp_path):
    """Two gloo ranks on a ``FileStore`` (``init_multihost``): the pooled
    moments and gathered per-chain results of ``global_chain_farm`` equal
    the one-process farm's bit for bit; 3 chains on 2 ranks raise; the
    2-rank "tv" farm of ``run_resumable_fused`` equals the one without a
    mesh, and its checkpoint, written by rank 0 after 4 steps, resumes in
    one process without a mesh to the straight 8-step run bit for bit."""
    worker = Path(__file__).with_name("torch_multihost_worker.py")
    store = tmp_path / "store"
    procs = [subprocess.Popen([sys.executable, str(worker), str(store), str(r), "2",
                               str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    with open(tmp_path / "farm.json") as f:
        pooled = json.load(f)
    got = torch.load(tmp_path / "farm.pt")
    res = t_runner.run_chains(W.ula_kernel(), torch.zeros(2, dtype=torch.float64), 0,
                              W.FARM_STEPS, W.FARM_CHAINS, collect="stats")
    want = merge_chain_moments(res.moments)
    assert pooled["count"] == want.count == W.FARM_CHAINS * W.FARM_STEPS
    assert pooled["mean"] == want.mean.tolist() and pooled["m2"] == want.m2.tolist()
    for k, v in (("mean", res.moments.mean), ("m2", res.moments.m2),
                 ("count", res.moments.count), ("position", res.final_state.position)):
        assert torch.equal(got[k], v), k
    args = W.tv_problem()
    half = t_longrun.run_resumable_fused(*args, 4, 2, **W.TV_ARGS)
    assert torch.equal(got["tv_position"], half["position"])
    assert torch.equal(got["tv_mean"], half["moments"].mean)
    assert torch.equal(got["tv_qh"], half["quantile_state"][0])
    straight = t_longrun.run_resumable_fused(*args, 8, 2, **W.TV_ARGS)
    resumed = t_longrun.run_resumable_fused(*args, 8, 2, ckpt_path=str(tmp_path / "tv.ckpt"),
                                            **W.TV_ARGS)
    assert resumed["done"] == 8
    _same({k: resumed[k] for k in ("position", "moments", "quantile_state", "quantiles")},
          {k: straight[k] for k in ("position", "moments", "quantile_state", "quantiles")})


# --- the resumable farm under a mesh ----------------------------------------------

N = 32
SIG = 0.75
FARM = {  # runner: options (tests/test_torch_multichain.py's)
    "tv": dict(quantiles=(0.1, 0.9)),
    "ulpda_tiled": dict(quantiles=(0.1, 0.9), band=8, halo=8, niter_solve=1),
}


@pytest.fixture(scope="module")
def problem():
    """The 32^2 deconvolution posterior in f64, built in JAX and carried to
    the port."""
    img = phantom(N, np.float64)
    jb = CirculantBlur2D.from_kernel((N, N), uniform_kernel(5, jnp.float64))
    y = np.asarray(jb.matvec(jnp.asarray(img))) \
        + SIG * np.random.default_rng(0).normal(size=(N, N))
    tb = interop.blur_from_numpy(np.asarray(jb.eigs_re), np.asarray(jb.eigs_im),
                                 np.asarray(jb.h), np.asarray(jb.hh), jb.offset)
    return (L2Data.create(op=jb, b=jnp.asarray(y), sigma=1 / SIG**2),
            interop.l2data_from_numpy(y, 1 / SIG**2, tb), y)


def _farm_args(problem, runner):
    l2 = problem[1]
    tau, gamma = (0.95 * SIG**2, 1.0) if runner == "ulpda_tiled" else (0.2 * SIG**2, SIG**2)
    x0 = torch.stack([l2.b, l2.b * 0.5, l2.b + 1.0, l2.b - 2.0])
    return (l2, 0.3, tau, gamma, x0, (4, 1)), dict(runner=runner, burn_in=3, **FARM[runner])


@pytest.mark.parametrize("runner", sorted(FARM))
def test_resumable_farm_under_mesh(problem, tmp_path, runner):
    """Noise on: 4 chains, 8 steps in segments of 4 on a one-rank gloo
    mesh, stopped after a segment and resumed from its checkpoint, equal
    the farm without a mesh bit for bit: positions, per-chain moments,
    markers and ULPDA state. A farm without a farm axis raises."""
    args, kw = _farm_args(problem, runner)
    mesh = chain_mesh(device="cpu")
    straight = t_longrun.run_resumable_fused(*args, 8, 4, **kw)
    ckpt = str(tmp_path / "farm.ckpt")
    t_longrun.run_resumable_fused(*args, 4, 4, ckpt_path=ckpt, chains_mesh=mesh, **kw)
    resumed = t_longrun.run_resumable_fused(*args, 8, 4, ckpt_path=ckpt, chains_mesh=mesh, **kw)
    keys = ["position", "moments", "quantile_state", "quantiles"] + (
        ["ulpda_extras"] if runner == "ulpda_tiled" else [])
    assert resumed["done"] == 8
    _same({k: resumed[k] for k in keys}, {k: straight[k] for k in keys})
    with pytest.raises(ValueError, match="chain farm"):
        t_longrun.run_resumable_fused(*args[:4], args[4][0], args[5], 4, 4, chains_mesh=mesh,
                                      **kw)


def test_tv_farm_under_mesh_matches_jax(problem):
    """Noise off, f64: the "tv" farm of 2 chains on a one-rank mesh, 8
    steps in segments of 4 with CI markers, against the JAX package's farm
    with ``chains_mesh`` over two of its devices."""
    jl2, tl2, y = problem
    x0 = np.stack([y, y * 0.5])
    kw = dict(burn_in=3, quantiles=(0.025, 0.975), noise_scale=0.0, niter_tv=5)
    jmesh = j_mesh.chain_mesh(2)
    want = j_longrun.run_resumable_fused(jl2, 0.3, 0.2 * SIG**2, SIG**2, jnp.asarray(x0),
                                         jax.random.PRNGKey(0), 8, 4, chains_mesh=jmesh,
                                         interpret=True, **kw)
    got = t_longrun.run_resumable_fused(tl2, 0.3, 0.2 * SIG**2, SIG**2, torch.from_numpy(x0),
                                        0, 8, 4, chains_mesh=chain_mesh(device="cpu"), **kw)
    _close(got["position"], want["position"], TOL_FARM, "x")
    _close(got["moments"].mean, want["moments"].mean, TOL_FARM, "mean")
    _close(got["moments"].m2, want["moments"].m2, TOL_FARM * 10, "m2")
    np.testing.assert_array_equal(_np(got["moments"].count), np.asarray(want["moments"].count))
    for p in (0.025, 0.975):
        _close(got["quantiles"][p], want["quantiles"][p], TOL_FARM, f"q{p}")


# --- the package surface ----------------------------------------------------------

# JAX names with no counterpart in the port, and why
NO_COUNTERPART = {
    "utils.default_real_dtype": "reads jax_enable_x64; the port takes its dtype from its "
                                "tensors",
}
SUBPACKAGES = ["", "core", "eval", "experiments", "kernels", "models", "ops", "parallel",
               "run", "utils", "utils.trace"]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_package_surface(sub):
    """Every name a subpackage of the JAX package exports (its ``__all__``,
    the top package its subpackages) exists in the port's, but the listed
    exceptions; importing the port imports no matplotlib and builds no
    kernel."""
    jname = "lmc_atomi_tpu" + (f".{sub}" if sub else "")
    tname = "lmc_atomi_torch" + (f".{sub}" if sub else "")
    jmod, tmod = importlib.import_module(jname), importlib.import_module(tname)
    names = getattr(jmod, "__all__", None) or [
        n for n in ("core", "eval", "kernels", "models", "ops", "parallel", "run", "utils")]
    names = list(names) + [n for n in dir(jmod) if sub == "utils" and n == "default_real_dtype"]
    missing = [n for n in names if not hasattr(tmod, n)
               and f"{sub}.{n}" not in NO_COUNTERPART]
    assert not missing, missing
    for key in NO_COUNTERPART:
        if key.startswith(f"{sub}."):
            assert not hasattr(tmod, key.split(".")[1]), key
    if sub == "":
        code = ("import sys, lmc_atomi_torch, lmc_atomi_torch.experiments; "
                "import lmc_atomi_torch._build as b; "
                "assert 'matplotlib' not in sys.modules and 'jax' not in sys.modules; "
                "assert b.library.cache_info().currsize == 0")
        subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
