"""Image sharding in the port, on the CPU: ``image_mesh``, ``shard_image``,
the halo exchange of the TV prox and the transposed FFT of
``CirculantBlur2D`` and ``L2Data`` (``ops/sharded.py``), the noise blocks
and the sharded MYULA chain, against the JAX package and against the port's
own one-device results.

One spawn of four gloo worker processes on a ``FileStore`` under a temp
directory (``tests/torch_image_worker.py``) computes every sharded case on
three meshes: ``rows2`` (a row split of 2 under a chain axis of 2), ``rows4``
and ``grid`` (2 x 2). Tolerances, f64: the sharded spectral products and
the prox within 1e-12 of the largest value of JAX's unsharded results
(``backend="xla"``; the gate of ``tests/test_parallel.py:128-150``), since
JAX's own tests hold its sharded results to its unsharded ones; the
sharded MYULA chains within 1e-10 of the port's one-device chain (the gate
of ``tests/test_parallel.py:103``) and within 1e-8 relative, 1e-10 absolute
of JAX's update rule fed the port's noise (``tests/test_torch_slice.py``'s
gate). The sharded prox, its thin-band case and the noise blocks equal the
one-device results bit for bit."""
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_image_worker as W
from lmc_atomi_torch.core.random import normal_field
from lmc_atomi_torch.ops.tv_cuda import prox_tv_iso_ref
from lmc_atomi_torch.run.runner import run_chain, run_chains
from lmc_atomi_tpu.ops.functionals import L2Data, TVNorm
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, uniform_kernel
from lmc_atomi_tpu.ops.tv import prox_tv_iso as j_prox_tv_iso
from lmc_atomi_tpu.utils.images import phantom

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TOL_JAX = 1e-12
TOL_CHAIN = 1e-10
WORLD = 4
MESHES = list(W.MESHES)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol, name=""):
    want = np.asarray(want)
    got = _np(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)


def _jax_problem(n):
    """The JAX operator of an ``n``-pixel 5x5 uniform blur and its
    observation of the phantom."""
    op = CirculantBlur2D.from_kernel((n, n), uniform_kernel(5, jnp.float64))
    y = op.matvec(jnp.asarray(phantom(n, np.float64)))
    return op, y


@pytest.fixture(scope="module")
def inputs():
    """The arrays the workers read: each size's JAX operator and
    observation, and the 64^2 test images (a phantom, a shifted copy for
    ``b``, a noisy phantom for the prox)."""
    rng = np.random.default_rng(0)
    arrays = {}
    for n in (32, 64):
        op, y = _jax_problem(n)
        arrays.update({f"eigs_re{n}": np.asarray(op.eigs_re), f"eigs_im{n}": np.asarray(op.eigs_im),
                       f"h{n}": np.asarray(op.h), f"hh{n}": np.asarray(op.hh),
                       f"offset{n}": np.asarray(op.offset), f"y{n}": np.asarray(y)})
    x = phantom(64, np.float64)
    arrays["x64"] = x
    arrays["b64"] = np.asarray(_jax_problem(64)[0].matvec(jnp.asarray(x))) + 0.1
    arrays["z64"] = x + 0.2 * rng.normal(size=(64, 64))
    arrays["z32"] = phantom(32, np.float64) + 0.2 * rng.normal(size=(32, 32))
    return arrays


@pytest.fixture(scope="module")
def sharded(inputs, tmp_path_factory):
    """Every sharded result, from one run of four worker processes."""
    tmp = tmp_path_factory.mktemp("image")
    np.savez(tmp / "in.npz", **inputs)
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_image_worker.py"),
                               str(tmp / "store"), str(r), str(WORLD), str(tmp / "in.npz"),
                               str(tmp)], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return torch.load(tmp / "image.pt")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("op", ["matvec", "rmatvec", "normal_grad", "gram_solve", "l2_grad",
                                "l2_prox"])
def test_sharded_spectral_ops_match_jax(sharded, inputs, mesh, op):
    """The transposed FFT: each sharded product of ``CirculantBlur2D`` and
    ``L2Data`` against JAX's unsharded one, 1e-12."""
    jop, y = _jax_problem(64)
    x, b = jnp.asarray(inputs["x64"]), jnp.asarray(inputs["b64"])
    l2 = L2Data.create(op=jop, b=y, sigma=1.0)
    want = {"matvec": lambda: jop.matvec(x), "rmatvec": lambda: jop.rmatvec(x),
            "normal_grad": lambda: jop.normal_grad(x, b),
            "gram_solve": lambda: jop.gram_solve(W.GRAM_RHO, x),
            "l2_grad": lambda: l2.grad(x), "l2_prox": lambda: l2.prox(x, W.PROX_TAU)}[op]()
    _close(sharded[mesh][op], want, TOL_JAX, f"{mesh} {op}")


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_prox_matches_jax_and_whole_image(sharded, inputs, mesh):
    """The halo-exchanged prox (``niter + 1`` rows and columns) against
    JAX's ``prox_tv_iso(backend="xla")`` (1e-12) and bit for bit against
    the port's plain prox of the whole image."""
    z = inputs["z64"]
    want = j_prox_tv_iso(jnp.asarray(z), W.PROX_GAMMA, W.PROX_NITER, backend="xla")
    got = sharded[mesh]["prox"]
    _close(got, want, TOL_JAX, mesh)
    assert torch.equal(got, prox_tv_iso_ref(torch.from_numpy(z), W.PROX_GAMMA, W.PROX_NITER))


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_prox_thin_bands(sharded, inputs, mesh):
    """32^2 over 4 rows is 8-row bands under an 11-row halo: each band takes
    rows of two neighbours; still the whole-image prox bit for bit."""
    want = prox_tv_iso_ref(torch.from_numpy(inputs["z32"]), W.PROX_GAMMA, W.PROX_NITER)
    assert torch.equal(sharded[mesh]["prox32"], want)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("h", [3, W.PROX_NITER + 1])
def test_halo_is_the_neighbourhood(sharded, mesh, h):
    """``halo(x_local, h, mesh)`` on every rank: its block with every line
    within ``h`` of it from the neighbours, corners included, none past the
    image's edges (checked on each rank against the whole image)."""
    assert sharded[mesh][f"halo{h}"] is True


@pytest.mark.parametrize("mesh", MESHES)
def test_short_halo_differs(sharded, inputs, mesh):
    """A halo of ``niter - 1`` lines leaves the cut edges' error inside the
    blocks: the result differs from the whole-image prox, so ``niter + 1``
    (``_halo_need``'s TV depth) is not slack."""
    want = prox_tv_iso_ref(torch.from_numpy(inputs["z64"]), W.PROX_GAMMA, W.PROX_NITER)
    # far above rounding (the full halo gives the same bits), though the
    # cut edge's error decays as it travels: ~7e-8 of values ~100 here
    assert float((sharded[mesh]["prox_short_halo"] - want).abs().max()) > 1e-9


@pytest.mark.parametrize("mesh", MESHES)
def test_noise_blocks_are_the_whole_field(sharded, mesh):
    """Each rank's ``normal_block`` is its slice of the one-device
    ``normal_field`` (every pixel keeps its global counter)."""
    want = normal_field(*W.NOISE_KEY, (64, 64), torch.float64, "cpu")
    assert torch.equal(sharded[mesh]["noise"], want)


def _one_device_chain(inputs, n, key, collect, **kw):
    _, l2 = W.problem(inputs, n)
    x0 = torch.from_numpy(inputs["y64"]) if collect != "samples" else \
        torch.zeros((n, n), dtype=torch.float64)
    return run_chain(W.myula_kernel(l2), x0, key, W.STEPS, collect=collect, **kw)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("n", [32, 64])
def test_sharded_myula_chain_matches_one_device(sharded, inputs, mesh, n):
    """``run_chain(myula_imaging)`` on ``shard_image(x0, mesh)``, 10 steps,
    ``collect="samples"``, against the port's one-device chain (1e-10)."""
    want = _one_device_chain(inputs, n, W.CHAIN_KEYS["samples"], "samples")
    _close(sharded[mesh][f"chain{n}"], _np(want.samples), TOL_CHAIN, f"{mesh} {n}")
    _close(sharded[mesh][f"chain{n}_last"], _np(want.final_state.position), TOL_CHAIN)


@pytest.mark.parametrize("n", [32, 64])
def test_sharded_chain_matches_jax_update_rule(sharded, inputs, n):
    """The 2 x 2 sharded chain against the JAX package's update rule (its
    own ``L2Data.grad`` and ``TVNorm.prox``) fed the port's noise."""
    jop, y = _jax_problem(n)
    l2 = L2Data.create(op=jop, b=jnp.asarray(inputs[f"y{n}"]), sigma=1.0)
    tv = TVNorm(**W.TV)
    grad, prox = jax.jit(l2.grad), jax.jit(lambda a: tv.prox(a, W.GAMMA))
    x = np.zeros((n, n))
    want = []
    for i in range(W.STEPS):
        xi = _np(normal_field(W.CHAIN_KEYS["samples"], 0, i, (n, n), torch.float64, "cpu"))
        xj = jnp.asarray(x)
        x = ((1 - W.TAU / W.GAMMA) * x - W.TAU * np.asarray(grad(xj))
             + (W.TAU / W.GAMMA) * np.asarray(prox(xj)) + math.sqrt(2 * W.TAU) * xi)
        want.append(x.copy())
    np.testing.assert_allclose(_np(sharded["grid"][f"chain{n}"]), np.asarray(want),
                               rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", ["stats", "both", "last"])
def test_sharded_chain_collect_modes(sharded, inputs, mesh, mode):
    """The other collect modes (burn-in 2) on the sharded chain: positions,
    Welford moments and samples against the one-device chain (1e-10)."""
    want = _one_device_chain(inputs, 64, W.CHAIN_KEYS[mode], mode, burn_in=2)
    got = sharded[mesh]
    _close(got[f"{mode}_position"], _np(want.final_state.position), TOL_CHAIN)
    if mode in ("stats", "both"):
        _close(got[f"{mode}_mean"], _np(want.moments.mean), TOL_CHAIN)
        _close(got[f"{mode}_m2"], _np(want.moments.m2), TOL_CHAIN)
    if mode == "both":
        _close(got["both_samples"], _np(want.samples), TOL_CHAIN)
    assert (f"{mode}_mean" in got) == (mode != "last")


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_step_gathers_nothing(sharded, mesh):
    """``CommDebugMode`` over one sharded MYULA step: every collective is an
    all-to-all of the halo or the transposed FFT; no all-gather, broadcast
    or reduction of the image, and the step returns a DTensor placed as
    its input."""
    comms = sharded[mesh]["step_comms"]
    assert comms and all("alltoall" in k for k in comms), comms
    assert sharded[mesh]["step_local"]


def test_run_chains_sharded_on_the_chain_axis(sharded):
    """``run_chains_sharded(..., mesh=image_mesh(chains=2, rows=2),
    axis="chains")`` equals ``run_chains`` bit for bit."""
    want = run_chains(W.farm_kernel(), torch.zeros(2, dtype=torch.float64), W.FARM["key"],
                      W.FARM["n_steps"], W.FARM["n_chains"], collect="both")
    got = sharded["farm"]
    assert torch.equal(got["samples"], want.samples)
    assert torch.equal(got["mean"], want.moments.mean)
    assert torch.equal(got["position"], want.final_state.position)


def test_shard_image_rejects_what_jax_rejects(sharded):
    """A shape the mesh does not divide raises ``ValueError`` in both
    packages (JAX's ``device_put`` of a ``NamedSharding``)."""
    from lmc_atomi_tpu.parallel.mesh import image_mesh as j_image_mesh
    from lmc_atomi_tpu.parallel.mesh import shard_image as j_shard_image

    with pytest.raises(ValueError, match="divisible"):
        j_shard_image(jnp.zeros((30, 32)), j_image_mesh(1, 4, 1))
    assert "not divisible" in sharded["uneven"]


def test_image_mesh_without_a_card_raises():
    """``device="cuda"`` without a card raises before any group starts."""
    import torch.distributed as dist

    from lmc_atomi_torch.parallel import image_mesh

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        image_mesh(rows=2)
    assert not dist.is_initialized()


def test_one_rank_image_mesh_runs_the_whole_image(inputs):
    """On a one-rank mesh (started by ``image_mesh`` itself) the sharded
    chain is one block: the one-device chain within 1e-10 (its FFT runs as
    an ``rfft`` along x and an ``fft`` along y, not ``rfft2``)."""
    import torch.distributed as dist

    from lmc_atomi_torch.parallel import image_mesh, shard_image

    try:
        mesh = image_mesh(device="cpu")
        assert mesh.shape == (1, 1, 1) and dist.get_world_size() == 1
        _, l2 = W.problem(inputs, 32)
        x0 = torch.zeros((32, 32), dtype=torch.float64)
        got = run_chain(W.myula_kernel(l2), shard_image(x0, mesh), 1, 4, collect="samples")
        want = run_chain(W.myula_kernel(l2), x0, 1, 4, collect="samples")
        _close(got.samples.full_tensor(), _np(want.samples), TOL_CHAIN)
        # an image on another device (a card's, here the meta device's)
        # does not move to a host mesh
        with pytest.raises(ValueError, match="does not go to"):
            shard_image(torch.zeros((32, 32), device="meta"), mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
