"""Worker process of the image-sharding tests of the port
(``tests/test_torch_image_sharding.py``).

Usage: python torch_image_worker.py STORE_FILE RANK WORLD IN_FILE OUT_DIR

Joins a gloo process group of ``WORLD`` (4) ranks on a ``FileStore`` (no TCP
port) and, on three meshes of ``image_mesh(device="cpu")`` (``rows2``:
``(2, 2, 1)``, a row split of 2 under a chain axis of 2; ``rows4``: ``(1, 4,
1)``; ``grid``: ``(1, 2, 2)``), runs every sharded case of the test on the
problem in ``IN_FILE`` (numpy arrays the test built with the JAX package):
the four ``CirculantBlur2D`` products, ``L2Data.grad`` and ``prox``, the TV
prox (also with a halo of ``niter - 1``, and on a 32^2 image over 4 rows
whose halo spans two neighbours), the noise blocks, ``run_chain`` of
``myula_imaging`` in every collect mode, the collectives of one step
(``CommDebugMode``), and ``run_chains_sharded`` on the chain axis. Rank 0
writes every result, gathered whole, to ``OUT_DIR/image.pt``.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lmc_atomi_torch import interop  # noqa: E402
from lmc_atomi_torch.core.random import normal_field  # noqa: E402
from lmc_atomi_torch.kernels import myula_imaging, ula  # noqa: E402
from lmc_atomi_torch.models import GaussianMixture  # noqa: E402
from lmc_atomi_torch.ops.functionals import TVNorm  # noqa: E402
from lmc_atomi_torch.ops.tv import prox_tv_iso  # noqa: E402
from lmc_atomi_torch.run.runner import run_chain  # noqa: E402

MESHES = {"rows2": (2, 2, 1), "rows4": (1, 4, 1), "grid": (1, 2, 2)}
TAU, GAMMA, STEPS = 0.1, 0.5, 10
TV = dict(sigma=0.3, niter=5)  # the chain's prior (tests/test_parallel.py)
PROX_GAMMA, PROX_NITER = 0.2, 10
GRAM_RHO, PROX_TAU = 0.7, 0.05
NOISE_KEY = (5, 3, 17)  # (seed, chain, step) of the noise blocks
CHAIN_KEYS = {"samples": 3, "stats": 4, "both": 5, "last": 6}
FARM = dict(n_chains=4, n_steps=20, key=7)
MUS = np.array([[0.0, 0.0], [-2.0, 3.0]])
SIGMAS = np.array([[[1.0, -0.5], [-0.5, 1.0]], [[0.5, 0.2], [0.2, 0.7]]])


def problem(arrays, n):
    """``(blur, l2)`` of the ``n``-pixel problem in ``arrays`` (the JAX
    operator's spectrum pair, ``h``, ``hh``, offset and observation)."""
    a = {k: arrays[f"{k}{n}"] for k in ("eigs_re", "eigs_im", "h", "hh", "offset", "y")}
    blur = interop.blur_from_numpy(a["eigs_re"], a["eigs_im"], a["h"], a["hh"],
                                   tuple(a["offset"]))
    return blur, interop.l2data_from_numpy(a["y"], 1.0, blur)


def myula_kernel(l2):
    return myula_imaging(l2, TVNorm(**TV), tau=TAU, gamma=GAMMA)


def farm_kernel():
    """ULA on a two-component Gaussian mixture, f64, one chain a call."""
    return ula(GaussianMixture.create(MUS, SIGMAS, np.ones(2) / 2).grad_potential, 0.05)


def _whole(v):
    """A DTensor gathered whole (every rank takes part; an image also
    through ``gather_image``, which must agree), or ``v``."""
    from lmc_atomi_torch.parallel.image import gather_image

    if hasattr(v, "full_tensor"):
        whole = v.full_tensor()
        assert v.ndim != 2 or torch.equal(gather_image(v), whole)
        return whole
    if isinstance(v, dict):
        return {k: _whole(x) for k, x in v.items()}
    return v


def cases(mesh, arrays, out):
    """Every sharded case on ``mesh``; results (DTensors) into ``out``."""
    from torch.distributed.tensor.debug import CommDebugMode

    from lmc_atomi_torch.parallel import shard_image
    from lmc_atomi_torch.ops.sharded import halo, halo_map, normal_block

    t = {k: torch.from_numpy(arrays[k]) for k in ("x64", "b64", "z64", "z32", "y32", "y64")}
    blur, l2 = problem(arrays, 64)
    x, b, z = (shard_image(t[k], mesh) for k in ("x64", "b64", "z64"))
    out["matvec"] = blur.matvec(x)
    out["rmatvec"] = blur.rmatvec(x)
    out["normal_grad"] = blur.normal_grad(x, b)
    out["gram_solve"] = blur.gram_solve(GRAM_RHO, x)
    out["l2_grad"] = l2.grad(x)
    out["l2_prox"] = l2.prox(x, PROX_TAU)
    out["prox"] = prox_tv_iso(z, PROX_GAMMA, PROX_NITER)
    out["prox_short_halo"] = halo_map(lambda e: prox_tv_iso(e, PROX_GAMMA, PROX_NITER), z,
                                      PROX_NITER - 1)
    out["prox32"] = prox_tv_iso(shard_image(t["z32"], mesh), PROX_GAMMA, PROX_NITER)
    # halo itself: the block with every line within h of it (h past a
    # thin band's neighbour), clipped at the image's edges
    for h in (3, PROX_NITER + 1):
        ys, xs = _block(z)
        want = t["z64"][max(ys.start - h, 0):ys.stop + h, max(xs.start - h, 0):xs.stop + h]
        out[f"halo{h}"] = torch.equal(halo(z.to_local(), h, mesh), want)
    out["noise"] = normal_block(*NOISE_KEY, z)
    assert torch.equal(out["noise"].to_local(), normal_field(
        *NOISE_KEY, tuple(out["noise"].to_local().shape), torch.float64, "cpu",
        origin=tuple(int(o.start) for o in _block(z)), global_shape=(64, 64)))
    for n in (32, 64):
        _, l2n = problem(arrays, n)
        x0 = shard_image(torch.zeros((n, n), dtype=torch.float64), mesh)
        res = run_chain(myula_kernel(l2n), x0, CHAIN_KEYS["samples"], STEPS, collect="samples")
        out[f"chain{n}"] = res.samples
        out[f"chain{n}_last"] = res.final_state.position
    x0 = shard_image(t["y64"], mesh)
    for mode in ("stats", "both", "last"):
        res = run_chain(myula_kernel(l2), x0, CHAIN_KEYS[mode], STEPS, collect=mode, burn_in=2)
        out[f"{mode}_position"] = res.final_state.position
        if res.moments is not None:
            out[f"{mode}_mean"] = res.moments.mean
            out[f"{mode}_m2"] = res.moments.m2
        if res.samples is not None:
            out[f"{mode}_samples"] = res.samples
    kern = myula_kernel(l2)
    state = kern.init(x0)
    comm = CommDebugMode()
    with comm:
        nxt, _ = kern.step(state, (CHAIN_KEYS["samples"], 0, 0))
    out["step_comms"] = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
    out["step_local"] = isinstance(nxt.position.to_local(), torch.Tensor) and \
        nxt.position.placements == x0.placements


def _block(x):
    """The slices of the global image that ``x``'s local block holds."""
    from lmc_atomi_torch.ops.sharded import block_grid

    g = block_grid(x)
    (y0, x0), (by, bx) = g.origin, g.block
    return slice(y0, y0 + by), slice(x0, x0 + bx)


def main():
    import torch.distributed as dist

    from lmc_atomi_torch.parallel import image_mesh, run_chains_sharded

    store_path, rank, world, in_file, out_dir = (sys.argv[1], int(sys.argv[2]),
                                                 int(sys.argv[3]), sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    arrays = dict(np.load(in_file))
    results = {}
    for name, shape in MESHES.items():
        mesh = image_mesh(*shape, device="cpu")
        assert mesh.device_type == "cpu" and mesh.mesh_dim_names == ("chains", "row", "col")
        out = {}
        cases(mesh, arrays, out)
        results[name] = {k: _whole(v) for k, v in out.items()}
    mesh = image_mesh(chains=2, rows=2, device="cpu")
    res = run_chains_sharded(farm_kernel(), torch.zeros(2, dtype=torch.float64), FARM["key"],
                             FARM["n_steps"], FARM["n_chains"], mesh=mesh, axis="chains",
                             collect="both")
    results["farm"] = {"samples": res.samples, "mean": res.moments.mean,
                       "position": res.final_state.position}
    try:
        from lmc_atomi_torch.parallel import shard_image

        shard_image(torch.zeros((30, 32)), image_mesh(1, 4, 1, device="cpu"))
        results["uneven"] = "accepted"
    except ValueError as e:
        results["uneven"] = str(e)
    if rank == 0:
        torch.save(results, os.path.join(out_dir, "image.pt"))
    dist.barrier()
    dist.destroy_process_group()
    print(f"worker {rank} done", file=sys.stderr)


if __name__ == "__main__":
    main()
