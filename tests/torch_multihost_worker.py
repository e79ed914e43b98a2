"""Worker process of the two-process chain-farm test of the port
(``tests/test_torch_parallel.py``).

Usage: python torch_multihost_worker.py STORE_FILE RANK WORLD OUT_DIR

Joins a gloo process group of ``WORLD`` ranks on a ``FileStore`` (no TCP
port) through ``init_multihost``, runs ``global_chain_farm`` of ULA (8 chains
x 100 steps) and a checkpointed ``run_resumable_fused(chains_mesh=...)``
``"tv"`` farm (4 chains, 4 of 8 steps, segments of 2), and writes from rank
0 the pooled moments (``farm.json``), the farm's gathered per-chain moments
and the "tv" bundle (``farm.pt``); the checkpoint goes to ``OUT_DIR/tv.ckpt``.
The test imports the problem constructors from this file.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lmc_atomi_torch.kernels import ula  # noqa: E402
from lmc_atomi_torch.models import GaussianMixture  # noqa: E402
from lmc_atomi_torch.ops.functionals import L2Data  # noqa: E402
from lmc_atomi_torch.ops.linops import CirculantBlur2D, uniform_kernel  # noqa: E402
from lmc_atomi_torch.utils.images import phantom  # noqa: E402

MUS = np.array([[0.0, 0.0], [-2.0, 3.0]])
SIGMAS = np.array([[[1.0, -0.5], [-0.5, 1.0]], [[0.5, 0.2], [0.2, 0.7]]])
N, SIG = 16, 0.75
FARM_CHAINS, FARM_STEPS = 8, 100
TV_CHAINS, TV_ARGS = 4, dict(burn_in=1, quantiles=(0.1, 0.9), niter_tv=3)


def ula_kernel():
    """The farm's kernel: ULA on the two-component mixture, f64, stepping
    all of a rank's chains at once."""
    gm = GaussianMixture.create(MUS, SIGMAS, np.ones(2) / 2)
    return ula(gm.grad_potential, 0.05)._replace(chain_axis=True)


def tv_problem():
    """``(l2, lam, tau, gamma, x0, key)`` of the "tv" farm: a 16^2 blurred
    phantom in f64 and four starts."""
    img = torch.from_numpy(phantom(N, np.float64))
    blur = CirculantBlur2D.from_kernel((N, N), uniform_kernel(5, torch.float64))
    y = blur.matvec(img) + SIG * torch.from_numpy(np.random.default_rng(0).normal(size=(N, N)))
    l2 = L2Data.create(op=blur, b=y, sigma=1 / SIG**2)
    x0 = torch.stack([y, y * 0.5, y + 1.0, y - 2.0])
    return l2, 0.3, 0.2 * SIG**2, SIG**2, x0, (4, 1)


def main():
    import torch.distributed as dist

    from lmc_atomi_torch.parallel import chain_mesh, global_chain_farm, init_multihost
    from lmc_atomi_torch.run import run_resumable_fused

    store_path, rank, world, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    store = dist.FileStore(store_path, world)
    assert init_multihost(world_size=world, rank=rank, store=store) == world
    assert dist.get_world_size() == world and dist.get_rank() == rank

    res, pooled = global_chain_farm(ula_kernel(), torch.zeros(2, dtype=torch.float64), 0,
                                    FARM_STEPS, FARM_CHAINS, collect="stats")
    mesh = chain_mesh(device="cpu")
    try:
        global_chain_farm(ula_kernel(), torch.zeros(2, dtype=torch.float64), 0, 5, 3)
        raise AssertionError("3 chains on 2 ranks did not raise")
    except ValueError as e:
        assert "not divisible" in str(e)
    bundle = run_resumable_fused(*tv_problem(), 4, 2, ckpt_path=os.path.join(out_dir, "tv.ckpt"),
                                 chains_mesh=mesh, **TV_ARGS)
    if rank == 0:
        with open(os.path.join(out_dir, "farm.json"), "w") as f:
            json.dump({"count": int(pooled.count), "mean": pooled.mean.tolist(),
                       "m2": pooled.m2.tolist()}, f)
        torch.save({"mean": res.moments.mean, "m2": res.moments.m2,
                    "count": res.moments.count, "position": res.final_state.position,
                    "tv_position": bundle["position"], "tv_mean": bundle["moments"].mean,
                    "tv_qh": bundle["quantile_state"][0]},
                   os.path.join(out_dir, "farm.pt"))
    dist.barrier()
    dist.destroy_process_group()
    print(f"worker {rank} done", file=sys.stderr)


if __name__ == "__main__":
    main()
