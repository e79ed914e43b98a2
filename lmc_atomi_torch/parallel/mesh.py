"""Device meshes of the port (counterpart of
``lmc_atomi_tpu/parallel/mesh.py``): chain farms across processes, and
images split over them.

The JAX package farms chains over a device mesh with ``shard_map``. Here the
mesh is a one-axis ``torch.distributed`` ``DeviceMesh`` over the ranks of a
process group, one process a device: rank ``r`` runs its share of the
chains, ``n_chains / world`` of them, and every field of the result comes
back to every rank with the global leading chain axis through
``all_gather``. Chain ``c`` keeps the key ``chain_keys(key, n_chains)[c]``
whichever rank runs it, so a farm equals ``run_chains`` bit for bit (where
the kernel's chains do not depend on the batch they run in) and the pooled
moments do not depend on the world size. NCCL gathers device tensors, gloo
host copies.

``image_mesh`` is the 3-D ``(chains, row, col)`` mesh and ``shard_image``
places an image on it in ``(row, col)`` blocks, a ``DTensor``: ``run_chain``
of ``myula_imaging`` then runs each rank's block, the TV prox on a halo
exchange and ``CirculantBlur2D`` on a transposed FFT (``ops/sharded.py``),
where JAX leaves those collectives to GSPMD.

``chain_mesh`` and ``image_mesh`` with no process group start a one-rank
group on an in-process store, so a single process needs no socket; a
multi-process run starts its group first (``parallel.multihost.init_multihost``,
e.g. under ``torchrun``, or ``init_process_group`` on a ``FileStore``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from lmc_atomi_torch.core.random import chain_keys
from lmc_atomi_torch.core.stats import RunningMoments
from lmc_atomi_torch.run.runner import ChainResult, _is_batched, _map, run_keyed_chains
from lmc_atomi_torch.utils.cli import require_device

__all__ = ["chain_mesh", "image_mesh", "shard_image", "run_chains_sharded",
           "merge_chain_moments", "gather_chains", "mesh_share"]


def chain_mesh(n_devices: Optional[int] = None, axis: str = "chains",
               device: str = "cuda"):
    """A one-axis ``DeviceMesh`` named ``axis`` over the first ``n_devices``
    ranks of the process group (all of them by default).

    Without a process group it starts a one-rank group on a ``HashStore``:
    NCCL for a CUDA ``device`` (which must exist: ``require_device``), gloo
    for ``device="cpu"``. A group the caller started is used as it is, and
    its backend sets where the gathers run (gloo: host copies, NCCL: the
    card). ``n_devices`` past the world size raises."""
    dev = require_device(device, "chain-mesh")
    _one_rank_group(dev)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"chain_mesh over {n} devices: the process group has "
                         f"world size {world}")
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(mesh_type, list(range(n)), mesh_dim_names=(axis,))


def _one_rank_group(dev: torch.device) -> None:
    """A one-rank process group on a ``HashStore`` where none is started:
    NCCL for a card, gloo for the host."""
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)


def image_mesh(chains: int = 1, rows: int = 1, cols: int = 1, devices=None,
               device: str = "cuda"):
    """The 3-D ``DeviceMesh`` ``(chains, row, col)`` over the first
    ``chains * rows * cols`` ranks of the process group (of ``devices``, a
    list of ranks, where given), for chain farms (``run_chains_sharded(...,
    axis="chains")``) whose images ``shard_image`` splits over ``row`` and
    ``col``.

    Its device type is ``device``'s (``"cuda"`` must exist:
    ``require_device``) whatever the group's backend: a ``DTensor`` moves its
    blocks to the mesh's device type, so a gloo group on one card (several
    ranks, host copies in the exchanges) still keeps the images on the card.
    Without a process group it starts a one-rank group as ``chain_mesh``
    does."""
    dev = require_device(device, "image-mesh")
    _one_rank_group(dev)
    need = int(chains) * int(rows) * int(cols)
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    if min(chains, rows, cols) < 1 or need > len(ranks) or not set(ranks) <= set(
            range(dist.get_world_size())):
        raise ValueError(f"image_mesh of {chains} x {rows} x {cols} over the ranks {ranks} of "
                         f"a process group of world size {dist.get_world_size()}")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(dev.type, torch.tensor(ranks[:need]).reshape(chains, rows, cols),
                      mesh_dim_names=("chains", "row", "col"))


def shard_image(x, mesh, row_axis: str = "row", col_axis: str = "col"):
    """``x`` (2-D, the same on every rank) placed on ``mesh`` in blocks:
    rows split over ``row_axis``, columns over ``col_axis``, replicated over
    the others; a ``DTensor`` placed ``[Replicate(), Shard(0), Shard(1)]``
    on ``image_mesh``, the counterpart of JAX's ``NamedSharding(mesh,
    P(row_axis, col_axis))``. Each rank keeps its block, on the mesh's
    device type; no data moves between ranks. A shape the mesh does not
    divide raises ``ValueError``, as JAX's ``device_put`` does, and so does
    an image on a device other than the host's or the mesh's: a card image
    never moves to a host mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    x = torch.as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"shard_image takes a 2-D image, got shape {tuple(x.shape)}")
    if x.device.type not in ("cpu", mesh.device_type):
        raise ValueError(f"an image on {x.device} does not go to a {mesh.device_type!r} mesh")
    names = mesh.mesh_dim_names
    for axis in (row_axis, col_axis):
        if axis not in names:
            raise ValueError(f"mesh has no axis {axis!r}: {names}")
    block = []
    for dim, axis in enumerate((row_axis, col_axis)):
        n, size = x.shape[dim], mesh.size(names.index(axis))
        if n % size:
            raise ValueError(f"image dimension {dim} of size {n} is not divisible by the "
                             f"{size} ranks of mesh axis {axis!r} (shape {tuple(x.shape)})")
        k = mesh.get_local_rank(axis)
        block.append(slice(k * (n // size), (k + 1) * (n // size)))
    placements = [Shard(0) if a == row_axis else Shard(1) if a == col_axis else Replicate()
                  for a in names]
    local = x[block[0], block[1]].contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=x.shape,
                              stride=(x.shape[1], 1))


def mesh_share(mesh, n_chains: int, axis: str = "chains"):
    """``(first, count)``: the chains of ``n_chains`` that this rank of
    ``mesh`` runs, a contiguous block of ``n_chains / size``."""
    n_dev = mesh.size(mesh.mesh_dim_names.index(axis))
    if n_chains % n_dev != 0:
        raise ValueError(f"n_chains={n_chains} not divisible by mesh axis {n_dev}")
    per = n_chains // n_dev
    return mesh.get_local_rank(axis) * per, per


def gather_chains(tree, mesh, axis: str = "chains"):
    """Every tensor of ``tree`` (with a leading chain axis) gathered over the
    mesh axis along that axis, rank after rank; 0-d tensors, Python values
    and None stay. The traversal is the same on every rank, so the
    collectives pair up. NCCL gathers on the card, gloo on the host (an
    ``image_mesh`` on the card may run gloo); each result returns to its
    tensor's device."""
    group = mesh.get_group(axis)
    size = dist.get_world_size(group)
    where = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")

    def gather(t):
        if not isinstance(t, torch.Tensor) or t.ndim == 0:
            return t
        src = t.detach().to(where).contiguous()
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts).to(t.device)

    return _map(gather, tree)


def run_chains_sharded(
    kernel,
    x0,
    key,
    n_steps: int,
    n_chains: int,
    mesh=None,
    axis: str = "chains",
    batched: Optional[bool] = None,
    **kwargs,
) -> ChainResult:
    """Shard ``n_chains`` independent chains across the mesh axis.

    Each rank runs its ``n_chains / size`` chains (``run_keyed_chains``: one
    step over all of them for a kernel with ``chain_axis``), chain ``c``
    under ``chain_keys(key, n_chains)[c]``; every ``ChainResult`` field comes
    back to every rank with the global leading chain axis. ``x0`` may be one
    position (broadcast) or carry a leading chain axis (per-chain starts);
    ``batched`` overrides the shape inference as in ``run_chains``. ``mesh``
    defaults to ``chain_mesh()``."""
    mesh = mesh if mesh is not None else chain_mesh(axis=axis)
    first, per = mesh_share(mesh, n_chains, axis)
    keys = chain_keys(key, n_chains)
    if batched is None:
        batched = _is_batched(x0, n_chains)
    if batched:
        x0 = _map(lambda l: l[first:first + per], x0)
    res = run_keyed_chains(kernel, x0, keys[first:first + per], n_steps,
                           batched=batched, **kwargs)
    return gather_chains(res, mesh, axis)


def merge_chain_moments(moments: RunningMoments) -> RunningMoments:
    """Pool per-chain moments (a ``RunningMoments`` with a leading chain
    axis; ``count`` per chain or one count for all) into one, chain by chain
    in order with the Chan et al. combine."""
    n = moments.mean.shape[0]
    counts = torch.as_tensor(moments.count).reshape(-1).tolist()
    counts = counts * n if len(counts) == 1 else counts

    def chain(i):
        return RunningMoments(count=int(counts[i]), mean=moments.mean[i],
                              m2=moments.m2[i])

    pooled = chain(0)
    for i in range(1, n):
        pooled = pooled.merge(chain(i))
    return pooled
