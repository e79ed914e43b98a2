"""The sharded path of the ops: each rank's block of an image split over
ranks (a ``DTensor`` of ``parallel.shard_image``), and the two exchanges
that let the operators run on it, written on ``torch.distributed``.

In the JAX package ``jit`` with a ``NamedSharding`` leaves the collectives
to GSPMD. PyTorch has no such pass: a ``DTensor`` meets ``torch.roll`` along
a sharded dimension or ``torch.fft`` by gathering the whole image on every
rank. So the sharded operators of the port run on each rank's block
(``DTensor.to_local``) through two exchanges on the process groups of the
mesh's ``row`` and ``col`` dimensions:

  * ``halo``: the block extended by ``h`` rows above and below and ``h``
    columns left and right from its neighbours (none past the image's
    edges, where the TV stencil is Neumann). ``prox_tv_iso`` runs on the
    extended block (``halo_map``) and keeps the interior: the cut edges act
    as Neumann edges, whose error travels one row a Chambolle trip, so ``h
    = niter + 1`` rows leave the interior equal to the whole-image prox;
  * the transposed FFT (``spectral_map``): an all-to-all on the ``col``
    group makes rows whole for the ``rfft`` along x, a second one and an
    all-to-all on the ``row`` group make the columns of the ``nx // 2 + 1``
    half-plane whole for the FFT along y; the spectral product takes the
    matching columns of the operator's spectrum, and the inverse path
    retraces the steps. ``CirculantBlur2D`` and ``L2Data`` run on it.

``normal_block`` draws a rank's block of the one-device noise field.

Every exchange is one ``all_to_all_single`` of flat element splits (the
half-plane's width is uneven: 257 at 512^2). NCCL moves card tensors; gloo
(several ranks on one card, or no card) moves host copies and the result
returns to its block's device, where all the arithmetic stays.
``torch.distributed.tensor`` is imported at first use (it costs about a
second): ``is_sharded`` is false until something imported it. The module
imports torch and ``core.random`` only, so the ops below the parallel layer
can use it; ``parallel/image.py`` gathers a split image whole.
"""
from __future__ import annotations

import math
import sys
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from lmc_atomi_torch.core.random import normal_field

__all__ = ["is_sharded", "block_grid", "halo", "halo_map", "spectral_map", "normal_block"]


def is_sharded(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (an image placed by ``shard_image``)."""
    dt = sys.modules.get("torch.distributed.tensor")
    return dt is not None and isinstance(x, dt.DTensor)


class Grid(NamedTuple):
    """Where a rank's block lies: the global ``shape``, the ``rows x cols``
    grid of blocks, this rank's ``(r, c)`` and the ``row`` and ``col``
    process groups (None for a dimension of one block)."""

    shape: Tuple[int, int]
    rows: int
    cols: int
    r: int
    c: int
    row_group: Optional[object]
    col_group: Optional[object]

    @property
    def block(self) -> Tuple[int, int]:
        return self.shape[0] // self.rows, self.shape[1] // self.cols

    @property
    def origin(self) -> Tuple[int, int]:
        by, bx = self.block
        return self.r * by, self.c * bx


def _grid(mesh, row_dim, col_dim, block) -> Grid:
    """The ``Grid`` of this rank's ``block`` (its shape) on ``mesh``, rows
    split over mesh dimension ``row_dim`` and columns over ``col_dim``
    (None: not split)."""

    def axis(d):
        if d is None:
            return 1, 0, None
        return mesh.size(d), mesh.get_local_rank(d), mesh.get_group(d)

    rows, r, row_group = axis(row_dim)
    cols, c, col_group = axis(col_dim)
    shape = (int(block[0]) * rows, int(block[1]) * cols)
    return Grid(shape, rows, cols, r, c, row_group if rows > 1 else None,
                col_group if cols > 1 else None)


def block_grid(x) -> Grid:
    """The ``Grid`` of a DTensor image: its mesh dimensions placed
    ``Shard(0)`` and ``Shard(1)``, every other one ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    if x.ndim != 2:
        raise ValueError(f"a sharded image is 2-D, got shape {tuple(x.shape)}")
    dims = {0: None, 1: None}
    for d, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim in dims and dims[p.dim] is None:
            dims[p.dim] = d
        elif not isinstance(p, Replicate):
            raise ValueError(f"image sharding takes (row, col) blocks, got {x.placements}")
    grid = _grid(x.device_mesh, dims[0], dims[1], x.to_local().shape)
    if grid.shape != tuple(x.shape):
        raise ValueError(f"image {tuple(x.shape)} does not divide into {grid.rows} x "
                         f"{grid.cols} blocks")
    return grid


def _wrap(local, like):
    """``local`` as a DTensor with ``like``'s mesh, placements and shape."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def _splits(n: int, parts: int):
    """``torch.tensor_split``'s sizes of ``n`` into ``parts``: the first
    ``n % parts`` one longer."""
    q, rem = divmod(n, parts)
    return [q + (i < rem) for i in range(parts)]


def _bounds(sizes: Sequence[int]):
    """``[(start, stop)]`` of consecutive pieces of ``sizes``."""
    out, at = [], 0
    for s in sizes:
        out.append((at, at + s))
        at += s
    return out


def _all_to_all(send, recv_shapes, group):
    """Piece ``i`` of ``send`` to group rank ``i``; returns the pieces
    received, of ``recv_shapes``, on ``send``'s device. One
    ``all_to_all_single`` of flat element splits, on host copies under
    gloo. A group of one (``None``) returns ``send`` as it is."""
    if group is None:
        return list(send)
    dev, cplx = send[0].device, send[0].is_complex()

    def flat(t):
        return (torch.view_as_real(t) if cplx else t).reshape(-1)

    where = torch.device("cpu") if dist.get_backend(group) == "gloo" else dev
    flats = [flat(t) for t in send]
    buf = torch.cat(flats).to(where)
    in_splits = [f.numel() for f in flats]
    per = 2 if cplx else 1
    out_splits = [math.prod(s) * per for s in recv_shapes]
    out = torch.empty(sum(out_splits), dtype=buf.dtype, device=where)
    dist.all_to_all_single(out, buf, out_splits, in_splits, group=group)
    out = out.to(dev)
    pieces = []
    for p, s in zip(out.split(out_splits), recv_shapes):
        pieces.append(torch.view_as_complex(p.reshape(tuple(s) + (2,))) if cplx
                      else p.reshape(s))
    return pieces


def _pads(grid: Grid, h: int):
    """``(top, left)``: the rows ``halo`` adds above the block and the
    columns it adds on the left, ``h`` each, fewer at the image's edges."""
    y0, x0 = grid.origin
    return min(h, y0), min(h, x0)


def _extend(block, axis: int, h: int, n: int, count: int, me: int, group):
    """``block`` (the ``me``-th of ``count`` along ``axis`` of an extent
    ``n``) extended by up to ``h`` lines each side from the blocks that hold
    them, as many neighbours as that takes."""
    if group is None or h <= 0:
        return block
    b = n // count

    def need(q):
        return max(0, q * b - h), min(n, (q + 1) * b + h)

    def overlap(q, lo, hi):
        return max(q * b, lo), min((q + 1) * b, hi)

    def lines(t, lo, hi):
        return t.narrow(axis, lo, hi - lo) if hi > lo else t.narrow(axis, 0, 0)

    send, shapes = [], []
    my_lo, my_hi = need(me)
    for q in range(count):
        if q == me:
            send.append(lines(block, 0, 0))
            shapes.append(tuple(lines(block, 0, 0).shape))
            continue
        lo, hi = overlap(me, *need(q))
        send.append(lines(block, lo - me * b, hi - me * b).contiguous())
        lo, hi = overlap(q, my_lo, my_hi)
        shape = list(block.shape)
        shape[axis] = max(hi - lo, 0)
        shapes.append(tuple(shape))
    got = _all_to_all(send, shapes, group)
    got[me] = block
    return torch.cat(got, dim=axis)


def halo(x_local, h: int, mesh):
    """This rank's block ``x_local`` of an image split over ``mesh`` (rows
    over its ``row`` dimension, columns over ``col``, as ``shard_image``
    places it) extended by ``h`` rows above and below from the row
    neighbours, then (with more than one column of blocks) by ``h`` columns
    left and right from the column neighbours: the extended rows travel too,
    which fills the corners. Nothing is added past the image's edges; a
    block thinner than ``h`` takes lines from as many neighbours as it
    needs. Every rank of the mesh calls it."""
    names = mesh.mesh_dim_names
    return _halo(x_local, h, _grid(mesh, names.index("row"), names.index("col"), x_local.shape))


def _halo(x_local, h: int, grid: Grid):
    ext = _extend(x_local, 0, h, grid.shape[0], grid.rows, grid.r, grid.row_group)
    return _extend(ext, 1, h, grid.shape[1], grid.cols, grid.c, grid.col_group)


def halo_map(fn: Callable, x, h: int):
    """``fn`` on each rank's block of the DTensor image ``x`` extended by
    ``halo(h)``, cut back to the block: equal to ``fn`` on the whole image
    where ``fn``'s value at a pixel depends only on pixels within ``h``
    rows and columns of it."""
    grid = block_grid(x)
    top, left = _pads(grid, h)
    by, bx = grid.block
    out = fn(_halo(x.to_local(), h, grid))
    return _wrap(out[top:top + by, left:left + bx].contiguous(), x)


def _freq_cols(grid: Grid) -> Tuple[int, int]:
    """The half-plane columns ``[lo, hi)`` whose whole columns this rank
    holds between the transposed FFT's passes: piece ``c`` of the ``nx // 2
    + 1`` columns split over the column blocks, then piece ``r`` of that
    over the row blocks."""
    nxh = grid.shape[1] // 2 + 1
    lo_c, hi_c = _bounds(_splits(nxh, grid.cols))[grid.c]
    lo, hi = _bounds(_splits(hi_c - lo_c, grid.rows))[grid.r]
    return lo_c + lo, lo_c + hi


def _rfft2(x_local, grid: Grid):
    """Forward pass: the local ``(ny, hi - lo)`` slice of ``rfft2`` of the
    image, the columns ``_freq_cols``."""
    by, bx = grid.block
    nx = grid.shape[1]
    nxh = nx // 2 + 1
    sub = _bounds(_splits(by, grid.cols))  # the band's rows, one piece a column block
    rows_c = sub[grid.c][1] - sub[grid.c][0]
    # whole rows of this rank's piece of the band
    whole = _all_to_all([x_local[a:b].contiguous() for a, b in sub],
                        [(rows_c, bx)] * grid.cols, grid.col_group)
    spec = torch.fft.rfft(torch.cat(whole, dim=1), dim=1)
    # the band's rows, the column block's share of the half plane
    fc = _bounds(_splits(nxh, grid.cols))
    band = _all_to_all([spec[:, a:b].contiguous() for a, b in fc],
                       [(b - a, fc[grid.c][1] - fc[grid.c][0]) for a, b in sub],
                       grid.col_group)
    band = torch.cat(band, dim=0)
    # every row, this rank's share of the column block's half plane
    fr = _bounds(_splits(band.shape[1], grid.rows))
    cols = _all_to_all([band[:, a:b].contiguous() for a, b in fr],
                       [(by, fr[grid.r][1] - fr[grid.r][0])] * grid.rows, grid.row_group)
    return torch.fft.fft(torch.cat(cols, dim=0), dim=0)


def _irfft2(spec, grid: Grid):
    """Inverse of ``_rfft2``: the rank's real ``(by, bx)`` block of
    ``irfft2`` of the half plane whose columns ``_freq_cols`` it holds."""
    by, bx = grid.block
    nx = grid.shape[1]
    nxh = nx // 2 + 1
    cols = torch.fft.ifft(spec, dim=0)
    fc = _bounds(_splits(nxh, grid.cols))
    fr = _bounds(_splits(fc[grid.c][1] - fc[grid.c][0], grid.rows))
    band = _all_to_all([cols[a:a + by].contiguous() for a in range(0, grid.shape[0], by)],
                       [(by, b - a) for a, b in fr], grid.row_group)
    band = torch.cat(band, dim=1)
    sub = _bounds(_splits(by, grid.cols))
    rows_c = sub[grid.c][1] - sub[grid.c][0]
    whole = _all_to_all([band[a:b].contiguous() for a, b in sub],
                        [(rows_c, b - a) for a, b in fc], grid.col_group)
    real = torch.fft.irfft(torch.cat(whole, dim=1), n=nx, dim=1)
    block = _all_to_all([real[:, a:a + bx].contiguous() for a in range(0, nx, bx)],
                        [(b - a, bx) for a, b in sub], grid.col_group)
    return torch.cat(block, dim=0)


def spectral_map(fn: Callable, *images):
    """``irfft2(fn(cols, *rfft2(images)))`` of DTensor images placed alike,
    through the transposed FFT: ``fn`` gets the slice ``cols`` of the
    half-plane columns this rank holds (for an ``(ny, nx // 2 + 1)``
    spectrum ``s``, ``s[:, cols]``) and each image's spectrum on them, and
    returns one spectrum on the same columns. The result is placed as the
    first image."""
    grid = block_grid(images[0])
    for im in images[1:]:
        if im.placements != images[0].placements or im.shape != images[0].shape:
            raise ValueError("spectral_map takes images placed alike")
    lo, hi = _freq_cols(grid)
    specs = [_rfft2(im.to_local(), grid) for im in images]
    return _wrap(_irfft2(fn(slice(lo, hi), *specs), grid), images[0])


def normal_block(seed: int, chain, step, x):
    """``core.random.normal_field`` of the whole image, drawn on each
    rank's block only (each pixel keeps its global counter) and placed as
    the DTensor ``x``."""
    grid = block_grid(x)
    local = x.to_local()
    return _wrap(normal_field(seed, chain, step, tuple(local.shape), local.dtype, local.device,
                              origin=grid.origin, global_shape=grid.shape), x)
