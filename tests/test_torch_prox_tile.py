"""Kernels 1 and 8's tile schedule on the CPU: a torch emulation of it held
bit for bit to the plain versions, and its planner ``prox_plan`` against a
brute-force search of the same cost.

On the card kernel 1 (``prox_tv_iso_cuda``) and kernel 8
(``myula_tv_fused_update_cuda``) run one kernel template,
``csrc/tv_prox.cu::tv_prox_tile``: a CTA holds a halo tile of the image (its
interior ty x tx grown by ``h = k + 1``) and runs the ``niter`` cold
Chambolle trips in segments of at most ``k``, trip ``tr`` of a segment of
``kk`` on the interior grown by ``kk - tr``; between two segments each CTA
writes its interior's dual to device memory and reloads its whole tile's
dual from there, through a grid barrier (the ``"resident"`` route) or a new
launch (``"launches"``); with ``k = niter`` there is one segment (``"cone"``,
or ``"resident"`` on a grid that fits the card at once). A tile whose rows
and columns avoid image row ``ny - 1`` and column ``nx - 1`` computes
without the forward-difference masks. ``_emulate`` runs that schedule tile
by tile in torch ops on a geometry of ``prox_plan``'s ranking, on a card
shrunk through ``n_sm`` and ``smem_limit`` so that the images have ragged,
edge and edge-free tiles. It sets every pixel outside a pass's rectangle to
NaN after the pass and x outside the interior grown by ``k``, and the
exchanged dual is a NaN field that only the interiors the CTAs write fill,
so a read outside the cone, a stale halo or a mask dropped on a tile that
needs it makes it differ from the plain versions. With a correct schedule every interior pixel takes the same
operations on the same values, so they agree bit for bit.
"""
import itertools

import numpy as np
import pytest
import torch

from lmc_atomi_torch.core.random import normal_field
from lmc_atomi_torch.kernels import myula_cuda
from lmc_atomi_torch.kernels.myula_fused import H100_SMEM_OPTIN, H100_SMS
from lmc_atomi_torch.ops import tv_cuda
from lmc_atomi_torch.ops.tv_cuda import _stencils

torch.set_num_threads(2)

GAMMA = 0.3 * 0.75**2
TAU = 0.2 * 0.75**2


def _free_stencils():
    """The stencils of an edge-free tile: every mask at "keep"."""
    def fwd_y(a):
        return torch.roll(a, -1, 0) - a

    def fwd_x(a):
        return torch.roll(a, -1, 1) - a

    def div(py, px):
        return (py - torch.roll(py, 1, 0)) + (px - torch.roll(px, 1, 1))

    return fwd_y, fwd_x, div


def _tile_free(by, bx, ty, tx, h, ny, nx):
    """The edge-free rule (``block_common.cuh::lmc_tile_free``)."""
    y0, x0 = by * ty - h, bx * tx - h
    return y0 >= 0 and x0 >= 0 and y0 + ty + 2 * h <= ny - 1 and x0 + tx + 2 * h <= nx - 1


def _emulate(x, gamma, niter, step, plan, tail=None):
    """The kernel's schedule on ``plan``: kernel 1's prox, or with ``tail =
    (grad, key, tau, gamma_myula)`` kernel 8's step. Returns the output and
    the number of edge-free tiles."""
    route, ty, tx, h, k = plan[:5]
    ny, nx = x.shape
    nan = torch.tensor(float("nan"), dtype=x.dtype)
    n_seg = -(-niter // k) if k else 1
    tiles = list(itertools.product(range(-(-ny // ty)), range(-(-nx // tx))))
    gdual = None  # the dual exchanged between two segments
    out = torch.full_like(x, float("nan"))
    n_free = sum(_tile_free(by, bx, ty, tx, h, ny, nx) for by, bx in tiles)
    for s in range(n_seg):
        kk = min(k, niter - s * k)
        new = (torch.full_like(x, float("nan")), torch.full_like(x, float("nan")))
        for by, bx in tiles:
            rows = torch.arange(by * ty - h, (by + 1) * ty + h) % ny
            cols = torch.arange(bx * tx - h, (bx + 1) * tx + h) % nx
            ri = torch.arange(len(rows))[:, None]
            ci = torch.arange(len(cols))[None, :]

            def grown(e):
                return ((ri >= h - e) & (ri < h + ty + e)
                        & (ci >= h - e) & (ci < h + tx + e))

            def keep(a, e):
                return torch.where(grown(e), a, nan)

            if _tile_free(by, bx, ty, tx, h, ny, nx):
                fwd_y, fwd_x, div = _free_stencils()
            else:
                my = (rows != ny - 1).to(x.dtype)[:, None]
                mx = (cols != nx - 1).to(x.dtype)[None, :]
                fwd_y, fwd_x, div = _stencils(x[rows][:, cols], (my, mx))
            xt = keep(x[rows][:, cols], k)
            xg = xt / gamma
            if s == 0:
                py = px = torch.zeros_like(xt)
            else:  # the whole tile's dual reloaded, nothing kept from before
                py, px = gdual[0][rows][:, cols], gdual[1][rows][:, cols]
            for tr in range(kk):
                e = kk - tr
                u = keep(div(py, px) - xg, e)
                gy = fwd_y(u)
                gx = fwd_x(u)
                mag = torch.sqrt(gy * gy + gx * gx)
                denom = 1.0 + step * mag
                py, px = keep((py + step * gy) / denom, e), keep((px + step * gx) / denom, e)
            r0, c0 = by * ty, bx * tx
            r1, c1 = min(r0 + ty, ny), min(c0 + tx, nx)
            inner = (slice(h, h + r1 - r0), slice(h, h + c1 - c0))
            img = (slice(r0, r1), slice(c0, c1))
            if s + 1 < n_seg:
                new[0][img], new[1][img] = py[inner], px[inner]
                continue
            prox = (xt - gamma * div(py, px))[inner]
            if tail is None:
                out[img] = prox
                continue
            grad, key, tau, gamma_m = tail
            c_keep, c_grad, c_prox, noise_amp, _ = myula_cuda._tail_coefs(tau, gamma_m, gamma,
                                                                         1.0)
            x_new = c_keep * xt[inner] - c_grad * grad[img] + c_prox * prox
            out[img] = x_new + noise_amp * normal_field(*key, x.shape, x.dtype, x.device)[img]
        gdual = new
    return out, n_free


# (niter, k, route): every route, k in {1, 3, niter}
SCHEDULES = [(0, 0, "cone"), (0, 0, "resident"), (1, 1, "cone"), (1, 1, "resident"),
             (3, 1, "resident"), (3, 1, "launches"), (3, 3, "cone"), (3, 3, "resident"),
             (10, 1, "launches"), (10, 3, "resident"), (10, 3, "launches"),
             (10, 10, "cone"), (10, 10, "resident")]
# shrunk cards (n_sm, smem_limit) whose rankings hold ragged, edge and
# edge-free tiles on every route at 64^2 and 48 x 72
CARDS = [(4, 40000), (9, 48000), (16, 60000), (2, 24000)]


def _geometry(shape, niter, k, route, tail):
    """The first geometry of ``prox_plan``'s ranking on one of CARDS with
    ``k`` trips a segment on ``route``, ragged, with edge and edge-free
    tiles."""
    ny, nx = shape
    for card in CARDS:
        for plan in tv_cuda._prox_ranking(ny, nx, niter, tail, *card):
            r, ty, tx, h, kk, _, edge, tiles = plan
            if (r, kk) == (route, k) and 0 < edge < tiles and (ny % ty or nx % tx):
                return plan
    raise AssertionError(f"no {route} geometry with k={k} at {shape}")


@pytest.mark.parametrize("tail, step", [(False, 0.25), (False, 0.2), (True, 0.25)])
@pytest.mark.parametrize("shape", [(64, 64), (48, 72)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("niter, k, route", SCHEDULES)
def test_prox_tile_schedule_equals_plain_versions(niter, k, route, dtype, shape, tail, step):
    """The emulated schedule equals ``prox_tv_iso_ref`` (kernel 1) or
    ``myula_tv_fused_update_ref`` (kernel 8) bit for bit on a ragged tiling
    with edge and edge-free tiles, on each route."""
    rng = np.random.default_rng(niter + 10 * k)
    x = torch.from_numpy(rng.normal(size=shape) * 20 + 100).to(dtype)
    plan = _geometry(shape, niter, k, route, tail)
    if tail:
        grad = torch.from_numpy(rng.normal(size=shape)).to(dtype)
        key = (7, 2, 11)
        got, n_free = _emulate(x, GAMMA, niter, step, plan, (grad, key, TAU, 0.75**2))
        want = myula_cuda.myula_tv_fused_update_ref(x, grad, key, TAU, 0.75**2, GAMMA,
                                                    niter=niter, step=step)
    else:
        got, n_free = _emulate(x, GAMMA, niter, step, plan)
        want = tv_cuda.prox_tv_iso_ref(x, GAMMA, niter=niter, step=step)
    assert n_free == plan[7] - plan[6] > 0
    assert got.dtype == dtype and torch.equal(got, want), float((got - want).abs().max())


def _brute_plan(shape, niter, tail, n_sm, smem_limit):
    """An independent search of the planner's cost (numpy over every
    interior and k, the trip sums in closed form): ``(route, ty, tx, h, k,
    threads)``."""
    ny, nx = shape
    ty, tx = (a.astype(np.int64) for a in np.meshgrid(np.arange(8, ny + 8, 8),
                                                       np.arange(8, nx + 8, 8), indexing="ij"))
    tiles = -(-ny // ty) * -(-nx // tx)
    best = None
    for k in range(1, niter + 1) if niter else [0]:
        h = k + 1
        sy, sx = ty + 2 * h, tx + 2 * h
        n_seg = -(-niter // k) if k else 1

        def trips(n):  # sy sx + sum_{e=1..n} 2 (ty + 2e)(tx + 2e), n <= k < h
            return (sy * sx + 2 * (n * ty * tx + (ty + tx) * n * (n + 1)
                                   + 4 * n * (n + 1) * (2 * n + 1) // 6))

        full, rest = divmod(niter, k) if k else (0, 0)
        work = (ty + 2 * k) * (tx + 2 * k) + (n_seg + tail) * ty * tx + full * trips(k)
        work = work + (trips(rest) if rest or not k else 0)
        cta = 16 * sy * sx + 4 * (sy + sx)
        for threads in (512, 1024):
            per_sm = 1024 // threads
            fits = (cta <= smem_limit) & (per_sm * (cta + 1024) <= smem_limit + 1024)
            waves = -(-tiles // (n_sm * per_sm))
            cost = waves * per_sm * work + (n_seg - 1) * 2500
            for i, j in zip(*np.nonzero(fits)):
                route = ("resident" if waves[i, j] == 1 else "cone" if n_seg == 1
                         else "launches")
                key = (route == "launches", int(cost[i, j]), threads, int(ty[i, j]),
                       int(tx[i, j]), k, route)
                best = key if best is None or key < best else best
    return best[6], best[3], best[4], best[5] + 1, best[5], best[2]


@pytest.mark.parametrize("shape, niter, tail, route", [
    ((512, 512), 10, False, "resident"), ((512, 512), 10, True, "resident"),
    ((2048, 2048), 10, False, "cone"), ((2048, 2048), 10, True, "cone"),
    ((4096, 4096), 10, False, "cone"), ((1024, 1500), 10, False, "cone"),
    ((512, 512), 3, False, "resident"), ((2048, 2048), 60, False, "launches"),
    ((2048, 2048), 64, True, "launches")])
def test_prox_plan_matches_brute_force(shape, niter, tail, route):
    """On the H100 (132 SMs, 227 KB a CTA) ``prox_plan`` picks the geometry
    and route of least cost that an independent search finds: resident at
    512^2, the cone at 2048^2, 4096^2 and 1024 x 1500, one launch a segment
    past the cone's fit; the tile counts follow; the second ask returns the
    cached plan."""
    plan = tv_cuda.prox_plan(shape, niter, tail, H100_SMS, H100_SMEM_OPTIN)
    want = _brute_plan(shape, niter, tail, H100_SMS, H100_SMEM_OPTIN)
    assert plan[:6] == want and plan[0] == route, (plan, want)
    ny, nx = shape
    _, ty, tx, h = plan[:4]
    assert plan[7] == -(-ny // ty) * -(-nx // tx)
    assert plan[6] == sum(not _tile_free(by, bx, ty, tx, h, ny, nx)
                          for by in range(-(-ny // ty)) for bx in range(-(-nx // tx)))
    assert tv_cuda.prox_plan(shape, niter, tail, H100_SMS, H100_SMEM_OPTIN) is plan


def test_prox_plan_none_when_nothing_fits():
    """No tile of halo 2 fits 2 KB of shared memory: no plan (the
    wrappers then raise)."""
    assert tv_cuda.prox_plan((64, 64), 10, False, 4, 2000) is None
