"""Resumable long runs in checkpointed segments (counterpart of
``lmc_atomi_tpu/run/longrun.py``).

A run of ``total_steps`` executes as host-level segments; after each one the
whole bundle (position or sampler state, streaming moments, marker state,
base key, steps done) is checkpointed, so a preempted run resumes where its
last checkpoint left it. The noise of step ``g`` is keyed by the global
step itself (``(seed, chain, g)``, ``core/random.py``), so a segmented run
draws exactly the noise of a straight one and its position equals the
straight run's; the moments merge with the Chan et al. combine.

A diverged chain raises ``FloatingPointError`` at the segment boundary,
before the checkpoint is overwritten, so the last good checkpoint stays.

A chain farm (``x0`` of shape ``(C, ny, nx)``) runs ``C`` chains of one
posterior under ``core.random.chain_keys``, fixed for the whole run, and
carries per-chain moments, markers and ULPDA state in the bundle.
"""
from __future__ import annotations

import os
from typing import TYPE_CHECKING, Callable, Optional

import torch

from lmc_atomi_torch.core.checkpoint import restore_checkpoint, save_checkpoint
from lmc_atomi_torch.core.random import chain_keys
from lmc_atomi_torch.core.stats import RunningMoments
from lmc_atomi_torch.run.runner import base_key, stack_tree

if TYPE_CHECKING:  # kernels/ imports run/: the kernels are imported where they run
    from lmc_atomi_torch.kernels.base import Kernel

__all__ = ["run_resumable", "run_resumable_fused"]

RUNNERS = ("tv", "wavelet", "tiled", "ulpda_tiled")


def _check_finite(pos, done: int, n: int, ckpt_path: Optional[str]) -> None:
    if not bool(torch.isfinite(pos).all()):
        raise FloatingPointError(
            f"chain diverged (non-finite position) before step {done + n}; "
            f"last checkpoint at {done} steps"
            + (f" in {ckpt_path}" if ckpt_path else ""))


def _finish_segment(bundle, ckpt_path, progress):
    if ckpt_path:
        save_checkpoint(ckpt_path, bundle)
    if progress is not None:
        progress(int(bundle["done"]), bundle)


def run_resumable(
    kernel: Kernel,
    x0,
    key,
    total_steps: int,
    segment_steps: int,
    ckpt_path: Optional[str] = None,
    burn_in: int = 0,
    progress: Optional[Callable[[int, dict], None]] = None,
):
    """Run ``total_steps`` kernel steps in checkpointed segments. Moments
    accumulate over steps ``g >= burn_in``. Returns the bundle
    ``{state, moments, key, done}``; resumes from ``ckpt_path`` if it
    exists."""
    seed, chain = base_key(key)
    state = kernel.init(x0)
    bundle = {"state": state, "moments": RunningMoments.init(state.position),
              "key": (seed, chain), "done": 0}
    if ckpt_path and os.path.exists(ckpt_path):
        bundle = restore_checkpoint(ckpt_path, bundle)
    while bundle["done"] < total_steps:
        done = bundle["done"]
        n = min(segment_steps, total_steps - done)
        st, mom = bundle["state"], bundle["moments"]
        for _ in range(n):
            st, _ = kernel.step(st, (seed, chain, st.step))
            mom = mom.update(st.position, weight=st.step > burn_in)
        _check_finite(st.position, done, n, ckpt_path)
        bundle = {"state": st, "moments": mom, "key": (seed, chain),
                  "done": done + n}
        _finish_segment(bundle, ckpt_path, progress)
    return bundle


def _farm_segment(one_chain, runner, x, keys, n, qstate, extras, kw):
    """One segment of the farm's chains ``x`` under ``keys``: one runner
    call on the chain axis, whose block calls each carry every chain (one
    kernel call a block for kernels 2 and 4, a step for kernels 6 and 7).
    Returns the positions, the segment's per-chain moments (a
    ``RunningMoments`` with a chain axis), the marker state and the ULPDA
    extras."""
    res = one_chain(x, keys, n, qstate, extras, **kw)
    count = torch.full((x.shape[0],), res.moments.count, dtype=torch.int64)
    seg = RunningMoments(count, res.moments.mean, res.moments.m2)
    if runner == "ulpda_tiled":
        extras = (res.final_state.extras.y, res.final_state.extras.xprev)
    return res.final_state.position, seg, res.quantile_state, extras


def run_resumable_fused(
    l2,
    tv_sigma: float,
    tau,
    gamma,
    x0,
    key,
    total_steps: int,
    segment_steps: int,
    ckpt_path: Optional[str] = None,
    burn_in: int = 0,
    progress: Optional[Callable[[int, dict], None]] = None,
    runner: str = "tv",
    chains_mesh=None,
    **fused_kwargs,
):
    """Checkpointed long MYULA runs on the block-fused path: each segment is
    one fused chain call starting at the global step ``done``.

    ``runner`` ``"tv"`` runs ``run_myula_tv_fused`` (``tv_sigma`` the TV
    weight), ``"wavelet"`` ``run_myula_wavelet_fused`` on an
    ``L2Data(Mask)`` inpainting posterior (``tv_sigma`` the wavelet-l1
    weight; ``levels``/``taps`` pass through ``fused_kwargs``), ``"tiled"``
    ``run_myula_tv_tiled`` (the large-image kernel; ``segment_steps`` even)
    and ``"ulpda_tiled"`` ``run_ulpda_tv_tiled`` with an ``L21Norm`` dual of
    weight ``tv_sigma`` and dual step ``mu = gamma``: its dual and previous
    sample ``(y, xprev)`` ride in the bundle (``"ulpda_extras"``) and the
    checkpoint, so a resumed primal-dual run continues bit for bit. The P^2
    ``quantiles`` stream rides in the bundle and the checkpoint; the bundle
    gains ``"quantiles"`` (the maps) at the end. Returns the bundle
    ``{position, moments, key, done[, quantile_state, ulpda_extras,
    quantiles]}``.

    A chain farm: an ``x0`` of shape ``(C, ny, nx)`` runs ``C`` chains of
    the posterior, chain ``c`` under ``chain_keys(key, C)[c]`` for the whole
    run (the global step is in Philox's counter, so a resumed farm goes on
    bit for bit and each chain equals the one-chain run under its key). The
    bundle then holds per-chain positions, moments (counts ``(C,)``), marker
    state ``(C, 5 n_q, ny, nx)`` and, for ``"ulpda_tiled"``, ``(y, xprev)``
    with ``y`` ``(C, 2, ny, nx)``; pool them with
    ``parallel.mesh.merge_chain_moments`` and ``eval.diagnostics``'
    ``rhat_from_moments``. Every runner runs the farm as one call a
    segment on the chain axis: a kernel-2 or kernel-4 call a block, a
    kernel-6 or kernel-7 call a step, each carrying every chain, as the JAX
    package's ``jax.vmap`` of a ``pallas_call`` runs one kernel for all
    chains.

    ``chains_mesh`` (``parallel.mesh.chain_mesh``) spreads a farm over the
    ranks of its process group: each rank runs its block of the chains
    (``mesh_share``) as above, the segment's positions, moments, marker
    state and ULPDA extras are gathered to every rank at its end, and rank
    0 alone writes the checkpoint (a barrier follows). The bundle holds the
    whole farm on every rank, so a farm saved by some number of ranks
    resumes on any other, and its result equals the farm's without a mesh
    bit for bit.
    """
    from lmc_atomi_torch.kernels.myula_fused import _marker_state, run_myula_tv_fused
    from lmc_atomi_torch.kernels.myula_tiled import run_myula_tv_tiled
    from lmc_atomi_torch.kernels.ulpda_tiled import run_ulpda_tv_tiled
    from lmc_atomi_torch.kernels.wavelet_fused import run_myula_wavelet_fused
    from lmc_atomi_torch.ops.functionals import L21Norm
    from lmc_atomi_torch.ops.linops import Gradient2D

    if runner not in RUNNERS:
        raise ValueError(f"unknown runner {runner!r}")
    x0 = torch.as_tensor(x0)
    farm = x0.ndim == 3
    if chains_mesh is not None and not farm:
        raise ValueError("chains_mesh runs a chain farm: x0 of shape (C, ny, nx)")
    seed, chain = base_key(key)
    keys = chain_keys((seed, chain), x0.shape[0]) if farm else None
    mine, writer = slice(None), True
    if chains_mesh is not None:
        from lmc_atomi_torch.parallel.mesh import gather_chains, mesh_share

        first, per = mesh_share(chains_mesh, x0.shape[0])
        mine, writer = slice(first, first + per), torch.distributed.get_rank() == 0
        keys = keys[mine]
    quantiles = tuple(float(p) for p in fused_kwargs.pop("quantiles", ()))
    bundle = {"position": x0,
              "moments": (stack_tree([RunningMoments.init(x) for x in x0]) if farm
                          else RunningMoments.init(x0)),
              "key": (seed, chain), "done": 0}
    if quantiles:
        bundle["quantile_state"] = _marker_state(x0, len(quantiles), None)
    if runner == "ulpda_tiled":
        # the stacked dual and the previous sample; x_prev = x0 is the cold
        # start
        lead, field = tuple(x0.shape[:-2]), tuple(x0.shape[-2:])
        bundle["ulpda_extras"] = (torch.zeros(lead + (2,) + field, dtype=x0.dtype,
                                              device=x0.device), x0)
    if ckpt_path and os.path.exists(ckpt_path):
        bundle = restore_checkpoint(ckpt_path, bundle)

    def one_chain(x, k, n, qstate, extras, **kw):
        if runner == "ulpda_tiled":
            y0, xprev0 = extras
            return run_ulpda_tv_tiled(l2, L21Norm(sigma=tv_sigma), Gradient2D(), tau,
                                      gamma, x, k, n, y0=y0, xprev0=xprev0,
                                      quantile_state=qstate, **kw)
        run = {"tv": run_myula_tv_fused, "wavelet": run_myula_wavelet_fused,
               "tiled": run_myula_tv_tiled}[runner]
        return run(l2, tv_sigma, tau, gamma, x, k, n, quantile_state=qstate, **kw)

    while bundle["done"] < total_steps:
        done = bundle["done"]
        n = min(segment_steps, total_steps - done)
        kw = dict(burn_in=burn_in, quantiles=quantiles, step_offset=done,
                  **fused_kwargs)
        qstate, extras = bundle.get("quantile_state"), bundle.get("ulpda_extras")
        if not farm:
            res = one_chain(bundle["position"], (seed, chain), n, qstate, extras, **kw)
            pos, qstate = res.final_state.position, res.quantile_state
            if runner == "ulpda_tiled":
                extras = (res.final_state.extras.y, res.final_state.extras.xprev)
            moments = bundle["moments"].merge(res.moments)
        else:
            pos, seg, qstate, extras = _farm_segment(
                one_chain, runner, bundle["position"][mine], keys, n,
                qstate and tuple(q[mine] for q in qstate),
                extras and tuple(e[mine] for e in extras), kw)
            if chains_mesh is not None:
                pos, seg, qstate, extras = gather_chains((pos, seg, qstate, extras),
                                                         chains_mesh)
            prev = bundle["moments"]
            counts = seg.count.tolist()
            moments = stack_tree([
                RunningMoments(int(prev.count[c]), prev.mean[c], prev.m2[c]).merge(
                    RunningMoments(counts[c], seg.mean[c], seg.m2[c]))
                for c in range(pos.shape[0])])
        _check_finite(pos, done, n, ckpt_path)
        new = {"position": pos, "moments": moments, "key": (seed, chain),
               "done": done + n}
        if quantiles:
            new["quantile_state"] = qstate
        if runner == "ulpda_tiled":
            new["ulpda_extras"] = extras
        bundle = new
        _finish_segment(bundle, ckpt_path if writer else None, progress)
        if chains_mesh is not None and ckpt_path:
            torch.distributed.barrier(group=chains_mesh.get_group())
    if quantiles:
        qh = bundle["quantile_state"][0]
        bundle["quantiles"] = {p: qh[..., 5 * j + 2, :, :] for j, p in enumerate(quantiles)}
    return bundle
