#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --turns KERNELS ROOT [ROOT ...]
    python3 chip_smoke.py --clock [ROOT ...]

Phases, one line each; any failure raises and the script exits non-zero:

1. device: the card, its power limit, and the torch/CUDA/nvcc versions;
2. build: the CUDA kernels from ``lmc_atomi_torch/csrc`` (one nvcc per source),
   in a thread beside the mixtures path (9c), which launches no kernel of
   the port and runs first; the kernel checks wait for the build;
3. kernel 1 (``prox_tv_iso_cuda``) against its plain torch version, bit for
   bit, at 512^2 (the resident route), 2048^2 (the cone) and 1024 x 1500
   (ragged tiles) for niter 0, 3, 10 and 20, and at 2048^2 for niter 60 (one
   launch a segment); then timed per call at 512^2 and 2048^2;
4. kernel 2 (``myula_tv_block_update_cuda``) against its plain version at
   512^2, 40 steps in blocks of 20, noise on (the same Philox stream on both
   sides), for cold-10 Chambolle, FGP-8, warm-5 and cold-10 with 95% CI
   markers, and for the MC-TV and ME-TV modes of the deconvolution models,
   bit for bit, each call on the resident route; then timed per solver and
   mode with CUDA events, per 500-step call and per one-step call;
5. kernel 3 (``ulpda_block_update_cuda``) the same way for the
   deconvolution models (l21/tv, l1/mctv, l21/metv in both ``gfirst``
   orders, FGP with the warm envelope dual, and model M10's 4-level Haar
   ``wl1`` dual in both orders, and at 6 levels), bit for bit, every call
   of a Gradient2D dual on the resident route and the wl1 dual's on the
   launch sequence; then timed per mode per 500-step call and per one-step
   call;
5b. kernels 4 and 5 (``wavelet_block_update_cuda``,
   ``ulpda_wavelet_block_update_cuda``) the same way on the inpainting
   posterior, bit for bit on every route, each call on the route named:
   ``"warp"`` (512^2 Haar, 3 levels, kernel 4 also with 95% CI markers),
   ``"tile"`` (Haar, 5 levels), ``"resident"`` (512^2 D4 and D8),
   ``"passes"`` (1024^2 D4, whose tiles do not all fit the card, and 512^2
   Haar at 6 levels), kernel 5 in both orders; then timed per filter;
5c. kernels 6, 7 and 8 (``myula_tv_tiled_update_cuda``,
   ``ulpda_tv_tiled_update_cuda``, ``myula_tv_fused_update_cuda``) against
   their plain versions at 2048^2, 40 steps in blocks of 20, noise on, and
   kernels 6 and 7 against the whole-image kernels 2 and 3 (on their
   launch sequences) on the same steps, bit for bit and on the geometry
   ``tiled_plan`` / ``ulpda_tiled_plan`` names, also at 1024 x 1500, and
   kernel 8 bit for bit at 2048^2 (the cone), 1024 x 1500 and 512^2 (the
   resident route); then
   timed per 200-step block beside kernels 2 and 3 (kernel 6 in TV
   cold-10, FGP-8, MC-TV and ME-TV, kernel 7 in TV, MC-TV and ME-TV);
5d. kernels 2 and 3 with a chain axis, noise on, 12 steps in blocks of 6:
   every chain of a call against the one-chain kernel call under its chain
   key and against the plain version, max abs error 0, at 64^2 x 8 chains
   in every mode (kernel 2: cold-10, FGP-8, CI markers, MC-TV, ME-TV;
   kernel 3: l21/TV, l1/MC-TV, l21/ME-TV in both orders; several chains a
   resident launch), at 512^2 x 2 chains and at 64^2 x 200 chains (more
   than the co-resident CTAs: resident launches in turn), each call's route
   and chains a launch logged; then timed against the plain version, and
   one call of 64 chains at 64^2 and of 2 at 512^2 against one-chain calls;
   kernels 4-7 with a chain axis, noise on, 12 steps in blocks of 6: every
   chain of a call against the plain version's call on the chain axis and
   the one-chain kernel call under its key, max abs error 0, kernels 4 and
   5 (both orders) at 64^2 x 8 chains on every route (Haar warp and CI
   markers, Haar 5 levels on the tile route, D4 and D8 resident, Haar 6
   levels and D4 through a patched plan on the per-level launches) and D4
   at 64^2 x 200 chains (resident launches in turn, chains at the group
   seams against the one-chain kernel and plain calls), kernels 6 (cold-10
   with CI markers, FGP-8, MC-TV) and 7 (TV both orders, ME-TV) at 256^2 x
   4 chains; then one call of each on the chain axis timed against its
   one-chain calls: 64 Haar chains at 64^2 (kernel 4: a 500-step block,
   kernel 5: 250), 4 chains at 256^2 (kernels 6 and 7: 200 steps);
6. the MYULA main path, the 512^2 TV-deblur posterior of ``bench.py``
   (phantom, 5x5 uniform blur, noise 0.75, TV weight 0.3), 20000 steps:
   ``run_myula_tv_fused`` for FGP-8, cold-10, warm-5 and cold-10 with 95% CI
   maps, then the unfused ``run_chain(myula_imaging)`` with kernel 1 inside
   (UNFUSED_STEPS, against a fused cold-10 chain as deep on the same key).
   Each is warmed up with another seed over fewer steps and timed; the
   posterior-mean PSNR
   must reach 40 dB and agree with the unfused path within 0.1 dB;
7. the deconvolution path: ``prox_lmc_deconv`` at 512^2 for ULPDA and MYULA
   (1000 steps, 10 models with the wavelet row M10, fused kernels) and the
   MAP branch (1000 adaptive PDHG iterations), the two sampling grids fused
   and unfused at DECONV_CHECK_STEPS steps (the same Philox stream chain for
   chain), and ``run_ulpda_fused``
   for TV, MC-TV and ME-TV (k5) timed at 20000 steps. The k5 and M10 PSNRs
   must reach the JAX package's (RESULTS.md) less 1 dB, and fused and
   unfused must agree within 0.1 dB;
8. the inpainting path (512^2 phantom, half the pixels missing, noise 0.1,
   wavelet-l1 weight 5): ``wavelet_inpainting`` with all 5 rows (2000 steps,
   burn-in 200, Haar), the fused D4 and D8 chains, timed 20000-step Haar
   chains (MYULA, MYULA with 95% CI maps, ULPDA), and a
   ``run_resumable_fused(runner="wavelet")`` restarted from its checkpoint
   against the straight run, with the RESULTS.md PSNR gates less 1 dB and
   fused within 0.1 dB of unfused;
9. the large-image path (``scripts/bench_tiled_2048.py``'s problem: the
   2048^2 phantom, the 512^2 problem's blur, noise and weights): 4000-step
   tiled chains (``run_myula_tv_tiled`` FGP-8 and MC-TV cold-10,
   ``run_ulpda_tv_tiled``) against the whole-image chains on the same key,
   with the JAX package's PSNRs less 1 dB; cold-10 with 95% CI maps; 4096^2
   FGP-8, 1000 steps; a ``run_resumable_fused(runner="ulpda_tiled")``
   restarted from its checkpoint; ``run_chain(myula_imaging_fused)`` against
   the unfused chain;
9b. the multichain path: ``multichain_deblur`` at 64^2 x 64 chains, 5000
   steps (MYULA and ULPDA, the same 64 chains one call after another
   beside them, the pooled means equal bit for bit; pooled-mean PSNR above
   the observation's, a finite R-hat) and at 512^2 x 4 chains (the main
   path's posterior, pooled-mean PSNR >= 40 dB); the chain farm of
   ``run_resumable_fused``: ``"tv"`` at 512^2 restarted from its
   checkpoint against the straight run, ``"wavelet"`` at 512^2 and
   ``"tiled"`` and ``"ulpda_tiled"`` at 2048^2, 2 chains each, every chain
   equal to its one-chain run under its chain key, each farm one kernel
   call a block for all its chains (the calls printed beside the one-chain
   runs');
9c. the mixtures path (the paper's workloads 1-3: the Gaussian mixture,
   the smoothed Laplacian mixture and the mixture x Laplace prior, n=5, the
   CLI defaults, k=1000): each CLI at 1024 chains, one step over all chains
   (``run_chains``), every sample finite, MALA's and MYMALA's acceptance in
   (0, 1], chain 0's final Sinkhorn W2 and each sampler's pooled mean within
   the JAX package's gates (MIX_GATES, scripts/mixture_gates.py); chains 0
   and 1023 of every sampler against their one-chain ``run_chain`` runs over
   the first 100 steps (bit for bit, IHPULA within MIX_EIGH_TOL), timed
   beside the batched rate, and 16 chains one after another; one W2 curve
   timed at k=5000; IHPULA's gamma=0.1, n=2 chain over MIX_IHPULA_STEPS f32
   steps, and
   whether ``torch.linalg.eigh`` waits for the card. No TPU kernel lies on
   this path;
9d. the PnP path (BASELINE.json config 5, ``experiments/pnp.py``):
   ``pnp_ula_deblur`` at the CLI's defaults (256^2 phantom, 8 chains, DnCNN
   depth 8 width 48 fitted 1500 steps under a spectral cap of 1.1) cut to
   500 steps (PNP_RUN) with the TV anchor through kernel 2 (95% CI markers, resident) and
   the score baseline on a ScoreUNet, and again at the configuration of
   ``scripts/pnp_gates.py`` held to the JAX package's PSNR gates
   (PNP_GATES); each posterior mean above the observation, the certified
   Lipschitz bound at most 1.1^8 and the measured constant within it;
   chains 0 and 7 of a block against their runs alone (PNP_CHAIN_TOL), the
   card's spectral norms of the fitted DnCNN against LAPACK's on the host
   (PNP_SPECTRAL_TOL), two fits from one seed equal, and ``load_image``'s
   photographs; kernel 2 at both sizes of the path (256^2 and the gates'
   128^2) with CI markers against its plain version before it. The nets'
   convolutions are library calls
   (the JAX package's are XLA ops outside any Pallas kernel). The
   deconvolution path (7) runs the score row (M11) once, with a 200-step
   fit, gated above the observation;
9d'. the PnP farm path (config 5's farm, ``scripts/expt_pnp1024_torch.py``):
   the script at the CLI's width (256^2, the DnCNN the PnP path fitted),
   PNP_FARM's blocks each a process of its own, pooled by ``pnp_merge``;
   its pooled mean and M2 against one in-process ``pnp_ula_deblur`` over
   the same chains in blocks of the same size (PNP_FARM_TOL, relative),
   the draws counted, the Lipschitz bound at most 1.1^8; kernel 2 (the TV
   anchor, resident) launches in the in-process call;
9e. the CT path (``experiments/ct.py``): the dense Radon projector at
   128^2 / 30 angles, the shear projector at 256^2 / 90 and the gather
   projector at 128^2 / 30 against their f64 versions on the host
   (CT_RADON_TOL), each twice with equal bits, timed;
   ``ct_tv_myula`` at the CLI's defaults (128^2, dense: adaptive-PDHG MAP,
   TV-MYULA with kernel 1, PnP-ULA with a DnCNN fitted in the run), each
   PSNR gated at RESULTS.md:283 less 1 dB (CT_REF); at 256^2 / 90 (shear:
   FISTA MAP with kernel 1 at niter 20) at 4500 steps with burn-in 4000,
   the MAP and the posterior mean gated at the JAX run's 26.00 and 22.977
   dB less 1 dB (CT_SHEAR_REF); the score branch (annealed score-ULA with a
   corrector) at 128^2 / 30 twice, equal bit for bit, gated above the FBP
   and inside scripts/ct_gates.py's band (CT_SCORE_GATE). Kernel 1 is held to its
   plain version at the path's shapes (128^2 and 256^2 niter 10, 256^2
   niter 20) before it. The projectors are library calls (``torch.matmul``,
   ``torch.fft``): the JAX package's are XLA ops outside any Pallas kernel;
9f. the SG-MCMC path (workload 5, ``experiments/sgld_runs.py``; beside the
   build, after the mixtures path): the CLI ``sgld_grid_mixture`` at
   k=SG_K (the JAX CLI's 50000, cut), the nine samplers one chain each,
   every retained draw finite and each sampler's ``modes_covered`` within
   the JAX package's band (SG_GATES, scripts/sgld_gates.py); each of the
   nine kernels at 1024 chains x 500 steps through ``run_chains`` (one step
   over all chains), chains 0 and 1023 against their one-chain
   ``run_chain`` runs over the first 100 steps bit for bit, the mean of
   each chain's modes covered within 4 standard errors of the JAX
   package's mean over its chains from the same start (SG_BATCH_REF), the
   aggregate rate beside the one-chain rate, CSGLD's pdf mass after the
   run; and
   ``optimize_grid_mixture`` at its defaults, ``modes_found`` within
   SG_OPT_GATE. No TPU kernel lies on this path;
9g. the chain-farm path (``parallel/``): ``run_chains_sharded`` of the
   mixtures' ULA on a one-rank NCCL ``chain_mesh()`` against
   ``run_chains``, bit for bit; ``run_resumable_fused(chains_mesh=...,
   runner="tv")`` at 64^2 x 8 chains (kernel 2's chain axis), two segments,
   straight and restarted from its checkpoint, against the farm without a
   mesh, bit for bit (positions, moments, CI markers); two processes on the
   one card (world size 2, gloo: NCCL refuses two ranks on one device),
   ``global_chain_farm`` of the ULA, 8 chains x 100 steps, rank 0's pooled
   moments against the one-process farm's, bit for bit;
9h. the image-sharding path (``ops/sharded.py``): four processes on the
   one card (``--image-rank``, gloo on a ``FileStore``) split the main
   problem (512^2) over ``image_mesh(device="cuda")`` meshes (1, 4, 1) and
   (1, 2, 2) with ``shard_image``; on each mesh every rank's band prox
   (kernel 1 on its block extended by 11 halo rows and columns) and noise
   block equal the one-device results bit for bit, its blocks of the four
   sharded ``CirculantBlur2D`` products lie within IMAGE_BLUR_TOL of the
   one-device ones, and 50 steps of the sharded ``run_chain(myula_imaging)``
   (``collect="stats"``), gathered on rank 0, lie within REL_TOL of one
   process's chain on the same key; kernel 1 must launch on every rank;
9i. the results path (``scripts/make_results_torch.py``): its ``main``
   runs the denoise and PnP sections on the card into a temporary
   directory (the PnP section from the committed ``assets/torch/``
   reports, its block pattern matching no file); both tables must be
   there, the denoise posterior-mean PSNR at RESULTS_DENOISE_REF less
   DECONV_MARGIN or more;
10. profile: torch.profiler windows of the main path's fused 500-step
   block, of the deconvolution cells (a fused
   ULPDA block, the one-step fused grid with its metrics, the MAP
   iteration), of the inpainting cells (a fused Haar and a D4 MYULA block, the
   unfused MYULA step) and of the large-image cell (one 200-step block at
   2048^2 of each tiled runner and of the whole-image runner beside it), of
   one packed 500-step block at 64^2 x 64 chains, of one batched ULA block
   of the Gaussian mixture (1024 chains x 100 steps), of one batched SGLD
   and one CSGLD block on the grid mixture (1024 chains x 100 steps, the
   launches a step), of 20 PnP-ULA steps of
   8 chains at 256^2, of 2 dense-MAP iterations at 128^2 and 20 shear
   TV-MYULA steps at 256^2 on the CT path, and kernel 1's device time per
   call at 512^2 and 2048^2.

With ``--turns KERNELS`` (a comma list of 1, 3, 4, 5, 6, 7, 8) the script
runs only a measurement: the registers and spills ``ptxas`` reports for
kernels 1 and 3-8, and each kernel timed in alternating turns (forward, then
backward) on the kernel of each ROOT (another checkout of the repository,
imported beside this one, e.g. a ``git archive`` of a parent commit) and on
this checkout's variants, each held bit for bit to this checkout's pick:
kernel 1 per call at 512^2 and 2048^2 and kernel 8 per 2048^2 step (niter
10) on ``prox_plan``'s rank 2, another route, ``k = niter`` and the best
geometry at 512 threads a CTA, and the unfused main path with each
checkout's kernel 1; kernel 3
per 500-step block and per one-step call at 512^2 in TV, MC-TV and ME-TV on
the resident route and the launch sequence, kernel 4 per 500-step block at
512^2 (Haar, Haar with 95% CI markers, D4, D8) and kernel 5 per 250-step
block (Haar, D4, D8, both orders) on ``wavelet_plan``'s route and the route
it replaced (``"tile"``, ``"passes"``), with the D4 resident route also at
1024 threads a CTA and its grid barriers alone (copies of the source edited
at text anchors, ``WAVELET_VARIANTS``), kernels 6 (KERNEL6_MODES)
and 7 (TV, MC-TV, ME-TV) per 200-step block at 2048^2 on their planners'
geometries of rank 2 and the best at 512 threads a CTA. With ``--clock`` it
prints the ``clock64`` phase split of kernel 3's resident step at 512² for
each ROOT (this checkout by default), from an instrumented copy of its
sources (``CLOCK_PATCHES``).

Each path runs with the launch counts set to 0 just before it and read just
after; each of its kernels must have launched, on the MYULA-main and
deconvolution paths every kernel-1 and kernel-2 call and on the
deconvolution path every kernel-3 call but the wl1 dual's must have taken
the resident route, on the inpainting path every kernel-4 and kernel-5
call the warp (Haar) or the resident route (D4/D8), and on the large-image
path no kernel-2 or kernel-3 call, and every kernel-1 and kernel-8 call the
cone, on the multichain path every kernel-2 and kernel-3 call the resident
route; the mixtures and SG-MCMC paths launch none of them, the PnP and PnP
farm paths kernel 2 alone and the CT path kernel 1 alone, every call on the resident
route, the chain-farm path kernel 2 alone on the resident route, and the
image-sharding path kernel 1 alone (its workers' launches added to this
process's). The script then prints one JSON line describing each kernel
(launches and route counts on the twelve paths, errors, times, the bound of
the card; for kernels 2-7 also the chain axis's plans and error, with
its times for kernels 2, 3 and 4,
for kernel 1 its error, route and times at the CT shapes) and, last,
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N = 512
STEPS = 20000
# the unfused main-path chain, against a fused one as deep (cut from 20000 to
# 10000, then to 5000 to make room for the CT path, then to 2500 for the
# SG-MCMC and chain-farm paths)
UNFUSED_STEPS = 2500
BLOCK = 500
SIGMA_NOISE = 0.75
TV_WEIGHT = 0.3
CHECK_STEPS, CHECK_BLOCK = 40, 20
# a block kernel is timed over this many steps (calls of BLOCK steps), its
# plain version over one call
TIMED_STEPS = 2000
# the timed 20k-step chains warm up with another seed over fewer steps: the
# fused ones past the CI run's burn-in of 2000, the unfused one less
FUSED_WARM, UNFUSED_WARM = 2500, 200
# the unfused main path's steps per turn in ``--turns 1``
UNFUSED_TURN_STEPS = 1000
# kernels 2 and 3 vs their plain versions after 40 steps, for every field: the
# gate of tests/test_myula_fused.py:89-92, atol = 3e-5 * max(1, max |field|).
# On the H100 they agree bit for bit (max_abs_err 0): both sides take the same
# float operations in the same order, and the library is built with
# --fmad=false.
REL_TOL = 3e-5
PSNR_FLOOR = 40.0
PSNR_GAP = 0.1
# L2Data.grad timed over this many calls, spectral and with prefer_stencil;
# the two agree within STENCIL_TOL * max(1, max |grad|) (f32 FFT roundoff
# against the stencil's direct sums)
STENCIL_CALLS, STENCIL_TOL = 100, 1e-4
# the deconvolution workload (lmc_atomi_torch/experiments/deconv.py)
DECONV_STEPS = 1000
DECONV_SCORE_FIT = 200  # the score row's training steps (the CLI's: 4000)
# the fused-against-unfused grids (cut from 1000 to 500, then to 250 to make
# room for the CT path, then to 125 for the SG-MCMC and chain-farm paths)
DECONV_CHECK_STEPS = 125
# k5 PSNR (TV, MC-TV, ME-TV) of the JAX package on the same protocol
# (RESULTS.md:82-84); the port's observation noise differs, so the gate is
# these less DECONV_MARGIN dB
DECONV_REF = {"ULPDA": (38.41, 39.09, 38.94), "MAP": (41.89, 41.91, 46.07),
              "MYULA": (34.23, 30.74, 33.39)}
DECONV_MARGIN = 1.0
# model M10 (k5-WL1), the wavelet row: MAP, ULPDA, MYULA (RESULTS.md:91)
M10_REF = {"MAP": 37.02, "ULPDA": 35.03, "MYULA": 32.08}
WL1_LEVELS = 4
# the inpainting workload (lmc_atomi_torch/experiments/inpainting.py)
INP_SIGMA, INP_TAU_W, INP_LEVELS = 0.1, 5.0, 3
INP_STEPS, INP_BURN = 2000, 200
# the JAX package on the same protocol (RESULTS.md:198-214); the port's mask
# and noise differ, so the gate is these less DECONV_MARGIN dB
INP_REF = {"MYULA": 17.61, "MALA": 7.71, "ULPDA-wavelet": 18.02}
INP_FUSED_REF = {"d4": (17.88, 18.31), "d8": (17.82, 18.16)}  # MYULA, ULPDA
TAPS = {"haar": 2, "d4": 4, "d8": 8}
# the large-image workload (scripts/bench_tiled_2048.py::_problem): 2048^2
# and 4096^2 phantom, the 512^2 problem's blur, noise and weights; chains of
# 4000 steps (4096^2: 1000) in blocks of 200, burn-in 1000
LARGE_N, HUGE_N = 2048, 4096
LARGE_STEPS, LARGE_BURN, LARGE_BLOCK = 4000, 1000, 200
HUGE_STEPS, HUGE_BURN = 1000, 250
# posterior-mean PSNR of the JAX package's tiled chains at 2048^2, 4000
# steps, burn-in 1000 (fig/r4_measurements/tiled_rows.jsonl: FGP-8 MYULA,
# streamed ULPDA, MC-TV MYULA with FGP-8, the gate of the MC-TV cold-10
# chain here); the gate is these less 1 dB
LARGE_REF = {"fgp8": 44.813, "ulpda": 44.607, "mctv": 28.536}
LARGE_MARGIN = 1.0
RESUME_STEPS = 1000  # run_resumable_fused(runner="ulpda_tiled"), 2 segments
TAIL_STEPS, TAIL_BURN = 1000, 250  # kernel 8's chain against the unfused one
# H100 SXM data sheet peaks at 700 W: f32 outside the tensor cores and HBM
# bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# profile_window: idle host time around a profiled call, first try and
# retry; the share of device records a window must keep; and the host-side
# CUDA calls that each make one device record
PROFILE_MARGINS_S = (0.5, 2.5)
PROFILE_KEPT = 0.99
CUDA_LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                               "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                               "cudaMemcpyAsync", "cudaMemsetAsync"})

SOLVERS = {
    "fgp8": dict(niter_tv=8, tv_solver="fgp"),
    "cold10": dict(niter_tv=10),
    "warm5": dict(niter_tv=5, tv_warm=True),
    "cold10_ci95": dict(niter_tv=10, quantiles=(0.025, 0.975)),
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 1):
    """Device time per call of ``fn`` with CUDA events, after a sync."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def plain_ms(timed, fn):
    """Device time of one call of a plain version, or None: the plain
    versions take seconds per call, so each kernel's is timed for the mode
    its kernels-line entry reports only."""
    return cuda_ms(fn)[0] if timed else None


def plain_note(p_ms, steps):
    return "" if p_ms is None else f", plain {p_ms:.3f} ms / {steps / p_ms * 1e3:.1f} iters/s"


# --- the least time the card could take -------------------------------------
# Floating-point operations per pixel, counted from csrc/ (a sqrt, rsqrt,
# division, log or cos counts as one operation). The Philox rounds of the
# noise are integer operations; they are counted at the f32 rate, since the
# data sheet gives no int32 rate outside the tensor cores.
F_TRIP = {"chambolle": 19,  # u = div p - x/g (5), grad u (2), |.| (4), 1 + s|.| (2), p (6)
          "fgp": 24}  # u (5), grad (2), r + s grad (4), |.|^-1/2 (4), min (1), scale (2), momentum (6)
F_PROX_FINISH = 5  # x - g div p
F_NOISE = 108  # Philox4x32-10: 10 x (2 mulhi, 2 mul, 4 xor, 2 key adds); Box-Muller: 8
F_WELFORD = 8
F_MCTV_CLAMP = 11  # grad (2), |.| (4), guard (1), 1/|.| (1), min (1), scale (2)


def f_gram(taps) -> int:
    """A^T A x as the separable passes: a multiply per nonzero tap, the sums."""
    n = 0
    for wy, wx in taps:
        ky = sum(1 for w in wy if w != 0.0)
        kx = sum(1 for w in wx if w != 0.0)
        n += 2 * ky - 1 + 2 * kx - 1
    return n + len(taps) - 1


def bound_ms(flops: float, nbytes: float):
    """``(ms, "operations" | "bytes")``: the larger of flops over the f32 peak
    and bytes over the memory peak."""
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bound_kernel1(npix: int, niter: int):
    """One prox: niter trips and the finish; x read once, the prox written once."""
    return bound_ms(npix * (niter * F_TRIP["chambolle"] + F_PROX_FINISH), 8 * npix)


def bound_kernel2(npix, n_steps, taps, niter_tv, tv_solver="chambolle",
                  mode="tv", niter_inner=0, n_q=0, with_noise=True, with_stats=True,
                  n_chains=1):
    """One block call of n_steps MYULA steps of n_chains chains; each chain's
    x, mean, m2 (and the 8 n_q marker planes) read once and written once and
    the shared atbs read once; without statistics x and atbs read, x
    written."""
    per = f_gram(taps) + 2 + niter_tv * F_TRIP[tv_solver] + F_PROX_FINISH + 5
    per += (F_WELFORD if with_stats else 0) + (F_NOISE if with_noise else 0) + 60 * n_q
    if mode == "mctv":
        per += F_MCTV_CLAMP + 5  # the clamp, then lamda div(.) added
    elif mode == "metv":
        per += niter_inner * F_TRIP[tv_solver] + F_PROX_FINISH + 3
    fields = (4 + 3 + 16 * n_q) if with_stats else 3
    return bound_ms(n_chains * npix * n_steps * per,
                    4 * npix * (n_chains * (fields - 1) + 1))


def f_dwt(taps: int, levels: int) -> float:
    """One interleaved transform (forward or inverse), per pixel: the
    axis-0 and axis-1 passes of level l each touch a 4^-l share of the
    pixels, with 2 taps operations per touched pixel (Haar: 2, an add or
    subtract and a multiply)."""
    per_pixel = 2 if taps == 2 else 2 * taps
    return 2 * per_pixel * sum(4.0 ** -lv for lv in range(levels))


def bound_kernel3(npix, n_steps, taps, niter_solve, mode="tv", dual="l21",
                  niter_inner=0, tv_solver="chambolle", gfirst=False,
                  with_noise=True, levels=WL1_LEVELS, n_chains=1):
    """One block call of n_steps ULPDA steps of n_chains chains; each chain's
    x, py, px, mean, m2 (and xbar with gfirst) read once and x, py, px,
    xbar, mean, m2 written once (no px for the wl1 dual), the shared atb
    read once."""
    per = 8 + niter_solve * (f_gram(taps) + 7) + 4 + F_WELFORD
    per += F_NOISE if with_noise else 0
    per += {"l21": 15, "l1": 10}.get(dual, 0)
    if dual == "wl1":  # W^T y in v, W xbar and the clip in the dual
        per += 2 * f_dwt(2, levels) + 4
    if mode == "mctv":
        per += F_MCTV_CLAMP + 5
    elif mode == "metv":
        per += niter_inner * F_TRIP[tv_solver] + F_PROX_FINISH + 3
    fields = 6 + gfirst + 6 - 2 * (dual == "wl1")
    return bound_ms(n_chains * npix * n_steps * per,
                    4 * npix * (n_chains * (fields - 1) + 1))


def bound_kernel4(npix, n_steps, taps, levels, n_q=0, with_noise=True, n_chains=1):
    """One block call of n_steps wavelet MYULA steps of n_chains chains;
    each chain's x, mean, m2 (and the 8 n_q marker planes) read once and
    written once, the shared y and mask read once. Per pixel and step: the
    two transforms, the soft threshold (5), the masked gradient (3), the
    update (5), noise, Welford, P^2."""
    per = 2 * f_dwt(taps, levels) + 5 + 3 + 5 + F_WELFORD + 60 * n_q
    per += (F_NOISE + 2) if with_noise else 0
    return bound_ms(n_chains * npix * n_steps * per,
                    4 * npix * (n_chains * (6 + 16 * n_q) + 2))


def bound_kernel5(npix, n_steps, taps, levels, gfirst=False, with_noise=True, n_chains=1):
    """One block call of n_steps wavelet-dual ULPDA steps of n_chains
    chains; each chain's x, c, mean, m2 (and xbar with gfirst) read once
    and x, c, xbar, mean, m2 written once, the shared y and mask read once.
    Per pixel and step: the two transforms, the dual's clip (4), the mask
    prox (4), xbar (3), noise, Welford; the prox's 1/(1 + ts m) and ts m y
    once per call (5)."""
    per = 2 * f_dwt(taps, levels) + 4 + 4 + 3 + F_WELFORD
    per += (F_NOISE + 2) if with_noise else 0
    return bound_ms(n_chains * npix * (n_steps * per + 5),
                    4 * npix * (n_chains * (4 + gfirst + 5) + 2))


def bound_kernel7(npix, n_steps, taps, niter_solve, mode="tv", dual="l21",
                  niter_inner=0, with_noise=True, n_chains=1):
    """One call of n_steps tiled ULPDA steps of n_chains chains: kernel 3's
    operations with x̄ recomputed at the 3 points the dual reads (+6); each
    chain's x, x_prev, py, px, mean, m2 read once and written once, the
    shared atb read once."""
    per = 8 + niter_solve * (f_gram(taps) + 7) + 4 + F_WELFORD + 6
    per += F_NOISE if with_noise else 0
    per += {"l21": 15, "l1": 10}[dual]
    if mode == "mctv":
        per += F_MCTV_CLAMP + 5
    elif mode == "metv":
        per += niter_inner * F_TRIP["chambolle"] + F_PROX_FINISH + 3
    return bound_ms(n_chains * npix * n_steps * per, 4 * npix * (n_chains * 12 + 1))


def bound_kernel8(npix, niter, with_noise=True):
    """One step given the gradient: niter Chambolle trips, the prox, the
    update (5) and the noise; x and the gradient read once, x' written once."""
    per = niter * F_TRIP["chambolle"] + F_PROX_FINISH + 5 + (F_NOISE if with_noise else 0)
    return bound_ms(npix * per, 4 * npix * 3)


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    from lmc_atomi_torch import _build

    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"device: {name} count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda} nvcc='{nvcc}'")
    print(smi, flush=True)
    # stated for the record: no TF32 anywhere (the learned priors' nets run
    # their convolutions under models/dncnn.py::net_precision, IEEE float32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


class PhaseBuild:
    """The kernel build in a thread (its nvcc processes wait on the host's
    other cores); ``join`` waits for it, logs it and raises its error."""

    def __init__(self):
        import threading

        from lmc_atomi_torch import _build

        self.out = {}
        t0 = time.perf_counter()

        def run():
            try:
                self.out["lib"] = _build.library()
            except BaseException as err:  # re-raised by join
                self.out["err"] = err
            self.out["s"] = time.perf_counter() - t0

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def join(self):
        self.thread.join()
        if "err" in self.out:
            raise self.out["err"]
        log(f"build: {self.out['lib']._name} in {self.out['s']:.2f} s")


def make_problem(dev, seed=0):
    import torch

    from lmc_atomi_torch.ops.functionals import L2Data
    from lmc_atomi_torch.ops.linops import CirculantBlur2D, uniform_kernel
    from lmc_atomi_torch.utils.images import phantom

    img = torch.from_numpy(phantom(N)).to(dev)
    blur = CirculantBlur2D.from_kernel((N, N), uniform_kernel(5, torch.float32, dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = blur.matvec(img) + SIGMA_NOISE * torch.randn(
        (N, N), generator=gen, device=dev, dtype=torch.float32)
    l2 = L2Data.create(op=blur, b=y, sigma=1.0 / SIGMA_NOISE**2)
    return img, y, l2


# kernel 1's trip counts against its plain version, and one at 2048^2 past
# the cone's fit
KERNEL1_NITERS = (0, 3, 10, 20)
KERNEL1_PAST_FIT = 60


def phase_kernel1(dev, report):
    """Kernel 1 against its plain version at max abs error 0: at 512^2 (the
    resident route), 2048^2 (the cone) and NONSQUARE (ragged tiles) for
    KERNEL1_NITERS, and at 2048^2 past the cone's fit (one launch a
    segment); then timed per call with CUDA events at 512^2 and 2048^2,
    niter 10."""
    import torch

    from lmc_atomi_torch.ops.tv_cuda import prox_tv_iso_cuda, prox_tv_iso_ref

    gamma = TV_WEIGHT * SIGMA_NOISE**2
    gen = torch.Generator(device=dev).manual_seed(3)
    images = {shape: 100.0 + 50.0 * torch.randn(shape, generator=gen, device=dev)
              for shape in ((N, N), (LARGE_N, LARGE_N), NONSQUARE)}
    cases = [(shape, niter) for shape in images for niter in KERNEL1_NITERS]
    cases.append(((LARGE_N, LARGE_N), KERNEL1_PAST_FIT))
    worst = 0.0
    for shape, niter in cases:
        x = images[shape]
        got = prox_tv_iso_cuda(x, gamma, niter=niter)
        plan = prox_tv_iso_cuda.last_plan
        err, _ = compare(f"kernel 1 {shape} niter={niter}", (got,),
                         (prox_tv_iso_ref(x, gamma, niter=niter),), ("x",), exact=True)
        worst = max(worst, err)
        log(f"kernel1 {shape[0]}x{shape[1]} niter={niter}: max_abs_err={err:.3e}, plan {plan}")
        want = ("resident" if shape == (N, N) else "launches" if niter == KERNEL1_PAST_FIT
                else "cone" if shape == (LARGE_N, LARGE_N) else plan[0])
        if plan[0] != want:
            raise AssertionError(f"kernel 1 at {shape}, niter {niter}: route {plan[0]}, "
                                 f"want {want}")
        if shape == NONSQUARE and not (shape[0] % plan[1] or shape[1] % plan[2]):
            raise AssertionError(f"kernel 1's interior {plan[1:3]} divides {NONSQUARE}")
    times = {}
    for n in (N, LARGE_N):
        x = images[(n, n)]
        ms, _ = cuda_ms(lambda: prox_tv_iso_cuda(x, gamma, niter=10), 200)
        p_ms, _ = cuda_ms(lambda: prox_tv_iso_ref(x, gamma, niter=10), 20)
        b_ms, b_by = bound_kernel1(n * n, 10)
        times[n] = (ms, p_ms, b_ms, b_by)
        log(f"kernel1 timing {n}^2 niter=10 per call: kernel {ms:.4f} ms (CUDA events, "
            f"200 back to back) on {prox_tv_iso_cuda.last_plan}, plain {p_ms:.4f} ms, "
            f"bound {b_ms:.5f} ms ({b_by})")
    ms, p_ms, b_ms, b_by = times[N]
    report["prox_tv_iso_cuda"] = dict(max_abs_err=worst, ms=ms, plain_ms=p_ms,
                                      bound_ms=b_ms, bound_by=b_by, library_ms=None)


def make_deconv_models(dev):
    """The deconvolution workload's image, observation and ten models (the
    wavelet row M10 last), as ``prox_lmc_deconv`` builds them on the card
    (seed 0)."""
    import torch

    from lmc_atomi_torch.experiments.deconv import deconv_models
    from lmc_atomi_torch.ops.linops import CirculantBlur2D, uniform_kernel
    from lmc_atomi_torch.utils.images import load_image

    img = torch.from_numpy(load_image("phantom", N)).to(dev)
    blurs = {k: CirculantBlur2D.from_kernel((N, N), uniform_kernel(k, torch.float32, dev))
             for k in (5, 6, 7)}
    gen = torch.Generator(device=dev).manual_seed(0)
    y = blurs[5].matvec(img) + SIGMA_NOISE * torch.randn(
        (N, N), generator=gen, dtype=torch.float32, device=dev)
    return img, y, deconv_models(y, blurs, SIGMA_NOISE, TV_WEIGHT, 15.0, 15.0,
                                 50, 10, WL1_LEVELS)


def compare(label, got, want, names, exact=False):
    """Max abs error of each field against ``REL_TOL * max(1, max |want|)``,
    or against 0 with ``exact``; raises on a miss. Returns the worst error and
    a log fragment."""
    import torch

    torch.cuda.synchronize()
    worst, parts = 0.0, []
    for field, g, w in zip(names, got, want):
        if w is None:
            continue
        err = float((g - w).abs().max())
        tol = 0.0 if exact else REL_TOL * max(1.0, float(w.abs().max()))
        parts.append(f"{field}={err:.3e}/{tol:.1e}")
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"{label} {field}: {err} > {tol}")
        worst = max(worst, err)
    return worst, " ".join(parts)


def _run_blocks(update, l2, x0, n_steps, block, cfg, seed, terms=None):
    """run_myula_tv_fused's block loop, with the block update passed in (the
    kernel or its plain version) so both run on the card; also
    run_myula_tv_tiled's, ``cfg`` then holding ``band`` and ``halo``. An int
    ``seed`` keys chain 0; a chain axis (``x0`` of shape ``(C, ny, nx)``)
    takes its ``C`` keys. ``terms`` is ``(tau, gamma, TV weight)``, by
    default the 512^2 problem's."""
    import torch

    from lmc_atomi_torch.kernels.myula_fused import (
        _fused_mode,
        _fused_params,
        _marker_state,
        _pack_scal_f,
    )

    taps, (oy, ox), atbs = _fused_params(l2)
    mode, lamda, gamma_mc, niter_inner = _fused_mode(l2)
    tau, gamma, weight = terms or (0.2 * SIGMA_NOISE**2, SIGMA_NOISE**2, TV_WEIGHT)
    scal_f = _pack_scal_f(l2, tau, gamma, weight, 1.0, lamda, gamma_mc)
    cfg = dict(cfg)
    burn = cfg.pop("burn_in", 0)
    x, mean, m2 = x0, torch.zeros_like(x0), torch.zeros_like(x0)
    qh, qn = _marker_state(x0, len(cfg.get("quantiles", ())), None)
    for b in range(n_steps // block):
        step0 = b * block
        x, mean, m2, qh, qn = update(
            x, atbs, mean, m2, (seed, 0) if isinstance(seed, int) else seed, scal_f,
            (step0, burn, max(step0 - burn, 0)),
            qh, qn, taps=taps, oy=oy, ox=ox, n_steps=block, mode=mode,
            niter_inner=niter_inner, **cfg)
    return x, mean, m2, qh, qn


# kernel 2 in the nonconvex modes of the deconvolution models
MODE_SOLVERS = {"cold10": dict(niter_tv=10),
                "fgp8_warm": dict(niter_tv=8, tv_solver="fgp", tv_warm=True)}


def routes_of(fn, wrapper):
    """Run ``fn`` with ``wrapper``'s route counts at 0; returns its result
    and the counts."""
    wrapper.routes = dict.fromkeys(wrapper.routes, 0)
    out = fn()
    return out, dict(wrapper.routes)


def bound_kernel2_cfg(data, cfg, n_steps, with_stats=True):
    """bound_kernel2 for a run of ``_run_blocks`` on ``data`` with ``cfg``."""
    from lmc_atomi_torch.kernels.myula_fused import _fused_mode, _fused_params

    mode, _, _, niter_inner = _fused_mode(data)
    return bound_kernel2(N * N, n_steps, _fused_params(data)[0], cfg["niter_tv"],
                         cfg.get("tv_solver", "chambolle"), mode, niter_inner,
                         len(cfg.get("quantiles", ())), with_stats=with_stats)


def phase_kernel2(dev, l2, y, models, report):
    """Kernel 2 against its plain version (max abs error 0 in every field),
    each call's route logged (every 512^2 call takes the resident route);
    then timed in every solver and mode per 500-step call, and per one-step
    call without statistics (the deconvolution grid's call)."""
    from lmc_atomi_torch.kernels.myula_fused import (
        myula_tv_block_update_cuda,
        myula_tv_block_update_ref,
    )

    k2 = myula_tv_block_update_cuda
    runs = [(name, l2, cfg) for name, cfg in SOLVERS.items()]
    runs += [(f"{mode}_{name}", models[i][1], cfg) for i, mode in ((1, "mctv"), (2, "metv"))
             for name, cfg in MODE_SOLVERS.items()]
    worst = 0.0
    for name, data, cfg in runs:
        cfg = dict(cfg, burn_in=10) if "quantiles" in cfg else dict(cfg)
        got, routes = routes_of(lambda: _run_blocks(k2, data, y, CHECK_STEPS, CHECK_BLOCK,
                                                    cfg, seed=7), k2)
        want = _run_blocks(myula_tv_block_update_ref, data, y, CHECK_STEPS,
                           CHECK_BLOCK, cfg, seed=7)
        err, parts = compare(f"kernel 2 ({name})", got, want,
                             ("x", "mean", "m2", "qh", "qn"), exact=True)
        worst = max(worst, err)
        log(f"kernel2 {name} {N}^2 {CHECK_STEPS} steps, noise on: routes {routes} "
            f"plan {k2.last_plan}; max_abs_err {parts}")
        if routes["sequence"]:
            raise AssertionError(f"kernel 2 ({name}) took the launch sequence at {N}^2")
    # device time per 500-step call in every solver and mode, and per one-step
    # call; the plain version's for the reported mode only (plain_ms)
    times = {}
    reps = TIMED_STEPS // BLOCK
    for name, data, cfg in runs:
        cfg = dict(cfg, burn_in=10) if "quantiles" in cfg else dict(cfg)
        k_ms, _ = cuda_ms(lambda: _run_blocks(k2, data, y, BLOCK, BLOCK, cfg, seed=8), reps)
        p_ms = plain_ms(name == "cold10", lambda: _run_blocks(
            myula_tv_block_update_ref, data, y, BLOCK, BLOCK, cfg, seed=8))
        b_ms, b_by = bound_kernel2_cfg(data, cfg, BLOCK)
        times[name] = (k_ms, p_ms, b_ms, b_by)
        log(f"kernel2 {name} timing ({reps * BLOCK} steps, plain {BLOCK}): kernel "
            f"{k_ms:.3f} ms / {BLOCK / k_ms * 1e3:.1f} iters/s{plain_note(p_ms, BLOCK)}, "
            f"bound {b_ms:.4f} ms ({b_by}), {k_ms / b_ms:.1f}x the bound")
    for name, data in (("tv", l2), ("mctv", models[1][1]), ("metv", models[2][1])):
        cfg = dict(niter_tv=10)
        scal = _block_scalars(data)
        x0 = y.clone()
        ms, _ = cuda_ms(lambda: k2(x0, scal[0], None, None, (8, 0), scal[1], (3, 0, 0),
                                   n_steps=1, with_stats=False, **scal[2], **cfg), 200)
        b_ms, b_by = bound_kernel2_cfg(data, cfg, 1, with_stats=False)
        log(f"kernel2 {name}_cold10 one step, no statistics: {ms * 1e3:.2f} us per call, "
            f"bound {b_ms * 1e3:.3f} us ({b_by}), {ms / b_ms:.1f}x the bound")
    k_ms, p_ms, b_ms, b_by = times["cold10"]
    report["myula_tv_block_update_cuda"] = dict(
        max_abs_err=worst, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)


def _block_scalars(l2):
    """``(atbs, scal_f, keywords)`` of a kernel-2 call on ``l2``, as
    ``_run_blocks`` makes them."""
    from lmc_atomi_torch.kernels.myula_fused import _fused_mode, _fused_params, _pack_scal_f

    taps, (oy, ox), atbs = _fused_params(l2)
    mode, lamda, gamma_mc, niter_inner = _fused_mode(l2)
    gamma = SIGMA_NOISE**2
    scal_f = _pack_scal_f(l2, 0.2 * gamma, gamma, TV_WEIGHT, 1.0, lamda, gamma_mc)
    return atbs, scal_f, dict(taps=taps, oy=oy, ox=ox, mode=mode, niter_inner=niter_inner)


def _ulpda_scalars(proxf, proxg, a_op=None):
    """``(atb, scal_f, keywords)`` of a kernel-3 call on ``proxf``, ``proxg``
    and the dual of ``a_op`` (default Gradient2D), as ``_run_ulpda_blocks``
    makes them."""
    from lmc_atomi_torch.kernels.ulpda_fused import _pack_ulpda_scal, _ulpda_setup
    from lmc_atomi_torch.ops.linops import Gradient2D

    (taps, (oy, ox), atb, mode, lamda, gamma_mc, niter_inner, dual,
     lam, levels) = _ulpda_setup(proxf, proxg, Gradient2D() if a_op is None else a_op)
    scal_f = _pack_ulpda_scal(proxf, proxg, 0.95 * SIGMA_NOISE**2, 1.0, 1.0, 1.0, lamda,
                              gamma_mc)
    return atb, scal_f, dict(taps=taps, oy=oy, ox=ox, lam=lam, dual=dual, mode=mode,
                             niter_inner=niter_inner, levels=levels)


def _run_ulpda_blocks(update, proxf, proxg, x0, n_steps, block, cfg, seed,
                      a_op=None):
    """run_ulpda_fused's block loop with the block update passed in (the dual
    of ``a_op``, default Gradient2D); ``seed`` as ``_run_blocks``'."""
    import torch

    atb, scal_f, kw = _ulpda_scalars(proxf, proxg, a_op)
    cfg = dict(cfg)
    kw["niter_inner"] = cfg.pop("niter_inner", kw["niter_inner"])  # as run_ulpda_fused's
    zeros = torch.zeros_like(x0)
    x, py, px, xbar, mean, m2 = x0, zeros, zeros, x0, zeros, zeros
    if kw["dual"] == "wl1":
        px = None
    for b in range(n_steps // block):
        step0 = b * block
        x, py, px, xbar, mean, m2 = update(
            x, py, px, xbar, atb, mean, m2, (seed, 0) if isinstance(seed, int) else seed,
            scal_f, (step0, 5, max(step0 - 5, 0)),
            n_steps=block, **kw, **cfg)
    return x, py, px, xbar, mean, m2


# kernel 3 on the k5 models of the deconvolution workload: (model index,
# gfirst, options); the dual follows the model (l21, l1, l21, and wl1 for
# model M10, index 9)
KERNEL3_RUNS = [(i, gfirst, {}) for i in (0, 1, 2, 9) for gfirst in (False, True)]
KERNEL3_RUNS.append((2, False, dict(tv_solver="fgp", niter_inner=8, env_warm=True)))


def phase_kernel3(dev, y, models, report):
    """Kernel 3 against its plain version (max abs error 0 in every field),
    each call's route logged (every 512^2 call of a Gradient2D dual takes
    the resident route, the wl1 dual the launch sequence); then timed per
    mode per 500-step call, and per one-step call without statistics (the
    deconvolution grid's call)."""
    import torch

    from lmc_atomi_torch.kernels.myula_fused import separable_gram_taps
    from lmc_atomi_torch.kernels.ulpda_fused import (
        ulpda_block_update_cuda,
        ulpda_block_update_ref,
    )
    from lmc_atomi_torch.ops.wavelet import HaarDWT2D

    k3 = ulpda_block_update_cuda
    fields = ("x", "py", "px", "xbar", "mean", "m2")
    worst = 0.0
    for i, gfirst, opts in KERNEL3_RUNS:
        name, proxf, proxg, a_op = models[i]
        cfg = dict(gfirst=gfirst, niter_solve=3, **opts)
        label = f"{name} gfirst={gfirst} {opts or ''}".strip()
        got, routes = routes_of(lambda: _run_ulpda_blocks(k3, proxf, proxg, y, CHECK_STEPS,
                                                          CHECK_BLOCK, cfg, 7, a_op), k3)
        want = _run_ulpda_blocks(ulpda_block_update_ref, proxf, proxg, y,
                                 CHECK_STEPS, CHECK_BLOCK, cfg, 7, a_op)
        err, parts = compare(f"kernel 3 ({label})", got, want, fields, exact=True)
        worst = max(worst, err)
        log(f"kernel3 {label} {N}^2 {CHECK_STEPS} steps, noise on: routes {routes} plan "
            f"{k3.last_plan}; max_abs_err {parts}")
        wl1 = isinstance(a_op, HaarDWT2D)
        if routes["sequence"] or routes["resident" if wl1 else "wl1"]:
            raise AssertionError(f"kernel 3 ({label}) at {N}^2 took the routes {routes}")
    # M10's wl1 dual past the 5 Haar levels of a CTA's region: one launch per
    # level and axis, bit for bit
    name, proxf, proxg, _ = models[9]
    lv = DEEP_HAAR_LEVELS
    for gfirst in (False, True):
        args = (proxf, proxg, y, CHECK_STEPS, CHECK_BLOCK, dict(gfirst=gfirst, niter_solve=3), 7,
                HaarDWT2D(levels=lv))
        err, parts = compare(f"kernel 3 (wl1, {lv} levels, gfirst={gfirst})",
                             _run_ulpda_blocks(k3, *args),
                             _run_ulpda_blocks(ulpda_block_update_ref, *args),
                             fields, exact=True)
        worst = max(worst, err)
        log(f"kernel3 {name} wl1 {lv} levels gfirst={gfirst} {N}^2 {CHECK_STEPS} steps, "
            f"noise on: max_abs_err {parts}")
    times = {}
    reps = TIMED_STEPS // BLOCK
    for i in (0, 1, 2, 9):
        name, proxf, proxg, a_op = models[i]
        cfg = dict(gfirst=False, niter_solve=3)
        k_ms, _ = cuda_ms(lambda: _run_ulpda_blocks(
            k3, proxf, proxg, y, BLOCK, BLOCK, cfg, 8, a_op), reps)
        plan = k3.last_plan
        mode = name.split("-")[1].lower()
        p_ms = plain_ms(mode == "tv", lambda: _run_ulpda_blocks(
            ulpda_block_update_ref, proxf, proxg, y, BLOCK, BLOCK, cfg, 8, a_op))
        taps = separable_gram_taps(proxf.op.hh)
        dual = {"mctv": "l1", "wl1": "wl1"}.get(mode, "l21")
        b_ms, b_by = bound_kernel3(N * N, BLOCK, taps, 3, mode="tv" if dual == "wl1" else mode,
                                   dual=dual, niter_inner=10)
        atb, scal_f, kw = _ulpda_scalars(proxf, proxg, a_op)
        py0 = torch.zeros_like(y)
        one, _ = cuda_ms(lambda: k3(y, py0, None if dual == "wl1" else py0, None, atb, None,
                                    None, (9, 0), scal_f, (3, 0, 0), n_steps=1,
                                    with_stats=False, niter_solve=3, **kw), 200)
        b1, _ = bound_kernel3(N * N, 1, taps, 3, mode="tv" if dual == "wl1" else mode,
                              dual=dual, niter_inner=10)
        times[mode] = (k_ms, p_ms, b_ms, b_by)
        log(f"kernel3 {name} timing ({reps * BLOCK} steps, plain {BLOCK}) on {plan}: kernel "
            f"{k_ms:.3f} ms / {BLOCK / k_ms * 1e3:.1f} iters/s{plain_note(p_ms, BLOCK)}, "
            f"bound {b_ms:.4f} ms ({b_by}), {k_ms / b_ms:.1f}x the bound; one step, no "
            f"statistics: {one * 1e3:.2f} us per call on {k3.last_plan}, bound "
            f"{b1 * 1e3:.3f} us")
    k_ms, p_ms, b_ms, b_by = times["tv"]
    report["ulpda_block_update_cuda"] = dict(
        max_abs_err=worst, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)


def make_inpainting(dev, seed=0, n=N):
    """The inpainting workload's image (in [0, 1]) and data term at n^2, as
    ``wavelet_inpainting`` builds them on the card: the mask, then the
    noise, from one generator."""
    import torch

    from lmc_atomi_torch.ops.functionals import L2Data
    from lmc_atomi_torch.ops.linops import Mask
    from lmc_atomi_torch.utils.images import load_image

    img = torch.from_numpy(load_image("phantom", n)).to(dev) / 255.0
    gen = torch.Generator(device=dev).manual_seed(seed)
    mask = (torch.rand((n, n), generator=gen, device=dev) > 0.5).float()
    y = mask * img + INP_SIGMA * mask * torch.randn(
        (n, n), generator=gen, dtype=torch.float32, device=dev)
    return img, L2Data(op=Mask(mask=mask), b=y, sigma=1.0 / INP_SIGMA**2)


INP_GAMMA = INP_SIGMA**2  # MYULA: gamma = 1 / L, tau = 0.2 gamma
INP_ULPDA_TAU = 0.95 * INP_SIGMA**2  # ULPDA: tau = 0.95 / L, mu = 1


def _wavelet_blocks(update, l2, n_steps, block, seed, taps, quantiles=(), burn=0,
                    levels=INP_LEVELS, x0=None):
    """run_myula_wavelet_fused's block loop with the block update passed in,
    from ``l2.b`` or ``x0``; an int ``seed`` keys chain 0, a chain axis
    (``x0`` of shape ``(C, ny, nx)``) takes its ``C`` keys."""
    import torch

    from lmc_atomi_torch.kernels.myula_fused import _marker_state

    scal_f = (0.2 * INP_GAMMA, INP_GAMMA, l2.sigma, INP_GAMMA * INP_TAU_W, 1.0)
    x0 = l2.b if x0 is None else x0
    x, mean, m2 = x0, torch.zeros_like(x0), torch.zeros_like(x0)
    qh, qn = _marker_state(x0, len(quantiles), None)
    for b in range(n_steps // block):
        step0 = b * block
        x, mean, m2, qh, qn = update(
            x, l2.b, l2.op.mask, mean, m2, (seed, 0) if isinstance(seed, int) else seed,
            scal_f,
            (step0, burn, max(step0 - burn, 0)), qh, qn, levels=levels,
            taps=taps, n_steps=block, quantiles=quantiles)
    return x, mean, m2, qh, qn


def _ulpda_wavelet_blocks(update, l2, n_steps, block, seed, taps, gfirst,
                          levels=INP_LEVELS, x0=None):
    """run_ulpda_wavelet_fused's block loop with the block update passed in,
    from ``l2.b`` or ``x0`` (keys as ``_wavelet_blocks``')."""
    import torch

    scal_f = (INP_ULPDA_TAU, 1.0, 1.0, 1.0, l2.sigma, INP_TAU_W)
    x0 = l2.b if x0 is None else x0
    zeros = torch.zeros_like(x0)
    x, c, xbar, mean, m2 = x0, zeros, x0, zeros, zeros
    for b in range(n_steps // block):
        step0 = b * block
        x, c, xbar, mean, m2, _, _ = update(
            x, c, xbar, l2.b, l2.op.mask, mean, m2,
            (seed, 2) if isinstance(seed, int) else seed, scal_f,
            (step0, 5, max(step0 - 5, 0)), levels=levels, taps=taps,
            n_steps=block, gfirst=gfirst)
    return x, c, xbar, mean, m2


# Haar past the 5 levels of a CTA's 32x32 region: the per-level launches
DEEP_HAAR_LEVELS = 6
# kernels 4 and 5 against their plain versions on each route: (label, size,
# taps, levels, quantiles, the route the wrappers must take)
WAVELET_CHECKS = [
    ("haar", N, 2, INP_LEVELS, (), "warp"),
    ("haar_ci95", N, 2, INP_LEVELS, (0.025, 0.975), "warp"),
    ("haar 5 levels", N, 2, 5, (), "tile"),
    ("d4", N, 4, INP_LEVELS, (), "resident"),
    ("d8", N, 8, INP_LEVELS, (), "resident"),
    ("d4", 2 * N, 4, INP_LEVELS, (), "passes"),
    (f"haar {DEEP_HAAR_LEVELS} levels", N, 2, DEEP_HAAR_LEVELS, (), "passes"),
]


def phase_kernel45(dev, report):
    """Kernels 4 and 5 against their plain versions on the inpainting
    posterior, 40 steps in blocks of 20, noise on, bit for bit on every
    route (``WAVELET_CHECKS``, kernel 5 in both orders); then timed per
    filter."""
    from lmc_atomi_torch.kernels.wavelet_fused import (
        ulpda_wavelet_block_update_cuda,
        ulpda_wavelet_block_update_ref,
        wavelet_block_update_cuda,
        wavelet_block_update_ref,
    )

    problems = {n: make_inpainting(dev, n=n)[1] for n in {c[1] for c in WAVELET_CHECKS}}
    worst4 = worst5 = 0.0
    for label, n, taps, lv, qs, route in WAVELET_CHECKS:
        l2, burn = problems[n], 10 if qs else 0
        got, routes = routes_of(lambda: _wavelet_blocks(
            wavelet_block_update_cuda, l2, CHECK_STEPS, CHECK_BLOCK, 7, taps, qs, burn, lv),
            wavelet_block_update_cuda)
        want = _wavelet_blocks(wavelet_block_update_ref, l2, CHECK_STEPS, CHECK_BLOCK, 7, taps,
                               qs, burn, lv)
        if routes[route] != CHECK_STEPS // CHECK_BLOCK:
            raise AssertionError(f"kernel 4 ({label}) took the routes {routes}, not {route}")
        err, parts = compare(f"kernel 4 ({label})", got, want, ("x", "mean", "m2", "qh", "qn"),
                             exact=True)
        worst4 = max(worst4, err)
        log(f"kernel4 {label} {n}^2 {CHECK_STEPS} steps, noise on, {route} "
            f"{wavelet_block_update_cuda.last_plan}: max_abs_err {parts}")
        if qs:
            continue
        for gfirst in (False, True):
            args = (l2, CHECK_STEPS, CHECK_BLOCK, 7, taps, gfirst, lv)
            got, routes = routes_of(lambda: _ulpda_wavelet_blocks(
                ulpda_wavelet_block_update_cuda, *args), ulpda_wavelet_block_update_cuda)
            if routes[route] != CHECK_STEPS // CHECK_BLOCK:
                raise AssertionError(f"kernel 5 ({label}) took the routes {routes}, not {route}")
            err, parts = compare(f"kernel 5 ({label} gfirst={gfirst})", got,
                                 _ulpda_wavelet_blocks(ulpda_wavelet_block_update_ref, *args),
                                 ("x", "c", "xbar", "mean", "m2"), exact=True)
            worst5 = max(worst5, err)
            log(f"kernel5 {label} gfirst={gfirst} {n}^2 {CHECK_STEPS} steps, noise on, {route}: "
                f"max_abs_err {parts}")
    # device time per call of the runners' default blocks (kernel 4: 500
    # steps, kernel 5: 250), kernel and plain version
    l2 = problems[N]
    b4, b5 = BLOCK, BLOCK // 2
    times = {}
    for name, taps in TAPS.items():
        k4, _ = cuda_ms(lambda: _wavelet_blocks(wavelet_block_update_cuda, l2, b4, b4, 8,
                                                taps), TIMED_STEPS // b4)
        k5, _ = cuda_ms(lambda: _ulpda_wavelet_blocks(ulpda_wavelet_block_update_cuda, l2,
                                                      b5, b5, 8, taps, False),
                        TIMED_STEPS // b5)
        p4 = plain_ms(name == "haar", lambda: _wavelet_blocks(
            wavelet_block_update_ref, l2, b4, b4, 8, taps))
        p5 = plain_ms(name == "haar", lambda: _ulpda_wavelet_blocks(
            ulpda_wavelet_block_update_ref, l2, b5, b5, 8, taps, False))
        bd4 = bound_kernel4(N * N, b4, taps, INP_LEVELS)
        bd5 = bound_kernel5(N * N, b5, taps, INP_LEVELS)
        times[name] = (k4, p4, bd4, k5, p5, bd5)
        log(f"kernel4 {name} timing ({TIMED_STEPS} steps, plain {b4}): kernel {k4:.3f} ms / "
            f"{b4 / k4 * 1e3:.1f} iters/s{plain_note(p4, b4)}, "
            f"bound {bd4[0]:.4f} ms ({bd4[1]})")
        log(f"kernel5 {name} timing ({TIMED_STEPS} steps, plain {b5}): kernel {k5:.3f} ms / "
            f"{b5 / k5 * 1e3:.1f} iters/s{plain_note(p5, b5)}, "
            f"bound {bd5[0]:.4f} ms ({bd5[1]})")
    qs = (0.025, 0.975)
    kq, _ = cuda_ms(lambda: _wavelet_blocks(wavelet_block_update_cuda, l2, b4, b4, 8, 2, qs,
                                            burn=0), TIMED_STEPS // b4)
    bdq = bound_kernel4(N * N, b4, 2, INP_LEVELS, n_q=2)
    log(f"kernel4 haar_ci95 timing ({TIMED_STEPS} steps): kernel {kq:.3f} ms / "
        f"{b4 / kq * 1e3:.1f} iters/s, bound {bdq[0]:.4f} ms ({bdq[1]})")
    k4, p4, (bd4, by4), k5, p5, (bd5, by5) = times["haar"]
    report["wavelet_block_update_cuda"] = dict(
        max_abs_err=worst4, ms=k4, plain_ms=p4, bound_ms=bd4, bound_by=by4, library_ms=None)
    report["ulpda_wavelet_block_update_cuda"] = dict(
        max_abs_err=worst5, ms=k5, plain_ms=p5, bound_ms=bd5, bound_by=by5, library_ms=None)


def make_large(dev, n, seed=0):
    """The large-image workload at n^2 (``n`` a side, or ``(ny, nx)``: the
    phantom's top-left corner): the image, the observation and the data
    terms (TV, and the MC-TV / ME-TV of the deconvolution models M2/M3: lamda
    0.3, gamma 15, 10 envelope trips)."""
    import torch

    from lmc_atomi_torch.ops.functionals import L2Data
    from lmc_atomi_torch.ops.linops import CirculantBlur2D, Gradient2D, uniform_kernel
    from lmc_atomi_torch.ops.ncvx_tv import L2NcvxTV
    from lmc_atomi_torch.utils.images import phantom

    ny, nx = (n, n) if isinstance(n, int) else n
    img = torch.from_numpy(phantom(max(ny, nx))[:ny, :nx].copy()).to(dev)
    blur = CirculantBlur2D.from_kernel((ny, nx), uniform_kernel(5, torch.float32, dev))
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = blur.matvec(img) + SIGMA_NOISE * torch.randn(
        (ny, nx), generator=gen, device=dev, dtype=torch.float32)
    terms = {"tv": L2Data.create(op=blur, b=y, sigma=1.0 / SIGMA_NOISE**2)}
    for mode, op2 in (("mctv", Gradient2D()), ("metv", None)):
        terms[mode] = L2NcvxTV(op=blur, b=y, op2=op2, sigma=1.0 / SIGMA_NOISE**2,
                               lamda=0.3, gamma=15.0, isotropic=True, niter_inner=10)
    return img, y, terms


def _tiling(halo_need, n):
    """The runners' default band and halo for a halo need at n rows."""
    from lmc_atomi_torch.kernels.myula_tiled import _round8, pick_band

    halo = _round8(max(halo_need, 8))
    return dict(band=pick_band(n, halo), halo=halo)


def _myula_tiling(l2, cfg, n):
    from lmc_atomi_torch.kernels.myula_fused import _fused_mode, _fused_params
    from lmc_atomi_torch.kernels.myula_tiled import _halo_need

    oy = _fused_params(l2)[1][0]
    mode, _, _, niter_inner = _fused_mode(l2)
    return _tiling(_halo_need(cfg.get("niter_tv", 10), oy, mode, niter_inner), n)


def kernel6_ranking(l2, cfg, shape):
    """The geometries ``tiled_plan`` weighs for kernel 6 on ``l2`` with
    ``cfg`` on this card, in its order: its pick first."""
    import torch

    from lmc_atomi_torch import _build
    from lmc_atomi_torch.kernels import myula_tiled
    from lmc_atomi_torch.kernels.myula_fused import _fused_mode, _fused_params

    taps, (oy, ox), _ = _fused_params(l2)
    mode, _, _, niter_inner = _fused_mode(l2)
    n_sm, smem_limit = _build.card_limits(torch.device("cuda", torch.cuda.current_device()))
    return myula_tiled._tiled_ranking(shape, taps, oy, ox, niter_tv=cfg.get("niter_tv", 10),
                                      tv_solver=cfg.get("tv_solver", "chambolle"), mode=mode,
                                      niter_inner=niter_inner, n_sm=n_sm, smem_limit=smem_limit)


def kernel6_on(geometry):
    """Kernel 6's wrapper launching ``geometry`` (an entry of
    ``kernel6_ranking``) in place of ``tiled_plan``'s pick: a measurement."""
    from unittest import mock

    from lmc_atomi_torch.kernels import myula_tiled

    def run(*args, **kwargs):
        with mock.patch.object(myula_tiled, "tiled_plan", lambda *_, **__: geometry):
            return myula_tiled.myula_tv_tiled_update_cuda(*args, **kwargs)

    return run


# kernel 6's timed modes at 2048^2: (name, data term, options)
KERNEL6_MODES = [("cold10", "tv", dict(niter_tv=10)),
                 ("fgp8", "tv", dict(niter_tv=8, tv_solver="fgp")),
                 ("mctv_cold10", "mctv", dict(niter_tv=10)),
                 ("metv_cold10", "metv", dict(niter_tv=10))]
# kernels 6 and 7's check on a size whose chosen interior divides neither side
NONSQUARE = (1024, 1500)
# kernel 7's duals per mode (the deconvolution models': l21, l1, l21)
L1_OR_L21 = {"tv": "l21", "mctv": "l1", "metv": "l21"}


def _dual7(mode):
    from lmc_atomi_torch.ops.functionals import L1Norm, L21Norm

    return (L21Norm if L1_OR_L21[mode] == "l21" else L1Norm)(sigma=TV_WEIGHT)


def kernel7_ranking(data, shape):
    """The geometries ``ulpda_tiled_plan`` weighs for kernel 7 on ``data``
    on this card, in its order: its pick first."""
    import torch

    from lmc_atomi_torch import _build
    from lmc_atomi_torch.kernels import ulpda_tiled
    from lmc_atomi_torch.kernels.myula_fused import _fused_mode, _fused_params

    taps, (oy, ox), _ = _fused_params(data)
    mode, _, _, niter_inner = _fused_mode(data)
    n_sm, smem_limit = _build.card_limits(torch.device("cuda", torch.cuda.current_device()))
    return ulpda_tiled._ulpda_tiled_ranking(tuple(shape), taps, oy, ox, niter_solve=3, mode=mode,
                                            niter_inner=niter_inner, n_sm=n_sm,
                                            smem_limit=smem_limit)


def _run_ulpda_tiled_blocks(update, proxf, proxg, x0, n_steps, block, cfg, seed):
    """run_ulpda_tv_tiled's block loop with the block update passed in, from
    the state _run_ulpda_blocks starts kernel 3 at (x = x_prev = x0, zero
    dual, burn-in 5); keys as ``_run_blocks``'. Returns (x, py, px, xbar,
    mean, m2), as kernel 3."""
    import torch

    from lmc_atomi_torch.kernels.ulpda_fused import _pack_ulpda_scal, _ulpda_setup
    from lmc_atomi_torch.kernels.ulpda_tiled import _ulpda_halo_need
    from lmc_atomi_torch.ops.linops import Gradient2D

    (taps, (oy, ox), atb, mode, lamda, gamma_mc, niter_inner, dual,
     lam, _) = _ulpda_setup(proxf, proxg, Gradient2D())
    tau0 = 0.95 * SIGMA_NOISE**2
    scal_f = _pack_ulpda_scal(proxf, proxg, tau0, 1.0, 1.0, 1.0, lamda, gamma_mc)
    tiling = _tiling(_ulpda_halo_need(3, oy, mode, niter_inner), x0.shape[-2])
    zeros = torch.zeros_like(x0)
    x, xp, py, px, mean, m2 = x0, x0, zeros, zeros, zeros, zeros
    for b in range(n_steps // block):
        step0 = b * block
        x, xp, py, px, mean, m2, _, _ = update(
            x, xp, py, px, atb, mean, m2, (seed, 0) if isinstance(seed, int) else seed,
            scal_f, (step0, 5, max(step0 - 5, 0)),
            taps=taps, oy=oy, ox=ox, lam=lam, n_steps=block, niter_solve=3, dual=dual,
            mode=mode, niter_inner=niter_inner, **tiling, **cfg)
    return x, py, px, x + 1.0 * (x - xp), mean, m2


def phase_kernel678(dev, report):
    """Kernels 6, 7 and 8 against their plain versions at 2048^2, 40 steps in
    blocks of 20, noise on, and against the whole-image kernels 2 and 3 on
    the same steps (kernel 6 bit for bit, also at NONSQUARE, on the plan
    ``tiled_plan`` names); then kernels 6 (in KERNEL6_MODES) and 7, their
    plain versions and kernels 2 and 3 timed per 200-step block, kernel 8
    per step."""
    from lmc_atomi_torch.kernels.myula_cuda import (
        myula_tv_fused_update_cuda,
        myula_tv_fused_update_ref,
    )
    from lmc_atomi_torch.kernels.myula_fused import _fused_params, myula_tv_block_update_cuda
    from lmc_atomi_torch.kernels.myula_tiled import (
        myula_tv_tiled_update_cuda,
        myula_tv_tiled_update_ref,
    )
    from lmc_atomi_torch.kernels.ulpda_fused import ulpda_block_update_cuda
    from lmc_atomi_torch.kernels.ulpda_tiled import (
        ulpda_tv_tiled_update_cuda,
        ulpda_tv_tiled_update_ref,
    )

    n = LARGE_N
    _, y, terms = make_large(dev, n)
    runs6 = [(name, terms["tv"], cfg) for name, cfg in SOLVERS.items() if name != "warm5"]
    runs6 += [(f"{mode}_cold10", terms[mode], dict(niter_tv=10)) for mode in ("mctv", "metv")]
    k6 = myula_tv_tiled_update_cuda

    def check6(name, data, cfg, y0, shape):
        """Kernel 6 against its plain version and kernel 2's launch sequence,
        bit for bit; returns its plan."""
        cfg = dict(cfg, burn_in=10) if "quantiles" in cfg else dict(cfg)
        tcfg = dict(cfg, **_myula_tiling(data, cfg, shape[0]))
        got = _run_blocks(k6, data, y0, CHECK_STEPS, CHECK_BLOCK, tcfg, seed=7)
        plan = k6.last_plan
        want = _run_blocks(myula_tv_tiled_update_ref, data, y0, CHECK_STEPS, CHECK_BLOCK,
                           tcfg, seed=7)
        err, parts = compare(f"kernel 6 ({name})", got, want, ("x", "mean", "m2", "qh", "qn"),
                             exact=True)
        k2, routes = routes_of(lambda: _run_blocks(
            myula_tv_block_update_cuda, data, y0, CHECK_STEPS, CHECK_BLOCK, cfg, seed=7),
            myula_tv_block_update_cuda)
        _, parts2 = compare(f"kernel 6 against kernel 2 ({name})", got, k2,
                            ("x", "mean", "m2", "qh", "qn"), exact=True)
        log(f"kernel6 {name} {shape[0]}x{shape[1]} {CHECK_STEPS} steps, noise on, plan {plan}: "
            f"max_abs_err {parts}; against kernel 2 (routes {routes}): {parts2}")
        if routes["resident"]:
            raise AssertionError(f"kernel 2 took the resident route at {shape}")
        return err, plan

    worst6 = 0.0
    for name, data, cfg in runs6:
        worst6 = max(worst6, check6(name, data, cfg, y, (n, n))[0])
    _, y_ns, terms_ns = make_large(dev, NONSQUARE)
    err, plan = check6("cold10", terms_ns["tv"], dict(niter_tv=10), y_ns, NONSQUARE)
    worst6 = max(worst6, err)
    if NONSQUARE[0] % plan[0] == 0 or NONSQUARE[1] % plan[1] == 0:
        raise AssertionError(f"kernel 6's interior {plan[:2]} divides a side of {NONSQUARE}")
    k7, k3 = ulpda_tv_tiled_update_cuda, ulpda_block_update_cuda
    fields = ("x", "py", "px", "xbar", "mean", "m2")

    def check7(mode, gfirst, data, y0, shape):
        """Kernel 7 against its plain version and kernel 3's launch sequence,
        bit for bit, on ``ulpda_tiled_plan``'s geometry; returns its plan."""
        label = f"{mode} {type(_dual7(mode)).__name__} gfirst={gfirst}"
        args = (data, _dual7(mode), y0, CHECK_STEPS, CHECK_BLOCK, dict(gfirst=gfirst), 7)
        got = _run_ulpda_tiled_blocks(k7, *args)
        plan = k7.last_plan
        want = _run_ulpda_tiled_blocks(ulpda_tv_tiled_update_ref, *args)
        err, parts = compare(f"kernel 7 ({label})", got, want, fields, exact=True)
        whole, routes = routes_of(lambda: _run_ulpda_blocks(
            k3, data, _dual7(mode), y0, CHECK_STEPS, CHECK_BLOCK,
            dict(gfirst=gfirst, niter_solve=3), 7), k3)
        _, parts3 = compare(f"kernel 7 against kernel 3 ({label})", got, whole, fields,
                            exact=True)
        log(f"kernel7 {label} {shape[0]}x{shape[1]} {CHECK_STEPS} steps, noise on, plan "
            f"{plan}: max_abs_err {parts}; against kernel 3 (routes {routes}): {parts3}")
        if plan != kernel7_ranking(data, shape)[0]:
            raise AssertionError(f"kernel 7 ran {plan}, not ulpda_tiled_plan's")
        if routes["resident"]:
            raise AssertionError(f"kernel 3 took the resident route at {shape}")
        return err, plan

    worst7 = 0.0
    for mode, gfirst in (("tv", False), ("tv", True), ("mctv", False), ("metv", False)):
        worst7 = max(worst7, check7(mode, gfirst, terms[mode], y, (n, n))[0])
    err, plan = check7("tv", False, terms_ns["tv"], y_ns, NONSQUARE)
    worst7 = max(worst7, err)
    if NONSQUARE[0] % plan[0] == 0 or NONSQUARE[1] % plan[1] == 0:
        raise AssertionError(f"kernel 7's interior {plan[:2]} divides a side of {NONSQUARE}")
    l2 = terms["tv"]
    gamma = SIGMA_NOISE**2
    tail = (0.2 * gamma, gamma, TV_WEIGHT * gamma)
    _, y_512, terms_512 = make_large(dev, N)
    worst8 = 0.0
    for shape, data, x, n_tail in (((n, n), l2, y, 5), (NONSQUARE, terms_ns["tv"], y_ns, 2),
                                   ((N, N), terms_512["tv"], y_512, 2)):
        plans, err8 = set(), 0.0
        for g in range(n_tail):
            grad = data.grad(x)
            got = myula_tv_fused_update_cuda(x, grad, (7, 0, g), *tail)
            plans.add(myula_tv_fused_update_cuda.last_plan)
            want = myula_tv_fused_update_ref(x, grad, (7, 0, g), *tail)
            err, _ = compare(f"kernel 8 {shape} (step {g})", (got,), (want,), ("x",),
                             exact=True)
            err8 = max(err8, err)
            x = got
        worst8 = max(worst8, err8)
        log(f"kernel8 {shape[0]}x{shape[1]} {n_tail} single steps, noise on: max_abs_err "
            f"{err8:.3e}, plan {plans}")
        route = {p[0] for p in plans}
        if shape == (n, n) and route != {"cone"} or shape == (N, N) and route != {"resident"}:
            raise AssertionError(f"kernel 8 at {shape} took the routes {route}")

    # device time per 200-step block (kernels and plain versions at the
    # runners' block), kernels 2 and 3 on the same blocks
    taps = _fused_params(l2)[0]
    npix, blk = n * n, LARGE_BLOCK
    times = {}
    for name, mode, cfg in KERNEL6_MODES:
        data = terms[mode]
        tcfg = dict(cfg, **_myula_tiling(data, cfg, n))
        t6, _ = cuda_ms(lambda: _run_blocks(k6, data, y, blk, blk, tcfg, 8), 2)
        plan = k6.last_plan
        t2, _ = cuda_ms(lambda: _run_blocks(myula_tv_block_update_cuda, data, y, blk, blk, cfg,
                                            8), 2)
        times[name] = (t6, t2)
        log(f"kernel6 {name} timing {n}^2 per {blk}-step block: kernel 6 {t6:.3f} ms "
            f"({blk / t6 * 1e3:.1f} iters/s) on plan {plan}, kernel 2 {t2:.3f} ms "
            f"({blk / t2 * 1e3:.1f} iters/s)")
    p6, _ = cuda_ms(lambda: _run_blocks(myula_tv_tiled_update_ref, l2, y, blk, blk,
                                        dict(niter_tv=10, **_myula_tiling(l2, {}, n)), 8))
    b6 = bound_kernel2(npix, blk, taps, 10)
    log(f"kernel6 cold10 plain {p6:.3f} ms per {blk} steps; bound {b6[0]:.4f} ms ({b6[1]})")
    report["myula_tv_tiled_update_cuda"] = dict(
        max_abs_err=worst6, ms=times["cold10"][0], plain_ms=p6, bound_ms=b6[0],
        bound_by=b6[1], library_ms=None)

    cfg = dict(gfirst=False)
    times7 = {}
    for mode in ("tv", "mctv", "metv"):
        data, dual = terms[mode], _dual7(mode)
        t7, _ = cuda_ms(lambda: _run_ulpda_tiled_blocks(k7, data, dual, y, blk, blk, cfg, 8), 2)
        plan = k7.last_plan
        t3, _ = cuda_ms(lambda: _run_ulpda_blocks(k3, data, dual, y, blk, blk,
                                                  dict(niter_solve=3), 8), 2)
        b7 = bound_kernel7(npix, blk, taps, 3, mode=mode, dual=L1_OR_L21[mode], niter_inner=10)
        times7[mode] = (t7, b7)
        log(f"kernel7 {mode} timing {n}^2 per {blk}-step block: kernel 7 {t7:.3f} ms "
            f"({blk / t7 * 1e3:.1f} iters/s) on plan {plan}, kernel 3 {t3:.3f} ms "
            f"({blk / t3 * 1e3:.1f} iters/s); bound {b7[0]:.4f} ms ({b7[1]})")
    p7, _ = cuda_ms(lambda: _run_ulpda_tiled_blocks(ulpda_tv_tiled_update_ref, l2, _dual7("tv"),
                                                    y, blk, blk, cfg, 8))
    t7, b7 = times7["tv"]
    log(f"kernel7 tv plain {p7:.3f} ms per {blk} steps")
    report["ulpda_tv_tiled_update_cuda"] = dict(
        max_abs_err=worst7, ms=t7, plain_ms=p7, bound_ms=b7[0], bound_by=b7[1],
        library_ms=None)

    grad = l2.grad(y)
    k8, _ = cuda_ms(lambda: myula_tv_fused_update_cuda(y, grad, (8, 0, 0), *tail), 50)
    p8, _ = cuda_ms(lambda: myula_tv_fused_update_ref(y, grad, (8, 0, 0), *tail), 5)
    b8 = bound_kernel8(npix, 10)
    log(f"kernel8 timing {n}^2 per step: kernel {k8:.4f} ms, plain {p8:.4f} ms; "
        f"bound {b8[0]:.5f} ms ({b8[1]})")
    report["myula_tv_fused_update_cuda"] = dict(
        max_abs_err=worst8, ms=k8, plain_ms=p8, bound_ms=b8[0], bound_by=b8[1],
        library_ms=None)


def phase_main_path(dev, img, y, l2):
    """The MYULA TV-deblur main path, 20000 steps per fused run, 5000 for
    the unfused chain (held to a fused chain as deep, on the same key)."""
    import torch

    from lmc_atomi_torch.eval.metrics import psnr
    from lmc_atomi_torch.kernels.imaging import myula_imaging
    from lmc_atomi_torch.kernels.myula_fused import run_myula_tv_fused
    from lmc_atomi_torch.ops.functionals import TVNorm
    from lmc_atomi_torch.run.runner import run_chain

    gamma = SIGMA_NOISE**2
    tau = 0.2 * gamma
    x0 = torch.zeros((N, N), device=dev)
    blur_psnr = float(psnr(img, y))

    def check_and_report(name, out, ms, wall, steps=STEPS):
        mean = out.moments.mean
        if mean.shape != (N, N) or not bool(torch.isfinite(mean).all()):
            raise AssertionError(f"{name}: bad posterior mean")
        if not bool(torch.isfinite(out.moments.variance).all()):
            raise AssertionError(f"{name}: non-finite variance")
        p = float(psnr(img, mean))
        extra = ""
        if getattr(out, "quantiles", None):
            lo, hi = out.quantiles[0.025], out.quantiles[0.975]
            cover = float(((lo <= mean) & (mean <= hi)).float().mean())
            width = float((hi - lo).mean())
            extra = f" ci_cover={cover:.5f} ci_mean_width={width:.4f}"
            if cover < 0.99:
                raise AssertionError(f"{name}: CI maps bracket the mean on {cover}")
        log(f"main {name}: {steps / ms * 1e3:.1f} iters/s (device {ms:.1f} ms, "
            f"host {wall:.3f} s) psnr_mean={p:.4f} psnr_blurred={blur_psnr:.4f}"
            f"{extra} mem_used='{nvidia_smi('memory.used')}' "
            f"max_alloc={torch.cuda.max_memory_allocated() / 2**20:.1f}MiB")
        return p

    def timed(run, warm_steps, steps=STEPS):
        run(1, warm_steps)  # warm-up: another seed, fewer steps
        t0 = time.perf_counter()
        ms, out = cuda_ms(lambda: run(2, steps))
        return out, ms, time.perf_counter() - t0

    psnrs = {}
    for name, cfg in SOLVERS.items():
        cfg = dict(cfg, burn_in=2000) if "quantiles" in cfg else cfg
        out, ms, wall = timed(lambda seed, n: run_myula_tv_fused(
            l2, TV_WEIGHT, tau, gamma, x0, seed, n, block=BLOCK, **cfg), FUSED_WARM)
        psnrs[name] = check_and_report(name, out, ms, wall)
    kern = myula_imaging(l2, TVNorm(sigma=TV_WEIGHT, niter=10), tau=tau, gamma=gamma)
    out, ms, wall = timed(lambda seed, n: run_chain(kern, x0, seed, n, collect="stats"),
                          UNFUSED_WARM, UNFUSED_STEPS)
    unfused = check_and_report("unfused_cold10", out, ms, wall, UNFUSED_STEPS)
    fused = float(psnr(img, run_myula_tv_fused(l2, TV_WEIGHT, tau, gamma, x0, 2, UNFUSED_STEPS,
                                               block=BLOCK).moments.mean))
    log(f"main cold10 fused / unfused at {UNFUSED_STEPS} steps: psnr {fused:.4f} / {unfused:.4f}")
    if abs(fused - unfused) > PSNR_GAP:
        raise AssertionError(f"fused {fused:.4f} and unfused {unfused:.4f} differ")
    for name in ("fgp8", "cold10", "warm5"):
        if psnrs[name] < PSNR_FLOOR or abs(psnrs[name] - psnrs["cold10"]) > PSNR_GAP:
            raise AssertionError(
                f"{name}: psnr {psnrs[name]:.4f} (floor {PSNR_FLOOR}, cold10 "
                f"{psnrs['cold10']:.4f}, gap {PSNR_GAP})")
    stencil_grad_times(l2, y)


def stencil_grad_times(l2, y):
    """The unfused data gradient: ``CirculantBlur2D``'s opt-in wrap-conv
    stencils (``prefer_stencil``, ``A^T b`` cached) against the spectral
    default, timed at ``y``; returns the ms a call of each."""
    from lmc_atomi_torch.ops.functionals import L2Data

    sten = L2Data.create(op=dataclasses.replace(l2.op, prefer_stencil=True), b=y, sigma=l2.sigma)
    times, grads = {}, {}
    for name, term in (("spectral", l2), ("prefer_stencil", sten)):
        term.grad(y)  # FFT plans, cuDNN's choice
        times[name], grads[name] = cuda_ms(lambda: term.grad(y), STENCIL_CALLS)
    diff = float((grads["spectral"] - grads["prefer_stencil"]).abs().max())
    scale = max(1.0, float(grads["spectral"].abs().max()))
    log(f"main L2Data.grad {tuple(y.shape)}, {tuple(l2.op.h.shape)} PSF, {STENCIL_CALLS} calls "
        f"each: spectral {times['spectral']:.4f} ms, prefer_stencil "
        f"{times['prefer_stencil']:.4f} ms a call, max |difference| {diff:.3e}")
    if diff > STENCIL_TOL * scale:
        raise AssertionError(f"prefer_stencil's L2Data.grad differs by {diff:.3e}")
    return times


def phase_deconv(dev, img, models):
    """The deconvolution path through its entry point, fused and unfused, and
    the timed fused ULPDA chains; raises on a missed gate."""
    import torch

    from lmc_atomi_torch.eval.metrics import psnr
    from lmc_atomi_torch.experiments.deconv import prox_lmc_deconv
    from lmc_atomi_torch.kernels.ulpda_fused import run_ulpda_fused
    from lmc_atomi_torch.ops.linops import Gradient2D

    observed = {}

    def run(tag, steps=DECONV_STEPS, **kw):
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            results, series, summary = prox_lmc_deconv(
                size=N, n_steps=steps, niter_map=steps, seed=0,
                device=str(dev), wavelet_row=True, wavelet_levels=WL1_LEVELS, **kw)
        wall = time.perf_counter() - t0
        if json.loads(out.getvalue().strip().splitlines()[-1]) != summary:
            raise AssertionError(f"deconv {tag}: summary line differs from the result")
        if len(results) != 10 + kw.get("score_row", False) or len(series) != 10:
            raise AssertionError(f"deconv {tag}: {len(results)} results")
        for label, est in results.items():
            if est.shape != (N, N) or not bool(torch.isfinite(torch.from_numpy(est)).all()):
                raise AssertionError(f"deconv {tag} {label}: bad estimate")
            if label not in series:  # the score row records no metrics
                continue
            met = series[label]
            if met["psnr"].shape != (steps,) or not all(
                    bool(torch.isfinite(torch.from_numpy(v)).all()) for v in met.values()):
                raise AssertionError(f"deconv {tag} {label}: bad metric series")
        p = [summary["report"][label]["psnr"] for label in results]
        rates = list(summary["iters_per_sec"].values())
        log(f"deconv {tag}: {wall:.1f} s, iters/s {min(rates):.1f}..{max(rates):.1f}, "
            f"psnr_blurred={summary['psnr_blurred']:.4f} psnr M1..M{len(p)} = "
            + " ".join(f"{v:.4f}" for v in p))
        observed["psnr"] = summary["psnr_blurred"]
        return p

    psnrs = {"ULPDA": run("ULPDA fused", alg="ULPDA"),
             "MYULA": run("MYULA fused + score row", alg="MYULA", score_row=True,
                          score_train_steps=DECONV_SCORE_FIT),
             "MAP": run("MAP", compute_map=True)}
    # fused against unfused on the same keys, DECONV_CHECK_STEPS deep
    pairs = {alg: [run(f"{alg} {kind} {DECONV_CHECK_STEPS}", DECONV_CHECK_STEPS, alg=alg,
                       fused=kind == "fused") for kind in ("fused", "unfused")]
             for alg in ("ULPDA", "MYULA")}
    for branch, ref in DECONV_REF.items():
        # the k5 models M1-M3 and the wavelet row M10
        for j, want in ((0, ref[0]), (1, ref[1]), (2, ref[2]), (9, M10_REF[branch])):
            got = psnrs[branch][j]
            if not got >= want - DECONV_MARGIN:
                raise AssertionError(
                    f"deconv {branch} M{j + 1}: psnr {got:.4f} < {want} - {DECONV_MARGIN}")
    # the score row (M11): finite (checked above) and above the observation
    if not psnrs["MYULA"][10] > observed["psnr"]:
        raise AssertionError(f"deconv score row: psnr {psnrs['MYULA'][10]:.4f} <= the "
                             f"observation's {observed['psnr']:.4f}")
    for alg, (fus, unf) in pairs.items():
        gaps = [abs(a - b) for a, b in zip(fus, unf)]
        log(f"deconv {alg} fused - unfused: max |dpsnr| = {max(gaps):.4f} dB")
        if max(gaps) > PSNR_GAP:
            raise AssertionError(f"deconv {alg}: fused and unfused differ by {gaps}")

    # fused ULPDA chains of the k5 models, timed after a warm-up with another seed
    tau0 = 0.95 * SIGMA_NOISE**2
    x0 = torch.zeros((N, N), device=dev)
    for name, proxf, proxg, _ in models[:3]:
        def chain(seed, n=STEPS):
            return run_ulpda_fused(proxf, proxg, Gradient2D(), tau0, 1.0, x0, seed,
                                   n, block=BLOCK)
        chain(1, FUSED_WARM)
        t0 = time.perf_counter()
        ms, out = cuda_ms(lambda: chain(2))
        mean = out.moments.mean
        if not bool(torch.isfinite(mean).all()):
            raise AssertionError(f"run_ulpda_fused {name}: non-finite posterior mean")
        log(f"ulpda fused {name}: {STEPS / ms * 1e3:.1f} iters/s "
            f"(device {ms:.1f} ms, host {time.perf_counter() - t0:.3f} s) "
            f"psnr_mean={float(psnr(img, mean)):.4f} "
            f"max_alloc={torch.cuda.max_memory_allocated() / 2**20:.1f}MiB")


def phase_inpainting(dev):
    """The inpainting path: the workload through its entry point (5 rows),
    the fused D4/D8 chains, the timed 20000-step Haar chains, and a
    checkpointed run restarted from its checkpoint; raises on a missed
    gate."""
    import tempfile

    import torch

    from lmc_atomi_torch.eval.metrics import psnr
    from lmc_atomi_torch.experiments.inpainting import wavelet_inpainting
    from lmc_atomi_torch.kernels.wavelet_fused import (
        run_myula_wavelet_fused,
        run_ulpda_wavelet_fused,
    )
    from lmc_atomi_torch.run.longrun import run_resumable_fused

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        results, summary = wavelet_inpainting(
            size=N, n_steps=INP_STEPS, burn_in=INP_BURN, wavelet="haar", fused=True,
            device=str(dev))
    wall = time.perf_counter() - t0
    if json.loads(out.getvalue().strip().splitlines()[-1]) != summary:
        raise AssertionError("inpainting: summary line differs from the result")
    rep = {k: v["psnr"] for k, v in summary["report"].items()}
    acc = summary["mala_acceptance"]
    for name, est in results.items():
        if est.shape != (N, N) or not bool(torch.isfinite(torch.from_numpy(est)).all()):
            raise AssertionError(f"inpainting {name}: bad posterior mean")
    log(f"inpainting haar {INP_STEPS} steps: {wall:.1f} s, "
        + " ".join(f"{k}={v:.4f}" for k, v in rep.items())
        + f" mala_acceptance={acc:.4f} iters/s "
        + " ".join(f"{k}={v}" for k, v in summary["iters_per_sec"].items()))
    for name, want in INP_REF.items():
        if not rep[name] >= want - DECONV_MARGIN:
            raise AssertionError(f"inpainting {name}: psnr {rep[name]:.4f} < {want} - 1")
    for fused, unfused in (("MYULA-fused", "MYULA"),
                           ("ULPDA-wavelet-fused", "ULPDA-wavelet")):
        if abs(rep[fused] - rep[unfused]) > PSNR_GAP:
            raise AssertionError(f"inpainting {fused}: {rep[fused]} against {rep[unfused]}")
    if not 0.0 < acc <= 1.0:
        raise AssertionError(f"inpainting MALA acceptance {acc}")

    img, l2 = make_inpainting(dev)
    for name in ("d4", "d8"):
        kw = dict(levels=INP_LEVELS, taps=TAPS[name], burn_in=INP_BURN)
        m = run_myula_wavelet_fused(l2, INP_TAU_W, 0.2 * INP_GAMMA, INP_GAMMA, l2.b, (0, 0),
                                    INP_STEPS, **kw)
        u = run_ulpda_wavelet_fused(l2, INP_TAU_W, INP_ULPDA_TAU, 1.0, l2.b, (0, 2),
                                    INP_STEPS, **kw)
        pm, pu = float(psnr(img, m.moments.mean)), float(psnr(img, u.moments.mean))
        log(f"inpainting {name} fused {INP_STEPS} steps: MYULA-fused={pm:.4f} "
            f"ULPDA-wavelet-fused={pu:.4f}")
        for got, want, row in ((pm, INP_FUSED_REF[name][0], "MYULA"),
                               (pu, INP_FUSED_REF[name][1], "ULPDA")):
            if not got >= want - DECONV_MARGIN:
                raise AssertionError(f"inpainting {name} {row}-fused: {got:.4f} < {want} - 1")

    chains = {
        "myula_haar": lambda seed, n=STEPS: run_myula_wavelet_fused(
            l2, INP_TAU_W, 0.2 * INP_GAMMA, INP_GAMMA, l2.b, seed, n, block=BLOCK,
            burn_in=INP_BURN),
        "myula_haar_ci95": lambda seed, n=STEPS: run_myula_wavelet_fused(
            l2, INP_TAU_W, 0.2 * INP_GAMMA, INP_GAMMA, l2.b, seed, n, block=BLOCK,
            burn_in=2000, quantiles=(0.025, 0.975)),
        "ulpda_haar": lambda seed, n=STEPS: run_ulpda_wavelet_fused(
            l2, INP_TAU_W, INP_ULPDA_TAU, 1.0, l2.b, seed, n, block=BLOCK // 2,
            burn_in=INP_BURN),
    }
    for name, chain in chains.items():
        chain(1, FUSED_WARM)  # warm-up: another seed, fewer steps
        t0 = time.perf_counter()
        ms, res = cuda_ms(lambda: chain(2))
        mean = res.moments.mean
        if not bool(torch.isfinite(mean).all()):
            raise AssertionError(f"{name}: non-finite posterior mean")
        extra = ""
        if res.quantiles:
            lo, hi = res.quantiles[0.025], res.quantiles[0.975]
            cover = float(((lo <= mean) & (mean <= hi)).float().mean())
            extra = f" ci_cover={cover:.5f} ci_mean_width={float((hi - lo).mean()):.4f}"
            if cover < 0.99:
                raise AssertionError(f"{name}: CI maps bracket the mean on {cover}")
        log(f"inpainting {name}: {STEPS / ms * 1e3:.1f} iters/s (device {ms:.1f} ms, "
            f"host {time.perf_counter() - t0:.3f} s) psnr_mean={float(psnr(img, mean)):.4f}"
            f"{extra} max_alloc={torch.cuda.max_memory_allocated() / 2**20:.1f}MiB")

    # a checkpointed run of 2 segments, stopped after the first and restarted
    kw = dict(runner="wavelet", burn_in=INP_BURN, levels=INP_LEVELS,
              quantiles=(0.025, 0.975))
    args = (l2, INP_TAU_W, 0.2 * INP_GAMMA, INP_GAMMA, l2.b, (0, 5))
    straight = run_resumable_fused(*args, INP_STEPS, INP_STEPS, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "inpainting.ckpt")
        run_resumable_fused(*args, INP_STEPS // 2, INP_STEPS // 2, ckpt_path=ckpt, **kw)
        resumed = run_resumable_fused(*args, INP_STEPS, INP_STEPS // 2, ckpt_path=ckpt, **kw)
    dm = float((resumed["moments"].mean - straight["moments"].mean).abs().max())
    if not (torch.equal(resumed["position"], straight["position"])
            and all(torch.equal(resumed["quantiles"][p], straight["quantiles"][p])
                    for p in (0.025, 0.975))
            and resumed["moments"].count == straight["moments"].count and dm < 1e-4):
        raise AssertionError(f"resumed wavelet run differs from the straight run (mean {dm})")
    log(f"inpainting run_resumable_fused(wavelet) 2 x {INP_STEPS // 2} steps through a "
        f"checkpoint: position and CI maps equal to the straight run, mean within {dm:.2e}")


def _check_mean(name, out, img):
    """Posterior-mean PSNR of a chain result; raises on a bad mean."""
    import torch

    from lmc_atomi_torch.eval.metrics import psnr

    mean = out.moments.mean
    if mean.shape != img.shape or not bool(torch.isfinite(mean).all()):
        raise AssertionError(f"{name}: bad posterior mean")
    return float(psnr(img, mean))


def phase_large(dev):
    """The large-image path: 2048^2 tiled chains (kernels 6, 7) against the
    whole-image chains (kernels 2, 3) on the same key, with the JAX
    package's PSNR gates; CI maps; 4096^2; a checkpointed
    ``run_resumable_fused(runner="ulpda_tiled")``; and the fused tail
    (kernel 8) against the unfused chain (kernel 1 inside)."""
    import tempfile

    import torch

    from lmc_atomi_torch.kernels.imaging import myula_imaging
    from lmc_atomi_torch.kernels.myula_cuda import myula_imaging_fused
    from lmc_atomi_torch.kernels.myula_fused import run_myula_tv_fused
    from lmc_atomi_torch.kernels.myula_tiled import run_myula_tv_tiled
    from lmc_atomi_torch.kernels.ulpda_fused import run_ulpda_fused
    from lmc_atomi_torch.kernels.ulpda_tiled import run_ulpda_tv_tiled
    from lmc_atomi_torch.ops.functionals import L21Norm, TVNorm
    from lmc_atomi_torch.ops.linops import Gradient2D
    from lmc_atomi_torch.run.longrun import run_resumable_fused
    from lmc_atomi_torch.run.runner import run_chain

    gamma = SIGMA_NOISE**2
    tau, tau_pd = 0.2 * gamma, 0.95 * gamma

    def timed(chain, warm_steps=LARGE_BLOCK):
        chain(1, warm_steps)  # warm-up: one block, another seed
        t0 = time.perf_counter()
        ms, out = cuda_ms(lambda: chain(2))
        return out, ms, time.perf_counter() - t0

    def pair(label, n, img, steps, tiled, whole, floor=None):
        """A tiled chain and the whole-image chain on the same key: the max
        abs error of the position and the mean, the PSNRs, the rates."""
        t_out, t_ms, t_wall = timed(tiled)
        w_out, w_ms, _ = timed(whole)
        pt, pw = _check_mean(f"{label} tiled", t_out, img), _check_mean(f"{label} whole", w_out, img)
        ex = float((t_out.final_state.position - w_out.final_state.position).abs().max())
        em = float((t_out.moments.mean - w_out.moments.mean).abs().max())
        log(f"large {label} {n}^2 {steps} steps: tiled {steps / t_ms * 1e3:.1f} iters/s "
            f"(device {t_ms:.1f} ms, host {t_wall:.3f} s), whole-image "
            f"{steps / w_ms * 1e3:.1f} iters/s; psnr_mean tiled={pt:.4f} whole={pw:.4f}; "
            f"tiled - whole max_abs_err x={ex:.3e} mean={em:.3e} "
            f"max_alloc={torch.cuda.max_memory_allocated() / 2**20:.1f}MiB")
        if abs(pt - pw) > PSNR_GAP:
            raise AssertionError(f"{label}: tiled {pt} against whole-image {pw}")
        if floor is not None and not pt >= floor - LARGE_MARGIN:
            raise AssertionError(f"{label}: psnr {pt:.4f} < {floor} - {LARGE_MARGIN}")
        return t_out

    img, y, terms = make_large(dev, LARGE_N)
    l2 = terms["tv"]
    x0 = torch.zeros_like(y)
    kw = dict(block=LARGE_BLOCK, burn_in=LARGE_BURN)
    fgp8 = dict(tv_solver="fgp", niter_tv=8)
    pair("myula fgp8", LARGE_N, img, LARGE_STEPS,
         lambda s, n=LARGE_STEPS: run_myula_tv_tiled(l2, TV_WEIGHT, tau, gamma, x0, s, n,
                                                     **kw, **fgp8),
         lambda s, n=LARGE_STEPS: run_myula_tv_fused(l2, TV_WEIGHT, tau, gamma, x0, s, n,
                                                     **kw, **fgp8),
         LARGE_REF["fgp8"])
    dual = L21Norm(sigma=TV_WEIGHT)
    pair("ulpda tv", LARGE_N, img, LARGE_STEPS,
         lambda s, n=LARGE_STEPS: run_ulpda_tv_tiled(l2, dual, Gradient2D(), tau_pd, 1.0, x0,
                                                     s, n, niter_solve=3, **kw),
         lambda s, n=LARGE_STEPS: run_ulpda_fused(l2, dual, Gradient2D(), tau_pd, 1.0, x0, s,
                                                  n, niter_solve=3, **kw),
         LARGE_REF["ulpda"])
    mctv = terms["mctv"]
    pair("myula mctv cold10", LARGE_N, img, LARGE_STEPS,
         lambda s, n=LARGE_STEPS: run_myula_tv_tiled(mctv, TV_WEIGHT, tau, gamma, x0, s, n,
                                                     **kw),
         lambda s, n=LARGE_STEPS: run_myula_tv_fused(mctv, TV_WEIGHT, tau, gamma, x0, s, n,
                                                     **kw),
         LARGE_REF["mctv"])
    qs = (0.025, 0.975)
    out, ms, wall = timed(lambda s, n=LARGE_STEPS: run_myula_tv_tiled(
        l2, TV_WEIGHT, tau, gamma, x0, s, n, quantiles=qs, quantile_thin=8, **kw))
    mean = out.moments.mean
    lo, hi = out.quantiles[qs[0]], out.quantiles[qs[1]]
    cover = float(((lo <= mean) & (mean <= hi)).float().mean())
    log(f"large myula cold10 + 95% CI (thin 8) {LARGE_N}^2: {LARGE_STEPS / ms * 1e3:.1f} "
        f"iters/s (device {ms:.1f} ms, host {wall:.3f} s) psnr_mean="
        f"{_check_mean('ci', out, img):.4f} ci_cover={cover:.5f} "
        f"ci_mean_width={float((hi - lo).mean()):.4f}")
    if cover < 0.99:
        raise AssertionError(f"large CI maps bracket the mean on {cover}")

    # a checkpointed primal-dual run of 2 segments against the straight run
    rkw = dict(runner="ulpda_tiled", burn_in=RESUME_STEPS // 4)
    args = (l2, TV_WEIGHT, tau_pd, 1.0, x0, (0, 5))
    straight = run_resumable_fused(*args, RESUME_STEPS, RESUME_STEPS, **rkw)
    half = RESUME_STEPS // 2
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "ulpda_tiled.ckpt")
        run_resumable_fused(*args, half, half, ckpt_path=ckpt, **rkw)
        resumed = run_resumable_fused(*args, RESUME_STEPS, half, ckpt_path=ckpt, **rkw)
    # the position, dual and previous sample bit for bit (the noise is keyed
    # by the global step); the moments merge with the Chan combine, which
    # rounds otherwise than one Welford stream
    same = {"x": torch.equal(resumed["position"], straight["position"])}
    same.update((k, torch.equal(a, b)) for k, a, b in zip(
        ("y", "xprev"), resumed["ulpda_extras"], straight["ulpda_extras"]))
    want = straight["moments"].mean
    dm = float((resumed["moments"].mean - want).abs().max())
    tol = REL_TOL * max(1.0, float(want.abs().max()))
    if not (all(same.values()) and resumed["moments"].count == straight["moments"].count
            and dm <= tol):
        raise AssertionError(f"resumed ulpda_tiled run differs from the straight run: "
                             f"equal {same}, mean {dm} (tol {tol})")
    log(f"large run_resumable_fused(ulpda_tiled) {LARGE_N}^2 2 x {half} steps through a "
        f"checkpoint: position, dual and previous sample equal to the straight run, mean "
        f"within {dm:.2e} (tol {tol:.1e})")

    # kernel 8: one fused step per call against the unfused step (kernel 1)
    fused = myula_imaging_fused(l2, TV_WEIGHT, tau, gamma)
    unfused = myula_imaging(l2, TVNorm(sigma=TV_WEIGHT, niter=10), tau, gamma)
    outs = {}
    for name, kern in (("fused", fused), ("unfused", unfused)):
        outs[name] = timed(
            lambda s, n=TAIL_STEPS, k=kern: run_chain(k, x0, (s, 3), n, collect="stats",
                                                      burn_in=min(TAIL_BURN, n - 1)),
            warm_steps=20)
    pf, pu = (_check_mean(f"tail {k}", outs[k][0], img) for k in ("fused", "unfused"))
    ex = float((outs["fused"][0].final_state.position
                - outs["unfused"][0].final_state.position).abs().max())
    log(f"large myula_imaging_fused cold10 {LARGE_N}^2 {TAIL_STEPS} steps: fused "
        f"{TAIL_STEPS / outs['fused'][1] * 1e3:.1f} iters/s, unfused "
        f"{TAIL_STEPS / outs['unfused'][1] * 1e3:.1f} iters/s; psnr_mean fused={pf:.4f} "
        f"unfused={pu:.4f}; fused - unfused max_abs_err x={ex:.3e}")
    if abs(pf - pu) > PSNR_GAP:
        raise AssertionError(f"fused tail {pf} against unfused {pu}")

    # 4096^2: the tiled chain against the whole-image one on the same key
    img, y, terms = make_large(dev, HUGE_N)
    l2 = terms["tv"]
    x0 = torch.zeros_like(y)
    hkw = dict(block=LARGE_BLOCK, burn_in=HUGE_BURN, **fgp8)
    pair("myula fgp8", HUGE_N, img, HUGE_STEPS,
         lambda s, n=HUGE_STEPS: run_myula_tv_tiled(l2, TV_WEIGHT, tau, gamma, x0, s, n, **hkw),
         lambda s, n=HUGE_STEPS: run_myula_tv_fused(l2, TV_WEIGHT, tau, gamma, x0, s, n, **hkw))


# --- multi-chain sampling: kernels 2 and 3 with a chain axis ----------------
MC_N, MC_CHAINS = 64, 8  # the chain-axis checks: 8 chains a call at 64^2
MC_BIG = 2  # chains at 512^2
MC_MANY = 200  # chains past the co-resident CTAs at 64^2: two resident launches
MC_MANY_PICK = (0, 1, 131, 132, MC_MANY - 1)  # its chains held to the solo calls
MC_TIMED_STEPS = 100  # the chain-axis call timed against its plain version
MC_UQ = dict(size=64, n_chains=64, n_steps=5000, burn_in=500)
MC_UQ_BIG = dict(size=N, n_chains=4, n_steps=5000, burn_in=2000)
MC_FARM_CHAINS, MC_FARM_STEPS, MC_TILED_STEPS = 2, 1000, 400
# the chain checks of kernels 2-7: two blocks; the CI runs' burn-in
# leaves 10 P^2 observations (past the 5 of the bootstrap)
CHAIN_STEPS, CHAIN_BLOCK, CHAIN_CI_BURN = 12, 6, 2
# kernel 2 with a chain axis: (data term, options)
K2_CHAIN_RUNS = {
    "cold10": ("tv", dict(niter_tv=10)),
    "fgp8": ("tv", dict(niter_tv=8, tv_solver="fgp")),
    "cold10_ci95": ("tv", dict(niter_tv=10, quantiles=(0.025, 0.975), burn_in=CHAIN_CI_BURN)),
    "mctv_cold10": ("mctv", dict(niter_tv=10)),
    "metv_cold10": ("metv", dict(niter_tv=10)),
}
# kernel 3 with a chain axis: (data term, gfirst); l21 duals but MC-TV's l1
K3_CHAIN_RUNS = [(m, g) for m in ("tv", "mctv", "metv") for g in (False, True)]
# kernels 4 and 5 with a chain axis: 8 chains a call at 64^2 on every route a
# 64^2 shape reaches ((label, taps, levels, quantiles, route); D4 on the
# per-level launches through a patched plan), and D4 with more chains than
# co-resident CTAs (resident launches in turn)
WV_CHAIN_N, WV_CHAIN_C, WV_CHAIN_MANY = 64, 8, 200
WV_CHAIN_CHECKS = [
    ("haar", 2, INP_LEVELS, (), "warp"),
    ("haar_ci95", 2, INP_LEVELS, (0.025, 0.975), "warp"),
    ("haar 5 levels", 2, 5, (), "tile"),
    ("d4", 4, INP_LEVELS, (), "resident"),
    ("d8", 8, INP_LEVELS, (), "resident"),
    (f"haar {DEEP_HAAR_LEVELS} levels", 2, DEEP_HAAR_LEVELS, (), "passes"),
    ("d4 (patched plan)", 4, INP_LEVELS, (), "passes"),
]
WV_TIMED_CHAINS = 64  # Haar chains at 64^2: one call against one-chain calls
# kernels 6 and 7 with a chain axis: 4 chains a call at 256^2 (two bands)
TL_CHAIN_N, TL_CHAIN_C = 256, 4
K6_CHAIN_RUNS = {"cold10_ci95": ("tv", dict(niter_tv=10, quantiles=(0.025, 0.975),
                                            burn_in=CHAIN_CI_BURN)),
                 "fgp8": ("tv", dict(niter_tv=8, tv_solver="fgp")),
                 "mctv_cold10": ("mctv", dict(niter_tv=10))}
K7_CHAIN_RUNS = [("tv", False), ("tv", True), ("metv", False)]

# the mixtures path (experiments/{mixtures,laplace_mixtures,prox_mixtures}.py):
# the paper's workloads 1-3 at full width (n=5 components, d=2, the CLI
# defaults); cut in depth only, to k=1000 steps (the CLIs: 5000, 5000, 10000)
MIX_K = 1000
MIX_CHAINS = 1024
MIX_PICK = (0, MIX_CHAINS - 1)  # chains held to their one-chain runs
MIX_ONE_STEPS = 100  # the one-chain runs' depth: the first steps of the chains
# samplers whose chains equal their one-chain runs bit for bit: all but
# IHPULA, whose eigh a batched call may take by another algorithm; its
# chains are held within MIX_EIGH_TOL of the one-chain run's scale
MIX_EIGH_TOL = 1e-3
MIX_SERIAL, MIX_SERIAL_STEPS = 16, 25  # chains one run_chain after another
MIX_W2_FULL = 5000  # one W2 curve timed at the CLI's default k
# the gamma=0.1, n=2 f32 regression (tests/test_kernels.py:174 runs 10000 steps; cut
# to 5000, past step ~3036 where the old eigvalsh chain diverged)
MIX_IHPULA_STEPS = 5000
MIX_PROFILE_STEPS = 100
# gates from the JAX package on the same configuration on the CPU (f32, 1024
# chains x 1000 steps, seeds 0-3), computed by scripts/mixture_gates.py: the
# final Sinkhorn W2 of chain 0 within [0.5 min, 1.5 max] of JAX's chains 0
# and 1 over the seeds, and each sampler's pooled mean within [min (mean - 5
# se), max (mean + 5 se)] over the seeds, per coordinate (se: the standard
# error of the 1024 chain means). The seeds move the start and the noise,
# which the port draws otherwise.
MIX_GATES = {  # sampler: (W2 gate or None, pooled-mean low (x, y), high (x, y))
    "gaussian": {
        "ULA": ((1.0046, 5.4785), (-0.4874, -0.6855), (0.2673, 0.1366)),
        "MALA": ((1.1473, 4.9477), (-0.5493, -0.6698), (0.1576, 0.043)),
        "PULA": ((0.9513, 6.6264), (-0.5237, -1.0665), (0.0551, 0.0547)),
        "IHPULA": ((1.1988, 7.0326), (-0.8309, -0.7309), (0.5095, 0.9716)),
        "MLA": ((1.0669, 4.5994), (-0.428, -0.8483), (0.3607, 0.3259)),
    },
    "laplace": {
        "ULA": ((6.9441, 24.6239), (-1.5861, -1.5897), (1.9392, 1.0807)),
        "MALA": ((7.5873, 25.0073), (-1.7887, -1.5882), (1.842, 1.1445)),
        "PULA": ((6.9094, 26.387), (-1.8697, -1.7234), (1.6535, 0.9926)),
        "IHPULA": ((4.1486, 30.0976), (-1.2279, -0.9224), (1.6815, 1.3969)),
        "MLA": ((6.061, 40.9365), (-3.9215, -4.8696), (4.2284, 3.1205)),
    },
    "prox": {
        "PGLD": (None, (-0.4762, -0.6554), (0.2541, 0.1179)),
        "MYULA": (None, (-0.4673, -0.5807), (0.1309, 0.0474)),
        "MYMALA": (None, (-0.4696, -0.623), (0.0415, 0.0877)),
        "PP-ULA": (None, (-0.4551, -0.6476), (-0.004, 0.0017)),
        "FBULA": (None, (-0.4352, -0.6191), (0.1276, 0.0156)),
        "LBMUMLA": (None, (-0.36, -0.7062), (0.2063, 0.2726)),
    },
}


def _chain_starts(y, n_chains):
    """Distinct starts of ``n_chains`` chains: the observation, shifted."""
    import torch

    return torch.stack([y + 4.0 * c for c in range(n_chains)]).contiguous()


def _ulpda_terms(terms, mode):
    from lmc_atomi_torch.ops.functionals import L1Norm, L21Norm

    return terms[mode], (L1Norm if mode == "mctv" else L21Norm)(sigma=TV_WEIGHT)


def _hold_chains(label, kern, plain, run, x0, keys, picks, fields, plain_axis=False):
    """Chain axis against its parts, noise on: the kernel's call on every
    chain of ``x0`` under ``keys`` (routes counted where the wrapper has
    them) against the plain version's call on the same chain axis (with
    ``plain_axis``), and each chain of ``picks`` against the kernel's
    one-chain call under its key (and, without ``plain_axis``, the plain
    version's), each at max abs error 0. Returns the worst error, the
    routes and the kernel's plan."""
    if hasattr(kern, "routes"):
        got, routes = routes_of(lambda: run(kern, x0, keys), kern)
    else:
        got, routes = run(kern, x0, keys), {}
    plan = kern.last_plan
    worst = 0.0
    if plain_axis:
        worst, _ = compare(f"{label} vs the plain chain axis", got, run(plain, x0, keys),
                           fields, exact=True)
    sides = (("solo", kern),) + (() if plain_axis else (("plain", plain),))
    for c in picks:
        mine = [None if g is None else g[c] for g in got]
        for side, fn in sides:
            want = run(fn, x0[c].contiguous(), keys[c])
            err, _ = compare(f"{label} chain {c} vs {side}", mine, want, fields, exact=True)
            worst = max(worst, err)
    return worst, routes, plan


def phase_chain_kernels(dev, report):
    """Kernels 2 and 3 with a chain axis, noise on: every chain of a call
    against the kernel's one-chain call under its chain key and against the
    plain version, max abs error 0, at 64^2 x 8 chains in every mode (a
    plan with several chains a resident launch), 512^2 x 2 and 64^2 x 200
    (more chains than co-resident CTAs: the launches take the chains in
    groups); then timed against the plain version and, per chain, against
    one-chain calls."""
    import torch

    from lmc_atomi_torch.core.random import chain_keys
    from lmc_atomi_torch.kernels.myula_fused import (
        _fused_mode,
        _fused_params,
        myula_tv_block_update_cuda,
        myula_tv_block_update_ref,
    )
    from lmc_atomi_torch.kernels.ulpda_fused import (
        ulpda_block_update_cuda,
        ulpda_block_update_ref,
    )

    k2, k3 = myula_tv_block_update_cuda, ulpda_block_update_cuda
    f2, f3 = ("x", "mean", "m2", "qh", "qn"), ("x", "py", "px", "xbar", "mean", "m2")
    cases = [(MC_N, MC_CHAINS, None), (N, MC_BIG, None), (MC_N, MC_MANY, MC_MANY_PICK)]
    worst2 = worst3 = 0.0
    plans2, plans3 = [], []
    for n, n_chains, picks in cases:
        _, y, terms = make_large(dev, n)
        x0 = _chain_starts(y, n_chains)
        keys = chain_keys((11, 0), n_chains)
        picks = range(n_chains) if picks is None else picks
        runs2 = K2_CHAIN_RUNS if n_chains == MC_CHAINS else {
            k: K2_CHAIN_RUNS[k] for k in (("cold10", "fgp8") if n == N else ("cold10",))}
        for name, (mode, cfg) in runs2.items():
            def run(fn, x, k, data=terms[mode], cfg=cfg):
                return _run_blocks(fn, data, x, CHAIN_STEPS, CHAIN_BLOCK, cfg, k)
            err, routes, plan = _hold_chains(f"kernel 2 {name} {n}^2 x {n_chains}", k2,
                                             myula_tv_block_update_ref, run, x0, keys,
                                             picks, f2)
            worst2 = max(worst2, err)
            plans2.append((plan, n_chains))
            log(f"kernel2 chain axis {name} {n}^2 x {n_chains} chains, {CHAIN_STEPS} steps, "
                f"noise on: routes {routes} plan {plan} (route, ty, tx, h, chains a launch); "
                f"chains {list(picks) if len(picks) < n_chains else 'all'} equal their solo "
                f"calls and the plain version (max_abs_err {err})")
            if routes["sequence"]:
                raise AssertionError(f"kernel 2 {name} {n}^2 x {n_chains} took the sequence")
        runs3 = K3_CHAIN_RUNS if n_chains == MC_CHAINS else [("tv", False)]
        for mode, gfirst in runs3:
            proxf, proxg = _ulpda_terms(terms, mode)
            cfg = dict(gfirst=gfirst, niter_solve=3)

            def run(fn, x, k, proxf=proxf, proxg=proxg, cfg=cfg):
                return _run_ulpda_blocks(fn, proxf, proxg, x, CHAIN_STEPS, CHAIN_BLOCK, cfg, k)
            err, routes, plan = _hold_chains(f"kernel 3 {mode} gfirst={gfirst} {n}^2", k3,
                                             ulpda_block_update_ref, run, x0, keys, picks, f3)
            worst3 = max(worst3, err)
            plans3.append((plan, n_chains))
            log(f"kernel3 chain axis {mode} gfirst={gfirst} {n}^2 x {n_chains} chains, "
                f"{CHAIN_STEPS} steps, noise on: routes {routes} plan {plan}; chains "
                f"{list(picks) if len(picks) < n_chains else 'all'} equal their solo calls "
                f"and the plain version (max_abs_err {err})")
            if routes["sequence"]:
                raise AssertionError(f"kernel 3 {mode} {n}^2 x {n_chains} took the sequence")
    for k, plans in (("2", plans2), ("3", plans3)):
        if not (any(p[4] > 1 for p, _ in plans) and any(p[4] < c for p, c in plans)):
            raise AssertionError(f"kernel {k}: no plan with several chains a launch, or "
                                 f"none with launches in turn: {plans}")

    # timed: the chain-axis call against its plain version (cold-10 and TV,
    # 64^2 x 8 chains); then per chain against one-chain calls, at 64^2 x
    # 64 chains and 512^2 x 2 chains, 500 steps a call
    _, y, terms = make_large(dev, MC_N)
    x0 = _chain_starts(y, MC_CHAINS)
    keys = chain_keys((12, 0), MC_CHAINS)
    l2, cfg = terms["tv"], dict(niter_tv=10)
    mode, _, _, niter_inner = _fused_mode(l2)
    k_ms, _ = cuda_ms(lambda: _run_blocks(k2, l2, x0, MC_TIMED_STEPS, MC_TIMED_STEPS, cfg,
                                          keys), 5)
    plan = k2.last_plan
    p_ms, _ = cuda_ms(lambda: _run_blocks(myula_tv_block_update_ref, l2, x0, MC_TIMED_STEPS,
                                          MC_TIMED_STEPS, cfg, keys))
    b_ms, b_by = bound_kernel2(MC_N * MC_N, MC_TIMED_STEPS, _fused_params(l2)[0], 10,
                               n_chains=MC_CHAINS)
    chain2 = dict(shape=[MC_CHAINS, MC_N, MC_N], steps=MC_TIMED_STEPS, plan=list(plan),
                  max_abs_err=worst2, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"kernel2 chain axis cold10 {MC_CHAINS} x {MC_N}^2, {MC_TIMED_STEPS} steps on {plan}: "
        f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{k_ms / b_ms:.1f}x the bound")
    proxf, proxg = _ulpda_terms(terms, "tv")
    cfg3 = dict(gfirst=False, niter_solve=3)
    k_ms, _ = cuda_ms(lambda: _run_ulpda_blocks(k3, proxf, proxg, x0, MC_TIMED_STEPS,
                                                MC_TIMED_STEPS, cfg3, keys), 5)
    plan = k3.last_plan
    p_ms, _ = cuda_ms(lambda: _run_ulpda_blocks(ulpda_block_update_ref, proxf, proxg, x0,
                                                MC_TIMED_STEPS, MC_TIMED_STEPS, cfg3, keys))
    b_ms, b_by = bound_kernel3(MC_N * MC_N, MC_TIMED_STEPS, _fused_params(proxf)[0], 3,
                               n_chains=MC_CHAINS)
    chain3 = dict(shape=[MC_CHAINS, MC_N, MC_N], steps=MC_TIMED_STEPS, plan=list(plan),
                  max_abs_err=worst3, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"kernel3 chain axis tv {MC_CHAINS} x {MC_N}^2, {MC_TIMED_STEPS} steps on {plan}: "
        f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{k_ms / b_ms:.1f}x the bound")
    for n, n_chains in ((MC_N, MC_UQ["n_chains"]), (N, MC_BIG)):
        _, y, terms = make_large(dev, n)
        x0 = _chain_starts(y, n_chains)
        keys = chain_keys((13, 0), n_chains)
        proxf, proxg = _ulpda_terms(terms, "tv")
        for k, run in ((k2, lambda x, key: _run_blocks(k2, terms["tv"], x, BLOCK, BLOCK,
                                                       dict(niter_tv=10), key)),
                       (k3, lambda x, key: _run_ulpda_blocks(k3, proxf, proxg, x, BLOCK, BLOCK,
                                                             cfg3, key))):
            packed, _ = cuda_ms(lambda: run(x0, keys), 2)
            plan = k.last_plan
            solo, _ = cuda_ms(lambda: [run(x0[c], keys[c]) for c in range(n_chains)], 2)
            name = "kernel2 cold10" if k is k2 else "kernel3 tv"
            log(f"{name} {n}^2 x {n_chains} chains, {BLOCK} steps: one call on {plan} "
                f"{packed:.3f} ms ({BLOCK * n_chains / packed * 1e3:.1f} chain-steps/s), "
                f"{n_chains} one-chain calls on {k.last_plan} {solo:.3f} ms "
                f"({BLOCK * n_chains / solo * 1e3:.1f} chain-steps/s): {solo / packed:.2f}x")
            (chain2 if k is k2 else chain3)[f"block_{n}x{n_chains}"] = dict(
                packed_ms=packed, solo_ms=solo, steps=BLOCK)
    report["myula_tv_block_update_cuda"]["chain_axis"] = chain2
    report["ulpda_block_update_cuda"]["chain_axis"] = chain3
    t0 = time.perf_counter()
    chain_kernels_4567(dev, report)
    log(f"kernels 4-7 with a chain axis: {time.perf_counter() - t0:.1f} s")


def chain_kernels_4567(dev, report):
    """Kernels 4-7 with a chain axis, noise on, every chain of a call held
    at max abs error 0 to the plain version's call on the chain axis and to
    the kernel's one-chain call under its key: kernels 4 and 5 (both
    orders) at 64^2 x 8 chains on each route of ``WV_CHAIN_CHECKS`` and D4
    at 64^2 x 200 (resident launches in turn; picked chains against the
    one-chain kernel and plain calls), kernels 6 and 7 at 256^2 x 4 chains;
    then 64 Haar chains at 64^2, a 500-step block, timed as one call
    against 64 one-chain calls."""
    import torch

    from lmc_atomi_torch.core.random import chain_keys
    from lmc_atomi_torch.kernels import wavelet_fused
    from lmc_atomi_torch.kernels.myula_fused import _fused_params
    from lmc_atomi_torch.kernels.myula_tiled import (
        myula_tv_tiled_update_cuda,
        myula_tv_tiled_update_ref,
    )
    from lmc_atomi_torch.kernels.ulpda_tiled import (
        ulpda_tv_tiled_update_cuda,
        ulpda_tv_tiled_update_ref,
    )
    from lmc_atomi_torch.kernels.wavelet_fused import (
        ulpda_wavelet_block_update_cuda,
        ulpda_wavelet_block_update_ref,
        wavelet_block_update_cuda,
        wavelet_block_update_ref,
    )

    k4, k5 = wavelet_block_update_cuda, ulpda_wavelet_block_update_cuda
    k6, k7 = myula_tv_tiled_update_cuda, ulpda_tv_tiled_update_cuda
    f4, f5 = ("x", "mean", "m2", "qh", "qn"), ("x", "c", "xbar", "mean", "m2")
    f7 = ("x", "py", "px", "xbar", "mean", "m2")
    _, l2 = make_inpainting(dev, n=WV_CHAIN_N)
    worst = dict.fromkeys(("4", "5", "6", "7"), 0.0)
    plans = {"4": [], "5": [], "6": [], "7": []}

    cases = [(WV_CHAIN_C, c) for c in WV_CHAIN_CHECKS]
    cases.append((WV_CHAIN_MANY, ("d4", 4, INP_LEVELS, (), "resident")))
    for n_chains, (label, taps, lv, qs, route) in cases:
        x0 = torch.stack([l2.b + 0.25 * c for c in range(n_chains)]).contiguous()
        keys = chain_keys((41, 0), n_chains)
        many = n_chains == WV_CHAIN_MANY
        burn = CHAIN_CI_BURN if qs else 0
        # the D4 per-level launches at 64^2, which no plan picks there
        with wavelet_route(route) if "patched" in label else contextlib.nullcontext():
            def run4(fn, x, k):
                return _wavelet_blocks(fn, l2, CHAIN_STEPS, CHAIN_BLOCK, k, taps, qs, burn,
                                       lv, x0=x)
            if many:
                # the plan's groups: the first, the last, and both sides of a seam
                g = wavelet_fused.wavelet_plan((WV_CHAIN_N, WV_CHAIN_N), taps, lv,
                                               torch.cuda.get_device_properties(dev)
                                               .multi_processor_count, n_chains)[3][0]
                picks = sorted({0, g - 1, min(g, n_chains - 1), n_chains - 1})
            else:
                picks = range(n_chains)
            err, routes, plan = _hold_chains(
                f"kernel 4 {label} {WV_CHAIN_N}^2 x {n_chains}", k4, wavelet_block_update_ref,
                run4, x0, keys, picks, f4, plain_axis=not many)
            worst["4"] = max(worst["4"], err)
            plans["4"].append((plan, n_chains))
            held = ("their solo kernel and plain calls" if many
                    else "the plain chain axis and their solo calls")
            log(f"kernel4 chain axis {label} {WV_CHAIN_N}^2 x {n_chains} chains, "
                f"{CHAIN_STEPS} steps, noise on: routes {routes} plan {plan} (route, levels, "
                f"gh, gw, chains a launch); chains {list(picks) if many else 'all'} equal "
                f"{held} (max_abs_err {err})")
            if routes[route] != CHAIN_STEPS // CHAIN_BLOCK:
                raise AssertionError(f"kernel 4 {label} x {n_chains} took {routes}, not {route}")
            for gfirst in ((False, True) if not qs and not many else ()):
                def run5(fn, x, k, gfirst=gfirst):
                    return _ulpda_wavelet_blocks(fn, l2, CHAIN_STEPS, CHAIN_BLOCK, k, taps,
                                                 gfirst, lv, x0=x)
                err, routes, plan = _hold_chains(
                    f"kernel 5 {label} gfirst={gfirst} {WV_CHAIN_N}^2", k5,
                    ulpda_wavelet_block_update_ref, run5, x0, keys, picks, f5,
                    plain_axis=True)
                worst["5"] = max(worst["5"], err)
                plans["5"].append((plan, n_chains))
                log(f"kernel5 chain axis {label} gfirst={gfirst} {WV_CHAIN_N}^2 x {n_chains} "
                    f"chains, {CHAIN_STEPS} steps, noise on: routes {routes} plan {plan}; "
                    f"every chain equals the plain chain axis and its solo call "
                    f"(max_abs_err {err})")
                if routes[route] != CHAIN_STEPS // CHAIN_BLOCK:
                    raise AssertionError(f"kernel 5 {label} took {routes}, not {route}")
    if not any(p[4] < c for p, c in plans["4"]):
        raise AssertionError(f"kernel 4: no plan with resident launches in turn: {plans['4']}")

    # kernels 6 and 7 at 256^2 x 4 chains
    _, y, terms = make_large(dev, TL_CHAIN_N)
    x0 = _chain_starts(y, TL_CHAIN_C)
    keys = chain_keys((42, 0), TL_CHAIN_C)
    for name, (mode, cfg) in K6_CHAIN_RUNS.items():
        data = terms[mode]
        tcfg = dict(cfg, **_myula_tiling(data, cfg, TL_CHAIN_N))

        def run6(fn, x, k, data=data, tcfg=tcfg):
            return _run_blocks(fn, data, x, CHAIN_STEPS, CHAIN_BLOCK, tcfg, k)
        err, _, plan = _hold_chains(f"kernel 6 {name} {TL_CHAIN_N}^2", k6,
                                  myula_tv_tiled_update_ref, run6, x0, keys,
                                  range(TL_CHAIN_C), f4, plain_axis=True)
        worst["6"] = max(worst["6"], err)
        plans["6"].append(plan)
        log(f"kernel6 chain axis {name} {TL_CHAIN_N}^2 x {TL_CHAIN_C} chains, band "
            f"{tcfg['band']} halo {tcfg['halo']}, {CHAIN_STEPS} steps, noise on: plan {plan}; "
            f"every chain equals the plain chain axis and its solo call (max_abs_err {err})")
    for mode, gfirst in K7_CHAIN_RUNS:
        proxf = terms[mode]

        def run7(fn, x, k, proxf=proxf, mode=mode, gfirst=gfirst):
            return _run_ulpda_tiled_blocks(fn, proxf, _dual7(mode), x, CHAIN_STEPS,
                                           CHAIN_BLOCK, dict(gfirst=gfirst), k)
        err, _, plan = _hold_chains(f"kernel 7 {mode} gfirst={gfirst} {TL_CHAIN_N}^2", k7,
                                  ulpda_tv_tiled_update_ref, run7, x0, keys,
                                  range(TL_CHAIN_C), f7, plain_axis=True)
        worst["7"] = max(worst["7"], err)
        plans["7"].append(plan)
        log(f"kernel7 chain axis {mode} gfirst={gfirst} {TL_CHAIN_N}^2 x {TL_CHAIN_C} chains, "
            f"{CHAIN_STEPS} steps, noise on: plan {plan}; every chain equals the plain chain "
            f"axis and its solo call (max_abs_err {err})")

    # timed: one call on the chain axis against one-chain calls, at the
    # runners' blocks: 64 Haar chains at 64^2 (kernel 4: 500 steps, kernel
    # 5: 250), 4 chains at 256^2 (kernels 6 and 7: 200 steps)
    card = nvidia_smi("name,power.limit")
    timed = {}

    def time_axis(k, name, block, x0, keys, bound):
        packed, _ = cuda_ms(lambda: block(x0, keys), 3)
        plan = k.last_plan
        solo, _ = cuda_ms(lambda: [block(x0[c], keys[c]) for c in range(len(keys))], 2)
        b_ms, b_by = bound
        log(f"{name} x {len(keys)} chains ({card}): one call on {plan} {packed:.3f} ms, "
            f"{len(keys)} one-chain calls on {k.last_plan} {solo:.3f} ms: "
            f"{solo / packed:.2f}x; bound {b_ms:.4f} ms ({b_by})")
        timed[k] = dict(shape=list(x0.shape), packed_ms=packed, solo_ms=solo, bound_ms=b_ms,
                        bound_by=b_by, card=card)

    b4, b5, nw = BLOCK, BLOCK // 2, WV_CHAIN_N * WV_CHAIN_N
    x0 = torch.stack([l2.b + 0.25 * c for c in range(WV_TIMED_CHAINS)]).contiguous()
    keys = chain_keys((43, 0), WV_TIMED_CHAINS)
    time_axis(k4, f"kernel4 haar {WV_CHAIN_N}^2, {b4} steps",
              lambda x, k: _wavelet_blocks(k4, l2, b4, b4, k, 2, x0=x), x0, keys,
              bound_kernel4(nw, b4, 2, INP_LEVELS, n_chains=WV_TIMED_CHAINS))
    time_axis(k5, f"kernel5 haar {WV_CHAIN_N}^2, {b5} steps",
              lambda x, k: _ulpda_wavelet_blocks(k5, l2, b5, b5, k, 2, False, x0=x), x0,
              keys, bound_kernel5(nw, b5, 2, INP_LEVELS, n_chains=WV_TIMED_CHAINS))
    _, y, terms = make_large(dev, TL_CHAIN_N)
    x0 = _chain_starts(y, TL_CHAIN_C)
    keys = chain_keys((44, 0), TL_CHAIN_C)
    nt, taps = TL_CHAIN_N * TL_CHAIN_N, _fused_params(terms["tv"])[0]
    cfg6 = dict(niter_tv=10, **_myula_tiling(terms["tv"], dict(niter_tv=10), TL_CHAIN_N))
    time_axis(k6, f"kernel6 cold10 {TL_CHAIN_N}^2, {LARGE_BLOCK} steps",
              lambda x, k: _run_blocks(k6, terms["tv"], x, LARGE_BLOCK, LARGE_BLOCK, cfg6, k),
              x0, keys, bound_kernel2(nt, LARGE_BLOCK, taps, 10, n_chains=TL_CHAIN_C))
    time_axis(k7, f"kernel7 tv {TL_CHAIN_N}^2, {LARGE_BLOCK} steps",
              lambda x, k: _run_ulpda_tiled_blocks(k7, terms["tv"], _dual7("tv"), x,
                                                   LARGE_BLOCK, LARGE_BLOCK, {}, k),
              x0, keys, bound_kernel7(nt, LARGE_BLOCK, taps, 3, n_chains=TL_CHAIN_C))
    for name, k, key in (("4", k4, "wavelet_block_update_cuda"),
                         ("5", k5, "ulpda_wavelet_block_update_cuda"),
                         ("6", k6, "myula_tv_tiled_update_cuda"),
                         ("7", k7, "ulpda_tv_tiled_update_cuda")):
        kept = ([[list(p), c] for p, c in plans[name]] if name in "45"
                else [list(p) for p in plans[name]])
        report[key]["chain_axis"] = dict(max_abs_err=worst[name], timed=timed[k], plans=kept)


def phase_multichain(dev):
    """The multichain path: ``multichain_deblur`` at 64^2 x 64 chains (MYULA
    and ULPDA, against the same chains run one call after another) and at
    512^2 x 4 chains, with the pooled-mean PSNR gates; and the chain farm of
    ``run_resumable_fused``: ``"tv"`` at 512^2 through a checkpoint against
    the straight run and each chain against its one-chain run, ``"wavelet"``
    at 512^2 and ``"tiled"`` and ``"ulpda_tiled"`` at 2048^2 each chain
    against its one-chain run; every farm makes one kernel call a block for
    all its chains (the calls counted and printed)."""
    import tempfile

    import torch

    from lmc_atomi_torch.core.random import chain_keys
    from lmc_atomi_torch.core.stats import RunningMoments
    from lmc_atomi_torch.experiments.multichain import multichain_deblur
    from lmc_atomi_torch.kernels.myula_fused import (
        myula_tv_block_update_cuda,
        run_myula_tv_fused,
    )
    from lmc_atomi_torch.kernels.myula_tiled import myula_tv_tiled_update_cuda
    from lmc_atomi_torch.kernels.ulpda_fused import run_ulpda_fused
    from lmc_atomi_torch.kernels.ulpda_tiled import ulpda_tv_tiled_update_cuda
    from lmc_atomi_torch.kernels.wavelet_fused import wavelet_block_update_cuda
    from lmc_atomi_torch.ops.functionals import L21Norm
    from lmc_atomi_torch.ops.linops import Gradient2D
    from lmc_atomi_torch.parallel.mesh import merge_chain_moments
    from lmc_atomi_torch.run.longrun import run_resumable_fused

    def uq(**kw):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            pooled, rhat, rep = multichain_deblur(device=str(dev), **kw)
        log(f"multichain {kw.get('kernel', 'myula')} {rep['size']}^2 x {rep['n_chains']} "
            f"chains, {rep['steps']} steps ({time.perf_counter() - t0:.1f} s in all): "
            f"aggregate {rep['aggregate_iters_per_sec']} iters/s, per chain "
            f"{rep['per_chain_iters_per_sec']} iters/s, psnr_pooled_mean="
            f"{rep['psnr_pooled_mean']:.4f} psnr_observed={rep['psnr_observed']:.4f} "
            f"rhat_max={rep['rhat_max']:.5f} rhat_mean={rep['rhat_mean']:.5f}")
        if not (rep["psnr_pooled_mean"] > rep["psnr_observed"]
                and math.isfinite(rep["rhat_max"])):
            raise AssertionError(f"multichain {kw}: {rep}")
        return pooled, rhat, rep

    # (c) 64^2 x 64 chains in one kernel call, and the same chains one call
    # after another: the same pooled mean, bit for bit
    size, n_chains, steps, burn = (MC_UQ[k] for k in ("size", "n_chains", "n_steps", "burn_in"))
    img, y, terms = make_large(dev, size)
    keys = chain_keys(chain_keys((0, 1), 1)[0], n_chains)
    x0 = torch.zeros((size, size), device=dev)
    proxf, proxg = _ulpda_terms(terms, "tv")
    noise = 1.0 if dev.type == "cuda" else 0.0  # as multichain_deblur's
    for kernel in ("myula", "ulpda"):
        pooled, _, rep = uq(kernel=kernel, **MC_UQ)

        def solo(key, n=steps):
            if kernel == "ulpda":
                return run_ulpda_fused(proxf, proxg, Gradient2D(), 0.95 * SIGMA_NOISE**2, 1.0,
                                       x0, key, n, burn_in=burn, noise_scale=noise).moments
            return run_myula_tv_fused(terms["tv"], TV_WEIGHT, 0.2 * SIGMA_NOISE**2,
                                      SIGMA_NOISE**2, x0, key, n, burn_in=burn,
                                      noise_scale=noise).moments
        solo((0, 9), 256)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moms = [solo(k) for k in keys]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        one_by_one = merge_chain_moments(RunningMoments(
            count=torch.tensor([m.count for m in moms]), mean=torch.stack([m.mean for m in moms]),
            m2=torch.stack([m.m2 for m in moms])))
        same = torch.equal(one_by_one.mean, pooled.mean)
        log(f"multichain {kernel} {size}^2: the same {n_chains} chains one "
            f"run_{'ulpda' if kernel == 'ulpda' else 'myula_tv'}_fused call after another: "
            f"aggregate {steps * n_chains / dt:.1f} iters/s ({dt:.3f} s); the packed calls "
            f"{rep['aggregate_iters_per_sec'] / (steps * n_chains / dt):.2f}x; pooled means "
            f"equal bit for bit: {same}")
        if not same:
            raise AssertionError(f"multichain {kernel}: packed and one-by-one chains differ")
    # (d) the main path's posterior at full width
    _, _, rep = uq(**MC_UQ_BIG)
    if rep["psnr_pooled_mean"] < PSNR_FLOOR:
        raise AssertionError(f"multichain {N}^2: psnr {rep['psnr_pooled_mean']} < {PSNR_FLOOR}")

    # (e) the chain farm: one kernel call a block for every chain, counted
    # on the runner's wrapper; the calls of the one-chain runs after it
    # are the farm's times its chains
    wrappers = {"tv": myula_tv_block_update_cuda, "wavelet": wavelet_block_update_cuda,
                "tiled": myula_tv_tiled_update_cuda, "ulpda_tiled": ulpda_tv_tiled_update_cuda}

    def farm(label, args, total, seg, kw, resume=False):
        x0 = args[4]
        wrapper = wrappers[kw["runner"]]
        before = wrapper.launches
        straight = run_resumable_fused(*args, total, seg, **kw)
        calls = wrapper.launches - before
        note = ""
        if resume:
            with tempfile.TemporaryDirectory() as tmp:
                ckpt = str(Path(tmp) / "farm.ckpt")
                run_resumable_fused(*args, total - seg, seg, ckpt_path=ckpt, **kw)
                resumed = run_resumable_fused(*args, total, seg, ckpt_path=ckpt, **kw)
            if not (torch.equal(resumed["position"], straight["position"])
                    and torch.equal(resumed["moments"].mean, straight["moments"].mean)):
                raise AssertionError(f"farm {label}: the resumed run differs")
            note = "; restarted from its checkpoint: equal to the straight run"
        ks = chain_keys(args[5], x0.shape[0])
        before = wrapper.launches
        for c in range(x0.shape[0]):
            one = run_resumable_fused(*args[:4], x0[c], ks[c], total, seg, **kw)
            if not (torch.equal(one["position"], straight["position"][c])
                    and torch.equal(one["moments"].mean, straight["moments"].mean[c])):
                raise AssertionError(f"farm {label}: chain {c} differs from its solo run")
        solo = wrapper.launches - before
        if not bool(torch.isfinite(straight["moments"].mean).all()):
            raise AssertionError(f"farm {label}: non-finite mean")
        log(f"farm {label}: {x0.shape[0]} chains x {total} steps in segments of {seg}, "
            f"counts {straight['moments'].count.tolist()}; {calls} calls of "
            f"{wrapper.__name__} (the {x0.shape[0]} one-chain runs: {solo}); each chain "
            f"equals its solo run_resumable_fused under its chain key{note}")
        if calls < 1 or solo != calls * x0.shape[0]:
            raise AssertionError(f"farm {label}: {calls} kernel calls for all chains, "
                                 f"{solo} for the one-chain runs: not one call a block")

    _, y, terms = make_large(dev, N)
    l2 = terms["tv"]
    gamma = SIGMA_NOISE**2
    x0 = torch.stack([y] * MC_FARM_CHAINS)
    farm(f"tv {N}^2", (l2, TV_WEIGHT, 0.2 * gamma, gamma, x0, (21, 0)), MC_FARM_STEPS,
         MC_FARM_STEPS // 2, dict(runner="tv", burn_in=200, quantiles=(0.025, 0.975)),
         resume=True)
    _, l2w = make_inpainting(dev)
    x0 = torch.stack([l2w.b] * MC_FARM_CHAINS)
    farm(f"wavelet {N}^2", (l2w, INP_TAU_W, 0.2 * INP_GAMMA, INP_GAMMA, x0, (22, 0)),
         MC_FARM_STEPS, MC_FARM_STEPS // 2, dict(runner="wavelet", burn_in=200,
                                                 levels=INP_LEVELS))
    _, y, terms = make_large(dev, LARGE_N)
    x0 = torch.stack([y] * MC_FARM_CHAINS)
    farm(f"tiled {LARGE_N}^2", (terms["tv"], TV_WEIGHT, 0.2 * gamma, gamma, x0, (23, 0)),
         MC_TILED_STEPS, MC_TILED_STEPS // 2, dict(runner="tiled", burn_in=100,
                                                   tv_solver="fgp", niter_tv=8))
    # the primal-dual farm: tv_sigma the l21 dual's weight, gamma the dual step
    farm(f"ulpda_tiled {LARGE_N}^2", (terms["tv"], TV_WEIGHT, 0.95 * gamma, 1.0, x0,
                                      (24, 0)),
         MC_TILED_STEPS, MC_TILED_STEPS // 2, dict(runner="ulpda_tiled", burn_in=100))


def mixture_workloads(dev):
    """The three mixture CLIs and their setups (target, generator, start,
    kernels) at the CLI defaults and seed 0, as the CLIs build them."""
    from lmc_atomi_torch.experiments.laplace_mixtures import laplace_setup, lmc_laplacian_mixture
    from lmc_atomi_torch.experiments.mixtures import gaussian_setup, lmc_gaussian_mixture
    from lmc_atomi_torch.experiments.prox_mixtures import prox_lmc_gaussian_mixture, prox_setup

    return {"gaussian": (lmc_gaussian_mixture, lambda: gaussian_setup(5, 0, dev)),
            "laplace": (lmc_laplacian_mixture, lambda: laplace_setup(5, 0.1, 0.1, 0, dev)),
            "prox": (prox_lmc_gaussian_mixture, lambda: prox_setup(5, 0.1, 0.01, 100, 0, dev))}


def _timed(fn):
    """``(fn(), seconds)`` on the host clock between two synchronisations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_mixtures(dev):
    """The mixtures path: each workload's CLI at 1024 chains (one step over
    all chains through ``run_chains``), its samples finite, MALA's and
    MYMALA's acceptance in (0, 1], chain 0's final W2 and every sampler's
    pooled mean within the JAX package's gates (MIX_GATES); chains 0 and
    1023 against their one-chain ``run_chain`` runs over the first
    MIX_ONE_STEPS steps (bit for bit, IHPULA within MIX_EIGH_TOL), the
    one-chain rate beside the batched one, and 16 chains one after another;
    one W2 curve timed at the CLI's default k; IHPULA's gamma=0.1, n=2 chain
    over MIX_IHPULA_STEPS f32 steps, finite, and whether ``torch.linalg.eigh`` waits
    for the card."""
    import warnings

    import numpy as np
    import torch

    from lmc_atomi_torch.core.random import chain_keys
    from lmc_atomi_torch.eval.wasserstein import w2_prefix_curve
    from lmc_atomi_torch.experiments.mixtures import gaussian_setup
    from lmc_atomi_torch.run.runner import run_chain, run_chains

    t_phase = time.perf_counter()
    for wl, (cli, setup) in mixture_workloads(dev).items():
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            res, wall = _timed(lambda: cli(k=MIX_K, n_chains=MIX_CHAINS, device=str(dev)))
        samples, summary = res[0], res[-1]
        accept = {m: float(v) for m, v in
                  re.findall(r"(\S+) percentage of effective samples: ([0-9.]+)", err.getvalue())}
        gates = MIX_GATES[wl]
        _, _, x0, kernels = setup()
        rows = []
        for i, (name, kern) in enumerate(kernels.items()):
            s = samples[name].reshape(MIX_CHAINS, MIX_K, 2)
            if not np.isfinite(s).all():
                raise AssertionError(f"mixtures {wl} {name}: non-finite samples")
            if name in accept and not 0.0 < accept[name] <= 1.0:
                raise AssertionError(f"mixtures {wl} {name}: acceptance {accept[name]}")
            pooled = s.reshape(-1, 2).mean(0)
            w2_gate, lo, hi = gates[name]
            if not (np.all(pooled >= lo) and np.all(pooled <= hi)):
                raise AssertionError(f"mixtures {wl} {name}: pooled mean {pooled} outside "
                                     f"[{lo}, {hi}]")
            w2 = summary.get("final_w2", {}).get(name)
            if (w2 is None) != (w2_gate is None) or (
                    w2 is not None and not w2_gate[0] <= w2 <= w2_gate[1]):
                raise AssertionError(f"mixtures {wl} {name}: chain 0's W2 {w2} outside {w2_gate}")
            keys = chain_keys((0, i), MIX_CHAINS)
            diffs, one_s = [], 0.0
            for c in MIX_PICK:
                one, dt = _timed(lambda: run_chain(kern, x0, keys[c], MIX_ONE_STEPS).samples)
                one_s += dt
                one, batch = one.cpu().numpy(), s[c, :MIX_ONE_STEPS]
                diff = float(np.abs(one - batch).max())
                exact = np.array_equal(one, batch)
                if not (exact or (name == "IHPULA"
                                  and diff <= MIX_EIGH_TOL * max(1.0, float(np.abs(one).max())))):
                    raise AssertionError(f"mixtures {wl} {name}: chain {c} differs from its "
                                         f"one-chain run by {diff}")
                diffs.append("equal" if exact else f"{diff:.3g}")
            rows.append(f"{name} {summary['iters_per_sec'][name]} aggregate iters/s, one chain "
                        f"{len(MIX_PICK) * MIX_ONE_STEPS / one_s:.1f}; chains {MIX_PICK} vs "
                        f"one-chain runs of {MIX_ONE_STEPS} steps {diffs}; W2 "
                        f"{w2 if w2 is None else round(w2, 4)} (gate {w2_gate}); pooled mean "
                        f"{pooled.round(4).tolist()} (gate {lo}, {hi})"
                        + (f"; acceptance {accept[name]}" if name in accept else ""))
        name, kern = next(iter(kernels.items()))
        _, dt = _timed(lambda: run_chains(kern._replace(chain_axis=False), x0, (0, 0),
                                         MIX_SERIAL_STEPS, MIX_SERIAL))
        log(f"mixtures {wl} (n=5, k={MIX_K}, {MIX_CHAINS} chains, CLI {wall:.1f} s): "
            + "; ".join(rows) + f". {MIX_SERIAL} {name} chains one after another "
            f"({MIX_SERIAL_STEPS} steps): {MIX_SERIAL * MIX_SERIAL_STEPS / dt:.1f} aggregate "
            f"iters/s")

    # one W2 curve at the Gaussian CLI's default k
    gm, gen, _, _ = gaussian_setup(5, 0, dev)
    true, s = gm.sample(gen, MIX_W2_FULL), gm.sample(gen, MIX_W2_FULL)
    w2_prefix_curve(true[:200], s[:200])  # warm-up
    (_, vals), dt = _timed(lambda: w2_prefix_curve(true, s))
    side = s[::max(1, MIX_W2_FULL // 2000)].shape[0]
    log(f"mixtures: one W2 curve at k={MIX_W2_FULL} ({vals.numel()} prefixes, Sinkhorn "
        f"200 iterations, {side} points a side): {dt * 1e3:.1f} ms; final W2 of two true "
        f"samples {float(vals[-1]):.4f}")

    # IHPULA, gamma = 0.1, n = 2, 10000 f32 steps
    from lmc_atomi_torch.experiments.configs import gaussian_mixture_config
    from lmc_atomi_torch.kernels import ihpula
    from lmc_atomi_torch.models import GaussianMixture

    gm2 = GaussianMixture.create(*gaussian_mixture_config(2), dtype=torch.float32, device=dev)
    kern = ihpula(gm2.grad_potential, gm2.hess_potential, 0.1)
    x0 = torch.randn(2, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    run_chain(kern, x0, (0, 3), 20)  # warm-up
    res, dt = _timed(lambda: run_chain(kern, x0, (0, 3), MIX_IHPULA_STEPS))
    if not bool(torch.isfinite(res.samples).all()):
        raise AssertionError("mixtures: the IHPULA gamma=0.1, n=2 chain diverged")
    h = gm2.hess_potential(x0)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.linalg.eigh(h)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:80] for w in caught if "synchroniz" in str(w.message)]
    log(f"mixtures: IHPULA gamma=0.1 n=2, {MIX_IHPULA_STEPS} f32 steps finite, "
        f"{dt / MIX_IHPULA_STEPS * 1e3:.3f} ms a step; torch.linalg.eigh waits for the card: "
        f"{bool(syncs)} {syncs[:1]}")
    log(f"mixtures path: {time.perf_counter() - t_phase:.1f} s")


# the SG-MCMC path (workload 5): the CLI at SG_K steps a sampler (the JAX
# CLI's default k=50000, cut to fit the script's budget: 5000 until the
# image-sharding path came), the nine kernels at SG_CHAINS chains x
# SG_BATCH_STEPS steps, chains SG_PICK held to their one-chain runs over
# SG_ONE_STEPS steps
SG_K = 1000
SG_CHAINS, SG_BATCH_STEPS, SG_ONE_STEPS = 1024, 500, 100
SG_PICK = (0, SG_CHAINS - 1)
SG_PROFILE_STEPS = 100
# gates from the JAX package on the CPU (scripts/sgld_gates.py): the CLI at
# k=SG_K, seeds 0-15, each sampler's modes covered within [max(0, min -
# ceil(sd)), min(25, max + ceil(sd))] over the seeds (at this depth five bands
# start at 0 and check little more than an upper bound; SG_BATCH_REF is the
# gate that tells the samplers apart), and
# optimize_grid_mixture's modes found at its defaults within [min - ceil(sd),
# max + ceil(sd)] (the seeds move the start and the noise, which the port
# draws otherwise); SG_BATCH_REF: each kernel's per-chain modes covered over
# 256 chains x SG_BATCH_STEPS steps from the port's start, built for k=SG_K
# (the cyclical schedules' period), (mean, sd), which the port's mean over
# SG_CHAINS chains must match within SG_BATCH_Z standard errors of the
# difference.
SG_GATES = {"SGLD": (0, 8), "MSGLD": (0, 22), "cyclicalSGLD": (0, 23),
            "contourSGLD": (0, 19), "SPGLD": (4, 16), "SSGLD": (6, 16), "MYSGLD": (4, 17),
            "cyclicalSPGLD": (4, 18), "contourSPGLD": (0, 21)}
SG_OPT_GATE = (14, 23)
SG_BATCH_REF_CHAINS, SG_BATCH_Z = 256, 4.0
SG_BATCH_REF = {"SGLD": (1.45703125, 0.9107793339212519),
                "MSGLD": (6.8828125, 2.1534144114524216),
                "cyclicalSGLD": (7.50390625, 2.4301989701079467),
                "contourSGLD": (5.13671875, 4.160606499788034),
                "SPGLD": (8.4921875, 1.7034962605782031),
                "SSGLD": (9.06640625, 1.8363124747444157),
                "MYSGLD": (8.83203125, 1.687064213883012),
                "cyclicalSPGLD": (7.4453125, 1.4940855620300555),
                "contourSPGLD": (5.171875, 4.406963073297956)}
# the chain-farm path: kernel 2's farm at FARM_N^2 x FARM_CHAINS, two
# segments of FARM_STEPS / 2; the two-process ULA farm
FARM_N, FARM_CHAINS, FARM_STEPS = 64, 8, 1000
FARM_ULA_CHAINS, FARM_ULA_STEPS = 8, 100


def phase_sgmcmc(dev):
    """The SG-MCMC path: the CLI at k=SG_K with every sampler's coverage in
    its JAX band (SG_GATES), each kernel at SG_CHAINS chains through
    ``run_chains`` with chains SG_PICK against their one-chain runs bit for
    bit, and the mode finder at its defaults (SG_OPT_GATE)."""
    import numpy as np
    import torch

    from lmc_atomi_torch.core.random import chain_keys, fold_in
    from lmc_atomi_torch.experiments.sgld_runs import (
        chain_modes_covered,
        grid_setup,
        optimize_grid_mixture,
        sgld_grid_mixture,
    )
    from lmc_atomi_torch.run.runner import run_chain, run_chains

    t_phase = time.perf_counter()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        (samples, summary), wall = _timed(lambda: sgld_grid_mixture(
            k=SG_K, make_plots=False, device=str(dev)))
    rows = []
    for name, s in samples.items():
        covered, (lo, hi) = summary["modes_covered"][name], SG_GATES[name]
        if not (s.shape[0] > 0 and np.isfinite(s).all()):
            raise AssertionError(f"SG-MCMC {name}: {s.shape[0]} draws, not all finite")
        if not lo <= covered <= hi:
            raise AssertionError(f"SG-MCMC {name}: {covered} modes covered, outside [{lo}, {hi}]")
        rows.append(f"{name} {summary['iters_per_sec'][name]} iters/s, {s.shape[0]} draws, "
                    f"{covered} modes (gate [{lo}, {hi}])")
    log(f"SG-MCMC CLI (k={SG_K}, one chain a sampler, {wall:.1f} s): " + "; ".join(rows))

    _, x0, kernels = grid_setup(SG_K, 0, dev)
    rows = []
    for i, (name, kern) in enumerate(kernels.items()):
        extras = (lambda e: e.energy_idx) if name.startswith("contour") else False
        key = fold_in(0, i)
        run_chains(kern, x0, fold_in(1, i), 20, SG_CHAINS, collect_extras=extras)  # warm-up
        res, dt = _timed(lambda: run_chains(kern, x0, key, SG_BATCH_STEPS, SG_CHAINS,
                                            collect_extras=extras))
        if not bool(torch.isfinite(res.samples).all()):
            raise AssertionError(f"SG-MCMC {name}: non-finite samples in the batched run")
        keys, one_s = chain_keys(key, SG_CHAINS), 0.0
        for c in SG_PICK:
            one, dt1 = _timed(lambda: run_chain(kern, x0, keys[c], SG_ONE_STEPS,
                                                collect_extras=extras))
            one_s += dt1
            same = torch.equal(one.samples, res.samples[c, :SG_ONE_STEPS])
            if extras:
                same = same and torch.equal(one.extras, res.extras[c, :SG_ONE_STEPS])
            if not same:
                diff = float((one.samples - res.samples[c, :SG_ONE_STEPS]).abs().max())
                raise AssertionError(f"SG-MCMC {name}: chain {c} differs from its one-chain "
                                     f"run by {diff}")
        cov = chain_modes_covered(res.samples.cpu().numpy())
        ref_mean, ref_sd = SG_BATCH_REF[name]
        z = abs(float(cov.mean()) - ref_mean) / math.sqrt(
            ref_sd**2 / SG_BATCH_REF_CHAINS + float(cov.std(ddof=1))**2 / SG_CHAINS)
        if not z <= SG_BATCH_Z:
            raise AssertionError(f"SG-MCMC {name}: {cov.mean():.4f} modes a chain against the "
                                 f"JAX package's {ref_mean:.4f}, {z:.2f} standard errors")
        note = f", {cov.mean():.4f} modes a chain (JAX {ref_mean:.4f}, {z:.2f} s.e.)"
        if extras:
            mass = res.final_state.extras.energy_pdf.double().sum(-1)
            note += (f", pdf mass after {SG_BATCH_STEPS} f32 steps in "
                     f"[{float(mass.min()):.7f}, {float(mass.max()):.7f}]")
        rows.append(f"{name} {SG_CHAINS * SG_BATCH_STEPS / dt:.1f} aggregate iters/s, one "
                    f"chain {len(SG_PICK) * SG_ONE_STEPS / one_s:.1f}{note}")
    log(f"SG-MCMC kernels at {SG_CHAINS} chains x {SG_BATCH_STEPS} steps (chains {SG_PICK} "
        f"equal to their one-chain runs over {SG_ONE_STEPS} steps, bit for bit): "
        + "; ".join(rows))

    with contextlib.redirect_stdout(io.StringIO()):
        (_, _, opt), dt = _timed(lambda: optimize_grid_mixture(device=str(dev)))
    lo, hi = SG_OPT_GATE
    if not lo <= opt["modes_found"] <= hi:
        raise AssertionError(f"SG-MCMC optimize_grid_mixture: {opt['modes_found']} modes, "
                             f"outside [{lo}, {hi}]")
    log(f"SG-MCMC optimize_grid_mixture (Adam, 64 restarts x 2000 steps, {dt:.1f} s): "
        f"{opt['modes_found']} modes (gate [{lo}, {hi}]), best log-prob "
        f"{opt['best_logprob']:.6f}")
    log(f"SG-MCMC path: {time.perf_counter() - t_phase:.1f} s")


def phase_farm(dev):
    """The chain-farm path: ``run_chains_sharded`` on a one-rank NCCL mesh
    against ``run_chains``; the ``"tv"`` farm of ``run_resumable_fused``
    under ``chains_mesh``, straight and restarted, against the farm without
    a mesh; two processes on the card (gloo) against one. Every comparison
    bit for bit."""
    import tempfile

    import torch
    import torch.distributed as dist

    from lmc_atomi_torch.experiments.mixtures import gaussian_setup
    from lmc_atomi_torch.parallel import chain_mesh, merge_chain_moments, run_chains_sharded
    from lmc_atomi_torch.parallel.mesh import gather_chains
    from lmc_atomi_torch.run.longrun import run_resumable_fused
    from lmc_atomi_torch.run.runner import run_chains

    def equal(label, pairs):
        for field, a, b in pairs:
            if not torch.equal(a, b):
                raise AssertionError(f"farm {label}: {field} differs")

    t_phase = time.perf_counter()
    mesh = chain_mesh()
    if dist.get_backend() != "nccl" or mesh.device_type != "cuda":
        raise AssertionError(f"chain_mesh() on the card: backend {dist.get_backend()}")
    _, _, x0, kernels = gaussian_setup(5, 0, dev)
    ula = kernels["ULA"]
    # one untimed sharded run first: NCCL sets up its communicator at the
    # first collective
    run_chains_sharded(ula, x0, (4, 0), 20, MIX_CHAINS, mesh=mesh, collect="both")
    want, dt0 = _timed(lambda: run_chains(ula, x0, (5, 0), 200, MIX_CHAINS, collect="both"))
    got, dt1 = _timed(lambda: run_chains_sharded(ula, x0, (5, 0), 200, MIX_CHAINS, mesh=mesh,
                                                 collect="both"))
    _, dt_gather = _timed(lambda: gather_chains(want, mesh))
    equal("run_chains_sharded", [("samples", got.samples, want.samples),
                                 ("position", got.final_state.position,
                                  want.final_state.position),
                                 ("mean", got.moments.mean, want.moments.mean),
                                 ("m2", got.moments.m2, want.moments.m2),
                                 ("count", got.moments.count, want.moments.count)])
    log(f"farm: run_chains_sharded of ULA on a one-rank NCCL chain_mesh, {MIX_CHAINS} chains "
        f"x 200 steps ({dt1:.3f} s after an untimed run, run_chains {dt0:.3f} s, the gather "
        f"of a run_chains result alone {dt_gather:.3f} s): equal to run_chains bit for bit")

    _, y, terms = make_large(dev, FARM_N)
    gamma = SIGMA_NOISE**2
    args = (terms["tv"], TV_WEIGHT, 0.2 * gamma, gamma, _chain_starts(y, FARM_CHAINS), (24, 0))
    kw = dict(runner="tv", burn_in=100, quantiles=(0.025, 0.975))
    seg = FARM_STEPS // 2
    plain, dt0 = _timed(lambda: run_resumable_fused(*args, FARM_STEPS, seg, **kw))
    meshed, dt1 = _timed(lambda: run_resumable_fused(*args, FARM_STEPS, seg, chains_mesh=mesh,
                                                     **kw))
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "farm.ckpt")
        run_resumable_fused(*args, seg, seg, ckpt_path=ckpt, chains_mesh=mesh, **kw)
        resumed = run_resumable_fused(*args, FARM_STEPS, seg, ckpt_path=ckpt, chains_mesh=mesh,
                                      **kw)
    for label, b in (("straight", meshed), ("resumed", resumed)):
        equal(f"tv {label}", [("position", b["position"], plain["position"]),
                              ("mean", b["moments"].mean, plain["moments"].mean),
                              ("m2", b["moments"].m2, plain["moments"].m2),
                              ("count", b["moments"].count, plain["moments"].count),
                              ("markers", b["quantile_state"][0], plain["quantile_state"][0])])
    dist.destroy_process_group()
    log(f"farm: run_resumable_fused(runner='tv', chains_mesh=chain_mesh()) {FARM_N}^2 x "
        f"{FARM_CHAINS} chains x {FARM_STEPS} steps in segments of {seg} ({dt1:.3f} s, "
        f"without the mesh {dt0:.3f} s), straight and restarted from its checkpoint: "
        "positions, moments and CI markers equal to the farm without a mesh bit for bit")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--farm-rank",
                                   str(r), str(Path(tmp) / "store"), tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, (_, e) in zip(procs, outs):
            if p.returncode != 0:
                raise AssertionError(f"farm worker exited {p.returncode}: {e[-2000:]}")
        two = torch.load(Path(tmp) / "farm.pt")
    dt2 = time.perf_counter() - t0
    res = run_chains(ula, x0, (6, 0), FARM_ULA_STEPS, FARM_ULA_CHAINS, collect="stats")
    one = merge_chain_moments(res.moments)
    if two["count"] != one.count:
        raise AssertionError(f"farm two processes: count {two['count']} != {one.count}")
    equal("two processes", [("pooled mean", two["mean"], one.mean.cpu()),
                            ("pooled m2", two["m2"], one.m2.cpu()),
                            ("chain means", two["chain_mean"], res.moments.mean.cpu())])
    log(f"farm: global_chain_farm of ULA over two processes on the card (gloo, world size 2), "
        f"{FARM_ULA_CHAINS} chains x {FARM_ULA_STEPS} steps ({dt2:.1f} s with the processes' "
        "start): rank 0's pooled moments equal the one-process farm's bit for bit")
    log(f"farm path: {time.perf_counter() - t_phase:.1f} s")


def farm_worker(rank: int, store: str, out_dir: str) -> None:
    """One rank of the chain-farm path's two-process run: a gloo group of
    two on a ``FileStore``, ``global_chain_farm`` of the Gaussian mixture's
    ULA on the card; rank 0 saves the pooled and per-chain moments."""
    import torch
    import torch.distributed as dist

    from lmc_atomi_torch.experiments.mixtures import gaussian_setup
    from lmc_atomi_torch.parallel import global_chain_farm, init_multihost

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_multihost(world_size=2, rank=rank, store=dist.FileStore(store, 2))
    _, _, x0, kernels = gaussian_setup(5, 0, dev)
    res, pooled = global_chain_farm(kernels["ULA"], x0, (6, 0), FARM_ULA_STEPS,
                                    FARM_ULA_CHAINS, collect="stats")
    if rank == 0:
        torch.save({"count": pooled.count, "mean": pooled.mean.cpu(), "m2": pooled.m2.cpu(),
                    "chain_mean": res.moments.mean.cpu()}, Path(out_dir) / "farm.pt")
    dist.barrier()
    dist.destroy_process_group()


# the image-sharding path: the main problem over IMAGE_RANKS processes on the
# one card (gloo), each mesh of IMAGE_MESHES; IMAGE_STEPS steps of the
# sharded chain after IMAGE_WARM untimed ones, and the sharded blur products
# within IMAGE_BLUR_TOL of the largest one-device value (f32: the transposed
# FFT's 1-D passes round otherwise than cuFFT's 2-D plan)
IMAGE_RANKS = 4
IMAGE_MESHES = ((1, 4, 1), (1, 2, 2))
IMAGE_STEPS, IMAGE_WARM = 50, 2
IMAGE_KEY = 31
IMAGE_BLUR_TOL = 1e-5


def phase_image(dev):
    """The image-sharding path: IMAGE_RANKS processes on the card (gloo on
    a ``FileStore``, ``--image-rank``) split the main problem over each mesh
    of IMAGE_MESHES (``image_mesh(device="cuda")``, ``shard_image``); each
    rank holds its band prox (kernel 1 on its halo-extended block) and noise
    block to the one-device results bit for bit and its blocks of the four
    sharded ``CirculantBlur2D`` products within IMAGE_BLUR_TOL, and rank 0
    gathers the moments of IMAGE_STEPS steps of the sharded
    ``run_chain(myula_imaging)``, held here to one process's chain on the
    same key within REL_TOL. Returns the workers' kernel-1 launches."""
    import tempfile

    import torch

    from lmc_atomi_torch.kernels.imaging import myula_imaging
    from lmc_atomi_torch.ops.functionals import TVNorm
    from lmc_atomi_torch.run.runner import run_chain

    t_phase, t_spawn = time.perf_counter(), time.time()
    with tempfile.TemporaryDirectory() as tmp:
        # -X faulthandler: a worker that dies on a signal prints its stack
        procs = [subprocess.Popen([sys.executable, "-X", "faulthandler",
                                   str(Path(__file__).resolve()), "--image-rank", str(r),
                                   str(Path(tmp) / "store"), tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(IMAGE_RANKS)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [f"rank {r} exited {p.returncode}: "
                  + "\n".join([ln for ln in e.splitlines() if ln.startswith("  File")][:12])
                  + e[-1500:] for r, (p, (_, e)) in enumerate(zip(procs, outs))
                  if p.returncode != 0]
        if failed:
            raise AssertionError("image workers failed: " + "\n".join(failed))
        reports = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                   for r in range(IMAGE_RANKS)]
        gathered = {m: torch.load(Path(tmp) / f"chain{m}.pt") for m in reports[0]["meshes"]}
    t_workers = time.perf_counter() - t_phase

    img, y, l2 = make_problem(dev)
    gamma = SIGMA_NOISE**2
    kern = myula_imaging(l2, TVNorm(sigma=TV_WEIGHT, niter=10), tau=0.2 * gamma, gamma=gamma)
    x0 = torch.zeros((N, N), device=dev)
    run_chain(kern, x0, IMAGE_KEY + 1, IMAGE_WARM, collect="stats")
    one, dt_one = _timed(lambda: run_chain(kern, x0, IMAGE_KEY, IMAGE_STEPS, collect="stats"))
    launches = 0
    for m, got in gathered.items():
        ranks = [r["meshes"][m] for r in reports]
        for r, rep in enumerate(ranks):
            if not (rep["prox_equal"] and rep["noise_equal"]):
                raise AssertionError(f"image {m} rank {r}: band prox equal {rep['prox_equal']}, "
                                     f"noise block equal {rep['noise_equal']}")
            if rep["launches"] < 1:
                raise AssertionError(f"image {m} rank {r}: kernel 1 was not launched")
            launches += rep["launches"]
        blur = {op: max(rep["blur"][op] for rep in ranks) for op in ranks[0]["blur"]}
        for op, (err, tol) in blur.items():
            if not err <= tol:
                raise AssertionError(f"image {m} {op}: {err} > {tol}")
        worst, note = compare(f"image {m} chain", [got[f].to(dev) for f in
                                                   ("mean", "m2", "position")],
                              [one.moments.mean, one.moments.m2, one.final_state.position],
                              ("mean", "m2", "position"))
        if not bool(torch.isfinite(got["mean"]).all()):
            raise AssertionError(f"image {m}: non-finite sharded mean")
        log(f"image {m} ({IMAGE_RANKS} processes, gloo): band prox and noise blocks equal "
            "the one-device results bit for bit on every rank; kernel 1 launches and routes "
            "by rank " + "; ".join(f"{r}: {rep['launches']} {rep['routes']} blocks "
                                   f"{rep['ext_shape']}" for r, rep in enumerate(ranks))
            + "; blur products max err/tol " + " ".join(
                f"{op}={e:.3e}/{t:.1e}" for op, (e, t) in blur.items())
            + f"; {IMAGE_STEPS}-step sharded chain against one process's: {note}; sharded "
            f"step {ranks[0]['step_ms']:.3f} ms (rank 0's host clock, {IMAGE_STEPS} steps "
            f"after {IMAGE_WARM}), one process {dt_one / IMAGE_STEPS * 1e3:.3f} ms")
    stages = {k: max(r["stamps"][k] for r in reports) - t_spawn for k in reports[0]["stamps"]}
    log(f"image path: {time.perf_counter() - t_phase:.1f} s ({t_workers:.1f} s the "
        "workers with their start; the last rank past each stage at "
        + ", ".join(f"{k} {v:.1f} s" for k, v in stages.items()) + ")")
    return {"prox_tv_iso_cuda": launches}


def image_worker(rank: int, store: str, out_dir: str) -> None:
    """One rank of the image-sharding path: a gloo group of IMAGE_RANKS on
    a ``FileStore``, every image on the card. For each mesh of
    IMAGE_MESHES: the one-device references first (kernel 1 on the whole
    image, the noise field, the blur products; launches not counted), then
    the sharded path with the launch counts at 0: the band prox, the noise
    block, the four products, IMAGE_WARM + IMAGE_STEPS steps of the chain.
    Writes ``rank{rank}.json``; rank 0 also the gathered moments."""
    import torch
    import torch.distributed as dist

    from lmc_atomi_torch.core.random import normal_field
    from lmc_atomi_torch.kernels.imaging import myula_imaging
    from lmc_atomi_torch.ops.functionals import TVNorm
    from lmc_atomi_torch.ops.tv import prox_tv_iso
    from lmc_atomi_torch.ops.tv_cuda import prox_tv_iso_cuda
    from lmc_atomi_torch.parallel import image_mesh, shard_image
    from lmc_atomi_torch.ops.sharded import block_grid, halo, normal_block
    from lmc_atomi_torch.parallel.image import gather_image
    from lmc_atomi_torch.run.runner import run_chain

    stamps = {"imports": time.time()}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, IMAGE_RANKS), rank=rank,
                            world_size=IMAGE_RANKS)
    stamps["group"] = time.time()
    img, y, l2 = make_problem(dev)
    blur = l2.op
    gamma = SIGMA_NOISE**2
    kern = myula_imaging(l2, TVNorm(sigma=TV_WEIGHT, niter=10), tau=0.2 * gamma, gamma=gamma)
    b = 0.5 * y + 0.1
    ops = {"matvec": (blur.matvec, (img,)), "rmatvec": (blur.rmatvec, (img,)),
           "normal_grad": (blur.normal_grad, (img, b)),
           "gram_solve": (lambda v: blur.gram_solve(0.2 * gamma / SIGMA_NOISE**2, v), (img,))}
    whole_prox = prox_tv_iso_cuda(y, TV_WEIGHT * gamma, niter=10)
    whole_noise = normal_field(IMAGE_KEY, 0, 3, (N, N), torch.float32, dev)
    whole_ops = {k: fn(*args) for k, (fn, args) in ops.items()}
    x0 = torch.zeros((N, N), device=dev)
    torch.cuda.synchronize()
    stamps["references"] = time.time()
    report = {"rank": rank, "meshes": {}, "stamps": stamps}
    for shape in IMAGE_MESHES:
        name = "x".join(map(str, shape))
        mesh = image_mesh(*shape, device="cuda")
        stamps[f"mesh {name}"] = time.time()
        if mesh.device_type != "cuda" or dist.get_backend() != "gloo":
            raise AssertionError(f"image_mesh on the card: {mesh.device_type}, "
                                 f"{dist.get_backend()}")
        prox_tv_iso_cuda.launches = 0
        prox_tv_iso_cuda.routes = dict.fromkeys(prox_tv_iso_cuda.routes, 0)
        ys = shard_image(y, mesh)
        grid = block_grid(ys)
        (y0, x0_), (by, bx) = grid.origin, grid.block
        here = (slice(y0, y0 + by), slice(x0_, x0_ + bx))
        stamps[f"shard {name}"] = time.time()
        band = prox_tv_iso(ys, TV_WEIGHT * gamma, 10)
        torch.cuda.synchronize()
        stamps[f"prox {name}"] = time.time()
        if not band.to_local().is_cuda:
            raise AssertionError("the band prox left the card")
        rep = {"prox_equal": torch.equal(band.to_local(), whole_prox[here]),
               "noise_equal": torch.equal(normal_block(IMAGE_KEY, 0, 3, ys).to_local(),
                                          whole_noise[here]),
               "ext_shape": list(halo(ys.to_local(), 11, mesh).shape), "blur": {}}
        for k, (fn, args) in ops.items():
            got = fn(*(shard_image(a, mesh) for a in args)).to_local()
            want = whole_ops[k]
            rep["blur"][k] = (float((got - want[here]).abs().max()),
                              IMAGE_BLUR_TOL * max(1.0, float(want.abs().max())))
        torch.cuda.synchronize()
        stamps[f"products {name}"] = time.time()
        xs0 = shard_image(x0, mesh)
        run_chain(kern, xs0, IMAGE_KEY + 1, IMAGE_WARM, collect="stats")
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_chain(kern, xs0, IMAGE_KEY, IMAGE_STEPS, collect="stats")
        torch.cuda.synchronize()
        rep["step_ms"] = (time.perf_counter() - t0) / IMAGE_STEPS * 1e3
        rep["launches"] = prox_tv_iso_cuda.launches
        rep["routes"] = {k: v for k, v in prox_tv_iso_cuda.routes.items() if v}
        whole = {"mean": gather_image(res.moments.mean), "m2": gather_image(res.moments.m2),
                 "position": gather_image(res.final_state.position)}
        if rank == 0:
            torch.save({k: v.cpu() for k, v in whole.items()}, Path(out_dir) / f"chain{name}.pt")
        report["meshes"][name] = rep
        stamps[f"done {name}"] = time.time()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(report))
    dist.barrier()
    dist.destroy_process_group()


def phase_profile_sgmcmc(dev):
    """Where the time goes in one batched SGLD and one CSGLD block on the
    grid mixture (SG_CHAINS chains x SG_PROFILE_STEPS steps, one step over
    all chains; CSGLD's pdf is 100000 bins a chain), and the launches a
    step."""
    from lmc_atomi_torch.experiments.sgld_runs import grid_setup
    from lmc_atomi_torch.run.runner import run_chains

    _, x0, kernels = grid_setup(SG_K, 0, dev)
    for name in ("SGLD", "contourSGLD"):
        got = profile_window(
            f"run_chains {name} {SG_CHAINS} chains x {SG_PROFILE_STEPS} steps (grid mixture)",
            lambda: run_chains(kernels[name], x0, (7, 0), SG_PROFILE_STEPS, SG_CHAINS))
        log(f"profile {name}: {sum(n for _, n in got.values()) / SG_PROFILE_STEPS:.1f} "
            "kernel launches a step")


def phase_profile_mixtures(dev):
    """Where the time goes in one batched ULA block of the Gaussian-mixture
    workload: 1024 chains x 100 steps, one step over all chains."""
    from lmc_atomi_torch.experiments.mixtures import gaussian_setup
    from lmc_atomi_torch.run.runner import run_chains

    _, _, x0, kernels = gaussian_setup(5, 0, dev)
    profile_window(f"run_chains ULA {MIX_CHAINS} chains x {MIX_PROFILE_STEPS} steps (Gaussian "
                   "mixture, n=5)",
                   lambda: run_chains(kernels["ULA"], x0, (4, 0), MIX_PROFILE_STEPS, MIX_CHAINS))


def phase_profile_multichain(dev):
    """Where the time goes in one packed 500-step block at 64^2 x 64 chains
    (kernel 2's chain axis)."""
    import torch

    from lmc_atomi_torch.core.random import chain_keys
    from lmc_atomi_torch.kernels.myula_fused import run_myula_tv_fused_packed

    _, y, terms = make_large(dev, MC_N)
    n_chains = MC_UQ["n_chains"]
    x0 = torch.zeros((n_chains, MC_N, MC_N), device=dev)
    gamma = SIGMA_NOISE**2
    profile_window(f"run_myula_tv_fused_packed cold10 {n_chains} x {MC_N}^2 {BLOCK} steps",
                   lambda: run_myula_tv_fused_packed(terms["tv"], TV_WEIGHT, 0.2 * gamma,
                                                     gamma, x0, (3, 0), BLOCK, block=BLOCK))


# the PnP path (experiments/pnp.py, BASELINE.json config 5): the CLI at its
# defaults (256^2 phantom, 8 chains x 2000 steps, DnCNN depth 8 width 48 with
# spectral cap 1.1 and 1500 training steps, the TV anchor through kernel 2
# with P^2 credible intervals) with the score baseline on a ScoreUNet; cut
# from 2000 steps to 500 (burn-in 200) to make room for the PnP farm path,
# which runs the farm's script at this width (config 5's 2000 steps ran on
# the card through scripts/expt_pnp1024_torch.py:
# assets/torch/results_pnp1024.json)
PNP_RUN = dict(score_baseline=True, score_arch="unet", n_steps=500)
# the gates' configuration (scripts/pnp_gates.py: JAX on the CPU, seeds 0-3)
# and its PSNR gates [min - 1 dB, max + 1 dB] over the seeds, per prior
PNP_GATE_RUN = dict(size=128, n_chains=4, n_steps=600, train_steps=400,
                    score_train_steps=400, tv_baseline=True, score_baseline=True,
                    score_arch="unet")
PNP_GATES = {"psnr_posterior_mean": (21.5121, 24.2626),
             "psnr_tv_baseline_mean": (12.2885, 14.3917),
             "psnr_score_mean": (24.9475, 29.3109)}
PNP_SIZE, PNP_CHAINS, PNP_SIGMA, PNP_DEN_SIGMA = 256, 8, 0.03, 0.05
PNP_TV_WEIGHT = 2.0
PNP_HELD = (0, PNP_CHAINS - 1)  # chains held to their one-chain runs
PNP_HELD_STEPS = 100
# a chain of a block against its run alone: the nets' convolutions may sum
# in another order for another batch size (cuDNN picks its algorithm by shape)
PNP_CHAIN_TOL = 1e-4
# the card's operator norms (models/dncnn.py::_power_sigma) against LAPACK's
# on the host, relative: the estimate's bound at any gap (3e-6) and float32
PNP_SPECTRAL_TOL = 1e-5
PNP_REFIT_STEPS = 100  # two fits of each net from one seed, held equal
PNP_PROFILE_STEPS = 20
# load_image's photographs: (side, mean, std) of tests/test_png.py
PNP_IMAGES = {"einstein": (512, 123.31, 48.54), "hopper": (512, 81.39, 70.36),
              "mri": (256, 45.84, 65.84)}
# the PnP farm path: config 5's farm script at the CLI's width, cut to 2
# blocks of 4 chains x 100 steps; its pooled moments against one in-process
# call over the same chains, relative to the largest value: both pool in
# float64 and differ only in the order of the merges
PNP_FARM = dict(n_blocks=2, block_chains=4, n_steps=100, burn_in=20)
PNP_FARM_TOL = 1e-10


def phase_kernel2_pnp(dev, report):
    """Kernel 2 on the PnP TV anchor's problem (cold-10, 95% CI markers)
    against its plain version, bit for bit, on the resident route, at both
    sizes the PnP path gives it: the CLI's 256^2 and the gates' 128^2."""
    from lmc_atomi_torch.experiments.pnp import deblur_problem
    from lmc_atomi_torch.kernels.myula_fused import (
        myula_tv_block_update_cuda,
        myula_tv_block_update_ref,
    )

    k2 = myula_tv_block_update_cuda
    terms = (0.2 * PNP_SIGMA**2, PNP_SIGMA**2, PNP_TV_WEIGHT)
    cfg = dict(niter_tv=10, quantiles=(0.025, 0.975), burn_in=10)
    for n in (PNP_SIZE, PNP_GATE_RUN["size"]):
        _, _, y, l2 = deblur_problem(n, PNP_SIGMA, 5, (0, 1), dev)
        got, routes = routes_of(lambda: _run_blocks(k2, l2, y, CHECK_STEPS, CHECK_BLOCK, cfg,
                                                    seed=7, terms=terms), k2)
        want = _run_blocks(myula_tv_block_update_ref, l2, y, CHECK_STEPS, CHECK_BLOCK, cfg,
                           seed=7, terms=terms)
        err, parts = compare(f"kernel 2 (PnP anchor {n}^2)", got, want,
                             ("x", "mean", "m2", "qh", "qn"), exact=True)
        log(f"kernel2 PnP anchor {n}^2 cold10 + CI {CHECK_STEPS} steps, noise on: routes "
            f"{routes} plan {k2.last_plan}; max_abs_err {parts}")
        if routes["sequence"] or not routes["resident"]:
            raise AssertionError(f"kernel 2 left the resident route at {n}^2: {routes}")
        report["myula_tv_block_update_cuda"]["max_abs_err"] = max(
            err, report["myula_tv_block_update_cuda"]["max_abs_err"])


def phase_pnp(dev, params):
    """The PnP path through its entry point: ``pnp_ula_deblur`` at the CLI's
    defaults with the score baseline (ScoreUNet) and at the gates'
    configuration, each prior's posterior-mean PSNR gated (above the
    observation's; within PNP_GATES at the gates' configuration), the
    Lipschitz bound at most 1.1^8 and the measured constant within it, the
    moments finite; chains 0 and 7 of a block against their runs alone
    (PNP_CHAIN_TOL), the fitted DnCNN's operator norms on the card against
    LAPACK's on the host (PNP_SPECTRAL_TOL, and within the cap), two fits
    of each net from one seed equal, and ``load_image``'s photographs. The
    DnCNN the CLI fits is saved at ``params`` for the farm path."""
    import numpy as np
    import torch

    from lmc_atomi_torch.core.checkpoint import restore_checkpoint
    from lmc_atomi_torch.core.random import chain_keys
    from lmc_atomi_torch.experiments.pnp import deblur_problem, pnp_ula_deblur
    from lmc_atomi_torch.kernels.imaging import pnp_ula
    from lmc_atomi_torch.models import dncnn
    from lmc_atomi_torch.models.score import train_score_net
    from lmc_atomi_torch.run.runner import run_chain, run_chains
    from lmc_atomi_torch.utils.images import load_image

    smi = nvidia_smi("name,power.limit")
    log(f"pnp [{smi}]: the nets' convolutions in "
        f"{'TF32' if dncnn.NET_TF32 else 'IEEE float32'} (cuDNN allow_tf32={dncnn.NET_TF32}, "
        "no autotuning, deterministic algorithms)")
    for name, (n, mean, std) in PNP_IMAGES.items():
        img = load_image(name, n)
        if img.shape != (n, n) or abs(img.mean() - mean) > 1.0 or abs(img.std() - std) > 1.0:
            raise AssertionError(f"load_image({name!r}): {img.shape} mean {img.mean()} "
                                 f"std {img.std()}")
    log(f"pnp: load_image einstein, hopper, mri at their shapes, means and stds")

    def run(tag, **kw):
        out, err = io.StringIO(), io.StringIO()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            mean, std, rep = pnp_ula_deblur(device=str(dev), make_plots=False, **kw)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        if {k: line[k] for k in rep} != rep:
            raise AssertionError(f"pnp {tag}: the JSON line differs from the report")
        if not (np.isfinite(mean).all() and np.isfinite(std).all()):
            raise AssertionError(f"pnp {tag}: non-finite posterior moments")
        log(f"pnp {tag} [{smi}]: {wall:.1f} s, peak {peak:.2f} GiB; psnr blurred "
            f"{rep['psnr_blurred']:.4f}, PnP {rep['psnr_posterior_mean']:.4f}, TV anchor "
            f"{rep['psnr_tv_baseline_mean']:.4f}, score {rep['psnr_score_mean']:.4f} dB; "
            f"95% CI width PnP {rep['mean_ci_width']:.4f}, TV {rep['tv_baseline_ci_width']:.4f}, "
            f"score {rep['score_ci_width']:.4f}; chain-steps/s PnP "
            f"{rep['chain_steps_per_sec']}, score {rep['score_steps_per_sec']} (with its "
            f"training), TV anchor steps/s {rep['tv_baseline_steps_per_sec']}; training "
            f"DnCNN {rep['train_seconds']:.2f} s, score net {rep['score_train_seconds']:.2f} s; "
            f"Lipschitz certified {rep['lipschitz_certified_bound']:.4f}, measured "
            f"{rep['lipschitz_measured']:.4f}")
        if not rep["psnr_posterior_mean"] > rep["psnr_blurred"]:
            raise AssertionError(f"pnp {tag}: posterior mean below the observation")
        bound = rep["lipschitz_certified_bound"]
        if not (bound <= 1.1**8 * (1 + 1e-5) and rep["lipschitz_measured"] <= bound):
            raise AssertionError(f"pnp {tag}: Lipschitz {rep['lipschitz_measured']} / {bound}")
        return rep

    run("CLI defaults", params_path=params, **PNP_RUN)
    model = dncnn.DnCNN(8, 48).to(dev)
    model.load_state_dict(restore_checkpoint(params, model.state_dict()))
    rep = run("gates' configuration", seed=0, **PNP_GATE_RUN)
    for key, (lo, hi) in PNP_GATES.items():
        if not lo <= rep[key] <= hi:
            raise AssertionError(f"pnp {key}: {rep[key]:.4f} outside the JAX gate [{lo}, {hi}]")

    # a block of chains (one net call a step) against its chains run alone
    _, _, y, l2 = deblur_problem(PNP_SIZE, PNP_SIGMA, 5, (0, 1), dev)
    tau = 0.5 / (1.0 / PNP_SIGMA**2 + 1.0 / PNP_DEN_SIGMA**2)
    kern = pnp_ula(l2.grad, dncnn.make_denoiser(model.eval()), tau, eps=PNP_DEN_SIGMA**2,
                   box=(-1.0, 2.0))
    key = (3, 0)
    block = run_chains(kern, y, key, PNP_HELD_STEPS, PNP_CHAINS, collect="last")
    keys = chain_keys(key, PNP_CHAINS)
    errs = {c: float((block.final_state.position[c] - run_chain(
        kern, y, keys[c], PNP_HELD_STEPS, collect="last").final_state.position).abs().max())
        for c in PNP_HELD}
    log(f"pnp: chains {PNP_HELD} of {PNP_CHAINS} against their runs alone over "
        f"{PNP_HELD_STEPS} steps: max abs error {errs} (tolerance {PNP_CHAIN_TOL})")
    if not all(np.isfinite(v) and v <= PNP_CHAIN_TOL for v in errs.values()):
        raise AssertionError(f"pnp: a chain of the block differs from its run alone: {errs}")

    # the fitted net's operator norms: the card's estimate (every projection
    # of the fit, the certified bound) against LAPACK's SVDs on the host
    ws, card = dncnn._layer_sigmas(model, 32)
    card = torch.stack(card).cpu().double()
    lapack = torch.stack([dncnn._transfer_sigma(w.detach().cpu().double()) for w in ws])
    rel = float(((card - lapack).abs() / lapack).max())
    log(f"pnp: the fitted DnCNN's operator norms on the card against LAPACK's: max relative "
        f"error {rel:.3e} (tolerance {PNP_SPECTRAL_TOL}); LAPACK's largest "
        f"{float(lapack.max()):.7f} (cap 1.1)")
    if not (rel <= PNP_SPECTRAL_TOL and float(lapack.max()) <= 1.1 * (1 + PNP_SPECTRAL_TOL)):
        raise AssertionError(f"pnp: the card's operator norms {card.tolist()} against "
                             f"LAPACK's {lapack.tolist()}")

    # a fit is reproducible from its seed (deterministic cuDNN, one graph)
    def same(a, b):
        return all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))

    fits = [dncnn.train_denoiser((8, 0), noise_sigma=PNP_DEN_SIGMA, steps=PNP_REFIT_STEPS,
                                 depth=8, features=48, spectral_norm=1.1, device=dev)
            for _ in range(2)]
    nets = [train_score_net((9, 0), sigma_max=0.4, sigma_min=PNP_DEN_SIGMA, n_sigmas=8,
                            steps=PNP_REFIT_STEPS, arch="unet", device=dev)[0]
            for _ in range(2)]
    if not (same(*fits) and same(*nets)):
        raise AssertionError("pnp: two fits from one seed differ")
    log(f"pnp: two fits of {PNP_REFIT_STEPS} steps from one seed equal (DnCNN depth 8 width "
        "48 with its projections, ScoreUNet)")


def phase_pnp_farm(dev, params):
    """Config 5's farm through its script, ``scripts/expt_pnp1024_torch.py``
    (its ``farm``, in this process), at the CLI's width with the DnCNN at
    ``params``: PNP_FARM's blocks each a process of its own, pooled by
    ``pnp_merge``; the pooled mean and M2 against one in-process
    ``pnp_ula_deblur`` over the same chains in blocks of the same size
    (PNP_FARM_TOL relative to the largest value), the draws, the report's
    device and the Lipschitz bound."""
    import importlib.util
    import tempfile

    import numpy as np

    from lmc_atomi_torch.experiments.pnp import pnp_ula_deblur

    t_phase = time.perf_counter()
    smi = nvidia_smi("name,power.limit")
    spec = importlib.util.spec_from_file_location(
        "expt_pnp1024_torch", ROOT / "scripts" / "expt_pnp1024_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    n_chains = PNP_FARM["n_blocks"] * PNP_FARM["block_chains"]
    draws = n_chains * (PNP_FARM["n_steps"] - PNP_FARM["burn_in"])
    with tempfile.TemporaryDirectory() as tmp:
        out, one = Path(tmp) / "farm", Path(tmp) / "one.npz"
        err = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
                rep = script.farm(outdir=str(out), params_path=params, report="",
                                  size=PNP_SIZE, depth=8, features=48, device=str(dev),
                                  **PNP_FARM)
        except SystemExit as e:
            raise AssertionError(f"pnp farm: {e}: {err.getvalue()[-4000:]}") from None
        farm_s = time.perf_counter() - t0
        if (rep["n_blocks"], rep["n_chains"], rep["n_chain_draws"]) != (
                PNP_FARM["n_blocks"], n_chains, draws) or rep["device"] != smi:
            raise AssertionError(f"pnp farm: the report {rep}")
        if not rep["lipschitz_certified_bound"] <= 1.1**8 * (1 + 1e-5):
            raise AssertionError(f"pnp farm: Lipschitz {rep['lipschitz_certified_bound']}")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            pnp_ula_deblur(size=PNP_SIZE, n_chains=n_chains, chain_block=PNP_FARM["block_chains"],
                           n_steps=PNP_FARM["n_steps"], burn_in=PNP_FARM["burn_in"],
                           params_path=params, moments_out=str(one), device=str(dev))
        one_s = time.perf_counter() - t0
        with np.load(out / "pnp_1024_final.npz") as got, np.load(one) as want:
            counts = int(got["count"]), int(want["count"])
            errs = {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
                    for k in ("mean", "m2")}
    log(f"pnp farm [{smi}]: {PNP_FARM['n_blocks']} blocks x {PNP_FARM['block_chains']} chains x "
        f"{PNP_FARM['n_steps']} steps at {PNP_SIZE}^2 through the script, {farm_s:.1f} s (blocks "
        f"{[round(b, 1) for b in rep['block_seconds']]} s, {rep['chain_steps_per_sec']:.1f} "
        f"chain-steps/s over the blocks' processes); pooled PSNR "
        f"{rep['psnr_posterior_mean']:.4f} dB, 95% CI width {rep['mean_ci_width']:.4f}, draws "
        f"{rep['n_chain_draws']}; against one in-process call ({one_s:.1f} s): counts {counts}, "
        f"max relative error {errs} (tolerance {PNP_FARM_TOL})")
    if counts != (draws, draws) or not all(e <= PNP_FARM_TOL for e in errs.values()):
        raise AssertionError(f"pnp farm: the farm's moments differ from one call's: {errs}")
    log(f"PnP farm path: {time.perf_counter() - t_phase:.1f} s")


# RESULTS.md's denoise row (noisy obs, posterior mean); the port's noise
# differs, so the mean is gated at it less DECONV_MARGIN
RESULTS_DENOISE_REF = (11.79, 14.09)


def phase_results(dev):
    """The results generator's ``main`` on the card for its denoise and PnP
    sections, into a temporary directory: each section's file and the
    assembled tables, the denoise row gated, nothing under ``assets/``
    written."""
    import importlib.util
    import tempfile

    t_phase = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "make_results_torch", ROOT / "scripts" / "make_results_torch.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assets = ROOT / "assets" / "torch"
    before = {p.name: p.stat().st_mtime_ns for p in assets.iterdir()}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "RESULTS.md"
        with contextlib.redirect_stdout(io.StringIO()):
            done = script.main(sections="denoise,pnp", out=str(out), device=str(dev),
                               pnp_pattern=str(Path(tmp) / "no_block_*.npz"))
        text = out.read_text()
        kept = sorted(p.name for p in (Path(tmp) / "results_sections").iterdir())
    lines = text.splitlines()
    head = "| noisy obs | posterior mean | iters/s |"
    row = lines[lines.index(head) + 2] if head in lines else None
    pnp_rows = [ln for ln in lines if ln.startswith(("| posterior-mean PSNR",
                                                     "| mean 95% CI width",
                                                     "| max posterior std"))]
    log(f"results path: sections {done}, files {kept}; denoise {row}; PnP {pnp_rows}")
    if done != ["denoise", "pnp"] or kept != ["denoise.json", "denoise.md", "pnp.json",
                                              "pnp.md"]:
        raise AssertionError(f"results: sections {done}, files {kept}")
    if row is None or len(pnp_rows) != 3 or (
            "Device: `" + nvidia_smi("name,power.limit") + "`") not in text:
        raise AssertionError(f"results: the tables are incomplete:\n{text}")
    noisy, mean, ips = (float(v) for v in row.strip("| ").split(" | "))
    if not (mean >= RESULTS_DENOISE_REF[1] - DECONV_MARGIN and mean > noisy and ips > 0):
        raise AssertionError(f"results: denoise row {row} (gate "
                             f"{RESULTS_DENOISE_REF[1] - DECONV_MARGIN:.2f} dB)")
    if {p.name: p.stat().st_mtime_ns for p in assets.iterdir()} != before:
        raise AssertionError("results: the path wrote under assets/torch/")
    log(f"results path: {time.perf_counter() - t_phase:.1f} s")


def phase_profile_pnp(dev):
    """Where the time goes in PnP-ULA steps: 8 chains at 256^2, one DnCNN
    call (depth 8, width 48) a step."""
    from lmc_atomi_torch.experiments.pnp import deblur_problem
    from lmc_atomi_torch.kernels.imaging import pnp_ula
    from lmc_atomi_torch.models import dncnn
    from lmc_atomi_torch.run.runner import run_chains

    _, _, y, l2 = deblur_problem(PNP_SIZE, PNP_SIGMA, 5, (0, 1), dev)
    model = dncnn.lecun_init(dncnn.DnCNN(8, 48).to(dev), (6, 0)).eval()
    tau = 0.5 / (1.0 / PNP_SIGMA**2 + 1.0 / PNP_DEN_SIGMA**2)
    kern = pnp_ula(l2.grad, dncnn.make_denoiser(model), tau, eps=PNP_DEN_SIGMA**2,
                   box=(-1.0, 2.0))
    profile_window(f"run_chains PnP-ULA {PNP_CHAINS} x {PNP_SIZE}^2 x {PNP_PROFILE_STEPS} steps "
                   f"[{nvidia_smi('name,power.limit')}]",
                   lambda: run_chains(kern, y, (4, 0), PNP_PROFILE_STEPS, PNP_CHAINS,
                                      collect="stats"))


# --- the CT path (experiments/ct.py) ---------------------------------------
# RESULTS.md:283, the 128^2 / 30-angle row: the CLI's defaults (the JAX
# package's run of them on the CPU gives 12.36 / 14.44 / 18.90 / 18.67 /
# 20.30), each gated at the JAX value less CT_MARGIN
CT_REF = {"psnr_backprojection": 12.36, "psnr_fbp": 14.44, "psnr_posterior_mean": 18.90,
          "psnr_map_tv": 18.67, "psnr_pnp_mean": 20.39}
CT_MARGIN = 1.0
CT_DEFAULT = (128, 30)  # the dense projector (251.7 MB float32)
CT_SHEAR = (256, 90)  # the shear projector (no matrix)
# the shear run: RESULTS.md:303-318's tau_tv = 15 run (20000 steps, burn-in 4000)
# cut to its first trace point, where the JAX package's posterior mean over steps
# 4001-4500 read 22.977 dB (fig/r4_measurements/ct256_tv15.log) and its FISTA MAP
# (500 iterations, the CLI's) 26.00 dB; each gated at that value less CT_MARGIN
CT_SHEAR_RUN = dict(size=256, n_angles=90, tau_tv=15.0, n_steps=4500, burn_in=4000, pnp=False)
CT_SHEAR_REF = {"psnr_map_tv": 26.00, "psnr_posterior_mean": 22.977}
# the score branch (annealed score-ULA, one corrector sweep a step, a 300-step fit of
# the score CNN) at 128^2 / 30 from the FBP start, at the configuration of
# scripts/ct_gates.py, whose JAX runs over seeds 0-3 (20.1565, 20.1872, 20.1914,
# 20.4860 dB on the CPU) give the gate [min - 1, max + 1]
CT_SCORE_RUN = dict(size=128, n_angles=30, n_steps=400, burn_in=200, compute_map=False,
                    pnp=False, score_prior=True, score_train_steps=300, pc_correctors=1)
CT_SCORE_GATE = (19.1565, 21.4860)
CT_RADON_TOL = 2e-5  # relative to the largest f64 value; TF32 would miss by ~1e-3
CT_RADON_REPS = 20
CT_PROFILE_MAP_ITERS = 2  # adaptive-PDHG iterations of the dense MAP's window
CT_PROFILE_STEPS = 20  # TV-MYULA steps at 256^2 / 90 of the chain's window
# (side, niter, gamma): the chain's prox at the defaults (tau_tv / L, L = lambda_max /
# sigma^2 ~ 3431 / 4), the shear chain's and the shear FISTA MAP's (tau_tv = 15,
# 15 / L at 256^2 / 90)
CT_KERNEL1 = ((128, 10, 0.006), (256, 10, 0.003), (256, 20, 0.003))


def phase_kernel1_ct(dev, report):
    """Kernel 1 against its plain version at max abs error 0 at the CT
    path's shapes (niter 10, the chains' prox at 128^2 and 256^2; 256^2
    niter 20, the shear FISTA MAP's), on the route ``prox_plan`` names, then
    timed per call with CUDA events beside the plain version and the
    bound."""
    import torch

    from lmc_atomi_torch.ops.tv_cuda import prox_tv_iso_cuda, prox_tv_iso_ref
    from lmc_atomi_torch.utils.images import phantom

    gen = torch.Generator(device=dev).manual_seed(5)
    ct = {}
    for n, niter, gamma in CT_KERNEL1:
        # an iterate of the chain's kind: the phantom in [0, 1] and noise
        x = (torch.from_numpy(phantom(n)).to(dev) / 255.0
             + 0.1 * torch.randn((n, n), generator=gen, device=dev))
        got = prox_tv_iso_cuda(x, gamma, niter=niter)
        plan = prox_tv_iso_cuda.last_plan
        err, _ = compare(f"kernel 1 CT {n}^2 niter={niter}", (got,),
                         (prox_tv_iso_ref(x, gamma, niter=niter),), ("x",), exact=True)
        ms, _ = cuda_ms(lambda: prox_tv_iso_cuda(x, gamma, niter=niter), 200)
        p_ms, _ = cuda_ms(lambda: prox_tv_iso_ref(x, gamma, niter=niter), 20)
        b_ms, b_by = bound_kernel1(n * n, niter)
        ct[f"{n}x{n}_niter{niter}"] = dict(max_abs_err=err, route=plan[0], ms=ms, plain_ms=p_ms,
                                           bound_ms=b_ms, bound_by=b_by)
        log(f"kernel1 CT {n}^2 niter={niter}: max_abs_err={err:.3e}, plan {plan}; per call "
            f"kernel {ms:.4f} ms (CUDA events, 200 back to back), plain {p_ms:.4f} ms, bound "
            f"{b_ms:.5f} ms ({b_by})")
    report["prox_tv_iso_cuda"]["ct"] = ct


def _radon_f64(op):
    """The f64 operator on the host with the card operator's angles (and
    residual angles), in the same mode."""
    import numpy as np
    import torch

    from lmc_atomi_torch.ops.radon import Radon2D, _dense_matrix

    th = op.thetas.double().cpu()
    dense = phis = None
    if op.mode == "dense":
        dense = _dense_matrix(op.shape, th.numpy(), op.n_det, torch.float64)
    elif op.mode == "shear":
        k = np.asarray(op.shear_ks)
        phis = torch.from_numpy(th.numpy() - k * (np.pi / 2.0))
    return Radon2D(thetas=th, dense=dense, shape=op.shape, mode=op.mode, shear_phis=phis,
                   shear_ks=op.shear_ks)


def _ct_radon_checks(dev):
    """Each projector the CT path runs (dense at 128^2/30, shear at 256^2/90,
    as ``create`` picks them) and the gather projector at 128^2/30 against
    its f64 version on the host, projection and backprojection within
    CT_RADON_TOL of the largest f64 value, each twice with equal bits (the
    gather adjoint sums in a fixed order); then timed per call with CUDA
    events."""
    import torch

    from lmc_atomi_torch.core.random import normal_field
    from lmc_atomi_torch.ops.radon import Radon2D
    from lmc_atomi_torch.utils.images import phantom

    smi = nvidia_smi("name,power.limit")
    for (n, n_angles), mode in ((CT_DEFAULT, "dense"), (CT_SHEAR, "shear"),
                                (CT_DEFAULT, "gather")):
        t0 = time.perf_counter()
        op = Radon2D.create((n, n), n_angles=n_angles, device=dev,
                            mode="gather" if mode == "gather" else None)
        if mode == "gather":
            op.matvec(torch.zeros((n, n), device=dev))  # builds its plan
        t_build = time.perf_counter() - t0
        if op.mode != mode:
            raise AssertionError(f"ct radon {n}^2 x {n_angles}: mode {op.mode}, want {mode}")
        ref = _radon_f64(op)
        x = torch.from_numpy(phantom(n)).to(dev) / 255.0
        y = op.matvec(x) + 2.0 * normal_field(7, 0, 0, (n_angles, n), torch.float32, dev)
        errs = {}
        for name, fn, fn64, arg in (("matvec", op.matvec, ref.matvec, x),
                                    ("rmatvec", op.rmatvec, ref.rmatvec, y)):
            a, b = fn(arg), fn(arg)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f"ct radon {op.mode} {name}: two calls differ")
            want = fn64(arg.double().cpu())
            errs[name] = float((a.double().cpu() - want).abs().max() / want.abs().max())
            if not errs[name] <= CT_RADON_TOL:
                raise AssertionError(f"ct radon {op.mode} {name}: relative error "
                                     f"{errs[name]:.3e} > {CT_RADON_TOL}")
        ms = {name: cuda_ms(lambda: fn(arg), CT_RADON_REPS)[0]
              for name, fn, arg in (("matvec", op.matvec, x), ("rmatvec", op.rmatvec, y))}
        mbytes = 0 if op.dense is None else op.dense.numel() * 4 / 1e6
        log(f"ct radon {op.mode} {n}^2 x {n_angles} angles [{smi}]: built in {t_build:.2f} s "
            f"(matrix {mbytes:.1f} MB), against f64 on the host: relative error matvec "
            f"{errs['matvec']:.3e}, rmatvec {errs['rmatvec']:.3e} (tolerance {CT_RADON_TOL}), "
            f"two calls equal bit for bit; per call (CUDA events, {CT_RADON_REPS} back to "
            f"back) matvec {ms['matvec']:.4f} ms, rmatvec {ms['rmatvec']:.4f} ms")


def phase_ct(dev):
    """The CT path through its entry point: the Radon checks, then
    ``ct_tv_myula`` at the CLI's defaults (128^2, 30 angles, dense; MAP by
    adaptive PDHG, TV chain with kernel 1, PnP-ULA with a DnCNN fitted in the
    run), each PSNR gated at RESULTS.md:283 less CT_MARGIN; at 256^2 / 90
    angles (shear; FISTA MAP with kernel 1 at niter 20) at the depth of the
    JAX package's first trace point (CT_SHEAR_RUN), the MAP and the posterior
    mean gated at its values less CT_MARGIN (CT_SHEAR_REF); and the score
    branch at 128^2 / 30 (CT_SCORE_RUN) twice, its posterior mean above the
    FBP start and inside the JAX package's band (CT_SCORE_GATE), equal bit
    for bit across the two runs. The MAP solvers are timed apart (a wrapper
    that synchronises around them)."""
    import numpy as np
    import torch

    from lmc_atomi_torch.experiments import ct

    _ct_radon_checks(dev)
    smi = nvidia_smi("name,power.limit")
    map_s = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            map_s[name] = time.perf_counter() - t0
            return out
        return wrapper

    def gate(tag, rep, refs):
        for key, ref in refs.items():
            if not rep[key] >= ref - CT_MARGIN:
                raise AssertionError(f"ct {tag} {key}: {rep[key]:.4f} below the JAX "
                                     f"package's {ref} less {CT_MARGIN} dB")

    orig = ct.adaptive_pdhg_segmented, ct.fista_segmented
    ct.adaptive_pdhg_segmented = timed("PDHG", orig[0])
    ct.fista_segmented = timed("FISTA", orig[1])
    score_means = []
    try:
        for tag, kw in (("CLI defaults", {}), ("shear", CT_SHEAR_RUN),
                        ("score", CT_SCORE_RUN), ("score again", CT_SCORE_RUN)):
            out = io.StringIO()
            map_s.clear()
            arrays = {}
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                mean, std, rep = ct.ct_tv_myula(device=str(dev), make_plots=False,
                                                arrays_out=arrays, **kw)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            line = json.loads(out.getvalue().strip().splitlines()[-1])
            if {k: line[k] for k in rep} != rep:
                raise AssertionError(f"ct {tag}: the JSON line differs from the report")
            if not all(np.isfinite(a).all() for a in arrays.values()):
                raise AssertionError(f"ct {tag}: non-finite images among {sorted(arrays)}")
            msg = (f"ct {tag} ({line['size']}^2, {line['n_angles']} angles, {line['steps']} "
                   f"steps) [{smi}]: {wall:.1f} s, peak {peak:.2f} GiB; psnr backprojection "
                   f"{rep['psnr_backprojection']:.4f}, FBP {rep['psnr_fbp']:.4f}")
            for (solver, secs) in map_s.items():
                n_map = kw.get("niter_map", 500)
                msg += (f", MAP {rep['psnr_map_tv']:.4f} ({solver}, {n_map} iterations, "
                        f"{secs:.2f} s, {n_map / secs:.1f} it/s)")
            msg += f", TV posterior mean {rep['psnr_posterior_mean']:.4f}"
            for key, name in (("psnr_pnp_mean", "PnP"), ("psnr_score_mean", "score-ULA")):
                if key in rep:
                    msg += f", {name} {rep[key]:.4f}"
            log(msg + f" dB; TV chain {rep['iters_per_sec']} iters/s; trace {rep['psnr_trace']}")
            if tag == "CLI defaults":
                gate(tag, rep, CT_REF)
            elif tag == "shear":
                gate(tag, rep, CT_SHEAR_REF)
            else:
                lo, hi = CT_SCORE_GATE
                if not (rep["psnr_score_mean"] > rep["psnr_fbp"]
                        and lo <= rep["psnr_score_mean"] <= hi):
                    raise AssertionError(f"ct {tag}: score-ULA mean {rep['psnr_score_mean']:.4f}"
                                         f" not above the FBP or outside [{lo}, {hi}]")
                score_means.append(arrays["score_mean"])
        if not np.array_equal(*score_means):
            raise AssertionError("ct score: two runs from one seed differ")
        log("ct score: two runs from one seed equal bit for bit")
    finally:
        ct.adaptive_pdhg_segmented, ct.fista_segmented = orig


def phase_profile_ct(dev):
    """Where the time goes on the CT path: CT_PROFILE_MAP_ITERS iterations
    of the dense MAP (adaptive PDHG, each a 50-trip CG gram solve) at 128^2 /
    30 angles, and CT_PROFILE_STEPS TV-MYULA steps at 256^2 / 90 (shear)."""
    import torch

    from lmc_atomi_torch.core.random import normal_field
    from lmc_atomi_torch.kernels.imaging import myula_imaging
    from lmc_atomi_torch.ops.functionals import L21Norm, L2Data, TVNorm
    from lmc_atomi_torch.ops.linops import Gradient2D, LinOp
    from lmc_atomi_torch.ops.radon import Radon2D, fbp
    from lmc_atomi_torch.run.optimize import adaptive_pdhg
    from lmc_atomi_torch.run.runner import run_chain
    from lmc_atomi_torch.utils.images import phantom

    smi = nvidia_smi("name,power.limit")
    for (n, n_angles), what in ((CT_DEFAULT, "map"), (CT_SHEAR, "chain")):
        op = Radon2D.create((n, n), n_angles=n_angles, device=dev)
        img = torch.from_numpy(phantom(n)).to(dev) / 255.0
        sino = op.matvec(img) + 2.0 * normal_field(0, 0, 0, (n_angles, n), torch.float32, dev)
        l2 = L2Data(op=op, b=sino, sigma=0.25)
        lips = float(LinOp.max_gram_eig(op, probe=img, iters=20)) / 4.0
        x0 = torch.clamp(fbp(op, sino, filter_name="hann"), min=0.0)
        if what == "map":
            profile_window(
                f"ct dense MAP {n}^2 x {n_angles}, {CT_PROFILE_MAP_ITERS} adaptive-PDHG "
                f"iterations [{smi}]",
                lambda: adaptive_pdhg(l2, L21Norm(sigma=5.0), Gradient2D(), x0, 0.95 / lips,
                                      1.0, CT_PROFILE_MAP_ITERS).x)
        else:
            kern = myula_imaging(l2, TVNorm(sigma=15.0, niter=10), tau=0.2 / lips,
                                 gamma=1.0 / lips)
            profile_window(
                f"ct shear TV-MYULA {n}^2 x {n_angles}, {CT_PROFILE_STEPS} steps [{smi}]",
                lambda: run_chain(kern, x0, (2, 0), CT_PROFILE_STEPS, collect="stats"))


def profile_window(label, fn):
    """torch.profiler over one call of ``fn`` (after a warm-up call): the
    wall time, the share of it the card was busy (the sum of kernel times
    over the wall time; the profiler slows the host, so host-bound windows
    read low) and the kernels that took most of the device time.

    The profiler keeps a device record only if its CUPTI timestamp falls
    inside the capture window, and on an H100 host those timestamps ran
    early by up to more than 0.5 s (Kineto counted the lost records as
    "Out-of-range"): a short window then loses its first records or all of
    them, and a long one a few. So the call runs with idle host time on
    either side, the first margin of PROFILE_MARGINS_S, and the window must
    hold device records for at least PROFILE_KEPT of the kernel launches
    and copies its host side made; if it does not, it is taken again with
    the next margin, and fails after the last."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t_start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    for margin in PROFILE_MARGINS_S:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(margin)
        device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        calls = sum(1 for e in prof.events() if e.name in CUDA_LAUNCH_CALLS)
        if device and len(device) >= PROFILE_KEPT * calls:
            break
        log(f"profile {label}: {len(device)} device records for {calls} launches and "
            f"copies at a {margin} s margin")
    else:
        raise AssertionError(f"profile {label}: the profiler lost device records")
    kernels = {}
    for evt in device:
        name = evt.name.replace("(anonymous namespace)::", "")
        name = re.sub(r"[<(].*", "", name).split("::")[-1].strip()[:32]
        t, n = kernels.get(name, (0.0, 0))
        kernels[name] = (t + evt.time_range.elapsed_us(), n + 1)
    busy = sum(t for t, _ in kernels.values()) / (wall * 1e6)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    log(f"profile {label} ({time.perf_counter() - t_start:.1f} s in all): wall "
        f"{wall * 1e3:.1f} ms, device busy {busy:.4f}, device records {len(device)} of "
        f"{calls} launches and copies (margin {margin} s), top kernels (share of device time, us each x count): "
        + "; ".join(f"{k} {t / sum(v[0] for v in kernels.values()):.3f} "
                    f"{t / n:.2f}us x{n}" for k, (t, n) in top))
    return kernels


def phase_profile(dev, l2, img, models):
    """Where the time goes in the main path's 500-step fused block (kernel
    2's resident route) and in the deconvolution cells: a fused ULPDA block,
    the one-step fused grid with its metrics, and the MAP iteration."""
    import torch

    from lmc_atomi_torch.eval.metrics import psnr
    from lmc_atomi_torch.kernels.myula_fused import run_myula_tv_fused
    from lmc_atomi_torch.kernels.ulpda_fused import run_ulpda_fused, ulpda_sep_fused
    from lmc_atomi_torch.ops.linops import Gradient2D
    from lmc_atomi_torch.run.optimize import adaptive_pdhg
    from lmc_atomi_torch.run.runner import run_chain

    tau0 = 0.95 * SIGMA_NOISE**2
    x0 = torch.zeros((N, N), device=dev)
    gamma = SIGMA_NOISE**2
    profile_window(f"run_myula_tv_fused cold10 {BLOCK} steps", lambda: run_myula_tv_fused(
        l2, TV_WEIGHT, 0.2 * gamma, gamma, x0, 3, BLOCK, block=BLOCK))
    grad_op = Gradient2D()
    for name, proxf, proxg, _ in (models[0], models[2]):
        profile_window(f"run_ulpda_fused {name} 500 steps", lambda: run_ulpda_fused(
            proxf, proxg, grad_op, tau0, 1.0, x0, 3, BLOCK, block=BLOCK))
    name, proxf, proxg, _ = models[2]
    metrics = {"cost": lambda x: proxf(x) + proxg(grad_op.matvec(x)),
               "err": lambda x: torch.linalg.norm(torch.ravel(x - img)),
               "psnr": lambda x: psnr(img, x)}
    kern = ulpda_sep_fused(proxf, proxg, grad_op, tau0, 1.0)
    profile_window(f"deconv ULPDA grid step {name} x50 (with metrics)", lambda: run_chain(
        kern, x0, 3, 50, collect="stats", metrics=metrics))
    profile_window(f"deconv MAP {name} x50 (with metrics)", lambda: adaptive_pdhg(
        proxf, proxg, grad_op, x0, tau0, 1.0, 50, metrics=metrics))


def phase_profile_kernel1(dev):
    """Kernel 1's device time per call at 512^2 and 2048^2 (niter 10), from
    one profiler window of 50 back-to-back calls each, beside its bound."""
    import torch

    from lmc_atomi_torch.ops.tv_cuda import prox_tv_iso_cuda

    gamma = TV_WEIGHT * SIGMA_NOISE**2
    gen = torch.Generator(device=dev).manual_seed(3)
    for n in (N, LARGE_N):
        x = 100.0 + 50.0 * torch.randn((n, n), generator=gen, device=dev)
        kernels = profile_window(f"kernel1 {n}^2 niter 10 x50", lambda: [
            prox_tv_iso_cuda(x, gamma, niter=10) for _ in range(50)])
        t, cnt = next(v for k, v in kernels.items() if "tv_prox_kernel" in k)
        b_ms, b_by = bound_kernel1(n * n, 10)
        log(f"kernel1 {n}^2 niter 10 device time {t / cnt:.2f} us a call (x{cnt}, route "
            f"{prox_tv_iso_cuda.last_plan[0]}), bound {b_ms * 1e3:.2f} us ({b_by})")


def phase_profile_inpainting(dev):
    """Where the time goes in the inpainting cells: a fused Haar and a fused
    D4 MYULA block, and the unfused MYULA step."""
    from lmc_atomi_torch.kernels.imaging import myula_imaging
    from lmc_atomi_torch.kernels.wavelet_fused import run_myula_wavelet_fused
    from lmc_atomi_torch.ops.functionals import OrthogonalL1
    from lmc_atomi_torch.ops.wavelet import HaarDWT2D
    from lmc_atomi_torch.run.runner import run_chain

    _, l2 = make_inpainting(dev)
    for name in ("haar", "d4"):
        profile_window(f"run_myula_wavelet_fused {name} {BLOCK} steps",
                       lambda: run_myula_wavelet_fused(l2, INP_TAU_W, 0.2 * INP_GAMMA, INP_GAMMA,
                                                       l2.b, 3, BLOCK, block=BLOCK,
                                                       taps=TAPS[name]))
    kern = myula_imaging(l2, OrthogonalL1(op=HaarDWT2D(levels=INP_LEVELS), sigma=INP_TAU_W),
                         0.2 * INP_GAMMA, INP_GAMMA)
    profile_window("inpainting MYULA unfused step x25", lambda: run_chain(
        kern, l2.b, 3, 25, collect="stats"))


def phase_profile_large(dev):
    """Where the time goes in the large-image cell: one 200-step block at
    2048^2 of each tiled runner (kernels 6 FGP-8 and 7) and of the
    whole-image runner on the same posterior (kernels 2 and 3)."""
    import torch

    from lmc_atomi_torch.kernels.myula_fused import run_myula_tv_fused
    from lmc_atomi_torch.kernels.myula_tiled import run_myula_tv_tiled
    from lmc_atomi_torch.kernels.ulpda_fused import run_ulpda_fused
    from lmc_atomi_torch.kernels.ulpda_tiled import run_ulpda_tv_tiled
    from lmc_atomi_torch.ops.functionals import L21Norm
    from lmc_atomi_torch.ops.linops import Gradient2D

    _, y, terms = make_large(dev, LARGE_N)
    l2, x0, gamma = terms["tv"], torch.zeros_like(y), SIGMA_NOISE**2
    fgp8 = dict(tv_solver="fgp", niter_tv=8, block=LARGE_BLOCK)
    for name, run in (("run_myula_tv_tiled", run_myula_tv_tiled),
                      ("run_myula_tv_fused", run_myula_tv_fused)):
        profile_window(f"{name} fgp8 {LARGE_N}^2 {LARGE_BLOCK} steps", lambda: run(
            l2, TV_WEIGHT, 0.2 * gamma, gamma, x0, 3, LARGE_BLOCK, **fgp8))
    dual = L21Norm(sigma=TV_WEIGHT)
    for name, run in (("run_ulpda_tv_tiled", run_ulpda_tv_tiled),
                      ("run_ulpda_fused", run_ulpda_fused)):
        profile_window(f"{name} tv {LARGE_N}^2 {LARGE_BLOCK} steps", lambda: run(
            l2, dual, Gradient2D(), 0.95 * gamma, 1.0, x0, 3, LARGE_BLOCK, niter_solve=3,
            block=LARGE_BLOCK))


def load_checkout(root, module, attr):
    """``attr`` of ``module`` of the package in another checkout at ``root``,
    imported beside this one: its modules load under the same names while
    this package's are set aside, and keep their own build."""
    import importlib

    def ours():
        return [k for k in sys.modules if k.split(".")[0] == "lmc_atomi_torch"]

    saved = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, str(root))
    try:
        mod = importlib.import_module(module)
        mod._build.library()
    finally:
        sys.path.remove(str(root))
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)
    return getattr(mod, attr)


def ptxas_report():
    """The registers, spills and shared memory ``ptxas -v`` reports for the
    kernels of csrc/tv_prox.cu, csrc/ulpda_block.cu, csrc/wavelet_block.cu
    and csrc/tiled_block.cu."""
    import tempfile

    from lmc_atomi_torch import _build

    for src in ("tv_prox.cu", "ulpda_block.cu", "wavelet_block.cu", "tiled_block.cu"):
        with tempfile.TemporaryDirectory() as tmp:
            proc = subprocess.run(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                 str(Path(tmp) / "t.o"), str(_build.CSRC / src)],
                capture_output=True, text=True, check=True)
        for line in proc.stderr.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"ptxas {src}: {line.strip()}")


def kernel3_sequence(*args, **kwargs):
    """Kernel 3's wrapper on the launch sequence in place of
    ``ulpda_resident_plan``'s route: a measurement."""
    from unittest import mock

    from lmc_atomi_torch.kernels import ulpda_fused

    with mock.patch.object(ulpda_fused, "ulpda_resident_plan", lambda *_, **__: None):
        return ulpda_fused.ulpda_block_update_cuda(*args, **kwargs)


def kernel7_on(geometry):
    """Kernel 7's wrapper launching ``geometry`` (an entry of
    ``kernel7_ranking``) in place of ``ulpda_tiled_plan``'s pick."""
    from unittest import mock

    from lmc_atomi_torch.kernels import ulpda_tiled

    def run(*args, **kwargs):
        with mock.patch.object(ulpda_tiled, "ulpda_tiled_plan", lambda *_, **__: geometry):
            return ulpda_tiled.ulpda_tv_tiled_update_cuda(*args, **kwargs)

    return run


def prox_variants(wrapper, shape, niter, tail, call, reps, roots):
    """Kernel 1 (``tail`` false) or 8 as ``_turns`` variants, each ``reps``
    calls of ``call(fn)`` returning the last output: this checkout's pick,
    the kernel of each checkout in ``roots``, and this checkout's wrapper on
    rank 2 of ``prox_plan``'s ranking, on the best geometry of another
    route, the best with ``k = niter`` and the best at 512 threads a CTA
    (patched in place of the pick: a measurement)."""
    import contextlib
    from unittest import mock

    import torch

    from lmc_atomi_torch import _build
    from lmc_atomi_torch.ops import tv_cuda

    def batch(fn, geometry=None):
        def run():
            with (mock.patch.object(tv_cuda, "prox_plan", lambda *_, **__: geometry)
                  if geometry else contextlib.nullcontext()):
                for _ in range(reps):
                    out = call(fn)
            return (out,)
        return run

    module, attr = (("lmc_atomi_torch.kernels.myula_cuda", "myula_tv_fused_update_cuda")
                    if tail else ("lmc_atomi_torch.ops.tv_cuda", "prox_tv_iso_cuda"))
    n_sm, smem_limit = _build.card_limits(torch.device("cuda", torch.cuda.current_device()))
    ranking = tv_cuda._prox_ranking(*shape, niter, tail, n_sm, smem_limit)
    picks = [ranking[2], next(g for g in ranking if g[0] != ranking[0][0]),
             next(g for g in ranking if g[4] == niter),
             next(g for g in ranking if g[5] == 512)]
    variants = [("pick", batch(wrapper))] + [
        (Path(r).name, batch(load_checkout(r, module, attr))) for r in roots]
    for geo in dict.fromkeys(g for g in picks if g != ranking[0]):
        variants.append((f"{geo[0]} {geo[1:6]}", batch(wrapper, geo)))
    return variants


def wavelet_route(route):
    """A context in which kernels 4 and 5's wrappers of this checkout take
    ``route`` (``"tile"`` or ``"passes"``, every chain a launch) in place of
    ``wavelet_plan``'s pick."""
    from unittest import mock

    from lmc_atomi_torch.kernels import wavelet_fused

    def plan(shape, taps, levels, n_sm=None, n_chains=1):
        l_eff = wavelet_fused.dwt_levels(shape, taps, levels)
        return l_eff, route, (wavelet_fused.tile_region(shape, l_eff) if route == "tile"
                              else (0, 0)), (n_chains, 1)

    return mock.patch.object(wavelet_fused, "wavelet_plan", plan)


def wavelet_on(wrapper, route):
    """Kernel 4's or 5's wrapper of this checkout on ``route`` in place of
    ``wavelet_plan``'s pick (``wavelet_route``): a measurement."""
    def run(*args, **kwargs):
        with wavelet_route(route):
            return wrapper(*args, **kwargs)

    return run


# ``--turns 4,5``: variants of the D4/D8 resident route, each from a copy of
# this checkout's sources edited at text anchors: (name, [(file, anchor,
# text, times the anchor occurs)]). The second drops every pass's work and
# the update, leaving a step's grid barriers (not compared: a timing only).
WAVELET_VARIANTS = [
    ("resident 1024 threads", [
        ("wavelet_block.cu", "#define WV_RS_THREADS 512\n#define WV_RS_PPT 8",
         "#define WV_RS_THREADS 1024\n#define WV_RS_PPT 4", 1)]),
    ("grid barriers alone", [
        ("wavelet_block.cu", "    fn(r, c, q);\n", "", 1),
        ("wavelet_block.cu", "      const float p = rs_p<TAPS>(sh, tx, li / tx, li % tx, f);\n",
         "      if (li >= 0) continue;\n"
         "      const float p = rs_p<TAPS>(sh, tx, li / tx, li % tx, f);\n", 2)]),
]
UNCHECKED_VARIANTS = ("grid barriers alone",)


def _turns(label, variants, run, fields, turns):
    """Each variant's ``run`` held bit for bit to the first's (but those of
    ``UNCHECKED_VARIANTS``), then timed in alternating turns (each turn all
    variants forward, then backward)."""
    ref = run(variants[0][1])
    for name, fn in variants[1:]:
        if name not in UNCHECKED_VARIANTS:
            compare(f"{label} {name}", run(fn), ref, fields, exact=True)
    ms = {name: [] for name, _ in variants}
    for _ in range(turns):
        for name, fn in variants + variants[::-1]:
            ms[name].append(cuda_ms(lambda: run(fn), 2)[0])
    for name, vals in ms.items():
        log(f"turns {label}, {name}: " + ", ".join(f"{v:.3f}" for v in vals) + " ms")


def phase_turns(dev, kernels, roots, turns=2):
    """Kernels 1 and 3-8 (those in ``kernels``) of each checkout in
    ``roots`` and of this one in its variants, timed in alternating turns,
    every variant held bit for bit to this checkout's pick: kernel 1 per 200
    calls at 512^2 and 50 at 2048^2 (niter 10), kernel 8 per 50 steps at
    2048^2, on the variants of ``prox_variants``, and the unfused MYULA main
    path over UNFUSED_TURN_STEPS steps with each checkout's kernel 1; kernel
    3 per 500-step block at 512^2 (the deconvolution models' TV,
    MC-TV, ME-TV) on the resident route and the launch sequence, and per
    one-step call without statistics; kernel 4 per 500-step and kernel 5 per
    250-step block at 512^2 on ``wavelet_plan``'s route, the route it
    replaced and, for D4/D8, ``WAVELET_VARIANTS``; kernels 6 and 7 per
    200-step block at 2048^2 at ranks 0 and 2 of their planner and its best
    512-thread geometry."""
    import torch

    from lmc_atomi_torch.kernels.myula_cuda import myula_tv_fused_update_cuda
    from lmc_atomi_torch.kernels.myula_tiled import myula_tv_tiled_update_cuda
    from lmc_atomi_torch.kernels.ulpda_fused import ulpda_block_update_cuda
    from lmc_atomi_torch.kernels.ulpda_tiled import ulpda_tv_tiled_update_cuda
    from lmc_atomi_torch.ops.tv_cuda import prox_tv_iso_cuda

    ptxas_report()
    ufields = ("x", "py", "px", "xbar", "mean", "m2")
    gamma = SIGMA_NOISE**2
    if 1 in kernels:
        gen = torch.Generator(device=dev).manual_seed(3)
        for n, reps in ((N, 200), (LARGE_N, 50)):
            x = 100.0 + 50.0 * torch.randn((n, n), generator=gen, device=dev)
            variants = prox_variants(
                prox_tv_iso_cuda, (n, n), 10, False,
                lambda fn: fn(x, TV_WEIGHT * gamma, niter=10), reps, roots)
            _turns(f"kernel1 {n}^2 niter 10 x{reps} calls", variants, lambda b: b(), ("x",),
                   turns)
            log(f"kernel1 {n}^2 pick: {prox_tv_iso_cuda.last_plan}")
        # the unfused MYULA main path, kernel 1 of each checkout patched in
        from unittest import mock

        from lmc_atomi_torch.kernels.imaging import myula_imaging
        from lmc_atomi_torch.ops import tv as tv_ops
        from lmc_atomi_torch.ops.functionals import TVNorm
        from lmc_atomi_torch.run.runner import run_chain

        _, _, l2 = make_problem(dev)
        kern = myula_imaging(l2, TVNorm(sigma=TV_WEIGHT, niter=10), tau=0.2 * gamma,
                             gamma=gamma)
        x0 = torch.zeros((N, N), device=dev)

        def chain(k1):
            with mock.patch.object(tv_ops, "prox_tv_iso_cuda", k1):
                return (run_chain(kern, x0, 4, UNFUSED_TURN_STEPS).final_state.position,)

        others = [(Path(r).name, load_checkout(r, "lmc_atomi_torch.ops.tv_cuda",
                                               "prox_tv_iso_cuda")) for r in roots]
        _turns(f"unfused MYULA main path {N}^2, {UNFUSED_TURN_STEPS} steps",
               [("pick", prox_tv_iso_cuda)] + others, chain, ("x",), turns)
    if 8 in kernels:
        _, y8, terms8 = make_large(dev, LARGE_N)
        grad, reps = terms8["tv"].grad(y8), 50
        variants = prox_variants(
            myula_tv_fused_update_cuda, (LARGE_N, LARGE_N), 10, True,
            lambda fn: fn(y8, grad, (8, 0, 0), 0.2 * gamma, gamma, TV_WEIGHT * gamma), reps,
            roots)
        _turns(f"kernel8 {LARGE_N}^2 niter 10 x{reps} steps", variants, lambda b: b(), ("x",),
               turns)
        log(f"kernel8 {LARGE_N}^2 pick: {myula_tv_fused_update_cuda.last_plan}")
    if 3 in kernels:
        others = [(Path(r).name, load_checkout(r, "lmc_atomi_torch.kernels.ulpda_fused",
                                               "ulpda_block_update_cuda")) for r in roots]
        _, y, models = make_deconv_models(dev)
        variants = [("pick", ulpda_block_update_cuda)] + others + [
            ("sequence", kernel3_sequence)]
        for name, proxf, proxg, _ in models[:3]:
            cfg = dict(gfirst=False, niter_solve=3)
            _turns(f"kernel3 {name} {N}^2 per {BLOCK}-step block", variants,
                   lambda fn: _run_ulpda_blocks(fn, proxf, proxg, y, BLOCK, BLOCK, cfg, 8),
                   ufields, turns)
            log(f"kernel3 {name} pick: {ulpda_block_update_cuda.last_plan}")
            atb, scal_f, kw = _ulpda_scalars(proxf, proxg)
            z = torch.zeros_like(y)
            _turns(f"kernel3 {name} {N}^2 one step, no statistics, x200", variants,
                   lambda fn: [fn(y, z, z, None, atb, None, None, (9, 0), scal_f, (3, 0, 0),
                                  n_steps=1, with_stats=False, niter_solve=3, **kw)[0]
                               for _ in range(200)][-1:],
                   ("x",), turns)
    if 4 in kernels or 5 in kernels:
        phase_turns_wavelet(dev, kernels, roots, turns)
    n, blk = LARGE_N, LARGE_BLOCK
    if 6 in kernels or 7 in kernels:
        _, y, terms = make_large(dev, n)
    if 6 in kernels:
        others = [(Path(r).name, load_checkout(r, "lmc_atomi_torch.kernels.myula_tiled",
                                               "myula_tv_tiled_update_cuda")) for r in roots]
        for name, mode, cfg in KERNEL6_MODES:
            data = terms[mode]
            ranking = kernel6_ranking(data, cfg, (n, n))
            rank512 = next(r for r, geo in enumerate(ranking) if geo[3] == 512)
            variants = [("pick", myula_tv_tiled_update_cuda)] + others + [
                (f"rank{r} {ranking[r]}", kernel6_on(ranking[r])) for r in (2, rank512)]
            tcfg = dict(cfg, **_myula_tiling(data, cfg, n))
            _turns(f"kernel6 {name} {n}^2 per {blk}-step block", variants,
                   lambda fn: _run_blocks(fn, data, y, blk, blk, tcfg, 8),
                   ("x", "mean", "m2", "qh", "qn"), turns)
            log(f"kernel6 {name} pick: {myula_tv_tiled_update_cuda.last_plan}")
    if 7 in kernels:
        others = [(Path(r).name, load_checkout(r, "lmc_atomi_torch.kernels.ulpda_tiled",
                                               "ulpda_tv_tiled_update_cuda")) for r in roots]
        for mode in ("tv", "mctv", "metv"):
            data = terms[mode]
            ranking = kernel7_ranking(data, (n, n))
            rank512 = next(r for r, geo in enumerate(ranking) if geo[3] == 512)
            variants = [("pick", ulpda_tv_tiled_update_cuda)] + others + [
                (f"rank{r} {ranking[r]}", kernel7_on(ranking[r])) for r in (2, rank512)]
            _turns(f"kernel7 {mode} {n}^2 per {blk}-step block", variants,
                   lambda fn: _run_ulpda_tiled_blocks(fn, data, _dual7(mode), y, blk, blk,
                                                      dict(gfirst=False), 8),
                   ufields, turns)
            log(f"kernel7 {mode} pick: {ulpda_tv_tiled_update_cuda.last_plan}")


def phase_turns_wavelet(dev, kernels, roots, turns):
    """Kernels 4 and 5 (those in ``kernels``) in alternating turns at 512^2:
    this checkout's pick, each checkout in ``roots``, this checkout on the
    route the pick replaced (Haar ``"tile"``, D4/D8 ``"passes"``) and, for
    D4/D8, on ``WAVELET_VARIANTS``."""
    import tempfile

    from lmc_atomi_torch.kernels import wavelet_fused

    _, l2 = make_inpainting(dev)
    module = "lmc_atomi_torch.kernels.wavelet_fused"
    with tempfile.TemporaryDirectory() as tmp:
        copies = {}
        for name, patches in WAVELET_VARIANTS:
            copies[name] = Path(tmp) / name.replace(" ", "_")
            patched_copy(ROOT, copies[name], patches)
        for kern in sorted({4, 5} & set(kernels)):
            attr = "wavelet_block_update_cuda" if kern == 4 else "ulpda_wavelet_block_update_cuda"
            pick = getattr(wavelet_fused, attr)
            others = [(Path(r).name, load_checkout(r, module, attr)) for r in roots]
            edited = [(name, load_checkout(d, module, attr)) for name, d in copies.items()]
            if kern == 4:
                runs = [(name, taps, qs, lambda fn, taps=taps, qs=qs: _wavelet_blocks(
                    fn, l2, BLOCK, BLOCK, 8, taps, qs)) for name, taps, qs in (
                        ("haar", 2, ()), ("haar_ci95", 2, (0.025, 0.975)), ("d4", 4, ()),
                        ("d8", 8, ()))]
                fields, block = ("x", "mean", "m2", "qh", "qn"), BLOCK
            else:
                runs = [(f"{name} gfirst={gfirst}", taps, (),
                         lambda fn, taps=taps, gfirst=gfirst: _ulpda_wavelet_blocks(
                             fn, l2, BLOCK // 2, BLOCK // 2, 8, taps, gfirst))
                        for name, taps in TAPS.items() for gfirst in (False, True)]
                fields, block = ("x", "c", "xbar", "mean", "m2"), BLOCK // 2
            for name, taps, _, run in runs:
                old = "tile" if taps == 2 else "passes"
                variants = [("pick", pick)] + others + [(old, wavelet_on(pick, old))]
                if taps > 2:
                    variants += edited
                _turns(f"kernel{kern} {name} {N}^2 per {block}-step block", variants, run,
                       fields, turns)
                log(f"kernel{kern} {name} pick: {pick.last_plan}")


# ``--clock``: clock64 ticks inserted into a copy of kernel 3's resident step
# (text anchors in csrc/, each must be found once): (file, anchor, text after)
CLOCK_TICK = """
__device__ unsigned long long ul_clk[32];
__device__ long long ul_tlast[4096];
__device__ __forceinline__ void ul_tick(int i) {
  if (threadIdx.x == 0) {
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    const long long t = clock64();
    atomicAdd(&ul_clk[i], (unsigned long long)(t - ul_tlast[b]));
    ul_tlast[b] = t;
  }
}
"""
CLOCK_READ = """
extern "C" int lmc_clk_read(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, ul_clk, sizeof(unsigned long long) * 32);
  if (e == cudaSuccess && reset) {
    unsigned long long z[32] = {0};
    e = cudaMemcpyToSymbol(ul_clk, z, sizeof(z));
  }
  return (int)e;
}
"""
CLOCK_PATCHES = [
    ("block_common.cuh", "// Elementwise sort", CLOCK_TICK + "\n// Elementwise sort"),
    ("block_common.cuh", "    T[li] = __ldcg(px + k);\n  });\n  __syncthreads();\n",
     "    T[li] = __ldcg(px + k);\n  });\n  __syncthreads();\n  ul_tick(1);\n"),
    ("block_common.cuh", "vv + p.ts * atb[lmc_tile_k(r, c, t)] : vv;\n  });\n  __syncthreads();\n",
     "vv + p.ts * atb[lmc_tile_k(r, c, t)] : vv;\n  });\n  __syncthreads();\n  ul_tick(2);\n"),
    ("block_common.cuh", "  // (3) the Chebyshev sweeps", "  ul_tick(3);\n  // (3) the Chebyshev sweeps"),
    ("block_common.cuh", "    if (p.grow == 0 && sw + 1 < ns) xch(sw);",
     "    ul_tick(4);\n    if (p.grow == 0 && sw + 1 < ns) xch(sw);"),
    ("ulpda_block.cu", "        u[k] = X[lt];\n      }\n      grid.sync();",
     "        u[k] = X[lt];\n      }\n      ul_tick(5);\n      grid.sync();\n      ul_tick(6);"),
    ("ulpda_block.cu", "        X[li] = __ldcg(u + lmc_tile_k(r, c, t));\n      });\n      __syncthreads();",
     "        X[li] = __ldcg(u + lmc_tile_k(r, c, t));\n      });\n      __syncthreads();\n"
     "      ul_tick(7);"),
    ("ulpda_block.cu", "  cg::grid_group grid = cg::this_grid();\n",
     "  cg::grid_group grid = cg::this_grid();\n"
     "  if (threadIdx.x == 0) ul_tlast[blockIdx.y * gridDim.x + blockIdx.x] = clock64();\n"),
    ("ulpda_block.cu", "    float* dst = par ? x0 : x1;\n    if (gfirst) {",
     "    float* dst = par ? x0 : x1;\n    ul_tick(0);\n    if (gfirst) {"),
    ("ulpda_block.cu", "    if (!gfirst) {\n      grid.sync();\n      dual_phase();\n    }",
     "    ul_tick(8);\n    if (!gfirst) {\n      grid.sync();\n      ul_tick(9);\n      dual_phase();\n"
     "      ul_tick(10);\n    }"),
]
CLOCK_PHASES = ("the last grid barrier", "load x, p", "v", "correction", "sweeps",
                "exchange writes", "exchange grid barriers", "exchange reloads", "finish",
                "first grid barrier", "dual phase")


def patched_copy(root, dst, patches):
    """A copy of ``root``'s package under ``dst`` with each ``(file, anchor,
    text[, count])`` of ``patches`` applied: the anchor, found ``count``
    times (default once), replaced by the text; raises if it is not."""
    import shutil

    shutil.copytree(Path(root) / "lmc_atomi_torch", Path(dst) / "lmc_atomi_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = Path(dst) / "lmc_atomi_torch" / "csrc"
    for name, anchor, text, *count in patches:
        src = (csrc / name).read_text()
        if src.count(anchor) != (count[0] if count else 1):
            raise AssertionError(f"anchor {anchor!r} found {src.count(anchor)} times "
                                 f"in {root}/{name}")
        (csrc / name).write_text(src.replace(anchor, text))


def clock_copy(root, dst):
    """A copy of ``root``'s package under ``dst`` with kernel 3's resident
    step timed phase by phase (``CLOCK_PATCHES``, thread 0 of each CTA,
    summed over the CTAs and steps); raises if an anchor is missing."""
    patched_copy(root, dst, CLOCK_PATCHES)
    with open(Path(dst) / "lmc_atomi_torch" / "csrc" / "ulpda_block.cu", "a") as fh:
        fh.write(CLOCK_READ)


def phase_clock(dev, roots):
    """The clock64 phase split of kernel 3's resident step for each checkout
    in ``roots`` (this one by default): per 500-step block at 512² in the
    deconvolution models' TV, MC-TV and ME-TV, on each checkout's route,
    the cycles of a CTA's step by phase (thread 0's view, after its CTA's
    barriers) at the card's maximum SM clock. The ticks add atomics and
    clock reads to every phase, so the block is timed too."""
    import ctypes
    import tempfile

    import numpy as np
    import torch

    from lmc_atomi_torch import _build

    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    _, y, models = make_deconv_models(dev)
    out = np.zeros(32, np.uint64)
    for root in roots or [str(ROOT)]:
        with tempfile.TemporaryDirectory() as tmp:
            clock_copy(root, tmp)
            k3 = load_checkout(tmp, "lmc_atomi_torch.kernels.ulpda_fused",
                               "ulpda_block_update_cuda")
            lib = k3.__globals__["_build"].library()
            lib.lmc_clk_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
            for name, proxf, proxg, _ in models[:3]:
                cfg = dict(gfirst=False, niter_solve=3)
                _run_ulpda_blocks(k3, proxf, proxg, y, BLOCK, BLOCK, cfg, 8)
                torch.cuda.synchronize()
                _build.check(lib.lmc_clk_read(out.ctypes.data, 1), "lmc_clk_read")
                ms, _ = cuda_ms(lambda: _run_ulpda_blocks(k3, proxf, proxg, y, BLOCK, BLOCK,
                                                          cfg, 8))
                _build.check(lib.lmc_clk_read(out.ctypes.data, 1), "lmc_clk_read")
                plan = k3.last_plan
                ctas = -(-N // plan[1]) * -(-N // plan[2])
                per = out[:len(CLOCK_PHASES)].astype(np.float64) / (ctas * BLOCK)
                tot = per.sum()
                log(f"clock {Path(root).resolve().name} {name} {N}^2 on {plan}: {ms:.3f} ms per {BLOCK} "
                    f"steps; a CTA's step {tot:.0f} cycles = {tot / mhz:.2f} us at {mhz:.0f} "
                    "MHz: " + "; ".join(f"{n} {v / tot:.3f} ({v / mhz:.2f} us)"
                                        for n, v in zip(CLOCK_PHASES, per) if v))


KERNELS = {  # wrapper name: (source, TPU kernel it replaces)
    "prox_tv_iso_cuda": ("lmc_atomi_torch/csrc/tv_prox.cu",
                         "lmc_atomi_tpu/ops/tv_pallas.py:91"),
    "myula_tv_block_update_cuda": ("lmc_atomi_torch/csrc/myula_block.cu",
                                   "lmc_atomi_tpu/kernels/myula_fused.py:714"),
    "ulpda_block_update_cuda": ("lmc_atomi_torch/csrc/ulpda_block.cu",
                                "lmc_atomi_tpu/kernels/ulpda_fused.py:327"),
    "wavelet_block_update_cuda": ("lmc_atomi_torch/csrc/wavelet_block.cu",
                                  "lmc_atomi_tpu/kernels/wavelet_fused.py:380"),
    "ulpda_wavelet_block_update_cuda": ("lmc_atomi_torch/csrc/wavelet_block.cu",
                                        "lmc_atomi_tpu/kernels/wavelet_fused.py:608"),
    "myula_tv_tiled_update_cuda": ("lmc_atomi_torch/csrc/tiled_block.cu",
                                   "lmc_atomi_tpu/kernels/myula_tiled.py:416"),
    "ulpda_tv_tiled_update_cuda": ("lmc_atomi_torch/csrc/tiled_block.cu",
                                   "lmc_atomi_tpu/kernels/ulpda_tiled.py:480"),
    "myula_tv_fused_update_cuda": ("lmc_atomi_torch/csrc/tv_prox.cu",
                                   "lmc_atomi_tpu/kernels/myula_pallas.py:91"),
}


def main() -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this script needs a GPU")
        return 1
    if not (ROOT / "lmc_atomi_torch" / "csrc").is_dir():
        log(f"FAIL: no lmc_atomi_torch/csrc beside {Path(__file__).name}")
        return 1
    if sys.argv[1:2] == ["--farm-rank"]:
        farm_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return 0
    if sys.argv[1:2] == ["--image-rank"]:
        image_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return 0
    from lmc_atomi_torch.kernels.myula_cuda import myula_tv_fused_update_cuda
    from lmc_atomi_torch.kernels.myula_fused import myula_tv_block_update_cuda
    from lmc_atomi_torch.kernels.myula_tiled import myula_tv_tiled_update_cuda
    from lmc_atomi_torch.kernels.ulpda_fused import ulpda_block_update_cuda
    from lmc_atomi_torch.kernels.ulpda_tiled import ulpda_tv_tiled_update_cuda
    from lmc_atomi_torch.kernels.wavelet_fused import (
        ulpda_wavelet_block_update_cuda,
        wavelet_block_update_cuda,
    )
    from lmc_atomi_torch.ops.tv_cuda import prox_tv_iso_cuda

    wrappers = {"prox_tv_iso_cuda": prox_tv_iso_cuda,
                "myula_tv_block_update_cuda": myula_tv_block_update_cuda,
                "ulpda_block_update_cuda": ulpda_block_update_cuda,
                "wavelet_block_update_cuda": wavelet_block_update_cuda,
                "ulpda_wavelet_block_update_cuda": ulpda_wavelet_block_update_cuda,
                "myula_tv_tiled_update_cuda": myula_tv_tiled_update_cuda,
                "ulpda_tv_tiled_update_cuda": ulpda_tv_tiled_update_cuda,
                "myula_tv_fused_update_cuda": myula_tv_fused_update_cuda}

    k1, k2, k3, k4, k5, k8 = (prox_tv_iso_cuda, myula_tv_block_update_cuda,
                              ulpda_block_update_cuda, wavelet_block_update_cuda,
                              ulpda_wavelet_block_update_cuda, myula_tv_fused_update_cuda)
    routed = {k: w for k, w in wrappers.items() if hasattr(w, "routes")}
    path_routes = {k: dict.fromkeys(w.routes, 0) for k, w in routed.items()}

    def drive(path, kernels, fn, *args, resident=False, wavelet=False, workers=False):
        """Run one path with every count at 0 before it; its kernels must
        have launched, and with ``resident`` (the 512^2 paths) every kernel-1
        and kernel-2 call and every kernel-3 call but the wl1 dual's must
        have taken the resident route, without it (the large-image path) no
        kernel-2 or kernel-3 call, and every kernel-1 and kernel-8 call the
        cone; with ``wavelet`` (the inpainting path) every kernel-4 and
        kernel-5 call the warp or the resident route. With ``workers`` the
        path's function returns the launches its worker processes counted,
        which add to this process's (the route checks see this process's)."""
        for w in wrappers.values():
            w.launches = 0
        for w in routed.values():
            w.routes = dict.fromkeys(w.routes, 0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ret = fn(*args)
        elsewhere = ret if workers else {}
        counts = {k: w.launches + elsewhere.get(k, 0) for k, w in wrappers.items()}
        log(f"launches on the {path} path ({time.perf_counter() - t0:.1f} s): {counts}; "
            f"kernel 1 routes {k1.routes}; kernel 2 routes {k2.routes}; kernel 3 routes "
            f"{k3.routes}; kernel 4 routes {k4.routes}; kernel 5 routes {k5.routes}; "
            f"kernel 8 routes {k8.routes}")
        for k in kernels:
            if counts[k] < 1:
                raise AssertionError(f"{k} was not launched on the {path} path")
        if resident:
            off = (k2.routes["sequence"] + k3.routes["sequence"] + k1.launches
                   - k1.routes["resident"])
        else:
            off = (k2.routes["resident"] + k3.routes["resident"] + k1.launches
                   - k1.routes["cone"] + k8.launches - k8.routes["cone"])
        if wavelet:
            off += sum(w.routes["tile"] + w.routes["passes"] for w in (k4, k5))
        if off:
            raise AssertionError(f"the {path} path took the routes {k1.routes}, {k2.routes}, "
                                 f"{k3.routes}, {k4.routes}, {k5.routes}, {k8.routes}")
        for k, w in routed.items():
            for r, v in w.routes.items():
                path_routes[k][r] += v
        return counts

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name, _ = phase_device()
    build = PhaseBuild()
    if sys.argv[1:] and sys.argv[1] in ("--turns", "--clock"):
        build.join()
    if sys.argv[1:2] == ["--turns"]:
        phase_turns(dev, {int(k) for k in sys.argv[2].split(",")}, sys.argv[3:])
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if sys.argv[1:2] == ["--clock"]:
        phase_clock(dev, sys.argv[2:])
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    try:
        mixtures = drive("mixtures", (), phase_mixtures, dev)
        log(f"the kernel build {'still runs' if build.thread.is_alive() else 'has ended'} "
            f"as the SG-MCMC path starts ({time.perf_counter() - t_start:.1f} s)")
        sgmcmc = drive("SG-MCMC", (), phase_sgmcmc, dev)
    finally:
        build.thread.join()  # no nvcc outlives the script
    build.join()
    report = {}
    phase_kernel1(dev, report)
    img, y, l2 = make_problem(dev)
    d_img, _, models = make_deconv_models(dev)
    phase_kernel2(dev, l2, y, models, report)
    phase_kernel3(dev, y, models, report)
    phase_kernel45(dev, report)
    phase_kernel678(dev, report)
    phase_chain_kernels(dev, report)
    phase_kernel2_pnp(dev, report)
    phase_kernel1_ct(dev, report)
    log(f"kernel checks done at {time.perf_counter() - t_start:.1f} s")

    pnp_dir = tempfile.TemporaryDirectory()
    pnp_params = str(Path(pnp_dir.name) / "dncnn.pt")
    paths = [
        drive("MYULA main", ("prox_tv_iso_cuda", "myula_tv_block_update_cuda"),
              phase_main_path, dev, img, y, l2, resident=True),
        drive("deconvolution", ("prox_tv_iso_cuda", "myula_tv_block_update_cuda",
                                "ulpda_block_update_cuda"),
              phase_deconv, dev, d_img, models, resident=True),
        drive("inpainting", ("wavelet_block_update_cuda", "ulpda_wavelet_block_update_cuda"),
              phase_inpainting, dev, wavelet=True),
        drive("large image", ("prox_tv_iso_cuda", "myula_tv_block_update_cuda",
                              "ulpda_block_update_cuda", "myula_tv_tiled_update_cuda",
                              "ulpda_tv_tiled_update_cuda", "myula_tv_fused_update_cuda"),
              phase_large, dev),
        drive("multichain", ("myula_tv_block_update_cuda", "ulpda_block_update_cuda",
                             "wavelet_block_update_cuda", "myula_tv_tiled_update_cuda",
                             "ulpda_tv_tiled_update_cuda"),
              phase_multichain, dev, resident=True, wavelet=True),
        mixtures,
        drive("PnP", ("myula_tv_block_update_cuda",), phase_pnp, dev, pnp_params, resident=True),
        drive("PnP farm", ("myula_tv_block_update_cuda",), phase_pnp_farm, dev, pnp_params,
              resident=True),
        drive("CT", ("prox_tv_iso_cuda",), phase_ct, dev, resident=True),
        sgmcmc,
        drive("chain farm", ("myula_tv_block_update_cuda",), phase_farm, dev, resident=True),
        drive("image sharding", ("prox_tv_iso_cuda",), phase_image, dev, resident=True,
              workers=True),
        drive("results", (), phase_results, dev),
    ]
    pnp_dir.cleanup()
    phase_profile(dev, l2, d_img, models)
    phase_profile_kernel1(dev)
    phase_profile_inpainting(dev)
    phase_profile_large(dev)
    phase_profile_multichain(dev)
    phase_profile_mixtures(dev)
    phase_profile_sgmcmc(dev)
    phase_profile_pnp(dev)
    phase_profile_ct(dev)
    kernels = [
        dict(name=k, route="cuda", source=KERNELS[k][0], replaces=KERNELS[k][1],
             launches=sum(p[k] for p in paths), **report[k],
             **({"routes": path_routes[k]} if k in path_routes else {}))
        for k in wrappers
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
