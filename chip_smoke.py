#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device: the card, its power limit, and the torch/CUDA/nvcc versions;
2. build: both CUDA kernels from ``lmc_atomi_torch/csrc`` (at first use);
3. kernel 1 (``prox_tv_iso_cuda``) against its plain torch version at 512^2;
4. kernel 2 (``myula_tv_block_update_cuda``) against its plain version at
   512^2, 40 steps in blocks of 20, noise on (the same Philox stream on both
   sides), for cold-10 Chambolle, FGP-8, warm-5 and cold-10 with 95% CI
   markers; then both timed per solver with CUDA events;
5. the main path, the 512^2 MYULA TV-deblur posterior of ``bench.py``
   (phantom, 5x5 uniform blur, noise 0.75, TV weight 0.3), 20000 steps:
   ``run_myula_tv_fused`` for FGP-8, cold-10, warm-5 and cold-10 with 95% CI
   maps, then the unfused ``run_chain(myula_imaging)`` with kernel 1 inside.
   Each is warmed up with another seed and timed; the posterior-mean PSNR
   must reach 40 dB and agree with the unfused path within 0.1 dB.

It then prints one JSON line describing each kernel (launch counts from the
main path only) and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N = 512
STEPS = 20000
BLOCK = 500
SIGMA_NOISE = 0.75
TV_WEIGHT = 0.3
CHECK_STEPS, CHECK_BLOCK = 40, 20
PLAIN_STEPS = 2000
# kernel 2 vs its plain version after 40 steps, for every field: the gate of
# tests/test_myula_fused.py:89-92, atol = 3e-5 * max(1, max |field|). On the
# H100 the two agree bit for bit (max_abs_err 0): both take the same float
# operations in the same order, and the library is built with --fmad=false.
REL_TOL = 3e-5
PSNR_FLOOR = 40.0
PSNR_GAP = 0.1

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
    # stated for the record: no TF32 anywhere (the port has no matmul or conv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi


def phase_build():
    from lmc_atomi_torch import _build

    t0 = time.perf_counter()
    lib = _build.library()
    log(f"build: {lib._name} in {time.perf_counter() - t0:.2f} s")


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


def phase_kernel1(dev, report):
    import torch

    from lmc_atomi_torch.ops.tv_cuda import prox_tv_iso_cuda, prox_tv_iso_ref

    gen = torch.Generator(device=dev).manual_seed(3)
    x = 100.0 + 50.0 * torch.randn((N, N), generator=gen, device=dev)
    gamma = TV_WEIGHT * SIGMA_NOISE**2
    got = prox_tv_iso_cuda(x, gamma, niter=10)
    want = prox_tv_iso_ref(x, gamma, niter=10)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = 1e-4 * max(1.0, float(x.abs().max()))
    ms, _ = cuda_ms(lambda: prox_tv_iso_cuda(x, gamma, niter=10), 200)
    plain_ms, _ = cuda_ms(lambda: prox_tv_iso_ref(x, gamma, niter=10), 50)
    log(f"kernel1 prox_tv_iso_cuda {N}^2 niter=10: max_abs_err={err:.3e} "
        f"(tol {tol:.3e}) {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call")
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"kernel 1 disagrees with its plain version: {err} > {tol}")
    report["prox_tv_iso_cuda"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def _run_blocks(update, l2, x0, n_steps, block, cfg, seed):
    """run_myula_tv_fused's block loop, with the block update passed in (the
    kernel or its plain version) so both run on the card."""
    import torch

    from lmc_atomi_torch.kernels.myula_fused import _fused_params, _pack_scal_f

    taps, (oy, ox), atbs = _fused_params(l2)
    gamma = SIGMA_NOISE**2
    scal_f = _pack_scal_f(l2, 0.2 * gamma, gamma, TV_WEIGHT, 1.0)
    cfg = dict(cfg)
    burn = cfg.pop("burn_in", 0)
    qs = cfg.get("quantiles", ())
    x, mean, m2 = x0, torch.zeros_like(x0), torch.zeros_like(x0)
    qh = qn = None
    if qs:
        qh = torch.zeros((5 * len(qs), N, N), device=x0.device)
        qn = torch.arange(2.0, 5.0, device=x0.device)[:, None, None].repeat(len(qs), N, N)
    for b in range(n_steps // block):
        step0 = b * block
        x, mean, m2, qh, qn = update(
            x, atbs, mean, m2, (seed, 0), scal_f, (step0, burn, max(step0 - burn, 0)),
            qh, qn, taps=taps, oy=oy, ox=ox, n_steps=block, **cfg)
    return x, mean, m2, qh, qn


def phase_kernel2(dev, l2, y, report):
    import torch

    from lmc_atomi_torch.kernels.myula_fused import (
        myula_tv_block_update_cuda,
        myula_tv_block_update_ref,
    )

    worst = 0.0
    for name, cfg in SOLVERS.items():
        cfg = dict(cfg, burn_in=10) if "quantiles" in cfg else dict(cfg)
        got = _run_blocks(myula_tv_block_update_cuda, l2, y, CHECK_STEPS,
                            CHECK_BLOCK, cfg, seed=7)
        want = _run_blocks(myula_tv_block_update_ref, l2, y, CHECK_STEPS,
                             CHECK_BLOCK, cfg, seed=7)
        torch.cuda.synchronize()
        parts = []
        for field, g, w in zip(("x", "mean", "m2", "qh", "qn"), got, want):
            if w is None:
                continue
            err = float((g - w).abs().max())
            tol = REL_TOL * max(1.0, float(w.abs().max()))
            parts.append(f"{field}={err:.3e}/{tol:.1e}")
            if not math.isfinite(err) or err > tol:
                raise AssertionError(f"kernel 2 ({name}) {field}: {err} > {tol}")
            worst = max(worst, err)
        log(f"kernel2 {name} {N}^2 {CHECK_STEPS} steps, noise on: max_abs_err "
            + " ".join(parts))
    # device time per 500-step call, kernel and plain version, per solver
    times = {}
    for name, cfg in SOLVERS.items():
        cfg = dict(cfg, burn_in=10) if "quantiles" in cfg else dict(cfg)
        reps = PLAIN_STEPS // BLOCK
        k_ms, _ = cuda_ms(lambda: _run_blocks(
            myula_tv_block_update_cuda, l2, y, BLOCK, BLOCK, cfg, seed=8), reps)
        p_ms, _ = cuda_ms(lambda: _run_blocks(
            myula_tv_block_update_ref, l2, y, BLOCK, BLOCK, cfg, seed=8), reps)
        times[name] = (k_ms, p_ms)
        log(f"kernel2 {name} timing ({PLAIN_STEPS} steps): kernel "
            f"{BLOCK / k_ms * 1e3:.1f} iters/s, plain {BLOCK / p_ms * 1e3:.1f} iters/s")
    k_ms, p_ms = times["cold10"]
    report["myula_tv_block_update_cuda"] = dict(max_abs_err=worst, ms=k_ms, plain_ms=p_ms)


def phase_main_path(dev, img, y, l2):
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

    def check_and_report(name, out, ms, wall):
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
        log(f"main {name}: {STEPS / ms * 1e3:.1f} iters/s (device {ms:.1f} ms, "
            f"host {wall:.3f} s) psnr_mean={p:.4f} psnr_blurred={blur_psnr:.4f}"
            f"{extra} mem_used='{nvidia_smi('memory.used')}' "
            f"max_alloc={torch.cuda.max_memory_allocated() / 2**20:.1f}MiB")
        return p

    def timed(run):
        run(1)  # warm-up at the same step count, another seed
        t0 = time.perf_counter()
        ms, out = cuda_ms(lambda: run(2))
        return out, ms, time.perf_counter() - t0

    psnrs = {}
    for name, cfg in SOLVERS.items():
        cfg = dict(cfg, burn_in=2000) if "quantiles" in cfg else cfg
        out, ms, wall = timed(lambda seed: run_myula_tv_fused(
            l2, TV_WEIGHT, tau, gamma, x0, seed, STEPS, block=BLOCK, **cfg))
        psnrs[name] = check_and_report(name, out, ms, wall)
    kern = myula_imaging(l2, TVNorm(sigma=TV_WEIGHT, niter=10), tau=tau, gamma=gamma)
    out, ms, wall = timed(lambda seed: run_chain(kern, x0, seed, STEPS, collect="stats"))
    unfused = check_and_report("unfused_cold10", out, ms, wall)
    for name in ("fgp8", "cold10", "warm5"):
        if psnrs[name] < PSNR_FLOOR or abs(psnrs[name] - unfused) > PSNR_GAP:
            raise AssertionError(
                f"{name}: psnr {psnrs[name]:.4f} (floor {PSNR_FLOOR}, unfused "
                f"{unfused:.4f}, gap {PSNR_GAP})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this script needs a GPU")
        return 1
    if not (ROOT / "lmc_atomi_torch" / "csrc").is_dir():
        log(f"FAIL: no lmc_atomi_torch/csrc beside {Path(__file__).name}")
        return 1
    from lmc_atomi_torch.kernels.myula_fused import myula_tv_block_update_cuda
    from lmc_atomi_torch.ops.tv_cuda import prox_tv_iso_cuda

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name, _ = phase_device()
    phase_build()
    report = {}
    phase_kernel1(dev, report)
    img, y, l2 = make_problem(dev)
    phase_kernel2(dev, l2, y, report)

    wrappers = {"prox_tv_iso_cuda": prox_tv_iso_cuda,
                "myula_tv_block_update_cuda": myula_tv_block_update_cuda}
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    phase_main_path(dev, img, y, l2)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    log(f"launches on the main path: {launches}")
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f"{k} was not launched on the main path")

    meta = {
        "prox_tv_iso_cuda": ("lmc_atomi_torch/csrc/tv_prox.cu",
                             "lmc_atomi_tpu/ops/tv_pallas.py:91"),
        "myula_tv_block_update_cuda": ("lmc_atomi_torch/csrc/myula_block.cu",
                                       "lmc_atomi_tpu/kernels/myula_fused.py:714"),
    }
    kernels = [
        dict(name=k, route="cuda", source=meta[k][0], replaces=meta[k][1],
             launches=launches[k], **report[k])
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
