"""Workload 5: the SG-MCMC family on the 25-mode grid mixture (counterpart of
``lmc_atomi_tpu/experiments/sgld_runs.py``; reference jax/sgld.py,
jax/prox_sgld.py).

SGLD, MSGLD, cyclical SGLD and contour SGLD, and the proximal variants
SPGLD, SSGLD, MYSGLD and their cyclical and contour compositions, one chain
each on the tempered grid target, with the importance-resampled CSGLD draws,
a histogram figure of every sampler's draws (``make_plots``, needs
matplotlib) and the summary line of the JAX package's CLI plus
``modes_covered``: the modes with a retained draw within unit distance
(RESULTS.md's coverage count). ``optimize_grid_mixture`` finds the modes by
multi-restart Adam or SGD.

    python -m lmc_atomi_torch.experiments.sgld_runs --k 50000
    python -m lmc_atomi_torch.experiments.sgld_runs --k 200 --device cpu
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from lmc_atomi_torch.experiments.configs import GRID_POSITIONS

# warm-up steps before each timed run, under another key
WARM_STEPS = 20
GRID_MODES = np.array([[a, b] for a in GRID_POSITIONS for b in GRID_POSITIONS])


def modes_covered(samples, modes=GRID_MODES, radius: float = 1.0) -> int:
    """Modes with a draw of ``samples`` (``(n, 2)``) within ``radius`` of
    their centre (RESULTS.md's coverage count)."""
    s = np.asarray(samples, np.float64).reshape(-1, 2)
    near = np.zeros(len(modes), bool)
    for i in range(0, s.shape[0], 8192):
        d2 = ((s[i:i + 8192, None, :] - modes[None]) ** 2).sum(-1)
        near |= (d2 < radius * radius).any(0)
    return int(near.sum())


def chain_modes_covered(samples, modes=GRID_MODES, radius: float = 1.0):
    """``modes_covered`` of each chain of ``samples`` (``(C, n, 2)``), as an
    int array of ``C``."""
    s = np.asarray(samples, np.float64)
    out = np.zeros(s.shape[0], np.int64)
    for i in range(0, s.shape[0], 64):
        d2 = ((s[i:i + 64, :, None, :] - modes) ** 2).sum(-1)
        out[i:i + 64] = (d2 < radius * radius).any(1).sum(-1)
    return out


def grid_kernels(gm, k: int, alpha: float = 1.0, moreau_lam: float = 0.1,
                 msgld_step_scale: float = 8.0, prox_step_scale: float = 8.0,
                 zeta: float = 0.75, sz: float = 10.0, temperature: float = 50.0,
                 num_partitions: int = 100000, energy_gap: float = 0.25,
                 include_prox: bool = True):
    """The workload's samplers on ``gm`` for a run of ``k`` steps, by name,
    as the JAX CLI builds them: the reference schedule ``0.05 (k+1)^-0.55``
    for SGLD, ``msgld_step_scale`` (``prox_step_scale``) times it for MSGLD
    (the proximal kernels), 30 cycles of the 0.09 cosine for the cyclical
    ones, and the contour ones at lr 1e-3 with ``sz`` times the reference's
    stochastic-approximation schedule. The proximal kernels target the
    mixture times Laplace(alpha): SPGLD's prox is step-scaled (threshold
    ``g / alpha``), MYSGLD's and SSGLD's Moreau pieces keep the constant
    smoothing ``moreau_lam``."""
    from lmc_atomi_torch.kernels import sgmcmc as S
    from lmc_atomi_torch.ops.prox import prox_laplace

    sched = S.polynomial_schedule(0.05, -0.55)
    prox_fn = lambda x, g: prox_laplace(x, g / alpha)
    prox_my = lambda x: prox_laplace(x, moreau_lam / alpha)
    moreau_grad = lambda x: (x - prox_my(x)) / moreau_lam
    sa_sched = lambda step: min(1e-2, (step + 100.0) ** (-0.8)) * sz
    contour = dict(num_partitions=num_partitions, energy_gap=energy_gap, zeta=zeta,
                   temperature=temperature, lr_schedule=1e-3, sa_schedule=sa_sched)
    kernels = {
        "SGLD": S.sgld(gm.grad_log_prob, sched),
        "MSGLD": S.msgld(gm.log_prob, gm.grad_log_prob,
                         S.polynomial_schedule(0.05 * msgld_step_scale, -0.55)),
        "cyclicalSGLD": S.cyclical_sgld(gm.grad_log_prob, k, 30, 0.09, 0.25),
        "contourSGLD": S.csgld(gm.log_prob, **contour),
    }
    if include_prox:
        sched_p = S.polynomial_schedule(0.05 * prox_step_scale, -0.55)
        kernels.update({
            "SPGLD": S.spgld(gm.grad_log_prob, prox_fn, sched_p),
            "SSGLD": S.ssgld(gm.grad_log_prob, moreau_grad, sched_p),
            "MYSGLD": S.mysgld(gm.grad_log_prob, prox_my, moreau_lam, sched_p),
            "cyclicalSPGLD": S.cyclical_spgld(gm.grad_log_prob, prox_fn, k, 30, 0.09, 0.25),
            "contourSPGLD": S.contour_spgld(gm.log_prob, prox_fn, **contour),
        })
    return kernels


def grid_setup(k: int, seed: int, dev, lamda: float = 1 / 25.0, sigma: float = 0.03,
               **kernel_kw):
    """The workload's f32 target on ``dev``, its start (uniform in [-10,
    10]^2 under ``seed``, the reference's) and its samplers for a run of
    ``k`` steps (``grid_kernels`` with ``kernel_kw``), as the CLI builds
    them."""
    from lmc_atomi_torch.core.random import uniform_field
    from lmc_atomi_torch.models import GridGaussianMixture

    gm = GridGaussianMixture.create(GRID_POSITIONS, sigma=sigma, lam=lamda,
                                    dtype=torch.float32, device=dev)
    x0 = -10 + 20 * uniform_field(seed, 0, 0, (2,), torch.float32, dev)
    return gm, x0, grid_kernels(gm, k, **kernel_kw)


def retained(name: str, res, zeta: float):
    """The draws the workload keeps of a one-chain result, as numpy: the
    sampling-phase steps of a cyclical kernel (reference
    jax/sgld.py:320-322), a contour kernel's importance resample where it
    holds more than 100 draws, every draw otherwise."""
    from lmc_atomi_torch.kernels.sgmcmc import csgld_importance_resample

    s = res.samples.cpu().numpy()
    if name.startswith("cyclical"):
        return s[np.array([bool(i.accepted) for i in res.infos], bool)]
    if name.startswith("contour"):
        rs = csgld_importance_resample(s, res.extras.cpu().numpy(),
                                       res.final_state.extras.energy_pdf.cpu().numpy(),
                                       zeta=zeta)
        return rs if rs.shape[0] > 100 else s
    return s


def sgld_grid_mixture(
    lamda: float = 1 / 25.0,
    sigma: float = 0.03,
    alpha: float = 1.0,
    moreau_lam: float = 0.1,
    k: int = 50000,
    msgld_step_scale: float = 8.0,
    prox_step_scale: float = 8.0,
    zeta: float = 0.75,
    sz: float = 10.0,
    temperature: float = 50.0,
    num_partitions: int = 100000,
    energy_gap: float = 0.25,
    seed: int = 0,
    include_prox: bool = True,
    outdir: str = "fig",
    make_plots: bool = False,
    device: str = "cuda",
):
    """Run the SG-MCMC samplers on the 25-mode grid mixture, one chain of
    ``k`` steps each from one start uniform in [-10, 10]^2 (the
    reference's), sampler ``i`` under ``fold_in(seed, i)``; f32. Returns
    ``(samples, summary)``, the retained draws as numpy arrays."""
    from lmc_atomi_torch.core.random import fold_in
    from lmc_atomi_torch.run.runner import run_chain
    from lmc_atomi_torch.utils.cli import require_device

    dev = require_device(device, "SG-MCMC grid-mixture")
    gm, x0, kernels = grid_setup(
        k, seed, dev, lamda, sigma, alpha=alpha, moreau_lam=moreau_lam,
        msgld_step_scale=msgld_step_scale, prox_step_scale=prox_step_scale, zeta=zeta, sz=sz,
        temperature=temperature, num_partitions=num_partitions, energy_gap=energy_gap,
        include_prox=include_prox)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    samples, timings = {}, {}
    for i, (name, kern) in enumerate(kernels.items()):
        # the contour kernels keep the energy bin of each step, not the pdf
        extras = (lambda e: e.energy_idx) if name.startswith("contour") else False
        run_chain(kern, x0, fold_in(seed + 1, i), min(k, WARM_STEPS), collect_extras=extras)
        sync()
        t0 = time.perf_counter()
        res = run_chain(kern, x0, fold_in(seed, i), k, collect="samples",
                        collect_extras=extras)
        sync()
        timings[name] = time.perf_counter() - t0
        samples[name] = retained(name, res, zeta)
        print(f"{name}: {samples[name].shape[0]} retained draws, "
              f"{k / timings[name]:.0f} iters/s", file=sys.stderr)

    if make_plots:
        from lmc_atomi_torch.experiments import figures as F

        F.ensure_outdir(outdir)
        grid = np.linspace(-8, 8, 200)
        xg, yg = np.meshgrid(grid, grid)
        pos = torch.as_tensor(np.stack([xg, yg], -1).reshape(-1, 2), dtype=torch.float32,
                              device=dev)
        z = torch.exp(gm.log_prob(pos)).cpu().numpy().reshape(xg.shape)
        F.sample_grid(xg, yg, z, samples, f"{outdir}/fig_sgld_grid_{k}_hist.pdf",
                      mode="hist", lim=8.0)

    summary = {
        "workload": "sgld_grid_mixture",
        "k": k,
        "iters_per_sec": {m: round(k / t, 1) for m, t in timings.items()},
        "retained": {m: int(v.shape[0]) for m, v in samples.items()},
        "modes_covered": {m: modes_covered(v) for m, v in samples.items()},
    }
    print(json.dumps(summary))
    return samples, summary


def solve_restarts(gm, x0, steps: int = 2000, optimizer: str = "adam",
                   lr: float = 0.05):
    """``steps`` of ``torch.optim.Adam`` or ``SGD`` (defaults, not fused) on
    ``-log_prob`` from the starts ``x0`` ``(n_restarts, 2)``, one parameter
    for all restarts: each restart's loss depends only on its row and the
    optimisers are elementwise, so this is the JAX package's vmap over
    restarts. The gradient is the target's written-out ``-grad_log_prob``
    (the JAX package's ``jax.grad``; a third of autograd's launches).
    Returns the final points and their log-probabilities."""
    x = torch.nn.Parameter(torch.as_tensor(x0).clone())
    opt = {"adam": torch.optim.Adam, "sgd": torch.optim.SGD}[optimizer]([x], lr=lr)
    for _ in range(steps):
        x.grad = -gm.grad_log_prob(x.detach())
        opt.step()
    x = x.detach()
    return x, gm.log_prob(x)


def optimize_grid_mixture(
    lamda: float = 1 / 25.0,
    sigma: float = 0.03,
    steps: int = 2000,
    n_restarts: int = 64,
    optimizer: str = "adam",
    lr: float = 0.05,
    seed: int = 0,
    device: str = "cuda",
):
    """Multi-restart mode finding on the grid target (reference
    jax/sgld_opt.py): ``n_restarts`` starts uniform in [-10, 10]^2, each
    optimised for ``steps`` steps (``solve_restarts``), and the distinct
    recovered modes, snapped to the grid. Returns ``(xs, logps, summary)``
    as numpy arrays and the summary line."""
    from lmc_atomi_torch.core.random import uniform_field
    from lmc_atomi_torch.models import GridGaussianMixture
    from lmc_atomi_torch.utils.cli import require_device

    dev = require_device(device, "grid-mixture optimisation")
    gm = GridGaussianMixture.create(GRID_POSITIONS, sigma=sigma, lam=lamda,
                                    dtype=torch.float32, device=dev)
    x0 = -10 + 20 * uniform_field(seed, 0, 0, (n_restarts, 2), torch.float32, dev)
    xs, logps = solve_restarts(gm, x0, steps, optimizer, lr)
    xs, logps = xs.cpu().numpy(), logps.cpu().numpy()
    snapped = np.round(xs / 2.0) * 2.0
    modes = {tuple(m) for m in snapped if np.abs(m).max() <= 4.0}
    summary = {
        "workload": "grid_mixture_optimization",
        "optimizer": optimizer,
        "restarts": n_restarts,
        "modes_found": len(modes),
        "best_logprob": float(logps.max()),
    }
    print(json.dumps(summary))
    return xs, logps, summary


def main():
    from lmc_atomi_torch.utils.cli import auto_cli

    auto_cli(sgld_grid_mixture)


if __name__ == "__main__":
    main()
