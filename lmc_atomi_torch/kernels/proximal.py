"""Proximal Langevin kernels on composite targets (counterpart of
``lmc_atomi_tpu/kernels/proximal.py``).

The six kernels of the reference ``ProximalLangevinMonteCarlo``
(prox_lmc.py:99-255), PGLD, MYULA, MYMALA, PP-ULA, FBULA and LBMUMLA, for
targets ``smooth potential + alpha ||theta - mu||_1``: the target object
(``models.MixtureWithLaplacePrior``) gives ``grad_smooth_potential``,
``prior_prox``, ``grad_moreau_prior`` and the log densities. PP-ULA's
dual fixed point runs a fixed ``t`` trips a step (prox_lmc.py:165-173).

Every kernel takes a chain axis (``Kernel.chain_axis``, see
``kernels/langevin.py``): the targets batch over leading axes.
"""
from __future__ import annotations

import torch

from lmc_atomi_torch.core.state import StepInfo
from lmc_atomi_torch.kernels.base import Kernel, stepsize_at
from lmc_atomi_torch.kernels.langevin import (
    StepNoise,
    _init,
    _lead,
    _sqrt,
    mh_step,
    sq_dev,
    sqrtm_psd,
)
from lmc_atomi_torch.ops.batched import matvec
from lmc_atomi_torch.ops.bregman import (
    bregman_moreau_env_grad_l1_hypent,
    grad_conjugate_mirror_hyp,
    grad_mirror_hyp,
)
from lmc_atomi_torch.ops.prox import prox_laplace

__all__ = ["pgld", "myula", "mymala", "ppula", "fbula", "lbmumla"]


def pgld(target, gamma) -> Kernel:
    """Proximal Gradient Langevin Dynamics (reference prox_lmc.py:98-110):
    prox the state, then one ULA step from the proxed point."""
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(gamma, state.step)
        p = target.prior_prox(state.position)  # prox_{lam alpha l1}
        x = p - g * target.grad_smooth_potential(p) + _sqrt(2 * g) * noise.normal(key, p)
        return state.next(x), StepInfo()

    return Kernel(_init, step, chain_axis=True)


def _my_drift(target, x, g):
    return x - g * target.grad_smooth_potential(x) - g * target.grad_moreau_prior(x)


def myula(target, gamma) -> Kernel:
    """Moreau-Yosida ULA (reference prox_lmc.py:113-130): the ULA drift plus
    the prior's Moreau-envelope gradient, (theta - prox)/lam."""
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(gamma, state.step)
        x = state.position
        return (state.next(_my_drift(target, x, g) + _sqrt(2 * g) * noise.normal(key, x)),
                StepInfo())

    return Kernel(_init, step, chain_axis=True)


def mymala(target, gamma) -> Kernel:
    """The MYULA proposal with a Metropolis filter against the exact
    nonsmooth product density (reference prox_lmc.py:133-158), in log
    space, per chain (``langevin.mh_step``)."""
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(gamma, state.step)
        x = state.position
        lead = _lead(key)

        def log_q(x_to, mean):
            return -sq_dev(x_to - mean, lead) / (4.0 * g)

        mean = _my_drift(target, x, g)  # the forward mean, once
        prop = mean + _sqrt(2 * g) * noise.normal(key, x)
        return mh_step(state, key, noise, prop, target.log_density,
                       log_q(x, _my_drift(target, prop, g)), log_q(prop, mean))

    return Kernel(_init, step, chain_axis=True)


def ppula(target, gamma, m, q, t: int = 100) -> Kernel:
    """Preconditioned proximal ULA (reference prox_lmc.py:161-188).

    Drift ``theta - g M grad U(theta) - g Q^{-1}(theta - pprox(theta))/lam``,
    noise ``sqrt(2g) sqrtm(M) xi``; ``pprox`` is the Q-preconditioned prox
    of the l1 prior from ``t`` trips of the dual fixed point. ``m`` and ``q``
    on the chain's device save copies a step."""
    m = torch.as_tensor(m)
    q = torch.as_tensor(q)
    sqrt_m = sqrtm_psd(m)
    q_inv = torch.linalg.inv(q)
    # rho = 1/||Q||_2, the largest singular value (reference prox_lmc.py:166)
    rho = 1.0 / float(torch.linalg.matrix_norm(q, ord=2))
    eta = rho - max(min(1.0, rho) - 1e-5, 1e-9)
    noise = StepNoise()

    def preconditioned_prox(x, gam, qx):
        w = torch.zeros_like(x)
        u = torch.zeros_like(x)
        thr = gam / eta  # once, not a launch a trip
        for _ in range(t):
            u = x - matvec(qx, w)
            w = w + eta * u - eta * prox_laplace(w / eta + u, thr)
        return u

    def step(state, key):
        g = stepsize_at(gamma, state.step)
        x = state.position
        pprox = preconditioned_prox(x, target.lam, q.to(x))
        prox_term = -g * matvec(q_inv.to(x), x - pprox) / target.lam
        drift = x - g * matvec(m.to(x), target.grad_smooth_potential(x)) + prox_term
        xi = noise.normal(key, x)
        return state.next(drift + _sqrt(2 * g) * matvec(sqrt_m.to(x), xi)), StepInfo()

    return Kernel(_init, step, chain_axis=True)


def fbula(target, gamma) -> Kernel:
    """Forward-backward envelope ULA (reference prox_lmc.py:191-208): one
    ULA step on grad FB-env = (I - lam hess U)(theta - prox_{lam alpha}(theta
    - lam grad U(theta)))/lam."""
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(gamma, state.step)
        x = state.position
        lam = target.lam
        inner = (x - target.prior_prox(x - lam * target.grad_smooth_potential(x))) / lam
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        jac = eye - lam * target.hess_smooth_potential(x)
        drift = x - g * matvec(jac, inner)
        return state.next(drift + _sqrt(2 * g) * noise.normal(key, x)), StepInfo()

    return Kernel(_init, step, chain_axis=True)


def lbmumla(target, gamma, beta, sigma) -> Kernel:
    """Left-Bregman-Moreau unadjusted mirror-Langevin (reference
    prox_lmc.py:211-255): a mirror step under hyperbolic entropy with the
    Bregman-Moreau envelope gradient of the l1 prior (the closed-form
    three-branch Bregman prox), pulled back through ``beta sinh``."""
    beta = torch.as_tensor(beta)
    sigma = torch.as_tensor(sigma)
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(gamma, state.step)
        x = state.position
        b = beta.to(x)
        breg_grad = bregman_moreau_env_grad_l1_hypent(x, sigma.to(x), target.lam,
                                                      target.prior.alpha)
        dual = (grad_mirror_hyp(x, b) - g * target.grad_smooth_potential(x) - g * breg_grad
                + _sqrt(2 * g) * torch.rsqrt(torch.sqrt(x * x + b * b)) * noise.normal(key, x))
        return state.next(grad_conjugate_mirror_hyp(dual, b)), StepInfo()

    return Kernel(_init, step, chain_axis=True)
