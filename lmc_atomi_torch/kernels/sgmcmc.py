"""Stochastic-gradient Langevin family (counterpart of
``lmc_atomi_tpu/kernels/sgmcmc.py``; reference jax/sgld.py, jax/prox_sgld.py).

SGLD, MSGLD, cyclical SGLD, contour SGLD (CSGLD) and the proximal variants
SPGLD, SSGLD, MYSGLD with their cyclical and contour compositions, as
``Kernel(init, step)`` factories with the JAX package's names, signatures and
semantics. Known reference defects are not mirrored, as in the JAX package:
single-key reuse (jax/lmc_jax.py:111-114), MSGLD's raw logprob ratio
(jax/sgld.py:190-229) and MYSGLD's ``gamma - prox`` typo
(jax/prox_sgld.py:236). CSGLD's ``mult_clip`` and its pdf floor at 1e-30 are
the JAX package's stabilisations, kept.

Conventions: kernels ascend ``grad_fn = grad log pi`` (``x + g grad +
sqrt(2 g) xi``); step sizes come from ``stepsize_at`` specs.

Keys and draws. A step's key is ``(seed, chain, step)`` (``kernels/base.py``)
and its draws are three Philox streams that never share a counter: the
noise is ``normal_field`` (counter word 2 = 0), MSGLD's accept draw
``uniform_scalar`` (word 2 = 1) and ``minibatch_grad_estimator``'s choice of
the batch the ``argsort`` of a ``uniform_field`` of the data's length (word
2 = 2); the keyed ``grad_fn(x, key)`` of the other kernels receives the step
key and draws on that last counter too, the only draw of word 2 = 2 in a
step. These stand for the JAX package's ``jax.random.split`` of the step
key; the streams differ from threefry's.

Every kernel takes a chain axis (``Kernel.chain_axis``): with ``chain`` a
tensor of ``C`` words the position is ``(C, ...)`` and row ``i`` is the
one-chain step under word ``i``, bit for bit where the target batches so
(``models.GridGaussianMixture`` does). A step never waits for the card:
MSGLD accepts through ``torch.where``, the cyclical phase is a host branch
on ``state.step`` (a Python int), and CSGLD's energy bin is an int64 tensor
that reads the pdf with ``gather`` and writes it with ``scatter_add_``.
"""
from __future__ import annotations

import inspect
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from lmc_atomi_torch.core.random import uniform_field
from lmc_atomi_torch.core.state import SamplerState, StepInfo
from lmc_atomi_torch.kernels.base import Kernel, stepsize_at
from lmc_atomi_torch.kernels.langevin import StepNoise, _init, _lead, _sqrt, mh_step

__all__ = [
    "polynomial_schedule",
    "cyclical_cosine_schedule",
    "minibatch_grad_estimator",
    "sgld",
    "msgld",
    "cyclical_sgld",
    "csgld",
    "csgld_importance_resample",
    "spgld",
    "ssgld",
    "mysgld",
    "cyclical_spgld",
    "contour_spgld",
]


def polynomial_schedule(a: float = 0.05, b: float = -0.55):
    """gamma_k = a * (k+1)^b, the reference's SGLD schedule
    (jax/sgld.py:131-132, 1-indexed)."""

    def fn(step):
        return a * (step + 1.0) ** b

    return fn


def cyclical_cosine_schedule(
    n_steps: int,
    num_cycles: int = 4,
    initial_step_size: float = 1e-3,
    exploration_ratio: float = 0.25,
):
    """Cosine cyclical schedule (reference jax/sgld.py:236-248): returns
    ``fn(step) -> (step_size, do_sample)``, a Python float and bool of the
    step. In float32, as the JAX package computes it (its int32 step over
    the cycle length divides to float32): the step size is a float32 value.
    """
    cycle_length = n_steps // num_cycles

    def fn(step):
        pos = np.float32(step % cycle_length) / np.float32(cycle_length)
        do_sample = bool(pos >= np.float32(exploration_ratio))
        step_size = (np.float32(0.5) * (np.cos(np.float32(math.pi) * pos) + np.float32(1.0))
                     * np.float32(initial_step_size))
        return float(step_size), do_sample

    return fn


def _grad_sum(fn: Callable, x):
    """The gradient of ``sum(fn(x))`` at ``x`` (each chain's own gradient
    where ``fn`` maps a chain axis to one value a chain) and ``fn(x)``."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        val = fn(xg)
        (grad,) = torch.autograd.grad(val.sum(), xg)
    return grad, val.detach()


def minibatch_grad_estimator(
    logprior_fn: Callable,
    loglik_fn: Callable,
    data,
    data_size: int,
    batch_size: Optional[int] = None,
):
    """Unbiased posterior score estimator (the blackjax
    ``gradients.grad_estimator`` contract, reference jax/prox_sgld.py:131):
    ``grad logprior(x) + (N / n) sum_batch grad loglik``.

    Returns ``grad_fn(position, key)``; with ``data=None`` the likelihood is
    taken as already full-batch and scaled by ``data_size`` (the reference's
    use, where loglik ignores the minibatch). Otherwise the batch is the
    first ``batch_size`` entries of a permutation keyed by the step key: the
    ``argsort`` (stable) of ``uniform_field`` of the key over the data, in
    place of ``jax.random.choice(..., replace=False)``. Over a chain axis
    each chain draws its own batch, and the gradients run under
    ``torch.func.vmap`` over the chains.
    """

    if data is None:

        def grad_fn(x, key):
            del key
            return (_grad_sum(logprior_fn, x)[0]
                    + data_size * _grad_sum(loglik_fn, x)[0])

        return grad_fn

    data = torch.as_tensor(data)
    n = data.shape[0]
    bs = batch_size or n
    grad = torch.func.grad

    def one(x, batch):
        lik = lambda xx: torch.sum(torch.func.vmap(lambda d: loglik_fn(xx, d))(batch))
        return grad(logprior_fn)(x) + (data_size / bs) * grad(lik)(x)

    def grad_fn(x, key):
        seed, chain, step = key
        u = uniform_field(seed, chain, step, (n,), torch.float32, x.device)
        idx = torch.argsort(u, dim=-1, stable=True)[..., :bs]
        batch = data.to(x.device)[idx]
        return torch.func.vmap(one)(x, batch) if _lead(key) else one(x, batch)

    return grad_fn


def _nparams(fn: Callable) -> int:
    """Parameters of ``fn``'s signature (1 where there is none to read): a
    ``*args`` counts as one, as in the JAX package's rule."""
    try:
        return len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return 1


def _as_keyed_grad(grad_fn: Callable) -> Callable:
    """Accept both grad_fn(x) and grad_fn(x, key)."""
    if _nparams(grad_fn) >= 2:
        return grad_fn
    return lambda x, key: grad_fn(x)


def _as_stepped_prox(prox_fn: Callable) -> Callable:
    """Normalize a prior prox to the ``(x, g) -> x`` contract: a prox of two
    parameters receives the current step size (``prox_{g f}``, whose
    threshold scales with the step), one of one parameter is applied as it
    is (a constant threshold, whose implied prior weight grows as the
    schedule decays; see the JAX package's note)."""
    if _nparams(prox_fn) >= 2:
        return prox_fn
    return lambda x, g: prox_fn(x)


def _sgld_move(state, key, noise, gf, g):
    """``x + g grad + sqrt(2 g) xi``."""
    x = state.position
    return x + g * gf(x, key) + _sqrt(2 * g) * noise.normal(key, x)


def sgld(grad_fn: Callable, schedule) -> Kernel:
    """SGLD: x <- x + g grad log pi + sqrt(2 g) xi (reference
    jax/sgld.py:120-165 via blackjax.sgld)."""
    gf = _as_keyed_grad(grad_fn)
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(schedule, state.step)
        return state.next(_sgld_move(state, key, noise, gf, g)), StepInfo()

    return Kernel(_init, step, chain_axis=True)


def msgld(logprob_fn: Callable, grad_fn: Callable, schedule) -> Kernel:
    """Metropolized SGLD (reference jax/sgld.py:169-229): the SGLD proposal
    and a density-ratio filter in log space, per chain
    (``langevin.mh_step`` with no proposal terms)."""
    gf = _as_keyed_grad(grad_fn)
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(schedule, state.step)
        prop = _sgld_move(state, key, noise, gf, g)
        return mh_step(state, key, noise, prop, logprob_fn, 0.0, 0.0)

    return Kernel(_init, step, chain_axis=True)


def cyclical_sgld(
    grad_fn: Callable,
    n_steps: int,
    num_cycles: int = 4,
    initial_step_size: float = 1e-3,
    exploration_ratio: float = 0.25,
    prox_fn: Optional[Callable] = None,
) -> Kernel:
    """Cyclical SG-MCMC (reference jax/sgld.py:232-326): cosine step sizes;
    the exploration phase is plain gradient ascent, the sampling phase SGLD.
    The phase is a function of ``state.step`` alone, so the switch (the JAX
    package's ``lax.cond``) is a host branch. ``info.accepted`` flags the
    sampling-phase steps (the reference keeps only those,
    jax/sgld.py:320-322). ``prox_fn`` composes the proximal cyclical
    variants (reference jax/prox_sgld.py:345-418): the prox follows each
    move. The noise scale ``sqrt(2 g)`` is float32's, as the JAX package's
    of its float32 step size."""
    gf = _as_keyed_grad(grad_fn)
    pf = None if prox_fn is None else _as_stepped_prox(prox_fn)
    sched = cyclical_cosine_schedule(n_steps, num_cycles, initial_step_size,
                                     exploration_ratio)
    noise = StepNoise()

    def step(state, key):
        g, do_sample = sched(state.step)
        x = state.position
        move = x + g * gf(x, key)
        if do_sample:
            scale = float(np.sqrt(np.float32(2.0) * np.float32(g)))
            move = move + scale * noise.normal(key, x)
        x = move
        if pf is not None:
            x = pf(x, g)
        return state.next(x), StepInfo(accepted=do_sample)

    return Kernel(_init, step, chain_axis=True)


class CSGLDExtras(NamedTuple):
    energy_pdf: torch.Tensor  # (..., num_partitions) self-adapted energy histogram
    energy_idx: torch.Tensor  # (...) int64 current energy bin


def csgld(
    logdensity_fn: Callable,
    num_partitions: int = 512,
    energy_gap: float = 0.25,
    min_energy: float = 0.0,
    zeta: float = 1.0,
    temperature: float = 1.0,
    lr_schedule=1e-3,
    sa_schedule=None,
    prox_fn: Optional[Callable] = None,
    mult_clip: float = 100.0,
) -> Kernel:
    """Contour SGLD (Deng et al. 2020; the blackjax.csgld kernel driven at
    reference jax/sgld.py:329-394).

    A self-adapting energy histogram ``energy_pdf`` over ``num_partitions``
    bins of width ``energy_gap`` from ``min_energy``. Per step, with U =
    -logdensity and bin J(U):

        mult  = 1 + zeta T (log pdf[J] - log pdf[J-1]) / energy_gap
        x    <- x + lr * mult * grad logdensity + sqrt(2 lr T) xi
        pdf  <- pdf + omega_k pdf[J]^zeta (onehot(J) - pdf)

    The gradient is autograd's of ``logdensity_fn``, taken with the energy
    in one pass. ``sa_schedule`` defaults to the reference's
    ``min(1e-2, (k+100)^-0.8)`` (jax/sgld.py:372). ``prox_fn`` composes
    contour-proximal SGLD (jax/prox_sgld.py:421-491). ``mult_clip`` bounds
    the drift multiplier, keeping its sign (the JAX package's stabilisation:
    unclipped, the sharpened pdf drove 25-mode contour-proximal chains to NaN
    between 5k and 50k steps).

    The pdf starts uniform without a chain axis and takes one at the first
    step over ``C`` chains, ``(C, num_partitions)``. The bins are read with
    ``gather`` (``log`` of the floored ``pdf[J]`` and ``pdf[J-1]`` only, the
    values the JAX package reads from the whole log-pdf) and the update is
    ``pdf - c pdf`` plus ``c`` scattered at ``J`` (``c = omega pdf[J]^zeta``),
    three passes over the pdf; the sum of the increment is zero when the pdf
    sums to 1, so there is no renormalisation, as in the JAX package.
    """
    if sa_schedule is None:
        sa_schedule = lambda step: min(1e-2, (step + 100.0) ** (-0.8))
    pf = None if prox_fn is None else _as_stepped_prox(prox_fn)
    noise = StepNoise()

    def init(x0):
        pdf = torch.full((num_partitions,), 1.0 / num_partitions, dtype=x0.dtype,
                         device=x0.device)
        idx = torch.zeros((), dtype=torch.int64, device=x0.device)
        return SamplerState.init(x0, extras=CSGLDExtras(energy_pdf=pdf, energy_idx=idx))

    def step(state, key):
        lr = stepsize_at(lr_schedule, state.step)
        omega = stepsize_at(sa_schedule, state.step)
        x = state.position
        lead = _lead(key)
        pdf = state.extras.energy_pdf
        if lead and pdf.ndim == 1:
            pdf = pdf.expand(x.shape[:1] + pdf.shape)

        grad, logd = _grad_sum(logdensity_fn, x)
        energy = -logd
        j = torch.clamp(torch.ceil((energy - min_energy) / energy_gap).to(torch.int64),
                        1, num_partitions - 1)
        near = torch.stack([j, j - 1], -1)
        log_pdf = torch.log(torch.clamp(pdf.gather(-1, near), min=1e-30))
        mult = 1.0 + zeta * temperature * (log_pdf[..., 0] - log_pdf[..., 1]) / energy_gap
        mult = torch.clamp(mult, -mult_clip, mult_clip)
        mult = mult.reshape(mult.shape + (1,) * (x.ndim - mult.ndim))
        x_new = x + lr * mult * grad + _sqrt(2 * lr * temperature) * noise.normal(key, x)
        if pf is not None:
            x_new = pf(x_new, lr)

        c = omega * pdf.gather(-1, j[..., None]) ** zeta
        pdf_new = torch.addcmul(pdf, c, pdf, value=-1.0)
        pdf_new.scatter_add_(-1, j[..., None], c)
        pdf_new.clamp_(min=1e-30)
        return (state.next(x_new, extras=CSGLDExtras(energy_pdf=pdf_new, energy_idx=j)),
                StepInfo(energy=energy))

    return Kernel(init, step, chain_axis=True)


def csgld_importance_resample(
    samples, energy_idx, energy_pdf, zeta: float = 1.0, quantile: float = 0.95,
    key=None, rounds: int = 5,
):
    """Post-hoc importance resampling of CSGLD draws (reference
    jax/sgld.py:380-394): keep samples whose energy bin lies in the top
    (1-quantile) mass of the learned energy pdf, accepted with probability
    proportional to pdf[bin]^zeta. Host-side numpy; ``key`` is an int seed
    or the port's ``(seed, chain)`` key, whose seed seeds the draws (None:
    0)."""
    samples = np.asarray(samples)
    energy_idx = np.asarray(energy_idx)
    pdf = np.asarray(energy_pdf)
    thresh = np.quantile(pdf, quantile)
    important = np.where(pdf > thresh)[0]
    if important.size == 0:
        return samples[:0]
    scaled = pdf[important] ** zeta
    scaled = scaled / scaled.max()
    if key is None:
        seed = 0
    elif isinstance(key, (tuple, list)):
        seed = int(key[0])
    else:
        seed = int(key)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        for w, idx in zip(scaled, important):
            if rng.uniform() < w:
                out.append(samples[energy_idx == idx])
    return np.concatenate(out, axis=0) if out else samples[:0]


# --- proximal SGLD variants (reference jax/prox_sgld.py) --------------------


def spgld(grad_fn: Callable, prox_fn: Callable, schedule) -> Kernel:
    """Stochastic proximal gradient LD: the SGLD move, then the prior prox
    (reference prox_lmc.py:99-110 / jax/prox_sgld.py:111-162 intent).
    ``prox_fn`` may take ``(x, g)`` to receive the current step size."""
    gf = _as_keyed_grad(grad_fn)
    pf = _as_stepped_prox(prox_fn)
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(schedule, state.step)
        return state.next(pf(_sgld_move(state, key, noise, gf, g), g)), StepInfo()

    return Kernel(_init, step, chain_axis=True)


def ssgld(grad_fn: Callable, moreau_grad_fn: Callable, schedule) -> Kernel:
    """Smoothed SGLD: the nonsmooth prior enters through its Moreau-envelope
    gradient, subtracted from the stochastic score (jax/prox_sgld.py:165-216
    intent)."""
    gf = _as_keyed_grad(grad_fn)
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(schedule, state.step)
        x = state.position
        drift = gf(x, key) - moreau_grad_fn(x)
        return state.next(x + g * drift + _sqrt(2 * g) * noise.normal(key, x)), StepInfo()

    return Kernel(_init, step, chain_axis=True)


def mysgld(grad_fn: Callable, prox_fn: Callable, lam: float, schedule) -> Kernel:
    """Moreau-Yosida SGLD (MYULA with a stochastic score; the reference's
    ``gamma - prox`` typo at jax/prox_sgld.py:236 fixed):

        x <- (1 - g/lam) x + g grad log pi + (g/lam) prox(x) + sqrt(2g) xi
    """
    gf = _as_keyed_grad(grad_fn)
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(schedule, state.step)
        x = state.position
        x_new = ((1.0 - g / lam) * x + g * gf(x, key) + (g / lam) * prox_fn(x)
                 + _sqrt(2 * g) * noise.normal(key, x))
        return state.next(x_new), StepInfo()

    return Kernel(_init, step, chain_axis=True)


def cyclical_spgld(
    grad_fn: Callable,
    prox_fn: Callable,
    n_steps: int,
    num_cycles: int = 4,
    initial_step_size: float = 1e-3,
    exploration_ratio: float = 0.25,
) -> Kernel:
    """Cyclical SPGLD (reference jax/prox_sgld.py:345-418)."""
    return cyclical_sgld(grad_fn, n_steps, num_cycles, initial_step_size,
                         exploration_ratio, prox_fn=prox_fn)


def contour_spgld(logdensity_fn: Callable, prox_fn: Callable, **csgld_kwargs) -> Kernel:
    """Contour proximal SGLD (reference jax/prox_sgld.py:421-491)."""
    return csgld(logdensity_fn, prox_fn=prox_fn, **csgld_kwargs)
