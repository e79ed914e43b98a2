"""Unadjusted and Metropolis-adjusted Langevin kernels on smooth(ed)
potentials (counterpart of ``lmc_atomi_tpu/kernels/langevin.py``): ULA, MALA,
PULA, IHPULA and MLA (reference lmc.py:94-190, lmc_laplace.py:110-216).

A step's key is ``(seed, chain, step)``: the proposal noise is
``normal_field`` and MALA's accept draw ``uniform_scalar`` of that key, two
Philox streams that never share a counter. A kernel draws them for up to
``NOISE_STEPS`` steps at once where the field is small (``StepNoise``): the
same numbers, bit for bit, in one draw of ~125 launches in place of one a
step, since a small chain's step is launch-bound. MALA keeps the
stay-at-state chain; the accept decision is a tensor chosen with
``torch.where`` on the device, so a step never waits for the card.

Each kernel also steps a batch of chains (``Kernel.chain_axis``): ``chain``
is then a tensor of ``C`` words and the position ``(C, ...)``. MALA's
proposal densities then sum over every axis but the chain axis, and each
chain accepts or rejects on its own. PULA, IHPULA and MLA set the flag;
``ula`` and ``mala`` leave it to the caller (``base.py``). Matrix-vector
products are ``ops/batched.py``'s, and MLA's ``sinh`` and its
``(x^2 + beta^2)^(-1/4)`` are written with ``expm1`` and square roots, so
that a chain's bits do not depend on the batch it runs in (IHPULA's
``eigh`` excepted: a batched call may take another algorithm).
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from lmc_atomi_torch.core.random import normal_field, uniform_scalar
from lmc_atomi_torch.core.state import SamplerState, StepInfo
from lmc_atomi_torch.kernels.base import Kernel, stepsize_at
from lmc_atomi_torch.ops.batched import fsum, matvec
from lmc_atomi_torch.ops.bregman import grad_conjugate_mirror_hyp, grad_mirror_hyp

__all__ = ["ula", "mala", "pula", "ihpula", "mla", "sqrtm_psd"]


def _sqrt(t):
    return torch.sqrt(t) if isinstance(t, torch.Tensor) else math.sqrt(t)


def _lead(key) -> int:
    """1 where the key holds a tensor of chain words (a chain axis), else 0."""
    return int(isinstance(key[1], torch.Tensor))


# a noise block holds at most NOISE_STEPS steps and NOISE_ELEMS numbers
NOISE_STEPS, NOISE_ELEMS = 64, 1 << 18


class StepNoise:
    """A kernel's ``normal_field`` and ``uniform_scalar`` at a step's key,
    drawn for a block of the next steps at once (``normal_field`` with a
    tensor of steps) and served from it while the key's seed and chain, the
    field and the step match; a field of more than ``NOISE_ELEMS // 2``
    numbers is drawn a step at a time. The values do not depend on the
    block."""

    def __init__(self):
        self._blocks = {}  # kind: ((seed, shape, dtype, device), chain, first step, block)

    def _take(self, kind, key, shape, dtype, device, draw):
        seed, chain, step = key
        ident = (seed, shape, dtype, device)
        got = self._blocks.get(kind)
        if got is not None:
            got_ident, got_chain, first, block = got
            # a block holds its chain words, so ``is`` cannot match a newer
            # tensor that took the place of a freed one
            same_chain = got_chain is chain or not (
                isinstance(got_chain, torch.Tensor) or isinstance(chain, torch.Tensor)
            ) and got_chain == chain
            if got_ident == ident and same_chain and 0 <= step - first < block.shape[0]:
                return block[step - first]
        n = min(NOISE_STEPS, NOISE_ELEMS // max(1, math.prod(shape)))
        if n < 2:
            return draw(step)
        block = draw(torch.arange(step, step + n, device=device))
        self._blocks[kind] = (ident, chain, step, block)
        return block[0]

    def normal(self, key, x):
        """``normal_field`` of the key over ``x``'s chain(s)."""
        seed, chain, _ = key
        shape = tuple(x.shape)
        return self._take("normal", key, shape, x.dtype, x.device, lambda s: normal_field(
            seed, chain, s, shape[_lead(key):], x.dtype, x.device))

    def uniform(self, key, dtype, device):
        """``uniform_scalar`` of the key, one a chain."""
        seed, chain, _ = key
        shape = tuple(chain.shape) if isinstance(chain, torch.Tensor) else ()
        return self._take("uniform", key, shape, dtype, device,
                          lambda s: uniform_scalar(seed, chain, s, dtype, device))


def _init(x0):
    return SamplerState.init(x0)


def mh_step(state, key, noise, prop, log_target, log_q_rev, log_q_fwd):
    """Metropolis-Hastings on ``prop``: the log ratio of the target plus the
    reverse (``x`` from ``prop``) minus the forward proposal log-density,
    term for term as the JAX package computes it, against
    ``uniform_scalar`` of the key (``noise.uniform``); per chain where the
    key holds a chain axis. ``StepInfo`` carries ``accepted`` and
    ``min(log_ratio, 0)``."""
    x = state.position
    log_ratio = log_target(prop) - log_target(x) + log_q_rev - log_q_fwd
    u = noise.uniform(key, log_ratio.dtype, log_ratio.device)
    log_ratio = torch.clamp(log_ratio, max=0.0)
    accept = torch.log(u) <= log_ratio
    x_new = torch.where(accept.reshape(accept.shape + (1,) * (x.ndim - accept.ndim)),
                        prop, x)
    return state.next(x_new), StepInfo(accepted=accept, log_accept_ratio=log_ratio)


def sq_dev(dev, lead: int):
    """``sum(dev^2)`` over every axis but the first ``lead`` (the chain axis)."""
    return torch.sum(dev * dev) if lead == 0 else fsum((dev * dev).flatten(lead), -1)


def sqrtm_psd(m):
    """Square root of a symmetric PSD matrix through ``eigh``."""
    w, v = torch.linalg.eigh(m)
    return (v * torch.sqrt(torch.clamp(w, min=0.0))) @ v.transpose(-1, -2)


def ula(grad_fn: Callable, gamma) -> Kernel:
    """Unadjusted Langevin: ``x <- x - g grad U(x) + sqrt(2 g) xi``."""
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(gamma, state.step)
        x = state.position
        x = x - g * grad_fn(x) + _sqrt(2 * g) * noise.normal(key, x)
        return state.next(x), StepInfo()

    return Kernel(_init, step)


def mala(log_density_fn: Callable, grad_fn: Callable, gamma) -> Kernel:
    """Metropolis-adjusted Langevin. Proposal ``N(x - g grad U(x), 2 g I)``;
    the accept test is ``mh_step``'s."""
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(gamma, state.step)
        x = state.position
        lead = _lead(key)

        def log_q(x_to, mean):
            # N(mean, 2 g I) log-density up to the common normalizer
            return -sq_dev(x_to - mean, lead) / (4.0 * g)

        mean = x - g * grad_fn(x)  # the forward mean, once
        prop = mean + _sqrt(2 * g) * noise.normal(key, x)
        return mh_step(state, key, noise, prop, log_density_fn,
                       log_q(x, prop - g * grad_fn(prop)), log_q(prop, mean))

    return Kernel(_init, step)


def pula(grad_fn: Callable, gamma, m) -> Kernel:
    """Preconditioned ULA with a fixed SPD ``m`` (reference lmc.py:134-148):
    ``x <- x - g M grad U + sqrt(2 g) sqrtm(M) xi``, ``sqrtm(M)`` factored
    once. ``m`` on the chain's device saves a copy a step."""
    m = torch.as_tensor(m)
    sqrt_m = sqrtm_psd(m)
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(gamma, state.step)
        x = state.position
        drift = x - g * matvec(m.to(x), grad_fn(x))
        xi = noise.normal(key, x)
        return state.next(drift + _sqrt(2 * g) * matvec(sqrt_m.to(x), xi)), StepInfo()

    return Kernel(_init, step, chain_axis=True)


def ihpula(grad_fn: Callable, hess_fn: Callable, gamma, shift: float = 0.05,
           regularize: bool = True) -> Kernel:
    """Inverse-Hessian preconditioned ULA (reference lmc.py:151-169).

    Per step ``H = hess U(x)``; with ``regularize`` (the reference's
    multi-mixture branch) ``M = (H + (|lambda_min| + shift) I)^{-1}``, else
    ``H^{-1}``. One symmetric eigendecomposition gives the shift, ``M`` and
    ``sqrtm(M)`` together, applied as matrix-vector products, as the JAX
    package computes it; in the position's dtype (the JAX package takes f64
    where x64 is on)."""
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(gamma, state.step)
        x = state.position
        w, v = torch.linalg.eigh(hess_fn(x))
        if regularize:
            w = w + (torch.abs(w.amin(-1, keepdim=True)) + shift)
        vt = v.transpose(-1, -2)
        drift = x - g * matvec(v, matvec(vt, grad_fn(x)) / w)
        xi = matvec(v, matvec(vt, noise.normal(key, x)) / torch.sqrt(w))
        return state.next(drift + _sqrt(2 * g) * xi), StepInfo()

    return Kernel(_init, step, chain_axis=True)


def mla(grad_fn: Callable, gamma, beta) -> Kernel:
    """Mirror-Langevin with the hyperbolic entropy mirror map (reference
    lmc.py:172-190): a dual step, pulled back through ``beta sinh``."""
    beta = torch.as_tensor(beta)
    noise = StepNoise()

    def step(state, key):
        g = stepsize_at(gamma, state.step)
        x = state.position
        b = beta.to(x)
        dual = (grad_mirror_hyp(x, b) - g * grad_fn(x)
                + _sqrt(2 * g) * torch.rsqrt(torch.sqrt(x * x + b * b)) * noise.normal(key, x))
        return state.next(grad_conjugate_mirror_hyp(dual, b)), StepInfo()

    return Kernel(_init, step, chain_axis=True)
