"""Bregman proximal maps under the hyperbolic entropy mirror map
(counterpart of ``lmc_atomi_tpu/ops/bregman.py``).

Mirror map ``phi_beta(x) = sum_i x_i arcsinh(x_i/beta_i) - sqrt(x_i^2+beta_i^2)``
with ``grad phi = arcsinh(x/beta)`` and conjugate gradient ``beta sinh(y)``
(reference lmc.py:173-177, prox_lmc.py:212-216); the left Bregman prox of
``gamma |.|_1`` in the three-branch closed form of reference
prox_lmc.py:218-233.

``sinh`` is ``(expm1(y) - expm1(-y)) / 2`` here: torch's CPU ``sinh`` rounds
its vector path and its scalar remainder loop differently, so a chain's bits
would depend on how many chains share its tensor; ``expm1`` rounds alike on
both paths.
"""
from __future__ import annotations

import torch

__all__ = [
    "grad_mirror_hyp",
    "grad_conjugate_mirror_hyp",
    "left_bregman_prox_l1_hypent",
    "bregman_moreau_env_grad_l1_hypent",
]


def sinh(y):
    return 0.5 * (torch.expm1(y) - torch.expm1(-y))


def grad_mirror_hyp(x, beta):
    return torch.asinh(x / beta)


def grad_conjugate_mirror_hyp(y, beta):
    return beta * sinh(y)


def left_bregman_prox_l1_hypent(x, beta, gamma):
    """Left Bregman prox of ``gamma |.|_1`` w.r.t. hyperbolic entropy."""
    up = beta * sinh(torch.asinh(x / beta) - gamma)
    dn = beta * sinh(torch.asinh(x / beta) + gamma)
    mid = torch.sqrt(x**2 + beta**2) - beta
    gamma = torch.as_tensor(gamma, dtype=x.dtype, device=x.device)
    p = torch.where(x > beta * sinh(gamma), up, mid)
    return torch.where(x < beta * sinh(-gamma), dn, p)


def bregman_moreau_env_grad_l1_hypent(x, beta, lam, alpha):
    """Gradient of the Bregman-Moreau envelope of ``alpha |.|_1`` (reference
    prox_lmc.py:235-236): ``(x - breg_prox(x)) / (lam sqrt(x^2 + beta^2))``."""
    p = left_bregman_prox_l1_hypent(x, beta, lam * alpha)
    return (x - p) / (lam * torch.sqrt(x**2 + beta**2))
