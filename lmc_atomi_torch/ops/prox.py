"""Closed-form proximal operators (counterpart of
``lmc_atomi_tpu/ops/prox.py``; reference prox.py:9-104).

Every operator is elementwise torch, vectorised: the reference's scalar
branches are ``torch.where`` selects, and its implicit scalar root-finds
(Weibull, generalized inverse Gaussian, Pearson type I, which it solves with
``scipy.optimize.minimize_scalar``) are bisections of a fixed 64 trips on the
prox stationarity equation, with no stopping test that reads the device.

Conventions: ``prox_f(x, gamma)`` solves ``argmin_y f(y) + ||y-x||^2/(2 gamma)``.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = [
    "prox_conjugate",
    "prox_square_loss",
    "prox_laplace",
    "soft_threshold",
    "prox_uncentered_laplace",
    "prox_gaussian",
    "prox_gen_gaussian",
    "prox_huber",
    "prox_max_ent",
    "prox_smoothed_laplace",
    "prox_exp",
    "prox_gamma",
    "prox_chi",
    "prox_uniform",
    "prox_triangular",
    "prox_weibull",
    "prox_gen_inv_gaussian",
    "prox_pearson_I",
    "prox_l2_ball",
    "prox_box",
    "prox_l21_pairs",
]


def _cbrt(x):
    """Real cube root (torch has no ``cbrt``)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def prox_conjugate(x, gamma, prox: Callable):
    """Moreau decomposition: prox of the convex conjugate f*,
    ``prox_{gamma f*}(x) = x - gamma * prox_{f/gamma}(x/gamma)``."""
    return x - gamma * prox(x / gamma, 1.0 / gamma)


def prox_square_loss(x, y, op, gamma, niter: int = 50):
    """Prox of ``(1/2)||Op u - y||^2``: ``(I + gamma Op^T Op)^{-1}(x + gamma
    Op^T y)`` through the operator's ``gram_solve``."""
    return op.gram_solve(gamma, x + gamma * op.rmatvec(y), niter=niter)


def prox_laplace(x, gamma):
    """Soft-thresholding: prox of ``gamma * |.|_1`` (reference prox.py:18-19)."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - gamma, min=0.0)


soft_threshold = prox_laplace


def prox_uncentered_laplace(x, gamma, mu):
    """Prox of ``gamma * |x - mu|_1`` (reference prox.py:22-23). Pure
    elementwise arithmetic, so ``torch.func`` transforms take it."""
    return mu + prox_laplace(x - mu, gamma)


def prox_gaussian(x, gamma):
    """Prox of ``gamma * x^2``."""
    return x / (2.0 * gamma + 1.0)


def prox_gen_gaussian(x, gamma, p):
    """Prox of ``gamma * |x|^p`` for p in {4/3, 3/2, 3, 4} (reference
    prox.py:30-41); ``p`` is a Python number that picks the closed form."""
    if p == 4 / 3:
        xi = torch.sqrt(x**2 + 256.0 * gamma**3 / 729.0)
        return x + 4.0 * gamma / (3.0 * 2.0 ** (1.0 / 3.0)) * (
            _cbrt(xi - x) - _cbrt(xi + x))
    if p == 3 / 2:
        return x + 9.0 * gamma**2 * torch.sign(x) * (
            1.0 - torch.sqrt(1.0 + 16.0 * torch.abs(x) / (9.0 * gamma**2))) / 8.0
    if p == 3:
        return torch.sign(x) * (torch.sqrt(1.0 + 12.0 * gamma * torch.abs(x)) - 1.0) / (
            6.0 * gamma)
    if p == 4:
        xi = torch.sqrt(x**2 + 1.0 / (27.0 * gamma))
        return _cbrt((xi + x) / (8.0 * gamma)) - _cbrt((xi - x) / (8.0 * gamma))
    raise ValueError(f"unsupported exponent p={p}; use 4/3, 3/2, 3 or 4")


def prox_huber(x, gamma, tau):
    """Prox of the Huber-type penalty (reference prox.py:44-45)."""
    small = torch.abs(x) <= gamma * (2.0 * tau + 1.0) / (2.0 * tau) ** 0.5
    return torch.where(small, x / (2.0 * tau + 1.0),
                       x - gamma * (2.0 * tau) ** 0.5 * torch.sign(x))


def prox_max_ent(x, gamma, tau, kappa, p):
    """Prox of the maximum-entropy-family penalty (reference prox.py:48-49)."""
    inner = torch.clamp(torch.abs(x) - gamma, min=0.0) / (2.0 * tau + 1.0)
    return torch.sign(x) * prox_gen_gaussian(inner, kappa / (2.0 * tau + 1.0), p)


def prox_smoothed_laplace(x, gamma):
    """Prox of the smoothed Laplace potential (reference prox.py:52-53)."""
    a = gamma * torch.abs(x) - gamma**2 - 1.0
    return torch.sign(x) * (a + torch.sqrt(a**2 + 4.0 * gamma * torch.abs(x))) / (
        2.0 * gamma)


def prox_exp(x, gamma):
    """Prox of the one-sided exponential potential (reference prox.py:56-57)."""
    return torch.where(x >= gamma, x - gamma, torch.zeros_like(x))


def prox_gamma(x, omega, kappa):
    """Prox of the gamma-distribution potential (reference prox.py:60-61)."""
    return (x - omega + torch.sqrt((x - omega) ** 2 + 4.0 * kappa)) / 2.0


def prox_chi(x, kappa):
    """Prox of the chi-distribution potential (reference prox.py:64-65)."""
    return (x + torch.sqrt(x**2 + 8.0 * kappa)) / 4.0


def prox_uniform(x, omega):
    """Projection onto ``[-omega, omega]`` (reference prox.py:68-75)."""
    return torch.clamp(x, -omega, omega)


def prox_triangular(x, omega1, omega2):
    """Prox of the triangular-distribution potential (reference prox.py:78-85)."""
    lo = (x + omega1 + torch.sqrt((x - omega1) ** 2 + 4.0)) / 2.0
    hi = (x + omega2 + torch.sqrt((x - omega2) ** 2 + 4.0)) / 2.0
    return torch.where(x < 1.0 / omega1, lo,
                       torch.where(x > 1.0 / omega2, hi, torch.zeros_like(x)))


def _bisect_root(f: Callable, lo, hi, iters: int = 64):
    """Bisection for a root of increasing ``f`` on ``[lo, hi]``, elementwise:
    a fixed ``iters`` trips, no test that waits for the device."""
    a, b = lo, hi
    for _ in range(iters):
        m = 0.5 * (a + b)
        pos = f(m) > 0
        a, b = torch.where(pos, a, m), torch.where(pos, m, b)
    return 0.5 * (a + b)


def _float(x):
    x = torch.as_tensor(x)
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


def _expand_hi(f, hi):
    # double hi until f(hi) > 0 (8 rounds, as the JAX package)
    for _ in range(8):
        hi = torch.where(f(hi) <= 0, 2.0 * hi, hi)
    return hi


def prox_weibull(x, omega, kappa, p, iters: int = 64):
    """Prox of the Weibull potential: the root on ``y > 0`` of
    ``p omega y^p + y^2 - x y - kappa`` (the first-order condition of
    reference prox.py:88-91), by bisection."""
    x = _float(x)
    x, omega, kappa = torch.broadcast_tensors(
        x, torch.as_tensor(omega, dtype=x.dtype, device=x.device),
        torch.as_tensor(kappa, dtype=x.dtype, device=x.device))

    def f(y):
        return p * omega * y**p + y**2 - x * y - kappa

    lo = torch.full_like(x, 1e-12)
    hi = torch.clamp(torch.abs(x), min=1.0) + torch.sqrt(torch.abs(kappa)) + 1.0
    return _bisect_root(f, lo, _expand_hi(f, hi), iters)


def prox_gen_inv_gaussian(x, omega, kappa, rho, iters: int = 64):
    """Prox of the generalized inverse Gaussian potential: the root on
    ``y > 0`` of ``y^3 + (omega - x) y^2 - kappa y - rho`` (reference
    prox.py:94-97), by bisection."""
    x = _float(x)

    def f(y):
        return y**3 + (omega - x) * y**2 - kappa * y - rho

    lo = torch.full_like(x, 1e-12)
    hi = (torch.abs(x) + abs(omega) + abs(kappa) ** 0.5
          + _cbrt(torch.as_tensor(abs(rho), dtype=x.dtype)) + 1.0)
    return _bisect_root(f, lo, _expand_hi(f, hi), iters)


def prox_pearson_I(x, kappa1, kappa2, omega1, omega2, iters: int = 64):
    """Prox of the Pearson type I potential on ``(omega1, omega2)``: the
    root of the cubic of reference prox.py:100-104 inside the interval, by
    bisection against the endpoints (the cubic's sign flipped where it
    decreases)."""
    x = _float(x)

    def f(y):
        return (y**3 - (omega1 + omega2 + x) * y**2
                + (omega1 * omega2 - kappa1 - kappa2 + (omega1 + omega2) * x) * y
                - omega1 * omega2 * x + omega1 * kappa2 + omega2 * kappa1)

    eps = 1e-9 * (omega2 - omega1)
    lo = torch.full_like(x, omega1 + eps)
    hi = torch.full_like(x, omega2 - eps)
    flip = f(lo) > f(hi)
    return _bisect_root(lambda y: torch.where(flip, -f(y), f(y)), lo, hi, iters)


def prox_l2_ball(x, radius, axis=None):
    """Projection onto the l2 ball of ``radius`` (over ``axis``, or all)."""
    if axis is None:
        nrm = torch.sqrt(torch.sum(x * x))
    else:
        nrm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    return x * torch.clamp(radius / torch.clamp(nrm, min=1e-30), max=1.0)


def prox_box(x, lo, hi):
    """Projection onto the box [lo, hi]."""
    return torch.clamp(x, lo, hi)


def prox_l21_pairs(z, gamma):
    """Prox of ``gamma * sum_i ||z_i||_2`` with the vectors stacked on axis
    0: group soft-thresholding."""
    nrm = torch.sqrt(torch.sum(z * z, dim=0, keepdim=True))
    return z * torch.clamp(1.0 - gamma / torch.clamp(nrm, min=1e-30), min=0.0)
