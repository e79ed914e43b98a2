"""Imaging-scale samplers (counterpart of ``lmc_atomi_tpu/kernels/imaging.py``):
ULPDA and MYULA over functionals, and PnP-ULA and the (annealed,
predictor-corrector) score-ULA of the learned priors. A step draws
``normal_field`` at its key ``(seed, chain, step)``, so a fused kernel
drawing the same Philox stream runs the same chain.

``pnp_ula``, ``score_ula`` and ``score_ula_pc`` set ``chain_axis``: under
``run_chains`` a step takes the ``(C, ny, nx)`` positions of ``C`` chains and
calls the denoiser or score net once on the whole block. Their ``grad_f``,
denoiser and score must then accept a leading chain axis (``L2Data.grad``
and the nets of ``models/`` do). Row ``c`` equals chain ``c`` run alone up
to the net's arithmetic: a convolution library may sum in another order for
another batch size (PnP-ULA, BASELINE.json config 5, Laumont et al. 2022)."""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from lmc_atomi_torch.core.random import normal_field
from lmc_atomi_torch.core.state import SamplerState, StepInfo
from lmc_atomi_torch.kernels.base import Kernel, stepsize_at
from lmc_atomi_torch.ops.sharded import is_sharded, normal_block

__all__ = ["ulpda", "myula_imaging", "pnp_ula", "score_ula", "score_ula_pc",
           "ULPDAExtras"]


def _sqrt(t):
    return torch.sqrt(t) if isinstance(t, torch.Tensor) else math.sqrt(t)


class ULPDAExtras(NamedTuple):
    y: Any  # dual variable
    xbar: Any  # extrapolated primal
    # previous primal iterate (the tiled kernel's exact resume point)
    xprev: Any = None


def ulpda(proxf, proxg, a_op, tau, mu, theta: float = 1.0,
          z: Optional[torch.Tensor] = None, gfirst: bool = True,
          noise_scale: float = 1.0) -> Kernel:
    """Unadjusted Langevin primal-dual (Chambolle-Pock + primal noise).

    gfirst=True recursion (reference algs.py:370-381, 435-441):
        y    <- proxdual_g(y + mu A xbar, mu)
        x    <- prox_f(x - tau (A^T y + z), tau) + sqrt(2 tau) xi
        xbar <- x + theta (x - x_old)
    gfirst=False applies the primal update first (algs.py:383-392, 442-448).
    ``noise_scale=0`` is deterministic Chambolle-Pock.
    """

    def init(x0, y0=None):
        y = a_op.matvec(x0) * 0.0 if y0 is None else y0
        return SamplerState.init(x0, extras=ULPDAExtras(y=y, xbar=x0))

    def step(state, key):
        t = stepsize_at(tau, state.step)
        m = stepsize_at(mu, state.step)
        x_old = state.position
        xi = noise_scale * normal_field(*key, x_old.shape, x_old.dtype,
                                        x_old.device)
        y = state.extras.y
        xbar = state.extras.xbar
        if gfirst:
            y = proxg.proxdual(y + m * a_op.matvec(xbar), m)
        aty = a_op.rmatvec(y)
        if z is not None:
            aty = aty + z
        x = proxf.prox(x_old - t * aty, t) + _sqrt(2 * t) * xi
        xbar = x + theta * (x - x_old)
        if not gfirst:
            y = proxg.proxdual(y + m * a_op.matvec(xbar), m)
        return state.next(x, extras=ULPDAExtras(y=y, xbar=xbar)), StepInfo()

    return Kernel(init, step)


def myula_imaging(proxf, proxg, tau, gamma, epsg: float = 1.0) -> Kernel:
    """Moreau-Yosida ULA over functionals (reference algs.py:528-535, 569):

        x <- (1 - tau/gamma) x - tau grad_f(x)
             + (tau/gamma) prox_g(x, epsg*gamma) + sqrt(2 tau) xi

    ``xi`` is ``normal_field(seed, chain, step)`` of the step's key. On an
    image split over ranks (``parallel.shard_image``) each rank draws its
    block of that field (``ops.sharded.normal_block``), and
    ``proxf.grad`` and ``proxg.prox`` run their sharded paths: ``run_chain``
    on ``shard_image(x0, mesh)`` runs the one-device chain.
    """

    def init(x0):
        return SamplerState.init(x0)

    def step(state, key):
        t = stepsize_at(tau, state.step)
        g = stepsize_at(gamma, state.step)
        x = state.position
        xi = (normal_block(*key, x) if is_sharded(x)
              else normal_field(*key, x.shape, x.dtype, x.device))
        x_new = (
            (1.0 - t / g) * x
            - t * proxf.grad(x)
            + (t / g) * proxg.prox(x, epsg * g)
            + _sqrt(2 * t) * xi
        )
        return state.next(x_new), StepInfo()

    return Kernel(init, step)


def _noise(key, x, stream: int = 0):
    """The step's normals for one chain ``x`` (``key`` a chain word) or a
    block of chains (``key[1]`` a tensor of ``C`` words, ``x`` ``(C, ...)``)."""
    shape = x.shape[1:] if isinstance(key[1], torch.Tensor) else x.shape
    return normal_field(*key, shape, x.dtype, x.device, stream=stream)


def _minimum(a, b):
    """The smaller of two step sizes, numbers or 0-d tensors (no host read)."""
    if isinstance(a, torch.Tensor):
        return torch.clamp(a, max=b)
    if isinstance(b, torch.Tensor):
        return torch.clamp(b, max=a)
    return min(a, b)


def _box_drift(x, box, weight):
    return (torch.clamp(x, box[0], box[1]) - x) / weight


def pnp_ula(grad_f, denoiser, tau, eps: float, alpha: float = 1.0,
            box: Optional[tuple] = None, box_weight: Optional[float] = None) -> Kernel:
    """Plug-and-Play ULA (Laumont et al. 2022; BASELINE.json config 5):

        x <- x - tau grad_f(x) + tau (alpha/eps)(D_eps(x) - x)
               + tau/lam_box (proj_C(x) - x) + sqrt(2 tau) xi

    ``denoiser`` is any image -> image callable (a trained CNN or an analytic
    one); ``box=(lo, hi)`` adds the compact-set projection drift that
    guarantees ergodicity (weight ``box_weight``, by default ``eps``).
    """

    def init(x0):
        return SamplerState.init(x0)

    def step(state, key):
        t = stepsize_at(tau, state.step)
        x = state.position
        drift = -grad_f(x) + (alpha / eps) * (denoiser(x) - x)
        if box is not None:
            drift = drift + _box_drift(x, box, box_weight if box_weight is not None else eps)
        return state.next(x + t * drift + _sqrt(2 * t) * _noise(key, x)), StepInfo()

    return Kernel(init, step, chain_axis=True)


def score_ula(grad_f, score, sigma, tau, alpha: float = 1.0,
              box: Optional[tuple] = None, box_weight: float = 1.0) -> Kernel:
    """Posterior Langevin with a learned noise-conditional score prior
    (``models/score.py``), annealed when ``sigma`` is a schedule:

        x <- x - tau_i grad_f(x) + tau_i alpha s_theta(x, sigma_i)
               + tau_i/lam_box (proj_C(x) - x) + sqrt(2 tau_i) xi

    ``sigma`` and ``tau`` follow ``stepsize_at`` (a number, a per-step
    sequence, tensor or numpy array, or a callable of the step), read once a
    step: an annealed ladder is ``sigma = sigmas.repeat_interleave(k)`` with
    its ``tau`` schedule (Song and Ermon: ``tau_i`` proportional to
    ``sigma_i^2``); a fixed ``sigma`` is PnP-ULA with ``eps = sigma^2``
    (Tweedie). It is :func:`score_ula_pc` with no corrector sweep.
    """
    return score_ula_pc(grad_f, score, sigma, tau, alpha=alpha, n_corrector=0, box=box,
                        box_weight=box_weight)


def score_ula_pc(grad_f, score, sigma, tau, alpha: float = 1.0, n_corrector: int = 1,
                 snr: float = 0.16, box: Optional[tuple] = None,
                 box_weight: float = 1.0) -> Kernel:
    """Predictor-corrector annealed score sampling (Song et al. 2021, the
    posterior form): one :func:`score_ula` predictor step at ``(sigma_i,
    tau_i)``, then ``n_corrector`` Langevin sweeps at the same level with the
    step ``eps_i = min(2 (snr sigma_i)^2, tau_i)``.

    The predictor draws the step's own noise (``stream`` 0), so
    ``n_corrector=0`` is ``score_ula``; sweep ``j`` draws stream
    ``j + 1`` of the same (seed, chain, step), the counterpart of the JAX
    package's ``fold_in(key, j + 1)``.
    """

    def init(x0):
        return SamplerState.init(x0)

    def drift_at(x, s):
        d = -grad_f(x) + alpha * score(x, s)
        if box is not None:
            d = d + _box_drift(x, box, box_weight)
        return d

    def step(state, key):
        t = stepsize_at(tau, state.step)
        s = stepsize_at(sigma, state.step)
        x = state.position
        x = x + t * drift_at(x, s) + _sqrt(2 * t) * _noise(key, x)
        if n_corrector:
            eps = _minimum(2.0 * (snr * s) ** 2, t)
            for j in range(n_corrector):
                x = x + eps * drift_at(x, s) + _sqrt(2 * eps) * _noise(key, x, stream=j + 1)
        return state.next(x), StepInfo()

    return Kernel(init, step, chain_axis=True)
