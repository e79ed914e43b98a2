"""One fused MYULA step given the data gradient (counterpart of
``lmc_atomi_tpu/kernels/myula_pallas.py``): kernel 8, its plain torch
version, and the ``Kernel`` factory ``myula_imaging_fused``.

The step after the data-term gradient ``g``:

    x' = (1 - tau/gamma) x - tau g + (tau/gamma) prox_{tv_gamma TV}(x)
         + noise_scale sqrt(2 tau) xi

with a cold Chambolle prox of ``niter`` trips (kernel 1's arithmetic) and
``xi`` the Philox normal of ``(seed, chain, step)`` (``core/random.py``).
``myula_tv_fused_update`` dispatches by device: ``csrc/tv_prox.cu`` (kernel
1's tile kernel with the update as its epilogue, on ``prox_plan``'s route)
for CUDA tensors, ``myula_tv_fused_update_ref`` for CPU tensors.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from lmc_atomi_torch import _build
from lmc_atomi_torch.core.random import normal_field
from lmc_atomi_torch.core.state import SamplerState, StepInfo
from lmc_atomi_torch.kernels.base import Kernel
from lmc_atomi_torch.ops.tv_cuda import ROUTES, _launch_prox_tile, prox_tv_iso_ref

__all__ = [
    "myula_tv_fused_update",
    "myula_tv_fused_update_cuda",
    "myula_tv_fused_update_ref",
    "myula_imaging_fused",
]


def _tail_coefs(tau, gamma, tv_gamma, noise_scale):
    """``(1 - tau/gamma, tau, tau/gamma, noise_scale sqrt(2 tau), tv_gamma)``
    as Python floats."""
    tau, gamma = float(tau), float(gamma)
    return (1.0 - tau / gamma, tau, tau / gamma,
            float(noise_scale) * math.sqrt(2.0 * tau), float(tv_gamma))


def myula_tv_fused_update_ref(x, grad, seed, tau, gamma, tv_gamma,
                              noise_scale=1.0, niter: int = 10,
                              step: float = 0.25, with_noise: bool = True):
    """Plain torch version of kernel 8 (see ``myula_tv_fused_update``)."""
    c_keep, c_grad, c_prox, noise_amp, tv_gamma = _tail_coefs(
        tau, gamma, tv_gamma, noise_scale)
    prox = prox_tv_iso_ref(x, tv_gamma, niter=niter, step=step)
    out = c_keep * x - c_grad * grad + c_prox * prox
    if with_noise:
        out = out + noise_amp * normal_field(*seed, x.shape, x.dtype, x.device)
    return out


def myula_tv_fused_update_cuda(x, grad, seed, tau, gamma, tv_gamma,
                               noise_scale=1.0, niter: int = 10,
                               step: float = 0.25, with_noise: bool = True):
    """Kernel 8 (``csrc/tv_prox.cu``, kernel 1's tile kernel with the update
    as its epilogue) on contiguous float32 CUDA images, on the route
    ``ops/tv_cuda.py::prox_plan`` names (counted in ``routes``, the plan in
    ``last_plan``). Raises on a CPU tensor, on a negative trip count, or
    when no tile fits the card."""
    if x.ndim != 2 or min(x.shape) < 2:
        raise ValueError(f"x must be an (ny, nx) image, got {tuple(x.shape)}")
    if niter < 0:
        raise ValueError(f"niter={niter} must be >= 0")
    _build.require_cuda_f32(tuple(x.shape), x=x, grad=grad)
    c_keep, c_grad, c_prox, noise_amp, tv_gamma = _tail_coefs(
        tau, gamma, tv_gamma, noise_scale)
    out, plan = _launch_prox_tile(x, grad, int(niter), step,
                                  (tv_gamma, c_keep, c_grad, c_prox, noise_amp),
                                  with_noise, seed)
    myula_tv_fused_update_cuda.launches += 1
    myula_tv_fused_update_cuda.routes[plan[0]] += 1
    myula_tv_fused_update_cuda.last_plan = plan
    return out


myula_tv_fused_update_cuda.launches = 0  # calls that launched the kernel
myula_tv_fused_update_cuda.routes = dict.fromkeys(ROUTES, 0)  # calls per route
myula_tv_fused_update_cuda.last_plan = None  # the last call's prox_plan


def myula_tv_fused_update(x, grad, seed, tau, gamma, tv_gamma, noise_scale=1.0,
                          niter: int = 10, step: float = 0.25,
                          with_noise: bool = True):
    """One fused MYULA update given the data-term gradient ``grad``, kernel 8.

    ``seed`` is the step's key ``(seed, chain, step)``. CUDA tensors run the
    hand kernel, CPU tensors its plain version."""
    fn = myula_tv_fused_update_cuda if x.is_cuda else myula_tv_fused_update_ref
    return fn(x, grad, seed, tau, gamma, tv_gamma, noise_scale, niter=niter,
              step=step, with_noise=with_noise)


def myula_imaging_fused(proxf: Any, tv_sigma: float, tau, gamma,
                        niter_tv: int = 10, base_seed: int = 0,
                        noise_scale: float = 1.0) -> Kernel:
    """MYULA with an isotropic-TV prior and a fused tail: a drop-in for
    ``myula_imaging(proxf, TVNorm(tv_sigma, niter_tv), tau, gamma)``. The
    noise of a step with key ``(seed, chain, step)`` is ``normal_field(seed +
    base_seed, chain, step)``, so with ``base_seed=0`` it draws the same
    stream as ``myula_imaging``."""

    def init(x0):
        return SamplerState.init(x0)

    def step(state, key):
        seed, chain, g = key
        x = state.position
        x_new = myula_tv_fused_update(
            x, proxf.grad(x), (seed + base_seed, chain, g), tau, gamma,
            tv_sigma * gamma, noise_scale, niter=niter_tv,
            with_noise=noise_scale != 0.0)
        return state.next(x_new), StepInfo()

    return Kernel(init, step)
