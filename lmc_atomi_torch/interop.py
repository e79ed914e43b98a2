"""Carry state between the JAX package and the port as numpy arrays.

The JAX package's objects are read out with ``np.asarray`` on the JAX side;
these functions build the port's objects from those arrays, so a problem set
up (or a chain started) in ``lmc_atomi_tpu`` can be run (or continued) in
``lmc_atomi_torch``. Nothing here imports JAX.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Optional

import numpy as np
import torch

from lmc_atomi_torch.core.state import SamplerState
from lmc_atomi_torch.core.stats import RunningMoments
from lmc_atomi_torch.kernels.imaging import ULPDAExtras
from lmc_atomi_torch.kernels.myula_fused import FusedChainResult, unpack_lanes
from lmc_atomi_torch.models.dncnn import DnCNN
from lmc_atomi_torch.models.score import ScoreNet, ScoreUNet
from lmc_atomi_torch.models import (
    GaussianMixture,
    GridGaussianMixture,
    LaplaceMixture,
    LaplacePrior,
    MixtureWithLaplacePrior,
    MultivariateLaplace,
)
from lmc_atomi_torch.ops.functionals import L2Data, OrthogonalL1
from lmc_atomi_torch.ops.linops import CirculantBlur2D, Gradient2D, Mask
from lmc_atomi_torch.ops.ncvx_tv import L2NcvxTV
from lmc_atomi_torch.ops.radon import Radon2D
from lmc_atomi_torch.ops.wavelet import DaubechiesDWT2D, HaarDWT2D
from lmc_atomi_torch.run.runner import base_key

__all__ = [
    "blur_from_numpy",
    "gradient_from_numpy",
    "l2data_from_numpy",
    "l2ncvx_from_numpy",
    "mask_l2_from_numpy",
    "orthogonal_l1_from_numpy",
    "radon_from_numpy",
    "fused_state_from_numpy",
    "ulpda_state_from_numpy",
    "ulpda_tiled_state_from_numpy",
    "packed_state_from_numpy",
    "farm_bundle_from_numpy",
    "gaussian_mixture_from_numpy",
    "grid_mixture_from_numpy",
    "laplace_mixture_from_numpy",
    "composite_from_numpy",
    "mvlaplace_from_numpy",
    "dncnn_from_numpy",
    "score_net_from_numpy",
    "score_unet_from_numpy",
    "to_numpy",
]


def _t(a, device) -> Optional[torch.Tensor]:
    return None if a is None else torch.as_tensor(np.array(a), device=device)


def blur_from_numpy(eigs_re, eigs_im, h=None, hh=None, offset=(0, 0),
                    device=None, prefer_stencil: bool = False) -> CirculantBlur2D:
    """A ``CirculantBlur2D`` from the JAX operator's ``eigs_re``/``eigs_im``
    float pair (one complex spectrum here), ``h``, ``hh``, ``offset`` and
    ``prefer_stencil``."""
    eigs = torch.complex(_t(eigs_re, device), _t(eigs_im, device))
    return CirculantBlur2D(eigs=eigs, h=_t(h, device), hh=_t(hh, device),
                           offset=tuple(int(o) for o in offset),
                           prefer_stencil=bool(prefer_stencil))


def gradient_from_numpy(sampling: float = 1.0) -> Gradient2D:
    """The JAX ``Gradient2D``'s counterpart (pass its ``sampling``)."""
    return Gradient2D(sampling=float(sampling))


def l2data_from_numpy(b, sigma: float, blur: CirculantBlur2D) -> L2Data:
    """``L2Data.create`` over ``blur`` for the observation ``b``."""
    return L2Data.create(op=blur, b=_t(b, blur.eigs.device), sigma=float(sigma))


def l2ncvx_from_numpy(b, blur: CirculantBlur2D, op2: Optional[Gradient2D] = None,
                      q=None, **fields) -> L2NcvxTV:
    """An ``L2NcvxTV`` over ``blur`` for the observation ``b``: pass the JAX
    functional's ``op2`` as its counterpart (``gradient_from_numpy``, or
    None for ME-TV), its ``q`` as an array, and its scalar fields
    (``sigma``, ``alpha``, ``lamda``, ``gamma``, ``isotropic``, ``qgrad``,
    ``niter_inner``, ``niter_solve``) as keywords."""
    device = blur.eigs.device
    return L2NcvxTV(op=blur, b=_t(b, device), op2=op2, q=_t(q, device),
                    **fields)


def mask_l2_from_numpy(mask, b, sigma: float, device=None) -> L2Data:
    """The inpainting data term ``L2Data(op=Mask(mask), b, sigma)``: pass
    the JAX functional's ``op.mask``, ``b`` and ``sigma``."""
    return L2Data(op=Mask(mask=_t(mask, device)), b=_t(b, device),
                  sigma=float(sigma))


def orthogonal_l1_from_numpy(sigma: float, levels: int,
                             taps: int = 2) -> OrthogonalL1:
    """The JAX ``OrthogonalL1``'s counterpart: pass its ``sigma`` and its
    operator's ``levels`` and ``taps`` (2 for ``HaarDWT2D``, 4 or 8 for
    ``DaubechiesDWT2D``)."""
    op = (HaarDWT2D(levels=int(levels)) if taps == 2
          else DaubechiesDWT2D(taps=int(taps), levels=int(levels)))
    return OrthogonalL1(op=op, sigma=float(sigma))


def radon_from_numpy(thetas, shape, mode: str, dense=None, shear_phis=None,
                     shear_ks=(), device=None) -> Radon2D:
    """The JAX ``Radon2D``'s counterpart from its ``thetas``, ``shape``,
    ``mode``, ``dense`` matrix, ``shear_phis`` and ``shear_ks``: the same
    angles and matrix, so both packages apply one operator."""
    return Radon2D(thetas=_t(thetas, device), dense=_t(dense, device),
                   shape=tuple(int(v) for v in shape), mode=str(mode),
                   shear_phis=_t(shear_phis, device),
                   shear_ks=tuple(int(k) for k in shear_ks))


def fused_state_from_numpy(x, mean, m2, count, qh=None, qn=None,
                           device=None) -> FusedChainResult:
    """The state of a JAX ``FusedChainResult``: pass the result's
    ``final_state.position``, ``moments.mean/m2/count`` and
    ``quantile_state``. Continue the chain with
    ``run_myula_tv_fused(..., x0=res.final_state.position,
    quantile_state=res.quantile_state, step_offset=<steps done>)`` and merge
    the moments with ``RunningMoments.merge``."""
    qstate = None if qh is None else (_t(qh, device), _t(qn, device))
    return FusedChainResult(
        final_state=SamplerState.init(_t(x, device)),
        moments=RunningMoments(count=int(count), mean=_t(mean, device),
                               m2=_t(m2, device)),
        quantile_state=qstate,
    )


def ulpda_state_from_numpy(x, y, xbar, mean, m2, count,
                           device=None) -> FusedChainResult:
    """The state of a JAX ``run_ulpda_fused`` or ``run_ulpda_wavelet_fused``
    result: pass its ``final_state.position``, ``final_state.extras.y`` (the
    stacked Gradient2D dual, or the wavelet chain's ``(ny, nx)`` dual in the
    interleaved layout), ``final_state.extras.xbar`` and
    ``moments.mean/m2/count``. Continue the chain with the port's runner of
    the same name, ``x0=res.final_state.position, y0=res.final_state.extras.y,
    xbar0=res.final_state.extras.xbar, step_offset=<steps done>``, and merge
    the moments with ``RunningMoments.merge``."""
    return FusedChainResult(
        final_state=SamplerState.init(
            _t(x, device), extras=ULPDAExtras(y=_t(y, device), xbar=_t(xbar, device))),
        moments=RunningMoments(count=int(count), mean=_t(mean, device),
                               m2=_t(m2, device)),
    )


def ulpda_tiled_state_from_numpy(x, y, xbar, xprev, mean, m2, count, qh=None,
                                 qn=None, device=None) -> FusedChainResult:
    """The state of a JAX ``run_ulpda_tv_tiled`` result: pass its
    ``final_state.position``, ``final_state.extras.y`` (the stacked dual),
    ``.xbar`` and ``.xprev`` (the previous sample, the tiled kernel's exact
    resume point), ``moments.mean/m2/count`` and ``quantile_state``. Continue
    the chain with ``run_ulpda_tv_tiled(..., x0=res.final_state.position,
    y0=res.final_state.extras.y, xprev0=res.final_state.extras.xprev,
    quantile_state=res.quantile_state, step_offset=<steps done>)`` and merge
    the moments with ``RunningMoments.merge``."""
    qstate = None if qh is None else (_t(qh, device), _t(qn, device))
    return FusedChainResult(
        final_state=SamplerState.init(_t(x, device), extras=ULPDAExtras(
            y=_t(y, device), xbar=_t(xbar, device), xprev=_t(xprev, device))),
        moments=RunningMoments(count=int(count), mean=_t(mean, device),
                               m2=_t(m2, device)),
        quantile_state=qstate,
    )


def packed_state_from_numpy(x, mean, m2, count, qh=None, qn=None, y=None,
                            xbar=None, device=None) -> FusedChainResult:
    """The state of a JAX packed result (``run_myula_tv_fused_packed`` or
    ``run_ulpda_fused_packed``): pass its ``final_state.position`` and
    ``moments.mean/m2`` (chain-major, ``(C, ny, nx)``), ``moments.count``,
    ``quantile_state`` (which the JAX runner returns lane-packed, ``(5
    n_q, ny, C nx)``) and the ULPDA extras ``y`` ``(2, C, ny, nx)`` and
    ``xbar``. The markers come back chain-major, ``(C, 5 n_q, ny, nx)``, the
    port's layout. Continue the chains with the port's packed runner of the
    same name, ``x0=res.final_state.position``, ``quantile_state=
    res.quantile_state`` (MYULA) or ``y0=res.final_state.extras.y,
    xbar0=res.final_state.extras.xbar`` (ULPDA) and ``step_offset=<steps
    done>``, under the port's own key, and merge the moments chain by chain
    with ``RunningMoments.merge``."""
    x = _t(x, device)
    qstate = None if qh is None else tuple(
        unpack_lanes(_t(q, device), x.shape[-1]) for q in (qh, qn))
    extras = None if y is None else ULPDAExtras(y=_t(y, device), xbar=_t(xbar, device))
    return FusedChainResult(
        final_state=SamplerState.init(x, extras=extras),
        moments=RunningMoments(count=int(count), mean=_t(mean, device),
                               m2=_t(m2, device)),
        quantile_state=qstate,
    )


def farm_bundle_from_numpy(position, count, mean, m2, done, key, qh=None,
                           qn=None, y=None, xprev=None, device=None) -> dict:
    """The bundle of a JAX ``run_resumable_fused`` chain farm (an ``x0`` of
    shape ``(C, ny, nx)``) as the port's: pass its ``position``, per-chain
    ``moments.count/mean/m2``, ``done``, ``quantile_state`` (chain-major in
    both packages) and, for runner ``"ulpda_tiled"``, ``ulpda_extras`` (``y``
    ``(C, 2, ny, nx)`` and ``xprev``). ``key`` is the port's base key the
    farm goes on under: the JAX key's threefry streams have no counterpart
    in the port. Save the bundle with ``core.checkpoint.save_checkpoint``
    and call the port's ``run_resumable_fused`` with that ``ckpt_path``, the
    same ``key`` and the runner's options to continue the farm."""
    bundle = {"position": _t(position, device),
              "moments": RunningMoments(count=torch.as_tensor(np.array(count)),
                                        mean=_t(mean, device), m2=_t(m2, device)),
              "key": base_key(key),
              "done": int(done)}
    if qh is not None:
        bundle["quantile_state"] = (_t(qh, device), _t(qn, device))
    if y is not None:
        bundle["ulpda_extras"] = (_t(y, device), _t(xprev, device))
    return bundle


def gaussian_mixture_from_numpy(mus, sigmas, log_weights, precs, log_norms, chols,
                                device=None) -> GaussianMixture:
    """The port's ``GaussianMixture`` from the JAX dataclass's fields."""
    return GaussianMixture(mus=_t(mus, device), sigmas=_t(sigmas, device),
                           log_weights=_t(log_weights, device), precs=_t(precs, device),
                           log_norms=_t(log_norms, device), chols=_t(chols, device))


def grid_mixture_from_numpy(mus, sigma, lam, device=None) -> GridGaussianMixture:
    """The port's ``GridGaussianMixture`` from the JAX dataclass's fields
    (``sigma`` and ``lam`` become Python floats)."""
    return GridGaussianMixture(mus=_t(mus, device), sigma=float(sigma), lam=float(lam))


def laplace_mixture_from_numpy(mus, alphas, log_weights, lam, device=None) -> LaplaceMixture:
    """The port's ``LaplaceMixture`` from the JAX dataclass's fields."""
    return LaplaceMixture(mus=_t(mus, device), alphas=_t(alphas, device),
                          log_weights=_t(log_weights, device), lam=_t(lam, device))


def composite_from_numpy(mixture, mu, alpha, lam, device=None) -> MixtureWithLaplacePrior:
    """The port's ``MixtureWithLaplacePrior``: pass the mixture as the port's
    model (``gaussian_mixture_from_numpy``), the prior's ``mu`` and
    ``alpha`` and the target's ``lam``."""
    return MixtureWithLaplacePrior(
        mixture=mixture, prior=LaplacePrior(mu=_t(mu, device), alpha=_t(alpha, device)),
        lam=_t(lam, device))


def mvlaplace_from_numpy(mean, cov, prec_u, log_det_cov, color,
                         device=None) -> MultivariateLaplace:
    """The port's ``MultivariateLaplace`` from the JAX dataclass's fields."""
    return MultivariateLaplace(mean=_t(mean, device), cov=_t(cov, device),
                               prec_u=_t(prec_u, device),
                               log_det_cov=_t(log_det_cov, device), color=_t(color, device))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.array(v)


def _load_flax(model, params, rename: Callable, transposed=(), dtype=None, device=None):
    """Load a flax parameter tree (nested dicts of arrays, with or without
    the top ``"params"`` level) into ``model``: module path ``(a, b, ...)``
    becomes ``rename(a).rename(b)...``; conv kernels HWIO -> OIHW, those of
    the top-level modules in ``transposed`` (flax ``ConvTranspose``) HWIO ->
    ``(in, out, kh, kw)`` flipped in both spatial axes, dense kernels
    transposed."""
    state = {}
    for path, a in _flat(params.get("params", params)):
        *mods, leaf = path
        name = ".".join(rename(m) for m in mods)
        t = torch.as_tensor(a)
        if leaf == "kernel":
            if t.ndim == 4 and mods[0] in transposed:
                t = t.permute(2, 3, 0, 1).flip(2, 3)
            elif t.ndim == 4:
                t = t.permute(3, 2, 0, 1)
            else:
                t = t.T
            state[name + ".weight"] = t
        else:
            state[name + ".bias"] = t
    model.to(device=device, dtype=dtype if dtype is not None else
             next(iter(state.values())).dtype)
    model.load_state_dict({k: v.contiguous() for k, v in state.items()})
    return model


def _indexed(names: dict):
    """``name<i>`` -> ``names[name].<i>`` for the flax modules in ``names``."""
    def rename(m):
        hit = re.fullmatch(r"([a-z_]+?)(\d+)", m)
        return f"{names[hit[1]]}.{hit[2]}" if hit and hit[1] in names else m
    return rename


def dncnn_from_numpy(params, dtype=None, device=None) -> DnCNN:
    """The port's ``DnCNN`` with the weights of the JAX package's flax
    ``DnCNN`` parameters (depth and width read from them)."""
    p = params.get("params", params)
    depth = len(p)
    features = np.shape(p["conv0"]["kernel"])[-1] if depth > 1 else 1
    return _load_flax(DnCNN(depth, features), p, lambda m: f"convs.{m}", dtype=dtype,
                      device=device)


def score_net_from_numpy(params, dtype=None, device=None) -> ScoreNet:
    """The port's ``ScoreNet`` from the flax ``ScoreNet`` parameters."""
    p = params.get("params", params)
    depth = sum(1 for k in p if re.fullmatch(r"conv\d+", k)) + 2
    model = ScoreNet(depth, np.shape(p["conv_in"]["kernel"])[-1],
                     np.shape(p["sigma_embed"]["emb1"]["kernel"])[-1])
    rename = _indexed({"conv": "convs", "film_s": "film_s", "film_b": "film_b"})
    return _load_flax(model, p, rename, dtype=dtype, device=device)


def score_unet_from_numpy(params, dtype=None, device=None) -> ScoreUNet:
    """The port's ``ScoreUNet`` from the flax ``ScoreUNet`` parameters."""
    p = params.get("params", params)
    levels = sum(1 for k in p if re.fullmatch(r"down\d+", k))
    features = tuple(np.shape(p[f"down{i}"]["conv"]["kernel"])[-1] for i in range(levels))
    model = ScoreUNet(features + (np.shape(p["mid0"]["conv"]["kernel"])[-1],),
                      np.shape(p["sigma_embed"]["emb1"]["kernel"])[-1])
    rename = _indexed({"down": "down", "pool": "pool", "up": "up", "dec": "dec"})
    transposed = tuple(f"up{i}" for i in range(levels))
    return _load_flax(model, p, rename, transposed, dtype=dtype, device=device)


def to_numpy(obj: Any) -> Any:
    """Tensors to numpy arrays, through tuples, lists, dicts and dataclass or
    NamedTuple results (as a dict of their fields)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_asdict"):
        return {k: to_numpy(v) for k, v in obj._asdict().items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    if hasattr(obj, "__dataclass_fields__"):
        return {k: to_numpy(getattr(obj, k)) for k in obj.__dataclass_fields__}
    return obj

