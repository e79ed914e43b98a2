"""Noise-conditional score prior (counterpart of
``lmc_atomi_tpu/models/score.py``).

A net ``eps_hat(x, sigma)`` learns the noise of ``x = x0 + sigma z`` across a
geometric ladder of levels by denoising score matching (an NCSN-style net,
Song and Ermon 2019); the score is ``-eps_hat / sigma``.

  * ``ScoreNet``: a flat residual CNN with FiLM conditioning on Fourier
    features of ``log sigma``;
  * ``ScoreUNet``: an encoder/decoder with stride-2 convs down, transposed
    convs up and concatenated skips, for the long-range structure of the
    coarse levels;
  * ``make_score_fn`` and ``score_to_denoiser`` (Tweedie: ``D(x) = x +
    sigma^2 s(x)``) plug the net into ``kernels.imaging.score_ula`` and
    ``pnp_ula``.

flax's 'SAME' padding is matched exactly: a stride-2 3 x 3 conv of an even
side pads (0, 1), a stride-2 ``ConvTranspose`` is ``conv_transpose2d`` of
the spatially flipped kernel cropped to twice the input side (the flipping
lives in ``interop.py``; this module keeps torch's layout). The layers are
library calls, as in ``models/dncnn.py``, and run under its
``net_precision``.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lmc_atomi_torch.core.random import chain_keys, normal_field, uniform_field
from lmc_atomi_torch.models.dncnn import chunked, fit, lecun_init, net_precision
from lmc_atomi_torch.utils.synthetic import GENERATORS

__all__ = [
    "ScoreNet",
    "ScoreUNet",
    "train_score_net",
    "draw_many",
    "score_loss",
    "make_score_fn",
    "score_to_denoiser",
    "geometric_sigmas",
]


def geometric_sigmas(sigma_max: float, sigma_min: float, n: int, dtype=torch.float32,
                     device=None):
    """Geometric noise ladder sigma_max -> sigma_min (NCSN convention)."""
    logs = torch.linspace(math.log(sigma_max), math.log(sigma_min), n, dtype=torch.float64)
    return torch.exp(logs).to(dtype=dtype, device=device)


class _SigmaEmbed(nn.Module):
    """log-sigma -> sin and cos of 8 octaves -> two dense SiLU layers."""

    def __init__(self, features: int = 64):
        super().__init__()
        self.emb1 = nn.Linear(16, features)
        self.emb2 = nn.Linear(features, features)

    def forward(self, sigma):
        logs = torch.log(sigma)[:, None]
        freqs = 2.0 ** torch.arange(0, 8, dtype=logs.dtype, device=logs.device)
        ff = torch.cat([torch.sin(logs * freqs), torch.cos(logs * freqs)], dim=-1)
        return F.silu(self.emb2(F.silu(self.emb1(ff))))


def _film(g, scale, shift):
    return g * (1.0 + scale[:, :, None, None]) + shift[:, :, None, None]


class ScoreNet(nn.Module):
    """Flat noise-conditional residual CNN: ``forward(x, sigma) -> eps_hat``,
    ``x`` (batch, n, n), ``sigma`` (batch,)."""

    def __init__(self, depth: int = 6, features: int = 48, emb_features: int = 64):
        super().__init__()
        self.sigma_embed = _SigmaEmbed(emb_features)
        self.conv_in = nn.Conv2d(1, features, 3, padding=1)
        self.film_s = nn.ModuleList(nn.Linear(emb_features, features) for _ in range(depth - 2))
        self.film_b = nn.ModuleList(nn.Linear(emb_features, features) for _ in range(depth - 2))
        self.convs = nn.ModuleList(nn.Conv2d(features, features, 3, padding=1)
                                   for _ in range(depth - 2))
        self.conv_out = nn.Conv2d(features, 1, 3, padding=1)

    def forward(self, x, sigma):
        emb = self.sigma_embed(sigma)
        h = self.conv_in(x[:, None])
        for fs, fb, conv in zip(self.film_s, self.film_b, self.convs):
            h = h + _film(conv(F.silu(h)), fs(emb), fb(emb))
        return self.conv_out(F.silu(h))[:, 0]


class _FiLMBlock(nn.Module):
    """Pre-activation residual conv block with FiLM conditioning; a 1 x 1
    ``skip`` conv where the channel count changes."""

    def __init__(self, cin: int, features: int, emb_features: int):
        super().__init__()
        self.film_s = nn.Linear(emb_features, features)
        self.film_b = nn.Linear(emb_features, features)
        self.conv = nn.Conv2d(cin, features, 3, padding=1)
        self.skip = nn.Conv2d(cin, features, 1) if cin != features else None

    def forward(self, h, emb):
        g = _film(self.conv(F.silu(h)), self.film_s(emb), self.film_b(emb))
        return (h if self.skip is None else self.skip(h)) + g


def _same_pad_stride2(h):
    """flax's 'SAME' padding of a stride-2 3 x 3 conv: (total // 2, total -
    total // 2) with total = 1 for an even side, 2 for an odd one."""
    pads = []
    for n in (h.shape[-1], h.shape[-2]):
        total = max(((n + 1) // 2 - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(h, pads)


class ScoreUNet(nn.Module):
    """Noise-conditional U-Net: ``forward(x, sigma) -> eps_hat``, ``x``
    (batch, n, n) with n divisible by ``2 ** (len(features) - 1)``."""

    def __init__(self, features: Tuple[int, ...] = (32, 64, 96), emb_features: int = 64):
        super().__init__()
        self.features = tuple(features)
        f = self.features
        self.sigma_embed = _SigmaEmbed(emb_features)
        self.conv_in = nn.Conv2d(1, f[0], 3, padding=1)
        self.down = nn.ModuleList(_FiLMBlock(f[i], f[i], emb_features)
                                  for i in range(len(f) - 1))
        self.pool = nn.ModuleList(nn.Conv2d(f[i], f[i + 1], 3, stride=2)
                                  for i in range(len(f) - 1))
        self.mid0 = _FiLMBlock(f[-1], f[-1], emb_features)
        self.mid1 = _FiLMBlock(f[-1], f[-1], emb_features)
        self.up = nn.ModuleList(nn.ConvTranspose2d(f[i + 1], f[i], 3, stride=2)
                                for i in range(len(f) - 1))
        self.dec = nn.ModuleList(_FiLMBlock(2 * f[i], f[i], emb_features)
                                 for i in range(len(f) - 1))
        self.conv_out = nn.Conv2d(f[0], 1, 3, padding=1)

    def forward(self, x, sigma):
        emb = self.sigma_embed(sigma)
        h = self.conv_in(x[:, None])
        skips = []
        for down, pool in zip(self.down, self.pool):
            h = down(h, emb)
            skips.append(h)
            h = pool(_same_pad_stride2(h))
        h = self.mid1(self.mid0(h, emb), emb)
        for i in reversed(range(len(self.up))):
            n, m = h.shape[-2:]
            h = self.up[i](h)[..., :2 * n, :2 * m]
            h = self.dec[i](torch.cat([h, skips[i]], dim=1), emb)
        return self.conv_out(F.silu(h))[:, 0]


def score_loss(model, clean, sig, z):
    """Denoising score matching in the noise parametrisation: the mean
    squared error of ``eps_hat(clean + sig z, sig)`` against ``z``."""
    return torch.mean((model(clean + sig[:, None, None] * z, sig) - z) ** 2)


def train_score_net(
    key,
    sigma_max: float = 0.5,
    sigma_min: float = 0.01,
    n_sigmas: int = 10,
    patch: int = 40,
    batch: int = 16,
    steps: int = 1500,
    lr: float = 1e-3,
    depth: int = 6,
    features: int = 48,
    arch: str = "cnn",  # 'cnn' (flat ScoreNet) | 'unet' (ScoreUNet)
    unet_features: Tuple[int, ...] = (32, 64, 96),
    image_class: str = "phantom",  # 'phantom' | 'terrain' | 'photo'
    dtype=torch.float32,
    device=None,
):
    """Denoising score matching on random images of ``image_class``; returns
    ``(model, sigmas)``. Step ``i`` draws a batch under ``(k_img, i)``, one
    ladder level per element under ``(k_lvl, i)`` and the noise ``z`` under
    ``(k_noise, i)`` (``DRAW_STEPS`` steps a draw), and regresses ``eps_hat(clean + sigma z, sigma)`` on
    ``z`` (the sigma^2-weighted DSM objective). ``arch="unet"`` trains a
    :class:`ScoreUNet` (``patch`` must divide by ``2 ** (len(unet_features)
    - 1)``)."""
    if image_class not in GENERATORS:
        raise ValueError(f"unknown image class {image_class!r}")
    if arch == "unet":
        model = ScoreUNet(features=tuple(unet_features))
    else:
        model = ScoreNet(depth=depth, features=features)
    sigmas = geometric_sigmas(sigma_max, sigma_min, n_sigmas, dtype, device)
    k_init, k_train = chain_keys(key, 2)
    model = lecun_init(model.to(device=device, dtype=dtype), k_init)
    fit(model, chunked(lambda s: draw_many(k_train, s, sigmas, batch, patch, image_class,
                                           dtype, device), device), score_loss, steps, lr)
    return model.eval(), sigmas


def draw_many(key, steps, sigmas, batch: int = 16, patch: int = 40,
              image_class: str = "phantom", dtype=torch.float32, device=None):
    """The batches of ``train_score_net``'s training steps ``steps`` (an
    int64 tensor of ``T`` steps) under its training key ``key`` (the second
    of ``chain_keys(key, 2)``): ``(clean, sig, z)`` of shapes ``(T, batch,
    patch, patch)``, ``(T, batch)`` and ``(T, batch, patch, patch)``. Step
    ``i`` draws its images under ``(k_img, i)``, one level of the ladder
    ``sigmas`` per element, uniformly, under ``(k_lvl, i)``, and the noise
    under ``(k_noise, i)``, with ``k_img, k_lvl, k_noise = chain_keys(key,
    3)``."""
    k_img, k_lvl, k_noise = chain_keys(key, 3)
    n_sigmas = len(sigmas)
    clean = GENERATORS[image_class]((*k_img, steps), batch, patch, dtype=dtype, device=device)
    u = uniform_field(*k_lvl, steps, (batch,), dtype, device)
    sig = sigmas[(u * n_sigmas).long().clamp(max=n_sigmas - 1)]
    return clean, sig, normal_field(*k_noise, steps, clean.shape[1:], dtype, device)


def make_score_fn(model: nn.Module) -> Callable:
    """``(x, sigma) -> grad log p_sigma(x)`` without autograd, for one image
    ``(n, n)`` or a block of chains ``(C, n, n)`` in one net call; ``sigma``
    a number or a 0-d tensor."""

    def score(x, sigma):
        xb = x.reshape((-1,) + tuple(x.shape[-2:]))
        if isinstance(sigma, torch.Tensor):
            sig = sigma.to(x.dtype).reshape(1).expand(xb.shape[0])
        else:  # a fill on the device: no copy from the host
            sig = torch.full((xb.shape[0],), float(sigma), dtype=x.dtype, device=x.device)
        with torch.no_grad(), net_precision():
            eps_hat = model(xb, sig)
        return (-eps_hat / sig[:, None, None]).reshape(x.shape)

    return score


def score_to_denoiser(score: Callable, sigma: float) -> Callable:
    """Tweedie adapter ``D(x) = x + sigma^2 score(x, sigma)``: an MMSE
    denoiser at noise sd ``sigma``; with ``pnp_ula(..., eps=sigma**2)`` the
    drift ``(D(x) - x)/eps`` is exactly the learned score."""

    def denoise(x):
        return x + sigma**2 * score(x, sigma)

    return denoise
