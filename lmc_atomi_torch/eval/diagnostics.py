"""MCMC convergence diagnostics (counterpart of
``lmc_atomi_tpu/eval/diagnostics.py``): FFT autocorrelation, the Geyer
effective sample size, split-R-hat over stacked samples, and Gelman-Rubin
R-hat from per-chain streaming moments (the fused runners keep only Welford
summaries, no samples).
"""
from __future__ import annotations

import torch

__all__ = [
    "autocorrelation",
    "effective_sample_size",
    "rhat_from_moments",
    "split_rhat",
]


def autocorrelation(x, max_lag=None):
    """Normalized autocorrelation of a ``(steps,)`` or ``(steps, dims)``
    series via FFT (Wiener-Khinchin), as ``(lags, dims)``."""
    x = torch.as_tensor(x)
    x = x.reshape(-1, 1) if x.ndim == 1 else x
    n = x.shape[0]
    xc = x - x.mean(dim=0, keepdim=True)
    size = 2 * n  # zero-padding for linear (not circular) correlation
    f = torch.fft.rfft(xc, n=size, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=size, dim=0)[:n]
    acov = acov / torch.arange(n, 0, -1, dtype=acov.dtype, device=acov.device)[:, None]
    rho = acov / torch.clamp(acov[0:1], min=1e-30)
    if max_lag is not None:
        rho = rho[: max_lag + 1]
    return rho


def effective_sample_size(x):
    """Geyer initial-positive-sequence ESS of a ``(steps,)`` or ``(steps,
    dims)`` series: pairs ``Gamma_m = rho_2m + rho_2m+1`` summed up to the
    first non-positive one, ``tau = 2 sum Gamma_m - 1``, ``ESS = n / tau``
    clipped to ``[1, n]``. A scalar for 1-D input, else ``(dims,)``."""
    x = torch.as_tensor(x)
    squeeze = x.ndim == 1
    rho = autocorrelation(x)  # (n, d)
    n, d = rho.shape
    n_pairs = n // 2
    pair_sums = rho[: 2 * n_pairs].reshape(n_pairs, 2, d).sum(dim=1)
    keep = torch.cumprod((pair_sums > 0).to(rho.dtype), dim=0)
    tau = 2.0 * torch.sum(pair_sums * keep, dim=0) - 1.0
    ess = n / torch.clamp(tau, min=1.0 / n)
    ess = torch.clamp(ess, 1.0, float(n))
    return ess[0] if squeeze else ess


def split_rhat(samples):
    """Split-R-hat of samples ``(chains, steps, ...dims)``: each chain split
    in half, between- against within-half variance; near 1 when the chains
    have mixed."""
    samples = torch.as_tensor(samples)
    c, n = samples.shape[:2]
    half = n // 2
    x = samples[:, : 2 * half].reshape((2 * c, half) + tuple(samples.shape[2:]))
    mean_per = x.mean(dim=1)
    var_per = x.var(dim=1, correction=1)
    w = var_per.mean(dim=0)
    b = half * mean_per.var(dim=0, correction=1)
    var_hat = (half - 1) / half * w + b / half
    return torch.sqrt(var_hat / torch.clamp(w, min=1e-30))


def rhat_from_moments(moments):
    """Gelman-Rubin R-hat from per-chain streaming moments (a
    ``RunningMoments`` with a leading chain axis; ``count`` per chain or
    one count for all): within ``W = mean_c var_c``, between ``B = n
    var_c(mean_c)`` with ``n`` the least count (at least 2), ``rhat =
    sqrt(((n - 1)/n W + B/n) / W)``. ``split_rhat`` is sharper where the
    samples are kept."""
    means = moments.mean  # (chains, ...)
    # the counts in float32, as the JAX package takes them
    cnt = torch.as_tensor(moments.count, dtype=torch.float32, device=means.device)
    cnt = cnt.reshape(-1).expand(means.shape[0]) if cnt.numel() == 1 else cnt
    n = torch.clamp(cnt.min(), min=2.0)
    denom = torch.clamp(cnt - 1.0, min=1.0).reshape((-1,) + (1,) * (means.ndim - 1))
    w = (moments.m2 / denom.to(means.dtype)).mean(dim=0)
    b = n * means.var(dim=0, correction=1)
    var_hat = (n - 1.0) / n * w + b / n
    return torch.sqrt(var_hat / torch.clamp(w, min=1e-30))
