"""Wasserstein-distance evaluation (counterpart of
``lmc_atomi_tpu/eval/wasserstein.py``).

The reference scores a sampler by the exact 2-Wasserstein distance between
true (ancestral) samples and each prefix of the chain, every 100 iterations,
through POT's network-simplex EMD (reference lmc.py:396-414). Here:

  * ``sinkhorn_w2``: entropic OT in the log domain on the device, weighted,
    so prefix curves mask points with ``-inf`` log-weights instead of
    slicing, and batched over prefixes (leading axes of the log-weights);
  * ``sliced_w2``: exact 1-D OT (sorting) averaged over random directions;
  * ``exact_w2`` and friends: the native network simplex
    (``eval/emd_native.py``, ``native/emd.cpp``) on the host, with the
    Hungarian assignment for equal sizes as its fallback.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "pairwise_sq_dists",
    "sinkhorn_w2",
    "sliced_w2",
    "exact_w2",
    "exact_w2_assignment",
    "exact_w2_multiscale",
    "w2_prefix_curve",
    "w2_prefix_curve_exact",
]

# device memory of a chunk of prefixes in ``w2_prefix_curve``: four live
# (chunk, n, m) tensors of a Sinkhorn iteration
_CHUNK_BYTES = 2 << 30


def pairwise_sq_dists(x, y):
    """Squared Euclidean cost matrix (the ``ot.dist`` default)."""
    x2 = torch.sum(x * x, dim=-1)[:, None]
    y2 = torch.sum(y * y, dim=-1)[None, :]
    return torch.clamp(x2 + y2 - 2.0 * x @ y.T, min=0.0)


def _ot_entropic(c, log_wa, log_wb, eps_abs, iters):
    """Log-domain Sinkhorn OT value of cost ``c`` (n, m) at absolute
    regularization ``eps_abs``, batched over the leading axes of the
    log-weights ``log_wa`` (..., n) and ``log_wb`` (..., m)."""
    ceps = c / eps_abs
    f = torch.zeros(log_wa.shape, dtype=c.dtype, device=c.device)
    g = torch.zeros(log_wb.shape, dtype=c.dtype, device=c.device)
    for _ in range(iters):
        # f_i = -log sum_j exp(log_wb_j + g_j - C_ij / eps)  (scaled units)
        f = -torch.logsumexp(log_wb[..., None, :] + g[..., None, :] - ceps, dim=-1)
        g = -torch.logsumexp(log_wa[..., :, None] + f[..., :, None] - ceps, dim=-2)
    # the transport plan in the log domain; masked points carry -inf weight
    log_p = (log_wa[..., :, None] + log_wb[..., None, :] + f[..., :, None]
             + g[..., None, :] - ceps)
    return torch.sum(torch.exp(log_p) * c, dim=(-2, -1))


def _uniform_log_w(n, like):
    return torch.full((n,), -math.log(n), dtype=like.dtype, device=like.device)


def sinkhorn_w2(x, y, log_wx=None, log_wy=None, eps: float = 0.05, iters: int = 200,
                debias: bool = True, scale=None, ot_xx=None):
    """Entropic squared W2 (log-domain Sinkhorn), with ``debias`` the
    Sinkhorn divergence ``OT(x,y) - (OT(x,x) + OT(y,y))/2``.

    ``log_wx``/``log_wy`` are log-weights (default uniform); ``-inf`` masks a
    point out, and leading axes of ``log_wy`` batch several weightings of
    ``y`` into one call. ``scale`` and ``ot_xx`` hoist the cost scale and
    ``OT(x,x)`` out of prefix loops (they must match eps and the weights).
    ``eps`` is relative to the largest cross cost. Returns the squared
    distance (its root is the reference's W2, lmc.py:407)."""
    if log_wx is None:
        log_wx = _uniform_log_w(x.shape[0], x)
    if log_wy is None:
        log_wy = _uniform_log_w(y.shape[0], y)
    cxy = pairwise_sq_dists(x, y)
    if scale is None:
        scale = torch.clamp(torch.max(cxy), min=1e-30)
    eps_abs = eps * scale
    val = _ot_entropic(cxy, log_wx, log_wy, eps_abs, iters)
    if debias:
        xx = (ot_xx if ot_xx is not None
              else _ot_entropic(pairwise_sq_dists(x, x), log_wx, log_wx, eps_abs, iters))
        yy = _ot_entropic(pairwise_sq_dists(y, y), log_wy, log_wy, eps_abs, iters)
        val = val - 0.5 * (xx + yy)
    return torch.clamp(val, min=0.0)


def sliced_w2(x, y, generator=None, n_proj: int = 128):
    """Sliced squared W2: the 1-D OT cost (sorted matching) averaged over
    ``n_proj`` random directions drawn from ``generator``. Equal sample
    counts."""
    dirs = torch.randn((n_proj, x.shape[-1]), generator=generator, dtype=x.dtype,
                       device=x.device)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    px = torch.sort(x @ dirs.T, dim=0).values  # (n, n_proj)
    py = torch.sort(y @ dirs.T, dim=0).values
    return torch.mean(torch.sum((px - py) ** 2, dim=0) / x.shape[0])


def exact_w2_assignment(x, y):
    """Exact squared W2 of equal-size uniform empirical measures through
    the Hungarian algorithm (host; validation sizes)."""
    from scipy.optimize import linear_sum_assignment

    c = pairwise_sq_dists(torch.as_tensor(x), torch.as_tensor(y)).cpu().numpy()
    r, cidx = linear_sum_assignment(c)
    return float(c[r, cidx].mean())


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def exact_w2(x, y):
    """Exact squared W2 between uniform empirical measures of any sizes: the
    native network simplex when it builds, the Hungarian assignment for
    equal sizes otherwise."""
    from lmc_atomi_torch.eval import emd_native

    if emd_native.available():
        return emd_native.exact_w2(_host(x), _host(y))
    if np.shape(x)[0] == np.shape(y)[0]:
        return exact_w2_assignment(x, y)
    raise RuntimeError("exact W2 with unequal sizes requires the native EMD library")


def _lloyd(x, k: int, generator, iters: int):
    """k-means (Lloyd) quantization of an empirical measure on the device,
    started from ``k`` distinct points drawn with ``generator``. Returns
    (centroids (k, d), weights (k,), mean squared quantization error); the
    error is the cost of sending every point to its centroid, so its root
    bounds W2(x, x_quantized) from above."""
    n = x.shape[0]
    c = x[torch.randperm(n, generator=generator, device=x.device)[:k]]

    def onehot(d2):
        return torch.nn.functional.one_hot(torch.argmin(d2, dim=1), k).to(x.dtype)

    for _ in range(iters):
        oh = onehot(pairwise_sq_dists(x, c))
        counts = oh.sum(dim=0)
        c = torch.where(counts[:, None] > 0,
                        (oh.T @ x) / torch.clamp(counts, min=1.0)[:, None], c)
    d2 = pairwise_sq_dists(x, c)
    return c, onehot(d2).sum(dim=0) / n, torch.mean(torch.min(d2, dim=1).values)


def exact_w2_multiscale(x, y, k: int = 4096, generator=None, kmeans_iters: int = 20):
    """Exact W2 past the reference's 10k-point cap (lmc.py:403-406) through
    quantization: Lloyd k-means on the device, then the native network
    simplex between the k-point measures.

    Returns ``(w2_sq_hat, err)``: the exact squared W2 between the quantized
    measures and a certified radius in the (unsquared) W2 metric,
    ``|W2(x, y) - sqrt(w2_sq_hat)| <= err = sqrt(qerr_x) + sqrt(qerr_y)``.
    With ``k >= n`` every point is its own centroid and err is ~0.
    ``generator`` (default: seeded 0 on ``x``'s device) draws both starts."""
    from lmc_atomi_torch.eval import emd_native

    x = torch.as_tensor(x)
    y = torch.as_tensor(y)
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    cx, wx, qx = _lloyd(x, min(k, x.shape[0]), generator, kmeans_iters)
    cy, wy, qy = _lloyd(y, min(k, y.shape[0]), generator, kmeans_iters)
    cost = pairwise_sq_dists(cx, cy).cpu().numpy().astype(np.float64)
    wx = wx.cpu().numpy().astype(np.float64)
    wy = wy.cpu().numpy().astype(np.float64)
    # k-means can leave empty clusters (zero weight): drop them, the
    # network simplex wants strictly feasible supplies
    ix, iy = wx > 0, wy > 0
    val, _ = emd_native.emd2(wx[ix] / wx[ix].sum(), wy[iy] / wy[iy].sum(),
                             cost[np.ix_(ix, iy)])
    err = float(np.sqrt(max(float(qx), 0.0)) + np.sqrt(max(float(qy), 0.0)))
    return float(val), err


def w2_prefix_curve_exact(true_samples, samples, interval: int = 100,
                          max_points: int = 10000):
    """The reference's exact-EMD W2-vs-samples curve (lmc.py:396-414): the
    network simplex between ``true_samples`` and each prefix, on the host,
    both capped at ``max_points`` (strided). Returns (ks, w2) with w2 the
    root of the squared distance."""
    from lmc_atomi_torch.eval import emd_native

    true_np = _host(true_samples)
    s_np = _host(samples)
    ts = true_np[:: max(1, true_np.shape[0] // max_points)]
    ks = list(range(2, s_np.shape[0] + 1, interval))
    vals = []
    for k in ks:
        prefix = s_np[:k]
        if prefix.shape[0] > max_points:
            prefix = prefix[:: prefix.shape[0] // max_points]
        vals.append(np.sqrt(max(emd_native.exact_w2(ts, prefix), 0.0)))
    return np.asarray(ks), np.asarray(vals)


def w2_prefix_curve(true_samples, samples, interval: int = 100, eps: float = 0.05,
                    iters: int = 200, max_points: int = 2000):
    """The reference's W2-vs-sample-count diagnostic (lmc.py:386-414): the
    squared W2 between ``true_samples`` and each prefix ``samples[:k]``,
    k = 2, interval + 2, ..., by masked-weight Sinkhorn. Both sets are
    strided down to at most ``max_points``. The prefixes run in chunks, one
    Sinkhorn a chunk, sized so that a chunk's ``(chunk, n, m)`` tensors stay
    under ~2 GB (the JAX package maps over them one at a time). Returns (ks,
    w2) with w2 the root of the estimate."""
    n = samples.shape[0]
    stride = max(1, n // max_points)
    ks = torch.arange(1, n, interval, device=samples.device) + 1  # k+1 for k=1,101,...
    ts = true_samples[:: max(1, true_samples.shape[0] // max_points)]
    ss = samples[::stride]
    m = ss.shape[0]

    # the loop invariants: the cost scale and the OT(ts, ts) debias term
    scale = torch.clamp(torch.max(pairwise_sq_dists(ts, ss)), min=1e-30)
    log_wt = _uniform_log_w(ts.shape[0], ts)
    ot_tt = _ot_entropic(pairwise_sq_dists(ts, ts), log_wt, log_wt, eps * scale, iters)

    # prefix masks over the strided samples: index * stride < k
    valid = (torch.arange(m, device=ss.device)[None, :] * stride) < ks[:, None]
    cnt = torch.clamp(valid.sum(dim=-1), min=1)
    log_w = torch.where(valid, -torch.log(cnt.to(ss.dtype))[:, None],
                        torch.tensor(-math.inf, dtype=ss.dtype, device=ss.device))
    chunk = max(1, _CHUNK_BYTES // (4 * max(ts.shape[0], m) * m * ss.element_size()))
    vals = torch.cat([sinkhorn_w2(ts, ss, None, lw, eps=eps, iters=iters, scale=scale,
                                  ot_xx=ot_tt)
                      for lw in torch.split(log_w, chunk)])
    return ks, torch.sqrt(torch.clamp(vals, min=0.0))
