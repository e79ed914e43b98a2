"""Small reductions in a fixed order, for steps batched over chains.

A chain's bits must not depend on how many chains share a call (``run_chains``
holds each chain to its one-chain run). torch picks a reduction's schedule,
and so its order of sums, by the shape (a batched matrix product by the
batch, a CUDA reduction by the number of outputs), and its CPU ``sinh`` and
``pow`` round the vector path and the scalar remainder loop apart. So the
mixture models and kernels sum a small axis left to right, one elementwise
add a term (``fsum``; ``max`` is exact in any order), multiply matrices by
vectors as broadcast products summed so (``matvec``), and build
``logsumexp`` and ``softmax`` from these; elementwise ops round alike
wherever an element lies. A longer axis (the grid mixture's 25 modes) sums
as a tree of halves (``tsum``): as batch-free as ``fsum`` in a handful of
launches. The JAX package's ``einsum``, ``logsumexp`` and
``softmax`` give the same values up to rounding.
"""
from __future__ import annotations

import torch

__all__ = ["fsum", "tsum", "matvec", "logsumexp", "softmax"]


def fsum(t, dim: int):
    """Sum along ``dim`` left to right, one add a term."""
    parts = t.unbind(dim)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def tsum(t, dim: int = -1):
    """Sum along ``dim`` as a tree: zero-padded to a power of two, then the
    first half plus the second, until one term is left."""
    n = t.shape[dim]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        dim = dim % t.ndim
        pad = [0, 0] * (t.ndim - 1 - dim) + [0, width - n]
        t = torch.nn.functional.pad(t, pad)
    while width > 1:
        width //= 2
        t = t.narrow(dim, 0, width) + t.narrow(dim, width, width)
    return t.squeeze(dim)


def matvec(a, v):
    """``a @ v`` over the last axes, batched over leading ones."""
    return fsum(a * v[..., None, :], -1)


def logsumexp(t):
    """``log sum exp`` over the last axis (finite entries)."""
    m = t.amax(-1, keepdim=True)
    return m[..., 0] + torch.log(fsum(torch.exp(t - m), -1))


def softmax(t):
    """``softmax`` over the last axis: ``exp(t - logsumexp(t))``."""
    return torch.exp(t - logsumexp(t)[..., None])
