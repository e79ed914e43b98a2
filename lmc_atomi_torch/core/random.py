"""Counter-based noise (counterpart of ``lmc_atomi_tpu/core/random.py``).

Every normal in the port is a pure function of ``(seed, chain, step,
pixel)``: Philox4x32-10 (Salmon et al. 2011) keyed by ``(seed, chain)`` on the
counter ``(pixel index, global step, 0, 0)``, then Box-Muller on the top 24
bits of the first two output words, as the fused TPU kernel's
``_box_muller2`` does. This mirrors the JAX package's ``fold_in(chain)`` /
``fold_in(step)`` key discipline, and it makes a chain independent of the
block size, lets a resumed chain continue bit for bit, and lets the CUDA
block kernel (``csrc/tv_common.cuh::lmc_normal``, the same function) be held
against its plain version with noise on. The stream differs from threefry.

MALA's accept draw, ``uniform_scalar``, is one uniform per (seed, chain,
step) on the counter ``(0, step, 1, 0)``: its third word is 1 where every
``normal_field`` counter has 0, so the two streams never share a counter (the
counterpart of ``jax.random.split`` of the step key in
``lmc_atomi_tpu/kernels/langevin.py::mala``).

``uniform_field`` draws a field of uniforms on the counter ``(k, step, 2,
0)``: the training data of the learned priors (``utils/synthetic.py``) and
their initial weights. ``normal_field(..., stream=j)`` puts ``j`` in counter
word 3, a stream of its own for each ``j`` (a predictor-corrector step's
corrector sweeps, the counterpart of ``fold_in(step_key, j)``).

Chains of one run take the keys ``chain_keys(key, n)``: ``(seed, chain_i)``
with ``chain_i`` a pure function of ``(seed, chain, i)``, distinct for
distinct ``i`` (the counterpart of ``fold_in(base, i)``). ``normal_field``
and ``uniform_scalar`` also take ``chain`` as an int64 tensor of ``C`` such
words and ``step`` as one of ``B`` steps and draw them all at once, each
entry equal bit for bit to its own call: Philox is elementwise, so the words
broadcast.

uint32 arithmetic is emulated in int64 with ``& 0xFFFFFFFF``. A 32x32-bit
product needs 64 bits: int64 tensor arithmetic wraps it modulo 2^64 (two's
complement on the CPU and the card), which leaves its low and high 32-bit
words intact, so one multiply gives both (``>>`` is arithmetic, so the high
word is masked). A step is launch-bound (~140 int64 launches of a Philox
draw), so each launch saved counts.
"""
from __future__ import annotations

import math

import torch

__all__ = ["philox4x32_10", "normal_field", "uniform_scalar", "uniform_field",
           "chain_keys", "fold_in", "as_key", "step_key", "normal_like"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
_CHAIN_TAG = 0x43484E53  # chain_keys' counter word 3; every noise counter has 0


def _mulhilo(m: int, a):
    """``(hi, lo)`` 32-bit words of ``m * a`` for uint32 ``m`` and ``a`` (an
    int64 tensor wraps the product, a Python int holds it)."""
    p = a * m
    return (p >> 32) & _MASK, p & _MASK


def philox4x32_10(counter, key):
    """Philox4x32-10 of a 4-word ``counter`` under a 2-word ``key``.

    Words are int64 tensors (or Python ints, which broadcast) holding values
    in ``[0, 2^32)``; returns the four output words the same way.
    """
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _MASK, key[1] & _MASK
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        # the words' xor first: one launch fewer where both are ints
        c0, c1, c2, c3 = hi1 ^ (c1 ^ k0), lo1, hi0 ^ (c3 ^ k1), lo0
    return c0, c1, c2, c3


def _words(chain, step):
    """``(leading shape, key word, step word)``: ints for one chain at one
    step; a tensor of ``C`` chain words and/or of ``B`` steps becomes a
    word that broadcasts against the counters, leading ``(B, C)``."""
    chain_lead = tuple(chain.shape) if isinstance(chain, torch.Tensor) else ()
    step_lead = tuple(step.shape) if isinstance(step, torch.Tensor) else ()
    word = chain.reshape(-1, 1) if chain_lead else int(chain)
    if step_lead:
        step = step.reshape((-1,) + (1,) * (len(chain_lead) + 1)) & _MASK
    else:
        step = int(step) & _MASK
    return step_lead + chain_lead, word, step


def _counters(shape, device, origin=None, global_shape=None):
    """Row-major indices of the elements of ``shape``: ``0..n-1``, or with
    ``origin`` those of the block of ``shape`` at ``origin`` inside a field
    of ``global_shape``."""
    if origin is None:
        return torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    if len(origin) != len(shape) or len(global_shape) != len(shape) or any(
            o < 0 or o + s > g for o, s, g in zip(origin, shape, global_shape)):
        raise ValueError(f"block {tuple(shape)} at {tuple(origin)} does not lie in a "
                         f"field of {tuple(global_shape)}")
    k = torch.zeros((), dtype=torch.int64, device=device)
    for o, s, g in zip(origin, shape, global_shape):
        k = k[..., None] * g + torch.arange(o, o + s, dtype=torch.int64, device=device)
    return k.reshape(-1)


def normal_field(seed: int, chain, step, shape, dtype, device, stream: int = 0,
                 origin=None, global_shape=None):
    """Standard normals of ``shape`` for one (seed, chain, step); element
    ``k`` of the row-major flattening uses counter ``(k, step, 0, stream)``.
    ``chain`` may be an int64 tensor of ``C`` words and ``step`` one of
    ``B`` steps: the result is then ``(B, C, *shape)`` (either axis only
    where given), entry ``[b, i]`` the draw of ``(chain[i], step[b])``.

    With ``origin`` (and ``global_shape``) the draw is the block of
    ``shape`` at ``origin`` of the field of ``global_shape``: each element
    keeps the counter of its global row-major index, so the block equals
    that slice of the whole field bit for bit (a rank of a sharded image
    draws its rows and columns only)."""
    lead, word, step = _words(chain, step)
    pixel = _counters(shape, device, origin, global_shape)
    w0, w1, _, _ = philox4x32_10((pixel, step, 0, int(stream)), (int(seed), word))
    u1 = (w0 >> 8).to(dtype) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))
    u2 = (w1 >> 8).to(dtype) * (1.0 / (1 << 24))
    r = torch.sqrt(-2.0 * torch.log(u1))
    return (r * torch.cos((2.0 * math.pi) * u2)).reshape(lead + tuple(shape))


def uniform_scalar(seed: int, chain, step, dtype, device):
    """One uniform in ``(0, 1)`` for (seed, chain, step), as a 0-d tensor on
    ``device`` (``(B, C)`` for tensors of ``B`` steps and ``C`` chain words,
    as ``normal_field``): the top 24 bits of the first word of counter
    ``(0, step, 1, 0)``, centred in its bin like ``normal_field``'s ``u1``."""
    lead, word, step = _words(chain, step)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    w0, _, _, _ = philox4x32_10((zero, zero + step, zero + 1, zero), (int(seed), word))
    return ((w0 >> 8).to(dtype) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))).reshape(lead)


def uniform_field(seed: int, chain, step, shape, dtype, device):
    """Uniforms in ``(0, 1)`` of ``shape`` for one (seed, chain, step):
    element ``k`` of the row-major flattening takes the top 24 bits of the
    first word of counter ``(k, step, 2, 0)``, centred in its bin as
    ``uniform_scalar``'s; ``chain`` and ``step`` may be tensors, as in
    ``normal_field``."""
    lead, word, step = _words(chain, step)
    n = math.prod(shape)
    k = torch.arange(n, dtype=torch.int64, device=device)
    w0, _, _, _ = philox4x32_10((k, step, 2, 0), (int(seed), word))
    return ((w0 >> 8).to(dtype) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))).reshape(
        lead + tuple(shape))


def _fmix32(h: int) -> int:
    """MurmurHash3's 32-bit finaliser, a bijection of ``[0, 2^32)``."""
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK
    return h ^ (h >> 16)


def chain_keys(key, n_chains: int):
    """``n_chains`` keys ``(seed, chain_i)`` of independent chains of one
    run: ``key`` is a seed or ``(seed, chain)``, and

        (w0, w1, _, _) = philox4x32_10((chain, 0, 0, 0x43484E53), (seed, 0))
        chain_i = fmix32((w0 + i) mod 2^32) xor w1

    with ``fmix32`` MurmurHash3's finaliser. Chain ``i`` then draws its
    noise under ``(seed, chain_i)``. ``chain_i`` is a pure function of
    ``(seed, chain, i)``; ``fmix32`` and the xor are bijections, so the words
    are distinct for distinct ``i < 2^32``, and the tag in counter word 3
    keeps this draw off every noise counter (whose word 3 is 0). The
    counterpart of the JAX package's ``fold_in(base, i)``; its streams differ
    from threefry's by design."""
    seed, w0, w1 = _chain_words(key)
    return [(seed, _fmix32((w0 + i) & _MASK) ^ w1) for i in range(int(n_chains))]


def _chain_words(key):
    """``(seed, w0, w1)`` of ``chain_keys``'s formula for ``key``."""
    if isinstance(key, (tuple, list)):
        seed, chain = (int(v) for v in key)
    else:
        seed, chain = int(key), 0
    w0, w1, _, _ = philox4x32_10((chain & _MASK, 0, 0, _CHAIN_TAG), (seed, 0))
    return seed, w0, w1


def fold_in(key, i: int):
    """The key ``chain_keys(key, i + 1)[i]``, the counterpart of the JAX
    package's ``fold_in(key, i)``: a key of its own for each index ``i``."""
    seed, w0, w1 = _chain_words(key)
    return seed, _fmix32((w0 + int(i)) & _MASK) ^ w1


def as_key(key):
    """``(seed, chain)`` of an int seed or a ``(seed, chain)`` pair (the
    counterpart of the JAX package's ``as_key``); a chain given as a tensor
    of words (a chain axis) stays a tensor."""
    if isinstance(key, (tuple, list)):
        seed, chain = key
        return int(seed), chain if isinstance(chain, torch.Tensor) else int(chain)
    return int(key), 0


def step_key(key, step: int):
    """The key ``(seed, chain, step)`` of step ``step`` of the chain ``key``
    (the counterpart of ``fold_in(base, step)``): the key a kernel's step
    receives from the runner."""
    return as_key(key) + (int(step),)


def normal_like(key, x):
    """``normal_field`` of a step key ``(seed, chain, step)`` over ``x``:
    one chain, or with ``chain`` a tensor of ``C`` words the ``C`` chains
    of ``x``'s leading axis."""
    seed, chain, step = key
    lead = int(isinstance(chain, torch.Tensor))
    return normal_field(seed, chain, step, tuple(x.shape[lead:]), x.dtype, x.device)
