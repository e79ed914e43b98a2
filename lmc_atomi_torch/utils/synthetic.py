"""Random synthetic and photographic training images (counterpart of
``lmc_atomi_tpu/utils/synthetic.py``), made on the device.

Training data of the learned priors (``models/dncnn.py``,
``models/score.py``): random piecewise-smooth phantoms, random 1/f terrains
and random dihedral-augmented patches of the bundled photographs, in [0, 1].
A batch is a pure function of its key ``(seed, chain, step)`` (or ``(seed,
chain)``, step 0): all of its random numbers come from one
``core.random.uniform_field`` draw (and a terrain's white noise from one
``normal_field``), element ``b`` of the batch taking its own slice. The
shape families, value ranges and augmentation are the JAX package's; its
threefry streams differ from the port's Philox by design.
"""
from __future__ import annotations

import numpy as np
import torch

from lmc_atomi_torch.core.random import normal_field, uniform_field

__all__ = [
    "random_phantom",
    "random_phantom_batch",
    "random_terrain",
    "random_terrain_batch",
    "photo_bank",
    "crop_patches",
    "random_photo_patch",
    "random_photo_batch",
]


def _key3(key):
    """``(seed, chain, step)`` from a seed, a ``(seed, chain)`` pair or a
    triple; the step may be an int64 tensor of ``T`` steps."""
    if isinstance(key, (tuple, list)):
        step = key[2] if len(key) > 2 else 0
        return (int(key[0]), int(key[1]),
                step if isinstance(step, torch.Tensor) else int(step))
    return int(key), 0, 0


def _lead(step):
    return tuple(step.shape) if isinstance(step, torch.Tensor) else ()


def _uniforms(key, batch: int, per: int, dtype, device):
    """``(lead + (batch,), u)``: ``per`` uniforms for each image, ``u`` of
    shape ``(images, per)``; ``lead`` is ``(T,)`` for a tensor of steps."""
    seed, chain, step = _key3(key)
    u = uniform_field(seed, chain, step, (batch, per), dtype, device)
    return _lead(step) + (batch,), u.reshape(-1, per)


def random_phantom_batch(key, batch: int, n: int, n_shapes: int = 6,
                         dtype=torch.float32, device=None):
    """``batch`` random piecewise-smooth n x n images in [0, 1]: a random
    linear ramp, then ``n_shapes`` disks or rectangles (even odds) of random
    centre in [0.1, 0.9), half-size in [0.05, 0.35) and value in [0, 1)
    painted in turn (a pixel takes the last shape that covers it). A key
    with a tensor of ``T`` steps gives ``(T, batch, n, n)``, each step's
    batch equal to its own draw."""
    lead, u = _uniforms(key, batch, 3 + 6 * n_shapes, dtype, device)
    grid = torch.arange(n, dtype=dtype, device=device) / n
    yy, xx = grid[:, None], grid[None, :]
    img = (0.2 + 0.3 * u[:, 0, None, None] + 0.3 * u[:, 1, None, None] * xx
           + 0.3 * u[:, 2, None, None] * yy)
    shp = u[:, 3:].reshape(-1, n_shapes, 6)[..., None, None]  # (images, shapes, 6, 1, 1)
    is_disk = shp[:, :, 0] < 0.5
    cy, cx = 0.1 + 0.8 * shp[:, :, 1], 0.1 + 0.8 * shp[:, :, 2]
    sy, sx = 0.05 + 0.3 * shp[:, :, 3], 0.05 + 0.3 * shp[:, :, 4]
    disk = ((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2 < 1.0
    rect = ((yy - cy).abs() < sy) & ((xx - cx).abs() < sx)
    covered = torch.where(is_disk, disk, rect)  # (images, shapes, n, n)
    order = torch.arange(1, n_shapes + 1, device=device)[:, None, None]
    last = (covered * order).amax(dim=1)  # 1 + the last covering shape, 0: none
    val = shp[:, :, 5, 0, 0].gather(1, (last - 1).clamp(min=0).reshape(len(u), -1))
    img = torch.where(last > 0, val.reshape(last.shape), img)
    return img.clamp(0.0, 1.0).reshape(lead + (n, n))


def random_phantom(key, n: int, n_shapes: int = 6, dtype=torch.float32, device=None):
    """One random piecewise-smooth n x n image in [0, 1]."""
    return random_phantom_batch(key, 1, n, n_shapes, dtype, device)[0]


def _quantile(v, q):
    """Per-row linear-interpolation quantile (``jnp.quantile``'s default) of
    ``v`` (B, N) at ``q`` (B,)."""
    s = torch.sort(v, dim=1).values
    pos = q * (v.shape[1] - 1)
    lo = pos.floor().long().clamp(0, v.shape[1] - 1)
    hi = (lo + 1).clamp(max=v.shape[1] - 1)
    frac = (pos - lo.to(pos.dtype))[:, None]
    a, b = s.gather(1, lo[:, None]), s.gather(1, hi[:, None])
    return (a + frac * (b - a))[:, 0]


def random_terrain_batch(key, batch: int, n: int, dtype=torch.float32, device=None,
                         beta: float = 1.6):
    """``batch`` random natural-statistics textured images in [0, 1]: white
    noise shaped by a radial 1/f^b filter (b = ``beta`` +- 0.2), a tanh tone
    curve and a dark ridge along the level set of a random quantile in
    [0.35, 0.75)."""
    seed, chain, step = _key3(key)
    lead = _lead(step) + (batch,)
    white = normal_field(seed, chain, step, (batch, n, n), dtype, device).reshape(-1, n, n)
    u = uniform_field(seed, chain, step, (batch, 2), dtype, device).reshape(-1, 2)
    batch = len(u)
    f = torch.fft.fftfreq(n, dtype=dtype, device=device)
    rad = torch.sqrt(f[:, None] ** 2 + f[None, :] ** 2)
    rad[0, 0] = 1.0 / n
    b = beta + 0.2 * (2.0 * u[:, 0] - 1.0)
    spec = torch.fft.fft2(white) * rad ** (-b[:, None, None])
    spec[:, 0, 0] = 0.0
    base = torch.fft.ifft2(spec).real.to(dtype)
    flat = base.reshape(batch, -1)
    base = (base - flat.mean(1)[:, None, None]) / (
        flat.std(1, correction=0)[:, None, None] + 1e-12)
    img = 0.5 + 0.2 * torch.tanh(0.9 * base)
    thr = _quantile(base.reshape(batch, -1), 0.35 + 0.4 * u[:, 1])
    img = torch.where((base - thr[:, None, None]).abs() < 0.035, 0.35 * img, img)
    return img.clamp(0.0, 1.0).reshape(lead + (n, n))


def random_terrain(key, n: int, dtype=torch.float32, device=None, beta: float = 1.6):
    """One random natural-statistics n x n image in [0, 1]."""
    return random_terrain_batch(key, 1, n, dtype, device, beta)[0]


_PHOTO_BANK_CACHE: dict = {}


def photo_bank(dtype=torch.float32, device=None) -> torch.Tensor:
    """The bundled photographs (einstein, hopper) as a (2, 512, 512) stack
    in [0, 1], decoded once per dtype and device and cached (the decode is
    host-side numpy, at f64: the PNGs are 8-bit, so f64/255 is exact)."""
    from lmc_atomi_torch.utils.images import einstein, hopper

    dev = torch.device(device) if device is not None else torch.device("cpu")
    key = (dtype, str(dev))
    if key not in _PHOTO_BANK_CACHE:
        bank = np.stack([einstein(512, np.float64), hopper(512, np.float64)]) / 255.0
        _PHOTO_BANK_CACHE[key] = torch.as_tensor(bank, dtype=dtype, device=dev)
    return _PHOTO_BANK_CACHE[key]


def crop_patches(bank, n: int, index, y0, x0, flip_y, flip_x, transpose):
    """Patches ``bank[index[b], y0[b]:y0[b]+n, x0[b]:x0[b]+n]``, flipped up-down,
    then left-right, then transposed where the boolean tensors say so: the
    deterministic half of ``random_photo_patch`` (all arguments (B,))."""
    r = torch.arange(n, device=bank.device)
    p = bank[index[:, None, None], (y0[:, None] + r)[:, :, None],
             (x0[:, None] + r)[:, None, :]]
    p = torch.where(flip_y[:, None, None], p.flip(1), p)
    p = torch.where(flip_x[:, None, None], p.flip(2), p)
    return torch.where(transpose[:, None, None], p.transpose(1, 2), p)


def _randint(u, high: int):
    return (u * high).long().clamp(max=high - 1)


def random_photo_batch(key, batch: int, n: int, dtype=torch.float32, device=None,
                       bank=None):
    """``batch`` random n x n patches of the photographs (``photo_bank``):
    a uniform source image and corner, and each dihedral flip (up-down,
    left-right, transpose) with probability 1/2, the standard
    denoiser-training augmentation."""
    bank = photo_bank(dtype, device) if bank is None else bank
    lead, u = _uniforms(key, batch, 6, bank.dtype, bank.device)
    return crop_patches(bank, n, _randint(u[:, 0], bank.shape[0]),
                        _randint(u[:, 1], bank.shape[1] - n + 1),
                        _randint(u[:, 2], bank.shape[2] - n + 1),
                        u[:, 3] < 0.5, u[:, 4] < 0.5, u[:, 5] < 0.5).reshape(lead + (n, n))


def random_photo_patch(key, n: int, bank):
    """One random augmented n x n patch of ``bank``."""
    return random_photo_batch(key, 1, n, bank=bank)[0]


# the training image classes: key, batch, n, dtype=, device= -> (batch, n, n)
GENERATORS = {"phantom": random_phantom_batch, "terrain": random_terrain_batch,
              "photo": random_photo_batch}
