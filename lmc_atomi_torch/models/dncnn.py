"""DnCNN denoiser prior for Plug-and-Play ULA (counterpart of
``lmc_atomi_tpu/models/dncnn.py``; BASELINE.json config 5).

A compact residual CNN (Zhang et al. 2017): 3 x 3 conv-ReLU stacks that
predict the noise residual, trained in the repo on random synthetic phantoms
with ``torch.optim.Adam`` (no weights are downloaded).

Spectral control: PnP-ULA's ergodicity argument (Laumont et al. 2022) needs
a Lipschitz denoiser. Training can project every conv kernel onto an exact
circular-conv operator-norm ball (Sedghi, Gupta and Long 2019: the singular
values of a 'SAME' conv are those of its per-frequency FFT transfer
matrices), which certifies ``L(residual) <= prod_i sigma_i`` since ReLU is
1-Lipschitz. ``lipschitz_estimate`` measures the local constant by Jacobian
power iteration (``torch.func.jvp`` / ``vjp``).

The nets' convolutions are library calls (``torch.nn.Conv2d``): the JAX
package computes them as XLA ops, outside any Pallas kernel. On the card
they run in IEEE float32 (``net_precision``: cuDNN's TF32 off), which the
PnP phase of ``chip_smoke.py`` prints. Initial weights follow flax's
defaults (LeCun-normal kernels truncated at 2 standard deviations, zero
biases), drawn from the port's Philox stream.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from lmc_atomi_torch.core.random import chain_keys, fold_in, normal_field, uniform_field
from lmc_atomi_torch.utils.synthetic import random_phantom_batch

__all__ = [
    "DnCNN",
    "net_precision",
    "lecun_init",
    "fit",
    "chunked",
    "train_denoiser",
    "make_denoiser",
    "conv_operator_norms",
    "project_conv_kernels",
    "lipschitz_estimate",
]

NET_TF32 = False  # the nets' cuDNN convolutions: IEEE float32 on the card
# the card's spectral norms: the Gram matrices squared SQUARINGS times, then
# POWER_ITERS power iterations on that power (G^(2^12 * 8) in all)
SQUARINGS, POWER_ITERS = 12, 8


def net_precision():
    """The context the nets run in, training and sampling: cuDNN on, TF32
    ``NET_TF32`` (off), no autotuning (a shape takes the same algorithm in
    every call) and deterministic algorithms: a transposed convolution's
    default one sums with atomics, so two equal calls would differ in the
    last bits, and a fit from a seed would not be reproducible."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                      allow_tf32=NET_TF32)


_TRUNC = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


def _fan_in(module: nn.Module) -> int:
    w = module.weight
    if isinstance(module, nn.ConvTranspose2d):  # (in, out, kh, kw)
        return w.shape[0] * w.shape[2] * w.shape[3]
    return math.prod(w.shape[1:])  # Conv2d (out, in, kh, kw), Linear (out, in)


def lecun_init(model: nn.Module, key) -> nn.Module:
    """flax's default initialisation, from the port's Philox: every conv,
    transposed conv and dense kernel LeCun-normal (``N(0, 1/fan_in)``
    truncated to 2 standard deviations, by the inverse CDF of a uniform),
    every bias 0; layer ``i`` (in module order) draws under ``fold_in(key,
    i)``."""
    lo, hi = 0.5 * math.erfc(math.sqrt(2.0)), 0.5 * math.erfc(-math.sqrt(2.0))
    layers = [m for m in model.modules()
              if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    with torch.no_grad():
        for i, m in enumerate(layers):
            w = m.weight
            u = uniform_field(*fold_in(key, i), 0, w.shape, torch.float64, w.device)
            z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
            w.copy_(z * (math.sqrt(1.0 / _fan_in(m)) / _TRUNC))
            if m.bias is not None:
                m.bias.zero_()
    return model


class DnCNN(nn.Module):
    """``depth - 1`` 3 x 3 conv-ReLU layers of ``features`` channels, then a
    3 x 3 conv to one channel, the predicted noise: ``forward(x) = x -
    noise``, ``x`` of shape ``(..., ny, nx)`` (every leading index an image).
    The convs are named as the flax module's (``conv0``..., ``conv_out``)."""

    def __init__(self, depth: int = 6, features: int = 32):
        super().__init__()
        self.depth, self.features = depth, features
        self.convs = nn.ModuleDict()
        ch = 1
        for i in range(depth - 1):
            self.convs[f"conv{i}"] = nn.Conv2d(ch, features, 3, padding=1)
            ch = features
        self.convs["conv_out"] = nn.Conv2d(ch, 1, 3, padding=1)

    def forward(self, x):
        h = x.reshape((-1, 1) + tuple(x.shape[-2:]))
        for name, conv in self.convs.items():
            h = conv(h)
            if name != "conv_out":
                h = torch.relu(h)
        return x - h.reshape(x.shape)


def _transfer_sigmas(weights, n: int = 32):
    """Operator norms of circular 'SAME' convs with the ``(L, out, in, kh,
    kw)`` kernels ``weights``: for each, the largest singular value of its
    ``(out, in)`` transfer matrices over the n x n frequency grid (Sedghi et
    al. 2019, Thm 1), an ``(L,)`` tensor on the kernels' device. A
    one-channel side makes each matrix a vector: its norm. On the CPU the
    SVDs are LAPACK's. On the card, ``_power_sigma`` on all ``L n^2``
    matrices at once, with no host read: cuSOLVER's batched SVD and
    eigensolver failed to converge on a trained net's matrices, and its
    default SVD driver solves them one after another."""
    n_l, cout, cin, kh, kw = weights.shape
    pad = weights.new_zeros((n_l, cout, cin, n, n))
    pad[..., :kh, :kw] = weights
    spec = torch.fft.fft2(pad).permute(0, 3, 4, 1, 2).reshape(n_l * n * n, cout, cin)
    if min(cout, cin) == 1:
        sig = torch.linalg.vector_norm(spec, dim=(1, 2))
    elif not spec.is_cuda:
        sig = torch.linalg.svdvals(spec)[:, 0]
    else:
        sig = _power_sigma(spec)
    return sig.reshape(n_l, n * n).amax(dim=1)


def _transfer_sigma(weight, n: int = 32):
    """``_transfer_sigmas`` of one ``(out, in, kh, kw)`` kernel, 0-d."""
    return _transfer_sigmas(weight[None], n)[0]


def _power_sigma(spec, squarings: int = SQUARINGS, iters: int = POWER_ITERS):
    """The largest singular value of each of a batch of complex matrices
    ``A``: ``G = A^H A`` squared ``squarings`` times (each square scaled to
    unit Frobenius norm), ``iters`` power iterations on that power from a
    fixed normal start, then ``|A v|``. It approaches from below: a
    singular value a relative ``d`` under the largest keeps a factor ``(1 -
    d)^(2^(squarings + 1) iters)`` of its start weight in ``v``, so ``|A
    v|`` errs by at most about ``1 / (e 2^(squarings + 2) iters)`` relative
    (3e-6 at the defaults) whatever the gap, times the start's weight
    ratio."""
    g = spec.mH @ spec
    for _ in range(squarings):
        g = g / torch.clamp(torch.linalg.matrix_norm(g, keepdim=True), min=1e-30)
        g = g @ g
    v = normal_field(0, 0, 0, (spec.shape[0], spec.shape[2], 1), spec.real.dtype,
                     spec.device).to(spec.dtype)
    for _ in range(iters):
        v = g @ v
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=(1, 2), keepdim=True), min=1e-30)
    return torch.linalg.vector_norm(spec @ v, dim=(1, 2))


def _convs(model: nn.Module):
    return [(name, m) for name, m in model.named_modules() if isinstance(m, nn.Conv2d)]


def _layer_sigmas(model: nn.Module, n: int):
    """``(weights, sigmas)`` of the conv layers, the kernels of one shape in
    one ``_transfer_sigmas`` batch: lists in module order, the norms 0-d
    tensors on the kernels' device."""
    groups: dict = {}
    for i, (_, m) in enumerate(_convs(model)):
        groups.setdefault(tuple(m.weight.shape), []).append(i)
    ws = [m.weight for _, m in _convs(model)]
    sig = [None] * len(ws)
    for idx in groups.values():
        for i, s in zip(idx, _transfer_sigmas(torch.stack([ws[i] for i in idx]), n).unbind()):
            sig[i] = s
    return ws, sig


def conv_operator_norms(model: nn.Module, n: int = 32) -> Dict[str, float]:
    """The circular operator norm of each conv layer, by the flax module's
    layer name (one host read for all layers)."""
    with torch.no_grad():
        _, sig = _layer_sigmas(model, n)
        vals = torch.stack(sig).tolist()
    return {name.split(".")[-1]: v for (name, _), v in zip(_convs(model), vals)}


def project_conv_kernels(model: nn.Module, target: float, n: int = 32) -> nn.Module:
    """Scale every conv kernel whose circular operator norm exceeds
    ``target`` onto the norm ball (the exact projection within the scaling
    family), in place, with no host read."""
    with torch.no_grad():
        ws, sig = _layer_sigmas(model, n)
        scale = torch.clamp(target / torch.clamp(torch.stack(sig), min=1e-12), max=1.0)
        torch._foreach_mul_(ws, list(scale.unbind()))
    return model


def lipschitz_estimate(fn: Callable, x, key, iters: int = 30, v0=None) -> float:
    """Local Lipschitz constant of ``fn`` at ``x``: the largest singular
    value of its Jacobian by jvp/vjp power iteration from ``v0`` (by default
    a normal draw under ``key``, step 0)."""
    v = normal_field(*key, 0, x.shape, x.dtype, x.device) if v0 is None else v0
    v = v / torch.linalg.norm(v.reshape(-1))
    with net_precision():
        _, vjp = torch.func.vjp(fn, x)
        for _ in range(iters):
            _, jv = torch.func.jvp(fn, (x,), (v,))
            (jtjv,) = vjp(jv)
            v = jtjv / torch.clamp(torch.linalg.norm(jtjv.reshape(-1)), min=1e-30)
        _, jv = torch.func.jvp(fn, (x,), (v,))
    return float(torch.linalg.norm(jv.detach().reshape(-1)))


DRAW_STEPS = 64  # training steps whose batches one draw makes (Philox is launch-bound)
GRAPH_WARMUP = 3  # the card's eager fit steps before it captures one step in a CUDA graph


def chunked(draw_many: Callable, device) -> Callable:
    """``draw(i)`` for ``fit`` from ``draw_many(steps)``, which makes the
    batches of a tensor of steps at once: ``DRAW_STEPS`` steps a call, each
    step's batch the same as its own draw (the Philox streams are
    elementwise in the step)."""
    made = {}

    def draw(i):
        c = i // DRAW_STEPS
        if c not in made:
            made.clear()
            made[c] = draw_many(torch.arange(c * DRAW_STEPS, (c + 1) * DRAW_STEPS,
                                             device=device))
        return tuple(t[i - c * DRAW_STEPS] for t in made[c])

    return draw


def fit(model: nn.Module, draw: Callable, loss_fn: Callable, steps: int, lr: float = 1e-3,
        project: Optional[Callable] = None, every: int = 10):
    """``steps`` Adam steps (``torch.optim.Adam``: optax.adam's update, eps
    outside the square root, bias-corrected) on ``loss_fn(model,
    *draw(i))`` for step ``i``; ``project(model)`` after every ``every``
    steps and at the end. The batches come from ``draw``, so a caller can
    inject them. Returns the last loss (a tensor: no host read).

    On the card the step (forward, backward and one fused Adam kernel) is
    captured in a CUDA graph after ``GRAPH_WARMUP`` eager steps and
    replayed on the batches copied into its inputs: the eager step is
    bound by the host's launches. The projections run between replays,
    in place."""
    params = list(model.parameters())
    cuda = params[0].is_cuda
    opt = torch.optim.Adam(params, lr=lr, fused=cuda or None, capturable=cuda)

    def after(i):
        if project is not None and (i + 1) % every == 0:
            project(model)

    loss = None
    with net_precision():
        if cuda and steps > GRAPH_WARMUP:
            loss = _fit_graphed(model, opt, draw, loss_fn, steps, after)
        else:
            for i in range(steps):
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(model, *draw(i))
                loss.backward()
                opt.step()
                after(i)
        if project is not None:
            project(model)
    return loss


def _fit_graphed(model, opt, draw, loss_fn, steps, after):
    """``fit``'s loop on the card: the first ``GRAPH_WARMUP`` steps eager on
    a side stream (as a capture needs), then one step captured and
    replayed for the rest."""
    inputs = tuple(t.clone() for t in draw(0))

    def step():
        loss = loss_fn(model, *inputs)
        loss.backward()
        opt.step()
        return loss

    main, side = torch.cuda.current_stream(), torch.cuda.Stream()
    for i in range(GRAPH_WARMUP):
        batch = draw(i)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for a, b in zip(inputs, batch):
                a.copy_(b)
            opt.zero_grad(set_to_none=True)
            step()
            after(i)
        main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    opt.zero_grad(set_to_none=True)
    with torch.cuda.graph(graph):
        loss = step()
    for i in range(GRAPH_WARMUP, steps):
        for a, b in zip(inputs, draw(i)):
            a.copy_(b)
        graph.replay()
        after(i)
    return loss


def denoiser_loss(model, clean, noisy):
    """The mean squared error of the denoised batch."""
    return torch.mean((model(noisy) - clean) ** 2)


def train_denoiser(
    key,
    noise_sigma: float = 0.1,
    patch: int = 40,
    batch: int = 16,
    steps: int = 800,
    lr: float = 1e-3,
    depth: int = 6,
    features: int = 32,
    spectral_norm: Optional[float] = None,
    sn_every: int = 10,
    dtype=torch.float32,
    device=None,
) -> DnCNN:
    """Train DnCNN on random phantoms (step ``i``: a batch under ``(k_img,
    i)``, its noise under ``(k_noise, i)``, drawn ``DRAW_STEPS`` steps at a
    time) and return it.
    ``spectral_norm=s`` projects every conv kernel onto the circular
    operator-norm ball of radius ``s`` every ``sn_every`` steps and at the
    end, certifying the residual ``s**depth``-Lipschitz."""
    k_init, k_train = chain_keys(key, 2)
    k_img, k_noise = chain_keys(k_train, 2)
    model = lecun_init(DnCNN(depth, features).to(device=device, dtype=dtype), k_init)

    def draw_many(steps):
        clean = random_phantom_batch((*k_img, steps), batch, patch, dtype=dtype, device=device)
        return clean, clean + noise_sigma * normal_field(*k_noise, steps, clean.shape[1:],
                                                         dtype, device)

    project = None
    if spectral_norm is not None:
        def project(m):
            return project_conv_kernels(m, spectral_norm)
    fit(model, chunked(draw_many, device), denoiser_loss, steps, lr, project, sn_every)
    return model.eval()


def make_denoiser(model: nn.Module) -> Callable:
    """The trained net as an image -> image callable without autograd: one
    image ``(ny, nx)`` or a block of chains ``(C, ny, nx)`` in one call."""

    def denoise(x):
        with torch.no_grad(), net_precision():
            return model(x)

    return denoise
