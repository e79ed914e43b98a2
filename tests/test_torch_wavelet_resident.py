"""Kernels 4 and 5's resident D4/D8 route on the CPU: a torch emulation of
its phase schedule, held bit for bit to the plain versions, and the host
picker of all four routes.

On the card the resident route (``csrc/wavelet_block.cu::wv_rs_myula``,
``wv_rs_ulpda``) runs a whole D4/D8 block call as one cooperative launch,
one CTA a tile of ``resident_tile``'s geometry, every CTA resident at once.
Each level of the interleaved transform is a phase between two grid
barriers: the CTA runs the level's first pass (forward: axis 0, inverse:
axis 1) on its tile's lattice points and the reach of the second pass
beyond them (``taps - 2`` lattice columns to the right, or rows above,
wrapped around the image) into shared memory, reading the field the
previous phase wrote (any CTA's), then the second pass from shared memory
on its own points, written to the level's field ``W_lv = B[lv % 2]``: the
soft threshold (or the dual's clip) where a coefficient becomes final. The
inverse level ``lv`` writes its result into ``W_(lv-1)`` beside the final
coefficients of level ``lv - 1``; the last inverse level is the update of
the CTA's own pixels. Kernel 5 keeps the dual's truth per tile and its
copy where the primal reads it, in the field of each coefficient's level.

A CUDA kernel has no CPU mode, and its CTAs run one after another never
pass a grid barrier, so ``_Resident`` stands in: the same phases, tile by
tile, in torch ops. A phase reads only the field written before the last
barrier (never the one it writes) and its tile's own state, and the second
pass reads only the first pass's points of its own tile (an index past them
raises). The fields are NaN wherever the schedule leaves nothing live: both
at each step's (kernel 5: each dual's) start, and before each level writes
a field, the points of it that the level before left dead. A read of
anything the schedule does not leave there reaches the result as NaN. With
a correct schedule every pixel takes the plain version's operations on the
same values, so the two agree bit for bit, in f32 as in f64.
"""
import numpy as np
import pytest
import torch

from lmc_atomi_torch.kernels import myula_fused as t_fused
from lmc_atomi_torch.kernels import wavelet_fused as t_wf
from lmc_atomi_torch.ops.wavelet import daubechies_filters

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.float64]
NAN = float("nan")


def _filled(shape, dtype):
    return torch.full(shape, NAN, dtype=dtype)


class _Resident:
    """The resident route's phases on an ``(ny, nx)`` image of ``levels``
    levels of a ``taps``-tap filter, tiles of ``resident_tile`` at
    ``n_sm`` SMs, fields ``w = [B0, B1]``."""

    def __init__(self, shape, taps, levels, dtype, n_sm):
        self.shape, self.levels, self.taps = shape, levels, taps
        h, g = daubechies_filters(taps)
        self.h = torch.tensor(h, dtype=dtype)
        self.g = torch.tensor(g, dtype=dtype)
        self.tile = t_wf.resident_tile(shape, levels, n_sm)
        ty, tx = self.tile
        self.tiles = [(i0, j0) for i0 in range(0, shape[0], ty) for j0 in range(0, shape[1], tx)]
        self.w = [_filled(shape, dtype) for _ in range(2)]

    def _taps(self, rd, odd, inverse):
        """The bank's sum (``rs_bank``, ``rs_bank_sh``): ``rd(k)`` the value
        ``k`` strides along the axis, ``odd`` the points' odd slots."""
        o = odd.long()
        acc = 0.0
        if not inverse:
            for m in range(self.taps):
                acc = acc + torch.where(odd, self.g[m], self.h[m]) * rd(m - o)
        else:
            for m in range(self.taps // 2):
                a = torch.where(odd, self.h[2 * m + 1], self.h[2 * m])
                b = torch.where(odd, self.g[2 * m + 1], self.g[2 * m])
                acc = acc + (a * rd(-2 * m - o) + b * rd(1 - 2 * m - o))
        return acc

    def _bank(self, src, i, j, s, axis, inverse):
        """``rs_bank``: the pass at the lattice points ``(i, j)`` of a field
        in device memory, the taps wrapped around the image."""
        n = self.shape[axis]
        idx = i if axis == 0 else j

        def rd(k):
            t = idx + k * s
            t = torch.where(t < 0, t + n, t)
            t = torch.where(t >= n, t - n, t)
            return src[t, j] if axis == 0 else src[i, t]

        return self._taps(rd, (idx & s) != 0, inverse)

    def _local(self, sh, r, c, axis, odd, inverse):
        """The second pass from the phase's shared rows ``sh`` at local
        points ``(r, c)``; an index past them raises."""
        def rd(k):
            rr, cc = (r + k, c) if axis == 0 else (r, c + k)
            assert bool((rr >= 0).all() and (rr < sh.shape[0]).all()
                        and (cc >= 0).all() and (cc < sh.shape[1]).all())
            return sh[rr, cc]

        return self._taps(rd, odd, inverse)

    def _grid(self, nr, nc):
        r, c = torch.meshgrid(torch.arange(nr), torch.arange(nc), indexing="ij")
        return r.reshape(-1), c.reshape(-1)

    def fwd_level(self, src, lv, out):
        """``rs_fwd_level`` on every tile: ``out(i, j, v)``."""
        s, ty, tx = 1 << lv, *self.tile
        nr, nc, ne = ty // s, tx // s, tx // s + self.taps - 2
        snap = src.clone()  # the field of the last barrier
        for i0, j0 in self.tiles:
            r, c = self._grid(nr, ne)
            i, j = i0 + r * s, (j0 + c * s) % self.shape[1]
            sh = self._bank(snap, i, j, s, 0, False).reshape(nr, ne)
            r, c = self._grid(nr, nc)
            v = self._local(sh, r, c, 1, (c & 1) != 0, False)
            out(i0 + r * s, j0 + c * s, v)

    def inv_level(self, src, lv, out=None):
        """``rs_inv_level`` (``rs_inv_rows`` and ``rs_p`` at level 0) on
        every tile: the level's result into ``out``, or at level 0
        returned at every pixel (the update's ``p``)."""
        s, ty, tx = 1 << lv, *self.tile
        nr, nc, up = ty // s, tx // s, self.taps - 2
        snap = src.clone()
        p = _filled(self.shape, src.dtype)
        for i0, j0 in self.tiles:
            r, c = self._grid(nr + up, nc)
            i, j = (i0 + (r - up) * s) % self.shape[0], j0 + c * s
            sh = self._bank(snap, i, j, s, 1, True).reshape(nr + up, nc)
            r, c = self._grid(nr, nc)
            v = self._local(sh, r + up, c, 0, (r & 1) != 0, True)
            (out if lv else p)[i0 + r * s, j0 + c * s] = v
        return p

    def _lattice_mask(self, lv):
        iy = torch.arange(self.shape[0])[:, None]
        ix = torch.arange(self.shape[1])[None, :]
        return ((iy | ix) & ((1 << lv) - 1)) == 0

    def forward(self, src, fin):
        """``rs_forward``: W src level by level into ``w``, ``fin(i, j, v,
        field)`` storing each final coefficient."""
        for lv in range(self.levels):
            s, out = 1 << lv, self.w[lv % 2]
            inp = src if lv == 0 else self.w[(lv - 1) % 2]
            assert inp is not out
            if lv >= 2:  # level lv - 2's next-level points, read by level lv - 1
                out[self._lattice_mask(lv - 1)] = NAN

            def store(i, j, v, lv=lv, out=out, s=s):
                on = ((i | j) & (2 * s - 1)) == 0
                if lv + 1 == self.levels:
                    on = torch.zeros_like(on)
                out[i[on], j[on]] = v[on]
                fin(i[~on], j[~on], v[~on], out)

            self.fwd_level(inp, lv, store)

    def inverse(self):
        """``rs_inverse``, then the level-0 pass: ``p`` at every pixel."""
        for lv in range(self.levels - 1, 0, -1):
            out = self.w[(lv - 1) % 2]
            assert out is not self.w[lv % 2]
            out[self._lattice_mask(lv)] = NAN  # the forward's points, read already
            self.inv_level(self.w[lv % 2], lv, out)
        return self.inv_level(self.w[0], 0)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("taps", [4, 8])
@pytest.mark.parametrize("shape", [(32, 32), (64, 48)], ids=["32x32", "64x48"])
def test_resident_transforms_match_interleaved(shape, taps, levels, dtype):
    """The phases give ``dwt_interleaved`` (each coefficient in the field of
    its level) and, from those fields, ``dwt_interleaved_inv`` in the last
    level's pass, bit for bit, with the fields poisoned where the schedule
    leaves nothing (tiles of 16 SMs: several per axis)."""
    assert t_wf.dwt_levels(shape, taps, levels) == levels
    rs = _Resident(shape, taps, levels, dtype, n_sm=16)
    assert len(rs.tiles) > 1
    x = torch.from_numpy(np.random.default_rng(taps + levels).normal(size=shape)).to(dtype)
    coef = _filled(shape, dtype)

    def fin(i, j, v, field):
        field[i, j] = v
        coef[i, j] = v

    rs.forward(x, fin)
    want = t_wf.dwt_interleaved(x, taps, levels)
    assert torch.equal(coef, want)
    assert torch.equal(rs.inverse(), t_wf.dwt_interleaved_inv(want, taps, levels))


def _inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)

    def rnd(fn, *a):
        return fn(*a, generator=g, dtype=torch.float64).to(dtype)

    x = rnd(torch.rand, shape)
    mask = (rnd(torch.rand, shape) > 0.5).to(dtype)
    y = mask * (x + 0.1 * rnd(torch.randn, shape))
    c = torch.clamp(rnd(torch.randn, shape), -0.4, 0.4)
    xbar = x + 0.1 * rnd(torch.randn, shape)
    noise = rnd(torch.randn, (8,) + shape)
    mean, m2 = rnd(torch.rand, shape), rnd(torch.rand, shape)
    return x, y, mask, c, xbar, noise, mean, m2


def _injected(monkeypatch, noise):
    monkeypatch.setattr(t_wf, "normal_field",
                        lambda seed, chain, g, shape, dtype, device: noise[g])


def _emulate_myula(rs, x, y, mask, scal_f, n_steps, noise, rec):
    """``wv_rs_myula``'s block: x in place between steps, both fields
    poisoned at each step's start."""
    c_keep, c_grad, c_prox, noise_amp, sig, thr = t_wf._myula_coefs(scal_f)
    sm = sig * mask
    x = x.clone()

    def fin(i, j, v, field):
        field[i, j] = torch.sign(v) * torch.clamp(torch.abs(v) - thr, min=0.0)

    for it in range(n_steps):
        g = rec.step0 + it
        for field in rs.w:
            field.fill_(NAN)
        rs.forward(x, fin)
        p = rs.inverse()
        grad = sm * (mask * x - y)
        xn = c_keep * x - c_grad * grad + c_prox * p
        if noise is not None:
            xn = xn + noise_amp * noise[g]
        x = xn
        rec(x, g)
    return (x, *rec.result())


def _emulate_ulpda(rs, x, c, xbar, y, mask, scal_f, n_steps, gfirst, noise, rec):
    """``wv_rs_ulpda``'s block: the dual's truth ``cs`` per tile, its copy
    in the fields (each coefficient in its level's, scattered there at the
    start without ``gfirst``), the fields poisoned before each dual phase,
    xbar in place."""
    tau, mu, theta, noise_amp, ts, g_sigma = t_wf._ulpda_coefs(scal_f)
    atb = ts * mask * y
    den = 1.0 / (1.0 + ts * mask)
    cs = c.clone()
    xbar = xbar.clone() if gfirst else _filled(x.shape, x.dtype)
    if not gfirst:
        for lv in range(rs.levels):
            final = rs._lattice_mask(lv)
            if lv + 1 < rs.levels:
                final &= ~rs._lattice_mask(lv + 1)
            rs.w[lv % 2][final] = cs[final]

    def fin(i, j, v, field):
        cn = torch.clamp(cs[i, j] + mu * v, -g_sigma, g_sigma)
        cs[i, j] = cn
        field[i, j] = cn

    def dual():
        for field in rs.w:
            field.fill_(NAN)
        rs.forward(xbar, fin)

    for it in range(n_steps):
        g = rec.step0 + it
        for part in ((0, 1) if gfirst else (1, 0)):
            if part == 0:
                dual()
                continue
            p = rs.inverse()
            xn = (x - tau * p + atb) * den
            if noise is not None:
                xn = xn + noise_amp * noise[g]
            xbar = xn + theta * (xn - x)
            x = xn
            rec(x, g)
    return x, cs, xbar, *rec.result()


# (shape, taps, levels): model M10's 3 levels, D8 on its deepest level,
# rectangular tiles
STEP_CASES = [((32, 32), 4, 3), ((32, 32), 8, 2), ((64, 48), 4, 2)]


@pytest.mark.parametrize("noise_on", [False, True], ids=["noise-off", "noise-injected"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape, taps, levels", STEP_CASES)
def test_resident_myula_block_matches_ref(monkeypatch, shape, taps, levels, dtype, noise_on):
    """Kernel 4's resident block, 3 steps with 95% CI markers, against
    ``wavelet_block_update_ref``: x, the moments and the markers bit for
    bit."""
    x, y, mask, _, _, noise, mean, m2 = _inputs(shape, dtype, taps)
    _injected(monkeypatch, noise)
    quantiles = (0.025, 0.975)
    qh = torch.zeros((10,) + shape, dtype=dtype)
    qn = torch.tensor([2.0, 3.0, 4.0], dtype=dtype)[:, None, None].repeat(2, *shape)
    scal_f = (0.002, 0.01, 100.0, 0.05, 1.0 if noise_on else 0.0)
    scal_i = (1, 2, 0)
    want = t_wf.wavelet_block_update_ref(
        x, y, mask, mean, m2, (3, 4), scal_f, scal_i, qh, qn, levels=levels, taps=taps,
        n_steps=3, with_noise=noise_on, quantiles=quantiles)
    rs = _Resident(shape, taps, levels, dtype, n_sm=16)
    rec = t_fused._BlockStats(scal_i, mean, m2, qh, qn, quantiles, 1, True)
    got = _emulate_myula(rs, x, y, mask, scal_f, 3, noise if noise_on else None, rec)
    for name, a, b in zip(("x", "mean", "m2", "qh", "qn"), got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("gfirst", [False, True])
@pytest.mark.parametrize("noise_on", [False, True], ids=["noise-off", "noise-injected"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape, taps, levels", STEP_CASES)
def test_resident_ulpda_block_matches_ref(monkeypatch, shape, taps, levels, dtype, noise_on,
                                          gfirst):
    """Kernel 5's resident block, 3 steps, both orders, against
    ``ulpda_wavelet_block_update_ref``: x, the dual, xbar and the moments
    bit for bit."""
    x, y, mask, c, xbar, noise, mean, m2 = _inputs(shape, dtype, 10 + taps)
    _injected(monkeypatch, noise)
    scal_f = (0.0095, 1.0, 1.0, 1.0 if noise_on else 0.0, 100.0, 0.4)
    scal_i = (2, 3, 0)
    want = t_wf.ulpda_wavelet_block_update_ref(
        x, c, xbar, y, mask, mean, m2, (3, 4), scal_f, scal_i, levels=levels, taps=taps,
        n_steps=3, gfirst=gfirst, with_noise=noise_on)
    rs = _Resident(shape, taps, levels, dtype, n_sm=16)
    rec = t_fused._BlockStats(scal_i, mean, m2, None, None, (), 1, True)
    got = _emulate_ulpda(rs, x, c, xbar, y, mask, scal_f, 3, gfirst,
                         noise if noise_on else None, rec)
    for name, a, b in zip(("x", "c", "xbar", "mean", "m2"), got, want):
        assert torch.equal(a, b), name


# (shape, taps, levels) -> (route, geometry) on the H100's 132 SMs
PLAN_CASES = [
    ((512, 512), 2, 3, "warp", (8, 8)),
    ((512, 512), 2, 1, "warp", (8, 8)),
    ((24, 40), 2, 3, "warp", (8, 8)),
    ((512, 512), 2, 4, "tile", (32, 32)),
    ((512, 512), 2, 5, "tile", (32, 32)),
    ((36, 36), 2, 2, "tile", (12, 12)),
    ((512, 512), 2, 6, "passes", (0, 0)),
    ((512, 512), 4, 3, "resident", (32, 64)),
    ((512, 512), 8, 3, "resident", (32, 64)),
    ((512, 512), 8, 1, "resident", (32, 64)),
    ((64, 64), 4, 3, "resident", (8, 8)),
    ((1024, 1024), 4, 3, "passes", (0, 0)),
    ((2048, 2048), 8, 3, "passes", (0, 0)),
    ((512, 512), 4, 0, "passes", (0, 0)),
]


@pytest.mark.parametrize("n_q", [0, 2])
@pytest.mark.parametrize("shape, taps, levels, route, geometry", PLAN_CASES)
def test_plan_routes(monkeypatch, shape, taps, levels, route, geometry, n_q):
    """``wavelet_plan`` and the wrappers' ``_prepare`` name the route and
    its geometry for each shape, filter, depth and marker count (the
    markers do not change the route); one chain is one launch in turn."""
    assert t_wf.wavelet_plan(shape, taps, levels) == (
        t_wf.dwt_levels(shape, taps, levels), route, geometry, (1, 1))
    monkeypatch.setattr(t_wf._build, "require_cuda_f32", lambda *a, **k: None)
    z = torch.zeros(shape, dtype=torch.float32)
    qs = (0.025, 0.975)[:n_q]
    q = torch.zeros((5 * n_q,) + shape) if n_q else None
    plan, _, qcoef = t_wf._prepare(z, taps, levels, 4, (0, 0, 0), qs, q, q, {"x": z})
    assert plan == t_wf.wavelet_plan(shape, taps, levels)
    assert qcoef.shape == (max(n_q, 1), 3)


@pytest.mark.parametrize("n_sm", [8, 16, 64, 132])
@pytest.mark.parametrize("shape, levels", [((512, 512), 3), ((64, 48), 2), ((96, 160), 3)])
def test_resident_tile_is_least_area(shape, levels, n_sm):
    """``resident_tile`` against a scan of every tiling: whole ``2^levels``
    tiles dividing the image, at most ``_RS_MAX_PIXELS`` pixels and
    ``n_sm`` tiles; the least area, then perimeter, then the wider."""
    t = 1 << levels
    fits = [(ty, tx) for ty in range(t, shape[0] + 1, t) for tx in range(t, shape[1] + 1, t)
            if shape[0] % ty == 0 and shape[1] % tx == 0
            and ty * tx <= t_wf._RS_MAX_PIXELS
            and (shape[0] // ty) * (shape[1] // tx) <= n_sm]
    want = min(fits, key=lambda g: (g[0] * g[1], g[0] + g[1], -g[1])) if fits else None
    assert t_wf.resident_tile(shape, levels, n_sm) == want
