"""Kernels 4 and 5's warp route on the CPU: a torch emulation of its lane map
and shuffle schedule, held bit for bit to the plain versions.

On the card the warp route (``csrc/wavelet_block.cu::wv_myula_warp``,
``wv_ulpda_warp``) runs a Haar block of at most 3 levels with one warp an
aligned 8 x 8 square of the image: lane ``l`` keeps pixels ``(2 (l >> 3) +
e, l & 7)``, ``e = 0, 1``, in registers, and each butterfly of the
interleaved transform is within a lane (rows ``2k, 2k + 1`` at level 0) or
one ``__shfl_xor_sync`` a value (rows past level 0 with lane ``l ^ (s <<
2)``, columns with lane ``l ^ s``). A CUDA kernel has no CPU mode, so
``_to_lanes``, ``_pass`` and the step emulations below stand in: the same
lane map, the same partner lanes and slot rules, the same float operations
in the same order. A wrong partner or lattice rule then gives a wrong value,
and with a correct schedule every pixel takes the plain version's
operations on the same values, so the two agree bit for bit, in f32 as in
f64.
"""
import numpy as np
import pytest
import torch

from lmc_atomi_torch.kernels import myula_fused as t_fused
from lmc_atomi_torch.kernels import wavelet_fused as t_wf

torch.set_num_threads(2)

SQ = 8  # csrc/wavelet_block.cu: WV_SQ
LANE = torch.arange(32)
SHAPES = [(8, 8), (16, 24), (32, 32), (24, 40)]
DTYPES = [torch.float32, torch.float64]


def _to_lanes(x):
    """``(ny, nx)`` -> ``(squares, 32, 2)``: square ``sq`` (row-major over
    the image), lane ``l``, register ``e`` holds pixel ``(2 (l >> 3) + e, l &
    7)`` of the square (``wp_pixel``)."""
    ny, nx = x.shape
    sq = x.reshape(ny // SQ, SQ, nx // SQ, SQ).permute(0, 2, 1, 3).reshape(-1, SQ, SQ)
    return torch.stack([sq[:, 2 * (LANE >> 3) + e, LANE & 7] for e in (0, 1)], dim=-1)


def _from_lanes(v, shape):
    ny, nx = shape
    sq = torch.empty((v.shape[0], SQ, SQ), dtype=v.dtype)
    for e in (0, 1):
        sq[:, 2 * (LANE >> 3) + e, LANE & 7] = v[:, :, e]
    return sq.reshape(ny // SQ, nx // SQ, SQ, SQ).permute(0, 2, 1, 3).reshape(ny, nx)


def _pass(v, s, axis):
    """``wp_haar_pass``: one butterfly pass at stride ``s`` along ``axis``."""
    if s == 1 and axis == 0:
        a, b = v[..., 0], v[..., 1]
        return torch.stack([(a + b) * t_wf._SQRT1_2, (a - b) * t_wf._SQRT1_2], dim=-1)
    c = LANE & 7
    partner = LANE ^ ((s << 2) if axis == 0 else s)
    out = v.clone()
    for e in ((0, 1) if s == 1 else (0,)):
        r = 2 * (LANE >> 3) + e
        own, other = v[:, :, e], v[:, partner, e]  # the shuffle
        idx = r if axis == 0 else c
        new = torch.where((idx & s) == 0, (own + other) * t_wf._SQRT1_2,
                          (other - own) * t_wf._SQRT1_2)
        out[:, :, e] = torch.where(((r | c) & (s - 1)) == 0, new, own)
    return out


def _fwd(v, levels):
    for lv in range(levels):
        v = _pass(_pass(v, 1 << lv, 0), 1 << lv, 1)
    return v


def _inv(v, levels):
    for lv in reversed(range(levels)):
        v = _pass(_pass(v, 1 << lv, 1), 1 << lv, 0)
    return v


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("levels", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_warp_transform_matches_interleaved(shape, levels, dtype):
    """The lane map and shuffle schedule give ``haar_interleaved`` and its
    inverse bit for bit; the lane map round-trips."""
    x = torch.from_numpy(np.random.default_rng(levels).normal(size=shape)).to(dtype)
    assert torch.equal(_from_lanes(_to_lanes(x), shape), x)
    assert t_wf.haar_levels(shape, levels) == levels
    got = _from_lanes(_fwd(_to_lanes(x), levels), shape)
    assert torch.equal(got, t_wf.haar_interleaved(x, levels))
    back = _from_lanes(_inv(_to_lanes(x), levels), shape)
    assert torch.equal(back, t_wf.haar_interleaved_inv(x, levels))


def _inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(shape, generator=g, dtype=torch.float64).to(dtype)
    mask = (torch.rand(shape, generator=g, dtype=torch.float64) > 0.5).to(dtype)
    y = mask * (x + 0.1 * torch.randn(shape, generator=g, dtype=torch.float64).to(dtype))
    c = torch.clamp(torch.randn(shape, generator=g, dtype=torch.float64), -0.4, 0.4).to(dtype)
    xbar = x + 0.1 * torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    noise = torch.randn((8,) + shape, generator=g, dtype=torch.float64).to(dtype)
    return x, y, mask, c, xbar, noise


def _injected(monkeypatch, noise):
    """The plain versions' noise replaced by a given field per step."""
    monkeypatch.setattr(t_wf, "normal_field",
                        lambda seed, chain, g, shape, dtype, device: noise[g])


def _emulate_myula(x, y, mask, scal_f, levels, n_steps, noise, rec):
    """``wv_myula_warp``'s block in lanes (the update term for term)."""
    c_keep, c_grad, c_prox, noise_amp, sig, thr = t_wf._myula_coefs(scal_f)
    shape = x.shape
    xv, yv, mv = _to_lanes(x), _to_lanes(y), _to_lanes(mask)
    sm = sig * mv
    for i in range(n_steps):
        g = rec.step0 + i
        v = _fwd(xv, levels)
        v = torch.sign(v) * torch.clamp(torch.abs(v) - thr, min=0.0)
        p = _inv(v, levels)
        grad = sm * (mv * xv - yv)
        xn = c_keep * xv - c_grad * grad + c_prox * p
        if noise is not None:
            xn = xn + noise_amp * _to_lanes(noise[g])
        xv = xn
        rec(_from_lanes(xv, shape), g)
    return (_from_lanes(xv, shape), *rec.result())


def _emulate_ulpda(x, c, xbar, y, mask, scal_f, levels, n_steps, gfirst, noise, rec):
    """``wv_ulpda_warp``'s block in lanes, dual first with ``gfirst``."""
    tau, mu, theta, noise_amp, ts, g_sigma = t_wf._ulpda_coefs(scal_f)
    shape = x.shape
    xv, cv, mv, yv = _to_lanes(x), _to_lanes(c), _to_lanes(mask), _to_lanes(y)
    xb = _to_lanes(xbar) if gfirst else xv
    atb = ts * mv * yv
    den = 1.0 / (1.0 + ts * mv)
    for i in range(n_steps):
        g = rec.step0 + i
        for part in ((0, 1) if gfirst else (1, 0)):
            if part == 0:
                cv = torch.clamp(cv + mu * _fwd(xb, levels), -g_sigma, g_sigma)
                continue
            p = _inv(cv, levels)
            xn = (xv - tau * p + atb) * den
            if noise is not None:
                xn = xn + noise_amp * _to_lanes(noise[g])
            xb = xn + theta * (xn - xv)
            xv = xn
            rec(_from_lanes(xv, shape), g)
    return (_from_lanes(xv, shape), _from_lanes(cv, shape), _from_lanes(xb, shape),
            *rec.result())


def _recorder(x, scal_i, quantiles, seed=1):
    g = torch.Generator().manual_seed(seed)
    shape = x.shape
    mean = torch.rand(shape, generator=g, dtype=torch.float64).to(x.dtype)
    m2 = torch.rand(shape, generator=g, dtype=torch.float64).to(x.dtype)
    n_q = len(quantiles)
    qh = qn = None
    if n_q:
        qh = torch.sort(x + torch.randn((n_q, 5) + shape, generator=g, dtype=torch.float64)
                        .to(x.dtype), dim=1)[0].reshape((5 * n_q,) + shape)
        qn = torch.tensor([5.0, 10.0, 15.0], dtype=x.dtype)[:, None, None].repeat(n_q, *shape)
    return mean, m2, qh, qn


# (shape, levels, quantiles): model M10's 3 levels with CI markers, fewer
# levels on other squares
STEP_CASES = [((16, 24), 3, (0.025, 0.975)), ((24, 40), 2, ()), ((32, 32), 1, (0.5,))]


@pytest.mark.parametrize("noise_on", [False, True], ids=["noise-off", "noise-injected"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape, levels, quantiles", STEP_CASES)
def test_warp_myula_block_matches_ref(monkeypatch, shape, levels, quantiles, dtype, noise_on):
    """Kernel 4's warp block, 5 steps, against ``wavelet_block_update_ref``:
    x, the moments and the markers bit for bit."""
    x, y, mask, _, _, noise = _inputs(shape, dtype, 3)
    _injected(monkeypatch, noise)
    scal_f = (0.002, 0.01, 100.0, 0.05, 1.0 if noise_on else 0.0)
    scal_i = (1, 2, 0)
    mean, m2, qh, qn = _recorder(x, scal_i, quantiles)
    want = t_wf.wavelet_block_update_ref(
        x, y, mask, mean, m2, (3, 4), scal_f, scal_i, qh, qn, levels=levels, taps=2,
        n_steps=5, with_noise=noise_on, quantiles=quantiles)
    rec = t_fused._BlockStats(scal_i, mean, m2, qh, qn, quantiles, 1, True)
    got = _emulate_myula(x, y, mask, scal_f, levels, 5, noise if noise_on else None, rec)
    for name, a, b in zip(("x", "mean", "m2", "qh", "qn"), got, want):
        assert (a is None and b is None) or torch.equal(a, b), name


@pytest.mark.parametrize("gfirst", [False, True])
@pytest.mark.parametrize("noise_on", [False, True], ids=["noise-off", "noise-injected"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("shape, levels", [((16, 24), 3), ((32, 32), 2)])
def test_warp_ulpda_block_matches_ref(monkeypatch, shape, levels, dtype, noise_on, gfirst):
    """Kernel 5's warp block, 5 steps, both orders, against
    ``ulpda_wavelet_block_update_ref``: x, the dual, xbar and the moments bit
    for bit."""
    x, y, mask, c, xbar, noise = _inputs(shape, dtype, 5)
    _injected(monkeypatch, noise)
    scal_f = (0.0095, 1.0, 1.0, 1.0 if noise_on else 0.0, 100.0, 0.4)
    scal_i = (2, 3, 0)
    mean, m2, _, _ = _recorder(x, scal_i, ())
    want = t_wf.ulpda_wavelet_block_update_ref(
        x, c, xbar, y, mask, mean, m2, (3, 4), scal_f, scal_i, levels=levels, taps=2,
        n_steps=5, gfirst=gfirst, with_noise=noise_on)
    rec = t_fused._BlockStats(scal_i, mean, m2, None, None, (), 1, True)
    got = _emulate_ulpda(x, c, xbar, y, mask, scal_f, levels, 5, gfirst,
                         noise if noise_on else None, rec)
    for name, a, b in zip(("x", "c", "xbar", "mean", "m2"), got, want):
        assert torch.equal(a, b), name


def test_partner_lanes_stay_in_square():
    """Every butterfly pairs two pixels of one square: the in-lane pair at
    level 0, and for each shuffle the partner lane holds the pixel ``s``
    further along the axis (or ``s`` back), so no value leaves the warp."""
    for lv in range(3):
        s = 1 << lv
        for axis in (0, 1):
            partner = LANE ^ ((s << 2) if axis == 0 else s)
            for e in ((0, 1) if s == 1 else (0,)):
                if s == 1 and axis == 0:
                    continue
                r, c = 2 * (LANE >> 3) + e, LANE & 7
                pr, pc = 2 * (partner >> 3) + e, partner & 7
                on = ((r | c) & (s - 1)) == 0
                d = (pr - r) if axis == 0 else (pc - c)
                same = (pc == c) if axis == 0 else (pr == r)
                assert bool((same & (d.abs() == s))[on].all()), (s, axis, e)
