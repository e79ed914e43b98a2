"""Port parity for the wavelet operators and kernels 4, 5 and kernel 3's
wl1 dual, on the CPU in f64 (the JAX side runs with x64, tests/conftest.py):
the Mallat ``HaarDWT2D``/``DaubechiesDWT2D``, ``Mask``, ``Identity``,
``L2Data(Mask)``, ``OrthogonalL1``, the interleaved transforms, and the plain
versions of the block kernels against the JAX Pallas kernels in interpret
mode (noise off). The same numpy inputs go to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.kernels import ulpda_fused as t_ulpda
from lmc_atomi_torch.kernels import wavelet_fused as t_wf
from lmc_atomi_torch.ops import functionals as t_fn
from lmc_atomi_torch.ops import linops as t_lin
from lmc_atomi_torch.ops import wavelet as t_wav
from lmc_atomi_tpu.kernels import ulpda_fused as j_ulpda
from lmc_atomi_tpu.kernels import wavelet_fused as j_wf
from lmc_atomi_tpu.ops import functionals as j_fn
from lmc_atomi_tpu.ops import linops as j_lin
from lmc_atomi_tpu.ops import wavelet as j_wav
from lmc_atomi_tpu.utils.images import phantom

torch.set_num_threads(2)

# f64 on both sides with the same operations in the same order: the
# transforms agree exactly, the block recursions to a few ulp
TOL = 1e-12
# inverse of forward: the D4/D8 constants are orthonormal to ~1e-12 only
ROUND_TRIP_TOL = 1e-10
N = 16


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=name)


def _ops(name, levels):
    if name == "haar":
        return j_wav.HaarDWT2D(levels=levels), t_wav.HaarDWT2D(levels=levels)
    taps = {"d4": 4, "d8": 8}[name]
    return (j_wav.DaubechiesDWT2D(taps=taps, levels=levels),
            t_wav.DaubechiesDWT2D(taps=taps, levels=levels))


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("name", ["haar", "d4", "d8"])
def test_dwt_matches_jax(name, levels):
    """Mallat-layout forward and inverse at 32^2 against JAX, inverse of the
    forward, and the adjoint by ``dot_test``; ``make_dwt`` names the op."""
    x = np.random.default_rng(levels).normal(size=(32, 32))
    jop, top = _ops(name, levels)
    c = top.matvec(torch.from_numpy(x))
    _close(c, jop.matvec(jnp.asarray(x)), name="matvec")
    _close(top.rmatvec(torch.from_numpy(x)), jop.rmatvec(jnp.asarray(x)),
           name="rmatvec")
    _close(top.rmatvec(c), x, ROUND_TRIP_TOL, name="inverse")
    lhs, rhs = t_lin.dot_test(top, torch.Generator().manual_seed(levels), (32, 32))
    assert abs(float(lhs - rhs)) <= 1e-12 * abs(float(lhs))
    assert t_wav.make_dwt(name, levels) == top


@pytest.mark.parametrize("name", ["haar", "d4", "d8"])
def test_dwt_level_guard_matches_jax(name):
    """24^2 = 8 x 3: levels past the third (D8: past the second, sub-images
    shorter than 8) are skipped, forward and inverse, as in the JAX
    package."""
    x = np.random.default_rng(5).normal(size=(24, 24))
    jop, top = _ops(name, 5)
    c = top.matvec(torch.from_numpy(x))
    _close(c, jop.matvec(jnp.asarray(x)), name="matvec")
    _close(top.rmatvec(c), x, ROUND_TRIP_TOL, name="inverse")
    ci = t_wf.dwt_interleaved(torch.from_numpy(x), jop.taps if name != "haar" else 2, 5)
    _close(ci, j_wf.dwt_interleaved(jnp.asarray(x), jop.taps if name != "haar" else 2, 5),
           name="interleaved")


@pytest.mark.parametrize("kind", ["mask", "identity"])
def test_mask_identity_and_l2data_match_jax(kind):
    """``Mask``/``Identity`` and the data term over them: ``grad`` (the
    operators have no spectrum, so it is ``sigma A^T(A x - b)``) and the
    closed-form ``prox``; ``dot_test`` holds the adjoint."""
    rng = np.random.default_rng(2)
    m = (rng.uniform(size=(N, N)) > 0.5).astype(np.float64)
    x, b = rng.normal(size=(2, N, N))
    if kind == "mask":
        jop, top = j_lin.Mask(mask=jnp.asarray(m)), t_lin.Mask(mask=torch.from_numpy(m))
    else:
        jop, top = j_lin.Identity(), t_lin.Identity()
    tx = torch.from_numpy(x)
    _close(top.matvec(tx), jop.matvec(jnp.asarray(x)))
    _close(top.rmatvec(tx), jop.rmatvec(jnp.asarray(x)))
    _close(top.gram_solve(0.7, tx), jop.gram_solve(0.7, jnp.asarray(x)))
    lhs, rhs = t_lin.dot_test(top, torch.Generator().manual_seed(0), (N, N))
    assert abs(float(lhs - rhs)) <= 1e-12 * abs(float(lhs))
    jl2 = j_fn.L2Data(op=jop, b=jnp.asarray(b), sigma=3.0)
    tl2 = t_fn.L2Data(op=top, b=torch.from_numpy(b), sigma=3.0)
    _close(tl2.grad(tx), jl2.grad(jnp.asarray(x)), name="grad")
    _close(tl2.prox(tx, 0.4), jl2.prox(jnp.asarray(x), 0.4), name="prox")
    _close(tl2(tx), jl2(jnp.asarray(x)), name="value")
    if kind == "mask":
        ml2 = interop.mask_l2_from_numpy(m, b, 3.0)
        _close(ml2.grad(tx), jl2.grad(jnp.asarray(x)), name="interop grad")


@pytest.mark.parametrize("name", ["haar", "d4", "d8"])
def test_orthogonal_l1_matches_jax(name):
    """``OrthogonalL1``: value, prox, Moreau gradient and value."""
    x = np.random.default_rng(3).normal(size=(32, 32))
    jop, _ = _ops(name, 3)
    jw = j_fn.OrthogonalL1(op=jop, sigma=0.6)
    tw = interop.orthogonal_l1_from_numpy(0.6, 3, 2 if name == "haar" else jop.taps)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(tw(tx), jw(jx), name="value")
    _close(tw.prox(tx, 0.7), jw.prox(jx, 0.7), name="prox")
    _close(tw.moreau_grad(tx, 0.3), jw.moreau_grad(jx, 0.3), name="moreau_grad")
    _close(tw.moreau_value(tx, 0.3), jw.moreau_value(jx, 0.3), name="moreau_value")


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("taps", [2, 4, 8])
def test_interleaved_transforms_match_jax(taps, inverse):
    """``dwt_interleaved``/``_inv`` (``haar_interleaved`` for 2 taps) at
    32^2, 3 and 4 levels, against JAX; each inverts the other."""
    x = np.random.default_rng(taps).normal(size=(32, 32))
    tx = torch.from_numpy(x)
    for levels in (3, 4):
        if inverse:
            got = t_wf.dwt_interleaved_inv(tx, taps, levels)
            want = j_wf.dwt_interleaved_inv(jnp.asarray(x), taps, levels)
            back = t_wf.dwt_interleaved(got, taps, levels)
        else:
            got = t_wf.dwt_interleaved(tx, taps, levels)
            want = j_wf.dwt_interleaved(jnp.asarray(x), taps, levels)
            back = t_wf.dwt_interleaved_inv(got, taps, levels)
        _close(got, want, name=f"levels={levels}")
        _close(back, x, ROUND_TRIP_TOL, name="round trip")
    if taps == 2:
        _close(t_wf.haar_interleaved(tx, 3), j_wf.haar_interleaved(jnp.asarray(x), 3))


def _block_state(rng, n_q, case):
    """Inputs of a block call: a masked observation, a mid-chain state and,
    with quantiles, markers in bootstrap (zeros) or steady state (sorted
    heights around x, interior positions within the count)."""
    x = rng.normal(size=(N, N)) * 0.5 + 0.5
    mask = (rng.uniform(size=(N, N)) > 0.5).astype(np.float64)
    y = mask * (x + 0.1 * rng.normal(size=(N, N)))
    mean = x + 0.05 * rng.normal(size=(N, N))
    m2 = rng.uniform(0.1, 1.0, size=(N, N))
    qh = qn = None
    if n_q:
        if case == "steady-q":
            qh = np.sort(x + 0.3 * rng.normal(size=(n_q, 5, N, N)), axis=1)
            qh = qh.reshape(5 * n_q, N, N)
            qn = np.tile(np.array([5.0, 10.0, 15.0])[:, None, None], (n_q, N, N))
        else:
            qh = np.zeros((5 * n_q, N, N))
            qn = np.tile(np.arange(2.0, 5.0)[:, None, None], (n_q, N, N))
    return x, y, mask, mean, m2, qh, qn


# (case, scal_i, quantiles, quantile_thin): burn-in inside the block; P^2 in
# bootstrap with thinning; P^2 past the bootstrap (c_prev >= 18)
BLOCK_CASES = {
    "moments": ((3, 5, 1), (), 1),
    "boot-q": ((0, 2, 0), (0.1, 0.9), 2),
    "steady-q": ((20, 2, 18), (0.25,), 1),
}
MYULA_RUNS = [(taps, "moments") for taps in (2, 4, 8)] + [
    (2, "boot-q"), (2, "steady-q"), (8, "steady-q")]
ULPDA_RUNS = [(taps, gfirst, "moments") for taps in (2, 4, 8)
              for gfirst in (False, True)] + [(2, True, "steady-q"), (4, False, "boot-q")]


def _jnp(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("taps,case", MYULA_RUNS)
def test_wavelet_block_ref_matches_jax(taps, case):
    """Kernel 4's plain version against the JAX kernel (interpret mode), 6
    steps at 16^2, 2 levels, noise off: x, the moments and the markers."""
    scal_i, quantiles, thin = BLOCK_CASES[case]
    x, y, mask, mean, m2, qh, qn = _block_state(np.random.default_rng(taps), len(quantiles),
                                                case)
    gamma = 0.01
    scal_f = (0.2 * gamma, gamma, 100.0, gamma * 5.0, 0.0)
    kw = dict(levels=2, taps=taps, n_steps=6, with_noise=False,
              quantiles=quantiles, quantile_thin=thin)
    want = j_wf.wavelet_block_update(
        *_jnp(x, y, mask, mean, m2), jnp.asarray([3, 4], jnp.int32),
        jnp.asarray(scal_f), jnp.asarray(scal_i, jnp.int32), *_jnp(qh, qn),
        interpret=True, **kw)
    got = t_wf.wavelet_block_update(*_t(x, y, mask, mean, m2), (3, 4), scal_f,
                                    scal_i, *_t(qh, qn), **kw)
    for name, g, w in zip(("x", "mean", "m2", "qh", "qn"), got, want):
        if quantiles or name in ("x", "mean", "m2"):
            _close(g, w, name=name)


@pytest.mark.parametrize("taps,gfirst,case", ULPDA_RUNS)
def test_ulpda_wavelet_block_ref_matches_jax(taps, gfirst, case):
    """Kernel 5's plain version against the JAX kernel (interpret mode), 6
    steps at 16^2, 2 levels, noise off, both orders: x, the interleaved dual,
    xbar, the moments and the markers."""
    scal_i, quantiles, thin = BLOCK_CASES[case]
    x, y, mask, mean, m2, qh, qn = _block_state(np.random.default_rng(10 + taps),
                                                len(quantiles), case)
    rng = np.random.default_rng(20 + taps)
    c = np.clip(rng.normal(size=(N, N)), -0.4, 0.4)
    xbar = x + 0.1 * rng.normal(size=(N, N))
    sigma = 100.0
    scal_f = (0.95 / sigma, 1.0, 1.0, 0.0, sigma, 0.4)
    kw = dict(levels=2, taps=taps, n_steps=6, gfirst=gfirst, with_noise=False,
              quantiles=quantiles, quantile_thin=thin)
    want = j_wf.ulpda_wavelet_block_update(
        *_jnp(x, c, xbar, y, mask, mean, m2), jnp.asarray([3, 4], jnp.int32),
        jnp.asarray(scal_f), jnp.asarray(scal_i, jnp.int32), *_jnp(qh, qn),
        interpret=True, **kw)
    got = t_wf.ulpda_wavelet_block_update(
        *_t(x, c, xbar, y, mask, mean, m2), (3, 4), scal_f, scal_i, *_t(qh, qn), **kw)
    for name, g, w in zip(("x", "c", "xbar", "mean", "m2", "qh", "qn"), got, want):
        if quantiles or name not in ("qh", "qn"):
            _close(g, w, name=name)


# (image side, Haar levels): model M10's 3 levels, and 6, past the 5 of a
# CTA's region, where the card takes one launch per level and axis; the
# 3-level cases keep their ids
WL1_CASES = [pytest.param(32, 3, False, id="False"), pytest.param(32, 3, True, id="True"),
             pytest.param(64, 6, False, id="64-6-False"),
             pytest.param(64, 6, True, id="64-6-True")]


@pytest.mark.parametrize("n, want_levels, gfirst", WL1_CASES)
def test_ulpda_wl1_block_ref_matches_jax(n, want_levels, gfirst):
    """Kernel 3's ``"wl1"`` dual (plain version) against the JAX kernel in
    interpret mode: the k5 deconvolution data term at n^2 with an interleaved
    Haar dual of ``want_levels`` levels, 3 steps from a mid-chain state, noise
    off."""
    sig = 0.75
    img = phantom(n, np.float64)
    jb = j_lin.CirculantBlur2D.from_kernel((n, n), j_lin.uniform_kernel(5, jnp.float64))
    rng = np.random.default_rng(4)
    y = np.asarray(jb.matvec(jnp.asarray(img))) + sig * rng.normal(size=(n, n))
    jl2 = j_fn.L2Data.create(op=jb, b=jnp.asarray(y), sigma=1 / sig**2)
    (taps, (oy, ox), atb, mode, _, _, _, dual, lam, levels) = j_ulpda._ulpda_setup(
        jl2, j_fn.L1Norm(sigma=0.3), j_wav.HaarDWT2D(levels=want_levels), 0.95 * sig**2, 1.0)
    assert (dual, levels, mode) == ("wl1", want_levels, "tv")
    x, xbar, mean = rng.normal(size=(3, n, n)) * 20 + 100
    py = np.clip(rng.normal(size=(n, n)), -0.3, 0.3)
    m2 = rng.uniform(1, 5, size=(n, n)) * 30
    scal_f = (0.95 * sig**2, 1.0, 1.0, 0.0, 1 / sig**2, 0.3)
    scal_i = (7, 8, 2)
    kw = dict(taps=taps, oy=oy, ox=ox, lam=lam, n_steps=3, niter_solve=3,
              gfirst=gfirst, dual="wl1", levels=levels, with_noise=False)
    want = j_ulpda.ulpda_block_update(
        *_jnp(x, py), jnp.zeros((1, 1)), *_jnp(xbar, atb, mean, m2),
        jnp.asarray([3, 4], jnp.int32), jnp.asarray(scal_f),
        jnp.asarray(scal_i, jnp.int32), interpret=True, **kw)
    got = t_ulpda.ulpda_block_update(*_t(x, py), None, *_t(xbar, atb, mean, m2),
                                     (3, 4), scal_f, scal_i, **kw)
    assert got[2] is None
    for name, i in (("x", 0), ("py", 1), ("xbar", 3), ("mean", 4), ("m2", 5)):
        _close(got[i], want[i], tol=1e-10, name=name)


@pytest.mark.parametrize("levels", range(1, 8))
def test_ulpda_wl1_route_by_levels(levels):
    """Kernel 3's ``"wl1"`` dual takes any number of Haar levels on the card:
    up to 5 the tile route on a CTA's region of whole 2^levels tiles, past 5
    (a tile larger than the 32x32 region) one launch per level and axis."""
    for shape in ((512, 512), (256, 128)):
        l_eff, route, region = t_ulpda._wl1_plan(shape, levels)
        assert l_eff == t_wf.haar_levels(shape, levels) == levels
        if levels <= 5:
            assert route == "tile" and region == t_wf.tile_region(shape, levels)
        else:
            assert route == "passes" and region == (0, 0)


def test_tile_region_and_guards():
    """The Haar kernels' CTA regions: whole tiles dividing the image, at
    most 32 on a side; deeper tiles raise. The CUDA wrappers refuse CPU
    tensors without counting a launch; bad taps raise."""
    assert t_wf.tile_region((512, 512), 3) == (32, 32)
    assert t_wf.tile_region((512, 512), 5) == (32, 32)
    assert t_wf.tile_region((24, 40), 3) == (24, 8)
    assert t_wf.haar_levels((24, 24), 5) == 3 and t_wf.dwt_levels((24, 24), 8, 5) == 2
    with pytest.raises(ValueError, match="32x32"):
        t_wf.tile_region((512, 512), 6)
    z = torch.zeros((N, N), dtype=torch.float32)
    before = (t_wf.wavelet_block_update_cuda.launches,
              t_wf.ulpda_wavelet_block_update_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_wf.wavelet_block_update_cuda(z, z, z, z, z, 0, (1e-3, 1e-2, 1.0, 0.1, 1.0),
                                       (0, 0, 0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_wf.ulpda_wavelet_block_update_cuda(z, z, z, z, z, z, z, 0,
                                             (1e-3, 1.0, 1.0, 1.0, 1.0, 0.1), (0, 0, 0))
    assert (t_wf.wavelet_block_update_cuda.launches,
            t_wf.ulpda_wavelet_block_update_cuda.launches) == before
    with pytest.raises(ValueError, match="taps=6"):
        t_wf.wavelet_block_update(z, z, z, z, z, 0, (1e-3, 1e-2, 1.0, 0.1, 1.0),
                                  (0, 0, 0), taps=6)


# the first and fifth cases keep the ids of the routes they named before
# the warp and resident routes ("tile", "passes")
@pytest.mark.parametrize("shape, taps, levels, route, region", [
    pytest.param((512, 512), 2, 3, "warp", (8, 8), id="shape0-2-3-tile-region0"),
    ((512, 512), 2, 5, "tile", (32, 32)),
    ((512, 512), 2, 6, "passes", (0, 0)),
    ((128, 64), 2, 7, "passes", (0, 0)),
    pytest.param((512, 512), 4, 3, "resident", (32, 64), id="shape4-4-3-passes-region4"),
    pytest.param((2048, 2048), 4, 3, "passes", (0, 0), id="shape5-4-3-passes-region5"),
])
def test_prepare_routes_haar_levels(monkeypatch, shape, taps, levels, route, region):
    """The CUDA wrappers' checks take any number of Haar levels: up to 3 the
    block runs in 8x8 squares of one warp, up to 5 in tiles of one CTA, past
    5 (a 2^levels square larger than a CTA's 32x32 region) in one launch per
    level and axis, as D4/D8 do where their tiles do not all fit the card at
    once (2048^2); at 512^2 D4/D8 take the resident route."""
    monkeypatch.setattr(t_wf._build, "require_cuda_f32", lambda *a, **k: None)
    z = torch.zeros(shape, dtype=torch.float32)
    (l_eff, got_route, got_region, _), steps, _ = t_wf._prepare(
        z, taps, levels, 4, (0, 0, 0), (), None, None, {"x": z})
    assert (l_eff, got_route, got_region, steps) == (
        t_wf.dwt_levels(shape, taps, levels), route, region, (0, 0, 0))
