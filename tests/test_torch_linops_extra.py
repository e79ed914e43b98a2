"""Port parity for the operator leftovers, on the CPU in f64: the ``LinOp``
base (``gram_solve`` by CG, the power-method ``max_gram_eig``),
``Diagonal``, ``Matrix``, ``Convolve2D``, ``cg_gram_solve``, the opt-in
stencil of ``CirculantBlur2D`` with ``L2Data.create``'s cached ``A^T b``,
``prox_tv_aniso``, ``TV1DNorm`` and ``moreau_envelope``, each against the
JAX package on the same numpy inputs (mirrors ``tests/test_linops.py`` and
``tests/test_parity_extras.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import convolve2d

from lmc_atomi_torch import interop
from lmc_atomi_torch.ops import functionals as t_fn
from lmc_atomi_torch.ops import linops as t_lin
from lmc_atomi_torch.ops import moreau as t_moreau
from lmc_atomi_torch.ops import tv as t_tv
from lmc_atomi_tpu.ops import functionals as j_fn
from lmc_atomi_tpu.ops import linops as j_lin
from lmc_atomi_tpu.ops import moreau as j_moreau
from lmc_atomi_tpu.ops import tv as j_tv

torch.set_num_threads(2)

# f64 on both sides: the same operations in another order
TOL = 1e-12
# a power method or CG run: roundoff grows over the trips
ITER_TOL = 1e-10


def _t(a):
    return torch.from_numpy(np.array(a, np.float64))


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)


def _adjoint(op, x_shape):
    lhs, rhs = t_lin.dot_test(op, torch.Generator().manual_seed(0), x_shape)
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-10)


def test_diagonal_and_matrix():
    rng = np.random.default_rng(0)
    d = np.linspace(0.5, 2.0, 12)
    a = rng.normal(size=(7, 5))
    y12, y5, y7 = rng.normal(size=12), rng.normal(size=5), rng.normal(size=7)
    td, jd = t_lin.Diagonal(diag=_t(d)), j_lin.Diagonal(diag=jnp.asarray(d))
    tm, jm = t_lin.Matrix(a=_t(a)), j_lin.Matrix(a=jnp.asarray(a))
    _adjoint(td, (12,))
    _adjoint(tm, (5,))
    _close(td.matvec(_t(y12)), jd.matvec(jnp.asarray(y12)))
    _close(td.gram_solve(0.7, _t(y12)), jd.gram_solve(0.7, jnp.asarray(y12)))
    _close(tm.matvec(_t(y5)), jm.matvec(jnp.asarray(y5)))
    _close(tm.rmatvec(_t(y7)), jm.rmatvec(jnp.asarray(y7)))
    # the Cholesky solve of (I + rho A^T A) x = y, on a vector and on columns
    _close(tm.gram_solve(0.8, _t(y5)), jm.gram_solve(0.8, jnp.asarray(y5)))
    y53 = rng.normal(size=(5, 3))
    _close(tm.gram_solve(0.8, _t(y53)), jm.gram_solve(0.8, jnp.asarray(y53)))
    lhs = tm.gram_solve(0.8, _t(y5))
    _close(lhs + 0.8 * tm.rmatvec(tm.matvec(lhs)), y5, name="solve residual")


@pytest.mark.parametrize("k,offset", [(5, None), (6, None), (7, None), (4, (1, 2))])
def test_convolve2d_against_jax_and_scipy(k, offset):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(14, 13))
    h = rng.normal(size=(k, k))
    top = t_lin.Convolve2D.from_kernel(_t(h), offset)
    jop = j_lin.Convolve2D.from_kernel(jnp.asarray(h), offset)
    assert top.offset == jop.offset
    _close(top.matvec(_t(x)), jop.matvec(jnp.asarray(x)))
    _close(top.rmatvec(_t(x)), jop.rmatvec(jnp.asarray(x)))
    oy, ox = top.offset
    full = convolve2d(x, h, mode="full", boundary="fill")
    _close(top.matvec(_t(x)), full[oy:oy + 14, ox:ox + 13], name="scipy")
    _adjoint(top, (14, 13))


def test_cg_gram_solve_against_jax_and_dense():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(10, 10)) / 3.0
    y = rng.normal(size=10)
    got = t_lin.cg_gram_solve(t_lin.Matrix(a=_t(a)), 0.8, _t(y), niter=60)
    _close(got, j_lin.cg_gram_solve(j_lin.Matrix(a=jnp.asarray(a)), 0.8, jnp.asarray(y),
                                    niter=60), ITER_TOL)
    want = np.linalg.solve(np.eye(10) + 0.8 * a.T @ a, y)
    _close(got, want, 1e-9, "dense solve")
    # an image operator through the base's gram_solve, a start x0, and the
    # 1e-30 guards once the residual is exactly zero (Identity: one trip)
    h = rng.normal(size=(5, 5))
    img = rng.normal(size=(12, 12))
    x0 = rng.normal(size=(12, 12))
    tc, jc = t_lin.Convolve2D.from_kernel(_t(h)), j_lin.Convolve2D.from_kernel(jnp.asarray(h))
    _close(tc.gram_solve(1.3, _t(img), niter=25),
           jc.gram_solve(1.3, jnp.asarray(img), niter=25), ITER_TOL)
    _close(t_lin.cg_gram_solve(tc, 1.3, _t(img), x0=_t(x0), niter=7),
           j_lin.cg_gram_solve(jc, 1.3, jnp.asarray(img), x0=jnp.asarray(x0), niter=7),
           ITER_TOL)
    ident = t_lin.cg_gram_solve(t_lin.Matrix(a=torch.eye(4, dtype=torch.float64)), 1.0,
                                _t(np.ones(4)), niter=5)
    assert torch.all(torch.isfinite(ident))
    _close(ident, np.full(4, 0.5))


@pytest.mark.parametrize("case", ["gradient", "convolve"])
def test_max_gram_eig_one_probe(case):
    """The power method from one probe in both packages; the gradient's
    estimate stays under its closed form 8."""
    rng = np.random.default_rng(4)
    probe = rng.normal(size=(16, 16))
    if case == "gradient":
        tops, jops = t_lin.Gradient2D(), j_lin.Gradient2D()
    else:
        h = np.ones((5, 3)) / 15.0
        tops, jops = (t_lin.Convolve2D.from_kernel(_t(h)),
                      j_lin.Convolve2D.from_kernel(jnp.asarray(h)))
    got = t_lin.LinOp.max_gram_eig(tops, probe=_t(probe), iters=50)
    want = j_lin.LinOp.max_gram_eig(jops, probe=jnp.asarray(probe), iters=50)
    np.testing.assert_allclose(float(got), float(want), rtol=ITER_TOL)
    if case == "gradient":
        assert float(got) <= 8.0 + 1e-9
    with pytest.raises(ValueError, match="probe"):
        t_lin.LinOp.max_gram_eig(tops)


@pytest.mark.parametrize("psf", ["square", "rectangular", "off_centre"])
def test_circulant_blur_as_linop_matches_jax(psf):
    """``CirculantBlur2D`` as a ``LinOp`` for square and rectangular PSFs and
    an off-centre origin: A, A^T and A^T A against the JAX package, the
    cached-spectrum ``L2Data`` gradient against JAX's, and the base class's
    CG gram solve against the exact spectral divide."""
    rng = np.random.default_rng(7)
    h, off = {"square": (np.ones((5, 5)) / 25, None),
              "rectangular": (rng.normal(size=(3, 5)), None),
              "off_centre": (rng.normal(size=(4, 3)), (1, 2))}[psf]
    x = rng.normal(size=(20, 24))
    jop = j_lin.CirculantBlur2D.from_kernel((20, 24), jnp.asarray(h), off)
    top = interop.blur_from_numpy(np.asarray(jop.eigs_re), np.asarray(jop.eigs_im),
                                  np.asarray(jop.h), np.asarray(jop.hh), jop.offset)
    assert isinstance(top, t_lin.LinOp)
    for fn in ("matvec", "rmatvec", "gram_matvec"):
        _close(getattr(top, fn)(_t(x)), getattr(jop, fn)(jnp.asarray(x)), name=f"{fn} jax")
    tl2 = t_fn.L2Data.create(op=top, b=_t(x), sigma=2.0)
    jl2 = j_fn.L2Data.create(op=jop, b=jnp.asarray(x), sigma=2.0)
    assert tl2.b_spec is not None
    z = rng.normal(size=(20, 24))
    _close(tl2.grad(_t(z)), jl2.grad(jnp.asarray(z)), name="spectral grad")
    _close(t_lin.LinOp.gram_solve(top, 0.7, _t(z), niter=200), top.gram_solve(0.7, _t(z)),
           ITER_TOL, name="CG against the exact solve")


def test_l2data_over_convolve2d_prox():
    """``L2Data`` over a LinOp without an exact solve: the prox is the CG
    gram solve with ``niter_solve`` trips."""
    rng = np.random.default_rng(8)
    h = np.ones((5, 5)) / 25.0
    b, x = rng.normal(size=(24, 24)), rng.normal(size=(24, 24))
    tl2 = t_fn.L2Data(op=t_lin.Convolve2D.from_kernel(_t(h)), b=_t(b), sigma=1.5,
                      niter_solve=20)
    jl2 = j_fn.L2Data(op=j_lin.Convolve2D.from_kernel(jnp.asarray(h)), b=jnp.asarray(b),
                      sigma=1.5, niter_solve=20)
    _close(tl2.prox(_t(x), 0.3), jl2.prox(jnp.asarray(x), 0.3), ITER_TOL)
    _close(tl2.grad(_t(x)), jl2.grad(jnp.asarray(x)))
    np.testing.assert_allclose(float(tl2(_t(x))), float(jl2(jnp.asarray(x))), rtol=TOL)


@pytest.mark.parametrize("niter", [0, 1, 10])
def test_prox_tv_aniso_and_tv1d(niter):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(13, 11))
    _close(t_tv.prox_tv_aniso(_t(x), 0.7, niter=niter),
           j_tv.prox_tv_aniso(jnp.asarray(x), 0.7, niter=niter))
    tn, jn = t_fn.TV1DNorm(sigma=0.4, niter=niter), j_fn.TV1DNorm(sigma=0.4, niter=niter)
    np.testing.assert_allclose(float(tn(_t(x))), float(jn(jnp.asarray(x))), rtol=TOL)
    got = tn.prox(_t(x), 1.5)
    assert got.shape == x.shape
    _close(got, jn.prox(jnp.asarray(x), 1.5))


def test_moreau_envelope():
    """The envelope of the isotropic TV and of the l1 norm, value, gradient
    and prox point, against the JAX combinator; for l1 also the closed
    form (the Huber function)."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(12, 12))
    cases = [
        (t_fn.TVNorm(sigma=0.5, niter=10), j_fn.TVNorm(sigma=0.5, niter=10), 0.3),
        (t_fn.L1Norm(sigma=1.0), j_fn.L1Norm(sigma=1.0), 0.2),
    ]
    for tg, jg, lam in cases:
        te = t_moreau.moreau_envelope(tg, tg.prox, lam)
        je = j_moreau.moreau_envelope(jg, jg.prox, lam)
        assert isinstance(te, t_moreau.MoreauEnvelope)
        np.testing.assert_allclose(float(te.value(_t(x))), float(je.value(jnp.asarray(x))),
                                   rtol=TOL)
        _close(te.grad(_t(x)), je.grad(jnp.asarray(x)))
        _close(te.prox_point(_t(x)), je.prox_point(jnp.asarray(x)))
    te = t_moreau.moreau_envelope(cases[1][0], cases[1][0].prox, 0.2)
    huber = np.where(np.abs(x) <= 0.2, x**2 / 0.4, np.abs(x) - 0.1).sum()
    np.testing.assert_allclose(float(te.value(_t(x))), huber, rtol=TOL)


def test_existing_operators_are_linops():
    """The operators of the earlier slices share the base; their own methods
    stand, and the base's fills the rest (the gradient's gram solve by CG)."""
    for op in (t_lin.Identity(), t_lin.Gradient2D(),
               t_lin.Mask(mask=torch.ones(3, 3, dtype=torch.float64))):
        assert isinstance(op, t_lin.LinOp)
    rng = np.random.default_rng(11)
    y = rng.normal(size=(9, 9))
    _close(t_lin.Gradient2D().gram_solve(0.5, _t(y), niter=30),
           j_lin.Gradient2D().gram_solve(0.5, jnp.asarray(y), niter=30), ITER_TOL)

