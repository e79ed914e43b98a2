"""Port parity for the operators of the deconvolution slice, in f64 on the
CPU against the JAX package: the soft threshold, the anisotropic and 1-D TV
values and proxes, ``Gradient2D``, ``L1Norm``/``L21Norm`` and the nonconvex
data term ``L2NcvxTV`` (MC-TV and ME-TV, isotropic and anisotropic)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.ops import functionals as t_fn
from lmc_atomi_torch.ops import tv as t_tv
from lmc_atomi_torch.ops.prox import prox_laplace as t_prox_laplace
from lmc_atomi_tpu.ops import tv as j_tv
from lmc_atomi_tpu.ops.functionals import L1Norm, L21Norm, L2Data
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, Gradient2D, uniform_kernel
from lmc_atomi_tpu.ops.ncvx_tv import L2NcvxTV
from lmc_atomi_tpu.ops.prox import prox_laplace

torch.set_num_threads(2)

TOL = 1e-10  # f64 roundoff of FFT round trips and short stencil loops


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(torch.as_tensor(got)), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("gamma", [0.0, 0.3, 2.0])
def test_prox_laplace_matches_jax(gamma):
    x = np.random.default_rng(0).normal(size=(12, 10)) * 2.0
    _close(t_prox_laplace(torch.from_numpy(x), gamma),
           prox_laplace(jnp.asarray(x), gamma), tol=0)


@pytest.mark.parametrize("fn", ["tv_aniso", "tv1d", "prox_tv1d"])
def test_aniso_and_1d_tv_match_jax(fn):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(20, 24)) * 3.0
    if fn != "tv_aniso":
        x = x.ravel()
    args = (0.7, 7) if fn.startswith("prox") else ()
    got = getattr(t_tv, fn)(torch.from_numpy(x), *args)
    want = getattr(j_tv, fn)(jnp.asarray(x), *args)
    _close(got, want)


@pytest.mark.parametrize("sampling", [1.0, 2.0])
def test_gradient2d_matches_jax(sampling):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(16, 20))
    p = rng.normal(size=(2, 16, 20))
    t_op = interop.gradient_from_numpy(sampling)
    j_op = Gradient2D(sampling=sampling)
    _close(t_op.matvec(torch.from_numpy(x)), j_op.matvec(jnp.asarray(x)), tol=1e-14)
    _close(t_op.rmatvec(torch.from_numpy(p)), j_op.rmatvec(jnp.asarray(p)),
           tol=1e-14)
    assert float(t_op.max_gram_eig()) == float(j_op.max_gram_eig())
    # the adjoint: <G x, p> = <x, G^T p>
    lhs = float(torch.sum(t_op.matvec(torch.from_numpy(x)) * torch.from_numpy(p)))
    rhs = float(torch.sum(torch.from_numpy(x) * t_op.rmatvec(torch.from_numpy(p))))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


@pytest.mark.parametrize("norm", ["l1", "l21"])
def test_l1_l21_norms_match_jax(norm):
    z = np.random.default_rng(3).normal(size=(2, 12, 14)) * 0.5
    z[:, :3, :3] = 0.0  # zero groups: the 1e-30 guards
    t_g, j_g = ((t_fn.L1Norm(sigma=0.3), L1Norm(sigma=0.3)) if norm == "l1"
                else (t_fn.L21Norm(sigma=0.3), L21Norm(sigma=0.3)))
    zt, zj = torch.from_numpy(z), jnp.asarray(z)
    _close(t_g(zt), j_g(zj), tol=1e-13)
    _close(t_g.prox(zt, 0.8), j_g.prox(zj, 0.8), tol=1e-14)
    _close(t_g.proxdual(zt, 1.0), j_g.proxdual(zj, 1.0), tol=1e-14)


@pytest.fixture(scope="module")
def blur_problem():
    rng = np.random.default_rng(4)
    ny, nx = 24, 20
    jb = CirculantBlur2D.from_kernel((ny, nx), uniform_kernel(5, jnp.float64))
    tb = interop.blur_from_numpy(np.asarray(jb.eigs_re), np.asarray(jb.eigs_im),
                                 np.asarray(jb.h), np.asarray(jb.hh), jb.offset)
    b = rng.normal(size=(ny, nx)) * 10 + 100
    x = rng.normal(size=(ny, nx)) * 10 + 100
    q = rng.normal(size=(ny, nx))
    return jb, tb, b, x, q


@pytest.mark.parametrize("isotropic", [True, False])
@pytest.mark.parametrize("mode", ["mctv", "metv", "metv_q"])
def test_l2ncvx_matches_jax(blur_problem, mode, isotropic):
    """Value, gradient and prox (MC-TV and ME-TV, both TV flavours, and a
    linear ``q`` term) against the JAX functional."""
    jb, tb, b, x, q = blur_problem
    fields = dict(sigma=1.7, lamda=0.3, gamma=2.5, isotropic=isotropic,
                  niter_inner=7, niter_solve=20)
    use_q = mode == "metv_q"
    if use_q:
        fields.update(alpha=0.4)
    j_op2 = Gradient2D() if mode == "mctv" else None
    t_op2 = interop.gradient_from_numpy() if mode == "mctv" else None
    jf = L2NcvxTV(op=jb, b=jnp.asarray(b), op2=j_op2,
                  q=jnp.asarray(q) if use_q else None, **fields)
    tf = interop.l2ncvx_from_numpy(b, tb, op2=t_op2, q=q if use_q else None,
                                   **fields)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(tf(xt), jf(xj))
    _close(tf.grad(xt), jf.grad(xj))
    _close(tf.prox(xt, 0.5), jf.prox(xj, 0.5))


def test_l2data_keeps_niter_solve():
    jb = CirculantBlur2D.from_kernel((8, 8), uniform_kernel(3, jnp.float64))
    tb = interop.blur_from_numpy(np.asarray(jb.eigs_re), np.asarray(jb.eigs_im),
                                 np.asarray(jb.h), np.asarray(jb.hh), jb.offset)
    b = np.random.default_rng(5).normal(size=(8, 8))
    t_l2 = t_fn.L2Data.create(op=tb, b=torch.from_numpy(b), niter_solve=7)
    j_l2 = L2Data.create(op=jb, b=jnp.asarray(b), niter_solve=7)
    assert t_l2.niter_solve == j_l2.niter_solve == 7
    x = np.random.default_rng(6).normal(size=(8, 8))
    _close(t_l2.prox(torch.from_numpy(x), 0.4), j_l2.prox(jnp.asarray(x), 0.4))
