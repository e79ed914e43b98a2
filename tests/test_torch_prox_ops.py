"""The port's proximal operators (``lmc_atomi_torch/ops/prox.py``) and
Bregman maps (``ops/bregman.py``) against the JAX package's, in f64 on
seeded numpy inputs: within 1e-12 of the output's scale, 1e-10 for the
bisection operators (Weibull, generalized inverse Gaussian, Pearson type I),
whose 64 trips stop at the f64 grid of their brackets."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.ops import bregman as t_breg
from lmc_atomi_torch.ops import prox as t_prox
from lmc_atomi_tpu.ops import bregman as j_breg
from lmc_atomi_tpu.ops import prox as j_prox
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, uniform_kernel

TOL = 1e-12
TOL_BISECT = 1e-10


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)


def _x(shape=(7, 5), scale=3.0, seed=0):
    return np.random.default_rng(seed).normal(size=shape) * scale


# (name, args after x, tolerance): every operator of the JAX module that
# takes an elementwise input
CASES = [
    ("prox_laplace", (0.7,), TOL),
    ("soft_threshold", (1.3,), TOL),
    ("prox_gaussian", (0.4,), TOL),
    ("prox_huber", (0.5, 0.8), TOL),
    ("prox_smoothed_laplace", (0.6,), TOL),
    ("prox_exp", (0.9,), TOL),
    ("prox_gamma", (0.3, 1.7), TOL),
    ("prox_chi", (2.5,), TOL),
    ("prox_uniform", (1.1,), TOL),
    ("prox_triangular", (-2.0, 3.0), TOL),
    ("prox_box", (-0.5, 1.5), TOL),
    ("prox_l21_pairs", (0.8,), TOL),
    ("prox_l2_ball", (2.0,), TOL),
    ("prox_weibull", (0.7, 1.3, 3.0), TOL_BISECT),
    ("prox_gen_inv_gaussian", (0.5, 1.2, 0.3), TOL_BISECT),
    ("prox_pearson_I", (0.4, 0.6, -1.0, 2.0), TOL_BISECT),
]


@pytest.mark.parametrize("name,args,tol", CASES, ids=[c[0] for c in CASES])
def test_prox_operator(name, args, tol):
    x = _x()
    _close(getattr(t_prox, name)(torch.from_numpy(x), *args),
           getattr(j_prox, name)(jnp.asarray(x), *args), tol, name)


@pytest.mark.parametrize("p", [4 / 3, 3 / 2, 3, 4])
def test_prox_gen_gaussian_and_max_ent(p):
    x = _x(seed=1)
    _close(t_prox.prox_gen_gaussian(torch.from_numpy(x), 0.6, p),
           j_prox.prox_gen_gaussian(jnp.asarray(x), 0.6, p))
    _close(t_prox.prox_max_ent(torch.from_numpy(x), 0.3, 0.4, 0.7, p),
           j_prox.prox_max_ent(jnp.asarray(x), 0.3, 0.4, 0.7, p))
    with pytest.raises(ValueError):
        t_prox.prox_gen_gaussian(torch.from_numpy(x), 0.6, 2)


def test_prox_uncentered_conjugate_and_l2_ball_axis():
    x, mu = _x(seed=2), _x(seed=3, scale=1.0)
    _close(t_prox.prox_uncentered_laplace(torch.from_numpy(x), 0.9, torch.from_numpy(mu)),
           j_prox.prox_uncentered_laplace(jnp.asarray(x), 0.9, jnp.asarray(mu)))
    _close(t_prox.prox_conjugate(torch.from_numpy(x), 0.7, t_prox.prox_laplace),
           j_prox.prox_conjugate(jnp.asarray(x), 0.7, j_prox.prox_laplace))
    _close(t_prox.prox_l2_ball(torch.from_numpy(x), 1.5, axis=1),
           j_prox.prox_l2_ball(jnp.asarray(x), 1.5, axis=1))


def test_bisection_roots_solve_their_equations():
    """The bisection operators land on the roots of their stationarity
    equations, inside their brackets."""
    x = torch.from_numpy(_x(seed=4))
    y = t_prox.prox_weibull(x, 0.7, 1.3, 3.0)
    assert bool((y > 0).all())
    assert float((3.0 * 0.7 * y**3 + y**2 - x * y - 1.3).abs().max()) < 1e-9
    y = t_prox.prox_pearson_I(x, 0.4, 0.6, -1.0, 2.0)
    assert bool(((y > -1.0) & (y < 2.0)).all())


def test_prox_square_loss_circulant():
    n = 12
    jb = CirculantBlur2D.from_kernel((n, n), uniform_kernel(3, jnp.float64))
    tb = interop.blur_from_numpy(np.asarray(jb.eigs_re), np.asarray(jb.eigs_im),
                                 np.asarray(jb.h), np.asarray(jb.hh), jb.offset)
    x, y = _x((n, n), seed=5), _x((n, n), seed=6)
    _close(t_prox.prox_square_loss(torch.from_numpy(x), torch.from_numpy(y), tb, 0.8),
           j_prox.prox_square_loss(jnp.asarray(x), jnp.asarray(y), jb, 0.8))


BREG = [
    ("grad_mirror_hyp", lambda m, x, b: m.grad_mirror_hyp(x, b)),
    ("grad_conjugate_mirror_hyp", lambda m, x, b: m.grad_conjugate_mirror_hyp(x, b)),
    ("left_bregman_prox_l1_hypent", lambda m, x, b: m.left_bregman_prox_l1_hypent(x, b, 0.4)),
    ("bregman_moreau_env_grad_l1_hypent",
     lambda m, x, b: m.bregman_moreau_env_grad_l1_hypent(x, b, 0.01, 0.1)),
]


@pytest.mark.parametrize("name,fn", BREG, ids=[b[0] for b in BREG])
def test_bregman(name, fn):
    x = _x((64, 2), seed=7)
    beta = np.array([0.7, 0.3])
    _close(fn(t_breg, torch.from_numpy(x), torch.from_numpy(beta)),
           fn(j_breg, jnp.asarray(x), jnp.asarray(beta)), name=name)
