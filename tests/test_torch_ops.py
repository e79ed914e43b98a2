"""Port parity: linear operators, TV proxes and functionals of
``lmc_atomi_torch`` against ``lmc_atomi_tpu`` in f64 on the CPU (same numpy
inputs into both packages), plus the port's guards: no JAX import, no silent
CPU fallback for CUDA kernels, a clear error without ``nvcc``."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import _build, interop
from lmc_atomi_torch.eval import metrics as t_metrics
from lmc_atomi_torch.ops import linops as t_linops
from lmc_atomi_torch.ops import tv as t_tv
from lmc_atomi_torch.ops.functionals import L2Data as TL2Data
from lmc_atomi_torch.ops.functionals import TVNorm as TTVNorm
from lmc_atomi_torch.ops.tv_cuda import prox_tv_iso_cuda, prox_tv_iso_ref
from lmc_atomi_tpu.eval import metrics as j_metrics
from lmc_atomi_tpu.ops import tv as j_tv
from lmc_atomi_tpu.ops.functionals import L2Data, TVNorm
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, gaussian_kernel, uniform_kernel
from lmc_atomi_tpu.ops.tv_pallas import prox_tv_iso_pallas

torch.set_num_threads(2)  # tier-1 runs several pytest workers on few cores

TOL = 1e-10  # f64 roundoff of FFT round trips and short stencil loops


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def problem():
    """A 32x28 blur problem built in JAX (f64) and carried to the port."""
    rng = np.random.default_rng(0)
    ny, nx = 32, 28
    h = uniform_kernel(5, jnp.float64)
    jb = CirculantBlur2D.from_kernel((ny, nx), h)
    b = rng.normal(size=(ny, nx))
    jl2 = L2Data.create(op=jb, b=jnp.asarray(b), sigma=1.7)
    tb = interop.blur_from_numpy(
        np.asarray(jb.eigs_re), np.asarray(jb.eigs_im), np.asarray(jb.h),
        np.asarray(jb.hh), jb.offset,
    )
    tl2 = interop.l2data_from_numpy(b, 1.7, tb)
    x = rng.normal(size=(ny, nx))
    return jb, jl2, tb, tl2, x


@pytest.mark.parametrize(
    "name", ["matvec", "rmatvec", "gram_matvec", "normal_grad", "gram_solve",
             "l2_grad", "l2_value", "l2_prox", "max_gram_eig"],
)
def test_blur_and_l2data_match_jax(problem, name):
    jb, jl2, tb, tl2, x = problem
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    b = np.asarray(jl2.b)
    calls = {
        "matvec": (lambda: jb.matvec(xj), lambda: tb.matvec(xt)),
        "rmatvec": (lambda: jb.rmatvec(xj), lambda: tb.rmatvec(xt)),
        "gram_matvec": (lambda: jb.gram_matvec(xj), lambda: tb.gram_matvec(xt)),
        "normal_grad": (lambda: jb.normal_grad(xj, jnp.asarray(b)),
                        lambda: tb.normal_grad(xt, torch.from_numpy(b))),
        "gram_solve": (lambda: jb.gram_solve(0.37, xj),
                       lambda: tb.gram_solve(0.37, xt)),
        "l2_grad": (lambda: jl2.grad(xj), lambda: tl2.grad(xt)),
        "l2_value": (lambda: jl2(xj), lambda: tl2(xt)),
        "l2_prox": (lambda: jl2.prox(xj, 0.3), lambda: tl2.prox(xt, 0.3)),
        "max_gram_eig": (lambda: jb.max_gram_eig(), lambda: tb.max_gram_eig()),
    }
    want, got = calls[name]
    np.testing.assert_allclose(_np(got()), np.asarray(want()), rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", ["uniform5", "gaussian7", "offset3x5"])
def test_from_kernel_matches_jax(kind):
    shape = (24, 20)
    if kind == "uniform5":
        h, offset = np.asarray(uniform_kernel(5, jnp.float64)), None
    elif kind == "gaussian7":
        h, offset = np.asarray(gaussian_kernel(7, 1.3, jnp.float64)), None
    else:
        h = np.random.default_rng(3).uniform(size=(3, 5))
        h, offset = h / h.sum(), (0, 1)
    jb = CirculantBlur2D.from_kernel(shape, jnp.asarray(h), offset)
    tb = t_linops.CirculantBlur2D.from_kernel(shape, torch.from_numpy(h), offset)
    assert tb.offset == jb.offset
    np.testing.assert_allclose(_np(tb.eigs.real), np.asarray(jb.eigs_re), atol=TOL)
    np.testing.assert_allclose(_np(tb.eigs.imag), np.asarray(jb.eigs_im), atol=TOL)
    np.testing.assert_allclose(_np(tb.hh), np.asarray(jb.hh), atol=TOL)


def test_blur_kernels_match_jax():
    np.testing.assert_array_equal(
        _np(t_linops.uniform_kernel(5, torch.float64)),
        np.asarray(uniform_kernel(5, jnp.float64)))
    np.testing.assert_allclose(
        _np(t_linops.gaussian_kernel(7, 1.3, torch.float64)),
        np.asarray(gaussian_kernel(7, 1.3, jnp.float64)), atol=1e-15)


@pytest.mark.parametrize("gamma,niter", [(0.4, 10), (0.17, 3), (2.5, 10)])
def test_prox_tv_iso_ref_matches_jax_xla_and_pallas(gamma, niter):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(32, 24)) * 3.0
    got = _np(prox_tv_iso_ref(torch.from_numpy(x), gamma, niter=niter))
    xla = np.asarray(j_tv.prox_tv_iso(jnp.asarray(x), gamma, niter=niter,
                                      backend="xla"))
    pallas = np.asarray(prox_tv_iso_pallas(jnp.asarray(x), gamma, niter=niter,
                                           interpret=True))
    np.testing.assert_allclose(got, xla, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)
    # the device dispatch sends a CPU tensor to the plain version
    np.testing.assert_array_equal(
        _np(t_tv.prox_tv_iso(torch.from_numpy(x), gamma, niter=niter)), got)


@pytest.mark.parametrize("accel,niter", [(True, 8), (False, 10)])
def test_prox_tv_iso_proj_matches_jax(accel, niter):
    x = np.random.default_rng(2).normal(size=(28, 32)) * 2.0
    got = t_tv.prox_tv_iso_proj(torch.from_numpy(x), 0.3, niter=niter,
                                accel=accel)
    want = j_tv.prox_tv_iso_proj(jnp.asarray(x), 0.3, niter=niter, accel=accel)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)


def test_grad_div_tv_and_tvnorm_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(20, 24))
    p = rng.normal(size=(2, 20, 24))
    np.testing.assert_array_equal(_np(t_tv.grad2d(torch.from_numpy(x))),
                                  np.asarray(j_tv.grad2d(jnp.asarray(x))))
    np.testing.assert_allclose(_np(t_tv.div2d(torch.from_numpy(p))),
                               np.asarray(j_tv.div2d(jnp.asarray(p))), atol=1e-14)
    np.testing.assert_allclose(float(t_tv.tv_iso(torch.from_numpy(x))),
                               float(j_tv.tv_iso(jnp.asarray(x))), rtol=1e-13)
    assert t_tv.fgp_momentum(8) == j_tv.fgp_momentum(8)
    jn, tn = TVNorm(sigma=0.3, niter=7), TTVNorm(sigma=0.3, niter=7)
    np.testing.assert_allclose(float(tn(torch.from_numpy(x))),
                               float(jn(jnp.asarray(x))), rtol=1e-13)
    np.testing.assert_allclose(_np(tn.prox(torch.from_numpy(x), 0.8)),
                               np.asarray(jn.prox(jnp.asarray(x), 0.8)),
                               atol=TOL)


@pytest.mark.parametrize("fn", ["snr", "mse", "psnr"])
def test_metrics_match_jax(fn):
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 255, size=(16, 16))
    b = a + rng.normal(size=a.shape)
    got = float(getattr(t_metrics, fn)(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(getattr(j_metrics, fn)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-13)


def test_l2data_create_without_spectrum_cache():
    """An L2Data built without ``create`` takes the normal_grad path."""
    blur = t_linops.CirculantBlur2D.from_kernel(
        (16, 16), t_linops.uniform_kernel(3, torch.float64))
    b = torch.from_numpy(np.random.default_rng(6).normal(size=(16, 16)))
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(16, 16)))
    plain = TL2Data(op=blur, b=b, sigma=2.0)
    cached = TL2Data.create(op=blur, b=b, sigma=2.0)
    assert plain.b_spec is None and cached.b_spec is not None
    np.testing.assert_allclose(_np(plain.grad(x)), _np(cached.grad(x)), atol=TOL)


STENCIL_CASES = {  # tests/test_linops.py::test_stencil_gram_path_matches_spectral's three
    "uniform5": (np.ones((5, 5)) / 25, None),
    "normal3x5": (np.random.default_rng(7).normal(size=(3, 5)), None),
    "normal4x3-offset": (np.random.default_rng(8).normal(size=(4, 3)), (1, 2)),
}


@pytest.mark.parametrize("case", list(STENCIL_CASES))
def test_prefer_stencil_matches_jax_stencil(case):
    """``prefer_stencil``: the wrap-conv ``matvec``, ``rmatvec`` and
    ``gram_matvec`` and ``L2Data``'s cached-``atb`` gradient against the JAX
    operator's own stencil path, f64, atol 1e-12; the default stays
    spectral, and a chain axis takes each image's stencil."""
    import dataclasses

    h, off = STENCIL_CASES[case]
    rng = np.random.default_rng(7)
    x, b = rng.normal(size=(20, 24)), rng.normal(size=(20, 24))
    jb = dataclasses.replace(CirculantBlur2D.from_kernel((20, 24), jnp.asarray(h), off),
                             prefer_stencil=True)
    base = t_linops.CirculantBlur2D.from_kernel((20, 24), torch.from_numpy(h), off)
    tb = dataclasses.replace(base, prefer_stencil=True)
    carried = interop.blur_from_numpy(np.asarray(jb.eigs_re), np.asarray(jb.eigs_im),
                                      np.asarray(jb.h), np.asarray(jb.hh), jb.offset,
                                      prefer_stencil=True)
    assert not base.prefer_stencil and carried.prefer_stencil
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for name in ("matvec", "rmatvec", "gram_matvec"):
        want = np.asarray(getattr(jb, name)(xj))
        for op in (tb, carried):
            np.testing.assert_allclose(_np(getattr(op, name)(xt)), want, rtol=0, atol=1e-12,
                                       err_msg=name)
        np.testing.assert_allclose(_np(getattr(base, name)(xt)), want, rtol=0, atol=1e-12,
                                   err_msg=f"spectral {name}")
    jl2 = L2Data.create(op=jb, b=jnp.asarray(b), sigma=1.7)
    tl2 = TL2Data.create(op=tb, b=torch.from_numpy(b), sigma=1.7)
    assert jl2.atb is not None and tl2.atb is not None
    assert TL2Data.create(op=base, b=torch.from_numpy(b), sigma=1.7).atb is None
    np.testing.assert_allclose(_np(tl2.atb), np.asarray(jl2.atb), rtol=0, atol=1e-12)
    np.testing.assert_allclose(_np(tl2.grad(xt)), np.asarray(jl2.grad(xj)), rtol=0, atol=1e-12)
    xc = torch.stack([xt, -0.5 * xt])
    for name in ("matvec", "rmatvec", "gram_matvec"):
        got = getattr(tb, name)(xc)
        for c in range(2):
            np.testing.assert_array_equal(_np(got[c]), _np(getattr(tb, name)(xc[c])))


# --- guards -----------------------------------------------------------------

def test_port_imports_no_jax():
    """Every module of the port imports without pulling in JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lmc_atomi_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'lmc_atomi_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "want = {'lmc_atomi_torch.kernels.myula_fused', 'lmc_atomi_torch.utils.png',\n"
        "        'lmc_atomi_torch.utils.synthetic', 'lmc_atomi_torch.models.dncnn',\n"
        "        'lmc_atomi_torch.models.score', 'lmc_atomi_torch.experiments.pnp'}\n"
        "assert want <= set(names), want - set(names)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax')\n"
        "       or m.startswith(('jax.', 'flax.', 'optax.', 'lmc_atomi_tpu'))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_prox_tv_iso_cuda_raises_on_cpu_tensor():
    before = prox_tv_iso_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        prox_tv_iso_cuda(torch.zeros((8, 8), dtype=torch.float32), 0.3)
    assert prox_tv_iso_cuda.launches == before
