"""Faults C3, C4 and C5 of the port, repaired, held to the JAX package on the
CPU in f64 with the noise off.

C3: ``kernels/base.py::stepsize_at`` returned a numpy step-size schedule
whole; the JAX package's indexes it (``jnp.asarray``), so a numpy tau or mu
schedule (the reference's per-iteration arrays) now drives ``ulpda`` as in
JAX. C4: ``run/runner.py::run_chain`` had no ``collect_extras`` (ULPDA's dual
samples, the reference's ``returny``) and no ``unroll``. C5: JAX keywords
that the port rejected: ``prox_tv_iso(backend=)``, the Pallas-only
``interpret``/``stream_x`` of the fused runners and ``base_seed`` of the
one-step fused kernels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.kernels import imaging as t_imaging
from lmc_atomi_torch.kernels.base import stepsize_at as t_stepsize_at
from lmc_atomi_torch.ops import functionals as t_fn
from lmc_atomi_torch.run.runner import run_chain as t_run_chain
from lmc_atomi_tpu.kernels import imaging as j_imaging
from lmc_atomi_tpu.kernels.base import stepsize_at as j_stepsize_at
from lmc_atomi_tpu.ops.functionals import L21Norm, L2Data
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, Gradient2D, uniform_kernel
from lmc_atomi_tpu.run.runner import run_chain as j_run_chain
from lmc_atomi_tpu.utils.images import phantom

torch.set_num_threads(2)

N = 16
# f64 on both sides; the recursions differ in summation order only
TOL = 1e-9


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=name)


@pytest.mark.parametrize("spec", ["0d", "1d", "scalar", "list", "tensor"])
@pytest.mark.parametrize("step", [0, 2])
def test_stepsize_at_matches_jax(spec, step):
    """0-d and 1-d numpy arrays (and numpy scalars) resolve as
    ``jnp.asarray`` resolves them: the value itself, or the ``step``-th."""
    sched = np.array([0.1, 0.2, 0.3])
    given = {"0d": np.array(0.25), "1d": sched, "scalar": np.float64(0.25),
             "list": [0.1, 0.2, 0.3], "tensor": torch.from_numpy(sched)}[spec]
    want = float(j_stepsize_at(np.asarray(given) if spec == "tensor" else given, step))
    got = t_stepsize_at(given, step)
    assert float(got) == want


@pytest.fixture(scope="module")
def problem():
    img = phantom(N, np.float64)
    jb = CirculantBlur2D.from_kernel((N, N), uniform_kernel(3, jnp.float64))
    y = np.asarray(jb.matvec(jnp.asarray(img)))
    tb = interop.blur_from_numpy(np.asarray(jb.eigs_re), np.asarray(jb.eigs_im),
                                 np.asarray(jb.h), np.asarray(jb.hh), jb.offset)
    jterms = (L2Data(op=jb, b=jnp.asarray(y), sigma=1.0), L21Norm(sigma=0.3), Gradient2D())
    tterms = (interop.l2data_from_numpy(y, 1.0, tb), t_fn.L21Norm(sigma=0.3),
              interop.gradient_from_numpy())
    return y, jterms, tterms


@pytest.mark.parametrize("gfirst", [True, False])
def test_ulpda_numpy_tau_schedule_matches_jax(problem, gfirst):
    """C3: ``ulpda`` with numpy tau and mu schedules, noise off: 6 steps
    against the JAX package's ``ulpda`` on the same schedules."""
    y, jterms, tterms = problem
    tau = np.linspace(0.02, 0.07, 6)
    mu = np.full(6, 1.0)
    jk = j_imaging.ulpda(*jterms, tau=tau, mu=mu, gfirst=gfirst, noise_scale=0.0)
    want = j_run_chain(jk, jnp.zeros((N, N)), jax.random.PRNGKey(0), 6,
                       collect="samples")
    tk = t_imaging.ulpda(*tterms, tau=tau, mu=mu, gfirst=gfirst, noise_scale=0.0)
    got = t_run_chain(tk, torch.zeros((N, N), dtype=torch.float64), 0, 6,
                      collect="samples")
    _close(got.samples, want.samples, name="x")
    _close(got.final_state.extras.y, want.final_state.extras.y, name="y")


def test_ulpda_dual_samples_collected(problem):
    """C4, the torch twin of ``tests/test_parity_extras.py::
    test_ulpda_dual_samples_collected``: ``collect_extras=True`` stacks the
    dual and xbar of each emitted step, held to the JAX package's (noise
    off)."""
    _, jterms, tterms = problem
    jk = j_imaging.ulpda(*jterms, tau=0.05, mu=1.0, noise_scale=0.0)
    want = j_run_chain(jk, jnp.zeros((N, N)), jax.random.PRNGKey(0), 10,
                       collect="samples", collect_extras=True)
    tk = t_imaging.ulpda(*tterms, tau=0.05, mu=1.0, noise_scale=0.0)
    got = t_run_chain(tk, torch.zeros((N, N), dtype=torch.float64), 0, 10,
                      collect="samples", collect_extras=True)
    # dual samples: (steps, 2, n, n), the reference's returny
    assert got.extras.y.shape == (10, 2, N, N)
    assert got.extras.xbar.shape == (10, N, N) and got.extras.xprev is None
    _close(got.extras.y, want.extras.y, name="y")
    _close(got.extras.xbar, want.extras.xbar, name="xbar")


def test_collect_extras_projection(problem):
    """C4, the projection form (``tests/test_parity_extras.py::
    test_collect_extras_projection``): a function of the extras is stacked
    instead of the extras, with thinning; it equals the projection of the
    full stack and the JAX package's."""
    _, jterms, tterms = problem
    jk = j_imaging.ulpda(*jterms, tau=0.05, mu=1.0, noise_scale=0.0)
    want = j_run_chain(jk, jnp.zeros((N, N)), jax.random.PRNGKey(0), 12, thin=3,
                       collect="last", collect_extras=lambda e: jnp.sum(jnp.abs(e.y)))
    tk = t_imaging.ulpda(*tterms, tau=0.05, mu=1.0, noise_scale=0.0)
    x0 = torch.zeros((N, N), dtype=torch.float64)
    got = t_run_chain(tk, x0, 0, 12, thin=3, collect="last",
                      collect_extras=lambda e: torch.sum(torch.abs(e.y)))
    full = t_run_chain(tk, x0, 0, 12, thin=3, collect="last", collect_extras=True)
    assert got.extras.shape == (4,)
    assert torch.equal(got.extras, torch.abs(full.extras.y).sum(dim=(1, 2, 3)))
    _close(got.extras, want.extras, name="projection")


def test_run_chain_unroll_takes_no_effect(problem):
    """C4: ``unroll`` is accepted and changes nothing (the port's loop is
    eager)."""
    _, _, tterms = problem
    tk = t_imaging.ulpda(*tterms, tau=0.05, mu=1.0)
    x0 = torch.zeros((N, N), dtype=torch.float64)
    a = t_run_chain(tk, x0, (3, 1), 8, collect="stats")
    b = t_run_chain(tk, x0, (3, 1), 8, collect="stats", unroll=4)
    assert torch.equal(a.final_state.position, b.final_state.position)
    assert torch.equal(a.moments.mean, b.moments.mean) and a.extras is None


# --- C5: JAX keywords the port rejected --------------------------------------------
# Each keyword called as the JAX package calls it, against the JAX call (f64,
# noise off, interpret mode on the JAX side); the Pallas-only keywords take
# no effect in the port, ``base_seed`` offsets the seed word of the key.

C5_N = 32


def _blur_problem(n):
    """An ``n``-pixel phantom deblurring posterior (5x5 blur, noise 0.75)
    in both packages: ``(y, JAX L2Data, port L2Data)``."""
    img = phantom(n, np.float64)
    jb = CirculantBlur2D.from_kernel((n, n), uniform_kernel(5, jnp.float64))
    y = np.asarray(jb.matvec(jnp.asarray(img))) + 0.75 * np.random.default_rng(1).normal(
        size=(n, n))
    tb = interop.blur_from_numpy(np.asarray(jb.eigs_re), np.asarray(jb.eigs_im),
                                 np.asarray(jb.h), np.asarray(jb.hh), jb.offset)
    return y, L2Data.create(op=jb, b=jnp.asarray(y), sigma=1 / 0.75**2), \
        interop.l2data_from_numpy(y, 1 / 0.75**2, tb)


@pytest.fixture(scope="module")
def c5_blur():
    return _blur_problem(C5_N)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_prox_tv_iso_backend_matches_jax(c5_blur, backend):
    """``prox_tv_iso(backend=...)`` as ``tests/test_tv_pallas.py`` calls
    JAX's: "xla" (and "auto" on a CPU tensor) is the plain version bit for
    bit, and JAX's ``backend="xla"`` prox within 1e-12."""
    from lmc_atomi_torch.ops.tv import prox_tv_iso
    from lmc_atomi_torch.ops.tv_cuda import prox_tv_iso_ref
    from lmc_atomi_tpu.ops.tv import prox_tv_iso as j_prox

    y = c5_blur[0]
    got = prox_tv_iso(torch.from_numpy(y), 0.3, niter=10, backend=backend)
    assert torch.equal(got, prox_tv_iso_ref(torch.from_numpy(y), 0.3, niter=10))
    _close(got, j_prox(jnp.asarray(y), 0.3, niter=10, backend="xla"), 1e-12)


def test_prox_tv_iso_backend_pallas_needs_a_card():
    """``backend="pallas"`` forces kernel 1, which refuses a CPU tensor;
    an unknown backend raises."""
    from lmc_atomi_torch.ops.tv import prox_tv_iso

    x = torch.zeros((8, 8), dtype=torch.float32)
    with pytest.raises((RuntimeError, ValueError, TypeError)):
        prox_tv_iso(x, 0.3, backend="pallas")
    with pytest.raises(ValueError, match="backend"):
        prox_tv_iso(x, 0.3, backend="triton")


def test_wavelet_runners_take_interpret():
    """``run_myula_wavelet_fused`` and ``run_ulpda_wavelet_fused`` with
    ``interpret=True``, as ``experiments/inpainting.py`` of the JAX package
    passes it: 4 noise-off steps against the JAX runners (1e-12)."""
    from lmc_atomi_torch.kernels import wavelet_fused as t_wf
    from lmc_atomi_tpu.kernels import wavelet_fused as j_wf
    from lmc_atomi_tpu.ops import linops as j_lin

    rng = np.random.default_rng(0)
    img = np.cumsum(np.cumsum(rng.normal(size=(C5_N, C5_N)), 0), 1) / C5_N + 0.5
    mask = (rng.uniform(size=(C5_N, C5_N)) > 0.5).astype(np.float64)
    y = mask * img + 0.1 * mask * rng.normal(size=(C5_N, C5_N))
    jl2 = L2Data(op=j_lin.Mask(mask=jnp.asarray(mask)), b=jnp.asarray(y), sigma=100.0)
    tl2 = interop.mask_l2_from_numpy(mask, y, 100.0)
    kw = dict(block=2, noise_scale=0.0, burn_in=1, interpret=True)
    for name, args in (("myula", (5.0, 0.002, 0.01)), ("ulpda", (5.0, 0.0095, 1.0))):
        jrun = getattr(j_wf, f"run_{name}_wavelet_fused")
        trun = getattr(t_wf, f"run_{name}_wavelet_fused")
        want = jrun(jl2, *args, jnp.asarray(y), jax.random.PRNGKey(0), 4, **kw)
        got = trun(tl2, *args, torch.from_numpy(y), 0, 4, **kw)
        _close(got.final_state.position, want.final_state.position, 1e-12, name)
        _close(got.moments.mean, want.moments.mean, 1e-12, name)


def test_tiled_runners_take_interpret_and_stream_x(c5_blur):
    """``run_myula_tv_tiled`` and ``run_ulpda_tv_tiled`` with ``interpret``
    and ``stream_x``, as the JAX package's callers pass them: noise-off
    chains against the JAX tiled kernels (``tests/test_torch_tiled.py``'s
    gates, 1e-11 on the position and mean)."""
    from lmc_atomi_torch.kernels import myula_tiled as t_tiled
    from lmc_atomi_torch.kernels import ulpda_tiled as t_utiled
    from lmc_atomi_torch.ops.functionals import L21Norm as TL21
    from lmc_atomi_torch.ops.linops import Gradient2D as TGrad
    from lmc_atomi_tpu.kernels import myula_tiled as j_tiled
    from lmc_atomi_tpu.kernels import ulpda_tiled as j_utiled

    y, jl2, tl2 = c5_blur
    x0 = np.zeros((C5_N, C5_N))
    kw = dict(block=2, burn_in=1, noise_scale=0.0, interpret=True, stream_x=True, band=16,
              halo=8)
    want = j_tiled.run_myula_tv_tiled(jl2, 0.3, 0.1125, 0.5625, jnp.asarray(x0),
                                      jax.random.PRNGKey(1), 4, niter_tv=5, **kw)
    got = t_tiled.run_myula_tv_tiled(tl2, 0.3, 0.1125, 0.5625, torch.from_numpy(x0), 1, 4,
                                     niter_tv=5, **kw)
    _close(got.final_state.position, want.final_state.position, 1e-11, "myula x")
    _close(got.moments.mean, want.moments.mean, 1e-11, "myula mean")
    # kernel 7's halo at a 5x5 blur and 3 sweeps is 16: a 64^2 image
    y, jl2, tl2 = _blur_problem(2 * C5_N)
    x0 = np.zeros_like(y)
    kw = dict(kw, band=32, halo=16)
    want = j_utiled.run_ulpda_tv_tiled(jl2, L21Norm(sigma=0.3), Gradient2D(), 0.534375, 1.0,
                                       jnp.asarray(x0), jax.random.PRNGKey(1), 2,
                                       niter_solve=3, **kw)
    got = t_utiled.run_ulpda_tv_tiled(tl2, TL21(sigma=0.3), TGrad(), 0.534375, 1.0,
                                      torch.from_numpy(x0), 1, 2, niter_solve=3, **kw)
    _close(got.final_state.position, want.final_state.position, 1e-11, "ulpda x")
    _close(got.moments.mean, want.moments.mean, 1e-11, "ulpda mean")


@pytest.mark.parametrize("which", ["myula", "ulpda"])
def test_sep_fused_take_base_seed_and_interpret(c5_blur, which):
    """``myula_imaging_sep_fused`` and ``ulpda_sep_fused`` with
    ``base_seed`` and ``interpret``, as the JAX package's callers pass them:
    noise off, 3 steps of ``run_chain`` against the JAX kernels (1e-9, the
    file's gate); noise on, ``base_seed=b`` under the key ``(s, c)`` draws
    exactly the chain of ``base_seed=0`` under ``(s + b, c)`` (JAX adds it
    to the key's first word)."""
    from lmc_atomi_torch.kernels import myula_fused as t_mf
    from lmc_atomi_torch.kernels import ulpda_fused as t_uf
    from lmc_atomi_torch.ops.functionals import L21Norm as TL21
    from lmc_atomi_torch.ops.linops import Gradient2D as TGrad
    from lmc_atomi_tpu.kernels import myula_fused as j_mf
    from lmc_atomi_tpu.kernels import ulpda_fused as j_uf

    y, jl2, tl2 = c5_blur

    def kernels(noise_scale, base_seed):
        if which == "myula":
            args = (0.3, 0.1125, 0.5625)
            return (j_mf.myula_imaging_sep_fused(jl2, *args, niter_tv=5, base_seed=base_seed,
                                                 noise_scale=noise_scale, interpret=True),
                    t_mf.myula_imaging_sep_fused(tl2, *args, niter_tv=5, base_seed=base_seed,
                                                 noise_scale=noise_scale, interpret=True))
        return (j_uf.ulpda_sep_fused(jl2, L21Norm(sigma=0.3), Gradient2D(), 0.534375, 1.0,
                                     base_seed=base_seed, noise_scale=noise_scale,
                                     interpret=True),
                t_uf.ulpda_sep_fused(tl2, TL21(sigma=0.3), TGrad(), 0.534375, 1.0,
                                     base_seed=base_seed, noise_scale=noise_scale,
                                     interpret=True))

    jk, tk = kernels(0.0, 7)
    want = j_run_chain(jk, jnp.asarray(y), jax.random.PRNGKey(0), 3, collect="samples")
    got = t_run_chain(tk, torch.from_numpy(y), 0, 3, collect="samples")
    _close(got.samples, want.samples, name=which)
    shifted = t_run_chain(kernels(1.0, 7)[1], torch.from_numpy(y), (4, 2), 3,
                          collect="samples")
    plain = t_run_chain(kernels(1.0, 0)[1], torch.from_numpy(y), (11, 2), 3,
                        collect="samples")
    other = t_run_chain(kernels(1.0, 0)[1], torch.from_numpy(y), (4, 2), 3,
                        collect="samples")
    assert torch.equal(shifted.samples, plain.samples)
    assert not torch.equal(shifted.samples, other.samples)
