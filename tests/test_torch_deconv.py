"""Port parity for the MAP optimizers and the deconvolution workload, on the
CPU: ``pdhg``, ``adaptive_pdhg`` (straight and segmented) and ``fista``
against the JAX package in f64, the nine MAP estimates of the workload
against the JAX ``adaptive_pdhg`` on one observation, and the port's
``prox_lmc_deconv`` end to end at 32^2 (``device="cpu"``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.experiments import deconv as t_deconv
from lmc_atomi_torch.ops import functionals as t_fn
from lmc_atomi_torch.ops import linops as t_linops
from lmc_atomi_torch.run import optimize as t_opt
from lmc_atomi_torch.utils import images as t_images
from lmc_atomi_torch.utils.cli import auto_cli
from lmc_atomi_tpu.ops.functionals import L1Norm, L21Norm, L2Data, TVNorm
from lmc_atomi_tpu.ops.linops import CirculantBlur2D, Gradient2D, uniform_kernel
from lmc_atomi_tpu.ops.ncvx_tv import L2NcvxTV
from lmc_atomi_tpu.run import optimize as j_opt
from lmc_atomi_tpu.utils.images import einstein, phantom

torch.set_num_threads(2)

SIG = 0.75
SIGMA = 1 / SIG**2
TAU0 = 0.95 / SIGMA
# f64 on both sides; the step-size decisions of adaptive PDHG compare
# residual norms far from their thresholds, so the iterates agree to
# roundoff growth over the run
TOL = 1e-8
NCVX_TOL = 1e-3  # MC-TV after 150 iterations, see test_nine_map_estimates_match_jax
METRIC_KEYS = {"cost", "err", "snr", "psnr", "mse"}
# the summary keys of lmc_atomi_tpu/experiments/deconv.py:336-344
SUMMARY_KEYS = {"workload", "branch", "size", "steps", "psnr_blurred", "report",
                "iters_per_sec"}


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=name)


def _observation(n, seed=0):
    img = phantom(n, np.float64)
    jb = CirculantBlur2D.from_kernel((n, n), uniform_kernel(5, jnp.float64))
    y = np.asarray(jb.matvec(jnp.asarray(img))) \
        + SIG * np.random.default_rng(seed).normal(size=(n, n))
    return img, y


@pytest.fixture(scope="module")
def tv_problem():
    """The k5 TV model at 24^2 in both packages."""
    n = 24
    img, y = _observation(n)
    jb = CirculantBlur2D.from_kernel((n, n), uniform_kernel(5, jnp.float64))
    tb = interop.blur_from_numpy(np.asarray(jb.eigs_re), np.asarray(jb.eigs_im),
                                 np.asarray(jb.h), np.asarray(jb.hh), jb.offset)
    jl2 = L2Data.create(op=jb, b=jnp.asarray(y), sigma=SIGMA)
    tl2 = interop.l2data_from_numpy(y, SIGMA, tb)
    return img, y, jl2, tl2


def _metrics(img, xp):
    return {"err": lambda x: xp.sum((x - img) ** 2) ** 0.5,
            "mean": lambda x: xp.mean(x)}


@pytest.mark.parametrize("solver", ["pdhg", "adaptive_pdhg"])
def test_pdhg_matches_jax(tv_problem, solver):
    img, y, jl2, tl2 = tv_problem
    kw = dict(tau=TAU0, mu=1.0, niter=40)
    want = getattr(j_opt, solver)(jl2, L21Norm(sigma=0.3), Gradient2D(),
                                  jnp.zeros_like(jnp.asarray(y)),
                                  metrics=_metrics(jnp.asarray(img), jnp), **kw)
    got = getattr(t_opt, solver)(tl2, t_fn.L21Norm(sigma=0.3),
                                 interop.gradient_from_numpy(),
                                 torch.zeros((24, 24), dtype=torch.float64),
                                 metrics=_metrics(torch.from_numpy(img), torch), **kw)
    _close(got.x, want.x, name="x")
    _close(got.y, want.y, name="y")
    for k in ("err", "mean"):
        _close(got.metrics[k], want.metrics[k], name=k)
        assert got.metrics[k].shape == (40,)
    if solver == "adaptive_pdhg":
        for g, w in zip(got.state[2:], want.state[2:]):  # tau_k, mu_k, alpha
            assert abs(float(g) - float(w)) < 1e-12 * abs(float(w))


def test_fista_matches_jax(tv_problem):
    img, y, jl2, tl2 = tv_problem
    jtv, ttv = TVNorm(sigma=0.3, niter=5), t_fn.TVNorm(sigma=0.3, niter=5)
    step = 0.9 / SIGMA
    want = j_opt.fista(jl2.grad, jtv.prox, jnp.asarray(y), step, 25,
                       metrics=_metrics(jnp.asarray(img), jnp))
    got = t_opt.fista(tl2.grad, ttv.prox, torch.from_numpy(y), step, 25,
                      metrics=_metrics(torch.from_numpy(img), torch))
    _close(got.x, want.x, name="x")
    _close(got.metrics["err"], want.metrics["err"], name="err")
    _close(got.state[2], want.state[2], tol=1e-14, name="t")


def test_segmented_runs_equal_straight_runs(tv_problem):
    """A run cut into segments continues the carry exactly: the same
    iterates, step sizes and metric rows as one straight run."""
    img, y, _, tl2 = tv_problem
    g, op = t_fn.L21Norm(sigma=0.3), interop.gradient_from_numpy()
    x0 = torch.zeros((24, 24), dtype=torch.float64)
    m = _metrics(torch.from_numpy(img), torch)
    straight = t_opt.adaptive_pdhg(tl2, g, op, x0, TAU0, 1.0, 20, metrics=m)
    seg = t_opt.adaptive_pdhg_segmented(tl2, g, op, x0, TAU0, 1.0, 20,
                                        segment_steps=7, metrics=m)
    torch.testing.assert_close(seg.x, straight.x, rtol=0, atol=0)
    torch.testing.assert_close(seg.metrics["err"], straight.metrics["err"],
                               rtol=0, atol=0)
    for a, b in zip(seg.state, straight.state):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    tv = t_fn.TVNorm(sigma=0.3, niter=5)
    f1 = t_opt.fista(tl2.grad, tv.prox, torch.from_numpy(y), 0.5, 12, metrics=m)
    f2 = t_opt.fista_segmented(tl2.grad, tv.prox, torch.from_numpy(y), 0.5, 12,
                               segment_steps=5, metrics=m)
    torch.testing.assert_close(f2.x, f1.x, rtol=0, atol=0)
    assert f2.metrics["err"].shape == (12,)


def _jax_models(y, n, niter_tv):
    """The nine models of lmc_atomi_tpu/experiments/deconv.py:99-126."""
    grad_op = Gradient2D()
    out = []
    for k in (5, 6, 7):
        # the spectrum alone: without the PSF arrays the three blurs share one
        # pytree shape, so each model type compiles once
        blur = CirculantBlur2D.from_kernel(
            (n, n), uniform_kernel(k, jnp.float64)).replace(h=None, hh=None)
        common = dict(op=blur, b=jnp.asarray(y), sigma=SIGMA, lamda=0.3,
                      isotropic=True, niter_inner=niter_tv, niter_solve=50)
        out += [
            (L2Data.create(op=blur, b=jnp.asarray(y), sigma=SIGMA), L21Norm(sigma=0.3)),
            (L2NcvxTV(op2=grad_op, gamma=15.0, **common), L1Norm(sigma=0.3)),
            (L2NcvxTV(op2=None, gamma=15.0, **common), L21Norm(sigma=0.3)),
        ]
    return out


def test_nine_map_estimates_match_jax():
    """The workload's nine models built by ``deconv_models`` (the port's own
    blurs) against the JAX ``adaptive_pdhg`` on the same observation: 32^2,
    150 iterations, f64. Every step-size decision agrees. The convex TV and
    ME-TV estimates agree to ``TOL``. The MC-TV iteration amplifies roundoff
    (its clamped gradient is nonconvex): the distance between the two
    packages' iterates grows about tenfold every 10 iterations past the 40th
    (measured 1e-11 at 20, 1e-9 at 50 and up to 4e-4 relative at 150 over
    three observations), so MC-TV is held to ``TOL`` for its first 40
    iterates and to ``NCVX_TOL`` at the end."""
    n, niter_tv, iters = 32, 10, 150
    _, y = _observation(n, seed=1)
    blurs = {k: t_linops.CirculantBlur2D.from_kernel(
        (n, n), t_linops.uniform_kernel(k, torch.float64)) for k in (5, 6, 7)}
    models = t_deconv.deconv_models(torch.from_numpy(y), blurs, SIG, 0.3, 15.0,
                                    15.0, 50, niter_tv)
    assert [m[0] for m in models] == [f"k{k}-{p}" for k in (5, 6, 7)
                                      for p in ("TV", "MCTV", "METV")]
    x0 = jnp.zeros((n, n))
    run = jax.jit(lambda pf, pg: j_opt.adaptive_pdhg(
        pf, pg, Gradient2D(), x0, TAU0, 1.0, iters,
        metrics={"dist": lambda x: jnp.sqrt(jnp.sum((x - y) ** 2))}))
    t_metrics = {"dist": lambda x: torch.sqrt(torch.sum((x - torch.from_numpy(y)) ** 2))}
    for (name, tf, tg, top), (jf, jg) in zip(models, _jax_models(y, n, niter_tv)):
        want = run(jf, jg)
        got = t_opt.adaptive_pdhg(tf, tg, top, torch.zeros((n, n), dtype=torch.float64),
                                  TAU0, 1.0, iters, metrics=t_metrics)
        for g, w in zip(got.state[2:], want.state[2:]):  # tau_k, mu_k, alpha
            assert float(g) == pytest.approx(float(w), rel=1e-13), name
        if "MCTV" in name:
            _close(got.metrics["dist"][:40], want.metrics["dist"][:40], name=name)
            _close(got.x, want.x, tol=NCVX_TOL, name=name)
        else:
            _close(got.metrics["dist"], want.metrics["dist"], name=name)
            _close(got.x, want.x, name=name)


@pytest.mark.parametrize("branch", ["ULPDA", "MYULA", "MAP"])
def test_deconv_workload_on_cpu(branch, capsys):
    results, series, summary = t_deconv.prox_lmc_deconv(
        size=32, n_steps=30, niter_map=30, niter_tv=5,
        alg="MYULA" if branch == "MYULA" else "ULPDA",
        compute_map=branch == "MAP", device="cpu")
    assert len(results) == 9
    for est in results.values():
        assert est.shape == (32, 32) and np.isfinite(est).all()
    assert len(series) == 9
    for met in series.values():
        assert set(met) == METRIC_KEYS
        assert met["psnr"].shape == (30,) and np.isfinite(met["cost"]).all()
    assert set(summary) == SUMMARY_KEYS
    assert summary["branch"] == branch and summary["steps"] == 30
    assert set(summary["report"]) == set(results)
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == summary
    assert out.err.count(f"SNR of {branch} image with M") == 9


def test_deconv_cli_and_device_guard(capsys, monkeypatch):
    auto_cli(t_deconv.prox_lmc_deconv,
             ["--size", "16", "--n_steps", "3", "--niter_tv", "2",
              "--alg", "MYULA", "--device", "cpu", "--collect_metrics", "false"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["size"] == 16 and summary["branch"] == "MYULA"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_deconv.prox_lmc_deconv(size=16, n_steps=2)


@pytest.mark.parametrize("flag", ["make_plots", "show"])
def test_deconv_parts_not_ported_raise(flag, tmp_path, capsys):
    """``make_plots`` writes the JAX package's two figures under ``outdir``;
    ``show`` prints the reference's iteration table (f, g(Ax), J) of every
    model, every row of a 2-step run."""
    t_deconv.prox_lmc_deconv(size=16, n_steps=2, device="cpu", outdir=str(tmp_path),
                             **{flag: True})
    out = capsys.readouterr().out
    if flag == "make_plots":
        stem = tmp_path / "fig_prox_lmc_deconv_phantom_ULPDA_2"
        for suffix in ("_images.pdf", "_snr_psnr_mse.pdf"):
            assert (tmp_path / f"{stem.name}{suffix}").stat().st_size > 0
    else:
        assert out.count("   Itn ") == 9 and "-- M9 (k7-METV) --" in out
        header = out.splitlines()[1].split()
        assert header == ["Itn", "f", "g(Ax)", "J"]
        assert len(out.splitlines()) == 9 * 4 + 1  # label, header, 2 rows; the JSON line


def test_load_image():
    np.testing.assert_array_equal(t_images.load_image("phantom", 40), phantom(40))
    # the photographs are ported (utils/png.py): tests/test_torch_png_images.py
    np.testing.assert_array_equal(t_images.load_image("einstein", 64), einstein(64))
    with pytest.raises(ValueError, match="unknown"):
        t_images.load_image("lena", 64)
