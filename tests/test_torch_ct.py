"""Port parity for the sparse-view CT workload (``experiments/ct.py``), on
the CPU in f64, each part fed the JAX package's sinogram and operator: the
power-method bound from one probe, the TV MAP (adaptive PDHG on the dense
projector, FISTA with a 20-trip Chambolle prox on the shear projector), and
the TV-MYULA chain with the noise off and with the port's noise injected
into the JAX kernel; then the port's CLI end to end on its two tiny
configurations of ``tests/test_experiments.py`` (every branch), its figure,
and its device guard."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.core.random import fold_in, normal_field
from lmc_atomi_torch.experiments import ct as t_ct
from lmc_atomi_torch.kernels import imaging as t_img
from lmc_atomi_torch.ops import functionals as t_fn
from lmc_atomi_torch.ops import linops as t_lin
from lmc_atomi_torch.ops import radon as t_radon
from lmc_atomi_torch.ops.tv import prox_tv_iso as t_prox_tv_iso
from lmc_atomi_torch.run import optimize as t_opt
from lmc_atomi_torch.run import runner as t_run
from lmc_atomi_torch.utils.cli import auto_cli
from lmc_atomi_tpu.kernels import imaging as j_img
from lmc_atomi_tpu.ops import functionals as j_fn
from lmc_atomi_tpu.ops import linops as j_lin
from lmc_atomi_tpu.ops.radon import Radon2D as JRadon2D
from lmc_atomi_tpu.ops.radon import fbp as j_fbp
from lmc_atomi_tpu.ops.tv import prox_tv_iso as j_prox_tv_iso
from lmc_atomi_tpu.run import optimize as j_opt
from lmc_atomi_tpu.run import runner as j_run
from lmc_atomi_tpu.utils.images import phantom

torch.set_num_threads(2)

N, ANGLES, SIGMA, TAU_TV = 32, 12, 2.0, 5.0
# f64 on both sides; adaptive PDHG's step-size decisions compare residual
# norms far from their thresholds, so the iterates agree to roundoff growth
TOL = 1e-8
# the JSON line's keys of lmc_atomi_tpu/experiments/ct.py
REPORT_KEYS = {"psnr_backprojection", "psnr_fbp", "psnr_map_tv", "psnr_posterior_mean",
               "iters_per_sec", "psnr_trace", "psnr_pnp_mean"}


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)


def _problem(mode):
    """The CT posterior at 32^2/12 in both packages: the JAX operator and
    data term, the port's from them, the step sizes from one probe, and the
    start (the clipped Hann FBP of the JAX package)."""
    jop = JRadon2D.create((N, N), n_angles=ANGLES, dtype=jnp.float64, mode=mode)
    top = interop.radon_from_numpy(
        np.asarray(jop.thetas), jop.shape, jop.mode,
        None if jop.dense is None else np.asarray(jop.dense),
        None if jop.shear_phis is None else np.asarray(jop.shear_phis), jop.shear_ks)
    img = phantom(N, np.float64) / 255.0
    sino = np.asarray(jop.matvec(jnp.asarray(img))) \
        + SIGMA * np.random.default_rng(0).normal(size=(ANGLES, N))
    jl2 = j_fn.L2Data(op=jop, b=jnp.asarray(sino), sigma=1.0 / SIGMA**2)
    tl2 = t_fn.L2Data(op=top, b=torch.from_numpy(sino), sigma=1.0 / SIGMA**2)
    probe = np.random.default_rng(1).normal(size=(N, N))
    jl = float(j_lin.LinOp.max_gram_eig(jop, probe=jnp.asarray(probe), iters=20))
    tl = float(t_lin.LinOp.max_gram_eig(top, probe=torch.from_numpy(probe), iters=20))
    np.testing.assert_allclose(tl, jl, rtol=1e-10)
    x0 = np.array(jnp.clip(j_fbp(jop, jnp.asarray(sino), filter_name="hann"), 0.0, None))
    _close(torch.clamp(t_radon.fbp(top, torch.from_numpy(sino), filter_name="hann"), min=0.0),
           x0, 1e-12, "fbp start")
    return img, jl2, tl2, jl / SIGMA**2, x0


def test_map_pdhg_dense_against_jax():
    img, jl2, tl2, lips, x0 = _problem("dense")
    want = j_opt.adaptive_pdhg_segmented(jl2, j_fn.L21Norm(sigma=TAU_TV), j_lin.Gradient2D(),
                                         jnp.asarray(x0), 0.95 / lips, 1.0, 15,
                                         segment_steps=6)
    got = t_opt.adaptive_pdhg_segmented(tl2, t_fn.L21Norm(sigma=TAU_TV), t_lin.Gradient2D(),
                                        torch.from_numpy(x0), 0.95 / lips, 1.0, 15,
                                        segment_steps=6)
    _close(got.x, want.x, name="x")
    _close(got.y, want.y, name="y")


def test_map_fista_shear_against_jax():
    img, jl2, tl2, lips, x0 = _problem("shear")
    want = j_opt.fista_segmented(
        jl2.grad, lambda x, t: j_prox_tv_iso(x, t * TAU_TV, niter=20), jnp.asarray(x0),
        1.0 / lips, 10, segment_steps=4)
    got = t_opt.fista_segmented(
        tl2.grad, lambda x, t: t_prox_tv_iso(x, t * TAU_TV, niter=20), torch.from_numpy(x0),
        1.0 / lips, 10, segment_steps=4)
    _close(got.x, want.x)


@pytest.mark.parametrize("noise", ["off", "injected"])
def test_tv_chain_against_jax(monkeypatch, noise):
    """MYULA over the Radon data term with kernel 1's prox (its plain
    version here) at the CLI's step sizes: with the noise off, the segmented
    runners' moments and PSNR traces; with the port's noise fed to the JAX
    kernel, 12 steps and their mean after a burn-in of 4."""
    img, jl2, tl2, lips, x0 = _problem("dense")
    gamma = 1.0 / lips
    jk = j_img.myula_imaging(jl2, j_fn.TVNorm(sigma=TAU_TV, niter=10), tau=0.2 * gamma,
                             gamma=gamma)
    tk = t_img.myula_imaging(tl2, t_fn.TVNorm(sigma=TAU_TV, niter=10), tau=0.2 * gamma,
                             gamma=gamma)
    key = fold_in(0, 2)
    if noise == "off":
        monkeypatch.setattr(j_img, "normal_like", lambda k, x: jnp.zeros_like(x))
        monkeypatch.setattr(t_img, "normal_field",
                            lambda *a, **k: torch.zeros(a[3], dtype=a[4]))
        traces = {"jax": [], "torch": []}

        def progress(pkg, img_):
            def fn(done, moments):
                m = np.asarray(moments.mean) if pkg == "jax" else _np(moments.mean)
                traces[pkg].append((done, float(np.sum((m - img_) ** 2))))
            return fn

        want = j_run.run_chain_segmented(jk, jnp.asarray(x0), jax.random.PRNGKey(0), 30,
                                         burn_in=10, segment_steps=10,
                                         progress=progress("jax", img))
        got = t_run.run_chain_segmented(tk, torch.from_numpy(x0), key, 30, burn_in=10,
                                        segment_steps=10, progress=progress("torch", img))
        _close(got.moments.mean, want.moments.mean, name="mean")
        _close(got.moments.std, want.moments.std, name="std")
        assert [d for d, _ in traces["torch"]] == [10, 20, 30]
        np.testing.assert_allclose([v for _, v in traces["torch"]],
                                   [v for _, v in traces["jax"]], rtol=TOL)
        return
    steps, burn = 12, 4
    draws = iter([jnp.asarray(_np(normal_field(*key, i, (N, N), torch.float64, "cpu")))
                  for i in range(steps)])
    monkeypatch.setattr(j_img, "normal_like", lambda k, x: next(draws))
    js = jk.init(jnp.asarray(x0))
    kept = []
    for i in range(steps):
        js, _ = jk.step(js, jax.random.PRNGKey(i))
        if i >= burn:
            kept.append(np.asarray(js.position))
    got = t_run.run_chain_segmented(tk, torch.from_numpy(x0), key, steps, burn_in=burn,
                                    segment_steps=5)
    _close(got.final_state.position, js.position, name="position")
    _close(got.moments.mean, np.mean(kept, axis=0), name="mean")


def test_ct_cli_all_branches(tmp_path, capsys):
    """``tests/test_experiments.py``'s first tiny configuration (TV chain, TV
    MAP by PDHG on the dense projector, PnP with a 5-step DnCNN fit), with
    credible bands, the branch images and the figure under the JAX
    package's file name; every report key finite."""
    arrays = {}
    mean, std, report = t_ct.ct_tv_myula(
        size=32, n_angles=12, n_steps=40, burn_in=10, niter_map=15, pnp_train_steps=5,
        ci_quantiles=(0.025, 0.975), arrays_out=arrays, make_plots=True,
        outdir=str(tmp_path), device="cpu")
    assert mean.shape == std.shape == (32, 32) and np.isfinite(mean).all()
    assert set(report) == REPORT_KEYS | {"mean_ci_width"}
    for k, v in report.items():
        assert np.all(np.isfinite(v)), k
    assert report["psnr_trace"][-1][0] == 40
    assert set(arrays) == {"img", "sino", "backprojection", "fbp", "mean", "std", "map",
                           "pnp_mean"}
    assert arrays["sino"].shape == (12, 32)
    assert (tmp_path / "fig_ct_32_12ang_40.pdf").stat().st_size > 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["workload"] == "ct_tv_myula" and line["n_angles"] == 12


def test_ct_cli_score_branch(capsys):
    """The second tiny configuration (annealed score-ULA, no MAP, no PnP),
    through the command line, with one corrector sweep a step."""
    auto_cli(t_ct.ct_tv_myula, ["--size", "32", "--n_angles", "12", "--n_steps", "40",
                                "--burn_in", "16", "--compute_map", "false", "--pnp", "false",
                                "--score_prior", "true", "--score_train_steps", "5",
                                "--pc_correctors", "1", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(report["psnr_score_mean"])
    assert "psnr_map_tv" not in report and "psnr_pnp_mean" not in report


def test_ct_device_guard(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_ct.ct_tv_myula(size=16)
