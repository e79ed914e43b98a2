"""Port parity for the inpainting slice on the CPU: the fused wavelet chains
against the port's unfused samplers on one Philox stream (f64, noise on), a
JAX wavelet-dual ULPDA chain continued in the port, MALA's log ratio against
the JAX formula, and the inpainting, denoising and deconvolution (wavelet
row) entry points."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.core.random import normal_field, uniform_scalar
from lmc_atomi_torch.eval.metrics import acceptance_rate, effective_sample_mask
from lmc_atomi_torch.experiments import deconv as t_deconv
from lmc_atomi_torch.experiments import denoise as t_denoise
from lmc_atomi_torch.experiments import inpainting as t_inp
from lmc_atomi_torch.kernels import imaging as t_imaging
from lmc_atomi_torch.kernels import wavelet_fused as t_wf
from lmc_atomi_torch.kernels.langevin import mala, ula
from lmc_atomi_torch.ops import functionals as t_fn
from lmc_atomi_torch.ops.wavelet import make_dwt
from lmc_atomi_torch.run.runner import run_chain
from lmc_atomi_torch.utils.cli import auto_cli
from lmc_atomi_tpu.kernels import wavelet_fused as j_wf
from lmc_atomi_tpu.ops import functionals as j_fn
from lmc_atomi_tpu.ops import linops as j_lin
from lmc_atomi_tpu.ops import wavelet as j_wav

torch.set_num_threads(2)

N = 32
SIG = 0.1
TAU_W = 5.0
# f64; fused and unfused differ by roundoff only (mask-gradient association,
# interleaved against Mallat transforms, a multiply by 1/sqrt2 against a
# division), ~1e-15 relative a step
TOL = 1e-10
SUMMARY_KEYS = {"workload", "size", "wavelet", "image", "steps", "report",
                "iters_per_sec", "mala_acceptance"}


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(_np(want))
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               err_msg=name)


@pytest.fixture(scope="module")
def problem():
    """A 32^2 masked, noisy observation of a smooth random image (f64)."""
    rng = np.random.default_rng(0)
    img = np.cumsum(np.cumsum(rng.normal(size=(N, N)), 0), 1) / N + 0.5
    mask = (rng.uniform(size=(N, N)) > 0.5).astype(np.float64)
    y = mask * img + SIG * mask * rng.normal(size=(N, N))
    return mask, y


def _l2(problem):
    mask, y = problem
    return interop.mask_l2_from_numpy(mask, y, 1.0 / SIG**2)


@pytest.mark.parametrize("wavelet", ["haar", "d4"])
def test_fused_myula_equals_unfused(problem, wavelet):
    """``run_myula_wavelet_fused`` (blocks of 4) against
    ``run_chain(myula_imaging(L2Data(Mask), OrthogonalL1))``, same seed and
    chain, noise on: final state and burn-in-masked moments."""
    l2 = _l2(problem)
    gamma = SIG**2
    tau = 0.2 * gamma
    x0 = l2.b
    wav = t_fn.OrthogonalL1(op=make_dwt(wavelet, 3), sigma=TAU_W)
    unf = run_chain(t_imaging.myula_imaging(l2, wav, tau, gamma), x0, (5, 2), 12,
                    collect="stats", burn_in=3)
    fus = t_wf.run_myula_wavelet_fused(l2, TAU_W, tau, gamma, x0, (5, 2), 12,
                                       taps=2 if wavelet == "haar" else 4,
                                       block=4, burn_in=3)
    _close(fus.final_state.position, unf.final_state.position, name="x")
    assert fus.moments.count == unf.moments.count == 9
    _close(fus.moments.mean, unf.moments.mean, name="mean")
    _close(fus.moments.m2, unf.moments.m2, name="m2")


@pytest.mark.parametrize("wavelet,gfirst", [("haar", False), ("haar", True),
                                            ("d4", False)])
def test_fused_ulpda_equals_unfused(problem, wavelet, gfirst):
    """``run_ulpda_wavelet_fused`` against ``run_chain(ulpda(L2Data(Mask),
    L1Norm, W))``, noise on: x, xbar, the moments, and the duals compared
    through ``W^T`` (the fused dual is interleaved, the unfused Mallat)."""
    l2 = _l2(problem)
    taps = 2 if wavelet == "haar" else 4
    w = make_dwt(wavelet, 3)
    tau, mu = 0.95 * SIG**2, 1.0
    x0 = l2.b
    unf = run_chain(t_imaging.ulpda(l2, t_fn.L1Norm(sigma=TAU_W), w, tau, mu,
                                    gfirst=gfirst), x0, (5, 2), 12,
                    collect="stats", burn_in=3)
    fus = t_wf.run_ulpda_wavelet_fused(l2, TAU_W, tau, mu, x0, (5, 2), 12,
                                       gfirst=gfirst, taps=taps, block=4,
                                       burn_in=3)
    fs, us = fus.final_state, unf.final_state
    _close(fs.position, us.position, name="x")
    _close(fs.extras.xbar, us.extras.xbar, name="xbar")
    _close(t_wf.dwt_interleaved_inv(fs.extras.y, taps, 3), w.rmatvec(us.extras.y),
           name="W^T y")
    assert fus.moments.count == unf.moments.count == 9
    _close(fus.moments.mean, unf.moments.mean, name="mean")
    _close(fus.moments.m2, unf.moments.m2, name="m2")


def test_jax_wavelet_ulpda_continues_in_port(problem):
    """3 fused wavelet-dual ULPDA steps in JAX (interpret mode), carried
    across with ``ulpda_state_from_numpy``, then 3 more in the port:
    equal to the JAX package's 6-step run, merged moments included (noise
    off)."""
    mask, y = problem
    jl2 = j_fn.L2Data(op=j_lin.Mask(mask=jnp.asarray(mask)), b=jnp.asarray(y),
                      sigma=1.0 / SIG**2)
    tau, mu = 0.95 * SIG**2, 1.0
    kw = dict(block=3, noise_scale=0.0, burn_in=1)
    args = (jl2, TAU_W, tau, mu, jnp.asarray(y), jax.random.PRNGKey(0))
    first = j_wf.run_ulpda_wavelet_fused(*args, 3, interpret=True, **kw)
    whole = j_wf.run_ulpda_wavelet_fused(*args, 6, interpret=True, **kw)
    st = first.final_state
    carried = interop.ulpda_state_from_numpy(
        np.asarray(st.position), np.asarray(st.extras.y), np.asarray(st.extras.xbar),
        np.asarray(first.moments.mean), np.asarray(first.moments.m2),
        int(first.moments.count))
    cs = carried.final_state
    got = t_wf.run_ulpda_wavelet_fused(_l2(problem), TAU_W, tau, mu, cs.position, 0,
                                       3, y0=cs.extras.y, xbar0=cs.extras.xbar,
                                       step_offset=3, **kw)
    for name, g, w in (("x", got.final_state.position, whole.final_state.position),
                       ("c", got.final_state.extras.y, whole.final_state.extras.y),
                       ("xbar", got.final_state.extras.xbar,
                        whole.final_state.extras.xbar)):
        _close(g, w, tol=1e-12, name=name)
    merged = carried.moments.merge(got.moments)
    assert merged.count == int(whole.moments.count) == 5
    _close(merged.mean, whole.moments.mean, tol=1e-12, name="mean")
    _close(merged.m2, whole.moments.m2, tol=1e-12, name="m2")


def _smoothed_target(problem):
    """The inpainting workload's Moreau-smoothed posterior, in both
    packages."""
    mask, y = problem
    l2 = _l2(problem)
    wav = t_fn.OrthogonalL1(op=make_dwt("haar", 3), sigma=TAU_W)
    jl2 = j_fn.L2Data(op=j_lin.Mask(mask=jnp.asarray(mask)), b=jnp.asarray(y),
                      sigma=1.0 / SIG**2)
    jwav = j_fn.OrthogonalL1(op=j_wav.HaarDWT2D(levels=3), sigma=TAU_W)
    lam = 0.05

    def t_logp(x):
        return -(l2(x) + wav.moreau_value(x, lam))

    def t_grad(x):
        return l2.grad(x) + wav.moreau_grad(x, lam)

    def j_logp(x):
        return -(jl2(x) + jwav.moreau_value(x, lam))

    def j_grad(x):
        return jl2.grad(x) + jwav.moreau_grad(x, lam)

    return t_logp, t_grad, j_logp, j_grad


def test_mala_log_ratio_matches_jax(problem):
    """Each MALA step: the proposal from ``normal_field`` of the step key,
    ``min(log ratio, 0)`` against the JAX formula (``kernels/langevin.py``)
    on the same proposal, the accept decision against ``uniform_scalar`` of
    the key, and the stay-at-state chain; ``acceptance_rate`` and
    ``effective_sample_mask`` over the steps."""
    t_logp, t_grad, j_logp, j_grad = _smoothed_target(problem)
    g = 4e-4
    kern = mala(t_logp, t_grad, g)
    state = kern.init(torch.from_numpy(problem[1]))
    infos = []
    for step in range(12):
        key = (3, 1, step)
        x = state.position
        prop = x - g * t_grad(x) + np.sqrt(2 * g) * normal_field(*key, x.shape, x.dtype, "cpu")
        jx, jp = jnp.asarray(_np(x)), jnp.asarray(_np(prop))

        def log_q(to, frm):
            dev = to - (frm - g * j_grad(frm))
            return -jnp.sum(dev * dev) / (4.0 * g)

        want = j_logp(jp) - j_logp(jx) + log_q(jx, jp) - log_q(jp, jx)
        state, info = kern.step(state, key)
        infos.append(info)
        _close(info.log_accept_ratio, min(float(want), 0.0), tol=1e-9, name="log ratio")
        u = float(uniform_scalar(*key, torch.float64, "cpu"))
        assert bool(info.accepted) == (np.log(u) <= min(float(want), 0.0))
        _close(state.position, prop if bool(info.accepted) else x, tol=0.0)
    acc = effective_sample_mask(infos)
    assert acc.shape == (12,) and acc.dtype == torch.bool
    assert 0 < int(acc.sum()) < 12  # both branches taken
    assert float(acceptance_rate(infos)) == pytest.approx(float(acc.float().mean()))


def test_ula_step(problem):
    """``ula``: one step is ``x - g grad + sqrt(2 g) xi`` with the key's
    normal field."""
    _, t_grad, _, _ = _smoothed_target(problem)
    x0 = torch.from_numpy(problem[1])
    st, info = ula(t_grad, 1e-4).step(ula(t_grad, 1e-4).init(x0), (0, 0, 7))
    want = x0 - 1e-4 * t_grad(x0) + np.sqrt(2e-4) * normal_field(0, 0, 7, x0.shape,
                                                                  x0.dtype, "cpu")
    _close(st.position, want, tol=0.0)
    assert st.step == 1 and info.accepted is None


def test_wavelet_inpainting_small(capsys):
    """The workload at 32^2 on the CPU with the fused rows: every posterior
    mean beats the masked observation, MALA accepts, the fused rows equal
    their unfused counterparts up to f32 roundoff, and the summary has the
    JAX package's keys."""
    results, summary = t_inp.wavelet_inpainting(size=32, n_steps=300, burn_in=60,
                                                fused=True, device="cpu")
    assert set(results) == {"MYULA", "MALA", "ULPDA-wavelet", "MYULA-fused",
                            "ULPDA-wavelet-fused"}
    rep = summary["report"]
    for name in results:
        assert results[name].shape == (32, 32) and np.isfinite(results[name]).all()
        assert rep[name]["psnr"] > rep["observed"]["psnr"], name
    assert 0.0 < summary["mala_acceptance"] <= 1.0
    assert abs(rep["MYULA-fused"]["psnr"] - rep["MYULA"]["psnr"]) < 1e-3
    assert abs(rep["ULPDA-wavelet-fused"]["psnr"] - rep["ULPDA-wavelet"]["psnr"]) < 1e-3
    assert set(summary) == SUMMARY_KEYS
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary


def test_inpainting_and_denoise_cli_and_device_rule(capsys, monkeypatch, tmp_path):
    """The CLIs on the CPU (``--device cpu``), D8 fused; without a card
    their default device raises; ``make_plots`` writes the JAX package's
    figure."""
    auto_cli(t_inp.wavelet_inpainting,
             ["--size", "16", "--n_steps", "8", "--burn_in", "2", "--wavelet", "d8",
              "--levels", "1", "--fused", "true", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["wavelet"] == "d8" and "ULPDA-wavelet-fused" in summary["report"]
    auto_cli(t_denoise.l1_denoise_myula,
             ["--size", "16", "--n_steps", "20", "--burn_in", "5", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"workload", "size", "psnr_noisy", "psnr_posterior_mean",
                        "iters_per_sec"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_inp.wavelet_inpainting(size=16, n_steps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_denoise.l1_denoise_myula(size=16, n_steps=2)
    t_inp.wavelet_inpainting(size=16, n_steps=2, device="cpu", make_plots=True,
                             outdir=str(tmp_path))
    t_denoise.l1_denoise_myula(size=16, n_steps=2, device="cpu", make_plots=True,
                               outdir=str(tmp_path))
    for name in ("fig_inpainting_16_2.pdf", "fig_l1_denoise_16_2.pdf"):
        assert (tmp_path / name).stat().st_size > 0


def test_denoise_result_and_median():
    """``l1_denoise_myula`` beats the noisy image and returns the JAX
    package's keys; ``median`` averages the two middle values of an even
    count, as ``jnp.median`` does."""
    mean, report = t_denoise.l1_denoise_myula(size=32, n_steps=200, burn_in=40,
                                              device="cpu")
    assert mean.shape == (32, 32) and np.isfinite(mean).all()
    assert report["psnr_posterior_mean"] > report["psnr_noisy"]
    assert set(report) == {"psnr_noisy", "psnr_posterior_mean", "iters_per_sec"}
    rng = np.random.default_rng(1)
    for n in (16, 15):
        v = rng.normal(size=(n, n))
        _close(t_denoise.median(torch.from_numpy(v)), jnp.median(jnp.asarray(v)),
               tol=0.0)


@pytest.mark.parametrize("branch", ["ULPDA", "MYULA", "MAP"])
def test_deconv_wavelet_row(branch):
    """``wavelet_row`` adds model M10 (``k5-WL1``: the Haar-domain dual for
    ULPDA and MAP, the exact ``OrthogonalL1`` prox for MYULA) to the
    deconvolution grid (cf. tests/test_experiments.py's JAX version)."""
    results, series, summary = t_deconv.prox_lmc_deconv(
        size=32, n_steps=20, niter_map=20, niter_tv=5, wavelet_row=True,
        wavelet_levels=3, alg="MYULA" if branch == "MYULA" else "ULPDA",
        compute_map=branch == "MAP", device="cpu")
    labels = list(summary["report"])
    assert len(labels) == 10 and labels[-1] == "M10 (k5-WL1)"
    assert np.isfinite(results["M10 (k5-WL1)"]).all()
    assert np.isfinite(summary["report"]["M10 (k5-WL1)"]["psnr"])
    assert series["M10 (k5-WL1)"]["cost"].shape == (20,)
    assert np.isfinite(series["M10 (k5-WL1)"]["cost"]).all()
