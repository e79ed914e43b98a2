"""The PnP CLI and the deconvolution study's score row in the port, on the
CPU (``device="cpu"``, tiny nets): ``pnp_ula_deblur`` with its TV anchor and
score baseline, the report against the JAX CLI's keys, ``train_only`` and
``params_path``, the farm's chain blocks and segments, ``pnp_merge`` on
block files of both packages in both packages, and
``prox_lmc_deconv(score_row=True)``."""
import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch.experiments import deconv as t_deconv
from lmc_atomi_torch.experiments import pnp as t_pnp
from lmc_atomi_torch.utils.cli import auto_cli
from lmc_atomi_tpu.experiments import pnp as j_pnp
from lmc_atomi_tpu.models import dncnn as j_dncnn

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(size=32, n_chains=2, n_steps=20, burn_in=5, train_steps=3, depth=3, features=8,
            device="cpu")


def _jax_report_keys():
    """The keys ``lmc_atomi_tpu/experiments/pnp.py::pnp_ula_deblur`` puts in
    its report (the dict literal and every ``report[...] =``)."""
    tree = ast.parse((ROOT / "lmc_atomi_tpu/experiments/pnp.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "pnp_ula_deblur")
    keys = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "report" and isinstance(node.value, ast.Dict)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
                and node.value.id == "report" and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
    return keys


def test_segments():
    assert t_pnp.segments(2000) == [500] * 4
    assert t_pnp.segments(1234) == [500, 500, 234]
    assert t_pnp.segments(20) == [20]


def test_pnp_cli_report_and_baselines(tmp_path, capsys):
    keys = _jax_report_keys()
    assert {"psnr_tv_baseline_mean", "score_ci_width", "lipschitz_measured"} <= keys
    mean, std, report = t_pnp.pnp_ula_deblur(
        **TINY, chain_block=1, score_baseline=True, score_train_steps=2, score_arch="unet",
        pc_correctors=1, moments_out=str(tmp_path / "blk_port.npz"))
    assert keys <= set(report)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["workload"] == "pnp_ula_deblur" and line["n_chains"] == 2
    assert mean.shape == (32, 32) and np.isfinite(mean).all() and (std >= 0).all()
    assert all(np.isfinite(report[k]) for k in keys)
    assert report["lipschitz_certified_bound"] <= 1.1**3 * (1 + 1e-6)
    with np.load(tmp_path / "blk_port.npz") as d:
        assert set(d) == {"count", "mean", "m2", "size", "seed", "n_chains", "n_steps"}
        # two chains x (20 - 5) collected steps, over two chain blocks of one
        assert int(d["count"]) == 30 and d["mean"].dtype == np.float64


def test_pnp_train_only_and_params_path(tmp_path, capsys):
    path = str(tmp_path / "dncnn.pt")
    _, _, trained = t_pnp.pnp_ula_deblur(**TINY, train_only=True, params_path=path)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["workload"] == (
        "pnp_train_denoiser")
    assert Path(path).exists()
    _, _, loaded = t_pnp.pnp_ula_deblur(**TINY, train_only=True, params_path=path)
    assert loaded["train_seconds"] == 0.0
    assert loaded["lipschitz_certified_bound"] == trained["lipschitz_certified_bound"]
    assert loaded["lipschitz_measured"] == trained["lipschitz_measured"]


def test_pnp_merge_reads_both_packages(tmp_path, capsys, monkeypatch):
    """A block file of each package; each package's ``pnp_merge`` pools
    both, and the two reports agree. The JAX CLI's farm writes its file as
    it is; its denoiser is the untrained net and its Lipschitz probe is
    skipped (both compile for seconds and leave the file's format alone)."""
    tiny = dict(size=16, n_chains=2, n_steps=6, burn_in=2, train_steps=1, depth=1,
                features=1, tv_baseline=False)
    t_pnp.pnp_ula_deblur(**tiny, device="cpu", seed=1, moments_out=str(tmp_path / "blk_0.npz"))

    def untrained(key, depth, features, **_):
        model = j_dncnn.DnCNN(depth=depth, features=features)
        return model.init(key, jnp.zeros((1, 40, 40))), model.apply

    monkeypatch.setattr(j_dncnn, "train_denoiser", untrained)
    monkeypatch.setattr(j_dncnn, "lipschitz_estimate", lambda *a, **k: 0.0)
    j_pnp.pnp_ula_deblur(**tiny, make_plots=False, moments_out=str(tmp_path / "blk_1.npz"))
    pattern = str(tmp_path / "blk_*.npz")
    got = t_pnp.pnp_merge(pattern=pattern, size=16, device="cpu")
    want = j_pnp.pnp_merge(pattern=pattern, size=16)
    assert got["n_blocks"] == want["n_blocks"] == 2
    assert got["n_chains"] == want["n_chains"] == 4
    assert got["n_chain_draws"] == want["n_chain_draws"] == 16
    for k in ("psnr_posterior_mean", "mean_ci_width", "std_max"):
        assert abs(got[k] - want[k]) <= 1e-9 * abs(want[k]), k
    capsys.readouterr()
    auto_cli(t_pnp.pnp_merge, ["--pattern", pattern, "--size", "16", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["n_blocks"] == 2


def test_pnp_device_guard_and_plots(monkeypatch, tmp_path):
    t_pnp.pnp_ula_deblur(**TINY, make_plots=True, outdir=str(tmp_path))
    assert (tmp_path / "fig_pnp_ula_32_20.pdf").stat().st_size > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_pnp.pnp_ula_deblur(size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_pnp.pnp_merge("blk_*.npz")


def test_deconv_score_row_runs(capsys):
    results, series, summary = t_deconv.prox_lmc_deconv(
        size=32, n_steps=16, niter_tv=2, alg="MYULA", device="cpu", collect_metrics=False,
        score_row=True, score_train_steps=2, segment_steps=5)
    label = "M_score (k5-SCORE)"
    assert len(results) == 10 and label in results
    est = results[label]
    assert est.shape == (32, 32) and np.isfinite(est).all()
    assert np.isfinite(summary["report"][label]["psnr"])
    assert label in summary["iters_per_sec"]
