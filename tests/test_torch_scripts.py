"""The port's workload scripts on the CPU.

* Line parity: each ``scripts/*_torch.sh`` sweep and its JAX script run under
  bash with a ``python`` that only records its arguments; every recorded
  ``python -m`` line goes through its module's own ``main()``, whose
  ``auto_cli`` is handed a recorder that carries the CLI function's
  signature, and the two lines must give the same function and the same
  keyword values. Set apart: ``platform``/``device``, and the port's
  ``make_plots`` default (False: the card's machine has no matplotlib) where
  neither line gives the flag. The config-5 farm's command lines are held to
  ``scripts/expt_pnp1024.sh``'s the same way.
* The farm, ``scripts/expt_pnp1024_torch.py``, at 16^2 (DnCNN depth 3, width
  8, 2 blocks x 2 chains x 10 steps): its pooled moments equal one 4-chain
  ``pnp_ula_deblur`` call's, and a second invocation runs no block.
* The anchor, ``scripts/expt_pnp_anchor_torch.py``, at the same size: its
  report has every key of the JAX script's.
"""
import ast
import importlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lmc_atomi_torch.core.checkpoint import save_checkpoint
from lmc_atomi_torch.experiments import pnp as t_pnp
from lmc_atomi_torch.models.dncnn import DnCNN, lecun_init

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SWEEPS = ["expt_lmc", "expt_lmc_laplace", "expt_prox_lmc", "expt_deconv", "expt_extras"]
RECORDER = '#!/bin/bash\nprintf "%s\\0" "$@" >> "$ARGV_LOG"\nprintf "\\n\\0" >> "$ARGV_LOG"\n'
NET = dict(size=16, depth=3, features=8, device="cpu")
TOL = 1e-10


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _recorded(script, tmp_path, **env):
    """The argument lists of every ``python`` the bash ``script`` starts."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    (bin_dir / "python").write_text(RECORDER)
    (bin_dir / "python").chmod(0o755)
    log = tmp_path / f"{script}.argv"
    log.write_text("")
    subprocess.run(["bash", str(ROOT / "scripts" / script)], check=True, env={
        **os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
        "ARGV_LOG": str(log), **env})
    calls, cur = [], []
    for token in log.read_text().split("\0"):
        if token == "\n":
            calls.append(cur)
            cur = []
        elif token:
            cur.append(token)
    return calls


def _parse(args, monkeypatch):
    """``(function name, keyword values)`` that ``python args`` hands its
    CLI function: the module's ``main()`` with a recording ``auto_cli``."""
    assert args[0] == "-m", args
    module = importlib.import_module(args[1])
    cli = importlib.import_module(args[1].split(".")[0] + ".utils.cli")
    real, seen = cli.auto_cli, []

    def recording(fn, argv=None):
        def recorder(**kw):
            return kw

        recorder.__signature__ = inspect.signature(fn)
        recorder.__name__, recorder.__doc__ = fn.__name__, fn.__doc__
        seen.append((fn.__name__, real(recorder, argv)))

    with monkeypatch.context() as m:
        m.setattr(cli, "auto_cli", recording)
        m.setattr(sys, "argv", [args[1], *args[2:]])
        module.main()
    assert len(seen) == 1, args
    return seen[0]


def _flags(args):
    return {a.split("=")[0] for a in args if a.startswith("--")}


def _same_call(t_args, j_args, monkeypatch, skip=()):
    """The port's line and the JAX line give one function the same values
    (bar the keywords in ``skip``); returns the port's."""
    assert t_args[1] == j_args[1].replace("lmc_atomi_tpu.", "lmc_atomi_torch."), (t_args, j_args)
    t_name, t_kw = _parse(t_args, monkeypatch)
    j_name, j_kw = _parse(j_args, monkeypatch)
    assert t_name == j_name
    t_kw.pop("device")
    j_kw.pop("platform", None)
    assert set(j_kw) <= set(t_kw), set(j_kw) - set(t_kw)
    shared = set(j_kw) - set(skip) - ({"make_plots"} - {f[2:] for f in _flags(j_args)})
    assert {k: t_kw[k] for k in shared} == {k: j_kw[k] for k in shared}, (t_args, j_args)
    return t_kw


@pytest.mark.parametrize("sweep", SWEEPS)
def test_sweep_lines_match_jax_script(sweep, tmp_path, monkeypatch):
    t_calls = _recorded(f"{sweep}_torch.sh", tmp_path)
    j_calls = _recorded(f"{sweep}.sh", tmp_path)
    assert len(t_calls) == len(j_calls) > 0
    text = (ROOT / "scripts" / f"{sweep}_torch.sh").read_text()
    assert "lmc_atomi_tpu" not in text and "--platform" not in text
    loops = [ln.strip() for ln in text.splitlines() if ln.strip().startswith("for ")]
    assert loops == [ln.strip() for ln in (ROOT / "scripts" / f"{sweep}.sh").read_text()
                     .splitlines() if ln.strip().startswith("for ")]
    for t_args, j_args in zip(t_calls, j_calls):
        assert _flags(t_args) == _flags(j_args), (t_args, j_args)
        _same_call(t_args, j_args, monkeypatch)


def test_farm_lines_match_jax_script(tmp_path, monkeypatch):
    """The farm's train, block and merge lines at config 5's defaults give
    the JAX script's values (paths aside: each block writes a partial file
    that the farm renames once the block has ended)."""
    farm = _script("expt_pnp1024_torch")
    out, params = tmp_path / "out", tmp_path / "params"
    j_calls = _recorded("expt_pnp1024.sh", tmp_path, PARAMS=str(params), OUT=str(out))
    d = {k: p.default for k, p in inspect.signature(farm.farm).parameters.items()}
    shape = dict(size=d["size"], depth=d["depth"], features=d["features"])
    train = farm.train_args(params, train_steps=d["train_steps"], device="cuda", **shape)
    blocks = [farm.block_args(b, out / f"partial_{farm.block_name(b, d['n_blocks'])}", params,
                              d["block_chains"], n_steps=d["n_steps"], burn_in=d["burn_in"],
                              device="cuda", **shape) for b in range(d["n_blocks"])]
    merge = farm.merge_args(out / "pnp_block_*.npz", out / "pnp_1024_final.npz", d["size"],
                            "cuda")
    assert len(j_calls) == 2 + d["n_blocks"] == 18
    _same_call(train, j_calls[0], monkeypatch)
    for b, (t_args, j_args) in enumerate(zip(blocks, j_calls[1:-1])):
        t_kw = _same_call(t_args, j_args, monkeypatch, skip=("moments_out",))
        assert t_kw["moments_out"] == str(out / f"partial_pnp_block_{b:02d}.npz")
        assert _parse(j_args, monkeypatch)[1]["moments_out"] == str(out / f"pnp_block_{b}.npz")
    kw = _same_call(merge, j_calls[-1], monkeypatch)
    assert kw["pattern"] == str(out / "pnp_block_*.npz")
    assert sorted(farm.block_name(b, 16) for b in (10, 2, 0)) == [
        "pnp_block_00.npz", "pnp_block_02.npz", "pnp_block_10.npz"]
    for name in ("expt_pnp1024_torch", "expt_pnp_anchor_torch"):
        tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text())
        imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert not {m for m in imported if m.split(".")[0] in ("jax", "lmc_atomi_tpu")}, name


def test_farm_pools_blocks_as_one_call_and_resumes(tmp_path, monkeypatch):
    """The prior is an initialised net saved here (a fit in a process of its
    own would cost the test another start; the farm's moments do not depend
    on how the weights were made); the blocks run on one thread each."""
    farm = _script("expt_pnp1024_torch")
    params, outdir = tmp_path / "dncnn.pt", tmp_path / "farm"
    save_checkpoint(str(params), lecun_init(DnCNN(NET["depth"], NET["features"]),
                                            (6, 0)).state_dict())
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    kw = dict(n_blocks=2, block_chains=2, n_steps=10, burn_in=2, train_steps=2,
              outdir=str(outdir), params_path=str(params), report=str(tmp_path / "rep.json"),
              **NET)
    rep = farm.farm(**kw)
    assert rep["n_blocks"] == 2 and rep["n_chains"] == 4
    assert rep["n_chain_draws"] == 4 * (10 - 2)
    saved = json.loads((tmp_path / "rep.json").read_text())
    jax_keys = set(json.loads((ROOT / "assets/results_pnp1024.json").read_text()))
    assert jax_keys | {"device", "block_seconds", "chain_steps_per_sec"} <= set(saved)
    assert saved["device"] == "cpu" and len(saved["block_seconds"]) == 2
    assert saved["fit_seconds"] is None and np.isfinite(saved["psnr_posterior_mean"])

    t_pnp.pnp_ula_deblur(n_chains=4, chain_block=2, n_steps=10, burn_in=2,
                         params_path=str(params), moments_out=str(tmp_path / "one.npz"), **NET)
    with np.load(outdir / "pnp_1024_final.npz") as got, np.load(tmp_path / "one.npz") as want:
        assert int(got["count"]) == int(want["count"]) == 32
        for key in ("mean", "m2"):
            a, b = got[key], want[key]
            assert a.dtype == b.dtype == np.float64
            assert np.abs(a - b).max() <= TOL * np.abs(b).max(), key

    stamps = {f: f.stat().st_mtime_ns for f in outdir.glob("pnp_block_*")}
    monkeypatch.setattr(farm, "_run", lambda *a: pytest.fail(f"a step ran again: {a}"))
    again = farm.farm(**kw)
    assert {f: f.stat().st_mtime_ns for f in outdir.glob("pnp_block_*")} == stamps
    assert {k: again[k] for k in jax_keys} == {k: rep[k] for k in jax_keys}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        farm.farm(outdir=str(outdir))


def _jax_anchor_keys():
    """Every key of ``scripts/expt_pnp_anchor.py``'s report: the dict
    literal (with the keys it copies from the run) and ``psnr_alpha_*``."""
    tree = ast.parse((ROOT / "scripts/expt_pnp_anchor.py").read_text())
    literal = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", "") == "report")
    keys = {n.value for n in ast.walk(literal)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    alphas = next(n.iter for n in ast.walk(tree) if isinstance(n, ast.For)
                  and getattr(n.target, "id", "") == "alpha")
    return keys | {f"psnr_alpha_{a.value}" for a in alphas.elts}


def test_anchor_report_has_jax_keys(tmp_path):
    anchor = _script("expt_pnp_anchor_torch")
    jax_file = (ROOT / "assets/results_pnp_anchor.json").read_bytes()
    keys = _jax_anchor_keys()
    assert {"psnr_tv_baseline_mean", "psnr_score_mean", "psnr_alpha_0.3"} <= keys
    anchor.main(n_chains=2, n_steps=10, burn_in=2, tv_steps=20, ablation_chains=2,
                train_steps=2, score_train_steps=2, out=str(tmp_path / "anchor.json"),
                params_path=str(tmp_path / "dncnn.pt"), **NET)
    saved = json.loads((tmp_path / "anchor.json").read_text())
    assert keys <= set(saved), keys - set(saved)
    assert saved["device"] == "cpu" and saved["tv_steps"] == 20
    assert all(np.isfinite(saved[k]) for k in keys)
    assert (ROOT / "assets/results_pnp_anchor.json").read_bytes() == jax_file
