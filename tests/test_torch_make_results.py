"""The port's results generators (``scripts/make_results_torch.py``,
``scripts/make_docs_figures_torch.py``) against the JAX package's
(``scripts/make_results.py``), on the CPU.

(a) Every section of both scripts on the same stubbed experiment results:
the table and heading lines (those starting with ``|`` or ``#``) equal,
but for the deliberate differences in ``DIFFERENT``. (b) The denoise
section for real in both packages at its published 64^2 size. (c) The PnP
section from the committed ``assets/torch/`` reports, writing nothing;
with block files, pooled into the report, whose other keys stay. (d) A
section that raises: exit 1, the other sections kept, none for it. (e)
Neither script imports JAX or the JAX package; the figures' compute
stage imports no matplotlib. (f) The render stage draws the five figures.
"""
import ast
import importlib.util
import json
import shutil
import sys
from collections import namedtuple
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_SCRIPTS = ("make_results_torch.py", "make_docs_figures_torch.py")
# the sections whose table or heading lines differ on purpose: the title
# line (which names the device) is outside the sections; the JAX
# throughput section is fixed prose about another device, the port's is
# measured on the card; the JAX multichain heading names the other
# device's lane packing
DIFFERENT = {"throughput": "all lines",
             "multichain": "## Lane-packed multi-chain UQ (fused MYULA, one kernel instance)"}
# no line the port writes may state a fact of the other device
OTHER_DEVICE_WORDS = ("TPU", "VMEM", "MXU", "TensorCore", "lane", "v5e", "Mosaic", "Pallas")
# (b): |port - JAX| of each denoise PSNR; 4 standard deviations of the JAX
# package's PSNRs over seeds 0-7 at this configuration (sd 0.095 dB noisy,
# 0.099 dB posterior mean), rounded up: `scripts/denoise_gates.py`
DENOISE_TOL_DB = 0.4


def _load(name):
    spec = importlib.util.spec_from_file_location(name[:-3], REPO / "scripts" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return _load("make_results.py"), _load("make_results_torch.py")


def _clock():
    """A fake ``time`` module whose ``perf_counter`` steps by one second a
    call, so both scripts time each run at 1 s."""
    t = iter(range(10**6))
    return SimpleNamespace(perf_counter=lambda: float(next(t)))


def _table(lines):
    return [ln for ln in lines if ln.startswith(("|", "#"))]


def _set_both(monkeypatch, attr, fn):
    """Stub ``attr`` (a dotted path below the package) in both packages."""
    for pkg in ("lmc_atomi_tpu", "lmc_atomi_torch"):
        monkeypatch.setattr(f"{pkg}.{attr}", fn)


def _stub_mixtures(mp):
    def gm(**kw):
        w2 = {m: kw["gamma_ula"] * kw["n"] + 0.01 * i
              for i, m in enumerate(["ULA", "MALA", "PULA", "IHPULA", "MLA"])}
        return None, None, {"final_w2": w2}

    _set_both(mp, "experiments.mixtures.lmc_gaussian_mixture", gm)
    _set_both(mp, "models.GaussianMixture.sample", lambda self, key, k: np.zeros((k, 2)))
    _set_both(mp, "run.runner.run_chain",
              lambda kern, x0, key, k, collect: SimpleNamespace(samples=np.zeros((k, 2))))
    _set_both(mp, "eval.wasserstein.exact_w2", lambda x, y: 0.0121)
    _set_both(mp, "eval.wasserstein.exact_w2_multiscale", lambda x, y, k: (0.0169, 0.2))


def _stub_laplace(mp, tmp_path, jax_mod, port_mod):
    mp.setattr(jax_mod, "LAPLACE_JSON", str(tmp_path / "jax_laplace.json"))
    mp.setattr(port_mod, "LAPLACE_JSON", str(tmp_path / "port_laplace.json"))
    summ = {"final_w2_exact": {"ULA": 0.5, "MALA": 0.25, "PULA": 0.125, "IHPULA": 1.5,
                               "MLA": 0.75}}
    _set_both(mp, "experiments.laplace_mixtures.lmc_laplacian_mixture",
              lambda **kw: (None, None, summ))


def _stub_prox(mp):
    rng = np.random.default_rng(3)
    names = ["PGLD", "MYULA", "MYMALA", "PP-ULA", "FBULA", "LBMUMLA"]
    samples = {m: rng.normal(size=(60, 2)) + i for i, m in enumerate(names)}
    summ = {"iters_per_sec": {m: 1000.0 * (i + 1) for i, m in enumerate(names)}}
    _set_both(mp, "experiments.prox_mixtures.prox_lmc_gaussian_mixture",
              lambda **kw: (samples, summ))

    def sliced(x, y, *args, **kw):
        return float(np.mean((np.asarray(x) - np.asarray(y)) ** 2))

    _set_both(mp, "eval.wasserstein.sliced_w2", sliced)


def _stub_deconv(mp):
    def deconv(size, image, make_plots, collect_metrics, wavelet_row, **kw):
        branch = kw.get("alg", "MAP") if not kw.get("compute_map") else "MAP"
        n = 10 if wavelet_row else 9
        off = {"MAP": 0.0, "ULPDA": 0.5, "MYULA": 1.0}[branch] + len(image)
        return None, None, {"report": {f"M{i + 1} (k)": {"psnr": 20.0 + i + off}
                                       for i in range(n)},
                            "psnr_blurred": 25.9 + len(image)}

    _set_both(mp, "experiments.deconv.prox_lmc_deconv", deconv)


def _stub_wavelets(mp):
    def inpaint(size, wavelet, image, n_steps, make_plots, fused, **kw):
        base = len(image) + len(wavelet) / 10
        rep = {"MYULA": {"psnr": base}, "ULPDA-wavelet": {"psnr": base + 0.5},
               "observed": {"psnr": 7.08}, "MALA": {"psnr": 7.71}}
        ips = {"MYULA": 517.0, "ULPDA-wavelet": 863.0}
        if fused:
            rep.update({"MYULA-fused": {"psnr": 17.56}, "ULPDA-wavelet-fused": {"psnr": 18.04}})
            ips.update({"MYULA-fused": 33076.0, "ULPDA-wavelet-fused": 36870.0})
        return None, {"report": rep, "iters_per_sec": ips, "mala_acceptance": 0.65}

    _set_both(mp, "experiments.inpainting.wavelet_inpainting", inpaint)


def _stub_ct(mp):
    def ct(size, n_angles, make_plots, score_prior, **kw):
        keys = ["psnr_backprojection", "psnr_fbp", "psnr_posterior_mean", "psnr_map_tv",
                "psnr_pnp_mean", "psnr_score_mean"]
        return None, None, {k: size / 10 + i for i, k in enumerate(keys)}

    _set_both(mp, "experiments.ct.ct_tv_myula", ct)


def _stub_sgld(mp):
    rng = np.random.default_rng(5)
    names = ["SGLD", "MSGLD", "cyclicalSGLD", "contourSGLD", "SPGLD"]
    samples = {m: rng.uniform(-4.5, 4.5, size=(20 * (i + 1), 2)) for i, m in enumerate(names)}
    summ = {"iters_per_sec": {m: 100.0 + i for i, m in enumerate(names)},
            "retained": {m: s.shape[0] for m, s in samples.items()}}
    _set_both(mp, "experiments.sgld_runs.sgld_grid_mixture", lambda **kw: (samples, summ))


def _stub_ci(mp):
    from lmc_atomi_torch.utils.images import phantom

    img = phantom(512).astype(np.float32)
    jout = namedtuple("JOut", "moments quantiles")
    jmom = namedtuple("JMom", "mean")

    def fields(base, d, w, lib):
        arr = lib(base + d)
        return arr, {0.025: lib(base - w), 0.975: lib(base + w)}

    def jax_tv(*a, **kw):
        import jax.numpy as jnp

        mean, q = fields(img, 1.0, 2.0, jnp.asarray)
        return jout(jmom(mean), q)

    def jax_wv(*a, **kw):
        import jax.numpy as jnp

        mean, q = fields(img / 255.0, 0.01, 0.05, jnp.asarray)
        return jout(jmom(mean), q)

    def port(base, d, w):
        def run(*a, **kw):
            mean, q = fields(base, d, w, torch.from_numpy)
            return SimpleNamespace(moments=SimpleNamespace(mean=mean), quantiles=q)
        return run

    # the 512^2 blur and data term are built but never used by the stubs:
    # an identity operator stands in for both packages' blur
    blur = SimpleNamespace(matvec=lambda x: x)
    _set_both(mp, "ops.linops.CirculantBlur2D.from_kernel", lambda *a, **kw: blur)
    _set_both(mp, "ops.functionals.L2Data.create", lambda **kw: None)
    mp.setattr("lmc_atomi_tpu.kernels.myula_fused.run_myula_tv_fused", jax_tv)
    mp.setattr("lmc_atomi_tpu.kernels.wavelet_fused.run_myula_wavelet_fused", jax_wv)
    mp.setattr("lmc_atomi_torch.kernels.myula_fused.run_myula_tv_fused", port(img, 1.0, 2.0))
    mp.setattr("lmc_atomi_torch.kernels.wavelet_fused.run_myula_wavelet_fused",
               port(img / 255.0, 0.01, 0.05))


def _stub_multichain(mp):
    def mc(size, n_chains, n_steps, burn_in, kernel, make_plots, **kw):
        return None, None, {"pack": 2, "aggregate_iters_per_sec": 1000.0 * size,
                            "psnr_pooled_mean": 30.0 + len(kernel), "rhat_max": 1.05}

    _set_both(mp, "experiments.multichain.multichain_deblur", mc)


def _stub_pnp(mp, tmp_path, jax_mod, port_mod):
    for f in ("results_pnp1024.json", "results_pnp_anchor.json"):
        shutil.copy(REPO / "assets" / "torch" / f, tmp_path / f)
    for mod in (jax_mod, port_mod):
        mp.setattr(mod, "PNP_JSON", str(tmp_path / "results_pnp1024.json"))


def _denoise(mp):
    rep = {"psnr_noisy": 11.79, "psnr_posterior_mean": 14.09, "iters_per_sec": 47680.0}
    _set_both(mp, "experiments.denoise.l1_denoise_myula", lambda **kw: (None, rep))


SECTIONS = ["mixtures", "laplace", "laplace-exact", "laplace-none", "prox", "denoise",
            "deconv", "wavelets", "pnp", "ct", "sgld", "ci", "multichain"]


@pytest.mark.parametrize("section", SECTIONS)
def test_section_parity(section, scripts, monkeypatch, tmp_path):
    """(a) The same stubbed experiment results through both scripts give the
    same table and heading lines, and the port's lines state no fact of the
    other device."""
    jax_mod, port_mod = scripts
    for mod in scripts:
        monkeypatch.setattr(mod, "time", _clock())
    name = section.split("-")[0]
    jargs, pargs = (), ("cpu",)
    if name == "mixtures":
        _stub_mixtures(monkeypatch)
    elif name == "laplace":
        _stub_laplace(monkeypatch, tmp_path, jax_mod, port_mod)
        exact = section == "laplace-exact"
        if section == "laplace":
            data = {"k": 50000, "final_w2_exact": {"ULA": 0.321, "MALA": 0.123}}
            for f in ("jax_laplace.json", "port_laplace.json"):
                (tmp_path / f).write_text(json.dumps(data))
        jargs, pargs = (exact, 50000), ("cpu", exact, 50000)
    elif name == "pnp":
        _stub_pnp(monkeypatch, tmp_path, jax_mod, port_mod)
        jargs = (str(tmp_path / "no_block_*.npz"),)
        pargs = ("cpu", jargs[0])
    elif name == "wavelets":
        _stub_wavelets(monkeypatch)
        jargs, pargs = (2000,), ("cpu", 2000)
    elif name == "sgld":
        _stub_sgld(monkeypatch)
        jargs, pargs = (50000,), ("cpu", 50000)
    else:
        {"prox": _stub_prox, "denoise": _denoise, "deconv": _stub_deconv, "ct": _stub_ct,
         "ci": _stub_ci, "multichain": _stub_multichain}[name](monkeypatch)
    jlines, plines = [], []
    getattr(jax_mod, f"sec_{name}")(jlines, *jargs)
    getattr(port_mod, f"sec_{name}")(plines, *pargs)
    jt, pt = _table(jlines), _table(plines)
    assert len(pt) >= 1 and len(jt) == len(pt)
    if name in DIFFERENT:
        assert jt[0] == DIFFERENT[name] and pt[0] != jt[0]
        jt, pt = jt[1:], pt[1:]
    assert pt == jt
    text = "\n".join(plines)
    assert not [w for w in OTHER_DEVICE_WORDS if w in text]
    if section == "laplace-exact":
        assert json.loads((tmp_path / "port_laplace.json").read_text())["device"] == "cpu"


def test_ct_section_cites_the_score_study(scripts, monkeypatch, tmp_path):
    """The ct section prints ``scripts/ct_score_drift.py``'s summary of both
    packages' score nets as a note under its table, and no note without
    one; the table stays as it is."""
    drift = _load("ct_score_drift.py")
    lines = [{"net": f"{kind}:{s}", "stream": "port:7", "state_psnr": v, "mean_psnr": v + 2.0}
             for kind, vals in (("port", (18.0, 3.0, 20.0)), ("jax", (19.0, 21.0, 2.0)))
             for s, v in enumerate(vals)]
    verdict = drift.decide(lines)["port:7"]
    assert verdict["below"] == [1, 1] and verdict["n"] == [3, 3]
    assert verdict["mann_whitney_u"] == 4.0 and not verdict["rejects"]
    drift._summary(str(tmp_path / "study.json"), {"port:7": verdict}, "cpu")
    _stub_ct(monkeypatch)
    port_mod = scripts[1]
    texts = []
    for study in ("study.json", "absent.json"):
        monkeypatch.setattr(port_mod, "CT_SCORE_STUDY", str(tmp_path / study))
        out = []
        port_mod.sec_ct(out, "cpu")
        texts.append((_table(out), " ".join(out)))
    (table, note), (bare_table, bare) = texts
    assert table == bare_table and "Mann-Whitney" not in bare
    for want in ("seeds 0-2, 1 of the port's 3 and 1 of the JAX package's 3",
                 "below 17 dB", "span 3.00 to 20.00 dB", "2.00 to 21.00 dB",
                 "Mann-Whitney U 4,", f"p = {verdict['p_mann_whitney']:.3f}", "on cpu"):
        assert want in note, want


def test_throughput_section_rows(scripts, monkeypatch):
    """The port's throughput section (its JAX counterpart is fixed prose,
    ``DIFFERENT``) times every configuration row of the JAX table, each
    ``THROUGHPUT_REPEATS`` times after a warm-up under another key, and
    prints the median and the range; its heading names the device."""
    _, port_mod = scripts
    monkeypatch.setattr(port_mod, "time", _clock())
    monkeypatch.setattr(port_mod, "CI_SIZE", 16)
    keys = []

    def run(*a, **kw):
        keys.append((a[5], a[6]))

    monkeypatch.setattr("lmc_atomi_torch.kernels.myula_fused.run_myula_tv_fused", run)
    monkeypatch.setattr("lmc_atomi_torch.kernels.ulpda_fused.run_ulpda_fused",
                        lambda *a, **kw: run(*a[1:], **kw))
    lines = []
    port_mod.sec_throughput(lines, "cpu")
    rows = [ln for ln in _table(lines) if ln.startswith("| ") and "iters/s" not in ln]
    cells = [ln.strip("| ").split(" | ") for ln in rows]
    assert lines[0] == "## Throughput (cpu)" and [len(c) for c in cells] == [2] * 7
    assert [v.split(" / ") for _, v in cells] == [["5.0k (5.0-5.0k)"] * n
                                                  for n in (1, 1, 2, 2, 1, 3, 3)]
    assert keys == ([(101, port_mod.THROUGHPUT_WARM)]
                    + [(1, port_mod.THROUGHPUT_STEPS)] * port_mod.THROUGHPUT_REPEATS) * 13
    assert not [w for w in OTHER_DEVICE_WORDS if w in "\n".join(lines)]


def test_denoise_section_real(scripts):
    """(b) The denoise section run for real in both packages at 64^2, 2000
    steps: each PSNR of the port within DENOISE_TOL_DB of the JAX package's
    (the two draw their noise from other streams)."""
    jax_mod, port_mod = scripts
    jlines, plines = [], []
    jax_mod.sec_denoise(jlines)
    port_mod.sec_denoise(plines, "cpu")
    j, p = ([float(v) for v in lines[lines.index("|---|---|---|") + 1].strip("| ").split(" | ")]
            for lines in (jlines, plines))
    assert abs(p[0] - j[0]) <= DENOISE_TOL_DB and abs(p[1] - j[1]) <= DENOISE_TOL_DB
    assert p[1] > p[0] and p[2] > 0


def test_pnp_section_from_committed_reports(scripts, tmp_path):
    """(c) With no block file, the PnP section renders the committed
    ``assets/torch/`` reports and writes nothing there."""
    _, port_mod = scripts
    assets = REPO / "assets" / "torch"
    before = {p.name: p.stat().st_mtime_ns for p in assets.iterdir()}
    lines = []
    port_mod.sec_pnp(lines, "cpu", str(tmp_path / "no_block_*.npz"))
    rep = json.loads((assets / "results_pnp1024.json").read_text())
    anchor = json.loads((assets / "results_pnp_anchor.json").read_text())
    assert f"| posterior-mean PSNR | {rep['psnr_posterior_mean']:.2f} dB |" in lines
    assert f"| mean 95% CI width | {rep['mean_ci_width']:.4f} |" in lines
    assert any(ln.startswith("| hand-crafted TV") and
               f"{anchor['psnr_tv_baseline_mean']:.2f}" in ln for ln in lines)
    assert {p.name: p.stat().st_mtime_ns for p in assets.iterdir()} == before


def test_pnp_section_merges_block_files(scripts, monkeypatch, tmp_path):
    """(c) With block files, the PnP section pools them into the farm
    script's report: the pooled figures replace the old ones, every other
    key of the report (size, steps, bounds, seconds) stays."""
    _, port_mod = scripts
    _stub_pnp(monkeypatch, tmp_path, port_mod, port_mod)
    old = json.loads((tmp_path / "results_pnp1024.json").read_text())
    rng = np.random.default_rng(0)
    for b in range(2):
        np.savez(tmp_path / f"pnp_block_{b:02d}.npz", count=np.asarray(30 + b),
                 mean=rng.uniform(0.0, 1.0, (256, 256)), n_chains=np.asarray(3),
                 m2=rng.uniform(0.0, 0.5, (256, 256)))
    lines = []
    port_mod.sec_pnp(lines, "cpu", str(tmp_path / "pnp_block_*.npz"))
    rep = json.loads((tmp_path / "results_pnp1024.json").read_text())
    assert (rep["n_blocks"], rep["n_chains"], rep["n_chain_draws"]) == (2, 6, 61)
    assert rep["device"] == "cpu" and rep["psnr_posterior_mean"] != old["psnr_posterior_mean"]
    pooled = {"n_blocks", "n_chains", "n_chain_draws", "psnr_posterior_mean", "mean_ci_width",
              "std_max", "device"}
    assert {"size", "n_steps", "lipschitz_certified_bound", "wall_seconds"} <= set(old) - pooled
    assert {k: rep[k] for k in set(old) - pooled} == {k: old[k] for k in set(old) - pooled}
    assert f"| posterior-mean PSNR | {rep['psnr_posterior_mean']:.2f} dB |" in lines


def test_failed_section_keeps_the_others(scripts, monkeypatch, tmp_path):
    """(d) A section that raises: the script exits 1, the other sections'
    files are written, none stands for the failed one (its old file is
    gone), and ``out`` is put together from what is there; ``--sections
    ""`` only puts ``out`` together again."""
    _, port_mod = scripts

    def ok(name):
        return lambda lines, a: lines.extend([f"## {name}", "", f"| {name} |", ""])

    def boom(lines, a):
        lines.append("## half a section")
        raise RuntimeError("boom")

    for name in ("denoise", "ct"):
        monkeypatch.setitem(port_mod.SECTIONS, name, ok(name))
    monkeypatch.setitem(port_mod.SECTIONS, "pnp", boom)
    secs = tmp_path / "results_sections"
    secs.mkdir()
    (secs / "pnp.md").write_text("## stale\n")
    (secs / "pnp.json").write_text('{"device": "old", "seconds": 1}\n')
    out = tmp_path / "RESULTS.md"
    with pytest.raises(SystemExit) as e:
        port_mod.main(sections="ct,pnp,denoise", out=str(out), device="cpu")
    assert e.value.code == 1
    assert sorted(p.name for p in secs.iterdir()) == ["ct.json", "ct.md", "denoise.json",
                                                      "denoise.md"]
    text = out.read_text()
    assert "Device: `cpu` (single card)" in text and "stale" not in text
    assert text.index("## denoise") < text.index("## ct")  # DEFAULT_SECTIONS order
    assert json.loads((secs / "ct.json").read_text())["device"] == "cpu"
    (secs / "ct.md").unlink()
    assert port_mod.main(sections="", out=str(out), device="cuda") == ["denoise"]
    assert "## ct" not in out.read_text()


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_no_jax_imports():
    """(e) Neither script imports JAX or the JAX package, at any depth of
    its source."""
    for name in PORT_SCRIPTS:
        mods = set(_imports(ast.parse((REPO / "scripts" / name).read_text())))
        assert mods and not [m for m in mods if m.split(".")[0] in ("jax", "lmc_atomi_tpu")]


def _stub_figure_workloads(mp):
    rng = np.random.default_rng(0)
    names = ["ULA", "MALA"]
    curves = {m: (np.arange(1, 4) * 500, rng.uniform(size=3)) for m in names}
    samples = {m: rng.normal(size=(300, 2)) for m in names}
    mp.setattr("lmc_atomi_torch.experiments.mixtures.lmc_gaussian_mixture",
               lambda **kw: (samples, curves, {}))
    mp.setattr("lmc_atomi_torch.experiments.deconv.prox_lmc_deconv",
               lambda **kw: ({"M1 (k5-TV)": rng.uniform(size=(8, 8))}, {}, {}))
    mp.setattr("lmc_atomi_torch.experiments.pnp.pnp_ula_deblur",
               lambda **kw: (rng.uniform(size=(8, 8)), rng.uniform(size=(8, 8)), {}))

    def ct(arrays_out, **kw):
        arrays_out.update({k: rng.uniform(size=(8, 8)) for k in
                           ("img", "sino", "mean", "std", "map", "pnp_mean", "score_mean")})
        return None, None, {}

    mp.setattr("lmc_atomi_torch.experiments.ct.ct_tv_myula", ct)


def test_figures_compute_then_render(monkeypatch, tmp_path):
    """(e) The compute stage imports no matplotlib (it is made unimportable
    while it runs) and writes one arrays file; (f) the render stage draws
    the five figures of the JAX script's names from it."""
    figs = _load("make_docs_figures_torch.py")
    _stub_figure_workloads(monkeypatch)
    arrays = tmp_path / "arrays.npz"
    with monkeypatch.context() as m:
        for mod in [k for k in sys.modules if k.split(".")[0] == "matplotlib"] + ["matplotlib"]:
            m.setitem(sys.modules, mod, None)
        figs.main(stage="compute", arrays=str(arrays), device="cpu")
    with np.load(arrays) as a:
        assert [k for k in a.files if k.startswith("ct::")][1] == "ct::Sinogram (30 angles)"
        assert a["deconv::Blurred"].shape == (256, 256)
    figs.main(stage="render", arrays=str(arrays), outdir=str(tmp_path / "figs"))
    assert sorted(p.name for p in (tmp_path / "figs").iterdir()) == [
        "ct_posterior.png", "deconv_grid.png", "mixtures_hist.png", "mixtures_w2.png",
        "pnp_uncertainty.png"]
    assert all(p.stat().st_size > 1000 for p in (tmp_path / "figs").iterdir())
