"""The learned priors in the port, on the CPU, against the JAX package: the
DnCNN, ScoreNet and ScoreUNet forward passes (flax parameters carried over
by ``interop.py``), the spectral functions, the Lipschitz estimate, ten Adam
steps of the denoiser's and the score net's training against optax, the
synthetic training data, and PnP-ULA, score-ULA and its predictor-corrector
form with the noise injected; then the samplers' identities in the port.

f64 throughout. The flax parameter trees have the flax modules' shapes
(``jax.eval_shape`` of ``init``) and seeded values: flax's own ``init``
keeps float32 parameters under x64 and compiles op by op for seconds. The
JAX trainers run as they are, with their models' ``init`` and the sigma
ladder patched to f64, and the port is fed the batches the JAX trainer
draws, recomputed from its keys. Tolerances: the nets and norms 1e-10 of
the output's scale, ten Adam steps 1e-8, the samplers 1e-12."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmc_atomi_torch import interop
from lmc_atomi_torch.core.random import normal_field
from lmc_atomi_torch.kernels import imaging as t_img
from lmc_atomi_torch.models import dncnn as t_dncnn
from lmc_atomi_torch.models import score as t_score
from lmc_atomi_torch.run.runner import run_chain, run_chain_segmented, run_chains
from lmc_atomi_torch.utils import images as t_images
from lmc_atomi_torch.utils import synthetic as t_syn
from lmc_atomi_tpu.core.random import step_key
from lmc_atomi_tpu.kernels import imaging as j_img
from lmc_atomi_tpu.models import dncnn as j_dncnn
from lmc_atomi_tpu.models import score as j_score
from lmc_atomi_tpu.utils import png as j_png
from lmc_atomi_tpu.utils import synthetic as j_syn

torch.set_num_threads(2)

TOL_NET = 1e-10
TOL_ADAM = 1e-8
TOL_STEP = 1e-12
N = 32
UNET = (8, 16, 24)
SEED, CHAIN = 5, 2


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol, name=""):
    want = np.asarray(want)
    got = _np(got)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _random_params(model, args, seed, bias=0.1):
    """A flax parameter tree of ``model`` (its shapes by ``jax.eval_shape``
    of ``init``, no compile): LeCun-scaled normal kernels and normal biases
    of sd ``bias``, f64, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return jnp.asarray(rng.standard_normal(leaf.shape) / np.sqrt(fan_in))
        return jnp.asarray(bias * rng.standard_normal(leaf.shape))

    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _args(kind, n=N):
    return (jnp.zeros((1, n, n)),) if kind == "dncnn" else (jnp.zeros((1, n, n)), jnp.ones((1,)))


def _jax_net(kind):
    if kind == "dncnn":
        m = j_dncnn.DnCNN(depth=3, features=8)
    elif kind == "cnn":
        m = j_score.ScoreNet(depth=4, features=8, emb_features=16)
    else:
        m = j_score.ScoreUNet(features=UNET, emb_features=16)
    return m, _random_params(m, _args(kind), {"dncnn": 0, "cnn": 1, "unet": 2}[kind])


_CONVERT = {"dncnn": interop.dncnn_from_numpy, "cnn": interop.score_net_from_numpy,
            "unet": interop.score_unet_from_numpy}


def _port(kind, tree):
    return _CONVERT[kind](jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("kind", ["dncnn", "cnn", "unet"])
def test_forward_matches_flax(kind):
    rng = np.random.default_rng(3)
    x = rng.random((3, N, N))
    sig = rng.uniform(0.05, 0.5, 3)
    m, p = _jax_net(kind)
    net = _port(kind, p)
    assert next(net.parameters()).dtype == torch.float64
    if kind == "dncnn":
        want, got = jax.jit(m.apply)(p, jnp.asarray(x)), net(torch.from_numpy(x))
    else:
        want = jax.jit(m.apply)(p, jnp.asarray(x), jnp.asarray(sig))
        got = net(torch.from_numpy(x), torch.from_numpy(sig))
    _close(got, want, TOL_NET, kind)


def test_spectral_norms_and_projection_match_jax():
    m, p = _jax_net("dncnn")
    net = _port("dncnn", p)
    want = j_dncnn.conv_operator_norms(p)
    got = t_dncnn.conv_operator_norms(net)
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL_NET * max(1.0, want[k]), k
    for n in (8, 16):
        k = np.array(p["params"]["conv1"]["kernel"])
        _close(t_dncnn._transfer_sigma(torch.from_numpy(k).permute(3, 2, 0, 1), n),
               j_dncnn._transfer_sigma(jnp.asarray(k), n), TOL_NET)
    # a cap between the layers' norms: some kernels scale, others stay
    target = float(np.median(list(want.values())))
    proj = jax.jit(j_dncnn.project_conv_kernels, static_argnums=1)(p, target)
    t_dncnn.project_conv_kernels(net, target)
    for (name, a), (_, b) in zip(net.named_parameters(), _port("dncnn", proj).named_parameters()):
        _close(a, _np(b), TOL_NET, name)


def test_power_sigma_approaches_the_svd():
    """The card's spectral norm (power iterations on the squared Gram
    matrices) on a conv layer's transfer matrices, run here on the CPU: from
    below, and within 1e-10 of LAPACK's largest singular value; also where
    the two largest singular values are 1e-4 apart."""
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((24, 24, 3, 3)) / 20.0)
    pad = w.new_zeros((24, 24, 16, 16))
    pad[:, :, :3, :3] = w
    spec = torch.fft.fft2(pad).permute(2, 3, 0, 1).reshape(256, 24, 24)
    exact = float(t_dncnn._transfer_sigma(w, 16))
    got = float(t_dncnn._power_sigma(spec).amax())
    assert exact * (1 - 1e-10) <= got <= exact * (1 + 1e-12)
    u, _, vh = torch.linalg.svd(spec[:8])
    s = torch.linspace(0.5, 0.9, 24, dtype=torch.float64).repeat(8, 1)
    s[:, -2:] = torch.tensor([1.0 - 1e-4, 1.0], dtype=torch.float64)
    close = (u * s.to(u.dtype)[:, None, :]) @ vh
    got = t_dncnn._power_sigma(close)
    assert float((got - 1.0).abs().max()) <= 1e-8


def test_lipschitz_estimate_matches_jax_with_start_vector():
    m, p = _jax_net("dncnn")
    net = _port("dncnn", p)
    x = np.random.default_rng(6).random((N, N))
    key = jax.random.PRNGKey(3)
    den = j_dncnn.make_denoiser(p, m.apply)
    want = j_dncnn.lipschitz_estimate(lambda z: den(z) - z, jnp.asarray(x), key, iters=2)
    v0 = torch.from_numpy(np.array(jax.random.normal(key, x.shape, jnp.float64)))
    got = t_dncnn.lipschitz_estimate(lambda z: net(z) - z, torch.from_numpy(x), (0, 0),
                                     iters=2, v0=v0)
    assert abs(got - want) <= TOL_NET * want


def _t64(a):
    return torch.from_numpy(np.array(a, np.float64))


def _assert_same_params(net, kind, tree, tol):
    for (name, a), (_, b) in zip(net.named_parameters(), _port(kind, tree).named_parameters()):
        _close(a, _np(b), tol, name)


def _denoiser_draw(k_train, batch=4, patch=16, noise_sigma=0.1):
    """``train_denoiser``'s batch of step ``i`` from its keys (JAX arrays;
    jitted, as in its ``train_step``)."""
    @jax.jit
    def draw(i):
        k_img, k_noise = jax.random.split(jax.random.fold_in(k_train, i))
        clean = j_syn.random_phantom_batch(k_img, batch, patch)
        return clean, clean + noise_sigma * jax.random.normal(k_noise, clean.shape, clean.dtype)
    return draw


def _score_draw(k_train, sigmas, batch=4, patch=16, n_sigmas=4):
    """``train_score_net``'s batch of step ``i`` from its keys."""
    @jax.jit
    def draw(i):
        k_img, k_lvl, k_noise = jax.random.split(jax.random.fold_in(k_train, i), 3)
        clean = j_syn.random_phantom_batch(k_img, batch, patch)
        sig = sigmas[jax.random.randint(k_lvl, (batch,), 0, n_sigmas)]
        return clean, sig, jax.random.normal(k_noise, clean.shape, clean.dtype)
    return draw


@pytest.mark.parametrize("kind", ["dncnn", "cnn", "unet"])
def test_adam_steps_match_optax(kind):
    """Ten Adam steps of the trainers' update, each held alone: from
    optax's parameters and moments, one step of the port's update (its
    loss and ``fit``'s ``torch.optim.Adam``) against one step of ``train_denoiser``'s
    / ``train_score_net``'s update (the same loss, ``optax.adam``), on the
    batch the JAX trainer draws at that step; the DnCNN with its spectral
    projection every 4 steps. Run freely, two trajectories part where a
    weight's gradient sits near Adam's eps of 1e-8: the update then
    multiplies a last-bit difference of the gradient by ~1e7 a step."""
    import optax

    m = _jax_net(kind)[0]
    p = _random_params(m, _args(kind, 16), 7, bias=0.0)
    lr = 1e-3 if kind == "dncnn" else 2e-3
    if kind == "dncnn":
        draw = _denoiser_draw(jax.random.PRNGKey(8))

        def j_loss(q, clean, noisy):
            return jnp.mean((m.apply(q, noisy) - clean) ** 2)
    else:
        sigmas = j_score.geometric_sigmas(0.4, 0.05, 4, jnp.float64)
        _close(t_score.geometric_sigmas(0.4, 0.05, 4, torch.float64), sigmas, 1e-15)
        draw = _score_draw(jax.random.PRNGKey(9), sigmas)

        def j_loss(q, clean, sig, z):
            return jnp.mean((m.apply(q, clean + sig[:, None, None] * z, sig) - z) ** 2)
    t_loss = t_dncnn.denoiser_loss if kind == "dncnn" else t_score.score_loss
    j_project = jax.jit(lambda q: j_dncnn.project_conv_kernels(q, 1.05))
    opt = optax.adam(lr)
    state = opt.init(p)

    @jax.jit
    def jstep(p, state, *batch):
        upd, state = opt.update(jax.grad(j_loss)(p, *batch), state)
        return optax.apply_updates(p, upd), state

    for i in range(10):
        batch = draw(i)
        net = _port(kind, p)
        moments = state[0]
        mus, nus = _port(kind, moments.mu), _port(kind, moments.nu)

        opt_t = torch.optim.Adam(net.parameters(), lr=lr)
        for w, mu, nu in zip(net.parameters(), mus.parameters(), nus.parameters()):
            opt_t.state[w] = {"step": torch.tensor(float(moments.count)),
                              "exp_avg": mu.detach().clone(), "exp_avg_sq": nu.detach().clone()}
        t_loss(net, *(_t64(a) for a in batch)).backward()
        opt_t.step()
        project = kind == "dncnn" and (i + 1) % 4 == 0
        if project:
            t_dncnn.project_conv_kernels(net, 1.05)
        p, state = jstep(p, state, *batch)
        if project:
            p = j_project(p)
        _assert_same_params(net, kind, p, TOL_ADAM)


def test_port_trainers_run_and_learn():
    """The port's own trainers (Philox batches, flax-style init): finite,
    deterministic, and the DnCNN beats the noisy input on a fresh phantom."""
    model = t_dncnn.train_denoiser((0, 1), noise_sigma=0.1, patch=16, batch=8, steps=60,
                                   depth=3, features=8, spectral_norm=1.5,
                                   dtype=torch.float64)
    again = t_dncnn.train_denoiser((0, 1), noise_sigma=0.1, patch=16, batch=8, steps=60,
                                   depth=3, features=8, spectral_norm=1.5,
                                   dtype=torch.float64)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    assert max(t_dncnn.conv_operator_norms(model).values()) <= 1.5 + 1e-9
    clean = t_syn.random_phantom((9, 9), 16, dtype=torch.float64)
    noisy = clean + 0.1 * normal_field(9, 10, 0, clean.shape, torch.float64, "cpu")
    out = t_dncnn.make_denoiser(model)(noisy)
    assert float(((out - clean) ** 2).mean()) < float(((noisy - clean) ** 2).mean())
    for arch, cls in (("cnn", "photo"), ("unet", "terrain")):
        net, sig = t_score.train_score_net((1, 2), steps=3, patch=16, batch=2, depth=3,
                                           features=4, arch=arch, unet_features=(4, 6, 8),
                                           image_class=cls, dtype=torch.float64)
        assert sig.shape == (10,)
        assert bool(torch.isfinite(net(torch.zeros(1, 16, 16, dtype=torch.float64),
                                       torch.ones(1, dtype=torch.float64))).all())


def test_lecun_init_matches_flax_scales():
    """Truncated LeCun-normal kernels (std sqrt(1/fan_in), |z| <= 2 sd) and
    zero biases, as flax initialises."""
    net = t_dncnn.lecun_init(t_score.ScoreUNet((16, 32, 48)).double(), (3, 4))
    for m in net.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
            w = m.weight
            std = (1.0 / t_dncnn._fan_in(m)) ** 0.5
            assert float(w.abs().max()) <= 2 * std / t_dncnn._TRUNC + 1e-12
            if w.numel() > 2000:
                assert abs(float(w.std()) / std - 1.0) < 0.1
            assert float(m.bias.abs().max()) == 0.0


# ---- synthetic data -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_random_photo_patch_matches_jax_given_draws(seed, monkeypatch):
    # the JAX package's bank from the port's decode, held byte for byte to
    # its own in tests/test_torch_png_images.py (the decode takes seconds)
    monkeypatch.setattr(j_png, "read_png_gray", lambda path: t_images._decoded(
        Path(path).stem).copy())
    jbank = j_syn.photo_bank(jnp.float64)
    tbank = t_syn.photo_bank(torch.float64)
    np.testing.assert_array_equal(_np(tbank), np.asarray(jbank))
    n = 24
    key = jax.random.PRNGKey(seed)
    k_im, k_y, k_x, k_f = jax.random.split(key, 4)
    i = int(jax.random.randint(k_im, (), 0, 2))
    y0 = int(jax.random.randint(k_y, (), 0, 512 - n + 1))
    x0 = int(jax.random.randint(k_x, (), 0, 512 - n + 1))
    flips = [bool(f) for f in jax.random.bernoulli(k_f, 0.5, (3,))]
    want = j_syn.random_photo_patch(key, n, jbank)
    t = torch.tensor
    got = t_syn.crop_patches(tbank, n, t([i]), t([y0]), t([x0]), t([flips[0]]),
                             t([flips[1]]), t([flips[2]]))[0]
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_synthetic_batches_statistics():
    """tests/test_score.py's and tests/test_pnp_inpainting.py's checks on the
    port's generators: shape, range, distinct draws, texture, determinism,
    and each photo patch a crop of a source under a dihedral transform."""
    ph = t_syn.random_phantom_batch((1, 0, 4), 4, 24)
    assert ph.shape == (4, 24, 24) and float(ph.min()) >= 0.0 and float(ph.max()) <= 1.0
    assert float((ph[0] - ph[1]).abs().max()) > 0.05
    tr = t_syn.random_terrain_batch((0, 0, 1), 4, 32)
    a = _np(tr)
    assert a.shape == (4, 32, 32) and (a >= 0).all() and (a <= 1).all()
    assert np.std(a[0]) > 0.01 and not np.allclose(a[0], a[1])
    photo = t_syn.random_photo_batch((3, 0, 2), 6, 24, dtype=torch.float64)
    p = _np(photo)
    assert p.shape == (6, 24, 24) and (p >= 0).all() and (p <= 1).all()
    assert np.std(p[0]) > 0.005 and not np.allclose(p[0], p[1])
    np.testing.assert_array_equal(p, _np(t_syn.random_photo_batch((3, 0, 2), 6, 24,
                                                                  dtype=torch.float64)))
    assert not np.allclose(p, _np(t_syn.random_photo_batch((3, 0, 3), 6, 24,
                                                           dtype=torch.float64)))
    bank = _np(t_syn.photo_bank(torch.float64))
    for patch in p[:2]:
        found = False
        for t in (patch, patch[::-1], patch[:, ::-1], patch.T, patch[::-1, ::-1],
                  patch[::-1].T, patch[:, ::-1].T, patch[::-1, ::-1].T):
            # candidates by the top-left value, then the whole window
            for i, y, x in zip(*np.nonzero(bank[:, :489, :489] == t[0, 0])):
                found = found or bool((bank[i, y:y + 24, x:x + 24] == t).all())
        assert found


def test_terrain_quantile_matches_numpy():
    v = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 101)))
    q = torch.tensor([0.35, 0.5, 0.749])
    want = [np.quantile(v[i].numpy(), float(q[i])) for i in range(3)]
    np.testing.assert_allclose(_np(t_syn._quantile(v, q.double())), want, rtol=1e-14)


# ---- samplers --------------------------------------------------------------


def _grad_f(x):
    return 2.0 * (x - 0.5)


def _sampler(pkg, name, net, box=(0.0, 1.0)):
    """The sampler ``name`` of package ``pkg`` over the net: an annealed
    sigma schedule for the score samplers."""
    sched = np.geomspace(0.4, 0.05, 8)
    tau = 0.5 / (2.0 + 0.8 / sched**2)
    if pkg == "jax":
        m, p = net
        if name == "pnp_ula":
            den = j_dncnn.make_denoiser(p, m.apply)
            return j_img.pnp_ula(_grad_f, den, 0.01, eps=0.04, alpha=0.8, box=box)
        score = j_score.make_score_fn(p, m.apply)
        sig, tau = jnp.asarray(sched), jnp.asarray(tau)
    else:
        if name == "pnp_ula":
            return t_img.pnp_ula(_grad_f, t_dncnn.make_denoiser(net), 0.01, eps=0.04,
                                 alpha=0.8, box=box)
        score = t_score.make_score_fn(net)
        sig, tau = torch.from_numpy(sched), torch.from_numpy(tau)
    mod = j_img if pkg == "jax" else t_img
    kw = dict(alpha=0.8, box=box, box_weight=0.04)
    if name == "score_ula":
        return mod.score_ula(_grad_f, score, sig, tau, **kw)
    return mod.score_ula_pc(_grad_f, score, sig, tau, n_corrector=2, snr=0.2, **kw)


@pytest.mark.parametrize("name", ["pnp_ula", "score_ula", "score_ula_pc"])
def test_sampler_matches_jax_injected_noise(monkeypatch, name):
    n_streams = 3 if name == "score_ula_pc" else 1
    kind = "dncnn" if name == "pnp_ula" else "cnn"
    m, p = _jax_net(kind)
    net = _port(kind, p)
    x0 = np.random.default_rng(9).random((N, N))
    noise = iter([jnp.asarray(_np(normal_field(SEED, CHAIN, i, (N, N), torch.float64, "cpu",
                                               stream=j)))
                  for i in range(8) for j in range(n_streams)])
    monkeypatch.setattr(j_img, "normal_like", lambda key, x: next(noise))
    jk, tk = _sampler("jax", name, (m, p)), _sampler("torch", name, net)
    js, ts = jk.init(jnp.asarray(x0)), tk.init(torch.from_numpy(x0))
    base = jax.random.PRNGKey(0)
    for i in range(8):
        js, _ = jk.step(js, step_key(base, i))
        ts, _ = tk.step(ts, (SEED, CHAIN, ts.step))
    assert ts.step == 8
    _close(ts.position, js.position, TOL_STEP, name)


def _tiny_score():
    return _port("cnn", _jax_net("cnn")[1])


def test_fixed_sigma_score_ula_equals_pnp_ula():
    score = t_score.make_score_fn(_tiny_score())
    sigma, alpha, tau = 0.2, 0.8, 0.01
    ka = t_img.score_ula(_grad_f, score, sigma, tau, alpha=alpha, box=(0.0, 1.0),
                         box_weight=sigma**2)
    kb = t_img.pnp_ula(_grad_f, t_score.score_to_denoiser(score, sigma), tau,
                       eps=sigma**2, alpha=alpha, box=(0.0, 1.0))
    x0 = 0.5 * torch.ones((10, 10), dtype=torch.float64)
    a = run_chain(ka, x0, (SEED, CHAIN), 5, collect="last").final_state.position
    b = run_chain(kb, x0, (SEED, CHAIN), 5, collect="last").final_state.position
    _close(a, _np(b), TOL_STEP)


def test_annealed_schedule_consumed_per_step_and_segmented():
    sig = torch.linspace(0.5, 0.05, 12, dtype=torch.float64)
    tau = 0.1 * sig**2

    def score(x, s):
        return -x * s

    kern = t_img.score_ula(lambda x: 0.1 * x, score, sig, tau)
    x0 = torch.ones((5, 5), dtype=torch.float64)
    st, ref = kern.init(x0), x0
    for i in range(4):
        st, _ = kern.step(st, (SEED, CHAIN, i))
        t, s = tau[i], sig[i]
        xi = normal_field(SEED, CHAIN, i, (5, 5), torch.float64, "cpu")
        ref = ref + t * (-0.1 * ref - ref * s) + torch.sqrt(2 * t) * xi
    assert torch.equal(st.position, ref)
    mono = run_chain(kern, x0, (SEED, CHAIN), 12, collect="stats", burn_in=3)
    seg = run_chain_segmented(kern, x0, (SEED, CHAIN), 12, segment_steps=5, burn_in=3)
    assert torch.equal(mono.final_state.position, seg.final_state.position)
    assert torch.equal(mono.moments.mean, seg.moments.mean)


def test_zero_correctors_equal_score_ula_exactly():
    score = t_score.make_score_fn(_tiny_score())
    sig = torch.linspace(0.4, 0.1, 6, dtype=torch.float64)
    kw = dict(alpha=0.8, box=(0.0, 1.0), box_weight=0.04)
    ka = t_img.score_ula(_grad_f, score, sig, 0.01, **kw)
    kb = t_img.score_ula_pc(_grad_f, score, sig, 0.01, n_corrector=0, **kw)
    x0 = 0.5 * torch.ones((3, 10, 10), dtype=torch.float64)
    a = run_chains(ka, x0, (SEED, CHAIN), 6, 3, collect="last").final_state.position
    b = run_chains(kb, x0, (SEED, CHAIN), 6, 3, collect="last").final_state.position
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["pnp_ula", "score_ula", "score_ula_pc"])
def test_chain_axis_equals_one_chain_runs(name):
    """``run_chains`` steps the block of chains with one net call; each row
    equals its chain run alone (f64 on the CPU: to the last bits' order)."""
    kind = "dncnn" if name == "pnp_ula" else "cnn"
    kern = _sampler("torch", name, _port(kind, _jax_net(kind)[1]))
    assert kern.chain_axis
    x0 = torch.from_numpy(np.random.default_rng(2).random((N, N)))
    many = run_chains(kern, x0, (SEED, CHAIN), 6, 4, collect="stats", burn_in=2)
    from lmc_atomi_torch.core.random import chain_keys

    for c, key in enumerate(chain_keys((SEED, CHAIN), 4)):
        one = run_chain(kern, x0, key, 6, collect="stats", burn_in=2)
        _close(many.final_state.position[c], _np(one.final_state.position), TOL_STEP)
        _close(many.moments.mean[c], _np(one.moments.mean), TOL_STEP)
