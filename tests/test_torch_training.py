"""Port parity of the 3DGS training path against the JAX package: gradients
of projection, SH and transforms against ``jax.grad``; losses (SSIM on
flat regions too); selective Adam; the DefaultStrategy's grow and prune;
and one ``Runner`` step of each package from the same state (carried
across with ``tdgs_torch.convert``), with the packed rasterizer (Pallas in
interpret mode on the JAX side).

Tolerances: gradients of projection/SH/transforms max|Δ| ≤ 1e-4·max|ref|;
losses 1e-5; Adam 1e-6; the Runner step: Adam moments within 1e-3 of their
max, parameters equal where |g| > 1e-3·max|g| (within 1e-3 of the step's
size) and within 6.4·lr elsewhere, where a tiny gradient's sign can flip
between the packages and the uncorrected first-moment step is ≈ 3.16·lr.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs.models import gaussians as jg
from tdgs.ops import projection as jproj
from tdgs.ops import sh as jsh
from tdgs.ops import transforms as jtf
from tdgs.ops.adam import selective_adam as j_selective_adam
from tdgs.strategy import DefaultStrategy as JDefault
from tdgs.strategy import ops as jops
from tdgs.training import losses as jl
from tdgs_torch import convert
from tdgs_torch.models import gaussians as tg
from tdgs_torch.ops import projection as tproj
from tdgs_torch.ops import sh as tsh
from tdgs_torch.ops import transforms as ttf
from tdgs_torch.ops.adam import selective_adam as t_selective_adam
from tdgs_torch.strategy import DefaultStrategy as TDefault
from tdgs_torch.strategy import ops as tops
from tdgs_torch.training import losses as tl

GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier runs six test processes on the machine's cores: two
    intra-op threads each keep PyTorch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close_rel(got, want, rtol, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{name}: max|Δ| {err} > {rtol} · {scale}"


def _jax_and_torch_grads(j_fn, t_fn, inputs, weights):
    """Gradients of Σ_k <out_k, w_k> w.r.t. every input, in both packages."""
    def j_loss(*xs):
        outs = j_fn(*xs)
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

    jg_ = jax.grad(j_loss, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(x) for x in inputs])
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    outs = t_fn(*ts)
    loss = sum((o * torch.from_numpy(np.asarray(w))).sum() for o, w in zip(outs, weights))
    tg_ = torch.autograd.grad(loss, ts, allow_unused=True)
    return ([np.asarray(g) for g in jg_],
            [np.zeros_like(x) if g is None else g.numpy() for g, x in zip(tg_, inputs)])


def _projection_inputs(seed, N=96):
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(N, 3)) * [1.5, 1.0, 2.0] + [0, 0, 3]).astype(np.float32)
    means[:8, 2] = -np.abs(means[:8, 2]) - 0.5  # behind the camera
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    scales = rng.uniform(0.02, 0.4, size=(N, 3)).astype(np.float32)
    opac = rng.uniform(0.0, 1.0, size=(N,)).astype(np.float32)
    opac[8:14] = 1e-3  # culled by the opacity threshold
    viewmats = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    viewmats[1, :3, 3] = [0.3, -0.2, 0.5]
    Ks = np.tile(np.array([[60.0, 0, 32], [0, 60, 24], [0, 0, 1]], np.float32), (2, 1, 1))
    return rng, means, quats, scales, opac, viewmats, Ks


@pytest.mark.parametrize("antialiased", [True])  # also the classic outputs
def test_projection_gradients_match_jax(antialiased):
    rng, means, quats, scales, opac, viewmats, Ks = _projection_inputs(3)
    C, N = 2, means.shape[0]
    weights = [rng.normal(size=(C, N, 2)).astype(np.float32),
               rng.normal(size=(C, N)).astype(np.float32),
               rng.normal(size=(C, N, 3)).astype(np.float32)]
    if antialiased:
        weights.append(rng.normal(size=(C, N)).astype(np.float32))

    def run(proj, vm, K, op):
        def fn(m, q, s, o):
            out = proj.fully_fused_projection(m, q, s, vm, K, 64, 48, opacities=o,
                                              calc_compensations=antialiased)
            # the opacities only cull (radii); their gradient is zero
            _, means2d, depths, conics, comp = out
            return [means2d, depths, conics] + ([comp] if antialiased else [])
        return fn

    want, got = _jax_and_torch_grads(
        run(jproj, jnp.asarray(viewmats), jnp.asarray(Ks), None),
        run(tproj, torch.from_numpy(viewmats), torch.from_numpy(Ks), None),
        [means, quats, scales, opac], weights)
    for name, g, w in zip(("means", "quats", "scales", "opacities"), got, want):
        assert np.isfinite(g).all(), name
        if name == "opacities":
            assert not np.abs(g).any() and not np.abs(w).any()
            continue
        _close_rel(g, w, GRAD_RTOL, name)


@pytest.mark.parametrize("degree", [0, 1, 3])
def test_sh_gradients_match_jax(degree):
    rng = np.random.default_rng(10 + degree)
    dirs = rng.normal(size=(2, 50, 3)).astype(np.float32)
    coeffs = rng.normal(size=(2, 50, 16, 3)).astype(np.float32)
    masks = rng.uniform(size=(2, 50)) > 0.2
    weights = [rng.normal(size=(2, 50, 3)).astype(np.float32)]
    want, got = _jax_and_torch_grads(
        lambda d, c: [jsh.spherical_harmonics(degree, d, c, masks=jnp.asarray(masks))],
        lambda d, c: [tsh.spherical_harmonics(degree, d, c, masks=torch.from_numpy(masks))],
        [dirs, coeffs], weights)
    for name, g, w in zip(("dirs", "coeffs"), got, want):
        _close_rel(g, w, GRAD_RTOL, name)


def test_transform_gradients_match_jax():
    rng = np.random.default_rng(21)
    quats = rng.normal(size=(40, 4)).astype(np.float32)
    scales = rng.uniform(0.05, 0.5, size=(40, 3)).astype(np.float32)
    weights = [rng.normal(size=(40, 3, 3)).astype(np.float32) for _ in range(2)]
    want, got = _jax_and_torch_grads(
        lambda q, s: list(jtf.quat_scale_to_covar_preci(q, s)),
        lambda q, s: list(ttf.quat_scale_to_covar_preci(q, s)),
        [quats, scales], weights)
    for name, g, w in zip(("quats", "scales"), got, want):
        _close_rel(g, w, GRAD_RTOL, name)


def test_losses_match_jax_and_ssim_stays_finite_on_flat_regions():
    rng = np.random.default_rng(4)
    pred = rng.uniform(size=(2, 40, 36, 3)).astype(np.float32)
    gt = rng.uniform(size=(2, 40, 36, 3)).astype(np.float32)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(gt)
    jp, jt = jnp.asarray(pred), jnp.asarray(gt)
    for name in ("l1_loss", "mse_loss", "psnr", "ssim", "d_ssim_l1_loss"):
        # SSIM of unrelated images is near 0: an absolute floor of 1e-6
        np.testing.assert_allclose(float(getattr(tl, name)(tp, tt)),
                                   float(getattr(jl, name)(jp, jt)), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # the loss's gradient w.r.t. the render
    p = torch.tensor(pred, requires_grad=True)
    tl.d_ssim_l1_loss(p, tt).backward()
    jgrad = jax.grad(lambda x: jl.d_ssim_l1_loss(x, jt))(jp)
    _close_rel(p.grad.numpy(), np.asarray(jgrad), 1e-4, "d loss / d pred")
    # flat images: E[x²] − E[x]² cancels; SSIM stays finite and ≈ 1
    flat = torch.full((1, 32, 32, 3), 0.7314)
    s = tl.ssim(flat, flat + 1e-4)
    assert torch.isfinite(s) and abs(float(s) - 1.0) < 1e-3
    f = flat.clone().requires_grad_(True)
    tl.d_ssim_l1_loss(f, flat + 0.01).backward()
    assert bool(torch.isfinite(f.grad).all())


def test_selective_adam_matches_jax_without_bias_correction():
    rng = np.random.default_rng(6)
    params = {"a": rng.normal(size=(10, 3)).astype(np.float32),
              "b": rng.normal(size=(10,)).astype(np.float32)}
    vis = rng.uniform(size=10) > 0.4
    j_init, t_init = j_selective_adam(1e-2), t_selective_adam(1e-2)
    js = j_init.init({k: jnp.asarray(v) for k, v in params.items()})
    ti, tu = t_init
    ts = ti({k: torch.from_numpy(v) for k, v in params.items()})
    for it in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        j_steps, js = j_init.update({k: jnp.asarray(v) for k, v in grads.items()}, js,
                                    visibility=jnp.asarray(vis))
        t_steps, ts = tu({k: torch.from_numpy(v) for k, v in grads.items()}, ts,
                         visibility=torch.from_numpy(vis))
        for k in params:
            np.testing.assert_allclose(t_steps[k].numpy(), np.asarray(j_steps[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ts.exp_avg[k].numpy(), np.asarray(js.exp_avg[k]),
                                       rtol=1e-6, atol=1e-7)
        if it == 0:
            # no bias correction: the first visible step is ≈ lr·(1−b1)/√(1−b2)
            g = grads["a"]
            want = -1e-2 * 0.1 * g / (np.sqrt(0.001 * g * g) + 1e-8)
            np.testing.assert_allclose(t_steps["a"].numpy()[vis], want[vis], rtol=1e-5)
            assert (t_steps["a"].numpy()[~vis] == 0).all()
    assert ts.count == int(js.count) == 3
    # the JAX state carried across
    back = convert.adam_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    assert back.count == 3
    np.testing.assert_array_equal(back.exp_avg_sq["b"].numpy(), np.asarray(js.exp_avg_sq["b"]))


def _strategy_inputs(seed, C=300):
    rng = np.random.default_rng(seed)
    n_alive = 200
    params = {
        "means": rng.normal(size=(C, 3)).astype(np.float32),
        "quats": rng.normal(size=(C, 4)).astype(np.float32),
        "scales": np.log(rng.uniform(0.001, 0.2, size=(C, 3))).astype(np.float32),
        "opacities": rng.normal(size=(C,)).astype(np.float32),
        "sh0": rng.normal(size=(C, 1, 3)).astype(np.float32),
        "shN": rng.normal(size=(C, 3, 3)).astype(np.float32),
    }
    params["opacities"][n_alive:] = jg.DEAD_OPACITY_LOGIT
    opt = {"mu": {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()},
           "nu": {k: rng.uniform(size=v.shape).astype(np.float32) for k, v in params.items()}}
    grad2d = rng.uniform(0, 0.02, size=C).astype(np.float32)
    count = rng.integers(1, 30, size=C).astype(np.float32)
    radii_norm = rng.uniform(0, 0.3, size=C).astype(np.float32)
    return params, opt, grad2d, count, radii_norm


@pytest.mark.parametrize("use_scale2d,prune_too_big,revised",
                         [(False, False, False), (True, True, True)])
def test_grow_and_prune_matches_jax(use_scale2d, prune_too_big, revised):
    """Masks and counts agree; every row no random draw touches agrees;
    the split children (random draws) are compared by distribution."""
    params, opt, grad2d, count, radii_norm = _strategy_inputs(5)
    kw = dict(grow_grad2d=2e-4, use_scale2d=use_scale2d,
              prune_too_big=prune_too_big, revised_opacity=revised)
    jp, jo, jinfo = jops.grow_and_prune_default(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, opt),
        jax.random.PRNGKey(0), jnp.asarray(grad2d), jnp.asarray(count),
        jnp.asarray(radii_norm), 1.0, **kw)
    tp, to, tinfo = tops.grow_and_prune_default(
        convert.tree_from_numpy(params, "cpu"), convert.tree_from_numpy(opt, "cpu"),
        torch.Generator().manual_seed(0), torch.from_numpy(grad2d),
        torch.from_numpy(count), torch.from_numpy(radii_norm), 1.0, **kw)
    for k in ("n_dupli", "n_split", "n_prune", "n_granted"):
        assert int(tinfo[k]) == int(jinfo[k]), k
    assert int(tinfo["n_granted"]) > 0 and int(tinfo["n_split"]) > 0

    jpn = {k: np.asarray(v) for k, v in jp.items()}
    tpn = {k: v.numpy() for k, v in tp.items()}
    # rows whose means came from a draw: split parents and split children
    drawn = np.abs(jpn["means"] - params["means"]).max(-1) > 0
    drawn_t = np.abs(tpn["means"] - params["means"]).max(-1) > 0
    np.testing.assert_array_equal(drawn, drawn_t)
    for k in params:
        np.testing.assert_allclose(tpn[k][~drawn], jpn[k][~drawn], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
        if k != "means":
            np.testing.assert_allclose(tpn[k], jpn[k], rtol=1e-6, atol=1e-6, err_msg=k)
    for part in ("mu", "nu"):
        for k in params:
            np.testing.assert_array_equal(to[part][k].numpy(), np.asarray(jo[part][k]))


def test_split_children_distribution_matches_jax():
    """Children are mean + R·diag(s)·ε: in both packages the whitened
    offsets of the in-place children are standard normal (1000 splits)."""
    rng = np.random.default_rng(12)
    C = 2000
    params = {
        "means": rng.normal(size=(C, 3)).astype(np.float32),
        "quats": rng.normal(size=(C, 4)).astype(np.float32),
        "scales": np.log(rng.uniform(0.02, 0.2, size=(C, 3))).astype(np.float32),
        "opacities": np.where(np.arange(C) < 1000, 0.0, jg.DEAD_OPACITY_LOGIT).astype(np.float32),
    }
    ones = np.ones(C, np.float32)
    args = (ones, ones, np.zeros(C, np.float32), 1.0)
    jp, _, _ = jops.grow_and_prune_default(
        jax.tree.map(jnp.asarray, params), {}, jax.random.PRNGKey(1),
        *map(jnp.asarray, args[:3]), 1.0, grow_grad2d=0.5)
    tp, _, _ = tops.grow_and_prune_default(
        convert.tree_from_numpy(params, "cpu"), {}, torch.Generator().manual_seed(1),
        *map(torch.from_numpy, args[:3]), 1.0, grow_grad2d=0.5)
    R = np.asarray(jtf.quat_to_rotmat(jnp.asarray(params["quats"])))[:1000]
    for got in (np.asarray(jp["means"]), tp["means"].numpy()):
        d = got[:1000] - params["means"][:1000]
        z = np.einsum("nji,nj->ni", R, d) / np.exp(params["scales"][:1000])
        assert np.abs(z.mean(0)).max() < 0.12, z.mean(0)
        assert np.abs(z.std(0) - 1.0).max() < 0.08, z.std(0)


def test_default_strategy_state_and_reset_match_jax():
    params, opt, *_ = _strategy_inputs(8)
    rng = np.random.default_rng(8)
    C = params["means"].shape[0]
    v = rng.normal(size=(2, C, 2)).astype(np.float32) * 1e-3
    radii = rng.integers(0, 5, size=(2, C, 2)).astype(np.int32)
    js, ts = JDefault(), TDefault()
    jstate = js.initialize_state(jax.tree.map(jnp.asarray, params), scene_scale=2.0)
    tstate = ts.initialize_state(convert.tree_from_numpy(params, "cpu"), scene_scale=2.0)
    info_j = {"radii": jnp.asarray(radii), "width": 64, "height": 48}
    info_t = {"radii": torch.from_numpy(radii), "width": 64, "height": 48}
    jstate = js.update_state(jstate, info_j, jnp.asarray(v))
    tstate = ts.update_state(tstate, info_t, torch.from_numpy(v))
    for k in ("grad2d", "count", "radii_norm"):
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), rtol=1e-6, err_msg=k)
    jp, jo = jops.reset_opacities(jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, opt), 0.01)
    tp, to = tops.reset_opacities(convert.tree_from_numpy(params, "cpu"),
                                  convert.tree_from_numpy(opt, "cpu"), 0.01)
    np.testing.assert_array_equal(tp["opacities"].numpy(), np.asarray(jp["opacities"]))
    np.testing.assert_array_equal(to["mu"]["opacities"].numpy(), np.asarray(jo["mu"]["opacities"]))
    # capacity growth pads dead rows, zero moments
    grown = tg.pad_splats(convert.tree_from_numpy(params, "cpu"), C + 64)
    want = jg.pad_splats(jax.tree.map(jnp.asarray, params), C + 64)
    for k in params:
        np.testing.assert_array_equal(grown[k].numpy(), np.asarray(want[k]), err_msg=k)
    padded = tops.pad_rows(convert.tree_from_numpy(opt, "cpu"), C, C + 64)
    assert padded["mu"]["means"].shape == (C + 64, 3)
    assert float(padded["nu"]["shN"][C:].abs().max()) == 0.0


def test_knn_and_create_splats_layout_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    np.testing.assert_allclose(tg.knn_mean_dist(torch.from_numpy(pts)).numpy(),
                               np.asarray(jg.knn_mean_dist(jnp.asarray(pts))), rtol=1e-5)
    rgbs = rng.uniform(size=(300, 3)).astype(np.float32)
    t = tg.create_splats(torch.from_numpy(pts), torch.from_numpy(rgbs),
                         torch.Generator().manual_seed(0), sh_degree=2, n_max=512)
    j = jg.create_splats(jnp.asarray(pts), jnp.asarray(rgbs), jax.random.PRNGKey(0),
                         sh_degree=2, n_max=512)
    for k in j:
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        if k != "quats":  # random draws
            np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tg.alive_mask(t).numpy(), np.asarray(jg.alive_mask(j)))


# ---------------------------------------------------------------------------
# one Runner step of each package from the same state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tdgs_torch.utils.test_data import make_colmap_test_scene

    root = str(tmp_path_factory.mktemp("scene"))
    make_colmap_test_scene(root, device="cpu")
    return root


def _configs(scene, tmp, absgrad):
    from tdgs.training.config import Config as JConfig
    from tdgs_torch.training.config import Config as TConfig

    kw = dict(data_dir=scene, data_factor=1, max_steps=1, eval_steps=[], save_steps=[],
              sh_degree=1, sh_degree_interval=1, capacity=512, tile_capacity=256,
              isect_capacity=1 << 14, test_every=4, tb_every=1, rasterizer="packed",
              background_color=(0.1, 0.2, 0.3), seed=3)
    sk = dict(refine_start_iter=0, refine_every=1000, reset_every=10_000, absgrad=absgrad)
    return (JConfig(result_dir=str(tmp / "j"), strategy=JDefault(**sk), data_prefetch=False,
                    **kw),
            TConfig(result_dir=str(tmp / "t"), strategy=TDefault(**sk), **kw))


@pytest.mark.parametrize("absgrad", [False, True])
def test_one_runner_step_matches_jax(scene, tmp_path, absgrad):
    from tdgs.training.trainer import Runner as JRunner
    from tdgs_torch.training.trainer import Runner as TRunner

    jcfg, tcfg = _configs(scene, tmp_path, absgrad)
    jr = JRunner(jcfg)
    rng = np.random.default_rng(11)
    # a mid-training state: perturbed splats, nonzero moments and accumulators
    splats = {k: np.asarray(v) for k, v in jr.splats.items()}
    alive = np.asarray(jg.alive_mask(jr.splats))
    splats["shN"] = np.where(alive[:, None, None],
                             rng.normal(size=splats["shN"].shape) * 0.1, 0).astype(np.float32)
    opt = {part: {k: (rng.uniform(0, 1e-4, size=v.shape) if part == "nu"
                      else rng.normal(size=v.shape) * 1e-3).astype(np.float32)
                  for k, v in splats.items()} for part in ("mu", "nu")}
    strat = {"grad2d": rng.uniform(size=512).astype(np.float32),
             "count": rng.integers(1, 5, size=512).astype(np.float32),
             "radii_norm": np.zeros(512, np.float32), "scene_scale": jr.scene_scale}
    jr.splats = jax.tree.map(jnp.asarray, splats)
    jr.opt_state = jax.tree.map(jnp.asarray, opt)
    jr.strategy_state = dict(jr.strategy_state, **{k: jnp.asarray(v) for k, v in strat.items()
                                                   if k != "scene_scale"})
    state0 = {"step": 0, "splats": splats, "opt_state": opt, "strategy_state": strat}

    tr = TRunner(tcfg, device="cpu")
    assert tr.scene_scale == pytest.approx(jr.scene_scale)
    tr.load_state_numpy(convert.runner_state_from_numpy(state0, device="cpu"))
    j_hist = jr.train()["history"]
    t_hist = tr.train()["history"]
    np.testing.assert_allclose(t_hist[0]["loss"], j_hist[0]["loss"], rtol=1e-4)

    after = convert.runner_state_to_numpy({"step": 1, "splats": tr.splats,
                                           "opt_state": tr.opt_state,
                                           "strategy_state": tr.strategy_state})
    lr = tr.optimizer.lr_at(1)
    for k in splats:
        jmu = np.asarray(jr.opt_state["mu"][k])
        for part in ("mu", "nu"):
            _close_rel(after["opt_state"][part][k], np.asarray(jr.opt_state[part][k]), 1e-3,
                       f"{part}[{k}]")
        # the gradient, recovered from the first moment
        g = (jmu - 0.9 * opt["mu"][k]) / 0.1
        strong = np.abs(g) > 1e-3 * np.abs(g).max()
        got, want = after["splats"][k], np.asarray(jr.splats[k])
        step = np.abs(want - splats[k]).max()
        np.testing.assert_allclose(got[strong], want[strong], rtol=0,
                                   atol=1e-3 * step + 1e-7, err_msg=k)
        assert np.abs(got - want).max() <= 6.4 * lr[k], k
    for k in ("grad2d", "count"):
        _close_rel(after["strategy_state"][k], np.asarray(jr.strategy_state[k]), 1e-3, k)
    assert not np.array_equal(after["strategy_state"]["grad2d"], strat["grad2d"])


def test_runner_config_raises_for_unported_features(tmp_path):
    from tdgs_torch.training.config import Config

    base = Config(data_dir=str(tmp_path), result_dir=str(tmp_path / "r"))
    base.check_ported()
    dataclasses.replace(base, model_type="2dgs", normal_loss=True, dist_loss=True).check_ported()
    for change in (dict(pose_opt=True, pose_noise=1e-3), dict(app_opt=True),
                   dict(compression="png"), dict(use_bilateral_grid=True),
                   dict(model_type="2dgs", sharded=True), dict(sharded=True),
                   dict(ckpt_format="orbax"), dict(disable_viewer=False)):
        dataclasses.replace(base, **change).check_ported()
    with pytest.raises(ValueError, match="ckpt_format"):
        dataclasses.replace(base, ckpt_format="msgpack").check_ported()


@pytest.mark.parametrize("mode", ["RGB", "D", "ED", "RGB+D", "RGB+ED"])
def test_packed_rasterizer_render_modes(mode):
    """rasterizer="packed" renders every mode as "packed_inference" does,
    and its gradients reach every input, finite."""
    from tdgs_torch.rendering import rasterization

    rng, means, quats, scales, opac, viewmats, Ks = _projection_inputs(7, N=60)
    sh = rng.normal(size=(60, 4, 3)).astype(np.float32) * 0.3
    bg = np.array([[0.1, 0.2, 0.3], [0.3, 0.2, 0.1]], np.float32)
    leaves = [torch.tensor(x, requires_grad=True) for x in (means, quats, scales, opac, sh)]
    outs = {}
    for r in ("packed", "packed_inference"):
        img, alpha, meta = rasterization(*leaves, viewmats, Ks, 64, 48, sh_degree=1,
                                         backgrounds=bg, render_mode=mode, rasterizer=r,
                                         device="cpu")
        outs[r] = (img, alpha)
    for a, b in zip(outs["packed"], outs["packed_inference"]):
        torch.testing.assert_close(a.detach(), b, rtol=0, atol=1e-5)
    img, alpha = outs["packed"]
    grads = torch.autograd.grad(img.sum() + alpha.sum(), leaves, allow_unused=True)
    for name, g in zip(("means", "quats", "scales", "opacities", "sh"), grads):
        if mode in ("D", "ED") and name == "sh":
            assert g is None or not g.abs().any()  # depth only: no colour
            continue
        assert g is not None and bool(torch.isfinite(g).all()) and g.abs().any(), name
