"""Port parity of 3DGS rendering and training through the tile-dense
rasterizers against the JAX package: ``rasterization`` with
``rasterizer="jax"`` and ``"pallas"`` in every render mode (``meta``
included), its gradients and the AbsGS tap; one DefaultStrategy ``Runner``
step with ``Config(rasterizer="pallas")`` (and ``"jax"`` with absgrad) from
the same state as the JAX ``Runner``'s (carried across by
``tdgs_torch.convert``); and the image-fitting example, whose losses follow
the JAX example's from the same start.

Tolerances: renders 1e-5 absolute against the JAX "jax" rasterizer (the
same cumprod formulation; ED's depth channel relative 1e-4 where alpha >
0.1) and 1e-4 against the JAX "pallas" kernels in interpret mode; meta
equal; gradients max|Δ| ≤ 1e-3 · max|ref| per input (the projection and
SH gradients, as tests/test_torch_training.py holds them); the Runner step
as tests/test_torch_training.py holds the packed one; image fitting: the
initial loss 1e-6, the later logged losses 2e-3 relative, because the
example's gaussians all start at one depth and tie (see the test).
"""

import json
import os
import re
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tdgs
import tdgs_torch
from tdgs.models import gaussians as jg
from tdgs.strategy import DefaultStrategy as JDefault
from tdgs_torch import convert
from tdgs_torch.strategy import DefaultStrategy as TDefault

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))

DENSE_META = ("tiles_per_gauss", "isect_ids", "isect_depths", "flatten_ids",
              "isect_offsets")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier runs six test processes on the machine's cores: two
    intra-op threads each keep PyTorch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(seed, N=64, C=1):
    rng = np.random.default_rng(seed)
    means = (rng.normal(size=(N, 3)) + [0, 0, 5]).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    scales = rng.uniform(0.05, 0.3, size=(N, 3)).astype(np.float32)
    opac = rng.uniform(0.3, 1, size=(N,)).astype(np.float32)
    sh = (rng.normal(size=(N, 16, 3)) * 0.3).astype(np.float32)
    viewmats = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    viewmats[:, 0, 3] = np.linspace(-0.2, 0.2, C)
    Ks = np.tile(np.array([[60.0, 0, 32], [0, 60, 24], [0, 0, 1]], np.float32), (C, 1, 1))
    return means, quats, scales, opac, sh, viewmats, Ks


def _close_rel(got, want, rtol, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{name}: max|Δ| {err} > {rtol} · {scale}"


@pytest.mark.parametrize("mode", ["RGB", "D", "ED", "RGB+D", "RGB+ED"])
@pytest.mark.parametrize("rasterizer", ["jax", "pallas"])
def test_rasterization_render_modes_and_meta_match_jax(rasterizer, mode):
    means, quats, scales, opac, sh, viewmats, Ks = _scene(700, C=2)
    bg = np.array([[0.3, 0.5, 0.7], [0.1, 0.2, 0.3]], np.float32)
    kw = dict(sh_degree=2, render_mode=mode, tile_capacity=128, max_tiles_per_gauss=16)
    # the JAX "pallas" kernels in interpret mode only where the port's are
    # the kernels' plain versions, and only in two modes (interpret mode is slow)
    refs = ["jax"] + (["pallas"] if rasterizer == "pallas" and mode in ("RGB", "RGB+ED")
                      else [])
    got_c, got_a, meta = tdgs_torch.rasterization(
        means, quats, scales, opac, sh, viewmats, Ks, 64, 48, backgrounds=bg,
        rasterizer=rasterizer, device="cpu", **kw)
    got_c, got_a = got_c.numpy(), got_a.numpy()
    for ref in refs:
        want_c, want_a, want_meta = tdgs.rasterization(
            *map(jnp.asarray, (means, quats, scales, opac, sh, viewmats, Ks)), 64, 48,
            backgrounds=jnp.asarray(bg), rasterizer=ref, **kw)
        atol = 1e-5 if ref == "jax" else 1e-4
        want_c, want_a = np.asarray(want_c), np.asarray(want_a)
        assert got_c.shape == want_c.shape == (2, 48, 64, {"RGB": 3, "D": 1, "ED": 1}.get(
            mode, 4))
        np.testing.assert_allclose(got_a, want_a, rtol=0, atol=atol, err_msg=ref)
        if mode in ("ED", "RGB+ED"):
            seen = want_a[..., 0] > 0.1
            np.testing.assert_allclose(got_c[..., -1][seen], want_c[..., -1][seen],
                                       rtol=10 * atol, err_msg=ref)
            got_rest, want_rest = got_c[..., :-1], want_c[..., :-1]
        else:
            got_rest, want_rest = got_c, want_c
        # accumulated depth ~5 per unit alpha
        scale = 5.0 if mode in ("D", "RGB+D") else 1.0
        np.testing.assert_allclose(got_rest, want_rest, rtol=0, atol=scale * atol,
                                   err_msg=ref)
    assert set(want_meta) <= set(meta)
    for k in ("n_isects", "n_dropped"):
        assert meta[k] == int(want_meta[k]), k
    assert meta["n_isects"] > 0
    for k in DENSE_META:
        g, w = meta[k].numpy(), np.asarray(want_meta[k])
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _grads(lib, rasterizer, abs_tap):
    means, quats, scales, opac, sh, viewmats, Ks = _scene(701)
    rng = np.random.default_rng(702)
    tgt = rng.uniform(size=(1, 48, 64, 3)).astype(np.float32)
    offset = np.zeros((1, 64, 2), np.float32)
    inputs = (means, quats, scales, opac, sh, offset) + ((offset,) if abs_tap else ())
    kw = dict(sh_degree=3, tile_capacity=128, rasterizer=rasterizer,
              backgrounds=np.array([[0.2, 0.4, 0.6]], np.float32))
    if lib == "jax":
        def loss(m, q, s, o, h, off, *tap):
            img, alpha, _ = tdgs.rasterization(
                m, q, s, o, h, jnp.asarray(viewmats), jnp.asarray(Ks), 64, 48,
                means2d_offset=off, means2d_abs_tap=tap[0] if tap else None,
                **dict(kw, backgrounds=jnp.asarray(kw["backgrounds"])))
            return jnp.sum((img - tgt) ** 2) + 0.1 * jnp.sum(alpha)

        g = jax.jit(jax.grad(loss, argnums=tuple(range(len(inputs)))))(
            *map(jnp.asarray, inputs))
        return [np.asarray(x) for x in g]
    leaves = [torch.tensor(x, requires_grad=True) for x in inputs]
    img, alpha, _ = tdgs_torch.rasterization(
        *leaves[:5], viewmats, Ks, 64, 48, means2d_offset=leaves[5],
        means2d_abs_tap=leaves[6] if abs_tap else None, device="cpu", **kw)
    loss = ((img - torch.from_numpy(tgt)) ** 2).sum() + 0.1 * alpha.sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("rasterizer,abs_tap", [("pallas", False), ("jax", True)])
def test_rasterization_gradients_match_jax(rasterizer, abs_tap):
    """Gradients of every input and of the screen-space taps (the
    DefaultStrategy's means2d offset; AbsGS on "jax") against jax.grad of
    the JAX "jax" rasterizer."""
    got = _grads("torch", rasterizer, abs_tap)
    want = _grads("jax", "jax", abs_tap)
    names = ("means", "quats", "scales", "opacities", "sh", "means2d_offset", "abs_tap")
    for name, g, w in zip(names, got, want):
        assert np.abs(w).max() > 0, name
        _close_rel(g, w, 1e-3, name)


def test_pallas_refuses_the_absgrad_tap():
    means, quats, scales, opac, sh, viewmats, Ks = _scene(703, N=8)
    with pytest.raises(ValueError, match="means2d_abs_tap"):
        tdgs_torch.rasterization(means, quats, scales, opac, sh[:, 0], viewmats, Ks, 64, 48,
                                 rasterizer="pallas", means2d_abs_tap=np.zeros((1, 8, 2)),
                                 device="cpu")


# ---------------------------------------------------------------------------
# one Runner step of each package from the same state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tdgs_torch.utils.test_data import make_colmap_test_scene

    root = str(tmp_path_factory.mktemp("scene"))
    make_colmap_test_scene(root, device="cpu")
    return root


@pytest.mark.parametrize("rasterizer,absgrad", [("pallas", False), ("jax", True)])
def test_one_runner_step_matches_jax(scene, tmp_path, rasterizer, absgrad):
    from tdgs.training.config import Config as JConfig
    from tdgs.training.trainer import Runner as JRunner
    from tdgs_torch.training.config import Config as TConfig
    from tdgs_torch.training.trainer import Runner as TRunner

    kw = dict(data_dir=scene, data_factor=1, max_steps=1, eval_steps=[], save_steps=[],
              sh_degree=1, sh_degree_interval=1, capacity=512, tile_capacity=256,
              isect_capacity=1 << 14, test_every=4, tb_every=1, rasterizer=rasterizer,
              background_color=(0.1, 0.2, 0.3), seed=3)
    sk = dict(refine_start_iter=0, refine_every=1000, reset_every=10_000, absgrad=absgrad)
    jr = JRunner(JConfig(result_dir=str(tmp_path / "j"), strategy=JDefault(**sk), **kw))
    rng = np.random.default_rng(12)
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
    tr = TRunner(TConfig(result_dir=str(tmp_path / "t"), strategy=TDefault(**sk), **kw),
                 device="cpu")
    tr.load_state_numpy(convert.runner_state_from_numpy(
        {"step": 0, "splats": splats, "opt_state": opt, "strategy_state": strat},
        device="cpu"))
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


def test_simple_trainer_cli_trains_through_pallas(scene, tmp_path, capsys):
    from tdgs_torch.simple_trainer import main

    rc = main(["default", "--rasterizer", "pallas", "--data-dir", scene, "--result-dir",
               str(tmp_path / "o"), "--data-factor", "1", "--max-steps", "12",
               "--eval-steps", "12", "--save-steps", "", "--capacity", "256",
               "--tile-capacity", "256", "--sh-degree", "1", "--test-every", "4",
               "--tb-every", "4", "--disable-video", "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["psnr"] > 0


# ---------------------------------------------------------------------------
# the image-fitting example
# ---------------------------------------------------------------------------


def _logged_losses(text):
    return [float(m) for m in re.findall(r"^iter\s+\d+ loss ([0-9.]+)$", text, re.M)]


def test_image_fitting_follows_the_jax_example(capsys):
    """From the JAX example's own init_params, five Adam steps log the same
    losses, and the fits end at the same loss."""
    import image_fitting as j_fit
    from tdgs_torch import image_fitting as t_fit

    kw = dict(height=48, width=48, num_points=256, iterations=5, lr=2e-2, log_every=1)
    j_init, j_final, j_img = j_fit.fit(**kw)
    j_log = _logged_losses(capsys.readouterr().out)
    init = {k: np.asarray(v) for k, v in j_fit.init_params(jax.random.PRNGKey(42), 256).items()}
    t_init, t_final, t_img = t_fit.fit(**kw, init=init, device="cpu")
    t_log = _logged_losses(capsys.readouterr().out)
    assert len(t_log) == len(j_log) == 5
    np.testing.assert_allclose(t_init, j_init, rtol=1e-6)
    np.testing.assert_allclose(t_log[0], j_log[0], rtol=0, atol=1e-6)
    # every gaussian starts at depth 8 and Adam's first steps move each by
    # about ±lr, so depths tie in groups: a 1e-6 difference between the two
    # packages' parameters reorders tied gaussians in a tile
    np.testing.assert_allclose(t_log[1:] + [t_final], j_log[1:] + [j_final], rtol=2e-3)
    assert t_img.shape == j_img.shape and np.isfinite(t_img).all()
    back = convert.image_fitting_params_to_numpy(
        convert.image_fitting_params_from_numpy(init, device="cpu"))
    for k, v in init.items():
        np.testing.assert_array_equal(back[k], v)


def test_image_fitting_loss_drops():
    """The JAX example test's margin (tests/test_image_fitting.py), from the
    port's own seeded init_params, through the default kernel path."""
    from tdgs_torch import image_fitting as t_fit

    initial, final, img = t_fit.fit(height=48, width=48, num_points=256, iterations=60,
                                    lr=2e-2, log_every=0, device="cpu")
    assert final < 0.55 * initial, (initial, final)
    assert img.shape == (48, 48, 3) and np.isfinite(img).all()


def test_image_fitting_cli_and_unported_2dgs(tmp_path, capsys):
    from tdgs_torch import image_fitting as t_fit

    out = str(tmp_path / "fit.png")
    assert t_fit.main(["--height", "32", "--width", "32", "--num-points", "64",
                       "--iterations", "3", "--device", "cpu", "--save", out]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["rasterizer"] == "pallas" and not any(summary["launches"].values())
    assert os.path.getsize(out) > 0
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 4"):
        t_fit.fit(height=32, width=32, num_points=8, iterations=1, model_type="2dgs",
                  device="cpu")
