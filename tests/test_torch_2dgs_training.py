"""Port parity of 2DGS rendering and training against the JAX package:
``tdgs_torch.rendering.rasterization_2dgs`` through the whole API (both
rasterizers, every render mode, the screen-space taps), one ``Runner``
step of each package from the same state with the normal-consistency and
distortion losses live, and the port's command line.

The JAX package's 2DGS rasterizers read its ray transform transposed (see
tests/test_torch_rasterize_2dgs.py and ROADMAP, faults on the reference
side). The ``jax_2dgs_fixed`` fixture hands them Mᵀ by wrapping the JAX
projection for the test, which makes the JAX package compute what the port
computes; ``test_reference_differs_without_the_fix`` shows the two differ
without it. The wrapper also hands on the unit surfel normal, as the port
takes it: the JAX package scales it by the third scale (ROADMAP, faults on
the reference side).

Tolerances: outputs 2e-3 absolute (log-space against running-product
transmittance), median depth equal in all but 0.5% of the pixels,
gradients max|Δ| ≤ 1e-3 · max|ref|; the Runner step as
tests/test_torch_training.py holds the 3DGS one.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tdgs.ops.projection_2dgs as jproj2
from tdgs.rendering import rasterization_2dgs as j_render
from tdgs_torch import convert
from tdgs_torch.rendering import rasterization_2dgs as t_render
from tests.test_2dgs import make_surfel_scene
from tests.test_torch_training import _close_rel

ATOL = 2e-3
RTOL = 1e-3
OUTPUTS = ("colors", "alphas", "normals", "normals_from_depth", "distortion", "median")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier runs six test processes on the machine's cores: two
    intra-op threads each keep PyTorch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_project_fixed(project):
    """The JAX 2DGS projection as the port computes it: Mᵀ for its
    rasterizers, and the surfel normal unscaled (the JAX package scales the
    unit third axis by the third scale, which 2DGS does not read)."""

    def fixed(means, quats, scales, *args, **kwargs):
        radii, means2d, depths, M, normals = project(means, quats, scales, *args, **kwargs)
        return (radii, means2d, depths, jnp.swapaxes(M, -1, -2),
                normals / scales[..., None, :, 2:3])

    return fixed


@pytest.fixture
def jax_2dgs_fixed(monkeypatch):
    """The JAX package's 2DGS path with Mᵀ handed to its rasterizers and
    the unit surfel normal (``jax_project_fixed``)."""
    monkeypatch.setattr(jproj2, "fully_fused_projection_2dgs",
                        jax_project_fixed(jproj2.fully_fused_projection_2dgs))


def _scene(seed, N=40, C=2, width=48, height=32):
    rng = np.random.default_rng(seed)
    means, quats, scales, opac, colors, viewmats, Ks, w, h = make_surfel_scene(
        rng, N=N, C=C, width=width, height=height)
    scales[::3] *= 0.08  # sub-pixel surfels: the σ2d branch, the taps' gradients
    sh = (rng.normal(size=(N, 4, 3)) * 0.3).astype(np.float32)
    bg = rng.uniform(size=(C, 3)).astype(np.float32)
    return dict(means=means, quats=quats, scales=scales, opacities=opac, sh=sh,
                viewmats=viewmats, Ks=Ks, width=w, height=h, backgrounds=bg)


KW = dict(sh_degree=1, tile_capacity=256, max_tiles_per_gauss=16)
LEAVES = ("means", "quats", "scales", "opacities", "sh")


def _assert_outputs(got, want, n=6):
    for name, g, w in zip(OUTPUTS[:n], got, want):
        if w is None:
            assert g is None, name
            continue
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name == "median":
            assert (np.abs(g - w) > 1e-5).mean() <= 0.005, name
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("mode", ["RGB", "D", "ED", "RGB+D", "RGB+ED"])
def test_rasterization_2dgs_matches_jax(jax_2dgs_fixed, mode):
    """Both rasterizers of the port against the JAX package's "packed" in
    one render mode (with distortion where there is a depth channel); the
    forward-only "packed_inference" returns zeros for distortion and
    median."""
    s = _scene(600)
    args = [s[k] for k in LEAVES + ("viewmats", "Ks")]
    kw = dict(KW, render_mode=mode, distloss=mode != "RGB", backgrounds=s["backgrounds"])
    want = j_render(*map(jnp.asarray, args), s["width"], s["height"], rasterizer="packed",
                    **dict(kw, backgrounds=jnp.asarray(s["backgrounds"])))
    got = t_render(*args, s["width"], s["height"], rasterizer="packed", device="cpu", **kw)
    _assert_outputs(got, want)
    assert float(want[1].max()) > 0.5
    inf = t_render(*args, s["width"], s["height"], rasterizer="packed_inference",
                   device="cpu", **kw)
    _assert_outputs(inf, want, n=4)
    assert not inf[4].abs().any() and not inf[5].abs().any()
    meta = got[6]
    np.testing.assert_array_equal(meta["radii"].numpy(), np.asarray(want[6]["radii"]))
    assert meta["n_isects"] == int(want[6]["n_isects"])
    assert set(want[6]) <= set(meta)


def test_rasterization_2dgs_taps_and_gradients_match_jax(jax_2dgs_fixed):
    """"RGB+ED" with distortion, two cameras: gradients of every splat
    input, of the means2d tap (DefaultStrategy's) and of the AbsGS tap."""
    s = _scene(601)
    C, N = s["viewmats"].shape[0], s["means"].shape[0]
    rng = np.random.default_rng(61)
    H, W = s["height"], s["width"]
    cot = [rng.normal(size=(C, H, W, k)).astype(np.float32) for k in (4, 1, 3, 3, 1)]
    kw = dict(KW, render_mode="RGB+ED", distloss=True)

    def j_loss(*xs):
        *leaves, tap, abs_tap = xs
        out = j_render(*leaves, jnp.asarray(s["viewmats"]), jnp.asarray(s["Ks"]), W, H,
                       rasterizer="packed", backgrounds=jnp.asarray(s["backgrounds"]),
                       means2d_offset=tap, means2d_abs_tap=abs_tap, **kw)
        return sum(jnp.sum(o * c) for o, c in zip(out[:5], cot))

    zeros = np.zeros((C, N, 2), np.float32)
    xs = [s[k] for k in LEAVES] + [zeros, zeros]
    want = jax.grad(j_loss, argnums=tuple(range(7)))(*map(jnp.asarray, xs))
    leaves = [torch.tensor(x, requires_grad=True) for x in xs]
    out = t_render(*leaves[:5], s["viewmats"], s["Ks"], W, H, rasterizer="packed",
                   backgrounds=s["backgrounds"], means2d_offset=leaves[5],
                   means2d_abs_tap=leaves[6], device="cpu", **kw)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out[:5], cot))
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(LEAVES + ("means2d_tap", "abs_tap"), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert np.isfinite(g).all() and float(np.abs(w).max()) > 0, name
        _close_rel(g, w, RTOL, name)
    assert (got[6].numpy() >= np.abs(got[5].numpy()) - 1e-5).all()


def test_reference_differs_without_the_fix():
    """Without the transposed ray transform the JAX package's surfels fill
    their tiles at about their opacity; the port's do not."""
    s = _scene(602, N=16, C=1)
    args = [s[k] for k in LEAVES + ("viewmats", "Ks")]
    want = j_render(*map(jnp.asarray, args), s["width"], s["height"],
                    rasterizer="packed_inference", **KW)
    got = t_render(*args, s["width"], s["height"], rasterizer="packed_inference",
                   device="cpu", **KW)
    assert float(np.abs(got[1].detach().numpy() - np.asarray(want[1])).max()) > 0.1
    assert float(got[1].mean()) < float(np.asarray(want[1]).mean())


def test_unported_2dgs_rasterizer_raises():
    """The dense "jax" is ported (tests/test_torch_dense_rasterizers.py holds
    it against the JAX package): it renders; a name the JAX package does not
    have raises, and so does the AbsGS tap on the forward-only path."""
    s = _scene(603, N=4, C=1)
    args = [s[k] for k in LEAVES + ("viewmats", "Ks")]
    out = t_render(*args, 48, 32, rasterizer="jax", device="cpu", **KW)
    assert out[0].shape == (1, 32, 48, 3) and bool(torch.isfinite(out[0]).all())
    with pytest.raises(ValueError, match="unknown rasterizer"):
        t_render(*args, 48, 32, rasterizer="pallas", device="cpu")
    with pytest.raises(ValueError):
        t_render(*args, 48, 32, rasterizer="packed_inference", device="cpu",
                 means2d_abs_tap=torch.zeros((1, 4, 2)))


# ---------------------------------------------------------------------------
# one Runner step of each package from the same state; the command line
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tdgs_torch.utils.test_data import make_colmap_test_scene

    root = str(tmp_path_factory.mktemp("scene"))
    make_colmap_test_scene(root, device="cpu")
    return root


def _configs(scene, tmp, absgrad):
    from tdgs.strategy import DefaultStrategy as JDefault
    from tdgs.training.config import Config as JConfig
    from tdgs_torch.strategy import DefaultStrategy as TDefault
    from tdgs_torch.training.config import Config as TConfig

    kw = dict(data_dir=scene, data_factor=1, max_steps=1, eval_steps=[], save_steps=[],
              sh_degree=1, sh_degree_interval=1, capacity=256, tile_capacity=256,
              isect_capacity=1 << 14, test_every=4, tb_every=1, seed=3,
              background_color=(0.1, 0.2, 0.3), model_type="2dgs", normal_loss=True,
              dist_loss=True, normal_start_iter=0, dist_start_iter=0,
              normal_lambda=0.5, dist_lambda=0.5)
    sk = dict(refine_start_iter=0, refine_every=1000, reset_every=10_000, absgrad=absgrad)
    return (JConfig(result_dir=str(tmp / "j"), strategy=JDefault(**sk), data_prefetch=False,
                    **kw),
            TConfig(result_dir=str(tmp / "t"), strategy=TDefault(**sk), **kw))


@pytest.mark.parametrize("absgrad", [False, True])
def test_one_2dgs_runner_step_matches_jax(jax_2dgs_fixed, scene, tmp_path, absgrad):
    """One step of each package from the same mid-training state, both
    losses live (lambdas raised to 0.5 so that they weigh in the
    gradients). The JAX Runner renders through its jnp rasterizer on the
    CPU (dense tiling), whose entry order can differ from the packed sort's
    on near-equal depths; the step is held at the 3DGS step's tolerances
    (tests/test_torch_training.py), which the test scene's 120 gaussians,
    at distinct depths, meet."""
    from tdgs.models import gaussians as jg
    from tdgs.training.trainer import Runner as JRunner
    from tdgs_torch.training.trainer import Runner as TRunner

    jcfg, tcfg = _configs(scene, tmp_path, absgrad)
    jr = JRunner(jcfg)
    rng = np.random.default_rng(21)
    C = 256
    splats = {k: np.asarray(v) for k, v in jr.splats.items()}
    alive = np.asarray(jg.alive_mask(jr.splats))
    splats["shN"] = np.where(alive[:, None, None],
                             rng.normal(size=splats["shN"].shape) * 0.1, 0).astype(np.float32)
    opt = {part: {k: (rng.uniform(0, 1e-4, size=v.shape) if part == "nu"
                      else rng.normal(size=v.shape) * 1e-3).astype(np.float32)
                  for k, v in splats.items()} for part in ("mu", "nu")}
    strat = {"grad2d": rng.uniform(size=C).astype(np.float32),
             "count": rng.integers(1, 5, size=C).astype(np.float32),
             "radii_norm": np.zeros(C, np.float32), "scene_scale": jr.scene_scale}
    jr.splats = jax.tree.map(jnp.asarray, splats)
    jr.opt_state = jax.tree.map(jnp.asarray, opt)
    jr.strategy_state = dict(jr.strategy_state, **{k: jnp.asarray(v) for k, v in strat.items()
                                                   if k != "scene_scale"})
    state0 = {"step": 0, "splats": splats, "opt_state": opt, "strategy_state": strat}

    tr = TRunner(tcfg, device="cpu")
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
        g = (jmu - 0.9 * opt["mu"][k]) / 0.1
        strong = np.abs(g) > 1e-3 * np.abs(g).max()
        got, want = after["splats"][k], np.asarray(jr.splats[k])
        step = np.abs(want - splats[k]).max()
        np.testing.assert_allclose(got[strong], want[strong], rtol=0,
                                   atol=1e-3 * step + 1e-7, err_msg=k)
        assert np.abs(got - want).max() <= 6.4 * lr[k], k
    for k in ("grad2d", "count"):
        _close_rel(after["strategy_state"][k], np.asarray(jr.strategy_state[k]), 1e-3, k)
    # the step was counted (the surfels here are wider than a pixel, so the
    # means2d tap, read only by the σ2d branch, may carry no gradient)
    assert not np.array_equal(after["strategy_state"]["count"], strat["count"])
    # the checkpoint carries the 2DGS run under the JAX package's keys
    back = convert.runner_state_from_numpy(jax.tree.map(np.asarray, {
        "step": 1, "splats": jr.splats, "opt_state": jr.opt_state,
        "strategy_state": {k: v for k, v in jr.strategy_state.items()}}), device="cpu")
    assert set(back["splats"]) == set(tr.splats)


def test_simple_trainer_2dgs_cli_on_cpu(scene, tmp_path, capsys):
    """``--model-type 2dgs --normal-loss --dist-loss`` end to end: the loss
    drops and the eval (kernel 4's plain version) reports a finite PSNR."""
    from tdgs_torch.simple_trainer import main

    rc = main(["default", "--data-dir", scene, "--result-dir", str(tmp_path / "o"),
               "--data-factor", "1", "--max-steps", "30", "--eval-steps", "30",
               "--save-steps", "", "--capacity", "256", "--tile-capacity", "256",
               "--sh-degree", "1", "--sh-degree-interval", "10", "--test-every", "4",
               "--tb-every", "5", "--model-type", "2dgs", "--normal-loss", "--dist-loss",
               "--normal-start-iter", "10", "--dist-start-iter", "5",
               "--disable-video", "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    hist, stats = json.loads(lines[-2]), json.loads(lines[-1])
    assert np.isfinite(stats["psnr"]) and stats["psnr"] > 10.0, stats
    assert all(np.isfinite(h["loss"]) for h in hist)
