"""Port parity of the trainer's optional modules in the ``Runner`` against
the JAX package: one step of each package from the same mid-training state
(splats, Adam moments and strategy state carried across with
``tdgs_torch.convert``, the auxiliary parameters and their moments with
``convert.aux_params_from_numpy`` / ``aux_opt_state_from_numpy``, JAX's
fixed pose perturbation fed to the port) with the pose corrector, the pose
noise and the bilateral grids; with the appearance module; with the pose
corrector under 3DGUT's world-space rasterizer; eval's colour-corrected
``cc_*`` metrics; ``run_compression``; and the checkpoint's keys.

The JAX package renders 3DGS through its Pallas packed kernels in
interpret mode, the port through the plain versions of kernels 1–3; under
``with_eval3d`` the JAX package renders through its dense jnp ``"eval3d"``
on the CPU, and the test hands the port's step its dense ``"eval3d"`` too
(``dense_eval3d``), so that both tile alike.

Tolerances (tests/test_torch_training.py's for the main state): the loss
1e-4 relative; the Adam moments, main and auxiliary, within 1e-3 of their
max; the parameters equal (within 1e-3 of the step's size) where the
gradient is strong (|g| > 1e-3·max|g| for the splats, 1e-6·max|g| for the
auxiliary parameters, whose first Adam step is about 3.16·lr·sign(g)), and
within 6.4·lr elsewhere; eval's PSNR and SSIM, plain and colour-corrected,
1e-4 relative; the compressed round trip's as well.
"""

import json
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs.models import gaussians as jg
from tdgs_torch import convert
from tests.test_torch_training import _close_rel


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tier runs six test processes on the machine's cores: two
    intra-op threads each keep PyTorch from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tdgs_torch.utils.test_data import make_colmap_test_scene

    root = str(tmp_path_factory.mktemp("scene"))
    make_colmap_test_scene(root, device="cpu")
    return root


@pytest.fixture
def dense_eval3d(monkeypatch):
    """The port's Runner trains through the dense "eval3d" under
    ``with_eval3d``, as the JAX Runner does on the CPU."""
    import tdgs_torch.training.trainer as T

    real = T.rasterization

    def dense(*args, **kw):
        if kw.get("with_eval3d") and kw.get("rasterizer") != "packed_inference":
            kw["rasterizer"] = "eval3d"
        return real(*args, **kw)

    monkeypatch.setattr(T, "rasterization", dense)


def _runners(scene, tmp, **extra):
    from tdgs.strategy import DefaultStrategy as JDefault
    from tdgs.training.config import Config as JConfig
    from tdgs.training.trainer import Runner as JRunner
    from tdgs_torch.strategy import DefaultStrategy as TDefault
    from tdgs_torch.training.config import Config as TConfig
    from tdgs_torch.training.trainer import Runner as TRunner

    kw = dict(data_dir=scene, data_factor=1, max_steps=1, eval_steps=[], save_steps=[],
              sh_degree=1, sh_degree_interval=1, capacity=512, tile_capacity=256,
              isect_capacity=1 << 14, test_every=4, tb_every=1, rasterizer="packed",
              background_color=(0.1, 0.2, 0.3), seed=3)
    kw.update(extra)
    sk = dict(refine_start_iter=0, refine_every=1000, reset_every=10_000)
    jr = JRunner(JConfig(result_dir=str(tmp / "j"), strategy=JDefault(**sk),
                         data_prefetch=False, **kw))
    tr = TRunner(TConfig(result_dir=str(tmp / "t"), strategy=TDefault(**sk), **kw),
                 device="cpu")
    return jr, tr


def _perturb(rng, tree, scale):
    return jax.tree.map(lambda v: (np.asarray(v) + rng.normal(size=np.shape(v)) * scale)
                        .astype(np.float32), tree)


def _moments(rng, tree):
    return {"mu": jax.tree.map(lambda v: (rng.normal(size=np.shape(v)) * 1e-3)
                               .astype(np.float32), tree),
            "nu": jax.tree.map(lambda v: rng.uniform(0, 1e-4, size=np.shape(v))
                               .astype(np.float32), tree)}


def _same_state(jr, tr, seed, aux_params=None):
    """A mid-training state in both Runners: perturbed splats, nonzero
    moments and accumulators, the given auxiliary parameters with nonzero
    moments, and JAX's pose perturbation. Returns the state as numpy."""
    rng = np.random.default_rng(seed)
    C = jr.capacity
    splats = {k: np.asarray(v) for k, v in jr.splats.items()}
    alive = np.asarray(jg.alive_mask(jr.splats))
    splats["shN"] = np.where(alive[:, None, None],
                             rng.normal(size=splats["shN"].shape) * 0.1, 0).astype(np.float32)
    opt = _moments(rng, splats)
    strat = {"grad2d": rng.uniform(size=C).astype(np.float32),
             "count": rng.integers(1, 5, size=C).astype(np.float32),
             "radii_norm": np.zeros(C, np.float32), "scene_scale": jr.scene_scale}
    jr.splats = jax.tree.map(jnp.asarray, splats)
    jr.opt_state = jax.tree.map(jnp.asarray, opt)
    jr.strategy_state = dict(jr.strategy_state, **{k: jnp.asarray(v) for k, v in strat.items()
                                                   if k != "scene_scale"})
    state0 = {"step": 0, "splats": splats, "opt_state": opt, "strategy_state": strat}
    tr.load_state_numpy(convert.runner_state_from_numpy(state0, device="cpu"))

    aux = aux_params if aux_params is not None else jax.tree.map(np.asarray, jr.aux_params)
    aux_opt = _moments(rng, aux)
    jr.aux_params = jax.tree.map(jnp.asarray, aux)
    jr.aux_opt_state = jax.tree.map(jnp.asarray, aux_opt)
    tr.load_aux_state(convert.aux_params_from_numpy(aux, device="cpu"),
                      convert.aux_opt_state_from_numpy(aux_opt, device="cpu"))
    if jr._pose_perturb is not None:
        tr._pose_perturb = torch.from_numpy(np.asarray(jr._pose_perturb).copy())
    return state0, aux, aux_opt


def _step_and_compare(jr, tr, state0, aux0, aux_opt0):
    """One step each: the loss, the main state as
    tests/test_torch_training.py holds it, and the auxiliary state."""
    j_hist = jr.train()["history"]
    t_hist = tr.train()["history"]
    np.testing.assert_allclose(t_hist[0]["loss"], j_hist[0]["loss"], rtol=1e-4)

    after = convert.runner_state_to_numpy({"step": 1, "splats": tr.splats,
                                           "opt_state": tr.opt_state,
                                           "strategy_state": tr.strategy_state})
    lr = tr.optimizer.lr_at(1)
    for k, v0 in state0["splats"].items():
        for part in ("mu", "nu"):
            _close_rel(after["opt_state"][part][k], np.asarray(jr.opt_state[part][k]), 1e-3,
                       f"{part}[{k}]")
        g = (np.asarray(jr.opt_state["mu"][k]) - 0.9 * state0["opt_state"]["mu"][k]) / 0.1
        strong = np.abs(g) > 1e-3 * np.abs(g).max()
        got, want = after["splats"][k], np.asarray(jr.splats[k])
        step = np.abs(want - v0).max()
        np.testing.assert_allclose(got[strong], want[strong], rtol=0,
                                   atol=1e-3 * step + 1e-7, err_msg=k)
        assert np.abs(got - want).max() <= 6.4 * lr[k], k

    t_aux = convert.aux_params_to_numpy(tr.aux_params())
    t_opt = convert.aux_opt_state_to_numpy(tr.aux_opt_state)
    flat = jax.tree_util.tree_flatten_with_path
    for (path, want), got, p0, mu0, jmu in zip(
            flat(jax.tree.map(np.asarray, jr.aux_params))[0], jax.tree.leaves(t_aux),
            jax.tree.leaves(aux0), jax.tree.leaves(aux_opt0["mu"]),
            jax.tree.leaves(jax.tree.map(np.asarray, jr.aux_opt_state["mu"]))):
        name = jax.tree_util.keystr(path)
        assert got.shape == want.shape, name
        g = (jmu - 0.9 * mu0) / 0.1
        assert np.abs(g).max() > 0, name
        strong = np.abs(g) > 1e-6 * np.abs(g).max()
        step = np.abs(want - p0).max()
        np.testing.assert_allclose(got[strong], want[strong], rtol=0,
                                   atol=1e-3 * step + 1e-7, err_msg=name)
    for part in ("mu", "nu"):
        for (path, want), got in zip(flat(jax.tree.map(np.asarray, jr.aux_opt_state[part]))[0],
                                     jax.tree.leaves(t_opt[part])):
            _close_rel(got, want, 1e-3, f"aux {part}{jax.tree_util.keystr(path)}")
    return t_hist, j_hist


def test_runner_step_pose_opt_noise_bilateral_grid_matches_jax(scene, tmp_path):
    """pose_opt with pose_noise (the fixed perturbation, then the corrector)
    and the bilateral grids: the rendered RGB goes through the grids, the
    loss adds tvloss and posereg; a perturbed corrector and grids, so both
    have gradients from the step's start."""
    jr, tr = _runners(scene, tmp_path, pose_opt=True, pose_noise=1e-2, pose_opt_lr=1e-3,
                      use_bilateral_grid=True, bilateral_grid_shape=(4, 3, 4),
                      pose_opt_reg=1e-2)
    assert tr._pose_perturb is not None and tr.aux_lrs == {
        k: float(v) for k, v in jr.aux_lrs.items()}
    rng = np.random.default_rng(40)
    aux = _perturb(rng, jax.tree.map(np.asarray, jr.aux_params), 0.02)
    state0, aux0, aux_opt0 = _same_state(jr, tr, 41, aux)
    _step_and_compare(jr, tr, state0, aux0, aux_opt0)
    with open(os.path.join(tr.cfg.result_dir, "metrics.jsonl")) as f:
        rec = [json.loads(line) for line in f]
    assert {"train/tvloss", "train/posereg", "train/rgbloss"} <= set(rec[-1])


def test_runner_step_app_opt_matches_jax(scene, tmp_path):
    """app_opt: colours sigmoid(MLP + colors) per camera, the MLP carried
    from JAX's init_appearance_opt with a nonzero last layer and embeddings
    (so every weight has a gradient), features and colours among the
    splats; the loss adds appreg."""
    jr, tr = _runners(scene, tmp_path, app_opt=True, feature_dim=8, app_embed_dim=4,
                      app_opt_reg=1e-2)
    assert set(tr.splats) == set(jr.splats) >= {"features", "colors"}
    assert tr.aux_lrs == pytest.approx({k: float(v) for k, v in jr.aux_lrs.items()})
    rng = np.random.default_rng(42)
    aux = jax.tree.map(np.asarray, jr.aux_params)
    aux["app_mlp"]["w2"] = (rng.normal(size=aux["app_mlp"]["w2"].shape) * 0.1).astype(
        np.float32)
    aux["app_embeds"] = (rng.normal(size=aux["app_embeds"].shape) * 0.1).astype(np.float32)
    state0, aux0, aux_opt0 = _same_state(jr, tr, 43, aux)
    _step_and_compare(jr, tr, state0, aux0, aux_opt0)


def test_runner_step_pose_opt_eval3d_matches_jax(scene, tmp_path, dense_eval3d):
    """pose_opt and pose_noise under with_eval3d (the UT tiling): the pose
    gradient reaches the corrector through the world-space rays."""
    jr, tr = _runners(scene, tmp_path, pose_opt=True, pose_noise=1e-2, pose_opt_lr=1e-3,
                      with_ut=True, with_eval3d=True, pose_opt_reg=1e-2)
    rng = np.random.default_rng(44)
    aux = _perturb(rng, jax.tree.map(np.asarray, jr.aux_params), 0.02)
    state0, aux0, aux_opt0 = _same_state(jr, tr, 45, aux)
    _step_and_compare(jr, tr, state0, aux0, aux_opt0)


def test_eval_cc_metrics_and_compression_match_jax(scene, tmp_path, monkeypatch):
    """Eval with the bilateral grids reports cc_psnr, cc_ssim and cc_ with
    the LPIPS key beside the plain metrics, as JAX's eval does, equal in
    value (PSNR, SSIM); run_compression's round trip scores as JAX's and
    leaves the splats as they were. The two LPIPS proxies draw different
    filter banks, so their values are not compared, and the JAX package's,
    which cannot be jitted, is stubbed to zeros here (its first call takes
    the CPU half a minute)."""
    import tdgs.training.metrics as jmetrics

    monkeypatch.setattr(jmetrics, "lpips",
                        lambda a, b, net="alex": jnp.zeros((a.shape[0],), jnp.float32))
    jr, tr = _runners(scene, tmp_path, use_bilateral_grid=True)
    rng = np.random.default_rng(46)
    splats = {k: np.asarray(v) for k, v in jr.splats.items()}
    alive = np.asarray(jg.alive_mask(jr.splats))
    splats["shN"] = np.where(alive[:, None, None],
                             rng.normal(size=splats["shN"].shape) * 0.2, 0).astype(np.float32)
    splats["sh0"] = splats["sh0"] + rng.normal(size=splats["sh0"].shape).astype(np.float32) * 0.3
    jr.splats = jax.tree.map(jnp.asarray, splats)
    tr.splats = convert.splats_from_numpy(splats, device="cpu")
    want, got = jr.eval(1), tr.eval(1)
    lp = got["lpips_impl"]
    lkey = "lpips" if lp.startswith("learned") else "lpips_proxy"
    assert {"psnr", "ssim", "cc_psnr", "cc_ssim", f"cc_{lkey}"} <= set(got)
    assert set(k for k in want if not k.startswith("lpips")) == set(
        k for k in got if not k.startswith("lpips"))
    for k in ("psnr", "ssim", "cc_psnr", "cc_ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["cc_psnr"] >= got["psnr"] - 1e-3
    with open(os.path.join(tr.stats_dir, "val_step1.json")) as f:
        assert set(json.load(f)) == set(got)

    before = {k: v.clone() for k, v in tr.splats.items()}
    want_c, got_c = jr.run_compression(1), tr.run_compression(1)
    for k in ("psnr", "ssim", "cc_psnr", "cc_ssim", "num_GS"):
        np.testing.assert_allclose(got_c[k], want_c[k], rtol=1e-4, err_msg=k)
    assert np.isfinite(got_c["psnr"]) and got_c["num_GS"] <= got["num_GS"]
    for k, v in before.items():
        assert torch.equal(tr.splats[k], v), k
    assert os.path.exists(os.path.join(tr.cfg.result_dir, "compression", "meta.json"))
    assert os.path.exists(os.path.join(tr.stats_dir, "compress_step1.json"))


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


def test_checkpoint_keys_match_jax(scene, tmp_path):
    """With every optional module on, the port's pickle holds the JAX
    package's keys and shapes: step, splats (features and colors among
    them), opt_state and strategy_state, and no auxiliary state (the JAX
    package's checkpoint drops it); a load keeps the modules as they were."""
    jr, tr = _runners(scene, tmp_path, pose_opt=True, pose_noise=1e-3, app_opt=True,
                      feature_dim=8, app_embed_dim=4, use_bilateral_grid=True,
                      bilateral_grid_shape=(4, 3, 4))
    jr.save_checkpoint(0)
    path = tr.save_checkpoint(0)
    with open(os.path.join(jr.ckpt_dir, "ckpt_0.pkl"), "rb") as f:
        want = pickle.load(f)
    with open(path, "rb") as f:
        got = pickle.load(f)
    assert _keys(got) == _keys(want)
    assert "features" in got["splats"] and "aux_params" not in got
    aux = convert.aux_params_to_numpy(tr.aux_params())
    assert tr.load_checkpoint(path) == 0
    for (a, b) in zip(jax.tree.leaves(aux), jax.tree.leaves(
            convert.aux_params_to_numpy(tr.aux_params()))):
        np.testing.assert_array_equal(a, b)
    assert _keys(aux) == _keys(jax.tree.map(np.asarray, jr.aux_params))
