"""The port's sharded ``Runner`` (``Config.sharded``) on a gloo world of 2
CPU ranks, against the JAX package's single-device ``Runner``:

- one training step at batch 2 from the same state (the JAX init,
  perturbed, cut to each rank's block with ``convert.shard_rows``): the
  loss within the JAX package's own bound for its sharded step, 2e-4
  (``tests/test_trainer_sharded.py:103-112``), and the rows as
  ``tests/test_torch_training.py`` holds the single-device step (Adam
  moments within 1e-3 of their max; parameters within 1e-3 of the step
  where |g| > 1e-3·max|g|, within 6.4·lr elsewhere; grad2d and count
  within 1e-3);
- a DefaultStrategy refine under sharding equals the single-device refine
  of the same whole arrays, row for row (bitwise), and so does an MCMC
  refine after a few MCMC steps;
- eval at C = 1 renders the gathered splats, alike on both ranks;
- the sharded checkpoint (``ckpt_format="orbax"``) round-trips bitwise
  into a new world of 2, and re-blocks into one process (W = 1);
- the paths the JAX step above does not reach, four steps each against the
  port's single-rank Runner at batch 2 (losses within 1e-4 relative): 2DGS
  with the normal and distortion losses and refines, 3DGUT under MCMC with
  the appearance module, 3DGUT with the monocular normals (their loss's
  gradient through the centres of a projection the render only tiles
  with), the pose corrector behind a pose noise, the
  bilateral grids and random backgrounds, the sparse depth losses with
  AbsGS refines, the dense depth loss with the monocular normals, and
  identity-vector segmentation. Their renders differ from the
  single-rank ones only where depth ties fall otherwise (each rank
  quantizes the depth keys over its own cameras), so the losses, not the
  rows, are held.

One world runs every case once (``parallel.checks.trainer_cases``,
module-scoped); each test holds one.
"""

import concurrent.futures
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tdgs.models import gaussians as jg
from tdgs.strategy import DefaultStrategy as JDefault
from tdgs_torch import convert
from tdgs_torch.parallel import checks, launch
from tdgs_torch.strategy import DefaultStrategy as TDefault
from tests.test_torch_training import _close_rel

LOSS_BOUND = 2e-4


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tdgs_torch.utils.test_data import make_colmap_test_scene

    root = str(tmp_path_factory.mktemp("sharded_scene"))
    make_colmap_test_scene(root, device="cpu")
    return root


VARIANT_STEPS = 4


def _variants(scene, tmp):
    """The port's configs of the variant runs (``checks.runner_variants``)."""
    from tdgs_torch.strategy import MCMCStrategy
    from tdgs_torch.training.config import Config
    from tdgs_torch.utils.test_data import make_colmap_test_scene, make_domino_scene

    tracked, dominoes = str(tmp / "tracked"), str(tmp / "dominoes")
    make_colmap_test_scene(tracked, device="cpu", tracks=True)
    # refined depths and unit normal maps, random: only their use is held
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(tracked, "normals"))
    os.makedirs(os.path.join(tracked, "refined_depths"))
    for name in sorted(os.listdir(os.path.join(tracked, "images"))):
        stem = os.path.splitext(name)[0]
        n = rng.normal(size=(48, 64, 3))
        np.save(os.path.join(tracked, "normals", f"{stem}.npy"),
                (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32))
        d = rng.uniform(2.0, 6.0, size=(48, 64)).astype(np.float32)
        d[:5] = 0.0  # no estimate there
        np.save(os.path.join(tracked, "refined_depths", f"{stem}_refined_depth.npy"), d)
    make_domino_scene(dominoes, n_dominoes=3, n_images=8, width=64, height=48,
                      gauss_per_domino=150, ground_gauss=300, sfm_points=400, device="cpu")
    base = dict(data_factor=1, max_steps=VARIANT_STEPS, eval_steps=[], save_steps=[],
                sh_degree=1, sh_degree_interval=1, capacity=512, tile_capacity=256,
                test_every=4, tb_every=1, batch_size=2, seed=3)
    refine = dict(refine_start_iter=1, refine_every=2, reset_every=10_000)
    return {
        "2dgs": Config(data_dir=scene, result_dir=str(tmp / "v_2dgs"), model_type="2dgs",
                       normal_loss=True, dist_loss=True, normal_start_iter=0,
                       dist_start_iter=0, strategy=TDefault(**refine), **base),
        "3dgut_modules": Config(
            data_dir=scene, result_dir=str(tmp / "v_3dgut"), with_ut=True, with_eval3d=True,
            app_opt=True, feature_dim=8, app_embed_dim=4, pose_opt=True, pose_noise=1e-3,
            use_bilateral_grid=True, random_bkgd=True, opacity_reg=0.01, scale_reg=0.01,
            strategy=MCMCStrategy(cap_max=512, refine_start_iter=1, refine_every=2), **base),
        "3dgut_normals": Config(
            data_dir=tracked, result_dir=str(tmp / "v_3dgut_normals"), with_ut=True,
            with_eval3d=True, load_normals=True, start_normal_loss_step=0,
            strategy=MCMCStrategy(cap_max=512, refine_start_iter=1, refine_every=2), **base),
        "depth_sparse_absgrad": Config(data_dir=tracked, result_dir=str(tmp / "v_depth"),
                                       depth_loss=True, depth_normal_loss=True,
                                       depth_normal_start_step=0,
                                       strategy=TDefault(absgrad=True, **refine), **base),
        "depth_dense_normals": Config(data_dir=tracked, result_dir=str(tmp / "v_normals"),
                                      depth_loss=True, use_precomputed_depths=True,
                                      load_normals=True, start_normal_loss_step=0,
                                      strategy=TDefault(**refine), **base),
        "segmentation": Config(data_dir=dominoes, result_dir=str(tmp / "v_seg"),
                               with_segmentation=True, seg_start_iter=1, seg_loss_every=1,
                               seg_spatial_every=2, **dict(base, capacity=1200)),
    }


@pytest.fixture(scope="module")
def cases(scene, tmp_path_factory):
    """The JAX Runner's step and the port's sharded cases from one state."""
    from tdgs.training.config import Config as JConfig
    from tdgs.training.trainer import Runner as JRunner
    from tdgs_torch.training.config import Config as TConfig

    tmp = tmp_path_factory.mktemp("sharded_runs")
    variants = _variants(scene, tmp)
    kw = dict(data_dir=scene, data_factor=1, max_steps=1, eval_steps=[], save_steps=[],
              sh_degree=1, sh_degree_interval=1, capacity=512, tile_capacity=256,
              isect_capacity=1 << 14, test_every=4, tb_every=1, rasterizer="packed",
              background_color=(0.1, 0.2, 0.3), seed=3, batch_size=2)
    sk = dict(refine_start_iter=0, refine_every=1000, reset_every=10_000)
    jr = JRunner(JConfig(result_dir=str(tmp / "j"), strategy=JDefault(**sk),
                         data_prefetch=False, **kw))
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
    tcfg = TConfig(result_dir=str(tmp / "t"), strategy=TDefault(**sk), **kw)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the port's world runs while the JAX step compiles
        world = pool.submit(launch.run, checks.trainer_cases, 2, convert.config_to_dict(tcfg),
                            state0, {k: convert.config_to_dict(v) for k, v in variants.items()},
                            "cpu", device="cpu", timeout_s=600)
        j_hist = jr.train()["history"]
        ranks = world.result()
    return {"jax": jr, "jax_history": j_hist, "state0": state0, "ranks": ranks,
            "tcfg": tcfg, "variants": variants}


def test_sharded_step_matches_jax_single_device_step(cases):
    jr, state0 = cases["jax"], cases["state0"]
    for res in cases["ranks"]:
        t_hist = res["step"]["history"]
        assert abs(t_hist[0]["loss"] - cases["jax_history"][0]["loss"]) < LOSS_BOUND, (
            t_hist, cases["jax_history"])
    after = cases["ranks"][0]["step"]["state"]
    from tdgs_torch.training.trainer import make_lr_schedules

    lr = {k: (v(1) if callable(v) else v)
          for k, v in make_lr_schedules(cases["tcfg"], jr.scene_scale,
                                        cases["tcfg"].max_steps).items()}
    for k in state0["splats"]:
        jmu = np.asarray(jr.opt_state["mu"][k])
        for part in ("mu", "nu"):
            _close_rel(after["opt_state"][part][k], np.asarray(jr.opt_state[part][k]), 1e-3,
                       f"{part}[{k}]")
        # the gradient, recovered from the first moment
        g = (jmu - 0.9 * state0["opt_state"]["mu"][k]) / 0.1
        strong = np.abs(g) > 1e-3 * np.abs(g).max()
        got, want = after["splats"][k], np.asarray(jr.splats[k])
        step = np.abs(want - state0["splats"][k]).max()
        np.testing.assert_allclose(got[strong], want[strong], rtol=0,
                                   atol=1e-3 * step + 1e-7, err_msg=k)
        assert np.abs(got - want).max() <= 6.4 * lr[k], k
    for k in ("grad2d", "count"):
        _close_rel(after["strategy_state"][k], np.asarray(jr.strategy_state[k]), 1e-3, k)
    # both ranks hold the same whole state
    other = cases["ranks"][1]["step"]["state"]
    for k in after["splats"]:
        np.testing.assert_array_equal(after["splats"][k], other["splats"][k])


def _assert_trees_equal(got, want, name):
    if isinstance(want, dict):
        assert set(got) == set(want), name
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{name}.{k}")
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{name}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        assert got == want, name


def test_sharded_default_refine_equals_single_device_refine(cases):
    for res in cases["ranks"]:
        ref = res["refine"]
        counts = ref["last_refine"]
        assert counts["n_dupli"] > 0 and counts["n_split"] > 0 and counts["n_prune"] > 0, counts
        _assert_trees_equal(ref["got"], ref["want"], "refine")


def test_sharded_mcmc_runs_and_refines_as_one_device(cases):
    for res in cases["ranks"]:
        mc = res["mcmc"]
        assert np.isfinite([h["loss"] for h in mc["history"]]).all()
        assert [r["step"] for r in mc["refines"]] == [2, 4]
        assert mc["n_alive"] > mc["alive0"]
        _assert_trees_equal(mc["got"], mc["want"], "mcmc")


def test_sharded_eval_renders_one_camera(cases):
    ev = [res["eval"] for res in cases["ranks"]]
    assert np.isfinite(ev[0]["psnr"]) and ev[0]["psnr"] > 10.0
    assert ev[0]["psnr"] == ev[1]["psnr"] and ev[0]["num_GS"] == ev[1]["num_GS"]


def test_sharded_checkpoint_round_trips_and_reblocks(cases, tmp_path):
    import dataclasses

    from tdgs_torch.training.trainer import Runner

    ck = cases["ranks"][0]["ckpt"]
    assert os.path.isdir(ck["path"]) and ck["step"] == 7
    for res in cases["ranks"]:
        _assert_trees_equal(res["ckpt"]["loaded"], ck["saved"], "loaded")
    # the same directory read whole by one process
    cfg = dataclasses.replace(cases["tcfg"], result_dir=str(tmp_path / "one"))
    one = Runner(cfg, device="cpu")
    try:
        assert one.load_checkpoint(ck["path"]) == 7
        _assert_trees_equal(one.state_numpy(7), ck["saved"], "reblocked")
    finally:
        one.close()


@pytest.mark.parametrize("variant", ["2dgs", "3dgut_modules", "3dgut_normals",
                                     "depth_sparse_absgrad", "depth_dense_normals",
                                     "segmentation"])
def test_sharded_runner_matches_single_rank_runner(cases, variant):
    from tdgs_torch.training.trainer import Runner

    runner = Runner(cases["variants"][variant], device="cpu")
    try:
        want = [h["loss"] for h in runner.train()["history"]]
        state = runner.state_numpy(VARIANT_STEPS)
    finally:
        runner.close()
    for res in cases["ranks"]:
        got = res["variants"][variant]
        assert len(got["history"]) == VARIANT_STEPS
        np.testing.assert_allclose([h["loss"] for h in got["history"]], want, rtol=1e-4)
        for k, v in got["state"]["splats"].items():
            assert v.shape == state["splats"][k].shape and np.isfinite(v).all(), k
