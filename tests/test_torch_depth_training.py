"""Port parity of 3DGS training with depth and normal supervision against
the JAX package: one ``Runner`` step from one state (carried across with
``tdgs_torch.convert``) with the dense depth loss on refined depth maps,
the sparse depth loss on a tracked scene, the depth-normal regularizers
past their start step, the monocular normals past theirs, and the fisheye
camera; the configuration switches; the depth and normal dumps; the
trajectory render of the command line.

Tolerances: the loss terms, the loss, the Adam moments and the strategy's
screen-gradient sums 1e-4 relative to the reference's largest magnitude;
parameters equal where the gradient is strong (within 1e-3 of the step),
within 6.4·lr elsewhere, where the sign of a tiny gradient can differ and
the uncorrected first Adam step is about 3.16·lr. The depth-normal case
runs at the default weights: at 50 times the normal-consistency weight the
moments differ by up to 6e-4, because the normals' total variation takes
the depth gradient through rsqrt(|n|² + 1e-12) and the expected depth's
1/alpha, which magnify the float32 rounding of the two renders (the chain
alone agrees to 2e-7: ``tests/test_torch_depth_normal.py``).
"""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs_torch import convert

TERM_RTOL = 1e-4
MOMENT_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_depths_and_normals(root, H, W, n_images, seed=5):
    """Refined depth maps (a slanted plane around depth 4, a corner
    invalid) and smooth unit normal maps for every image."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "refined_depths"), exist_ok=True)
    os.makedirs(os.path.join(root, "normals"), exist_ok=True)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for i in range(n_images):
        d = 4.0 + 0.01 * xx - 0.005 * yy + rng.uniform(-0.02, 0.02, (H, W))
        d[:4, :4] = 0.0
        np.save(os.path.join(root, "refined_depths", f"img_{i:03d}_refined_depth.npy"),
                d.astype(np.float32))
        n = np.stack([np.sin(0.1 * xx + i), np.cos(0.07 * yy), -np.ones_like(xx)], -1)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
        np.save(os.path.join(root, "normals", f"img_{i:03d}.npy"), n.astype(np.float32))


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tdgs_torch.utils.test_data import make_colmap_test_scene

    root = str(tmp_path_factory.mktemp("depth_scene"))
    make_colmap_test_scene(root, device="cpu", tracks=True)
    write_depths_and_normals(root, 48, 64, 8)
    return root


CASES = {
    "dense_depth": dict(depth_loss=True, use_precomputed_depths=True),
    "sparse_depth": dict(depth_loss=True),
    "depth_normal": dict(depth_normal_loss=True, depth_normal_start_step=0),
    "mono_normals": dict(load_normals=True, start_normal_loss_step=1),
    "fisheye": dict(camera_model="fisheye", depth_loss=True),
}
TERMS = {
    "dense_depth": ("depthloss",),
    "sparse_depth": ("depthloss",),
    "depth_normal": ("depthsmooth", "normalconsist"),
    "mono_normals": ("normalloss",),
    "fisheye": ("depthloss",),
}


def _configs(scene, tmp, case):
    from tdgs.strategy import DefaultStrategy as JDefault
    from tdgs.training.config import Config as JConfig
    from tdgs_torch.strategy import DefaultStrategy as TDefault
    from tdgs_torch.training.config import Config as TConfig

    kw = dict(data_dir=scene, data_factor=1, normalize_world_space=False, max_steps=1,
              eval_steps=[], save_steps=[], sh_degree=1, sh_degree_interval=1,
              capacity=512, tile_capacity=256, isect_capacity=1 << 14, test_every=4,
              tb_every=1, rasterizer="packed", seed=3, depth_lambda=0.5, **CASES[case])
    sk = dict(refine_start_iter=0, refine_every=1000, reset_every=10_000)
    return (JConfig(result_dir=str(tmp / "j"), strategy=JDefault(**sk), data_prefetch=False,
                    **kw),
            TConfig(result_dir=str(tmp / "t"), strategy=TDefault(**sk), **kw))


def _metrics(result_dir):
    with open(os.path.join(result_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f][-1]


def _close_rel(got, want, rtol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{name}: max|Δ| {err} > {rtol} · {scale}"


@pytest.mark.parametrize("case", list(CASES))
def test_one_runner_step_matches_jax(scene, tmp_path, case):
    from tdgs.models import gaussians as jg
    from tdgs.training.trainer import Runner as JRunner
    from tdgs_torch.training.trainer import Runner as TRunner

    jcfg, tcfg = _configs(scene, tmp_path, case)
    jr = JRunner(jcfg)
    rng = np.random.default_rng(21)
    splats = {k: np.array(v) for k, v in jr.splats.items()}
    alive = np.asarray(jg.alive_mask(jr.splats))
    # a mid-training state: anisotropic scales, so each normal is defined
    splats["shN"] = np.where(alive[:, None, None],
                             rng.normal(size=splats["shN"].shape) * 0.1, 0).astype(np.float32)
    splats["scales"] = (splats["scales"] + rng.normal(size=splats["scales"].shape)
                        * 0.3).astype(np.float32)
    opt = {part: {k: (rng.uniform(0, 1e-4, size=v.shape) if part == "nu"
                      else rng.normal(size=v.shape) * 1e-3).astype(np.float32)
                  for k, v in splats.items()} for part in ("mu", "nu")}
    jr.splats = jax.tree.map(jnp.asarray, splats)
    jr.opt_state = jax.tree.map(jnp.asarray, opt)
    strat = {k: np.asarray(v) for k, v in jr.strategy_state.items() if k != "scene_scale"}
    strat["scene_scale"] = jr.strategy_state["scene_scale"]
    state0 = {"step": 0, "splats": splats, "opt_state": opt, "strategy_state": strat}

    tr = TRunner(tcfg, device="cpu")
    tr.load_state_numpy(convert.runner_state_from_numpy(state0, device="cpu"))
    j_hist = jr.train()["history"]
    t_hist = tr.train()["history"]
    tr.close()

    jm, tm = _metrics(jr.cfg.result_dir), _metrics(tr.cfg.result_dir)
    for k in ("rgbloss",) + TERMS[case]:
        key = f"train/{k}"
        assert key in tm and tm[key] != 0.0 and np.isfinite(tm[key]), key
        _close_rel(tm[key], jm[key], TERM_RTOL, key)
    np.testing.assert_allclose(t_hist[0]["loss"], j_hist[0]["loss"], rtol=TERM_RTOL)

    after = tr.state_numpy(1)
    lr = tr.optimizer.lr_at(1)
    for k, v0 in splats.items():
        for part in ("mu", "nu"):
            _close_rel(after["opt_state"][part][k], np.asarray(jr.opt_state[part][k]),
                       MOMENT_RTOL, f"{part}[{k}]")
        g = (np.asarray(jr.opt_state["mu"][k]) - 0.9 * opt["mu"][k]) / 0.1
        strong = np.abs(g) > 1e-3 * np.abs(g).max()
        got, want = after["splats"][k], np.asarray(jr.splats[k])
        step = np.abs(want - v0).max()
        np.testing.assert_allclose(got[strong], want[strong], rtol=0, atol=1e-3 * step + 1e-7,
                                   err_msg=k)
        assert np.abs(got - want).max() <= 6.4 * lr[k], k
    for k in ("grad2d", "count"):
        _close_rel(after["strategy_state"][k], np.asarray(jr.strategy_state[k]),
                   MOMENT_RTOL, k)


def test_config_ports_depth_normals_and_cameras(tmp_path):
    from tdgs_torch.training.config import Config

    base = Config(data_dir=str(tmp_path), result_dir=str(tmp_path / "r"))
    for camera_model in ("ortho", "fisheye"):
        dataclasses.replace(
            base, depth_loss=True, use_precomputed_depths=True, depth_normal_loss=True,
            load_normals=True, save_depth_normal_vis=True,
            camera_model=camera_model).check_ported()
    # the sharded directory container (ported with parallel/)
    dataclasses.replace(base, ckpt_format="orbax").check_ported()


def test_command_line_dumps_depth_normals_lpips_and_trajectory(scene, tmp_path, monkeypatch):
    """``python -m tdgs_torch.simple_trainer`` with the depth and normal
    terms: the vis dumps at the ``tb_every`` cadence, LPIPS (the proxy, no
    weights on disk) in the eval JSON, the trajectory as a GIF where PIL
    imports and as PNG frames where it does not."""
    import sys

    from tdgs_torch import simple_trainer
    from tdgs_torch.training.trainer import Runner
    from tdgs_torch.utils.png import read_png

    monkeypatch.setenv("TDGS_LPIPS_WEIGHTS", "")
    monkeypatch.setenv("HOME", str(tmp_path))
    out = tmp_path / "out"
    argv = ["default", "--data-dir", scene, "--result-dir", str(out), "--data-factor", "1",
            "--max-steps", "4", "--eval-steps", "4", "--save-steps", "", "--capacity", "512",
            "--tile-capacity", "256", "--sh-degree", "1", "--test-every", "4", "--tb-every",
            "2", "--depth-loss", "--use-precomputed-depths", "--depth-normal-loss",
            "--depth-normal-start-step", "1", "--load-normals", "--start-normal-loss-step",
            "2", "--save-depth-normal-vis", "--device", "cpu"]
    assert simple_trainer.main(argv) == 0
    vis = sorted(p.name for p in (out / "vis").iterdir())
    assert vis == ["depth_00002.png", "depth_00004.png", "normal_00002.png", "normal_00004.png"]
    assert read_png(str(out / "vis" / "depth_00004.png")).shape == (48, 64, 3)
    stats = json.loads((out / "stats" / "val_step4.json").read_text())
    assert stats["lpips_impl"] == "random-proxy" and np.isfinite(stats["lpips_proxy"])
    assert "lpips" not in stats
    with open(out / "metrics.jsonl") as f:
        terms = [r for r in map(json.loads, f) if "train/loss" in r][-1]
    for k in ("depthloss", "normalloss", "depthsmooth", "normalconsist"):
        assert np.isfinite(terms[f"train/{k}"]) and terms[f"train/{k}"] > 0, k
    assert (out / "traj_4.gif").is_file()

    # no PIL: the frames as PNGs, from the ellipse path
    monkeypatch.setitem(sys.modules, "PIL", None)
    cfg_kw = dict(data_dir=scene, result_dir=str(tmp_path / "nopil"), data_factor=1,
                  max_steps=1, capacity=512, tile_capacity=256, sh_degree=1, test_every=4)
    from tdgs_torch.training.config import Config

    runner = Runner(Config(**cfg_kw), device="cpu")
    path = runner.render_traj(1, n_frames=5, traj_path="ellipse")
    runner.close()
    frames = sorted(os.listdir(path))
    assert frames == [f"frame_{i:04d}.png" for i in range(5)]
    assert read_png(os.path.join(path, frames[0])).shape == (48, 64, 3)
