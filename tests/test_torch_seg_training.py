"""Port parity of training with identity-vector segmentation against the
JAX package: instance-mask loading (with the patch crop), one ``Runner``
step with the CGC loss and the spatial regularizer from one state (carried
across with ``tdgs_torch.convert``, the spatial sample fed from JAX's
``k_seg``), the identity render, the checkpoint's ``segmentation_head``
read back by JAX, and a small CPU run of the whole chain
(``tdgs_torch.rally_e2e``).

Tolerances: the segmentation loss terms, the cluster quality, the Adam
moments of ``identity_encodings`` and of the head 1e-4 relative to the
reference's largest magnitude; the other splats' moments 1e-3 (the main
render's gradients through the packed kernels, as
``tests/test_torch_training.py``); parameters equal where the gradient is
strong (within 1e-3 of the step), and within 6.4·lr elsewhere, where the
sign of a tiny gradient can differ and the uncorrected first Adam step is
about 3.16·lr. The identity map 1e-5 relative. The state's positions are
all distinct, so the spatial regularizer's neighbours have no ties."""

import json
import os
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tdgs_torch import convert
from tdgs_torch.segmentation import losses as tlos

SEG_RTOL = 1e-4
MAIN_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tdgs_torch.utils.test_data import make_domino_scene

    root = str(tmp_path_factory.mktemp("dominoes"))
    make_domino_scene(root, n_dominoes=3, n_images=8, width=64, height=48,
                      gauss_per_domino=120, ground_gauss=200, sfm_points=300, device="cpu")
    return root


def _close_rel(got, want, rtol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{name}: max|Δ| {err} > {rtol} · {scale}"


@pytest.mark.parametrize("patch_size", [None, 32])
def test_instance_masks_load_and_crop_like_jax(scene, patch_size):
    from tdgs.datasets import Dataset as JDataset
    from tdgs.datasets import Parser as JParser
    from tdgs_torch.datasets import Dataset, Parser

    kw = dict(factor=1, normalize=False, test_every=4, load_instance_masks=True)
    jset = JDataset(JParser(scene, **kw), "train", patch_size=patch_size)
    tset = Dataset(Parser(scene, **kw), "train", patch_size=patch_size)
    assert len(jset) == len(tset) == 6
    for i in range(len(tset)):
        np.random.seed(100 + i)
        want = jset[i]
        np.random.seed(100 + i)
        got = tset[i]
        for k in ("instance_mask", "image", "K", "viewmat"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert set(np.unique(tset[0]["instance_mask"])) <= {0, 1, 2, 3}
    # masks are not read unless asked for
    assert "instance_mask" not in Dataset(Parser(scene, factor=1, normalize=False))[0]


def _configs(scene, tmp):
    from tdgs.strategy import DefaultStrategy as JDefault
    from tdgs.training.config import Config as JConfig
    from tdgs_torch.strategy import DefaultStrategy as TDefault
    from tdgs_torch.training.config import Config as TConfig

    kw = dict(data_dir=scene, data_factor=1, normalize_world_space=False, max_steps=1,
              eval_steps=[], save_steps=[], sh_degree=1, sh_degree_interval=1,
              capacity=512, tile_capacity=256, isect_capacity=1 << 14, test_every=4,
              tb_every=1, rasterizer="packed", background_color=(0.78,) * 3, seed=3,
              with_segmentation=True, identity_dim=16, seg_start_iter=1, seg_loss_every=1,
              seg_spatial_every=1, cgc_min_cluster=20)
    sk = dict(refine_start_iter=0, refine_every=1000, reset_every=10_000)
    return (JConfig(result_dir=str(tmp / "j"), strategy=JDefault(**sk), data_prefetch=False,
                    **kw),
            TConfig(result_dir=str(tmp / "t"), strategy=TDefault(**sk), **kw))


def _metrics(result_dir):
    with open(os.path.join(result_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f][-1]


@pytest.fixture(scope="module")
def one_step(scene, tmp_path_factory):
    """Both Runners from one state, one step each with the CGC loss and the
    spatial regularizer."""
    from tdgs.models import gaussians as jg
    from tdgs.training.trainer import Runner as JRunner
    from tdgs_torch.training.trainer import Runner as TRunner

    tmp = tmp_path_factory.mktemp("seg_step")
    jcfg, tcfg = _configs(scene, tmp)
    jr = JRunner(jcfg)
    rng = np.random.default_rng(12)
    splats = {k: np.array(v) for k, v in jr.splats.items()}
    alive = np.asarray(jg.alive_mask(jr.splats))
    # a mid-training state; the dead rows' positions made distinct too
    splats["shN"] = np.where(alive[:, None, None],
                             rng.normal(size=splats["shN"].shape) * 0.1, 0).astype(np.float32)
    splats["means"][~alive] = rng.normal(size=((~alive).sum(), 3)).astype(np.float32) * 3
    opt = {part: {k: (rng.uniform(0, 1e-4, size=v.shape) if part == "nu"
                      else rng.normal(size=v.shape) * 1e-3).astype(np.float32)
                  for k, v in splats.items()} for part in ("mu", "nu")}
    head = {k: np.asarray(v) for k, v in jr.seg_head.items()}
    jr.splats = jax.tree.map(jnp.asarray, splats)
    jr.opt_state = jax.tree.map(jnp.asarray, opt)
    strat = {k: np.asarray(v) for k, v in jr.strategy_state.items() if k != "scene_scale"}
    strat["scene_scale"] = jr.strategy_state["scene_scale"]
    state0 = {"step": 0, "splats": splats, "opt_state": opt, "strategy_state": strat,
              "segmentation_head": head}

    # the spatial regularizer's sample: jax.random.permutation under k_seg
    k_seg = jax.random.split(jr.key, 4)[3]
    draws = np.asarray(jax.random.permutation(k_seg, 512)).astype(np.int64)

    tr = TRunner(tcfg, device="cpu")
    tr.load_state_numpy(convert.runner_state_from_numpy(state0, device="cpu"))
    id_maps = (jr.render_identity_map(0), tr.render_identity_map(0))
    j_hist = jr.train()["history"]
    mp = pytest.MonkeyPatch()
    mp.setattr(tlos, "sample_indices", lambda gen, n, s: torch.from_numpy(draws[:s]))
    try:
        t_hist = tr.train()["history"]
    finally:
        mp.undo()
    return dict(jr=jr, tr=tr, state0=state0, j_hist=j_hist, t_hist=t_hist, id_maps=id_maps,
                tmp=tmp)


def test_one_seg_runner_step_matches_jax(one_step):
    jr, tr, state0 = one_step["jr"], one_step["tr"], one_step["state0"]
    jm, tm = _metrics(jr.cfg.result_dir), _metrics(tr.cfg.result_dir)
    for k in ("train/segloss", "train/spatialreg", "train/cluster_intra",
              "train/cluster_inter"):
        assert k in tm and tm[k] != 0.0, k
        _close_rel(tm[k], jm[k], SEG_RTOL, k)
    np.testing.assert_allclose(one_step["t_hist"][0]["loss"], one_step["j_hist"][0]["loss"],
                               rtol=SEG_RTOL)

    after = tr.state_numpy(1)
    lr = tr.optimizer.lr_at(1)
    opt0 = state0["opt_state"]
    for k, v0 in state0["splats"].items():
        rtol = SEG_RTOL if k == "identity_encodings" else MAIN_RTOL
        for part in ("mu", "nu"):
            _close_rel(after["opt_state"][part][k], np.asarray(jr.opt_state[part][k]), rtol,
                       f"{part}[{k}]")
        g = (np.asarray(jr.opt_state["mu"][k]) - 0.9 * opt0["mu"][k]) / 0.1
        strong = np.abs(g) > 1e-3 * np.abs(g).max()
        got, want = after["splats"][k], np.asarray(jr.splats[k])
        step = np.abs(want - v0).max()
        np.testing.assert_allclose(got[strong], want[strong], rtol=0, atol=1e-3 * step + 1e-7,
                                   err_msg=k)
        assert np.abs(got - want).max() <= 6.4 * lr[k], k
    # identity encodings moved by the segmentation gradients alone
    assert not np.array_equal(after["splats"]["identity_encodings"],
                              state0["splats"]["identity_encodings"])

    # the head: its own Adam (lr 1e-3, no bias correction) after one step
    for part in ("mu", "nu"):
        for k in ("w1", "b1", "w2", "b2"):
            _close_rel(tr.seg_opt_state[part][k].numpy(), np.asarray(jr.seg_opt_state[part][k]),
                       SEG_RTOL, f"head {part}[{k}]")
    for k, v in after["segmentation_head"].items():
        g = np.asarray(jr.seg_opt_state["mu"][k]) / 0.1
        strong = np.abs(g) > 1e-3 * np.abs(g).max()
        want = np.asarray(jr.seg_head[k])
        np.testing.assert_allclose(v[strong], want[strong], rtol=0, atol=3.2e-6, err_msg=k)
        assert np.abs(v - want).max() <= 6.4e-3, k


def test_render_identity_map_matches_jax(one_step):
    want, got = one_step["id_maps"]
    assert got.shape == want.shape == (48, 64, 16)
    _close_rel(got, want, 1e-5, "identity map")


def test_checkpoint_segmentation_head_read_back_by_jax(one_step, tmp_path):
    from tdgs.training.trainer import Runner as JRunner

    tr = one_step["tr"]
    path = tr.save_checkpoint(1)
    with open(path, "rb") as f:
        state = pickle.load(f)
    assert set(state) == {"step", "splats", "opt_state", "strategy_state",
                          "segmentation_head"}
    jcfg, _ = _configs(tr.cfg.data_dir, tmp_path)
    jr = JRunner(jcfg)
    assert jr.load_checkpoint(path) == 1
    for k, v in tr.seg_head.params().items():
        np.testing.assert_array_equal(np.asarray(jr.seg_head[k]), v.detach().numpy(), k)
    np.testing.assert_array_equal(np.asarray(jr.splats["identity_encodings"]),
                                  tr.splats["identity_encodings"].numpy())


def test_rally_e2e_chain_on_cpu(tmp_path):
    """The whole chain at a small size: every stage runs and the summary has
    the JAX example's keys (less the reference oracle's)."""
    from tdgs_torch.rally_e2e import main

    out = tmp_path / "summary.json"
    assert main(["--data-dir", str(tmp_path / "data"), "--out-dir", str(tmp_path / "out"),
                 "--steps", "30", "--n-dominoes", "3", "--n-images", "8",
                 "--data-width", "64", "--data-height", "48", "--gauss-per-domino", "150",
                 "--ground-gauss", "300", "--sfm-points", "400", "--capacity", "1200",
                 "--frames", "3", "--width", "96", "--height", "64", "--ckpt-every", "20",
                 "--gif", str(tmp_path / "rally.gif"), "--json", str(out),
                 "--device", "cpu"]) == 0
    summary = json.loads(out.read_text())
    jax_keys = {"steps", "n_dominoes", "train_psnr", "train_ssim", "num_gaussians",
                "clusters_found", "clusters_expected", "n_bodies", "kernel_vs_oracle_psnr",
                "rally_fps", "rally_physics_hz", "frames", "width", "height", "compile_s",
                "backend", "max_body_displacement", "wall_s", "north_star"}
    assert jax_keys <= set(summary)
    assert set(summary["stage_s"]) == {"dataset", "train", "cluster", "ply", "rally"}
    assert summary["clusters_expected"] == 3 and summary["seg_steps"] == 3
    assert 1 <= summary["clusters_found"] <= 3
    assert summary["n_bodies"] == summary["clusters_found"]
    assert summary["kernel_vs_oracle_psnr"] >= 40.0
    assert summary["max_body_displacement"] > 0 and np.isfinite(summary["train_psnr"])
    assert os.path.exists(tmp_path / "out" / "ckpts" / "ckpt_20.pkl")
    assert os.path.exists(tmp_path / "out" / "scene.ply")
    assert os.path.exists(tmp_path / "rally.gif")
