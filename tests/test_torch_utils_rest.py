"""The port's remaining utilities against the JAX package's, on the CPU:

- ``utils/logger.py``: the JSONL records (and the TensorBoard mirror's
  files); ``device_mem_gb`` is None without a card.
- ``utils/profiler.py``: ``timeit`` accumulates only under TIMEIT=1,
  ``reset``/``summary`` as in JAX, ``trace`` writes a trace.
- ``utils/viz.py``: ``set_random_seed`` seeds random and numpy as JAX does
  (draws equal) and returns a seeded generator; the carried viridis table
  equals matplotlib's; ``save_disparity_image`` writes the JAX package's
  pixels (dense and sparse); ``colormap`` the JAX package's canvas.
- ``segmentation/visualize.py``: ``pca_project`` within 1e-5 of its
  maximum, ``identity_map_to_rgb`` and ``save_identity_map`` equal,
  ``save_depth_as_image`` the JAX package's pixels, ``tsne_plot`` writes a
  PNG.
- ``utils/golden.py compose_reference_2dgs_f64``: equal to the JAX one
  handed Mᵀ (it reads the rows), within 1e-12.
- ``load_identity_encodings``: the K-means labels of the live rows equal
  the JAX example's over a checkpoint of the live rows only (the JAX
  example clusters every row; ROADMAP, faults on the reference side); the
  dead rows are background.
"""

import importlib.util
import json
import os
import pickle
import random
import sys

import numpy as np
import pytest
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _png(path):
    return np.asarray(Image.open(path).convert("RGB"))


def test_metrics_logger_records(tmp_path):
    from tdgs_torch.utils.logger import MetricsLogger, device_mem_gb

    log = MetricsLogger(str(tmp_path / "r"))
    log.log(3, {"train/loss": 0.25, "train/n": 7, "skip": None, "name": "x",
                "t": torch.tensor(1.5)})
    log.log(4, {"train/loss": 0.125})
    log.close()
    recs = [json.loads(l) for l in open(log.path)]
    assert [r["step"] for r in recs] == [3, 4]
    assert {k: v for k, v in recs[0].items() if k != "time"} == {
        "step": 3, "train/loss": 0.25, "train/n": 7.0, "t": 1.5}
    assert os.listdir(tmp_path / "r" / "tb")  # the TensorBoard mirror wrote its events
    MetricsLogger(str(tmp_path / "s"), use_tensorboard=False).close()
    assert not os.path.exists(tmp_path / "s" / "tb")
    assert device_mem_gb() is None


def test_profiler_accumulates_under_timeit(monkeypatch, tmp_path):
    from tdgs_torch.utils import profiler

    profiler.reset()
    monkeypatch.setenv("TIMEIT", "0")
    with profiler.timeit("off"):
        pass
    assert profiler.profiler == {}
    monkeypatch.setenv("TIMEIT", "1")

    @profiler.timeit("fn")
    def work():
        return sum(range(1000))

    for _ in range(3):
        work()
    with profiler.timeit("block"):
        work()
    assert set(profiler.profiler) == {"fn", "block"}
    assert profiler.profiler["fn"] >= profiler.profiler["block"] > 0
    lines = profiler.summary().splitlines()
    assert [l.split(":")[0] for l in lines] == ["block", "fn"] and lines[0].endswith(" ms")
    profiler.reset()
    assert profiler.profiler == {} and profiler.device_memory_stats() is None
    with profiler.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))


def test_set_random_seed_matches_jax():
    from tdgs.utils.viz import set_random_seed as j_seed
    from tdgs_torch.utils.viz import set_random_seed as t_seed

    j_seed(123)
    want = (random.random(), np.random.rand(4))
    g = t_seed(123)
    got = (random.random(), np.random.rand(4))
    assert got[0] == want[0] and np.array_equal(got[1], want[1])
    assert torch.equal(torch.rand(5, generator=g),
                       torch.rand(5, generator=torch.Generator().manual_seed(123)))


def test_viridis_table_is_matplotlibs():
    from matplotlib import colormaps

    from tdgs_torch.utils._viridis import VIRIDIS

    assert np.array_equal(VIRIDIS, np.asarray(colormaps["viridis"].colors, np.float32))


@pytest.mark.parametrize("cmap", ["viridis", None])
def test_save_disparity_image_matches_jax(tmp_path, cmap):
    from tdgs.utils.viz import save_disparity_image as j_save
    from tdgs_torch.utils.viz import save_disparity_image as t_save

    rng = np.random.default_rng(8)
    disp = rng.uniform(0.1, 2.0, size=(24, 32)).astype(np.float32)
    j_save(disp, str(tmp_path / "j.png"), cmap=cmap)
    t_save(disp, str(tmp_path / "t.png"), cmap=cmap)
    assert np.array_equal(_png(tmp_path / "t.png"), _png(tmp_path / "j.png"))
    pts = rng.uniform(0, [32, 24], size=(40, 2))
    j_save(disp.reshape(-1)[:40], str(tmp_path / "js.png"), points=pts, height=24, width=32, cmap=cmap)
    t_save(disp.reshape(-1)[:40], str(tmp_path / "ts.png"), points=pts, height=24, width=32, cmap=cmap)
    assert np.array_equal(_png(tmp_path / "ts.png"), _png(tmp_path / "js.png"))


def test_colormap_matches_jax():
    from tdgs.utils.viz import colormap as j_cm
    from tdgs_torch.utils.viz import colormap as t_cm

    img = np.linspace(0, 1, 30 * 40).reshape(30, 40)
    assert np.array_equal(t_cm(img, "jet"), j_cm(img, "jet"))


def test_identity_visualizations_match_jax(tmp_path):
    from tdgs.segmentation import visualize as J
    from tdgs_torch.segmentation import visualize as T

    rng = np.random.default_rng(9)
    X = rng.normal(size=(200, 16)).astype(np.float32)
    got, want = T.pca_project(X, 3), J.pca_project(X, 3)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    fmap = rng.normal(size=(12, 20, 16)).astype(np.float32)
    assert np.array_equal(T.identity_map_to_rgb(fmap), J.identity_map_to_rgb(fmap))
    T.save_identity_map(fmap, str(tmp_path / "t.png"))
    J.save_identity_map(fmap, str(tmp_path / "j.png"))
    assert np.array_equal(_png(tmp_path / "t.png"), _png(tmp_path / "j.png"))
    depth = rng.uniform(1, 5, size=(12, 20)).astype(np.float32)
    depth[:3] = 0.0  # invalid
    T.save_depth_as_image(depth, str(tmp_path / "td.png"))
    J.save_depth_as_image(depth, str(tmp_path / "jd.png"))
    assert np.array_equal(_png(tmp_path / "td.png"), _png(tmp_path / "jd.png"))
    labels = np.repeat(np.arange(-1, 3), 15)
    out = T.tsne_plot(X[:60], labels, str(tmp_path / "tsne.png"))
    assert _png(out).shape[-1] == 3


def test_golden_2dgs_matches_jax_with_transposed_rays():
    from tdgs.utils.golden import compose_reference_2dgs_f64 as j_gold
    from tdgs_torch.utils.golden import compose_reference_2dgs_f64 as t_gold

    rng = np.random.default_rng(12)
    N, tw, th, ts = 40, 3, 2, 16
    means2d = rng.uniform(0, [48, 32], size=(N, 2)).astype(np.float32)
    # ray transforms of surfels in front of a pinhole camera: rows of K·[RS | t]
    M = rng.normal(size=(N, 3, 3)).astype(np.float32) * 0.1
    M[:, 2, 2] = rng.uniform(3, 6, size=N)
    M[:, 0, 2] = means2d[:, 0] * M[:, 2, 2]
    M[:, 1, 2] = means2d[:, 1] * M[:, 2, 2]
    M = np.swapaxes(M, -1, -2).copy()  # the port's layout: those rows as columns
    ids = np.concatenate([rng.permutation(N)[:25] for _ in range(tw * th)]).astype(np.int32)
    offsets = np.arange(0, 25 * tw * th + 1, 25)
    ch = rng.uniform(size=(N, 4)).astype(np.float32)
    op = rng.uniform(0.3, 1.0, size=N).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3, 0.0])
    got = t_gold(offsets, ids, means2d, M, ch, op, 48, 32, ts, tw, th, background=bg)
    want = j_gold(offsets, ids, means2d, np.swapaxes(M, -1, -2), ch, op, 48, 32, ts, tw, th,
                  background=bg)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-12
    assert got[1].max() > 0.5


@pytest.fixture(scope="module")
def identity_checkpoint(tmp_path_factory):
    """A domino scene (3 dominoes, 8 views of 64x48 with instance masks)
    and a checkpoint of its ground-truth gaussians: identity encodings one
    per domino (and the ground) plus noise, a random head, and 300 dead
    capacity rows sharing one encoding; and a copy holding the live rows
    only."""
    from tdgs_torch.models.gaussians import DEAD_OPACITY_LOGIT, rgb_to_sh
    from tdgs_torch.segmentation.head import head_to_numpy, init_segmentation_head
    from tdgs_torch.utils.test_data import make_domino_scene

    tmp = tmp_path_factory.mktemp("identity")
    gt = make_domino_scene(str(tmp / "data"), n_dominoes=3, n_images=8, width=64, height=48,
                           gauss_per_domino=150, ground_gauss=300, sfm_points=400,
                           device="cpu")
    rng = np.random.default_rng(6)
    n = gt["means"].shape[0]
    codes = rng.normal(size=(4, 16)).astype(np.float32)
    enc = codes[gt["labels"]] + rng.normal(size=(n, 16)).astype(np.float32) * 0.1
    live = {
        "means": gt["means"], "quats": gt["quats"], "scales": np.log(gt["scales"]),
        "opacities": np.log(gt["opacities"] / (1 - gt["opacities"])),
        "sh0": rgb_to_sh(gt["colors"])[:, None, :].astype(np.float32),
        "shN": np.zeros((n, 15, 3), np.float32), "identity_encodings": enc,
    }
    live = {k: np.asarray(v, np.float32) for k, v in live.items()}
    dead = {k: np.repeat(v[:1] * 0, 300, axis=0) for k, v in live.items()}
    dead["opacities"][:] = DEAD_OPACITY_LOGIT
    dead["quats"][:, 0] = 1.0
    dead["identity_encodings"][:] = 0.5
    full = {k: np.concatenate([live[k], dead[k]]) for k in live}
    head = head_to_numpy(init_segmentation_head(torch.Generator().manual_seed(1),
                                                device="cpu"))
    paths = {}
    for name, splats in (("full", full), ("live", live)):
        paths[name] = str(tmp / f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump({"step": 1, "splats": splats, "segmentation_head": head}, f)
    return str(tmp / "data"), paths, n


def _jax_cli(argv):
    spec = importlib.util.spec_from_file_location(
        "jax_load_identity_encodings", os.path.join(REPO, "examples",
                                                    "load_identity_encodings.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = ["load_identity_encodings.py"] + argv
    try:
        mod.main()
    finally:
        sys.argv = old


def test_load_identity_encodings_matches_jax(identity_checkpoint, tmp_path):
    from tdgs_torch import load_identity_encodings as cli
    from tdgs_torch.segmentation.clustering import load_cluster_groups

    data, paths, n_live = identity_checkpoint
    args = ["--data-dir", data, "--view-index", "2"]
    _jax_cli(["--ckpt", paths["live"], "--out", str(tmp_path / "j.npz")] + args)
    assert cli.main(["--ckpt", paths["full"], "--out", str(tmp_path / "t.npz"),
                     "--device", "cpu"] + args) == 0
    want, got = load_cluster_groups(str(tmp_path / "j.npz")), load_cluster_groups(
        str(tmp_path / "t.npz"))
    assert sorted(got) == sorted(want) and len(want) == 4  # 3 clusters and the background
    for key in want:
        if key == "background":  # and the dead rows
            assert np.array_equal(got[key], np.concatenate([want[key],
                                                            np.arange(n_live, n_live + 300)]))
        else:
            assert np.array_equal(got[key], want[key]), key
