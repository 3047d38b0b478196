"""The port's 3DGS trainer end to end on the CPU: 60 steps on the port's
own ``make_colmap_test_scene`` (loss drops by 20%, eval PSNR > 15, as the
JAX package's tests/test_trainer.py holds its Runner), checkpoints that
restore params, moments and step, the command line, and the PNG codec the
scene writer and reader use where PIL is missing."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from tdgs_torch.strategy import DefaultStrategy
from tdgs_torch.training.config import Config
from tdgs_torch.training.trainer import Runner
from tdgs_torch.utils.png import read_png, write_png
from tdgs_torch.utils.test_data import make_colmap_test_scene


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
    root = str(tmp_path_factory.mktemp("scene"))
    make_colmap_test_scene(root, device="cpu")
    return root


def _config(scene, result_dir, absgrad=False, **kw):
    base = dict(
        data_dir=scene, result_dir=result_dir, data_factor=1, max_steps=60,
        eval_steps=[60], save_steps=[60], sh_degree=1, sh_degree_interval=20,
        strategy=DefaultStrategy(refine_start_iter=10, refine_every=20,
                                 refine_stop_iter=100, reset_every=10_000,
                                 absgrad=absgrad),
        capacity=512, tile_capacity=256, isect_capacity=1 << 14, test_every=4,
        tb_every=10,
    )
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("absgrad", [False, True])
def test_trainer_loss_drops_and_eval(scene, tmp_path, absgrad):
    cfg = _config(scene, str(tmp_path / "results"), absgrad=absgrad)
    runner = Runner(cfg, device="cpu")
    out = runner.train()
    hist = out["history"]
    assert hist[-1]["loss"] < hist[0]["loss"] * 0.8, hist
    assert [r["step"] for r in runner.refines] == [20, 40, 60]
    stats = runner.eval(60)
    assert stats["psnr"] > 15.0, stats
    with open(tmp_path / "results" / "stats" / "val_step60.json") as f:
        assert json.load(f)["psnr"] == pytest.approx(stats["psnr"])
    ckpt = tmp_path / "results" / "ckpts" / "ckpt_60.pkl"
    assert ckpt.exists()

    # the file holds builtins and numpy arrays only, under the JAX keys
    with open(ckpt, "rb") as f:
        raw = pickle.load(f)
    assert set(raw) == {"step", "splats", "opt_state", "strategy_state"}
    assert set(raw["opt_state"]) == {"mu", "nu"}
    assert all(isinstance(v, np.ndarray) for v in raw["splats"].values())

    runner2 = Runner(cfg, device="cpu")
    assert runner2.load_checkpoint(str(ckpt)) == 60
    for k, v in runner.splats.items():
        torch.testing.assert_close(runner2.splats[k], v, rtol=0, atol=0)
        for part in ("mu", "nu"):
            torch.testing.assert_close(runner2.opt_state[part][k],
                                       runner.opt_state[part][k], rtol=0, atol=0)
    torch.testing.assert_close(runner2.strategy_state["grad2d"],
                               runner.strategy_state["grad2d"], rtol=0, atol=0)
    ply = runner2.export_ply(60)
    assert os.path.getsize(ply) > 0


def test_capacity_grows_with_dead_rows(scene, tmp_path):
    cfg = _config(scene, str(tmp_path / "r"), max_steps=20, eval_steps=[],
                  save_steps=[], capacity=130, max_capacity=1000,
                  capacity_growth_at=0.5)
    runner = Runner(cfg, device="cpu")
    assert runner.capacity == 130
    runner.train()
    assert runner.capacity == 260
    for k, v in runner.splats.items():
        assert v.shape[0] == 260, k
        assert runner.opt_state["mu"][k].shape[0] == 260, k
    assert runner.strategy_state["grad2d"].shape == (260,)


def test_trainer_batch_size_2(scene, tmp_path):
    """Two views a step fold into the camera axis; the taps and the
    strategy state keep consistent shapes (as the JAX package's
    test_trainer_batch_size_2)."""
    cfg = _config(scene, str(tmp_path / "r"), max_steps=30, eval_steps=[],
                  save_steps=[], batch_size=2, capacity=512)
    runner = Runner(cfg, device="cpu")
    hist = runner.train()["history"]
    assert hist[-1]["loss"] < hist[0]["loss"], hist
    assert bool(torch.isfinite(runner.strategy_state["grad2d"]).all())
    assert float(runner.strategy_state["count"].max()) > 0


def test_simple_trainer_cli_on_cpu(scene, tmp_path, capsys):
    from tdgs_torch.simple_trainer import main

    rc = main(["default", "--data-dir", scene, "--result-dir", str(tmp_path / "o"),
               "--data-factor", "1", "--max-steps", "12", "--eval-steps", "12",
               "--save-steps", "", "--capacity", "256", "--tile-capacity", "256",
               "--sh-degree", "1", "--test-every", "4", "--tb-every", "4",
               "--disable-video", "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["psnr"] > 0
    rc = main(["mcmc", "--with-ut", "--with-eval3d", "--data-dir", scene,
               "--result-dir", str(tmp_path / "m"), "--data-factor", "1", "--max-steps", "12",
               "--eval-steps", "12", "--save-steps", "", "--cap-max", "256",
               "--tile-capacity", "256", "--sh-degree", "1", "--test-every", "4",
               "--tb-every", "4", "--disable-video", "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["psnr"] > 0


def test_png_codec_reads_every_filter(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = np.stack([(xx * 4) % 256, (yy * 6) % 256, ((xx + yy) * 3) % 256], -1)
    for k, img in enumerate([rng.integers(0, 256, (37, 53, 3)), smooth]):
        img = img.astype(np.uint8)
        mine = str(tmp_path / f"m{k}.png")
        write_png(mine, img)
        np.testing.assert_array_equal(np.asarray(PIL.open(mine)), img)
        np.testing.assert_array_equal(read_png(mine), img)
        # PIL picks adaptive row filters (Sub, Up, Average, Paeth)
        theirs = str(tmp_path / f"p{k}.png")
        PIL.fromarray(np.dstack([img, img[..., :1]])).save(theirs, optimize=True)
        np.testing.assert_array_equal(read_png(theirs), np.dstack([img, img[..., :1]]))
    with pytest.raises(ValueError):  # not a PNG file
        read_png(__file__)


def test_colmap_scene_writer_matches_reference(tmp_path):
    """Same seeds, same draws: the COLMAP files are byte for byte the JAX
    package's; the images, rendered by each package's own rasterizer,
    agree to within one 8-bit level on average."""
    from tdgs.utils import test_data as jtd
    from tdgs_torch.utils import test_data as ttd

    j_root, t_root = tmp_path / "j", tmp_path / "t"
    jtd.make_colmap_test_scene(str(j_root))
    ttd.make_colmap_test_scene(str(t_root), device="cpu")
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (j_root / "sparse" / "0" / f).read_bytes() == \
            (t_root / "sparse" / "0" / f).read_bytes(), f
    for png in sorted((j_root / "images").iterdir()):
        a = read_png(str(png)).astype(np.int32)
        b = read_png(str(t_root / "images" / png.name)).astype(np.int32)
        assert np.abs(a - b).mean() < 1.0, png.name
