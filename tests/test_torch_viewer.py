"""The port's viewer (``tdgs_torch.viewer``, the Runner's live view,
``tdgs_torch.simple_viewer``) against the JAX package's on the CPU.

- ``load_test_data``, ``fly_camera`` and ``orbit_camera``: bitwise.
- ``make_splat_render_fn`` and ``Runner._viewer_render_fn``: uint8 frames
  within 1 level of the JAX package's (its "jax"/"eval3d" routes, the
  port's plain routes here) in every mode of every family (3DGS, 2DGS,
  3DGUT) on one small scene; the JAX 2DGS path is handed Mᵀ (ROADMAP,
  faults on the reference side).
- The HTTP round trip: the page, a JPEG within 3/255 of the frame, the
  knobs reaching ``RenderTabState``, 404 and 500. Each server binds a free
  port of its own (port 0); every request and join has a timeout.
- ``Config(disable_viewer=False)`` trains with the viewer serving frames,
  and on a gloo world of 2 ranks (``Config.sharded``) rank 0 answers
  requests during training without stalling the world; ``rasterization(
  distributed=True)`` there renders bitwise what ``rasterization_sharded``
  renders.
- ``python -m tdgs_torch.simple_viewer`` serves a frame.
"""

import concurrent.futures
import dataclasses
import io
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tdgs.ops.projection_2dgs as jproj2
from tdgs.viewer import server as jserver
from tdgs_torch.viewer import server as tserver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("rgb", "depth", "alpha")
FAMILIES = ("3dgs", "2dgs", "3dgut")


def _raw_splats(n=64, seed=5):
    rng = np.random.default_rng(seed)
    return {
        "means": rng.normal(size=(n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "scales": np.log(rng.uniform(0.05, 0.2, size=(n, 3))).astype(np.float32),
        "opacities": rng.normal(size=(n,)).astype(np.float32),
        "sh0": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "shN": (rng.normal(size=(n, 15, 3)) * 0.2).astype(np.float32),
    }


VM = jserver.orbit_camera(0.4, 0.3, 4.0, np.zeros(3, np.float32))
K = np.array([[80.0, 0, 48], [0, 80.0, 32], [0, 0, 1]], np.float32)


@pytest.fixture
def jax_2dgs_fixed(monkeypatch):
    """The JAX package's 2DGS path with Mᵀ handed to its rasterizers."""
    project = jproj2.fully_fused_projection_2dgs

    def transposed(*args, **kwargs):
        radii, means2d, depths, M, normals = project(*args, **kwargs)
        return radii, means2d, depths, jnp.swapaxes(M, -1, -2), normals

    monkeypatch.setattr(jproj2, "fully_fused_projection_2dgs", transposed)


def _within_one_level(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, (diff.max(), (diff > 1).sum())


@pytest.mark.parametrize("scene_grid", [1, 2])
def test_load_test_data_bitwise(scene_grid):
    from tdgs.utils.test_data import load_test_data as j_load
    from tdgs_torch.utils.test_data import load_test_data as t_load

    got, want = t_load(scene_grid=scene_grid, n=300), j_load(scene_grid=scene_grid, n=300)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("pose", [(0.3, 0.2, 5.0), (2.5, -0.7, 2.0), (0.0, 1.5, 9.0)])
def test_cameras_bitwise(pose):
    az, el, dist = pose
    target = np.array([0.5, -1.0, 0.25], np.float32)
    assert np.array_equal(tserver.orbit_camera(az, el, dist, target),
                          jserver.orbit_camera(az, el, dist, target))
    pos = np.array([6.0, 0.5, 2.0], np.float32)
    for pitch in (el, np.pi / 2):  # straight up takes the stable right
        assert np.array_equal(tserver.fly_camera(pos, az, pitch),
                              jserver.fly_camera(pos, az, pitch))


@pytest.mark.parametrize("family", FAMILIES)
def test_render_fn_matches_jax(family, jax_2dgs_fixed):
    raw = _raw_splats()
    want_fn = jserver.make_splat_render_fn({k: jnp.asarray(v) for k, v in raw.items()},
                                           model_type=family)
    got_fn = tserver.make_splat_render_fn(raw, model_type=family, device="cpu")
    for mode in MODES:
        st = tserver.RenderTabState(render_mode=mode, backgrounds=(0.2, 0.4, 0.6))
        js = jserver.RenderTabState(render_mode=mode, backgrounds=(0.2, 0.4, 0.6))
        want = want_fn(VM, K, 96, 64, js)
        got = got_fn(VM, K, 96, 64, st)
        assert want.max() > 0
        _within_one_level(got, want)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from tdgs_torch.utils.test_data import make_colmap_test_scene

    root = str(tmp_path_factory.mktemp("viewer_scene"))
    make_colmap_test_scene(root, device="cpu")
    return root


def _config(module, scene, result_dir, **kw):
    return module.Config(data_dir=scene, result_dir=result_dir, data_factor=1, max_steps=20,
                         eval_steps=[], save_steps=[], ply_steps=[], sh_degree=1,
                         sh_degree_interval=5, capacity=512, tile_capacity=256,
                         isect_capacity=1 << 14, test_every=4, tb_every=5, **kw)


@pytest.fixture(scope="module")
def runners(scene, tmp_path_factory):
    """One JAX Runner and one port Runner holding the same splats."""
    import tdgs.training.config as jcfg
    from tdgs.training.trainer import Runner as JRunner
    import tdgs_torch.training.config as tcfg
    from tdgs_torch.training.trainer import Runner as TRunner

    tmp = tmp_path_factory.mktemp("viewer_runners")
    jr = JRunner(_config(jcfg, scene, str(tmp / "j"), rasterizer="jax"))
    tr = TRunner(_config(tcfg, scene, str(tmp / "t")), device="cpu")
    raw = _raw_splats()
    jr.splats = {k: jnp.asarray(v) for k, v in raw.items()}
    tr.splats = {k: torch.as_tensor(v) for k, v in raw.items()}
    yield jr, tr
    tr.close()


@pytest.mark.parametrize("family", FAMILIES)
def test_runner_viewer_render_fn_matches_jax(runners, family, jax_2dgs_fixed):
    jr, tr = runners
    change = dict(model_type="2dgs") if family == "2dgs" else (
        dict(with_eval3d=True) if family == "3dgut" else {})
    jcfg0, tcfg0 = jr.cfg, tr.cfg
    jr.cfg, tr.cfg = dataclasses.replace(jcfg0, **change), dataclasses.replace(tcfg0, **change)
    try:
        for mode in MODES:
            for inverse in (False, True) if mode == "depth" else (False,):
                want = jr._viewer_render_fn(VM, K, 96, 64, jserver.RenderTabState(
                    render_mode=mode, inverse_depth=inverse, backgrounds=(0.3, 0.3, 0.9)))
                got = tr._viewer_render_fn(VM, K, 96, 64, tserver.RenderTabState(
                    render_mode=mode, inverse_depth=inverse, backgrounds=(0.3, 0.3, 0.9)))
                assert want.max() > 0
                _within_one_level(got, want)
    finally:
        jr.cfg, tr.cfg = jcfg0, tcfg0


def _get(url, timeout=60):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_http_roundtrip():
    from PIL import Image

    seen = []
    ys, xs = np.mgrid[0:30, 0:40]
    frame = np.stack([xs * 6, ys * 8, np.full_like(xs, 128)], -1).astype(np.uint8)

    def render_fn(vm, K_, w, h, st):
        if st.render_mode == "boom":
            raise RuntimeError("render failed")
        seen.append((vm, K_, w, h, dataclasses.replace(st)))
        return frame[:h, :w]

    viewer = tserver.ViewerServer(render_fn, width=80, height=60, port=0, host="127.0.0.1")
    th = viewer.start()
    base = f"http://127.0.0.1:{viewer.port}"
    try:
        code, ctype, body = _get(base + "/")
        assert code == 200 and ctype == "text/html" and b"tdgs viewer" in body
        assert b'width="80" height="60"' in body
        vm = np.arange(16, dtype=np.float32)
        q = ("/render?mode=depth&sh=2&near=0.5&far=9&rclip=1.5&eps2d=0.2&bg=0.1,0.2,0.3"
             "&w=40&h=30&vm=" + ",".join(str(x) for x in vm))
        code, ctype, body = _get(base + q)
        assert code == 200 and ctype == "image/jpeg" and body[:2] == b"\xff\xd8"
        got = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
        assert np.abs(got.astype(np.float32) - frame).mean() <= 3.0
        vm_seen, K_seen, w, h, st = seen[-1]
        assert (w, h) == (40, 30) and np.array_equal(vm_seen, vm.reshape(4, 4))
        assert np.allclose(K_seen, [[44.0, 0, 20], [0, 44.0, 15], [0, 0, 1]])
        assert (st.render_mode, st.max_sh_degree, st.near_plane, st.far_plane, st.radius_clip,
                st.eps2d, st.backgrounds) == ("depth", 2, 0.5, 9.0, 1.5, 0.2, (0.1, 0.2, 0.3))
        assert viewer.state.render_mode == "depth"
        # a fly camera and the orbit default
        _get(base + "/render?px=1&py=2&pz=3&yaw=0.5&pitch=-0.2")
        assert np.array_equal(seen[-1][0], tserver.fly_camera(
            np.array([1, 2, 3], np.float32), 0.5, -0.2))
        _get(base + "/render?az=0.7&dist=3&tz=1")
        assert np.array_equal(seen[-1][0], tserver.orbit_camera(
            0.7, 0.3, 3.0, np.array([0, 0, 1], np.float32)))
        code, _, body = _get(base + "/render?mode=boom")
        assert code == 500 and b"render failed" in body
        assert _get(base + "/nope")[0] == 404
    finally:
        viewer.shutdown()
        th.join(timeout=30)
    assert not th.is_alive()


def test_live_viewer_serves_during_training(scene, tmp_path):
    import tdgs_torch.training.config as tcfg
    from tdgs_torch.training.trainer import Runner
    from tdgs_torch.utils.ply import load_ply

    runner = Runner(_config(tcfg, scene, str(tmp_path / "r"), disable_viewer=False,
                            viewer_port=0), device="cpu")
    frames, codes = [], []
    stop = threading.Event()

    def client(port):
        while not stop.is_set():
            code, ctype, body = _get(f"http://127.0.0.1:{port}/render?w=48&h=32&dist=3")
            codes.append(code)
            frames.append(body[:2])

    th = threading.Thread(target=client, args=(runner.viewer.port,))
    th.start()
    try:
        hist = runner.train()["history"]
        n_during = len(frames)
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive()
    assert n_during > 0 and set(codes) == {200} and set(frames) == {b"\xff\xd8"}
    assert hist[-1]["loss"] < hist[0]["loss"]
    ply = runner.export_ply(20)
    splat = runner.export_ply(20, format="splat")
    from tdgs_torch.models.gaussians import alive_mask

    n_alive = int(alive_mask(runner.splats).sum())
    assert load_ply(ply)["means"].shape[0] == n_alive
    with open(splat, "rb") as f:
        assert len(f.read()) == 32 * n_alive
    runner.close()
    assert runner.viewer is None


@pytest.fixture(scope="module")
def sharded_world(scene, tmp_path_factory):
    from tdgs_torch import convert
    import tdgs_torch.training.config as tcfg
    from tdgs_torch.parallel import checks, launch

    cfg = _config(tcfg, scene, str(tmp_path_factory.mktemp("viewer_sharded")), batch_size=2)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(launch.run, checks.viewer_case, 2, convert.config_to_dict(cfg), "cpu",
                        device="cpu", timeout_s=240)
        return fut.result(timeout=300)


def test_sharded_live_viewer(sharded_world):
    r0, r1 = sharded_world
    assert r0["has_viewer"] and not r1["has_viewer"]
    assert r0["history"] == r1["history"]
    assert set(r0["statuses"]) == {200}
    # frames answered while the world trained, and one after it
    assert any(t < r0["train_s"] for t in r0["served"]), (r0["served"], r0["train_s"])
    assert r0["served"][-1] >= r0["train_s"]
    for mode, img in r0["modes"].items():
        assert img.shape == (32, 48, 3) and img.dtype == np.uint8 and img.max() > 0, mode


def test_distributed_kwarg_delegates_to_sharded_render(sharded_world):
    for r in sharded_world:
        for got, want in zip(r["distributed"]["got"], r["distributed"]["want"]):
            assert np.array_equal(got, want)


def test_simple_viewer_cli_serves_a_frame():
    proc = subprocess.Popen(
        [sys.executable, "-m", "tdgs_torch.simple_viewer", "--port", "0", "--host",
         "127.0.0.1", "--device", "cpu", "--width", "64", "--height", "48"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
    try:
        line = ""
        while "viewer at" not in line:
            line = proc.stdout.readline()
            assert line, "the viewer exited before serving"
        port = int(line.rsplit(":", 1)[1])
        code, ctype, body = _get(f"http://127.0.0.1:{port}/render?az=1.5&dist=7", timeout=120)
        assert code == 200 and body[:2] == b"\xff\xd8"
    finally:
        proc.kill()
        proc.wait(timeout=30)
