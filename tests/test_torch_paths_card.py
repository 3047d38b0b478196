"""The port's paths on the card, each at full size: the rally frame with its
physics, the bench scene's render and training step through each
rasterizer and camera, the ``Runner`` for 3DGS, 2DGS, 3DGUT and the
tile-dense path on a procedural 1236x822 COLMAP scene, the command lines,
the domino chain (train, segment, cluster, PLY, bodies, rally) with
kernels 1-3 at its trained shapes, the depth path, the trainer's optional
modules, the sharded render and trainer, and the viewer. Each path is held
to the launches of its kernels (one a frame or step; the Adam kernel and,
under MCMC, the position noise exactly one a step), finite outputs, and
what the path promises: a loss that drops, refines where the strategy
schedules them, a chain of one body per domino.

Each test records the launches it counted, after its own reset, as the
``launches`` property (``eval_launches`` for an evaluation), which
``chip_smoke.py`` prints by kernel. ``tests/test_torch_kernel_card.py``
holds each kernel against its plain version; this file holds the paths
that launch them. Every test here is marked ``cuda`` and skips without a
card; the file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_paths_card.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tdgs_torch
from tdgs_torch.ops import _build
from tdgs_torch.ops import adam as A
from tdgs_torch.ops import mcmc_noise as N
from tdgs_torch.ops import projection_2dgs as SP
from tdgs_torch.ops import projection_ut as U
from tdgs_torch.ops import rasterize_2dgs_packed as R2
from tdgs_torch.ops import rasterize_eval3d_packed as E
from tdgs_torch.ops import rasterize_pallas as RP
from tdgs_torch.ops import segment_sum as S
from tdgs_torch.ops.rasterize_packed import KERNEL, max_entries_per_tile
from tdgs_torch.physics import (
    PhysicsParams,
    extract_bodies_from_splats,
    initial_state,
    labels_to_body_ids,
    make_step_and_render,
    physics_step,
    settle_on_ground,
)
from tdgs_torch.physics.bodies import BodyState
from tdgs_torch.strategy import MCMCStrategy
from tdgs_torch.training.trainer import Runner
from tdgs_torch.utils.test_data import DOMINO_BACKGROUND, make_colmap_test_scene, make_rich_scene
from tests import card_scenes as C
from tests.test_torch_kernel_card import _assert_k1, _assert_k123

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 100  # the Runner cells' steps: refines at 40 and 80


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def bench(card):
    return C.to_card(C.bench_scene())


@pytest.fixture(scope="module")
def rich(card, tmp_path_factory):
    """make_rich_scene at the JAX package's defaults (40 images of
    1236x822, 150k ground-truth gaussians, 40k SfM points): (root, the
    ground truth)."""
    root = str(tmp_path_factory.mktemp("rich_scene"))
    return root, make_rich_scene(root, device="cuda")


def _launches(kernels):
    return {k: _build.LAUNCHES.get(k, 0) for k in kernels}


def mcmc_3dgut_options():
    """The mcmc preset (examples/simple_trainer.py:81-86) with 3DGUT, MCMC
    refining at steps 40 and 80 up to 160k gaussians."""
    strategy = MCMCStrategy(cap_max=160_000, refine_start_iter=20, refine_every=40,
                            refine_stop_iter=1000)
    return dict(strategy=strategy, with_ut=True, with_eval3d=True, init_opa=0.5,
                init_scale=0.1, opacity_reg=0.01, scale_reg=0.01)


def train_records(result_dir):
    """The training records of a Runner's metrics log."""
    with open(os.path.join(result_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "train/loss" in r]


# ---------------------------------------------------------------------------
# the rally frame: 16 dominoes at 1920x1080, 240 Hz physics, 8 substeps
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_rally_on_card(card, record_property):
    """The rally's physics: 8 substeps on the card within 1e-3 of the same
    8 on the CPU; then 90 frames of physics and render, each launching
    kernel 1, every frame finite, the bodies moving."""
    rally = C.to_card(C.rally_scene())
    labels = rally["labels"].cpu().numpy()
    bodies, groups = extract_bodies_from_splats(
        rally["means"].cpu().numpy(), rally["quats"].cpu().numpy(),
        rally["scales"].cpu().numpy(), rally["opacities"].cpu().numpy(), labels,
        device="cuda")
    bodies = settle_on_ground(bodies)
    body_ids = torch.as_tensor(labels_to_body_ids(labels, groups), device="cuda")
    state = initial_state(bodies)
    state.w[0, 1] = 4.0
    params = PhysicsParams(dt=1.0 / 240)

    def cpu(t):
        return type(t)(*[x.cpu() for x in t])

    b_cpu, s_cpu, s_card = cpu(bodies), cpu(state), state
    for _ in range(8):
        s_card = physics_step(s_card, bodies, params)
        s_cpu = physics_step(s_cpu, b_cpu, params)
    for f in BodyState._fields:
        assert float((getattr(s_card, f).cpu() - getattr(s_cpu, f)).abs().max()) <= 1e-3, f

    bg = torch.full((1, 3), DOMINO_BACKGROUND, device="cuda")

    def render_fn(m, q):
        img, alpha, _ = tdgs_torch.rasterization(
            m, q, rally["scales"], rally["opacities"], rally["sh"], rally["viewmats"],
            rally["Ks"], C.WIDTH, C.HEIGHT, sh_degree=3, backgrounds=bg, isect_exact=True,
            device="cuda")
        return img, alpha

    step = make_step_and_render({"means": rally["means"], "quats": rally["quats"]}, body_ids,
                                bodies, render_fn, params=params, substeps=8)
    n_frames = 90
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    _build.reset_launches()
    for _ in range(n_frames):
        state, img, alpha = step(state)
        finite &= torch.isfinite(img).all() & torch.isfinite(alpha).all()
    torch.cuda.synchronize()
    record_property("launches", _launches((KERNEL,)))
    assert _build.LAUNCHES.get(KERNEL, 0) >= n_frames
    assert bool(finite)
    assert float((state.x - bodies.com0).norm(dim=-1).max()) > 0.0


# ---------------------------------------------------------------------------
# the bench scene (200k gaussians at 1920x1080, SH 3, K = 16) through each
# rasterizer and camera: 20 frames, or 20 forward and backward steps
# ---------------------------------------------------------------------------

# name → (family, trains, rasterization options, the kernels each frame or
# step launches, the stream capacity)
RENDER_PATHS = {
    "3dgs_render": ("3dgs", False, {}, (KERNEL,), None),
    "3dgs_train": ("3dgs", True, dict(rasterizer="packed"), C.KERNELS, C.bench_capacity),
    "ortho_render": ("3dgs", False, dict(camera_model="ortho"), (KERNEL,), None),
    "fisheye_render": ("3dgs", False, dict(camera_model="fisheye"), (KERNEL,), None),
    "fisheye_train": ("3dgs", True, dict(camera_model="fisheye", rasterizer="packed"),
                      C.KERNELS, None),
    "2dgs_render": ("2dgs", False, dict(rasterizer="packed_inference"), (R2.KERNEL_FWD,),
                    C.bench_capacity_2dgs),
    "2dgs_train": ("2dgs", True, dict(render_mode="RGB+ED", distloss=True, rasterizer="packed"),
                   (R2.KERNEL_TRAIN, R2.KERNEL_BWD, S.KERNEL), C.bench_capacity_2dgs),
    "eval3d_render": ("3dgs", False, dict(rasterizer="eval3d_packed"), (E.KERNEL_FWD,),
                      C.bench_capacity),
    "eval3d_train": ("3dgs", True, dict(rasterizer="eval3d_packed"),
                     (E.KERNEL_TRAIN, E.KERNEL_BWD, S.KERNEL), C.bench_capacity),
    "pallas_render": ("3dgs", False, dict(rasterizer="pallas"), (RP.KERNEL_FWD,),
                      C.dense_capacity),
    "pallas_train": ("3dgs", True, dict(rasterizer="pallas"), C.DENSE_KERNELS,
                     C.dense_capacity),
}


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(RENDER_PATHS))
def test_render_path_on_card(bench, path, record_property):
    """20 frames, each re-projected and re-sorted (the opacities perturbed
    a frame), as the JAX package's bench.py times them; the training paths
    take the loss img.mean() + alpha.mean() (2DGS: + distortion.mean()) and
    its gradients to means, quats, scales, opacities and SH. Every loss and
    gradient finite, each kernel of the path launched every frame."""
    family, train, opts, kernels, capacity = RENDER_PATHS[path]
    sc = dict(bench, Ks=C.camera_Ks(opts["camera_model"])) if "camera_model" in opts else bench
    kw = dict(sh_degree=3, tile_capacity=1024, max_tiles_per_gauss=16, device="cuda", **opts)
    if capacity is not None:
        kw["isect_capacity"] = capacity(sc)
    render = tdgs_torch.rasterization_2dgs if family == "2dgs" else tdgs_torch.rasterization
    leaves = [sc[k].clone().requires_grad_(train)
              for k in ("means", "quats", "scales", "opacities", "sh")]
    n = 20
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    _build.reset_launches()
    for i in range(n):
        m, q, s, op, sh = leaves
        with torch.set_grad_enabled(train):
            out = render(m, q, s, op * (1.0 + 1e-5 * i), sh, sc["viewmats"], sc["Ks"], C.WIDTH,
                         C.HEIGHT, **kw)
            loss = out[0].mean()
            if train:
                loss = loss + (out[4] if family == "2dgs" else out[1]).mean()
                grads = torch.autograd.grad(loss, leaves)
                finite &= torch.stack([torch.isfinite(g).all() for g in grads]).all()
        finite &= torch.isfinite(loss)
    torch.cuda.synchronize()
    launches = _launches(kernels)
    record_property("launches", launches)
    assert bool(finite)
    for k, count in launches.items():
        assert count >= n, (k, count)


# ---------------------------------------------------------------------------
# the Runner on the rich scene, 100 steps, then eval on the test views
# ---------------------------------------------------------------------------

# model → (options, the kernels each step launches, the eval's kernel)
RUNNERS = {
    "3dgs": ({}, C.KERNELS, KERNEL),
    "2dgs": (dict(model_type="2dgs", normal_loss=True, dist_loss=True, normal_start_iter=30,
                  dist_start_iter=10), (S.KERNEL, R2.KERNEL_TRAIN, R2.KERNEL_BWD), R2.KERNEL_FWD),
    "3dgut": (None, (E.KERNEL_TRAIN, E.KERNEL_BWD, S.KERNEL), E.KERNEL_FWD),
    "pallas": (dict(rasterizer="pallas"), C.DENSE_KERNELS, KERNEL),
}


@pytest.mark.cuda
@pytest.mark.parametrize("model", list(RUNNERS))
def test_runner_on_card(rich, model, record_property):
    """The Runner at SH 3 (DefaultStrategy refining at 40 and 80; "3dgut":
    the mcmc preset with the UT projection and the eval3d rasterizer, MCMC
    refining at 40 and 80 up to 160k gaussians; "pallas": the tile-dense
    path), then eval through the forward-only kernel (1, 4 for 2DGS, 7 for
    3DGUT): the loss drops, the strategy refines at 40 and 80, every
    parameter, loss and eval number is finite, each kernel of the path
    launches every step, the Adam kernel exactly once a step, the position
    noise once a step under MCMC and never otherwise, the eval's kernel
    once a test view, and the UT projection's kernel once a render under
    3DGUT (each training step and test view) and never otherwise, the
    surfel projection's forward kernel once a render (each training step
    and each render of the eval) and its backward once a step under 2DGS
    and never otherwise."""
    root, _ = rich
    opts, kernels, eval_kernel = RUNNERS[model]
    opts = mcmc_3dgut_options() if opts is None else opts
    runner = Runner(C.cell_config(root, f"trainer_{model}", N_STEPS, tb_every=5, **opts),
                    device="cuda")
    try:
        _build.reset_launches()
        hist = runner.train()["history"]
        torch.cuda.synchronize()
        launches = _launches(kernels + (A.KERNEL, N.KERNEL, U.KERNEL, SP.KERNEL, SP.KERNEL_BWD))
        _build.reset_launches()
        stats = runner.eval(N_STEPS)
        eval_launches = _launches((eval_kernel, U.KERNEL, SP.KERNEL))
        views = len(runner.valset)
        record_property("launches", launches)
        record_property("eval_launches", eval_launches)
        assert eval_launches[eval_kernel] >= views, eval_launches
        assert all(bool(torch.isfinite(v).all()) for v in runner.splats.values())
        refined = [r["step"] for r in runner.refines]
        mcmc = isinstance(runner.strategy, MCMCStrategy)
    finally:
        runner.close()
    assert hist[-1]["loss"] < hist[0]["loss"], (hist[0], hist[-1])
    assert 40 in refined and 80 in refined, refined
    assert all(np.isfinite([h["loss"] for h in hist]))
    assert np.isfinite(stats["psnr"]) and np.isfinite(stats["ssim"])
    for k in kernels:
        assert launches[k] >= N_STEPS, (k, launches[k])
    assert launches[A.KERNEL] == N_STEPS
    assert launches[N.KERNEL] == (N_STEPS if mcmc else 0)
    ut = model == "3dgut"
    assert launches[U.KERNEL] == (N_STEPS if ut else 0)
    assert eval_launches[U.KERNEL] == (views if ut else 0)
    surfels = model == "2dgs"
    assert launches[SP.KERNEL] == launches[SP.KERNEL_BWD] == (N_STEPS if surfels else 0)
    assert eval_launches[SP.KERNEL] == (eval_launches[eval_kernel] if surfels else 0)


# ---------------------------------------------------------------------------
# the command lines, each in its own process
# ---------------------------------------------------------------------------

# name → (arguments after the interpreter, the kernels each step launches)
COMMANDS = {
    "simple_trainer_3dgut": (["-m", "tdgs_torch.simple_trainer", "mcmc", "--with-ut",
                              "--with-eval3d"], ()),
    "image_fitting_pallas": (["-m", "tdgs_torch.image_fitting", "--rasterizer", "pallas"],
                             C.DENSE_KERNELS),
    "image_fitting_2dgs": (["-m", "tdgs_torch.image_fitting", "--model-type", "2dgs"],
                           (R2.KERNEL_TRAIN, R2.KERNEL_BWD, S.KERNEL)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("command", list(COMMANDS))
def test_command_line_on_card(card, command, tmp_path, record_property):
    """``simple_trainer mcmc --with-ut --with-eval3d``: 60 steps on the
    64x48 test scene, then a finite eval. ``image_fitting`` through the
    tile-dense path and as 2DGS surfels at the example's defaults (128x128,
    2000 gaussians, 1000 Adam steps): the loss falls below 0.55 of its start
    (the JAX package's test margin), each kernel of the path launched every
    step."""
    args, kernels = COMMANDS[command]
    if command == "simple_trainer_3dgut":
        scene = str(tmp_path / "scene")
        make_colmap_test_scene(scene, device="cuda")
        args = args + ["--data-dir", scene, "--result-dir", str(tmp_path / "out"),
                       "--data-factor", "1", "--max-steps", "60", "--eval-steps", "60",
                       "--save-steps", "", "--cap-max", "2000", "--tile-capacity", "256",
                       "--sh-degree", "1", "--sh-degree-interval", "20", "--test-every", "4",
                       "--disable-video"]
    out = subprocess.run([sys.executable] + args, capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    if command == "simple_trainer_3dgut":
        assert np.isfinite(summary["psnr"]), summary
        return
    record_property("launches", summary["launches"])
    assert summary["final_loss"] < 0.55 * summary["initial_loss"], summary
    for k in kernels:
        assert summary["launches"].get(k, 0) >= 1000, (k, summary["launches"])


# ---------------------------------------------------------------------------
# the domino chain (python -m tdgs_torch.rally_e2e) at the JAX example's
# defaults: 6 dominoes, 32 views of 480x360, capacity 24k, 2000 steps,
# identity_dim 16; 90 rally frames at 1920x1080 on its derived tiling plan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chain(card, tmp_path_factory):
    """The chain written under a temporary root, no GIF: (root, its
    summary, kernels 1-3's launches)."""
    root = str(tmp_path_factory.mktemp("chain"))
    _build.reset_launches()
    summary = C.trained_chain(root)
    torch.cuda.synchronize()
    return root, summary, _launches(C.KERNELS)


@pytest.mark.cuda
def test_chain_on_card(chain, record_property):
    """One cluster and one body per domino, each cluster of at least a
    seventh of the 700 gaussians a domino is drawn with (a cluster of a few
    live rows is a domino lost to a neighbour's cluster, not a body), the
    kernel against the float64 golden at 40 dB or more, the bodies moving,
    a finite validation PSNR and rally, kernels 1-3 launched."""
    _, summary, launches = chain
    record_property("launches", launches)
    n = summary["n_dominoes"]
    assert summary["clusters_found"] == summary["clusters_expected"] == n, summary
    assert summary["n_bodies"] == n
    assert min(summary["cluster_sizes"], default=0) >= 700 // 7, summary["cluster_sizes"]
    assert summary["kernel_vs_oracle_psnr"] >= 40.0
    assert summary["max_body_displacement"] > 0.0
    assert np.isfinite(summary["train_psnr"])
    assert summary["all_frames_finite"]
    assert all(v > 0 for v in launches.values()), launches


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["identity_d16", "e_trained_dominoes_2048"])
def test_kernels_on_the_trained_chain_on_card(chain, case):
    """The chain's trained scene at its shapes (``card_scenes.chain_case``):
    kernels 1-3 at the identity render's D = 16 as ``_assert_k123`` holds
    them; kernel 1 at the rally frame, where the trained scene's products
    end near the 1e-4 cutoff, as ``_assert_k1`` holds it."""
    root, summary, _ = chain
    args, bg, tc = C.chain_case(root, summary, case)
    if case == "identity_d16":
        _assert_k123(args, tc, seed=3)
    else:
        _assert_k1(args, tc, bg)


@pytest.mark.cuda
def test_load_identity_encodings_on_card(chain, record_property):
    """``python -m tdgs_torch.load_identity_encodings`` (its ``main``) on the
    chain's checkpoint and scene, the K-means at its defaults, the view read
    in the chain's frame and taken from the side of the row (``--view-index
    6``: the first views look down the row, where the front dominoes hide
    the rear ones' masks): one cluster a domino, each of at least 100
    gaussians; kernel 1 renders the identity map at D = 16."""
    from tdgs_torch.load_identity_encodings import build_parser, run

    root, summary, _ = chain
    args = build_parser().parse_args([
        "--ckpt", f"{root}/out/ckpts/ckpt_{summary['steps']}.pkl", "--data-dir",
        f"{root}/data", "--out", f"{root}/cluster_groups_cli.npz", "--view-index", "6",
        "--no-normalize-world-space", "--device", "cuda"])
    _build.reset_launches()
    res = run(args)
    record_property("launches", _launches((KERNEL,)))
    assert res["clusters"] == summary["n_dominoes"], res
    assert min(res["cluster_sizes"], default=0) >= 100, res["cluster_sizes"]
    assert _build.LAUNCHES.get(KERNEL, 0) >= 1


# ---------------------------------------------------------------------------
# the trainer cell with the live viewer, and the PLY served by simple_viewer
# ---------------------------------------------------------------------------


def _http_get(url, timeout=120):
    """(status, body) of a GET."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.cuda
def test_runner_with_live_viewer_on_card(rich, record_property):
    """The trainer cell with the live viewer on (a free port): a client
    thread fetches 960x540 frames in a loop while it trains. The RGB loss
    drops, a frame is served during training, every frame is a JPEG with no
    500, kernels 1-3 launch every step; after training ``_viewer_render_fn``
    gives a frame in every mode for 3DGS (kernel 1) and for the same splats
    as 2DGS surfels (kernel 4); then the PLY and .splat exports, and the PLY
    served once by ``python -m tdgs_torch.simple_viewer --model-type 3dgut``
    (kernel 7) as a process of its own."""
    import dataclasses
    import threading

    from tdgs_torch.viewer import RenderTabState

    root, _ = rich
    w, h = 960, 540
    cfg = C.cell_config(root, "trainer_viewer", N_STEPS, disable_viewer=False, viewer_port=0)
    runner = Runner(cfg, device="cuda")
    frames, codes = [], []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            code, body = _http_get(f"http://127.0.0.1:{runner.viewer.port}/render?w={w}&h={h}"
                                   "&mode=rgb")
            codes.append(code)
            frames.append(body[:2] == b"\xff\xd8")

    th = threading.Thread(target=client, daemon=True)
    _build.reset_launches()
    th.start()
    try:
        runner.train()
        n_during = len(frames)
    finally:
        stop.set()
        th.join(timeout=120)
    launches = _launches(C.KERNELS)
    record_property("launches", launches)
    recs = train_records(cfg.result_dir)
    d = runner.trainset[0]
    vm, K = np.asarray(d["viewmat"]), np.asarray(d["K"])
    H, W = d["image"].shape[:2]
    live = {}
    for family, kernel in (("3dgs", KERNEL), ("2dgs", R2.KERNEL_FWD)):
        cfg0 = runner.cfg
        if family == "2dgs":
            runner.cfg = dataclasses.replace(cfg0, model_type="2dgs")
        _build.reset_launches()
        try:
            for mode in ("rgb", "depth", "alpha"):
                img = runner._viewer_render_fn(vm, K, W, H, RenderTabState(render_mode=mode))
                live[f"{family}_{mode}"] = bool(img.shape == (H, W, 3) and img.max() > 0)
        finally:
            runner.cfg = cfg0
        live[f"{family}_launches"] = _build.LAUNCHES.get(kernel, 0) >= 3
    ply = runner.export_ply(N_STEPS)
    splat = runner.export_ply(N_STEPS, format="splat")
    runner.close()
    assert os.path.getsize(ply) > 0 and os.path.getsize(splat) > 0

    proc = subprocess.Popen(
        [sys.executable, "-m", "tdgs_torch.simple_viewer", "--ply", ply, "--model-type", "3dgut",
         "--port", "0", "--host", "127.0.0.1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
    try:
        line, log = "", []
        while "viewer at" not in line:
            line = proc.stdout.readline()
            log.append(line)
            assert line, f"simple_viewer exited: {''.join(log)[-2000:]}"
        cli_code, cli_body = _http_get(
            f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}/render?w={w}&h={h}&dist=4")
    finally:
        proc.kill()
        proc.wait(timeout=60)
    assert recs[-1]["train/rgbloss"] < recs[0]["train/rgbloss"]
    assert n_during > 0
    assert set(codes) == {200} and all(frames), sorted(set(codes))
    assert all(live.values()), live
    assert cli_code == 200 and cli_body[:2] == b"\xff\xd8", cli_code
    for k in C.KERNELS:
        assert launches[k] >= N_STEPS, (k, launches[k])


# ---------------------------------------------------------------------------
# depth and normal supervision on the rich scene: its refined depths and
# normal maps, the Runner with every depth and normal term (with and without
# the decode-ahead), kernels 1-3 at its D = 4, the trajectory render, the
# sparse depths of a tracked copy
# ---------------------------------------------------------------------------

DEPTH_LOSSES = {"rgbloss", "depthloss", "normalloss", "depthsmooth", "normalconsist"}


@pytest.fixture(scope="module")
def depth(rich):
    """The depth maps written into the rich scene, then the depth path's
    Runner trained 100 steps and evaluated without and with the
    decode-ahead: (the maps' numbers, {prefetch: the run's record}); the
    record with the decode-ahead keeps its Runner."""
    root, gt = rich
    maps = C.write_depth_maps(root, gt)
    runs = {}
    for prefetch in (False, True):
        name = f"trainer_depth{'' if prefetch else '_no_prefetch'}"
        runner = Runner(C.cell_config(root, name, N_STEPS, data_prefetch=prefetch,
                                      **C.DEPTH_TERMS), device="cuda")
        _build.reset_launches()
        runner.train()
        torch.cuda.synchronize()
        launches = _launches(C.KERNELS)
        _build.reset_launches()
        stats = runner.eval(N_STEPS)
        records = train_records(runner.cfg.result_dir)
        runs[prefetch] = dict(
            runner=runner, launches=launches, stats=stats, records=records,
            eval_launches=_build.LAUNCHES.get(KERNEL, 0), views=len(runner.valset),
            vis=len(os.listdir(os.path.join(runner.cfg.result_dir, "vis"))))
        if not prefetch:
            runner.close()
    yield maps, runs
    runs[True]["runner"].close()


@pytest.mark.cuda
def test_depth_maps_on_card(depth, record_property):
    """The normalization keeps handedness, kernel 1 rendered every view,
    and each view's depth covers more than half of its pixels."""
    det, coverage, launches, views = depth[0]
    record_property("launches", {KERNEL: launches})
    assert det > 0
    assert launches >= views
    assert coverage > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch", "no_prefetch"])
def test_depth_runner_on_card(depth, prefetch, record_property):
    """Every loss term finite at the last step, the RGB loss dropped, the 20
    depth and normal dumps written, eval (PSNR, SSIM, LPIPS) finite, kernels
    1-3 launched every step and kernel 1 once a test view at eval."""
    run = depth[1][prefetch]
    record_property("launches", run["launches"])
    record_property("eval_launches", {KERNEL: run["eval_launches"]})
    last = run["records"][-1]
    terms = {k: last[f"train/{k}"] for k in DEPTH_LOSSES if f"train/{k}" in last}
    assert set(terms) == DEPTH_LOSSES, terms
    assert all(np.isfinite(v) for v in terms.values()), terms
    assert terms["rgbloss"] < run["records"][0]["train/rgbloss"]
    assert run["vis"] == 2 * (N_STEPS // 10)
    stats = run["stats"]
    assert np.isfinite(stats["psnr"]) and np.isfinite(stats["ssim"]) and stats["lpips_impl"]
    assert np.isfinite(stats.get("lpips_proxy", stats.get("lpips"))), stats
    assert run["eval_launches"] >= run["views"]
    for k in C.KERNELS:
        assert run["launches"][k] >= N_STEPS, (k, run["launches"][k])


@pytest.mark.cuda
@pytest.mark.parametrize("tile_capacity", [1024, 128])
def test_kernels_1_to_3_on_the_depth_path_on_card(depth, tile_capacity):
    """Kernel 1's training call, kernels 2 and 3 at D = 4 on the trained
    depth path's first training view (1236x822), also cut at
    tile_capacity 128, where a tile must reach the cut."""
    args = C.depth_kernel_inputs(depth[1][True]["runner"])
    if tile_capacity == 128:
        counts = torch.diff(args[7].long())
        assert int((counts > max_entries_per_tile(128)).sum()) > 0
    _assert_k123(args, tile_capacity, seed=4 if tile_capacity == 1024 else 5)


@pytest.mark.cuda
def test_depth_trajectory_on_card(depth, record_property):
    """The trajectory render at the end of training: 60 "interp" frames of
    the depth path's trained scene at 1236x822 through kernel 1's inference
    call, all written out (a GIF where PIL imports, else PNG frames)."""
    runner = depth[1][True]["runner"]
    n_frames = 60
    _build.reset_launches()
    frames = runner.traj_frames(n_frames, traj_path="interp")
    launches = _build.LAUNCHES.get(KERNEL, 0)
    record_property("launches", {KERNEL: launches})
    path = runner.write_traj(runner.cfg.max_steps, frames)
    if os.path.isdir(path):
        written = len(os.listdir(path))
    else:
        from PIL import Image

        with Image.open(path) as im:
            written = im.n_frames
    assert written == n_frames
    assert launches >= n_frames


@pytest.mark.cuda
def test_sparse_depth_runner_on_card(rich, tmp_path):
    """The Runner with the sparse depth loss on a tracked copy of the rich
    scene (each image tracks the SfM points that project inside it), 20
    steps: every training view has a point, the depth loss is finite."""
    from tdgs_torch.utils.test_data import tracked_copy

    root, _ = rich
    root_t = str(tmp_path / "tracked")
    os.makedirs(root_t)
    tracked_copy(root, root_t)
    runner = Runner(C.cell_config(root_t, "trainer_depth_sparse", 20, depth_loss=True),
                    device="cuda")
    try:
        names = [runner.parser.image_names[i] for i in runner.trainset.indices]
        counts = [len(runner.parser.point_indices[n]) for n in names]
        runner.train()
    finally:
        runner.close()
    assert min(counts) >= 1
    assert np.isfinite(train_records(runner.cfg.result_dir)[-1]["train/depthloss"])


# ---------------------------------------------------------------------------
# the trainer's optional modules: the pose corrector behind a fixed pose
# noise, the appearance module, the bilateral grids, the PNG compression
# ---------------------------------------------------------------------------

AUX_TERMS = ("rgbloss", "tvloss", "posereg", "appreg", "opacityreg", "scalereg")
AUX_MODULES = dict(pose_opt=True, pose_noise=1e-3, app_opt=True, use_bilateral_grid=True)


def _means_roundtrip_steps(splats, compress_dir):
    """How far the decompressed means lie from the compressed ones, in
    16-bit steps of their log-space span (the codec's quantum): the alive
    splats cropped and ordered as ``PngCompression.compress`` does."""
    from tdgs_torch.compression import PngCompression
    from tdgs_torch.models.gaussians import alive_mask
    from tdgs_torch.utils.ply import morton_sort_centers

    keep = alive_mask(splats)
    means = splats["means"][keep].detach().cpu().numpy()
    op = splats["opacities"][keep].detach().cpu().numpy()
    n = means.shape[0]
    side = int(np.floor(np.sqrt(n)))
    means = means[np.argsort(op)[n - side * side:]]
    means = means[morton_sort_centers(means)]
    dec = PngCompression(device="cuda").decompress(compress_dir)["means"]

    def log(x):
        return np.sign(x) * np.log1p(np.abs(x))

    step = (log(means).max(0) - log(means).min(0)) / 65535
    return float((np.abs(log(dec) - log(means)) / step).max())


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["3dgs", "3dgut"])
def test_runner_with_aux_modules_on_card(rich, model, record_property):
    """100 steps, then eval, the pose corrector at its default lr (1e-5)
    behind a fixed pose noise of 1e-3. "3dgs": the trainer cell with the
    pose corrector, the appearance module and the bilateral grids, then
    ``run_compression``; "3dgut": the 3DGUT cell with the pose corrector
    and noise. Every loss term and eval number finite, the RGB loss
    dropped, the corrector moved and finite, each kernel of the path
    launched every step ("3dgut": the UT projection's kernel exactly once a
    step); "3dgs" also: cc_psnr at least psnr − 1e-3 dB (the
    identity affine is in the fit's family), the compressed eval finite,
    the decompressed means within one 16-bit step of their log-space span."""
    from tdgs_torch.models.gaussians import alive_mask

    root, _ = rich
    if model == "3dgut":
        cfg = C.cell_config(root, "trainer_3dgut_pose", N_STEPS, pose_opt=True, pose_noise=1e-3,
                            **mcmc_3dgut_options())
        kernels = (E.KERNEL_TRAIN, E.KERNEL_BWD, S.KERNEL, U.KERNEL)
    else:
        cfg = C.cell_config(root, "trainer_aux", N_STEPS, **AUX_MODULES)
        kernels = C.KERNELS
    runner = Runner(cfg, device="cuda")
    try:
        _build.reset_launches()
        runner.train()
        torch.cuda.synchronize()
        launches = _launches(kernels)
        record_property("launches", launches)
        stats = runner.eval(N_STEPS)
        embeds = runner.camera_opt.embeds.detach()
        moved = float(embeds.abs().max())
        assert bool(torch.isfinite(embeds).all())
        if model == "3dgs":
            comp = runner.run_compression(N_STEPS)
            cdir = os.path.join(cfg.result_dir, "compression")
            steps_off = _means_roundtrip_steps(runner.splats, cdir)
            assert int(alive_mask(runner.splats).sum()) > 0
    finally:
        runner.close()
    records = train_records(cfg.result_dir)
    terms = {k: records[-1][f"train/{k}"] for k in AUX_TERMS if f"train/{k}" in records[-1]}
    assert "rgbloss" in terms and all(np.isfinite(v) for v in terms.values()), terms
    assert terms["rgbloss"] < records[0]["train/rgbloss"]
    assert np.isfinite(stats["psnr"]) and np.isfinite(stats["ssim"])
    assert 0.0 < moved < np.inf
    for k in kernels:
        assert launches[k] >= N_STEPS, (k, launches[k])
    if model == "3dgut":
        assert launches[U.KERNEL] == N_STEPS, launches
    if model == "3dgs":
        assert stats["cc_psnr"] >= stats["psnr"] - 1e-3, stats
        assert np.isfinite(comp["psnr"]), comp
        assert steps_off <= 1.0, steps_off


# ---------------------------------------------------------------------------
# the sharded path: the bench scene seen by two cameras on a world of 2
# ranks sharing the card (gloo) and of 1 (NCCL); the trainer cell sharded
# over 2 ranks at batch 2
# ---------------------------------------------------------------------------

SHARDED_WORLDS = {2: list(C.SHARDED_CASES), 1: ["3dgs_packed"]}
SHARDED_STEPS = 5


@pytest.fixture(scope="module")
def sharded(card):
    """Each world's ranks (``card_scenes.sharded_render_rank``)."""
    from tdgs_torch.parallel import launch

    caps = {"pallas": C.dense_capacity(C.to_card(C.sharded_scene()))}
    return {world: launch.run(C.sharded_render_rank, world, names, caps, SHARDED_STEPS,
                              device="cuda", timeout_s=600)
            for world, names in SHARDED_WORLDS.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("world,case", [(w, n) for w, names in SHARDED_WORLDS.items()
                                        for n in names])
def test_sharded_render_at_full_size_on_card(sharded, world, case, record_property):
    """The sharded render (``parallel.sharded_render``) of the bench scene
    (200k gaussians, SH 3, 1920x1080) seen by two cameras, so that kernels
    1-10 run through the exchange: on each rank every output and gradient
    finite, n_dropped equal to the single-rank render's, outputs within TOL
    and each input's gradient (summed over the ranks) within BWD_RTOL of the
    single-rank render of its camera, each kernel launched every step, and
    the backend the mesh's rule gives the world."""
    from tdgs_torch.parallel.mesh import choose_backend

    kernels = C.SHARDED_CASES[case][4]
    record_property("launches", {k: sum(r["cases"][case]["launches"][k] for r in sharded[world])
                                 for k in kernels})
    for rank in sharded[world]:
        c = rank["cases"][case]
        assert rank["backend"] == choose_backend("cuda", world), rank["backend"]
        assert c["finite"], (rank["rank"], c)
        assert c["n_dropped"] == c["single_n_dropped"], (rank["rank"], c)
        assert c["max_abs_err"] <= C.TOL, (rank["rank"], c)
        assert max(c["max_rel_err"].values(), default=0.0) <= C.BWD_RTOL, (rank["rank"], c)
        for k in kernels:
            assert c["launches"][k] >= SHARDED_STEPS, (rank["rank"], k, c["launches"])


@pytest.mark.cuda
def test_sharded_runner_on_card(rich, record_property):
    """The trainer cell (1236x822, DefaultStrategy refining at 40 and 80)
    trained gaussian-sharded (``Config.sharded``) at batch 2 for 100 steps
    on two ranks sharing the card: its first step's loss within 2e-4 of the
    single-rank Runner's at batch 2 (the JAX package's bound for its sharded
    step), the RGB loss dropping, the strategy refining at 40 and 80, a
    finite eval and parameters, kernels 1-3 launched every step, and the
    sharded checkpoint read back bit for bit by a new sharded Runner."""
    from tdgs_torch.parallel import launch

    root, _ = rich
    single = Runner(C.sharded_config(root, N_STEPS, False), device="cuda")
    try:
        loss_single = single.train()["history"][0]["loss"]
    finally:
        single.close()
    ranks = launch.run(C.sharded_runner_rank, 2, root, N_STEPS, device="cuda", timeout_s=900)
    r0 = next(r for r in ranks if r["rank"] == 0)
    record_property("launches", {k: sum(r["launches"][k] for r in ranks) for k in C.KERNELS})
    rgb = [r["train/rgbloss"] for r in train_records(r0["result_dir"])]
    assert abs(r0["history"][0]["loss"] - loss_single) <= 2e-4, (r0["history"][0], loss_single)
    assert rgb[-1] < rgb[0], (rgb[0], rgb[-1])
    assert np.isfinite(r0["eval_psnr"]) and all(r["all_finite"] for r in ranks)
    assert all(r["ckpt_roundtrip_bitwise"] for r in ranks)
    refined = [r["step"] for r in r0["refines"]]
    assert 40 in refined and 80 in refined, refined
    for k in C.KERNELS:
        assert sum(r["launches"][k] for r in ranks) >= N_STEPS, k


# ---------------------------------------------------------------------------
# the viewer: the bench scene served at 1920x1080 for each family
# ---------------------------------------------------------------------------

VIEWER_KERNELS = {"3dgs": KERNEL, "2dgs": R2.KERNEL_FWD, "3dgut": E.KERNEL_FWD}


def _viewer_poses(n, seed=5):
    """The bench view and n − 1 poses near it (turned by up to 0.04 rad,
    moved by up to 0.3), each still facing the scene."""
    from tdgs_torch.ops.transforms import quat_to_rotmat

    rng = np.random.default_rng(seed)
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        q = np.concatenate([[1.0], rng.uniform(-0.02, 0.02, 3)]).astype(np.float32)
        vm = np.eye(4, dtype=np.float32)
        vm[:3, :3] = quat_to_rotmat(torch.as_tensor(q / np.linalg.norm(q))).numpy()
        vm[:3, 3] = rng.uniform(-0.3, 0.3, 3)
        poses.append(vm)
    return poses


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(VIEWER_KERNELS))
def test_viewer_serves_the_bench_scene_on_card(bench, family, record_property):
    """A ``ViewerServer`` on 127.0.0.1 over ``make_splat_render_fn``: the
    page, rgb/depth/alpha once each, then 20 rgb frames through ``?vm=``
    (the bench view and poses near it). No status but 200, the family's
    kernel launched once a request, the bench view's frame within 1 level
    of a direct ``rasterization`` call after the same conversion and not
    black, its served JPEG within 3 levels (mean) of it."""
    import io

    from PIL import Image

    from tdgs_torch.viewer import server as V

    raw = dict(means=bench["means"], quats=bench["quats"], scales=torch.log(bench["scales"]),
               opacities=torch.logit(bench["opacities"]), sh0=bench["sh"][:, :1],
               shN=bench["sh"][:, 1:])
    poses = _viewer_poses(20)
    fn = V.make_splat_render_fn(raw, model_type=family, device="cuda")
    server = V.ViewerServer(fn, width=C.WIDTH, height=C.HEIGHT, port=0, host="127.0.0.1",
                            focal=float(bench["Ks"][0, 0, 0]))
    th = server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        codes = [_http_get(base + "/")[0]]
        for mode in ("rgb", "depth", "alpha"):
            codes.append(_http_get(f"{base}/render?w={C.WIDTH}&h={C.HEIGHT}&mode={mode}")[0])
        _build.reset_launches()
        bodies = []
        for vm in poses:
            q = ",".join(repr(float(x)) for x in vm.reshape(-1))
            code, body = _http_get(f"{base}/render?w={C.WIDTH}&h={C.HEIGHT}&mode=rgb&vm={q}")
            codes.append(code)
            bodies.append(body)
        launches = _build.LAUNCHES.get(VIEWER_KERNELS[family], 0)
        # the UT projection's too: the viewer renders 3DGUT without with_ut
        record_property("launches", _launches((VIEWER_KERNELS[family], U.KERNEL)))
        K = server.intrinsics(C.WIDTH, C.HEIGHT)
        frame = fn(poses[0], K, C.WIDTH, C.HEIGHT, V.RenderTabState(render_mode="rgb"))
    finally:
        server.shutdown()
        th.join(timeout=30)
    kw = dict(sh_degree=3, backgrounds=torch.zeros((1, 3), device="cuda"),
              rasterizer=V.viewer_rasterizer(family, torch.device("cuda")), device="cuda")
    args = (bench["means"], bench["quats"], torch.exp(raw["scales"]),
            torch.sigmoid(raw["opacities"]), bench["sh"],
            torch.as_tensor(poses[0], device="cuda")[None],
            torch.as_tensor(K, device="cuda")[None], C.WIDTH, C.HEIGHT)
    with torch.no_grad():
        render = tdgs_torch.rasterization_2dgs if family == "2dgs" else tdgs_torch.rasterization
        res = render(*args, **kw)
    want = V.frame_to_uint8(res[0], res[1], "rgb")
    served = np.asarray(Image.open(io.BytesIO(bodies[0])).convert("RGB"))
    assert set(codes) == {200}, sorted(set(codes))
    assert launches >= len(poses), launches
    assert int(np.abs(frame.astype(np.int16) - want.astype(np.int16)).max()) <= 1
    assert frame.mean() > 1.0
    assert float(np.abs(served.astype(np.float32) - frame).mean()) <= 3.0
