"""Smoke run of the PyTorch/CUDA port on one GPU: build the kernels, hold
each against its plain PyTorch version, drive the domino-rally frame end to
end at 1920x1080, time the bench-scale render, drive 3DGS training (the
bench-scale forward+backward step, and the Runner on a rich procedural
COLMAP scene), then the same for 2DGS surfels (the bench-scale render and
training step, the Runner with the normal and distortion losses) and for
3DGUT (the world-space eval3d rasterizer at the bench scale, σ* against
float64, the Runner with the mcmc preset, the command line) and for the
tile-dense rasterizer (``rasterizer="pallas"``: kernels 9 and 10 at the
bench scale, the bench render and training step, the Runner, the
image-fitting example), then the domino chain of ``tdgs_torch.rally_e2e``
(instance masks, training with identity-vector segmentation, clustering,
PLY, bodies, the rally on its derived tiling plan against a float64
golden) with kernels 1-3 held and timed at its shapes and the
segmentation step's cost, then the depth path on the rich scene (its
refined depths and normal maps rendered through kernel 1, the Runner with
the dense depth, depth-normal and monocular-normal terms and LPIPS, with
and without the decode-ahead, kernels 1-3 held and timed at its D = 4,
the trajectory render, the sparse depth loss on a tracked copy) and the
ortho and fisheye cameras at the bench scale, then the trainer's optional
modules on the rich scene (the pose corrector behind a fixed pose noise,
the appearance module and the bilateral grids with the colour-corrected
eval and the PNG compression's round trip; the pose corrector under
3DGUT), the dense plain-tensor rasterizers (eval3d and 2DGS "jax") against
kernels 5-8 on a window of the bench view, and the surfel image fit, then
the gaussian-sharded path of ``tdgs_torch.parallel`` (the trainer cell
trained by two ranks sharing the card through ``torch.distributed.run``,
its first loss against the single-rank Runner's and its sharded checkpoint
read back; the bench scene seen by two cameras on a world of 2 ranks over
gloo, kernels 1-10 through the exchange against the single-rank render,
and on a world of 1 over NCCL), then the viewer (``tdgs_torch.viewer``:
the bench scene served at 1920x1080 for each family through kernels 1, 4
and 7, each frame held against a direct render and its JPEG against the
frame; the trainer cell with the live viewer serving frames while it
trains, then its PLY served by ``python -m tdgs_torch.simple_viewer``),
kernel 4 against the float64 surfel golden, and the clustering command
line (``python -m tdgs_torch.load_identity_encodings``) on the chain's
checkpoint, and print one JSON line per phase.

    python3 chip_smoke.py

Needs a CUDA card and this repository's ``tdgs_torch`` package; it exits
non-zero without either. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is what nvidia-smi
reports for the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import tdgs_torch
from tdgs_torch.main import default_camera
from tdgs_torch.models.gaussians import rgb_to_sh
from tdgs_torch.ops import _build
from tdgs_torch.ops import adam as A
from tdgs_torch.ops import mcmc_noise as N
from tdgs_torch.ops import segment_sum as S
from tdgs_torch.ops.rasterize_packed import (
    BLOCKS_A_TILE as P_BLOCKS_A_TILE,
    KERNEL,
    KERNEL_BWD,
    max_entries_per_tile,
    pixel_entry_evaluations,
    rasterize_packed_bwd,
    rasterize_packed_bwd_plain,
    rasterize_packed_train_fwd,
    rasterize_packed_train_fwd_plain,
    rasterize_to_pixels_packed_inference,
    rasterize_to_pixels_packed_inference_plain,
)
from tdgs_torch.ops import rasterize_2dgs_packed as R2
from tdgs_torch.ops import rasterize_pallas as RP
from tdgs_torch.ops import rasterize_eval3d_packed as E
from tdgs_torch.ops.camera_models import RollingShutterType
from tdgs_torch.physics import (
    PhysicsParams,
    extract_bodies_from_splats,
    initial_state,
    labels_to_body_ids,
    make_step_and_render,
    physics_step,
    settle_on_ground,
)
from tdgs_torch.physics.bodies import BodyState, RigidBodies
from tdgs_torch.rendering import _colors_per_camera
from tdgs_torch.strategy import DefaultStrategy, MCMCStrategy
from tdgs_torch.training.bilateral_grid import init_bilateral_grid
from tdgs_torch.training.config import Config
from tdgs_torch.ops.tiling import derive_isect_capacity
from tdgs_torch.training.trainer import Runner
from tdgs_torch.utils.test_data import (
    DOMINO_BACKGROUND,
    make_domino_scene_arrays,
    make_colmap_test_scene,
    make_rich_scene,
)

DEVICE = "cuda"
WIDTH, HEIGHT = 1920, 1080
TOL = 1e-3  # kernel vs plain version, absolute, colors and alphas
BWD_RTOL = 1e-3  # kernel 2 vs plain: max|Δ| / max|plain| per gradient group
SEG_RTOL = 1e-5  # kernel 3 vs plain: max|Δ| / max|plain| per column group
ADAM_ULPS = 4  # the Adam kernel vs plain: float32 ulps of the value (and of the step)
KERNELS = (KERNEL, KERNEL_BWD, S.KERNEL)
DENSE_KERNELS = (RP.KERNEL_FWD, RP.KERNEL_BWD, S.KERNEL)
DIST_RTOL = 1e-3  # kernel 5 vs plain: distortion, max|Δ| / max|plain|
MEDIAN_SHARE = 0.01  # kernel 5 vs plain: share of pixels whose median differs
SIGMA_TOL = 1e-3  # eval3d σ* (float32, σ* < 4) vs float64, absolute

# FP32 operations of one (pixel, entry) evaluation that both compositing
# kernels make: sigma 11, exp 2, alpha 2, tests 2, transmittance 3. Every
# walked evaluation costs the walk; only a live one (included, past the
# sigma and 1/255 tests) goes on to the colours or the gradients. The op
# counts below take evals = (walked, live), as the plain walks count them.
WALK_OPS = 20


def fwd_ops(D, evals):
    """The forward's: the walk, then at each live evaluation the weight (1)
    and a multiply-add per channel."""
    walked, live = evals
    return walked * WALK_OPS + live * (1 + 2 * D)


def bwd_ops(D, evals):
    """The backward's: the walk, then at each live evaluation w (1), r
    (2·D), the prefix and suffix (3), 1/(1 − α) (1), v_alpha (5), v_sigma
    (2), the five geometry terms (16), the opacity term (1), the colours
    (D), and one add per value into the entry's sums (6 + D)."""
    walked, live = evals
    return walked * WALK_OPS + live * (35 + 4 * D)


# FP32 operations of one (pixel, entry) evaluation of the 2DGS walk
# (rasterize_2dgs_common.cuh and the kernels' loops): tmp 12, the tmpz
# guard 2, the guarded reciprocal 2, sigma3d 6, dx/dy 2, sigma2d 4, the min
# and the half 2, exp 2, alpha 2, the 1/255 test 1, transmittance 2, the
# cutoff test 1
WALK_OPS_2DGS = 38


def fwd_2dgs_ops(DA, train, evals):
    """Kernels 4 and 5: the walk, then at each live evaluation the weight
    (1), a multiply-add per channel; the training call adds the distortion
    (8) and the median (3)."""
    walked, live = evals
    return walked * WALK_OPS_2DGS + live * (1 + 2 * DA + (11 if train else 0))


def bwd_2dgs_ops(DA, evals):
    """Kernel 6: the walk, then at each live evaluation w (1), r (2·DA), the
    distortion chain (22), the prefix and suffix (3), v_alpha (6), the clamp
    test (1), v_sigma and the opacity term (3), the branch test (2), the
    σ3d branch's nine geometry terms (14), the depth term (1), the channels
    (DA), and one add per value into the entry's sums (12 + DA)."""
    walked, live = evals
    return walked * WALK_OPS_2DGS + live * (1 + 2 * DA + 22 + 3 + 6 + 1 + 3 + 2 + 14 + 1
                                            + DA + 12 + DA)


# FP32 operations of one (pixel, entry) evaluation of the eval3d walk
# (rasterize_eval3d_common.cuh and the kernels' loops): r = M d 15, g.r 5,
# the cross product 9, |c|^2 5, |r|^2 and its floor 6, the division and the
# half 2, the gate 1, exp 2, alpha 2, the 1/255 test 1, transmittance 2, the
# cutoff test 1; g = g0 + M o' adds 18 when the camera is not central
WALK_OPS_EVAL3D = 51


def fwd_eval3d_ops(D, central, evals):
    """Kernel 7: the walk, then at each live evaluation the weight (1), a
    multiply-add per channel."""
    walked, live = evals
    return walked * (WALK_OPS_EVAL3D + (0 if central else 18)) + live * (1 + 2 * D)


def bwd_eval3d_ops(D, central, evals):
    """Kernel 8: the walk, then at each live evaluation w (1), r_ch (2·D),
    the prefix (2), 1/(1 − α) and v_alpha (6), the clamp test (1), v_sigma
    and the opacity term (3), k and coef (4), u = r × c (9), v_r and v_g
    (6), d M (9, or 27 with the o' terms), v_d (18, and v_o' 18 more), the
    colours (D), and one add per value into the entry's sums (13 + D)."""
    walked, live = evals
    per_ray = 9 + 18 if central else 27 + 36
    return (walked * (WALK_OPS_EVAL3D + (0 if central else 18))
            + live * (1 + 2 * D + 2 + 6 + 1 + 3 + 4 + 9 + 6 + per_ray + D + 13 + D))


# H100 SXM published peaks: HBM bytes/s, FP32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------


def bench_scene(n=200_000, seed=0, scale_range=(0.005, 0.03)):
    """The 200k-gaussian 1080p scene of the JAX package's bench.py."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * np.array(
        [3.0, 2.0, 1.0], np.float32) + np.array([0, 0, 8.0], np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = rng.uniform(*scale_range, size=(n, 3)).astype(np.float32)
    opacities = rng.uniform(0.3, 1.0, size=(n,)).astype(np.float32)
    sh = (rng.normal(size=(n, 16, 3)) * 0.2).astype(np.float32)
    viewmats = np.eye(4, dtype=np.float32)[None]
    f = 1400.0
    Ks = np.array([[[f, 0, WIDTH / 2], [0, f, HEIGHT / 2], [0, 0, 1]]], np.float32)
    return dict(means=means, quats=quats, scales=scales, opacities=opacities,
                sh=sh, viewmats=viewmats, Ks=Ks)


def rally_scene(seed=3):
    """16 dominoes x 2500 gaussians on 10k ground disks, SH degree 3."""
    s = make_domino_scene_arrays(n_dominoes=16, n_images=1, width=WIDTH,
                                 height=HEIGHT, gauss_per_domino=2500,
                                 ground_gauss=10_000, seed=seed)
    rng = np.random.default_rng(seed + 1)
    n = s["means"].shape[0]
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0] = rgb_to_sh(s["colors"])
    sh[:, 1:] = rng.normal(size=(n, 15, 3)) * 0.05
    viewmat, K = default_camera(s["means"], WIDTH, HEIGHT)
    return dict(means=s["means"], quats=s["quats"], scales=s["scales"],
                opacities=s["opacities"], sh=sh, viewmats=viewmat[None],
                Ks=K[None], labels=s["labels"] - 1)


def to_card(scene):
    return {k: torch.as_tensor(v, device=DEVICE) for k, v in scene.items()}


def kernel_inputs(sc, render_mode="RGB", backgrounds=None, **kw):
    """The compositing kernel's inputs for one frame, built by the port's
    own projection, SH and tiling (rasterization's meta + its colors)."""
    _, _, meta = tdgs_torch.rasterization(
        sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["sh"],
        sc["viewmats"], sc["Ks"], WIDTH, HEIGHT, sh_degree=3,
        render_mode=render_mode, backgrounds=backgrounds, device=DEVICE, **kw)
    colors = _colors_per_camera(sc["sh"], 3, sc["means"], sc["viewmats"], meta["radii"])
    if render_mode == "RGB+ED":
        colors = torch.cat([colors, meta["depths"][..., None]], -1)
        if backgrounds is not None:
            backgrounds = torch.cat([backgrounds, backgrounds.new_zeros((1, 1))], -1)
    args = (meta["means2d"].contiguous(), meta["conics"].contiguous(),
            colors.contiguous(), meta["opacities"].contiguous(), WIDTH, HEIGHT,
            meta["tile_size"], meta["isect_offsets"], meta["flatten_ids"])
    return args, backgrounds, meta


def time_ms(fn, reps):
    """Mean device time of fn() over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Mean device time of fn() over reps runs captured in one CUDA graph
    and replayed, by CUDA events: the host's time to make each call, which
    exceeds the device's for a kernel of tens of microseconds called
    through Python, drops out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def named_rows(offsets, ids, tile_capacity):
    """(entries the tiles keep after the cut, distinct gaussians those
    entries name)."""
    starts = offsets[:-1].long()
    counts = torch.clamp(torch.diff(offsets.long()), 0, max_entries_per_tile(tile_capacity))
    entries = int(counts.sum())
    # stream positions each tile reads: its start plus 0..count-1
    pos = torch.arange(entries, device=ids.device) + torch.repeat_interleave(
        starts - (torch.cumsum(counts, 0) - counts), counts, output_size=entries)
    return entries, int(torch.unique(ids[pos]).numel())


def kernel_work(args, tile_capacity):
    """(pixel, entry) evaluations (walked, live), bytes and the least time
    the card could take for one launch on these inputs."""
    means2d, conics, colors, opac, W, H, ts, offsets, ids = args
    D = colors.shape[-1]
    n_images = means2d.numel() // (means2d.shape[-2] * 2)
    evals = pixel_entry_evaluations(*args, tile_capacity=tile_capacity)
    entries, rows = named_rows(offsets, ids, tile_capacity)
    # each input read once: the feature rows (means2d, conics, opacity,
    # colors) of the gaussians the cut ranges name, their flatten ids and
    # the offsets; colors and alphas written once
    n_bytes = (rows * (6 + D) * 4 + entries * 4 + offsets.numel() * 4
               + n_images * W * H * (D + 1) * 4)
    n_ops = fwd_ops(D, evals)
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32 * 1e3
    return dict(evaluations=evals, entries=entries, rows=rows, bytes=n_bytes, fp32_ops=n_ops,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def parity(name, args, backgrounds=None, tile_capacity=1024):
    """Kernel vs plain version on the same inputs; fails above TOL, or if a
    second launch differs from the first in a bit."""
    got = rasterize_to_pixels_packed_inference(*args, backgrounds=backgrounds,
                                               tile_capacity=tile_capacity)
    again = rasterize_to_pixels_packed_inference(*args, backgrounds=backgrounds,
                                                 tile_capacity=tile_capacity)
    repeat_bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
    want = rasterize_to_pixels_packed_inference_plain(
        *args, backgrounds=backgrounds, tile_capacity=tile_capacity)
    torch.cuda.synchronize()
    errs = {}
    for key, g, w in (("colors", got[0], want[0]), ("alphas", got[1], want[1])):
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"parity {name}: non-finite kernel {key}")
        d = (g - w).abs()
        errs[f"{key}_max_abs_err"] = float(d.max())
        errs[f"{key}_mean_abs_err"] = float(d.mean())
    counts = torch.diff(args[7].long())
    emit("parity", case=name, tol=TOL, D=args[2].shape[-1], tile_capacity=tile_capacity,
         n_isects=int(counts.sum()), max_tile_range=int(counts.max()),
         tiles_cut=int((counts > max_entries_per_tile(tile_capacity)).sum()),
         alpha_mean=float(want[1].mean()), repeat_bitwise=repeat_bitwise,
         blocks_a_tile=P_BLOCKS_A_TILE.get(KERNEL), **errs)
    if not repeat_bitwise:
        raise RuntimeError(f"parity {name}: two launches of kernel 1 differ")
    worst = max(errs["colors_max_abs_err"], errs["alphas_max_abs_err"])
    if not worst <= TOL:
        raise RuntimeError(f"parity {name}: max abs err {worst} > {TOL}")
    return worst


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_parity(bench, rally, heavy):
    errs = []
    args, _, _ = kernel_inputs(bench, max_tiles_per_gauss=16)
    errs.append(parity("a_bench_rgb", args))
    bg = torch.tensor([[0.3, 0.5, 0.7]], device=DEVICE)
    args_ed, bg4, _ = kernel_inputs(bench, render_mode="RGB+ED", backgrounds=bg,
                                    max_tiles_per_gauss=16)
    errs.append(parity("b_bench_rgb_ed_background", args_ed, backgrounds=bg4))
    args_h, _, _ = kernel_inputs(heavy, isect_exact=True)
    errs.append(parity("c_heavy_overlap_truncated", args_h, tile_capacity=128))
    args_d, _, _ = kernel_inputs(rally, isect_exact=True)
    errs.append(parity("d_domino_exact", args_d))
    return max(errs)


def phase_physics_parity(rally_bodies: RigidBodies, state: BodyState):
    """8 substeps on the card against the same 8 on the CPU."""
    params = PhysicsParams(dt=1.0 / 240)
    def cpu(t):
        return type(t)(*[x.cpu() for x in t])

    b_cpu, s_cpu, s_gpu = cpu(rally_bodies), cpu(state), state
    for _ in range(8):
        s_gpu = physics_step(s_gpu, rally_bodies, params)
        s_cpu = physics_step(s_cpu, b_cpu, params)
    err = max(float((getattr(s_gpu, f).cpu() - getattr(s_cpu, f)).abs().max())
              for f in BodyState._fields)
    emit("physics_parity", steps=8, max_abs_err_card_vs_cpu=err)
    if not err <= 1e-3:
        raise RuntimeError(f"physics card vs cpu: {err}")


def phase_rally(rally, n_frames=90, substeps=8):
    labels = rally["labels"].cpu().numpy()
    bodies, groups = extract_bodies_from_splats(
        rally["means"].cpu().numpy(), rally["quats"].cpu().numpy(),
        rally["scales"].cpu().numpy(), rally["opacities"].cpu().numpy(), labels,
        device=DEVICE)
    bodies = settle_on_ground(bodies)
    body_ids = torch.as_tensor(labels_to_body_ids(labels, groups), device=DEVICE)
    state = initial_state(bodies)
    state.w[0, 1] = 4.0
    phase_physics_parity(bodies, state)

    bg = torch.full((1, 3), DOMINO_BACKGROUND, device=DEVICE)
    ev = []
    last = {}

    def render_fn(m, q):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        img, alpha, meta = tdgs_torch.rasterization(
            m, q, rally["scales"], rally["opacities"], rally["sh"],
            rally["viewmats"], rally["Ks"], WIDTH, HEIGHT, sh_degree=3,
            backgrounds=bg, isect_exact=True, device=DEVICE)
        e1.record()
        ev.append((e0, e1))
        last.update(meta=meta, means=m, quats=q)
        return img, alpha

    step = make_step_and_render(
        {"means": rally["means"], "quats": rally["quats"]}, body_ids, bodies,
        render_fn, params=PhysicsParams(dt=1.0 / 240), substeps=substeps)
    # one warm-up frame (allocator, library handles), then the timed run
    step(state)
    torch.cuda.synchronize()
    ev.clear()

    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    frame_start = []
    n_dropped = 0
    _build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(n_frames):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        frame_start.append(e)
        state, img, alpha = step(state)
        finite &= torch.isfinite(img).all() & torch.isfinite(alpha).all()
        n_dropped = max(n_dropped, last["meta"]["n_dropped"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.LAUNCHES.get(KERNEL, 0)

    physics_ms = [s.elapsed_time(r0) for s, (r0, _) in zip(frame_start, ev)]
    render_ms = [r0.elapsed_time(r1) for r0, r1 in ev]
    frame_ms = np.add(physics_ms, render_ms)
    disp = float((state.x - bodies.com0).norm(dim=-1).max())
    emit("rally", frames=n_frames, width=WIDTH, height=HEIGHT, substeps=substeps,
         physics_hz=240, n_gaussians=int(rally["means"].shape[0]),
         n_bodies=int(bodies.mass.shape[0]), fps=n_frames / wall, wall_s=wall,
         physics_ms_per_frame=float(np.mean(physics_ms)),
         render_ms_per_frame=float(np.mean(render_ms)),
         # median and the highest percentile with >= 10 frames beyond it
         frame_ms_p50=float(np.percentile(frame_ms, 50)),
         frame_ms_p88=float(np.percentile(frame_ms, 88)),
         kernel_launches=launches, max_body_displacement=disp,
         n_dropped=n_dropped, n_isects_last=last["meta"]["n_isects"],
         all_frames_finite=bool(finite))
    if launches < n_frames:
        raise RuntimeError(f"rally launched the kernel {launches} < {n_frames} times")
    if not disp > 0.0:
        raise RuntimeError("rally: no body moved")
    if not bool(finite):
        raise RuntimeError("rally: non-finite frame")
    phase_trace(rally, bodies, body_ids, state, substeps)
    # the kernel's inputs on the last frame, for its timing at rally shapes
    frame = dict(rally, means=last["means"], quats=last["quats"])
    args, bg_last, _ = kernel_inputs(frame, backgrounds=bg, isect_exact=True)
    return launches, args, bg_last


def traced(fn):
    """Run fn() once under torch.profiler: (device kernels launched, device
    busy ms, wall ms, idle share). Kernels on one stream do not overlap, so
    busy time is the sum of kernel durations. None where the profiler saw
    no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return dict(kernels=None, device_busy_ms=None, wall_ms=wall_ms, idle_share=None)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(kernels=len(kernels), device_busy_ms=busy_ms, wall_ms=wall_ms,
                idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                top_ms={name[:80]: ms for name, ms in top})


def phase_trace(rally, bodies, body_ids, state, substeps=8):
    """One rally frame traced in its two halves (tracing off for the
    end-to-end numbers above): device launches, busy time and idle share."""
    from tdgs_torch.physics import apply_cluster_transforms

    params = PhysicsParams(dt=1.0 / 240)
    box = {}

    def physics():
        st = state
        for _ in range(substeps):
            st = physics_step(st, bodies, params)
        box["state"] = st

    def render():
        m, q = apply_cluster_transforms(rally["means"], rally["quats"], body_ids,
                                        box["state"], bodies)
        tdgs_torch.rasterization(
            m, q, rally["scales"], rally["opacities"], rally["sh"],
            rally["viewmats"], rally["Ks"], WIDTH, HEIGHT, sh_degree=3,
            backgrounds=torch.full((1, 3), DOMINO_BACKGROUND, device=DEVICE),
            isect_exact=True, device=DEVICE)

    physics()  # warm
    render()
    emit("rally_trace", substeps=substeps, physics=traced(physics),
         render=traced(render))


def measure_kernel(args, backgrounds=None, tile_capacity=1024, reps=20):
    """Kernel 1's inference call: by CUDA events and by graph replay, its
    plain version's time and its bound."""
    def kernel():
        rasterize_to_pixels_packed_inference(*args, backgrounds=backgrounds,
                                             tile_capacity=tile_capacity)

    ms = time_ms(kernel, reps)
    device_graph_ms = graph_ms(kernel, reps)
    plain_ms = time_ms(lambda: rasterize_to_pixels_packed_inference_plain(
        *args, backgrounds=backgrounds, tile_capacity=tile_capacity), 3)
    return dict(ms=ms, device_graph_ms=device_graph_ms, plain_ms=plain_ms,
                blocks_a_tile=P_BLOCKS_A_TILE.get(KERNEL), **kernel_work(args, tile_capacity))


def phase_bench(bench, n_frames=20):
    """20 frames of the 200k scene, each re-projected and re-sorted, as the
    JAX package's bench.py times them (opacities perturbed per frame)."""

    def frame(i):
        img, _, meta = tdgs_torch.rasterization(
            bench["means"], bench["quats"], bench["scales"],
            bench["opacities"] * (1.0 + 1e-5 * i), bench["sh"], bench["viewmats"],
            bench["Ks"], WIDTH, HEIGHT, sh_degree=3, tile_capacity=1024,
            max_tiles_per_gauss=16, device=DEVICE)
        return img, meta

    _, meta = frame(0)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    acc = torch.zeros((), device=DEVICE)
    for i in range(n_frames):
        img, _ = frame(i)
        acc += img.mean()
    torch.cuda.synchronize()
    fps = n_frames / (time.perf_counter() - t0)
    launches = _build.LAUNCHES.get(KERNEL, 0)
    args, _, _ = kernel_inputs(bench, max_tiles_per_gauss=16)
    k = measure_kernel(args)
    emit("bench_render", frames=n_frames, fps=fps, n_gaussians=int(bench["means"].shape[0]),
         n_isects=meta["n_isects"], n_dropped=meta["n_dropped"], launches=launches,
         kernel_ms=k["ms"], device_graph_ms=k["device_graph_ms"], plain_ms=k["plain_ms"],
         bound_ms=k["bound_ms"],
         bound_by=k["bound_by"], pixel_entry_evaluations=k["evaluations"],
         entries=k["entries"], bytes=k["bytes"], fp32_ops=k["fp32_ops"],
         finite=bool(torch.isfinite(acc)))
    if not bool(torch.isfinite(acc)):
        raise RuntimeError("bench render: non-finite frame")
    if launches < n_frames:
        raise RuntimeError(f"bench render launched kernel 1 {launches} < {n_frames} times")
    return k, launches



# ---------------------------------------------------------------------------
# training: kernels 2 and 3, the bench-scale step, the Runner
# ---------------------------------------------------------------------------


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


GROUPS = {"means2d": slice(0, 2), "conics": slice(2, 5), "opacities": slice(5, 6),
          "colors": slice(6, None)}


def seg_groups(D):
    """Column groups of the segment sums with the AbsGS columns."""
    return dict(GROUPS, colors=slice(6, 6 + D), abs_means2d=slice(6 + D, None))


def train_parity(name, args, tile_capacity, seed):
    """Kernel 1 (training use), kernel 2 and kernel 3 against their plain
    versions on the same inputs; random cotangents. Fails above the
    tolerances, or if two segment-sum launches differ in any bit."""
    img, trans = rasterize_packed_train_fwd(*args, tile_capacity=tile_capacity)
    img_p, trans_p = rasterize_packed_train_fwd_plain(*args, tile_capacity=tile_capacity)
    fwd_err = max(float((img - img_p).abs().max()), float((trans - trans_p).abs().max()))
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    v_img = torch.randn(img.shape, generator=g, device=DEVICE)
    v_t = torch.randn(trans.shape, generator=g, device=DEVICE)
    rows = rasterize_packed_bwd(*args, img, trans, v_img, v_t, tile_capacity=tile_capacity)
    rows_p = rasterize_packed_bwd_plain(*args, img, trans, v_img, v_t,
                                        tile_capacity=tile_capacity)
    bwd_rel = {k: _rel(rows[:, c], rows_p[:, c]) for k, c in GROUPS.items()}
    bwd_abs = float((rows - rows_p).abs().max())
    offsets, ids = args[7], args[8]
    G = args[0].numel() // 2
    sids, perm = S.sort_ids(ids, offsets[-1])
    s1 = S.segment_rows_sum(rows, perm, sids, G, abs_cols=True)
    s2 = S.segment_rows_sum(rows, perm, sids, G, abs_cols=True)
    s0 = S.segment_rows_sum(rows, perm, sids, G)  # without the AbsGS columns
    sp = S.segment_rows_sum_plain(rows, perm, sids, G, abs_cols=True)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(s1, s2))
    seg_rel = {k: _rel(s1[:, c], sp[:, c]) for k, c in seg_groups(args[2].shape[-1]).items()}
    seg_rel["without_abs_columns"] = _rel(s0, sp[:, :rows.shape[1]])
    seg_abs = float((s1 - sp).abs().max())
    counts = torch.diff(offsets.long())
    emit("train_parity", case=name, tile_capacity=tile_capacity,
         n_isects=int(counts.sum()), tiles_cut=int(
             (counts > max_entries_per_tile(tile_capacity)).sum()),
         fwd_max_abs_err=fwd_err, bwd_max_rel_err=bwd_rel, bwd_max_abs_err=bwd_abs,
         bwd_rtol=BWD_RTOL, segsum_max_rel_err=seg_rel, segsum_max_abs_err=seg_abs,
         segsum_rtol=SEG_RTOL, segsum_bitwise_equal=bitwise,
         finite=bool(torch.isfinite(rows).all()))
    if not fwd_err <= TOL:
        raise RuntimeError(f"train_parity {name}: forward err {fwd_err} > {TOL}")
    if not bool(torch.isfinite(rows).all()) or not max(bwd_rel.values()) <= BWD_RTOL:
        raise RuntimeError(f"train_parity {name}: backward {bwd_rel} > {BWD_RTOL}")
    if not max(seg_rel.values()) <= SEG_RTOL or not bitwise:
        raise RuntimeError(f"train_parity {name}: segment sum {seg_rel}, bitwise {bitwise}")
    return dict(fwd=fwd_err, bwd=bwd_abs, seg=seg_abs,
                bwd_rel=max(bwd_rel.values()), seg_rel=max(seg_rel.values()),
                inputs=(args, img, trans, v_img, v_t, rows))


def phase_train_parity(bench, heavy, cap):
    """Kernels 2 and 3 at the training path's bench shapes (200k gaussians,
    K = 16, its stream capacity) and on a case whose tiles overflow
    tile_capacity = 128."""
    args, _, _ = kernel_inputs(bench, max_tiles_per_gauss=16, isect_capacity=cap)
    a = train_parity("a_bench", args, 1024, seed=1)
    args_h, _, _ = kernel_inputs(heavy, isect_exact=True)
    b = train_parity("b_heavy_overlap_truncated", args_h, 128, seed=2)
    errs = {k: max(a[k], b[k]) for k in ("fwd", "bwd", "seg", "bwd_rel", "seg_rel")}
    return errs, a["inputs"]


def measure_train_kernels(inputs, reps=20, tile_capacity=1024, phase="train_kernels"):
    """Times of kernels 1 (training call), 2 and 3 on a training stream (the
    bench shapes unless given others), with their plain versions', their
    bounds, and index_add_ as the segment sum's library yardstick."""
    args, img, trans, v_img, v_t, rows = inputs
    tc = tile_capacity
    D = args[2].shape[-1]
    offsets, ids = args[7], args[8]
    G = args[0].numel() // 2
    n_isects = int(offsets[-1])
    L = ids.shape[0]
    fwd = kernel_work(args, tc)

    fwd_ms = time_ms(lambda: rasterize_packed_train_fwd(*args, tile_capacity=tc), reps)
    fwd_graph_ms = graph_ms(lambda: rasterize_packed_train_fwd(*args, tile_capacity=tc), reps)
    fwd_plain = time_ms(lambda: rasterize_packed_train_fwd_plain(*args, tile_capacity=tc), 2)

    def bwd():
        rasterize_packed_bwd(*args, img, trans, v_img, v_t, tile_capacity=tc)

    bwd_ms, bwd_graph_ms = time_ms(bwd, reps), graph_ms(bwd, reps)
    bwd_plain = time_ms(lambda: rasterize_packed_bwd_plain(*args, img, trans, v_img, v_t,
                                                           tile_capacity=tc), 1)
    n_pix = img.numel() // D
    # each input read once: the rows the cut ranges name, ids, offsets and
    # per pixel the forward's colours and T with their cotangents; the
    # [L, 6 + D] rows written once
    bwd_bytes = (fwd["rows"] * (6 + D) * 4 + fwd["entries"] * 4 + offsets.numel() * 4
                 + n_pix * (2 * D + 2) * 4 + L * (6 + D) * 4)
    n_bwd_ops = bwd_ops(D, fwd["evaluations"])
    t_b, t_o = bwd_bytes / PEAK_BYTES * 1e3, n_bwd_ops / PEAK_FP32 * 1e3

    out = {
        KERNEL: dict(ms=fwd_ms, device_graph_ms=fwd_graph_ms, plain_ms=fwd_plain,
                     bound_ms=fwd["bound_ms"],
                     bound_by=fwd["bound_by"], library_ms=None,
                     evaluations=fwd["evaluations"], bytes=fwd["bytes"]),
        KERNEL_BWD: dict(ms=bwd_ms, device_graph_ms=bwd_graph_ms, plain_ms=bwd_plain,
                         bound_ms=max(t_b, t_o),
                         bound_by="bytes" if t_b >= t_o else "operations",
                         library_ms=None, evaluations=fwd["evaluations"],
                         bytes=bwd_bytes, fp32_ops=n_bwd_ops),
        S.KERNEL: measure_segment_sum(rows, ids, offsets, G, reps),
    }
    emit(phase, n_isects=n_isects, stream_slots=L, n_gaussians=G, D=D, tile_capacity=tc,
         **out)
    return out


def measure_segment_sum(rows, ids, offsets, G, reps=20):
    """Kernel 3 on a backward's per-slot rows [L, F] and their stream ids
    (the slots past offsets[-1] are padding), summed into G rows: its device
    time, its plain version's time, its bound, and index_add_ over the valid
    slots as its library yardstick. ``ms`` and ``library_ms`` are CUDA
    events around back-to-back calls, as every kernel is timed; a call from
    Python costs the host about as long as this kernel, so the same calls
    replayed from a CUDA graph (``graph_ms``) are given beside them as the
    device's own time."""
    n_isects = int(offsets[-1])
    F = rows.shape[1]
    sids, perm = S.sort_ids(ids, offsets[-1])
    valid_ids = ids[:n_isects].long()
    valid_rows = rows[:n_isects]

    def kernel():
        return S.segment_rows_sum(rows, perm, sids, G)

    def library():
        return torch.zeros((G, F), device=DEVICE).index_add_(0, valid_ids, valid_rows)

    seg_ms, lib_ms = time_ms(kernel, reps), time_ms(library, reps)
    seg_graph, lib_graph = graph_ms(kernel, reps), graph_ms(library, reps)
    seg_plain = time_ms(lambda: S.segment_rows_sum_plain(rows, perm, sids, G), 3)
    # sorted id and permutation (4 bytes each) with each row, read once;
    # the per-gaussian sums written once
    seg_bytes = n_isects * (F + 2) * 4 + G * F * 4
    seg_b, seg_o = seg_bytes / PEAK_BYTES * 1e3, n_isects * F / PEAK_FP32 * 1e3
    return dict(ms=seg_ms, plain_ms=seg_plain, bound_ms=max(seg_b, seg_o),
                bound_by="bytes" if seg_b >= seg_o else "operations",
                library_ms=lib_ms, device_graph_ms=seg_graph, library_graph_ms=lib_graph,
                entries=n_isects, rows_out=G, columns=F, bytes=seg_bytes)


def measure_adam(n=1_000_000, visible=1.0, reps=20, seed=0, sh_slices=True):
    """The Adam kernel (csrc/adam.cu) over the trainer's six 3DGS groups at
    SH degree 3 (59 floats a row) at ``n`` rows, a random share ``visible``
    of them unmasked, the SH gradients slices of one as the trainer's
    (``sh_slices``): its device time by CUDA events and by CUDA graph
    replay, the plain chain's time, and its bound by bytes (28 a visible
    float, 24 a masked one, a byte a row). Held against the plain chain:
    visible elements within ``ADAM_ULPS`` float32 ulps of its value, and of
    the parameter's step, masked rows bitwise the inputs."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    shapes = {"means": (3,), "scales": (3,), "quats": (4,), "opacities": (),
              "sh0": (1, 3), "shN": (15, 3)}

    def draw(shape, scale):
        return torch.randn((n,) + shape, generator=gen, device=DEVICE) * scale

    params = {k: draw(s, 1.0) for k, s in shapes.items()}
    grads = {k: draw(s, 1e-3) for k, s in shapes.items()}
    if sh_slices:
        sh = draw((16, 3), 1e-3)
        grads.update(sh0=sh[:, :1], shN=sh[:, 1:])
    mu = {k: draw(s, 1e-4) for k, s in shapes.items()}
    nu = {k: draw(s, 1e-4).square() for k, s in shapes.items()}
    vis = torch.rand(n, generator=gen, device=DEVICE) < visible
    lrs = {k: 1e-3 for k in shapes}
    args = (params, grads, mu, nu, lrs, 0.9, 0.999, 1e-15, vis)
    ulps, masked_bitwise = adam_errors(args, A.adam_update(*args), A.adam_update_plain(*args))
    if ulps > ADAM_ULPS or not masked_bitwise:
        raise RuntimeError(f"kernel_adam: {ulps:.2f} ulps from the plain chain (tolerance "
                           f"{ADAM_ULPS}), masked rows bitwise the inputs: {masked_bitwise}")
    _build.reset_launches()
    ms = time_ms(lambda: A.adam_update(*args), reps)
    launches = _build.LAUNCHES.get(A.KERNEL, 0)
    graph = graph_ms(lambda: A.adam_update(*args), reps)
    plain = time_ms(lambda: A.adam_update_plain(*args), reps)
    floats = sum(t.numel() for t in params.values())
    shown = float(vis.float().mean())
    n_bytes = floats * (24 + 4 * shown) + n
    bound = n_bytes / PEAK_BYTES * 1e3
    return dict(ms=ms, device_graph_ms=graph, plain_ms=plain, bound_ms=bound, bound_by="bytes",
                roofline=bound / ms, bytes=n_bytes, floats=floats, rows=n,
                visible_share=shown, sh_grad_slices=sh_slices,
                launches_per_call=launches / (reps + 1), max_ulps=ulps,
                masked_rows_bitwise=masked_bitwise)


def adam_errors(args, got, want):
    """→ (the kernel's largest distance from the plain chain over visible
    elements, in float32 ulps of the plain value plus, for a parameter, of
    its step; whether every masked row is bitwise its input)."""
    params, _, mu, nu, _, _, _, _, vis = args
    ulps, bitwise = 0.0, True
    for j, src in enumerate((params, mu, nu)):
        for k, s in src.items():
            out, ref = got[j][k], want[j][k]
            room = _spacing(ref[vis])
            if j == 0:
                room = room + _spacing(ref[vis] - s[vis])
            if room.numel():
                ulps = max(ulps, float(((out[vis] - ref[vis]).abs() / room).max()))
            bitwise = bitwise and torch.equal(out[~vis], s[~vis])
    return ulps, bitwise


def noise_state(n, seed=0):
    """``n`` rows for the MCMC noise, drawn as ``portbench/scenes/state.py``
    draws the trained state (anisotropic splats of the surfaces' spacing, 1%
    at 2.5x, 5% near-transparent, so that the gate opens), quaternions left
    unnormalized, and the standard normal noise; on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=DEVICE)

    log_s = float(np.log(0.012)) + 0.35 * randn(n, 3)
    log_s[:, 2] += float(np.log(0.3))
    log_s = log_s + (rand(n) < 0.01)[:, None] * float(np.log(2.5))
    op = torch.sigmoid(1.0 + 1.5 * randn(n))
    op = torch.where(rand(n) < 0.05, 0.001 + 0.003 * rand(n), op)
    params = {"means": 1.5 * randn(n, 3), "quats": randn(n, 4) * (0.5 + rand(n, 1)),
              "scales": log_s, "opacities": torch.logit(op)}
    return params, randn(n, 3)


def noise_float64(params, noise, scaler, active):
    """The means after the MCMC noise evaluated in float64 from the same
    float32 inputs."""
    from tdgs_torch.ops.transforms import quat_to_rotmat

    p = {k: v.double() for k, v in params.items()}
    q = p["quats"] / torch.clamp(torch.linalg.norm(p["quats"], dim=-1, keepdim=True),
                                 min=1e-12)
    M = quat_to_rotmat(q) * torch.exp(p["scales"])[:, None, :]
    gate = torch.sigmoid(100.0 * ((1.0 - torch.sigmoid(p["opacities"])) - 0.995))
    v = noise.double() * gate[:, None] * scaler
    step = torch.einsum("nij,nkj,nk->ni", M, M, v)
    step = torch.where(active[:, None], step, torch.zeros_like(step))
    return p["means"] + step


def mcmc_noise_errors(params, noise, scaler, active):
    """The kernel and the plain chain against float64 on these rows → (the
    kernel's worst error, the chain's, whether every kernel error is within
    twice the chain's worst plus an ulp of the means, whether the inactive
    rows and those with sigmoid(o) >= 0.5 are bitwise their inputs)."""
    got = N.inject_noise_to_position(params, noise, scaler, active)["means"]
    chain = N.inject_noise_to_position_plain(params, noise, scaler, active)["means"]
    exact = noise_float64(params, noise, scaler, active)
    err_k = (got.double() - exact).abs()
    err_c = float((chain.double() - exact).abs().max())
    within = bool((err_k <= 2 * err_c + _spacing(exact.float()).double()).all())
    kept = ~active | (torch.sigmoid(params["opacities"]) >= 0.5)
    bitwise = torch.equal(got[kept], params["means"][kept])
    return float(err_k.max()), err_c, within, bitwise


def measure_mcmc_noise(n=1_000_000, reps=20, seed=0, scaler=160.0):
    """The MCMC noise kernel (csrc/mcmc_noise.cu) at ``n`` rows drawn by
    ``noise_state``, every row active as at the benchmark's cap: its
    device time by CUDA events and by CUDA graph replay, the plain chain's
    time, and its bound by bytes (69 a row: means, quats, log-scales,
    logit, noise and the mask read, the means written). Held first against
    float64 (``mcmc_noise_errors``) with 95% of the rows active."""
    params, noise = noise_state(n, seed)
    some = torch.arange(n, device=DEVICE) < int(0.95 * n)
    err_k, err_c, within, bitwise = mcmc_noise_errors(params, noise, scaler, some)
    if not (within and bitwise):
        raise RuntimeError(f"kernel_mcmc_noise: worst error {err_k!r} against the chain's "
                           f"{err_c!r} (within 2x + 1 ulp: {within}), kept rows bitwise: "
                           f"{bitwise}")
    active = torch.ones(n, dtype=torch.bool, device=DEVICE)
    _build.reset_launches()
    ms = time_ms(lambda: N.inject_noise_to_position(params, noise, scaler, active), reps)
    launches = _build.LAUNCHES.get(N.KERNEL, 0)
    graph = graph_ms(lambda: N.inject_noise_to_position(params, noise, scaler, active), reps)
    plain = time_ms(lambda: N.inject_noise_to_position_plain(params, noise, scaler, active),
                    reps)
    n_bytes = 69 * n
    bound = n_bytes / PEAK_BYTES * 1e3
    return dict(ms=ms, device_graph_ms=graph, plain_ms=plain, bound_ms=bound,
                bound_by="bytes", roofline=bound / ms, bytes=n_bytes, rows=n,
                launches_per_call=launches / (reps + 1), max_abs_err=err_k,
                chain_max_abs_err=err_c, within_chain=within, kept_rows_bitwise=bitwise)


def _spacing(x):
    """The float32 ulp at each |x|."""
    return torch.nextafter(x.abs(), torch.full_like(x, float("inf"))) - x.abs()


def bench_capacity(bench):
    """The training path's stream capacity: this scene's intersections with
    25% headroom (the role of derive_isect_capacity in the JAX package's
    bench.py)."""
    _, _, meta = tdgs_torch.rasterization(
        bench["means"], bench["quats"], bench["scales"], bench["opacities"],
        bench["sh"], bench["viewmats"], bench["Ks"], WIDTH, HEIGHT, sh_degree=3,
        tile_capacity=1024, max_tiles_per_gauss=16, device=DEVICE)
    return int(meta["n_isects"] * 1.25)


def phase_render_train(bench, cap, n_steps=20, rasterizer="packed"):
    """The JAX package's bench.py 3DGS training step (bench.py:236-282) on
    the port: loss = img.mean() + alpha.mean() through rasterization(
    rasterizer="packed"), gradients w.r.t. means, quats, scales, opacities
    and SH, 20 steps at 1920x1080 with 200k gaussians. ``rasterizer=
    "pallas"``: the same step through the tile-dense path (kernels 9, 10
    and 3), phase ``render_train_pallas``."""
    name, kernels = (("render_train", KERNELS) if rasterizer == "packed"
                     else ("render_train_pallas", DENSE_KERNELS))
    names = ("means", "quats", "scales", "opacities", "sh")
    leaves = [bench[k].clone().requires_grad_(True) for k in names]
    box = {}

    def forward(i, cap):
        m, q, sc, op, sh = leaves
        img, alpha, meta = tdgs_torch.rasterization(
            m, q, sc, op * (1.0 + 1e-5 * i), sh, bench["viewmats"], bench["Ks"],
            WIDTH, HEIGHT, sh_degree=3, rasterizer=rasterizer, tile_capacity=1024,
            max_tiles_per_gauss=16, isect_capacity=cap, device=DEVICE)
        box["meta"] = meta
        return img.mean() + alpha.mean()

    def step(i, cap):
        loss = forward(i, cap)
        grads = torch.autograd.grad(loss, leaves)
        return loss, grads

    step(0, cap)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    ev = []
    t0 = time.perf_counter()
    for i in range(n_steps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        loss, grads = step(i, cap)
        e1.record()
        ev.append((e0, e1))
        finite &= torch.isfinite(loss) & torch.stack([torch.isfinite(g).all() for g in grads]).all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: _build.LAUNCHES.get(k, 0) for k in kernels}
    step_ms = [a.elapsed_time(b) for a, b in ev]

    # one step traced in its two halves
    holder = {}

    def fwd_only():
        holder["loss"] = forward(0, cap)

    def bwd_only():
        torch.autograd.grad(holder["loss"], leaves)

    fwd_trace = traced(fwd_only)
    bwd_trace = traced(bwd_only)
    emit(name, steps=n_steps, width=WIDTH, height=HEIGHT,
         n_gaussians=int(leaves[0].shape[0]), isect_capacity=cap,
         n_isects=box["meta"]["n_isects"], n_dropped=box["meta"]["n_dropped"],
         fps=n_steps / wall, wall_s=wall, step_ms_mean=float(np.mean(step_ms)),
         step_ms_p50=float(np.percentile(step_ms, 50)), launches=launches,
         all_finite=bool(finite), traced_forward=fwd_trace, traced_backward=bwd_trace)
    if not bool(finite):
        raise RuntimeError(f"{name}: non-finite loss or gradient")
    for k in kernels:
        if launches[k] < n_steps:
            raise RuntimeError(f"{name} launched {k} {launches[k]} < {n_steps} times")
    return launches


def phase_trainer(root, scene_s, model_type="3dgs", n_steps=100, rasterizer="packed"):
    """The port's Runner on make_rich_scene at the JAX package's defaults
    (40 images of 1236x822, 150k ground-truth gaussians, 40k SfM points,
    seed 11), written to ``root`` in ``scene_s`` seconds: packed rasterizer,
    SH 3, DefaultStrategy refining at steps 40 and 80, eval on the test
    views at the end through the forward-only kernel (1, 4 for 2DGS, 7
    for 3DGUT). ``model_type="2dgs"`` trains surfels with the
    normal-consistency and distortion losses live from steps 30 and 10;
    ``"3dgut"`` the mcmc preset with the UT projection and the eval3d
    rasterizer, MCMC refining at steps 40 and 80 up to 160k gaussians.
    ``rasterizer="pallas"`` trains 3DGS through the tile-dense path (kernels
    9, 10 and 3; phase ``trainer_pallas``), eval still through kernel 1."""
    strategy = DefaultStrategy(refine_start_iter=20, refine_every=40,
                               refine_stop_iter=1000, reset_every=10_000)
    if model_type == "2dgs":
        name, eval_kernel = "trainer_2dgs", R2.KERNEL_FWD
        kernels = (S.KERNEL, R2.KERNEL_TRAIN, R2.KERNEL_BWD)
        extra = dict(model_type="2dgs", normal_loss=True, dist_loss=True,
                     normal_start_iter=30, dist_start_iter=10)
    elif model_type == "3dgut":
        # the mcmc preset (examples/simple_trainer.py:81-86) with 3DGUT
        name, eval_kernel = "trainer_3dgut", E.KERNEL_FWD
        kernels = (E.KERNEL_TRAIN, E.KERNEL_BWD, S.KERNEL)
        strategy = MCMCStrategy(cap_max=160_000, refine_start_iter=20, refine_every=40,
                                refine_stop_iter=1000)
        extra = dict(with_ut=True, with_eval3d=True, init_opa=0.5, init_scale=0.1,
                     opacity_reg=0.01, scale_reg=0.01)
    elif rasterizer == "pallas":
        name, eval_kernel, kernels, extra = "trainer_pallas", KERNEL, DENSE_KERNELS, {}
    else:
        name, eval_kernel, kernels, extra = "trainer", KERNEL, KERNELS, {}
    cfg = Config(
        data_dir=root, result_dir=f"{root}/results_{name}", data_factor=1,
        max_steps=n_steps, eval_steps=[], save_steps=[], sh_degree=3,
        sh_degree_interval=20, rasterizer=rasterizer, tb_every=5, strategy=strategy,
        **extra,
    )
    runner = Runner(cfg, device=DEVICE)
    from tdgs_torch.models.gaussians import alive_mask

    alive0 = int(alive_mask(runner.splats).sum())
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = runner.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: _build.LAUNCHES.get(k, 0) for k in kernels + (A.KERNEL, N.KERNEL)}
    _build.reset_launches()
    stats = runner.eval(n_steps)
    eval_launches = _build.LAUNCHES.get(eval_kernel, 0)
    hist = out["history"]
    # one more step, split: the batch's decode on the host, then the
    # step itself traced (it changes the splats after the eval above)
    t1 = time.perf_counter()
    batch = runner._batch([0])
    data_ms = (time.perf_counter() - t1) * 1e3
    step_trace = traced(lambda: runner.train_step(batch, n_steps + 1, cfg.sh_degree))
    finite = all(bool(torch.isfinite(v).all()) for v in runner.splats.values())
    finite = finite and all(np.isfinite([h["loss"] for h in hist]))
    finite = finite and np.isfinite(stats["psnr"]) and np.isfinite(stats["ssim"])
    emit(name, steps=n_steps, scene_s=scene_s, train_images=len(runner.trainset),
         test_images=len(runner.valset), width=int(runner.parser.imsize_dict[1][0]),
         height=int(runner.parser.imsize_dict[1][1]), capacity=runner.capacity,
         alive_init=alive0, steps_per_s=n_steps / wall, wall_s=wall,
         loss_first=hist[0], loss_last=hist[-1], loss_history=hist,
         refines=runner.refines, launches=launches, eval_kernel=eval_kernel,
         eval_launches=eval_launches, eval_psnr=stats["psnr"], eval_ssim=stats["ssim"],
         eval_num_gs=stats["num_GS"], all_finite=bool(finite),
         data_ms_per_step=data_ms, traced_step=step_trace)
    refined = [r["step"] for r in runner.refines]
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise RuntimeError(f"{name}: loss did not drop {hist[0]} -> {hist[-1]}")
    if 40 not in refined or 80 not in refined:
        raise RuntimeError(f"{name}: strategy refined at {refined}, not 40 and 80")
    if not finite:
        raise RuntimeError(f"{name}: non-finite params, loss or eval")
    for k in kernels:
        if launches[k] < n_steps:
            raise RuntimeError(f"{name} launched {k} {launches[k]} < {n_steps} times")
    if launches[A.KERNEL] != n_steps:
        raise RuntimeError(f"{name} launched {A.KERNEL} {launches[A.KERNEL]} times in "
                           f"{n_steps} steps, not one a step")
    mcmc_steps = n_steps if isinstance(strategy, MCMCStrategy) else 0
    if launches[N.KERNEL] != mcmc_steps:
        raise RuntimeError(f"{name} launched {N.KERNEL} {launches[N.KERNEL]} times in "
                           f"{mcmc_steps} MCMC steps, not one a step")
    if eval_launches < len(runner.valset):
        raise RuntimeError(f"{name}: eval launched {eval_kernel} {eval_launches} times "
                           f"for {len(runner.valset)} views")
    return launches, eval_launches, n_steps / wall


# ---------------------------------------------------------------------------
# 2DGS: kernels 4, 5 and 6, the bench-scale render and training step, the
# Runner with model_type="2dgs"
# ---------------------------------------------------------------------------


def kernel_inputs_2dgs(sc, render_mode="RGB+ED", distloss=True, width=None, height=None,
                       **kw):
    """The 2DGS kernels' inputs for one frame, built by the port's own
    projection, SH and tiling (rasterization_2dgs's meta): ``geo``, the
    stream-order feature rows with the offsets, the image count, the
    channel count D (3 for "RGB", 4 with the depth channel that "RGB+ED"
    and distloss add) and the image's size, as kernels 5 and 6 take them;
    and ``k4``, the per-gaussian rows at the inference kernel's stride with
    the flatten ids and the rest of ``geo``, as kernel 4 takes them."""
    width = WIDTH if width is None else width
    height = HEIGHT if height is None else height
    out = tdgs_torch.rasterization_2dgs(
        sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["sh"],
        sc["viewmats"], sc["Ks"], width, height, sh_degree=3, render_mode=render_mode,
        distloss=distloss, device=DEVICE, **kw)
    meta = out[6]
    colors = _colors_per_camera(sc["sh"], 3, sc["means"], sc["viewmats"], meta["radii"])
    if distloss or render_mode == "RGB+ED":
        colors = torch.cat([colors, meta["depths"][..., None]], -1)
    D = colors.shape[-1]
    args = (meta["means2d"], meta["ray_transforms"], colors, meta["normals"],
            meta["opacities"])
    ids = meta["flatten_ids"]
    rows = R2.feature_rows(*args)[ids.long()].contiguous()
    rest = (meta["isect_offsets"], 1, D, width, height, meta["tile_size"])
    feats = R2.feature_rows(*args, width=R2.padded_width(D))
    return ((rows,) + rest, (feats, ids) + rest), meta


def kernel_work_2dgs(args, tile_capacity, evaluations, k4=None):
    """Bytes and operations of kernels 4, 5 and 6 on these inputs (kernel
    4's bytes from ``k4``, its inputs, where given), each input read once
    and each output written once, and their bounds."""
    rows, offsets, n_images, D, W, H, _ = args
    DA, F = D + 3, rows.shape[1]
    counts = torch.clamp(torch.diff(offsets.long()), 0, max_entries_per_tile(tile_capacity))
    entries = int(counts.sum())
    n_pix = n_images * W * H
    read = entries * F * 4 + offsets.numel() * 4  # the cut ranges' rows, offsets
    if k4 is not None:
        # through flatten_ids: the rows of the gaussians the cut ranges
        # name, their ids and the offsets
        _, named = named_rows(offsets, k4[1], tile_capacity)
        read_k4 = named * F * 4 + entries * 4 + offsets.numel() * 4
    else:
        read_k4 = read
    work = {
        R2.KERNEL_FWD: (read_k4 + n_pix * (DA + 1) * 4,
                        fwd_2dgs_ops(DA, False, evaluations)),
        R2.KERNEL_TRAIN: (read + n_pix * (DA + 3) * 4,
                          fwd_2dgs_ops(DA, True, evaluations)),
        # the forward's outputs (channels, T, distortion) and their
        # cotangents per pixel; one row per stream slot written
        R2.KERNEL_BWD: (read + n_pix * 2 * (DA + 2) * 4 + rows.shape[0] * F * 4,
                        bwd_2dgs_ops(DA, evaluations)),
    }
    out = {}
    for name, (n_bytes, n_ops) in work.items():
        t_b, t_o = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32 * 1e3
        out[name] = dict(bytes=n_bytes, fp32_ops=n_ops, evaluations=evaluations,
                         entries=entries, bound_ms=max(t_b, t_o),
                         bound_by="bytes" if t_b >= t_o else "operations")
    return out


def _abs_err(a, b):
    return float((a - b).abs().max())


def inference_errors(k4, tile_capacity, plain, backgrounds=None):
    """Kernel 4 on ``k4`` against its plain version: ``plain`` is
    rasterize_2dgs_fwd_plain's output on the same frame's stream-order
    rows, with the background blended as the wrapper's CPU path blends it.
    max|Δ| of colours, alpha and normals, and whether the kernel's outputs
    are finite."""
    I, D = k4[3], k4[4]
    img, alp, nrm = R2.rasterize_2dgs_inference(*k4, backgrounds, tile_capacity)
    p_img, p_nrm, p_T = plain[:3]
    p_alp = 1.0 - p_T
    if backgrounds is not None:
        p_img = p_img + (1.0 - p_alp)[..., None] * backgrounds.reshape(I, 1, 1, D)
    finite = all(bool(torch.isfinite(x).all()) for x in (img, alp, nrm))
    return dict(colors=_abs_err(img, p_img), alpha=_abs_err(alp[..., 0], p_alp),
                normals=_abs_err(nrm, p_nrm)), finite


def stream_stats(offsets, tile_capacity):
    counts = torch.diff(offsets.long())
    return dict(n_isects=int(counts.sum()),
                tiles_cut=int((counts > max_entries_per_tile(tile_capacity)).sum()))


def parity_2dgs_inference(name, inputs, backgrounds, tile_capacity=1024):
    """Kernel 4 as its main paths call it, "RGB" (D = 3), through
    flatten_ids: without a background (the bench render) and with one
    blended in the kernel (the Runner's eval). Fails above TOL, or if a
    second launch differs from the first in a bit."""
    geo, k4 = inputs
    plain = R2.rasterize_2dgs_fwd_plain(*geo, tile_capacity)
    errs, finite = {}, True
    for case, bg in (("no_background", None), ("background", backgrounds)):
        errs[case], ok = inference_errors(k4, tile_capacity, plain, bg)
        finite = finite and ok
    first, again = (R2.rasterize_2dgs_inference(*k4, backgrounds, tile_capacity)
                    for _ in range(2))
    repeat_bitwise = all(torch.equal(a, b) for a, b in zip(first, again))
    worst = max(max(e.values()) for e in errs.values())
    emit("parity_2dgs", case=name, tile_capacity=tile_capacity, D=geo[3],
         **stream_stats(geo[1], tile_capacity), pixel_entry_evaluations=plain[5].tolist(),
         alpha_mean=float((1.0 - plain[2]).mean()), inference_max_abs_err=errs, tol=TOL,
         repeat_bitwise=repeat_bitwise, blocks_a_tile=R2.BLOCKS_A_TILE.get(R2.KERNEL_FWD),
         finite=finite)
    if not finite:
        raise RuntimeError(f"parity_2dgs {name}: non-finite kernel output")
    if not repeat_bitwise:
        raise RuntimeError(f"parity_2dgs {name}: two launches of kernel 4 differ")
    if not worst <= TOL:
        raise RuntimeError(f"parity_2dgs {name}: kernel 4 {errs} > {TOL}")
    return dict(fwd=worst, evaluations=plain[5].tolist(), inputs=inputs)


def parity_2dgs(name, inputs, tile_capacity, seed):
    """Kernels 4, 5 and 6 against their plain versions on "RGB+ED" inputs
    with the distortion (the training path's), random cotangents; fails
    above the tolerances, or if two launches of kernel 5 differ in a bit."""
    geo, k4 = inputs
    D = geo[3]
    plain = R2.rasterize_2dgs_fwd_plain(*geo, tile_capacity, depth_row=D - 1,
                                        compute_distort=True)
    p_img, p_nrm, p_T, p_dist, p_med, evals = plain
    fwd_err, fwd_finite = inference_errors(k4, tile_capacity, plain)
    train = R2.rasterize_2dgs_train_fwd(*geo, tile_capacity, D - 1, True)
    again = R2.rasterize_2dgs_train_fwd(*geo, tile_capacity, D - 1, True)
    repeat_bitwise = all(torch.equal(a, b) for a, b in zip(train, again))
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    cot = [torch.randn(x.shape, generator=g, device=DEVICE) for x in train[:4]]
    v_rows = R2.rasterize_2dgs_bwd(*geo, *train[:4], *cot, tile_capacity, D - 1, True)
    want_rows = R2.rasterize_2dgs_bwd_plain(*geo, *train[:4], *cot, tile_capacity, D - 1, True)
    torch.cuda.synchronize()

    # colours, transmittance and normals are held to TOL, the distortion
    # to DIST_RTOL, the median to MEDIAN_SHARE
    train_err = dict(colors=_abs_err(train[0], p_img), transmittance=_abs_err(train[2], p_T),
                     normals=_abs_err(train[1], p_nrm))
    dist_rel = _rel(train[3], p_dist)
    median_share = float(((train[4] - p_med).abs() > 1e-5).float().mean())
    groups = {"means2d": slice(0, 2), "t0_tpx_tpy": slice(2, 11), "opacity": slice(11, 12),
              "channels": slice(12, None)}
    bwd_rel = {k: _rel(v_rows[:, c], want_rows[:, c]) for k, c in groups.items()}
    finite = fwd_finite and all(bool(torch.isfinite(x).all()) for x in (*train, v_rows))
    emit("parity_2dgs", case=name, tile_capacity=tile_capacity, D=D,
         **stream_stats(geo[1], tile_capacity), pixel_entry_evaluations=evals.tolist(),
         alpha_mean=float((1.0 - p_T).mean()), inference_max_abs_err=fwd_err,
         train_max_abs_err=train_err, tol=TOL, distortion_max_abs_err=_abs_err(train[3], p_dist),
         distortion_max_rel_err=dist_rel, dist_rtol=DIST_RTOL,
         distortion_max=float(p_dist.abs().max()), median_differs_share=median_share,
         median_share_tol=MEDIAN_SHARE, bwd_max_rel_err=bwd_rel, bwd_rtol=BWD_RTOL,
         bwd_max_abs_err=_abs_err(v_rows, want_rows), repeat_bitwise=repeat_bitwise,
         blocks_a_tile=R2.BLOCKS_A_TILE.get(R2.KERNEL_TRAIN), finite=finite)
    worst = max(max(fwd_err.values()), max(train_err.values()))
    if not finite:
        raise RuntimeError(f"parity_2dgs {name}: non-finite kernel output")
    if not repeat_bitwise:
        raise RuntimeError(f"parity_2dgs {name}: two launches of kernel 5 differ")
    if not worst <= TOL or not dist_rel <= DIST_RTOL or not median_share <= MEDIAN_SHARE:
        raise RuntimeError(f"parity_2dgs {name}: forward {fwd_err} {train_err}, "
                           f"distortion {dist_rel}, median {median_share}")
    if not max(bwd_rel.values()) <= BWD_RTOL:
        raise RuntimeError(f"parity_2dgs {name}: backward {bwd_rel} > {BWD_RTOL}")
    return dict(fwd=max(fwd_err.values()), train=max(train_err.values()), dist_rel=dist_rel,
                median_share=median_share, bwd=_abs_err(v_rows, want_rows),
                bwd_rel=max(bwd_rel.values()), evaluations=evals.tolist(),
                inputs=(geo, train, cot))


def phase_parity_2dgs(bench, heavy, cap):
    """Kernel 4 at the bench render's shapes (the bench scene at 1080p, SH
    3, "RGB", K = 16, stream capacity ``cap``), with and without a
    background; kernels 4, 5 and 6 at the training step's (the same with
    "RGB+ED" and the distortion) and on a truncating case (60k large
    surfels, tile_capacity = 128)."""
    kw = dict(tile_capacity=1024, max_tiles_per_gauss=16, isect_capacity=cap)
    inputs_rgb, _ = kernel_inputs_2dgs(bench, render_mode="RGB", distloss=False, **kw)
    bg = torch.tensor([[0.3, 0.5, 0.7]], device=DEVICE)
    rgb = parity_2dgs_inference("a_bench_rgb", inputs_rgb, bg)
    inputs, _ = kernel_inputs_2dgs(bench, **kw)
    a = parity_2dgs("b_bench_rgb_ed_dist", inputs, 1024, seed=3)
    inputs_h, _ = kernel_inputs_2dgs(heavy, tile_capacity=128, isect_exact=True)
    b = parity_2dgs("c_heavy_overlap_truncated", inputs_h, 128, seed=4)
    errs = {k: max(a[k], b[k]) for k in ("train", "dist_rel", "median_share", "bwd", "bwd_rel")}
    errs["fwd"] = max(rgb["fwd"], a["fwd"], b["fwd"])
    return errs, rgb, a


def measure_kernels_2dgs(rgb, ed, reps=20):
    """Times of kernel 4 at the bench render's shapes ("RGB", no
    background, through flatten_ids) and of kernels 5 and 6 at the training
    step's ("RGB+ED", distortion), by CUDA events and by graph replay, with
    their plain versions' and their bounds; beside kernel 4, the earlier
    inference path's gather of the feature rows into stream order, which
    it no longer makes. No PyTorch call composites a sorted tile stream, so
    there is no library yardstick."""
    tc = 1024
    geo_rgb, k4 = rgb["inputs"]
    geo, train, cot = ed["inputs"]
    D = geo[3]
    work = kernel_work_2dgs(geo, tc, ed["evaluations"])
    work[R2.KERNEL_FWD] = kernel_work_2dgs(geo_rgb, tc, rgb["evaluations"], k4)[R2.KERNEL_FWD]
    F = R2.GEOM_COLS + geo_rgb[3] + 3
    feats = k4[0][:, :F].contiguous()

    def gather():
        return feats[k4[1].long()]

    calls = {
        R2.KERNEL_FWD: (lambda: R2.rasterize_2dgs_inference(*k4, None, tc),
                        lambda: R2.rasterize_2dgs_fwd_plain(*geo_rgb, tc)),
        R2.KERNEL_TRAIN: (lambda: R2.rasterize_2dgs_train_fwd(*geo, tc, D - 1, True),
                          lambda: R2.rasterize_2dgs_fwd_plain(*geo, tc, D - 1, True)),
        R2.KERNEL_BWD: (lambda: R2.rasterize_2dgs_bwd(*geo, *train[:4], *cot, tc, D - 1, True),
                        lambda: R2.rasterize_2dgs_bwd_plain(*geo, *train[:4], *cot, tc,
                                                            D - 1, True)),
    }
    out = {}
    for name, (kernel, plain) in calls.items():
        out[name] = dict(ms=time_ms(kernel, reps), device_graph_ms=graph_ms(kernel, reps),
                         plain_ms=time_ms(plain, 2), library_ms=None,
                         blocks_a_tile=R2.BLOCKS_A_TILE.get(name), **work[name])
    out[R2.KERNEL_FWD].update(earlier_gather_ms=time_ms(gather, reps),
                              earlier_gather_device_graph_ms=graph_ms(gather, reps),
                              earlier_gather_bytes=k4[1].numel() * F * 4)
    emit("kernels_2dgs", **out)
    return out


def bench_capacity_2dgs(bench):
    """The 2DGS training path's stream capacity: this scene's surfel
    intersections with 25% headroom."""
    out = tdgs_torch.rasterization_2dgs(
        bench["means"], bench["quats"], bench["scales"], bench["opacities"], bench["sh"],
        bench["viewmats"], bench["Ks"], WIDTH, HEIGHT, sh_degree=3, tile_capacity=1024,
        max_tiles_per_gauss=16, device=DEVICE)
    return int(out[6]["n_isects"] * 1.25)


def phase_bench_render_2dgs(bench, cap, n_frames=20):
    """20 frames of the 200k scene as surfels through the forward-only
    rasterizer (kernel 4), each re-projected and re-sorted, as the JAX
    package's bench.py:187-208 times them."""

    def frame(i):
        out = tdgs_torch.rasterization_2dgs(
            bench["means"], bench["quats"], bench["scales"],
            bench["opacities"] * (1.0 + 1e-5 * i), bench["sh"], bench["viewmats"],
            bench["Ks"], WIDTH, HEIGHT, sh_degree=3, tile_capacity=1024,
            max_tiles_per_gauss=16, isect_capacity=cap, rasterizer="packed_inference",
            device=DEVICE)
        return out[0], out[6]

    frame(0)
    torch.cuda.synchronize()
    _build.reset_launches()
    acc = torch.zeros((), device=DEVICE)
    t0 = time.perf_counter()
    for i in range(n_frames):
        img, meta = frame(i)
        acc += img.mean()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.LAUNCHES.get(R2.KERNEL_FWD, 0)
    emit("bench_render_2dgs", frames=n_frames, fps=n_frames / wall, wall_s=wall,
         n_gaussians=int(bench["means"].shape[0]), isect_capacity=cap,
         n_isects=meta["n_isects"], n_dropped=meta["n_dropped"], launches=launches,
         finite=bool(torch.isfinite(acc)), traced_frame=traced(lambda: frame(0)))
    if launches < n_frames:
        raise RuntimeError(f"bench_render_2dgs launched kernel 4 {launches} < {n_frames} times")
    if not bool(torch.isfinite(acc)):
        raise RuntimeError("bench_render_2dgs: non-finite frame")
    return launches


def phase_render_train_2dgs(bench, cap, n_steps=20):
    """The JAX package's bench.py 2DGS training step (bench.py:251-258) on
    the port: rasterization_2dgs(render_mode="RGB+ED", distloss=True,
    rasterizer="packed"), loss = img.mean() + distort.mean(), gradients
    w.r.t. means, quats, scales, opacities and SH, 20 steps at 1920x1080
    with 200k surfels."""
    names = ("means", "quats", "scales", "opacities", "sh")
    leaves = [bench[k].clone().requires_grad_(True) for k in names]
    box = {}

    def forward(i):
        m, q, sc, op, sh = leaves
        out = tdgs_torch.rasterization_2dgs(
            m, q, sc, op * (1.0 + 1e-5 * i), sh, bench["viewmats"], bench["Ks"],
            WIDTH, HEIGHT, sh_degree=3, render_mode="RGB+ED", distloss=True,
            rasterizer="packed", tile_capacity=1024, max_tiles_per_gauss=16,
            isect_capacity=cap, device=DEVICE)
        box["meta"] = out[6]
        return out[0].mean() + out[4].mean()

    def step(i):
        loss = forward(i)
        return loss, torch.autograd.grad(loss, leaves)

    step(0)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    ev = []
    t0 = time.perf_counter()
    for i in range(n_steps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        loss, grads = step(i)
        e1.record()
        ev.append((e0, e1))
        finite &= torch.isfinite(loss) & torch.stack([torch.isfinite(g).all() for g in grads]).all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = (R2.KERNEL_TRAIN, R2.KERNEL_BWD, S.KERNEL)
    launches = {k: _build.LAUNCHES.get(k, 0) for k in kernels}
    step_ms = [a.elapsed_time(b) for a, b in ev]
    holder = {}

    def fwd_only():
        holder["loss"] = forward(0)

    def bwd_only():
        torch.autograd.grad(holder["loss"], leaves)

    fwd_trace = traced(fwd_only)
    bwd_trace = traced(bwd_only)
    emit("render_train_2dgs", steps=n_steps, width=WIDTH, height=HEIGHT,
         n_gaussians=int(leaves[0].shape[0]), isect_capacity=cap,
         n_isects=box["meta"]["n_isects"], n_dropped=box["meta"]["n_dropped"],
         fps=n_steps / wall, wall_s=wall, step_ms_mean=float(np.mean(step_ms)),
         step_ms_p50=float(np.percentile(step_ms, 50)), launches=launches,
         all_finite=bool(finite), traced_forward=fwd_trace, traced_backward=bwd_trace)
    if not bool(finite):
        raise RuntimeError("render_train_2dgs: non-finite loss or gradient")
    for k in kernels:
        if launches[k] < n_steps:
            raise RuntimeError(f"render_train_2dgs launched {k} {launches[k]} < {n_steps} times")
    return launches


# ---------------------------------------------------------------------------
# eval3d / 3DGUT: kernels 7 and 8, the bench-scale render and training step,
# the Runner with the MCMC preset, the command line
# ---------------------------------------------------------------------------


def rolling_shutter_kw(sc):
    """A TOP_TO_BOTTOM rolling shutter whose end pose has moved 2 cm along x
    and turned 0.5° about y, with the UT projection tiling it."""
    end = sc["viewmats"].clone()
    a = np.deg2rad(0.5)
    rot = torch.tensor([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                       dtype=torch.float32, device=end.device)
    end[:, :3, :3] = rot @ end[:, :3, :3]
    end[:, 0, 3] += 0.02
    return dict(with_ut=True, rolling_shutter=RollingShutterType.TOP_TO_BOTTOM,
                viewmats_rs=end)


def kernel_inputs_eval3d(sc, **kw):
    """Kernels 7 and 8's inputs for one frame, built by the port's own
    projection, SH, tiling, rays and rows (rasterization's meta): (rows,
    d, o', offsets, I, D, W, H, tile size), with the scene's feature rows
    and rays for the float64 check."""
    _, _, meta = tdgs_torch.rasterization(
        sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["sh"],
        sc["viewmats"], sc["Ks"], WIDTH, HEIGHT, sh_degree=3, with_eval3d=True,
        device=DEVICE, **kw)
    colors = _colors_per_camera(sc["sh"], 3, sc["means"], sc["viewmats"], meta["radii"])
    rs = dict(rolling_shutter=kw.get("rolling_shutter", RollingShutterType.GLOBAL),
              viewmats_rs=kw.get("viewmats_rs"))
    ts = meta["tile_size"]
    d, o, o_ref = E.tile_rays_world(1, meta["tile_width"], meta["tile_height"], ts,
                                    WIDTH, HEIGHT, sc["viewmats"], sc["Ks"], **rs)
    N = sc["means"].shape[0]
    feats = E.feature_rows(sc["means"], sc["quats"], sc["scales"],
                           meta["opacities"].reshape(1, N), colors.reshape(1, N, -1), o_ref)
    rows = feats[meta["flatten_ids"].long()].contiguous()
    geo = (rows, d.contiguous(), None if o is None else o.contiguous(),
           meta["isect_offsets"], 1, colors.shape[-1], WIDTH, HEIGHT, ts)
    return geo, dict(meta=meta, rs=rs)


def _quadratic_form_rows(sc, o_ref, ids):
    """The JAX package's eval3d rows in float32 (rasterize_eval3d_pallas.py
    :386-398): w = Σ⁻¹μ′, mAm = μ′ᵀΣ⁻¹μ′, prec6, gathered in stream order."""
    from tdgs_torch.ops.transforms import quat_scale_to_covar_sym6

    p00, p01, p02, p11, p12, p22 = quat_scale_to_covar_sym6(
        sc["quats"], 1.0 / torch.clamp(sc["scales"], min=1e-8))
    m = sc["means"] - o_ref[0]
    w = torch.stack([p00 * m[:, 0] + p01 * m[:, 1] + p02 * m[:, 2],
                     p01 * m[:, 0] + p11 * m[:, 1] + p12 * m[:, 2],
                     p02 * m[:, 0] + p12 * m[:, 1] + p22 * m[:, 2]], -1)
    mAm = (w * m).sum(-1, keepdim=True)
    prec6 = torch.stack([p00, p11, p22, 2.0 * p01, 2.0 * p02, 2.0 * p12], -1)
    return torch.cat([w, mAm, prec6], -1)[ids]


def _quadratic_form_sigma(q, d):
    """σ* = ½(mAm − (g·r)²/rr) of a central camera, as the JAX kernels take
    it (:210-216), in float32. q: [n, L, 10] rows, d: [n, P, 3] rays."""
    dd6 = torch.stack([d[..., 0] * d[..., 0], d[..., 1] * d[..., 1], d[..., 2] * d[..., 2],
                       d[..., 0] * d[..., 1], d[..., 0] * d[..., 2], d[..., 1] * d[..., 2]], -1)
    gr = -torch.bmm(d, q[..., 0:3].transpose(1, 2))
    rr = torch.clamp(torch.bmm(dd6, q[..., 4:10].transpose(1, 2)), min=1e-12)
    return 0.5 * (q[..., 3][:, None, :] - gr * gr / rr)


def _quantiles(errs):
    e = torch.sort(torch.cat(errs))[0]
    n = e.numel()
    return {k: float(e[min(int(f * n), n - 1)]) for k, f in
            (("median", 0.5), ("p99", 0.99), ("max", 1.0))} if n else {}


def sigma_f64_error(sc, geo, extra, tile_capacity, limit=4.0, budget=1 << 22):
    """|σ*(float32) − σ*(float64)| over the (pixel, entry) pairs of the cut
    ranges, inside the image, in front of the camera, with float64 σ*
    below ``limit``: the port's (the plain version's arithmetic, which is
    the kernels' operation for operation) and, for a central camera, the
    JAX package's quadratic form in float32. The float64 σ* takes the rows
    and the rays again in float64 from the same float32 scene. Returns
    (quantiles of the port's error, of the quadratic form's, of mAm, pairs)."""
    rows, d, o, offsets, I, D, W, H, ts = geo
    meta = extra["meta"]
    f64 = {k: sc[k].double() for k in ("means", "quats", "scales", "viewmats", "Ks")}
    rs = dict(extra["rs"])
    if rs["viewmats_rs"] is not None:
        rs["viewmats_rs"] = rs["viewmats_rs"].double()
    d64, o64, o_ref64 = E.tile_rays_world(1, meta["tile_width"], meta["tile_height"], ts,
                                          W, H, f64["viewmats"], f64["Ks"], **rs)
    N = sc["means"].shape[0]
    ids = meta["flatten_ids"].long()
    feats64 = E.feature_rows(f64["means"], f64["quats"], f64["scales"],
                             meta["opacities"].reshape(1, N).double(),
                             torch.zeros((1, N, D), dtype=torch.float64, device=DEVICE),
                             o_ref64)
    rows64 = feats64[ids]
    qrows = None
    if o is None:
        o_ref = -(sc["viewmats"][:, :3, :3].transpose(1, 2) @ sc["viewmats"][:, :3, 3:])[..., 0]
        qrows = _quadratic_form_rows(sc, o_ref, ids)
    r32, r64 = E._response_eval3d(rows, d, o), E._response_eval3d(rows64, d64, o64)
    counts = torch.clamp(torch.diff(offsets.long()), 0, max_entries_per_tile(tile_capacity))
    starts = offsets[:-1].long()
    tw = meta["tile_width"]
    P = ts * ts
    p = torch.arange(P, device=DEVICE)
    T = counts.shape[0]
    chunk = max(1, budget // (P * max(int(counts.max()), 1)))
    errs, qerrs, mams = [], [], []
    for t0 in range(0, T, chunk):
        tt = torch.arange(t0, min(t0 + chunk, T), device=DEVICE)
        L = int(counts[tt].max())
        if L == 0:
            continue
        lane = torch.arange(L, device=DEVICE)
        valid = lane[None, :] < counts[tt, None]
        idx = torch.where(valid, starts[tt, None] + lane[None, :], 0)
        s32 = r32(tt, idx, None, None, None)[0]
        s64 = r64(tt, idx, None, None, None)[0]
        px = (tt % tw * ts)[:, None] + p % ts
        py = (tt // tw * ts)[:, None] + p // ts
        inside = ((px < W) & (py < H))[:, :, None]
        sel = valid[:, None, :] & inside & (s64 >= 0) & (s64 < limit) & (s32 >= 0)
        errs.append((s32.double() - s64)[sel].abs().float())
        if qrows is not None:
            q = qrows[idx]
            qerrs.append((_quadratic_form_sigma(q, d[tt]).double() - s64)[sel].abs().float())
            mams.append(q[..., 3][:, None, :].expand_as(s64)[sel])
    pairs = sum(int(e.numel()) for e in errs)
    return _quantiles(errs), _quantiles(qerrs), _quantiles(mams), pairs


EVAL3D_GROUPS = {"M": slice(0, 9), "g0": slice(9, 12), "opacity": slice(12, 13),
                 "colors": slice(13, None)}


def parity_eval3d(name, geo, tile_capacity, seed, backgrounds):
    """Kernels 7 (both calls) and 8 against their plain versions on the
    same inputs, random cotangents; fails above the tolerances, or if a
    second launch of kernel 7 differs from the first in a bit."""
    rows, d, o, offsets, I, D = geo[:6]
    stream = geo[:9]
    p_img, p_T, evals = E.rasterize_eval3d_fwd_plain(*stream, tile_capacity)
    fwd_err, finite = {}, True
    for case, bg in (("no_background", None), ("background", backgrounds)):
        img, alp = E.rasterize_eval3d_inference(*stream, bg, tile_capacity)
        want = p_img if bg is None else p_img + p_T[..., None] * bg.reshape(I, 1, 1, D)
        fwd_err[case] = dict(colors=_abs_err(img, want), alpha=_abs_err(alp[..., 0], 1.0 - p_T))
        finite = finite and bool(torch.isfinite(img).all()) and bool(torch.isfinite(alp).all())
    img, T = E.rasterize_eval3d_train_fwd(*stream, tile_capacity)
    fwd_err["train"] = dict(colors=_abs_err(img, p_img), transmittance=_abs_err(T, p_T))
    img2, T2 = E.rasterize_eval3d_train_fwd(*stream, tile_capacity)
    inf1 = E.rasterize_eval3d_inference(*stream, backgrounds, tile_capacity)
    inf2 = E.rasterize_eval3d_inference(*stream, backgrounds, tile_capacity)
    repeat_bitwise = (torch.equal(img, img2) and torch.equal(T, T2)
                      and all(torch.equal(a, b) for a, b in zip(inf1, inf2)))
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    v_img = torch.randn(img.shape, generator=g, device=DEVICE)
    v_T = torch.randn(T.shape, generator=g, device=DEVICE)
    got = E.rasterize_eval3d_bwd(*stream, img, T, v_img, v_T, tile_capacity)
    want = E.rasterize_eval3d_bwd_plain(*stream, img, T, v_img, v_T, tile_capacity)
    torch.cuda.synchronize()
    bwd_rel = {k: _rel(got[0][:, c], want[0][:, c]) for k, c in EVAL3D_GROUPS.items()}
    bwd_rel["v_d"] = _rel(got[1], want[1])
    if o is not None:
        bwd_rel["v_o"] = _rel(got[2], want[2])
    finite = finite and all(bool(torch.isfinite(x).all()) for x in got if x is not None)
    worst = max(max(e.values()) for e in fwd_err.values())
    emit("parity_eval3d", case=name, tile_capacity=tile_capacity, D=D, central=o is None,
         **stream_stats(offsets, tile_capacity), pixel_entry_evaluations=evals.tolist(),
         alpha_mean=float((1.0 - p_T).mean()), fwd_max_abs_err=fwd_err, tol=TOL,
         bwd_max_rel_err=bwd_rel, bwd_rtol=BWD_RTOL,
         bwd_max_abs_err=_abs_err(got[0], want[0]), finite=finite,
         fwd_repeat_bitwise=repeat_bitwise)
    if not finite:
        raise RuntimeError(f"parity_eval3d {name}: non-finite kernel output")
    if not repeat_bitwise:
        raise RuntimeError(f"parity_eval3d {name}: two launches of kernel 7 differ")
    if not worst <= TOL:
        raise RuntimeError(f"parity_eval3d {name}: forward {fwd_err} > {TOL}")
    if not max(bwd_rel.values()) <= BWD_RTOL:
        raise RuntimeError(f"parity_eval3d {name}: backward {bwd_rel} > {BWD_RTOL}")
    return dict(fwd=worst, bwd=_abs_err(got[0], want[0]), bwd_rel=max(bwd_rel.values()),
                evaluations=evals.tolist(), inputs=(stream, img, T, v_img, v_T))


def phase_parity_eval3d(bench, heavy, cap):
    """Kernels 7 and 8 at the bench shapes (the bench scene at 1080p, SH 3,
    "RGB", central, K = 16, stream capacity ``cap``), with and without a
    background, σ* there against float64; a rolling-shutter case (UT
    tiling, a moved end pose); a truncating case (60k large gaussians,
    tile_capacity = 128)."""
    bg = torch.tensor([[0.3, 0.5, 0.7]], device=DEVICE)
    kw = dict(tile_capacity=1024, max_tiles_per_gauss=16, isect_capacity=cap)
    geo, extra = kernel_inputs_eval3d(bench, **kw)
    a = parity_eval3d("a_bench_rgb_central", geo, 1024, 5, bg)
    a.update(flatten_ids=extra["meta"]["flatten_ids"], n_gaussians=bench["means"].shape[0])
    port, quadratic, mAm, pairs = sigma_f64_error(bench, geo, extra, 1024)
    sigma_err = port["max"]
    emit("parity_eval3d_sigma", case="a_bench_rgb_central", sigma_limit=4.0,
         pairs=pairs, sigma_max_abs_err_vs_f64=sigma_err, tol=SIGMA_TOL,
         port_abs_err_vs_f64=port, reference_quadratic_form_abs_err_vs_f64=quadratic,
         mAm=mAm)
    if not sigma_err <= SIGMA_TOL:
        raise RuntimeError(f"parity_eval3d: σ* vs float64 {sigma_err} > {SIGMA_TOL}")
    geo_rs, extra_rs = kernel_inputs_eval3d(bench, **kw, **rolling_shutter_kw(bench))
    b = parity_eval3d("b_bench_rgb_rolling_shutter", geo_rs, 1024, 6, bg)
    geo_h, _ = kernel_inputs_eval3d(heavy, tile_capacity=128, isect_exact=True)
    c = parity_eval3d("c_heavy_overlap_truncated", geo_h, 128, 7, bg)
    errs = {k: max(a[k], b[k], c[k]) for k in ("fwd", "bwd", "bwd_rel")}
    errs["sigma"] = sigma_err
    return errs, a


def kernel_work_eval3d(geo, tile_capacity, evaluations):
    """Bytes and operations of kernels 7 and 8 on these inputs, each input
    read once and each output written once, and their bounds."""
    rows, d, o, offsets, I, D, W, H, _ = geo
    F = rows.shape[1]
    central = o is None
    counts = torch.clamp(torch.diff(offsets.long()), 0, max_entries_per_tile(tile_capacity))
    entries = int(counts.sum())
    n_pix = I * W * H
    n_rays = d.numel() // 3
    ray_bytes = n_rays * (3 if central else 6) * 4
    read = entries * F * 4 + offsets.numel() * 4 + ray_bytes
    work = {
        E.KERNEL_FWD: (read + n_pix * (D + 1) * 4,
                       fwd_eval3d_ops(D, central, evaluations)),
        # the forward's colours and T with their cotangents per pixel; one
        # row per stream slot and the ray gradients written
        E.KERNEL_BWD: (read + n_pix * 2 * (D + 1) * 4 + rows.shape[0] * F * 4 + ray_bytes,
                       bwd_eval3d_ops(D, central, evaluations)),
    }
    out = {}
    for name, (n_bytes, n_ops) in work.items():
        t_b, t_o = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32 * 1e3
        out[name] = dict(bytes=n_bytes, fp32_ops=n_ops, evaluations=evaluations,
                         entries=entries, bound_ms=max(t_b, t_o),
                         bound_by="bytes" if t_b >= t_o else "operations")
    return out


def measure_kernels_eval3d(a, reps=20):
    """Times of kernel 7 (the forward-only call, no background: the bench
    render; and the training call) and kernel 8 at the bench shapes, with
    their plain versions' and their bounds (no PyTorch call composites a
    sorted tile stream, so there is no library yardstick); and kernel 3 on
    kernel 8's rows. Returns ({kernel: times}, kernel 3's times)."""
    tc = 1024
    stream, img, T, v_img, v_T = a["inputs"]
    work = kernel_work_eval3d(stream, tc, a["evaluations"])
    calls = {
        E.KERNEL_FWD: (lambda: E.rasterize_eval3d_inference(*stream, None, tc),
                       lambda: E.rasterize_eval3d_fwd_plain(*stream, tc)),
        E.KERNEL_BWD: (lambda: E.rasterize_eval3d_bwd(*stream, img, T, v_img, v_T, tc),
                       lambda: E.rasterize_eval3d_bwd_plain(*stream, img, T, v_img, v_T, tc)),
    }
    out = {}
    for name, (kernel, plain) in calls.items():
        out[name] = dict(ms=time_ms(kernel, reps), device_graph_ms=graph_ms(kernel, reps),
                         plain_ms=time_ms(plain, 1), library_ms=None, **work[name])
    out[E.KERNEL_FWD]["train_call_ms"] = time_ms(
        lambda: E.rasterize_eval3d_train_fwd(*stream, tc), reps)
    # kernel 3 on kernel 8's own rows (13 + D columns), as the eval3d VJP
    # sums them per gaussian
    v_rows = E.rasterize_eval3d_bwd(*stream, img, T, v_img, v_T, tc)[0]
    seg = measure_segment_sum(v_rows, a["flatten_ids"], stream[3], a["n_gaussians"], reps)
    emit("kernels_eval3d", **out, segment_sum_on_eval3d_rows=seg)
    return out, seg


def phase_bench_render_eval3d(bench, cap, n_frames=20):
    """20 frames of the 200k scene through the world-space rasterizer
    (kernel 7's forward-only call), each re-projected and re-sorted, as the
    JAX package's bench.py:210-232 times them."""

    def frame(i):
        img, _, meta = tdgs_torch.rasterization(
            bench["means"], bench["quats"], bench["scales"],
            bench["opacities"] * (1.0 + 1e-5 * i), bench["sh"], bench["viewmats"],
            bench["Ks"], WIDTH, HEIGHT, sh_degree=3, tile_capacity=1024,
            max_tiles_per_gauss=16, isect_capacity=cap, rasterizer="eval3d_packed",
            device=DEVICE)
        return img, meta

    frame(0)
    torch.cuda.synchronize()
    _build.reset_launches()
    acc = torch.zeros((), device=DEVICE)
    t0 = time.perf_counter()
    for i in range(n_frames):
        img, meta = frame(i)
        acc += img.mean()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.LAUNCHES.get(E.KERNEL_FWD, 0)
    emit("bench_render_eval3d", frames=n_frames, fps=n_frames / wall, wall_s=wall,
         n_gaussians=int(bench["means"].shape[0]), isect_capacity=cap,
         n_isects=meta["n_isects"], n_dropped=meta["n_dropped"], launches=launches,
         finite=bool(torch.isfinite(acc)), traced_frame=traced(lambda: frame(0)))
    if launches < n_frames:
        raise RuntimeError(f"bench_render_eval3d launched kernel 7 {launches} < {n_frames} times")
    if not bool(torch.isfinite(acc)):
        raise RuntimeError("bench_render_eval3d: non-finite frame")
    return launches


def phase_render_train_eval3d(bench, cap, n_steps=20):
    """The JAX package's bench.py training step with model="eval3d"
    (bench.py:236-282) on the port: rasterization(rasterizer=
    "eval3d_packed"), loss = img.mean() + alpha.mean(), gradients w.r.t.
    means, quats, scales, opacities and SH, 20 steps at 1920x1080 with 200k
    gaussians."""
    names = ("means", "quats", "scales", "opacities", "sh")
    leaves = [bench[k].clone().requires_grad_(True) for k in names]
    box = {}

    def forward(i):
        m, q, sc, op, sh = leaves
        img, alpha, meta = tdgs_torch.rasterization(
            m, q, sc, op * (1.0 + 1e-5 * i), sh, bench["viewmats"], bench["Ks"],
            WIDTH, HEIGHT, sh_degree=3, rasterizer="eval3d_packed", tile_capacity=1024,
            max_tiles_per_gauss=16, isect_capacity=cap, device=DEVICE)
        box["meta"] = meta
        return img.mean() + alpha.mean()

    def step(i):
        loss = forward(i)
        return loss, torch.autograd.grad(loss, leaves)

    step(0)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    ev = []
    t0 = time.perf_counter()
    for i in range(n_steps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        loss, grads = step(i)
        e1.record()
        ev.append((e0, e1))
        finite &= torch.isfinite(loss) & torch.stack([torch.isfinite(g).all() for g in grads]).all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = (E.KERNEL_TRAIN, E.KERNEL_BWD, S.KERNEL)
    launches = {k: _build.LAUNCHES.get(k, 0) for k in kernels}
    step_ms = [a.elapsed_time(b) for a, b in ev]
    holder = {}

    def fwd_only():
        holder["loss"] = forward(0)

    def bwd_only():
        torch.autograd.grad(holder["loss"], leaves)

    fwd_trace = traced(fwd_only)
    bwd_trace = traced(bwd_only)
    emit("render_train_eval3d", steps=n_steps, width=WIDTH, height=HEIGHT,
         n_gaussians=int(leaves[0].shape[0]), isect_capacity=cap,
         n_isects=box["meta"]["n_isects"], n_dropped=box["meta"]["n_dropped"],
         fps=n_steps / wall, wall_s=wall, step_ms_mean=float(np.mean(step_ms)),
         step_ms_p50=float(np.percentile(step_ms, 50)), launches=launches,
         all_finite=bool(finite), traced_forward=fwd_trace, traced_backward=bwd_trace)
    if not bool(finite):
        raise RuntimeError("render_train_eval3d: non-finite loss or gradient")
    for k in kernels:
        if launches[k] < n_steps:
            raise RuntimeError(f"render_train_eval3d launched {k} {launches[k]} < {n_steps} times")
    return launches


def phase_cli_3dgut(root, n_steps=60):
    """``python -m tdgs_torch.simple_trainer mcmc --with-ut --with-eval3d``
    on the 64x48 test scene (make_colmap_test_scene), 60 steps, on the card,
    in its own process."""
    scene = f"{root}/cli_scene"
    make_colmap_test_scene(scene, device=DEVICE)
    cmd = [sys.executable, "-m", "tdgs_torch.simple_trainer", "mcmc", "--with-ut",
           "--with-eval3d", "--data-dir", scene, "--result-dir", f"{root}/cli_out",
           "--data-factor", "1", "--max-steps", str(n_steps), "--eval-steps", str(n_steps),
           "--save-steps", "", "--cap-max", "2000", "--tile-capacity", "256",
           "--sh-degree", "1", "--sh-degree-interval", "20", "--test-every", "4",
           "--disable-video"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    stats = json.loads(lines[-1]) if out.returncode == 0 and lines else {}
    emit("cli_3dgut", command=" ".join(cmd[1:5]), steps=n_steps, rc=out.returncode,
         wall_s=wall, eval=stats, stderr_tail=out.stderr[-400:] if out.returncode else "")
    if out.returncode != 0 or not np.isfinite(stats.get("psnr", float("nan"))):
        raise RuntimeError(f"cli_3dgut: rc {out.returncode}, {out.stderr[-2000:]}")
    return stats


# ---------------------------------------------------------------------------
# tile-dense: kernels 9 and 10, the bench-scale render and training step,
# the Runner with rasterizer="pallas", the image-fitting example
# ---------------------------------------------------------------------------


def dense_capacity(sc, max_tiles_per_gauss=16):
    """The dense tiling's isect_capacity for a scene, sized as the JAX
    package's bench.py:100-105 sizes it (derive_isect_capacity, 10%
    headroom)."""
    return derive_isect_capacity(sc["means"], sc["quats"], sc["scales"], sc["opacities"],
                                 sc["viewmats"], sc["Ks"], WIDTH, HEIGHT,
                                 max_tiles_per_gauss=max_tiles_per_gauss, device=DEVICE)


def kernel_inputs_dense(sc, tile_capacity, render_mode="RGB", **kw):
    """Kernel 9's inputs for one frame: the port's projection, SH and dense
    tiling (rasterization's meta with rasterizer="pallas"), then the
    per-tile gather. Returns (rows [T, cap, 6 + D], counts [T], meta)."""
    with torch.no_grad():
        _, _, meta = tdgs_torch.rasterization(
            sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["sh"],
            sc["viewmats"], sc["Ks"], WIDTH, HEIGHT, sh_degree=3, render_mode=render_mode,
            rasterizer="pallas", tile_capacity=tile_capacity, device=DEVICE, **kw)
        colors = _colors_per_camera(sc["sh"], 3, sc["means"], sc["viewmats"], meta["radii"])
        if render_mode == "RGB+ED":
            colors = torch.cat([colors, meta["depths"][..., None]], -1)
        rows, counts = RP.dense_rows(meta["means2d"], meta["conics"], colors,
                                     meta["opacities"], meta["isect_offsets"],
                                     meta["flatten_ids"], meta["n_isects"], tile_capacity)
    return rows.contiguous(), counts, meta


def dense_stats(meta, counts, tile_capacity):
    offs = meta["isect_offsets"].reshape(-1).long()
    ranges = torch.diff(torch.cat([offs, offs.new_tensor([meta["n_isects"]])]))
    return dict(n_isects=meta["n_isects"], n_dropped=meta["n_dropped"],
                isect_capacity=int(meta["flatten_ids"].shape[0]),
                valid_slots=int(counts.sum()), max_tile_range=int(ranges.max()),
                tiles_cut=int((ranges > tile_capacity).sum()))


def parity_dense(name, sc, tile_capacity, seed, backgrounds=None, must_cut=False, **kw):
    """Kernels 9 and 10 against their plain versions on one frame's dense
    rows (``check_dense``); random cotangents. Fails, with ``must_cut``, if
    no tile holds more than ``tile_capacity`` entries."""
    render_mode = kw.pop("render_mode", "RGB")
    rows, counts, meta = kernel_inputs_dense(sc, tile_capacity, render_mode, **kw)
    stats = dense_stats(meta, counts, tile_capacity)
    geo = (1, WIDTH, HEIGHT, 16)
    img, trans = RP.rasterize_dense_fwd(rows, counts, *geo)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    v_img = torch.randn(img.shape, generator=g, device=DEVICE)
    v_t = torch.randn(trans.shape, generator=g, device=DEVICE)
    out = check_dense(name, (rows, counts, geo, img, trans, v_img, v_t), backgrounds,
                      tile_capacity=tile_capacity, **stats)
    if must_cut and not stats["tiles_cut"]:
        raise RuntimeError(f"parity_dense {name}: no tile is cut at {tile_capacity}")
    return out


def check_dense(name, inputs, backgrounds=None, **fields):
    """Kernel 9's outputs and kernel 10's gradient rows on ``inputs`` (rows,
    counts, geometry, kernel 9's colours and T, their cotangents) against
    the plain versions, with the background (if any) blended as the wrapper
    blends it, and the blocks a tile the wrappers launched. Fails above TOL
    (forward) or BWD_RTOL per gradient group, on a non-finite output, or if
    a second launch of kernel 9 differs from the first in a bit."""
    rows, counts, geo, img, trans, v_img, v_t = inputs
    D = rows.shape[-1] - RP.GEOM_COLS
    again = RP.rasterize_dense_fwd(rows, counts, *geo)
    blocks = dict(fwd=RP.BLOCKS_A_TILE[RP.KERNEL_FWD])
    repeat_bitwise = torch.equal(again[0], img) and torch.equal(again[1], trans)
    img_p, trans_p = RP.rasterize_dense_fwd_plain(rows, counts, *geo)
    fwd = dict(colors=_abs_err(img, img_p), transmittance=_abs_err(trans, trans_p))
    if backgrounds is not None:
        bg = backgrounds.reshape(1, 1, 1, D)
        fwd["with_background"] = _abs_err(img + trans[..., None] * bg,
                                          img_p + trans_p[..., None] * bg)
    v_rows = RP.rasterize_dense_bwd(rows, counts, *geo, img, trans, v_img, v_t)
    blocks["bwd"] = RP.BLOCKS_A_TILE[RP.KERNEL_BWD]
    want = RP.rasterize_dense_bwd_plain(rows, counts, *geo, img, trans, v_img, v_t)
    torch.cuda.synchronize()
    bwd_rel = {k: _rel(v_rows[..., c], want[..., c]) for k, c in GROUPS.items()}
    finite = all(bool(torch.isfinite(x).all()) for x in (img, trans, v_rows))
    emit("parity_dense", case=name, D=D, **fields, alpha_mean=float((1 - trans_p).mean()),
         blocks_a_tile=blocks, fwd_repeat_bitwise=repeat_bitwise,
         fwd_max_abs_err=fwd, tol=TOL, bwd_max_rel_err=bwd_rel, bwd_rtol=BWD_RTOL,
         bwd_max_abs_err=_abs_err(v_rows, want), finite=finite)
    if not finite:
        raise RuntimeError(f"parity_dense {name}: non-finite kernel output")
    if not repeat_bitwise:
        raise RuntimeError(f"parity_dense {name}: two launches of kernel 9 differ")
    if not max(fwd.values()) <= TOL:
        raise RuntimeError(f"parity_dense {name}: forward {fwd} > {TOL}")
    if not max(bwd_rel.values()) <= BWD_RTOL:
        raise RuntimeError(f"parity_dense {name}: backward {bwd_rel} > {BWD_RTOL}")
    return dict(fwd=max(fwd.values()), bwd=_abs_err(v_rows, want),
                bwd_rel=max(bwd_rel.values()), inputs=inputs)


def phase_parity_dense(bench, heavy, cap):
    """Kernels 9 and 10 at the bench frame's dense shapes (200k gaussians,
    K = 16, ``cap`` from derive_isect_capacity, tile_capacity 1024): "RGB"
    with a background and "RGB+ED" (D = 4); on a truncating case (60k
    large gaussians, tile_capacity = 128); and at the image-fitting
    example's first step (64 tiles, the one shape here at which the
    wrappers cut each tile into several blocks)."""
    bg = torch.tensor([0.3, 0.5, 0.7], device=DEVICE)
    kw = dict(max_tiles_per_gauss=16, isect_capacity=cap)
    a = parity_dense("a_bench_rgb_background", bench, 1024, 5, backgrounds=bg, **kw)
    b = parity_dense("b_bench_rgb_ed", bench, 1024, 6, render_mode="RGB+ED", **kw)
    c = parity_dense("c_heavy_overlap_truncated", heavy, 128, 7, must_cut=True,
                     max_tiles_per_gauss=32, isect_capacity=dense_capacity(heavy, 32))
    fitting = kernel_inputs_fitting()
    d = check_dense("d_image_fitting", fitting, tile_capacity=fitting[0].shape[1],
                    valid_slots=int(fitting[1].sum()))
    return {k: max(x[k] for x in (a, b, c, d)) for k in ("fwd", "bwd", "bwd_rel")}, a, d


def dense_kernel_times(inputs, reps=20):
    """Times of kernels 9 and 10 on one frame's dense inputs (rows [T, cap,
    6 + D], counts, geometry, the forward's outputs and their cotangents),
    by CUDA events (``ms``) and by CUDA graph replay (``device_graph_ms``:
    without the host's time to make each call, which nears the kernels' at
    image fitting's shape), with their plain versions' and their bounds. No
    PyTorch call composites a tile's slots, so there is no library
    yardstick."""
    rows, counts, geo, img, trans, v_img, v_t = inputs
    T, cap, F = rows.shape
    D = F - RP.GEOM_COLS
    evals = RP.dense_evaluations(rows, counts, *geo)
    valid = int(counts.sum())
    n_pix = geo[0] * geo[1] * geo[2]
    # each input read once: the valid rows and the counts, per pixel the
    # forward's colours and T with their cotangents (backward); outputs
    # written once: the image and T, or every [T, cap, F] gradient row
    work = {
        RP.KERNEL_FWD: (valid * F * 4 + T * 4 + n_pix * (D + 1) * 4, fwd_ops(D, evals)),
        RP.KERNEL_BWD: (valid * F * 4 + T * 4 + n_pix * (2 * D + 2) * 4 + T * cap * F * 4,
                        bwd_ops(D, evals)),
    }
    calls = {
        RP.KERNEL_FWD: (lambda: RP.rasterize_dense_fwd(rows, counts, *geo),
                        lambda: RP.rasterize_dense_fwd_plain(rows, counts, *geo)),
        RP.KERNEL_BWD: (lambda: RP.rasterize_dense_bwd(rows, counts, *geo, img, trans,
                                                       v_img, v_t),
                        lambda: RP.rasterize_dense_bwd_plain(rows, counts, *geo, img, trans,
                                                             v_img, v_t)),
    }
    out = {}
    for name, (kernel, plain) in calls.items():
        n_bytes, n_ops = work[name]
        t_b, t_o = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32 * 1e3
        out[name] = dict(ms=time_ms(kernel, reps), device_graph_ms=graph_ms(kernel, reps),
                         blocks_a_tile=RP.BLOCKS_A_TILE[name], plain_ms=time_ms(plain, 2),
                         library_ms=None, bound_ms=max(t_b, t_o),
                         bound_by="bytes" if t_b >= t_o else "operations", bytes=n_bytes,
                         fp32_ops=n_ops, evaluations=evals, valid_slots=valid,
                         slots=T * cap)
    return out


def kernel_inputs_fitting(seed=9):
    """Kernels 9 and 10's inputs at the image-fitting example's shape: its
    first step (128x128, 2000 gaussians from ``init_params`` with the
    example's seed 42, tile_capacity 512, 64 tiles per gaussian), the
    forward's outputs and random cotangents."""
    from tdgs_torch import image_fitting as IF

    H = W = 128
    tc = 512
    p = IF.init_params(torch.Generator().manual_seed(42), 2000, device=DEVICE)
    viewmats, Ks = IF.build_camera(H, W, DEVICE)
    with torch.no_grad():
        colors = torch.sigmoid(p["colors"])
        _, _, meta = tdgs_torch.rasterization(
            p["means"], p["quats"], torch.exp(p["scales"]), torch.sigmoid(p["opacities"]),
            colors, viewmats, Ks, W, H, rasterizer="pallas", tile_capacity=tc,
            max_tiles_per_gauss=64, device=DEVICE)
        rows, counts = RP.dense_rows(meta["means2d"], meta["conics"], colors[None],
                                     meta["opacities"], meta["isect_offsets"],
                                     meta["flatten_ids"], meta["n_isects"], tc)
    rows = rows.contiguous()
    geo = (1, W, H, 16)
    img, trans = RP.rasterize_dense_fwd(rows, counts, *geo)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    v_img = torch.randn(img.shape, generator=g, device=DEVICE)
    v_t = torch.randn(trans.shape, generator=g, device=DEVICE)
    return rows, counts, geo, img, trans, v_img, v_t


def measure_kernels_dense(a, d, reps=20):
    """Times of kernels 9 and 10 at the bench frame's dense shapes ("RGB",
    tile_capacity 1024; parity_dense's case a) and, as their second shape,
    at the image-fitting example's (``image_fitting``; case d)."""
    out = dense_kernel_times(a["inputs"], reps)
    fitting = dense_kernel_times(d["inputs"], reps)
    emit("kernels_dense", **out, image_fitting=fitting)
    return out, fitting


def _psnr(a, b):
    mse = float(((a.clamp(0, 1) - b.clamp(0, 1)) ** 2).mean())
    return float("inf") if mse == 0 else -10.0 * float(np.log10(mse))


def phase_bench_render_pallas(bench, cap, n_frames=20):
    """20 frames of the 200k scene through rasterizer="pallas" (dense
    tiling at the derived capacity, the per-tile gather, kernel 9), each
    re-projected and re-sorted; then one frame traced, and the same frame
    through "packed_inference" for comparison (information, not a gate:
    the two differ only by the packed sort's depth quantisation)."""

    def frame(i, rasterizer="pallas"):
        img, _, meta = tdgs_torch.rasterization(
            bench["means"], bench["quats"], bench["scales"],
            bench["opacities"] * (1.0 + 1e-5 * i), bench["sh"], bench["viewmats"],
            bench["Ks"], WIDTH, HEIGHT, sh_degree=3, tile_capacity=1024,
            max_tiles_per_gauss=16, isect_capacity=cap, rasterizer=rasterizer,
            device=DEVICE)
        return img, meta

    with torch.no_grad():
        img0, meta = frame(0)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        acc = torch.zeros((), device=DEVICE)
        for i in range(n_frames):
            img, _ = frame(i)
            acc += img.mean()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _build.LAUNCHES.get(RP.KERNEL_FWD, 0)
        trace = traced(lambda: frame(0))
        packed, _ = frame(0, "packed_inference")
    emit("bench_render_pallas", frames=n_frames, fps=n_frames / wall, wall_s=wall,
         n_gaussians=int(bench["means"].shape[0]), isect_capacity=cap,
         n_isects=meta["n_isects"], n_dropped=meta["n_dropped"], kernel_launches=launches,
         traced_frame=trace, vs_packed_inference_max_abs_diff=_abs_err(img0, packed),
         vs_packed_inference_psnr_db=_psnr(img0, packed), finite=bool(torch.isfinite(acc)))
    if not bool(torch.isfinite(acc)):
        raise RuntimeError("bench_render_pallas: non-finite frame")
    if launches < n_frames:
        raise RuntimeError(f"bench_render_pallas launched kernel 9 {launches} < {n_frames} "
                           "times")
    return launches


def phase_image_fitting(min_iterations=1000):
    """``python -m tdgs_torch.image_fitting --rasterizer pallas`` at the
    example's defaults (128x128, 2000 gaussians, 1000 Adam steps) on the
    card, in its own process. The loss must fall below 0.55 of its start
    (the JAX package's test margin) and every step must launch kernels 9
    and 10."""
    cmd = [sys.executable, "-m", "tdgs_torch.image_fitting", "--rasterizer", "pallas"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    summary = json.loads(lines[-1]) if out.returncode == 0 and lines else {}
    launches = summary.get("launches", {})
    emit("image_fitting", command=" ".join(cmd[1:]), rc=out.returncode, process_wall_s=wall,
         **{k: v for k, v in summary.items() if k != "launches"},
         launches={k: launches.get(k, 0) for k in DENSE_KERNELS},
         log_tail=lines[-4:-1], stderr_tail=out.stderr[-400:] if out.returncode else "")
    if out.returncode != 0:
        raise RuntimeError(f"image_fitting: rc {out.returncode}, {out.stderr[-2000:]}")
    if not summary["final_loss"] < 0.55 * summary["initial_loss"]:
        raise RuntimeError(f"image_fitting: loss {summary['initial_loss']} -> "
                           f"{summary['final_loss']}")
    for k in DENSE_KERNELS:
        if launches.get(k, 0) < min_iterations:
            raise RuntimeError(f"image_fitting launched {k} {launches.get(k, 0)} times")
    return {k: launches.get(k, 0) for k in DENSE_KERNELS}


# ---------------------------------------------------------------------------
# the domino chain (python -m tdgs_torch.rally_e2e): dataset with instance
# masks → training with identity-vector segmentation (kernels 1, 2, 3; the
# identity render at D = 16) → clustering → PLY → bodies → rally (kernel 1
# at tile_capacity 2048 on the trained scene's plan)
# ---------------------------------------------------------------------------


def phase_rally_e2e(root, **chain_kw):
    """The chain at the JAX example's defaults (6 dominoes, 32 views of
    480x360, capacity 24k, 2000 steps, identity_dim 16; 90 frames at
    1920x1080, 240 Hz, 8 substeps), written under ``root``, no GIF. Fails
    unless it finds one cluster and one body per domino, each cluster of at
    least a seventh of the gaussians the scene draws a domino with (100 of
    700: a cluster of a few live rows is a domino lost to a neighbour's
    cluster, not a body), its kernel-vs-float64 golden reaches 40 dB,
    the bodies move, the validation PSNR is finite and each of kernels 1, 2
    and 3 launched."""
    from tdgs_torch.rally_e2e import run_chain

    torch.cuda.synchronize()
    _build.reset_launches()
    summary = run_chain(data_dir=f"{root}/data", out_dir=f"{root}/out", gif=None,
                        device=DEVICE, **chain_kw)
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES.get(k, 0) for k in KERNELS}
    emit("rally_e2e", launches=launches, **summary)
    n = summary["n_dominoes"]
    min_cluster = chain_kw.get("gauss_per_domino", 700) // 7
    failures = [
        (summary["clusters_found"] == summary["clusters_expected"] == n,
         f"clusters {summary['clusters_found']} of {n}"),
        (summary["n_bodies"] == n, f"bodies {summary['n_bodies']} of {n}"),
        (min(summary["cluster_sizes"], default=0) >= min_cluster,
         f"cluster sizes {summary['cluster_sizes']}, a domino needs {min_cluster}"),
        (summary["kernel_vs_oracle_psnr"] >= 40.0,
         f"golden {summary['kernel_vs_oracle_psnr']} dB < 40"),
        (summary["max_body_displacement"] > 0.0, "no body moved"),
        (bool(np.isfinite(summary["train_psnr"])), f"val PSNR {summary['train_psnr']}"),
        (summary["all_frames_finite"], "non-finite rally frame"),
    ] + [(launches[k] > 0, f"{k} never launched") for k in KERNELS]
    bad = [msg for ok, msg in failures if not ok]
    if bad:
        raise RuntimeError(f"rally_e2e: {'; '.join(bad)}")
    return summary, launches


def phase_parity_identity(root, summary, reps=20):
    """Kernels 1 (training call), 2 and 3 at D = 16 on the identity render
    of the chain's trained scene (its checkpoint's splats and head, the
    first training view, 480x360, the Runner's stream: K = 32,
    tile_capacity 1024) against their plain versions (TOL, BWD_RTOL,
    SEG_RTOL, kernel 3 bitwise repeatable), then timed; and kernel 1's
    inference call at the chain's rally frame (1920x1080, the PLY's
    splats, tile_capacity 2048, the chain's tiling plan), held to TOL and
    timed."""
    import pickle

    from tdgs_torch.datasets import Dataset, Parser
    from tdgs_torch.pipeline import GaussianModel
    from tdgs_torch.segmentation.head import apply_segmentation_head, head_from_numpy

    with open(f"{root}/out/ckpts/ckpt_{summary['steps']}.pkl", "rb") as f:
        state = pickle.load(f)
    sp = {k: torch.as_tensor(v, device=DEVICE) for k, v in state["splats"].items()}
    head = head_from_numpy(state["segmentation_head"], device=DEVICE)
    view = Dataset(Parser(f"{root}/data", factor=1, normalize=False), "train")[0]
    H, W = view["image"].shape[:2]
    vm = torch.as_tensor(view["viewmat"], device=DEVICE)
    K = torch.as_tensor(view["K"], device=DEVICE)
    with torch.no_grad():
        feats = apply_segmentation_head(head, sp["identity_encodings"])
        _, _, meta = tdgs_torch.rasterization(
            sp["means"], sp["quats"], torch.exp(sp["scales"]), torch.sigmoid(sp["opacities"]),
            feats, vm[None], K[None], W, H, rasterizer="packed", device=DEVICE)
    args = (meta["means2d"].contiguous(), meta["conics"].contiguous(),
            feats[None].contiguous(), meta["opacities"].contiguous(), W, H,
            meta["tile_size"], meta["isect_offsets"], meta["flatten_ids"])
    ident = train_parity("identity_d16", args, 1024, seed=3)
    t_ident = measure_train_kernels(ident["inputs"], reps=reps, tile_capacity=1024,
                                    phase="identity_kernels")

    splats = GaussianModel(sh_degree=3, device=DEVICE).load_splats_from_ply(
        f"{root}/out/scene.ply")
    K_r = K.clone()
    K_r[0] *= WIDTH / W
    K_r[1] *= HEIGHT / H
    frame = dict(means=splats["means"], quats=splats["quats"],
                 scales=torch.exp(splats["scales"]),
                 opacities=torch.sigmoid(splats["opacities"]),
                 sh=torch.cat([splats["sh0"], splats["shN"]], dim=-2),
                 viewmats=vm[None], Ks=K_r[None])
    bg = torch.full((1, 3), DOMINO_BACKGROUND, device=DEVICE)
    args_r, bg_r, _ = kernel_inputs(frame, backgrounds=bg, tile_capacity=2048,
                                    **summary["isect_plan"])
    err_r = parity("e_trained_dominoes_2048", args_r, backgrounds=bg_r, tile_capacity=2048)
    k_r = measure_kernel(args_r, backgrounds=bg_r, tile_capacity=2048, reps=reps)
    emit("kernel_rally_e2e_shape", tile_capacity=2048, max_abs_err=err_r, **k_r)
    return ident, t_ident, err_r, k_r


def phase_seg_step(root, summary, reps=10):
    """The segmentation layer's cost on the chain's trained scene (its
    checkpoint, the first training view, 480x360): the Runner's step
    without the segmentation step, with the CGC loss (the identity render
    at D = 16 forward and backward, the loss), with the spatial regularizer
    (8192 sampled gaussians) and with both, each by CUDA events over
    ``reps`` back-to-back steps; one step with both traced."""
    from tdgs_torch.rally_e2e import chain_config

    step = summary["steps"]
    cfg = chain_config(f"{root}/data", f"{root}/seg_step", step)
    runner = Runner(cfg, device=DEVICE)
    runner.load_checkpoint(f"{root}/out/ckpts/ckpt_{step}.pkl")
    batch = runner._batch([0])

    def run(use_seg, use_spatial):
        runner.train_step(batch, step, cfg.sh_degree, use_seg=use_seg,
                          use_spatial=use_spatial)

    modes = {"main": (False, False), "seg_loss": (True, False), "spatial": (False, True),
             "both": (True, True)}
    ms = {name: time_ms(lambda f=flags: run(*f), reps) for name, flags in modes.items()}
    emit("seg_step", reps=reps, step_ms=ms, seg_loss_ms=ms["seg_loss"] - ms["main"],
         spatial_ms=ms["spatial"] - ms["main"], traced_both=traced(lambda: run(True, True)))
    return ms


# ---------------------------------------------------------------------------
# depth and normal supervision: the rich scene's refined depths and normal
# maps, kernels 1-3 at the depth path's D = 4, the Runner with every depth
# and normal term, the sparse depths of a tracked copy, the trajectory
# render, and the ortho and fisheye cameras at the bench scale
# ---------------------------------------------------------------------------

# the depth path's Runner: dense depths from the refined maps, the
# depth-normal regularizers and the monocular normals from step 30, and the
# depth and normal dumps at the tb_every cadence
DEPTH_TERMS = dict(depth_loss=True, use_precomputed_depths=True, depth_normal_loss=True,
                   depth_normal_start_step=30, load_normals=True, start_normal_loss_step=30,
                   save_depth_normal_vis=True)


def phase_depth_scene(root, gt):
    """The rich scene's refined depths and normal maps, as a depth or normal
    estimator would give them: the ground-truth gaussians rendered in "ED"
    at every view through kernel 1 (exact coverage, tile_capacity 2048) into
    refined_depths/{stem}_refined_depth.npy, and the world normals of those
    depths (``utils/depth.depth_to_normal``) into normals/{stem}.npy; both
    in the frame the Runner's Parser normalizes to (depths times its scale,
    normals turned by its rotation)."""
    from tdgs_torch.datasets import Parser
    from tdgs_torch.utils.depth import depth_to_normal, rotate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parser = Parser(root, factor=1)
    T = parser.transform[:3, :3]
    det = float(np.linalg.det(T))
    if not det > 0:
        raise RuntimeError(f"depth_scene: the normalization has det {det}")
    scale = det ** (1.0 / 3.0)
    R = torch.as_tensor(T / scale, dtype=torch.float32, device=DEVICE)
    for sub in ("refined_depths", "normals"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    sc = to_card({k: gt[k] for k in ("means", "quats", "scales", "opacities", "colors")})
    W, H = parser.imsize_dict[parser.camera_ids[0]]
    _build.reset_launches()
    coverage = []
    for i, name in enumerate(parser.image_names):
        vm = torch.as_tensor(gt["viewmats"][i], device=DEVICE)
        K = torch.as_tensor(gt["Ks"][i], device=DEVICE)
        depth, _, _ = tdgs_torch.rasterization(
            sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["colors"], vm[None],
            K[None], W, H, render_mode="ED", rasterizer="packed_inference",
            tile_capacity=2048, isect_exact=True, device=DEVICE)
        normals = rotate(R, depth_to_normal(depth[0], torch.linalg.inv(vm), K))
        stem = os.path.splitext(name)[0]
        d = (depth[0, ..., 0] * scale).cpu().numpy()
        np.save(os.path.join(root, "refined_depths", f"{stem}_refined_depth.npy"), d)
        np.save(os.path.join(root, "normals", f"{stem}.npy"), normals.cpu().numpy())
        coverage.append(float((d > 0).mean()))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _build.LAUNCHES.get(KERNEL, 0)
    emit("depth_scene", views=len(parser.image_names), width=W, height=H, seconds=seconds,
         normalization_scale=scale, depth_coverage_min=min(coverage), kernel_1_launches=launches)
    if launches < len(parser.image_names) or not min(coverage) > 0.5:
        raise RuntimeError(f"depth_scene: {launches} launches, coverage {min(coverage)}")
    return seconds


def cell_config(root, name, n_steps, strategy=None, **extra):
    """The trainer cell's configuration (packed, SH 3, DefaultStrategy
    refining at 40 and 80, or ``strategy``) with ``extra`` options, logging
    every 10 steps."""
    strategy = strategy or DefaultStrategy(refine_start_iter=20, refine_every=40,
                                           refine_stop_iter=1000, reset_every=10_000)
    return Config(data_dir=root, result_dir=f"{root}/results_{name}", data_factor=1,
                  max_steps=n_steps, eval_steps=[], save_steps=[], sh_degree=3,
                  sh_degree_interval=20, rasterizer="packed", tb_every=10,
                  strategy=strategy, **extra)


def train_timed(runner, n_steps):
    """runner.train() with the host time of its batches (decode, or the wait
    for the decode-ahead, and the copies to the card) summed apart: (steps
    a second, data ms a step, history)."""
    box = {"s": 0.0, "n": 0}
    batch = runner._batch

    def timed(idx):
        t = time.perf_counter()
        out = batch(idx)
        box["s"] += time.perf_counter() - t
        box["n"] += 1
        return out

    runner._batch = timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = runner.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    runner._batch = batch
    return n_steps / wall, box["s"] / max(box["n"], 1) * 1e3, out["history"]


def train_records(result_dir):
    with open(os.path.join(result_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "train/loss" in r]


def phase_trainer_depth(root, n_steps=100):
    """The Runner with every depth and normal term (``DEPTH_TERMS``) on the
    rich scene with its refined depths and normal maps, 100 steps, then
    eval (PSNR, SSIM, LPIPS); once without the decode-ahead and then, the
    run that counts the launches, with it. Fails unless every loss term is
    finite at the last step, the RGB loss dropped, the 20 dumps were
    written, eval is finite and kernels 1-3 launched every step."""
    runs = {}
    for prefetch in (False, True):
        name = f"trainer_depth{'' if prefetch else '_no_prefetch'}"
        runner = Runner(cell_config(root, name, n_steps, data_prefetch=prefetch,
                                     **DEPTH_TERMS), device=DEVICE)
        _build.reset_launches()
        steps_per_s, data_ms, hist = train_timed(runner, n_steps)
        launches = {k: _build.LAUNCHES.get(k, 0) for k in KERNELS}
        runs[prefetch] = dict(runner=runner, steps_per_s=steps_per_s, data_ms_per_step=data_ms,
                              hist=hist, launches=launches)
    runs[False]["runner"].close()
    main = runs[True]
    runner = main["runner"]
    _build.reset_launches()
    stats = runner.eval(n_steps)
    eval_launches = _build.LAUNCHES.get(KERNEL, 0)
    # one more step traced (it changes the splats after the eval above)
    batch = runner._batch([0])
    step_trace = traced(lambda: runner.train_step(batch, n_steps + 1, runner.cfg.sh_degree))
    records = train_records(runner.cfg.result_dir)
    terms = {k[len("train/"):]: v for k, v in records[-1].items()
             if k.startswith("train/") and k[len("train/"):] in
             ("rgbloss", "depthloss", "normalloss", "depthsmooth", "normalconsist")}
    vis = sorted(os.listdir(os.path.join(runner.cfg.result_dir, "vis")))
    emit("trainer_depth", steps=n_steps, train_images=len(runner.trainset),
         capacity=runner.capacity, steps_per_s=main["steps_per_s"],
         data_ms_per_step=main["data_ms_per_step"],
         no_prefetch_steps_per_s=runs[False]["steps_per_s"],
         no_prefetch_data_ms_per_step=runs[False]["data_ms_per_step"],
         loss_terms_last=terms, rgbloss_first=records[0]["train/rgbloss"],
         loss_first=main["hist"][0], loss_last=main["hist"][-1], vis_pngs=len(vis),
         refines=runner.refines, launches=main["launches"],
         no_prefetch_launches=runs[False]["launches"], eval_launches=eval_launches,
         eval_psnr=stats["psnr"], eval_ssim=stats["ssim"],
         eval_lpips_proxy=stats.get("lpips_proxy"), eval_lpips=stats.get("lpips"),
         lpips_impl=stats["lpips_impl"], eval_num_gs=stats["num_GS"], traced_step=step_trace)
    failures = [
        (set(terms) == {"rgbloss", "depthloss", "normalloss", "depthsmooth", "normalconsist"}
         and all(np.isfinite(v) for v in terms.values()), f"loss terms {terms}"),
        (terms.get("rgbloss", np.inf) < records[0]["train/rgbloss"], "the RGB loss did not drop"),
        (len(vis) == 2 * (n_steps // 10), f"{len(vis)} vis PNGs"),
        (all(np.isfinite(stats[k]) for k in ("psnr", "ssim")) and stats["lpips_impl"]
         and np.isfinite(stats.get("lpips_proxy", stats.get("lpips"))), f"eval {stats}"),
        (eval_launches >= len(runner.valset), f"eval launched kernel 1 {eval_launches} times"),
    ] + [(main["launches"][k] >= n_steps, f"{k} launched {main['launches'][k]} times")
         for k in KERNELS]
    bad = [msg for ok, msg in failures if not ok]
    if bad:
        raise RuntimeError(f"trainer_depth: {'; '.join(bad)}")
    return runner, main["launches"], eval_launches


def depth_kernel_inputs(runner, view=0):
    """Kernel 1-3's operands on the depth path's stream: the Runner's splats
    rendered to training view ``view`` in "RGB+ED" as its step renders them
    (the packed tiling at its capacities), the SH colours with the depths
    as the fourth channel."""
    from tdgs_torch.models.gaussians import splat_activations

    cfg = runner.cfg
    d = runner.trainset[view]
    H, W = d["image"].shape[:2]
    vm = torch.as_tensor(d["viewmat"], device=DEVICE)[None]
    K = torch.as_tensor(d["K"], device=DEVICE)[None]
    with torch.no_grad():
        means, quats, scales, opacities, sh = splat_activations(runner.splats)
        _, _, meta = tdgs_torch.rasterization(
            means, quats, scales, opacities, sh, vm, K, W, H, sh_degree=cfg.sh_degree,
            render_mode="RGB+ED", rasterizer="packed", tile_capacity=cfg.tile_capacity,
            isect_capacity=cfg.isect_capacity, max_tiles_per_gauss=cfg.max_tiles_per_gauss,
            device=DEVICE)
        colors = torch.cat([_colors_per_camera(sh, cfg.sh_degree, means, vm, meta["radii"]),
                            meta["depths"][..., None]], -1)
    return (meta["means2d"].contiguous(), meta["conics"].contiguous(), colors.contiguous(),
            meta["opacities"].contiguous(), W, H, meta["tile_size"], meta["isect_offsets"],
            meta["flatten_ids"])


def phase_parity_depth(runner, reps=20):
    """Kernels 1 (training call), 2 and 3 at D = 4 on the trained depth
    path's first training view (1236x822), against their plain versions
    (TOL, BWD_RTOL, SEG_RTOL; kernel 3 bitwise repeatable), also cut at
    tile_capacity = 128; then timed by CUDA events and graph replay, with
    their bounds and index_add_ beside kernel 3."""
    args = depth_kernel_inputs(runner)
    a = train_parity("depth_d4", args, 1024, seed=4)
    counts = torch.diff(args[7].long())
    cut = int((counts > max_entries_per_tile(128)).sum())
    if cut == 0:
        raise RuntimeError("parity_depth: no tile reaches 128 entries to cut")
    b = train_parity("depth_d4_truncated", args, 128, seed=5)
    t = measure_train_kernels(a["inputs"], reps=reps, tile_capacity=1024,
                              phase="depth_kernels")
    errs = {k: max(a[k], b[k]) for k in ("fwd", "bwd", "seg", "bwd_rel", "seg_rel")}
    return errs, t


def phase_trainer_depth_sparse(root, n_steps=20):
    """The Runner with the sparse depth loss on a tracked copy of the rich
    scene (each image tracks the SfM points that project inside it:
    ``utils/test_data.tracked_copy``), 20 steps. Fails unless the depth
    loss is finite and every training view has a point."""
    from tdgs_torch.utils.test_data import tracked_copy

    root_t = os.path.join(root, "tracked")
    os.makedirs(root_t)
    tracked_copy(root, root_t)
    runner = Runner(cell_config(root_t, "trainer_depth_sparse", n_steps, depth_loss=True),
                    device=DEVICE)
    names = [runner.parser.image_names[i] for i in runner.trainset.indices]
    counts = [len(runner.parser.point_indices[n]) for n in names]
    _build.reset_launches()
    steps_per_s, data_ms, hist = train_timed(runner, n_steps)
    runner.close()
    depthloss = train_records(runner.cfg.result_dir)[-1]["train/depthloss"]
    emit("trainer_depth_sparse", steps=n_steps, steps_per_s=steps_per_s,
         data_ms_per_step=data_ms, depthloss_last=depthloss,
         mean_points_a_view=float(np.mean(counts)), min_points_a_view=min(counts),
         loss_last=hist[-1],
         launches={k: _build.LAUNCHES.get(k, 0) for k in KERNELS})
    if not np.isfinite(depthloss) or min(counts) < 1:
        raise RuntimeError(f"trainer_depth_sparse: depthloss {depthloss}, "
                           f"min points a view {min(counts)}")


def phase_render_traj(runner, n_frames=60):
    """The trajectory render at the end of training: 60 "interp" frames of
    the depth path's trained scene at 1236x822 in "RGB+ED" through kernel
    1's inference call (``render_fps``: the frames on the host), then
    written out (a GIF where PIL imports, else PNG frames; ``fps``: both)."""
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = runner.traj_frames(n_frames, traj_path="interp")
    render_s = time.perf_counter() - t0
    path = runner.write_traj(runner.cfg.max_steps, frames)
    wall = time.perf_counter() - t0
    if os.path.isdir(path):
        frames = len(os.listdir(path))
    else:
        from PIL import Image

        with Image.open(path) as im:
            frames = im.n_frames
    launches = _build.LAUNCHES.get(KERNEL, 0)
    emit("render_traj", frames=frames, fps=frames / wall, render_fps=n_frames / render_s,
         wall_s=wall, write_s=wall - render_s, path=path, launches=launches)
    if frames != n_frames or launches < n_frames:
        raise RuntimeError(f"render_traj: {frames} frames, {launches} launches")


def phase_camera_models(bench, n_frames=20):
    """The 200k-gaussian bench scene at 1920x1080 through the orthographic
    camera (90 pixels a world unit: the scene's ±3σ in y fills the height)
    and the equidistant fisheye (f = 960 / (π / 2): the width spans 180°):
    kernel 1 within TOL of its plain version on each stream, 20 frames each,
    and one forward and backward "packed" step under the fisheye with
    finite gradients."""
    out = {}
    worst = 0.0
    for cm, f in (("ortho", 0.5 * HEIGHT / 6.0), ("fisheye", 0.5 * WIDTH / (np.pi / 2))):
        K = torch.tensor([[[f, 0, WIDTH / 2], [0, f, HEIGHT / 2], [0, 0, 1]]],
                         dtype=torch.float32, device=DEVICE)
        sc = dict(bench, Ks=K)
        args, _, meta = kernel_inputs(sc, max_tiles_per_gauss=16, camera_model=cm)
        worst = max(worst, parity(f"{cm}_bench", args))

        def frame(i):
            img, _, _ = tdgs_torch.rasterization(
                sc["means"], sc["quats"], sc["scales"], sc["opacities"] * (1.0 + 1e-5 * i),
                sc["sh"], sc["viewmats"], K, WIDTH, HEIGHT, sh_degree=3, camera_model=cm,
                tile_capacity=1024, max_tiles_per_gauss=16, device=DEVICE)
            return img

        frame(0)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        acc = torch.zeros((), device=DEVICE)
        for i in range(n_frames):
            acc += frame(i).mean()
        torch.cuda.synchronize()
        out[cm] = dict(focal=f, fps=n_frames / (time.perf_counter() - t0),
                       n_isects=meta["n_isects"], n_dropped=meta["n_dropped"],
                       launches=_build.LAUNCHES.get(KERNEL, 0),
                       visible_share=float(meta["radii"].gt(0).all(-1).float().mean()),
                       finite=bool(torch.isfinite(acc)))
    names = ("means", "quats", "scales", "opacities", "sh")
    leaves = [bench[k].clone().requires_grad_(True) for k in names]
    K = torch.tensor([[[out["fisheye"]["focal"], 0, WIDTH / 2],
                       [0, out["fisheye"]["focal"], HEIGHT / 2], [0, 0, 1]]], device=DEVICE)
    img, alpha, _ = tdgs_torch.rasterization(
        *leaves, bench["viewmats"], K, WIDTH, HEIGHT, sh_degree=3, camera_model="fisheye",
        rasterizer="packed", tile_capacity=1024, max_tiles_per_gauss=16, device=DEVICE)
    grads = torch.autograd.grad(img.mean() + alpha.mean(), leaves)
    grads_finite = all(bool(torch.isfinite(g).all()) for g in grads)
    emit("camera_models", tol=TOL, max_abs_err=worst, fisheye_grads_finite=grads_finite,
         fisheye_grad_means_max=float(grads[0].abs().max()), **out)
    if not grads_finite or not all(v["finite"] and v["launches"] >= n_frames
                                   for v in out.values()):
        raise RuntimeError(f"camera_models: {out}, gradients finite {grads_finite}")
    return worst


# ---------------------------------------------------------------------------
# the trainer's optional modules (pose corrector and noise, appearance,
# bilateral grids, PNG compression) on the rich scene, the dense reference
# rasterizers against kernels 5-8, and the surfel image fit
# ---------------------------------------------------------------------------

AUX_TERMS = ("rgbloss", "tvloss", "posereg", "appreg", "opacityreg", "scalereg")


def means_roundtrip_steps(splats, compress_dir):
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
    dec = PngCompression(device=DEVICE).decompress(compress_dir)["means"]

    def log(x):
        return np.sign(x) * np.log1p(np.abs(x))

    step = (log(means).max(0) - log(means).min(0)) / 65535
    return float((np.abs(log(dec) - log(means)) / step).max())


def aux_config(root, name, model_type, n_steps, **extra):
    """The trainer cell's configuration (``"3dgs"``) or the trainer_3dgut
    cell's (``"3dgut"``: the mcmc preset, cap_max 160k, UT and eval3d) with
    ``extra``: (config, the kernels of its path)."""
    if model_type == "3dgut":
        strategy = MCMCStrategy(cap_max=160_000, refine_start_iter=20, refine_every=40,
                                refine_stop_iter=1000)
        return cell_config(root, name, n_steps, strategy=strategy, with_ut=True,
                           with_eval3d=True, init_opa=0.5, init_scale=0.1, opacity_reg=0.01,
                           scale_reg=0.01, **extra), (E.KERNEL_TRAIN, E.KERNEL_BWD, S.KERNEL)
    return cell_config(root, name, n_steps, **extra), KERNELS


AUX_MODULES = dict(pose_opt=True, pose_noise=1e-3, app_opt=True, use_bilateral_grid=True)


def phase_trainer_aux_pose_lr(root, pose_opt_lr=1e-3, n_steps=100):
    """The trainer_aux configuration with the pose corrector at
    ``pose_opt_lr``, 100 steps, then eval; no gate. The aux Adam (the JAX
    Runner's: no bias correction, every row every step) moves an image's
    pose on every step after a visit, by 3.16·lr at first and 0.9 times
    less each step, about 32·lr in all: at 1e-3, 0.03 a visit, thirty times
    the pose noise it should undo."""
    cfg, _ = aux_config(root, "trainer_aux_pose_lr", "3dgs", n_steps,
                        **dict(AUX_MODULES, pose_opt_lr=pose_opt_lr))
    runner = Runner(cfg, device=DEVICE)
    steps_per_s, _, _ = train_timed(runner, n_steps)
    stats = runner.eval(n_steps)
    emit("trainer_aux_pose_lr", pose_opt_lr=pose_opt_lr, steps=n_steps,
         steps_per_s=steps_per_s,
         rgbloss=[r["train/rgbloss"] for r in train_records(cfg.result_dir)],
         corrector_max_abs=float(runner.camera_opt.embeds.detach().abs().max()),
         eval_psnr=stats["psnr"], eval_cc_psnr=stats["cc_psnr"])
    runner.close()


def phase_trainer_aux(root, scene_s, model_type="3dgs", n_steps=100):
    """The Runner with the optional modules on the rich scene, 100 steps,
    then eval, the pose corrector at its default lr (1e-5) behind a fixed
    pose noise of 1e-3 (``phase_trainer_aux_pose_lr`` shows why not 1e-3).
    ``"3dgs"`` (phase ``trainer_aux``): the trainer cell with the pose
    corrector, the appearance module (feature_dim 32, embed_dim 16) and the
    bilateral grids (16, 16, 8), then ``run_compression``. ``"3dgut"``
    (phase ``trainer_3dgut_pose``): the trainer_3dgut cell with the pose
    corrector and noise. Fails on a non-finite loss term or eval, an RGB
    loss that did not drop, a corrector that did not move or is not finite,
    a kernel of the path launched fewer times than steps; for trainer_aux
    also on cc_psnr below psnr − 1e-3 dB (the identity affine is in the
    fit's family) and on decompressed means further than one 16-bit step of
    their log-space span from the originals."""
    if model_type == "3dgut":
        name = "trainer_3dgut_pose"
        cfg, kernels = aux_config(root, name, model_type, n_steps, pose_opt=True,
                                  pose_noise=1e-3)
    else:
        name = "trainer_aux"
        cfg, kernels = aux_config(root, name, model_type, n_steps, **AUX_MODULES)
    runner = Runner(cfg, device=DEVICE)
    _build.reset_launches()
    steps_per_s, data_ms, hist = train_timed(runner, n_steps)
    launches = {k: _build.LAUNCHES.get(k, 0) for k in kernels}
    stats = runner.eval(n_steps)
    records = train_records(cfg.result_dir)
    terms = {k[len("train/"):]: v for k, v in records[-1].items()
             if k[len("train/"):] in AUX_TERMS}
    embeds = runner.camera_opt.embeds.detach()
    moved = float(embeds.abs().max())
    # one more step traced (it changes the splats after the eval above)
    batch = runner._batch([0])
    step_trace = traced(lambda: runner.train_step(batch, n_steps + 1, cfg.sh_degree))
    fields = dict(steps=n_steps, scene_s=scene_s, train_images=len(runner.trainset),
                  capacity=runner.capacity, steps_per_s=steps_per_s, data_ms_per_step=data_ms,
                  loss_terms_last=terms, rgbloss_first=records[0]["train/rgbloss"],
                  loss_first=hist[0], loss_last=hist[-1], refines=runner.refines,
                  launches=launches, corrector_max_abs=moved,
                  corrector_rms=float(embeds.pow(2).mean().sqrt()),
                  pose_noise_rms=float(runner._pose_perturb.pow(2).mean().sqrt()),
                  eval_psnr=stats["psnr"], eval_ssim=stats["ssim"],
                  eval_num_gs=stats["num_GS"], traced_step=step_trace)
    failures = [
        (all(np.isfinite(v) for v in terms.values()) and "rgbloss" in terms,
         f"loss terms {terms}"),
        (terms.get("rgbloss", np.inf) < records[0]["train/rgbloss"], "the RGB loss did not drop"),
        (np.isfinite(stats["psnr"]) and np.isfinite(stats["ssim"]), f"eval {stats}"),
        (0.0 < moved < np.inf and bool(torch.isfinite(embeds).all()),
         f"the corrector moved {moved}"),
    ] + [(launches[k] >= n_steps, f"{k} launched {launches[k]} times") for k in kernels]
    if model_type == "3dgs":
        identity = init_bilateral_grid(1, 1, 1, 1, device=DEVICE).reshape(12)
        fields.update(eval_cc_psnr=stats["cc_psnr"], eval_cc_ssim=stats["cc_ssim"],
                      app_embeds_max_abs=float(runner.app_module.embeds.detach().abs().max()),
                      bilagrid_max_dev=float((runner.bilagrid.detach() - identity)
                                             .abs().max()))
        failures.append((stats["cc_psnr"] >= stats["psnr"] - 1e-3,
                         f"cc_psnr {stats['cc_psnr']} < psnr {stats['psnr']} - 1e-3"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comp = runner.run_compression(n_steps)
        comp_s = time.perf_counter() - t0
        cdir = os.path.join(cfg.result_dir, "compression")
        files = {f: os.path.getsize(os.path.join(cdir, f)) for f in sorted(os.listdir(cdir))}
        steps_off = means_roundtrip_steps(runner.splats, cdir)
        floats = sum(v[0].numel() for v in runner.splats.values())
        fields.update(compression_wall_s=comp_s, compression_bytes=sum(files.values()),
                      compression_files=files, compression_psnr=comp["psnr"],
                      compression_ssim=comp["ssim"], compression_num_gs=comp["num_GS"],
                      uncompressed_bytes=int(stats["num_GS"]) * floats * 4,
                      means_max_err_16bit_steps=steps_off)
        failures += [(np.isfinite(comp["psnr"]), f"compressed eval {comp}"),
                     (steps_off <= 1.0, f"means {steps_off} 16-bit steps off")]
    emit(name, **fields)
    runner.close()
    bad = [msg for ok, msg in failures if not ok]
    if bad:
        raise RuntimeError(f"{name}: {'; '.join(bad)}")
    return launches


def dense_window(counts_fn, max_bytes=1e9, size=(512, 288)):
    """The largest centred window of the bench view, halved from ``size``
    until the dense rasterizers' largest [tiles, pixels, capacity] tensor
    fits ``max_bytes`` (autograd keeps a few dozen of them), with the
    capacity the window's longest tile (whole 128s, so that the packed
    kernels cut nothing either): (W, H, tile_capacity, entries, tiles).
    ``counts_fn(W, H)`` gives the packed stream's entries a tile."""
    W, H = size
    while True:
        counts = counts_fn(W, H)
        cap = max(128, -(-int(counts.max()) // 128) * 128)
        if counts.numel() * 256 * cap * 4 <= max_bytes or W <= 64:
            return W, H, cap, int(counts.sum()), counts.numel()
        W, H = W // 2, H // 2


def _window_Ks(sc, W, H):
    Ks = sc["Ks"].clone()
    Ks[:, 0, 2], Ks[:, 1, 2] = W / 2, H / 2
    return Ks


def _dense_pair(render, inputs, n_out, reps=3):
    """The dense route and the kernel route (``render(route, *leaves)`` →
    outputs) on the same inputs: (outputs, gradients of a random
    cotangent sum of the first ``n_out`` outputs, ms of forward + backward
    by CUDA events) for each route."""
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    res = {}
    cot = None
    for route in ("dense", "kernel"):
        leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
        torch.cuda.reset_peak_memory_stats()
        out = render(route, *leaves)
        if cot is None:
            cot = [torch.randn(o.shape, generator=gen, device=DEVICE) for o in out[:n_out]]
        grads = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out[:n_out], cot)),
                                    leaves, allow_unused=True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        def step():
            o = render(route, *leaves)
            torch.autograd.grad(sum((x * c).sum() for x, c in zip(o[:n_out], cot)), leaves,
                                allow_unused=True)

        res[route] = dict(out=[o.detach() for o in out], grads=grads,
                          ms=time_ms(step, reps), peak_gib=peak)
    return res


def phase_parity_dense_reference(bench):
    """The dense plain-tensor rasterizers, independent of the kernels, as
    references for them on the card: on a centred window of the bench view
    sized from its stream (``dense_window``: the largest [T, P, cap] tensor
    under 2 GB, no tile cut), the dense world-space ``"eval3d"`` against
    ``"eval3d_packed"`` (kernels 7, 8 and 3) and the dense 2DGS ``"jax"``
    against ``"packed"`` (kernels 5, 6 and 3), "RGB" with the gradients to
    every input (the pose's too, for eval3d), and 2DGS "RGB+ED" with
    distortion. Outputs within TOL (distortion DIST_RTOL, median
    MEDIAN_SHARE), gradients within BWD_RTOL of each group's max. Times both
    routes (forward + backward) and prints the peak memory."""
    sc = bench
    errs = {}

    def counts_3dgs(W, H):
        with torch.no_grad():
            _, _, meta = tdgs_torch.rasterization(
                sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["sh"],
                sc["viewmats"], _window_Ks(sc, W, H), W, H, sh_degree=3,
                rasterizer="packed_inference", device=DEVICE)
        return torch.diff(meta["isect_offsets"].long())

    def counts_2dgs(W, H):
        with torch.no_grad():
            meta = tdgs_torch.rasterization_2dgs(
                sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["sh"],
                sc["viewmats"], _window_Ks(sc, W, H), W, H, sh_degree=3,
                rasterizer="packed_inference", device=DEVICE)[-1]
        return torch.diff(meta["isect_offsets"].long())

    dropped = {}
    for fam, counts_fn in (("eval3d", counts_3dgs), ("2dgs", counts_2dgs)):
        W, H, cap, entries, tiles = dense_window(counts_fn)
        Ks = _window_Ks(sc, W, H)
        isect_cap = 1 << (max(entries, 1) * 2 - 1).bit_length()
        kw = dict(sh_degree=3, tile_capacity=cap, isect_capacity=isect_cap, device=DEVICE)
        names = ("means", "quats", "scales", "opacities", "sh") + (
            ("viewmats",) if fam == "eval3d" else ())
        inputs = [sc[k] for k in names]
        if fam == "eval3d":
            def render(route, *x):
                img, alp, meta = tdgs_torch.rasterization(
                    *x[:5], x[5], Ks, W, H, with_eval3d=True,
                    rasterizer="eval3d" if route == "dense" else "eval3d_packed", **kw)
                dropped[route] = int(meta["n_dropped"])
                return img, alp
            n_out = 2
        else:
            def render(route, *x):
                out = tdgs_torch.rasterization_2dgs(
                    *x, sc["viewmats"], Ks, W, H, render_mode="RGB+ED", distloss=True,
                    rasterizer="jax" if route == "dense" else "packed", **kw)
                dropped[route] = int(out[-1]["n_dropped"])
                return out[0], out[1], out[2], out[4], out[5]
            n_out = 4  # colours, alpha, normals, distortion (the median has no gradient)
        res = _dense_pair(render, inputs, n_out)
        d, k = res["dense"], res["kernel"]
        e = dict(fwd=max(_abs_err(a, b) for a, b in zip(d["out"][:3], k["out"][:3])))
        if fam == "2dgs":
            e["dist_rel"] = _rel(d["out"][3], k["out"][3])
            e["median_share"] = float(((d["out"][4] - k["out"][4]).abs() > 1e-4)
                                      .float().mean())
        e["bwd_rel"] = {n: _rel(a, b) for n, a, b in zip(names, d["grads"], k["grads"])}
        errs[fam] = e
        emit(f"parity_dense_reference_{fam}", width=W, height=H, tile_capacity=cap,
             entries=entries, tiles=tiles, largest_tpc_gb=tiles * 256 * cap * 4 / 1e9,
             n_dropped=dropped, max_abs_err=e["fwd"],
             distortion_max_rel_err=e.get("dist_rel"), median_differs_share=e.get("median_share"),
             grad_max_rel_err=e["bwd_rel"], dense_ms=d["ms"], kernel_ms=k["ms"],
             dense_peak_gib=d["peak_gib"], kernel_peak_gib=k["peak_gib"],
             alpha_max=float(k["out"][1].max()))
        bad = [f"outputs {e['fwd']} > {TOL}"] if e["fwd"] > TOL else []
        bad += [f"gradient {n} {v} > {BWD_RTOL}" for n, v in e["bwd_rel"].items()
                if not v <= BWD_RTOL]
        if fam == "2dgs":
            bad += [f"distortion {e['dist_rel']}"] if e["dist_rel"] > DIST_RTOL else []
            bad += [f"median {e['median_share']}"] if e["median_share"] > MEDIAN_SHARE else []
        if float(k["out"][1].max()) < 0.5 or any(dropped.values()):
            bad.append(f"alpha max {float(k['out'][1].max())}, dropped {dropped}")
        if bad:
            raise RuntimeError(f"parity_dense_reference_{fam}: {'; '.join(bad)}")
    return errs


def phase_image_fitting_2dgs(min_iterations=1000):
    """``python -m tdgs_torch.image_fitting --model-type 2dgs`` at the
    example's defaults (128x128, 2000 surfels, 1000 Adam steps) on the card
    in its own process, through the packed surfel path. The loss must fall
    below 0.55 of its start and every step must launch kernels 5, 6 and 3."""
    kernels = (R2.KERNEL_TRAIN, R2.KERNEL_BWD, S.KERNEL)
    cmd = [sys.executable, "-m", "tdgs_torch.image_fitting", "--model-type", "2dgs"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    summary = json.loads(lines[-1]) if out.returncode == 0 and lines else {}
    launches = {k: summary.get("launches", {}).get(k, 0) for k in kernels}
    emit("image_fitting_2dgs", command=" ".join(cmd[1:]), rc=out.returncode,
         process_wall_s=wall, **{k: v for k, v in summary.items() if k != "launches"},
         launches=launches, log_tail=lines[-4:-1],
         stderr_tail=out.stderr[-400:] if out.returncode else "")
    if out.returncode != 0:
        raise RuntimeError(f"image_fitting_2dgs: rc {out.returncode}, {out.stderr[-2000:]}")
    if not summary["final_loss"] < 0.55 * summary["initial_loss"]:
        raise RuntimeError(f"image_fitting_2dgs: loss {summary['initial_loss']} -> "
                           f"{summary['final_loss']}")
    for k in kernels:
        if launches[k] < min_iterations:
            raise RuntimeError(f"image_fitting_2dgs launched {k} {launches[k]} times")
    return launches


# ---------------------------------------------------------------------------
# the sharded path (parallel/): worlds of ranks on the card
# ---------------------------------------------------------------------------

# name → (family, rasterizer, render mode, with the backward, its kernels)
SHARDED_CASES = {
    "3dgs_packed": ("3dgs", "packed", "RGB", True, KERNELS),
    "3dgs_packed_inference": ("3dgs", "packed_inference", "RGB", False, (KERNEL,)),
    "2dgs_packed": ("2dgs", "packed", "RGB+ED", True, (R2.KERNEL_TRAIN, R2.KERNEL_BWD, S.KERNEL)),
    "2dgs_packed_inference": ("2dgs", "packed_inference", "RGB", False, (R2.KERNEL_FWD,)),
    "eval3d": ("eval3d", None, "RGB", True, (E.KERNEL_TRAIN, E.KERNEL_BWD, S.KERNEL)),
    "pallas": ("3dgs", "pallas", "RGB", True, DENSE_KERNELS),
}


def sharded_scene(n, width, height):
    """The bench scene seen by two cameras 0.3 apart along x."""
    sc = bench_scene(n=n)
    f = 1400.0
    viewmats = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    viewmats[1, 0, 3] = 0.3
    sc["viewmats"] = viewmats
    sc["Ks"] = np.tile(np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                                np.float32), (2, 1, 1))
    return sc


def _sharded_outputs(kind, out):
    """(the outputs a loss reads, meta) of a sharded render."""
    if kind == "2dgs":
        return out[:4], out[-1]
    return out[:2], out[-1]


def sharded_parity_rank(names, caps, setup, n_steps):
    """One rank of ``parity_sharded``: each case's sharded render of this
    rank's cameras from its block of the bench scene (forward, and the
    backward of the outputs' means where the case trains), timed by CUDA
    events over ``n_steps`` with its kernels' launches and the bytes it
    hands to collectives; then the single-rank render of the same cameras
    from every gaussian, whose gradients summed over the ranks are held
    against the sharded ones."""
    from tdgs_torch.parallel import comm, make_mesh
    from tdgs_torch.parallel import sharded_render as SR
    from tdgs_torch.utils.depth import rotate

    device, W, H = setup["device"], setup["width"], setup["height"]
    mesh = make_mesh(device=device)
    D, r = mesh.world, mesh.rank
    sc = {k: torch.as_tensor(v, device=mesh.device)
          for k, v in sharded_scene(setup["n"], W, H).items()}
    C, N = sc["viewmats"].shape[0], sc["means"].shape[0]
    c, n = C // D, N // D
    cams, rows = slice(r * c, (r + 1) * c), slice(r * n, (r + 1) * n)
    vm, Ks = sc["viewmats"][cams], sc["Ks"][cams]
    names_in = ("means", "quats", "scales", "opacities", "sh")
    out = {"rank": r, "world": D, "backend": mesh.backend, "cases": {}}
    for name in names:
        kind, rasterizer, mode, train, kernels = SHARDED_CASES[name]
        kw = dict(sh_degree=3, tile_capacity=1024, max_tiles_per_gauss=16, render_mode=mode,
                  isect_capacity=caps.get(name))
        if kind != "eval3d":
            kw["rasterizer"] = rasterizer
        if kind == "2dgs":
            kw["distloss"] = train  # kernel 5's distortion, on both sides
        local = [sc[k][rows].clone().requires_grad_(train) for k in names_in]
        fn = {"3dgs": SR.rasterization_sharded, "2dgs": SR.rasterization_2dgs_sharded,
              "eval3d": SR.rasterization_eval3d_sharded}[kind]

        def step():
            with torch.set_grad_enabled(train):
                outs, meta = _sharded_outputs(kind, fn(*local, vm, Ks, W, H, mesh, **kw))
                grads = (torch.autograd.grad(sum(o.mean() for o in outs), local)
                         if train else None)
            return outs, meta, grads

        step()  # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        comm.reset_exchanged()
        ev = []
        for _ in range(n_steps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            outs, meta, grads = step()
            e1.record()
            ev.append((e0, e1))
        torch.cuda.synchronize()
        launches = {k: _build.LAUNCHES.get(k, 0) for k in kernels}
        exchanged = comm.EXCHANGED["bytes"] / n_steps
        calls = comm.EXCHANGED["calls"] / n_steps
        step_ms = [a.elapsed_time(b) for a, b in ev]

        # the single-rank render of the same cameras, from every gaussian
        full = [sc[k].clone().requires_grad_(train) for k in names_in]
        skw = dict(kw, device=mesh.device)
        with torch.set_grad_enabled(train):
            if kind == "2dgs":
                o = tdgs_torch.rasterization_2dgs(*full, vm, Ks, W, H, **skw)
                souts, smeta = (o[0], o[1], rotate(vm[:, :3, :3], o[2]), o[4]), o[6]
            else:
                o = tdgs_torch.rasterization(*full, vm, Ks, W, H,
                                             with_eval3d=kind == "eval3d", **skw)
                souts, smeta = o[:2], o[2]
            sgrads = (torch.autograd.grad(sum(x.mean() for x in souts), full)
                      if train else None)
        fwd = max(float((a.detach() - b.detach()).abs().max()) for a, b in zip(outs, souts))
        finite = all(bool(torch.isfinite(a).all()) for a in outs)
        bwd_rel = {}
        if train:
            for k, g, sg in zip(names_in, grads, sgrads):
                want = comm.all_reduce_sum(sg)[rows]
                finite = finite and bool(torch.isfinite(g).all())
                bwd_rel[k] = float((g - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        out["cases"][name] = dict(
            step_ms=step_ms, step_ms_mean=float(np.mean(step_ms)), launches=launches,
            exchanged_bytes_per_step=exchanged, collectives_per_step=calls,
            max_abs_err=fwd, max_rel_err=bwd_rel, finite=finite,
            n_dropped=int(meta["n_dropped"].sum()), single_n_dropped=int(smeta["n_dropped"]),
            alpha_mean=float(outs[1].detach().mean()))
    return out


def phase_parity_sharded(n=200_000, n_steps=5):
    """The sharded render (``parallel.sharded_render``) of the bench scene
    (200k gaussians, SH 3, 1920x1080) seen by two cameras, on a world of 2
    ranks sharing the card (gloo, by ``mesh.choose_backend``): 3DGS
    "packed" (forward and backward) and "packed_inference", 2DGS "packed"
    RGB+ED (forward and backward) and "packed_inference", eval3d (forward
    and backward) and "pallas" (forward and backward), so that kernels 1-10
    run through the exchange; each rank held against the single-rank render
    of its camera (TOL, BWD_RTOL, n_dropped equal). Then 3DGS "packed" on a
    world of 1 rank, whose backend is NCCL. Two ranks on one card measure
    the exchange's cost, not scaling."""
    from tdgs_torch.parallel import launch
    from tdgs_torch.parallel.mesh import choose_backend

    t0 = time.perf_counter()
    setup = dict(device=DEVICE, width=WIDTH, height=HEIGHT, n=n)
    sc = to_card(sharded_scene(n, WIDTH, HEIGHT))
    caps = {"pallas": dense_capacity(sc)}
    worlds = {}
    for world, names in ((2, list(SHARDED_CASES)), (1, ["3dgs_packed"])):
        ranks = launch.run(sharded_parity_rank, world, names, caps, setup, n_steps,
                           device=DEVICE, timeout_s=600)
        worlds[world] = ranks
    wall = time.perf_counter() - t0
    launches = {k: 0 for k in KERNELS + DENSE_KERNELS + (R2.KERNEL_FWD, R2.KERNEL_TRAIN,
                                                         R2.KERNEL_BWD, E.KERNEL_TRAIN,
                                                         E.KERNEL_BWD)}
    errs = {k: {"fwd": 0.0, "bwd_rel": 0.0} for k in launches}
    summary = {}
    for world, ranks in worlds.items():
        backend = ranks[0]["backend"]
        want_backend = choose_backend(DEVICE, world)
        for name in ranks[0]["cases"]:
            kind, rasterizer, mode, train, kernels = SHARDED_CASES[name]
            per_rank = [rk["cases"][name] for rk in ranks]
            summary[f"w{world}/{name}"] = dict(
                backend=backend, step_ms=[c["step_ms_mean"] for c in per_rank],
                exchanged_bytes_per_step=[c["exchanged_bytes_per_step"] for c in per_rank],
                collectives_per_step=per_rank[0]["collectives_per_step"],
                max_abs_err=max(c["max_abs_err"] for c in per_rank),
                max_rel_err=max([max(c["max_rel_err"].values(), default=0.0)
                                 for c in per_rank]),
                n_dropped=[c["n_dropped"] for c in per_rank],
                single_n_dropped=[c["single_n_dropped"] for c in per_rank],
                alpha_mean=[c["alpha_mean"] for c in per_rank],
                launches=[c["launches"] for c in per_rank])
            for c in per_rank:
                if not c["finite"]:
                    raise RuntimeError(f"parity_sharded {name}: non-finite output or gradient")
                if c["n_dropped"] != c["single_n_dropped"]:
                    raise RuntimeError(f"parity_sharded {name}: n_dropped {c['n_dropped']} "
                                       f"!= single-rank {c['single_n_dropped']}")
                if not c["max_abs_err"] <= TOL:
                    raise RuntimeError(f"parity_sharded {name}: max abs err "
                                       f"{c['max_abs_err']} > {TOL}")
                worst = max(c["max_rel_err"].values(), default=0.0)
                if not worst <= BWD_RTOL:
                    raise RuntimeError(f"parity_sharded {name}: max rel err {worst} > "
                                       f"{BWD_RTOL} ({c['max_rel_err']})")
                for k in kernels:
                    if c["launches"][k] < n_steps:
                        raise RuntimeError(f"parity_sharded {name} launched {k} "
                                           f"{c['launches'][k]} < {n_steps} times")
                    launches[k] += c["launches"][k]
                    errs[k]["fwd"] = max(errs[k]["fwd"], c["max_abs_err"])
                    errs[k]["bwd_rel"] = max(errs[k]["bwd_rel"], worst)
            if backend != want_backend:
                raise RuntimeError(f"parity_sharded: world of {world} chose {backend}, "
                                   f"the rule says {want_backend}")
    emit("parity_sharded", width=WIDTH, height=HEIGHT, n_gaussians=n, cameras=2,
         steps=n_steps, wall_s=wall, tol=TOL, bwd_rtol=BWD_RTOL, cases=summary,
         launches=launches)
    return launches, errs


def trainer_sharded_config(root, n_steps, sharded, batch_size=2):
    """The trainer cell's Runner (DefaultStrategy refining at 40 and 80) at
    batch 2, sharded or on one device, the sharded checkpoint container."""
    strategy = DefaultStrategy(refine_start_iter=20, refine_every=40,
                               refine_stop_iter=1000, reset_every=10_000)
    return Config(data_dir=root, result_dir=f"{root}/results_trainer_sharded_{int(sharded)}",
                  data_factor=1, max_steps=n_steps, eval_steps=[], save_steps=[], sh_degree=3,
                  sh_degree_interval=20, rasterizer="packed", tb_every=1, strategy=strategy,
                  batch_size=batch_size, sharded=sharded, ckpt_format="orbax")


def trees_equal(a, b) -> bool:
    """Nested dicts of arrays and builtins equal bit for bit."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


def trainer_sharded_rank(args):
    """One rank of ``trainer_sharded``, started by torch.distributed.run:
    the sharded Runner trains, evaluates, saves the sharded checkpoint, and
    a fresh sharded Runner loads it; writes rank{r}.json to args["out"]."""
    from tdgs_torch.parallel import comm
    from tdgs_torch.parallel.mesh import initialize_multihost

    device = args["device"]
    backend = initialize_multihost(device)
    cfg = trainer_sharded_config(args["root"], args["n_steps"], True)
    runner = Runner(cfg, device=device)
    rank = runner.mesh.rank
    sync = torch.cuda.synchronize if runner.device.type == "cuda" else (lambda: None)
    _build.reset_launches()
    comm.reset_exchanged()
    sync()
    t0 = time.perf_counter()
    out = runner.train()
    sync()
    wall = time.perf_counter() - t0
    launches = {k: _build.LAUNCHES.get(k, 0) for k in KERNELS}
    exchanged = comm.EXCHANGED["bytes"] / args["n_steps"]
    rgb = [json.loads(line)["train/rgbloss"]
           for line in open(os.path.join(cfg.result_dir, "metrics.jsonl"))] if rank == 0 else []
    _build.reset_launches()
    stats = runner.eval(args["n_steps"])
    eval_launches = _build.LAUNCHES.get(KERNEL, 0)
    t1 = time.perf_counter()
    path = runner.save_checkpoint(args["n_steps"])
    save_s = time.perf_counter() - t1
    saved = runner.state_numpy(args["n_steps"])
    runner.trainset.close()
    fresh = Runner(cfg, device=device)
    step = fresh.load_checkpoint(path)
    loaded = fresh.state_numpy(args["n_steps"])
    fresh.trainset.close()
    same = step == args["n_steps"] and trees_equal(saved, loaded)
    ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(path) for f in fs)
    rec = dict(rank=rank, world=runner.mesh.world, backend=backend, wall_s=wall,
               steps_per_s=args["n_steps"] / wall, history=out["history"], rgbloss=rgb,
               launches=launches, exchanged_bytes_per_step=exchanged,
               eval_psnr=stats["psnr"], eval_ssim=stats["ssim"], eval_num_gs=stats["num_GS"],
               eval_launches=eval_launches, refines=runner.refines, capacity=runner.capacity,
               ckpt_path=path, ckpt_bytes=ckpt_bytes, ckpt_save_s=save_s,
               ckpt_roundtrip_bitwise=bool(same),
               all_finite=all(bool(torch.isfinite(v).all()) for v in runner.splats.values()))
    with open(os.path.join(args["out"], f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    torch.distributed.destroy_process_group()
    return 0


def phase_trainer_sharded(root, n_steps=100):
    """The trainer cell's rich scene (1236x822, 40k SfM points, capacity
    160k) trained gaussian-sharded (``Config.sharded``) at batch 2 for
    ``n_steps`` on two ranks sharing the card, started through
    ``python -m torch.distributed.run --nproc-per-node 2``; the first
    step's loss against the single-rank Runner at batch 2 (|Δ| ≤ 2e-4, the
    JAX package's bound for its sharded step), the RGB loss dropping, a
    finite eval, and the sharded checkpoint saved and read back bitwise by
    a new sharded Runner. The single-rank Runner trains the same
    ``n_steps`` first, for its steps/s and eval beside the sharded ones."""
    single = Runner(trainer_sharded_config(root, n_steps, False), device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist_single = single.train()["history"]
    torch.cuda.synchronize()
    wall_single = time.perf_counter() - t0
    stats_single = single.eval(n_steps)
    single.close()
    loss_single = hist_single[0]["loss"]
    out_dir = tempfile.mkdtemp(prefix="tdgs_trainer_sharded_")
    args = dict(root=root, n_steps=n_steps, device=DEVICE, out=out_dir)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         "2", os.path.abspath(__file__), "--trainer-sharded-rank", json.dumps(args)],
        capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"trainer_sharded: torch.distributed.run exited {proc.returncode}:"
                           f"\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    ranks = [json.load(open(os.path.join(out_dir, f"rank{r}.json"))) for r in range(2)]
    shutil.rmtree(out_dir, ignore_errors=True)
    r0 = ranks[0]
    hist, rgb = r0["history"], r0["rgbloss"]
    launches = {k: sum(rk["launches"][k] for rk in ranks) for k in KERNELS}
    delta = abs(hist[0]["loss"] - loss_single)
    emit("trainer_sharded", ranks=2, backend=r0["backend"], steps=n_steps,
         wall_s_with_launch=wall, steps_per_s=r0["steps_per_s"],
         steps_per_s_ranks=[rk["steps_per_s"] for rk in ranks], capacity=r0["capacity"],
         loss_first=hist[0], loss_first_single_rank=loss_single, loss_first_delta=delta,
         loss_last=hist[-1], rgbloss_first=rgb[0], rgbloss_last=rgb[-1],
         single_rank=dict(steps_per_s=n_steps / wall_single, loss_last=hist_single[-1],
                          eval_psnr=stats_single["psnr"], eval_ssim=stats_single["ssim"],
                          eval_num_gs=stats_single["num_GS"]),
         refines=r0["refines"], launches=launches,
         exchanged_bytes_per_step=[rk["exchanged_bytes_per_step"] for rk in ranks],
         eval_psnr=r0["eval_psnr"], eval_ssim=r0["eval_ssim"], eval_num_gs=r0["eval_num_gs"],
         eval_launches=[rk["eval_launches"] for rk in ranks], ckpt_bytes=r0["ckpt_bytes"],
         ckpt_save_s=r0["ckpt_save_s"],
         ckpt_roundtrip_bitwise=[rk["ckpt_roundtrip_bitwise"] for rk in ranks],
         all_finite=all(rk["all_finite"] for rk in ranks))
    if not delta <= 2e-4:
        raise RuntimeError(f"trainer_sharded: first-step loss {hist[0]['loss']} vs single-rank "
                           f"{loss_single}: |Δ| {delta} > 2e-4")
    if not rgb[-1] < rgb[0]:
        raise RuntimeError(f"trainer_sharded: RGB loss did not drop {rgb[0]} -> {rgb[-1]}")
    if not (np.isfinite(r0["eval_psnr"]) and all(rk["all_finite"] for rk in ranks)):
        raise RuntimeError("trainer_sharded: non-finite eval or params")
    if not all(rk["ckpt_roundtrip_bitwise"] for rk in ranks):
        raise RuntimeError("trainer_sharded: the sharded checkpoint did not read back bitwise")
    refined = [r["step"] for r in r0["refines"]]
    if 40 not in refined or 80 not in refined:
        raise RuntimeError(f"trainer_sharded: the strategy refined at {refined}, not 40 and 80")
    for k in KERNELS:
        if launches[k] < n_steps:
            raise RuntimeError(f"trainer_sharded launched {k} {launches[k]} < {n_steps} times")
    return launches


# ---------------------------------------------------------------------------
# the viewer (tdgs_torch.viewer, the Runner's live view, simple_viewer), the
# clustering command line, and the surfel golden
# ---------------------------------------------------------------------------

VIEWER_FAMILIES = {"3dgs": KERNEL, "2dgs": R2.KERNEL_FWD, "3dgut": E.KERNEL_FWD}
JPEG_MAE = 3.0  # served JPEG against the frame, mean |Δ| in 8-bit levels


def viewer_splats(sc):
    """A scene's raw splat dict (log scales, logit opacities, sh0/shN)."""
    return dict(means=sc["means"], quats=sc["quats"], scales=torch.log(sc["scales"]),
                opacities=torch.logit(sc["opacities"]), sh0=sc["sh"][:, :1],
                shN=sc["sh"][:, 1:])


def viewer_poses(n, seed=5):
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


def http_get(url, timeout=120):
    """(status, body, ms) of a GET, on the host clock."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            code, body = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read()
    return code, body, (time.perf_counter() - t0) * 1e3


def decode_jpeg(body):
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


def phase_viewer(bench, n_requests=20):
    """Each family (3DGS kernel 1, 2DGS kernel 4, 3DGUT kernel 7) served at
    1920x1080 from the bench scene by a ``ViewerServer`` on 127.0.0.1 over
    ``make_splat_render_fn``: the page once, rgb/depth/alpha once each to
    warm up, then ``n_requests`` rgb frames through ``?vm=`` (the bench view
    and poses near it). Reports request ms (host clock, the JPEG encode
    included), the render's ms (CUDA events around the rasterization call
    inside ``render_fn``), ``render_fn``'s host ms (the render, the copy to
    the host and the uint8 conversion), the JPEG encode's host ms, JPEG
    bytes and the kernel's launches. Fails on a 500, unless the bench
    view's frame is within 1 level of a direct ``rasterization`` call on
    the same inputs after the same conversion, unless the served JPEG of it
    decodes within 3 levels (mean) of that frame, or unless the kernel
    launched once a request."""
    from tdgs_torch.viewer import server as V

    raw = viewer_splats(bench)
    K0 = bench["Ks"][0].cpu().numpy()
    poses = viewer_poses(n_requests)
    out = {}
    for family, kernel in VIEWER_FAMILIES.items():
        render_ms, host_ms = [], []
        direct = {"rasterization": V.rasterization, "rasterization_2dgs": V.rasterization_2dgs}

        def timed(fn):
            def call(*a, **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                res = fn(*a, **k)
                end.record()
                render_ms.append((start, end))
                return res
            return call

        V.rasterization = timed(direct["rasterization"])
        V.rasterization_2dgs = timed(direct["rasterization_2dgs"])
        try:
            fn = V.make_splat_render_fn(raw, model_type=family, device=DEVICE)

            def render_fn(*a):
                t0 = time.perf_counter()
                img = fn(*a)
                host_ms.append((time.perf_counter() - t0) * 1e3)
                return img

            server = V.ViewerServer(render_fn, width=WIDTH, height=HEIGHT, port=0,
                                    host="127.0.0.1", focal=float(K0[0, 0]))
            th = server.start()
            base = f"http://127.0.0.1:{server.port}"
            try:
                codes = [http_get(base + "/")[0]]
                for mode in ("rgb", "depth", "alpha"):
                    codes.append(http_get(f"{base}/render?w={WIDTH}&h={HEIGHT}&mode={mode}")[0])
                torch.cuda.synchronize()
                _build.reset_launches()
                render_ms.clear()
                host_ms.clear()
                req_ms, sizes, bodies = [], [], []
                for vm in poses:
                    q = ",".join(repr(float(x)) for x in vm.reshape(-1))
                    code, body, ms = http_get(f"{base}/render?w={WIDTH}&h={HEIGHT}&mode=rgb"
                                              f"&vm={q}")
                    codes.append(code)
                    req_ms.append(ms)
                    sizes.append(len(body))
                    bodies.append(body)
                launches = _build.LAUNCHES.get(kernel, 0)
                dev_ms = [s.elapsed_time(e) for s, e in render_ms]
                # the bench view's frame: render_fn against a direct call
                st = V.RenderTabState(render_mode="rgb")
                frame = fn(poses[0], server.intrinsics(WIDTH, HEIGHT), WIDTH, HEIGHT, st)
            finally:
                server.shutdown()
                th.join(timeout=30)
        finally:
            V.rasterization, V.rasterization_2dgs = direct.values()
        rast = V.viewer_rasterizer(family, torch.device(DEVICE))
        args = (bench["means"], bench["quats"], torch.exp(raw["scales"]),
                torch.sigmoid(raw["opacities"]), bench["sh"],
                torch.as_tensor(poses[0], device=DEVICE)[None],
                torch.as_tensor(server.intrinsics(WIDTH, HEIGHT), device=DEVICE)[None],
                WIDTH, HEIGHT)
        kw = dict(sh_degree=3, backgrounds=torch.zeros((1, 3), device=DEVICE),
                  rasterizer=rast, device=DEVICE)
        with torch.no_grad():
            if family == "2dgs":
                res = tdgs_torch.rasterization_2dgs(*args, **kw)
            else:
                res = tdgs_torch.rasterization(*args, **kw)
        want = V.frame_to_uint8(res[0], res[1], "rgb")
        level = int(np.abs(frame.astype(np.int16) - want.astype(np.int16)).max())
        served = decode_jpeg(bodies[0])
        jpeg_mae = float(np.abs(served.astype(np.float32) - frame).mean())
        # the same frame at PIL's default chroma subsampling (4:2:0), for the record
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, "JPEG", quality=90)
        jpeg_mae_420 = float(np.abs(decode_jpeg(buf.getvalue()).astype(np.float32)
                                    - frame).mean())
        t0 = time.perf_counter()
        for _ in range(5):
            V.encode_jpeg(frame)
        jpeg_ms = (time.perf_counter() - t0) / 5 * 1e3
        out[family] = dict(
            kernel=kernel, rasterizer=rast, requests=len(poses),
            request_ms_median=float(np.median(req_ms)),
            request_ms_p90=float(np.percentile(req_ms, 90)),
            render_ms_median=float(np.median(dev_ms)),
            render_fn_host_ms_median=float(np.median(host_ms)),
            jpeg_encode_ms=jpeg_ms, jpeg_bytes_median=int(np.median(sizes)),
            launches=launches, max_level_vs_direct=level, jpeg_mae_levels=jpeg_mae,
            jpeg_mae_levels_420=jpeg_mae_420, jpeg_bytes_420=len(buf.getvalue()),
            codes=sorted(set(codes)), frame_mean=float(frame.mean()))
        emit(f"viewer_{family}", **out[family])
        bad = [c for c in codes if c != 200]
        if bad:
            raise RuntimeError(f"viewer {family}: HTTP {bad}")
        if level > 1:
            raise RuntimeError(f"viewer {family}: frame {level} levels off the direct render")
        if jpeg_mae > JPEG_MAE:
            raise RuntimeError(f"viewer {family}: JPEG {jpeg_mae:.2f} levels off its frame")
        if launches < len(poses):
            raise RuntimeError(f"viewer {family}: {kernel} launched {launches} times "
                               f"for {len(poses)} requests")
        if frame.mean() <= 1.0:
            raise RuntimeError(f"viewer {family}: the bench view renders black")
    return out


def phase_trainer_viewer(root, n_steps=100, width=960, height=540):
    """The trainer cell with the live viewer on (``disable_viewer=False``,
    a free port): a client thread fetches ``/render`` at 960x540 in a loop
    while it trains ``n_steps``. Reports steps/s, frames served and their
    request ms, and kernels 1-3's launches (kernel 1's include the frames).
    Fails unless the RGB loss drops, every frame is a JPEG with no 500, and
    after training ``_viewer_render_fn`` gives a finite frame in every mode
    for 3DGS (kernel 1) and for the same splats as 2DGS surfels (kernel 4).
    Then the PLY and .splat exports, and the PLY served once by ``python -m
    tdgs_torch.simple_viewer --model-type 3dgut`` (kernel 7) as a process
    of its own: one frame, then it is killed."""
    import dataclasses
    import threading

    from tdgs_torch.viewer import RenderTabState

    cfg = cell_config(root, "trainer_viewer", n_steps, disable_viewer=False, viewer_port=0)
    runner = Runner(cfg, device=DEVICE)
    port = runner.viewer.port
    frames, codes, ms = [], [], []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            code, body, t = http_get(f"http://127.0.0.1:{port}/render?w={width}&h={height}"
                                     "&mode=rgb")
            codes.append(code)
            frames.append(body[:2] == b"\xff\xd8")
            ms.append(t)

    th = threading.Thread(target=client, daemon=True)
    _build.reset_launches()
    th.start()
    try:
        steps_per_s, _, hist = train_timed(runner, n_steps)
        n_during = len(frames)
    finally:
        stop.set()
        th.join(timeout=120)
    launches = {k: _build.LAUNCHES.get(k, 0) for k in KERNELS}
    recs = train_records(cfg.result_dir)
    rgb_first, rgb_last = recs[0]["train/rgbloss"], recs[-1]["train/rgbloss"]
    d = runner.trainset[0]
    vm, K = np.asarray(d["viewmat"]), np.asarray(d["K"])
    H, W = d["image"].shape[:2]
    finite = {}
    for family in ("3dgs", "2dgs"):
        cfg0 = runner.cfg
        if family == "2dgs":
            runner.cfg = dataclasses.replace(cfg0, model_type="2dgs")
        _build.reset_launches()
        try:
            for mode in ("rgb", "depth", "alpha"):
                img = runner._viewer_render_fn(vm, K, W, H, RenderTabState(render_mode=mode))
                finite[f"{family}_{mode}"] = bool(img.shape == (H, W, 3) and img.max() > 0)
        finally:
            runner.cfg = cfg0
        finite[f"{family}_launches"] = _build.LAUNCHES.get(VIEWER_FAMILIES[family], 0)
    ply = runner.export_ply(n_steps)
    splat = runner.export_ply(n_steps, format="splat")
    sizes = {"ply_bytes": os.path.getsize(ply), "splat_bytes": os.path.getsize(splat)}
    runner.close()

    proc = subprocess.Popen(
        [sys.executable, "-m", "tdgs_torch.simple_viewer", "--ply", ply, "--model-type",
         "3dgut", "--port", "0", "--host", "127.0.0.1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        line, log = "", []
        while "viewer at" not in line:
            line = proc.stdout.readline()
            log.append(line)
            if not line:
                raise RuntimeError(f"simple_viewer exited: {''.join(log)[-2000:]}")
        cli_code, cli_body, cli_ms = http_get(
            f"http://127.0.0.1:{int(line.rsplit(':', 1)[1])}/render?w={width}&h={height}"
            "&dist=4")
    finally:
        proc.kill()
        proc.wait(timeout=60)
    emit("trainer_viewer", steps=n_steps, steps_per_s=steps_per_s, frames=len(frames),
         frames_during_training=n_during, frame_ms_median=float(np.median(ms)) if ms else None,
         frame_ms_p90=float(np.percentile(ms, 90)) if ms else None,
         codes=sorted(set(codes)), launches=launches, rgbloss_first=rgb_first,
         rgbloss_last=rgb_last, loss_history=hist, live_frames=finite, **sizes,
         simple_viewer_3dgut=dict(code=cli_code, jpeg=cli_body[:2] == b"\xff\xd8",
                                  ms=cli_ms))
    failures = [
        (rgb_last < rgb_first, f"RGB loss {rgb_first} -> {rgb_last}"),
        (n_during > 0, "no frame served during training"),
        (set(codes) == {200} and all(frames), f"HTTP {sorted(set(codes))}, non-JPEG frames"),
        (all(v for k, v in finite.items() if not k.endswith("launches")),
         f"live frames {finite}"),
        (finite["3dgs_launches"] >= 3 and finite["2dgs_launches"] >= 3,
         f"live frames' launches {finite}"),
        (cli_code == 200 and cli_body[:2] == b"\xff\xd8", f"simple_viewer HTTP {cli_code}"),
    ] + [(launches[k] >= n_steps, f"{k} launched {launches[k]} times") for k in KERNELS]
    bad = [msg for ok, msg in failures if not ok]
    if bad:
        raise RuntimeError(f"trainer_viewer: {'; '.join(bad)}")
    return launches, steps_per_s


def phase_load_identity_encodings(root, summary, min_cluster=100):
    """``python -m tdgs_torch.load_identity_encodings`` (its ``main``) on the
    chain's checkpoint and scene, the K-means at its defaults, the view
    read in the chain's frame (``--no-normalize-world-space``) and taken
    from the side of the row (``--view-index 6``: the first views look down
    the row, where the front dominoes hide the rear ones' masks). Held to
    the chain's bar: one cluster a domino, each of at least
    ``min_cluster`` gaussians (a seventh of the 700 a domino is drawn
    with); kernel 1 renders the identity map at D = 16."""
    from tdgs_torch.load_identity_encodings import build_parser, run

    out = f"{root}/cluster_groups_cli.npz"
    args = build_parser().parse_args([
        "--ckpt", f"{root}/out/ckpts/ckpt_{summary['steps']}.pkl", "--data-dir",
        f"{root}/data", "--out", out, "--view-index", "6", "--no-normalize-world-space",
        "--device", DEVICE])
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = run(args)
    wall = time.perf_counter() - t0
    launches = _build.LAUNCHES.get(KERNEL, 0)
    emit("load_identity_encodings", wall_s=wall, kernel_launches=launches, **res)
    n = summary["n_dominoes"]
    if (res["clusters"] != n or min(res["cluster_sizes"], default=0) < min_cluster
            or launches < 1):
        raise RuntimeError(f"load_identity_encodings: clusters {res['cluster_sizes']} of {n} "
                           f"(each needs {min_cluster}), kernel 1 launched {launches} times")
    return res


def phase_golden_2dgs(bench, tile_capacity=4096):
    """Kernel 4's bench frame ("RGB", the surfels' SH colours) against
    ``compose_reference_2dgs_f64`` over the same packed stream, in dB
    (colours and alpha), held to 40 dB as ``kernel_vs_oracle_psnr`` is;
    ``tile_capacity`` keeps every entry of the stream's fullest tile."""
    from tdgs_torch.rally_e2e import psnr_np
    from tdgs_torch.utils.golden import compose_reference_2dgs_f64

    with torch.no_grad():
        out = tdgs_torch.rasterization_2dgs(
            bench["means"], bench["quats"], bench["scales"], bench["opacities"], bench["sh"],
            bench["viewmats"], bench["Ks"], WIDTH, HEIGHT, sh_degree=3,
            tile_capacity=tile_capacity, max_tiles_per_gauss=16,
            rasterizer="packed_inference", device=DEVICE)
        meta = out[6]
        cols = _colors_per_camera(bench["sh"], 3, bench["means"], bench["viewmats"],
                                  meta["radii"])
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    offsets = host(meta["isect_offsets"])
    fullest = int(np.diff(offsets).max())
    t0 = time.perf_counter()
    img, alpha = compose_reference_2dgs_f64(
        offsets, host(meta["flatten_ids"]), host(meta["means2d"]).reshape(-1, 2),
        host(meta["ray_transforms"]).reshape(-1, 3, 3), host(cols).reshape(-1, 3),
        host(meta["opacities"]).reshape(-1), WIDTH, HEIGHT, 16, meta["tile_width"],
        meta["tile_height"], n_isects=int(meta["n_isects"]))
    oracle_s = time.perf_counter() - t0
    psnr = psnr_np(np.clip(host(out[0][0]), 0, 1), np.clip(img, 0, 1))
    psnr_alpha = psnr_np(host(out[1][0, ..., 0]), alpha)
    emit("golden_2dgs", psnr=psnr, psnr_alpha=psnr_alpha, n_isects=int(meta["n_isects"]),
         fullest_tile=fullest, tile_capacity=tile_capacity, oracle_s=oracle_s)
    if fullest > tile_capacity:
        raise RuntimeError(f"golden_2dgs: a tile holds {fullest} > {tile_capacity} entries")
    if psnr < 40.0 or psnr_alpha < 40.0:
        raise RuntimeError(f"golden_2dgs: kernel 4 vs float64 {psnr:.2f} dB "
                           f"(alpha {psnr_alpha:.2f}) < 40")
    return psnr


def main():
    if sys.argv[1:2] == ["--trainer-sharded-rank"]:
        # one rank of phase_trainer_sharded, under torch.distributed.run
        return trainer_sharded_rank(json.loads(sys.argv[2]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    build_s = _build.build()
    ptxas = {n: [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]
             for n, log in _build.BUILD_LOGS.items()}
    emit("build", seconds=build_s, kernels=_build.kernel_names(), ptxas=ptxas)

    bench = to_card(bench_scene())
    rally = to_card(rally_scene())
    heavy = to_card(bench_scene(n=60_000, seed=1, scale_range=(0.05, 0.12)))
    max_err = phase_parity(bench, rally, heavy)

    rally_launches, rally_args, rally_bg = phase_rally(rally)
    k_rally = measure_kernel(rally_args, backgrounds=rally_bg)
    emit("kernel_rally_shape", **k_rally)
    k_adam = dict(all_visible=measure_adam(), half_visible=measure_adam(visible=0.5),
                  dense_grads=measure_adam(sh_slices=False))
    emit("kernel_adam", **k_adam)
    k_noise = measure_mcmc_noise()
    emit("kernel_mcmc_noise", **k_noise)
    k_bench, bench_launches = phase_bench(bench)

    cap = bench_capacity(bench)
    train_errs, train_inputs = phase_train_parity(bench, heavy, cap)
    train_launches = phase_render_train(bench, cap)
    root = tempfile.mkdtemp(prefix="tdgs_rich_scene_")
    try:
        t0 = time.perf_counter()
        gt = make_rich_scene(root, device=DEVICE)
        scene_s = time.perf_counter() - t0
        trainer_launches, trainer_eval, trainer_rate = phase_trainer(root, scene_s)
        trainer_viewer_launches, trainer_viewer_rate = phase_trainer_viewer(root)
        emit("trainer_viewer_vs_trainer", trainer_steps_per_s=trainer_rate,
             trainer_viewer_steps_per_s=trainer_viewer_rate,
             ratio=trainer_viewer_rate / trainer_rate)
        k_train = measure_train_kernels(train_inputs)

        cap_2dgs = bench_capacity_2dgs(bench)
        errs_2dgs, par_rgb, par_ed = phase_parity_2dgs(bench, heavy, cap_2dgs)
        render_2dgs_launches = phase_bench_render_2dgs(bench, cap_2dgs)
        train_2dgs_launches = phase_render_train_2dgs(bench, cap_2dgs)
        trainer_2dgs_launches, trainer_2dgs_eval, _ = phase_trainer(root, scene_s, "2dgs")

        # the eval3d tiling of the bench render is the 3DGS one: same capacity
        errs_e3, par_e3 = phase_parity_eval3d(bench, heavy, cap)
        render_e3_launches = phase_bench_render_eval3d(bench, cap)
        train_e3_launches = phase_render_train_eval3d(bench, cap)
        trainer_e3_launches, trainer_e3_eval, _ = phase_trainer(root, scene_s, "3dgut")
        phase_cli_3dgut(root)

        cap_dense = dense_capacity(bench)
        errs_dense, par_dense, par_fitting = phase_parity_dense(bench, heavy, cap_dense)
        render_dense_launches = phase_bench_render_pallas(bench, cap_dense)
        train_dense_launches = phase_render_train(bench, cap_dense, rasterizer="pallas")
        trainer_dense_launches, _, _ = phase_trainer(root, scene_s, rasterizer="pallas")
        fitting_launches = phase_image_fitting()

        phase_depth_scene(root, gt)
        depth_runner, depth_launches, depth_eval = phase_trainer_depth(root)
        errs_depth, k_depth = phase_parity_depth(depth_runner)
        phase_render_traj(depth_runner)
        depth_runner.close()
        phase_trainer_depth_sparse(root)
        err_cameras = phase_camera_models(bench)

        aux_launches = phase_trainer_aux(root, scene_s)
        phase_trainer_aux_pose_lr(root)
        pose_3dgut_launches = phase_trainer_aux(root, scene_s, "3dgut")
        trainer_sharded_launches = phase_trainer_sharded(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sharded_launches, sharded_errs = phase_parity_sharded()
    errs_ref = phase_parity_dense_reference(bench)
    viewer = phase_viewer(bench)
    golden_2dgs = phase_golden_2dgs(bench)
    fitting_2dgs_launches = phase_image_fitting_2dgs()
    root_e2e = tempfile.mkdtemp(prefix="tdgs_rally_e2e_")
    try:
        e2e, e2e_launches = phase_rally_e2e(root_e2e)
        ident, k_ident, err_e2e, k_e2e = phase_parity_identity(root_e2e, e2e)
        phase_seg_step(root_e2e, e2e)
        phase_load_identity_encodings(root_e2e, e2e)
    finally:
        shutil.rmtree(root_e2e, ignore_errors=True)
    k_eval3d, seg_eval3d = measure_kernels_eval3d(par_e3)
    k_dense, k_fitting = measure_kernels_dense(par_dense, par_fitting)
    timings = dict(k_train, **measure_kernels_2dgs(par_rgb, par_ed), **k_eval3d, **k_dense)
    timings[A.KERNEL] = dict(k_adam["all_visible"], library_ms=None)
    timings[N.KERNEL] = dict(k_noise, library_ms=None)
    fitting_shape = {name: {f"image_fitting_{k}": t[k]
                            for k in ("ms", "device_graph_ms", "plain_ms", "bound_ms",
                                      "blocks_a_tile")}
                     for name, t in k_fitting.items()}
    # the chain's launches and the D = 16 identity render's times (kernels 1,
    # 2, 3), kernel 1's inference call at the chain's rally frame
    timed = ("ms", "device_graph_ms", "plain_ms", "bound_ms", "bound_by")
    e2e_fields = {name: dict(rally_e2e_launches=e2e_launches[name],
                             **{f"identity_d16_{k}": k_ident[name][k] for k in timed})
                  for name in KERNELS}
    e2e_fields[KERNEL].update(identity_d16_max_abs_err=ident["fwd"],
                              rally_e2e_2048_max_abs_err=err_e2e,
                              **{f"rally_e2e_2048_{k}": k_e2e[k] for k in timed})
    e2e_fields[KERNEL_BWD].update(identity_d16_max_rel_err=ident["bwd_rel"])
    e2e_fields[S.KERNEL].update(identity_d16_max_rel_err=ident["seg_rel"],
                                identity_d16_library_ms=k_ident[S.KERNEL]["library_ms"])
    # the depth path: its launches (trainer_depth) and kernels 1-3 at D = 4
    # on its first training view ("RGB+ED")
    for name in KERNELS:
        e2e_fields[name].update(trainer_depth_launches=depth_launches[name],
                                **{f"depth_d4_{k}": k_depth[name][k] for k in timed})
    e2e_fields[KERNEL].update(depth_d4_max_abs_err=errs_depth["fwd"],
                              trainer_depth_eval_launches=depth_eval,
                              camera_models_max_abs_err=err_cameras)
    e2e_fields[KERNEL_BWD].update(depth_d4_max_rel_err=errs_depth["bwd_rel"])
    e2e_fields[S.KERNEL].update(depth_d4_max_rel_err=errs_depth["seg_rel"],
                                depth_d4_library_ms=k_depth[S.KERNEL]["library_ms"],
                                depth_d4_library_graph_ms=k_depth[S.KERNEL]["library_graph_ms"])
    # the optional modules' paths (trainer_aux: kernels 1-3; trainer_3dgut_pose:
    # 7, 8, 3; image_fitting_2dgs: 5, 6, 3) and the dense references of 5-8
    for name in KERNELS:
        e2e_fields[name]["trainer_aux_launches"] = aux_launches[name]
    e2e_fields[S.KERNEL].update(
        trainer_3dgut_pose_launches=pose_3dgut_launches[S.KERNEL],
        image_fitting_2dgs_launches=fitting_2dgs_launches[S.KERNEL])
    ref_e3, ref_2d = errs_ref["eval3d"], errs_ref["2dgs"]
    new_fields = {
        E.KERNEL_FWD: dict(trainer_3dgut_pose_launches=pose_3dgut_launches[E.KERNEL_TRAIN],
                           dense_reference_max_abs_err=ref_e3["fwd"]),
        E.KERNEL_BWD: dict(trainer_3dgut_pose_launches=pose_3dgut_launches[E.KERNEL_BWD],
                           dense_reference_max_rel_err=max(ref_e3["bwd_rel"].values()),
                           dense_reference_viewmats_rel_err=ref_e3["bwd_rel"]["viewmats"]),
        R2.KERNEL_TRAIN: dict(image_fitting_2dgs_launches=fitting_2dgs_launches[R2.KERNEL_TRAIN],
                              dense_reference_max_abs_err=ref_2d["fwd"],
                              dense_reference_distortion_max_rel_err=ref_2d["dist_rel"]),
        R2.KERNEL_BWD: dict(image_fitting_2dgs_launches=fitting_2dgs_launches[R2.KERNEL_BWD],
                            dense_reference_max_rel_err=max(ref_2d["bwd_rel"].values())),
    }

    # the sharded path (parity_sharded: every kernel through the exchange;
    # trainer_sharded: kernels 1-3), held against the single-rank render
    for name, n in sharded_launches.items():
        fields = new_fields.setdefault(name, {})
        fields.update(parity_sharded_launches=n,
                      parity_sharded_max_abs_err=sharded_errs[name]["fwd"])
        if sharded_errs[name]["bwd_rel"]:
            fields["parity_sharded_max_rel_err"] = sharded_errs[name]["bwd_rel"]
    for name in KERNELS:
        new_fields[name]["trainer_sharded_launches"] = trainer_sharded_launches[name]
    # the viewer (kernels 1, 4, 7: 20 requests at 1080p each) and the trainer
    # with the live viewer on (kernels 1-3; kernel 1's count holds the frames)
    for family, v in viewer.items():
        new_fields.setdefault(v["kernel"], {}).update(
            viewer_launches=v["launches"], viewer_ms=v["render_ms_median"],
            viewer_request_ms=v["request_ms_median"])
    new_fields[R2.KERNEL_FWD]["golden_2dgs_psnr"] = golden_2dgs
    for name in KERNELS:
        new_fields[name]["trainer_viewer_launches"] = trainer_viewer_launches[name]

    # name: (source, TPU kernel, launches on the main path (kernels 1-3 in
    # render_train, 4 in bench_render_2dgs, 5 and 6 in render_train_2dgs, 7
    # in bench_render_eval3d, 8 in render_train_eval3d, 9 and 10 in
    # render_train_pallas, Adam in trainer, the MCMC noise in trainer_3dgut),
    # the error and the tolerance it is held to, the other paths' launches)
    pallas_2dgs = "tdgs/ops/rasterize_2dgs_pallas.py"
    pallas_e3 = "tdgs/ops/rasterize_eval3d_pallas.py"
    table = {
        KERNEL: ("rasterize_packed_fwd.cu", "tdgs/ops/rasterize_pallas_packed.py:322",
                 train_launches[KERNEL],
                 dict(max_abs_err=max(max_err, train_errs["fwd"]), abs_tol=TOL),
                 dict(bench_render_launches=bench_launches,
                      trainer_launches=trainer_launches[KERNEL],
                      trainer_eval_launches=trainer_eval, rally_launches=rally_launches,
                      rally_ms=k_rally["ms"], rally_device_graph_ms=k_rally["device_graph_ms"],
                      rally_plain_ms=k_rally["plain_ms"], rally_bound_ms=k_rally["bound_ms"],
                      bench_render_ms=k_bench["ms"],
                      bench_render_device_graph_ms=k_bench["device_graph_ms"],
                      **e2e_fields[KERNEL])),
        KERNEL_BWD: ("rasterize_packed_bwd.cu", "tdgs/ops/rasterize_pallas_packed.py:645",
                     train_launches[KERNEL_BWD],
                     dict(max_abs_err=train_errs["bwd"], max_rel_err=train_errs["bwd_rel"],
                          rtol=BWD_RTOL),
                     dict(trainer_launches=trainer_launches[KERNEL_BWD],
                          **e2e_fields[KERNEL_BWD])),
        S.KERNEL: ("segment_sum.cu", "tdgs/ops/segment_sum_pallas.py:48",
                   train_launches[S.KERNEL],
                   dict(max_abs_err=train_errs["seg"], max_rel_err=train_errs["seg_rel"],
                        rtol=SEG_RTOL),
                   dict(trainer_launches=trainer_launches[S.KERNEL],
                        render_train_2dgs_launches=train_2dgs_launches[S.KERNEL],
                        trainer_2dgs_launches=trainer_2dgs_launches[S.KERNEL],
                        render_train_eval3d_launches=train_e3_launches[S.KERNEL],
                        trainer_3dgut_launches=trainer_e3_launches[S.KERNEL],
                        render_train_pallas_launches=train_dense_launches[S.KERNEL],
                        trainer_pallas_launches=trainer_dense_launches[S.KERNEL],
                        image_fitting_launches=fitting_launches[S.KERNEL],
                        library_graph_ms=timings[S.KERNEL]["library_graph_ms"],
                        **{f"eval3d_rows_{k}": seg_eval3d[k]
                           for k in ("columns", "ms", "device_graph_ms", "bound_ms",
                                     "library_ms", "library_graph_ms")},
                        **e2e_fields[S.KERNEL])),
        R2.KERNEL_FWD: ("rasterize_2dgs_fwd.cu", f"{pallas_2dgs}:84", render_2dgs_launches,
                        dict(max_abs_err=errs_2dgs["fwd"], abs_tol=TOL),
                        dict(trainer_2dgs_eval_launches=trainer_2dgs_eval,
                             blocks_a_tile=timings[R2.KERNEL_FWD]["blocks_a_tile"],
                             **{k: timings[R2.KERNEL_FWD][k]
                                for k in ("earlier_gather_ms", "earlier_gather_device_graph_ms",
                                          "earlier_gather_bytes")})),
        R2.KERNEL_TRAIN: ("rasterize_2dgs_fwd.cu", f"{pallas_2dgs}:457",
                          train_2dgs_launches[R2.KERNEL_TRAIN],
                          dict(max_abs_err=errs_2dgs["train"], abs_tol=TOL,
                               distortion_max_rel_err=errs_2dgs["dist_rel"],
                               dist_rtol=DIST_RTOL,
                               median_differs_share=errs_2dgs["median_share"],
                               median_share_tol=MEDIAN_SHARE),
                          dict(trainer_launches=trainer_2dgs_launches[R2.KERNEL_TRAIN],
                               blocks_a_tile=timings[R2.KERNEL_TRAIN]["blocks_a_tile"])),
        R2.KERNEL_BWD: ("rasterize_2dgs_bwd.cu", f"{pallas_2dgs}:596",
                        train_2dgs_launches[R2.KERNEL_BWD],
                        dict(max_abs_err=errs_2dgs["bwd"], max_rel_err=errs_2dgs["bwd_rel"],
                             rtol=BWD_RTOL),
                        dict(trainer_launches=trainer_2dgs_launches[R2.KERNEL_BWD])),
        E.KERNEL_FWD: ("rasterize_eval3d_fwd.cu", f"{pallas_e3}:98", render_e3_launches,
                       dict(max_abs_err=errs_e3["fwd"], abs_tol=TOL,
                            sigma_max_abs_err_vs_f64=errs_e3["sigma"], sigma_tol=SIGMA_TOL),
                       dict(render_train_launches=train_e3_launches[E.KERNEL_TRAIN],
                            trainer_launches=trainer_e3_launches[E.KERNEL_TRAIN],
                            trainer_eval_launches=trainer_e3_eval,
                            train_call_ms=timings[E.KERNEL_FWD]["train_call_ms"])),
        E.KERNEL_BWD: ("rasterize_eval3d_bwd.cu", f"{pallas_e3}:495",
                       train_e3_launches[E.KERNEL_BWD],
                       dict(max_abs_err=errs_e3["bwd"], max_rel_err=errs_e3["bwd_rel"],
                            rtol=BWD_RTOL),
                       dict(trainer_launches=trainer_e3_launches[E.KERNEL_BWD])),
        RP.KERNEL_FWD: ("rasterize_dense_fwd.cu", "tdgs/ops/rasterize_pallas.py:99",
                        train_dense_launches[RP.KERNEL_FWD],
                        dict(max_abs_err=errs_dense["fwd"], abs_tol=TOL),
                        dict(bench_render_launches=render_dense_launches,
                             trainer_launches=trainer_dense_launches[RP.KERNEL_FWD],
                             image_fitting_launches=fitting_launches[RP.KERNEL_FWD],
                             **fitting_shape[RP.KERNEL_FWD])),
        RP.KERNEL_BWD: ("rasterize_dense_bwd.cu", "tdgs/ops/rasterize_pallas.py:168",
                        train_dense_launches[RP.KERNEL_BWD],
                        dict(max_abs_err=errs_dense["bwd"], max_rel_err=errs_dense["bwd_rel"],
                             rtol=BWD_RTOL),
                        dict(trainer_launches=trainer_dense_launches[RP.KERNEL_BWD],
                             image_fitting_launches=fitting_launches[RP.KERNEL_BWD],
                             **fitting_shape[RP.KERNEL_BWD])),
        A.KERNEL: ("adam.cu", "none (XLA-fused jnp)", trainer_launches[A.KERNEL],
                   dict(max_ulps=max(t["max_ulps"] for t in k_adam.values()),
                        ulp_tol=ADAM_ULPS,
                        masked_rows_bitwise=all(t["masked_rows_bitwise"]
                                                for t in k_adam.values())),
                   dict(trainer_2dgs_launches=trainer_2dgs_launches[A.KERNEL],
                        trainer_3dgut_launches=trainer_e3_launches[A.KERNEL],
                        trainer_pallas_launches=trainer_dense_launches[A.KERNEL],
                        **{f"{case}_{k}": t[k] for case, t in k_adam.items()
                           if case != "all_visible"
                           for k in ("ms", "device_graph_ms", "plain_ms", "bound_ms")})),
        N.KERNEL: ("mcmc_noise.cu", "none (XLA-fused jnp)", trainer_e3_launches[N.KERNEL],
                   dict(max_abs_err=k_noise["max_abs_err"],
                        chain_max_abs_err=k_noise["chain_max_abs_err"],
                        within_chain=k_noise["within_chain"],
                        kept_rows_bitwise=k_noise["kept_rows_bitwise"]),
                   dict(trainer_launches=trainer_launches[N.KERNEL])),
    }
    kernels = []
    for name, (src, replaces, launches, errs, others) in table.items():
        k = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"tdgs_torch/csrc/{src}",
            "replaces": replaces, "launches": launches, **errs, "ms": k["ms"],
            "device_graph_ms": k["device_graph_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], **others, **new_fields.get(name, {}),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
