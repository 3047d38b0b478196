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
image-fitting example), and print one JSON line per phase.

    python3 chip_smoke.py

Needs a CUDA card and this repository's ``tdgs_torch`` package; it exits
non-zero without either. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is what nvidia-smi
reports for the card's name and power limit.
"""

from __future__ import annotations

import json
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
from tdgs_torch.ops import segment_sum as S
from tdgs_torch.ops.rasterize_packed import (
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


def kernel_work(args, tile_capacity):
    """(pixel, entry) evaluations (walked, live), bytes and the least time
    the card could take for one launch on these inputs."""
    means2d, conics, colors, opac, W, H, ts, offsets, ids = args
    D = colors.shape[-1]
    n_images = means2d.numel() // (means2d.shape[-2] * 2)
    evals = pixel_entry_evaluations(*args, tile_capacity=tile_capacity)
    starts = offsets[:-1].long()
    counts = torch.clamp(torch.diff(offsets.long()), 0, max_entries_per_tile(tile_capacity))
    entries = int(counts.sum())
    # stream positions each tile reads: its start plus 0..count-1
    pos = torch.arange(entries, device=ids.device) + torch.repeat_interleave(
        starts - (torch.cumsum(counts, 0) - counts), counts, output_size=entries)
    rows = int(torch.unique(ids[pos]).numel())
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
    """Kernel vs plain version on the same inputs; fails above TOL."""
    got = rasterize_to_pixels_packed_inference(*args, backgrounds=backgrounds,
                                               tile_capacity=tile_capacity)
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
         alpha_mean=float(want[1].mean()), **errs)
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
    ms = time_ms(lambda: rasterize_to_pixels_packed_inference(
        *args, backgrounds=backgrounds, tile_capacity=tile_capacity), reps)
    plain_ms = time_ms(lambda: rasterize_to_pixels_packed_inference_plain(
        *args, backgrounds=backgrounds, tile_capacity=tile_capacity), 3)
    return dict(ms=ms, plain_ms=plain_ms, **kernel_work(args, tile_capacity))


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
    t0 = time.perf_counter()
    acc = torch.zeros((), device=DEVICE)
    for i in range(n_frames):
        img, _ = frame(i)
        acc += img.mean()
    torch.cuda.synchronize()
    fps = n_frames / (time.perf_counter() - t0)
    args, _, _ = kernel_inputs(bench, max_tiles_per_gauss=16)
    k = measure_kernel(args)
    emit("bench_render", frames=n_frames, fps=fps, n_gaussians=int(bench["means"].shape[0]),
         n_isects=meta["n_isects"], n_dropped=meta["n_dropped"],
         kernel_ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
         bound_by=k["bound_by"], pixel_entry_evaluations=k["evaluations"],
         entries=k["entries"], bytes=k["bytes"], fp32_ops=k["fp32_ops"],
         finite=bool(torch.isfinite(acc)))
    if not bool(torch.isfinite(acc)):
        raise RuntimeError("bench render: non-finite frame")
    return k



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
    sp = S.segment_rows_sum_plain(rows, perm, sids, G, abs_cols=True)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(s1, s2))
    seg_rel = {k: _rel(s1[:, c], sp[:, c]) for k, c in seg_groups(args[2].shape[-1]).items()}
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


def measure_train_kernels(inputs, reps=20):
    """Times of kernels 1 (training call), 2 and 3 at the bench shapes, with
    their plain versions', their bounds, and index_add_ as the segment
    sum's library yardstick."""
    args, img, trans, v_img, v_t, rows = inputs
    tc = 1024
    D = args[2].shape[-1]
    offsets, ids = args[7], args[8]
    G = args[0].numel() // 2
    n_isects = int(offsets[-1])
    L = ids.shape[0]
    fwd = kernel_work(args, tc)

    fwd_ms = time_ms(lambda: rasterize_packed_train_fwd(*args, tile_capacity=tc), reps)
    fwd_plain = time_ms(lambda: rasterize_packed_train_fwd_plain(*args, tile_capacity=tc), 2)

    bwd_ms = time_ms(lambda: rasterize_packed_bwd(*args, img, trans, v_img, v_t,
                                                  tile_capacity=tc), reps)
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
        KERNEL: dict(ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fwd["bound_ms"],
                     bound_by=fwd["bound_by"], library_ms=None,
                     evaluations=fwd["evaluations"], bytes=fwd["bytes"]),
        KERNEL_BWD: dict(ms=bwd_ms, plain_ms=bwd_plain, bound_ms=max(t_b, t_o),
                         bound_by="bytes" if t_b >= t_o else "operations",
                         library_ms=None, evaluations=fwd["evaluations"],
                         bytes=bwd_bytes, fp32_ops=n_bwd_ops),
        S.KERNEL: measure_segment_sum(rows, ids, offsets, G, reps),
    }
    emit("train_kernels", n_isects=n_isects, stream_slots=L, n_gaussians=G, **out)
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
        kernels = (E.KERNEL_FWD, E.KERNEL_BWD, S.KERNEL)
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
    launches = {k: _build.LAUNCHES.get(k, 0) for k in kernels}
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
    if eval_launches < len(runner.valset):
        raise RuntimeError(f"{name}: eval launched {eval_kernel} {eval_launches} times "
                           f"for {len(runner.valset)} views")
    return launches, eval_launches


# ---------------------------------------------------------------------------
# 2DGS: kernels 4, 5 and 6, the bench-scale render and training step, the
# Runner with model_type="2dgs"
# ---------------------------------------------------------------------------


def kernel_inputs_2dgs(sc, render_mode="RGB+ED", distloss=True, **kw):
    """The 2DGS kernels' inputs for one frame, built by the port's own
    projection, SH and tiling (rasterization_2dgs's meta): stream-order
    feature rows, offsets, the image count and the channel count D (3 for
    "RGB", 4 with the depth channel that "RGB+ED" and distloss add)."""
    out = tdgs_torch.rasterization_2dgs(
        sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["sh"],
        sc["viewmats"], sc["Ks"], WIDTH, HEIGHT, sh_degree=3, render_mode=render_mode,
        distloss=distloss, device=DEVICE, **kw)
    meta = out[6]
    colors = _colors_per_camera(sc["sh"], 3, sc["means"], sc["viewmats"], meta["radii"])
    if distloss or render_mode == "RGB+ED":
        colors = torch.cat([colors, meta["depths"][..., None]], -1)
    feats = R2.feature_rows(meta["means2d"], meta["ray_transforms"], colors,
                            meta["normals"], meta["opacities"])
    rows = feats[meta["flatten_ids"].long()].contiguous()
    return (rows, meta["isect_offsets"], 1, colors.shape[-1], WIDTH, HEIGHT,
            meta["tile_size"]), meta


def kernel_work_2dgs(args, tile_capacity, evaluations):
    """Bytes and operations of kernels 4, 5 and 6 on these inputs, each
    input read once and each output written once, and their bounds."""
    rows, offsets, n_images, D, W, H, _ = args
    DA, F = D + 3, rows.shape[1]
    counts = torch.clamp(torch.diff(offsets.long()), 0, max_entries_per_tile(tile_capacity))
    entries = int(counts.sum())
    n_pix = n_images * W * H
    read = entries * F * 4 + offsets.numel() * 4  # the cut ranges' rows, offsets
    work = {
        R2.KERNEL_FWD: (read + n_pix * (DA + 1) * 4,
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


def inference_errors(args, tile_capacity, plain, backgrounds=None):
    """Kernel 4 against its plain version: ``plain`` is
    rasterize_2dgs_fwd_plain's output on ``args``, with the background
    blended as the wrapper's CPU path blends it. max|Δ| of colours, alpha
    and normals, and whether the kernel's outputs are finite."""
    I, D = args[2], args[3]
    img, alp, nrm = R2.rasterize_2dgs_inference(*args, backgrounds, tile_capacity)
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


def parity_2dgs_inference(name, args, backgrounds, tile_capacity=1024):
    """Kernel 4 as its main paths call it, "RGB" (D = 3): without a
    background (the bench render) and with one blended in the kernel (the
    Runner's eval). Fails above TOL."""
    plain = R2.rasterize_2dgs_fwd_plain(*args, tile_capacity)
    errs, finite = {}, True
    for case, bg in (("no_background", None), ("background", backgrounds)):
        errs[case], ok = inference_errors(args, tile_capacity, plain, bg)
        finite = finite and ok
    worst = max(max(e.values()) for e in errs.values())
    emit("parity_2dgs", case=name, tile_capacity=tile_capacity, D=args[3],
         **stream_stats(args[1], tile_capacity), pixel_entry_evaluations=plain[5].tolist(),
         alpha_mean=float((1.0 - plain[2]).mean()), inference_max_abs_err=errs, tol=TOL,
         finite=finite)
    if not finite:
        raise RuntimeError(f"parity_2dgs {name}: non-finite kernel output")
    if not worst <= TOL:
        raise RuntimeError(f"parity_2dgs {name}: kernel 4 {errs} > {TOL}")
    return dict(fwd=worst, evaluations=plain[5].tolist(), inputs=args)


def parity_2dgs(name, geo, tile_capacity, seed):
    """Kernels 4, 5 and 6 against their plain versions on "RGB+ED" inputs
    with the distortion (the training path's), random cotangents; fails
    above the tolerances."""
    D = geo[3]
    plain = R2.rasterize_2dgs_fwd_plain(*geo, tile_capacity, depth_row=D - 1,
                                        compute_distort=True)
    p_img, p_nrm, p_T, p_dist, p_med, evals = plain
    fwd_err, fwd_finite = inference_errors(geo, tile_capacity, plain)
    train = R2.rasterize_2dgs_train_fwd(*geo, tile_capacity, D - 1, True)
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
         bwd_max_abs_err=_abs_err(v_rows, want_rows), finite=finite)
    worst = max(max(fwd_err.values()), max(train_err.values()))
    if not finite:
        raise RuntimeError(f"parity_2dgs {name}: non-finite kernel output")
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
    args_rgb, _ = kernel_inputs_2dgs(bench, render_mode="RGB", distloss=False, **kw)
    bg = torch.tensor([[0.3, 0.5, 0.7]], device=DEVICE)
    rgb = parity_2dgs_inference("a_bench_rgb", args_rgb, bg)
    args, _ = kernel_inputs_2dgs(bench, **kw)
    a = parity_2dgs("b_bench_rgb_ed_dist", args, 1024, seed=3)
    args_h, _ = kernel_inputs_2dgs(heavy, tile_capacity=128, isect_exact=True)
    b = parity_2dgs("c_heavy_overlap_truncated", args_h, 128, seed=4)
    errs = {k: max(a[k], b[k]) for k in ("train", "dist_rel", "median_share", "bwd", "bwd_rel")}
    errs["fwd"] = max(rgb["fwd"], a["fwd"], b["fwd"])
    return errs, rgb, a


def measure_kernels_2dgs(rgb, ed, reps=20):
    """Times of kernel 4 at the bench render's shapes ("RGB", no
    background) and of kernels 5 and 6 at the training step's ("RGB+ED",
    distortion), with their plain versions' and their bounds. No PyTorch
    call composites a sorted tile stream, so there is no library
    yardstick."""
    tc = 1024
    geo_rgb = rgb["inputs"]
    geo, train, cot = ed["inputs"]
    D = geo[3]
    work = kernel_work_2dgs(geo, tc, ed["evaluations"])
    work[R2.KERNEL_FWD] = kernel_work_2dgs(geo_rgb, tc, rgb["evaluations"])[R2.KERNEL_FWD]
    calls = {
        R2.KERNEL_FWD: (lambda: R2.rasterize_2dgs_inference(*geo_rgb, None, tc),
                        lambda: R2.rasterize_2dgs_fwd_plain(*geo_rgb, tc)),
        R2.KERNEL_TRAIN: (lambda: R2.rasterize_2dgs_train_fwd(*geo, tc, D - 1, True),
                          lambda: R2.rasterize_2dgs_fwd_plain(*geo, tc, D - 1, True)),
        R2.KERNEL_BWD: (lambda: R2.rasterize_2dgs_bwd(*geo, *train[:4], *cot, tc, D - 1, True),
                        lambda: R2.rasterize_2dgs_bwd_plain(*geo, *train[:4], *cot, tc,
                                                            D - 1, True)),
    }
    out = {}
    for name, (kernel, plain) in calls.items():
        out[name] = dict(ms=time_ms(kernel, reps), plain_ms=time_ms(plain, 2),
                         library_ms=None, **work[name])
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
    same inputs, random cotangents; fails above the tolerances."""
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
         bwd_max_abs_err=_abs_err(got[0], want[0]), finite=finite)
    if not finite:
        raise RuntimeError(f"parity_eval3d {name}: non-finite kernel output")
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
        out[name] = dict(ms=time_ms(kernel, reps), plain_ms=time_ms(plain, 1),
                         library_ms=None, **work[name])
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
    kernels = (E.KERNEL_FWD, E.KERNEL_BWD, S.KERNEL)
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


def main():
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
    k_bench = phase_bench(bench)

    cap = bench_capacity(bench)
    train_errs, train_inputs = phase_train_parity(bench, heavy, cap)
    train_launches = phase_render_train(bench, cap)
    root = tempfile.mkdtemp(prefix="tdgs_rich_scene_")
    try:
        t0 = time.perf_counter()
        make_rich_scene(root, device=DEVICE)
        scene_s = time.perf_counter() - t0
        trainer_launches, trainer_eval = phase_trainer(root, scene_s)
        k_train = measure_train_kernels(train_inputs)

        cap_2dgs = bench_capacity_2dgs(bench)
        errs_2dgs, par_rgb, par_ed = phase_parity_2dgs(bench, heavy, cap_2dgs)
        render_2dgs_launches = phase_bench_render_2dgs(bench, cap_2dgs)
        train_2dgs_launches = phase_render_train_2dgs(bench, cap_2dgs)
        trainer_2dgs_launches, trainer_2dgs_eval = phase_trainer(root, scene_s, "2dgs")

        # the eval3d tiling of the bench render is the 3DGS one: same capacity
        errs_e3, par_e3 = phase_parity_eval3d(bench, heavy, cap)
        render_e3_launches = phase_bench_render_eval3d(bench, cap)
        train_e3_launches = phase_render_train_eval3d(bench, cap)
        trainer_e3_launches, trainer_e3_eval = phase_trainer(root, scene_s, "3dgut")
        phase_cli_3dgut(root)

        cap_dense = dense_capacity(bench)
        errs_dense, par_dense, par_fitting = phase_parity_dense(bench, heavy, cap_dense)
        render_dense_launches = phase_bench_render_pallas(bench, cap_dense)
        train_dense_launches = phase_render_train(bench, cap_dense, rasterizer="pallas")
        trainer_dense_launches, _ = phase_trainer(root, scene_s, rasterizer="pallas")
        fitting_launches = phase_image_fitting()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    k_eval3d, seg_eval3d = measure_kernels_eval3d(par_e3)
    k_dense, k_fitting = measure_kernels_dense(par_dense, par_fitting)
    timings = dict(k_train, **measure_kernels_2dgs(par_rgb, par_ed), **k_eval3d, **k_dense)
    fitting_shape = {name: {f"image_fitting_{k}": t[k]
                            for k in ("ms", "device_graph_ms", "plain_ms", "bound_ms",
                                      "blocks_a_tile")}
                     for name, t in k_fitting.items()}

    # name: (source, TPU kernel, launches on the main path (kernels 1-3 in
    # render_train, 4 in bench_render_2dgs, 5 and 6 in render_train_2dgs, 7
    # in bench_render_eval3d, 8 in render_train_eval3d, 9 and 10 in
    # render_train_pallas), the error and the tolerance it is held to, the
    # other paths' launches)
    pallas_2dgs = "tdgs/ops/rasterize_2dgs_pallas.py"
    pallas_e3 = "tdgs/ops/rasterize_eval3d_pallas.py"
    table = {
        KERNEL: ("rasterize_packed_fwd.cu", "tdgs/ops/rasterize_pallas_packed.py:322",
                 train_launches[KERNEL],
                 dict(max_abs_err=max(max_err, train_errs["fwd"]), abs_tol=TOL),
                 dict(trainer_launches=trainer_launches[KERNEL],
                      trainer_eval_launches=trainer_eval, rally_launches=rally_launches,
                      rally_ms=k_rally["ms"], rally_plain_ms=k_rally["plain_ms"],
                      rally_bound_ms=k_rally["bound_ms"], bench_render_ms=k_bench["ms"])),
        KERNEL_BWD: ("rasterize_packed_bwd.cu", "tdgs/ops/rasterize_pallas_packed.py:645",
                     train_launches[KERNEL_BWD],
                     dict(max_abs_err=train_errs["bwd"], max_rel_err=train_errs["bwd_rel"],
                          rtol=BWD_RTOL),
                     dict(trainer_launches=trainer_launches[KERNEL_BWD])),
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
                        device_graph_ms=timings[S.KERNEL]["device_graph_ms"],
                        library_graph_ms=timings[S.KERNEL]["library_graph_ms"],
                        **{f"eval3d_rows_{k}": seg_eval3d[k]
                           for k in ("columns", "ms", "device_graph_ms", "bound_ms",
                                     "library_ms", "library_graph_ms")})),
        R2.KERNEL_FWD: ("rasterize_2dgs_fwd.cu", f"{pallas_2dgs}:84", render_2dgs_launches,
                        dict(max_abs_err=errs_2dgs["fwd"], abs_tol=TOL),
                        dict(trainer_2dgs_eval_launches=trainer_2dgs_eval)),
        R2.KERNEL_TRAIN: ("rasterize_2dgs_fwd.cu", f"{pallas_2dgs}:457",
                          train_2dgs_launches[R2.KERNEL_TRAIN],
                          dict(max_abs_err=errs_2dgs["train"], abs_tol=TOL,
                               distortion_max_rel_err=errs_2dgs["dist_rel"],
                               dist_rtol=DIST_RTOL,
                               median_differs_share=errs_2dgs["median_share"],
                               median_share_tol=MEDIAN_SHARE),
                          dict(trainer_launches=trainer_2dgs_launches[R2.KERNEL_TRAIN])),
        R2.KERNEL_BWD: ("rasterize_2dgs_bwd.cu", f"{pallas_2dgs}:596",
                        train_2dgs_launches[R2.KERNEL_BWD],
                        dict(max_abs_err=errs_2dgs["bwd"], max_rel_err=errs_2dgs["bwd_rel"],
                             rtol=BWD_RTOL),
                        dict(trainer_launches=trainer_2dgs_launches[R2.KERNEL_BWD])),
        E.KERNEL_FWD: ("rasterize_eval3d_fwd.cu", f"{pallas_e3}:98", render_e3_launches,
                       dict(max_abs_err=errs_e3["fwd"], abs_tol=TOL,
                            sigma_max_abs_err_vs_f64=errs_e3["sigma"], sigma_tol=SIGMA_TOL),
                       dict(render_train_launches=train_e3_launches[E.KERNEL_FWD],
                            trainer_launches=trainer_e3_launches[E.KERNEL_FWD],
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
                        dict(device_graph_ms=timings[RP.KERNEL_FWD]["device_graph_ms"],
                             bench_render_launches=render_dense_launches,
                             trainer_launches=trainer_dense_launches[RP.KERNEL_FWD],
                             image_fitting_launches=fitting_launches[RP.KERNEL_FWD],
                             **fitting_shape[RP.KERNEL_FWD])),
        RP.KERNEL_BWD: ("rasterize_dense_bwd.cu", "tdgs/ops/rasterize_pallas.py:168",
                        train_dense_launches[RP.KERNEL_BWD],
                        dict(max_abs_err=errs_dense["bwd"], max_rel_err=errs_dense["bwd_rel"],
                             rtol=BWD_RTOL),
                        dict(device_graph_ms=timings[RP.KERNEL_BWD]["device_graph_ms"],
                             trainer_launches=trainer_dense_launches[RP.KERNEL_BWD],
                             image_fitting_launches=fitting_launches[RP.KERNEL_BWD],
                             **fitting_shape[RP.KERNEL_BWD])),
    }
    kernels = []
    for name, (src, replaces, launches, errs, others) in table.items():
        k = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"tdgs_torch/csrc/{src}",
            "replaces": replaces, "launches": launches, **errs, "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], **others,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
