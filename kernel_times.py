"""Time each of the port's CUDA kernels alone on the card, at the shapes of
PERF.md's kernel table: kernels 1-10 on the 200k-gaussian 1080p bench
scene (tests/card_scenes.py) at the shapes of its render and training
paths, kernel 1 also on the rally's scene at rest, kernels 9 and 10 also
at the image-fitting example's, kernel 3 also on kernel 8's rows, the Adam
kernel (11) over the trainer's six groups at 1M rows, the MCMC position
noise (12) at 1M rows, the UT projection (13) at 1M gaussians, for the
3DGUT cell's camera and for a distorted rolling-shutter one, and the
surfel projection's forward (14) and backward (15) at the 2DGS cell's 3M
surfels and camera; then, on
scenes it trains first (a few minutes), kernels 1-3 at the domino chain's
identity render (D = 16) and kernel 1 at its rally frame (tile_capacity
2048), kernels 1-3 at the depth path's D = 4, and kernels 4-6 at the 2DGS
trainer's first step (1236x822).

    python3 kernel_times.py

For each kernel and shape it prints one JSON line: the mean device time a
launch by CUDA events around back-to-back calls (``ms``) and by the same
calls replayed from one CUDA graph (``device_graph_ms``, without the
host's time to make each call), the plain PyTorch version's time
(``plain_ms``), and the least time the card could take for the launch
(``bound_ms``): max(bytes / 3.35 TB/s, FP32 operations / 67 TFLOP/s) of
the launch's counted work, each input read once and each output written
once. The first lines give the card (nvidia-smi's name and power limit)
and the build. It checks nothing: the card tests hold each kernel against
its plain version (``python -m pytest --noconftest -m cuda``, README).
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile

import numpy as np
import torch

from tdgs_torch.models.gaussians import create_splats
from tdgs_torch.ops import _build
from tdgs_torch.ops import adam as A
from tdgs_torch.ops import mcmc_noise as N
from tdgs_torch.ops import projection_2dgs as SP
from tdgs_torch.ops import projection_ut as U
from tdgs_torch.ops import rasterize_2dgs_packed as R2
from tdgs_torch.ops import rasterize_eval3d_packed as E
from tdgs_torch.ops import rasterize_pallas as RP
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
from tdgs_torch.training.trainer import Runner
from tdgs_torch.utils.test_data import DOMINO_BACKGROUND, make_rich_scene
from tests import card_scenes as C

DEVICE = "cuda"
REPS = 20

# H100 SXM published peaks: HBM bytes/s, FP32 (non-tensor) FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

# FP32 operations of one (pixel, entry) evaluation that both compositing
# kernels make: sigma 11, exp 2, alpha 2, tests 2, transmittance 3. Every
# walked evaluation costs the walk; only a live one (included, past the
# sigma and 1/255 tests) goes on to the colours or the gradients. The op
# counts below take evals = (walked, live), as the plain walks count them.
WALK_OPS = 20


def fwd_ops(D, evals):
    """Kernels 1 and 9: the walk, then at each live evaluation the weight
    (1) and a multiply-add per channel."""
    walked, live = evals
    return walked * WALK_OPS + live * (1 + 2 * D)


def bwd_ops(D, evals):
    """Kernels 2 and 10: the walk, then at each live evaluation w (1), r
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


def bound(n_bytes, n_ops):
    """The least time a launch of this work takes, and which peak sets it."""
    t_b, t_o = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32 * 1e3
    return dict(bytes=n_bytes, fp32_ops=n_ops, bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


def emit(kernel, shape, **fields):
    print(json.dumps({"kernel": kernel, "shape": shape, **fields}), flush=True)


def time_ms(fn, reps=REPS):
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


def graph_ms(fn, reps=REPS):
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


def times(kernel, plain, plain_reps):
    """ms, device_graph_ms and plain_ms of a kernel's call and its plain
    version's."""
    return dict(ms=time_ms(kernel), device_graph_ms=graph_ms(kernel),
                plain_ms=time_ms(plain, plain_reps))


# ---------------------------------------------------------------------------
# kernels 1-3
# ---------------------------------------------------------------------------


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
    """Kernel 1's (pixel, entry) evaluations (walked, live), entries, rows
    and bound on these inputs: each input read once (the feature rows of
    the gaussians the cut ranges name, their flatten ids and the offsets),
    colours and alphas written once."""
    means2d, conics, colors, opac, W, H, ts, offsets, ids = args
    D = colors.shape[-1]
    n_images = means2d.numel() // (means2d.shape[-2] * 2)
    evals = pixel_entry_evaluations(*args, tile_capacity=tile_capacity)
    entries, rows = named_rows(offsets, ids, tile_capacity)
    n_bytes = (rows * (6 + D) * 4 + entries * 4 + offsets.numel() * 4
               + n_images * W * H * (D + 1) * 4)
    return dict(evaluations=evals, entries=entries, rows=rows,
                **bound(n_bytes, fwd_ops(D, evals)))


def time_kernel_1_inference(shape, args, backgrounds=None, tile_capacity=1024):
    emit(KERNEL, shape, **times(
        lambda: rasterize_to_pixels_packed_inference(*args, backgrounds=backgrounds,
                                                     tile_capacity=tile_capacity),
        lambda: rasterize_to_pixels_packed_inference_plain(
            *args, backgrounds=backgrounds, tile_capacity=tile_capacity), 3),
        blocks_a_tile=P_BLOCKS_A_TILE.get(KERNEL), **kernel_work(args, tile_capacity))


def time_segment_sum(shape, rows, ids, offsets, G):
    """Kernel 3 on a backward's per-slot rows [L, F] and their stream ids
    (the slots past offsets[-1] are padding), summed into G rows; beside it
    ``index_add_`` over the valid slots, its library yardstick."""
    n_isects = int(offsets[-1])
    F = rows.shape[1]
    sids, perm = S.sort_ids(ids, offsets[-1])
    valid_ids, valid_rows = ids[:n_isects].long(), rows[:n_isects]

    def library():
        return torch.zeros((G, F), device=DEVICE).index_add_(0, valid_ids, valid_rows)

    # sorted id and permutation (4 bytes each) with each row, read once;
    # the per-gaussian sums written once
    emit(S.KERNEL, shape, **times(lambda: S.segment_rows_sum(rows, perm, sids, G),
                                  lambda: S.segment_rows_sum_plain(rows, perm, sids, G), 3),
         library_ms=time_ms(library), library_graph_ms=graph_ms(library),
         entries=n_isects, rows_out=G, columns=F,
         **bound(n_isects * (F + 2) * 4 + G * F * 4, n_isects * F))


def time_kernels_1_to_3(shape, args, tc, seed):
    """Kernel 1's training call, kernels 2 and 3 on a training step's
    stream ``args``."""
    img, trans, v_img, v_t, rows = C.train_stream(args, tc, seed)
    D = args[2].shape[-1]
    offsets, ids = args[7], args[8]
    fwd = kernel_work(args, tc)
    emit(KERNEL, shape, **times(
        lambda: rasterize_packed_train_fwd(*args, tile_capacity=tc),
        lambda: rasterize_packed_train_fwd_plain(*args, tile_capacity=tc), 2),
        blocks_a_tile=P_BLOCKS_A_TILE.get(KERNEL), **fwd)
    # each input read once: the rows the cut ranges name, ids, offsets and
    # per pixel the forward's colours and T with their cotangents; the
    # [L, 6 + D] rows written once
    n_pix = img.numel() // D
    L = ids.shape[0]
    n_bytes = (fwd["rows"] * (6 + D) * 4 + fwd["entries"] * 4 + offsets.numel() * 4
               + n_pix * (2 * D + 2) * 4 + L * (6 + D) * 4)
    emit(KERNEL_BWD, shape, **times(
        lambda: rasterize_packed_bwd(*args, img, trans, v_img, v_t, tile_capacity=tc),
        lambda: rasterize_packed_bwd_plain(*args, img, trans, v_img, v_t, tile_capacity=tc), 1),
        evaluations=fwd["evaluations"], **bound(n_bytes, bwd_ops(D, fwd["evaluations"])))
    time_segment_sum(shape, rows, ids, offsets, args[0].numel() // 2)


# ---------------------------------------------------------------------------
# kernels 4-6
# ---------------------------------------------------------------------------


def work_2dgs(geo, tile_capacity, evaluations, k4=None):
    """Bytes and operations of kernels 4, 5 and 6 on these inputs (kernel
    4's bytes from ``k4``, its inputs, where given), each input read once
    and each output written once, and their bounds."""
    rows, offsets, n_images, D, W, H, _ = geo
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
        R2.KERNEL_FWD: (read_k4 + n_pix * (DA + 1) * 4, fwd_2dgs_ops(DA, False, evaluations)),
        R2.KERNEL_TRAIN: (read + n_pix * (DA + 3) * 4, fwd_2dgs_ops(DA, True, evaluations)),
        # the forward's outputs (channels, T, distortion) and their
        # cotangents per pixel; one row per stream slot written
        R2.KERNEL_BWD: (read + n_pix * 2 * (DA + 2) * 4 + rows.shape[0] * F * 4,
                        bwd_2dgs_ops(DA, evaluations)),
    }
    return {name: dict(evaluations=evaluations, entries=entries, **bound(*w))
            for name, w in work.items()}


def time_kernels_4_to_6(prefix, rgb, ed):
    """Kernel 4 at a render's shapes (``rgb``: "RGB", no background, through
    flatten_ids), kernels 5 and 6 at the training step's (``ed``: "RGB+ED",
    the distortion)."""
    geo_rgb, k4, tc = rgb
    evals = R2.rasterize_2dgs_fwd_plain(*geo_rgb, tc)[5].tolist()
    emit(R2.KERNEL_FWD, f"{prefix}_render", **times(
        lambda: R2.rasterize_2dgs_inference(*k4, None, tc),
        lambda: R2.rasterize_2dgs_fwd_plain(*geo_rgb, tc), 2),
        blocks_a_tile=R2.BLOCKS_A_TILE.get(R2.KERNEL_FWD),
        **work_2dgs(geo_rgb, tc, evals, k4)[R2.KERNEL_FWD])
    geo, tc, seed = ed
    D = geo[3]
    evals = R2.rasterize_2dgs_fwd_plain(*geo, tc, depth_row=D - 1, compute_distort=True)[5]
    work = work_2dgs(geo, tc, evals.tolist())
    train, cot = C.train_stream_2dgs(geo, tc, seed)
    emit(R2.KERNEL_TRAIN, f"{prefix}_train", **times(
        lambda: R2.rasterize_2dgs_train_fwd(*geo, tc, D - 1, True),
        lambda: R2.rasterize_2dgs_fwd_plain(*geo, tc, D - 1, True), 2),
        blocks_a_tile=R2.BLOCKS_A_TILE.get(R2.KERNEL_TRAIN), **work[R2.KERNEL_TRAIN])
    emit(R2.KERNEL_BWD, f"{prefix}_train", **times(
        lambda: R2.rasterize_2dgs_bwd(*geo, *train[:4], *cot, tc, D - 1, True),
        lambda: R2.rasterize_2dgs_bwd_plain(*geo, *train[:4], *cot, tc, D - 1, True), 2),
        **work[R2.KERNEL_BWD])


# ---------------------------------------------------------------------------
# kernels 7 and 8
# ---------------------------------------------------------------------------


def work_eval3d(geo, tile_capacity, evaluations):
    """Bytes and operations of kernels 7 and 8 on these inputs, each input
    read once and each output written once, and their bounds."""
    rows, d, o, offsets, I, D, W, H, _ = geo
    F = rows.shape[1]
    central = o is None
    counts = torch.clamp(torch.diff(offsets.long()), 0, max_entries_per_tile(tile_capacity))
    entries = int(counts.sum())
    n_pix = I * W * H
    ray_bytes = d.numel() // 3 * (3 if central else 6) * 4
    read = entries * F * 4 + offsets.numel() * 4 + ray_bytes
    work = {
        E.KERNEL_FWD: (read + n_pix * (D + 1) * 4, fwd_eval3d_ops(D, central, evaluations)),
        # the forward's colours and T with their cotangents per pixel; one
        # row per stream slot and the ray gradients written
        E.KERNEL_BWD: (read + n_pix * 2 * (D + 1) * 4 + rows.shape[0] * F * 4 + ray_bytes,
                       bwd_eval3d_ops(D, central, evaluations)),
    }
    return {name: dict(evaluations=evaluations, entries=entries, **bound(*w))
            for name, w in work.items()}


def time_kernels_7_8(scenes):
    """Kernel 7 (the forward-only call, no background, as the bench render
    calls it; its training call beside) and kernel 8 at the bench shapes,
    central; kernel 7 under the rolling shutter; kernel 3 on kernel 8's
    rows (13 + D columns), as the eval3d VJP sums them per gaussian."""
    for name, shape in (("a_bench_rgb_central", "bench"),
                        ("b_bench_rgb_rolling_shutter", "rolling_shutter")):
        geo, extra, tc, seed = C.kernel_eval3d_case(scenes, name)
        stream = geo[:9]
        evals = E.rasterize_eval3d_fwd_plain(*stream, tc)[2].tolist()
        work = work_eval3d(stream, tc, evals)
        emit(E.KERNEL_FWD, shape, **times(
            lambda: E.rasterize_eval3d_inference(*stream, None, tc),
            lambda: E.rasterize_eval3d_fwd_plain(*stream, tc), 1),
            train_call_ms=time_ms(lambda: E.rasterize_eval3d_train_fwd(*stream, tc)),
            **work[E.KERNEL_FWD])
        if shape != "bench":
            continue
        img, T, v_img, v_T = C.train_stream_eval3d(stream, tc, seed)
        emit(E.KERNEL_BWD, shape, **times(
            lambda: E.rasterize_eval3d_bwd(*stream, img, T, v_img, v_T, tc),
            lambda: E.rasterize_eval3d_bwd_plain(*stream, img, T, v_img, v_T, tc), 1),
            **work[E.KERNEL_BWD])
        v_rows = E.rasterize_eval3d_bwd(*stream, img, T, v_img, v_T, tc)[0]
        time_segment_sum("eval3d_rows", v_rows, extra["meta"]["flatten_ids"], stream[3],
                         scenes["bench"]["means"].shape[0])


# ---------------------------------------------------------------------------
# kernels 9 and 10
# ---------------------------------------------------------------------------


def time_kernels_9_10(shape, inputs):
    """Kernels 9 and 10 on one frame's dense inputs (rows [T, cap, 6 + D],
    counts, geometry, the forward's outputs and their cotangents): each
    input read once (the valid rows and the counts, per pixel the forward's
    colours and T with their cotangents for the backward), each output
    written once (the image and T, or every [T, cap, F] gradient row)."""
    rows, counts, geo, img, trans, v_img, v_t = inputs
    T, cap, F = rows.shape
    D = F - RP.GEOM_COLS
    evals = RP.dense_evaluations(rows, counts, *geo)
    valid = int(counts.sum())
    n_pix = geo[0] * geo[1] * geo[2]
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
    for name, (kernel, plain) in calls.items():
        t = times(kernel, plain, 2)
        emit(name, shape, **t, blocks_a_tile=RP.BLOCKS_A_TILE[name], evaluations=evals,
             valid_slots=valid, slots=T * cap, **bound(*work[name]))


# ---------------------------------------------------------------------------
# the Adam kernel (11), the MCMC position noise (12), the UT projection (13),
# the surfel projection (14, 15)
# ---------------------------------------------------------------------------


def time_adam(shape, n=1_000_000, visible=1.0, sh_slices=True, seed=0):
    """The Adam kernel over the trainer's six 3DGS groups at SH degree 3 (59
    floats a row) at ``n`` rows, a random share ``visible`` of them
    unmasked, the SH gradients slices of one as the trainer's
    (``sh_slices``); its bound by bytes (28 a visible float, 24 a masked
    one, a byte a row)."""
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
    args = (params, grads, mu, nu, {k: 1e-3 for k in shapes}, 0.9, 0.999, 1e-15, vis)
    floats = sum(t.numel() for t in params.values())
    shown = float(vis.float().mean())
    t = times(lambda: A.adam_update(*args), lambda: A.adam_update_plain(*args), REPS)
    b = bound(floats * (24 + 4 * shown) + n, 0)
    emit(A.KERNEL, shape, **t, **b, roofline=b["bound_ms"] / t["ms"], floats=floats, rows=n,
         visible_share=shown, sh_grad_slices=sh_slices)


def time_mcmc_noise(n=1_000_000):
    """The MCMC noise kernel at ``n`` rows drawn as the benchmark's trained
    state (``card_scenes.noise_state``), every row active as at the
    benchmark's cap; its bound by bytes (69 a row: means, quats,
    log-scales, logit, noise and the mask read, the means written)."""
    params, noise = C.noise_state(n, device=DEVICE)
    active = torch.ones(n, dtype=torch.bool, device=DEVICE)
    scaler = C.NOISE_SCALER
    t = times(lambda: N.inject_noise_to_position(params, noise, scaler, active),
              lambda: N.inject_noise_to_position_plain(params, noise, scaler, active), REPS)
    b = bound(69 * n, 0)
    emit(N.KERNEL, "1m_rows", **t, **b, roofline=b["bound_ms"] / t["ms"], rows=n)


def time_ut_project(shape, n=1_000_000, distorted_rolling_shutter=False):
    """The UT projection's kernel (13) at ``n`` gaussians of
    ``card_scenes.ut_scene`` for one 1236x822 pinhole camera, global
    shutter as the 3DGUT cell projects, or (``distorted_rolling_shutter``)
    with the card tests' distortion (``card_scenes.ut_distortion``) and
    rolling shutter (``card_scenes.rolling_shutter_kw``, two passes); its
    bound by bytes (76 a row: means, quats, scales and the opacity read,
    radii, means2d, the depth and the conic written)."""
    sc = C.ut_scene(n, device=DEVICE)
    kw = {}
    if distorted_rolling_shutter:
        rs = C.rolling_shutter_kw(sc)
        kw = dict(C.ut_distortion(1, device=DEVICE), rolling_shutter=rs["rolling_shutter"],
                  viewmats_rs=rs["viewmats_rs"])
    args = (sc["means"], sc["quats"], sc["scales"], sc["opacities"], sc["viewmats"], sc["Ks"],
            C.UT_WIDTH, C.UT_HEIGHT)
    t = times(lambda: U.project_ut_for_tiles(*args, **kw),
              lambda: U.fully_fused_projection_with_ut(*args, **kw), REPS)
    b = bound(76 * n, 0)
    emit(U.KERNEL, shape, **t, **b, roofline=b["bound_ms"] / t["ms"], rows=n)


def time_surfel_project(n=3_000_000):
    """The surfel projection's kernels at the 2DGS cell's shape: ``n``
    surfels of ``card_scenes.surfel_scene`` for one 1297x840 camera, the
    backward with every cotangent; bounds by bytes (108 a row forward:
    means, quats and scales read, radii, means2d, the depth, M and the
    normal written; 140 backward: the inputs and the four cotangents read,
    the three gradients written). ``plain_ms``: the chain under no_grad,
    the plain VJP; ``chain_autograd_ms``: the chain recording its graph, and
    that graph's backward, which the kernels replace on the trainer's
    path."""
    sc = C.surfel_scene(n, device=DEVICE)
    ins = tuple(sc[k] for k in ("means", "quats", "scales", "viewmats", "Ks"))
    size = (C.SURFEL_WIDTH, C.SURFEL_HEIGHT)
    leaves = [t.clone().requires_grad_(True) for t in ins[:3]]

    def chain():
        return SP.surfel_projection_chain(*leaves, *ins[3:], *size)

    t = times(lambda: SP.surfel_project_fwd(*ins, *size),
              lambda: SP.surfel_projection_chain(*ins, *size), 5)
    b = bound(108 * n, 0)
    emit(SP.KERNEL, "2dgs_cell_3m", **t, **b, roofline=b["bound_ms"] / t["ms"],
         chain_autograd_ms=time_ms(chain, 5), rows=n)
    outs = chain()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    cots = [torch.randn(o.shape, generator=gen, device=DEVICE) for o in outs[1:]]
    t = times(lambda: SP.surfel_project_bwd(*ins, *cots),
              lambda: SP.surfel_projection_vjp_plain(*ins, *cots), 5)
    b = bound(140 * n, 0)
    emit(SP.KERNEL_BWD, "2dgs_cell_3m", **t, **b, roofline=b["bound_ms"] / t["ms"],
         chain_autograd_ms=time_ms(
             lambda: torch.autograd.grad(outs[1:], leaves, cots, retain_graph=True), 5),
         rows=n)


# ---------------------------------------------------------------------------
# the shapes of trained scenes
# ---------------------------------------------------------------------------


def trainer_2dgs_scene(root, width=1236, height=822, n_surfels=40_000, seed=11):
    """The 2DGS trainer's first step: the rich scene's camera 0 at its image
    size, with ``n_surfels`` of its ground-truth points initialised as the
    Runner initialises SfM points (3-NN scales, opacity 0.1, SH degree 3
    from the colours)."""
    sc = make_rich_scene(root, n_images=1, width=width, height=height, device=DEVICE)
    sel = np.random.default_rng(seed).choice(sc["means"].shape[0], size=n_surfels,
                                             replace=False)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    p = create_splats(torch.as_tensor(sc["means"][sel], device=DEVICE),
                      torch.as_tensor(sc["colors"][sel], device=DEVICE), g, sh_degree=3)
    return dict(means=p["means"], quats=p["quats"], scales=torch.exp(p["scales"]),
                opacities=torch.sigmoid(p["opacities"]), sh=torch.cat([p["sh0"], p["shN"]], 1),
                viewmats=torch.as_tensor(sc["viewmats"][:1], device=DEVICE),
                Ks=torch.as_tensor(sc["Ks"][:1], device=DEVICE))


def time_trained_shapes():
    """Kernels 1-3 at the chain's identity render and kernel 1 at its rally
    frame (``card_scenes.chain_case``), kernels 1-3 at the depth path's
    first training view after its 100 steps (``card_scenes.DEPTH_TERMS``),
    kernels 4-6 at the 2DGS trainer's first step. What the scenes' builders
    print goes to stderr."""
    with tempfile.TemporaryDirectory() as root:
        with contextlib.redirect_stdout(sys.stderr):
            summary = C.trained_chain(root)
        args, _, tc = C.chain_case(root, summary, "identity_d16")
        time_kernels_1_to_3("identity_d16", args, tc, 3)
        args, bg, tc = C.chain_case(root, summary, "e_trained_dominoes_2048")
        time_kernel_1_inference("chain_rally_2048", args, bg, tc)
    with tempfile.TemporaryDirectory() as root:
        with contextlib.redirect_stdout(sys.stderr):
            C.write_depth_maps(root, make_rich_scene(root, device=DEVICE))
            runner = Runner(C.cell_config(root, "trainer_depth", 100, **C.DEPTH_TERMS),
                            device=DEVICE)
            runner.train()
        try:
            time_kernels_1_to_3("depth_d4", C.depth_kernel_inputs(runner), 1024, 4)
        finally:
            runner.close()
    with tempfile.TemporaryDirectory() as root:
        sc = trainer_2dgs_scene(root)
    size = dict(width=1236, height=822, tile_capacity=1024)
    geo_rgb, k4 = C.kernel_inputs_2dgs(sc, render_mode="RGB", distloss=False, **size)
    geo, _ = C.kernel_inputs_2dgs(sc, **size)
    time_kernels_4_to_6("trainer_2dgs", (geo_rgb, k4, 1024), (geo, 1024, 3))


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(json.dumps({"device": smi.stdout.strip().splitlines()[0], "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    build_s = _build.build()
    ptxas = {n: [line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line]
             for n, log in _build.BUILD_LOGS.items()}
    print(json.dumps({"build_s": build_s, "ptxas": ptxas}), flush=True)

    scenes = C.full_size_scenes()
    args, bg, tc = C.kernel_1_case(scenes, "a_bench_rgb")
    time_kernel_1_inference("bench_render", args, bg, tc)
    bg = torch.full((1, 3), DOMINO_BACKGROUND, device=DEVICE)
    args, bg, _ = C.kernel_inputs(scenes["rally"], backgrounds=bg, isect_exact=True)
    time_kernel_1_inference("rally_at_rest", args, bg)
    time_kernels_1_to_3("bench_train", *C.train_case(scenes, "a_bench"))
    geo_rgb, k4, tc, _ = C.kernel_2dgs_case(scenes, "a_bench_rgb")
    geo, _, tc_ed, seed = C.kernel_2dgs_case(scenes, "b_bench_rgb_ed_dist")
    time_kernels_4_to_6("bench", (geo_rgb, k4, tc), (geo, tc_ed, seed))
    time_kernels_7_8(scenes)
    inputs, _, _ = C.kernel_dense_case(scenes, "a_bench_rgb_background")
    time_kernels_9_10("bench", inputs)
    time_kernels_9_10("image_fitting", C.kernel_inputs_fitting())
    for shape, kw in (("1m_all_visible", {}), ("1m_half_visible", dict(visible=0.5)),
                      ("1m_dense_grads", dict(sh_slices=False))):
        time_adam(shape, **kw)
    time_mcmc_noise()
    time_ut_project("3dgut_cell_1m")
    time_ut_project("1m_distorted_rolling_shutter", distorted_rolling_shutter=True)
    time_surfel_project()
    time_trained_shapes()


if __name__ == "__main__":
    main()
