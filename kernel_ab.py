"""Ablation and A/B of the tile-dense kernels 10 (backward) and 9
(composite) on the card, against the sources of an earlier commit, at the
bench frame's dense shape and at image fitting's first step.

    git archive 2d1267b tdgs_torch/csrc | tar -x -C tdgs_torch/build/prev
    python3 kernel_ab.py tdgs_torch/build/prev/tdgs_torch/csrc

The ablation's patches anchor on the kernels' designs at commit 2d1267b,
before their redesign. Builds with nvcc, one process per variant, all
started together:
- from the earlier kernel 10, the ablation variants (a) as it was, (b) the
  walk alone (no per-slot reduction or partial store; a sink keeps the
  walk), (c) (b) with the transposing reduce-scatter of
  csrc/warp_reduce.cuh and one store, (d) (a) without the zero rows past
  each tile's count (timing only), and a counting build of (a); from the
  earlier kernel 9, (a) as it was, (b) batch 0 staged once and walked for
  every batch, (c) each warp staging its own rows and stopping on its own;
- from this tree's kernels 10 and 9, a build as they are (called as every
  variant is, into one output made beforehand: the yardstick of the
  variants; "tree" goes through the wrapper, which makes its output at
  each call), each design without one of its parts (asynchronous staging,
  the cull), kernel 10 with its zeros past count after the walk (single
  floats or 16-byte stores) in place of 16-byte stores before it, kernel 9
  with kernel 6's looser cull in place of its own or with a done warp
  leaving each batch by a vote, and a counting build of kernel 9's cull;
  the split of tiles across blocks is an argument, timed at 1, 2, 4 and 8
  blocks a tile at image fitting's shape.
Each kernel's variants run on the same inputs and are timed twice by
chip_smoke.time_ms and twice by chip_smoke.graph_ms, in turns from the
first to the last and back. Their outputs are held against the plain
version, against a second launch (bit for bit) and against this tree's
kernel. Prints one JSON line per kernel and shape. Needs a CUDA card; the
port does not use this script.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as C
from tdgs_torch.ops import _build
from tdgs_torch.ops import rasterize_pallas as RP

OUT = _build.BUILD_DIR / "kernel_ab"
# kernel 10's: (a) as committed, (b) the walk alone, (c) (b) with the
# reduce-scatter, (d) without the zeros past count
ABLATION_K10 = {0: "a_committed", 1: "b_walk_alone", 2: "c_walk_reduce_scatter",
                3: "d_no_zeros_past_count"}
ABLATION_K9 = {0: "a_committed", 1: "b_batch0_staged_once", 2: "c_per_warp_termination"}

# counters a counting build adds: four sums over the launch
COUNTERS = '''
__device__ unsigned long long g_counts[4];
extern "C" int abl_counts(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_counts, sizeof(g_counts));
}
extern "C" int abl_reset() {
  unsigned long long z[4] = {0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(g_counts, z, sizeof(z));
}
'''

# the ablation's switch (ABL = 0..3, see ABLATION_K10) and the reduce-scatter
ABLATION_HEAD = '''
#ifndef ABL
#define ABL 0
#endif
#include "warp_reduce.cuh"
#if ABL_COUNT
''' + COUNTERS + '''#endif
'''

# kernel 6's per-warp cull (the least eigenvalue of a 3DGS conic over the
# distance to the warp's box)
CULL_3DGS = '''
__device__ __forceinline__ bool may_reach(float4 q0, float4 q1, float x0, float x1,
                                          float y0, float y1) {
  const float a = q0.z, b = q0.w, c = q1.x;
  const float dx = fmaxf(0.f, fmaxf(x0 - q0.x, q0.x - x1));
  const float dy = fmaxf(0.f, fmaxf(y0 - q0.y, q0.y - y1));
  const float h = 0.5f * (a - c);
  const float lam = 0.5f * (a + c) - sqrtf(h * h + b * b) - 2e-5f * (fabsf(a) + fabsf(c));
  return !(0.5f * fmaxf(lam, 0.f) * (dx * dx + dy * dy) > logf(255.f * q1.y) + 1.f);
}
'''


def _sub(text, old, new):
    if text.count(old) != 1:
        raise ValueError(f"patch anchor found {text.count(old)} times: {old[:60]!r}")
    return text.replace(old, new)


def ablation_source(text):
    """The earlier kernel 10 with the ABL switch and, with ABL_COUNT,
    counters of (pixel, slot) evaluations, live ones, warp-slots with a live
    lane and batches."""
    s = _sub(text, "namespace {\n", ABLATION_HEAD + "namespace {\n")
    s = _sub(s, "  int b0 = 0;\n", "  unsigned long long c_eval = 0, c_live = 0, c_wred = 0, "
             "c_batch = 0;\n  float sink = 0.f;\n  int b0 = 0;\n")
    tail = "  // zero rows: slots no pixel reached, and those past the tile's count\n"
    cap_bound = "       i < static_cast<int64_t>(cap) * F; i += blockDim.x) {\n"
    s = _sub(s, cap_bound, "#if ABL == 3\n" + cap_bound.replace("(cap)", "(count)")
             + "#else\n" + cap_bound + "#endif\n")
    s = _sub(s, "    for (int i = tid; i < n * F; i += blockDim.x) s_rows[i] = src[i];\n"
             "    __syncthreads();\n",
             "    for (int i = tid; i < n * F; i += blockDim.x) s_rows[i] = src[i];\n"
             "    if (tid == 0) ++c_batch;\n    __syncthreads();\n")
    s = _sub(s, "      if (!done) {\n", "      if (!done) {\n        ++c_eval;\n")
    s = _sub(s, "            live = true;\n", "            live = true;\n            ++c_live;\n")
    start = ("      float* part = s_part + (warp * kBatch + k) * F;\n"
             "      if (__any_sync(kFullMask, live)) {\n")
    end = ("        if (lane + 32 < F) part[lane + 32] = 0.f;\n      }\n    }\n"
           "    __syncthreads();\n")
    i0 = s.index(start)
    i1 = s.index(end, i0) + len(end)
    committed = s[i0:i1].replace(
        "      if (__any_sync(kFullMask, live)) {\n",
        "      if (__any_sync(kFullMask, live)) {\n        if (lane == 0) ++c_wred;\n", 1)
    walk_only = ("      if (live) {\n"
                 "          sink += g_mx + g_my + g_a + g_b + g_c + g_op;\n#pragma unroll\n"
                 "          for (int c = 0; c < CMAX; ++c) if (c < D) sink += w * vcol[c];\n"
                 "      }\n    }\n    __syncthreads();\n")
    scatter = ("      constexpr int NV = tdgswarp::reduce_width(6 + CMAX);\n"
               "      float* part = s_part + (warp * kBatch + k) * F;\n"
               "      if (__any_sync(kFullMask, live)) {\n"
               "        if (lane == 0) ++c_wred;\n        float v[NV];\n"
               "#pragma unroll\n        for (int j = 6; j < NV; ++j) v[j] = 0.f;\n"
               "        v[0] = g_mx; v[1] = g_my; v[2] = g_a; v[3] = g_b; v[4] = g_c; "
               "v[5] = g_op;\n#pragma unroll\n        for (int c = 0; c < CMAX; ++c) {\n"
               "          if (c < D) v[6 + c] = w * vcol[c];\n        }\n"
               "        tdgswarp::reduce_scatter<NV>(v, lane);\n"
               "        tdgswarp::store_scattered<NV>(part, v, lane, F);\n"
               "      } else {\n        tdgswarp::store_zero_row(part, lane, F);\n      }\n"
               "    }\n    __syncthreads();\n")
    s = (s[:i0] + "#if ABL == 1\n" + walk_only + "#elif ABL == 2\n" + scatter + "#else\n"
         + committed + "#endif\n" + s[i1:])
    return _sub(s, tail, "#if ABL == 1\n  if (sink == 1.2345678e-37f) v_rows[0] = sink;\n#endif\n"
                "#if ABL_COUNT\n  atomicAdd(&g_counts[0], c_eval);\n"
                "  atomicAdd(&g_counts[1], c_live);\n  atomicAdd(&g_counts[2], c_wred);\n"
                "  atomicAdd(&g_counts[3], c_batch);\n#endif\n" + tail)


def ablation_fwd_source(text):
    """The earlier kernel 9 with the ABL switch: (b) batch 0 staged once and
    walked for every batch, (c) each warp staging its own batches of 32 rows
    into its slice of shared memory and stopping once its pixels are done,
    in place of the block's shared batches and block-wide stop."""
    s = _sub(text, "namespace {\n", "#ifndef ABL\n#define ABL 0\n#endif\nnamespace {\n")
    copy = "    for (int i = tid; i < n * F; i += block) s_rows[i] = src[i];\n"
    s = _sub(s, copy, "#if ABL == 1\n    if (b0 == 0)\n#endif\n" + copy)
    first = "  for (int b0 = 0; b0 < count; b0 += block) {\n"
    last = "      const float* r = s_rows + k * F;\n"
    i0 = s.index(first)
    i1 = s.index(last, i0) + len(last)
    per_warp = ("  float* s_own = s_rows + (tid & ~31) * F;  // this warp's [32, F]\n"
                "  for (int b0 = 0; b0 < count; b0 += 32) {\n"
                "    if (__all_sync(0xffffffffu, done)) break;\n"
                "    const int n = min(32, count - b0);\n"
                "    const float* src = tile_rows + static_cast<int64_t>(b0) * F;\n"
                "    __syncwarp();\n"
                "    for (int i = tid & 31; i < n * F; i += 32) s_own[i] = src[i];\n"
                "    __syncwarp();\n"
                "    for (int k = 0; k < n && !done; ++k) {\n"
                "      const float* r = s_own + k * F;\n")
    return s[:i0] + "#if ABL == 2\n" + per_warp + "#else\n" + s[i0:i1] + "#endif\n" + s[i1:]


def tree_variants():
    """{name: source text}: this tree's kernels 10 and 9 as they are, each
    without one part of its design, or with one changed; counting builds
    end in _counters."""
    k10 = (_build.CSRC_DIR / "rasterize_dense_bwd.cu").read_text()
    k9 = (_build.CSRC_DIR / "rasterize_dense_fwd.cu").read_text()
    # row_stage.cuh with synchronous copies in place of cp.async, inlined
    include = '#include "row_stage.cuh"\n'
    stage = _sub((_build.CSRC_DIR / "row_stage.cuh").read_text(), "#pragma once\n", "")
    stage = _sub(stage, "      tdgsasync::copy_4(f < 6 ? batch + 8 * lane + f : batch + 8 * kBatch + "
                 "lane * DP + (f - 6),\n                        src(f));",
                 "      *(f < 6 ? batch + 8 * lane + f : batch + 8 * kBatch + lane * DP + (f - 6)) "
                 "= *src(f);")
    # kernel 10 with the zeros past count in single floats after the walk
    k10_tail = _sub(k10, """  // zero rows past the count, this block's share, before the walk
  zero_floats(tile_out + static_cast<int64_t>(count) * F,
              tile_out + static_cast<int64_t>(cap) * F, part * blockDim.x + tid,
              n_split * blockDim.x);
  if (lo >= hi) return;  // a range past the count: nothing to walk
""", """  const auto zeros_past_count = [&] {
    for (int64_t i = static_cast<int64_t>(count) * F + part * blockDim.x + tid;
         i < static_cast<int64_t>(cap) * F; i += n_split * blockDim.x) {
      tile_out[i] = 0.f;
    }
  };
  if (lo >= hi) {
    zeros_past_count();
    return;
  }
""")
    k10_tail = _sub(k10_tail, "  // zero rows: the slots of this range that no pixel reached\n",
                    "  zeros_past_count();\n  // zero rows: the slots of this range that no pixel "
                    "reached\n")
    # kernel 10 with the zeros past count in 16-byte stores after the walk
    past_count = """  zero_floats(tile_out + static_cast<int64_t>(count) * F,
              tile_out + static_cast<int64_t>(cap) * F, part * blockDim.x + tid,
              n_split * blockDim.x);
"""
    k10_wide_after = _sub(k10, "  // zero rows past the count, this block's share, before the walk\n"
                          + past_count + "  if (lo >= hi) return;  // a range past the count: "
                          "nothing to walk\n", "  if (lo >= hi) {\n" + past_count
                          + "    return;\n  }\n")
    k10_wide_after = _sub(k10_wide_after, "  // zero rows: the slots of this range that no pixel "
                          "reached\n", past_count + "  // zero rows: the slots of this range that "
                          "no pixel reached\n")
    # kernel 9 with the cull of kernel 6 (the conic's least eigenvalue over
    # the distance to the box) in place of the box's least value
    cull_call = "tdgscull::may_reach(s_geo[2 * lane], s_geo[2 * lane + 1], x0, x1, y0, y1)"
    kernel_head = "template <int CMAX>\n__global__"
    k9_round = _sub(k9, kernel_head, CULL_3DGS + "\n" + kernel_head)
    k9_round = _sub(k9_round, cull_call, cull_call.replace("tdgscull::", ""))
    # kernel 9 counting the cull's slots offered and kept (lane 0 of each
    # warp) and the (pixel, slot) evaluations
    k9_count = _sub(k9, "namespace {\n", COUNTERS + "namespace {\n")
    k9_count = _sub(k9_count, "  if (count > 0) stage(0, s_batches);\n",
                    "  unsigned long long c_offered = 0, c_kept = 0, c_eval = 0;\n"
                    "  if (count > 0) stage(0, s_batches);\n")
    k9_count = _sub(k9_count, "    while (todo != 0u) {\n",
                    "    if (lane == 0) {\n      c_offered += n;\n      c_kept += __popc(todo);\n"
                    "    }\n    while (todo != 0u) {\n")
    k9_count = _sub(k9_count, "      if (!done) {\n", "      if (!done) {\n        ++c_eval;\n")
    k9_count = _sub(k9_count, "  tdgsasync::wait<0>();  // a batch still in flight after an early "
                    "exit\n", "  tdgsasync::wait<0>();\n  if (lane == 0) {\n"
                    "    atomicAdd(&g_counts[0], c_offered);\n"
                    "    atomicAdd(&g_counts[1], c_kept);\n  }\n"
                    "  atomicAdd(&g_counts[2], c_eval);\n")
    return {
        # built and called as every variant is: the fair yardstick for them
        "k10_as_is": k10,
        "k9_as_is": k9,
        "k10_sync_staging": _sub(k10, include, stage),
        "k10_scalar_zeros_after_walk": k10_tail,
        "k10_wide_zeros_after_walk": k10_wide_after,
        "k10_no_cull": _sub(k10, f"lane < n && {cull_call}", "lane < n"),
        "k9_sync_staging": _sub(k9, include, stage),
        "k9_no_cull": _sub(k9, f"lane < n && {cull_call}", "lane < n"),
        "k9_eigenvalue_cull": k9_round,
        # a warp whose pixels are all done leaving each batch early, by a vote
        "k9_warp_skip": _sub(k9, "    __syncthreads();\n    const float4* s_geo",
                             "    __syncthreads();\n    if (__all_sync(kFullMask, done)) "
                             "continue;\n    const float4* s_geo"),
        "k9_cull_counters": k9_count,
    }


def build_all(prev: Path):
    """Every variant, one nvcc each, all started together; {name: CDLL}."""
    OUT.mkdir(parents=True, exist_ok=True)
    # the earlier sources take their own headers first, then this tree's
    # (warp_reduce.cuh); this tree's variants only this tree's
    earlier = ["-I", str(prev), "-I", str(_build.CSRC_DIR)]
    jobs = {}
    src = OUT / "ablation_k10.cu"
    src.write_text(ablation_source((prev / "rasterize_dense_bwd.cu").read_text()))
    for m, variant in ABLATION_K10.items():
        jobs[f"k10_{variant}"] = (src, [f"-DABL={m}", *earlier])
    jobs["k10_count_a_committed"] = (src, ["-DABL=0", "-DABL_COUNT=1", *earlier])
    src = OUT / "ablation_k9.cu"
    src.write_text(ablation_fwd_source((prev / "rasterize_dense_fwd.cu").read_text()))
    for m, variant in ABLATION_K9.items():
        jobs[f"k9_{variant}"] = (src, [f"-DABL={m}", *earlier])
    for name, text in tree_variants().items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        jobs[name] = (src, ["-I", str(_build.CSRC_DIR)])
    procs = {}
    for name, (src, flags) in jobs.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(OUT / f"lib{name}.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def _call(fn, *args):
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
    if err != 0:
        raise RuntimeError(f"launch failed with cudaError_t {err}")


def _entry(lib, name, n_ptrs, n_ints):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _counts(lib, run):
    lib.abl_counts.argtypes = [ctypes.c_void_p]
    lib.abl_reset()
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 4)()
    lib.abl_counts(buf)
    return list(buf)


def _flat(out):
    return torch.cat([o.reshape(-1) for o in out]) if isinstance(out, tuple) else out


def compare(kernel, fns, plain, groups=None, pad=None, reps=20):
    """Each variant against the plain version (max|Δ| / max|plain| per
    column group of gradient rows, or max|Δ| of the whole output without
    ``groups``), a second launch and the tree's kernel (``fns["tree"]``);
    ``pad`` marks the rows that must be zero. Times in turns, there and
    back, by CUDA events around back-to-back calls and by the replay of the
    same calls from a CUDA graph (``graph_ms``: without the host's time to
    make each call, which matters where a launch takes tens of
    microseconds)."""
    ref = _flat(fns["tree"]()).clone()
    plain = _flat(plain)
    agree = {}
    for name, fn in fns.items():
        first, second = _flat(fn()).clone(), _flat(fn()).clone()
        torch.cuda.synchronize()
        agree[name] = dict(repeat_bitwise=bool(torch.equal(first, second)),
                           bitwise_vs_tree=bool(torch.equal(first, ref)))
        if groups is None:
            agree[name]["max_abs_err_vs_plain"] = C._abs_err(first, plain)
        else:
            agree[name]["max_rel_err_vs_plain"] = {g: C._rel(first[:, c], plain[:, c])
                                                   for g, c in groups.items()}
        if pad is not None:
            agree[name]["padding_zero"] = float(first[pad].abs().max()) == 0.0
    warm_up(fns["tree"])
    order = list(fns)
    times = {name: [] for name in fns}
    graphs = {name: [] for name in fns}
    for name in order + order[::-1]:
        times[name].append(C.time_ms(fns[name], reps))
        graphs[name].append(C.graph_ms(fns[name], reps))
    return dict(kernel=kernel, times_ms=times, graph_ms=graphs, agree=agree)


def warm_up(fn, seconds=0.5):
    """Runs fn back to back for ``seconds``, so that the card's clocks have
    risen before the first timing."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()


def run_dense(libs, bench):
    """Kernels 10 and 9 at the bench frame's dense shape ("RGB", K = 16,
    tile_capacity 1024, chip_smoke's parity_dense case a) and at image
    fitting's first step (chip_smoke.kernel_inputs_fitting)."""
    rows, counts, _ = C.kernel_inputs_dense(bench, 1024, max_tiles_per_gauss=16,
                                            isect_capacity=C.dense_capacity(bench))
    geo = (1, C.WIDTH, C.HEIGHT, 16)
    img, trans = RP.rasterize_dense_fwd(rows, counts, *geo)
    g = torch.Generator(device=C.DEVICE).manual_seed(5)
    v_img = torch.randn(img.shape, generator=g, device=C.DEVICE)
    v_t = torch.randn(trans.shape, generator=g, device=C.DEVICE)
    shapes = {"bench": (rows, counts, geo, img, trans, v_img, v_t),
              "image_fitting": C.kernel_inputs_fitting()}
    designs = [name for name in tree_variants() if not name.endswith("_counters")]
    for shape, (rows, counts, geo, img, trans, v_img, v_t) in shapes.items():
        T, cap, F = rows.shape
        D = F - RP.GEOM_COLS
        # the blocks a tile is cut into, forced, where tiles are few
        splits = (1, 2, 4, 8) if shape == "image_fitting" else ()
        pad = (torch.arange(cap, device=rows.device)[None] >= counts[:, None]).reshape(-1)
        ranges = RP.split_count(T, rows.device, RP.MAX_RANGES)

        def k10(lib, earlier=False):
            fn = _entry(lib, "tdgs_rasterize_dense_bwd", 7, 6 if earlier else 7)
            out = torch.empty_like(rows)
            extra = () if earlier else (ranges,)
            return lambda: _call(fn, rows, counts, img, trans, v_img, v_t, out, *geo, D, cap,
                                 *extra) or out.view(-1, F)

        fns = {f"k10_{v}": k10(libs[f"k10_{v}"], True) for v in ABLATION_K10.values()}
        fns.update({name: k10(libs[name]) for name in designs if name.startswith("k10_")})
        fns.update({f"tree_split_{s}": functools.partial(
            lambda s: RP._launch_dense_bwd(rows, counts, *geo, img, trans, v_img, v_t,
                                           n_split=s).view(-1, F), s) for s in splits})
        fns["tree"] = lambda: RP.rasterize_dense_bwd(rows, counts, *geo, img, trans, v_img,
                                                     v_t).view(-1, F)
        plain = RP.rasterize_dense_bwd_plain(rows, counts, *geo, img, trans, v_img, v_t)
        result = compare("k10", fns, plain.view(-1, F), C.GROUPS, pad)
        # (pixel, slot) evaluations, live ones, warp-slots with a live
        # lane, batches
        lib = libs["k10_count_a_committed"]
        result.update(shape=shape, n_split=ranges,
                      counts={"a_committed": _counts(lib, k10(lib, True))})
        print(json.dumps(result), flush=True)

        parts = RP.split_count(T, rows.device, geo[3] * geo[3] // 32)

        def k9(lib, earlier=False):
            fn = _entry(lib, "tdgs_rasterize_dense_fwd", 4, 6 if earlier else 7)
            out_c, out_t = torch.empty_like(img), torch.empty_like(trans)
            extra = () if earlier else (parts,)
            return lambda: _call(fn, rows, counts, out_c, out_t, *geo, D, cap,
                                 *extra) or (out_c, out_t)

        fns = {f"k9_{v}": k9(libs[f"k9_{v}"], True) for v in ABLATION_K9.values()}
        fns.update({name: k9(libs[name]) for name in designs if name.startswith("k9_")})
        fns.update({f"tree_split_{s}": functools.partial(
            lambda s: RP._launch_dense_fwd(rows, counts, *geo, n_split=s), s)
            for s in splits})
        fns["tree"] = lambda: RP.rasterize_dense_fwd(rows, counts, *geo)
        result = compare("k9", fns, RP.rasterize_dense_fwd_plain(rows, counts, *geo))
        # per warp-batch: slots offered to the cull, kept; (pixel, slot)
        # evaluations
        lib = libs["k9_cull_counters"]
        result.update(shape=shape, n_split=parts,
                      counts={"tree_cull": _counts(lib, k9(lib))[:3]})
        print(json.dumps(result), flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    if len(argv) != 1:
        raise SystemExit("usage: python3 kernel_ab.py <earlier tdgs_torch/csrc>")
    t0 = time.perf_counter()
    prev = Path(argv[0]).resolve()
    _build.build()
    libs = build_all(prev)
    print(json.dumps({"device": C.nvidia_smi(), "build_s": time.perf_counter() - t0}),
          flush=True)
    run_dense(libs, C.to_card(C.bench_scene()))
    print(json.dumps({"seconds": time.perf_counter() - t0, "device": C.nvidia_smi()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
