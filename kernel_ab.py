"""Ablation and A/B of the backward kernels 2, 6 and 8 on the card, against
the sources of an earlier commit, at chip_smoke.py's bench shapes.

    git archive <commit> tdgs_torch/csrc | tar -x -C tdgs_torch/build/prev
    python3 kernel_ab.py tdgs_torch/build/prev/tdgs_torch/csrc

Builds with nvcc, one process per variant, all started together:
- from the earlier kernels 6 and 2, the ablation variants (a) as they
  were, (b) the walk alone (no per-entry reduction or partial store; a
  sink keeps the walk), (c) (b) with the transposing reduce-scatter of
  csrc/warp_reduce.cuh and one store, (d) (a) with batch 0 staged once and
  walked for every batch, (e) (c) with an approximate 1 / (1 - alpha),
  (f) (c) with batch 0 staged once; and counting builds of (a) and (d);
- from this tree's kernels 6 and 2, each design without one of its parts
  (asynchronous staging, the cull, the half-warp rows), with a cull added
  (kernel 2) and with -maxrregcount=64; a counting build of kernel 6's
  cull;
- the earlier kernel 8.
Each kernel's variants run on the same inputs and are timed twice by
chip_smoke.time_ms, in turns from the first to the last and back. Their
rows are held against the plain version, against a second launch (bit
for bit) and against this tree's kernel; kernel 8's against the earlier
build. Prints one JSON line per kernel. Needs a CUDA card; the port does
not use this script.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as C
from tdgs_torch.ops import _build
from tdgs_torch.ops import rasterize_2dgs_packed as R2
from tdgs_torch.ops import rasterize_eval3d_packed as E
from tdgs_torch.ops.rasterize_packed import (
    _check_stream,
    max_entries_per_tile,
    rasterize_packed_bwd,
    rasterize_packed_bwd_plain,
    rasterize_packed_train_fwd,
)

OUT = _build.BUILD_DIR / "kernel_ab"
ABLATION = {0: "a_committed", 1: "b_walk_alone", 2: "c_walk_reduce_scatter",
            3: "d_batch0_staged_once", 4: "e_c_approx_reciprocal", 5: "f_c_batch0_staged_once"}
GROUPS_2DGS = {"means2d": slice(0, 2), "t0_tpx_tpy": slice(2, 11), "opacity": slice(11, 12),
               "channels": slice(12, None)}

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

# the ablation's switch (ABL = 0..5, see ABLATION) and the reduce-scatter
ABLATION_HEAD = '''
#ifndef ABL
#define ABL 0
#endif
#include "warp_reduce.cuh"
#if ABL_COUNT
''' + COUNTERS + '''#endif
'''

# kernel 2 with kernel 6's per-warp cull (the bound for a 3DGS conic)
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
WARP_BOX = '''
  float x0 = fx, x1 = fx, y0 = fy, y1 = fy;
  for (int o = 16; o > 0; o >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(kFullMask, x0, o));
    x1 = fmaxf(x1, __shfl_xor_sync(kFullMask, x1, o));
    y0 = fminf(y0, __shfl_xor_sync(kFullMask, y0, o));
    y1 = fmaxf(y1, __shfl_xor_sync(kFullMask, y1, o));
  }
'''


def _sub(text, old, new):
    if text.count(old) != 1:
        raise ValueError(f"patch anchor found {text.count(old)} times: {old[:60]!r}")
    return text.replace(old, new)


def ablation_source(text, kernel):
    """The earlier kernel 6 or 2 with the ABL switch and, with ABL_COUNT,
    counters of (pixel, entry) evaluations, live ones, warp-entries with a
    live lane and batches."""
    s = _sub(text, "namespace {\n", ABLATION_HEAD + "namespace {\n")
    s = _sub(s, "  int b0 = 0;\n", "  unsigned long long c_eval = 0, c_live = 0, c_wred = 0, "
             "c_batch = 0;\n  float sink = 0.f;\n  int b0 = 0;\n")
    once = "#if ABL == 3 || ABL == 5\n    if (b0 == 0)\n#endif\n"
    if kernel == "k6":
        s = _sub(s, "    for (int i = tid; i < n * F; i += blockDim.x) s_rows[i] = src[i];\n"
                 "    __syncthreads();\n",
                 once + "    for (int i = tid; i < n * F; i += blockDim.x) s_rows[i] = src[i];\n"
                 "    if (tid == 0) ++c_batch;\n    __syncthreads();\n")
        nv, cols = "kGeomCols + CMAX", "kGeomCols"
        fill = ("#pragma unroll\n        for (int j = 0; j < kGeomCols; ++j) v[j] = g[j];\n"
                "#pragma unroll\n        for (int c = 0; c < CMAX; ++c) {\n"
                "          if (c < DA) v[kGeomCols + c] = w * vch[c] + "
                "(c == depth_row ? g_depth : 0.f);\n        }\n")
        sink = ("#pragma unroll\n          for (int j = 0; j < kGeomCols; ++j) sink += g[j];\n"
                "#pragma unroll\n          for (int c = 0; c < CMAX; ++c) "
                "if (c < DA) sink += w * vch[c];\n          sink += g_depth;\n")
    else:
        s = _sub(s, "    if (tid < n) {\n      const int64_t g = flatten_ids",
                 "#if ABL == 3 || ABL == 5\n    if (b0 == 0 && tid < n) {\n#else\n"
                 "    if (tid < n) {\n#endif\n      const int64_t g = flatten_ids")
        s = _sub(s, "    __syncthreads();\n\n    for (int k = 0; k < n; ++k) {",
                 "    if (tid == 0) ++c_batch;\n    __syncthreads();\n\n"
                 "    for (int k = 0; k < n; ++k) {")
        nv, cols = "6 + CMAX", "6"
        fill = ("        v[0] = g_mx; v[1] = g_my; v[2] = g_a; v[3] = g_b; v[4] = g_c; "
                "v[5] = g_op;\n#pragma unroll\n        for (int c = 0; c < CMAX; ++c) {\n"
                "          if (c < D) v[6 + c] = w * vcol[c];\n        }\n")
        sink = ("          sink += g_mx + g_my + g_a + g_b + g_c + g_op;\n#pragma unroll\n"
                "          for (int c = 0; c < CMAX; ++c) if (c < D) sink += w * vcol[c];\n")
    s = _sub(s, "      if (!done) {\n", "      if (!done) {\n        ++c_eval;\n")
    s = _sub(s, "            live = true;\n", "            live = true;\n            ++c_live;\n")
    s = _sub(s, "            const float ra = 1.f / one_minus;\n",
             "#if ABL == 4\n            const float ra = __fdividef(1.f, one_minus);\n#else\n"
             "            const float ra = 1.f / one_minus;\n#endif\n")
    start = ("      float* part = s_part + (warp * kBatch + k) * F;\n"
             "      if (__any_sync(kFullMask, live)) {\n")
    end = ("        if (lane + 32 < F) part[lane + 32] = 0.f;\n      }\n    }\n"
           "    __syncthreads();\n")
    i0 = s.index(start)
    i1 = s.index(end, i0) + len(end)
    committed = s[i0:i1].replace(
        "      if (__any_sync(kFullMask, live)) {\n",
        "      if (__any_sync(kFullMask, live)) {\n        if (lane == 0) ++c_wred;\n", 1)
    walk_only = f"      if (live) {{\n{sink}      }}\n    }}\n    __syncthreads();\n"
    scatter = (f"      constexpr int NV = tdgswarp::reduce_width({nv});\n"
               f"      float* part = s_part + (warp * kBatch + k) * F;\n"
               f"      if (__any_sync(kFullMask, live)) {{\n"
               f"        if (lane == 0) ++c_wred;\n        float v[NV];\n"
               f"#pragma unroll\n        for (int j = {cols}; j < NV; ++j) v[j] = 0.f;\n{fill}"
               f"        tdgswarp::reduce_scatter<NV>(v, lane);\n"
               f"        tdgswarp::store_scattered<NV>(part, v, lane, F);\n"
               f"      }} else {{\n        tdgswarp::store_zero_row(part, lane, F);\n      }}\n"
               f"    }}\n    __syncthreads();\n")
    s = (s[:i0] + "#if ABL == 1\n" + walk_only + "#elif ABL == 2 || ABL == 4 || ABL == 5\n"
         + scatter + "#else\n" + committed + "#endif\n" + s[i1:])
    tail = "  // zero rows: entries no pixel reached, and those past the tile's cut\n"
    return _sub(s, tail, "#if ABL == 1\n  if (sink == 1.2345678e-37f) v_rows[0] = sink;\n#endif\n"
                "#if ABL_COUNT\n  atomicAdd(&g_counts[0], c_eval);\n"
                "  atomicAdd(&g_counts[1], c_live);\n  atomicAdd(&g_counts[2], c_wred);\n"
                "  atomicAdd(&g_counts[3], c_batch);\n#endif\n" + tail)


def tree_variants():
    """{name: (source text, extra flags)}: this tree's kernels 6 and 2, each
    without one part of its design, or with one added."""
    k6 = (_build.CSRC_DIR / "rasterize_2dgs_bwd.cu").read_text()
    k2 = (_build.CSRC_DIR / "rasterize_packed_bwd.cu").read_text()
    counted = _sub(k6, "namespace {\n", COUNTERS + "namespace {\n")
    counted = _sub(counted, "  int b0 = 0;\n",
                   "  unsigned long long c_offered = 0, c_kept = 0, c_live = 0;\n  int b0 = 0;\n")
    counted = _sub(counted, "    const unsigned reach = __ballot_sync(",
                   "    if (lane == 0) c_offered += n;\n    const unsigned reach = __ballot_sync(")
    counted = _sub(counted, "      if (__any_sync(kFullMask, live)) {\n",
                   "      if (lane == 0) ++c_kept;\n      if (__any_sync(kFullMask, live)) {\n"
                   "        if (lane == 0) ++c_live;\n")
    counted = _sub(counted, "  // zero rows: entries no pixel reached",
                   "  if (lane == 0) {\n    atomicAdd(&g_counts[0], c_offered);\n"
                   "    atomicAdd(&g_counts[1], c_kept);\n    atomicAdd(&g_counts[2], c_live);\n"
                   "  }\n  // zero rows: entries no pixel reached")
    k2_cull = _sub(k2, "template <int CMAX, bool HALF_ROWS>\n__global__",
                   CULL_3DGS + "\ntemplate <int CMAX, bool HALF_ROWS>\n__global__")
    k2_cull = _sub(k2_cull, "  const float fy = static_cast<float>(py) + 0.5f;\n",
                   "  const float fy = static_cast<float>(py) + 0.5f;\n" + WARP_BOX)
    k2_cull = _sub(k2_cull, "    const float* s_col = s_batches + buf * BS + 8 * kBatch;\n\n"
                   "    for (int k = 0; k < n; ++k) {\n"
                   "      float* part = s_part + (warp * kBatch + k) * F;\n",
                   "    const float* s_col = s_batches + buf * BS + 8 * kBatch;\n"
                   "    const unsigned reach = __ballot_sync(kFullMask, "
                   "lane < n && may_reach(s_geo[2 * lane], s_geo[2 * lane + 1], x0, x1, y0, y1));"
                   "\n\n    for (int k = 0; k < n; ++k) {\n"
                   "      float* part = s_part + (warp * kBatch + k) * F;\n"
                   "      if (!((reach >> k) & 1u)) {\n"
                   "        tdgswarp::store_zero_row(part, lane, F);\n        continue;\n      }\n")
    return {
        "k6_sync_staging": (_sub(
            k6, "tdgsasync::copy_4(dst + i + (i / F) * (FP - F), src + i);",
            "dst[i + (i / F) * (FP - F)] = src[i];"), []),
        "k6_no_cull": (_sub(k6, "    const unsigned reach = __ballot_sync(kFullMask, may);",
                            "    const unsigned reach = 0xffffffffu;"), []),
        "k6_no_half_rows": (_sub(k6, "TDGS_LAUNCH(7, true)", "TDGS_LAUNCH(8, false)"), []),
        "k6_maxrregcount_64": (k6, ["-maxrregcount=64"]),
        "k6_cull_counters": (counted, []),
        "k2_sync_staging": (_sub(
            k2, "tdgsasync::copy_4(f < 6 ? dst + 8 * lane + f : dst + 8 * kBatch + lane * DP + "
            "(f - 6),\n                          src);",
            "*(f < 6 ? dst + 8 * lane + f : dst + 8 * kBatch + lane * DP + (f - 6)) = *src;"),
            []),
        "k2_no_half_rows": (_sub(k2, "TDGS_LAUNCH(4, true)", "TDGS_LAUNCH(4, false)"), []),
        "k2_with_cull": (k2_cull, []),
        "k2_maxrregcount_64": (k2, ["-maxrregcount=64"]),
    }


def build_all(prev: Path):
    """Every variant, one nvcc each, all started together; {name: CDLL}."""
    OUT.mkdir(parents=True, exist_ok=True)
    # the earlier sources take their own headers first, then this tree's
    # (warp_reduce.cuh); this tree's variants only this tree's
    earlier = ["-I", str(prev), "-I", str(_build.CSRC_DIR)]
    jobs = {}
    for kernel, name in (("k6", "rasterize_2dgs_bwd"), ("k2", "rasterize_packed_bwd")):
        src = OUT / f"ablation_{kernel}.cu"
        src.write_text(ablation_source((prev / f"{name}.cu").read_text(), kernel))
        for m in ABLATION:
            jobs[f"{kernel}_{ABLATION[m]}"] = (src, [f"-DABL={m}", *earlier])
        for m in (0, 3):
            jobs[f"{kernel}_count_{ABLATION[m]}"] = (
                src, [f"-DABL={m}", "-DABL_COUNT=1", *earlier])
    jobs["k8_prev"] = (prev / "rasterize_eval3d_bwd.cu", earlier)
    for name, (text, flags) in tree_variants().items():
        src = OUT / f"{name}.cu"
        src.write_text(text)
        jobs[name] = (src, [*flags, "-I", str(_build.CSRC_DIR)])
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
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
        ctypes.c_int64, ctypes.c_void_p]
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


def compare(kernel, fns, plain, groups, n_valid, reps=20):
    """Each variant against the plain version, a second launch and the
    tree's kernel (``fns["tree"]``); times in turns, there and back."""
    ref = fns["tree"]().clone()
    agree = {}
    for name, fn in fns.items():
        first, second = fn().clone(), fn().clone()
        torch.cuda.synchronize()
        agree[name] = dict(
            max_rel_err_vs_plain={g: C._rel(first[:, c], plain[:, c]) for g, c in groups.items()},
            repeat_bitwise=bool(torch.equal(first, second)),
            bitwise_vs_tree=bool(torch.equal(first, ref)),
            padding_zero=float(first[n_valid:].abs().max()) == 0.0)
    warm_up(fns["tree"])
    order = list(fns)
    times = {name: [] for name in fns}
    for name in order + order[::-1]:
        times[name].append(C.time_ms(fns[name], reps))
    return dict(kernel=kernel, times_ms=times, agree=agree)


def warm_up(fn, seconds=0.5):
    """Runs fn back to back for ``seconds``, so that the card's clocks have
    risen before the first timing."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()


def main(prev_dir: str) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    prev = Path(prev_dir).resolve()
    _build.build(["rasterize_2dgs_fwd", "rasterize_2dgs_bwd", "rasterize_packed_fwd",
                  "rasterize_packed_bwd", "rasterize_eval3d_fwd", "rasterize_eval3d_bwd"])
    libs = build_all(prev)
    print(json.dumps({"device": C.nvidia_smi(), "build_s": time.perf_counter() - t0}),
          flush=True)
    bench = C.to_card(C.bench_scene())
    tc = 1024
    me = max_entries_per_tile(tc)

    # kernel 6 at measure_kernels_2dgs' shapes (RGB+ED, distortion)
    geo, _ = C.kernel_inputs_2dgs(bench, tile_capacity=tc, max_tiles_per_gauss=16,
                                  isect_capacity=C.bench_capacity_2dgs(bench))
    D6 = geo[3]
    train = R2.rasterize_2dgs_train_fwd(*geo, tc, D6 - 1, True)
    g = torch.Generator(device=C.DEVICE).manual_seed(3)
    cot = [torch.randn(x.shape, generator=g, device=C.DEVICE) for x in train[:4]]
    tw6, th6 = R2._check_rows(*geo)

    def k6(lib):
        fn = _entry(lib, "tdgs_rasterize_2dgs_bwd", 11, 10)
        out = torch.empty_like(geo[0])
        return lambda: _call(fn, geo[0], geo[1], *train[:4], *cot, out, 1, C.WIDTH, C.HEIGHT,
                             geo[6], tw6, th6, D6, me, D6 - 1, 1, geo[0].shape[0]) or out

    # kernel 2 at measure_train_kernels' shapes
    args, _, _ = C.kernel_inputs(bench, max_tiles_per_gauss=16,
                                 isect_capacity=C.bench_capacity(bench))
    img, trans = rasterize_packed_train_fwd(*args, tile_capacity=tc)
    g = torch.Generator(device=C.DEVICE).manual_seed(1)
    v_img = torch.randn(img.shape, generator=g, device=C.DEVICE)
    v_t = torch.randn(trans.shape, generator=g, device=C.DEVICE)
    means2d, conics, colors, opac, W, H, ts, offsets, ids = args
    _, I, _, D, tw, th = _check_stream(means2d, conics, colors, opac, W, H, ts, offsets, ids)

    def k2(lib):
        fn = _entry(lib, "tdgs_rasterize_packed_bwd", 11, 8)
        out = torch.empty((ids.shape[0], 6 + D), device=C.DEVICE)
        return lambda: _call(fn, means2d, conics, opac, colors, offsets, ids, img, trans, v_img,
                             v_t, out, I, W, H, ts, tw, th, D, me, ids.shape[0]) or out

    cases = {
        "k6": (k6, lambda: R2.rasterize_2dgs_bwd(*geo, *train[:4], *cot, tc, D6 - 1, True),
               R2.rasterize_2dgs_bwd_plain(*geo, *train[:4], *cot, tc, D6 - 1, True),
               GROUPS_2DGS, int(geo[1][-1])),
        "k2": (k2, lambda: rasterize_packed_bwd(*args, img, trans, v_img, v_t,
                                                tile_capacity=tc),
               rasterize_packed_bwd_plain(*args, img, trans, v_img, v_t, tile_capacity=tc),
               C.GROUPS, int(offsets[-1])),
    }
    designs = [name for name in tree_variants() if not name.endswith("_counters")]
    for kernel, (make, tree, plain, groups, n_valid) in cases.items():
        fns = {f"{kernel}_{v}": make(libs[f"{kernel}_{v}"]) for v in ABLATION.values()}
        fns.update({name: make(libs[name]) for name in designs
                    if name.startswith(f"{kernel}_")})
        fns["tree"] = tree
        result = compare(kernel, fns, plain, groups, n_valid)
        result["counts"] = {
            # (pixel, entry) evaluations, live ones, warp-entries with a live
            # lane, batches
            **{v: _counts(libs[f"{kernel}_count_{v}"], make(libs[f"{kernel}_count_{v}"]))
               for v in (ABLATION[0], ABLATION[3])},
        }
        if kernel == "k6":
            # warp-entries offered to the cull, kept, with a live lane
            result["counts"]["tree_cull"] = _counts(libs["k6_cull_counters"],
                                                    make(libs["k6_cull_counters"]))[:3]
        print(json.dumps(result), flush=True)

    # kernel 8 at measure_kernels_eval3d's shapes: bitwise against the
    # earlier build
    geo8, _ = C.kernel_inputs_eval3d(bench, tile_capacity=tc, max_tiles_per_gauss=16,
                                     isect_capacity=C.bench_capacity(bench))
    stream = geo8[:9]
    img8, T8 = E.rasterize_eval3d_train_fwd(*stream, tc)
    g = torch.Generator(device=C.DEVICE).manual_seed(5)
    v_img8 = torch.randn(img8.shape, generator=g, device=C.DEVICE)
    v_T8 = torch.randn(T8.shape, generator=g, device=C.DEVICE)
    rows8, d8, o8, offsets8, I8, D8, W8, H8, ts8 = stream
    tw8, th8 = E._check_inputs(*stream)
    fn8 = _entry(libs["k8_prev"], "tdgs_rasterize_eval3d_bwd", 11, 8)
    v_rows8, v_d8 = torch.empty_like(rows8), torch.empty_like(d8)

    def prev8():
        _call(fn8, rows8, d8, o8, offsets8, img8, T8, v_img8, v_T8, v_rows8, v_d8, None, I8, W8,
              H8, ts8, tw8, th8, D8, me, rows8.shape[0])
        return torch.cat([v_rows8.reshape(-1), v_d8.reshape(-1)])

    def tree8():
        v_rows, v_d = E.rasterize_eval3d_bwd(*stream, img8, T8, v_img8, v_T8, tc)[:2]
        return torch.cat([v_rows.reshape(-1), v_d.reshape(-1)])

    fns = {"k8_prev": prev8, "tree": tree8}
    ref, old = fns["tree"]().clone(), fns["k8_prev"]().clone()
    torch.cuda.synchronize()
    warm_up(tree8)
    times = {name: [] for name in fns}
    for name in ["k8_prev", "tree", "tree", "k8_prev"]:
        times[name].append(C.time_ms(fns[name], 20))
    print(json.dumps(dict(kernel="k8", times_ms=times, bitwise_vs_prev=bool(torch.equal(ref, old)),
                          device=C.nvidia_smi(), seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
