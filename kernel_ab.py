"""Ablation and A/B of the compositing kernels 7 (eval3d) and 1 (packed
3DGS) on the card, against the sources of an earlier commit, at the bench
frame's shapes and, for kernel 1, at the rally frame's.

    git archive 6965681 tdgs_torch/csrc | tar -x -C tdgs_torch/build/prev
    python3 kernel_ab.py tdgs_torch/build/prev/tdgs_torch/csrc

The ablation's patches anchor on the kernels' designs at commit 6965681,
before their redesign. Builds with nvcc, one process per variant, all
started together:
- from the earlier kernel 7, the ablation variants (a) as it was, (b) batch
  0 staged once and walked for every batch, (c) sigma* with __fdividef in
  place of the IEEE division (timing only), and a counting build of (a);
  from the earlier kernel 1, (a), (b) and a counting build. A counting
  build reads, per warp and entry offered, whether a lane of the warp
  reaches alpha >= 1/255 there (with and without its own cutoff): the
  ceiling of any per-warp cull. Kernel 1's timeline build records each
  block's start and end on the card's global timer.
- from this tree's kernels 7 and 1, a build as they are (called as every
  variant is, into one output made beforehand: the yardstick of the
  variants; "tree" goes through the wrapper), each design without its
  cull, with synchronous staging, and a counting build of its cull's kept
  share.
- the earlier and this tree's kernels 2, 8, 9 and 10, which share headers
  with the redesigns: their bits and their times.
Each kernel's variants run on the same inputs and are timed twice by
chip_smoke.time_ms and twice by chip_smoke.graph_ms, in turns from the
first to the last and back. Their outputs are held against the plain
version, against a second launch (bit for bit) and against this tree's
kernel. Prints one JSON line per kernel and shape. Needs a CUDA card; the
port does not use this script.
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
from tdgs_torch.ops import rasterize_eval3d_packed as E
from tdgs_torch.ops import rasterize_packed as P
from tdgs_torch.ops import rasterize_pallas as RP

OUT = _build.BUILD_DIR / "kernel_ab"
ABLATION_K7 = {0: "a_committed", 1: "b_batch0_staged_once", 2: "c_fast_division"}
ABLATION_K1 = {0: "a_committed", 1: "b_batch0_staged_once"}
N_COUNTS = 8
SPLITS = (1, 2, 4, 8)  # kernel 1's blocks a tile, forced through the wrapper
PTXAS = {}  # variant -> {kernel entry: registers} of its build
MAX_BLOCKS = 1 << 15

# counters a counting build adds: N_COUNTS sums over the launch
COUNTERS = f'''
__device__ unsigned long long g_counts[{N_COUNTS}];
extern "C" int abl_counts(unsigned long long* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_counts, sizeof(g_counts));
}}
extern "C" int abl_reset() {{
  unsigned long long z[{N_COUNTS}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_counts, z, sizeof(z));
}}
'''

# a timeline build's record: each block's start and end, in ns
TIMELINE = f'''
__device__ unsigned long long g_span[2 * {MAX_BLOCKS}];
__device__ __forceinline__ unsigned long long abl_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
extern "C" int abl_spans(unsigned long long* out, int n) {{
  return (int)cudaMemcpyFromSymbol(out, g_span, 2 * sizeof(unsigned long long) * n);
}}
'''

ABL_HEAD = "#ifndef ABL\n#define ABL 0\n#endif\n#if ABL_COUNT\n" + COUNTERS + "#endif\n"

# the walk of a counting build: every lane evaluates every entry offered,
# the warp votes, lane 0 counts (offered, with a lane reaching alpha >=
# 1/255, with such a lane not yet past its cutoff, with a lane walking)
# and each walking pixel counts its evaluations and live ones
COUNT_VOTE = '''
      const unsigned v_any = __ballot_sync(0xffffffffu, inside && pass);
      const unsigned v_live = __ballot_sync(0xffffffffu, !done && pass);
      const unsigned v_walk = __ballot_sync(0xffffffffu, !done);
      if ((threadIdx.x & 31) == 0) {
        ++c_offered;
        c_any += v_any != 0u;
        c_live_warp += v_live != 0u;
        c_walk_warp += v_walk != 0u;
      }
      if (done) continue;
      ++c_eval;
      if (!pass) continue;
      ++c_live;
'''

COUNT_DECL = ("  unsigned long long c_offered = 0, c_any = 0, c_live_warp = 0, c_walk_warp = 0, "
              "c_eval = 0, c_live = 0;\n")
COUNT_FLUSH = '''#if ABL_COUNT
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&g_counts[0], c_offered);
    atomicAdd(&g_counts[1], c_any);
    atomicAdd(&g_counts[2], c_live_warp);
    atomicAdd(&g_counts[3], c_walk_warp);
  }
  atomicAdd(&g_counts[4], c_eval);
  atomicAdd(&g_counts[5], c_live);
#endif
'''
COUNT_NAMES = ("warp_entries_offered", "with_a_lane_reaching_1_255",
               "with_such_a_lane_before_its_cutoff", "with_a_lane_walking",
               "pixel_entry_evaluations", "live_evaluations")


def _sub(text, old, new):
    if text.count(old) != 1:
        raise ValueError(f"patch anchor found {text.count(old)} times: {old[:60]!r}")
    return text.replace(old, new)


def _between(text, first, last):
    """(start, end) of the span from ``first`` to the end of ``last``."""
    i0 = text.index(first)
    return i0, text.index(last, i0) + len(last)


def ablation_k7_source(text, common):
    """The earlier kernel 7 with the ABL switch: (b) batch 0 staged once,
    (c) sigma* divided by __fdividef (its header inlined and patched), and
    with ABL_COUNT the counting walk."""
    s = _sub(text, "namespace {\n", ABL_HEAD + "namespace {\n")
    common = _sub(common, "#pragma once\n", "")
    common = _sub(common, "__fdiv_rn(cc, s.rr)",
                  "\n#if ABL == 2\n__fdividef(cc, s.rr)\n#else\n__fdiv_rn(cc, s.rr)\n#endif\n")
    s = _sub(s, '#include "rasterize_eval3d_common.cuh"\n', common)
    copy = "    for (int i = tid; i < n * F; i += block) s_rows[i] = src[i];\n"
    s = _sub(s, copy, "#if ABL == 1\n    if (b0 == 0)\n#endif\n" + copy)
    first = "    for (int k = 0; k < n && !done; ++k) {\n"
    last = "      T = next_T;\n    }\n"
    i0, i1 = _between(s, first, last)
    counting = ('''    for (int k = 0; k < n; ++k) {
      const float* row = s_rows + k * F;
      Response s;
      const float sigma = ray_sigma<CENTRAL>(row, d, o, s);
      const float alpha = fminf(kAlphaClamp, __fmul_rn(row[12], expf(-sigma)));
      const bool pass = s.gr < 0.f && !(alpha < kAlphaThreshold);
''' + COUNT_VOTE + '''      const float next_T = __fmul_rn(T, __fsub_rn(1.f, alpha));
      if (next_T <= kTransmittanceEps) {
        done = true;
        continue;
      }
      const float w = __fmul_rn(alpha, T);
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < D) acc[c] += w * row[kGeomCols + c];
      }
      T = next_T;
    }
''')
    s = s[:i0] + "#if ABL_COUNT\n" + counting + "#else\n" + s[i0:i1] + "#endif\n" + s[i1:]
    s = _sub(s, "  for (int b0 = 0; b0 < count; b0 += block) {\n",
             "#if ABL_COUNT\n" + COUNT_DECL + "#endif\n"
             "  for (int b0 = 0; b0 < count; b0 += block) {\n")
    return _sub(s, "  if (!inside) return;\n", COUNT_FLUSH + "  if (!inside) return;\n")


def ablation_k1_source(text):
    """The earlier kernel 1 with the ABL switch: (b) batch 0 staged once,
    with ABL_COUNT the counting walk, with ABL_TIMELINE each block's span."""
    s = _sub(text, "namespace {\n", ABL_HEAD + "#if ABL_TIMELINE\n" + TIMELINE + "#endif\n"
             "namespace {\n")
    s = _sub(s, "    if (e < count) {\n",
             "#if ABL == 1\n    if (b0 == 0 && e < count) {\n#else\n    if (e < count) {\n"
             "#endif\n")
    first = "    for (int k = 0; k < n && !done; ++k) {\n"
    last = "      T = next_T;\n    }\n"
    i0, i1 = _between(s, first, last)
    counting = ('''    for (int k = 0; k < n; ++k) {
      const float2 xy = s_xy[k];
      const float dx = __fsub_rn(xy.x, fx);
      const float dy = __fsub_rn(xy.y, fy);
      const float quad = __fadd_rn(
          __fmul_rn(__fmul_rn(s_conic[3 * k], dx), dx),
          __fmul_rn(__fmul_rn(s_conic[3 * k + 2], dy), dy));
      const float sigma = __fadd_rn(
          __fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(s_conic[3 * k + 1], dx), dy));
      const float alpha = fminf(kAlphaClamp, __fmul_rn(s_op[k], expf(-sigma)));
      const bool pass = !(sigma < 0.f) && !(alpha < kAlphaThreshold);
''' + COUNT_VOTE + '''      const float next_T = __fmul_rn(T, __fsub_rn(1.f, alpha));
      if (next_T <= kTransmittanceEps) {
        done = true;
        continue;
      }
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < D) acc[c] += w * s_col[k * D + c];
      }
      T = next_T;
    }
''')
    s = s[:i0] + "#if ABL_COUNT\n" + counting + "#else\n" + s[i0:i1] + "#endif\n" + s[i1:]
    s = _sub(s, "  for (int b0 = 0; b0 < count; b0 += block) {\n",
             "#if ABL_COUNT\n" + COUNT_DECL + "#endif\n#if ABL_TIMELINE\n"
             "  const unsigned long long t_start = abl_now();\n#endif\n"
             "  for (int b0 = 0; b0 < count; b0 += block) {\n")
    return _sub(s, "  if (!inside) return;\n",
                COUNT_FLUSH + "#if ABL_TIMELINE\n  __syncthreads();\n  if (tid == 0 && t < "
                f"{MAX_BLOCKS}) {{\n    g_span[2 * t] = t_start;\n    g_span[2 * t + 1] = "
                "abl_now();\n  }\n#endif\n  if (!inside) return;\n")


def _inline(text, include, header):
    """``text`` with ``#include "<include>"`` replaced by ``header``'s text."""
    return _sub(text, f'#include "{include}"\n', _sub(header, "#pragma once\n", ""))


def _sync_row_stage():
    """row_stage.cuh with synchronous copies in place of cp.async."""
    stage = (_build.CSRC_DIR / "row_stage.cuh").read_text()
    dst = "f < G ? batch + GP * lane + f : batch + GP * kBatch + lane * DP + (f - G)"
    stage = _sub(stage, f"      tdgsasync::copy_4({dst},\n                        src(f));",
                 f"      *({dst}) = *src(f);")
    stage = _sub(stage, "        tdgsasync::copy_16(batch + GP * lane + 4 * u, row + 4 * u);",
                 "        *reinterpret_cast<float4*>(batch + GP * lane + 4 * u) = "
                 "*reinterpret_cast<const float4*>(row + 4 * u);")
    return _sub(stage, f"        tdgsasync::copy_4({dst},\n                          row + f);",
                f"        *({dst}) = row[f];")


# kernel 7's counting build: per warp and batch, the entries offered, kept
# by ray_cull.cuh, and kept by the three bounds it was chosen against -- the
# box sphere (below), (i) a cone about a of chord radius delta = max
# |u_i - a| against the same sphere, (ii) the cone against the silhouette
# quadric, first order in delta -- then the (pixel, entry) evaluations
CONE_BOUNDS = """// the box sphere: the entry's bounding sphere, radius sqrt(2 (tau_0 +
// 0.25)) max(s) about mu, mu - o_ref = -M^T diag(1 / |M_i|^2) g0 (rows of M
// orthogonal to 1e-5, checked), against the pyramid of the warp's slope box
__device__ __forceinline__ bool abl_box_sphere(const float4* q, const tdgsraycull::WarpRays& w) {
  using namespace tdgsraycull;
  const float4 q0 = q[0], q1 = q[1], q2 = q[2];
  const float op = q[3].x;
  // alpha <= op at every ray: below 1/255 everywhere
  if (op < (1.0f / 255.0f)) return false;
  if (!w.ok) return true;
  const float m0[3] = {q0.x, q0.y, q0.z}, m1[3] = {q0.w, q1.x, q1.y},
              m2[3] = {q1.z, q1.w, q2.x};
  const float g0[3] = {q2.y, q2.z, q2.w};
  const float n0 = dot3(m0, m0), n1 = dot3(m1, m1), n2 = dot3(m2, m2);
  const float mn = fminf(fminf(n0, n1), n2), mx = fmaxf(fmaxf(n0, n1), n2);
  const float d01 = dot3(m0, m1), d02 = dot3(m0, m2), d12 = dot3(m1, m2);
  // rows nonzero, below 1e12, orthogonal to 1e-5 (NaN fails)
  if (!(mn > 0.f && mx < 1e24f && d01 * d01 <= 1e-10f * n0 * n1 &&
        d02 * d02 <= 1e-10f * n0 * n2 && d12 * d12 <= 1e-10f * n1 * n2)) {
    return true;
  }
  // mu - o_ref = -M^T diag(1 / |M_i|^2) g0; c from the warp's apex
  const float w0 = g0[0] / n0, w1 = g0[1] / n1, w2 = g0[2] / n2;
  float c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = -(w0 * m0[k] + w1 * m1[k] + w2 * m2[k]) - w.oc[k];
  const float smax = rsqrtf(mn) * (1.f + 1e-6f);
  const float cond = smax * sqrtf(mx);
  const float g0n = sqrtf(dot3(g0, g0));
  // |g| along any ray of the warp: g0 + M o'
  const float gmag = g0n + sqrtf(3.f * mx) * (sqrtf(dot3(w.oc, w.oc)) + w.odev);
  // past 1e25 the walk's products g r could overflow into a NaN sigma*
  if (!(gmag < 1e25f)) return true;
  // each ray's r = M d turns its direction by up to 9 eps cond: its slopes
  // by up to 32 eps cond (slopes <= 1)
  const float eta = 32.f * kEps * cond;
  const float S = w.S + eta, G = w.G + eta;
  const float kS = rsqrtf(1.f + S * S), kG = rsqrtf(1.f + G * G);
  const float ca = fabsf(dot3(c, w.a)), cb = fabsf(dot3(c, w.b)), cn = fabsf(dot3(c, w.n));
  const float lb = fmaxf((cb - S * ca) * kS, (cn - G * ca) * kG);
  const float rho = sqrtf(2.f * (__logf(255.f * op) + 0.25f));
  const float cm = sqrtf(dot3(c, c));
  // the sphere's radius with the walk's rounding, M's orthogonality (the
  // centre within 4e-5 max(s) |g0|), the apexes' spread and the cull's own
  // rounding
  const float R = smax * (rho + 8.f * kEps * gmag) * (1.f + 1e-4f) + 4e-5f * smax * g0n + w.odev +
                  1e-5f * (cm + smax * g0n);
  return !(lb > R);
}



__device__ __forceinline__ float abl_delta(const float* d, bool inside, const float* a) {
  const float inv = rsqrtf(tdgsraycull::dot3(d, d));
  const float e[3] = {d[0] * inv - a[0], d[1] * inv - a[1], d[2] * inv - a[2]};
  return tdgsraycull::warp_max(inside ? sqrtf(tdgsraycull::dot3(e, e)) : 0.f) * (1.f + 1e-5f)
         + 1e-6f;
}
// 0: kept by neither bound, 1: (i) keeps, 2: (ii) keeps, 3: both keep
__device__ __forceinline__ int abl_cone_keeps(const float4* q, const tdgsraycull::WarpRays& w,
                                              float delta) {
  using namespace tdgsraycull;
  const float4 q0 = q[0], q1 = q[1], q2 = q[2];
  const float op = q[3].x;
  if (op < (1.0f / 255.0f)) return 0;
  const float m0[3] = {q0.x, q0.y, q0.z}, m1[3] = {q0.w, q1.x, q1.y}, m2[3] = {q1.z, q1.w, q2.x};
  const float g0[3] = {q2.y, q2.z, q2.w};
  const float n0 = dot3(m0, m0), n1 = dot3(m1, m1), n2 = dot3(m2, m2);
  const float mn = fminf(fminf(n0, n1), n2), mx = fmaxf(fmaxf(n0, n1), n2);
  if (!(w.ok && mn > 0.f && mx < 1e24f && delta < 1.f)) return 3;
  const float rho = sqrtf(2.f * (__logf(255.f * op) + 0.25f));
  const float g0n = sqrtf(dot3(g0, g0));
  const float gmag = g0n + sqrtf(3.f * mx) * (sqrtf(dot3(w.oc, w.oc)) + w.odev);
  const float smax = rsqrtf(mn) * (1.f + 1e-6f);
  // (i): |c x u| >= |c x a| - |c| (delta + the walk's turn of r)
  const float w0 = g0[0] / n0, w1 = g0[1] / n1, w2 = g0[2] / n2;
  float c[3];
  for (int k = 0; k < 3; ++k) c[k] = -(w0 * m0[k] + w1 * m1[k] + w2 * m2[k]) - w.oc[k];
  const float cx[3] = {c[1] * w.a[2] - c[2] * w.a[1], c[2] * w.a[0] - c[0] * w.a[2],
                       c[0] * w.a[1] - c[1] * w.a[0]};
  const float cm = sqrtf(dot3(c, c));
  const float lb = sqrtf(dot3(cx, cx)) - cm * (delta + 16.f * kEps * smax * sqrtf(mx));
  const float R = smax * (rho + 8.f * kEps * gmag) * (1.f + 1e-4f) + 4e-5f * smax * g0n + w.odev
                  + 1e-5f * (cm + smax * g0n);
  const bool keep_i = !(lb > R);
  // (ii): in the canonical frame, g_c = g0 + M o_c, r_a = M a, |M| <= |M|_F
  float gc[3], ra[3];
  const float* m[3] = {m0, m1, m2};
  for (int i = 0; i < 3; ++i) {
    gc[i] = g0[i] + dot3(m[i], w.oc);
    ra[i] = dot3(m[i], w.a);
  }
  const float mf = sqrtf(n0 + n1 + n2);
  const float x[3] = {gc[1] * ra[2] - gc[2] * ra[1], gc[2] * ra[0] - gc[0] * ra[2],
                      gc[0] * ra[1] - gc[1] * ra[0]};
  const float de = delta + 9.f * kEps;
  const float gcn = sqrtf(dot3(gc, gc));
  const float L = (sqrtf(dot3(x, x)) * (1.f - 1e-5f) - gcn * mf * de)
                  / (sqrtf(dot3(ra, ra)) * (1.f + 1e-5f) + mf * de)
                  - mf * w.odev - 8.f * kEps * gmag;
  const bool keep_ii = !(L > rho * (1.f + 1e-5f));
  return (keep_i ? 1 : 0) + (keep_ii ? 2 : 0);
}
"""


def tree_variants():
    """{name: source text}: this tree's kernels 7 and 1 as they are, each
    without one part of its design, or with one changed; counting builds
    end in _counters."""
    k7 = (_build.CSRC_DIR / "rasterize_eval3d_fwd.cu").read_text()
    k1 = (_build.CSRC_DIR / "rasterize_packed_fwd.cu").read_text()
    walk = (_build.CSRC_DIR / "composite_walk.cuh").read_text()
    sync_stage = _sync_row_stage()
    k7_cull = "lane < n && tdgsraycull::may_reach(s_geo + 4 * lane, s_rays[warp])"
    i0, i1 = _between(k7, "  __shared__ tdgsraycull::WarpRays s_rays[32];\n",
                      "    if (lane == 0) s_rays[warp] = w;\n  }\n")
    frame = k7[i0:i1]
    k7_count = _sub(k7, "namespace {\n", COUNTERS + "namespace {\n")
    k7_count = _sub(k7_count, "template <int CMAX, bool CENTRAL>\n__global__",
                    CONE_BOUNDS + "template <int CMAX, bool CENTRAL>\n__global__")
    k7_count = _sub(k7_count, "  if (count > 0) stage(0, s_batches);\n",
                    "  unsigned long long c_offered = 0, c_kept = 0, c_i = 0, c_ii = 0, c_eval = 0, "
                    "c_s = 0;\n"
                    "  __syncwarp();\n"
                    "  const float delta = abl_delta(d, inside, s_rays[warp].a);\n"
                    "  if (count > 0) stage(0, s_batches);\n")
    k7_count = _sub(k7_count, "    while (todo != 0u) {\n",
                    "    {\n      const int alt = lane < n ? abl_cone_keeps(s_geo + 4 * lane, "
                    "s_rays[warp], delta) : 0;\n      const unsigned k_i = __ballot_sync(kFullMask, "
                    "alt & 1), k_ii = __ballot_sync(kFullMask, alt & 2), k_s = __ballot_sync("
                    "kFullMask, lane < n && abl_box_sphere(s_geo + 4 * lane, s_rays[warp]));\n"
                    "      if (lane == 0) {\n"
                    "        c_offered += n;\n        c_kept += __popc(todo);\n"
                    "        c_i += __popc(k_i);\n        c_ii += __popc(k_ii);\n"
                    "        c_s += __popc(k_s);\n      }\n    }\n"
                    "    while (todo != 0u) {\n")
    k7_count = _sub(k7_count, "      if (done) continue;\n      float row[16];\n",
                    "      if (done) continue;\n      ++c_eval;\n      float row[16];\n")
    k7_count = _sub(k7_count, "  tdgsasync::wait<0>();  // a batch still in flight after an early "
                    "exit\n", "  tdgsasync::wait<0>();\n  if (lane == 0) {\n"
                    "    atomicAdd(&g_counts[0], c_offered);\n    atomicAdd(&g_counts[1], c_kept);\n"
                    "    atomicAdd(&g_counts[2], c_i);\n    atomicAdd(&g_counts[3], c_ii);\n"
                    "    atomicAdd(&g_counts[5], c_s);\n  }\n"
                    "  atomicAdd(&g_counts[4], c_eval);\n")
    k1_cull = ("lane < n && tdgscull::may_reach(s_geo[2 * lane], s_geo[2 * lane + 1], pix.x0, "
               "pix.x1,\n                                        pix.y0, pix.y1)")
    k1_count = _sub(walk, "namespace tdgswalk {\n", COUNTERS + "namespace tdgswalk {\n")
    k1_count = _sub(k1_count, "  if (count > 0) stage(0, s_batches);\n",
                    "  unsigned long long c_offered = 0, c_kept = 0, c_eval = 0;\n"
                    "  if (count > 0) stage(0, s_batches);\n")
    k1_count = _sub(k1_count, "    while (todo != 0u) {\n",
                    "    if (lane == 0) {\n      c_offered += n;\n      c_kept += __popc(todo);\n"
                    "    }\n    while (todo != 0u) {\n")
    k1_count = _sub(k1_count, "      if (!done) {\n", "      if (!done) {\n        ++c_eval;\n")
    k1_count = _sub(k1_count, "  tdgsasync::wait<0>();  // a batch still in flight after an early "
                    "exit\n", "  tdgsasync::wait<0>();\n  if (lane == 0) {\n"
                    "    atomicAdd(&g_counts[0], c_offered);\n    atomicAdd(&g_counts[1], c_kept);\n"
                    "  }\n  atomicAdd(&g_counts[4], c_eval);\n")
    return {
        # built and called as every variant is: the fair yardstick for them
        "k7_as_is": k7,
        "k1_as_is": k1,
        "k7_no_cull": _sub(k7, k7_cull, "lane < n"),
        "k7_sphere_cull": _sub(_sub(k7, "template <int CMAX, bool CENTRAL>\n__global__",
                                    CONE_BOUNDS + "template <int CMAX, bool CENTRAL>\n__global__"),
                               k7_cull, k7_cull.replace("tdgsraycull::may_reach",
                                                        "abl_box_sphere")),
        "k7_frame_in_registers": _sub(_sub(k7, frame, "  const tdgsraycull::WarpRays s_rays_w = "
                                           "tdgsraycull::warp_rays<CENTRAL>(d, o, inside, "
                                           "min(tile_size, 32));\n"),
                                      k7_cull, k7_cull.replace("s_rays[warp]", "s_rays_w")),
        "k7_sync_staging": _inline(k7, "row_stage.cuh", sync_stage),
        "k7_4_byte_copies": _sub(k7, "  const int wide = (kGeomCols", "  const int wide = 0 && ("
                                 "kGeomCols"),
        "k7_cull_counters": k7_count,
        "k1_no_cull": _inline(k1, "composite_walk.cuh", _sub(walk, k1_cull, "lane < n")),
        "k1_sync_staging": _inline(k1, "composite_walk.cuh",
                                   _inline(walk, "row_stage.cuh", sync_stage)),
        "k1_cull_counters": _inline(k1, "composite_walk.cuh", k1_count),
        "k7_uncapped_registers": _sub(k7, "__maxnreg__(max_registers(CMAX)) ", ""),
        "k1_timeline": _sub(_sub(_sub(k1, "namespace {\n", TIMELINE + "namespace {\n"),
                                 "  const bool inside = px < width && py < height;\n",
                                 "  const bool inside = px < width && py < height;\n"
                                 "  const unsigned long long t_start = abl_now();\n"),
                            "  if (!inside) return;\n",
                            "  __syncthreads();\n  if (tid == 0 && blockIdx.x < "
                            f"{MAX_BLOCKS}) {{\n    g_span[2 * blockIdx.x] = t_start;\n"
                            "    g_span[2 * blockIdx.x + 1] = abl_now();\n  }\n"
                            "  if (!inside) return;\n"),
    }


# kernels whose sources did not change in design but share headers with the
# redesigns: (source, this tree's entry) timed against the earlier build
KEPT = ("rasterize_packed_bwd", "rasterize_eval3d_bwd", "rasterize_dense_fwd",
        "rasterize_dense_bwd")


def build_all(prev: Path):
    """Every variant, one nvcc each, all started together; {name: CDLL}."""
    OUT.mkdir(parents=True, exist_ok=True)
    earlier = ["-I", str(prev)]
    jobs = {}
    src = OUT / "ablation_k7.cu"
    src.write_text(ablation_k7_source((prev / "rasterize_eval3d_fwd.cu").read_text(),
                                      (prev / "rasterize_eval3d_common.cuh").read_text()))
    for m, variant in ABLATION_K7.items():
        jobs[f"k7_{variant}"] = (src, [f"-DABL={m}", *earlier])
    jobs["k7_count_a_committed"] = (src, ["-DABL=0", "-DABL_COUNT=1", *earlier])
    src = OUT / "ablation_k1.cu"
    src.write_text(ablation_k1_source((prev / "rasterize_packed_fwd.cu").read_text()))
    for m, variant in ABLATION_K1.items():
        jobs[f"k1_{variant}"] = (src, [f"-DABL={m}", *earlier])
    jobs["k1_count_a_committed"] = (src, ["-DABL=0", "-DABL_COUNT=1", *earlier])
    jobs["k1_timeline_a_committed"] = (src, ["-DABL=0", "-DABL_TIMELINE=1", *earlier])
    for name in KEPT:
        jobs[f"earlier_{name}"] = (prev / f"{name}.cu", earlier)
    # the earlier kernel 9 on this tree's headers: its own walk beside the
    # shared one
    src = OUT / "k9_own_walk.cu"
    src.write_text((prev / "rasterize_dense_fwd.cu").read_text())
    jobs["k9_own_walk"] = (src, ["-I", str(_build.CSRC_DIR)])
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
            print(json.dumps({"nvcc_failed": name, "log": log[-2000:]}), flush=True)
            continue
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        PTXAS[name] = _registers(log)
    return libs


def _registers(log):
    """{kernel entry: registers} from ptxas's -v output."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and "registers" in line and entry is not None:
            out[entry] = int(line.split("Used")[1].split("registers")[0])
    return out


def _call(fn, *args):
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args], stream)
    if err != 0:
        raise RuntimeError(f"launch failed with cudaError_t {err}")


def _entry(lib, name, n_ptrs, n_ints, slots=False):
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + ([ctypes.c_int64] if slots else []) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _counts(lib, run, names=COUNT_NAMES):
    """A counting build's sums over one launch, by slot: {name: sum} for
    each named slot (None skips one)."""
    lib.abl_counts.argtypes = [ctypes.c_void_p]
    lib.abl_reset()
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * N_COUNTS)()
    lib.abl_counts(buf)
    return {name: v for name, v in zip(names, list(buf)) if name is not None}


def _timeline(lib, run, n_blocks, counts, blocks_a_tile=1):
    """Each block's span from a timeline build: the launch's span, the
    longest block's and the entries of the longest blocks' tiles."""
    run()
    torch.cuda.synchronize()
    n = min(n_blocks, MAX_BLOCKS)
    buf = (ctypes.c_ulonglong * (2 * n))()
    lib.abl_spans.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.abl_spans(buf, n)
    span = torch.tensor(list(buf), dtype=torch.float64).reshape(n, 2)
    dur = (span[:, 1] - span[:, 0]) * 1e-6
    longest = torch.argsort(dur, descending=True)[:10]
    return dict(launch_ms=float((span[:, 1].max() - span[:, 0].min()) * 1e-6),
                longest_block_ms=float(dur.max()), mean_block_ms=float(dur.mean()),
                p99_block_ms=float(dur.quantile(0.99)),
                longest_blocks_entries=[int(counts[i // blocks_a_tile]) for i in longest])


def _flat(out):
    return torch.cat([o.reshape(-1) for o in out]) if isinstance(out, tuple) else out


def compare(kernel, fns, plain=None, reps=20):
    """Each variant against the plain version (max|Δ|), a second launch and
    the tree's kernel (``fns["tree"]``) bit for bit. Times in turns, there
    and back, by CUDA events around back-to-back calls and by the replay
    of the same calls from a CUDA graph."""
    ref = _flat(fns["tree"]()).clone()
    agree = {}
    for name, fn in fns.items():
        first, second = _flat(fn()).clone(), _flat(fn()).clone()
        torch.cuda.synchronize()
        agree[name] = dict(repeat_bitwise=bool(torch.equal(first, second)),
                           bitwise_vs_tree=bool(torch.equal(first, ref)))
        if plain is not None:
            agree[name]["max_abs_err_vs_plain"] = C._abs_err(first, _flat(plain))
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


def tile_stats(offsets, max_entries):
    """The distribution of entries per tile."""
    n = torch.clamp(torch.diff(offsets.long()), 0, max_entries).double()
    return dict(tiles=int(n.numel()), entries=int(n.sum()), mean=float(n.mean()),
                p50=float(n.quantile(0.5)), p99=float(n.quantile(0.99)), max=float(n.max()),
                empty=int((n == 0).sum()),
                top_1pct_share=float(torch.sort(n, descending=True)[0][:max(1, n.numel() // 100)]
                                     .sum() / max(float(n.sum()), 1.0)))


# the slots of this tree's counting builds: kernel 7's, then kernel 1's
K7_CULL_NAMES = ("warp_entries_offered", "kept", "kept_by_cone_sphere", "kept_by_cone_quadric",
                 "pixel_entry_evaluations", "kept_by_box_sphere")
K1_CULL_NAMES = ("warp_entries_offered", "kept", None, None, "pixel_entry_evaluations")


def run_k7(libs, bench, cap, shape="bench"):
    """Kernel 7's inference call (no background, as the bench render) at
    the bench shape, or with ``shape="bench_rolling_shutter"`` at
    chip_smoke's rolling-shutter case; returns its inputs."""
    rs = C.rolling_shutter_kw(bench) if shape == "bench_rolling_shutter" else {}
    geo, _ = C.kernel_inputs_eval3d(bench, tile_capacity=1024, max_tiles_per_gauss=16,
                                    isect_capacity=cap, **rs)
    rows, d, o, offsets, I, D, W, H, ts = geo
    tw, th = -(-W // ts), -(-H // ts)
    max_e = P.max_entries_per_tile(1024)
    p_img, p_T, _ = E.rasterize_eval3d_fwd_plain(*geo, 1024)
    plain = (p_img, 1.0 - p_T)

    def k7(lib):
        fn = _entry(lib, "tdgs_rasterize_eval3d_fwd", 7, 9)
        out_c, out_a = torch.empty_like(p_img), torch.empty_like(p_T)
        return lambda: _call(fn, rows, d, o, offsets, None, out_c, out_a, I, W, H, ts, tw, th,
                             D, max_e, 0) or (out_c, out_a)

    fns = {name: k7(lib) for name, lib in libs.items()
           if name.startswith("k7_") and "count" not in name}
    fns["tree"] = lambda: tuple(x.reshape(-1) for x in E.rasterize_eval3d_inference(
        *geo, None, 1024))
    result = compare("k7", fns, tuple(x.reshape(-1) for x in plain))
    counts = {"a_committed": _counts(libs["k7_count_a_committed"],
                                     k7(libs["k7_count_a_committed"]))}
    if "k7_cull_counters" in libs:
        counts["tree_cull"] = _counts(libs["k7_cull_counters"], k7(libs["k7_cull_counters"]),
                                      K7_CULL_NAMES)
    result.update(shape=shape, stream=tile_stats(offsets, max_e), counts=counts)
    print(json.dumps(result), flush=True)
    return geo


def run_k1(libs, shape, args, bg, splits=()):
    """Kernel 1's inference call at one shape (``args`` from
    chip_smoke.kernel_inputs), and through the wrapper at each of
    ``splits`` blocks a tile."""
    means2d, conics, colors, opac, W, H, ts, offsets, ids = args
    D = colors.shape[-1]
    tw, th = -(-W // ts), -(-H // ts)
    max_e = P.max_entries_per_tile(1024)
    plain = P.rasterize_to_pixels_packed_inference_plain(*args, backgrounds=bg)
    # this tree's builds cut tiles into the blocks the wrapper does
    P.rasterize_to_pixels_packed_inference(*args, backgrounds=bg)
    n_split = P.BLOCKS_A_TILE[P.KERNEL]

    def k1(lib, earlier=False):
        fn = _entry(lib, "tdgs_rasterize_packed_fwd", 9, 9 if earlier else 10)
        out_c, out_a = torch.empty_like(plain[0]), torch.empty_like(plain[1])
        extra = () if earlier else (n_split,)
        return lambda: _call(fn, means2d, conics, opac, colors, offsets, ids, bg, out_c, out_a,
                             1, W, H, ts, tw, th, D, max_e, 0, *extra) or (out_c, out_a)

    fns = {f"k1_{v}": k1(libs[f"k1_{v}"], True) for v in ABLATION_K1.values()}
    fns.update({name: k1(lib) for name, lib in libs.items()
                if name.startswith("k1_") and name not in fns and "count" not in name
                and "timeline" not in name})
    for s in splits:
        fns[f"tree_split_{s}"] = (lambda n: lambda: P._launch_fwd(
            means2d, conics, colors, opac, W, H, ts, offsets, ids, bg, 1024, False,
            n_split=n))(s)
    fns["tree"] = lambda: P.rasterize_to_pixels_packed_inference(*args, backgrounds=bg)
    result = compare("k1", fns, plain)
    counts = torch.clamp(torch.diff(offsets.long()), 0, max_e).tolist()
    cnt = {"a_committed": _counts(libs["k1_count_a_committed"],
                                  k1(libs["k1_count_a_committed"], True))}
    timeline = {"a_committed": _timeline(libs["k1_timeline_a_committed"],
                                         k1(libs["k1_timeline_a_committed"], True), tw * th,
                                         counts)}
    if "k1_cull_counters" in libs:
        cnt["tree_cull"] = _counts(libs["k1_cull_counters"], k1(libs["k1_cull_counters"]),
                                   K1_CULL_NAMES)
        timeline["as_is"] = _timeline(libs["k1_timeline"], k1(libs["k1_timeline"]),
                                      tw * th * n_split, counts, n_split)
    result.update(shape=shape, n_split=n_split, stream=tile_stats(offsets, max_e), counts=cnt,
                  timeline=timeline)
    print(json.dumps(result), flush=True)


def run_kept(libs, bench, cap, geo7):
    """Kernels 2, 8, 9 and 10 built from the earlier sources and from this
    tree's, on the same inputs at the bench shapes: their bits and times."""
    g = torch.Generator(device=C.DEVICE).manual_seed(5)
    tc = 1024
    max_e = P.max_entries_per_tile(tc)
    # kernel 2 on the training path's stream
    args, _, _ = C.kernel_inputs(bench, max_tiles_per_gauss=16, isect_capacity=cap)
    means2d, conics, colors, opac, W, H, ts, offsets, ids = args
    D = colors.shape[-1]
    tw, th = -(-W // ts), -(-H // ts)
    img, trans = P.rasterize_packed_train_fwd(*args, tile_capacity=tc)
    v_img, v_t = torch.randn(img.shape, generator=g, device=C.DEVICE), torch.randn(
        trans.shape, generator=g, device=C.DEVICE)
    L = ids.shape[0]

    def k2(lib):
        fn = _entry(lib, "tdgs_rasterize_packed_bwd", 11, 8, slots=True)
        out = torch.empty((L, 6 + D), device=C.DEVICE)
        return lambda: _call(fn, means2d, conics, opac, colors, offsets, ids, img, trans, v_img,
                             v_t, out, 1, W, H, ts, tw, th, D, max_e, L) or out

    # kernel 8 on kernel 7's bench inputs
    rows7, d7, o7, off7, I7, D7, W7, H7, ts7 = geo7
    img7, t7 = E.rasterize_eval3d_train_fwd(*geo7, tc)
    v_img7, v_t7 = torch.randn(img7.shape, generator=g, device=C.DEVICE), torch.randn(
        t7.shape, generator=g, device=C.DEVICE)

    def k8(lib):
        fn = _entry(lib, "tdgs_rasterize_eval3d_bwd", 11, 8, slots=True)
        out, vd = torch.empty_like(rows7), torch.empty_like(d7)
        return lambda: _call(fn, rows7, d7, o7, off7, img7, t7, v_img7, v_t7, out, vd, None, I7,
                             W7, H7, ts7, tw, th, D7, max_e, rows7.shape[0]) or (out, vd)

    # kernels 9 and 10 at the bench frame's dense shape
    rows, counts, _ = C.kernel_inputs_dense(bench, tc, max_tiles_per_gauss=16,
                                            isect_capacity=C.dense_capacity(bench))
    geo = (1, W, H, 16)
    cap9 = rows.shape[1]
    img9, trans9 = RP.rasterize_dense_fwd(rows, counts, *geo)
    v_img9, v_t9 = torch.randn(img9.shape, generator=g, device=C.DEVICE), torch.randn(
        trans9.shape, generator=g, device=C.DEVICE)

    def k9(lib):
        fn = _entry(lib, "tdgs_rasterize_dense_fwd", 4, 7)
        out_c, out_t = torch.empty_like(img9), torch.empty_like(trans9)
        return lambda: _call(fn, rows, counts, out_c, out_t, *geo, rows.shape[2] - 6, cap9,
                             1) or (out_c, out_t)

    def k10(lib):
        fn = _entry(lib, "tdgs_rasterize_dense_bwd", 7, 7)
        out = torch.empty_like(rows)
        return lambda: _call(fn, rows, counts, img9, trans9, v_img9, v_t9, out, *geo,
                             rows.shape[2] - 6, cap9, 1) or out

    for kernel, make in (("k2", k2), ("k8", k8), ("k9", k9), ("k10", k10)):
        source = {"k2": "rasterize_packed_bwd", "k8": "rasterize_eval3d_bwd",
                  "k9": "rasterize_dense_fwd", "k10": "rasterize_dense_bwd"}[kernel]
        fns = {"earlier": make(libs[f"earlier_{source}"]), "tree": make(_build.load(source))}
        if kernel == "k9":
            fns = {"earlier": fns["earlier"], "own_walk": make(libs["k9_own_walk"]),
                   "tree": fns["tree"]}
        result = compare(kernel, fns)
        result.update(shape="bench")
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
    tree = {name: _registers(log) for name, log in _build.BUILD_LOGS.items()}
    print(json.dumps({"device": C.nvidia_smi(), "build_s": time.perf_counter() - t0,
                      "ptxas": PTXAS, "ptxas_tree": tree}), flush=True)
    bench = C.to_card(C.bench_scene())
    cap = C.bench_capacity(bench)
    geo7 = run_k7(libs, bench, cap)
    run_k7(libs, bench, cap, "bench_rolling_shutter")
    args, _, _ = C.kernel_inputs(bench, max_tiles_per_gauss=16)
    run_k1(libs, "bench", args, None, SPLITS)
    rally = C.to_card(C.rally_scene())
    bg = torch.full((1, 3), C.DOMINO_BACKGROUND, device=C.DEVICE)
    args, bg, _ = C.kernel_inputs(rally, backgrounds=bg, isect_exact=True)
    run_k1(libs, "rally", args, bg, SPLITS)
    run_kept(libs, bench, cap, geo7)
    print(json.dumps({"seconds": time.perf_counter() - t0, "device": C.nvidia_smi()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
