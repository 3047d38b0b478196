// The front-to-back walk of the 2DGS (surfel) compositing kernels 4 (the
// inference call, rows read through flatten_ids) and 5 (the training call,
// stream-order rows), rasterize_2dgs_fwd.cu: one thread per pixel, over one
// tile's entries in order. The kernels differ only in where a batch's rows
// come from (the `stage` they pass) and in what they write after the walk.
// Per pixel centre (fx, fy) and per entry, with sigma from
// rasterize_2dgs_common.cuh:
//   alpha = min(0.999, op exp(-sigma)); skipped if alpha < 1/255
//   the entry is included iff T (1 - alpha) > 1e-4, T the running product
//   acc += alpha T ch over included entries (channels = colours [+ depth]
//   and the 3 camera-frame normals)
// and, with TRAIN and a depth channel at `depth_row`, the distortion
// sum 2 w (d A - B) over the exclusive prefixes A, B of w and w d (when
// `with_dist`) and the median depth, d of the last included entry with
// T_prev > 0.5 and w > 0.
//
// - Staging: entries come in batches of 32, which the whole block copies
//   into shared memory asynchronously and double-buffered (cp.async), each
//   row landing padded -- the 12 geometry floats (mx, my, t0, tpx, tpy, op)
//   as three float4s, the DA channels as whole float4s -- so that a pixel
//   reads an entry in 16-byte broadcasts (row_stage.cuh with G = 12).
//   stage(from, dst) starts the copies of the entries from .. from + 31
//   into dst and commits them.
// - Cull: before walking a batch, each lane tests one entry against the box
//   of the warp's pixel centres (surfel_cull.cuh, the bound kernel 6 culls
//   with), and the warp walks only the entries that may reach alpha >=
//   1/255 there. An entry it skips would have been skipped at every pixel
//   of the warp (and it adds nothing to T, the channels, the distortion or
//   the median), so the output is bitwise that of walking it.
// - Termination: a pixel past its cutoff evaluates nothing more, and the
//   block stops fetching once all its pixels are done.
//
// Arithmetic: sigma, op vis, 1 - alpha, T and w round on their own (the _rn
// intrinsics, never contracted) and the channel sums are explicit FMAs, so
// the 1/255 and cutoff tests agree rounding for rounding with kernel 6,
// which retraces them, and the output does not depend on what the compiler
// contracts.
#pragma once

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "composite_walk.cuh"
#include "rasterize_2dgs_common.cuh"
#include "row_stage.cuh"
#include "surfel_cull.cuh"

namespace tdgssurfel {

using tdgsstage::kBatch;
constexpr unsigned kFullMask = 0xffffffffu;

// What a pixel carries through the walk: the channel sums (DA <= CMAX), T,
// and with TRAIN the distortion, its prefixes and the median depth.
template <int CMAX>
struct Carry {
  float acc[CMAX];
  float T, dist, A, B, med;
  bool done;  // past its cutoff, or outside the image
};

template <int CMAX>
__device__ __forceinline__ void init(Carry<CMAX>& c, bool inside) {
#pragma unroll
  for (int i = 0; i < CMAX; ++i) c.acc[i] = 0.f;
  c.T = 1.f;
  c.dist = c.A = c.B = c.med = 0.f;
  c.done = !inside;
}

// Walks `count` entries for pixel `pix`; s_batches holds two batches of
// row_stage.cuh's layout with G = 12. `depth_row` < 0: no depth channel.
template <int CMAX, bool TRAIN, typename Stage>
__device__ __forceinline__ void walk(float* s_batches, int count, int DA,
                                     const tdgswalk::Pixel& pix, int depth_row, bool with_dist,
                                     Carry<CMAX>& c, Stage stage) {
  using namespace tdgs2dgs;
  constexpr int NQ = (CMAX + 3) / 4;  // float4s of channels
  const int lane = threadIdx.x & 31;
  const int DP = tdgsstage::padded(DA);
  const int BS = tdgsstage::batch_floats<kGeomCols>(DA);
  const bool with_depth = TRAIN && depth_row >= 0;

  if (count > 0) stage(0, s_batches);
  for (int b0 = 0, buf = 0; b0 < count; b0 += kBatch, buf ^= 1) {
    // a barrier too: the previous batch has been read
    if (__syncthreads_count(c.done) == static_cast<int>(blockDim.x)) break;
    const int n = min(kBatch, count - b0);
    // the next batch lands in the other buffer while this one is walked
    if (b0 + kBatch < count) {
      stage(b0 + kBatch, s_batches + (buf ^ 1) * BS);
    } else {
      tdgsasync::commit();
    }
    tdgsasync::wait<1>();
    __syncthreads();
    const float* s_geo = s_batches + buf * BS;
    const float* s_ch = tdgsstage::colours<kGeomCols>(s_batches + buf * BS);
    // the batch's entries that may reach this warp's pixels, one lane each
    bool may = false;
    if (lane < n) {
      float g[kGeomCols];
      load_geometry(s_geo + kGeomCols * lane, g);
      may = may_reach(g, pix.x0, pix.x1, pix.y0, pix.y1);
    }
    unsigned todo = __ballot_sync(kFullMask, may);
    while (todo != 0u) {
      const int k = __ffs(todo) - 1;
      todo &= todo - 1u;
      if (c.done) continue;
      float g[kGeomCols];
      load_geometry(s_geo + kGeomCols * k, g);
      Response r;
      const float sigma = ray_splat_sigma(g, pix.fx, pix.fy, r);
      const float alpha = fminf(kAlphaClamp, __fmul_rn(g[11], expf(-sigma)));
      if (alpha < kAlphaThreshold) continue;
      const float next_T = __fmul_rn(c.T, __fsub_rn(1.f, alpha));
      if (next_T <= kTransmittanceEps) {
        c.done = true;
        continue;
      }
      const float w = __fmul_rn(alpha, c.T);
      const float4* ch4 = reinterpret_cast<const float4*>(s_ch + k * DP);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (4 * q < DA) {
          const float4 v = ch4[q];
          const float ch[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (4 * q + i < DA) c.acc[4 * q + i] = __fmaf_rn(w, ch[i], c.acc[4 * q + i]);
          }
        }
      }
      if (with_depth) {
        const float d = s_ch[k * DP + depth_row];
        if (with_dist) {
          c.dist += 2.f * w * (d * c.A - c.B);
          c.A += w;
          c.B += w * d;
        }
        if (c.T > 0.5f && w > 0.f) c.med = d;  // the last qualifying entry wins
      }
      c.T = next_T;
    }
  }
  tdgsasync::wait<0>();  // a batch still in flight after an early exit
}

}  // namespace tdgssurfel
