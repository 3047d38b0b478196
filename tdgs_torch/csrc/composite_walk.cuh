// The front-to-back walk of the 3DGS compositing kernels 1 (packed stream,
// rasterize_packed_fwd.cu) and 9 (tile-dense rows, rasterize_dense_fwd.cu):
// one thread per pixel, over one tile's entries in order. The kernels
// differ only in where a batch's rows come from (the `stage` they pass)
// and in what they write after the walk. Per pixel centre (fx, fy) and per
// entry:
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy,  dx = mx - fx
//   alpha = min(0.999, op exp(-sigma)); skipped if sigma < 0 or alpha < 1/255
//   the entry is included iff T (1 - alpha) > 1e-4, T the running product
//   acc += alpha T c over included entries
//
// - Staging: entries come in batches of 32, which the whole block copies
//   into shared memory asynchronously and double-buffered (cp.async), each
//   row landing padded so that a pixel reads an entry in 16-byte broadcasts
//   (row_stage.cuh). stage(from, dst) starts the copies of the entries
//   from .. from + 31 into dst and commits them.
// - Cull: before walking a batch, each lane tests one entry against the box
//   of the warp's pixel centres (conic_cull.cuh, a conservative bound), and
//   the warp walks only the entries that may reach alpha >= 1/255 there. An
//   entry it skips would have been excluded at every pixel of the warp, so
//   the output is bitwise that of walking it.
// - Termination: a pixel past its cutoff evaluates nothing more, and the
//   block stops fetching once all its pixels are done. (A warp whose pixels
//   are all done leaving the batch early, by a vote, measured slower in
//   kernel 9.)
//
// Arithmetic: sigma, op vis, 1 - alpha, T and the colour sums round on
// their own (the _rn intrinsics are never contracted), as the plain
// PyTorch versions round sigma and alpha, so the sigma < 0, 1/255 and
// cutoff tests agree with them bit for bit, the backward kernels 2 and 10
// retrace the same inclusions, and the output does not depend on what the
// compiler contracts.
#pragma once

#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "conic_cull.cuh"
#include "row_stage.cuh"

namespace tdgswalk {

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr unsigned kFullMask = 0xffffffffu;
using tdgsstage::kBatch;

// A pixel's centre and the box of its warp's pixel centres, which the cull
// tests against. Every lane of the warp makes its own.
struct Pixel {
  float fx, fy, x0, x1, y0, y1;
};

__device__ __forceinline__ Pixel pixel(int px, int py) {
  Pixel p;
  p.fx = static_cast<float>(px) + 0.5f;
  p.fy = static_cast<float>(py) + 0.5f;
  tdgscull::warp_box(p.fx, p.fy, p.x0, p.x1, p.y0, p.y1);
  return p;
}

// Walks `count` entries into acc (D <= CMAX channels) and T for pixel `pix`;
// `done` is true on entry for a pixel outside the image. s_batches holds
// two batches.
template <int CMAX, typename Stage>
__device__ __forceinline__ void walk(float* s_batches, int count, int D, const Pixel& pix,
                                     float (&acc)[CMAX], float& T, bool& done, Stage stage) {
  constexpr int NQ = (CMAX + 3) / 4;  // float4s of colours
  const int lane = threadIdx.x & 31;
  const int DP = tdgsstage::padded(D);
  const int BS = tdgsstage::batch_floats(D);
  const float fx = pix.fx, fy = pix.fy;

  if (count > 0) stage(0, s_batches);
  for (int b0 = 0, buf = 0; b0 < count; b0 += kBatch, buf ^= 1) {
    // a barrier too: the previous batch has been read
    if (__syncthreads_count(done) == static_cast<int>(blockDim.x)) break;
    const int n = min(kBatch, count - b0);
    // the next batch lands in the other buffer while this one is walked
    if (b0 + kBatch < count) {
      stage(b0 + kBatch, s_batches + (buf ^ 1) * BS);
    } else {
      tdgsasync::commit();
    }
    tdgsasync::wait<1>();
    __syncthreads();
    const float4* s_geo = tdgsstage::geometry(s_batches + buf * BS);
    const float* s_col = tdgsstage::colours(s_batches + buf * BS);
    // the batch's entries that may reach this warp's pixels, one lane each
    unsigned todo = __ballot_sync(
        kFullMask,
        lane < n && tdgscull::may_reach(s_geo[2 * lane], s_geo[2 * lane + 1], pix.x0, pix.x1,
                                        pix.y0, pix.y1));
    while (todo != 0u) {
      const int k = __ffs(todo) - 1;
      todo &= todo - 1u;
      if (!done) {
        const float4 q0 = s_geo[2 * k], q1 = s_geo[2 * k + 1];
        const float dx = __fsub_rn(q0.x, fx);
        const float dy = __fsub_rn(q0.y, fy);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(q0.z, dx), dx),
                                     __fmul_rn(__fmul_rn(q1.x, dy), dy));
        const float sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(q0.w, dx), dy));
        const float alpha = fminf(kAlphaClamp, __fmul_rn(q1.y, expf(-sigma)));
        if (!(sigma < 0.f) && !(alpha < kAlphaThreshold)) {
          const float next_T = __fmul_rn(T, __fsub_rn(1.f, alpha));
          if (next_T <= kTransmittanceEps) {
            done = true;
          } else {
            const float w = __fmul_rn(alpha, T);
            const float4* col4 = reinterpret_cast<const float4*>(s_col + k * DP);
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              if (4 * q < D) {
                const float4 c4 = col4[q];
                const float col[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  if (4 * q + i < D) acc[4 * q + i] = __fmaf_rn(w, col[i], acc[4 * q + i]);
                }
              }
            }
            T = next_T;
          }
        }
      }
    }
  }
  tdgsasync::wait<0>();  // a batch still in flight after an early exit
}

}  // namespace tdgswalk
