// The batches in which the 3DGS compositing kernels 2, 9 and 10 stage their
// entries' rows in shared memory: kBatch entries at a time, each row landing
// padded -- (mx, my, a, b, c, opacity) as two float4s, then the D colours
// as whole float4s -- so that a pixel reads an entry in 16-byte broadcasts.
// A kernel keeps two such batches, one walked while the next lands by
// cp.async (async_copy.cuh).
#pragma once

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace tdgsstage {

constexpr int kBatch = 32;

// a colour row's stride: D floats padded to whole float4s
__host__ __device__ constexpr int padded(int D) { return (D + 3) & ~3; }

// floats of one batch: [kBatch, 8] geometry (2 unused), then [kBatch, DP]
// colours
__host__ __device__ constexpr int batch_floats(int D) { return kBatch * (8 + padded(D)); }

__device__ __forceinline__ const float4* geometry(const float* batch) {
  return reinterpret_cast<const float4*>(batch);
}

__device__ __forceinline__ const float* colours(const float* batch) {
  return batch + 8 * kBatch;
}

// A thread's share of staging one batch into `batch`: thread (warp, lane)
// starts the copies of field `warp` (and every n_warps-th after it) of the
// batch's entry `lane`, whose field f lies at src(f), if `valid`; then it
// commits its group (an empty one when it started none).
template <typename Src>
__device__ __forceinline__ void stage(float* batch, bool valid, int lane, int warp,
                                      int n_warps, int D, Src src) {
  if (valid) {
    const int DP = padded(D);
    for (int f = warp; f < 6 + D; f += n_warps) {
      tdgsasync::copy_4(f < 6 ? batch + 8 * lane + f : batch + 8 * kBatch + lane * DP + (f - 6),
                        src(f));
    }
  }
  tdgsasync::commit();
}

}  // namespace tdgsstage
