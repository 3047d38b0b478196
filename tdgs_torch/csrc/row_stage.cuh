// The batches in which the compositing kernels 1, 2, 7, 9 and 10 stage their
// entries' rows in shared memory: kBatch entries at a time, each row landing
// padded -- its G geometry floats as whole float4s (G = 6 for 3DGS: mx, my,
// a, b, c, opacity as two float4s; G = 13 for eval3d: M, g0, opacity as
// four), then the D channels as whole float4s -- so that a pixel reads an
// entry in 16-byte broadcasts. A kernel keeps two such batches, one walked
// while the next lands by cp.async (async_copy.cuh).
#pragma once

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace tdgsstage {

constexpr int kBatch = 32;

// a row's stride: n floats padded to whole float4s
__host__ __device__ constexpr int padded(int n) { return (n + 3) & ~3; }

// floats of one batch: [kBatch, padded(G)] geometry, then [kBatch, padded(D)]
// channels
template <int G = 6>
__host__ __device__ constexpr int batch_floats(int D) {
  return kBatch * (padded(G) + padded(D));
}

__device__ __forceinline__ const float4* geometry(const float* batch) {
  return reinterpret_cast<const float4*>(batch);
}

template <int G = 6>
__device__ __forceinline__ const float* colours(const float* batch) {
  return batch + padded(G) * kBatch;
}

// A thread's share of staging one batch into `batch`: thread (warp, lane)
// starts the copies of field `warp` (and every n_warps-th after it) of the
// batch's entry `lane`, whose field f lies at src(f), if `valid`; then it
// commits its group (an empty one when it started none).
template <int G = 6, typename Src>
__device__ __forceinline__ void stage(float* batch, bool valid, int lane, int warp,
                                      int n_warps, int D, Src src) {
  if (valid) {
    constexpr int GP = padded(G);
    const int DP = padded(D);
    for (int f = warp; f < G + D; f += n_warps) {
      tdgsasync::copy_4(f < G ? batch + GP * lane + f : batch + GP * kBatch + lane * DP + (f - G),
                        src(f));
    }
  }
  tdgsasync::commit();
}

// stage() for an entry whose G + D fields lie contiguous at `row`, 16-byte
// aligned: the geometry's whole float4s in 16-byte copies, its remaining
// floats and the channels (whose source is not aligned) in 4-byte ones.
template <int G>
__device__ __forceinline__ void stage_row16(float* batch, bool valid, int lane, int warp,
                                            int n_warps, int D, const float* row) {
  if (valid) {
    constexpr int G4 = G / 4;  // the geometry's whole float4s
    constexpr int GP = padded(G);
    const int DP = padded(D);
    // copy u < G4 is float4 u; after them, field 4 G4 + (u - G4)
    for (int u = warp; u < G4 + (G - 4 * G4) + D; u += n_warps) {
      if (u < G4) {
        tdgsasync::copy_16(batch + GP * lane + 4 * u, row + 4 * u);
      } else {
        const int f = 4 * G4 + (u - G4);
        tdgsasync::copy_4(f < G ? batch + GP * lane + f : batch + GP * kBatch + lane * DP + (f - G),
                          row + f);
      }
    }
  }
  tdgsasync::commit();
}

}  // namespace tdgsstage
