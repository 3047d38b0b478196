// Sorted segment sum of gradient rows: the VJP of the per-entry feature
// gather (`feats[flatten_ids]`), and the AbsGS accumulation with it.
//
// Replaces the TPU kernel tdgs/ops/segment_sum_pallas.py `_segsum_kernel`
// (:48), reached through `sorted_segment_rows_sum` (:156) from the
// `gather_rows_segsum` VJP (:219-243). Semantics:
//   out[g, f] = sum of rows[perm[e], f] over sorted positions e with
//               sids[e] == g, taken in sorted order,
//   and with `abs_cols`, out[g, F + j] = the same sum of |rows[perm[e], j]|
//   for j in {0, 1} (the screen-space mean columns: the AbsGS tap that
//   tdgs/ops/rasterize_jax.py:40 `absgrad_tap` scatters on its own).
// `perm` is the permutation of a STABLE sort of the ids and `sids` the
// sorted ids; the sort stays outside, as `lax.sort` stays outside the
// Pallas call. Ids outside [0, n_out) (the wrapper maps stream padding to
// n_out) belong to no output row and are never read.
//
// What bounds it on the H100: bytes. Each entry's row (F floats) is read
// once, at a place the permutation picks, and each output row is written
// once; there is one add per value.
//
// Design: two launches on the caller's stream. First one thread per sorted
// position marks where each id's segment starts and ends (into a zeroed
// [2, n_out] int32 scratch, so ids with no entry keep an empty segment);
// a first version found the bounds by two binary searches per output row,
// and their dependent loads, not the bytes, set its time. Then one warp
// per output row: the 32 lanes stride over the segment, each gathering
// whole rows through `perm` into F register accumulators, and a butterfly
// of shuffles sums the lanes. There are no float atomics, and every sum is
// taken in a fixed order, so two launches give bitwise equal output.
// Reading the rows through the permutation, rather than taking pre-permuted
// rows, saves a full pass over the [E, F] rows in device memory (a write
// and a read). A segment of thousands of entries (one gaussian over many
// tiles) is walked by 32 lanes at once, not by one thread.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

// bounds[0, g] / bounds[1, g]: first / one-past-last sorted position of id g
__global__ void segment_bounds_kernel(const int32_t* __restrict__ sids,
                                      int32_t* __restrict__ bounds,
                                      int64_t n_entries, int64_t n_out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  const int32_t g = sids[e];
  if (g < 0 || g >= n_out) return;
  if (e == 0 || sids[e - 1] != g) bounds[g] = static_cast<int32_t>(e);
  if (e == n_entries - 1 || sids[e + 1] != g) bounds[n_out + g] = static_cast<int32_t>(e + 1);
}

template <int FMAX>
__global__ void segment_sum_kernel(const float* __restrict__ rows,      // [E, F]
                                   const int64_t* __restrict__ perm,    // [E]
                                   const int32_t* __restrict__ bounds,  // [2, n_out]
                                   float* __restrict__ out,             // [n_out, F_out]
                                   int64_t n_out, int F, int abs_cols) {
  const int lane = threadIdx.x & 31;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (g >= n_out) return;  // whole warps leave together
  const int F_out = F + (abs_cols ? 2 : 0);

  const int64_t lo = bounds[g];
  const int64_t hi = bounds[n_out + g];

  // register accumulators: F columns, and the two |.| columns apart from
  // them (a run-time index into `acc` would push it out to local memory)
  float acc[FMAX];
#pragma unroll
  for (int f = 0; f < FMAX; ++f) acc[f] = 0.f;
  float abs0 = 0.f, abs1 = 0.f;
  for (int64_t e = lo + lane; e < hi; e += 32) {
    const float* row = rows + perm[e] * F;
#pragma unroll
    for (int f = 0; f < FMAX; ++f) {
      if (f < F) acc[f] += row[f];
    }
    if (abs_cols) {
      abs0 += fabsf(row[0]);
      abs1 += fabsf(row[1]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int f = 0; f < FMAX; ++f) acc[f] += __shfl_xor_sync(kFullMask, acc[f], off);
    abs0 += __shfl_xor_sync(kFullMask, abs0, off);
    abs1 += __shfl_xor_sync(kFullMask, abs1, off);
  }
  float* dst = out + g * F_out;
#pragma unroll
  for (int f = 0; f < FMAX; ++f) {
    if (f < F && (f & 31) == lane) dst[f] = acc[f];
  }
  if (abs_cols && lane == 0) {
    dst[F] = abs0;
    dst[F + 1] = abs1;
  }
}

template <int FMAX>
cudaError_t launch(const float* rows, const int64_t* perm, const int32_t* bounds,
                   float* out, int64_t n_out, int F, int abs_cols,
                   cudaStream_t stream) {
  const int64_t blocks = (n_out + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_sum_kernel<FMAX><<<static_cast<unsigned>(blocks), 32 * kWarpsPerBlock, 0, stream>>>(
      rows, perm, bounds, out, n_out, F, abs_cols);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). F <= 64, n_entries < 2^31;
// `bounds` is int32 scratch of 2 * n_out values, overwritten.
extern "C" int tdgs_segment_sum(const float* rows, const int64_t* perm,
                                const int32_t* sids, int32_t* bounds, float* out,
                                int64_t n_entries, int64_t n_out, int F,
                                int abs_cols, void* stream) {
  if (F <= 0 || F > 64 || (abs_cols && F < 2) || n_entries >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bounds, 0, 2 * n_out * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_entries > 0) {
    segment_bounds_kernel<<<static_cast<unsigned>((n_entries + 255) / 256), 256, 0, s>>>(
        sids, bounds, n_entries, n_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (F <= 8) {
    err = launch<8>(rows, perm, bounds, out, n_out, F, abs_cols, s);
  } else if (F <= 16) {
    err = launch<16>(rows, perm, bounds, out, n_out, F, abs_cols, s);
  } else if (F <= 40) {
    err = launch<40>(rows, perm, bounds, out, n_out, F, abs_cols, s);
  } else {
    err = launch<64>(rows, perm, bounds, out, n_out, F, abs_cols, s);
  }
  return static_cast<int>(err);
}
