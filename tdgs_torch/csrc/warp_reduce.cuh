// The transposing reduce-scatter of the backward kernels (2, 6, 8): sums
// NV per-lane values over a warp's 32 lanes and leaves the sums one column
// to a lane, so that the warp's partial row goes to shared memory in one
// coalesced store.
//
// At each of five levels a lane keeps half of its values and sends the
// other half to its partner, so the sums end one column to a lane (two at
// NV = 64) after 16, 31 or 62 shuffles at NV = 16, 32 or 64 (NV = 16:
// 8 + 4 + 2 + 1, then 1 across the halves of the warp). A butterfly that
// left every sum in every lane would take 5 * F shuffles for F values.
// Template recursion over the levels keeps every index a constant, so the
// values stay in registers (a loop form left them in local memory).
// The additions form a fixed tree: the sums are bitwise repeatable.
#pragma once

#include <cuda_runtime.h>

namespace tdgswarp {

constexpr unsigned kFullMask = 0xffffffffu;

// The reduction width for n values: n padded to 16, 32 or 64.
__host__ __device__ constexpr int reduce_width(int n) {
  return n <= 16 ? 16 : (n <= 32 ? 32 : 64);
}

// One level: lanes pair across lane bit O; each keeps the half of its
// first 2H values that its bit selects (the upper half when set) and adds
// its partner's copy of that half.
template <int O, int H, int NV>
__device__ __forceinline__ void halve(float (&v)[NV], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = upper ? v[j] : v[j + H];
    const float keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(kFullMask, send, O);
  }
  if constexpr (O > 1) halve<O / 2, H / 2>(v, lane);
}

// Sums v over the warp's 32 lanes, scattered: on return lane l holds the
// sum of column l % NV in v[0] (NV <= 32), or of columns 2l and 2l + 1 in
// v[0] and v[1] (NV = 64).
template <int NV>
__device__ __forceinline__ void reduce_scatter(float (&v)[NV], int lane) {
  static_assert(NV == 16 || NV == 32 || NV == 64, "NV: 16, 32 or 64");
  halve<(NV / 2 < 16 ? NV / 2 : 16), NV / 2>(v, lane);
  if constexpr (NV == 16) v[0] += __shfl_xor_sync(kFullMask, v[0], 16);
}

// The warp's scattered sums into its partial row `part` of F <= NV floats:
// one store instruction across the warp (NV <= 32: lane l writes column l),
// or one pair of neighbouring columns a lane (NV = 64).
template <int NV>
__device__ __forceinline__ void store_scattered(float* part, const float (&v)[NV], int lane,
                                                int F) {
  if (NV <= 32) {
    if (lane < F) part[lane] = v[0];
  } else {
    if (2 * lane < F) part[2 * lane] = v[0];
    if (2 * lane + 1 < F) part[2 * lane + 1] = v[1];
  }
}

// The warp's partial row of zeros (no lane contributed to this entry).
__device__ __forceinline__ void store_zero_row(float* part, int lane, int F) {
  if (lane < F) part[lane] = 0.f;
  if (lane + 32 < F) part[lane + 32] = 0.f;
}

}  // namespace tdgswarp
