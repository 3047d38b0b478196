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
// n_out) belong to no output row and are never read. `perm` may name fewer
// rows than `rows` holds.
//
// What bounds it on the H100: bytes. Each entry's row (F floats) is read
// once, at a place the permutation picks, and each output row is written
// once; there is one add per value.
//
// Design: one launch. As the TPU kernel slides a window of output rows
// along the sorted stream, each block here owns a window of consecutive
// output rows, kept in shared memory, for a chunk of at most kMaxChunk
// columns (one chunk for rows of up to 24: the 3DGS, 2DGS and RGB eval3d
// rows):
//   - warps 0 and 1 find the window's sorted positions [p0, p1) by a
//     search in `sids` (32 probes a round, four rounds for 2^20 positions);
//   - each warp takes an equal span of them and walks it 32 positions at a
//     time, a lane to a position: the ids and the permutation are read
//     coalesced, every lane gathers its row through `perm` (as 16-byte
//     chunks: a 36-byte row in three loads) and leaves it in the warp's
//     staging rows, and the lane that heads each segment in those 32
//     positions sums the segment's staged rows in sorted order and adds
//     the sum to the segment's window row;
//   - the part of a segment that began before a warp's span goes to the
//     warp's carry row instead, and after the walk one thread adds the
//     carries to their window rows in span order;
//   - the window, zeros included for the rows no position names, is
//     written to `out` in coalesced stores.
// A window row is added to by one warp at a time in sorted order: there
// are no float atomics and every sum is taken in a fixed order, so two
// launches give bitwise equal output. There are no shuffles of values and
// no work for output rows without entries beyond the window's zeros.
// Reading the rows through the permutation, rather than taking
// pre-permuted rows, saves a full pass over the [E, F] rows in device
// memory (a write and a read).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindowFloats = 6144;  // shared memory of one window: 24 KB
// Columns one block sums: wider rows are cut into chunks, one a block, so
// that a thread's register accumulators, and with them its registers, stay
// few enough for the blocks in flight that hide the gathers' latency
constexpr int kMaxChunk = 24;

// output rows of one block's window: a power of two, so that `cols`
// columns of them fit kWindowFloats
__host__ __device__ constexpr int window_rows(int cols) {
  int rows = 1024;
  while (rows * cols > kWindowFloats) rows /= 2;
  return rows;
}

// first position in sids[0, n) whose id is >= g (sids sorted), found by a
// whole warp: each round probes 32 evenly spaced positions of the interval
// left, so 2^20 positions take four rounds of loads, not twenty
__device__ __forceinline__ int64_t warp_lower_bound(const int32_t* __restrict__ sids,
                                                    int64_t n, int64_t g) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t q = lo + ((lane + 1) * (hi - lo)) / 32 - 1;
    const bool less = q < lo || sids[q] < g;  // monotone over the lanes
    const int c = __popc(__ballot_sync(kFullMask, less));
    const int64_t q_hi = __shfl_sync(kFullMask, q, c & 31);
    const int64_t q_lo = __shfl_sync(kFullMask, q, (c + 31) & 31);
    if (c == 32) {
      lo = hi;
    } else {
      hi = q_hi;
      if (c > 0) lo = q_lo + 1;
    }
  }
  return lo;
}

// Loads the n_c floats at float index `at` of `rows` (16-byte aligned)
// into x, read as the aligned 16-byte chunks that cover them: a 36-byte
// row takes three vector loads, not nine scalar ones. ALIGNED: `at` is a
// multiple of 4.
template <int CW, bool ALIGNED>
__device__ __forceinline__ void load_row(const float* __restrict__ rows, int64_t at, int n_c,
                                         float (&x)[CW]) {
  constexpr int kChunks = ALIGNED ? CW / 4 : (CW + 3 + 3) / 4;
  const int shift = ALIGNED ? 0 : static_cast<int>(at & 3);
  const float4* src = reinterpret_cast<const float4*>(rows) + (at >> 2);
  float buf[4 * kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * c < shift + n_c) q = __ldg(src + c);
    buf[4 * c] = q.x;
    buf[4 * c + 1] = q.y;
    buf[4 * c + 2] = q.z;
    buf[4 * c + 3] = q.w;
  }
#pragma unroll
  for (int f = 0; f < CW; ++f) {
    if (ALIGNED) {
      x[f] = buf[f];
    } else {  // x[f] = buf[f + shift], by selects
      const float lo = shift & 1 ? buf[f + 1] : buf[f];
      const float hi = shift & 1 ? buf[f + 3] : buf[f + 2];
      x[f] = shift & 2 ? hi : lo;
    }
  }
}

// Block (window, chunk): the window's output rows, columns
// [chunk * width, + n_c) and, in chunk 0 with abs_cols, the |.| columns.
template <int CW, bool ALIGNED>
__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const float* __restrict__ rows,     // [R, F]
    const int64_t* __restrict__ perm,   // [E]
    const int32_t* __restrict__ sids,   // [E] sorted
    float* __restrict__ out,            // [n_out, F_out]
    int64_t n_entries, int64_t n_out, int F, int abs_cols, int width) {
  constexpr int kRows = window_rows(CW + 2);
  __shared__ float window[kRows * (CW + 2)];
  __shared__ float stage[kWarps][32 * (CW + 3)];  // a warp's 32 staged rows
  __shared__ float carry[kWarps][CW + 2];
  __shared__ int32_t carry_id[kWarps];
  __shared__ int64_t span[2];
  const int F_out = F + (abs_cols ? 2 : 0);
  const int col0 = static_cast<int>(blockIdx.y) * width;
  const int n_c = F - col0 < width ? F - col0 : width;
  const bool abs_here = abs_cols && blockIdx.y == 0;
  const int W = n_c + (abs_here ? 2 : 0);  // window row: chunk columns, |.|
  const int W_st = W | 1;  // staged row stride, odd: no two lanes share a bank
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int n_rows = static_cast<int>(n_out - c0 < kRows ? n_out - c0 : kRows);
  const int n_vals = n_rows * W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < n_vals; i += kThreads) window[i] = 0.f;
  if (lane < W) carry[warp][lane] = 0.f;
  if (threadIdx.x < 64) {  // warp 0 finds the window's first position, warp 1 its end
    const int64_t at = warp_lower_bound(sids, n_entries, warp == 0 ? c0 : c0 + n_rows);
    if (lane == 0) span[warp] = at;
  }
  __syncthreads();
  const int64_t p0 = span[0], p1 = span[1];

  // this warp's span of positions; the part of a segment that began before
  // it (in an earlier warp's span) goes to its carry row
  const int64_t per = (p1 - p0 + kWarps - 1) / kWarps;
  const int64_t s0 = p0 + warp * per < p1 ? p0 + warp * per : p1;
  const int64_t s1 = s0 + per < p1 ? s0 + per : p1;
  const int32_t carried = s0 < s1 && s0 > p0 && sids[s0 - 1] == sids[s0] ? sids[s0] : -1;
  if (lane == 0) carry_id[warp] = carried;
  float* staged = stage[warp];
  for (int64_t base = s0; base < s1; base += 32) {
    const int64_t e = base + lane;
    const bool valid = e < s1;
    const int32_t id = valid ? sids[e] : -1;
    float x[CW];
    load_row<CW, ALIGNED>(rows, (valid ? perm[e] : 0) * F + col0, valid ? n_c : 0, x);
    float* mine = staged + lane * W_st;
#pragma unroll
    for (int f = 0; f < CW; ++f) {
      if (f < n_c) mine[f] = x[f];
    }
    if (abs_here) {
      mine[n_c] = fabsf(x[0]);
      mine[n_c + 1] = fabsf(x[1]);
    }
    // a lane heads a segment where its id differs from the lane before
    const int32_t before = __shfl_up_sync(kFullMask, id, 1);
    const unsigned heads = __ballot_sync(kFullMask, valid && (lane == 0 || id != before));
    __syncwarp();
    if ((heads >> lane) & 1u) {
      const unsigned later = heads & ~((2u << lane) - 1u);  // heads after this lane
      const int end_lane = later ? __ffs(later) - 1 : 32;
      const int end = static_cast<int>(s1 - base < end_lane ? s1 - base : end_lane);
      float acc[CW + 2];
#pragma unroll
      for (int f = 0; f < CW + 2; ++f) acc[f] = 0.f;
      for (int j = lane; j < end; ++j) {  // sorted order
        const float* r = staged + j * W_st;
#pragma unroll
        for (int f = 0; f < CW + 2; ++f) {
          if (f < W) acc[f] += r[f];
        }
      }
      float* dst = id == carried ? carry[warp] : window + (id - c0) * W;
#pragma unroll
      for (int f = 0; f < CW + 2; ++f) {
        if (f < W) dst[f] += acc[f];
      }
    }
    __syncwarp();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the carries, in span order, after the rows' earlier parts
    for (int w = 0; w < kWarps; ++w) {
      if (carry_id[w] < 0) continue;
      float* dst = window + (carry_id[w] - c0) * W;
      for (int f = 0; f < W; ++f) dst[f] += carry[w][f];
    }
  }
  __syncthreads();
  // the window's rows into out: with one chunk a contiguous span of it
  float* dst = out + c0 * F_out;
  for (int i = threadIdx.x; i < n_vals; i += kThreads) {
    const int r = i / W, j = i - r * W;
    dst[static_cast<int64_t>(r) * F_out + (j < n_c ? col0 + j : F + j - n_c)] = window[i];
  }
}

template <int CW, bool ALIGNED>
cudaError_t launch(const float* rows, const int64_t* perm, const int32_t* sids, float* out,
                   int64_t n_entries, int64_t n_out, int F, int abs_cols, int width,
                   cudaStream_t stream) {
  constexpr int kRows = window_rows(CW + 2);
  const dim3 grid(static_cast<unsigned>((n_out + kRows - 1) / kRows),
                  static_cast<unsigned>((F + width - 1) / width));
  segment_sum_kernel<CW, ALIGNED><<<grid, kThreads, 0, stream>>>(
      rows, perm, sids, out, n_entries, n_out, F, abs_cols, width);
  return cudaGetLastError();
}

template <int CW>
cudaError_t launch_width(const float* rows, const int64_t* perm, const int32_t* sids,
                         float* out, int64_t n_entries, int64_t n_out, int F, int abs_cols,
                         int width, cudaStream_t stream) {
  // every chunk starts on a multiple of 4 floats of a row of 16-byte
  // multiples: no chunk's floats need shifting
  return (F % 4 == 0 && width % 4 == 0)
             ? launch<CW, true>(rows, perm, sids, out, n_entries, n_out, F, abs_cols, width,
                                stream)
             : launch<CW, false>(rows, perm, sids, out, n_entries, n_out, F, abs_cols, width,
                                 stream);
}

}  // namespace

// Returns a cudaError_t (0 on success). F <= 64, n_entries < 2^31; `rows`
// 16-byte aligned.
extern "C" int tdgs_segment_sum(const float* rows, const int64_t* perm,
                                const int32_t* sids, float* out, int64_t n_entries,
                                int64_t n_out, int F, int abs_cols, void* stream) {
  if (F <= 0 || F > 64 || (abs_cols && F < 2) || n_entries < 0 ||
      n_entries >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(rows) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // columns in as few chunks of at most kMaxChunk as cover F, evened out,
  // and whole 16-byte chunks of the rows where they are made of them
  const int n_chunks = (F + kMaxChunk - 1) / kMaxChunk;
  int width = (F + n_chunks - 1) / n_chunks;
  if (F % 4 == 0) width = (width + 3) & ~3;
  const cudaError_t err =
      width <= 16 ? launch_width<16>(rows, perm, sids, out, n_entries, n_out, F, abs_cols,
                                     width, s)
                  : launch_width<kMaxChunk>(rows, perm, sids, out, n_entries, n_out, F,
                                            abs_cols, width, s);
  return static_cast<int>(err);
}
