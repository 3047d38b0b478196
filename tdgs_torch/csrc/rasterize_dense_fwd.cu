// Forward 3DGS compositing over tile-dense gathered rows.
//
// Replaces the TPU kernel tdgs/ops/rasterize_pallas.py `_fwd_kernel` (:99),
// called by `_raster_core_fwd` (:318) under `rasterize_to_pixels_pallas`
// (:399). The per-tile gather stays outside, as XLA's gather does in JAX:
// tile t's first `cap` sorted entries arrive as rows [T, cap, 6 + D] =
// (mx, my, a, b, c, opacity, colours), of which the first counts[t] are
// valid. Semantics, per pixel centre (px + 0.5, py + 0.5) and per valid
// slot k, front to back:
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy,  dx = mx - px
//   alpha = min(0.999, op exp(-sigma)); alpha = 0 if sigma < 0 or alpha < 1/255
//   slot k is included iff prod_{j<=k} (1 - alpha_j) > 1e-4
//   color += alpha T_prev c_k over included slots; T = prod (1 - alpha_k)
// Outputs: the colours without background [I, H, W, D] and T [I, H, W]
// itself (not 1 - T: the backward needs T's relative precision where it is
// small); the wrapper blends the background outside, as the JAX function
// does. The TPU kernel's log-space prefix, its triangular matmul and its
// 128-slot chunk skip are MXU artefacts: a per-pixel walk that stops at its
// own cutoff computes the same function.
//
// What bounds it on the H100: the (pixel, slot) evaluations -- a few FP32
// FMAs, one expf and D colour FMAs each -- against the FP32 and SFU rates;
// the bytes (the tile's valid rows, read once, and the image writes) are
// small beside them. Early termination makes both depend on the data. Each
// pixel's walk is a chain of dependent operations, so where tiles are few
// (image fitting's 64) the chains' length, not the card's rate, sets the
// time.
//
// Design: one thread per pixel; the block stages each tile's valid rows and
// each warp (two 16-pixel rows of a 16x16 tile) walks them on its own:
// - Staging: slots come in batches of 32, which the whole block copies into
//   shared memory asynchronously and double-buffered (cp.async of 4-byte
//   values), each row landing padded so that a pixel reads a slot in
//   16-byte broadcasts (row_stage.cuh, shared with kernels 2 and 10).
// - Cull: before walking a batch, each lane tests one slot against the box
//   of the warp's pixel centres (conic_cull.cuh, a conservative bound), and
//   the warp walks only the slots that may reach alpha >= 1/255 there. A
//   slot it skips would have been excluded at every pixel of the warp, so
//   the output is bitwise that of walking it.
// - Termination: a pixel past its cutoff evaluates nothing more, and the
//   block stops fetching once all its pixels are done. (A warp whose pixels
//   are all done leaving the batch early, by a vote, measured slower.)
// - Blocks: a tile's 8 warps share one block, or, where tiles are few,
//   n_split blocks of 8 / n_split warps, each staging the tile's rows (the
//   wrapper picks n_split from the tile count and the card's SMs; the
//   output does not depend on it).
// Slots past counts[t] are never read. Colours accumulate in registers
// (templated channel bound); pixels beyond the image edge are masked.
//
// Arithmetic: sigma, op vis, 1 - alpha, T and the colour sums round on
// their own (the _rn intrinsics are never contracted), as the plain
// PyTorch version rounds sigma and alpha, so the sigma < 0, 1/255 and
// cutoff tests agree with it bit for bit and the output does not depend on
// what the compiler contracts.
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "conic_cull.cuh"
#include "row_stage.cuh"

namespace {

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr unsigned kFullMask = 0xffffffffu;
using tdgsstage::kBatch;

template <int CMAX>
__global__ void rasterize_dense_fwd_kernel(
    const float* __restrict__ rows,       // [T, cap, 6 + D]
    const int32_t* __restrict__ counts,   // [T]
    float* __restrict__ out_colors,       // [I, H, W, D]
    float* __restrict__ out_T,            // [I, H, W]
    int width, int height, int tile_size, int tile_width, int tiles_per_image,
    int D, int cap, int n_split) {
  constexpr int NQ = (CMAX + 3) / 4;  // float4s of colours
  extern __shared__ float4 smem4[];
  const int F = 6 + D;
  const int DP = tdgsstage::padded(D);
  const int n_warps = blockDim.x >> 5;
  const int BS = tdgsstage::batch_floats(D);
  float* s_batches = reinterpret_cast<float*>(smem4);  // two batches [2, BS]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int t = blockIdx.x / n_split;
  const int part = blockIdx.x - t * n_split;
  const int image = t / tiles_per_image;
  const int t_in = t - image * tiles_per_image;
  const int ty = t_in / tile_width;
  const int tx = t_in - ty * tile_width;
  const int p = part * blockDim.x + tid;  // the pixel within its tile
  const int px = tx * tile_size + p % tile_size;
  const int py = ty * tile_size + p / tile_size;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px) + 0.5f;
  const float fy = static_cast<float>(py) + 0.5f;
  float x0, x1, y0, y1;
  tdgscull::warp_box(fx, fy, x0, x1, y0, y1);

  const int count = max(0, min(counts[t], cap));
  const float* tile_rows = rows + static_cast<int64_t>(t) * cap * F;

  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
  float T = 1.f;
  bool done = !inside;

  // The whole block stages a batch from the tile's contiguous rows.
  const auto stage = [&](int from, float* dst) {
    const float* src = tile_rows + static_cast<int64_t>(from + lane) * F;
    tdgsstage::stage(dst, from + lane < count, lane, warp, n_warps, D,
                     [&](int f) { return src + f; });
  };
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
    // the batch's slots that may reach this warp's pixels, one lane each
    unsigned todo = __ballot_sync(
        kFullMask,
        lane < n && tdgscull::may_reach(s_geo[2 * lane], s_geo[2 * lane + 1], x0, x1, y0, y1));
    while (todo != 0u) {
      const int k = __ffs(todo) - 1;
      todo &= todo - 1u;
      if (!done) {
        // sigma and alpha round each operation on its own, as the plain
        // PyTorch version does, so the sigma < 0 and 1/255 tests agree bit
        // for bit
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

  if (!inside) return;
  const int64_t pix = (static_cast<int64_t>(image) * height + py) * width + px;
  out_T[pix] = T;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < D) out_colors[pix * D + c] = acc[c];
  }
}

template <int CMAX>
cudaError_t launch(const float* rows, const int32_t* counts, float* out_colors,
                   float* out_T, int n_tiles, int width, int height, int tile_size,
                   int tile_width, int tiles_per_image, int D, int cap, int n_split,
                   cudaStream_t stream) {
  const int block = tile_size * tile_size / n_split;
  // two batches of at most 32 x (8 + 32) floats: 10 KB
  const size_t smem = static_cast<size_t>(2) * tdgsstage::batch_floats(D) * sizeof(float);
  rasterize_dense_fwd_kernel<CMAX><<<n_tiles * n_split, block, smem, stream>>>(
      rows, counts, out_colors, out_T, width, height, tile_size, tile_width,
      tiles_per_image, D, cap, n_split);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). D <= 32; tiles of a multiple of 32
// pixels, at most 1024; rows hold n_images * tiles_x * tiles_y tiles of
// `cap` slots. n_split: the blocks that share each tile's warps (it divides
// them; the wrapper picks it from the tile count and the card's SMs; the
// output does not depend on it).
extern "C" int tdgs_rasterize_dense_fwd(
    const float* rows, const int32_t* counts, float* out_colors, float* out_T,
    int n_images, int width, int height, int tile_size, int D, int cap, int n_split,
    void* stream) {
  const int block = tile_size * tile_size;
  if (tile_size <= 0 || block > 1024 || block % 32 != 0 || D <= 0 || D > 32 || cap < 0 ||
      n_split < 1 || (block / 32) % n_split != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile_width = (width + tile_size - 1) / tile_size;
  const int tile_height = (height + tile_size - 1) / tile_size;
  const int tiles_per_image = tile_width * tile_height;
  const int n_tiles = n_images * tiles_per_image;
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TDGS_LAUNCH(CM)                                                        \
  launch<CM>(rows, counts, out_colors, out_T, n_tiles, width, height,          \
             tile_size, tile_width, tiles_per_image, D, cap, n_split, s)
  cudaError_t err;
  if (D <= 4) {
    err = TDGS_LAUNCH(4);
  } else if (D <= 8) {
    err = TDGS_LAUNCH(8);
  } else if (D <= 16) {
    err = TDGS_LAUNCH(16);
  } else {
    err = TDGS_LAUNCH(32);
  }
#undef TDGS_LAUNCH
  return static_cast<int>(err);
}
