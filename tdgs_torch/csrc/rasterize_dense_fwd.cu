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
// Design: one thread per pixel; the block stages each tile's valid rows in
// batches and each warp (two 16-pixel rows of a 16x16 tile) walks them on
// its own, culling the slots that cannot reach its pixels: the walk of
// composite_walk.cuh, shared with kernel 1, here over the tile's contiguous
// rows. A tile's 8 warps share one block, or, where tiles are few,
// n_split blocks of 8 / n_split warps, each staging the tile's rows (the
// wrapper picks n_split from the tile count and the card's SMs; the output
// does not depend on it). Slots past counts[t] are never read. Colours
// accumulate in registers (templated channel bound); pixels beyond the
// image edge are masked.
#include <cuda_runtime.h>

#include <cstdint>

#include "composite_walk.cuh"

namespace {

template <int CMAX>
__global__ void rasterize_dense_fwd_kernel(
    const float* __restrict__ rows,       // [T, cap, 6 + D]
    const int32_t* __restrict__ counts,   // [T]
    float* __restrict__ out_colors,       // [I, H, W, D]
    float* __restrict__ out_T,            // [I, H, W]
    int width, int height, int tile_size, int tile_width, int tiles_per_image,
    int D, int cap, int n_split) {
  extern __shared__ float4 smem4[];
  const int F = 6 + D;
  const int n_warps = blockDim.x >> 5;
  float* s_batches = reinterpret_cast<float*>(smem4);  // two batches
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
  const tdgswalk::Pixel centre = tdgswalk::pixel(px, py);

  const int count = max(0, min(counts[t], cap));
  const float* tile_rows = rows + static_cast<int64_t>(t) * cap * F;

  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
  float T = 1.f;
  bool done = !inside;
  // the whole block stages a batch from the tile's contiguous rows
  tdgswalk::walk<CMAX>(s_batches, count, D, centre, acc, T, done, [&](int from, float* dst) {
    const float* src = tile_rows + static_cast<int64_t>(from + lane) * F;
    tdgsstage::stage(dst, from + lane < count, lane, warp, n_warps, D,
                     [&](int f) { return src + f; });
  });

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
