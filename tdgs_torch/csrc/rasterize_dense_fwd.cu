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
// small beside them. Early termination makes both depend on the data.
//
// Design: one block per 16x16 tile, one thread per pixel, as kernel 1
// (rasterize_packed_fwd.cu). The block copies each batch of up to blockDim
// valid rows, which are contiguous in memory, into shared memory with
// coalesced loads; every pixel reads them as broadcasts and walks the batch
// front to back, stopping at its own cutoff; the block stops fetching once
// every pixel is done (__syncthreads_count). Slots past counts[t] are never
// read. Colours accumulate in registers (templated channel bound); pixels
// beyond the image edge are masked.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;

template <int CMAX>
__global__ void rasterize_dense_fwd_kernel(
    const float* __restrict__ rows,       // [T, cap, 6 + D]
    const int32_t* __restrict__ counts,   // [T]
    float* __restrict__ out_colors,       // [I, H, W, D]
    float* __restrict__ out_T,            // [I, H, W]
    int width, int height, int tile_size, int tile_width, int tiles_per_image,
    int D, int cap) {
  extern __shared__ float s_rows[];  // [blockDim, 6 + D]
  const int block = blockDim.x;
  const int F = 6 + D;

  const int t = blockIdx.x;
  const int image = t / tiles_per_image;
  const int t_in = t - image * tiles_per_image;
  const int ty = t_in / tile_width;
  const int tx = t_in - ty * tile_width;
  const int tid = threadIdx.x;
  const int px = tx * tile_size + tid % tile_size;
  const int py = ty * tile_size + tid / tile_size;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px) + 0.5f;
  const float fy = static_cast<float>(py) + 0.5f;

  const int count = min(counts[t], cap);
  const float* tile_rows = rows + static_cast<int64_t>(t) * cap * F;

  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
  float T = 1.f;
  bool done = !inside;

  for (int b0 = 0; b0 < count; b0 += block) {
    // also the barrier that keeps the previous batch alive until read
    if (__syncthreads_count(done) == block) break;
    const int n = min(block, count - b0);
    const float* src = tile_rows + static_cast<int64_t>(b0) * F;
    for (int i = tid; i < n * F; i += block) s_rows[i] = src[i];
    __syncthreads();
    for (int k = 0; k < n && !done; ++k) {
      // sigma and alpha round each operation on its own (the _rn
      // intrinsics are never contracted into FMAs), as the plain PyTorch
      // version does, so the sigma < 0 and 1/255 tests agree bit for bit
      const float* r = s_rows + k * F;
      const float dx = __fsub_rn(r[0], fx);
      const float dy = __fsub_rn(r[1], fy);
      const float quad = __fadd_rn(__fmul_rn(__fmul_rn(r[2], dx), dx),
                                   __fmul_rn(__fmul_rn(r[4], dy), dy));
      const float sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(r[3], dx), dy));
      if (sigma < 0.f) continue;
      const float alpha = fminf(kAlphaClamp, __fmul_rn(r[5], expf(-sigma)));
      if (alpha < kAlphaThreshold) continue;
      const float next_T = __fmul_rn(T, __fsub_rn(1.f, alpha));
      if (next_T <= kTransmittanceEps) {
        done = true;
        break;
      }
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < D) acc[c] += w * r[6 + c];
      }
      T = next_T;
    }
  }

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
                   int tile_width, int tiles_per_image, int D, int cap,
                   cudaStream_t stream) {
  const int block = tile_size * tile_size;
  const size_t smem = static_cast<size_t>(block) * (6 + D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterize_dense_fwd_kernel<CMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rasterize_dense_fwd_kernel<CMAX><<<n_tiles, block, smem, stream>>>(
      rows, counts, out_colors, out_T, width, height, tile_size, tile_width,
      tiles_per_image, D, cap);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). D <= 32, at most 1024 pixels a
// tile; rows hold n_images * tiles_x * tiles_y tiles of `cap` slots.
extern "C" int tdgs_rasterize_dense_fwd(
    const float* rows, const int32_t* counts, float* out_colors, float* out_T,
    int n_images, int width, int height, int tile_size, int D, int cap,
    void* stream) {
  if (tile_size <= 0 || tile_size * tile_size > 1024 || D <= 0 || D > 32 || cap < 0) {
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
             tile_size, tile_width, tiles_per_image, D, cap, s)
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
