// Forward 3DGS compositing over the sorted packed intersection stream.
//
// Replaces the TPU kernel tdgs/ops/rasterize_pallas_packed.py
// `_fwd_kernel_unaligned` (:322), called by
// `rasterize_to_pixels_packed_inference` (:447). Semantics, per pixel
// centre (px + 0.5, py + 0.5) and per entry of its tile's range
// offsets[t]..offsets[t+1], cut to `max_entries`, in stream order:
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy,  dx = mx - px
//   alpha = min(0.999, op exp(-sigma)); alpha = 0 if sigma < 0 or alpha < 1/255
//   entry k is included iff prod_{j<=k} (1 - alpha_j) > 1e-4
//   color += alpha T_prev c_k over included entries; T_out = prod (1 - alpha)
// Outputs: colors [I, H, W, D] with `backgrounds` blended as
// img + (1 - alpha) bg, and alphas = 1 - T_out [I, H, W]. The training call
// (`write_transmittance`, as `_raster_unaligned_fwd` :871 feeds the
// backward) writes T_out itself in place of the alphas: 1 - T loses the
// relative precision the backward needs where T is small.
//
// What bounds it on the H100: the (pixel, entry) evaluations -- a few FP32
// FMAs, one expf and D colour FMAs each -- against the FP32 and SFU rates;
// and the bytes of the gathered feature rows (flatten id + 6 + D floats per
// entry) plus the image writes. Early termination makes both depend on the
// data.
//
// This first design: one block per 16x16 tile, one thread per pixel. Each
// batch of up to blockDim entries is gathered cooperatively from the
// per-gaussian rows (the block reads flatten_ids itself, so no packed copy
// of the stream is materialised) into shared memory, where every pixel of
// the tile reads it as a broadcast. Each pixel walks the batch front to
// back and stops at its own cutoff; the block stops fetching once every
// pixel is done (__syncthreads_count). Colours are accumulated in registers
// (templated channel bound), written straight into the [I, H, W, D] image,
// with pixels beyond the image edge masked.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;

template <int CMAX>
__global__ void rasterize_packed_fwd_kernel(
    const float* __restrict__ means2d,      // [G, 2]
    const float* __restrict__ conics,       // [G, 3]
    const float* __restrict__ opacities,    // [G]
    const float* __restrict__ colors,       // [G, D]
    const int32_t* __restrict__ offsets,    // [T + 1]
    const int32_t* __restrict__ flatten_ids,
    const float* __restrict__ backgrounds,  // [I, D] or nullptr
    float* __restrict__ out_colors,         // [I, H, W, D]
    float* __restrict__ out_alphas,         // [I, H, W]
    int width, int height, int tile_size, int tile_width,
    int tiles_per_image, int D, int max_entries, int write_transmittance) {
  extern __shared__ float4 smem_raw[];
  const int block = blockDim.x;
  float2* s_xy = reinterpret_cast<float2*>(smem_raw);        // [block]
  float* s_conic = reinterpret_cast<float*>(s_xy + block);   // [block, 3]
  float* s_op = s_conic + 3 * block;                         // [block]
  float* s_col = s_op + block;                               // [block, D]

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

  const int start = offsets[t];
  const int count = min(offsets[t + 1] - start, max_entries);

  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
  float T = 1.f;
  bool done = !inside;

  for (int b0 = 0; b0 < count; b0 += block) {
    // also the barrier that keeps the previous batch alive until read
    if (__syncthreads_count(done) == block) break;
    const int e = b0 + tid;
    if (e < count) {
      const int64_t g = flatten_ids[start + e];
      s_xy[tid] = make_float2(means2d[2 * g], means2d[2 * g + 1]);
      s_conic[3 * tid] = conics[3 * g];
      s_conic[3 * tid + 1] = conics[3 * g + 1];
      s_conic[3 * tid + 2] = conics[3 * g + 2];
      s_op[tid] = opacities[g];
      for (int c = 0; c < D; ++c) s_col[tid * D + c] = colors[g * D + c];
    }
    __syncthreads();
    const int n = min(block, count - b0);
    for (int k = 0; k < n && !done; ++k) {
      // sigma and alpha round each operation on its own (the _rn
      // intrinsics are never contracted into FMAs), as the plain PyTorch
      // version does, so the sigma < 0 and 1/255 tests agree bit for bit
      const float2 xy = s_xy[k];
      const float dx = __fsub_rn(xy.x, fx);
      const float dy = __fsub_rn(xy.y, fy);
      const float quad = __fadd_rn(
          __fmul_rn(__fmul_rn(s_conic[3 * k], dx), dx),
          __fmul_rn(__fmul_rn(s_conic[3 * k + 2], dy), dy));
      const float sigma = __fadd_rn(
          __fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(s_conic[3 * k + 1], dx), dy));
      if (sigma < 0.f) continue;
      const float alpha = fminf(kAlphaClamp, __fmul_rn(s_op[k], expf(-sigma)));
      if (alpha < kAlphaThreshold) continue;
      const float next_T = __fmul_rn(T, __fsub_rn(1.f, alpha));
      if (next_T <= kTransmittanceEps) {
        done = true;
        break;
      }
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < D) acc[c] += w * s_col[k * D + c];
      }
      T = next_T;
    }
  }

  if (!inside) return;
  const int64_t pix = (static_cast<int64_t>(image) * height + py) * width + px;
  const float alpha_out = 1.f - T;
  out_alphas[pix] = write_transmittance ? T : alpha_out;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < D) {
      float v = acc[c];
      if (backgrounds != nullptr) v += (1.f - alpha_out) * backgrounds[image * D + c];
      out_colors[pix * D + c] = v;
    }
  }
}

template <int CMAX>
cudaError_t launch(const float* means2d, const float* conics,
                   const float* opacities, const float* colors,
                   const int32_t* offsets, const int32_t* flatten_ids,
                   const float* backgrounds, float* out_colors,
                   float* out_alphas, int n_tiles, int width, int height,
                   int tile_size, int tile_width, int tiles_per_image, int D,
                   int max_entries, int write_transmittance,
                   cudaStream_t stream) {
  const int block = tile_size * tile_size;
  const size_t smem = static_cast<size_t>(block) * (6 + D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterize_packed_fwd_kernel<CMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rasterize_packed_fwd_kernel<CMAX><<<n_tiles, block, smem, stream>>>(
      means2d, conics, opacities, colors, offsets, flatten_ids, backgrounds,
      out_colors, out_alphas, width, height, tile_size, tile_width,
      tiles_per_image, D, max_entries, write_transmittance);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). `backgrounds` may be null;
// `write_transmittance` != 0 writes T_out into `out_alphas`.
extern "C" int tdgs_rasterize_packed_fwd(
    const float* means2d, const float* conics, const float* opacities,
    const float* colors, const int32_t* offsets, const int32_t* flatten_ids,
    const float* backgrounds, float* out_colors, float* out_alphas,
    int n_images, int width, int height, int tile_size, int tile_width,
    int tile_height, int D, int max_entries, int write_transmittance,
    void* stream) {
  const int tiles_per_image = tile_width * tile_height;
  const int n_tiles = n_images * tiles_per_image;
  if (tile_size <= 0 || tile_size * tile_size > 1024 || D <= 0 || D > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TDGS_LAUNCH(CM)                                                      \
  launch<CM>(means2d, conics, opacities, colors, offsets, flatten_ids,       \
             backgrounds, out_colors, out_alphas, n_tiles, width, height,    \
             tile_size, tile_width, tiles_per_image, D, max_entries,         \
             write_transmittance, s)
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
