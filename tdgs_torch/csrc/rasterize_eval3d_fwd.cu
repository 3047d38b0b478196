// Forward world-space (eval3d, 3DGUT) compositing over the sorted packed
// intersection stream.
//
// Replaces the TPU kernel tdgs/ops/rasterize_eval3d_pallas.py
// `_fwd_kernel_eval3d_unaligned` (:98), called by `_raster_eval3d_fwd`
// (:832) for `rasterize_to_pixels_eval3d_packed` (:328).
// Semantics, per pixel of a 16x16 tile with its world ray (d, o') and per
// entry of the tile's range offsets[t]..offsets[t+1], cut to `max_entries`,
// in stream order, with sigma* and the g.r gate from
// rasterize_eval3d_common.cuh:
//   alpha = min(0.999, op exp(-sigma*)); the entry is skipped where g.r >= 0
//   or alpha < 1/255
//   entry k is included iff prod_{j<=k} (1 - alpha_j) > 1e-4
//   acc += alpha T_prev ch_k over included entries; T_out = prod (1 - alpha)
// The inference call writes colours with `backgrounds` blended as
// img + (1 - alpha) bg and alphas = 1 - T_out; the training call writes
// colours without background and T_out itself (the backward needs its
// relative precision where T is small).
//
// What bounds it on the H100: the (pixel, entry) evaluations -- r = M d
// (15 operations), g.r, the cross product and |c|^2, |r|^2, one division,
// one expf, then the walk and D channel FMAs -- against the FP32 and SFU
// rates. The bytes (the entries' rows of 13 + D floats, read once per
// tile, the rays and the per-pixel outputs) are small beside them.
//
// Design: kernel 1's (rasterize_packed_fwd.cu). One block per 16x16 tile,
// one thread per pixel, the pixel's ray (d, and o' when not CENTRAL) in
// registers. The feature rows arrive gathered in stream order (the wrapper
// gathers them by flatten_ids, so that their VJP is the segment-sum
// kernel), so each batch of up to blockDim entries is one contiguous,
// coalesced copy into shared memory, where every pixel reads it as a
// broadcast. Each pixel walks front to back and stops at its own cutoff;
// the block stops fetching once every pixel is done. CENTRAL (o' = 0: a
// central camera with a global shutter) removes the M o' terms, as the
// Pallas kernel's `central` flag does. The TPU kernel's 3-slot DMA, rolled
// windows, log-space prefix products on the MXU, polynomial exp/log and
// HIGHEST-precision quadratic forms are TPU artefacts and are not carried
// over.
#include <cuda_runtime.h>

#include <cstdint>

#include "rasterize_eval3d_common.cuh"

namespace {

using namespace tdgseval3d;

template <int CMAX, bool CENTRAL>
__global__ void rasterize_eval3d_fwd_kernel(
    const float* __restrict__ rows,         // [L, 13 + D] stream order
    const float* __restrict__ rays_d,       // [T, P, 3] world directions
    const float* __restrict__ rays_o,       // [T, P, 3] o' (not CENTRAL)
    const int32_t* __restrict__ offsets,    // [T + 1]
    const float* __restrict__ backgrounds,  // [I, D] or nullptr
    float* __restrict__ out_colors,         // [I, H, W, D]
    float* __restrict__ out_alphas,         // [I, H, W]: 1 - T, or T
    int width, int height, int tile_size, int tile_width, int tiles_per_image,
    int D, int max_entries, int write_transmittance) {
  extern __shared__ float s_rows[];  // [blockDim, F]
  const int F = kGeomCols + D;
  const int block = blockDim.x;

  const int t = blockIdx.x;
  const int image = t / tiles_per_image;
  const int t_in = t - image * tiles_per_image;
  const int ty = t_in / tile_width;
  const int tx = t_in - ty * tile_width;
  const int tid = threadIdx.x;
  const int px = tx * tile_size + tid % tile_size;
  const int py = ty * tile_size + tid / tile_size;
  const bool inside = px < width && py < height;

  const int64_t ray = (static_cast<int64_t>(t) * block + tid) * 3;
  float d[3], o[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d[k] = rays_d[ray + k];
    if (!CENTRAL) o[k] = rays_o[ray + k];
  }

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
    const int n = min(block, count - b0);
    const float* src = rows + static_cast<int64_t>(start + b0) * F;
    for (int i = tid; i < n * F; i += block) s_rows[i] = src[i];
    __syncthreads();
    for (int k = 0; k < n && !done; ++k) {
      const float* row = s_rows + k * F;
      Response s;
      const float sigma = ray_sigma<CENTRAL>(row, d, o, s);
      if (!(s.gr < 0.f)) continue;
      const float alpha = fminf(kAlphaClamp, __fmul_rn(row[12], expf(-sigma)));
      if (alpha < kAlphaThreshold) continue;
      const float next_T = __fmul_rn(T, __fsub_rn(1.f, alpha));
      if (next_T <= kTransmittanceEps) {
        done = true;
        break;
      }
      const float w = __fmul_rn(alpha, T);
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < D) acc[c] += w * row[kGeomCols + c];
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

template <int CMAX, bool CENTRAL>
cudaError_t launch(const float* rows, const float* rays_d, const float* rays_o,
                   const int32_t* offsets, const float* backgrounds,
                   float* out_colors, float* out_alphas, int n_tiles, int width,
                   int height, int tile_size, int tile_width, int tiles_per_image,
                   int D, int max_entries, int write_transmittance,
                   cudaStream_t stream) {
  const int block = tile_size * tile_size;
  const size_t smem = static_cast<size_t>(block) * (kGeomCols + D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterize_eval3d_fwd_kernel<CMAX, CENTRAL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rasterize_eval3d_fwd_kernel<CMAX, CENTRAL><<<n_tiles, block, smem, stream>>>(
      rows, rays_d, rays_o, offsets, backgrounds, out_colors, out_alphas, width,
      height, tile_size, tile_width, tiles_per_image, D, max_entries,
      write_transmittance);
  return cudaGetLastError();
}

template <bool CENTRAL>
cudaError_t dispatch(const float* rows, const float* rays_d, const float* rays_o,
                     const int32_t* offsets, const float* backgrounds,
                     float* out_colors, float* out_alphas, int n_tiles, int width,
                     int height, int tile_size, int tile_width, int tiles_per_image,
                     int D, int max_entries, int write_transmittance,
                     cudaStream_t stream) {
#define TDGS_LAUNCH(CM)                                                        \
  launch<CM, CENTRAL>(rows, rays_d, rays_o, offsets, backgrounds, out_colors,  \
                      out_alphas, n_tiles, width, height, tile_size,           \
                      tile_width, tiles_per_image, D, max_entries,             \
                      write_transmittance, stream)
  if (D <= 4) return TDGS_LAUNCH(4);
  if (D <= 8) return TDGS_LAUNCH(8);
  if (D <= 16) return TDGS_LAUNCH(16);
  return TDGS_LAUNCH(32);
#undef TDGS_LAUNCH
}

}  // namespace

// Kernel 7. Returns a cudaError_t (0 on success). `rays_o` null means a
// central camera (o' = 0); `backgrounds` may be null; with
// `write_transmittance` the alpha output holds T_out (the training call).
// tile_size^2 must be a whole number of warps, at most 1024; D <= 32.
extern "C" int tdgs_rasterize_eval3d_fwd(
    const float* rows, const float* rays_d, const float* rays_o,
    const int32_t* offsets, const float* backgrounds, float* out_colors,
    float* out_alphas, int n_images, int width, int height, int tile_size,
    int tile_width, int tile_height, int D, int max_entries,
    int write_transmittance, void* stream) {
  const int tiles_per_image = tile_width * tile_height;
  const int n_tiles = n_images * tiles_per_image;
  const int block = tile_size * tile_size;
  if (tile_size <= 0 || block > 1024 || block % 32 != 0 || D <= 0 || D > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      rays_o == nullptr
          ? dispatch<true>(rows, rays_d, rays_o, offsets, backgrounds, out_colors,
                           out_alphas, n_tiles, width, height, tile_size,
                           tile_width, tiles_per_image, D, max_entries,
                           write_transmittance, s)
          : dispatch<false>(rows, rays_d, rays_o, offsets, backgrounds, out_colors,
                            out_alphas, n_tiles, width, height, tile_size,
                            tile_width, tiles_per_image, D, max_entries,
                            write_transmittance, s);
  return static_cast<int>(err);
}
