// Forward 2DGS (surfel) compositing over the sorted packed intersection
// stream: the inference call and the training call, two instances of one
// template.
//
// Replaces the TPU kernels tdgs/ops/rasterize_2dgs_pallas.py
//   `_fwd_kernel_2dgs_unaligned` (:84), called by
//   `rasterize_to_pixels_2dgs_packed_inference` (:182), and
//   `_fwd_kernel_2dgs_train` (:457), called by `_raster_2dgs_unaligned_fwd`
//   (:925) for `rasterize_to_pixels_2dgs_packed` (:335).
// Semantics, per pixel centre (px + 0.5, py + 0.5) and per entry of its
// tile's range offsets[t]..offsets[t+1], cut to `max_entries`, in stream
// order, with sigma from rasterize_2dgs_common.cuh:
//   alpha = min(0.999, op exp(-sigma)); the entry is skipped if alpha < 1/255
//   entry k is included iff prod_{j<=k} (1 - alpha_j) > 1e-4
//   acc += alpha T_prev ch_k over included entries (channels = colours
//   [+ depth] and the 3 camera-frame normals); T_out = prod (1 - alpha)
// The inference call writes colours with `backgrounds` blended as
// img + (1 - alpha) bg, alphas = 1 - T_out and normals. The training call
// writes colours (no background), normals, T_out itself (the backward
// needs its relative precision where T is small), and, with a depth
// channel at `depth_row`:
//   distortion = sum_k 2 w_k (d_k A_k - B_k), A_k, B_k the exclusive prefix
//   sums of w and w d over the included entries (when `compute_distort`);
//   median depth = d of the last included entry with T_prev > 0.5 and
//   w > 0, 0 where there is none.
//
// What bounds it on the H100: the (pixel, entry) evaluations -- the
// 2DGS walk (six products and six sums for tmp, one reciprocal, sigma3d,
// sigma2d, the min, one expf) and DA channel FMAs each -- against the FP32
// and SFU rates. The bytes (the entries' rows of 12 + DA floats, read once
// per tile, and the per-pixel outputs) are small beside them at the
// training path's depth of overlap.
//
// Design: kernel 1's (rasterize_packed_fwd.cu). One block per 16x16 tile,
// one thread per pixel. The feature rows arrive gathered in stream order
// (the wrapper gathers them by flatten_ids, so that their VJP is the
// segment-sum kernel), so each batch of up to blockDim entries is one
// contiguous, coalesced copy into shared memory, where every pixel reads it
// as a broadcast. Each pixel walks front to back and stops at its own
// cutoff; the block stops fetching once every pixel is done. Channels,
// transmittance, the distortion's prefix sums and the median live in
// registers. The TPU kernels' 3-slot DMA, rolled unaligned windows,
// log-space prefix products on the MXU and polynomial transcendentals are
// TPU artefacts and are not carried over.
#include <cuda_runtime.h>

#include <cstdint>

#include "rasterize_2dgs_common.cuh"

namespace {

using namespace tdgs2dgs;

template <int CMAX, bool TRAIN>
__global__ void rasterize_2dgs_fwd_kernel(
    const float* __restrict__ rows,         // [L, 12 + DA] stream order
    const int32_t* __restrict__ offsets,    // [T + 1]
    const float* __restrict__ backgrounds,  // [I, D] or nullptr (inference)
    float* __restrict__ out_colors,         // [I, H, W, D]
    float* __restrict__ out_normals,        // [I, H, W, 3]
    float* __restrict__ out_alphas,         // [I, H, W]: 1 - T, or T (training)
    float* __restrict__ out_dist,           // [I, H, W] (training)
    float* __restrict__ out_median,         // [I, H, W] (training)
    int width, int height, int tile_size, int tile_width, int tiles_per_image,
    int D, int max_entries, int depth_row, int compute_distort) {
  extern __shared__ float s_rows[];  // [blockDim, F]
  const int DA = D + 3;
  const int F = kGeomCols + DA;
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
  const float fx = static_cast<float>(px) + 0.5f;
  const float fy = static_cast<float>(py) + 0.5f;

  const int start = offsets[t];
  const int count = min(offsets[t + 1] - start, max_entries);
  const bool with_depth = TRAIN && depth_row >= 0;
  const bool with_dist = with_depth && compute_distort;

  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
  float T = 1.f;
  float A = 0.f, B = 0.f, dist = 0.f, med = 0.f;
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
      Response r;
      const float sigma = ray_splat_sigma(row, fx, fy, r);
      const float alpha = fminf(kAlphaClamp, __fmul_rn(row[11], expf(-sigma)));
      if (alpha < kAlphaThreshold) continue;
      const float next_T = __fmul_rn(T, __fsub_rn(1.f, alpha));
      if (next_T <= kTransmittanceEps) {
        done = true;
        break;
      }
      const float w = __fmul_rn(alpha, T);
#pragma unroll
      for (int c = 0; c < CMAX; ++c) {
        if (c < DA) acc[c] += w * row[kGeomCols + c];
      }
      if (with_depth) {
        const float d = row[kGeomCols + depth_row];
        if (with_dist) {
          dist += 2.f * w * (d * A - B);
          A += w;
          B += w * d;
        }
        if (T > 0.5f && w > 0.f) med = d;  // the last qualifying entry wins
      }
      T = next_T;
    }
  }

  if (!inside) return;
  const int64_t pix = (static_cast<int64_t>(image) * height + py) * width + px;
  const float alpha_out = 1.f - T;
  if (TRAIN) {
    out_alphas[pix] = T;
    out_dist[pix] = dist;
    out_median[pix] = med;
  } else {
    out_alphas[pix] = alpha_out;
  }
#pragma unroll
  for (int c = 0; c < CMAX; ++c) {
    if (c < D) {
      float v = acc[c];
      if (!TRAIN && backgrounds != nullptr) {
        v += (1.f - alpha_out) * backgrounds[image * D + c];
      }
      out_colors[pix * D + c] = v;
    } else if (c < DA) {
      out_normals[pix * 3 + (c - D)] = acc[c];
    }
  }
}

template <int CMAX, bool TRAIN>
cudaError_t launch(const float* rows, const int32_t* offsets,
                   const float* backgrounds, float* out_colors,
                   float* out_normals, float* out_alphas, float* out_dist,
                   float* out_median, int n_tiles, int width, int height,
                   int tile_size, int tile_width, int tiles_per_image, int D,
                   int max_entries, int depth_row, int compute_distort,
                   cudaStream_t stream) {
  const int block = tile_size * tile_size;
  const size_t smem = static_cast<size_t>(block) * (kGeomCols + D + 3) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterize_2dgs_fwd_kernel<CMAX, TRAIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rasterize_2dgs_fwd_kernel<CMAX, TRAIN><<<n_tiles, block, smem, stream>>>(
      rows, offsets, backgrounds, out_colors, out_normals, out_alphas, out_dist,
      out_median, width, height, tile_size, tile_width, tiles_per_image, D,
      max_entries, depth_row, compute_distort);
  return cudaGetLastError();
}

template <bool TRAIN>
int dispatch(const float* rows, const int32_t* offsets, const float* backgrounds,
             float* out_colors, float* out_normals, float* out_alphas,
             float* out_dist, float* out_median, int n_images, int width,
             int height, int tile_size, int tile_width, int tile_height, int D,
             int max_entries, int depth_row, int compute_distort, void* stream) {
  const int tiles_per_image = tile_width * tile_height;
  const int n_tiles = n_images * tiles_per_image;
  if (tile_size <= 0 || tile_size * tile_size > 1024 || D <= 0 || D > 32 ||
      depth_row >= D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TDGS_LAUNCH(CM)                                                       \
  launch<CM, TRAIN>(rows, offsets, backgrounds, out_colors, out_normals,      \
                    out_alphas, out_dist, out_median, n_tiles, width, height, \
                    tile_size, tile_width, tiles_per_image, D, max_entries,   \
                    depth_row, compute_distort, s)
  cudaError_t err;
  if (D + 3 <= 8) {
    err = TDGS_LAUNCH(8);
  } else if (D + 3 <= 16) {
    err = TDGS_LAUNCH(16);
  } else {
    err = TDGS_LAUNCH(35);
  }
#undef TDGS_LAUNCH
  return static_cast<int>(err);
}

}  // namespace

// Kernel 4, the inference call. Returns a cudaError_t (0 on success).
// `backgrounds` may be null.
extern "C" int tdgs_rasterize_2dgs_fwd(
    const float* rows, const int32_t* offsets, const float* backgrounds,
    float* out_colors, float* out_normals, float* out_alphas, int n_images,
    int width, int height, int tile_size, int tile_width, int tile_height,
    int D, int max_entries, void* stream) {
  return dispatch<false>(rows, offsets, backgrounds, out_colors, out_normals,
                         out_alphas, nullptr, nullptr, n_images, width, height,
                         tile_size, tile_width, tile_height, D, max_entries, -1, 0,
                         stream);
}

// Kernel 5, the training call. Returns a cudaError_t (0 on success).
// `depth_row` < 0: no depth channel (distortion and median stay 0).
extern "C" int tdgs_rasterize_2dgs_fwd_train(
    const float* rows, const int32_t* offsets, float* out_colors,
    float* out_normals, float* out_T, float* out_dist, float* out_median,
    int n_images, int width, int height, int tile_size, int tile_width,
    int tile_height, int D, int max_entries, int depth_row,
    int compute_distort, void* stream) {
  return dispatch<true>(rows, offsets, nullptr, out_colors, out_normals, out_T,
                        out_dist, out_median, n_images, width, height, tile_size,
                        tile_width, tile_height, D, max_entries, depth_row,
                        compute_distort, stream);
}
