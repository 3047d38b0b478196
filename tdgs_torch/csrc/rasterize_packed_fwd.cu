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
// data. Measured on the H100 (kernel_ab.py, the earlier design: a block
// gathering batches of 256 entries synchronously, every pixel evaluating
// every entry), the staging cost nothing at the bench shape, and at the
// rally's (773 of 8,160 tiles hold entries, many cut at 1,024) the longest
// block lasted 96% of the launch: a chain of latencies, not the card's rate.
//
// Design: kernel 9's walk (composite_walk.cuh), with the rows read through
// flatten_ids as kernel 2 reads them: one thread per pixel; the block
// stages each batch of 32 entries asynchronously and double-buffered
// (cp.async), each thread loading the gaussian id of its lane's entry a
// batch ahead and copying that gaussian's fields from means2d, conics,
// opacities and colors into the padded rows of row_stage.cuh (no packed copy
// of the stream is materialised); each warp culls the entries that cannot
// reach its pixels (conic_cull.cuh) and walks the rest; each pixel stops at
// its own cutoff and the block once every pixel is done. A tile's warps
// share one block, or n_split blocks (the wrapper's choice; the output does
// not depend on it). Colours accumulate in registers (templated channel
// bound) and are written straight into the [I, H, W, D] image, with pixels
// beyond the image edge masked.
#include <cuda_runtime.h>

#include <cstdint>

#include "composite_walk.cuh"

namespace {

using tdgsstage::kBatch;

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
    int tiles_per_image, int D, int max_entries, int write_transmittance, int n_split) {
  extern __shared__ float4 smem4[];
  float* s_batches = reinterpret_cast<float*>(smem4);  // two batches
  const int n_warps = blockDim.x >> 5;
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

  const int start = offsets[t];
  const int count = min(offsets[t + 1] - start, max_entries);

  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
  float T = 1.f;
  bool done = !inside;

  // Thread (warp, lane) copies field `warp` (and every n_warps-th after it)
  // of entry `lane`, so it needs the gaussian of its lane's entry alone,
  // which it loads a batch ahead.
  const auto gaussian = [&](int from) {
    return from + lane < count ? flatten_ids[start + from + lane] : -1;
  };
  int g_next = -1;
  tdgswalk::walk<CMAX>(
      s_batches, count, D, centre, acc, T, done, [&](int from, float* dst) {
        const int64_t g = from == 0 ? gaussian(0) : g_next;
        g_next = gaussian(from + kBatch);
        tdgsstage::stage(dst, g >= 0, lane, warp, n_warps, D, [&](int f) {
          return f < 2   ? means2d + 2 * g + f
                 : f < 5 ? conics + 3 * g + (f - 2)
                 : f < 6 ? opacities + g
                         : colors + g * D + (f - 6);
        });
      });

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
                   int max_entries, int write_transmittance, int n_split,
                   cudaStream_t stream) {
  const int block = tile_size * tile_size / n_split;
  // two batches of at most 32 x (8 + 32) floats: 10 KB
  const size_t smem = static_cast<size_t>(2) * tdgsstage::batch_floats(D) * sizeof(float);
  rasterize_packed_fwd_kernel<CMAX><<<n_tiles * n_split, block, smem, stream>>>(
      means2d, conics, opacities, colors, offsets, flatten_ids, backgrounds,
      out_colors, out_alphas, width, height, tile_size, tile_width,
      tiles_per_image, D, max_entries, write_transmittance, n_split);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). `backgrounds` may be null;
// `write_transmittance` != 0 writes T_out into `out_alphas`. D <= 32; tiles
// of a whole number of warps, at most 1024 pixels; n_split divides a tile's
// warps (the output does not depend on it).
extern "C" int tdgs_rasterize_packed_fwd(
    const float* means2d, const float* conics, const float* opacities,
    const float* colors, const int32_t* offsets, const int32_t* flatten_ids,
    const float* backgrounds, float* out_colors, float* out_alphas,
    int n_images, int width, int height, int tile_size, int tile_width,
    int tile_height, int D, int max_entries, int write_transmittance, int n_split,
    void* stream) {
  const int tiles_per_image = tile_width * tile_height;
  const int n_tiles = n_images * tiles_per_image;
  const int block = tile_size * tile_size;
  if (tile_size <= 0 || block > 1024 || block % 32 != 0 || D <= 0 || D > 32 ||
      n_split < 1 || (block / 32) % n_split != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TDGS_LAUNCH(CM)                                                      \
  launch<CM>(means2d, conics, opacities, colors, offsets, flatten_ids,       \
             backgrounds, out_colors, out_alphas, n_tiles, width, height,    \
             tile_size, tile_width, tiles_per_image, D, max_entries,         \
             write_transmittance, n_split, s)
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
