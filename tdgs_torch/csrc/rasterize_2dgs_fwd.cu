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
// training path's depth of overlap. Measured on the H100 (kernel_ab.py, the
// earlier design: a block copying batches of 256 rows synchronously, every
// pixel evaluating every entry, at the bench shape): the staging cost
// nothing measurable, the correctly rounded reciprocal about 7%, and 37% of
// the warp-entries had a lane at which the entry reached alpha >= 1/255 --
// the ceiling of any per-warp cull; kernel 6's bound keeps 53%.
//
// Design: kernel 1's (rasterize_packed_fwd.cu) on the surfel walk of
// surfel_walk.cuh: one thread per pixel; the block stages each batch of 32
// entries asynchronously and double-buffered (cp.async, row_stage.cuh);
// each warp culls the entries that cannot reach its pixels (surfel_cull.cuh,
// kernel 6's bound) and walks the rest; each pixel stops at its own cutoff
// and the block once every pixel is done. Channels, transmittance, the
// distortion's prefix sums and the median live in registers.
// - The training call (kernel 5) stages the stream-order rows that the
//   wrapper gathers by flatten_ids (their VJP is the segment-sum kernel,
//   and kernel 6 reads the same rows): each batch is contiguous.
// - The inference call (kernel 4) reads through flatten_ids as kernel 1
//   does: each thread loads the gaussian id of its lane's entry a batch
//   ahead and copies that gaussian's per-gaussian feature row (padded to
//   whole float4s, so its geometry lands in three 16-byte copies) into the
//   batch. No stream-order copy of the rows is materialised.
// A tile's warps share one block, or n_split blocks (the wrapper's choice;
// the output does not depend on it). The TPU kernels' 3-slot DMA, rolled
// unaligned windows, log-space prefix products on the MXU and polynomial
// transcendentals are TPU artefacts and are not carried over.
#include <cuda_runtime.h>

#include <cstdint>

#include "surfel_walk.cuh"

namespace {

using tdgs2dgs::kGeomCols;
using tdgsstage::kBatch;

template <int CMAX, bool TRAIN>
__global__ void rasterize_2dgs_fwd_kernel(
    const float* __restrict__ rows,          // TRAIN: [L, 12 + DA] stream order;
                                             // else [G, row_stride] per gaussian
    const int32_t* __restrict__ flatten_ids, // [L] (inference)
    const int32_t* __restrict__ offsets,     // [T + 1]
    const float* __restrict__ backgrounds,   // [I, D] or nullptr (inference)
    float* __restrict__ out_colors,          // [I, H, W, D]
    float* __restrict__ out_normals,         // [I, H, W, 3]
    float* __restrict__ out_alphas,          // [I, H, W]: 1 - T, or T (training)
    float* __restrict__ out_dist,            // [I, H, W] (training)
    float* __restrict__ out_median,          // [I, H, W] (training)
    int width, int height, int tile_size, int tile_width, int tiles_per_image,
    int D, int max_entries, int depth_row, int compute_distort, int row_stride, int n_split) {
  extern __shared__ float4 smem4[];
  float* s_batches = reinterpret_cast<float*>(smem4);  // two batches
  const int DA = D + 3;
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

  tdgssurfel::Carry<CMAX> c;
  tdgssurfel::init(c, inside);
  const bool with_dist = TRAIN && depth_row >= 0 && compute_distort;
  if (TRAIN) {
    // the batch's rows are contiguous: thread (warp, lane) copies fields of
    // entry `lane`
    const int F = kGeomCols + DA;
    tdgssurfel::walk<CMAX, true>(
        s_batches, count, DA, centre, depth_row, with_dist, c, [&](int from, float* dst) {
          const bool valid = from + lane < count;
          const float* row = rows + static_cast<int64_t>(start + from + lane) * F;
          tdgsstage::stage<kGeomCols>(dst, valid, lane, warp, n_warps, DA,
                                      [&](int f) { return row + f; });
        });
  } else {
    // Thread (warp, lane) copies fields of entry `lane`, so it needs the
    // gaussian of its lane's entry alone, which it loads a batch ahead.
    const auto gaussian = [&](int from) {
      return from + lane < count ? flatten_ids[start + from + lane] : -1;
    };
    int g_next = -1;
    tdgssurfel::walk<CMAX, false>(
        s_batches, count, DA, centre, -1, false, c, [&](int from, float* dst) {
          const int64_t g = from == 0 ? gaussian(0) : g_next;
          g_next = gaussian(from + kBatch);
          tdgsstage::stage_row16<kGeomCols>(dst, g >= 0, lane, warp, n_warps, DA,
                                            rows + g * row_stride);
        });
  }

  if (!inside) return;
  const int64_t pix = (static_cast<int64_t>(image) * height + py) * width + px;
  const float alpha_out = 1.f - c.T;
  if (TRAIN) {
    out_alphas[pix] = c.T;
    out_dist[pix] = c.dist;
    out_median[pix] = c.med;
  } else {
    out_alphas[pix] = alpha_out;
  }
#pragma unroll
  for (int i = 0; i < CMAX; ++i) {
    if (i < D) {
      float v = c.acc[i];
      if (!TRAIN && backgrounds != nullptr) {
        v += (1.f - alpha_out) * backgrounds[image * D + i];
      }
      out_colors[pix * D + i] = v;
    } else if (i < DA) {
      out_normals[pix * 3 + (i - D)] = c.acc[i];
    }
  }
}

template <int CMAX, bool TRAIN>
cudaError_t launch(const float* rows, const int32_t* flatten_ids, const int32_t* offsets,
                   const float* backgrounds, float* out_colors, float* out_normals,
                   float* out_alphas, float* out_dist, float* out_median, int n_tiles,
                   int width, int height, int tile_size, int tile_width,
                   int tiles_per_image, int D, int max_entries, int depth_row,
                   int compute_distort, int row_stride, int n_split, cudaStream_t stream) {
  const int block = tile_size * tile_size / n_split;
  // two batches of at most 32 x (12 + 36) floats: 12 KB
  const size_t smem =
      static_cast<size_t>(2) * tdgsstage::batch_floats<kGeomCols>(D + 3) * sizeof(float);
  rasterize_2dgs_fwd_kernel<CMAX, TRAIN><<<n_tiles * n_split, block, smem, stream>>>(
      rows, flatten_ids, offsets, backgrounds, out_colors, out_normals, out_alphas,
      out_dist, out_median, width, height, tile_size, tile_width, tiles_per_image, D,
      max_entries, depth_row, compute_distort, row_stride, n_split);
  return cudaGetLastError();
}

template <bool TRAIN>
int dispatch(const float* rows, const int32_t* flatten_ids, const int32_t* offsets,
             const float* backgrounds, float* out_colors, float* out_normals,
             float* out_alphas, float* out_dist, float* out_median, int n_images,
             int width, int height, int tile_size, int tile_width, int tile_height, int D,
             int max_entries, int depth_row, int compute_distort, int row_stride,
             int n_split, void* stream) {
  const int tiles_per_image = tile_width * tile_height;
  const int n_tiles = n_images * tiles_per_image;
  const int block = tile_size * tile_size;
  if (tile_size <= 0 || block > 1024 || block % 32 != 0 || D <= 0 || D > 32 ||
      depth_row >= D || n_split < 1 || (block / 32) % n_split != 0 ||
      row_stride < kGeomCols + D + 3 || (!TRAIN && row_stride % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TDGS_LAUNCH(CM)                                                              \
  launch<CM, TRAIN>(rows, flatten_ids, offsets, backgrounds, out_colors, out_normals, \
                    out_alphas, out_dist, out_median, n_tiles, width, height,        \
                    tile_size, tile_width, tiles_per_image, D, max_entries,          \
                    depth_row, compute_distort, row_stride, n_split, s)
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
// `feats` holds one row per gaussian, `row_stride` floats apart (a multiple
// of 4, the pointer 16-byte aligned): 12 geometry floats, then the D + 3
// channels; `backgrounds` may be null. Tiles of a whole number of warps, at
// most 1024 pixels; n_split divides a tile's warps (the output does not
// depend on it).
extern "C" int tdgs_rasterize_2dgs_fwd(
    const float* feats, const int32_t* flatten_ids, const int32_t* offsets,
    const float* backgrounds, float* out_colors, float* out_normals, float* out_alphas,
    int n_images, int width, int height, int tile_size, int tile_width, int tile_height,
    int D, int max_entries, int row_stride, int n_split, void* stream) {
  if (reinterpret_cast<uintptr_t>(feats) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<false>(feats, flatten_ids, offsets, backgrounds, out_colors, out_normals,
                         out_alphas, nullptr, nullptr, n_images, width, height, tile_size,
                         tile_width, tile_height, D, max_entries, -1, 0, row_stride, n_split,
                         stream);
}

// Kernel 5, the training call on stream-order rows of 12 + D + 3 floats.
// Returns a cudaError_t (0 on success). `depth_row` < 0: no depth channel
// (distortion and median stay 0).
extern "C" int tdgs_rasterize_2dgs_fwd_train(
    const float* rows, const int32_t* offsets, float* out_colors, float* out_normals,
    float* out_T, float* out_dist, float* out_median, int n_images, int width, int height,
    int tile_size, int tile_width, int tile_height, int D, int max_entries, int depth_row,
    int compute_distort, int n_split, void* stream) {
  return dispatch<true>(rows, nullptr, offsets, nullptr, out_colors, out_normals, out_T,
                        out_dist, out_median, n_images, width, height, tile_size,
                        tile_width, tile_height, D, max_entries, depth_row, compute_distort,
                        kGeomCols + D + 3, n_split, stream);
}
