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
// Measured on the H100 (kernel_ab.py, the earlier design: a block copying
// batches of 256 rows synchronously, every pixel evaluating every entry):
// the staging cost 0.7% at the bench shape, and 46% of the warp-entries
// had a lane at which the entry reached alpha >= 1/255 -- the ceiling of
// any per-warp cull.
//
// Design: kernel 9's (rasterize_dense_fwd.cu) on the eval3d rows. One
// thread per pixel, the pixel's ray (d, and o' when not CENTRAL) in
// registers. The feature rows arrive gathered in stream order (the wrapper
// gathers them by flatten_ids, so that their VJP is the segment-sum
// kernel).
// - Staging: entries come in batches of 32, which the whole block copies
//   into shared memory asynchronously and double-buffered (cp.async), each
//   row landing padded -- the 13 geometry floats as four float4s, the
//   channels as whole float4s -- so that a pixel reads an entry in 16-byte
//   broadcasts (row_stage.cuh, shared with kernels 1, 2, 9 and 10). Where
//   a row is 16-byte aligned (13 + D a multiple of 4: D = 3, 7, ...), its
//   three whole float4s of geometry are 16-byte copies.
// - Cull: before walking a batch, each lane tests one entry against the
//   warp's rays (ray_cull.cuh: the entry's silhouette against the box of
//   the warp's ray slopes, a conservative bound; the warp's frame in shared
//   memory, where it costs no registers), and the warp walks only the
//   entries that may reach alpha >= 1/255 along one of its rays. An entry
//   it skips would have been excluded at every pixel of the warp, so the
//   output is bitwise that of walking it.
// - Termination: a pixel past its cutoff evaluates nothing more, and the
//   block stops fetching once all its pixels are done.
// CENTRAL (o' = 0: a central camera with a global shutter) removes the M o'
// terms, as the Pallas kernel's `central` flag does. The arithmetic is
// rasterize_eval3d_common.cuh's, shared with kernel 8, which retraces the
// same inclusions. The TPU kernel's 3-slot DMA, rolled windows, log-space
// prefix products on the MXU, polynomial exp/log and HIGHEST-precision
// quadratic forms are TPU artefacts and are not carried over.
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "rasterize_eval3d_common.cuh"
#include "ray_cull.cuh"
#include "row_stage.cuh"

namespace {

using namespace tdgseval3d;
using tdgsstage::kBatch;
constexpr unsigned kFullMask = 0xffffffffu;

// Registers a thread: the cull's arithmetic, live beside the walk's state,
// lifts the RGB build (CMAX = 4) from 40 registers to 70 and its blocks per
// SM from 6 to 3. Capped at 48 (5 blocks) it took 0.62 ms at the bench
// shape against 0.69 uncapped (64: 0.63, 40: 0.63; kernel_ab.py on an
// H100); the wider builds keep what the compiler gives them (not measured
// capped).
constexpr int max_registers(int cmax) { return cmax <= 4 ? 48 : 255; }

template <int CMAX, bool CENTRAL>
__global__ void __maxnreg__(max_registers(CMAX)) rasterize_eval3d_fwd_kernel(
    const float* __restrict__ rows,         // [L, 13 + D] stream order
    const float* __restrict__ rays_d,       // [T, P, 3] world directions
    const float* __restrict__ rays_o,       // [T, P, 3] o' (not CENTRAL)
    const int32_t* __restrict__ offsets,    // [T + 1]
    const float* __restrict__ backgrounds,  // [I, D] or nullptr
    float* __restrict__ out_colors,         // [I, H, W, D]
    float* __restrict__ out_alphas,         // [I, H, W]: 1 - T, or T
    int width, int height, int tile_size, int tile_width, int tiles_per_image,
    int D, int max_entries, int write_transmittance, int wide) {
  constexpr int NQ = (CMAX + 3) / 4;  // float4s of channels
  extern __shared__ float4 smem4[];
  float* s_batches = reinterpret_cast<float*>(smem4);  // two batches
  const int F = kGeomCols + D;
  const int DP = tdgsstage::padded(D);
  const int BS = tdgsstage::batch_floats<kGeomCols>(D);
  const int n_warps = blockDim.x >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int t = blockIdx.x;
  const int image = t / tiles_per_image;
  const int t_in = t - image * tiles_per_image;
  const int ty = t_in / tile_width;
  const int tx = t_in - ty * tile_width;
  const int px = tx * tile_size + tid % tile_size;
  const int py = ty * tile_size + tid / tile_size;
  const bool inside = px < width && py < height;

  const int64_t ray = (static_cast<int64_t>(t) * blockDim.x + tid) * 3;
  float d[3], o[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    d[k] = rays_d[ray + k];
    if (!CENTRAL) o[k] = rays_o[ray + k];
  }
  // the warp's rays as the cull reads them, in shared memory (read after
  // the loop's first barrier)
  __shared__ tdgsraycull::WarpRays s_rays[32];
  {
    const tdgsraycull::WarpRays w =
        tdgsraycull::warp_rays<CENTRAL>(d, o, inside, min(tile_size, 32));
    if (lane == 0) s_rays[warp] = w;
  }

  const int start = offsets[t];
  const int count = min(offsets[t + 1] - start, max_entries);

  float acc[CMAX];
#pragma unroll
  for (int c = 0; c < CMAX; ++c) acc[c] = 0.f;
  float T = 1.f;
  bool done = !inside;

  // The whole block stages a batch from the contiguous stream-order rows:
  // thread (warp, lane) copies its share of entry `lane`.
  const auto stage = [&](int from, float* dst) {
    const float* row = rows + static_cast<int64_t>(start + from + lane) * F;
    const bool valid = from + lane < count;
    if (wide) {
      tdgsstage::stage_row16<kGeomCols>(dst, valid, lane, warp, n_warps, D, row);
    } else {
      tdgsstage::stage<kGeomCols>(dst, valid, lane, warp, n_warps, D,
                                  [&](int f) { return row + f; });
    }
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
    const float* s_ch = tdgsstage::colours<kGeomCols>(s_batches + buf * BS);
    // the batch's entries that may reach this warp's rays, one lane each
    unsigned todo = __ballot_sync(
        kFullMask, lane < n && tdgsraycull::may_reach(s_geo + 4 * lane, s_rays[warp]));
    while (todo != 0u) {
      const int k = __ffs(todo) - 1;
      todo &= todo - 1u;
      if (done) continue;
      float row[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = s_geo[4 * k + q];
        row[4 * q] = v.x;
        row[4 * q + 1] = v.y;
        row[4 * q + 2] = v.z;
        row[4 * q + 3] = v.w;
      }
      Response s;
      const float sigma = ray_sigma<CENTRAL>(row, d, o, s);
      if (!(s.gr < 0.f)) continue;
      const float alpha = fminf(kAlphaClamp, __fmul_rn(row[12], expf(-sigma)));
      if (alpha < kAlphaThreshold) continue;
      const float next_T = __fmul_rn(T, __fsub_rn(1.f, alpha));
      if (next_T <= kTransmittanceEps) {
        done = true;
        continue;
      }
      const float w = __fmul_rn(alpha, T);
      const float4* ch4 = reinterpret_cast<const float4*>(s_ch + k * DP);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (4 * q < D) {
          const float4 c4 = ch4[q];
          const float ch[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (4 * q + i < D) acc[4 * q + i] += w * ch[i];
          }
        }
      }
      T = next_T;
    }
  }
  tdgsasync::wait<0>();  // a batch still in flight after an early exit

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
  // two batches of at most 32 x (16 + 32) floats: 12 KB
  const size_t smem = static_cast<size_t>(2) * tdgsstage::batch_floats<kGeomCols>(D) *
                      sizeof(float);
  // rows of whole float4s, 16-byte aligned: 16-byte copies of the geometry
  const int wide = (kGeomCols + D) % 4 == 0 && reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  rasterize_eval3d_fwd_kernel<CMAX, CENTRAL><<<n_tiles, block, smem, stream>>>(
      rows, rays_d, rays_o, offsets, backgrounds, out_colors, out_alphas, width,
      height, tile_size, tile_width, tiles_per_image, D, max_entries,
      write_transmittance, wide);
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
