// Backward of the world-space (eval3d, 3DGUT) compositing over the sorted
// packed intersection stream: per-entry gradient rows in stream order, and
// per-pixel gradients of the rays.
//
// Replaces the TPU kernel tdgs/ops/rasterize_eval3d_pallas.py
// `_bwd_kernel_eval3d_unaligned` (:495), called by `_raster_eval3d_bwd`
// (:881). Per pixel and per entry k of its tile's range, cut to
// `max_entries` exactly as the forward cuts it, in stream order, with
// sigma*, the g.r gate, alpha and the inclusion rule of the forward
// (rasterize_eval3d_common.cuh), vis = exp(-sigma*):
//   T_prev  = prod_{j<k} (1 - alpha_j),  w = alpha T_prev
//   r_ch    = sum_c v_ch[c] ch_k[c]
//   suffix  = tot_q - sum_{j<=k} w_j r_ch_j,  tot_q = sum_c v_ch[c] acc[c]
//   v_alpha = r_ch T_prev - suffix / (1 - alpha) + v_alpha_img T_final / (1 - alpha)
//   v_sigma = -op vis v_alpha, v_op = vis v_alpha where op vis <= 0.999
// and, with u = r x c = |r|^2 g_perp (g_perp the part of g normal to r,
// taken without cancellation) and k = v_sigma / |r|^2,
//   v_g = k u,   v_r = -k (g.r / |r|^2) u
//   d M_i = v_r_i d + v_g_i o',  d g0 = v_g       (per entry)
//   v_d  += M^T v_r,  v_o' += M^T v_g             (per pixel)
// The entry's row, summed over the tile's pixels, is
//   [d M (9), d g0 (3), d op, w v_ch (D)].
// Entries past the cut, past every pixel's end of walk, or not included,
// get zero rows; so do the stream slots past offsets[T]. T_final and v_T
// (v_alpha_img = -v_T) come from the forward's training call.
//
// What bounds it on the H100: operations. Each (pixel, entry) evaluation
// repeats the forward's sigma*, then the suffix terms, u, the 13 + D
// products of the entry's row and the 9 (18 when not CENTRAL) of the
// pixel's ray gradients, and every entry's 13 + D sums over the tile's 256
// pixels. The bytes -- the entries' rows, the rays, the per-pixel inputs,
// one row of 13 + D floats written per stream slot and the ray gradients
// -- are small beside that.
//
// Design: kernel 6's (rasterize_2dgs_bwd.cu) walk. One block per 16x16
// tile, one thread per pixel; entries in batches of 32, copied
// contiguously from the stream-order rows into shared memory. Each pixel
// walks forward to the forward's cutoff keeping T_prev and the prefix of
// q = w r_ch (the JAX formulation, so parity is one to one; the suffix is
// tot_q minus the prefix, in float32 throughout). Per entry, a warp whose
// pixels all contribute zero skips the reduction; otherwise it sums its 32
// pixels' 13 + D values, padded to NV (16 at D <= 3, 32 at D <= 16, 64
// beyond), by the transposing reduce-scatter of warp_reduce.cuh (16, 31
// or 62 shuffles at NV = 16, 32 or 64; a butterfly that left every sum in
// every lane would take 80 at D = 3, and shuffles run at a quarter of the
// FP32 rate), and the warp's partial row goes to shared memory in one
// coalesced store. After the batch the block sums the 8 warps' partials in
// a fixed order and writes the batch's rows, which are contiguous in the
// stream. Every stream position belongs to one tile, so each row is
// written once, with no float atomics, and every sum is taken in a fixed
// order: the result is deterministic. The ray gradients stay in each
// pixel's registers and are written once per tile.
// The TPU kernel's cross-tile carry chunk, which zeroes up to 127 kept
// entries of a truncated tile, is a Mosaic artefact and is not carried
// over: those entries get their gradients here.
#include <cuda_runtime.h>

#include <cstdint>

#include "rasterize_eval3d_common.cuh"
#include "warp_reduce.cuh"

namespace {

using namespace tdgseval3d;

using tdgswarp::kFullMask;
constexpr int kBatch = 32;

template <int CMAX, int NV, bool CENTRAL>
__global__ void rasterize_eval3d_bwd_kernel(
    const float* __restrict__ rows,        // [L, 13 + D] stream order
    const float* __restrict__ rays_d,      // [T, P, 3]
    const float* __restrict__ rays_o,      // [T, P, 3] (not CENTRAL)
    const int32_t* __restrict__ offsets,   // [T + 1]
    const float* __restrict__ out_colors,  // [I, H, W, D] forward
    const float* __restrict__ out_T,       // [I, H, W] final transmittance
    const float* __restrict__ v_colors,    // [I, H, W, D]
    const float* __restrict__ v_T,         // [I, H, W]
    float* __restrict__ v_rows,            // [L, 13 + D]
    float* __restrict__ v_d,               // [T, P, 3]
    float* __restrict__ v_o,               // [T, P, 3] (not CENTRAL)
    int width, int height, int tile_size, int tile_width, int tiles_per_image,
    int n_tiles, int D, int max_entries, int64_t n_slots) {
  static_assert(kGeomCols + CMAX <= NV, "a row's values fit the reduction");
  extern __shared__ float smem[];
  const int F = kGeomCols + D;
  const int n_warps = blockDim.x >> 5;
  float* s_rows = smem;                 // [kBatch, F]
  float* s_part = s_rows + kBatch * F;  // [n_warps, kBatch, F]

  const int tid = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= n_tiles) {
    // the stream's padding past offsets[T]: zero rows, grid-stride over the
    // blocks launched past the tiles
    const int64_t first = static_cast<int64_t>(offsets[n_tiles]) * F;
    const int64_t stride = static_cast<int64_t>(gridDim.x - n_tiles) * blockDim.x;
    for (int64_t i = first + static_cast<int64_t>(blockIdx.x - n_tiles) * blockDim.x + tid;
         i < n_slots * F; i += stride) {
      v_rows[i] = 0.f;
    }
    return;
  }

  const int t = blockIdx.x;
  const int image = t / tiles_per_image;
  const int t_in = t - image * tiles_per_image;
  const int ty = t_in / tile_width;
  const int tx = t_in - ty * tile_width;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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

  const int start = offsets[t];
  const int end = offsets[t + 1];
  const int count = min(end - start, max_entries);

  // per-pixel inputs; pixels outside the image contribute nothing
  float vch[CMAX];
  float tot_q = 0.f, va_tfin = 0.f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) vch[c] = 0.f;
  if (inside) {
    const int64_t pix = (static_cast<int64_t>(image) * height + py) * width + px;
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < D) {
        vch[c] = v_colors[pix * D + c];
        tot_q += vch[c] * out_colors[pix * D + c];
      }
    }
    va_tfin = -v_T[pix] * out_T[pix];
  }
  float T = 1.f;
  float pref_q = 0.f;
  float vd[3] = {0.f, 0.f, 0.f}, vo[3] = {0.f, 0.f, 0.f};
  bool done = !inside;

  int b0 = 0;
  for (; b0 < count; b0 += kBatch) {
    // a barrier too: the previous batch's rows and partials have been read
    if (__syncthreads_count(done) == static_cast<int>(blockDim.x)) break;
    const int n = min(kBatch, count - b0);
    const float* src = rows + static_cast<int64_t>(start + b0) * F;
    for (int i = tid; i < n * F; i += blockDim.x) s_rows[i] = src[i];
    __syncthreads();

    for (int k = 0; k < n; ++k) {
      const float* row = s_rows + k * F;
      float g[kGeomCols];  // d M (9), d g0 (3), d op
#pragma unroll
      for (int j = 0; j < kGeomCols; ++j) g[j] = 0.f;
      float w = 0.f;
      bool live = false;
      if (!done) {
        // the forward's arithmetic, rounding for rounding, so the gate,
        // inclusion and cutoff agree with it
        Response s;
        const float sigma = ray_sigma<CENTRAL>(row, d, o, s);
        const float vis = expf(-sigma);
        const float op_vis = __fmul_rn(row[12], vis);
        const float alpha = fminf(kAlphaClamp, op_vis);
        if (s.gr < 0.f && alpha >= kAlphaThreshold) {
          const float one_minus = __fsub_rn(1.f, alpha);
          const float next_T = __fmul_rn(T, one_minus);
          if (next_T <= kTransmittanceEps) {
            done = true;
          } else {
            live = true;
            w = __fmul_rn(alpha, T);
            float r_ch = 0.f;
#pragma unroll
            for (int c = 0; c < CMAX; ++c) {
              if (c < D) r_ch += vch[c] * row[kGeomCols + c];
            }
            pref_q += w * r_ch;
            const float ra = 1.f / one_minus;
            const float v_alpha = r_ch * T - (tot_q - pref_q) * ra + va_tfin * ra;
            if (op_vis <= kAlphaClamp) {
              const float v_sigma = -op_vis * v_alpha;
              g[12] = vis * v_alpha;
              const float kk = v_sigma / s.rr;
              const float coef = -kk * (s.gr / s.rr);
              const float u[3] = {s.r[1] * s.c[2] - s.r[2] * s.c[1],
                                  s.r[2] * s.c[0] - s.r[0] * s.c[2],
                                  s.r[0] * s.c[1] - s.r[1] * s.c[0]};
#pragma unroll
              for (int i = 0; i < 3; ++i) {
                const float v_r = coef * u[i];
                const float v_g = kk * u[i];
                g[9 + i] = v_g;
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                  g[3 * i + j] = CENTRAL ? v_r * d[j] : v_r * d[j] + v_g * o[j];
                  vd[j] += row[3 * i + j] * v_r;
                  if (!CENTRAL) vo[j] += row[3 * i + j] * v_g;
                }
              }
            }
            T = next_T;
          }
        }
      }
      float* part = s_part + (warp * kBatch + k) * F;
      if (__any_sync(kFullMask, live)) {
        float v[NV];  // d M (9), d g0 (3), d op, w v_ch (D), zero padding
#pragma unroll
        for (int j = 0; j < kGeomCols; ++j) v[j] = g[j];
#pragma unroll
        for (int j = kGeomCols; j < NV; ++j) v[j] = 0.f;
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          if (c < D) v[kGeomCols + c] = w * vch[c];
        }
        tdgswarp::reduce_scatter<NV>(v, lane);
        tdgswarp::store_scattered<NV>(part, v, lane, F);
      } else {
        tdgswarp::store_zero_row(part, lane, F);
      }
    }
    __syncthreads();

    // the batch's rows: the warps' partials summed in a fixed order
    float* dst = v_rows + static_cast<int64_t>(start + b0) * F;
    for (int i = tid; i < n * F; i += blockDim.x) {
      float s = 0.f;
      for (int wp = 0; wp < n_warps; ++wp) s += s_part[wp * kBatch * F + i];
      dst[i] = s;
    }
  }
  // zero rows: entries no pixel reached, and those past the tile's cut
  const int64_t zero_from = static_cast<int64_t>(start + min(b0, count)) * F;
  for (int64_t i = zero_from + tid; i < static_cast<int64_t>(end) * F; i += blockDim.x) {
    v_rows[i] = 0.f;
  }
  // the pixel's ray gradients, written once
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v_d[ray + k] = vd[k];
    if (!CENTRAL) v_o[ray + k] = vo[k];
  }
}

template <int CMAX, int NV, bool CENTRAL>
cudaError_t launch(const float* rows, const float* rays_d, const float* rays_o,
                   const int32_t* offsets, const float* out_colors,
                   const float* out_T, const float* v_colors, const float* v_T,
                   float* v_rows, float* v_d, float* v_o, int n_tiles, int width,
                   int height, int tile_size, int tile_width, int tiles_per_image,
                   int D, int max_entries, int64_t n_slots, cudaStream_t stream) {
  const int block = tile_size * tile_size;
  const int F = kGeomCols + D;
  const size_t smem =
      static_cast<size_t>(kBatch) * F * (1 + block / 32) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterize_eval3d_bwd_kernel<CMAX, NV, CENTRAL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // blocks past the tiles zero the stream's padding rows
  const int64_t tail_blocks = (n_slots * F + 8 * block - 1) / (8 * block);
  const int n_tail = static_cast<int>(tail_blocks < 264 ? tail_blocks : 264);
  rasterize_eval3d_bwd_kernel<CMAX, NV, CENTRAL>
      <<<n_tiles + n_tail, block, smem, stream>>>(
          rows, rays_d, rays_o, offsets, out_colors, out_T, v_colors, v_T, v_rows,
          v_d, v_o, width, height, tile_size, tile_width, tiles_per_image, n_tiles,
          D, max_entries, n_slots);
  return cudaGetLastError();
}

template <bool CENTRAL>
cudaError_t dispatch(const float* rows, const float* rays_d, const float* rays_o,
                     const int32_t* offsets, const float* out_colors,
                     const float* out_T, const float* v_colors, const float* v_T,
                     float* v_rows, float* v_d, float* v_o, int n_tiles, int width,
                     int height, int tile_size, int tile_width, int tiles_per_image,
                     int D, int max_entries, int64_t n_slots, cudaStream_t stream) {
#define TDGS_LAUNCH(CM, NV)                                                     \
  launch<CM, NV, CENTRAL>(rows, rays_d, rays_o, offsets, out_colors, out_T,       \
                          v_colors, v_T, v_rows, v_d, v_o, n_tiles, width, height, \
                          tile_size, tile_width, tiles_per_image, D, max_entries,  \
                          n_slots, stream)
  // NV: the 13 + CMAX values of a row padded to a power of two
  if (D <= 3) return TDGS_LAUNCH(3, 16);
  if (D <= 8) return TDGS_LAUNCH(8, 32);
  if (D <= 16) return TDGS_LAUNCH(16, 32);
  return TDGS_LAUNCH(32, 64);
#undef TDGS_LAUNCH
}

}  // namespace

// Kernel 8. Returns a cudaError_t (0 on success). `rays_o` and `v_o` null
// mean a central camera (o' = 0, no origin gradients). tile_size^2 must be
// a whole number of warps, at most 1024; D <= 32; `v_rows` holds n_slots
// rows of 13 + D floats, `v_d` (and `v_o`) one ray per tile pixel.
extern "C" int tdgs_rasterize_eval3d_bwd(
    const float* rows, const float* rays_d, const float* rays_o,
    const int32_t* offsets, const float* out_colors, const float* out_T,
    const float* v_colors, const float* v_T, float* v_rows, float* v_d,
    float* v_o, int n_images, int width, int height, int tile_size,
    int tile_width, int tile_height, int D, int max_entries, int64_t n_slots,
    void* stream) {
  const int tiles_per_image = tile_width * tile_height;
  const int n_tiles = n_images * tiles_per_image;
  const int block = tile_size * tile_size;
  if (tile_size <= 0 || block > 1024 || block % 32 != 0 || D <= 0 || D > 32 ||
      (rays_o == nullptr) != (v_o == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      rays_o == nullptr
          ? dispatch<true>(rows, rays_d, rays_o, offsets, out_colors, out_T,
                           v_colors, v_T, v_rows, v_d, v_o, n_tiles, width, height,
                           tile_size, tile_width, tiles_per_image, D, max_entries,
                           n_slots, s)
          : dispatch<false>(rows, rays_d, rays_o, offsets, out_colors, out_T,
                            v_colors, v_T, v_rows, v_d, v_o, n_tiles, width, height,
                            tile_size, tile_width, tiles_per_image, D, max_entries,
                            n_slots, s);
  return static_cast<int>(err);
}
