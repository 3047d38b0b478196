// Backward of the 3DGS compositing over tile-dense gathered rows: one
// gradient row per (tile, slot).
//
// Replaces the TPU kernel tdgs/ops/rasterize_pallas.py `_bwd_kernel` (:168),
// called by `_raster_core_bwd` (:339). Inputs are the forward's rows
// [T, cap, 6 + D] = (mx, my, a, b, c, opacity, colours) with counts[t]
// valid slots, its outputs (colours without background, T) and their
// cotangents. Per pixel centre (px + 0.5, py + 0.5) and per valid slot k,
// with alpha_k, vis_k = exp(-sigma_k) and the forward's inclusion rule
// (slot k is included iff prod_{j<=k} (1 - alpha_j) > 1e-4):
//   T_prev  = prod_{j<k} (1 - alpha_j)
//   w_k     = alpha_k T_prev,  r_k = sum_c v_col[c] color_k[c],  q_k = w_k r_k
//   suffix  = tot_q - sum_{j<=k} q_j,  tot_q = sum_c v_col[c] out_color[c]
//   v_alpha = r_k T_prev - suffix / (1 - alpha_k) + v_alpha_img T_final / (1 - alpha_k)
//   v_sigma = -op vis v_alpha where op vis <= 0.999 (else 0)
// with v_alpha_img = -v_T (the cotangent of alpha = 1 - T), tot_q over the
// colours before the background (:351). The slot's row, summed over the
// tile's pixels, is
//   [d mx, d my, d a, d b, d c, d op, d color_0..D-1]
//   = [v_sigma (a dx + b dy), v_sigma (b dx + c dy), v_sigma dx^2 / 2,
//      v_sigma dx dy, v_sigma dy^2 / 2, vis v_alpha (where unclamped),
//      w_k v_col[c]]
// with dx = mx - px, dy = my - py (:199, :233-242). Slots past counts[t],
// past every pixel's cutoff, or not included get zero rows.
//
// What bounds it on the H100: operations. Each (pixel, slot) evaluation
// costs the forward's sigma/alpha arithmetic, the suffix terms and 6 + D
// products; then every slot's 6 + D sums over the tile's 256 pixels. The
// bytes are small beside that: the valid rows, the per-pixel inputs, and
// the [T, cap, 6 + D] gradient rows written once.
//
// Design: kernel 2's (rasterize_packed_bwd.cu) on the dense layout. One
// block per 16x16 tile, one thread per pixel. Slots come in batches of 32,
// copied from the contiguous rows into shared memory. Each pixel walks
// forward to the forward's cutoff, keeping T_prev and the prefix of q (the
// JAX formulation, so parity is one to one). Per slot, a warp whose pixels
// all contribute zero skips the reduction; otherwise it sums its 32 pixels
// with a shuffle butterfly and lane 0 leaves the warp's 6 + D partial sums
// in shared memory. After the batch the block sums the 8 warps' partials in
// a fixed order and writes the batch's rows, which are contiguous. Every
// (tile, slot) row is written once, by its tile's block: no float atomics,
// and the result is deterministic. The TPU kernel's log-space prefixes,
// triangular matmuls and 128-slot chunk skip are MXU artefacts and are not
// carried over.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBatch = 32;

template <int CMAX>
__global__ void rasterize_dense_bwd_kernel(
    const float* __restrict__ rows,        // [T, cap, 6 + D]
    const int32_t* __restrict__ counts,    // [T]
    const float* __restrict__ out_colors,  // [I, H, W, D] forward colours
    const float* __restrict__ out_T,       // [I, H, W] final transmittance
    const float* __restrict__ v_colors,    // [I, H, W, D]
    const float* __restrict__ v_T,         // [I, H, W]
    float* __restrict__ v_rows,            // [T, cap, 6 + D]
    int width, int height, int tile_size, int tile_width, int tiles_per_image,
    int D, int cap) {
  extern __shared__ float smem[];
  const int F = 6 + D;
  const int n_warps = blockDim.x >> 5;
  float* s_rows = smem;                 // [kBatch, F]
  float* s_part = s_rows + kBatch * F;  // [n_warps, kBatch, F]

  const int t = blockIdx.x;
  const int image = t / tiles_per_image;
  const int t_in = t - image * tiles_per_image;
  const int ty = t_in / tile_width;
  const int tx = t_in - ty * tile_width;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int px = tx * tile_size + tid % tile_size;
  const int py = ty * tile_size + tid / tile_size;
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px) + 0.5f;
  const float fy = static_cast<float>(py) + 0.5f;

  const int count = min(counts[t], cap);
  const float* tile_rows = rows + static_cast<int64_t>(t) * cap * F;
  float* tile_out = v_rows + static_cast<int64_t>(t) * cap * F;

  float vcol[CMAX];
  float tot_q = 0.f;
  float va_tfin = 0.f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) vcol[c] = 0.f;
  if (inside) {
    const int64_t pix = (static_cast<int64_t>(image) * height + py) * width + px;
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < D) {
        vcol[c] = v_colors[pix * D + c];
        tot_q += vcol[c] * out_colors[pix * D + c];
      }
    }
    va_tfin = -v_T[pix] * out_T[pix];
  }
  float T = 1.f;
  float pref_q = 0.f;
  bool done = !inside;

  int b0 = 0;
  for (; b0 < count; b0 += kBatch) {
    // a barrier too: the previous batch's partials have all been read
    if (__syncthreads_count(done) == static_cast<int>(blockDim.x)) break;
    const int n = min(kBatch, count - b0);
    const float* src = tile_rows + static_cast<int64_t>(b0) * F;
    for (int i = tid; i < n * F; i += blockDim.x) s_rows[i] = src[i];
    __syncthreads();

    for (int k = 0; k < n; ++k) {
      const float* r = s_rows + k * F;
      float g_mx = 0.f, g_my = 0.f, g_a = 0.f, g_b = 0.f, g_c = 0.f, g_op = 0.f;
      float w = 0.f;
      bool live = false;
      if (!done) {
        // the forward's arithmetic, rounding for rounding (see
        // rasterize_dense_fwd.cu), so inclusion and cutoff agree with it
        const float ca = r[2], cb = r[3], cc = r[4];
        const float dx = __fsub_rn(r[0], fx);
        const float dy = __fsub_rn(r[1], fy);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                     __fmul_rn(__fmul_rn(cc, dy), dy));
        const float sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(cb, dx), dy));
        const float vis = expf(-sigma);
        const float op_vis = __fmul_rn(r[5], vis);
        const float alpha = fminf(kAlphaClamp, op_vis);
        if (sigma >= 0.f && alpha >= kAlphaThreshold) {
          const float one_minus = __fsub_rn(1.f, alpha);
          const float next_T = __fmul_rn(T, one_minus);
          if (next_T <= kTransmittanceEps) {
            done = true;
          } else {
            live = true;
            w = alpha * T;
            float rr = 0.f;
#pragma unroll
            for (int c = 0; c < CMAX; ++c) {
              if (c < D) rr += vcol[c] * r[6 + c];
            }
            pref_q += w * rr;
            const float ra = 1.f / one_minus;
            const float v_alpha = rr * T - (tot_q - pref_q) * ra + va_tfin * ra;
            if (op_vis <= kAlphaClamp) {
              const float v_sigma = -op_vis * v_alpha;
              g_mx = v_sigma * (ca * dx + cb * dy);
              g_my = v_sigma * (cb * dx + cc * dy);
              g_a = 0.5f * v_sigma * dx * dx;
              g_b = v_sigma * dx * dy;
              g_c = 0.5f * v_sigma * dy * dy;
              g_op = vis * v_alpha;
            }
            T = next_T;
          }
        }
      }
      float* part = s_part + (warp * kBatch + k) * F;
      if (__any_sync(kFullMask, live)) {
        float gc[CMAX];
#pragma unroll
        for (int c = 0; c < CMAX; ++c) gc[c] = (c < D) ? w * vcol[c] : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          g_mx += __shfl_xor_sync(kFullMask, g_mx, off);
          g_my += __shfl_xor_sync(kFullMask, g_my, off);
          g_a += __shfl_xor_sync(kFullMask, g_a, off);
          g_b += __shfl_xor_sync(kFullMask, g_b, off);
          g_c += __shfl_xor_sync(kFullMask, g_c, off);
          g_op += __shfl_xor_sync(kFullMask, g_op, off);
#pragma unroll
          for (int c = 0; c < CMAX; ++c) {
            if (c < D) gc[c] += __shfl_xor_sync(kFullMask, gc[c], off);
          }
        }
        if (lane == 0) {
          part[0] = g_mx;
          part[1] = g_my;
          part[2] = g_a;
          part[3] = g_b;
          part[4] = g_c;
          part[5] = g_op;
#pragma unroll
          for (int c = 0; c < CMAX; ++c) {
            if (c < D) part[6 + c] = gc[c];
          }
        }
      } else if (lane < F) {
        part[lane] = 0.f;
        if (lane + 32 < F) part[lane + 32] = 0.f;
      }
    }
    __syncthreads();

    // the batch's rows: the warps' partials summed in a fixed order
    float* dst = tile_out + static_cast<int64_t>(b0) * F;
    for (int i = tid; i < n * F; i += blockDim.x) {
      float s = 0.f;
      for (int wp = 0; wp < n_warps; ++wp) s += s_part[wp * kBatch * F + i];
      dst[i] = s;
    }
  }
  // zero rows: slots no pixel reached, and those past the tile's count
  for (int64_t i = static_cast<int64_t>(min(b0, count)) * F + tid;
       i < static_cast<int64_t>(cap) * F; i += blockDim.x) {
    tile_out[i] = 0.f;
  }
}

template <int CMAX>
cudaError_t launch(const float* rows, const int32_t* counts, const float* out_colors,
                   const float* out_T, const float* v_colors, const float* v_T,
                   float* v_rows, int n_tiles, int width, int height, int tile_size,
                   int tile_width, int tiles_per_image, int D, int cap,
                   cudaStream_t stream) {
  const int block = tile_size * tile_size;
  const int F = 6 + D;
  const size_t smem =
      static_cast<size_t>(kBatch) * F * (1 + block / 32) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterize_dense_bwd_kernel<CMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rasterize_dense_bwd_kernel<CMAX><<<n_tiles, block, smem, stream>>>(
      rows, counts, out_colors, out_T, v_colors, v_T, v_rows, width, height,
      tile_size, tile_width, tiles_per_image, D, cap);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). Tiles of a multiple of 32 pixels,
// at most 1024; D <= 32; `v_rows` has the shape of `rows`.
extern "C" int tdgs_rasterize_dense_bwd(
    const float* rows, const int32_t* counts, const float* out_colors,
    const float* out_T, const float* v_colors, const float* v_T, float* v_rows,
    int n_images, int width, int height, int tile_size, int D, int cap,
    void* stream) {
  const int block = tile_size * tile_size;
  if (tile_size <= 0 || block > 1024 || block % 32 != 0 || D <= 0 || D > 32 || cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile_width = (width + tile_size - 1) / tile_size;
  const int tile_height = (height + tile_size - 1) / tile_size;
  const int tiles_per_image = tile_width * tile_height;
  const int n_tiles = n_images * tiles_per_image;
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TDGS_LAUNCH(CM)                                                          \
  launch<CM>(rows, counts, out_colors, out_T, v_colors, v_T, v_rows, n_tiles,    \
             width, height, tile_size, tile_width, tiles_per_image, D, cap, s)
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
