// Backward of the 3DGS compositing over the sorted packed intersection
// stream: per-entry gradient rows, in stream order.
//
// Replaces the TPU kernel tdgs/ops/rasterize_pallas_packed.py
// `_bwd_kernel_unaligned` (:645) with its chunk math `_bwd_chunk_grads`
// (:568), called by `_raster_unaligned_bwd` (:921). Per pixel centre
// (px + 0.5, py + 0.5) and per entry k of its tile's range, cut to
// `max_entries` exactly as the forward cuts it, in stream order, with
// alpha_k, vis_k = exp(-sigma_k) and the inclusion rule of the forward
// (entry k is included iff prod_{j<=k} (1 - alpha_j) > 1e-4):
//   T_prev  = prod_{j<k} (1 - alpha_j)       (the forward's running product)
//   w_k     = alpha_k T_prev,  r_k = sum_c v_col[c] color_k[c],  q_k = w_k r_k
//   suffix  = tot_q - sum_{j<=k} q_j,  tot_q = sum_c v_col[c] out_color[c]
//   v_alpha = r_k T_prev - suffix / (1 - alpha_k) + v_alpha_img T_final / (1 - alpha_k)
//   v_sigma = -op vis v_alpha where op vis <= 0.999 (else 0)
// and the entry's row, summed over the tile's pixels, is
//   [d mx, d my, d a, d b, d c, d op, d color_0..D-1]
//   = [v_sigma (a dx + b dy), v_sigma (b dx + c dy), v_sigma dx^2 / 2,
//      v_sigma dx dy, v_sigma dy^2 / 2, vis v_alpha (where unclamped),
//      w_k v_col[c]]
// with dx = mx - px, dy = my - py. Entries past the cut, past every
// pixel's end of walk, or not included, get zero rows; so do the stream
// slots past offsets[T] (the padding the segment sum never reads).
// Inputs out_T (T_final) and v_T (the cotangent of T_final) come from the
// forward's training call; v_alpha_img = -v_T.
//
// What bounds it on the H100: operations. Each (pixel, entry) evaluation
// costs the forward's sigma/alpha arithmetic, the suffix terms, and 6 + D
// products; then every entry's 6 + D sums over the tile's 256 pixels. The
// bytes are small beside that: the gathered feature rows, the per-pixel
// inputs, and one row of 6 + D floats written per stream entry.
//
// Design: one block per 16x16 tile, one thread per pixel, as the forward.
// Entries come in batches of 32, gathered through flatten_ids into shared
// memory (no packed copy of the stream exists). Each pixel walks forward
// to the forward's cutoff and keeps T_prev and the prefix of q, which is
// the JAX formulation (not gsplat's back-to-front division), so parity is
// one to one. Per entry, a warp whose pixels all contribute zero skips the
// reduction; otherwise it sums its 32 pixels with a shuffle butterfly and
// lane 0 leaves the warp's 6 + D partial sums in shared memory. After the
// batch, the block sums the 8 warps' partials in a fixed order and writes
// the batch's rows, which are contiguous in the stream. Each stream
// position belongs to exactly one tile, so every row is written once, with
// no float atomics, and the result is deterministic. The TPU kernel's carry
// chunk, its 3-slot DMA ring and its log-space prefixes are artefacts of
// Mosaic's 128-aligned copies and the MXU, and are not carried over: kept
// entries of a truncated tile get their gradients here.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kBatch = 32;

template <int CMAX>
__global__ void rasterize_packed_bwd_kernel(
    const float* __restrict__ means2d,      // [G, 2]
    const float* __restrict__ conics,       // [G, 3]
    const float* __restrict__ opacities,    // [G]
    const float* __restrict__ colors,       // [G, D]
    const int32_t* __restrict__ offsets,    // [T + 1]
    const int32_t* __restrict__ flatten_ids,
    const float* __restrict__ out_colors,   // [I, H, W, D] forward colours
    const float* __restrict__ out_T,        // [I, H, W] final transmittance
    const float* __restrict__ v_colors,     // [I, H, W, D]
    const float* __restrict__ v_T,          // [I, H, W]
    float* __restrict__ v_rows,             // [L, 6 + D]
    int width, int height, int tile_size, int tile_width,
    int tiles_per_image, int n_tiles, int D, int max_entries, int64_t n_slots) {
  extern __shared__ float smem[];
  const int F = 6 + D;
  const int n_warps = blockDim.x >> 5;
  float* s_xy = smem;                      // [kBatch, 2]
  float* s_conic = s_xy + 2 * kBatch;      // [kBatch, 3]
  float* s_op = s_conic + 3 * kBatch;      // [kBatch]
  float* s_col = s_op + kBatch;            // [kBatch, D]
  float* s_part = s_col + kBatch * D;      // [n_warps, kBatch, F]

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
  const float fx = static_cast<float>(px) + 0.5f;
  const float fy = static_cast<float>(py) + 0.5f;

  const int start = offsets[t];
  const int end = offsets[t + 1];
  const int count = min(end - start, max_entries);

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
    if (tid < n) {
      const int64_t g = flatten_ids[start + b0 + tid];
      s_xy[2 * tid] = means2d[2 * g];
      s_xy[2 * tid + 1] = means2d[2 * g + 1];
      s_conic[3 * tid] = conics[3 * g];
      s_conic[3 * tid + 1] = conics[3 * g + 1];
      s_conic[3 * tid + 2] = conics[3 * g + 2];
      s_op[tid] = opacities[g];
      for (int c = 0; c < D; ++c) s_col[tid * D + c] = colors[g * D + c];
    }
    __syncthreads();

    for (int k = 0; k < n; ++k) {
      float g_mx = 0.f, g_my = 0.f, g_a = 0.f, g_b = 0.f, g_c = 0.f, g_op = 0.f;
      float w = 0.f;
      bool live = false;
      if (!done) {
        // the forward's arithmetic, rounding for rounding (see
        // rasterize_packed_fwd.cu), so inclusion and cutoff agree with it
        const float ca = s_conic[3 * k], cb = s_conic[3 * k + 1], cc = s_conic[3 * k + 2];
        const float dx = __fsub_rn(s_xy[2 * k], fx);
        const float dy = __fsub_rn(s_xy[2 * k + 1], fy);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                     __fmul_rn(__fmul_rn(cc, dy), dy));
        const float sigma = __fadd_rn(__fmul_rn(0.5f, quad),
                                      __fmul_rn(__fmul_rn(cb, dx), dy));
        const float vis = expf(-sigma);
        const float op_vis = __fmul_rn(s_op[k], vis);
        const float alpha = fminf(kAlphaClamp, op_vis);
        if (sigma >= 0.f && alpha >= kAlphaThreshold) {
          const float one_minus = __fsub_rn(1.f, alpha);
          const float next_T = __fmul_rn(T, one_minus);
          if (next_T <= kTransmittanceEps) {
            done = true;
          } else {
            live = true;
            w = alpha * T;
            float r = 0.f;
#pragma unroll
            for (int c = 0; c < CMAX; ++c) {
              if (c < D) r += vcol[c] * s_col[k * D + c];
            }
            pref_q += w * r;
            const float ra = 1.f / one_minus;
            const float v_alpha = r * T - (tot_q - pref_q) * ra + va_tfin * ra;
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
}

template <int CMAX>
cudaError_t launch(const float* means2d, const float* conics,
                   const float* opacities, const float* colors,
                   const int32_t* offsets, const int32_t* flatten_ids,
                   const float* out_colors, const float* out_T,
                   const float* v_colors, const float* v_T, float* v_rows,
                   int n_tiles, int width, int height, int tile_size,
                   int tile_width, int tiles_per_image, int D, int max_entries,
                   int64_t n_slots, cudaStream_t stream) {
  const int block = tile_size * tile_size;
  const int F = 6 + D;
  const size_t smem =
      static_cast<size_t>(kBatch) * (6 + D + (block / 32) * F) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterize_packed_bwd_kernel<CMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // blocks past the tiles zero the stream's padding rows
  const int64_t tail_blocks = (n_slots * F + 8 * block - 1) / (8 * block);
  const int n_tail = static_cast<int>(tail_blocks < 264 ? tail_blocks : 264);
  rasterize_packed_bwd_kernel<CMAX><<<n_tiles + n_tail, block, smem, stream>>>(
      means2d, conics, opacities, colors, offsets, flatten_ids, out_colors,
      out_T, v_colors, v_T, v_rows, width, height, tile_size, tile_width,
      tiles_per_image, n_tiles, D, max_entries, n_slots);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). tile_size must be a multiple of
// 32 pixels per tile (16x16 in practice), D <= 32, and `v_rows` holds
// n_slots rows of 6 + D floats.
extern "C" int tdgs_rasterize_packed_bwd(
    const float* means2d, const float* conics, const float* opacities,
    const float* colors, const int32_t* offsets, const int32_t* flatten_ids,
    const float* out_colors, const float* out_T, const float* v_colors,
    const float* v_T, float* v_rows, int n_images, int width, int height,
    int tile_size, int tile_width, int tile_height, int D, int max_entries,
    int64_t n_slots, void* stream) {
  const int tiles_per_image = tile_width * tile_height;
  const int n_tiles = n_images * tiles_per_image;
  const int block = tile_size * tile_size;
  if (tile_size <= 0 || block > 1024 || block % 32 != 0 || D <= 0 || D > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TDGS_LAUNCH(CM)                                                        \
  launch<CM>(means2d, conics, opacities, colors, offsets, flatten_ids,         \
             out_colors, out_T, v_colors, v_T, v_rows, n_tiles, width, height, \
             tile_size, tile_width, tiles_per_image, D, max_entries, n_slots, s)
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
