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
// inputs, and one row of 6 + D floats written per stream entry. Measured
// on the H100 by ablation at the bench shapes (D = 3; kernel_ab.py), the
// earlier design of this kernel, which summed each entry's 6 + D columns
// by a warp butterfly (45 shuffles per warp-entry) and stored them from
// one lane, spent about half its time there, half in the walk, and next to
// nothing in the synchronous gather of the rows.
//
// Design: one block per 16x16 tile, one thread per pixel, as the forward.
// Entries come in batches of 32, gathered through flatten_ids into shared
// memory (no packed copy of the stream exists), an entry's geometry as two
// float4s (mx, my, a, b; c, op) and its colours padded to whole float4s,
// so that a pixel reads them in 16-byte broadcasts (row_stage.cuh, shared
// with kernels 9 and 10). The whole block
// gathers, asynchronously and double-buffered: while the current batch is
// walked, each thread starts the copies (cp.async, async_copy.cuh) of one
// lane's entry's fields of the next batch, the entry's gaussian id loaded a
// batch ahead. Each pixel walks
// forward to the forward's cutoff and keeps T_prev and the prefix of q,
// which is the JAX formulation (not gsplat's back-to-front division), so
// parity is one to one. Per entry, a warp whose pixels all contribute zero
// skips the reduction; otherwise it sums its 32 pixels' values by the
// transposing reduce-scatter of warp_reduce.cuh and writes its partial row
// to shared memory in one store. With 16-pixel tile rows a warp's two
// half-warps are two pixel rows, each at one dy, so the five geometry
// columns follow from three sums over each row (of v_sigma, v_sigma dx and
// v_sigma dx^2): at D <= 4 the 4 + D values fit 8 lanes, 12 shuffles per
// warp-entry where a butterfly over the 6 + D columns took 45. Otherwise
// the 6 + D columns are padded to NV (16 at D <= 10, 32 at D <= 26, 64
// beyond). After the batch, the block sums the 8 warps' partials in a
// fixed order and writes the batch's rows, which are contiguous in the
// stream. Each stream position belongs to exactly one tile, so every row
// is written once, with no float atomics, and the result is deterministic.
// A per-warp cull of the entries that cannot reach a warp's pixels
// (kernel 6's) skips 32% of the warp-entries here, but its effect on the
// H100 was within the spread between calls: the 3DGS evaluation it saves
// is cheap.
// The TPU kernel's carry chunk, its 3-slot DMA ring and its log-space
// prefixes are artefacts of Mosaic's 128-aligned copies and the MXU, and
// are not carried over: kept entries of a truncated tile get their
// gradients here.
//
// Arithmetic: sigma, op vis, alpha, 1 - alpha and next_T round on their
// own (_rn intrinsics, never contracted), as in the forward kernel 1, so
// inclusion and cutoff agree with it rounding for rounding. The gradient
// arithmetic after an entry is live may contract to FMAs, and
// 1 / (1 - alpha) is an approximate reciprocal (1 - alpha >= 0.001, well
// conditioned; within the 1e-3 tolerance against the plain version).
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "row_stage.cuh"
#include "warp_reduce.cuh"

namespace {

using tdgswarp::kFullMask;

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
using tdgsstage::kBatch;

// CMAX: the colour bound (D <= CMAX). HALF_ROWS: each half-warp is one
// pixel row (tile rows of 16 or 32 pixels), so dy is one value per half-warp
// and the five geometry columns come from three moments of v_sigma over
// it; only with CMAX = 4.
template <int CMAX, bool HALF_ROWS>
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
  constexpr int NV = tdgswarp::reduce_width(6 + CMAX);
  static_assert(!HALF_ROWS || CMAX == 4, "HALF_ROWS reduces 4 + D <= 8 values");
  constexpr int NQ = (CMAX + 3) / 4;  // float4s of colours
  extern __shared__ float4 smem4[];
  const int F = 6 + D;
  const int DP = tdgsstage::padded(D);
  const int n_warps = blockDim.x >> 5;
  // two batches, then the warps' partial rows
  const int BS = tdgsstage::batch_floats(D);
  float* s_batches = reinterpret_cast<float*>(smem4);  // [2, BS]
  float* s_part = s_batches + 2 * BS;                   // [n_warps, kBatch, F]

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

  // The whole block gathers a batch: thread tid copies field tid / 32 (and
  // every n_warps-th after it) of entry tid % 32, so each thread needs the
  // gaussian of its lane's entry alone, which it loads a batch ahead.
  const auto gaussian = [&](int from) {
    return from + lane < count ? flatten_ids[start + from + lane] : -1;
  };
  const auto stage = [&](int g, float* dst) {
    const int64_t g64 = g;
    tdgsstage::stage(dst, g >= 0, lane, warp, n_warps, D, [&](int f) {
      return f < 2   ? means2d + 2 * g64 + f
             : f < 5 ? conics + 3 * g64 + (f - 2)
             : f < 6 ? opacities + g64
                     : colors + g64 * D + (f - 6);
    });
  };
  if (count > 0) stage(gaussian(0), s_batches);
  int g_next = gaussian(kBatch);
  int b0 = 0;
  for (int buf = 0; b0 < count; b0 += kBatch, buf ^= 1) {
    // a barrier too: the previous batch's rows and partials have been read
    if (__syncthreads_count(done) == static_cast<int>(blockDim.x)) break;
    const int n = min(kBatch, count - b0);
    // the next batch lands in the other buffer while this one is walked
    if (b0 + kBatch < count) {
      stage(g_next, s_batches + (buf ^ 1) * BS);
      g_next = gaussian(b0 + 2 * kBatch);
    } else {
      tdgsasync::commit();
    }
    tdgsasync::wait<1>();
    __syncthreads();
    const float4* s_geo = tdgsstage::geometry(s_batches + buf * BS);
    const float* s_col = tdgsstage::colours(s_batches + buf * BS);

    for (int k = 0; k < n; ++k) {
      float* part = s_part + (warp * kBatch + k) * F;
      // d mx, d my, d a, d b, d c; with HALF_ROWS the moments v_sigma,
      // v_sigma dx, v_sigma dx^2 in the first three
      float g_mx = 0.f, g_my = 0.f, g_a = 0.f, g_b = 0.f, g_c = 0.f, g_op = 0.f;
      float w = 0.f;
      bool live = false;
      if (!done) {
        const float4 q0 = s_geo[2 * k], q1 = s_geo[2 * k + 1];
        const float ca = q0.z, cb = q0.w, cc = q1.x;
        // the forward's arithmetic, rounding for rounding (see
        // rasterize_packed_fwd.cu), so inclusion and cutoff agree with it
        const float dx = __fsub_rn(q0.x, fx);
        const float dy = __fsub_rn(q0.y, fy);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                     __fmul_rn(__fmul_rn(cc, dy), dy));
        const float sigma = __fadd_rn(__fmul_rn(0.5f, quad),
                                      __fmul_rn(__fmul_rn(cb, dx), dy));
        const float vis = expf(-sigma);
        const float op_vis = __fmul_rn(q1.y, vis);
        const float alpha = fminf(kAlphaClamp, op_vis);
        if (sigma >= 0.f && alpha >= kAlphaThreshold) {
          const float one_minus = __fsub_rn(1.f, alpha);
          const float next_T = __fmul_rn(T, one_minus);
          if (next_T <= kTransmittanceEps) {
            done = true;
          } else {
            // the gradients: contracted, approximate reciprocal
            live = true;
            w = alpha * T;
            const float4* col4 = reinterpret_cast<const float4*>(s_col + k * DP);
            float col[4 * NQ];
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              if (4 * q < D) {
                const float4 c4 = col4[q];
                col[4 * q] = c4.x;
                col[4 * q + 1] = c4.y;
                col[4 * q + 2] = c4.z;
                col[4 * q + 3] = c4.w;
              }
            }
            float r = 0.f;
#pragma unroll
            for (int c = 0; c < CMAX; ++c) {
              if (c < D) r += vcol[c] * col[c];
            }
            pref_q += w * r;
            const float ra = __fdividef(1.f, one_minus);
            const float v_alpha = r * T - (tot_q - pref_q) * ra + va_tfin * ra;
            if (op_vis <= kAlphaClamp) {
              const float v_sigma = -op_vis * v_alpha;
              if constexpr (HALF_ROWS) {
                g_mx = v_sigma;
                g_my = v_sigma * dx;
                g_a = g_my * dx;
              } else {
                g_mx = v_sigma * (ca * dx + cb * dy);
                g_my = v_sigma * (cb * dx + cc * dy);
                g_a = 0.5f * v_sigma * dx * dx;
                g_b = v_sigma * dx * dy;
                g_c = 0.5f * v_sigma * dy * dy;
              }
              g_op = vis * v_alpha;
            }
            T = next_T;
          }
        }
      }
      if (!__any_sync(kFullMask, live)) {
        tdgswarp::store_zero_row(part, lane, F);
      } else if constexpr (HALF_ROWS) {
        // the moments, d op and w v_col (D <= 4) summed over each half-warp:
        // a reduce-scatter over 8 lanes leaves lane l column l & 7, one more
        // shuffle the half-warp's sum. Over a pixel row at one dy,
        //   d mx = a S(v dx) + b dy S(v),  d my = b S(v dx) + c dy S(v),
        //   d a = S(v dx^2) / 2,  d b = dy S(v dx),  d c = dy^2 S(v) / 2,
        // then the two rows' values are added: 12 shuffles where the 6 + D
        // columns took 16.
        float v[8] = {g_mx, g_my, g_a, g_op, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          if (c < D) v[4 + c] = w * vcol[c];
        }
        tdgswarp::halve<4, 4>(v, lane);
        const float sum = v[0] + __shfl_xor_sync(kFullMask, v[0], 8);
        const int row = lane & 16;
        const float m0 = __shfl_sync(kFullMask, sum, row);
        const float m1 = __shfl_sync(kFullMask, sum, row | 1);
        const float m2 = __shfl_sync(kFullMask, sum, row | 2);
        const float4 q0 = s_geo[2 * k], q1 = s_geo[2 * k + 1];
        const float dy = __fsub_rn(q0.y, fy);
        // lanes 0-4 of a half-warp: the geometry columns; 11: d op; 12-15:
        // the colours (lanes 8-15 hold columns 0-7 again)
        const int j = lane & 15;
        float val = sum;
        if (j == 0) val = q0.z * m1 + q0.w * dy * m0;
        if (j == 1) val = q0.w * m1 + q1.x * dy * m0;
        if (j == 2) val = 0.5f * m2;
        if (j == 3) val = dy * m1;
        if (j == 4) val = 0.5f * dy * dy * m0;
        val += __shfl_xor_sync(kFullMask, val, 16);
        const int col = j < 5 ? j : (j == 11 ? 5 : j - 6);
        if (lane < 16 && (j < 5 || j == 11 || (j >= 12 && j - 12 < D))) part[col] = val;
      } else {
        float v[NV];  // d mx, d my, d a, d b, d c, d op, w v_col (D), zero padding
        v[0] = g_mx;
        v[1] = g_my;
        v[2] = g_a;
        v[3] = g_b;
        v[4] = g_c;
        v[5] = g_op;
#pragma unroll
        for (int j = 6; j < NV; ++j) v[j] = 0.f;
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          if (c < D) v[6 + c] = w * vcol[c];
        }
        tdgswarp::reduce_scatter<NV>(v, lane);
        tdgswarp::store_scattered<NV>(part, v, lane, F);
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
  tdgsasync::wait<0>();  // a batch still in flight after an early exit
  // zero rows: entries no pixel reached, and those past the tile's cut
  const int64_t zero_from = static_cast<int64_t>(start + min(b0, count)) * F;
  for (int64_t i = zero_from + tid; i < static_cast<int64_t>(end) * F; i += blockDim.x) {
    v_rows[i] = 0.f;
  }
}

template <int CMAX, bool HALF_ROWS>
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
      (static_cast<size_t>(2) * tdgsstage::batch_floats(D) + kBatch * (block / 32) * F) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterize_packed_bwd_kernel<CMAX, HALF_ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // blocks past the tiles zero the stream's padding rows
  const int64_t tail_blocks = (n_slots * F + 8 * block - 1) / (8 * block);
  const int n_tail = static_cast<int>(tail_blocks < 264 ? tail_blocks : 264);
  rasterize_packed_bwd_kernel<CMAX, HALF_ROWS><<<n_tiles + n_tail, block, smem, stream>>>(
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
#define TDGS_LAUNCH(CM, HALF)                                                   \
  launch<CM, HALF>(means2d, conics, opacities, colors, offsets, flatten_ids,    \
                   out_colors, out_T, v_colors, v_T, v_rows, n_tiles, width,    \
                   height, tile_size, tile_width, tiles_per_image, D,           \
                   max_entries, n_slots, s)
  cudaError_t err;
  // the values reduced per entry: 4 + D <= 8 when half-warps are pixel
  // rows (D <= 4); else the 6 + D columns padded to NV = 16 (D <= 10), 32
  // (D <= 26) or 64
  if (D <= 4 && tile_size % 16 == 0) {
    err = TDGS_LAUNCH(4, true);
  } else if (D <= 4) {
    err = TDGS_LAUNCH(4, false);
  } else if (D <= 10) {
    err = TDGS_LAUNCH(10, false);
  } else if (D <= 26) {
    err = TDGS_LAUNCH(26, false);
  } else {
    err = TDGS_LAUNCH(32, false);
  }
#undef TDGS_LAUNCH
  return static_cast<int>(err);
}
