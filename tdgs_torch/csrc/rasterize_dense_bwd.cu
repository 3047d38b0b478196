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
// What bounds it on the H100: bytes and operations about equally. The
// [T, cap, 6 + D] gradient rows are written once (301 MB at the bench
// shape, 267 MB of them zeros past the counts); beside them the valid rows
// and the per-pixel inputs are small. Each (pixel, slot) evaluation costs
// the forward's sigma/alpha arithmetic; a live one adds the suffix terms
// and 6 + D products, and every slot's 6 + D sums run over the tile's 256
// pixels. Measured on the H100 by ablation (kernel_ab.py), the earlier
// design of this kernel -- kernel 2's first design on this layout, a warp
// butterfly over the 6 + D columns per slot stored from one lane -- spent
// about half its time in that reduction; and at a shape of few tiles
// (image fitting's 64) it left most of the card idle, each tile's block
// walking its slots in series.
//
// Design: kernel 2's (rasterize_packed_bwd.cu) on the dense layout, with
// kernel 9's cull. One block of one thread per pixel for each range of a
// 16x16 tile's slots.
// Slots come in batches of 32, copied from the contiguous rows into shared
// memory, asynchronously and double-buffered (cp.async of 4-byte values,
// each row landing padded: row_stage.cuh, shared with kernels 2 and 9).
// Each pixel walks forward to the forward's cutoff, keeping T_prev and the
// prefix of q (the JAX formulation, so parity is one to one). Before a
// batch, each lane tests one slot against the box of its warp's pixel
// centres (conic_cull.cuh, conservative), and the warp skips the slots that
// no pixel of it can include: their partial rows are zero, as walking them
// would leave them. Per slot, a warp whose
// pixels all contribute zero skips the reduction; otherwise it sums its 32
// pixels' values by the transposing reduce-scatter of warp_reduce.cuh (16
// shuffles per warp-slot at D <= 10) and writes its partial row to shared
// memory in one store. After the batch the block sums the 8 warps'
// partials in a fixed order and writes the batch's rows, which are
// contiguous. (Kernel 2's half-warp rows -- the geometry columns from three
// moments over each 16-pixel row, 12 shuffles -- measured slower here once
// the cull was in, at both shapes.)
// - The zero rows past the tile's count go out in 16-byte stores before the
//   walk, so that they overlap it.
// - Ranges: where tiles are few, each tile's valid slots are cut into
//   n_split ranges of whole batches, one block each. A block first replays
//   the walk over the slots before its range without reducing: the same
//   instructions on the same values, so T_prev, the prefix of q and each
//   pixel's cutoff reach its range bit for bit as in one block. Each
//   (tile, slot) row is still written once, by one block: no float atomics,
//   and the rows are bitwise those of n_split = 1.
// The TPU kernel's log-space prefixes, triangular matmuls and 128-slot
// chunk skip are MXU artefacts and are not carried over.
//
// Arithmetic: sigma, op vis, alpha, 1 - alpha and next_T round on their own
// (_rn intrinsics, never contracted), as in the forward kernel 9, so
// inclusion and cutoff agree with it rounding for rounding; so do w, r and
// the prefix of q, which the replay must reproduce exactly. The gradient
// arithmetic after a slot is live may contract to FMAs, and 1 / (1 - alpha)
// is an approximate reciprocal (1 - alpha >= 0.001, well conditioned;
// within the 1e-3 tolerance against the plain version).
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "conic_cull.cuh"
#include "row_stage.cuh"
#include "warp_reduce.cuh"

namespace {

using tdgswarp::kFullMask;

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
using tdgsstage::kBatch;

// Zeros the floats [begin, end): 16-byte stores between the first and last
// 16-byte boundaries, single floats around them; thread i of `stride`.
__device__ __forceinline__ void zero_floats(float* begin, float* end, int i, int stride) {
  if (begin >= end) return;
  const uintptr_t ub = reinterpret_cast<uintptr_t>(begin);
  const uintptr_t ue = reinterpret_cast<uintptr_t>(end);
  uintptr_t ua = (ub + 15) & ~static_cast<uintptr_t>(15);
  uintptr_t uz = ue & ~static_cast<uintptr_t>(15);
  if (ua > ue) ua = ue;
  if (uz < ua) uz = ua;
  float* a = reinterpret_cast<float*>(ua);
  float* z = reinterpret_cast<float*>(uz);
  if (i < a - begin) begin[i] = 0.f;
  if (i < end - z) z[i] = 0.f;
  float4* a4 = reinterpret_cast<float4*>(a);
  const int64_t n4 = (z - a) / 4;
  for (int64_t j = i; j < n4; j += stride) a4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// CMAX: the colour bound (D <= CMAX).
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
    int D, int cap, int n_split) {
  constexpr int NV = tdgswarp::reduce_width(6 + CMAX);
  constexpr int NQ = (CMAX + 3) / 4;  // float4s of colours
  extern __shared__ float4 smem4[];
  const int F = 6 + D;
  const int DP = tdgsstage::padded(D);
  const int n_warps = blockDim.x >> 5;
  // two batches, then the warps' partial rows
  const int BS = tdgsstage::batch_floats(D);
  float* s_batches = reinterpret_cast<float*>(smem4);  // [2, BS]
  float* s_part = s_batches + 2 * BS;                   // [n_warps, kBatch, F]

  const int t = blockIdx.x / n_split;
  const int part = blockIdx.x - t * n_split;
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
  float x0, x1, y0, y1;
  tdgscull::warp_box(fx, fy, x0, x1, y0, y1);

  const int count = max(0, min(counts[t], cap));
  const float* tile_rows = rows + static_cast<int64_t>(t) * cap * F;
  float* tile_out = v_rows + static_cast<int64_t>(t) * cap * F;
  // this block's range [lo, hi) of the valid slots, in whole batches; the
  // walk replays [0, lo) and reduces [lo, hi)
  const int span = ((count + n_split - 1) / n_split + kBatch - 1) / kBatch * kBatch;
  const int lo = min(count, part * span);
  const int hi = min(count, lo + span);

  // zero rows past the count, this block's share, before the walk
  zero_floats(tile_out + static_cast<int64_t>(count) * F,
              tile_out + static_cast<int64_t>(cap) * F, part * blockDim.x + tid,
              n_split * blockDim.x);
  if (lo >= hi) return;  // a range past the count: nothing to walk

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

  // The whole block stages a batch from the tile's contiguous rows.
  const auto stage = [&](int from, float* dst) {
    const float* src = tile_rows + static_cast<int64_t>(from + lane) * F;
    tdgsstage::stage(dst, from + lane < hi, lane, warp, n_warps, D,
                     [&](int f) { return src + f; });
  };
  stage(0, s_batches);
  int b0 = 0;
  for (int buf = 0; b0 < hi; b0 += kBatch, buf ^= 1) {
    // a barrier too: the previous batch's rows and partials have been read
    if (__syncthreads_count(done) == static_cast<int>(blockDim.x)) break;
    const int n = min(kBatch, hi - b0);
    const bool reduce = b0 >= lo;  // else the replay of an earlier range
    // the next batch lands in the other buffer while this one is walked
    if (b0 + kBatch < hi) {
      stage(b0 + kBatch, s_batches + (buf ^ 1) * BS);
    } else {
      tdgsasync::commit();
    }
    tdgsasync::wait<1>();
    __syncthreads();
    const float4* s_geo = tdgsstage::geometry(s_batches + buf * BS);
    const float* s_col = tdgsstage::colours(s_batches + buf * BS);
    // the batch's slots that may reach this warp's pixels, one lane each
    const unsigned reach = __ballot_sync(
        kFullMask,
        lane < n && tdgscull::may_reach(s_geo[2 * lane], s_geo[2 * lane + 1], x0, x1, y0, y1));

    for (int k = 0; k < n; ++k) {
      float* part_row = s_part + (warp * kBatch + k) * F;
      if (!((reach >> k) & 1u)) {  // no pixel of the warp includes it
        if (reduce) tdgswarp::store_zero_row(part_row, lane, F);
        continue;
      }
      float g_mx = 0.f, g_my = 0.f, g_a = 0.f, g_b = 0.f, g_c = 0.f, g_op = 0.f;
      float w = 0.f;
      bool live = false;
      if (!done) {
        const float4 q0 = s_geo[2 * k], q1 = s_geo[2 * k + 1];
        const float ca = q0.z, cb = q0.w, cc = q1.x;
        // the forward's arithmetic, rounding for rounding (see
        // rasterize_dense_fwd.cu), so inclusion and cutoff agree with it
        const float dx = __fsub_rn(q0.x, fx);
        const float dy = __fsub_rn(q0.y, fy);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                                     __fmul_rn(__fmul_rn(cc, dy), dy));
        const float sigma = __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(cb, dx), dy));
        const float vis = expf(-sigma);
        const float op_vis = __fmul_rn(q1.y, vis);
        const float alpha = fminf(kAlphaClamp, op_vis);
        if (sigma >= 0.f && alpha >= kAlphaThreshold) {
          const float one_minus = __fsub_rn(1.f, alpha);
          const float next_T = __fmul_rn(T, one_minus);
          if (next_T <= kTransmittanceEps) {
            done = true;
          } else {
            live = true;
            // w, r and the prefix of q uncontracted: the replay of an
            // earlier range must reach the same prefix bit for bit
            w = __fmul_rn(alpha, T);
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
              if (c < D) r = __fmaf_rn(vcol[c], col[c], r);
            }
            pref_q = __fmaf_rn(w, r, pref_q);
            if (reduce) {
              // the gradients: contracted, approximate reciprocal
              const float ra = __fdividef(1.f, one_minus);
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
            }
            T = next_T;
          }
        }
      }
      if (!reduce) continue;
      if (!__any_sync(kFullMask, live)) {
        tdgswarp::store_zero_row(part_row, lane, F);
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
        tdgswarp::store_scattered<NV>(part_row, v, lane, F);
      }
    }
    if (!reduce) continue;
    __syncthreads();

    // the batch's rows: the warps' partials summed in a fixed order
    float* dst = tile_out + static_cast<int64_t>(b0) * F;
    for (int i = tid; i < n * F; i += blockDim.x) {
      float s = 0.f;
      for (int wp = 0; wp < n_warps; ++wp) s += s_part[wp * kBatch * F + i];
      dst[i] = s;
    }
  }
  tdgsasync::wait<0>();  // a batch still in flight after an early exit
  // zero rows: the slots of this range that no pixel reached
  zero_floats(tile_out + static_cast<int64_t>(max(lo, min(b0, hi))) * F,
              tile_out + static_cast<int64_t>(hi) * F, tid, blockDim.x);
}

template <int CMAX>
cudaError_t launch(const float* rows, const int32_t* counts, const float* out_colors,
                   const float* out_T, const float* v_colors, const float* v_T,
                   float* v_rows, int n_tiles, int width, int height, int tile_size,
                   int tile_width, int tiles_per_image, int D, int cap, int n_split,
                   cudaStream_t stream) {
  const int block = tile_size * tile_size;
  const int F = 6 + D;
  const size_t smem =
      (static_cast<size_t>(2) * tdgsstage::batch_floats(D) + kBatch * (block / 32) * F) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterize_dense_bwd_kernel<CMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rasterize_dense_bwd_kernel<CMAX><<<n_tiles * n_split, block, smem, stream>>>(
      rows, counts, out_colors, out_T, v_colors, v_T, v_rows, width, height,
      tile_size, tile_width, tiles_per_image, D, cap, n_split);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). Tiles of a multiple of 32 pixels,
// at most 1024; D <= 32; `v_rows` has the shape of `rows`. n_split >= 1:
// the blocks, one per range of slots, that share each tile (the wrapper
// picks it from the tile count and the card's SMs; the rows do not depend
// on it).
extern "C" int tdgs_rasterize_dense_bwd(
    const float* rows, const int32_t* counts, const float* out_colors,
    const float* out_T, const float* v_colors, const float* v_T, float* v_rows,
    int n_images, int width, int height, int tile_size, int D, int cap, int n_split,
    void* stream) {
  const int block = tile_size * tile_size;
  if (tile_size <= 0 || block > 1024 || block % 32 != 0 || D <= 0 || D > 32 || cap < 0 ||
      n_split < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile_width = (width + tile_size - 1) / tile_size;
  const int tile_height = (height + tile_size - 1) / tile_size;
  const int tiles_per_image = tile_width * tile_height;
  const int n_tiles = n_images * tiles_per_image;
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TDGS_LAUNCH(CM)                                                        \
  launch<CM>(rows, counts, out_colors, out_T, v_colors, v_T, v_rows, n_tiles,  \
             width, height, tile_size, tile_width, tiles_per_image, D, cap,    \
             n_split, s)
  cudaError_t err;
  // the 6 + D values reduced per slot, padded to NV = 16 (D <= 10), 32
  // (D <= 26) or 64
  if (D <= 4) {
    err = TDGS_LAUNCH(4);
  } else if (D <= 10) {
    err = TDGS_LAUNCH(10);
  } else if (D <= 26) {
    err = TDGS_LAUNCH(26);
  } else {
    err = TDGS_LAUNCH(32);
  }
#undef TDGS_LAUNCH
  return static_cast<int>(err);
}
