// Backward of the 2DGS (surfel) compositing over the sorted packed
// intersection stream: per-entry gradient rows, in stream order.
//
// Replaces the TPU kernel tdgs/ops/rasterize_2dgs_pallas.py
// `_bwd_kernel_2dgs_unaligned` (:596), called by `_raster_2dgs_unaligned_bwd`
// (:991). Per pixel centre and per entry k of its tile's range, cut to
// `max_entries` exactly as the forward cuts it, in stream order, with sigma
// from rasterize_2dgs_common.cuh, vis = exp(-sigma), alpha and the
// inclusion rule of the forward:
//   T_prev  = prod_{j<k} (1 - alpha_j),  w = alpha T_prev
//   r       = sum_c v_ch[c] ch_k[c]
//   with the distortion (depth channel d, exclusive prefixes A, B of w and
//   w d, B_tot the depth channel's total, A_tot = 1 - T_final, v_d the
//   distortion's cotangent):
//     r += v_d (2 (d A - B) + 2 ((B_tot - B - w d) - d (A_tot - A - w)))
//     g_d = v_d 2 w (2 A + w - A_tot)   added to the depth channel's row
//   suffix  = tot_q - sum_{j<=k} w_j r_j,
//   tot_q   = sum_c v_ch[c] acc[c] (+ 2 v_d distortion)
//   v_alpha = r T_prev - suffix / (1 - alpha) + v_alpha_img T_final / (1 - alpha)
//   v_sigma = -op vis v_alpha, v_op = vis v_alpha where op vis <= 0.999
//   sigma3d branch (sigma3d <= sigma2d and tmpz not degenerate):
//     v_tmp = (v_sigma tmpx / tmpz^2, v_sigma tmpy / tmpz^2, -v_sigma sigma3d / tmpz)
//     d t0 = v_tmp, d tpx = v_tmp px, d tpy = v_tmp py
//   sigma2d branch: d mx = 2 v_sigma dx, d my = 2 v_sigma dy
// and the entry's row, summed over the tile's pixels, is
//   [d mx, d my, d t0 (3), d tpx (3), d tpy (3), d op, w v_ch (DA) (+ g_d)].
// Entries past the cut, past every pixel's end of walk, or not included,
// get zero rows; so do the stream slots past offsets[T]. T_final and v_T
// (v_alpha_img = -v_T) come from the forward's training call.
//
// What bounds it on the H100: operations. Each (pixel, entry) evaluation
// repeats the forward's 2DGS walk, then the distortion chain, the suffix
// terms and 12 + DA products, and every entry's 12 + DA sums over the
// tile's 256 pixels. The bytes -- the entries' rows, the per-pixel inputs
// and one row of 12 + DA floats written per stream slot -- are small
// beside that. Measured on the H100 by ablation at the bench shapes
// (RGB+ED, D = 4; kernel_ab.py), the earlier design of this kernel, which
// summed each entry's 12 + DA columns by a warp butterfly (95 shuffles
// per warp-entry) and stored them from one lane, spent about 62% of its
// time there, 38% in the walk, and next to nothing in the synchronous
// staging of the rows.
//
// Design: one block per 16x16 tile, one thread per pixel; entries in
// batches of 32, copied from the stream-order rows into shared memory with
// each row padded to whole float4s, so that a pixel reads an entry's
// geometry in three 16-byte broadcasts. The copies are asynchronous and
// double-buffered: the block starts the next batch's (cp.async of 4-byte
// values, async_copy.cuh, which land each row padded, where a bulk copy
// could not) before it walks the current one. Each pixel walks
// forward to the forward's cutoff keeping T_prev, the prefix of q = w r and
// the distortion's prefixes (the JAX formulation, so parity is one to one;
// the suffix is tot_q minus the prefix, in float32 throughout).
// - Cull: before a batch, each warp tests its 32 entries, one a lane,
//   against the box of its pixel centres (surfel_cull.cuh, a conservative
//   bound shared with the forward kernels 4 and 5) and walks only those
//   that may reach alpha >= 1/255 there; a skipped
//   entry would have been excluded at every pixel of the warp, so the rows
//   are bitwise those of walking it. At the bench shapes this skips 47% of
//   the warp-entries.
// - Reduction: per entry, a warp whose pixels all contribute zero skips
//   it; otherwise it sums its 32 pixels' values by the transposing
//   reduce-scatter of warp_reduce.cuh and writes its partial row to shared
//   memory in one store. With 16-pixel tile rows a warp's two half-warps
//   are two pixel rows, each at one fy, so the three d tpy = sum v_tmp fy
//   columns need no values of their own: the half-warps' sums of v_tmp,
//   weighted by their fy, give them. At D <= 4 the 9 + DA values left fit
//   16 lanes: 17 shuffles per warp-entry where a butterfly over the 12 + DA
//   columns took 95.
// After the batch the block sums the 8 warps' partials in a fixed order and
// writes the batch's rows, which are contiguous in the stream. Every stream
// position belongs to one tile, so each row is written once, with no float
// atomics: the result is deterministic. The TPU kernel's cross-tile carry
// chunk, which
// zeroes up to 127 kept entries of a truncated tile, is a Mosaic artefact
// and is not carried over: those entries get their gradients here.
//
// Arithmetic: sigma (rasterize_2dgs_common.cuh), op vis, alpha, 1 - alpha
// and next_T round on their own (_rn intrinsics, never contracted), as in
// the forward kernel 5, so inclusion and cutoff agree with it rounding for
// rounding. The gradient arithmetic after an entry is live may contract to
// FMAs, and 1 / (1 - alpha) is an approximate reciprocal (1 - alpha >=
// 0.001, well conditioned; within the 1e-3 tolerance against the plain
// version).
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "rasterize_2dgs_common.cuh"
#include "surfel_cull.cuh"
#include "warp_reduce.cuh"

namespace {

using namespace tdgs2dgs;
using tdgssurfel::load_geometry;
using tdgssurfel::may_reach;
using tdgswarp::kFullMask;

constexpr int kBatch = 32;

// a row's stride in shared memory: F floats padded to whole float4s
__host__ __device__ constexpr int padded(int F) { return (F + 3) & ~3; }

// CMAX: the channel bound (DA <= CMAX). HALF_ROWS: each half-warp is one
// pixel row (tile rows of 16 or 32 pixels), so the d tpy columns come from
// the half-warps' sums of v_tmp; only with NV = 16.
template <int CMAX, bool HALF_ROWS>
__global__ void rasterize_2dgs_bwd_kernel(
    const float* __restrict__ rows,         // [L, 12 + DA] stream order
    const int32_t* __restrict__ offsets,    // [T + 1]
    const float* __restrict__ out_colors,   // [I, H, W, D] forward
    const float* __restrict__ out_normals,  // [I, H, W, 3]
    const float* __restrict__ out_T,        // [I, H, W] final transmittance
    const float* __restrict__ out_dist,     // [I, H, W]
    const float* __restrict__ v_colors,     // [I, H, W, D]
    const float* __restrict__ v_normals,    // [I, H, W, 3]
    const float* __restrict__ v_T,          // [I, H, W]
    const float* __restrict__ v_dist,       // [I, H, W]
    float* __restrict__ v_rows,             // [L, 12 + DA]
    int width, int height, int tile_size, int tile_width,
    int tiles_per_image, int n_tiles, int D, int max_entries, int depth_row,
    int compute_distort, int64_t n_slots) {
  // the values a lane contributes per entry: d mx, d my, d t0 (3), d tpx
  // (3), d tpy (3, not with HALF_ROWS), d op, the channels; padded to NV
  constexpr int NR = kGeomCols + CMAX - (HALF_ROWS ? 3 : 0);
  constexpr int NV = tdgswarp::reduce_width(NR);
  static_assert(!HALF_ROWS || NV == 16, "HALF_ROWS reduces 16 values");
  constexpr int NQ = (CMAX + 3) / 4;  // float4s of channels
  extern __shared__ float4 smem4[];
  const int DA = D + 3;
  const int F = kGeomCols + DA;
  const int FP = padded(F);
  const int n_warps = blockDim.x >> 5;
  float* s_batches = reinterpret_cast<float*>(smem4);  // [2, kBatch, FP]
  float* s_part = s_batches + 2 * kBatch * FP;          // [n_warps, kBatch, F]

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
  // the box of the warp's pixel centres
  float x0 = fx, x1 = fx, y0 = fy, y1 = fy;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(kFullMask, x0, o));
    x1 = fmaxf(x1, __shfl_xor_sync(kFullMask, x1, o));
    y0 = fminf(y0, __shfl_xor_sync(kFullMask, y0, o));
    y1 = fmaxf(y1, __shfl_xor_sync(kFullMask, y1, o));
  }

  const int start = offsets[t];
  const int end = offsets[t + 1];
  const int count = min(end - start, max_entries);
  const bool with_dist = compute_distort && depth_row >= 0;

  // per-pixel inputs; pixels outside the image contribute nothing
  float vch[CMAX];
  float tot_q = 0.f, va_tfin = 0.f, vd = 0.f, b_tot = 0.f, a_tot = 0.f;
#pragma unroll
  for (int c = 0; c < CMAX; ++c) vch[c] = 0.f;
  if (inside) {
    const int64_t pix = (static_cast<int64_t>(image) * height + py) * width + px;
#pragma unroll
    for (int c = 0; c < CMAX; ++c) {
      if (c < D) {
        vch[c] = v_colors[pix * D + c];
        tot_q += vch[c] * out_colors[pix * D + c];
      } else if (c < DA) {
        vch[c] = v_normals[pix * 3 + (c - D)];
        tot_q += vch[c] * out_normals[pix * 3 + (c - D)];
      }
    }
    const float t_final = out_T[pix];
    va_tfin = -v_T[pix] * t_final;
    if (with_dist) {
      vd = v_dist[pix];
      tot_q += 2.f * vd * out_dist[pix];
      b_tot = out_colors[pix * D + depth_row];
      a_tot = 1.f - t_final;
    }
  }
  float T = 1.f;
  float pref_q = 0.f, A = 0.f, B = 0.f;
  bool done = !inside;

  // starts copying the batch at `from` into `dst`, each row padded to FP
  const auto stage = [&](int from, float* dst) {
    const float* src = rows + static_cast<int64_t>(start + from) * F;
    for (int i = tid; i < min(kBatch, count - from) * F; i += blockDim.x) {
      tdgsasync::copy_4(dst + i + (i / F) * (FP - F), src + i);
    }
    tdgsasync::commit();
  };
  if (count > 0) stage(0, s_batches);
  int b0 = 0;
  for (int buf = 0; b0 < count; b0 += kBatch, buf ^= 1) {
    // a barrier too: the previous batch's rows and partials have been read
    if (__syncthreads_count(done) == static_cast<int>(blockDim.x)) break;
    const int n = min(kBatch, count - b0);
    // the next batch lands in the other buffer while this one is walked
    if (b0 + kBatch < count) {
      stage(b0 + kBatch, s_batches + (buf ^ 1) * kBatch * FP);
    } else {
      tdgsasync::commit();
    }
    tdgsasync::wait<1>();
    __syncthreads();
    const float* s_rows = s_batches + buf * kBatch * FP;
    // the batch's entries that may reach this warp's pixels, one lane each
    bool may = false;
    if (lane < n) {
      float gl[kGeomCols];
      load_geometry(s_rows + lane * FP, gl);
      may = may_reach(gl, x0, x1, y0, y1);
    }
    const unsigned reach = __ballot_sync(kFullMask, may);

    for (int k = 0; k < n; ++k) {
      float* part = s_part + (warp * kBatch + k) * F;
      if (!((reach >> k) & 1u)) {  // no pixel of the warp includes it
        tdgswarp::store_zero_row(part, lane, F);
        continue;
      }
      const float* row = s_rows + k * FP;
      const float4* row4 = reinterpret_cast<const float4*>(row);
      float g[kGeomCols];  // d mx, d my, d t0 (3), d tpx (3), d tpy (3), d op
#pragma unroll
      for (int j = 0; j < kGeomCols; ++j) g[j] = 0.f;
      float w = 0.f, g_depth = 0.f;
      bool live = false;
      if (!done) {
        float geo[kGeomCols];  // mx, my, t0 (3), tpx (3), tpy (3), op
        load_geometry(row, geo);
        // the forward's arithmetic, rounding for rounding, so inclusion and
        // cutoff agree with it
        Response r;
        const float sigma = ray_splat_sigma(geo, fx, fy, r);
        const float vis = expf(-sigma);
        const float op_vis = __fmul_rn(geo[11], vis);
        const float alpha = fminf(kAlphaClamp, op_vis);
        if (alpha >= kAlphaThreshold) {
          const float one_minus = __fsub_rn(1.f, alpha);
          const float next_T = __fmul_rn(T, one_minus);
          if (next_T <= kTransmittanceEps) {
            done = true;
          } else {
            // the gradients: contracted, approximate reciprocal
            live = true;
            w = alpha * T;
            float ch[4 * NQ];
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
              if (4 * q < DA) {
                const float4 c4 = row4[kGeomCols / 4 + q];
                ch[4 * q] = c4.x;
                ch[4 * q + 1] = c4.y;
                ch[4 * q + 2] = c4.z;
                ch[4 * q + 3] = c4.w;
              }
            }
            float rr = 0.f;
#pragma unroll
            for (int c = 0; c < CMAX; ++c) {
              if (c < DA) rr += vch[c] * ch[c];
            }
            if (with_dist) {
              const float d = row[kGeomCols + depth_row];
              const float wd = w * d;
              const float r_dist = 2.f * (d * A - B) +
                                   2.f * ((b_tot - B - wd) - d * (a_tot - A - w));
              rr += vd * r_dist;
              g_depth = vd * (2.f * w * (2.f * A + w - a_tot));
              A += w;
              B += wd;
            }
            pref_q += w * rr;
            const float ra = __fdividef(1.f, one_minus);
            const float v_alpha = rr * T - (tot_q - pref_q) * ra + va_tfin * ra;
            if (op_vis <= kAlphaClamp) {
              const float v_sigma = -op_vis * v_alpha;
              g[11] = vis * v_alpha;
              if (r.sigma3d <= r.sigma2d && !r.bad) {
                const float rtz2 = r.rtz * r.rtz;
                const float vx = v_sigma * r.tmpx * rtz2;
                const float vy = v_sigma * r.tmpy * rtz2;
                const float vz = -v_sigma * r.sigma3d * r.rtz;
                g[2] = vx;
                g[3] = vy;
                g[4] = vz;
                g[5] = vx * fx;
                g[6] = vy * fx;
                g[7] = vz * fx;
                if (!HALF_ROWS) {
                  g[8] = vx * fy;
                  g[9] = vy * fy;
                  g[10] = vz * fy;
                }
              } else {
                g[0] = 2.f * v_sigma * r.dx;
                g[1] = 2.f * v_sigma * r.dy;
              }
            }
            T = next_T;
          }
        }
      }
      if (__any_sync(kFullMask, live)) {
        // the lane's values in reduction order: the geometry columns (d tpy
        // left out with HALF_ROWS), then the channels, zero padding
        constexpr int NG = HALF_ROWS ? kGeomCols - 3 : kGeomCols;
        float v[NV];
#pragma unroll
        for (int j = 0; j < NV; ++j) v[j] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = g[j];
        if (HALF_ROWS) {
          v[8] = g[11];
        } else {
#pragma unroll
          for (int j = 8; j < kGeomCols; ++j) v[j] = g[j];
        }
#pragma unroll
        for (int c = 0; c < CMAX; ++c) {
          if (c < DA) v[NG + c] = w * vch[c] + (c == depth_row ? g_depth : 0.f);
        }
        if constexpr (HALF_ROWS) {
          // sums over each half-warp (one pixel row): lane l holds column
          // l & 15 of its own row; d tpy = fy_0 S_0 + fy_1 S_1 of the d t0
          // sums, then the two rows' sums added
          tdgswarp::halve<8, 8>(v, lane);
          const float m = fy * v[0];
          const float tpy = m + __shfl_xor_sync(kFullMask, m, 16);
          v[0] += __shfl_xor_sync(kFullMask, v[0], 16);
          // one store: lanes 0..15 their column, lanes 18..20 d tpy
          const int j = lane & 15;
          const bool low = lane < 16;
          const int col = low ? (j < 8 ? j : (j == 8 ? 11 : j + 3)) : j + 6;
          if (low ? j < NG + DA : (j >= 2 && j <= 4)) part[col] = low ? v[0] : tpy;
        } else {
          tdgswarp::reduce_scatter<NV>(v, lane);
          tdgswarp::store_scattered<NV>(part, v, lane, F);
        }
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
  tdgsasync::wait<0>();  // a batch still in flight after an early exit
  // zero rows: entries no pixel reached, and those past the tile's cut
  const int64_t zero_from = static_cast<int64_t>(start + min(b0, count)) * F;
  for (int64_t i = zero_from + tid; i < static_cast<int64_t>(end) * F; i += blockDim.x) {
    v_rows[i] = 0.f;
  }
}

template <int CMAX, bool HALF_ROWS>
cudaError_t launch(const float* rows, const int32_t* offsets,
                   const float* out_colors, const float* out_normals,
                   const float* out_T, const float* out_dist,
                   const float* v_colors, const float* v_normals,
                   const float* v_T, const float* v_dist, float* v_rows,
                   int n_tiles, int width, int height, int tile_size,
                   int tile_width, int tiles_per_image, int D, int max_entries,
                   int depth_row, int compute_distort, int64_t n_slots,
                   cudaStream_t stream) {
  const int block = tile_size * tile_size;
  const int F = kGeomCols + D + 3;
  const size_t smem =
      static_cast<size_t>(kBatch) * (2 * padded(F) + (block / 32) * F) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterize_2dgs_bwd_kernel<CMAX, HALF_ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // blocks past the tiles zero the stream's padding rows
  const int64_t tail_blocks = (n_slots * F + 8 * block - 1) / (8 * block);
  const int n_tail = static_cast<int>(tail_blocks < 264 ? tail_blocks : 264);
  rasterize_2dgs_bwd_kernel<CMAX, HALF_ROWS><<<n_tiles + n_tail, block, smem, stream>>>(
      rows, offsets, out_colors, out_normals, out_T, out_dist, v_colors,
      v_normals, v_T, v_dist, v_rows, width, height, tile_size, tile_width,
      tiles_per_image, n_tiles, D, max_entries, depth_row, compute_distort,
      n_slots);
  return cudaGetLastError();
}

}  // namespace

// Kernel 6. Returns a cudaError_t (0 on success). tile_size must be a
// multiple of 32 pixels per tile (16x16 in practice), D <= 32, `v_rows`
// holds n_slots rows of 12 + D + 3 floats; `depth_row` < 0 means no depth
// channel (the distortion terms are off).
extern "C" int tdgs_rasterize_2dgs_bwd(
    const float* rows, const int32_t* offsets, const float* out_colors,
    const float* out_normals, const float* out_T, const float* out_dist,
    const float* v_colors, const float* v_normals, const float* v_T,
    const float* v_dist, float* v_rows, int n_images, int width, int height,
    int tile_size, int tile_width, int tile_height, int D, int max_entries,
    int depth_row, int compute_distort, int64_t n_slots, void* stream) {
  const int tiles_per_image = tile_width * tile_height;
  const int n_tiles = n_images * tiles_per_image;
  const int block = tile_size * tile_size;
  if (tile_size <= 0 || block > 1024 || block % 32 != 0 || D <= 0 || D > 32 ||
      depth_row >= D) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TDGS_LAUNCH(CM, HALF)                                                     \
  launch<CM, HALF>(rows, offsets, out_colors, out_normals, out_T, out_dist,       \
                   v_colors, v_normals, v_T, v_dist, v_rows, n_tiles, width,      \
                   height, tile_size, tile_width, tiles_per_image, D, max_entries, \
                   depth_row, compute_distort, n_slots, s)
  // the values reduced per entry, padded to NV: 12 + DA <= 16 (D = 1);
  // 9 + DA <= 16 when half-warps are pixel rows (D <= 4); 12 + DA <= 32
  // (D <= 17); 12 + DA <= 64
  const bool half_rows = tile_size % 16 == 0;
  cudaError_t err;
  if (D + 3 <= 4) {
    err = TDGS_LAUNCH(4, false);
  } else if (D + 3 <= 7 && half_rows) {
    err = TDGS_LAUNCH(7, true);
  } else if (D + 3 <= 20) {
    err = TDGS_LAUNCH(20, false);
  } else {
    err = TDGS_LAUNCH(35, false);
  }
#undef TDGS_LAUNCH
  return static_cast<int>(err);
}
