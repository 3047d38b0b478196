// A conservative cull of 2DGS (surfel) entries against a warp's pixels, for
// the forward kernels 4 and 5 (surfel_walk.cuh) and the backward kernel 6
// (rasterize_2dgs_bwd.cu): a warp skips an entry that no pixel centre of its
// box can include, so its output is bitwise that of walking the entry.
#pragma once

#include <cuda_runtime.h>

#include "rasterize_2dgs_common.cuh"

namespace tdgssurfel {

using tdgs2dgs::kGeomCols;

// An entry's geometry (mx, my, t0, tpx, tpy, op) from the three float4s at
// `row`, 16-byte aligned.
__device__ __forceinline__ void load_geometry(const float* row, float (&g)[kGeomCols]) {
  const float4* row4 = reinterpret_cast<const float4*>(row);
  const float4 q0 = row4[0], q1 = row4[1], q2 = row4[2];
  g[0] = q0.x; g[1] = q0.y; g[2] = q0.z; g[3] = q0.w;
  g[4] = q1.x; g[5] = q1.y; g[6] = q1.z; g[7] = q1.w;
  g[8] = q2.x; g[9] = q2.y; g[10] = q2.z; g[11] = q2.w;
}

// Whether the entry (geometry g) may reach alpha >= 1/255 at a pixel centre
// in the box [x0, x1] x [y0, y1]. Over the box, sigma2d >= 2 d^2 (d: the
// distance from (mx, my) to the box) and, tmp being affine in the pixel
// centre, sigma3d >= (lx^2 + ly^2) / hz^2 with lx, ly the least |tmpx|,
// |tmpy| and hz the largest |tmpz| over the box's corners (0 where a
// component changes sign). alpha = op exp(-sigma) < 1/255 wherever sigma >
// log(255 op). Each bound is widened by far more than the kernels' rounding
// of tmp and sigma (1e-5 of the terms' sizes) and the threshold raised by 1,
// so an entry that may be included anywhere in the box is never dropped;
// NaN keeps the entry.
__device__ __forceinline__ bool may_reach(const float (&g)[kGeomCols], float x0, float x1,
                                          float y0, float y1) {
  const float dx = fmaxf(0.f, fmaxf(x0 - g[0], g[0] - x1));
  const float dy = fmaxf(0.f, fmaxf(y0 - g[1], g[1] - y1));
  const float s2d = 2.f * (dx * dx + dy * dy);
  const float ax = fmaxf(fabsf(x0), fabsf(x1)), ay = fmaxf(fabsf(y0), fabsf(y1));
  float lo[2], hz = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float t = g[2 + i], u = g[5 + i], v = g[8 + i];
    const float c00 = t + u * x0 + v * y0, c10 = t + u * x1 + v * y0;
    const float c01 = t + u * x0 + v * y1, c11 = t + u * x1 + v * y1;
    const float lo_c = fminf(fminf(c00, c10), fminf(c01, c11));
    const float hi_c = fmaxf(fmaxf(c00, c10), fmaxf(c01, c11));
    const float slack = 1e-5f * (fabsf(t) + fabsf(u) * ax + fabsf(v) * ay);
    if (i < 2) {
      lo[i] = fmaxf(0.f, fmaxf(lo_c, -hi_c) - slack);
    } else {
      hz = fmaxf(fabsf(lo_c), fabsf(hi_c)) + slack;
    }
  }
  // |tmpz| < 1e-9 gives sigma3d = 1e6 in the walk
  const float s3d = fminf((lo[0] * lo[0] + lo[1] * lo[1]) / (hz * hz), tdgs2dgs::kSigmaBad);
  return !(0.5f * fminf(s3d, s2d) * (1.f - 1e-5f) > logf(255.f * g[11]) + 1.f);
}

}  // namespace tdgssurfel
