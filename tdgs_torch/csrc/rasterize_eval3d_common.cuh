// The world-space (eval3d, 3DGUT) gaussian response along a pixel's ray,
// shared by the forward kernel (rasterize_eval3d_fwd.cu) and the backward
// kernel (rasterize_eval3d_bwd.cu), from tdgs/ops/rasterize_eval3d.py
// (:11-16, the canonical-frame formulation).
//
// A per-entry feature row holds, in this order,
//   [M (9, row-major), g0 (3), op, channels (D)]
// with M = diag(1/s) R^T the world-to-canonical transform of the gaussian
// (mean mu, rotation R, scales s) and g0 = M (o_ref - mu), o_ref the
// camera centre at the frame's start pose (the wrapper forms them,
// rasterize_eval3d_packed.py feature_rows). A pixel's ray is o_ref + o' + t d
// (o' = 0 for a central camera with a global shutter), so in the canonical
// frame
//   r = M d,  g = g0 + M o',
//   sigma* = min_t |g + t r|^2 / 2 = |g x r|^2 / (2 |r|^2),
// kept only where g.r < 0 (the best response lies in front of the camera).
// The cross product takes sigma* without the cancellation of the expanded
// quadratic form (|g|^2 - (g.r)^2/|r|^2)/2 that the JAX kernels evaluate:
// both of its terms are of size (distance / scale)^2, about 1e5-1e6 at real
// scene scales (ROADMAP, faults on the reference side).
// Every operation rounds on its own (the _rn intrinsics are never
// contracted into FMAs), in the order of the plain PyTorch version
// (_response_eval3d), so the forward, the backward and the plain version
// agree bit for bit on sigma and on the g.r gate.
#pragma once

#include <cuda_runtime.h>

namespace tdgseval3d {

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kRrMin = 1e-12f;
constexpr int kGeomCols = 13;  // M (9), g0 (3), op

struct Response {
  float r[3], g[3], c[3];
  float gr, rr;
};

__device__ __forceinline__ float dot3_rn(const float* a, const float* b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])),
                   __fmul_rn(a[2], b[2]));
}

// sigma* of the row's entry along the ray (d, o'); fills `s` with the
// intermediates the backward needs. `o` is read only when !CENTRAL.
template <bool CENTRAL>
__device__ __forceinline__ float ray_sigma(const float* row, const float* d,
                                           const float* o, Response& s) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.r[i] = dot3_rn(row + 3 * i, d);
    s.g[i] = CENTRAL ? row[9 + i] : __fadd_rn(row[9 + i], dot3_rn(row + 3 * i, o));
  }
  s.gr = dot3_rn(s.g, s.r);
  s.c[0] = __fsub_rn(__fmul_rn(s.g[1], s.r[2]), __fmul_rn(s.g[2], s.r[1]));
  s.c[1] = __fsub_rn(__fmul_rn(s.g[2], s.r[0]), __fmul_rn(s.g[0], s.r[2]));
  s.c[2] = __fsub_rn(__fmul_rn(s.g[0], s.r[1]), __fmul_rn(s.g[1], s.r[0]));
  const float cc = dot3_rn(s.c, s.c);
  s.rr = fmaxf(dot3_rn(s.r, s.r), kRrMin);
  return __fmul_rn(0.5f, __fdiv_rn(cc, s.rr));
}

}  // namespace tdgseval3d
