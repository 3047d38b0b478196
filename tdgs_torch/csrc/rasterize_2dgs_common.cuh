// The 2DGS ray-splat response shared by the forward kernels
// (rasterize_2dgs_fwd.cu) and the backward kernel (rasterize_2dgs_bwd.cu),
// from tdgs/ops/rasterize_2dgs_pallas.py `_chunk_values_2dgs` (:48).
//
// A per-entry feature row holds, in this order,
//   [mx, my, t0 (3), tpx (3), tpy (3), op, channels (DA)]
// with t0 = T0 x T1, tpx = T1 x T2 and tpy = T2 x T0, where T0, T1, T2 are
// the rows of K [RS_u, RS_v, mean_c], i.e. the columns of the projection's
// ray transform M (the wrapper forms them, rasterize_2dgs_packed.py
// feature_rows; the JAX package takes M's rows instead, see ROADMAP, faults
// on the reference side), so that for a pixel centre (px, py) the ray-splat
// intersection is tmp = t0 + tpx px + tpy py.
// Then, with tmpz guarded at 1e-9,
//   sigma3d = (tmpx^2 + tmpy^2) / tmpz^2,  sigma2d = 2 ((mx-px)^2 + (my-py)^2)
//   sigma   = min(sigma3d, sigma2d) / 2
// Every operation rounds on its own (the _rn intrinsics are never
// contracted into FMAs) and the reciprocal of tmpz is one correctly rounded
// __frcp_rn, so the forward and the backward, and the plain PyTorch
// version, agree bit for bit on sigma, on the min(sigma3d, sigma2d) branch
// and so on which entries pass the 1/255 and 1e-4 tests.
#pragma once

#include <cuda_runtime.h>

namespace tdgs2dgs {

constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaThreshold = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr float kTmpzEps = 1e-9f;
constexpr float kSigmaBad = 1e6f;
constexpr int kGeomCols = 12;  // mx, my, t0, tpx, tpy, op

struct Response {
  float tmpx, tmpy, rtz, sigma3d, sigma2d, dx, dy;
  bool bad;  // |tmpz| < 1e-9: sigma3d is 1e6
};

// sigma of the row's entry at pixel centre (fx, fy); fills `r` with the
// intermediates the backward needs.
__device__ __forceinline__ float ray_splat_sigma(const float* row, float fx,
                                                 float fy, Response& r) {
  r.tmpx = __fadd_rn(__fadd_rn(row[2], __fmul_rn(row[5], fx)), __fmul_rn(row[8], fy));
  r.tmpy = __fadd_rn(__fadd_rn(row[3], __fmul_rn(row[6], fx)), __fmul_rn(row[9], fy));
  const float tmpz =
      __fadd_rn(__fadd_rn(row[4], __fmul_rn(row[7], fx)), __fmul_rn(row[10], fy));
  r.bad = fabsf(tmpz) < kTmpzEps;
  r.rtz = __frcp_rn(r.bad ? 1.f : tmpz);
  r.sigma3d = r.bad ? kSigmaBad
                    : __fmul_rn(__fadd_rn(__fmul_rn(r.tmpx, r.tmpx), __fmul_rn(r.tmpy, r.tmpy)),
                                __fmul_rn(r.rtz, r.rtz));
  r.dx = __fsub_rn(row[0], fx);
  r.dy = __fsub_rn(row[1], fy);
  r.sigma2d = __fmul_rn(2.f, __fadd_rn(__fmul_rn(r.dx, r.dx), __fmul_rn(r.dy, r.dy)));
  return __fmul_rn(0.5f, fminf(r.sigma3d, r.sigma2d));
}

}  // namespace tdgs2dgs
