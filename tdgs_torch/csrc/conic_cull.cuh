// A conservative cull of 3DGS entries (slots) against a warp's pixels, for
// the compositing kernels 1, 9 and 10: a warp skips a slot that no pixel of
// its box can include, so its output is bitwise that of walking the slot.
#pragma once

#include <cuda_runtime.h>

namespace tdgscull {

// The box of the warp's pixel centres [x0, x1] x [y0, y1].
__device__ __forceinline__ void warp_box(float fx, float fy, float& x0, float& x1, float& y0,
                                         float& y1) {
  x0 = x1 = fx;
  y0 = y1 = fy;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(0xffffffffu, x0, o));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, o));
    y0 = fminf(y0, __shfl_xor_sync(0xffffffffu, y0, o));
    y1 = fmaxf(y1, __shfl_xor_sync(0xffffffffu, y1, o));
  }
}

// Whether a slot (q0 = mx, my, a, b; q1 = c, op) may reach alpha >= 1/255
// at a pixel centre of the box. The walk's offsets (dx, dy) = (mx, my) -
// pixel centre, rounded as the walk rounds them, lie in [u0, u1] x
// [v0, v1], and its sigma is within 2e-7 S of q(dx, dy) / 2, q(u, v) =
// a u^2 + 2 b u v + c v^2 and S <= (a + 2|b| + c) r^2 its terms' size over
// the box. q's least value over the box lies on one of its four edges (on
// each, q is convex and has its least value at a clamped point), or is 0
// where the mean lies inside the box. Where S <= 1e5, sigma is then at
// least that least value / 2 - 0.05 at every pixel, and alpha = op
// exp(-sigma) < 1/255 wherever sigma > log(255 op): the slot is dropped
// only if the least value / 2 exceeds log(255 op) + 1.25. A conic with
// a <= 0 or c <= 0, a box too far or a conic too large for that bound, and
// NaN keep the slot.
__device__ __forceinline__ bool may_reach(float4 q0, float4 q1, float x0, float x1, float y0,
                                          float y1) {
  const float a = q0.z, b = q0.w, c = q1.x;
  const float u0 = __fsub_rn(q0.x, x1), u1 = __fsub_rn(q0.x, x0);
  const float v0 = __fsub_rn(q0.y, y1), v1 = __fsub_rn(q0.y, y0);
  const float r2 = fmaxf(u0 * u0, u1 * u1) + fmaxf(v0 * v0, v1 * v1);
  if (!(a > 0.f && c > 0.f && (a + 2.f * fabsf(b) + c) * r2 <= 1e5f)) return true;
  const float ia = __fdividef(1.f, a), ic = __fdividef(1.f, c);
  // q's least value on the edges u = u0, u1 (v free) and v = v0, v1 (u free)
  const auto on_u = [&](float u) {
    const float v = fminf(fmaxf(-b * u * ic, v0), v1);
    return (a * u + 2.f * b * v) * u + c * v * v;
  };
  const auto on_v = [&](float v) {
    const float u = fminf(fmaxf(-b * v * ia, u0), u1);
    return (c * v + 2.f * b * u) * v + a * u * u;
  };
  float q = fminf(fminf(on_u(u0), on_u(u1)), fminf(on_v(v0), on_v(v1)));
  if (u0 <= 0.f && 0.f <= u1 && v0 <= 0.f && 0.f <= v1) q = 0.f;
  return !(0.5f * q > __logf(255.f * q1.y) + 1.25f);
}

}  // namespace tdgscull
