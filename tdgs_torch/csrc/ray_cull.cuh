// A conservative cull of eval3d entries against a warp's rays, for the
// world-space compositing kernel 7: a warp skips an entry that reaches
// alpha < 1/255 along every one of its rays, so its output is bitwise that
// of walking the entry. The kernel is given no 2D footprint; the bound
// works on the rays and the entry's row [M (9), g0 (3), op] alone.
//
// Along a ray o_ref + o' + t d the entry's response is alpha = op
// exp(-sigma*) with, in the entry's canonical frame (g = g0 + M o',
// r = M d), sigma* = |g x r|^2 / (2 |r|^2) (the g.r gate only excludes
// more), so the entry is excluded wherever sigma* > tau_0 = log(255 op),
// i.e. wherever the canonical distance |g x r| / |r| of the ray from the
// gaussian's centre exceeds rho_0 = sqrt(2 tau_0).
//
// The warp's rays: in the frame (a, b, n) of the warp -- a the mean
// direction, b across a pixel row, n across the rows -- each d_i is a
// multiple of a + s b + t n with (s, t) in the slope box [-S, S] x
// [-G, G]; and each o'_i lies within o_dev of their mean o_c (0 for a
// central camera; a pixel row's shutter times make o_dev small). With g =
// g0 + M o_c, g x r = x_a + s x_b + t x_n (x_e = g x M e) is affine in
// (s, t), so over the box |g x r| is at least the least norm of that map:
// 0 where its zero lies inside the box, else the least value on one of the
// four edges, on each of which the squared norm is a 1D quadratic. |r| is
// at most |M a| + S |M b| + G |M n|. The bound is the silhouette of the
// ellipsoid seen across the warp's box of rays: written with cross
// products, it does not cancel as the expanded quadratic form
// |g|^2 - (g.r)^2 / |r|^2 would (ROADMAP, faults on the reference side).
// Measured on the H100 at the bench shape (kernel_ab.py's counting build)
// it keeps 48.5% of the warp-entries, against 46.0% that have a lane
// reaching alpha >= 1/255; a sphere about the mean of radius rho_0 max(s)
// against the same box kept 74%, the same sphere or quadric against a cone
// about a, as a warp's 16 x 2 pixels would give it, 84% and 92%.
//
// Conservative by construction: the entry is dropped only where that
// distance, less |M| o_dev, exceeds sqrt(2 (tau_0 + 0.25)) with margins for
// everything the walk rounds -- sigma* by the cross product and g = g0 +
// M o' (16 eps |g|), each ray's r = M d and the frame's own rounding
// (4e-6 |M|), each edge's least value taken at a rounded point (1e-5 of
// the terms), alpha past the threshold (the 0.25 in sigma). NaN anywhere,
// op NaN, rows of M past 1e12, |g| past 1e25 (where the walk's products
// could overflow into a NaN sigma*), a zero inside the box, a warp whose
// slopes exceed 1 or whose rays point away from a, and a camera inside the
// ellipsoid keep the entry; an entry with op < 1/255 never reaches alpha
// >= 1/255 and is dropped.
#pragma once

#include <cuda_runtime.h>

namespace tdgsraycull {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kEps = 5.9604645e-8f;  // 2^-24, float32's unit round-off

// The warp's rays as the bound needs them.
struct WarpRays {
  float a[3], b[3], n[3];  // an orthonormal frame, a along the rays
  float S, G;              // slope bounds along b and n
  float oc[3];             // the mean apex offset o_c (0 when central)
  float odev;              // max |o'_i - o_c|
  bool ok;                 // false: every entry is kept
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// NaN-preserving: a NaN in any lane makes the result NaN
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(kFullMask, v, o);
    v = (v != v) ? v : ((w != w || w > v) ? w : v);
  }
  return v;
}

__device__ __forceinline__ float dot3(const float* x, const float* y) {
  return x[0] * y[0] + x[1] * y[1] + x[2] * y[2];
}

// The frame and slope box of the warp's rays (d, and o' when !CENTRAL) over
// its lanes inside the image; `row` lanes make a pixel row (the tile size,
// at most 32). Every lane of the warp calls it.
template <bool CENTRAL>
__device__ __forceinline__ WarpRays warp_rays(const float* d, const float* o, bool inside,
                                              int row) {
  WarpRays w;
  float s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) s[k] = warp_sum(inside ? d[k] : 0.f);
  const float sn = rsqrtf(dot3(s, s));
  // b: a pixel row's spread, made normal to a
  float e[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    w.a[k] = s[k] * sn;
    e[k] = __shfl_sync(kFullMask, d[k], row - 1) - __shfl_sync(kFullMask, d[k], 0);
  }
  const float ea = dot3(e, w.a);
#pragma unroll
  for (int k = 0; k < 3; ++k) e[k] -= ea * w.a[k];
  const float en = rsqrtf(dot3(e, e));
#pragma unroll
  for (int k = 0; k < 3; ++k) w.b[k] = e[k] * en;
  w.n[0] = w.a[1] * w.b[2] - w.a[2] * w.b[1];
  w.n[1] = w.a[2] * w.b[0] - w.a[0] * w.b[2];
  w.n[2] = w.a[0] * w.b[1] - w.a[1] * w.b[0];
  const float al = dot3(d, w.a);
  const bool ahead = al > 0.f;
  const float sb = ahead ? fabsf(dot3(d, w.b)) / al : 1e30f;
  const float sg = ahead ? fabsf(dot3(d, w.n)) / al : 1e30f;
  // the cull's own rounding: a relative 1e-5 and an absolute 1e-6
  w.S = warp_max(inside ? sb : 0.f) * (1.f + 1e-5f) + 1e-6f;
  w.G = warp_max(inside ? sg : 0.f) * (1.f + 1e-5f) + 1e-6f;
  float odev = 0.f;
  if (CENTRAL) {
    w.oc[0] = w.oc[1] = w.oc[2] = 0.f;
  } else {
    const float n_in = warp_sum(inside ? 1.f : 0.f);
#pragma unroll
    for (int k = 0; k < 3; ++k) w.oc[k] = warp_sum(inside ? o[k] : 0.f) / n_in;
    float dv[3] = {o[0] - w.oc[0], o[1] - w.oc[1], o[2] - w.oc[2]};
    odev = warp_max(inside ? sqrtf(dot3(dv, dv)) : 0.f);
    odev = odev * (1.f + 1e-5f) + 1e-6f * sqrtf(dot3(w.oc, w.oc));
  }
  w.odev = odev;
  // NaN fails every test here
  w.ok = w.S <= 1.f && w.G <= 1.f && odev < 1e30f;
  return w;
}

__device__ __forceinline__ void cross3(const float* x, const float* y, float* z) {
  z[0] = x[1] * y[2] - x[2] * y[1];
  z[1] = x[2] * y[0] - x[0] * y[2];
  z[2] = x[0] * y[1] - x[1] * y[0];
}

// Whether the entry whose geometry q holds (q[0..2] = [M00 M01 M02 M10],
// [M11 M12 M20 M21], [M22 g0x g0y g0z], [op, -, -, -]) may reach
// alpha >= 1/255 along a ray of the warp.
__device__ __forceinline__ bool may_reach(const float4* q, const WarpRays& w) {
  const float4 q0 = q[0], q1 = q[1], q2 = q[2];
  const float op = q[3].x;
  if (op < (1.0f / 255.0f)) return false;
  if (!w.ok) return true;
  const float m[3][3] = {{q0.x, q0.y, q0.z}, {q0.w, q1.x, q1.y}, {q1.z, q1.w, q2.x}};
  const float mx = fmaxf(fmaxf(dot3(m[0], m[0]), dot3(m[1], m[1])), dot3(m[2], m[2]));
  float g[3], ra[3], rb[3], rn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g[i] = (i == 0 ? q2.y : i == 1 ? q2.z : q2.w) + dot3(m[i], w.oc);
    ra[i] = dot3(m[i], w.a);
    rb[i] = dot3(m[i], w.b);
    rn[i] = dot3(m[i], w.n);
  }
  const float mnorm = sqrtf(3.f * mx);  // >= |M|
  const float gmag = sqrtf(dot3(g, g)) + mnorm * w.odev;
  // past these sizes the walk's products g r could overflow into a NaN
  if (!(mx < 1e24f && gmag < 1e25f)) return true;
  float xa[3], xb[3], xn[3], xbn[3];
  cross3(g, ra, xa);
  cross3(g, rb, xb);
  cross3(g, rn, xn);
  cross3(xb, xn, xbn);
  const float A = dot3(xb, xb), B = dot3(xb, xn), C = dot3(xn, xn);
  const float P = dot3(xa, xb), Q = dot3(xa, xn);
  const float det = dot3(xbn, xbn);
  const float S = w.S, G = w.G;
  // the zero of x_a + s x_b + t x_n: inside the box (or no edge to bound
  // it) keeps the entry
  const float s0 = (B * Q - C * P) / det, t0 = (B * P - A * Q) / det;
  if (!(det > 0.f && (fabsf(s0) > S || fabsf(t0) > G))) return true;
  const auto h = [&](float s, float t) {
    float v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = xa[k] + s * xb[k] + t * xn[k];
    return dot3(v, v);
  };
  const float h_min = fminf(
      fminf(h(S, fminf(fmaxf(-(Q + S * B) / C, -G), G)),
            h(-S, fminf(fmaxf(-(Q - S * B) / C, -G), G))),
      fminf(h(fminf(fmaxf(-(P + G * B) / A, -S), S), G),
            h(fminf(fmaxf(-(P - G * B) / A, -S), S), -G)));
  // the walk's r = M d off by up to 24 eps |M| (and the frame's own
  // rounding), its sigma* by 8 eps |g|; each edge's least value taken at a
  // rounded point; the apexes' spread
  const float dr = 4e-6f * mnorm;
  const float num = sqrtf(h_min) * (1.f - 1e-5f) -
                    1e-5f * (sqrtf(dot3(xa, xa)) + S * sqrtf(A) + G * sqrtf(C)) - gmag * dr;
  const float den = (sqrtf(dot3(ra, ra)) + S * sqrtf(dot3(rb, rb)) + G * sqrtf(dot3(rn, rn))) *
                        (1.f + 1e-5f) + dr;
  const float dist = num / den - mnorm * w.odev - 16.f * kEps * gmag;
  const float rho = sqrtf(2.f * (__logf(255.f * op) + 0.25f));
  return !(dist > rho);
}

}  // namespace tdgsraycull
