// The 2DGS surfel projection, forward and backward, one launch each:
// ops/projection_2dgs.py surfel_project_fwd and surfel_project_bwd, behind
// the autograd Function of fully_fused_projection_2dgs.
//
// Replaces no TPU kernel. The JAX package's tdgs/ops/projection_2dgs.py
// fully_fused_projection_2dgs is plain jnp, which XLA fuses, forward and
// backward. PyTorch runs the same chain (surfel_projection_chain) as some 190
// launches over [C, N] float32 tensors and differentiates it by autograd in
// some 290 more (products, accumulations, fills, and the copies of the
// stacks and unbinds), each writing its intermediate to device memory and
// reading it back.
//
// Semantics, per (camera i, surfel g) row of the [..., C, N] rows: the plain
// chain's forward and surfel_projection_vjp_plain's backward, operation for
// operation in their order. The library is built with -fmad=false
// (_build.SOURCE_FLAGS): every product and sum is rounded on its own, as
// PyTorch's elementwise launches round them, with IEEE division and square
// root; constants are the chain's Python floats rounded to float32. So the
// outputs and the gradients equal the plain versions' on the card bit for
// bit. The backward takes no intermediate from the forward: it recomputes
// the rotation, the camera-frame axes, T_sl, d and the flip from the saved
// inputs, by the same device functions, and sums each surfel's terms over
// its cameras in their order inside the thread (no atomics: repeatable).
//
// What bounds it on the H100: bytes. Forward, a row reads means 12 B, quats
// 16 and the two scales (12 B rows), and writes radii 8, means2d 8, the depth
// 4, M 36 and the normal 12: 108 B, 324 MB at 3M rows with one camera, 0.097
// ms at 3.35 TB/s. Backward, it reads the inputs again (40 B), the
// cotangents of means2d, the depth, M and the normal (60 B), and writes the
// gradients of means, quats and scales (40 B): 140 B, 0.42 GB, 0.125 ms. Some
// 200 and 400 FP32 operations a row are far below the card's balance point.
//
// Design: one thread a surfel and one camera (forward) or one batch entry
// (backward) a grid row, nothing intermediate in device memory. The camera
// is read by every thread of a block from the same addresses (L1
// broadcasts). The quaternion is one 16-byte load where it lies on a 16-byte
// boundary; means and scales are float triples, neighbouring threads' rows on
// neighbouring addresses, so a warp's loads cover the same cache lines.
#include <cuda_runtime.h>

#include <cstdint>

// The launch's arguments, filled by the Python wrapper (a ctypes.Structure
// of the same fields in the same order).
struct SurfelProjectArgs {
  const float* means;      // [G, 3], G = B * N
  const float* quats;      // [G, 4] wxyz
  const float* scales;     // [G, S], S = scale_width >= 2; the first two read
  const float* viewmats;   // [I, 4, 4] world -> camera, I = B * C
  const float* Ks;         // [I, 3, 3]
  int32_t* radii;          // forward: [R, 2], R = I * N
  float* means2d;          // [R, 2]
  float* depths;           // [R]
  float* M;                // [R, 3, 3]
  float* normals;          // [R, 3]
  const float* v_means2d;  // backward: [R, 2], or null (zero)
  const float* v_depths;   // [R] or null
  const float* v_M;        // [R, 3, 3] or null
  const float* v_normals;  // [R, 3] or null
  float* v_means;          // [G, 3]
  float* v_quats;          // [G, 4]
  float* v_scales;         // [G, S]
  int64_t n_gauss;         // N
  int64_t n_cams;          // C, the cameras of one batch entry
  int64_t n_batch;         // B
  int32_t scale_width;     // S
  int32_t vec_quats;       // quats on a 16-byte boundary
  float width, height, near_plane, far_plane, radius_clip, eps;
};

namespace {

constexpr int kThreads = 256;  // surfels a block

struct Camera {
  float W[3][3], t[3];
  float fx, fy, cx, cy;
};

__device__ __forceinline__ void load_camera(const SurfelProjectArgs& a, int64_t i, Camera& c) {
  const float* vm = a.viewmats + 16 * i;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.W[r][j] = __ldg(vm + 4 * r + j);
    c.t[r] = __ldg(vm + 4 * r + 3);
  }
  const float* K = a.Ks + 9 * i;
  c.fx = __ldg(K + 0);
  c.fy = __ldg(K + 4);
  c.cx = __ldg(K + 2);
  c.cy = __ldg(K + 5);
}

// The surfel's mean, two scales and unit quaternion, and its rotation:
// _geometry's per-surfel terms.
struct Surfel {
  float m[3], s[2];
  float q[4];     // the unit quaternion (w, x, y, z)
  float norm;     // sqrt(max(|q|^2, 1e-24))
  bool free;      // |q|^2 >= 1e-24: the norm carries a gradient
  float r[9];     // the rotation, row-major
};

__device__ __forceinline__ void load_surfel(const SurfelProjectArgs& a, int64_t g, Surfel& p) {
#pragma unroll
  for (int k = 0; k < 3; ++k) p.m[k] = __ldg(a.means + 3 * g + k);
  p.s[0] = __ldg(a.scales + a.scale_width * g);
  p.s[1] = __ldg(a.scales + a.scale_width * g + 1);
  float4 q;
  if (a.vec_quats) {
    q = __ldg(reinterpret_cast<const float4*>(a.quats) + g);
  } else {
    q = make_float4(__ldg(a.quats + 4 * g), __ldg(a.quats + 4 * g + 1), __ldg(a.quats + 4 * g + 2),
                    __ldg(a.quats + 4 * g + 3));
  }
  const float sq = q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w;
  const float lo = static_cast<float>(1e-24);
  p.norm = sqrtf(sq < lo ? lo : sq);  // torch.clamp: NaN stays NaN
  p.free = sq >= lo;
  const float w = q.x / p.norm, x = q.y / p.norm, y = q.z / p.norm, z = q.w / p.norm;
  p.q[0] = w;
  p.q[1] = x;
  p.q[2] = y;
  p.q[3] = z;
  p.r[0] = 1.0f - 2.0f * (y * y + z * z);
  p.r[1] = 2.0f * (x * y - w * z);
  p.r[2] = 2.0f * (x * z + w * y);
  p.r[3] = 2.0f * (x * y + w * z);
  p.r[4] = 1.0f - 2.0f * (x * x + z * z);
  p.r[5] = 2.0f * (y * z - w * x);
  p.r[6] = 2.0f * (x * z - w * y);
  p.r[7] = 2.0f * (y * z + w * x);
  p.r[8] = 1.0f - 2.0f * (x * x + y * y);
}

// _geometry's per-(camera, surfel) terms
struct Geometry {
  float mc[3];    // the mean in the camera frame
  float n[3];     // the third axis in the camera frame
  float flip;     // +-1: the normal turned toward the camera
  float T[3][3];  // T_sl = K [RS_u, RS_v, mean_c]; h = T[2]
  float f[3];     // (1, 1, -1) / d where |d| > eps, else 0
  float rcp;      // 1 / d (1 where d = 0)
  bool big;       // |d| > eps
};

__device__ __forceinline__ void geometry(const Camera& c, const Surfel& p, float eps,
                                         Geometry& g) {
  float RS_wl[3][2], Tcl[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g.mc[i] = c.W[i][0] * p.m[0] + c.W[i][1] * p.m[1] + c.W[i][2] * p.m[2] + c.t[i];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int j = 0; j < 2; ++j) RS_wl[k][j] = p.r[3 * k + j] * p.s[j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      Tcl[i][j] = c.W[i][0] * RS_wl[0][j] + c.W[i][1] * RS_wl[1][j] + c.W[i][2] * RS_wl[2][j];
    }
    Tcl[i][2] = g.mc[i];
    g.n[i] = c.W[i][0] * p.r[2] + c.W[i][1] * p.r[5] + c.W[i][2] * p.r[8];
  }
  const float cosv = -(g.n[0] * g.mc[0] + g.n[1] * g.mc[1] + g.n[2] * g.mc[2]);
  g.flip = cosv > 0.0f ? 1.0f : -1.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    g.T[0][j] = c.fx * Tcl[0][j] + c.cx * Tcl[2][j];
    g.T[1][j] = c.fy * Tcl[1][j] + c.cy * Tcl[2][j];
    g.T[2][j] = Tcl[2][j];
  }
  const float* h = g.T[2];
  const float d = h[0] * h[0] + h[1] * h[1] - h[2] * h[2];
  const float d_safe = d == 0.0f ? 1.0f : d;
  g.big = fabsf(d) > eps;
  g.rcp = 1.0f / d_safe;
  g.f[0] = g.big ? g.rcp : 0.0f;
  g.f[1] = g.f[0];
  g.f[2] = g.big ? -g.rcp : 0.0f;
}

__global__ void __launch_bounds__(kThreads) surfel_project_fwd_kernel(const SurfelProjectArgs a) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= a.n_gauss) return;
  const int64_t cam = blockIdx.y;  // over the B * C cameras
  const int64_t row = cam * a.n_gauss + n;
  Surfel p;
  load_surfel(a, (cam / a.n_cams) * a.n_gauss + n, p);
  Camera c;
  load_camera(a, cam, c);
  Geometry g;
  geometry(c, p, a.eps, g);

  const float(*T)[3] = g.T;
  const float* h = g.T[2];
  const float* f = g.f;
  float m2d[2], ext[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    m2d[k] = T[k][0] * h[0] * f[0] + T[k][1] * h[1] * f[1] + T[k][2] * h[2] * f[2];
    const float e = m2d[k] * m2d[k] -
                    (T[k][0] * T[k][0] * f[0] + T[k][1] * T[k][1] * f[1] + T[k][2] * T[k][2] * f[2]);
    const float lo = static_cast<float>(1e-4);
    ext[k] = sqrtf(e < lo ? lo : e);
  }
  const float depth = g.mc[2];
  const float sigmas = static_cast<float>(3.33);
  const float rx = ceilf(sigmas * ext[0]);
  const float ry = ceilf(sigmas * ext[1]);
  bool valid = g.big && depth > a.near_plane && depth < a.far_plane;
  valid = valid && !(rx <= a.radius_clip && ry <= a.radius_clip);
  valid = valid && m2d[0] + rx > 0.0f && m2d[0] - rx < a.width && m2d[1] + ry > 0.0f &&
          m2d[1] - ry < a.height;

  reinterpret_cast<int2*>(a.radii)[row] =
      valid ? make_int2(static_cast<int>(rx), static_cast<int>(ry)) : make_int2(0, 0);
  reinterpret_cast<float2*>(a.means2d)[row] = make_float2(m2d[0], m2d[1]);
  a.depths[row] = depth;
  float* Mr = a.M + 9 * row;  // M = T_sl^T
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) Mr[3 * i + j] = T[j][i];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) a.normals[3 * row + i] = g.n[i] * g.flip;
}

__device__ __forceinline__ float load_or_zero(const float* p, int64_t i) {
  return p == nullptr ? 0.0f : __ldg(p + i);
}

__global__ void __launch_bounds__(kThreads) surfel_project_bwd_kernel(const SurfelProjectArgs a) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= a.n_gauss) return;
  const int64_t b = blockIdx.y;
  const int64_t gi = b * a.n_gauss + n;
  Surfel p;
  load_surfel(a, gi, p);

  // each camera's terms of the VJP, summed over the cameras in their order
  float acc_m[3] = {0.0f, 0.0f, 0.0f}, acc_r[9] = {}, acc_s[2] = {0.0f, 0.0f};
  for (int64_t ci = 0; ci < a.n_cams; ++ci) {
    const int64_t cam = b * a.n_cams + ci;
    const int64_t row = cam * a.n_gauss + n;
    Camera c;
    load_camera(a, cam, c);
    Geometry g;
    geometry(c, p, a.eps, g);
    const float(*T)[3] = g.T;
    const float* h = g.T[2];
    const float* f = g.f;

    const float gu = load_or_zero(a.v_means2d, 2 * row);
    const float gv = load_or_zero(a.v_means2d, 2 * row + 1);
    const float gz = load_or_zero(a.v_depths, row);
    float gT[3][3], gn[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int r = 0; r < 3; ++r) gT[k][r] = load_or_zero(a.v_M, 9 * row + 3 * r + k);
      gn[k] = load_or_zero(a.v_normals, 3 * row + k);
    }

    // M = T_sl^T, then means2d_k = sum_r T_sl[k][r] h_r f_r
    float av[3], gh[3], gf[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) av[r] = gu * T[0][r] + gv * T[1][r];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      gT[0][r] = gT[0][r] + gu * h[r] * f[r];
      gT[1][r] = gT[1][r] + gv * h[r] * f[r];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) gh[r] = av[r] * f[r];
#pragma unroll
    for (int r = 0; r < 3; ++r) gf[r] = av[r] * h[r];
    // f = (1, 1, -1) / d where |d| > eps; d = h0^2 + h1^2 - h2^2
    const float g_rcp = gf[0] + gf[1] - gf[2];
    const float gd = g.big ? -(g_rcp * g.rcp * g.rcp) : 0.0f;
    gh[0] = gh[0] + 2.0f * h[0] * gd;
    gh[1] = gh[1] + 2.0f * h[1] * gd;
    gh[2] = gh[2] - 2.0f * h[2] * gd;
#pragma unroll
    for (int r = 0; r < 3; ++r) gT[2][r] = gT[2][r] + gh[r];
    // T_sl = K T_cl; T_cl = [RS_cl[:, 0], RS_cl[:, 1], mean_c]; depth = mean_c[2]
    float gTc[3][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      gTc[0][j] = c.fx * gT[0][j];
      gTc[1][j] = c.fy * gT[1][j];
      gTc[2][j] = c.cx * gT[0][j] + c.cy * gT[1][j] + gT[2][j];
    }
    gTc[2][2] = gTc[2][2] + gz;
    float g_ncl[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) g_ncl[i] = gn[i] * g.flip;
    // back to the world frame: W^T
    float cm[3], cr[9], cs[2], g_RSwl[3][2];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        g_RSwl[k][j] = c.W[0][k] * gTc[0][j] + c.W[1][k] * gTc[1][j] + c.W[2][k] * gTc[2][j];
      }
      cr[3 * k + 2] = c.W[0][k] * g_ncl[0] + c.W[1][k] * g_ncl[1] + c.W[2][k] * g_ncl[2];
      cm[k] = c.W[0][k] * gTc[0][2] + c.W[1][k] * gTc[1][2] + c.W[2][k] * gTc[2][2];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int j = 0; j < 2; ++j) cr[3 * k + j] = g_RSwl[k][j] * p.s[j];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      cs[j] = g_RSwl[0][j] * p.r[j] + g_RSwl[1][j] * p.r[3 + j] + g_RSwl[2][j] * p.r[6 + j];
    }

    // the first camera's terms start the sums (0 + x would turn -0 into +0)
    const bool first = ci == 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) acc_m[k] = first ? cm[k] : acc_m[k] + cm[k];
#pragma unroll
    for (int k = 0; k < 9; ++k) acc_r[k] = first ? cr[k] : acc_r[k] + cr[k];
#pragma unroll
    for (int j = 0; j < 2; ++j) acc_s[j] = first ? cs[j] : acc_s[j] + cs[j];
  }

  // the rotation of the unit quaternion (w, x, y, z), then its norm
  const float w = p.q[0], x = p.q[1], y = p.q[2], z = p.q[3];
  const float g00 = acc_r[0], g01 = acc_r[1], g02 = acc_r[2], g10 = acc_r[3], g11 = acc_r[4],
              g12 = acc_r[5], g20 = acc_r[6], g21 = acc_r[7], g22 = acc_r[8];
  float gq[4];
  gq[0] = 2.0f * (z * (g10 - g01) + y * (g02 - g20) + x * (g21 - g12));
  gq[1] = 2.0f * (y * (g01 + g10) + z * (g02 + g20) + w * (g21 - g12) - 2.0f * x * (g11 + g22));
  gq[2] = 2.0f * (x * (g01 + g10) + w * (g02 - g20) + z * (g12 + g21) - 2.0f * y * (g00 + g22));
  gq[3] = 2.0f * (w * (g10 - g01) + x * (g02 + g20) + y * (g12 + g21) - 2.0f * z * (g00 + g11));
  const float dot = p.free ? w * gq[0] + x * gq[1] + y * gq[2] + z * gq[3] : 0.0f;
  float4 vq;
  vq.x = (gq[0] - w * dot) / p.norm;
  vq.y = (gq[1] - x * dot) / p.norm;
  vq.z = (gq[2] - y * dot) / p.norm;
  vq.w = (gq[3] - z * dot) / p.norm;
  reinterpret_cast<float4*>(a.v_quats)[gi] = vq;
#pragma unroll
  for (int k = 0; k < 3; ++k) a.v_means[3 * gi + k] = acc_m[k];
  float* vs = a.v_scales + a.scale_width * gi;
  vs[0] = acc_s[0];
  vs[1] = acc_s[1];
  for (int j = 2; j < a.scale_width; ++j) vs[j] = 0.0f;
}

int check(const SurfelProjectArgs& a, int64_t grid_y) {
  if (a.n_gauss < 0 || a.n_cams < 0 || a.n_batch < 0 || a.scale_width < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (grid_y > 65535 || (a.n_gauss + kThreads - 1) / kThreads >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaSuccess);
}

dim3 grid(const SurfelProjectArgs& a, int64_t grid_y) {
  return dim3(static_cast<unsigned>((a.n_gauss + kThreads - 1) / kThreads),
              static_cast<unsigned>(grid_y));
}

}  // namespace

// One launch over the B * C cameras (grid rows) and the N surfels; the
// outputs are dense, radii and means2d on 8-byte boundaries. Returns a
// cudaError_t (0 on success).
extern "C" int tdgs_surfel_project(const SurfelProjectArgs* args, void* stream) {
  const SurfelProjectArgs& a = *args;
  const int64_t cams = a.n_batch * a.n_cams;
  if (const int err = check(a, cams)) return err;
  if (a.n_gauss == 0 || cams == 0) return static_cast<int>(cudaSuccess);
  surfel_project_fwd_kernel<<<grid(a, cams), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One launch over the B batch entries (grid rows) and the N surfels, each
// thread summing its surfel's terms over the C cameras; the gradients are
// dense, v_quats on a 16-byte boundary. Returns a cudaError_t.
extern "C" int tdgs_surfel_project_bwd(const SurfelProjectArgs* args, void* stream) {
  const SurfelProjectArgs& a = *args;
  if (const int err = check(a, a.n_batch)) return err;
  if (a.n_gauss == 0 || a.n_batch == 0) return static_cast<int>(cudaSuccess);
  surfel_project_bwd_kernel<<<grid(a, a.n_batch), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
