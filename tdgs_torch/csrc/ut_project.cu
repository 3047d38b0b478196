// The unscented-transform (3DGUT) projection of gaussians to cameras, forward
// only, in one launch: ops/projection_ut.py project_ut_for_tiles.
//
// Replaces no TPU kernel. The JAX package's tdgs/ops/projection_ut.py is plain
// jnp, which XLA fuses; PyTorch runs the same chain
// (fully_fused_projection_with_ut) as some sixty launches over [C, N, 7, 3]
// and [C, N, 7, 2] float32 tensors (84 MB each at 1M gaussians), among them a
// cuBLAS float32 GEMM for the 3x3 rotation of every sigma point, each writing
// its intermediate to device memory and reading it back. Under the eval3d
// rasterizer the projection only tiles (radii, means2d and depths feed the
// tile sort, the response is taken along the rays), so no gradient flows back
// through it and a forward kernel is all it needs. It computes no
// compensations: an antialiased render scales the opacities by them, a
// gradient flows through them, and that render keeps the chain.
//
// Semantics, per row (camera i, gaussian g) of the [..., C, N] rows, flattened
// (i = row / N over the flattened cameras, g from the row's batch and column):
// the plain chain's, in its order of operations where that is free:
//   q = q / max(|q|, 1e-12), R = R(q), the axes a_j = (R[:, j] s_j) gamma,
//   the sigma points m, m + a_j, m - a_j (j = 0..2), each taken to the camera
//   (R_cw p + t_cw) and through its model (pinhole, with the OpenCV rational
//   radial, tangential and thin-prism terms when given; the equidistant
//   fisheye; FTheta's angle -> pixel polynomial; orthographic); under a rolling
//   shutter `rs_iterations` passes that take each point again from the pose
//   at its pixel's shutter time (nlerp of the frame's start and end
//   quaternions, linear translation); then the UT moments (weighted mean and
//   covariance of the 7 pixels), the conic of the covariance plus eps2d, and
//   the chain's validity tests, extent and radii. The depth is the centre
//   point's camera z from the last pass.
// Float32 throughout, with IEEE division, square root and logf (no fast
// math); sums are taken in the sigma points' order.
//
// What bounds it on the H100: bytes. A row reads means 12 B, quats 16, scales
// 12 and the opacity 4, and writes radii 8, means2d 8, the depth 4 and the
// conic 12: 76 B, or 76 MB at 1M rows, 0.023 ms at 3.35 TB/s; some 400 FP32
// operations a row (0.006 ms at 67 TFLOP/s) are far below the card's balance
// point.
//
// Design: one thread a row, nothing intermediate in device memory. The
// gaussian's axes, its 7 pixels and the moments stay in registers; a sigma
// point is formed again from the mean and an axis where a rolling-shutter
// pass needs it. The camera (pose, intrinsics, coefficients) is read by every
// thread of a block from the same few addresses (L1 broadcasts). The
// quaternion is one 16-byte load; means and scales are float triples, the
// neighbouring threads' rows on neighbouring addresses, so a warp's three
// loads cover the same cache lines; means2d and radii are 8-byte stores. The
// camera model and the rolling shutter are template parameters, so the
// global-shutter pinhole of the training path carries none of the others'
// registers.
#include <cuda_runtime.h>

#include <cstdint>

// The launch's arguments, filled by the Python wrapper (a ctypes.Structure
// of the same fields in the same order).
struct UtProjectArgs {
  const float* means;        // [G, 3]
  const float* quats;        // [G, 4] wxyz
  const float* scales;       // [G, 3]
  const float* opacities;    // [G] or null
  const float* viewmats;     // [I, 4, 4] world -> camera, frame start
  const float* Ks;           // [I, 3, 3]
  const float* radial;       // [I, 6] (pinhole) or [I, 4] (fisheye), or null
  const float* tangential;   // [I, 2] or null
  const float* thin_prism;   // [I, 4] or null
  const float* viewmats_rs;  // [I, 4, 4] frame end, or null (global shutter)
  const float* rs_quats;     // [I, 2, 4]: the start pose's quaternion, the end's signed
  int32_t* radii;            // [R, 2]
  float* means2d;            // [R, 2]
  float* depths;             // [R]
  float* conics;             // [R, 3]
  int64_t n_rows;            // R = I * N
  int64_t n_gauss;           // N
  int64_t n_cams;            // C, the cameras of one batch entry
  int32_t camera;            // CameraKind
  int32_t rs_type;           // RollingShutterType
  int32_t rs_iterations;
  int32_t require_all;       // require_all_sigma_points_valid
  int32_t n_poly;            // FTheta angle -> pixel distance coefficients
  int32_t vec_quats;         // quats on a 16-byte boundary
  float width, height, eps2d, near_plane, far_plane, radius_clip;
  float lo_x, hi_x, lo_y, hi_y;  // the margin tests' bounds
  float gamma;                   // sqrt(n + lambda)
  float w_mean0, w_cov0, w_i;    // the UT weights
  float alpha_threshold, extend_max;
  float poly[8];
  float max_angle;
};

namespace {

constexpr int kThreads = 256;  // rows a block
constexpr int kPoints = 7;     // sigma points a gaussian

enum CameraKind : int {
  kPinhole = 0,
  kPinholeDistorted = 1,
  kFisheye = 2,
  kFtheta = 3,
  kOrtho = 4,
};

struct Camera {
  float R[3][3], t[3];
  float fx, fy, cx, cy;
  float k[6], p[2], s[4];
  bool has_k, has_p, has_s;
};

template <int CAM>
__device__ __forceinline__ void load_camera(const UtProjectArgs& a, int64_t i, Camera& c) {
  const float* vm = a.viewmats + 16 * i;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.R[r][j] = __ldg(vm + 4 * r + j);
    c.t[r] = __ldg(vm + 4 * r + 3);
  }
  const float* K = a.Ks + 9 * i;
  c.fx = __ldg(K + 0);
  c.fy = __ldg(K + 4);
  c.cx = __ldg(K + 2);
  c.cy = __ldg(K + 5);
  c.has_k = c.has_p = c.has_s = false;
  if (CAM == kPinholeDistorted) {
    c.has_k = a.radial != nullptr;
    c.has_p = a.tangential != nullptr;
    c.has_s = a.thin_prism != nullptr;
    if (c.has_k) {
#pragma unroll
      for (int j = 0; j < 6; ++j) c.k[j] = __ldg(a.radial + 6 * i + j);
    }
    if (c.has_p) {
      c.p[0] = __ldg(a.tangential + 2 * i);
      c.p[1] = __ldg(a.tangential + 2 * i + 1);
    }
    if (c.has_s) {
#pragma unroll
      for (int j = 0; j < 4; ++j) c.s[j] = __ldg(a.thin_prism + 4 * i + j);
    }
  } else if (CAM == kFisheye) {
    c.has_k = a.radial != nullptr;
    if (c.has_k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) c.k[j] = __ldg(a.radial + 4 * i + j);
    }
  }
}

// camera_models.project_point: camera space -> pixel; returns the point's
// validity (in front of the camera; FTheta: within its largest angle)
template <int CAM>
__device__ __forceinline__ bool project(const float pc[3], const Camera& c,
                                        const UtProjectArgs& a, float& u, float& v) {
  const float X = pc[0], Y = pc[1], Z = pc[2];
  if (CAM == kFtheta) {
    const float r3d = sqrtf(X * X + Y * Y);
    const float theta = atan2f(r3d, Z);
    float rd = 0.0f;
    for (int j = a.n_poly - 1; j >= 0; --j) rd = rd * theta + a.poly[j];
    const float r_safe = r3d < 1e-9f ? 1.0f : r3d;
    u = X / r_safe * rd + c.cx;
    v = Y / r_safe * rd + c.cy;
    return theta <= a.max_angle;
  }
  if (CAM == kOrtho) {
    u = c.fx * X + c.cx;
    v = c.fy * Y + c.cy;
    return Z > 0.0f;
  }
  const float Zs = fabsf(Z) < 1e-9f ? 1e-9f : Z;
  const float x = X / Zs, y = Y / Zs;
  float xd = x, yd = y;
  if (CAM == kPinholeDistorted) {
    const float r2 = x * x + y * y;
    float scale = 1.0f;
    if (c.has_k) {
      const float num = 1.0f + r2 * (c.k[0] + r2 * (c.k[1] + r2 * c.k[2]));
      const float den = 1.0f + r2 * (c.k[3] + r2 * (c.k[4] + r2 * c.k[5]));
      scale = num / (den == 0.0f ? 1.0f : den);
    }
    float dx = 0.0f, dy = 0.0f;
    if (c.has_p) {
      dx = dx + (2.0f * c.p[0] * x * y + c.p[1] * (r2 + 2.0f * x * x));
      dy = dy + (c.p[0] * (r2 + 2.0f * y * y) + 2.0f * c.p[1] * x * y);
    }
    if (c.has_s) {
      dx = dx + r2 * (c.s[0] + c.s[1] * r2);
      dy = dy + r2 * (c.s[2] + c.s[3] * r2);
    }
    xd = x * scale + dx;
    yd = y * scale + dy;
  } else if (CAM == kFisheye) {
    const float r = sqrtf(x * x + y * y);
    const bool small = r < 1e-9f;
    const float theta = atanf(r);
    float theta_d = theta;
    if (c.has_k) {
      const float t2 = theta * theta;
      theta_d = theta * (1.0f + t2 * (c.k[0] + t2 * (c.k[1] + t2 * (c.k[2] + t2 * c.k[3]))));
    }
    const float scale = small ? 1.0f : theta_d / r;
    xd = x * scale;
    yd = y * scale;
  }
  u = c.fx * xd + c.cx;
  v = c.fy * yd + c.cy;
  return Z > 0.0f;
}

// torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// quat_normalize then quat_to_rotmat_comps (row-major)
__device__ __forceinline__ void rotmat(float w, float x, float y, float z, float R[3][3]) {
  const float norm = fmaxf(sqrtf(w * w + x * x + y * y + z * z), 1e-12f);
  w = w / norm;
  x = x / norm;
  y = y / norm;
  z = z / norm;
  R[0][0] = 1.0f - 2.0f * (y * y + z * z);
  R[0][1] = 2.0f * (x * y - w * z);
  R[0][2] = 2.0f * (x * z + w * y);
  R[1][0] = 2.0f * (x * y + w * z);
  R[1][1] = 1.0f - 2.0f * (x * x + z * z);
  R[1][2] = 2.0f * (y * z - w * x);
  R[2][0] = 2.0f * (x * z - w * y);
  R[2][1] = 2.0f * (y * z + w * x);
  R[2][2] = 1.0f - 2.0f * (x * x + y * y);
}

// sigma point k: m, m + a_{k-1} (k = 1..3), m - a_{k-4} (k = 4..6)
__device__ __forceinline__ void sigma_point(int k, const float m[3], const float ax[3][3],
                                            float p[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    p[r] = k == 0 ? m[r] : (k <= 3 ? m[r] + ax[k - 1][r] : m[r] - ax[k - 4][r]);
  }
}

__device__ __forceinline__ void transform(const float R[3][3], const float t[3], const float p[3],
                                          float pc[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) pc[r] = R[r][0] * p[0] + R[r][1] * p[1] + R[r][2] * p[2] + t[r];
}

template <int CAM, bool RS>
__global__ void __launch_bounds__(kThreads) ut_project_kernel(const UtProjectArgs a) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= a.n_rows) return;
  int64_t cam = 0, g = row;
  if (a.n_rows != a.n_gauss) {  // more than one camera
    cam = row / a.n_gauss;
    g = (cam / a.n_cams) * a.n_gauss + (row - cam * a.n_gauss);
  }

  // the gaussian's mean and its scaled axes a_j = (R[:, j] s_j) gamma
  float m[3], s[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    m[r] = __ldg(a.means + 3 * g + r);
    s[r] = __ldg(a.scales + 3 * g + r);
  }
  float4 q;
  if (a.vec_quats) {
    q = __ldg(reinterpret_cast<const float4*>(a.quats) + g);
  } else {
    q = make_float4(__ldg(a.quats + 4 * g), __ldg(a.quats + 4 * g + 1), __ldg(a.quats + 4 * g + 2),
                    __ldg(a.quats + 4 * g + 3));
  }
  float ax[3][3];
  {
    float R[3][3];
    rotmat(q.x, q.y, q.z, q.w, R);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int r = 0; r < 3; ++r) ax[j][r] = (R[r][j] * s[j]) * a.gamma;
    }
  }

  Camera c;
  load_camera<CAM>(a, cam, c);
  float pu[kPoints], pv[kPoints];
  bool all_ok = true, any_ok = false;
  float depth = 0.0f;
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    float p[3], pc[3];
    sigma_point(k, m, ax, p);
    transform(c.R, c.t, p, pc);
    if (k == 0) depth = pc[2];
    const bool ok = project<CAM>(pc, c, a, pu[k], pv[k]);
    all_ok = all_ok && ok;
    any_ok = any_ok || ok;
  }

  if (RS) {
    // interpolate_pose between the frame's start and end poses at each
    // point's shutter time, from the pixel of the previous pass
    float q0[4], q1[4], t1[3];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      q0[j] = __ldg(a.rs_quats + 8 * cam + j);
      q1[j] = __ldg(a.rs_quats + 8 * cam + 4 + j);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) t1[r] = __ldg(a.viewmats_rs + 16 * cam + 4 * r + 3);
    for (int it = 0; it < a.rs_iterations; ++it) {
      all_ok = true;
      any_ok = false;
#pragma unroll
      for (int k = 0; k < kPoints; ++k) {
        const float su = clamp_nan(pu[k] / a.width, 0.0f, 1.0f);
        const float sv = clamp_nan(pv[k] / a.height, 0.0f, 1.0f);
        const float tt = a.rs_type == 1 ? sv
                         : a.rs_type == 2 ? su
                         : a.rs_type == 3 ? 1.0f - sv
                                          : 1.0f - su;
        const float om = 1.0f - tt;
        float qi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) qi[j] = q0[j] * om + q1[j] * tt;
        const float norm =
            fmaxf(sqrtf(qi[0] * qi[0] + qi[1] * qi[1] + qi[2] * qi[2] + qi[3] * qi[3]), 1e-12f);
        float R[3][3], t[3];
        rotmat(qi[0] / norm, qi[1] / norm, qi[2] / norm, qi[3] / norm, R);
#pragma unroll
        for (int r = 0; r < 3; ++r) t[r] = c.t[r] * om + t1[r] * tt;
        float p[3], pc[3];
        sigma_point(k, m, ax, p);
        transform(R, t, p, pc);
        if (k == 0) depth = pc[2];
        const bool ok = project<CAM>(pc, c, a, pu[k], pv[k]);
        all_ok = all_ok && ok;
        any_ok = any_ok || ok;
      }
    }
  }

  // the UT moments
  float mu = a.w_mean0 * pu[0], mv = a.w_mean0 * pv[0];
#pragma unroll
  for (int k = 1; k < kPoints; ++k) {
    mu = mu + a.w_i * pu[k];
    mv = mv + a.w_i * pv[k];
  }
  float c00 = 0.0f, c01 = 0.0f, c11 = 0.0f;
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const float w = k == 0 ? a.w_cov0 : a.w_i;
    const float du = pu[k] - mu, dv = pv[k] - mv;
    c00 = c00 + w * du * du;
    c01 = c01 + w * du * dv;
    c11 = c11 + w * dv * dv;
  }

  const float c00b = c00 + a.eps2d, c11b = c11 + a.eps2d;
  const float det = c00b * c11b - c01 * c01;
  const float det_safe = det == 0.0f ? 1.0f : det;

  bool valid = (a.require_all ? all_ok : any_ok) && det > 0.0f && depth > a.near_plane &&
               depth < a.far_plane;
  float extend = a.extend_max;
  if (a.opacities != nullptr) {
    const float op = __ldg(a.opacities + g);
    valid = valid && op >= a.alpha_threshold;
    const float opc = op < a.alpha_threshold ? a.alpha_threshold : op;
    extend = fminf(extend, sqrtf(2.0f * logf(opc / a.alpha_threshold)));
  }
  const float rx = ceilf(extend * sqrtf(c00b < 0.0f ? 0.0f : c00b));
  const float ry = ceilf(extend * sqrtf(c11b < 0.0f ? 0.0f : c11b));
  valid = valid && !(rx <= a.radius_clip && ry <= a.radius_clip);
  valid = valid && mu + rx > a.lo_x && mu - rx < a.hi_x && mv + ry > a.lo_y && mv - ry < a.hi_y;

  reinterpret_cast<int2*>(a.radii)[row] =
      valid ? make_int2(static_cast<int>(rx), static_cast<int>(ry)) : make_int2(0, 0);
  reinterpret_cast<float2*>(a.means2d)[row] = make_float2(mu, mv);
  a.depths[row] = depth;
  a.conics[3 * row] = c11b / det_safe;
  a.conics[3 * row + 1] = -c01 / det_safe;
  a.conics[3 * row + 2] = c00b / det_safe;
}

template <int CAM>
cudaError_t launch(const UtProjectArgs& a, bool rs, unsigned blocks, cudaStream_t stream) {
  if (rs) {
    ut_project_kernel<CAM, true><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    ut_project_kernel<CAM, false><<<blocks, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// One launch over args->n_rows rows; the outputs are dense, radii and means2d
// on 8-byte boundaries. A rolling shutter is applied where rs_type is not 0,
// viewmats_rs and rs_quats are given and rs_iterations > 0. Returns a
// cudaError_t (0 on success).
extern "C" int tdgs_ut_project(const UtProjectArgs* args, void* stream) {
  const UtProjectArgs& a = *args;
  if (a.n_rows < 0 || a.n_poly < 0 || a.n_poly > 8) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_rows == 0) return static_cast<int>(cudaSuccess);
  if (a.n_gauss <= 0 || a.n_cams <= 0 || a.n_rows % a.n_gauss != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (a.n_rows + kThreads - 1) / kThreads;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const bool rs = a.rs_type != 0 && a.viewmats_rs != nullptr && a.rs_quats != nullptr &&
                  a.rs_iterations > 0;
  const unsigned b = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.camera) {
    case kPinhole: return static_cast<int>(launch<kPinhole>(a, rs, b, s));
    case kPinholeDistorted: return static_cast<int>(launch<kPinholeDistorted>(a, rs, b, s));
    case kFisheye: return static_cast<int>(launch<kFisheye>(a, rs, b, s));
    case kFtheta: return static_cast<int>(launch<kFtheta>(a, rs, b, s));
    case kOrtho: return static_cast<int>(launch<kOrtho>(a, rs, b, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
