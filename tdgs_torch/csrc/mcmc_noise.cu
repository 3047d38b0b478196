// The MCMC position noise over every row, in one launch:
// MCMCStrategy.step_post_backward's inject_noise_to_position.
//
// Replaces no TPU kernel. The JAX package's tdgs/strategy/ops.py is plain
// jnp, and XLA fuses its sigmoids, the covariance, the gate, the matvec and
// the masked add into one pass; PyTorch runs the same chain as some thirty
// launches, among them a cuBLAS batched GEMM over 1M 3x3 matrices and a
// batched matvec, each writing its intermediate to device memory and reading
// it back. Semantics, per row i (q the quaternion wxyz, l the log-scales, o
// the opacity logit, e the standard normal noise):
//   if active is given and active[i] is 0: means'[i] = means[i] (a bitwise
//   copy); else
//   q = q / max(|q|, 1e-12), R = R(q), s = exp(l),
//   gate = sigmoid(100 ((1 - sigmoid(o)) - 0.995)),
//   means'[i] = means[i] + R diag(s^2) R^T (e gate scaler),
// with sigmoid(x) = 1 / (1 + exp(-x)) as PyTorch computes it, expf, IEEE
// division and square root (no fast math), in the plain chain's order where
// that is free. The covariance is never formed: the step is M (M^T v) with
// M = R diag(s) and v = e gate scaler, in registers.
//
// What bounds it on the H100: bytes. A row reads means 12 B, quats 16,
// log-scales 12, the opacity logit 4, the noise 12 and the mask 1, and
// writes 12 B of means: 69 B, or 69 MB at 1M rows, 0.021 ms at 3.35 TB/s;
// some 60 operations a row are far below the card's balance point.
//
// Design: one thread a row, kThreads rows a block. The three arrays of 12-byte
// rows (means, log-scales, noise) are staged through shared memory: the
// block's threads move each one's 3 kThreads floats as 16-byte loads,
// neighbouring threads on neighbouring addresses, and each thread takes its
// own row from there (a stride of 3 words: no bank conflict); the new means
// go back the same way. The quaternion is one 16-byte load a thread, the
// logit and the mask one word and one byte. A block that is not whole (the
// last), or arrays off a 16-byte boundary (a sharded block's slice), take
// the scalar path, a float at a time.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;               // rows a block
constexpr int kVec = 3 * kThreads / 4;      // float4s of a block's 12-byte rows

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// the new means of one active row
__device__ __forceinline__ void noise_row(const float m[3], float4 q, const float l[3],
                                          float logit, const float e[3], float scaler,
                                          float out[3]) {
  // quat_normalize: q / max(|q|, 1e-12)
  const float norm = fmaxf(sqrtf(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w), 1e-12f);
  const float w = q.x / norm, x = q.y / norm, y = q.z / norm, z = q.w / norm;
  // quat_to_rotmat_comps, row-major
  const float R[3][3] = {
      {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - w * z), 2.0f * (x * z + w * y)},
      {2.0f * (x * y + w * z), 1.0f - 2.0f * (x * x + z * z), 2.0f * (y * z - w * x)},
      {2.0f * (x * z - w * y), 2.0f * (y * z + w * x), 1.0f - 2.0f * (x * x + y * y)},
  };
  const float s[3] = {expf(l[0]), expf(l[1]), expf(l[2])};
  const float gate = sigmoid(100.0f * ((1.0f - sigmoid(logit)) - 0.995f));
  float v[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) v[j] = e[j] * gate * scaler;
  // u = M^T v = diag(s) R^T v; step = M u = R diag(s) u
  float u[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) u[j] = s[j] * (R[0][j] * v[0] + R[1][j] * v[1] + R[2][j] * v[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i] = m[i] + (R[i][0] * (s[0] * u[0]) + R[i][1] * (s[1] * u[1]) + R[i][2] * (s[2] * u[2]));
  }
}

__global__ void __launch_bounds__(kThreads)
    mcmc_noise_kernel(const float* __restrict__ means, const float* __restrict__ quats,
                      const float* __restrict__ log_scales, const float* __restrict__ logits,
                      const float* __restrict__ noise, const uint8_t* __restrict__ active,
                      float* __restrict__ out, int64_t n, float scaler, int vec) {
  __shared__ float4 s_means[kVec], s_scales[kVec], s_noise[kVec];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t row = row0 + threadIdx.x;
  const int t = threadIdx.x;
  const bool whole = vec && row0 + kThreads <= n;  // the same for every thread of the block
  float m[3], l[3], e[3];
  if (whole) {
    const float4* gm = reinterpret_cast<const float4*>(means + 3 * row0);
    const float4* gl = reinterpret_cast<const float4*>(log_scales + 3 * row0);
    const float4* ge = reinterpret_cast<const float4*>(noise + 3 * row0);
    for (int k = t; k < kVec; k += kThreads) {
      s_means[k] = __ldg(gm + k);
      s_scales[k] = __ldg(gl + k);
      s_noise[k] = __ldg(ge + k);
    }
    __syncthreads();
    const float* fm = reinterpret_cast<const float*>(s_means) + 3 * t;
    const float* fl = reinterpret_cast<const float*>(s_scales) + 3 * t;
    const float* fe = reinterpret_cast<const float*>(s_noise) + 3 * t;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      m[j] = fm[j];
      l[j] = fl[j];
      e[j] = fe[j];
    }
  } else if (row < n) {
#pragma unroll
    for (int j = 0; j < 3; ++j) m[j] = __ldg(means + 3 * row + j);
  }
  float o[3] = {0.0f, 0.0f, 0.0f};
  if (row < n) {
    o[0] = m[0];
    o[1] = m[1];
    o[2] = m[2];
    if (active == nullptr || __ldg(active + row) != 0) {
      float4 q;
      if (vec) {
        q = __ldg(reinterpret_cast<const float4*>(quats) + row);
      } else {
        q = make_float4(__ldg(quats + 4 * row), __ldg(quats + 4 * row + 1),
                        __ldg(quats + 4 * row + 2), __ldg(quats + 4 * row + 3));
      }
      if (!whole) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          l[j] = __ldg(log_scales + 3 * row + j);
          e[j] = __ldg(noise + 3 * row + j);
        }
      }
      noise_row(m, q, l, __ldg(logits + row), e, scaler, o);
    }
  }
  if (whole) {
    float* fo = reinterpret_cast<float*>(s_means) + 3 * t;  // this thread's own row
#pragma unroll
    for (int j = 0; j < 3; ++j) fo[j] = o[j];
    __syncthreads();
    float4* go = reinterpret_cast<float4*>(out + 3 * row0);
    for (int k = t; k < kVec; k += kThreads) go[k] = s_means[k];
  } else if (row < n) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[3 * row + j] = o[j];
  }
}

}  // namespace

// One launch over n rows: means, log_scales, noise and out [n, 3], quats
// [n, 4], logits [n] float32, all dense; `active` a byte a row, or null for
// every row active. Returns a cudaError_t (0 on success).
extern "C" int tdgs_mcmc_noise(const float* means, const float* quats, const float* log_scales,
                               const float* logits, const float* noise, const uint8_t* active,
                               float* out, int64_t n, float scaler, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t at = reinterpret_cast<uint64_t>(means) | reinterpret_cast<uint64_t>(quats) |
                      reinterpret_cast<uint64_t>(log_scales) |
                      reinterpret_cast<uint64_t>(noise) | reinterpret_cast<uint64_t>(out);
  const int vec = (at & 15u) == 0;
  mcmc_noise_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(means, quats, log_scales, logits,
                                                           noise, active, out, n, scaler, vec);
  return static_cast<int>(cudaGetLastError());
}
