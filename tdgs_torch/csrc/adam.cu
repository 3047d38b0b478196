// Selective Adam without bias correction over every parameter group of the
// trainer, in one launch: SplatOptimizer.update's update.
//
// Replaces no TPU kernel. The JAX package's tdgs/ops/adam.py is plain jnp,
// and XLA fuses its moment update, its jnp.where masks and the step into one
// pass per leaf; PyTorch runs the same chain as some seventeen elementwise
// kernels a group, each writing its intermediate to device memory and
// reading it back. Semantics, per element i of a group with row width F:
//   row = i / F; if visibility is given and visibility[row] is 0, then
//   p' = p, m' = m, v' = v (bitwise copies; g is not read); else
//   m' = b1 m + (1 - b1) g, v' = b2 v + ((1 - b2) g) g,
//   p' = p + (-lr m') / (sqrt(v') + eps),
// each operation rounded on its own in that order (no fused multiply-add),
// as the plain PyTorch version in tdgs_torch/ops/adam.py rounds them. The
// gradient's rows may lie apart (a row stride above F: the SH groups'
// gradients are slices of the gradient of their concatenation), each row
// contiguous; the other six arrays are dense.
//
// What bounds it on the H100: bytes. A visible float reads p, g, m, v and
// writes p', m', v' (28 bytes), a masked one 24, and each row's mask is one
// byte: 1.65 GB for the 1M x 59 floats of a 3DGS state at SH degree 3, or
// 0.49 ms at 3.35 TB/s; a handful of operations a float is far below the
// card's balance point.
//
// Design: one pass, no intermediates, one launch for all groups (the
// multi-tensor pattern). The groups' pointers, sizes, widths and learning
// rates travel by value in the launch's parameters, so nothing is uploaded
// a step. Each block takes kChunk consecutive floats of one group: its
// threads move them as 16-byte loads and stores where the group's arrays
// are 16-byte aligned (scalar otherwise, and for a group's last partial
// float4), neighbouring threads on neighbouring addresses, and read the
// gradient only where some element of its float4 is visible (a float at a
// time where its rows lie apart). At 1M x 59 floats that is about 14,500
// blocks of 256 threads: every SM holds blocks enough to keep its loads in
// flight.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxGroups = 16;
constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;                          // float4s a thread
constexpr int64_t kChunk = 4LL * kThreads * kVecPerThread;  // floats a block

struct Group {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  float* p_out;
  float* m_out;
  float* v_out;
  int64_t n;         // floats
  int64_t block0;    // the group's first block
  int64_t g_stride;  // floats from one row of g to the next (width: dense)
  int width;         // floats a row
  float neg_lr;      // -lr
  int vec;           // p, m, v, the outputs and a dense g 16-byte aligned
};

struct Table {
  Group groups[kMaxGroups];
  int n_groups;
};

struct Coeffs {
  float b1, c1, b2, c2, eps;  // c1 = 1 - b1, c2 = 1 - b2, rounded from double
};

// one element: the plain version's operations in its order, each rounded
__device__ __forceinline__ void adam_one(float p, float g, float m, float v, float neg_lr,
                                         const Coeffs& k, float& p_o, float& m_o, float& v_o) {
  m_o = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.c1, g));
  v_o = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.c2, g), g));
  const float step = __fdiv_rn(__fmul_rn(neg_lr, m_o), __fadd_rn(__fsqrt_rn(v_o), k.eps));
  p_o = __fadd_rn(p, step);
}

// the row of float i of a group, as 32-bit division where it fits
__device__ __forceinline__ int64_t row_of(int64_t i, int width) {
  if (i < (int64_t{1} << 32)) {
    return static_cast<int64_t>(static_cast<uint32_t>(i) / static_cast<uint32_t>(width));
  }
  return i / width;
}

__global__ void __launch_bounds__(kThreads) adam_kernel(const Table table,
                                                        const uint8_t* __restrict__ visibility,
                                                        const Coeffs k) {
  // this block's group: the last whose first block is at or before it
  int gi = 0;
  for (int j = 1; j < table.n_groups; ++j) {
    if (static_cast<int64_t>(blockIdx.x) >= table.groups[j].block0) gi = j;
  }
  const Group G = table.groups[gi];  // a copy: never the address of a parameter
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) - G.block0) * kChunk;
  const int64_t c1 = c0 + kChunk < G.n ? c0 + kChunk : G.n;
  const float* __restrict__ P = G.p;
  const float* __restrict__ Gr = G.g;
  const float* __restrict__ M = G.m;
  const float* __restrict__ V = G.v;
  float* __restrict__ PO = G.p_out;
  float* __restrict__ MO = G.m_out;
  float* __restrict__ VO = G.v_out;
  const int width = G.width;
  const int64_t g_stride = G.g_stride;
  const bool dense_g = g_stride == width;
  const bool by_row = visibility != nullptr || !dense_g;  // rows needed
  const float neg_lr = G.neg_lr;

  // whole float4s of the chunk; with the scalar path, every float
  const int64_t n_vec = G.vec ? (c1 - c0) / 4 : 0;
#pragma unroll
  for (int u = 0; u < kVecPerThread; ++u) {
    const int64_t q = static_cast<int64_t>(u) * kThreads + threadIdx.x;
    if (q >= n_vec) break;
    const int64_t i = c0 + 4 * q;
    bool vis[4] = {true, true, true, true};
    int64_t at[4];  // each float's place in g where its rows lie apart
    bool any = true;
    if (by_row) {
      int64_t row = row_of(i, width);
      int rem = static_cast<int>(i - row * width);
      any = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        vis[j] = visibility == nullptr || __ldg(visibility + row) != 0;
        any = any || vis[j];
        at[j] = row * g_stride + rem;
        if (++rem == width) {
          rem = 0;
          ++row;
        }
      }
    }
    const float4 p = __ldg(reinterpret_cast<const float4*>(P + i));
    const float4 m = __ldg(reinterpret_cast<const float4*>(M + i));
    const float4 v = __ldg(reinterpret_cast<const float4*>(V + i));
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    if (any && dense_g) {
      g = __ldg(reinterpret_cast<const float4*>(Gr + i));
    } else if (any) {
      if (vis[0]) g.x = __ldg(Gr + at[0]);
      if (vis[1]) g.y = __ldg(Gr + at[1]);
      if (vis[2]) g.z = __ldg(Gr + at[2]);
      if (vis[3]) g.w = __ldg(Gr + at[3]);
    }
    float4 po = p, mo = m, vo = v;
    if (vis[0]) adam_one(p.x, g.x, m.x, v.x, neg_lr, k, po.x, mo.x, vo.x);
    if (vis[1]) adam_one(p.y, g.y, m.y, v.y, neg_lr, k, po.y, mo.y, vo.y);
    if (vis[2]) adam_one(p.z, g.z, m.z, v.z, neg_lr, k, po.z, mo.z, vo.z);
    if (vis[3]) adam_one(p.w, g.w, m.w, v.w, neg_lr, k, po.w, mo.w, vo.w);
    *reinterpret_cast<float4*>(PO + i) = po;
    *reinterpret_cast<float4*>(MO + i) = mo;
    *reinterpret_cast<float4*>(VO + i) = vo;
  }
  // the rest one float a thread: a vectorized group's tail of 1-3 floats,
  // or the whole chunk of a group that is not aligned
  for (int64_t i = c0 + 4 * n_vec + threadIdx.x; i < c1; i += kThreads) {
    const int64_t row = by_row ? row_of(i, width) : 0;
    const bool vis = visibility == nullptr || __ldg(visibility + row) != 0;
    const float p = P[i], m = M[i], v = V[i];
    float po = p, mo = m, vo = v;
    const int64_t at = dense_g ? i : row * g_stride + (i - row * width);
    if (vis) adam_one(p, Gr[at], m, v, neg_lr, k, po, mo, vo);
    PO[i] = po;
    MO[i] = mo;
    VO[i] = vo;
  }
}

}  // namespace

// One launch over n_groups <= 16 groups. `ptrs` holds seven pointers a
// group (p, g, m, v, p_out, m_out, v_out), `sizes` its floats, `widths` its
// floats a row, `g_strides` the floats from one row of its gradient to the
// next (its width where the gradient is dense), `lrs` its learning rate;
// `visibility` holds a byte a row, or is null for every row visible. c1 and
// c2 are 1 - b1 and 1 - b2 as the caller rounds them. Returns a cudaError_t
// (0 on success).
extern "C" int tdgs_adam(const uint64_t* ptrs, const int64_t* sizes, const int32_t* widths,
                         const int64_t* g_strides, const float* lrs, int n_groups,
                         const uint8_t* visibility, float b1, float c1, float b2, float c2,
                         float eps, void* stream) {
  if (n_groups < 0 || n_groups > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  Table table = {};
  int n = 0;
  int64_t blocks = 0;
  for (int j = 0; j < n_groups; ++j) {
    if (sizes[j] < 0 || (sizes[j] > 0 && (widths[j] <= 0 || g_strides[j] < widths[j]))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (sizes[j] == 0) continue;  // an empty group takes no block
    Group& G = table.groups[n++];
    const uint64_t* q = ptrs + 7 * j;
    G.p = reinterpret_cast<const float*>(q[0]);
    G.g = reinterpret_cast<const float*>(q[1]);
    G.m = reinterpret_cast<const float*>(q[2]);
    G.v = reinterpret_cast<const float*>(q[3]);
    G.p_out = reinterpret_cast<float*>(q[4]);
    G.m_out = reinterpret_cast<float*>(q[5]);
    G.v_out = reinterpret_cast<float*>(q[6]);
    G.n = sizes[j];
    G.block0 = blocks;
    G.g_stride = g_strides[j];
    G.width = widths[j];
    G.neg_lr = -lrs[j];
    const uint64_t g_at = g_strides[j] == widths[j] ? q[1] : 0;  // read a float at a time
    G.vec = ((q[0] | g_at | q[2] | q[3] | q[4] | q[5] | q[6]) & 15u) == 0;
    blocks += (sizes[j] + kChunk - 1) / kChunk;
  }
  table.n_groups = n;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const Coeffs k = {b1, c1, b2, c2, eps};
  adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(table, visibility, k);
  return static_cast<int>(cudaGetLastError());
}
