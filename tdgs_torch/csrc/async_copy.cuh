// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later), with which kernels 1, 2, 6, 7, 9 and 10 load their
// next batch of entries while the block walks the current one. A copy
// lands in shared memory once the thread that started it has waited for
// its group and the block has passed a barrier.
#pragma once

#include <cuda_runtime.h>

namespace tdgsasync {

// Starts the copy of one float (through L1: the batches' rows and
// gaussians are read by one block each).
__device__ __forceinline__ void copy_4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// Starts the copy of four floats; both addresses 16-byte aligned (past L1:
// a stream-order row is read by one block).
__device__ __forceinline__ void copy_16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// Closes the copies this thread started since the last commit into a group
// (an empty group when it started none).
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tdgsasync
