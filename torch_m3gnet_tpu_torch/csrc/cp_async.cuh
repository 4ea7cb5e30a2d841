// The cp.async helpers with which the sorted-owner sums stage their spans:
// factorized_stage.cu (q_scatter, B1), fused_triplet.cu (B4, B5) and
// owner_sum.cuh (B7, B8) include it. Internal linkage (an unnamed
// namespace), so that every source that includes it links into one library
// without clashing symbols.

#pragma once

#include <cuda_runtime.h>

namespace {

// Asynchronous global -> shared copies (cp.async, sm_80 and later): they
// take no registers, so a thread can keep all of its staging loads in
// flight. cp_async16 needs both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// Waits for this thread's copies; a __syncthreads() must follow before
// other threads read them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// For a pipeline of staged tiles: close this thread's copies issued since
// the last commit into one group, and wait until at most Pending of its
// groups are still in flight (the newest ones). As above, a __syncthreads()
// must follow before other threads read the copies.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

}  // namespace
