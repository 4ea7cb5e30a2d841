// The offsets pass of the sorted-owner sums: sorted_segment.cu (B8),
// factorized_stage.cu (q_scatter, B1) and fused_triplet.cu
// (fused_triplet_gate_sum, B4) include it and run it before their sums.
// (backward_pair, B5, takes its offsets of the e2 order from the batch.)
//
// segment_offsets(seg, offsets, m_len, S): seg (m_len,) is int32, sorted
// ascending, with values in [0, S). For each boundary m in [0, m_len] (one
// or four consecutive ones per thread), offsets[s] = m is written for every
// s in (seg[m-1], seg[m]] (seg[-1] = -1, seg[m_len] = S), so offsets[s] is
// the first m with seg[m] >= s, each of the S + 1 offsets is written
// exactly once, offsets[S] = m_len, and no thread searches. Segment s owns
// the run [offsets[s], offsets[s+1]).
//
// The header also holds the cp.async helpers with which the sums stage
// their spans. Internal linkage (an unnamed namespace), so that every source
// that includes it links into one library without clashing symbols.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kOffsetsBlock = 256;

// Per consecutive boundaries a thread.
template <int Per>
__global__ void __launch_bounds__(kOffsetsBlock)
segment_offsets(const int* __restrict__ seg, int* __restrict__ offsets, int m_len,
                int num_segments) {
  const long long m0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * Per;
  if (m0 > m_len) return;
  int prev = m0 == 0 ? -1 : __ldg(seg + m0 - 1);
#pragma unroll
  for (int j = 0; j < Per; ++j) {
    const long long m = m0 + j;
    if (m > m_len) break;
    const int next = m == m_len ? num_segments : __ldg(seg + m);
    // Clamped so that ids outside [0, S) cannot write out of bounds.
    const int lo = max(prev + 1, 0), hi = min(next, num_segments);
    for (int s = lo; s <= hi; ++s) offsets[s] = (int)m;
    prev = next;
  }
}

template <int Per>
void launch_segment_offsets_per(const int* seg, int* offsets, int m_len, int num_segments,
                                cudaStream_t s) {
  const long long threads = ((long long)m_len + Per) / Per;
  segment_offsets<Per><<<(int)((threads + kOffsetsBlock - 1) / kOffsetsBlock), kOffsetsBlock, 0,
                         s>>>(seg, offsets, m_len, num_segments);
}

// Launches segment_offsets on stream s over the m_len + 1 boundaries: four
// a thread for a long index (the bench batch's 1,057,792 triplets), whose
// threads would otherwise be many and nearly idle, one a thread for a
// short one (its 147,456 edges), so that enough threads stay in flight.
inline void launch_segment_offsets(const int* seg, int* offsets, int m_len, int num_segments,
                                   cudaStream_t s) {
  if (m_len >= (1 << 19))
    launch_segment_offsets_per<4>(seg, offsets, m_len, num_segments, s);
  else
    launch_segment_offsets_per<1>(seg, offsets, m_len, num_segments, s);
}

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
