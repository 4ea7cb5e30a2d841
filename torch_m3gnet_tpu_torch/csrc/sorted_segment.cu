// Hopper (sm_90a) kernel for the segment sum over sorted segment ids.
//
// Replaces the Pallas TPU kernels of torch_m3gnet_tpu/ops/pallas_segment.py:
//   m3g_sorted_segment_sum <- sorted_segment_sum (_forward, pallas_call at :129)
//                             and sorted_segment_sum_any (_forward_t,
//                             pallas_call at :252), one function:
//       out[f, s] = sum_{m: seg[m]=s} data[f, m]        (F, M) -> (F, S)
// All arrays are f32, row-major, with the entity axis (M or S) contiguous:
// the port's feature-major layout, which is what sorted_segment_sum_any's
// transposed (F, E) buffer gives the TPU. seg (M,) is int32, sorted
// ascending, with values in [0, S).
//
// What bounds it: memory. It moves (F*M + M + F*S) * 4 bytes and does F*M
// adds. At the bench point the node aggregation (F = 64, M = 147,456,
// S = 3,584) moves 39.3 MB and the gather-mode triplet->edge sum (F = 9,
// M = 1,057,792, S = 147,456) 47.6 MB.
//
// What the design does about it: no atomics and a fixed summation order, so
// two calls on the same inputs give the same bits (index_add does not).
//   1. segment_offsets (segment_offsets.cuh, shared with q_scatter and
//      fused_triplet_gate_sum): each boundary m in [0, M] writes offsets[s]
//      = first m with seg[m] >= s for every s in (seg[m-1], seg[m]], so
//      each of the S + 1 offsets is written exactly once and no thread
//      searches.
//   2. The sums, chosen by the mean run length M / S (a function of the
//      shapes only, so the same call always takes the same path):
//      - segment_sum_tiled: one block per (row, 256 consecutive segments).
//        Their runs are one contiguous span of the row, which the block
//        stages through shared memory in 8,192-float tiles with coalesced
//        loads; then each thread sums its own segment's part of the tile,
//        in order, into four partial sums combined in a fixed order. A long
//        run (the last node owns the padded edges) is one thread's longer
//        loop.
//      - segment_sum_block: for runs longer than kLongRun (the strain
//        stress sums ~4,600 edges into each of 32 graphs), one block of 256
//        threads per (segment, row), so the grid still fills the card:
//        a strided per-thread sum, a warp butterfly, then warp 0's
//        fixed-order sum of the eight warp partials.
// The TPU version's one-hot MXU contraction over 512-segment windows, its
// bf16 hi/lo split and its sequential read-modify-write of the output have
// no counterpart here: every output element is written once, by one owner.
//
// Interface: plain C, loaded with ctypes. The entry point launches on the
// given stream of the current device, allocates nothing (the caller passes
// an (S + 1,) int32 scratch for the offsets), and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "segment_offsets.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 8192;    // floats of a row staged per tile (32 KB)
constexpr int kLongRun = 256;  // mean run above which a block owns a run

__global__ void __launch_bounds__(kBlock)
segment_sum_tiled(const float* __restrict__ data, const int* __restrict__ offsets,
                  float* __restrict__ out, int m_len, int num_segments) {
  __shared__ float tile[kTile];
  const int f = blockIdx.y;
  const int s0 = blockIdx.x * kBlock;
  const int s = s0 + threadIdx.x;
  const bool live = s < num_segments;
  const int span_begin = __ldg(offsets + s0);
  const int span_end = __ldg(offsets + min(s0 + kBlock, num_segments));
  const int begin = live ? __ldg(offsets + s) : 0;
  const int end = live ? __ldg(offsets + s + 1) : 0;
  const float* __restrict__ row = data + (size_t)f * m_len;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = span_begin; t0 < span_end; t0 += kTile) {
    const int t1 = min(t0 + kTile, span_end);
    __syncthreads();  // the previous tile is consumed
#pragma unroll 8
    for (int i = t0 + threadIdx.x; i < t1; i += kBlock) tile[i - t0] = __ldg(row + i);
    __syncthreads();
    const int lo = max(begin, t0), hi = min(end, t1);
    int i = lo;
    for (; i + 3 < hi; i += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] += tile[i + k - t0];
    }
    for (; i < hi; ++i) acc[0] += tile[i - t0];
  }
  if (live) out[(size_t)f * num_segments + s] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

__global__ void __launch_bounds__(kBlock)
segment_sum_block(const float* __restrict__ data, const int* __restrict__ offsets,
                  float* __restrict__ out, int m_len, int num_segments) {
  __shared__ float partial[kBlock / 32];
  const int s = blockIdx.x, f = blockIdx.y;
  const int begin = __ldg(offsets + s), end = __ldg(offsets + s + 1);
  const float* __restrict__ row = data + (size_t)f * m_len;
  float acc = 0.f;
#pragma unroll 4
  for (int m = begin + threadIdx.x; m < end; m += kBlock) acc += __ldg(row + m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kBlock / 32; ++w) total += partial[w];
    out[(size_t)f * num_segments + s] = total;
  }
}

}  // namespace

// sorted_segment_sum(data (rows, m_len), seg (m_len,)) -> out (rows,
// num_segments); offsets is an (num_segments + 1,) int32 scratch. Every
// output element is written, empty segments with 0.
extern "C" int m3g_sorted_segment_sum(const void* data, const void* seg, void* offsets,
                                      void* out, int rows, int m_len, int num_segments,
                                      void* stream) {
  if (rows <= 0 || num_segments <= 0 || m_len < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(data);
  int* off = static_cast<int*>(offsets);
  float* o = static_cast<float*>(out);
  launch_segment_offsets(static_cast<const int*>(seg), off, m_len, num_segments, s);
  if (m_len / num_segments > kLongRun) {
    segment_sum_block<<<dim3(num_segments, rows), kBlock, 0, s>>>(x, off, o, m_len,
                                                                 num_segments);
  } else {
    const int groups = (num_segments + kBlock - 1) / kBlock;
    segment_sum_tiled<<<dim3(groups, rows), kBlock, 0, s>>>(x, off, o, m_len, num_segments);
  }
  return (int)cudaGetLastError();
}
