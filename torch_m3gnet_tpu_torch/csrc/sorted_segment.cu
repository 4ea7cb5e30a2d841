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
// What bounds it: memory. It moves (F*M + S + 1 + F*S) * 4 bytes and does
// F*M adds. At the bench point the node aggregation (F = 64, M = 147,456,
// S = 3,584) moves 38.7 MB and the gather-mode triplet->edge sum (F = 9,
// M = 1,057,792, S = 147,456) 44.0 MB.
//
// What the design does about it: no atomics and a fixed summation order, so
// two calls on the same inputs give the same bits (index_add does not).
//   1. The caller passes seg's run offsets (S + 1,): offsets[s] = the first
//      m with seg[m] >= s, so segment s owns [offsets[s], offsets[s+1]) and
//      no thread searches. They are a property of the batch, built once per
//      batch on the device (data.to_torch for edge_src and triplet_e1,
//      Potential.assemble for the strain stress's edge_graph), so the
//      kernel reads neither seg nor a pass of its own.
//   2. The sums, chosen from the shapes only (so the same call always takes
//      the same path):
//      - segment_sum_tiled<R>: one block per (R rows, sb consecutive
//        segments), one thread per segment summing its run in all R rows
//        (R <= 4); its body, owner_sum_tiled (owner_sum.cuh), is shared
//        with windowed_scatter_fm (B7).
//        The segments' runs are one contiguous span of each row, which the
//        block streams through two shared-memory buffers of kOwnerStage
//        floats (R rows x kOwnerStage / R entries) with 16-byte cp.async copies where
//        the rows and the pointer are 16-byte aligned (scalar copies
//        otherwise): chunk k + 1 is in flight while chunk k is summed, and
//        no registers hold the loads. Each thread adds its run's part of a
//        chunk, in order, into R chunk partials that it adds to R sums
//        carried across chunks. The offsets and span ends are read once for
//        R rows. R and sb come from (F, S), with F the rows of one member
//        where a committee folds K members' rows into one call (so each
//        member is summed in the order of its own call, and the grid has
//        K times the blocks): the largest divisor R <= 4 of F
//        whose grid (sb = 256) has kFullBlocks (four blocks per SM of an
//        H100), else R = 1 with sb halved (down to 64) until the grid has
//        one block per SM. So the node aggregation (F = 64, S = 3,584) runs
//        R = 1, 896 blocks; the gather-mode triplet->edge sum (F = 9,
//        S = 147,456) R = 3, 1,728 blocks; the forces (F = 3) R = 1 with 64
//        segments a block, 168 blocks (one row of 256 segments a block gave
//        42 there). On an H100, more rows a block (R = 2 and 4 at F = 64,
//        R = 9 at F = 9) were slower: fewer blocks, fewer bytes in flight.
//        The blocks run from the last segments down, so the block of the
//        padded tail's long run (the last node) starts first.
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
// given stream of the current device, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "owner_sum.cuh"

namespace {

constexpr int kBlock = 256;      // threads of segment_sum_block; most of segment_sum_tiled
constexpr int kLongRun = 256;    // mean run above which a block owns a run
constexpr int kMaxRows = 4;       // rows per tiled block at most
constexpr int kFullBlocks = 528;  // four blocks per SM of an H100 SXM (132 SMs)
constexpr int kMinBlocks = 132;   // one block per SM

// Block (blockIdx.x from the last segments down, blockIdx.y) owns segments
// [s0, s0 + blockDim.x) of rows [f0, f0 + R), one thread per segment
// (owner_sum.cuh).
template <int R>
__global__ void __launch_bounds__(kBlock)
segment_sum_tiled(const float* __restrict__ data, const int* __restrict__ offsets,
                  float* __restrict__ out, int rows, int m_len, int num_segments, bool vec) {
  owner_sum_tiled<R, false>(data, nullptr, offsets, out, rows, m_len, num_segments, vec);
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

// The tiled sum's (rows per block, segments per block) for F rows and S
// segments; see the file comment.
void tiled_shape(int rows, int num_segments, int* r_out, int* sb_out) {
  const long long groups = (num_segments + kBlock - 1) / kBlock;
  for (int r = min(rows, kMaxRows); r > 1; --r) {
    if (rows % r == 0 && (long long)(rows / r) * groups >= kFullBlocks) {
      *r_out = r;
      *sb_out = kBlock;
      return;
    }
  }
  int sb = kBlock;
  while (sb > 64 && (long long)rows * ((num_segments + sb - 1) / sb) < kMinBlocks) sb /= 2;
  *r_out = 1;
  *sb_out = sb;
}

// gridDim.y limit: more row blocks than this launch in slices of rows.
constexpr int kMaxGridY = 65535;

template <int R>
void launch_tiled(const float* x, const int* off, float* o, int rows, int m_len,
                  int num_segments, int sb, bool vec, cudaStream_t s) {
  // Slices of kMaxGridY * R rows start on a multiple of R, so every block
  // owns the same R rows as in one grid.
  for (int r0 = 0; r0 < rows; r0 += kMaxGridY * R) {
    const int n = min(rows - r0, kMaxGridY * R);
    const dim3 grid((num_segments + sb - 1) / sb, (n + R - 1) / R);
    segment_sum_tiled<R><<<grid, sb, 0, s>>>(x + (size_t)r0 * m_len, off,
                                             o + (size_t)r0 * num_segments, n, m_len,
                                             num_segments, vec);
  }
}

}  // namespace

#define M3G_SEG_ROWS(X) X(1) X(2) X(3) X(4)
#define M3G_CASE_TILED(R_) \
  case R_: launch_tiled<R_>(x, off, o, rows, m_len, num_segments, sb, vec, s); break;

// sorted_segment_sum(data (rows, m_len)) -> out (rows, num_segments), by
// the run offsets (num_segments + 1,) int32 of the sorted segment ids.
// Every output element is written, empty segments with 0.
// tile_rows divides rows: the rows of one member when several members'
// rows are folded into one call (a committee). The tiled sum picks its
// shape for tile_rows, so that a block never straddles two members and
// each member is summed in the order of a call with tile_rows rows.
extern "C" int m3g_sorted_segment_sum(const void* data, const void* offsets, void* out, int rows,
                                      int m_len, int num_segments, int tile_rows, void* stream) {
  if (rows <= 0 || num_segments <= 0 || m_len < 0 || tile_rows <= 0 || rows % tile_rows != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(data);
  const int* off = static_cast<const int*>(offsets);
  float* o = static_cast<float*>(out);
  if (m_len / num_segments > kLongRun) {
    for (int r0 = 0; r0 < rows; r0 += kMaxGridY)
      segment_sum_block<<<dim3(num_segments, min(rows - r0, kMaxGridY)), kBlock, 0, s>>>(
          x + (size_t)r0 * m_len, off, o + (size_t)r0 * num_segments, m_len, num_segments);
  } else {
    int r = 1, sb = kBlock;
    tiled_shape(tile_rows, num_segments, &r, &sb);
    const bool vec = m_len % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    switch (r) {
      M3G_SEG_ROWS(M3G_CASE_TILED)
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
