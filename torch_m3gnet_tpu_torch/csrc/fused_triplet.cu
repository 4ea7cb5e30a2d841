// Hopper (sm_90a) kernels for the fused three-body message stage and its VJP.
//
// Replaces the Pallas TPU kernels of torch_m3gnet_tpu/ops/pallas_fused_triplet.py:
//   m3g_fused_triplet_gate_sum <- fused_triplet_gate_sum (_forward, pallas_call
//                                 at :352 resident, :381 windowed)
//       out[:, e] = sum_{t: e1[t]=e} basis[:, t] * gate[:, e2[t]]
//   m3g_backward_pair          <- backward_pair (_backward, pallas_call at
//                                 :476 resident, :513 windowed)
//       d_basis[:, t] = g[:, e1[t]] * gate[:, e2[t]]
//       d_gate[:, e]  = sum_{t: e2[t]=e} g[:, e1[t]] * basis[:, t]
// basis and d_basis are (LN, T), gate, g, out and d_gate (LN, E): f32,
// row-major, entity axis contiguous. e1 (T,) is int32, sorted ascending, in
// [0, E); e2 (T,) is int32 in [0, E), unsorted. Padded triplets carry zero
// basis and point e1 at the last (padded) edge, which therefore owns a long
// run of them.
//
// What bounds them: memory. The forward does 2*LN*T flops against
// (LN*T + 2*T + 2*LN*E) * 4 bytes, the backward 3*LN*T flops against
// (2*LN*T + 2*T + 3*LN*E) * 4 bytes: at the bench point (LN = 9,
// E = 147,456, T = 1,057,792) 57 MB and 101 MB against 19 and 29 MFLOP,
// well under one flop per byte.
//
// What the design does about it: the T-scale message basis * gate[e2] never
// touches device memory, and every T-scale array is read or written with
// coalesced accesses along t. The gate[:, e2[t]] reads, and in the backward
// the g[:, e1[t]] reads and the d_gate adds, fall in a short window of
// columns (both edges of a triplet share a source node and edges are sorted
// by source), so L1/L2 serve them.
//   - forward: the sorted-owner sum of B8 with the gate product fused into
//     the staging. The offsets pass of segment_offsets.cuh turns the sorted
//     e1 into each edge's triplet range [off[e], off[e+1]), so nothing
//     searches e1 and e1 is read by that pass only. One block owns
//     kFwdEdges = 256 consecutive edges, one thread each (576 blocks at the
//     bench point: one wave). Their triplets are one contiguous span, which
//     the block streams in chunks of kFwdStage / (LN + 1) triplets: e2 and
//     the LN rows of basis are copied to shared memory with cp.async (16
//     bytes a copy where rows and pointers are 16-byte aligned; no
//     registers held, so every copy of a chunk is in flight at once), then
//     each row is multiplied in place by gate[:, e2[t]] from L1/L2. Each
//     thread then sums its edge's run of the chunk in triplet order into
//     LN chunk partials that it adds to LN sums carried across chunks: no
//     atomics and a fixed order, so two calls give the same bits. An edge
//     with no triplet costs one comparison of two offsets; the padded
//     edge's long run is just more chunks, and its block (the blocks run
//     from the last edge down) starts first.
//   - backward: one thread per triplet. d_basis is a streaming write; d_gate
//     scatters by the unsorted e2, with f32 atomicAdd into an output the
//     entry point zeroes first (cudaMemsetAsync on the same stream). Its
//     last bits change from run to run.
// The TPU version's windowed one-hot MXU gathers and scatters, bf16 hi/lo
// split, sequential grid and VMEM residency have no counterpart here.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream of the current device, allocates nothing (the forward takes
// an (E + 1,) int32 scratch for the offsets), and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported LN).

#include <cuda_runtime.h>

#include <cstdint>

#include "segment_offsets.cuh"

namespace {

constexpr int kBlock = 256;       // threads per block of the backward
constexpr int kFwdEdges = 256;    // edges (threads) per block of the forward
constexpr int kFwdStage = 8192;   // 4-byte words staged per forward chunk (32 KB)

// The forward after the offsets pass. Block b owns edges [e0, e0 + kFwdEdges)
// with e0 counted from the last edge down, so that the block of the padded
// edge (its long run) starts first and overlaps the rest. Shared memory
// holds a chunk of the block's triplet span: e2 and the LN rows of basis,
// each row then multiplied in place by the gathered gate row.
template <int LN>
__global__ void __launch_bounds__(kFwdEdges)
fused_triplet_gate_sum_kernel(const float* __restrict__ basis, const float* __restrict__ gate,
                              const int* __restrict__ offsets, const int* __restrict__ e2,
                              float* __restrict__ out, int num_edges, int num_trip, bool vec) {
  // Triplets per chunk: a multiple of 32, so that every staged row starts
  // 16-byte aligned.
  constexpr int kChunk = (kFwdStage / (LN + 1)) & ~31;
  __shared__ __align__(16) int k_s[kChunk];
  __shared__ __align__(16) float prod[LN * kChunk];
  const int e0 = (gridDim.x - 1 - blockIdx.x) * kFwdEdges;
  const int e = e0 + threadIdx.x;
  const bool live = e < num_edges;
  const int span_begin = __ldg(offsets + e0);
  const int span_end = __ldg(offsets + min(e0 + kFwdEdges, num_edges));
  const int begin = live ? __ldg(offsets + e) : 0;
  const int end = live ? __ldg(offsets + e + 1) : 0;

  float acc[LN];
#pragma unroll
  for (int r = 0; r < LN; ++r) acc[r] = 0.f;
  // With vec, chunks start on a multiple of 4 triplets, so that every staged
  // quad is one aligned 16-byte copy; the triplets outside the span that
  // this pulls in are never summed.
  const int first = vec ? (span_begin & ~3) : span_begin;
  for (int c0 = first; c0 < span_end; c0 += kChunk) {
    const int c1 = min(c0 + kChunk, span_end);
    const int width = vec ? (c1 - c0 + 3) & ~3 : c1 - c0;
    __syncthreads();  // the previous chunk is consumed
    // Item i is staged row i / (kChunk / 4) (row 0 is e2, row 1 + r is
    // basis row r), quad i % (kChunk / 4); without vec, 4 single words.
#pragma unroll
    for (int i = threadIdx.x; i < (LN + 1) * (kChunk / 4); i += kFwdEdges) {
      const int row = i / (kChunk / 4), q = i % (kChunk / 4);
      const void* src = row == 0 ? static_cast<const void*>(e2 + c0)
                                 : static_cast<const void*>(basis + (size_t)(row - 1) * num_trip + c0);
      void* dst = row == 0 ? static_cast<void*>(k_s) : static_cast<void*>(prod + (row - 1) * kChunk);
      if (vec) {
        if (4 * q < width)
          cp_async16(static_cast<char*>(dst) + 16 * q, static_cast<const char*>(src) + 16 * q);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * q + u < width)
            cp_async4(static_cast<char*>(dst) + 4 * (4 * q + u),
                      static_cast<const char*>(src) + 4 * (4 * q + u));
      }
    }
    cp_async_wait_all();
    __syncthreads();
    for (int i = threadIdx.x; i < width; i += kFwdEdges) {
      const float* g = gate + k_s[i];
#pragma unroll
      for (int r = 0; r < LN; ++r) prod[r * kChunk + i] *= __ldg(g + (size_t)r * num_edges);
    }
    __syncthreads();
    const int lo = max(begin, c0) - c0, hi = min(end, c1) - c0;
    if (lo < hi) {
      float part[LN];
#pragma unroll
      for (int r = 0; r < LN; ++r) part[r] = 0.f;
      for (int i = lo; i < hi; ++i) {
#pragma unroll
        for (int r = 0; r < LN; ++r) part[r] += prod[r * kChunk + i];
      }
#pragma unroll
      for (int r = 0; r < LN; ++r) acc[r] += part[r];
    }
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < LN; ++r) out[(size_t)r * num_edges + e] = acc[r];
  }
}

__global__ void __launch_bounds__(kBlock)
backward_pair_kernel(const float* __restrict__ basis, const float* __restrict__ gate,
                     const float* __restrict__ g, const int* __restrict__ e1,
                     const int* __restrict__ e2, float* __restrict__ d_basis,
                     float* __restrict__ d_gate, int rows, int num_edges, int num_trip) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_trip) return;
  const int a = __ldg(e1 + t);
  const int b = __ldg(e2 + t);
  for (int r = 0; r < rows; ++r) {
    const size_t row_e = (size_t)r * num_edges, row_t = (size_t)r * num_trip;
    const float gv = __ldg(g + row_e + a);
    d_basis[row_t + t] = gv * __ldg(gate + row_e + b);
    atomicAdd(d_gate + row_e + b, gv * __ldg(basis + row_t + t));
  }
}

template <int LN>
void launch_fwd(const float* basis, const float* gate, const int* e1, const int* e2, int* offsets,
                float* out, int num_edges, int num_trip, cudaStream_t stream) {
  launch_segment_offsets(e1, offsets, num_trip, num_edges, stream);
  const bool vec = num_trip % 4 == 0 && reinterpret_cast<uintptr_t>(basis) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(e2) % 16 == 0;
  const int grid = (num_edges + kFwdEdges - 1) / kFwdEdges;
  fused_triplet_gate_sum_kernel<LN><<<grid, kFwdEdges, 0, stream>>>(basis, gate, offsets, e2, out,
                                                                 num_edges, num_trip, vec);
}

}  // namespace

// Supported LN = l_max * n_max: 1..16. The Python wrapper checks the same
// range (KERNEL_MAX_ROWS in ops/fused_triplet.py).
#define M3G_ROWS(X)                                                               \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) \
  X(16)
#define M3G_CASE_FWD(LN_) \
  case LN_: launch_fwd<LN_>(b, gt, i1, i2, off, o, num_edges, num_trip, s); break;

// fused_triplet_gate_sum(basis (rows, T), gate (rows, E), e1, e2) -> out (rows,
// E); offsets is an (E + 1,) int32 scratch.
extern "C" int m3g_fused_triplet_gate_sum(const void* basis, const void* gate, const void* e1,
                                          const void* e2, void* offsets, void* out, int rows,
                                          int num_edges, int num_trip, void* stream) {
  const float* b = static_cast<const float*>(basis);
  const float* gt = static_cast<const float*>(gate);
  const int* i1 = static_cast<const int*>(e1);
  const int* i2 = static_cast<const int*>(e2);
  int* off = static_cast<int*>(offsets);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    M3G_ROWS(M3G_CASE_FWD)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// backward_pair(basis (rows, T), gate (rows, E), g (rows, E), e1, e2)
//   -> d_basis (rows, T), d_gate (rows, E), zeroed here before the adds.
extern "C" int m3g_backward_pair(const void* basis, const void* gate, const void* g,
                                 const void* e1, const void* e2, void* d_basis, void* d_gate,
                                 int rows, int num_edges, int num_trip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(d_gate, 0, sizeof(float) * (size_t)rows * num_edges, s);
  if (err != cudaSuccess) return (int)err;
  if (num_trip > 0) {
    const int grid = (num_trip + kBlock - 1) / kBlock;
    backward_pair_kernel<<<grid, kBlock, 0, s>>>(
        static_cast<const float*>(basis), static_cast<const float*>(gate),
        static_cast<const float*>(g), static_cast<const int*>(e1), static_cast<const int*>(e2),
        static_cast<float*>(d_basis), static_cast<float*>(d_gate), rows, num_edges, num_trip);
  }
  return (int)cudaGetLastError();
}
