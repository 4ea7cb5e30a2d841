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
//   - forward: one warp per output edge. e1 is sorted, so an edge's triplets
//     are one contiguous range; the warp finds its start with a 32-way
//     search (each round probes 32 evenly spaced points, so ~5 rounds cover
//     a million triplets), then its lanes walk the range 32 triplets at a
//     time with coalesced loads, keep LN partial sums in registers and end
//     with a fixed-order butterfly. No atomics: deterministic. An edge with
//     no triplets stores zeros; the padded edge's long tail is a longer loop.
//   - backward: one thread per triplet. d_basis is a streaming write; d_gate
//     scatters by the unsorted e2, with f32 atomicAdd into an output the
//     entry point zeroes first (cudaMemsetAsync on the same stream). Its
//     last bits change from run to run.
// The TPU version's windowed one-hot MXU gathers and scatters, bf16 hi/lo
// split, sequential grid and VMEM residency have no counterpart here.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream of the current device, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported LN).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr unsigned kFull = 0xffffffffu;

// First index in the sorted a[0, n) whose value is >= key, found by the
// whole warp (every lane gets the same answer). Each round probes 32 evenly
// spaced points of [lo, hi); the ballot of "a[p] < key" is a prefix of the
// lanes because a is sorted, and the boundary lies in the gap after the
// last lane that is below.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a, int n, int key,
                                                int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int stride = (hi - lo + 31) >> 5;
    const int p = lo + lane * stride;
    const bool below = p < hi && __ldg(a + p) < key;
    const int c = __popc(__ballot_sync(kFull, below));
    if (c == 0) {
      hi = lo;
    } else {
      hi = min(lo + c * stride, hi);
      lo = lo + (c - 1) * stride + 1;
    }
  }
  return lo;
}

template <int LN>
__global__ void __launch_bounds__(kBlock)
fused_triplet_gate_sum_kernel(const float* __restrict__ basis, const float* __restrict__ gate,
                              const int* __restrict__ e1, const int* __restrict__ e2,
                              float* __restrict__ out, int num_edges, int num_trip) {
  const int e = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= num_edges) return;  // the whole warp leaves together

  float acc[LN];
#pragma unroll
  for (int r = 0; r < LN; ++r) acc[r] = 0.f;
  for (int base = warp_lower_bound(e1, num_trip, e, lane); base < num_trip; base += 32) {
    const int t = base + lane;
    const bool mine = t < num_trip && __ldg(e1 + t) == e;
    if (mine) {
      const float* __restrict__ g = gate + __ldg(e2 + t);
#pragma unroll
      for (int r = 0; r < LN; ++r)
        acc[r] = fmaf(__ldg(basis + (size_t)r * num_trip + t), __ldg(g + (size_t)r * num_edges),
                      acc[r]);
    }
    if (!__all_sync(kFull, mine)) break;  // the range ends in this chunk
  }
  // Butterfly: every lane ends with the same full sums, in a fixed order.
#pragma unroll
  for (int r = 0; r < LN; ++r) {
    float v = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    acc[r] = v;
  }
#pragma unroll
  for (int r = 0; r < LN; ++r)
    if (r == lane) out[(size_t)r * num_edges + e] = acc[r];
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
void launch_fwd(const float* basis, const float* gate, const int* e1, const int* e2,
                float* out, int num_edges, int num_trip, cudaStream_t stream) {
  const long long threads = 32LL * num_edges;
  const int grid = (int)((threads + kBlock - 1) / kBlock);
  fused_triplet_gate_sum_kernel<LN><<<grid, kBlock, 0, stream>>>(basis, gate, e1, e2, out,
                                                                 num_edges, num_trip);
}

}  // namespace

// Supported LN = l_max * n_max: 1..16. The Python wrapper checks the same
// range (KERNEL_MAX_ROWS in ops/fused_triplet.py).
#define M3G_ROWS(X)                                                               \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) \
  X(16)
#define M3G_CASE_FWD(LN_) \
  case LN_: launch_fwd<LN_>(b, gt, i1, i2, o, num_edges, num_trip, s); break;

// fused_triplet_gate_sum(basis (rows, T), gate (rows, E), e1, e2) -> out (rows, E).
extern "C" int m3g_fused_triplet_gate_sum(const void* basis, const void* gate, const void* e1,
                                          const void* e2, void* out, int rows, int num_edges,
                                          int num_trip, void* stream) {
  const float* b = static_cast<const float*>(basis);
  const float* gt = static_cast<const float*>(gate);
  const int* i1 = static_cast<const int*>(e1);
  const int* i2 = static_cast<const int*>(e2);
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
