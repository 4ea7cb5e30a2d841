// Hopper (sm_90a) kernels for the factorized three-body stage of M3GNet.
//
// Replaces the Pallas TPU kernels of torch_m3gnet_tpu/ops/pallas_factorized_stage.py:
//   m3g_q_scatter  <- q_scatter (_q_impl, pallas_call at :230)
//       A[(m,n), i]   = sum_{e: src[e]=i} sh[m,e] * gm[(l_m,n), e]
//   m3g_r1_gather  <- r1_gather (_r_impl mode "r1", pallas_call at :340)
//       out[(l,n), e] = sum_{m: l_m=l} sh[m,e] * A[(m,n), src[e]]
//   m3g_r2_gather  <- r2_gather (_r_impl mode "r2", pallas_call at :340)
//       out[m, e]     = sum_n gm[(l_m,n), e] * A[(m,n), src[e]]
// with M = l_max^2 harmonic rows grouped by degree (rows l^2 .. (l+1)^2-1
// have degree l), LN = l_max*n_max rows in gm and in r1's output, and
// MN = M*n_max rows in A. All arrays are f32, row-major, with the entity
// axis (edges E or nodes N) contiguous: sh (M, E), gm (LN, E), A (MN, N).
// src (E,) is int32 and sorted ascending (padded edges point at the last
// node).
//
// What bounds them: memory. Each does 2*MN*E flops (8 MFLOP at the bench
// point, E = 147,456) against about 11.6 MB of compulsory traffic: under one
// flop per byte, far below the card's f32 balance point (~20 flop/byte).
//
// What the design does about it: every compulsory byte is read once, loads
// and stores are coalesced, and nothing else touches device memory.
//   - r1/r2: one thread per edge, edges on the fast axis, so a warp's loads
//     of a row of sh/gm and its stores of a row of out are 128-byte
//     coalesced. The A[:, src[e]] reads are near-broadcasts (neighbouring
//     edges share a source node) and are served by L1/L2. The MN-wide
//     per-edge product lives in registers only.
//   - q_scatter: one warp per node. Edges are sorted by source, so a node's
//     edges are one contiguous range, found by binary search on src. Lanes
//     stride over that range with coalesced loads, keep the MN partial sums
//     in registers and finish with a fixed-order butterfly reduction: no
//     atomics, so the result is deterministic. A node with no edges gets
//     zeros; the last node's long padded tail is just a longer loop.
// The TPU version's windowed one-hot MXU matmuls, bf16 hi/lo split and
// VMEM-resident accumulator exist for the TPU only and have no counterpart
// here; A lives in device memory, so there is no node-count cap.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream of the current device, allocates nothing, and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported
// (l_max, n_max)).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

// First index in the sorted a[0, n) whose value is >= key.
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n, int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Loops below run over degree l and, inside it, over the components
// m = l^2 .. (l+1)^2 - 1 of that degree, so that after unrolling every
// register-array index is a compile-time constant.

template <int L, int NM>
__global__ void __launch_bounds__(kBlock)
q_scatter_kernel(const float* __restrict__ sh, const float* __restrict__ gm,
                 const int* __restrict__ src, float* __restrict__ out,
                 int num_edges, int num_nodes) {
  constexpr int M = L * L;
  constexpr int LN = L * NM;
  constexpr int MN = M * NM;
  const int node = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;  // one warp per node
  const int lane = threadIdx.x & 31;
  if (node >= num_nodes) return;  // the whole warp leaves together
  const int begin = lower_bound(src, num_edges, node);
  const int end = lower_bound(src, num_edges, node + 1);

  float acc[MN];
#pragma unroll
  for (int r = 0; r < MN; ++r) acc[r] = 0.f;
  for (int e = begin + lane; e < end; e += 32) {
    float g[LN];
#pragma unroll
    for (int j = 0; j < LN; ++j) g[j] = __ldg(gm + (size_t)j * num_edges + e);
#pragma unroll
    for (int l = 0; l < L; ++l) {
#pragma unroll
      for (int m = l * l; m < (l + 1) * (l + 1); ++m) {
        const float s = __ldg(sh + (size_t)m * num_edges + e);
#pragma unroll
        for (int n = 0; n < NM; ++n)
          acc[m * NM + n] = fmaf(s, g[l * NM + n], acc[m * NM + n]);
      }
    }
  }
  // Butterfly: every lane ends with the same full sums, in a fixed order.
#pragma unroll
  for (int r = 0; r < MN; ++r) {
    float v = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    acc[r] = v;
  }
  // Lane r % 32 stores row r (MN <= 64 rows, so at most two rounds).
#pragma unroll
  for (int r = 0; r < MN; ++r)
    if ((r & 31) == lane) out[(size_t)r * num_nodes + node] = acc[r];
}

template <int L, int NM>
__global__ void __launch_bounds__(kBlock)
r1_gather_kernel(const float* __restrict__ a, const float* __restrict__ sh,
                 const int* __restrict__ src, float* __restrict__ out,
                 int num_edges, int num_nodes) {
  constexpr int M = L * L;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_edges) return;
  const float* __restrict__ a_i = a + __ldg(src + e);
  float s[M];
#pragma unroll
  for (int m = 0; m < M; ++m) s[m] = __ldg(sh + (size_t)m * num_edges + e);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float acc[NM];
#pragma unroll
    for (int n = 0; n < NM; ++n) acc[n] = 0.f;
#pragma unroll
    for (int m = l * l; m < (l + 1) * (l + 1); ++m) {
#pragma unroll
      for (int n = 0; n < NM; ++n)
        acc[n] = fmaf(s[m], __ldg(a_i + (size_t)(m * NM + n) * num_nodes), acc[n]);
    }
#pragma unroll
    for (int n = 0; n < NM; ++n) out[(size_t)(l * NM + n) * num_edges + e] = acc[n];
  }
}

template <int L, int NM>
__global__ void __launch_bounds__(kBlock)
r2_gather_kernel(const float* __restrict__ a, const float* __restrict__ gm,
                 const int* __restrict__ src, float* __restrict__ out,
                 int num_edges, int num_nodes) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_edges) return;
  const float* __restrict__ a_i = a + __ldg(src + e);
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float g[NM];
#pragma unroll
    for (int n = 0; n < NM; ++n) g[n] = __ldg(gm + (size_t)(l * NM + n) * num_edges + e);
#pragma unroll
    for (int m = l * l; m < (l + 1) * (l + 1); ++m) {
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NM; ++n)
        acc = fmaf(g[n], __ldg(a_i + (size_t)(m * NM + n) * num_nodes), acc);
      out[(size_t)m * num_edges + e] = acc;
    }
  }
}

template <int L, int NM>
void launch_q(const float* sh, const float* gm, const int* src, float* out,
              int num_edges, int num_nodes, cudaStream_t stream) {
  const long long threads = 32LL * num_nodes;
  const int grid = (int)((threads + kBlock - 1) / kBlock);
  q_scatter_kernel<L, NM><<<grid, kBlock, 0, stream>>>(sh, gm, src, out, num_edges, num_nodes);
}

template <int L, int NM>
void launch_r1(const float* a, const float* sh, const int* src, float* out,
               int num_edges, int num_nodes, cudaStream_t stream) {
  const int grid = (num_edges + kBlock - 1) / kBlock;
  r1_gather_kernel<L, NM><<<grid, kBlock, 0, stream>>>(a, sh, src, out, num_edges, num_nodes);
}

template <int L, int NM>
void launch_r2(const float* a, const float* gm, const int* src, float* out,
               int num_edges, int num_nodes, cudaStream_t stream) {
  const int grid = (num_edges + kBlock - 1) / kBlock;
  r2_gather_kernel<L, NM><<<grid, kBlock, 0, stream>>>(a, gm, src, out, num_edges, num_nodes);
}

}  // namespace

// Supported (l_max, n_max): 1..4 each. The Python wrapper checks the same
// range (KERNEL_MAX_L, KERNEL_MAX_N in ops/factorized_stage.py).
#define M3G_CASES(X) \
  X(1, 1) X(1, 2) X(1, 3) X(1, 4) X(2, 1) X(2, 2) X(2, 3) X(2, 4) \
  X(3, 1) X(3, 2) X(3, 3) X(3, 4) X(4, 1) X(4, 2) X(4, 3) X(4, 4)

#define M3G_CASE_q(L_, N_) \
  case L_ * 8 + N_: launch_q<L_, N_>(x, y, idx, o, num_edges, num_nodes, s); break;
#define M3G_CASE_r1(L_, N_) \
  case L_ * 8 + N_: launch_r1<L_, N_>(x, y, idx, o, num_edges, num_nodes, s); break;
#define M3G_CASE_r2(L_, N_) \
  case L_ * 8 + N_: launch_r2<L_, N_>(x, y, idx, o, num_edges, num_nodes, s); break;

#define M3G_ENTRY(NAME, LAUNCH)                                                 \
  extern "C" int NAME(const void* in0, const void* in1, const void* src,       \
                      void* out, int num_edges, int num_nodes, int l_max,       \
                      int n_max, void* stream) {                                \
    const float* x = static_cast<const float*>(in0);                            \
    const float* y = static_cast<const float*>(in1);                            \
    const int* idx = static_cast<const int*>(src);                              \
    float* o = static_cast<float*>(out);                                        \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                         \
    switch (l_max * 8 + n_max) {                                                \
      M3G_CASES(M3G_CASE_##LAUNCH)                                              \
      default:                                                                  \
        return (int)cudaErrorInvalidValue;                                      \
    }                                                                           \
    return (int)cudaGetLastError();                                             \
  }

// q_scatter(sh, gm, src) -> A (MN, num_nodes); in0 = sh, in1 = gm.
M3G_ENTRY(m3g_q_scatter, q)
// r1_gather(A, sh, src) -> out (LN, num_edges); in0 = A, in1 = sh.
M3G_ENTRY(m3g_r1_gather, r1)
// r2_gather(A, gm, src) -> out (M, num_edges); in0 = A, in1 = gm.
M3G_ENTRY(m3g_r2_gather, r2)
