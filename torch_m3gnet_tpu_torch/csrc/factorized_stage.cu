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
//     coalesced. The A[:, src[e]] reads are near-broadcasts (about 41 edges
//     share a source node at the bench point) and are served by L1/L2. The
//     MN-wide per-edge product lives in registers only. At the bench point
//     the whole grid is resident at once, so what sets the time is how many
//     independent load chains are in flight, not the width of each access.
//     On an NVIDIA H100 (80GB HBM3, 700 W) this kernel comes within about
//     1 us of a plain copy of its operand to its output timed in the same
//     process. Tiles of four edges a thread with 16-byte accesses and the
//     node window A[:, lo..hi] staged in shared memory once per block (or
//     per warp) hold a quarter of the chains and add a copy and a barrier
//     to each: up to 2 us slower (PERF.md and CHANGES.md keep the
//     numbers).
//   - q_scatter: the sorted-owner sum. It takes each node's edge range
//     [off[i], off[i+1]) from the batch's offsets of src (built once per
//     batch by data.to_torch), so nothing searches src and the kernel does
//     not read it. One block owns kQNodes = 4
//     consecutive nodes (896 blocks of ~165 edges at the bench point, so
//     each block's chain of dependent steps is short). Their edges are one
//     contiguous span, which the block copies to shared memory in chunks
//     of kQChunk edges with cp.async (the M rows of sh and the LN rows of
//     gm, 16 bytes a copy where rows and pointers are 16-byte aligned; no
//     registers held, so every copy of a chunk is in flight at once). Two
//     neighbouring lanes own each (node, output row) pair and sum
//     alternate edges of its run from shared memory into four partial
//     sums, carried across chunks and combined in a fixed order (a
//     one-step butterfly between the two lanes): no atomics, so two calls
//     give the same bits, and a run of any length (the padded tail on the
//     last node, or every edge on one node) is just more chunks. The
//     blocks run from the last node down, so that the padded tail's block
//     starts first. Neighbouring pairs own neighbouring nodes of one row,
//     so the stores go out in runs of kQNodes floats. A node with no edges
//     gets zeros.
// The TPU version's windowed one-hot MXU matmuls, bf16 hi/lo split and
// VMEM-resident accumulator exist for the TPU only and have no counterpart
// here; A lives in device memory, so there is no node-count cap.
//
// The member axis: a committee of K potentials (models/ensemble.py, one
// torch.func.vmap over the members, as JAX's jax.vmap gives each
// pallas_call a grid axis over the batch) calls each kernel once for all
// K members. blockIdx.y is the member (more than 65,535 members, the
// gridDim.y limit, launch in slices of 65,535); each float operand comes with a
// member stride in floats, 0 where the members share it (the geometry sh
// in the committee's forward, the saved primals of a batched Hessian), and
// the output is K contiguous (rows, cols) slabs. The index src and its
// offsets are one for all members. Each member is
// summed in the order of a K = 1 call, so the K slabs equal K single
// calls bit for bit; K = 1 with both strides 0 is the plain call.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream of the current device, allocates nothing, and returns
// cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported (l_max, n_max) or a member
// count below 1).

#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kMaxGridY = 65535;        // gridDim.y limit: a larger member count launches in slices
constexpr int kQBlock = 256;            // threads per q_scatter block
constexpr int kQNodes = 4;              // nodes per q_scatter block
constexpr int kQSplit = 2;              // neighbouring lanes that share one (node, row) sum
constexpr int kQChunk = 512;            // edges staged per chunk
constexpr int kQQuads = kQChunk / 4;
constexpr int kQStride = kQChunk + 4;   // a staged row's stride in floats: 16-byte
                                        // aligned, and rows start on other banks

// Row `row` of the staged chunk: sh rows first, then gm rows.
__device__ __forceinline__ const float* staged_row(const float* sh, const float* gm, int row,
                                                   int m, int num_edges) {
  return row < m ? sh + (size_t)row * num_edges : gm + (size_t)(row - m) * num_edges;
}

// q_scatter by src's offsets. Block b owns nodes [n0, n0 + kQNodes)
// with n0 counted from the last node down, so that the block of the padded
// tail (the last node's long run) starts first and overlaps the rest. Shared
// memory holds a chunk of the block's edge span as M + LN rows (sh rows,
// then gm rows) of kQStride floats: (M + LN) * kQStride floats of dynamic
// shared memory. Pair p of the block is node p % kQNodes, output row
// p / kQNodes; kQSplit neighbouring lanes share a pair, lane h summing the
// edges h, h + kQSplit, ... of each chunk's run.
template <int L, int NM>
__global__ void __launch_bounds__(kQBlock)
q_scatter_kernel(const float* __restrict__ sh, const float* __restrict__ gm,
                 const int* __restrict__ offsets, float* __restrict__ out,
                 int num_edges, int num_nodes, bool vec, long long sh_stride,
                 long long gm_stride) {
  constexpr int M = L * L;
  constexpr int LN = L * NM;
  constexpr int MN = M * NM;
  constexpr int kRows = M + LN;
  constexpr int kPairs = kQNodes * MN;
  constexpr int kPairsPerPass = kQBlock / kQSplit;
  constexpr int kPer = (kPairs + kPairsPerPass - 1) / kPairsPerPass;
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  sh += blockIdx.y * sh_stride;  // member blockIdx.y
  gm += blockIdx.y * gm_stride;
  out += (size_t)blockIdx.y * MN * num_nodes;

  const int n0 = (gridDim.x - 1 - blockIdx.x) * kQNodes;
  const int nodes = min(kQNodes, num_nodes - n0);
  const int span_begin = __ldg(offsets + n0);
  const int span_end = __ldg(offsets + n0 + nodes);
  const int h = threadIdx.x % kQSplit;

  int begin[kPer], end[kPer], s_off[kPer], g_off[kPer];
  float acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = threadIdx.x / kQSplit + k * kPairsPerPass;
    const int j = p % kQNodes, r = p / kQNodes;
    const bool live = p < kPairs && j < nodes;
    begin[k] = live ? __ldg(offsets + n0 + j) : 0;
    end[k] = live ? __ldg(offsets + n0 + j + 1) : 0;
    const int m = min(r / NM, M - 1), n = r % NM;
    int l = 0;
    while ((l + 1) * (l + 1) <= m) ++l;
    s_off[k] = m * kQStride;
    g_off[k] = (M + l * NM + n) * kQStride;
    acc[k] = 0.f;
  }

  // With vec, chunks start on a multiple of 4 edges, so that every staged
  // quad is one aligned 16-byte copy of a row; the edges before span_begin
  // that this pulls in belong to other blocks and are never summed.
  const int first = vec ? (span_begin & ~3) : span_begin;
  for (int c0 = first; c0 < span_end; c0 += kQChunk) {
    const int c1 = min(c0 + kQChunk, span_end);
    __syncthreads();  // the previous chunk is consumed
    // Item i is staged row i / kQQuads, quad i % kQQuads; without vec, four
    // single edges.
    const int width = vec ? (c1 - c0 + 3) & ~3 : c1 - c0;
#pragma unroll
    for (int i = threadIdx.x; i < kRows * kQQuads; i += kQBlock) {
      const int row = i / kQQuads, q = i % kQQuads;
      float* dst = stage + row * kQStride + 4 * q;
      const float* src = staged_row(sh, gm, row, M, num_edges) + c0 + 4 * q;
      if (vec) {
        if (4 * q < width) cp_async16(dst, src);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * q + u < width) cp_async4(dst + u, src + u);
      }
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int lo = max(begin[k], c0) - c0, hi = min(end[k], c1) - c0;
      const float* s_row = stage + s_off[k];
      const float* g_row = stage + g_off[k];
      // Four partial sums in a fixed order: independent FMA chains.
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      int i = lo + h;
      for (; i + 3 * kQSplit < hi; i += 4 * kQSplit) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          part[u] = fmaf(s_row[i + u * kQSplit], g_row[i + u * kQSplit], part[u]);
      }
      for (; i < hi; i += kQSplit) part[0] = fmaf(s_row[i], g_row[i], part[0]);
      acc[k] += (part[0] + part[1]) + (part[2] + part[3]);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    // The lanes of a pair combine in a fixed butterfly: each ends with the
    // same bits.
    float v = acc[k];
#pragma unroll
    for (int off = 1; off < kQSplit; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const int p = threadIdx.x / kQSplit + k * kPairsPerPass;
    const int j = p % kQNodes;
    if (h == 0 && p < kPairs && j < nodes) out[(size_t)(p / kQNodes) * num_nodes + n0 + j] = v;
  }
}

// Loops below run over degree l and, inside it, over the components
// m = l^2 .. (l+1)^2 - 1 of that degree, so that after unrolling every
// register-array index is a compile-time constant.

template <int L, int NM>
__global__ void __launch_bounds__(kBlock)
r1_gather_kernel(const float* __restrict__ a, const float* __restrict__ sh,
                 const int* __restrict__ src, float* __restrict__ out,
                 int num_edges, int num_nodes, long long a_stride, long long sh_stride) {
  constexpr int M = L * L;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_edges) return;
  a += blockIdx.y * a_stride;  // member blockIdx.y
  sh += blockIdx.y * sh_stride;
  out += (size_t)blockIdx.y * L * NM * num_edges;
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
                 int num_edges, int num_nodes, long long a_stride, long long gm_stride) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= num_edges) return;
  a += blockIdx.y * a_stride;  // member blockIdx.y
  gm += blockIdx.y * gm_stride;
  out += (size_t)blockIdx.y * L * L * num_edges;
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
cudaError_t launch_q(const float* sh, const float* gm, const int* offsets, float* out,
                     int num_edges, int num_nodes, int members, long long sh_stride,
                     long long gm_stride, cudaStream_t stream) {
  constexpr int kSmem = (L * L + L * NM) * kQStride * (int)sizeof(float);
  if (kSmem > 48 * 1024) {  // (l_max, n_max) = (4, 4) stages 66 KB
    const cudaError_t err = cudaFuncSetAttribute(
        q_scatter_kernel<L, NM>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
  }
  // Every member's rows stay 16-byte aligned: the strides are multiples of 4.
  const bool vec = num_edges % 4 == 0 && reinterpret_cast<uintptr_t>(sh) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gm) % 16 == 0 && sh_stride % 4 == 0 &&
                   gm_stride % 4 == 0;
  for (int k0 = 0; k0 < members; k0 += kMaxGridY) {
    const dim3 grid((num_nodes + kQNodes - 1) / kQNodes, min(members - k0, kMaxGridY));
    q_scatter_kernel<L, NM><<<grid, kQBlock, kSmem, stream>>>(
        sh + k0 * sh_stride, gm + k0 * gm_stride, offsets,
        out + (size_t)k0 * L * L * NM * num_nodes, num_edges, num_nodes, vec, sh_stride,
        gm_stride);
  }
  return cudaSuccess;
}

template <int L, int NM>
void launch_r1(const float* a, const float* sh, const int* src, float* out,
               int num_edges, int num_nodes, int members, long long a_stride,
               long long sh_stride, cudaStream_t stream) {
  for (int k0 = 0; k0 < members; k0 += kMaxGridY) {
    const dim3 grid((num_edges + kBlock - 1) / kBlock, min(members - k0, kMaxGridY));
    r1_gather_kernel<L, NM><<<grid, kBlock, 0, stream>>>(
        a + k0 * a_stride, sh + k0 * sh_stride, src,
        out + (size_t)k0 * L * NM * num_edges, num_edges, num_nodes, a_stride, sh_stride);
  }
}

template <int L, int NM>
void launch_r2(const float* a, const float* gm, const int* src, float* out,
               int num_edges, int num_nodes, int members, long long a_stride,
               long long gm_stride, cudaStream_t stream) {
  for (int k0 = 0; k0 < members; k0 += kMaxGridY) {
    const dim3 grid((num_edges + kBlock - 1) / kBlock, min(members - k0, kMaxGridY));
    r2_gather_kernel<L, NM><<<grid, kBlock, 0, stream>>>(
        a + k0 * a_stride, gm + k0 * gm_stride, src,
        out + (size_t)k0 * L * L * num_edges, num_edges, num_nodes, a_stride, gm_stride);
  }
}

}  // namespace

// Supported (l_max, n_max): 1..4 each. The Python wrapper checks the same
// range (KERNEL_MAX_L, KERNEL_MAX_N in ops/factorized_stage.py).
#define M3G_CASES(X) \
  X(1, 1) X(1, 2) X(1, 3) X(1, 4) X(2, 1) X(2, 2) X(2, 3) X(2, 4) \
  X(3, 1) X(3, 2) X(3, 3) X(3, 4) X(4, 1) X(4, 2) X(4, 3) X(4, 4)

#define M3G_CASE_q(L_, N_)                                                               \
  case L_ * 8 + N_: {                                                                    \
    const cudaError_t err =                                                              \
        launch_q<L_, N_>(x, y, idx, o, num_edges, num_nodes, members, x_stride, y_stride, s); \
    if (err != cudaSuccess) return (int)err;                                             \
  } break;
#define M3G_CASE_r1(L_, N_)                                                              \
  case L_ * 8 + N_:                                                                      \
    launch_r1<L_, N_>(x, y, idx, o, num_edges, num_nodes, members, x_stride, y_stride, s); \
    break;
#define M3G_CASE_r2(L_, N_)                                                              \
  case L_ * 8 + N_:                                                                      \
    launch_r2<L_, N_>(x, y, idx, o, num_edges, num_nodes, members, x_stride, y_stride, s); \
    break;

#define M3G_MEMBERS_OK(K) ((K) >= 1)

#define M3G_ENTRY(NAME, LAUNCH)                                                 \
  extern "C" int NAME(const void* in0, const void* in1, const void* index,     \
                      void* out, int num_edges, int num_nodes, int l_max,       \
                      int n_max, int members, long long x_stride,               \
                      long long y_stride, void* stream) {                       \
    if (!M3G_MEMBERS_OK(members)) return (int)cudaErrorInvalidValue;            \
    const float* x = static_cast<const float*>(in0);                            \
    const float* y = static_cast<const float*>(in1);                            \
    const int* idx = static_cast<const int*>(index);                            \
    float* o = static_cast<float*>(out);                                        \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                         \
    switch (l_max * 8 + n_max) {                                                \
      M3G_CASES(M3G_CASE_##LAUNCH)                                              \
      default:                                                                  \
        return (int)cudaErrorInvalidValue;                                      \
    }                                                                           \
    return (int)cudaGetLastError();                                             \
  }

// q_scatter(sh, gm, offsets) -> A (members, MN, num_nodes); in0 = sh, in1 =
// gm, index = the (num_nodes + 1,) int32 offsets of the sorted edge
// sources, with member strides x_stride, y_stride in floats (0: shared).
M3G_ENTRY(m3g_q_scatter, q)
// r1_gather(A, sh, src) -> out (members, LN, num_edges); in0 = A, in1 = sh,
// index = src, with member strides x_stride, y_stride in floats (0: shared).
M3G_ENTRY(m3g_r1_gather, r1)
// r2_gather(A, gm, src) -> out (members, M, num_edges); in0 = A, in1 = gm.
M3G_ENTRY(m3g_r2_gather, r2)
