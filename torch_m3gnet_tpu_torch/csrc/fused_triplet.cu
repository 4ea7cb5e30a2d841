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
// basis, point e1 at the last (padded) edge, which therefore owns a long
// run of them, and point e2 at edge 0. Both take the batch's index (built
// once per batch by data.to_torch): the forward the run offsets of e1, off1
// (E + 1,) int32, edge e's triplets [off1[e], off1[e + 1]); the backward
// the e2 order (ops/fused_triplet.py triplet_e2_order): order (T,) int32,
// the stable permutation that sorts e2, and off2 (E + 1,) int32, edge e's
// run [off2[e], off2[e + 1]) of it.
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
// the g[:, e1[t]] reads and the gathers by the e2 order, fall in a short
// window of columns (both edges of a triplet share a source node and edges
// are sorted by source), so L1/L2 serve them.
//   - forward: the sorted-owner sum of B8 with the gate product fused into
//     the staging. Each edge's triplet range [off1[e], off1[e+1]) comes
//     from the batch, so nothing searches e1 and the kernel does not read
//     it. One block owns
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
//   - backward: one launch, two block ranges with no dependency between
//     them, so the gather-bound d_gate blocks and the streaming d_basis
//     blocks share the card:
//     * d_gate, blocks [0, ceil(E / 256)): the same sorted-owner sum as the
//       forward, turned to e2. A block owns kPairEdges = 256 consecutive
//       edges, one thread each; their triplets are one contiguous span of
//       the e2 order, whose ends the block reads from off2. It streams the
//       span in chunks of kPairStage / (LN + 1) triplets: the order is
//       copied to shared memory with cp.async, then each staged triplet t
//       gets its LN products g[:, e1[t]] * basis[:, t] in shared memory
//       (four staged triplets a thread with their loads in flight
//       together), and each thread sums its edge's run of the chunk in
//       order into LN partials added to LN sums carried across chunks, and
//       writes its LN outputs once. No memset and no atomics: every edge
//       has one owner and a fixed order, so two calls give the same bits,
//       and an edge with no triplet gets zeros. On the bench batch the
//       triplets of a span lie within a few nodes' triplet ranges (both
//       edges of a triplet share its source node), so the gathers of
//       basis, e1 and g stay in a window that L1/L2 serve. The padded
//       triplets' run on edge 0 is one thread's longer loop in block 0,
//       which starts first.
//     * d_basis, the blocks after them: a streaming write in t order, four
//       consecutive triplets a thread with 16-byte loads of e1 and e2 and
//       16-byte stores of each d_basis row where T % 4 == 0 and the
//       pointers are 16-byte aligned (scalar otherwise); consecutive
//       triplets share e1 (it is sorted), so g[:, e1] comes from L1.
//     The order adds 4 * (T + E + 1) bytes to the compulsory traffic, and
//     the d_gate blocks read e1 a second time (by t = order[i]): 9.05 MB
//     over the 100.5 MB at the bench point. The d_gate blocks take the low
//     block indices, so they start first (the other way round was slower
//     on an H100), and the gathers of their products, not the d_basis
//     stream, set the kernel's time.
// The TPU version's windowed one-hot MXU gathers and scatters, bf16 hi/lo
// split, sequential grid and VMEM residency have no counterpart here.
//
// The member axis: a committee of K potentials (models/ensemble.py, one
// torch.func.vmap over the members, as JAX's jax.vmap gives each
// pallas_call a grid axis over the batch) calls each kernel once for all
// K members. Each float operand comes with a member stride in floats, 0
// where the members share it (the basis in the committee's forward), and
// every output is K contiguous slabs: out and d_gate (K, LN, E), d_basis
// (K, LN, T). The index is one for all members: every member's sum reads
// the batch's one e1 offsets or e2 order.
// The member is the fast part of blockIdx.x (block b is member b % K of
// tile b / K), so that the K members of one tile run together: the
// forward's padded-edge tile first for every member, the backward's d_gate
// blocks of every member before any d_basis block, and a shared basis
// span read by the K members at about one time, while L2 holds it. More
// than 65,535 members launch in slices. Each member is summed in the order
// of a K = 1 call, so the K slabs equal K single calls bit for bit. K = 1
// launches the kernels without the member arithmetic (kMembers false).
// Where there are members, each base pointer goes through opaque(). On an
// NVIDIA H100 80GB HBM3 (700 W), at the bench point, K = 3 with the basis
// shared, device time beside 3 single calls' 96 / 128 us
// (tools/fused_triplet_turns.py, in turns): this design, B4 57 us, B5
// 119 us; without opaque(), B5 150 us (ptxas gave it 80 registers); the
// member on a grid axis of its own (as factorized_stage.cu has it), B4 75
// and B5 144 us, 152 without opaque(): the last member's d_gate blocks
// started after the other members' d_basis blocks. Member arithmetic in
// the K = 1 kernel cost B5 42.7 -> 55.7 us (46 with opaque()): ptxas then
// kept fewer of its gathers in flight.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream of the current device, allocates nothing, and returns
// cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported LN or a member count below 1).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int kFwdEdges = 256;    // edges (threads) per block of the forward
constexpr int kFwdStage = 8192;   // 4-byte words staged per forward chunk (32 KB)
constexpr int kPairEdges = 256;   // threads per block of the backward; d_gate owners a block
constexpr int kPairStage = 8192;  // 4-byte words staged per d_gate chunk (32 KB)
constexpr int kPairTrip = 4;      // triplets per thread of a d_basis block (one 16-byte quad)
constexpr int kMaxMembers = 65535;  // members a launch: a larger count launches in slices

// p, hidden from the compiler's address arithmetic (an empty asm that may
// change it), so that a member's base pointer is used as a kernel argument
// is: the gathers' addresses are then formed as the K = 1 kernel forms them.
template <typename T>
__device__ __forceinline__ T* opaque(T* p) {
  asm("" : "+l"(p));
  return p;
}

// The forward by the e1 offsets. Tile b owns edges [e0, e0 + kFwdEdges)
// with e0 counted from the last edge down, so that the tile of the padded
// edge (its long run) starts first and overlaps the rest. Shared memory
// holds a chunk of the block's triplet span: e2 and the LN rows of basis,
// each row then multiplied in place by the gathered gate row. With
// kMembers, block b is member b % members of tile b / members.
template <int LN, bool kMembers>
__global__ void __launch_bounds__(kFwdEdges)
fused_triplet_gate_sum_kernel(const float* __restrict__ basis, const float* __restrict__ gate,
                              const int* __restrict__ offsets, const int* __restrict__ e2,
                              float* __restrict__ out, int num_edges, int num_trip, bool vec,
                              int members, long long basis_stride, long long gate_stride) {
  // Triplets per chunk: a multiple of 32, so that every staged row starts
  // 16-byte aligned.
  constexpr int kChunk = (kFwdStage / (LN + 1)) & ~31;
  __shared__ __align__(16) int k_s[kChunk];
  __shared__ __align__(16) float prod[LN * kChunk];
  int tile = blockIdx.x, tiles = gridDim.x;
  if (kMembers) {
    const int m = tile % members;
    tile /= members;
    tiles /= members;
    basis = opaque(basis + m * basis_stride);
    gate = opaque(gate + m * gate_stride);
    out = opaque(out + (size_t)m * LN * num_edges);
  }
  const int e0 = (tiles - 1 - tile) * kFwdEdges;
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

// The backward: blocks [0, gate_blocks) own kPairEdges consecutive edges
// of d_gate each; the blocks after them write d_basis, kPairTrip
// consecutive triplets a thread. With kMembers, grid block b is block
// b / members of member b % members.
template <int LN, bool kMembers>
__global__ void __launch_bounds__(kPairEdges)
backward_pair_kernel(const float* __restrict__ basis, const float* __restrict__ gate,
                     const float* __restrict__ g, const int* __restrict__ e1,
                     const int* __restrict__ e2, const int* __restrict__ order,
                     const int* __restrict__ off2, float* __restrict__ d_basis,
                     float* __restrict__ d_gate, int num_edges, int num_trip, int gate_blocks,
                     bool vec, int members, long long basis_stride, long long gate_stride,
                     long long g_stride) {
  constexpr int kChunk = (kPairStage / (LN + 1)) & ~31;
  __shared__ __align__(16) int k_s[kChunk];
  __shared__ __align__(16) float prod[LN * kChunk];
  int block = blockIdx.x;
  if (kMembers) {
    const int m = block % members;
    block /= members;
    basis = opaque(basis + m * basis_stride);
    gate = opaque(gate + m * gate_stride);
    g = opaque(g + m * g_stride);
    d_basis = opaque(d_basis + (size_t)m * LN * num_trip);
    d_gate = opaque(d_gate + (size_t)m * LN * num_edges);
  }

  if (block >= gate_blocks) {
    // d_basis[:, t] = g[:, e1[t]] * gate[:, e2[t]]
    const int t0 = ((block - gate_blocks) * kPairEdges + threadIdx.x) * kPairTrip;
    if (t0 >= num_trip) return;
    if (vec) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(e1 + t0));
      const int4 b = __ldg(reinterpret_cast<const int4*>(e2 + t0));
#pragma unroll
      for (int r = 0; r < LN; ++r) {
        const float* gr = g + (size_t)r * num_edges;
        const float* qr = gate + (size_t)r * num_edges;
        const float4 v =
            make_float4(__ldg(gr + a.x) * __ldg(qr + b.x), __ldg(gr + a.y) * __ldg(qr + b.y),
                        __ldg(gr + a.z) * __ldg(qr + b.z), __ldg(gr + a.w) * __ldg(qr + b.w));
        *reinterpret_cast<float4*>(d_basis + (size_t)r * num_trip + t0) = v;
      }
    } else {
      for (int t = t0; t < min(t0 + kPairTrip, num_trip); ++t) {
        const int a = __ldg(e1 + t), b = __ldg(e2 + t);
#pragma unroll
        for (int r = 0; r < LN; ++r)
          d_basis[(size_t)r * num_trip + t] =
              __ldg(g + (size_t)r * num_edges + a) * __ldg(gate + (size_t)r * num_edges + b);
      }
    }
    return;
  }

  // d_gate[:, e] = sum over i in [off2[e], off2[e + 1]) of
  // g[:, e1[t]] * basis[:, t], t = order[i], in i order.
  const int e0 = block * kPairEdges;
  const int e = e0 + threadIdx.x;
  const bool live = e < num_edges;
  const int span_begin = __ldg(off2 + e0);
  const int span_end = __ldg(off2 + min(e0 + kPairEdges, num_edges));
  const int begin = live ? __ldg(off2 + e) : 0;
  const int end = live ? __ldg(off2 + e + 1) : 0;

  float acc[LN];
#pragma unroll
  for (int r = 0; r < LN; ++r) acc[r] = 0.f;
  // With vec, chunks start on a multiple of 4, so that every staged quad
  // of the order is one aligned 16-byte copy; the entries outside the span
  // that this pulls in are never summed.
  const int first = vec ? (span_begin & ~3) : span_begin;
  for (int c0 = first; c0 < span_end; c0 += kChunk) {
    const int c1 = min(c0 + kChunk, span_end);
    const int width = vec ? (c1 - c0 + 3) & ~3 : c1 - c0;
    __syncthreads();  // the previous chunk is consumed
    for (int q = threadIdx.x; 4 * q < width; q += kPairEdges) {
      if (vec) {
        cp_async16(k_s + 4 * q, order + c0 + 4 * q);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * q + u < width) cp_async4(k_s + 4 * q + u, order + c0 + 4 * q + u);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    for (int i0 = threadIdx.x; i0 < width; i0 += kPairTrip * kPairEdges) {
      int t[kPairTrip], a[kPairTrip];
#pragma unroll
      for (int u = 0; u < kPairTrip; ++u) {
        const int i = i0 + u * kPairEdges;
        t[u] = i < width ? k_s[i] : -1;
      }
#pragma unroll
      for (int u = 0; u < kPairTrip; ++u) a[u] = t[u] >= 0 ? __ldg(e1 + t[u]) : 0;
#pragma unroll
      for (int r = 0; r < LN; ++r) {
#pragma unroll
        for (int u = 0; u < kPairTrip; ++u)
          if (t[u] >= 0)
            prod[r * kChunk + i0 + u * kPairEdges] =
                __ldg(g + (size_t)r * num_edges + a[u]) * __ldg(basis + (size_t)r * num_trip + t[u]);
      }
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
    for (int r = 0; r < LN; ++r) d_gate[(size_t)r * num_edges + e] = acc[r];
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Members a launch of `blocks` blocks each: at most kMaxMembers, and a grid
// of at most INT_MAX blocks.
int members_per_launch(int blocks) {
  const long long cap = INT_MAX / blocks;
  return cap < kMaxMembers ? (int)cap : kMaxMembers;
}

template <int LN>
void launch_fwd(const float* basis, const float* gate, const int* offsets, const int* e2,
                float* out, int num_edges, int num_trip, int members, long long basis_stride,
                long long gate_stride, cudaStream_t stream) {
  // Every member's basis rows stay 16-byte aligned: the stride is a
  // multiple of 4 (the gate is read a word at a time).
  const bool vec =
      num_trip % 4 == 0 && aligned16(basis) && aligned16(e2) && basis_stride % 4 == 0;
  const int tiles = (num_edges + kFwdEdges - 1) / kFwdEdges;
  if (members == 1) {
    fused_triplet_gate_sum_kernel<LN, false><<<tiles, kFwdEdges, 0, stream>>>(
        basis, gate, offsets, e2, out, num_edges, num_trip, vec, 1, 0, 0);
    return;
  }
  const int per_launch = members_per_launch(tiles);
  for (int k0 = 0; k0 < members; k0 += per_launch) {
    const int k = min(members - k0, per_launch);
    fused_triplet_gate_sum_kernel<LN, true><<<tiles * k, kFwdEdges, 0, stream>>>(
        basis + k0 * basis_stride, gate + k0 * gate_stride, offsets, e2,
        out + (size_t)k0 * LN * num_edges, num_edges, num_trip, vec, k, basis_stride,
        gate_stride);
  }
}

template <int LN>
void launch_pair(const float* basis, const float* gate, const float* g, const int* e1,
                 const int* e2, const int* order, const int* off2, float* d_basis,
                 float* d_gate, int num_edges, int num_trip, int members, long long basis_stride,
                 long long gate_stride, long long g_stride, cudaStream_t stream) {
  // The vector paths read the index and write d_basis, whose member slabs
  // (LN * T floats) stay 16-byte aligned where T % 4 == 0; the float
  // operands are read a word at a time, so their strides do not matter.
  const bool vec = num_trip % 4 == 0 && aligned16(e1) && aligned16(e2) && aligned16(order) &&
                   aligned16(d_basis);
  const int gate_blocks = (num_edges + kPairEdges - 1) / kPairEdges;
  const long long per_block = (long long)kPairEdges * kPairTrip;
  const int blocks = gate_blocks + (int)(((long long)num_trip + per_block - 1) / per_block);
  if (members == 1) {
    backward_pair_kernel<LN, false><<<blocks, kPairEdges, 0, stream>>>(
        basis, gate, g, e1, e2, order, off2, d_basis, d_gate, num_edges, num_trip, gate_blocks,
        vec, 1, 0, 0, 0);
    return;
  }
  const int per_launch = members_per_launch(blocks);
  for (int k0 = 0; k0 < members; k0 += per_launch) {
    const int k = min(members - k0, per_launch);
    backward_pair_kernel<LN, true><<<blocks * k, kPairEdges, 0, stream>>>(
        basis + k0 * basis_stride, gate + k0 * gate_stride, g + k0 * g_stride, e1, e2, order,
        off2, d_basis + (size_t)k0 * LN * num_trip, d_gate + (size_t)k0 * LN * num_edges,
        num_edges, num_trip, gate_blocks, vec, k, basis_stride, gate_stride, g_stride);
  }
}

}  // namespace

// Supported LN = l_max * n_max: 1..16. The Python wrapper checks the same
// range (KERNEL_MAX_ROWS in ops/fused_triplet.py).
#define M3G_ROWS(X)                                                               \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) \
  X(16)
#define M3G_CASE_FWD(LN_)                                                                      \
  case LN_:                                                                                    \
    launch_fwd<LN_>(b, gt, off, i2, o, num_edges, num_trip, members, basis_stride,             \
                    gate_stride, s);                                                           \
    break;
#define M3G_CASE_PAIR(LN_)                                                                     \
  case LN_:                                                                                    \
    launch_pair<LN_>(b, gt, gg, i1, i2, ord, o2, db, dg, num_edges, num_trip, members,         \
                     basis_stride, gate_stride, g_stride, s);                                  \
    break;

// fused_triplet_gate_sum(basis (rows, T), gate (rows, E), off1, e2) -> out
// (rows, E) for each of `members` members, each float operand at its
// member stride in floats (0: shared), out (members, rows, E); off1 is the
// (E + 1,) int32 run offsets of the sorted e1.
extern "C" int m3g_fused_triplet_gate_sum(const void* basis, const void* gate, const void* off1,
                                          const void* e2, void* out, int rows, int num_edges,
                                          int num_trip, int members, long long basis_stride,
                                          long long gate_stride, void* stream) {
  if (members < 1) return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(basis);
  const float* gt = static_cast<const float*>(gate);
  const int* off = static_cast<const int*>(off1);
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

// backward_pair(basis (rows, T), gate (rows, E), g (rows, E), e1, e2, order,
//   off2) -> d_basis (rows, T), d_gate (rows, E) for each of `members`
//   members, each float operand at its member stride in floats (0: shared),
//   d_basis (members, rows, T), d_gate (members, rows, E); every element of
//   both is written.
extern "C" int m3g_backward_pair(const void* basis, const void* gate, const void* g,
                                 const void* e1, const void* e2, const void* order,
                                 const void* off2, void* d_basis, void* d_gate, int rows,
                                 int num_edges, int num_trip, int members,
                                 long long basis_stride, long long gate_stride,
                                 long long g_stride, void* stream) {
  if (num_edges <= 0 || num_trip < 0 || members < 1) return (int)cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(basis);
  const float* gt = static_cast<const float*>(gate);
  const float* gg = static_cast<const float*>(g);
  const int* i1 = static_cast<const int*>(e1);
  const int* i2 = static_cast<const int*>(e2);
  const int* ord = static_cast<const int*>(order);
  const int* o2 = static_cast<const int*>(off2);
  float* db = static_cast<float*>(d_basis);
  float* dg = static_cast<float*>(d_gate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows) {
    M3G_ROWS(M3G_CASE_PAIR)
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
