// Candidate designs for r1_gather / r2_gather (B2, B3), measured against
// the kernel the port ships (csrc/factorized_stage.cu: one thread per
// edge, A[:, src[e]] read through L1). Not part of the port: the library
// of ops/_cuda.py builds csrc/ only. tools/r_gather_designs.py compiles
// this file once per variant, with
//   -DDESIGN=1  tile: a block owns kTile = 4 * THREADS consecutive edges,
//               a thread 4 of them with 16-byte operand, id and output
//               accesses; the block reads its first and last id, stages
//               the node window A[:, lo..hi] in shared memory once
//               (cp.async; MN x width floats, up to 4,096), checks at the
//               barrier that every id lies in it, and reads A from device
//               memory where it does not fit;
//   -DDESIGN=2  warp window: as 1, but each warp takes its window from the
//               min and max of its own ids (two register reductions, no
//               load before the operand's and no block barrier) and
//               stages it in its own 1,024 floats;
//   -DDESIGN=3  two columns: 4 edges a thread, 16-byte accesses, no shared
//               memory: the columns A[:, id] of the thread's first and last
//               id through L1, each edge taking the one its id names
//               (sorted ids), a third gathered where an id is neither;
//   -DDESIGN=4  probe, not the function: out[r, e] = operand[r, e], EDGES
//               (1 or 4) edges a thread: what streaming the operand in and
//               the output out costs at this grid;
//   -DDESIGN=5  probe: out[r, e] = operand[r, e] + src[e], EDGES edges a
//               thread: the same plus the ids.
// Designs 1-3 first ask for all of A to be brought into L2 (one 128-byte
// line a thread over the grid), so that the copies after src find it
// there. Each output of 1-3 is the fixed-order FMA chain of _r_impl, so
// they equal the shipped kernel bit for bit. Same C entry points as
// csrc/factorized_stage.cu, for (l_max, n_max) = (1, 1), (3, 3), (4, 4).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "segment_offsets.cuh"  // cp_async4

#ifndef DESIGN
#define DESIGN 1
#endif
#ifndef THREADS
#define THREADS 128
#endif
#ifndef EDGES
#define EDGES 4
#endif

namespace {

constexpr int kTile = THREADS * 4;  // edges per block of designs 1-3

__device__ __forceinline__ void prefetch_a(const float* a, int rows, int num_nodes) {
  const size_t lines = ((size_t)rows * num_nodes * sizeof(float) + 127) / 128;
  for (size_t k = (size_t)threadIdx.x * gridDim.x + blockIdx.x; k < lines;
       k += (size_t)gridDim.x * THREADS)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(a + 32 * k));
}

// A thread's four edges [e0, e0 + 4): ids and operand rows (16-byte loads
// with vec, where num_edges % 4 == 0 and the pointers are aligned); an edge
// past the end gets id `fill`, a valid node, and is never stored.
template <int kIn>
__device__ __forceinline__ void load4(const float* __restrict__ in, const int* __restrict__ src,
                                      int num_edges, int e0, bool vec, int fill, int (&ids)[4],
                                      float (&x)[kIn][4], bool (&live)[4]) {
  if (vec) {
    const bool lv = e0 < num_edges;
    const int4 v =
        lv ? __ldg(reinterpret_cast<const int4*>(src + e0)) : make_int4(fill, fill, fill, fill);
    ids[0] = v.x, ids[1] = v.y, ids[2] = v.z, ids[3] = v.w;
#pragma unroll
    for (int r = 0; r < kIn; ++r) {
      const float4 f = lv ? __ldg(reinterpret_cast<const float4*>(in + (size_t)r * num_edges + e0))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      x[r][0] = f.x, x[r][1] = f.y, x[r][2] = f.z, x[r][3] = f.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) live[j] = lv;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      live[j] = e0 + j < num_edges;
      ids[j] = live[j] ? __ldg(src + e0 + j) : fill;
#pragma unroll
      for (int r = 0; r < kIn; ++r)
        x[r][j] = live[j] ? __ldg(in + (size_t)r * num_edges + e0 + j) : 0.f;
    }
  }
}

// Designs 1-2: every output row of the thread's four edges, each written
// as soon as it is summed, with A[r, ids[j]] from at(r, j).
template <int L, int NM, bool R1, int kIn, class At>
__device__ __forceinline__ void rows_out(const float (&x)[kIn][4], At at, float* __restrict__ out,
                                         int num_edges, int e0, bool vec, const bool (&live)[4]) {
  auto put = [&](int row, const float (&y)[4]) {
    float* o = out + (size_t)row * num_edges + e0;
    if (vec) {
      if (live[0]) *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (live[j]) o[j] = y[j];
    }
  };
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if constexpr (R1) {  // out[(l,n)] = sum_{m: l_m=l} sh[m] * A[(m,n)]
#pragma unroll
      for (int n = 0; n < NM; ++n) {
        float y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int m = l * l; m < (l + 1) * (l + 1); ++m) acc = fmaf(x[m][j], at(m * NM + n, j), acc);
          y[j] = acc;
        }
        put(l * NM + n, y);
      }
    } else {  // out[m] = sum_n gm[(l_m,n)] * A[(m,n)]
#pragma unroll
      for (int m = l * l; m < (l + 1) * (l + 1); ++m) {
        float y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int n = 0; n < NM; ++n) acc = fmaf(x[l * NM + n][j], at(m * NM + n, j), acc);
          y[j] = acc;
        }
        put(m, y);
      }
    }
  }
}

// Design 3: edge j's outputs y[:, j] from its operand x[:, j] and A's
// column c, and the rows of y written after all four edges.
template <int L, int NM, bool R1, int kIn, int kOut>
__device__ __forceinline__ void edge_outputs(const float (&x)[kIn][4], int j,
                                             const float (&c)[L * L * NM], float (&y)[kOut][4]) {
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if constexpr (R1) {
#pragma unroll
      for (int n = 0; n < NM; ++n) {
        float acc = 0.f;
#pragma unroll
        for (int m = l * l; m < (l + 1) * (l + 1); ++m) acc = fmaf(x[m][j], c[m * NM + n], acc);
        y[l * NM + n][j] = acc;
      }
    } else {
#pragma unroll
      for (int m = l * l; m < (l + 1) * (l + 1); ++m) {
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NM; ++n) acc = fmaf(x[l * NM + n][j], c[m * NM + n], acc);
        y[m][j] = acc;
      }
    }
  }
}

template <int kOut>
__device__ __forceinline__ void store_rows(const float (&y)[kOut][4], float* __restrict__ out,
                                           int num_edges, int e0, bool vec, const bool (&live)[4]) {
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    float* o = out + (size_t)r * num_edges + e0;
    if (vec) {
      if (live[0]) *reinterpret_cast<float4*>(o) = make_float4(y[r][0], y[r][1], y[r][2], y[r][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (live[j]) o[j] = y[r][j];
    }
  }
}

// Designs 1-3: out (kOut, E) from A (MN, N), the operand (kIn, E) and src.
template <int L, int NM, bool R1>
__global__ void __launch_bounds__(THREADS)
design_kernel(const float* __restrict__ a, const float* __restrict__ in,
              const int* __restrict__ src, float* __restrict__ out, int num_edges,
              int num_nodes, bool vec) {
  constexpr int MN = L * L * NM;
  constexpr int kIn = R1 ? L * L : L * NM;
  prefetch_a(a, MN, num_nodes);
  const int e0 = (blockIdx.x * THREADS + threadIdx.x) * 4;
#if DESIGN == 1
  constexpr int kWindow = 4096;
  __shared__ float window[kWindow];
  const int t0 = blockIdx.x * kTile;
  const int lo = __ldg(src + t0);
  const int hi = __ldg(src + min(t0 + kTile, num_edges) - 1);
#else
  const int lane = threadIdx.x % 32;
  if (e0 - lane * 4 >= num_edges) return;  // the whole warp is past the end
#endif
  int ids[4];
  float x[kIn][4];
  bool live[4];
#if DESIGN == 1
  load4<kIn>(in, src, num_edges, e0, vec, lo, ids, x, live);
#else
  load4<kIn>(in, src, num_edges, e0, vec, 0, ids, x, live);
#endif
  auto global = [&](int r, int j) { return __ldg(a + (size_t)r * num_nodes + ids[j]); };
#if DESIGN == 1 || DESIGN == 2
#if DESIGN == 2
  constexpr int kWindow = 1024;
  __shared__ float windows[THREADS / 32][kWindow];
  float* window = windows[threadIdx.x / 32];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (live[j]) lo = min(lo, ids[j]), hi = max(hi, ids[j]);
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (!live[j]) ids[j] = lo;
#endif
  const int width = hi - lo + 1;
  bool staged = width >= 1 && width <= kWindow / MN;  // uniform in the block (1) / warp (2)
  if (staged) {
#if DESIGN == 1
    for (int i = threadIdx.x; i < MN * width; i += THREADS) {
#else
    for (int i = lane; i < MN * width; i += 32) {
#endif
      const int r = i / width;
      cp_async4(window + i, a + (size_t)r * num_nodes + lo + (i - r * width));
    }
    cp_async_wait_all();
#if DESIGN == 1
    bool inside = true;
#pragma unroll
    for (int j = 0; j < 4; ++j) inside = inside && ids[j] >= lo && ids[j] <= hi;
    staged = __syncthreads_and(inside);
#else
    __syncwarp();
#endif
  }
  if (staged)
    rows_out<L, NM, R1>(x, [&](int r, int j) { return window[r * width + ids[j] - lo]; }, out,
                        num_edges, e0, vec, live);
  else
    rows_out<L, NM, R1>(x, global, out, num_edges, e0, vec, live);
#else  // DESIGN == 3: each edge's outputs from its column, stored after all four
  float c0[MN], c3[MN], y[R1 ? L * NM : L * L][4];
#pragma unroll
  for (int r = 0; r < MN; ++r) c0[r] = global(r, 0), c3[r] = global(r, 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (ids[j] == ids[0]) {
      edge_outputs<L, NM, R1>(x, j, c0, y);
    } else if (ids[j] == ids[3]) {
      edge_outputs<L, NM, R1>(x, j, c3, y);
    } else {
      float c[MN];
#pragma unroll
      for (int r = 0; r < MN; ++r) c[r] = global(r, j);
      edge_outputs<L, NM, R1>(x, j, c, y);
    }
  }
  store_rows(y, out, num_edges, e0, vec, live);
#endif
}

// Designs 4-5 (probes): EDGES consecutive edges a thread, one access of
// EDGES floats per row.
template <int K> struct VecOf;
template <> struct VecOf<1> { using F = float; };
template <> struct VecOf<4> { using F = float4; };

template <int L, int NM, bool R1>
__global__ void __launch_bounds__(THREADS)
probe_kernel(const float* __restrict__ in, const int* __restrict__ src, float* __restrict__ out,
             int num_edges) {
  constexpr int kIn = R1 ? L * L : L * NM;
  using VF = typename VecOf<EDGES>::F;
  const int e0 = (blockIdx.x * THREADS + threadIdx.x) * EDGES;
  if (e0 >= num_edges) return;
  const float add = DESIGN == 5 ? (float)__ldg(src + e0) : 0.f;
#pragma unroll
  for (int r = 0; r < kIn; ++r) {
    union { VF v; float s[EDGES]; } f;
    f.v = __ldg(reinterpret_cast<const VF*>(in + (size_t)r * num_edges + e0));
#pragma unroll
    for (int j = 0; j < EDGES; ++j) f.s[j] += add;
    *reinterpret_cast<VF*>(out + (size_t)r * num_edges + e0) = f.v;
  }
}

template <int L, int NM, bool R1>
int launch(const float* a, const float* in, const int* src, float* out, int num_edges,
           int num_nodes, cudaStream_t stream) {
#if DESIGN <= 3
  const bool vec = num_edges % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  design_kernel<L, NM, R1><<<(num_edges + kTile - 1) / kTile, THREADS, 0, stream>>>(
      a, in, src, out, num_edges, num_nodes, vec);
#else
  // the probes take the bench shapes only: aligned rows, E % EDGES == 0
  if (num_edges % EDGES != 0 || L != NM) return (int)cudaErrorInvalidValue;  // kIn == kOut
  const int per_block = THREADS * EDGES;
  probe_kernel<L, NM, R1><<<(num_edges + per_block - 1) / per_block, THREADS, 0, stream>>>(
      in, src, out, num_edges);
#endif
  return (int)cudaGetLastError();
}

}  // namespace

#define DESIGN_ENTRY(NAME, R1_)                                                               \
  extern "C" int NAME(const void* a, const void* in, const void* src, void* out,             \
                      int num_edges, int num_nodes, int l_max, int n_max, void* stream) {     \
    const float* pa = static_cast<const float*>(a);                                         \
    const float* pi = static_cast<const float*>(in);                                        \
    const int* ps = static_cast<const int*>(src);                                           \
    float* po = static_cast<float*>(out);                                                   \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                                     \
    switch (l_max * 8 + n_max) {                                                            \
      case 9: return launch<1, 1, R1_>(pa, pi, ps, po, num_edges, num_nodes, s);            \
      case 27: return launch<3, 3, R1_>(pa, pi, ps, po, num_edges, num_nodes, s);           \
      case 36: return launch<4, 4, R1_>(pa, pi, ps, po, num_edges, num_nodes, s);           \
      default: return (int)cudaErrorInvalidValue;                                           \
    }                                                                                       \
  }

DESIGN_ENTRY(m3g_r1_gather, true)
DESIGN_ENTRY(m3g_r2_gather, false)
