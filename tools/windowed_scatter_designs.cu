// Candidate designs of the sorted-owner sum of windowed_scatter_fm (B7),
// built by tools/windowed_scatter_designs.py into one library per variant.
//
//   out[f, e] = sum over i in [offsets[e], offsets[e + 1]) of vals[f, pos(i)]
//
// pos(i) = order[i] (the e2 call) or i (the e1 call, order = nullptr), in i
// order; f32 (F, T) -> (F, E), F <= 4 rows a block. Designs 1, 2 and 4
// sum each owner's run in chunks of the span, as the shipped kernel
// (owner_sum.cuh) does, so that with the same blocks and chunk bounds their
// sums are bitwise equal to it. The shipped kernel runs the e1 call with
// 256 edges a block, the e2 call with 128.
//
// Defines:
//   DESIGN 1: the shipped body, owner_sum_tiled<4, Ordered>, with THREADS
//             edges (and threads) a block for both calls.
//   DESIGN 2: the e2 call without the gathered value buffer: the block
//             stages its span of the order as the shipped kernel does, and
//             each owner reads vals[:, order[i]] of its own run from L1/L2,
//             four entries' loads in flight at a time (one barrier a chunk
//             fewer, no shared value buffer; idle threads on edges with no
//             triplet). The e1 call is DESIGN 1's.
//   DESIGN 3: the e2 call through a staged window of vals: the block's e2
//             triplets lie in the triplet range of its edges' few source
//             nodes, [tmin, tmax] (each owner's run ascends in t: a block
//             minimum of its first entries and maximum of its last). Where
//             that window fits WINDOW entries, the block stages it for its
//             four rows with 16-byte cp.async (a coalesced stream, as the e1
//             call's), and each owner sums vals[:, order[i]] of its run from
//             shared memory; otherwise (the padded triplets' long run on
//             edge 0, uniform random ids) each owner reads its run from
//             L1/L2. Sums each run in one chain, so it is not bitwise equal
//             to the shipped kernel (exact on dyadic data all the same).
//   DESIGN 4: the e2 call in chunks of the shipped body (design_gather),
//             with the chunk's values gathered as GATHER_MODE says:
//             0: the shipped gather: the block stages its chunk of the
//                order's span with cp.async (double buffered, as B5), then
//                gathers by entry (thread j of the block takes entries j,
//                j + THREADS, ...: 32 lanes' loads fall on ~17 lines),
//                GATHER entries a thread a pass (the shipped 8, at 128
//                edges a block; the first design had 4, at 256);
//             1: as 0, but by depth: each owner gathers its own part, four
//                entries a step, so that at each step a warp's lanes
//                (consecutive edges, whose triplets interleave) read nearby
//                columns; a part longer than 32 entries (the padded
//                triplets' run on edge 0) is gathered by the owner's warp;
//             4: as 0, but the order read from L1/L2 in the gather's pass
//                (no staging: one wait and one barrier a chunk fewer);
//             2: probe, mode 0's gather and no sum (writes garbage);
//             3: probe, neither gather nor sum: the offsets' reads and the
//                output's writes (zeros).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "owner_sum.cuh"

#ifndef DESIGN
#define DESIGN 1
#endif
#ifndef THREADS
#define THREADS 256
#endif
#ifndef WINDOW
#define WINDOW 3056
#endif
#ifndef GATHER_MODE
#define GATHER_MODE 0
#endif
#ifndef GATHER
#define GATHER 4
#endif

namespace {

constexpr int kRows = 4;

template <bool Ordered>
__global__ void __launch_bounds__(THREADS)
design_tiled(const float* __restrict__ vals, const int* __restrict__ order,
             const int* __restrict__ offsets, float* __restrict__ out, int rows, int num_cols,
             int num_idx, bool vec) {
  owner_sum_tiled<kRows, Ordered>(vals, order, offsets, out, rows, num_idx, num_cols, vec);
}

// DESIGN 3, the e2 call through a staged window of vals.
__global__ void __launch_bounds__(THREADS)
design_window(const float* __restrict__ vals, const int* __restrict__ order,
              const int* __restrict__ offsets, float* __restrict__ out, int rows, int num_cols,
              int num_idx, bool vec) {
  __shared__ __align__(16) float win[kRows * WINDOW];
  __shared__ int bounds[2][THREADS / 32];
  const int e0 = (gridDim.x - 1 - blockIdx.x) * blockDim.x;
  const int f0 = blockIdx.y * kRows;
  const int nr = min(kRows, rows - f0);
  const int e = e0 + threadIdx.x;
  const bool live = e < num_cols;
  const int begin = live ? __ldg(offsets + e) : 0;
  const int end = live ? __ldg(offsets + e + 1) : 0;
  const float* __restrict__ base = vals + (size_t)f0 * num_idx;
  // the block's window [tmin, tmax]: each run ascends in t
  int lo = begin < end ? __ldg(order + begin) : INT_MAX;
  int hi = begin < end ? __ldg(order + end - 1) : -1;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if ((threadIdx.x & 31) == 0) {
    bounds[0][threadIdx.x >> 5] = lo;
    bounds[1][threadIdx.x >> 5] = hi;
  }
  __syncthreads();
  int tmin = INT_MAX, tmax = -1;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) {
    tmin = min(tmin, bounds[0][w]);
    tmax = max(tmax, bounds[1][w]);
  }
  const int tbase = vec ? (tmin & ~3) : tmin;
  const int width = tmax - tbase + 1;
  const bool staged = tmax >= 0 && width <= WINDOW - 3;
  if (staged) {
    const int padded = vec ? (width + 3) & ~3 : width;
    for (int q = threadIdx.x; q < kRows * (WINDOW / 4); q += blockDim.x) {
      const int r = q / (WINDOW / 4), c = 4 * (q % (WINDOW / 4));
      if (r >= nr || c >= padded) continue;
      const float* src = base + (size_t)r * num_idx + tbase + c;
      float* to = win + r * WINDOW + c;
      if (vec) {
        cp_async16(to, src);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + u < width) cp_async4(to + u, src + u);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int i = begin; i < end; i += 4) {
    int t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) t[u] = i + u < end ? __ldg(order + i + u) : -1;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (t[u] < 0) continue;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr)
          acc[r] += staged ? win[r * WINDOW + t[u] - tbase] : __ldg(base + (size_t)r * num_idx + t[u]);
    }
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nr) out[(size_t)(f0 + r) * num_cols + e] = acc[r];
  }
}

// DESIGN 2, the e2 call: the order's span staged in chunks of kChunk
// entries (double buffered, as owner_sum_tiled), each owner's run read
// directly.
__global__ void __launch_bounds__(THREADS)
design_walk(const float* __restrict__ vals, const int* __restrict__ order,
            const int* __restrict__ offsets, float* __restrict__ out, int rows, int num_cols,
            int num_idx, bool vec) {
  constexpr int kChunk = (kOwnerStage / kRows) & ~31;
  __shared__ __align__(16) int pos[2][kChunk];
  const int e0 = (gridDim.x - 1 - blockIdx.x) * blockDim.x;
  const int f0 = blockIdx.y * kRows;
  const int nr = min(kRows, rows - f0);
  const int e = e0 + threadIdx.x;
  const bool live = e < num_cols;
  const int span_begin = __ldg(offsets + e0);
  const int span_end = __ldg(offsets + min(e0 + (int)blockDim.x, num_cols));
  const int begin = live ? __ldg(offsets + e) : 0;
  const int end = live ? __ldg(offsets + e + 1) : 0;
  const float* __restrict__ base = vals + (size_t)f0 * num_idx;
  const int first = vec ? (span_begin & ~3) : span_begin;
  const int chunks = span_end > first ? (span_end - first + kChunk - 1) / kChunk : 0;

  auto stage = [&](int k) {
    const int c0 = first + k * kChunk;
    const int c1 = min(c0 + kChunk, span_end);
    const int width = vec ? (c1 - c0 + 3) & ~3 : c1 - c0;
    for (int q = threadIdx.x; 4 * q < width; q += blockDim.x) {
      if (vec) {
        cp_async16(pos[k & 1] + 4 * q, order + c0 + 4 * q);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * q + u < width) cp_async4(pos[k & 1] + 4 * q + u, order + c0 + 4 * q + u);
      }
    }
    cp_async_commit();
  };

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  if (chunks > 0) stage(0);
  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) {
      stage(k + 1);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    const int c0 = first + k * kChunk;
    const int c1 = min(c0 + kChunk, span_end);
    const int lo = max(begin, c0) - c0, hi = min(end, c1) - c0;
    if (lo < hi) {
      const int* p = pos[k & 1];
      float part[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[r] = 0.f;
      for (int i = lo; i < hi; i += 4) {
        float v[4][kRows];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = i + u < hi ? p[i + u] : -1;
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            v[u][r] = (t >= 0 && r < nr) ? __ldg(base + (size_t)r * num_idx + t) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (i + u < hi) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) part[r] += v[u][r];
          }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += part[r];
    }
    __syncthreads();  // chunk k is consumed
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nr) out[(size_t)(f0 + r) * num_cols + e] = acc[r];
  }
}

// DESIGN 4, the e2 call: owner_sum_tiled's ordered path with the gather
// of GATHER_MODE.
__global__ void __launch_bounds__(THREADS)
design_gather(const float* __restrict__ vals, const int* __restrict__ order,
              const int* __restrict__ offsets, float* __restrict__ out, int rows, int num_cols,
              int num_idx, bool vec) {
  constexpr int kChunk = (kOwnerStage / kRows) & ~31;
  __shared__ __align__(16) float val[kRows * kChunk];
  __shared__ __align__(16) int pos[2][kChunk];
  const int sb = blockDim.x;
  const int e0 = (gridDim.x - 1 - blockIdx.x) * sb;
  const int f0 = blockIdx.y * kRows;
  const int nr = min(kRows, rows - f0);
  const int e = e0 + threadIdx.x;
  const bool live = e < num_cols;
  const int span_begin = __ldg(offsets + e0);
  const int span_end = __ldg(offsets + min(e0 + sb, num_cols));
  const int begin = live ? __ldg(offsets + e) : 0;
  const int end = live ? __ldg(offsets + e + 1) : 0;
  const float* __restrict__ base = vals + (size_t)f0 * num_idx;
  constexpr bool kStaged = GATHER_MODE <= 2;
  const int first = kStaged && vec ? (span_begin & ~3) : span_begin;
  const int chunks = span_end > first ? (span_end - first + kChunk - 1) / kChunk : 0;

  auto stage = [&](int k) {
    const int c0 = first + k * kChunk;
    const int c1 = min(c0 + kChunk, span_end);
    const int width = vec ? (c1 - c0 + 3) & ~3 : c1 - c0;
    for (int q = threadIdx.x; 4 * q < width; q += sb) {
      if (vec) {
        cp_async16(pos[k & 1] + 4 * q, order + c0 + 4 * q);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * q + u < width) cp_async4(pos[k & 1] + 4 * q + u, order + c0 + 4 * q + u);
      }
    }
    cp_async_commit();
  };
  // entries i0, i0 + step, ... (kG of them, below i_end) of the chunk
  constexpr int kG = GATHER_MODE == 1 ? 4 : GATHER;
  auto gather = [&](const int* p, int i0, int step, int i_end) {
    int t[kG];
#pragma unroll
    for (int u = 0; u < kG; ++u) t[u] = i0 + u * step < i_end ? p[i0 + u * step] : -1;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nr) {
#pragma unroll
        for (int u = 0; u < kG; ++u)
          if (t[u] >= 0) val[r * kChunk + i0 + u * step] = __ldg(base + (size_t)r * num_idx + t[u]);
      }
    }
  };

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  if (kStaged && chunks > 0) stage(0);
  for (int k = 0; k < chunks; ++k) {
    if (kStaged) {
      if (k + 1 < chunks) {
        stage(k + 1);
        cp_async_wait_group<1>();
      } else {
        cp_async_wait_group<0>();
      }
      __syncthreads();
    }
    const int c0 = first + k * kChunk;
    const int c1 = min(c0 + kChunk, span_end);
    const int* p = kStaged ? pos[k & 1] : nullptr;
    if (GATHER_MODE == 0 || GATHER_MODE == 2) {
      const int g0 = max(span_begin, c0) - c0, g1 = c1 - c0;
      for (int i0 = g0 + threadIdx.x; i0 < g1; i0 += kG * sb) gather(p, i0, sb, g1);
    } else if (GATHER_MODE == 4) {
      for (int i0 = threadIdx.x; i0 < c1 - c0; i0 += kG * sb) gather(order + c0, i0, sb, c1 - c0);
    } else if (GATHER_MODE == 1) {
      const int lo = max(begin, c0) - c0, hi = min(end, c1) - c0;
      const bool walk = hi - lo <= 32;
      if (walk)
        for (int i0 = lo; i0 < hi; i0 += 4) gather(p, i0, 1, hi);
      for (unsigned rest = __ballot_sync(0xffffffffu, !walk); rest; rest &= rest - 1) {
        const int owner = __ffs(rest) - 1;
        const int o_lo = __shfl_sync(0xffffffffu, lo, owner);
        const int o_hi = __shfl_sync(0xffffffffu, hi, owner);
        for (int i0 = o_lo + (threadIdx.x & 31); i0 < o_hi; i0 += 128) gather(p, i0, 32, o_hi);
      }
    }
    __syncthreads();
    const int lo = max(begin, c0) - c0, hi = min(end, c1) - c0;
    if (GATHER_MODE == 2) acc[0] += val[threadIdx.x];  // keeps the probe's gather alive
    if ((GATHER_MODE <= 1 || GATHER_MODE == 4) && lo < hi) {
      float part[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[r] = 0.f;
      for (int i = lo; i < hi; ++i) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[r] += val[r * kChunk + i];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += part[r];
    }
    __syncthreads();
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nr) out[(size_t)(f0 + r) * num_cols + e] = acc[r];
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// As m3g_windowed_scatter: (vals, order or NULL, offsets, out, rows,
// num_cols, num_idx, stream).
extern "C" int m3g_windowed_scatter(const void* vals, const void* order, const void* offsets,
                                    void* out, int rows, int num_cols, int num_idx,
                                    void* stream) {
  if (rows <= 0 || num_cols <= 0 || num_idx < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int* ord = static_cast<const int*>(order);
  const int* off = static_cast<const int*>(offsets);
  float* o = static_cast<float*>(out);
  const bool vec = num_idx % 4 == 0 && aligned16(ord != nullptr ? (const void*)ord : vals);
  const dim3 grid((num_cols + THREADS - 1) / THREADS, (rows + kRows - 1) / kRows);
  if (ord == nullptr)
    design_tiled<false><<<grid, THREADS, 0, s>>>(v, nullptr, off, o, rows, num_cols, num_idx,
                                                 vec);
  else if (DESIGN == 2)
    design_walk<<<grid, THREADS, 0, s>>>(v, ord, off, o, rows, num_cols, num_idx, vec);
  else if (DESIGN == 4)
    design_gather<<<grid, THREADS, 0, s>>>(v, ord, off, o, rows, num_cols, num_idx, vec);
  else if (DESIGN == 3)
    design_window<<<grid, THREADS, 0, s>>>(v, ord, off, o, rows, num_cols, num_idx,
                                           num_idx % 4 == 0 && aligned16(vals));
  else
    design_tiled<true><<<grid, THREADS, 0, s>>>(v, ord, off, o, rows, num_cols, num_idx, vec);
  return (int)cudaGetLastError();
}
