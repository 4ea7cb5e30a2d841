// The tiled sorted-owner sum, shared by sorted_segment_sum (B8,
// sorted_segment.cu) and windowed_scatter_fm (B7, windowed_take.cu):
//
//   out[f, s] = sum over i in [offsets[s], offsets[s + 1]) of data[f, pos(i)]
//
// in i order, with pos(i) = i (Ordered = false: the entries are sorted by
// segment) or pos(i) = order[i] (Ordered = true: order is a permutation
// that sorts an unsorted index stably, offsets its runs). data (rows,
// m_len) and out (rows, S) are f32, row-major; offsets (S + 1,) and order
// (m_len,) int32.
//
// owner_sum_tiled<R, Ordered> is the body of one block: the block
// owns segments [s0, s0 + blockDim.x) of rows [f0, f0 + R) (R <= 4), one
// thread per segment. Blocks run from the last segments down (s0 from
// blockIdx.x reversed), so the block of a padded tail's long run starts
// first. The segments' runs are one contiguous span [offsets[s0],
// offsets[s0 + sb]) of the entries, which the block walks in chunks of
// kChunk = kOwnerStage / R entries (rounded down to a multiple of 32):
//   - without an order, chunk k of the R rows is staged into one of two
//     shared buffers with cp.async (16-byte copies where vec holds: m_len a
//     multiple of 4 and data 16-byte aligned; 4-byte copies otherwise), so
//     chunk k + 1 is in flight while chunk k is summed, and no registers
//     hold the loads;
//   - with an order, chunk k of the order's span is staged the same way
//     (vec: m_len a multiple of 4 and order 16-byte aligned) into one of
//     two index buffers, as backward_pair stages its e2 order; the block
//     then gathers data[r, order[i]] for the chunk's entries from L1/L2
//     into one shared value buffer, kOwnerGather entries a thread a pass
//     with all their loads in flight together.
// Each owner then adds its run's part of the chunk, in order, into R chunk
// partials that it adds to R sums carried across chunks, and writes each
// of its R outputs once (0 for an empty run): no memset, no atomics, and
// a fixed order, so two calls give the same bits.

#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int kOwnerStage = 4096;  // floats per staged buffer of R rows (16 KB)
constexpr int kOwnerGather = 8;    // entries a thread gathers per pass (Ordered)

template <int R, bool Ordered>
__device__ __forceinline__ void owner_sum_tiled(const float* __restrict__ data,
                                                const int* __restrict__ order,
                                                const int* __restrict__ offsets,
                                                float* __restrict__ out, int rows, int m_len,
                                                int num_segments, bool vec) {
  // Entries per chunk: a multiple of 32, so that every staged row starts
  // 16-byte aligned.
  constexpr int kChunk = (kOwnerStage / R) & ~31;
  constexpr int kQuads = kChunk / 4;
  // Without an order: two buffers of R rows (chunk k in buffer k & 1).
  // With one: one buffer of R rows, the gathered values, and two buffers
  // of the order's entries.
  __shared__ __align__(16) float buf[Ordered ? 1 : 2][R * kChunk];
  __shared__ __align__(16) int pos[Ordered ? 2 : 1][Ordered ? kChunk : 4];
  const int sb = blockDim.x;
  const int s0 = (gridDim.x - 1 - blockIdx.x) * sb;
  const int f0 = blockIdx.y * R;
  const int nr = min(R, rows - f0);
  const int s = s0 + threadIdx.x;
  const bool live = s < num_segments;
  const int span_begin = __ldg(offsets + s0);
  const int span_end = __ldg(offsets + min(s0 + sb, num_segments));
  const int begin = live ? __ldg(offsets + s) : 0;
  const int end = live ? __ldg(offsets + s + 1) : 0;
  const float* __restrict__ base = data + (size_t)f0 * m_len;
  // With vec, chunks start on a multiple of 4 entries, so that every staged
  // quad is one aligned 16-byte copy; the entries outside the span that
  // this pulls in are never summed (nor gathered).
  const int first = vec ? (span_begin & ~3) : span_begin;
  const int chunks = span_end > first ? (span_end - first + kChunk - 1) / kChunk : 0;

  // Copies quad q of chunk k (at c0, width entries) from src to to: one
  // 16-byte cp.async with vec, else up to 4 single words.
  auto copy_quad = [&](auto* to, const auto* src, int q, int width) {
    if (vec) {
      if (4 * q < width) cp_async16(to + 4 * q, src + 4 * q);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * q + u < width) cp_async4(to + 4 * q + u, src + 4 * q + u);
    }
  };
  // Issues chunk k's copies into buffer k & 1 as one cp.async group: the R
  // rows' entries (item i is row i / kQuads, quad i % kQuads), or
  // (Ordered) the order's.
  auto stage = [&](int k) {
    const int c0 = first + k * kChunk;
    const int c1 = min(c0 + kChunk, span_end);
    const int width = vec ? (c1 - c0 + 3) & ~3 : c1 - c0;
    if constexpr (Ordered) {
      for (int q = threadIdx.x; 4 * q < width; q += sb) copy_quad(pos[k & 1], order + c0, q, width);
    } else {
      for (int i = threadIdx.x; i < R * kQuads; i += sb) {
        const int r = i / kQuads;
        if (r >= nr) break;
        copy_quad(buf[k & 1] + r * kChunk, base + (size_t)r * m_len + c0, i % kQuads, width);
      }
    }
    cp_async_commit();
  };

  // buf[0][r][i] = data[f0 + r, pos[k & 1][i]] over the span's part of
  // chunk k, [g0, g1); the buffer was last read before the previous barrier.
  auto gather = [&](int k, int g0, int g1) {
    float* val = buf[0];
    const int* p = pos[k & 1];
    for (int i0 = g0 + threadIdx.x; i0 < g1; i0 += kOwnerGather * sb) {
      int t[kOwnerGather];
#pragma unroll
      for (int u = 0; u < kOwnerGather; ++u) {
        const int i = i0 + u * sb;
        t[u] = i < g1 ? p[i] : -1;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nr) {
#pragma unroll
          for (int u = 0; u < kOwnerGather; ++u)
            if (t[u] >= 0) val[r * kChunk + i0 + u * sb] = __ldg(base + (size_t)r * m_len + t[u]);
        }
      }
    }
  };

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  if (chunks > 0) stage(0);
  for (int k = 0; k < chunks; ++k) {
    if (k + 1 < chunks) {
      stage(k + 1);  // its buffer was last read before the previous barrier
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();  // chunk k is in shared memory
    const int c0 = first + k * kChunk;
    const int c1 = min(c0 + kChunk, span_end);
    if constexpr (Ordered) {
      gather(k, max(span_begin, c0) - c0, c1 - c0);
      __syncthreads();  // the chunk's values are gathered
    }
    const float* src = buf[Ordered ? 0 : k & 1];
    const int lo = max(begin, c0) - c0, hi = min(end, c1) - c0;
    if (lo < hi) {
      float part[R];
#pragma unroll
      for (int r = 0; r < R; ++r) part[r] = 0.f;
      for (int i = lo; i < hi; ++i) {
#pragma unroll
        for (int r = 0; r < R; ++r) part[r] += src[r * kChunk + i];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += part[r];
    }
    __syncthreads();  // chunk k is consumed
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nr) out[(size_t)(f0 + r) * num_segments + s] = acc[r];
  }
}

}  // namespace
