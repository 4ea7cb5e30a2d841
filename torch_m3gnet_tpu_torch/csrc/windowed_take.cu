// Hopper (sm_90a) kernels for the T-scale gather of edge geometry and its
// transpose, used by the fused three-body mode.
//
// Replaces the Pallas TPU kernels of torch_m3gnet_tpu/ops/pallas_windowed_take.py:
//   m3g_windowed_take     <- windowed_take_fm (_take_impl, pallas_call at :146
//                            resident, :166 windowed)
//       out[f, t] = data[f, idx[t]]                       (F, E) -> (F, T)
//   m3g_windowed_scatter  <- windowed_scatter_fm (_scatter_impl, pallas_call
//                            at :218 resident, :240 windowed)
//       out[f, e] = sum_{t: idx[t]=e} vals[f, t]          (F, T) -> (F, E)
// All arrays are f32, row-major, with the entity axis (E or T) contiguous.
// idx (T,) is int32 with values in [0, E); it need NOT be sorted (the
// model passes the sorted triplet_e1 and the unsorted triplet_e2).
//
// What bounds them: memory. The take moves (F*E + T + F*T) * 4 bytes and
// computes nothing; the scatter does F*T adds on the same bytes. At the
// bench point (F = 4, E = 147,456, T = 1,057,792) that is 23.5 MB each.
//
// What the designs do about it:
//   - take: one thread per index t, looping over the F rows, so that a
//     warp's loads of idx and stores of out are 128-byte coalesced along t;
//     the data[:, idx[t]] reads hit a short window of columns (the triplets
//     of one source node touch only that node's edges), so L1/L2 serve them
//     and device memory sees each column about once.
//   - scatter: a sorted-owner sum (owner_sum_tiled, owner_sum.cuh, shared
//     with sorted_segment_sum): it takes the owners of idx, offsets (E + 1,)
//     and, for an unsorted idx, the stable order that sorts it (the batch's
//     triplet_e1 offsets and e2 order, built once per batch), and computes
//         out[:, e] = sum over i in [offsets[e], offsets[e + 1]) of
//                     vals[:, order[i]]   (vals[:, i] without an order)
//     in i order. A block owns the edges of all four rows, one thread an
//     edge. By e1 (256 edges a block) it streams its contiguous span of vals
//     through shared memory (cp.async, double buffered), as
//     sorted_segment_sum does. By e2 (128 edges a block) it stages its span
//     of the order the same way and gathers the four values of each staged
//     triplet from L1/L2 into shared memory, eight triplets a thread a
//     pass: both edges of a triplet share their source node, so a block's
//     e2 triplets lie in the triplet range of its few source nodes. Each edge's thread then sums
//     its run and writes its outputs once, empty edges 0: no memset, no
//     atomics, and the same bits on every call. It reads vals, offsets (and
//     the order) once and writes out once: 19.9 MB by e1 and 24.1 MB by e2
//     at the bench point. On an H100 (PERF.md; the designs that lost are
//     in CHANGES.md) the e2 call is fastest with 128-edge blocks and eight
//     triplets a thread a pass: a block's span (~900 triplets) then mostly
//     fits one chunk, and the whole grid stays resident. The e1 call is
//     fastest at 256. Gathering each owner's run by depth (coalesced, but
//     one load latency a step), owners that walk their own runs and a staged
//     window of vals (in both, one thread walks the padded triplets' run of
//     ~270 on edge 0) were slower.
// The TPU version's one-hot MXU contractions over windows of 256 columns,
// its bf16 hi/lo split and its VMEM residency have no counterpart here.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream of the current device, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "owner_sum.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kScatterRows = 4;      // rows a scatter block owns: the four of the geometry
constexpr int kScatterEdgesE2 = 128;  // edges a scatter block owns by an order (kBlock without)
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kBlock)
windowed_take_kernel(const float* __restrict__ data, const int* __restrict__ idx,
                     float* __restrict__ out, int rows, int num_cols, int num_idx) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_idx) return;
  const int c = __ldg(idx + t);
  for (int f = 0; f < rows; ++f)
    out[(size_t)f * num_idx + t] = __ldg(data + (size_t)f * num_cols + c);
}

// Block (blockIdx.x from the last edges down, blockIdx.y) owns edges
// [e0, e0 + blockDim.x) of rows [f0, f0 + kScatterRows), one thread per edge.
// The bound is the block size of the call.
template <bool Ordered>
__global__ void __launch_bounds__(Ordered ? kScatterEdgesE2 : kBlock)
windowed_scatter_owned(const float* __restrict__ vals, const int* __restrict__ order,
                       const int* __restrict__ offsets, float* __restrict__ out, int rows,
                       int num_cols, int num_idx, bool vec) {
  owner_sum_tiled<kScatterRows, Ordered>(vals, order, offsets, out, rows, num_idx, num_cols,
                                         vec);
}

int grid_for(int n) { return (n + kBlock - 1) / kBlock; }

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// take(data (rows, num_cols), idx (num_idx,)) -> out (rows, num_idx).
extern "C" int m3g_windowed_take(const void* data, const void* idx, void* out, int rows,
                                 int num_cols, int num_idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_idx > 0)
    windowed_take_kernel<<<grid_for(num_idx), kBlock, 0, s>>>(
        static_cast<const float*>(data), static_cast<const int*>(idx),
        static_cast<float*>(out), rows, num_cols, num_idx);
  return (int)cudaGetLastError();
}

// scatter(vals (rows, num_idx)) -> out (rows, num_cols) by the owners of
// idx: offsets (num_cols + 1,) and order (num_idx,), or order = nullptr
// for a sorted idx. Every output element is written, empty edges with 0.
extern "C" int m3g_windowed_scatter(const void* vals, const void* order, const void* offsets,
                                    void* out, int rows, int num_cols, int num_idx,
                                    void* stream) {
  if (rows <= 0 || num_cols <= 0 || num_idx < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const int* ord = static_cast<const int*>(order);
  const int* off = static_cast<const int*>(offsets);
  float* o = static_cast<float*>(out);
  // 16-byte staging of the span: of the order where there is one, else of
  // vals, where the pointer is aligned and the span's last quad ends inside
  const bool vec = num_idx % 4 == 0 && aligned16(ord != nullptr ? (const void*)ord : vals);
  // More than kMaxGridY row blocks (the gridDim.y limit) launch in slices.
  for (int r0 = 0; r0 < rows; r0 += kMaxGridY * kScatterRows) {
    const int n = min(rows - r0, kMaxGridY * kScatterRows);
    const dim3 grid(ord != nullptr ? (num_cols + kScatterEdgesE2 - 1) / kScatterEdgesE2
                                   : grid_for(num_cols),
                    (n + kScatterRows - 1) / kScatterRows);
    const float* vr = v + (size_t)r0 * num_idx;
    float* orow = o + (size_t)r0 * num_cols;
    if (ord != nullptr)
      windowed_scatter_owned<true><<<grid, kScatterEdgesE2, 0, s>>>(vr, ord, off, orow, n,
                                                                   num_cols, num_idx, vec);
    else
      windowed_scatter_owned<false><<<grid, kBlock, 0, s>>>(vr, nullptr, off, orow, n, num_cols,
                                                           num_idx, vec);
  }
  return (int)cudaGetLastError();
}
