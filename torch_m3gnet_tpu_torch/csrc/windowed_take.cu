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
// What the design does about it: one thread per index t, looping over the
// F rows, so that a warp's loads of idx and vals and its stores of out are
// 128-byte coalesced along t. The data[:, idx[t]] reads and the scattered
// adds hit a short window of columns (the triplets of one source node touch
// only that node's edges), so L1/L2 serve them and device memory sees each
// column about once.
//   - take: plain loads and stores; deterministic.
//   - scatter: f32 atomicAdd into an output the entry point zeroes first
//     (cudaMemsetAsync on the same stream). The atomics resolve in L2; their
//     order, and so the last bits of each sum, change from run to run.
// The TPU version's one-hot MXU contractions over windows of 256 columns,
// its bf16 hi/lo split and its VMEM residency have no counterpart here.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream of the current device, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
windowed_take_kernel(const float* __restrict__ data, const int* __restrict__ idx,
                     float* __restrict__ out, int rows, int num_cols, int num_idx) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_idx) return;
  const int c = __ldg(idx + t);
  for (int f = 0; f < rows; ++f)
    out[(size_t)f * num_idx + t] = __ldg(data + (size_t)f * num_cols + c);
}

__global__ void __launch_bounds__(kBlock)
windowed_scatter_kernel(const float* __restrict__ vals, const int* __restrict__ idx,
                        float* __restrict__ out, int rows, int num_cols, int num_idx) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_idx) return;
  const int c = __ldg(idx + t);
  for (int f = 0; f < rows; ++f)
    atomicAdd(out + (size_t)f * num_cols + c, __ldg(vals + (size_t)f * num_idx + t));
}

int grid_for(int n) { return (n + kBlock - 1) / kBlock; }

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

// scatter(vals (rows, num_idx), idx (num_idx,)) -> out (rows, num_cols),
// zeroed here before the adds.
extern "C" int m3g_windowed_scatter(const void* vals, const void* idx, void* out, int rows,
                                    int num_cols, int num_idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)rows * num_cols, s);
  if (err != cudaSuccess) return (int)err;
  if (num_idx > 0)
    windowed_scatter_kernel<<<grid_for(num_idx), kBlock, 0, s>>>(
        static_cast<const float*>(vals), static_cast<const int*>(idx),
        static_cast<float*>(out), rows, num_cols, num_idx);
  return (int)cudaGetLastError();
}
