// Hopper (sm_90a) kernels of CHGNet's gated-MLP tail, feature-major:
//
//   out = SiLU(LN_c(core + b_c)) * sigmoid(LN_g(gate + b_g))
//
// over (F, M) arrays, row-major (feature f, column m at f * M + m). LN
// normalises each column over its F features (biased variance, eps) and
// applies a scale and a shift per feature; b_c and b_g are the last Dense
// layers' biases, taken in here so that the Dense products stay bias-free
// cuBLAS GEMMs on (F, M) (ops/norm_gate.py, models/layers.py
// NormGatedMLPFM).
//
// Replaces no Pallas kernel: CHGNet has no JAX counterpart. The port ran
// this tail in torch before: each stack's (F, M) output transposed to
// (M, F) for nn.LayerNorm's contiguous rows, the product transposed back,
// and the same again in the backward, eight (F, M) passes of torch's
// strided copy a call beside two LayerNorms and the unfused gate.
//
//   m3g_norm_gate_fwd(core, gate, params[6], out, F, M, vec, eps, stream)
//   m3g_norm_gate_bwd_rows(F, M, vec, &rows, stream)
//   m3g_norm_gate_bwd(g, core, gate, params[6], d_core, d_gate, partial,
//                     rows, grads[6], F, M, vec, eps, stream)
//
// params (and grads) in this order: core bias, gate bias, core scale, core
// shift, gate scale, gate shift, each (F,). The backward recomputes the
// normalised columns from core and gate (nothing is saved between the two)
// and writes d core, d gate and the six parameters' gradients, which are
// sums over the columns: each of its `rows` blocks sums its columns into
// one row of `partial` (rows x 6 F floats), and a second kernel sums the
// rows in a fixed order into grads. No atomics: two calls give the same
// bits. m3g_norm_gate_bwd_rows says how many rows (blocks) the backward
// takes at F and M (it launches nothing; the stream is unused), so the
// caller allocates `partial` to match.
//
// What bounds them: memory. The forward reads 2 F M floats and writes
// F M; the backward reads 3 F M and writes 2 F M: 32 F bytes a column for
// the pair. At CHGNet's screen request (F 64; four calls at E ~0.75 M
// columns, five at T ~2.57 M) that is ~32.5 GB, ~9.7 ms at 3.35 TB/s.
//
// What the design does about it:
//   - a block owns a tile of 64 columns across all F features of both
//     stacks: 16 threads along the columns, each with 4 adjacent ones
//     (16-byte loads and stores, so half a warp moves 256 contiguous bytes
//     of a row), and 16 along the features, each with every 16th row
//     (RPT rows, 4 for F <= 64, held in registers: each byte is read once
//     and written once);
//   - the sums over a column's features (mean, centred variance, and in the
//     backward the LayerNorm's two sums) are each thread's rows summed in
//     registers, then the 16 row groups' partials summed through shared
//     memory in a fixed order;
//   - the forward has one tile a block. The backward's blocks stay resident
//     and walk the tiles (grid = the blocks that fit on the card at once),
//     so the parameters' partial sums are one row a block: ~1 MB, not one
//     row a tile;
//   - a column count M that is not a multiple of 4 (or an operand that is
//     not 16-byte aligned) takes 4-byte loads; the ragged last tile loads
//     zeros past M, which give zero gradients there, and stores nothing.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream of the current device, allocates nothing, and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kCols = 64;                          // a tile's columns
constexpr int kColGroups = kCols / 4;              // threads along a row, 4 columns each
constexpr int kRowGroups = 16;                     // threads along the features
constexpr int kThreads = kColGroups * kRowGroups;  // 256
constexpr int kMaxF = 256;
constexpr int kParams = 6;

struct Params {
  const float* p[kParams];
};
struct Grads {
  float* p[kParams];
};

struct Smem {
  float par[kParams][kMaxF];
  float red[kRowGroups][4][kCols];
  // mean core, mean gate, rstd core, rstd gate; the backward's LayerNorm
  // sums (means over F) of dx^ and dx^ x^, core then gate
  float stat[8][kCols];
};

template <bool kVec>
__device__ __forceinline__ void load4(const float* __restrict__ row, long long m, long long M,
                                      float (&v)[4]) {
  if (kVec) {
    const float4 x = m < M ? __ldg(reinterpret_cast<const float4*>(row + m))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = m + j < M ? __ldg(row + m + j) : 0.f;
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ row, long long m, long long M,
                                       const float (&v)[4]) {
  if (kVec) {
    if (m < M) *reinterpret_cast<float4*>(row + m) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (m + j < M) row[m + j] = v[j];
  }
}

__device__ __forceinline__ float sigmoid(float y) { return __frcp_rn(1.f + expf(-y)); }

__device__ __forceinline__ void load_params(Smem& s, const Params& prm, int F) {
  for (int i = threadIdx.x; i < kParams * F; i += kThreads) s.par[i / F][i % F] = __ldg(prm.p[i / F] + i % F);
}

// For each of the Q quantities and the thread's 4 columns: the sum over the
// block's row groups of part (each thread's rows, already summed), finished
// by fn, into s.stat[dst + q]. Returns with the block in step.
template <int Q, typename Fn>
__device__ __forceinline__ void column_sums(Smem& s, const float (&part)[Q][4], int dst, Fn fn) {
  const int cg = threadIdx.x % kColGroups, rg = threadIdx.x / kColGroups;
#pragma unroll
  for (int q = 0; q < Q; ++q)
    *reinterpret_cast<float4*>(&s.red[rg][q][4 * cg]) =
        make_float4(part[q][0], part[q][1], part[q][2], part[q][3]);
  __syncthreads();
  if (threadIdx.x < Q * kCols) {
    const int q = threadIdx.x / kCols, c = threadIdx.x % kCols;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kRowGroups; ++r) sum += s.red[r][q][c];
    s.stat[dst + q][c] = fn(sum);
  }
  __syncthreads();
}

// The tile's columns of core and gate (x[0], x[1]; biases added) normalised
// in place over the F features: x^ = (x - mean) * rstd. Rows past F are
// left as they are. rstd of the thread's 4 columns is returned in rstd.
template <int RPT>
__device__ __forceinline__ void normalise(Smem& s, float (&x)[2][RPT][4], int F, float eps,
                                          float (&rstd)[2][4]) {
  const int cg = threadIdx.x % kColGroups, rg = threadIdx.x / kColGroups;
  const float inv_f = 1.f / F;
  float part[2][4] = {};
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    if (rg + kRowGroups * k < F)
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[st][j] += x[st][k][j];
  column_sums<2>(s, part, 0, [&](float v) { return v * inv_f; });
  float mean[2][4];
#pragma unroll
  for (int st = 0; st < 2; ++st)
#pragma unroll
    for (int j = 0; j < 4; ++j) mean[st][j] = s.stat[st][4 * cg + j], part[st][j] = 0.f;
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    if (rg + kRowGroups * k < F)
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float d = x[st][k][j] - mean[st][j];
          part[st][j] += d * d;
        }
  column_sums<2>(s, part, 2, [&](float v) { return rsqrtf(v * inv_f + eps); });
#pragma unroll
  for (int st = 0; st < 2; ++st)
#pragma unroll
    for (int j = 0; j < 4; ++j) rstd[st][j] = s.stat[2 + st][4 * cg + j];
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    if (rg + kRowGroups * k < F)
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[st][k][j] = (x[st][k][j] - mean[st][j]) * rstd[st][j];
}

// The tile's rows of core and gate into x[0], x[1], with their biases added.
template <int RPT, bool kVec>
__device__ __forceinline__ void load_tile(const float* __restrict__ core,
                                          const float* __restrict__ gate, int F, long long M,
                                          long long m, float (&x)[2][RPT][4]) {
  const int rg = threadIdx.x / kColGroups;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int f = rg + kRowGroups * k;
    if (f < F) {
      load4<kVec>(core + (long long)f * M, m, M, x[0][k]);
      load4<kVec>(gate + (long long)f * M, m, M, x[1][k]);
    }
  }
}

template <int RPT>
__device__ __forceinline__ void add_biases(const Smem& s, int F, float (&x)[2][RPT][4]) {
  const int rg = threadIdx.x / kColGroups;
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int f = rg + kRowGroups * k;
    if (f < F)
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[st][k][j] += s.par[st][f];
  }
}

template <int RPT, bool kVec>
__global__ void __launch_bounds__(kThreads)
norm_gate_fwd_kernel(const float* __restrict__ core, const float* __restrict__ gate,
                     const Params prm, float* __restrict__ out, int F, long long M, float eps) {
  __shared__ Smem s;
  const int rg = threadIdx.x / kColGroups;
  const long long m = (long long)blockIdx.x * kCols + 4 * (threadIdx.x % kColGroups);
  float x[2][RPT][4];
  load_tile<RPT, kVec>(core, gate, F, M, m, x);
  load_params(s, prm, F);
  __syncthreads();
  add_biases<RPT>(s, F, x);
  float rstd[2][4];
  normalise<RPT>(s, x, F, eps, rstd);
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int f = rg + kRowGroups * k;
    if (f >= F) continue;
    const float sc = s.par[2][f], shc = s.par[3][f], sg = s.par[4][f], shg = s.par[5][f];
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float yc = sc * x[0][k][j] + shc, yg = sg * x[1][k][j] + shg;
      o[j] = yc * sigmoid(yc) * sigmoid(yg);
    }
    store4<kVec>(out + (long long)f * M, m, M, o);
  }
}

template <int RPT, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
norm_gate_bwd_kernel(const float* __restrict__ g, const float* __restrict__ core,
                     const float* __restrict__ gate, const Params prm,
                     float* __restrict__ d_core, float* __restrict__ d_gate,
                     float* __restrict__ partial, int F, long long M, float eps, int tiles) {
  __shared__ Smem s;
  const int cg = threadIdx.x % kColGroups, rg = threadIdx.x / kColGroups;
  const float inv_f = 1.f / F;
  load_params(s, prm, F);
  __syncthreads();
  // per row of the thread, over its columns of every tile: the gradients of
  // the core bias, gate bias, core scale, core shift, gate scale, gate shift
  float acc[kParams][RPT] = {};
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long m = (long long)tile * kCols + 4 * cg;
    float x[2][RPT][4], dy[2][RPT][4];
    load_tile<RPT, kVec>(core, gate, F, M, m, x);
#pragma unroll
    for (int k = 0; k < RPT; ++k)
      if (rg + kRowGroups * k < F) load4<kVec>(g + (long long)(rg + kRowGroups * k) * M, m, M, dy[0][k]);
    add_biases<RPT>(s, F, x);
    float rstd[2][4];
    normalise<RPT>(s, x, F, eps, rstd);
    // dy of each LayerNorm's output; the LayerNorm's sums over F of
    // dx^ = scale dy and dx^ x^
    float part[4][4] = {};
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int f = rg + kRowGroups * k;
      if (f >= F) continue;
      const float sc = s.par[2][f], shc = s.par[3][f], sg = s.par[4][f], shg = s.par[5][f];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float yc = sc * x[0][k][j] + shc, yg = sg * x[1][k][j] + shg;
        const float pc = sigmoid(yc), pg = sigmoid(yg), go = dy[0][k][j];
        const float dyc = go * pg * pc * (1.f + yc * (1.f - pc));
        const float dyg = go * yc * pc * pg * (1.f - pg);
        dy[0][k][j] = dyc, dy[1][k][j] = dyg;
        part[0][j] += sc * dyc;
        part[1][j] += sg * dyg;
        part[2][j] += sc * dyc * x[0][k][j];
        part[3][j] += sg * dyg * x[1][k][j];
      }
    }
    column_sums<4>(s, part, 4, [&](float v) { return v * inv_f; });
    float a[2][4], b[2][4];
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[st][j] = s.stat[4 + st][4 * cg + j], b[st][j] = s.stat[6 + st][4 * cg + j];
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int f = rg + kRowGroups * k;
      if (f >= F) continue;
      const float scale[2] = {s.par[2][f], s.par[4][f]};
      float dx[2][4];
#pragma unroll
      for (int st = 0; st < 2; ++st)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dx[st][j] = rstd[st][j] * (scale[st] * dy[st][k][j] - a[st][j] - x[st][k][j] * b[st][j]);
          acc[st][k] += dx[st][j];                          // the Dense biases
          acc[2 + 2 * st][k] += dy[st][k][j] * x[st][k][j];  // the scales
          acc[3 + 2 * st][k] += dy[st][k][j];                // the shifts
        }
      store4<kVec>(d_core + (long long)f * M, m, M, dx[0]);
      store4<kVec>(d_gate + (long long)f * M, m, M, dx[1]);
    }
  }
  // each row's sums over the 16 column groups (lanes of one half-warp), in a
  // fixed order; column group 0 writes the block's row of partials
#pragma unroll
  for (int q = 0; q < kParams; ++q)
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      float v = acc[q][k];
#pragma unroll
      for (int o = kColGroups / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, kColGroups);
      const int f = rg + kRowGroups * k;
      if (cg == 0 && f < F) partial[((long long)blockIdx.x * kParams + q) * F + f] = v;
    }
}

// grads[q][f] = the sum over the blocks' partial rows, in block order.
__global__ void norm_gate_param_sums(const float* __restrict__ partial, int blocks, int F,
                                     const Grads grads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kParams * F) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum += partial[(long long)b * kParams * F + i];
  grads.p[i / F][i % F] = sum;
}

// Rows a thread holds: 4 up to 64 features (CHGNet's width), 16 up to 256
// (correct, but the backward spills there). Two instantiations of each
// kernel, not five, keep the one-time build short.
int rows_per_thread(int F) { return F <= 4 * kRowGroups ? 4 : 16; }

template <int RPT>
void launch_fwd(bool vec, int tiles, cudaStream_t s, const float* core, const float* gate,
                const Params& prm, float* out, int F, long long M, float eps) {
  if (vec)
    norm_gate_fwd_kernel<RPT, true><<<tiles, kThreads, 0, s>>>(core, gate, prm, out, F, M, eps);
  else
    norm_gate_fwd_kernel<RPT, false><<<tiles, kThreads, 0, s>>>(core, gate, prm, out, F, M, eps);
}

// The blocks of the backward: as many as fit on the current card at once,
// and at most one a tile.
template <int RPT, bool kVec>
cudaError_t bwd_blocks_as(int tiles, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, norm_gate_bwd_kernel<RPT, kVec>,
                                                        kThreads, 0);
  *blocks = std::min(tiles, std::max(1, sms * per_sm));
  return err;
}

// Launches `blocks` blocks (clamped to the tiles), each with its row of
// `partial`.
template <int RPT, bool kVec>
cudaError_t launch_bwd_as(int tiles, int blocks, cudaStream_t s, const float* g,
                          const float* core, const float* gate, const Params& prm, float* d_core,
                          float* d_gate, float* partial, const Grads& grads, int F, long long M,
                          float eps) {
  blocks = std::min(tiles, blocks);
  norm_gate_bwd_kernel<RPT, kVec><<<blocks, kThreads, 0, s>>>(g, core, gate, prm, d_core, d_gate,
                                                               partial, F, M, eps, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  norm_gate_param_sums<<<(kParams * F + kThreads - 1) / kThreads, kThreads, 0, s>>>(partial, blocks,
                                                                                   F, grads);
  return cudaGetLastError();
}

template <int RPT>
cudaError_t bwd_blocks(bool vec, int tiles, int* blocks) {
  return vec ? bwd_blocks_as<RPT, true>(tiles, blocks) : bwd_blocks_as<RPT, false>(tiles, blocks);
}

template <int RPT>
cudaError_t launch_bwd(bool vec, int tiles, int blocks, cudaStream_t s, const float* g,
                       const float* core, const float* gate, const Params& prm, float* d_core,
                       float* d_gate, float* partial, const Grads& grads, int F, long long M,
                       float eps) {
  return vec ? launch_bwd_as<RPT, true>(tiles, blocks, s, g, core, gate, prm, d_core, d_gate,
                                        partial, grads, F, M, eps)
             : launch_bwd_as<RPT, false>(tiles, blocks, s, g, core, gate, prm, d_core, d_gate,
                                         partial, grads, F, M, eps);
}

bool tiles_of(int F, long long M, int* tiles) {
  if (F < 1 || F > kMaxF || M < 0 || (M + kCols - 1) / kCols > INT_MAX) return false;
  *tiles = (int)((M + kCols - 1) / kCols);
  return true;
}

}  // namespace

#define M3G_NG_RPT(X) X(4) X(16)

extern "C" int m3g_norm_gate_fwd(const void* core, const void* gate, const void* const* params,
                                 void* out, int F, long long M, int vec, float eps,
                                 void* stream) {
  int tiles = 0;
  if (!tiles_of(F, M, &tiles)) return (int)cudaErrorInvalidValue;
  if (tiles == 0) return (int)cudaSuccess;  // nothing to compute: a zero-size grid is an error
  Params prm;
  for (int q = 0; q < kParams; ++q) prm.p[q] = static_cast<const float*>(params[q]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *c = static_cast<const float*>(core), *gt = static_cast<const float*>(gate);
  float* o = static_cast<float*>(out);
  switch (rows_per_thread(F)) {
#define M3G_NG_FWD(R)                                          \
  case R:                                                      \
    launch_fwd<R>(vec != 0, tiles, s, c, gt, prm, o, F, M, eps); \
    break;
    M3G_NG_RPT(M3G_NG_FWD)
#undef M3G_NG_FWD
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int m3g_norm_gate_bwd_rows(int F, long long M, int vec, int* rows, void* stream) {
  (void)stream;
  int tiles = 0;
  if (!tiles_of(F, M, &tiles)) return (int)cudaErrorInvalidValue;
  switch (rows_per_thread(F)) {
#define M3G_NG_ROWS(R) \
  case R:              \
    return (int)bwd_blocks<R>(vec != 0, tiles, rows);
    M3G_NG_RPT(M3G_NG_ROWS)
#undef M3G_NG_ROWS
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int m3g_norm_gate_bwd(const void* g, const void* core, const void* gate,
                                 const void* const* params, void* d_core, void* d_gate,
                                 void* partial, int rows, void* const* grads, int F, long long M,
                                 int vec, float eps, void* stream) {
  int tiles = 0;
  if (!tiles_of(F, M, &tiles) || (tiles > 0 && rows < 1)) return (int)cudaErrorInvalidValue;
  Params prm;
  Grads out;
  for (int q = 0; q < kParams; ++q) {
    prm.p[q] = static_cast<const float*>(params[q]);
    out.p[q] = static_cast<float*>(grads[q]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles == 0) {  // no columns: the parameters' gradients are zero
    for (int q = 0; q < kParams; ++q) {
      const cudaError_t err = cudaMemsetAsync(out.p[q], 0, sizeof(float) * F, s);
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
  }
  const float *gp = static_cast<const float*>(g), *c = static_cast<const float*>(core),
              *gt = static_cast<const float*>(gate);
  float *dc = static_cast<float*>(d_core), *dg = static_cast<float*>(d_gate),
        *part = static_cast<float*>(partial);
  switch (rows_per_thread(F)) {
#define M3G_NG_BWD(R) \
  case R:             \
    return (int)launch_bwd<R>(vec != 0, tiles, rows, s, gp, c, gt, prm, dc, dg, part, out, F, M, eps);
    M3G_NG_RPT(M3G_NG_BWD)
#undef M3G_NG_BWD
    default:
      return (int)cudaErrorInvalidValue;
  }
}
