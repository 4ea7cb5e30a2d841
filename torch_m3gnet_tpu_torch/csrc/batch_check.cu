// Hopper (sm_90a) kernel that checks a host batch's indices on the card,
// after data.to_torch has copied them there and before any kernel reads them.
//
// Replaces no Pallas kernel: the JAX package checks a batch's indices on the
// host, with numpy, and so did the port before this kernel. The kernels of
// the port do not check bounds (an index out of range reads or writes out of
// bounds, an unsorted one gives wrong sums), so every host batch is checked
// once; on the host that was five or six numpy passes over ~92 MB with the
// card idle, here it is one pass over the copies.
//
//   m3g_check_batch_index(table, n, word, stream)
//
// table holds n <= kMaxArrays rows of six int64 each, one row an index array:
//   (pointer, length, bound, element bytes (4: int32, 8: int64), sort mask,
//    range mask).
// Every element must lie in [0, bound), else the row's range mask is or-ed
// into *word; where the sort mask is not 0, every element must be <= the
// next one, else the sort mask is or-ed in. The entry zeroes *word on the
// stream first (a memset, not a kernel); the host reads it once. The masks
// are the caller's rule bits (ops/batch_check.py: bit 2 i for rule i's
// order, 2 i + 1 for its range), so the lowest set bit names the first rule
// that fails.
//
// What bounds it: memory. It reads each element once: at a screen batch (N
// 16,384, E 751,104, T 7,205,888; three triplet indices, two edge indices,
// node_graph) 92.5 MB, 27.6 us at 3.35 TB/s. It writes one word.
//
// What the design does about it:
//   - one launch for every array: the blocks are dealt out over the arrays
//     (first_block, a prefix over the rows), and each block owns one tile of
//     kTileVecs 16-byte vectors (16 KB) of one array;
//   - each thread issues its kVecs 16-byte loads before any compare, with
//     neighbouring threads on neighbouring addresses;
//   - a sorted array compares each element with the next: inside a vector
//     in registers, the vector's last element with the next lane's first
//     by a warp shuffle, and lane 31's (or the last whole vector's) with the
//     next element read from memory. So a pair across a warp, a tile or a
//     block boundary is compared like any other. The ragged tail (the
//     elements after the last whole vector) is checked by thread 0 of the
//     array's last block;
//   - each block ors its threads' faults with __syncthreads_or, and its
//     thread 0 does one atomicOr, only where the block found a fault: a
//     clean batch does no atomics.
// Arrays must be 16-byte aligned (the wrapper copies one that is not).
//
// Interface: plain C, loaded with ctypes. The entry point zeroes the word and
// launches on the given stream of the current device, allocates nothing, and
// returns the memset's error or cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxArrays = 8;
constexpr int kRowLongs = 6;
constexpr int kThreads = 256;
constexpr int kVecs = 4;                     // 16-byte vectors a thread
constexpr int kTileVecs = kThreads * kVecs;  // a block's tile: 16 KB

// The kernel's view of the table, passed by value.
struct Table {
  const void* ptr[kMaxArrays];
  long long len[kMaxArrays];
  unsigned long long bound[kMaxArrays];  // clamped to the element type's range
  int wide[kMaxArrays];                  // 1: int64 elements, 0: int32
  int sort_mask[kMaxArrays];
  int range_mask[kMaxArrays];
  int first_block[kMaxArrays + 1];
  int n;
};

template <typename T>
struct Unsigned;
template <>
struct Unsigned<int> {
  using type = unsigned;
};
template <>
struct Unsigned<long long> {
  using type = unsigned long long;
};

// Tile `tile` of array p (len elements of T): sets range_bad where an
// element lies outside [0, bound) and, for a sorted array, sort_bad where an
// element is greater than the next.
template <typename T>
__device__ __forceinline__ void check_tile(const T* __restrict__ p, long long len,
                                           unsigned long long bound, bool sorted,
                                           long long tile, bool last_tile, bool& range_bad,
                                           bool& sort_bad) {
  using U = typename Unsigned<T>::type;
  constexpr int kPer = 16 / sizeof(T);
  const U ub = static_cast<U>(bound);  // a negative value is a large unsigned one
  const long long nv = len / kPer;     // whole vectors
  const long long v0 = tile * kTileVecs + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int4* __restrict__ vp = reinterpret_cast<const int4*>(p);
  int4 raw[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long vi = v0 + (long long)k * kThreads;
    raw[k] = vi < nv ? __ldg(vp + vi) : make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long vi = v0 + (long long)k * kThreads;
    union {
      int4 v;
      T x[kPer];
    } u;
    u.v = raw[k];
    // Lane l + 1 holds vector vi + 1 (the same k): its first element is the
    // successor of this vector's last. Every lane takes part in the shuffle.
    const T next_lane = __shfl_down_sync(0xffffffffu, u.x[0], 1);
    if (vi < nv) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) range_bad |= static_cast<U>(u.x[j]) >= ub;
      if (sorted) {
#pragma unroll
        for (int j = 0; j + 1 < kPer; ++j) sort_bad |= u.x[j + 1] < u.x[j];
        const long long succ = (vi + 1) * kPer;
        if (succ < len) {
          const T y = (lane != 31 && vi + 1 < nv) ? next_lane : __ldg(p + succ);
          sort_bad |= y < u.x[kPer - 1];
        }
      }
    }
  }
  if (last_tile && threadIdx.x == 0) {
    for (long long i = nv * kPer; i < len; ++i) {
      const T x = __ldg(p + i);
      range_bad |= static_cast<U>(x) >= ub;
      if (sorted && i + 1 < len) sort_bad |= __ldg(p + i + 1) < x;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
check_batch_index(const __grid_constant__ Table t, int* __restrict__ word) {
  int a = 0;
#pragma unroll
  for (int i = 1; i < kMaxArrays; ++i)
    if (i < t.n && (int)blockIdx.x >= t.first_block[i]) a = i;
  const long long tile = (long long)blockIdx.x - t.first_block[a];
  const bool last_tile = (int)blockIdx.x + 1 == t.first_block[a + 1];
  const bool sorted = t.sort_mask[a] != 0;
  bool range_bad = false, sort_bad = false;
  if (t.wide[a])
    check_tile(static_cast<const long long*>(t.ptr[a]), t.len[a], t.bound[a], sorted, tile,
               last_tile, range_bad, sort_bad);
  else
    check_tile(static_cast<const int*>(t.ptr[a]), t.len[a], t.bound[a], sorted, tile, last_tile,
               range_bad, sort_bad);
  const int any_range = __syncthreads_or(range_bad);
  const int any_sort = __syncthreads_or(sort_bad);
  if (threadIdx.x == 0 && (any_range || any_sort))
    atomicOr(word, (any_range ? t.range_mask[a] : 0) | (any_sort ? t.sort_mask[a] : 0));
}

}  // namespace

extern "C" int m3g_check_batch_index(const void* table, int n, void* word, void* stream) {
  if (n < 0 || n > kMaxArrays || word == nullptr) return (int)cudaErrorInvalidValue;
  const long long* rows = static_cast<const long long*>(table);
  Table t = {};
  long long blocks = 0;
  for (int a = 0; a < n; ++a) {
    const long long* row = rows + kRowLongs * a;
    const long long ptr = row[0], len = row[1], bound = row[2], bytes = row[3];
    if (len < 0 || bound < 0 || (bytes != 4 && bytes != 8) || ptr % 16 != 0 ||
        (len > 0 && ptr == 0))
      return (int)cudaErrorInvalidValue;
    t.ptr[a] = reinterpret_cast<const void*>(ptr);
    t.len[a] = len;
    // No int32 value reaches 2^31: a larger bound is 2^31, which the unsigned
    // compare reads as "every non-negative value".
    t.bound[a] = bytes == 4 && bound > INT_MAX ? (1ull << 31) : (unsigned long long)bound;
    t.wide[a] = bytes == 8;
    t.sort_mask[a] = (int)row[4];
    t.range_mask[a] = (int)row[5];
    t.first_block[a] = (int)blocks;
    const long long nv = len / (16 / bytes);
    blocks += len == 0 ? 0 : (nv + kTileVecs - 1) / kTileVecs + (nv == 0);
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  for (int a = n; a <= kMaxArrays; ++a) t.first_block[a] = (int)blocks;
  t.n = n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(word, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (blocks == 0) return (int)cudaSuccess;  // nothing to read: a zero-size grid is an error
  check_batch_index<<<(int)blocks, kThreads, 0, s>>>(t, static_cast<int*>(word));
  return (int)cudaGetLastError();
}
