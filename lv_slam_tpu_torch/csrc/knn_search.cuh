// The sorted grid's k-nearest search, shared by kernel 9k's entries
// (knn_grid.cu: knn, the 2-point lines and the 3-point planes) and the 5-NN
// line / plane fits of lfa_fit.cu (kernel 10g). The design and what it
// keeps of the reference's `knn` are set out in knn_grid.cu's comment: the
// 27 cells in `_OFF27` order, a lower bound each (INT32_MAX out of the
// extent), the `slots` clamped candidate rows, the fma-chain squared
// distances, and the k best candidates by (d2, candidate index), misses at
// +inf, as one 64-bit word each, searched by a warp or by a thread.
#pragma once

#include "common.cuh"

#include <math.h>
#include <stdint.h>

namespace lvs {

constexpr int kExtent = 1024;
constexpr int kKeyMax = 2147483647;  // INT32_MAX
constexpr int kMaxK = 8;             // neighbours a grid query may keep
constexpr int kStageAll = 8192;      // keys a block stages whole up to this many (32 KB)
constexpr int kSamples = 1024;       // else every stride-th key
constexpr unsigned long long kNone = ~0ull;  // an empty list entry: above every candidate

// The sorted keys as a block holds them: every `stride`-th key (all of them
// at stride 1) in shared memory, `count` of them, and the whole array.
struct StagedKeys {
  const int* keys;
  int n;
  const int* at;  // shared memory
  int count;
  int stride;

  // keys[i], INT32_MAX past the last row (at or above every searched key)
  __device__ __forceinline__ int key(int i) const {
    if (stride == 1) return i < n ? at[i] : kKeyMax;
    return i < n ? __ldg(keys + i) : kKeyMax;
  }

  // first index of keys (ascending, n of them) holding a value >= q: the
  // branch-free bisection over the staged keys, then within one stride
  __device__ __forceinline__ int lower_bound(int q) const {
    int pos = 0;
    for (int len = count; len > 1;) {
      const int half = len >> 1;
      pos = at[pos + half] < q ? pos + half : pos;
      len -= half;
    }
    const int j = pos + (at[pos] < q);  // staged keys below q
    if (stride == 1 || j == 0) return j * stride;
    pos = (j - 1) * stride + 1;  // the bound lies in [pos, pos + stride - 1]
    for (int len = stride - 1; len > 1;) {
      const int half = len >> 1;
      pos = key(pos + half) < q ? pos + half : pos;
      len -= half;
    }
    return pos + (key(pos) < q);
  }
};

// Every thread of the block: stage `keys` (n >= 1 of them) into `at`.
__device__ __forceinline__ StagedKeys stage_keys(const int* __restrict__ keys, int n, int* at) {
  StagedKeys s{keys, n, at, n, 1};
  if (n <= kStageAll) {
    const bool vec = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
    const int n4 = vec ? n / 4 : 0;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      reinterpret_cast<int4*>(at)[i] = __ldg(reinterpret_cast<const int4*>(keys) + i);
    for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) at[i] = __ldg(keys + i);
  } else {
    s.stride = (n + kSamples - 1) / kSamples;
    s.count = (n + s.stride - 1) / s.stride;
    for (int j = threadIdx.x; j < s.count; j += blockDim.x) at[j] = __ldg(keys + static_cast<long long>(j) * s.stride);
  }
  __syncthreads();
  return s;
}

// a sorted list of the K least words seen, in registers
template <int K>
__device__ __forceinline__ void keep_best(unsigned long long (&a)[K], unsigned long long c) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) a[j] = c < a[j - 1] ? a[j - 1] : (c < a[j] ? c : a[j]);
  a[0] = c < a[0] ? c : a[0];
}

// the same list carrying each word's grid row
template <int K>
__device__ __forceinline__ void keep_best(unsigned long long (&a)[K], int (&rows)[K], unsigned long long c, int r) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool shift = c < a[j - 1], here = !shift && c < a[j];
    rows[j] = shift ? rows[j - 1] : (here ? r : rows[j]);
    a[j] = shift ? a[j - 1] : (here ? c : a[j]);
  }
  rows[0] = c < a[0] ? r : rows[0];
  a[0] = c < a[0] ? c : a[0];
}

// candidate `index` with squared distance d as one word: (d2 bits << 32 | index)
__device__ __forceinline__ unsigned long long candidate_word(float d, unsigned index) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) | index;
}

// Neighbour cell `cell27` (`_OFF27` order) of the query in cell c: its
// flat key, or INT32_MAX out of the extent (then `in_extent` is false).
__device__ __forceinline__ int neighbour_key(const int (&c)[3], const int (&o)[3], int cell27, bool* in_extent) {
  const int off[3] = {cell27 / 9 - 1, (cell27 / 3) % 3 - 1, cell27 % 3 - 1};
  bool in = true;
  int r[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    long long rel = static_cast<long long>(c[a]) - o[a] + off[a];
    in = in && rel >= 0 && rel < kExtent;
    r[a] = static_cast<int>(rel);
  }
  *in_extent = in;
  return in ? (r[0] * kExtent + r[1]) * kExtent + r[2] : kKeyMax;
}

// The query's grid context: the staged keys, the points, the origin, the
// cell size, the slots a cell gives, and where every out-of-extent cell's
// search lands (lower_bound(INT32_MAX), alike for all of them).
struct Grid {
  StagedKeys keys;
  const float* xyz;
  int o[3];
  float cell;
  int slots;
  int miss_start;
};

// The K best candidates of query q, a warp calling (lane = neighbour
// cell): on every lane, their squared distances ascending in d2[0..K)
// (+inf for misses) and their grid rows in row[0..K).
template <int K>
__device__ __forceinline__ void warp_k_nearest(const Grid& g, const float (&q)[3], float (&d2)[K], int (&row)[K]) {
  const int lane = threadIdx.x & 31;
  const int n = g.keys.n;
  unsigned long long best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) best[j] = kNone;
  int start = 0;
  if (lane < 27) {
    const int c[3] = {cell_floor_div(q[0], g.cell), cell_floor_div(q[1], g.cell), cell_floor_div(q[2], g.cell)};
    bool in_extent;
    const int key = neighbour_key(c, g.o, lane, &in_extent);
    start = in_extent ? g.keys.lower_bound(key) : g.miss_start;
    const unsigned first = static_cast<unsigned>(lane * g.slots);
#pragma unroll 8
    for (int s = 0; s < g.slots; ++s) {
      const int idx = min(start + s, n - 1);
      const float px = __ldg(g.xyz + 3 * idx + 0), py = __ldg(g.xyz + 3 * idx + 1), pz = __ldg(g.xyz + 3 * idx + 2);
      float d = INFINITY;
      if (in_extent && g.keys.key(idx) == key) {
        const float dx = q[0] - px, dy = q[1] - py, dz = q[2] - pz;
        d = dot3_fma(dx, dy, dz, dx, dy, dz);
      }
      keep_best(best, candidate_word(d, first + s));
    }
  }
  // K rounds of the warp's least head; its lane moves on to its next
#pragma unroll
  for (int r = 0; r < K; ++r) {
    unsigned long long m = best[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, m, off);
      m = other < m ? other : m;
    }
    const bool mine = best[0] == m;
#pragma unroll
    for (int j = 0; j < K - 1; ++j) best[j] = mine ? best[j + 1] : best[j];
    best[K - 1] = mine ? kNone : best[K - 1];
    const unsigned idx = static_cast<unsigned>(m);
    const int cell27 = static_cast<int>(idx / static_cast<unsigned>(g.slots));
    const int s = static_cast<int>(idx - static_cast<unsigned>(cell27 * g.slots));
    const int at = __shfl_sync(0xffffffffu, start, cell27);
    d2[r] = __uint_as_float(static_cast<unsigned>(m >> 32));
    row[r] = min(at + s, n - 1);
  }
}

// The same, one thread calling: the 27 cells in turn, a candidate entering
// only where it beats the K-th kept one (then so would no later miss of the
// cell: misses come in index order behind every hit).
template <int K>
__device__ __forceinline__ void thread_k_nearest(const Grid& g, const float (&q)[3], float (&d2)[K], int (&row)[K]) {
  const int n = g.keys.n;
  unsigned long long best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    best[j] = kNone;
    row[j] = 0;
  }
  const int c[3] = {cell_floor_div(q[0], g.cell), cell_floor_div(q[1], g.cell), cell_floor_div(q[2], g.cell)};
  for (int cell27 = 0; cell27 < 27; ++cell27) {
    bool in_extent;
    const int key = neighbour_key(c, g.o, cell27, &in_extent);
    const unsigned first = static_cast<unsigned>(cell27 * g.slots);
    if (!in_extent) {
      for (int s = 0; s < g.slots; ++s) {
        const unsigned long long w = candidate_word(INFINITY, first + s);
        if (!(w < best[K - 1])) break;
        keep_best(best, row, w, min(g.miss_start + s, n - 1));
      }
      continue;
    }
    const int start = g.keys.lower_bound(key);
    for (int s = 0; s < g.slots; ++s) {
      const int idx = min(start + s, n - 1);
      float d = INFINITY;
      if (g.keys.key(idx) == key) {
        const float dx = q[0] - __ldg(g.xyz + 3 * idx + 0), dy = q[1] - __ldg(g.xyz + 3 * idx + 1),
                    dz = q[2] - __ldg(g.xyz + 3 * idx + 2);
        d = dot3_fma(dx, dy, dz, dx, dy, dz);
      }
      const unsigned long long w = candidate_word(d, first + s);
      if (w < best[K - 1]) keep_best(best, row, w, idx);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) d2[j] = __uint_as_float(static_cast<unsigned>(best[j] >> 32));
}

// G lanes a query: 32 (a warp, the cells over its lanes) or 1 (a thread)
template <int K, int G>
__device__ __forceinline__ void k_nearest(const Grid& g, const float (&q)[3], float (&d2)[K], int (&row)[K]) {
  if (G == 32)
    warp_k_nearest<K>(g, q, d2, row);
  else
    thread_k_nearest<K>(g, q, d2, row);
}

constexpr int kQueryThreads = 256;  // a query kernel's block

// Launches `kernel` over q queries, G lanes each: persistent blocks, as
// many as the card holds at once, or fewer where the queries need fewer.
template <int G, class... A, class... B>
int launch_query(void (*kernel)(A...), int q, cudaStream_t stream, B... args) {
  if (q <= 0) LVS_RETURN_LAST_ERROR();
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kQueryThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kPerBlock = kQueryThreads / G;
  const long long wanted = (static_cast<long long>(q) + kPerBlock - 1) / kPerBlock;
  const long long most = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  kernel<<<static_cast<int>(wanted < most ? wanted : most), kQueryThreads, 0, stream>>>(args...);
  LVS_RETURN_LAST_ERROR();
}

// A batch this large fills the card a thread a query; a smaller one takes a warp a query.
constexpr int kThreadQueries = 16384;

// Every thread of the block: the grid context, the keys staged.
__device__ __forceinline__ Grid grid_of(const int* __restrict__ keys, const float* __restrict__ xyz, int n,
                                        const int* __restrict__ origin, float cell, int slots, int* staged) {
  Grid g{stage_keys(keys, n, staged), xyz, {__ldg(origin + 0), __ldg(origin + 1), __ldg(origin + 2)}, cell, slots,
         0};
  g.miss_start = g.keys.lower_bound(kKeyMax);
  return g;
}

}  // namespace lvs
