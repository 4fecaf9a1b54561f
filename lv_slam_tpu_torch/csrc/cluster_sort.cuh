// The sort of up to 8192 64-bit keys by one launch of one 8-block cluster
// (1024 threads a block, a key a thread), shared by kernel 9a's insert
// (csrc/cell_table.cu, its one-word and two-word keys) and kernel 9g's
// build of up to 8192 lanes (csrc/knn_grid.cu, one-word keys). Each block
// sorts its 1024 keys: a bitonic sort of each warp's 32 in registers over
// shuffles (`warp_sort`), then five merge-path rounds in shared memory
// (`merge_runs`); a key's place in the cluster's order is its rank in its
// block plus, in every other block, the count of keys before it, ties to
// the lower block (`cluster_scatter`: ten-step binary searches over
// distributed shared memory, the blocks in lockstep; or, with the other
// blocks' keys first copied into the block's own shared memory,
// `cluster_scatter_staged`), and it is stored in the block that owns that
// place. Callers make their keys distinct (the row
// or lane in the low bits), so the order is that of a stable sort.
// Everything sits in an anonymous namespace: each source that includes the
// file has its own copy.
#pragma once

#include <cooperative_groups.h>

namespace {

constexpr int kSortCtas = 8;         // one thread-block cluster, the portable size
constexpr int kSortThreads = 1024;   // per block, one key a thread

typedef unsigned long long u64;

// A sort key. Narrow: one word (kernel 9a's packed (bucket, vx, cy, cz,
// row) fields of `ops/knn.py` `insert_sort_keys`, offset by the batch's
// minima; kernel 9g's flat cell key << 32 | lane); wide: two words (kernel
// 9a's (bucket << 32 | vx ^ 2^31, vyz << 32 | row)). Rows are distinct
// keys, so any sort of them is the reference's stable sort.
struct Narrow {
  u64 k;
};
struct Wide {
  u64 hi, lo;
};

__device__ __forceinline__ bool key_lt(const Narrow& a, const Narrow& b) { return a.k < b.k; }
__device__ __forceinline__ bool key_lt(const Wide& a, const Wide& b) {
  return a.hi < b.hi || (a.hi == b.hi && a.lo < b.lo);
}

// The sorted keys in shared memory: narrow keys one word each, wide keys
// two arrays of words.
__device__ __forceinline__ Narrow key_at(const u64* sm, int, int p, Narrow) { return {sm[p]}; }
__device__ __forceinline__ Wide key_at(const u64* sm, int n_pad, int p, Wide) { return {sm[p], sm[n_pad + p]}; }
__device__ __forceinline__ void put_key(u64* sm, int, int p, const Narrow& a) { sm[p] = a.k; }
__device__ __forceinline__ void put_key(u64* sm, int n_pad, int p, const Wide& a) {
  sm[p] = a.hi;
  sm[n_pad + p] = a.lo;
}

// Ascending bitonic sort of a warp's 32 one-word keys, one a lane, over
// shuffles: stage (ks, s) pairs lane l with l ^ 2^s, ascending where bit ks
// of l is 0 (every warp ascending at the last size).
__device__ __forceinline__ u64 warp_sort(u64 v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 1; ks <= 5; ++ks) {
#pragma unroll
    for (int s = ks - 1; s >= 0; --s) {
      const int j = 1 << s, k = ks == 5 ? 0 : 1 << ks;
      const u64 o = __shfl_xor_sync(0xffffffffu, v, j);
      const bool take_min = ((lane & j) == 0) == ((lane & k) == 0);  // lower half where ascending
      v = ((o < v) == take_min) ? o : v;
    }
  }
  return v;
}

// Merges a block's 32 warp-sorted runs of 32 keys (at sm[0 .. 1024)) in
// five rounds of pairwise merges; thread t writes output t, taken at the
// split that a binary search along its diagonal finds (merge path), ties to
// the first run. The sorted keys end at sm[1024 .. 2048).
__device__ void merge_runs(u64* sm) {
  u64 *src = sm, *dst = sm + kSortThreads;
  const int pos = threadIdx.x;
#pragma unroll 1
  for (int r = 32; r < kSortThreads; r <<= 1) {
    const int base = pos & ~(2 * r - 1), d = pos - base;
    int lo = max(0, d - r), hi = min(d, r);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (src[base + mid] <= src[base + r + d - 1 - mid]) lo = mid + 1;
      else hi = mid;
    }
    const int i = lo, j = d - lo;
    const u64 a = i < r ? src[base + i] : 0, b = j < r ? src[base + r + j] : 0;
    dst[pos] = i < r && (j >= r || a <= b) ? a : b;
    __syncthreads();
    u64* t = src;
    src = dst;
    dst = t;
  }
}

// The cluster's sort from each block's locally sorted keys (at `local`):
// a key's position is its rank in its block plus, for every other block,
// the number of that block's keys before it (keys ordered, ties to the
// lower block), found by ten-step binary searches over distributed shared
// memory, all blocks' in lockstep. Each key goes to the block that owns
// its position (positions rank * 1024 .. rank * 1024 + 1023).
template <typename K>
__device__ void cluster_scatter(const u64* local, u64* sorted, int rank) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const K mine = key_at(local, kSortThreads, tid, K{});
  const u64* other[kSortCtas];
  int count[kSortCtas];
#pragma unroll
  for (int c = 0; c < kSortCtas; ++c) {
    other[c] = cluster.map_shared_rank(local, c);
    count[c] = 0;
  }
#pragma unroll
  for (int step = kSortThreads / 2; step >= 1; step >>= 1) {
#pragma unroll
    for (int c = 0; c < kSortCtas; ++c) {
      if (c == rank) continue;
      const K key = key_at(other[c], kSortThreads, count[c] + step - 1, K{});
      if (c < rank ? !key_lt(mine, key) : key_lt(key, mine)) count[c] += step;
    }
  }
  int g = tid;
#pragma unroll
  for (int c = 0; c < kSortCtas; ++c) {
    if (c == rank) continue;
    const K key = key_at(other[c], kSortThreads, count[c], K{});  // the last probe: counts of 1024
    g += count[c] + (count[c] == kSortThreads - 1 && (c < rank ? !key_lt(mine, key) : key_lt(key, mine)));
  }
  u64* dst = cluster.map_shared_rank(sorted, g / kSortThreads);
  put_key(dst, kSortThreads, g % kSortThreads, mine);
}

// `cluster_scatter` for one-word keys with every block's sorted keys (at
// `local`) first copied into the block's `staged` (kSortCtas * 1024 words
// of shared memory): one coalesced read of each other block's memory a
// thread, then the binary searches in the block's own shared memory, where
// they cost a fraction of the same searches over distributed shared memory.
// The places are those of `cluster_scatter<Narrow>`.
__device__ __forceinline__ void cluster_scatter_staged(const u64* local, u64* sorted, u64* staged, int rank) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < kSortCtas; ++c)
    if (c != rank) staged[c * kSortThreads + tid] = cluster.map_shared_rank(local, c)[tid];
  __syncthreads();
  const u64 mine = local[tid];
  int g = tid;
#pragma unroll
  for (int c = 0; c < kSortCtas; ++c) {
    if (c == rank) continue;
    const u64* other = staged + c * kSortThreads;
    int count = 0;
#pragma unroll
    for (int step = kSortThreads / 2; step >= 1; step >>= 1) {
      const u64 key = other[count + step - 1];
      if (c < rank ? !(mine < key) : key < mine) count += step;
    }
    const u64 key = other[count];  // the last probe: counts of 1024
    g += count + (count == kSortThreads - 1 && (c < rank ? !(mine < key) : key < mine));
  }
  cluster.map_shared_rank(sorted, g / kSortThreads)[g % kSortThreads] = mine;
}

}  // namespace
