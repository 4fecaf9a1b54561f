// Design variants of kernel 9g's one-launch cluster route
// (lv_slam_tpu_torch/csrc/knn_grid.cu `knn_grid_cluster`), for
// scripts/k9_variants.py: the same kernel with each word's place found by
// binary searches over distributed shared memory (`cluster_scatter`, as
// kernel 9a finds its rows' places) or over a copy of every block's sorted
// words in the block's own shared memory (`cluster_scatter_staged`, the
// shipped design); block 0's thread 0 stamps %globaltimer after each phase.
// Build: nvcc <kernels/_build.py's flags> -shared -I lv_slam_tpu_torch/csrc.
#include "cluster_sort.cuh"
#include "common.cuh"
#include "voxel_keys.cuh"

#include <limits.h>

namespace {

constexpr int kExtent = 1024, kKeyMax = 2147483647;
constexpr int kStamps = 8;

__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Staged: 0 searches over distributed shared memory, 1 over the block's copy.
template <int Staged>
__global__ void __cluster_dims__(kSortCtas, 1, 1) __launch_bounds__(kSortThreads)
variant_cluster(const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float inv,
                int* __restrict__ out_keys, float* __restrict__ out_xyz, int* __restrict__ origin,
                unsigned long long* stamps) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ u64 staged[];
  __shared__ u64 run[2 * kSortThreads];
  __shared__ u64 sorted[kSortThreads];
  __shared__ int warp_min[kSortThreads / 32][3];
  __shared__ int block_min[3];
  __shared__ int cluster_min[kSortCtas][3];
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool stamp = rank == 0 && tid == 0;
  if (stamp) stamps[0] = gtime();
  const long long i = static_cast<long long>(rank) * kSortThreads + tid;
  const bool live = i < n, on = live && mask[i];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int m = __reduce_min_sync(
        0xffffffffu, on ? static_cast<int>(floorf(xyz[3 * i + k] * inv)) : (live ? kBigX : INT_MAX));
    if (lane == 0) warp_min[warp][k] = m;
  }
  __syncthreads();
  if (tid < 3) {
    int r = INT_MAX;
    for (int w = 0; w < kSortThreads / 32; ++w) r = min(r, warp_min[w][tid]);
    block_min[tid] = r;
  }
  cluster.sync();
  if (stamp) stamps[1] = gtime();  // the block minima, across the cluster
  if (tid < 3 * kSortCtas) cluster_min[tid / 3][tid % 3] = cluster.map_shared_rank(block_min, tid / 3)[tid % 3];
  __syncthreads();
  int o[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int r = INT_MAX;
#pragma unroll
    for (int b = 0; b < kSortCtas; ++b) r = min(r, cluster_min[b][k]);
    o[k] = n == 0 || r == kBigX ? 0 : r;
  }
  u64 word = ~0ull;
  if (live) {
    int rel[3];
    const int key = flat_rel(xyz, 3, mask, 1, i, inv, o, kExtent, rel) ? (rel[0] * kExtent + rel[1]) * kExtent + rel[2]
                                                                       : kKeyMax;
    word = (static_cast<u64>(static_cast<unsigned>(key)) << 32) | static_cast<unsigned>(i);
  }
  __syncthreads();
  if (stamp) stamps[2] = gtime();  // the origin and the words
  run[tid] = warp_sort(word);
  __syncthreads();
  if (stamp) stamps[3] = gtime();  // the warps' sorts
  merge_runs(run);
  cluster.sync();
  if (stamp) stamps[4] = gtime();  // the block's merge
  if (Staged) cluster_scatter_staged(run + kSortThreads, sorted, staged, rank);
  else cluster_scatter<Narrow>(run + kSortThreads, sorted, rank);
  __syncthreads();
  if (stamp) stamps[5] = gtime();  // the places (and the copy)
  cluster.sync();
  if (stamp) stamps[6] = gtime();  // every word at its place
  if (live) {
    const u64 w = sorted[tid];
    const long long src = static_cast<long long>(w & 0xffffffffu);
    out_keys[i] = static_cast<int>(w >> 32);
#pragma unroll
    for (int k = 0; k < 3; ++k) out_xyz[3 * i + k] = xyz[3 * src + k];
  }
  if (rank == 0 && tid < 3) origin[tid] = o[tid];
  __syncthreads();
  if (stamp) stamps[7] = gtime();  // the outputs
}

}  // namespace

extern "C" int k9_variant_grid(int staged, const float* xyz, const bool* mask, int n, float inv, int* keys, float* out,
                               int* origin, unsigned long long* stamps, cudaStream_t stream) {
  if (n < 0 || n > kSortCtas * kSortThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (!staged) {
    variant_cluster<0><<<kSortCtas, kSortThreads, 0, stream>>>(xyz, mask, n, inv, keys, out, origin, stamps);
    LVS_RETURN_LAST_ERROR();
  }
  const int bytes = kSortCtas * kSortThreads * sizeof(u64);
  const cudaError_t err = cudaFuncSetAttribute(variant_cluster<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  variant_cluster<1><<<kSortCtas, kSortThreads, bytes, stream>>>(xyz, mask, n, inv, keys, out, origin, stamps);
  LVS_RETURN_LAST_ERROR();
}
