// Kernel 21: the evenly strided subsample of a front-compacted cloud (the
// host DLO's per-scan scan-matching subsample, and the fused odometry's
// `subsample_method="gather"`).
//
// Replaces: lv_slam_tpu/ops/prefilter.py:254 `uniform_subsample` (the count
// of set mask lanes, the float32 stride, the gather of the chosen rows).
//
// What bounds it on the card: bytes, and before them latency. A call reads
// the mask once (131072 bytes for a prefiltered KITTI-density scan) and
// reads and writes the out_cap chosen rows once (17 bytes a row, 65536
// rows): ~2.4 MB, 0.7 us at 3.35 TB/s. There are a few operations a row.
// The one dependency across lanes is the count, which every row's index
// needs: the plain version took a reduction, a dozen elementwise launches
// and three gathers for it.
//
// Design: one launch of G clusters of 8 blocks (`subsample_cluster`, G at
// most 16, enough clusters for one group of 4 rows a thread). Each cluster
// counts the whole mask: block r of the cluster counts the r-th eighth of it
// with 16-byte loads (a byte is set where it is not 0, as the twin's int32
// cast counts it), the block's count goes to its shared memory, and after one
// cluster barrier each warp sums the 8 counts over distributed shared memory.
// So no cluster waits on another and nothing is reset between calls; the
// mask is read from L2 once a cluster. Then each thread takes 4 consecutive
// rows: step = float(count) / float(max(take, 1)) (IEEE division), row i's
// index floor(i * step) as one rounded float32 product (`__fmul_rn`, so no
// flag can contract it), clamped to [0, n - 1]; its point, intensity and
// mask byte are gathered for rows below take = min(count, out_cap), the
// sentinel, 0 and false written past it, in 16-byte stores. A block arrives
// at a second cluster barrier when its warps have read the counts and waits
// on it before it exits, so no block's shared memory goes while another may
// read it. The output is the twin's bit for bit: integer counts, one
// division and one product rounded as the twin rounds them, and copies.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;       // blocks a cluster
constexpr int kMaxClusters = 16;  // the grid's clusters at most
constexpr int kRows = 4;          // consecutive output rows a thread

__device__ __forceinline__ int nonzero_bytes(unsigned w) { return __popc(__vcmpne4(w, 0u)) >> 3; }

// The set bytes of mask[lo, hi): 16-byte loads over the aligned middle,
// byte loads at either end.
__device__ __forceinline__ int count_mask(const bool* __restrict__ mask, long long lo, long long hi) {
  const unsigned char* m = reinterpret_cast<const unsigned char*>(mask);
  const long long base = reinterpret_cast<uintptr_t>(m) & 15;  // the pointer's misalignment
  long long a = ((lo + base + 15) & ~15ll) - base, b = ((hi + base) & ~15ll) - base;
  if (a > b) a = b = hi;
  int c = 0;
  for (long long i = lo + threadIdx.x; i < a; i += blockDim.x) c += m[i] != 0;
  const uint4* w = reinterpret_cast<const uint4*>(m + a);
  const long long n_words = (b - a) >> 4;
#pragma unroll 4
  for (long long i = threadIdx.x; i < n_words; i += blockDim.x) {
    const uint4 v = w[i];
    c += nonzero_bytes(v.x) + nonzero_bytes(v.y) + nonzero_bytes(v.z) + nonzero_bytes(v.w);
  }
  for (long long i = b + threadIdx.x; i < hi; i += blockDim.x) c += m[i] != 0;
  return c;
}

// The block's sum of one int a thread, in thread 0.
__device__ __forceinline__ int block_count(int c) {
  __shared__ int warps[lvs::kThreads / 32];
  c = lvs::warp_sum(c);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = c;
  __syncthreads();
  int s = 0;
  if (threadIdx.x == 0)
    for (int k = 0; k < lvs::kThreads / 32; ++k) s += warps[k];
  return s;
}

// Rows [4 g, 4 g + 4) of the output for thread group g: the twin's index,
// gather and fill.
__device__ __forceinline__ void write_rows(const float* __restrict__ xyz, const float* __restrict__ inten,
                                           const bool* __restrict__ mask, int n, int out_cap, int cnt, int g,
                                           float* __restrict__ out_xyz, float* __restrict__ out_int,
                                           bool* __restrict__ out_mask) {
  const int take = cnt < out_cap ? cnt : out_cap;
  const float step = __fdiv_rn(__int2float_rn(cnt), __int2float_rn(take > 1 ? take : 1));
  float p[kRows][4];
  bool m[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int i = kRows * g + k;
    if (i < take) {
      int idx = static_cast<int>(floorf(__fmul_rn(__int2float_rn(i), step)));
      idx = idx < 0 ? 0 : (idx > n - 1 ? n - 1 : idx);
      const long long at = idx;
      p[k][0] = xyz[3 * at + 0];
      p[k][1] = xyz[3 * at + 1];
      p[k][2] = xyz[3 * at + 2];
      p[k][3] = inten[at];
      m[k] = reinterpret_cast<const unsigned char*>(mask)[at] != 0;
    } else {
      p[k][0] = p[k][1] = p[k][2] = lvs::kSentinel;
      p[k][3] = 0.0f;
      m[k] = false;
    }
  }
  const long long i0 = static_cast<long long>(kRows) * g;
  if (i0 + kRows <= out_cap) {  // a whole group: 16-byte stores (the rows start 16-byte aligned)
    float4* ox = reinterpret_cast<float4*>(out_xyz + 3 * i0);
    ox[0] = make_float4(p[0][0], p[0][1], p[0][2], p[1][0]);
    ox[1] = make_float4(p[1][1], p[1][2], p[2][0], p[2][1]);
    ox[2] = make_float4(p[2][2], p[3][0], p[3][1], p[3][2]);
    *reinterpret_cast<float4*>(out_int + i0) = make_float4(p[0][3], p[1][3], p[2][3], p[3][3]);
    *reinterpret_cast<unsigned*>(out_mask + i0) =
        static_cast<unsigned>(m[0]) | (static_cast<unsigned>(m[1]) << 8) | (static_cast<unsigned>(m[2]) << 16) |
        (static_cast<unsigned>(m[3]) << 24);
  } else {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const long long i = i0 + k;
      if (i >= out_cap) break;
      out_xyz[3 * i + 0] = p[k][0];
      out_xyz[3 * i + 1] = p[k][1];
      out_xyz[3 * i + 2] = p[k][2];
      out_int[i] = p[k][3];
      out_mask[i] = m[k];
    }
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(lvs::kThreads)
subsample_cluster(const float* __restrict__ xyz, const float* __restrict__ inten, const bool* __restrict__ mask,
                  int n, int out_cap, float* __restrict__ out_xyz, float* __restrict__ out_int,
                  bool* __restrict__ out_mask) {
  __shared__ int count;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long lo = static_cast<long long>(n) * rank / kCluster;
  const long long hi = static_cast<long long>(n) * (rank + 1) / kCluster;
  const int c = block_count(count_mask(mask, lo, hi));
  if (threadIdx.x == 0) count = c;
  cluster.sync();  // every block's count is in its shared memory
  const int lane = threadIdx.x & 31;
  int total = lane < kCluster ? *cluster.map_shared_rank(&count, lane) : 0;
  total = __reduce_add_sync(0xffffffffu, total);
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");  // this block reads no other's memory now
  const int groups = (out_cap + kRows - 1) / kRows;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += gridDim.x * blockDim.x)
    write_rows(xyz, inten, mask, n, out_cap, total, g, out_xyz, out_int, out_mask);
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // no block exits while another may read it
}

// The grid's clusters: enough for one group of kRows rows a thread, at most
// kMaxClusters.
inline int clusters_for(int out_cap) {
  const long long groups = (static_cast<long long>(out_cap) + kRows - 1) / kRows;
  const long long per_cluster = static_cast<long long>(kCluster) * lvs::kThreads;
  const long long g = (groups + per_cluster - 1) / per_cluster;
  return static_cast<int>(g < 1 ? 1 : (g > kMaxClusters ? kMaxClusters : g));
}

bool aligned(const void* p, uintptr_t to) { return (reinterpret_cast<uintptr_t>(p) & (to - 1)) == 0; }

}  // namespace

// out_cap rows of the subsample of n lanes (0 < out_cap < n); out_xyz and
// out_int 16-byte aligned, out_mask 4-byte aligned
extern "C" int lvs_uniform_subsample(const float* xyz, const float* inten, const bool* mask, int n, int out_cap,
                                     float* out_xyz, float* out_int, bool* out_mask, cudaStream_t stream) {
  if (n < 1 || out_cap < 1 || out_cap >= n || !aligned(out_xyz, 16) || !aligned(out_int, 16) ||
      !aligned(out_mask, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  subsample_cluster<<<kCluster * clusters_for(out_cap), lvs::kThreads, 0, stream>>>(xyz, inten, mask, n, out_cap,
                                                                                     out_xyz, out_int, out_mask);
  LVS_RETURN_LAST_ERROR();
}
