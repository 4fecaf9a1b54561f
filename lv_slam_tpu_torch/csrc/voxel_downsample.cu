// Kernel 1: voxel downsample (VOXELGRID centroid / APPROX_VOXELGRID cell
// center), after the voxel-key sort.
//
// Replaces: lv_slam_tpu/ops/prefilter.py:74 `voxel_downsample` (the
// reduce="scatter" path: run starts, segment sums, front-compacted output).
//
// What bounds it on the card: memory traffic and latency, not arithmetic. Per
// scan it reads 131072 sorted int64 keys, the permutation and the gathered
// xyz/intensity once, and writes out_cap rows; a few MB in all. At the 0.1 m
// flagship resolution most runs hold one or two points.
//
// Design: the wrapper sorts the packed 64-bit key (kx * 2^31 + kyz, which
// orders lanes exactly as the reference's two-key sort) and takes a prefix
// sum of the run-start flags that `mark_runs` writes. `reduce_runs` then runs
// one thread per run start, which walks its run sequentially: deterministic,
// no atomics, and the same summation order as the reference's in-order
// segment_sum. Output row r is run r, so the result is front-compacted in key
// order, which `stride_subsample` relies on. The same launch writes the
// sentinel padding of rows at or past the number of runs.
#include "common.cuh"

namespace {

constexpr long long kBig = 1LL << 30;  // kx of masked lanes
constexpr long long kYZMask = (1LL << 31) - 1;

__device__ __forceinline__ bool lane_valid(long long key) { return (key >> 31) < kBig; }

__global__ void mark_runs(const long long* __restrict__ skey, int n, int* __restrict__ flag) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long k = skey[i];
  bool start = (i == 0) || (k != skey[i - 1]);
  flag[i] = (start && lane_valid(k)) ? 1 : 0;
}

__global__ void reduce_runs(const long long* __restrict__ skey,
                            const long long* __restrict__ order,
                            const int* __restrict__ flag, const int* __restrict__ cum, int n,
                            const float* __restrict__ xyz, const float* __restrict__ inten,
                            float res, int approx, int out_cap, float* __restrict__ out_xyz,
                            float* __restrict__ out_int, bool* __restrict__ out_mask) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  int n_runs = n > 0 ? cum[n - 1] : 0;
  if (t < out_cap && t >= n_runs) {  // padding row
    out_xyz[3 * t + 0] = lvs::kSentinel;
    out_xyz[3 * t + 1] = lvs::kSentinel;
    out_xyz[3 * t + 2] = lvs::kSentinel;
    out_int[t] = 0.0f;
    out_mask[t] = false;
  }
  if (t >= n || !flag[t]) return;
  int row = cum[t] - 1;
  if (row >= out_cap) return;
  long long key = skey[t];
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, si = 0.0f, cnt = 0.0f;
  for (int j = t; j < n && skey[j] == key; ++j) {
    long long src = order[j];
    sx += xyz[3 * src + 0];
    sy += xyz[3 * src + 1];
    sz += xyz[3 * src + 2];
    si += inten[src];
    cnt += 1.0f;
  }
  if (approx) {
    long long kyz = key & kYZMask;
    int cx = static_cast<int>(key >> 31);
    int cy = static_cast<int>(kyz / 32768) - 16384;
    int cz = static_cast<int>(kyz % 32768) - 16384;
    out_xyz[3 * row + 0] = (static_cast<float>(cx) + 0.5f) * res;
    out_xyz[3 * row + 1] = (static_cast<float>(cy) + 0.5f) * res;
    out_xyz[3 * row + 2] = (static_cast<float>(cz) + 0.5f) * res;
  } else {
    out_xyz[3 * row + 0] = sx / cnt;
    out_xyz[3 * row + 1] = sy / cnt;
    out_xyz[3 * row + 2] = sz / cnt;
  }
  out_int[row] = si / cnt;
  out_mask[row] = true;
}

}  // namespace

extern "C" int lvs_voxel_mark_runs(const long long* skey, int n, int* flag, cudaStream_t stream) {
  if (n > 0) mark_runs<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(skey, n, flag);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_voxel_reduce_runs(const long long* skey, const long long* order,
                                     const int* flag, const int* cum, int n, const float* xyz,
                                     const float* inten, float res, int approx, int out_cap,
                                     float* out_xyz, float* out_int, bool* out_mask,
                                     cudaStream_t stream) {
  int threads = n > out_cap ? n : out_cap;
  if (threads > 0)
    reduce_runs<<<lvs::blocks_for(threads), lvs::kThreads, 0, stream>>>(
        skey, order, flag, cum, n, xyz, inten, res, approx, out_cap, out_xyz, out_int, out_mask);
  LVS_RETURN_LAST_ERROR();
}
