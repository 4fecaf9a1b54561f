// Kernel 14: the 0.25 m centroid grid of the fitness score, and its
// nearest-centroid queries.
//
// Replaces: lv_slam_tpu/ops/nn.py:42 `build_centroid_grid` and :86
// `nn_sq_dists` (with the masked mean of :129 `fitness_score` and of the
// loop verification's `fit_one`, lv_slam_tpu/graph/loop_detector.py:109).
//
// What bounds it on the card: the build reads one sorted run of 131072
// points and writes 65536 leaves, a few MB: memory latency. The query does
// 27 binary searches of ~17 steps over 256 KB of keys per point; the keys
// and centroids stay in L2, so the dependent loads bound it, not HBM.
//
// Design: the wrapper computes the flat int32 cell keys and sorts them
// stably (torch glue, as for kernel 1). `grid_mark` flags run starts,
// a prefix sum numbers the runs, and `grid_reduce` runs one thread per run
// start that walks its run in sorted order (the reference's in-order
// segment sum), so leaf r is run r: keys come out ascending, runs past
// `leaf_cap` are dropped as the reference drops them, and the result is
// deterministic. `grid_query` runs one thread per (candidate, point): it
// moves the point by the candidate's transform (the fma chain XLA makes of
// `transform_points` on the CPU), looks each of the 27 neighbour cells up by
// binary search over the sorted keys (the reference's `searchsorted`, so
// the hit sets are identical), keeps the least squared distance to a hit
// centroid (+inf on a miss), and reduces (sum of finite d2 within range,
// their count) per block; `grid_finish` adds a candidate's block partials
// in a fixed order and writes its mean, +inf when nothing was in range.
#include "common.cuh"

namespace {

constexpr int kKeyMax = 2147483647;  // INT32_MAX: cells out of the extent
constexpr int kWarps = lvs::kThreads / 32;

__global__ void grid_mark(const int* __restrict__ skey, int n, int* __restrict__ flag) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int k = skey[i];
  flag[i] = ((i == 0 || k != skey[i - 1]) && k != kKeyMax) ? 1 : 0;
}

__global__ void grid_reduce(const int* __restrict__ skey, const long long* __restrict__ order,
                            const int* __restrict__ flag, const int* __restrict__ cum, int n,
                            const float* __restrict__ xyz, int leaf_cap, int* __restrict__ keys,
                            float* __restrict__ centroids, float* __restrict__ counts) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  int n_runs = n > 0 ? cum[n - 1] : 0;
  if (t < leaf_cap && t >= n_runs) {  // leaves past the last occupied cell
    keys[t] = kKeyMax;
    centroids[3 * t + 0] = lvs::kSentinel;
    centroids[3 * t + 1] = lvs::kSentinel;
    centroids[3 * t + 2] = lvs::kSentinel;
    counts[t] = 0.0f;
  }
  if (t >= n || !flag[t]) return;
  int row = cum[t] - 1;
  if (row >= leaf_cap) return;
  int key = skey[t];
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, cnt = 0.0f;
  for (int j = t; j < n && skey[j] == key; ++j) {
    long long src = order[j];
    sx += xyz[3 * src + 0];
    sy += xyz[3 * src + 1];
    sz += xyz[3 * src + 2];
    cnt += 1.0f;
  }
  keys[row] = key;
  centroids[3 * row + 0] = sx / cnt;
  centroids[3 * row + 1] = sy / cnt;
  centroids[3 * row + 2] = sz / cnt;
  counts[row] = cnt;
}

// first index of `keys` (ascending, length m) holding a value >= q
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys, int m, int q) {
  int lo = 0, hi = m;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// grid (n_blocks, k): block b of candidate c covers its points b*256 ..
__global__ void __launch_bounds__(lvs::kThreads)
grid_query(const int* __restrict__ keys, const float* __restrict__ centroids, int leaf_cap,
           const int* __restrict__ origin, float inv_res, int e, const float* __restrict__ pts,
           const bool* __restrict__ mask, int n, const float* __restrict__ transforms, float max_d2,
           float* __restrict__ d2_out, float* __restrict__ partials) {
  __shared__ float smem[2][kWarps];
  int c = blockIdx.y;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  float best = INFINITY;
  if (i < n && mask[static_cast<long long>(c) * n + i]) {
    const float* p = pts + 3 * (static_cast<long long>(c) * n + i);
    float y[3] = {p[0], p[1], p[2]};
    if (transforms != nullptr) {
      const float* T = transforms + 16 * c;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        float acc = p[0] * T[4 * r + 0];
        acc = fmaf(p[1], T[4 * r + 1], acc);
        acc = fmaf(p[2], T[4 * r + 2], acc);
        y[r] = acc + T[4 * r + 3];
      }
    }
    int cell[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) cell[r] = static_cast<int>(floorf(y[r] * inv_res)) - origin[r];
    for (int o = 0; o < 27; ++o) {
      int r0 = cell[0] + o / 9 - 1, r1 = cell[1] + (o / 3) % 3 - 1, r2 = cell[2] + o % 3 - 1;
      if (r0 < 0 || r0 >= e || r1 < 0 || r1 >= e || r2 < 0 || r2 >= e) continue;
      int q = (r0 * e + r1) * e + r2;
      int idx = lower_bound(keys, leaf_cap, q);
      if (idx >= leaf_cap) idx = leaf_cap - 1;
      if (__ldg(keys + idx) != q) continue;
      float dx = y[0] - centroids[3 * idx + 0];
      float dy = y[1] - centroids[3 * idx + 1];
      float dz = y[2] - centroids[3 * idx + 2];
      float d2 = dx * dx + dy * dy + dz * dz;
      best = fminf(best, d2);
    }
  }
  if (d2_out != nullptr && i < n) d2_out[static_cast<long long>(c) * n + i] = best;
  bool ok = isfinite(best) && best <= max_d2;
  float s = warp_sum(ok ? best : 0.0f), m = warp_sum(ok ? 1.0f : 0.0f);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    smem[0][warp] = s;
    smem[1][warp] = m;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float v = 0.0f;
    for (int w = 0; w < kWarps; ++w) v += smem[threadIdx.x][w];
    partials[2 * (static_cast<long long>(c) * gridDim.x + blockIdx.x) + threadIdx.x] = v;
  }
}

// one thread per candidate: its block partials in order -> the masked mean
__global__ void grid_finish(const float* __restrict__ partials, int n_blocks, int k,
                            float* __restrict__ out) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= k) return;
  float total = 0.0f, cnt = 0.0f;
  for (int b = 0; b < n_blocks; ++b) {
    total += partials[2 * (static_cast<long long>(c) * n_blocks + b) + 0];
    cnt += partials[2 * (static_cast<long long>(c) * n_blocks + b) + 1];
  }
  out[c] = cnt > 0.0f ? total / cnt : INFINITY;
}

}  // namespace

extern "C" int lvs_grid_mark(const int* skey, int n, int* flag, cudaStream_t stream) {
  if (n > 0) grid_mark<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(skey, n, flag);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_grid_reduce(const int* skey, const long long* order, const int* flag, const int* cum,
                               int n, const float* xyz, int leaf_cap, int* keys, float* centroids,
                               float* counts, cudaStream_t stream) {
  int threads = n > leaf_cap ? n : leaf_cap;
  if (threads > 0)
    grid_reduce<<<lvs::blocks_for(threads), lvs::kThreads, 0, stream>>>(
        skey, order, flag, cum, n, xyz, leaf_cap, keys, centroids, counts);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_grid_query(const int* keys, const float* centroids, int leaf_cap, const int* origin,
                              float inv_res, int e, const float* pts, const bool* mask, int n, int k,
                              const float* transforms, float max_d2, float* d2_out, float* partials,
                              int n_blocks, float* out, cudaStream_t stream) {
  if (k > 0 && n_blocks > 0) {
    grid_query<<<dim3(n_blocks, k), lvs::kThreads, 0, stream>>>(
        keys, centroids, leaf_cap, origin, inv_res, e, pts, mask, n, transforms, max_d2, d2_out,
        partials);
    grid_finish<<<lvs::blocks_for(k), lvs::kThreads, 0, stream>>>(partials, n_blocks, k, out);
  }
  LVS_RETURN_LAST_ERROR();
}
