// Kernel 14: the 0.25 m centroid grid of the fitness score, and its
// nearest-centroid queries; kernels 17 and 18, the other queries of the grid.
//
// Replaces: lv_slam_tpu/ops/nn.py:42 `build_centroid_grid` and :86
// `nn_sq_dists` (with the masked mean of :129 `fitness_score` and of the
// loop verification's `fit_one`, lv_slam_tpu/graph/loop_detector.py:109);
// K17: :107 `nn_points` with the fixed-trip body of lv_slam_tpu/ops/icp.py:29
// `icp_align`; K18: :151 `radius_outlier_removal` and :174
// `statistical_outlier_removal`.
//
// What bounds it on the card: the build reads 131072 points and writes
// 65536 leaves, a few MB: its launches' latency (the sort's look-backs) and
// the longest run's chain. The query reads each point once; the keys (256
// KB) and centroids stay in L2, so its dependent loads bound it, not HBM.
//
// Build design (`lvs_centroid_grid`, one C call of 7 launches, no host read
// and no torch op between them; kernel 3's flat-key front end, run walk,
// partial rows and scratch layout from csrc/voxel_keys.cuh, its passes from
// csrc/key_sort.cuh):
// 1. `grid_ranges`: each block's masked minimum, maximum and unmasked count
//    of the cells floor(x * (1/res)) to its partial row (`flat_ranges`); the
//    same launch zeroes the sort's words and pads every leaf (INT32_MAX, the
//    sentinel, count 0): the run pass overwrites the leaves that runs reach.
// 2. `grid_keys` (`flat_keys`, e = 1024): the origin is the masked minimum
//    cell, 0 where no lane is unmasked; an in-extent lane's (rel0, rel1,
//    rel2) packed into the fewest bits (the flat key's order), others
//    dropped; the digits counted for the sort.
// 3. Four launches of `key_sort_pass` (30 bits at most; a pass past the
//    key's width returns on the device word): stable, so a cell's points
//    keep their input order.
// 4. `grid_runs` (`run_leaves`): run starts numbered by decoupled look-back
//    give the leaf; the run's thread walks its points in sorted order (the
//    reference's in-order segment sum), so leaf r is run r, keys come out
//    ascending and runs past `leaf_cap` are dropped, as the reference drops
//    them. The sums and the division are those of the design this replaced
//    (`grid_reduce` after torch.sort), so the grid is bit for bit its grid
//    (`scripts/k14_parent.py` holds it so on the card).
//
// Query design (`probe27`, shared by `grid_query`, K17's `nn_probe` and
// K18's `neighbour_count`): the flat key (r0 * e + r1) * e + r2 has z
// innermost, so the 27 cells are 9 (x, y) columns of three consecutive
// keys. One lower bound a column, for its lowest in-extent z key, finds all
// three: keys are unique and ascending, so the next at most three keys
// decide the column's cells. The 9 searches run side by side, branch-free,
// their first ~10 steps over a sample of the sorted keys staged in shared
// memory (every ceil(leaf_cap / 1024)-th, at most 4 KB), the last ~6 over
// the keys themselves. A column whose x or y is out of the extent misses
// whole; a z out of it misses only its cell. Cells are visited in `_OFF27`
// order, so the hit set, `fminf`, `nn_probe`'s first minimum and K18's count
// sums are those of the 27 binary searches this replaced (the reference's
// `searchsorted`).
//
// `grid_query` runs one thread per (candidate, point), on a grid that fills
// the card once (a block stages the sample, then takes 256-point tiles): it
// moves the point by the candidate's transform (the fma chain XLA makes of
// `transform_points` on the CPU), keeps the least squared distance to a hit
// centroid (+inf on a miss), and reduces (sum of finite d2 within range,
// their count) per tile; `grid_finish`, a block per candidate, stages its
// tile partials in shared memory and adds them in tile order
// (`staged_column_sum`, which the ICP and statistical reductions share: one
// thread's ordered adds no longer wait on a global load each), and writes
// its mean, +inf when nothing was in range.
//
// K17 and K18 take the same probe. `nn_probe` keeps the argmin
// centroid (the first in `_OFF27` order, as `jnp.argmin`; leaf 0's centroid
// on a miss, as the reference's `where(hit, idx, 0)` gather), its squared
// distance the fma chain XLA makes of `jnp.sum(d ** 2, -1)` on the CPU.
// One ICP iteration is `icp_match` (move each source point by the transform
// as XLA's fma chain, `nn_probe`, the weight w = valid & d2 < max_d2, block
// partials of w, w y, w nn and w d2), `icp_means` (the partials in a fixed
// order: count, the two means, the fitness), `icp_cov` (block partials of
// the centred cross-covariance (y - mu_y) w (nn - mu_n)^T: the second pass
// keeps the digits a one-pass uncentred float32 sum loses at tens of metres)
// and `icp_update`: one thread takes the Kabsch rotation from the 3x3 SVD in
// float64 (Jacobi eigenvectors V of C^T C, U's first two columns C v / |C v|,
// the third their cross product, R = V diag(1, 1, det V) U^T, which is the
// reference's V diag(1, 1, sign det(V U^T)) U^T whatever the sign of U's
// third column) and composes the update on the device: no host read in the
// loop. `outlier_radius` sums the counts of the hit cells and keeps
// count - 1 >= min_neighbors; `stat_dist` turns the same sum into the
// isolation distance cbrt(k (1.5 m)^3 / max(density, 1)) (the root in
// float64, rounded), and `stat_mean` / `stat_var` / `stat_keep` threshold it
// at mean + m std over the masked lanes, each sum a float64 one (block
// partials added in a fixed order) rounded to float32 once, so that the
// plain twin's float64 sums give the same threshold. Only masked-in lanes
// are probed; dropped lanes take the sentinel; nothing is compacted.
#include "common.cuh"
#include "key_sort.cuh"
#include "voxel_keys.cuh"

namespace {

constexpr int kKeyMax = 2147483647;  // INT32_MAX: cells out of the extent
constexpr int kWarps = lvs::kThreads / 32;

constexpr int kExtent = 1024;   // cells per axis: 1024^3 flat keys fit int32
constexpr int kGridPasses = 4;  // digit passes of a 30-bit packed key

__global__ void __launch_bounds__(lvs::kThreads)
grid_ranges(const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float inv, int* __restrict__ part,
            unsigned* __restrict__ zero, long long n_zero, int leaf_cap, int* __restrict__ keys,
            float* __restrict__ centroids, float* __restrict__ counts, int* __restrict__ origin) {
  flat_ranges(xyz, 3, mask, 1, n, inv, part, zero, n_zero);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = first; i < 3ll * leaf_cap; i += stride) centroids[i] = lvs::kSentinel;
  for (long long i = first; i < leaf_cap; i += stride) {
    keys[i] = kKeyMax;
    counts[i] = 0.0f;
  }
  if (first == 0) origin[0] = origin[1] = origin[2] = 0;  // for n = 0, where no keys pass runs
}

__global__ void __launch_bounds__(lvs::kThreads)
grid_keys(const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float inv,
          const int* __restrict__ part, int n_part, FlatControl* fc, int* __restrict__ origin_cell,
          unsigned long long* __restrict__ keys) {
  flat_keys(xyz, 3, mask, 1, n, inv, kExtent, part, n_part, fc, origin_cell, keys);
}

// One cell's sums, point by point in sorted order.
struct GridSums {
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, cnt = 0.0f;
};

__global__ void __launch_bounds__(ks::kThreads)
grid_runs(const unsigned long long* __restrict__ keys_a, const unsigned* __restrict__ vals_a,
          const unsigned long long* __restrict__ keys_b, const unsigned* __restrict__ vals_b, FlatControl* fc,
          unsigned* run_status, const float* __restrict__ xyz, int leaf_cap, int* __restrict__ keys,
          float* __restrict__ centroids, float* __restrict__ counts) {
  const auto add = [](GridSums& s, const float4& p) {
    s.sx += p.x;
    s.sy += p.y;
    s.sz += p.z;
    s.cnt += 1.0f;
  };
  const auto write = [&](const GridSums& s, unsigned row, unsigned long long key) -> unsigned {
    keys[row] = flat_key(key, fc->b1, fc->b2, kExtent);
    centroids[3 * row + 0] = s.sx / s.cnt;
    centroids[3 * row + 1] = s.sy / s.cnt;
    centroids[3 * row + 2] = s.sz / s.cnt;
    counts[row] = s.cnt;
    return 1u;
  };
  unsigned mine;
  run_leaves<GridSums>(keys_a, vals_a, keys_b, vals_b, &fc->sort, &fc->sort.tickets[ks::kMaxPasses], run_status, xyz,
                       3, leaf_cap, add, write, mine);
}

constexpr int kSamples = 1024;  // sorted keys a block stages in shared memory

// Every stride-th key (at most kSamples of them) in shared memory, where a
// search takes its first steps.
struct KeySample {
  const int* at;  // shared memory: keys[j * stride], j < count
  int stride, count;
};

// The whole block; ends with a barrier.
__device__ __forceinline__ KeySample stage_sample(const int* __restrict__ keys, int m, int* sample) {
  KeySample s;
  s.at = sample;
  s.stride = max(1, (m + kSamples - 1) / kSamples);
  s.count = m > 0 ? (m + s.stride - 1) / s.stride : 0;
  for (int j = threadIdx.x; j < s.count; j += blockDim.x) sample[j] = __ldg(keys + static_cast<long long>(j) * s.stride);
  __syncthreads();
  return s;
}

// keys[i], INT32_MAX past the last leaf (above every query)
__device__ __forceinline__ int key_at(const int* __restrict__ keys, int m, int i) {
  return i < m ? __ldg(keys + i) : kKeyMax;
}

constexpr int kColumns = 9;  // the (x, y) columns of the 27 cells

// a + b in int32, wrapping as the reference's int32 cell offsets
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
constexpr int kDead = -2147483647 - 1;  // a dead column's search key: below every key, its search stays at 0

// The hit leaves of the 27 cells around `cell` (relative to the grid's
// origin), `visit(leaf)` for each in `_OFF27` order: one lower bound a
// column (module comment), the 9 side by side.
template <typename Visit>
__device__ __forceinline__ void probe27(const int* __restrict__ keys, int m, const KeySample& s, int e,
                                        const int cell[3], Visit visit) {
  int z0 = 3, n_z = 0;  // the first in-extent z offset and the in-extent z cells, alike in every column
#pragma unroll
  for (int d = 2; d >= 0; --d) {
    const int r2 = wrap_add(cell[2], d - 1);
    const bool in = r2 >= 0 && r2 < e;
    z0 = in ? d : z0;
    n_z += in;
  }
  int q[kColumns], nz[kColumns], pos[kColumns];
#pragma unroll
  for (int c = 0; c < kColumns; ++c) {
    const int r0 = wrap_add(cell[0], c / 3 - 1), r1 = wrap_add(cell[1], c % 3 - 1);
    const bool live = r0 >= 0 && r0 < e && r1 >= 0 && r1 < e && n_z > 0 && m > 0;
    nz[c] = live ? n_z : 0;
    q[c] = live ? (r0 * e + r1) * e + cell[2] + z0 - 1 : kDead;
    pos[c] = 0;
  }
  // the samples below q (the same steps for every column)
  for (int len = s.count; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int c = 0; c < kColumns; ++c) pos[c] = s.at[pos[c] + half] < q[c] ? pos[c] + half : pos[c];
    len -= half;
  }
#pragma unroll
  for (int c = 0; c < kColumns; ++c) {
    const int j = pos[c] + (s.count > 0 && s.at[pos[c]] < q[c]);
    pos[c] = j == 0 ? 0 : (j - 1) * s.stride + 1;  // the lower bound lies in [pos, pos + stride - 1]
  }
  for (int len = s.stride - 1; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int c = 0; c < kColumns; ++c) pos[c] = key_at(keys, m, pos[c] + half) < q[c] ? pos[c] + half : pos[c];
    len -= half;
  }
  if (s.stride > 1) {
#pragma unroll
    for (int c = 0; c < kColumns; ++c) pos[c] += key_at(keys, m, pos[c]) < q[c];
  }
  // a column's cells: the next at most three keys, read together
  int k[kColumns][3];
#pragma unroll
  for (int c = 0; c < kColumns; ++c) {
#pragma unroll
    for (int t = 0; t < 3; ++t) k[c][t] = t < nz[c] ? key_at(keys, m, pos[c] + t) : kKeyMax;
  }
#pragma unroll
  for (int c = 0; c < kColumns; ++c) {
    int p = 0;  // keys taken by the column's earlier cells
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int want = q[c] + t;
      const bool hit = t < nz[c] && ((p == 0 && k[c][0] == want) || (p == 1 && k[c][1] == want) ||
                                     (p == 2 && k[c][2] == want));
      if (hit) {
        visit(pos[c] + p);
        ++p;
      }
    }
  }
}

using lvs::warp_sum;

__device__ __forceinline__ void cell_of(const float* y, float inv_res, const int* __restrict__ origin, int cell[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) cell[r] = lvs::cell_floor(y[r], inv_res) - origin[r];
}

// Tile b of candidate c covers its points b*256 ..; a block stages the
// sample once and takes tiles (c, b) = divmod(t, n_blocks) for t =
// blockIdx.x, blockIdx.x + gridDim.x, ...: each tile's partials are those
// of a block per tile.
__global__ void __launch_bounds__(lvs::kThreads)
grid_query(const int* __restrict__ keys, const float* __restrict__ centroids, int leaf_cap,
           const int* __restrict__ origin, float inv_res, int e, const float* __restrict__ pts,
           const bool* __restrict__ mask, int n, int k, int n_blocks, const float* __restrict__ transforms,
           float max_d2, float* __restrict__ d2_out, float* __restrict__ partials) {
  __shared__ float smem[2][kWarps];
  __shared__ int sample[kSamples];
  const KeySample sampled = stage_sample(keys, leaf_cap, sample);
  for (long long tile = blockIdx.x; tile < static_cast<long long>(k) * n_blocks; tile += gridDim.x) {
    const int c = static_cast<int>(tile / n_blocks), b = static_cast<int>(tile % n_blocks);
    int i = b * blockDim.x + threadIdx.x;
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
      cell_of(y, inv_res, origin, cell);
      probe27(keys, leaf_cap, sampled, e, cell, [&](int idx) {
        float dx = y[0] - centroids[3 * idx + 0];
        float dy = y[1] - centroids[3 * idx + 1];
        float dz = y[2] - centroids[3 * idx + 2];
        float d2 = dx * dx + dy * dy + dz * dz;
        best = fminf(best, d2);
      });
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
      partials[2 * (static_cast<long long>(c) * n_blocks + b) + threadIdx.x] = v;
    }
    __syncthreads();  // smem is the next tile's
  }
}

constexpr int kStageRows = 512;  // partial rows a block stages in shared memory at a time

// Thread t < M's sum of column t of `partials` (n_rows rows of M values) in
// row order, as `lvs::column_sum` adds it: the block stages kStageRows rows
// at a time in shared memory with coalesced loads, and each column's thread
// adds from there, not a global load's latency an add. Every thread of the
// block calls it; the others get 0.
template <int M, typename T>
__device__ __forceinline__ T staged_column_sum(const T* __restrict__ partials, int n_rows) {
  __shared__ T stage[kStageRows * M];
  T sum = 0;
  for (int r0 = 0; r0 < n_rows; r0 += kStageRows) {
    const int rows = min(kStageRows, n_rows - r0);
    for (int i = threadIdx.x; i < rows * M; i += blockDim.x) stage[i] = partials[static_cast<long long>(r0) * M + i];
    __syncthreads();
    if (threadIdx.x < M) {
#pragma unroll 8
      for (int r = 0; r < rows; ++r) sum += stage[r * M + threadIdx.x];
    }
    __syncthreads();
  }
  return sum;
}

// a block per candidate: its block partials in order -> the masked mean
__global__ void __launch_bounds__(lvs::kThreads)
grid_finish(const float* __restrict__ partials, int n_blocks, float* __restrict__ out) {
  __shared__ float s[2];
  const float v = staged_column_sum<2>(partials + 2 * static_cast<long long>(blockIdx.x) * n_blocks, n_blocks);
  if (threadIdx.x < 2) s[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = s[1] > 0.0f ? s[0] / s[1] : INFINITY;
}

// The nearest hit centroid of y among the 27 cells: its squared distance
// (+inf on a miss) and its leaf (0 on a miss, the reference's gather).
__device__ __forceinline__ float nn_probe(const int* __restrict__ keys, const float* __restrict__ centroids,
                                          int leaf_cap, const KeySample& sample, const int* __restrict__ origin,
                                          float inv_res, int e, const float* y, int* leaf) {
  int cell[3];
  cell_of(y, inv_res, origin, cell);
  float best = INFINITY;
  int best_idx = 0;
  probe27(keys, leaf_cap, sample, e, cell, [&](int idx) {
    float dx = y[0] - centroids[3 * idx + 0];
    float dy = y[1] - centroids[3 * idx + 1];
    float dz = y[2] - centroids[3 * idx + 2];
    float d2 = lvs::dot3_fma(dx, dy, dz, dx, dy, dz);
    if (d2 < best) {
      best = d2;
      best_idx = idx;
    }
  });
  *leaf = best_idx;
  return best;
}

__global__ void __launch_bounds__(lvs::kThreads)
nn_points_kernel(const int* __restrict__ keys, const float* __restrict__ centroids, int leaf_cap,
                 const int* __restrict__ origin, float inv_res, int e, const float* __restrict__ pts,
                 const bool* __restrict__ mask, int n, float* __restrict__ d2_out, float* __restrict__ nn_out,
                 bool* __restrict__ valid_out) {
  __shared__ int sample[kSamples];
  const KeySample sampled = stage_sample(keys, leaf_cap, sample);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float y[3] = {pts[3 * i + 0], pts[3 * i + 1], pts[3 * i + 2]};
  int leaf;
  float d2 = nn_probe(keys, centroids, leaf_cap, sampled, origin, inv_res, e, y, &leaf);
  bool valid = mask[i] && isfinite(d2);
  d2_out[i] = valid ? d2 : INFINITY;
  valid_out[i] = valid;
  for (int r = 0; r < 3; ++r) nn_out[3 * i + r] = centroids[3 * leaf + r];
}

// ICP pass 1: y = T src (XLA's fma chain), the match, and block partials of
// (w, w y, w nn, w d2); y, nn and w are kept for pass 2
__global__ void __launch_bounds__(lvs::kThreads)
icp_match(const int* __restrict__ keys, const float* __restrict__ centroids, int leaf_cap,
          const int* __restrict__ origin, float inv_res, int e, const float* __restrict__ src,
          const bool* __restrict__ mask, int n, const float* __restrict__ T, float max_d2, float* __restrict__ y_out,
          float* __restrict__ nn_out, float* __restrict__ w_out, float* __restrict__ partials) {
  __shared__ int sample[kSamples];
  const KeySample sampled = stage_sample(keys, leaf_cap, sample);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (i < n) {
    float p[3] = {src[3 * i + 0], src[3 * i + 1], src[3 * i + 2]};
    float y[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      y[r] = lvs::fma64(p[2], T[4 * r + 2], lvs::fma64(p[1], T[4 * r + 1], p[0] * T[4 * r + 0])) + T[4 * r + 3];
    int leaf;
    float d2 = nn_probe(keys, centroids, leaf_cap, sampled, origin, inv_res, e, y, &leaf);
    float nn[3] = {centroids[3 * leaf + 0], centroids[3 * leaf + 1], centroids[3 * leaf + 2]};
    bool w = mask[i] && isfinite(d2) && d2 < max_d2;
    for (int r = 0; r < 3; ++r) {
      y_out[3 * i + r] = y[r];
      nn_out[3 * i + r] = nn[r];
    }
    w_out[i] = w ? 1.0f : 0.0f;
    if (w) {
      v[0] = 1.0f;
      for (int r = 0; r < 3; ++r) {
        v[1 + r] = y[r];
        v[4 + r] = nn[r];
      }
      v[7] = d2;
    }
  }
  lvs::block_sums<8>(v, partials + 8 * static_cast<long long>(blockIdx.x));
}

// stats = [count, mu_y (3), mu_n (3), fitness]: the reference's
// max(sum w, 1) divisions
__global__ void __launch_bounds__(lvs::kThreads)
icp_means(const float* __restrict__ partials, int n_blocks, float* __restrict__ stats) {
  __shared__ float s[8];
  const float v = staged_column_sum<8>(partials, n_blocks);
  if (threadIdx.x < 8) s[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float wsum = fmaxf(s[0], 1.0f);
    stats[0] = s[0];
    for (int r = 1; r < 7; ++r) stats[r] = s[r] / wsum;
    stats[7] = s[7] / wsum;
  }
}

// ICP pass 2: block partials of (y - mu_y) w (nn - mu_n)^T, row-major
__global__ void __launch_bounds__(lvs::kThreads)
icp_cov(const float* __restrict__ y, const float* __restrict__ nn, const float* __restrict__ w, int n,
        const float* __restrict__ stats, float* __restrict__ partials) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  float v[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (i < n && w[i] != 0.0f) {
    for (int a = 0; a < 3; ++a) {
      float yc = (y[3 * i + a] - stats[1 + a]) * w[i];
      for (int b = 0; b < 3; ++b) v[3 * a + b] = yc * (nn[3 * i + b] - stats[4 + b]);
    }
  }
  lvs::block_sums<9>(v, partials + 9 * static_cast<long long>(blockIdx.x));
}

// Eigenvectors (columns of v) and eigenvalues of a symmetric 3x3 by cyclic Jacobi.
__device__ void jacobi3(double a[3][3], double v[3][3]) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) v[r][c] = r == c ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 32; ++sweep) {
    double off = a[0][1] * a[0][1] + a[0][2] * a[0][2] + a[1][2] * a[1][2];
    double diag = a[0][0] * a[0][0] + a[1][1] * a[1][1] + a[2][2] * a[2][2];
    if (off <= 1e-30 * diag || off == 0.0) break;
    for (int p = 0; p < 2; ++p) {
      for (int q = p + 1; q < 3; ++q) {
        if (a[p][q] == 0.0) continue;
        double theta = (a[q][q] - a[p][p]) / (2.0 * a[p][q]);
        double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(theta * theta + 1.0));
        double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
        for (int k = 0; k < 3; ++k) {  // A <- A J (columns p, q)
          double akp = a[k][p], akq = a[k][q];
          a[k][p] = c * akp - s * akq;
          a[k][q] = s * akp + c * akq;
        }
        for (int k = 0; k < 3; ++k) {  // A <- J^T A (rows p, q)
          double apk = a[p][k], aqk = a[q][k];
          a[p][k] = c * apk - s * aqk;
          a[q][k] = s * apk + c * aqk;
        }
        for (int k = 0; k < 3; ++k) {
          double vkp = v[k][p], vkq = v[k][q];
          v[k][p] = c * vkp - s * vkq;
          v[k][q] = s * vkp + c * vkq;
        }
      }
    }
  }
}

// The Kabsch step: cov from its partials, R from its SVD (float64), t =
// mu_n - R mu_y, and T_out = [R t] T (float32, as the reference composes)
__global__ void __launch_bounds__(lvs::kThreads)
icp_update(const float* __restrict__ partials, int n_blocks, const float* __restrict__ stats,
           const float* __restrict__ T, float* __restrict__ T_out) {
  __shared__ float cov[9];
  const float col = staged_column_sum<9>(partials, n_blocks);
  if (threadIdx.x < 9) cov[threadIdx.x] = col;
  __syncthreads();
  if (threadIdx.x != 0) return;
  double c[3][3], ctc[3][3], v[3][3];
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 3; ++k) c[r][k] = cov[3 * r + k];
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 3; ++k) ctc[r][k] = c[0][r] * c[0][k] + c[1][r] * c[1][k] + c[2][r] * c[2][k];
  jacobi3(ctc, v);
  int order[3] = {0, 1, 2};  // eigenvalues descending: the singular values' order
  for (int a = 0; a < 3; ++a)
    for (int b = a + 1; b < 3; ++b)
      if (ctc[order[b]][order[b]] > ctc[order[a]][order[a]]) {
        int tmp = order[a];
        order[a] = order[b];
        order[b] = tmp;
      }
  double vs[3][3], u[3][3];
  for (int k = 0; k < 3; ++k)
    for (int r = 0; r < 3; ++r) vs[r][k] = v[r][order[k]];
  for (int k = 0; k < 2; ++k) {  // u_k = C v_k, orthonormalized; v_k where C v_k vanishes
    for (int pass = 0; pass < 2; ++pass) {
      for (int r = 0; r < 3; ++r)
        u[r][k] = pass == 0 ? c[r][0] * vs[0][k] + c[r][1] * vs[1][k] + c[r][2] * vs[2][k] : vs[r][k];
      if (k == 1) {
        double d = u[0][0] * u[0][1] + u[1][0] * u[1][1] + u[2][0] * u[2][1];
        for (int r = 0; r < 3; ++r) u[r][1] -= d * u[r][0];
      }
      double nrm = sqrt(u[0][k] * u[0][k] + u[1][k] * u[1][k] + u[2][k] * u[2][k]);
      if (nrm > 1e-150) {
        for (int r = 0; r < 3; ++r) u[r][k] /= nrm;
        break;
      }
    }
  }
  u[0][2] = u[1][0] * u[2][1] - u[2][0] * u[1][1];
  u[1][2] = u[2][0] * u[0][1] - u[0][0] * u[2][1];
  u[2][2] = u[0][0] * u[1][1] - u[1][0] * u[0][1];
  double det_v = vs[0][0] * (vs[1][1] * vs[2][2] - vs[1][2] * vs[2][1]) -
                 vs[0][1] * (vs[1][0] * vs[2][2] - vs[1][2] * vs[2][0]) +
                 vs[0][2] * (vs[1][0] * vs[2][1] - vs[1][1] * vs[2][0]);
  double sv[3] = {1.0, 1.0, det_v < 0.0 ? -1.0 : 1.0};
  float R[3][3], t[3];
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 3; ++k)
      R[r][k] = static_cast<float>(vs[r][0] * u[k][0] * sv[0] + vs[r][1] * u[k][1] * sv[1] +
                                   vs[r][2] * u[k][2] * sv[2]);
  for (int r = 0; r < 3; ++r)
    t[r] = stats[4 + r] - ((R[r][0] * stats[1] + R[r][1] * stats[2]) + R[r][2] * stats[3]);
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 4; ++k)
      T_out[4 * r + k] = ((R[r][0] * T[k] + R[r][1] * T[4 + k]) + R[r][2] * T[8 + k]) + (k == 3 ? t[r] : 0.0f);
  for (int k = 0; k < 4; ++k) T_out[12 + k] = T[12 + k];
}

// Sum of the counts of the hit cells around each lane's cell (0 for
// masked lanes, whose sentinel cells are out of the extent)
__device__ __forceinline__ float neighbour_count(const int* __restrict__ keys, const float* __restrict__ counts,
                                                 int leaf_cap, const KeySample& sample,
                                                 const int* __restrict__ origin, float inv_res, int e,
                                                 const float* y) {
  int cell[3];
  cell_of(y, inv_res, origin, cell);
  float sum = 0.0f;
  probe27(keys, leaf_cap, sample, e, cell, [&](int idx) { sum += counts[idx]; });
  return sum;
}

__device__ __forceinline__ void write_kept(const float* __restrict__ xyz, int i, bool keep, float* __restrict__ out_xyz,
                                           bool* __restrict__ out_mask) {
  for (int r = 0; r < 3; ++r) out_xyz[3 * i + r] = keep ? xyz[3 * i + r] : lvs::kSentinel;
  out_mask[i] = keep;
}

__global__ void __launch_bounds__(lvs::kThreads)
outlier_radius(const int* __restrict__ keys, const float* __restrict__ counts, int leaf_cap,
               const int* __restrict__ origin, float inv_res, int e, const float* __restrict__ xyz,
               const bool* __restrict__ mask, int n, float min_neighbors, float* __restrict__ out_xyz,
               bool* __restrict__ out_mask) {
  __shared__ int sample[kSamples];
  const KeySample sampled = stage_sample(keys, leaf_cap, sample);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool keep = mask[i];  // a masked-out lane is dropped without its probe
  if (keep) {
    const float y[3] = {xyz[3 * i + 0], xyz[3 * i + 1], xyz[3 * i + 2]};
    keep = neighbour_count(keys, counts, leaf_cap, sampled, origin, inv_res, e, y) - 1.0f >= min_neighbors;
  }
  write_kept(xyz, i, keep, out_xyz, out_mask);
}

__global__ void __launch_bounds__(lvs::kThreads)
stat_dist(const int* __restrict__ keys, const float* __restrict__ counts, int leaf_cap,
          const int* __restrict__ origin, float inv_res, int e, const float* __restrict__ xyz,
          const bool* __restrict__ mask, int n, float k_vol, float* __restrict__ dist, double* __restrict__ partials) {
  __shared__ int sample[kSamples];
  const KeySample sampled = stage_sample(keys, leaf_cap, sample);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  double v[2] = {0.0, 0.0};
  if (i < n && mask[i]) {  // stat_var and stat_keep read dist only where masked in
    const float y[3] = {xyz[3 * i + 0], xyz[3 * i + 1], xyz[3 * i + 2]};
    float density = neighbour_count(keys, counts, leaf_cap, sampled, origin, inv_res, e, y);
    float d = __double2float_rn(pow(static_cast<double>(k_vol / fmaxf(density, 1.0f)), 1.0 / 3.0));
    dist[i] = d;
    v[0] = d;
    v[1] = 1.0;
  }
  lvs::block_sums<2>(v, partials + 2 * static_cast<long long>(blockIdx.x));
}

// stats = [mean, n]; the sums are float64, rounded to float32 once
__global__ void __launch_bounds__(lvs::kThreads)
stat_mean(const double* __restrict__ partials, int n_blocks, float* __restrict__ stats) {
  __shared__ double s[2];
  const double v = staged_column_sum<2>(partials, n_blocks);
  if (threadIdx.x < 2) s[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float cnt = fmaxf(__double2float_rn(s[1]), 1.0f);
    stats[0] = __double2float_rn(s[0]) / cnt;
    stats[1] = cnt;
  }
}

__global__ void __launch_bounds__(lvs::kThreads)
stat_var(const float* __restrict__ dist, const bool* __restrict__ mask, int n, const float* __restrict__ stats,
         double* __restrict__ partials) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  double v[1] = {0.0};
  if (i < n && mask[i]) {
    float d = dist[i] - stats[0];
    v[0] = d * d;
  }
  lvs::block_sums<1>(v, partials + static_cast<long long>(blockIdx.x));
}

// stats[2] = mean + stddev_mult * sqrt(var)
__global__ void __launch_bounds__(lvs::kThreads)
stat_thresh(const double* __restrict__ partials, int n_blocks, float stddev_mult, float* __restrict__ stats) {
  const double sum = staged_column_sum<1>(partials, n_blocks);
  if (threadIdx.x == 0) {
    float var = __double2float_rn(sum) / stats[1];
    stats[2] = stats[0] + stddev_mult * sqrtf(var);
  }
}

__global__ void __launch_bounds__(lvs::kThreads)
stat_keep(const float* __restrict__ xyz, const bool* __restrict__ mask, const float* __restrict__ dist, int n,
          const float* __restrict__ stats, float* __restrict__ out_xyz, bool* __restrict__ out_mask) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  write_kept(xyz, i, mask[i] && dist[i] <= stats[2], out_xyz, out_mask);
}

}  // namespace

Layout grid_layout(int n) { return layout(n, sizeof(FlatControl)); }

extern "C" long long lvs_centroid_grid_scratch_bytes(int n) {
  return static_cast<long long>(grid_layout(n).total);
}

// xyz (n, 3) and mask (n,) of the cloud; outputs leaf_cap keys, centroids
// (leaf_cap, 3), counts and origin (3,); scratch of
// lvs_centroid_grid_scratch_bytes(n) bytes.
extern "C" int lvs_centroid_grid(const float* xyz, const bool* mask, int n, float inv_res, int leaf_cap,
                                 void* scratch, long long scratch_bytes, int* keys, float* centroids, float* counts,
                                 int* origin, cudaStream_t stream) {
  if (n < 0 || n > ks::kMaxKeys || leaf_cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = grid_layout(n);
  if (scratch_bytes < static_cast<long long>(l.total)) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = scratch_at(scratch, l);
  auto* fc = reinterpret_cast<FlatControl*>(s.base);
  const int range_blocks = range_blocks_for(n, 3ll * leaf_cap, s.n_zero);
  grid_ranges<<<range_blocks, lvs::kThreads, 0, stream>>>(xyz, mask, n, inv_res, s.part,
                                                          reinterpret_cast<unsigned*>(s.base), s.n_zero, leaf_cap,
                                                          keys, centroids, counts, origin);
  if (n == 0) LVS_RETURN_LAST_ERROR();
  grid_keys<<<std::min(lvs::blocks_for(n), kKeyBlocks), lvs::kThreads, 0, stream>>>(xyz, mask, n, inv_res, s.part,
                                                                                     range_blocks, fc, origin,
                                                                                     s.keys_b);
  ks::launch_passes(n, s.keys_a, s.vals_a, s.keys_b, s.vals_b, &fc->sort, s.status, stream, kGridPasses);
  grid_runs<<<(n + kRunTile - 1) / kRunTile, ks::kThreads, 0, stream>>>(s.keys_a, s.vals_a, s.keys_b, s.vals_b, fc,
                                                                        s.run_status, xyz, leaf_cap, keys,
                                                                        centroids, counts);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_grid_query(const int* keys, const float* centroids, int leaf_cap, const int* origin,
                              float inv_res, int e, const float* pts, const bool* mask, int n, int k,
                              const float* transforms, float max_d2, float* d2_out, float* partials,
                              int n_blocks, float* out, cudaStream_t stream) {
  if (k > 0 && n_blocks > 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, grid_query, lvs::kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long tiles = static_cast<long long>(k) * n_blocks;
    const int blocks = static_cast<int>(std::max(1ll, std::min(tiles, static_cast<long long>(per_sm) * sms)));
    grid_query<<<blocks, lvs::kThreads, 0, stream>>>(keys, centroids, leaf_cap, origin, inv_res, e, pts, mask, n, k,
                                                     n_blocks, transforms, max_d2, d2_out, partials);
    grid_finish<<<k, lvs::kThreads, 0, stream>>>(partials, n_blocks, out);
  }
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_nn_points(const int* keys, const float* centroids, int leaf_cap, const int* origin, float inv_res,
                             int e, const float* pts, const bool* mask, int n, float* d2, float* nn, bool* valid,
                             cudaStream_t stream) {
  if (n > 0)
    nn_points_kernel<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(keys, centroids, leaf_cap, origin, inv_res, e,
                                                                       pts, mask, n, d2, nn, valid);
  LVS_RETURN_LAST_ERROR();
}

// One ICP match: `stats` <- [count, mu_y, mu_n, fitness]; y, nn, w scratch (n)
extern "C" int lvs_icp_match(const int* keys, const float* centroids, int leaf_cap, const int* origin,
                             float inv_res, int e, const float* src, const bool* mask, int n, const float* T,
                             float max_d2, float* y, float* nn, float* w, float* partials, int n_blocks,
                             float* stats, cudaStream_t stream) {
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  icp_match<<<n_blocks, lvs::kThreads, 0, stream>>>(keys, centroids, leaf_cap, origin, inv_res, e, src, mask, n, T,
                                                    max_d2, y, nn, w, partials);
  icp_means<<<1, lvs::kThreads, 0, stream>>>(partials, n_blocks, stats);
  LVS_RETURN_LAST_ERROR();
}

// The rest of the ICP iteration after `lvs_icp_match`: T_out = Kabsch update @ T
extern "C" int lvs_icp_update(const float* y, const float* nn, const float* w, int n, const float* stats,
                              float* partials, int n_blocks, const float* T, float* T_out, cudaStream_t stream) {
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  icp_cov<<<n_blocks, lvs::kThreads, 0, stream>>>(y, nn, w, n, stats, partials);
  icp_update<<<1, lvs::kThreads, 0, stream>>>(partials, n_blocks, stats, T, T_out);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_outlier_radius(const int* keys, const float* counts, int leaf_cap, const int* origin,
                                  float inv_res, int e, const float* xyz, const bool* mask, int n,
                                  float min_neighbors, float* out_xyz, bool* out_mask, cudaStream_t stream) {
  if (n > 0)
    outlier_radius<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(keys, counts, leaf_cap, origin, inv_res, e, xyz,
                                                                     mask, n, min_neighbors, out_xyz, out_mask);
  LVS_RETURN_LAST_ERROR();
}

// dist (n) and the float64 partials (n_blocks * 2) are scratch; stats (3) = [mean, n, thresh]
extern "C" int lvs_outlier_statistical(const int* keys, const float* counts, int leaf_cap, const int* origin,
                                       float inv_res, int e, const float* xyz, const bool* mask, int n, float k_vol,
                                       float stddev_mult, float* dist, double* partials, int n_blocks, float* stats,
                                       float* out_xyz, bool* out_mask, cudaStream_t stream) {
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  stat_dist<<<n_blocks, lvs::kThreads, 0, stream>>>(keys, counts, leaf_cap, origin, inv_res, e, xyz, mask, n, k_vol,
                                                    dist, partials);
  stat_mean<<<1, lvs::kThreads, 0, stream>>>(partials, n_blocks, stats);
  stat_var<<<n_blocks, lvs::kThreads, 0, stream>>>(dist, mask, n, stats, partials);
  stat_thresh<<<1, lvs::kThreads, 0, stream>>>(partials, n_blocks, stddev_mult, stats);
  stat_keep<<<n_blocks, lvs::kThreads, 0, stream>>>(xyz, mask, dist, n, stats, out_xyz, out_mask);
  LVS_RETURN_LAST_ERROR();
}
