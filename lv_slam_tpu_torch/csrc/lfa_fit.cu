// Kernels 10 and 10g: LFA scan-to-map correspondences, line and plane fits
// over the hashed cell tables (10) and over the k nearest of a sorted grid
// (10g).
//
// Replaces: lv_slam_tpu/lfa/registration.py:58 `lines_from_fit` and :111
// `planes_from_fit`: their CellTable branch with the probe of
// lv_slam_tpu/ops/knn.py:238 `candidates_cell` inside (10), and their
// KnnGrid branch, `knn(grid, y, k)` (:73, :128) gated at dists < 1 m (10g).
//
// What bounds it on the card: the dependent random reads. Per query kernel
// 10 reads 8 bucket rows of 96 bytes (4096 edge + 8064 surf queries per
// scan: ~9 MB of row reads that mostly hit L2) and does ~600 flops plus one
// 3x3 eigh; at 12k queries that is under 10 MFLOP, so the latency of the
// probe chain and the eigh are what show. Kernel 10g's query runs K9k's 27
// dependent binary searches before its fit (knn_search.cuh): latency again.
//
// Design: one thread per query. Kernel 10 hashes the 2x2x2 cell block
// around (q - cs/2) / cs, drops a probe whose bucket an earlier probe
// already read, and takes the 8 x S slots as its candidates; kernel 10g
// runs the grid search (`lvs::k_nearest`) and takes its k nearest, each
// gated on its correctly rounded distance. One fit serves both
// (`line_of` / `plane_of` over a candidate source): it walks the candidates
// in order three times (sum for the mean, sum for the covariance, and for
// planes the residual check), so the sums run in the reference's candidate
// order and the plain twin, a loop over the same candidates, rounds
// identically. Candidates outside the 1 m gate add an exact zero, as the
// reference's masked sums do. The 3x3 eigh is the voxel map's device
// function (linalg3.cuh). Accept rules: lines need n_use >= k and
// lambda2 > 3 max(lambda1, 1e-12); planes need n_use >= k, every
// participant within 0.2 m of the fit, and a finite fit.
#include "common.cuh"
#include "knn_search.cuh"
#include "linalg3.cuh"

#include <math.h>

namespace {

constexpr unsigned kH1 = 73856093u, kH2 = 19349669u, kH3 = 83492791u;
constexpr int kMaxSlots = 32;

struct Probe {
  const float* rows[8];  // nullptr for a probe whose bucket an earlier one read
};

__device__ Probe probe(const float* table, int n_buckets, int slots, float cs, float qx, float qy,
                       float qz) {
  float half = cs / 2.0f;
  int b0 = static_cast<int>(floorf((qx - half) / cs));
  int b1 = static_cast<int>(floorf((qy - half) / cs));
  int b2 = static_cast<int>(floorf((qz - half) / cs));
  int bucket[8];
  Probe p;
  for (int o = 0; o < 8; ++o) {
    unsigned h = (static_cast<unsigned>(b0 + (o >> 2)) * kH1) ^
                 (static_cast<unsigned>(b1 + ((o >> 1) & 1)) * kH2) ^
                 (static_cast<unsigned>(b2 + (o & 1)) * kH3);
    bucket[o] = static_cast<int>(h % static_cast<unsigned>(n_buckets));
    bool dup = false;
    for (int e = 0; e < o; ++e) dup |= bucket[e] == bucket[o];
    p.rows[o] = dup ? nullptr : table + static_cast<long long>(bucket[o]) * slots * 4;
  }
  return p;
}

// The 8 x S candidates of a cell-table probe (kernel 10): candidate
// c = o * S + s, slot s of probe o, takes part when its slot is valid, its
// probe the first of its bucket, and its squared distance, summed as the
// plain twin sums it, below 1 m^2.
struct TableCandidates {
  Probe p;
  int slots;
  float qx, qy, qz;

  __device__ int count() const { return 8 * slots; }

  __device__ bool get(int c, float* x, float* y, float* z) const {
    const int o = c / slots, s = c - o * slots;
    if (p.rows[o] == nullptr) return false;
    const float* row = p.rows[o] + 4 * s;
    if (!(row[3] > 0.5f)) return false;
    *x = row[0];
    *y = row[1];
    *z = row[2];
    float dx = qx - *x, dy = qy - *y, dz = qz - *z;
    return ((dx * dx + dy * dy) + dz * dz) < 1.0f;
  }
};

// The k nearest of a sorted-grid query (kernel 10g, K9k's search): the
// reference's `knn(grid, y, k)` then `valid & (dists < 1.0)`, a gate on the
// distance (the twin's sqrt32(clamp(d2, 0)), correctly rounded as sqrtf).
struct GridCandidates {
  const float* xyz;
  int k;
  float d2[lvs::kMaxK];
  int row[lvs::kMaxK];

  __device__ int count() const { return k; }

  __device__ bool get(int j, float* x, float* y, float* z) const {
    *x = xyz[3 * row[j] + 0];
    *y = xyz[3 * row[j] + 1];
    *z = xyz[3 * row[j] + 2];
    const float d = sqrtf(d2[j] < 0.0f ? 0.0f : d2[j]);
    return isfinite(d) && d < 1.0f;
  }
};

struct Fit {
  float n_use, mu[3], cov[6];  // cov: 00 01 02 11 12 22
};

// The masked mean and covariance of the candidates that take part, summed
// in candidate order from +0 (the plain twin's `_ordered_sum`); a candidate
// that does not adds an exact zero, as the reference's masked sums do.
template <class C>
__device__ Fit fit(const C& cand) {
  Fit f;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, n = 0.0f;
  const int m = cand.count();
  for (int c = 0; c < m; ++c) {
    float x = 0.0f, y = 0.0f, z = 0.0f;
    bool use = cand.get(c, &x, &y, &z);
    if (!use) x = y = z = 0.0f;
    s0 = s0 + x;
    s1 = s1 + y;
    s2 = s2 + z;
    n = n + (use ? 1.0f : 0.0f);
  }
  float cnt = fmaxf(n, 1.0f);
  f.n_use = n;
  f.mu[0] = s0 / cnt;
  f.mu[1] = s1 / cnt;
  f.mu[2] = s2 / cnt;
  float c6[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = 0; c < m; ++c) {
    float x = 0.0f, y = 0.0f, z = 0.0f;
    bool use = cand.get(c, &x, &y, &z);
    if (!use) x = y = z = 0.0f;
    float w = use ? 1.0f : 0.0f;
    float d0 = (x - f.mu[0]) * w, d1 = (y - f.mu[1]) * w, d2 = (z - f.mu[2]) * w;
    c6[0] = c6[0] + d0 * d0;
    c6[1] = c6[1] + d0 * d1;
    c6[2] = c6[2] + d0 * d2;
    c6[3] = c6[3] + d1 * d1;
    c6[4] = c6[4] + d1 * d2;
    c6[5] = c6[5] + d2 * d2;
  }
  for (int j = 0; j < 6; ++j) f.cov[j] = c6[j] / cnt;
  return f;
}

// Query i's line: the fit's mean and principal direction, accepted with
// n_use >= k and lambda2 > 3 max(lambda1, 1e-12).
template <class C>
__device__ void line_of(const C& cand, int i, bool masked_in, int k, float* __restrict__ mu,
                        float* __restrict__ v, bool* __restrict__ valid) {
  Fit f = fit(cand);
  float ev[3];
  lvs::Vec3 evec[3];
  lvs::eigh3x3(f.cov[0], f.cov[1], f.cov[2], f.cov[3], f.cov[4], f.cov[5], ev, evec);
  for (int j = 0; j < 3; ++j) mu[3 * i + j] = f.mu[j];
  v[3 * i + 0] = evec[2].x;
  v[3 * i + 1] = evec[2].y;
  v[3 * i + 2] = evec[2].z;
  valid[i] = masked_in && f.n_use >= static_cast<float>(k) && ev[2] > 3.0f * fmaxf(ev[1], 1e-12f);
}

// Query i's plane: the smallest-eigenvalue normal of the fit, accepted with
// n_use >= k, every participant within 0.2 m of the plane and a finite fit;
// a rejected plane is zeroed.
template <class C>
__device__ void plane_of(const C& cand, int i, bool masked_in, int k, float* __restrict__ normal,
                         float* __restrict__ offset, bool* __restrict__ valid) {
  Fit f = fit(cand);
  float ev[3];
  lvs::Vec3 evec[3];
  // cov + 1e-9 I, every entry rounded as the plain twin's matrix sum rounds it
  lvs::eigh3x3(f.cov[0] + 1e-9f, f.cov[1] + 0.0f, f.cov[2] + 0.0f, f.cov[3] + 1e-9f,
               f.cov[4] + 0.0f, f.cov[5] + 1e-9f, ev, evec);
  lvs::Vec3 n = evec[0];
  float d = -((n.x * f.mu[0] + n.y * f.mu[1]) + n.z * f.mu[2]);
  bool flat = true;
  const int m = cand.count();
  for (int c = 0; c < m; ++c) {
    float x, y, z;
    if (cand.get(c, &x, &y, &z)) flat &= fabsf(((x * n.x + y * n.y) + z * n.z) + d) < 0.2f;
  }
  bool finite = isfinite(n.x) && isfinite(n.y) && isfinite(n.z) && isfinite(d);
  bool ok = masked_in && f.n_use >= static_cast<float>(k) && flat && finite;
  normal[3 * i + 0] = ok && isfinite(n.x) ? n.x : 0.0f;
  normal[3 * i + 1] = ok && isfinite(n.y) ? n.y : 0.0f;
  normal[3 * i + 2] = ok && isfinite(n.z) ? n.z : 0.0f;
  offset[i] = ok && isfinite(d) ? d : 0.0f;
  valid[i] = ok;
}

__global__ void lines(const float* __restrict__ y, const bool* __restrict__ mask, int q,
                      const float* __restrict__ table, int n_buckets, int slots, float cs, int k,
                      float* __restrict__ mu, float* __restrict__ v, bool* __restrict__ valid) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  float qx = y[3 * i + 0], qy = y[3 * i + 1], qz = y[3 * i + 2];
  TableCandidates cand{probe(table, n_buckets, slots, cs, qx, qy, qz), slots, qx, qy, qz};
  line_of(cand, i, mask[i], k, mu, v, valid);
}

__global__ void planes(const float* __restrict__ y, const bool* __restrict__ mask, int q,
                       const float* __restrict__ table, int n_buckets, int slots, float cs, int k,
                       float* __restrict__ normal, float* __restrict__ offset,
                       bool* __restrict__ valid) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  float qx = y[3 * i + 0], qy = y[3 * i + 1], qz = y[3 * i + 2];
  TableCandidates cand{probe(table, n_buckets, slots, cs, qx, qy, qz), slots, qx, qy, qz};
  plane_of(cand, i, mask[i], k, normal, offset, valid);
}

__device__ __forceinline__ void grid_search(const int* __restrict__ keys, const float* __restrict__ xyz, int n,
                                            const int* __restrict__ origin, float cell,
                                            const float* __restrict__ y, int i, GridCandidates* cand) {
  cand->xyz = xyz;
  lvs::k_nearest(keys, xyz, n, origin, cell, y[3 * i + 0], y[3 * i + 1], y[3 * i + 2], cand->k, 8, cand->d2,
                 cand->row);
}

__global__ void grid_lines(const int* __restrict__ keys, const float* __restrict__ xyz, int n,
                           const int* __restrict__ origin, float cell, const float* __restrict__ y,
                           const bool* __restrict__ mask, int q, int k, float* __restrict__ mu,
                           float* __restrict__ v, bool* __restrict__ valid) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  GridCandidates cand;
  cand.k = k;
  grid_search(keys, xyz, n, origin, cell, y, i, &cand);
  line_of(cand, i, mask[i], k, mu, v, valid);
}

__global__ void grid_planes(const int* __restrict__ keys, const float* __restrict__ xyz, int n,
                            const int* __restrict__ origin, float cell, const float* __restrict__ y,
                            const bool* __restrict__ mask, int q, int k, float* __restrict__ normal,
                            float* __restrict__ offset, bool* __restrict__ valid) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  GridCandidates cand;
  cand.k = k;
  grid_search(keys, xyz, n, origin, cell, y, i, &cand);
  plane_of(cand, i, mask[i], k, normal, offset, valid);
}

}  // namespace

extern "C" int lvs_lines_from_fit(const float* y, const bool* mask, int q, const float* table,
                                  int n_buckets, int slots, float cs, int k, float* mu, float* v,
                                  bool* valid, cudaStream_t stream) {
  if (slots > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  if (q > 0)
    lines<<<lvs::blocks_for(q), lvs::kThreads, 0, stream>>>(y, mask, q, table, n_buckets, slots, cs,
                                                            k, mu, v, valid);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_planes_from_fit(const float* y, const bool* mask, int q, const float* table,
                                   int n_buckets, int slots, float cs, int k, float* normal,
                                   float* offset, bool* valid, cudaStream_t stream) {
  if (slots > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  if (q > 0)
    planes<<<lvs::blocks_for(q), lvs::kThreads, 0, stream>>>(y, mask, q, table, n_buckets, slots,
                                                             cs, k, normal, offset, valid);
  LVS_RETURN_LAST_ERROR();
}

// kernel 10g: the fits over the k nearest of a sorted grid (k <= 8)
extern "C" int lvs_grid_lines_from_fit(const int* keys, const float* xyz, int n, const int* origin, float cell,
                                       const float* y, const bool* mask, int q, int k, float* mu, float* v,
                                       bool* valid, cudaStream_t stream) {
  if (k < 1 || k > lvs::kMaxK || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (q > 0)
    grid_lines<<<lvs::blocks_for(q), lvs::kThreads, 0, stream>>>(keys, xyz, n, origin, cell, y, mask, q, k, mu, v,
                                                                 valid);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_grid_planes_from_fit(const int* keys, const float* xyz, int n, const int* origin, float cell,
                                        const float* y, const bool* mask, int q, int k, float* normal,
                                        float* offset, bool* valid, cudaStream_t stream) {
  if (k < 1 || k > lvs::kMaxK || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (q > 0)
    grid_planes<<<lvs::blocks_for(q), lvs::kThreads, 0, stream>>>(keys, xyz, n, origin, cell, y, mask, q, k,
                                                                  normal, offset, valid);
  LVS_RETURN_LAST_ERROR();
}
