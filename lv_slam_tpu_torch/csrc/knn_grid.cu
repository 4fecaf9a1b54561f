// Kernels 9g and 9k: standalone LFA's sorted k-NN grid, its build and its
// queries (the k nearest, and the 2-point lines / 3-point planes of the
// scan-to-scan odometry).
//
// Replaces: lv_slam_tpu/ops/knn.py:39 `build_grid` (9g) and :280 `knn` (9k),
// with lv_slam_tpu/lfa/registration.py:41 `lines_from_2nn` and :94
// `planes_from_3nn` built on the same search.
//
// What bounds it on the card: latency. A build moves 4096 or 8064 points
// (~100 KB); a query batch is 768 or 1536 queries, each doing 27 binary
// searches of ~13 dependent steps over the keys and reading up to 216
// candidate points, all of it L2-resident. Neither comes near HBM's rate or
// the card's arithmetic; the dependent loads do.
//
// Build design (9g): `knn_grid_init` sets the per-axis minimum to 2^30,
// `knn_grid_cells` takes each valid lane's cell, floor(x * (1/cell)) as XLA
// compiles the reference's division by a constant, into an atomicMin per
// axis (order-free, so deterministic), and `knn_grid_keys` writes each lane's
// flat key ((rx * 1024 + ry) * 1024 + rz, or INT32_MAX outside the 1024^3
// extent or for masked lanes), the origin 0 when no lane is valid. The
// wrapper sorts the keys stably (torch glue, as for kernel 1); equal keys
// keep input order. `knn_grid_gather` writes the points in key order.
//
// Query design (9k): one thread per query runs the grid search of
// knn_search.cuh (27 binary searches, the clamped slots, the fma-chain
// squared distances rounded as the plain twin rounds them, an insertion
// list in `lax.top_k`'s tie order) and keeps the k best. The lines and
// planes entries then form the line (a, (b - a) / |b - a|) or the plane
// through the 3 points in place, with the reference's gates, rounding its
// norms, cross product and offset as XLA's CPU fma chains do.
#include "common.cuh"
#include "knn_search.cuh"

#include <math.h>

namespace {

using lvs::kExtent;
using lvs::kKeyMax;
using lvs::kMaxK;
using lvs::fma64;  // float32 fma as the plain twin computes it
using lvs::dot3_fma;
using lvs::k_nearest;

constexpr int kBig = 1 << 30;

__global__ void knn_grid_init(int* __restrict__ low) {
  if (threadIdx.x < 3) low[threadIdx.x] = kBig;
}

__device__ __forceinline__ int cell_of(float x, float inv_cell) {
  return static_cast<int>(floorf(x * inv_cell));
}

__global__ void knn_grid_cells(const float* __restrict__ xyz, const bool* __restrict__ mask, int n,
                               float inv_cell, int* __restrict__ low) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !mask[i]) return;
  for (int a = 0; a < 3; ++a) atomicMin(low + a, cell_of(xyz[3 * i + a], inv_cell));
}

__global__ void knn_grid_keys(const float* __restrict__ xyz, const bool* __restrict__ mask, int n,
                              float inv_cell, const int* __restrict__ low, int* __restrict__ origin,
                              int* __restrict__ keys) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int o[3];
  for (int a = 0; a < 3; ++a) o[a] = low[a] == kBig ? 0 : low[a];
  if (i == 0) {
    for (int a = 0; a < 3; ++a) origin[a] = o[a];
  }
  if (i >= n) return;
  bool ok = mask[i];
  int r[3];
  for (int a = 0; a < 3; ++a) {
    long long rel = static_cast<long long>(cell_of(xyz[3 * i + a], inv_cell)) - o[a];
    ok = ok && rel >= 0 && rel < kExtent;
    r[a] = static_cast<int>(rel);
  }
  keys[i] = ok ? (r[0] * kExtent + r[1]) * kExtent + r[2] : kKeyMax;
}

__global__ void knn_grid_gather(const long long* __restrict__ order, const float* __restrict__ xyz, int n,
                                float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long src = order[i];
  out[3 * i + 0] = xyz[3 * src + 0];
  out[3 * i + 1] = xyz[3 * src + 1];
  out[3 * i + 2] = xyz[3 * src + 2];
}

__global__ void __launch_bounds__(lvs::kThreads)
knn_query(const int* __restrict__ keys, const float* __restrict__ xyz, int n, const int* __restrict__ origin,
          float cell, const float* __restrict__ queries, int q, int k, int slots, float* __restrict__ dists,
          float* __restrict__ points, bool* __restrict__ valid) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= q) return;
  float d2[kMaxK];
  int row[kMaxK];
  k_nearest(keys, xyz, n, origin, cell, queries[3 * t + 0], queries[3 * t + 1], queries[3 * t + 2], k, slots,
            d2, row);
  for (int j = 0; j < k; ++j) {
    float d = sqrtf(fmaxf(d2[j], 0.0f));
    dists[t * k + j] = d;
    valid[t * k + j] = isfinite(d);
    for (int a = 0; a < 3; ++a) points[(t * k + j) * 3 + a] = __ldg(xyz + 3 * row[j] + a);
  }
}

__global__ void __launch_bounds__(lvs::kThreads)
knn_lines(const int* __restrict__ keys, const float* __restrict__ xyz, int n, const int* __restrict__ origin,
          float cell, const float* __restrict__ queries, const bool* __restrict__ mask, int q,
          float* __restrict__ mu, float* __restrict__ v, bool* __restrict__ valid) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= q) return;
  float d2[2];
  int row[2];
  k_nearest(keys, xyz, n, origin, cell, queries[3 * t + 0], queries[3 * t + 1], queries[3 * t + 2], 2, 8,
            d2, row);
  float a[3], ab[3];
  for (int i = 0; i < 3; ++i) {
    a[i] = __ldg(xyz + 3 * row[0] + i);
    ab[i] = __ldg(xyz + 3 * row[1] + i) - a[i];
  }
  float d0 = sqrtf(fmaxf(d2[0], 0.0f)), d1 = sqrtf(fmaxf(d2[1], 0.0f));
  float norm = sqrtf(dot3_fma(ab[0], ab[1], ab[2], ab[0], ab[1], ab[2]));
  valid[t] = mask[t] && isfinite(d0) && isfinite(d1) && d0 * d0 < 25.0f && norm > 1e-3f;
  float den = fmaxf(norm, 1e-9f);
  for (int i = 0; i < 3; ++i) {
    mu[3 * t + i] = a[i];
    v[3 * t + i] = ab[i] / den;
  }
}

__global__ void __launch_bounds__(lvs::kThreads)
knn_planes(const int* __restrict__ keys, const float* __restrict__ xyz, int n, const int* __restrict__ origin,
           float cell, const float* __restrict__ queries, const bool* __restrict__ mask, int q,
           float* __restrict__ normal, float* __restrict__ offset, bool* __restrict__ valid) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= q) return;
  float d2[3];
  int row[3];
  k_nearest(keys, xyz, n, origin, cell, queries[3 * t + 0], queries[3 * t + 1], queries[3 * t + 2], 3, 8,
            d2, row);
  float a[3], u[3], w[3];
  for (int i = 0; i < 3; ++i) {
    a[i] = __ldg(xyz + 3 * row[0] + i);
    u[i] = __ldg(xyz + 3 * row[1] + i) - a[i];
    w[i] = __ldg(xyz + 3 * row[2] + i) - a[i];
  }
  // jnp.cross as XLA contracts it: fma(u1, w2, -(u2 * w1)), ...
  float nv[3] = {fma64(u[1], w[2], -__fmul_rn(u[2], w[1])), fma64(u[2], w[0], -__fmul_rn(u[0], w[2])),
                 fma64(u[0], w[1], -__fmul_rn(u[1], w[0]))};
  float norm = sqrtf(dot3_fma(nv[0], nv[1], nv[2], nv[0], nv[1], nv[2]));
  bool all_valid = true;
  for (int j = 0; j < 3; ++j) all_valid = all_valid && isfinite(sqrtf(fmaxf(d2[j], 0.0f)));
  float d0 = sqrtf(fmaxf(d2[0], 0.0f));
  valid[t] = mask[t] && all_valid && d0 * d0 < 25.0f && norm > 1e-3f;
  float den = fmaxf(norm, 1e-9f);
  float nh[3] = {nv[0] / den, nv[1] / den, nv[2] / den};
  for (int i = 0; i < 3; ++i) normal[3 * t + i] = nh[i];
  offset[t] = -dot3_fma(nh[0], nh[1], nh[2], a[0], a[1], a[2]);
}

}  // namespace

extern "C" int lvs_knn_grid_keys(const float* xyz, const bool* mask, int n, float inv_cell, int* low,
                                 int* origin, int* keys, cudaStream_t stream) {
  knn_grid_init<<<1, 32, 0, stream>>>(low);
  if (n > 0) knn_grid_cells<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(xyz, mask, n, inv_cell, low);
  int threads = n > 1 ? n : 1;  // thread 0 writes the origin
  knn_grid_keys<<<lvs::blocks_for(threads), lvs::kThreads, 0, stream>>>(xyz, mask, n, inv_cell, low, origin,
                                                                         keys);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_knn_grid_gather(const long long* order, const float* xyz, int n, float* out,
                                   cudaStream_t stream) {
  if (n > 0) knn_grid_gather<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(order, xyz, n, out);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_knn(const int* keys, const float* xyz, int n, const int* origin, float cell,
                       const float* queries, int q, int k, int slots, float* dists, float* points, bool* valid,
                       cudaStream_t stream) {
  if (k < 1 || k > kMaxK || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (q > 0)
    knn_query<<<lvs::blocks_for(q), lvs::kThreads, 0, stream>>>(keys, xyz, n, origin, cell, queries, q, k, slots,
                                                                dists, points, valid);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_lines_from_2nn(const int* keys, const float* xyz, int n, const int* origin, float cell,
                                  const float* queries, const bool* mask, int q, float* mu, float* v,
                                  bool* valid, cudaStream_t stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (q > 0)
    knn_lines<<<lvs::blocks_for(q), lvs::kThreads, 0, stream>>>(keys, xyz, n, origin, cell, queries, mask, q, mu,
                                                                v, valid);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_planes_from_3nn(const int* keys, const float* xyz, int n, const int* origin, float cell,
                                   const float* queries, const bool* mask, int q, float* normal, float* offset,
                                   bool* valid, cudaStream_t stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (q > 0)
    knn_planes<<<lvs::blocks_for(q), lvs::kThreads, 0, stream>>>(keys, xyz, n, origin, cell, queries, mask, q,
                                                                 normal, offset, valid);
  LVS_RETURN_LAST_ERROR();
}
