// Kernels 9g and 9k: standalone LFA's sorted k-NN grid, its build and its
// queries (the k nearest, and the 2-point lines / 3-point planes of the
// scan-to-scan odometry).
//
// Replaces: lv_slam_tpu/ops/knn.py:39 `build_grid` (9g) and :280 `knn` (9k),
// with lv_slam_tpu/lfa/registration.py:41 `lines_from_2nn` and :94
// `planes_from_3nn` built on the same search.
//
// What bounds it on the card: latency. A build moves 4096 or 8064 points
// (~100 KB); a query batch is 768 or 1536 queries (GICP's: 131072 on
// 131072-lane grids), each doing 27 binary searches over the keys and
// reading up to 216 candidate points, all of it L2-resident. Neither comes
// near HBM's rate or the card's arithmetic; the chains of dependent loads
// do, and at GICP's batch the instructions a query takes.
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
// Query design (9k): a warp a query for a batch below 16384 queries (the
// standalone LFA's 768 and 1536: a thread a query would leave the card all
// but idle), a thread a query for a larger one (GICP's 131072 fill the
// card that way, and the warp's merge would only add instructions). Both
// keep the reference's choices: the 27 cells in `_OFF27` order, each one's
// start row by a lower bound (`searchsorted`, side left; a cell out of the
// extent has key INT32_MAX, and its start, lower_bound(INT32_MAX), is
// found once per thread, not once per cell), its `slots` candidate rows
// start + s, each clamped to the last row as the reference clamps them; a
// candidate hits when its row holds the cell, and its squared distance is
// the fma chain XLA makes of `jnp.sum(d ** 2, -1)` on the CPU, +inf on a
// miss. A candidate is the 64-bit word (d2 bits << 32 | candidate index),
// index = cell * slots + s: the bits of a non-negative float order as its
// value, so the words order by (d2, index), which is `lax.top_k`'s order
// of -d2 (ties and misses to the lower index). The block first stages the
// keys in shared memory: all of them up to 8192 (the standalone grids:
// every search step and every slot's key a shared-memory read), else
// every stride-th (1024 samples; the search's last steps read the keys in
// global memory, within one stride). Blocks are persistent (as many as fit
// on the card), so a large batch stages the keys once per block.
// - A warp a query: lane l < 27 takes cell l, searches and tests its slots
//   and keeps its K least words in registers; K rounds of a warp minimum
//   (xor shuffles) then take the query's K best in order, and the winner's
//   row comes from its cell's lane by a shuffle. The 27 searches run side
//   by side instead of one after another. A search once per (x, y) column,
//   as kernel 14's grid takes it (a key per cell), would not shorten this:
//   here a cell is a run of rows, so each further cell's start is a search
//   of its own, and the lanes search side by side anyway.
// - A thread a query: the cells in turn, a register list of the K least
//   words and their rows (K a template argument: no local memory); a
//   candidate enters only where it beats the K-th kept word, and an
//   out-of-extent cell is neither searched nor read (a masked query at the
//   sentinel reads no key past its first K misses).
// The lines and planes entries then form the line (a, (b - a) / |b - a|) or
// the plane through the 3 points (lane 0 of the warp, or the thread), with
// the reference's gates, rounding its norms, cross product and offset as
// XLA's CPU fma chains do. Every output is bit for bit that of the earlier
// one-thread-a-query kernel (insertion lists behind equal distances, 27
// searches over the keys in global memory), which
// `scripts/knn_floor_parent.py` checks on the card. The search lives in
// knn_search.cuh, which kernel 10g's fits (lfa_fit.cu) share.
#include "common.cuh"
#include "knn_search.cuh"

#include <math.h>
#include <stdint.h>

namespace {

using lvs::dot3_fma;
using lvs::fma64;  // float32 fma as the plain twin computes it
using lvs::Grid;
using lvs::grid_of;
using lvs::k_nearest;
using lvs::kExtent;
using lvs::kKeyMax;
using lvs::kMaxK;
using lvs::kStageAll;

constexpr int kBig = 1 << 30;
constexpr int kQueryThreads = 256;

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

// ----------------------------------------------------------- kernel 9k (its search: knn_search.cuh)

template <int K, int G>
__global__ void __launch_bounds__(kQueryThreads)
knn_query(const int* __restrict__ keys, const float* __restrict__ xyz, int n, const int* __restrict__ origin,
          float cell, const float* __restrict__ queries, int q, int slots, float* __restrict__ dists,
          float* __restrict__ points, bool* __restrict__ valid) {
  __shared__ int staged[kStageAll];
  const Grid g = grid_of(keys, xyz, n, origin, cell, slots, staged);
  constexpr int kPerBlock = kQueryThreads / G;
  const int lane = G == 32 ? threadIdx.x & 31 : 0;
  for (long long t = static_cast<long long>(blockIdx.x) * kPerBlock + threadIdx.x / G; t < q;
       t += static_cast<long long>(gridDim.x) * kPerBlock) {
    const float y[3] = {queries[3 * t + 0], queries[3 * t + 1], queries[3 * t + 2]};
    float d2[K];
    int row[K];
    k_nearest<K, G>(g, y, d2, row);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (G == 32 && lane != j) continue;
      const float d = sqrtf(fmaxf(d2[j], 0.0f));
      dists[t * K + j] = d;
      valid[t * K + j] = isfinite(d);
      for (int a = 0; a < 3; ++a) points[(t * K + j) * 3 + a] = __ldg(xyz + 3 * row[j] + a);
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kQueryThreads)
knn_lines(const int* __restrict__ keys, const float* __restrict__ xyz, int n, const int* __restrict__ origin,
          float cell, const float* __restrict__ queries, const bool* __restrict__ mask, int q,
          float* __restrict__ mu, float* __restrict__ v, bool* __restrict__ valid) {
  __shared__ int staged[kStageAll];
  const Grid g = grid_of(keys, xyz, n, origin, cell, 8, staged);
  constexpr int kPerBlock = kQueryThreads / G;
  for (long long t = static_cast<long long>(blockIdx.x) * kPerBlock + threadIdx.x / G; t < q;
       t += static_cast<long long>(gridDim.x) * kPerBlock) {
    const float y[3] = {queries[3 * t + 0], queries[3 * t + 1], queries[3 * t + 2]};
    float d2[2];
    int row[2];
    k_nearest<2, G>(g, y, d2, row);
    if (G == 32 && (threadIdx.x & 31) != 0) continue;
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
}

template <int G>
__global__ void __launch_bounds__(kQueryThreads)
knn_planes(const int* __restrict__ keys, const float* __restrict__ xyz, int n, const int* __restrict__ origin,
           float cell, const float* __restrict__ queries, const bool* __restrict__ mask, int q,
           float* __restrict__ normal, float* __restrict__ offset, bool* __restrict__ valid) {
  __shared__ int staged[kStageAll];
  const Grid g = grid_of(keys, xyz, n, origin, cell, 8, staged);
  constexpr int kPerBlock = kQueryThreads / G;
  for (long long t = static_cast<long long>(blockIdx.x) * kPerBlock + threadIdx.x / G; t < q;
       t += static_cast<long long>(gridDim.x) * kPerBlock) {
    const float y[3] = {queries[3 * t + 0], queries[3 * t + 1], queries[3 * t + 2]};
    float d2[3];
    int row[3];
    k_nearest<3, G>(g, y, d2, row);
    if (G == 32 && (threadIdx.x & 31) != 0) continue;
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
}

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

template <int K>
int launch_knn(const int* keys, const float* xyz, int n, const int* origin, float cell, const float* queries, int q,
               int slots, float* dists, float* points, bool* valid, cudaStream_t stream) {
  if (q >= kThreadQueries)
    return launch_query<1>(knn_query<K, 1>, q, stream, keys, xyz, n, origin, cell, queries, q, slots, dists, points,
                           valid);
  return launch_query<32>(knn_query<K, 32>, q, stream, keys, xyz, n, origin, cell, queries, q, slots, dists, points,
                          valid);
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
  if (k < 1 || k > kMaxK || n < 1 || slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 1: return launch_knn<1>(keys, xyz, n, origin, cell, queries, q, slots, dists, points, valid, stream);
    case 2: return launch_knn<2>(keys, xyz, n, origin, cell, queries, q, slots, dists, points, valid, stream);
    case 3: return launch_knn<3>(keys, xyz, n, origin, cell, queries, q, slots, dists, points, valid, stream);
    case 4: return launch_knn<4>(keys, xyz, n, origin, cell, queries, q, slots, dists, points, valid, stream);
    case 5: return launch_knn<5>(keys, xyz, n, origin, cell, queries, q, slots, dists, points, valid, stream);
    case 6: return launch_knn<6>(keys, xyz, n, origin, cell, queries, q, slots, dists, points, valid, stream);
    case 7: return launch_knn<7>(keys, xyz, n, origin, cell, queries, q, slots, dists, points, valid, stream);
    default: return launch_knn<8>(keys, xyz, n, origin, cell, queries, q, slots, dists, points, valid, stream);
  }
}

extern "C" int lvs_lines_from_2nn(const int* keys, const float* xyz, int n, const int* origin, float cell,
                                  const float* queries, const bool* mask, int q, float* mu, float* v,
                                  bool* valid, cudaStream_t stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (q >= kThreadQueries)
    return launch_query<1>(knn_lines<1>, q, stream, keys, xyz, n, origin, cell, queries, mask, q, mu, v, valid);
  return launch_query<32>(knn_lines<32>, q, stream, keys, xyz, n, origin, cell, queries, mask, q, mu, v, valid);
}

extern "C" int lvs_planes_from_3nn(const int* keys, const float* xyz, int n, const int* origin, float cell,
                                   const float* queries, const bool* mask, int q, float* normal, float* offset,
                                   bool* valid, cudaStream_t stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (q >= kThreadQueries)
    return launch_query<1>(knn_planes<1>, q, stream, keys, xyz, n, origin, cell, queries, mask, q, normal, offset,
                           valid);
  return launch_query<32>(knn_planes<32>, q, stream, keys, xyz, n, origin, cell, queries, mask, q, normal, offset,
                          valid);
}
