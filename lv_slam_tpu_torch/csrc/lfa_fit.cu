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
// row reads, of the ordered sums and of the eigh is what shows. Kernel
// 10g's query runs 27 binary searches (side by side on a warp's lanes in
// its small batches) and a merge before its fit: latency again.
//
// Kernel 10's design, in two phases per block of 256 threads:
// 1. Staging, kGroup = 8 lanes per query: lane o takes probe o of the
//    2x2x2 cell block around (q - cs/2) / cs, so a block stages 32 queries
//    and the chain's 4096 / 8064 queries fill 128 / 252 blocks (one thread
//    per query filled 16 / 32 of the 132 SMs). Each lane hashes its own
//    bucket and drops its probe when an earlier lane of the group holds the
//    same bucket (their buckets come by shuffles: only the first probe of
//    a bucket reads it), issues its row's S reads at once as 16-byte
//    float4 slots (rows are S x 16 bytes), gates its candidates (slot
//    valid, probe kept, d^2 = ((dx dx + dy dy) + dz dz) < 1, no branch) and
//    writes candidate c = o S + s of its query's slice of shared memory as
//    (x, y, z, 1) if it takes part, else zeros. Each slot is read once.
// 2. The fit, one thread per query (threads 0..31 of the block, one warp,
//    after a block barrier): the sums must run from +0 in candidate order,
//    the plain twin's `_ordered_sum` order, so the thread runs the mean's
//    adds, then the covariance's with each centred point times its weight,
//    over its staged slice: the one-thread kernel's arithmetic exactly (a
//    non-participant adds an exact zero). Then the 3x3 eigh (the voxel
//    map's device function, linalg3.cuh), for planes the 0.2 m test of the
//    staged participants, and the writes. A slice is 8 S + 1 float4s, odd,
//    so the 32 threads' reads of their slices fall in distinct banks.
// What bounds it now is the fit thread's dependent chain: clock stamps put
// over 4/5 of a block's cycles in the sums and the eigh. Running them in
// one lane of each staging group, or relaying the running sums from lane
// to lane by shuffles, took 8 warps a block through the same chains and
// was slower (`scripts/k10_variants.py`, PERF.md). The outputs equal
// those of the one-thread-per-query kernel it replaced, bit for bit.
// Accept rules: lines need n_use >= k and lambda2 > 3 max(lambda1, 1e-12);
// planes need n_use >= k, every participant within 0.2 m of the fit, and a
// finite fit.
//
// Kernel 10g: the block stages the grid's keys, then kernel 9k's search
// (`lvs::k_nearest` of knn_search.cuh) finds each query's K best: below
// 16384 queries (standalone LFA's 768 sharp and 1536 flat ones) a warp a
// query, a lane a neighbour cell searching and testing its slots side by
// side and the warp's merge of (d2, index) words taking the K best in
// order (K = 5 where k <= 5); above them a thread a query, the 27 cells in
// turn (K = 8), where a warp's merge would only add instructions. One lane
// then takes the k nearest, each gated on its correctly rounded distance,
// and runs the same fit (`fit`, `line_of`, `plane_of`), summing in
// candidate order: the first k of a sorted list are the k nearest either
// way, so both routes give the earlier thread-a-query kernel's bits.
#include "common.cuh"
#include "knn_search.cuh"
#include "linalg3.cuh"

#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kH1 = 73856093u, kH2 = 19349669u, kH3 = 83492791u;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSlots = 32;
constexpr int kGroup = 8;  // lanes per query
constexpr int kChunk = 8;  // slots of a probe row read at once

// The k nearest of a sorted-grid query (kernel 10g, K9k's search; d2 and
// row hold its K best, K >= k, the first k used): the
// reference's `knn(grid, y, k)` then `valid & (dists < 1.0)`, a gate on the
// distance (the twin's sqrt32(clamp(d2, 0)), correctly rounded as sqrtf).
template <int K>
struct GridCandidates {
  static constexpr int kMax = K;  // candidates at most: the loops over them unroll, d2 and row stay in registers
  const float* xyz;
  int k;
  float d2[K];
  int row[K];

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
#pragma unroll
  for (int c = 0; c < C::kMax; ++c) {
    if (c >= m) break;
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
#pragma unroll
  for (int c = 0; c < C::kMax; ++c) {
    if (c >= m) break;
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

// Query i's line from its fit: the mean and principal direction, accepted
// with n_use >= k and lambda2 > 3 max(lambda1, 1e-12).
__device__ void write_line(const Fit& f, int i, bool masked_in, int k, float* __restrict__ mu,
                           float* __restrict__ v, bool* __restrict__ valid) {
  float ev[3];
  lvs::Vec3 evec[3];
  lvs::eigh3x3(f.cov[0], f.cov[1], f.cov[2], f.cov[3], f.cov[4], f.cov[5], ev, evec);
  for (int j = 0; j < 3; ++j) mu[3 * i + j] = f.mu[j];
  v[3 * i + 0] = evec[2].x;
  v[3 * i + 1] = evec[2].y;
  v[3 * i + 2] = evec[2].z;
  valid[i] = masked_in && f.n_use >= static_cast<float>(k) && ev[2] > 3.0f * fmaxf(ev[1], 1e-12f);
}

// The fit's plane: the smallest-eigenvalue normal n and the offset d.
__device__ void plane_frame(const Fit& f, lvs::Vec3* n, float* d) {
  float ev[3];
  lvs::Vec3 evec[3];
  // cov + 1e-9 I, every entry rounded as the plain twin's matrix sum rounds it
  lvs::eigh3x3(f.cov[0] + 1e-9f, f.cov[1] + 0.0f, f.cov[2] + 0.0f, f.cov[3] + 1e-9f,
               f.cov[4] + 0.0f, f.cov[5] + 1e-9f, ev, evec);
  *n = evec[0];
  *d = -((n->x * f.mu[0] + n->y * f.mu[1]) + n->z * f.mu[2]);
}

__device__ __forceinline__ bool near_plane(float x, float y, float z, lvs::Vec3 n, float d) {
  return fabsf(((x * n.x + y * n.y) + z * n.z) + d) < 0.2f;
}

// Query i's plane, accepted with n_use >= k, every participant within 0.2 m
// of the plane (`flat`) and a finite fit; a rejected plane is zeroed.
__device__ void write_plane(const Fit& f, lvs::Vec3 n, float d, bool flat, int i, bool masked_in, int k,
                            float* __restrict__ normal, float* __restrict__ offset, bool* __restrict__ valid) {
  bool finite = isfinite(n.x) && isfinite(n.y) && isfinite(n.z) && isfinite(d);
  bool ok = masked_in && f.n_use >= static_cast<float>(k) && flat && finite;
  normal[3 * i + 0] = ok && isfinite(n.x) ? n.x : 0.0f;
  normal[3 * i + 1] = ok && isfinite(n.y) ? n.y : 0.0f;
  normal[3 * i + 2] = ok && isfinite(n.z) ? n.z : 0.0f;
  offset[i] = ok && isfinite(d) ? d : 0.0f;
  valid[i] = ok;
}

// Query i's line over the k nearest of a sorted grid (kernel 10g).
template <class C>
__device__ void line_of(const C& cand, int i, bool masked_in, int k, float* __restrict__ mu,
                        float* __restrict__ v, bool* __restrict__ valid) {
  write_line(fit(cand), i, masked_in, k, mu, v, valid);
}

// Query i's plane over the k nearest of a sorted grid (kernel 10g).
template <class C>
__device__ void plane_of(const C& cand, int i, bool masked_in, int k, float* __restrict__ normal,
                         float* __restrict__ offset, bool* __restrict__ valid) {
  Fit f = fit(cand);
  lvs::Vec3 n;
  float d;
  plane_frame(f, &n, &d);
  bool flat = true;
  const int m = cand.count();
#pragma unroll
  for (int c = 0; c < C::kMax; ++c) {
    if (c >= m) break;
    float x, y, z;
    if (cand.get(c, &x, &y, &z)) flat &= near_plane(x, y, z, n, d);
  }
  write_plane(f, n, d, flat, i, masked_in, k, normal, offset, valid);
}

// ----------------------------------------------------------- kernel 10

// Slot c takes part: valid, and within 1 m of the query (no branch).
__device__ __forceinline__ bool takes_part(float4 c, float qx, float qy, float qz) {
  const float dx = qx - c.x, dy = qy - c.y, dz = qz - c.z;
  return (c.w > 0.5f) & (((dx * dx + dy * dy) + dz * dz) < 1.0f);
}

// Stages a query's 8 x S candidates in the group's shared-memory slice:
// lane gl of the group of G takes probes o = gl * P + p (P = 8 / G), hashes
// each one's bucket, drops a probe whose bucket an earlier probe holds
// (their buckets come by shuffles), reads its row's S slots as float4
// loads issued kChunk at a time, and writes candidate c = o * S + s as
// (x, y, z, 1) when it takes part, else (0, 0, 0, 0).
template <int G>
__device__ __forceinline__ void stage_candidates(float4* __restrict__ stage, const float* __restrict__ table,
                                                 int n_buckets, int slots, float cs, float qx, float qy, float qz) {
  constexpr int P = 8 / G;
  const int lane = threadIdx.x & 31, gl = lane % G, base = lane - gl;
  const float half = cs / 2.0f;
  const int b0 = lvs::cell_floor_div(qx - half, cs);
  const int b1 = lvs::cell_floor_div(qy - half, cs);
  const int b2 = lvs::cell_floor_div(qz - half, cs);
  int bucket[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int o = gl * P + p;
    const unsigned h = (static_cast<unsigned>(b0 + (o >> 2)) * kH1) ^
                       (static_cast<unsigned>(b1 + ((o >> 1) & 1)) * kH2) ^
                       (static_cast<unsigned>(b2 + (o & 1)) * kH3);
    bucket[p] = static_cast<int>(h % static_cast<unsigned>(n_buckets));
  }
  bool dup[P];
#pragma unroll
  for (int p = 0; p < P; ++p) dup[p] = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {  // probe e's bucket, from the lane that holds it
    const int be = __shfl_sync(kFull, bucket[e % P], base + e / P);
#pragma unroll
    for (int p = 0; p < P; ++p) dup[p] |= e < gl * P + p && be == bucket[p];
  }
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float4* row =
        dup[p] ? nullptr : reinterpret_cast<const float4*>(table) + static_cast<long long>(bucket[p]) * slots;
    float4* out = stage + (gl * P + p) * slots;
    for (int s0 = 0; s0 < slots; s0 += kChunk) {
      float4 c[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) c[j] = row != nullptr && s0 + j < slots ? __ldg(row + s0 + j) : zero;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (s0 + j < slots)
          out[s0 + j] = takes_part(c[j], qx, qy, qz) ? make_float4(c[j].x, c[j].y, c[j].z, 1.0f) : zero;
    }
  }
}

// `fit` over staged candidates: the same adds in the same order (candidate
// order from +0, a non-participant's zeros included), so the same bits. The
// 8 S candidates come 8 at a time, their reads issued before their adds.
__device__ __forceinline__ Fit staged_fit(const float4* __restrict__ stage, int slots) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, n = 0.0f;
  for (int c0 = 0; c0 < slots; ++c0) {
    float4 p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = stage[8 * c0 + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s0 = s0 + p[j].x;
      s1 = s1 + p[j].y;
      s2 = s2 + p[j].z;
      n = n + p[j].w;
    }
  }
  Fit f;
  const float cnt = fmaxf(n, 1.0f);
  f.n_use = n;
  f.mu[0] = s0 / cnt;
  f.mu[1] = s1 / cnt;
  f.mu[2] = s2 / cnt;
  float c6[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int c0 = 0; c0 < slots; ++c0) {
    float4 p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = stage[8 * c0 + j];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d0 = (p[j].x - f.mu[0]) * p[j].w, d1 = (p[j].y - f.mu[1]) * p[j].w,
                  d2 = (p[j].z - f.mu[2]) * p[j].w;
      c6[0] = c6[0] + d0 * d0;
      c6[1] = c6[1] + d0 * d1;
      c6[2] = c6[2] + d0 * d2;
      c6[3] = c6[3] + d1 * d1;
      c6[4] = c6[4] + d1 * d2;
      c6[5] = c6[5] + d2 * d2;
    }
  }
  for (int j = 0; j < 6; ++j) f.cov[j] = c6[j] / cnt;
  return f;
}

// A query's slice of the block's shared memory: 8 S + 1 float4s, an odd
// count, so the fit threads' reads of their slices fall in distinct banks.
__host__ __device__ __forceinline__ int slice(int slots) { return 8 * slots + 1; }

// Stages the block's blockDim.x / G queries, G lanes each (a query past the
// last one stages query q - 1). Then thread j < blockDim.x / G takes the
// block's j-th query, i: returns whether it is one, and sets its slice.
template <int G>
__device__ __forceinline__ bool stage_block(const float* __restrict__ y, int q, const float* __restrict__ table,
                                            int n_buckets, int slots, float cs, int* i, const float4** mine) {
  extern __shared__ float4 stage[];
  const int per_block = blockDim.x / G, first = blockIdx.x * per_block;
  const int j = threadIdx.x / G, iq = min(first + j, q - 1);
  stage_candidates<G>(stage + j * slice(slots), table, n_buckets, slots, cs, y[3 * iq + 0], y[3 * iq + 1],
                      y[3 * iq + 2]);
  __syncthreads();
  *i = first + threadIdx.x;
  *mine = stage + threadIdx.x * slice(slots);
  return threadIdx.x < per_block && *i < q;
}

template <int G>
__global__ void __launch_bounds__(lvs::kThreads)
    lines(const float* __restrict__ y, const bool* __restrict__ mask, int q, const float* __restrict__ table,
          int n_buckets, int slots, float cs, int k, float* __restrict__ mu, float* __restrict__ v,
          bool* __restrict__ valid) {
  int i;
  const float4* mine;
  if (stage_block<G>(y, q, table, n_buckets, slots, cs, &i, &mine))
    write_line(staged_fit(mine, slots), i, mask[i], k, mu, v, valid);
}

template <int G>
__global__ void __launch_bounds__(lvs::kThreads)
    planes(const float* __restrict__ y, const bool* __restrict__ mask, int q, const float* __restrict__ table,
           int n_buckets, int slots, float cs, int k, float* __restrict__ normal, float* __restrict__ offset,
           bool* __restrict__ valid) {
  int i;
  const float4* mine;
  if (!stage_block<G>(y, q, table, n_buckets, slots, cs, &i, &mine)) return;
  const Fit f = staged_fit(mine, slots);
  lvs::Vec3 n;
  float d;
  plane_frame(f, &n, &d);
  bool flat = true;
  for (int c = 0; c < 8 * slots; ++c) {
    const float4 p = mine[c];
    flat &= (p.w == 0.0f) | near_plane(p.x, p.y, p.z, n, d);
  }
  write_plane(f, n, d, flat, i, mask[i], k, normal, offset, valid);
}

// Launches a kernel-10 fit over q queries: blocks of `threads`, G lanes a
// query to stage, a slice of shared memory per query.
template <int G, class... A, class... B>
int launch_fit(void (*kernel)(A...), int threads, int q, int slots, cudaStream_t stream, B... args) {
  const int smem = threads / G * slice(slots) * static_cast<int>(sizeof(float4));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long per_block = threads / G;
  if (q > 0) kernel<<<static_cast<int>((q + per_block - 1) / per_block), threads, smem, stream>>>(args...);
  LVS_RETURN_LAST_ERROR();
}

// ----------------------------------------------------------- kernel 10g

// A query's K best by K9k's search, G lanes a query (a warp: a lane a
// neighbour cell, the warp's merge; a thread: the cells in turn), then one
// lane runs the fit over the first k, every add in candidate order, as the
// earlier thread-a-query kernel did: the same candidates, the same bits.
template <int K, int G, bool kPlanes>
__global__ void __launch_bounds__(lvs::kQueryThreads)
grid_fit(const int* __restrict__ keys, const float* __restrict__ xyz, int n, const int* __restrict__ origin,
         float cell, const float* __restrict__ y, const bool* __restrict__ mask, int q, int k, float* __restrict__ a,
         float* __restrict__ b, bool* __restrict__ valid) {
  __shared__ int staged[lvs::kStageAll];
  const lvs::Grid g = lvs::grid_of(keys, xyz, n, origin, cell, 8, staged);
  constexpr int kPerBlock = lvs::kQueryThreads / G;
  for (long long t = static_cast<long long>(blockIdx.x) * kPerBlock + threadIdx.x / G; t < q;
       t += static_cast<long long>(gridDim.x) * kPerBlock) {
    GridCandidates<K> cand;
    cand.xyz = xyz;
    cand.k = k;
    const float yi[3] = {y[3 * t + 0], y[3 * t + 1], y[3 * t + 2]};
    lvs::k_nearest<K, G>(g, yi, cand.d2, cand.row);
    if (G == 32 && (threadIdx.x & 31) != 0) continue;
    const int i = static_cast<int>(t);
    if constexpr (kPlanes)
      plane_of(cand, i, mask[i], k, a, b, valid);  // a: the normals, b: the offsets
    else
      line_of(cand, i, mask[i], k, a, b, valid);   // a: the means, b: the directions
  }
}

// Kernel 10g over q queries: a warp a query below lvs::kThreadQueries
// queries (K = 5 where k <= 5: the merge takes no more rounds than it
// keeps), a thread a query above (K = 8), as kernel 9k's searches.
template <bool kPlanes>
int launch_grid_fit(const int* keys, const float* xyz, int n, const int* origin, float cell, const float* y,
                    const bool* mask, int q, int k, float* a, float* b, bool* valid, cudaStream_t stream) {
  if (k < 1 || k > lvs::kMaxK || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (q >= lvs::kThreadQueries)
    return lvs::launch_query<1>(grid_fit<lvs::kMaxK, 1, kPlanes>, q, stream, keys, xyz, n, origin, cell, y, mask, q,
                                k, a, b, valid);
  if (k <= 5)
    return lvs::launch_query<32>(grid_fit<5, 32, kPlanes>, q, stream, keys, xyz, n, origin, cell, y, mask, q, k, a,
                                 b, valid);
  return lvs::launch_query<32>(grid_fit<lvs::kMaxK, 32, kPlanes>, q, stream, keys, xyz, n, origin, cell, y, mask, q,
                               k, a, b, valid);
}

// The table entries' argument checks: slots within kMaxSlots, rows 16-byte aligned.
int table_args(const float* table, int slots) {
  if (slots < 1 || slots > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

}  // namespace

extern "C" int lvs_lines_from_fit(const float* y, const bool* mask, int q, const float* table,
                                  int n_buckets, int slots, float cs, int k, float* mu, float* v,
                                  bool* valid, cudaStream_t stream) {
  if (int err = table_args(table, slots)) return err;
  return launch_fit<kGroup>(lines<kGroup>, lvs::kThreads, q, slots, stream, y, mask, q, table, n_buckets, slots, cs,
                            k, mu, v, valid);
}

extern "C" int lvs_planes_from_fit(const float* y, const bool* mask, int q, const float* table,
                                   int n_buckets, int slots, float cs, int k, float* normal,
                                   float* offset, bool* valid, cudaStream_t stream) {
  if (int err = table_args(table, slots)) return err;
  return launch_fit<kGroup>(planes<kGroup>, lvs::kThreads, q, slots, stream, y, mask, q, table, n_buckets, slots, cs,
                            k, normal, offset, valid);
}

// kernel 10g: the fits over the k nearest of a sorted grid (k <= 8)
extern "C" int lvs_grid_lines_from_fit(const int* keys, const float* xyz, int n, const int* origin, float cell,
                                       const float* y, const bool* mask, int q, int k, float* mu, float* v,
                                       bool* valid, cudaStream_t stream) {
  return launch_grid_fit<false>(keys, xyz, n, origin, cell, y, mask, q, k, mu, v, valid, stream);
}

extern "C" int lvs_grid_planes_from_fit(const int* keys, const float* xyz, int n, const int* origin, float cell,
                                        const float* y, const bool* mask, int q, int k, float* normal,
                                        float* offset, bool* valid, cudaStream_t stream) {
  return launch_grid_fit<true>(keys, xyz, n, origin, cell, y, mask, q, k, normal, offset, valid, stream);
}
