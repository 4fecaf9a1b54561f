// Kernel 9: the LFA world maps' hashed cell tables: batch insert (9a), crop
// (9b), the whole-table build of the host mapping (9c) and the 8-cell k-NN
// (9n).
//
// Replaces: lv_slam_tpu/ops/knn.py:139 `insert_cell_table`, :218
// `crop_cell_table`, :93 `build_cell_table` and :264 `knn_cell`. A table is (B, S*4) float32:
// S slots of [x, y, z, valid]
// per bucket; a 2 m cell hashes to bucket ((c0*H1) ^ (c1*H2) ^ (c2*H3)) mod B
// in uint32 arithmetic (the reference's wrapping int32 products, taken as
// uint32).
//
// What bounds it on the card: latency. An insert touches one 96-byte bucket
// row per batch point (4096 edge / 8064 surf points per scan, under 1 MB);
// the crop is one pass over the table (1.5 MB edge, 3 MB surf at the flagship
// capacities, ~1.4 us of HBM time at 3.35 TB/s).
//
// Insert design: `insert_keys` computes each point's bucket and 0.4 / 0.8 m
// voxel (a multiply by the float32 reciprocal of the resolution, as XLA
// compiles the reference's constant division) into two sort keys; the wrapper
// sorts them with two stable torch.sort passes, the least significant first,
// which is the reference's stable three-key lax.sort. Then one thread per
// sorted row: `insert_keep` finds the first row of each voxel and checks the
// bucket's stored slots for the voxel (the map wins) and records the bucket's
// free slots as they were before this batch; `insert_place` (a second launch,
// so no thread reads a row another one writes) counts the kept rows before it
// in its bucket run and writes the point into the rank-th free slot: crop
// leaves holes, so the free slots are not a prefix. Kept rows of one bucket
// get distinct ranks, so no two threads write one slot: deterministic.
//
// Build design (9c): `table_keys` writes each row's bucket (its cell is
// floor(x * (1/cell)), as XLA compiles the reference's division by a
// constant), B for masked rows; the wrapper sorts the buckets stably (torch
// glue), so each bucket's rows form one run in input order. `table_zero`
// clears the table, then `table_place` runs one thread per sorted row: a
// binary search finds the start of its bucket run, and the row is written
// to slot rank = row - start when rank < S. Slots are distinct, so the table
// is deterministic slot for slot. What bounds it: the table's clear and
// write (3 MB for the surf map's 2^15 x 6 slots, ~1 us of HBM time) and the
// 65536-row sort; the binary searches stay in L2.
//
// Crop design: one elementwise pass over the slots, in place. With a last
// crop center it first decides the crop_interval gate itself, from device
// memory (moved^2 > interval^2), and returns at once when it is closed, so
// the LFA step reads nothing back to the host; one thread writes the new crop
// center.
//
// k-NN design (9n): one warp per query. Lanes 0-7 hash the 2x2x2 cell block
// around (q - cs/2) / cs (`candidates_cell`'s probe) and mark a probe whose
// bucket an earlier probe holds (the later of two is dropped); then the
// lanes take the 8 x S candidates c = o * S + s in turn, a candidate's key
// the bits of its squared distance (the fma chain of the reference's sum of
// squares, rounded as the plain twin rounds it; +inf for an invalid slot or
// a dropped probe), kept in shared memory. Each candidate's rank is the
// number of candidates before it in (key, index) order, `lax.top_k`'s order
// of -d2: ties to the lower index, misses in index order; the keys of
// non-negative floats, +inf and NaN order as the floats do (NaN last, as
// the twin's stable sort puts it). A candidate of rank < k writes output
// slot `rank`: its distance, its table row's point (an invalid slot's too,
// as the reference returns it) and whether the distance is finite. Ranks are
// distinct, so every slot has one writer. What bounds it: latency (8 row
// reads of 96 bytes per query and (8 S)^2 comparisons in shared memory).
#include "common.cuh"

#include <math.h>

namespace {

constexpr unsigned kH1 = 73856093u, kH2 = 19349669u, kH3 = 83492791u;
constexpr int kYZOff = 1 << 14, kYZLim = (1 << 15) - 1;
constexpr int kMaxSlots = 32;

__device__ __forceinline__ int bucket_of(int c0, int c1, int c2, int n_buckets) {
  unsigned h = (static_cast<unsigned>(c0) * kH1) ^ (static_cast<unsigned>(c1) * kH2) ^
               (static_cast<unsigned>(c2) * kH3);
  return static_cast<int>(h % static_cast<unsigned>(n_buckets));
}

__device__ __forceinline__ int pack_yz(int cy, int cz) {
  cy = min(max(cy + kYZOff, 0), kYZLim);
  cz = min(max(cz + kYZOff, 0), kYZLim);
  return cy * (1 << 15) + cz;
}

// khi = bucket << 32 | (vx with its sign bit flipped): ascending khi is
// ascending (bucket, vx); masked points take bucket B and vx 2^30.
__global__ void insert_keys(const float* __restrict__ xyz, const bool* __restrict__ mask, int n,
                            int n_buckets, float inv_res, float cell_size,
                            long long* __restrict__ khi, int* __restrict__ vyz) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = xyz[3 * i + 0], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
  int vx = static_cast<int>(floorf(x * inv_res));
  int vy = static_cast<int>(floorf(y * inv_res));
  int vz = static_cast<int>(floorf(z * inv_res));
  int b = n_buckets;
  if (mask[i]) {
    b = bucket_of(static_cast<int>(floorf(x / cell_size)), static_cast<int>(floorf(y / cell_size)),
                  static_cast<int>(floorf(z / cell_size)), n_buckets);
  } else {
    vx = 1 << 30;
  }
  khi[i] = (static_cast<long long>(b) << 32) | (static_cast<unsigned>(vx) ^ 0x80000000u);
  vyz[i] = pack_yz(vy, vz);
}

__device__ __forceinline__ int khi_bucket(long long k) { return static_cast<int>(k >> 32); }

__global__ void insert_keep(const long long* __restrict__ skhi, const long long* __restrict__ order,
                            const int* __restrict__ vyz, const float* __restrict__ table, int n,
                            int n_buckets, int slots, float inv_res, int* __restrict__ keep,
                            int* __restrict__ free_mask) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long k = skhi[i];
  int b = khi_bucket(k);
  int syz = vyz[order[i]];
  bool first = i == 0 || k != skhi[i - 1] || syz != vyz[order[i - 1]];
  int kept = 0, free_bits = 0;
  if (b < n_buckets && first) {
    int vx = static_cast<int>(static_cast<unsigned>(k) ^ 0x80000000u);
    int vy = syz / (1 << 15) - kYZOff, vz = syz % (1 << 15) - kYZOff;
    const float* row = table + static_cast<long long>(b) * slots * 4;
    bool dup = false;
    for (int s = 0; s < slots; ++s) {
      if (row[4 * s + 3] > 0.5f) {
        dup |= static_cast<int>(floorf(row[4 * s + 0] * inv_res)) == vx &&
               static_cast<int>(floorf(row[4 * s + 1] * inv_res)) == vy &&
               static_cast<int>(floorf(row[4 * s + 2] * inv_res)) == vz;
      } else {
        free_bits |= 1 << s;
      }
    }
    kept = !dup;
  }
  keep[i] = kept;
  free_mask[i] = free_bits;
}

__global__ void insert_place(const long long* __restrict__ skhi, const long long* __restrict__ order,
                             const float* __restrict__ xyz, const int* __restrict__ keep,
                             const int* __restrict__ free_mask, int n, int slots,
                             float* __restrict__ table) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !keep[i]) return;
  int b = khi_bucket(skhi[i]);
  int rank = 0;
  for (int j = i - 1; j >= 0 && khi_bucket(skhi[j]) == b; --j) rank += keep[j];
  int bits = free_mask[i];
  for (int s = 0; s < slots; ++s) {
    if (!(bits >> s & 1)) continue;
    if (rank-- > 0) continue;
    long long src = order[i];
    float* dst = table + (static_cast<long long>(b) * slots + s) * 4;
    dst[0] = xyz[3 * src + 0];
    dst[1] = xyz[3 * src + 1];
    dst[2] = xyz[3 * src + 2];
    dst[3] = 1.0f;
    return;
  }  // a full bucket drops the point
}

__global__ void crop(float* __restrict__ table, int n_slots, const float* __restrict__ center,
                     const float* __restrict__ last_center, float interval2, float radius2,
                     float* __restrict__ center_out) {
  float c0 = center[0], c1 = center[1], c2 = center[2];
  bool go = true;
  if (last_center != nullptr) {
    float d0 = c0 - last_center[0], d1 = c1 - last_center[1], d2 = c2 - last_center[2];
    go = ((d0 * d0 + d1 * d1) + d2 * d2) > interval2;
  }
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0 && center_out != nullptr) {
    center_out[0] = go ? c0 : last_center[0];
    center_out[1] = go ? c1 : last_center[1];
    center_out[2] = go ? c2 : last_center[2];
  }
  if (!go || i >= n_slots) return;
  float* p = table + 4 * static_cast<long long>(i);
  float dx = p[0] - c0, dy = p[1] - c1, dz = p[2] - c2;
  bool valid = p[3] > 0.5f && ((dx * dx + dy * dy) + dz * dz) < radius2;
  p[3] = valid ? 1.0f : 0.0f;
}

__global__ void table_keys(const float* __restrict__ xyz, const bool* __restrict__ mask, int n,
                           int n_buckets, float inv_cell, int* __restrict__ bucket) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bucket[i] = mask[i] ? bucket_of(static_cast<int>(floorf(xyz[3 * i + 0] * inv_cell)),
                                  static_cast<int>(floorf(xyz[3 * i + 1] * inv_cell)),
                                  static_cast<int>(floorf(xyz[3 * i + 2] * inv_cell)), n_buckets)
                      : n_buckets;
}

__global__ void table_zero(float4* __restrict__ table, long long n_slots) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n_slots) table[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__global__ void table_place(const int* __restrict__ sb, const long long* __restrict__ order,
                            const float* __restrict__ xyz, int n, int n_buckets, int slots,
                            float* __restrict__ table) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int b = sb[i];
  if (b >= n_buckets) return;
  int lo = 0, hi = i;  // the first row of b's run: a lower bound in [0, i]
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (sb[mid] < b) lo = mid + 1; else hi = mid;
  }
  int rank = i - lo;
  if (rank >= slots) return;
  long long src = order[i];
  float* dst = table + (static_cast<long long>(b) * slots + rank) * 4;
  dst[0] = xyz[3 * src + 0];
  dst[1] = xyz[3 * src + 1];
  dst[2] = xyz[3 * src + 2];
  dst[3] = 1.0f;
}

constexpr int kWarps = lvs::kThreads / 32;  // queries per block of knn_cell_query

__global__ void __launch_bounds__(lvs::kThreads)
knn_cell_query(const float* __restrict__ table, int n_buckets, int slots, float cs,
               const float* __restrict__ queries, int q, int k, float* __restrict__ dists,
               float* __restrict__ points, bool* __restrict__ valid) {
  __shared__ unsigned s_key[kWarps][8 * kMaxSlots];
  __shared__ int s_bucket[kWarps][8];
  __shared__ bool s_dup[kWarps][8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + warp;
  if (t >= q) return;  // the whole warp: no block-wide barrier follows
  const float qx = queries[3 * t + 0], qy = queries[3 * t + 1], qz = queries[3 * t + 2];
  if (lane < 8) {
    const float half = cs / 2.0f;
    s_bucket[warp][lane] = bucket_of(static_cast<int>(floorf((qx - half) / cs)) + (lane >> 2),
                                     static_cast<int>(floorf((qy - half) / cs)) + ((lane >> 1) & 1),
                                     static_cast<int>(floorf((qz - half) / cs)) + (lane & 1), n_buckets);
  }
  __syncwarp();
  if (lane < 8) {
    bool dup = false;
    for (int e = 0; e < lane; ++e) dup |= s_bucket[warp][e] == s_bucket[warp][lane];
    s_dup[warp][lane] = dup;
  }
  __syncwarp();
  const int m = 8 * slots;
  for (int c = lane; c < m; c += 32) {
    const int o = c / slots;
    const float* row = table + (static_cast<long long>(s_bucket[warp][o]) * slots + (c - o * slots)) * 4;
    float d2 = INFINITY;
    if (!s_dup[warp][o] && row[3] > 0.5f) {
      const float dx = qx - row[0], dy = qy - row[1], dz = qz - row[2];
      d2 = lvs::dot3_fma(dx, dy, dz, dx, dy, dz);
    }
    s_key[warp][c] = __float_as_uint(d2);
  }
  __syncwarp();
  for (int c = lane; c < m; c += 32) {
    const unsigned key = s_key[warp][c];
    int rank = 0;
    for (int j = 0; j < m; ++j) {
      const unsigned kj = s_key[warp][j];
      rank += kj < key || (kj == key && j < c);
    }
    if (rank >= k) continue;
    const int o = c / slots;
    const float* row = table + (static_cast<long long>(s_bucket[warp][o]) * slots + (c - o * slots)) * 4;
    const float d2 = __uint_as_float(key);
    const float d = sqrtf(d2 < 0.0f ? 0.0f : d2);  // clamp(min=0), NaN kept
    const long long out = static_cast<long long>(t) * k + rank;
    dists[out] = d;
    valid[out] = isfinite(d);
    for (int a = 0; a < 3; ++a) points[3 * out + a] = row[a];
  }
}

}  // namespace

extern "C" int lvs_table_keys(const float* xyz, const bool* mask, int n, int n_buckets, float inv_cell,
                              int* bucket, cudaStream_t stream) {
  if (n > 0)
    table_keys<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(xyz, mask, n, n_buckets, inv_cell, bucket);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_table_build(const int* sb, const long long* order, const float* xyz, int n, int n_buckets,
                               int slots, float* table, cudaStream_t stream) {
  long long n_slots = static_cast<long long>(n_buckets) * slots;
  if (n_slots > 0)
    table_zero<<<lvs::blocks_for(n_slots), lvs::kThreads, 0, stream>>>(reinterpret_cast<float4*>(table), n_slots);
  if (n > 0)
    table_place<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(sb, order, xyz, n, n_buckets, slots, table);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_insert_keys(const float* xyz, const bool* mask, int n, int n_buckets,
                               float inv_res, float cell_size, long long* khi, int* vyz,
                               cudaStream_t stream) {
  if (n > 0)
    insert_keys<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(xyz, mask, n, n_buckets, inv_res,
                                                                  cell_size, khi, vyz);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_insert_rows(const long long* skhi, const long long* order, const int* vyz,
                               const float* xyz, int n, int n_buckets, int slots, float inv_res,
                               int* keep, int* free_mask, float* table, cudaStream_t stream) {
  if (slots > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    insert_keep<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(
        skhi, order, vyz, table, n, n_buckets, slots, inv_res, keep, free_mask);
    insert_place<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(skhi, order, xyz, keep,
                                                                   free_mask, n, slots, table);
  }
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_crop_cell_table(float* table, int n_slots, const float* center,
                                   const float* last_center, float interval2, float radius2,
                                   float* center_out, cudaStream_t stream) {
  int threads = n_slots > 1 ? n_slots : 1;
  crop<<<lvs::blocks_for(threads), lvs::kThreads, 0, stream>>>(table, n_slots, center, last_center,
                                                               interval2, radius2, center_out);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_knn_cell(const float* table, int n_buckets, int slots, float cs, const float* queries, int q,
                            int k, float* dists, float* points, bool* valid, cudaStream_t stream) {
  if (slots > kMaxSlots || k < 1 || k > 8 * slots) return static_cast<int>(cudaErrorInvalidValue);
  if (q > 0)
    knn_cell_query<<<(q + kWarps - 1) / kWarps, lvs::kThreads, 0, stream>>>(table, n_buckets, slots, cs, queries,
                                                                           q, k, dists, points, valid);
  LVS_RETURN_LAST_ERROR();
}
