// Kernel 9: the LFA world maps' hashed cell tables: batch insert (9a), crop
// (9b), the whole-table build of the host mapping (9c) and the 8-cell k-NN
// (9n).
//
// Replaces: lv_slam_tpu/ops/knn.py:139 `insert_cell_table`, :218
// `crop_cell_table` (both LFA tables in one launch), :93 `build_cell_table`
// and :264 `knn_cell`. A table is (B, S*4) float32:
// S slots of [x, y, z, valid]
// per bucket; a 2 m cell hashes to bucket ((c0*H1) ^ (c1*H2) ^ (c2*H3)) mod B
// in uint32 arithmetic (the reference's wrapping int32 products, taken as
// uint32).
//
// What bounds it on the card: latency. An insert touches one 96-byte bucket
// row per batch point (4096 edge / 8064 surf points per scan, under 1 MB,
// ~0.00005 ms of HBM time); the crop is one pass over both tables (1.5 MB
// edge, 3 MB surf at the flagship capacities, ~1.4 us of HBM time at
// 3.35 TB/s), and nothing when its gate is closed. The insert of at most 8192 rows is bound by its chain of
// block-wide steps and five cluster barriers, not by the bytes.
//
// Insert design, a batch of at most 8192 rows (`insert_cluster`):
// one launch of one thread-block cluster, 8 blocks of 1024 threads, one
// row a thread (row rank * 1024 + t). (1) Keys: each row's bucket and
// 0.4 / 0.8 m voxel as `insert_keys` computes them (a multiply by the
// float32 reciprocal of the resolution, as XLA compiles the reference's
// constant division; masked rows in bucket B with vx 2^30); the batch's
// field ranges by a block reduction, then the 8 blocks' over distributed
// shared memory. (2) Sort: the keys of `ops/knn.py` `insert_sort_keys`,
// one 64-bit word when the fields' ranges fit 63 bits with the row index
// last (else two words), so every key is distinct and the order is the
// reference's stable three-key lax.sort. Each block sorts its 1024 keys
// (one-word keys: a bitonic sort of each warp's 32 in registers over
// shuffles, then five merge-path rounds in shared memory; two-word keys: a
// bitonic sort in shared memory); a key's place in the cluster's order is
// its rank in its block plus, in every other block, the count of keys
// before it (ten-step binary searches over distributed shared memory, ties
// to the lower block), and it is stored in the block that owns that place.
// (3) Keep: the first row of each voxel, unless a valid slot of its bucket
// row holds the voxel; each warp reads its rows' bucket rows together, 8
// lanes to a row and a slot to a lane (one coalesced 96-byte read per row,
// four rows' reads in flight), and a ballot returns the row's free slots.
// (4) Rank: a segmented exclusive scan of the keep flags over the cluster
// (warp, block, then the earlier blocks' aggregates in rank order),
// restarting at each bucket run; after the cluster barrier that ends every
// table read, each kept row writes the rank-th free slot of its bucket row
// (crop leaves holes, so the free slots are not a prefix): one writer per
// slot, deterministic. A full bucket drops the overflow. Larger batches take
// three launches: `insert_keys` writes two sort keys, the wrapper sorts them
// with two stable torch.sort passes (the least significant first),
// `insert_keep` finds the first row of each voxel and the bucket's free
// slots, and `insert_place` (a second launch, so no thread reads a row
// another one writes) counts the kept rows before it in its bucket run and
// writes the rank-th free slot. A cluster, not one block: one block's sort
// of 8192 keys runs on one SM, and the cluster spreads every per-row step
// over 8.
//
// Build design (9c, `lvs_build_cell_table`: one C call of 3 launches and
// the key sort's passes, no host read and no torch op between them):
// 1. `table_clear` zeroes the sort's words, the per-bucket counts and the
//    fill's tile words.
// 2. `table_count`: each unmasked row's bucket (its cell is floor(x *
//    (1/cell)), as XLA compiles the reference's division by a constant) is
//    its sort key, masked rows take none (the sort drops them); the digits
//    counted for the sort, the bucket's count by an integer atomic (the
//    totals do not depend on the order), the valid rows into the sort's
//    count.
// 3. The passes of csrc/key_sort.cuh, as many as B - 1 has digits (the host
//    knows B: 2 for the flagship's 2^14 and 2^15 buckets, 3 up to 2^24, 1 up
//    to 256): stable, so each bucket's rows form one run in input order.
// 4. `table_fill`, a thread a sorted position and a table slot: the row at
//    sorted position i is the rank-th of its bucket's run, rank the equal
//    keys just before it (at most S read), and fills slot (bucket, rank)
//    with flag 1.0 when rank < S; slot (b, s) of a bucket counted at most s
//    rows is zeroed (+0.0). Every slot is written once, in a 16-byte store,
//    and has one writer, so the table is deterministic; it is bit for bit
//    the twin's (a stable sort, each row's rank in its run, one scatter of
//    ranks below S into a zeroed table) and the earlier route's (a
//    torch.sort between two launches, a clear of the whole table, then a
//    binary search a row; `scripts/grid_table_parent.py` holds it so on the
//    card). What bounds it: the table's write (3 MB for the surf map's 2^15
//    x 6 slots, ~1 us of HBM time) and the 65536-row sort's launches.
//
// Crop design (`crop_tables`): one launch crops the LFA step's two tables
// (or one), in place, a thread eight slots. With a last crop
// center every block first decides the crop_interval gate itself, from
// device memory (moved^2 > interval^2), and exits at once when it is
// closed, so the LFA step reads nothing back to the host; block 0's first
// thread writes the new crop center. Open, the grid covers both tables'
// slots as one range in one round, eight 16-byte slot loads in flight a
// thread, and stores a slot's valid flag only where its bits change (a
// valid slot that leaves the radius: the flag turns 0). Most launches find
// the gate closed, and then their time is the grid's: eight slots a thread
// (144 blocks at the flagship's tables) keep it small
// (`scripts/k14_variants.py` times one, four and eight).
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
#include "cluster_sort.cuh"
#include "common.cuh"
#include "key_sort.cuh"

#include <cooperative_groups.h>
#include <math.h>

#include <algorithm>

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
  int vx = lvs::cell_floor(x, inv_res);
  int vy = lvs::cell_floor(y, inv_res);
  int vz = lvs::cell_floor(z, inv_res);
  int b = n_buckets;
  if (mask[i]) {
    b = bucket_of(lvs::cell_floor_div(x, cell_size), lvs::cell_floor_div(y, cell_size),
                  lvs::cell_floor_div(z, cell_size), n_buckets);
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
        dup |= lvs::cell_floor(row[4 * s + 0], inv_res) == vx && lvs::cell_floor(row[4 * s + 1], inv_res) == vy &&
               lvs::cell_floor(row[4 * s + 2], inv_res) == vz;
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

// ---- 9a up to 8192 rows: keys, sort, keep, rank and place in one cluster launch ----

constexpr int kInsCtas = kSortCtas;        // one thread-block cluster, the portable size
constexpr int kInsThreads = kSortThreads;  // per block, one row a thread
constexpr int kInsWarps = kInsThreads / 32;
constexpr int kInsMaxRows = kInsCtas * kInsThreads;  // 8192

// Ascending bitonic sort of n_pad two-word keys in shared memory (hi words
// at sm, lo words at sm + n_pad): the rare batch whose fields pass 63 bits.
__device__ void bitonic_shared(u64* sm, int n_pad) {
  for (int k = 2; k <= n_pad; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n_pad / 2; i += kInsThreads) {
        const int a = 2 * i - (i & (j - 1)), b = a + j;  // i with a 0 inserted at bit log2(j)
        const Wide x = {sm[a], sm[n_pad + a]}, y = {sm[b], sm[n_pad + b]};
        if (key_lt(y, x) != ((a & k) != 0)) {
          sm[a] = y.hi;
          sm[n_pad + a] = y.lo;
          sm[b] = x.hi;
          sm[n_pad + b] = x.lo;
        }
      }
      __syncthreads();
    }
  }
}

// The batch's field ranges: minima over rows, maxima as minima of ~x.
enum { kBMin, kBMax, kXMin, kXMax, kYMin, kYMax, kZMin, kZMax, kMYMin, kMYMax, kMZMin, kMZMax, kRanges };

struct Packing {
  int b0, x0, y0, z0, my0, mz0;  // offsets: all rows' bucket; valid rows' vx, cy, cz; masked rows' cy, cz
  int wx, wy, wz, wi;            // field widths in bits
};

__device__ __forceinline__ int bit_length(unsigned x) { return 32 - __clz(x); }

__device__ __forceinline__ int span_bits(int lo, int not_hi) {  // bits of hi - lo, 0 for an empty set
  const int hi = ~not_hi;
  return hi < lo ? 0 : bit_length(static_cast<unsigned>(hi) - static_cast<unsigned>(lo));
}

__device__ __forceinline__ u64 narrow_key(const Packing& q, int b, int vx, int cy, int cz, int row, bool valid) {
  u64 k = static_cast<unsigned>(b - q.b0);
  k = (k << q.wx) | (valid ? static_cast<unsigned>(vx) - static_cast<unsigned>(q.x0) : 0u);
  k = (k << q.wy) | static_cast<unsigned>(cy - (valid ? q.y0 : q.my0));
  k = (k << q.wz) | static_cast<unsigned>(cz - (valid ? q.z0 : q.mz0));
  return (k << q.wi) | static_cast<unsigned>(row);
}

struct Row {
  int b, vx, cy, cz, row;
};

__device__ __forceinline__ Row decode(const Packing& q, const Narrow& a, int n_buckets) {
  u64 k = a.k;
  Row r;
  r.row = static_cast<int>(k & ((1ull << q.wi) - 1));
  k >>= q.wi;
  const int cz = static_cast<int>(k & ((1ull << q.wz) - 1));
  k >>= q.wz;
  const int cy = static_cast<int>(k & ((1ull << q.wy) - 1));
  k >>= q.wy;
  const unsigned vx = static_cast<unsigned>(k & ((1ull << q.wx) - 1));
  r.b = static_cast<int>(k >> q.wx) + q.b0;
  const bool valid = r.b < n_buckets;
  r.vx = static_cast<int>(vx + static_cast<unsigned>(q.x0));
  r.cy = cy + (valid ? q.y0 : q.my0);
  r.cz = cz + (valid ? q.z0 : q.mz0);
  return r;
}
__device__ __forceinline__ Row decode(const Packing&, const Wide& a, int) {
  Row r;
  r.b = static_cast<int>(a.hi >> 32);
  r.vx = static_cast<int>(static_cast<unsigned>(a.hi) ^ 0x80000000u);
  const int vyz = static_cast<int>(a.lo >> 32);
  r.cy = vyz >> 15;
  r.cz = vyz & ((1 << 15) - 1);
  r.row = static_cast<int>(static_cast<unsigned>(a.lo));
  return r;
}

// Whether two keys are of one bucket; of one voxel of one bucket (all
// fields but the row).
__device__ __forceinline__ bool same_bucket(const Packing& q, const Narrow& a, const Narrow& b) {
  const int shift = q.wx + q.wy + q.wz + q.wi;
  return (a.k >> shift) == (b.k >> shift);
}
__device__ __forceinline__ bool same_bucket(const Packing&, const Wide& a, const Wide& b) {
  return (a.hi >> 32) == (b.hi >> 32);
}
__device__ __forceinline__ bool same_voxel(const Packing& q, const Narrow& a, const Narrow& b) {
  return (a.k >> q.wi) == (b.k >> q.wi);
}
__device__ __forceinline__ bool same_voxel(const Packing&, const Wide& a, const Wide& b) {
  return a.hi == b.hi && (a.lo >> 32) == (b.lo >> 32);
}

// (segment-start flag, count) pairs, the earlier first: a segmented sum.
__device__ __forceinline__ void seg_add(bool& f, int& v, bool f_earlier, int v_earlier) {
  if (!f) v += v_earlier;
  f |= f_earlier;
}

// A block's shared memory (dynamic: over 48 KB).
struct InsertShared {
  u64 run[2][kInsThreads];     // the block's keys: warp runs and the merge's (narrow); hi, lo words (wide)
  u64 sorted[2][kInsThreads];  // the block's 1024 positions of the cluster's order, written by every block
  int ranges[kRanges];         // the block's field ranges, read by every block
  int all_ranges[kRanges];
  int red[kRanges][kInsWarps];
  int4 check_row[kInsWarps][32];  // a warp's rows to check: bucket and voxel
  int check_dup[kInsWarps][32], check_free[kInsWarps][32];
  int warp_f[kInsWarps], warp_v[kInsWarps];
  int block_f, block_v;        // the block's scan aggregate, read by the later blocks
};

// Keep, rank and place over the cluster's sorted keys: thread t of block
// `rank` owns position rank * 1024 + t.
template <typename K>
__device__ void keep_and_place(const float* __restrict__ xyz, int n, int n_buckets, int slots, float inv_res,
                               const Packing& q, InsertShared& sh, int rank, float* __restrict__ table) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = rank * kInsThreads + tid;
  const u64* keys = &sh.sorted[0][0];

  // run starts and the rows to check: the first row of each voxel in a
  // valid bucket
  bool start = true, check = false;
  K key;
  if (p < n) {
    key = key_at(keys, kInsThreads, tid, K{});
    bool first = true;
    if (p > 0) {
      const K before = tid > 0 ? key_at(keys, kInsThreads, tid - 1, K{})
                               : key_at(cluster.map_shared_rank(keys, rank - 1), kInsThreads, kInsThreads - 1, K{});
      start = !same_bucket(q, before, key);
      first = !same_voxel(q, before, key);
    }
    check = first && decode(q, key, n_buckets).b < n_buckets;
  }

  // keep: a checked row whose voxel no valid slot of its bucket row holds.
  // The warp checks its rows together, `group` lanes to a row and one slot
  // to a lane, so each bucket row is one coalesced read and four rows'
  // reads are in flight at once; the row's free slots come back from a
  // ballot
  const int group = slots <= 8 ? 8 : slots <= 16 ? 16 : 32, per_pass = 32 / group;
  const unsigned group_bits = group == 32 ? 0xffffffffu : (1u << group) - 1;
  const int g = lane / group, slot = lane % group;
  bool keep = false;
  int free_bits = 0;
  const unsigned need = __ballot_sync(0xffffffffu, check);
  const int idx = __popc(need & ((1u << lane) - 1)), n_need = __popc(need);
  if (check) {
    const Row r = decode(q, key, n_buckets);
    sh.check_row[warp][idx] = make_int4(r.b, r.vx, r.cy - kYZOff, r.cz - kYZOff);
  }
  __syncwarp();
  for (int first_row = 0; first_row < n_need; first_row += 4 * per_pass) {
    float4 s[4];
    int4 c[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = first_row + u * per_pass + g;
      c[u] = sh.check_row[warp][min(i, n_need - 1)];
      s[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < n_need && slot < slots)
        s[u] = reinterpret_cast<const float4*>(table)[static_cast<long long>(c[u].x) * slots + slot];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = first_row + u * per_pass + g;
      const bool act = i < n_need && slot < slots, occupied = act && s[u].w > 0.5f;
      const bool same = occupied && lvs::cell_floor(s[u].x, inv_res) == c[u].y &&
                        lvs::cell_floor(s[u].y, inv_res) == c[u].z && lvs::cell_floor(s[u].z, inv_res) == c[u].w;
      const unsigned dups = __ballot_sync(0xffffffffu, same), frees = __ballot_sync(0xffffffffu, act && !occupied);
      if (slot == 0 && i < n_need) {
        sh.check_dup[warp][i] = (dups >> (g * group) & group_bits) != 0;
        sh.check_free[warp][i] = static_cast<int>(frees >> (g * group) & group_bits);
      }
    }
  }
  __syncwarp();
  if (check) {
    keep = !sh.check_dup[warp][idx];
    free_bits = sh.check_free[warp][idx];
  }

  // rank: the kept rows before each row in its bucket run, a segmented
  // exclusive scan over the cluster (the warp, the block's warps, the
  // earlier blocks in rank order)
  bool f = start;
  int c = keep;
  for (int d = 1; d < 32; d <<= 1) {
    const bool of = __shfl_up_sync(0xffffffffu, f, d);
    const int oc = __shfl_up_sync(0xffffffffu, c, d);
    if (lane >= d) seg_add(f, c, of, oc);
  }
  if (lane == 31) {
    sh.warp_f[warp] = f;
    sh.warp_v[warp] = c;
  }
  bool xf = __shfl_up_sync(0xffffffffu, f, 1);  // this thread's exclusive prefix within its warp
  int xc = __shfl_up_sync(0xffffffffu, c, 1);
  if (lane == 0) {
    xf = false;
    xc = 0;
  }
  __syncthreads();
  if (warp == 0) {
    bool wf = sh.warp_f[lane];
    int wc = sh.warp_v[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const bool of = __shfl_up_sync(0xffffffffu, wf, d);
      const int oc = __shfl_up_sync(0xffffffffu, wc, d);
      if (lane >= d) seg_add(wf, wc, of, oc);
    }
    sh.warp_f[lane] = wf;
    sh.warp_v[lane] = wc;
    if (lane == 31) {
      sh.block_f = wf;
      sh.block_v = wc;
    }
  }
  cluster.sync();  // every block's table reads are done before any write below; the aggregates are written
  if (warp > 0) seg_add(xf, xc, sh.warp_f[warp - 1], sh.warp_v[warp - 1]);
  for (int b = rank - 1; b >= 0 && !xf; --b) {  // the earlier blocks, the nearest first
    const InsertShared* o = cluster.map_shared_rank(&sh, b);
    seg_add(xf, xc, o->block_f, o->block_v);
  }

  // place: a kept row takes the rank-th free slot of its bucket row (one
  // writer per slot); a full bucket drops it
  if (keep) {
    int bits = free_bits;
    const int rank_in_run = start ? 0 : xc;
    for (int i = 0; i < rank_in_run && bits; ++i) bits &= bits - 1;  // drop the lowest free slots
    if (bits) {
      const Row r = decode(q, key, n_buckets);
      const long long src = r.row;
      reinterpret_cast<float4*>(table)[static_cast<long long>(r.b) * slots + __ffs(bits) - 1] =
          make_float4(xyz[3 * src + 0], xyz[3 * src + 1], xyz[3 * src + 2], 1.0f);
    }
  }
}

__global__ void __cluster_dims__(kInsCtas, 1, 1) __launch_bounds__(kInsThreads, 1)
insert_cluster(const float* __restrict__ xyz, const bool* __restrict__ mask, int n, int n_buckets, int slots,
               float inv_res, float cell_size, float* __restrict__ table) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char insert_smem[];
  InsertShared& sh = *reinterpret_cast<InsertShared*>(insert_smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int p = rank * kInsThreads + tid;  // this thread's row

  // keys: insert_keys's bucket and voxel, and the field ranges of the
  // block, then of the cluster
  int b = n_buckets, vx = 0, cy = 0, cz = 0;
  bool valid = false;
  int mn[kRanges];
#pragma unroll
  for (int i = 0; i < kRanges; ++i) mn[i] = 0x7fffffff;
  if (p < n) {
    // a power-of-two cell divides exactly as a multiply by its reciprocal;
    // h mod B by Lemire's exact 64-bit multiply
    const bool cell_pow2 =
        (__float_as_uint(cell_size) & 0x807fffffu) == 0 && cell_size >= 1.17549435e-38f && isfinite(cell_size);
    const float inv_cell = 1.0f / cell_size;
    const auto cell = [&](float a) {
      return static_cast<unsigned>(cell_pow2 ? lvs::cell_floor(a, inv_cell) : lvs::cell_floor_div(a, cell_size));
    };
    const float x = xyz[3 * p + 0], y = xyz[3 * p + 1], z = xyz[3 * p + 2];
    valid = mask[p];
    vx = valid ? lvs::cell_floor(x, inv_res) : 1 << 30;
    cy = min(max(lvs::cell_floor(y, inv_res) + kYZOff, 0), kYZLim);
    cz = min(max(lvs::cell_floor(z, inv_res) + kYZOff, 0), kYZLim);
    if (valid) {
      const unsigned h = (cell(x) * kH1) ^ (cell(y) * kH2) ^ (cell(z) * kH3);  // bucket_of
      const u64 mod_m = ~0ull / static_cast<unsigned>(n_buckets) + 1;
      b = static_cast<int>(__umul64hi(mod_m * h, static_cast<unsigned>(n_buckets)));
      mn[kXMin] = vx;
      mn[kXMax] = ~vx;
      mn[kYMin] = cy;
      mn[kYMax] = ~cy;
      mn[kZMin] = cz;
      mn[kZMax] = ~cz;
    } else {
      mn[kMYMin] = cy;
      mn[kMYMax] = ~cy;
      mn[kMZMin] = cz;
      mn[kMZMax] = ~cz;
    }
    mn[kBMin] = b;
    mn[kBMax] = ~b;
  }
#pragma unroll
  for (int i = 0; i < kRanges; ++i) {
    int m = mn[i];
    for (int d = 16; d > 0; d >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, d));
    if (lane == 0) sh.red[i][warp] = m;
  }
  __syncthreads();
  if (tid < kRanges) {
    int m = sh.red[tid][0];
    for (int w = 1; w < kInsWarps; ++w) m = min(m, sh.red[tid][w]);
    sh.ranges[tid] = m;
  }
  cluster.sync();
  if (tid < kRanges) {
    int m = 0x7fffffff;
    for (int c = 0; c < kInsCtas; ++c) m = min(m, cluster.map_shared_rank(sh.ranges, c)[tid]);
    sh.all_ranges[tid] = m;
  }
  __syncthreads();
  const int* rg = sh.all_ranges;
  Packing q;
  q.b0 = rg[kBMin];
  q.x0 = rg[kXMin];
  q.y0 = rg[kYMin];
  q.z0 = rg[kZMin];
  q.my0 = rg[kMYMin];
  q.mz0 = rg[kMZMin];
  const int wb = span_bits(rg[kBMin], rg[kBMax]);
  q.wx = span_bits(rg[kXMin], rg[kXMax]);
  q.wy = max(span_bits(rg[kYMin], rg[kYMax]), span_bits(rg[kMYMin], rg[kMYMax]));
  q.wz = max(span_bits(rg[kZMin], rg[kZMax]), span_bits(rg[kMZMin], rg[kMZMax]));
  q.wi = bit_length(static_cast<unsigned>(n - 1));

  // sort: each block sorts its 1024 keys (one-word keys: warp runs in
  // registers, then merges; two-word keys: a bitonic sort in shared
  // memory), then the cluster places every key
  if (wb + q.wx + q.wy + q.wz + q.wi <= 63) {
    sh.run[0][tid] = warp_sort(p < n ? narrow_key(q, b, vx, cy, cz, p, valid) : ~0ull);
    __syncthreads();
    merge_runs(&sh.run[0][0]);
    cluster.sync();  // every block's keys are sorted before any block searches them
    cluster_scatter<Narrow>(&sh.run[1][0], &sh.sorted[0][0], rank);
    cluster.sync();
    keep_and_place<Narrow>(xyz, n, n_buckets, slots, inv_res, q, sh, rank, table);
  } else {
    sh.run[0][tid] = p < n ? (static_cast<u64>(b) << 32) | (static_cast<unsigned>(vx) ^ 0x80000000u) : ~0ull;
    sh.run[1][tid] = p < n ? (static_cast<u64>(cy * (1 << 15) + cz) << 32) | static_cast<unsigned>(p) : ~0ull;
    __syncthreads();
    bitonic_shared(&sh.run[0][0], kInsThreads);
    cluster.sync();
    cluster_scatter<Wide>(&sh.run[0][0], &sh.sorted[0][0], rank);
    cluster.sync();
    keep_and_place<Wide>(xyz, n, n_buckets, slots, inv_res, q, sh, rank, table);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

constexpr int kCropUnroll = 8;  // slots a thread loads at once: one round covers the tables

// The slots of table a (n_a of them) then those of table b (n_b) as one
// range; each slot a float4 [x, y, z, valid].
__global__ void __launch_bounds__(lvs::kThreads)
crop_tables(float4* __restrict__ a, long long n_a, float4* __restrict__ b, long long n_b,
            const float* __restrict__ center, const float* __restrict__ last_center, float interval2, float radius2,
            float* __restrict__ center_out) {
  const float c0 = center[0], c1 = center[1], c2 = center[2];
  bool go = true;
  if (last_center != nullptr) {
    const float d0 = c0 - last_center[0], d1 = c1 - last_center[1], d2 = c2 - last_center[2];
    go = ((d0 * d0 + d1 * d1) + d2 * d2) > interval2;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && center_out != nullptr) {
    center_out[0] = go ? c0 : last_center[0];
    center_out[1] = go ? c1 : last_center[1];
    center_out[2] = go ? c2 : last_center[2];
  }
  if (!go) return;  // the whole grid: the gate reads the same words everywhere
  const long long n = n_a + n_b, stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += kCropUnroll * stride) {
    float4 p[kCropUnroll];
#pragma unroll
    for (int u = 0; u < kCropUnroll; ++u) {
      const long long j = i + u * stride;
      if (j < n) p[u] = j < n_a ? a[j] : b[j - n_a];
    }
#pragma unroll
    for (int u = 0; u < kCropUnroll; ++u) {
      const long long j = i + u * stride;
      if (j >= n) continue;
      const float dx = p[u].x - c0, dy = p[u].y - c1, dz = p[u].z - c2;
      const bool valid = p[u].w > 0.5f && ((dx * dx + dy * dy) + dz * dz) < radius2;
      const float flag = valid ? 1.0f : 0.0f;
      if (__float_as_uint(flag) != __float_as_uint(p[u].w)) (j < n_a ? a[j] : b[j - n_a]).w = flag;
    }
  }
}

// ---------------------------------------------------------------- kernel 9c

namespace ks = lvs::keysort;

constexpr int kClearBlocks = 528;  // the clear's grid cap: 4 blocks an SM
constexpr int kCountBlocks = 132;  // the count's grid cap, a block an SM: fewer blocks' digit counts to add

// The scratch of one build, in bytes from its start: the words that the
// clear zeroes (the sort's control and tile status words, the bucket
// counts), then two key and two value buffers.
struct TableLayout {
  size_t status, counts, zero_end, keys_a, keys_b, vals_a, vals_b, total;
};

inline size_t up256(size_t x) { return (x + 255) / 256 * 256; }

TableLayout table_layout(int n, int n_buckets) {
  const size_t tiles = n > 0 ? (static_cast<size_t>(n) + ks::kTile - 1) / ks::kTile : 1;
  TableLayout l;
  l.status = up256(sizeof(ks::Control));
  l.counts = up256(l.status + tiles * ks::kRadix * sizeof(unsigned));
  l.zero_end = up256(l.counts + static_cast<size_t>(n_buckets) * sizeof(unsigned));
  l.keys_a = l.zero_end;
  l.keys_b = up256(l.keys_a + n * sizeof(unsigned long long));
  l.vals_a = up256(l.keys_b + n * sizeof(unsigned long long));
  l.vals_b = up256(l.vals_a + n * sizeof(unsigned));
  l.total = up256(l.vals_b + n * sizeof(unsigned));
  return l;
}

__global__ void __launch_bounds__(lvs::kThreads) table_clear(uint4* __restrict__ words, long long n_words) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_words; i += stride)
    words[i] = make_uint4(0u, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(lvs::kThreads)
table_count(const float* __restrict__ xyz, const bool* __restrict__ mask, int n, int n_buckets, float inv_cell,
            int n_passes, ks::Control* ctl, unsigned* __restrict__ counts, unsigned long long* __restrict__ keys) {
  __shared__ unsigned digits[ks::kMaxPasses][ks::kRadix];
  __shared__ unsigned block_valid;
  for (int i = threadIdx.x; i < ks::kMaxPasses * ks::kRadix; i += blockDim.x) (&digits[0][0])[i] = 0u;
  if (threadIdx.x == 0) block_valid = 0u;
  if (blockIdx.x == 0 && threadIdx.x == 0) ctl->n_passes = n_passes;
  __syncthreads();
  unsigned mine = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
#pragma unroll 2
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    unsigned long long key = ks::kInvalidKey;
    const float x = xyz[3 * i + 0], y = xyz[3 * i + 1], z = xyz[3 * i + 2];  // read with the mask, not after it
    if (mask[i]) {
      const int b = bucket_of(lvs::cell_floor(x, inv_cell), lvs::cell_floor(y, inv_cell), lvs::cell_floor(z, inv_cell),
                              n_buckets);
      key = static_cast<unsigned long long>(b);
      ks::count_digits(digits, key, n_passes);
      atomicAdd(counts + b, 1u);
      ++mine;
    }
    keys[i] = key;
  }
  mine = lvs::warp_sum(mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&block_valid, mine);
  __syncthreads();
  ks::flush_digits(digits, n_passes, ctl);
  if (threadIdx.x == 0 && block_valid) atomicAdd(reinterpret_cast<unsigned*>(&ctl->n_valid), block_valid);
}

// One thread a sorted position and a table slot, on a grid over the larger
// count: the row at sorted position i, the rank-th of its bucket's run
// (rank < S: fewer than S equal keys before it), fills slot (bucket, rank);
// slot (b, s) of a bucket holding at most s rows is zeroed. Each slot has
// one writer.
__global__ void __launch_bounds__(lvs::kThreads)
table_fill(const unsigned long long* __restrict__ skeys, const unsigned* __restrict__ svals,
           const unsigned* __restrict__ counts, const ks::Control* ctl, const float* __restrict__ xyz,
           int n_buckets, int slots, float4* __restrict__ table) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n_slots = static_cast<long long>(n_buckets) * slots;
  if (i < n_slots) {
    const long long b = i / slots;
    if (i - b * slots >= counts[b]) table[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  if (i < ctl->n_valid) {
    const unsigned long long key = skeys[i];
    int rank = 0;
    while (rank < slots && rank < i && skeys[i - rank - 1] == key) ++rank;
    if (rank < slots) {
      const long long row = svals[i];
      table[static_cast<long long>(key) * slots + rank] =
          make_float4(xyz[3 * row + 0], xyz[3 * row + 1], xyz[3 * row + 2], 1.0f);
    }
  }
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
    s_bucket[warp][lane] = bucket_of(lvs::cell_floor_div(qx - half, cs) + (lane >> 2),
                                     lvs::cell_floor_div(qy - half, cs) + ((lane >> 1) & 1),
                                     lvs::cell_floor_div(qz - half, cs) + (lane & 1), n_buckets);
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

extern "C" long long lvs_cell_table_scratch_bytes(int n, int n_buckets) {
  return static_cast<long long>(table_layout(n, n_buckets).total);
}

// xyz (n, 3) and mask (n,) -> table (n_buckets, slots * 4); n_passes digit
// passes, enough for the bucket B - 1; scratch of
// lvs_cell_table_scratch_bytes(n, n_buckets) bytes.
extern "C" int lvs_build_cell_table(const float* xyz, const bool* mask, int n, int n_buckets, int slots,
                                    float inv_cell, int n_passes, void* scratch, long long scratch_bytes,
                                    float* table, cudaStream_t stream) {
  if (n < 0 || n > ks::kMaxKeys || n_buckets < 1 || slots < 1 || n_passes < 1 || n_passes > ks::kMaxPasses ||
      (static_cast<unsigned long long>(n_buckets - 1) >> (ks::kDigitBits * n_passes)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const TableLayout l = table_layout(n, n_buckets);
  if (scratch_bytes < static_cast<long long>(l.total)) return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(scratch);
  auto* ctl = reinterpret_cast<ks::Control*>(base);
  auto* counts = reinterpret_cast<unsigned*>(base + l.counts);
  auto* keys_a = reinterpret_cast<unsigned long long*>(base + l.keys_a);
  auto* keys_b = reinterpret_cast<unsigned long long*>(base + l.keys_b);
  auto* vals_a = reinterpret_cast<unsigned*>(base + l.vals_a);
  auto* vals_b = reinterpret_cast<unsigned*>(base + l.vals_b);
  const long long n_words = static_cast<long long>(l.zero_end / sizeof(uint4));
  table_clear<<<std::max(1, std::min(lvs::blocks_for(n_words), kClearBlocks)), lvs::kThreads, 0, stream>>>(
      reinterpret_cast<uint4*>(base), n_words);
  if (n > 0) {
    table_count<<<std::min(lvs::blocks_for(n), kCountBlocks), lvs::kThreads, 0, stream>>>(
        xyz, mask, n, n_buckets, inv_cell, n_passes, ctl, counts, keys_b);
    ks::launch_passes(n, keys_a, vals_a, keys_b, vals_b, ctl, reinterpret_cast<unsigned*>(base + l.status), stream,
                      n_passes);
  }
  const bool in_a = (n_passes & 1) != 0;
  table_fill<<<lvs::blocks_for(std::max(static_cast<long long>(n_buckets) * slots, static_cast<long long>(n))),
               lvs::kThreads, 0, stream>>>(in_a ? keys_a : keys_b, in_a ? vals_a : vals_b, counts, ctl, xyz,
                                           n_buckets, slots, reinterpret_cast<float4*>(table));
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

extern "C" int lvs_insert_cell_table(const float* xyz, const bool* mask, int n, int n_buckets, int slots,
                                     float inv_res, float cell_size, float* table, cudaStream_t stream) {
  if (slots > kMaxSlots || n > kInsMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) LVS_RETURN_LAST_ERROR();
  const int bytes = sizeof(InsertShared);
  cudaError_t err = cudaFuncSetAttribute(insert_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  insert_cluster<<<kInsCtas, kInsThreads, bytes, stream>>>(xyz, mask, n, n_buckets, slots, inv_res, cell_size, table);
  LVS_RETURN_LAST_ERROR();
}

// Crops tables a (n_a slots) and b (n_b; 0 for one table) in one launch;
// the tables are 16-byte aligned. last_center null: no gate.
extern "C" int lvs_crop_cell_tables(float* a, int n_a, float* b, int n_b, const float* center,
                                    const float* last_center, float interval2, float radius2, float* center_out,
                                    cudaStream_t stream) {
  if (n_a < 0 || n_b < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(n_a) + n_b;
  const int blocks = std::max(1, lvs::blocks_for((n + kCropUnroll - 1) / kCropUnroll));
  crop_tables<<<blocks, lvs::kThreads, 0, stream>>>(reinterpret_cast<float4*>(a), n_a, reinterpret_cast<float4*>(b),
                                                   n_b, center, last_center, interval2, radius2, center_out);
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
