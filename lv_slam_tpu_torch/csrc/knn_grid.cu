// Kernels 9g and 9k: standalone LFA's sorted k-NN grid, its build and its
// queries (the k nearest, and the 2-point lines / 3-point planes of the
// scan-to-scan odometry).
//
// Replaces: lv_slam_tpu/ops/knn.py:39 `build_grid` (9g) and :280 `knn` (9k),
// with lv_slam_tpu/lfa/registration.py:41 `lines_from_2nn` and :94
// `planes_from_3nn` built on the same search.
//
// What bounds it on the card: latency. A build moves 4096 or 8064 points
// (~100 KB; GICP's 131072, ~2.6 MB), its launches one to a few waves each,
// the sort's look-backs in series; a query batch is 768 or 1536 queries (GICP's: 131072 on
// 131072-lane grids), each doing 27 binary searches over the keys and
// reading up to 216 candidate points, all of it L2-resident. Neither comes
// near HBM's rate or the card's arithmetic; the chains of dependent loads
// do, and at GICP's batch the instructions a query takes.
//
// Build design (9g, `lvs_knn_grid`: one C call, no host read and no torch
// op between its launches). Up to 8192 lanes (standalone LFA's 4096 and
// 8064) it is one launch of one 8-block cluster, `knn_grid_cluster`: the
// origin by block minima merged over distributed shared memory, each lane's
// word (flat key << 32 | lane; INT32_MAX for a masked or out-of-extent
// lane) sorted as kernel 9a sorts its rows (csrc/cluster_sort.cuh), the
// lane index making the words distinct and the order the twin's stable one;
// a word's place comes from binary searches of every other block's sorted
// words after a block copies them into its own shared memory (64 KB): the
// same searches over distributed shared memory took most of the launch
// (`scripts/k9_variants.py` times both).
// A larger build (GICP's 131072 lanes) is 7 launches, kernel 14's flat-key
// front end and scratch layout from csrc/voxel_keys.cuh, its passes from
// csrc/key_sort.cuh:
// 1. `knn_grid_ranges` (`flat_ranges`): each block's masked minimum,
//    maximum and unmasked count of the cells floor(x * (1/cell)) (as XLA
//    compiles the reference's division by a constant) to its partial row;
//    the same launch zeroes the sort's words.
// 2. `knn_grid_pack` (`flat_keys`, e = 1024): the origin is the masked
//    minimum cell, 0 where no lane is unmasked; an in-extent lane's (rel0,
//    rel1, rel2) packed into the fewest bits (the flat key's order), the
//    others dropped from the sort.
// 3. Four launches of `key_sort_pass` (30 bits at most; a pass past the
//    key's width returns on the device word): stable, so a cell's points
//    keep their input order.
// 4. `knn_grid_place`, a tile of 1024 positions a block: sorted position p
//    < n_valid gets the flat key (rel0 * 1024 + rel1) * 1024 + rel2 of its
//    packed key and its lane's point. The grid keeps every lane, and the
//    twin's stable sort leaves the masked and out-of-extent lanes (key
//    INT32_MAX) after the sorted ones in lane order: the same block takes
//    lanes [1024 t, 1024 (t + 1)), tests each as `flat_keys` did
//    (`flat_rel`), and writes a dropped lane to n_valid + the dropped lanes
//    before it, its tile's count placed after the earlier tiles' by
//    decoupled look-back. Dropping those lanes from the sort, rather than
//    sorting them under an extra top bit, keeps the packed key (and kernels
//    3 and 14's `flat_keys`) as it is, costs no digit pass where the three
//    fields fill a multiple of 8 bits, and spares the passes GICP's masked
//    lanes (~47k of 131072 lanes are unmasked there).
// The cell offsets are int32 differences that wrap, where the earlier
// kernel took them in int64: the origin is the minimum, so an offset is
// non-negative in exact arithmetic, and one past 2^31 - 1 cells wraps
// negative; both leave the extent alike (`tests/test_torch_knn.py` and
// chip_smoke's `knn_cases` hold a span past 2^31 cells). The grid is bit for
// bit the earlier route's (keys, origin, a torch.sort, a gather;
// `scripts/grid_table_parent.py` holds it so on the card).
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
#include "cluster_sort.cuh"
#include "common.cuh"
#include "key_sort.cuh"
#include "knn_search.cuh"
#include "voxel_keys.cuh"

#include <limits.h>

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
using lvs::kQueryThreads;
using lvs::kStageAll;
using lvs::kThreadQueries;
using lvs::launch_query;

// ----------------------------------------------------------- kernel 9g

constexpr int kGridPasses = 4;   // digit passes of a 30-bit packed key
constexpr int kPlaceItems = 4;   // positions (and lanes) a thread of the output pass
constexpr int kPlaceTile = lvs::kThreads * kPlaceItems;
constexpr int kPackBlocks = 132;  // the keys pass's grid cap, a block an SM: fewer blocks' digit counts to add
static_assert(kPlaceTile == kRunTile, "the layout's run status words are the output pass's tile words");

__global__ void __launch_bounds__(lvs::kThreads)
knn_grid_ranges(const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float inv,
                int* __restrict__ part, unsigned* __restrict__ zero, long long n_zero, int* __restrict__ origin) {
  flat_ranges(xyz, 3, mask, 1, n, inv, part, zero, n_zero);
  if (blockIdx.x == 0 && threadIdx.x == 0) origin[0] = origin[1] = origin[2] = 0;  // for n = 0: no keys pass
}

__global__ void __launch_bounds__(lvs::kThreads)
knn_grid_pack(const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float inv,
              const int* __restrict__ part, int n_part, FlatControl* fc, int* __restrict__ origin,
              unsigned long long* __restrict__ keys) {
  flat_keys(xyz, 3, mask, 1, n, inv, kExtent, part, n_part, fc, origin, keys);
}

__global__ void __launch_bounds__(lvs::kThreads)
knn_grid_place(const unsigned long long* __restrict__ keys_a, const unsigned* __restrict__ vals_a,
               const unsigned long long* __restrict__ keys_b, const unsigned* __restrict__ vals_b, FlatControl* fc,
               unsigned* tail_status, const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float inv,
               int* __restrict__ out_keys, float* __restrict__ out_xyz) {
  __shared__ int tile_id;
  __shared__ unsigned tile_base;
  // the tail's tile comes from a ticket (every earlier tile's block is then running: the look-back cannot wait
  // on one that has not started); the sorted positions take the block's index, as nothing waits on them
  if (threadIdx.x == 0) tile_id = static_cast<int>(atomicAdd(&fc->sort.tickets[ks::kMaxPasses], 1u));
  const int n_valid = fc->sort.n_valid;
  const bool in_a = (fc->sort.n_passes & 1) != 0;
  const unsigned long long* __restrict__ skeys = in_a ? keys_a : keys_b;
  const unsigned* __restrict__ svals = in_a ? vals_a : vals_b;
  const int b1 = fc->b1, b2 = fc->b2;
  const int o[3] = {fc->origin[0], fc->origin[1], fc->origin[2]};

  // the sorted positions: the key and the lane's point, every load of the
  // thread's positions issued before the stores
  const long long first = static_cast<long long>(blockIdx.x) * kPlaceTile + threadIdx.x;
  unsigned long long key[kPlaceItems];
  long long lane[kPlaceItems];
#pragma unroll
  for (int j = 0; j < kPlaceItems; ++j) {
    const long long p = first + j * lvs::kThreads;
    key[j] = p < n_valid ? skeys[p] : 0ull;
    lane[j] = p < n_valid ? svals[p] : 0;
  }
  float pt[kPlaceItems][3];
#pragma unroll
  for (int j = 0; j < kPlaceItems; ++j) {
#pragma unroll
    for (int k = 0; k < 3; ++k) pt[j][k] = first + j * lvs::kThreads < n_valid ? xyz[3 * lane[j] + k] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kPlaceItems; ++j) {
    const long long p = first + j * lvs::kThreads;
    if (p >= n_valid) break;
    out_keys[p] = flat_key(key[j], b1, b2, kExtent);
#pragma unroll
    for (int k = 0; k < 3; ++k) out_xyz[3 * p + k] = pt[j][k];
  }

  // the lanes of the ticket's tile that the sort dropped, in lane order
  // after the sorted positions
  __syncthreads();
  const int tile = tile_id;
  const long long mine0 = static_cast<long long>(tile) * kPlaceTile + threadIdx.x * kPlaceItems;
  bool dropped[kPlaceItems];
  unsigned count = 0;
#pragma unroll
  for (int j = 0; j < kPlaceItems; ++j) {
    int rel[3];
    dropped[j] = mine0 + j < n && !flat_rel(xyz, 3, mask, 1, mine0 + j, inv, o, kExtent, rel);
    count += dropped[j];
  }
  unsigned tile_count;
  unsigned at = ks::block_exclusive_scan(count, &tile_count);
  if (threadIdx.x < 32) {
    const unsigned b = ks::warp_lookback(tail_status, 1, tile, 1u, tile_count);
    if (threadIdx.x == 0) tile_base = b;
  }
  __syncthreads();
  long long pos = static_cast<long long>(n_valid) + tile_base + at;
#pragma unroll
  for (int j = 0; j < kPlaceItems; ++j) {
    if (!dropped[j]) continue;
    const long long i = mine0 + j;
    out_keys[pos] = kKeyMax;
#pragma unroll
    for (int k = 0; k < 3; ++k) out_xyz[3 * pos + k] = xyz[3 * i + k];
    ++pos;
  }
}

// Up to kClusterLanes lanes (standalone LFA's 4096 and 8064): one launch of
// one 8-block cluster, a lane a thread. The origin is the masked minimum
// cell (block minima, then the 8 blocks' over distributed shared memory);
// each lane's word is (flat key, INT32_MAX out of the extent or masked) <<
// 32 | lane, so the words are distinct and their order is the twin's stable
// sort, the dropped lanes last in lane order; csrc/cluster_sort.cuh sorts
// them; position p's thread writes its key and its lane's point.
constexpr int kClusterLanes = kSortCtas * kSortThreads;

__global__ void __cluster_dims__(kSortCtas, 1, 1) __launch_bounds__(kSortThreads)
knn_grid_cluster(const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float inv,
                 int* __restrict__ out_keys, float* __restrict__ out_xyz, int* __restrict__ origin) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ u64 staged[];        // every block's sorted keys, copied for the searches
  __shared__ u64 run[2 * kSortThreads];  // the warps' runs, then the merge's: the block's keys sorted at the back half
  __shared__ u64 sorted[kSortThreads];   // the block's positions of the cluster's order
  __shared__ int warp_min[kSortThreads / 32][3];
  __shared__ int block_min[3];
  __shared__ int cluster_min[kSortCtas][3];
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i = static_cast<long long>(rank) * kSortThreads + tid;
  const bool live = i < n, on = live && mask[i];

  // the origin: the minimum over the lanes of the cell, 2^30 for a masked
  // lane (the twin's where(mask, coords, BIG).amin), 0 where that is 2^30
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int m = __reduce_min_sync(
        0xffffffffu, on ? lvs::cell_floor(xyz[3 * i + k], inv) : (live ? kBigX : INT_MAX));
    if (lane == 0) warp_min[warp][k] = m;
  }
  __syncthreads();
  if (tid < 3) {
    int r = INT_MAX;
    for (int w = 0; w < kSortThreads / 32; ++w) r = min(r, warp_min[w][tid]);
    block_min[tid] = r;
  }
  cluster.sync();
  if (tid < 3 * kSortCtas) cluster_min[tid / 3][tid % 3] = cluster.map_shared_rank(block_min, tid / 3)[tid % 3];
  __syncthreads();
  int o[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int r = INT_MAX;
#pragma unroll
    for (int b = 0; b < kSortCtas; ++b) r = min(r, cluster_min[b][k]);
    o[k] = n == 0 || r == kBigX ? 0 : r;
  }

  // the lane's word; past the last lane, one above every lane's
  u64 word = ~0ull;
  if (live) {
    int rel[3];
    const int key = flat_rel(xyz, 3, mask, 1, i, inv, o, kExtent, rel) ? (rel[0] * kExtent + rel[1]) * kExtent + rel[2]
                                                                       : kKeyMax;
    word = (static_cast<u64>(static_cast<unsigned>(key)) << 32) | static_cast<unsigned>(i);
  }
  run[tid] = warp_sort(word);
  __syncthreads();
  merge_runs(run);
  cluster.sync();  // every block's keys sorted before the others copy them
  cluster_scatter_staged(run + kSortThreads, sorted, staged, rank);
  cluster.sync();  // every word at its place; no block reads another's memory after this
  if (live) {
    const u64 w = sorted[tid];
    const long long src = static_cast<long long>(w & 0xffffffffu);
    out_keys[i] = static_cast<int>(w >> 32);
#pragma unroll
    for (int k = 0; k < 3; ++k) out_xyz[3 * i + k] = xyz[3 * src + k];
  }
  if (rank == 0 && tid < 3) origin[tid] = o[tid];
}

constexpr int kClusterStaged = kSortCtas * kSortThreads * sizeof(u64);  // the dynamic shared memory of a block

Layout knn_grid_layout(int n) { return layout(n, sizeof(FlatControl)); }

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

extern "C" long long lvs_knn_grid_scratch_bytes(int n) {
  return n <= kClusterLanes ? 0ll : static_cast<long long>(knn_grid_layout(n).total);
}

// xyz (n, 3) and mask (n,); outputs the sorted keys (n,), the points in key
// order (n, 3) and the origin cell (3,); scratch of
// lvs_knn_grid_scratch_bytes(n) bytes.
extern "C" int lvs_knn_grid(const float* xyz, const bool* mask, int n, float inv_cell, void* scratch,
                            long long scratch_bytes, int* keys, float* out_xyz, int* origin, cudaStream_t stream) {
  if (n < 0 || n > ks::kMaxKeys) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= kClusterLanes) {
    const cudaError_t err =
        cudaFuncSetAttribute(knn_grid_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterStaged);
    if (err != cudaSuccess) return static_cast<int>(err);
    knn_grid_cluster<<<kSortCtas, kSortThreads, kClusterStaged, stream>>>(xyz, mask, n, inv_cell, keys, out_xyz,
                                                                            origin);
    LVS_RETURN_LAST_ERROR();
  }
  const Layout l = knn_grid_layout(n);
  if (scratch_bytes < static_cast<long long>(l.total)) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = scratch_at(scratch, l);
  auto* fc = reinterpret_cast<FlatControl*>(s.base);
  const int range_blocks = range_blocks_for(n, 0, s.n_zero);
  knn_grid_ranges<<<range_blocks, lvs::kThreads, 0, stream>>>(xyz, mask, n, inv_cell, s.part,
                                                              reinterpret_cast<unsigned*>(s.base), s.n_zero, origin);
  if (n == 0) LVS_RETURN_LAST_ERROR();
  knn_grid_pack<<<std::min(lvs::blocks_for(n), kPackBlocks), lvs::kThreads, 0, stream>>>(
      xyz, mask, n, inv_cell, s.part, range_blocks, fc, origin, s.keys_b);
  ks::launch_passes(n, s.keys_a, s.vals_a, s.keys_b, s.vals_b, &fc->sort, s.status, stream, kGridPasses);
  knn_grid_place<<<(n + kPlaceTile - 1) / kPlaceTile, lvs::kThreads, 0, stream>>>(
      s.keys_a, s.vals_a, s.keys_b, s.vals_b, fc, s.run_status, xyz, mask, n, inv_cell, keys, out_xyz);
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
