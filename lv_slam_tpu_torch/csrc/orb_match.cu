// Kernel 12b: masked mutual-best descriptor matching of one keyframe
// against a batch of loop candidates.
//
// Replaces: lv_slam_tpu/ops/orb.py:274 `match_scores_batch` (its device
// program :254 `_match_scores_masked`, over :225 `hamming_matrix`).
//
// What it computes, as the reference does: d(i, j) is the Hamming distance
// of query row i and candidate row j, 1e9 where either side is masked;
// best_ab[i] and best_ba[j] are the row and column argmins, the first index
// on ties; row i counts when it is unmasked, best_ba[best_ab[i]] == i and
// float(d(i, best_ab[i])) <= max_dist; the score is
// n_good / max(min(na, nb), 1) in float32.
//
// What bounds it on the card: 8 candidates of 512 x 32-byte descriptors are
// 130 KB and the 348 x 348 valid pairs of each ~25 integer operations, under
// a microsecond at the card's rates. But a distance is 8 `__popc`, which
// issue at 16 a cycle per SM (a quarter of the integer rate), so the pairs
// cost ~0.5 cycle each on the SMs that hold them: how many SMs share the
// work is what bounds it. The first kernel ran one block per candidate (8 of
// the 132 SMs), and each thread walked every row twice, once for the column
// argmin and once for the row argmin, so each distance was computed twice:
// 0.1190 ms.
//
// Design: one thread-block cluster of kCtas = 8 blocks x 512 threads per
// candidate, so 8 candidates fill 64 SMs; each distance is computed once.
// (1) Every block compacts both masks with warp ballots: the unmasked query
// rows and candidate columns in order, and each column's place in its list.
// Masked rows and columns are never walked; their results are the
// contract's defaults (an all-masked row or column picks index 0).
// (2) Block r stages its slice of the unmasked rows (ceil(na / 8) of them,
// so the work is even whatever the mask) in shared memory. A thread owns one
// unmasked column, holds its 8 words in registers and walks the slice, the
// rows broadcast from shared memory.
// (3) Argmins as packed 32-bit keys, (distance << 16) | index, with 0xFFFF
// for a masked pair's distance: an unsigned min over keys is argmin's first
// index on ties in any order of reduction, so the result does not depend on
// the schedule. A column's key runs in the thread's register; a row's is
// reduced over each warp (`redux.sync.min`) and then over the warps
// (shared-memory `atomicMin`). Both start at (0xFFFF << 16) | 0, which is
// what an all-masked row or column gives.
// (4) After a cluster barrier, each of the block's rows reads its best
// column's partial minima from the 8 blocks through distributed shared
// memory, so best_ba[best_ab[i]] costs 8 remote loads per row; the good
// rows are added into block 0's counter (integers: any order), and after a
// last cluster barrier block 0 writes the score with the reference's float32
// division.
//
// What was hard: keeping the reference's answers in the cases the tiling
// makes delicate. A masked pair must sort as its 1e9 does (0xFFFF sits above
// every distance of 0..256, and the max_dist test reads 1e9 for it, so a
// max_dist of 1e9 still counts it as the reference does); a block whose
// slice is empty (cap < 8, or na not a multiple of 8) still writes its
// partial column minima and reaches both cluster barriers; partial warps
// take part in the warp reductions with a key above every real one. Indices
// are 16 bits; shared memory (~14.5 bytes a row of cap) stops cap near
// 16000 first, and a larger cap fails the launch, which the wrapper raises.
#include "common.cuh"

#include <cooperative_groups.h>

namespace {

constexpr int kCtas = 8;  // blocks per candidate: one cluster, the portable size
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kMaskedPair = 0xFFFFu;          // the distance code of a masked pair (1e9)
constexpr unsigned kEmpty = kMaskedPair << 16;     // every pair masked: index 0
constexpr unsigned kNoColumn = 0xFFFFFFFFu;        // a lane past the last column
constexpr float kMaskedDistance = 1000000000.0f;   // the reference's 1e9

// dynamic shared memory of one block for `cap`, section by section
struct Layout {
  int slice;  // ceil(cap / kCtas): the most rows a block holds
  size_t rows, row_key, row_idx, col_part, row_list, col_list, col_pos, bytes;
  __host__ __device__ explicit Layout(int cap) : slice((cap + kCtas - 1) / kCtas) {
    rows = 0;                                            // slice x 8 words
    row_key = rows + sizeof(uint32_t) * 8 * slice;       // slice keys
    row_idx = row_key + sizeof(uint32_t) * slice;        // slice row indices
    col_part = row_idx + sizeof(uint32_t) * slice;       // cap column keys, by place in the column list
    row_list = col_part + sizeof(uint32_t) * cap;        // cap unmasked rows in order
    col_list = row_list + sizeof(uint16_t) * cap;        // cap unmasked columns in order
    col_pos = col_list + sizeof(uint16_t) * cap;         // cap places in the column list
    bytes = col_pos + sizeof(uint16_t) * cap;
  }
};

__device__ __forceinline__ unsigned hamming(uint4 x0, uint4 x1, const uint32_t (&b)[8]) {
  return __popc(x0.x ^ b[0]) + __popc(x0.y ^ b[1]) + __popc(x0.z ^ b[2]) + __popc(x0.w ^ b[3]) +
         __popc(x1.x ^ b[4]) + __popc(x1.y ^ b[5]) + __popc(x1.z ^ b[6]) + __popc(x1.w ^ b[7]);
}

// grid (k * kCtas), clusters of kCtas: cluster c scores the query against candidate c
__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kThreads, 1)
match_cluster(const uint32_t* __restrict__ a, const bool* __restrict__ a_mask, const uint32_t* __restrict__ bs,
              const bool* __restrict__ b_masks, int cap, float max_dist, float* __restrict__ out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_a[kWarps], warp_b[kWarps];
  __shared__ int n_good;
  const Layout L(cap);
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem + L.rows);
  uint32_t* row_key = reinterpret_cast<uint32_t*>(smem + L.row_key);
  uint32_t* row_idx = reinterpret_cast<uint32_t*>(smem + L.row_idx);
  uint32_t* col_part = reinterpret_cast<uint32_t*>(smem + L.col_part);
  uint16_t* row_list = reinterpret_cast<uint16_t*>(smem + L.row_list);
  uint16_t* col_list = reinterpret_cast<uint16_t*>(smem + L.col_list);
  uint16_t* col_pos = reinterpret_cast<uint16_t*>(smem + L.col_pos);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x / kCtas;
  const uint32_t* b = bs + static_cast<long long>(c) * cap * 8;
  const bool* bm = b_masks + static_cast<long long>(c) * cap;
  if (tid == 0) n_good = 0;

  // (1) the unmasked rows and columns, in order
  int na = 0, nb = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < cap; base += kThreads) {
    const int idx = base + tid;
    const bool va = idx < cap && a_mask[idx], vb = idx < cap && bm[idx];
    const unsigned ba = __ballot_sync(0xffffffffu, va), bb = __ballot_sync(0xffffffffu, vb);
    if (lane == 0) {
      warp_a[warp] = __popc(ba);
      warp_b[warp] = __popc(bb);
    }
    __syncthreads();
    int oa = na, ob = nb;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) {
        oa += warp_a[w];
        ob += warp_b[w];
      }
      na += warp_a[w];
      nb += warp_b[w];
    }
    if (va) row_list[oa + __popc(ba & below)] = static_cast<uint16_t>(idx);
    if (vb) {
      const int p = ob + __popc(bb & below);
      col_list[p] = static_cast<uint16_t>(idx);
      col_pos[idx] = static_cast<uint16_t>(p);
    }
    __syncthreads();  // the warp counts are read before the next round writes them
  }

  // (2) this block's slice of the unmasked rows
  const int slice = (na + kCtas - 1) / kCtas, first = rank * slice;
  const int cnt = max(0, min(slice, na - first));
  for (int x = tid; x < 8 * cnt; x += kThreads) rows[x] = a[8 * row_list[first + (x >> 3)] + (x & 7)];
  for (int s = tid; s < cnt; s += kThreads) {
    row_idx[s] = row_list[first + s];
    row_key[s] = kEmpty;
  }
  __syncthreads();

  // (3) each distance once: a thread per unmasked column walks the slice
  const uint4* rows4 = reinterpret_cast<const uint4*>(rows);
  for (int base = 0; base < nb; base += kThreads) {
    if (base + 32 * warp >= nb) break;  // warp-uniform: no column left for this warp
    const int cc = base + tid;
    const bool live = cc < nb;
    const unsigned j = live ? col_list[cc] : 0u;
    uint32_t bj[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) bj[t] = live ? b[8 * j + t] : 0u;
    const unsigned dead = live ? 0u : kNoColumn;
    unsigned col_key = kEmpty;
#pragma unroll 4
    for (int s = 0; s < cnt; ++s) {
      const unsigned d = hamming(rows4[2 * s], rows4[2 * s + 1], bj);
      col_key = min(col_key, (d << 16) | row_idx[s]);
      const unsigned best = __reduce_min_sync(0xffffffffu, (d << 16) | j | dead);
      if (lane == 0) atomicMin(&row_key[s], best);
    }
    if (live) col_part[cc] = col_key;
  }
  __syncthreads();
  cluster.sync();  // every block's column minima are written

  // (4) the mutual, distance-gated test of the block's rows
  int good = 0;
  for (int s = tid; s < cnt; s += kThreads) {
    const unsigned key = row_key[s], code = key >> 16, i = row_idx[s];
    unsigned best_ba = 0;  // no unmasked column: best_ab is 0, a masked column whose argmin is 0
    float dist = kMaskedDistance;
    if (code != kMaskedPair) {
      const unsigned p = col_pos[key & 0xFFFFu];
      unsigned m = kNoColumn;
#pragma unroll
      for (int r = 0; r < kCtas; ++r) m = min(m, cluster.map_shared_rank(col_part, r)[p]);
      best_ba = m & 0xFFFFu;
      dist = static_cast<float>(code);
    }
    good += (best_ba == i && dist <= max_dist) ? 1 : 0;
  }
  good = __reduce_add_sync(0xffffffffu, good);
  if (lane == 0 && good) atomicAdd(cluster.map_shared_rank(&n_good, 0), good);
  cluster.sync();  // every count is in, and no block leaves while another reads its memory
  if (rank == 0 && tid == 0) {
    const float denom = fmaxf(fminf(static_cast<float>(na), static_cast<float>(nb)), 1.0f);
    out[c] = static_cast<float>(n_good) / denom;
  }
}

}  // namespace

extern "C" int lvs_orb_match(const uint8_t* a, const bool* a_mask, const uint8_t* bs, const bool* b_masks, int cap,
                             int k, float max_dist, float* out, cudaStream_t stream) {
  if (k > 0 && cap > 0) {
    const size_t bytes = Layout(cap).bytes;
    if (bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(match_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(bytes));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    match_cluster<<<k * kCtas, kThreads, bytes, stream>>>(reinterpret_cast<const uint32_t*>(a), a_mask,
                                                          reinterpret_cast<const uint32_t*>(bs), b_masks, cap,
                                                          max_dist, out);
  }
  LVS_RETURN_LAST_ERROR();
}
