// Kernel 12b: masked mutual-best descriptor matching of one keyframe
// against a batch of loop candidates.
//
// Replaces: lv_slam_tpu/ops/orb.py:274 `match_scores_batch` (its device
// program :254 `_match_scores_masked`, over :225 `hamming_matrix`).
//
// What bounds it on the card: 8 candidates of 512 x 32-byte descriptors are
// 130 KB; the 8 x 512 x 512 distances are ~25 integer operations each, 50 M
// operations, under a microsecond at the card's rate. One block per
// candidate leaves most SMs idle and each thread walks 512 rows twice:
// latency and the per-block instruction rate bound it.
//
// Design: one 512-thread block per candidate. The query's and the
// candidate's descriptors (as 8 words each) and masks go to shared memory.
// A distance is `__popc(a ^ b)` summed over 8 words, 1e9 where either side
// is masked (the reference's `where(valid, d, 1e9)`). One thread per
// candidate row finds the column argmin, one thread per query row the row
// argmin, both keeping the first index on ties as `argmin` does; a query
// row counts when it is unmasked, its best candidate's best query is itself
// and the distance is within `max_dist`. A block reduction gives n_good, and
// the score n_good / max(min(na, nb), 1) is the reference's float32
// division, so the kernel and the plain twin agree to the bit.
#include "common.cuh"

namespace {

constexpr int kBlock = 512;
constexpr int kMasked = 1000000000;  // the reference's 1e9 for masked pairs

__device__ __forceinline__ int hamming(const uint32_t* a, const uint32_t* b) {
  int d = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) d += __popc(a[t] ^ b[t]);
  return d;
}

__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int total = 0;
  for (int i = 0; i < kBlock / 32; ++i) total += red[i];
  return total;
}

// grid (k): block c scores the query against candidate c
__global__ void __launch_bounds__(kBlock)
orb_match(const uint32_t* __restrict__ a, const bool* __restrict__ a_mask, const uint32_t* __restrict__ bs,
          const bool* __restrict__ b_masks, int cap, float max_dist, float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* sa = smem;                                  // cap x 8
  uint32_t* sb = sa + 8 * cap;                          // cap x 8
  int* best_ba = reinterpret_cast<int*>(sb + 8 * cap);  // cap
  int* red = best_ba + cap;                             // kBlock / 32
  uint8_t* ma = reinterpret_cast<uint8_t*>(red + kBlock / 32);  // cap
  uint8_t* mb = ma + cap;                                        // cap
  int c = blockIdx.x;
  const uint32_t* b = bs + static_cast<long long>(c) * cap * 8;
  const bool* bm = b_masks + static_cast<long long>(c) * cap;
  for (int t = threadIdx.x; t < 8 * cap; t += kBlock) {
    sa[t] = a[t];
    sb[t] = b[t];
  }
  int na = 0, nb = 0;
  for (int t = threadIdx.x; t < cap; t += kBlock) {
    ma[t] = a_mask[t] ? 1 : 0;
    mb[t] = bm[t] ? 1 : 0;
    na += ma[t];
    nb += mb[t];
  }
  __syncthreads();

  // column argmin: the best query row of each candidate row
  for (int j = threadIdx.x; j < cap; j += kBlock) {
    uint32_t bj[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) bj[t] = sb[8 * j + t];
    int best = 0, best_d = 0x7fffffff;
    for (int i = 0; i < cap; ++i) {
      int d = (ma[i] && mb[j]) ? hamming(sa + 8 * i, bj) : kMasked;
      if (d < best_d) {
        best_d = d;
        best = i;
      }
    }
    best_ba[j] = best;
  }
  __syncthreads();

  // row argmin and the mutual, distance-gated test
  int good = 0;
  for (int i = threadIdx.x; i < cap; i += kBlock) {
    uint32_t ai[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) ai[t] = sa[8 * i + t];
    int best = 0, best_d = 0x7fffffff;
    for (int j = 0; j < cap; ++j) {
      int d = (ma[i] && mb[j]) ? hamming(ai, sb + 8 * j) : kMasked;
      if (d < best_d) {
        best_d = d;
        best = j;
      }
    }
    if (ma[i] && best_ba[best] == i && static_cast<float>(best_d) <= max_dist) ++good;
  }
  int n_good = block_sum(good, red);
  int total_a = block_sum(na, red);
  int total_b = block_sum(nb, red);
  if (threadIdx.x == 0) {
    float denom = fmaxf(fminf(static_cast<float>(total_a), static_cast<float>(total_b)), 1.0f);
    out[c] = static_cast<float>(n_good) / denom;
  }
}

}  // namespace

extern "C" int lvs_orb_match(const uint8_t* a, const bool* a_mask, const uint8_t* bs, const bool* b_masks, int cap,
                             int k, float max_dist, float* out, cudaStream_t stream) {
  if (k > 0 && cap > 0) {
    size_t smem = 2 * 8 * sizeof(uint32_t) * cap + sizeof(int) * (cap + kBlock / 32) + 2 * cap;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(orb_match, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    orb_match<<<k, kBlock, smem, stream>>>(reinterpret_cast<const uint32_t*>(a), a_mask,
                                           reinterpret_cast<const uint32_t*>(bs), b_masks, cap, max_dist, out);
  }
  LVS_RETURN_LAST_ERROR();
}
