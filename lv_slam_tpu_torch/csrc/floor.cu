// Kernel 16: RANSAC floor detection.
//
// Replaces: lv_slam_tpu/ops/floor.py:27 `detect_floor` (the hypotheses from
// the reference's random triples, the (N, H) inlier test and its counts,
// the argmax, the weighted mean and covariance of the best hypothesis's
// inliers, lv_slam_tpu/ops/linalg3.py:25 `eigh3x3` on it, and the gates).
//
// What bounds it on the card: operations. Each band point (35977 of a
// prefiltered scan's 131072 lanes) is tested against H = 256 planes, about
// 7 flops each: 64 MFLOP, ~1 us at the float32 peak; the points (1.5 MB)
// are read twice. What held the earlier three launches back was latency:
// one block made the hypotheses, one thread scanned the counts in global
// memory, and one block of 1024 threads read every lane twice from one SM.
//
// Design, two launches:
// 1. `floor_count`, 128 blocks of 1024 threads (fewer for a small cloud).
//    Every block first forms all H hypotheses in shared memory, a thread
//    each: it gathers its triple (drawn on the host, see ops/floor.py), forms
//    the normal as the reference's compiled `jnp.cross` rounds it (fma(u1,
//    w2, -(u2 w1)), ...), its length, the +z orientation, the triple and
//    normal gates and the offset d = -(n . p0) (an fma chain); block 0
//    writes them out (planes, and counts 0 or -1 for a failed one). The
//    lanes go to the blocks in 32-lane chunks dealt round robin, a warp a
//    chunk, so every block holds its share of the band wherever the cloud's
//    valid lanes sit (a prefiltered scan fills its first third). A warp
//    marks its chunk's z band (mask and |z + height| < clip; one ballot
//    word written out for the finish) and appends the band points to shared
//    memory; then thread (part, slot) tests hypotheses slot, slot + 256, ...
//    against every fourth staged point, |fma(z, n2, fma(y, n1, x n0)) + d| <
//    thresh (a warp's threads read the same point: a broadcast), counting in
//    registers, and the block writes its counts to its column of partial
//    counts (a row a hypothesis). No atomic on a count: integer counts in any order are the same
//    counts.
// 2. `floor_finish`, one cluster of 16 blocks of 256 threads. Threads 0-63
//    of block b are the earlier finish's threads 64 b .. 64 b + 63, spread
//    over 16 SMs: chain g adds lanes g, g + 1024, ... in order. First every
//    thread of a block loads: a quarter of hypothesis 64 b + t % 64's partial
//    counts (8 int4 loads), then the block's lanes (12
//    bytes a lane, 64 lanes a round of 1024, float4 loads) and their band
//    words into shared memory, all loads of a thread in flight together.
//    The chain threads total hypothesis g's count (-1 for a failed one);
//    the cluster's argmax, the first index on ties, is read over
//    distributed shared memory. The block marks its lanes that are
//    best-plane inliers in the band (the same test; a ballot word per 32
//    lanes), then each chain sums its band count and its inliers' positions
//    from shared memory, the earlier loop's adds and skips as selects
//    without its branches, 16 rounds' loads issued before their adds, its
//    positions on one thread and its counts on another; the
//    1024 chain values go to block 0, whose 256 threads add them in the
//    earlier `block_sum`'s fixed tree (pairs (i, i + half), half = 512 ..
//    1; a wide level's operands loaded before its sums are stored, the last
//    six levels in a warp a sum, by shuffles); block 0's
//    means go back to every block, the chains sum their centred second
//    moments (three on each of two threads), block 0 adds them in the same
//    tree, and one thread runs the
//    eigh3x3 device function of kernel 4 on the covariance and applies the
//    reference's gates. So the coefficients are bit for bit the earlier
//    kernel's (`scripts/knn_floor_parent.py` checks it on the card), and no
//    float is added by an atomic.
#include "common.cuh"
#include "linalg3.cuh"

#include <cooperative_groups.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kCountBlocks = 128;  // the count's blocks, at most: 32-lane chunks dealt round robin
constexpr int kCountThreads = 1024;
constexpr int kWarpsCount = kCountThreads / 32;  // a warp takes a chunk
constexpr int kHypSlots = 256;     // hypotheses a quarter of the count block tests at a time
constexpr int kParts = kCountThreads / kHypSlots;  // ways each hypothesis's points are split
constexpr int kMaxHyp = 1024;      // hypotheses ops/floor.py admits
constexpr int kChains = 1024;      // the finish's chains: the earlier finish block's threads
constexpr int kCluster = 16;       // the finish's blocks
constexpr int kChainThreads = kChains / kCluster;
constexpr int kRounds = 128;       // rounds of 1024 lanes a finish block stages at a time (131072 lanes)
constexpr int kFinishThreads = 256;  // a finish block: its chains' 64 threads stage, count and add with 192 more
constexpr int kSums = 6;           // values a chain hands to block 0: 5 sums, then 6 moments

__device__ __forceinline__ bool in_band(const float* xyz, const bool* mask, int i, float height, float clip) {
  return mask[i] && fabsf(xyz[3 * i + 2] + height) < clip;
}

__device__ __forceinline__ bool inlier(float x, float y, float z, float4 pl, float thresh) {
  float dot = fmaf(z, pl.z, fmaf(y, pl.y, x * pl.x));
  return fabsf(dot + pl.w) < thresh;
}

// Hypothesis h: its plane (unit normal, offset) and whether it passes the gates.
__device__ __forceinline__ bool hypothesis(const float* __restrict__ xyz, const bool* __restrict__ mask,
                                           const int* __restrict__ idx, int h, float height, float clip,
                                           float cos_thresh, float4* plane) {
  int a = idx[3 * h + 0], b = idx[3 * h + 1], c = idx[3 * h + 2];
  bool tri_ok = in_band(xyz, mask, a, height, clip) && in_band(xyz, mask, b, height, clip) &&
                in_band(xyz, mask, c, height, clip);
  // masked lanes read as the sentinel, as the reference's masked_xyz
  float p0[3], u[3], w[3];
  for (int k = 0; k < 3; ++k) {
    p0[k] = mask[a] ? xyz[3 * a + k] : lvs::kSentinel;
    float p1 = mask[b] ? xyz[3 * b + k] : lvs::kSentinel;
    float p2 = mask[c] ? xyz[3 * c + k] : lvs::kSentinel;
    u[k] = p1 - p0[k];
    w[k] = p2 - p0[k];
  }
  float nv[3] = {fmaf(u[1], w[2], -(u[2] * w[1])), fmaf(u[2], w[0], -(u[0] * w[2])),
                 fmaf(u[0], w[1], -(u[1] * w[0]))};
  float nn = sqrtf(fmaf(nv[2], nv[2], fmaf(nv[1], nv[1], nv[0] * nv[0])));
  float den = fmaxf(nn, 1e-9f);
  float unit[3] = {nv[0] / den, nv[1] / den, nv[2] / den};
  if (unit[2] < 0.0f)
    for (int k = 0; k < 3; ++k) unit[k] = -unit[k];
  float d = -fmaf(unit[2], p0[2], fmaf(unit[1], p0[1], unit[0] * p0[0]));
  *plane = make_float4(unit[0], unit[1], unit[2], d);
  return tri_ok && nn > 1e-6f && unit[2] > cos_thresh;
}

__global__ void __launch_bounds__(kCountThreads)
floor_count(const float* __restrict__ xyz, const bool* __restrict__ mask, int n, const int* __restrict__ idx,
            int n_hyp, float height, float clip, float thresh, float cos_thresh, float* __restrict__ planes,
            int* __restrict__ counts, int* __restrict__ partials, unsigned* __restrict__ band_words) {
  __shared__ float4 s_planes[kMaxHyp];
  __shared__ bool s_ok[kMaxHyp];
  __shared__ float4 s_pts[kCountThreads];  // a batch's band points; at the end the parts' counts
  __shared__ int s_n;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // thread (part, slot) counts hypotheses slot, slot + 256, ... over every kParts-th point
  const int slot = tid % kHypSlots, part = tid / kHypSlots;
  int c[kMaxHyp / kHypSlots] = {};
  const int n_chunks = (n + 31) >> 5;
  const int stride = static_cast<int>(gridDim.x);
  bool first = true;
  for (int batch = static_cast<int>(blockIdx.x); batch < n_chunks; batch += stride * kWarpsCount) {
    const int chunk = batch + warp * stride;  // chunks are dealt round robin: every block gets its share of the band
    const int i = chunk * 32 + lane;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    bool band = false;
    if (i < n) {
      x = xyz[3 * i + 0];
      y = xyz[3 * i + 1];
      z = xyz[3 * i + 2];
      band = mask[i] && fabsf(z + height) < clip;
    }
    if (first) {  // the hypotheses, while the chunk's loads are in flight
      for (int h = tid; h < n_hyp; h += kCountThreads) {
        float4 pl;
        const bool ok = hypothesis(xyz, mask, idx, h, height, clip, cos_thresh, &pl);
        s_planes[h] = pl;
        s_ok[h] = ok;
        if (blockIdx.x == 0) {
          reinterpret_cast<float4*>(planes)[h] = pl;
          counts[h] = ok ? 0 : -1;  // -1 marks a failed hypothesis
        }
      }
      first = false;
    }
    __syncthreads();  // the hypotheses are in place; the last batch's points are counted
    if (tid == 0) s_n = 0;
    __syncthreads();
    const unsigned ballot = __ballot_sync(0xffffffffu, band);
    if (lane == 0 && chunk < n_chunks) band_words[chunk] = ballot;
    int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&s_n, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (band) s_pts[base + __popc(ballot & ((1u << lane) - 1u))] = make_float4(x, y, z, 0.0f);
    __syncthreads();
    const int m = s_n;
#pragma unroll
    for (int j = 0; j < kMaxHyp / kHypSlots; ++j) {
      const int h = slot + j * kHypSlots;
      if (h >= n_hyp || !s_ok[h]) continue;
      const float4 pl = s_planes[h];
#pragma unroll 4
      for (int p = part; p < m; p += kParts) {
        const float4 pt = s_pts[p];
        c[j] += inlier(pt.x, pt.y, pt.z, pl, thresh);
      }
    }
  }
  __syncthreads();
  int* s_part = reinterpret_cast<int*>(s_pts);  // [kParts][kMaxHyp]
#pragma unroll
  for (int j = 0; j < kMaxHyp / kHypSlots; ++j) {
    const int h = slot + j * kHypSlots;
    if (h < n_hyp) s_part[part * kMaxHyp + h] = c[j];
  }
  __syncthreads();
  for (int h = tid; h < n_hyp; h += kCountThreads) {
    int total = 0;
    for (int q = 0; q < kParts; ++q) total += s_part[q * kMaxHyp + h];
    partials[static_cast<long long>(h) * kCountBlocks + blockIdx.x] = total;
  }
}

struct FinishShared {
  float red[kSums][kChains];    // block 0: the chains' values, added in the tree
  int parts[kFinishThreads];    // a block's partial counts, kFinishThreads / kChainThreads parts a hypothesis
  float total[kSums];           // block 0: the trees' sums (x y z w b, then the moments over the count)
  float mu[3];                  // block 0: the inliers' mean
  int best_count, best;         // this block's argmax, then the cluster's
  int warp_count[kChainThreads / 32], warp_best[kChainThreads / 32];
};

// Every thread of the block: the block's lanes of rounds r0 .. r0 + rounds - 1
// (lanes r * 1024 + 64 * rank + [0, 64)) into shared memory, their positions
// (192 floats a round; float4 loads where the round is whole and aligned)
// and their band words (2 a round; 0 past the cloud).
__device__ __forceinline__ void stage_rounds(const float* __restrict__ xyz, const unsigned* __restrict__ band_words,
                                             int n, int rank, int r0, int rounds, bool xyz16, float* s_xyz,
                                             unsigned* s_band) {
  const int tid = threadIdx.x;
  constexpr int kVec = 3 * kChainThreads / 4;  // float4s a round
  const long long base = static_cast<long long>(r0) * kChains + kChainThreads * rank;  // round r0's first lane
  const long long fit = static_cast<long long>(n) - kChainThreads - base;  // whole rounds: base + 1024 j <= fit
  const int whole = !xyz16 || fit < 0 ? 0 : static_cast<int>(min(static_cast<long long>(rounds), fit / kChains + 1));
#pragma unroll 24
  for (int it = tid; it < whole * kVec; it += kFinishThreads) {
    const int j = it / kVec, c = it - j * kVec;
    const float4* src = reinterpret_cast<const float4*>(xyz + 3 * (base + static_cast<long long>(j) * kChains));
    reinterpret_cast<float4*>(s_xyz + 3 * kChainThreads * j)[c] = __ldg(src + c);
  }
  for (int it = whole * 3 * kChainThreads + tid; it < rounds * 3 * kChainThreads; it += kFinishThreads) {
    const int j = it / (3 * kChainThreads), w = it - j * 3 * kChainThreads;
    const long long word = 3 * (base + static_cast<long long>(j) * kChains) + w;
    if (word < 3 * static_cast<long long>(n)) s_xyz[it] = __ldg(xyz + word);
  }
  const long long n_words = (static_cast<long long>(n) + 31) >> 5;
  for (int it = tid; it < 2 * rounds; it += kFinishThreads) {
    const long long word = ((base + static_cast<long long>(it >> 1) * kChains) >> 5) + (it & 1);
    s_band[it] = word < n_words ? __ldg(band_words + word) : 0u;
  }
}

// The rounds r0 .. r0 + rounds - 1 in which chain g has a lane below n: the first `end` of them.
__device__ __forceinline__ int chain_rounds(int n, int r0, int rounds, int g) {
  const long long rest = static_cast<long long>(n) - (static_cast<long long>(r0) * kChains + g);
  const long long need = (rest + kChains - 1) / kChains;
  return rest <= 0 ? 0 : static_cast<int>(need < rounds ? need : rounds);
}

// Every thread of the block: for each staged round, the words of its 64
// lanes that are best-plane inliers in the band (a ballot a warp).
__device__ __forceinline__ void mark_inliers(const float* s_xyz, const unsigned* s_band, unsigned* s_in, int rounds,
                                             float4 pl, float thresh) {
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < 2 * rounds; w += kFinishThreads / 32) {  // word w: round w / 2, its half w % 2
    const float* p = s_xyz + 3 * (32 * w + lane);
    const bool in = ((s_band[w] >> lane) & 1u) && inlier(p[0], p[1], p[2], pl, thresh);
    const unsigned ballot = __ballot_sync(0xffffffffu, in);
    if (lane == 0) s_in[w] = ballot;
  }
}

// Chain t = threadIdx.x % 64's staged lanes of rounds 0 .. end - 1 in order:
// add(x, y, z, in the band, a best-plane inlier in the band) for each. A
// batch's loads from shared memory are issued before its adds, which alone
// depend on one another.
template <class Add>
__device__ __forceinline__ void chain_pass(const float* s_xyz, const unsigned* s_band, const unsigned* s_in, int end,
                                           Add add) {
  constexpr int kBatch = 16;
  const int t = threadIdx.x % kChainThreads;
  for (int j0 = 0; j0 < end; j0 += kBatch) {
    float x[kBatch], y[kBatch], z[kBatch];
    bool band[kBatch], in[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = min(j0 + u, end - 1);  // a round past the end reloads the last one; it is not added
      const float* p = s_xyz + 3 * (kChainThreads * j + t);
      band[u] = (s_band[2 * j + (t >> 5)] >> (t & 31)) & 1u;
      in[u] = (s_in[2 * j + (t >> 5)] >> (t & 31)) & 1u;
      x[u] = p[0];
      y[u] = p[1];
      z[u] = p[2];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool live = j0 + u < end;
      add(x[u], y[u], z[u], live && band[u], live && in[u]);
    }
  }
}

// The block's threads add v[k][0 .. 1024), k < n_sums <= 8, in place in the
// earlier finish's tree (v[i] + v[i + half], half = 512 .. 1); returns the
// sum v[k][0] to thread 32 k. Levels 512 .. 64 run over the block (a level's
// operands loaded before its sums are stored), 32 .. 1 in warp k, its lane
// i holding v[k][i] (the same pairs, by shuffles).
__device__ __forceinline__ float tree_sums(float (*v)[kChains], int n_sums) {
  constexpr int kAdds = kSums * kChains / 2 / kFinishThreads;  // a thread's adds at the widest level
  __syncthreads();
  for (int shift = 9; shift >= 6; --shift) {
    const int half = 1 << shift, total = half * n_sums;
    float a[kAdds], b[kAdds];
#pragma unroll
    for (int u = 0; u < kAdds; ++u) {
      const int e = threadIdx.x + u * kFinishThreads, k = e >> shift, i = e & (half - 1);
      if (e < total) {
        a[u] = v[k][i];
        b[u] = v[k][i + half];
      }
    }
#pragma unroll
    for (int u = 0; u < kAdds; ++u) {
      const int e = threadIdx.x + u * kFinishThreads, k = e >> shift, i = e & (half - 1);
      if (e < total) v[k][i] = a[u] + b[u];
    }
    __syncthreads();
  }
  const int k = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float x = 0.0f;
  if (k < n_sums) {
    x = v[k][lane] + v[k][lane + 32];
#pragma unroll
    for (int half = 16; half > 0; half >>= 1) x += __shfl_down_sync(0xffffffffu, x, half);
  }
  return x;
}

__global__ void __launch_bounds__(kFinishThreads)
floor_finish(const float* __restrict__ xyz, int n, const unsigned* __restrict__ band_words,
             const float* __restrict__ planes, int* __restrict__ counts, const int* __restrict__ partials,
             int n_rows, int n_hyp, float thresh, float cos_thresh, float min_fraction, float* __restrict__ coeffs,
             int* __restrict__ stats, bool* __restrict__ found) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const bool chain = tid < kChainThreads;  // the threads that total a hypothesis each
  extern __shared__ __align__(16) unsigned char dyn[];
  float* s_xyz = reinterpret_cast<float*>(dyn);                                           // kRounds * 192
  unsigned* s_band = reinterpret_cast<unsigned*>(s_xyz + kRounds * 3 * kChainThreads);  // kRounds * 2
  unsigned* s_in = s_band + 2 * kRounds;                                                 // kRounds * 2
  __shared__ FinishShared sh;

  const int n_rounds = (n + kChains - 1) / kChains;
  const bool xyz16 = (reinterpret_cast<uintptr_t>(xyz) & 15) == 0;
  const bool one_stage = n_rounds <= kRounds;

  // hypothesis h = 64 * rank + tid % 64's count, its partial rows split four
  // ways: loaded before the lanes are staged, added after
  constexpr int kRowParts = kFinishThreads / kChainThreads;
  const int h = rank * kChainThreads + tid % kChainThreads;
  constexpr int kPerPart = kCountBlocks / kRowParts;  // a thread's rows: 8 int4 loads
  const int first_row = tid / kChainThreads * kPerPart;
  const int4* row4 = reinterpret_cast<const int4*>(partials + static_cast<long long>(h) * kCountBlocks + first_row);
  int4 rows[kPerPart / 4];
#pragma unroll
  for (int u = 0; u < kPerPart / 4; ++u)
    rows[u] = h < n_hyp && first_row + 4 * u < n_rows ? __ldg(row4 + u) : make_int4(0, 0, 0, 0);
  if (one_stage) stage_rounds(xyz, band_words, n, rank, 0, n_rounds, xyz16, s_xyz, s_band);
  int part = 0;
#pragma unroll
  for (int u = 0; u < kPerPart / 4; ++u) {  // rows past the count's blocks were never written
    const int r = first_row + 4 * u;
    part += (r < n_rows ? rows[u].x : 0) + (r + 1 < n_rows ? rows[u].y : 0) + (r + 2 < n_rows ? rows[u].z : 0) +
            (r + 3 < n_rows ? rows[u].w : 0);
  }
  sh.parts[tid] = part;
  __syncthreads();
  int value = -2147483647 - 1, at = h;  // below every hypothesis's count
  if (chain) {
    if (h < n_hyp) {
      int count = 0;
      for (int q = 0; q < kRowParts; ++q) count += sh.parts[q * kChainThreads + tid];
      value = counts[h] < 0 ? -1 : count;
      counts[h] = value;
    }
    // the argmax, the first index on ties: the warp, the block, then the cluster
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int v = __shfl_down_sync(0xffffffffu, value, off), a = __shfl_down_sync(0xffffffffu, at, off);
      if (v > value || (v == value && a < at)) {
        value = v;
        at = a;
      }
    }
    if ((tid & 31) == 0) {
      sh.warp_count[tid >> 5] = value;
      sh.warp_best[tid >> 5] = at;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int best_count = sh.warp_count[0], best = sh.warp_best[0];
    for (int w = 1; w < kChainThreads / 32; ++w)
      if (sh.warp_count[w] > best_count) {
        best_count = sh.warp_count[w];
        best = sh.warp_best[w];
      }
    sh.best_count = best_count;
    sh.best = best;
  }
  cluster.sync();  // every block's argmax is written
  if (tid < 32) {  // lane b reads block b's; blocks hold ascending hypotheses, so the first index wins ties
    int value = -2147483647 - 1, at = 0;
    if (tid < kCluster) {
      const FinishShared* o = cluster.map_shared_rank(&sh, tid);
      value = o->best_count;
      at = o->best;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int v = __shfl_down_sync(0xffffffffu, value, off), a = __shfl_down_sync(0xffffffffu, at, off);
      if (v > value || (v == value && a < at)) {
        value = v;
        at = a;
      }
    }
    if (tid == 0) {
      sh.warp_count[0] = value;
      sh.warp_best[0] = at;
    }
  }
  __syncthreads();
  const int best = sh.warp_best[0], best_count = sh.warp_count[0];
  const float4 pl = reinterpret_cast<const float4*>(planes)[best];

  if (one_stage) {
    mark_inliers(s_xyz, s_band, s_in, n_rounds, pl, thresh);
    __syncthreads();
  }

  // pass 1: the chain's band count and its inliers' positions, in lane
  // order; threads 0-63 add x, y, z, threads 64-127 count (the sums apart
  // keep their orders)
  const int q = tid / kChainThreads, c = rank * kChainThreads + tid % kChainThreads;  // c: the chain
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int r0 = 0; r0 < n_rounds; r0 += kRounds) {
    const int rounds = min(kRounds, n_rounds - r0);
    if (!one_stage) {
      __syncthreads();
      stage_rounds(xyz, band_words, n, rank, r0, rounds, xyz16, s_xyz, s_band);
      __syncthreads();
      mark_inliers(s_xyz, s_band, s_in, rounds, pl, thresh);
      __syncthreads();
    }
    // the adds and skips of the earlier loop, without its branches
    if (q == 0)
      chain_pass(s_xyz, s_band, s_in, chain_rounds(n, r0, rounds, c), [&](float x, float y, float z, bool, bool in) {
        acc[0] = in ? acc[0] + x : acc[0];
        acc[1] = in ? acc[1] + y : acc[1];
        acc[2] = in ? acc[2] + z : acc[2];
      });
    else if (q == 1)
      chain_pass(s_xyz, s_band, s_in, chain_rounds(n, r0, rounds, c), [&](float, float, float, bool band, bool in) {
        acc[0] = in ? acc[0] + 1.0f : acc[0];
        acc[1] = band ? acc[1] + 1.0f : acc[1];
      });
  }
  FinishShared* zero = cluster.map_shared_rank(&sh, 0);
  if (q < 2)
    for (int k = 0; k < 3 - q; ++k) zero->red[3 * q + k][c] = acc[k];  // x y z, then w b
  cluster.sync();  // the chains' sums are in block 0
  if (rank == 0) {
    const float total = tree_sums(sh.red, 5);
    if ((tid & 31) == 0 && tid < 32 * 5) sh.total[tid >> 5] = total;
    __syncthreads();
    if (tid < 3) sh.mu[tid] = sh.total[tid] / fmaxf(sh.total[3], 1.0f);
  }
  cluster.sync();  // block 0's means are written, its sums read: the moments may overwrite them
  if (rank != 0 && tid < 3) sh.mu[tid] = zero->mu[tid];  // three remote reads a block
  __syncthreads();
  const float mu[3] = {sh.mu[0], sh.mu[1], sh.mu[2]};

  // pass 2: the chain's centred second moments; threads 0-63 xx, xy, xz,
  // threads 64-127 yy, yz, zz
  acc[0] = acc[1] = acc[2] = 0.0f;
  for (int r0 = 0; r0 < n_rounds; r0 += kRounds) {
    const int rounds = min(kRounds, n_rounds - r0);
    if (!one_stage) {
      __syncthreads();
      stage_rounds(xyz, band_words, n, rank, r0, rounds, xyz16, s_xyz, s_band);
      __syncthreads();
      mark_inliers(s_xyz, s_band, s_in, rounds, pl, thresh);
      __syncthreads();
    }
    if (q == 0)
      chain_pass(s_xyz, s_band, s_in, chain_rounds(n, r0, rounds, c), [&](float x, float y, float z, bool, bool in) {
        const float cx = x - mu[0], cy = y - mu[1], cz = z - mu[2];
        acc[0] = in ? acc[0] + cx * cx : acc[0];
        acc[1] = in ? acc[1] + cx * cy : acc[1];
        acc[2] = in ? acc[2] + cx * cz : acc[2];
      });
    else if (q == 1)
      chain_pass(s_xyz, s_band, s_in, chain_rounds(n, r0, rounds, c), [&](float, float y, float z, bool, bool in) {
        const float cy = y - mu[1], cz = z - mu[2];
        acc[0] = in ? acc[0] + cy * cy : acc[0];
        acc[1] = in ? acc[1] + cy * cz : acc[1];
        acc[2] = in ? acc[2] + cz * cz : acc[2];
      });
  }
  if (q < 2)
    for (int k = 0; k < 3; ++k) zero->red[3 * q + k][c] = acc[k];  // xx xy xz, then yy yz zz
  cluster.sync();  // the chains' moments are in block 0; no block reads another's memory after this
  if (rank != 0) return;
  const float wsum = sh.total[3], bsum = sh.total[4], cnt = fmaxf(wsum, 1.0f);
  const float moment = tree_sums(sh.red, 6);
  __syncthreads();  // every thread has read the totals of pass 1
  if ((tid & 31) == 0 && tid < 32 * 6) sh.total[tid >> 5] = moment / cnt;
  __syncthreads();
  if (tid != 0) return;
  float cov[6];
  for (int k = 0; k < 6; ++k) cov[k] = sh.total[k];
  float ev[3];
  lvs::Vec3 evec[3];
  lvs::eigh3x3(cov[0], cov[1], cov[2], cov[3], cov[4], cov[5], ev, evec);
  float nx = evec[0].x, ny = evec[0].y, nz = evec[0].z;
  if (nz < 0.0f) {
    nx = -nx; ny = -ny; nz = -nz;
  }
  coeffs[0] = nx;
  coeffs[1] = ny;
  coeffs[2] = nz;
  coeffs[3] = -fmaf(nz, mu[2], fmaf(ny, mu[1], nx * mu[0]));
  stats[0] = best_count;
  stats[1] = best;
  *found = best_count > 0 && wsum >= min_fraction * fmaxf(bsum, 1.0f) && nz > cos_thresh;
}

constexpr size_t kFinishSmem = sizeof(float) * kRounds * 3 * kChainThreads + sizeof(unsigned) * 4 * kRounds;

}  // namespace

// Scratch of `lvs_floor` for n lanes and n_hyp hypotheses: each
// hypothesis's counts from the (at most kCountBlocks) count blocks, then the
// band words.
extern "C" long long lvs_floor_scratch_bytes(int n, int n_hyp) {
  return 4 * (static_cast<long long>(n_hyp) * kCountBlocks + (static_cast<long long>(n) + 31) / 32);
}

extern "C" int lvs_floor(const float* xyz, const bool* mask, int n, const int* idx, int n_hyp, float height,
                         float clip, float thresh, float cos_thresh, float min_fraction, float* planes, int* counts,
                         void* scratch, float* coeffs, int* stats, bool* found, cudaStream_t stream) {
  if (n < 1 || n_hyp < 1 || n_hyp > kMaxHyp || (reinterpret_cast<uintptr_t>(planes) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (n + 31) / 32, blocks = chunks < kCountBlocks ? chunks : kCountBlocks;
  int* partials = static_cast<int*>(scratch);
  unsigned* band_words = reinterpret_cast<unsigned*>(partials + static_cast<long long>(n_hyp) * kCountBlocks);
  floor_count<<<blocks, kCountThreads, 0, stream>>>(xyz, mask, n, idx, n_hyp, height, clip, thresh, cos_thresh,
                                                      planes, counts, partials, band_words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static_assert(kFinishSmem + sizeof(FinishShared) <= 227 * 1024, "the finish block's shared memory");
  err = cudaFuncSetAttribute(floor_finish, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kFinishSmem));
  if (err == cudaSuccess) err = cudaFuncSetAttribute(floor_finish, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute cluster = {};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster);
  config.blockDim = dim3(kFinishThreads);
  config.dynamicSmemBytes = kFinishSmem;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, floor_finish, xyz, n, static_cast<const unsigned*>(band_words),
                           static_cast<const float*>(planes), counts, static_cast<const int*>(partials), blocks, n_hyp,
                           thresh, cos_thresh, min_fraction, coeffs, stats, found);
  return static_cast<int>(err);
}
