// Kernels 3 and 4: the bucket-pair hash table of an NDT voxel map and the NDT
// derivative pass over it.
//
// Kernel 3 replaces lv_slam_tpu/ops/ndt_hash.py:53 `to_hash`.
//   Bound on the card: once per keyframe it reads leaf_cap leaves (56 bytes
//   each) and writes B = 4 * leaf_cap buckets of 128 bytes (16 MB of table at
//   leaf_cap 32768): pure memory traffic, 5 microseconds of HBM time.
//   Design, four launches in one C call: `hash_init` sets the int2 bucket
//   heads (slot 0, slot 1) to the sentinel; `hash_slot0` computes each
//   leaf's key once into a scratch word, takes slot 0 by atomicMin (the
//   lowest leaf index) and adds the block's valid leaves to n_dropped;
//   `hash_slot1` takes slot 1 (the lowest of the rest) from the stored keys;
//   `hash_rows` writes the table with 8 lanes a bucket, lane j the j-th
//   float4 of the 32-float row, so a warp stores four whole contiguous rows
//   in one instruction and every float is stored once, and subtracts the
//   block's filled slots from n_dropped (dropped = valid - filled; integer
//   atomics, so the count does not depend on the order). atomicMin of
//   indices is order-independent, so the table is deterministic and
//   bit-exact with the plain version. Keys are moved as int32 bits, never
//   through float math.
//
// Kernel 4 replaces lv_slam_tpu/ops/ndt_hash.py:132 `ndt_derivatives_hash`
// with lv_slam_tpu/ops/ndt_soa.py:59 `accumulate_ndt_terms` as its body.
//   Bound on the card: per call it reads N points (12 B each, N = 65536 or
//   32768 on the coarse phase) and the table's sectors that its probes need,
//   each once (a probe's slot-0 key sector, slot 1's where slot 0 misses,
//   and the hit slot's tail sector; at most the 16 MB table, which stays in
//   the 50 MB L2 across the Newton iterations); about 330 flops per hit.
//   What it fetches from L2, repeats included: the earlier kernel loaded
//   both slots' first 48 bytes, four 32-byte sectors a probe, hit or miss;
//   this one both key sectors a probe and a tail sector a hit.
//   `chip_smoke.probe_sectors` counts all three.
//   Design: one thread per point (the point -> thread map, the offset order
//   and the reduction's order are the earlier kernel's, so the partial rows
//   are its bits; `scripts/newton_parent.py` holds them to it). For each
//   group of up to 7 offsets (DIRECT7 is one group) a thread first computes
//   every probe's key and bucket and issues both slots' key words at once
//   (sectors 0 and 2 of the row), then takes the hits in offset order: the
//   matching slot's head, covariance (its key's sector) and tail (one more
//   sector), and the 43 terms (score, gradient 6, Hessian 36: the T2 block
//   is not symmetric, so no triangle is mirrored) kept in registers. Lanes
//   that miss or fail the gate are skipped, never multiplied by 0 (a
//   sentinel lane's terms can be inf). Each block then sums its rows into
//   one partial row by `lvs::block_partials` (ndt_terms.cuh: the warp's 43
//   values halved over the lane pairs of a shuffle-down tree, 48 shuffles a
//   warp, the tree's bits); `ndt_finish` sums the partial rows in block
//   order, so the result does not change from run to run.
//   What bounds it: at K13's 8 x 131072 lanes the 215 shuffles a warp of the
//   earlier shuffle-down reduction took a quarter of the pass (0.0623 ms
//   with it, 0.0473 halved; H100, PERF.md), and the probes' gathers the
//   rest; at K6's 65536 lanes (256 blocks, one wave) the latency of one
//   point's loads. 80 registers (`__launch_bounds__(256, 3)`: three blocks
//   an SM; the DIRECT7 instance spills 128 bytes and still runs 3% faster
//   than at two).
//   Tried and dropped, with their times in PERF.md: the earlier whole-row
//   loads for DIRECT1, two and one blocks an SM, the shuffle-down reduction.
//
// Kernel 13's derivative pass (lv_slam_tpu/graph/loop_detector.py:69
// `_fused_verify_fn`, the vmapped `ndt_align_hash_table` over the loop
// candidates) is the same pass with a candidate grid axis: block (b, c)
// reads candidate c's points, mask and transform and writes its own partial
// row; `ndt_finish` runs one block per candidate. One launch serves every
// candidate of a Newton iteration.
#include "ndt_terms.cuh"

namespace {

using lvs::flat_key;

constexpr unsigned kFib = 2654435769u;  // 2^32 / golden ratio
constexpr int kTerms = lvs::kNdtTerms;

__device__ __forceinline__ int bucket_of(int key, int b_bits) {
  return static_cast<int>((static_cast<unsigned>(key) * kFib) >> (32 - b_bits));
}

// ---------------------------------------------------------------- kernel 3

__global__ void hash_init(int n_buckets, int sentinel, int2* heads, int* n_dropped) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b == 0) *n_dropped = 0;
  if (b < n_buckets) heads[b] = make_int2(sentinel, sentinel);
}

__device__ __forceinline__ int leaf_key(const float* means, const int* origin, float inv_res, int e,
                                        int l) {
  int c0 = lvs::cell_floor(means[3 * l + 0], inv_res) - origin[0];
  int c1 = lvs::cell_floor(means[3 * l + 1], inv_res) - origin[1];
  int c2 = lvs::cell_floor(means[3 * l + 2], inv_res) - origin[2];
  return flat_key(c0, c1, c2, e);
}

// each leaf's key, once, into keys[l]; slot 0 of its bucket; the block's
// valid leaves added to n_dropped (`hash_rows` takes the filled slots off)
__global__ void hash_slot0(const float* __restrict__ means, const bool* __restrict__ valid,
                           const int* __restrict__ origin, float inv_res, int e, int leaf_cap, int b_bits,
                           int* __restrict__ keys, int2* heads, int* n_dropped) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  bool v = l < leaf_cap && valid[l];
  if (v) {
    int key = leaf_key(means, origin, inv_res, e, l);
    keys[l] = key;
    atomicMin(&heads[bucket_of(key, b_bits)].x, l);
  }
  int n_valid = __syncthreads_count(v);
  if (threadIdx.x == 0 && n_valid) atomicAdd(n_dropped, n_valid);
}

__global__ void hash_slot1(const bool* __restrict__ valid, const int* __restrict__ keys, int leaf_cap,
                           int b_bits, int2* heads) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= leaf_cap || !valid[l]) return;
  int2* head = &heads[bucket_of(keys[l], b_bits)];
  if (head->x != l) atomicMin(&head->y, l);
}

// row of bucket b: [key bits, mu(3), c00 c01 c02 c11 c12 c22, w, 0 x 5] x 2
// slots; thread t writes float4 t % 8 of bucket t / 8
__global__ void hash_rows(const float* __restrict__ means, const float* __restrict__ icovs,
                          const float* __restrict__ weights, const int* __restrict__ keys, int leaf_cap,
                          int n_buckets, const int2* __restrict__ heads, float4* __restrict__ table,
                          int* n_dropped) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int b = static_cast<int>(t >> 3), part = static_cast<int>(t & 3);
  bool filled = false;
  if (b < n_buckets) {
    int2 head = heads[b];
    int l = (t & 4) ? head.y : head.x;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (l < leaf_cap) {
      const float* c = icovs + 9 * static_cast<long long>(l);
      if (part == 0) {
        v = make_float4(__int_as_float(keys[l]), means[3 * l + 0], means[3 * l + 1], means[3 * l + 2]);
        filled = true;
      } else if (part == 1) {
        v = make_float4(c[0], c[1], c[2], c[4]);
      } else if (part == 2) {
        v.x = c[5];
        v.y = c[8];
        v.z = weights[l];
      }
    } else if (part == 0) {
      v.x = __int_as_float(-1);  // empty slot: never equals a valid (>= 0) query key
    }
    table[t] = v;
  }
  int n_filled = __syncthreads_count(filled);
  if (threadIdx.x == 0 && n_filled) atomicSub(n_dropped, n_filled);
}

// ---------------------------------------------------------------- kernel 4

constexpr int kProbeGroup = 7;  // DIRECT7's offsets: a group's key loads are in flight together

constexpr int kPassMinBlocks = 3;  // blocks an SM: 80 registers

// The pass over KP offsets a group (1 or kProbeGroup): each probe first
// loads the two slots' key words, and a hit then loads its slot's head,
// covariance and tail.
template <int KP>
__global__ void __launch_bounds__(lvs::kThreads, kPassMinBlocks)
ndt_partials(const float* __restrict__ table, int b_bits, const int* __restrict__ origin,
             float inv_res, int e, const float* __restrict__ xs, int n,
             const bool* __restrict__ mask, const float* __restrict__ T, int t_stride, const int* __restrict__ done,
             int done_stride, float d1, float d2, const int* __restrict__ offsets, int k, int weighted,
             float* __restrict__ partials) {
  // the Newton loop's gate: a finished candidate's block returns at once
  if (done != nullptr && done[done_stride * blockIdx.y]) return;
  // candidate blockIdx.y: its own points, mask, transform and partial rows
  xs += 3LL * n * blockIdx.y;
  mask += static_cast<long long>(n) * blockIdx.y;
  T += static_cast<long long>(t_stride) * blockIdx.y;
  partials += static_cast<long long>(kTerms) * gridDim.x * blockIdx.y;
  float acc[kTerms];
#pragma unroll
  for (int v = 0; v < kTerms; ++v) acc[v] = 0.0f;

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && mask[i]) {
    float x0 = xs[i], x1 = xs[n + i], x2 = xs[2 * n + i];
    float y[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) y[r] = T[4 * r + 0] * x0 + T[4 * r + 1] * x1 + T[4 * r + 2] * x2 + T[4 * r + 3];
    int cell[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) cell[r] = lvs::cell_floor(y[r], inv_res) - origin[r];
    const int* words = reinterpret_cast<const int*>(table);
    for (int o0 = 0; o0 < k; o0 += KP) {
      // every probe of the group: its cell's key and bucket, then both
      // slots' key words (sectors 0 and 2 of the row) in flight together
      int key[KP], bucket[KP];
      unsigned live = 0;  // the probes whose cell lies inside [0, e)^3
#pragma unroll
      for (int p = 0; p < KP; ++p) {
        const int o = o0 + p;
        key[p] = 0;
        if (o < k) {
          const int r0 = cell[0] + offsets[3 * o + 0];
          const int r1 = cell[1] + offsets[3 * o + 1];
          const int r2 = cell[2] + offsets[3 * o + 2];
          if (r0 >= 0 && r0 < e && r1 >= 0 && r1 < e && r2 >= 0 && r2 < e) {
            key[p] = flat_key(r0, r1, r2, e);
            live |= 1u << p;
          }
        }
        bucket[p] = bucket_of(key[p], b_bits);
      }
      int k0[KP], k1[KP];
#pragma unroll
      for (int p = 0; p < KP; ++p) {
        k0[p] = k1[p] = 0;
        if (live >> p & 1) {
          const int* row = words + 32 * static_cast<long long>(bucket[p]);
          k0[p] = __ldg(row);
          k1[p] = __ldg(row + 16);
        }
      }
      // the hits in offset order: the matching slot's 48 bytes (its head
      // and covariance share the key's sector), then its terms
#pragma unroll
      for (int p = 0; p < KP; ++p) {
        if (!(live >> p & 1)) continue;
        const bool m0 = k0[p] == key[p];
        if (!m0 && k1[p] != key[p]) continue;
        const float4* slot = reinterpret_cast<const float4*>(table + 32 * static_cast<long long>(bucket[p])) +
                             (m0 ? 0 : 4);
        const float4 head = __ldg(slot), cov = __ldg(slot + 1), tail = __ldg(slot + 2);
        lvs::ndt_point_terms(y, head.y, head.z, head.w, cov.x, cov.y, cov.z, cov.w, tail.x, tail.y, tail.z,
                             d1, d2, weighted, acc);
      }
    }
  }
  lvs::block_partials(acc, partials + kTerms * blockIdx.x);
}

// Launches the pass over grid (n_blocks, n_cand) with the group size for k
// offsets; the gate `done` may be null.
int launch_partials(const float* table, int b_bits, const int* origin, float inv_res, int e, const float* xs, int n,
                    const bool* mask, const float* T, int t_stride, const int* done, int done_stride, int n_cand,
                    float d1, float d2, const int* offsets, int k, int weighted, float* partials, int n_blocks,
                    cudaStream_t stream) {
  const dim3 grid(n_blocks, n_cand);
  if (k == 1)
    ndt_partials<1><<<grid, lvs::kThreads, 0, stream>>>(
        table, b_bits, origin, inv_res, e, xs, n, mask, T, t_stride, done, done_stride, d1, d2, offsets, k,
        weighted, partials);
  else
    ndt_partials<kProbeGroup><<<grid, lvs::kThreads, 0, stream>>>(
        table, b_bits, origin, inv_res, e, xs, n, mask, T, t_stride, done, done_stride, d1, d2, offsets, k,
        weighted, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// scratch: leaf_cap int32 keys, then n_buckets int2 heads (8-byte aligned)
extern "C" int lvs_to_hash(const float* means, const float* icovs, const float* weights,
                           const bool* valid, const int* origin, float inv_res, int e,
                           int leaf_cap, int b_bits, int* scratch, float* table,
                           int* n_dropped, cudaStream_t stream) {
  int n_buckets = 1 << b_bits;
  int* keys = scratch;
  int2* heads = reinterpret_cast<int2*>(scratch + ((leaf_cap + 1) & ~1));
  hash_init<<<lvs::blocks_for(n_buckets), lvs::kThreads, 0, stream>>>(n_buckets, leaf_cap, heads, n_dropped);
  if (leaf_cap > 0) {
    int bl = lvs::blocks_for(leaf_cap);
    hash_slot0<<<bl, lvs::kThreads, 0, stream>>>(means, valid, origin, inv_res, e, leaf_cap, b_bits, keys, heads,
                                                 n_dropped);
    hash_slot1<<<bl, lvs::kThreads, 0, stream>>>(valid, keys, leaf_cap, b_bits, heads);
  }
  hash_rows<<<lvs::blocks_for(8LL * n_buckets), lvs::kThreads, 0, stream>>>(
      means, icovs, weights, keys, leaf_cap, n_buckets, heads, reinterpret_cast<float4*>(table), n_dropped);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_ndt_hash_derivatives(const float* table, int b_bits, const int* origin,
                                        float inv_res, int e, const float* xs, int n,
                                        const bool* mask, const float* T, float d1, float d2,
                                        const int* offsets, int k, int weighted, float* partials,
                                        int n_blocks, float* out, cudaStream_t stream) {
  const int err = launch_partials(table, b_bits, origin, inv_res, e, xs, n, mask, T, 16, nullptr, 0, 1, d1, d2,
                                  offsets, k, weighted, partials, n_blocks, stream);
  if (err) return err;
  ndt_finish<<<1, 64, 0, stream>>>(partials, n_blocks, out);
  LVS_RETURN_LAST_ERROR();
}

// n_cand candidates: xs (n_cand, 3, n), mask (n_cand, n), T (n_cand, 4, 4),
// partials (n_cand, n_blocks, 43), out (n_cand, 43)
extern "C" int lvs_ndt_hash_derivatives_batched(const float* table, int b_bits, const int* origin,
                                                float inv_res, int e, const float* xs, int n,
                                                const bool* mask, const float* T, int n_cand,
                                                float d1, float d2, const int* offsets, int k,
                                                int weighted, float* partials, int n_blocks,
                                                float* out, cudaStream_t stream) {
  if (n_cand > 0) {
    const int err = launch_partials(table, b_bits, origin, inv_res, e, xs, n, mask, T, 16, nullptr, 0, n_cand, d1,
                                    d2, offsets, k, weighted, partials, n_blocks, stream);
    if (err) return err;
    ndt_finish<<<n_cand, 64, 0, stream>>>(partials, n_blocks, out);
  }
  LVS_RETURN_LAST_ERROR();
}

// The Newton loop's pass (K6 with n_cand 1, K13's with the candidates):
// candidate c's transform at T + t_stride * c and its gate at done +
// done_stride * c, both in the loop's state buffers; the partial rows only
// (`newton_step` sums them).
extern "C" int lvs_ndt_hash_partials(const float* table, int b_bits, const int* origin, float inv_res, int e,
                                     const float* xs, int n, const bool* mask, const float* T, int t_stride,
                                     const int* done, int done_stride, int n_cand, float d1, float d2,
                                     const int* offsets, int k, int weighted, float* partials, int n_blocks,
                                     cudaStream_t stream) {
  if (n_cand > 0)
    return launch_partials(table, b_bits, origin, inv_res, e, xs, n, mask, T, t_stride, done, done_stride, n_cand, d1,
                           d2, offsets, k, weighted, partials, n_blocks, stream);
  LVS_RETURN_LAST_ERROR();
}
