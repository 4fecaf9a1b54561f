// Kernels 3 and 4: the bucket-pair hash table of an NDT voxel map and the NDT
// derivative pass over it.
//
// Kernel 3 replaces lv_slam_tpu/ops/ndt_hash.py:53 `to_hash`.
//   Bound on the card: once per keyframe it touches leaf_cap leaves and
//   B = 4 * leaf_cap buckets of 128 bytes (16 MB of table at leaf_cap 32768):
//   pure memory traffic, a few microseconds of HBM time, so the launches'
//   latency is what shows.
//   Design: the reference's two scatter-min passes become atomicMin passes on
//   int32 bucket heads (slot 0 = lowest leaf index, slot 1 = lowest of the
//   rest), a third pass counts the dropped leaves, and a last pass writes each
//   bucket's 32-float row. atomicMin of indices is order-independent, so the
//   table is deterministic and bit-exact with the plain version. Keys are
//   written as int32 bits through an int alias, never through float math.
//
// Kernel 4 replaces lv_slam_tpu/ops/ndt_hash.py:132 `ndt_derivatives_hash`
// with lv_slam_tpu/ops/ndt_soa.py:59 `accumulate_ndt_terms` as its body.
//   Bound on the card: per call it reads N points (12 B each, N = 65536 or
//   32768 on the coarse phase) and one random 128-byte table row per point
//   and offset; the table (16 MB) stays in the 50 MB L2 across the Newton
//   iterations. About 300 flops per hit, so the kernel is bound by the
//   dependent row load and by the 43-wide reduction, not by arithmetic.
//   Design: one thread per point loops over the K offsets and keeps the 43
//   sums (score, gradient 6, Hessian 36: the T2 block is not symmetric, so no
//   triangle is mirrored) in registers; lanes that miss or fail the gate are
//   skipped, never multiplied by 0 (a sentinel lane's terms can be inf). Warp
//   shuffles and shared memory reduce each block to one partial row; a second
//   one-block kernel sums the partial rows in a fixed order, so the result is
//   deterministic run to run.
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

__global__ void hash_init(int n_buckets, int sentinel, int* first, int* second, int* n_dropped) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b == 0) *n_dropped = 0;
  if (b < n_buckets) {
    first[b] = sentinel;
    second[b] = sentinel;
  }
}

__device__ __forceinline__ int leaf_key(const float* means, const int* origin, float inv_res, int e,
                                        int l) {
  int c0 = static_cast<int>(floorf(means[3 * l + 0] * inv_res)) - origin[0];
  int c1 = static_cast<int>(floorf(means[3 * l + 1] * inv_res)) - origin[1];
  int c2 = static_cast<int>(floorf(means[3 * l + 2] * inv_res)) - origin[2];
  return flat_key(c0, c1, c2, e);
}

__global__ void hash_slot0(const float* means, const bool* valid, const int* origin, float inv_res,
                           int e, int leaf_cap, int b_bits, int* first) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= leaf_cap || !valid[l]) return;
  atomicMin(&first[bucket_of(leaf_key(means, origin, inv_res, e, l), b_bits)], l);
}

__global__ void hash_slot1(const float* means, const bool* valid, const int* origin, float inv_res,
                           int e, int leaf_cap, int b_bits, const int* first, int* second) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= leaf_cap || !valid[l]) return;
  int h = bucket_of(leaf_key(means, origin, inv_res, e, l), b_bits);
  if (first[h] != l) atomicMin(&second[h], l);
}

__global__ void hash_dropped(const float* means, const bool* valid, const int* origin,
                             float inv_res, int e, int leaf_cap, int b_bits, const int* first,
                             const int* second, int* n_dropped) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= leaf_cap || !valid[l]) return;
  int h = bucket_of(leaf_key(means, origin, inv_res, e, l), b_bits);
  if (first[h] != l && second[h] != l) atomicAdd(n_dropped, 1);
}

// row of bucket b: [key bits, mu(3), c00 c01 c02 c11 c12 c22, w, 0 x 5] x 2 slots
__global__ void hash_rows(const float* means, const float* icovs, const float* weights,
                          const int* origin, float inv_res, int e, int leaf_cap, int n_buckets,
                          const int* first, const int* second, float* table) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_buckets) return;
  for (int s = 0; s < 2; ++s) {
    int l = s == 0 ? first[b] : second[b];
    float* row = table + 32 * static_cast<long long>(b) + 16 * s;
    int* row_bits = reinterpret_cast<int*>(row);
    for (int c = 1; c < 16; ++c) row[c] = 0.0f;
    if (l >= leaf_cap) {
      row_bits[0] = -1;  // empty slot: never equals a valid (>= 0) query key
      continue;
    }
    row_bits[0] = leaf_key(means, origin, inv_res, e, l);
    row[1] = means[3 * l + 0];
    row[2] = means[3 * l + 1];
    row[3] = means[3 * l + 2];
    const float* c = icovs + 9 * l;
    row[4] = c[0]; row[5] = c[1]; row[6] = c[2];
    row[7] = c[4]; row[8] = c[5]; row[9] = c[8];
    row[10] = weights[l];
  }
}

// ---------------------------------------------------------------- kernel 4

__global__ void __launch_bounds__(lvs::kThreads)
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
    for (int r = 0; r < 3; ++r) cell[r] = static_cast<int>(floorf(y[r] * inv_res)) - origin[r];
    for (int o = 0; o < k; ++o) {
      int r0 = cell[0] + offsets[3 * o + 0];
      int r1 = cell[1] + offsets[3 * o + 1];
      int r2 = cell[2] + offsets[3 * o + 2];
      if (r0 < 0 || r0 >= e || r1 < 0 || r1 >= e || r2 < 0 || r2 >= e) continue;
      int key = flat_key(r0, r1, r2, e);
      const float* row = table + 32 * static_cast<long long>(bucket_of(key, b_bits));
      // columns 0-11 of both slots, all inside one 128-byte row; the slot is
      // chosen by value so everything stays in registers
      const float4* row4 = reinterpret_cast<const float4*>(row);
      float4 a0 = __ldg(row4 + 0), b0 = __ldg(row4 + 1), c0 = __ldg(row4 + 2);
      float4 a1 = __ldg(row4 + 4), b1 = __ldg(row4 + 5), c1 = __ldg(row4 + 6);
      bool m0 = __float_as_int(a0.x) == key;
      if (!m0 && __float_as_int(a1.x) != key) continue;
      float4 head = m0 ? a0 : a1;  // key, mu0, mu1, mu2
      float4 cov = m0 ? b0 : b1;   // c00, c01, c02, c11
      float4 tail = m0 ? c0 : c1;  // c12, c22, w, pad
      lvs::ndt_point_terms(y, head.y, head.z, head.w, cov.x, cov.y, cov.z, cov.w, tail.x, tail.y, tail.z,
                           d1, d2, weighted, acc);
    }
  }
  lvs::block_partials(acc, partials + kTerms * blockIdx.x);
}

}  // namespace

extern "C" int lvs_to_hash(const float* means, const float* icovs, const float* weights,
                           const bool* valid, const int* origin, float inv_res, int e,
                           int leaf_cap, int b_bits, int* first, int* second, float* table,
                           int* n_dropped, cudaStream_t stream) {
  int n_buckets = 1 << b_bits;
  int bb = lvs::blocks_for(n_buckets), bl = lvs::blocks_for(leaf_cap);
  hash_init<<<bb, lvs::kThreads, 0, stream>>>(n_buckets, leaf_cap, first, second, n_dropped);
  if (leaf_cap > 0) {
    hash_slot0<<<bl, lvs::kThreads, 0, stream>>>(means, valid, origin, inv_res, e, leaf_cap, b_bits, first);
    hash_slot1<<<bl, lvs::kThreads, 0, stream>>>(means, valid, origin, inv_res, e, leaf_cap, b_bits,
                                                 first, second);
    hash_dropped<<<bl, lvs::kThreads, 0, stream>>>(means, valid, origin, inv_res, e, leaf_cap,
                                                   b_bits, first, second, n_dropped);
  }
  hash_rows<<<bb, lvs::kThreads, 0, stream>>>(means, icovs, weights, origin, inv_res, e, leaf_cap,
                                              n_buckets, first, second, table);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_ndt_hash_derivatives(const float* table, int b_bits, const int* origin,
                                        float inv_res, int e, const float* xs, int n,
                                        const bool* mask, const float* T, float d1, float d2,
                                        const int* offsets, int k, int weighted, float* partials,
                                        int n_blocks, float* out, cudaStream_t stream) {
  ndt_partials<<<n_blocks, lvs::kThreads, 0, stream>>>(table, b_bits, origin, inv_res, e, xs, n,
                                                       mask, T, 16, nullptr, 0, d1, d2, offsets, k,
                                                       weighted, partials);
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
    ndt_partials<<<dim3(n_blocks, n_cand), lvs::kThreads, 0, stream>>>(
        table, b_bits, origin, inv_res, e, xs, n, mask, T, 16, nullptr, 0, d1, d2, offsets, k, weighted,
        partials);
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
    ndt_partials<<<dim3(n_blocks, n_cand), lvs::kThreads, 0, stream>>>(
        table, b_bits, origin, inv_res, e, xs, n, mask, T, t_stride, done, done_stride, d1, d2, offsets, k,
        weighted, partials);
  LVS_RETURN_LAST_ERROR();
}
