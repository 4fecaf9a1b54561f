// Kernels K6L and K6G: the NDT derivative passes over the dense voxel->leaf
// LUT (the host DLO's align and its retry's arbiter, the fused odometry's
// table="lut").
//
// K6L replaces lv_slam_tpu/ops/ndt_soa.py:134 `ndt_derivatives_soa` (body
// :59 `accumulate_ndt_terms`, rows packed by `to_soa` :35).
//   Bound on the card: per call it reads N points (12 B each, N = 65536 on
//   the host DLO) and, per point and offset, one 4-byte LUT entry and one
//   64-byte packed row; the rows (2 MB at 32768 leaves) stay in the 50 MB L2,
//   the 64 MiB LUT does not, so each probe is a dependent random read of
//   device memory. About 300 flops per hit: latency-bound, like kernel 4.
//   Design: kernel 4's pass with another probe. One thread per point
//   transforms it as XLA compiles the reference's einsum on the CPU,
//   fma(z, R2, fma(y, R1, x * R0)) + t (each fma in float64, rounded once, as
//   the plain twin), so kernel, twin and reference put every point in the
//   same cell; takes its cell by a true float32 division by the resolution
//   (the reference divides by the map's resolution array, not by a folded
//   reciprocal); and per offset tests
//   the extent, loads the LUT entry and, on a hit, the packed row in three
//   16-byte loads. The per-point body, the block reduction and the fixed-order
//   finish are kernel 4's (ndt_terms.cuh), so the result is deterministic.
//
// K6G replaces lv_slam_tpu/ops/ndt.py:59 `ndt_derivatives` over
// lv_slam_tpu/ops/voxel_map.py:214 `lookup_leaves`.
//   Bound on the card: the same reads as K6L, with each hit's leaf read as
//   52 bytes from three arrays (mean, the full 3x3 inverse covariance,
//   weight) instead of one packed row; about 400 flops per hit.
//   Design: one thread per point over the K offsets, with the generic
//   formulas in the reference's arithmetic: the point moves as XLA contracts
//   `points @ R^T + t` on the CPU (the same fma chain as K6L's), the cross
//   product y x q as XLA's fma chain, q = C d with all nine entries of C (the
//   reference's icov is V diag(1/l) V^T, whose mirrored entries can differ in
//   the last bit), and the Hessian's C S, S C and S C S blocks each formed as
//   written, not through S C = -(C S)^T. The 43 sums reduce as kernel 4's.
#include "ndt_terms.cuh"

namespace {

constexpr int kTerms = lvs::kNdtTerms;

using lvs::fma64;  // float32 fma as the plain twin's `fma32` computes it

__global__ void __launch_bounds__(lvs::kThreads)
ndt_lut_partials(const float* __restrict__ packed, const int* __restrict__ lut,
                 const int* __restrict__ origin, float res, int e, const float* __restrict__ xs, int n,
                 const bool* __restrict__ mask, const float* __restrict__ T, const int* __restrict__ done,
                 float d1, float d2, const int* __restrict__ offsets, int k, int weighted,
                 float* __restrict__ partials) {
  if (done != nullptr && *done) return;  // the Newton loop's gate
  float acc[kTerms];
#pragma unroll
  for (int v = 0; v < kTerms; ++v) acc[v] = 0.0f;

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && mask[i]) {
    float x0 = xs[i], x1 = xs[n + i], x2 = xs[2 * n + i];
    float y[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      y[r] = fma64(x2, T[4 * r + 2], fma64(x1, T[4 * r + 1], x0 * T[4 * r + 0])) + T[4 * r + 3];
    int cell[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) cell[r] = static_cast<int>(floorf(__fdiv_rn(y[r], res))) - origin[r];
    for (int o = 0; o < k; ++o) {
      int r0 = cell[0] + offsets[3 * o + 0];
      int r1 = cell[1] + offsets[3 * o + 1];
      int r2 = cell[2] + offsets[3 * o + 2];
      if (r0 < 0 || r0 >= e || r1 < 0 || r1 >= e || r2 < 0 || r2 >= e) continue;
      int leaf = __ldg(lut + lvs::flat_key(r0, r1, r2, e));
      if (leaf < 0) continue;
      // row: mu0 mu1 mu2 c00 | c01 c02 c11 c12 | c22 w pad pad
      const float4* row4 = reinterpret_cast<const float4*>(packed + 16 * static_cast<long long>(leaf));
      float4 a = __ldg(row4 + 0), b = __ldg(row4 + 1), c = __ldg(row4 + 2);
      lvs::ndt_point_terms(y, a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, d1, d2, weighted, acc);
    }
  }
  lvs::block_partials(acc, partials + kTerms * blockIdx.x);
}

// One (point, leaf) contribution of the generic pass: y the transformed
// point, mu the leaf mean, C its full inverse covariance (row-major).
__device__ __forceinline__ void generic_terms(const float y[3], const float mu[3], float C[3][3],
                                              float w_leaf, float d1, float d2, int weighted,
                                              float acc[kTerms]) {
  float d[3] = {y[0] - mu[0], y[1] - mu[1], y[2] - mu[2]};
  float q[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) q[r] = C[r][0] * d[0] + C[r][1] * d[1] + C[r][2] * d[2];
  float md = d[0] * q[0] + d[1] * q[1] + d[2] * q[2];
  float eterm = expf(-0.5f * d2 * md);
  float gate = d2 * eterm;
  if (!(gate <= 1.0f && gate >= 0.0f && isfinite(gate))) return;
  float w = weighted ? w_leaf : 1.0f;
  float wf = w * ((d1 * d2) * eterm);
  acc[0] += w * (-d1 * eterm);

  // g6 = [q ; y x q], the cross product as XLA's fma chain
  float g[6] = {q[0], q[1], q[2], fma64(y[1], q[2], -(y[2] * q[1])), fma64(y[2], q[0], -(y[0] * q[2])),
                fma64(y[0], q[1], -(y[1] * q[0]))};
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[1 + a] += wf * g[a];

  // S = skew(y); CS = C S, SC = S C, SCS = (S C) S, each as written
  float S[3][3] = {{0.0f, -y[2], y[1]}, {y[2], 0.0f, -y[0]}, {-y[1], y[0], 0.0f}};
  float cs[3][3], sc[3][3], scs[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      cs[a][b] = C[a][0] * S[0][b] + C[a][1] * S[1][b] + C[a][2] * S[2][b];
      sc[a][b] = S[a][0] * C[0][b] + S[a][1] * C[1][b] + S[a][2] * C[2][b];
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) scs[a][b] = sc[a][0] * S[0][b] + sc[a][1] * S[1][b] + sc[a][2] * S[2][b];
  float qy = q[0] * y[0] + q[1] * y[1] + q[2] * y[2];
  float h1 = -d2 * wf;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      float h = h1 * g[a] * g[b];
      if (a < 3 && b < 3) {
        h += wf * C[a][b];
      } else if (a < 3) {
        h += -(wf * cs[a][b - 3]);
      } else if (b < 3) {
        h += wf * sc[a - 3][b];
      } else {
        h += wf * y[a - 3] * q[b - 3] - (a == b ? wf * qy : 0.0f);  // T2
        h += -(wf * scs[a - 3][b - 3]);
      }
      acc[7 + 6 * a + b] += h;
    }
  }
}

__global__ void __launch_bounds__(lvs::kThreads)
ndt_generic_partials(const float* __restrict__ means, const float* __restrict__ icovs,
                     const float* __restrict__ weights, const int* __restrict__ lut,
                     const int* __restrict__ origin, float res, int e, const float* __restrict__ xyz,
                     int n, const bool* __restrict__ mask, const float* __restrict__ T,
                     const int* __restrict__ done, float d1, float d2, const int* __restrict__ offsets, int k,
                     int weighted, float* __restrict__ partials) {
  if (done != nullptr && *done) return;  // the Newton loop's gate
  float acc[kTerms];
#pragma unroll
  for (int v = 0; v < kTerms; ++v) acc[v] = 0.0f;

  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && mask[i]) {
    float x0 = xyz[3 * i], x1 = xyz[3 * i + 1], x2 = xyz[3 * i + 2];
    float y[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
      y[r] = fma64(x2, T[4 * r + 2], fma64(x1, T[4 * r + 1], x0 * T[4 * r + 0])) + T[4 * r + 3];
    int cell[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) cell[r] = static_cast<int>(floorf(__fdiv_rn(y[r], res))) - origin[r];
    for (int o = 0; o < k; ++o) {
      int r0 = cell[0] + offsets[3 * o + 0];
      int r1 = cell[1] + offsets[3 * o + 1];
      int r2 = cell[2] + offsets[3 * o + 2];
      if (r0 < 0 || r0 >= e || r1 < 0 || r1 >= e || r2 < 0 || r2 >= e) continue;
      int leaf = __ldg(lut + lvs::flat_key(r0, r1, r2, e));
      if (leaf < 0) continue;
      long long l = leaf;
      float mu[3] = {__ldg(means + 3 * l), __ldg(means + 3 * l + 1), __ldg(means + 3 * l + 2)};
      float C[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) C[a][b] = __ldg(icovs + 9 * l + 3 * a + b);
      generic_terms(y, mu, C, __ldg(weights + l), d1, d2, weighted, acc);
    }
  }
  lvs::block_partials(acc, partials + kTerms * blockIdx.x);
}

}  // namespace

// xs (3, n), mask (n,), T (4, 4), packed (L, 16), lut (e^3,), partials
// (n_blocks, 43), out (43,)
extern "C" int lvs_ndt_lut_derivatives(const float* packed, const int* lut, const int* origin, float res,
                                       int e, const float* xs, int n, const bool* mask, const float* T,
                                       float d1, float d2, const int* offsets, int k, int weighted,
                                       float* partials, int n_blocks, float* out, cudaStream_t stream) {
  ndt_lut_partials<<<n_blocks, lvs::kThreads, 0, stream>>>(packed, lut, origin, res, e, xs, n, mask, T, nullptr,
                                                           d1, d2, offsets, k, weighted, partials);
  ndt_finish<<<1, 64, 0, stream>>>(partials, n_blocks, out);
  LVS_RETURN_LAST_ERROR();
}

// xyz (n, 3), means (L, 3), icovs (L, 3, 3), weights (L,), the rest as above
extern "C" int lvs_ndt_generic_derivatives(const float* means, const float* icovs, const float* weights,
                                           const int* lut, const int* origin, float res, int e,
                                           const float* xyz, int n, const bool* mask, const float* T,
                                           float d1, float d2, const int* offsets, int k, int weighted,
                                           float* partials, int n_blocks, float* out, cudaStream_t stream) {
  ndt_generic_partials<<<n_blocks, lvs::kThreads, 0, stream>>>(means, icovs, weights, lut, origin, res, e, xyz, n,
                                                               mask, T, nullptr, d1, d2, offsets, k, weighted,
                                                               partials);
  ndt_finish<<<1, 64, 0, stream>>>(partials, n_blocks, out);
  LVS_RETURN_LAST_ERROR();
}

// The Newton loop's passes (K7, csrc/newton.cu): the transform is the
// candidate in the loop's state, the pass is skipped once `*done` is set,
// and only the partial rows are written (`newton_step` sums them).
extern "C" int lvs_ndt_lut_partials(const float* packed, const int* lut, const int* origin, float res, int e,
                                    const float* xs, int n, const bool* mask, const float* T, const int* done,
                                    float d1, float d2, const int* offsets, int k, int weighted, float* partials,
                                    int n_blocks, cudaStream_t stream) {
  ndt_lut_partials<<<n_blocks, lvs::kThreads, 0, stream>>>(packed, lut, origin, res, e, xs, n, mask, T, done, d1,
                                                           d2, offsets, k, weighted, partials);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_ndt_generic_partials(const float* means, const float* icovs, const float* weights, const int* lut,
                                        const int* origin, float res, int e, const float* xyz, int n,
                                        const bool* mask, const float* T, const int* done, float d1, float d2,
                                        const int* offsets, int k, int weighted, float* partials, int n_blocks,
                                        cudaStream_t stream) {
  ndt_generic_partials<<<n_blocks, lvs::kThreads, 0, stream>>>(means, icovs, weights, lut, origin, res, e, xyz, n,
                                                               mask, T, done, d1, d2, offsets, k, weighted,
                                                               partials);
  LVS_RETURN_LAST_ERROR();
}
