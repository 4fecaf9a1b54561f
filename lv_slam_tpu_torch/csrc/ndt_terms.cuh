// The NDT derivative pass's shared device code: the per-point body of
// lv_slam_tpu/ops/ndt_soa.py:59 `accumulate_ndt_terms` over the upper-triangle
// inverse covariance (kernels 4, 13 and K6L), the 43-wide block reduction into
// one partial row per block, and the fixed-order sum of the partial rows
// (all the derivative passes, K6G included). The 43 terms are the score, the
// gradient (6) and the Hessian (36: the T2 curvature block is not symmetric,
// so no triangle is mirrored).
#pragma once

#include "common.cuh"

namespace lvs {

constexpr int kNdtTerms = 43;
constexpr int kNdtWarps = kThreads / 32;

// (rel0 * e + rel1) * e + rel2 with int32 wrap-around, as the reference's
// int32 arithmetic, without signed-overflow UB
__device__ __forceinline__ int flat_key(int r0, int r1, int r2, int e) {
  unsigned k = (static_cast<unsigned>(r0) * e + static_cast<unsigned>(r1)) * e + static_cast<unsigned>(r2);
  return static_cast<int>(k);
}

// One (point, leaf) contribution of `accumulate_ndt_terms` added to acc: y the
// transformed point, mu the leaf mean, c00..c22 its upper inverse covariance,
// w_leaf its PCA weight. A contribution that fails the gate is skipped, never
// multiplied by 0 (a far lane's terms can be inf).
__device__ __forceinline__ void ndt_point_terms(const float y[3], float mu0, float mu1, float mu2,
                                                float c00, float c01, float c02, float c11, float c12,
                                                float c22, float w_leaf, float d1, float d2,
                                                int weighted, float acc[kNdtTerms]) {
  float dd0 = y[0] - mu0, dd1 = y[1] - mu1, dd2 = y[2] - mu2;
  float q0 = c00 * dd0 + c01 * dd1 + c02 * dd2;
  float q1 = c01 * dd0 + c11 * dd1 + c12 * dd2;
  float q2 = c02 * dd0 + c12 * dd1 + c22 * dd2;
  float md = dd0 * q0 + dd1 * q1 + dd2 * q2;
  float eterm = expf(-0.5f * d2 * md);
  float gate = d2 * eterm;
  if (!(gate <= 1.0f && gate >= 0.0f && isfinite(gate))) return;
  float w = weighted ? w_leaf : 1.0f;
  float f = w * ((d1 * d2) * eterm);
  acc[0] += w * (-d1 * eterm);

  float g[6] = {q0, q1, q2, y[1] * q2 - y[2] * q1, y[2] * q0 - y[0] * q2, y[0] * q1 - y[1] * q0};
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[1 + a] += f * g[a];

  // CS: cs[i][j] = (C S)_ij with S = skew(y); SC = -(CS)^T; SCS from SC
  float C[3][3] = {{c00, c01, c02}, {c01, c11, c12}, {c02, c12, c22}};
  float cs[3][3], sc[3][3], scs[3][3];
  for (int a = 0; a < 3; ++a) {
    cs[a][0] = C[a][1] * y[2] - C[a][2] * y[1];
    cs[a][1] = C[a][2] * y[0] - C[a][0] * y[2];
    cs[a][2] = C[a][0] * y[1] - C[a][1] * y[0];
  }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) sc[a][b] = -cs[b][a];
  for (int a = 0; a < 3; ++a) {
    scs[a][0] = sc[a][1] * y[2] - sc[a][2] * y[1];
    scs[a][1] = sc[a][2] * y[0] - sc[a][0] * y[2];
    scs[a][2] = sc[a][0] * y[1] - sc[a][1] * y[0];
  }
  float qy = q0 * y[0] + q1 * y[1] + q2 * y[2];
  float q[3] = {q0, q1, q2};
  float h1 = -d2 * f;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      float h = h1 * g[a] * g[b];
      if (a < 3 && b < 3) {
        h += f * C[a][b];
      } else if (a < 3) {
        h += -(f * cs[a][b - 3]);
      } else if (b < 3) {
        h += -(f * cs[b][a - 3]);
      } else {
        h += f * y[a - 3] * q[b - 3] - (a == b ? f * qy : 0.0f);  // T2
        h += -(f * scs[a - 3][b - 3]);
      }
      acc[7 + 6 * a + b] += h;
    }
  }
}

// One halving step of `block_partials`: lane l keeps half of its 2N values
// (the upper half where l & mask) and adds its partner's (l ^ mask) for them.
template <int N>
__device__ __forceinline__ void halve(const float (&in)[2 * N], float (&out)[N], int lane, int mask) {
  const bool upper = lane & mask;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float keep = upper ? in[k + N] : in[k], give = upper ? in[k] : in[k + N];
    out[k] = keep + __shfl_xor_sync(0xffffffffu, give, mask);
  }
}

// Sums the block's acc rows into its partial row partials[0..42]: each
// warp's 43 sums (padded to 48) are halved over the lane pairs (l, l ^ 16),
// (l, l ^ 8), (l, l ^ 4), (l, l ^ 2), then the pair (l, l ^ 1) finishes its
// 3 values. Those are the pairs, and so the trees, of `warp_sum`'s
// shuffle-downs (a + b == b + a, so each sum has their bits) at 48 shuffles
// a warp in place of 215; the warps' sums then go through shared memory in
// warp order. Every thread of the block must call it.
__device__ __forceinline__ void block_partials(const float (&acc)[kNdtTerms], float* __restrict__ partials) {
  __shared__ float smem[kNdtWarps][kNdtTerms];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v48[48], v24[24], v12[12], v6[6], v3[3];
#pragma unroll
  for (int k = 0; k < 48; ++k) v48[k] = k < kNdtTerms ? acc[k] : 0.0f;
  halve<24>(v48, v24, lane, 16);
  halve<12>(v24, v12, lane, 8);
  halve<6>(v12, v6, lane, 4);
  halve<3>(v6, v3, lane, 2);
  const int j0 = (lane & 16 ? 24 : 0) + (lane & 8 ? 12 : 0) + (lane & 4 ? 6 : 0) + (lane & 2 ? 3 : 0);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const float sum = v3[t] + __shfl_xor_sync(0xffffffffu, v3[t], 1);
    if (!(lane & 1) && j0 + t < kNdtTerms) smem[warp][j0 + t] = sum;
  }
  __syncthreads();
  if (threadIdx.x < kNdtTerms) {
    float s = 0.0f;
    for (int w = 0; w < kNdtWarps; ++w) s += smem[w][threadIdx.x];
    partials[threadIdx.x] = s;
  }
}

}  // namespace lvs

namespace {

// The partial rows of candidate blockIdx.x summed in block order: the result
// does not change from run to run. Thread v < 43 runs column v's chain; the
// next 32 rows' loads are in flight while this 32's adds run (one 64-thread
// block a candidate, so the loads, not the adds, set its time).
__global__ void ndt_finish(const float* __restrict__ partials, int n_blocks, float* __restrict__ out) {
  constexpr int kAhead = 32;
  int v = threadIdx.x;
  if (v >= lvs::kNdtTerms) return;
  partials += static_cast<long long>(lvs::kNdtTerms) * n_blocks * blockIdx.x + v;
  out += lvs::kNdtTerms * blockIdx.x;
  float s = 0.0f;
  int b = 0;
  if (n_blocks >= kAhead) {
    float x[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) x[u] = __ldg(partials + lvs::kNdtTerms * u);
    for (b = kAhead; b + kAhead <= n_blocks; b += kAhead) {
      float nx[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) nx[u] = __ldg(partials + lvs::kNdtTerms * (b + u));
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        s += x[u];
        x[u] = nx[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) s += x[u];
  }
  for (; b < n_blocks; ++b) s += partials[lvs::kNdtTerms * b];
  out[v] = s;
}

}  // namespace
