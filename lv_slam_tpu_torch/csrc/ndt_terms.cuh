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

// Sums the block's acc rows (warp shuffles, then the warps in order) into its
// partial row partials[0..42]. Every thread of the block must call it.
__device__ __forceinline__ void block_partials(const float acc[kNdtTerms], float* __restrict__ partials) {
  __shared__ float smem[kNdtWarps][kNdtTerms];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < kNdtTerms; ++v) {
    float s = warp_sum(acc[v]);
    if (lane == 0) smem[warp][v] = s;
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
// does not change from run to run.
__global__ void ndt_finish(const float* __restrict__ partials, int n_blocks, float* __restrict__ out) {
  int v = threadIdx.x;
  if (v >= lvs::kNdtTerms) return;
  partials += static_cast<long long>(lvs::kNdtTerms) * n_blocks * blockIdx.x;
  out += lvs::kNdtTerms * blockIdx.x;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partials[lvs::kNdtTerms * b + v];
  out[v] = s;
}

}  // namespace
