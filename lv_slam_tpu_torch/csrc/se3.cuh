// SE(3) helpers of the device-side loops (K7's `newton_step`, the LM's
// update): `core/se3.exp_se3` in float32 with its small-angle branch, and a
// 4x4 product, each written as the plain PyTorch twins evaluate them (one
// rounding per product and per sum; the build's --fmad=false keeps them
// unfused).
#pragma once

#include "common.cuh"

namespace lvs {

// out = a @ b, row-major 4x4, each entry summed over k in order
__device__ __forceinline__ void matmul44(const float* a, const float* b, float* out) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float s = a[4 * r + 0] * b[c];
      s += a[4 * r + 1] * b[4 + c];
      s += a[4 * r + 2] * b[8 + c];
      s += a[4 * r + 3] * b[12 + c];
      out[4 * r + c] = s;
    }
}

// exp([rho, phi]) as a row-major 4x4: R = I + A K + B K^2, t = (I + B K +
// C K^2) rho with K = skew(phi), and the Taylor branch below |phi| = 1e-4
__device__ __forceinline__ void exp_se3(const float xi[6], float out[16]) {
  const float p0 = xi[3], p1 = xi[4], p2 = xi[5];
  const float theta_sq = p0 * p0 + p1 * p1 + p2 * p2;
  const bool small = theta_sq < 1e-8f;
  const float safe_tsq = small ? 1.0f : theta_sq;
  const float safe_t = sqrtf(safe_tsq);
  float a, b, c;
  if (small) {
    a = 1.0f - theta_sq / 6.0f;
    b = 0.5f - theta_sq / 24.0f;
    c = 1.0f / 6.0f - theta_sq / 120.0f;
  } else {
    const float sn = sinf(safe_t), cs = cosf(safe_t);
    a = sn / safe_t;
    b = (1.0f - cs) / safe_tsq;
    c = (safe_t - sn) / (safe_tsq * safe_t);
  }
  const float k[3][3] = {{0.0f, -p2, p1}, {p2, 0.0f, -p0}, {-p1, p0, 0.0f}};
  float k2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float s = k[i][0] * k[0][j];
      s += k[i][1] * k[1][j];
      s += k[i][2] * k[2][j];
      k2[i][j] = s;
    }
  float v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      out[4 * i + j] = (eye + a * k[i][j]) + b * k2[i][j];
      v[i][j] = (eye + b * k[i][j]) + c * k2[i][j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float s = v[i][0] * xi[0];
    s += v[i][1] * xi[1];
    s += v[i][2] * xi[2];
    out[4 * i + 3] = s;
  }
  out[12] = 0.0f;
  out[13] = 0.0f;
  out[14] = 0.0f;
  out[15] = 1.0f;
}

}  // namespace lvs
