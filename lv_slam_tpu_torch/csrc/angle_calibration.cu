// Kernel 0a: the prefilter's per-point vertical-angle calibration.
//
// Replaces: lv_slam_tpu/ops/prefilter.py:33 `vertical_angle_calibration`.
//
// What bounds it on the card: bytes. Each lane reads its point and mask (13
// bytes) and writes its point (12 bytes), ~3.3 MB at 131072 lanes, with ~80
// operations per lane (the axis, Rodrigues' matrix, the product).
//
// Design: one thread per lane, in the reference's order of operations as
// XLA compiles it on the CPU, each fused multiply-add rounded once (in
// float64, as the plain twin's `fma32`): the axis p x z = (y, -x, 0) divided
// by max(|p x z|, 1e-12) (|.| the fma chain under a correctly rounded root),
// phi = axis * angle, theta^2 = fma(phi1, phi1, phi0 phi0), Rodrigues'
// factors sin(t) / t and (1 - cos(t)) / t^2 in float32 (the Taylor values 1
// and 1/2 below theta = 1e-4), R = fma(B, K^2, fma(A, K, I)) with K^2 an fma
// chain, and R p an fma chain. Points on the z axis have no axis and stay
// where they are; masked lanes take the sentinel.
#include "common.cuh"

#include <math.h>

namespace {

__global__ void __launch_bounds__(lvs::kThreads)
angle_calibration(const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float angle,
                  float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (!mask[i]) {
    for (int r = 0; r < 3; ++r) out[3 * i + r] = lvs::kSentinel;
    return;
  }
  float p[3] = {xyz[3 * i + 0], xyz[3 * i + 1], xyz[3 * i + 2]};
  float den = fmaxf(sqrtf(lvs::fma64(p[0], p[0], __fmul_rn(p[1], p[1]))), 1e-12f);
  float x = (p[1] / den) * angle, y = (-p[0] / den) * angle;  // phi; phi_z = 0
  float tsq = lvs::fma64(y, y, __fmul_rn(x, x));
  float a = 1.0f, b = 0.5f;  // the Taylor branch's values at theta^2 < 1e-8
  if (!(tsq < 1e-8f)) {
    float t = sqrtf(tsq);
    a = sinf(t) / t;
    b = (1.0f - cosf(t)) / tsq;
  }
  float k[3][3] = {{0.0f, -0.0f, y}, {0.0f, 0.0f, -x}, {-y, x, 0.0f}};  // skew(phi), phi_z = 0
  float rot[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      float kk = lvs::fma64(k[r][2], k[2][c], lvs::fma64(k[r][1], k[1][c], __fmul_rn(k[r][0], k[0][c])));
      rot[r][c] = lvs::fma64(b, kk, lvs::fma64(a, k[r][c], r == c ? 1.0f : 0.0f));
    }
  for (int r = 0; r < 3; ++r) out[3 * i + r] = lvs::dot3_fma(rot[r][0], rot[r][1], rot[r][2], p[0], p[1], p[2]);
}

}  // namespace

extern "C" int lvs_angle_calibration(const float* xyz, const bool* mask, int n, float angle, float* out,
                                     cudaStream_t stream) {
  if (n > 0) angle_calibration<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(xyz, mask, n, angle, out);
  LVS_RETURN_LAST_ERROR();
}
