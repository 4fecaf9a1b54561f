// Kernel 0a and the distance band: the prefilter's front, the per-point
// vertical-angle calibration, the distance band, or the two in one pass.
//
// Replaces: lv_slam_tpu/ops/prefilter.py:33 `vertical_angle_calibration`
// (0a) and :26 `distance_filter` (the band; a plain jnp op in the reference).
//
// What bounds it on the card: bytes. The function reads each lane's mask (1
// byte) and, where it is set, its point (12 bytes), and writes its point
// (12 bytes) and, with the band, its keep flag (1 byte): ~3.3 MB at 131072
// lanes. The calibration's ~70 operations a lane, most of them float64 (the
// twin's fma emulation) with their float32 <-> float64 conversions (16 a
// clock an SM), cost more than the bytes.
//
// Design: `prefilter_front<kCalibrate, kBand>`, one thread a lane: it loads
// the lane's mask byte and point together (a masked-out lane's point is
// read and dropped), keeps everything in registers and writes the point
// (the sentinel where the lane is not kept) and, with the band, the keep
// flag. A warp's 4-byte accesses cover whole sectors. On an H100, 2 and 4
// lanes a thread with 8- and 16-byte vectors were slower in every form
// (fewer threads hid less of the calibration's latency), and a point load
// behind the mask's was no faster (`scripts/front_variants.cu`, timed by
// `scripts/prefilter_gicp_parent.py`).
//
// The calibration rounds as the reference's program on the CPU (XLA's fma
// chains, each fused multiply-add rounded once in float64 and then to
// float32, as the plain twin's `fma32`): the axis p x z = (y, -x, 0) divided
// by max(|p x z|, 1e-12), phi = axis * angle, theta^2 = fma(phi1, phi1,
// phi0 phi0), Rodrigues' factors sin(t) / t and (1 - cos(t)) / t^2 (the
// Taylor values 1 and 1/2 below theta^2 = 1e-8), R = fma(B, K^2, fma(A, K,
// I)) with K^2 an fma chain, and R p an fma chain. With phi_z = 0, most of
// K^2's and R's fma chains add exact zeros: where phi_x, phi_y, B, phi_x
// phi_y, A phi_x, A phi_y and K^2's last diagonal entry are finite and
// nonzero, a zero added to a nonzero value leaves it as it is, so R's entries
// are the products and the four fmas that remain (`rotation`);
// any other lane (the z axis, NaN, underflow) runs every chain of the full
// form (`rotation_full`), so the sign of every zero stays the twin's. The
// band keeps near < |p| < far, |p| = sqrt(fma(z, z, fma(y, y, x * x))) with
// the fmas rounded as above and an IEEE root (the twin's `sqrt32`).
#include "common.cuh"

#include <math.h>

namespace {

// R of the full form: every fma chain of K^2 and of fma(B, K^2, fma(A, K, I))
__device__ __forceinline__ void rotation_full(float x, float y, float a, float b, float (&rot)[3][3]) {
  const float k[3][3] = {{0.0f, -0.0f, y}, {0.0f, 0.0f, -x}, {-y, x, 0.0f}};  // skew(phi), phi_z = 0
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float kk = lvs::fma64(k[r][2], k[2][c], lvs::fma64(k[r][1], k[1][c], __fmul_rn(k[r][0], k[0][c])));
      rot[r][c] = lvs::fma64(b, kk, lvs::fma64(a, k[r][c], r == c ? 1.0f : 0.0f));
    }
}

// R, bit for bit `rotation_full`'s (see the header)
__device__ __forceinline__ void rotation(float x, float y, float a, float b, float (&rot)[3][3]) {
  const float xy = __fmul_rn(x, y), ax = __fmul_rn(a, x), ay = __fmul_rn(a, y);
  const float k22 = lvs::fma64(x, -x, __fmul_rn(-y, y));  // K^2[2][2] = fma(x, -x, -y * y)
  const bool exact = isfinite(x) && isfinite(y) && x != 0.0f && y != 0.0f && b != 0.0f && xy != 0.0f &&
                     ax != 0.0f && ay != 0.0f && k22 != 0.0f;
  if (!exact) {
    rotation_full(x, y, a, b, rot);
    return;
  }
  const float bxy = __fmul_rn(b, xy);
  rot[0][0] = lvs::fma64(b, __fmul_rn(y, -y), 1.0f);
  rot[0][1] = bxy;
  rot[0][2] = ay;
  rot[1][0] = bxy;
  rot[1][1] = lvs::fma64(b, __fmul_rn(-x, x), 1.0f);
  rot[1][2] = -ax;
  rot[2][0] = -ay;
  rot[2][1] = ax;
  rot[2][2] = lvs::fma64(b, k22, 1.0f);
}

// p rotated by angle about the unit axis p x z
__device__ __forceinline__ void calibrate(const float (&p)[3], float angle, float (&out)[3]) {
  float den = fmaxf(sqrtf(lvs::fma64(p[0], p[0], __fmul_rn(p[1], p[1]))), 1e-12f);
  float x = __fmul_rn(__fdiv_rn(p[1], den), angle), y = __fmul_rn(__fdiv_rn(-p[0], den), angle);  // phi
  float tsq = lvs::fma64(y, y, __fmul_rn(x, x));
  float a = 1.0f, b = 0.5f;  // the Taylor branch's values at theta^2 < 1e-8
  if (!(tsq < 1e-8f)) {
    float t = sqrtf(tsq);
    a = __fdiv_rn(sinf(t), t);
    b = __fdiv_rn(__fsub_rn(1.0f, cosf(t)), tsq);
  }
  float rot[3][3];
  rotation(x, y, a, b, rot);
#pragma unroll
  for (int r = 0; r < 3; ++r) out[r] = lvs::dot3_fma(rot[r][0], rot[r][1], rot[r][2], p[0], p[1], p[2]);
}

__device__ __forceinline__ bool in_band(const float (&p)[3], float near, float far) {
  float d = sqrtf(lvs::dot3_fma(p[0], p[1], p[2], p[0], p[1], p[2]));
  return d > near && d < far;
}

// kCalibrate: out = mask ? R p : sentinel. kBand: keep = mask & near < |p| <
// far and out = keep ? p : sentinel. Both: the band on the calibrated point.
template <bool kCalibrate, bool kBand>
__global__ void __launch_bounds__(lvs::kThreads)
prefilter_front(const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float angle, float near,
                float far, float* __restrict__ out, bool* __restrict__ keep) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float p[3] = {xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2]};
  bool k = mask[i];
  float q[3] = {lvs::kSentinel, lvs::kSentinel, lvs::kSentinel};
  if (k) {
    float c[3] = {p[0], p[1], p[2]};
    if constexpr (kCalibrate) calibrate(p, angle, c);
    if constexpr (kBand) k = in_band(c, near, far);
    if (k) q[0] = c[0], q[1] = c[1], q[2] = c[2];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) out[3 * i + r] = q[r];
  if constexpr (kBand) keep[i] = k;
}

template <bool kCalibrate, bool kBand>
void launch_front(const float* xyz, const bool* mask, int n, float angle, float near, float far, float* out,
                  bool* keep, cudaStream_t stream) {
  prefilter_front<kCalibrate, kBand><<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(xyz, mask, n, angle, near,
                                                                                       far, out, keep);
}

}  // namespace

// One pass of the prefilter's front over n lanes: with `calibrate`, the
// calibration by `angle` (radians); with `band`, the band near < |p| < far
// and keep (n); out (n, 3).
extern "C" int lvs_prefilter_front(const float* xyz, const bool* mask, int n, int calibrate, float angle, int band,
                                   float near, float far, float* out, bool* keep, cudaStream_t stream) {
  if (!(calibrate || band) || (band && keep == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    if (calibrate && band)
      launch_front<true, true>(xyz, mask, n, angle, near, far, out, keep, stream);
    else if (calibrate)
      launch_front<true, false>(xyz, mask, n, angle, near, far, out, keep, stream);
    else
      launch_front<false, true>(xyz, mask, n, angle, near, far, out, keep, stream);
  }
  LVS_RETURN_LAST_ERROR();
}
