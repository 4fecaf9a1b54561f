// Variants of kernel 0a, the prefilter's front
// (lv_slam_tpu_torch/csrc/angle_calibration.cu, `prefilter_front`, one lane a
// thread), for scripts/prefilter_gicp_parent.py:
// - `front_lanes<kCalibrate, kBand, L>`: each form at L = 2 or 4 lanes a
//   thread, the points and keep flags as 8- or 16-byte vectors (three
//   `float4` in and out at 4 lanes) and the mask bytes in one load; the last
//   thread of a cloud whose lanes L does not divide takes its lanes one by
//   one; the pointers must lie on a group's boundary (4 L bytes for the
//   points, L for the flags). Same bits as the shipped kernel;
// - `front_masked_read<kCalibrate, kBand>`: each form at one lane a thread
//   with the point loaded only where the mask is set (behind the mask's
//   load). Same bits as the shipped kernel;
// - `variant_sincos`: sinf and cosf of theta as one `sincosf`; kept only if
//   its bits are the shipped kernel's;
// - `variant_fmaf`: every float64-rounded fma (`lvs::fma64`) of the
//   calibration as one float32 `fmaf`, which rounds once and so is not the
//   twin's arithmetic: it times what the float64 emulation (its conversions
//   and double ops) costs, and ships nowhere.
// Build: nvcc <kernels/_build.py's flags> -shared -I lv_slam_tpu_torch/csrc.
#include "angle_calibration.cu"

namespace {

// L lanes' points (3L floats) and mask bytes from lane i0: vectors for a
// whole group, one lane at a time for the cloud's last, partial group
template <int L>
__device__ __forceinline__ void load_lanes(const float* __restrict__ xyz, const bool* __restrict__ mask,
                                           long long i0, int count, float (&p)[3 * L], bool (&m)[L]) {
  if (count == L) {
    if constexpr (L == 4) {
      const float4* v = reinterpret_cast<const float4*>(xyz + 3 * i0);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        float4 f = v[q];
        p[4 * q] = f.x, p[4 * q + 1] = f.y, p[4 * q + 2] = f.z, p[4 * q + 3] = f.w;
      }
      unsigned w = *reinterpret_cast<const unsigned*>(mask + i0);
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] = (w >> (8 * j)) & 0xffu;
    } else {
      const float2* v = reinterpret_cast<const float2*>(xyz + 3 * i0);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        float2 f = v[q];
        p[2 * q] = f.x, p[2 * q + 1] = f.y;
      }
      unsigned short w = *reinterpret_cast<const unsigned short*>(mask + i0);
      m[0] = w & 0xffu, m[1] = w >> 8;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    m[j] = j < count && mask[i0 + j];
#pragma unroll
    for (int r = 0; r < 3; ++r) p[3 * j + r] = j < count ? xyz[3 * (i0 + j) + r] : 0.0f;
  }
}

template <int L>
__device__ __forceinline__ void store_lanes(float* __restrict__ out, bool* __restrict__ keep, long long i0,
                                            int count, const float (&q)[3 * L], const bool (&k)[L]) {
  if (count == L) {
    if constexpr (L == 4) {
      float4* v = reinterpret_cast<float4*>(out + 3 * i0);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = make_float4(q[4 * c], q[4 * c + 1], q[4 * c + 2], q[4 * c + 3]);
      if (keep != nullptr)
        *reinterpret_cast<unsigned*>(keep + i0) =
            unsigned(k[0]) | unsigned(k[1]) << 8 | unsigned(k[2]) << 16 | unsigned(k[3]) << 24;
    } else {
      float2* v = reinterpret_cast<float2*>(out + 3 * i0);
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = make_float2(q[2 * c], q[2 * c + 1]);
      if (keep != nullptr) *reinterpret_cast<unsigned short*>(keep + i0) = (unsigned short)(k[0] | k[1] << 8);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < L; ++j)
    if (j < count) {
#pragma unroll
      for (int r = 0; r < 3; ++r) out[3 * (i0 + j) + r] = q[3 * j + r];
      if (keep != nullptr) keep[i0 + j] = k[j];
    }
}

// the shipped kernel's function at L lanes a thread
template <bool kCalibrate, bool kBand, int L>
__global__ void __launch_bounds__(lvs::kThreads)
front_lanes(const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float angle, float near, float far,
            float* __restrict__ out, bool* __restrict__ keep) {
  const long long i0 = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * L;
  if (i0 >= n) return;
  const int count = static_cast<int>(n - i0 < L ? n - i0 : L);
  float p[3 * L], q[3 * L];
  bool m[L], k[L];
  load_lanes<L>(xyz, mask, i0, count, p, m);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    float pj[3] = {p[3 * j], p[3 * j + 1], p[3 * j + 2]}, qj[3] = {pj[0], pj[1], pj[2]};
    k[j] = m[j];
    if (m[j]) {
      if constexpr (kCalibrate) calibrate(pj, angle, qj);
      if constexpr (kBand) k[j] = in_band(qj, near, far);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) q[3 * j + r] = k[j] ? qj[r] : lvs::kSentinel;
  }
  store_lanes<L>(out, kBand ? keep : nullptr, i0, count, q, k);
}

template <bool kCalibrate, bool kBand, int L>
void launch_lanes(const float* xyz, const bool* mask, int n, float angle, float near, float far, float* out,
                  bool* keep, cudaStream_t stream) {
  const int blocks = lvs::blocks_for((static_cast<long long>(n) + L - 1) / L);
  front_lanes<kCalibrate, kBand, L><<<blocks, lvs::kThreads, 0, stream>>>(xyz, mask, n, angle, near, far, out, keep);
}

// the shipped kernel with a lane's point read only where its mask is set
template <bool kCalibrate, bool kBand>
__global__ void __launch_bounds__(lvs::kThreads)
front_masked_read(const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float angle, float near,
                  float far, float* __restrict__ out, bool* __restrict__ keep) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool k = mask[i];
  float q[3] = {lvs::kSentinel, lvs::kSentinel, lvs::kSentinel};
  if (k) {
    const float p[3] = {xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2]};
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
void launch_masked_read(const float* xyz, const bool* mask, int n, float angle, float near, float far, float* out,
                        bool* keep, cudaStream_t stream) {
  front_masked_read<kCalibrate, kBand><<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(xyz, mask, n, angle, near,
                                                                                         far, out, keep);
}

template <bool kCalibrate, bool kBand>
void launch_lanes(const float* xyz, const bool* mask, int n, float angle, float near, float far, int lanes,
                  float* out, bool* keep, cudaStream_t stream) {
  if (lanes == 4)
    launch_lanes<kCalibrate, kBand, 4>(xyz, mask, n, angle, near, far, out, keep, stream);
  else if (lanes == 2)
    launch_lanes<kCalibrate, kBand, 2>(xyz, mask, n, angle, near, far, out, keep, stream);
  else
    launch_masked_read<kCalibrate, kBand>(xyz, mask, n, angle, near, far, out, keep, stream);
}

bool aligned(const void* ptr, int bytes) { return reinterpret_cast<uintptr_t>(ptr) % bytes == 0; }

enum Variant { kSincos = 0, kFmaf = 1 };

template <int V>
__device__ __forceinline__ float vfma(float a, float b, float c) {
  if constexpr (V == kFmaf) return __fmaf_rn(a, b, c);
  else return lvs::fma64(a, b, c);
}

template <int V>
__device__ __forceinline__ void calibrate_variant(const float (&p)[3], float angle, float (&out)[3]) {
  float den = fmaxf(sqrtf(vfma<V>(p[0], p[0], __fmul_rn(p[1], p[1]))), 1e-12f);
  float x = __fmul_rn(__fdiv_rn(p[1], den), angle), y = __fmul_rn(__fdiv_rn(-p[0], den), angle);
  float tsq = vfma<V>(y, y, __fmul_rn(x, x));
  float a = 1.0f, b = 0.5f;
  if (!(tsq < 1e-8f)) {
    float t = sqrtf(tsq), s, c;
    if constexpr (V == kSincos) {
      sincosf(t, &s, &c);
    } else {
      s = sinf(t);
      c = cosf(t);
    }
    a = __fdiv_rn(s, t);
    b = __fdiv_rn(__fsub_rn(1.0f, c), tsq);
  }
  float rot[3][3];
  if constexpr (V == kFmaf) {
    const float xy = __fmul_rn(x, y), ax = __fmul_rn(a, x), ay = __fmul_rn(a, y), bxy = __fmul_rn(b, xy);
    const float r[3][3] = {{vfma<V>(b, __fmul_rn(y, -y), 1.0f), bxy, ay},
                           {bxy, vfma<V>(b, __fmul_rn(-x, x), 1.0f), -ax},
                           {-ay, ax, vfma<V>(b, vfma<V>(x, -x, __fmul_rn(-y, y)), 1.0f)}};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) rot[i][j] = r[i][j];
  } else {
    rotation(x, y, a, b, rot);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) out[r] = vfma<V>(rot[r][2], p[2], vfma<V>(rot[r][1], p[1], __fmul_rn(rot[r][0], p[0])));
}

template <int V>
__global__ void __launch_bounds__(lvs::kThreads)
front_variant(const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float angle,
              float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float p[3] = {xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2]};
  float q[3] = {lvs::kSentinel, lvs::kSentinel, lvs::kSentinel};
  if (mask[i]) calibrate_variant<V>(p, angle, q);
#pragma unroll
  for (int r = 0; r < 3; ++r) out[3 * i + r] = q[r];
}

}  // namespace

// the calibration of n lanes by `angle` (radians) as variant `variant` (0:
// sincosf, 1: fmaf)
extern "C" int variant_calibration(const float* xyz, const bool* mask, int n, float angle, int variant, float* out,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  if (variant == kSincos)
    front_variant<kSincos><<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(xyz, mask, n, angle, out);
  else
    front_variant<kFmaf><<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(xyz, mask, n, angle, out);
  LVS_RETURN_LAST_ERROR();
}

// `lvs_prefilter_front`'s forms at `lanes` (2 or 4) lanes a thread, or with
// lanes = 1 at one lane a thread reading a point only where its mask is
// set; xyz and out aligned to 4 * lanes bytes, mask and keep to lanes bytes
extern "C" int variant_front(const float* xyz, const bool* mask, int n, int calibrate, float angle, int band,
                             float near, float far, int lanes, float* out, bool* keep, cudaStream_t stream) {
  if ((lanes != 1 && lanes != 2 && lanes != 4) || !(calibrate || band) || (band && keep == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(xyz, 4 * lanes) || !aligned(out, 4 * lanes) || !aligned(mask, lanes) ||
      (band && !aligned(keep, lanes)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n > 0) {
    if (calibrate && band)
      launch_lanes<true, true>(xyz, mask, n, angle, near, far, lanes, out, keep, stream);
    else if (calibrate)
      launch_lanes<true, false>(xyz, mask, n, angle, near, far, lanes, out, keep, stream);
    else
      launch_lanes<false, true>(xyz, mask, n, angle, near, far, lanes, out, keep, stream);
  }
  LVS_RETURN_LAST_ERROR();
}
