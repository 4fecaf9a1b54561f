// Kernels 19a and 19b: GICP's plane-regularized covariances and its normal
// equations.
//
// Replaces: lv_slam_tpu/ops/gicp.py:31 `_plane_covariances` (with the
// target covariance computed inline in `gicp_align`'s body, :71-83) (19a),
// and the normal equations of :48 `gicp_align` (:86-99) (19b).
//
// What bounds it on the card: 19a reads the flags that choose its lanes
// (the mask, or K19b's three lane inputs), and the 8 valid flags and the
// neighbours (104 bytes) of a chosen lane, and writes a 3x3 (36 bytes) per
// lane and, with a mask, a flag, with ~600 operations per chosen lane (the
// sums and the closed-form eigh), so HBM, not arithmetic. 19b reads the ok
// flag of every lane, the match's flag and distance where it is ok, and
// the source point, its match and two 3x3 covariances (96 bytes) of each
// matched lane, with ~350 operations per matched lane; its 42 block
// partials are a few hundred KB.
//
// 19a design (`plane_cov<k>`): one thread per lane, from K9k's k neighbours
// and their valid flags, k a template argument (1..8 behind a switch), so
// the weights, the neighbours and the sums stay in registers: the
// neighbours come in as 16-byte loads (six at k = 8), the flags as one
// 8-byte load; then the count, the mean and the covariance, each sum over
// the neighbours in order; K4's `eigh3x3` of cov + 1e-9 I; the regularized
// V diag(1e-3, 1, 1) V^T. The block stages its 256 x 9 results in shared
// memory and writes them as 16-byte stores. Three modes choose the lanes
// that get the matrix; the others get the identity and read no neighbour:
// every lane (the reference's body); with a mask, ok = mask & count >= 3
// (the source's covariances, ok written); with K19b's lane test, need =
// src_ok & nn_valid & nn_dist < max_dist (the target's covariances at the
// matches: K19b reads no other lane of them).
//
// 19b design (`gicp_normal`): one thread per lane moves the source point by
// the transform (XLA's CPU fma chain, as the plain twin's
// `se3.transform_points_fma`), forms M = C_b + R C_a R^T + 1e-6 I, inverts
// it by cofactors, and for the lanes that are ok (source masked in, source
// covariance ok, a match within the correspondence distance) adds J^T W J
// and J^T W d with J = [I, -[y]x] (the exact forward-mode Jacobian of
// exp_se3(delta) T at delta = 0, tangent (rho, phi)) and d = y - nn. The 36 +
// 6 sums go to block partials (warp shuffles, then the warps in order) and
// `gicp_finish` adds the blocks in order: deterministic.
#include "common.cuh"
#include "linalg3.cuh"

namespace {

constexpr int kMaxK = 8;
constexpr int kTerms = 42;  // H (6x6 row-major), then g (6)

// A lane's k neighbours' flags, k bytes from `src`, as the widest loads that
// their alignment allows (one 8-byte load at k = 8)
template <int K>
__device__ __forceinline__ void load_flags(const unsigned char* __restrict__ src, float (&w)[K]) {
  constexpr int kBytes = K % 8 == 0 ? 8 : K % 4 == 0 ? 4 : K % 2 == 0 ? 2 : 1;
#pragma unroll
  for (int c = 0; c < K / kBytes; ++c) {
    unsigned long long word;
    if constexpr (kBytes == 8) word = *reinterpret_cast<const unsigned long long*>(src + 8 * c);
    else if constexpr (kBytes == 4) word = *reinterpret_cast<const unsigned*>(src + 4 * c);
    else if constexpr (kBytes == 2) word = *reinterpret_cast<const unsigned short*>(src + 2 * c);
    else word = src[c];
#pragma unroll
    for (int b = 0; b < kBytes; ++b) w[kBytes * c + b] = (word >> (8 * b)) & 0xffu ? 1.0f : 0.0f;
  }
}

// A lane's k neighbours (3k floats from `src`), as 16-byte loads where 3k
// is a multiple of 4 (six at k = 8), else 8- or 4-byte ones
template <int K>
__device__ __forceinline__ void load_points(const float* __restrict__ src, float (&p)[3 * K]) {
  constexpr int kWords = (3 * K) % 4 == 0 ? 4 : (3 * K) % 2 == 0 ? 2 : 1;
#pragma unroll
  for (int c = 0; c < 3 * K / kWords; ++c) {
    if constexpr (kWords == 4) {
      float4 f = reinterpret_cast<const float4*>(src)[c];
      p[4 * c] = f.x, p[4 * c + 1] = f.y, p[4 * c + 2] = f.z, p[4 * c + 3] = f.w;
    } else if constexpr (kWords == 2) {
      float2 f = reinterpret_cast<const float2*>(src)[c];
      p[2 * c] = f.x, p[2 * c + 1] = f.y;
    } else {
      p[c] = src[c];
    }
  }
}

enum CovMode { kEvery = 0, kMask = 1, kNeed = 2 };

// K19b's lane test: the lanes whose normal-equation terms `gicp_normal` sums,
// and so the lanes of the target's covariances that it reads (`plane_cov`'s
// kNeed mode); `ops/gicp.LaneTest.lanes` is its plain form
__device__ __forceinline__ bool lane_needed(const bool* __restrict__ src_ok, const bool* __restrict__ nn_valid,
                                            const float* __restrict__ nn_dist, float max_dist, long long i) {
  return src_ok[i] && nn_valid[i] && nn_dist[i] < max_dist;
}

// mode kEvery: the regularized matrix on every lane (the reference's body).
// kMask: ok = mask & count >= 3, the matrix where ok, else the identity.
// kNeed: need = src_ok & nn_valid & nn_dist < max_dist (K19b's lane test),
// the matrix where needed (no count test), else the identity. A lane that
// gets the identity reads no neighbour. The block's 256 x 9 results are
// staged in shared memory and written as 16-byte stores.
template <int K>
__global__ void __launch_bounds__(lvs::kThreads)
plane_cov(const float* __restrict__ pts, const bool* __restrict__ valid, int n, int mode,
          const bool* __restrict__ mask, const bool* __restrict__ src_ok, const bool* __restrict__ nn_valid,
          const float* __restrict__ nn_dist, float max_dist, float* __restrict__ cov_out, bool* __restrict__ ok_out) {
  __shared__ float4 stage4[lvs::kThreads * 9 / 4];
  float* stage = reinterpret_cast<float*>(stage4);
  const long long base = static_cast<long long>(blockIdx.x) * lvs::kThreads;
  const long long i = base + threadIdx.x;
  float out[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  if (i < n) {
    bool live = true;
    if (mode == kMask) live = mask[i];
    else if (mode == kNeed) live = lane_needed(src_ok, nn_valid, nn_dist, max_dist, i);
    bool ok = false;
    if (live) {
      float w[K], p[3 * K];
      load_flags<K>(reinterpret_cast<const unsigned char*>(valid) + K * i, w);
      float wsum = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) wsum += w[j];
      ok = mode != kMask || wsum >= 3.0f;
      if (ok) {
        load_points<K>(pts + 3 * K * i, p);
        float cnt = fmaxf(wsum, 1.0f);
        float mu[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          float s = 0.0f;
#pragma unroll
          for (int j = 0; j < K; ++j) s += p[3 * j + r] * w[j];
          mu[r] = s / cnt;
        }
        float c[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = a; b < 3; ++b) {
            float s = 0.0f;
#pragma unroll
            for (int j = 0; j < K; ++j) s += ((p[3 * j + a] - mu[a]) * w[j]) * ((p[3 * j + b] - mu[b]) * w[j]);
            c[a][b] = s / cnt;
          }
        float ev[3];
        lvs::Vec3 v[3];
        // cov + 1e-9 I, every entry added to, as the reference adds the whole matrix
        lvs::eigh3x3(c[0][0] + 1e-9f, c[0][1] + 0.0f, c[0][2] + 0.0f, c[1][1] + 1e-9f, c[1][2] + 0.0f,
                     c[2][2] + 1e-9f, ev, v);
        const float g[3] = {1e-3f, 1.0f, 1.0f};  // the reference's gicp_epsilon
        const float vm[3][3] = {{v[0].x, v[1].x, v[2].x}, {v[0].y, v[1].y, v[2].y}, {v[0].z, v[1].z, v[2].z}};
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            out[3 * a + b] =
                ((vm[a][0] * g[0]) * vm[b][0] + (vm[a][1] * g[1]) * vm[b][1]) + (vm[a][2] * g[2]) * vm[b][2];
      }
    }
    if (mode == kMask) ok_out[i] = ok;
  }
#pragma unroll
  for (int a = 0; a < 9; ++a) stage[9 * threadIdx.x + a] = out[a];
  __syncthreads();
  const int rows = static_cast<int>(n - base < lvs::kThreads ? n - base : lvs::kThreads);
  float4* dst = reinterpret_cast<float4*>(cov_out + 9 * base);
  for (int q = threadIdx.x; q < 9 * rows / 4; q += lvs::kThreads) dst[q] = stage4[q];
  const int tail = 9 * rows % 4;  // a partial last block: its last floats one by one
  if (static_cast<int>(threadIdx.x) < tail)
    cov_out[9 * base + 9 * rows - tail + threadIdx.x] = stage[9 * rows - tail + threadIdx.x];
}

template <int K>
void launch_plane_cov(const float* pts, const bool* valid, int n, int mode, const bool* mask, const bool* src_ok,
                      const bool* nn_valid, const float* nn_dist, float max_dist, float* cov, bool* ok,
                      cudaStream_t stream) {
  plane_cov<K><<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(pts, valid, n, mode, mask, src_ok, nn_valid,
                                                                 nn_dist, max_dist, cov, ok);
}

__global__ void __launch_bounds__(lvs::kThreads)
gicp_normal(const float* __restrict__ src, const bool* __restrict__ src_ok, const float* __restrict__ cov_a,
            const float* __restrict__ T, const float* __restrict__ nn, const float* __restrict__ nn_dist,
            const bool* __restrict__ nn_valid, const float* __restrict__ cov_b, int n, float max_dist,
            float* __restrict__ partials) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  float acc[kTerms];
#pragma unroll
  for (int m = 0; m < kTerms; ++m) acc[m] = 0.0f;
  if (i < n && lane_needed(src_ok, nn_valid, nn_dist, max_dist, i)) {
    float y[3];
    for (int r = 0; r < 3; ++r)
      y[r] = lvs::fma64(src[3 * i + 2], T[4 * r + 2],
                        lvs::fma64(src[3 * i + 1], T[4 * r + 1], src[3 * i + 0] * T[4 * r + 0])) +
             T[4 * r + 3];
    const float* ca = cov_a + 9 * static_cast<long long>(i);
    const float* cb = cov_b + 9 * static_cast<long long>(i);
    float rc[3][3], m[3][3];
    for (int a = 0; a < 3; ++a)  // R C_a
      for (int b = 0; b < 3; ++b) rc[a][b] = (T[4 * a + 0] * ca[b] + T[4 * a + 1] * ca[3 + b]) + T[4 * a + 2] * ca[6 + b];
    for (int a = 0; a < 3; ++a)  // C_b + (R C_a) R^T + 1e-6 I
      for (int b = 0; b < 3; ++b)
        m[a][b] = (cb[3 * a + b] + ((rc[a][0] * T[4 * b + 0] + rc[a][1] * T[4 * b + 1]) + rc[a][2] * T[4 * b + 2])) +
                  (a == b ? 1e-6f : 0.0f);
    float cof[3][3];  // cofactors: inverse = cof^T / det
    cof[0][0] = m[1][1] * m[2][2] - m[1][2] * m[2][1];
    cof[0][1] = m[1][2] * m[2][0] - m[1][0] * m[2][2];
    cof[0][2] = m[1][0] * m[2][1] - m[1][1] * m[2][0];
    cof[1][0] = m[0][2] * m[2][1] - m[0][1] * m[2][2];
    cof[1][1] = m[0][0] * m[2][2] - m[0][2] * m[2][0];
    cof[1][2] = m[0][1] * m[2][0] - m[0][0] * m[2][1];
    cof[2][0] = m[0][1] * m[1][2] - m[0][2] * m[1][1];
    cof[2][1] = m[0][2] * m[1][0] - m[0][0] * m[1][2];
    cof[2][2] = m[0][0] * m[1][1] - m[0][1] * m[1][0];
    float det = (m[0][0] * cof[0][0] + m[0][1] * cof[0][1]) + m[0][2] * cof[0][2];
    float wm[3][3];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) wm[a][b] = cof[b][a] / det;
    float d[3] = {y[0] - nn[3 * i + 0], y[1] - nn[3 * i + 1], y[2] - nn[3 * i + 2]};
    // J (3x6) = [I, -[y]x]
    float jac[3][6] = {{1.0f, 0.0f, 0.0f, 0.0f, y[2], -y[1]},
                       {0.0f, 1.0f, 0.0f, -y[2], 0.0f, y[0]},
                       {0.0f, 0.0f, 1.0f, y[1], -y[0], 0.0f}};
    float wj[3][6], wd[3];
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 6; ++b) wj[a][b] = (wm[a][0] * jac[0][b] + wm[a][1] * jac[1][b]) + wm[a][2] * jac[2][b];
      wd[a] = (wm[a][0] * d[0] + wm[a][1] * d[1]) + wm[a][2] * d[2];
    }
    for (int a = 0; a < 6; ++a) {
      for (int b = 0; b < 6; ++b) acc[6 * a + b] = (jac[0][a] * wj[0][b] + jac[1][a] * wj[1][b]) + jac[2][a] * wj[2][b];
      acc[36 + a] = (jac[0][a] * wd[0] + jac[1][a] * wd[1]) + jac[2][a] * wd[2];
    }
  }
  lvs::block_sums<kTerms>(acc, partials + kTerms * static_cast<long long>(blockIdx.x));
}

__global__ void gicp_finish(const float* __restrict__ partials, int n_blocks, float* __restrict__ out) {
  if (threadIdx.x < kTerms) out[threadIdx.x] = lvs::column_sum(partials, n_blocks, kTerms, threadIdx.x);
}

}  // namespace

// cov (n, 3, 3) from pts (n, k, 3) and valid (n, k), 1 <= k <= 8; mode as
// `CovMode`: kMask reads mask and writes ok (n); kNeed reads src_ok,
// nn_valid and nn_dist. pts and cov 16-byte aligned, valid 8-byte aligned.
extern "C" int lvs_plane_cov(const float* pts, const bool* valid, int n, int k, int mode, const bool* mask,
                             const bool* src_ok, const bool* nn_valid, const float* nn_dist, float max_dist,
                             float* cov, bool* ok, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || mode < kEvery || mode > kNeed || (mode == kMask && (mask == nullptr || ok == nullptr)) ||
      (mode == kNeed && (src_ok == nullptr || nn_valid == nullptr || nn_dist == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(pts) % 16 || reinterpret_cast<uintptr_t>(cov) % 16 ||
      reinterpret_cast<uintptr_t>(valid) % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n > 0) {
    switch (k) {
#define LVS_PLANE_COV(K) \
  case K:                \
    launch_plane_cov<K>(pts, valid, n, mode, mask, src_ok, nn_valid, nn_dist, max_dist, cov, ok, stream); \
    break;
      LVS_PLANE_COV(1) LVS_PLANE_COV(2) LVS_PLANE_COV(3) LVS_PLANE_COV(4)
      LVS_PLANE_COV(5) LVS_PLANE_COV(6) LVS_PLANE_COV(7) LVS_PLANE_COV(8)
#undef LVS_PLANE_COV
    }
  }
  LVS_RETURN_LAST_ERROR();
}

// out (42) = [H (6x6 row-major), g (6)]; partials (n_blocks * 42) is scratch
extern "C" int lvs_gicp_normal(const float* src, const bool* src_ok, const float* cov_a, const float* T,
                               const float* nn, const float* nn_dist, const bool* nn_valid, const float* cov_b,
                               int n, float max_dist, float* partials, int n_blocks, float* out,
                               cudaStream_t stream) {
  if (n_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  gicp_normal<<<n_blocks, lvs::kThreads, 0, stream>>>(src, src_ok, cov_a, T, nn, nn_dist, nn_valid, cov_b, n,
                                                      max_dist, partials);
  gicp_finish<<<1, 64, 0, stream>>>(partials, n_blocks, out);
  LVS_RETURN_LAST_ERROR();
}
