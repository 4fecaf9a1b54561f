// Kernels 19a and 19b: GICP's plane-regularized covariances and its normal
// equations.
//
// Replaces: lv_slam_tpu/ops/gicp.py:31 `_plane_covariances` (with the
// target covariance computed inline in `gicp_align`'s body, :71-83) (19a),
// and the normal equations of :48 `gicp_align` (:86-99) (19b).
//
// What bounds it on the card: 19a reads the mask of every lane, and the 8
// valid flags and the valid neighbours (12 bytes each) of a masked-in lane,
// and writes a 3x3 and a flag (37 bytes) per lane, with ~600 operations per
// masked-in lane (the sums and the closed-form eigh), so HBM, not
// arithmetic. 19b reads the ok flag of every lane, the match's flag and
// distance where it is ok, and the source point, its match and two 3x3
// covariances (96 bytes) of each matched lane, with ~350 operations per
// matched lane; its 42 block partials are a few hundred KB.
//
// 19a design (`plane_cov`): one thread per lane, from K9k's k neighbours and
// their valid flags: the count, the mean and the covariance, each sum over
// the neighbours in order; K4's `eigh3x3` of cov + 1e-9 I; the regularized
// V diag(1e-3, 1, 1) V^T. With a mask it also writes ok = mask & count >= 3
// and the identity where not ok (a masked-out lane reads no neighbour:
// the source's covariances); without one it
// writes the regularized matrix on every lane (the target's, as the
// reference's body does).
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

__global__ void __launch_bounds__(lvs::kThreads)
plane_cov(const float* __restrict__ pts, const bool* __restrict__ valid, int n, int k,
          const bool* __restrict__ mask, float* __restrict__ cov_out, bool* __restrict__ ok_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float* out = cov_out + 9 * static_cast<long long>(i);
  if (mask != nullptr && !mask[i]) {  // not ok: the identity, no neighbour read
    ok_out[i] = false;
    for (int a = 0; a < 9; ++a) out[a] = a % 4 == 0 ? 1.0f : 0.0f;
    return;
  }
  float w[kMaxK];
  float wsum = 0.0f;
  for (int j = 0; j < k; ++j) {
    w[j] = valid[static_cast<long long>(i) * k + j] ? 1.0f : 0.0f;
    wsum += w[j];
  }
  float cnt = fmaxf(wsum, 1.0f);
  const float* p = pts + static_cast<long long>(i) * k * 3;
  float mu[3];
  for (int r = 0; r < 3; ++r) {
    float s = 0.0f;
    for (int j = 0; j < k; ++j) s += p[3 * j + r] * w[j];
    mu[r] = s / cnt;
  }
  float c[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      float s = 0.0f;
      for (int j = 0; j < k; ++j) s += ((p[3 * j + a] - mu[a]) * w[j]) * ((p[3 * j + b] - mu[b]) * w[j]);
      c[a][b] = s / cnt;
    }
  float ev[3];
  lvs::Vec3 v[3];
  // cov + 1e-9 I, every entry added to, as the reference adds the whole matrix
  lvs::eigh3x3(c[0][0] + 1e-9f, c[0][1] + 0.0f, c[0][2] + 0.0f, c[1][1] + 1e-9f, c[1][2] + 0.0f, c[2][2] + 1e-9f,
               ev, v);
  const float g[3] = {1e-3f, 1.0f, 1.0f};  // the reference's gicp_epsilon
  float vm[3][3] = {{v[0].x, v[1].x, v[2].x}, {v[0].y, v[1].y, v[2].y}, {v[0].z, v[1].z, v[2].z}};  // columns
  bool ok = true;
  if (mask != nullptr) {
    ok = mask[i] && wsum >= 3.0f;
    ok_out[i] = ok;
  }
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      float s = ((vm[a][0] * g[0]) * vm[b][0] + (vm[a][1] * g[1]) * vm[b][1]) + (vm[a][2] * g[2]) * vm[b][2];
      out[3 * a + b] = ok ? s : (a == b ? 1.0f : 0.0f);
    }
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
  if (i < n && src_ok[i] && nn_valid[i] && nn_dist[i] < max_dist) {
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

extern "C" int lvs_plane_cov(const float* pts, const bool* valid, int n, int k, const bool* mask, float* cov,
                             bool* ok, cudaStream_t stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) plane_cov<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(pts, valid, n, k, mask, cov, ok);
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
