// Kernel 11: Gauss-Newton on frozen point-to-line / point-to-plane
// correspondences, all iterations in one launch.
//
// Replaces: lv_slam_tpu/lfa/registration.py:156 `gn_solve`.
//
// What bounds it on the card: latency. Each of the 8 iterations reads the
// 12160 residual lanes (~0.5 MB, L2-resident after the first) and does
// ~150 flops per lane, then a 6x6 solve that only one thread can do; the
// serial solve and the block-wide barriers between iterations dominate.
//
// Design: one block of 1024 threads runs every iteration; the transform stays
// in shared memory, so the solve costs no host sync and one launch instead of
// 8 x (reduction + solve + exp) launches. Per iteration each thread builds the
// residuals of its lanes (line: r = |(y - mu) x v|, J = [g, y x g] with
// g = v x (c / r); plane: r = n.y + d, J = [n, y x n]), Huber(0.1)-weights
// them and sums the 21 entries of J^T W J (symmetric here, unlike the NDT
// Hessian) and the 6 of J^T W r; warp shuffles and a fixed-order pass over
// the warps reduce them, deterministically. Thread 0 adds the ridge
// 1e-4 tr(H)/6 + 1e-9, solves by LU with partial pivoting (the elimination of
// the reference's jnp.linalg.solve; first-largest pivot on ties), zeroes a
// non-finite step and applies exp_se3 on the left. Invalid lanes are zeroed
// before any nonlinear op (sentinel points at 1e6 overflow when squared).
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kGnThreads = 1024;
constexpr int kSums = 27;  // H upper triangle (21), then g (6)

struct Sym6 {
  float h[21];
  float g[6];
};

__device__ __forceinline__ int tri(int a, int b) {  // a <= b
  return a * 6 - a * (a - 1) / 2 + (b - a);
}

__device__ __forceinline__ void cross(const float a[3], const float b[3], float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void transform(const float* T, const float p[3], float y[3]) {
  for (int r = 0; r < 3; ++r) y[r] = ((p[0] * T[4 * r + 0] + p[1] * T[4 * r + 1]) + p[2] * T[4 * r + 2]) + T[4 * r + 3];
}

__device__ __forceinline__ void accumulate(float acc[kSums], const float j[6], float w, float r) {
  int t = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) acc[t++] += (j[a] * w) * j[b];
  for (int a = 0; a < 6; ++a) acc[21 + a] += j[a] * (w * r);
}

__device__ __forceinline__ float huber(float r) {
  float ar = fabsf(r);
  return ar > 0.1f ? 0.1f / fmaxf(ar, 1e-9f) : 1.0f;
}

// Solves A x = b (6x6, row-major, overwritten) by LU with partial pivoting.
__device__ void solve6(float A[36], float b[6], float x[6]) {
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    float best = fabsf(A[6 * c + c]);
    for (int r = c + 1; r < 6; ++r) {
      float v = fabsf(A[6 * r + c]);
      if (v > best) { best = v; piv = r; }
    }
    if (piv != c) {
      for (int k = 0; k < 6; ++k) {
        float t = A[6 * c + k]; A[6 * c + k] = A[6 * piv + k]; A[6 * piv + k] = t;
      }
      float t = b[c]; b[c] = b[piv]; b[piv] = t;
    }
    for (int r = c + 1; r < 6; ++r) {
      float l = A[6 * r + c] / A[6 * c + c];
      for (int k = c + 1; k < 6; ++k) A[6 * r + k] -= l * A[6 * c + k];
      b[r] -= l * b[c];
    }
  }
  for (int r = 5; r >= 0; --r) {
    float s = b[r];
    for (int k = r + 1; k < 6; ++k) s -= A[6 * r + k] * x[k];
    x[r] = s / A[6 * r + r];
  }
}

// T <- exp_se3(delta) T, the formula of core/se3.py (Taylor branch below
// theta = 1e-4).
__device__ void apply_exp(const float delta[6], float T[16]) {
  const float* rho = delta;
  const float* phi = delta + 3;
  float tsq = (phi[0] * phi[0] + phi[1] * phi[1]) + phi[2] * phi[2];
  float a, b, c;
  if (tsq < 1e-8f) {
    a = 1.0f - tsq / 6.0f;
    b = 0.5f - tsq / 24.0f;
    c = 1.0f / 6.0f - tsq / 120.0f;
  } else {
    float t = sqrtf(tsq);
    a = sinf(t) / t;
    b = (1.0f - cosf(t)) / tsq;
    c = (t - sinf(t)) / (tsq * t);
  }
  float K[9] = {0.0f, -phi[2], phi[1], phi[2], 0.0f, -phi[0], -phi[1], phi[0], 0.0f};
  float K2[9];
  for (int r = 0; r < 3; ++r)
    for (int q = 0; q < 3; ++q)
      K2[3 * r + q] = (K[3 * r + 0] * K[q] + K[3 * r + 1] * K[3 + q]) + K[3 * r + 2] * K[6 + q];
  float R[9], V[9];
  for (int e = 0; e < 9; ++e) {
    float eye = (e % 4 == 0) ? 1.0f : 0.0f;
    R[e] = (eye + a * K[e]) + b * K2[e];
    V[e] = (eye + b * K[e]) + c * K2[e];
  }
  float E[16];
  for (int r = 0; r < 3; ++r) {
    for (int q = 0; q < 3; ++q) E[4 * r + q] = R[3 * r + q];
    E[4 * r + 3] = (V[3 * r + 0] * rho[0] + V[3 * r + 1] * rho[1]) + V[3 * r + 2] * rho[2];
  }
  E[12] = 0.0f; E[13] = 0.0f; E[14] = 0.0f; E[15] = 1.0f;
  float out[16];
  for (int r = 0; r < 4; ++r)
    for (int q = 0; q < 4; ++q)
      out[4 * r + q] = ((E[4 * r + 0] * T[q] + E[4 * r + 1] * T[4 + q]) + E[4 * r + 2] * T[8 + q]) +
                       E[4 * r + 3] * T[12 + q];
  for (int e = 0; e < 16; ++e) T[e] = out[e];
}

__global__ void __launch_bounds__(kGnThreads)
gn(const float* __restrict__ T0, const float* __restrict__ edges, const float* __restrict__ lmu,
   const float* __restrict__ lv, const bool* __restrict__ lvalid, int ne,
   const float* __restrict__ surfs, const float* __restrict__ pn, const float* __restrict__ pd,
   const bool* __restrict__ pvalid, int ns, int iters, float* __restrict__ T_out) {
  __shared__ float T[16];
  __shared__ float part[kGnThreads / 32][kSums];
  int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < 16) T[tid] = T0[tid];
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    float acc[kSums];
    for (int s = 0; s < kSums; ++s) acc[s] = 0.0f;
    for (int i = tid; i < ne; i += blockDim.x) {
      bool ok = lvalid[i];
      float p[3], mu[3], v[3] = {lv[3 * i + 0], lv[3 * i + 1], lv[3 * i + 2]};
      for (int k = 0; k < 3; ++k) {
        p[k] = ok ? edges[3 * i + k] : 0.0f;
        mu[k] = ok ? lmu[3 * i + k] : 0.0f;
      }
      float y[3], diff[3], c[3], cr[3], g[3], yg[3];
      transform(T, p, y);
      for (int k = 0; k < 3; ++k) diff[k] = y[k] - mu[k];
      cross(diff, v, c);
      float r = sqrtf(((c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]) + 1e-12f);
      for (int k = 0; k < 3; ++k) cr[k] = c[k] / r;
      cross(v, cr, g);
      cross(y, g, yg);
      float j[6] = {g[0], g[1], g[2], yg[0], yg[1], yg[2]};
      accumulate(acc, j, (ok ? 1.0f : 0.0f) * huber(r), r);
    }
    for (int i = tid; i < ns; i += blockDim.x) {
      bool ok = pvalid[i];
      float p[3], n[3] = {pn[3 * i + 0], pn[3 * i + 1], pn[3 * i + 2]};
      for (int k = 0; k < 3; ++k) p[k] = ok ? surfs[3 * i + k] : 0.0f;
      float d = ok ? fminf(fmaxf(pd[i], -1e4f), 1e4f) : 0.0f;
      float y[3], yn[3];
      transform(T, p, y);
      float r = ((y[0] * n[0] + y[1] * n[1]) + y[2] * n[2]) + d;
      cross(y, n, yn);
      float j[6] = {n[0], n[1], n[2], yn[0], yn[1], yn[2]};
      accumulate(acc, j, (ok ? 1.0f : 0.0f) * huber(r), r);
    }
    for (int s = 0; s < kSums; ++s) {
      float v = acc[s];
      for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
      if (lane == 0) part[warp][s] = v;
    }
    __syncthreads();
    if (tid == 0) {
      float sum[kSums];
      for (int s = 0; s < kSums; ++s) {
        float v = 0.0f;
        for (int w = 0; w < kGnThreads / 32; ++w) v += part[w][s];
        sum[s] = v;
      }
      float H[36], b[6], delta[6];
      for (int a = 0; a < 6; ++a)
        for (int q = a; q < 6; ++q) H[6 * a + q] = H[6 * q + a] = sum[tri(a, q)];
      float trace = ((((H[0] + H[7]) + H[14]) + H[21]) + H[28]) + H[35];
      float ridge = 1e-4f * trace / 6.0f + 1e-9f;
      for (int a = 0; a < 6; ++a) {
        H[7 * a] += ridge;
        b[a] = -sum[21 + a];
      }
      solve6(H, b, delta);
      bool finite = true;
      for (int a = 0; a < 6; ++a) finite &= isfinite(delta[a]);
      if (finite) apply_exp(delta, T);
    }
    __syncthreads();
  }
  if (tid < 16) T_out[tid] = T[tid];
}

}  // namespace

extern "C" int lvs_gn_solve(const float* T0, const float* edges, const float* lmu, const float* lv,
                            const bool* lvalid, int ne, const float* surfs, const float* pn,
                            const float* pd, const bool* pvalid, int ns, int iters, float* T_out,
                            cudaStream_t stream) {
  gn<<<1, kGnThreads, 0, stream>>>(T0, edges, lmu, lv, lvalid, ne, surfs, pn, pd, pvalid, ns, iters,
                                   T_out);
  LVS_RETURN_LAST_ERROR();
}
