// Kernel 15: the pose graph's SE3-edge normal equations.
//
// Replaces: lv_slam_tpu/graph/pose_graph.py:240 `_chi2_and_normal` for the
// SE3 edges (odometry and loops), with `_edge_res_jac` :152 and
// lv_slam_tpu/graph/factors.py:34 `se3_edge_residual`, :194 `huber_weight`.
//
// What bounds it on the card: nothing large. The bench graph has at most 256
// edges and a dense H of at most 408 x 408 floats (666 KB). Each edge costs
// ~3000 flops and 156 scattered adds; one launch is latency, and the LM's
// Cholesky (a library call) and its host loop cost more.
//
// Design: one thread per edge. It forms delta = Z^-1 Ti^-1 Tj, the residual
// [t, 2 q_xyz] (Shepperd's quaternion: the branch of the largest leading
// term, first on ties, as `jnp.argmax` picks it), chi2 = r^T Omega r and the
// Huber weight and robust chi2. The Jacobian w.r.t. the left perturbations
// exp(xi) T is forward-mode through the same branch, as `jax.jacfwd`
// takes it: the tangent of delta along generator G_k of node j is
// A G_k Tj with A = Z^-1 Ti^-1, and along node i its negative; the
// quaternion's tangent follows the picked candidate through the
// normalisation, with the sign flip held. The 12 x 12 block J^T (w Omega) J
// and the 12-vector J^T (w Omega) r are added into the dense H and b with
// float atomicAdd (the order, hence the last bits, varies from run to run).
// Each edge writes its robust chi2; `chi2_sum` adds them in a fixed order,
// so the trial step's accept test is deterministic. `build = 0` is the
// chi2-only variant of the trial step.
#include "common.cuh"

namespace {

__device__ __forceinline__ void matmul4(const float* a, const float* b, float* c) {
  for (int r = 0; r < 4; ++r)
    for (int col = 0; col < 4; ++col) {
      float s = a[4 * r + 0] * b[0 * 4 + col];
      s += a[4 * r + 1] * b[1 * 4 + col];
      s += a[4 * r + 2] * b[2 * 4 + col];
      s += a[4 * r + 3] * b[3 * 4 + col];
      c[4 * r + col] = s;
    }
}

// rigid inverse [R^T, -R^T t] (core/se3.inverse)
__device__ __forceinline__ void inverse4(const float* t, float* out) {
  for (int r = 0; r < 3; ++r) {
    for (int col = 0; col < 3; ++col) out[4 * r + col] = t[4 * col + r];
    float s = t[4 * 0 + r] * t[3];
    s += t[4 * 1 + r] * t[7];
    s += t[4 * 2 + r] * t[11];
    out[4 * r + 3] = -s;
  }
  out[12] = 0.0f; out[13] = 0.0f; out[14] = 0.0f; out[15] = 1.0f;
}

// Shepperd candidate `best` of rotation m (row-major 3x3 inside a 4x4),
// with `one` = 1 for the value and 0 for a tangent (the candidates are
// affine in m)
__device__ __forceinline__ void quat_candidate(const float* m, int best, float one, float* q) {
  float m00 = m[0], m01 = m[1], m02 = m[2], m10 = m[4], m11 = m[5], m12 = m[6];
  float m20 = m[8], m21 = m[9], m22 = m[10];
  float tr = m00 + m11 + m22;
  if (best == 0) {
    q[0] = one + tr; q[1] = m21 - m12; q[2] = m02 - m20; q[3] = m10 - m01;
  } else if (best == 1) {
    q[0] = m21 - m12; q[1] = one + m00 - m11 - m22; q[2] = m01 + m10; q[3] = m02 + m20;
  } else if (best == 2) {
    q[0] = m02 - m20; q[1] = m01 + m10; q[2] = one - m00 + m11 - m22; q[3] = m12 + m21;
  } else {
    q[0] = m10 - m01; q[1] = m02 + m20; q[2] = m12 + m21; q[3] = one - m00 - m11 + m22;
  }
}

__device__ __forceinline__ int quat_branch(const float* m) {
  float m00 = m[0], m11 = m[5], m22 = m[10];
  float tr = m00 + m11 + m22;
  float mags[4] = {1.0f + tr, 1.0f + m00 - m11 - m22, 1.0f - m00 + m11 - m22, 1.0f - m00 - m11 + m22};
  int best = 0;
  for (int c = 1; c < 4; ++c)
    if (mags[c] > mags[best]) best = c;
  return best;
}

__global__ void se3_edges(const float* __restrict__ poses, const int* __restrict__ e_i,
                          const int* __restrict__ e_j, const float* __restrict__ meas,
                          const float* __restrict__ info, const float* __restrict__ huber,
                          const bool* __restrict__ valid, int n_edges, int n, int build,
                          float* __restrict__ rho_out, float* __restrict__ H, float* __restrict__ b) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_edges) return;
  if (!valid[e]) {
    rho_out[e] = 0.0f;
    return;
  }
  const float* ti = poses + 16 * e_i[e];
  const float* tj = poses + 16 * e_j[e];
  float zinv[16], tiinv[16], a[16], delta[16];
  inverse4(meas + 16 * e, zinv);
  inverse4(ti, tiinv);
  matmul4(zinv, tiinv, a);
  matmul4(a, tj, delta);

  int best = quat_branch(delta);
  float qc[4];
  quat_candidate(delta, best, 1.0f, qc);
  float norm = sqrtf(qc[0] * qc[0] + qc[1] * qc[1] + qc[2] * qc[2] + qc[3] * qc[3]);
  float q[4];
  for (int c = 0; c < 4; ++c) q[c] = qc[c] / norm;
  float sign = q[0] < 0.0f ? -1.0f : 1.0f;
  float r[6] = {delta[3], delta[7], delta[11], 2.0f * (q[1] * sign), 2.0f * (q[2] * sign),
                2.0f * (q[3] * sign)};

  const float* om = info + 36 * e;
  float om_r[6];
  float chi2 = 0.0f;
  for (int i = 0; i < 6; ++i) {
    float s = 0.0f;
    for (int j = 0; j < 6; ++j) s += om[6 * i + j] * r[j];
    om_r[i] = s;
    chi2 += r[i] * s;
  }
  float chi = sqrtf(fmaxf(chi2, 0.0f));
  float hb = huber[e];
  float w = 1.0f, rho = chi2;
  if (hb > 0.0f) {
    w = chi <= hb ? 1.0f : hb / fmaxf(chi, 1e-12f);
    rho = chi <= hb ? chi2 : 2.0f * hb * chi - hb * hb;
  }
  rho_out[e] = rho;
  if (!build) return;

  // J (6 x 12): columns 0-5 node i, 6-11 node j
  float J[6][12];
  for (int k = 0; k < 6; ++k) {
    // M = G_k Tj (rows 0-2; row 3 is zero): translation generators put
    // Tj's last row [0 0 0 1] in row k, rotation generators skew(e_a) Tj
    float M[12];
    for (int c = 0; c < 12; ++c) M[c] = 0.0f;
    if (k < 3) {
      M[4 * k + 3] = 1.0f;
    } else {
      int ax = k - 3;  // skew(e_ax) rows: e_ax x (column) -> rows of Tj
      int r1 = (ax + 1) % 3, r2 = (ax + 2) % 3;
      for (int c = 0; c < 4; ++c) {
        M[4 * r1 + c] = -tj[4 * r2 + c];
        M[4 * r2 + c] = tj[4 * r1 + c];
      }
    }
    float d[12];  // rows 0-2 of A M
    for (int rr = 0; rr < 3; ++rr)
      for (int c = 0; c < 4; ++c) {
        float s = a[4 * rr + 0] * M[0 * 4 + c];
        s += a[4 * rr + 1] * M[1 * 4 + c];
        s += a[4 * rr + 2] * M[2 * 4 + c];
        d[4 * rr + c] = s;
      }
    float dqc[4];
    quat_candidate(d, best, 0.0f, dqc);
    float dot = qc[0] * dqc[0] + qc[1] * dqc[1] + qc[2] * dqc[2] + qc[3] * dqc[3];
    float dn = dot / norm;
    float dr[6] = {d[3], d[7], d[11], 0.0f, 0.0f, 0.0f};
    for (int c = 1; c < 4; ++c) {
      float dq = (dqc[c] * norm - qc[c] * dn) / (norm * norm);
      dr[2 + c] = 2.0f * (dq * sign);
    }
    for (int i = 0; i < 6; ++i) {
      J[i][6 + k] = dr[i];
      J[i][k] = -dr[i];
    }
  }

  int idx[12];
  for (int c = 0; c < 6; ++c) {
    idx[c] = 6 * e_i[e] + c;
    idx[6 + c] = 6 * e_j[e] + c;
  }
  float WJ[6][12];
  for (int i = 0; i < 6; ++i)
    for (int c = 0; c < 12; ++c) {
      float s = 0.0f;
      for (int j = 0; j < 6; ++j) s += (w * om[6 * i + j]) * J[j][c];
      WJ[i][c] = s;
    }
  for (int p = 0; p < 12; ++p) {
    float bs = 0.0f;
    for (int i = 0; i < 6; ++i) bs += J[i][p] * (w * om_r[i]);
    atomicAdd(b + idx[p], bs);
    for (int c = 0; c < 12; ++c) {
      float s = 0.0f;
      for (int i = 0; i < 6; ++i) s += J[i][p] * WJ[i][c];
      atomicAdd(H + static_cast<long long>(idx[p]) * n + idx[c], s);
    }
  }
}

// one block: a fixed-order sum of the edges' robust chi2
__global__ void chi2_sum(const float* __restrict__ rho, int n_edges, float* __restrict__ out) {
  __shared__ float part[lvs::kThreads];
  float s = 0.0f;
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x) s += rho[e];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = part[0];
}

}  // namespace

extern "C" int lvs_pose_graph_edges(const float* poses, const int* e_i, const int* e_j, const float* meas,
                                    const float* info, const float* huber, const bool* valid, int n_edges,
                                    int n, int build, float* rho, float* H, float* b, float* chi2,
                                    cudaStream_t stream) {
  if (n_edges > 0)
    se3_edges<<<lvs::blocks_for(n_edges), lvs::kThreads, 0, stream>>>(
        poses, e_i, e_j, meas, info, huber, valid, n_edges, n, build, rho, H, b);
  chi2_sum<<<1, lvs::kThreads, 0, stream>>>(rho, n_edges, chi2);
  LVS_RETURN_LAST_ERROR();
}
