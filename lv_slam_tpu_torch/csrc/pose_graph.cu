// Kernel 15: the pose graph's normal equations, every factor family.
//
// Replaces: lv_slam_tpu/graph/pose_graph.py:240 `_chi2_and_normal`, with
// `_edge_res_jac` :152, `_prior_res_jac` :167, `_sp_res_jac` :193,
// `_q_res_jac` :209 and lv_slam_tpu/graph/factors.py (the SE3 edge :34, the
// priors :49-93, the plane helpers :110-160, the plane factors :163-210,
// `huber_weight` :213).
//
// What bounds it on the card: nothing large. The bench graph has at most 256
// edges, 256 priors, 64 SE3-plane and 16 plane-plane factors and a dense H of
// at most 408 x 408 floats (666 KB). Each factor costs a few thousand flops
// and writes up to 156 floats; `assemble`'s warps each scan the factor lists
// (one ballot per 32 factors) and add a few blocks. The launches
// are latency, and the LM's Cholesky (a library call) costs more.
//
// Design: one thread per factor, one kernel per family. An edge thread forms
// delta = Z^-1 Ti^-1 Tj, the residual [t, 2 q_xyz] (Shepperd's quaternion:
// the branch of the largest leading term, first on ties, as `jnp.argmax`
// picks it), chi2 = r^T Omega r, the Huber weight and g2o's robust chi2; its
// Jacobian w.r.t. the left perturbations exp(xi) T is forward-mode through
// the same branch, as `jax.jacfwd` takes it (the tangent of delta along
// generator G_k of node j is A G_k Tj with A = Z^-1 Ti^-1, along node i its
// negative). The prior, SE3-plane and plane-plane threads evaluate the
// reference's residual once per tangent direction in dual numbers (value,
// derivative): the pose's tangent along direction k is G_k T, a plane's is
// that of `plane_oplus` at delta = e_k. Every sign choice (the quaternion
// hemisphere, the plane alignments, the Shepperd branch) is taken on the
// value and held for the derivative, as `jacfwd` holds a `jnp.where`'s
// predicate; the prior types are selected per factor (the reference computes
// all five and keeps one). Like the reference, these factors add their plain
// chi2 (not the robust one) while taking Huber weights. Each factor writes
// its block J^T (w Omega) J and vector J^T (w Omega) r to its own slot of a
// scratch buffer; `assemble` then adds them into the dense H and b with one
// warp per variable (node or plane), which owns that variable's rows: it
// finds the factors on the variable with a ballot over 32 factors at a time
// and adds their blocks in factor order, each entry by one lane (the
// diagonal block and b in registers, written once at the end). Every sum
// thus has a fixed order and H and b are the same bits on every run (float
// atomicAdd would vary their last bits run to run, and the LM's accept tests
// carry that to the poses). Each factor writes its chi2 term to its own
// slot; `chi2_sum` adds all slots in a fixed order, so the trial step's
// accept test is deterministic too. `build = 0` is the chi2-only
// variant of the trial step (no blocks, no `assemble`).
// Inside the device-side LM loop (csrc/lm.cu) every launch takes the loop's
// `done` flag (null outside it) and returns at once when it is set.
#include "common.cuh"

namespace {

// floats of one factor's block in the scratch: J^T (w Omega) J (nd x nd,
// row-major), then J^T (w Omega) r (nd)
__host__ __device__ constexpr int block_floats(int nd) { return nd * nd + nd; }

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
                          const bool* __restrict__ valid, int n_edges, int build, float* __restrict__ rho_out,
                          float* __restrict__ blk, const int* __restrict__ done) {
  if (done != nullptr && *done) return;  // the LM loop's gate
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

  float WJ[6][12];
  for (int i = 0; i < 6; ++i)
    for (int c = 0; c < 12; ++c) {
      float s = 0.0f;
      for (int j = 0; j < 6; ++j) s += (w * om[6 * i + j]) * J[j][c];
      WJ[i][c] = s;
    }
  float* out = blk + static_cast<long long>(e) * block_floats(12);
  for (int p = 0; p < 12; ++p) {
    float bs = 0.0f;
    for (int i = 0; i < 6; ++i) bs += J[i][p] * (w * om_r[i]);
    out[12 * 12 + p] = bs;
    for (int c = 0; c < 12; ++c) {
      float s = 0.0f;
      for (int i = 0; i < 6; ++i) s += J[i][p] * WJ[i][c];
      out[12 * p + c] = s;
    }
  }
}


// ---------------------------------------------------------------- dual numbers
// (value, derivative along one tangent direction): forward mode, one pass per
// direction

struct D {
  float v, d;
};

__device__ __forceinline__ D cst(float v) { return D{v, 0.0f}; }
__device__ __forceinline__ D operator+(D a, D b) { return D{a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ D operator-(D a, D b) { return D{a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ D operator-(D a) { return D{-a.v, -a.d}; }
__device__ __forceinline__ D operator*(D a, D b) { return D{a.v * b.v, a.d * b.v + a.v * b.d}; }
__device__ __forceinline__ D operator*(float s, D a) { return D{s * a.v, s * a.d}; }
__device__ __forceinline__ D operator/(D a, D b) {
  float q = a.v / b.v;
  return D{q, (a.d - q * b.d) / b.v};
}
__device__ __forceinline__ D dsqrt(D a) {
  float s = sqrtf(a.v);
  return D{s, a.d * (0.5f / s)};
}
// jnp.maximum(x, floor) with a constant floor
__device__ __forceinline__ D dmax(D a, float floor) { return a.v > floor ? a : cst(floor); }

__device__ __forceinline__ D dot3(const D* a, const D* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }
__device__ __forceinline__ D norm3(const D* a) { return dsqrt(dot3(a, a)); }
__device__ __forceinline__ void cross3(const D* a, const D* b, D* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}
__device__ __forceinline__ float sign_of(float x) { return x < 0.0f ? -1.0f : 1.0f; }

// rows 0-2 of a pose (12 entries) as duals: value T, tangent G_dir T along
// se(3) direction `dir` (0-2 translation, 3-5 rotation; -1: none)
__device__ __forceinline__ void pose_dual(const float* t, int dir, D* m) {
  for (int c = 0; c < 12; ++c) m[c] = cst(t[c]);
  if (dir >= 0 && dir < 3) {
    m[4 * dir + 3].d = 1.0f;
  } else if (dir >= 3 && dir < 6) {
    int ax = dir - 3, r1 = (ax + 1) % 3, r2 = (ax + 2) % 3;
    for (int c = 0; c < 4; ++c) {
      m[4 * r1 + c].d = -t[4 * r2 + c];
      m[4 * r2 + c].d = t[4 * r1 + c];
    }
  }
}

// core/se3.quat_from_matrix on the 3x3 block of m (row stride 4): Shepperd's
// candidate of the largest leading term (on the values), normalized, w >= 0
__device__ void quat_dual(const D* m, D* q) {
  float mv[12];
  for (int c = 0; c < 12; ++c) mv[c] = m[c].v;
  int best = quat_branch(mv);
  D m00 = m[0], m01 = m[1], m02 = m[2], m10 = m[4], m11 = m[5], m12 = m[6], m20 = m[8], m21 = m[9],
    m22 = m[10];
  D one = cst(1.0f), tr = m00 + m11 + m22;
  if (best == 0) {
    q[0] = one + tr; q[1] = m21 - m12; q[2] = m02 - m20; q[3] = m10 - m01;
  } else if (best == 1) {
    q[0] = m21 - m12; q[1] = one + m00 - m11 - m22; q[2] = m01 + m10; q[3] = m02 + m20;
  } else if (best == 2) {
    q[0] = m02 - m20; q[1] = m01 + m10; q[2] = one - m00 + m11 - m22; q[3] = m12 + m21;
  } else {
    q[0] = m10 - m01; q[1] = m02 + m20; q[2] = m12 + m21; q[3] = one - m00 - m11 + m22;
  }
  D nrm = dsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int c = 0; c < 4; ++c) q[c] = q[c] / nrm;
  float s = sign_of(q[0].v);
  for (int c = 0; c < 4; ++c) q[c] = s * q[c];
}

// factors.plane_normalize
__device__ __forceinline__ void plane_normalize(const D* p, D* out) {
  D nrm = dmax(norm3(p), 1e-9f);
  for (int c = 0; c < 4; ++c) out[c] = p[c] / nrm;
}

// factors.plane_tangent_basis at the unit normal n
__device__ __forceinline__ void tangent_basis(const D* n, D* b1, D* b2) {
  b1[0] = cst(1.0f) - n[0] * n[0];
  b1[1] = cst(0.0f) - n[1] * n[0];
  b1[2] = cst(0.0f) - n[2] * n[0];
  D nrm = dmax(norm3(b1), 1e-9f);
  for (int c = 0; c < 3; ++c) b1[c] = b1[c] / nrm;
  cross3(n, b1, b2);
}

// factors.plane_oplus(p, delta) with delta = e_dir (dir in 0-2; -1: none)
// as the tangent at delta = 0
__device__ void plane_oplus_dual(const float* pf, int dir, D* out) {
  D p0[4], p[4];
  for (int c = 0; c < 4; ++c) p0[c] = cst(pf[c]);
  plane_normalize(p0, p);
  D b1[3], b2[3];
  tangent_basis(p, b1, b2);
  D d0 = D{0.0f, dir == 0 ? 1.0f : 0.0f}, d1 = D{0.0f, dir == 1 ? 1.0f : 0.0f};
  D d2 = D{0.0f, dir == 2 ? 1.0f : 0.0f};
  D nn[3];
  for (int c = 0; c < 3; ++c) nn[c] = p[c] + d0 * b1[c] + d1 * b2[c];
  D nrm = dmax(norm3(nn), 1e-9f);
  for (int c = 0; c < 3; ++c) out[c] = nn[c] / nrm;
  out[3] = p[3] + d2;
}

// the weighted chi2 of an m-dim residual, the Huber weight, and the factor's
// block J^T (w Omega) J, J^T (w Omega) r (nd dofs) written to `out`
template <int M, int ND>
__device__ void accumulate(const float* r, float J[M][ND], const float* om, int om_stride, float hb, int build,
                           float* rho_out, float* out) {
  float om_r[M];
  float chi2 = 0.0f;
  for (int i = 0; i < M; ++i) {
    float s = 0.0f;
    for (int j = 0; j < M; ++j) s += om[om_stride * i + j] * r[j];
    om_r[i] = s;
    chi2 += r[i] * s;
  }
  *rho_out = chi2;  // the plain chi2, as the reference sums it for these factors
  if (!build) return;
  float chi = sqrtf(fmaxf(chi2, 0.0f));
  float w = (hb > 0.0f && chi > hb) ? hb / fmaxf(chi, 1e-12f) : 1.0f;
  float WJ[M][ND];
  for (int i = 0; i < M; ++i)
    for (int c = 0; c < ND; ++c) {
      float s = 0.0f;
      for (int j = 0; j < M; ++j) s += (w * om[om_stride * i + j]) * J[j][c];
      WJ[i][c] = s;
    }
  for (int p = 0; p < ND; ++p) {
    float bs = 0.0f;
    for (int i = 0; i < M; ++i) bs += J[i][p] * (w * om_r[i]);
    out[ND * ND + p] = bs;
    for (int c = 0; c < ND; ++c) {
      float s = 0.0f;
      for (int i = 0; i < M; ++i) s += J[i][p] * WJ[i][c];
      out[ND * p + c] = s;
    }
  }
}

// the unary prior of type `type` at pose t, tangent along `dir`, padded to 4
__device__ void prior_residual(const float* t, int dir, int type, const float* m, D* r) {
  D T[12];
  pose_dual(t, dir, T);
  r[3] = cst(0.0f);
  if (type == 0 || type == 1) {  // PRIOR_XYZ, PRIOR_XY
    r[0] = T[3] - cst(m[0]);
    r[1] = T[7] - cst(m[1]);
    r[2] = type == 0 ? T[11] - cst(m[2]) : cst(0.0f);
  } else if (type == 2) {  // PRIOR_QUAT: 2 (q_i^-1 q_meas).xyz, hemisphere of w
    D q[4];
    quat_dual(T, q);
    D w1 = q[0], v1[3] = {-q[1], -q[2], -q[3]};
    D w2 = cst(m[0]), v2[3] = {cst(m[1]), cst(m[2]), cst(m[3])};
    D w = w1 * w2 - dot3(v1, v2);
    D cr[3];
    cross3(v1, v2, cr);
    float s = sign_of(w.v);
    for (int c = 0; c < 3; ++c) r[c] = 2.0f * (s * (w1 * v2[c] + w2 * v1[c] + cr[c]));
  } else if (type == 3) {  // PRIOR_VEC: R^T v_world - v_local
    for (int i = 0; i < 3; ++i)
      r[i] = T[i] * cst(m[0]) + T[4 + i] * cst(m[1]) + T[8 + i] * cst(m[2]) - cst(m[3 + i]);
  } else {  // PRIOR_PLANE: z = 0 in the sensor frame vs the measured plane
    D nm[3] = {cst(m[0]), cst(m[1]), cst(m[2])};
    D nrm = dmax(norm3(nm), 1e-9f);
    for (int c = 0; c < 3; ++c) nm[c] = nm[c] / nrm;
    D nl[3] = {T[8], T[9], T[10]};
    float s = sign_of(dot3(nl, nm).v);
    for (int c = 0; c < 3; ++c) r[c] = nl[c] - s * nm[c];
    r[3] = T[11] - cst(s * m[3]);
  }
}

__global__ void priors(const float* __restrict__ poses, const int* __restrict__ node, const int* __restrict__ type,
                       const float* __restrict__ meas, const float* __restrict__ info,
                       const float* __restrict__ huber, const bool* __restrict__ valid, int n_priors, int build,
                       float* __restrict__ rho_out, float* __restrict__ blk, const int* __restrict__ done) {
  if (done != nullptr && *done) return;
  int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n_priors) return;
  if (!valid[f]) {
    rho_out[f] = 0.0f;
    return;
  }
  const float* t = poses + 16 * node[f];
  D r[4];
  float rv[4], J[4][6];
  prior_residual(t, -1, type[f], meas + 8 * f, r);
  for (int i = 0; i < 4; ++i) rv[i] = r[i].v;
  if (build)
    for (int k = 0; k < 6; ++k) {
      prior_residual(t, k, type[f], meas + 8 * f, r);
      for (int i = 0; i < 4; ++i) J[i][k] = r[i].d;
    }
  accumulate<4, 6>(rv, J, info + 16 * f, 4, huber[f], build, rho_out + f,
                   blk + static_cast<long long>(f) * block_floats(6));
}

// EdgeSE3Plane: plane_ominus(plane_transform(T, plane), meas), tangent along
// `dir` (0-5 the pose, 6-8 the plane)
__device__ void se3_plane_residual(const float* t, const float* plane, const float* m, int dir, D* r) {
  D T[12], pl[4];
  pose_dual(t, dir < 6 ? dir : -1, T);
  plane_oplus_dual(plane, dir >= 6 ? dir - 6 : -1, pl);
  D loc[4];  // plane_transform: n_local = R^T n, d_local = d + n . t
  for (int i = 0; i < 3; ++i) loc[i] = T[i] * pl[0] + T[4 + i] * pl[1] + T[8 + i] * pl[2];
  loc[3] = pl[3] + (pl[0] * T[3] + pl[1] * T[7] + pl[2] * T[11]);
  D a[4], bm[4], mm[4];
  plane_normalize(loc, a);
  for (int c = 0; c < 4; ++c) mm[c] = cst(m[c]);
  plane_normalize(mm, bm);
  D b1[3], b2[3];
  tangent_basis(a, b1, b2);
  r[0] = dot3(bm, b1);
  r[1] = dot3(bm, b2);
  r[2] = a[3] - bm[3];
}

__global__ void se3_planes(const float* __restrict__ poses, const float* __restrict__ planes,
                           const int* __restrict__ sp_i, const int* __restrict__ sp_plane,
                           const float* __restrict__ meas, const float* __restrict__ info,
                           const float* __restrict__ huber, const bool* __restrict__ valid, int n_sp, int build,
                           float* __restrict__ rho_out, float* __restrict__ blk, const int* __restrict__ done) {
  if (done != nullptr && *done) return;
  int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n_sp) return;
  if (!valid[f]) {
    rho_out[f] = 0.0f;
    return;
  }
  const float* t = poses + 16 * sp_i[f];
  const float* pl = planes + 4 * sp_plane[f];
  D r[3];
  float rv[3], J[3][9];
  se3_plane_residual(t, pl, meas + 4 * f, -1, r);
  for (int i = 0; i < 3; ++i) rv[i] = r[i].v;
  if (build)
    for (int k = 0; k < 9; ++k) {
      se3_plane_residual(t, pl, meas + 4 * f, k, r);
      for (int i = 0; i < 3; ++i) J[i][k] = r[i].d;
    }
  accumulate<3, 9>(rv, J, info + 9 * f, 3, huber[f], build, rho_out + f,
                   blk + static_cast<long long>(f) * block_floats(9));
}

// the typed plane-plane / plane-prior residual, tangent along `dir` (0-2
// plane i, 3-5 plane j), padded to 4
__device__ void plane_edge_residual(const float* p1, const float* p2, int type, const float* m, int dir, D* r) {
  D a0[4], b0[4], a[4], bb[4];
  plane_oplus_dual(p1, dir < 3 ? dir : -1, a0);
  plane_oplus_dual(p2, dir >= 3 ? dir - 3 : -1, b0);
  plane_normalize(a0, a);
  plane_normalize(b0, bb);
  for (int c = 0; c < 4; ++c) r[c] = cst(0.0f);
  if (type == 0) {  // PLANE_IDENTITY: (b - a) - meas, b aligned to a over all four
    float s = sign_of((dot3(a, bb) + a[3] * bb[3]).v);
    for (int c = 0; c < 4; ++c) r[c] = (s * bb[c] - a[c]) - cst(m[c]);
  } else if (type == 1) {  // PLANE_PARALLEL
    float s = sign_of(dot3(a, bb).v);
    for (int c = 0; c < 3; ++c) r[c] = (s * bb[c] - a[c]) - cst(m[c]);
  } else if (type == 2) {  // PLANE_PERPENDICULAR
    r[0] = dot3(a, bb);
  } else if (type == 3) {  // PLANE_PRIOR_NORMAL
    D mm[3] = {cst(m[0]), cst(m[1]), cst(m[2])};
    float s = sign_of(dot3(a, mm).v);
    for (int c = 0; c < 3; ++c) r[c] = s * a[c] - mm[c];
  } else {  // PLANE_PRIOR_DISTANCE
    r[0] = cst(m[0]) - a[3];
  }
}

__global__ void plane_edges(const float* __restrict__ planes, const int* __restrict__ q_i,
                            const int* __restrict__ q_j, const int* __restrict__ type,
                            const float* __restrict__ meas, const float* __restrict__ info,
                            const float* __restrict__ huber, const bool* __restrict__ valid, int n_q, int build,
                            float* __restrict__ rho_out, float* __restrict__ blk, const int* __restrict__ done) {
  if (done != nullptr && *done) return;
  int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= n_q) return;
  if (!valid[f]) {
    rho_out[f] = 0.0f;
    return;
  }
  const float* p1 = planes + 4 * q_i[f];
  const float* p2 = planes + 4 * q_j[f];
  D r[4];
  float rv[4], J[4][6];
  plane_edge_residual(p1, p2, type[f], meas + 4 * f, -1, r);
  for (int i = 0; i < 4; ++i) rv[i] = r[i].v;
  if (build)
    for (int k = 0; k < 6; ++k) {
      plane_edge_residual(p1, p2, type[f], meas + 4 * f, k, r);
      for (int i = 0; i < 4; ++i) J[i][k] = r[i].d;
    }
  accumulate<4, 6>(rv, J, info + 16 * f, 4, huber[f], build, rho_out + f,
                   blk + static_cast<long long>(f) * block_floats(6));
}

// one block: a fixed-order sum of the factors' chi2 terms
__global__ void chi2_sum(const float* __restrict__ rho, int n_edges, float* __restrict__ out,
                         const int* __restrict__ done) {
  if (done != nullptr && *done) return;  // uniform over the block
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

// ---------------------------------------------------------------- assembly

// one factor family's arrays for `assemble`: each factor's variables a and b
// (b absent in a unary family) and its blocks
struct Family {
  const int* va;
  const int* vb;
  const bool* valid;
  const float* blk;
  int n_f;
};

// the first dof of a node (6 v) or a plane (6 K + 3 v) in the state
__device__ __forceinline__ int dof_of(bool node, int v, int n_nodes) { return node ? 6 * v : 6 * n_nodes + 3 * v; }

// One warp adds the blocks of `fam`'s factors that touch variable u (a node
// when u_node, else a plane) to u's rows: the factors in slot order, within
// a factor its variable pairs in order. Entry e of a du x d2 block belongs
// to lane e % 32 (slot e / 32 of two: du x d2 <= 36), so every entry of H
// and b is added by one lane, in that order. The diagonal block (u, u) and
// b's rows add into the registers h0, h1 and hb, the other blocks into H.
// A and B are whether slots a and b are nodes; NB is b's dofs (0: unary).
template <bool A, bool B, int NB>
__device__ void gather(const Family fam, int u, bool u_node, int n_nodes, int n, float* __restrict__ H, int lane,
                       float& h0, float& h1, float& hb) {
  constexpr int NA = A ? 6 : 3, ND = NA + NB, SLOTS = NB > 0 ? 2 : 1;
  if (u_node ? !(A || (NB > 0 && B)) : (A && (NB == 0 || B))) return;  // no variable of u's kind
  const int du = u_node ? 6 : 3, row0 = dof_of(u_node, u, n_nodes);
  for (int f0 = 0; f0 < fam.n_f; f0 += 32) {  // uniform over the warp
    const int f = f0 + lane;
    bool hit = false;
    if (f < fam.n_f) {
      const bool valid = fam.valid[f];
      const int a = fam.va[f], vb = NB > 0 ? fam.vb[f] : -1;
      hit = valid && ((A == u_node && a == u) || (NB > 0 && B == u_node && vb == u));
    }
    unsigned m = __ballot_sync(0xffffffffu, hit);
    while (m) {
      const int g = f0 + __ffs(m) - 1;
      m &= m - 1;
      const float* blk = fam.blk + static_cast<long long>(g) * block_floats(ND);
      const int var[2] = {fam.va[g], NB > 0 ? fam.vb[g] : 0};
      for (int s = 0; s < SLOTS; ++s) {
        if ((s == 0 ? A : B) != u_node || var[s] != u) continue;
        const int off = s == 0 ? 0 : NA;
        for (int s2 = 0; s2 < SLOTS; ++s2) {
          const bool node2 = s2 == 0 ? A : B;
          const int d2 = s2 == 0 ? NA : NB, cells = du * d2;
          const float* src = blk + ND * off + (s2 == 0 ? 0 : NA);  // entry (r, c) at src[ND r + c]
          const int e0 = lane, e1 = lane + 32;
          const float v0 = e0 < cells ? src[ND * (e0 / d2) + e0 % d2] : 0.0f;
          const float v1 = e1 < cells ? src[ND * (e1 / d2) + e1 % d2] : 0.0f;
          if (node2 == u_node && var[s2] == u) {
            h0 += v0;
            h1 += v1;
          } else {
            float* dst = H + static_cast<long long>(row0) * n + dof_of(node2, var[s2], n_nodes);
            if (e0 < cells) dst[static_cast<long long>(e0 / d2) * n + e0 % d2] += v0;
            if (e1 < cells) dst[static_cast<long long>(e1 / d2) * n + e1 % d2] += v1;
          }
        }
        if (lane < du) hb += blk[ND * ND + off + lane];
      }
    }
  }
}

// one warp per variable (the nodes, then the planes): H's and b's rows of
// that variable, added in the fixed order of `gather` over the families in
// the order edges, priors, SE3-plane, plane-plane
__global__ void assemble(const Family fe, const Family fp, const Family fs, const Family fq, int n_nodes,
                         int n_planes, int n, float* __restrict__ H, float* __restrict__ b,
                         const int* __restrict__ done) {
  if (done != nullptr && *done) return;
  const int lane = threadIdx.x & 31;
  const int u = static_cast<int>((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5);
  if (u >= n_nodes + n_planes) return;  // uniform over the warp
  const bool u_node = u < n_nodes;
  const int v = u_node ? u : u - n_nodes;
  float h0 = 0.0f, h1 = 0.0f, hb = 0.0f;
  gather<true, true, 6>(fe, v, u_node, n_nodes, n, H, lane, h0, h1, hb);   // SE3 edges: node, node
  gather<true, false, 0>(fp, v, u_node, n_nodes, n, H, lane, h0, h1, hb);  // priors: node
  gather<true, false, 3>(fs, v, u_node, n_nodes, n, H, lane, h0, h1, hb);  // SE3-plane: node, plane
  gather<false, false, 3>(fq, v, u_node, n_nodes, n, H, lane, h0, h1, hb);  // plane-plane: plane, plane
  const int du = u_node ? 6 : 3, row0 = dof_of(u_node, v, n_nodes);
  float* diag = H + static_cast<long long>(row0) * n + row0;
  if (lane < du * du) diag[static_cast<long long>(lane / du) * n + lane % du] += h0;
  if (lane + 32 < du * du) diag[static_cast<long long>((lane + 32) / du) * n + (lane + 32) % du] += h1;
  if (lane < du) b[row0 + lane] += hb;
}

}  // namespace

extern "C" int lvs_pose_graph_edges(const float* poses, const int* e_i, const int* e_j, const float* meas,
                                    const float* info, const float* huber, const bool* valid, int n_edges,
                                    int build, float* rho, float* blk, const int* done, cudaStream_t stream) {
  if (n_edges > 0)
    se3_edges<<<lvs::blocks_for(n_edges), lvs::kThreads, 0, stream>>>(
        poses, e_i, e_j, meas, info, huber, valid, n_edges, build, rho, blk, done);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_pose_graph_priors(const float* poses, const int* node, const int* type, const float* meas,
                                     const float* info, const float* huber, const bool* valid, int n_priors,
                                     int build, float* rho, float* blk, const int* done, cudaStream_t stream) {
  if (n_priors > 0)
    priors<<<lvs::blocks_for(n_priors), lvs::kThreads, 0, stream>>>(
        poses, node, type, meas, info, huber, valid, n_priors, build, rho, blk, done);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_pose_graph_se3_planes(const float* poses, const float* planes, const int* sp_i,
                                         const int* sp_plane, const float* meas, const float* info,
                                         const float* huber, const bool* valid, int n_sp, int build, float* rho,
                                         float* blk, const int* done, cudaStream_t stream) {
  if (n_sp > 0)
    se3_planes<<<lvs::blocks_for(n_sp), lvs::kThreads, 0, stream>>>(
        poses, planes, sp_i, sp_plane, meas, info, huber, valid, n_sp, build, rho, blk, done);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_pose_graph_plane_edges(const float* planes, const int* q_i, const int* q_j, const int* type,
                                          const float* meas, const float* info, const float* huber,
                                          const bool* valid, int n_q, int build, float* rho, float* blk,
                                          const int* done, cudaStream_t stream) {
  if (n_q > 0)
    plane_edges<<<lvs::blocks_for(n_q), lvs::kThreads, 0, stream>>>(
        planes, q_i, q_j, type, meas, info, huber, valid, n_q, build, rho, blk, done);
  LVS_RETURN_LAST_ERROR();
}

// the blocks of the four families (written by the calls above with build)
// added into H and b, which hold zeros or the sums to add to
extern "C" int lvs_pose_graph_assemble(const int* e_i, const int* e_j, const bool* e_valid, const float* e_blk,
                                       int n_edges, const int* p_node, const bool* p_valid, const float* p_blk,
                                       int n_priors, const int* sp_i, const int* sp_plane, const bool* sp_valid,
                                       const float* sp_blk, int n_sp, const int* q_i, const int* q_j,
                                       const bool* q_valid, const float* q_blk, int n_q, int n_nodes, int n_planes,
                                       int n, float* H, float* b, const int* done, cudaStream_t stream) {
  const long long threads = 32LL * (n_nodes + n_planes);
  if (threads > 0)
    assemble<<<lvs::blocks_for(threads), lvs::kThreads, 0, stream>>>(
        Family{e_i, e_j, e_valid, e_blk, n_edges}, Family{p_node, nullptr, p_valid, p_blk, n_priors},
        Family{sp_i, sp_plane, sp_valid, sp_blk, n_sp}, Family{q_i, q_j, q_valid, q_blk, n_q}, n_nodes, n_planes,
        n, H, b, done);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_pose_graph_chi2(const float* rho, int n_terms, float* chi2, const int* done,
                                   cudaStream_t stream) {
  chi2_sum<<<1, lvs::kThreads, 0, stream>>>(rho, n_terms, chi2, done);
  LVS_RETURN_LAST_ERROR();
}
