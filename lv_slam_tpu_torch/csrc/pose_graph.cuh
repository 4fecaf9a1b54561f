// Kernel 15's factor code, shared by the normal equations' cluster
// (`csrc/pose_graph.cu`) and the LM step (`csrc/lm.cu`), which evaluates the
// candidate's chi2 with the same functions: the graph's arrays, the factor
// families' residuals (the SE3 edge's Shepperd quaternion, the dual-number
// residuals of the priors, the SE3-plane and the plane-plane factors), each
// factor's plain or robust chi2 term, and the cluster barrier.
//
// Every function here is the one the earlier one-thread-per-factor kernels
// ran, operation for operation (the build's --fmad=false rounds each product
// on its own), so a factor's chi2 term and Jacobian are the same bits
// whichever thread or lane computes them.
#pragma once

#include "common.cuh"

namespace lvs {

// the graph's arrays (graph/pose_graph.py PoseGraph), filled once per LM
// loop on the host and passed by value (a named namespace: the C entries
// take it, so it must have external linkage)
struct GraphArgs {
  const int* e_i;
  const int* e_j;
  const float* e_meas;
  const float* e_info;
  const float* e_huber;
  const bool* e_valid;
  const int* p_node;
  const int* p_type;
  const float* p_meas;
  const float* p_info;
  const float* p_huber;
  const bool* p_valid;
  const int* sp_i;
  const int* sp_plane;
  const float* sp_meas;
  const float* sp_info;
  const float* sp_huber;
  const bool* sp_valid;
  const int* q_i;
  const int* q_j;
  const int* q_type;
  const float* q_meas;
  const float* q_info;
  const float* q_huber;
  const bool* q_valid;
  const bool* node_valid;
  const bool* node_fixed;
  const bool* plane_valid;
  const bool* plane_fixed;
  int n_e, n_p, n_s, n_q, n_nodes, n_planes;
};

}  // namespace lvs

namespace {

using lvs::GraphArgs;

constexpr int kCluster = 8;  // blocks of the one cluster a launch runs
constexpr int kWarps = lvs::kThreads / 32;

// the loop's scalars (graph/pose_graph.py LMState)
constexpr int F_LAM = 0, F_CHI2 = 1, F_NEW_CHI2 = 2;
constexpr int S_DONE = 0, S_IT = 1, S_OK = 2, S_SMALL = 3;

__host__ __device__ __forceinline__ int n_terms(const GraphArgs& g) { return g.n_e + g.n_p + g.n_s + g.n_q; }

// a cluster barrier whose arrive releases and whose wait acquires every
// earlier write of the cluster's threads (global memory too)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// floats of one factor's block in the scratch: J^T (w Omega) J (nd x nd,
// row-major), then J^T (w Omega) r (nd)
__host__ __device__ constexpr int block_floats(int nd) { return nd * nd + nd; }

// a / b, IEEE-rounded: a zero over a non-zero, non-NaN b is the signed
// zero the division gives, without the division (whose range check sends a
// zero numerator down its slow path); every other pair is divided
__device__ __forceinline__ float div0(float a, float b) {
  if (a == 0.0f && b != 0.0f && b == b) return __int_as_float((__float_as_int(a) ^ __float_as_int(b)) & 0x80000000);
  return a / b;
}

// a factor slot's staged variables: a | b << 16, kNoVars for an invalid slot
constexpr unsigned kNoVars = 0xffffffffu;
__device__ __forceinline__ int var_a(unsigned vw) { return static_cast<int>(vw & 0xffffu); }
__device__ __forceinline__ int var_b(unsigned vw) { return static_cast<int>(vw >> 16); }

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
  const float mags[4] = {1.0f + tr, 1.0f + m00 - m11 - m22, 1.0f - m00 + m11 - m22, 1.0f - m00 - m11 + m22};
  int best = 0;
  float top = mags[0];  // mags[best], held in a register
#pragma unroll
  for (int c = 1; c < 4; ++c)
    if (mags[c] > top) {
      best = c;
      top = mags[c];
    }
  return best;
}

// ---------------------------------------------------------------- the SE3 edge

// An edge's value: delta = Z^-1 Ti^-1 Tj, its residual [t, 2 q_xyz]
// (Shepperd's quaternion: the branch of the largest leading term, first on
// ties, as `jnp.argmax` picks it), chi2 = r^T Omega r, the Huber weight and
// g2o's robust chi2, with what the Jacobian's columns reuse
struct EdgeValue {
  float a[16];  // Z^-1 Ti^-1
  float qc[4], norm, sign;
  int best;
  float om_r[6];
  float w, rho;
};

__device__ __forceinline__ void edge_value(const GraphArgs& g, const float* __restrict__ ti,
                                           const float* __restrict__ tj, int e, EdgeValue& v) {
  float zinv[16], tiinv[16], delta[16];
  inverse4(g.e_meas + 16 * e, zinv);
  inverse4(ti, tiinv);
  matmul4(zinv, tiinv, v.a);
  matmul4(v.a, tj, delta);

  v.best = quat_branch(delta);
  quat_candidate(delta, v.best, 1.0f, v.qc);
  v.norm = sqrtf(v.qc[0] * v.qc[0] + v.qc[1] * v.qc[1] + v.qc[2] * v.qc[2] + v.qc[3] * v.qc[3]);
  float q[4];
  for (int c = 0; c < 4; ++c) q[c] = div0(v.qc[c], v.norm);
  v.sign = q[0] < 0.0f ? -1.0f : 1.0f;
  float r[6] = {delta[3], delta[7], delta[11], 2.0f * (q[1] * v.sign), 2.0f * (q[2] * v.sign),
                2.0f * (q[3] * v.sign)};

  const float* om = g.e_info + 36 * e;
  float chi2 = 0.0f;
  for (int i = 0; i < 6; ++i) {
    float s = 0.0f;
    for (int j = 0; j < 6; ++j) s += om[6 * i + j] * r[j];
    v.om_r[i] = s;
    chi2 += r[i] * s;
  }
  float chi = sqrtf(fmaxf(chi2, 0.0f));
  float hb = g.e_huber[e];
  v.w = 1.0f;
  v.rho = chi2;
  if (hb > 0.0f) {
    v.w = chi <= hb ? 1.0f : hb / fmaxf(chi, 1e-12f);
    v.rho = chi <= hb ? chi2 : 2.0f * hb * chi - hb * hb;
  }
}

// column k of the residual's Jacobian along node j's left perturbation
// exp(xi) Tj (node i's is its negative): forward mode through the value's
// Shepperd branch, as `jax.jacfwd` takes it (the tangent of delta along
// generator G_k of node j is A G_k Tj). Lanes take different k: every
// entry is selected from registers, with no branch on k, so the lanes run
// one path.
__device__ __forceinline__ void edge_column(const EdgeValue& v, const float* __restrict__ tj, int k, float* dr) {
  float t[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) t[c] = tj[c];
  // M = G_k Tj (rows 0-2; row 3 is zero): translation generators put
  // Tj's last row [0 0 0 1] in row k, rotation generators skew(e_a) Tj
  const bool trans = k < 3;
  const int ax = k - 3, r1 = (ax + 1) % 3, r2 = (ax + 2) % 3;  // skew(e_ax): e_ax x (column) -> rows of Tj
  float M[12];
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    const int row = c / 4, col = c % 4;
    const float t_r1 = r1 == 0 ? t[col] : r1 == 1 ? t[4 + col] : t[8 + col];
    const float t_r2 = r2 == 0 ? t[col] : r2 == 1 ? t[4 + col] : t[8 + col];
    const float rot = row == r1 ? -t_r2 : row == r2 ? t_r1 : 0.0f;
    M[c] = trans ? (row == k && col == 3 ? 1.0f : 0.0f) : rot;
  }
  float d[12];  // rows 0-2 of A M
#pragma unroll
  for (int rr = 0; rr < 3; ++rr)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float s = v.a[4 * rr + 0] * M[0 * 4 + c];
      s += v.a[4 * rr + 1] * M[1 * 4 + c];
      s += v.a[4 * rr + 2] * M[2 * 4 + c];
      d[4 * rr + c] = s;
    }
  float dqc[4];
  quat_candidate(d, v.best, 0.0f, dqc);
  float dot = v.qc[0] * dqc[0] + v.qc[1] * dqc[1] + v.qc[2] * dqc[2] + v.qc[3] * dqc[3];
  float dn = div0(dot, v.norm);
  dr[0] = d[3];
  dr[1] = d[7];
  dr[2] = d[11];
#pragma unroll
  for (int c = 1; c < 4; ++c) {
    float dq = div0(dqc[c] * v.norm - v.qc[c] * dn, v.norm * v.norm);
    dr[2 + c] = 2.0f * (dq * v.sign);
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
  float q = div0(a.v, b.v);
  return D{q, div0(a.d - q * b.d, b.v)};
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
// (each tangent entry selected, as in `edge_column`)
__device__ __forceinline__ void pose_dual(const float* t, int dir, D* m) {
  const int ax = dir - 3, r1 = (ax + 1) % 3, r2 = (ax + 2) % 3;
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    const int row = c / 4, col = c % 4;
    float d = 0.0f;
    if (dir >= 0 && dir < 3)
      d = row == dir && col == 3 ? 1.0f : 0.0f;
    else if (dir >= 3 && dir < 6)
      d = row == r1 ? -t[4 * r2 + col] : row == r2 ? t[4 * r1 + col] : 0.0f;
    m[c] = D{t[c], d};
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

// factor f's residual (family 1 priors, 2 SE3-plane, 3 plane-plane; f
// counts within its family, `vw` its staged variables), tangent along
// `dir` (-1: the value)
__device__ __forceinline__ void dual_residual(const GraphArgs& g, const float* __restrict__ poses,
                                              const float* __restrict__ planes, int family, int f, unsigned vw,
                                              int dir, D* r) {
  if (family == 1) {
    prior_residual(poses + 16 * var_a(vw), dir, g.p_type[f], g.p_meas + 8 * f, r);
  } else if (family == 2) {
    se3_plane_residual(poses + 16 * var_a(vw), planes + 4 * var_b(vw), g.sp_meas + 4 * f, dir, r);
  } else {
    plane_edge_residual(planes + 4 * var_a(vw), planes + 4 * var_b(vw), g.q_type[f], g.q_meas + 4 * f, dir, r);
  }
}

// r^T Omega r of an m-dim residual, with Omega r
template <int M>
__device__ __forceinline__ float weighted_chi2(const float* r, const float* om, int om_stride, float* om_r) {
  float chi2 = 0.0f;
  for (int i = 0; i < M; ++i) {
    float s = 0.0f;
    for (int j = 0; j < M; ++j) s += om[om_stride * i + j] * r[j];
    om_r[i] = s;
    chi2 += r[i] * s;
  }
  return chi2;
}

// family f of the global factor slot t (edges, priors, SE3-plane,
// plane-plane, in that order), with t's index inside it
__device__ __forceinline__ int family_of(const GraphArgs& g, int t, int& f) {
  f = t;
  if (f < g.n_e) return 0;
  f -= g.n_e;
  if (f < g.n_p) return 1;
  f -= g.n_p;
  if (f < g.n_s) return 2;
  f -= g.n_s;
  return 3;
}

// Every factor slot's variables into `vars` (n_terms(g) words), by the
// block's threads
__device__ void stage_vars(const GraphArgs& g, unsigned* vars) {
  for (int t = threadIdx.x; t < n_terms(g); t += blockDim.x) {
    int f;
    const int family = family_of(g, t, f);
    bool valid;
    unsigned a, b = 0;
    if (family == 0) {
      valid = g.e_valid[f];
      a = g.e_i[f];
      b = g.e_j[f];
    } else if (family == 1) {
      valid = g.p_valid[f];
      a = g.p_node[f];
    } else if (family == 2) {
      valid = g.sp_valid[f];
      a = g.sp_i[f];
      b = g.sp_plane[f];
    } else {
      valid = g.q_valid[f];
      a = g.q_i[f];
      b = g.q_j[f];
    }
    vars[t] = valid ? (a | b << 16) : kNoVars;
  }
}

// factor slot t's chi2 term (0 for an invalid slot; `vw` its staged
// variables): the SE3 edges' robust chi2, the other factors' plain chi2,
// as the reference sums them
__device__ float factor_rho(const GraphArgs& g, const float* __restrict__ poses, const float* __restrict__ planes,
                            int t, unsigned vw) {
  if (vw == kNoVars) return 0.0f;
  int f;
  const int family = family_of(g, t, f);
  if (family == 0) {
    EdgeValue v;
    edge_value(g, poses + 16 * var_a(vw), poses + 16 * var_b(vw), f, v);
    return v.rho;
  }
  D r[4];
  r[3] = cst(0.0f);  // the SE3-plane residual's 3 entries leave it
  dual_residual(g, poses, planes, family, f, vw, -1, r);
  float rv[4], om_r[4];
  for (int i = 0; i < 4; ++i) rv[i] = r[i].v;
  if (family == 1) return weighted_chi2<4>(rv, g.p_info + 16 * f, 4, om_r);
  if (family == 2) return weighted_chi2<3>(rv, g.sp_info + 9 * f, 3, om_r);
  return weighted_chi2<4>(rv, g.q_info + 16 * f, 4, om_r);
}

// One block (256 threads): the sum of the n chi2 terms in a fixed order
// (thread t adds terms t, t + 256, ... in turn, then the halving tree, its
// last five levels as warp 0's shuffles: the same adds in the same order),
// read past L1 (other blocks of the cluster wrote them); every thread
// returns it
__device__ float ordered_sum(const float* __restrict__ rho, int n) {
  __shared__ float part[lvs::kThreads];
  float s = 0.0f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) s += __ldcg(rho + e);
  part[threadIdx.x] = s;
  __syncthreads();
  for (int half = blockDim.x / 2; half >= 32; half >>= 1) {
    if (threadIdx.x < half) part[threadIdx.x] += part[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x < 32) {
    float v = part[threadIdx.x];
    for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, off);
    if (threadIdx.x == 0) part[0] = v;
  }
  __syncthreads();
  return part[0];
}

}  // namespace
