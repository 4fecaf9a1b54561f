// The Levenberg-Marquardt loop of the pose graph, on the device.
//
// Replaces the body of lv_slam_tpu/graph/pose_graph.py:380
// `optimize_pose_graph`'s `lax.while_loop` (:380-421) around kernel 15
// (`csrc/pose_graph.cu`) and the dense factorization, which stays a library
// call (`torch.linalg.cholesky_ex` + `cholesky_solve`, as the reference leaves
// it to `jax.scipy.linalg.solve`). An iteration is: K15's normal equations
// at the current poses and planes, `lm_damp`, the Cholesky factor and solve,
// `lm_update`, K15's chi2 at the candidate, `lm_accept`. Every launch but the
// two library calls is gated on the loop's `done` flag; the host launches
// iterations in groups with one read of `done` per group
// (`graph/pose_graph.py:optimize_pose_graph`).
//
// Bound on the card: at the flagship graph (64 nodes, 8 planes: n = 408) an
// iteration moves the dense H twice (666 KB: `lm_damp` reads it and writes
// the damped copy) and does a few thousand operations per node in
// `lm_update`: microseconds. What shows is the launches' latency and the
// library factorization (n^3 / 3 operations).
//
// Design: `lm_damp` is elementwise over H and b (one thread per entry): the
// gauge of `_apply_gauge` (node 0, fixed and invalid nodes and planes), the
// damping h + lam * max(diag h, 1e-6) on the diagonal, rhs = -b, and it
// clears H and b for the next build (K15's `assemble` adds into them).
// `lm_update` and `lm_accept` are one block each: `lm_update` tests the solve
// (the factor's info and every entry finite), zeroes a failed step, takes
// max |delta| for the `small` test, and moves each node by exp_se3 of its
// 6 dofs (left-multiplied) and each plane by `plane_oplus`, one thread per
// node or plane; `lm_accept` takes the candidate when its chi2 does not
// exceed the current one, then the lambda schedule, the iteration count and
// the stopping tests (it >= num_iterations, small, relative chi2 change).
// Each is written as the plain twin (`_lm_iteration_ref`) computes it.
#include "common.cuh"
#include "se3.cuh"

namespace {

// the loop's scalars (graph/pose_graph.py LMState)
constexpr int F_LAM = 0, F_CHI2 = 1, F_NEW_CHI2 = 2;
constexpr int S_DONE = 0, S_IT = 1, S_OK = 2, S_SMALL = 3;

// whether dof d is free (`_apply_gauge`'s `freed`)
__device__ __forceinline__ bool freed(int d, int n_nodes, const bool* node_valid, const bool* node_fixed,
                                      const bool* plane_valid, const bool* plane_fixed) {
  if (d < 6 * n_nodes) {
    int i = d / 6;
    return node_valid[i] && !node_fixed[i] && i > 0;
  }
  int q = (d - 6 * n_nodes) / 3;
  return plane_valid[q] && !plane_fixed[q];
}

__global__ void lm_damp(float* __restrict__ H, float* __restrict__ b, const bool* __restrict__ node_valid,
                        const bool* __restrict__ node_fixed, const bool* __restrict__ plane_valid,
                        const bool* __restrict__ plane_fixed, int n_nodes, int n, const float* __restrict__ lmf,
                        const int* __restrict__ lmi, float* __restrict__ damped, float* __restrict__ rhs) {
  if (lmi[S_DONE]) return;
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  if (e < nn) {
    const int i = static_cast<int>(e / n), j = static_cast<int>(e % n);
    const bool fi = freed(i, n_nodes, node_valid, node_fixed, plane_valid, plane_fixed);
    const bool fj = freed(j, n_nodes, node_valid, node_fixed, plane_valid, plane_fixed);
    float v = fi && fj ? H[e] : 0.0f;
    H[e] = 0.0f;
    const float lam = lmf[F_LAM];
    if (i == j) {
      v = v + (fi ? 0.0f : 1.0f);
      const float dg = v < 1e-6f ? 1e-6f : v;  // clamp(min=1e-6), NaN-propagating
      damped[e] = v + lam * dg;
    } else {
      v = v + 0.0f;
      damped[e] = v + lam * 0.0f;
    }
  } else if (e < nn + n) {
    const int i = static_cast<int>(e - nn);
    const float bi = b[i];
    b[i] = 0.0f;
    rhs[i] = -(freed(i, n_nodes, node_valid, node_fixed, plane_valid, plane_fixed) ? bi : 0.0f);
  }
}

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float norm3f(const float* v) {
  float s = v[0] * v[0];
  s += v[1] * v[1];
  s += v[2] * v[2];
  return sqrtf(s);
}

// factors.plane_oplus(p, d): the normal moved in its tangent basis, then the distance
__device__ void plane_oplus(const float* p_in, const float* d, float* out) {
  float p[4];
  const float pn = clamp_min(norm3f(p_in), 1e-9f);
  for (int c = 0; c < 4; ++c) p[c] = p_in[c] / pn;
  float b1[3] = {1.0f - p[0] * p[0], 0.0f - p[1] * p[0], 0.0f - p[2] * p[0]};
  const float bn = clamp_min(norm3f(b1), 1e-9f);
  for (int c = 0; c < 3; ++c) b1[c] = b1[c] / bn;
  const float b2[3] = {p[1] * b1[2] - p[2] * b1[1], p[2] * b1[0] - p[0] * b1[2], p[0] * b1[1] - p[1] * b1[0]};
  float nn[3];
  for (int c = 0; c < 3; ++c) nn[c] = (p[c] + d[0] * b1[c]) + d[1] * b2[c];
  const float nnn = clamp_min(norm3f(nn), 1e-9f);
  for (int c = 0; c < 3; ++c) out[c] = nn[c] / nnn;
  out[3] = p[3] + d[2];
}

// one block: the step's test, the candidate poses and planes
__global__ void lm_update(const float* __restrict__ delta, const int* __restrict__ chol_info,
                          const float* __restrict__ poses, const float* __restrict__ planes,
                          float* __restrict__ cand_poses, float* __restrict__ cand_planes, int n_nodes,
                          int n_planes, int n, int* __restrict__ lmi) {
  if (lmi[S_DONE]) return;
  __shared__ float s_max[lvs::kThreads];
  bool finite = true;
  for (int d = threadIdx.x; d < n; d += blockDim.x) finite = finite && isfinite(delta[d]);
  const bool ok = __syncthreads_and(finite) && *chol_info == 0;
  float m = 0.0f;
  if (ok)
    for (int d = threadIdx.x; d < n; d += blockDim.x) m = fmaxf(m, fabsf(delta[d]));
  s_max[threadIdx.x] = m;
  for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) {
    float xi[6], e[16];
    for (int c = 0; c < 6; ++c) xi[c] = ok ? delta[6 * i + c] : 0.0f;
    lvs::exp_se3(xi, e);
    lvs::matmul44(e, poses + 16 * i, cand_poses + 16 * i);
  }
  for (int q = threadIdx.x; q < n_planes; q += blockDim.x) {
    float d[3];
    for (int c = 0; c < 3; ++c) d[c] = ok ? delta[6 * n_nodes + 3 * q + c] : 0.0f;
    plane_oplus(planes + 4 * q, d, cand_planes + 4 * q);
  }
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) s_max[threadIdx.x] = fmaxf(s_max[threadIdx.x], s_max[threadIdx.x + half]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    lmi[S_OK] = ok;
    lmi[S_SMALL] = s_max[0] < 1e-6f;
  }
}

// one block: accept or reject the candidate, the lambda schedule, the stopping tests
__global__ void lm_accept(float* __restrict__ poses, float* __restrict__ planes, const float* __restrict__ cand_poses,
                          const float* __restrict__ cand_planes, int n_nodes, int n_planes, float* __restrict__ lmf,
                          int* __restrict__ lmi, int num_iterations) {
  if (lmi[S_DONE]) return;
  const float chi2 = lmf[F_CHI2], new_chi2 = lmf[F_NEW_CHI2];
  const bool accept = lmi[S_OK] && new_chi2 <= chi2;
  if (accept) {
    for (int e = threadIdx.x; e < 16 * n_nodes; e += blockDim.x) poses[e] = cand_poses[e];
    for (int e = threadIdx.x; e < 4 * n_planes; e += blockDim.x) planes[e] = cand_planes[e];
  }
  __syncthreads();  // every thread has read `done` before thread 0 writes it
  if (threadIdx.x != 0) return;
  const float next = accept ? new_chi2 : chi2;
  const float lam = lmf[F_LAM];
  const float half = lam * 0.5f, quad = lam * 4.0f;
  lmf[F_LAM] = accept ? (half < 1e-9f ? 1e-9f : half) : (quad > 1e6f ? 1e6f : quad);
  const int it = lmi[S_IT] + 1;
  lmi[S_IT] = it;
  const bool rel_ok = accept && (chi2 - next) < 1e-8f * (chi2 + 1e-12f);
  lmf[F_CHI2] = next;
  lmi[S_DONE] = it >= num_iterations || lmi[S_SMALL] || rel_ok;
}

}  // namespace

// H (n, n) and b (n,) from K15's build, cleared here; damped (n, n), rhs (n,)
extern "C" int lvs_lm_damp(float* H, float* b, const bool* node_valid, const bool* node_fixed,
                           const bool* plane_valid, const bool* plane_fixed, int n_nodes, int n, const float* lmf,
                           const int* lmi, float* damped, float* rhs, cudaStream_t stream) {
  lm_damp<<<lvs::blocks_for(static_cast<long long>(n) * n + n), lvs::kThreads, 0, stream>>>(
      H, b, node_valid, node_fixed, plane_valid, plane_fixed, n_nodes, n, lmf, lmi, damped, rhs);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_lm_update(const float* delta, const int* chol_info, const float* poses, const float* planes,
                             float* cand_poses, float* cand_planes, int n_nodes, int n_planes, int n, int* lmi,
                             cudaStream_t stream) {
  lm_update<<<1, lvs::kThreads, 0, stream>>>(delta, chol_info, poses, planes, cand_poses, cand_planes, n_nodes,
                                             n_planes, n, lmi);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_lm_accept(float* poses, float* planes, const float* cand_poses, const float* cand_planes,
                             int n_nodes, int n_planes, float* lmf, int* lmi, int num_iterations,
                             cudaStream_t stream) {
  lm_accept<<<1, lvs::kThreads, 0, stream>>>(poses, planes, cand_poses, cand_planes, n_nodes, n_planes, lmf, lmi,
                                             num_iterations);
  LVS_RETURN_LAST_ERROR();
}
