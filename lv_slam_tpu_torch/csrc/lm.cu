// The Levenberg-Marquardt loop of the pose graph, on the device.
//
// Replaces the body of lv_slam_tpu/graph/pose_graph.py:380
// `optimize_pose_graph`'s `lax.while_loop` (:380-421) around kernel 15
// (`csrc/pose_graph.cu`) and the dense factorization, which stays a library
// call (`torch.linalg.cholesky_ex` + `cholesky_solve`, as the reference leaves
// it to `jax.scipy.linalg.solve`). An iteration is two hand launches around
// the library solve: K15 in its damped mode (the normal equations, the gauge
// and the damping, written as the damped system and its right-hand side),
// then `lm_step`, one cluster that tests the solve, forms the candidate,
// evaluates its chi2 with K15's factor code and takes the accept decision.
// Both are gated on the loop's `done` flag; the host launches iterations in
// groups with one read of `done` per group
// (`graph/pose_graph.py:optimize_pose_graph`). The sharded LM
// (`parallel/mesh.py`) sums raw H and b and the candidate's chi2 across its
// ranks between these steps, so it runs K15 raw, `lm_damp`, the solve,
// `lm_step` stopped before the decision, and `lm_accept`.
//
// Bound on the card: the work an iteration needs is the graph's arrays read
// once, the damped system written once and read by the solve, rhs, and the
// poses and planes read and written: at phase 5's 216-dof system ~0.2 MB,
// well under a microsecond of HBM time. What shows is latency: the factors'
// dependent chains, the cluster barriers and the launches, and the library
// factorization (n^3 / 3 operations).
//
// Design: `lm_step` is one cluster of 8 x 256 threads: every block tests the
// solve (the factor's info and every entry finite: a failed step is zero);
// a thread per node forms exp_se3(delta) T (left-multiplied), a thread per
// plane `plane_oplus`; after a cluster barrier a thread per factor slot
// evaluates the candidate's chi2 term (`factor_rho`, the code K15's chi2
// mode runs); after a second, block 0 takes max |delta| for the `small`
// test (reduced before the barrier), sums the terms in K15's fixed order,
// and runs `lm_accept`'s logic:
// the candidate is taken when its chi2 does not exceed the current one,
// then the lambda schedule, the iteration count and the stopping tests (it
// >= num_iterations, small, relative chi2 change). `lm_damp` (sharded only)
// is elementwise over H and b: the gauge of `_apply_gauge` (node 0, fixed
// and invalid nodes and planes), the damping h + lam * max(diag h, 1e-6),
// rhs = -b, and it clears H and b for the next build. Each is written as
// the plain twin (`_lm_iteration_ref`) computes it.
#include "pose_graph.cuh"
#include "se3.cuh"

namespace {

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

// factors.plane_oplus(p, d): the normal moved in its tangent basis, then the
// distance (`div0`: a zero entry over its norm without the division's slow path)
__device__ void plane_oplus(const float* p_in, const float* d, float* out) {
  float p[4];
  const float pn = clamp_min(norm3f(p_in), 1e-9f);
  for (int c = 0; c < 4; ++c) p[c] = div0(p_in[c], pn);
  float b1[3] = {1.0f - p[0] * p[0], 0.0f - p[1] * p[0], 0.0f - p[2] * p[0]};
  const float bn = clamp_min(norm3f(b1), 1e-9f);
  for (int c = 0; c < 3; ++c) b1[c] = div0(b1[c], bn);
  const float b2[3] = {p[1] * b1[2] - p[2] * b1[1], p[2] * b1[0] - p[0] * b1[2], p[0] * b1[1] - p[1] * b1[0]};
  float nn[3];
  for (int c = 0; c < 3; ++c) nn[c] = (p[c] + d[0] * b1[c]) + d[1] * b2[c];
  const float nnn = clamp_min(norm3f(nn), 1e-9f);
  for (int c = 0; c < 3; ++c) out[c] = div0(nn[c], nnn);
  out[3] = p[3] + d[2];
}

// lm_accept's decision (block 0 of `lm_step`, or its own launch in the
// sharded LM): take the candidate when its chi2 does not exceed the current
// one, then the lambda schedule, the iteration count and the stopping tests.
// Every thread of the block must have read `done` before it is called.
__device__ void accept_step(float* __restrict__ poses, float* __restrict__ planes,
                            const float* __restrict__ cand_poses, const float* __restrict__ cand_planes, int n_nodes,
                            int n_planes, float* __restrict__ lmf, int* __restrict__ lmi, int num_iterations, bool ok,
                            bool small, float new_chi2) {
  const float chi2 = lmf[F_CHI2];
  const bool accept = ok && new_chi2 <= chi2;
  if (accept) {
    for (int e = threadIdx.x; e < 16 * n_nodes; e += blockDim.x) poses[e] = __ldcg(cand_poses + e);
    for (int e = threadIdx.x; e < 4 * n_planes; e += blockDim.x) planes[e] = __ldcg(cand_planes + e);
  }
  __syncthreads();  // every thread has read the scalars before thread 0 writes them
  if (threadIdx.x != 0) return;
  const float next = accept ? new_chi2 : chi2;
  const float lam = lmf[F_LAM];
  const float half = lam * 0.5f, quad = lam * 4.0f;
  lmf[F_LAM] = accept ? (half < 1e-9f ? 1e-9f : half) : (quad > 1e6f ? 1e6f : quad);
  const int it = lmi[S_IT] + 1;
  lmi[S_IT] = it;
  const bool rel_ok = accept && (chi2 - next) < 1e-8f * (chi2 + 1e-12f);
  lmf[F_CHI2] = next;
  lmi[S_DONE] = it >= num_iterations || small || rel_ok;
}

// One cluster: the step's test, the candidate poses and planes, the
// candidate's chi2 terms and their ordered sum, then (with `decide`) the
// accept decision. Without it, block 0 leaves the sum in lmf[2] and ok /
// small in lmi[2:4] for `lm_accept`.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(lvs::kThreads)
    lm_step(const GraphArgs g, const float* __restrict__ delta, const int* __restrict__ chol_info,
            float* __restrict__ poses, float* __restrict__ planes, float* __restrict__ cand_poses,
            float* __restrict__ cand_planes, float* __restrict__ rho, float* __restrict__ lmf, int* __restrict__ lmi,
            int n, int num_iterations, int decide) {
  if (lmi[S_DONE]) return;  // uniform over the cluster: block 0 writes it after the last cluster barrier
  extern __shared__ unsigned vars[];  // every factor slot's staged variables
  const int rank = cluster_rank();
  const int stride = kCluster * lvs::kThreads;
  const int i0 = rank * lvs::kThreads + threadIdx.x;  // this thread's first node
  float xi0[6], t0[16];  // its step and pose, loaded before the step's test
  if (i0 < g.n_nodes) {
#pragma unroll
    for (int c = 0; c < 6; ++c) xi0[c] = delta[6 * i0 + c];
#pragma unroll
    for (int c = 0; c < 16; ++c) t0[c] = poses[16 * i0 + c];
  }
  stage_vars(g, vars);
  bool finite = true;
  float m = 0.0f;  // max |delta|, read only when every entry is finite
  for (int d = threadIdx.x; d < n; d += blockDim.x) {
    const float x = delta[d];
    finite = finite && isfinite(x);
    m = fmaxf(m, fabsf(x));
  }
  const bool ok = __syncthreads_and(finite) && *chol_info == 0;
  for (int i = i0; i < g.n_nodes; i += stride) {
    float xi[6], e[16], t[16];
#pragma unroll
    for (int c = 0; c < 6; ++c) xi[c] = ok ? (i == i0 ? xi0[c] : delta[6 * i + c]) : 0.0f;
#pragma unroll
    for (int c = 0; c < 16; ++c) t[c] = i == i0 ? t0[c] : poses[16 * i + c];
    lvs::exp_se3(xi, e);
    lvs::matmul44(e, t, cand_poses + 16 * i);
  }
  for (int q = i0; q < g.n_planes; q += stride) {
    float d[3];
    for (int c = 0; c < 3; ++c) d[c] = ok ? delta[6 * g.n_nodes + 3 * q + c] : 0.0f;
    plane_oplus(planes + 4 * q, d, cand_planes + 4 * q);
  }
  __shared__ float s_max[kWarps];
  if (rank == 0) {  // the `small` test's max |delta| (exact in any order; a failed step's is 0)
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = ok ? m : 0.0f;
  }
  cluster_sync();  // the candidate is visible to the cluster
  const int total = n_terms(g);
  for (int t = i0; t < total; t += stride) rho[t] = factor_rho(g, cand_poses, cand_planes, t, vars[t]);
  cluster_sync();  // every chi2 term is visible to block 0
  if (rank != 0) return;

  const float new_chi2 = ordered_sum(rho, total);  // its barriers also publish s_max
  float top = s_max[0];
  for (int w = 1; w < kWarps; ++w) top = fmaxf(top, s_max[w]);
  const bool small = top < 1e-6f;
  if (threadIdx.x == 0) {  // no thread of the block reads these below
    lmf[F_NEW_CHI2] = new_chi2;
    lmi[S_OK] = ok;
    lmi[S_SMALL] = small;
  }
  if (!decide) return;
  accept_step(poses, planes, cand_poses, cand_planes, g.n_nodes, g.n_planes, lmf, lmi, num_iterations, ok, small,
              new_chi2);
}

// one block: the sharded LM's decision once the ranks have summed the
// candidate's chi2 into lmf[2]
__global__ void lm_accept(float* __restrict__ poses, float* __restrict__ planes, const float* __restrict__ cand_poses,
                          const float* __restrict__ cand_planes, int n_nodes, int n_planes, float* __restrict__ lmf,
                          int* __restrict__ lmi, int num_iterations) {
  if (lmi[S_DONE]) return;
  accept_step(poses, planes, cand_poses, cand_planes, n_nodes, n_planes, lmf, lmi, num_iterations, lmi[S_OK] != 0,
              lmi[S_SMALL] != 0, lmf[F_NEW_CHI2]);
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

// One LM step after the solve (delta (n,), the Cholesky's info) on the
// graph `*g` (a host struct): the candidate into cand_poses / cand_planes,
// its chi2 terms into `rho`, then with `decide` the accept decision on
// poses, planes, lmf and lmi; without it the sum and the flags for
// `lvs_lm_accept`
extern "C" int lvs_lm_step(const lvs::GraphArgs* g, const float* delta, const int* chol_info, float* poses,
                           float* planes, float* cand_poses, float* cand_planes, float* rho, float* lmf, int* lmi,
                           int n, int num_iterations, int decide, cudaStream_t stream) {
  const long long smem = 4LL * n_terms(*g);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(lm_step, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lm_step<<<kCluster, lvs::kThreads, smem, stream>>>(*g, delta, chol_info, poses, planes, cand_poses, cand_planes, rho,
                                                     lmf, lmi, n, num_iterations, decide);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_lm_accept(float* poses, float* planes, const float* cand_poses, const float* cand_planes,
                             int n_nodes, int n_planes, float* lmf, int* lmi, int num_iterations,
                             cudaStream_t stream) {
  lm_accept<<<1, lvs::kThreads, 0, stream>>>(poses, planes, cand_poses, cand_planes, n_nodes, n_planes, lmf, lmi,
                                             num_iterations);
  LVS_RETURN_LAST_ERROR();
}
