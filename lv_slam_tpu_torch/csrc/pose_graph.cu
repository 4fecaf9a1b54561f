// Kernel 15: the pose graph's normal equations, every factor family, in one
// launch of one thread-block cluster.
//
// Replaces: lv_slam_tpu/graph/pose_graph.py:240 `_chi2_and_normal`, with
// `_edge_res_jac` :152, `_prior_res_jac` :167, `_sp_res_jac` :193,
// `_q_res_jac` :209 and lv_slam_tpu/graph/factors.py (the SE3 edge :34, the
// priors :49-93, the plane helpers :110-160, the plane factors :163-210,
// `huber_weight` :213); in its damped mode also `_apply_gauge` :360 and the
// damping of `optimize_pose_graph`'s loop body (:394).
//
// What bounds it on the card: nothing large. The backend's graphs hold at
// most a few thousand factors and a dense H of (6 K + 3 Q)^2 floats (216^2 on
// the flagship circle's main path, 408^2 at 64 keyframes). Each factor costs
// a few thousand dependent flops and writes up to 156 floats. What shows is
// latency: the factors' chains of dependent operations and the launches.
//
// Design: one cluster of 8 blocks x 256 threads (`__cluster_dims__`), every
// factor family and the assembly in one launch, three modes:
//   raw     chi2, H and b (`_chi2_and_normal(build=True)`, and the sharded
//           LM, whose ranks sum raw H and b before the gauge);
//   chi2    chi2 only;
//   damped  the unsharded LM's system: the gauge (`freed`) and
//           v + lam max(v, 1e-6) on the diagonal written straight into the
//           damped matrix, and rhs = -b (no H to clear afterwards).
// Each block first stages every factor slot's variables (validity and
// indices, one word a slot) in shared memory, so a factor's pose loads wait
// on no index load.
// Factor phase (raw, damped): a warp per factor, the 64 warps of the cluster
// striding over the factor slots (edges, priors, SE3-plane, plane-plane).
// Every lane evaluates the factor's value (the same code, so the same bits);
// lane k takes tangent direction k of its Jacobian (an edge's 6 columns,
// selected without a branch on k, or the 6 or 9 dual-number passes, whose
// values are the residual's) into the warp's shared memory, and the lanes
// split the entries of W J and of the block J^T (w Omega) J, J^T (w Omega)
// r, each entry's sum in the order the earlier one-thread kernels added it,
// so each block is those kernels' bits. Blocks go to a global scratch slot
// of their own, written by the warp's lanes together. In chi2 mode a thread
// takes a factor (the value only).
// Then a cluster barrier (release / acquire): every block and chi2 term is
// visible to the whole cluster.
// Assembly phase: a warp per variable (node, then plane), striding over the
// variables, owns that variable's rows of H and b: it zeroes them, finds the
// factors on the variable with a ballot over 32 staged slots at a time and
// adds their blocks in slot order, each entry by one lane (the diagonal
// block and b in registers, written once at the end; the first block on a
// partner stored as 0 + v without reading H back). Every sum thus has a
// fixed order and H and b are the same bits on every run (float atomics
// would vary their last bits run to run, and the LM's accept tests carry
// that to the poses). In damped mode the warp leaves out the blocks on a
// variable the gauge holds and passes each add through the damping's
// off-diagonal operations (x + 0, then + lam * 0: applied after every add
// it gives the bits of applying it once to the sum). Block 0 sums the chi2
// terms in a fixed order (`ordered_sum`), so the LM's accept test is
// deterministic. A zero divided by a non-zero takes `div0` (the division's
// bits without its slow path).
// Inside the device-side LM loop (csrc/lm.cu) every launch takes the loop's
// `done` flag (null outside it) and returns at once when it is set.
#include "pose_graph.cuh"

namespace {

constexpr int MODE_RAW = 0, MODE_CHI2 = 1, MODE_DAMPED = 2;
constexpr int kWarpScratch = 2 * 6 * 12;  // J and W J of the largest factor (an edge: 6 x 12)

// the weighted chi2 of an m-dim residual, the Huber weight, and the factor's
// block J^T (w Omega) J, J^T (w Omega) r (nd dofs) written to `out` by the
// warp's lanes; J (M x ND, row-major) in the warp's shared memory
template <int M, int ND>
__device__ void accumulate_warp(const float* rv, const float* Jw, float* WJw, const float* om, int om_stride, float hb,
                                float* rho_out, float* __restrict__ out, int lane) {
  float om_r[M];
  const float chi2 = weighted_chi2<M>(rv, om, om_stride, om_r);
  if (lane == 0) *rho_out = chi2;  // the plain chi2, as the reference sums it for these factors
  float chi = sqrtf(fmaxf(chi2, 0.0f));
  float w = (hb > 0.0f && chi > hb) ? hb / fmaxf(chi, 1e-12f) : 1.0f;
  for (int e = lane; e < M * ND; e += 32) {
    const int i = e / ND, c = e % ND;
    float s = 0.0f;
    for (int j = 0; j < M; ++j) s += (w * om[om_stride * i + j]) * Jw[ND * j + c];
    WJw[e] = s;
  }
  __syncwarp();
  for (int e = lane; e < ND * ND + ND; e += 32) {
    if (e < ND * ND) {
      const int p = e / ND, c = e % ND;
      float s = 0.0f;
      for (int i = 0; i < M; ++i) s += Jw[ND * i + p] * WJw[ND * i + c];
      out[e] = s;
    } else {
      const int p = e - ND * ND;
      float bs = 0.0f;
      for (int i = 0; i < M; ++i) bs += Jw[ND * i + p] * (w * om_r[i]);
      out[e] = bs;
    }
  }
}

// an SE3 edge's chi2 term and block, by one warp
__device__ void edge_warp(const GraphArgs& g, const float* __restrict__ poses, int e, unsigned vw, float* Jw,
                          float* WJw, float* __restrict__ rho, float* __restrict__ blk, int lane) {
  const float* tj = poses + 16 * var_b(vw);
  EdgeValue v;
  edge_value(g, poses + 16 * var_a(vw), tj, e, v);
  if (lane == 0) rho[e] = v.rho;
  if (lane < 6) {  // J (6 x 12): columns 0-5 node i, 6-11 node j
    float dr[6];
    edge_column(v, tj, lane, dr);
    for (int i = 0; i < 6; ++i) {
      Jw[12 * i + 6 + lane] = dr[i];
      Jw[12 * i + lane] = -dr[i];
    }
  }
  __syncwarp();
  const float* om = g.e_info + 36 * e;
  for (int x = lane; x < 72; x += 32) {
    const int i = x / 12, c = x % 12;
    float s = 0.0f;
    for (int j = 0; j < 6; ++j) s += (v.w * om[6 * i + j]) * Jw[12 * j + c];
    WJw[x] = s;
  }
  __syncwarp();
  float* out = blk + static_cast<long long>(e) * block_floats(12);
  for (int x = lane; x < 156; x += 32) {
    if (x < 144) {
      const int p = x / 12, c = x % 12;
      float s = 0.0f;
      for (int i = 0; i < 6; ++i) s += Jw[12 * i + p] * WJw[12 * i + c];
      out[x] = s;
    } else {
      const int p = x - 144;
      float bs = 0.0f;
      for (int i = 0; i < 6; ++i) bs += Jw[12 * i + p] * (v.w * v.om_r[i]);
      out[x] = bs;
    }
  }
}

// a prior's, SE3-plane edge's or plane-plane factor's chi2 term and block,
// by one warp: one dual-number pass a lane, along direction `lane` (lanes
// past the factor's dofs: none). A dual's value never reads a derivative,
// so every lane's values are the residual's.
template <int M, int ND>
__device__ void dual_warp(const GraphArgs& g, const float* __restrict__ poses, const float* __restrict__ planes,
                          int family, int f, unsigned vw, const float* om, int om_stride, float hb, float* Jw,
                          float* WJw, float* rho_out, float* __restrict__ out, int lane) {
  D r[4];
  r[3] = cst(0.0f);
  dual_residual(g, poses, planes, family, f, vw, lane < ND ? lane : -1, r);
  float rv[M];
  for (int i = 0; i < M; ++i) rv[i] = r[i].v;
  if (lane < ND)
    for (int i = 0; i < M; ++i) Jw[ND * i + lane] = r[i].d;
  __syncwarp();
  accumulate_warp<M, ND>(rv, Jw, WJw, om, om_stride, hb, rho_out, out, lane);
}

// one factor slot t (any family; `vw` its staged variables) by one warp
__device__ void factor_warp(const GraphArgs& g, const float* __restrict__ poses, const float* __restrict__ planes,
                            int t, unsigned vw, float* Jw, float* WJw, float* __restrict__ rho,
                            float* __restrict__ blk, int lane) {
  if (vw == kNoVars) {
    if (lane == 0) rho[t] = 0.0f;
    return;
  }
  int f;
  const int family = family_of(g, t, f);
  const long long o1 = static_cast<long long>(g.n_e) * block_floats(12);
  const long long o2 = o1 + static_cast<long long>(g.n_p) * block_floats(6);
  const long long o3 = o2 + static_cast<long long>(g.n_s) * block_floats(9);
  if (family == 0) {
    edge_warp(g, poses, f, vw, Jw, WJw, rho, blk, lane);
  } else if (family == 1) {
    dual_warp<4, 6>(g, poses, planes, 1, f, vw, g.p_info + 16 * f, 4, g.p_huber[f], Jw, WJw, rho + t,
                    blk + o1 + static_cast<long long>(f) * block_floats(6), lane);
  } else if (family == 2) {
    dual_warp<3, 9>(g, poses, planes, 2, f, vw, g.sp_info + 9 * f, 3, g.sp_huber[f], Jw, WJw, rho + t,
                    blk + o2 + static_cast<long long>(f) * block_floats(9), lane);
  } else {
    dual_warp<4, 6>(g, poses, planes, 3, f, vw, g.q_info + 16 * f, 4, g.q_huber[f], Jw, WJw, rho + t,
                    blk + o3 + static_cast<long long>(f) * block_floats(6), lane);
  }
}

// ---------------------------------------------------------------- assembly

// one factor family for the assembly: its staged variables and its blocks
struct Family {
  const unsigned* vars;
  const float* blk;
  int n_f;
};

// the first dof of a node (6 v) or a plane (6 K + 3 v) in the state
__device__ __forceinline__ int dof_of(bool node, int v, int n_nodes) { return node ? 6 * v : 6 * n_nodes + 3 * v; }

// A warp's set of variables, one bit each (at most kMaxVars): lane l holds
// variables 32 l .. 32 l + 31 in `lo` and 1024 + 32 l .. in `hi`. Every
// lane reads a bit with two shuffles (the whole warp takes part); the
// owning lane sets it. No memory, so no barrier between a set and a read.
constexpr int kMaxVars = 2048;
struct WarpBits {
  unsigned lo = 0u, hi = 0u;
  __device__ __forceinline__ bool test(int w) const {
    const int src = (w >> 5) & 31;
    const unsigned x0 = __shfl_sync(0xffffffffu, lo, src), x1 = __shfl_sync(0xffffffffu, hi, src);
    return ((w >> 10 ? x1 : x0) >> (w & 31)) & 1u;
  }
  __device__ __forceinline__ void set(int w, int lane) {
    if (lane == ((w >> 5) & 31)) {
      if (w >> 10)
        hi |= 1u << (w & 31);
      else
        lo |= 1u << (w & 31);
    }
  }
};

// One warp adds the blocks of `fam`'s factors that touch variable u (a node
// when u_node, else a plane) to u's rows: the factors in slot order, within
// a factor its variable pairs in order. It finds them with a ballot over 32
// slots at a time (the slots' staged variables). Entry e of a du x d2 block
// belongs to lane e % 32 (slot e / 32 of two: du x d2 <= 36), so every
// entry of H and b is added by one lane, in that order. The diagonal block
// (u, u) and b's rows add into the registers h0, h1 and hb, the other
// blocks into H's rows, which hold zeros to start: the first block on a
// partner variable (not yet in `written`) is stored as 0 + v without
// reading H back, a later one is added to what the same lane stored.
// A and B are whether slots a and b are nodes; NB is b's dofs (0: unary).
// DAMPED: H is the damped matrix; a block on a variable the gauge holds is
// left out (its entries stay the damping's zeros), and each add is followed
// by the damping's off-diagonal operations.
template <bool A, bool B, int NB, bool DAMPED>
__device__ void gather(const Family fam, int u, bool u_node, int n_nodes, int n, float* __restrict__ H, int lane,
                       float& h0, float& h1, float& hb, const unsigned char* freed, WarpBits& written, float lam) {
  constexpr int NA = A ? 6 : 3, ND = NA + NB, SLOTS = NB > 0 ? 2 : 1;
  if (u_node ? !(A || (NB > 0 && B)) : (A && (NB == 0 || B))) return;  // no variable of u's kind
  const int du = u_node ? 6 : 3, row0 = dof_of(u_node, u, n_nodes);
  for (int f0 = 0; f0 < fam.n_f; f0 += 32) {  // uniform over the warp
    const int f = f0 + lane;
    bool hit = false;
    if (f < fam.n_f) {
      const unsigned vw = fam.vars[f];
      hit = vw != kNoVars && ((A == u_node && var_a(vw) == u) || (NB > 0 && B == u_node && var_b(vw) == u));
    }
    unsigned m = __ballot_sync(0xffffffffu, hit);
    while (m) {
      const int g = f0 + __ffs(m) - 1;
      m &= m - 1;
      const float* blk = fam.blk + static_cast<long long>(g) * block_floats(ND);
      const unsigned vw = fam.vars[g];
      const int var[2] = {var_a(vw), var_b(vw)};
      for (int s = 0; s < SLOTS; ++s) {
        if ((s == 0 ? A : B) != u_node || var[s] != u) continue;
        const int off = s == 0 ? 0 : NA;
        for (int s2 = 0; s2 < SLOTS; ++s2) {
          const bool node2 = s2 == 0 ? A : B;
          const int d2 = s2 == 0 ? NA : NB, cells = du * d2;
          const float* src = blk + ND * off + (s2 == 0 ? 0 : NA);  // entry (r, c) at src[ND r + c]
          const int e0 = lane, e1 = lane + 32;
          const float v0 = e0 < cells ? __ldcg(src + ND * (e0 / d2) + e0 % d2) : 0.0f;
          const float v1 = e1 < cells ? __ldcg(src + ND * (e1 / d2) + e1 % d2) : 0.0f;
          if (node2 == u_node && var[s2] == u) {
            h0 += v0;
            h1 += v1;
          } else {
            const int w = node2 ? var[s2] : n_nodes + var[s2];  // the partner variable
            if (DAMPED && !freed[w]) continue;
            const bool first = !written.test(w);
            float* dst = H + static_cast<long long>(row0) * n + dof_of(node2, var[s2], n_nodes);
            if (e0 < cells) {
              float* p = dst + static_cast<long long>(e0 / d2) * n + e0 % d2;
              float x = (first ? 0.0f : *p) + v0;
              if (DAMPED) x = (x + 0.0f) + lam * 0.0f;
              *p = x;
            }
            if (e1 < cells) {
              float* p = dst + static_cast<long long>(e1 / d2) * n + e1 % d2;
              float x = (first ? 0.0f : *p) + v1;
              if (DAMPED) x = (x + 0.0f) + lam * 0.0f;
              *p = x;
            }
            written.set(w, lane);
          }
        }
        if (lane < du) hb += __ldcg(blk + ND * ND + off + lane);
      }
    }
  }
}

// One warp: variable u's rows of H and b (raw) or of the damped system and
// rhs, from the four families in the order edges, priors, SE3-plane,
// plane-plane. The warp first zeroes its rows (so H and b need no initial
// values: every off-diagonal sum is 0 + its blocks in order, as the
// earlier kernels added them into a zeroed H), then adds the blocks, then
// writes the diagonal block and b.
template <bool DAMPED>
__device__ void assemble_variable(const Family* fams, int u, int n_nodes, int n, float* __restrict__ H,
                                  float* __restrict__ b, int lane, const unsigned char* freed, float lam) {
  const bool u_node = u < n_nodes;
  const int v = u_node ? u : u - n_nodes;
  const int du = u_node ? 6 : 3, row0 = dof_of(u_node, v, n_nodes);
  const bool fu = DAMPED && freed[u];
  for (int r = 0; r < du; ++r) {  // the rows' zeros (the damping's, in damped mode)
    float* row = H + static_cast<long long>(row0 + r) * n;
    if (n % 4 == 0) {
      for (int c = lane; c < n / 4; c += 32) reinterpret_cast<float4*>(row)[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      for (int c = lane; c < n; c += 32) row[c] = 0.0f;
    }
  }
  __syncwarp();  // the zeros are written before any lane adds onto them
  float h0 = 0.0f, h1 = 0.0f, hb = 0.0f;
  if (!DAMPED || fu) {
    WarpBits written;  // SE3 edges, priors, SE3-plane, plane-plane
    gather<true, true, 6, DAMPED>(fams[0], v, u_node, n_nodes, n, H, lane, h0, h1, hb, freed, written, lam);
    gather<true, false, 0, DAMPED>(fams[1], v, u_node, n_nodes, n, H, lane, h0, h1, hb, freed, written, lam);
    gather<true, false, 3, DAMPED>(fams[2], v, u_node, n_nodes, n, H, lane, h0, h1, hb, freed, written, lam);
    gather<false, false, 3, DAMPED>(fams[3], v, u_node, n_nodes, n, H, lane, h0, h1, hb, freed, written, lam);
  }
  float* diag = H + static_cast<long long>(row0) * n + row0;
  const float hs[2] = {h0, h1};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int e = lane + 32 * s;
    if (e >= du * du) continue;
    float* p = diag + static_cast<long long>(e / du) * n + e % du;
    if (!DAMPED) {
      *p = 0.0f + hs[s];
      continue;
    }
    // lm_damp's operations on H's entry (0 + the block's sum)
    float x = fu ? 0.0f + hs[s] : 0.0f;
    if (e / du == e % du) {
      x = x + (fu ? 0.0f : 1.0f);
      const float dg = x < 1e-6f ? 1e-6f : x;  // clamp(min=1e-6), NaN-propagating
      *p = x + lam * dg;
    } else {
      x = x + 0.0f;
      *p = x + lam * 0.0f;
    }
  }
  if (lane < du) b[row0 + lane] = DAMPED ? -(fu ? 0.0f + hb : 0.0f) : 0.0f + hb;
}

// The cluster: every slot's variables staged, the factor phase, a cluster
// barrier, then the assembly (raw, damped) and block 0's ordered chi2 sum
// (raw, chi2). Dynamic shared memory: each warp's J and W J, every factor
// slot's staged variables, each variable's `freed` byte.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(lvs::kThreads)
    normal_cluster(const GraphArgs g, const float* __restrict__ poses, const float* __restrict__ planes, int mode,
                   float* __restrict__ rho, float* __restrict__ blk, float* __restrict__ H, float* __restrict__ b,
                   float* __restrict__ chi2, const float* __restrict__ lmf, const int* __restrict__ done) {
  if (done != nullptr && *done) return;  // the LM loop's gate, uniform over the cluster
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = cluster_rank();
  const int total = n_terms(g), n_vars = g.n_nodes + g.n_planes;
  unsigned* vars = reinterpret_cast<unsigned*>(smem + kWarps * kWarpScratch);
  unsigned char* freed = reinterpret_cast<unsigned char*>(vars + total);
  stage_vars(g, vars);
  if (mode == MODE_DAMPED)
    for (int u = threadIdx.x; u < n_vars; u += blockDim.x)
      freed[u] = u < g.n_nodes ? g.node_valid[u] && !g.node_fixed[u] && u > 0
                               : g.plane_valid[u - g.n_nodes] && !g.plane_fixed[u - g.n_nodes];
  __syncthreads();

  if (mode == MODE_CHI2) {
    for (int t = rank * lvs::kThreads + threadIdx.x; t < total; t += kCluster * lvs::kThreads)
      rho[t] = factor_rho(g, poses, planes, t, vars[t]);
  } else {
    float* Jw = smem + warp * kWarpScratch;
    for (int t = rank * kWarps + warp; t < total; t += kCluster * kWarps) {
      factor_warp(g, poses, planes, t, vars[t], Jw, Jw + kWarpScratch / 2, rho, blk, lane);
      __syncwarp();  // the next factor reuses the warp's J and W J
    }
  }
  __syncthreads();
  cluster_sync();  // every block and chi2 term is visible to the cluster

  if (rank == 0 && mode != MODE_DAMPED) {
    const float s = ordered_sum(rho, total);
    if (threadIdx.x == 0 && chi2 != nullptr) *chi2 = s;
  }
  if (mode == MODE_CHI2) return;
  const long long o1 = static_cast<long long>(g.n_e) * block_floats(12);
  const long long o2 = o1 + static_cast<long long>(g.n_p) * block_floats(6);
  const long long o3 = o2 + static_cast<long long>(g.n_s) * block_floats(9);
  const Family fams[4] = {{vars, blk, g.n_e},
                          {vars + g.n_e, blk + o1, g.n_p},
                          {vars + g.n_e + g.n_p, blk + o2, g.n_s},
                          {vars + g.n_e + g.n_p + g.n_s, blk + o3, g.n_q}};
  const int n = 6 * g.n_nodes + 3 * g.n_planes;
  for (int u = rank * kWarps + warp; u < n_vars; u += kCluster * kWarps) {
    if (mode == MODE_DAMPED)
      assemble_variable<true>(fams, u, g.n_nodes, n, H, b, lane, freed, lmf[F_LAM]);
    else
      assemble_variable<false>(fams, u, g.n_nodes, n, H, b, lane, freed, 0.0f);
  }
}

// Bytes of dynamic shared memory the cluster takes for `n_terms` factor
// slots and `n_vars` variables
long long smem_bytes(int n_terms, int n_vars) { return 4LL * (kWarps * kWarpScratch + n_terms) + n_vars; }

}  // namespace

// One evaluation of the graph `*g` (a host struct) at `poses` and `planes`:
// mode 0 (raw) writes the chi2 terms `rho`, the blocks `blk`, H to `h`, b
// to `b` and the chi2 sum to `chi2` unless it is null; mode 1 (chi2) writes
// rho and the sum; mode 2 (damped) writes the damped system to `h` and
// rhs = -b to `b` with lambda lmf[0]. `done`: the LM loop's gate, or null.
// At most kMaxVars nodes and planes together.
extern "C" int lvs_pose_graph(const lvs::GraphArgs* g, const float* poses, const float* planes, int mode, float* rho,
                              float* blk, float* h, float* b, float* chi2, const float* lmf, const int* done,
                              cudaStream_t stream) {
  if (g->n_nodes + g->n_planes > kMaxVars || mode < MODE_RAW || mode > MODE_DAMPED)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(n_terms(*g), g->n_nodes + g->n_planes);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(normal_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  normal_cluster<<<kCluster, lvs::kThreads, smem, stream>>>(*g, poses, planes, mode, rho, blk, h, b, chi2, lmf, done);
  LVS_RETURN_LAST_ERROR();
}
