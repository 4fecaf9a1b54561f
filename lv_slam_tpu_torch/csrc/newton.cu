// K7: the damped-Newton step of the NDT align, on the device.
//
// Replaces the body of lv_slam_tpu/ops/ndt_soa.py:167 `_newton_loop` (shared
// by `ndt_align_soa` :209 and lv_slam_tpu/ops/ndt_hash.py:184
// `ndt_align_hash_table`), of lv_slam_tpu/ops/ndt.py:131 `ndt_align`'s loop
// (with `dof_mask`), and of its vmap over the loop candidates in
// lv_slam_tpu/graph/loop_detector.py:69 `_fused_verify_fn`. The reference
// runs each as a `lax.while_loop`; here the loop state lives in a device
// buffer per align (or per candidate), each iteration is one derivative pass
// (K6, K6L, K6G or K13's, gated on the state's `done` flag) and one
// `newton_step` launch, and the host launches iterations in groups with one
// read of `done` per group (`ops/ndt.py:_newton_loop`).
//
// Bound on the card: per lane it reads the pass's partial rows (n_blocks x
// 43 floats, 44 KB at 65536 points) and its 80-float state, and solves one
// 6x6 system: under a microsecond of memory traffic and a few thousand
// operations. What shows is the launch latency and one thread's dependent
// arithmetic.
//
// Design: one block per lane. Its first 43 threads sum the partial rows in
// `ndt_finish`'s fixed order (the result does not change from run to run);
// thread 0 then runs the reference's body: on the first call it takes the
// sums as score0 and sets done = isnan(score0); otherwise the accept test,
// the cap halving or reset, the iteration count and the stopping tests; and,
// if not done, proposes the next candidate: the ridge, the `dof` projection
// (the ground NDT), the 6x6 solve (LU with partial pivoting in float64,
// rounded once to float32; a zero pivot is LAPACK's info != 0), the norm and
// the `bad` test, the ascent flip, the clamp to [eps/2, cap] and
// exp_se3(alpha * direction) @ transform. A lane whose `done` is set returns
// at once, so a launch after done is an exact no-op.
//
// K7s, `newton_sums` (replaces the per-shard sums before the `psum` of
// lv_slam_tpu/parallel/mesh.py:118): the point-sharded align needs the
// lane's sums before the step, to all-reduce them over the ranks that hold
// its points. It writes each lane's 43 sums in `newton_step`'s order (zeros
// for a finished lane), and `newton_step` then takes the reduced rows as a
// pass of one block (0 + x is x), so one rank's sharded step equals the
// unsharded one.
//
// What bounds K7s: a lane's rows are n_blocks x 172 contiguous bytes (88 KB
// at K13's 512 blocks), under 0.2 us of the card's bandwidth for six lanes.
// The order is the contract: column c is ((0 + r0) + r1) + ... in block
// order, a chain of n_blocks dependent float adds that no split may
// shorten (at best one add per ~4-cycle latency: ~1 us at 512), so the
// chain and the wait for its first operand are the floor. The first
// kernel (one 64-thread block per lane, 43 threads each walking
// `column_sum` over global memory) put a load's latency on every add:
// 0.0110 ms against torch.sum's 0.0038.
//
// Design: a block per lane and group of 4 columns (grid (lanes, 11)), 256
// threads. All threads gather the group's 4 floats of every row with plain
// loads, 16 in flight per thread (1024 rows a batch), into shared memory
// column by column (a column's stride, 2056 floats, puts a warp's stores on
// 32 distinct banks); after one barrier, thread c < 4 runs its column's
// chain from shared memory, a float4 (4 rows) a load and 32 rows a step,
// each add a plain `acc = acc + x` in order (no contraction: --fmad=false,
// and nothing to fuse). A lane with more than 2048 rows takes them in
// rounds of 2048, the chain's sum carried over. A finished lane writes its
// zeros and returns.
//
// What was hard: the bytes had to be spread. A one-block-per-lane ring (TMA
// bulk copies or 4-byte cp.async into shared memory, the chain consuming
// slots behind mbarriers) ran no faster than torch.sum: all 88 KB of a lane
// reach one SM, and each slot's barrier round trip stalls the chain. Split
// by columns, each block gathers 8 KB, the 11 blocks of a lane load on 11
// SMs at once, and the chain waits for one gather's latency. The chain
// itself stalled while each step's shared-memory loads waited behind its
// adds; float4 reads over a column-major layout take 4 rows a load, and 8
// loads a step are in flight before its 32 adds.
#include "common.cuh"
#include "ndt_terms.cuh"
#include "se3.cuh"

namespace {

// the state row of one lane (ops/ndt.py NewtonState): floats ...
constexpr int kF = 80;
constexpr int F_T = 0, F_SCORE = 16, F_GRAD = 17, F_HESS = 23, F_CAND = 59, F_CAP = 75, F_ALPHA = 76;
// ... and ints
constexpr int kS = 4;
constexpr int S_DONE = 0, S_IT = 1, S_STARTED = 2, S_BAD = 3;

// A x = b for a 6x6 A by LU with partial pivoting in float64; b becomes x.
// Returns 0, or (as LAPACK's getrf) the 1-based column of the first exactly
// zero pivot, in which case x is not computed.
__device__ int solve6(double A[6][6], double b[6]) {
  for (int c = 0; c < 6; ++c) {
    int p = c;
    double best = fabs(A[c][c]);
    for (int r = c + 1; r < 6; ++r)
      if (fabs(A[r][c]) > best) {
        best = fabs(A[r][c]);
        p = r;
      }
    if (p != c) {
      for (int j = 0; j < 6; ++j) {
        double t = A[c][j];
        A[c][j] = A[p][j];
        A[p][j] = t;
      }
      double t = b[c];
      b[c] = b[p];
      b[p] = t;
    }
    if (A[c][c] == 0.0) return c + 1;
    for (int r = c + 1; r < 6; ++r) {
      double l = A[r][c] / A[c][c];
      for (int j = c + 1; j < 6; ++j) A[r][j] -= l * A[c][j];
      b[r] -= l * b[c];
    }
  }
  for (int r = 5; r >= 0; --r) {
    double s = b[r];
    for (int j = r + 1; j < 6; ++j) s -= A[r][j] * b[j];
    b[r] = s / A[r][r];
  }
  return 0;
}

// The next candidate from the lane's accepted state (the top of the
// reference's loop body). dof_bits < 0: every dimension free.
__device__ void propose(float* st, int* si, float step_min, int dof_bits) {
  float* g = st + F_GRAD;
  float* h = st + F_HESS;
  float tr = 0.0f;
  for (int i = 0; i < 6; ++i) tr += fabsf(h[7 * i]);
  const float ridge = 1e-6f * tr / 6.0f + 1e-12f;
  if (dof_bits >= 0) {  // freeze the masked dims, pin their diagonal
    float m[6];
    for (int i = 0; i < 6; ++i) m[i] = (dof_bits >> i) & 1 ? 1.0f : 0.0f;
    for (int i = 0; i < 6; ++i) {
      g[i] = g[i] * m[i];
      for (int j = 0; j < 6; ++j) h[6 * i + j] = (h[6 * i + j] * m[i]) * m[j] - (1.0f - m[j]) * (i == j ? 1.0f : 0.0f);
    }
  }
  double A[6][6], x[6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) A[i][j] = static_cast<double>(h[6 * i + j] + (i == j ? ridge : 0.0f));
    x[i] = -static_cast<double>(g[i]);
  }
  const int info = solve6(A, x);
  float delta[6];
  for (int i = 0; i < 6; ++i) delta[i] = info ? 0.0f : static_cast<float>(x[i]);
  float sq = 0.0f;
  for (int i = 0; i < 6; ++i) sq += delta[i] * delta[i];
  const float norm = sqrtf(sq);
  const bool bad = norm == 0.0f || !isfinite(norm) || info != 0;
  const float den = bad ? 1.0f : norm;
  float dir[6];
  for (int i = 0; i < 6; ++i) dir[i] = delta[i] / den;
  float dphi0 = 0.0f;
  for (int i = 0; i < 6; ++i) dphi0 += g[i] * dir[i];
  if (-dphi0 > 0.0f)
    for (int i = 0; i < 6; ++i) dir[i] = -dir[i];
  // clamp(norm, min=step_min) then minimum with cap, NaN-propagating as torch's
  const float lo = norm < step_min ? step_min : norm;
  const float cap = st[F_CAP];
  const float alpha = cap < lo ? cap : lo;
  float xi[6], e[16];
  for (int i = 0; i < 6; ++i) xi[i] = alpha * dir[i];
  lvs::exp_se3(xi, e);
  lvs::matmul44(e, st + F_T, st + F_CAND);
  st[F_ALPHA] = alpha;
  si[S_BAD] = bad;
}

// One Newton iteration per lane (blockIdx.x): partials (n_lanes, n_blocks,
// 43) from the derivative pass at the lane's candidate; state f (n_lanes,
// 80), s (n_lanes, 4).
__global__ void newton_step(const float* __restrict__ partials, int n_blocks, float* __restrict__ f,
                            int* __restrict__ s, float eps, float step_min, float step_max, int max_iterations,
                            int dof_bits) {
  const int c = blockIdx.x;
  float* st = f + kF * c;
  int* si = s + kS * c;
  if (si[S_DONE]) return;  // the gate: the whole block returns, nothing is written
  __shared__ float sums[lvs::kNdtTerms];
  if (threadIdx.x < lvs::kNdtTerms)
    sums[threadIdx.x] = lvs::column_sum(partials + static_cast<long long>(lvs::kNdtTerms) * n_blocks * c, n_blocks,
                                        lvs::kNdtTerms, threadIdx.x);
  __syncthreads();
  if (threadIdx.x != 0) return;

  const float new_score = sums[0];
  bool done;
  if (!si[S_STARTED]) {  // the derivatives at the guess: score0, grad0, hess0
    for (int v = 0; v < lvs::kNdtTerms; ++v) st[F_SCORE + v] = sums[v];
    st[F_CAP] = step_max;
    si[S_IT] = 0;
    si[S_STARTED] = 1;
    done = isnan(new_score);
  } else {
    const bool bad = si[S_BAD] != 0;
    const float alpha = st[F_ALPHA];
    const bool accept = !bad && new_score >= st[F_SCORE];
    if (accept) {
      for (int v = 0; v < 16; ++v) st[F_T + v] = st[F_CAND + v];
      for (int v = 0; v < lvs::kNdtTerms; ++v) st[F_SCORE + v] = sums[v];
    }
    const float halved = st[F_CAP] * 0.5f;
    st[F_CAP] = accept ? step_max : (halved < step_min ? step_min : halved);
    const int it = si[S_IT] + 1;
    si[S_IT] = it;
    const bool shrunk_out = !accept && alpha <= step_min;
    done = bad || it > max_iterations || (accept && alpha < eps) || shrunk_out;
  }
  si[S_DONE] = done;
  if (!done) propose(st, si, step_min, dof_bits);
}

constexpr int kSumCols = 4;  // columns a block sums
constexpr int kSumGroups = (lvs::kNdtTerms + kSumCols - 1) / kSumCols;
constexpr int kSumThreads = 256;
constexpr int kSumLoads = 16;           // loads in flight per thread: 1024 rows a batch
constexpr int kSumRound = 2048;         // rows held in shared memory at once
constexpr int kSumPad = kSumRound + 8;  // a column's stride: a warp's stores fall on 32 banks

// acc + col[0] + col[1] + ... + col[n - 1], in that order; col 16-byte aligned
__device__ __forceinline__ float column_chain(const float* col, int n, float acc) {
  const float4* col4 = reinterpret_cast<const float4*>(col);
  int b = 0;
  for (; b + 32 <= n; b += 32) {
    float4 q[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) q[u] = col4[b / 4 + u];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      acc = acc + q[u].x;
      acc = acc + q[u].y;
      acc = acc + q[u].z;
      acc = acc + q[u].w;
    }
  }
  for (; b < n; ++b) acc = acc + col[b];
  return acc;
}

// Each lane's summed derivative rows (n_lanes, 43), zeros for a finished
// lane: block (c, g) writes columns [4g, 4g + 4) of lane c.
__global__ void __launch_bounds__(kSumThreads)
newton_sums(const float* __restrict__ partials, int n_blocks, const int* __restrict__ s, float* __restrict__ sums) {
  const int c = blockIdx.x, c0 = blockIdx.y * kSumCols, tid = threadIdx.x;
  const int w = min(kSumCols, lvs::kNdtTerms - c0);
  float* out = sums + lvs::kNdtTerms * c + c0;
  if (s[kS * c + S_DONE]) {
    if (tid < w) out[tid] = 0.0f;
    return;
  }
  __shared__ __align__(16) float cols[kSumCols * kSumPad];
  const float* rows = partials + static_cast<long long>(lvs::kNdtTerms) * n_blocks * c + c0;
  float acc = 0.0f;
  for (int r0 = 0; r0 < n_blocks; r0 += kSumRound) {
    const int nr = min(kSumRound, n_blocks - r0), n_el = nr * kSumCols;
    const float* src = rows + static_cast<long long>(r0) * lvs::kNdtTerms;
    for (int base = 0; base < n_el; base += kSumThreads * kSumLoads) {
      float v[kSumLoads];
#pragma unroll
      for (int u = 0; u < kSumLoads; ++u) {
        const int x = base + u * kSumThreads + tid, col = x % kSumCols;
        v[u] = x < n_el && col < w ? src[(x / kSumCols) * lvs::kNdtTerms + col] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kSumLoads; ++u) {
        const int x = base + u * kSumThreads + tid;
        if (x < n_el) cols[(x % kSumCols) * kSumPad + x / kSumCols] = v[u];
      }
    }
    __syncthreads();
    if (tid < w) acc = column_chain(cols + tid * kSumPad, nr, acc);
    __syncthreads();  // the chains have read this round before the next overwrites it
  }
  if (tid < w) out[tid] = acc;
}

}  // namespace

extern "C" int lvs_newton_sums(const float* partials, int n_blocks, const int* s, int n_lanes, float* sums,
                               cudaStream_t stream) {
  if (n_lanes > 0) newton_sums<<<dim3(n_lanes, kSumGroups), kSumThreads, 0, stream>>>(partials, n_blocks, s, sums);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_newton_step(const float* partials, int n_blocks, float* f, int* s, int n_lanes, float eps,
                               float step_min, float step_max, int max_iterations, int dof_bits,
                               cudaStream_t stream) {
  if (n_lanes > 0)
    newton_step<<<n_lanes, 64, 0, stream>>>(partials, n_blocks, f, s, eps, step_min, step_max, max_iterations,
                                            dof_bits);
  LVS_RETURN_LAST_ERROR();
}
