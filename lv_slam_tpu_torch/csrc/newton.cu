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
// 43 floats, 44 KB at 256 blocks, 88 KB at K13's 512) and its 80-float
// state, and solves one 6x6 system: under a microsecond of memory traffic
// and a few thousand operations. What bounds it is latency: the sums' order
// is the contract (column v is ((0 + r0) + r1) + ... in block order,
// `ndt_finish`'s and `newton_sums`' order), a chain of n_blocks dependent
// float adds (~5 cycles each) that no split may shorten; then the step's
// float64 LU, 12 dependent divisions of ~113 cycles on its critical path,
// and one thread's float32 exp_se3 and 4x4 product.
//
// Design: a cluster of 8 blocks of 256 threads per lane (blockIdx.x / 8);
// a finished lane's blocks return at once, before any other load or store,
// so a launch after done is an exact no-op. Block g sums the 6 columns from
// 6g (the last block 1): every thread issues its ~12 loads of the slice at
// once into shared memory (row-major, a stride of 6), then thread v < 6 runs
// column v's chain from there, the next 16 rows' reads in flight ahead of
// its adds. Blocks 1-7 send their sums into block 0's shared memory with
// async stores (`st.async`) that complete an mbarrier there, one message
// each and no fence. Block 0 staged the state row meanwhile; its warp 0
// then runs the step: every lane takes the accept test, the cap rule and
// the stopping tests on the staged state (the reference's body), the copies
// spread over the lanes; the ridge, the `dof` projection (the ground NDT)
// and the float64 system over the lanes, lane r < 6 holding row r; the LU
// with partial pivoting (the first row with the strictly larger |a|, a zero
// pivot returning LAPACK's info) a column at a time, its entries and the
// pivot row reaching the lanes by shuffles and lane r > c computing
// l = a[r][c] / a[c][c] and a[r][j] -= l * a[c][j], one thread's loop's
// operations (--fmad=false), so the same bits; then lane 0 the 6-step
// back-substitution (row r subtracts x[r + 1] first: a chain), the norm and
// `bad` test, the ascent flip, the clamp to [eps/2, cap] and
// exp_se3(alpha * direction) @ transform. The warp writes the state row
// back. Every value is the earlier kernel's to the bit
// (`scripts/newton_parent.py` holds it to that kernel on the card).
//
// What was hard: everything is a dependent chain, so each phase's latency
// shows (clock stamps of block 0 at 1 lane x 256 rows on an H100, PERF.md:
// the gate ~480 cycles, the rows landed ~1500 after
// it, the chains ~1600, the sums' exchange ~350, the accept test ~550, the
// solve ~3700, the rest of the step ~1750). The earlier kernel (threads
// 0-42 walking `column_sum` down global memory, then thread 0 alone with
// its 6x6 system in local memory, the pivot's row swap indexed at run time)
// put a load's latency on every add: 0.0088 ms a step. One block a lane
// gathers its 44-88 KB into one SM at ~6 bytes a cycle (~7200 cycles for
// 44 KB); split over the cluster, each block's ~6 KB land in one load's
// latency. Tried and dropped (times in PERF.md): one block of 512 or 1024
// threads a lane,
// clusters of 2 and 4, 128 and 512 threads, the rows signalled to the
// chains in chunks on named barriers (the loads land together anyway), a
// cluster barrier for the exchange (slower than one async message), the
// solve with a lane an element over shared memory (its round trips and warp barriers
// cost ~1.4 us more) and on one thread in registers (~0.3 us more).
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

constexpr int kTerms = lvs::kNdtTerms;
constexpr int kStepRows = 512;  // rows staged in shared memory a round

// the two halves of a cluster barrier: arrive (relaxed: it only says the
// block runs), wait (acquire)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `address` (this block's shared memory) in block `rank` of the cluster
__device__ __forceinline__ uint32_t in_rank(uint32_t address, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(address), "r"(rank));
  return out;
}

// v stored into rank 0's shared memory by the async store that also counts
// its 4 bytes off rank 0's mbarrier (`st.async`: one message, no fence)
__device__ __forceinline__ void store_to_rank0(uint32_t sum_address, uint32_t barrier_address, float v) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];" ::"r"(sum_address), "f"(v),
               "r"(barrier_address)
               : "memory");
}

__device__ __forceinline__ void wait_phase0(uint32_t barrier_address) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0; selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(barrier_address)
        : "memory");
}

constexpr int kStepCluster = 8;                                        // blocks a lane
constexpr int kStepThreads = 256;                                      // threads a block
constexpr int kWidth = (kTerms + kStepCluster - 1) / kStepCluster;     // columns a block sums
constexpr int kLoads = (kStepRows * kWidth + kStepThreads - 1) / kStepThreads;  // loads a thread a round

template <int W>
__device__ __forceinline__ void load16(float (&q)[16], const float* p) {
#pragma unroll
  for (int u = 0; u < 16; ++u) q[u] = p[u * W];
}

__device__ __forceinline__ float add16(float acc, const float (&q)[16]) {
#pragma unroll
  for (int u = 0; u < 16; ++u) acc = acc + q[u];
  return acc;
}

// acc + col[0] + col[W] + ... + col[(n - 1) * W], in that order: the next
// 16 rows' reads (constant offsets from one pointer) are in flight while
// this 16's adds run, so each add waits only on the one before
template <int W>
__device__ __forceinline__ float row_chain(const float* col, int n, float acc) {
  const float* p = col;
  if (n >= 16) {
    float q[16], r[16];
    load16<W>(q, p);
    p += 16 * W;
    n -= 16;
    for (; n >= 32; n -= 32, p += 32 * W) {
      load16<W>(r, p);
      acc = add16(acc, q);
      load16<W>(q, p + 16 * W);
      acc = add16(acc, r);
    }
    if (n >= 16) {
      load16<W>(r, p);
      acc = add16(acc, q);
      acc = add16(acc, r);
      p += 16 * W;
      n -= 16;
    } else {
      acc = add16(acc, q);
    }
  }
  for (; n > 0; --n, p += W) acc = acc + *p;
  return acc;
}

// A x = b for a 6x6 A by LU with partial pivoting in float64 over one warp,
// lane r < 6 holding row r (A's row in row[0..5], b's entry in row[6]);
// returns, on every lane, 0 or (as LAPACK's getrf) the 1-based column of
// the first exactly zero pivot, in which case x is not computed; else lane
// 0 ends with x in x[0..5]. Each column: its entries reach every lane by
// shuffles and every lane picks the same pivot (the first row with the
// strictly larger |a|), lanes c and p trade rows, and lane r > c computes
// l = a[r][c] / a[c][c] and a[r][j] -= l * a[c][j]: one thread's loop's
// operations, so the same bits (--fmad=false). The 6-step back-substitution
// is a chain (row r subtracts x[r + 1] first), so lane 0 runs it.
__device__ __forceinline__ int solve6_rows(double (&row)[7], double (&x)[6], int lane) {
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    double col[6];
#pragma unroll
    for (int r = c; r < 6; ++r) col[r] = __shfl_sync(0xffffffffu, row[c], r);
    int p = c;
    double best = fabs(col[c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r)
      if (fabs(col[r]) > best) {
        best = fabs(col[r]);
        p = r;
      }
    double pivot[7];
#pragma unroll
    for (int j = c; j < 7; ++j) pivot[j] = __shfl_sync(0xffffffffu, row[j], p);
    if (p != c) {  // lane p takes row c, lane c the pivot row
#pragma unroll
      for (int j = c; j < 7; ++j) {
        const double rc = __shfl_sync(0xffffffffu, row[j], c);
        row[j] = lane == c ? pivot[j] : (lane == p ? rc : row[j]);
      }
    }
    if (pivot[c] == 0.0) return c + 1;
    if (lane > c && lane < 6) {
      const double l = row[c] / pivot[c];
#pragma unroll
      for (int j = c + 1; j < 7; ++j) row[j] -= l * pivot[j];
    }
  }
  double u[6][7];  // the upper triangle and the eliminated b, on every lane
#pragma unroll
  for (int r = 0; r < 6; ++r)
#pragma unroll
    for (int j = r; j < 7; ++j) u[r][j] = __shfl_sync(0xffffffffu, row[j], r);
  if (lane == 0)
#pragma unroll
    for (int r = 5; r >= 0; --r) {
      double s = u[r][6];
#pragma unroll
      for (int j = r + 1; j < 6; ++j) s -= u[r][j] * x[j];
      x[r] = s / u[r][r];
    }
  return 0;
}

// The next candidate from the lane's accepted state (the top of the
// reference's loop body), by warp 0 on the state staged in shared memory:
// the ridge, the `dof` projection (the ground NDT; dof_bits < 0: every
// dimension free) and the system over the lanes, the solve, then lane 0 the
// step.
__device__ void propose(float* st, int* si, float step_min, int dof_bits, int lane) {
  float* g = st + F_GRAD;
  float* h = st + F_HESS;
  float tr = 0.0f;  // every lane, in the same order
  for (int i = 0; i < 6; ++i) tr += fabsf(h[7 * i]);
  const float ridge = 1e-6f * tr / 6.0f + 1e-12f;
  if (dof_bits >= 0) {  // freeze the masked dims, pin their diagonal
    __syncwarp();       // every lane has read the diagonal
    for (int e = lane; e < 36; e += 32) {
      const int i = e / 6, j = e % 6;
      const float mi = (dof_bits >> i) & 1 ? 1.0f : 0.0f, mj = (dof_bits >> j) & 1 ? 1.0f : 0.0f;
      h[e] = (h[e] * mi) * mj - (1.0f - mj) * (i == j ? 1.0f : 0.0f);
    }
    if (lane < 6) g[lane] = g[lane] * ((dof_bits >> lane) & 1 ? 1.0f : 0.0f);
    __syncwarp();
  }
  double row[7] = {}, x[6];  // lane r < 6: row r of H + ridge I, and -g[r]
  if (lane < 6) {
#pragma unroll
    for (int j = 0; j < 6; ++j) row[j] = static_cast<double>(h[6 * lane + j] + (lane == j ? ridge : 0.0f));
    row[6] = -static_cast<double>(g[lane]);
  }
  const int info = solve6_rows(row, x, lane);
  if (lane != 0) return;
  float delta[6], gv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    delta[i] = info ? 0.0f : static_cast<float>(x[i]);
    gv[i] = g[i];
  }
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) sq += delta[i] * delta[i];
  const float norm = sqrtf(sq);
  const bool bad = norm == 0.0f || !isfinite(norm) || info != 0;
  const float den = bad ? 1.0f : norm;
  float dir[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) dir[i] = delta[i] / den;
  float dphi0 = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) dphi0 += gv[i] * dir[i];
  if (-dphi0 > 0.0f)
#pragma unroll
    for (int i = 0; i < 6; ++i) dir[i] = -dir[i];
  // clamp(norm, min=step_min) then minimum with cap, NaN-propagating as torch's
  const float lo = norm < step_min ? step_min : norm;
  const float cap = st[F_CAP];
  const float alpha = cap < lo ? cap : lo;
  float xi[6], e[16], t[16], cand[16];
#pragma unroll
  for (int i = 0; i < 6; ++i) xi[i] = alpha * dir[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = st[F_T + i];
  lvs::exp_se3(xi, e);
  lvs::matmul44(e, t, cand);
#pragma unroll
  for (int i = 0; i < 16; ++i) st[F_CAND + i] = cand[i];
  st[F_ALPHA] = alpha;
  si[S_BAD] = bad;
}

// One Newton iteration per lane: partials (n_lanes, n_blocks, 43) from the
// derivative pass at the lane's candidate; state f (n_lanes, 80), s
// (n_lanes, 4). A cluster of kStepCluster blocks a lane: block g sums
// columns [g * kWidth, ...) and stores them into rank 0's shared memory
// with async stores that complete rank 0's mbarrier, and rank 0 runs the
// step; dynamic shared memory for min(n_blocks, kStepRows) rows of the
// slice.
__global__ void __launch_bounds__(kStepThreads)
newton_step(const float* __restrict__ partials, int n_blocks, float* __restrict__ f, int* __restrict__ s, float eps,
            float step_min, float step_max, int max_iterations, int dof_bits) {
  static_assert(kWidth <= kStepThreads && kF <= kStepThreads, "a thread per column of the slice and per state float");
  const int c = blockIdx.x / kStepCluster, rank = blockIdx.x % kStepCluster, tid = threadIdx.x;
  const int c0 = rank * kWidth, w = min(kWidth, kTerms - c0);  // this block's columns
  float* f_row = f + kF * c;
  int* s_row = s + kS * c;
  if (s_row[S_DONE]) return;  // the gate: the lane's blocks return, nothing is written
  extern __shared__ float rows[];  // a round's rows of the slice, row-major
  __shared__ float sums[kTerms];
  __shared__ float st[kF];
  __shared__ int si[kS];
  __shared__ __align__(8) unsigned long long sums_landed;  // rank 0: the other blocks' sums
  if (rank == 0 && tid == 0) {  // one arrival, and the other blocks' 4 (43 - kWidth) bytes
    const uint32_t bar = shared_address(&sums_landed);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(4 * (kTerms - kWidth))
                 : "memory");
  }
  cluster_arrive_relaxed();  // this block runs (rank 0: its mbarrier is set); each waits before a remote store
  const float* lane_rows = partials + static_cast<long long>(kTerms) * n_blocks * c + c0;
  float acc = 0.0f;
  for (int r0 = 0; r0 < n_blocks; r0 += kStepRows) {
    // every thread's loads of the round issued together, then stored
    const int nr = min(kStepRows, n_blocks - r0), n_el = nr * kWidth;
    const float* src = lane_rows + static_cast<long long>(r0) * kTerms;
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int x = tid + u * kStepThreads, col = x % kWidth;
      v[u] = x < n_el && col < w ? __ldg(src + (x / kWidth) * kTerms + col) : 0.0f;
    }
    if (r0 == 0 && rank == 0) {  // the state row, while the rows load
      if (tid < kF) st[tid] = f_row[tid];
      if (tid < kS) si[tid] = s_row[tid];
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int x = tid + u * kStepThreads;
      if (x < n_el) rows[x] = v[u];
    }
    __syncthreads();
    if (tid < w) acc = row_chain<kWidth>(rows + tid, nr, acc);
    __syncthreads();  // the chains have read this round before the next overwrites it
  }
  cluster_wait();  // every block of the cluster runs
  if (tid < w) {
    if (rank == 0)
      sums[tid] = acc;
    else
      store_to_rank0(in_rank(shared_address(sums + c0 + tid), 0), in_rank(shared_address(&sums_landed), 0), acc);
  }
  if (rank != 0) return;  // a block of the cluster past rank 0 has sent its sums
  __syncthreads();        // rank 0's own sums and the staged state
  if (tid >= 32) return;
  wait_phase0(shared_address(&sums_landed));  // and the other blocks' sums

  // every lane: the accept test and the stopping tests on the staged state
  // (the same reads give the same answers), then the copies spread over the
  // lanes and lane 0's scalar updates
  const int lane = tid;
  const float new_score = sums[0];
  const bool started = si[S_STARTED] != 0, bad = si[S_BAD] != 0;
  const float alpha = st[F_ALPHA], halved = st[F_CAP] * 0.5f;
  const bool accept = started && !bad && new_score >= st[F_SCORE];
  const int it = si[S_IT] + 1;
  // the derivatives at the guess (score0, grad0, hess0), or the accepted candidate's
  const bool done = started ? bad || it > max_iterations || (accept && alpha < eps) || (!accept && alpha <= step_min)
                            : isnan(new_score);
  __syncwarp();  // every lane has read the state
  if (!started || accept)
    for (int v = lane; v < kTerms; v += 32) st[F_SCORE + v] = sums[v];
  if (accept && lane < 16) st[F_T + lane] = st[F_CAND + lane];
  if (lane == 0) {
    st[F_CAP] = !started || accept ? step_max : (halved < step_min ? step_min : halved);
    si[S_IT] = started ? it : 0;
    si[S_STARTED] = 1;
    si[S_DONE] = done;
  }
  __syncwarp();
  if (!done) propose(st, si, step_min, dof_bits, lane);
  __syncwarp();
  for (int v = lane; v < kF; v += 32) f_row[v] = st[v];
  if (lane < kS) s_row[lane] = si[lane];
}

// Launches newton_step over n_lanes lanes (0 or a CUDA error).
int launch_step(const float* partials, int n_blocks, float* f, int* s, int n_lanes, float eps, float step_min,
                float step_max, int max_iterations, int dof_bits, cudaStream_t stream) {
  if (n_lanes <= 0) return 0;
  const int smem = min(max(n_blocks, 1), kStepRows) * kWidth * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(newton_step, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute cluster = {};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kStepCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_lanes * kStepCluster);
  config.blockDim = dim3(kStepThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, newton_step, partials, n_blocks, f, s, eps, step_min, step_max,
                                             max_iterations, dof_bits);
  return err != cudaSuccess ? static_cast<int>(err) : static_cast<int>(cudaGetLastError());
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
  return launch_step(partials, n_blocks, f, s, n_lanes, eps, step_min, step_max, max_iterations, dof_bits, stream);
}
