// Kernels K6L and K6G: the NDT derivative passes over the dense voxel->leaf
// LUT (the host DLO's align and its retry's arbiter, the fused odometry's
// table="lut", the mesh's sharded align).
//
// K6L replaces lv_slam_tpu/ops/ndt_soa.py:134 `ndt_derivatives_soa` (body
// :59 `accumulate_ndt_terms`, rows packed by `to_soa` :35).
//   Bound on the card: per call it reads N points (12 B each, N = 65536 on
//   the host DLO) and, per point and offset, one 4-byte LUT entry and one
//   64-byte packed row; the rows (2 MB at 32768 leaves) stay in the 50 MB L2,
//   the 64 MiB LUT does not, so each probe is a random read of device
//   memory. About 300 flops per hit: latency-bound, like kernel 4.
//
// K6G replaces lv_slam_tpu/ops/ndt.py:59 `ndt_derivatives` over
// lv_slam_tpu/ops/voxel_map.py:214 `lookup_leaves`.
//   Bound on the card: the same reads as K6L, with each hit's leaf read as
//   52 bytes from three arrays (mean, the full 3x3 inverse covariance,
//   weight) instead of one packed row; about 400 flops per hit.
//
// Design: one pass, `lut_pass`, for both; only the hit's row and its terms
// differ (`PackedMap`, `GenericMap`). What it does about its latency chain
// (the earlier pass made done -> T / origin / offsets -> LUT entry -> row ->
// terms dependent loads a thread, and DIRECT7's seven offsets one after
// another):
// - the uniform inputs (T, the origin, the offsets, the gate `done`) are
//   read together with the first row's points: for DIRECT1 into every
//   thread's registers, with no barrier; for a probe group staged in shared
//   memory, one load a thread from a selected address (a load in each of
//   four branches made warp 0, and so the block's barrier, wait four
//   latencies; DIRECT1 staged so is measured slower, a variant). One memory
//   latency stands before the cells; the gate still returns before any
//   store, so a finished candidate writes nothing;
// - keys first: every offset's LUT entry of a group (DIRECT7 is one group)
//   is in flight together; then the hits, taken in offset order from a bit
//   mask, the next hit's row in flight during this hit's terms, so DIRECT7's
//   14 dependent latencies become about 2, and a warp runs as many terms as
//   its lane with the most hits, not a round for every offset any lane hits;
// - a block a row; a row with no valid lane writes its zero row without
//   probing (K21 puts the valid lanes first, so the tail rows are empty).
//   A persistent grid whose blocks walk the rows, the next row's points in
//   flight during this row's reduction, measured no faster (11b's 512-row
//   passes slower), nor did several points a thread in longer rows: both
//   are in `scripts/ndt_lut_variants.cu`, not here;
// - a standalone call is one launch: each block adds one to a device
//   counter after a __threadfence(), and the block that finds itself last
//   sums the rows in row order, as `ndt_finish` does (all 256 rows loaded
//   at once and staged in shared memory, then a chain a column), and sets
//   the counter back to 0 for the next call. The counter is the wrapper's
//   memory.
// The per-point arithmetic is the earlier pass's: the transform as XLA
// compiles the reference's einsum on the CPU, fma(z, R2, fma(y, R1, x * R0))
// + t (each fma in float64, rounded once, as the plain twin), the cell by a
// true float32 division by the resolution (the reference divides by the
// map's resolution array, not by a folded reciprocal), each lane's offsets
// summed in order, each 256-lane row by `lvs::block_partials`' tree and the
// rows in row order: every partial row and every sum keeps the earlier
// kernel's bits (`scripts/ndt_lut_parent.py` holds them to it).
//
// K6G's generic formulas are the reference's arithmetic: the cross product
// y x q as XLA's fma chain, q = C d with all nine entries of C (the
// reference's icov is V diag(1/l) V^T, whose mirrored entries can differ in
// the last bit), and the Hessian's C S, S C and S C S blocks each formed as
// written, not through S C = -(C S)^T.
#include "ndt_terms.cuh"

namespace {

constexpr int kTerms = lvs::kNdtTerms;
constexpr int kThreads = lvs::kThreads;
constexpr int kMaxOffsets = 27;  // DIRECT26's 27 cells: the largest neighbourhood
constexpr int kProbeGroup = 7;   // DIRECT7's offsets: a group's LUT entries are in flight together
constexpr int kFinishRows = 256;  // rows staged in shared memory a round of the standalone call's sum

using lvs::fma64;  // float32 fma as the plain twin's `fma32` computes it

// A pass's inputs besides the map's rows, and its outputs.
struct PassArgs {
  const int* lut;
  const int* origin;
  float res;
  int e;
  const float* pts;  // K6L: xs (3, n); K6G: xyz (n, 3)
  int n;
  const bool* mask;
  const float* T;     // (4, 4) row-major: the transform, or the Newton loop's candidate
  const int* done;    // the Newton loop's gate, or null
  float d1, d2;
  const int* offsets;  // (k, 3)
  int k;
  int weighted;
  float* partials;  // (n_rows, 43)
  int n_rows;
  int* counter;  // standalone call: blocks finished; else null
  float* out;    // standalone call: (43,) sums of the rows
};

// K6L's map: a hit reads its packed row
// mu0 mu1 mu2 c00 | c01 c02 c11 c12 | c22 w pad pad in three 16-byte loads.
struct PackedMap {
  const float* packed;
  static constexpr bool kSoaPoints = true;
  struct Row {
    float4 a, b, c;
  };
  __device__ __forceinline__ Row load(int leaf) const {
    const float4* r = reinterpret_cast<const float4*>(packed + 16 * static_cast<long long>(leaf));
    return Row{__ldg(r), __ldg(r + 1), __ldg(r + 2)};
  }
  __device__ __forceinline__ void terms(const float y[3], const Row& r, float d1, float d2, int weighted,
                                        float (&acc)[kTerms]) const {
    lvs::ndt_point_terms(y, r.a.x, r.a.y, r.a.z, r.a.w, r.b.x, r.b.y, r.b.z, r.b.w, r.c.x, r.c.y, d1, d2, weighted,
                         acc);
  }
};

// One (point, leaf) contribution of the generic pass: y the transformed
// point, mu the leaf mean, C its full inverse covariance (row-major).
__device__ __forceinline__ void generic_terms(const float y[3], const float mu[3], const float (&C)[3][3],
                                              float w_leaf, float d1, float d2, int weighted,
                                              float (&acc)[kTerms]) {
  float d[3] = {y[0] - mu[0], y[1] - mu[1], y[2] - mu[2]};
  float q[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) q[r] = C[r][0] * d[0] + C[r][1] * d[1] + C[r][2] * d[2];
  float md = d[0] * q[0] + d[1] * q[1] + d[2] * q[2];
  float eterm = expf(-0.5f * d2 * md);
  float gate = d2 * eterm;
  if (!(gate <= 1.0f && gate >= 0.0f && isfinite(gate))) return;
  float w = weighted ? w_leaf : 1.0f;
  float wf = w * ((d1 * d2) * eterm);
  acc[0] += w * (-d1 * eterm);

  // g6 = [q ; y x q], the cross product as XLA's fma chain
  float g[6] = {q[0], q[1], q[2], fma64(y[1], q[2], -(y[2] * q[1])), fma64(y[2], q[0], -(y[0] * q[2])),
                fma64(y[0], q[1], -(y[1] * q[0]))};
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[1 + a] += wf * g[a];

  // S = skew(y); CS = C S, SC = S C, SCS = (S C) S, each as written
  float S[3][3] = {{0.0f, -y[2], y[1]}, {y[2], 0.0f, -y[0]}, {-y[1], y[0], 0.0f}};
  float cs[3][3], sc[3][3], scs[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      cs[a][b] = C[a][0] * S[0][b] + C[a][1] * S[1][b] + C[a][2] * S[2][b];
      sc[a][b] = S[a][0] * C[0][b] + S[a][1] * C[1][b] + S[a][2] * C[2][b];
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) scs[a][b] = sc[a][0] * S[0][b] + sc[a][1] * S[1][b] + sc[a][2] * S[2][b];
  float qy = q[0] * y[0] + q[1] * y[1] + q[2] * y[2];
  float h1 = -d2 * wf;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      float h = h1 * g[a] * g[b];
      if (a < 3 && b < 3) {
        h += wf * C[a][b];
      } else if (a < 3) {
        h += -(wf * cs[a][b - 3]);
      } else if (b < 3) {
        h += wf * sc[a - 3][b];
      } else {
        h += wf * y[a - 3] * q[b - 3] - (a == b ? wf * qy : 0.0f);  // T2
        h += -(wf * scs[a - 3][b - 3]);
      }
      acc[7 + 6 * a + b] += h;
    }
  }
}

// K6G's map: a hit's 13 loads (mean, the nine inverse-covariance entries,
// weight) issued together.
struct GenericMap {
  const float* means;
  const float* icovs;
  const float* weights;
  static constexpr bool kSoaPoints = false;
  struct Row {
    float mu[3];
    float C[3][3];
    float w;
  };
  __device__ __forceinline__ Row load(int leaf) const {
    const long long l = leaf;
    Row r;
#pragma unroll
    for (int a = 0; a < 3; ++a) r.mu[a] = __ldg(means + 3 * l + a);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) r.C[a][b] = __ldg(icovs + 9 * l + 3 * a + b);
    r.w = __ldg(weights + l);
    return r;
  }
  __device__ __forceinline__ void terms(const float y[3], const Row& r, float d1, float d2, int weighted,
                                        float (&acc)[kTerms]) const {
    generic_terms(y, r.mu, r.C, r.w, d1, d2, weighted, acc);
  }
};

// This thread's point (lane row * 256 + t): its coordinates and mask,
// loaded with no branch on the mask.
template <class Map>
__device__ __forceinline__ void load_point(const PassArgs& a, float (&x)[3], bool& valid) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  valid = false;
  x[0] = x[1] = x[2] = 0.0f;
  if (i < a.n) {
    valid = __ldg(reinterpret_cast<const unsigned char*>(a.mask) + i) != 0;
    if (Map::kSoaPoints) {
      x[0] = __ldg(a.pts + i);
      x[1] = __ldg(a.pts + a.n + i);
      x[2] = __ldg(a.pts + 2 * a.n + i);
    } else {
      x[0] = __ldg(a.pts + 3 * i);
      x[1] = __ldg(a.pts + 3 * i + 1);
      x[2] = __ldg(a.pts + 3 * i + 2);
    }
  }
}

// The pass's uniform inputs (the transform T, the origin, the offsets),
// read from the block's shared-memory staging (a probe group's: any k) ...
struct SharedUniforms {
  const int* w;  // T (12 words), the origin (3), done (1), the offsets (3 k)
  __device__ __forceinline__ float T(int i) const { return __int_as_float(w[i]); }
  __device__ __forceinline__ int origin(int r) const { return w[12 + r]; }
  __device__ __forceinline__ int offset(int o, int c) const { return w[16 + 3 * o + c]; }
};

// ... or from every thread's registers, loaded with its point and with no
// barrier before the cell (one offset: DIRECT1)
struct RegisterUniforms {
  float t[12];
  int org[3], off[3];
  __device__ __forceinline__ float T(int i) const { return t[i]; }
  __device__ __forceinline__ int origin(int r) const { return org[r]; }
  __device__ __forceinline__ int offset(int, int c) const { return off[c]; }
};

// leaf[p] for a run-time p < KP, by selects (a register array indexed at
// run time would go to local memory)
template <int KP>
__device__ __forceinline__ int pick(const int (&leaf)[KP], int p) {
  int v = leaf[0];
#pragma unroll
  for (int u = 1; u < KP; ++u) v = p == u ? leaf[u] : v;
  return v;
}

// The terms of this thread's point, if valid, over every offset, into acc.
// One offset (KP = 1): its LUT entry, then the hit's row and terms. Else per
// group of KP offsets: every LUT entry of the group in flight together, then
// the hits taken in offset order from a bit mask, the next hit's row in
// flight during this hit's terms, so a warp runs as many terms as its lane
// with the most hits (not one round an offset that any lane hits). The
// offsets are summed in order either way.
template <int KP, class Map, class U>
__device__ __forceinline__ void accumulate(const Map& map, const PassArgs& a, const U& u, const float (&x)[3],
                                           bool valid, float (&acc)[kTerms]) {
  float y[3];
  int cell[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    y[r] = fma64(x[2], u.T(4 * r + 2), fma64(x[1], u.T(4 * r + 1), x[0] * u.T(4 * r + 0))) + u.T(4 * r + 3);
    cell[r] = valid ? static_cast<int>(floorf(__fdiv_rn(y[r], a.res))) - u.origin(r) : 0;
  }
  const int e = a.e;
  for (int o0 = 0; o0 < a.k; o0 += KP) {
    int leaf[KP];
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      const int o = o0 + p;
      leaf[p] = -1;
      if (valid && o < a.k) {
        const int r0 = cell[0] + u.offset(o, 0);
        const int r1 = cell[1] + u.offset(o, 1);
        const int r2 = cell[2] + u.offset(o, 2);
        if (r0 >= 0 && r0 < e && r1 >= 0 && r1 < e && r2 >= 0 && r2 < e)
          leaf[p] = __ldg(a.lut + lvs::flat_key(r0, r1, r2, e));
      }
    }
    if constexpr (KP == 1) {
      if (leaf[0] >= 0) map.terms(y, map.load(leaf[0]), a.d1, a.d2, a.weighted, acc);
    } else {
      unsigned hits = 0;
#pragma unroll
      for (int p = 0; p < KP; ++p) hits |= leaf[p] >= 0 ? 1u << p : 0u;
      int p = hits ? __ffs(hits) - 1 : -1;
      hits &= hits - 1;
      typename Map::Row row;
      if (p >= 0) row = map.load(pick<KP>(leaf, p));
      while (p >= 0) {
        const int q = hits ? __ffs(hits) - 1 : -1;
        hits &= hits - 1;
        typename Map::Row next;
        if (q >= 0) next = map.load(pick<KP>(leaf, q));
        map.terms(y, row, a.d1, a.d2, a.weighted, acc);
        row = next;
        p = q;
      }
    }
  }
}

// The standalone call's sums: the block that finished last adds the n_rows
// partial rows in row order (`ndt_finish`'s chain a column, so its bits).
// Up to kFinishRows rows a round are loaded by all 256 threads at once
// (one L2 latency) and staged in shared memory; thread v < 43 then runs
// column v's chain, the next round's loads in flight meanwhile.
__device__ __forceinline__ void sum_rows(const float* partials, int n_rows, float* out) {
  constexpr int kSpan = kFinishRows * kTerms;
  constexpr int kPer = (kSpan + kThreads - 1) / kThreads;
  __shared__ float staged[kSpan];
  const int tid = threadIdx.x;
  float next[kPer];
  auto fetch = [&](int round) {
    const int base = round * kSpan;
    const int count = min(kFinishRows, n_rows - round * kFinishRows) * kTerms;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int idx = tid + u * kThreads;
      next[u] = idx < count ? __ldcg(partials + base + idx) : 0.0f;  // rows other blocks wrote: L2, not L1
    }
  };
  float s = 0.0f;
  fetch(0);
  for (int round = 0; round * kFinishRows < n_rows; ++round) {
    __syncthreads();  // the last round's chains have read `staged`
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int idx = tid + u * kThreads;
      if (idx < kSpan) staged[idx] = next[u];
    }
    __syncthreads();
    const int rows = min(kFinishRows, n_rows - round * kFinishRows);
    if ((round + 1) * kFinishRows < n_rows) fetch(round + 1);
    if (tid < kTerms) {
#pragma unroll 16
      for (int b = 0; b < rows; ++b) s += staged[b * kTerms + tid];
    }
  }
  if (tid < kTerms) out[tid] = s;
}

// Row blockIdx.x of the pass into its partial row; a row with no valid
// lane writes its zero row without probing.
template <int KP, class Map, class U>
__device__ __forceinline__ void pass_row(const Map& map, const PassArgs& a, const U& u, const float (&x)[3],
                                         bool valid) {
  const long long row = blockIdx.x;
  if (__syncthreads_or(valid)) {
    float acc[kTerms];
#pragma unroll
    for (int v = 0; v < kTerms; ++v) acc[v] = 0.0f;
    accumulate<KP>(map, a, u, x, valid, acc);
    lvs::block_partials(acc, a.partials + kTerms * row);
  } else if (threadIdx.x < kTerms) {
    a.partials[kTerms * row + threadIdx.x] = 0.0f;  // the tree's sum of zeros
  }
}

// The pass: a block a 256-lane row, KP offsets a probe group (1 for
// DIRECT1, else 7). The uniform inputs and the gate are read together
// with the point: for one offset by every thread into registers, else
// staged in shared memory, a word a thread. The gate returns before any
// store. Two blocks an SM (128 registers, no spill).
template <int KP, bool kFinish, class Map>
__global__ void __launch_bounds__(kThreads, 2) lut_pass(Map map, PassArgs a) {
  __shared__ int sLast;
  const int tid = threadIdx.x;
  float x[3];
  bool valid;
  load_point<Map>(a, x, valid);
  if constexpr (KP == 1) {
    RegisterUniforms u;
#pragma unroll
    for (int i = 0; i < 12; ++i) u.t[i] = __ldg(a.T + i);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      u.org[r] = __ldg(a.origin + r);
      u.off[r] = __ldg(a.offsets + r);
    }
    if (a.done != nullptr && __ldg(a.done)) return;  // the Newton loop's gate: a finished candidate writes nothing
    pass_row<KP>(map, a, u, x, valid);
  } else {
    // T (12 words), the origin (3), done (1), the offsets (3 k): a word a
    // thread, one load each from a selected address (a load in each of
    // four branches made warp 0, and so the barrier, wait four latencies)
    __shared__ int staged[16 + 3 * kMaxOffsets];
    if (tid < 16 + 3 * a.k) {
      const int* src = tid < 12    ? reinterpret_cast<const int*>(a.T) + tid
                       : tid < 15  ? a.origin + (tid - 12)
                       : tid == 15 ? (a.done != nullptr ? a.done : a.origin)
                                   : a.offsets + (tid - 16);
      const int word = __ldg(src);
      staged[tid] = tid == 15 && a.done == nullptr ? 0 : word;
    }
    __syncthreads();
    if (staged[15]) return;  // the Newton loop's gate: a finished candidate writes nothing
    pass_row<KP>(map, a, SharedUniforms{staged}, x, valid);
  }

  if constexpr (kFinish) {
    __threadfence();  // this block's rows, before its count
    __syncthreads();
    if (tid == 0) sLast = atomicAdd(a.counter, 1) == static_cast<int>(gridDim.x) - 1;
    __syncthreads();
    if (sLast) {
      __threadfence();
      sum_rows(a.partials, a.n_rows, a.out);
      if (tid == 0) *a.counter = 0;  // ready for the next call on the stream
    }
  }
}

// The pass for k offsets, a block a row: one probe group for DIRECT1,
// groups of 7 above it (DIRECT7 one group).
template <bool kFinish, class Map>
int launch_pass(const Map& map, const PassArgs& a, cudaStream_t stream) {
  if (a.k < 1 || a.k > kMaxOffsets) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_rows < 1) return 0;
  if (a.k == 1)
    lut_pass<1, kFinish><<<a.n_rows, kThreads, 0, stream>>>(map, a);
  else
    lut_pass<kProbeGroup, kFinish><<<a.n_rows, kThreads, 0, stream>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

PassArgs pass_args(const int* lut, const int* origin, float res, int e, const float* pts, int n, const bool* mask,
                   const float* T, const int* done, float d1, float d2, const int* offsets, int k, int weighted,
                   float* partials, int n_rows, int* counter, float* out) {
  return PassArgs{lut, origin, res, e, pts, n, mask, T, done, d1, d2, offsets, k, weighted, partials, n_rows,
                  counter, out};
}

}  // namespace

// xs (3, n), mask (n,), T (4, 4), packed (L, 16), lut (e^3,), partials
// (n_blocks, 43), counter: one int32 that is 0 between calls, out (43,)
extern "C" int lvs_ndt_lut_derivatives(const float* packed, const int* lut, const int* origin, float res,
                                       int e, const float* xs, int n, const bool* mask, const float* T,
                                       float d1, float d2, const int* offsets, int k, int weighted,
                                       float* partials, int n_blocks, int* counter, float* out,
                                       cudaStream_t stream) {
  return launch_pass<true>(PackedMap{packed},
                           pass_args(lut, origin, res, e, xs, n, mask, T, nullptr, d1, d2, offsets, k, weighted,
                                     partials, n_blocks, counter, out),
                           stream);
}

// xyz (n, 3), means (L, 3), icovs (L, 3, 3), weights (L,), the rest as above
extern "C" int lvs_ndt_generic_derivatives(const float* means, const float* icovs, const float* weights,
                                           const int* lut, const int* origin, float res, int e,
                                           const float* xyz, int n, const bool* mask, const float* T,
                                           float d1, float d2, const int* offsets, int k, int weighted,
                                           float* partials, int n_blocks, int* counter, float* out,
                                           cudaStream_t stream) {
  return launch_pass<true>(GenericMap{means, icovs, weights},
                           pass_args(lut, origin, res, e, xyz, n, mask, T, nullptr, d1, d2, offsets, k, weighted,
                                     partials, n_blocks, counter, out),
                           stream);
}

// The Newton loop's passes (K7, csrc/newton.cu): the transform is the
// candidate in the loop's state, the pass is skipped once `*done` is set,
// and only the partial rows are written (`newton_step` sums them).
extern "C" int lvs_ndt_lut_partials(const float* packed, const int* lut, const int* origin, float res, int e,
                                    const float* xs, int n, const bool* mask, const float* T, const int* done,
                                    float d1, float d2, const int* offsets, int k, int weighted, float* partials,
                                    int n_blocks, cudaStream_t stream) {
  return launch_pass<false>(PackedMap{packed},
                            pass_args(lut, origin, res, e, xs, n, mask, T, done, d1, d2, offsets, k, weighted,
                                      partials, n_blocks, nullptr, nullptr),
                            stream);
}

extern "C" int lvs_ndt_generic_partials(const float* means, const float* icovs, const float* weights, const int* lut,
                                        const int* origin, float res, int e, const float* xyz, int n,
                                        const bool* mask, const float* T, const int* done, float d1, float d2,
                                        const int* offsets, int k, int weighted, float* partials, int n_blocks,
                                        cudaStream_t stream) {
  return launch_pass<false>(GenericMap{means, icovs, weights},
                            pass_args(lut, origin, res, e, xyz, n, mask, T, done, d1, d2, offsets, k, weighted,
                                      partials, n_blocks, nullptr, nullptr),
                            stream);
}
