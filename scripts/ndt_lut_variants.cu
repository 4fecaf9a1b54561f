// Design variants of the LUT pass K6L (`lv_slam_tpu_torch/csrc/ndt_lut.cu`,
// `lut_pass`), for `scripts/ndt_lut_parent.py` to time beside the shipped
// kernel in one call. It includes the shipped source: variant 0 is the
// shipped launch itself, the others are instances of this file's own copy
// of the pass (`variants::lut_pass`), which adds the knobs the shipped
// source does not carry (points a thread, a persistent grid, the hits
// compacted or not, blocks an SM, the uniforms staged or in registers):
//   0  the shipped pass (route A: 256-lane rows, a block a row, DIRECT7's
//      hits compacted with the next hit's row in flight, two blocks an SM);
//   1  route A with one round an offset (each hit's row, then its terms);
//   2  route A on a persistent grid (as many blocks as the card holds,
//      each walking rows, the next row's points in flight);
//   3  route A at three blocks an SM (80 registers: it spills);
//   4  route A at one block an SM (255 registers);
//   5  route B: 2 points a thread, 512-lane rows (other sums, other bits);
//   6  route B: 4 points a thread, 1024-lane rows;
//   7  route A with DIRECT1's uniform inputs (T, the origin, the offset,
//      `done`) staged in shared memory behind a barrier, as a probe group's
//      are, not loaded into every thread's registers.
// Build (the chip has nvcc; scripts/ndt_lut_parent.py does it):
//   nvcc <kernels/_build.py's flags> -shared -I lv_slam_tpu_torch/csrc \
//        -o libndt_lut_variants.so scripts/ndt_lut_variants.cu
#include "ndt_lut.cu"

namespace {
namespace variants {

constexpr int kVariants = 8;

// The P points of this thread in row `row` (lanes row * 256 P + t + 256 j):
// their coordinates and mask, loaded with no branch on the mask.
template <int P>
__device__ __forceinline__ void load_points(const PassArgs& a, int row, float (&x)[P][3], bool (&valid)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = row * kThreads * P + j * kThreads + threadIdx.x;
    valid[j] = false;
    x[j][0] = x[j][1] = x[j][2] = 0.0f;
    if (i < a.n) {
      valid[j] = __ldg(reinterpret_cast<const unsigned char*>(a.mask) + i) != 0;
      x[j][0] = __ldg(a.pts + i);
      x[j][1] = __ldg(a.pts + a.n + i);
      x[j][2] = __ldg(a.pts + 2 * a.n + i);
    }
  }
}

// The shipped `accumulate` for P points a thread, the hits compacted
// (kCompact) or one round an offset, each hit's row then its terms.
template <int P, int KP, bool kCompact, class U>
__device__ __forceinline__ void accumulate(const PackedMap& map, const PassArgs& a, const U& u,
                                           const float (&x)[P][3], const bool (&valid)[P], float (&acc)[kTerms]) {
  float y[P][3];
  int cell[P][3];
#pragma unroll
  for (int j = 0; j < P; ++j) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      y[j][r] = fma64(x[j][2], u.T(4 * r + 2), fma64(x[j][1], u.T(4 * r + 1), x[j][0] * u.T(4 * r + 0))) +
                u.T(4 * r + 3);
      cell[j][r] = valid[j] ? static_cast<int>(floorf(__fdiv_rn(y[j][r], a.res))) - u.origin(r) : 0;
    }
  }
  const int e = a.e;
  for (int o0 = 0; o0 < a.k; o0 += KP) {
    int leaf[P][KP];
#pragma unroll
    for (int j = 0; j < P; ++j) {
#pragma unroll
      for (int p = 0; p < KP; ++p) {
        const int o = o0 + p;
        leaf[j][p] = -1;
        if (valid[j] && o < a.k) {
          const int r0 = cell[j][0] + u.offset(o, 0);
          const int r1 = cell[j][1] + u.offset(o, 1);
          const int r2 = cell[j][2] + u.offset(o, 2);
          if (r0 >= 0 && r0 < e && r1 >= 0 && r1 < e && r2 >= 0 && r2 < e)
            leaf[j][p] = __ldg(a.lut + lvs::flat_key(r0, r1, r2, e));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (kCompact) {
        unsigned hits = 0;
#pragma unroll
        for (int p = 0; p < KP; ++p) hits |= leaf[j][p] >= 0 ? 1u << p : 0u;
        int p = hits ? __ffs(hits) - 1 : -1;
        hits &= hits - 1;
        PackedMap::Row row;
        if (p >= 0) row = map.load(pick<KP>(leaf[j], p));
        while (p >= 0) {
          const int q = hits ? __ffs(hits) - 1 : -1;
          hits &= hits - 1;
          PackedMap::Row next;
          if (q >= 0) next = map.load(pick<KP>(leaf[j], q));
          map.terms(y[j], row, a.d1, a.d2, a.weighted, acc);
          row = next;
          p = q;
        }
      } else {
#pragma unroll
        for (int p = 0; p < KP; ++p)
          if (leaf[j][p] >= 0) map.terms(y[j], map.load(leaf[j][p]), a.d1, a.d2, a.weighted, acc);
      }
    }
  }
}

// Rows blockIdx.x, + gridDim.x, ... of the pass into their partial rows,
// the next row's points in flight while this one is reduced; (x, valid)
// hold the first row's points.
template <int P, int KP, bool kCompact, class U>
__device__ __forceinline__ void walk_rows(const PackedMap& map, const PassArgs& a, const U& u, float (&x)[P][3],
                                          bool (&valid)[P]) {
  for (int row = blockIdx.x; row < a.n_rows; row += gridDim.x) {
    float cx[P][3];
    bool cv[P];
    bool any = false;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      cv[j] = valid[j];
      any |= valid[j];
#pragma unroll
      for (int r = 0; r < 3; ++r) cx[j][r] = x[j][r];
    }
    if (row + gridDim.x < a.n_rows) load_points<P>(a, row + gridDim.x, x, valid);
    // also the barrier between the last row's reduction and this one's
    if (__syncthreads_or(any)) {
      float acc[kTerms];
#pragma unroll
      for (int v = 0; v < kTerms; ++v) acc[v] = 0.0f;
      accumulate<P, KP, kCompact>(map, a, u, cx, cv, acc);
      lvs::block_partials(acc, a.partials + kTerms * static_cast<long long>(row));
    } else if (threadIdx.x < kTerms) {
      a.partials[kTerms * static_cast<long long>(row) + threadIdx.x] = 0.0f;
    }
  }
}

// The gated pass with every knob: P points a thread, KP offsets a probe
// group, the hits compacted or not, kMinBlocks blocks an SM, the uniforms
// in registers (KP = 1 only) or staged in shared memory.
template <int P, int KP, bool kCompact, int kMinBlocks, bool kRegisters>
__global__ void __launch_bounds__(kThreads, kMinBlocks) lut_pass(PackedMap map, PassArgs a) {
  static_assert(!kRegisters || KP == 1, "registers hold one offset");
  const int tid = threadIdx.x;
  float x[P][3];
  bool valid[P];
  load_points<P>(a, blockIdx.x, x, valid);
  if constexpr (kRegisters) {
    RegisterUniforms u;
#pragma unroll
    for (int i = 0; i < 12; ++i) u.t[i] = __ldg(a.T + i);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      u.org[r] = __ldg(a.origin + r);
      u.off[r] = __ldg(a.offsets + r);
    }
    if (a.done != nullptr && __ldg(a.done)) return;
    walk_rows<P, KP, kCompact>(map, a, u, x, valid);
  } else {
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
    if (staged[15]) return;
    walk_rows<P, KP, kCompact>(map, a, SharedUniforms{staged}, x, valid);
  }
}

// Launches lut_pass<...> on a persistent grid (as many blocks as the card
// holds at once, at most a block a row), or with `persistent` false a
// block a row.
template <int P, int KP, bool kCompact, int kMinBlocks, bool kRegisters = KP == 1>
int launch(const PackedMap& map, const PassArgs& a, bool persistent, cudaStream_t stream) {
  int grid = a.n_rows;
  if (persistent) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lut_pass<P, KP, kCompact, kMinBlocks, kRegisters>,
                                                  kThreads, 0);
    const int slots = sms * (per_sm > 0 ? per_sm : 1);
    grid = grid < slots ? grid : slots;
  }
  lut_pass<P, KP, kCompact, kMinBlocks, kRegisters><<<grid, kThreads, 0, stream>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

int points_per_thread(int variant) { return variant == 5 ? 2 : variant == 6 ? 4 : 1; }

template <int KP>
int dispatch(int variant, const PackedMap& map, const PassArgs& a, cudaStream_t stream) {
  constexpr bool kCompact = KP > 1;
  switch (variant) {
    case 0: return launch_pass<false>(map, a, stream);
    case 1: return launch<1, KP, false, 2>(map, a, false, stream);
    case 2: return launch<1, KP, kCompact, 2>(map, a, true, stream);
    case 3: return launch<1, KP, kCompact, 3>(map, a, false, stream);
    case 4: return launch<1, KP, kCompact, 1>(map, a, false, stream);
    case 5: return launch<2, KP, kCompact, 2>(map, a, false, stream);
    case 6: return launch<4, KP, kCompact, 2>(map, a, false, stream);
    default: return launch<1, KP, kCompact, 2, false>(map, a, false, stream);
  }
}

}  // namespace variants
}  // namespace

// Rows (partial rows of 43) that variant `variant` writes for n lanes.
extern "C" int lvs_variant_rows(int variant, int n) {
  const int lanes = kThreads * variants::points_per_thread(variant);
  return n > 0 ? (n + lanes - 1) / lanes : 1;
}

// The gated pass (`lvs_ndt_lut_partials`' arguments, the variant first).
extern "C" int lvs_variant_lut_partials(int variant, const float* packed, const int* lut, const int* origin,
                                        float res, int e, const float* xs, int n, const bool* mask, const float* T,
                                        const int* done, float d1, float d2, const int* offsets, int k,
                                        int weighted, float* partials, int n_rows, cudaStream_t stream) {
  if (variant < 0 || variant >= variants::kVariants || k < 1 || k > kMaxOffsets)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows < 1) return 0;
  const PassArgs a = pass_args(lut, origin, res, e, xs, n, mask, T, done, d1, d2, offsets, k, weighted, partials,
                               n_rows, nullptr, nullptr);
  return k == 1 ? variants::dispatch<1>(variant, PackedMap{packed}, a, stream)
                : variants::dispatch<kProbeGroup>(variant, PackedMap{packed}, a, stream);
}
