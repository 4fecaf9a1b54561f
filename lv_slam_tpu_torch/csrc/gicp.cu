// Kernels 19a and 19b: GICP's plane-regularized covariances and its normal
// equations.
//
// Replaces: lv_slam_tpu/ops/gicp.py:31 `_plane_covariances` (with the
// target covariance computed inline in `gicp_align`'s body, :71-83) (19a),
// and the normal equations of :48 `gicp_align` (:86-99) (19b).
//
// What bounds it on the card: 19a reads the flags that choose its lanes
// (the mask, or K19b's three lane inputs), and the 8 valid flags and the
// neighbours (104 bytes) of a chosen lane, and writes a 3x3 (36 bytes) per
// lane and, with a mask, a flag, with ~600 operations per chosen lane (the
// sums and the closed-form eigh), so HBM, not arithmetic. 19b reads the ok
// flag of every lane, the match's flag and distance where it is ok, and
// the source point, its match and two 3x3 covariances (96 bytes) of each
// matched lane, with ~350 operations per matched lane; its tiles' 42-float
// rows (86 KB at 131072 lanes) stay in L2.
//
// 19a design (`plane_cov<k>`): one thread per lane, from K9k's k neighbours
// and their valid flags, k a template argument (1..8 behind a switch), so
// the weights, the neighbours and the sums stay in registers: the
// neighbours come in as 16-byte loads (six at k = 8), the flags as one
// 8-byte load; then the count, the mean and the covariance, each sum over
// the neighbours in order; K4's `eigh3x3` of cov + 1e-9 I; the regularized
// V diag(1e-3, 1, 1) V^T. The block stages its 256 x 9 results in shared
// memory and writes them as 16-byte stores. Three modes choose the lanes
// that get the matrix; the others get the identity and read no neighbour:
// every lane (the reference's body); with a mask, ok = mask & count >= 3
// (the source's covariances, ok written); with K19b's lane test, need =
// src_ok & nn_valid & nn_dist < max_dist (the target's covariances at the
// matches: K19b reads no other lane of them).
//
// 19b design (`gicp_normal`, one launch): blocks walk the 256-lane tiles
// of the parent's blocks (as many blocks as the card holds at once, or one
// a tile where fewer). A thread a lane moves the source point by the
// transform (XLA's CPU fma chain, as the plain twin's
// `se3.transform_points_fma`), forms M = C_b + R C_a R^T + 1e-6 I, inverts
// it by cofactors (nine IEEE divisions by det, as the twin divides), and
// for the lanes that are ok (source masked in, source covariance ok, a
// match within the correspondence distance) forms J^T W J and J^T W d with
// J = [I, -[y]x] (the exact forward-mode Jacobian of exp_se3(delta) T at
// delta = 0, tangent (rho, phi)) and d = y - nn. A warp's 42 sums come by
// the shuffle-down tree's pairs, traded so that each level moves half of a
// lane's values (43 shuffles a warp, not 210; a warp with no ok lane trades
// nothing), the warps in order give the tile's row; the tiles where some
// lane is ok write it and a live flag. The last block to count itself on
// the device counter stages the live rows in shared memory and adds them
// in tile order. Every sum keeps the order of the earlier two launches
// (`gicp_normal`'s block sums, `gicp_finish`'s column walk over every
// block), so the bits: deterministic, and no float atomics (their order
// flipped the LM's accept test).
#include "common.cuh"
#include "linalg3.cuh"

namespace {

constexpr int kMaxK = 8;
constexpr int kTerms = 42;  // H (6x6 row-major), then g (6)
constexpr int kRow = 44;    // a tile's partial row: the 42 sums and 2 unused floats, 16-byte aligned

// A lane's k neighbours' flags, k bytes from `src`, as the widest loads that
// their alignment allows (one 8-byte load at k = 8)
template <int K>
__device__ __forceinline__ void load_flags(const unsigned char* __restrict__ src, float (&w)[K]) {
  constexpr int kBytes = K % 8 == 0 ? 8 : K % 4 == 0 ? 4 : K % 2 == 0 ? 2 : 1;
#pragma unroll
  for (int c = 0; c < K / kBytes; ++c) {
    unsigned long long word;
    if constexpr (kBytes == 8) word = *reinterpret_cast<const unsigned long long*>(src + 8 * c);
    else if constexpr (kBytes == 4) word = *reinterpret_cast<const unsigned*>(src + 4 * c);
    else if constexpr (kBytes == 2) word = *reinterpret_cast<const unsigned short*>(src + 2 * c);
    else word = src[c];
#pragma unroll
    for (int b = 0; b < kBytes; ++b) w[kBytes * c + b] = (word >> (8 * b)) & 0xffu ? 1.0f : 0.0f;
  }
}

// A lane's k neighbours (3k floats from `src`), as 16-byte loads where 3k
// is a multiple of 4 (six at k = 8), else 8- or 4-byte ones
template <int K>
__device__ __forceinline__ void load_points(const float* __restrict__ src, float (&p)[3 * K]) {
  constexpr int kWords = (3 * K) % 4 == 0 ? 4 : (3 * K) % 2 == 0 ? 2 : 1;
#pragma unroll
  for (int c = 0; c < 3 * K / kWords; ++c) {
    if constexpr (kWords == 4) {
      float4 f = reinterpret_cast<const float4*>(src)[c];
      p[4 * c] = f.x, p[4 * c + 1] = f.y, p[4 * c + 2] = f.z, p[4 * c + 3] = f.w;
    } else if constexpr (kWords == 2) {
      float2 f = reinterpret_cast<const float2*>(src)[c];
      p[2 * c] = f.x, p[2 * c + 1] = f.y;
    } else {
      p[c] = src[c];
    }
  }
}

enum CovMode { kEvery = 0, kMask = 1, kNeed = 2 };

// K19b's lane test: the lanes whose normal-equation terms `gicp_normal` sums,
// and so the lanes of the target's covariances that it reads (`plane_cov`'s
// kNeed mode); `ops/gicp.LaneTest.lanes` is its plain form
// (the three loads issued together, not one behind another's test)
__device__ __forceinline__ bool lane_needed(const bool* __restrict__ src_ok, const bool* __restrict__ nn_valid,
                                            const float* __restrict__ nn_dist, float max_dist, long long i) {
  const bool ok = src_ok[i], valid = nn_valid[i];
  const float dist = nn_dist[i];
  return ok & valid & (dist < max_dist);
}

// mode kEvery: the regularized matrix on every lane (the reference's body).
// kMask: ok = mask & count >= 3, the matrix where ok, else the identity.
// kNeed: need = src_ok & nn_valid & nn_dist < max_dist (K19b's lane test),
// the matrix where needed (no count test), else the identity. A lane that
// gets the identity reads no neighbour. The block's 256 x 9 results are
// staged in shared memory and written as 16-byte stores.
template <int K>
__global__ void __launch_bounds__(lvs::kThreads)
plane_cov(const float* __restrict__ pts, const bool* __restrict__ valid, int n, int mode,
          const bool* __restrict__ mask, const bool* __restrict__ src_ok, const bool* __restrict__ nn_valid,
          const float* __restrict__ nn_dist, float max_dist, float* __restrict__ cov_out, bool* __restrict__ ok_out) {
  __shared__ float4 stage4[lvs::kThreads * 9 / 4];
  float* stage = reinterpret_cast<float*>(stage4);
  const long long base = static_cast<long long>(blockIdx.x) * lvs::kThreads;
  const long long i = base + threadIdx.x;
  float out[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
  if (i < n) {
    bool live = true;
    if (mode == kMask) live = mask[i];
    else if (mode == kNeed) live = lane_needed(src_ok, nn_valid, nn_dist, max_dist, i);
    bool ok = false;
    if (live) {
      float w[K], p[3 * K];
      load_flags<K>(reinterpret_cast<const unsigned char*>(valid) + K * i, w);
      float wsum = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) wsum += w[j];
      ok = mode != kMask || wsum >= 3.0f;
      if (ok) {
        load_points<K>(pts + 3 * K * i, p);
        float cnt = fmaxf(wsum, 1.0f);
        float mu[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          float s = 0.0f;
#pragma unroll
          for (int j = 0; j < K; ++j) s += p[3 * j + r] * w[j];
          mu[r] = s / cnt;
        }
        float c[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = a; b < 3; ++b) {
            float s = 0.0f;
#pragma unroll
            for (int j = 0; j < K; ++j) s += ((p[3 * j + a] - mu[a]) * w[j]) * ((p[3 * j + b] - mu[b]) * w[j]);
            c[a][b] = s / cnt;
          }
        float ev[3];
        lvs::Vec3 v[3];
        // cov + 1e-9 I, every entry added to, as the reference adds the whole matrix
        lvs::eigh3x3(c[0][0] + 1e-9f, c[0][1] + 0.0f, c[0][2] + 0.0f, c[1][1] + 1e-9f, c[1][2] + 0.0f,
                     c[2][2] + 1e-9f, ev, v);
        const float g[3] = {1e-3f, 1.0f, 1.0f};  // the reference's gicp_epsilon
        const float vm[3][3] = {{v[0].x, v[1].x, v[2].x}, {v[0].y, v[1].y, v[2].y}, {v[0].z, v[1].z, v[2].z}};
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int b = 0; b < 3; ++b)
            out[3 * a + b] =
                ((vm[a][0] * g[0]) * vm[b][0] + (vm[a][1] * g[1]) * vm[b][1]) + (vm[a][2] * g[2]) * vm[b][2];
      }
    }
    if (mode == kMask) ok_out[i] = ok;
  }
#pragma unroll
  for (int a = 0; a < 9; ++a) stage[9 * threadIdx.x + a] = out[a];
  __syncthreads();
  const int rows = static_cast<int>(n - base < lvs::kThreads ? n - base : lvs::kThreads);
  float4* dst = reinterpret_cast<float4*>(cov_out + 9 * base);
  for (int q = threadIdx.x; q < 9 * rows / 4; q += lvs::kThreads) dst[q] = stage4[q];
  const int tail = 9 * rows % 4;  // a partial last block: its last floats one by one
  if (static_cast<int>(threadIdx.x) < tail)
    cov_out[9 * base + 9 * rows - tail + threadIdx.x] = stage[9 * rows - tail + threadIdx.x];
}

template <int K>
void launch_plane_cov(const float* pts, const bool* valid, int n, int mode, const bool* mask, const bool* src_ok,
                      const bool* nn_valid, const float* nn_dist, float max_dist, float* cov, bool* ok,
                      cudaStream_t stream) {
  plane_cov<K><<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(pts, valid, n, mode, mask, src_ok, nn_valid,
                                                                 nn_dist, max_dist, cov, ok);
}

// The warp's sums of M per-lane values, each by `lvs::warp_sum`'s tree
// (lane l with lane l + 16, then + 8, + 4, + 2, + 1), so each has that
// tree's bits (a pair's sum commutes), in about M shuffles in all instead
// of 5 M: at each level a lane keeps half of its values and trades the
// other half with its partner (an odd one out is traded whole and both
// keep the sum). Sum id[j] ends on every lane that holds it, which writes
// it to out[id[j] * stride] (equal bits where two lanes write one).
template <int C, int kOff>
__device__ __forceinline__ void warp_sums_to(const float (&v)[C], const int (&id)[C], float* out, int stride) {
  constexpr int kPairs = C / 2, kNext = (C + 1) / 2;
  const bool hi = (threadIdx.x & kOff) != 0;
  float w[kNext];
  int wid[kNext];
#pragma unroll
  for (int j = 0; j < kPairs; ++j) {
    const float keep = hi ? v[2 * j + 1] : v[2 * j], send = hi ? v[2 * j] : v[2 * j + 1];
    w[j] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
    wid[j] = hi ? id[2 * j + 1] : id[2 * j];
  }
  if constexpr (C % 2 == 1) {
    w[kPairs] = v[C - 1] + __shfl_xor_sync(0xffffffffu, v[C - 1], kOff);
    wid[kPairs] = id[C - 1];
  }
  if constexpr (kOff == 1) {
#pragma unroll
    for (int j = 0; j < kNext; ++j) out[wid[j] * stride] = w[j];
  } else {
    warp_sums_to<kNext, kOff / 2>(w, wid, out, stride);
  }
}

constexpr int kWarps = lvs::kThreads / 32;
constexpr int kFinishTiles = 256;  // tiles' partial rows staged at once by the finishing block
constexpr int kChainBatch = 16;   // staged values a column's chain loads together

// The finishing block: the live tiles' partial rows (a dead tile's row is
// +0 throughout, and adding +0 to a sum that starts at +0 leaves its bits)
// in tile order, kFinishTiles at a time: their flags (the next round's
// loaded during this one's work) compacted to indices, their rows copied
// into shared memory by 16-byte cp.async copies (L2 to shared memory, every
// copy of the round in flight at once), then a chain of adds a column, from
// +0 in tile order, as the earlier `gicp_finish` added every block's row:
// two batches of kChainBatch values loaded, then their adds.
__device__ __forceinline__ void finish_tiles(const float* __restrict__ partials, const unsigned char* __restrict__ live,
                                             int n_tiles, float* __restrict__ out) {
  __shared__ __align__(16) float staged[kFinishTiles * kRow];
  __shared__ int tiles[kFinishTiles];
  __shared__ int warp_count[2][kWarps];  // by round parity: a dead round has one barrier
  constexpr int kChunks = kRow / 4;  // 16-byte copies a row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float s = 0.0f;
  unsigned char next = tid < n_tiles ? __ldcg(live + tid) : 0;  // flags other blocks wrote: L2, not L1
  for (int base = 0; base < n_tiles; base += kFinishTiles) {
    const bool on = next != 0;
    const int ahead = base + kFinishTiles + tid;
    next = ahead < n_tiles ? __ldcg(live + ahead) : 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    int* counts = warp_count[(base / kFinishTiles) & 1];
    if (lane == 0) counts[warp] = __popc(ballot);
    __syncthreads();  // the last round's chains have read `staged`; the counts are in
    int before = 0, count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? counts[w] : 0;
      count += counts[w];
    }
    if (count == 0) continue;  // a round of dead tiles adds nothing
    if (on) tiles[before + __popc(ballot & ((1u << lane) - 1u))] = base + tid;
    __syncthreads();
    for (int e = tid; e < count * kChunks; e += lvs::kThreads) {
      const int j = e / kChunks, q = e - j * kChunks;
      const float* src = partials + static_cast<long long>(tiles[j]) * kRow + 4 * q;
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(staged + j * kRow + 4 * q));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (tid < kTerms) {
      const float* col = staged + tid;
      int j = 0;
      for (; j + 2 * kChainBatch <= count; j += 2 * kChainBatch) {
        float a[kChainBatch], b[kChainBatch];
#pragma unroll
        for (int u = 0; u < kChainBatch; ++u) a[u] = col[(j + u) * kRow];
#pragma unroll
        for (int u = 0; u < kChainBatch; ++u) b[u] = col[(j + kChainBatch + u) * kRow];
#pragma unroll
        for (int u = 0; u < kChainBatch; ++u) s += a[u];
#pragma unroll
        for (int u = 0; u < kChainBatch; ++u) s += b[u];
      }
      for (; j < count; ++j) s += col[j * kRow];
    }
  }
  if (tid < kTerms) out[tid] = s;
}

// One launch: blocks walk the 256-lane tiles (tile t, t + gridDim.x, ...).
// A tile's matched lanes form their 42 terms; each warp's sums come by
// `warp_sums_to`'s tree (a warp with no matched lane writes zeros and
// trades nothing), the warps' sums in warp order give the tile's partial
// row, written with the tile's live flag where any lane matched. Each
// block then counts itself on the device counter (an acq_rel atomic after a
// block barrier); the last one adds the live rows (`finish_tiles`) and sets
// the counter back to 0 for the next call. Every sum keeps the earlier
// two-launch kernel's order, so its bits.
__global__ void __launch_bounds__(lvs::kThreads)
gicp_normal(const float* __restrict__ src, const bool* __restrict__ src_ok, const float* __restrict__ cov_a,
            const float* __restrict__ T, const float* __restrict__ nn, const float* __restrict__ nn_dist,
            const bool* __restrict__ nn_valid, const float* __restrict__ cov_b, int n, float max_dist, int n_tiles,
            float* __restrict__ partials, unsigned char* __restrict__ live, int* __restrict__ counter,
            float* __restrict__ out) {
  __shared__ float warp_sums[kTerms * kWarps];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long i = static_cast<long long>(t) * lvs::kThreads + tid;
    const bool need = i < n && lane_needed(src_ok, nn_valid, nn_dist, max_dist, i);
    float acc[kTerms];
#pragma unroll
    for (int m = 0; m < kTerms; ++m) acc[m] = 0.0f;
    if (need) {
      float y[3];
#pragma unroll
      for (int r = 0; r < 3; ++r)
        y[r] = lvs::fma64(src[3 * i + 2], T[4 * r + 2],
                          lvs::fma64(src[3 * i + 1], T[4 * r + 1], src[3 * i + 0] * T[4 * r + 0])) +
               T[4 * r + 3];
      const float* ca = cov_a + 9 * i;
      const float* cb = cov_b + 9 * i;
      float rc[3][3], m[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a)  // R C_a
#pragma unroll
        for (int b = 0; b < 3; ++b)
          rc[a][b] = (T[4 * a + 0] * ca[b] + T[4 * a + 1] * ca[3 + b]) + T[4 * a + 2] * ca[6 + b];
#pragma unroll
      for (int a = 0; a < 3; ++a)  // C_b + (R C_a) R^T + 1e-6 I
#pragma unroll
        for (int b = 0; b < 3; ++b)
          m[a][b] = (cb[3 * a + b] + ((rc[a][0] * T[4 * b + 0] + rc[a][1] * T[4 * b + 1]) + rc[a][2] * T[4 * b + 2])) +
                    (a == b ? 1e-6f : 0.0f);
      float cof[3][3];  // cofactors: inverse = cof^T / det
      cof[0][0] = m[1][1] * m[2][2] - m[1][2] * m[2][1];
      cof[0][1] = m[1][2] * m[2][0] - m[1][0] * m[2][2];
      cof[0][2] = m[1][0] * m[2][1] - m[1][1] * m[2][0];
      cof[1][0] = m[0][2] * m[2][1] - m[0][1] * m[2][2];
      cof[1][1] = m[0][0] * m[2][2] - m[0][2] * m[2][0];
      cof[1][2] = m[0][1] * m[2][0] - m[0][0] * m[2][1];
      cof[2][0] = m[0][1] * m[1][2] - m[0][2] * m[1][1];
      cof[2][1] = m[0][2] * m[1][0] - m[0][0] * m[1][2];
      cof[2][2] = m[0][0] * m[1][1] - m[0][1] * m[1][0];
      const float det = (m[0][0] * cof[0][0] + m[0][1] * cof[0][1]) + m[0][2] * cof[0][2];
      float wm[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) wm[a][b] = cof[b][a] / det;
      const float d[3] = {y[0] - nn[3 * i + 0], y[1] - nn[3 * i + 1], y[2] - nn[3 * i + 2]};
      // J (3x6) = [I, -[y]x]
      const float jac[3][6] = {{1.0f, 0.0f, 0.0f, 0.0f, y[2], -y[1]},
                               {0.0f, 1.0f, 0.0f, -y[2], 0.0f, y[0]},
                               {0.0f, 0.0f, 1.0f, y[1], -y[0], 0.0f}};
      float wj[3][6], wd[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 6; ++b) wj[a][b] = (wm[a][0] * jac[0][b] + wm[a][1] * jac[1][b]) + wm[a][2] * jac[2][b];
        wd[a] = (wm[a][0] * d[0] + wm[a][1] * d[1]) + wm[a][2] * d[2];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = 0; b < 6; ++b)
          acc[6 * a + b] = (jac[0][a] * wj[0][b] + jac[1][a] * wj[1][b]) + jac[2][a] * wj[2][b];
        acc[36 + a] = (jac[0][a] * wd[0] + jac[1][a] * wd[1]) + jac[2][a] * wd[2];
      }
    }
    if (__ballot_sync(0xffffffffu, need) != 0) {
      int id[kTerms];
#pragma unroll
      for (int m = 0; m < kTerms; ++m) id[m] = m;
      warp_sums_to<kTerms, 16>(acc, id, warp_sums + warp, kWarps);
    } else {
      for (int m = lane; m < kTerms; m += 32) warp_sums[m * kWarps + warp] = 0.0f;
    }
    const bool any = __syncthreads_or(need);
    if (any && tid < kTerms) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += warp_sums[tid * kWarps + w];
      partials[static_cast<long long>(t) * kRow + tid] = s;
    }
    if (tid == 0) live[t] = any;
    __syncthreads();  // the row is read before the next tile's warps write
  }
  // the count: a release of this block's rows and flags (ordered before it
  // by the barrier) and, for the last block, an acquire of everyone's
  __syncthreads();
  if (tid == 0) {
    int before;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;" : "=r"(before) : "l"(counter) : "memory");
    last = before == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (last) {
    finish_tiles(partials, live, n_tiles, out);
    if (tid == 0) *counter = 0;  // ready for the next call on the stream
  }
}

}  // namespace

// cov (n, 3, 3) from pts (n, k, 3) and valid (n, k), 1 <= k <= 8; mode as
// `CovMode`: kMask reads mask and writes ok (n); kNeed reads src_ok,
// nn_valid and nn_dist. pts and cov 16-byte aligned, valid 8-byte aligned.
extern "C" int lvs_plane_cov(const float* pts, const bool* valid, int n, int k, int mode, const bool* mask,
                             const bool* src_ok, const bool* nn_valid, const float* nn_dist, float max_dist,
                             float* cov, bool* ok, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || mode < kEvery || mode > kNeed || (mode == kMask && (mask == nullptr || ok == nullptr)) ||
      (mode == kNeed && (src_ok == nullptr || nn_valid == nullptr || nn_dist == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(pts) % 16 || reinterpret_cast<uintptr_t>(cov) % 16 ||
      reinterpret_cast<uintptr_t>(valid) % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n > 0) {
    switch (k) {
#define LVS_PLANE_COV(K) \
  case K:                \
    launch_plane_cov<K>(pts, valid, n, mode, mask, src_ok, nn_valid, nn_dist, max_dist, cov, ok, stream); \
    break;
      LVS_PLANE_COV(1) LVS_PLANE_COV(2) LVS_PLANE_COV(3) LVS_PLANE_COV(4)
      LVS_PLANE_COV(5) LVS_PLANE_COV(6) LVS_PLANE_COV(7) LVS_PLANE_COV(8)
#undef LVS_PLANE_COV
    }
  }
  LVS_RETURN_LAST_ERROR();
}

// out (42) = [H (6x6 row-major), g (6)]; scratch (16-byte aligned) holds lvs_gicp_normal_scratch_bytes(n)
// bytes (the tiles' partial rows and live flags); counter is one int32 that is 0 between calls on the stream.
extern "C" long long lvs_gicp_normal_scratch_bytes(int n) {
  const long long tiles = n > 0 ? (static_cast<long long>(n) + lvs::kThreads - 1) / lvs::kThreads : 1;
  return tiles * kRow * static_cast<long long>(sizeof(float)) + tiles;
}

extern "C" int lvs_gicp_normal(const float* src, const bool* src_ok, const float* cov_a, const float* T,
                               const float* nn, const float* nn_dist, const bool* nn_valid, const float* cov_b,
                               int n, float max_dist, void* scratch, long long scratch_bytes, int* counter, float* out,
                               cudaStream_t stream) {
  if (n < 0 || counter == nullptr || scratch_bytes < lvs_gicp_normal_scratch_bytes(n))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(scratch) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const int n_tiles = n > 0 ? lvs::blocks_for(n) : 1;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gicp_normal, lvs::kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int most = sms * (per_sm > 0 ? per_sm : 1);
  auto* partials = static_cast<float*>(scratch);
  auto* live = reinterpret_cast<unsigned char*>(partials + static_cast<long long>(n_tiles) * kRow);
  gicp_normal<<<n_tiles < most ? n_tiles : most, lvs::kThreads, 0, stream>>>(
      src, src_ok, cov_a, T, nn, nn_dist, nn_valid, cov_b, n, max_dist, n_tiles, partials, live, counter, out);
  LVS_RETURN_LAST_ERROR();
}
