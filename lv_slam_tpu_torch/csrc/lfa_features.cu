// Kernel 8: LOAM feature extraction over a range image.
//
// Replaces: lv_slam_tpu/lfa/features.py:176 `extract_features`, with
// project_range_image :44, compact_rows :89, _window_sum :107, curvature :115,
// _local_extrema :126, _sector_topk :139 and _compact :157.
//
// What bounds it on the card: latency, not bytes or flops. Per scan it reads
// 131072 lanes (1.6 MB) once and writes 15360 feature rows; the arithmetic
// (two atan2 per lane, an 11-wide window per cell) is a few MFLOP. What is
// left is the chain within a ring: its compaction, curvature, top-k and the
// picks' places, so the design runs each (ring, sector)'s whole chain in one
// block, over the ring's row in shared memory, with every block of the grid
// at work at once.
//
// Both atan2 run in double and round to float: float atan2 differs by an ulp
// between the CPU and the card, enough to move a point across a ring or
// column edge, and the correctly rounded value is the same everywhere.
//
// Design, three launches on the caller's stream:
// 1. `fill_best` sets the rings x 1800 winner table to the invalid pack
//    2^30, writes the sentinel padding into every row of the four clouds
//    and zeroes the placement's ticket and look-back words (it stays a
//    kernel, not a memset: it has those other rows to write).
// 2. `project`, one thread per lane: ring from the elevation, column from
//    the azimuth, and an atomicMin of the int32 pack (range_cm << 17 | lane).
//    The minimum of a set does not depend on the order of the atomics, so the
//    winners are deterministic and those of the reference's scatter-min.
//    Division by a constant is a multiply by the folded float32 reciprocal
//    (`ring_scale`, `col_scale`), as XLA compiles the reference.
// 3. `select_sector`, one block of 256 threads per (ring, sector), 384 at
//    the flagship's 64 x 6, taken in (ring, sector) order from a ticket:
//    - the stable compaction of the ring's valid cells is a block prefix sum
//      over its 1800-entry winner row, recomputed by each of the ring's
//      sector blocks (7 KB from L2);
//    - the sector's compacted columns with a 7-column halo on each side
//      (the +-5 curvature window around the +-2 extrema), wrapped around
//      the whole row as jnp.roll wraps, go to shared memory; past the
//      ring's valid count a column is a zero point, invalid;
//    - curvature with the reference's summation order (total = (total +
//      x[i-j]) + x[i+j], j = 1..5; diff = sum - 10 p), then the +-2 maxima
//      and the edge / surf flags;
//    - top-k without k rescans: each column with a finite score (eligible:
//      c for an edge, -c for a surf) is one packed key (the score's
//      order-preserving float bits, then the inverted column), and its
//      place is the number of finite keys above it (larger score first,
//      the lower column on ties: lax.top_k's order); the other columns
//      (score -inf) follow in column order, numbered by the same block scan
//      that compacts the finite keys. The picks are the first k places; a
//      pick is good where its column is eligible (the twin's gather of ok);
//    - placement: warp 0 counts the good edge picks (all k, and the first
//      k_sharp), warp 1 the surf picks, and four warps take their clouds'
//      offsets after every earlier (ring, sector) by decoupled look-back,
//      32 earlier sectors a round trip (csrc/key_sort.cuh); then each good
//      pick is written at its offset
//      plus its rank among the good ones, the order of the reference's
//      stable compaction. Picks past a cap are dropped.
// Replaced (PR 2's design): `rows`, one block per ring (64 of 132 SMs),
// took the top-k by k sequential warp arg-max rounds that each rescanned
// the sector; `compact`, one block, wrote every pick serially per (ring,
// sector). Rejected: per-lane sorted heads merged by one warp reduction per
// pick (k dependent rounds again, 85 at VLP-16's less-flat k); a bitonic
// sort of the sector's 512 keys in shared memory (45 barrier steps; slower
// than the ranks when the two were timed on the card).
#include "common.cuh"
#include "key_sort.cuh"

#include <math.h>

namespace {

namespace ks = lvs::keysort;

constexpr int kInvalid = 1 << 30;
constexpr int kLaneBits = 17;
constexpr int kMaxAzimuth = 2048;
constexpr int kSelectThreads = 256;
constexpr int kMaxPer = kMaxAzimuth / kSelectThreads;  // winner cells a thread scans
constexpr int kMaxWidth = 1024;                        // sector columns: the sort's size
constexpr int kHalo = 7;                               // +-5 curvature window around the +-2 extrema
constexpr int kMaxWindow = kMaxWidth + 2 * kHalo;

enum : unsigned char { kValid = 1, kEdge = 2, kSurf = 4 };

struct Cloud {
  float* xyz;
  bool* mask;
  int cap;
};

struct Clouds {
  Cloud c[4];  // sharp, less sharp, flat, less flat
};

__global__ void fill_best(int* __restrict__ best, int cells, unsigned* __restrict__ status, int n_status,
                          Clouds out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < cells) best[i] = kInvalid;
  if (i < n_status) status[i] = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (i < out.c[k].cap) {
      out.c[k].xyz[3 * i + 0] = lvs::kSentinel;
      out.c[k].xyz[3 * i + 1] = lvs::kSentinel;
      out.c[k].xyz[3 * i + 2] = lvs::kSentinel;
      out.c[k].mask[i] = false;
    }
  }
}

__global__ void project(const float* __restrict__ xyz, const bool* __restrict__ mask, int n,
                        int n_rings, int n_az, float min_range, float max_elev, float ring_scale,
                        float col_scale, float rad2deg, float pi, int* __restrict__ best) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !mask[i]) return;
  float x = xyz[3 * i + 0], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
  float xx = x * x, yy = y * y, zz = z * z;
  float rng = sqrtf((xx + yy) + zz);
  if (!(rng > min_range)) return;
  // atan2 in double, rounded to float: the plain twin's `_atan2`
  float elev = static_cast<float>(atan2(static_cast<double>(z), static_cast<double>(sqrtf(xx + yy)))) * rad2deg;
  int ring = static_cast<int>(rintf((max_elev - elev) * ring_scale));
  if (ring < 0 || ring >= n_rings) return;
  float azim = static_cast<float>(atan2(static_cast<double>(y), static_cast<double>(x)));
  int col = static_cast<int>(floorf((azim + pi) * col_scale));
  col = min(max(col, 0), n_az - 1);
  int rq = min(max(static_cast<int>(rng * 100.0f), 0), (1 << 13) - 1);
  atomicMin(&best[ring * n_az + col], (rq << kLaneBits) | i);
}

// A column's sort key: the score's order-preserving bits, then the inverted
// column, so a descending sort puts the larger score first and the lower
// column first on ties. -0 reads as +0 (the twin's sort holds them equal).
__device__ __forceinline__ unsigned long long pick_key(float score, int col) {
  unsigned u = __float_as_uint(score == 0.0f ? 0.0f : score);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | (0xffffffffu - static_cast<unsigned>(col));
}

__device__ __forceinline__ int key_col(unsigned long long key) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(key));
}

// The lanes of a warp whose position r0 + lane is below `limit`.
__device__ __forceinline__ unsigned lanes_below(int limit, int r0) {
  const int m = limit - r0;
  return m >= 32 ? 0xffffffffu : (m <= 0 ? 0u : (1u << m) - 1u);
}

__global__ void __launch_bounds__(kSelectThreads) select_sector(
    const float* __restrict__ xyz, const int* __restrict__ best, int n_az, int n_sectors, int n_cells, int ke,
    int kg, int k_sharp, int k_flat, unsigned* status, Clouds out) {
  __shared__ int lanes[kMaxAzimuth];  // compacted column -> winner lane; then the top-k orders
  __shared__ float wx[kMaxWindow], wy[kMaxWindow], wz[kMaxWindow], wc[kMaxWindow];
  __shared__ unsigned char wf[kMaxWindow];
  __shared__ unsigned long long key_e[kMaxWidth], key_g[kMaxWidth];
  __shared__ int cell_id;
  __shared__ unsigned counts[4], bases[4];  // the four clouds' picks of this sector, and their offsets
  const int tid = threadIdx.x;
  if (tid == 0) cell_id = static_cast<int>(atomicAdd(status, 1u));
  __syncthreads();
  const int cell = cell_id;
  const int ring = cell / n_sectors, sector = cell % n_sectors;
  const int width = n_az / n_sectors, window = width + 2 * kHalo;
  const int* row = best + ring * n_az;

  // the ring's stable compaction: each thread owns a contiguous chunk
  const int per = (n_az + kSelectThreads - 1) / kSelectThreads;
  int win[kMaxPer];
  unsigned mine = 0;
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) {
    const int c = tid * per + m;
    win[m] = (m < per && c < n_az) ? row[c] : kInvalid;
    mine += win[m] < kInvalid;
  }
  unsigned n_valid;
  unsigned pos = ks::block_exclusive_scan(mine, &n_valid);
#pragma unroll
  for (int m = 0; m < kMaxPer; ++m) {
    if (win[m] < kInvalid) lanes[pos++] = win[m] & ((1 << kLaneBits) - 1);
  }
  __syncthreads();

  // the sector's columns and their halo, wrapped around the row
  const int first = sector * width - kHalo;
  for (int off = tid; off < window; off += kSelectThreads) {
    const int c = ((first + off) % n_az + n_az) % n_az;
    float x = 0.0f, y = 0.0f, z = 0.0f;  // pts = where(valid, image, 0)
    unsigned char f = 0;
    if (c < static_cast<int>(n_valid)) {
      const int src = lanes[c];
      x = xyz[3 * src + 0];
      y = xyz[3 * src + 1];
      z = xyz[3 * src + 2];
      f = kValid;
    }
    wx[off] = x;
    wy[off] = y;
    wz[off] = z;
    wf[off] = f;
  }
  __syncthreads();

  // curvature over the +-5 window, for the sector and 2 columns each side
  for (int off = 5 + tid; off < window - 5; off += kSelectThreads) {
    float sx = 0.0f, sy = 0.0f, sz = 0.0f, cnt = 0.0f;
    for (int j = 1; j <= 5; ++j) {
      const int l = off - j, r = off + j;
      sx = (sx + wx[l]) + wx[r];
      sy = (sy + wy[l]) + wy[r];
      sz = (sz + wz[l]) + wz[r];
      cnt = (cnt + static_cast<float>(wf[l] & kValid)) + static_cast<float>(wf[r] & kValid);
    }
    const float dx = sx - 10.0f * wx[off], dy = sy - 10.0f * wy[off], dz = sz - 10.0f * wz[off];
    const float c = (dx * dx + dy * dy) + dz * dz;
    wc[off] = ((wf[off] & kValid) && cnt >= 10.0f) ? c : -INFINITY;
  }
  __syncthreads();

  // +-2 local maxima and eligibility
  for (int i = tid; i < width; i += kSelectThreads) {
    const int off = kHalo + i;
    const float c = wc[off];
    float b = c;
    for (int j = 1; j <= 2; ++j) b = fmaxf(b, fmaxf(wc[off - j], wc[off + j]));
    const bool cok = c != -INFINITY;
    wf[off] |= (cok && c == b && c > 0.1f ? kEdge : 0) | (cok && c < 0.1f ? kSurf : 0);
  }
  __syncthreads();

  // top-k order: the columns with a finite score (eligible, score c for
  // edges and -c for surfs) ranked by key, then the others (score -inf) in
  // column order, the twin's stable descending sort. A block scan over
  // contiguous chunks of columns numbers both groups.
  int* order_e = lanes;  // the compaction's lanes are no longer needed
  int* order_g = lanes + kMaxWidth;
  const int k_e = min(ke, width), k_g = min(kg, width);
  const int chunk = (width + kSelectThreads - 1) / kSelectThreads;
  unsigned finite = 0;  // edges in the low 16 bits, surfs in the high
#pragma unroll
  for (int m = 0; m < kMaxWidth / kSelectThreads; ++m) {
    const int col = tid * chunk + m;
    if (m < chunk && col < width) {
      const float c = wc[kHalo + col];
      const unsigned char f = wf[kHalo + col];
      finite += ((f & kEdge) && isfinite(c) ? 1u : 0u) | ((f & kSurf) && isfinite(c) ? 0x10000u : 0u);
    }
  }
  unsigned totals;
  unsigned before = ks::block_exclusive_scan(finite, &totals);
  const int m_e = static_cast<int>(totals & 0xffffu), m_g = static_cast<int>(totals >> 16);
#pragma unroll
  for (int m = 0; m < kMaxWidth / kSelectThreads; ++m) {
    const int col = tid * chunk + m;
    if (m < chunk && col < width) {
      const float c = wc[kHalo + col];
      const unsigned char f = wf[kHalo + col];
      const int fe = static_cast<int>(before & 0xffffu), fg = static_cast<int>(before >> 16);
      if ((f & kEdge) && isfinite(c)) {
        key_e[fe] = pick_key(c, col);
        before += 1u;
      } else if (m_e + col - fe < k_e) {
        order_e[m_e + col - fe] = col;
      }
      if ((f & kSurf) && isfinite(c)) {
        key_g[fg] = pick_key(-c, col);
        before += 0x10000u;
      } else if (m_g + col - fg < k_g) {
        order_g[m_g + col - fg] = col;
      }
    }
  }
  __syncthreads();
  // a finite column's place is the number of finite keys above its own
  for (int i = tid; i < max(m_e, m_g); i += kSelectThreads) {
    if (i < m_e) {
      const unsigned long long mine = key_e[i];
      int rank = 0;
      for (int j = 0; j < m_e; ++j) rank += key_e[j] > mine;
      if (rank < k_e) order_e[rank] = key_col(mine);
    }
    if (i < m_g) {
      const unsigned long long mine = key_g[i];
      int rank = 0;
      for (int j = 0; j < m_g; ++j) rank += key_g[j] > mine;
      if (rank < k_g) order_g[rank] = key_col(mine);
    }
  }
  __syncthreads();

  // placement: warp 0 counts the edge picks (sharp, less sharp), warp 1 the
  // surf picks (flat, less flat); warp c takes cloud c's offset
  const int warp = tid >> 5, lane = tid & 31;
  const bool surf = warp == 1;
  const int* order = surf ? order_g : order_e;
  const unsigned char need = surf ? kSurf : kEdge;
  const int k_all = surf ? k_g : k_e;
  const int k_short = min(surf ? k_flat : k_sharp, k_all);
  const unsigned lt = (1u << lane) - 1u;
  if (warp < 2) {
    unsigned n_all = 0, n_short = 0;
    for (int r0 = 0; r0 < k_all; r0 += 32) {
      const int r = r0 + lane;
      const bool good = r < k_all && (wf[kHalo + order[r]] & need);
      const unsigned ballot = __ballot_sync(0xffffffffu, good);
      n_all += __popc(ballot);
      n_short += __popc(ballot & lanes_below(k_short, r0));
    }
    if (lane == 0) {
      counts[surf ? 2 : 0] = n_short;
      counts[surf ? 3 : 1] = n_all;
    }
  }
  __syncthreads();
  if (warp < 4) {
    const unsigned b = ks::warp_lookback(status + 1 + warp * n_cells, 1, cell, 1u, counts[warp]);
    if (lane == 0) bases[warp] = b;
  }
  __syncthreads();
  if (warp >= 2) return;
  const Cloud c_short = surf ? out.c[2] : out.c[0];
  const Cloud c_all = surf ? out.c[3] : out.c[1];
  const unsigned base_short = bases[surf ? 2 : 0], base_all = bases[surf ? 3 : 1];
  unsigned seen = 0;
  for (int r0 = 0; r0 < k_all; r0 += 32) {
    const int r = r0 + lane;
    const int off = r < k_all ? kHalo + order[r] : 0;
    const bool good = r < k_all && (wf[off] & need);
    const unsigned ballot = __ballot_sync(0xffffffffu, good);
    const unsigned rank = seen + __popc(ballot & lt);
    seen += __popc(ballot);
    if (!good) continue;
    const float x = wx[off], y = wy[off], z = wz[off];
    unsigned at = base_all + rank;
    if (at < static_cast<unsigned>(c_all.cap)) {
      c_all.xyz[3 * at + 0] = x;
      c_all.xyz[3 * at + 1] = y;
      c_all.xyz[3 * at + 2] = z;
      c_all.mask[at] = true;
    }
    at = base_short + rank;  // the good picks below k_short lead the good ones
    if (r < k_short && at < static_cast<unsigned>(c_short.cap)) {
      c_short.xyz[3 * at + 0] = x;
      c_short.xyz[3 * at + 1] = y;
      c_short.xyz[3 * at + 2] = z;
      c_short.mask[at] = true;
    }
  }
}

}  // namespace

extern "C" int lvs_extract_features(const float* xyz, const bool* mask, int n, int n_rings,
                                    int n_az, int n_sectors, float min_range, float max_elev,
                                    float ring_scale, float col_scale, float rad2deg, float pi,
                                    int ke, int kg, int k_sharp, int k_flat, int* best, unsigned* status,
                                    float* sharp, bool* sharp_mask, int cap_s, float* less_sharp,
                                    bool* less_sharp_mask, int cap_ls, float* flat,
                                    bool* flat_mask, int cap_f, float* less_flat,
                                    bool* less_flat_mask, int cap_lf, cudaStream_t stream) {
  if (n_az > kMaxAzimuth || n_sectors < 1 || n_az / n_sectors > kMaxWidth || n_az / n_sectors < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cells = n_rings * n_az;
  const int n_cells = n_rings * n_sectors;
  const int n_status = 1 + 4 * n_cells;
  const Clouds out{{{sharp, sharp_mask, cap_s}, {less_sharp, less_sharp_mask, cap_ls}, {flat, flat_mask, cap_f},
                    {less_flat, less_flat_mask, cap_lf}}};
  int fill = cells > n_status ? cells : n_status;
  for (const Cloud& c : out.c) fill = c.cap > fill ? c.cap : fill;
  fill_best<<<lvs::blocks_for(fill), lvs::kThreads, 0, stream>>>(best, cells, status, n_status, out);
  if (n > 0)
    project<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(xyz, mask, n, n_rings, n_az, min_range,
                                                              max_elev, ring_scale, col_scale,
                                                              rad2deg, pi, best);
  if (n_cells > 0)
    select_sector<<<n_cells, kSelectThreads, 0, stream>>>(xyz, best, n_az, n_sectors, n_cells, ke, kg, k_sharp,
                                                          k_flat, status, out);
  LVS_RETURN_LAST_ERROR();
}
