// Kernel 8: LOAM feature extraction over a range image.
//
// Replaces: lv_slam_tpu/lfa/features.py:176 `extract_features`, with
// project_range_image :44, compact_rows :89, _window_sum :107, curvature :115,
// _local_extrema :126, _sector_topk :139 and _compact :157.
//
// What bounds it on the card: latency, not bytes or flops. Per scan it reads
// 131072 lanes (1.6 MB) once and writes 15360 feature rows; the arithmetic
// (two atan2 per lane, an 11-wide window per cell) is a few MFLOP. The work
// between the launches is serial within a ring, so the design keeps each
// ring's row in shared memory and runs its whole chain in one block.
//
// Both atan2 run in double and round to float: float atan2 differs by an ulp
// between the CPU and the card, enough to move a point across a ring or
// column edge, and the correctly rounded value is the same everywhere.
//
// Design, four launches on the caller's stream:
// 1. `fill_best` sets the 64 x 1800 winner table to the invalid pack 2^30.
// 2. `project`, one thread per lane: ring from the elevation, column from
//    the azimuth, and an atomicMin of the int32 pack (range_cm << 17 | lane).
//    The minimum of a set does not depend on the order of the atomics, so the
//    winners are deterministic and those of the reference's scatter-min.
//    Division by a constant is a multiply by the folded float32 reciprocal
//    (`ring_scale`, `col_scale`), as XLA compiles the reference.
// 3. `rows`, one block of 1024 threads per ring: the stable compaction of the
//    ring's valid cells is a block prefix sum; the compacted row lives in
//    shared memory, where the +-5 curvature window and the +-2 extrema wrap
//    around the row as jnp.roll does, with the reference's summation order
//    (total = (total + x[i-j]) + x[i+j], j = 1..5; diff = sum - 10 p). Then
//    one warp per (sector, list) takes the top-k by repeated warp arg-max:
//    larger score first, the lower column on ties (lax.top_k's rule). A pick
//    is good exactly while its score is finite, so each (ring, sector) writes
//    its good picks and their count.
// 4. `compact`, one block: exclusive prefix sums of the per-(ring, sector)
//    counts place every good pick of the four clouds in (ring, sector, rank)
//    order, the order of the reference's stable compaction; the rest of each
//    cap is sentinel padding.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kInvalid = 1 << 30;
constexpr int kLaneBits = 17;
constexpr int kMaxAzimuth = 2048;
constexpr int kRowThreads = 1024;
constexpr int kMaxPerLane = kMaxAzimuth / 32;  // sector columns a warp lane holds

enum : unsigned char { kValid = 1, kCok = 2, kEdge = 4, kSurf = 8 };

__global__ void fill_best(int* best, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) best[i] = kInvalid;
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

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// every thread gets its offset and the block total.
__device__ int block_exclusive_scan(int v, int* total, int* scratch) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  int inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    int o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? scratch[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      int o = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += o;
    }
    scratch[lane] = w;  // inclusive warp totals
  }
  __syncthreads();
  int base = warp > 0 ? scratch[warp - 1] : 0;
  *total = scratch[n_warps - 1];
  __syncthreads();  // scratch is reused by the next call
  return base + inc - v;
}

__device__ __forceinline__ bool better(float sa, int ca, float sb, int cb) {
  return sa > sb || (sa == sb && ca < cb);
}

__global__ void rows(const float* __restrict__ xyz, const int* __restrict__ best, int n_az,
                     int n_sectors, int ke, int kg, float* __restrict__ pick_e,
                     int* __restrict__ cnt_e, float* __restrict__ pick_g, int* __restrict__ cnt_g) {
  __shared__ float px[kMaxAzimuth], py[kMaxAzimuth], pz[kMaxAzimuth], pc[kMaxAzimuth];
  __shared__ unsigned char flag[kMaxAzimuth];
  __shared__ int scratch[32];
  const int ring = blockIdx.x;
  const int* row = best + ring * n_az;

  // stable compaction: each thread owns a contiguous chunk of columns
  int per = (n_az + blockDim.x - 1) / blockDim.x;
  int c0 = threadIdx.x * per, c1 = min(c0 + per, n_az);
  int mine = 0;
  for (int c = c0; c < c1; ++c) mine += row[c] < kInvalid;
  int n_valid;
  int pos = block_exclusive_scan(mine, &n_valid, scratch);
  for (int c = c0; c < c1; ++c) {
    int b = row[c];
    if (b < kInvalid) {
      int src = b & ((1 << kLaneBits) - 1);
      px[pos] = xyz[3 * src + 0];
      py[pos] = xyz[3 * src + 1];
      pz[pos] = xyz[3 * src + 2];
      flag[pos] = kValid;
      ++pos;
    }
  }
  for (int c = n_valid + threadIdx.x; c < n_az; c += blockDim.x) {
    px[c] = 0.0f;  // pts = where(valid, image, 0)
    py[c] = 0.0f;
    pz[c] = 0.0f;
    flag[c] = 0;
  }
  __syncthreads();

  // curvature over the wrapped +-5 window
  for (int i = threadIdx.x; i < n_az; i += blockDim.x) {
    float sx = 0.0f, sy = 0.0f, sz = 0.0f, cnt = 0.0f;
    for (int j = 1; j <= 5; ++j) {
      int l = (i - j + n_az) % n_az, r = (i + j) % n_az;
      sx = (sx + px[l]) + px[r];
      sy = (sy + py[l]) + py[r];
      sz = (sz + pz[l]) + pz[r];
      cnt = (cnt + static_cast<float>(flag[l] & kValid)) + static_cast<float>(flag[r] & kValid);
    }
    float dx = sx - 10.0f * px[i], dy = sy - 10.0f * py[i], dz = sz - 10.0f * pz[i];
    float c = (dx * dx + dy * dy) + dz * dz;
    bool cok = (flag[i] & kValid) && cnt >= 10.0f;
    pc[i] = cok ? c : -INFINITY;
  }
  __syncthreads();

  // +-2 local maxima (wrapped), edge / surf eligibility
  unsigned char fl[(kMaxAzimuth + kRowThreads - 1) / kRowThreads];
  for (int i = threadIdx.x, m = 0; i < n_az; i += blockDim.x, ++m) {
    float c = pc[i];
    float b = c;
    for (int j = 1; j <= 2; ++j) {
      b = fmaxf(b, fmaxf(pc[(i - j + n_az) % n_az], pc[(i + j) % n_az]));
    }
    bool cok = c != -INFINITY;
    unsigned char f = flag[i];
    if (cok) f |= kCok;
    if (cok && c == b && c > 0.1f) f |= kEdge;
    if (cok && c < 0.1f) f |= kSurf;
    fl[m] = f;
  }
  __syncthreads();
  for (int i = threadIdx.x, m = 0; i < n_az; i += blockDim.x, ++m) flag[i] = fl[m];
  __syncthreads();

  // top-k per (sector, list): warp w < n_sectors takes edges, the next
  // n_sectors warps take surfs
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int width = n_az / n_sectors;
  for (int task = warp; task < 2 * n_sectors; task += blockDim.x >> 5) {
    bool surf = task >= n_sectors;
    int s = surf ? task - n_sectors : task;
    int k = surf ? kg : ke;
    unsigned char need = surf ? kSurf : kEdge;
    int first = s * width;
    unsigned long long taken = 0ull;
    float* out = (surf ? pick_g : pick_e) + static_cast<long long>(ring * n_sectors + s) * k * 3;
    int count = 0;
    for (int r = 0; r < k; ++r) {
      float bs = -INFINITY;
      int bc = 0x7fffffff;
      for (int m = 0; m * 32 + lane < width; ++m) {
        if (taken >> m & 1ull) continue;
        int col = first + m * 32 + lane;
        float sc = (flag[col] & need) ? (surf ? -pc[col] : pc[col]) : -INFINITY;
        if (better(sc, col, bs, bc)) { bs = sc; bc = col; }
      }
      for (int d = 16; d > 0; d >>= 1) {
        float os = __shfl_xor_sync(0xffffffffu, bs, d);
        int oc = __shfl_xor_sync(0xffffffffu, bc, d);
        if (better(os, oc, bs, bc)) { bs = os; bc = oc; }
      }
      if (bs == -INFINITY) break;  // only non-finite scores remain: no more good picks
      int rel = bc - first;
      if ((rel & 31) == lane) taken |= 1ull << (rel >> 5);
      if (lane == 0) {
        out[3 * r + 0] = px[bc];
        out[3 * r + 1] = py[bc];
        out[3 * r + 2] = pz[bc];
      }
      ++count;
    }
    if (lane == 0) (surf ? cnt_g : cnt_e)[ring * n_sectors + s] = count;
  }
}

struct Cloud {
  float* xyz;
  bool* mask;
  int cap;
};

// Writes the `take` leading picks of each (ring, sector) at `offset` onwards,
// then pads the cap; `offset` / `total` come from a block scan.
__device__ void place(Cloud out, const float* picks, int k, int rs, int take, int offset, int total) {
  if (take > 0) {
    const float* src = picks + static_cast<long long>(rs) * k * 3;
    for (int r = 0; r < take; ++r) {
      int p = offset + r;
      if (p >= out.cap) break;
      out.xyz[3 * p + 0] = src[3 * r + 0];
      out.xyz[3 * p + 1] = src[3 * r + 1];
      out.xyz[3 * p + 2] = src[3 * r + 2];
      out.mask[p] = true;
    }
  }
  for (int p = min(total, out.cap) + threadIdx.x; p < out.cap; p += blockDim.x) {
    out.xyz[3 * p + 0] = lvs::kSentinel;
    out.xyz[3 * p + 1] = lvs::kSentinel;
    out.xyz[3 * p + 2] = lvs::kSentinel;
    out.mask[p] = false;
  }
}

__global__ void compact(const float* __restrict__ pick_e, const int* __restrict__ cnt_e,
                        const float* __restrict__ pick_g, const int* __restrict__ cnt_g, int n_rs,
                        int ke, int kg, int k_sharp, int k_flat, Cloud sharp, Cloud less_sharp,
                        Cloud flat, Cloud less_flat) {
  __shared__ int scratch[32];
  int t = threadIdx.x;
  int ce = t < n_rs ? cnt_e[t] : 0;
  int cg = t < n_rs ? cnt_g[t] : 0;
  int total;
  int take = min(ce, k_sharp);
  int off = block_exclusive_scan(take, &total, scratch);
  place(sharp, pick_e, ke, t, take, off, total);
  off = block_exclusive_scan(ce, &total, scratch);
  place(less_sharp, pick_e, ke, t, ce, off, total);
  take = min(cg, k_flat);
  off = block_exclusive_scan(take, &total, scratch);
  place(flat, pick_g, kg, t, take, off, total);
  off = block_exclusive_scan(cg, &total, scratch);
  place(less_flat, pick_g, kg, t, cg, off, total);
}

}  // namespace

extern "C" int lvs_extract_features(const float* xyz, const bool* mask, int n, int n_rings,
                                    int n_az, int n_sectors, float min_range, float max_elev,
                                    float ring_scale, float col_scale, float rad2deg, float pi,
                                    int ke, int kg, int k_sharp, int k_flat, int* best,
                                    float* pick_e, int* cnt_e, float* pick_g, int* cnt_g,
                                    float* sharp, bool* sharp_mask, int cap_s, float* less_sharp,
                                    bool* less_sharp_mask, int cap_ls, float* flat,
                                    bool* flat_mask, int cap_f, float* less_flat,
                                    bool* less_flat_mask, int cap_lf, cudaStream_t stream) {
  if (n_az > kMaxAzimuth || n_az / n_sectors > kMaxPerLane * 32 || n_rings * n_sectors > kRowThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  int cells = n_rings * n_az;
  fill_best<<<lvs::blocks_for(cells), lvs::kThreads, 0, stream>>>(best, cells);
  if (n > 0)
    project<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(xyz, mask, n, n_rings, n_az, min_range,
                                                              max_elev, ring_scale, col_scale,
                                                              rad2deg, pi, best);
  rows<<<n_rings, kRowThreads, 0, stream>>>(xyz, best, n_az, n_sectors, ke, kg, pick_e, cnt_e, pick_g,
                                            cnt_g);
  compact<<<1, kRowThreads, 0, stream>>>(pick_e, cnt_e, pick_g, cnt_g, n_rings * n_sectors, ke, kg,
                                         k_sharp, k_flat, Cloud{sharp, sharp_mask, cap_s},
                                         Cloud{less_sharp, less_sharp_mask, cap_ls},
                                         Cloud{flat, flat_mask, cap_f},
                                         Cloud{less_flat, less_flat_mask, cap_lf});
  LVS_RETURN_LAST_ERROR();
}
