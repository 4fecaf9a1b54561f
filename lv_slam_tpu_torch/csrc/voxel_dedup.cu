// Kernels 1b, 2 and 2r: first-point-per-voxel dedup, and the keyframe
// window's gather + motion-compose in front of it (of filtered scans for K2,
// of raw scans with the distance band for K2r).
//
// Replaces: lv_slam_tpu/ops/prefilter.py:203 `voxel_dedup_first` (K1b),
// lv_slam_tpu/utils/jit_cache.py:127 `window_group_filtered_fn` (K2; the
// flush :44 and the partial merge :185 are K1b over a concatenation) and
// :78 `window_group_fn` (K2r: `window_raw_keys` here, then kernel 1's run
// reduction, csrc/voxel_downsample.cu, over the sorted keys).
//
// What bounds it on the card: memory traffic. A window group reads up to
// 16 x 131072 filtered lanes (16 bytes each), writes their moved positions
// and 64-bit keys (2.1 M rows, ~50 MB), and the compaction writes 131072
// rows; there are a few flops per lane. The 64-bit key sort between the two
// passes (torch.sort, cub's radix sort) moves more bytes than both kernels.
//
// Design: `window_keys` (or `dedup_keys` for a cloud that is already in the
// window frame) runs one thread per lane: it gathers the lane from its scan
// row, moves it with an explicit fma chain (the contraction XLA makes of the
// reference's einsum on the CPU), and writes the packed key
// kx * 2^31 + (y|z), which orders lanes exactly as the reference's stable
// two-key sort; masked lanes carry kx = 2^30 and sort last. The wrapper sorts
// the keys stably, so ties keep the lower input index, as the reference's
// iota-carrying `lax.sort` does. `dedup_mark` flags each run's first lane,
// a prefix sum numbers the runs, and `dedup_compact` writes run r's first
// lane to row r: the output is front-compacted in key order with no atomics,
// so it is deterministic and equal to the plain twin lane for lane.
//
// K2r: `window_raw_keys` runs one thread per lane of L raw (cap, 3) rows. It
// ANDs the row's `valid` flag into the mask, keeps near < |p| < far with |p|
// taken as the reference's compiled `jnp.linalg.norm` rounds it on the CPU
// (sqrtf(fma(z, z, fma(y, y, x * x))), correctly rounded), moves the lane by
// the same fma chain as K2, pins masked lanes to the sentinel and writes the
// same packed key. A raw window group reads up to 16 x 131072 lanes (20
// bytes each) and writes 24 bytes per lane; the wrapper then sorts the keys
// (the 64-bit radix sort is the largest part of the group's device time) and
// kernel 1 reduces each run to its centroid in key order.
#include "common.cuh"

namespace {

constexpr long long kBig = 1LL << 30;  // kx of masked lanes
constexpr int kYZOff = 1 << 14;
constexpr int kYZLim = (1 << 15) - 1;

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// kx * 2^31 + packed (cy, cz), coordinates floor(x * (1/res)) as the
// reference's compiled programs take them
__device__ __forceinline__ long long voxel_key(float x, float y, float z, bool valid, float inv_res) {
  long long kx = valid ? static_cast<long long>(static_cast<int>(floorf(x * inv_res))) : kBig;
  int cy = clampi(static_cast<int>(floorf(y * inv_res)) + kYZOff, 0, kYZLim);
  int cz = clampi(static_cast<int>(floorf(z * inv_res)) + kYZOff, 0, kYZLim);
  return kx * (1LL << 31) + static_cast<long long>(cy) * (1 << 15) + cz;
}

__device__ __forceinline__ bool key_valid(long long key) { return (key >> 31) < kBig; }

__global__ void dedup_keys(const float* __restrict__ xyz, const bool* __restrict__ mask, int n,
                           float inv_res, long long* __restrict__ key) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool m = mask[i];
  float x = m ? xyz[3 * i + 0] : lvs::kSentinel;
  float y = m ? xyz[3 * i + 1] : lvs::kSentinel;
  float z = m ? xyz[3 * i + 2] : lvs::kSentinel;
  key[i] = voxel_key(x, y, z, m, inv_res);
}

// lane i = l * cap + p: point p of chunk row clamp(start + l), moved by rels[l]
__global__ void window_keys(const float* __restrict__ xyz_t, const float* __restrict__ inten,
                            const bool* __restrict__ mask, int n_rows, int cap, int start, int length,
                            const float* __restrict__ rels, const bool* __restrict__ valid,
                            float inv_res, float* __restrict__ out_xyz, float* __restrict__ out_int,
                            long long* __restrict__ key) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(length) * cap) return;
  int l = static_cast<int>(i / cap), p = static_cast<int>(i % cap);
  int row = clampi(start + l, 0, n_rows - 1);
  long long base = static_cast<long long>(row) * cap;
  bool m = mask[base + p] && valid[l];
  float x = xyz_t[3 * base + p], y = xyz_t[3 * base + cap + p], z = xyz_t[3 * base + 2 * cap + p];
  const float* T = rels + 16 * l;
  float moved[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float acc = x * T[4 * r + 0];
    acc = fmaf(y, T[4 * r + 1], acc);
    acc = fmaf(z, T[4 * r + 2], acc);
    moved[r] = m ? acc + T[4 * r + 3] : lvs::kSentinel;
  }
  out_xyz[3 * i + 0] = moved[0];
  out_xyz[3 * i + 1] = moved[1];
  out_xyz[3 * i + 2] = moved[2];
  out_int[i] = inten[base + p];
  key[i] = voxel_key(moved[0], moved[1], moved[2], m, inv_res);
}

// lane i = l * cap + p: raw point p of chunk row clamp(start + l), banded,
// moved by rels[l]
__global__ void window_raw_keys(const float* __restrict__ xyz, const float* __restrict__ inten,
                                const bool* __restrict__ mask, int n_rows, int cap, int start, int length,
                                const float* __restrict__ rels, const bool* __restrict__ valid, float near,
                                float far, float inv_res, float* __restrict__ out_xyz,
                                float* __restrict__ out_int, long long* __restrict__ key) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(length) * cap) return;
  int l = static_cast<int>(i / cap), p = static_cast<int>(i % cap);
  int row = clampi(start + l, 0, n_rows - 1);
  long long lane = static_cast<long long>(row) * cap + p;
  bool m = mask[lane] && valid[l];
  float x = xyz[3 * lane + 0], y = xyz[3 * lane + 1], z = xyz[3 * lane + 2];
  float mx = m ? x : 0.0f, my = m ? y : 0.0f, mz = m ? z : 0.0f;
  float dist = sqrtf(fmaf(mz, mz, fmaf(my, my, mx * mx)));
  m = m && dist > near && dist < far;
  const float* T = rels + 16 * l;
  float moved[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float acc = x * T[4 * r + 0];
    acc = fmaf(y, T[4 * r + 1], acc);
    acc = fmaf(z, T[4 * r + 2], acc);
    moved[r] = m ? acc + T[4 * r + 3] : lvs::kSentinel;
  }
  out_xyz[3 * i + 0] = moved[0];
  out_xyz[3 * i + 1] = moved[1];
  out_xyz[3 * i + 2] = moved[2];
  out_int[i] = inten[lane];
  key[i] = voxel_key(moved[0], moved[1], moved[2], m, inv_res);
}

__global__ void dedup_mark(const long long* __restrict__ skey, int n, int* __restrict__ flag) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long k = skey[i];
  flag[i] = ((i == 0 || k != skey[i - 1]) && key_valid(k)) ? 1 : 0;
}

__global__ void dedup_compact(const long long* __restrict__ order, const int* __restrict__ flag,
                              const int* __restrict__ cum, int n, const float* __restrict__ xyz,
                              const float* __restrict__ inten, int out_cap, float* __restrict__ out_xyz,
                              float* __restrict__ out_int, bool* __restrict__ out_mask) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  int n_runs = n > 0 ? cum[n - 1] : 0;
  if (t < out_cap && t >= n_runs) {  // rows past the last voxel
    out_xyz[3 * t + 0] = lvs::kSentinel;
    out_xyz[3 * t + 1] = lvs::kSentinel;
    out_xyz[3 * t + 2] = lvs::kSentinel;
    out_int[t] = 0.0f;
    out_mask[t] = false;
  }
  if (t >= n || !flag[t]) return;
  int row = cum[t] - 1;
  if (row >= out_cap) return;
  long long src = order[t];
  out_xyz[3 * row + 0] = xyz[3 * src + 0];
  out_xyz[3 * row + 1] = xyz[3 * src + 1];
  out_xyz[3 * row + 2] = xyz[3 * src + 2];
  out_int[row] = inten[src];
  out_mask[row] = true;
}

}  // namespace

extern "C" int lvs_dedup_keys(const float* xyz, const bool* mask, int n, float inv_res, long long* key,
                              cudaStream_t stream) {
  if (n > 0) dedup_keys<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(xyz, mask, n, inv_res, key);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_window_keys(const float* xyz_t, const float* inten, const bool* mask, int n_rows,
                               int cap, int start, int length, const float* rels, const bool* valid,
                               float inv_res, float* out_xyz, float* out_int, long long* key,
                               cudaStream_t stream) {
  long long n = static_cast<long long>(length) * cap;
  if (n > 0)
    window_keys<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(
        xyz_t, inten, mask, n_rows, cap, start, length, rels, valid, inv_res, out_xyz, out_int, key);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_window_raw_keys(const float* xyz, const float* inten, const bool* mask, int n_rows, int cap,
                                   int start, int length, const float* rels, const bool* valid, float near,
                                   float far, float inv_res, float* out_xyz, float* out_int, long long* key,
                                   cudaStream_t stream) {
  long long n = static_cast<long long>(length) * cap;
  if (n > 0)
    window_raw_keys<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(
        xyz, inten, mask, n_rows, cap, start, length, rels, valid, near, far, inv_res, out_xyz, out_int, key);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_dedup_mark(const long long* skey, int n, int* flag, cudaStream_t stream) {
  if (n > 0) dedup_mark<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(skey, n, flag);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_dedup_compact(const long long* order, const int* flag, const int* cum, int n,
                                 const float* xyz, const float* inten, int out_cap, float* out_xyz,
                                 float* out_int, bool* out_mask, cudaStream_t stream) {
  int threads = n > out_cap ? n : out_cap;
  if (threads > 0)
    dedup_compact<<<lvs::blocks_for(threads), lvs::kThreads, 0, stream>>>(
        order, flag, cum, n, xyz, inten, out_cap, out_xyz, out_int, out_mask);
  LVS_RETURN_LAST_ERROR();
}
