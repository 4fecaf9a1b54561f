// Kernel 1: voxel downsample (VOXELGRID centroid / APPROX_VOXELGRID cell
// center): the voxel-key sort and the per-voxel reduction, all on the card.
//
// Replaces: lv_slam_tpu/ops/prefilter.py:74 `voxel_downsample` (the
// reduce="scatter" path: the two-key sort, run starts, segment sums,
// front-compacted output).
//
// What bounds it on the card: memory traffic and latency, not arithmetic.
// Per scan it reads 131072 lanes of xyz / intensity / mask once and writes
// out_cap rows, a few MB in all (~1.3 us at 3.35 TB/s). At the 0.1 m
// flagship resolution most runs hold one or two points. The sort's passes
// move the keys a few times more, and each launch is a few microseconds of
// latency, so the design spends launches, not bytes.
//
// Design (`lvs_voxel_downsample`, one C call, 3 + kMaxPasses launches, no
// host read and no torch op between them):
// 1. `voxel_ranges` (a grid of at most 132 blocks, each thread a stride of
//    lanes): the voxel coordinates of each valid lane exactly as
//    `cells.cell_coords` and `_pack_yz` take them (floor(x * (1/res)) with
//    the folded float32 reciprocal, y and z clipped to [0, 2^15); a lane is
//    a voxel's where it is unmasked and kx < 2^30, the twin's rule); each
//    block's minima, maxima and valid count go to its own partial row (no
//    atomics, nothing to reset first). The same launch zeroes the sort's
//    control words and tile status words and writes the sentinel padding
//    into every output row.
// 2. `voxel_keys`: every block reduces the partial rows, so every block
//    knows the ranges; the key is (kx - kx_min, cy - cy_min, cz - cz_min)
//    packed into the fewest bits, most significant first: order-preserving
//    and lexicographic, the reference's (kx, packed yz) two-key order. At
//    the flagship's 0.1 m and 100 m band that is ~31 bits, 4 digit passes
//    where the int64 key took 8. Masked lanes get no key (kInvalidKey):
//    the sort drops them. The block also counts each pass's digits
//    (integer atomics into the control block) and block 0 writes the number
//    of valid keys, of passes (at least 1) and the field offsets and widths.
// 3. kMaxPasses launches of `key_sort_pass` (csrc/key_sort.cuh): stable
//    8-bit LSD passes with decoupled look-back; a pass past the key's width
//    returns at once, on the device value.
// 4. `voxel_runs`, a tile of sorted keys per block: the run starts, their
//    prefix by decoupled look-back (not a separate scan), and one thread per
//    run start sums its run in sorted order, which is input order within a
//    voxel (the twin's in-order index_add_), from the tile's points gathered
//    into shared memory at once, then from memory past the tile; it writes
//    row r = run r when r < out_cap. APPROX_VOXELGRID decodes the cell from
//    the key.
//
// Rejected: one thread-block cluster for the 131072-lane case (8 SMs would
// carry the whole sort, and the map's 2^22 lanes would still need this
// route); torch.sort of a packed 32-bit key (still cub's passes and the
// glue around them); an atomic-reset control block (needs a memset or a
// launch before the first atomics, which the partial rows avoid).
//
// `mark_runs` and `reduce_runs` below are the centroid reduction after a sort
// that the caller made: kernel 2r (`window_group_fn`) reduces its
// torch.sort'ed int64 window keys with them.
#include "common.cuh"
#include "key_sort.cuh"

#include <limits.h>

#include <algorithm>

namespace {

constexpr long long kBig = 1LL << 30;  // kx of masked lanes

__device__ __forceinline__ bool lane_valid(long long key) { return (key >> 31) < kBig; }

__global__ void mark_runs(const long long* __restrict__ skey, int n, int* __restrict__ flag) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long k = skey[i];
  bool start = (i == 0) || (k != skey[i - 1]);
  flag[i] = (start && lane_valid(k)) ? 1 : 0;
}

__global__ void reduce_runs(const long long* __restrict__ skey,
                            const long long* __restrict__ order,
                            const int* __restrict__ flag, const int* __restrict__ cum, int n,
                            const float* __restrict__ xyz, const float* __restrict__ inten,
                            int out_cap, float* __restrict__ out_xyz,
                            float* __restrict__ out_int, bool* __restrict__ out_mask) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  int n_runs = n > 0 ? cum[n - 1] : 0;
  if (t < out_cap && t >= n_runs) {  // padding row
    out_xyz[3 * t + 0] = lvs::kSentinel;
    out_xyz[3 * t + 1] = lvs::kSentinel;
    out_xyz[3 * t + 2] = lvs::kSentinel;
    out_int[t] = 0.0f;
    out_mask[t] = false;
  }
  if (t >= n || !flag[t]) return;
  int row = cum[t] - 1;
  if (row >= out_cap) return;
  long long key = skey[t];
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, si = 0.0f, cnt = 0.0f;
  for (int j = t; j < n && skey[j] == key; ++j) {
    long long src = order[j];
    sx += xyz[3 * src + 0];
    sy += xyz[3 * src + 1];
    sz += xyz[3 * src + 2];
    si += inten[src];
    cnt += 1.0f;
  }
  out_xyz[3 * row + 0] = sx / cnt;
  out_xyz[3 * row + 1] = sy / cnt;
  out_xyz[3 * row + 2] = sz / cnt;
  out_int[row] = si / cnt;
  out_mask[row] = true;
}

// ------------------------------------------------------------------ kernel 1

namespace ks = lvs::keysort;

constexpr int kYZOff = 1 << 14;
constexpr int kYZLim = (1 << 15) - 1;
constexpr int kRangeBlocks = 132;  // voxel_ranges' grid cap: a block an SM
constexpr int kKeyBlocks = 1056;   // voxel_keys' grid cap: 8 blocks an SM
constexpr int kParts = 8;          // a partial row: kx, cy, cz minima and maxima, valid count, pad
constexpr int kRunItems = 4;       // voxel_runs: sorted positions a thread
constexpr int kRunTile = ks::kThreads * kRunItems;
constexpr int kBigX = 1 << 30;     // kx of masked lanes in the twin's key: a lane at or past it is not a voxel

struct VoxelControl {
  ks::Control sort;
  int kx_min, cy_min, cz_min;  // field offsets of the rebased key
  int by, bz;                  // bit widths of the cy and cz fields
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// floor(x * (1/res)) as `cell_coords` takes it; cy and cz shifted and
// clipped as `_pack_yz` packs them
__device__ __forceinline__ void voxel_coords(const float* __restrict__ xyz, long long i, float inv, int& kx,
                                             int& cy, int& cz) {
  kx = static_cast<int>(floorf(xyz[3 * i + 0] * inv));
  cy = clampi(static_cast<int>(floorf(xyz[3 * i + 1] * inv)) + kYZOff, 0, kYZLim);
  cz = clampi(static_cast<int>(floorf(xyz[3 * i + 2] * inv)) + kYZOff, 0, kYZLim);
}

// The block's reduction of a partial row (minima at 0, 2, 4, maxima at 1, 3,
// 5, the count at 6): threads 0..kParts-1 see the result in out.
__device__ __forceinline__ void block_ranges(int (&v)[kParts], int* out) {
  __shared__ int rows[32][kParts];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 6; k += 2) {
      v[k] = min(v[k], __shfl_down_sync(0xffffffffu, v[k], off));
      v[k + 1] = max(v[k + 1], __shfl_down_sync(0xffffffffu, v[k + 1], off));
    }
    v[6] += __shfl_down_sync(0xffffffffu, v[6], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kParts; ++k) rows[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < kParts) {
    const int k = threadIdx.x;
    int r = rows[0][k];
    for (int w = 1; w < n_warps; ++w) {
      const int o = rows[w][k];
      r = k == 6 ? r + o : ((k & 1) ? max(r, o) : min(r, o));
    }
    out[k] = r;
  }
  __syncthreads();
}

__device__ __forceinline__ void empty_ranges(int (&v)[kParts]) {
#pragma unroll
  for (int k = 0; k < 6; k += 2) {
    v[k] = INT_MAX;
    v[k + 1] = INT_MIN;
  }
  v[6] = 0;
  v[7] = 0;
}

__global__ void __launch_bounds__(lvs::kThreads) voxel_ranges(
    const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float inv, int* __restrict__ part,
    unsigned* __restrict__ zero, long long n_zero, int out_cap, float* __restrict__ out_xyz,
    float* __restrict__ out_int, bool* __restrict__ out_mask) {
  __shared__ int row[kParts];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int v[kParts];
  empty_ranges(v);
#pragma unroll 4
  for (long long i = first; i < n; i += stride) {
    if (!mask[i]) continue;
    int kx, cy, cz;
    voxel_coords(xyz, i, inv, kx, cy, cz);
    if (kx >= kBigX) continue;
    v[0] = min(v[0], kx);
    v[1] = max(v[1], kx);
    v[2] = min(v[2], cy);
    v[3] = max(v[3], cy);
    v[4] = min(v[4], cz);
    v[5] = max(v[5], cz);
    ++v[6];
  }
  block_ranges(v, row);
  if (threadIdx.x < kParts) part[blockIdx.x * kParts + threadIdx.x] = row[threadIdx.x];
  for (long long i = first; i < n_zero; i += stride) zero[i] = 0u;
  for (long long r = first; r < out_cap; r += stride) {  // padding; voxel_runs overwrites the voxels' rows
    out_xyz[3 * r + 0] = lvs::kSentinel;
    out_xyz[3 * r + 1] = lvs::kSentinel;
    out_xyz[3 * r + 2] = lvs::kSentinel;
    out_int[r] = 0.0f;
    out_mask[r] = false;
  }
}

__device__ __forceinline__ int bit_width(unsigned r) { return r ? 32 - __clz(static_cast<int>(r)) : 0; }

__global__ void __launch_bounds__(lvs::kThreads) voxel_keys(
    const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float inv, const int* __restrict__ part,
    int n_part, VoxelControl* vc, unsigned long long* __restrict__ keys) {
  __shared__ unsigned counts[ks::kMaxPasses][ks::kRadix];
  __shared__ int range[kParts];
  int v[kParts];
  empty_ranges(v);
  for (int b = threadIdx.x; b < n_part; b += blockDim.x) {
    const int* p = part + b * kParts;
#pragma unroll
    for (int k = 0; k < 6; k += 2) {
      v[k] = min(v[k], p[k]);
      v[k + 1] = max(v[k + 1], p[k + 1]);
    }
    v[6] += p[6];
  }
  for (int i = threadIdx.x; i < ks::kMaxPasses * ks::kRadix; i += blockDim.x) (&counts[0][0])[i] = 0u;
  block_ranges(v, range);  // ends with a barrier
  const int n_valid = range[6];
  const int kx_min = n_valid ? range[0] : 0, cy_min = n_valid ? range[2] : 0, cz_min = n_valid ? range[4] : 0;
  const int bx = n_valid ? bit_width(static_cast<unsigned>(static_cast<long long>(range[1]) - kx_min)) : 0;
  const int by = n_valid ? bit_width(static_cast<unsigned>(range[3] - cy_min)) : 0;
  const int bz = n_valid ? bit_width(static_cast<unsigned>(range[5] - cz_min)) : 0;
  const int n_passes = max(1, (bx + by + bz + ks::kDigitBits - 1) / ks::kDigitBits);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    vc->sort.n_valid = n_valid;
    vc->sort.n_passes = n_passes;
    vc->kx_min = kx_min;
    vc->cy_min = cy_min;
    vc->cz_min = cz_min;
    vc->by = by;
    vc->bz = bz;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    unsigned long long key = ks::kInvalidKey;
    int kx, cy, cz;
    if (mask[i] && (voxel_coords(xyz, i, inv, kx, cy, cz), kx < kBigX)) {
      key = (static_cast<unsigned long long>(static_cast<unsigned>(static_cast<long long>(kx) - kx_min))
             << (by + bz)) |
            (static_cast<unsigned long long>(cy - cy_min) << bz) | static_cast<unsigned long long>(cz - cz_min);
      ks::count_digits(counts, key, n_passes);
    }
    keys[i] = key;
  }
  __syncthreads();
  ks::flush_digits(counts, n_passes, &vc->sort);
}

// One tile of the sorted keys a block, kRunItems consecutive positions a
// thread: run r's centroid (or cell center) into row r. Each thread gathers
// its positions' points at once into shared memory; a run start sums its
// run in sorted order from there, and from memory past the tile's end.
__global__ void __launch_bounds__(ks::kThreads) voxel_runs(
    const unsigned long long* __restrict__ keys_a, const unsigned* __restrict__ vals_a,
    const unsigned long long* __restrict__ keys_b, const unsigned* __restrict__ vals_b, VoxelControl* vc,
    unsigned* run_status, const float* __restrict__ xyz, const float* __restrict__ inten, float res, int approx,
    int out_cap, float* __restrict__ out_xyz, float* __restrict__ out_int, bool* __restrict__ out_mask) {
  __shared__ unsigned long long tile_key[kRunTile];
  __shared__ float4 tile_point[kRunTile];  // x, y, z, intensity
  __shared__ int tile_id;
  __shared__ unsigned tile_base;
  const int n = vc->sort.n_valid;
  const bool in_a = (vc->sort.n_passes & 1) != 0;
  const unsigned long long* __restrict__ keys = in_a ? keys_a : keys_b;
  const unsigned* __restrict__ vals = in_a ? vals_a : vals_b;
  if (threadIdx.x == 0) tile_id = static_cast<int>(atomicAdd(&vc->sort.tickets[ks::kMaxPasses], 1u));
  __syncthreads();
  const int tile = tile_id;
  const long long tile_first = static_cast<long long>(tile) * kRunTile;
  if (tile_first >= n) return;  // whole block
  const int tile_n = static_cast<int>(min(static_cast<long long>(kRunTile), n - tile_first));
  const int mine0 = threadIdx.x * kRunItems;  // this thread's first position in the tile
  bool in[kRunItems];
  unsigned long long key[kRunItems];
  unsigned src[kRunItems];
  const unsigned long long before = mine0 < tile_n && tile_first + mine0 > 0 ? keys[tile_first + mine0 - 1] : ~0ull;
#pragma unroll
  for (int j = 0; j < kRunItems; ++j) {
    in[j] = mine0 + j < tile_n;
    key[j] = in[j] ? keys[tile_first + mine0 + j] : 0ull;
    src[j] = in[j] ? vals[tile_first + mine0 + j] : 0u;
  }
  unsigned starts = 0;
  bool start[kRunItems];
#pragma unroll
  for (int j = 0; j < kRunItems; ++j) {
    if (in[j]) {
      tile_key[mine0 + j] = key[j];
      tile_point[mine0 + j] = make_float4(xyz[3ll * src[j] + 0], xyz[3ll * src[j] + 1], xyz[3ll * src[j] + 2],
                                          inten[src[j]]);
    }
    start[j] = in[j] && (tile_first + mine0 + j == 0 || (j == 0 ? before : key[j - 1]) != key[j]);
    starts += start[j];
  }
  unsigned tile_runs;
  unsigned r = ks::block_exclusive_scan(starts, &tile_runs);
  if (threadIdx.x < 32) {
    const unsigned b = ks::warp_lookback(run_status, 1, tile, 1u, tile_runs);
    if (threadIdx.x == 0) tile_base = b;
  }
  __syncthreads();
  r += tile_base;
  const int by = vc->by, bz = vc->bz;
#pragma unroll
  for (int j = 0; j < kRunItems; ++j) {
    if (!start[j]) continue;
    const unsigned row = r++;
    if (row >= static_cast<unsigned>(out_cap)) continue;
    float sx = 0.0f, sy = 0.0f, sz = 0.0f, si = 0.0f, cnt = 0.0f;
    int m = mine0 + j;
    for (; m < tile_n && tile_key[m] == key[j]; ++m) {
      const float4 p = tile_point[m];
      sx += p.x;
      sy += p.y;
      sz += p.z;
      si += p.w;
      cnt += 1.0f;
    }
    if (m == kRunTile) {  // the run may go on past the tile
      for (long long i = tile_first + m; i < n && keys[i] == key[j]; ++i) {
        const long long at = vals[i];
        sx += xyz[3 * at + 0];
        sy += xyz[3 * at + 1];
        sz += xyz[3 * at + 2];
        si += inten[at];
        cnt += 1.0f;
      }
    }
    if (approx) {
      const int cx = static_cast<int>(static_cast<long long>(key[j] >> (by + bz)) + vc->kx_min);
      const int cy = static_cast<int>((key[j] >> bz) & ((1ull << by) - 1)) + vc->cy_min - kYZOff;
      const int cz = static_cast<int>(key[j] & ((1ull << bz) - 1)) + vc->cz_min - kYZOff;
      out_xyz[3 * row + 0] = (static_cast<float>(cx) + 0.5f) * res;
      out_xyz[3 * row + 1] = (static_cast<float>(cy) + 0.5f) * res;
      out_xyz[3 * row + 2] = (static_cast<float>(cz) + 0.5f) * res;
    } else {
      out_xyz[3 * row + 0] = sx / cnt;
      out_xyz[3 * row + 1] = sy / cnt;
      out_xyz[3 * row + 2] = sz / cnt;
    }
    out_int[row] = si / cnt;
    out_mask[row] = true;
  }
}

// The scratch of one call, in bytes from its start: the words that
// voxel_ranges zeroes first (control, pass status, run status), then the
// partial rows, two key and two value buffers.
struct Layout {
  size_t status, run_status, zero_end, part, keys_a, keys_b, vals_a, vals_b, total;
};

size_t up256(size_t x) { return (x + 255) / 256 * 256; }

Layout layout(int n) {
  const size_t tiles = n > 0 ? (static_cast<size_t>(n) + ks::kTile - 1) / ks::kTile : 1;
  const size_t run_tiles = n > 0 ? (static_cast<size_t>(n) + kRunTile - 1) / kRunTile : 1;
  Layout l;
  l.status = up256(sizeof(VoxelControl));
  l.run_status = l.status + tiles * ks::kRadix * sizeof(unsigned);
  l.zero_end = up256(l.run_status + run_tiles * sizeof(unsigned));
  l.part = l.zero_end;
  l.keys_a = up256(l.part + kRangeBlocks * kParts * sizeof(int));
  l.keys_b = up256(l.keys_a + n * sizeof(unsigned long long));
  l.vals_a = up256(l.keys_b + n * sizeof(unsigned long long));
  l.vals_b = up256(l.vals_a + n * sizeof(unsigned));
  l.total = up256(l.vals_b + n * sizeof(unsigned));
  return l;
}

}  // namespace

extern "C" int lvs_voxel_mark_runs(const long long* skey, int n, int* flag, cudaStream_t stream) {
  if (n > 0) mark_runs<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(skey, n, flag);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_voxel_reduce_runs(const long long* skey, const long long* order,
                                     const int* flag, const int* cum, int n, const float* xyz,
                                     const float* inten, int out_cap, float* out_xyz, float* out_int,
                                     bool* out_mask, cudaStream_t stream) {
  int threads = n > out_cap ? n : out_cap;
  if (threads > 0)
    reduce_runs<<<lvs::blocks_for(threads), lvs::kThreads, 0, stream>>>(
        skey, order, flag, cum, n, xyz, inten, out_cap, out_xyz, out_int, out_mask);
  LVS_RETURN_LAST_ERROR();
}

extern "C" long long lvs_voxel_scratch_bytes(int n) { return static_cast<long long>(layout(n).total); }

extern "C" int lvs_voxel_downsample(const float* xyz, const float* inten, const bool* mask, int n, float inv_res,
                                    float res, int approx, int out_cap, void* scratch, long long scratch_bytes,
                                    float* out_xyz, float* out_int, bool* out_mask, cudaStream_t stream) {
  if (n < 0 || n > ks::kMaxKeys || out_cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(n);
  if (scratch_bytes < static_cast<long long>(l.total)) return static_cast<int>(cudaErrorInvalidValue);
  char* base = static_cast<char*>(scratch);
  auto* vc = reinterpret_cast<VoxelControl*>(base);
  auto* status = reinterpret_cast<unsigned*>(base + l.status);
  auto* run_status = reinterpret_cast<unsigned*>(base + l.run_status);
  auto* part = reinterpret_cast<int*>(base + l.part);
  auto* keys_a = reinterpret_cast<unsigned long long*>(base + l.keys_a);
  auto* keys_b = reinterpret_cast<unsigned long long*>(base + l.keys_b);
  auto* vals_a = reinterpret_cast<unsigned*>(base + l.vals_a);
  auto* vals_b = reinterpret_cast<unsigned*>(base + l.vals_b);
  const long long n_zero = static_cast<long long>(l.zero_end / sizeof(unsigned));
  const long long work = n > out_cap ? n : (out_cap > n_zero ? out_cap : n_zero);
  const int range_blocks = std::max(1, std::min(lvs::blocks_for(work), kRangeBlocks));
  voxel_ranges<<<range_blocks, lvs::kThreads, 0, stream>>>(xyz, mask, n, inv_res, part,
                                                           reinterpret_cast<unsigned*>(base), n_zero, out_cap,
                                                           out_xyz, out_int, out_mask);
  if (n == 0) LVS_RETURN_LAST_ERROR();
  const int key_blocks = std::min(lvs::blocks_for(n), kKeyBlocks);
  voxel_keys<<<key_blocks, lvs::kThreads, 0, stream>>>(xyz, mask, n, inv_res, part, range_blocks, vc, keys_b);
  ks::launch_passes(n, keys_a, vals_a, keys_b, vals_b, &vc->sort, status, stream);
  voxel_runs<<<(n + kRunTile - 1) / kRunTile, ks::kThreads, 0, stream>>>(
      keys_a, vals_a, keys_b, vals_b, vc, run_status, xyz, inten, res, approx, out_cap, out_xyz, out_int, out_mask);
  LVS_RETURN_LAST_ERROR();
}
