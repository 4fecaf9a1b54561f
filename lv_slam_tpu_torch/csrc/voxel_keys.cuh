// Kernel 1's front end, shared by the callers that sort lanes by voxel:
// kernel 1 (`csrc/voxel_downsample.cu`), kernels 1b, 2 and 2r
// (`csrc/voxel_dedup.cu`; kernels 1 and 2r also share the centroid pass
// `voxel_runs`), and, for its partial rows, scratch layout and
// run numbering, kernels 3 (`csrc/voxel_map.cu`), 14
// (`csrc/centroid_grid.cu`) and 9g (`csrc/knn_grid.cu`), which also share
// the flat-key front end at the end of this file (3 and 14 its run walk).
//
// `voxel_ranges` (a grid of at most kRangeBlocks blocks, each thread a
// stride of lanes) takes the voxel coordinates of each valid lane exactly
// as `cells.cell_coords` and `_pack_yz` take them (floor(x * (1/res)) with
// the folded float32 reciprocal, y and z clipped to [0, 2^15); a lane is a
// voxel's where it is unmasked and kx < 2^30, the twins' rule) and writes
// each block's minima, maxima and valid count to its own partial row (no
// atomics, nothing to reset first). The same launch zeroes the sort's
// control words and tile status words and writes the sentinel padding into
// every output row.
//
// `voxel_keys`: every block reduces the partial rows, so every block knows
// the ranges; the key is (kx - kx_min, cy - cy_min, cz - cz_min) packed into
// the fewest bits, most significant first: order-preserving and
// lexicographic, the twins' (kx, packed yz) two-key order. Masked lanes get
// no key (kInvalidKey): the sort drops them. The block also counts each
// pass's digits (integer atomics into the control block) and block 0 writes
// the number of valid keys, of passes (at least 1) and the field offsets
// and widths.
//
// Then a caller launches the kMaxPasses passes of `csrc/key_sort.cuh` and a
// run pass over the sorted tiles: its own, or `voxel_runs` (below), the
// centroids of kernels 1 and 2r. Everything here sits in an
// anonymous namespace: each source that includes the file has its own copy.
#pragma once

#include "common.cuh"
#include "key_sort.cuh"

#include <limits.h>

#include <algorithm>

namespace {

namespace ks = lvs::keysort;

constexpr int kYZOff = 1 << 14;
constexpr int kYZLim = (1 << 15) - 1;
constexpr int kRangeBlocks = 132;  // the ranges pass's grid cap: a block an SM
constexpr int kKeyBlocks = 1056;   // the keys pass's grid cap: 8 blocks an SM
constexpr int kParts = 8;          // a partial row: three minima and maxima, valid count, pad
constexpr int kRunItems = 4;       // a run pass: sorted positions a thread
constexpr int kRunTile = ks::kThreads * kRunItems;
constexpr int kBigX = 1 << 30;     // kx of masked lanes in the twins' key: a lane at or past it is not a voxel

struct VoxelControl {
  ks::Control sort;
  int kx_min, cy_min, cz_min;  // field offsets of the rebased key
  int by, bz;                  // bit widths of the cy and cz fields
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// floor(x * (1/res)) as `cell_coords` takes it; cy and cz shifted and
// clipped as `_pack_yz` packs them
__device__ __forceinline__ void voxel_coords(float x, float y, float z, float inv, int& kx, int& cy, int& cz) {
  kx = lvs::cell_floor(x, inv);
  cy = clampi(lvs::cell_floor(y, inv) + kYZOff, 0, kYZLim);
  cz = clampi(lvs::cell_floor(z, inv) + kYZOff, 0, kYZLim);
}

// lane i's point at xyz + S * i (S = 4: packed with its intensity)
template <int S = 3>
__device__ __forceinline__ void voxel_coords(const float* __restrict__ xyz, long long i, float inv, int& kx,
                                             int& cy, int& cz) {
  voxel_coords(xyz[S * i + 0], xyz[S * i + 1], xyz[S * i + 2], inv, kx, cy, cz);
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

// Adds a valid lane's voxel to a thread's partial row.
__device__ __forceinline__ void add_range(int (&v)[kParts], int kx, int cy, int cz) {
  v[0] = min(v[0], kx);
  v[1] = max(v[1], kx);
  v[2] = min(v[2], cy);
  v[3] = max(v[3], cy);
  v[4] = min(v[4], cz);
  v[5] = max(v[5], cz);
  ++v[6];
}

// The tail of a ranges pass: the block's partial row, the zeroed words, the
// padding of the output rows (a run pass overwrites the voxels' rows).
__device__ __forceinline__ void finish_ranges(int (&v)[kParts], int* __restrict__ part, unsigned* __restrict__ zero,
                                              long long n_zero, int out_cap, float* __restrict__ out_xyz,
                                              float* __restrict__ out_int, bool* __restrict__ out_mask) {
  __shared__ int row[kParts];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  block_ranges(v, row);
  if (threadIdx.x < kParts) part[blockIdx.x * kParts + threadIdx.x] = row[threadIdx.x];
  for (long long i = first; i < n_zero; i += stride) zero[i] = 0u;
  for (long long r = first; r < out_cap; r += stride) {
    out_xyz[3 * r + 0] = lvs::kSentinel;
    out_xyz[3 * r + 1] = lvs::kSentinel;
    out_xyz[3 * r + 2] = lvs::kSentinel;
    out_int[r] = 0.0f;
    out_mask[r] = false;
  }
}

__global__ void __launch_bounds__(lvs::kThreads) voxel_ranges(
    const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float inv, int* __restrict__ part,
    unsigned* __restrict__ zero, long long n_zero, int out_cap, float* __restrict__ out_xyz,
    float* __restrict__ out_int, bool* __restrict__ out_mask) {
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
    add_range(v, kx, cy, cz);
  }
  finish_ranges(v, part, zero, n_zero, out_cap, out_xyz, out_int, out_mask);
}

__device__ __forceinline__ int bit_width(unsigned r) { return r ? 32 - __clz(static_cast<int>(r)) : 0; }

// Every block's reduction of the n_part partial rows, into v; also zeroes
// the block's digit counts. Ends with a barrier.
__device__ __forceinline__ void reduce_parts(const int* __restrict__ part, int n_part,
                                             unsigned (*counts)[ks::kRadix], int* range) {
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
  block_ranges(v, range);
}

template <int S = 3>
__global__ void __launch_bounds__(lvs::kThreads) voxel_keys(
    const float* __restrict__ xyz, const bool* __restrict__ mask, int n, float inv, const int* __restrict__ part,
    int n_part, VoxelControl* vc, unsigned long long* __restrict__ keys) {
  __shared__ unsigned counts[ks::kMaxPasses][ks::kRadix];
  __shared__ int range[kParts];
  reduce_parts(part, n_part, counts, range);
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
    if (mask[i] && (voxel_coords<S>(xyz, i, inv, kx, cy, cz), kx < kBigX)) {
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

// A run pass's tile: the block's ticket, its kRunItems positions a thread
// of the sorted keys, and which of them start a run (`load_run_tile`); then
// `number_runs` gives `r`, the run index of the thread's first start (its
// place after every earlier tile's runs, by decoupled look-back on
// run_status), and `base`, the tile's. A caller issues its own loads for
// the tile between the two.
struct RunTile {
  int tile;
  long long first;  // the tile's first sorted position
  int n;            // keys in the tile
  int mine0;        // the thread's first position in the tile
  unsigned long long key[kRunItems];
  bool in[kRunItems];
  bool start[kRunItems];
  unsigned starts;
  unsigned r;
  unsigned base;  // the run index of the tile's first start
};

// `ticket` is the Control word the pass takes its tiles from. Returns false
// for a block past the last key (the whole block).
__device__ __forceinline__ bool load_run_tile(const unsigned long long* __restrict__ keys, int n, unsigned* ticket,
                                              RunTile& t) {
  __shared__ int tile_id;
  if (threadIdx.x == 0) tile_id = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  t.tile = tile_id;
  t.first = static_cast<long long>(t.tile) * kRunTile;
  if (t.first >= n) return false;
  t.n = static_cast<int>(min(static_cast<long long>(kRunTile), n - t.first));
  t.mine0 = threadIdx.x * kRunItems;
  const unsigned long long before = t.mine0 < t.n && t.first + t.mine0 > 0 ? keys[t.first + t.mine0 - 1] : ~0ull;
#pragma unroll
  for (int j = 0; j < kRunItems; ++j) {
    t.in[j] = t.mine0 + j < t.n;
    t.key[j] = t.in[j] ? keys[t.first + t.mine0 + j] : 0ull;
  }
  t.starts = 0;
#pragma unroll
  for (int j = 0; j < kRunItems; ++j) {
    t.start[j] = t.in[j] && (t.first + t.mine0 + j == 0 || (j == 0 ? before : t.key[j - 1]) != t.key[j]);
    t.starts += t.start[j];
  }
  return true;
}

__device__ __forceinline__ void number_runs(RunTile& t, unsigned* run_status) {
  __shared__ unsigned tile_base;
  unsigned tile_runs;
  t.r = ks::block_exclusive_scan(t.starts, &tile_runs);
  if (threadIdx.x < 32) {
    const unsigned b = ks::warp_lookback(run_status, 1, t.tile, 1u, tile_runs);
    if (threadIdx.x == 0) tile_base = b;
  }
  __syncthreads();
  t.base = tile_base;
  t.r += tile_base;
}

// The scratch of one call, in bytes from its start: the words that the
// ranges pass zeroes first (control, pass status, run status), then
// `part_rows` partial rows, two key and two value buffers, then `extra`
// bytes of the caller's.
struct Layout {
  size_t status, run_status, zero_end, part, keys_a, keys_b, vals_a, vals_b, extra, total;
};

inline size_t up256(size_t x) { return (x + 255) / 256 * 256; }

inline Layout layout(int n, size_t control_bytes = sizeof(VoxelControl), size_t extra_bytes = 0,
                     int part_rows = kRangeBlocks) {
  const size_t tiles = n > 0 ? (static_cast<size_t>(n) + ks::kTile - 1) / ks::kTile : 1;
  const size_t run_tiles = n > 0 ? (static_cast<size_t>(n) + kRunTile - 1) / kRunTile : 1;
  Layout l;
  l.status = up256(control_bytes);
  l.run_status = l.status + tiles * ks::kRadix * sizeof(unsigned);
  l.zero_end = up256(l.run_status + run_tiles * sizeof(unsigned));
  l.part = l.zero_end;
  l.keys_a = up256(l.part + part_rows * kParts * sizeof(int));
  l.keys_b = up256(l.keys_a + n * sizeof(unsigned long long));
  l.vals_a = up256(l.keys_b + n * sizeof(unsigned long long));
  l.vals_b = up256(l.vals_a + n * sizeof(unsigned));
  l.extra = up256(l.vals_b + n * sizeof(unsigned));
  l.total = up256(l.extra + extra_bytes);
  return l;
}

// The pointers of a call's scratch.
struct Scratch {
  char* base;
  unsigned* status;
  unsigned* run_status;
  int* part;
  unsigned long long *keys_a, *keys_b;
  unsigned *vals_a, *vals_b;
  char* extra;
  long long n_zero;  // words from `base` that the ranges pass zeroes
};

inline Scratch scratch_at(void* p, const Layout& l) {
  char* base = static_cast<char*>(p);
  return Scratch{base,
                 reinterpret_cast<unsigned*>(base + l.status),
                 reinterpret_cast<unsigned*>(base + l.run_status),
                 reinterpret_cast<int*>(base + l.part),
                 reinterpret_cast<unsigned long long*>(base + l.keys_a),
                 reinterpret_cast<unsigned long long*>(base + l.keys_b),
                 reinterpret_cast<unsigned*>(base + l.vals_a),
                 reinterpret_cast<unsigned*>(base + l.vals_b),
                 base + l.extra,
                 static_cast<long long>(l.zero_end / sizeof(unsigned))};
}

// The ranges pass's grid: enough blocks for the larger of the lanes, the
// output rows and the zeroed words, at most `cap` (the partial rows the
// layout holds).
inline int range_blocks_for(int n, long long out_rows, long long n_zero, int cap = kRangeBlocks) {
  const long long work = std::max<long long>(n, std::max(out_rows, n_zero));
  return std::max(1, std::min(lvs::blocks_for(work), cap));
}

// `voxel_keys` and the sort passes after a ranges pass of `range_blocks`
// blocks: the sorted keys and lanes end in (keys_a, vals_a) when the pass
// count is odd, else in (keys_b, vals_b). Lane i's point is at xyz + S * i.
template <int S = 3>
inline void launch_keys_and_sort(const float* xyz, const bool* mask, int n, float inv, int range_blocks,
                                 const Scratch& s, cudaStream_t stream) {
  auto* vc = reinterpret_cast<VoxelControl*>(s.base);
  voxel_keys<S><<<std::min(lvs::blocks_for(n), kKeyBlocks), lvs::kThreads, 0, stream>>>(xyz, mask, n, inv, s.part,
                                                                                      range_blocks, vc, s.keys_b);
  ks::launch_passes(n, s.keys_a, s.vals_a, s.keys_b, s.vals_b, &vc->sort, s.status, stream);
}

// Lane `at`'s point and intensity (S as `voxel_runs`).
template <int S>
__device__ __forceinline__ float4 point_at(const float* __restrict__ xyz, const float* __restrict__ inten,
                                           long long at) {
  if constexpr (S == 4) {
    return reinterpret_cast<const float4*>(xyz)[at];
  } else {
    return make_float4(xyz[3 * at + 0], xyz[3 * at + 1], xyz[3 * at + 2], inten[at]);
  }
}

// One tile of the sorted keys a block, kRunItems consecutive positions a
// thread: run r's centroid (or cell center) into row r. Each thread gathers
// its positions' points at once into shared memory; a run start sums its
// run in sorted order from there, and from memory past the tile's end. A
// tile at or past position out_cap may hold no run below out_cap (a window
// group's 2 M lanes hold many more voxels than its rows): it numbers its
// runs first and gathers nothing when its first run has no row. S = 3:
// lane i's point at xyz + 3 i and its intensity at inten[i]; S = 4: both
// at xyz + 4 i (one 16-byte load a lane; `inten` unread).
template <int S = 3>
__global__ void __launch_bounds__(ks::kThreads) voxel_runs(
    const unsigned long long* __restrict__ keys_a, const unsigned* __restrict__ vals_a,
    const unsigned long long* __restrict__ keys_b, const unsigned* __restrict__ vals_b, VoxelControl* vc,
    unsigned* run_status, const float* __restrict__ xyz, const float* __restrict__ inten, float res, int approx,
    int out_cap, float* __restrict__ out_xyz, float* __restrict__ out_int, bool* __restrict__ out_mask) {
  __shared__ unsigned long long tile_key[kRunTile];
  __shared__ float4 tile_point[kRunTile];  // x, y, z, intensity
  const int n = vc->sort.n_valid;
  const bool in_a = (vc->sort.n_passes & 1) != 0;
  const unsigned long long* __restrict__ keys = in_a ? keys_a : keys_b;
  const unsigned* __restrict__ vals = in_a ? vals_a : vals_b;
  RunTile t;
  if (!load_run_tile(keys, n, &vc->sort.tickets[ks::kMaxPasses], t)) return;  // whole block
  const bool late = t.first >= out_cap;
  if (late) {
    number_runs(t, run_status);                            // ends with a barrier
    if (t.base >= static_cast<unsigned>(out_cap)) return;  // whole block: no run of the tile has a row
  }
  unsigned src[kRunItems];
#pragma unroll
  for (int j = 0; j < kRunItems; ++j) src[j] = t.in[j] ? vals[t.first + t.mine0 + j] : 0u;
#pragma unroll
  for (int j = 0; j < kRunItems; ++j) {
    if (t.in[j]) {
      tile_key[t.mine0 + j] = t.key[j];
      tile_point[t.mine0 + j] = point_at<S>(xyz, inten, src[j]);
    }
  }
  if (late)
    __syncthreads();
  else
    number_runs(t, run_status);  // ends with a barrier
  unsigned r = t.r;
  const int by = vc->by, bz = vc->bz;
#pragma unroll
  for (int j = 0; j < kRunItems; ++j) {
    if (!t.start[j]) continue;
    const unsigned row = r++;
    if (row >= static_cast<unsigned>(out_cap)) continue;
    float sx = 0.0f, sy = 0.0f, sz = 0.0f, si = 0.0f, cnt = 0.0f;
    int m = t.mine0 + j;
    for (; m < t.n && tile_key[m] == t.key[j]; ++m) {
      const float4 p = tile_point[m];
      sx += p.x;
      sy += p.y;
      sz += p.z;
      si += p.w;
      cnt += 1.0f;
    }
    if (m == kRunTile) {  // the run may go on past the tile
      for (long long i = t.first + m; i < n && keys[i] == t.key[j]; ++i) {
        const float4 p = point_at<S>(xyz, inten, vals[i]);
        sx += p.x;
        sy += p.y;
        sz += p.z;
        si += p.w;
        cnt += 1.0f;
      }
    }
    if (approx) {
      const int cx = static_cast<int>(static_cast<long long>(t.key[j] >> (by + bz)) + vc->kx_min);
      const int cy = static_cast<int>((t.key[j] >> bz) & ((1ull << by) - 1)) + vc->cy_min - kYZOff;
      const int cz = static_cast<int>(t.key[j] & ((1ull << bz) - 1)) + vc->cz_min - kYZOff;
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

// `voxel_runs` after `launch_keys_and_sort` over n lanes: run r's centroid
// (or, with `approx`, cell center at `res`) of xyz and inten (S as
// `voxel_runs`) into row r.
template <int S = 3>
inline void launch_voxel_runs(int n, const Scratch& s, const float* xyz, const float* inten, float res, int approx,
                              int out_cap, float* out_xyz, float* out_int, bool* out_mask, cudaStream_t stream) {
  voxel_runs<S><<<(n + kRunTile - 1) / kRunTile, ks::kThreads, 0, stream>>>(
      s.keys_a, s.vals_a, s.keys_b, s.vals_b, reinterpret_cast<VoxelControl*>(s.base), s.run_status, xyz, inten, res,
      approx, out_cap, out_xyz, out_int, out_mask);
}

// ------------------------------------------- kernels 3, 14 and 9g's front end
//
// A flat cell key is (rel0 * e + rel1) * e + rel2 with rel = floor(x *
// (1/res)) - origin, the origin the masked minimum cell (masked lanes fold
// in 2^30, the twins' `where(mask, coords, BIG).amin`; 0 on an axis where it
// is 2^30). `flat_ranges` (the ranges pass) writes each block's minima,
// maxima and unmasked count to its partial row; `flat_keys` (the keys pass)
// reduces the partial rows in every block, and an in-extent lane (unmasked,
// 0 <= rel < e on each axis) gets (rel0, rel1, rel2) packed most significant
// first, each field min(max - origin, e - 1) wide in bits: the flat key's
// order in the fewest digit passes. Other lanes get kInvalidKey and are
// dropped (in the twins they sort behind every leaf and make none).

struct FlatControl {
  ks::Control sort;
  int origin[3];  // origin_cell
  int b1, b2;     // bit widths of the rel1 and rel2 fields
};

// Lane i's point at xyz + xs * i and its flag at mask + ms * i. Also zeroes
// n_zero words from `zero`.
__device__ __forceinline__ void flat_ranges(const float* __restrict__ xyz, int xs, const bool* __restrict__ mask,
                                            int ms, int n, float inv, int* __restrict__ part,
                                            unsigned* __restrict__ zero, long long n_zero) {
  __shared__ int row[kParts];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int v[kParts];
  empty_ranges(v);
#pragma unroll 4
  for (long long i = first; i < n; i += stride) {
    if (!mask[ms * i]) {
      v[0] = min(v[0], kBigX);
      v[2] = min(v[2], kBigX);
      v[4] = min(v[4], kBigX);
      continue;
    }
    const float* p = xyz + xs * i;
    add_range(v, lvs::cell_floor(p[0], inv), lvs::cell_floor(p[1], inv), lvs::cell_floor(p[2], inv));
  }
  block_ranges(v, row);
  if (threadIdx.x < kParts) part[blockIdx.x * kParts + threadIdx.x] = row[threadIdx.x];
  for (long long i = first; i < n_zero; i += stride) zero[i] = 0u;
}

// Lane i's cell offsets from the origin `o`, in int32 differences that
// wrap as the twin's; whether the lane is unmasked and in the extent (0 <=
// rel < e on each axis). `flat_keys` keys these lanes, and kernel 9g's
// output pass (csrc/knn_grid.cu) places the others by the same test.
__device__ __forceinline__ bool flat_rel(const float* __restrict__ xyz, int xs, const bool* __restrict__ mask, int ms,
                                         long long i, float inv, const int (&o)[3], int e, int (&rel)[3]) {
  if (!mask[ms * i]) return false;
  bool in = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rel[k] = static_cast<int>(static_cast<unsigned>(lvs::cell_floor(xyz[xs * i + k], inv)) -
                              static_cast<unsigned>(o[k]));
    in = in && rel[k] >= 0 && rel[k] < e;
  }
  return in;
}

// The keys pass after `flat_ranges`: block 0 writes the origin (to `fc` and
// `origin_cell`), the pass count and the field widths; every block counts
// its keys' digits and adds its in-extent lanes to the sort's count.
__device__ __forceinline__ void flat_keys(const float* __restrict__ xyz, int xs, const bool* __restrict__ mask, int ms,
                                          int n, float inv, int e, const int* __restrict__ part, int n_part,
                                          FlatControl* fc, int* __restrict__ origin_cell,
                                          unsigned long long* __restrict__ keys) {
  __shared__ unsigned counts[ks::kMaxPasses][ks::kRadix];
  __shared__ int range[kParts];
  __shared__ unsigned block_valid;
  if (threadIdx.x == 0) block_valid = 0u;
  reduce_parts(part, n_part, counts, range);  // ends with a barrier
  int o[3], w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = range[2 * k] == kBigX ? 0 : range[2 * k];
    const long long span = min(max(static_cast<long long>(range[2 * k + 1]) - o[k], 0ll),
                               static_cast<long long>(e - 1));
    w[k] = range[6] ? bit_width(static_cast<unsigned>(span)) : 0;
  }
  const int n_passes = max(1, (w[0] + w[1] + w[2] + ks::kDigitBits - 1) / ks::kDigitBits);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    fc->sort.n_passes = n_passes;
    fc->b1 = w[1];
    fc->b2 = w[2];
#pragma unroll
    for (int k = 0; k < 3; ++k) fc->origin[k] = origin_cell[k] = o[k];
  }
  unsigned mine = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    unsigned long long key = ks::kInvalidKey;
    int rel[3];
    if (flat_rel(xyz, xs, mask, ms, i, inv, o, e, rel)) {
      key = (static_cast<unsigned long long>(rel[0]) << (w[1] + w[2])) |
            (static_cast<unsigned long long>(rel[1]) << w[2]) | static_cast<unsigned long long>(rel[2]);
      ks::count_digits(counts, key, n_passes);
      ++mine;
    }
    keys[i] = key;
  }
  mine = lvs::warp_sum(mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&block_valid, mine);
  __syncthreads();
  ks::flush_digits(counts, n_passes, &fc->sort);
  if (threadIdx.x == 0 && block_valid) atomicAdd(reinterpret_cast<unsigned*>(&fc->sort.n_valid), block_valid);
}

// The flat key (rel0 * e + rel1) * e + rel2 of a packed key whose rel1 and
// rel2 fields are b1 and b2 bits wide.
__device__ __forceinline__ int flat_key(unsigned long long key, int b1, int b2, int e) {
  const int rel0 = static_cast<int>(key >> (b1 + b2));
  const int rel1 = static_cast<int>((key >> b2) & ((1ull << b1) - 1));
  const int rel2 = static_cast<int>(key & ((1ull << b2) - 1));
  return (rel0 * e + rel1) * e + rel2;
}

constexpr int kWalk = 4;  // positions a walk step adds at once

// Adds the run of `key` to `mo` (`add(mo, point)`) from staged position m on,
// in sorted order, while positions below `end` hold it; returns the position
// past the run's last. Staged positions are consecutive sorted ones and a
// run's positions are contiguous, so where the kWalk-th position ahead holds
// the key, every one before it does: those steps add kWalk points in order
// (each sum's order is the run's), with the next step's key and points read
// first. The last steps go one position at a time, each reading the next
// position before it adds its own.
template <typename Acc, typename Add>
__device__ __forceinline__ int walk(const unsigned long long* tile_key, const float4* tile_point, int m, int end,
                                    unsigned long long key, Acc& mo, Add add) {
  if (m + kWalk <= end && tile_key[m + kWalk - 1] == key) {
    float4 p[kWalk];
#pragma unroll
    for (int q = 0; q < kWalk; ++q) p[q] = tile_point[m + q];
    for (;;) {  // the next step's key and points are read before this step's adds
      const int next = m + kWalk;
      const bool more = next + kWalk <= end && tile_key[min(next + kWalk, end) - 1] == key;
      float4 np[kWalk];
#pragma unroll
      for (int q = 0; q < kWalk; ++q) np[q] = tile_point[min(next + q, end - 1)];
#pragma unroll
      for (int q = 0; q < kWalk; ++q) add(mo, p[q]);
      m = next;
      if (!more) break;
#pragma unroll
      for (int q = 0; q < kWalk; ++q) p[q] = np[q];
    }
  }
  if (m >= end) return m;
  unsigned long long k = tile_key[m];
  float4 p = tile_point[m];
  while (k == key) {
    const int next = m + 1 < end ? m + 1 : m;
    const unsigned long long next_key = tile_key[next];
    const float4 next_p = tile_point[next];
    add(mo, p);
    ++m;
    k = m < end ? next_key : ~key;
    p = next_p;
  }
  return m;
}

// A run pass after the sort: one tile of the sorted keys a block, kRunItems
// consecutive positions a thread; run r's sums (an `Acc`, each point added
// by `add` in sorted order) go to `write(acc, r, packed key)` when r <
// leaf_cap, and `mine` sums what `write` returns. The tile's points are
// gathered into shared memory at once, and each run start's thread walks its
// run there. The tile's last run may go on past the tile (a cell of more
// points than a tile holds, or one that straddles two): then the block
// stages the following positions kRunTile at a time (every thread's loads at
// once) and that run's thread walks each staging in turn. Returns false for
// a block past the last key (the whole block).
template <typename Acc, typename Add, typename Write>
__device__ __forceinline__ bool run_leaves(const unsigned long long* __restrict__ keys_a,
                                           const unsigned* __restrict__ vals_a,
                                           const unsigned long long* __restrict__ keys_b,
                                           const unsigned* __restrict__ vals_b, const ks::Control* sort,
                                           unsigned* ticket, unsigned* run_status, const float* __restrict__ xyz,
                                           int xs, int leaf_cap, Add add, Write write, unsigned& mine) {
  __shared__ unsigned long long tile_key[kRunTile];
  __shared__ float4 tile_point[kRunTile];
  __shared__ unsigned long long carry_key;  // the key of the run that goes on past the tile
  __shared__ int carry;                     // 0: none, 1: the block stages for it, 2: it has ended
  const int n = sort->n_valid;
  const bool in_a = (sort->n_passes & 1) != 0;
  const unsigned long long* __restrict__ skeys = in_a ? keys_a : keys_b;
  const unsigned* __restrict__ vals = in_a ? vals_a : vals_b;
  mine = 0;
  RunTile t;
  if (!load_run_tile(skeys, n, ticket, t)) return false;
  if (threadIdx.x == 0) carry = 0;
  unsigned src[kRunItems];
#pragma unroll
  for (int j = 0; j < kRunItems; ++j) src[j] = t.in[j] ? vals[t.first + t.mine0 + j] : 0u;
#pragma unroll
  for (int j = 0; j < kRunItems; ++j) {
    if (t.in[j]) {
      tile_key[t.mine0 + j] = t.key[j];
      const float* p = xyz + static_cast<long long>(xs) * src[j];
      tile_point[t.mine0 + j] = make_float4(p[0], p[1], p[2], 0.0f);
    }
  }
  number_runs(t, run_status);  // ends with a barrier
  unsigned r = t.r;
  bool carrier = false;  // this thread's last run goes on past the tile
  Acc carried;
  unsigned carried_row = 0;
  unsigned long long carried_key = 0;

#pragma unroll
  for (int j = 0; j < kRunItems; ++j) {
    if (!t.start[j]) continue;
    const unsigned row = r++;
    if (row >= static_cast<unsigned>(leaf_cap)) continue;
    Acc mo;
    const int m = walk(tile_key, tile_point, t.mine0 + j, t.n, t.key[j], mo, add);
    if (m == kRunTile && t.first + kRunTile < n) {
      carrier = true;
      carried = mo;
      carried_row = row;
      carried_key = t.key[j];
      carry_key = t.key[j];
      carry = 1;
      continue;
    }
    mine += write(mo, row, t.key[j]);
  }
  __syncthreads();
  if (carry == 1) {  // the whole block: every thread read carry after the barrier
    const unsigned long long key = carry_key;
    for (long long base = t.first + kRunTile;; base += kRunTile) {
      const int count = static_cast<int>(min(static_cast<long long>(kRunTile), n - base));
      unsigned long long k[kRunItems];
      unsigned at[kRunItems];
#pragma unroll
      for (int j = 0; j < kRunItems; ++j) k[j] = t.mine0 + j < count ? skeys[base + t.mine0 + j] : ~key;
#pragma unroll
      for (int j = 0; j < kRunItems; ++j) at[j] = k[j] == key ? vals[base + t.mine0 + j] : 0u;
#pragma unroll
      for (int j = 0; j < kRunItems; ++j) {
        tile_key[t.mine0 + j] = k[j];
        if (k[j] == key) {
          const float* p = xyz + static_cast<long long>(xs) * at[j];
          tile_point[t.mine0 + j] = make_float4(p[0], p[1], p[2], 0.0f);
        }
      }
      __syncthreads();
      if (carrier) {
        const int m = walk(tile_key, tile_point, 0, count, key, carried, add);
        if (m < count || base + kRunTile >= n) carry = 2;
      }
      __syncthreads();
      if (carry == 2) break;
    }
    if (carrier) mine += write(carried, carried_row, carried_key);
  }
  return true;
}

}  // namespace
