// Kernels 1b, 2 and 2r: first-point-per-voxel dedup, and the keyframe
// window's gather + motion-compose in front of it (of filtered scans for K2);
// and the raw window group, the same front with the distance band, reduced to
// voxel centroids (K2r).
//
// Replaces: lv_slam_tpu/ops/prefilter.py:203 `voxel_dedup_first` (K1b),
// lv_slam_tpu/utils/jit_cache.py:127 `window_group_filtered_fn` (K2; the
// flush :44 and the partial merge :185 are K1b over a concatenation) and
// :78 `window_group_fn` (K2r: `window_raw_ranges` here, then kernel 1's
// keys, sort and centroid pass, csrc/voxel_keys.cuh).
//
// What bounds it on the card: memory traffic. A window group reads up to
// 16 x 131072 filtered lanes (16 bytes each; a raw lane 17), writes their
// moved positions, intensities and masks (2.1 M rows, ~36 MB), sorts their
// keys and writes 131072 rows; there are a few flops per lane. The sort's
// passes move the keys and lane indices (12 bytes a valid lane) once a pass.
//
// Design (`lvs_voxel_dedup` for K1b, `lvs_window_dedup` for K2,
// `lvs_window_raw` for K2r: each one C call of 3 + kMaxPasses launches, no
// host read and no torch op between them), over kernel 1's front end
// (`csrc/voxel_keys.cuh`):
// 1. K1b: `voxel_ranges`, kernel 1's own. K2: `window_ranges`, a grid of at
//    most 528 blocks, each thread a stride of lanes: lane i = l * cap + p
//    gathers point p of chunk row clamp(start + l), moves it with an
//    explicit fma chain (the contraction XLA makes of the reference's
//    einsum on the CPU) and writes its mask (mask AND the row's `valid`) to
//    the scratch, and an unmasked lane's moved point and intensity (the
//    later passes read nothing else of a masked lane); the same pass takes
//    the voxel ranges of the moved lanes, zeroes the sort's words and pads
//    the output rows, as `voxel_ranges`. K2r: `window_raw_ranges`, the same
//    over the raw (C, cap, 3) layout, with the distance band: a lane stays
//    where near < |p| < far, |p| taken as the reference's compiled
//    `jnp.linalg.norm` rounds it on the CPU (sqrtf(fma(z, z, fma(y, y, x *
//    x))), correctly rounded); a kept lane's moved point and intensity go
//    out as one 16-byte word, so the centroid pass gathers a lane with one
//    load.
// 2. `voxel_keys` and the sort passes (`csrc/key_sort.cuh`): the key is
//    kernel 1's, (kx, clipped cy, clipped cz) rebased into the fewest bits,
//    which orders lanes exactly as the twins' int64 key kx * 2^31 + (y|z)
//    and their stable sort (ties keep the lower input index, as the
//    reference's iota-carrying `lax.sort`). A lane has a key where it is
//    unmasked and kx < 2^30. At 0.1 m over a 16-scan window the key is
//    about 31 bits: 4 passes where torch.sort's int64 key took 8.
// 3. K1b and K2: `dedup_runs`, a tile of sorted keys per block: the run
//    starts, their index by decoupled look-back, and run r's first lane (the
//    lowest input index of its voxel, as the stable sort keeps it) copied to
//    row r when r < out_cap. The output is front-compacted in key order with
//    no float arithmetic and no atomics, so it equals the plain twin lane for
//    lane. K2r: kernel 1's `voxel_runs`, each run start summing its run in
//    sorted order, which is input order within a voxel, the order of the
//    twin's `index_add_`: the centroids are the twin's bit for bit. The
//    group's 2 M lanes hold ~216 k voxels for 131072 rows: a tile past the
//    last row's run numbers its runs and gathers nothing.
//
// K2r before this route wrote a packed int64 key for every lane, sorted
// the 2.1 M keys with torch.sort (8 radix passes, the largest part of the
// group's device time) and walked each run from one thread after a torch
// cumsum of the run starts; the rebased key sorts in half the passes and
// the group is one C call.
#include "common.cuh"
#include "key_sort.cuh"
#include "voxel_keys.cuh"

namespace {

// row r of the moved point: x * T[r][0], then fma(y, T[r][1], .), fma(z,
// T[r][2], .), plus T[r][3]
__device__ __forceinline__ void move_point(const float* __restrict__ T, float x, float y, float z, bool m,
                                           float (&moved)[3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float acc = x * T[4 * r + 0];
    acc = fmaf(y, T[4 * r + 1], acc);
    acc = fmaf(z, T[4 * r + 2], acc);
    moved[r] = m ? acc + T[4 * r + 3] : lvs::kSentinel;
  }
}

// lane i = l * cap + p: point p of chunk row clamp(start + l), moved by
// rels[l] into (mxyz, minten, mmask); the moved lanes' voxel ranges, the
// zeroed words and the padding as `voxel_ranges`
__global__ void __launch_bounds__(lvs::kThreads) window_ranges(
    const float* __restrict__ xyz_t, const float* __restrict__ inten, const bool* __restrict__ mask, int n_rows,
    int cap, int start, int length, const float* __restrict__ rels, const bool* __restrict__ valid, float inv_res,
    float* __restrict__ mxyz, float* __restrict__ minten, bool* __restrict__ mmask, int* __restrict__ part,
    unsigned* __restrict__ zero, long long n_zero, int out_cap, float* __restrict__ out_xyz,
    float* __restrict__ out_int, bool* __restrict__ out_mask) {
  const int n = length * cap;
  const int stride = gridDim.x * blockDim.x;
  int v[kParts];
  empty_ranges(v);
#pragma unroll 4
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int l = i / cap, p = i - l * cap;
    const int row = clampi(start + l, 0, n_rows - 1);
    const long long base = static_cast<long long>(row) * cap;
    const bool m = mask[base + p] && valid[l];
    mmask[i] = m;
    if (!m) continue;  // the later passes read a masked lane's mask only
    float moved[3];
    move_point(rels + 16 * l, xyz_t[3 * base + p], xyz_t[3 * base + cap + p], xyz_t[3 * base + 2 * cap + p], m,
               moved);
    mxyz[3ll * i + 0] = moved[0];
    mxyz[3ll * i + 1] = moved[1];
    mxyz[3ll * i + 2] = moved[2];
    minten[i] = inten[base + p];
    int kx, cy, cz;
    voxel_coords(moved[0], moved[1], moved[2], inv_res, kx, cy, cz);
    if (kx < kBigX) add_range(v, kx, cy, cz);
  }
  finish_ranges(v, part, zero, n_zero, out_cap, out_xyz, out_int, out_mask);
}

// lane i = l * cap + p: raw point p of chunk row clamp(start + l) (the
// (C, cap, 3) layout), kept in the distance band and moved by rels[l], into
// mpoint (x, y, z, intensity) and mmask; the moved lanes' voxel ranges, the
// zeroed words and the padding as `voxel_ranges`
__global__ void __launch_bounds__(lvs::kThreads) window_raw_ranges(
    const float* __restrict__ xyz, const float* __restrict__ inten, const bool* __restrict__ mask, int n_rows,
    int cap, int start, int length, const float* __restrict__ rels, const bool* __restrict__ valid, float near,
    float far, float inv_res, float4* __restrict__ mpoint, bool* __restrict__ mmask, int* __restrict__ part,
    unsigned* __restrict__ zero, long long n_zero, int out_cap, float* __restrict__ out_xyz,
    float* __restrict__ out_int, bool* __restrict__ out_mask) {
  const int n = length * cap;
  const int stride = gridDim.x * blockDim.x;
  int v[kParts];
  empty_ranges(v);
#pragma unroll 4
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int l = i / cap, p = i - l * cap;
    const int row = clampi(start + l, 0, n_rows - 1);
    const long long lane = static_cast<long long>(row) * cap + p;
    bool m = mask[lane] && valid[l];
    float x = 0.0f, y = 0.0f, z = 0.0f;
    if (m) {
      x = xyz[3 * lane + 0];
      y = xyz[3 * lane + 1];
      z = xyz[3 * lane + 2];
      const float dist = sqrtf(fmaf(z, z, fmaf(y, y, x * x)));
      m = dist > near && dist < far;
    }
    mmask[i] = m;
    if (!m) continue;  // the later passes read a masked lane's mask only
    float moved[3];
    move_point(rels + 16 * l, x, y, z, true, moved);
    mpoint[i] = make_float4(moved[0], moved[1], moved[2], inten[lane]);
    int kx, cy, cz;
    voxel_coords(moved[0], moved[1], moved[2], inv_res, kx, cy, cz);
    if (kx < kBigX) add_range(v, kx, cy, cz);
  }
  finish_ranges(v, part, zero, n_zero, out_cap, out_xyz, out_int, out_mask);
}

// One tile of the sorted keys a block, kRunItems consecutive positions a
// thread: run r's first lane into row r.
__global__ void __launch_bounds__(ks::kThreads) dedup_runs(
    const unsigned long long* __restrict__ keys_a, const unsigned* __restrict__ vals_a,
    const unsigned long long* __restrict__ keys_b, const unsigned* __restrict__ vals_b, VoxelControl* vc,
    unsigned* run_status, const float* __restrict__ xyz, const float* __restrict__ inten, int out_cap,
    float* __restrict__ out_xyz, float* __restrict__ out_int, bool* __restrict__ out_mask) {
  const int n = vc->sort.n_valid;
  const bool in_a = (vc->sort.n_passes & 1) != 0;
  const unsigned long long* __restrict__ keys = in_a ? keys_a : keys_b;
  const unsigned* __restrict__ vals = in_a ? vals_a : vals_b;
  RunTile t;
  if (!load_run_tile(keys, n, &vc->sort.tickets[ks::kMaxPasses], t)) return;  // whole block
  unsigned src[kRunItems];
#pragma unroll
  for (int j = 0; j < kRunItems; ++j) src[j] = t.start[j] ? vals[t.first + t.mine0 + j] : 0u;
  number_runs(t, run_status);
  unsigned r = t.r;
#pragma unroll
  for (int j = 0; j < kRunItems; ++j) {
    if (!t.start[j]) continue;
    const unsigned row = r++;
    if (row >= static_cast<unsigned>(out_cap)) continue;
    const long long at = src[j];
    out_xyz[3 * row + 0] = xyz[3 * at + 0];
    out_xyz[3 * row + 1] = xyz[3 * at + 1];
    out_xyz[3 * row + 2] = xyz[3 * at + 2];
    out_int[row] = inten[at];
    out_mask[row] = true;
  }
}

// K2's and K2r's scratch: kernel 1's layout with a partial row for each of
// up to kWindowBlocks blocks (four an SM: a window group's 2.1 M lanes need
// the loads of more warps in flight than one block an SM holds), then the
// moved lanes (K2: xyz, intensity, mask; K2r: xyz and intensity packed in
// 16 bytes, then the mask)
constexpr int kWindowBlocks = 4 * kRangeBlocks;
constexpr size_t kMovedBytes = 3 * sizeof(float) + sizeof(float) + sizeof(bool);

Layout window_layout(int n) {
  return layout(n, sizeof(VoxelControl), static_cast<size_t>(n) * kMovedBytes + 512, kWindowBlocks);
}

void launch_runs(int n, const Scratch& s, const float* xyz, const float* inten, int out_cap, float* out_xyz,
                 float* out_int, bool* out_mask, cudaStream_t stream) {
  dedup_runs<<<(n + kRunTile - 1) / kRunTile, ks::kThreads, 0, stream>>>(
      s.keys_a, s.vals_a, s.keys_b, s.vals_b, reinterpret_cast<VoxelControl*>(s.base), s.run_status, xyz, inten,
      out_cap, out_xyz, out_int, out_mask);
}

}  // namespace

// K1b: scratch of lvs_voxel_scratch_bytes(n) bytes (kernel 1's layout);
// out_cap at most n
extern "C" int lvs_voxel_dedup(const float* xyz, const float* inten, const bool* mask, int n, float inv_res,
                               int out_cap, void* scratch, long long scratch_bytes, float* out_xyz, float* out_int,
                               bool* out_mask, cudaStream_t stream) {
  if (n < 0 || n > ks::kMaxKeys || out_cap < 0 || out_cap > n) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(n);
  if (scratch_bytes < static_cast<long long>(l.total)) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = scratch_at(scratch, l);
  const int range_blocks = range_blocks_for(n, out_cap, s.n_zero);
  voxel_ranges<<<range_blocks, lvs::kThreads, 0, stream>>>(xyz, mask, n, inv_res, s.part,
                                                           reinterpret_cast<unsigned*>(s.base), s.n_zero, out_cap,
                                                           out_xyz, out_int, out_mask);
  if (n == 0) LVS_RETURN_LAST_ERROR();
  launch_keys_and_sort(xyz, mask, n, inv_res, range_blocks, s, stream);
  launch_runs(n, s, xyz, inten, out_cap, out_xyz, out_int, out_mask, stream);
  LVS_RETURN_LAST_ERROR();
}

extern "C" long long lvs_window_scratch_bytes(int n) { return static_cast<long long>(window_layout(n).total); }

// K2: scratch of lvs_window_scratch_bytes(length * cap) bytes; out_cap at
// most length * cap
extern "C" int lvs_window_dedup(const float* xyz_t, const float* inten, const bool* mask, int n_rows, int cap,
                                int start, int length, const float* rels, const bool* valid, float inv_res,
                                int out_cap, void* scratch, long long scratch_bytes, float* out_xyz, float* out_int,
                                bool* out_mask, cudaStream_t stream) {
  const long long n64 = static_cast<long long>(length) * cap;
  if (n_rows < 1 || cap < 0 || length < 0 || n64 > ks::kMaxKeys || out_cap < 0 || out_cap > n64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(n64);
  const Layout l = window_layout(n);
  if (scratch_bytes < static_cast<long long>(l.total)) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = scratch_at(scratch, l);
  auto* mxyz = reinterpret_cast<float*>(s.extra);
  float* minten = mxyz + 3ll * n;
  bool* mmask = reinterpret_cast<bool*>(minten + n);
  const int range_blocks = range_blocks_for(n, out_cap, s.n_zero, kWindowBlocks);
  window_ranges<<<range_blocks, lvs::kThreads, 0, stream>>>(xyz_t, inten, mask, n_rows, cap, start, length, rels,
                                                            valid, inv_res, mxyz, minten, mmask, s.part,
                                                            reinterpret_cast<unsigned*>(s.base), s.n_zero, out_cap,
                                                            out_xyz, out_int, out_mask);
  if (n == 0) LVS_RETURN_LAST_ERROR();
  launch_keys_and_sort(mxyz, mmask, n, inv_res, range_blocks, s, stream);
  launch_runs(n, s, mxyz, minten, out_cap, out_xyz, out_int, out_mask, stream);
  LVS_RETURN_LAST_ERROR();
}

// K2r: scratch of lvs_window_scratch_bytes(length * cap) bytes; out_cap may
// exceed length * cap (the rows past the voxels are padding)
extern "C" int lvs_window_raw(const float* xyz, const float* inten, const bool* mask, int n_rows, int cap, int start,
                              int length, const float* rels, const bool* valid, float near, float far, float inv_res,
                              int out_cap, void* scratch, long long scratch_bytes, float* out_xyz, float* out_int,
                              bool* out_mask, cudaStream_t stream) {
  const long long n64 = static_cast<long long>(length) * cap;
  if (n_rows < 1 || cap < 0 || length < 0 || n64 > ks::kMaxKeys || out_cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(n64);
  const Layout l = window_layout(n);
  if (scratch_bytes < static_cast<long long>(l.total)) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = scratch_at(scratch, l);
  auto* mpoint = reinterpret_cast<float4*>(s.extra);  // the moved xyz and intensity of K2's layout, packed
  bool* mmask = reinterpret_cast<bool*>(mpoint + n);
  const int range_blocks = range_blocks_for(n, out_cap, s.n_zero, kWindowBlocks);
  window_raw_ranges<<<range_blocks, lvs::kThreads, 0, stream>>>(xyz, inten, mask, n_rows, cap, start, length, rels,
                                                                valid, near, far, inv_res, mpoint, mmask, s.part,
                                                                reinterpret_cast<unsigned*>(s.base), s.n_zero,
                                                                out_cap, out_xyz, out_int, out_mask);
  if (n == 0) LVS_RETURN_LAST_ERROR();
  const auto* packed = reinterpret_cast<const float*>(mpoint);
  launch_keys_and_sort<4>(packed, mmask, n, inv_res, range_blocks, s, stream);
  launch_voxel_runs<4>(n, s, packed, nullptr, 0.0f, 0, out_cap, out_xyz, out_int, out_mask, stream);
  LVS_RETURN_LAST_ERROR();
}
