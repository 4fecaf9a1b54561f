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
// host read and no torch op between them; steps 1 and 2 are
// `csrc/voxel_keys.cuh`, which kernels 1b and 2 share):
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
#include "voxel_keys.cuh"

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
  const int n = vc->sort.n_valid;
  const bool in_a = (vc->sort.n_passes & 1) != 0;
  const unsigned long long* __restrict__ keys = in_a ? keys_a : keys_b;
  const unsigned* __restrict__ vals = in_a ? vals_a : vals_b;
  RunTile t;
  if (!load_run_tile(keys, n, &vc->sort.tickets[ks::kMaxPasses], t)) return;  // whole block
  unsigned src[kRunItems];
#pragma unroll
  for (int j = 0; j < kRunItems; ++j) src[j] = t.in[j] ? vals[t.first + t.mine0 + j] : 0u;
#pragma unroll
  for (int j = 0; j < kRunItems; ++j) {
    if (t.in[j]) {
      tile_key[t.mine0 + j] = t.key[j];
      tile_point[t.mine0 + j] = make_float4(xyz[3ll * src[j] + 0], xyz[3ll * src[j] + 1], xyz[3ll * src[j] + 2],
                                            inten[src[j]]);
    }
  }
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
        const long long at = vals[i];
        sx += xyz[3 * at + 0];
        sy += xyz[3 * at + 1];
        sz += xyz[3 * at + 2];
        si += inten[at];
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

// Kernel 1b's scratch (`lvs_voxel_dedup`) has the same layout.
extern "C" long long lvs_voxel_scratch_bytes(int n) { return static_cast<long long>(layout(n).total); }

extern "C" int lvs_voxel_downsample(const float* xyz, const float* inten, const bool* mask, int n, float inv_res,
                                    float res, int approx, int out_cap, void* scratch, long long scratch_bytes,
                                    float* out_xyz, float* out_int, bool* out_mask, cudaStream_t stream) {
  if (n < 0 || n > ks::kMaxKeys || out_cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(n);
  if (scratch_bytes < static_cast<long long>(l.total)) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = scratch_at(scratch, l);
  auto* vc = reinterpret_cast<VoxelControl*>(s.base);
  const int range_blocks = range_blocks_for(n, out_cap, s.n_zero);
  voxel_ranges<<<range_blocks, lvs::kThreads, 0, stream>>>(xyz, mask, n, inv_res, s.part,
                                                           reinterpret_cast<unsigned*>(s.base), s.n_zero, out_cap,
                                                           out_xyz, out_int, out_mask);
  if (n == 0) LVS_RETURN_LAST_ERROR();
  launch_keys_and_sort(xyz, mask, n, inv_res, range_blocks, s, stream);
  voxel_runs<<<(n + kRunTile - 1) / kRunTile, ks::kThreads, 0, stream>>>(
      s.keys_a, s.vals_a, s.keys_b, s.vals_b, vc, s.run_status, xyz, inten, res, approx, out_cap, out_xyz, out_int,
      out_mask);
  LVS_RETURN_LAST_ERROR();
}
