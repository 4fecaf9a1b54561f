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
// host read and no torch op between them; every step is in
// `csrc/voxel_keys.cuh`: kernel 1b shares steps 1-3, kernel 2 steps 2-3 and
// kernel 2r steps 2-4):
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
#include "common.cuh"
#include "key_sort.cuh"
#include "voxel_keys.cuh"

// Kernel 1b's scratch (`lvs_voxel_dedup`) has the same layout.
extern "C" long long lvs_voxel_scratch_bytes(int n) { return static_cast<long long>(layout(n).total); }

extern "C" int lvs_voxel_downsample(const float* xyz, const float* inten, const bool* mask, int n, float inv_res,
                                    float res, int approx, int out_cap, void* scratch, long long scratch_bytes,
                                    float* out_xyz, float* out_int, bool* out_mask, cudaStream_t stream) {
  if (n < 0 || n > ks::kMaxKeys || out_cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(n);
  if (scratch_bytes < static_cast<long long>(l.total)) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = scratch_at(scratch, l);
  const int range_blocks = range_blocks_for(n, out_cap, s.n_zero);
  voxel_ranges<<<range_blocks, lvs::kThreads, 0, stream>>>(xyz, mask, n, inv_res, s.part,
                                                           reinterpret_cast<unsigned*>(s.base), s.n_zero, out_cap,
                                                           out_xyz, out_int, out_mask);
  if (n == 0) LVS_RETURN_LAST_ERROR();
  launch_keys_and_sort(xyz, mask, n, inv_res, range_blocks, s, stream);
  launch_voxel_runs(n, s, xyz, inten, res, approx, out_cap, out_xyz, out_int, out_mask, stream);
  LVS_RETURN_LAST_ERROR();
}
