// Kernel 3: NDT voxel-Gaussian map build, the flat-key sort included, with
// the closed-form 3x3 eigh (linalg3.cuh) as a __device__ function.
//
// Replaces: lv_slam_tpu/ops/voxel_map.py:66 `build_voxel_map` (the voxel
// keys relative to the masked minimum cell, the key sort, the per-leaf
// moments, covariance, min-points rule, eigh, eq. 6.11 inflation, inverse
// covariance and PCA weight) and lv_slam_tpu/ops/linalg3.py:25 `eigh3x3`.
//
// What bounds it on the card: per keyframe it reads 65536 lanes of xyz and
// mask once, sorts their keys and writes leaf_cap rows of 3+9+1+3+1 values
// (about 2.3 MB at leaf_cap 32768): a few microseconds of HBM traffic. The
// per-leaf math (a 28-float moment walk, one eigh, a 3x3 reconstruction) is
// a few hundred flops, so the kernel is latency-bound at this size, and one
// thread per leaf keeps every leaf's math in registers.
//
// Design (`lvs_voxel_map`, one C call of 6 launches at e = 256, no host
// read and no torch op between them; the shape of kernel 1's, with its
// partial rows, scratch layout, run numbering, flat-key front end and run
// walk from csrc/voxel_keys.cuh, shared with kernel 14, and its passes from
// csrc/key_sort.cuh):
// 1. `leaf_ranges` (at most 132 blocks, each thread a stride of lanes):
//    the cell coordinates floor(x * (1/res)) of the unmasked lanes, as
//    `ops/cells.cell_coords` takes them, each block's minima (masked lanes
//    fold in 2^30, the twin's `where(mask, coords, BIG).amin`), maxima and
//    unmasked count to its own partial row. The same launch zeroes the
//    sort's words, `n_leaves` and every leaf row (key -1): a run pass
//    overwrites the rows that runs reach.
// 2. `leaf_keys`: every block reduces the partial rows. The origin is the
//    masked minimum cell, 0 on an axis where it is 2^30 (no unmasked lane);
//    block 0 writes it as `origin_cell`. An in-extent lane (unmasked, 0 <=
//    rel < e on each axis) gets (rel0, rel1, rel2) packed most significant
//    first, each field min(max - origin, e - 1) wide in bits: the flat key's
//    order in <= 3 digit passes at e = 256 (torch.sort's int32 key took 4),
//    fewer on a coarse map. Other lanes get kInvalidKey and are dropped (in
//    the twin they sort behind every leaf and make none). The block counts
//    each pass's digits and adds its in-extent lanes to the sort's count.
// 3. ceil(3 * ceil(log2 e) / 8) launches of `key_sort_pass` (3 at e = 256
//    and at e = 64): stable, so a voxel's points stay in input order; a pass
//    past the key's width returns at once, on the device word.
// 4. `leaf_runs`, a tile of sorted positions a block: run starts numbered
//    by decoupled look-back give the leaf index; the tile's points are
//    gathered into shared memory with every load issued at once; one
//    thread per run start walks its run in sorted order there (a run that
//    goes on past the tile: the block stages the following positions a
//    tile at a time, every load at once, and the run's thread walks each
//    staging), runs the per-leaf arithmetic (the moments centred on each
//    point's cell centre, so |c| <= res/2 keeps the float32 second moments
//    free of cancellation) and writes the whole leaf row with its flat key.
//    Runs at or past leaf_cap are dropped, as the reference's scratch
//    bucket drops them. The block adds its valid leaves to `n_leaves`
//    (integer atomics: the total does not depend on the order).
// Every leaf's sums keep the order and the arithmetic of the design this
// replaced (`build_leaves`, one thread a run start after torch.sort), so the
// outputs are bit for bit its outputs (`scripts/k3_parent.py` holds them so
// on the card).
//
// Where the time goes: the longest run's thread. A voxel of the loop
// detector's 4 m rung holds hundreds of points or more, and one voxel
// holding every lane is one chain of n points: the sums must run in order.
//
// Kernel K3L replaces lv_slam_tpu/ops/voxel_map.py:177-181, the dense LUT
// scatter inside `build_voxel_map`: an (E^3,) int32 table of -1 with each
// valid leaf's row at its flat key.
//   Bound on the card: at E = 256 the table is 64 MiB, written once per
//   keyframe: about 20 us at 3.35 TB/s; the leaves' keys and flags (160 KB)
//   are noise beside it.
//   Design: `lut_fill` writes -1 with 16-byte stores over a grid-stride loop,
//   then `lut_scatter` runs one thread per leaf and writes its row where the
//   leaf is valid. Valid leaves have distinct keys, so every entry has at
//   most one writer and the table is deterministic.
#include "common.cuh"
#include "key_sort.cuh"
#include "linalg3.cuh"
#include "voxel_keys.cuh"

namespace {

// jnp.maximum semantics: NaN propagates.
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf("") : fmaxf(a, b);
}

__global__ void __launch_bounds__(lvs::kThreads) leaf_ranges(
    const float* __restrict__ xyz, int xs, const bool* __restrict__ mask, int ms, int n, float inv,
    int* __restrict__ part,
    unsigned* __restrict__ zero, long long n_zero, int leaf_cap, float* __restrict__ means,
    float* __restrict__ icovs, float* __restrict__ weights, float* __restrict__ normals, bool* __restrict__ valid,
    int* __restrict__ keys, int* __restrict__ origin, int* __restrict__ n_leaves) {
  flat_ranges(xyz, xs, mask, ms, n, inv, part, zero, n_zero);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = first; i < 9ll * leaf_cap; i += stride) icovs[i] = 0.0f;
  for (long long i = first; i < 3ll * leaf_cap; i += stride) {
    means[i] = 0.0f;
    normals[i] = 0.0f;
  }
  for (long long i = first; i < leaf_cap; i += stride) {
    weights[i] = 0.0f;
    valid[i] = false;
    keys[i] = -1;
  }
  if (first == 0) {  // for n = 0, where no keys pass runs
    origin[0] = origin[1] = origin[2] = 0;
    *n_leaves = 0;
  }
}

__global__ void __launch_bounds__(lvs::kThreads) leaf_keys(
    const float* __restrict__ xyz, int xs, const bool* __restrict__ mask, int ms, int n, float inv, int e,
    const int* __restrict__ part, int n_part, FlatControl* mc, int* __restrict__ origin_cell,
    unsigned long long* __restrict__ keys) {
  flat_keys(xyz, xs, mask, ms, n, inv, e, part, n_part, mc, origin_cell, keys);
}

// One voxel's sums, point by point in sorted order: moments centred on each
// point's cell centre (|c| <= res/2 keeps the float32 second moments free
// of cancellation). A run's points share their cell (its key is made of
// the same `lvs::cell_floor`), so the centre is taken once, at its first
// point, off the walk's chain of adds: the same value for every point.
struct Sums {
  float cnt = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  float s00 = 0.0f, s01 = 0.0f, s02 = 0.0f, s11 = 0.0f, s12 = 0.0f, s22 = 0.0f;
  float centre[3] = {0.0f, 0.0f, 0.0f};

  __device__ __forceinline__ void add(float px, float py, float pz, float res, float inv_res) {
    const float p[3] = {px, py, pz};
    if (cnt == 0.0f) {
#pragma unroll
      for (int a = 0; a < 3; ++a) centre[a] = (lvs::floor_cell(p[a], inv_res) + 0.5f) * res;
    }
    float c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) c[a] = p[a] - centre[a];
    cnt += 1.0f;
    s0 += c[0]; s1 += c[1]; s2 += c[2];
    s00 += c[0] * c[0]; s01 += c[0] * c[1]; s02 += c[0] * c[2];
    s11 += c[1] * c[1]; s12 += c[1] * c[2]; s22 += c[2] * c[2];
  }
};

__device__ void zero_leaf(int l, float* means, float* icovs, float* weights, float* normals,
                          bool* valid, int* keys, int key) {
  keys[l] = key;
  for (int c = 0; c < 3; ++c) means[3 * l + c] = 0.0f;
  for (int c = 0; c < 9; ++c) icovs[9 * l + c] = 0.0f;
  for (int c = 0; c < 3; ++c) normals[3 * l + c] = 0.0f;
  weights[l] = 0.0f;
  valid[l] = false;
}

// The leaf row of one voxel from its sums; returns whether the leaf is valid.
__device__ __noinline__ bool write_leaf(Sums mo, int leaf, int key, const int* origin, float res, int e, int min_points,
                           float eig_mult, int weighted, float* __restrict__ means, float* __restrict__ icovs,
                           float* __restrict__ weights, float* __restrict__ normals, bool* __restrict__ valid,
                           int* __restrict__ keys) {
  const float cnt = mo.cnt;
  float m0 = mo.s0 / cnt, m1 = mo.s1 / cnt, m2 = mo.s2 / cnt;
  float f = (cnt - 1.0f) / cnt;
  float cv00 = (mo.s00 / cnt - m0 * m0) * f, cv01 = (mo.s01 / cnt - m0 * m1) * f;
  float cv02 = (mo.s02 / cnt - m0 * m2) * f, cv11 = (mo.s11 / cnt - m1 * m1) * f;
  float cv12 = (mo.s12 / cnt - m1 * m2) * f, cv22 = (mo.s22 / cnt - m2 * m2) * f;

  // world mean = leaf cell center + centered mean
  int kz = key % e, ky = (key / e) % e, kx = key / (e * e);
  float mean[3] = {(static_cast<float>(kx + origin[0]) + 0.5f) * res + m0,
                   (static_cast<float>(ky + origin[1]) + 0.5f) * res + m1,
                   (static_cast<float>(kz + origin[2]) + 0.5f) * res + m2};

  bool occupied = cnt >= static_cast<float>(min_points);
  if (!occupied) {  // the reference decomposes the identity here, then zeroes the leaf: no eigh needed
    zero_leaf(leaf, means, icovs, weights, normals, valid, keys, key);
    return false;
  }
  float ev[3];
  lvs::Vec3 vec[3];
  lvs::eigh3x3(cv00, cv01, cv02, cv11, cv12, cv22, ev, vec);
  float tol = 1e-5f * fabsf(ev[2]);
  bool pos_def = (ev[0] >= -tol) && (ev[1] >= -tol) && (ev[2] > 0.0f);
  float min_ev = eig_mult * ev[2];
  float evi[3], inv[3];
  for (int j = 0; j < 3; ++j) {
    evi[j] = jmax(ev[j], min_ev);
    inv[j] = 1.0f / jmax(evi[j], 1e-30f);
  }
  // icov = V diag(inv) V^T; V[i][j] is component i of eigenvector j
  float V[3][3] = {{vec[0].x, vec[1].x, vec[2].x},
                   {vec[0].y, vec[1].y, vec[2].y},
                   {vec[0].z, vec[1].z, vec[2].z}};
  float ic[9];
  bool finite = true;
  for (int i = 0; i < 3; ++i) {
    for (int k = 0; k < 3; ++k) {
      float s = V[i][0] * inv[0] * V[k][0];
      s += V[i][1] * inv[1] * V[k][1];
      s += V[i][2] * inv[2] * V[k][2];
      ic[3 * i + k] = s;
      finite = finite && isfinite(s);
    }
  }
  bool ok = pos_def && finite;
  if (!ok) {
    zero_leaf(leaf, means, icovs, weights, normals, valid, keys, key);
    return false;
  }
  float w = 1.0f;
  if (weighted) {
    float sg[3];
    for (int j = 0; j < 3; ++j) sg[j] = sqrtf(jmax(evi[j], 0.0f));
    float s_max = jmax(sg[2], 1e-30f);
    float feats[3] = {(sg[2] - sg[1]) / s_max, (sg[1] - sg[0]) / s_max, sg[0] / s_max};
    // argmax, ties to the lower index; scales: linear 0.75, planar 1.25, spherical 1.0
    float scale = 0.75f, best = feats[0];
    if (feats[1] > best) { scale = 1.25f; best = feats[1]; }
    if (feats[2] > best) { scale = 1.0f; }
    w = scale * sqrtf(mean[0] * mean[0] + mean[1] * mean[1] + mean[2] * mean[2]);
  }
  for (int c = 0; c < 3; ++c) means[3 * leaf + c] = mean[c];
  for (int c = 0; c < 9; ++c) icovs[9 * leaf + c] = ic[c];
  normals[3 * leaf + 0] = vec[0].x;
  normals[3 * leaf + 1] = vec[0].y;
  normals[3 * leaf + 2] = vec[0].z;
  weights[leaf] = w;
  valid[leaf] = true;
  keys[leaf] = key;
  return true;
}

// `run_leaves` (csrc/voxel_keys.cuh): run r's leaf into row r when r <
// leaf_cap, its sums walked in sorted order; the block adds its valid
// leaves to n_leaves.
__global__ void __launch_bounds__(ks::kThreads) leaf_runs(
    const unsigned long long* __restrict__ keys_a, const unsigned* __restrict__ vals_a,
    const unsigned long long* __restrict__ keys_b, const unsigned* __restrict__ vals_b, FlatControl* mc,
    unsigned* run_status, const float* __restrict__ xyz, int xs, float res, float inv_res, int e, int leaf_cap,
    int min_points, float eig_mult, int weighted, float* __restrict__ means, float* __restrict__ icovs,
    float* __restrict__ weights, float* __restrict__ normals, bool* __restrict__ valid, int* __restrict__ keys,
    int* __restrict__ n_leaves) {
  __shared__ unsigned block_leaves;
  if (threadIdx.x == 0) block_leaves = 0u;
  const auto add = [=](Sums& mo, const float4& p) { mo.add(p.x, p.y, p.z, res, inv_res); };
  const auto write = [&](const Sums& mo, unsigned row, unsigned long long key) -> unsigned {
    return write_leaf(mo, static_cast<int>(row), flat_key(key, mc->b1, mc->b2, e), mc->origin, res, e, min_points,
                      eig_mult, weighted, means, icovs, weights, normals, valid, keys);
  };
  unsigned mine;
  if (!run_leaves<Sums>(keys_a, vals_a, keys_b, vals_b, &mc->sort, &mc->sort.tickets[ks::kMaxPasses], run_status,
                        xyz, xs, leaf_cap, add, write, mine))
    return;  // whole block
  mine = lvs::warp_sum(mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&block_leaves, mine);
  __syncthreads();
  if (threadIdx.x == 0 && block_leaves) atomicAdd(n_leaves, static_cast<int>(block_leaves));
}

// ---------------------------------------------------------------- kernel K3L

__global__ void lut_fill(int4* __restrict__ lut4, long long n4) {
  const int4 empty = make_int4(-1, -1, -1, -1);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    lut4[i] = empty;
}

__global__ void lut_scatter(const int* __restrict__ keys, const bool* __restrict__ valid, int leaf_cap,
                            int e3, int* __restrict__ lut) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= leaf_cap || !valid[l]) return;
  int k = keys[l];
  if (k >= 0 && k < e3) lut[k] = l;
}

}  // namespace

Layout map_layout(int n) { return layout(n, sizeof(FlatControl)); }

extern "C" long long lvs_voxel_map_scratch_bytes(int n) { return static_cast<long long>(map_layout(n).total); }

// xyz (n, 3) and mask (n,) of the cloud, lane i's point at xyz + xs * i and
// its flag at mask + ms * i (a strided subsample is read in place);
// outputs leaf_cap rows, origin (3,) and n_leaves (); scratch of
// lvs_voxel_map_scratch_bytes(n) bytes. The flat key (rel0 * e + rel1) * e
// + rel2 must fit an int: 1 <= e <= 1290.
extern "C" int lvs_voxel_map(const float* xyz, int xs, const bool* mask, int ms, int n, float res, float inv_res,
                             int e, int leaf_cap,
                             int min_points, float eig_mult, int weighted, void* scratch, long long scratch_bytes,
                             float* means, float* icovs, float* weights, float* normals, bool* valid, int* keys,
                             int* origin, int* n_leaves, cudaStream_t stream) {
  if (n < 0 || n > ks::kMaxKeys || leaf_cap < 0 || e < 1 || e > 1290 || xs < 3 || ms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = map_layout(n);
  if (scratch_bytes < static_cast<long long>(l.total)) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch s = scratch_at(scratch, l);
  auto* mc = reinterpret_cast<FlatControl*>(s.base);
  const int range_blocks = range_blocks_for(n, 9ll * leaf_cap, s.n_zero);
  leaf_ranges<<<range_blocks, lvs::kThreads, 0, stream>>>(xyz, xs, mask, ms, n, inv_res, s.part,
                                                          reinterpret_cast<unsigned*>(s.base), s.n_zero, leaf_cap,
                                                          means, icovs, weights, normals, valid, keys, origin,
                                                          n_leaves);
  if (n == 0) LVS_RETURN_LAST_ERROR();
  leaf_keys<<<std::min(lvs::blocks_for(n), kKeyBlocks), lvs::kThreads, 0, stream>>>(
      xyz, xs, mask, ms, n, inv_res, e, s.part, range_blocks, mc, origin, s.keys_b);
  // each key field is at most bit_width(e - 1) wide: at e = 256, 24 bits in 3 passes
  int field_bits = 0;
  while ((1 << field_bits) < e) ++field_bits;
  const int max_passes = std::max(1, (3 * field_bits + ks::kDigitBits - 1) / ks::kDigitBits);
  ks::launch_passes(n, s.keys_a, s.vals_a, s.keys_b, s.vals_b, &mc->sort, s.status, stream, max_passes);
  leaf_runs<<<(n + kRunTile - 1) / kRunTile, ks::kThreads, 0, stream>>>(
      s.keys_a, s.vals_a, s.keys_b, s.vals_b, mc, s.run_status, xyz, xs, res, inv_res, e, leaf_cap, min_points,
      eig_mult, weighted, means, icovs, weights, normals, valid, keys, n_leaves);
  LVS_RETURN_LAST_ERROR();
}

// lut: (e3,) int32, e3 = extent^3; torch's allocations are 512-byte aligned,
// so the int4 view is aligned; the e3 % 4 tail is filled by the last thread
extern "C" int lvs_voxel_map_lut(const int* keys, const bool* valid, int leaf_cap, int e3, int* lut,
                                 cudaStream_t stream) {
  long long n4 = e3 / 4;
  if (n4 > 0) {
    long long blocks = (n4 + lvs::kThreads - 1) / lvs::kThreads;
    lut_fill<<<static_cast<int>(blocks < 4096 ? blocks : 4096), lvs::kThreads, 0, stream>>>(
        reinterpret_cast<int4*>(lut), n4);
  }
  if (e3 % 4) cudaMemsetAsync(lut + 4 * n4, 0xFF, (e3 % 4) * sizeof(int), stream);
  if (leaf_cap > 0)
    lut_scatter<<<lvs::blocks_for(leaf_cap), lvs::kThreads, 0, stream>>>(keys, valid, leaf_cap, e3, lut);
  LVS_RETURN_LAST_ERROR();
}
