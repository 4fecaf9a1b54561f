// Kernel 2: NDT voxel-Gaussian map build, after the flat-key sort, with the
// closed-form 3x3 eigh (linalg3.cuh) as a __device__ function.
//
// Replaces: lv_slam_tpu/ops/voxel_map.py:66 `build_voxel_map` (the per-leaf
// moments, covariance, min-points rule, eigh, eq. 6.11 inflation, inverse
// covariance and PCA weight) and lv_slam_tpu/ops/linalg3.py:25 `eigh3x3`.
//
// What bounds it on the card: per keyframe it reads 65536 sorted keys, the
// permutation and the gathered points once and writes leaf_cap rows of
// 3+9+1+3+1 values (about 2.3 MB at leaf_cap 32768): a few microseconds of
// HBM traffic. The per-leaf math (a 28-float moment walk, one eigh, a 3x3
// reconstruction) is a few hundred flops, so the kernel is latency-bound at
// this size, and one thread per leaf keeps every leaf's math in registers.
//
// Design: `mark_leaves` flags run starts of in-extent keys; the wrapper's
// prefix sum turns them into leaf indices, so leaves come out in ascending key
// order as in the reference. `build_leaves` runs one thread per run start,
// walks the run sequentially (the reference's in-order segment_sum order, no
// atomics), and writes the whole leaf row; the same launch zeroes the rows
// no run reaches. Runs at or past leaf_cap are dropped, as the reference's
// scratch bucket drops them. Each leaf's flat key is written beside it, so
// that kernel K3L can scatter the dense LUT for the callers that probe one.
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
#include "linalg3.cuh"

namespace {

// jnp.maximum semantics: NaN propagates.
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf("") : fmaxf(a, b);
}

__global__ void mark_leaves(const int* __restrict__ skey, int n, int overflow_key,
                            int* __restrict__ flag) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int k = skey[i];
  bool start = (i == 0) || (k != skey[i - 1]);
  flag[i] = (start && k < overflow_key) ? 1 : 0;
}

__device__ void zero_leaf(int l, float* means, float* icovs, float* weights, float* normals,
                          bool* valid, int* keys, int key) {
  keys[l] = key;
  for (int c = 0; c < 3; ++c) means[3 * l + c] = 0.0f;
  for (int c = 0; c < 9; ++c) icovs[9 * l + c] = 0.0f;
  for (int c = 0; c < 3; ++c) normals[3 * l + c] = 0.0f;
  weights[l] = 0.0f;
  valid[l] = false;
}

__global__ void build_leaves(const int* __restrict__ skey, const long long* __restrict__ order,
                             const int* __restrict__ flag, const int* __restrict__ cum, int n,
                             const float* __restrict__ xyz, const int* __restrict__ origin,
                             float res, float inv_res, int e, int leaf_cap, int min_points,
                             float eig_mult, int weighted, float* __restrict__ means,
                             float* __restrict__ icovs, float* __restrict__ weights,
                             float* __restrict__ normals, bool* __restrict__ valid,
                             int* __restrict__ keys) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  int n_runs = n > 0 ? cum[n - 1] : 0;
  if (t < leaf_cap && t >= n_runs) zero_leaf(t, means, icovs, weights, normals, valid, keys, -1);
  if (t >= n || !flag[t]) return;
  int leaf = cum[t] - 1;
  if (leaf >= leaf_cap) return;
  int key = skey[t];

  // moments centered on each point's cell center: |c| <= res/2 keeps the
  // float32 second moments free of cancellation
  float cnt = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  float s00 = 0.0f, s01 = 0.0f, s02 = 0.0f, s11 = 0.0f, s12 = 0.0f, s22 = 0.0f;
  for (int j = t; j < n && skey[j] == key; ++j) {
    long long src = order[j];
    float p[3], c[3];
    for (int a = 0; a < 3; ++a) {
      p[a] = xyz[3 * src + a];
      c[a] = p[a] - (floorf(p[a] * inv_res) + 0.5f) * res;
    }
    cnt += 1.0f;
    s0 += c[0]; s1 += c[1]; s2 += c[2];
    s00 += c[0] * c[0]; s01 += c[0] * c[1]; s02 += c[0] * c[2];
    s11 += c[1] * c[1]; s12 += c[1] * c[2]; s22 += c[2] * c[2];
  }
  float m0 = s0 / cnt, m1 = s1 / cnt, m2 = s2 / cnt;
  float f = (cnt - 1.0f) / cnt;
  float cv00 = (s00 / cnt - m0 * m0) * f, cv01 = (s01 / cnt - m0 * m1) * f;
  float cv02 = (s02 / cnt - m0 * m2) * f, cv11 = (s11 / cnt - m1 * m1) * f;
  float cv12 = (s12 / cnt - m1 * m2) * f, cv22 = (s22 / cnt - m2 * m2) * f;

  // world mean = leaf cell center + centered mean
  int kz = key % e, ky = (key / e) % e, kx = key / (e * e);
  float mean[3] = {(static_cast<float>(kx + origin[0]) + 0.5f) * res + m0,
                   (static_cast<float>(ky + origin[1]) + 0.5f) * res + m1,
                   (static_cast<float>(kz + origin[2]) + 0.5f) * res + m2};

  bool occupied = cnt >= static_cast<float>(min_points);
  if (!occupied) {  // the reference decomposes the identity here, then zeroes the leaf
    cv00 = 1.0f; cv01 = 0.0f; cv02 = 0.0f; cv11 = 1.0f; cv12 = 0.0f; cv22 = 1.0f;
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
  bool ok = occupied && pos_def && finite;
  if (!ok) {
    zero_leaf(leaf, means, icovs, weights, normals, valid, keys, key);
    return;
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

extern "C" int lvs_voxel_map_mark(const int* skey, int n, int overflow_key, int* flag,
                                  cudaStream_t stream) {
  if (n > 0) mark_leaves<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(skey, n, overflow_key, flag);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_voxel_map_build(const int* skey, const long long* order, const int* flag,
                                   const int* cum, int n, const float* xyz, const int* origin,
                                   float res, float inv_res, int e, int leaf_cap, int min_points,
                                   float eig_mult, int weighted, float* means, float* icovs,
                                   float* weights, float* normals, bool* valid, int* keys,
                                   cudaStream_t stream) {
  int threads = n > leaf_cap ? n : leaf_cap;
  if (threads > 0)
    build_leaves<<<lvs::blocks_for(threads), lvs::kThreads, 0, stream>>>(
        skey, order, flag, cum, n, xyz, origin, res, inv_res, e, leaf_cap, min_points, eig_mult,
        weighted, means, icovs, weights, normals, valid, keys);
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
