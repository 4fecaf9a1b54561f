// Kernel 16: RANSAC floor detection.
//
// Replaces: lv_slam_tpu/ops/floor.py:27 `detect_floor` (the hypotheses from
// the reference's random triples, the (N, H) inlier test and its counts,
// the argmax, the weighted mean and covariance of the best hypothesis's
// inliers, lv_slam_tpu/ops/linalg3.py:25 `eigh3x3` on it, and the gates).
//
// What bounds it on the card: operations. Each of N points (65536-131072
// lanes of a prefiltered scan) is tested against H = 256 planes, about 7
// flops each: N H 7 = 235 MFLOP at N = 131072, 3.5 us at the float32 peak;
// the points (1.5 MB) are read three times.
//
// Design: `floor_hypotheses` runs one thread per hypothesis: it gathers its
// triple (drawn on the host, see ops/floor.py), forms the normal as the
// reference's compiled `jnp.cross` rounds it (fma(u1, w2, -(u2 w1)), ...),
// its length, the +z orientation, the triple and normal gates and the offset
// d = -(n . p0) (an fma chain). `floor_count` gives each block the H planes
// in shared memory; each thread takes one point, and for a point in the z
// band tests |fma(z, n2, fma(y, n1, x n0)) + d| < thresh against every
// plane, counting in shared memory (one atomic per inlier), then one global
// atomic per hypothesis per block. Integer counts make the result
// independent of the order. `floor_finish` is one block: thread 0 takes the
// argmax (a failed hypothesis counts -1, the first index wins ties), then the
// block sums the best plane's inliers (the same test) and their positions
// with a fixed-order tree reduction, then their centred second moments, and
// thread 0 runs the eigh3x3 device function of kernel 4 on the covariance
// and applies the reference's gates.
#include "common.cuh"
#include "linalg3.cuh"

namespace {

constexpr int kFinishThreads = 1024;

__device__ __forceinline__ bool in_band(const float* xyz, const bool* mask, int i, float height, float clip) {
  return mask[i] && fabsf(xyz[3 * i + 2] + height) < clip;
}

__device__ __forceinline__ bool inlier(const float* xyz, int i, const float* pl, float thresh) {
  float x = xyz[3 * i + 0], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
  float dot = fmaf(z, pl[2], fmaf(y, pl[1], x * pl[0]));
  return fabsf(dot + pl[3]) < thresh;
}

__global__ void floor_hypotheses(const float* __restrict__ xyz, const bool* __restrict__ mask,
                                 const int* __restrict__ idx, int n_hyp, float height, float clip, float cos_thresh,
                                 float* __restrict__ planes, int* __restrict__ counts) {
  int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= n_hyp) return;
  int a = idx[3 * h + 0], b = idx[3 * h + 1], c = idx[3 * h + 2];
  bool tri_ok = in_band(xyz, mask, a, height, clip) && in_band(xyz, mask, b, height, clip) &&
                in_band(xyz, mask, c, height, clip);
  // masked lanes read as the sentinel, as the reference's masked_xyz
  float p0[3], u[3], w[3];
  for (int k = 0; k < 3; ++k) {
    p0[k] = mask[a] ? xyz[3 * a + k] : lvs::kSentinel;
    float p1 = mask[b] ? xyz[3 * b + k] : lvs::kSentinel;
    float p2 = mask[c] ? xyz[3 * c + k] : lvs::kSentinel;
    u[k] = p1 - p0[k];
    w[k] = p2 - p0[k];
  }
  float nv[3] = {fmaf(u[1], w[2], -(u[2] * w[1])), fmaf(u[2], w[0], -(u[0] * w[2])),
                 fmaf(u[0], w[1], -(u[1] * w[0]))};
  float nn = sqrtf(fmaf(nv[2], nv[2], fmaf(nv[1], nv[1], nv[0] * nv[0])));
  float den = fmaxf(nn, 1e-9f);
  float unit[3] = {nv[0] / den, nv[1] / den, nv[2] / den};
  if (unit[2] < 0.0f)
    for (int k = 0; k < 3; ++k) unit[k] = -unit[k];
  bool ok = tri_ok && nn > 1e-6f && unit[2] > cos_thresh;
  float d = -fmaf(unit[2], p0[2], fmaf(unit[1], p0[1], unit[0] * p0[0]));
  planes[4 * h + 0] = unit[0];
  planes[4 * h + 1] = unit[1];
  planes[4 * h + 2] = unit[2];
  planes[4 * h + 3] = d;
  counts[h] = ok ? 0 : -1;  // -1 marks a failed hypothesis; floor_count skips it
}

__global__ void floor_count(const float* __restrict__ xyz, const bool* __restrict__ mask, int n,
                            const float* __restrict__ planes, int n_hyp, float height, float clip, float thresh,
                            int* __restrict__ counts) {
  extern __shared__ float sh[];
  float* s_planes = sh;
  int* s_counts = reinterpret_cast<int*>(sh + 4 * n_hyp);
  for (int h = threadIdx.x; h < n_hyp; h += blockDim.x) {
    for (int k = 0; k < 4; ++k) s_planes[4 * h + k] = planes[4 * h + k];
    s_counts[h] = 0;
  }
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n && in_band(xyz, mask, i, height, clip))
    for (int h = 0; h < n_hyp; ++h)
      if (inlier(xyz, i, s_planes + 4 * h, thresh)) atomicAdd(s_counts + h, 1);
  __syncthreads();
  for (int h = threadIdx.x; h < n_hyp; h += blockDim.x)
    if (s_counts[h] > 0 && counts[h] >= 0) atomicAdd(counts + h, s_counts[h]);
}

// the block's fixed-order tree sum of v[0..kFinishThreads) (in shared memory)
__device__ float block_sum(float* v) {
  __syncthreads();
  for (int half = kFinishThreads / 2; half > 0; half >>= 1) {
    if (static_cast<int>(threadIdx.x) < half) v[threadIdx.x] += v[threadIdx.x + half];
    __syncthreads();
  }
  float out = v[0];
  __syncthreads();
  return out;
}

__global__ void floor_finish(const float* __restrict__ xyz, const bool* __restrict__ mask, int n,
                             const float* __restrict__ planes, const int* __restrict__ counts, int n_hyp,
                             float height, float clip, float thresh, float cos_thresh, float min_fraction,
                             float* __restrict__ coeffs, int* __restrict__ stats, bool* __restrict__ found) {
  __shared__ float red[kFinishThreads];
  __shared__ int s_best;
  int t = threadIdx.x;
  if (t == 0) {
    int best = 0;
    for (int h = 1; h < n_hyp; ++h)
      if (counts[h] > counts[best]) best = h;
    s_best = best;
  }
  __syncthreads();
  const float* pl = planes + 4 * s_best;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, sw = 0.0f, sb = 0.0f;
  for (int i = t; i < n; i += kFinishThreads) {
    if (!in_band(xyz, mask, i, height, clip)) continue;
    sb += 1.0f;
    if (!inlier(xyz, i, pl, thresh)) continue;
    sx += xyz[3 * i + 0];
    sy += xyz[3 * i + 1];
    sz += xyz[3 * i + 2];
    sw += 1.0f;
  }
  float sums[5] = {sx, sy, sz, sw, sb};
  for (int k = 0; k < 5; ++k) {
    red[t] = sums[k];
    sums[k] = block_sum(red);
  }
  float cnt = fmaxf(sums[3], 1.0f);
  float mu[3] = {sums[0] / cnt, sums[1] / cnt, sums[2] / cnt};
  float m[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // xx xy xz yy yz zz
  for (int i = t; i < n; i += kFinishThreads) {
    if (!in_band(xyz, mask, i, height, clip) || !inlier(xyz, i, pl, thresh)) continue;
    float cx = xyz[3 * i + 0] - mu[0], cy = xyz[3 * i + 1] - mu[1], cz = xyz[3 * i + 2] - mu[2];
    m[0] += cx * cx; m[1] += cx * cy; m[2] += cx * cz;
    m[3] += cy * cy; m[4] += cy * cz; m[5] += cz * cz;
  }
  for (int k = 0; k < 6; ++k) {
    red[t] = m[k];
    m[k] = block_sum(red) / cnt;
  }
  if (t != 0) return;
  float ev[3];
  lvs::Vec3 evec[3];
  lvs::eigh3x3(m[0], m[1], m[2], m[3], m[4], m[5], ev, evec);
  float nx = evec[0].x, ny = evec[0].y, nz = evec[0].z;
  if (nz < 0.0f) {
    nx = -nx; ny = -ny; nz = -nz;
  }
  coeffs[0] = nx;
  coeffs[1] = ny;
  coeffs[2] = nz;
  coeffs[3] = -fmaf(nz, mu[2], fmaf(ny, mu[1], nx * mu[0]));
  int best_count = counts[s_best];
  stats[0] = best_count;
  stats[1] = s_best;
  *found = best_count > 0 && sums[3] >= min_fraction * fmaxf(sums[4], 1.0f) && nz > cos_thresh;
}

}  // namespace

extern "C" int lvs_floor(const float* xyz, const bool* mask, int n, const int* idx, int n_hyp, float height,
                         float clip, float thresh, float cos_thresh, float min_fraction, float* planes, int* counts,
                         float* coeffs, int* stats, bool* found, cudaStream_t stream) {
  floor_hypotheses<<<1, n_hyp, 0, stream>>>(xyz, mask, idx, n_hyp, height, clip, cos_thresh, planes, counts);
  if (n > 0)
    floor_count<<<lvs::blocks_for(n), lvs::kThreads, n_hyp * (4 * sizeof(float) + sizeof(int)), stream>>>(
        xyz, mask, n, planes, n_hyp, height, clip, thresh, counts);
  floor_finish<<<1, kFinishThreads, 0, stream>>>(xyz, mask, n, planes, counts, n_hyp, height, clip, thresh,
                                                  cos_thresh, min_fraction, coeffs, stats, found);
  LVS_RETURN_LAST_ERROR();
}
