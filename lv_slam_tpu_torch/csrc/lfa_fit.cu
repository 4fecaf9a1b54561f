// Kernel 10: LFA scan-to-map correspondences, line and plane fits over the
// hashed cell tables.
//
// Replaces: lv_slam_tpu/lfa/registration.py:58 `lines_from_fit` and :111
// `planes_from_fit`, on their CellTable branch, with the probe of
// lv_slam_tpu/ops/knn.py:238 `candidates_cell` inside.
//
// What bounds it on the card: the dependent random reads. Per query it reads
// 8 bucket rows of 96 bytes (4096 edge + 8064 surf queries per scan: ~9 MB of
// row reads that mostly hit L2) and does ~600 flops plus one 3x3 eigh; at
// 12k queries that is under 10 MFLOP, so the latency of the probe chain and
// the eigh are what show.
//
// Design: one thread per query. It hashes the 2x2x2 cell block around
// (q - cs/2) / cs, drops a probe whose bucket an earlier probe already read,
// and walks the 8 x S candidates in slot order three times (sum for the
// mean, sum for the covariance, and for planes the residual check), so the
// sums run in the reference's candidate order and the plain twin, a loop
// over the same 48 candidates, rounds identically. Candidates outside the
// 1 m gate add an exact zero, as the reference's masked sums do. The 3x3
// eigh is the voxel map's device function (linalg3.cuh). Accept rules: lines
// need n_use >= k and lambda2 > 3 max(lambda1, 1e-12); planes need
// n_use >= k, every participant within 0.2 m of the fit, and a finite fit.
#include "common.cuh"
#include "linalg3.cuh"

#include <math.h>

namespace {

constexpr unsigned kH1 = 73856093u, kH2 = 19349669u, kH3 = 83492791u;
constexpr int kMaxSlots = 32;

struct Probe {
  const float* rows[8];  // nullptr for a probe whose bucket an earlier one read
};

__device__ Probe probe(const float* table, int n_buckets, int slots, float cs, float qx, float qy,
                       float qz) {
  float half = cs / 2.0f;
  int b0 = static_cast<int>(floorf((qx - half) / cs));
  int b1 = static_cast<int>(floorf((qy - half) / cs));
  int b2 = static_cast<int>(floorf((qz - half) / cs));
  int bucket[8];
  Probe p;
  for (int o = 0; o < 8; ++o) {
    unsigned h = (static_cast<unsigned>(b0 + (o >> 2)) * kH1) ^
                 (static_cast<unsigned>(b1 + ((o >> 1) & 1)) * kH2) ^
                 (static_cast<unsigned>(b2 + (o & 1)) * kH3);
    bucket[o] = static_cast<int>(h % static_cast<unsigned>(n_buckets));
    bool dup = false;
    for (int e = 0; e < o; ++e) dup |= bucket[e] == bucket[o];
    p.rows[o] = dup ? nullptr : table + static_cast<long long>(bucket[o]) * slots * 4;
  }
  return p;
}

// Candidate (o, s): its point and whether it takes part (valid slot, first
// probe of its bucket, within 1 m of the query).
__device__ __forceinline__ bool candidate(const Probe& p, int o, int s, float qx, float qy, float qz,
                                          float* x, float* y, float* z) {
  if (p.rows[o] == nullptr) return false;
  const float* c = p.rows[o] + 4 * s;
  if (!(c[3] > 0.5f)) return false;
  *x = c[0];
  *y = c[1];
  *z = c[2];
  float dx = qx - *x, dy = qy - *y, dz = qz - *z;
  return ((dx * dx + dy * dy) + dz * dz) < 1.0f;
}

struct Fit {
  float n_use, mu[3], cov[6];  // cov: 00 01 02 11 12 22
};

__device__ Fit fit(const Probe& p, int slots, float qx, float qy, float qz) {
  Fit f;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, n = 0.0f;
  for (int o = 0; o < 8; ++o) {
    for (int s = 0; s < slots; ++s) {
      float x = 0.0f, y = 0.0f, z = 0.0f;
      bool use = candidate(p, o, s, qx, qy, qz, &x, &y, &z);
      if (!use) x = y = z = 0.0f;
      s0 = s0 + x;
      s1 = s1 + y;
      s2 = s2 + z;
      n = n + (use ? 1.0f : 0.0f);
    }
  }
  float cnt = fmaxf(n, 1.0f);
  f.n_use = n;
  f.mu[0] = s0 / cnt;
  f.mu[1] = s1 / cnt;
  f.mu[2] = s2 / cnt;
  float c[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int o = 0; o < 8; ++o) {
    for (int s = 0; s < slots; ++s) {
      float x = 0.0f, y = 0.0f, z = 0.0f;
      bool use = candidate(p, o, s, qx, qy, qz, &x, &y, &z);
      if (!use) x = y = z = 0.0f;
      float w = use ? 1.0f : 0.0f;
      float d0 = (x - f.mu[0]) * w, d1 = (y - f.mu[1]) * w, d2 = (z - f.mu[2]) * w;
      c[0] = c[0] + d0 * d0;
      c[1] = c[1] + d0 * d1;
      c[2] = c[2] + d0 * d2;
      c[3] = c[3] + d1 * d1;
      c[4] = c[4] + d1 * d2;
      c[5] = c[5] + d2 * d2;
    }
  }
  for (int j = 0; j < 6; ++j) f.cov[j] = c[j] / cnt;
  return f;
}

__global__ void lines(const float* __restrict__ y, const bool* __restrict__ mask, int q,
                      const float* __restrict__ table, int n_buckets, int slots, float cs, int k,
                      float* __restrict__ mu, float* __restrict__ v, bool* __restrict__ valid) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  float qx = y[3 * i + 0], qy = y[3 * i + 1], qz = y[3 * i + 2];
  Probe p = probe(table, n_buckets, slots, cs, qx, qy, qz);
  Fit f = fit(p, slots, qx, qy, qz);
  float ev[3];
  lvs::Vec3 evec[3];
  lvs::eigh3x3(f.cov[0], f.cov[1], f.cov[2], f.cov[3], f.cov[4], f.cov[5], ev, evec);
  for (int j = 0; j < 3; ++j) mu[3 * i + j] = f.mu[j];
  v[3 * i + 0] = evec[2].x;
  v[3 * i + 1] = evec[2].y;
  v[3 * i + 2] = evec[2].z;
  valid[i] = mask[i] && f.n_use >= static_cast<float>(k) && ev[2] > 3.0f * fmaxf(ev[1], 1e-12f);
}

__global__ void planes(const float* __restrict__ y, const bool* __restrict__ mask, int q,
                       const float* __restrict__ table, int n_buckets, int slots, float cs, int k,
                       float* __restrict__ normal, float* __restrict__ offset,
                       bool* __restrict__ valid) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  float qx = y[3 * i + 0], qy = y[3 * i + 1], qz = y[3 * i + 2];
  Probe p = probe(table, n_buckets, slots, cs, qx, qy, qz);
  Fit f = fit(p, slots, qx, qy, qz);
  float ev[3];
  lvs::Vec3 evec[3];
  // cov + 1e-9 I, every entry rounded as the plain twin's matrix sum rounds it
  lvs::eigh3x3(f.cov[0] + 1e-9f, f.cov[1] + 0.0f, f.cov[2] + 0.0f, f.cov[3] + 1e-9f,
               f.cov[4] + 0.0f, f.cov[5] + 1e-9f, ev, evec);
  lvs::Vec3 n = evec[0];
  float d = -((n.x * f.mu[0] + n.y * f.mu[1]) + n.z * f.mu[2]);
  bool flat = true;
  for (int o = 0; o < 8; ++o) {
    for (int s = 0; s < slots; ++s) {
      float x, yy, z;
      if (candidate(p, o, s, qx, qy, qz, &x, &yy, &z))
        flat &= fabsf(((x * n.x + yy * n.y) + z * n.z) + d) < 0.2f;
    }
  }
  bool finite = isfinite(n.x) && isfinite(n.y) && isfinite(n.z) && isfinite(d);
  bool ok = mask[i] && f.n_use >= static_cast<float>(k) && flat && finite;
  normal[3 * i + 0] = ok && isfinite(n.x) ? n.x : 0.0f;
  normal[3 * i + 1] = ok && isfinite(n.y) ? n.y : 0.0f;
  normal[3 * i + 2] = ok && isfinite(n.z) ? n.z : 0.0f;
  offset[i] = ok && isfinite(d) ? d : 0.0f;
  valid[i] = ok;
}

}  // namespace

extern "C" int lvs_lines_from_fit(const float* y, const bool* mask, int q, const float* table,
                                  int n_buckets, int slots, float cs, int k, float* mu, float* v,
                                  bool* valid, cudaStream_t stream) {
  if (slots > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  if (q > 0)
    lines<<<lvs::blocks_for(q), lvs::kThreads, 0, stream>>>(y, mask, q, table, n_buckets, slots, cs,
                                                            k, mu, v, valid);
  LVS_RETURN_LAST_ERROR();
}

extern "C" int lvs_planes_from_fit(const float* y, const bool* mask, int q, const float* table,
                                   int n_buckets, int slots, float cs, int k, float* normal,
                                   float* offset, bool* valid, cudaStream_t stream) {
  if (slots > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  if (q > 0)
    planes<<<lvs::blocks_for(q), lvs::kThreads, 0, stream>>>(y, mask, q, table, n_buckets, slots,
                                                             cs, k, normal, offset, valid);
  LVS_RETURN_LAST_ERROR();
}
