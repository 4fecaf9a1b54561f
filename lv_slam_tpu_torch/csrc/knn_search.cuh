// The sorted grid's k-nearest search (kernel 9k's), shared by the k-NN
// entries of knn_grid.cu and the 5-NN line / plane fits of lfa_fit.cu
// (kernel 10g).
//
// A query takes its 27 neighbour cells in the reference's `_OFF27` order (i
// outermost); a binary search (`searchsorted`, side left, also for
// out-of-extent cells, whose key is INT32_MAX) gives each cell's start row,
// and the `slots` candidates are the rows start .. start + slots - 1, each
// clamped to the last row as the reference clamps them; a candidate hits
// when its row holds that cell. Its squared distance is the fma chain XLA
// makes of `jnp.sum(d ** 2, -1)` on the CPU, misses are +inf, and an
// insertion list keeps the k best by (d2, candidate index): candidates come
// in index order and a new one goes behind every equal distance, which is
// `lax.top_k`'s tie order, misses included.
#pragma once

#include "common.cuh"

#include <math.h>

namespace lvs {

constexpr int kExtent = 1024;
constexpr int kKeyMax = 2147483647;  // INT32_MAX
constexpr int kMaxK = 8;             // neighbours a grid query may keep

// first index of `keys` (ascending, length m) holding a value >= q
__device__ __forceinline__ int lower_bound(const int* __restrict__ keys, int m, int q) {
  int lo = 0, hi = m;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(keys + mid) < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The k best candidates of query (qx, qy, qz): squared distances ascending
// in d2[0..k) (+inf for misses) and their grid rows in row[0..k).
__device__ __forceinline__ void k_nearest(const int* __restrict__ keys, const float* __restrict__ xyz, int n,
                                          const int* __restrict__ origin, float cell, float qx, float qy,
                                          float qz, int k, int slots, float* d2, int* row) {
  int c[3] = {static_cast<int>(floorf(qx / cell)), static_cast<int>(floorf(qy / cell)),
              static_cast<int>(floorf(qz / cell))};
  int o[3] = {__ldg(origin + 0), __ldg(origin + 1), __ldg(origin + 2)};
  int filled = 0;
  for (int cell27 = 0; cell27 < 27; ++cell27) {
    int off[3] = {cell27 / 9 - 1, (cell27 / 3) % 3 - 1, cell27 % 3 - 1};
    bool in_extent = true;
    int r[3];
    for (int a = 0; a < 3; ++a) {
      long long rel = static_cast<long long>(c[a]) - o[a] + off[a];
      in_extent = in_extent && rel >= 0 && rel < kExtent;
      r[a] = static_cast<int>(rel);
    }
    int key = in_extent ? (r[0] * kExtent + r[1]) * kExtent + r[2] : kKeyMax;
    int start = lower_bound(keys, n, key);
    for (int s = 0; s < slots; ++s) {
      int idx = min(start + s, n - 1);
      float d = INFINITY;
      if (in_extent && __ldg(keys + idx) == key) {
        float dx = qx - __ldg(xyz + 3 * idx + 0);
        float dy = qy - __ldg(xyz + 3 * idx + 1);
        float dz = qz - __ldg(xyz + 3 * idx + 2);
        d = dot3_fma(dx, dy, dz, dx, dy, dz);
      }
      // behind every equal distance: the lower candidate index wins ties
      if (filled == k && !(d < d2[k - 1])) continue;
      int j = filled < k ? filled++ : k - 1;
      while (j > 0 && d < d2[j - 1]) {
        d2[j] = d2[j - 1];
        row[j] = row[j - 1];
        --j;
      }
      d2[j] = d;
      row[j] = idx;
    }
  }
}

}  // namespace lvs
