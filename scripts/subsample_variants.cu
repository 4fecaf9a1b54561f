// Design variants of kernel 21 (lv_slam_tpu_torch/csrc/subsample.cu, the
// uniform subsample), for scripts/window_subsample_parent.py:
// - `variant_clusters`: the shipped cluster kernel on a chosen number of
//   8-block clusters (1 is one cluster for the whole call);
// - `variant_two_launches`: the count in a first launch, each block's
//   count to its own partial row (no atomics, nothing to reset), then a
//   rows launch whose every block sums the partial rows and writes its rows.
// Build: nvcc <kernels/_build.py's flags> -shared -I lv_slam_tpu_torch/csrc.
#include "subsample.cu"

namespace {

__global__ void __launch_bounds__(lvs::kThreads) count_partials(const bool* __restrict__ mask, int n,
                                                                 int* __restrict__ part) {
  const long long lo = static_cast<long long>(n) * blockIdx.x / gridDim.x;
  const long long hi = static_cast<long long>(n) * (blockIdx.x + 1) / gridDim.x;
  const int c = block_count(count_mask(mask, lo, hi));
  if (threadIdx.x == 0) part[blockIdx.x] = c;
}

__global__ void __launch_bounds__(lvs::kThreads) rows_from_partials(
    const float* __restrict__ xyz, const float* __restrict__ inten, const bool* __restrict__ mask, int n, int out_cap,
    const int* __restrict__ part, int n_part, float* __restrict__ out_xyz, float* __restrict__ out_int,
    bool* __restrict__ out_mask) {
  __shared__ int total;
  if (threadIdx.x < 32) {
    int c = 0;
    for (int b = threadIdx.x; b < n_part; b += 32) c += part[b];
    c = lvs::warp_sum(c);
    if (threadIdx.x == 0) total = c;
  }
  __syncthreads();
  const int groups = (out_cap + kRows - 1) / kRows;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += gridDim.x * blockDim.x)
    write_rows(xyz, inten, mask, n, out_cap, total, g, out_xyz, out_int, out_mask);
}

}  // namespace

extern "C" int variant_clusters(const float* xyz, const float* inten, const bool* mask, int n, int out_cap,
                                int clusters, float* out_xyz, float* out_int, bool* out_mask, cudaStream_t stream) {
  subsample_cluster<<<kCluster * clusters, lvs::kThreads, 0, stream>>>(xyz, inten, mask, n, out_cap, out_xyz, out_int,
                                                                        out_mask);
  LVS_RETURN_LAST_ERROR();
}

// part: count_blocks ints of scratch
extern "C" int variant_two_launches(const float* xyz, const float* inten, const bool* mask, int n, int out_cap,
                                    int count_blocks, int* part, float* out_xyz, float* out_int, bool* out_mask,
                                    cudaStream_t stream) {
  count_partials<<<count_blocks, lvs::kThreads, 0, stream>>>(mask, n, part);
  const int groups = (out_cap + kRows - 1) / kRows;
  rows_from_partials<<<lvs::blocks_for(groups), lvs::kThreads, 0, stream>>>(xyz, inten, mask, n, out_cap, part,
                                                                              count_blocks, out_xyz, out_int,
                                                                              out_mask);
  LVS_RETURN_LAST_ERROR();
}
