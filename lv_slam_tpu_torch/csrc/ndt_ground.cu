// Kernel 20: the ground-leaf filter of the ground-constrained NDT.
//
// Replaces: lv_slam_tpu/ops/ndt_ground.py:29 `filter_ground_leaves`.
//
// What bounds it on the card: bytes. It reads the dense LUT (E^3 int32:
// 1 MB at the test's E = 64, 64 MB at the flagship's 256) and writes it
// again; each LUT entry that names a leaf reads that leaf's valid flag and
// normal z (L2-resident), and the leaves' flags are rewritten.
//
// Design: one thread per LUT entry (and per leaf): a leaf is ground when it
// is valid and |n_z| >= cos(max angle) (the float32 constant the reference
// computes, passed by value); a LUT entry keeps its leaf when that leaf is
// ground, else becomes -1; each leaf's valid flag becomes its ground flag.
// Every output has one writer, and the inputs are not written: the result
// is the reference's, bit for bit.
#include "common.cuh"

namespace {

__device__ __forceinline__ bool ground(const bool* __restrict__ valid, const float* __restrict__ normals, int leaf,
                                       float cos_thresh) {
  return valid[leaf] && fabsf(normals[3 * leaf + 2]) >= cos_thresh;
}

__global__ void ground_filter(const int* __restrict__ lut, long long e3, const bool* __restrict__ valid,
                              const float* __restrict__ normals, int leaf_cap, float cos_thresh,
                              int* __restrict__ lut_out, bool* __restrict__ valid_out) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < leaf_cap) valid_out[t] = ground(valid, normals, static_cast<int>(t), cos_thresh);
  if (t < e3) {
    int leaf = lut[t];
    lut_out[t] = leaf >= 0 && ground(valid, normals, leaf, cos_thresh) ? leaf : -1;
  }
}

}  // namespace

extern "C" int lvs_ground_filter(const int* lut, long long e3, const bool* valid, const float* normals, int leaf_cap,
                                 float cos_thresh, int* lut_out, bool* valid_out, cudaStream_t stream) {
  long long n = e3 > leaf_cap ? e3 : leaf_cap;
  if (n > 0)
    ground_filter<<<lvs::blocks_for(n), lvs::kThreads, 0, stream>>>(lut, e3, valid, normals, leaf_cap, cos_thresh,
                                                                    lut_out, valid_out);
  LVS_RETURN_LAST_ERROR();
}
