// Shared helpers for the lv_slam_tpu_torch kernels (plain CUDA C++17, no
// PyTorch headers). Every C entry point launches on the caller's stream and
// returns cudaGetLastError(), which the Python wrapper turns into an error.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lvs {

constexpr float kSentinel = 1.0e6f;  // core/cloud.py SENTINEL
constexpr int kThreads = 256;

inline int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

// float32 fma(a, b, c) as the plain twins compute it (`ops/linalg3.fma32`):
// the float64 product is exact, the sum rounds to float64, then to float32
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                                     static_cast<double>(c)));
}

// fma(a2, b2, fma(a1, b1, a0 * b0)): XLA's CPU form of a 3-term dot
__device__ __forceinline__ float dot3_fma(float a0, float a1, float a2, float b0, float b1, float b2) {
  return fma64(a2, b2, fma64(a1, b1, __fmul_rn(a0, b0)));
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The block's sums of M per-thread values, in a fixed order (shuffles within
// each warp, then the warps in order), written by threads 0..M-1 to out[0..M).
// Needs blockDim.x == kThreads.
template <int M, typename T>
__device__ __forceinline__ void block_sums(T (&v)[M], T* __restrict__ out) {
  __shared__ T smem[M][kThreads / 32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    T s = warp_sum(v[m]);
    if (lane == 0) smem[m][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < M) {
    T s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += smem[threadIdx.x][w];
    out[threadIdx.x] = s;
  }
}

// Column c of `partials` (n_blocks rows of m) summed over the rows in order.
template <typename T>
__device__ __forceinline__ T column_sum(const T* __restrict__ partials, int n_blocks, int m, int c) {
  T s = 0;
  for (int b = 0; b < n_blocks; ++b) s += partials[static_cast<long long>(b) * m + c];
  return s;
}

}  // namespace lvs

#define LVS_RETURN_LAST_ERROR() return static_cast<int>(cudaGetLastError())
