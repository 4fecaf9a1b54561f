// Shared helpers for the lv_slam_tpu_torch kernels (plain CUDA C++17, no
// PyTorch headers). Every C entry point launches on the caller's stream and
// returns cudaGetLastError(), which the Python wrapper turns into an error.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
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

// v as the reference's compiled programs see it: a subnormal (|v| <
// FLT_MIN) flushed to +0, as XLA's CPU code and the TPU flush it. NaN and
// the infinities pass.
__device__ __forceinline__ float ftz(float v) { return fabsf(v) < FLT_MIN ? 0.0f : v; }

// The cell rule (`ops/cells.py`): floor(ftz(ftz(x) * inv)) where the
// reference multiplies by a folded reciprocal, floor(ftz(ftz(x) / d)) where
// it divides truly. Flushing the product too puts a normal x whose product
// is subnormal (inv < 1: -2e-38 at 4 m) in cell 0, as the reference does.
// On inputs without subnormals both are the plain floor's bits. No global
// flush-to-zero flag: it would move other bits.
__device__ __forceinline__ float floor_cell(float x, float inv) { return floorf(ftz(__fmul_rn(ftz(x), inv))); }
__device__ __forceinline__ int cell_floor(float x, float inv) { return static_cast<int>(floor_cell(x, inv)); }
__device__ __forceinline__ int cell_floor_div(float x, float d) {
  return static_cast<int>(floorf(ftz(__fdiv_rn(ftz(x), d))));
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

}  // namespace lvs

#define LVS_RETURN_LAST_ERROR() return static_cast<int>(cudaGetLastError())
