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

}  // namespace lvs

#define LVS_RETURN_LAST_ERROR() return static_cast<int>(cudaGetLastError())
