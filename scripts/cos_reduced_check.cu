// Exhaustive check of `lvs::cos_reduced` (lv_slam_tpu_torch/csrc/linalg3.cuh,
// the cosine of kernel 4's eigh3x3) against CUDA's `cosf` under the port's
// nvcc flags: every float x of either sign with |x| <= 105615 (2.4e9 of
// them), compared bit for bit. Used by scripts/prefilter_gicp_parent.py and
// tests/test_torch_kernels.py::test_cos_reduced_is_cosf_on_the_card.
// Build: nvcc <kernels/_build.py's flags> -shared -I lv_slam_tpu_torch/csrc.
#include "common.cuh"
#include "linalg3.cuh"

namespace {

__global__ void cos_check(unsigned hi, unsigned long long* __restrict__ bad, unsigned* __restrict__ first) {
  for (unsigned long long b = blockIdx.x * static_cast<unsigned long long>(blockDim.x) + threadIdx.x; b <= hi;
       b += static_cast<unsigned long long>(gridDim.x) * blockDim.x) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const unsigned bits = static_cast<unsigned>(b) | (s ? 0x80000000u : 0u);
      const float x = __uint_as_float(bits);
      if (__float_as_uint(cosf(x)) != __float_as_uint(lvs::cos_reduced(x))) {
        const unsigned long long k = atomicAdd(bad, 1ull);
        if (k < 16) first[k] = bits;
      }
    }
  }
}

}  // namespace

// Counts into *bad (zeroed here) the floats x with |x| <= the float whose
// bits are `hi` where cos_reduced(x) and cosf(x) differ in any bit; the
// first 16 such x's bits go to first[0..16).
extern "C" int cos_reduced_mismatches(unsigned hi, unsigned long long* bad, unsigned* first, cudaStream_t stream) {
  cudaMemsetAsync(bad, 0, sizeof(unsigned long long), stream);
  cos_check<<<132 * 16, lvs::kThreads, 0, stream>>>(hi, bad, first);
  LVS_RETURN_LAST_ERROR();
}
