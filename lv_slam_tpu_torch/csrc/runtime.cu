// Error text for the codes the kernels' C entry points return.
#include <cuda_runtime.h>

extern "C" const char* lvs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
