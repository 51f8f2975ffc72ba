// Error text for the CUDA error codes the kernel entry points return.

#include <cuda_runtime.h>

extern "C" const char* hk_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
