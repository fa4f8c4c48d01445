// Error text for the codes the C entries return (cudaGetLastError()).
#include <cuda_runtime.h>

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
