// Error text for the codes the entry points return (cudaGetLastError()).
#include <cuda_runtime.h>

extern "C" const char* dwt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
