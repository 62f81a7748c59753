// Error strings for the launch statuses the kernels' C entry points return.
#include <cuda_runtime.h>

extern "C" const char* ktpu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
