// Error names for the Python wrappers: every kernel entry point returns a
// cudaError_t as int, and the wrapper raises with this string.
#include <cuda_runtime.h>

extern "C" const char* rtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
