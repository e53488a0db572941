// Error reporting shared by the kernel wrappers: each C entry point returns
// a cudaError_t, and the Python side turns a nonzero one into a message.

#include <cuda_runtime.h>

extern "C" const char* m2s_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
