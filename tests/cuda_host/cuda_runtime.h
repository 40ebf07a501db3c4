// Host stand-in for the CUDA runtime names that csrc/tcn_block.cu uses, so
// that tests/test_torch_tcn_block.py can build the kernels with g++ and run
// each launch as a loop over its blocks and threads on the CPU.  The _rn
// intrinsics are single IEEE float operations (the test builds with
// -ffp-contract=off).

#pragma once

#include <math.h>
#include <stdint.h>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(threads)

struct HostDim3 {
  unsigned x, y, z;
};
static HostDim3 blockIdx, threadIdx;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host build"; }

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }

// kernel<<<grid, threads, shared, stream>>>(args) is rewritten by the test
// as host_launch(grid, threads, shared, stream, [&] { kernel(args); }).
template <class F>
void host_launch(int grid, int threads, int, cudaStream_t, F run) {
  for (int b = 0; b < grid; ++b)
    for (int t = 0; t < threads; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      run();
    }
}
