// Host stand-in for the CUDA runtime names that csrc/tcn_block.cu and
// csrc/conv_block.cu use, so that tests/test_torch_tcn_block.py and
// tests/test_torch_conv_block.py can build the kernels with g++ and run
// each launch as a loop over its blocks and threads on the CPU.  The _rn
// intrinsics are single IEEE float operations (the tests build with
// -ffp-contract=off); rsqrtf, an approximation on the card, is 1 / sqrtf
// here.

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
static HostDim3 blockIdx, threadIdx, blockDim;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host build"; }

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline float rsqrtf(float a) { return 1.f / sqrtf(a); }

// kernel<<<grid, threads, shared, stream>>>(args) is rewritten by the test
// as host_launch(grid, threads, shared, stream, [&] { kernel(args); }).
template <class F>
void host_launch(int grid, int threads, int, cudaStream_t, F run) {
  blockDim.x = threads;
  for (int b = 0; b < grid; ++b)
    for (int t = 0; t < threads; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      run();
    }
}
