// Host stand-in for the CUDA runtime names that csrc/ssd_scan.cu uses, so
// that tests/test_torch_granite.py can build its kernels with g++ and run
// each launch on the CPU: every block in turn, its threads as std::threads
// that meet at __syncthreads() on a std::barrier, with the block's dynamic
// shared memory in a buffer of its own (the test rewrites the kernel's
// `extern __shared__` declaration to read it) and its static __shared__
// arrays as function statics (one block runs at a time).

#pragma once

#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <barrier>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
#define __launch_bounds__(...)

using std::max;
using std::min;

struct float4 {
  float x, y, z, w;
};

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};

inline thread_local dim3 blockIdx, threadIdx;
inline dim3 blockDim, gridDim;
inline thread_local std::barrier<>* host_barrier = nullptr;
inline thread_local float4* host_shared_memory = nullptr;

inline void __syncthreads() { host_barrier->arrive_and_wait(); }
inline float4* host_shared() { return host_shared_memory; }

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host build"; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

// kernel<<<grid, threads, shared, stream>>>(args) is rewritten by the test
// as host_launch(grid, threads, shared, stream, [&] { kernel(args); }).
template <class F>
void host_launch(dim3 grid, int threads, size_t shared, cudaStream_t, F run) {
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::vector<float4> smem(shared / sizeof(float4) + 1);
        std::barrier<> bar(threads);
        std::vector<std::thread> pool;
        for (int t = 0; t < threads; ++t)
          pool.emplace_back([&, t] {
            blockIdx = dim3(x, y, z);
            threadIdx = dim3(t);
            host_barrier = &bar;
            host_shared_memory = smem.data();
            run();
          });
        for (auto& th : pool) th.join();
      }
}
