// Median selection networks shared by the HPSS kernels (frontend.cu: K1 and
// K2; hpss.cu: K3).
//
// Median<L>::run(v) leaves v[0..L) partly sorted and returns the median of
// its L values.  Each network is the Batcher odd-even mergesort network for
// L wires pruned backward from the median wire, the comparator lists of
// ops/hpss_pallas.py::median_network in the JAX package (91 comparators for
// 21 wires, 32 for 11, 8 for 5); a CPU test reads this file and pins each
// list to that function.  With constant indices the whole array stays in
// registers.

#pragma once

#include <cuda_runtime.h>
#include <float.h>

namespace hpss_median {

#define CS(i, j)                          \
  {                                       \
    const float a_ = v[i], b_ = v[j];     \
    v[i] = fminf(a_, b_);                 \
    v[j] = fmaxf(a_, b_);                 \
  }

template <int L>
struct Median;

template <>
struct Median<5> {
  __device__ __forceinline__ static float run(float* v) {
    CS(0,1); CS(2,3); CS(0,2); CS(1,3); CS(1,2); CS(0,4); CS(2,4); CS(1,2);
    return v[2];
  }
};

template <>
struct Median<11> {
  __device__ __forceinline__ static float run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(8,9); CS(0,2); CS(1,3); CS(4,6);
    CS(5,7); CS(8,10); CS(1,2); CS(5,6); CS(9,10); CS(0,4); CS(1,5); CS(2,6);
    CS(3,7); CS(2,4); CS(3,5); CS(1,2); CS(3,4); CS(5,6); CS(9,10); CS(0,8);
    CS(1,9); CS(2,10); CS(4,8); CS(5,9); CS(6,10); CS(3,5); CS(6,8); CS(5,6);
    return v[5];
  }
};

template <>
struct Median<21> {
  __device__ __forceinline__ static float run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(8,9); CS(10,11); CS(12,13);
    CS(14,15); CS(16,17); CS(18,19); CS(0,2); CS(1,3); CS(4,6); CS(5,7);
    CS(8,10); CS(9,11); CS(12,14); CS(13,15); CS(16,18); CS(17,19); CS(1,2);
    CS(5,6); CS(9,10); CS(13,14); CS(17,18); CS(0,4); CS(1,5); CS(2,6);
    CS(3,7); CS(8,12); CS(9,13); CS(10,14); CS(11,15); CS(16,20); CS(2,4);
    CS(3,5); CS(10,12); CS(11,13); CS(18,20); CS(1,2); CS(3,4); CS(5,6);
    CS(9,10); CS(11,12); CS(13,14); CS(17,18); CS(19,20); CS(0,8); CS(1,9);
    CS(2,10); CS(3,11); CS(4,12); CS(5,13); CS(6,14); CS(7,15); CS(4,8);
    CS(5,9); CS(6,10); CS(7,11); CS(2,4); CS(3,5); CS(6,8); CS(7,9);
    CS(10,12); CS(11,13); CS(18,20); CS(1,2); CS(3,4); CS(5,6); CS(7,8);
    CS(9,10); CS(11,12); CS(17,18); CS(19,20); CS(0,16); CS(1,17); CS(2,18);
    CS(3,19); CS(4,20); CS(8,16); CS(9,17); CS(10,18); CS(11,19); CS(12,20);
    CS(5,9); CS(6,10); CS(7,11); CS(12,16); CS(7,9); CS(10,12); CS(9,10);
    return v[10];
  }
};

#undef CS

// numpy mode='symmetric' index rule, repeated with period 2n, so that a
// pad wider than the axis works as jnp.pad(mode='symmetric') does.
__device__ __forceinline__ int sym(int i, int n) {
  const int p = 2 * n;
  int r = i % p;
  if (r < 0) r += p;
  return r < n ? r : p - 1 - r;
}

// librosa's softmask with power 2 and split_zeros=False, for both masks at
// once: normalised by z = max(harm, perc); where z is below float32's
// smallest normal both masks are 0.
__device__ __forceinline__ void soft_masks(float harm, float perc,
                                           float* mask_h, float* mask_p) {
  const float z = fmaxf(harm, perc);
  const bool bad = z < FLT_MIN;
  const float zn = bad ? 1.f : z;
  const float rh = harm / zn, rp = perc / zn;
  const float hn = rh * rh;
  const float pn = rp * rp;
  const float den = bad ? 1.f : hn + pn;
  *mask_h = bad ? 0.f : hn / den;
  *mask_p = bad ? 0.f : pn / den;
}

}  // namespace hpss_median
