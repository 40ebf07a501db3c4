// Median selection networks shared by the HPSS kernels (frontend.cu: K1 and
// K2 take Median<L>; hpss.cu: K3 and K4 take the shared-core networks
// below).
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

// Shared-core selection (hpss.cu: K3 and K4).  K consecutive outputs of a
// width-W running median read W + K - 1 inputs x[0 .. W+K-2], window j
// being x[j .. j+W-1]; all K windows hold the core x[K-1 .. W-1].  With
// M = (W - 1) / 2, a core value of rank below M - K + 1 or above M is no
// window's median, so each window's median is the median of the core's K
// middle ranks and the window's own K - 1 extra inputs (forgetful
// selection; exact, ties included).
//   MedianCore<W, K>::run(v): v[0 .. W-K] is the core; sorts its ranks
//     M-K+1 .. M onto wires M-K+1 .. M (Batcher's network on W - K + 1
//     wires pruned backward from those wires).
//   MedianMerge<K>::run(v): v[0 .. K-1] sorted, v[K .. 2K-2] the extras;
//     returns the median of the 2K - 1 values (the extras sorted, then
//     min(v[K-1], min_i max(A[i-1], B[K-1-i])) over the two sorted lists).
// tools/median_networks.py generates both lists; per output, (21, 4) takes
// 77/4 + 9 = 28.25 comparators against Median<21>'s 91, (11, 2) 29/2 + 2 =
// 16.5 against 32, (11, 4) 13.75, (5, 2) 4.5.  A CPU test reads this file
// and checks every list over all 0/1 inputs.
template <int W, int K>
struct MedianCore;

template <int K>
struct MedianMerge;

template <>
struct MedianCore<21, 4> {
  __device__ __forceinline__ static void run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(8,9); CS(10,11); CS(12,13);
    CS(14,15); CS(16,17); CS(0,2); CS(1,3); CS(4,6); CS(5,7); CS(8,10);
    CS(9,11); CS(12,14); CS(13,15); CS(1,2); CS(5,6); CS(9,10); CS(13,14);
    CS(0,4); CS(1,5); CS(2,6); CS(3,7); CS(8,12); CS(9,13); CS(10,14);
    CS(11,15); CS(2,4); CS(3,5); CS(10,12); CS(11,13); CS(1,2); CS(3,4);
    CS(5,6); CS(9,10); CS(11,12); CS(13,14); CS(0,8); CS(1,9); CS(2,10);
    CS(3,11); CS(4,12); CS(5,13); CS(6,14); CS(7,15); CS(4,8); CS(5,9);
    CS(6,10); CS(7,11); CS(2,4); CS(3,5); CS(6,8); CS(7,9); CS(10,12);
    CS(11,13); CS(1,2); CS(3,4); CS(5,6); CS(7,8); CS(9,10); CS(11,12);
    CS(0,16); CS(1,17); CS(8,16); CS(9,17); CS(4,8); CS(5,9); CS(6,10);
    CS(7,11); CS(12,16); CS(6,8); CS(7,9); CS(10,12); CS(7,8); CS(9,10);
  }
};

template <>
struct MedianCore<11, 4> {
  __device__ __forceinline__ static void run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(0,2); CS(1,3); CS(4,6); CS(5,7);
    CS(1,2); CS(5,6); CS(0,4); CS(1,5); CS(2,6); CS(3,7); CS(2,4); CS(3,5);
    CS(1,2); CS(3,4); CS(5,6);
  }
};

template <>
struct MedianCore<11, 2> {
  __device__ __forceinline__ static void run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(8,9); CS(0,2); CS(1,3); CS(4,6);
    CS(5,7); CS(1,2); CS(5,6); CS(0,4); CS(1,5); CS(2,6); CS(3,7); CS(2,4);
    CS(3,5); CS(1,2); CS(3,4); CS(5,6); CS(0,8); CS(1,9); CS(4,8); CS(5,9);
    CS(2,4); CS(3,5); CS(6,8); CS(3,4); CS(5,6);
  }
};

template <>
struct MedianCore<5, 2> {
  __device__ __forceinline__ static void run(float* v) {
    CS(0,1); CS(2,3); CS(0,2); CS(1,3); CS(1,2);
  }
};

template <>
struct MedianMerge<2> {
  __device__ __forceinline__ static float run(float* v) {
    CS(0,2); CS(1,2);
    return v[1];
  }
};

template <>
struct MedianMerge<4> {
  __device__ __forceinline__ static float run(float* v) {
    CS(4,5); CS(4,6); CS(5,6); CS(0,6); CS(1,5); CS(2,4); CS(3,4); CS(3,5);
    CS(3,6);
    return v[3];
  }
};

#undef CS

// out[j] = median of x[j .. j+W-1] for j < K, from x[0 .. W+K-2]: the core
// network once, then one merge per output.  With constant indices all of
// it stays in registers.
template <int W, int K>
__device__ __forceinline__ void running_medians(const float* x, float* out) {
  constexpr int LO = (W - 1) / 2 - K + 1;
  float core[W - K + 1];
#pragma unroll
  for (int i = 0; i < W - K + 1; ++i) core[i] = x[K - 1 + i];
  MedianCore<W, K>::run(core);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float u[2 * K - 1];
#pragma unroll
    for (int i = 0; i < K; ++i) u[i] = core[LO + i];
#pragma unroll
    for (int i = j; i < K - 1; ++i) u[K + i - j] = x[i];
#pragma unroll
    for (int i = 0; i < j; ++i) u[2 * K - 1 - j + i] = x[W + i];
    out[j] = MedianMerge<K>::run(u);
  }
}

// numpy mode='symmetric' index rule, repeated with period 2n, so that a
// pad wider than the axis works as jnp.pad(mode='symmetric') does.
__device__ __forceinline__ int sym(int i, int n) {
  const int p = 2 * n;
  int r = i % p;
  if (r < 0) r += p;
  return r < n ? r : p - 1 - r;
}

// sym() for -n <= i < 2n (within one period): branches only, no division.
__device__ __forceinline__ int sym1(int i, int n) {
  return i < 0 ? -1 - i : (i < n ? i : 2 * n - 1 - i);
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

// soft_masks with two correctly rounded reciprocals in place of the four
// divisions: r = 1/z scales both medians and 1/(hn + pn), with hn + pn in
// [1, 2], scales both squares.  Each quotient becomes two roundings, a few
// ulp in all (K3's and K4's bar is rtol 1e-5).
__device__ __forceinline__ void soft_masks_rcp(float harm, float perc,
                                               float* mask_h, float* mask_p) {
  const float z = fmaxf(harm, perc);
  const bool bad = z < FLT_MIN;
  const float r = __frcp_rn(bad ? 1.f : z);
  const float rh = harm * r, rp = perc * r;
  const float hn = rh * rh;
  const float pn = rp * rp;
  const float rd = __frcp_rn(bad ? 1.f : hn + pn);
  *mask_h = bad ? 0.f : hn * rd;
  *mask_p = bad ? 0.f : pn * rd;
}

}  // namespace hpss_median
