// Median selection networks shared by the HPSS kernels (frontend.cu: K1 and
// K2 take Median<L>; hpss.cu: K3 and K4 take the shared-core networks
// below), and the soft masks.
//
// Median<L>::run(v) leaves v[0..L) partly sorted and returns the median of
// its L values.  Each network is the Batcher odd-even mergesort network for
// L wires pruned backward from the median wire, the comparator lists of
// ops/hpss_pallas.py::median_network in the JAX package (8 comparators for
// 5 wires, 32 for 11, 91 for 21, 152 for 31, 257 for 41, 335 for 51);
// tools/median_networks.py writes them and a CPU test pins each list to
// that function.  This file holds the networks of the ten pairs of
// ops/hpss.py::KERNEL_MEDIANS.  Any other odd pair of widths 3 to 61 gets
// the specialisations it lacks from ops/median_networks.py::pair_networks
// (the same generator), which ops/_nvcc.py writes beside the library and
// names in -DHPSS_PAIR_NETWORKS; they are included below.  With constant
// indices the whole array stays in registers (or, for the widest, spills
// to local memory: see chip_smoke.py's ptxas report).

#pragma once

#include <cuda_runtime.h>
#include <float.h>

// The (l_harm, l_perc) pair a library instantiates, as X(l_harm, l_perc):
// the one named by -DHPSS_LH=... -DHPSS_LP=... (ops/_nvcc.py::pair_defines;
// ops/_nvcc.py builds one library per pair of ops/hpss.py::KERNEL_MEDIANS).
#if !defined(HPSS_LH) || !defined(HPSS_LP)
#error "build with -DHPSS_LH=<l_harm> -DHPSS_LP=<l_perc> (ops/_nvcc.py)"
#endif
#define HPSS_FOR_EACH_PAIR(X) X(HPSS_LH, HPSS_LP)

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

template <>
struct Median<31> {
  __device__ __forceinline__ static float run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(8,9); CS(10,11); CS(12,13);
    CS(14,15); CS(16,17); CS(18,19); CS(20,21); CS(22,23); CS(24,25);
    CS(26,27); CS(28,29); CS(0,2); CS(1,3); CS(4,6); CS(5,7); CS(8,10);
    CS(9,11); CS(12,14); CS(13,15); CS(16,18); CS(17,19); CS(20,22);
    CS(21,23); CS(24,26); CS(25,27); CS(28,30); CS(1,2); CS(5,6); CS(9,10);
    CS(13,14); CS(17,18); CS(21,22); CS(25,26); CS(29,30); CS(0,4); CS(1,5);
    CS(2,6); CS(3,7); CS(8,12); CS(9,13); CS(10,14); CS(11,15); CS(16,20);
    CS(17,21); CS(18,22); CS(19,23); CS(24,28); CS(25,29); CS(26,30);
    CS(2,4); CS(3,5); CS(10,12); CS(11,13); CS(18,20); CS(19,21); CS(26,28);
    CS(27,29); CS(1,2); CS(3,4); CS(5,6); CS(9,10); CS(11,12); CS(13,14);
    CS(17,18); CS(19,20); CS(21,22); CS(25,26); CS(27,28); CS(29,30);
    CS(0,8); CS(1,9); CS(2,10); CS(3,11); CS(4,12); CS(5,13); CS(6,14);
    CS(7,15); CS(16,24); CS(17,25); CS(18,26); CS(19,27); CS(20,28);
    CS(21,29); CS(22,30); CS(4,8); CS(5,9); CS(6,10); CS(7,11); CS(20,24);
    CS(21,25); CS(22,26); CS(23,27); CS(2,4); CS(3,5); CS(6,8); CS(7,9);
    CS(10,12); CS(11,13); CS(18,20); CS(19,21); CS(22,24); CS(23,25);
    CS(26,28); CS(27,29); CS(1,2); CS(3,4); CS(5,6); CS(7,8); CS(9,10);
    CS(11,12); CS(13,14); CS(17,18); CS(19,20); CS(21,22); CS(23,24);
    CS(25,26); CS(27,28); CS(29,30); CS(0,16); CS(1,17); CS(2,18); CS(3,19);
    CS(4,20); CS(5,21); CS(6,22); CS(7,23); CS(8,24); CS(9,25); CS(10,26);
    CS(11,27); CS(12,28); CS(13,29); CS(14,30); CS(8,16); CS(9,17);
    CS(10,18); CS(11,19); CS(12,20); CS(13,21); CS(14,22); CS(15,23);
    CS(12,16); CS(13,17); CS(14,18); CS(15,19); CS(14,16); CS(15,17);
    CS(15,16);
    return v[15];
  }
};

template <>
struct Median<41> {
  __device__ __forceinline__ static float run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(8,9); CS(10,11); CS(12,13);
    CS(14,15); CS(16,17); CS(18,19); CS(20,21); CS(22,23); CS(24,25);
    CS(26,27); CS(28,29); CS(30,31); CS(32,33); CS(34,35); CS(36,37);
    CS(38,39); CS(0,2); CS(1,3); CS(4,6); CS(5,7); CS(8,10); CS(9,11);
    CS(12,14); CS(13,15); CS(16,18); CS(17,19); CS(20,22); CS(21,23);
    CS(24,26); CS(25,27); CS(28,30); CS(29,31); CS(32,34); CS(33,35);
    CS(36,38); CS(37,39); CS(1,2); CS(5,6); CS(9,10); CS(13,14); CS(17,18);
    CS(21,22); CS(25,26); CS(29,30); CS(33,34); CS(37,38); CS(0,4); CS(1,5);
    CS(2,6); CS(3,7); CS(8,12); CS(9,13); CS(10,14); CS(11,15); CS(16,20);
    CS(17,21); CS(18,22); CS(19,23); CS(24,28); CS(25,29); CS(26,30);
    CS(27,31); CS(32,36); CS(33,37); CS(34,38); CS(35,39); CS(2,4); CS(3,5);
    CS(10,12); CS(11,13); CS(18,20); CS(19,21); CS(26,28); CS(27,29);
    CS(34,36); CS(35,37); CS(1,2); CS(3,4); CS(5,6); CS(9,10); CS(11,12);
    CS(13,14); CS(17,18); CS(19,20); CS(21,22); CS(25,26); CS(27,28);
    CS(29,30); CS(33,34); CS(35,36); CS(37,38); CS(0,8); CS(1,9); CS(2,10);
    CS(3,11); CS(4,12); CS(5,13); CS(6,14); CS(7,15); CS(16,24); CS(17,25);
    CS(18,26); CS(19,27); CS(20,28); CS(21,29); CS(22,30); CS(23,31);
    CS(32,40); CS(4,8); CS(5,9); CS(6,10); CS(7,11); CS(20,24); CS(21,25);
    CS(22,26); CS(23,27); CS(36,40); CS(2,4); CS(3,5); CS(6,8); CS(7,9);
    CS(10,12); CS(11,13); CS(18,20); CS(19,21); CS(22,24); CS(23,25);
    CS(26,28); CS(27,29); CS(34,36); CS(35,37); CS(38,40); CS(1,2); CS(3,4);
    CS(5,6); CS(7,8); CS(9,10); CS(11,12); CS(13,14); CS(17,18); CS(19,20);
    CS(21,22); CS(23,24); CS(25,26); CS(27,28); CS(29,30); CS(33,34);
    CS(35,36); CS(37,38); CS(39,40); CS(0,16); CS(1,17); CS(2,18); CS(3,19);
    CS(4,20); CS(5,21); CS(6,22); CS(7,23); CS(8,24); CS(9,25); CS(10,26);
    CS(11,27); CS(12,28); CS(13,29); CS(14,30); CS(15,31); CS(8,16);
    CS(9,17); CS(10,18); CS(11,19); CS(12,20); CS(13,21); CS(14,22);
    CS(15,23); CS(4,8); CS(5,9); CS(6,10); CS(7,11); CS(12,16); CS(13,17);
    CS(14,18); CS(15,19); CS(20,24); CS(21,25); CS(22,26); CS(23,27);
    CS(36,40); CS(2,4); CS(3,5); CS(6,8); CS(7,9); CS(10,12); CS(11,13);
    CS(14,16); CS(15,17); CS(18,20); CS(19,21); CS(22,24); CS(23,25);
    CS(26,28); CS(34,36); CS(35,37); CS(38,40); CS(1,2); CS(3,4); CS(5,6);
    CS(7,8); CS(9,10); CS(11,12); CS(13,14); CS(15,16); CS(17,18); CS(19,20);
    CS(21,22); CS(23,24); CS(25,26); CS(33,34); CS(35,36); CS(37,38);
    CS(39,40); CS(0,32); CS(1,33); CS(2,34); CS(3,35); CS(4,36); CS(5,37);
    CS(6,38); CS(7,39); CS(8,40); CS(16,32); CS(17,33); CS(18,34); CS(19,35);
    CS(20,36); CS(21,37); CS(22,38); CS(23,39); CS(24,40); CS(10,18);
    CS(11,19); CS(12,20); CS(13,21); CS(14,22); CS(15,23); CS(24,32);
    CS(25,33); CS(14,18); CS(15,19); CS(20,24); CS(21,25); CS(18,20);
    CS(19,21); CS(19,20);
    return v[20];
  }
};

template <>
struct Median<51> {
  __device__ __forceinline__ static float run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(8,9); CS(10,11); CS(12,13);
    CS(14,15); CS(16,17); CS(18,19); CS(20,21); CS(22,23); CS(24,25);
    CS(26,27); CS(28,29); CS(30,31); CS(32,33); CS(34,35); CS(36,37);
    CS(38,39); CS(40,41); CS(42,43); CS(44,45); CS(46,47); CS(48,49);
    CS(0,2); CS(1,3); CS(4,6); CS(5,7); CS(8,10); CS(9,11); CS(12,14);
    CS(13,15); CS(16,18); CS(17,19); CS(20,22); CS(21,23); CS(24,26);
    CS(25,27); CS(28,30); CS(29,31); CS(32,34); CS(33,35); CS(36,38);
    CS(37,39); CS(40,42); CS(41,43); CS(44,46); CS(45,47); CS(48,50);
    CS(1,2); CS(5,6); CS(9,10); CS(13,14); CS(17,18); CS(21,22); CS(25,26);
    CS(29,30); CS(33,34); CS(37,38); CS(41,42); CS(45,46); CS(49,50);
    CS(0,4); CS(1,5); CS(2,6); CS(3,7); CS(8,12); CS(9,13); CS(10,14);
    CS(11,15); CS(16,20); CS(17,21); CS(18,22); CS(19,23); CS(24,28);
    CS(25,29); CS(26,30); CS(27,31); CS(32,36); CS(33,37); CS(34,38);
    CS(35,39); CS(40,44); CS(41,45); CS(42,46); CS(43,47); CS(2,4); CS(3,5);
    CS(10,12); CS(11,13); CS(18,20); CS(19,21); CS(26,28); CS(27,29);
    CS(34,36); CS(35,37); CS(42,44); CS(43,45); CS(1,2); CS(3,4); CS(5,6);
    CS(9,10); CS(11,12); CS(13,14); CS(17,18); CS(19,20); CS(21,22);
    CS(25,26); CS(27,28); CS(29,30); CS(33,34); CS(35,36); CS(37,38);
    CS(41,42); CS(43,44); CS(45,46); CS(49,50); CS(0,8); CS(1,9); CS(2,10);
    CS(3,11); CS(4,12); CS(5,13); CS(6,14); CS(7,15); CS(16,24); CS(17,25);
    CS(18,26); CS(19,27); CS(20,28); CS(21,29); CS(22,30); CS(23,31);
    CS(32,40); CS(33,41); CS(34,42); CS(35,43); CS(36,44); CS(37,45);
    CS(38,46); CS(39,47); CS(4,8); CS(5,9); CS(6,10); CS(7,11); CS(20,24);
    CS(21,25); CS(22,26); CS(23,27); CS(36,40); CS(37,41); CS(38,42);
    CS(39,43); CS(2,4); CS(3,5); CS(6,8); CS(7,9); CS(10,12); CS(11,13);
    CS(18,20); CS(19,21); CS(22,24); CS(23,25); CS(26,28); CS(27,29);
    CS(34,36); CS(35,37); CS(38,40); CS(39,41); CS(42,44); CS(43,45);
    CS(1,2); CS(3,4); CS(5,6); CS(7,8); CS(9,10); CS(11,12); CS(13,14);
    CS(17,18); CS(19,20); CS(21,22); CS(23,24); CS(25,26); CS(27,28);
    CS(29,30); CS(33,34); CS(35,36); CS(37,38); CS(39,40); CS(41,42);
    CS(43,44); CS(45,46); CS(49,50); CS(0,16); CS(1,17); CS(2,18); CS(3,19);
    CS(4,20); CS(5,21); CS(6,22); CS(7,23); CS(8,24); CS(9,25); CS(10,26);
    CS(11,27); CS(12,28); CS(13,29); CS(14,30); CS(15,31); CS(32,48);
    CS(33,49); CS(34,50); CS(8,16); CS(9,17); CS(10,18); CS(11,19);
    CS(12,20); CS(13,21); CS(14,22); CS(15,23); CS(40,48); CS(41,49);
    CS(42,50); CS(4,8); CS(5,9); CS(6,10); CS(7,11); CS(12,16); CS(13,17);
    CS(14,18); CS(15,19); CS(20,24); CS(21,25); CS(22,26); CS(23,27);
    CS(36,40); CS(37,41); CS(38,42); CS(39,43); CS(44,48); CS(45,49);
    CS(46,50); CS(2,4); CS(3,5); CS(6,8); CS(7,9); CS(10,12); CS(11,13);
    CS(14,16); CS(15,17); CS(18,20); CS(19,21); CS(22,24); CS(23,25);
    CS(26,28); CS(27,29); CS(34,36); CS(35,37); CS(38,40); CS(39,41);
    CS(42,44); CS(43,45); CS(46,48); CS(47,49); CS(1,2); CS(3,4); CS(5,6);
    CS(7,8); CS(9,10); CS(11,12); CS(13,14); CS(15,16); CS(17,18); CS(19,20);
    CS(21,22); CS(23,24); CS(25,26); CS(27,28); CS(33,34); CS(35,36);
    CS(37,38); CS(39,40); CS(41,42); CS(43,44); CS(45,46); CS(47,48);
    CS(49,50); CS(0,32); CS(1,33); CS(2,34); CS(3,35); CS(4,36); CS(5,37);
    CS(6,38); CS(7,39); CS(8,40); CS(9,41); CS(10,42); CS(11,43); CS(12,44);
    CS(13,45); CS(14,46); CS(15,47); CS(16,48); CS(17,49); CS(18,50);
    CS(16,32); CS(17,33); CS(18,34); CS(19,35); CS(20,36); CS(21,37);
    CS(22,38); CS(23,39); CS(24,40); CS(25,41); CS(26,42); CS(27,43);
    CS(28,44); CS(13,21); CS(14,22); CS(15,23); CS(24,32); CS(25,33);
    CS(26,34); CS(27,35); CS(28,36); CS(21,25); CS(22,26); CS(23,27);
    CS(28,32); CS(23,25); CS(26,28); CS(25,26);
    return v[25];
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
// 16.5 against 32, (11, 4) 13.75, (5, 2) 4.5; for the tuner's widths
// (31, 4) 43.5, (41, 4) 68.5, (51, 4) 89.5 and (21, 2) 44, (31, 2) 76,
// (41, 2) 126, (51, 2) 167.  CPU tests read this file and check every list
// over all 0/1 inputs where that fits in seconds, the rest as the backward
// pruning of Batcher's network and on random inputs with ties.
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
struct MedianCore<31, 4> {
  __device__ __forceinline__ static void run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(8,9); CS(10,11); CS(12,13);
    CS(14,15); CS(16,17); CS(18,19); CS(20,21); CS(22,23); CS(24,25);
    CS(26,27); CS(0,2); CS(1,3); CS(4,6); CS(5,7); CS(8,10); CS(9,11);
    CS(12,14); CS(13,15); CS(16,18); CS(17,19); CS(20,22); CS(21,23);
    CS(24,26); CS(25,27); CS(1,2); CS(5,6); CS(9,10); CS(13,14); CS(17,18);
    CS(21,22); CS(25,26); CS(0,4); CS(1,5); CS(2,6); CS(3,7); CS(8,12);
    CS(9,13); CS(10,14); CS(11,15); CS(16,20); CS(17,21); CS(18,22);
    CS(19,23); CS(2,4); CS(3,5); CS(10,12); CS(11,13); CS(18,20); CS(19,21);
    CS(1,2); CS(3,4); CS(5,6); CS(9,10); CS(11,12); CS(13,14); CS(17,18);
    CS(19,20); CS(21,22); CS(25,26); CS(0,8); CS(1,9); CS(2,10); CS(3,11);
    CS(4,12); CS(5,13); CS(6,14); CS(7,15); CS(16,24); CS(17,25); CS(18,26);
    CS(19,27); CS(4,8); CS(5,9); CS(6,10); CS(7,11); CS(20,24); CS(21,25);
    CS(22,26); CS(23,27); CS(2,4); CS(3,5); CS(6,8); CS(7,9); CS(10,12);
    CS(11,13); CS(18,20); CS(19,21); CS(22,24); CS(23,25); CS(1,2); CS(3,4);
    CS(5,6); CS(7,8); CS(9,10); CS(11,12); CS(13,14); CS(17,18); CS(19,20);
    CS(21,22); CS(23,24); CS(25,26); CS(0,16); CS(1,17); CS(2,18); CS(3,19);
    CS(4,20); CS(5,21); CS(6,22); CS(7,23); CS(8,24); CS(9,25); CS(10,26);
    CS(11,27); CS(8,16); CS(9,17); CS(10,18); CS(11,19); CS(12,20);
    CS(13,21); CS(14,22); CS(15,23); CS(6,10); CS(7,11); CS(12,16);
    CS(13,17); CS(14,18); CS(15,19); CS(10,12); CS(11,13); CS(14,16);
    CS(15,17); CS(11,12); CS(13,14); CS(15,16);
  }
};

template <>
struct MedianCore<41, 4> {
  __device__ __forceinline__ static void run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(8,9); CS(10,11); CS(12,13);
    CS(14,15); CS(16,17); CS(18,19); CS(20,21); CS(22,23); CS(24,25);
    CS(26,27); CS(28,29); CS(30,31); CS(32,33); CS(34,35); CS(36,37);
    CS(0,2); CS(1,3); CS(4,6); CS(5,7); CS(8,10); CS(9,11); CS(12,14);
    CS(13,15); CS(16,18); CS(17,19); CS(20,22); CS(21,23); CS(24,26);
    CS(25,27); CS(28,30); CS(29,31); CS(32,34); CS(33,35); CS(1,2); CS(5,6);
    CS(9,10); CS(13,14); CS(17,18); CS(21,22); CS(25,26); CS(29,30);
    CS(33,34); CS(0,4); CS(1,5); CS(2,6); CS(3,7); CS(8,12); CS(9,13);
    CS(10,14); CS(11,15); CS(16,20); CS(17,21); CS(18,22); CS(19,23);
    CS(24,28); CS(25,29); CS(26,30); CS(27,31); CS(32,36); CS(33,37);
    CS(2,4); CS(3,5); CS(10,12); CS(11,13); CS(18,20); CS(19,21); CS(26,28);
    CS(27,29); CS(34,36); CS(35,37); CS(1,2); CS(3,4); CS(5,6); CS(9,10);
    CS(11,12); CS(13,14); CS(17,18); CS(19,20); CS(21,22); CS(25,26);
    CS(27,28); CS(29,30); CS(33,34); CS(35,36); CS(0,8); CS(1,9); CS(2,10);
    CS(3,11); CS(4,12); CS(5,13); CS(6,14); CS(7,15); CS(16,24); CS(17,25);
    CS(18,26); CS(19,27); CS(20,28); CS(21,29); CS(22,30); CS(23,31);
    CS(4,8); CS(5,9); CS(6,10); CS(7,11); CS(20,24); CS(21,25); CS(22,26);
    CS(23,27); CS(2,4); CS(3,5); CS(6,8); CS(7,9); CS(10,12); CS(11,13);
    CS(18,20); CS(19,21); CS(22,24); CS(23,25); CS(26,28); CS(27,29);
    CS(34,36); CS(35,37); CS(1,2); CS(3,4); CS(5,6); CS(7,8); CS(9,10);
    CS(11,12); CS(13,14); CS(17,18); CS(19,20); CS(21,22); CS(23,24);
    CS(25,26); CS(27,28); CS(29,30); CS(33,34); CS(35,36); CS(0,16);
    CS(1,17); CS(2,18); CS(3,19); CS(4,20); CS(5,21); CS(6,22); CS(7,23);
    CS(8,24); CS(9,25); CS(10,26); CS(11,27); CS(12,28); CS(13,29);
    CS(14,30); CS(15,31); CS(8,16); CS(9,17); CS(10,18); CS(11,19);
    CS(12,20); CS(13,21); CS(14,22); CS(15,23); CS(4,8); CS(5,9); CS(6,10);
    CS(7,11); CS(12,16); CS(13,17); CS(14,18); CS(15,19); CS(20,24);
    CS(21,25); CS(22,26); CS(23,27); CS(2,4); CS(3,5); CS(6,8); CS(7,9);
    CS(10,12); CS(11,13); CS(14,16); CS(15,17); CS(18,20); CS(19,21);
    CS(22,24); CS(23,25); CS(26,28); CS(34,36); CS(35,37); CS(1,2); CS(3,4);
    CS(5,6); CS(9,10); CS(11,12); CS(13,14); CS(15,16); CS(17,18); CS(19,20);
    CS(21,22); CS(23,24); CS(25,26); CS(33,34); CS(35,36); CS(0,32);
    CS(1,33); CS(2,34); CS(3,35); CS(4,36); CS(5,37); CS(16,32); CS(17,33);
    CS(18,34); CS(19,35); CS(20,36); CS(21,37); CS(9,17); CS(10,18);
    CS(11,19); CS(12,20); CS(13,21); CS(14,22); CS(15,23); CS(24,32);
    CS(25,33); CS(13,17); CS(14,18); CS(15,19); CS(20,24); CS(21,25);
    CS(15,17); CS(18,20); CS(19,21); CS(17,18); CS(19,20);
  }
};

template <>
struct MedianCore<51, 4> {
  __device__ __forceinline__ static void run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(8,9); CS(10,11); CS(12,13);
    CS(14,15); CS(16,17); CS(18,19); CS(20,21); CS(22,23); CS(24,25);
    CS(26,27); CS(28,29); CS(30,31); CS(32,33); CS(34,35); CS(36,37);
    CS(38,39); CS(40,41); CS(42,43); CS(44,45); CS(46,47); CS(0,2); CS(1,3);
    CS(4,6); CS(5,7); CS(8,10); CS(9,11); CS(12,14); CS(13,15); CS(16,18);
    CS(17,19); CS(20,22); CS(21,23); CS(24,26); CS(25,27); CS(28,30);
    CS(29,31); CS(32,34); CS(33,35); CS(36,38); CS(37,39); CS(40,42);
    CS(41,43); CS(44,46); CS(45,47); CS(1,2); CS(5,6); CS(9,10); CS(13,14);
    CS(17,18); CS(21,22); CS(25,26); CS(29,30); CS(33,34); CS(37,38);
    CS(41,42); CS(45,46); CS(0,4); CS(1,5); CS(2,6); CS(3,7); CS(8,12);
    CS(9,13); CS(10,14); CS(11,15); CS(16,20); CS(17,21); CS(18,22);
    CS(19,23); CS(24,28); CS(25,29); CS(26,30); CS(27,31); CS(32,36);
    CS(33,37); CS(34,38); CS(35,39); CS(40,44); CS(41,45); CS(42,46);
    CS(43,47); CS(2,4); CS(3,5); CS(10,12); CS(11,13); CS(18,20); CS(19,21);
    CS(26,28); CS(27,29); CS(34,36); CS(35,37); CS(42,44); CS(43,45);
    CS(1,2); CS(3,4); CS(5,6); CS(9,10); CS(11,12); CS(13,14); CS(17,18);
    CS(19,20); CS(21,22); CS(25,26); CS(27,28); CS(29,30); CS(33,34);
    CS(35,36); CS(37,38); CS(41,42); CS(43,44); CS(45,46); CS(0,8); CS(1,9);
    CS(2,10); CS(3,11); CS(4,12); CS(5,13); CS(6,14); CS(7,15); CS(16,24);
    CS(17,25); CS(18,26); CS(19,27); CS(20,28); CS(21,29); CS(22,30);
    CS(23,31); CS(32,40); CS(33,41); CS(34,42); CS(35,43); CS(36,44);
    CS(37,45); CS(38,46); CS(39,47); CS(4,8); CS(5,9); CS(6,10); CS(7,11);
    CS(20,24); CS(21,25); CS(22,26); CS(23,27); CS(36,40); CS(37,41);
    CS(38,42); CS(39,43); CS(2,4); CS(3,5); CS(6,8); CS(7,9); CS(10,12);
    CS(11,13); CS(18,20); CS(19,21); CS(22,24); CS(23,25); CS(26,28);
    CS(27,29); CS(34,36); CS(35,37); CS(38,40); CS(39,41); CS(42,44);
    CS(43,45); CS(1,2); CS(3,4); CS(5,6); CS(7,8); CS(9,10); CS(11,12);
    CS(13,14); CS(17,18); CS(19,20); CS(21,22); CS(23,24); CS(25,26);
    CS(27,28); CS(29,30); CS(33,34); CS(35,36); CS(37,38); CS(39,40);
    CS(41,42); CS(43,44); CS(45,46); CS(0,16); CS(1,17); CS(2,18); CS(3,19);
    CS(4,20); CS(5,21); CS(6,22); CS(7,23); CS(8,24); CS(9,25); CS(10,26);
    CS(11,27); CS(12,28); CS(13,29); CS(14,30); CS(15,31); CS(8,16);
    CS(9,17); CS(10,18); CS(11,19); CS(12,20); CS(13,21); CS(14,22);
    CS(15,23); CS(4,8); CS(5,9); CS(6,10); CS(7,11); CS(12,16); CS(13,17);
    CS(14,18); CS(15,19); CS(20,24); CS(21,25); CS(22,26); CS(23,27);
    CS(36,40); CS(37,41); CS(38,42); CS(39,43); CS(2,4); CS(3,5); CS(6,8);
    CS(7,9); CS(10,12); CS(11,13); CS(14,16); CS(15,17); CS(18,20);
    CS(19,21); CS(22,24); CS(23,25); CS(26,28); CS(27,29); CS(34,36);
    CS(35,37); CS(38,40); CS(39,41); CS(42,44); CS(43,45); CS(1,2); CS(3,4);
    CS(5,6); CS(7,8); CS(9,10); CS(11,12); CS(13,14); CS(15,16); CS(17,18);
    CS(19,20); CS(21,22); CS(23,24); CS(25,26); CS(27,28); CS(33,34);
    CS(35,36); CS(37,38); CS(39,40); CS(41,42); CS(43,44); CS(45,46);
    CS(0,32); CS(1,33); CS(2,34); CS(3,35); CS(4,36); CS(5,37); CS(6,38);
    CS(7,39); CS(8,40); CS(9,41); CS(10,42); CS(11,43); CS(12,44); CS(13,45);
    CS(14,46); CS(15,47); CS(16,32); CS(17,33); CS(18,34); CS(19,35);
    CS(20,36); CS(21,37); CS(22,38); CS(23,39); CS(24,40); CS(25,41);
    CS(26,42); CS(27,43); CS(28,44); CS(11,19); CS(12,20); CS(13,21);
    CS(14,22); CS(15,23); CS(24,32); CS(25,33); CS(26,34); CS(27,35);
    CS(28,36); CS(15,19); CS(20,24); CS(21,25); CS(22,26); CS(23,27);
    CS(28,32); CS(19,21); CS(22,24); CS(23,25); CS(26,28); CS(21,22);
    CS(23,24); CS(25,26);
  }
};

template <>
struct MedianCore<21, 2> {
  __device__ __forceinline__ static void run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(8,9); CS(10,11); CS(12,13);
    CS(14,15); CS(16,17); CS(18,19); CS(0,2); CS(1,3); CS(4,6); CS(5,7);
    CS(8,10); CS(9,11); CS(12,14); CS(13,15); CS(16,18); CS(17,19); CS(1,2);
    CS(5,6); CS(9,10); CS(13,14); CS(17,18); CS(0,4); CS(1,5); CS(2,6);
    CS(3,7); CS(8,12); CS(9,13); CS(10,14); CS(11,15); CS(2,4); CS(3,5);
    CS(10,12); CS(11,13); CS(1,2); CS(3,4); CS(5,6); CS(9,10); CS(11,12);
    CS(13,14); CS(17,18); CS(0,8); CS(1,9); CS(2,10); CS(3,11); CS(4,12);
    CS(5,13); CS(6,14); CS(7,15); CS(4,8); CS(5,9); CS(6,10); CS(7,11);
    CS(2,4); CS(3,5); CS(6,8); CS(7,9); CS(10,12); CS(11,13); CS(1,2);
    CS(3,4); CS(5,6); CS(7,8); CS(9,10); CS(11,12); CS(17,18); CS(0,16);
    CS(1,17); CS(2,18); CS(3,19); CS(8,16); CS(9,17); CS(10,18); CS(11,19);
    CS(5,9); CS(6,10); CS(7,11); CS(12,16); CS(7,9); CS(10,12); CS(9,10);
  }
};

template <>
struct MedianCore<31, 2> {
  __device__ __forceinline__ static void run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(8,9); CS(10,11); CS(12,13);
    CS(14,15); CS(16,17); CS(18,19); CS(20,21); CS(22,23); CS(24,25);
    CS(26,27); CS(28,29); CS(0,2); CS(1,3); CS(4,6); CS(5,7); CS(8,10);
    CS(9,11); CS(12,14); CS(13,15); CS(16,18); CS(17,19); CS(20,22);
    CS(21,23); CS(24,26); CS(25,27); CS(1,2); CS(5,6); CS(9,10); CS(13,14);
    CS(17,18); CS(21,22); CS(25,26); CS(0,4); CS(1,5); CS(2,6); CS(3,7);
    CS(8,12); CS(9,13); CS(10,14); CS(11,15); CS(16,20); CS(17,21);
    CS(18,22); CS(19,23); CS(24,28); CS(25,29); CS(2,4); CS(3,5); CS(10,12);
    CS(11,13); CS(18,20); CS(19,21); CS(26,28); CS(27,29); CS(1,2); CS(3,4);
    CS(5,6); CS(9,10); CS(11,12); CS(13,14); CS(17,18); CS(19,20); CS(21,22);
    CS(25,26); CS(27,28); CS(0,8); CS(1,9); CS(2,10); CS(3,11); CS(4,12);
    CS(5,13); CS(6,14); CS(7,15); CS(16,24); CS(17,25); CS(18,26); CS(19,27);
    CS(20,28); CS(21,29); CS(4,8); CS(5,9); CS(6,10); CS(7,11); CS(20,24);
    CS(21,25); CS(22,26); CS(23,27); CS(2,4); CS(3,5); CS(6,8); CS(7,9);
    CS(10,12); CS(11,13); CS(18,20); CS(19,21); CS(22,24); CS(23,25);
    CS(26,28); CS(27,29); CS(1,2); CS(3,4); CS(5,6); CS(7,8); CS(9,10);
    CS(11,12); CS(13,14); CS(17,18); CS(19,20); CS(21,22); CS(23,24);
    CS(25,26); CS(27,28); CS(0,16); CS(1,17); CS(2,18); CS(3,19); CS(4,20);
    CS(5,21); CS(6,22); CS(7,23); CS(8,24); CS(9,25); CS(10,26); CS(11,27);
    CS(12,28); CS(13,29); CS(8,16); CS(9,17); CS(10,18); CS(11,19);
    CS(12,20); CS(13,21); CS(14,22); CS(15,23); CS(7,11); CS(12,16);
    CS(13,17); CS(14,18); CS(15,19); CS(11,13); CS(14,16); CS(15,17);
    CS(13,14); CS(15,16);
  }
};

template <>
struct MedianCore<41, 2> {
  __device__ __forceinline__ static void run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(8,9); CS(10,11); CS(12,13);
    CS(14,15); CS(16,17); CS(18,19); CS(20,21); CS(22,23); CS(24,25);
    CS(26,27); CS(28,29); CS(30,31); CS(32,33); CS(34,35); CS(36,37);
    CS(38,39); CS(0,2); CS(1,3); CS(4,6); CS(5,7); CS(8,10); CS(9,11);
    CS(12,14); CS(13,15); CS(16,18); CS(17,19); CS(20,22); CS(21,23);
    CS(24,26); CS(25,27); CS(28,30); CS(29,31); CS(32,34); CS(33,35);
    CS(36,38); CS(37,39); CS(1,2); CS(5,6); CS(9,10); CS(13,14); CS(17,18);
    CS(21,22); CS(25,26); CS(29,30); CS(33,34); CS(37,38); CS(0,4); CS(1,5);
    CS(2,6); CS(3,7); CS(8,12); CS(9,13); CS(10,14); CS(11,15); CS(16,20);
    CS(17,21); CS(18,22); CS(19,23); CS(24,28); CS(25,29); CS(26,30);
    CS(27,31); CS(32,36); CS(33,37); CS(34,38); CS(35,39); CS(2,4); CS(3,5);
    CS(10,12); CS(11,13); CS(18,20); CS(19,21); CS(26,28); CS(27,29);
    CS(34,36); CS(35,37); CS(1,2); CS(3,4); CS(5,6); CS(9,10); CS(11,12);
    CS(13,14); CS(17,18); CS(19,20); CS(21,22); CS(25,26); CS(27,28);
    CS(29,30); CS(33,34); CS(35,36); CS(37,38); CS(0,8); CS(1,9); CS(2,10);
    CS(3,11); CS(4,12); CS(5,13); CS(6,14); CS(7,15); CS(16,24); CS(17,25);
    CS(18,26); CS(19,27); CS(20,28); CS(21,29); CS(22,30); CS(23,31);
    CS(4,8); CS(5,9); CS(6,10); CS(7,11); CS(20,24); CS(21,25); CS(22,26);
    CS(23,27); CS(2,4); CS(3,5); CS(6,8); CS(7,9); CS(10,12); CS(11,13);
    CS(18,20); CS(19,21); CS(22,24); CS(23,25); CS(26,28); CS(27,29);
    CS(34,36); CS(35,37); CS(1,2); CS(3,4); CS(5,6); CS(7,8); CS(9,10);
    CS(11,12); CS(13,14); CS(17,18); CS(19,20); CS(21,22); CS(23,24);
    CS(25,26); CS(27,28); CS(29,30); CS(33,34); CS(35,36); CS(37,38);
    CS(0,16); CS(1,17); CS(2,18); CS(3,19); CS(4,20); CS(5,21); CS(6,22);
    CS(7,23); CS(8,24); CS(9,25); CS(10,26); CS(11,27); CS(12,28); CS(13,29);
    CS(14,30); CS(15,31); CS(8,16); CS(9,17); CS(10,18); CS(11,19);
    CS(12,20); CS(13,21); CS(14,22); CS(15,23); CS(4,8); CS(5,9); CS(6,10);
    CS(7,11); CS(12,16); CS(13,17); CS(14,18); CS(15,19); CS(20,24);
    CS(21,25); CS(22,26); CS(23,27); CS(2,4); CS(3,5); CS(6,8); CS(7,9);
    CS(10,12); CS(11,13); CS(14,16); CS(15,17); CS(18,20); CS(19,21);
    CS(22,24); CS(23,25); CS(26,28); CS(34,36); CS(35,37); CS(1,2); CS(3,4);
    CS(5,6); CS(7,8); CS(9,10); CS(11,12); CS(13,14); CS(15,16); CS(17,18);
    CS(19,20); CS(21,22); CS(23,24); CS(25,26); CS(33,34); CS(35,36);
    CS(37,38); CS(0,32); CS(1,33); CS(2,34); CS(3,35); CS(4,36); CS(5,37);
    CS(6,38); CS(7,39); CS(16,32); CS(17,33); CS(18,34); CS(19,35);
    CS(20,36); CS(21,37); CS(22,38); CS(23,39); CS(10,18); CS(11,19);
    CS(12,20); CS(13,21); CS(14,22); CS(15,23); CS(24,32); CS(25,33);
    CS(14,18); CS(15,19); CS(20,24); CS(21,25); CS(18,20); CS(19,21);
    CS(19,20);
  }
};

template <>
struct MedianCore<51, 2> {
  __device__ __forceinline__ static void run(float* v) {
    CS(0,1); CS(2,3); CS(4,5); CS(6,7); CS(8,9); CS(10,11); CS(12,13);
    CS(14,15); CS(16,17); CS(18,19); CS(20,21); CS(22,23); CS(24,25);
    CS(26,27); CS(28,29); CS(30,31); CS(32,33); CS(34,35); CS(36,37);
    CS(38,39); CS(40,41); CS(42,43); CS(44,45); CS(46,47); CS(48,49);
    CS(0,2); CS(1,3); CS(4,6); CS(5,7); CS(8,10); CS(9,11); CS(12,14);
    CS(13,15); CS(16,18); CS(17,19); CS(20,22); CS(21,23); CS(24,26);
    CS(25,27); CS(28,30); CS(29,31); CS(32,34); CS(33,35); CS(36,38);
    CS(37,39); CS(40,42); CS(41,43); CS(44,46); CS(45,47); CS(1,2); CS(5,6);
    CS(9,10); CS(13,14); CS(17,18); CS(21,22); CS(25,26); CS(29,30);
    CS(33,34); CS(37,38); CS(41,42); CS(45,46); CS(0,4); CS(1,5); CS(2,6);
    CS(3,7); CS(8,12); CS(9,13); CS(10,14); CS(11,15); CS(16,20); CS(17,21);
    CS(18,22); CS(19,23); CS(24,28); CS(25,29); CS(26,30); CS(27,31);
    CS(32,36); CS(33,37); CS(34,38); CS(35,39); CS(40,44); CS(41,45);
    CS(42,46); CS(43,47); CS(2,4); CS(3,5); CS(10,12); CS(11,13); CS(18,20);
    CS(19,21); CS(26,28); CS(27,29); CS(34,36); CS(35,37); CS(42,44);
    CS(43,45); CS(1,2); CS(3,4); CS(5,6); CS(9,10); CS(11,12); CS(13,14);
    CS(17,18); CS(19,20); CS(21,22); CS(25,26); CS(27,28); CS(29,30);
    CS(33,34); CS(35,36); CS(37,38); CS(41,42); CS(43,44); CS(45,46);
    CS(0,8); CS(1,9); CS(2,10); CS(3,11); CS(4,12); CS(5,13); CS(6,14);
    CS(7,15); CS(16,24); CS(17,25); CS(18,26); CS(19,27); CS(20,28);
    CS(21,29); CS(22,30); CS(23,31); CS(32,40); CS(33,41); CS(34,42);
    CS(35,43); CS(36,44); CS(37,45); CS(38,46); CS(39,47); CS(4,8); CS(5,9);
    CS(6,10); CS(7,11); CS(20,24); CS(21,25); CS(22,26); CS(23,27);
    CS(36,40); CS(37,41); CS(38,42); CS(39,43); CS(2,4); CS(3,5); CS(6,8);
    CS(7,9); CS(10,12); CS(11,13); CS(18,20); CS(19,21); CS(22,24);
    CS(23,25); CS(26,28); CS(27,29); CS(34,36); CS(35,37); CS(38,40);
    CS(39,41); CS(42,44); CS(43,45); CS(1,2); CS(3,4); CS(5,6); CS(7,8);
    CS(9,10); CS(11,12); CS(13,14); CS(17,18); CS(19,20); CS(21,22);
    CS(23,24); CS(25,26); CS(27,28); CS(29,30); CS(33,34); CS(35,36);
    CS(37,38); CS(39,40); CS(41,42); CS(43,44); CS(45,46); CS(0,16);
    CS(1,17); CS(2,18); CS(3,19); CS(4,20); CS(5,21); CS(6,22); CS(7,23);
    CS(8,24); CS(9,25); CS(10,26); CS(11,27); CS(12,28); CS(13,29);
    CS(14,30); CS(15,31); CS(32,48); CS(33,49); CS(8,16); CS(9,17);
    CS(10,18); CS(11,19); CS(12,20); CS(13,21); CS(14,22); CS(15,23);
    CS(40,48); CS(41,49); CS(4,8); CS(5,9); CS(6,10); CS(7,11); CS(12,16);
    CS(13,17); CS(14,18); CS(15,19); CS(20,24); CS(21,25); CS(22,26);
    CS(23,27); CS(36,40); CS(37,41); CS(38,42); CS(39,43); CS(44,48);
    CS(45,49); CS(2,4); CS(3,5); CS(6,8); CS(7,9); CS(10,12); CS(11,13);
    CS(14,16); CS(15,17); CS(18,20); CS(19,21); CS(22,24); CS(23,25);
    CS(26,28); CS(27,29); CS(34,36); CS(35,37); CS(38,40); CS(39,41);
    CS(42,44); CS(43,45); CS(46,48); CS(47,49); CS(1,2); CS(3,4); CS(5,6);
    CS(7,8); CS(9,10); CS(11,12); CS(13,14); CS(15,16); CS(17,18); CS(19,20);
    CS(21,22); CS(23,24); CS(25,26); CS(27,28); CS(33,34); CS(35,36);
    CS(37,38); CS(39,40); CS(41,42); CS(43,44); CS(45,46); CS(47,48);
    CS(0,32); CS(1,33); CS(2,34); CS(3,35); CS(4,36); CS(5,37); CS(6,38);
    CS(7,39); CS(8,40); CS(9,41); CS(10,42); CS(11,43); CS(12,44); CS(13,45);
    CS(14,46); CS(15,47); CS(16,48); CS(17,49); CS(16,32); CS(17,33);
    CS(18,34); CS(19,35); CS(20,36); CS(21,37); CS(22,38); CS(23,39);
    CS(24,40); CS(25,41); CS(26,42); CS(27,43); CS(28,44); CS(12,20);
    CS(13,21); CS(14,22); CS(15,23); CS(24,32); CS(25,33); CS(26,34);
    CS(27,35); CS(28,36); CS(20,24); CS(21,25); CS(22,26); CS(23,27);
    CS(28,32); CS(22,24); CS(23,25); CS(26,28); CS(23,24); CS(25,26);
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

// The networks of a pair this file does not hold (ops/_nvcc.py).
#ifdef HPSS_PAIR_NETWORKS
#include HPSS_PAIR_NETWORKS
#endif

#undef CS

// out[j] = median of x[j .. j+W-1] for j < K, from x[0 .. W+K-2]: the core
// network once, then one merge per output.  With constant indices all of
// it stays in registers.  A window too narrow to share a core with K - 1
// others (K > (W+1)/2: rank M-K+1 does not exist) takes Median<W> per
// output instead.
template <int W, int K>
__device__ __forceinline__ void running_medians(const float* x, float* out) {
  constexpr int LO = (W - 1) / 2 - K + 1;
  if constexpr (LO < 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float v[W];
#pragma unroll
      for (int i = 0; i < W; ++i) v[i] = x[j + i];
      out[j] = Median<W>::run(v);
    }
  } else {
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

// soft_masks at any power p, as the JAX kernels take it
// (ops/hpss_pallas.py::_masks_from_tile): the normalised medians raised to
// p through powf, with the same rule where z is below float32's smallest
// normal.  p is a kernel argument; the kernels take soft_masks at p == 2
// (a uniform branch), so the squares stay as they are.
__device__ __forceinline__ void soft_masks_pow(float harm, float perc,
                                               float power, float* mask_h,
                                               float* mask_p) {
  const float z = fmaxf(harm, perc);
  const bool bad = z < FLT_MIN;
  const float zn = bad ? 1.f : z;
  const float hn = powf(harm / zn, power);
  const float pn = powf(perc / zn, power);
  const float den = bad ? 1.f : hn + pn;
  *mask_h = bad ? 0.f : hn / den;
  *mask_p = bad ? 0.f : pn / den;
}

// soft_masks_pow with soft_masks_rcp's reciprocals.
__device__ __forceinline__ void soft_masks_rcp_pow(float harm, float perc,
                                                   float power,
                                                   float* mask_h,
                                                   float* mask_p) {
  const float z = fmaxf(harm, perc);
  const bool bad = z < FLT_MIN;
  const float r = __frcp_rn(bad ? 1.f : z);
  const float hn = powf(harm * r, power);
  const float pn = powf(perc * r, power);
  const float rd = __frcp_rn(bad ? 1.f : hn + pn);
  *mask_h = bad ? 0.f : hn * rd;
  *mask_p = bad ? 0.f : pn * rd;
}

}  // namespace hpss_median
