// K3 on Hopper: spectral HPSS, from a magnitude spectrogram to the masked
// harmonic and percussive components, or to the two soft masks.
//
// Replaces the TPU kernel ops/hpss_pallas.py::_hpss_kernel (with its body
// _masks_from_tile), launched by _hpss_pallas behind hpss and hpss_masks, of
// the JAX package.  Same function: for every bin (f, t) of a (B, F, T)
// float32 magnitude batch, an l_harm-frame harmonic median across time and
// an l_perc-bin percussive median across frequency (numpy mode='symmetric'
// edges on both axes), librosa's softmask (power 2, split_zeros=False), and
// either S*mask_h and S*mask_p or the masks alone (mask_only), written as two
// (B, F, T) maps.
//
// What bounds it on an H100: bytes, narrowly.  Per bin it reads 4 bytes and
// writes 8, against (91 + 32) comparators of two operations each and ~10
// mask operations at (21, 11): ~256 f32 operations per 12 bytes, ~21
// FLOP/byte, at the f32 CUDA-core ridge (~20).  So the design reads each
// input once from device memory and keeps the medians in registers:
//   - One block per (32-bin x 32-frame tile, batch item).  The block reads
//     its tile with halos of l_perc//2 bins and l_harm//2 frames into shared
//     memory, mapping every index through the symmetric rule (period 2n), so
//     the edges need no pre-padded copy (the TPU kernel's _pad_and_tile) and
//     every F, T >= 1 works.  Rows are read along frames, coalesced.
//   - Each thread takes one output bin at a time, lane = frame: the reads of
//     both median windows from shared memory are conflict-free (consecutive
//     words) and the stores of a warp are one contiguous run of a row.
//   - Medians run in registers through the pruned Batcher networks of
//     median.cuh (those of ops/hpss_pallas.py::median_network).
// The halo re-reads (52 x 42 loaded per 32 x 32 output at (21, 11)) come
// from L2 for the most part; device memory sees each input about once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libhpss.so hpss.cu
// C interface, loaded with ctypes by sm_hpss_mtl_tpu_torch/ops/hpss.py.

#include <cuda_runtime.h>

#include "median.cuh"

namespace {

constexpr int TT = 32;  // frames per tile (= one warp of lanes)
constexpr int TF = 32;  // bins per tile
constexpr int THREADS = 256;

using hpss_median::Median;
using hpss_median::sym;

template <int LH, int LP, bool MASK_ONLY>
__global__ void __launch_bounds__(THREADS)
hpss_kernel(const float* __restrict__ S, float* __restrict__ out_h,
            float* __restrict__ out_p, int F, int T) {
  constexpr int HT = LH / 2;
  constexpr int HP = LP / 2;
  constexpr int W = TT + 2 * HT;  // tile width with its time halos
  constexpr int R = TF + 2 * HP;  // tile height with its frequency halos
  __shared__ float tile[R * W];

  const int t0 = blockIdx.x * TT;
  const int f0 = blockIdx.y * TF;
  const size_t base = (size_t)blockIdx.z * F * T;
  const float* Sb = S + base;

  for (int idx = threadIdx.x; idx < R * W; idx += THREADS) {
    const int r = idx / W;
    const int c = idx - r * W;
    const int f = sym(f0 - HP + r, F);
    const int t = sym(t0 - HT + c, T);
    tile[idx] = Sb[(size_t)f * T + t];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < TF * TT; idx += THREADS) {
    const int r = idx / TT;
    const int c = idx - r * TT;
    const int f = f0 + r, t = t0 + c;
    if (f >= F || t >= T) continue;
    float v[LH];
#pragma unroll
    for (int j = 0; j < LH; ++j) v[j] = tile[(r + HP) * W + c + j];
    const float harm = Median<LH>::run(v);
    float u[LP];
#pragma unroll
    for (int j = 0; j < LP; ++j) u[j] = tile[(r + j) * W + c + HT];
    const float perc = Median<LP>::run(u);
    float mh, mp;
    hpss_median::soft_masks(harm, perc, &mh, &mp);
    const size_t o = base + (size_t)f * T + t;
    if constexpr (MASK_ONLY) {
      out_h[o] = mh;
      out_p[o] = mp;
    } else {
      const float s = tile[(r + HP) * W + c + HT];
      out_h[o] = s * mh;
      out_p[o] = s * mp;
    }
  }
}

template <int LH, int LP>
cudaError_t launch(const float* S, float* out_h, float* out_p, int B, int F,
                   int T, bool mask_only, cudaStream_t stream) {
  const dim3 grid((T + TT - 1) / TT, (F + TF - 1) / TF, B);
  if (mask_only)
    hpss_kernel<LH, LP, true><<<grid, THREADS, 0, stream>>>(S, out_h, out_p,
                                                            F, T);
  else
    hpss_kernel<LH, LP, false><<<grid, THREADS, 0, stream>>>(S, out_h, out_p,
                                                             F, T);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K3 on `stream`.  S: (B, F, T) f32 magnitudes; out_h, out_p:
// (B, F, T) f32, the masked components or (mask_only != 0) the masks.
// Returns a cudaError_t; cudaErrorInvalidValue for an unsupported
// (l_harm, l_perc) pair or a grid too large.  Does not synchronise.
int k3_hpss(const void* S, void* out_h, void* out_p, int B, int F, int T,
            int l_harm, int l_perc, int mask_only, void* stream) {
  const float* s = static_cast<const float*>(S);
  float* oh = static_cast<float*>(out_h);
  float* op = static_cast<float*>(out_p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((F + TF - 1) / TF > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (l_harm == 21 && l_perc == 11)
    return launch<21, 11>(s, oh, op, B, F, T, mask_only != 0, st);
  if (l_harm == 11 && l_perc == 5)
    return launch<11, 5>(s, oh, op, B, F, T, mask_only != 0, st);
  return (int)cudaErrorInvalidValue;
}

const char* k3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
