// K3 and K4 on Hopper: spectral HPSS, from a magnitude spectrogram to the
// masked harmonic and percussive components or the two soft masks (K3), or
// to the mel projections of both components (K4).
//
// K3 replaces the TPU kernel ops/hpss_pallas.py::_hpss_kernel (with its body
// _masks_from_tile), launched by _hpss_pallas behind hpss and hpss_masks, of
// the JAX package.  Same function: for every bin (f, t) of a (B, F, T)
// float32 magnitude batch, an l_harm-frame harmonic median across time and
// an l_perc-bin percussive median across frequency (numpy mode='symmetric'
// edges on both axes), librosa's softmask (power 2, split_zeros=False), and
// either S*mask_h and S*mask_p or the masks alone (mask_only), written as two
// (B, F, T) maps.
//
// K4 replaces ops/hpss_pallas.py::_hpss_mel_kernel, launched by
// _hpss_mel_pallas behind hpss_mel: the same medians and masks, then
// M @ (S*mask_h) and M @ (S*mask_p) for an (n_mels, F) mel basis M, written
// as two (B, n_mels, T) maps.  The front end takes it for clips shorter than
// 2*(l_harm//2) frames (ops/frontend.py), so on its path T is 1..19 and the
// whole launch is a single block per item.
//
// What bounds K3 on an H100: bytes, narrowly.  Per bin it reads 4 bytes and
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
// What bounds K4: launch latency on its path, and bytes beyond it.  Per
// frame it reads F magnitudes (804 bytes at F = 201) and writes 2*n_mels
// floats (960 bytes), and it reads the 96 KB basis once, against ~256 f32
// operations per bin for the medians and masks and two FMAs per nonzero of
// the basis for the mel sums.  On its path (B = 1, T <= 19) that is a few
// hundred thousand operations, far less than one launch costs.  The design
// is K3's tile load and K1's mel epilogue:
//   - One block per (32-frame time tile, batch item), covering all F bins.
//     It loads its F x (32 + 2*(l_harm/2)) window of S into shared memory,
//     mapping time indices through the symmetric rule, so every T >= 1 works
//     (T < l_harm repeats the mirror with period 2T) and no padded copy is
//     made.
//   - Medians and masks in registers (median.cuh), lane = frame; the
//     percussive window reads bins through sym(k + j - HP, F), as K1 does.
//     S*mask_h and S*mask_p go to two [32][F] shared tiles (stride F across
//     lanes, conflict-free for odd F).
//   - The mel projection is K1's epilogue (frontend.cu): lane = frame, MPT
//     bands per thread, basis rows read through __ldg.  An empty basis row
//     sums exact zeros, as the plain matmul does.
// Shared memory: F*(32 + 2*HT)*4 + 2*32*F*4 bytes, 93,264 at F = 201 and
// 119,248 at F = 257 with l_harm 21; an F that does not fit a block is
// refused.
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
constexpr int MPT = 4;  // K4: mel bands per thread in the projection

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

// K4: shared memory, in floats: the S window [F][W] then the masked tiles
// hs, ps [TT][F] each.
template <int LH>
inline size_t k4_smem_floats(int F) {
  return (size_t)F * (TT + 2 * (LH / 2)) + 2 * (size_t)TT * F;
}

template <int LH, int LP>
__global__ void __launch_bounds__(THREADS)
hpss_mel_kernel(const float* __restrict__ S, const float* __restrict__ mel,
                float* __restrict__ out_h, float* __restrict__ out_p, int F,
                int T, int n_mels) {
  constexpr int HT = LH / 2;
  constexpr int HP = LP / 2;
  constexpr int W = TT + 2 * HT;  // tile width with its time halos
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // [F][W]
  float* hs = tile + (size_t)F * W;               // [TT][F]
  float* ps = hs + (size_t)TT * F;                // [TT][F]

  const int t0 = blockIdx.x * TT;
  const int b = blockIdx.y;
  const float* Sb = S + (size_t)b * F * T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int idx = threadIdx.x; idx < F * W; idx += THREADS) {
    const int f = idx / W;
    const int c = idx - f * W;
    tile[idx] = Sb[(size_t)f * T + sym(t0 - HT + c, T)];
  }
  __syncthreads();

  // Medians and masks: lane = frame c of the tile, one bin f at a time.
  // Frames past T are computed from mirrored data and never stored.
  for (int idx = threadIdx.x; idx < TT * F; idx += THREADS) {
    const int f = idx / TT;
    const int c = idx - f * TT;
    float v[LH];
#pragma unroll
    for (int j = 0; j < LH; ++j) v[j] = tile[f * W + c + j];
    const float harm = Median<LH>::run(v);
    float u[LP];
#pragma unroll
    for (int j = 0; j < LP; ++j) u[j] = tile[sym(f + j - HP, F) * W + c + HT];
    const float perc = Median<LP>::run(u);
    float mh, mp;
    hpss_median::soft_masks(harm, perc, &mh, &mp);
    const float s = tile[f * W + c + HT];
    hs[c * F + f] = s * mh;
    ps[c * F + f] = s * mp;
  }
  __syncthreads();

  // Mel projection (K1's epilogue): lane = frame of the tile, MPT bands per
  // thread.
  const int tt = t0 + lane;
  for (int m0 = warp * MPT; m0 < n_mels; m0 += (THREADS / 32) * MPT) {
    float ah[MPT], ap[MPT];
    const float* rows[MPT];
#pragma unroll
    for (int j = 0; j < MPT; ++j) {
      ah[j] = 0.f;
      ap[j] = 0.f;
      rows[j] = mel + (size_t)min(m0 + j, n_mels - 1) * F;
    }
    for (int k = 0; k < F; ++k) {
      const float h = hs[lane * F + k];
      const float p = ps[lane * F + k];
#pragma unroll
      for (int j = 0; j < MPT; ++j) {
        const float w = __ldg(rows[j] + k);
        ah[j] = fmaf(w, h, ah[j]);
        ap[j] = fmaf(w, p, ap[j]);
      }
    }
    if (tt < T) {
#pragma unroll
      for (int j = 0; j < MPT; ++j) {
        const int m = m0 + j;
        if (m < n_mels) {
          const size_t o = ((size_t)b * n_mels + m) * T + tt;
          out_h[o] = ah[j];
          out_p[o] = ap[j];
        }
      }
    }
  }
}

template <int LH, int LP>
cudaError_t launch_mel(const float* S, const float* mel, float* out_h,
                       float* out_p, int B, int F, int T, int n_mels,
                       cudaStream_t stream) {
  const size_t bytes = k4_smem_floats<LH>(F) * sizeof(float);
  int device = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return e;
  if (bytes > (size_t)limit) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(hpss_mel_kernel<LH, LP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + TT - 1) / TT, B);
  hpss_mel_kernel<LH, LP><<<grid, THREADS, bytes, stream>>>(
      S, mel, out_h, out_p, F, T, n_mels);
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

// Launches K4 on `stream`.  S: (B, F, T) f32 magnitudes; mel: (n_mels, F)
// f32; out_h, out_p: (B, n_mels, T) f32, the mel projections of the masked
// components.  Returns a cudaError_t; cudaErrorInvalidValue for an
// unsupported (l_harm, l_perc) pair, an F whose shared memory does not fit
// one block, or a grid too large.  Does not synchronise.
int k4_hpss_mel(const void* S, const void* mel, void* out_h, void* out_p,
                int B, int F, int T, int l_harm, int l_perc, int n_mels,
                void* stream) {
  const float* s = static_cast<const float*>(S);
  const float* m = static_cast<const float*>(mel);
  float* oh = static_cast<float*>(out_h);
  float* op = static_cast<float*>(out_p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 65535 || n_mels < 1) return (int)cudaErrorInvalidValue;
  if (l_harm == 21 && l_perc == 11)
    return launch_mel<21, 11>(s, m, oh, op, B, F, T, n_mels, st);
  if (l_harm == 11 && l_perc == 5)
    return launch_mel<11, 5>(s, m, oh, op, B, F, T, n_mels, st);
  return (int)cudaErrorInvalidValue;
}

const char* k3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
