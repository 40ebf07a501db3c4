// K1 and K2 on Hopper: fused STFT magnitude -> HPSS medians and Wiener
// masks -> (K1) mel projection, from raw audio to both HPSS feature maps in
// one launch.
//
// Replaces the TPU kernels of ops/frontend_pallas.py in the JAX package:
// K1 is _frontend_kernel (mel output), K2 is _frontend_kernel_mag
// (full-resolution output); both share the body _tile_masks and are launched
// by _frontend_pallas.  Same function: for every frame t of a (B, N) batch of
// audio, the Hann-windowed rDFT magnitude S (center=False), an l_harm-frame
// harmonic median across time and an l_perc-bin percussive median across
// frequency (both with numpy mode='symmetric' edges), librosa's softmask
// (power 2, split_zeros=False), then
//   K1: the mel projections of S*mask_h and S*mask_p, two (B, n_mels, T) maps;
//   K2: S*mask_h and S*mask_p themselves, two (B, F, T) maps.
// One template, frontend_kernel<LH, LP, FULLRES>; FULLRES selects the
// epilogue and nothing else, so K1's arithmetic is K2's up to the masks.
//
// What bounds them on an H100: operations.  K1 needs ~63k f32 FLOPs per
// output frame at n_fft 400 (a real FFT ~2.5*n_fft*log2(n_fft) ~ 8.6k, the
// median comparators ~49k, window, magnitude, masks and sparse mel ~4.5k)
// against 1,600 bytes of audio in and features out, ~39 FLOP/byte, above the
// f32 CUDA-core ridge (~20).  K2 drops the mel projection but writes 2F
// floats per frame (2,056 bytes at n_fft 512), ~30 FLOP/byte: operations
// still bound it.  The kernels compute the DFT directly, 2*n_fft*2F FLOPs per
// frame (~526k at n_fft 512): several times the function's floor, taken for
// a simple, exact loop with no FFT plan (an FFT or tensor-core DFT is later
// work).  The design keeps every intermediate on chip and spends its effort
// on the DFT's inner loop:
//   - One block per (32-frame time tile, batch item).  Blocks are independent;
//     nothing carries between them.  A tile recomputes its 2*ht halo frames
//     (x1.6 DFT work at ht=10), the price of having no inter-block traffic.
//   - The block windows its 52 frames into shared memory, stored [n][frame]
//     so that one thread reads 8 frames of one sample as two broadcast
//     float4 loads.  Frame indices outside [0, T) map by the symmetric rule,
//     so the time edge mirror needs no special tile and every T >= 1 works.
//   - Twiddles come from an n_fft-entry (cos, sin) table indexed by
//     (n*k) mod n_fft, kept exact (no recurrence); each thread accumulates
//     one bin for 8 frames in registers, 16 FMAs per table read.
//   - Medians run in registers through the pruned Batcher networks of
//     median.cuh (those of ops/hpss_pallas.py::median_network).
//   - K1: the mel projection reads the (n_mels, F) basis from global memory,
//     where it stays in L1/L2, and the masked tiles from shared memory.
//   - K2: the masked magnitudes go straight from registers to global memory;
//     the 32 lanes of a warp take the 32 frames of one bin, so each store of
//     a warp is one contiguous run of a (B, F, T) row.
// Shared memory per block: (3*n_fft + NFP*n_fft + NF*F) floats, 136 KB at
// n_fft 400 and 170 KB at n_fft 512 with l_harm 21 (under the 227 KB a block
// may take after cudaFuncSetAttribute), so one block runs per SM.
// The DFT is full f32 on the CUDA cores (the dft_precision='highest'
// contract); a split-precision tensor-core mode is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfrontend.so frontend.cu
// C interface, loaded with ctypes by sm_hpss_mtl_tpu_torch/ops/frontend.py.

#include <cuda_runtime.h>

#include "median.cuh"

namespace {

constexpr int TILE = 32;     // output frames per block (= one warp of lanes)
constexpr int FR = 8;        // frames per thread in the DFT loop
constexpr int THREADS = 256;
constexpr int MPT = 4;       // mel bands per thread in the projection

using hpss_median::Median;
using hpss_median::sym;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

template <int LH>
struct Geometry {
  static constexpr int HT = LH / 2;
  static constexpr int NF = TILE + 2 * HT;        // frames a tile needs
  static constexpr int NFP = round_up(NF, FR);    // padded to the DFT blocking
};

// Shared-memory layout, in floats:
//   tab  [n_fft] float2   (cos, sin) of 2*pi*i/n_fft
//   win  [n_fft]          Hann window, zero-padded to n_fft
//   xw   [n_fft][NFP]     windowed frames; K1 reuses it for the H and P
//                         tiles ([TILE][F] each) once the DFT is done
//   mag  [NF][F]          magnitudes, frames in mirrored order
__host__ __device__ inline int xw_offset(int n_fft) {
  return round_up(3 * n_fft, 4);
}

template <int LH>
__host__ __device__ inline int xw_floats(int n_fft) {
  const int F = n_fft / 2 + 1;
  const int a = n_fft * Geometry<LH>::NFP, b = 2 * TILE * F;
  return a > b ? a : b;
}

template <int LH, int LP, bool FULLRES>
__global__ void __launch_bounds__(THREADS)
frontend_kernel(const float* __restrict__ y, const float* __restrict__ mel,
                float* __restrict__ out_h, float* __restrict__ out_p, int N,
                int T, int n_fft, int win_length, int hop, int n_mels) {
  constexpr int HT = Geometry<LH>::HT;
  constexpr int HP = LP / 2;
  constexpr int NF = Geometry<LH>::NF;
  constexpr int NFP = Geometry<LH>::NFP;
  const int F = n_fft / 2 + 1;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const float* yb = y + (size_t)b * N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float2* tab = reinterpret_cast<float2*>(smem);
  float* win = smem + 2 * n_fft;
  float* xw = smem + xw_offset(n_fft);
  float* mag = xw + xw_floats<LH>(n_fft);

  // Twiddle table and window, in double then rounded once to f32.
  const int lpad = (n_fft - win_length) / 2;
  for (int i = threadIdx.x; i < n_fft; i += THREADS) {
    double s, c;
    sincospi(2.0 * i / n_fft, &s, &c);
    tab[i] = make_float2((float)c, (float)s);
    const int j = i - lpad;
    win[i] = (j >= 0 && j < win_length)
                 ? (float)(0.5 - 0.5 * cospi(2.0 * j / win_length))
                 : 0.f;
  }
  __syncthreads();

  // Windowed frames t0-HT .. t0+TILE+HT-1, mirrored into [0, T).
  for (int idx = threadIdx.x; idx < NFP * n_fft; idx += THREADS) {
    const int i = idx / n_fft;
    const int n = idx - i * n_fft;
    float v = 0.f;
    if (i < NF) {
      const int m = sym(t0 - HT + i, T);
      v = yb[(size_t)m * hop + n] * win[n];
    }
    xw[n * NFP + i] = v;
  }
  __syncthreads();

  // DFT magnitudes: lane = bin, FR frames per thread.
  const int n_kg = (F + 31) / 32;
  const int n_tasks = n_kg * (NFP / FR);
  for (int task = warp; task < n_tasks; task += THREADS / 32) {
    const int kg = task % n_kg;
    const int fg = task / n_kg;
    const int k = kg * 32 + lane;
    const int kk = k < F ? k : 0;  // idle lanes compute bin 0, then discard
    float re[FR], im[FR];
#pragma unroll
    for (int j = 0; j < FR; ++j) {
      re[j] = 0.f;
      im[j] = 0.f;
    }
    const float* xcol = xw + fg * FR;
    int idx = 0;
    for (int n = 0; n < n_fft; ++n) {
      const float2 cs = tab[idx];
      idx += kk;
      if (idx >= n_fft) idx -= n_fft;
      const float4* xp = reinterpret_cast<const float4*>(xcol + n * NFP);
      const float4 a = xp[0], c = xp[1];
      const float x[FR] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int j = 0; j < FR; ++j) {
        re[j] = fmaf(x[j], cs.x, re[j]);
        im[j] = fmaf(x[j], cs.y, im[j]);
      }
    }
    if (k < F) {
#pragma unroll
      for (int j = 0; j < FR; ++j) {
        const int i = fg * FR + j;
        if (i < NF) mag[i * F + k] = sqrtf(re[j] * re[j] + im[j] * im[j]);
      }
    }
  }
  __syncthreads();

  // Medians and soft masks.  K1: the masked tiles overwrite the frame
  // buffer, [frame][bin].  K2: lane = frame, each warp writes one bin's
  // 32 frames to the (B, F, T) outputs.
  float* hs = xw;
  float* ps = xw + TILE * F;
  for (int idx = threadIdx.x; idx < TILE * F; idx += THREADS) {
    int i, k;
    if constexpr (FULLRES) {
      k = idx / TILE;
      i = idx - k * TILE;
    } else {
      i = idx / F;
      k = idx - i * F;
    }
    float v[LH];
#pragma unroll
    for (int j = 0; j < LH; ++j) v[j] = mag[(i + j) * F + k];
    const float harm = Median<LH>::run(v);
    float u[LP];
#pragma unroll
    for (int j = 0; j < LP; ++j) u[j] = mag[(i + HT) * F + sym(k + j - HP, F)];
    const float perc = Median<LP>::run(u);
    const float s = mag[(i + HT) * F + k];
    float mh, mp;
    hpss_median::soft_masks(harm, perc, &mh, &mp);
    if constexpr (FULLRES) {
      if (t0 + i < T) {
        const size_t o = ((size_t)b * F + k) * T + t0 + i;
        out_h[o] = s * mh;
        out_p[o] = s * mp;
      }
    } else {
      hs[idx] = s * mh;
      ps[idx] = s * mp;
    }
  }
  if constexpr (FULLRES) return;
  __syncthreads();

  // Mel projection: lane = frame of the tile, MPT bands per thread.
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

template <int LH, int LP, bool FULLRES>
cudaError_t launch(const float* y, const float* mel, float* out_h,
                   float* out_p, int B, int N, int T, int n_fft,
                   int win_length, int hop, int n_mels, cudaStream_t stream) {
  const int F = n_fft / 2 + 1;
  const size_t floats = (size_t)xw_offset(n_fft) + xw_floats<LH>(n_fft) +
                        (size_t)Geometry<LH>::NF * F;
  const size_t bytes = floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      frontend_kernel<LH, LP, FULLRES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + TILE - 1) / TILE, B);
  frontend_kernel<LH, LP, FULLRES><<<grid, THREADS, bytes, stream>>>(
      y, mel, out_h, out_p, N, T, n_fft, win_length, hop, n_mels);
  return cudaGetLastError();
}

template <bool FULLRES>
int dispatch(const void* y, const void* mel, void* out_h, void* out_p, int B,
             int N, int T, int n_fft, int win_length, int hop, int l_harm,
             int l_perc, int n_mels, void* stream) {
  const float* yy = static_cast<const float*>(y);
  const float* mm = static_cast<const float*>(mel);
  float* oh = static_cast<float*>(out_h);
  float* op = static_cast<float*>(out_p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l_harm == 21 && l_perc == 11)
    return launch<21, 11, FULLRES>(yy, mm, oh, op, B, N, T, n_fft, win_length,
                                   hop, n_mels, st);
  if (l_harm == 11 && l_perc == 5)
    return launch<11, 5, FULLRES>(yy, mm, oh, op, B, N, T, n_fft, win_length,
                                  hop, n_mels, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches K1 on `stream`.  y: (B, N) f32; mel: (n_mels, n_fft/2+1) f32;
// out_h, out_p: (B, n_mels, T) f32, T = 1 + (N - n_fft) / hop >= 1.
// Returns a cudaError_t; cudaErrorInvalidValue for an unsupported
// (l_harm, l_perc) pair.  Does not synchronise.
int k1_stft_hpss_mel(const void* y, const void* mel, void* out_h, void* out_p,
                     int B, int N, int T, int n_fft, int win_length, int hop,
                     int l_harm, int l_perc, int n_mels, void* stream) {
  return dispatch<false>(y, mel, out_h, out_p, B, N, T, n_fft, win_length,
                         hop, l_harm, l_perc, n_mels, stream);
}

// Launches K2 on `stream`.  y: (B, N) f32; out_h, out_p: (B, n_fft/2+1, T)
// f32, T = 1 + (N - n_fft) / hop >= 1.  Returns as k1_stft_hpss_mel does.
int k2_stft_hpss(const void* y, void* out_h, void* out_p, int B, int N, int T,
                 int n_fft, int win_length, int hop, int l_harm, int l_perc,
                 void* stream) {
  return dispatch<true>(y, nullptr, out_h, out_p, B, N, T, n_fft, win_length,
                        hop, l_harm, l_perc, 0, stream);
}

const char* k1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
