// K3 and K4 on Hopper: spectral HPSS, from a magnitude spectrogram to the
// masked harmonic and percussive components or the two soft masks (K3), or
// to the mel projections of both components (K4).
//
// K3 replaces the TPU kernel ops/hpss_pallas.py::_hpss_kernel (with its body
// _masks_from_tile), launched by _hpss_pallas behind hpss and hpss_masks, of
// the JAX package.  Same function: for every bin (f, t) of a (B, F, T)
// float32 magnitude batch, an l_harm-frame harmonic median across time and
// an l_perc-bin percussive median across frequency (numpy mode='symmetric'
// edges on both axes), librosa's softmask (any power; split_zeros=False),
// and either S*mask_h and S*mask_p or the masks alone (mask_only), written
// as two (B, F, T) maps.
//
// K4 replaces ops/hpss_pallas.py::_hpss_mel_kernel, launched by
// _hpss_mel_pallas behind hpss_mel: the same medians and masks, then
// M @ (S*mask_h) and M @ (S*mask_p) for an (n_mels, F) mel basis M, written
// as two (B, n_mels, T) maps.  The front end takes it for clips shorter than
// 2*(l_harm//2) frames (ops/frontend.py), so on its path B = 1, T = 1..19.
//
// Shared by both: the unit of work.  A thread takes QF = 2 bins x QT = 4
// frames.  Along time its four harmonic windows share a core of l_harm - 3
// frames, along frequency its two percussive windows one of l_perc - 1
// bins, and median.cuh's shared-core networks select from those: per output
// 28.25 + 16.5 = 44.75 comparators at (21, 11) instead of the 91 + 32 of
// one network per window.  The masks take two reciprocals instead of four
// divisions (soft_masks_rcp).  Each block reads its window of S into shared
// memory once (load_window): the symmetric index maps are built once, each
// lane's columns in registers and each row once, so no inner loop computes
// an index rule, and a warp starts the loads of several rows before their
// stores.  A fork that read interior K3 tiles without the maps, as float2,
// measured no faster at 1 x 201 x 5998 (0.01321 ms against 0.01335 without
// it, on an H100; tools/hpss_ab.py) and is gone.  Harmonic rows are read
// from shared memory as float4 (conflict-free along a warp), percussive
// columns as float2; K3 stores float2 pairs where T is even (0.01648 ms
// with scalar stores, variant scalar_stores).
//
// What bounds K3 on an H100: bytes.  Per bin it reads 4 bytes and writes 8,
// against 2 * 44.75 min/max and ~10 mask operations: ~100 operations per 12
// bytes, under the f32 ridge (~20 per byte at 67 TFLOP/s and 3.35 TB/s).
// Blocks of 256 threads, two regimes:
//   - Long clips (T > 32; resynthesis: 1 x 201 x 5998): tiles of up to 32
//     bin pairs and as many frames as fill the card's block slots
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs, read
//     once per device) in whole waves, at least 32 frames; a warp loads 8
//     rows at once.  Bin rows are balanced: 201 bins make 4 rows of 26 pairs
//     (the last 23), not 6 full rows of 32 bins and one of 9.  With 80
//     registers the H100 holds 3 blocks per SM, and 5998 frames make 4 x 94
//     tiles of 52 bins x 64 frames (376 blocks, one wave of 396 slots),
//     reading 62 x 84 values per 52 x 64 outputs (1.56x).
//   - Short clips (T <= 32; Jang evaluation: 1 x 257 x T, T < 20): one time
//     tile of the real frame groups and at most 11 bin pairs, so that its
//     32 rows are one batch of 4 rows a warp; one unit per thread.  At
//     257 x 13: 12 blocks of 11 pairs x 4 frame groups.
// Shared memory: (2*pairs + 2*HP) x stride floats, at most 43.8 KB (32
// pairs x 32 groups) at (21, 11); the tuner's wide medians take up to
// 67.5 KB ((21, 51)), so the occupancy query opts in above 48 KB.
//
// What bounds K4: launch latency on its path, and bytes beyond it.  Per
// frame it reads F magnitudes and writes 2*n_mels floats, and reads the
// basis's nonzeros, against K3's operations per bin and two FMAs per nonzero
// of the basis.  At T = 13 that is under a million operations, far less than
// one launch costs, so the design spreads the launch and cuts its serial
// path:
//   - Grid (group of K4_BANDS = 8 mel bands, time tile of 32 frames, batch
//     item): 15 blocks at 120 bands, T <= 32.
//   - A block reads its bands' nonzero ranges [lo, hi) (ops/mel.py::
//     mel_band_ranges, the ranges K1 takes) and computes medians and masks
//     only for the bins of their union, its span, plus l_perc//2 halo rows.
//     Shared memory grows with the span's chunk, not with F: the span is
//     taken K4_CHUNK = 64 bins at a time, each band summing the chunk's part
//     of its range in order, so any F works.  With the sr=22050 bank at
//     n_fft 400 (F = 201) the 15 spans take 223 bin rows for the 199 bins
//     any band reads: 24 bins (12%) are computed twice (27 of 255 at n_fft
//     512); the widest span is 45 bins (57 at n_fft 512), one pass.
//   - Units over the span's real bin pairs and frame groups only; at
//     T = 13 the widest block runs 92 units, one per thread.
//   - Epilogue: thread = (band, frame), 8 bands x 32 frames; the sum runs
//     over the band's nonzero bins only, as K1's does, reading the masked
//     tiles from shared memory (conflict-free along frames) and the basis
//     through __ldg (one address per warp).  An empty band writes exact
//     zeros.
// Shared memory: a 74 x 52 tile and two 64 x 32 masked tiles, 31.8 KB
// static at l_harm 21; no attribute calls at launch.  Registers are capped
// for 3 blocks per SM (80): a warp loads 4 rows at once, since 8 took 116
// registers and 2 blocks per SM, 0.051 ms at 1 x 201 x 5998 against 0.038
// (tools/hpss_ab.py, variant k4_rows8).

// The tuner's median pairs (l_harm up to 51, l_perc up to 51) take the same
// design: wider shared cores (89.5 comparators per harmonic output at 51,
// 167 per percussive one), percussive columns read one frame at a time
// above l_perc 11 (unit_masks), and K3 tiles above 48 KB of shared memory.
//
// Any other odd pair of widths 3 to 61 (median.cuh's generated networks):
// a harmonic median narrower than 7 frames has no shared core of QT = 4
// windows and takes Median<l_harm> per frame (running_medians), and K4
// takes its span in chunks of 32 or 16 bins where 64 would pass 48 KB of
// static shared memory (k4_chunk; 32 at (61, 61)).
//
// The mask power is an argument of the entry points: 2 launches the
// instances above (POW false, the squares), any other power their POW
// twins, which raise through powf (median.cuh's soft_masks_rcp_pow).  The
// masks are much of these short kernels' work, so powf stays out of the
// squares' instances and their registers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -DHPSS_LH=51 -DHPSS_LP=11 -o libhpss.so hpss.cu
// C interface, loaded with ctypes by sm_hpss_mtl_tpu_torch/ops/hpss.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "median.cuh"

namespace {

constexpr int QF = 2;             // bins per unit (percussive outputs)
constexpr int QT = 4;             // frames per unit (harmonic outputs)
constexpr int THREADS = 256;      // threads of a K3 or K4 block
constexpr int SHORT_GROUPS = 8;   // frame groups up to which K3 is short
constexpr int SHORT_PAIRS = 11;   // most bin pairs of a short K3 tile
constexpr int K3_PAIRS = 32;      // most bin pairs of a K3 tile
constexpr int K3_GROUPS = 32;     // most frame groups of a K3 tile
constexpr int K3_UNITS = 4;       // units per thread a long K3 tile aims at
constexpr int K3_ROWS = 8;        // rows a warp loads at once, K3
constexpr int SHORT_ROWS = 4;     // the same for a tile of <= 4 rows a warp
constexpr int K4_ROWS = 4;        // rows a warp loads at once, K4
constexpr int K4_MIN_BLOCKS = 3;  // K4 blocks an SM must hold (registers)
constexpr int K4_BANDS = 8;       // mel bands per K4 block
constexpr int K4_TT = 32;         // frames per K4 time tile
constexpr int K4_CHUNK = 64;      // bins of a K4 span per pass
constexpr int MAX_DEVICES = 64;
// Percussive rows a unit reads for all QT frames at once; wider windows
// are read one frame at a time (unit_masks).
constexpr int PERC_ROWS_AT_ONCE = 12;

static_assert(QT == 4, "unit_masks reads four frames per row");
static_assert(K4_BANDS * K4_TT == THREADS, "K4: one (band, frame) a thread");
static_assert((K4_CHUNK / QF) * (K4_TT / QT) <= THREADS,
              "K4: one unit a thread per chunk");

using hpss_median::running_medians;
using hpss_median::soft_masks_rcp;
using hpss_median::soft_masks_rcp_pow;
using hpss_median::sym;
using hpss_median::sym1;

// Row stride of a tile of `frames` frames (a multiple of QT) and its halos:
// a multiple of 4, wide enough for the last unit's float4 harmonic reads.
template <int LH>
__host__ __device__ constexpr int tile_stride(int frames) {
  return (frames + 2 * (LH / 2) + 3) & ~3;
}

// Copies rows r0 .. r0+R-1 x columns c0 .. c0+WD-1 of the (F, T) slab Sb,
// both mapped through the symmetric rule, into tile[R][W].  The index maps
// are built once: each lane maps its CPL columns into registers, each row
// is mapped once, with sym1 where the range lies within one period.  A warp
// takes rows warp, warp + warps, ..., ROWS of them at a time, and starts
// all their loads before its stores (the tile and the slab never alias, so
// ROWS x CPL loads are in flight per lane).  Past the last row the loads
// repeat it and are not stored: predicating them instead took K3 from 80 to
// 107 registers on an H100 (chip_smoke.py's ptxas report).
template <int CPL, int ROWS>
__device__ __forceinline__ void load_window(float* tile, int W,
                                            const float* __restrict__ Sb,
                                            int F, int T, int r0, int R,
                                            int c0, int WD) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const bool rows1 = r0 >= -F && r0 + R <= 2 * F;
  const bool cols1 = c0 >= -T && c0 + WD <= 2 * T;
  int col[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = min(lane + 32 * k, WD - 1);
    col[k] = cols1 ? sym1(c0 + j, T) : sym(c0 + j, T);
  }
  for (int i0 = warp; i0 < R; i0 += ROWS * warps) {
    float v[ROWS][CPL];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = min(i0 + r * warps, R - 1);
      const float* row = Sb + (size_t)(rows1 ? sym1(r0 + i, F)
                                             : sym(r0 + i, F)) * T;
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        if (lane + 32 * k < WD) v[r][k] = __ldg(row + col[k]);
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int i = i0 + r * warps;
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        if (i < R && lane + 32 * k < WD) tile[i * W + lane + 32 * k] = v[r][k];
    }
  }
}

// Medians and masks of one unit, QF bins x QT frames.  Tile row r holds the
// unit's first bin (rows r-HP .. r+QF-1+HP exist); column c, a multiple of
// 4, starts its first harmonic window, so its frames sit at columns c+HT ..
// c+HT+QT-1.  W is the tile's row stride.  Also returns the unit's
// magnitudes.
template <int LH, int LP, bool POW>
__device__ __forceinline__ void unit_masks(const float* tile, int W, int r,
                                           int c, float power,
                                           float (&mh)[QF][QT],
                                           float (&mp)[QF][QT],
                                           float (&s)[QF][QT]) {
  constexpr int HT = LH / 2;
  constexpr int HP = LP / 2;
  constexpr int NX = (LH + QT - 1 + 3) / 4;  // float4 reads per window row
  constexpr int NY = LP + QF - 1;            // rows of the percussive windows
  float harm[QF][QT];
#pragma unroll
  for (int q = 0; q < QF; ++q) {
    float x[4 * NX];
    const float4* row =
        reinterpret_cast<const float4*>(tile + (r + q) * W + c);
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const float4 a = row[j];
      x[4 * j] = a.x;
      x[4 * j + 1] = a.y;
      x[4 * j + 2] = a.z;
      x[4 * j + 3] = a.w;
    }
    running_medians<LH, QT>(x, harm[q]);
#pragma unroll
    for (int t = 0; t < QT; ++t) s[q][t] = x[HT + t];
  }
  float y[QT][NY];
  if constexpr (NY <= PERC_ROWS_AT_ONCE) {
#pragma unroll
    for (int i = 0; i < NY; ++i) {
      const float* p = tile + (r - HP + i) * W + c + HT;
      if constexpr (HT % 2 == 0) {
        const float2 a = reinterpret_cast<const float2*>(p)[0];
        const float2 b = reinterpret_cast<const float2*>(p)[1];
        y[0][i] = a.x;
        y[1][i] = a.y;
        y[2][i] = b.x;
        y[3][i] = b.y;
      } else {
#pragma unroll
        for (int t = 0; t < QT; ++t) y[t][i] = p[t];
      }
    }
  }
#pragma unroll
  for (int t = 0; t < QT; ++t) {
    float perc[QF];
    if constexpr (NY > PERC_ROWS_AT_ONCE) {
      // Wide percussive windows (l_perc 21 to 51): one frame's column at a
      // time, so that NY registers hold it rather than QT * NY.
#pragma unroll
      for (int i = 0; i < NY; ++i)
        y[t][i] = tile[(r - HP + i) * W + c + HT + t];
    }
    running_medians<LP, QF>(y[t], perc);
#pragma unroll
    for (int q = 0; q < QF; ++q) {
      if constexpr (POW) {
        soft_masks_rcp_pow(harm[q][t], perc[q], power, &mh[q][t], &mp[q][t]);
        continue;
      }
      soft_masks_rcp(harm[q][t], perc[q], &mh[q][t], &mp[q][t]);
    }
  }
}

// ---- K3 -------------------------------------------------------------------

template <int LP>
__host__ __device__ constexpr int k3_rows(int pairs) {
  return QF * pairs + 2 * (LP / 2);
}

// Shared memory of a K3 tile: the window, [rows][stride] floats.
template <int LH, int LP>
size_t k3_smem_bytes(int pairs, int groups) {
  return sizeof(float) * (size_t)k3_rows<LP>(pairs) *
         tile_stride<LH>(QT * groups);
}

template <int LH, int LP, bool MASK_ONLY, bool POW>
__global__ void __launch_bounds__(THREADS)
hpss_kernel(const float* __restrict__ S, float* __restrict__ out_h,
            float* __restrict__ out_p, int F, int T, int pairs, int groups,
            float power) {
  constexpr int HT = LH / 2;
  constexpr int HP = LP / 2;
  extern __shared__ float4 smem4[];
  const int FB = QF * pairs, TB = QT * groups;
  const int R = k3_rows<LP>(pairs);
  const int WD = TB + 2 * HT;  // columns read
  const int W = tile_stride<LH>(TB);
  float* tile = reinterpret_cast<float*>(smem4);  // [R][W]

  const int f0 = blockIdx.y * FB;
  const int t0 = blockIdx.x * TB;
  const size_t base = (size_t)blockIdx.z * F * T;
  const float* Sb = S + base;

  constexpr int MAX_WD = QT * K3_GROUPS + 2 * HT;
  if (R <= SHORT_ROWS * (THREADS / 32)) {
    // One batch of SHORT_ROWS rows a warp covers the tile (short clips).
    load_window<(MAX_WD + 31) / 32, SHORT_ROWS>(tile, W, Sb, F, T, f0 - HP,
                                                R, t0 - HT, WD);
  } else {
    load_window<(MAX_WD + 31) / 32, K3_ROWS>(tile, W, Sb, F, T, f0 - HP, R,
                                             t0 - HT, WD);
  }
  __syncthreads();

  const bool pair_stores =
      (T & 1) == 0 && (((uintptr_t)out_h | (uintptr_t)out_p) & 7) == 0;
  const int units = pairs * groups;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int p = u / groups;
    const int g = u - p * groups;
    const int f = f0 + QF * p, t = t0 + QT * g;
    if (f >= F || t >= T) continue;
    float mh[QF][QT], mp[QF][QT], s[QF][QT];
    unit_masks<LH, LP, POW>(tile, W, QF * p + HP, QT * g, power, mh, mp, s);
#pragma unroll
    for (int q = 0; q < QF; ++q) {
      if (f + q >= F) break;
      float vh[QT], vp[QT];
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        vh[j] = MASK_ONLY ? mh[q][j] : s[q][j] * mh[q][j];
        vp[j] = MASK_ONLY ? mp[q][j] : s[q][j] * mp[q][j];
      }
      const size_t o = base + (size_t)(f + q) * T + t;
      if (pair_stores && t + QT <= T) {
        float2* h2 = reinterpret_cast<float2*>(out_h + o);
        float2* p2 = reinterpret_cast<float2*>(out_p + o);
        h2[0] = make_float2(vh[0], vh[1]);
        h2[1] = make_float2(vh[2], vh[3]);
        p2[0] = make_float2(vp[0], vp[1]);
        p2[1] = make_float2(vp[2], vp[3]);
      } else {
#pragma unroll
        for (int j = 0; j < QT; ++j)
          if (t + j < T) {
            out_h[o + j] = vh[j];
            out_p[o + j] = vp[j];
          }
      }
    }
  }
}

// The card's SMs and the blocks of a kernel one SM holds, read once per
// device.
struct Occupancy {
  int sms = 0;
  int blocks = 0;
};

template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, size_t smem,
                      Occupancy* cache, Occupancy* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && cache[dev].blocks > 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  Occupancy o;
  // K3's largest tile passes the 48 KB of dynamic shared memory a launch
  // may take without opting in at the wide medians ((41, 11): 49.7 KB,
  // (21, 51): 67.5 KB); the attribute is per device, as is this cache.
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.blocks, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  if (o.blocks < 1) return cudaErrorInvalidConfiguration;
  if (dev < MAX_DEVICES) cache[dev] = o;
  *out = o;
  return cudaSuccess;
}

template <int LH, int LP, bool MASK_ONLY, bool POW>
cudaError_t k3_occupancy(Occupancy* out) {
  static Occupancy cache[MAX_DEVICES];
  return occupancy(hpss_kernel<LH, LP, MASK_ONLY, POW>, THREADS,
                   k3_smem_bytes<LH, LP>(K3_PAIRS, K3_GROUPS), cache, out);
}

struct K3Plan {
  int pairs, groups, rows, cols;
  size_t smem;
};

// Tiles of a K3 launch (see the header): bin rows balanced, and for long
// clips as many time tiles as fill the block slots in whole waves.
template <int LH, int LP>
K3Plan k3_plan(int B, int F, int T, const Occupancy& occ) {
  const int P = (F + QF - 1) / QF, G = (T + QT - 1) / QT;
  const bool short_clip = G <= SHORT_GROUPS;
  K3Plan p;
  p.groups = G < K3_GROUPS ? G : K3_GROUPS;
  const int most = short_clip ? SHORT_PAIRS : K3_PAIRS;
  int cap = (short_clip ? THREADS : K3_UNITS * THREADS) / p.groups;
  cap = cap < 1 ? 1 : (cap > most ? most : cap);
  p.rows = (P + cap - 1) / cap;
  p.pairs = (P + p.rows - 1) / p.rows;
  p.cols = (G + p.groups - 1) / p.groups;
  if (!short_clip) {
    const long long slots = (long long)occ.sms * occ.blocks;
    const long long rb = (long long)p.rows * B;
    const long long waves = (rb * p.cols + slots - 1) / slots;
    long long cols = waves * slots / rb;
    if (cols < p.cols) cols = p.cols;
    long long groups = (G + cols - 1) / cols;
    if (groups < SHORT_GROUPS) groups = SHORT_GROUPS;
    p.groups = (int)(groups < p.groups ? groups : p.groups);
    p.cols = (G + p.groups - 1) / p.groups;
  }
  p.smem = k3_smem_bytes<LH, LP>(p.pairs, p.groups);
  return p;
}

template <int LH, int LP, bool MASK_ONLY, bool POW>
cudaError_t launch_k3(const float* S, float* out_h, float* out_p, int B,
                      int F, int T, float power, cudaStream_t stream) {
  Occupancy occ;
  const cudaError_t e = k3_occupancy<LH, LP, MASK_ONLY, POW>(&occ);
  if (e != cudaSuccess) return e;
  const K3Plan p = k3_plan<LH, LP>(B, F, T, occ);
  const dim3 grid(p.cols, p.rows, B);
  hpss_kernel<LH, LP, MASK_ONLY, POW><<<grid, THREADS, p.smem, stream>>>(
      S, out_h, out_p, F, T, p.pairs, p.groups, power);
  return cudaGetLastError();
}

// K3 at `power`: the squares' instance at 2, the powf one otherwise.
template <int LH, int LP>
cudaError_t launch(const float* S, float* out_h, float* out_p, int B, int F,
                   int T, bool mask_only, float power, cudaStream_t stream) {
  if (power == 2.f)
    return mask_only
               ? launch_k3<LH, LP, true, false>(S, out_h, out_p, B, F, T,
                                                power, stream)
               : launch_k3<LH, LP, false, false>(S, out_h, out_p, B, F, T,
                                                 power, stream);
  return mask_only ? launch_k3<LH, LP, true, true>(S, out_h, out_p, B, F, T,
                                                   power, stream)
                   : launch_k3<LH, LP, false, true>(S, out_h, out_p, B, F,
                                                    T, power, stream);
}

// ---- K4 -------------------------------------------------------------------

// Bins of a K4 pass: K4_CHUNK, or half or a quarter of it where the tiles
// would pass the 48 KB of static shared memory (wide pairs: (61, 61) takes
// 32).  Every pair of KERNEL_MEDIANS takes K4_CHUNK.
template <int LH, int LP>
__host__ __device__ constexpr int k4_chunk() {
  for (int c = K4_CHUNK; c > 16; c /= 2)
    if (4 * ((c + 2 * (LP / 2)) * tile_stride<LH>(K4_TT) + 2 * c * K4_TT) <=
        48 * 1024)
      return c;
  return 16;
}

template <int LH, int LP, bool POW>
__global__ void __launch_bounds__(THREADS, K4_MIN_BLOCKS)
hpss_mel_kernel(const float* __restrict__ S, const float* __restrict__ mel,
                const int2* __restrict__ bands, float* __restrict__ out_h,
                float* __restrict__ out_p, int F, int T, int n_mels,
                float power) {
  constexpr int HT = LH / 2;
  constexpr int HP = LP / 2;
  constexpr int CHUNK = k4_chunk<LH, LP>();
  constexpr int R = CHUNK + 2 * HP;        // tile rows
  constexpr int W = tile_stride<LH>(K4_TT);
  __shared__ __align__(16) float tile[R * W];
  __shared__ __align__(16) float hs[CHUNK * K4_TT];  // [bin][frame]
  __shared__ __align__(16) float ps[CHUNK * K4_TT];

  const int m0 = blockIdx.x * K4_BANDS;
  const int t0 = blockIdx.y * K4_TT;
  const int b = blockIdx.z;
  const float* Sb = S + (size_t)b * F * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // The group's span: the union of its bands' nonzero bins.
  int glo = F, ghi = 0;
#pragma unroll
  for (int j = 0; j < K4_BANDS; ++j) {
    if (m0 + j >= n_mels) break;
    const int2 r = __ldg(bands + m0 + j);
    if (r.y > r.x) {
      glo = min(glo, r.x);
      ghi = max(ghi, r.y);
    }
  }
  // This thread's output: band m, frame t.
  const int m = m0 + warp;
  const int t = t0 + lane;
  const int2 band = m < n_mels ? __ldg(bands + m) : make_int2(0, 0);
  const float* wrow = mel + (size_t)(m < n_mels ? m : 0) * F;
  float ah = 0.f, ap = 0.f;

  const int ng = (min(K4_TT, T - t0) + QT - 1) / QT;  // real frame groups
  const int wd = QT * ng + 2 * HT;                     // columns read
  for (int c0 = glo; c0 < ghi; c0 += CHUNK) {
    const int nb = min(CHUNK, ghi - c0);  // bins of this pass
    const int np = (nb + QF - 1) / QF;
    if (c0 > glo) __syncthreads();  // the last pass's epilogue read hs, ps
    load_window<(K4_TT + 2 * HT + 31) / 32, K4_ROWS>(
        tile, W, Sb, F, T, c0 - HP, QF * np + 2 * HP, t0 - HT, wd);
    __syncthreads();
    for (int u = threadIdx.x; u < np * ng; u += THREADS) {
      const int p = u / ng;
      const int g = u - p * ng;
      float mh[QF][QT], mp[QF][QT], s[QF][QT];
      unit_masks<LH, LP, POW>(tile, W, QF * p + HP, QT * g, power, mh, mp,
                              s);
#pragma unroll
      for (int q = 0; q < QF; ++q) {
        const int o = (QF * p + q) * K4_TT + QT * g;
        *reinterpret_cast<float4*>(hs + o) =
            make_float4(s[q][0] * mh[q][0], s[q][1] * mh[q][1],
                        s[q][2] * mh[q][2], s[q][3] * mh[q][3]);
        *reinterpret_cast<float4*>(ps + o) =
            make_float4(s[q][0] * mp[q][0], s[q][1] * mp[q][1],
                        s[q][2] * mp[q][2], s[q][3] * mp[q][3]);
      }
    }
    __syncthreads();
    // This pass's part of the band's sum, in bin order.
    const int klo = max(band.x, c0), khi = min(band.y, c0 + nb);
    for (int k = klo; k < khi; ++k) {
      const float wk = __ldg(wrow + k);
      ah = fmaf(wk, hs[(k - c0) * K4_TT + lane], ah);
      ap = fmaf(wk, ps[(k - c0) * K4_TT + lane], ap);
    }
  }
  if (m < n_mels && t < T) {
    const size_t o = ((size_t)b * n_mels + m) * T + t;
    out_h[o] = ah;
    out_p[o] = ap;
  }
}

template <int LH, int LP>
cudaError_t launch_mel(const float* S, const float* mel, const int2* bands,
                       float* out_h, float* out_p, int B, int F, int T,
                       int n_mels, float power, cudaStream_t stream) {
  const dim3 grid((n_mels + K4_BANDS - 1) / K4_BANDS, (T + K4_TT - 1) / K4_TT,
                  B);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (power == 2.f)
    hpss_mel_kernel<LH, LP, false><<<grid, THREADS, 0, stream>>>(
        S, mel, bands, out_h, out_p, F, T, n_mels, power);
  else
    hpss_mel_kernel<LH, LP, true><<<grid, THREADS, 0, stream>>>(
        S, mel, bands, out_h, out_p, F, T, n_mels, power);
  return cudaGetLastError();
}

template <int LH, int LP>
int k4_blocks(void) {
  static Occupancy cache[MAX_DEVICES];
  Occupancy o;
  const cudaError_t e =
      occupancy(hpss_mel_kernel<LH, LP, false>, THREADS, 0, cache, &o);
  return e == cudaSuccess ? o.blocks : -(int)e;
}

template <int LH, int LP>
int k3_blocks(void) {
  Occupancy o;
  const cudaError_t e = k3_occupancy<LH, LP, true, false>(&o);
  return e == cudaSuccess ? o.blocks : -(int)e;
}

}  // namespace

extern "C" {

// Launches K3 on `stream`.  S: (B, F, T) f32 magnitudes; out_h, out_p:
// (B, F, T) f32, the masked components or (mask_only != 0) the masks, the
// masks raised to `power` (2 squares).
// Returns a cudaError_t; cudaErrorInvalidValue for a (l_harm, l_perc) pair
// this library was not built for (HPSS_FOR_EACH_PAIR) or a grid too large.
// Does not synchronise.
int k3_hpss(const void* S, void* out_h, void* out_p, int B, int F, int T,
            int l_harm, int l_perc, int mask_only, float power,
            void* stream) {
  const float* s = static_cast<const float*>(S);
  float* oh = static_cast<float*>(out_h);
  float* op = static_cast<float*>(out_p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || F < 1 || T < 1) return (int)cudaErrorInvalidValue;
#define HPSS_LAUNCH(LH, LP)          \
  if (l_harm == LH && l_perc == LP) \
    return launch<LH, LP>(s, oh, op, B, F, T, mask_only != 0, power, st);
  HPSS_FOR_EACH_PAIR(HPSS_LAUNCH)
#undef HPSS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Launches K4 on `stream`.  S: (B, F, T) f32 magnitudes; mel: (n_mels, F)
// f32; bands: (n_mels, 2) int32, each band's nonzero bins [lo, hi) ([0, 0)
// for an empty band); out_h, out_p: (B, n_mels, T) f32, the mel projections
// of the masked components (masks as for k3_hpss).  Returns a cudaError_t;
// cudaErrorInvalidValue for a (l_harm, l_perc) pair this library was not
// built for or a grid too large.  Does not synchronise.
int k4_hpss_mel(const void* S, const void* mel, const void* bands,
                void* out_h, void* out_p, int B, int F, int T, int l_harm,
                int l_perc, int n_mels, float power, void* stream) {
  const float* s = static_cast<const float*>(S);
  const float* m = static_cast<const float*>(mel);
  const int2* r = static_cast<const int2*>(bands);
  float* oh = static_cast<float*>(out_h);
  float* op = static_cast<float*>(out_p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || F < 1 || T < 1 || n_mels < 1)
    return (int)cudaErrorInvalidValue;
#define HPSS_LAUNCH(LH, LP)          \
  if (l_harm == LH && l_perc == LP) \
    return launch_mel<LH, LP>(s, m, r, oh, op, B, F, T, n_mels, power, st);
  HPSS_FOR_EACH_PAIR(HPSS_LAUNCH)
#undef HPSS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Blocks of K3 (its mask-only kernel at its largest tile) that one SM of
// the current device holds at once, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative cudaError_t on
// failure.
int k3_blocks_per_sm(int l_harm, int l_perc) {
#define HPSS_BLOCKS(LH, LP) \
  if (l_harm == LH && l_perc == LP) return k3_blocks<LH, LP>();
  HPSS_FOR_EACH_PAIR(HPSS_BLOCKS)
#undef HPSS_BLOCKS
  return -(int)cudaErrorInvalidValue;
}

// The same for K4.
int k4_blocks_per_sm(int l_harm, int l_perc) {
#define HPSS_BLOCKS(LH, LP) \
  if (l_harm == LH && l_perc == LP) return k4_blocks<LH, LP>();
  HPSS_FOR_EACH_PAIR(HPSS_BLOCKS)
#undef HPSS_BLOCKS
  return -(int)cudaErrorInvalidValue;
}

const char* k3_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
