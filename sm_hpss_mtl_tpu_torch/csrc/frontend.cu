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
// (any power; split_zeros=False), then
//   K1: the mel projections of S*mask_h and S*mask_p, two (B, n_mels, T) maps;
//   K2: S*mask_h and S*mask_p themselves, two (B, F, T) maps.
// One template, frontend_kernel<LH, LP, FULLRES>; FULLRES selects the
// epilogue and nothing else, so K1's arithmetic is K2's up to the masks.
//
// What bounds them on an H100.  The function needs ~63k f32 operations per
// output frame at n_fft 400 (an FFT's ~8.6k, the median comparators ~49k,
// magnitudes, masks and the sparse mel ~4.5k) against 1,600 bytes of audio
// in and features out: operations, on the CUDA cores.  The kernel computes
// the DFT as a direct product instead of an FFT, which costs more operations
// than the medians, so the design puts that product on the tensor cores:
//   - The DFT is a product per block: 64 frame rows by the windowed rDFT
//     basis, by mma.sync.m16n8k8 with TF32 operands in split TF32 (3xTF32):
//     each operand is hi + lo with hi = tf32(x) and lo = tf32(x - hi), and
//     the product is lo*hi + hi*lo + hi*hi (lo*lo dropped), close to f32
//     accuracy (the JAX bf16x3 decomposition with 11-bit halves).  The
//     tensor core sums one k-step's products from zero; the running sums
//     are f32 registers, added to on the CUDA cores with rounding to
//     nearest, since the tensor core's accumulation truncates (a running
//     sum kept there put K2's features 0.03 dB off the plain path at
//     deep-cancellation bins).  The A operand is split in registers as its
//     fragments are loaded; the basis's halves come precomputed from the
//     wrapper in the order the B fragments read them (one coalesced 16-byte
//     load per lane per k-step and tile), read from L2 by every block.  No
//     twiddle table is read.
//   - The window is symmetric about n_fft/2, so each frame is folded into
//     its even part e_n = x_n + x_{N-n} and odd part o_n = x_n - x_{N-n},
//     n in [0, N/2]: e meets the cos columns and o the -sin columns, half
//     the products of the plain sum (26 k-steps of 8 at n_fft 400 and 512;
//     the zero k-steps of a padded window are skipped).  A group of 8 bins
//     is a cos tile and a sin tile of one warp, so accumulator e of the two
//     tiles holds the real and imaginary part of one bin and the magnitude
//     is taken in registers.
//   - The audio is staged once per block with cp.async as rows of `hop`
//     samples (the JAX superblocks): frame r, sample n sits at row
//     r + n / hop, column n % hop, and a k-step of 8 never crosses a row.
//     The row pitch is hop rounded up to 32 plus 4 floats, so the eight
//     rows of an A fragment fall on eight bank quads (conflict-free).
//     43-44 KB, where the previous design expanded 56 windowed frames into
//     90-115 KB.
//   - One block per (tile of 64 - 2*(l_harm/2) output frames, batch item):
//     44 frames at l_harm 21 for 64 DFT rows, a halo factor of 1.45 (the
//     tuner's l_harm 51: 14 frames, 4.6; each pair is its own library,
//     median.cuh's HPSS_FOR_EACH_PAIR, timed per pair by chip_smoke.py).  The
//     block computes the DFT of the real frames of its range only; frames
//     outside [0, T) are read back through the symmetric rule from the
//     magnitude rows (as the JAX kernel's edge fix copies rows), so edge
//     tiles do less work and every T >= 1 works.
//   - Halo mode (the time-sharded front end, parallel/frontend_shard.py; the
//     JAX kernel's halo_in_audio and edge_flags): the audio carries
//     HT = l_harm/2 frames of a neighbour's audio before frame 0 and after
//     frame T-1, and each side has a flag.  At a side whose flag is 0 those
//     frames are real: the real range grows to [-HT, T + HT) there and the
//     medians read them as they are.  At a side whose flag is 1 the audio
//     there is ignored and the symmetric rule applies, as for a whole
//     signal.  Nothing else changes: the flags move the bounds lo and hi of
//     the real range, and the audio is staged HT*hop samples later.
//   - Shared memory is the audio rows plus the magnitudes (64 x F floats),
//     95 KB at n_fft 400 and 110 KB at 512, so two blocks (16 warps) run
//     per SM; registers are capped at 128 by __launch_bounds__ for that.
//   - Medians run in registers through the pruned Batcher networks of
//     median.cuh; the symmetric rule is applied only in edge tiles and edge
//     bins.
//   - K1: the masked tiles overwrite the audio rows in chunks of frames; the
//     mel projection sums each band over its nonzero bins only (the ranges
//     come from the wrapper), in ascending order, which equals the dense
//     sum bit for bit.
//   - K2: the masked magnitudes go straight from registers to global memory;
//     consecutive lanes take consecutive frames of one bin, so each store of
//     a warp is a contiguous run of a (B, F, T) row.
//
//
// Modes:
//   - HPSS_BF16X3 (ops/_nvcc.py builds one library per pair and DFT
//     precision): the DFT in bf16x3, the JAX package's default
//     dft_precision (frontend_pallas.py::_tile_masks): the folded e_n and
//     o_n are rounded in registers to bf16 hi = bf16(x) and lo = bf16(x -
//     hi) (cvt.rn.bf16x2.f32, round to nearest even), the basis comes in
//     bf16 halves of the same float64 basis, and the product is lo*hi +
//     hi*lo + hi*hi with f32 accumulators (lo*lo dropped), as the JAX
//     kernel computes it, but on the folded frame.  mma.sync.m16n8k16 with
//     bf16 operands covers 16 samples an instruction where TF32's m16n8k8
//     covers 8, so the 26 k-steps of 8 at n_fft 400 become 13 of 16 and the
//     tensor-core instructions halve (the k16 fragment of a row is two runs
//     of 8 samples, and a run of 8 never crosses a row of audio, so n_fft
//     and hop stay multiples of 8; a k-step past n_fft/2 meets zero basis
//     rows).  m16n8k8 bf16 would keep TF32's instruction count and buy
//     nothing.  As in split TF32, each k-step's products are summed from
//     zero on the tensor core and added to the f32 sums on the CUDA cores.
//     One DFT loop serves both precisions (Dft<BF16X3>: the k-step, the
//     fragment's gather and split, the mma).
//   - power, a kernel argument: the masks (h/z)^power and (p/z)^power;
//     2 squares (the arithmetic above), any other power goes through powf
//     (median.cuh's soft_masks_pow), a uniform branch in one instance: the
//     masks are a small part of K1's and K2's work (hpss.cu's short
//     kernels instead keep a powf twin of each instance).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -DHPSS_LH=51 -DHPSS_LP=11 [-DHPSS_BF16X3=1]
//        -o libfrontend.so frontend.cu
// C interface, loaded with ctypes by sm_hpss_mtl_tpu_torch/ops/frontend.py.

#include <cuda_runtime.h>

#include <cstdint>

#include "median.cuh"

namespace {

constexpr int ROWS = 64;       // DFT frame rows per block
constexpr int MT = ROWS / 16;  // m16 tiles of those rows
constexpr int GP = 2;          // groups of 8 bins a warp accumulates at once
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

using hpss_median::Median;
using hpss_median::sym;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Floats per row of staged audio: hop rounded up to 32, plus 4.
__host__ __device__ inline int audio_pitch(int hop) {
  return round_up(hop, 32) + 4;
}

// Floats of the staged audio: ROWS + ceil(n_fft / hop) rows (the DFT of
// row r reads rows r .. r + n_fft / hop).
__host__ __device__ inline int audio_floats(int n_fft, int hop) {
  return (ROWS + (n_fft + hop - 1) / hop) * audio_pitch(hop);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a * b for one m16n8k8 tile, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

#ifndef HPSS_BF16X3
#define HPSS_BF16X3 0
#endif
constexpr bool kBf16x3 = HPSS_BF16X3 != 0;

// {bf16(lo_elem) in the low half, bf16(hi_elem) in the high half}, each
// rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo_elem, float hi_elem) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi_elem), "f"(lo_elem));
  return r;
}

// (x0, x1) as bf16x2 halves: hi = bf16(x), lo = bf16(x - hi), element 0 in
// the low half of each register.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t* hi,
                                           uint32_t* lo) {
  *hi = pack_bf16(x0, x1);
  *lo = pack_bf16(x0 - __uint_as_float(*hi << 16),
                  x1 - __uint_as_float(*hi & 0xffff0000u));
}

// d += a * b for one m16n8k16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
               "l"(src));
}

template <int LH>
struct Geometry {
  static constexpr int HT = LH / 2;
  static constexpr int TILE = ROWS - 2 * HT;  // output frames per block
};

// Shared-memory layout, in floats:
//   audio [audio_floats]   staged audio rows; K1 reuses it for the masked
//                          H and P tiles of a chunk of frames ([ch][F] each)
//   mag   [ROWS][F]        magnitudes of frames f_lo .. f_hi-1
__host__ __device__ inline int smem_floats(int n_fft, int hop) {
  return audio_floats(n_fft, hop) + ROWS * (n_fft / 2 + 1);
}

// The two DFT precisions, one per library (HPSS_BF16X3): a k-step is RUNS
// runs of 8 folded samples, and a lane's A fragment holds, per run and
// row, the samples at columns col(tig) and col(tig) + GAP of the run.
// fragment() gathers the fragment of one m16 tile from the staged audio
// (f0: the frame's samples, a0 and b0: the mirrored samples N - n of the
// two columns, per run; o: the tile's row offset), folds it and splits
// each folded value into hi and lo halves; mma() is the tile's product.
template <bool BF16X3>
struct Dft;

// Split TF32 on mma.sync.m16n8k8: one run of 8 per k-step; registers
// (g, tig), (g + 8, tig), (g, tig + 4), (g + 8, tig + 4).
template <>
struct Dft<false> {
  static constexpr int RUNS = 1;
  static constexpr int GAP = 4;
  __device__ static int col(int tig) { return tig; }
  __device__ static void fragment(const float* const* f0,
                                  const float* const* a0,
                                  const float* const* b0, int o, int pitch,
                                  uint32_t* eh, uint32_t* el, uint32_t* oh,
                                  uint32_t* ol) {
    const float x[4] = {f0[0][o], f0[0][o + 8 * pitch], f0[0][o + 4],
                        f0[0][o + 8 * pitch + 4]};
    const float z[4] = {a0[0][o], a0[0][o + 8 * pitch], b0[0][o],
                        b0[0][o + 8 * pitch]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ev = x[i] + z[i], od = x[i] - z[i];
      eh[i] = to_tf32(ev);
      el[i] = to_tf32(ev - __uint_as_float(eh[i]));
      oh[i] = to_tf32(od);
      ol[i] = to_tf32(od - __uint_as_float(oh[i]));
    }
  }
  __device__ static void mma(float* d, const uint32_t* a, const uint32_t* b) {
    mma_tf32(d, a, b);
  }
};

// bf16x3 on mma.sync.m16n8k16: two runs of 8 per k-step; register 2h + r
// packs samples 2*tig and 2*tig + 1 of run h at row g + 8r.  The mirrored
// samples of a pair sit in two different rows of audio when N - n starts
// a run, so each has its own pointer.
template <>
struct Dft<true> {
  static constexpr int RUNS = 2;
  static constexpr int GAP = 1;
  __device__ static int col(int tig) { return 2 * tig; }
  __device__ static void fragment(const float* const* f0,
                                  const float* const* a0,
                                  const float* const* b0, int o, int pitch,
                                  uint32_t* eh, uint32_t* el, uint32_t* oh,
                                  uint32_t* ol) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = o + 8 * r * pitch;
        const float2 x = *reinterpret_cast<const float2*>(f0[h] + q);
        const float z0 = a0[h][q], z1 = b0[h][q];
        split_bf16(x.x + z0, x.y + z1, &eh[2 * h + r], &el[2 * h + r]);
        split_bf16(x.x - z0, x.y - z1, &oh[2 * h + r], &ol[2 * h + r]);
      }
    }
  }
  __device__ static void mma(float* d, const uint32_t* a, const uint32_t* b) {
    mma_bf16(d, a, b);
  }
};

template <int LH, int LP, bool FULLRES>
__global__ void __launch_bounds__(THREADS, 2)
frontend_kernel(const float* __restrict__ y, const float4* __restrict__ basis,
                const float* __restrict__ mel, const int2* __restrict__ bands,
                float* __restrict__ out_h, float* __restrict__ out_p, int N,
                int T, int n_fft, int win_length, int hop, int n_mels,
                int halo, int mirror_l, int mirror_r, float power) {
  constexpr int HT = Geometry<LH>::HT;
  constexpr int HP = LP / 2;
  constexpr int TILE = Geometry<LH>::TILE;
  const int F = n_fft / 2 + 1;
  const int pitch = audio_pitch(hop);
  const int n_audio = audio_floats(n_fft, hop);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  // Frames in [lo, hi) are real (their audio is in y); output frame t
  // starts at sample (t + off) * hop.  Without halo both flags are 1.
  const int off = halo ? HT : 0;
  const int lo = mirror_l ? 0 : -HT;
  const int hi = mirror_r ? T : T + HT;
  // The real frames this tile's medians read: [f_lo, f_hi).
  const int f_lo = max(lo, t0 - HT);
  const int f_hi = min(hi, t0 + TILE + HT);
  const int n_real = f_hi - f_lo;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  extern __shared__ float4 smem4[];
  float* audio = reinterpret_cast<float*>(smem4);
  float* mag = audio + n_audio;

  // Stage the samples of frames f_lo .. f_hi-1 as rows of `hop`; the rows
  // past them are zeroed (read only by DFT rows that are discarded).
  {
    const float* src = y + (size_t)b * N + (size_t)(f_lo + off) * hop;
    const int span = (n_real - 1) * hop + n_fft;
    const int quads = hop / 4;
    const int n_quads = (n_audio / pitch) * quads;
    const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    for (int q = threadIdx.x; q < n_quads; q += THREADS) {
      const int r = q / quads;
      const int c = 4 * (q - r * quads);
      const int s = r * hop + c;
      float* dst = audio + r * pitch + c;
      if (s >= span) {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (aligned) {
        cp_async16(dst, src + s);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) cp_async4(dst + e, src + s + e);
      }
    }
    asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::
                     : "memory");
  }
  __syncthreads();

  // DFT magnitudes on the tensor cores, from each frame's even and odd
  // parts about n_fft/2 (the window is symmetric): for n in [0, n_fft/2],
  // e_n = x_n + x_{N-n} meets the cos columns and o_n = x_n - x_{N-n} the
  // -sin columns, half the products of the plain sum.  Warp w takes the
  // groups of 8 bins w, w + 8, w + 16, ... in passes of GP groups, each
  // group a cos tile and a sin tile, each pass over all k-steps and the
  // m16 tiles that hold real frames.  A k-step is D::RUNS runs of 8
  // samples (Dft above).
  {
    using D = Dft<kBf16x3>;
    constexpr int KS = 8 * D::RUNS;
    const int g = lane >> 2, tig = lane & 3;
    const int col = D::col(tig);
    const int s_lo = (n_fft - win_length) / 2 / KS;
    const int s_hi = ((n_fft / 2 + 8) / 8 + D::RUNS - 1) / D::RUNS;
    const int n_groups = (F + 7) / 8;
    const int n_mt = (n_real + 15) / 16;
    for (int q0 = warp; q0 < n_groups; q0 += WARPS * GP) {
      float acc[MT][2 * GP][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int t = 0; t < 2 * GP; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;
      // Sample KS*s + col of the frame at row (srow, scol + col); samples
      // N - KS*s - col and N - KS*s - col - GAP at (arow, acol) and (brow,
      // bcol); each pointer advances a run of 8 at a time.
      int srow = KS * s_lo / hop, scol = KS * s_lo - srow * hop;
      const int qa = n_fft - KS * s_lo - col, qb = qa - D::GAP;
      int arow = qa / hop, acol = qa - arow * hop;
      int brow = qb / hop, bcol = qb - brow * hop;
      const float4* bs = basis + (size_t)q0 * 64 + lane;
      for (int s = s_lo; s < s_hi; ++s) {
        uint32_t bh[2 * GP][2], bl[2 * GP][2];
#pragma unroll
        for (int t = 0; t < 2 * GP; ++t) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (q0 + (t >> 1) * WARPS < n_groups)
            v = __ldg(bs + ((t >> 1) * WARPS * 2 + (t & 1)) * 32);
          bh[t][0] = __float_as_uint(v.x);
          bh[t][1] = __float_as_uint(v.y);
          bl[t][0] = __float_as_uint(v.z);
          bl[t][1] = __float_as_uint(v.w);
        }
        bs += (size_t)n_groups * 64;
        const float* f0[D::RUNS];
        const float* a0[D::RUNS];
        const float* b0[D::RUNS];
#pragma unroll
        for (int h = 0; h < D::RUNS; ++h) {
          f0[h] = audio + (g + srow) * pitch + scol + col;
          a0[h] = audio + (g + arow) * pitch + acol;
          b0[h] = audio + (g + brow) * pitch + bcol;
          scol += 8;
          if (scol >= hop) {
            scol -= hop;
            ++srow;
          }
          acol -= 8;
          if (acol < 0) {
            acol += hop;
            --arow;
          }
          bcol -= 8;
          if (bcol < 0) {
            bcol += hop;
            --brow;
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt < n_mt) {
            uint32_t eh[4], el[4], oh[4], ol[4];
            D::fragment(f0, a0, b0, mt * 16 * pitch, pitch, eh, el, oh, ol);
            // Each k-step's products are summed from zero on the tensor core
            // and added to the f32 sums on the CUDA cores (round to
            // nearest): the tensor core's own accumulation truncates, which
            // over a whole frame costs deep-cancellation bins their digits.
#pragma unroll
            for (int t = 0; t < 2 * GP; t += 2) {
              if (q0 + (t >> 1) * WARPS < n_groups) {
                float c[4] = {0.f, 0.f, 0.f, 0.f}, d[4] = {0.f, 0.f, 0.f, 0.f};
                D::mma(c, el, bh[t]);
                D::mma(c, eh, bl[t]);
                D::mma(c, eh, bh[t]);
                D::mma(d, ol, bh[t + 1]);
                D::mma(d, oh, bl[t + 1]);
                D::mma(d, oh, bh[t + 1]);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  acc[mt][t][e] += c[e];
                  acc[mt][t + 1][e] += d[e];
                }
              }
            }
          }
        }
      }
      // Accumulator e of the cos tile is the real part, of the sin tile the
      // imaginary part, of bin 8q + 2*tig + (e & 1) at row g + 8*(e >> 1)
      // of the m16 tile.
#pragma unroll
      for (int t = 0; t < 2 * GP; t += 2) {
        const int k0 = 8 * (q0 + (t >> 1) * WARPS) + 2 * tig;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = mt * 16 + g + 8 * (e >> 1), k = k0 + (e & 1);
            const float re = acc[mt][t][e], im = acc[mt][t + 1][e];
            if (row < n_real && k < F)
              mag[row * F + k] = sqrtf(re * re + im * im);
          }
        }
      }
    }
  }
  __syncthreads();

  // Medians and soft masks.  In an interior tile every frame of the medians
  // is real and frame t0 - HT + r sits in row r; edge tiles map frames
  // outside [lo, hi) through the symmetric rule at the mirrored side (one
  // reflection lands in the real range when the other side is real).
  const bool interior = t0 - HT >= lo && t0 + TILE + HT <= hi;
  const bool both = mirror_l && mirror_r;
  auto edge = [&](int f) {
    if (both) return sym(f, T);
    return f < lo ? -1 - f : (f >= hi ? 2 * T - 1 - f : f);
  };
  auto masks = [&](int i, int k, float* sh, float* sp) {
    const int t = t0 + i;
    float v[LH];
    if (interior) {
#pragma unroll
      for (int j = 0; j < LH; ++j) v[j] = mag[(i + j) * F + k];
    } else {
#pragma unroll
      for (int j = 0; j < LH; ++j)
        v[j] = mag[(edge(t - HT + j) - f_lo) * F + k];
    }
    const float harm = Median<LH>::run(v);
    const float* row = mag + (t - f_lo) * F;
    float u[LP];
    if (k >= HP && k < F - HP) {
#pragma unroll
      for (int j = 0; j < LP; ++j) u[j] = row[k + j - HP];
    } else {
#pragma unroll
      for (int j = 0; j < LP; ++j) u[j] = row[sym(k + j - HP, F)];
    }
    const float perc = Median<LP>::run(u);
    const float s = row[k];
    float mh, mp;
    if (power == 2.f)
      hpss_median::soft_masks(harm, perc, &mh, &mp);
    else
      hpss_median::soft_masks_pow(harm, perc, power, &mh, &mp);
    *sh = s * mh;
    *sp = s * mp;
  };

  if constexpr (FULLRES) {
    // Consecutive lanes take consecutive frames of one bin.
    for (int idx = threadIdx.x; idx < TILE * F; idx += THREADS) {
      const int k = idx / TILE;
      const int i = idx - k * TILE;
      if (t0 + i >= T) continue;
      float h, p;
      masks(i, k, &h, &p);
      const size_t o = ((size_t)b * F + k) * T + t0 + i;
      out_h[o] = h;
      out_p[o] = p;
    }
  } else {
    // In chunks of `ch` frames: the masked tiles into the audio rows, then
    // the mel projection of each band over its nonzero bins [lo, hi).
    const int ch = min(TILE, n_audio / (2 * F));
    float* hs = audio;
    float* ps = audio + ch * F;
    for (int c0 = 0; c0 < TILE; c0 += ch) {
      const int nc = min(ch, TILE - c0);
      for (int idx = threadIdx.x; idx < nc * F; idx += THREADS) {
        const int il = idx / F;
        const int k = idx - il * F;
        if (t0 + c0 + il < T) masks(c0 + il, k, hs + idx, ps + idx);
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < nc * n_mels; idx += THREADS) {
        const int m = idx / nc;
        const int il = idx - m * nc;
        const int tt = t0 + c0 + il;
        if (tt >= T) continue;
        const int2 r = __ldg(bands + m);
        const float* w = mel + (size_t)m * F;
        const float* hr = hs + il * F;
        const float* pr = ps + il * F;
        float ah = 0.f, ap = 0.f;
        for (int k = r.x; k < r.y; ++k) {
          const float wk = __ldg(w + k);
          ah = fmaf(wk, hr[k], ah);
          ap = fmaf(wk, pr[k], ap);
        }
        const size_t o = ((size_t)b * n_mels + m) * T + tt;
        out_h[o] = ah;
        out_p[o] = ap;
      }
      __syncthreads();
    }
  }
}

// n_fft and hop multiples of 8 (a k-step never crosses a row of audio), and
// a window centred so that it is symmetric about n_fft/2 (the fold).
bool geometry_ok(int n_fft, int win_length, int hop) {
  return n_fft > 0 && n_fft % 8 == 0 && hop > 0 && hop % 8 == 0 &&
         win_length > 0 && win_length <= n_fft &&
         (n_fft - win_length) % 2 == 0;
}

// The halo switch and the edge flags: without halo both sides mirror, and
// the audio holds the T output frames (and, in halo mode, HT more on each
// side).
bool halo_ok(int N, int T, int n_fft, int hop, int l_harm, int halo,
             int mirror_l, int mirror_r) {
  if (halo != 0 && halo != 1) return false;
  if ((mirror_l != 0 && mirror_l != 1) || (mirror_r != 0 && mirror_r != 1))
    return false;
  if (!halo && !(mirror_l && mirror_r)) return false;
  const long long frames = (long long)T + (halo ? 2 * (l_harm / 2) : 0);
  return T >= 1 && (long long)N >= (frames - 1) * hop + n_fft;
}

template <int LH, int LP, bool FULLRES>
cudaError_t prepare(int n_fft, int hop, size_t* bytes) {
  *bytes = (size_t)smem_floats(n_fft, hop) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      frontend_kernel<LH, LP, FULLRES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(frontend_kernel<LH, LP, FULLRES>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int LH, int LP, bool FULLRES>
cudaError_t launch(const float* y, const float4* basis, const float* mel,
                   const int2* bands, float* out_h, float* out_p, int B, int N,
                   int T, int n_fft, int win_length, int hop, int n_mels,
                   int halo, int mirror_l, int mirror_r, float power,
                   cudaStream_t stream) {
  size_t bytes;
  cudaError_t e = prepare<LH, LP, FULLRES>(n_fft, hop, &bytes);
  if (e != cudaSuccess) return e;
  constexpr int TILE = Geometry<LH>::TILE;
  const dim3 grid((T + TILE - 1) / TILE, B);
  frontend_kernel<LH, LP, FULLRES><<<grid, THREADS, bytes, stream>>>(
      y, basis, mel, bands, out_h, out_p, N, T, n_fft, win_length, hop,
      n_mels, halo, mirror_l, mirror_r, power);
  return cudaGetLastError();
}

template <int LH, int LP, bool FULLRES>
int blocks_per_sm(int n_fft, int hop) {
  size_t bytes;
  cudaError_t e = prepare<LH, LP, FULLRES>(n_fft, hop, &bytes);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, frontend_kernel<LH, LP, FULLRES>, THREADS, bytes);
  return e == cudaSuccess ? n : -(int)e;
}

template <bool FULLRES>
int dispatch(const void* y, const void* basis, const void* mel,
             const void* bands, void* out_h, void* out_p, int B, int N, int T,
             int n_fft, int win_length, int hop, int l_harm, int l_perc,
             int n_mels, int halo, int mirror_l, int mirror_r, float power,
             void* stream) {
  if (!geometry_ok(n_fft, win_length, hop) ||
      !halo_ok(N, T, n_fft, hop, l_harm, halo, mirror_l, mirror_r))
    return (int)cudaErrorInvalidValue;
  const float* yy = static_cast<const float*>(y);
  const float4* bb = static_cast<const float4*>(basis);
  const float* mm = static_cast<const float*>(mel);
  const int2* rr = static_cast<const int2*>(bands);
  float* oh = static_cast<float*>(out_h);
  float* op = static_cast<float*>(out_p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HPSS_LAUNCH(LH, LP)                                                 \
  if (l_harm == LH && l_perc == LP)                                         \
    return launch<LH, LP, FULLRES>(yy, bb, mm, rr, oh, op, B, N, T, n_fft, \
                                   win_length, hop, n_mels, halo, mirror_l, \
                                   mirror_r, power, st);
  HPSS_FOR_EACH_PAIR(HPSS_LAUNCH)
#undef HPSS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches K1 on `stream`.  y: (B, N) f32; basis: the folded, split
// windowed rDFT basis in fragment order, as ops/frontend.py::dft_fragments
// lays it out (the window symmetric about n_fft/2, zero at n = 0);
// mel: (n_mels, n_fft/2+1) f32; bands: (n_mels, 2) int32, each band's
// nonzero bins [lo, hi); out_h, out_p: (B, n_mels, T) f32,
// T = 1 + (N - n_fft) / hop >= 1, or with halo = 1 that less 2*(l_harm/2):
// the audio then carries l_harm/2 frames before frame 0 and after frame
// T-1, real at a side whose flag (mirror_l, mirror_r) is 0, ignored and
// replaced by the symmetric mirror at a side whose flag is 1.  Without halo
// both flags must be 1.  n_fft and hop must be multiples of 8.  The basis
// is in the layout of the library's DFT mode (HPSS_BF16X3 or split TF32);
// the masks are raised to `power` (2 squares).
// Returns a cudaError_t; cudaErrorInvalidValue for a (l_harm, l_perc) pair
// this library was not built for (HPSS_FOR_EACH_PAIR), an unsupported
// geometry or flags, or audio too short for T.  Does not synchronise.
int k1_stft_hpss_mel(const void* y, const void* basis, const void* mel,
                     const void* bands, void* out_h, void* out_p, int B, int N,
                     int T, int n_fft, int win_length, int hop, int l_harm,
                     int l_perc, int n_mels, int halo, int mirror_l,
                     int mirror_r, float power, void* stream) {
  return dispatch<false>(y, basis, mel, bands, out_h, out_p, B, N, T, n_fft,
                         win_length, hop, l_harm, l_perc, n_mels, halo,
                         mirror_l, mirror_r, power, stream);
}

// Launches K2 on `stream`.  y and basis as for k1_stft_hpss_mel; out_h,
// out_p: (B, n_fft/2+1, T) f32.  Returns as k1_stft_hpss_mel does.
int k2_stft_hpss(const void* y, const void* basis, void* out_h, void* out_p,
                 int B, int N, int T, int n_fft, int win_length, int hop,
                 int l_harm, int l_perc, int halo, int mirror_l, int mirror_r,
                 float power, void* stream) {
  return dispatch<true>(y, basis, nullptr, nullptr, out_h, out_p, B, N, T,
                        n_fft, win_length, hop, l_harm, l_perc, 0, halo,
                        mirror_l, mirror_r, power, stream);
}

// Blocks of K2 (fullres != 0) or K1 that one SM holds at once, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; a negative cudaError_t on
// failure.
int k1_blocks_per_sm(int fullres, int n_fft, int hop, int l_harm,
                     int l_perc) {
#define HPSS_BLOCKS(LH, LP)                                  \
  if (l_harm == LH && l_perc == LP)                          \
    return fullres ? blocks_per_sm<LH, LP, true>(n_fft, hop) \
                   : blocks_per_sm<LH, LP, false>(n_fft, hop);
  HPSS_FOR_EACH_PAIR(HPSS_BLOCKS)
#undef HPSS_BLOCKS
  return -(int)cudaErrorInvalidValue;
}

const char* k1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
