// Mamba-2's chunked scan (SSD, "state space duality"; Dao and Gu,
// arXiv:2405.21060) on Hopper, for the Mamba-2 mixers of
// models/granite.py (Granite-4.0-H's trunk).
//
// Replaces no TPU kernel: the JAX package has no state-space model.  No
// PyTorch operation computes this scan, and the rest of the mixer (its
// projections, the causal conv, the gated norm) stays in cuBLAS and
// PyTorch's elementwise kernels.
//
// For each slot b and head h, over the positions t of one model call, from
// the carried state S (P x N) of the slot's head:
//
//   S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t + D x_t
//
// with x_t (P), B_t and C_t (N, shared by the heads: one group), dt_t > 0
// and A < 0 per head.  Computed in the chunked form, chunks of Q = 256
// positions from the call's first (the last may be shorter), with a_t =
// dt_t A and its inclusive cumulative sum c_t inside a chunk:
//
//   y_t  = D x_t + exp(c_t) C_t . S_in                       (state in)
//        + sum_{s <= t} (C_t . B_s) exp(c_t - c_s) dt_s x_s   (inside)
//   S_out = exp(c_last) S_in + sum_s exp(c_last - c_s) dt_s x_s B_s^T
//
// Every exponent is <= 0.  Two kernels, launched by ssd_scan_forward:
//
//   ssd_scan_cb      CB[b, chunk, t, s] = C_t . B_s for s <= t: the heads
//                    share it (one group), so it is formed once per chunk,
//                    64 x 64 tiles on or below the diagonal, 4 x 4 outputs
//                    a thread, the N axis in steps of 16 through shared
//                    memory.
//   ssd_scan_chunks  one block of 256 threads per (head, slot), walking
//                    the chunks in order with the state in shared memory:
//                    (1) the cumulative sum of a_t (a block scan);
//                    (2) y for the chunk's Q x P outputs, 8 x 8 a thread:
//                    C . S_in scaled by exp(c_t), then the masked inner
//                    product over s <= t, both as register-tiled products
//                    from 32-deep tiles in shared memory (a warp whose 32
//                    rows all lie above a tile's first s skips its
//                    products), plus D x_t;
//                    (3) the new state, P x N outputs, 4 x 8 a thread, a
//                    product over the chunk's positions.
//
// What bounds it on an H100: operations.  A position of a head takes
// ~49 k float32 operations (16 k each for the state's read, the state's
// update and, on average, the inner product) against ~0.5 kB of x and y:
// far above the float32 ridge (20 operations a byte).  The products run on
// the FP32 pipes (the model computes in float32, TF32 off); the design
// keeps them in registers (64 or 32 accumulators a thread, operands read
// from shared memory as 16-byte vectors, each read feeding 8 or 16 FMAs)
// and the chunk's tiles in shared memory (76 kB a block, so two blocks a
// SM), and forms C . B once per chunk for all 64 heads.  Four slots of 64
// heads are 256 blocks: one wave on the 132 SMs at two blocks each.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libssd_scan.so ssd_scan.cu
// C interface, loaded with ctypes by sm_hpss_mtl_tpu_torch/ops/ssd_scan.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int P = 64;          // head size
constexpr int N = 128;         // state size
constexpr int Q = 256;         // scan chunk
constexpr int THREADS = 256;
constexpr int KT = 32;         // depth of a product's shared-memory tile
constexpr int QS = Q + 4;      // row of a t-major tile (16-byte aligned)
// Shared memory of ssd_scan_chunks, in floats: the state (N x P, n-major),
// the chunk's c_t and dt_t, and the tiles of one product at a time.
constexpr int TILES = (KT * QS + KT * P) > (KT * P + KT * N)
                          ? (KT * QS + KT * P) : (KT * P + KT * N);
constexpr int SMEM_FLOATS = N * P + 2 * Q + TILES;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;
// ssd_scan_cb's tiles.
constexpr int CB_TILE = 64;
constexpr int CB_K = 16;
constexpr int CB_TILES = Q / CB_TILE;

__device__ __forceinline__ void load8(float* v, const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load4(float* v, const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// CB[b, k, t, s] = sum_n C[b, k Q + t, n] B[b, k Q + s, n] for the tiles on
// or below the diagonal; rows and columns past the chunk's end read 0.
__global__ void __launch_bounds__(THREADS) ssd_scan_cb(
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    float* __restrict__ cb, int L, int64_t ld, int n_chunks) {
  const int ti = blockIdx.x / CB_TILES, si = blockIdx.x % CB_TILES;
  if (si > ti) return;                       // above the diagonal: unread
  const int k = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int l0 = k * Q;
  const int Lc = min(Q, L - l0);
  __shared__ float4 cb_shared[2 * CB_K * CB_TILE / 4];
  float* Cs = reinterpret_cast<float*>(cb_shared);   // [CB_K][CB_TILE]
  float* Bs = Cs + CB_K * CB_TILE;                    // [CB_K][CB_TILE]
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += CB_K) {
    for (int i = tid; i < CB_TILE * CB_K; i += THREADS) {
      const int r = i / CB_K, kk = i % CB_K;
      const int t = ti * CB_TILE + r, s = si * CB_TILE + r;
      Cs[kk * CB_TILE + r] =
          t < Lc ? Cm[((int64_t)b * L + l0 + t) * ld + n0 + kk] : 0.f;
      Bs[kk * CB_TILE + r] =
          s < Lc ? Bm[((int64_t)b * L + l0 + s) * ld + n0 + kk] : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < CB_K; ++kk) {
      float cv[4], bv[4];
      load4(cv, Cs + kk * CB_TILE + ty * 4);
      load4(bv, Bs + kk * CB_TILE + tx * 4);
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = cb + ((int64_t)b * n_chunks + k) * Q * Q;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      out[(ti * CB_TILE + ty * 4 + i) * Q + si * CB_TILE + tx * 4 + j] =
          acc[i][j];
}

__global__ void __launch_bounds__(THREADS, 2) ssd_scan_chunks(
    const float* __restrict__ x, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ D,
    const float* __restrict__ state_in, float* __restrict__ y,
    float* __restrict__ state_out, const float* __restrict__ cb, int L,
    int H, int64_t ld) {
  extern __shared__ float4 ssd_shared[];
  float* S = reinterpret_cast<float*>(ssd_shared);   // [N][P]
  float* cum = S + N * P;                             // [Q]
  float* dts = cum + Q;                               // [Q]
  float* work = dts + Q;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp_row0 = (tid / 32) * 32;   // the 32 rows of the thread's warp
  const float a_h = A[h], d_h = D[h];
  const int64_t sbase = ((int64_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += THREADS)
    S[(i % N) * P + i / N] = state_in ? state_in[sbase + i] : 0.f;
  const int n_chunks = (L + Q - 1) / Q;
  for (int k = 0; k < n_chunks; ++k) {
    const int l0 = k * Q;
    const int Lc = min(Q, L - l0);
    const int64_t row0 = (int64_t)b * L + l0;
    // (1) dt_t and the inclusive sum of dt_t A over the chunk (0 past its
    // end, where the padding's dt is 0).
    const float d = tid < Lc ? dt[(row0 + tid) * H + h] : 0.f;
    dts[tid] = d;
    cum[tid] = d * a_h;
    __syncthreads();
    for (int off = 1; off < Q; off <<= 1) {
      const float v = tid >= off ? cum[tid - off] : 0.f;
      __syncthreads();
      cum[tid] += v;
      __syncthreads();
    }
    // (2) y: rows t = 8 ty + i, columns p = 8 tx + j.
    {
      const int ty = tid / 8, tx = tid % 8;
      float* At = work;                  // [KT][QS], t-major rows
      float* Bt = work + KT * QS;        // [KT][P]
      float acc[8][8] = {};
      // The state in: sum_n C[t][n] S[n][p], then times exp(c_t).
      for (int n0 = 0; n0 < N; n0 += KT) {
        for (int i = tid; i < Q * KT; i += THREADS) {
          const int t = i / KT, kk = i % KT;
          At[kk * QS + t] = t < Lc ? Cm[(row0 + t) * ld + n0 + kk] : 0.f;
        }
        __syncthreads();
        for (int kk = 0; kk < KT; ++kk) {
          float av[8], bv[8];
          load8(av, At + kk * QS + ty * 8);
          load8(bv, S + (n0 + kk) * P + tx * 8);
          for (int i = 0; i < 8; ++i)
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
      for (int i = 0; i < 8; ++i) {
        const float e = expf(cum[ty * 8 + i]);
        for (int j = 0; j < 8; ++j) acc[i][j] *= e;
      }
      // Inside the chunk: G[t][s] = CB[t][s] exp(c_t - c_s) dt_s for
      // s <= t, times x_s.
      const float* cbk = cb + ((int64_t)b * n_chunks + k) * Q * Q;
      for (int s0 = 0; s0 < Lc; s0 += KT) {
        for (int i = tid; i < Q * KT; i += THREADS) {
          const int t = i / KT, kk = i % KT, s = s0 + kk;
          float g = 0.f;
          if (t < Lc && s <= t)
            g = cbk[t * Q + s] * expf(cum[t] - cum[s]) * dts[s];
          At[kk * QS + t] = g;
        }
        for (int i = tid; i < KT * P; i += THREADS) {
          const int kk = i / P, p = i % P, s = s0 + kk;
          Bt[kk * P + p] = s < Lc ? x[(row0 + s) * ld + h * P + p] : 0.f;
        }
        __syncthreads();
        if (warp_row0 + 31 >= s0) {
          for (int kk = 0; kk < KT; ++kk) {
            float av[8], bv[8];
            load8(av, At + kk * QS + ty * 8);
            load8(bv, Bt + kk * P + tx * 8);
            for (int i = 0; i < 8; ++i)
              for (int j = 0; j < 8; ++j)
                acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
        __syncthreads();
      }
      for (int i = 0; i < 8; ++i) {
        const int t = ty * 8 + i;
        if (t >= Lc) break;
        const int64_t r = row0 + t;
        for (int j = 0; j < 8; ++j) {
          const int p = tx * 8 + j;
          y[(r * H + h) * P + p] =
              fmaf(d_h, x[r * ld + h * P + p], acc[i][j]);
        }
      }
    }
    // (3) The state out: rows p = 4 ty + i, columns n = 8 tx + j.
    {
      const int ty = tid / 16, tx = tid % 16;
      float* Xt = work;                  // [KT][P]: exp(c_last - c_s) dt_s x_s
      float* Bs = work + KT * P;         // [KT][N]
      const float last = cum[Q - 1];
      float acc[4][8] = {};
      for (int s0 = 0; s0 < Lc; s0 += KT) {
        for (int i = tid; i < KT * P; i += THREADS) {
          const int kk = i / P, p = i % P, s = s0 + kk;
          Xt[kk * P + p] =
              s < Lc ? expf(last - cum[s]) * dts[s] *
                           x[(row0 + s) * ld + h * P + p]
                     : 0.f;
        }
        for (int i = tid; i < KT * N; i += THREADS) {
          const int kk = i / N, n = i % N, s = s0 + kk;
          Bs[kk * N + n] = s < Lc ? Bm[(row0 + s) * ld + n] : 0.f;
        }
        __syncthreads();
        for (int kk = 0; kk < KT; ++kk) {
          float av[4], bv[8];
          load4(av, Xt + kk * P + ty * 4);
          load8(bv, Bs + kk * N + tx * 8);
          for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
      const float e = expf(last);
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 8; ++j) {
          float* s = S + (tx * 8 + j) * P + ty * 4 + i;
          *s = fmaf(e, *s, acc[i][j]);
        }
    }
    __syncthreads();
  }
  for (int i = tid; i < P * N; i += THREADS)
    state_out[sbase + i] = S[(i % N) * P + i / N];
}

// A shape the kernels take: Granite-4.0-H's head and state sizes, the
// published chunk, and rows wide enough for a slot's heads.
bool valid(int batch, int L, int H, int ld, int head_dim, int d_state,
           int chunk) {
  return batch >= 1 && L >= 1 && H >= 1 && head_dim == P && d_state == N &&
         chunk == Q && ld >= H * P && ld >= N && batch <= 65535 &&
         H <= INT32_MAX / P;
}

}  // namespace

extern "C" {

// x: (batch, L, H, P) rows of `ld` floats (x[b, t, h, p] at
// x[(b L + t) ld + h P + p]); B, C: (batch, L, N) rows of `ld` floats (the
// mixer's conv output, whose rows hold x, B and C side by side); dt:
// contiguous (batch, L, H), after its softplus; A, D: (H,); state_in: the
// contiguous (batch, H, P, N) carried state, or null for zeros.  y: the
// contiguous (batch, L, H, P) output; state_out: the contiguous (batch, H,
// P, N) state after the L positions; cb: scratch of batch x ceil(L / chunk)
// x chunk x chunk floats.  head_dim, d_state and chunk must be 64, 128 and
// 256.  Launches on `stream`, does not synchronise, and returns a
// cudaError_t (cudaErrorInvalidValue for a shape it does not take).
int ssd_scan_forward(const void* x, const void* B, const void* C,
                     const void* dt, const void* A, const void* D,
                     const void* state_in, void* y, void* state_out,
                     void* cb, int batch, int L, int H, int ld, int head_dim,
                     int d_state, int chunk, void* stream) {
  if (!valid(batch, L, H, ld, head_dim, d_state, chunk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (L + Q - 1) / Q;
  ssd_scan_cb<<<dim3(CB_TILES * CB_TILES, n_chunks, batch), THREADS, 0,
                st>>>(static_cast<const float*>(B),
                      static_cast<const float*>(C), static_cast<float*>(cb),
                      L, (int64_t)ld, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_scan_chunks,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_chunks<<<dim3(H, batch), THREADS, SMEM_BYTES, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(state_in), static_cast<float*>(y),
      static_cast<float*>(state_out), static_cast<const float*>(cb), L, H,
      (int64_t)ld);
  return (int)cudaGetLastError();
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
