// The TCN residual block's pointwise chain on Hopper
// (models/tcn.py::TCNResidualBlock): what runs between the block's two
// cuDNN convolutions, and after the second.
//
// Replaces no TPU kernel: the JAX package writes this chain in jnp and XLA
// fuses it on the TPU, while the port's eager PyTorch ran each step as a
// kernel of its own (~10 passes over a (B, C, T) activation forward, ~14
// more backward).  The products stay with cuDNN; the convolutions are
// called without their bias, which these kernels add.
//
//   forward_a   after the dilated convolution: pre = conv + b, y = relu(pre),
//               m = max_c |y| + 1e-5, n = y / m and, in train mode, the
//               spatial dropout d = (n * mask) * (1 / keep).  Writes n or d.
//   forward_b   after the 1x1 convolution: t = conv + b, out = x + t.
//               Writes out, and t where the TCN sums the skip branches.
//   backward_a  the gradient of pre from the gradient of d (or n): the keep
//               factor and mask, the division's two terms with the channel
//               sum for m, amax's gradient split evenly over the channels
//               tied at the max (as torch.amax splits it), and ReLU's
//               threshold at y > 0.  It recomputes y and m from conv and b,
//               so the forward saves nothing it did not already hold.
//
// Under torch.func.vmap (the multi-trial step) the wrapper folds the trial
// axis into the items: each trial's items then read their own row of a
// (bias_rows, C) bias.
//
// Same bits as the chain: every step is the float operation PyTorch's CUDA
// kernels perform, in their order, through the _rn intrinsics (no FMA
// contraction, a true division).  In bfloat16 each step is rounded where
// PyTorch's bf16 elementwise ops round it: the sums, m, the division and
// the dropout's two products; ReLU and the max are exact.  The division by
// keep is a product by 1 / keep, as PyTorch's CUDA division by a Python
// float computes it; the wrapper passes that reciprocal, taken in double
// and rounded to float32.  The backward computes in float32, with one
// division (1 / m) and products by it, and rounds once, at its output.
//
// What bounds them on an H100: bytes.  Per element forward_a reads 4 bytes
// and writes 4 against ~5 operations, forward_b reads 8 and writes 4 or 8,
// backward_a reads 8 and writes 4 against ~12: far under the float32 ridge.
// Design of forward_a and backward_a: one thread per (item, time step),
// looping over the C channels.  Along a warp consecutive threads read
// consecutive time steps of one channel, so each load is coalesced, and the
// channel max and sum stay in one thread: no shuffle, no shared memory.
// For C of 8, 16 or 32 (the tuner's n_filters) the loop is unrolled and the
// channel values stay in registers between the passes; any
// other C takes the same loop with the values read again (from L1 or L2).
// Blocks of 64 threads, so that the training step's 36 x 32 x 68 (2448
// columns) spreads over 39 SMs, not ten; the segmenter's 10000 x 32 x 68
// makes 10625 blocks.  forward_b is elementwise: 16 bytes a thread where
// T allows (4 float32 or 8 bf16 time steps of one channel), blocks of 256.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libtcn_block.so tcn_block.cu
// C interface, loaded with ctypes by sm_hpss_mtl_tpu_torch/ops/tcn_block.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;     // forward_a, backward_a
constexpr int B_THREADS = 256;  // forward_b
constexpr float NORM_EPS = 1e-5f;  // channel_normalization's epsilon

// Storage types: loads to float, the rounding of a step's float result to
// the storage type, and stores.
struct F32 {
  using T = float;
  static __device__ __forceinline__ float ld(const T* p) { return *p; }
  static __device__ __forceinline__ float rn(float v) { return v; }
  static __device__ __forceinline__ void st(T* p, float v) { *p = v; }
};

struct BF16 {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float ld(const T* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float rn(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void st(T* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// torch.relu on CUDA (clamp_min(v, 0)): NaN passes through.
__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

// A step of torch.amax: NaN propagates.
__device__ __forceinline__ float max_nan(float a, float v) {
  return (v > a || isnan(v)) ? v : a;
}

// y = relu(conv + b), rounded as the chain rounds it.
template <class S>
__device__ __forceinline__ float relu_pre(const typename S::T* conv,
                                          const typename S::T* bias,
                                          int64_t at, int c) {
  return relu(S::rn(__fadd_rn(S::ld(conv + at), S::ld(bias + c))));
}

// One thread's (item, time step): its first element's offset, or -1 past
// the end.
__device__ __forceinline__ int64_t column(int B, int n_ch, int T, int& b) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (int64_t)B * T) return -1;
  b = (int)(i / T);
  const int t = (int)(i - (int64_t)b * T);
  return (int64_t)b * n_ch * T + t;
}

// Item b's bias: one row of n_ch for all B items, or bias_rows rows each
// for B / bias_rows consecutive items (a vmapped block's trials, folded
// into the items).
template <class T_>
__device__ __forceinline__ const T_* bias_row(const T_* bias, int b, int B,
                                              int n_ch, int bias_rows) {
  if (bias_rows == 1) return bias;
  return bias + (int64_t)(b / (B / bias_rows)) * n_ch;
}

// C > 0: the channel count, values kept in registers; C == 0: n_ch
// channels, values read again.
template <class S, int C>
__global__ void __launch_bounds__(THREADS)
forward_a(const typename S::T* __restrict__ conv,
          const typename S::T* __restrict__ bias,
          const typename S::T* __restrict__ mask,
          typename S::T* __restrict__ out, int B, int n_ch, int T,
          int bias_rows, float inv_keep) {
  const int nc = C > 0 ? C : n_ch;
  int b;
  const int64_t base = column(B, nc, T, b);
  if (base < 0) return;
  const int64_t row = (int64_t)b * nc;
  const auto* bs = bias_row(bias, b, B, nc, bias_rows);
  float y[C > 0 ? C : 1];
  float a = 0.f;
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const float v = relu_pre<S>(conv, bs, base + (int64_t)c * T, c);
    if constexpr (C > 0) y[c] = v;
    a = max_nan(a, fabsf(v));
  }
  const float m = S::rn(__fadd_rn(a, NORM_EPS));
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const int64_t at = base + (int64_t)c * T;
    float v;
    if constexpr (C > 0) v = y[c];
    else v = relu_pre<S>(conv, bs, at, c);
    float n = S::rn(__fdiv_rn(v, m));
    if (mask != nullptr) {
      n = S::rn(__fmul_rn(n, S::ld(mask + row + c)));
      n = S::rn(__fmul_rn(n, inv_keep));
    }
    S::st(out + at, n);
  }
}

// VEC consecutive elements, one load or store of 16 bytes where VEC fills
// them.
template <class T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// forward_b is elementwise along a channel's row, so it takes VEC time
// steps a thread (T a multiple of VEC: a pack never crosses a row), in
// blocks of B_THREADS.
template <class S, int VEC>
__global__ void __launch_bounds__(B_THREADS)
forward_b(const typename S::T* __restrict__ x,
          const typename S::T* __restrict__ conv,
          const typename S::T* __restrict__ bias,
          typename S::T* __restrict__ out, typename S::T* __restrict__ t_out,
          int64_t packs, int B, int n_ch, int T, int bias_rows) {
  using P = Pack<typename S::T, VEC>;
  const int64_t i = (int64_t)blockIdx.x * B_THREADS + threadIdx.x;
  if (i >= packs) return;
  const int64_t at = i * VEC;
  const int64_t r = at / T;                 // item * n_ch + channel
  const int b = (int)(r / n_ch);
  const float bc = S::ld(bias_row(bias, b, B, n_ch, bias_rows)
                         + (r - (int64_t)b * n_ch));
  const P cv = *reinterpret_cast<const P*>(conv + at);
  const P xv = *reinterpret_cast<const P*>(x + at);
  P ov, tv;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float t = S::rn(__fadd_rn(S::ld(&cv.v[k]), bc));
    S::st(&ov.v[k], __fadd_rn(S::ld(&xv.v[k]), t));
    S::st(&tv.v[k], t);
  }
  *reinterpret_cast<P*>(out + at) = ov;
  if (t_out != nullptr) *reinterpret_cast<P*>(t_out + at) = tv;
}

// The gradient of d (or n), times the keep factor and the mask.
template <class S>
__device__ __forceinline__ float grad_n(const typename S::T* grad,
                                        const typename S::T* mask,
                                        int64_t at, int64_t bc,
                                        float inv_keep) {
  const float g = S::ld(grad + at);
  if (mask == nullptr) return g;
  return __fmul_rn(__fmul_rn(g, inv_keep), S::ld(mask + bc));
}

template <class S, int C>
__global__ void __launch_bounds__(THREADS)
backward_a(const typename S::T* __restrict__ grad,
           const typename S::T* __restrict__ conv,
           const typename S::T* __restrict__ bias,
           const typename S::T* __restrict__ mask,
           typename S::T* __restrict__ g_pre, int B, int n_ch, int T,
           int bias_rows, float inv_keep) {
  const int nc = C > 0 ? C : n_ch;
  int b;
  const int64_t base = column(B, nc, T, b);
  if (base < 0) return;
  const int64_t row = (int64_t)b * nc;
  const auto* bs = bias_row(bias, b, B, nc, bias_rows);
  float y[C > 0 ? C : 1];
  float a = 0.f;
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const float v = relu_pre<S>(conv, bs, base + (int64_t)c * T, c);
    if constexpr (C > 0) y[c] = v;
    a = max_nan(a, fabsf(v));
  }
  const float m = S::rn(__fadd_rn(a, NORM_EPS));
  // One division: 1/m, and products by it (the forward's exact division
  // is not needed here; the result is a float32 gradient).
  const float r = __fdiv_rn(1.f, m);
  const float r2 = __fmul_rn(r, r);
  // The gradient of m: -sum_c g_n * y / m^2, over the channels.
  float s = 0.f, ties = 0.f;
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const int64_t at = base + (int64_t)c * T;
    float v;
    if constexpr (C > 0) v = y[c];
    else v = relu_pre<S>(conv, bs, at, c);
    const float g = grad_n<S>(grad, mask, at, row + c, inv_keep);
    s = __fadd_rn(s, __fmul_rn(__fmul_rn(g, v), r2));
    ties += fabsf(v) == a ? 1.f : 0.f;
  }
  // amax's gradient, -s, split over the tied channels; through |y| it
  // keeps its sign where y > 0, and ReLU's threshold zeroes the rest.
  const float share = __fdiv_rn(-s, ties);
#pragma unroll
  for (int c = 0; c < nc; ++c) {
    const int64_t at = base + (int64_t)c * T;
    float v;
    if constexpr (C > 0) v = y[c];
    else v = relu_pre<S>(conv, bs, at, c);
    float gy = __fmul_rn(grad_n<S>(grad, mask, at, row + c, inv_keep), r);
    if (v == a) gy = __fadd_rn(gy, share);
    S::st(g_pre + at, v > 0.f ? gy : 0.f);
  }
}

int grid(int B, int T) {
  return (int)(((int64_t)B * T + THREADS - 1) / THREADS);
}

// A shape every grid below holds (at most 2^31 - 1 blocks), with the items
// split evenly over the bias rows.
bool valid(int B, int n_ch, int T, int bias_rows) {
  return B >= 1 && n_ch >= 1 && T >= 1 && bias_rows >= 1 &&
         B % bias_rows == 0 &&
         (int64_t)B * n_ch * T <= (int64_t)INT32_MAX * THREADS;
}

// The instance of kernel K for n_ch channels: 8, 16 and 32 unrolled, any
// other count in the general loop.
template <class F>
F instance(int n_ch, F k8, F k16, F k32, F k0) {
  return n_ch == 8 ? k8 : n_ch == 16 ? k16 : n_ch == 32 ? k32 : k0;
}

template <class S>
int launch_a(const void* conv, const void* bias, const void* mask, void* out,
             int B, int n_ch, int T, int bias_rows, float inv_keep,
             cudaStream_t st) {
  using T_ = typename S::T;
  using F = void (*)(const T_*, const T_*, const T_*, T_*, int, int, int,
                     int, float);
  const F kernel = instance<F>(n_ch, forward_a<S, 8>, forward_a<S, 16>,
                               forward_a<S, 32>, forward_a<S, 0>);
  kernel<<<grid(B, T), THREADS, 0, st>>>(
      static_cast<const T_*>(conv), static_cast<const T_*>(bias),
      static_cast<const T_*>(mask), static_cast<T_*>(out), B, n_ch, T,
      bias_rows, inv_keep);
  return (int)cudaGetLastError();
}

template <class S>
int launch_b(const void* x, const void* conv, const void* bias, void* out,
             void* t_out, int B, int n_ch, int T, int bias_rows,
             cudaStream_t st) {
  using T_ = typename S::T;
  constexpr int VEC = 16 / sizeof(T_);
  const auto* xs = static_cast<const T_*>(x);
  const auto* cv = static_cast<const T_*>(conv);
  const auto* bs = static_cast<const T_*>(bias);
  auto* o = static_cast<T_*>(out);
  auto* t = static_cast<T_*>(t_out);
  const int64_t n = (int64_t)B * n_ch * T;
  if (T % VEC == 0) {
    const int64_t packs = n / VEC;
    forward_b<S, VEC><<<(int)((packs + B_THREADS - 1) / B_THREADS),
                        B_THREADS, 0, st>>>(xs, cv, bs, o, t, packs, B, n_ch,
                                            T, bias_rows);
  } else {
    forward_b<S, 1><<<(int)((n + B_THREADS - 1) / B_THREADS), B_THREADS, 0,
                      st>>>(xs, cv, bs, o, t, n, B, n_ch, T, bias_rows);
  }
  return (int)cudaGetLastError();
}

template <class S>
int launch_backward_a(const void* grad, const void* conv, const void* bias,
                      const void* mask, void* g_pre, int B, int n_ch, int T,
                      int bias_rows, float inv_keep, cudaStream_t st) {
  using T_ = typename S::T;
  using F = void (*)(const T_*, const T_*, const T_*, const T_*, T_*, int,
                     int, int, int, float);
  const F kernel = instance<F>(n_ch, backward_a<S, 8>, backward_a<S, 16>,
                               backward_a<S, 32>, backward_a<S, 0>);
  kernel<<<grid(B, T), THREADS, 0, st>>>(
      static_cast<const T_*>(grad), static_cast<const T_*>(conv),
      static_cast<const T_*>(bias), static_cast<const T_*>(mask),
      static_cast<T_*>(g_pre), B, n_ch, T, bias_rows, inv_keep);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point takes contiguous (B, C, T) activations, a
// (bias_rows, C) bias (one row for B / bias_rows consecutive items; one row
// for all of them in a plain call) and, where given (not null), a (B, C)
// dropout mask of 0 and 1, all of one storage type: float32 (bf16 == 0) or
// bfloat16 (bf16 != 0).  inv_keep is float32 1 / keep, read only with a
// mask.  Each launches on `stream`, does not synchronise, and returns a
// cudaError_t (cudaErrorInvalidValue for an empty or too large shape, or
// bias rows that do not divide B).

// out = dropout(relu(conv + b) / (max_c |relu(conv + b)| + 1e-5)).
int tcn_forward_a(const void* conv, const void* bias, const void* mask,
                  void* out, int B, int C, int T, int bias_rows, int bf16,
                  float inv_keep, void* stream) {
  if (!valid(B, C, T, bias_rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_a<BF16>(conv, bias, mask, out, B, C, T, bias_rows,
                               inv_keep, st)
              : launch_a<F32>(conv, bias, mask, out, B, C, T, bias_rows,
                              inv_keep, st);
}

// t = conv + b, out = x + t; t written only where t_out is not null.
int tcn_forward_b(const void* x, const void* conv, const void* bias,
                  void* out, void* t_out, int B, int C, int T, int bias_rows,
                  int bf16, void* stream) {
  if (!valid(B, C, T, bias_rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_b<BF16>(x, conv, bias, out, t_out, B, C, T, bias_rows,
                               st)
              : launch_b<F32>(x, conv, bias, out, t_out, B, C, T, bias_rows,
                              st);
}

// g_pre = the gradient of conv + b given grad, the gradient of
// tcn_forward_a's output (same bias, mask and inv_keep).
int tcn_backward_a(const void* grad, const void* conv, const void* bias,
                   const void* mask, void* g_pre, int B, int C, int T,
                   int bias_rows, int bf16, float inv_keep, void* stream) {
  if (!valid(B, C, T, bias_rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_backward_a<BF16>(grad, conv, bias, mask, g_pre, B, C,
                                        T, bias_rows, inv_keep, st)
              : launch_backward_a<F32>(grad, conv, bias, mask, g_pre, B, C,
                                       T, bias_rows, inv_keep, st);
}

const char* tcn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
