// The tail of Jang's conv block at inference on Hopper
// (models/jang.py::_ConvBlock): what runs after the block's cuDNN
// convolution, which is called without its bias.
//
// Replaces no TPU kernel: the JAX package writes the chain in jnp
// (sm_hpss_mtl_tpu/models/jang.py) and XLA fuses it on the TPU, while the
// port's eager PyTorch ran each step as a kernel of its own: the bias add,
// BatchNorm, ReLU, the -inf padding of 'SAME' at an odd width and the max
// pool, each reading and writing the whole activation (~20 MB a Jang-MTL
// window in float32, against 4.6 MB read once and written pooled).
//
//   conv_block_forward   for each element of an NCHW product y:
//                        t = y + b (rounded to the storage type, as
//                        Conv2d.forward rounds it in bfloat16, then
//                        promoted to float32 as BatchNorm2d promotes it),
//                        z = BatchNorm(t) in eval form from the running
//                        mean and variance, weight, shift and eps, r =
//                        relu(z); then the 2x2/2 max pool of r, which reads
//                        rows 2i, 2i+1 and columns 2j, 2j+1 where they exist:
//                        'VALID' (Ho = H / 2) drops an odd last row or column,
//                        'SAME' (Ho = ceil(H / 2)) pools it alone, as its -inf
//                        padding on the high side does.  Writes only the
//                        pooled float32 tensor.
//
// Same bits as the chain: each step is the float operation PyTorch's CUDA
// path performs, through the _rn intrinsics (no FMA contraction but the one
// cuDNN's BatchNorm makes: see bn_terms), and the max pool visits the
// window in max_pool2d's order with its NaN rule.
//
// Under torch.func.vmap (the multi-trial evaluation step) the wrapper folds
// the trial axis into the items: each trial's items then read their own row
// of (rows, C) parameters.
//
// What bounds it on an H100: bytes.  Per input element it reads 4 bytes
// (2 in bfloat16) and writes a quarter of 4, against ~6 operations: far
// under the float32 ridge.  Design: one block per (item, channel) plane, so
// the channel's BatchNorm terms are computed once, in the block's prologue,
// and are uniform in it.  Each thread takes a 2-row by VEC-column tile of
// the plane per step (VEC / 2 pooled outputs), in a loop over the plane's
// tiles; its two rows are loaded before either is used, 16 bytes a row
// where the width and the pointers allow it (Jang-MTL's W = 68 in float32),
// 8 or 4 where they allow less (W = 34, whose odd rows start 8 bytes off a
// 16-byte boundary), and element by element at an odd width (W = 17, with
// the pooled column at the edge).  Neighbouring threads take neighbouring
// tiles of a row, so each load of a warp is coalesced.  The host gives a
// block as many threads as balance its tiles over at most 256 (a plane of
// 270 tiles takes 160 threads in two steps, not 256 in two with half
// idle).  On an H100 80GB HBM3 (700 W) Jang-MTL's three float32 blocks at
// 1024 items run at 92%, 92% and 75% of their bytes' bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libconv_block.so conv_block.cu
// C interface, loaded with ctypes by sm_hpss_mtl_tpu_torch/ops/conv_block.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

// Storage types of the product and its bias: loads to float, and the
// rounding of the bias add to the storage type.
struct F32 {
  using T = float;
  static __device__ __forceinline__ float ld(T v) { return v; }
  static __device__ __forceinline__ float rn(float v) { return v; }
};

struct BF16 {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float ld(T v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float rn(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// VEC consecutive elements, loaded or stored at once.
template <class T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// A channel's terms: the conv bias, and BatchNorm's in eval form.
struct Terms {
  float bias, mean, inv_std, weight, shift;
};

// cuDNN's eval-form BatchNorm (bn_fw_inf_1C11_kernel_NCHW, float32), as
// torch.batch_norm computes it on an H100: 1 / std by rsqrtf (the
// approximate reciprocal square root) of var + eps in float32, then
// fma(weight * (t - mean), 1 / std, shift).  The same bits over 16.7 M
// values, a variance of 1e-5 among them; no other order of these float
// operations matched (each differed in 10-35% of the values by an ulp or
// two).
__device__ __forceinline__ Terms bn_terms(float bias, float mean, float var,
                                          float weight, float shift,
                                          float eps) {
  return {bias, mean, rsqrtf(__fadd_rn(var, eps)), weight, shift};
}

// BatchNorm of t, in eval form.
__device__ __forceinline__ float normalize(float t, const Terms& k) {
  return __fmaf_rn(__fmul_rn(k.weight, __fsub_rn(t, k.mean)), k.inv_std,
                   k.shift);
}

// torch.relu on CUDA (clamp_min(v, 0)): NaN passes through.
__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

// A step of max_pool2d's window: a larger value or a NaN replaces the max.
__device__ __forceinline__ float max_nan(float a, float v) {
  return (v > a || isnan(v)) ? v : a;
}

// One product element through the bias, BatchNorm and ReLU.
template <class S>
__device__ __forceinline__ float value(typename S::T y, const Terms& k) {
  return relu(normalize(S::rn(__fadd_rn(S::ld(y), k.bias)), k));
}

// VEC > 1: a thread takes VEC columns of two rows per step (W a multiple of
// VEC, so Wo = W / 2 and no column is left alone); VEC == 1: one pooled
// output per step, its window cut at the plane's edges.  Blocks: one per
// (item, channel) plane; the parameters' row of item b is
// b / items_per_row.
template <class S, int VEC>
__global__ void __launch_bounds__(MAX_THREADS)
conv_block(const typename S::T* __restrict__ conv,
           const typename S::T* __restrict__ bias,
           const float* __restrict__ mean, const float* __restrict__ var,
           const float* __restrict__ weight, const float* __restrict__ shift,
           float* __restrict__ out, int C, int H, int W, int Ho, int Wo,
           int items_per_row, float eps) {
  using T = typename S::T;
  const int64_t plane = blockIdx.x;
  const int64_t item = plane / C;
  const int c = (int)(plane - item * C);
  const int64_t p = item / items_per_row * C + c;
  const Terms k = bn_terms(S::ld(bias[p]), mean[p], var[p], weight[p],
                           shift[p], eps);
  const T* in = conv + plane * H * W;
  float* o = out + plane * Ho * Wo;
  if constexpr (VEC == 1) {
    const int tiles = Ho * Wo;
    for (int n = threadIdx.x; n < tiles; n += blockDim.x) {
      const int i = n / Wo, j = n - i * Wo;
      const T* at = in + (2 * i) * W + 2 * j;
      const bool right = 2 * j + 1 < W, down = 2 * i + 1 < H;
      const T a0 = at[0];
      const T a1 = right ? at[1] : a0;
      const T b0 = down ? at[W] : a0;
      const T b1 = down && right ? at[W + 1] : a0;
      float m = value<S>(a0, k);
      if (right) m = max_nan(m, value<S>(a1, k));
      if (down) {
        m = max_nan(m, value<S>(b0, k));
        if (right) m = max_nan(m, value<S>(b1, k));
      }
      o[n] = m;
    }
  } else {
    using P = Pack<T, VEC>;
    using Q = Pack<float, VEC / 2>;
    const int per_row = W / VEC;
    const int tiles = Ho * per_row;
    for (int n = threadIdx.x; n < tiles; n += blockDim.x) {
      const int i = n / per_row, q = n - i * per_row;
      const T* at = in + (2 * i) * W + q * VEC;
      const bool down = 2 * i + 1 < H;
      const P a = *reinterpret_cast<const P*>(at);
      P b;
      if (down) b = *reinterpret_cast<const P*>(at + W);
      Q m;
#pragma unroll
      for (int u = 0; u < VEC / 2; ++u) {
        float v = max_nan(value<S>(a.v[2 * u], k), value<S>(a.v[2 * u + 1], k));
        if (down) {
          v = max_nan(v, value<S>(b.v[2 * u], k));
          v = max_nan(v, value<S>(b.v[2 * u + 1], k));
        }
        m.v[u] = v;
      }
      *reinterpret_cast<Q*>(o + i * Wo + q * (VEC / 2)) = m;
    }
  }
}

template <class S, int VEC>
int launch(const void* conv, const void* bias, const void* mean,
           const void* var, const void* weight, const void* shift, void* out,
           int B, int C, int H, int W, int Ho, int Wo, int rows, float eps,
           cudaStream_t st) {
  using T = typename S::T;
  const int tiles = VEC == 1 ? Ho * Wo : Ho * (W / VEC);
  const int steps = (tiles + MAX_THREADS - 1) / MAX_THREADS;
  const int threads = ((tiles + steps - 1) / steps + 31) / 32 * 32;
  conv_block<S, VEC><<<(unsigned)((int64_t)B * C), threads, 0, st>>>(
      static_cast<const T*>(conv), static_cast<const T*>(bias),
      static_cast<const float*>(mean), static_cast<const float*>(var),
      static_cast<const float*>(weight), static_cast<const float*>(shift),
      static_cast<float*>(out), C, H, W, Ho, Wo, B / rows, eps);
  return (int)cudaGetLastError();
}

// Whether VEC columns a thread fit: W a multiple of VEC, and the product's
// and the output's pointers aligned to a pack (their planes then are too).
bool fits(int vec, int W, const void* conv, const void* out, int size) {
  return W % vec == 0 &&
         reinterpret_cast<uintptr_t>(conv) % ((uintptr_t)vec * size) == 0 &&
         reinterpret_cast<uintptr_t>(out) % ((uintptr_t)vec / 2 * 4) == 0;
}

// The widest load that fits: 16 bytes, else 8, else 4 (two elements),
// else the element-wise path.
template <class S>
int dispatch(const void* conv, const void* bias, const void* mean,
             const void* var, const void* weight, const void* shift,
             void* out, int B, int C, int H, int W, int Ho, int Wo, int rows,
             float eps, cudaStream_t st) {
  constexpr int size = (int)sizeof(typename S::T);
  constexpr int widest = 16 / size;
#define CONV_BLOCK_LAUNCH(V)                                                 \
  return launch<S, V>(conv, bias, mean, var, weight, shift, out, B, C, H, W, \
                      Ho, Wo, rows, eps, st)
  if (fits(widest, W, conv, out, size)) CONV_BLOCK_LAUNCH(widest);
  if constexpr (widest > 4) {
    if (fits(4, W, conv, out, size)) CONV_BLOCK_LAUNCH(4);
  }
  if (fits(2, W, conv, out, size)) CONV_BLOCK_LAUNCH(2);
  CONV_BLOCK_LAUNCH(1);
#undef CONV_BLOCK_LAUNCH
}

// A shape the grid and the indexing hold, with the pooled size of 'VALID'
// or 'SAME' on each axis and the items split evenly over the rows.
bool valid(int B, int C, int H, int W, int Ho, int Wo, int rows) {
  return B >= 1 && C >= 1 && H >= 1 && W >= 1 && rows >= 1 &&
         B % rows == 0 && (Ho == H / 2 || Ho == (H + 1) / 2) && Ho >= 1 &&
         (Wo == W / 2 || Wo == (W + 1) / 2) && Wo >= 1 &&
         (int64_t)B * C <= INT32_MAX && (int64_t)H * W <= INT32_MAX;
}

}  // namespace

extern "C" {

// conv: the contiguous (B, C, H, W) product, without its bias; bias: (rows,
// C) in conv's storage type, float32 (bf16 == 0) or bfloat16 (bf16 != 0);
// mean, var, weight, shift: BatchNorm's (rows, C) float32 running mean and
// variance, weight and shift, eps its epsilon; rows: 1 for all B items, or
// a row for each B / rows consecutive items (a vmapped block's trials
// folded into the items).  out: the contiguous float32 (B, C, Ho, Wo)
// pooled result, Ho and Wo the 2x2/2 pool's 'VALID' or 'SAME' sizes.
// Launches on `stream`, does not synchronise, and returns a cudaError_t
// (cudaErrorInvalidValue for a shape it does not take).
int conv_block_forward(const void* conv, const void* bias, const void* mean,
                       const void* var, const void* weight,
                       const void* shift, void* out, int B, int C, int H,
                       int W, int Ho, int Wo, int rows, int bf16, float eps,
                       void* stream) {
  if (!valid(B, C, H, W, Ho, Wo, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<BF16>(conv, bias, mean, var, weight, shift, out, B,
                               C, H, W, Ho, Wo, rows, eps, st)
              : dispatch<F32>(conv, bias, mean, var, weight, shift, out, B,
                              C, H, W, Ho, Wo, rows, eps, st);
}

const char* conv_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
