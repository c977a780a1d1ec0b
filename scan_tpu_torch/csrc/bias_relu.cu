// Inference tail of a VGG conv: the conv's bias and the ReLU, and at a stage's
// last conv also the 2x2/2 max-pool, in one pass over the conv's NHWC output.
//
//   in place:  y   = relu(round(y + bias))                      (B, H, W, C)
//   pool:      out = max over 2x2 of relu(round(y + bias))      (B, H/2, W/2, C)
//
// round: to y's dtype (bf16 or float32), the sum taken in float32 once. That
// is what PyTorch computes after cuDNN, which returns the conv without its
// bias and adds the bias in a separate pass; ReLU and max are exact on the
// rounded values, so the result is the module path's (conv, bias add,
// F.relu, F.max_pool2d) but for the sign of a zero. A NaN propagates, as
// F.relu and F.max_pool2d propagate it. The pool floors odd H and W.
//
// Replaces no TPU kernel: XLA fuses scan_tpu's bias, ReLU and pool on its own.
// Added for the port, where the module path reads and writes a conv's output
// three or four times (bias add, ReLU, pool); this kernel reads it once and
// writes it once, or a quarter of it in the pool mode.
//
// Layout: a thread owns one 16-byte vector of channels (8 bf16 or 4 f32) for
// good, so its bias lives in registers; neighbouring threads take
// neighbouring vectors of one pixel, a block (THREADS / CV) * CV threads, CV =
// C / vector. The grid strides over pixels, one wave of blocks.
//
// What bounds it: bytes. At (8, 336, 672, 128) bf16, C2F's stage 2 at batch 8,
// the in-place mode moves 2 x 462 MB (0.276 ms at 3.35 TB/s) and the pool
// mode 462 + 116 MB (0.173 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
};

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// v holds values of the output dtype already: the stores round nothing.
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// relu(round(y + b)) in T, as a float. A NaN passes (the comparison is false).
__device__ __forceinline__ float biased_relu(float y, float b, __nv_bfloat16) {
  const float r = __bfloat162float(__float2bfloat16_rn(__fadd_rn(y, b)));
  return r < 0.f ? 0.f : r;
}
__device__ __forceinline__ float biased_relu(float y, float b, float) {
  const float r = __fadd_rn(y, b);
  return r < 0.f ? 0.f : r;
}

// max(m, v) that keeps a NaN from either side, as F.max_pool2d does.
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

template <typename T>
__device__ __forceinline__ void load_bias(const T* __restrict__ bias, int cv, float* bv) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int i = 0; i < V; ++i) bv[i] = to_float(bias[cv * V + i]);
}

// y (pixels, C) in place.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bias_relu_kernel(T* __restrict__ y, const T* __restrict__ bias, long long pixels,
                 int CV) {
  constexpr int V = Vec<T>::N;
  constexpr int UNROLL = 4;  // vectors in flight a thread
  const int per_block = blockDim.x / CV;
  const int cv = threadIdx.x % CV;
  const long long step = (long long)gridDim.x * per_block;
  const long long C = (long long)CV * V;
  float bv[V];
  load_bias(bias, cv, bv);
  T* base = y + cv * V;
  for (long long p = (long long)blockIdx.x * per_block + threadIdx.x / CV;
       p < pixels; p += step * UNROLL) {
    float v[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (p + u * step < pixels) load_vec(base + (p + u * step) * C, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p + u * step >= pixels) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) v[u][i] = biased_relu(v[u][i], bv[i], T());
      store_vec(base + (p + u * step) * C, v[u]);
    }
  }
}

// y (B, H, W, C) -> out (B, Ho, Wo, C), Ho = H / 2, Wo = W / 2 (floored).
// The wrapper keeps B * H * W below 2^31, so pixel indices fit 32 bits.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bias_relu_pool_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                      T* __restrict__ out, unsigned pixels, unsigned H,
                      unsigned W, unsigned Ho, unsigned Wo, int CV) {
  constexpr int V = Vec<T>::N;
  constexpr int UNROLL = 2;  // output vectors in flight a thread, 4 loads each
  const unsigned per_block = blockDim.x / CV;
  const int cv = threadIdx.x % CV;
  const unsigned step = gridDim.x * per_block;
  const long long C = (long long)CV * V;
  float bv[V];
  load_bias(bias, cv, bv);
  const T* src = y + cv * V;
  T* dst = out + cv * V;
  for (unsigned p = blockIdx.x * per_block + threadIdx.x / CV; p < pixels;
       p += step * UNROLL) {
    float v[UNROLL][4][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned q = p + u * step;
      if (q >= pixels) continue;
      const unsigned wo = q % Wo, t = q / Wo;
      const unsigned ho = t % Ho, b = t / Ho;
      const long long in = ((long long)(b * H + 2 * ho) * W + 2 * wo) * C;
      load_vec(src + in, v[u][0]);
      load_vec(src + in + C, v[u][1]);
      load_vec(src + in + W * C, v[u][2]);
      load_vec(src + in + W * C + C, v[u][3]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned q = p + u * step;
      if (q >= pixels) continue;
      float m[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        m[i] = biased_relu(v[u][0][i], bv[i], T());
#pragma unroll
        for (int k = 1; k < 4; ++k) m[i] = nan_max(m[i], biased_relu(v[u][k][i], bv[i], T()));
      }
      store_vec(dst + (long long)q * C, m);
    }
  }
}

template <typename T>
int launch(void* y, const void* bias, void* out, int B, int H, int W, int C,
           int max_blocks, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int CV = C / V;
  const int per_block = THREADS / CV;
  const long long pixels =
      out ? (long long)B * (H / 2) * (W / 2) : (long long)B * H * W;
  if (pixels == 0) return 0;
  const long long need = (pixels + per_block - 1) / per_block;
  const int blocks = (int)(need < max_blocks ? need : max_blocks);
  if (out)
    bias_relu_pool_kernel<T><<<blocks, per_block * CV, 0, stream>>>(
        static_cast<const T*>(y), static_cast<const T*>(bias), static_cast<T*>(out),
        (unsigned)pixels, H, W, H / 2, W / 2, CV);
  else
    bias_relu_kernel<T><<<blocks, per_block * CV, 0, stream>>>(
        static_cast<T*>(y), static_cast<const T*>(bias), pixels, CV);
  return (int)cudaGetLastError();
}

}  // namespace

// y: (B, H, W, C) NHWC contiguous, 16-byte aligned, bf16 (y_bf16 = 1) or f32;
// bias: (C,) in y's dtype. out null: y = relu(y + bias) in place; else out
// (B, H/2, W/2, C) contiguous gets the pooled result and y is only read.
// The wrapper checks that C is a multiple of the vector (8 bf16, 4 f32),
// that C / vector is at most 256, and that B * H * W is below 2^31.
// max_blocks: the grid's cap (a wave: 8 blocks an SM). Returns a CUDA error.
extern "C" int scan_bias_relu(void* y, const void* bias, void* out, int B, int H,
                              int W, int C, int y_bf16, int max_blocks,
                              cudaStream_t stream) {
  if (B < 0 || H < 0 || W < 0 || C <= 0 || max_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (y_bf16)
    return launch<__nv_bfloat16>(y, bias, out, B, H, W, C, max_blocks, stream);
  return launch<float>(y, bias, out, B, H, W, C, max_blocks, stream);
}
