// Inference tail of a tower block: the conv's bias, GroupNorm and ReLU in two
// passes over the conv's NHWC output.
//
//   out = relu((y + bias - mean_g) * rstd_g * gamma + beta)   (y's dtype)
//
// where mean_g and rstd_g = 1 / sqrt(var_g + eps) are the float32 moments of
// y + bias over (H, W, the channels of group g) of one sample, var biased.
//
// Replaces no TPU kernel: XLA fuses the bias, the norm and the ReLU of
// scan_tpu's towers on its own. Added for the port, where a bf16 conv's bias
// runs as a separate broadcast add after cuDNN, GroupNorm makes its
// channels_last input NCHW-contiguous (a copy) and reads it twice more, and
// the ReLU and the next conv's relayout each read and write it again.
//
// Two launches:
//   * stats: a grid of (pixel chunk, sample). A thread owns one 16-byte
//     vector of channels (8 bf16 or 4 f32, inside one group) and walks the
//     chunk's pixels, folding each vector's mean and M2 into its own
//     (count, mean, M2) by Chan's formula. The block merges its threads by
//     group and writes one partial per (sample, chunk, group) to scratch.
//   * apply: a grid of (pixel chunk, sample). The block merges its sample's
//     partials by group (the same formula, in a fixed order: the result does
//     not depend on the schedule), folds rstd * gamma into a per-channel
//     scale and bias - mean into a per-channel shift, re-reads its pixels
//     (last first, so the stats pass's latest reads come from L2) and writes
//     relu((y + shift) * scale + beta) with 16-byte stores.
// No E[x^2] - E[x]^2: every merge carries M2, the sum of squared deviations.
//
// What bounds it: bytes. It reads y twice and writes the output once: at
// (8, 84, 168, 256) bf16, the C2F P3 level at batch 8, 3 x 57.8 MB, 0.052 ms
// at 3.35 TB/s; its arithmetic is a few operations a byte.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // vectors in flight a thread

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

__device__ __forceinline__ float param(const void* p, int bf16, int i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

struct Moments {
  float n, mean, m2;
};

// Chan et al.: fold (nb, mb, m2b) into a.
__device__ __forceinline__ void merge(Moments& a, float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float n = a.n + nb;
  const float delta = mb - a.mean;
  const float wb = nb / n;
  a.mean = __fmaf_rn(delta, wb, a.mean);
  a.m2 = a.m2 + m2b + delta * delta * a.n * wb;
  a.n = n;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_stats_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                float* __restrict__ part, int HW, int C, int G, int chunk_px) {
  constexpr int V = Vec<T>::N;
  const int CV = C / V, VG = C / G / V;
  const int x = threadIdx.x, py = threadIdx.y, PPI = blockDim.y;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int start = chunk * chunk_px;
  const int end = min(HW, start + chunk_px);
  float bv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) bv[i] = bias ? to_float(bias[x * V + i]) : 0.f;
  const T* base = y + (long long)b * HW * C + x * V;

  Moments m{0.f, 0.f, 0.f};
  for (int p0 = start + py; p0 < end; p0 += PPI * UNROLL) {
    float v[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (p0 + u * PPI < end) load_vec(base + (long long)(p0 + u * PPI) * C, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p0 + u * PPI >= end) continue;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        v[u][i] += bv[i];
        s += v[u][i];
      }
      const float mb = s * (1.f / V);
      float m2b = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[u][i] - mb;
        m2b = __fmaf_rn(d, d, m2b);
      }
      merge(m, (float)V, mb, m2b);
    }
  }

  __shared__ float sh[3][THREADS];
  const int t = py * CV + x;
  sh[0][t] = m.n;
  sh[1][t] = m.mean;
  sh[2][t] = m.m2;
  __syncthreads();
  if (t < G) {
    Moments acc{0.f, 0.f, 0.f};
    for (int q = 0; q < PPI; ++q)
      for (int k = 0; k < VG; ++k) {
        const int s = q * CV + t * VG + k;
        merge(acc, sh[0][s], sh[1][s], sh[2][s]);
      }
    float* o = part + (((long long)b * gridDim.x + chunk) * G + t) * 3;
    o[0] = acc.n;
    o[1] = acc.mean;
    o[2] = acc.m2;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gn_apply_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                const void* __restrict__ gamma, const void* __restrict__ beta,
                int param_bf16, const float* __restrict__ part,
                T* __restrict__ out, int HW, int C, int G, int chunk_px,
                float eps) {
  constexpr int V = Vec<T>::N;
  const int CV = C / V, VG = C / G / V;
  const int x = threadIdx.x, py = threadIdx.y, PPI = blockDim.y;
  const int t = py * CV + x;
  const int b = blockIdx.y;

  // The sample's moments: L lanes a group, each over every L-th chunk's
  // partial (the stats pass ran on this grid), then one thread a group over
  // its lanes.
  __shared__ float sh[3][THREADS];
  __shared__ float s_mean[THREADS], s_rstd[THREADS];
  const int L = CV * PPI / G;
  if (t < G * L) {
    const int g = t / L, l = t % L;
    const int chunks = gridDim.x;
    const float* p = part + (long long)b * chunks * G * 3;
    Moments m{0.f, 0.f, 0.f};
#pragma unroll 4
    for (int k = l; k < chunks; k += L) {
      const float* q = p + ((long long)k * G + g) * 3;
      merge(m, q[0], q[1], q[2]);
    }
    sh[0][t] = m.n;
    sh[1][t] = m.mean;
    sh[2][t] = m.m2;
  }
  __syncthreads();
  if (t < G) {
    Moments m{0.f, 0.f, 0.f};
    for (int l = 0; l < L; ++l) merge(m, sh[0][t * L + l], sh[1][t * L + l], sh[2][t * L + l]);
    s_mean[t] = m.mean;
    s_rstd[t] = 1.f / sqrtf(m.m2 / m.n + eps);
  }
  __syncthreads();

  const int g = x / VG;
  const float mean = s_mean[g], rstd = s_rstd[g];
  float scale[V], shift[V], off[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = x * V + i;
    scale[i] = param(gamma, param_bf16, c) * rstd;
    shift[i] = (bias ? to_float(bias[c]) : 0.f) - mean;
    off[i] = param(beta, param_bf16, c);
  }

  // The chunk's pixels from its last to its first: the stats block of the
  // same chunk read them first to last, so the last ones are the likeliest
  // still to be in L2.
  const int start = blockIdx.x * chunk_px;
  const int end = min(HW, start + chunk_px);
  const long long base = (long long)b * HW * C + x * V;
  for (int p0 = start + py; p0 < end; p0 += PPI * UNROLL) {
    float v[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (p0 + u * PPI < end)
        load_vec(y + base + (long long)(start + end - 1 - p0 - u * PPI) * C, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (p0 + u * PPI >= end) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float r = __fmaf_rn(v[u][i] + shift[i], scale[i], off[i]);
        v[u][i] = r < 0.f ? 0.f : r;  // a NaN passes, as F.relu passes it
      }
      store_vec(out + base + (long long)(start + end - 1 - p0 - u * PPI) * C, v[u]);
    }
  }
}

template <typename T>
int launch(const void* y, const void* bias, const void* gamma, const void* beta,
           float* part, void* out, int B, int HW, int C, int G, int chunks,
           int chunk_px, int param_bf16, float eps, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int CV = C / V;
  const dim3 grid(chunks, B), block(CV, THREADS / CV);
  gn_stats_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(bias), part, HW, C, G, chunk_px);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_apply_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(bias), gamma, beta,
      param_bf16, part, static_cast<T*>(out), HW, C, G, chunk_px, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// y, out: (B, HW, C) NHWC contiguous, bf16 (y_bf16 = 1) or f32; bias: (C,) in
// y's dtype or null; gamma, beta: (C,) bf16 (param_bf16 = 1) or f32; part:
// float32 scratch of B * chunks * G * 3. Both passes cut each sample into the
// same `chunks` chunks of `chunk_px` pixels (the last may be shorter). The
// wrapper checks that C / G is a multiple of the vector (8 bf16, 4 f32), that
// C / vector divides 256, and that the chunks cover HW.
extern "C" int scan_group_norm_relu(const void* y, const void* bias,
                                    const void* gamma, const void* beta,
                                    float* part, void* out, int B, int HW,
                                    int C, int G, int chunks, int chunk_px,
                                    int y_bf16, int param_bf16, float eps,
                                    cudaStream_t stream) {
  if (B <= 0 || HW <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  if (y_bf16)
    return launch<__nv_bfloat16>(y, bias, gamma, beta, part, out, B, HW, C, G,
                                 chunks, chunk_px, param_bf16, eps, stream);
  return launch<float>(y, bias, gamma, beta, part, out, B, HW, C, G, chunks,
                       chunk_px, param_bf16, eps, stream);
}
