// Fused VGG16 stage 1: relu(maxpool2x2(conv3x3(relu(conv3x3(x,w0)+b0),w1)+b1)).
//
// Replaces scan_tpu/ops/pallas/stem_kernel.py::fused_s2d_stem (body
// _stem_kernel). The TPU kernel's column deinterleave, sublane fold, lane
// padding, 12-tap lane concat and 4-phase output were forced by Mosaic and
// are not carried over. This kernel keeps only the idea: the full-resolution
// conv1_1 output never reaches device memory.
//
// One block per (image, TH x TW tile of pooled outputs), 256 threads:
//   1. the input halo tile, (2TH+4) x (2TW+4) x 3, goes to shared memory
//      (zero outside the image: conv1_1's padding);
//   2. conv1_1 + bias + ReLU over the (2TH+2) x (2TW+2) x 64 tile it feeds,
//      into shared memory; every value outside the image is zeroed, because
//      conv1_2 must see zero padding there (stem_kernel.py:165-176);
//   3. conv1_2: thread t owns one pooled pixel and 16 output channels, i.e.
//      a 2x2 window x 16 channels = 64 accumulators in registers. w1 is
//      staged through shared memory 8 input channels at a time. Bias, the
//      2x2 max and ReLU happen in registers, and only the pooled
//      (B, H/2, W/2, 64) NHWC output is written.
// Ragged H and W are masked, not asserted.
//
// What bounds it: operations. At 800x1344 one image is 83.0 GFLOP (79.3 in
// conv1_2), against 12.9 MB of fp32 input and 68.8 MB (fp32) or 34.4 MB
// (bf16) of output. This first version runs on the CUDA cores in fp32 FMAs (no
// mma/wgmma, no TMA); the register tile gives 576 FMAs per 16 shared loads
// of activations and 36 broadcast 16-byte loads of weights.
//
// Two variants:
//   float: fp32 in, fp32 out;
//   bf16:  x, w0, b0, w1, b1 rounded to bf16 on load, as the bf16 plain
//          version's casts do; fp32 accumulation; the conv1_1 output is
//          rounded to bf16 before conv1_2; bf16 out.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 4;        // pooled rows per block
constexpr int TW = 16;       // pooled cols per block
constexpr int CIN = 3;
constexpr int CH = 64;
constexpr int XR = 2 * TH + 4, XC = 2 * TW + 4;  // input halo tile
constexpr int YR = 2 * TH + 2, YC = 2 * TW + 2;  // conv1_1 tile
constexpr int CI_CHUNK = 8;                      // w1 input channels staged
constexpr int CO_T = 16;                         // output channels per thread
constexpr int THREADS = TH * TW * (CH / CO_T);   // 256

constexpr int SMEM_FLOATS =
    CIN * XR * XC + 9 * CIN * CH + 2 * CH + CH * YR * YC + CI_CHUNK * 9 * CH;
constexpr int SMEM_BYTES = SMEM_FLOATS * 4;

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <bool BF16>
__device__ __forceinline__ void store_out(float* out, size_t idx, float v) {
  out[idx] = v;
}
template <>
__device__ __forceinline__ void store_out<true>(float* out, size_t idx, float v) {
  reinterpret_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
}

// x: (B, H, W, 3) NHWC; w0: (3, 3, 3, 64) as [ky][kx][ci][co];
// w1: (64, 3, 3, 64) as [ci][ky][kx][co]; out: (B, H/2, W/2, 64).
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
stem_kernel(const float* __restrict__ x, const float* __restrict__ w0,
            const float* __restrict__ b0, const float* __restrict__ w1,
            const float* __restrict__ b1, float* __restrict__ out,
            int H, int W) {
  extern __shared__ float smem[];
  float* xs = smem;                       // [CIN][XR][XC]
  float* w0s = xs + CIN * XR * XC;        // [ky][kx][ci][co]
  float* b0s = w0s + 9 * CIN * CH;        // [co]
  float* b1s = b0s + CH;                  // [co]
  float* ys = b1s + CH;                   // [CH][YR][YC]
  float* w1s = ys + CH * YR * YC;         // [CI_CHUNK][ky][kx][co]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int HP = H / 2, WP = W / 2;
  const int p0 = blockIdx.y * TH, q0 = blockIdx.x * TW;  // pooled origin
  const int gy0 = 2 * p0 - 2, gx0 = 2 * q0 - 2;           // x tile origin

  // ---- 1. input halo tile, weights of conv1_1, biases ----
  const float* xb = x + (size_t)b * H * W * CIN;
  for (int idx = tid; idx < XR * XC * CIN; idx += THREADS) {
    const int c = idx % CIN;
    const int col = (idx / CIN) % XC;
    const int row = idx / (CIN * XC);
    const int gy = gy0 + row, gx = gx0 + col;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = rnd<BF16>(xb[((size_t)gy * W + gx) * CIN + c]);
    xs[(c * XR + row) * XC + col] = v;
  }
  for (int idx = tid; idx < 9 * CIN * CH; idx += THREADS)
    w0s[idx] = rnd<BF16>(w0[idx]);
  for (int idx = tid; idx < CH; idx += THREADS) {
    b0s[idx] = rnd<BF16>(b0[idx]);
    b1s[idx] = rnd<BF16>(b1[idx]);
  }
  __syncthreads();

  // ---- 2. conv1_1 + bias + ReLU; y tile origin is (gy0 + 1, gx0 + 1) ----
  for (int idx = tid; idx < CH * YR * YC; idx += THREADS) {
    const int col = idx % YC;
    const int row = (idx / YC) % YR;
    const int co = idx / (YR * YC);
    const int gy = gy0 + 1 + row, gx = gx0 + 1 + col;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      float acc = 0.f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci)
            acc += xs[(ci * XR + row + ky) * XC + col + kx] *
                   w0s[((ky * 3 + kx) * CIN + ci) * CH + co];
      v = fmaxf(rnd<BF16>(acc + b0s[co]), 0.f);
    }
    ys[(co * YR + row) * YC + col] = v;
  }

  // ---- 3. conv1_2 + bias + 2x2 max + ReLU ----
  const int cg = tid / (TH * TW);  // channel group: warp-uniform
  const int pix = tid % (TH * TW);
  const int py = pix / TW, px = pix % TW;
  float acc[4][CO_T];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int o = 0; o < CO_T; ++o) acc[p][o] = 0.f;

  for (int c0 = 0; c0 < CH; c0 += CI_CHUNK) {
    __syncthreads();  // ys complete (first pass) / w1s free (later passes)
    for (int idx = tid; idx < CI_CHUNK * 9 * CH; idx += THREADS)
      w1s[idx] = rnd<BF16>(w1[(size_t)c0 * 9 * CH + idx]);
    __syncthreads();
#pragma unroll 1
    for (int cc = 0; cc < CI_CHUNK; ++cc) {
      // 4x4 y patch feeding the 2x2 window: y rows 2py..2py+3, cols 2px..2px+3
      float patch[4][4];
      const float* yp = ys + ((c0 + cc) * YR + 2 * py) * YC + 2 * px;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) patch[r][c] = yp[r * YC + c];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* wp = reinterpret_cast<const float4*>(
              w1s + ((cc * 3 + ky) * 3 + kx) * CH + cg * CO_T);
          float wv[CO_T];
#pragma unroll
          for (int v = 0; v < CO_T / 4; ++v) {
            const float4 t = wp[v];
            wv[4 * v] = t.x;
            wv[4 * v + 1] = t.y;
            wv[4 * v + 2] = t.z;
            wv[4 * v + 3] = t.w;
          }
#pragma unroll
          for (int oy = 0; oy < 2; ++oy)
#pragma unroll
            for (int ox = 0; ox < 2; ++ox) {
              const float yv = patch[oy + ky][ox + kx];
#pragma unroll
              for (int o = 0; o < CO_T; ++o)
                acc[oy * 2 + ox][o] += yv * wv[o];
            }
        }
      }
    }
  }

  const int P = p0 + py, Q = q0 + px;
  if (P >= HP || Q >= WP) return;
  const size_t base = (((size_t)b * HP + P) * WP + Q) * CH + cg * CO_T;
#pragma unroll
  for (int o = 0; o < CO_T; ++o) {
    const float bias = b1s[cg * CO_T + o];
    float m = fmaxf(fmaxf(acc[0][o] + bias, acc[1][o] + bias),
                    fmaxf(acc[2][o] + bias, acc[3][o] + bias));
    store_out<BF16>(out, base + o, fmaxf(m, 0.f));
  }
}

}  // namespace

extern "C" int scan_stem_smem_bytes() { return SMEM_BYTES; }

extern "C" int scan_stem(const float* x, const float* w0, const float* b0,
                         const float* w1, const float* b1, void* out, int B,
                         int H, int W, int out_bf16, cudaStream_t stream) {
  const int HP = H / 2, WP = W / 2;
  if (B <= 0 || HP <= 0 || WP <= 0) return 0;
  dim3 grid((WP + TW - 1) / TW, (HP + TH - 1) / TH, B);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (out_bf16) {
    err = cudaFuncSetAttribute(stem_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    stem_kernel<true><<<grid, THREADS, SMEM_BYTES, stream>>>(
        x, w0, b0, w1, b1, static_cast<float*>(out), H, W);
  } else {
    err = cudaFuncSetAttribute(stem_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    stem_kernel<false><<<grid, THREADS, SMEM_BYTES, stream>>>(
        x, w0, b0, w1, b1, static_cast<float*>(out), H, W);
  }
  return (int)cudaGetLastError();
}
