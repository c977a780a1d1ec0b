// conv1_1 of the int8 stem with its successor's quantize, in one pass:
//
//   acc = conv3x3(x_q, w_q)                       (s8 x s8 -> s32, zero pad 1)
//   y   = bf16(acc * (s0 * w_scale) + b0)          (round to nearest even)
//   out = clip(rint(relu(y) / s1), -127, 127)      (s8, plain NHWC)
//
// Replaces scan_tpu/ops/pallas/conv0_kernel.py::conv0_s8 (body _kernel). The
// TPU kernel's sublane fold, column deinterleave and (72, 128) im2col
// weight were Mosaic's layout demands, as was its (B, H, W/2, 128) output
// with even and odd columns in the two lane halves. That output is a
// reshape of plain NHWC, which this kernel writes; the next conv reads it
// as an ordinary s8 NHWC input at scale s1.
//
// One block per 8 x 32 tile of output pixels, 256 threads, one pixel each:
//   1. the (8+2) x (32+2) input halo goes to shared memory as one 32-bit word
//      per pixel, bytes (c0, c1, c2, 0), zero outside the image; the weights
//      go there as one word per (tap, output channel), bytes (w0, w1, w2, 0);
//   2. each thread keeps its nine tap words in registers and forms each of
//      the 64 output channels with nine __dp4a (signed bytes, s32 sum);
//   3. the epilogue runs in float32 in scan_tpu's order: a product, a sum
//      (no FMA: the build passes --fmad=false), a round to bf16, the ReLU,
//      an IEEE division and rintf (half to even); the 64 bytes of a pixel go
//      out as four 16-byte stores.
//
// What bounds it: bytes. At (8, 800, 1344) it reads 26 MB and writes 551 MB,
// 0.17 ms at 3.35 TB/s, against 30 GOP of int8 work (0.015 ms at the
// 1979 TOP/s tensor-core peak). This first version spends 576 dp4a and 64
// divisions a pixel on the CUDA cores.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TR = 8, TC = 32;            // output pixels per block
constexpr int XR = TR + 2, XC = TC + 2;   // input halo tile
constexpr int CH = 64;
constexpr int THREADS = TR * TC;          // 256

__device__ __forceinline__ uint32_t byte_of(float q, int shift) {
  return ((uint32_t)(uint8_t)(int8_t)(int)q) << shift;
}

__global__ void __launch_bounds__(THREADS)
conv0_kernel(const int8_t* __restrict__ x, const int* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ bias,
             const float* __restrict__ s1p, int8_t* __restrict__ out, int H,
             int W) {
  __shared__ int xs[XR * XC];
  __shared__ int ws[9 * CH];
  __shared__ float sc[CH], bs[CH];

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
  const int8_t* xb = x + (size_t)b * H * W * 3;
  for (int i = tid; i < XR * XC; i += THREADS) {
    const int gy = r0 - 1 + i / XC, gx = c0 - 1 + i % XC;
    uint32_t v = 0u;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int8_t* p = xb + ((size_t)gy * W + gx) * 3;
      v = (uint32_t)(uint8_t)p[0] | ((uint32_t)(uint8_t)p[1] << 8) |
          ((uint32_t)(uint8_t)p[2] << 16);
    }
    xs[i] = (int)v;
  }
  for (int i = tid; i < 9 * CH; i += THREADS) ws[i] = w[i];
  if (tid < CH) {
    sc[tid] = scale[tid];
    bs[tid] = bias[tid];
  }
  __syncthreads();

  const int ty = tid / TC, tx = tid % TC;
  const int gy = r0 + ty, gx = c0 + tx;
  if (gy >= H || gx >= W) return;
  int v[9];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) v[ky * 3 + kx] = xs[(ty + ky) * XC + tx + kx];

  const float s1 = *s1p;
  uint4* dst = reinterpret_cast<uint4*>(out + (((size_t)b * H + gy) * W + gx) * CH);
#pragma unroll 1
  for (int c16 = 0; c16 < CH / 16; ++c16) {
    uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int co = c16 * 16 + j;
      int acc = 0;
#pragma unroll
      for (int t = 0; t < 9; ++t) acc = __dp4a(v[t], ws[t * CH + co], acc);
      float y = (float)acc * sc[co];
      y = y + bs[co];
      y = __bfloat162float(__float2bfloat16_rn(y));
      y = fmaxf(y, 0.f);
      float q = rintf(y / s1);
      q = fminf(fmaxf(q, -127.f), 127.f);
      word[j / 4] |= byte_of(q, 8 * (j % 4));
    }
    dst[c16] = make_uint4(word[0], word[1], word[2], word[3]);
  }
}

}  // namespace

// x: (B, H, W, 3) s8 NHWC; w: (9, 64) words [tap][co], bytes (w_c0, w_c1,
// w_c2, 0); scale = s0 * w_scale and bias: (64,) f32; s1: device f32 scalar;
// out: (B, H, W, 64) s8 NHWC.
extern "C" int scan_conv0_s8(const int8_t* x, const int* w, const float* scale,
                             const float* bias, const float* s1, int8_t* out,
                             int B, int H, int W, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  dim3 grid((W + TC - 1) / TC, (H + TR - 1) / TR, B);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  conv0_kernel<<<grid, THREADS, 0, stream>>>(x, w, scale, bias, s1, out, H, W);
  return (int)cudaGetLastError();
}
