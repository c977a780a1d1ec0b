// All of int8 VGG16 stage 1 in one kernel: s8 image in, pooled s8 out.
//
//   acc0 = conv3x3(x_q, w0_q)                         s32, zero pad 1
//   y_q  = clip(rint(relu(acc0 * a0 + b0) / s1), 0, 127)   (0 outside the image)
//   acc1 = conv3x3(y_q, w1_q)                         s32, zero pad 1
//   out  = maxpool2x2(clip(rint((acc1 * a1 + b1) / s_out), 0, 127))
//   with a0 = s0 * w0_scale, a1 = s1 * w1_scale
//
// Replaces scan_tpu/ops/pallas/stem_int8_kernel.py::fused_stem_int8 (body
// _kernel). The TPU kernel's pair-column im2col bands, built by XLA outside
// it, and its (12*128, 256) conv1_2 weight full of structural zeros were
// Mosaic devices; this kernel keeps only what they were for: the full-
// resolution conv1_1 and conv1_2 outputs never reach device memory.
//
// One block per TH x TW = 4 x 16 tile of pooled outputs, 256 threads; it is
// kernel K2's halo tile (csrc/stem.cu) in s8:
//   1. the (2TH+4) x (2TW+4) input halo goes to shared memory as one word a
//      pixel, bytes (c0, c1, c2, 0), zero outside the image; both weights
//      go there as words of four input channels: w0 [tap][co], w1
//      [tap][ci/4][co] (36 KB);
//   2. conv1_1 over the (2TH+2) x (2TW+2) x 64 tile that conv1_2 reads:
//      nine __dp4a an output, the f32 epilogue and requant at s1, then
//      every position outside the image is forced to 0, because conv1_2
//      must see zero padding there and bias + ReLU would not give it
//      (stem_int8_kernel.py:118-125). Stored as [ci/4][row][col] words;
//   3. conv1_2: thread t owns one pooled pixel and 16 output channels, a
//      2x2 window x 16 = 64 s32 accumulators in registers, fed by __dp4a
//      over 4x4 words of y per input-channel group and 16 broadcast weight
//      words per tap;
//   4. the epilogue takes the max of the four s32 sums first and requantizes
//      once. That equals requantizing all four and taking the max, as the
//      TPU kernel does, because each step of the epilogue (the exact int to
//      float conversion, the product by a1 > 0, the sum, the division by
//      s_out > 0, rintf, the clip) is non-decreasing. The 16 bytes go out
//      as one store.
// Every float step runs in scan_tpu's order, one rounding each: the build
// passes --fmad=false and uses IEEE division; rintf rounds half to even.
//
// What bounds it: operations. At (8, 800, 1344) it does 664 GOP of int8
// work (conv1_2 is 634), 0.34 ms at the 1979 TOP/s tensor-core peak,
// against 26 MB in and 138 MB out. This first version runs the products
// as __dp4a on the CUDA cores, not on the tensor cores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 4, TW = 16;                   // pooled outputs per block
constexpr int CH = 64, CW = CH / 4;              // channels, words a pixel
constexpr int XR = 2 * TH + 4, XC = 2 * TW + 4;  // input halo tile
constexpr int YR = 2 * TH + 2, YC = 2 * TW + 2;  // conv1_1 tile
constexpr int CO_T = 16;                         // output channels a thread
constexpr int THREADS = TH * TW * (CH / CO_T);   // 256

constexpr int SMEM_WORDS =
    XR * XC + 9 * CH + 9 * CW * CH + 4 * CH + CW * YR * YC;
constexpr int SMEM_BYTES = SMEM_WORDS * 4;

__device__ __forceinline__ float requant(int acc, float a, float b, float s) {
  float v = (float)acc * a;
  v = v + b;
  v = fmaxf(v, 0.f);
  return fminf(fmaxf(rintf(v / s), 0.f), 127.f);
}

__global__ void __launch_bounds__(THREADS)
stem_int8_kernel(const int8_t* __restrict__ x, const int* __restrict__ w0,
                 const int* __restrict__ w1, const float* __restrict__ a0,
                 const float* __restrict__ b0, const float* __restrict__ a1,
                 const float* __restrict__ b1, const float* __restrict__ s1p,
                 const float* __restrict__ sop, int8_t* __restrict__ out,
                 int H, int W) {
  extern __shared__ int smem[];
  int* xs = smem;                          // [XR][XC]
  int* w0s = xs + XR * XC;                 // [tap][co]
  int* w1s = w0s + 9 * CH;                 // [tap][ci/4][co]
  float* a0s = reinterpret_cast<float*>(w1s + 9 * CW * CH);
  float* b0s = a0s + CH;
  float* a1s = b0s + CH;
  float* b1s = a1s + CH;
  int* ys = reinterpret_cast<int*>(b1s + CH);  // [ci/4][YR][YC]

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int HP = H / 2, WP = W / 2;
  const int p0 = blockIdx.y * TH, q0 = blockIdx.x * TW;  // pooled origin
  const int gy0 = 2 * p0 - 2, gx0 = 2 * q0 - 2;           // x tile origin

  // ---- 1. input halo, weights, epilogue constants ----
  const int8_t* xb = x + (size_t)b * H * W * 3;
  for (int i = tid; i < XR * XC; i += THREADS) {
    const int gy = gy0 + i / XC, gx = gx0 + i % XC;
    uint32_t v = 0u;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int8_t* p = xb + ((size_t)gy * W + gx) * 3;
      v = (uint32_t)(uint8_t)p[0] | ((uint32_t)(uint8_t)p[1] << 8) |
          ((uint32_t)(uint8_t)p[2] << 16);
    }
    xs[i] = (int)v;
  }
  for (int i = tid; i < 9 * CH; i += THREADS) w0s[i] = w0[i];
  for (int i = tid; i < 9 * CW * CH / 4; i += THREADS)
    reinterpret_cast<int4*>(w1s)[i] = reinterpret_cast<const int4*>(w1)[i];
  if (tid < CH) {
    a0s[tid] = a0[tid];
    b0s[tid] = b0[tid];
    a1s[tid] = a1[tid];
    b1s[tid] = b1[tid];
  }
  const float s1 = *s1p, so = *sop;
  __syncthreads();

  // ---- 2. conv1_1 + requant at s1; y tile origin is (gy0 + 1, gx0 + 1) ----
  for (int i = tid; i < CW * YR * YC; i += THREADS) {
    const int col = i % YC;
    const int row = (i / YC) % YR;
    const int cw = i / (YR * YC);
    const int gy = gy0 + 1 + row, gx = gx0 + 1 + col;
    uint32_t word = 0u;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      int v[9];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
          v[ky * 3 + kx] = xs[(row + ky) * XC + col + kx];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = cw * 4 + j;
        int acc = 0;
#pragma unroll
        for (int t = 0; t < 9; ++t) acc = __dp4a(v[t], w0s[t * CH + co], acc);
        const float q = requant(acc, a0s[co], b0s[co], s1);
        word |= ((uint32_t)(int)q) << (8 * j);
      }
    }
    ys[i] = (int)word;
  }
  __syncthreads();

  // ---- 3. conv1_2 over the 2x2 window of one pooled pixel, 16 channels ----
  const int cg = tid / (TH * TW);  // channel group: warp-uniform
  const int pix = tid % (TH * TW);
  const int py = pix / TW, px = pix % TW;
  int acc[4][CO_T];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int o = 0; o < CO_T; ++o) acc[p][o] = 0;

#pragma unroll 1
  for (int cw = 0; cw < CW; ++cw) {
    int patch[4][4];
    const int* yp = ys + (cw * YR + 2 * py) * YC + 2 * px;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) patch[r][c] = yp[r * YC + c];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const int4* wp = reinterpret_cast<const int4*>(
            w1s + (((ky * 3 + kx) * CW + cw) * CH + cg * CO_T));
        int wv[CO_T];
#pragma unroll
        for (int k = 0; k < CO_T / 4; ++k) {
          const int4 t = wp[k];
          wv[4 * k] = t.x;
          wv[4 * k + 1] = t.y;
          wv[4 * k + 2] = t.z;
          wv[4 * k + 3] = t.w;
        }
#pragma unroll
        for (int oy = 0; oy < 2; ++oy)
#pragma unroll
          for (int ox = 0; ox < 2; ++ox) {
            const int yv = patch[oy + ky][ox + kx];
#pragma unroll
            for (int o = 0; o < CO_T; ++o)
              acc[oy * 2 + ox][o] = __dp4a(yv, wv[o], acc[oy * 2 + ox][o]);
          }
      }
    }
  }

  // ---- 4. max of the window, requant at s_out, one 16-byte store ----
  const int P = p0 + py, Q = q0 + px;
  if (P >= HP || Q >= WP) return;
  uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int o = 0; o < CO_T; ++o) {
    const int co = cg * CO_T + o;
    const int m = max(max(acc[0][o], acc[1][o]), max(acc[2][o], acc[3][o]));
    float v = (float)m * a1s[co];
    v = v + b1s[co];
    const float q = fminf(fmaxf(rintf(v / so), 0.f), 127.f);
    word[o / 4] |= ((uint32_t)(int)q) << (8 * (o % 4));
  }
  *reinterpret_cast<uint4*>(out + (((size_t)b * HP + P) * WP + Q) * CH +
                            cg * CO_T) = make_uint4(word[0], word[1], word[2],
                                                    word[3]);
}

}  // namespace

extern "C" int scan_stem_int8_smem_bytes() { return SMEM_BYTES; }

// x: (B, H, W, 3) s8 NHWC at scale s0; w0: (9, 64) words [tap][co], bytes
// (w_c0, w_c1, w_c2, 0); w1: (9, 16, 64) words [tap][ci/4][co], bytes
// (w_ci, w_ci+1, w_ci+2, w_ci+3); a0 = s0 * w0_scale, b0, a1 = s1 * w1_scale,
// b1: (64,) f32; s1, s_out: device f32 scalars; out: (B, H/2, W/2, 64) s8.
extern "C" int scan_stem_int8(const int8_t* x, const int* w0, const int* w1,
                              const float* a0, const float* b0,
                              const float* a1, const float* b1,
                              const float* s1, const float* s_out, int8_t* out,
                              int B, int H, int W, cudaStream_t stream) {
  const int HP = H / 2, WP = W / 2;
  if (B <= 0 || HP <= 0 || WP <= 0) return 0;
  dim3 grid((WP + TW - 1) / TW, (HP + TH - 1) / TH, B);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stem_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  stem_int8_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      x, w0, w1, a0, b0, a1, b1, s1, s_out, out, H, W);
  return (int)cudaGetLastError();
}
