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
// What bounds it: bytes. At (4, 800, 1344) it reads 13 MB and writes 275 MB
// (0.086 ms at 3.35 TB/s) against 30 GOP of int8 work (0.015 ms at the
// 1979 TOP/s tensor-core peak). Each byte out is an epilogue of several
// float operations, so instruction issue, not bytes, is what the design
// has to cut: its epilogue is 9 operations an output, all but the clip on
// the FMA pipe:
//
//   * The conv is a GEMM on the tensor cores, mma.sync m16n8k32 s8 -> s32:
//     M = 16 consecutive pixels of one row, N = 32 channels (a warp's half),
//     K = 3 rows ky x 4 pixel words kx (bytes c0, c1, c2, 0) = 48 bytes,
//     padded with zero weights to 64, i.e. two k32 steps. Word 4 ky + kx of
//     K is pixel (ky, kx) of the 3 x 4 window, so lane (g, t)'s A registers
//     are the halo words (ky, col + g + t) and (ky, col + g + 8 + t): one
//     plain LDS each, the eleven words of one LDS consecutive in one halo
//     row (no bank conflict). kx = 3 reads a real halo word whose weight is
//     0; step 1's upper half (ky = 3) is the constant 0.
//   * w0 is packed once per weight version as (64, 16) words [co][4 ky + kx].
//     Each thread keeps its B fragments (12 words) and its 8 channels' scale
//     and bias in registers for the block's life. B's columns are permuted
//     so that a lane's 8 channels of a pixel are contiguous: each pixel's
//     bytes go out as one 8-byte store, straight from registers.
//   * The epilogue is exact, in scan_tpu's order, with no conversion and no
//     division (checked against the plain version by the CPU tests in
//     tests/test_torch_conv0_mma.py, exhaustively where they can be):
//       - the accumulators start at the bits of 1.5 * 2^23, so the s32 sum
//         is a float one subtraction from acc (exact for |acc| < 2^22);
//       - the product and the sum as __fmul_rn and __fadd_rn;
//       - the round to bf16 by Veltkamp's split, three FMA-pipe operations;
//       - ReLU, the product with r = 1 / s1 and the clip at 128 in one
//         saturating multiply by r / 128; rint by one FMA adding 2^23; the
//         byte is the float's low byte, clipped at 127.
//     p = y * r is within 2 ulp(128) of y / s1, so rint(p) = rint(y / s1)
//     unless y / s1 lies within ~2^-14 of a half-integer. Only the bf16
//     values y in [s1 / 4, 128 s1) can give a byte other than 0 or 127, and
//     each block tries all of them (1,280) against the IEEE division before
//     its tiles. Where all agree (1 in 2,000 seeded scales disagrees, and
//     round ones such as 7 or 0.9 more often: the CPU tests), the division
//     is never needed. Else the second, guarded kernel does the launch's
//     work: it divides for a thread's m16 tile wherever one of its products
//     lies within 2^-14 of a half-integer, or where the scales leave the
//     common path's range.
//
// Grid: persistent. The common path's kernel runs three 256-thread blocks a
// SM (80 registers); the guarded one two. Both are launched; each makes the
// same check, and the one whose case it is not exits at once. A block walks
// tiles of 4 rows x 128 columns, two warps a row (one a channel half, eight
// m16 tiles each); it loads the next tile's halo into registers (warp w its
// row w) before it computes the current one.

#include <cstdint>
#include <cuda_runtime.h>
#include <initializer_list>

#include "stem_mma.cuh"

namespace {

constexpr int CH = 64;
constexpr int TR = 4, TC = 128;            // output pixels per tile
constexpr int WARPS = 2 * TR, THREADS = WARPS * 32;
constexpr int MT = TC / 16;                // m16 tiles a row
constexpr int HALF = CH / 2;               // channels a warp
constexpr int NT = HALF / 8;               // n8 tiles a warp
constexpr int XR = TR + 2, XC = TC + 4;    // halo: kx = 0..3 reaches col + 18
constexpr int X_WORDS = XR * XC;
constexpr int X_PER_LANE = (XC + 31) / 32;  // halo words a lane loads
static_assert(XR <= WARPS, "a warp loads one halo row");
constexpr int K_WORDS = 16;                // packed w0 words a channel

// |acc| <= 27 products of |x| <= 128 and |w| <= 127 = 438,912 < 2^22: the
// magic-number conversion below is exact.
static_assert(27 * 128 * 127 < (1 << 22), "s32 -> f32 by 1.5 * 2^23");

constexpr float kMagic22 = 12582912.f;     // 1.5 * 2^23
constexpr float kMagic23 = 8388608.f;      // 2^23
constexpr float kSigma = 65537.f;          // Veltkamp's 2^16 + 1
constexpr float kGuard = 0.5f - 0x1p-14f;  // |p - rint(p)| at which to divide

// The accumulators start at 0x4B400000, so an mma's s32 sum is the bits of
// 1.5 * 2^23 + acc, and acc itself is one subtraction away.
__device__ __forceinline__ float acc_value(int acc_bits) {
  return __fsub_rn(__int_as_float(acc_bits), kMagic22);
}

__device__ __forceinline__ float mul_sat(float a, float b) {
  float d;
  asm("mul.rn.sat.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The byte of y from its bf16 value: ps = sat(y * r / 128) =
// min(relu(y * r), 128) / 128 (r / 128 is exact); t = 2^23 + rint(128 ps) by
// one FMA; the byte is t's low byte, clipped at 127. With GUARD, dmax keeps
// the largest |128 ps - rint(128 ps)|, for the guard band.
template <bool GUARD>
__device__ __forceinline__ uint32_t quant_bf16(float y, float r128,
                                               float& dmax) {
  const float ps = mul_sat(y, r128);
  const float t = __fmaf_rn(ps, 128.f, kMagic23);
  if (GUARD)
    dmax = fmaxf(dmax, fabsf(__fmaf_rn(ps, 128.f, -__fsub_rn(t, kMagic23))));
  return min(__float_as_uint(t), 0x4B00007Fu);
}

// The common path, for one output, all of it on the FMA pipe but the clip:
// y = acc * sc + bs, rounded to bf16 by Veltkamp's split (g = (2^16 + 1) y,
// y - g + g: the round to 8 significant bits, half to even, for every
// normal |y| < 2^110; a denormal y gives byte 0, as the exact path does).
template <bool GUARD>
__device__ __forceinline__ uint32_t quant_fast(int acc_bits, float sc,
                                               float bs, float r128,
                                               float& dmax) {
  const float y = __fadd_rn(__fmul_rn(acc_value(acc_bits), sc), bs);
  const float g = __fmul_rn(y, kSigma);
  return quant_bf16<GUARD>(__fadd_rn(g, __fsub_rn(y, g)), r128, dmax);
}

// The exact path, taken for a thread's whole m16 tile where one of its
// values lies in the guard band (or the scales are out of the common path's
// range): the round to bf16 on the bits, the ReLU and the IEEE division.
__device__ __forceinline__ uint32_t quant_exact(int acc_bits, float sc,
                                                float bs, float s1) {
  float y = __fadd_rn(__fmul_rn(acc_value(acc_bits), sc), bs);
  uint32_t u = __float_as_uint(y);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;  // bf16, half to even
  y = fmaxf(__uint_as_float(u), 0.f);
  const float t = __fadd_rn(fminf(__fdiv_rn(y, s1), 128.f), kMagic23);
  return min(__float_as_uint(t), 0x4B00007Fu);
}

// Whether the common path without its guard gives the byte of the IEEE
// division for the bf16 value y >= 0.
__device__ __forceinline__ bool quant_agrees(float y, float r128, float s1) {
  float unused = 0.f;
  const float e = __fadd_rn(fminf(__fdiv_rn(y, s1), 128.f), kMagic23);
  return quant_bf16<false>(y, r128, unused) ==
         min(__float_as_uint(e), 0x4B00007Fu);
}

// The bytes of one m16 tile: acc[nt][0..1] are the lane's pixel, channels
// 8t + 2 nt, +1 at op; acc[nt][2..3] the pixel 8 further. Each pixel's 8
// bytes go out as one store, where the pixel is one of the npx left in W.
template <bool GUARD>
__device__ __forceinline__ void epilogue(const int (&acc)[NT][4],
                                         const float (&sc)[NT][2],
                                         const float (&bs)[NT][2],
                                         float r128, float s1,
                                         bool exact_only, int8_t* op,
                                         int npx) {
  // q holds the bits of t: the byte in the low 8, 0x4B0000 above
  float dmax = 0.f;
  uint32_t q[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      q[nt][i] = quant_fast<GUARD>(acc[nt][i], sc[nt][i & 1], bs[nt][i & 1],
                                   r128, dmax);
  if (GUARD && (dmax >= kGuard || exact_only)) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        q[nt][i] = quant_exact(acc[nt][i], sc[nt][i & 1], bs[nt][i & 1], s1);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // two bytes a channel pair: lo + 256 hi keeps both in the low 16 bits
    // (0x4B000000 * 256 wraps to 0)
    uint32_t pair[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      pair[nt] = q[nt][2 * h] + q[nt][2 * h + 1] * 256u;
    if (8 * h < npx)
      *reinterpret_cast<uint2*>(op + 8 * h * CH) =
          make_uint2(__byte_perm(pair[0], pair[1], 0x5410),
                     __byte_perm(pair[2], pair[3], 0x5410));
  }
}

// x: (B, H, W, 3) s8 NHWC; w: (64, 16) words [co][4 ky + kx], bytes (w_c0,
// w_c1, w_c2, 0), zero for kx = 3; w_scale, bias: (64,) f32; s0, s1: device
// f32 scalars, floored at 1e-8 here as the plain version floors them; out:
// (B, H, W, 64) s8 NHWC.
// GUARD: the launch for scales whose division-free path needs its guard
// band. Both kernels run the same check, and the one whose case it is does
// the work (3 blocks a SM, 80 registers a thread, for the common path).
template <bool GUARD>
__global__ void __launch_bounds__(THREADS, GUARD ? 2 : 3)
conv0_kernel(const int8_t* __restrict__ x, const int* __restrict__ w,
             const float* __restrict__ w_scale, const float* __restrict__ s0p,
             const float* __restrict__ bias, const float* __restrict__ s1p,
             int8_t* __restrict__ out, int B, int H, int W) {
  __shared__ uint32_t xs[X_WORDS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row = warp >> 1, half = warp & 1;  // the warp's row, channels
  const int tiles_x = (W + TC - 1) / TC, tiles_y = (H + TR - 1) / TR;
  const int tiles = B * tiles_y * tiles_x;

  // B fragments: k bytes 4t..4t+3 (word t) and 16+4t.. (word 4+t) of each
  // k32 step; step 1's second word (ky = 3) is 0. Column n of n8 tile nt is
  // channel 8 (n >> 1) + 2 nt + (n & 1) of the warp's half, so that lane
  // (g, t)'s C columns 2t, 2t + 1 are channels 8t + 2 nt, +1: its 8 bytes of
  // a pixel are contiguous, one 8-byte store.
  uint32_t bw0[NT][2], bw1[NT];
  float sc[NT][2], bs[NT][2];
  const float s0 = fmaxf(*s0p, 1e-8f), s1 = fmaxf(*s1p, 1e-8f);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int* wc =
        w + (HALF * half + 8 * (g >> 1) + 2 * nt + (g & 1)) * K_WORDS;
    bw0[nt][0] = wc[t];
    bw0[nt][1] = wc[4 + t];
    bw1[nt] = wc[8 + t];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[nt][j] = __fmul_rn(w_scale[HALF * half + 8 * t + 2 * nt + j], s0);
      bs[nt][j] = bias[HALF * half + 8 * t + 2 * nt + j];
    }
  }
  // r = 1 / s1, correctly rounded (the value torch.reciprocal gives)
  const float r = __frcp_rn(s1), r128 = __fmul_rn(r, 0.0078125f);
  // The common path's range: |acc| < 2^19, so |y| < 2^110 when |sc| <= 2^90
  // and |bs| <= 2^100; r / 128 stays normal when r >= 2^-100.
  bool exact_only = !(r >= 0x1p-100f);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      exact_only |= !(fabsf(sc[nt][j]) <= 0x1p90f && fabsf(bs[nt][j]) <= 0x1p100f);
  // Does the common path need its guard at this s1? Only the bf16 values
  // y in [s1 / 4, 128 s1) can give a byte other than 0 or 127 (p < 0.5 or
  // p >= 127.5 by either path below and above); they lie in the 10 binades
  // from s1's exponent - 2 to + 7, 1,280 values, which the block tries all
  // of. Where every one agrees with the division (most scales do)
  // the guard is left out.
  const int e1 = (int)((__float_as_uint(s1) >> 23) & 0xFFu);
  bool disagree = exact_only;
  for (int i = tid; i < 10 * 128; i += THREADS) {
    const int e = e1 - 2 + (i >> 7);
    if (e >= 0 && e < 255)
      disagree |= !quant_agrees(
          __uint_as_float((uint32_t)(e << 7 | (i & 127)) << 16), r128, s1);
  }
  if ((__syncthreads_or(disagree) != 0) != GUARD) return;
  // The halo of a tile, (TR + 2) x (TC + 4) pixel words, zero outside the
  // image: warp w < TR + 2 loads halo row w, lane l its words l + 32 j.
  uint32_t pre[X_PER_LANE];
  auto load_halo = [&](int tile) {
    const int b = tile / (tiles_y * tiles_x);
    const int gy = (tile / tiles_x) % tiles_y * TR - 1 + warp;
    const int gx0 = tile % tiles_x * TC - 1 + lane;
    const bool row_in = warp < XR && gy >= 0 && gy < H;
    const int8_t* xrow = x + ((size_t)b * H + gy) * W * 3;
#pragma unroll
    for (int j = 0; j < X_PER_LANE; ++j) {
      const int gx = gx0 + 32 * j;
      pre[j] = 0u;
      if (row_in && lane + 32 * j < XC && gx >= 0 && gx < W) {
        const int8_t* p = xrow + (size_t)gx * 3;
        pre[j] = (uint32_t)(uint8_t)p[0] | ((uint32_t)(uint8_t)p[1] << 8) |
                 ((uint32_t)(uint8_t)p[2] << 16);
      }
    }
  };
  if (blockIdx.x < tiles) load_halo(blockIdx.x);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int y = (tile / tiles_x) % tiles_y * TR + row;
    const int c0 = tile % tiles_x * TC;
    __syncthreads();  // the last tile's reads of xs are done
    if (warp < XR) {
#pragma unroll
      for (int j = 0; j < X_PER_LANE; ++j)
        if (lane + 32 * j < XC) xs[warp * XC + lane + 32 * j] = pre[j];
    }
    __syncthreads();
    if (tile + gridDim.x < tiles) load_halo(tile + gridDim.x);
    if (y >= H) continue;

    // lane (g, t)'s bytes of pixel c0 + g: channels 8t.. of the warp's half
    int8_t* op = out + (((size_t)b * H + y) * W + c0 + g) * CH + HALF * half +
                 8 * t;
    const uint32_t* xr = xs + row * XC + g + t;
    const int npx = W - c0 - g;  // pixels of this lane's column still in W
#pragma unroll 1
    for (int m = 0; m < MT && 16 * m < W - c0; ++m) {
      const uint32_t a0[4] = {xr[0], xr[8], xr[XC], xr[XC + 8]};
      const uint32_t a1[4] = {xr[2 * XC], xr[2 * XC + 8], 0u, 0u};
      int acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0x4B400000;
        stem_mma::MmaS8::mma(acc[nt], a0, bw0[nt][0], bw0[nt][1]);
        stem_mma::MmaS8::mma(acc[nt], a1, bw1[nt], 0u);
      }
      epilogue<GUARD>(acc, sc, bs, r128, s1, exact_only, op, npx - 16 * m);
      xr += 16;
      op += 16 * CH;
    }
  }
}

}  // namespace

extern "C" int scan_conv0_s8(const int8_t* x, const int* w,
                             const float* w_scale, const float* s0,
                             const float* bias, const float* s1, int8_t* out,
                             int B, int H, int W, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return 0;
  const long long tiles =
      (long long)B * ((H + TR - 1) / TR) * ((W + TC - 1) / TC);
  if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the common path's kernel, then the guarded one: one of them exits at once
  for (auto kernel : {conv0_kernel<false>, conv0_kernel<true>}) {
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const long long fit = (long long)sms * per_sm;
    kernel<<<(int)(tiles < fit ? tiles : fit), THREADS, 0, stream>>>(
        x, w, w_scale, s0, bias, s1, out, B, H, W);
    err = cudaGetLastError();
  }
  return (int)err;
}
