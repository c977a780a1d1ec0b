// Fused VGG16 stage 1: relu(maxpool2x2(conv3x3(relu(conv3x3(x,w0)+b0),w1)+b1)).
//
// Replaces scan_tpu/ops/pallas/stem_kernel.py::fused_s2d_stem (body
// _stem_kernel). The TPU kernel's column deinterleave, sublane fold, lane
// padding, 12-tap lane concat and 4-phase output were forced by Mosaic and
// are not carried over. This kernel keeps the idea: the full-resolution
// conv1_1 and conv1_2 outputs never reach device memory.
//
// What bounds it: operations. At 800x1344 one image is 83.0 GFLOP, 79.3 of
// them in conv1_2, against 12.9 MB of fp32 input and 68.8 MB (fp32) or
// 34.4 MB (bf16) of output.
//
// bf16 (the deployment dtype): conv1_2 runs on the tensor cores, as the TPU
// kernel runs it on its matrix unit: the implicit GEMM of csrc/stem_mma.cuh,
// mma.sync m16n8k16 bf16 -> f32. A persistent block (512 threads, about one
// per SM) keeps the packed w0 and w1 in shared memory and walks over 8 x 16
// tiles of pooled outputs:
//   1. the input halo tile, 20 x 36 x 3, goes to shared memory, rounded to
//      bf16 (zero outside the image: conv1_1's padding);
//   2. conv1_1 (about 6% of the work) on the tensor cores as well, K = 27
//      padded to 48 with zero weights: on the CUDA cores it took more than
//      half of the kernel's time. f32 sums, + b0, round to bf16, ReLU, into
//      the swizzled 18 x 34 pixel-major tile that is conv1_2's A operand;
//      every value outside the image is zeroed, because conv1_2 must see
//      zero padding there (stem_kernel.py:165-176);
//   3. conv1_2 as the shared mma main loop; the 2x2 max in registers and
//      one shuffle, then + b1, ReLU and one round to bf16, staged per warp
//      and written as 16-byte stores of the pooled (B, H/2, W/2, 64) NHWC
//      output.
// The arithmetic is the plain version's step for step (x, w0, b0, w1, b1
// rounded to bf16; f32 sums; conv1_1 rounded to bf16 before conv1_2); only
// the order of conv1_2's sum differs.
//
// float32: the CUDA-core design (TF32 would break its 1e-4 tolerance), one
// block per 4 x 16 pooled tile, 256 threads; thread t owns one pooled pixel
// and 16 output channels, i.e. 64 accumulators, w1 staged 8 input channels
// at a time. Its products are explicit __fmaf_rn: the build passes
// --fmad=false for the kernels that must round like their plain versions,
// and that would split every a*b + c here into a multiply and an add.
// Ragged H and W are masked, not asserted, in both.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stem_mma.cuh"

namespace {

constexpr int CIN = 3;
constexpr int CH = 64;

// ---------------------------------------------------------------- bf16 ---

namespace bf = stem_mma;
using LB = bf::Layout<2>;

// conv1_1 as a GEMM too: M = the 612 pixels of the conv1_1 tile in runs of
// 16 (39 m16 tiles, the last one partly past the tile), N = 64, K = 9 taps
// x 4 channel slots (c0, c1, c2, 0), padded with zero taps to 48, i.e. three
// k16 steps. A pixel of the input halo is one 8-byte slot, so a lane's A
// pair (k 2t, 2t+1) is one 32-bit word of one pixel. w0 is packed as
// [co][14 taps][4] bf16 (taps 9-13 zero; 112-byte rows, which put the eight
// rows of an ldmatrix in eight bank groups).
constexpr int W0_TAPS = 14;
constexpr int W0_STRIDE = W0_TAPS * 4 * 2;              // 112 bytes a co
constexpr int W0_BYTES = CH * W0_STRIDE;
constexpr int X_PIX = bf::XR * bf::XC;                  // 720 halo pixels
constexpr int Y_MTILES = (bf::YPIX + 15) / 16;          // 39
constexpr int BF_SMEM_BYTES = LB::W_BYTES + LB::Y_BYTES + LB::OUT_BYTES +
                              X_PIX * 8 + W0_BYTES + 2 * CH * 4;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// x: (B, H, W, 3) f32 NHWC; w0: (64, 14, 4) bf16 [co][tap][ci] (taps 9-13
// and ci 3 zero); b0, b1: (64,) f32 holding bf16 values; w1: (64, 9, 64)
// bf16 [co][tap][ci]; out: (B, H/2, W/2, 64) bf16. Without CONV12 the
// conv1_2 main loop is left out (its sums are 0): a probe that times
// everything else.
template <bool CONV12>
__global__ void __launch_bounds__(bf::THREADS, 1)
stem_bf16_kernel(const float* __restrict__ x, const void* __restrict__ w0,
                 const float* __restrict__ b0, const void* __restrict__ w1,
                 const float* __restrict__ b1, __nv_bfloat16* __restrict__ out,
                 int B, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ws = smem;                       // w1, padded rows
  unsigned char* ys = ws + LB::W_BYTES;           // conv1_1 tile, swizzled
  unsigned char* stage = ys + LB::Y_BYTES;        // pooled outputs, per warp
  uint32_t* xs = reinterpret_cast<uint32_t*>(stage + LB::OUT_BYTES);
  unsigned char* w0s = reinterpret_cast<unsigned char*>(xs + 2 * X_PIX);
  float* b0s = reinterpret_cast<float*>(w0s + W0_BYTES);
  float* b1s = b0s + CH;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int HP = H / 2, WP = W / 2;
  const int tiles_x = (WP + bf::TW - 1) / bf::TW;
  const int tiles_y = (HP + bf::TH - 1) / bf::TH;
  const int tiles = B * tiles_y * tiles_x;

  bf::load_w1<2>(ws, w1);
  for (int i = tid; i < W0_BYTES / 16; i += bf::THREADS)
    reinterpret_cast<int4*>(w0s)[i] = static_cast<const int4*>(w0)[i];
  if (tid < CH) {
    b0s[tid] = b0[tid];
    b1s[tid] = b1[tid];
  }
  // conv1_1 A: the halo offset of tap 4s + 2h + t/2 (taps past 8 read tap 0;
  // their weights are 0)
  int toff[3][2];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tap = 4 * s + 2 * h + (t >> 1);
      toff[s][h] = tap < 9 ? (tap / 3) * bf::XC + tap % 3 : 0;
    }
  const uint32_t w0a = bf::smem_addr(w0s) +
                       ((lane >> 4) * 8 + (lane & 7)) * W0_STRIDE +
                       ((lane >> 3) & 1) * 16;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int p0 = (tile / tiles_x) % tiles_y * bf::TH;
    const int q0 = tile % tiles_x * bf::TW;
    const int gy0 = 2 * p0 - 2, gx0 = 2 * q0 - 2;  // x tile origin

    // ---- 1. input halo tile, one 8-byte bf16 slot (c0, c1, c2, 0) a pixel
    const float* xb = x + (size_t)b * H * W * 3;
    for (int i = tid; i < X_PIX; i += bf::THREADS) {
      const int gy = gy0 + i / bf::XC, gx = gx0 + i % bf::XC;
      uint2 v = make_uint2(0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const float* p = xb + ((size_t)gy * W + gx) * 3;
        v = make_uint2(pack_bf16x2(p[0], p[1]), pack_bf16x2(p[2], 0.f));
      }
      reinterpret_cast<uint2*>(xs)[i] = v;
    }
    // Also the barrier between the last tile's conv1_2, which reads ys, and
    // this tile's conv1_1, which overwrites it.
    __syncthreads();

    // ---- 2. conv1_1 on the tensor cores; + b0, round to bf16, ReLU, zero
    // outside the image; into the swizzled tile. y tile origin is
    // (gy0 + 1, gx0 + 1). ----
    {
      uint32_t bw[3][bf::NT][2];
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int np = 0; np < bf::NT / 2; ++np) {
          uint32_t r[4];
          bf::ldsm_x4(w0a + np * 16 * W0_STRIDE + s * 32, r);
          bw[s][2 * np][0] = r[0];
          bw[s][2 * np][1] = r[1];
          bw[s][2 * np + 1][0] = r[2];
          bw[s][2 * np + 1][1] = r[3];
        }
#pragma unroll 1
      for (int mt = warp; mt < Y_MTILES; mt += bf::WARPS) {
        int pix[2], hb[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pix[h] = 16 * mt + g + 8 * h;
          const int q = min(pix[h], bf::YPIX - 1);
          hb[h] = (q / bf::YC) * bf::XC + q % bf::YC;
        }
        float acc[bf::NT][4];
#pragma unroll
        for (int nt = 0; nt < bf::NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const uint32_t a[4] = {xs[2 * (hb[0] + toff[s][0]) + (t & 1)],
                                 xs[2 * (hb[1] + toff[s][0]) + (t & 1)],
                                 xs[2 * (hb[0] + toff[s][1]) + (t & 1)],
                                 xs[2 * (hb[1] + toff[s][1]) + (t & 1)]};
#pragma unroll
          for (int nt = 0; nt < bf::NT; ++nt)
            bf::MmaBf16::mma(acc[nt], a, bw[s][nt][0], bw[s][nt][1]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (pix[h] >= bf::YPIX) continue;
          const int gy = gy0 + 1 + pix[h] / bf::YC;
          const int gx = gx0 + 1 + pix[h] % bf::YC;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int nt = 0; nt < bf::NT; ++nt) {
            const int co = 8 * nt + 2 * t;
            uint32_t v = 0u;
            if (inside)
              v = pack_bf16x2(
                  fmaxf(bf16r(acc[nt][2 * h] + b0s[co]), 0.f),
                  fmaxf(bf16r(acc[nt][2 * h + 1] + b0s[co + 1]), 0.f));
            *reinterpret_cast<uint32_t*>(
                ys + bf::y_offset<2>(pix[h], nt) + 4 * t) = v;
          }
        }
      }
    }
    __syncthreads();

    // ---- 3. conv1_2 on the tensor cores, pool, bias, ReLU, store ----
    float acc[bf::MT][bf::NT][4] = {};
    if constexpr (CONV12) {
      bf::conv12<bf::MmaBf16>(ys, ws, acc);
    } else {  // keep the conv1_1 tile live
      acc[0][0][0] = (float)ys[tid];
    }
    unsigned char* st = stage + warp * bf::WARP_POOLED * LB::OUT_STRIDE;
#pragma unroll
    for (int mt = 0; mt < bf::MT; ++mt) {
      const int px = 4 * mt + (g >> 1);  // staged pooled pixel
#pragma unroll
      for (int nt = 0; nt < bf::NT; ++nt) {
        const float m0 = bf::pool_pair(acc[mt][nt][0], acc[mt][nt][2]);
        const float m1 = bf::pool_pair(acc[mt][nt][1], acc[mt][nt][3]);
        if ((nt & 1) == (g & 1)) {  // lanes g, g^1 split the n8 tiles
          const int co = 8 * nt + 2 * t;
          *reinterpret_cast<uint32_t*>(st + px * LB::OUT_STRIDE + co * 2) =
              pack_bf16x2(fmaxf(m0 + b1s[co], 0.f),
                          fmaxf(m1 + b1s[co + 1], 0.f));
        }
      }
    }
    bf::store_staged<2>(st, reinterpret_cast<unsigned char*>(out), b,
                        p0 + (warp >> 1), q0 + 8 * (warp & 1), HP, WP);
  }
}

// --------------------------------------------------------------- float ---

namespace f32 {

constexpr int TH = 4;        // pooled rows per block
constexpr int TW = 16;       // pooled cols per block
constexpr int XR = 2 * TH + 4, XC = 2 * TW + 4;  // input halo tile
constexpr int YR = 2 * TH + 2, YC = 2 * TW + 2;  // conv1_1 tile
constexpr int CI_CHUNK = 8;                      // w1 input channels staged
constexpr int CO_T = 16;                         // output channels per thread
constexpr int THREADS = TH * TW * (CH / CO_T);   // 256

constexpr int SMEM_BYTES =
    (CIN * XR * XC + 9 * CIN * CH + 2 * CH + CH * YR * YC + CI_CHUNK * 9 * CH) *
    4;

// x: (B, H, W, 3) NHWC; w0: (3, 3, 3, 64) as [ky][kx][ci][co];
// w1: (64, 3, 3, 64) as [ci][ky][kx][co]; out: (B, H/2, W/2, 64).
__global__ void __launch_bounds__(THREADS)
stem_f32_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                const float* __restrict__ b0, const float* __restrict__ w1,
                const float* __restrict__ b1, float* __restrict__ out, int H,
                int W) {
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
      v = xb[((size_t)gy * W + gx) * CIN + c];
    xs[(c * XR + row) * XC + col] = v;
  }
  for (int idx = tid; idx < 9 * CIN * CH; idx += THREADS) w0s[idx] = w0[idx];
  for (int idx = tid; idx < CH; idx += THREADS) {
    b0s[idx] = b0[idx];
    b1s[idx] = b1[idx];
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
            acc = __fmaf_rn(xs[(ci * XR + row + ky) * XC + col + kx],
                            w0s[((ky * 3 + kx) * CIN + ci) * CH + co], acc);
      v = fmaxf(acc + b0s[co], 0.f);
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
      w1s[idx] = w1[(size_t)c0 * 9 * CH + idx];
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
                acc[oy * 2 + ox][o] =
                    __fmaf_rn(yv, wv[o], acc[oy * 2 + ox][o]);
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
    out[base + o] = fmaxf(m, 0.f);
  }
}

}  // namespace f32

template <bool CONV12>
int launch_bf16(const float* x, const void* w0, const float* b0,
                const void* w1, const float* b1, void* out, int B, int H,
                int W, cudaStream_t stream) {
  const long long tiles = (long long)B * ((H / 2 + bf::TH - 1) / bf::TH) *
                          ((W / 2 + bf::TW - 1) / bf::TW);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t err = bf::persistent_grid(
      stem_bf16_kernel<CONV12>, BF_SMEM_BYTES, (int)tiles, &grid);
  if (err != cudaSuccess) return (int)err;
  stem_bf16_kernel<CONV12><<<grid, bf::THREADS, BF_SMEM_BYTES, stream>>>(
      x, w0, b0, w1, b1, static_cast<__nv_bfloat16*>(out), B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// The weights are stem_kernel.py::pack_weights's: b0 and b1 (64,) f32 (bf16
// values for the bf16 variant); for bf16 w0 (64, 14, 4) and w1 (64, 9, 64)
// bf16 [co][tap][ci], for float32 w0 (9, 3, 64) [tap][ci][co] and w1
// (64, 9, 64) [ci][tap][co] f32. x: (B, H, W, 3) f32 NHWC; out: (B, H/2,
// W/2, 64) bf16 or f32.
extern "C" int scan_stem(const float* x, const void* w0, const float* b0,
                         const void* w1, const float* b1, void* out, int B,
                         int H, int W, int out_bf16, cudaStream_t stream) {
  const int HP = H / 2, WP = W / 2;
  if (B <= 0 || HP <= 0 || WP <= 0) return 0;
  if (out_bf16)
    return launch_bf16<true>(x, w0, b0, w1, b1, out, B, H, W, stream);
  dim3 grid((WP + f32::TW - 1) / f32::TW, (HP + f32::TH - 1) / f32::TH, B);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      f32::stem_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      f32::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  f32::stem_f32_kernel<<<grid, f32::THREADS, f32::SMEM_BYTES, stream>>>(
      x, static_cast<const float*>(w0), b0, static_cast<const float*>(w1), b1,
      static_cast<float*>(out), H, W);
  return (int)cudaGetLastError();
}

// The bf16 variant without its conv1_2 main loop, same arguments: timed
// beside scan_stem to split the kernel's time. The port never calls it.
extern "C" int scan_stem_probe(const float* x, const void* w0,
                               const float* b0, const void* w1,
                               const float* b1, void* out, int B, int H,
                               int W, cudaStream_t stream) {
  if (B <= 0 || H / 2 <= 0 || W / 2 <= 0) return 0;
  return launch_bf16<false>(x, w0, b0, w1, b1, out, B, H, W, stream);
}
