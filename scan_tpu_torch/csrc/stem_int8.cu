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
// Mosaic devices; this kernel keeps what they were for: the full-resolution
// conv1_1 and conv1_2 outputs never reach device memory, and conv1_2 runs on
// the matrix unit (here the tensor cores).
//
// A persistent block (512 threads, about one per SM) keeps the packed w1 in
// shared memory and walks over 8 x 16 tiles of pooled outputs; it is kernel
// K2's bf16 tile (csrc/stem.cu) in s8:
//   1. the 20 x 36 input halo goes to shared memory as one word a pixel,
//      bytes (c0, c1, c2, 0), zero outside the image;
//   2. conv1_1 over the 18 x 34 x 64 tile that conv1_2 reads: nine __dp4a
//      an output on the CUDA cores, the f32 epilogue and requant at s1,
//      then every position outside the image is forced to 0, because
//      conv1_2 must see zero padding there and bias + ReLU would not give
//      it (stem_int8_kernel.py:118-125). A thread item is one pixel x 16
//      channels, stored as one 16-byte chunk of the swizzled pixel-major
//      tile;
//   3. conv1_2 as the implicit GEMM of csrc/stem_mma.cuh, mma.sync
//      m16n8k32 s8 -> s32; s32 sums are exact in any order;
//   4. the epilogue takes the max of the four s32 sums first and requantizes
//      once. That equals requantizing all four and taking the max, as the
//      TPU kernel does, because each step of the epilogue (the exact int to
//      float conversion, the product by a1 > 0, the sum, the division by
//      s_out > 0, rintf, the clip) is non-decreasing. Each warp stages its
//      eight pooled pixels and writes each lane's 16 bytes as one store.
// Every float step runs in scan_tpu's order, one rounding each: the build
// passes --fmad=false and uses IEEE division; rintf rounds half to even.
//
// What bounds it: operations. At (8, 800, 1344) it does 664 GOP of int8
// work (conv1_2 is 634), 0.34 ms at the 1979 TOP/s tensor-core peak,
// against 26 MB in and 138 MB out.

#include <cstdint>
#include <cuda_runtime.h>

#include "stem_mma.cuh"

namespace {

namespace sm = stem_mma;
using L = sm::Layout<1>;

constexpr int CH = sm::CH;
constexpr int XWORDS = sm::XR * sm::XC;
constexpr int SMEM_BYTES = L::W_BYTES + L::Y_BYTES + L::OUT_BYTES +
                           (XWORDS + 9 * CH + 4 * CH) * 4;
constexpr int PIX_PAD = 640;  // conv1_1 pixels, padded to a multiple of 32
static_assert(sm::YPIX <= PIX_PAD, "conv1_1 pixels");
static_assert((PIX_PAD * L::PIX_CHUNKS) % sm::THREADS == 0, "conv1_1 passes");

// clip(rint(v / s), 0, 127) for s > 0. Where v <= 0 (or NaN) that is 0
// whatever the quotient, so the division, the costliest step, is skipped
// there; elsewhere every step is the plain version's.
__device__ __forceinline__ float requant_pos(float v, float s) {
  return v > 0.f ? fminf(rintf(v / s), 127.f) : 0.f;
}

__device__ __forceinline__ float requant(int acc, float a, float b, float s) {
  float v = (float)acc * a;
  v = v + b;
  return requant_pos(fmaxf(v, 0.f), s);
}

// Without CONV12 the conv1_2 main loop is left out (the sums are 0): a probe
// that times everything else.
template <bool CONV12>
__global__ void __launch_bounds__(sm::THREADS, 1)
stem_int8_kernel(const int8_t* __restrict__ x, const int* __restrict__ w0,
                 const void* __restrict__ w1, const float* __restrict__ a0,
                 const float* __restrict__ b0, const float* __restrict__ a1,
                 const float* __restrict__ b1, const float* __restrict__ s1p,
                 const float* __restrict__ sop, int8_t* __restrict__ out,
                 int B, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ws = smem;                        // w1, padded rows
  unsigned char* ys = ws + L::W_BYTES;             // conv1_1 tile, swizzled
  unsigned char* stage = ys + L::Y_BYTES;          // pooled outputs, per warp
  int* xs = reinterpret_cast<int*>(stage + L::OUT_BYTES);  // [XR][XC]
  int* w0s = xs + XWORDS;                          // [tap][co]
  float* a0s = reinterpret_cast<float*>(w0s + 9 * CH);
  float* b0s = a0s + CH;
  float* a1s = b0s + CH;
  float* b1s = a1s + CH;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int HP = H / 2, WP = W / 2;
  const int tiles_x = (WP + sm::TW - 1) / sm::TW;
  const int tiles_y = (HP + sm::TH - 1) / sm::TH;
  const int tiles = B * tiles_y * tiles_x;

  sm::load_w1<1>(ws, w1);
  for (int i = tid; i < 9 * CH; i += sm::THREADS) w0s[i] = w0[i];
  if (tid < CH) {
    a0s[tid] = a0[tid];
    b0s[tid] = b0[tid];
    a1s[tid] = a1[tid];
    b1s[tid] = b1[tid];
  }
  const float s1 = *s1p, so = *sop;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int p0 = (tile / tiles_x) % tiles_y * sm::TH;
    const int q0 = tile % tiles_x * sm::TW;
    const int gy0 = 2 * p0 - 2, gx0 = 2 * q0 - 2;  // x tile origin

    // ---- 1. input halo ----
    const int8_t* xb = x + (size_t)b * H * W * 3;
    for (int i = tid; i < XWORDS; i += sm::THREADS) {
      const int gy = gy0 + i / sm::XC, gx = gx0 + i % sm::XC;
      uint32_t v = 0u;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int8_t* p = xb + ((size_t)gy * W + gx) * 3;
        v = (uint32_t)(uint8_t)p[0] | ((uint32_t)(uint8_t)p[1] << 8) |
            ((uint32_t)(uint8_t)p[2] << 16);
      }
      xs[i] = (int)v;
    }
    // Also the barrier between the last tile's conv1_2, which reads ys, and
    // this tile's conv1_1, which overwrites it.
    __syncthreads();

    // ---- 2. conv1_1 + requant at s1; y tile origin is (gy0 + 1, gx0 + 1).
    // The chunk is warp-uniform, so the w0 loads are broadcasts. ----
    for (int i = tid; i < PIX_PAD * L::PIX_CHUNKS; i += sm::THREADS) {
      const int chunk = i / PIX_PAD, pix = i % PIX_PAD;
      if (pix >= sm::YPIX) continue;
      const int row = pix / sm::YC, col = pix % sm::YC;
      const int gy = gy0 + 1 + row, gx = gx0 + 1 + col;
      uint32_t word[4] = {0u, 0u, 0u, 0u};
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        int v[9];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
            v[ky * 3 + kx] = xs[(row + ky) * sm::XC + col + kx];
        int acc[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[j] = 0;
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int4* wp =
              reinterpret_cast<const int4*>(w0s + t * CH + chunk * 16);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int4 wv = wp[k];
            acc[4 * k] = __dp4a(v[t], wv.x, acc[4 * k]);
            acc[4 * k + 1] = __dp4a(v[t], wv.y, acc[4 * k + 1]);
            acc[4 * k + 2] = __dp4a(v[t], wv.z, acc[4 * k + 2]);
            acc[4 * k + 3] = __dp4a(v[t], wv.w, acc[4 * k + 3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int co = chunk * 16 + j;
          const float q = requant(acc[j], a0s[co], b0s[co], s1);
          word[j / 4] |= ((uint32_t)(int)q) << (8 * (j % 4));
        }
      }
      *reinterpret_cast<uint4*>(ys + sm::y_offset<1>(pix, chunk)) =
          make_uint4(word[0], word[1], word[2], word[3]);
    }
    __syncthreads();

    // ---- 3. conv1_2 on the tensor cores ----
    int acc[sm::MT][sm::NT][4] = {};
    if constexpr (CONV12) {
      sm::conv12<sm::MmaS8>(ys, ws, acc);
    } else {  // keep the conv1_1 tile live
      acc[0][0][0] = ys[tid];
    }

    // ---- 4. max of the window, requant at s_out, staged, 16-byte stores
    unsigned char* st = stage + warp * sm::WARP_POOLED * L::OUT_STRIDE;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < sm::MT; ++mt) {
      const int px = 4 * mt + (g >> 1);  // staged pooled pixel
#pragma unroll
      for (int nt = 0; nt < sm::NT; ++nt) {
        const int m0 = sm::pool_pair(acc[mt][nt][0], acc[mt][nt][2]);
        const int m1 = sm::pool_pair(acc[mt][nt][1], acc[mt][nt][3]);
        if ((nt & 1) == (g & 1)) {  // lanes g, g^1 split the n8 tiles
          const int co = 8 * nt + 2 * t;
          float v0 = (float)m0 * a1s[co];
          v0 = v0 + b1s[co];
          float v1 = (float)m1 * a1s[co + 1];
          v1 = v1 + b1s[co + 1];
          const int q0v = (int)requant_pos(v0, so);
          const int q1v = (int)requant_pos(v1, so);
          *reinterpret_cast<uint16_t*>(st + px * L::OUT_STRIDE + co) =
              (uint16_t)(q0v | (q1v << 8));
        }
      }
    }
    sm::store_staged<1>(st, reinterpret_cast<unsigned char*>(out), b,
                        p0 + (warp >> 1), q0 + 8 * (warp & 1), HP, WP);
  }
}

template <bool CONV12>
int launch(const int8_t* x, const int* w0, const void* w1, const float* a0,
           const float* b0, const float* a1, const float* b1,
           const float* s1, const float* s_out, int8_t* out, int B, int H,
           int W, cudaStream_t stream) {
  const int HP = H / 2, WP = W / 2;
  if (B <= 0 || HP <= 0 || WP <= 0) return 0;
  const long long tiles = (long long)B * ((HP + sm::TH - 1) / sm::TH) *
                          ((WP + sm::TW - 1) / sm::TW);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t err = sm::persistent_grid(stem_int8_kernel<CONV12>,
                                              SMEM_BYTES, (int)tiles, &grid);
  if (err != cudaSuccess) return (int)err;
  stem_int8_kernel<CONV12><<<grid, sm::THREADS, SMEM_BYTES, stream>>>(
      x, w0, w1, a0, b0, a1, b1, s1, s_out, out, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, H, W, 3) s8 NHWC at scale s0; w0: (9, 64) words [tap][co], bytes
// (w_c0, w_c1, w_c2, 0); w1: (64, 9, 64) s8 [co][tap][ci]; a0 = s0 *
// w0_scale, b0, a1 = s1 * w1_scale, b1: (64,) f32; s1, s_out: device f32
// scalars; out: (B, H/2, W/2, 64) s8.
extern "C" int scan_stem_int8(const int8_t* x, const int* w0, const void* w1,
                              const float* a0, const float* b0,
                              const float* a1, const float* b1,
                              const float* s1, const float* s_out, int8_t* out,
                              int B, int H, int W, cudaStream_t stream) {
  return launch<true>(x, w0, w1, a0, b0, a1, b1, s1, s_out, out, B, H, W,
                      stream);
}

// The kernel without its conv1_2 main loop, same arguments: timed beside
// scan_stem_int8 to split the kernel's time. The port never calls it.
extern "C" int scan_stem_int8_probe(const int8_t* x, const int* w0,
                                    const void* w1, const float* a0,
                                    const float* b0, const float* a1,
                                    const float* b1, const float* s1,
                                    const float* s_out, int8_t* out, int B,
                                    int H, int W, cudaStream_t stream) {
  return launch<false>(x, w0, w1, a0, b0, a1, b1, s1, s_out, out, B, H, W,
                       stream);
}
