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
// float32 (the configs' default compute dtype): both convs on the TF32
// tensor cores as 3xTF32, the same tile walk (mma.sync m16n8k8 .tf32 has
// the bf16 m16n8k16's lane layout in bytes). Every product a * b is
// a_lo b_hi + a_hi b_lo + a_hi b_hi over the split x_hi = cvt.rna.tf32(x),
// x_lo = cvt.rna.tf32(x - x_hi); the dropped a_lo b_lo is ~2^-22 relative.
// One TF32 product keeps 11 significant bits and misses the 1e-4
// tolerance the plain float32 version is held to; three keep it
// (tests/test_torch_stem_mma.py emulates both). The weights are split once
// per weight version (pack_weights); the activations at fragment load, in
// registers. The card's mma does not round its f32 sum to nearest, and
// 216 of them chained into one accumulator (72 k8 steps x 3) miss 1e-4 on
// the card; so each k8 step's three mma, the small terms first, run from a
// zero sum of their own, and one __fadd_rn adds it to the tile's sum.
// Shared memory is the design problem. A block has at most 227 KB; w1 is
// 147 KB in float32 and 295 KB as hi + lo, and the float32 conv1_1 tile is
// 18 x 34 x 256 B = 153 KB. So the tile stays resident and w1 streams
// through it in 18 chunks of one tap x 32 input channels (hi + lo, 16 KB),
// two slots double-buffered with cp.async: the next chunk loads while the
// current one multiplies, one barrier a chunk, and the stream runs on into
// the next tile's first chunk (w1 is the same for every tile); the next
// tile's halo comes by cp.async behind the GEMM as well. 153 KB tile + 36
// KB ring + 11 KB halo (float4 a pixel) + 20 KB w0 hi/lo + biases =
// 226,176 bytes. conv1_1 (K = 27 of 603, padded to 32: four k8 steps) runs
// 3xTF32 on the tensor cores too, its steps summed as conv1_2's, a warp
// taking one m16 tile x half of N at a time (78 units over 16 warps; the
// phase is latency-bound), then + b0, ReLU, zero outside the image, as
// float2 stores into the tile. The epilogue takes the max of the four f32
// sums, + b1, ReLU, and stores 8 bytes a lane, four lanes a 32-byte sector
// of the pooled NHWC output. What bounds it: 332 GFLOP of float32 work at
// (4, 800, 1344), 4.95 ms at the CUDA cores' 67 TFLOP/s, or three times it
// on the 495 TFLOP/s TF32 tensor cores, 2.01 ms.
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

using LF = bf::Layout<4>;

// conv1_1: K = the 27 (tap, channel) pairs, tap-major, padded with zero
// weights to 32: four k8 steps. In shared memory w0 is laid out per co, k8
// step s and lane column t as the four values lane (g, t) needs, (hi k,
// hi k + 4, lo k, lo k + 4) for k = 8 s + t: one 16-byte load a fragment
// pair; a co's row is padded to 80 floats so the eight lanes of a phase
// (g = 0, 1) fall on 32 banks.
constexpr int W0_K = 32;
constexpr int W0_STEPS = W0_K / 8;
constexpr int W0_ROW = 80;
// conv1_1's unit of work, a warp's at a time: one m16 tile x C11_NT n8
// tiles, so the 39 m16 tiles' work spreads over the 16 warps in 78 units
constexpr int C11_NT = 4;
constexpr int C11_PARTS = bf::NT / C11_NT;
constexpr int C11_UNITS = Y_MTILES * C11_PARTS;
// conv1_2's w1 streams in chunks of one tap x 32 input channels: 18 a
// tile, each 4 k8 steps; a chunk's co row is 128 bytes of hi and 128 of
// lo, each padded to 144 so the eight rows of an ldmatrix fall in eight
// bank groups. Two chunk slots, double-buffered with cp.async.
constexpr int CHUNK_CI = 32;
constexpr int CHUNKS = bf::TAPS * CH / CHUNK_CI;     // 18
constexpr int CHUNK_STEPS = CHUNK_CI / 8;            // 4
constexpr int WROW = CHUNK_CI * 4 + 16;              // 144 bytes
constexpr int SLOT_BYTES = 2 * CH * WROW;            // hi, lo: 18,432
constexpr int SMEM_BYTES = LF::Y_BYTES + 2 * SLOT_BYTES + X_PIX * 16 +
                           CH * W0_ROW * 4 + 2 * CH * 4 + 8 * W0_STEPS * 4;
static_assert(SMEM_BYTES <= 232448, "a block's shared memory");
static_assert(CHUNKS % 2 == 0, "chunk c always uses slot c % 2");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   bf::smem_addr(dst)),
               "l"(src));
}
// 4 bytes, or 4 zero bytes where n = 0 (src must still be a valid address)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   bf::smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x: (B, H, W, 3) f32 NHWC; w0: (2, 64, 32) f32 [hi/lo][co][tap, ci]
// (k past 26 zero); w1: (2, 64, 9, 64) f32 [hi/lo][co][tap][ci];
// b0, b1: (64,) f32; out: (B, H/2, W/2, 64) f32. hi and lo are the 3xTF32
// split of the weights (stem_kernel.py::pack_weights). Without CONV12 the
// conv1_2 main loop is left out (its sums are 0): a probe that times
// everything else.
template <bool CONV12>
__global__ void __launch_bounds__(bf::THREADS, 1)
stem_f32_kernel(const float* __restrict__ x, const float* __restrict__ w0,
                const float* __restrict__ b0, const float* __restrict__ w1,
                const float* __restrict__ b1, float* __restrict__ out, int B,
                int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ys = smem;                       // conv1_1 tile, swizzled
  unsigned char* ring = ys + LF::Y_BYTES;         // two w1 chunk slots
  float* xs = reinterpret_cast<float*>(ring + 2 * SLOT_BYTES);  // [pix][4]
  float* w0s = xs + X_PIX * 4;                    // [co][s][t][4], padded
  float* b0s = w0s + CH * W0_ROW;
  float* b1s = b0s + CH;
  int* koffs = reinterpret_cast<int*>(b1s + CH);  // [t][2 s + j]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int HP = H / 2, WP = W / 2;
  const int tiles_x = (WP + bf::TW - 1) / bf::TW;
  const int tiles_y = (HP + bf::TH - 1) / bf::TH;
  const int tiles = B * tiles_y * tiles_x;

  // w1 chunk c (tap c / 2, input channels 32 (c % 2) ..) into slot c % 2:
  // thread i copies 16 bytes of co row i / 8 of hi and the same of lo
  static_assert(CH * (CHUNK_CI / 4) == bf::THREADS, "a chunk's copies");
  const float* csrc = w1 + (size_t)(tid >> 3) * bf::TAPS * CH + (tid & 7) * 4;
  unsigned char* cdst = ring + (tid >> 3) * WROW + (tid & 7) * 16;
  auto load_chunk = [&](int c) {
    const float* src = csrc + (c >> 1) * CH + (c & 1) * CHUNK_CI;
    unsigned char* dst = cdst + (c & 1) * SLOT_BYTES;
    cp_async16(dst, src);
    cp_async16(dst + CH * WROW, src + CH * bf::TAPS * CH);
    cp_async_commit();
  };
  // the halo of a tile by cp.async, one float4 (c0, c1, c2, 0) a pixel,
  // zero outside the image (conv1_1's padding); the fourth float is
  // cleared once and never copied
  auto load_halo = [&](int tile) {
    const int b = tile / (tiles_y * tiles_x);
    const int gy0 = 2 * ((tile / tiles_x) % tiles_y * bf::TH) - 2;
    const int gx0 = 2 * (tile % tiles_x * bf::TW) - 2;
    const float* xb = x + (size_t)b * H * W * 3;
    for (int i = tid; i < X_PIX; i += bf::THREADS) {
      const int gy = gy0 + i / bf::XC, gx = gx0 + i % bf::XC;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* p = in ? xb + ((size_t)gy * W + gx) * 3 : x;
#pragma unroll
      for (int c = 0; c < 3; ++c) cp_async4(xs + 4 * i + c, p + c, in ? 4 : 0);
    }
  };
  for (int i = tid; i < X_PIX; i += bf::THREADS) xs[4 * i + 3] = 0.f;
  if (blockIdx.x < tiles) {
    load_halo(blockIdx.x);
    if (CONV12) load_chunk(0);  // commits the halo's copies too
    else cp_async_commit();
  }
  for (int i = tid; i < 2 * CH * W0_K; i += bf::THREADS) {
    // i = ((co * 4 + s) * 4 + t) * 4 + j: hi (j < 2) or lo of k = 8 s + t
    // + 4 (j & 1)
    const int j = i & 3, t4 = (i >> 2) & 3, s4 = (i >> 4) & 3, co = i >> 6;
    w0s[co * W0_ROW + (i & 63)] =
        w0[((j >> 1) * CH + co) * W0_K + 8 * s4 + t4 + 4 * (j & 1)];
  }
  if (tid < CH) {
    b0s[tid] = b0[tid];
    b1s[tid] = b1[tid];
  }
  // conv1_1 A: koffs[t][2 s + j] is the float offset in the halo of k = 8 s
  // + 4 j + t, tap k / 3 and channel k % 3 (k past 26 reads the pixel
  // itself; its weight is 0): a table, so the offsets take no registers
  if (tid < 4 * 2 * W0_STEPS) {
    const int k = 8 * ((tid & 7) >> 1) + 4 * (tid & 1) + (tid >> 3);
    const int tap = k / 3;
    koffs[tid] = k < 27 ? 4 * ((tap / 3) * bf::XC + tap % 3) + k % 3 : 0;
  }
  // conv1_2 A: lane gives the address of row (lane & 7) + 8 ((lane >> 3) &
  // 1) of the m16 tile, in its 16-byte chunk lane >> 4 of the k8 step
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int achunk = lane >> 4;
  int pbase[bf::MT];
#pragma unroll
  for (int mt = 0; mt < bf::MT; ++mt)
    pbase[mt] = (2 * (warp >> 1) + (arow >> 3)) * bf::YC +
                16 * (warp & 1) + 8 * mt + (arow & 7);
  const uint32_t ya = bf::smem_addr(ys);
  // B: co row 16 np + 8 (lane >> 4) + (lane & 7), chunk (lane >> 3) & 1 of
  // the k8 step; lo's rows follow hi's
  const uint32_t wb = bf::smem_addr(ring) +
                      ((lane >> 4) * 8 + (lane & 7)) * WROW +
                      ((lane >> 3) & 1) * 16;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int p0 = (tile / tiles_x) % tiles_y * bf::TH;
    const int q0 = tile % tiles_x * bf::TW;
    const int gy0 = 2 * p0 - 2, gx0 = 2 * q0 - 2;  // x tile origin

    // ---- 1. the input halo tile, fetched while the last tile's conv1_2
    // ran (or before the first): wait for it. Also the barrier between the
    // last tile's conv1_2, which reads ys, and this tile's conv1_1, which
    // overwrites it. ----
    cp_async_wait_all();
    __syncthreads();

    // ---- 2. conv1_1, 3xTF32 on the tensor cores; + b0, ReLU, zero outside
    // the image; into the swizzled tile. y tile origin is (gy0 + 1,
    // gx0 + 1). ----
#pragma unroll 1
    for (int u = warp; u < C11_UNITS; u += bf::WARPS) {
      const int mt = u / C11_PARTS, nt0 = C11_NT * (u % C11_PARTS);
      int pix[2], hb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pix[h] = 16 * mt + g + 8 * h;
        const int q = min(pix[h], bf::YPIX - 1);
        hb[h] = (q / bf::YC) * bf::XC + q % bf::YC;
      }
      float acc[C11_NT][4];
#pragma unroll
      for (int k = 0; k < C11_NT; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[k][i] = 0.f;
#pragma unroll
      for (int s = 0; s < W0_STEPS; ++s) {
        const int k0 = koffs[8 * t + 2 * s], k1 = koffs[8 * t + 2 * s + 1];
        const uint32_t a[4] = {__float_as_uint(xs[4 * hb[0] + k0]),
                               __float_as_uint(xs[4 * hb[1] + k0]),
                               __float_as_uint(xs[4 * hb[0] + k1]),
                               __float_as_uint(xs[4 * hb[1] + k1])};
        uint32_t ah[4], al[4];
        bf::tf32_split(a, ah, al);
#pragma unroll
        for (int k = 0; k < C11_NT; ++k) {
          const float4 wv = reinterpret_cast<const float4*>(
              w0s + (8 * (nt0 + k) + g) * W0_ROW)[s * 4 + t];
          const uint32_t bh0 = __float_as_uint(wv.x);
          const uint32_t bh1 = __float_as_uint(wv.y);
          // the step's three products into a sum of their own, then one
          // round-to-nearest add (as conv1_2's, below)
          float d[4];
          bf::MmaTf32::mma0(d, al, bh0, bh1);
          bf::MmaTf32::mma(d, ah, __float_as_uint(wv.z),
                           __float_as_uint(wv.w));
          bf::MmaTf32::mma(d, ah, bh0, bh1);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[k][i] = __fadd_rn(acc[k][i], d[i]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (pix[h] >= bf::YPIX) continue;
        const int gy = gy0 + 1 + pix[h] / bf::YC;
        const int gx = gx0 + 1 + pix[h] % bf::YC;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int k = 0; k < C11_NT; ++k) {
          const int nt = nt0 + k, co = 8 * nt + 2 * t;
          float2 v = make_float2(0.f, 0.f);
          if (inside)
            v = make_float2(fmaxf(acc[k][2 * h] + b0s[co], 0.f),
                            fmaxf(acc[k][2 * h + 1] + b0s[co + 1], 0.f));
          *reinterpret_cast<float2*>(
              ys + bf::y_offset<4>(pix[h], 2 * nt + (t >> 1)) + 8 * (t & 1)) =
              v;
        }
      }
    }

    // conv1_1 is done with xs: the next tile's halo streams in behind this
    // tile's conv1_2 (committed with chunk 1, or at once in the probe)
    __syncthreads();
    if (tile + gridDim.x < tiles) load_halo(tile + gridDim.x);

    // ---- 3. conv1_2, 3xTF32 on the tensor cores, w1 streamed ----
    float acc[bf::MT][bf::NT][4] = {};
    if constexpr (CONV12) {
#pragma unroll 1
      for (int c = 0; c < CHUNKS; ++c) {
        // chunk c has landed and every warp is done with chunk c - 1
        cp_async_wait_all();
        __syncthreads();
        if (c + 1 < CHUNKS)
          load_chunk(c + 1);
        else if (tile + gridDim.x < tiles)
          load_chunk(0);  // the next tile's first chunk
        const int tap = c >> 1;
        const int shift = (tap / 3) * bf::YC + tap % 3;
        const uint32_t kb = wb + (c & 1) * SLOT_BYTES;
#pragma unroll
        for (int s = 0; s < CHUNK_STEPS; ++s) {
          uint32_t ah[bf::MT][4], al[bf::MT][4];
#pragma unroll
          for (int mt = 0; mt < bf::MT; ++mt) {
            uint32_t a[4];
            bf::ldsm_x4(ya + bf::y_offset<4>(pbase[mt] + shift,
                                             8 * (c & 1) + 2 * s + achunk),
                        a);
            bf::tf32_split(a, ah[mt], al[mt]);
          }
#pragma unroll
          for (int np = 0; np < bf::NT / 2; ++np) {
            uint32_t bh[4], bl[4];
            bf::ldsm_x4(kb + np * 16 * WROW + s * 32, bh);
            bf::ldsm_x4(kb + (CH + np * 16) * WROW + s * 32, bl);
            // the k8 step's three products, the small terms first, into a
            // sum of their own; then one round-to-nearest add to the tile's
#pragma unroll
            for (int mt = 0; mt < bf::MT; ++mt) {
              float d[2][4];
              bf::MmaTf32::mma0(d[0], al[mt], bh[0], bh[1]);
              bf::MmaTf32::mma0(d[1], al[mt], bh[2], bh[3]);
              bf::MmaTf32::mma(d[0], ah[mt], bl[0], bl[1]);
              bf::MmaTf32::mma(d[1], ah[mt], bl[2], bl[3]);
              bf::MmaTf32::mma(d[0], ah[mt], bh[0], bh[1]);
              bf::MmaTf32::mma(d[1], ah[mt], bh[2], bh[3]);
#pragma unroll
              for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  acc[mt][2 * np + j][i] =
                      __fadd_rn(acc[mt][2 * np + j][i], d[j][i]);
            }
          }
        }
      }
    } else {  // keep the conv1_1 tile live
      cp_async_commit();
      acc[0][0][0] = reinterpret_cast<const float*>(ys)[tid];
    }

    // ---- 4. the 2x2 max in registers and one shuffle, + b1, ReLU, 8-byte
    // stores of the pooled NHWC output (four lanes fill a 32-byte sector)
    const int P = p0 + (warp >> 1);
#pragma unroll
    for (int mt = 0; mt < bf::MT; ++mt) {
      const int Q = q0 + 8 * (warp & 1) + 4 * mt + (g >> 1);
#pragma unroll
      for (int nt = 0; nt < bf::NT; ++nt) {
        const float m0 = bf::pool_pair(acc[mt][nt][0], acc[mt][nt][2]);
        const float m1 = bf::pool_pair(acc[mt][nt][1], acc[mt][nt][3]);
        if ((nt & 1) == (g & 1) && P < HP && Q < WP) {
          const int co = 8 * nt + 2 * t;
          *reinterpret_cast<float2*>(
              out + (((size_t)b * HP + P) * WP + Q) * CH + co) =
              make_float2(fmaxf(m0 + b1s[co], 0.f),
                          fmaxf(m1 + b1s[co + 1], 0.f));
        }
      }
    }
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

template <bool CONV12>
int launch_f32(const float* x, const void* w0, const float* b0,
               const void* w1, const float* b1, void* out, int B, int H,
               int W, cudaStream_t stream) {
  const long long tiles = (long long)B * ((H / 2 + bf::TH - 1) / bf::TH) *
                          ((W / 2 + bf::TW - 1) / bf::TW);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t err = bf::persistent_grid(
      f32::stem_f32_kernel<CONV12>, f32::SMEM_BYTES, (int)tiles, &grid);
  if (err != cudaSuccess) return (int)err;
  f32::stem_f32_kernel<CONV12><<<grid, bf::THREADS, f32::SMEM_BYTES,
                                 stream>>>(
      x, static_cast<const float*>(w0), b0, static_cast<const float*>(w1), b1,
      static_cast<float*>(out), B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// The weights are stem_kernel.py::pack_weights's: b0 and b1 (64,) f32 (bf16
// values for the bf16 variant); for bf16 w0 (64, 14, 4) and w1 (64, 9, 64)
// bf16 [co][tap][ci], for float32 w0 (2, 64, 32) [hi/lo][co][tap, ci] (k
// past 26 zero) and w1 (2, 64, 9, 64) [hi/lo][co][tap][ci] f32, the
// 3xTF32 split. x: (B, H, W, 3) f32 NHWC;
// out: (B, H/2, W/2, 64) bf16 or f32.
extern "C" int scan_stem(const float* x, const void* w0, const float* b0,
                         const void* w1, const float* b1, void* out, int B,
                         int H, int W, int out_bf16, cudaStream_t stream) {
  if (B <= 0 || H / 2 <= 0 || W / 2 <= 0) return 0;
  if (out_bf16)
    return launch_bf16<true>(x, w0, b0, w1, b1, out, B, H, W, stream);
  return launch_f32<true>(x, w0, b0, w1, b1, out, B, H, W, stream);
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

// The float32 variant without its conv1_2 main loop, likewise.
extern "C" int scan_stem_f32_probe(const float* x, const void* w0,
                                   const float* b0, const void* w1,
                                   const float* b1, void* out, int B, int H,
                                   int W, cudaStream_t stream) {
  if (B <= 0 || H / 2 <= 0 || W / 2 <= 0) return 0;
  return launch_f32<false>(x, w0, b0, w1, b1, out, B, H, W, stream);
}
