// conv1_2 of the fused VGG16 stem as a tensor-core implicit GEMM, shared by
// kernel K2's bf16 variant (csrc/stem.cu) and kernel K5 (csrc/stem_int8.cu).
//
// A block owns one tile of TH x TW pooled outputs at a time, i.e. the
// OR x OC = 16 x 32 full-resolution conv1_2 outputs under it. The GEMM:
//   M = the 512 conv1_2 outputs of the tile,
//   N = 64 output channels,
//   K = 9 taps x 64 input channels = 576, tap-major.
//
// A is the conv1_1 tile, YR x YC = 18 x 34 pixels, in shared memory, pixel
// major with the 64 channels of a pixel contiguous (128 B in bf16, 64 B in
// s8). For tap (ky, kx) the A rows are the same tile shifted by (ky, kx):
// no im2col is built, each lane of an ldmatrix gives its own row address.
// The 16-byte chunks of a pixel are swizzled by the pixel index, so the
// eight rows of an ldmatrix (eight neighbouring pixels) hit eight different
// bank groups:
//   bf16 (8 chunks a pixel): chunk ^ (pixel & 7)
//   f32 (16 chunks a pixel, K2's float32 variant): chunk ^ (pixel & 7)
//   s8   (4 chunks a pixel): chunk ^ ((pixel >> 1) & 3)
//
// B is w1, packed once per weight version as [co][tap][ci] so K is
// contiguous and ldmatrix without .trans gives the B fragments. It stays in
// shared memory for the block's whole life (the grid is persistent, about
// one block per SM), each co row padded by 16 B so the eight rows of an
// ldmatrix fall in eight bank groups.
//
// Rows of an m16 tile are two full-resolution rows x 8 columns: rows 0-7 are
// output row 2p, rows 8-15 row 2p+1. Lane (g = lane/4, t = lane%4) then
// holds, for n8 tile nt, acc[0..1] at (2p, col g) and acc[2..3] at
// (2p+1, col g), channels 8nt+2t and 8nt+2t+1: the vertical half of the
// 2x2 pool is in the thread, the horizontal half one __shfl_xor(4) away.
//
// 16 warps; warp w owns output rows 2(w/2), 2(w/2)+1 and columns
// 16(w%2) .. 16(w%2)+15 (two m16 tiles) x all 64 channels: 64 accumulators
// a thread. Per 32 bytes of K a warp loads 2 A and 4 B fragments (x4) and
// issues 16 mma.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace stem_mma {

constexpr int TH = 8, TW = 16;            // pooled outputs per tile
constexpr int OR = 2 * TH, OC = 2 * TW;   // conv1_2 outputs per tile
constexpr int YR = OR + 2, YC = OC + 2;   // conv1_1 tile
constexpr int YPIX = YR * YC;             // 612
constexpr int XR = OR + 4, XC = OC + 4;   // input halo tile
constexpr int CH = 64, TAPS = 9;
constexpr int WARPS = 16, THREADS = WARPS * 32;
constexpr int MT = 2;                     // m16 tiles a warp
constexpr int NT = CH / 8;                // n8 tiles
constexpr int WARP_POOLED = MT * 4;       // pooled outputs a warp stores

static_assert(WARPS * MT * 16 == OR * OC, "warps cover the tile");

// EB: bytes an element (4 for f32, 2 for bf16, 1 for s8)
template <int EB>
struct Layout {
  static constexpr int PIX_BYTES = CH * EB;          // one conv1_1 pixel
  static constexpr int PIX_CHUNKS = PIX_BYTES / 16;  // 8 or 4
  static constexpr int STEPS = PIX_BYTES / 32;       // K steps a tap: 4 or 2
  static constexpr int W_ROW = TAPS * PIX_BYTES;     // one co of w1 (global)
  static constexpr int W_STRIDE = W_ROW + 16;        // one co of w1 (shared)
  static constexpr int W_BYTES = CH * W_STRIDE;
  static constexpr int Y_BYTES = YPIX * PIX_BYTES;
  static constexpr int OUT_STRIDE = PIX_BYTES + 16;  // staged pooled pixel
  static constexpr int OUT_BYTES = WARPS * WARP_POOLED * OUT_STRIDE;
};

// Byte offset of 16-byte chunk c of pixel p in the swizzled conv1_1 tile.
// A pixel of 8 chunks or more (bf16, f32) xors the chunk's low 3 bits with
// p & 7; one of 4 (s8) spans half a 128-byte group, so pixels go in pairs.
template <int EB>
__device__ __forceinline__ int y_offset(int p, int c) {
  constexpr int PC = Layout<EB>::PIX_CHUNKS;
  constexpr int PER = PC >= 8 ? 1 : 8 / PC;       // pixels a swizzle step
  constexpr int MASK = PC >= 8 ? 7 : PC - 1;
  return p * (PC * 16) + ((c ^ ((p / PER) & MASK)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

struct MmaBf16 {
  static constexpr int EB = 2;
  using Acc = float;
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

struct MmaS8 {
  static constexpr int EB = 1;
  using Acc = int;
  static __device__ __forceinline__ void mma(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// K2's float32 variant, 3xTF32: m16n8k8 on TF32 operands (the float bits
// with their low 13 bits zero), f32 sums. Same A, B and C lane layout in
// bytes as MmaBf16's, so the tile walk above carries over: a k8 step is 32
// bytes of K.
struct MmaTf32 {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  // d = a b, from zero sums (no register to clear)
  static __device__ __forceinline__ void mma0(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
  }
};

// x rounded to TF32, to nearest with ties away from zero (cvt.rna): the
// float's bits with the low 13 zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split of an A fragment: hi = tf32(a), lo = tf32(a - hi) (the
// difference is exact).
__device__ __forceinline__ void tf32_split(const uint32_t (&a)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = __uint_as_float(a[i]);
    hi[i] = tf32_rna(v);
    lo[i] = tf32_rna(__fsub_rn(v, __uint_as_float(hi[i])));
  }
}

// Copy the packed w1 ([co][tap][ci], W_ROW bytes a co) into its padded
// shared layout. Called once per block.
template <int EB>
__device__ __forceinline__ void load_w1(unsigned char* ws, const void* w1) {
  using L = Layout<EB>;
  constexpr int CHUNKS = L::W_ROW / 16;
  const int4* src = static_cast<const int4*>(w1);
  for (int i = threadIdx.x; i < CH * CHUNKS; i += THREADS) {
    const int co = i / CHUNKS, c = i % CHUNKS;
    *reinterpret_cast<int4*>(ws + co * L::W_STRIDE + c * 16) = src[i];
  }
}

// The tile's conv1_2 sums for this warp: acc[mt][nt][4] as described above.
template <class Op>
__device__ __forceinline__ void conv12(const unsigned char* ys,
                                       const unsigned char* ws,
                                       typename Op::Acc (&acc)[MT][NT][4]) {
  using L = Layout<Op::EB>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  // A: lane gives the address of row (lane & 7) + 8 ((lane >> 3) & 1) of
  // the m16 tile, in its 16-byte chunk lane >> 4 of the 32-byte K step.
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int achunk = lane >> 4;
  int pbase[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    pbase[mt] = (2 * (warp >> 1) + (arow >> 3)) * YC +
                16 * (warp & 1) + 8 * mt + (arow & 7);
  // B: matrices (n8 tile 2np, 2np+1) x (chunk 0, 1) of the K step; lane
  // gives co row 16 np + 8 (lane >> 4) + (lane & 7), chunk (lane >> 3) & 1.
  const uint32_t ya = smem_addr(ys);
  const uint32_t wb = smem_addr(ws) +
                      ((lane >> 4) * 8 + (lane & 7)) * L::W_STRIDE +
                      ((lane >> 3) & 1) * 16;

#pragma unroll 1
  for (int tap = 0; tap < TAPS; ++tap) {
    const int shift = (tap / 3) * YC + tap % 3;
#pragma unroll
    for (int s = 0; s < L::STEPS; ++s) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(ya + y_offset<Op::EB>(pbase[mt] + shift, 2 * s + achunk),
                a[mt]);
      const uint32_t kb = wb + (tap * L::STEPS + s) * 32;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(kb + np * 16 * L::W_STRIDE, b);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          Op::mma(acc[mt][2 * np], a[mt], b[0], b[1]);
          Op::mma(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
}

// 2x2 max: the two rows in the thread, then the neighbouring column.
__device__ __forceinline__ float pool_pair(float top, float bottom) {
  const float v = fmaxf(top, bottom);
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}
__device__ __forceinline__ int pool_pair(int top, int bottom) {
  const int v = max(top, bottom);
  return max(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

// Store the warp's WARP_POOLED staged pooled pixels (pooled row `prow`,
// columns pcol0 .. pcol0 + WARP_POOLED - 1 of the image) as 16-byte stores.
template <int EB>
__device__ __forceinline__ void store_staged(const unsigned char* stage,
                                             unsigned char* out, int b,
                                             int prow, int pcol0, int HP,
                                             int WP) {
  using L = Layout<EB>;
  constexpr int PC = L::PIX_CHUNKS;
  const int lane = threadIdx.x & 31;
  __syncwarp();
  if (prow >= HP) return;
#pragma unroll
  for (int q = lane; q < WARP_POOLED * PC; q += 32) {
    const int px = q / PC, c = q % PC;
    const int Q = pcol0 + px;
    if (Q < WP)
      *reinterpret_cast<int4*>(
          out + (((size_t)b * HP + prow) * WP + Q) * L::PIX_BYTES + c * 16) =
          *reinterpret_cast<const int4*>(stage + px * L::OUT_STRIDE + c * 16);
  }
}

// Persistent grid: about as many blocks as fit on the card at once.
template <class Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int smem, int tiles,
                                   int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = tiles < sms * per_sm ? tiles : sms * per_sm;
  return cudaSuccess;
}

}  // namespace stem_mma
