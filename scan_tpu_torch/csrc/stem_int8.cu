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
//      bytes (c0, c1, c2, 0), zero outside the image; each thread loads its
//      words of the next tile's halo into registers before conv1_2 and
//      stores them after it, so the loads' latency hides behind the GEMM;
//   2. conv1_1 over the 18 x 34 x 64 tile that conv1_2 reads, on the tensor
//      cores: mma.sync m16n8k32 s8 -> s32 in K3's fragment layout
//      (csrc/conv0.cu): M = 16 pixels of the tile in a run (39 m16 tiles,
//      the last partly past the tile), N = 64, K = 3 rows ky x 4 pixel words
//      kx (bytes c0, c1, c2, 0) = 48 bytes, padded with zero weights to 64,
//      i.e. two k32 steps. A lane's A registers are plain loads of halo
//      words; kx = 3 reads a real halo word whose weight is 0. w0 is packed
//      once per weight version as (64, 16) words [co][4 ky + kx], and B's
//      columns are permuted so that lane (g, t) holds channels 16 t ..
//      16 t + 15 of its two pixels, one 16-byte chunk of the swizzled
//      pixel-major tile. A warp takes one m16 tile x half of N at a time
//      (78 units over 16 warps): conv1_1 is latency-bound here, and the
//      smaller unit balances the warps. The requant at s1 (below), then
//      every position outside the image is forced to 0, because conv1_2
//      must see zero padding there and bias + ReLU would not give it
//      (stem_int8_kernel.py:118-125); 8 bytes a pixel from registers;
//   3. conv1_2 as the implicit GEMM of csrc/stem_mma.cuh, mma.sync
//      m16n8k32 s8 -> s32; s32 sums are exact in any order;
//   4. the epilogue takes the max of the four s32 sums first and requantizes
//      once at s_out. That equals requantizing all four and taking the max,
//      as the TPU kernel does, because each step of the epilogue (the exact
//      int to float conversion, the product by a1 > 0, the sum, the
//      quotient by s_out > 0, rint, the clip) is non-decreasing. Each warp
//      stages its eight pooled pixels and writes each lane's 16 bytes as
//      one store.
// Every float step runs in scan_tpu's order, one rounding each: the build
// passes --fmad=false; rint rounds half to even.
//
// Both requants, clip(rint(max(v, 0) / s), 0, 127), have no division per
// value. conv1_1's sums start at the bits of 1.5 * 2^23, so acc is a float
// one subtraction away (|acc| <= 27 * 128 * 127 < 2^22, as in K3); v = acc
// a + b in scan_tpu's order; p = max(v, 0) r with r = 1 / s correctly
// rounded (__frcp_rn, torch.reciprocal's value) once per launch;
// rint(min(p, 128)) by one add of 2^23. p is within q 2^-23 (1 + 2^-24) of
// q = y / s, i.e. under 2^-16 for q < 128, and the division's float is
// within 2^-17 of q, so rint(p) is the division's rint unless q lies within
// ~2^-15 of a half-integer. Where one of a thread's values has p within
// 2^-14 of one (and below 127, above which both clip to 127), the thread
// redoes its unit with the IEEE division, and only then:
// tests/test_torch_stem_int8_mma.py proves the guard over every float32 y
// that matters for seeded, round and extreme scales. Where r is not a
// normal float (s > 2^125) every value is divided.
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
// kx = 3 of the last halo row's last pixel reads one word past the halo
// (its weight is 0): the halo array is padded by a 16-byte chunk
constexpr int XWORDS_PAD = XWORDS + 4;
constexpr int W0_WORDS = 16;                         // K words a channel
// w0 in shared memory: row 8 nt + n is B's column n of n8 tile nt (channel
// 16 (n >> 1) + 2 nt + (n & 1)), 20 words a row, so lane (g, t)'s loads of
// row 8 nt + g, word t + 4 j hit 32 banks
constexpr int W0_ROW = 20;
constexpr int Y_MTILES = (sm::YPIX + 15) / 16;       // 39
// conv1_1's unit of work, a warp's at a time: one m16 tile x C11_NT n8
// tiles, so the 39 m16 tiles' work spreads over the 16 warps in 78 units
// (latency bounds conv1_1 at 16 warps an SM: smaller units balance the
// warps and hold fewer values live)
constexpr int C11_NT = 4;
constexpr int C11_PARTS = sm::NT / C11_NT;
constexpr int C11_UNITS = Y_MTILES * C11_PARTS;
constexpr int X_PER_THREAD = (XWORDS + sm::THREADS - 1) / sm::THREADS;
constexpr int SMEM_BYTES = L::W_BYTES + L::Y_BYTES + L::OUT_BYTES +
                           (XWORDS_PAD + CH * W0_ROW + 4 * CH) * 4;

// |acc| <= 27 products of |x| <= 128 and |w| <= 127 = 438,912 < 2^22: the
// magic-number conversion below is exact.
static_assert(27 * 128 * 127 < (1 << 22), "s32 -> f32 by 1.5 * 2^23");

constexpr float kMagic22 = 12582912.f;     // 1.5 * 2^23
constexpr float kMagic23 = 8388608.f;      // 2^23
constexpr float kGuard = 0.5f - 0x1p-14f;  // |p - rint(p)| at which to divide

// clip(rint(y / s), 0, 127) for y = max(v, 0) (0 for a NaN v), as the bits
// of 2^23 + byte, without a division: p = y r (r = 1 / s), rint by one add
// of 2^23. ``near`` is set where p lies within 2^-14 of a half-integer
// below 127; there the thread redoes its values with requant_exact (see
// the note above). Both requants, at s1 and at s_out, take it.
__device__ __forceinline__ uint32_t requant_fast(float v, float r,
                                                 bool& near) {
  const float p = fminf(__fmul_rn(fmaxf(v, 0.f), r), 128.f);
  const float t = __fadd_rn(p, kMagic23);  // 2^23 + rint(p), half to even
  near |= p < 127.f && fabsf(__fsub_rn(p, __fsub_rn(t, kMagic23))) >= kGuard;
  return min(__float_as_uint(t), 0x4B00007Fu);
}

// The same byte by the IEEE division.
__device__ __forceinline__ uint32_t requant_exact(float v, float s) {
  const float t =
      __fadd_rn(fminf(__fdiv_rn(fmaxf(v, 0.f), s), 128.f), kMagic23);
  return min(__float_as_uint(t), 0x4B00007Fu);
}

// conv1_1's value before the requant: acc from the bits of 1.5 * 2^23 +
// acc, then acc a0 + b0 in scan_tpu's order.
__device__ __forceinline__ float dequant1(int acc_bits, float a, float b) {
  const float y = __fsub_rn(__int_as_float(acc_bits), kMagic22);
  return __fadd_rn(__fmul_rn(y, a), b);
}

// The halo word of pixel i (row-major over XR x XC) of the tile with x
// origin (gy0, gx0): bytes (c0, c1, c2, 0), 0 outside the image.
__device__ __forceinline__ uint32_t halo_word(const int8_t* xb, int i,
                                              int gy0, int gx0, int H,
                                              int W) {
  const int gy = gy0 + i / sm::XC, gx = gx0 + i % sm::XC;
  if (i >= XWORDS || gy < 0 || gy >= H || gx < 0 || gx >= W) return 0u;
  const int8_t* p = xb + ((size_t)gy * W + gx) * 3;
  return (uint32_t)(uint8_t)p[0] | ((uint32_t)(uint8_t)p[1] << 8) |
         ((uint32_t)(uint8_t)p[2] << 16);
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
  uint32_t* xs = reinterpret_cast<uint32_t*>(stage + L::OUT_BYTES);
  int* w0s = reinterpret_cast<int*>(xs + XWORDS_PAD);  // [8 nt + n][W0_ROW]
  float* a0s = reinterpret_cast<float*>(w0s + CH * W0_ROW);
  float* b0s = a0s + CH;
  float* a1s = b0s + CH;
  float* b1s = a1s + CH;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int HP = H / 2, WP = W / 2;
  const int tiles_x = (WP + sm::TW - 1) / sm::TW;
  const int tiles_y = (HP + sm::TH - 1) / sm::TH;
  const int tiles = B * tiles_y * tiles_x;

  sm::load_w1<1>(ws, w1);
  for (int i = tid; i < CH * W0_WORDS; i += sm::THREADS) {
    const int row = i / W0_WORDS, nt = row >> 3, n = row & 7;
    w0s[row * W0_ROW + i % W0_WORDS] =
        w0[(16 * (n >> 1) + 2 * nt + (n & 1)) * W0_WORDS + i % W0_WORDS];
  }
  if (tid < CH) {
    a0s[tid] = a0[tid];
    b0s[tid] = b0[tid];
    a1s[tid] = a1[tid];
    b1s[tid] = b1[tid];
  }
  if (tid < XWORDS_PAD - XWORDS) xs[XWORDS + tid] = 0u;
  const float s1 = *s1p, so = *sop;
  // r = 1 / s, correctly rounded; s > 2^125 leaves it subnormal, where the
  // bound on |p - y / s| no longer holds: divide everywhere then
  const float r = __frcp_rn(s1), ro = __frcp_rn(so);
  const bool divide_all = !(r >= 0x1p-125f), divide_all_o = !(ro >= 0x1p-125f);
  // Column n of n8 tile nt of conv1_1's B is channel 16 (n >> 1) + 2 nt +
  // (n & 1): lane (g, t) loads column g (row 8 nt + g of w0s), and its C
  // columns 2t, 2t + 1 are channels 16 t + 2 nt, + 1.

  // each thread's words of the halo: i = tid + THREADS j
  auto tile_origin = [&](int tile, int& b, int& gy0, int& gx0) {
    b = tile / (tiles_y * tiles_x);
    gy0 = 2 * ((tile / tiles_x) % tiles_y * sm::TH) - 2;
    gx0 = 2 * (tile % tiles_x * sm::TW) - 2;
  };
  uint32_t pre[X_PER_THREAD];
  auto load_halo = [&](int tile) {
    int b, gy0, gx0;
    tile_origin(tile, b, gy0, gx0);
    const int8_t* xb = x + (size_t)b * H * W * 3;
#pragma unroll
    for (int j = 0; j < X_PER_THREAD; ++j)
      pre[j] = halo_word(xb, tid + sm::THREADS * j, gy0, gx0, H, W);
  };
  auto store_halo = [&]() {
#pragma unroll
    for (int j = 0; j < X_PER_THREAD; ++j)
      if (tid + sm::THREADS * j < XWORDS) xs[tid + sm::THREADS * j] = pre[j];
  };
  if (blockIdx.x < tiles) {
    load_halo(blockIdx.x);
    store_halo();
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int b, gy0, gx0;  // x tile origin; the y tile's is (gy0 + 1, gx0 + 1)
    tile_origin(tile, b, gy0, gx0);
    const int p0 = (gy0 + 2) / 2, q0 = (gx0 + 2) / 2;  // pooled origin
    // The halo is in xs; also the barrier between the last tile's conv1_2,
    // which reads ys, and this tile's conv1_1, which overwrites it.
    __syncthreads();

    // ---- 2. conv1_1 on the tensor cores + requant at s1, 0 outside the
    // image, into the swizzled tile ----
#pragma unroll 1
    for (int u = warp; u < C11_UNITS; u += sm::WARPS) {
      const int mt = u / C11_PARTS, part = u % C11_PARTS;
      int pix[2], hb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        pix[h] = 16 * mt + g + 8 * h;
        const int q = min(pix[h], sm::YPIX - 1);
        hb[h] = (q / sm::YC) * sm::XC + q % sm::YC + t;
      }
      // k32 step 0: words (ky 0, kx t) and (ky 1, kx t); step 1: (ky 2,
      // kx t) and ky = 3, which is 0
      const uint32_t a_0[4] = {xs[hb[0]], xs[hb[1]], xs[hb[0] + sm::XC],
                               xs[hb[1] + sm::XC]};
      const uint32_t a_1[4] = {xs[hb[0] + 2 * sm::XC],
                               xs[hb[1] + 2 * sm::XC], 0u, 0u};
      int acc[C11_NT][4];
#pragma unroll
      for (int k = 0; k < C11_NT; ++k) {
        const int* wc = w0s + (8 * (C11_NT * part + k) + g) * W0_ROW;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[k][i] = 0x4B400000;
        sm::MmaS8::mma(acc[k], a_0, wc[t], wc[4 + t]);
        sm::MmaS8::mma(acc[k], a_1, wc[8 + t], 0u);
      }
      // the lane's 2 C11_NT channels, 16 t + 2 C11_NT part .. : a0 and b0
      const int co0 = 16 * t + 2 * C11_NT * part;
      float sa[2 * C11_NT], sb[2 * C11_NT];
#pragma unroll
      for (int k = 0; k < C11_NT / 2; ++k) {
        const float4 va = reinterpret_cast<const float4*>(a0s + co0)[k];
        const float4 vb = reinterpret_cast<const float4*>(b0s + co0)[k];
        sa[4 * k] = va.x; sa[4 * k + 1] = va.y;
        sa[4 * k + 2] = va.z; sa[4 * k + 3] = va.w;
        sb[4 * k] = vb.x; sb[4 * k + 1] = vb.y;
        sb[4 * k + 2] = vb.z; sb[4 * k + 3] = vb.w;
      }
      // the lane's values: the division-free bytes, and the exact ones for
      // the thread's whole unit where one lies in the guard band
      uint32_t q[C11_NT][4];
      bool near = divide_all;
#pragma unroll
      for (int k = 0; k < C11_NT; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          q[k][i] = requant_fast(
              dequant1(acc[k][i], sa[2 * k + (i & 1)], sb[2 * k + (i & 1)]),
              r, near);
      if (near) {
#pragma unroll
        for (int k = 0; k < C11_NT; ++k)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            q[k][i] = requant_exact(
                dequant1(acc[k][i], sa[2 * k + (i & 1)], sb[2 * k + (i & 1)]),
                s1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (pix[h] >= sm::YPIX) continue;
        const int gy = gy0 + 1 + pix[h] / sm::YC;
        const int gx = gx0 + 1 + pix[h] % sm::YC;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        // two bytes a channel pair: lo + 256 hi keeps both in the low 16
        // bits (0x4B000000 * 256 wraps to 0); four a word
        uint32_t word[C11_NT / 2];
#pragma unroll
        for (int k = 0; k < C11_NT / 2; ++k)
          word[k] = inside ? __byte_perm(
                                 q[2 * k][2 * h] + q[2 * k][2 * h + 1] * 256u,
                                 q[2 * k + 1][2 * h] +
                                     q[2 * k + 1][2 * h + 1] * 256u,
                                 0x5410)
                           : 0u;
        unsigned char* dst =
            ys + sm::y_offset<1>(pix[h], t) + 2 * C11_NT * part;
        *reinterpret_cast<uint2*>(dst) = make_uint2(word[0], word[1]);
      }
    }
    __syncthreads();

    // the next tile's halo: loaded now, stored after conv1_2 (xs is read
    // only by conv1_1, which every warp has finished)
    if (tile + gridDim.x < tiles) load_halo(tile + gridDim.x);

    // ---- 3. conv1_2 on the tensor cores ----
    int acc[sm::MT][sm::NT][4] = {};
    if constexpr (CONV12) {
      sm::conv12<sm::MmaS8>(ys, ws, acc);
    } else {  // keep the conv1_1 tile live
      acc[0][0][0] = ys[tid];
    }
    if (tile + gridDim.x < tiles) store_halo();

    // ---- 4. max of the window, requant at s_out, staged, 16-byte stores.
    // Lanes g, g ^ 1 hold the same pooled sums and split the n8 tiles: the
    // lane takes nt = 2k + (g & 1). Division-free bytes first, the exact
    // ones for the thread's 16 where one lies in the guard band.
    unsigned char* st = stage + warp * sm::WARP_POOLED * L::OUT_STRIDE;
    const int odd = g & 1;
    float v[sm::MT][sm::NT / 2][2];
    uint32_t q[sm::MT][sm::NT / 2][2];
    bool near = divide_all_o;
#pragma unroll
    for (int mt = 0; mt < sm::MT; ++mt)
#pragma unroll
      for (int k = 0; k < sm::NT / 2; ++k) {
        int m[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          m[e][0] = sm::pool_pair(acc[mt][2 * k + e][0], acc[mt][2 * k + e][2]);
          m[e][1] = sm::pool_pair(acc[mt][2 * k + e][1], acc[mt][2 * k + e][3]);
        }
        const int co = 8 * (2 * k + odd) + 2 * t;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[mt][k][j] = __fadd_rn(
              __fmul_rn((float)(odd ? m[1][j] : m[0][j]), a1s[co + j]),
              b1s[co + j]);
          q[mt][k][j] = requant_fast(v[mt][k][j], ro, near);
        }
      }
    if (near) {
#pragma unroll
      for (int mt = 0; mt < sm::MT; ++mt)
#pragma unroll
        for (int k = 0; k < sm::NT / 2; ++k)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            q[mt][k][j] = requant_exact(v[mt][k][j], so);
    }
#pragma unroll
    for (int mt = 0; mt < sm::MT; ++mt) {
      const int px = 4 * mt + (g >> 1);  // staged pooled pixel
#pragma unroll
      for (int k = 0; k < sm::NT / 2; ++k)
        // lo + 256 hi keeps both bytes in the low 16 bits
        *reinterpret_cast<uint16_t*>(st + px * L::OUT_STRIDE +
                                     8 * (2 * k + odd) + 2 * t) =
            (uint16_t)(q[mt][k][0] + q[mt][k][1] * 256u);
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

// x: (B, H, W, 3) s8 NHWC at scale s0; w0: (64, 16) words [co][4 ky + kx],
// bytes (w_c0, w_c1, w_c2, 0), zero for kx = 3 or ky = 3 (K3's pack); w1:
// (64, 9, 64) s8 [co][tap][ci]; a0 = s0 * w0_scale, b0, a1 = s1 * w1_scale,
// b1: (64,) f32; s1, s_out: device f32 scalars; out: (B, H/2, W/2, 64) s8.
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
