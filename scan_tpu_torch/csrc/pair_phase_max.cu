// Stem tail of the s8-epilogue pair-conv chain: the 2x2 max-pool of an s8
// NHWC tensor whose values are already ReLU'd and requantized.
//
// Replaces scan_tpu/ops/pallas/phase_max_kernel.py::pair_phase_max_s8 (body
// _pair_kernel). On the TPU the two row-phase pair convs each write
// (B, H/2, W/2, 2C) s8 and the kernel takes the max of their four C-slices.
// Here conv1_2 is one full-resolution conv writing (B, H, W, C) s8, and the
// four phase slices are the four pixels of each 2x2 window: the same values,
// so the same max.
//
// One thread per pooled pixel and 16 channels: four 16-byte loads, a
// byte-wise signed max (__vmaxs4) on the packed words, one 16-byte store.
//
// What bounds it: bytes. At (8, 800, 1344, 64) it reads 0.55 GB and writes
// 0.14 GB, 0.21 ms at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                    __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}

__global__ void __launch_bounds__(THREADS)
pair_phase_max_kernel(const int8_t* __restrict__ z, int8_t* __restrict__ out,
                      int H, int W, int C, long long total) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int C16 = C / 16;
  const int HP = H / 2, WP = W / 2;
  const int c16 = (int)(idx % C16);
  long long r = idx / C16;
  const int q = (int)(r % WP);
  r /= WP;
  const int p = (int)(r % HP);
  const long long b = r / HP;

  const int8_t* base = z + (((b * H + 2 * p) * W + 2 * q) * C + c16 * 16);
  const uint4 a = *reinterpret_cast<const uint4*>(base);
  const uint4 b1 = *reinterpret_cast<const uint4*>(base + C);
  const uint4 c = *reinterpret_cast<const uint4*>(base + (long long)W * C);
  const uint4 d = *reinterpret_cast<const uint4*>(base + (long long)W * C + C);
  *reinterpret_cast<uint4*>(out + idx * 16) = vmax(vmax(a, b1), vmax(c, d));
}

}  // namespace

// z: (B, H, W, C) s8 NHWC; out: (B, H/2, W/2, C) s8. C must be a multiple of
// 16; the wrapper checks.
extern "C" int scan_pair_phase_max_s8(const int8_t* z, int8_t* out, int B,
                                      int H, int W, int C, cudaStream_t stream) {
  const long long total = (long long)B * (H / 2) * (W / 2) * (C / 16);
  if (total <= 0) return 0;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pair_phase_max_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      z, out, H, W, C, total);
  return (int)cudaGetLastError();
}
