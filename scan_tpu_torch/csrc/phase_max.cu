// Stem tail of the int8 default chain: 2x2 max-pool, ReLU and the successor's
// requant in one pass.
//
//   out = clip(rint(relu(max over the 2x2 window) / s_out), -127, 127)  (s8)
//
// Replaces scan_tpu/ops/pallas/phase_max_kernel.py::phase_max_requant (body
// _kernel). The TPU kernel reads a phase-major (B, H/2, W/2, 4C) tensor
// because its packed stride-2 conv wrote one. Here conv1_2 writes plain
// full-resolution NHWC, so the kernel reads the (B, H, W, C) conv output and
// pools it itself: no relayout copy in front of it.
//
// One thread per pooled pixel and 8 channels: four 16-byte (bf16) or two
// 16-byte (f32) loads per window position, one 8-byte store. The max and the
// ReLU are exact in float (bf16 widens exactly); the division is IEEE float32
// and the rounding is half to even (rintf), as jnp.round.
//
// What bounds it: bytes. At (8, 800, 1344, 64) bf16 it reads 1.10 GB and
// writes 0.14 GB, 0.37 ms at 3.35 TB/s; it does a few operations a byte.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
phase_max_requant_kernel(const T* __restrict__ z, const float* __restrict__ s_out,
                         int8_t* __restrict__ out, int H, int W, int C,
                         long long total) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int C8 = C / 8;
  const int HP = H / 2, WP = W / 2;
  const int c8 = (int)(idx % C8);
  long long r = idx / C8;
  const int q = (int)(r % WP);
  r /= WP;
  const int p = (int)(r % HP);
  const long long b = r / HP;

  float m[8];
  const T* base = z + (((b * H + 2 * p) * W + 2 * q) * C + c8 * 8);
  load8(base, m);
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    float v[8];
    load8(base + ((long long)(k >> 1) * W + (k & 1)) * C, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) m[i] = fmaxf(m[i], v[i]);
  }
  const float s = *s_out;
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float y = fmaxf(m[i], 0.f);
    float qv = rintf(y / s);
    qv = fminf(fmaxf(qv, -127.f), 127.f);
    packed[i / 4] |= ((uint32_t)(uint8_t)(int8_t)(int)qv) << (8 * (i % 4));
  }
  *reinterpret_cast<uint2*>(out + idx * 8) = make_uint2(packed[0], packed[1]);
}

}  // namespace

// z: (B, H, W, C) NHWC, bf16 (z_bf16 = 1) or f32; s_out: device f32 scalar;
// out: (B, H/2, W/2, C) s8. C must be a multiple of 8; the wrapper checks.
extern "C" int scan_phase_max_requant(const void* z, const float* s_out,
                                      int8_t* out, int B, int H, int W, int C,
                                      int z_bf16, cudaStream_t stream) {
  const long long total = (long long)B * (H / 2) * (W / 2) * (C / 8);
  if (total <= 0) return 0;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (z_bf16) {
    phase_max_requant_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(z), s_out, out, H, W, C, total);
  } else {
    phase_max_requant_kernel<float><<<(unsigned)blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(z), s_out, out, H, W, C, total);
  }
  return (int)cudaGetLastError();
}
