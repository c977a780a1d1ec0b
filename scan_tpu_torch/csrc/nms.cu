// Greedy (ML-)NMS over score-sorted boxes, B images per launch.
//
// Replaces scan_tpu/ops/pallas/nms_kernel.py::nms_pallas_sorted (body
// _nms_kernel). The Pallas kernel keeps a (K, K) int32 suppression matrix
// in VMEM and runs a fori_loop over its rows on one core. Here the matrix is
// a bitmask, as in the reference's own nms.cu:
//
//   pass 1 (nms_mask_kernel): one block per (column tile, row tile, image),
//     64 threads; thread r sets bit c of word mask[b][i][tile_c] when row
//     i = 64*tile_r + r would suppress box j = 64*tile_c + c: IoU > thr,
//     same label (ML-NMS), both boxes valid, and j > i.
//   pass 2 (nms_scan_kernel): one warp per image walks the rows in order;
//     lane w owns word w of the "removed" bitset (K/64 <= 32 words), so a
//     kept row ORs its mask row into the bitset in one step. Mask rows are
//     staged in shared memory 64 at a time, so a step waits on no global
//     load.
//
// What bounds it: neither bytes nor operations. K = 512 boxes are 8 KB and
// the IoU pairs are ~2 MFLOP per image; the greedy scan is K dependent
// steps, each as long as its latency. The design keeps each step to
// shared-memory reads and one 32-lane OR, and runs B images side by side,
// one warp each.
//
// Exactness: the keep mask must equal XLA's bit for bit. The IoU is computed
// in the order of scan_tpu.structures.boxes.box_iou, the file is compiled
// with --fmad=false (no FMA contraction), division is IEEE, and the
// threshold is compared as a float, as XLA compares in f32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kMaxWords = 32;  // K <= 2048
constexpr int kScanChunk = 64;  // mask rows staged in shared memory at a time

__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                const int32_t* __restrict__ labels,
                                int K, int words, float thr, float off,
                                unsigned long long* __restrict__ mask) {
  const int tile_c = blockIdx.x;
  const int tile_r = blockIdx.y;
  const int b = blockIdx.z;
  const int r = threadIdx.x;
  unsigned long long* out =
      mask + ((size_t)b * K + (size_t)tile_r * kTile + r) * words + tile_c;
  const int i = tile_r * kTile + r;

  __shared__ float cb[kTile][4];
  __shared__ int cl[kTile];
  __shared__ int cv[kTile];
  const int j0 = tile_c * kTile;
  const int cols = min(kTile, K - j0);
  if (r < cols) {
    const float* bj = boxes + ((size_t)b * K + j0 + r) * 4;
    cb[r][0] = bj[0];
    cb[r][1] = bj[1];
    cb[r][2] = bj[2];
    cb[r][3] = bj[3];
    cl[r] = labels ? labels[(size_t)b * K + j0 + r] : 0;
    cv[r] = valid[(size_t)b * K + j0 + r];
  }
  __syncthreads();
  if (i >= K) return;
  if (tile_c < tile_r) {  // every column precedes every row: no bits
    *out = 0ull;
    return;
  }
  const float* bi = boxes + ((size_t)b * K + i) * 4;
  const float x1 = bi[0], y1 = bi[1], x2 = bi[2], y2 = bi[3];
  const float area_i = (x2 - x1 + off) * (y2 - y1 + off);
  const int li = labels ? labels[(size_t)b * K + i] : 0;
  const bool vi = valid[(size_t)b * K + i] != 0;
  unsigned long long bits = 0ull;
  if (vi) {
    for (int c = 0; c < cols; ++c) {
      const int j = j0 + c;
      if (j <= i || !cv[c] || cl[c] != li) continue;
      const float area_j =
          (cb[c][2] - cb[c][0] + off) * (cb[c][3] - cb[c][1] + off);
      const float w = fmaxf(fminf(x2, cb[c][2]) - fmaxf(x1, cb[c][0]) + off, 0.f);
      const float h = fmaxf(fminf(y2, cb[c][3]) - fmaxf(y1, cb[c][1]) + off, 0.f);
      const float inter = w * h;
      const float iou = inter / (area_i + area_j - inter);
      if (iou > thr) bits |= 1ull << c;
    }
  }
  *out = bits;
}

__global__ void nms_scan_kernel(const uint8_t* __restrict__ valid,
                                const unsigned long long* __restrict__ mask,
                                int K, int words, uint8_t* __restrict__ keep) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  __shared__ unsigned long long removed[kMaxWords];
  __shared__ unsigned long long rows[kScanChunk * kMaxWords];
  __shared__ uint8_t vs[kScanChunk];
  if (lane < words) removed[lane] = 0ull;
  const unsigned long long* m = mask + (size_t)b * K * words;
  for (int r0 = 0; r0 < K; r0 += kScanChunk) {
    // stage the chunk's mask rows and valid flags: one coalesced load
    // instead of a dependent global read on every step of the scan
    const int n = min(kScanChunk, K - r0);
    for (int t = lane; t < n * words; t += 32) rows[t] = m[(size_t)r0 * words + t];
    for (int t = lane; t < n; t += 32) vs[t] = valid[(size_t)b * K + r0 + t];
    __syncwarp();
    for (int r = 0; r < n; ++r) {
      const int i = r0 + r;
      const bool kept =
          vs[r] && !((removed[i / kTile] >> (i % kTile)) & 1ull);
      __syncwarp();
      if (kept && lane < words) removed[lane] |= rows[r * words + lane];
      if (lane == 0) keep[(size_t)b * K + i] = kept ? 1 : 0;
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int scan_nms_sorted(const float* boxes, const uint8_t* valid,
                               const int32_t* labels, int B, int K,
                               float iou_threshold, int plus_one,
                               unsigned long long* mask, uint8_t* keep,
                               cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  const int words = (K + kTile - 1) / kTile;
  if (words > kMaxWords) return (int)cudaErrorInvalidValue;
  const float off = plus_one ? 1.f : 0.f;
  dim3 grid1(words, words, B);
  nms_mask_kernel<<<grid1, kTile, 0, stream>>>(boxes, valid, labels, K, words,
                                               iou_threshold, off, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<B, 32, 0, stream>>>(valid, mask, K, words, keep);
  return (int)cudaGetLastError();
}
