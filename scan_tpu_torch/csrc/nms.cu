// Greedy (ML-)NMS over score-sorted boxes, B images per launch, any K that
// fits the bitmask in device memory.
//
// Replaces scan_tpu/ops/pallas/nms_kernel.py::nms_pallas_sorted (body
// _nms_kernel). The Pallas kernel keeps a (K, K) int32 suppression matrix
// in VMEM and runs a fori_loop over its rows on one core. Here the matrix is
// a bitmask, as in the reference's own nms.cu:
//
//   pass 1 (nms_mask_kernel): one block per (column tile, row tile, image),
//     256 threads; bit c of word mask[b][i][tile_c] is set when row
//     i = 64*tile_r + r would suppress box j = 64*tile_c + c: IoU > thr,
//     same label (ML-NMS), both boxes valid, and j > i. Four threads share
//     a row, 16 columns each, unrolled, and OR their bits by two shuffles.
//     Blocks below the diagonal (tile_c < tile_r) write nothing: the scan
//     never reads them.
//   pass 2 resolves the rows 64 at a time, one block per image, in one of
//   two scans. Each walks a chunk of 64 rows on warp 0, every lane
//   redundantly, on the diagonal words mask[64c + r][c] loaded into
//   registers first: a row is kept when its bit of the chunk's "removed"
//   word is clear, and then ORs its diagonal word in. Invalid rows and rows
//   past K start with their bit set. A step is a bit test and a predicated
//   OR on one 32-bit half: no barrier, no shared-memory round trip. The
//   bits left clear are the chunk's keep flags, which go out as one
//   coalesced pair of byte stores a lane. Then the kept rows' words right
//   of the chunk are ORed into "removed". The chunk's mask rows are staged
//   in shared memory by the whole block, double-buffered through
//   registers: the next chunk's loads are in flight while warp 0 walks
//   this one.
//     - nms_scan_small_kernel, K <= 2048 (PR 4's design): lane w of warp 0
//       holds word w of "removed" in a register (K/64 <= 32 words), and
//       each lane w > c ORs word w of the kept rows in, right after the
//       walk; a chunk's 64 rows x 32 words fit one 16 KB stage, and one
//       barrier a chunk closes it.
//     - nms_scan_kernel, any K its shared memory holds: "removed", one
//       word a chunk (1.5 KB at K = 12,000), lives in shared memory. A
//       chunk's rows are 64 x W x 8 bytes, 96 KB at K = 12,000 and more than
//       a block's 227 KB past K = 29,000, so they are staged in pieces of
//       64 rows x 64 words (32 KB), the words [c + 64p, c + 64p + 64) of
//       chunk c's rows: ceil((W - c) / 64) pieces for chunk c, only the
//       words at or right of it (the scan never reads the others). After
//       warp 0's walk of the first piece and a barrier, the whole block ORs
//       each piece's words in, 4 row groups of 16 rows, a word a thread,
//       combined by a shared-memory atomicOr; one barrier closes a piece.
//       Shared memory is 64 KB of staging + 8 W bytes, so K is limited to
//       64 x 20,863 = 1,335,232 by it; the (B, K, W) bitmask in device
//       memory (36 MB at B = 2, K = 12,000) limits it long before.
//     The two scans give equal keep masks; the small one is the faster at
//     K <= 2048 (one barrier a chunk against two, no atomics: the pieced
//     scan took 17-21% longer at K = 512-2000 on an NVIDIA H100 80GB HBM3
//     at 700 W, kernel_ab.py).
//
// What bounds it: neither bytes nor operations. K = 512 boxes are 8 KB and
// the IoU pairs are ~2 MFLOP per image; the greedy scan is K dependent
// steps, each as long as its latency, and, in the pieced scan, a barrier
// and a piece's load latency per piece, ~W / 2 + W^2 / 128 pieces an image
// (372 at K = 12,000). A step of the walk is two dependent register
// operations, with no barrier, no shared-memory round trip and no store;
// the mask pass gives each thread 16 IoUs, so that their IEEE divisions
// overlap.
//
// Labels are read as int32 or int64, so the caller casts nothing.
//
// Exactness: the keep mask must equal XLA's bit for bit. The IoU is computed
// in the order of scan_tpu.structures.boxes.box_iou, the file is compiled
// with --fmad=false (no FMA contraction), division is IEEE, and the
// threshold is compared as a float, as XLA compares in f32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kTile = 64;
constexpr int kPiece = 64;  // words a staged piece holds, of 64 rows each
constexpr int kMaskThreads = 256;
constexpr int kScanThreads = 256;
constexpr int kPieceWords = kTile * kPiece;                        // 4096
constexpr int kStagePerThread = kPieceWords / kScanThreads;        // 16
constexpr int kRowsPerGroup = kTile * kPiece / kScanThreads;       // 16
constexpr int kMaxWordsSmall = 32;  // nms_scan_small_kernel: K <= 2048
constexpr int kMaxKSmall = kTile * kMaxWordsSmall;
constexpr int kSmallStagePerThread = kTile * kMaxWordsSmall / kScanThreads;  // 8
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90
constexpr int kMaxWords = (kMaxSmem - 2 * kPieceWords * 8) / 8 - 1;

// 256 threads: thread (r, q) = (tid / 4, tid % 4) tests row r against the
// 16 columns 16q .. 16q + 15; the four partial words of a row are ORed by
// two shuffles.
template <typename L>
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float* __restrict__ boxes,
                const uint8_t* __restrict__ valid,
                const L* __restrict__ labels, int K, int words, float thr,
                float off, u64* __restrict__ mask) {
  const int tile_c = blockIdx.x;
  const int tile_r = blockIdx.y;
  if (tile_c < tile_r) return;  // every column precedes every row
  const int b = blockIdx.z;
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int i = tile_r * kTile + r;

  __shared__ float4 cb[kTile];
  __shared__ L cl[kTile];
  __shared__ uint8_t cv[kTile];
  const int j0 = tile_c * kTile;
  if (threadIdx.x < kTile) {
    const int j = j0 + threadIdx.x;
    const bool in = j < K;  // columns past K: invalid
    cb[threadIdx.x] = in ? reinterpret_cast<const float4*>(boxes)[(size_t)b * K + j]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    cl[threadIdx.x] = in && labels ? labels[(size_t)b * K + j] : L(0);
    cv[threadIdx.x] = in ? valid[(size_t)b * K + j] : 0;
  }
  __syncthreads();
  const bool row_in = i < K;
  const int ic = row_in ? i : K - 1;
  const float4 bi = reinterpret_cast<const float4*>(boxes)[(size_t)b * K + ic];
  const float area_i = (bi.z - bi.x + off) * (bi.w - bi.y + off);
  const L li = labels ? labels[(size_t)b * K + ic] : L(0);
  const bool vi = row_in && valid[(size_t)b * K + ic] != 0;
  uint32_t bits = 0u;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int c = 16 * q + k;
    const float4 bj = cb[c];
    const float area_j = (bj.z - bj.x + off) * (bj.w - bj.y + off);
    const float w = fmaxf(fminf(bi.z, bj.z) - fmaxf(bi.x, bj.x) + off, 0.f);
    const float h = fmaxf(fminf(bi.w, bj.w) - fmaxf(bi.y, bj.y) + off, 0.f);
    const float inter = w * h;
    const float iou = inter / (area_i + area_j - inter);
    const bool sup = j0 + c > i && cv[c] && cl[c] == li && iou > thr;
    bits |= (uint32_t)sup << k;
  }
  u64 word = vi ? (u64)bits << (16 * q) : 0ull;
  word |= __shfl_xor_sync(0xffffffffu, word, 1);
  word |= __shfl_xor_sync(0xffffffffu, word, 2);
  if (row_in && q == 0) mask[((size_t)b * K + i) * words + tile_c] = word;
}

// Load chunk c's mask rows (64 x words, rows past K skipped) into registers.
__device__ __forceinline__ void load_chunk(const u64* m, int c, int K,
                                           int words,
                                           u64 (&v)[kSmallStagePerThread]) {
  const int n = min(kTile, K - c * kTile) * words;
#pragma unroll
  for (int k = 0; k < kSmallStagePerThread; ++k) {
    const int q = threadIdx.x + k * kScanThreads;
    if (q < n) v[k] = m[(size_t)c * kTile * words + q];
  }
}

__device__ __forceinline__ void store_chunk(u64* rows, int c, int K,
                                            int words,
                                            const u64 (&v)[kSmallStagePerThread]) {
  const int n = min(kTile, K - c * kTile) * words;
#pragma unroll
  for (int k = 0; k < kSmallStagePerThread; ++k) {
    const int q = threadIdx.x + k * kScanThreads;
    if (q < n) rows[q] = v[k];
  }
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_small_kernel(const uint8_t* __restrict__ valid, const u64* __restrict__ mask,
                int K, int words, uint8_t* __restrict__ keep) {
  __shared__ u64 rows[2][kTile * kMaxWordsSmall];
  __shared__ uint8_t vs[kMaxKSmall];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const bool scanner = threadIdx.x < 32;
  const u64* m = mask + (size_t)b * K * words;
  const uint8_t* vb = valid + (size_t)b * K;
  uint8_t* kb = keep + (size_t)b * K;

  u64 v[kSmallStagePerThread];
  load_chunk(m, 0, K, words, v);
  for (int i = threadIdx.x; i < K; i += kScanThreads) vs[i] = vb[i];
  store_chunk(rows[0], 0, K, words, v);
  __syncthreads();

  u64 removed = 0ull;  // word `lane` of the bitset (lanes < words)
  for (int c = 0; c < words; ++c) {
    const bool more = c + 1 < words;
    if (more) load_chunk(m, c + 1, K, words, v);
    if (scanner) {
      const int i0 = c * kTile;
      const u64* rc = rows[c & 1];
      // valid rows of the chunk (rows past K are not valid)
      const bool v_lo = i0 + lane < K && vs[i0 + lane];
      const bool v_hi = i0 + 32 + lane < K && vs[i0 + 32 + lane];
      const u64 vword = (u64)__ballot_sync(0xffffffffu, v_lo) |
                        ((u64)__ballot_sync(0xffffffffu, v_hi) << 32);
      const u64 cur = __shfl_sync(0xffffffffu, removed, c) | ~vword;
      // The walk, in two 32-bit halves: a row's bits are all above it, so
      // rows 32..63 touch only the upper half. The diagonal words are
      // loaded first; a step is then a bit test and a predicated OR.
      uint32_t dlo[32], dhi[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const u64 d = rc[r * words + c];
        if (r < 32) dlo[r] = (uint32_t)d;
        dhi[r] = (uint32_t)(d >> 32);
      }
      uint32_t lo = (uint32_t)cur, hi = (uint32_t)(cur >> 32);
#pragma unroll
      for (int r = 0; r < 32; ++r)
        if (!((lo >> r) & 1u)) {
          lo |= dlo[r];
          hi |= dhi[r];
        }
#pragma unroll
      for (int r = 32; r < kTile; ++r)
        if (!((hi >> (r - 32)) & 1u)) hi |= dhi[r];
      const u64 kept = ~((u64)hi << 32 | lo);
      if (lane > c && lane < words) {
#pragma unroll
        for (int r = 0; r < kTile; ++r)
          removed |= rc[r * words + lane] & (0ull - ((kept >> r) & 1ull));
      }
      if (i0 + lane < K) kb[i0 + lane] = (uint8_t)((kept >> lane) & 1ull);
      if (i0 + 32 + lane < K)
        kb[i0 + 32 + lane] = (uint8_t)((kept >> (32 + lane)) & 1ull);
    }
    if (more) store_chunk(rows[(c + 1) & 1], c + 1, K, words, v);
    __syncthreads();
  }
}

// Load piece (c, w0) -- chunk c's rows, words [w0, w0 + kPiece) -- into
// registers: element q = row * kPiece + col, a warp reads 32 consecutive
// words of one row. Rows past K and words past W read as 0.
__device__ __forceinline__ void load_piece(const u64* m, int c, int w0, int K,
                                           int words,
                                           u64 (&v)[kStagePerThread]) {
  const int rows = min(kTile, K - c * kTile);
  const int cols = min(kPiece, words - w0);
#pragma unroll
  for (int k = 0; k < kStagePerThread; ++k) {
    const int q = threadIdx.x + k * kScanThreads;
    const int r = q / kPiece, j = q % kPiece;
    v[k] = r < rows && j < cols
               ? m[(size_t)(c * kTile + r) * words + w0 + j]
               : 0ull;
  }
}

__device__ __forceinline__ void store_piece(u64* s,
                                            const u64 (&v)[kStagePerThread]) {
#pragma unroll
  for (int k = 0; k < kStagePerThread; ++k)
    s[threadIdx.x + k * kScanThreads] = v[k];
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const uint8_t* __restrict__ valid, const u64* __restrict__ mask,
                int K, int words, uint8_t* __restrict__ keep) {
  extern __shared__ u64 smem[];
  u64* stage = smem;                       // [2][kTile * kPiece]
  u64* removed = smem + 2 * kPieceWords;   // [words]
  u64* kept_s = removed + words;           // [1]: the chunk's kept rows
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const u64* m = mask + (size_t)b * K * words;
  const uint8_t* vb = valid + (size_t)b * K;
  uint8_t* kb = keep + (size_t)b * K;

  // removed starts as the invalid rows and the rows past K
  for (int c = warp; c < words; c += kScanThreads / 32) {
    const int i0 = c * kTile;
    const bool v_lo = i0 + lane < K && vb[i0 + lane];
    const bool v_hi = i0 + 32 + lane < K && vb[i0 + 32 + lane];
    const u64 vword = (u64)__ballot_sync(0xffffffffu, v_lo) |
                      ((u64)__ballot_sync(0xffffffffu, v_hi) << 32);
    if (lane == 0) removed[c] = ~vword;
  }
  u64 v[kStagePerThread];
  load_piece(m, 0, 0, K, words, v);
  store_piece(stage, v);
  __syncthreads();

  // thread (g, j): word j of the piece over the rows 16g .. 16g + 15
  const int j = threadIdx.x % kPiece, g = threadIdx.x / kPiece;
  int buf = 0;
  for (int c = 0; c < words; ++c) {
    const int pieces = (words - c + kPiece - 1) / kPiece;
    for (int p = 0; p < pieces; ++p) {
      const int nc = p + 1 < pieces ? c : c + 1;  // the next piece
      const int nw0 = p + 1 < pieces ? c + (p + 1) * kPiece : c + 1;
      const bool more = nc < words;
      if (more) load_piece(m, nc, nw0, K, words, v);
      const u64* sp = stage + buf * kPieceWords;
      if (p == 0) {
        if (warp == 0) {
          // The walk, as in nms_scan_small_kernel, on the diagonal words
          // (column 0 of the piece) and removed[c] from shared memory.
          uint32_t dlo[32], dhi[kTile];
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
            const u64 d = sp[r * kPiece];
            if (r < 32) dlo[r] = (uint32_t)d;
            dhi[r] = (uint32_t)(d >> 32);
          }
          const u64 cur = removed[c];
          uint32_t lo = (uint32_t)cur, hi = (uint32_t)(cur >> 32);
#pragma unroll
          for (int r = 0; r < 32; ++r)
            if (!((lo >> r) & 1u)) {
              lo |= dlo[r];
              hi |= dhi[r];
            }
#pragma unroll
          for (int r = 32; r < kTile; ++r)
            if (!((hi >> (r - 32)) & 1u)) hi |= dhi[r];
          const u64 kept = ~((u64)hi << 32 | lo);
          if (lane == 0) kept_s[0] = kept;
          const int i0 = c * kTile;
          if (i0 + lane < K) kb[i0 + lane] = (uint8_t)((kept >> lane) & 1ull);
          if (i0 + 32 + lane < K)
            kb[i0 + 32 + lane] = (uint8_t)((kept >> (32 + lane)) & 1ull);
        }
        __syncthreads();
      }
      // the kept rows' words right of the chunk, into removed
      const int w = c + p * kPiece + j;
      if (w > c && w < words) {
        const u64 kept = kept_s[0] >> (g * kRowsPerGroup);
        u64 acc = 0ull;
#pragma unroll
        for (int r = 0; r < kRowsPerGroup; ++r)
          acc |= sp[(g * kRowsPerGroup + r) * kPiece + j] &
                 (0ull - ((kept >> r) & 1ull));
        if (acc) atomicOr(&removed[w], acc);
      }
      if (more) store_piece(stage + (buf ^ 1) * kPieceWords, v);
      __syncthreads();
      buf ^= 1;
    }
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Raise the scan's shared-memory limit to a block's maximum, once per
// device: above 48 KB a kernel gets dynamic shared memory only so.
static cudaError_t allow_scan_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(nms_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// The largest K the scan's shared memory holds (its bitset beside the
// staging buffers).
extern "C" int scan_nms_max_k() { return kTile * kMaxWords; }

// labels: (B, K) int32 (label_bytes 4), int64 (8), or null (0).
extern "C" int scan_nms_sorted(const float* boxes, const uint8_t* valid,
                               const void* labels, int label_bytes, int B,
                               int K, float iou_threshold, int plus_one,
                               u64* mask, uint8_t* keep, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  const int words = (K + kTile - 1) / kTile;
  if (words > kMaxWords) return (int)cudaErrorInvalidValue;
  cudaError_t err = words > kMaxWordsSmall ? allow_scan_smem() : cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  const float off = plus_one ? 1.f : 0.f;
  dim3 grid1(words, words, B);
  if (labels == nullptr || label_bytes == 4)
    nms_mask_kernel<int32_t><<<grid1, kMaskThreads, 0, stream>>>(
        boxes, valid, static_cast<const int32_t*>(labels), K, words,
        iou_threshold, off, mask);
  else if (label_bytes == 8)
    nms_mask_kernel<long long><<<grid1, kMaskThreads, 0, stream>>>(
        boxes, valid, static_cast<const long long*>(labels), K, words,
        iou_threshold, off, mask);
  else
    return (int)cudaErrorInvalidValue;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (words <= kMaxWordsSmall) {
    nms_scan_small_kernel<<<B, kScanThreads, 0, stream>>>(valid, mask, K,
                                                          words, keep);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)(2 * kPieceWords + words + 1) * sizeof(u64);
  nms_scan_kernel<<<B, kScanThreads, smem, stream>>>(valid, mask, K, words,
                                                     keep);
  return (int)cudaGetLastError();
}

// The launch floor of scan_nms_sorted: empty kernels on the same two grids.
extern "C" int scan_nms_empty(int B, int K, cudaStream_t stream) {
  if (B <= 0 || K <= 0) return 0;
  const int words = (K + kTile - 1) / kTile;
  empty_kernel<<<dim3(words, words, B), kMaskThreads, 0, stream>>>();
  empty_kernel<<<B, kScanThreads, 0, stream>>>();
  return (int)cudaGetLastError();
}
