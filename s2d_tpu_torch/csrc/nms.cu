// Greedy same-label suppression over a score-sorted IoU matrix.
//
// Replaces the TPU kernel s2d_tpu/ops/nms.py:_nms_kernel (K4): visiting the
// candidates in index (score) order, candidate j > i is dropped when i is
// still kept, has j's label, and IoU(i, j) > threshold. Output: keep mask.
//
// What bounds it on an H100: latency. The main path's call is N = 50: a
// 10 KB matrix (3.1e-6 ms of bytes) and 50 dependent steps. The earlier
// kernel (one thread a candidate) paid a __syncthreads() and a global load
// of iou[i, j] on every step, ~170 ns a step.
// Design: the dependent chain runs on bits in registers.
//   1. The 32 warps of the block take (row i, 32 columns) pairs in turn,
//      4 at a time (their loads all in flight before the first ballot), and
//      build row i's suppression bits with one coalesced 128-byte load and
//      one __ballot_sync: bit j set when j > i, label j equals label i and
//      IoU(i, j) > threshold. The rows go to shared memory, N x ceil(N / 32)
//      words (128 KB at N = 1024); at N = 50 each warp has 4 pairs or fewer.
//   2. Warp 0 walks i = 0 .. N-1 with the removed set in registers: lane w
//      holds bits 32 w .. 32 w + 31 (N <= 1024 = 32 x 32). Step i reads
//      whether i is removed from lane i / 32 by one shuffle and, when it is
//      kept, ORs its row of bits into the set: a few cycles a step and no
//      block barrier.
//   3. Warp 0 writes keep[j] = not removed.
// Labels are read as int64, the type the postprocess hands over, so the
// wrapper converts nothing.
//
// Past 1024 candidates (box NMS: the TTA merge pools up to 1800 at the
// CutLER defaults; up to kLargeMaxN = 4096) the rows no longer fit in shared
// memory (4096 x 128 words = 2 MB) and the removed set no longer fits one
// word a lane; and from about a hundred candidates on, the one block's
// first phase (one SM reading the whole IoU, its loads in flight a few at a
// time) makes the one-block kernel the slower, 7.6x at the RPN's N = 1000
// on an H100 (PERF.md, K4's row). The wrapper takes this path from
// WALK_FROM (128) candidates on (ops/nms.py), two kernels:
//   A. suppression_bits_kernel, a grid of blocks: the same ballots, written
//      to a scratch matrix in global memory (N x WP words, WP = W rounded up
//      to 4 so a row is whole uint4s), from which the walk reads; the IoU is
//      read once by the whole card instead of one SM.
//   B. greedy_walk_kernel, one warp: lane L holds words 4L .. 4L+3 of the
//      removed set (128 words, 4096 bits). The rows come in chunks of 32 (the
//      candidates of one word) by cp.async into shared memory, the next
//      chunk's copies in flight while the warp walks this one (a load a step
//      from global memory left the walk waiting on its latency). The walk
//      needs no shuffle a step and no branch: at the start of word q
//      one shuffle hands every lane the owner's word q ("cur"); every lane
//      reads row i's word q from shared memory (one broadcast), decides "i
//      kept" from cur alone and folds that word into cur, and its own 4 words
//      of row i into its part of the set. The owner's word stays equal to
//      cur.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 1024;  // 32 lanes x 32 bits
constexpr int kLargeMaxN = 4096;  // 32 lanes x 4 words x 32 bits
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;  // (row, word) pairs a warp loads before it ballots
constexpr int kMaxDevices = 64;
constexpr int kBitsThreads = 256;  // suppression_bits_kernel's block
constexpr int kBitsMaxBlocks = 1024;
constexpr int kChunk = 32;  // rows the walk stages at a time: one word of candidates

__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float* __restrict__ iou,       // (N, N)
                  const long long* __restrict__ labels,  // (N,)
                  unsigned char* __restrict__ keep_out, int n, float threshold) {
  extern __shared__ unsigned rows[];  // (N, words) suppression bits
  const int words = (n + 31) / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // (row, word) pairs in turn over the warps, kBatch at a time: a warp's
  // loads (IoU and labels, straight from global memory) are all issued
  // before its first ballot waits on one
  const int pairs = n * words;
  for (int base = warp; base < pairs; base += kWarps * kBatch) {
    bool drop[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = base + u * kWarps;
      const int i = t / words;
      const int j = 32 * (t - i * words) + lane;
      const bool in = t < pairs && j < n && j > i;
      const float v = in ? __ldg(iou + (long long)i * n + j) : 0.f;
      const long long lj = in ? __ldg(labels + j) : 0;
      const long long li = in ? __ldg(labels + i) : 0;
      drop[u] = in && lj == li && v > threshold;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = base + u * kWarps;
      const unsigned bits = __ballot_sync(0xffffffffu, drop[u]);
      if (lane == 0 && t < pairs) rows[t] = bits;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  unsigned removed = 0;  // lane w: candidates 32 w .. 32 w + 31
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    // the row's load does not wait on the walk; only the OR does
    const unsigned row = lane < words ? rows[i * words + lane] : 0u;
    const unsigned owner = __shfl_sync(0xffffffffu, removed, i >> 5);
    removed |= (owner >> (i & 31)) & 1u ? 0u : row;
  }
  for (int j0 = 0; j0 < n; j0 += 32) {  // warp-uniform: every lane reaches the shuffle
    const unsigned word = __shfl_sync(0xffffffffu, removed, j0 >> 5);
    if (j0 + lane < n) keep_out[j0 + lane] = (unsigned char)!((word >> lane) & 1u);
  }
}

// A: the ballots of greedy_nms_kernel's first phase over the whole grid,
// into bits (N x wp words; words past ceil(N / 32) are 0).
__global__ void __launch_bounds__(kBitsThreads)
suppression_bits_kernel(const float* __restrict__ iou, const long long* __restrict__ labels,
                        unsigned* __restrict__ bits, int n, int wp, float threshold) {
  const int warps = gridDim.x * (kBitsThreads / 32);
  const int warp = blockIdx.x * (kBitsThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int pairs = n * wp;
  for (int base = warp; base < pairs; base += warps * kBatch) {  // warp-uniform
    bool drop[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = base + u * warps;
      const int i = t / wp;
      const int j = 32 * (t - i * wp) + lane;
      const bool in = t < pairs && j < n && j > i;
      const float v = in ? __ldg(iou + (long long)i * n + j) : 0.f;
      const long long lj = in ? __ldg(labels + j) : 0;
      const long long li = in ? __ldg(labels + i) : 0;
      drop[u] = in && lj == li && v > threshold;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = base + u * warps;
      const unsigned word = __ballot_sync(0xffffffffu, drop[u]);
      if (lane == 0 && t < pairs) bits[t] = word;
    }
  }
}

__device__ __forceinline__ unsigned component(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// B: the greedy walk over A's rows, one warp (see the head of the file).
__global__ void __launch_bounds__(32)
greedy_walk_kernel(const unsigned* __restrict__ bits, int wp, unsigned char* __restrict__ keep_out,
                   int n) {
  __shared__ __align__(16) uint4 stage[2][kChunk][32];  // rows of two chunks, 32 KB
  const int lane = threadIdx.x;
  const int wp4 = wp / 4;
  const bool mine = lane < wp4;
  const unsigned lane_mask = mine ? 0xffffffffu : 0u;  // lanes past the row's words hold nothing
  const uint4* rows = reinterpret_cast<const uint4*>(bits);
  const int chunks = (n + kChunk - 1) / kChunk;
  // chunk c's rows, this lane's uint4 of each, copied to stage[c & 1]
  // asynchronously (cp.async: no register holds them on the way)
  auto fetch = [&](int c) {
    if (mine) {
      const int r0 = c * kChunk;
      const int rn = min(kChunk, n - r0);
      for (int r = 0; r < rn; ++r)
        __pipeline_memcpy_async(&stage[c & 1][r][lane], rows + (long long)(r0 + r) * wp4 + lane,
                                sizeof(uint4));
    }
    __pipeline_commit();
  };
  fetch(0);
  uint4 removed = make_uint4(0u, 0u, 0u, 0u);
  for (int c = 0; c < chunks; ++c) {  // chunk c: candidates of word c
    if (c + 1 < chunks) {
      fetch(c + 1);
    } else {
      __pipeline_commit();  // an empty group: one wait for every chunk
    }
    __pipeline_wait_prior(1);
    __syncwarp();  // every lane's copies of chunk c have landed
    unsigned cur = __shfl_sync(0xffffffffu, component(removed, c & 3), c >> 2);
    const uint4(*chunk)[32] = stage[c & 1];
    const int rn = min(kChunk, n - c * kChunk);
    // branch-free, so that the shared loads issue ahead of the chain: the
    // step's dependent work is cur's bit test and one OR into cur
#pragma unroll 8
    for (int r = 0; r < rn; ++r) {
      const uint4 row = chunk[r][lane];
      const unsigned diag = reinterpret_cast<const unsigned*>(chunk[r])[c];
      const unsigned kept = ((cur >> r) & 1u) - 1u;  // all ones when 32 c + r is kept
      cur |= diag & kept;
      const unsigned m = kept & lane_mask;
      removed.x |= row.x & m;
      removed.y |= row.y & m;
      removed.z |= row.z & m;
      removed.w |= row.w & m;
    }
    __syncwarp();  // read by every lane before fetch(c + 2) refills the stage
  }
  for (int j0 = 0; j0 < n; j0 += 32) {  // warp-uniform: every lane reaches the shuffle
    const int q = j0 >> 5;
    const unsigned word = __shfl_sync(0xffffffffu, component(removed, q & 3), q >> 2);
    if (j0 + lane < n) keep_out[j0 + lane] = (unsigned char)!((word >> lane) & 1u);
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Words a row of the scratch matrix of N > 1024 candidates holds.
static int scratch_row_words(int n) { return ((n + 31) / 32 + 3) / 4 * 4; }

// labels int64. N in 1..4096. With scratch (s2d_greedy_nms_scratch_words(N)
// 32-bit words, 16-byte aligned) the two-kernel path runs, without it the
// one-block kernel (N <= 1024).
extern "C" int s2d_greedy_nms(const void* iou, const void* labels, void* scratch, void* keep,
                              int n, float threshold, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n > kLargeMaxN || (scratch == nullptr && n > kMaxN)) return (int)cudaErrorInvalidValue;
  if (scratch != nullptr) {
    const int wp = scratch_row_words(n);
    const int per_block = (kBitsThreads / 32) * kBatch;
    int blocks = (n * wp + per_block - 1) / per_block;
    if (blocks > kBitsMaxBlocks) blocks = kBitsMaxBlocks;
    suppression_bits_kernel<<<blocks, kBitsThreads, 0, (cudaStream_t)stream>>>(
        (const float*)iou, (const long long*)labels, (unsigned*)scratch, n, wp, threshold);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    greedy_walk_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
        (const unsigned*)scratch, wp, (unsigned char*)keep, n);
    return (int)cudaGetLastError();
  }
  const size_t bytes = (size_t)n * ((n + 31) / 32) * sizeof(unsigned);
  if (bytes > 48 * 1024) {  // above the default: opt in once per device
    static bool opted[kMaxDevices] = {};
    int device = 0;
    cudaGetDevice(&device);
    if (device >= kMaxDevices || !opted[device]) {
      const cudaError_t err = cudaFuncSetAttribute(
          greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)((size_t)kMaxN * (kMaxN / 32) * sizeof(unsigned)));
      if (err != cudaSuccess) return (int)err;
      if (device < kMaxDevices) opted[device] = true;
    }
  }
  greedy_nms_kernel<<<1, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)iou, (const long long*)labels, (unsigned char*)keep, n, threshold);
  return (int)cudaGetLastError();
}

// Scratch words of s2d_greedy_nms's two-kernel path for N candidates.
extern "C" int s2d_greedy_nms_scratch_words(int n) {
  return n > 0 && n <= kLargeMaxN ? n * scratch_row_words(n) : 0;
}

// An empty kernel: the device time of a launch, K4's floor (chip_smoke.py).
extern "C" int s2d_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
