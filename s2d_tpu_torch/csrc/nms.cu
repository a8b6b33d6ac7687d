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
// CutLER defaults) the rows no longer fit in shared
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
//
// Past 4096 candidates (box NMS at a PRE_NMS_TOPK_TEST, --num-proposals or
// TTA merge that large; JAX's box_nms takes any N) the removed set no longer
// fits the warp's registers. The walk goes in blocks of kBlock = 4096
// candidates in score order, each walked as above with the removed set of
// its own 128 words. Before block b is walked, C. walk_seed_kernel, a grid,
// seeds its removed set from A's rows of every kept candidate of the blocks
// before it: candidate j of block b starts removed when a kept candidate i <
// 4096 b has its label and IoU(i, j) > threshold, which is exactly what the
// greedy loop has removed by the time it reaches block b. The order stays
// exact; the cost is one grid pass and one walk launch a block. N <= 4096
// takes the walk's unblocked instantiation, whose code (and time) is the
// walk's before blocks.
#include <climits>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 1024;  // 32 lanes x 32 bits
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;  // (row, word) pairs a warp loads before it ballots
constexpr int kMaxDevices = 64;
constexpr int kBitsThreads = 256;  // suppression_bits_kernel's block
constexpr int kBitsMaxBlocks = 1024;
constexpr int kChunk = 32;  // rows the walk stages at a time: one word of candidates
constexpr int kBlock = 4096;  // candidates one walk launch takes: 32 lanes x 4 words x 32 bits
constexpr int kBlockWords = kBlock / 32;
constexpr int kSeedRows = 32;  // rows of earlier blocks a walk_seed_kernel block reads

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
// kBlocked (N > kBlock): candidates r0 .. r0 + min(N - r0, kBlock) - 1 (r0 a
// multiple of kBlock), lane L holding words 4L .. 4L+3 of the block's own
// words and starting from `seed` (the block's removed set, kBlockWords
// words) where there is one; else all N from an empty set, the code of the
// walk before blocks (r0 = 0 at compile time), so N <= kBlock keeps its time.
template <bool kBlocked>
__global__ void __launch_bounds__(32)
greedy_walk_kernel(const unsigned* __restrict__ bits, int wp, const unsigned* __restrict__ seed,
                   unsigned char* __restrict__ keep_out, int block_r0, int n) {
  __shared__ __align__(16) uint4 stage[2][kChunk][32];  // rows of two chunks, 32 KB
  const int lane = threadIdx.x;
  const int wp4 = wp / 4;
  const int r0 = kBlocked ? block_r0 : 0;
  const int u0 = r0 / 128;  // the block's first uint4 of a row
  const int rows_n = kBlocked ? min(n - r0, kBlock) : n;
  const bool mine = u0 + lane < wp4;
  const unsigned lane_mask = mine ? 0xffffffffu : 0u;  // lanes past the row's words hold nothing
  const uint4* rows = reinterpret_cast<const uint4*>(bits);
  const int chunks = (rows_n + kChunk - 1) / kChunk;
  // chunk c's rows, this lane's uint4 of each, copied to stage[c & 1]
  // asynchronously (cp.async: no register holds them on the way)
  auto fetch = [&](int c) {
    if (mine) {
      const int rc = c * kChunk;
      const int rn = min(kChunk, rows_n - rc);
      for (int r = 0; r < rn; ++r)
        __pipeline_memcpy_async(&stage[c & 1][r][lane],
                                rows + (long long)(r0 + rc + r) * wp4 + u0 + lane, sizeof(uint4));
    }
    __pipeline_commit();
  };
  fetch(0);
  uint4 removed = make_uint4(0u, 0u, 0u, 0u);
  if (kBlocked && seed != nullptr && mine) removed = reinterpret_cast<const uint4*>(seed)[lane];
  for (int c = 0; c < chunks; ++c) {  // chunk c: candidates of the block's word c
    if (c + 1 < chunks) {
      fetch(c + 1);
    } else {
      __pipeline_commit();  // an empty group: one wait for every chunk
    }
    __pipeline_wait_prior(1);
    __syncwarp();  // every lane's copies of chunk c have landed
    unsigned cur = __shfl_sync(0xffffffffu, component(removed, c & 3), c >> 2);
    const uint4(*chunk)[32] = stage[c & 1];
    const int rn = min(kChunk, rows_n - c * kChunk);
    // branch-free, so that the shared loads issue ahead of the chain: the
    // step's dependent work is cur's bit test and one OR into cur
#pragma unroll 8
    for (int r = 0; r < rn; ++r) {
      const uint4 row = chunk[r][lane];
      const unsigned diag = reinterpret_cast<const unsigned*>(chunk[r])[c];
      const unsigned kept = ((cur >> r) & 1u) - 1u;  // all ones when the candidate is kept
      cur |= diag & kept;
      const unsigned m = kept & lane_mask;
      removed.x |= row.x & m;
      removed.y |= row.y & m;
      removed.z |= row.z & m;
      removed.w |= row.w & m;
    }
    __syncwarp();  // read by every lane before fetch(c + 2) refills the stage
  }
  for (int j0 = 0; j0 < rows_n; j0 += 32) {  // warp-uniform: every lane reaches the shuffle
    const int q = j0 >> 5;
    const unsigned word = __shfl_sync(0xffffffffu, component(removed, q & 3), q >> 2);
    if (j0 + lane < rows_n) keep_out[r0 + j0 + lane] = (unsigned char)!((word >> lane) & 1u);
  }
}

// C: the removed set block r0 / kBlock starts from, into seed (kBlockWords
// words, zeroed before): the OR of A's rows of the kept candidates before r0,
// over the block's words. Thread t takes word t, a grid block kSeedRows rows.
__global__ void __launch_bounds__(kBlockWords)
walk_seed_kernel(const unsigned* __restrict__ bits, int wp, const unsigned char* __restrict__ keep,
                 unsigned* __restrict__ seed, int r0) {
  const int w = r0 / 32 + threadIdx.x;
  if (w >= wp) return;
  const int i0 = blockIdx.x * kSeedRows;
  const int i1 = min(i0 + kSeedRows, r0);
  unsigned acc = 0;
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const unsigned v = __ldg(bits + (long long)i * wp + w);
    acc |= keep[i] ? v : 0u;
  }
  if (acc) atomicOr(seed + threadIdx.x, acc);
}

__global__ void empty_kernel() {}

}  // namespace

// Words a row of the scratch matrix holds.
static int scratch_row_words(int n) { return ((n + 31) / 32 + 3) / 4 * 4; }

// Scratch words past the matrix: each block's seed past the first.
static long long seed_words(int n) {
  return n > kBlock ? (long long)((n + kBlock - 1) / kBlock - 1) * kBlockWords : 0;
}

// labels int64. N >= 1. With scratch (s2d_greedy_nms_scratch_words(N)
// 32-bit words, 16-byte aligned) the grid + walk path runs, without it the
// one-block kernel (N <= 1024).
extern "C" int s2d_greedy_nms(const void* iou, const void* labels, void* scratch, void* keep,
                              int n, float threshold, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (scratch == nullptr && n > kMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (scratch != nullptr) {
    const int wp = scratch_row_words(n);
    if ((long long)n * wp + seed_words(n) > INT_MAX) return (int)cudaErrorInvalidValue;
    unsigned* bits = (unsigned*)scratch;
    unsigned* seeds = bits + (long long)n * wp;
    if (n > kBlock) {
      const cudaError_t err =
          cudaMemsetAsync(seeds, 0, (size_t)seed_words(n) * sizeof(unsigned), st);
      if (err != cudaSuccess) return (int)err;
    }
    const int per_block = (kBitsThreads / 32) * kBatch;
    int blocks = (n * wp + per_block - 1) / per_block;
    if (blocks > kBitsMaxBlocks) blocks = kBitsMaxBlocks;
    suppression_bits_kernel<<<blocks, kBitsThreads, 0, st>>>(
        (const float*)iou, (const long long*)labels, bits, n, wp, threshold);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (n <= kBlock) {
      greedy_walk_kernel<false><<<1, 32, 0, st>>>(bits, wp, nullptr, (unsigned char*)keep, 0, n);
      return (int)cudaGetLastError();
    }
    for (int r0 = 0; r0 < n; r0 += kBlock) {
      const unsigned* seed = nullptr;
      if (r0 > 0) {
        unsigned* s = seeds + (long long)(r0 / kBlock - 1) * kBlockWords;
        walk_seed_kernel<<<(r0 + kSeedRows - 1) / kSeedRows, kBlockWords, 0, st>>>(
            bits, wp, (const unsigned char*)keep, s, r0);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        seed = s;
      }
      greedy_walk_kernel<true><<<1, 32, 0, st>>>(bits, wp, seed, (unsigned char*)keep, r0, n);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
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
  greedy_nms_kernel<<<1, kThreads, bytes, st>>>(
      (const float*)iou, (const long long*)labels, (unsigned char*)keep, n, threshold);
  return (int)cudaGetLastError();
}

// Scratch words of s2d_greedy_nms's grid + walk path for N candidates (0
// where they would pass 2^31 - 1).
extern "C" int s2d_greedy_nms_scratch_words(int n) {
  if (n <= 0) return 0;
  const long long words = (long long)n * scratch_row_words(n) + seed_words(n);
  return words > INT_MAX ? 0 : (int)words;
}

// An empty kernel: the device time of a launch, K4's floor (chip_smoke.py).
extern "C" int s2d_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
