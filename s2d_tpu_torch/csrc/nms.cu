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
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 1024;  // 32 lanes x 32 bits
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;  // (row, word) pairs a warp loads before it ballots
constexpr int kMaxDevices = 64;

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

__global__ void empty_kernel() {}

}  // namespace

// labels int64. N in 1..1024.
extern "C" int s2d_greedy_nms(const void* iou, const void* labels, void* keep,
                              int n, float threshold, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n > kMaxN) return (int)cudaErrorInvalidValue;
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

// An empty kernel: the device time of a launch, K4's floor (chip_smoke.py).
extern "C" int s2d_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
