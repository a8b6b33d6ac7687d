// Greedy same-label suppression over a score-sorted IoU matrix.
//
// Replaces the TPU kernel s2d_tpu/ops/nms.py:_nms_kernel (K4): visiting the
// candidates in index (score) order, candidate j > i is dropped when i is
// still kept, has j's label, and IoU(i, j) > threshold. Output: keep mask.
//
// What bounds it on an H100: nothing but latency. The main path's call is
// N = 50: 50 dependent steps over a 10 KB matrix. The work is too small for
// more than one block, and the steps are sequential by definition.
// Design: one block, one thread per candidate (N <= 1024); keep and the
// labels live in shared memory, and a __syncthreads() separates the steps so
// step i reads keep[i] after every earlier step's writes.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 1024;

__global__ void greedy_nms_kernel(const float* __restrict__ iou,  // (N, N)
                                  const int* __restrict__ labels,  // (N,)
                                  unsigned char* __restrict__ keep_out,
                                  int n, float threshold) {
  __shared__ int keep[kMaxN];
  __shared__ int label[kMaxN];
  const int j = threadIdx.x;
  if (j < n) {
    keep[j] = 1;
    label[j] = labels[j];
  }
  for (int i = 0; i < n; ++i) {
    __syncthreads();
    // only thread j writes keep[j], and only for j > i: no write races the
    // keep[i] read of this step
    if (j < n && j > i && keep[i] && label[j] == label[i] &&
        iou[(long long)i * n + j] > threshold)
      keep[j] = 0;
  }
  if (j < n) keep_out[j] = (unsigned char)keep[j];
}

}  // namespace

extern "C" int s2d_greedy_nms(const void* iou, const void* labels, void* keep,
                              int n, float threshold, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n > kMaxN) return (int)cudaErrorInvalidValue;
  const int threads = (n + 31) / 32 * 32;
  greedy_nms_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const float*)iou, (const int*)labels, (unsigned char*)keep, n,
      threshold);
  return (int)cudaGetLastError();
}
