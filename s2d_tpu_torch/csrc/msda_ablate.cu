// The MSDA separable-sampling ablation: four variants of one level's
// bilinear sampling, split into a row (y) pass and a column (x) pass.
//
// Replaces the TPU kernel tools/bench_pallas_ablate.py:make -> kernel (K6).
// Inputs: vt (ng, W*d, k) bf16, the value map of one level with its W
// columns times d channels as rows and its k rows as columns; per point p
// (ng, 1, gqp) the row index ya (int32), the row weights wy0/wy1 and the
// column index x0 (int32) with the column weights wx0/wx1 (f32). Output
// out (ng, d, gqp) f32:
//   empty        0
//   dotonly      bf16(wy0) vt[i, c, ya] + bf16(wy1) vt[i, c, ya+1]
//   noconstruct  0.5 vt[i, c, 0], the same for every p
//   full         sum over w of WX[p, w] (bf16(wy0) vt[i, w d + c, ya]
//                + bf16(wy1) vt[i, w d + c, ya+1]), WX = wx0 at x0 and wx1
//                at x0 + 1
// A row index outside [0, k) or a column outside [0, W) contributes 0 (the
// Pallas kernel's one-hot matrices have no such row or column). The y
// weights are rounded to bf16 (the Pallas kernel builds its one-hot matrix
// in bf16 for the MXU); the products of two bf16 values are exact in f32,
// and every product and sum is rounded on its own (__fmul_rn/__fadd_rn, no
// FMA contraction), in the order of the plain version
// (ops/msda_ablate.py), which this kernel therefore matches bit for bit.
//
// What bounds it on an H100: bytes. At the tool's defaults (ng=8, W=20,
// d=32, k=128, gqp=155,136) the output is 158.9 MB, the point arrays 29.8
// MB and vt 1.3 MB; the arithmetic is ~9 operations per output.
// Design: one thread per (i, p), p fastest across the threads, looping over
// the d channels: each point's six values are read once, and for each
// channel a warp's 32 stores are one coalesced 128-byte row. vt is read
// through the read-only cache: a warp's reads for one channel fall within
// one 256-byte row of vt (dotonly) or within the W rows of that channel
// (full), 160 KB per i, which stays in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = 0;
constexpr int kDotOnly = 1;
constexpr int kNoConstruct = 2;
constexpr int kFull = 3;

__device__ __forceinline__ float load_bf16(const unsigned short* p) {
  // bf16 -> f32 is exact: the bf16 bits are the f32's high half
  return __uint_as_float(static_cast<unsigned>(__ldg(p)) << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// bf16(wy0) row[y] + bf16(wy1) row[y + 1] over one row of vt; a row index
// outside [0, k) contributes 0
__device__ __forceinline__ float row_sum(const unsigned short* row, int y, float a0,
                                         float a1, int k) {
  const float t0 = (y >= 0 && y < k) ? __fmul_rn(a0, load_bf16(row + y)) : 0.f;
  const float t1 = (y + 1 >= 0 && y + 1 < k) ? __fmul_rn(a1, load_bf16(row + y + 1)) : 0.f;
  return __fadd_rn(t0, t1);
}

template <int kVariant>
__global__ void msda_ablate_kernel(const unsigned short* __restrict__ vt,
                                   const int* __restrict__ ya,
                                   const float* __restrict__ wy0,
                                   const float* __restrict__ wy1,
                                   const int* __restrict__ x0,
                                   const float* __restrict__ wx0,
                                   const float* __restrict__ wx1,
                                   float* __restrict__ out, int ng, int wd,
                                   int k, int gqp, int w, int d) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= static_cast<long long>(ng) * gqp) return;
  const int i = static_cast<int>(idx / gqp);
  const int p = static_cast<int>(idx - static_cast<long long>(i) * gqp);
  float* o = out + static_cast<long long>(i) * d * gqp + p;
  const unsigned short* v = vt + static_cast<long long>(i) * wd * k;

  if (kVariant == kEmpty) {
    for (int c = 0; c < d; ++c) o[static_cast<long long>(c) * gqp] = 0.f;
    return;
  }
  if (kVariant == kNoConstruct) {
    for (int c = 0; c < d; ++c)
      o[static_cast<long long>(c) * gqp] = __fmul_rn(0.5f, load_bf16(v + static_cast<long long>(c) * k));
    return;
  }
  const int y = __ldg(ya + idx);
  const float a0 = round_bf16(__ldg(wy0 + idx));
  const float a1 = round_bf16(__ldg(wy1 + idx));
  if (kVariant == kDotOnly) {
    for (int c = 0; c < d; ++c)
      o[static_cast<long long>(c) * gqp] = row_sum(v + static_cast<long long>(c) * k, y, a0, a1, k);
    return;
  }
  const int x = __ldg(x0 + idx);
  const float b0 = __ldg(wx0 + idx);
  const float b1 = __ldg(wx1 + idx);
  const bool x0_in = x >= 0 && x < w;
  const bool x1_in = x + 1 >= 0 && x + 1 < w;
  for (int c = 0; c < d; ++c) {
    const float u0 = x0_in
        ? __fmul_rn(b0, row_sum(v + (static_cast<long long>(x) * d + c) * k, y, a0, a1, k))
        : 0.f;
    const float u1 = x1_in
        ? __fmul_rn(b1, row_sum(v + (static_cast<long long>(x + 1) * d + c) * k, y, a0, a1, k))
        : 0.f;
    o[static_cast<long long>(c) * gqp] = __fadd_rn(u0, u1);
  }
}

}  // namespace

// variant: 0 empty, 1 dotonly, 2 noconstruct, 3 full (ops/msda_ablate.VARIANTS)
extern "C" int s2d_msda_ablate(int variant, const void* vt, const void* ya,
                               const void* wy0, const void* wy1, const void* x0,
                               const void* wx0, const void* wx1, void* out,
                               int ng, int wd, int k, int gqp, int w, int d,
                               void* stream) {
  const long long threads_total = static_cast<long long>(ng) * gqp;
  if (threads_total <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const long long blocks = (threads_total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const unsigned short*>(vt);
  const auto* y = static_cast<const int*>(ya);
  const auto* a0 = static_cast<const float*>(wy0);
  const auto* a1 = static_cast<const float*>(wy1);
  const auto* x = static_cast<const int*>(x0);
  const auto* b0 = static_cast<const float*>(wx0);
  const auto* b1 = static_cast<const float*>(wx1);
  auto* o = static_cast<float*>(out);
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (variant) {
    case kEmpty:
      msda_ablate_kernel<kEmpty><<<grid, kThreads, 0, s>>>(v, y, a0, a1, x, b0, b1, o, ng, wd, k, gqp, w, d);
      break;
    case kDotOnly:
      msda_ablate_kernel<kDotOnly><<<grid, kThreads, 0, s>>>(v, y, a0, a1, x, b0, b1, o, ng, wd, k, gqp, w, d);
      break;
    case kNoConstruct:
      msda_ablate_kernel<kNoConstruct><<<grid, kThreads, 0, s>>>(v, y, a0, a1, x, b0, b1, o, ng, wd, k, gqp, w, d);
      break;
    case kFull:
      msda_ablate_kernel<kFull><<<grid, kThreads, 0, s>>>(v, y, a0, a1, x, b0, b1, o, ng, wd, k, gqp, w, d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
