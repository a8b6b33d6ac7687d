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
// Design: `empty` and `noconstruct` are fills of one value a row (i, c),
// written front to back by 16-byte stores (`empty` writes its zeros
// itself). For `dotonly` and `full` a thread takes 4 consecutive points of
// one i and writes each channel's 4 outputs with one 16-byte store (a
// warp: 512 contiguous bytes a channel, a block 8 KB); it reads the
// points' arrays by 16-byte loads. Where gqp is not a multiple of 4 the
// rows are not 16-byte aligned, and the same code runs with 4-byte loads
// and stores and a ragged last group. `dotonly` and `full` stage vt[i] in shared memory,
// transposed to [y][x][c] (for dotonly only x = 0's d rows): a corner's d
// channels are then 2 d contiguous bytes, read 8 channels at a time by
// 16-byte shared loads, where the earlier kernel made 128 scalar 2-byte
// loads from L1/L2 for a point of `full`. A block stays on one i: at the
// defaults vt[i] is 160 KB, one block an SM, 16 blocks an i. A map too
// large for shared memory is read from L2 instead, 8 channels at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kEmpty = 0;
constexpr int kDotOnly = 1;
constexpr int kNoConstruct = 2;
constexpr int kFull = 3;
constexpr int kThreads = 512;
constexpr int kSharedBytes = 232448;  // the opt-in limit of a block on sm_90
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float bf16_bits(unsigned short b) {
  // bf16 -> f32 is exact: the bf16 bits are the f32's high half
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 4 consecutive values from p on: one 16-byte load when kVec, else up to n
template <bool kVec, typename T>
__device__ __forceinline__ void load4(const T* __restrict__ src, int n, T (&v)[4]) {
  if (kVec) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(src));
    v[0] = reinterpret_cast<const T&>(q.x);
    v[1] = reinterpret_cast<const T&>(q.y);
    v[2] = reinterpret_cast<const T&>(q.z);
    v[3] = reinterpret_cast<const T&>(q.w);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = u < n ? __ldg(src + u) : T(0);
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* dst, int n, float a, float b, float c, float e) {
  if (kVec) {
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, e);
  } else {
    if (n > 0) dst[0] = a;
    if (n > 1) dst[1] = b;
    if (n > 2) dst[2] = c;
    if (n > 3) dst[3] = e;
  }
}

// 8 channels c8 .. c8 + 7 of corner (y, x) as f32: from the staged copy
// ([y][x][c], cols columns) by one 16-byte load, or from vt in global memory
// (rows x d + c, k apart)
template <bool kStaged>
__device__ __forceinline__ void corner8(const unsigned short* staged, const unsigned short* v,
                                        int y, int x, int c8, int cols, int d, int k,
                                        float (&out)[8]) {
  if (kStaged) {
    const uint4 q = *reinterpret_cast<const uint4*>(staged + ((long long)y * cols + x) * d + c8);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[2 * e] = __uint_as_float(w[e] << 16);
      out[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      out[e] = bf16_bits(__ldg(v + ((long long)x * d + c8 + e) * k + y));
  }
}

// `empty` and `noconstruct`: every output row (i, c) holds one value, 0 or
// 0.5 vt[i, c, 0]. A block writes kFillVectors 16-byte runs of kThreads
// stores in one row (y), so that the grid writes the output front to back,
// as a fill does; a row not 16-byte aligned (gqp % 4 != 0) is written by
// 4-byte stores.
constexpr int kFillVectors = 2;

template <int kVariant, bool kVec>
__global__ void __launch_bounds__(kThreads)
msda_ablate_fill(const unsigned short* __restrict__ vt, float* __restrict__ out, int wd, int k,
                 int gqp, int d) {
  const int r = blockIdx.y;  // i d + c
  const float h = kVariant == kEmpty
      ? 0.f
      : __fmul_rn(0.5f, bf16_bits(__ldg(vt + (long long)(r / d) * wd * k + (long long)(r % d) * k)));
  float* row = out + (long long)r * gqp;
  const int first = blockIdx.x * kFillVectors * kThreads + threadIdx.x;
  if (kVec) {
    float4* row4 = reinterpret_cast<float4*>(row);
#pragma unroll
    for (int u = 0; u < kFillVectors; ++u) {
      const int q = first + u * kThreads;
      if (q < gqp / 4) row4[q] = make_float4(h, h, h, h);
    }
  } else {
#pragma unroll
    for (int u = 0; u < kFillVectors; ++u) {
      const int q = first + u * kThreads;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e < gqp) row[4 * q + e] = h;
    }
  }
}

template <int kVariant, bool kVec, bool kStaged>
__global__ void __launch_bounds__(kThreads)
msda_ablate_kernel(const unsigned short* __restrict__ vt, const int* __restrict__ ya,
                   const float* __restrict__ wy0, const float* __restrict__ wy1,
                   const int* __restrict__ x0, const float* __restrict__ wx0,
                   const float* __restrict__ wx1, float* __restrict__ out, int wd, int k,
                   int gqp, int w, int d) {
  extern __shared__ __align__(16) unsigned short staged[];
  const int i = blockIdx.y;
  const unsigned short* v = vt + (long long)i * wd * k;
  float* o = out + (long long)i * d * gqp;
  const long long pt = (long long)i * gqp;
  const int groups = (gqp + 3) / 4;
  const int cols = kVariant == kFull ? w : 1;

  if (kStaged) {  // vt[i]'s first cols * d rows, transposed to [y][x][c]
    const int chunks = cols * d * (k / 8);
    for (int t = threadIdx.x; t < chunks; t += kThreads) {
      const int c = t % d;
      const int r = t / d;
      const int x = r % cols;
      const int y8 = 8 * (r / cols);
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(v + ((long long)x * d + c) * k + y8));
      const unsigned wv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        staged[((long long)(y8 + e) * cols + x) * d + c] =
            static_cast<unsigned short>(e & 1 ? wv[e >> 1] >> 16 : wv[e >> 1] & 0xffffu);
    }
    __syncthreads();
  }

  for (int g = blockIdx.x * kThreads + threadIdx.x; g < groups; g += gridDim.x * kThreads) {
    const int p = 4 * g;
    const int n = min(4, gqp - p);
    float* op = o + p;
    int y[4], x[4];
    float a0[4], a1[4], b0[4], b1[4];
    load4<kVec>(ya + pt + p, n, y);
    load4<kVec>(wy0 + pt + p, n, a0);
    load4<kVec>(wy1 + pt + p, n, a1);
    if (kVariant == kFull) {
      load4<kVec>(x0 + pt + p, n, x);
      load4<kVec>(wx0 + pt + p, n, b0);
      load4<kVec>(wx1 + pt + p, n, b1);
    }
    bool y0_in[4], y1_in[4], x0_in[4], x1_in[4];
    int yc0[4], yc1[4], xc0[4], xc1[4];  // clamped: an address to read, masked after
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a0[u] = round_bf16(a0[u]);
      a1[u] = round_bf16(a1[u]);
      y0_in[u] = y[u] >= 0 && y[u] < k;
      y1_in[u] = y[u] + 1 >= 0 && y[u] + 1 < k;
      yc0[u] = min(max(y[u], 0), k - 1);
      yc1[u] = min(max(y[u] + 1, 0), k - 1);
      if (kVariant == kFull) {
        x0_in[u] = x[u] >= 0 && x[u] < w;
        x1_in[u] = x[u] + 1 >= 0 && x[u] + 1 < w;
        xc0[u] = min(max(x[u], 0), w - 1);
        xc1[u] = min(max(x[u] + 1, 0), w - 1);
      } else {
        x0_in[u] = true;
        x1_in[u] = false;
        xc0[u] = xc1[u] = 0;
      }
    }
    for (int c8 = 0; c8 < d; c8 += 8) {
      float res[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float r0[8], r1[8];
        // column x0: bf16(wy0) v[ya] + bf16(wy1) v[ya + 1]
        {
          float top[8], bottom[8];
          corner8<kStaged>(staged, v, yc0[u], xc0[u], c8, cols, d, k, top);
          corner8<kStaged>(staged, v, yc1[u], xc0[u], c8, cols, d, k, bottom);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            r0[e] = __fadd_rn(y0_in[u] ? __fmul_rn(a0[u], top[e]) : 0.f,
                              y1_in[u] ? __fmul_rn(a1[u], bottom[e]) : 0.f);
        }
        if (kVariant == kDotOnly) {
#pragma unroll
          for (int e = 0; e < 8; ++e) res[u][e] = r0[e];
          continue;
        }
        {  // column x0 + 1
          float top[8], bottom[8];
          corner8<kStaged>(staged, v, yc0[u], xc1[u], c8, cols, d, k, top);
          corner8<kStaged>(staged, v, yc1[u], xc1[u], c8, cols, d, k, bottom);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            r1[e] = __fadd_rn(y0_in[u] ? __fmul_rn(a0[u], top[e]) : 0.f,
                              y1_in[u] ? __fmul_rn(a1[u], bottom[e]) : 0.f);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e)
          res[u][e] = __fadd_rn(x0_in[u] ? __fmul_rn(b0[u], r0[e]) : 0.f,
                                x1_in[u] ? __fmul_rn(b1[u], r1[e]) : 0.f);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        store4<kVec>(op + (long long)(c8 + e) * gqp, n, res[0][e], res[1][e], res[2][e],
                     res[3][e]);
    }
  }
}

template <int kVariant, bool kVec, bool kStaged>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t s, const unsigned short* v,
                   const int* y, const float* a0, const float* a1, const int* x,
                   const float* b0, const float* b1, float* o, int wd, int k, int gqp, int w,
                   int d) {
  msda_ablate_kernel<kVariant, kVec, kStaged><<<grid, kThreads, smem, s>>>(
      v, y, a0, a1, x, b0, b1, o, wd, k, gqp, w, d);
  return cudaGetLastError();
}

template <int kVariant>
cudaError_t dispatch(bool vec, bool staged, dim3 grid, size_t smem, cudaStream_t s,
                     const unsigned short* v, const int* y, const float* a0, const float* a1,
                     const int* x, const float* b0, const float* b1, float* o, int wd, int k,
                     int gqp, int w, int d) {
  if (vec && staged)
    return launch<kVariant, true, true>(grid, smem, s, v, y, a0, a1, x, b0, b1, o, wd, k, gqp, w, d);
  if (vec)
    return launch<kVariant, true, false>(grid, smem, s, v, y, a0, a1, x, b0, b1, o, wd, k, gqp, w, d);
  if (staged)
    return launch<kVariant, false, true>(grid, smem, s, v, y, a0, a1, x, b0, b1, o, wd, k, gqp, w, d);
  return launch<kVariant, false, false>(grid, smem, s, v, y, a0, a1, x, b0, b1, o, wd, k, gqp, w, d);
}

cudaError_t allow_shared(bool vec) {  // the opt-in above 48 KB, for the staged kernels
  const int bytes = kSharedBytes;
  cudaError_t err;
  if (vec) {
    err = cudaFuncSetAttribute(msda_ablate_kernel<kDotOnly, true, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(msda_ablate_kernel<kFull, true, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  } else {
    err = cudaFuncSetAttribute(msda_ablate_kernel<kDotOnly, false, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(msda_ablate_kernel<kFull, false, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  return err;
}

}  // namespace

// variant: 0 empty, 1 dotonly, 2 noconstruct, 3 full (ops/msda_ablate.VARIANTS).
// d % 8 == 0 and k % 8 == 0 (the wrapper checks); the arrays as torch lays
// them out contiguously (16-byte aligned bases).
extern "C" int s2d_msda_ablate(int variant, const void* vt, const void* ya,
                               const void* wy0, const void* wy1, const void* x0,
                               const void* wx0, const void* wx1, void* out,
                               int ng, int wd, int k, int gqp, int w, int d,
                               void* stream) {
  if (ng <= 0 || gqp <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if (d % 8 || k % 8 || k <= 0 || w <= 0 || ng > 65535 || variant < 0 || variant > kFull)
    return static_cast<int>(cudaErrorInvalidValue);
  static int sm_count[kMaxDevices] = {};
  static bool opted[kMaxDevices][2] = {};
  int device = 0;
  cudaGetDevice(&device);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sm_count[device] == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool vec = gqp % 4 == 0;
  const long long groups = (gqp + 3) / 4;
  const long long need = (groups + kThreads - 1) / kThreads;  // blocks an i at one group a thread
  long long per_i = need;
  size_t smem = 0;
  bool staged = false;
  if (variant == kDotOnly || variant == kFull) {
    const long long bytes = 2LL * k * (variant == kFull ? w : 1) * d;
    staged = bytes <= kSharedBytes;
    if (staged) {
      if (!opted[device][vec]) {
        const cudaError_t err = allow_shared(vec);
        if (err != cudaSuccess) return static_cast<int>(err);
        opted[device][vec] = true;
      }
      smem = static_cast<size_t>(bytes);
      // as many blocks as fit on the card at once (each stages vt[i] once),
      // shared among the i
      const long long per_sm = std::min<long long>(2048 / kThreads, kSharedBytes / bytes);
      per_i = std::max<long long>(1, sm_count[device] * per_sm / ng);
      per_i = std::min(per_i, need);
    }
  }
  if (per_i > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(per_i), static_cast<unsigned>(ng));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const unsigned short*>(vt);
  const auto* y = static_cast<const int*>(ya);
  const auto* a0 = static_cast<const float*>(wy0);
  const auto* a1 = static_cast<const float*>(wy1);
  const auto* x = static_cast<const int*>(x0);
  const auto* b0 = static_cast<const float*>(wx0);
  const auto* b1 = static_cast<const float*>(wx1);
  auto* o = static_cast<float*>(out);
  if (variant == kEmpty || variant == kNoConstruct) {
    const long long per_row = (groups + kFillVectors * kThreads - 1) / (kFillVectors * kThreads);
    if ((long long)ng * d > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 rows(static_cast<unsigned>(per_row), static_cast<unsigned>(ng * d));
    if (variant == kEmpty && vec)
      msda_ablate_fill<kEmpty, true><<<rows, kThreads, 0, s>>>(v, o, wd, k, gqp, d);
    else if (variant == kEmpty)
      msda_ablate_fill<kEmpty, false><<<rows, kThreads, 0, s>>>(v, o, wd, k, gqp, d);
    else if (vec)
      msda_ablate_fill<kNoConstruct, true><<<rows, kThreads, 0, s>>>(v, o, wd, k, gqp, d);
    else
      msda_ablate_fill<kNoConstruct, false><<<rows, kThreads, 0, s>>>(v, o, wd, k, gqp, d);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t err =
      variant == kDotOnly
          ? dispatch<kDotOnly>(vec, staged, grid, smem, s, v, y, a0, a1, x, b0, b1, o, wd, k, gqp, w, d)
          : dispatch<kFull>(vec, staged, grid, smem, s, v, y, a0, a1, x, b0, b1, o, wd, k, gqp, w, d);
  return static_cast<int>(err);
}
