// Multi-scale deformable attention, forward, f32.
//
// Replaces the TPU kernel s2d_tpu/ops/ms_deform_attn_pallas.py:_fwd_kernel
// (K1). That kernel builds one-hot corner matrices and contracts them on the
// MXU only because Mosaic has no gather; this one computes the function
// itself: per (batch, query, head), over L levels x P points, bilinearly
// sample the level's value map at a normalized location (align_corners=False:
// x = loc_x * W - 0.5, zero outside the map) and sum the samples weighted by
// the softmaxed attention weights into a D-vector.
//
// What bounds it on an H100: the gathers. At the main path's shapes (B = 8
// frames, Lq = S = 5040, M = 8 heads, D = 32, L = 3, P = 4) one call reads
// 15.5 M corner rows of D * 4 = 128 bytes, 1.98 GB, where the HBM bound
// counts 129 MB (each input once): the rows come from L2 (a frame's value
// map, 5.2 MB, stays there), so the L2-to-SM traffic and the loads in
// flight are the floor of a gather, not HBM. The earlier kernel (a warp per
// (b, query, head), lane = channel) issued 48 scalar 4-byte loads per lane
// behind branches, every lane repeating the same corner arithmetic. This
// one is bound by the largest level's corner rows from L2 (a third of the
// rows, 0.66 GB at the main path's shapes) and by how many of those loads
// 16 warps an SM keep in flight.
// Design:
//   * A block owns one (frame, head) and a range of queries, and first
//     stages the levels that fit in shared memory (smallest first; chosen by
//     the launcher from the level shapes) with cp.async: at the main path's
//     shapes the 12 x 20 and 24 x 40 maps, 150 KB, so 8 of the 12 points
//     gather from shared memory and only the 48 x 80 level's 4 from L2, a
//     third of the L2 traffic.
//   * 8 lanes serve one (query, head), each 4 channels by 16-byte loads; a
//     warp serves 4 queries. The 8 lanes first compute the points' corners
//     together (lane j takes points j, j + 8, ...): 4 corner addresses
//     (shared or global, a zero weight and a safe address outside the map)
//     and 4 weights with the attention weight folded in, into a table in
//     shared memory; then every lane reads each entry as three 16-byte
//     broadcasts and issues the 4 corner loads of several points before it
//     uses any of them.
//   * The grid is (query ranges, heads, frames), with as many query ranges
//     as the SMs take one block each (the staged maps fill an SM's shared
//     memory). Accumulation is f32.
//
// Border (the JAX kernel's clamp, ms_deform_attn_pallas.py:355-356): x and y
// are clamped to [-4, size + 2] before floor, so an unbounded sampling offset
// never overflows the int conversion; a corner outside the map contributes 0.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 8;  // lanes a (query, head)
constexpr int kGroups = kThreads / kLanes;  // (query, head) pairs in flight a block
constexpr int kMaxLevels = 8;
constexpr int kSharedBytes = 232448;  // the opt-in limit of a block on sm_90
constexpr int kMaxDevices = 64;

struct LevelShapes {  // of a call, passed by value: each level's H, W, first position
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

struct __align__(16) Corners {  // one sampling point
  const float4* at[4];  // (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)
  float w[4];  // bilinear weight x attention weight; 0 outside the map
};

struct Level {
  const float* base;  // row 0 of this head's map: shared memory or global
  int row4;  // float4s between two positions of the map
  int h, w;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& x) {
  acc.x += w * x.x;
  acc.y += w * x.y;
  acc.z += w * x.z;
  acc.w += w * x.w;
}

__global__ void __launch_bounds__(kThreads, 1)
msda_fwd_kernel(const float* __restrict__ value,  // (B, S, M, D)
                const LevelShapes shapes,
                const float* __restrict__ loc,  // (B, Lq, M, L, P, 2) xy
                const float* __restrict__ attn,  // (B, Lq, M, L, P)
                float* __restrict__ out,  // (B, Lq, M * D)
                int S, int M, int D, int Lq, int L, int P, int staged_levels,
                int staged_floats) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* staged = reinterpret_cast<float*>(smem);
  Corners* table = reinterpret_cast<Corners*>(smem + (size_t)staged_floats * 4);
  __shared__ Level levels[kMaxLevels];

  const int NP = L * P;
  const int m = blockIdx.y;
  const int b = blockIdx.z;
  const int per_block = (Lq + gridDim.x - 1) / gridDim.x;
  const int q_begin = blockIdx.x * per_block;
  const int q_end = min(Lq, q_begin + per_block);
  const long long row = (long long)M * D;  // floats between two positions
  const float* v_bm = value + (long long)b * S * row + (long long)m * D;

  if (threadIdx.x == 0) {
    int off = 0;
    for (int l = 0; l < L; ++l) {
      const int h = shapes.h[l], w = shapes.w[l];
      Level lv{v_bm + (long long)shapes.start[l] * row, (int)(row / 4), h, w};
      if ((staged_levels >> l) & 1) {
        lv.base = staged + off;
        lv.row4 = D / 4;
        off += h * w * D;
      }
      levels[l] = lv;
    }
  }
  // stage the chosen levels of this (frame, head): rows of D floats
  {
    int off = 0;
    for (int l = 0; l < L; ++l) {
      if (!((staged_levels >> l) & 1)) continue;
      const int hw = shapes.h[l] * shapes.w[l];
      const float* src = v_bm + (long long)shapes.start[l] * row;
      const int d4 = D / 4;
      for (int i = threadIdx.x; i < hw * d4; i += kThreads) {
        const int r = i / d4;
        const int c = 4 * (i - r * d4);
        cp_async16(staged + off + r * D + c, src + r * row + c);
      }
      off += hw * D;
    }
    asm volatile("cp.async.commit_group;");
    asm volatile("cp.async.wait_group 0;");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = lane / kLanes;  // the (query, head) of this lane in its warp
  const int j = lane % kLanes;
  Corners* mine = table + (size_t)(warp * (32 / kLanes) + slot) * NP;
  // warp-uniform loop: every lane reaches each __syncwarp
  for (int q0 = q_begin + warp * (32 / kLanes); q0 < q_end; q0 += kGroups) {
    const int qi = q0 + slot;
    const bool active = qi < q_end;
    const long long task = ((long long)b * Lq + qi) * M + m;
    if (active) {
      for (int pt = j; pt < NP; pt += kLanes) {
        const Level lv = levels[pt / P];
        const float2 xy = reinterpret_cast<const float2*>(loc)[task * NP + pt];
        float x = xy.x * (float)lv.w - 0.5f;
        float y = xy.y * (float)lv.h - 0.5f;
        x = fminf(fmaxf(x, -4.f), (float)(lv.w + 2));
        y = fminf(fmaxf(y, -4.f), (float)(lv.h + 2));
        const float xf = floorf(x);
        const float yf = floorf(y);
        const int x0 = (int)xf;
        const int y0 = (int)yf;
        const float fx = x - xf;
        const float fy = y - yf;
        const float a = attn[task * NP + pt];
        const float wy[2] = {(1.f - fy) * a, fy * a};
        const float wx[2] = {1.f - fx, fx};
        Corners c;
        const float4* base = reinterpret_cast<const float4*>(lv.base);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int yy = y0 + (k >> 1);
          const int xx = x0 + (k & 1);
          const bool in = yy >= 0 && yy < lv.h && xx >= 0 && xx < lv.w;
          c.at[k] = in ? base + (long long)(yy * lv.w + xx) * lv.row4 : base;
          c.w[k] = in ? wy[k >> 1] * wx[k & 1] : 0.f;
        }
        mine[pt] = c;
      }
    }
    __syncwarp();
    if (active) {
      for (int d0 = 0; d0 < D; d0 += 4 * kLanes) {
        const int c4 = d0 / 4 + j;  // this lane's float4 of the row
        if (4 * c4 >= D) break;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int pt = 0; pt < NP; ++pt) {
          const Corners c = mine[pt];
          const float4 v0 = c.at[0][c4];
          const float4 v1 = c.at[1][c4];
          const float4 v2 = c.at[2][c4];
          const float4 v3 = c.at[3][c4];
          fma4(acc, c.w[0], v0);
          fma4(acc, c.w[1], v1);
          fma4(acc, c.w[2], v2);
          fma4(acc, c.w[3], v3);
        }
        *reinterpret_cast<float4*>(out + task * D + 4 * c4) = acc;
      }
    }
    __syncwarp();  // the table is rewritten for the next queries
  }
}

}  // namespace

// level_info: (L, 3) int32 [H, W, start] in host memory. The launcher
// stages the smallest levels whose maps of one head fit in shared memory
// beside the corner table, and cuts the queries of each (frame, head) into
// as many ranges as leave one block on each SM (a block's staged maps fill
// its SM's shared memory). D % 4 == 0, L <= 8, value 16-byte aligned.
extern "C" int s2d_msda_fwd(const void* value, const void* level_info,
                            const void* loc, const void* attn, void* out,
                            int B, int S, int M, int D, int Lq, int L, int P,
                            void* stream) {
  if ((long long)B * Lq * M <= 0) return (int)cudaSuccess;
  if (D % 4 || L <= 0 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  constexpr int kDynamicBytes = kSharedBytes - (int)(kMaxLevels * sizeof(Level));
  static int sm_count[kMaxDevices] = {};  // set with the device's opt-in
  int device = 0;
  cudaGetDevice(&device);
  int sms = device < kMaxDevices ? sm_count[device] : 0;
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        msda_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynamicBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (device < kMaxDevices) sm_count[device] = sms;
  }
  const int* info = (const int*)level_info;
  LevelShapes shapes;
  for (int l = 0; l < L; ++l) {
    shapes.h[l] = info[3 * l];
    shapes.w[l] = info[3 * l + 1];
    shapes.start[l] = info[3 * l + 2];
  }
  const long long table = (long long)kGroups * L * P * sizeof(Corners);
  if (table > kDynamicBytes) return (int)cudaErrorInvalidValue;
  int staged = 0;
  long long floats = 0;
  for (int n = 0; n < L; ++n) {  // the levels by size, smallest first
    int pick = -1;
    for (int l = 0; l < L; ++l)
      if (!((staged >> l) & 1) &&
          (pick < 0 || shapes.h[l] * shapes.w[l] < shapes.h[pick] * shapes.w[pick]))
        pick = l;
    const long long more = (long long)shapes.h[pick] * shapes.w[pick] * D;
    if (4 * (floats + more) + table > kDynamicBytes) break;
    staged |= 1 << pick;
    floats += more;
  }
  const int splits = sms > B * M ? sms / (B * M) : 1;
  msda_fwd_kernel<<<dim3(splits, M, B), kThreads, (size_t)(4 * floats + table),
                    (cudaStream_t)stream>>>(
      (const float*)value, shapes, (const float*)loc, (const float*)attn, (float*)out, S, M,
      D, Lq, L, P, staged, (int)floats);
  return (int)cudaGetLastError();
}
