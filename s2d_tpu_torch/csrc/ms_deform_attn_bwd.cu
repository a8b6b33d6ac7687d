// Multi-scale deformable attention, backward, f32.
//
// Replaces the TPU kernel s2d_tpu/ops/ms_deform_attn_pallas.py:_bwd_kernel
// (K2) and the chain rule of its custom VJP (_msda_pallas_bwd). That kernel
// contracts one-hot corner matrices on the MXU because Mosaic has no gather
// or scatter; this one computes the gradients themselves. For every
// (batch, query, head) and every (level, point) of the forward
//
//   out[d] = sum_{l,p} aw[l,p] * bilinear(value_l[:, d], loc[l,p])
//
// it writes
//   d value:  w_corner * aw * g[d] added into each in-range corner row;
//   d aw:     sum_d g[d] * sample[d];
//   d loc:    aw * sum_d g[d] * (d sample / d x, d sample / d y), times W
//             (or H) for the chain rule through x = loc_x * W - 0.5.
// Corners and weights are recomputed exactly as K1 computes them (the JAX
// kernel's clamp of x and y to [-4, size + 2] before floor, zero outside),
// so a point with every corner outside gets a zero location gradient.
//
// What bounds it on an H100: not bytes (each input read once and each
// output written once is ~160 MB at the train step's shapes, B=6 frames,
// Lq=S=5040, M=8, D=32, L=3, P=4) but the corner traffic: 11.6 M corner
// rows of 128 bytes gathered (1.49 GB) and as many rows added into
// grad_value. The earlier kernel (a warp per (b, query, head), lane =
// channel) did it with 371 M scalar f32 atomicAdds resolving in L2, every
// lane repeating each point's corner arithmetic.
// Design (K1's layout, ms_deform_attn_fwd.cu):
//   * 8 lanes serve one (query, head), each 4 channels by 16-byte loads; a
//     warp serves 4 queries of one head. The 8 lanes first compute the
//     points' corners together (lane j takes points j, j + 8, ...) into a
//     table in shared memory: 4 corner positions (-1 outside), fx, fy and
//     the attention weight. Then every lane loads the 8 corner rows of 2
//     points before it uses any of them (4 points spill registers).
//   * A block owns a contiguous range of (frame, head, query) tasks, in
//     that order, cut so that the SMs take one block each: a range crosses
//     at most a few (frame, head) segments. For each segment it accumulates
//     d value of the levels that fit in shared memory (the smallest first:
//     at the train shapes the 12 x 20 and 24 x 40 maps, 150 KB) and
//     flushes them once into grad_value by 16-byte atomics
//     (red.global.add.v4.f32, sm_90). It also stages the value maps that
//     still fit (the 12 x 20 one): those corners read shared memory, the
//     others L2 by 16-byte loads. So 8 of the 12 points add into shared
//     memory, and the 48 x 80 level's 4 add straight into grad_value by
//     16-byte atomics, a quarter of the scalar ones' operations.
//   * sm_90 has no shared-memory float add: atomicAdd on a shared float is
//     a 32-bit compare-and-swap loop. A lane adds its float4 with one
//     128-bit compare-and-swap (atom.shared.cas.b128, sm_90): a quarter of
//     the swaps, retried only where two lanes hit the same row at once.
//   * d loc and d aw sum over the 8 lanes by 3 xor shuffles, and lane u of
//     the 8 writes point u of a group of 2.
// Cutting the channels into 16-wide slices, so that both small maps could
// be staged beside their accumulators, was slower on the card: the corner
// tables computed per slice and the location gradients' cross-slice
// atomics cost more than the staging saved.
// grad_value is summed by atomics in an order that changes from run to run:
// it is nondeterministic by rounding only. The launcher plans the levels
// to accumulate and to stage from the level shapes, and a level too large
// for shared memory is read from L2 and adds into grad_value directly.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLanes = 8;  // lanes a (query, head)
constexpr int kGroups = kThreads / kLanes;  // (query, head) pairs in flight a block
constexpr int kChunk = 2;  // points whose corner rows a lane loads at once
constexpr int kMaxLevels = 8;
constexpr int kSharedBytes = 232448;  // the opt-in limit of a block on sm_90
constexpr int kStaticBytes = 1024;  // the level table below, with room
constexpr int kDynamicBytes = kSharedBytes - kStaticBytes;
constexpr int kMaxDevices = 64;

struct LevelShapes {  // of a call, passed by value: each level's H, W, first position
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

struct __align__(16) Point {  // one sampling point of one (query, head)
  int pos[4];  // (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1); -1 outside
  float fx, fy, aw;
  int pad;
};

struct Level {  // one level of the current (frame, head)
  const float* value;  // global, position 0 of this head; positions row apart
  float* grad;  // global d value, position 0 of this head
  int staged;  // float offset of its shared value copy (positions D apart), or -1
  int acc;  // float offset of its shared d value (positions D apart), or -1
  int h, w;
};

__device__ __forceinline__ unsigned long long pair_bits(float lo, float hi) {
  return ((unsigned long long)__float_as_uint(hi) << 32) | __float_as_uint(lo);
}

// Adds v into the shared float4 at p. sm_90 has no shared-memory float add
// (a shared atomicAdd on a float compiles to a 32-bit compare-and-swap
// loop); one 128-bit compare-and-swap (atom.shared.cas.b128, sm_90) covers a
// lane's 4 channels, a quarter of the swaps. The loop retries only when
// another lane changed the row in between.
__device__ __forceinline__ void shared_add4(float4* p, const float4& v) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  float4 old = *p;
  while (true) {
    const unsigned long long e0 = pair_bits(old.x, old.y), e1 = pair_bits(old.z, old.w);
    const unsigned long long d0 = pair_bits(old.x + v.x, old.y + v.y);
    const unsigned long long d1 = pair_bits(old.z + v.z, old.w + v.w);
    unsigned long long s0, s1;
    asm volatile(
        "{\n\t.reg .b128 e, d, s;\n\t"
        "mov.b128 e, {%2, %3};\n\t"
        "mov.b128 d, {%4, %5};\n\t"
        "atom.shared.cas.b128 s, [%6], e, d;\n\t"
        "mov.b128 {%0, %1}, s;\n\t}"
        : "=l"(s0), "=l"(s1)
        : "l"(e0), "l"(e1), "l"(d0), "l"(d1), "r"(addr)
        : "memory");
    if (s0 == e0 && s1 == e1) return;
    old = make_float4(__uint_as_float((unsigned)s0), __uint_as_float((unsigned)(s0 >> 32)),
                      __uint_as_float((unsigned)s1), __uint_as_float((unsigned)(s1 >> 32)));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
msda_bwd_kernel(const float* __restrict__ value,     // (B, S, M, D)
                const LevelShapes shapes,
                const float* __restrict__ loc,       // (B, Lq, M, L, P, 2) xy
                const float* __restrict__ attn,      // (B, Lq, M, L, P)
                const float* __restrict__ grad_out,  // (B, Lq, M * D)
                float* __restrict__ grad_value,      // (B, S, M, D), zeroed
                float* __restrict__ grad_loc,        // (B, Lq, M, L, P, 2)
                float* __restrict__ grad_attn,       // (B, Lq, M, L, P)
                int B, int S, int M, int D, int Lq, int L, int P, int acc_levels,
                int staged_levels, int acc_floats, int staged_floats, long long per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  float* staged = acc + acc_floats;
  Point* table = reinterpret_cast<Point*>(staged + staged_floats);
  __shared__ Level levels[kMaxLevels];

  const int NP = L * P;
  const int D4 = D / 4;
  const long long row = (long long)M * D;  // floats between two positions
  const long long total = (long long)B * M * Lq;
  const long long t_begin = blockIdx.x * per_block;
  const long long t_end = min(total, t_begin + per_block);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slot = lane / kLanes;  // the (query, head) of this lane in its warp
  const int j = lane % kLanes;
  Point* mine = table + (size_t)(warp * (32 / kLanes) + slot) * NP;

  for (long long seg_begin = t_begin; seg_begin < t_end;) {
    const long long seg = seg_begin / Lq;  // b * M + m
    const long long seg_end = min(t_end, (seg + 1) * Lq);
    const int b = (int)(seg / M);
    const int m = (int)(seg % M);
    const long long head = (long long)b * S * row + (long long)m * D;
    if (threadIdx.x == 0) {
      int acc_off = 0, staged_off = 0;
      for (int l = 0; l < L; ++l) {
        const int h = shapes.h[l], w = shapes.w[l];
        const long long first = head + (long long)shapes.start[l] * row;
        Level lv{value + first, grad_value + first, -1, -1, h, w};
        if ((acc_levels >> l) & 1) {
          lv.acc = acc_off;
          acc_off += h * w * D;
        }
        if ((staged_levels >> l) & 1) {
          lv.staged = staged_off;
          staged_off += h * w * D;
        }
        levels[l] = lv;
      }
    }
    for (int i = threadIdx.x; i < acc_floats; i += kThreads) acc[i] = 0.f;
    {  // stage the chosen value maps of this (frame, head): rows of D floats
      int off = 0;
      for (int l = 0; l < L; ++l) {
        if (!((staged_levels >> l) & 1)) continue;
        const int hw = shapes.h[l] * shapes.w[l];
        const float* src = value + head + (long long)shapes.start[l] * row;
        for (int i = threadIdx.x; i < hw * D4; i += kThreads) {
          const int r = i / D4;
          const int c = 4 * (i - r * D4);
          *reinterpret_cast<float4*>(staged + off + r * D + c) =
              __ldg(reinterpret_cast<const float4*>(src + r * row + c));
        }
        off += hw * D;
      }
    }
    __syncthreads();

    const int q_begin = (int)(seg_begin - seg * Lq);
    const int q_end = (int)(seg_end - seg * Lq);
    // warp-uniform loop: every lane reaches each __syncwarp and shuffle
    for (int q0 = q_begin + warp * (32 / kLanes); q0 < q_end; q0 += kGroups) {
      const int qi = q0 + slot;
      const bool active = qi < q_end;
      const long long task = ((long long)b * Lq + (active ? qi : q_begin)) * M + m;
      if (active) {
        for (int pt = j; pt < NP; pt += kLanes) {
          const int l = pt / P;
          const int h = shapes.h[l], w = shapes.w[l];
          const float2 xy = reinterpret_cast<const float2*>(loc)[task * NP + pt];
          float x = xy.x * (float)w - 0.5f;
          float y = xy.y * (float)h - 0.5f;
          x = fminf(fmaxf(x, -4.f), (float)(w + 2));
          y = fminf(fmaxf(y, -4.f), (float)(h + 2));
          const float xf = floorf(x);
          const float yf = floorf(y);
          const int x0 = (int)xf;
          const int y0 = (int)yf;
          Point e;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int yy = y0 + (k >> 1);
            const int xx = x0 + (k & 1);
            e.pos[k] = (yy >= 0 && yy < h && xx >= 0 && xx < w) ? yy * w + xx : -1;
          }
          e.fx = x - xf;
          e.fy = y - yf;
          e.aw = attn[task * NP + pt];
          e.pad = 0;
          mine[pt] = e;
        }
      }
      __syncwarp();
      const float* g_row = grad_out + ((long long)b * Lq + (active ? qi : q_begin)) * row + m * D;
      for (int c0 = 0; c0 < NP; c0 += kChunk) {
        float s_sum[kChunk], dx_sum[kChunk], dy_sum[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) s_sum[u] = dx_sum[u] = dy_sum[u] = 0.f;
        for (int c4 = j; active && c4 < D4; c4 += kLanes) {
          const float4 g = __ldg(reinterpret_cast<const float4*>(g_row + 4 * c4));
          Point e[kChunk];
          float4 v[kChunk][4];
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            if (c0 + u >= NP) break;
            e[u] = mine[c0 + u];
            const Level& lv = levels[(c0 + u) / P];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int pos = max(e[u].pos[k], 0);
              v[u][k] = lv.staged >= 0
                  ? *reinterpret_cast<const float4*>(staged + lv.staged + pos * D + 4 * c4)
                  : __ldg(reinterpret_cast<const float4*>(lv.value + pos * row + 4 * c4));
            }
          }
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            if (c0 + u >= NP) break;
            const Level& lv = levels[(c0 + u) / P];
            const float wx[2] = {1.f - e[u].fx, e[u].fx};
            const float wy[2] = {1.f - e[u].fy, e[u].fy};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int pos = e[u].pos[k];
              if (pos < 0) continue;
              const float4 x = v[u][k];
              const float t = g.x * x.x + g.y * x.y + g.z * x.z + g.w * x.w;
              const float wb = wy[k >> 1] * wx[k & 1];
              s_sum[u] += wb * t;
              dx_sum[u] += (k & 1 ? wy[k >> 1] : -wy[k >> 1]) * t;
              dy_sum[u] += (k >> 1 ? wx[k & 1] : -wx[k & 1]) * t;
              const float a = wb * e[u].aw;
              const float4 add = make_float4(a * g.x, a * g.y, a * g.z, a * g.w);
              if (lv.acc >= 0)
                shared_add4(reinterpret_cast<float4*>(acc + lv.acc + pos * D + 4 * c4), add);
              else
                atomicAdd(reinterpret_cast<float4*>(lv.grad + pos * row + 4 * c4), add);
            }
          }
        }
        // sum over the 8 lanes of the group; lane u keeps point c0 + u
        float s_out = 0.f, dx_out = 0.f, dy_out = 0.f;
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
#pragma unroll
          for (int off = 1; off < kLanes; off <<= 1) {
            s_sum[u] += __shfl_xor_sync(0xffffffffu, s_sum[u], off);
            dx_sum[u] += __shfl_xor_sync(0xffffffffu, dx_sum[u], off);
            dy_sum[u] += __shfl_xor_sync(0xffffffffu, dy_sum[u], off);
          }
          if (j == u) {
            s_out = s_sum[u];
            dx_out = dx_sum[u];
            dy_out = dy_sum[u];
          }
        }
        const int pt = c0 + j;
        if (active && j < kChunk && pt < NP) {
          const int l = pt / P;
          const float aw = mine[pt].aw;
          grad_attn[task * NP + pt] = s_out;
          grad_loc[(task * NP + pt) * 2] = aw * dx_out * (float)shapes.w[l];
          grad_loc[(task * NP + pt) * 2 + 1] = aw * dy_out * (float)shapes.h[l];
        }
      }
      __syncwarp();  // the table is rewritten for the next queries
    }
    __syncthreads();

    // flush the shared d value of this (frame, head) by 16-byte atomics
    for (int l = 0; l < L; ++l) {
      const Level lv = levels[l];
      if (lv.acc < 0) continue;
      for (int i = threadIdx.x; i < lv.h * lv.w * D4; i += kThreads) {
        const int pos = i / D4;
        const int c = 4 * (i - pos * D4);
        const float4 sum = *reinterpret_cast<const float4*>(acc + lv.acc + pos * D + c);
        if (sum.x != 0.f || sum.y != 0.f || sum.z != 0.f || sum.w != 0.f)
          atomicAdd(reinterpret_cast<float4*>(lv.grad + pos * row + c), sum);
      }
    }
    __syncthreads();  // the accumulator and the level table are reset next
    seg_begin = seg_end;
  }
}

}  // namespace

// level_info: (L, 3) int32 [H, W, start] in host memory. D % 4 == 0,
// L <= 8, value, grad_out and grad_value 16-byte aligned, grad_value zeroed.
extern "C" int s2d_msda_bwd(const void* value, const void* level_info,
                            const void* loc, const void* attn,
                            const void* grad_out, void* grad_value,
                            void* grad_loc, void* grad_attn, int B, int S,
                            int M, int D, int Lq, int L, int P, void* stream) {
  const long long total = (long long)B * Lq * M;
  if (total <= 0) return (int)cudaSuccess;
  if (D % 4 || L <= 0 || L > kMaxLevels || P <= 0) return (int)cudaErrorInvalidValue;
  static int sm_count[kMaxDevices] = {};  // set with the device's opt-in
  int device = 0;
  cudaGetDevice(&device);
  int sms = device < kMaxDevices ? sm_count[device] : 0;
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        msda_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynamicBytes);
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
  const long long table = (long long)kGroups * L * P * sizeof(Point);
  if (table > kDynamicBytes) return (int)cudaErrorInvalidValue;
  // the levels by size, smallest first: d value accumulators, then value maps
  int order[kMaxLevels];
  for (int l = 0; l < L; ++l) order[l] = l;
  for (int a = 1; a < L; ++a)
    for (int c = a; c > 0 && shapes.h[order[c]] * shapes.w[order[c]] <
                                 shapes.h[order[c - 1]] * shapes.w[order[c - 1]]; --c) {
      const int t = order[c];
      order[c] = order[c - 1];
      order[c - 1] = t;
    }
  long long used = table, acc_floats = 0, staged_floats = 0;
  int acc_levels = 0, staged_levels = 0;
  for (int n = 0; n < L; ++n) {
    const long long more = (long long)shapes.h[order[n]] * shapes.w[order[n]] * D;
    if (used + 4 * more > kDynamicBytes) break;
    acc_levels |= 1 << order[n];
    acc_floats += more;
    used += 4 * more;
  }
  for (int n = 0; n < L; ++n) {
    const long long more = (long long)shapes.h[order[n]] * shapes.w[order[n]] * D;
    if (used + 4 * more > kDynamicBytes) break;
    staged_levels |= 1 << order[n];
    staged_floats += more;
    used += 4 * more;
  }
  // one block an SM (the accumulators fill its shared memory), each a
  // contiguous range of whole warps' worth of tasks
  long long blocks = (total + kGroups - 1) / kGroups;
  if (blocks > sms) blocks = sms;
  long long per_block = (total + blocks - 1) / blocks;
  per_block = (per_block + 3) / 4 * 4;
  blocks = (total + per_block - 1) / per_block;
  msda_bwd_kernel<<<(unsigned)blocks, kThreads, (size_t)used, (cudaStream_t)stream>>>(
      (const float*)value, shapes, (const float*)loc, (const float*)attn,
      (const float*)grad_out, (float*)grad_value, (float*)grad_loc, (float*)grad_attn, B, S, M,
      D, Lq, L, P, acc_levels, staged_levels, (int)acc_floats, (int)staged_floats, per_block);
  return (int)cudaGetLastError();
}
