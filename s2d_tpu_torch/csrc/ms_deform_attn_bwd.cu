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
// d value.
//
// d value is deterministic: the same inputs give the same bits in any run,
// as the Pallas kernel's fixed contraction order does. Float atomics add in
// an order that changes from run to run, so d value is summed in 64-bit
// fixed point (integer addition is associative), and no block adds into
// another's rows:
//   * msda_bwd_value: a block owns d value of one (frame, head), 4
//     channels and a range of positions (at the train shapes all 5040: 160
//     KB of int64 accumulators in shared memory, 384 blocks). It takes
//     max|g| of its channels and max|aw| of its (frame, head) (maxima do not
//     depend on the order), turns g and w = wb aw into integers G =
//     rint(g 2^30 / max|g|), A = rint(w 2^30 / max|aw|), both at most 2^30
//     in magnitude (wb <= 1), and adds A G >> s for every corner of every
//     point (a 32 x 32 -> 64-bit multiply), with Lq L P < 2^(s + 2): no row
//     (a point's four corner weights sum to at most 1) reaches 2^62. At the
//     train shapes s = 14: a contribution is kept to 2^-46 max|g| max|aw|,
//     its factors to 2^-30 of their maxima. sm_90 has no native 64-bit
//     shared add (atomicAdd on a shared 64-bit integer compiles to a
//     compare-and-swap loop, ATOMS.CAST.SPIN.64): an int64 takes a native
//     32-bit add on its low word and the carry on its high word. The block
//     then writes its rows of d value in f32, once. A zero maximum gives
//     zeros; a non-finite g or aw makes the block's d value NaN (the float
//     sum gives inf or NaN where such a contribution lands: never a finite
//     wrong value). Each block reads its (frame, head)'s locations and
//     weights; the 8 channel blocks of one (frame, head) run side by side,
//     so 7 of the 8 reads come from L2.
//   * msda_bwd_grads: d loc and d aw, K1's layout (ms_deform_attn_fwd.cu).
//     8 lanes serve one (query, head), each 4 channels by 16-byte loads; a
//     warp serves 4 queries of one head. The 8 lanes first compute the
//     points' corners together (lane j takes points j, j + 8, ...) into a
//     table in shared memory: 4 corner positions (-1 outside), fx, fy and
//     the attention weight. Then every lane loads the 8 corner rows of 2
//     points before it uses any of them (4 points spill registers). A block
//     owns a contiguous range of (frame, head, query) tasks, cut so that the
//     SMs take one block each, and stages the value maps of each (frame,
//     head) that fit in shared memory, the smallest first (at the train
//     shapes the 12 x 20 and 24 x 40 maps, 150 KB): those corners read
//     shared memory, the 48 x 80 map's L2. The sums over the 8 lanes are 3
//     xor shuffles in a fixed order, and lane u of the 8 writes point u of
//     a group of 2: deterministic.
// The float design of d value (accumulators in shared memory by 128-bit
// compare-and-swap, the 48 x 80 level by 16-byte global atomics) took less
// than half this kernel's time. A first fixed-point design kept its layout
// and added the larger levels by 64-bit global atomics, which took most of
// its time; this one, as slow, spends it in msda_bwd_value, where every
// point is visited once per 4 channels and every channel of every corner
// takes two shared atomics. A 128-bit compare-and-swap over two int64
// channels was several times slower than the two 32-bit adds.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // msda_bwd_grads
constexpr int kLanes = 8;  // lanes a (query, head)
constexpr int kGroups = kThreads / kLanes;  // (query, head) pairs in flight a block
constexpr int kChunk = 2;  // points whose corner rows a lane loads at once
constexpr int kValueThreads = 1024;  // msda_bwd_value
constexpr int kMaxLevels = 8;
constexpr int kSharedBytes = 232448;  // the opt-in limit of a block on sm_90
constexpr int kStaticBytes = 1024;  // the level table and the reductions, with room
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
  int staged;  // float offset of its shared value copy (positions D apart), or -1
  int h, w;
};

// A sampling point's corners, as K1 computes them: x = loc_x W - 0.5 (the
// JAX kernel's clamp to [-4, W + 2] before floor), fx its fraction; each
// corner's position in the level, -1 outside.
__device__ __forceinline__ Point corners(float2 xy, int h, int w, float aw) {
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
  e.aw = aw;
  e.pad = 0;
  return e;
}

// Adds v to the int64 at p in shared memory, [low word, high word]: the low
// word takes a native 32-bit add and the carry out of it goes to the high
// word. The sum modulo 2^64 comes out the same in any order: the low word
// wraps the same number of times.
__device__ __forceinline__ void shared_add64(unsigned* p, long long v) {
  const unsigned lo = (unsigned)v;
  const unsigned old = atomicAdd(p, lo);
  const unsigned up = (unsigned)((unsigned long long)v >> 32) + (old + lo < old ? 1u : 0u);
  if (up) atomicAdd(p + 1, up);
}

// The maximum over the block of each thread's a and b (bits of |x|: the
// order of the non-negative floats, NaN above inf), in every thread.
__device__ __forceinline__ uint2 block_max2(unsigned a, unsigned b) {
  __shared__ unsigned warp_max[2][32];
  a = __reduce_max_sync(0xffffffffu, a);
  b = __reduce_max_sync(0xffffffffu, b);
  if ((threadIdx.x & 31) == 0) {
    warp_max[0][threadIdx.x >> 5] = a;
    warp_max[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  a = b = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    a = max(a, warp_max[0][w]);
    b = max(b, warp_max[1][w]);
  }
  return make_uint2(a, b);
}

__global__ void __launch_bounds__(kValueThreads, 1)
msda_bwd_value(const LevelShapes shapes,
               const float* __restrict__ loc,       // (B, Lq, M, L, P, 2) xy
               const float* __restrict__ attn,      // (B, Lq, M, L, P)
               const float* __restrict__ grad_out,  // (B, Lq, M * D)
               float* __restrict__ grad_value,      // (B, S, M, D)
               int S, int M, int D, int Lq, int L, int P, int ranges, int per_range) {
  extern __shared__ __align__(16) unsigned acc[];  // (positions, 4 channels) x [lo, hi]
  const int D4 = D / 4;
  const int NP = L * P;
  const int c4 = blockIdx.x % D4;
  const int range = (blockIdx.x / D4) % ranges;
  const int seg = blockIdx.x / (D4 * ranges);  // b * M + m
  const int b = seg / M;
  const int m = seg % M;
  const int p_begin = range * per_range;
  const int n_pos = min(S, p_begin + per_range) - p_begin;
  const long long row = (long long)M * D;
  const float* g_col = grad_out + (long long)b * Lq * row + m * D + 4 * c4;  // query q: + q row
  const long long task0 = (long long)b * Lq * M + m;  // query q: + q M

  for (int i = threadIdx.x; i < 8 * n_pos; i += kValueThreads) acc[i] = 0u;
  unsigned g_bits = 0, aw_bits = 0;
  for (int q = threadIdx.x; q < Lq; q += kValueThreads) {
    const float4 g = __ldg(reinterpret_cast<const float4*>(g_col + q * row));
    g_bits = max(max(g_bits, __float_as_uint(g.x) & 0x7fffffffu), __float_as_uint(g.y) & 0x7fffffffu);
    g_bits = max(max(g_bits, __float_as_uint(g.z) & 0x7fffffffu), __float_as_uint(g.w) & 0x7fffffffu);
  }
  for (int it = threadIdx.x; it < Lq * NP; it += kValueThreads) {
    const int q = it / NP;
    aw_bits = max(aw_bits, __float_as_uint(__ldg(attn + (task0 + (long long)q * M) * NP + it - q * NP)) &
                               0x7fffffffu);
  }
  const uint2 bits = block_max2(g_bits, aw_bits);  // its barrier also orders the zeroing
  const bool finite = bits.x < 0x7f800000u && bits.y < 0x7f800000u;
  const double max_g = finite ? (double)__uint_as_float(bits.x) : 0.0;
  const double max_aw = finite ? (double)__uint_as_float(bits.y) : 0.0;
  const double inv_g = max_g > 0.0 ? 1073741824.0 / max_g : 0.0;
  const double inv_aw = max_aw > 0.0 ? 1073741824.0 / max_aw : 0.0;
  int e = 0;
  frexp((double)Lq * NP, &e);  // count = f 2^e, f in [0.5, 1): count < 2^e
  const int shift = max(e - 2, 0);

  for (int it = threadIdx.x; it < Lq * NP; it += kValueThreads) {
    const int q = it / NP;
    const int pt = it - q * NP;
    const int l = pt / P;
    const long long at = (task0 + (long long)q * M) * NP + pt;
    const Point c = corners(__ldg(reinterpret_cast<const float2*>(loc) + at), shapes.h[l],
                            shapes.w[l], __ldg(attn + at));
    const float4 g = __ldg(reinterpret_cast<const float4*>(g_col + q * row));
    const int G[4] = {__double2int_rn(g.x * inv_g), __double2int_rn(g.y * inv_g),
                      __double2int_rn(g.z * inv_g), __double2int_rn(g.w * inv_g)};
    const float wx[2] = {1.f - c.fx, c.fx};
    const float wy[2] = {1.f - c.fy, c.fy};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int pos = c.pos[k] < 0 ? -1 : shapes.start[l] + c.pos[k] - p_begin;
      if (pos < 0 || pos >= n_pos) continue;
      // wb * aw is exact in double
      const int A = __double2int_rn((double)(wy[k >> 1] * wx[k & 1]) * (double)c.aw * inv_aw);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
        shared_add64(acc + 8 * pos + 2 * ch, ((long long)A * G[ch]) >> shift);
    }
  }
  __syncthreads();

  const double back = ldexp(max_g * max_aw, shift - 60);  // a unit of the sums in d value
  const float nan = __int_as_float(0x7fffffff);
  for (int i = threadIdx.x; i < n_pos; i += kValueThreads) {
    const unsigned long long* sums = reinterpret_cast<const unsigned long long*>(acc + 8 * i);
    float v[4];
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) v[ch] = finite ? (float)((double)(long long)sums[ch] * back) : nan;
    *reinterpret_cast<float4*>(grad_value + ((long long)b * S + p_begin + i) * row + m * D +
                               4 * c4) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
msda_bwd_grads(const float* __restrict__ value,     // (B, S, M, D)
               const LevelShapes shapes,
               const float* __restrict__ loc,       // (B, Lq, M, L, P, 2) xy
               const float* __restrict__ attn,      // (B, Lq, M, L, P)
               const float* __restrict__ grad_out,  // (B, Lq, M * D)
               float* __restrict__ grad_loc,        // (B, Lq, M, L, P, 2)
               float* __restrict__ grad_attn,       // (B, Lq, M, L, P)
               int B, int S, int M, int D, int Lq, int L, int P, int staged_levels,
               int staged_floats, long long per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* staged = reinterpret_cast<float*>(smem);
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
      int staged_off = 0;
      for (int l = 0; l < L; ++l) {
        const int h = shapes.h[l], w = shapes.w[l];
        Level lv{value + head + (long long)shapes.start[l] * row, -1, h, w};
        if ((staged_levels >> l) & 1) {
          lv.staged = staged_off;
          staged_off += h * w * D;
        }
        levels[l] = lv;
      }
    }
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
          mine[pt] = corners(reinterpret_cast<const float2*>(loc)[task * NP + pt], shapes.h[l],
                             shapes.w[l], attn[task * NP + pt]);
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
            const float wx[2] = {1.f - e[u].fx, e[u].fx};
            const float wy[2] = {1.f - e[u].fy, e[u].fy};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (e[u].pos[k] < 0) continue;
              const float4 x = v[u][k];
              const float t = g.x * x.x + g.y * x.y + g.z * x.z + g.w * x.w;
              s_sum[u] += wy[k >> 1] * wx[k & 1] * t;
              dx_sum[u] += (k & 1 ? wy[k >> 1] : -wy[k >> 1]) * t;
              dy_sum[u] += (k >> 1 ? wx[k & 1] : -wx[k & 1]) * t;
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
    __syncthreads();  // the staged maps and the level table are rewritten next
    seg_begin = seg_end;
  }
}

}  // namespace

// level_info: (L, 3) int32 [H, W, start] in host memory. D % 4 == 0,
// L <= 8, value, grad_out and grad_value 16-byte aligned.
extern "C" int s2d_msda_bwd(const void* value, const void* level_info,
                            const void* loc, const void* attn,
                            const void* grad_out, void* grad_value,
                            void* grad_loc, void* grad_attn, int B, int S,
                            int M, int D, int Lq, int L, int P, void* stream) {
  if (D % 4 || L <= 0 || L > kMaxLevels || P <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)B * S * M * D <= 0) return (int)cudaSuccess;
  static int sm_count[kMaxDevices] = {};  // set with the device's opt-ins
  int device = 0;
  cudaGetDevice(&device);
  int sms = device < kMaxDevices ? sm_count[device] : 0;
  if (sms == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        msda_bwd_grads, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynamicBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(msda_bwd_value, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kDynamicBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    if (device < kMaxDevices) sm_count[device] = sms;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int* info = (const int*)level_info;
  LevelShapes shapes;
  for (int l = 0; l < L; ++l) {
    shapes.h[l] = info[3 * l];
    shapes.w[l] = info[3 * l + 1];
    shapes.start[l] = info[3 * l + 2];
  }

  // d value: a block per (frame, head), position range and 4 channels, the
  // ranges as few as the accumulators (32 bytes a position) allow
  const int per_max = kDynamicBytes / 32;
  const int ranges = (S + per_max - 1) / per_max;
  const int per_range = (S + ranges - 1) / ranges;
  const long long value_blocks = (long long)B * M * ranges * (D / 4);
  if (value_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  msda_bwd_value<<<(unsigned)value_blocks, kValueThreads, (size_t)per_range * 32, s>>>(
      shapes, (const float*)loc, (const float*)attn, (const float*)grad_out, (float*)grad_value,
      S, M, D, Lq, L, P, ranges, per_range);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // d loc and d aw
  const long long total = (long long)B * Lq * M;
  if (total <= 0) return (int)cudaSuccess;
  const long long table = (long long)kGroups * L * P * sizeof(Point);
  if (table > kDynamicBytes) return (int)cudaErrorInvalidValue;
  // the levels by size, smallest first: the value maps to stage
  int order[kMaxLevels];
  for (int l = 0; l < L; ++l) order[l] = l;
  for (int a = 1; a < L; ++a)
    for (int c = a; c > 0 && shapes.h[order[c]] * shapes.w[order[c]] <
                                 shapes.h[order[c - 1]] * shapes.w[order[c - 1]]; --c) {
      const int t = order[c];
      order[c] = order[c - 1];
      order[c - 1] = t;
    }
  long long used = table, staged_floats = 0;
  int staged_levels = 0;
  for (int n = 0; n < L; ++n) {
    const long long more = (long long)shapes.h[order[n]] * shapes.w[order[n]] * D;
    if (used + 4 * more > kDynamicBytes) break;
    staged_levels |= 1 << order[n];
    staged_floats += more;
    used += 4 * more;
  }
  // one block an SM (the staged maps fill its shared memory), each a
  // contiguous range of whole warps' worth of tasks
  long long blocks = (total + kGroups - 1) / kGroups;
  if (blocks > sms) blocks = sms;
  long long per_block = (total + blocks - 1) / blocks;
  per_block = (per_block + 3) / 4 * 4;
  blocks = (total + per_block - 1) / per_block;
  msda_bwd_grads<<<(unsigned)blocks, kThreads, (size_t)used, s>>>(
      (const float*)value, shapes, (const float*)loc, (const float*)attn,
      (const float*)grad_out, (float*)grad_loc, (float*)grad_attn, B, S, M, D, Lq, L, P,
      staged_levels, (int)staged_floats, per_block);
  return (int)cudaGetLastError();
}
