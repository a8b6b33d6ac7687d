// Masked cross-attention, forward only, f32 in and out, on the tensor cores.
//
// Replaces the TPU kernel s2d_tpu/ops/masked_attention_pallas.py:_kernel
// (K3): out = softmax(q . k^T * Dh^-1/2, blocked -> -1e30) . v with an
// online softmax over key tiles, the running max clamped at >= -1e4, and 0
// for a row whose every key is blocked (l == 0).
//
// What bounds it on an H100: at the main path's largest call (BH = 8,
// Q = 100, K = 30720, Dh = 32) it is 3.1 GFLOP of products (q.k and p.v)
// against 66 MB of K, V and mask bytes: 0.047 ms at the f32 rate of the
// CUDA cores, 0.019 ms as 3xTF32 on the tensor cores (three TF32 products
// a product at 495 TFLOP/s), 0.020 ms at the HBM rate, so the card's least
// time is the bytes'. The earlier kernel did every product as a scalar FMA
// with an operand from shared memory, 25x the f32 bound. This
// one is bound by instruction issue: 3 mma.sync a product, the split of
// every K and V operand that each warp reads (7 warps split the same tile),
// and the softmax's exp2 and max per logit; at short K (1920) by the launch
// of two kernels and the chunk partials.
// Design:
//   * q.k^T and p.v run on the tensor cores, mma.sync.m16n8k8 in TF32 with
//     f32 accumulation. TF32 keeps 10 mantissa bits, which puts the logits
//     ~1e-3 off, so each operand is split as x = hi + lo (hi = tf32(x), lo =
//     tf32(x - hi)) and a.b is summed as lo.hi + hi.lo + hi.hi ("3xTF32"),
//     f32-accurate to ~1e-6 on the logits (tests/test_torch_kernels.py holds
//     the argument in a numpy emulation). That is 3x the products of TF32,
//     still far under the tensor cores' rate.
//   * A block holds every query of its (batch*head) in registers: up to 8
//     warps of 16 query rows (100 queries -> 7 warps, 112 rows), q split
//     once into hi/lo fragments. A warp's 16 x 64 logits tile stays in the
//     mma accumulator layout; the p.v product takes it as its A operand
//     without a shuffle, by numbering the 8 keys of each k-step in the
//     order the accumulator holds them (keys 2t, 2t+1 at k = t, t+4) and
//     reading V's rows in the same order.
//   * The online softmax (max, sum, rescale) is per query row in registers,
//     in base-2 units (logits scaled by log2(e), ex2.approx); each row's max
//     is reduced over the 4 lanes that hold it.
//   * K, V and the mask tile (64 keys) stream through a double-buffered ring
//     in shared memory filled by cp.async (rows padded to Dh + 4 floats and
//     80 mask bytes: conflict-free fragment reads). The mask is read through
//     its strides (batch, head, query, key): the decoder passes (B, 1, Q, K)
//     expanded over heads with head stride 0, so nothing of size H*Q*K is
//     made. A mask whose key stride is 1 and whose rows are 16-byte aligned
//     is copied 16 bytes at a time; any other layout byte by byte.
//   * The keys are cut into chunks (a multiple of the tile, chosen by the
//     wrapper from K so that the grid covers the SMs even at K = 1920); each
//     block writes a partial (accumulators, max, sum) of its chunk, and a
//     second kernel merges the chunks into the output.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1.0e30f;  // blocked logit, as the TPU kernel
constexpr float kMaxClamp = -1.0e4f * kLog2e;  // running-max floor, base-2 units
constexpr int kTileK = 64;  // keys a tile
constexpr int kMaxWarps = 8;  // 16 query rows each
constexpr int kStages = 2;
constexpr int kMaskStride = 80;  // bytes a query row of the mask tile
constexpr int kMaxDevices = 64;

template <int DH>
struct Tile {
  static constexpr int kStride = DH + 4;  // floats a key row
  static constexpr int kKV = kTileK * kStride;  // floats of the K (or V) tile
  static constexpr int kMaskBytes = kMaxWarps * 16 * kMaskStride;
  static constexpr int kBytes = 2 * kKV * 4 + kMaskBytes;  // one stage
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a . b, one m16n8k8 TF32 product with f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32: the small terms first, then hi . hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_hi)[4],
                                     const uint32_t (&a_lo)[4], float b0, float b1) {
  uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
  split(b0, b0_hi, b0_lo);
  split(b1, b1_hi, b1_lo);
  mma(d, a_lo, b0_hi, b1_hi);
  mma(d, a_hi, b0_lo, b1_lo);
  mma(d, a_hi, b0_hi, b1_hi);
}

__device__ __forceinline__ float exp2_approx(float x) {  // 2^x; 0 for x = -1.4e30
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, asynchronously; zeros where !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }

__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group landed
  asm volatile("cp.async.wait_group 1;");
}

template <int DH>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
masked_attention_partial(const float* __restrict__ q,  // (BH, Q, DH)
                         const float* __restrict__ k,  // (BH, K, DH)
                         const float* __restrict__ v,  // (BH, K, DH)
                         const unsigned char* __restrict__ mask,
                         float* __restrict__ part,  // (BH, chunks, Q, DH + 2)
                         int Q, int K, int H, long long mb, long long mh, long long mq,
                         long long mk, float scale_log2, int chunk_keys, int mask_aligned) {
  using T = Tile<DH>;
  constexpr int kStride = T::kStride;
  constexpr int kSteps = DH / 8;  // k-steps of q . k, n-tiles of p . v
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the fragment's row (and B column) group
  const int t = lane & 3;  // the thread in the group
  const int rows = blockDim.x >> 1;  // 16 query rows a warp
  const int q0 = blockIdx.x * rows;
  const int bh = blockIdx.y;
  const int chunk = blockIdx.z;
  const int k_begin = chunk * chunk_keys;
  const int k_end = min(K, k_begin + chunk_keys);
  const int tiles = k_end > k_begin ? (k_end - k_begin + kTileK - 1) / kTileK : 0;
  const unsigned char* mbase = mask + (long long)(bh / H) * mb + (long long)(bh % H) * mh;
  const float* kb = k + (long long)bh * K * DH;
  const float* vb = v + (long long)bh * K * DH;

  auto k_tile = [&](int s) { return reinterpret_cast<float*>(smem + s * T::kBytes); };
  auto v_tile = [&](int s) { return k_tile(s) + T::kKV; };
  auto m_tile = [&](int s) { return smem + s * T::kBytes + 2 * T::kKV * 4; };

  auto load = [&](int s, int t0) {
    float* ks = k_tile(s);
    float* vs = v_tile(s);
    constexpr int kPerRow = DH / 4;  // 16-byte pieces of a key row
    for (int i = threadIdx.x; i < kTileK * kPerRow; i += blockDim.x) {
      const int r = i / kPerRow;
      const int c = (i - r * kPerRow) * 4;
      const bool ok = t0 + r < k_end;
      const long long at = ok ? (long long)(t0 + r) * DH + c : 0;
      cp_async16(ks + r * kStride + c, kb + at, ok);
      cp_async16(vs + r * kStride + c, vb + at, ok);
    }
    unsigned char* ms = m_tile(s);
    if (mask_aligned) {  // key stride 1, rows 16-byte aligned, K % 16 == 0
      for (int i = threadIdx.x; i < rows * (kTileK / 16); i += blockDim.x) {
        const int r = i / (kTileK / 16);
        const int c = (i - r * (kTileK / 16)) * 16;
        const bool ok = q0 + r < Q && t0 + c < K;
        const unsigned char* src = ok ? mbase + (long long)(q0 + r) * mq + t0 + c : mbase;
        cp_async16(ms + r * kMaskStride + c, src, ok);
      }
    } else {
      for (int i = threadIdx.x; i < rows * kTileK; i += blockDim.x) {
        const int r = i / kTileK;
        const int c = i - r * kTileK;
        const bool ok = q0 + r < Q && t0 + c < k_end;
        ms[r * kMaskStride + c] = ok ? mbase[(long long)(q0 + r) * mq + (long long)(t0 + c) * mk] : 1;
      }
    }
  };

  // this warp's 16 query rows as A fragments: a0 (g, t), a1 (g + 8, t),
  // a2 (g, t + 4), a3 (g + 8, t + 4) of each 16 x 8 k-step
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const bool warp_active = q0 + warp * 16 < Q;
  const float* qb = q + (long long)bh * Q * DH;
  uint32_t q_hi[kSteps][4], q_lo[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int c = 8 * s + t;
    split(r0 < Q ? qb[(long long)r0 * DH + c] : 0.f, q_hi[s][0], q_lo[s][0]);
    split(r1 < Q ? qb[(long long)r1 * DH + c] : 0.f, q_hi[s][1], q_lo[s][1]);
    split(r0 < Q ? qb[(long long)r0 * DH + c + 4] : 0.f, q_hi[s][2], q_lo[s][2]);
    split(r1 < Q ? qb[(long long)r1 * DH + c + 4] : 0.f, q_hi[s][3], q_lo[s][3]);
  }

  // accumulators: o[n] holds rows g, g + 8 x channels 8n + 2t, 8n + 2t + 1
  float o[kSteps][4];
#pragma unroll
  for (int n = 0; n < kSteps; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kMaxClamp, kMaxClamp};
  float l_run[2] = {0.f, 0.f};  // this lane's share of each row's sum

  if (tiles > 0) load(0, k_begin);
  cp_async_commit();
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) load((it + 1) & 1, k_begin + (it + 1) * kTileK);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const int t0 = k_begin + it * kTileK;
    const float* ks = k_tile(it & 1);
    const float* vs = v_tile(it & 1);
    const unsigned char* ms = m_tile(it & 1);
    if (warp_active) {
      // logits: s[j] holds rows g, g + 8 x keys 8j + 2t, 8j + 2t + 1
      float s[kTileK / 8][4];
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
#pragma unroll
        for (int j = 0; j < kTileK / 8; ++j) {
          // B (k = dim, n = key): b0 = K[8j + g][8st + t], b1 = ...[+ 4]
          const float* kr = ks + (8 * j + g) * kStride + 8 * st + t;
          mma3(s[j], q_hi[st], q_lo[st], kr[0], kr[4]);
        }
      }
      const unsigned char* mr0 = ms + (warp * 16 + g) * kMaskStride;
      const unsigned char* mr1 = mr0 + 8 * kMaskStride;
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          const bool in = t0 + col < k_end;  // keys past the chunk are blocked
          s[j][e] = in && !mr0[col] ? s[j][e] * scale_log2 : kNegInf;
          s[j][2 + e] = in && !mr1[col] ? s[j][2 + e] * scale_log2 : kNegInf;
          mx0 = fmaxf(mx0, s[j][e]);
          mx1 = fmaxf(mx1, s[j][2 + e]);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(fmaxf(m_run[0], mx0), kMaxClamp);
      const float mn1 = fmaxf(fmaxf(m_run[1], mx1), kMaxClamp);
      const float al0 = exp2_approx(m_run[0] - mn0);
      const float al1 = exp2_approx(m_run[1] - mn1);
      m_run[0] = mn0;
      m_run[1] = mn1;
      l_run[0] *= al0;
      l_run[1] *= al1;
#pragma unroll
      for (int n = 0; n < kSteps; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
        s[j][0] = exp2_approx(s[j][0] - mn0);  // exactly 0 for a blocked key
        s[j][1] = exp2_approx(s[j][1] - mn0);
        s[j][2] = exp2_approx(s[j][2] - mn1);
        s[j][3] = exp2_approx(s[j][3] - mn1);
        l_run[0] += s[j][0] + s[j][1];
        l_run[1] += s[j][2] + s[j][3];
      }
      // o += p . v. k-step j covers keys 8j .. 8j + 7, numbered so that the
      // accumulator is the A fragment: k = t <-> key 8j + 2t, k = t + 4 <->
      // key 8j + 2t + 1
#pragma unroll
      for (int j = 0; j < kTileK / 8; ++j) {
        uint32_t a_hi[4], a_lo[4];
        split(s[j][0], a_hi[0], a_lo[0]);  // (g, 8j + 2t)
        split(s[j][2], a_hi[1], a_lo[1]);  // (g + 8, 8j + 2t)
        split(s[j][1], a_hi[2], a_lo[2]);  // (g, 8j + 2t + 1)
        split(s[j][3], a_hi[3], a_lo[3]);  // (g + 8, 8j + 2t + 1)
        // B (k = key, n = channel): V[8j + 2t][8n + g], V[8j + 2t + 1][8n + g]
        const float* vr = vs + (8 * j + 2 * t) * kStride + g;
#pragma unroll
        for (int n = 0; n < kSteps; ++n) mma3(o[n], a_hi, a_lo, vr[8 * n], vr[kStride + 8 * n]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  float l0 = l_run[0], l1 = l_run[1];
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const long long row0 = ((long long)bh * gridDim.z + chunk) * Q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0;
    if (r >= Q) continue;
    float* dst = part + (row0 + r) * (DH + 2);
#pragma unroll
    for (int n = 0; n < kSteps; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n + 2 * t) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
    if (t == 0) {
      dst[DH] = m_run[h];
      dst[DH + 1] = h ? l1 : l0;
    }
  }
}

// out[bh, q, d] = sum_c acc_c[d] 2^(m_c - M) / sum_c l_c 2^(m_c - M), M the
// largest chunk max (>= the clamp); 0 where no key was open (l == 0)
template <int DH>
__global__ void masked_attention_combine(const float* __restrict__ part,
                                         float* __restrict__ out, int BH, int Q,
                                         int chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)BH * Q * DH) return;
  const int d = (int)(i % DH);
  const long long bq = i / DH;  // bh * Q + q
  const long long bh = bq / Q;
  const long long qi = bq % Q;
  const long long stride = (long long)Q * (DH + 2);
  const float* p = part + (bh * chunks * Q + qi) * (DH + 2);
  float m_all = kMaxClamp;
  for (int c = 0; c < chunks; ++c) m_all = fmaxf(m_all, p[c * stride + DH]);
  float l_all = 0.f, acc = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const float w = exp2f(p[c * stride + DH] - m_all);
    l_all += p[c * stride + DH + 1] * w;
    acc += p[c * stride + d] * w;
  }
  out[i] = acc / (l_all > 0.f ? l_all : 1.f);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* mask, void* part,
           void* out, int BH, int Q, int K, int H, long long mb, long long mh, long long mq,
           long long mk, float scale, int chunk_keys, cudaStream_t stream) {
  constexpr int kSmem = kStages * Tile<DH>::kBytes;
  static bool configured[kMaxDevices] = {};  // the opt-in is per device
  int device = 0;
  cudaGetDevice(&device);
  if (device >= kMaxDevices || !configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        masked_attention_partial<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    if (device < kMaxDevices) configured[device] = true;
  }
  const int warps = min(kMaxWarps, (Q + 15) / 16);
  const int rows = warps * 16;
  const int chunks = K > 0 ? (K + chunk_keys - 1) / chunk_keys : 1;
  const dim3 grid((Q + rows - 1) / rows, BH, chunks);
  // 16-byte copies of the mask rows where its layout allows them
  const int mask_aligned = mk == 1 && !(mb % 16 || mh % 16 || mq % 16 || K % 16 ||
                                        reinterpret_cast<uintptr_t>(mask) % 16);
  masked_attention_partial<DH><<<grid, warps * 32, kSmem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const unsigned char*)mask,
      (float*)part, Q, K, H, mb, mh, mq, mk, scale * kLog2e, chunk_keys, mask_aligned);
  const long long total = (long long)BH * Q * DH;
  masked_attention_combine<DH><<<(unsigned int)((total + 255) / 256), 256, 0, stream>>>(
      (const float*)part, (float*)out, BH, Q, chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// Workspace `part`: BH * chunks * Q * (Dh + 2) floats, chunks =
// max(1, ceil(K / chunk_keys)); chunk_keys a multiple of 64. q, k, v
// contiguous and 16-byte aligned; the mask any strides.
extern "C" int s2d_masked_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* part,
    void* out, int BH, int Q, int K, int Dh, int H, long long mb, long long mh,
    long long mq, long long mk, float scale, int chunk_keys, void* stream) {
  if (BH <= 0 || Q <= 0) return (int)cudaSuccess;
  if (chunk_keys <= 0 || chunk_keys % kTileK) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 16:
      return launch<16>(q, k, v, mask, part, out, BH, Q, K, H, mb, mh, mq, mk, scale,
                        chunk_keys, s);
    case 32:
      return launch<32>(q, k, v, mask, part, out, BH, Q, K, H, mb, mh, mq, mk, scale,
                        chunk_keys, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
