// Masked cross-attention, forward only, f32, streamed over key tiles.
//
// Replaces the TPU kernel s2d_tpu/ops/masked_attention_pallas.py:_kernel
// (K3): out = softmax(q . k^T * Dh^-1/2, blocked -> -1e30) . v with an
// online softmax over key tiles, the running max clamped at >= -1e4, and 0
// for a row whose every key is blocked (l == 0).
//
// What bounds it on an H100: at the main path's largest call (BH = 8,
// Q = 100, K = 30720, Dh = 32) it is 0.4 GFLOP of f32 FMA per head and
// 7.9 MB of K/V reads in all; the mask is (B, Q, K) bytes, shared by the
// heads. Without tensor cores the FMA issue rate and the shared-memory reads
// bound it.
// Design: the keys are cut into chunks of kChunk; one block per (tile of
// kWarps queries, batch*head, chunk), one warp per query, so that a long
// key axis still spreads over every SM (a block that walked all K keys
// alone left the SMs waiting on each tile's load). K and V tiles of kTileK
// keys are staged in shared memory, rows padded to Dh + 1 floats so that 32
// lanes reading 32 different keys hit 32 banks. Lane j takes keys j, j + 32,
// ... of each tile and keeps its own online-softmax state (max, sum, Dh
// accumulators); the 32 lane states merge at the end of the chunk into a
// partial (max, sum, accumulators) in a workspace, and a second kernel
// merges the chunks' partials into the output. The mask is read through its
// strides (batch, head, query, key), so the decoder passes its (B, 1, Q, K)
// mask expanded over heads with head stride 0 and nothing of size H*Q*K is
// materialized; 32 lanes read 32 consecutive key bytes. No tensor cores yet.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1.0e30f;  // blocked logit, as the TPU kernel
constexpr float kMaxClamp = -1.0e4f;  // running-max floor
constexpr int kWarps = 4;
constexpr int kTileK = 128;
constexpr int kChunk = 8 * kTileK;  // keys per block

template <int DH>
__global__ void __launch_bounds__(kWarps * 32)
masked_attention_partial(const float* __restrict__ q,  // (BH, Q, DH)
                         const float* __restrict__ k,  // (BH, K, DH)
                         const float* __restrict__ v,  // (BH, K, DH)
                         const unsigned char* __restrict__ mask,
                         float* __restrict__ part,     // (BH, chunks, Q, DH + 2)
                         int Q, int K, int H, long long mb, long long mh,
                         long long mq, long long mk, float scale) {
  constexpr int kPad = DH + 1;
  static_assert(kWarps * 32 <= 2 * kTileK, "merge buffer must fit the tiles");
  __shared__ float smem[2 * kTileK * kPad];
  float* ks = smem;
  float* vs = smem + kTileK * kPad;

  const int bh = blockIdx.y;
  const int chunk = blockIdx.z;
  const int k_end = min(K, (chunk + 1) * kChunk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  const bool q_ok = qi < Q;
  const int qc = q_ok ? qi : 0;
  const unsigned char* mrow =
      mask + (long long)(bh / H) * mb + (long long)(bh % H) * mh + qc * mq;

  float qr[DH];
  const float* qp = q + ((long long)bh * Q + qc) * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = qp[d];

  float m_run = kMaxClamp;
  float l_run = 0.f;
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;

  const float* kb = k + (long long)bh * K * DH;
  const float* vb = v + (long long)bh * K * DH;
  for (int t0 = chunk * kChunk; t0 < k_end; t0 += kTileK) {
    const int n = min(kTileK, k_end - t0);
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kTileK * DH; i += blockDim.x) {
      const int r = i / DH;
      const int c = i - r * DH;
      const long long g = (long long)(t0 + r) * DH + c;
      ks[r * kPad + c] = r < n ? kb[g] : 0.f;
      vs[r * kPad + c] = r < n ? vb[g] : 0.f;
    }
    __syncthreads();
    if (q_ok) {
      constexpr int kPerLane = kTileK / 32;
      float s[kPerLane];
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const int r = j * 32 + lane;
        float logit = kNegInf;  // keys past K are blocked, as the TPU pad
        if (r < n && !mrow[(long long)(t0 + r) * mk]) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) dot += qr[d] * ks[r * kPad + d];
          logit = dot * scale;
        }
        s[j] = logit;
        tile_max = fmaxf(tile_max, logit);
      }
      const float m_new = fmaxf(fmaxf(m_run, tile_max), kMaxClamp);
      const float alpha = expf(m_run - m_new);
      l_run *= alpha;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const float p = expf(s[j] - m_new);  // exactly 0 for a blocked key
        l_run += p;
        const int r = j * 32 + lane;
        if (p != 0.f) {
#pragma unroll
          for (int d = 0; d < DH; ++d) acc[d] += p * vs[r * kPad + d];
        }
      }
      m_run = m_new;
    }
  }

  // merge the 32 lane states of each warp; the tiles' memory is reused
  float m_all = m_run;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, off));
  const float rescale = expf(m_run - m_all);
  float l_all = l_run * rescale;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    l_all += __shfl_xor_sync(0xffffffffu, l_all, off);
  __syncthreads();
  float* part_s = smem + warp * 32 * kPad;
#pragma unroll
  for (int d = 0; d < DH; ++d) part_s[lane * kPad + d] = acc[d] * rescale;
  __syncwarp();
  if (q_ok) {
    float* dst = part + (((long long)bh * gridDim.z + chunk) * Q + qi) * (DH + 2);
    for (int d = lane; d < DH; d += 32) {
      float sum = 0.f;
      for (int r = 0; r < 32; ++r) sum += part_s[r * kPad + d];
      dst[d] = sum;
    }
    if (lane == 0) {
      dst[DH] = m_all;
      dst[DH + 1] = l_all;
    }
  }
}

// out[bh, q, d] = sum_c acc_c[d] e^(m_c - M) / sum_c l_c e^(m_c - M), M the
// largest chunk max (>= -1e4 by the clamp); 0 where no key was open (l == 0)
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
    const float w = expf(p[c * stride + DH] - m_all);
    l_all += p[c * stride + DH + 1] * w;
    acc += p[c * stride + d] * w;
  }
  out[i] = acc / (l_all > 0.f ? l_all : 1.f);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* part, void* out, int BH, int Q, int K, int H, long long mb,
           long long mh, long long mq, long long mk, float scale,
           cudaStream_t stream) {
  const int chunks = (K + kChunk - 1) / kChunk;
  const dim3 grid((Q + kWarps - 1) / kWarps, BH, chunks > 0 ? chunks : 1);
  masked_attention_partial<DH><<<grid, kWarps * 32, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v,
      (const unsigned char*)mask, (float*)part, Q, K, H, mb, mh, mq, mk, scale);
  const long long total = (long long)BH * Q * DH;
  masked_attention_combine<DH><<<(unsigned int)((total + 255) / 256), 256, 0, stream>>>(
      (const float*)part, (float*)out, BH, Q, chunks > 0 ? chunks : 1);
  return (int)cudaGetLastError();
}

}  // namespace

// Workspace `part`: BH * max(1, ceil(K / 1024)) * Q * (Dh + 2) floats.
extern "C" int s2d_masked_attention_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* part,
    void* out, int BH, int Q, int K, int Dh, int H, long long mb, long long mh,
    long long mq, long long mk, float scale, void* stream) {
  if (BH <= 0 || Q <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 16:
      return launch<16>(q, k, v, mask, part, out, BH, Q, K, H, mb, mh, mq, mk, scale, s);
    case 32:
      return launch<32>(q, k, v, mask, part, out, BH, Q, K, H, mb, mh, mq, mk, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
