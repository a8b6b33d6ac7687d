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
// What bounds it on an H100: gather traffic. At the main path's shapes
// (B=8 frames, Lq=S=5040, M=8 heads, D=32, L=3, P=4) one call reads about
// 15.5M corner rows of D*4 = 128 bytes; one frame's value map (5040 x 256 x
// 4 B = 5.2 MB) stays in the 50 MB L2, so the reads are L2 hits.
// Design: one warp per (b, query, head) with lane = channel, so each corner
// read is one coalesced 128-byte row; the 8 warps of a block are the 8 heads
// of one query and write one contiguous (M*D) output row. The location and
// weight loads are warp-uniform broadcasts. Accumulation is f32.
//
// Border (the JAX kernel's clamp, ms_deform_attn_pallas.py:355-356): x and y
// are clamped to [-4, size + 2] before floor, so an unbounded sampling offset
// never overflows the int conversion; a corner outside the map contributes 0.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_fwd_kernel(const float* __restrict__ value,      // (B, S, M, D)
                const int* __restrict__ level_info,   // (L, 3): H, W, start
                const float* __restrict__ loc,        // (B, Lq, M, L, P, 2) xy
                const float* __restrict__ attn,       // (B, Lq, M, L, P)
                float* __restrict__ out,              // (B, Lq, M * D)
                int B, int S, int M, int D, int Lq, int L, int P) {
  const long long task =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (task >= (long long)B * Lq * M) return;  // whole warps exit together
  const int m = (int)(task % M);
  const long long bq = task / M;  // b * Lq + query
  const int b = (int)(bq / Lq);
  const long long row = (long long)M * D;  // stride between spatial positions
  const float* v_b = value + (long long)b * S * row + (long long)m * D;
  const float* loc_t = loc + task * L * P * 2;
  const float* attn_t = attn + task * L * P;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      const int h = level_info[3 * l];
      const int w = level_info[3 * l + 1];
      const float* v_l = v_b + (long long)level_info[3 * l + 2] * row + d;
      for (int p = 0; p < P; ++p) {
        const int lp = l * P + p;
        float x = loc_t[2 * lp] * (float)w - 0.5f;
        float y = loc_t[2 * lp + 1] * (float)h - 0.5f;
        x = fminf(fmaxf(x, -4.f), (float)(w + 2));
        y = fminf(fmaxf(y, -4.f), (float)(h + 2));
        const float xf = floorf(x);
        const float yf = floorf(y);
        const int x0 = (int)xf;
        const int y0 = (int)yf;
        const float fx = x - xf;
        const float fy = y - yf;
        const bool x0_in = x0 >= 0 && x0 < w;
        const bool x1_in = x0 + 1 >= 0 && x0 + 1 < w;
        float s = 0.f;
        if (active) {
          if (y0 >= 0 && y0 < h) {
            const float* r = v_l + (long long)y0 * w * row;
            if (x0_in) s += (1.f - fy) * (1.f - fx) * r[(long long)x0 * row];
            if (x1_in) s += (1.f - fy) * fx * r[(long long)(x0 + 1) * row];
          }
          if (y0 + 1 >= 0 && y0 + 1 < h) {
            const float* r = v_l + (long long)(y0 + 1) * w * row;
            if (x0_in) s += fy * (1.f - fx) * r[(long long)x0 * row];
            if (x1_in) s += fy * fx * r[(long long)(x0 + 1) * row];
          }
        }
        acc += attn_t[lp] * s;
      }
    }
    if (active) out[bq * row + (long long)m * D + d] = acc;
  }
}

}  // namespace

extern "C" int s2d_msda_fwd(const void* value, const void* level_info,
                            const void* loc, const void* attn, void* out,
                            int B, int S, int M, int D, int Lq, int L, int P,
                            void* stream) {
  const long long tasks = (long long)B * Lq * M;
  if (tasks <= 0) return (int)cudaSuccess;
  const unsigned int blocks =
      (unsigned int)((tasks + kWarpsPerBlock - 1) / kWarpsPerBlock);
  msda_fwd_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const float*)value, (const int*)level_info, (const float*)loc,
      (const float*)attn, (float*)out, B, S, M, D, Lq, L, P);
  return (int)cudaGetLastError();
}
