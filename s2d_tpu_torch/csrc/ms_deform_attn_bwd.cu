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
// Lq=S=5040, M=8, D=32, L=3, P=4) but the corner traffic: ~11M corner rows
// gathered and ~11M rows of f32 atomicAdd into grad_value, which (31 MB)
// stays in the 50 MB L2, so the atomics resolve there.
// Layout (K1's): one warp per (b, query, head), lane = channel, so each
// corner read and each corner update is one coalesced 128-byte row. The
// channel sums are warp shuffles; lane 0 writes the location and weight
// gradients. d value takes f32 atomicAdd: several (query, point) pairs hit
// one corner row, so grad_value is run-to-run nondeterministic in the order
// of its summation (by rounding only).
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msda_bwd_kernel(const float* __restrict__ value,      // (B, S, M, D)
                const int* __restrict__ level_info,   // (L, 3): H, W, start
                const float* __restrict__ loc,        // (B, Lq, M, L, P, 2) xy
                const float* __restrict__ attn,       // (B, Lq, M, L, P)
                const float* __restrict__ grad_out,   // (B, Lq, M * D)
                float* __restrict__ grad_value,       // (B, S, M, D), zeroed
                float* __restrict__ grad_loc,         // (B, Lq, M, L, P, 2)
                float* __restrict__ grad_attn,        // (B, Lq, M, L, P)
                int B, int S, int M, int D, int Lq, int L, int P) {
  const long long task =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (task >= (long long)B * Lq * M) return;  // whole warps exit together
  const int m = (int)(task % M);
  const long long bq = task / M;  // b * Lq + query
  const int b = (int)(bq / Lq);
  const long long row = (long long)M * D;  // stride between spatial positions
  const long long v_off = (long long)b * S * row + (long long)m * D;
  const float* loc_t = loc + task * L * P * 2;
  const float* attn_t = attn + task * L * P;
  const float* g_t = grad_out + bq * row + (long long)m * D;

  for (int l = 0; l < L; ++l) {
    const int h = level_info[3 * l];
    const int w = level_info[3 * l + 1];
    const long long lvl = v_off + (long long)level_info[3 * l + 2] * row;
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
      const bool y0_in = y0 >= 0 && y0 < h;
      const bool y1_in = y0 + 1 >= 0 && y0 + 1 < h;
      const float aw = attn_t[lp];
      const long long r00 = lvl + ((long long)y0 * w + x0) * row;
      const long long r01 = r00 + row;
      const long long r10 = r00 + (long long)w * row;
      const long long r11 = r10 + row;
      const float w00 = (1.f - fy) * (1.f - fx), w01 = (1.f - fy) * fx;
      const float w10 = fy * (1.f - fx), w11 = fy * fx;
      float s_sum = 0.f, dx_sum = 0.f, dy_sum = 0.f;
      for (int d0 = 0; d0 < D; d0 += 32) {
        const int d = d0 + lane;
        if (d >= D) continue;
        const float g = g_t[d];
        const float v00 = (y0_in && x0_in) ? value[r00 + d] : 0.f;
        const float v01 = (y0_in && x1_in) ? value[r01 + d] : 0.f;
        const float v10 = (y1_in && x0_in) ? value[r10 + d] : 0.f;
        const float v11 = (y1_in && x1_in) ? value[r11 + d] : 0.f;
        s_sum += g * (w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11);
        dx_sum += g * ((1.f - fy) * (v01 - v00) + fy * (v11 - v10));
        dy_sum += g * ((1.f - fx) * (v10 - v00) + fx * (v11 - v01));
        const float ga = g * aw;
        if (y0_in && x0_in) atomicAdd(grad_value + r00 + d, w00 * ga);
        if (y0_in && x1_in) atomicAdd(grad_value + r01 + d, w01 * ga);
        if (y1_in && x0_in) atomicAdd(grad_value + r10 + d, w10 * ga);
        if (y1_in && x1_in) atomicAdd(grad_value + r11 + d, w11 * ga);
      }
      s_sum = warp_sum(s_sum);
      dx_sum = warp_sum(dx_sum);
      dy_sum = warp_sum(dy_sum);
      if (lane == 0) {
        grad_attn[task * L * P + lp] = s_sum;
        grad_loc[(task * L * P + lp) * 2] = aw * dx_sum * (float)w;
        grad_loc[(task * L * P + lp) * 2 + 1] = aw * dy_sum * (float)h;
      }
    }
  }
}

}  // namespace

extern "C" int s2d_msda_bwd(const void* value, const void* level_info,
                            const void* loc, const void* attn,
                            const void* grad_out, void* grad_value,
                            void* grad_loc, void* grad_attn, int B, int S,
                            int M, int D, int Lq, int L, int P, void* stream) {
  const long long tasks = (long long)B * Lq * M;
  if (tasks <= 0) return (int)cudaSuccess;
  const unsigned int blocks =
      (unsigned int)((tasks + kWarpsPerBlock - 1) / kWarpsPerBlock);
  msda_bwd_kernel<<<blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const float*)value, (const int*)level_info, (const float*)loc,
      (const float*)attn, (const float*)grad_out, (float*)grad_value,
      (float*)grad_loc, (float*)grad_attn, B, S, M, D, Lq, L, P);
  return (int)cudaGetLastError();
}
