// Batched epsilon-scaled asymmetric auction (linear sum assignment), f32.
//
// Replaces the TPU kernel
// s2d_tpu/ops/auction_pallas.py:_batched_auction_asym_kernel (K5), which is
// bit-identical to s2d_tpu/ops/auction.py:_auction_asym: N persons (target
// slots) bid over Q >= N objects (queries) on an integer-valued benefit
// matrix. Per epsilon phase (the static list from _eps_schedule):
//   1. partial reset: a person keeps its object iff it is still eps-CS;
//   2. forward rounds until every person is assigned: each unassigned
//      person bids (prices[i1] + (w1 - w2)) + eps on its best object i1
//      (w1 its best net value, lowest index among ties; w2 the best with i1
//      excluded); each object takes its highest bid, the lowest person id
//      among equal bids;
//   3. reverse rounds until no unowned object has a price > 0: such an
//      object seduces its best person at max(0, gamma - eps) or drops its
//      price to 0 (beta <= eps).
// Rounds are counted against max_iters per loop, as the reference does.
//
// Bit-identity: only adds, subtracts, compares and maxima on floats, in the
// reference's association; no fused multiply-add can form (there is no
// multiply), and the build uses no fast-math flag.
//
// What bounds it on an H100: neither bytes (a problem is 40 KB) nor
// operations, but the latency of the serial rounds: ~800 forward rounds per
// problem at the train step's shapes (40 problems of 100 x 100), each a few
// passes over shared memory separated by __syncthreads. 40 blocks occupy 40
// of the 132 SMs.
// Layout: one block per problem. The (N, Q) benefit, the prices, the owners
// and the per-person state live in shared memory (100 x 100 f32 is 40 KB);
// the round loop is a machine loop inside the block. Per-person maxima are
// warp-wide (a warp per person, lanes over objects, shuffle reductions);
// per-object choices take one thread per object scanning the persons.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1.0e18f;  // "no bid" sentinel (ops.auction._NEG)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ benefit_all,  // (B, N, Q)
               const float* __restrict__ eps_list,     // (E,)
               int* __restrict__ out,                  // (B, N)
               int N, int Q, int E, int max_iters) {
  extern __shared__ float smem[];
  float* benefit = smem;                 // N * Q
  float* prices = benefit + N * Q;       // Q
  float* obj_f = prices + Q;             // Q: best bid / beta
  float* obj_g = obj_f + Q;              // Q: gamma
  int* owner = (int*)(obj_g + Q);        // Q: person per object, -1 unowned
  int* obj_i = owner + Q;                // Q: winner / i_star
  float* bid = (float*)(obj_i + Q);      // N: bid / pi / win beta
  int* pobj = (int*)(bid + N);           // N: object per person, -1
  int* i1 = pobj + N;                    // N: bid target / j_win
  int* flag = i1 + N;                    // N: keep / seduced

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* src = benefit_all + (long long)blockIdx.x * N * Q;
  for (int k = tid; k < N * Q; k += kThreads) benefit[k] = src[k];
  for (int j = tid; j < Q; j += kThreads) {
    prices[j] = 0.f;
    owner[j] = -1;
  }
  __syncthreads();

  for (int e = 0; e < E; ++e) {
    const float eps = eps_list[e];

    // person -> object from the owners
    for (int i = tid; i < N; i += kThreads) pobj[i] = -1;
    __syncthreads();
    for (int j = tid; j < Q; j += kThreads)
      if (owner[j] >= 0) pobj[owner[j]] = j;
    __syncthreads();

    // ---- partial reset: keep the pairs that are eps-CS at this eps
    for (int i = warp; i < N; i += kWarps) {
      const float* row = benefit + i * Q;
      float best = kNeg;
      for (int j = lane; j < Q; j += 32) best = fmaxf(best, row[j] - prices[j]);
      best = warp_max(best);
      if (lane == 0) {
        const int o = pobj[i];
        flag[i] = o >= 0 && (row[o] - prices[o]) >= best - eps;
      }
    }
    __syncthreads();
    for (int j = tid; j < Q; j += kThreads)
      if (owner[j] >= 0 && !flag[owner[j]]) owner[j] = -1;
    __syncthreads();
    for (int i = tid; i < N; i += kThreads)
      if (pobj[i] >= 0 && !flag[i]) pobj[i] = -1;
    __syncthreads();

    // ---- forward rounds: unassigned persons bid until all are assigned
    int unassigned = 0;
    for (int i = tid; i < N; i += kThreads) unassigned += pobj[i] < 0;
    unassigned = __syncthreads_or(unassigned);
    for (int it = 0; unassigned && it < max_iters; ++it) {
      for (int i = warp; i < N; i += kWarps) {
        if (pobj[i] >= 0) continue;  // warp-uniform
        const float* row = benefit + i * Q;
        float w1 = kNeg;
        for (int j = lane; j < Q; j += 32) w1 = fmaxf(w1, row[j] - prices[j]);
        w1 = warp_max(w1);
        int arg = Q;
        for (int j = lane; j < Q; j += 32)
          if (row[j] - prices[j] >= w1) { arg = j; break; }
        arg = warp_min(arg);
        float w2 = kNeg;
        for (int j = lane; j < Q; j += 32)
          if (j != arg) w2 = fmaxf(w2, row[j] - prices[j]);
        w2 = warp_max(w2);
        if (lane == 0) {
          i1[i] = arg;
          bid[i] = (prices[arg] + (w1 - w2)) + eps;
        }
      }
      __syncthreads();
      for (int j = tid; j < Q; j += kThreads) {
        float best = kNeg;
        for (int i = 0; i < N; ++i)
          if (pobj[i] < 0 && i1[i] == j) best = fmaxf(best, bid[i]);
        int winner = -1;
        if (best > kNeg) {
          for (int i = 0; i < N; ++i)
            if (pobj[i] < 0 && i1[i] == j && bid[i] >= best) { winner = i; break; }
        }
        obj_i[j] = winner;
        obj_f[j] = best;
      }
      __syncthreads();
      for (int j = tid; j < Q; j += kThreads) {
        if (obj_i[j] >= 0) {
          owner[j] = obj_i[j];
          prices[j] = obj_f[j];
        }
      }
      __syncthreads();
      for (int i = tid; i < N; i += kThreads) pobj[i] = -1;
      __syncthreads();
      for (int j = tid; j < Q; j += kThreads)
        if (owner[j] >= 0) pobj[owner[j]] = j;
      __syncthreads();
      unassigned = 0;
      for (int i = tid; i < N; i += kThreads) unassigned += pobj[i] < 0;
      unassigned = __syncthreads_or(unassigned);
    }

    // ---- reverse rounds: unowned objects with a price seduce or give up
    int pending = 0;
    for (int j = tid; j < Q; j += kThreads) pending += owner[j] < 0 && prices[j] > 0.f;
    pending = __syncthreads_or(pending);
    for (int it = 0; pending && it < max_iters; ++it) {
      // person profits pi
      for (int i = warp; i < N; i += kWarps) {
        const float* row = benefit + i * Q;
        float best = kNeg;
        for (int j = lane; j < Q; j += 32) best = fmaxf(best, row[j] - prices[j]);
        best = warp_max(best);
        if (lane == 0) {
          const int o = pobj[i];
          bid[i] = o >= 0 ? row[o] - prices[o] : best - eps;
        }
      }
      __syncthreads();
      // per object: best person (beta, i_star) and the runner-up gamma
      for (int j = tid; j < Q; j += kThreads) {
        float beta = kNeg;
        for (int i = 0; i < N; ++i) beta = fmaxf(beta, benefit[i * Q + j] - bid[i]);
        int star = N;
        for (int i = 0; i < N; ++i)
          if (benefit[i * Q + j] - bid[i] >= beta) { star = i; break; }
        float gamma = kNeg;
        for (int i = 0; i < N; ++i)
          if (i != star) gamma = fmaxf(gamma, benefit[i * Q + j] - bid[i]);
        const bool bidder = owner[j] < 0 && prices[j] > 0.f;
        const bool give_up = bidder && beta <= eps;
        obj_f[j] = beta;
        obj_g[j] = gamma;
        obj_i[j] = (bidder && !give_up) ? star : -1;  // seducing objects
        if (give_up) prices[j] = 0.f;
      }
      __syncthreads();
      // per person: the seducing object with the highest beta, lowest index
      for (int i = tid; i < N; i += kThreads) {
        float win_beta = kNeg;
        for (int j = 0; j < Q; ++j)
          if (obj_i[j] == i) win_beta = fmaxf(win_beta, obj_f[j]);
        int j_win = -1;
        if (win_beta > kNeg) {
          for (int j = 0; j < Q; ++j)
            if (obj_i[j] == i && obj_f[j] >= win_beta) { j_win = j; break; }
        }
        i1[i] = j_win;
      }
      __syncthreads();
      // seduced persons leave their object ...
      for (int i = tid; i < N; i += kThreads)
        if (i1[i] >= 0 && pobj[i] >= 0) owner[pobj[i]] = -1;
      __syncthreads();
      // ... and take the seducing object at the competitive price
      for (int i = tid; i < N; i += kThreads) {
        const int j = i1[i];
        if (j >= 0) {
          owner[j] = i;
          prices[j] = fmaxf(0.f, obj_g[j] - eps);
        }
      }
      __syncthreads();
      for (int i = tid; i < N; i += kThreads) pobj[i] = -1;
      __syncthreads();
      for (int j = tid; j < Q; j += kThreads)
        if (owner[j] >= 0) pobj[owner[j]] = j;
      __syncthreads();
      pending = 0;
      for (int j = tid; j < Q; j += kThreads) pending += owner[j] < 0 && prices[j] > 0.f;
      pending = __syncthreads_or(pending);
    }
  }

  for (int i = tid; i < N; i += kThreads)
    out[(long long)blockIdx.x * N + i] = pobj[i];
}

size_t shared_bytes(int N, int Q) {
  return (size_t)N * Q * sizeof(float) + (size_t)Q * 5 * 4 + (size_t)N * 4 * 4;
}

}  // namespace

// Returns cudaSuccess, a CUDA error code, or -1 when one problem does not
// fit in the shared memory of a block.
extern "C" int s2d_auction(const void* benefit, const void* eps_list, void* out,
                           int B, int N, int Q, int E, int max_iters,
                           void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  const size_t bytes = shared_bytes(N, Q);
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (bytes > (size_t)optin) return -1;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  auction_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)benefit, (const float*)eps_list, (int*)out, N, Q, E,
      max_iters);
  return (int)cudaGetLastError();
}
