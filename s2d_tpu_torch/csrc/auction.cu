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
//      price to 0 (beta <= eps); a person seduced by several takes the
//      highest beta, the lowest object index among equal betas.
// Rounds are Jacobi (every bid of a round sees the prices of its start) and
// counted against max_iters per loop, as the reference does.
//
// What bounds it on an H100: neither bytes (a problem is 40 KB) nor
// operations, but the latency of the serial rounds: ~800 rounds a problem
// on average and ~1,300 for the slowest at the train step's shapes (40
// problems of 100 x 100), one block a problem, so the kernel lasts as long
// as the slowest problem's rounds x the latency of a round. 40 blocks
// occupy 40 of the 132 SMs.
//
// Design (a round is a few dependent shared-memory passes and barriers):
//   * Lists, not scans. The unassigned persons (forward) and the unowned
//     priced objects (reverse, "sellers") live in a compacted list, double
//     buffered: a round reads one and appends (shared atomicAdd) what stays
//     active to the other. Only list entries do any work, so a late round
//     with 2 bidders costs 2 warps, not N + Q threads scanning everything.
//   * Resolve by key, not by scan. A bidder posts the 64-bit key
//     (ordered(bid) << 32) | ~person into its object's slot by a shared
//     atomicMax; ordered() is the monotone float -> uint32 map (sign bit set
//     for non-negatives, all bits flipped for negatives; -0 is first added
//     to +0 so that the two zeros, equal as floats, map to one key). The
//     largest key is exactly the reference's choice: the highest bid, and
//     among equal bids the largest ~person, the lowest person id. A bidder
//     then wins iff the slot holds its own key. The reverse pass posts
//     (ordered(beta) << 32) | ~object into the seduced person's slot: the
//     highest beta, then the lowest object index. Keys compare integers,
//     so no float is computed differently from the reference.
//   * beta, i* and gamma only for sellers: a warp per seller, lanes over the
//     persons, a (best, its lowest index, second best) triple per lane
//     merged by xor shuffles. The maxima are exact (fmaxf of the same f32
//     values in any order), and the merge keeps the lowest index among
//     equal bests, as the reference's where(r >= beta, id, N).min(); the
//     second best starts at the reference's -1e18 floor. The forward bids
//     use the same merge over objects, so w1, i1 and w2 come from one pass.
//   * The person -> object map is kept in step, not rebuilt: the winner of
//     an object sets its own entry and clears the displaced person's (no
//     two threads write one entry: a displaced person owned the object, a
//     winner owned none, and each person wins at most one object a round).
//   * Two barriers a round, forward and reverse (three in a reverse round
//     after a forward loop cut by max_iters, which left persons to price).
//     512 threads: 16 warps take the first rounds' bidders, and a barrier
//     over 16 warps is cheap when only a few have work.
//   * The benefit rows have an odd pitch in shared memory, so that the
//     reverse pass's column reads (lanes over persons) hit 32 banks.
// Arithmetic: only adds, subtracts, compares and maxima on floats, in the
// reference's association, with no multiply for a fused multiply-add to
// form and no fast-math flag in the build: the assignments are
// bit-identical to ops/auction.auction_asym_plain and the JAX auction.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1.0e18f;  // "no bid" sentinel (ops.auction.NEG)
typedef unsigned long long u64;

// The monotone map of a float's order onto uint32, above the low word.
__device__ __forceinline__ u64 order_key(float v, unsigned low) {
  unsigned b = __float_as_uint(v + 0.0f);  // -0 + 0 = +0
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((u64)b << 32) | low;
}

struct Top2 {  // best value, its lowest index, the best of the others
  float v1;
  int i1;
  float v2;
};

__device__ __forceinline__ Top2 top2_init() { return Top2{-__int_as_float(0x7f800000), INT_MAX, kNeg}; }

// x at index j; a lane sees its indices in increasing order, so a tie with
// the best stays second and the best keeps the lowest index
__device__ __forceinline__ void top2_push(Top2& t, float x, int j) {
  if (x > t.v1) {
    t.v2 = fmaxf(t.v2, t.v1);
    t.v1 = x;
    t.i1 = j;
  } else {
    t.v2 = fmaxf(t.v2, x);
  }
}

// Merge over the warp; every lane ends with the same triple.
__device__ __forceinline__ Top2 warp_top2(Top2 t) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov1 = __shfl_xor_sync(0xffffffffu, t.v1, off);
    const int oi1 = __shfl_xor_sync(0xffffffffu, t.i1, off);
    const float ov2 = __shfl_xor_sync(0xffffffffu, t.v2, off);
    if (t.v1 > ov1 || (t.v1 == ov1 && t.i1 < oi1)) {
      t.v2 = fmaxf(t.v2, ov1);
    } else {
      t.v2 = fmaxf(ov2, t.v1);
      t.v1 = ov1;
      t.i1 = oi1;
    }
  }
  return t;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

struct Smem {
  u64* okey;    // 2 x Q: the best bid key an object received this round
  u64* pkey;    // 2 x N: the best seducer key a person received this round
  u64* skey;    // Q: the key a seller posted
  u64* mykey;   // N: the key a bidder posted
  float* benefit;  // N x pitch
  float* prices;   // Q
  float* gam;      // Q: a seller's gamma
  float* mybid;    // N: a bidder's bid
  float* pi_free;  // N: the profit of an unassigned person in a reverse round
  int* owner;      // Q: person per object, -1 unowned
  int* star;       // Q: a seller's best person
  int* pobj;       // N: object per person, -1
  int* target;     // N: a bidder's object
  int* list;       // 2 x max(N, Q): the active persons or sellers
};

__host__ __device__ inline int pitch_of(int Q) { return Q | 1; }

__host__ __device__ inline unsigned char* take(unsigned char* base, size_t& off, size_t bytes) {
  unsigned char* p = base + off;
  off += (bytes + 15) & ~(size_t)15;  // 16-byte aligned arrays
  return p;
}

// Lays the arrays out from `base`; returns the bytes they take.
__host__ __device__ inline size_t carve(Smem* s, unsigned char* base, int N, int Q) {
  const int L = N > Q ? N : Q;
  size_t off = 0;
  Smem t;
  t.okey = (u64*)take(base, off, sizeof(u64) * 2 * Q);
  t.pkey = (u64*)take(base, off, sizeof(u64) * 2 * N);
  t.skey = (u64*)take(base, off, sizeof(u64) * Q);
  t.mykey = (u64*)take(base, off, sizeof(u64) * N);
  t.benefit = (float*)take(base, off, sizeof(float) * (size_t)N * pitch_of(Q));
  t.prices = (float*)take(base, off, sizeof(float) * Q);
  t.gam = (float*)take(base, off, sizeof(float) * Q);
  t.mybid = (float*)take(base, off, sizeof(float) * N);
  t.pi_free = (float*)take(base, off, sizeof(float) * N);
  t.owner = (int*)take(base, off, sizeof(int) * Q);
  t.star = (int*)take(base, off, sizeof(int) * Q);
  t.pobj = (int*)take(base, off, sizeof(int) * N);
  t.target = (int*)take(base, off, sizeof(int) * N);
  t.list = (int*)take(base, off, sizeof(int) * 2 * L);
  if (s) *s = t;
  return off;
}

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ benefit_all,  // (B, N, Q)
               const float* __restrict__ eps_list,     // (E,)
               int* __restrict__ out,                  // (B, N)
               int N, int Q, int E, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int cnt[2];  // entries of each list
  Smem s;
  carve(&s, smem, N, Q);
  const int P = pitch_of(Q);
  const int LL = N > Q ? N : Q;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* src = benefit_all + (long long)blockIdx.x * N * Q;
  for (int k = tid; k < N * Q; k += kThreads) s.benefit[(k / Q) * P + k % Q] = src[k];
  for (int j = tid; j < Q; j += kThreads) {
    s.prices[j] = 0.f;
    s.owner[j] = -1;
    s.okey[j] = s.okey[Q + j] = 0;
  }
  for (int i = tid; i < N; i += kThreads) {
    s.pobj[i] = -1;
    s.pkey[i] = s.pkey[N + i] = 0;
  }
  if (tid == 0) cnt[0] = cnt[1] = 0;
  __syncthreads();

  for (int e = 0; e < E; ++e) {
    const float eps = eps_list[e];

    // ---- partial reset: keep the pairs that are eps-CS at this eps; the
    // others and the unassigned persons make the first bidder list
    for (int i = warp; i < N; i += kWarps) {
      const float* row = s.benefit + i * P;
      float best = kNeg;
      for (int j = lane; j < Q; j += 32) best = fmaxf(best, row[j] - s.prices[j]);
      best = warp_max(best);
      if (lane == 0) {
        const int o = s.pobj[i];
        const bool keep = o >= 0 && (row[o] - s.prices[o]) >= best - eps;
        if (!keep) {
          if (o >= 0) {
            s.owner[o] = -1;
            s.pobj[i] = -1;
          }
          s.list[atomicAdd(&cnt[0], 1)] = i;
        }
      }
    }
    __syncthreads();

    // ---- forward rounds: unassigned persons bid until all are assigned.
    // Invariant at a round's start: cnt[cur] bidders in list cur, cnt[cur ^ 1]
    // = 0, okey[cur] all 0 (cleared in the round before).
    int cur = 0;
    int n = cnt[0];
    for (int it = 0; n > 0 && it < max_iters; ++it) {
      const int* bidders = s.list + cur * LL;
      u64* slot = s.okey + cur * Q;
      for (int k = warp; k < n; k += kWarps) {
        const int i = bidders[k];
        const float* row = s.benefit + i * P;
        Top2 t = top2_init();
        for (int j = lane; j < Q; j += 32) top2_push(t, row[j] - s.prices[j], j);
        t = warp_top2(t);
        if (lane == 0) {
          const float bid = (s.prices[t.i1] + (t.v1 - t.v2)) + eps;
          const u64 key = order_key(bid, ~(unsigned)i);
          s.mybid[i] = bid;
          s.mykey[i] = key;
          s.target[i] = t.i1;
          atomicMax(slot + t.i1, key);
        }
      }
      __syncthreads();
      int* next = s.list + (cur ^ 1) * LL;
      for (int k = tid; k < n; k += kThreads) {
        const int i = bidders[k];
        const int j = s.target[i];
        if (slot[j] == s.mykey[i]) {  // i bid highest on j
          const int old = s.owner[j];
          s.owner[j] = i;
          s.pobj[i] = j;
          s.prices[j] = s.mybid[i];
          if (old >= 0) {
            s.pobj[old] = -1;
            next[atomicAdd(&cnt[cur ^ 1], 1)] = old;
          }
        } else {
          next[atomicAdd(&cnt[cur ^ 1], 1)] = i;
        }
      }
      for (int j = tid; j < Q; j += kThreads) s.okey[(cur ^ 1) * Q + j] = 0;
      if (tid == 0) cnt[cur] = 0;  // every thread read it before the barrier above
      __syncthreads();
      cur ^= 1;
      n = cnt[cur];
    }
    const bool unassigned_left = n > 0;  // the round guard cut the loop
    __syncthreads();
    for (int j = tid; j < Q; j += kThreads) s.okey[j] = s.okey[Q + j] = 0;
    if (tid == 0) cnt[0] = cnt[1] = 0;
    __syncthreads();

    // ---- reverse rounds: unowned objects with a price seduce or give up
    for (int j = tid; j < Q; j += kThreads)
      if (s.owner[j] < 0 && s.prices[j] > 0.f) s.list[atomicAdd(&cnt[0], 1)] = j;
    __syncthreads();
    cur = 0;
    n = cnt[0];
    for (int it = 0; n > 0 && it < max_iters; ++it) {
      if (unassigned_left) {  // block-uniform
        for (int i = warp; i < N; i += kWarps) {
          if (s.pobj[i] >= 0) continue;  // warp-uniform
          const float* row = s.benefit + i * P;
          float best = kNeg;
          for (int j = lane; j < Q; j += 32) best = fmaxf(best, row[j] - s.prices[j]);
          best = warp_max(best);
          if (lane == 0) s.pi_free[i] = best - eps;
        }
        __syncthreads();
      }
      const int* sellers = s.list + cur * LL;
      u64* slot = s.pkey + cur * N;
      for (int k = warp; k < n; k += kWarps) {
        const int j = sellers[k];
        Top2 t = top2_init();
        for (int i = lane; i < N; i += 32) {
          // pi: the person's profit at its object, or the unassigned one's;
          // a seller is unowned, so no price read here changes this round
          const int o = s.pobj[i];
          const float pi = o >= 0 ? s.benefit[i * P + o] - s.prices[o] : s.pi_free[i];
          top2_push(t, s.benefit[i * P + j] - pi, i);
        }
        t = warp_top2(t);
        if (lane == 0) {
          if (t.v1 <= eps) {
            s.prices[j] = 0.f;  // gives up
          } else {
            const u64 key = order_key(t.v1, ~(unsigned)j);
            s.gam[j] = t.v2;
            s.star[j] = t.i1;
            s.skey[j] = key;
            atomicMax(slot + t.i1, key);
          }
        }
      }
      __syncthreads();
      int* next = s.list + (cur ^ 1) * LL;
      for (int k = tid; k < n; k += kThreads) {
        const int j = sellers[k];
        if (s.prices[j] == 0.f) continue;  // gave up: a seller's price was > 0
        const int i = s.star[j];
        if (slot[i] == s.skey[j]) {  // i takes j: it leaves its object ...
          const int old = s.pobj[i];
          if (old >= 0) {
            s.owner[old] = -1;
            if (s.prices[old] > 0.f) next[atomicAdd(&cnt[cur ^ 1], 1)] = old;
          }
          s.owner[j] = i;  // ... for j at the competitive price
          s.pobj[i] = j;
          s.prices[j] = fmaxf(0.f, s.gam[j] - eps);
        } else {
          next[atomicAdd(&cnt[cur ^ 1], 1)] = j;
        }
      }
      for (int i = tid; i < N; i += kThreads) s.pkey[(cur ^ 1) * N + i] = 0;
      if (tid == 0) cnt[cur] = 0;
      __syncthreads();
      cur ^= 1;
      n = cnt[cur];
    }
    __syncthreads();
    for (int i = tid; i < N; i += kThreads) s.pkey[i] = s.pkey[N + i] = 0;
    if (tid == 0) cnt[0] = cnt[1] = 0;
    __syncthreads();
  }

  for (int i = tid; i < N; i += kThreads)
    out[(long long)blockIdx.x * N + i] = s.pobj[i];
}

}  // namespace

// Returns cudaSuccess, a CUDA error code, or -1 when one problem does not
// fit in the shared memory of a block.
extern "C" int s2d_auction(const void* benefit, const void* eps_list, void* out,
                           int B, int N, int Q, int E, int max_iters,
                           void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  const size_t bytes = carve(nullptr, nullptr, N, Q);
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (bytes + 2 * sizeof(int) > (size_t)optin) return -1;
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
