// CREPE's banded Viterbi decode over 360 pitch bins, in one thread block:
//
//   dp[0]  = log_init + log_obs[0]                        (not renormalized)
//   best_j = max over |d| <= 11 of dp[j+d] + band[j][d]   (strict >: lowest d)
//   teleport: dp[m] + log_eps, m the first-index argmax of dp; on an exact
//             tie with best_j it wins only when m < the in-band source
//   dp[t]  = best + log_obs[t], minus its max              (t = 1 .. n-1)
//   path   = first-index argmax of the last dp, then the backpointer walk;
//            rows t >= n pass through, so path[t] = that argmax for t >= n-1
//
// Replaces polgen_rvc_tpu/ops/pallas_viterbi.py:viterbi_path_pallas (its
// _fwd_kernel and _bwd_kernel). The TPU kernel streamed blocks of time steps
// over a sequential grid and carried the dp row in VMEM from one grid step
// to the next. The recursion is serial in t and a convert decodes one
// sequence, so here the grid becomes a loop inside a single block.
//
// Bound: bytes (log_obs read once and the int32 path written once: ~3.3 us
// at T = 7,751 at 3.35 TB/s); the arithmetic is ~2 x 23 x 360 fp32
// operations a step. Neither sets the time: every step waits for the block
// max of the step before, so the kernel runs at one step's latency after
// another. Design: one thread per bin (384 threads, 24 idle), each holding
// its 23 band values in registers; dp double-buffered in shared memory with
// -inf borders, so the 23 candidates are branch-free reads; the next row of
// log_obs prefetched into a register a step ahead; the block max with its
// first-index argmax by redux.sync + ballot in each warp and once more over
// the 12 warp results (two barriers a step). The max that renormalizes
// dp[t] is also the teleport source of step t + 1: after dp - max(dp) the
// maximum is exactly +0 and lies exactly where dp == max(dp) (x - y == 0
// iff x == y in IEEE arithmetic with subnormals kept), so its first index is
// the argmax the next step needs, bit for bit. Backpointers go to an int16
// scratch (5.6 MB at T = 7,751, which stays in L2) and thread 0 walks them
// back after a barrier. Only fp32 adds, compares and subtracts, in the
// plain twin's order: built without --use_fast_math, the paths are the
// twin's, bit for bit.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BINS = 360;
constexpr int HALF = 11;                 // width 12: sources j - 11 .. j + 11
constexpr int BW = 2 * HALF + 1;
constexpr int THREADS = 384;
constexpr int WARPS = THREADS / 32;
constexpr int ROW = THREADS + 2 * HALF;  // a dp row with -inf borders
constexpr unsigned FULL = 0xffffffffu;

// Order-preserving map of a float onto an unsigned key (no NaNs here).
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The block's max of v and the lowest thread index holding it (thread j
// holds bin j), in every thread. One barrier; the caller keeps s_val and
// s_idx untouched until its next barrier.
__device__ __forceinline__ void block_argmax(float v, float* s_val, int* s_idx,
                                             float& max_v, int& max_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float wv = value_of(__reduce_max_sync(FULL, key_of(v)));
  const unsigned hit = __ballot_sync(FULL, v == wv);
  if (lane == 0) {
    s_val[warp] = wv;
    s_idx[warp] = warp * 32 + __ffs(hit) - 1;
  }
  __syncthreads();
  const float bv = lane < WARPS ? s_val[lane] : -INFINITY;
  max_v = value_of(__reduce_max_sync(FULL, key_of(bv)));
  const unsigned bhit = __ballot_sync(FULL, lane < WARPS && bv == max_v);
  max_i = s_idx[__ffs(bhit) - 1];
}

__global__ void __launch_bounds__(THREADS, 1)
viterbi_kernel(const float* __restrict__ log_obs, const float* __restrict__ band,
               short* back, int* path, int T, int n, float log_eps,
               float log_init) {
  __shared__ float s_dp[2][ROW];
  __shared__ float s_val[WARPS];
  __shared__ int s_idx[WARPS];
  const int j = threadIdx.x;
  const bool active = j < BINS;
  for (int i = j; i < 2 * ROW; i += THREADS) (&s_dp[0][0])[i] = -INFINITY;
  float bnd[BW];
#pragma unroll
  for (int d = 0; d < BW; ++d) bnd[d] = active ? band[j * BW + d] : -INFINITY;
  __syncthreads();

  float v = active ? log_init + log_obs[j] : -INFINITY;
  if (active) s_dp[0][HALF + j] = v;
  float max_v;
  int m;
  block_argmax(v, s_val, s_idx, max_v, m);
  __syncthreads();

  float obs_next = (active && n > 1) ? log_obs[BINS + j] : 0.0f;
  int cur = 0;
  for (int t = 1; t < n; ++t) {
    const float o = obs_next;
    if (active && t + 1 < n) obs_next = log_obs[(size_t)(t + 1) * BINS + j];
    const float* row = &s_dp[cur][j];  // row[d] = dp[j + d - HALF]
    const float teleport = s_dp[cur][HALF + m] + log_eps;
    float best = -INFINITY;
    int bi = 0;
#pragma unroll
    for (int d = 0; d < BW; ++d) {
      const float c = row[d] + bnd[d];
      if (c > best) {
        best = c;
        bi = j + d - HALF;
      }
    }
    if (teleport > best || (teleport == best && m < bi)) {
      best = teleport;
      bi = m;
    }
    v = active ? best + o : -INFINITY;
    block_argmax(v, s_val, s_idx, max_v, m);
    if (active) {
      s_dp[cur ^ 1][HALF + j] = v - max_v;
      back[(size_t)t * BINS + j] = (short)bi;
    }
    cur ^= 1;
    __syncthreads();
  }

  const int end = m;
  for (int t = n - 1 + j; t < T; t += THREADS) path[t] = end;
  __syncthreads();  // the backpointer stores, visible to thread 0
  if (j == 0) {
    int b = end;
    for (int t = n - 1; t >= 1; --t) {
      b = back[(size_t)t * BINS + b];
      path[t - 1] = b;
    }
  }
}

}  // namespace

// log_obs (T, 360) fp32; band (360, 23) fp32; back (n, 360) int16 scratch;
// path (T,) int32. 1 <= n <= T.
POLGEN_API int viterbi_path(const void* log_obs, const void* band, void* back,
                            void* path, int T, int n, float log_eps,
                            float log_init, void* stream) {
  if (T < 1 || n < 1 || n > T) return (int)cudaErrorInvalidValue;
  viterbi_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_obs), static_cast<const float*>(band),
      static_cast<short*>(back), static_cast<int*>(path), T, n, log_eps,
      log_init);
  return (int)cudaGetLastError();
}
