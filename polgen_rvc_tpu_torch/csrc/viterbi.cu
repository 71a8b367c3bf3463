// CREPE's banded Viterbi decode over 360 pitch bins:
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
// max of the step before, so the forward loop runs at one step's latency
// and instruction issue after another, and the walk at one dependent load
// a step. Three launches keep only what is serial in the serial loops:
//
// 1. Forward (one block). What step t + 1 needs of step t is the row of
//    values v = best + o and its max, not the argmax or the backpointers.
//    Four warps, one to a scheduler, each thread three neighbouring bins
//    with their 3 x 23 band values in registers. Each step stores the raw
//    v (not renormalized) into a double-buffered shared row with -inf
//    borders and into the rows scratch, and each warp its max; one barrier
//    a step. After it, every thread reduces the four warp maxima itself
//    and forms its candidates as (v[j+d] - M) + band[j][d]: the twin's
//    dp = dp_new - max, then dp_pad + band, in the same order and to the
//    same bits. Step 1 subtracts +0 instead (dp[0] is not renormalized;
//    x - (+0) == x exactly). The teleport value is (M - sub) + log_eps:
//    the max of dp is M - sub, and at t >= 2 exactly +0 (x - y == 0 iff
//    x == y in IEEE arithmetic with subnormals kept), so no load of dp[m]
//    exists. A thread's 25 window values are renormalized once for its
//    three bins, and each bin's best is an fmaxf tree of depth 5. The
//    observations arrive by cp.async into a per-thread ring of shared
//    slots seven steps ahead.
// 2. Backpointers (rows in parallel, one block a span of 16): from row
//    t-1 and the same arithmetic, M and m, then per bin the same best (a
//    max is exact in any order), the lowest d whose candidate equals it
//    (the strict-> lowest-d rule) and the teleport tie rule; int16 back[t].
//    Then every thread chases its own start bin through the span's rows in
//    shared memory: the span's map from path[hi-1] to path[lo-1].
// 3. Walk (one block). The end bin from the last row; then one thread
//    chases the maps, 16 steps of the path a lookup: 485 dependent loads at
//    T = 7,751 instead of 7,750, the maps streamed into shared memory from
//    the end in chunks of 64 by cp.async (two in flight, 16-byte coalesced
//    copies), as the TPU's _bwd_kernel walks from VMEM. Last, every thread
//    walks whole spans from their known ends through back in L2.
//
// Only fp32 adds, compares, subtracts and max, in the plain twin's order:
// built without --use_fast_math, the paths are the twin's, bit for bit.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BINS = 360;
constexpr int HALF = 11;                 // width 12: sources j - 11 .. j + 11
constexpr int BW = 2 * HALF + 1;
constexpr unsigned FULL = 0xffffffffu;

constexpr int K = 3;                     // forward: bins a thread
constexpr int THREADS = 128;             // 120 busy
constexpr int WARPS = THREADS / 32;
constexpr int WIN = K + 2 * HALF;        // a thread's window of sources
constexpr int ROW = THREADS * K + 2 * HALF;  // a raw row with -inf borders
constexpr int RING = 8;                  // observation rows in flight

constexpr int BACK_THREADS = 384;        // backpointers: one thread a bin
constexpr int SPAN = 16;                 // backpointer rows a block (a span)
constexpr int BACK_ROW = BACK_THREADS + 2 * HALF;

constexpr int WALK_THREADS = 256;
constexpr int WALK_MAPS = 64;            // span maps a chunk of the walk
constexpr int ROW_VECS = BINS * 2 / 16;  // 16-byte vectors an int16 row

// Order-preserving map of a float onto an unsigned key (no NaNs here).
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float warp_max(float v) {
  return value_of(__reduce_max_sync(FULL, key_of(v)));
}

// The lowest index i with v == the warp's max wv, over lanes holding
// (v, i); no lane holding wv gives 0xffffffff.
__device__ __forceinline__ unsigned warp_first(float v, float wv, int i) {
  return __reduce_min_sync(FULL, v == wv ? (unsigned)i : 0xffffffffu);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows (n, 360) fp32: row t = dp_new of step t (row 0 = dp[0]), not
// renormalized.
__global__ void __launch_bounds__(THREADS, 1)
viterbi_forward_kernel(const float* __restrict__ log_obs,
                       const float* __restrict__ band, float* __restrict__ rows,
                       int n, float log_eps, float log_init) {
  static_assert(WARPS == 4, "the step reads four warp slots as one float4");
  __shared__ float s_raw[2][ROW];
  __shared__ __align__(16) float s_wv[2][WARPS];
  __shared__ float s_obs[RING][THREADS * K];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = tid * K;  // this thread's first bin; its window starts at
                           // raw index j0 (bin j0 - HALF)
  for (int i = tid; i < 2 * ROW; i += THREADS) (&s_raw[0][0])[i] = -INFINITY;
  float bnd[K][BW];
#pragma unroll
  for (int b = 0; b < K; ++b)
#pragma unroll
    for (int d = 0; d < BW; ++d)
      bnd[b][d] = j0 + b < BINS ? band[(j0 + b) * BW + d] : -INFINITY;
  // observation row t lands in slot t % RING, copied by the thread that
  // reads it; one commit group a row (empty past n)
  auto fetch = [&](int t) {
    if (t < n) {
#pragma unroll
      for (int b = 0; b < K; ++b)
        if (j0 + b < BINS)
          cp_async4(&s_obs[t % RING][j0 + b], log_obs + (size_t)t * BINS + j0 + b);
    }
    cp_async_commit();
  };
  for (int t = 1; t < RING; ++t) fetch(t);
  __syncthreads();

  float v[K];
  auto publish = [&](int buf, int t) {
#pragma unroll
    for (int b = 0; b < K; ++b) {
      s_raw[buf][HALF + j0 + b] = v[b];
      if (j0 + b < BINS) rows[(size_t)t * BINS + j0 + b] = v[b];
    }
    const float wv = warp_max(fmaxf(fmaxf(v[0], v[1]), v[2]));
    if (lane == 0) s_wv[buf][warp] = wv;
  };
  // dp[0], not renormalized; the loop's first step subtracts +0
#pragma unroll
  for (int b = 0; b < K; ++b)
    v[b] = j0 + b < BINS ? log_init + log_obs[j0 + b] : -INFINITY;
  publish(0, 0);

  int cur = 0;
  float sub = 0.f;  // +0 at step 1, then the previous row's max
  for (int t = 1; t < n; ++t) {
    __syncthreads();
    fetch(t + RING - 1);  // into the slot of row t - 1, read before the barrier
    const float4 w = *reinterpret_cast<const float4*>(s_wv[cur]);
    const float M = fmaxf(fmaxf(w.x, w.y), fmaxf(w.z, w.w));
    if (t > 1) sub = M;
    const float teleport = (M - sub) + log_eps;
    float dp[WIN];
#pragma unroll
    for (int i = 0; i < WIN; ++i) dp[i] = s_raw[cur][j0 + i] - sub;
    float best[K];
#pragma unroll
    for (int b = 0; b < K; ++b) {
      float r[12];
#pragma unroll
      for (int d = 0; d < 11; ++d)
        r[d] = fmaxf(dp[b + 2 * d] + bnd[b][2 * d], dp[b + 2 * d + 1] + bnd[b][2 * d + 1]);
      r[11] = dp[b + 22] + bnd[b][22];
#pragma unroll
      for (int d = 0; d < 6; ++d) r[d] = fmaxf(r[2 * d], r[2 * d + 1]);
      best[b] = fmaxf(fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3])), fmaxf(r[4], r[5]));
    }
    cp_async_wait<RING - 1>();  // row t's group (the oldest of RING) is in
#pragma unroll
    for (int b = 0; b < K; ++b)
      v[b] = j0 + b < BINS ? fmaxf(best[b], teleport) + s_obs[t % RING][j0 + b]
                           : -INFINITY;
    cur ^= 1;
    publish(cur, t);
  }
  cp_async_wait<0>();
}

// Block c: back[t] for its rows t in [lo, hi), lo = 1 + c * SPAN,
// hi = min(n, lo + SPAN), from rows[t-1]; then, chasing every start bin
// through them in shared memory, the span's map: maps[c][b] = path[lo-1]
// given path[hi-1] = b.
__global__ void __launch_bounds__(BACK_THREADS)
viterbi_back_kernel(const float* __restrict__ rows, const float* __restrict__ band,
                    short* __restrict__ back, short* __restrict__ maps, int n,
                    float log_eps) {
  __shared__ float s_row[BACK_ROW];
  __shared__ float s_wv[BACK_THREADS / 32];
  __shared__ unsigned s_wi[BACK_THREADS / 32];
  __shared__ short s_back[SPAN][BINS];
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
  const bool active = j < BINS;
  float bnd[BW];
#pragma unroll
  for (int d = 0; d < BW; ++d) bnd[d] = active ? band[j * BW + d] : -INFINITY;
  for (int i = j; i < BACK_ROW; i += BACK_THREADS) s_row[i] = -INFINITY;
  const int lo = 1 + blockIdx.x * SPAN, hi = min(n, lo + SPAN);
  float x = active ? rows[(size_t)(lo - 1) * BINS + j] : -INFINITY;
  for (int t = lo; t < hi; ++t) {
    __syncthreads();  // the previous row's reads are done
    s_row[HALF + j] = x;
    const float wv = warp_max(x);
    const unsigned wi = warp_first(x, wv, j);
    if (lane == 0) {
      s_wv[warp] = wv;
      s_wi[warp] = wi;
    }
    if (active && t + 1 < hi) x = rows[(size_t)t * BINS + j];
    __syncthreads();
    const float sv = lane < BACK_THREADS / 32 ? s_wv[lane] : -INFINITY;
    const float M = warp_max(sv);
    const int m = (int)warp_first(sv, M, lane < BACK_THREADS / 32 ? s_wi[lane] : 0);
    const float sub = t > 1 ? M : 0.f;
    const float teleport = (M - sub) + log_eps;
    float c[BW];
#pragma unroll
    for (int d = 0; d < BW; ++d) c[d] = (s_row[j + d] - sub) + bnd[d];
    float best = c[0];
#pragma unroll
    for (int d = 1; d < BW; ++d) best = fmaxf(best, c[d]);
    int bd = BW - 1;
#pragma unroll
    for (int d = BW - 2; d >= 0; --d) bd = c[d] == best ? d : bd;
    const int bi = j + bd - HALF;
    const bool take = teleport > best || (teleport == best && m < bi);
    if (active) {
      const short p = (short)(take ? m : bi);
      s_back[t - lo][j] = p;
      back[(size_t)t * BINS + j] = p;
    }
  }
  __syncthreads();
  if (active) {
    int b = j;
    for (int t = hi - 1; t >= lo; --t) b = s_back[t - lo][b];
    maps[(size_t)blockIdx.x * BINS + j] = (short)b;
  }
}

__device__ __forceinline__ int ld_shared_u16(unsigned addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// path[n-1 ..] = the first-index argmax of rows[n-1]. Then one thread
// chases the spans' maps from the last to the first, streamed through
// shared memory (path[lo-1] of every span), and every thread walks whole
// spans from their ends through back: path[t-1] = back[t][path[t]].
__global__ void __launch_bounds__(WALK_THREADS, 1)
viterbi_walk_kernel(const float* __restrict__ rows, const short* __restrict__ back,
                    const short* __restrict__ maps, int* __restrict__ path, int T,
                    int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  short* s_maps = reinterpret_cast<short*>(smem_raw);  // [2][WALK_MAPS][BINS]
  __shared__ int s_out[WALK_MAPS];
  __shared__ float s_wv[WALK_THREADS / 32];
  __shared__ unsigned s_wi[WALK_THREADS / 32];
  __shared__ int s_end;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int spans = (n - 1 + SPAN - 1) / SPAN;
  const int chunks = (spans + WALK_MAPS - 1) / WALK_MAPS;
  // chunk k holds the maps of spans hi - r (r = 0 .. count - 1),
  // hi = spans - 1 - k * WALK_MAPS
  auto load = [&](int k) {
    if (k < chunks) {
      const int hi = spans - 1 - k * WALK_MAPS;
      const int count = min(WALK_MAPS, hi + 1);
      short* dst = s_maps + (k & 1) * WALK_MAPS * BINS;
      for (int idx = tid; idx < count * ROW_VECS; idx += WALK_THREADS) {
        const int r = idx / ROW_VECS, u = idx - r * ROW_VECS;
        cp_async16(dst + r * BINS + u * 8, maps + (size_t)(hi - r) * BINS + u * 8);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  load(0);
  load(1);

  // the end bin: each thread's first max over its bins, then the lowest
  // bin holding the block's max
  float tv = -INFINITY;
  int ti = BINS;
  for (int j = tid; j < BINS; j += WALK_THREADS) {
    const float x = rows[(size_t)(n - 1) * BINS + j];
    if (x > tv) {
      tv = x;
      ti = j;
    }
  }
  const float wv = warp_max(tv);
  const unsigned wi = warp_first(tv, wv, ti);
  if (lane == 0) {
    s_wv[warp] = wv;
    s_wi[warp] = wi;
  }
  __syncthreads();
  if (tid == 0) {
    float M = s_wv[0];
    for (int w = 1; w < WALK_THREADS / 32; ++w) M = fmaxf(M, s_wv[w]);
    unsigned e = 0xffffffffu;
    for (int w = 0; w < WALK_THREADS / 32; ++w)
      if (s_wv[w] == M) e = min(e, s_wi[w]);
    s_end = (int)e;
  }
  __syncthreads();
  int b = s_end;
  for (int t = n - 1 + tid; t < T; t += WALK_THREADS) path[t] = b;

  for (int k = 0; k < chunks; ++k) {
    const int hi = spans - 1 - k * WALK_MAPS;
    const int count = min(WALK_MAPS, hi + 1);
    cp_async_wait<1>();
    __syncthreads();
    if (tid == 0) {
      unsigned addr = static_cast<unsigned>(
          __cvta_generic_to_shared(s_maps + (k & 1) * WALK_MAPS * BINS));
      for (int r = 0; r < count; ++r, addr += BINS * sizeof(short)) {
        b = ld_shared_u16(addr + 2 * b);
        s_out[r] = b;
      }
    }
    __syncthreads();
    if (tid < count) path[(hi - tid) * SPAN] = s_out[tid];  // path[lo - 1]
    load(k + 2);
  }
  cp_async_wait<0>();
  __syncthreads();  // every span's end entry path[hi - 1] is written
  for (int c = tid; c < spans; c += WALK_THREADS) {
    const int lo = 1 + c * SPAN, hi = min(n, lo + SPAN);
    int p = path[hi - 1];
    for (int t = hi - 1; t > lo; --t) {
      p = back[(size_t)t * BINS + p];
      path[t - 1] = p;
    }
  }
}

}  // namespace

// log_obs (T, 360) fp32; band (360, 23) fp32; scratch: rows (n, 360) fp32,
// back (n, 360) int16 (row 0 unused), maps (ceil((n-1) / 16), 360) int16;
// path (T,) int32; 1 <= n <= T. The three launches on one stream.
POLGEN_API int viterbi_forward(const void* log_obs, const void* band, void* rows,
                               int n, float log_eps, float log_init, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  viterbi_forward_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_obs), static_cast<const float*>(band),
      static_cast<float*>(rows), n, log_eps, log_init);
  return (int)cudaGetLastError();
}

POLGEN_API int viterbi_backpointers(const void* rows, const void* band, void* back,
                                    void* maps, int n, float log_eps, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  if (n == 1) return (int)cudaSuccess;
  viterbi_back_kernel<<<(n - 1 + SPAN - 1) / SPAN, BACK_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(band),
      static_cast<short*>(back), static_cast<short*>(maps), n, log_eps);
  return (int)cudaGetLastError();
}

POLGEN_API int viterbi_walk(const void* rows, const void* back, const void* maps,
                            void* path, int T, int n, void* stream) {
  if (T < 1 || n < 1 || n > T) return (int)cudaErrorInvalidValue;
  const int smem = 2 * WALK_MAPS * BINS * (int)sizeof(short);
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  viterbi_walk_kernel<<<1, WALK_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const short*>(back),
      static_cast<const short*>(maps), static_cast<int*>(path), T, n);
  return (int)cudaGetLastError();
}
