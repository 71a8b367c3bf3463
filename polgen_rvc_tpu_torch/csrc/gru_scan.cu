// RMVPE's bidirectional GRU recurrence, both directions, in one launch
// (torch gate order: reset r, update z, new n):
//
//   r  = sigmoid(gx_r[t] + W_hr h)         gx_r, gx_z carry b_ih + b_hr, b_hz
//   z  = sigmoid(gx_z[t] + W_hz h)
//   n  = tanh(gx_n[t] + r * (W_hn h + b_hn))
//   h' = (1 - z) * n + z * h               h = 0 before the first step
//
// The input projection gx = x W_ih^T + b of every step and both directions
// is one matrix product before the launch (ops/rnn.py), as the JAX
// package's lax.scan GRU hoists it (polgen_rvc_tpu/ops/rnn.py:bigru). That
// package has no TPU kernel for the recurrence; this one replaces the
// per-step cuDNN RNN kernels (a gemv and an elementwise cell a step and
// direction) that torch.nn.GRU launched.
//
// Bound: neither bytes nor operations. Each step does 3 x 256 x 256 fp32
// multiply-adds a direction (4.7 GFLOP for a minute of audio, 6,000 steps:
// 70 us at the card's 67 TFLOP/s of fp32, 0.6 ms at the 16 SMs' share of
// it), but step t + 1 needs every unit of step t, so the time is one
// step's latency after another: the serial floor of the recurrence. Within
// a step the 96 KB of weights each CTA reads from shared memory (768
// cycles at 128 bytes a cycle) is the longest part.
//
// Design: one thread-block cluster of 8 CTAs for each (batch row,
// direction). Each CTA owns 32 hidden units and keeps their 96 rows of
// W_hh (r, z, n; 96 KB fp32) and their b_hn in shared memory for the whole
// sequence. A step:
//   1. every thread reads its 8 of the 256 values of h(t-1) from its own
//      CTA's shared memory (lane l: elements 4l..4l+3 and 128+4l..128+4l+3,
//      conflict-free 16-byte loads);
//   2. each warp owns 4 units, 12 rows: each lane multiplies its 8 values
//      into the 12 rows (fp32 FMAs), then the 12 partial sums are reduced
//      over the warp by 18 shuffles (halving twice, then a butterfly of
//      3), which leaves the lanes 8u..8u+7 holding unit u's three sums,
//      bit for bit alike;
//   3. each of those 8 lanes applies the gates (full-precision expf and
//      tanhf) and stores h'(unit) into the next h buffer of one CTA of the
//      cluster through distributed shared memory (lane 8u + k into CTA k);
//      lane 8u also writes the output;
//   4. one cluster barrier (arrive.release, then wait.acquire). The h
//      buffer is double-buffered, so a store into buffer (t + 1) & 1 never
//      meets a read of step t: a CTA reaches step t + 1's stores only after
//      every CTA arrived at the end of step t. Between arrive and wait each
//      lane loads its unit's three gx values of the next step.
// The backward direction walks t = T-1 .. 0 over the whole T, as
// torch.nn.GRU does. Outputs: (B, T, 512), forward in [0, 256), backward
// in [256, 512). Built without --use_fast_math.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int H = 256;                     // hidden units a direction
constexpr int G = 3 * H;                   // one direction's gate columns of gx
constexpr int CLUSTER = 8;                 // CTAs a (batch row, direction)
constexpr int UNITS = H / CLUSTER;         // 32 hidden units a CTA
constexpr int THREADS = 256;               // 8 warps
constexpr int WARP_UNITS = UNITS / (THREADS / 32);  // 4 units a warp
constexpr int WARP_ROWS = 3 * WARP_UNITS;  // 12 rows of W_hh a warp
constexpr unsigned FULL = 0xffffffffu;
// W_hh rows [unit][gate][H], then two h buffers, then b_hn of the units
constexpr size_t SMEM_BYTES = sizeof(float) * ((size_t)UNITS * 3 * H + 2 * H + UNITS);

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float dot8(float4 w0, float4 w1, float4 h0, float4 h1) {
  float a = w0.x * h0.x;
  a = fmaf(w0.y, h0.y, a);
  a = fmaf(w0.z, h0.z, a);
  a = fmaf(w0.w, h0.w, a);
  a = fmaf(w1.x, h1.x, a);
  a = fmaf(w1.y, h1.y, a);
  a = fmaf(w1.z, h1.z, a);
  return fmaf(w1.w, h1.w, a);
}

// gx: (B, T, 2G) fp32, gx[b, t, d*G + g*H + j]; w_hh: (2, H, 3, H) fp32,
// w_hh[d, j, g, k] = W_hh_d[g*H + j, k]; b_hn: (2, H); out: (B, T, 2H).
// Grid: 2B clusters of CLUSTER CTAs, cluster c = 2b + d.
__global__ void __launch_bounds__(THREADS, 1)
gru_scan_kernel(const float* __restrict__ gx, const float* __restrict__ w_hh,
                const float* __restrict__ b_hn, float* __restrict__ out, int T) {
  extern __shared__ __align__(16) float smem[];
  float* w = smem;                          // [UNITS][3][H]
  float* hbuf = smem + (size_t)UNITS * 3 * H;  // [2][H]
  float* bn = hbuf + 2 * H;                 // [UNITS]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int seq = blockIdx.x / CLUSTER;
  const int b = seq >> 1, dir = seq & 1;
  const int j0 = rank * UNITS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  {
    const float4* src =
        reinterpret_cast<const float4*>(w_hh + ((size_t)dir * H + j0) * 3 * H);
    float4* dst = reinterpret_cast<float4*>(w);
    for (int i = tid; i < UNITS * 3 * H / 4; i += THREADS) dst[i] = src[i];
    for (int i = tid; i < H; i += THREADS) hbuf[i] = 0.0f;
    if (tid < UNITS) bn[tid] = b_hn[dir * H + j0 + tid];
  }
  // every CTA of the cluster running, its h(-1) zeroed, before any remote store
  cluster.sync();

  const int u = lane >> 3;                 // the unit this lane finishes
  const int jl = warp * WARP_UNITS + u;    // its index in the CTA
  const int j = j0 + jl;
  const int peer = lane & 7;               // the CTA it stores h' into
  const float4* rows = reinterpret_cast<const float4*>(w + (size_t)warp * WARP_ROWS * H);
  const float bias_n = bn[jl];
  float* remote = cluster.map_shared_rank(hbuf, peer);
  const bool hi16 = lane & 16, hi8 = lane & 8;
  const size_t row_stride = (size_t)2 * G;
  const float* gx_unit = gx + (size_t)b * T * row_stride + (size_t)dir * G + j;
  float* out_unit = out + (size_t)b * T * 2 * H + (size_t)dir * H + j;

  int t = dir ? T - 1 : 0;
  float xr = gx_unit[(size_t)t * row_stride];
  float xz = gx_unit[(size_t)t * row_stride + H];
  float xn = gx_unit[(size_t)t * row_stride + 2 * H];
  for (int s = 0; s < T; ++s) {
    const float* hcur = hbuf + (s & 1) * H;
    const float4 h0 = reinterpret_cast<const float4*>(hcur)[lane];
    const float4 h1 = reinterpret_cast<const float4*>(hcur)[lane + 32];
    float acc[WARP_ROWS];
#pragma unroll
    for (int r = 0; r < WARP_ROWS; ++r)
      acc[r] = dot8(rows[r * (H / 4) + lane], rows[r * (H / 4) + lane + 32], h0, h1);
    // rows 0..5 are units 0, 1 of the warp, 6..11 units 2, 3: lanes with
    // bit 4 set keep the second half, then bit 3 picks one unit of the half
    float half[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float keep = hi16 ? acc[i + 6] : acc[i];
      const float send = hi16 ? acc[i] : acc[i + 6];
      half[i] = keep + __shfl_xor_sync(FULL, send, 16);
    }
    float g3[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float keep = hi8 ? half[i + 3] : half[i];
      const float send = hi8 ? half[i] : half[i + 3];
      g3[i] = keep + __shfl_xor_sync(FULL, send, 8);
    }
#pragma unroll
    for (int off = 4; off >= 1; off >>= 1) {
#pragma unroll
      for (int i = 0; i < 3; ++i) g3[i] += __shfl_xor_sync(FULL, g3[i], off);
    }
    const float r = sigmoid(xr + g3[0]);
    const float z = sigmoid(xz + g3[1]);
    const float n = tanhf(xn + r * (g3[2] + bias_n));
    const float h = (1.0f - z) * n + z * hcur[j];
    remote[((s + 1) & 1) * H + j] = h;
    if (peer == 0) out_unit[(size_t)t * 2 * H] = h;
    cluster_arrive_release();
    if (s + 1 < T) {
      t = dir ? T - 2 - s : s + 1;
      xr = gx_unit[(size_t)t * row_stride];
      xz = gx_unit[(size_t)t * row_stride + H];
      xn = gx_unit[(size_t)t * row_stride + 2 * H];
    }
    cluster_wait_acquire();
  }
}

}  // namespace

// gx: (B, T, 1536) fp32, the input projections with b_ih and the r, z parts
// of b_hh added, forward then backward, each r, z, n; w_hh: (2, 256, 3, 256)
// fp32 (ops/rnn.py:pack_gru_weights); b_hn: (2, 256) fp32; out: (B, T, 512)
// fp32. All contiguous, on the device current for the call.
POLGEN_API int gru_scan(const void* gx, const void* w_hh, const void* b_hn, void* out,
                        int B, int T, void* stream) {
  if (B < 1 || T < 1 || B > (1 << 20)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * 2 * B, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gru_scan_kernel, static_cast<const float*>(gx),
                           static_cast<const float*>(w_hh),
                           static_cast<const float*>(b_hn), static_cast<float*>(out), T);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
