// VITS windowed relative-position attention in one streaming-softmax pass:
//
//   s[t,u]  = q[t].k[u] + (|u-t| <= w ? q[t].rel_k[u-t+w] : 0)   (q pre-scaled)
//   p[t,:]  = softmax over u < length of s[t,:]
//   out[t]  = sum_u p[t,u] v[u] + sum_{|d|<=w} p[t,t+d] rel_v[d+w]
//
// Replaces polgen_rvc_tpu/ops/flash_relattn.py:flash_band_attention. Rows
// t >= length hold unspecified (finite) values, as there.
//
// Bound: operations (4*T^2*dk FLOP per (batch, head) over the valid keys;
// at T ~ 3,600 and dk = 96 that is ~5 GFLOP per head per layer) at the
// bf16 tensor-core rate, with q, k, v read once. Design: a flash-attention
// pass on mma.sync m16n8k16, bf16 operands, fp32 accumulators. A block owns
// 64 query rows of one (batch, head), 16 per warp, and walks key tiles of
// 64 up to the row block's length (later tiles are skipped). q stays in
// registers as A fragments; each key tile is staged once in shared memory,
// k row-major for q.k^T and v read through ldmatrix.trans as the B operand
// of p.v, so no transpose pass exists. The softmax is online in fp32 in the
// score fragments (row max and sum across the four lanes of a row); p is
// rounded to bf16 for the value product, as flash kernels do. The band
// terms cost only where the +-w band crosses a tile: the rel-key logits
// q.rel_k are computed once per block (64 x (2w+1), fp32) and added to the
// scores there, and the warp writes its fp32 probabilities to its own
// shared tile so each lane adds p[t,t+d] rel_v[d+w] to its output columns.
// No T x T array exists anywhere. Not pipelined: the next tile's loads wait
// for this tile's products (later work: cp.async double buffering, wgmma).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // four warps
constexpr int MAXD = 128;
constexpr int PS = BK + 4;    // fp32 row stride of a warp's probability tile
constexpr float NEG = -1e30f;

// Two 8x8 bf16 matrices from shared memory, transposed: lanes 0-15 give the
// row addresses (16-byte aligned). Lane (g, q) receives M0[2q..2q+1][g] and
// M1[2q..2q+1][g]: the B fragment of mma.sync for a row-major [k][n] tile.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* b,
                                              const __nv_bfloat16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(addr));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
band_attention_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ relk,
                      const __nv_bfloat16* __restrict__ relv,
                      const int* __restrict__ lengths, OutT* __restrict__ out,
                      int T, int D, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SD = D + 8;      // bf16 row stride: 16-byte rows, no bank conflicts
  const int NR = 2 * W + 1;  // band width
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x SD
  __nv_bfloat16* ks = qs + BQ * SD;                                 // BK x SD
  __nv_bfloat16* vs = ks + BK * SD;                                 // BK x SD
  float* ps = reinterpret_cast<float*>(vs + BK * SD);  // 4 warps x 16 x PS
  float* rv = ps + 4 * 16 * PS;                        // NR x D
  float* qr = rv + NR * D;                             // BQ x NR

  const int bh = blockIdx.y;
  const int t0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int row0 = warp * 16;  // the warp's first row in the block
  const int len = min(lengths[bh], T);
  const size_t base = (size_t)bh * T * D;
  const int DV = D / 8;    // 16-byte vectors per row
  const int KD = D / 16;   // mma depth steps over D
  const int ND = D / 8;    // 8-wide output column tiles

  for (int idx = tid; idx < BQ * DV; idx += THREADS) {
    const int i = idx / DV, c = idx - i * DV;
    const int t = t0 + i;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) val = *reinterpret_cast<const uint4*>(q + base + (size_t)t * D + c * 8);
    *reinterpret_cast<uint4*>(qs + i * SD + c * 8) = val;
  }
  for (int idx = tid; idx < NR * D; idx += THREADS)
    rv[idx] = __bfloat162float(relv[idx]);
  __syncthreads();
  // rel-key logits of the block's rows (products of bf16 values, exact in
  // fp32); read after the first tile's barrier
  for (int idx = tid; idx < BQ * NR; idx += THREADS) {
    const int i = idx / NR, r = idx - i * NR;
    float s = 0.f;
    for (int d = 0; d < D; ++d)
      s += __bfloat162float(qs[i * SD + d]) * __bfloat162float(relk[r * D + d]);
    qr[idx] = s;
  }

  uint32_t qa[MAXD / 16][4];
#pragma unroll
  for (int kk = 0; kk < MAXD / 16; ++kk) {
    if (kk < KD) {
      const __nv_bfloat16* p = qs + (row0 + g) * SD + kk * 16 + 2 * qd;
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SD);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SD + 8);
    }
  }

  // output accumulators: rows g (elements 0, 1) and g + 8 (2, 3), columns
  // dn * 8 + 2q (+1)
  float o[MAXD / 8][4];
#pragma unroll
  for (int dn = 0; dn < MAXD / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};
  float* pw = ps + warp * 16 * PS;
  const int tw = t0 + row0;  // the warp's first query position

  for (int k0 = 0; k0 < len; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * DV; idx += THREADS) {
      const int j = idx / DV, c = idx - j * DV;
      const int u = k0 + j;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (u < T) {
        kv = *reinterpret_cast<const uint4*>(k + base + (size_t)u * D + c * 8);
        vv = *reinterpret_cast<const uint4*>(v + base + (size_t)u * D + c * 8);
      }
      *reinterpret_cast<uint4*>(ks + j * SD + c * 8) = kv;
      *reinterpret_cast<uint4*>(vs + j * SD + c * 8) = vv;
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MAXD / 16; ++kk) {
      if (kk < KD) {
#pragma unroll
        for (int nt = 0; nt < BK / 8; ++nt) {
          const __nv_bfloat16* p = ks + (nt * 8 + g) * SD + kk * 16 + 2 * qd;
          uint32_t b[2];
          b[0] = *reinterpret_cast<const uint32_t*>(p);
          b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
          mma_bf16_16816(s[nt], qa[kk], b);
        }
      }
    }
    const bool band = k0 <= tw + 15 + W && k0 + BK - 1 >= tw - W;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + g + (e >> 1) * 8;
        const int u = k0 + nt * 8 + 2 * qd + (e & 1);
        float val = s[nt][e];
        if (band) {
          const int off = u - (t0 + i) + W;
          if (off >= 0 && off < NR) val += qr[i * NR + off];
        }
        s[nt][e] = u < len ? val : NEG;
      }

    // online softmax of rows g (h = 0) and g + 8 (h = 1); key 0 is always
    // valid, so every row's running max is finite after the first tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      const float alpha = expf(m_run[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[nt][e] = expf(s[nt][e] - m_new);
          sum += s[nt][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[h] = l_run[h] * alpha + sum;
      m_run[h] = m_new;
#pragma unroll
      for (int dn = 0; dn < MAXD / 8; ++dn) {
        o[dn][2 * h] *= alpha;
        o[dn][2 * h + 1] *= alpha;
      }
    }

    // p.v: the score fragments are the A fragments of the product
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(__float2bfloat16(s[2 * kk][0]), __float2bfloat16(s[2 * kk][1]));
      pa[1] = pack_bf16x2(__float2bfloat16(s[2 * kk][2]), __float2bfloat16(s[2 * kk][3]));
      pa[2] = pack_bf16x2(__float2bfloat16(s[2 * kk + 1][0]),
                          __float2bfloat16(s[2 * kk + 1][1]));
      pa[3] = pack_bf16x2(__float2bfloat16(s[2 * kk + 1][2]),
                          __float2bfloat16(s[2 * kk + 1][3]));
      const __nv_bfloat16* vrow = vs + (kk * 16 + (lane & 15)) * SD;
#pragma unroll
      for (int dn = 0; dn < MAXD / 8; ++dn) {
        if (dn < ND) {
          uint32_t b[2];
          ldsm_x2_trans(b, vrow + dn * 8);
          mma_bf16_16816(o[dn], pa, b);
        }
      }
    }

    // rel-value band: p[t, t+d] rel_v[d+w] from the warp's fp32 probabilities
    if (band) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store2(pw + (g + 8 * h) * PS + nt * 8 + 2 * qd, s[nt][2 * h],
                 s[nt][2 * h + 1]);
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = tw + g + 8 * h;
        for (int r = 0; r < NR; ++r) {
          const int j = t - W + r - k0;
          if (j < 0 || j >= BK) continue;
          const float pj = pw[(g + 8 * h) * PS + j];
          const float* rvr = rv + r * D + 2 * qd;
#pragma unroll
          for (int dn = 0; dn < MAXD / 8; ++dn) {
            if (dn < ND) {
              o[dn][2 * h] += pj * rvr[dn * 8];
              o[dn][2 * h + 1] += pj * rvr[dn * 8 + 1];
            }
          }
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = tw + g + 8 * h;
    if (t >= T) continue;
    const float inv = 1.f / l_run[h];
    OutT* orow = out + base + (size_t)t * D + 2 * qd;
#pragma unroll
    for (int dn = 0; dn < MAXD / 8; ++dn)
      if (dn < ND) store2(orow + dn * 8, o[dn][2 * h] * inv, o[dn][2 * h + 1] * inv);
  }
}

template <typename OutT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* relk, const void* relv, const void* lengths,
                   void* out, int BH, int T, int D, int W, cudaStream_t stream) {
  const int NR = 2 * W + 1;
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(BQ + 2 * BK) * (D + 8) +
                      sizeof(float) * ((size_t)4 * 16 * PS + (size_t)NR * D +
                                       (size_t)BQ * NR);
  cudaError_t err = cudaFuncSetAttribute(
      band_attention_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, BH);
  band_attention_kernel<OutT><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(relk),
      static_cast<const __nv_bfloat16*>(relv), static_cast<const int*>(lengths),
      static_cast<OutT*>(out), T, D, W);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (BH, T, D) bf16, q already scaled by 1/sqrt(D); relk, relv:
// (2W+1, D) bf16; lengths: (BH,) int32, each >= 1; out: (BH, T, D), fp32
// when out_f32 else bf16. D is a multiple of 16, at most 128.
POLGEN_API int band_attention(const void* q, const void* k, const void* v,
                              const void* relk, const void* relv,
                              const void* lengths, void* out, int BH, int T,
                              int D, int W, int out_f32, void* stream) {
  if (D < 16 || D > MAXD || D % 16 != 0 || W < 0 || BH < 1 || T < 1 ||
      BH > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      out_f32 ? launch<float>(q, k, v, relk, relv, lengths, out, BH, T, D, W, s)
              : launch<__nv_bfloat16>(q, k, v, relk, relv, lengths, out, BH, T,
                                      D, W, s);
  return (int)err;
}
