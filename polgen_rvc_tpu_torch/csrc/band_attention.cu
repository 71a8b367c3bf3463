// VITS windowed relative-position attention in one streaming-softmax pass:
//
//   s[t,u]  = q[t].k[u] + (|u-t| <= w ? q[t].rel_k[u-t+w] : 0)   (q pre-scaled)
//   p[t,:]  = softmax over u < length of s[t,:]
//   out[t]  = sum_u p[t,u] v[u] + sum_{|d|<=w} p[t,t+d] rel_v[d+w]
//
// Replaces polgen_rvc_tpu/ops/flash_relattn.py:flash_band_attention. Rows
// t >= length hold unspecified (finite) values, as there; a block whose
// rows all lie at or past the length writes zeros.
//
// Bound: operations (4*T^2*dk FLOP per (batch, head) over the valid keys;
// at T ~ 3,600 and dk = 96 that is ~5 GFLOP per head per layer) at the
// bf16 tensor-core rate, with q, k, v read once. Design: a flash-attention
// pass on mma.sync m16n8k16, bf16 operands, fp32 accumulators.
//
// - Work. A 64-row query block of one (batch, head) is split over a
//   2-CTA thread-block cluster: CTA 0 walks the first half of the key tiles
//   up to the row's length, CTA 1 the second, so the main path's 202 live
//   row blocks become 404 CTAs of 21-29 tiles, about the 396 slots of
//   three CTAs an SM. At the end CTA 1 writes its softmax state (running
//   max m, sum l, unnormalized o) into CTA 0's shared memory through the
//   cluster's distributed shared memory (over its now idle key ring, after
//   a cluster barrier), and CTA 0 merges the two and writes the rows.
//   Blocks wholly past their row's length write zeros and return before
//   any key tile. Rows are taken longest first, so the last wave holds
//   short rows' blocks.
// - Loads. Each CTA holds 64 query rows, 16 per warp, q as A fragments in
//   registers (ldmatrix.x4). Key/value tiles of 64 go through a two-slot
//   cp.async ring, one barrier a tile: the next tile's copy is in flight
//   during this tile's products. K's B fragments come by ldmatrix.x4, V's
//   by ldmatrix.x4.trans (no transpose pass). rel_k borrows the ring's
//   second slot and q's tile gives way to the rel-key logits and band
//   probabilities once its fragments are loaded: 73 KB of shared memory
//   and at most 168 registers a thread fit three CTAs an SM. Only a row's
//   last tile masks keys past its length.
// - Softmax online in fp32 in the score fragments, in base 2: one FFMA
//   folds log2(e) and the running max, then ex2.approx. p is rounded to
//   bf16 for the value product, as flash kernels do.
// - Band terms only where the +-w band crosses a tile. q.rel_k is one small
//   tensor-core product per warp from rel_k staged in shared memory (fp32
//   in shared, added to the scores there); each warp scatters its fp32
//   band probabilities into a (16, 2w+1) table so each lane adds
//   p[t,t+d] rel_v[d+w] to its output columns in fp32.
// No T x T array exists anywhere. Not here: wgmma, TMA.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // four warps
constexpr int STAGES = 2;     // key/value ring slots
constexpr int MIN_BLOCKS = 3; // CTAs an SM: at most 168 registers a thread
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i .. 8i+7 give the
// row addresses of matrix i (16-byte aligned). Lane (g, q) receives row g,
// elements 2q and 2q + 1 of each (transposed: column g, rows 2q, 2q + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const __nv_bfloat16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__host__ __device__ constexpr int band_rows_padded(int nr) { return (nr + 7) & ~7; }

// Bytes of the area that holds q's tile in the prologue and the rel-key
// logits and band probabilities (BQ x NRP fp32 each) after it.
__host__ __device__ constexpr int q_area_bytes(int d, int nrp) {
  return BQ * (d + 8) * 2 > 2 * BQ * nrp * 4 ? BQ * (d + 8) * 2 : 2 * BQ * nrp * 4;
}

// Shared memory of one CTA, in bytes, for head width d and band 2w + 1:
// the ring (rel_k borrows slot 1 in the prologue), the q area, rel_v.
size_t smem_bytes(int d, int w) {
  return sizeof(__nv_bfloat16) * (size_t)STAGES * 2 * BK * (d + 8) +
         q_area_bytes(d, band_rows_padded(2 * w + 1)) +
         sizeof(float) * (size_t)(2 * w + 1) * d;
}

// The (batch, head) row of this CTA: blockIdx.y-th in order of decreasing
// length (ties by index), so that the longest rows' blocks are scheduled
// first and the last wave holds short ones. Quadratic in the rows, so only
// up to 64 of them; past that, in index order.
__device__ __forceinline__ int row_by_length(const int* lengths, int T) {
  const int rows = gridDim.y;
  if (rows > 64) return blockIdx.y;
  for (int b = 0; b < rows; ++b) {
    const int lb = min(lengths[b], T);
    int before = 0;
    for (int c = 0; c < rows; ++c) {
      const int lc = min(lengths[c], T);
      before += lc > lb || (lc == lb && c < b);
    }
    if (before == (int)blockIdx.y) return b;
  }
  return blockIdx.y;
}

// DT: the head width when fixed at compile time (96, the models' width),
// else 0 and the width D <= 128 comes at run time.
template <int DT, typename OutT>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, MIN_BLOCKS)
band_attention_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ relk,
                      const __nv_bfloat16* __restrict__ relv,
                      const int* __restrict__ lengths, OutT* __restrict__ out,
                      int T, int d_arg, int W) {
  constexpr int MAXD = DT ? DT : 128;
  const int D = DT ? DT : d_arg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SD = D + 8;  // bf16 row stride: 16-byte rows, no bank conflicts
  const int NR = 2 * W + 1, NRP = band_rows_padded(NR);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  // prologue only: rel_k (NRP x SD, zero rows >= NR) in ring slot 1, q's
  // tile (BQ x SD) in the q area; then the q area holds qr and pb
  __nv_bfloat16* rks = ring + 2 * BK * SD;
  __nv_bfloat16* qs = ring + STAGES * 2 * BK * SD;
  float* qr = reinterpret_cast<float*>(qs);            // BQ x NRP
  float* pb = qr + BQ * NRP;                           // BQ x NRP
  float* rv = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(qs) +
                                       q_area_bytes(D, NRP));  // NR x D
  // CTA 1's state for the merge, over CTA 0's ring once both are done
  float* mo = reinterpret_cast<float*>(smem_raw);      // BQ x D
  float* mm = mo + BQ * D;                             // BQ
  float* ml = mm + BQ;                                 // BQ

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int bh = row_by_length(lengths, T);
  const int t0 = (blockIdx.x >> 1) * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, qd = lane & 3;
  const int row0 = warp * 16;  // the warp's first row in the block
  const int len = min(lengths[bh], T);
  const size_t base = (size_t)bh * T * D;
  const int DV = D / 8;   // 16-byte vectors per row
  const int KD = D / 16;  // mma depth steps over D
  const int ND = D / 8;   // 8-wide output column tiles

  if (t0 >= len) {  // every row past the length: zeros, half a CTA each
    for (int idx = tid; idx < (BQ / 2) * (D / 2); idx += THREADS) {
      const int i = idx / (D / 2), c = idx - i * (D / 2);
      const int t = t0 + (int)rank * (BQ / 2) + i;
      if (t < T) store2(out + base + (size_t)t * D + 2 * c, 0.f, 0.f);
    }
    return;
  }
  const int n_tiles = (len + BK - 1) / BK, split = (n_tiles + 1) / 2;
  const int tile_begin = rank ? split : 0, tile_end = rank ? n_tiles : split;

  auto load_tile = [&](int i, int slot) {
    __nv_bfloat16* ks = ring + slot * 2 * BK * SD;
    __nv_bfloat16* vs = ks + BK * SD;
    for (int idx = tid; idx < BK * DV; idx += THREADS) {
      const int j = idx / DV, c = idx - j * DV;
      const int u = i * BK + j;
      const size_t off = base + (size_t)(u < T ? u : 0) * D + c * 8;
      cp_async16(ks + j * SD + c * 8, k + off, u < T);
      cp_async16(vs + j * SD + c * 8, v + off, u < T);
    }
    cp_async_commit();
  };
  if (tile_begin < tile_end) load_tile(tile_begin, 0);

  for (int idx = tid; idx < BQ * DV; idx += THREADS) {
    const int i = idx / DV, c = idx - i * DV;
    const int t = t0 + i;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) val = *reinterpret_cast<const uint4*>(q + base + (size_t)t * D + c * 8);
    *reinterpret_cast<uint4*>(qs + i * SD + c * 8) = val;
  }
  for (int idx = tid; idx < NRP * DV; idx += THREADS) {
    const int r = idx / DV, c = idx - r * DV;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < NR) val = *reinterpret_cast<const uint4*>(relk + (size_t)r * D + c * 8);
    *reinterpret_cast<uint4*>(rks + r * SD + c * 8) = val;
  }
  for (int idx = tid; idx < NR * D; idx += THREADS)
    rv[idx] = __bfloat162float(relv[idx]);
  __syncthreads();

  // q as A fragments: matrices (rows 0-7, 8-15) x (depth 0-7, 8-15)
  uint32_t qa[MAXD / 16][4];
#pragma unroll
  for (int kk = 0; kk < MAXD / 16; ++kk)
    if (kk < KD) ldsm_x4(qa[kk], qs + (row0 + (lane & 15)) * SD + kk * 16 + (lane >> 4) * 8);
  __syncthreads();  // every warp has its q fragments: the q area is free

  // rel-key logits of the warp's rows on the tensor cores (products of
  // bf16 values, fp32 sums), then into the warp's rows of qr
  float* qrw = qr + row0 * NRP;
  for (int nt = 0; nt < NRP / 8; ++nt) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < MAXD / 16; ++kk) {
      if (kk < KD) {
        const __nv_bfloat16* p = rks + (nt * 8 + g) * SD + kk * 16 + 2 * qd;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(p);
        b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
        mma_bf16_16816(acc, qa[kk], b);
      }
    }
    store2(qrw + g * NRP + nt * 8 + 2 * qd, acc[0], acc[1]);
    store2(qrw + (g + 8) * NRP + nt * 8 + 2 * qd, acc[2], acc[3]);
  }
  __syncwarp();

  // output accumulators: rows g (elements 0, 1) and g + 8 (2, 3), columns
  // dn * 8 + 2q (+1)
  float o[MAXD / 8][4];
#pragma unroll
  for (int dn = 0; dn < MAXD / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};
  float* pbw = pb + row0 * NRP;
  const int tw = t0 + row0;  // the warp's first query position

  for (int i = tile_begin; i < tile_end; ++i) {
    const int slot = (i - tile_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile i is in; every warp is done with the other slot
    if (i + 1 < tile_end) load_tile(i + 1, slot ^ 1);
    const __nv_bfloat16* ks = ring + slot * 2 * BK * SD;
    const __nv_bfloat16* vs = ks + BK * SD;
    const int k0 = i * BK;

    // scores: 16 rows x 64 keys per warp; each ldmatrix.x4 gives two key
    // tiles' B fragments at one depth step
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MAXD / 16; ++kk) {
      if (kk < KD) {
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t b[4];
          ldsm_x4(b, ks + ((2 * np + (lane >> 4)) * 8 + (lane & 7)) * SD + kk * 16 +
                         ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[2 * np], qa[kk], b);
          mma_bf16_16816(s[2 * np + 1], qa[kk], b + 2);
        }
      }
    }
    const bool band = k0 <= tw + 15 + W && k0 + BK - 1 >= tw - W;
    if (band) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + (e >> 1) * 8;  // the warp's row
          const int off = k0 + nt * 8 + 2 * qd + (e & 1) - (tw + r) + W;
          if (off >= 0 && off < NR) s[nt][e] += qrw[r * NRP + off];
        }
    }
    if (k0 + BK > len) {  // the row's last tile: keys past the length
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nt * 8 + 2 * qd + (e & 1) >= len) s[nt][e] = NEG;
    }

    // online softmax of rows g (h = 0) and g + 8 (h = 1), base 2; the
    // first tile of a CTA has a valid key, so the running max is finite
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      const float mL = m_new * LOG2E;
      const float alpha = ex2(fmaf(m_run[h], LOG2E, -mL));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[nt][e] = ex2(fmaf(s[nt][e], LOG2E, -mL));
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

    // p.v: the score fragments are the A fragments of the product; each
    // ldmatrix.x4.trans gives two column tiles' B fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(__float2bfloat16(s[2 * kk][0]), __float2bfloat16(s[2 * kk][1]));
      pa[1] = pack_bf16x2(__float2bfloat16(s[2 * kk][2]), __float2bfloat16(s[2 * kk][3]));
      pa[2] = pack_bf16x2(__float2bfloat16(s[2 * kk + 1][0]),
                          __float2bfloat16(s[2 * kk + 1][1]));
      pa[3] = pack_bf16x2(__float2bfloat16(s[2 * kk + 1][2]),
                          __float2bfloat16(s[2 * kk + 1][3]));
      const __nv_bfloat16* vrow =
          vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * SD + (lane >> 4) * 8;
#pragma unroll
      for (int dp = 0; dp < MAXD / 16; ++dp) {
        if (dp < KD) {
          uint32_t b[4];
          ldsm_x4_trans(b, vrow + dp * 16);
          mma_bf16_16816(o[2 * dp], pa, b);
          mma_bf16_16816(o[2 * dp + 1], pa, b + 2);
        }
      }
    }

    // rel-value band: p[t, t+d] rel_v[d+w] from the warp's fp32
    // probabilities, scattered into its (16, NR) band table
    if (band) {
      for (int idx = lane; idx < 16 * NRP; idx += 32) pbw[idx] = 0.f;
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + (e >> 1) * 8;
          const int off = k0 + nt * 8 + 2 * qd + (e & 1) - (tw + r) + W;
          if (off >= 0 && off < NR) pbw[r * NRP + off] = s[nt][e];
        }
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* pr = pbw + (g + 8 * h) * NRP;
        for (int r = 0; r < NR; ++r) {
          const float pj = pr[r];
          const float* rvr = rv + r * D + 2 * qd;
#pragma unroll
          for (int dn = 0; dn < MAXD / 8; ++dn) {
            if (dn < ND) {
              const float2 rvv = *reinterpret_cast<const float2*>(rvr + dn * 8);
              o[dn][2 * h] += pj * rvv.x;
              o[dn][2 * h + 1] += pj * rvv.y;
            }
          }
        }
      }
      __syncwarp();
    }
  }

  // merge the two halves of the key range in CTA 0
  cluster.sync();  // both CTAs are done with their rings
  if (rank == 1) {
    float* rmo = cluster.map_shared_rank(mo, 0);
    float* rmm = cluster.map_shared_rank(mm, 0);
    float* rml = cluster.map_shared_rank(ml, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
#pragma unroll
      for (int dn = 0; dn < MAXD / 8; ++dn)
        if (dn < ND) store2(rmo + r * D + dn * 8 + 2 * qd, o[dn][2 * h], o[dn][2 * h + 1]);
      if (qd == 0) {
        rmm[r] = m_run[h];
        rml[r] = l_run[h];
      }
    }
  }
  cluster.sync();  // CTA 1's state is in CTA 0's shared memory
  if (rank == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    const int t = t0 + r;
    const float m1 = mm[r], m = fmaxf(m_run[h], m1);
    const float a0 = ex2((m_run[h] - m) * LOG2E), a1 = ex2((m1 - m) * LOG2E);
    const float inv = 1.f / (l_run[h] * a0 + ml[r] * a1);
    if (t >= T) continue;
    OutT* orow = out + base + (size_t)t * D + 2 * qd;
    const float* mrow = mo + r * D + 2 * qd;
#pragma unroll
    for (int dn = 0; dn < MAXD / 8; ++dn)
      if (dn < ND)
        store2(orow + dn * 8, (o[dn][2 * h] * a0 + mrow[dn * 8] * a1) * inv,
               (o[dn][2 * h + 1] * a0 + mrow[dn * 8 + 1] * a1) * inv);
  }
}

template <int DT, typename OutT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* relk, const void* relv, const void* lengths,
                   void* out, int BH, int T, int D, int W, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, W);
  cudaError_t err = cudaFuncSetAttribute(band_attention_kernel<DT, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(2 * ((T + BQ - 1) / BQ), BH);  // a cluster of two CTAs a row block
  band_attention_kernel<DT, OutT><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(relk),
      static_cast<const __nv_bfloat16*>(relv), static_cast<const int*>(lengths),
      static_cast<OutT*>(out), T, D, W);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_width(const void* q, const void* k, const void* v,
                         const void* relk, const void* relv, const void* lengths,
                         void* out, int BH, int T, int D, int W, cudaStream_t s) {
  return D == 96 ? launch<96, OutT>(q, k, v, relk, relv, lengths, out, BH, T, D, W, s)
                 : launch<0, OutT>(q, k, v, relk, relv, lengths, out, BH, T, D, W, s);
}

}  // namespace

// q, k, v: (BH, T, D) bf16, q already scaled by 1/sqrt(D); relk, relv:
// (2W+1, D) bf16; lengths: (BH,) int32, each >= 1; out: (BH, T, D), fp32
// when out_f32 else bf16. D is a multiple of 16, at most 128.
POLGEN_API int band_attention(const void* q, const void* k, const void* v,
                              const void* relk, const void* relv,
                              const void* lengths, void* out, int BH, int T,
                              int D, int W, int out_f32, void* stream) {
  if (D < 16 || D > 128 || D % 16 != 0 || W < 0 || band_rows_padded(2 * W + 1) > BK ||
      BH < 1 || T < 1 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      out_f32 ? launch_width<float>(q, k, v, relk, relv, lengths, out, BH, T, D, W, s)
              : launch_width<__nv_bfloat16>(q, k, v, relk, relv, lengths, out, BH,
                                            T, D, W, s);
  return (int)err;
}
