// One conv pair of a HiFi-GAN ResBlock1, fused with its activations, edge
// zeroing, biases, residual and the group's running mean:
//
//   h = rnd(lrelu(conv_{k,d}(rnd(lrelu(src))) + b1))   h = 0 outside [0, T)
//   v = conv_{k,1}(h) + b2 + src
//   not last: y = v, or y = acc + v (acc may be y), float32
//   last:     y = (acc + v) / n_res, or v / n_res without acc, in y's type
//
// rnd rounds fp32 to bf16; src (float32 or bf16) is read as zero outside
// [0, T). Replaces polgen_rvc_tpu/ops/pallas_resblock.py:
// fused_resblock_group (and its time-folded twin): the wrapper in
// ops/resblock_group.py launches this once per conv pair, 9 times per
// decoder stage, with the residual stream and running sum in fp32 between
// launches.
//
// Bound: operations at C >= 64 (a pair is 4*k*C^2 FLOP per sample against
// ~10-20 bytes), close to the bytes at C = 32. Design: a block owns one
// batch row and M consecutive rows of h, all C channels (conv2 contracts
// over all of them), so the intermediate never leaves shared memory:
//   - rnd(lrelu(src)) over the tile plus both halos is staged once,
//     time-major with channels contiguous (row stride C + 8: ldmatrix rows
//     fall on distinct banks); every tap j reads it shifted by j*d rows;
//   - conv1 runs M = time x N = all C output channels x K = C_in * k as an
//     implicit GEMM on mma.sync m16n8k16 (bf16 operands, fp32 accumulator,
//     64 a thread), A and B fragments through ldmatrix.x4; h is biased,
//     activated, rounded, zeroed outside [0, T) and written over the
//     staged rows, which conv1 no longer needs;
//   - conv2 runs the same loop over h, whose first M - (k - 1) rows are the
//     block's outputs (the halo recompute costs (k - 1) / M of the work);
//     its epilogue adds bias and residual and writes the result;
//   - weights stream through a three-slot ring of 16 KB chunks (taps x C
//     output x 32 input channels; 64-byte rows, 16-byte units
//     XOR-swizzled against bank conflicts): cp.async keeps two chunks in
//     flight while one chunk's products run.
// M * C = 16384 (M = 512 at C = 32 ... 64 at C = 256): ~100 KB of shared
// memory, two blocks of eight warps an SM, so one block's staging and
// epilogue overlap the other's products. Widths 96, 160, 192 and 224 take
// a small generic tile (32 output channels a pass, h apart). Not here:
// wgmma, TMA, clusters, persistent blocks, the whole group in one pass.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // eight warps
constexpr int KC = 32;        // input channels per weight chunk
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// all but the newest group of copies have landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v > 0.f ? v : v * slope;
}

struct PairArgs {
  const void* src;                // (B, C, T) float32 or bf16
  const __nv_bfloat16 *w1, *w2;   // (k, C_out, C_in) bf16
  const float *b1, *b2;           // (C,) float32
  const float* acc;               // (B, C, T) float32 or null
  void* y;                        // (B, C, T) float32, or bf16 when last
  int C, T, k, dil;
  float slope;
  int last;
  float n_res;
  int src_bf16, out_bf16;
};

// ring chunk (conv, oc, cc, tap group): taps [j0, j0 + nj) x OC output x
// KC input channels, row R = (j - j0) * OC + o, its four 16-byte units at
// u ^ ((R >> 1) & 3)
template <int OC>
__device__ __forceinline__ void load_chunk(const PairArgs& a, int conv, int oc,
                                           int cc, int j0, int nj,
                                           __nv_bfloat16* buf) {
  const __nv_bfloat16* w = conv ? a.w2 : a.w1;
  const int C = a.C;
  for (int idx = threadIdx.x; idx < nj * OC * 4; idx += THREADS) {
    const int R = idx >> 2, u = idx & 3;
    const int jj = R / OC, o = R - jj * OC;
    cp_async16(smem_addr(buf + R * KC + ((u ^ ((R >> 1) & 3)) << 3)),
               w + ((size_t)(j0 + jj) * C + oc * OC + o) * C + cc * KC + u * 8);
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// xs[r][c] = rnd(lrelu(src[c][xlo + r])), zero outside [0, T), for r in
// [0, XR). Work items are (8 time steps, 2 channels), lanes along the
// channel pairs (conflict-free 32-bit stores into the time-major rows);
// 16-byte loads where the 8 steps lie inside [0, T) on an aligned row, and
// two items a thread in flight before any store.
template <typename SrcT>
__device__ __forceinline__ void stage_src(const SrcT* src, __nv_bfloat16* xs,
                                          int S, int C, int T, int xlo,
                                          int XR, float slope) {
  constexpr int V = 8, U = 2;
  const int g_lo = floor_div(xlo, V);
  const int n_groups = floor_div(xlo + XR - 1, V) - g_lo + 1;
  const int pairs = C / 2, items = n_groups * pairs;
  const bool aligned = T % V == 0;
  for (int base = threadIdx.x; base < items; base += THREADS * U) {
    float v[U][2][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * THREADS;
      const int gi = idx / pairs, cp = idx - gi * pairs;
      const int tg = (g_lo + gi) * V;
      const size_t row = (size_t)(2 * cp) * T;
      if (idx < items && aligned && tg >= 0 && tg + V <= T) {
        load8(src + row + tg, v[u][0]);
        load8(src + row + T + tg, v[u][1]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int t = tg + e;
          const bool in = idx < items && t >= 0 && t < T;
          v[u][0][e] = in ? load1(src + row + t) : 0.f;
          v[u][1][e] = in ? load1(src + row + T + t) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * THREADS;
      if (idx >= items) break;
      const int gi = idx / pairs, cp = idx - gi * pairs;
      const int r0 = (g_lo + gi) * V - xlo;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int r = r0 + e;
        if (r < 0 || r >= XR) continue;
        *reinterpret_cast<uint32_t*>(xs + r * S + 2 * cp) =
            pack_bf16x2(__float2bfloat16(lrelu(v[u][0][e], slope)),
                        __float2bfloat16(lrelu(v[u][1][e], slope)));
      }
    }
  }
}

template <int OC>
struct Ring {
  static constexpr int TJ = OC >= 256 ? 1 : 256 / OC;  // taps a chunk: 16 KB
  static constexpr int SLOTS = 3;                      // two chunks in flight
  static constexpr int ELEMS = TJ * OC * KC;
};

template <int M, int OC, int MT, int NT>
__global__ void __launch_bounds__(THREADS, 2) pair_kernel(const PairArgs a) {
  constexpr int WARPS_N = OC / (8 * NT);
  constexpr int WARPS_M = (THREADS / 32) / WARPS_N;
  static_assert(WARPS_M * 16 * MT == M, "warp tiles must cover M rows");
  static_assert(NT % 2 == 0, "B fragments come in pairs of n-tiles");
  using R = Ring<OC>;

  const int C = a.C, T = a.T, k = a.k, dil = a.dil;
  const int S = C + 8;                 // activation row stride (bf16)
  const int ctr = (k - 1) / 2;
  const int XR = M + (k - 1) * dil;    // staged src rows
  const int bn = M - (k - 1);          // outputs per block
  const int t0 = blockIdx.x * bn;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp / WARPS_N, wn = warp - wm * WARPS_N;

  // one output chunk (OC = C): h overwrites the staged rows once conv1 is
  // done with them; else h has rows of its own
  const int NO = C / OC, NC = C / KC, NG = (k + R::TJ - 1) / R::TJ;
  const bool alias = NO == 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hs = alias ? xs : xs + XR * S;
  __nv_bfloat16* wring = xs + (alias ? XR : XR + M + k - 1) * S;

  const int per_conv = NO * NC * NG, n_chunks = 2 * per_conv;
  auto fetch = [&](int n) {
    if (n < n_chunks) {
      const int cv = n / per_conv, rm = n - cv * per_conv;
      const int oc = rm / (NC * NG), rc = rm - oc * NC * NG;
      const int cc = rc / NG, j0 = (rc - cc * NG) * R::TJ;
      load_chunk<OC>(a, cv, oc, cc, j0, min(R::TJ, k - j0),
                     wring + (n % R::SLOTS) * R::ELEMS);
    }
    cp_async_commit();
  };
  fetch(0);
  fetch(1);

  // rnd(lrelu(src)) over [t0 - ctr*(1+dil), +XR)
  const size_t plane = (size_t)C * T;
  const int xlo = t0 - ctr * (1 + dil);
  if (a.src_bf16)
    stage_src(static_cast<const __nv_bfloat16*>(a.src) + b * plane, xs, S, C, T,
              xlo, XR, a.slope);
  else
    stage_src(static_cast<const float*>(a.src) + b * plane, xs, S, C, T, xlo,
              XR, a.slope);

  const int b_row = wn * NT * 8 + (lane & 7) + ((lane >> 4) << 3);
  const int b_unit = (lane >> 3) & 1;
  float acc[MT][NT][4];
  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait_one();
    __syncthreads();  // chunk i (and the staged rows, h) visible; slot free
    fetch(i + 2);

    const int conv = i / per_conv, rm = i - conv * per_conv;
    const int oc = rm / (NC * NG), rc = rm - oc * NC * NG;
    const int cc = rc / NG, j0 = (rc - cc * NG) * R::TJ;
    const int nj = min(R::TJ, k - j0);
    if (cc == 0 && j0 == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    const __nv_bfloat16* act = conv == 0 ? xs : hs;
    const int shift = conv == 0 ? dil : 1;
    const __nv_bfloat16* wb = wring + (i % R::SLOTS) * R::ELEMS;
    const uint32_t a_base = smem_addr(
        act + (wm * MT * 16 + (lane & 15) + j0 * shift) * S + cc * KC + (lane >> 4) * 8);
    for (int jj = 0; jj < nj; ++jj) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(af[mt], a_base + ((mt * 16 + jj * shift) * S + kk * 16) * 2);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int row = jj * OC + b_row + np * 16;
          uint32_t bf[4];
          ldmatrix_x4(bf, smem_addr(wb + row * KC +
                                    (((kk * 2 + b_unit) ^ ((row >> 1) & 3)) << 3)));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(acc[mt][2 * np], af[mt], bf);
            mma_bf16_16816(acc[mt][2 * np + 1], af[mt], bf + 2);
          }
        }
      }
    }
    if (cc != NC - 1 || j0 + nj != k) continue;

    if (conv == 0) {
      if (alias) __syncthreads();  // every warp is done reading xs
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = wm * MT * 16 + mt * 16 + g + half * 8;
          const int t = t0 - ctr + p;
          const bool in = t >= 0 && t < T;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int o = oc * OC + wn * NT * 8 + nt * 8 + 2 * q;
            const float v0 = lrelu(acc[mt][nt][half * 2] + __ldg(a.b1 + o), a.slope);
            const float v1 = lrelu(acc[mt][nt][half * 2 + 1] + __ldg(a.b1 + o + 1), a.slope);
            *reinterpret_cast<uint32_t*>(hs + p * S + o) = pack_bf16x2(
                __float2bfloat16(in ? v0 : 0.f), __float2bfloat16(in ? v1 : 0.f));
          }
        }
      continue;
    }
    // conv2: per row group, every residual (and running-sum) value is
    // loaded before the first store (acc may be y), so the loads overlap
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = wm * MT * 16 + mt * 16 + g + half * 8;
        const int t = t0 + p;
        if (p >= bn || t >= T) continue;
        const size_t ib = b * plane + t;
        float res[NT][2], run[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const size_t i = ib + (size_t)(oc * OC + wn * NT * 8 + nt * 8 + 2 * q + e) * T;
            res[nt][e] = a.src_bf16 ? load1(static_cast<const __nv_bfloat16*>(a.src) + i)
                                    : load1(static_cast<const float*>(a.src) + i);
            run[nt][e] = a.acc ? a.acc[i] : 0.f;
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = oc * OC + wn * NT * 8 + nt * 8 + 2 * q + e;
            const size_t i = ib + (size_t)o * T;
            float v = acc[mt][nt][half * 2 + e] + __ldg(a.b2 + o) + res[nt][e];
            if (a.acc) v = run[nt][e] + v;
            if (!a.last) static_cast<float*>(a.y)[i] = v;
            else if (a.out_bf16)
              static_cast<__nv_bfloat16*>(a.y)[i] = __float2bfloat16(v / a.n_res);
            else
              static_cast<float*>(a.y)[i] = v / a.n_res;
          }
        }
      }
    }
  }
}

template <int M, int OC, int MT, int NT>
cudaError_t launch_tile(const PairArgs& a, int B, cudaStream_t stream) {
  const int S = a.C + 8;
  const size_t rows = (size_t)M + (a.k - 1) * a.dil + (a.C == OC ? 0 : M + a.k - 1);
  const size_t smem = rows * S * 2 + Ring<OC>::SLOTS * Ring<OC>::ELEMS * 2;
  if (a.k > M || smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = pair_kernel<M, OC, MT, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int bn = M - (a.k - 1);
  dim3 grid((a.T + bn - 1) / bn, B);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// src, acc, y: (B, C, T); w1, w2: (k, C, C) bf16 [tap][out][in]; b1, b2 (C,)
// float32. src is bf16 when src_bf16, else float32; acc float32 or null;
// y float32, or bf16 (out_bf16) for the last pair of a group. y may
// be acc, never src. C a multiple of 32 up to 256, k odd.
POLGEN_API int resblock_pair(const void* src, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* acc,
                             void* y, int B, int C, int T, int k, int dil,
                             float slope, int last, float n_res, int src_bf16,
                             int out_bf16, void* stream) {
  if (C % 32 != 0 || C < 32 || C > 256 || B < 1 || B > 65535 || T < 1 ||
      k < 1 || k % 2 == 0 || dil < 1)
    return (int)cudaErrorInvalidValue;
  PairArgs a;
  a.src = src;
  a.w1 = static_cast<const __nv_bfloat16*>(w1);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.b1 = static_cast<const float*>(b1);
  a.b2 = static_cast<const float*>(b2);
  a.acc = static_cast<const float*>(acc);
  a.y = y;
  a.C = C;
  a.T = T;
  a.k = k;
  a.dil = dil;
  a.slope = slope;
  a.last = last;
  a.n_res = n_res;
  a.src_bf16 = src_bf16;
  a.out_bf16 = out_bf16;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 32: err = launch_tile<512, 32, 4, 4>(a, B, s); break;
    case 64: err = launch_tile<256, 64, 4, 4>(a, B, s); break;
    case 128: err = launch_tile<128, 128, 2, 8>(a, B, s); break;
    case 256: err = launch_tile<64, 256, 2, 8>(a, B, s); break;
    default: err = launch_tile<64, 32, 1, 2>(a, B, s);  // 96, 160, 192, 224
  }
  return (int)err;
}
