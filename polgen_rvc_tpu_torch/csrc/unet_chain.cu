// One 3x3 convolution of an RMVPE U-Net ConvBlockRes chain, fused with its
// bias, ReLU and (for a block's second conv) the residual or 1x1 shortcut:
//
//   y[b,o,t,w] = relu(bias[o] + sum_{c,dt,dw} W[o,c,dt,dw] rnd(x[b,c,t+dt-1,w+dw-1]))
//                + (sc ? bs[o] + sum_c sc[o,c] res[b,c,t,w]
//                      : res ? res[b,o,t,w] : 0)
//
// with zeros outside [0,T) x [0,W) (BatchNorm is folded into W and bias)
// and rnd the rounding to bf16. x and res are float32 or bf16, y is
// float32 or bf16 (rounded once); the shortcut reads res at full
// precision. Replaces polgen_rvc_tpu/ops/pallas_unet2d.py:
// fused_convblock_chain_folded: the wrapper in ops/unet_chain.py launches
// this twice per block, with h (conv1's output) in bf16 and each block's
// output in float32 between launches, and the chain's last conv writing
// x's dtype.
//
// Bound, per conv: 18*C_in*C_out*T*W FLOP against ~(2 or 4)*(C_in + C_out)
// *T*W bytes. At the W >= 64 levels (C = 16, 32) that is bytes; at the
// deep levels (C = 64..512, W = 32..4, T = 1800..225) operations, with too
// few positions to fill 132 SMs with large tiles. Design: an implicit GEMM
// (M = C_out, N = (t, w) positions, K = 9 * C_in) on mma.sync m16n8k16,
// bf16 operands, fp32 accumulator (the TPU kernel's mel fold is not
// reproduced). A block of eight warps owns BM output channels x TT whole
// mel rows (N = TT*W positions, so W needs no halo); the tile (BM, N) is
// chosen per level so that every launch of the main path has ~2 or more
// blocks an SM (tile_for below):
//   - per chunk of KC input channels, x over the block's rows and a
//     one-frame halo is staged as bf16 rows of W+2 positions (a fixed zero
//     column each side), channels contiguous: every tap (dt, dw) is the
//     same buffer shifted by dt*(W+2) + dw rows, and the im2col is never
//     built. Rows are 16-byte aligned, so A (weights, [tap][out][in]) and
//     B (the shifted rows) fragments both come through ldmatrix.x4;
//   - the next chunk is in flight while this chunk's products run: its
//     weight slice by cp.async into a second buffer, its activations by
//     16-byte loads into registers (neighbouring threads on neighbouring
//     positions of one channel), converted and stored after the products;
//     one barrier a chunk;
//   - KC = 16 where C_out <= 32 (the byte-bound W >= 64 levels, C_in = 1
//     padded to 16), KC = 32 above;
//   - the epilogue adds bias and ReLU in registers, parks the fp32 tile in
//     shared memory, and then adds the residual or the fp32 1x1 shortcut
//     and writes y along positions, 8 a thread (16- or 8-byte vectors),
//     both reads and writes coalesced.
// Not here: wgmma, TMA, clusters, split-K, a whole block in one launch.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // eight warps
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct ConvArgs {
  const void* x;              // (B, Cin, T, W) float32 or bf16
  const __nv_bfloat16* w;     // (9, Cout, CinP) bf16 [tap][out][in]
  const float* bias;          // (Cout,)
  const void* res;            // null, (B, Cout, T, W), or (B, Cres, T, W)
  const float* sc;            // (Cout, Cres) 1x1 shortcut, or null
  const float* sb;            // (Cout,) shortcut bias, or null
  void* y;                    // (B, Cout, T, W) float32 or bf16
  int Cin, CinP, Cout, Cres, T, W;
  int res_bf16, out_bf16;
};

// 8 values at element offset off of a float32 or bf16 row (off a multiple
// of 4); only 4 where half
__device__ __forceinline__ void load8(const void* base, size_t off, int bf16,
                                      bool half, float* v) {
  if (!bf16) {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(base) + off);
    const float4 lo = __ldg(p);
    const float4 hi = half ? make_float4(0.f, 0.f, 0.f, 0.f) : __ldg(p + 1);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    return;
  }
  const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(base) + off;
  uint32_t r[4];
  if (!half && (off & 7) == 0) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = u.x; r[1] = u.y; r[2] = u.z; r[3] = u.w;
  } else {
    const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p));
    const uint2 hi = half ? make_uint2(0u, 0u)
                          : __ldg(reinterpret_cast<const uint2*>(p + 4));
    r[0] = lo.x; r[1] = lo.y; r[2] = hi.x; r[3] = hi.y;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(r[i] << 16);
    v[2 * i + 1] = __uint_as_float(r[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(void* base, size_t off, int bf16,
                                       bool half, const float* v) {
  if (!bf16) {
    float4* p = reinterpret_cast<float4*>(static_cast<float*>(base) + off);
    p[0] = make_float4(v[0], v[1], v[2], v[3]);
    if (!half) p[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    r[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  __nv_bfloat16* p = static_cast<__nv_bfloat16*>(base) + off;
  if (!half && (off & 7) == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(r[0], r[1]);
    if (!half) *reinterpret_cast<uint2*>(p + 4) = make_uint2(r[2], r[3]);
  }
}

// Tile of BM output channels x N = WARPS_N*NT*8 positions; warp tiles of
// MT*16 channels x NT*8 positions; KC input channels a chunk.
template <int BM, int WARPS_M, int MT, int NT, int KC>
struct Tile {
  static constexpr int WARPS_N = (THREADS / 32) / WARPS_M;
  static constexpr int N = WARPS_N * NT * 8;
  static constexpr int S = KC + 8;  // staged row stride in bf16 (16-aligned)
  static constexpr int OS = N + 8;  // output tile row stride in floats
  static_assert(WARPS_M * MT * 16 == BM, "warp tiles must cover BM");
  static_assert(NT % 2 == 0, "B fragments come in pairs of n-tiles");
  static __host__ __device__ size_t smem(int W) {
    const size_t rows = (size_t)(N / W + 2) * (W + 2);
    const size_t stage = 2 * (rows + 9 * BM) * S * 2;
    const size_t out = (size_t)BM * OS * 4;
    return stage > out ? stage : out;
  }
};

template <int BM, int WARPS_M, int MT, int NT, int KC, typename SrcT>
__global__ void __launch_bounds__(THREADS, 2)
unet_conv3x3_kernel(const ConvArgs a) {
  using TL = Tile<BM, WARPS_M, MT, NT, KC>;
  constexpr int N = TL::N, S = TL::S, PAIRS = KC / 2;
  // staged positions are at most N + 2*W, W <= min(N, 128); 4 a load at
  // least: U load items a thread at most
  constexpr int POSMAX = N + 2 * (N < 128 ? N : 128);
  constexpr int U = (PAIRS * (POSMAX / 4) + THREADS - 1) / THREADS;

  const int W = a.W, T = a.T, CinP = a.CinP;
  const int lw = __ffs(W) - 1;  // W is a power of two
  const int TT = N >> lw, WP = W + 2;
  const int rows = (TT + 2) * WP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs[2];
  __nv_bfloat16* ws[2];
  xs[0] = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  xs[1] = xs[0] + rows * S;
  ws[0] = xs[1] + rows * S;
  ws[1] = ws[0] + 9 * BM * S;

  const int t0 = blockIdx.x * TT;
  const int o0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp / TL::WARPS_N, wn = warp - wm * TL::WARPS_N;

  // the zero columns (w = -1 and w = W) of both buffers never change
  for (int idx = tid; idx < 2 * 2 * (TT + 2); idx += THREADS) {
    const int buf = idx & 1, side = (idx >> 1) & 1, fr = idx >> 2;
    uint4* p = reinterpret_cast<uint4*>(xs[buf] + (fr * WP + side * (W + 1)) * S);
#pragma unroll
    for (int v = 0; v < KC / 8; ++v) p[v] = make_uint4(0u, 0u, 0u, 0u);
  }

  // activation items: (channel pair, V consecutive positions of one frame)
  const int lv = (sizeof(SrcT) == 2 && W >= 8) ? 3 : 2;
  const int items = PAIRS * (((TT + 2) * W) >> lv);
  const size_t plane = (size_t)T * W;
  const SrcT* xb = static_cast<const SrcT*>(a.x) + (size_t)b * a.Cin * plane;
  uint4 raw[U][2];

  auto load_chunk = [&](int c0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = tid + u * THREADS;
      const int cp = idx % PAIRS, p = (idx / PAIRS) << lv;
      const int t = t0 - 1 + (p >> lw);
      const int c = c0 + 2 * cp;
      const bool in = idx < items && t >= 0 && t < T;
      raw[u][0] = raw[u][1] = make_uint4(0u, 0u, 0u, 0u);
      if (!in) continue;
      const SrcT* src = xb + (size_t)c * plane + (size_t)t * W + (p & (W - 1));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (c + h >= a.Cin) break;
        const SrcT* s = src + h * plane;
        if (sizeof(SrcT) == 4 || lv == 3) {
          raw[u][h] = __ldg(reinterpret_cast<const uint4*>(s));
        } else {
          const uint2 v = __ldg(reinterpret_cast<const uint2*>(s));
          raw[u][h] = make_uint4(v.x, v.y, 0u, 0u);
        }
      }
    }
  };

  // rounded bf16 channel pairs, one 32-bit store per position
  auto store_chunk = [&](__nv_bfloat16* dst_buf) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = tid + u * THREADS;
      if (idx >= items) break;
      const int cp = idx % PAIRS, p = (idx / PAIRS) << lv;
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          dst_buf + ((p >> lw) * WP + (p & (W - 1)) + 1) * S + 2 * cp);
      const uint32_t r0[4] = {raw[u][0].x, raw[u][0].y, raw[u][0].z, raw[u][0].w};
      const uint32_t r1[4] = {raw[u][1].x, raw[u][1].y, raw[u][1].z, raw[u][1].w};
      if (sizeof(SrcT) == 4) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 h =
              __floats2bfloat162_rn(__uint_as_float(r0[e]), __uint_as_float(r1[e]));
          dst[e * (S / 2)] = *reinterpret_cast<const uint32_t*>(&h);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (e >= (1 << (lv - 1))) break;
          dst[(2 * e) * (S / 2)] = __byte_perm(r0[e], r1[e], 0x5410);
          dst[(2 * e + 1) * (S / 2)] = __byte_perm(r0[e], r1[e], 0x7632);
        }
      }
    }
  };

  auto fetch_w = [&](int c0, __nv_bfloat16* dst) {
    constexpr int UNITS = KC / 8;
    for (int idx = tid; idx < 9 * BM * UNITS; idx += THREADS) {
      const int unit = idx % UNITS, row = idx / UNITS;  // row = tap * BM + o
      const int j = row / BM, o = row - j * BM;
      cp_async16(smem_addr(dst + row * S + unit * 8),
                 a.w + ((size_t)j * a.Cout + o0 + o) * CinP + c0 + unit * 8);
    }
    cp_async_commit();
  };

  // ldmatrix row addresses (bytes, tap (0, 0), k 0) of this lane
  const uint32_t a_off =
      ((wm * MT * 16 + (lane & 15)) * S + (lane >> 4) * 8) * 2;
  uint32_t b_off[NT / 2];
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    const int n = wn * NT * 8 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
    b_off[np] = (((n >> lw) * WP + (n & (W - 1))) * S + ((lane >> 3) & 1) * 8) * 2;
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_chunks = CinP / KC;
  fetch_w(0, ws[0]);
  load_chunk(0);
  store_chunk(xs[0]);
  for (int i = 0; i < n_chunks; ++i) {
    const int cur = i & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk i staged; every warp is done with chunk i - 1
    if (i + 1 < n_chunks) {
      fetch_w((i + 1) * KC, ws[cur ^ 1]);
      load_chunk((i + 1) * KC);
    }
    const uint32_t xa = smem_addr(xs[cur]);
    const uint32_t wa = smem_addr(ws[cur]) + a_off;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const uint32_t xj = xa + ((j / 3) * WP + (j % 3)) * S * 2;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(af[mt], wa + ((j * BM + mt * 16) * S + kk * 16) * 2);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, xj + b_off[np] + kk * 32);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(acc[mt][2 * np], af[mt], bf);
            mma_bf16_16816(acc[mt][2 * np + 1], af[mt], bf + 2);
          }
        }
      }
    }
    if (i + 1 < n_chunks) store_chunk(xs[cur ^ 1]);
  }
  __syncthreads();  // every warp is done with the staged buffers

  // bias and ReLU in registers; the fp32 tile parks in shared memory
  float* os = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = wm * MT * 16 + mt * 16 + g + half * 8;
      const float bo = __ldg(a.bias + o0 + o);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wn * NT * 8 + nt * 8 + 2 * q;
        *reinterpret_cast<float2*>(os + o * TL::OS + n) =
            make_float2(fmaxf(acc[mt][nt][half * 2] + bo, 0.f),
                        fmaxf(acc[mt][nt][half * 2 + 1] + bo, 0.f));
      }
    }
  __syncthreads();

  // residual or shortcut, then y: 8 positions of EPT output rows a thread
  constexpr int NG = N / 8, OSTEP = THREADS / NG, EPT = BM / OSTEP;
  static_assert(THREADS % NG == 0 && BM % OSTEP == 0, "epilogue items");
  const int p0 = (tid % NG) * 8, orow = tid / NG;
  const int npos = min(N, (T - t0) * W);
  if (p0 >= npos) return;
  const bool half = p0 + 8 > npos;  // W = 4: the tile's last frame alone
  const size_t pbase = (size_t)t0 * W + p0;
  float v[EPT][8];
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const float* src = os + (orow + i * OSTEP) * TL::OS + p0;
    const float4 lo = *reinterpret_cast<const float4*>(src);
    const float4 hi = *reinterpret_cast<const float4*>(src + 4);
    v[i][0] = lo.x; v[i][1] = lo.y; v[i][2] = lo.z; v[i][3] = lo.w;
    v[i][4] = hi.x; v[i][5] = hi.y; v[i][6] = hi.z; v[i][7] = hi.w;
  }
  if (a.sc) {
    // 1x1 shortcut over the block input at full precision
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const float s = __ldg(a.sb + o0 + orow + i * OSTEP);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] += s;
    }
    const size_t rb = (size_t)b * a.Cres * plane + pbase;
#pragma unroll 4
    for (int c = 0; c < a.Cres; ++c) {
      float r[8];
      load8(a.res, rb + (size_t)c * plane, a.res_bf16, half, r);
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const float s = __ldg(a.sc + (size_t)(o0 + orow + i * OSTEP) * a.Cres + c);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][e] = fmaf(s, r[e], v[i][e]);
      }
    }
  } else if (a.res) {
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      float r[8];
      load8(a.res, ((size_t)b * a.Cout + o0 + orow + i * OSTEP) * plane + pbase,
            a.res_bf16, half, r);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[i][e] += r[e];
    }
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i)
    store8(a.y, ((size_t)b * a.Cout + o0 + orow + i * OSTEP) * plane + pbase,
           a.out_bf16, half, v[i]);
}

template <int BM, int WARPS_M, int MT, int NT, int KC>
cudaError_t launch_tile(const ConvArgs& a, int B, int src_bf16,
                        cudaStream_t stream) {
  using TL = Tile<BM, WARPS_M, MT, NT, KC>;
  if (a.W > TL::N || TL::N % a.W != 0 || a.CinP % KC != 0)
    return cudaErrorInvalidValue;
  const size_t smem = TL::smem(a.W);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  void (*kern)(const ConvArgs) =
      src_bf16 ? &unet_conv3x3_kernel<BM, WARPS_M, MT, NT, KC, __nv_bfloat16>
               : &unet_conv3x3_kernel<BM, WARPS_M, MT, NT, KC, float>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int TT = TL::N / a.W;
  dim3 grid((a.T + TT - 1) / TT, a.Cout / BM, B);
  kern<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// The tile of a launch: 0 = BM 16 x N 256, 1 = 32 x 256 (both KC 16),
// 2 = 64 x 64, 3 = 32 x 64 (both KC 32). Main path: W = 128 and 64
// (C_out 16, 32) take 0 and 1; W = 32, 16 (C_out 64, 128) take 2; W = 8,
// 4 (C_out 256, 512) take 3.
int tile_for(int Cout, int W) {
  if (Cout % 64 == 0 && W >= 16 && W <= 32) return 2;
  if (Cout % 32 == 0 && Cout >= 64 && W <= 64) return 3;
  if (Cout % 32 == 0) return 1;
  return 0;
}

constexpr int TILE_BM[4] = {16, 32, 64, 32};
constexpr int TILE_N[4] = {256, 256, 64, 64};
constexpr int TILE_KC[4] = {16, 16, 32, 32};

}  // namespace

// The tile a launch at (Cout, W) takes: out[0..3] = BM, positions N,
// frames TT = N / W, and KC (the packed input channels, CinP, must be a
// multiple of it). Returns 0, or an error for a shape the kernel refuses.
POLGEN_API int unet_conv3x3_tile(int Cout, int W, void* out) {
  if (Cout % 16 != 0 || Cout < 16 || W < 4 || W > 128 || 128 % W != 0)
    return (int)cudaErrorInvalidValue;
  const int k = tile_for(Cout, W);
  int* o = static_cast<int*>(out);
  o[0] = TILE_BM[k];
  o[1] = TILE_N[k];
  o[2] = TILE_N[k] / W;
  o[3] = TILE_KC[k];
  return 0;
}

// x: (B, Cin, T, W) float32 or bf16 (src_bf16); w: (9, Cout, CinP) bf16,
// CinP = Cin rounded up to the tile's KC with zero channels; bias (Cout,)
// float32; res: null, or (B, Cout, T, W) residual, or with sc/sb the
// (B, Cres, T, W) block input of a (Cout, Cres) float32 1x1 shortcut,
// float32 or bf16 (res_bf16); y: (B, Cout, T, W) float32 or bf16
// (out_bf16), never x or res. Cout a multiple of 16; W a power of two
// from 4 to 128.
POLGEN_API int unet_conv3x3(const void* x, const void* w, const void* bias,
                            const void* res, const void* sc, const void* sb,
                            void* y, int B, int Cin, int CinP, int Cout,
                            int Cres, int T, int W, int src_bf16, int res_bf16,
                            int out_bf16, void* stream) {
  if (Cout % 16 != 0 || Cout < 16 || W < 4 || W > 128 || 128 % W != 0 ||
      CinP < Cin || Cin < 1 || B < 1 || B > 65535 || T < 1 ||
      (sc != nullptr && (res == nullptr || Cres < 1)))
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.x = x;
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.res = res;
  a.sc = static_cast<const float*>(sc);
  a.sb = static_cast<const float*>(sb);
  a.y = y;
  a.Cin = Cin;
  a.CinP = CinP;
  a.Cout = Cout;
  a.Cres = Cres;
  a.T = T;
  a.W = W;
  a.res_bf16 = res_bf16;
  a.out_bf16 = out_bf16;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (tile_for(Cout, W)) {
    case 0: err = launch_tile<16, 1, 1, 4, 16>(a, B, src_bf16, s); break;
    case 1: err = launch_tile<32, 1, 2, 4, 16>(a, B, src_bf16, s); break;
    case 2: err = launch_tile<64, 4, 1, 4, 32>(a, B, src_bf16, s); break;
    default: err = launch_tile<32, 2, 1, 2, 32>(a, B, src_bf16, s);
  }
  return (int)err;
}
