// One 3x3 convolution of an RMVPE U-Net ConvBlockRes chain, fused with its
// bias, ReLU and (for a block's second conv) the residual or 1x1 shortcut:
//
//   y[b,o,t,w] = relu(bias[o] + sum_{c,dt,dw} W[o,c,dt,dw] x[b,c,t+dt-1,w+dw-1])
//                + (sc ? bs[o] + sum_c sc[o,c] res[b,c,t,w]
//                      : res ? res[b,o,t,w] : 0)
//
// with zeros outside [0,T) x [0,W) (BatchNorm is folded into W and bias).
// Replaces polgen_rvc_tpu/ops/pallas_unet2d.py:fused_convblock_chain_folded;
// the wrapper in ops/unet_chain.py launches this twice per block.
//
// Bound: operations (18*C_in*C_out*T*W FLOP per conv; ~5e11 for the whole
// U-Net on a minute of audio) at low channel counts (16..512), where the
// TPU kernel folded the mel axis into channels to fill its matrix unit.
// Design: an implicit GEMM (M = C_out, N = (t, w) positions, K = 9 * C_in)
// on mma.sync m16n8k16, bf16 operands, fp32 accumulator; the fold is not
// reproduced. A block owns BM output channels x 128 positions (128/W whole
// mel rows, so W divides 128). For each chunk of 32 input channels it
// stages x over the block's rows plus a one-frame halo above and below, in
// rows W+2 wide with a zero column each side, channels contiguous: every
// tap (dt, dw) is then the same buffer shifted by dt*(W+2) + dw, and the
// im2col is never built. The 1x1 shortcut reads its input in fp32, as the
// TPU kernel does, with plain FMA in the epilogue.
#include "common.cuh"

namespace {

constexpr int BN = 128;      // positions per block
constexpr int KC = 32;       // input channels per staged chunk
constexpr int STRIDE = 40;   // smem row stride in bf16 (80 bytes: 16-aligned)
constexpr int THREADS = 128; // four warps, each 32 positions wide

// w: (9, Cout, CinP) bf16 [tap][out][in], CinP = Cin rounded up to KC with
// zero channels; the grid is (ceil(T*W / BN), Cout / BM, B).
template <int BM>
__global__ void __launch_bounds__(THREADS)
unet_conv3x3_kernel(const float* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ res,
                    const float* __restrict__ sc,
                    const float* __restrict__ sb, float* __restrict__ y,
                    int Cin, int CinP, int Cout, int Cres, int T, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int TT = BN / W;            // frames per block
  const int WP = W + 2;             // padded row width
  const int rows = (TT + 2) * WP;   // staged positions
  __nv_bfloat16* ws = xs + rows * STRIDE;

  const int t0 = blockIdx.x * TT;
  const int o0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;

  // staged row of each of this lane's four B-fragment positions, tap (0, 0)
  int base[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = warp * 32 + nt * 8 + g;
    base[nt] = (n / W) * WP + (n % W);
  }

  constexpr int MT = BM / 16;
  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const size_t plane = (size_t)T * W;
  const float* xb = x + (size_t)b * Cin * plane;
  const int lw = __ffs(W) - 1;       // W is a power of two
  const int interior = (TT + 2) << lw;
  // the zero columns (w = -1 and w = W) never change: written once
  for (int idx = tid; idx < 2 * (TT + 2); idx += THREADS) {
    const int fr = idx >> 1, col = (idx & 1) ? W + 1 : 0;
    uint4* p = reinterpret_cast<uint4*>(xs + (fr * WP + col) * STRIDE);
#pragma unroll
    for (int v = 0; v < KC / 8; ++v) p[v] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int c0 = 0; c0 < CinP; c0 += KC) {
    __syncthreads();
    // x as bf16 channel pairs; consecutive threads read consecutive w
    for (int cp = 0; cp < KC / 2; ++cp) {
      const int c = c0 + 2 * cp;
      const float* xc = xb + (size_t)c * plane;
      for (int r = tid; r < interior; r += THREADS) {
        const int fr = r >> lw, ww = r & (W - 1);
        const int t = t0 - 1 + fr;
        float v0 = 0.f, v1 = 0.f;
        if (t >= 0 && t < T) {
          const float* xp = xc + (size_t)t * W + ww;
          if (c < Cin) v0 = xp[0];
          if (c + 1 < Cin) v1 = xp[plane];
        }
        *reinterpret_cast<uint32_t*>(xs + (fr * WP + ww + 1) * STRIDE + 2 * cp) =
            pack_bf16x2(__float2bfloat16(v0), __float2bfloat16(v1));
      }
    }
    for (int idx = tid; idx < 9 * BM * (KC / 8); idx += THREADS) {
      const int v8 = idx & (KC / 8 - 1);
      const int jo = idx / (KC / 8);  // tap * BM + o
      const int j = jo / BM, o = jo - j * BM;
      *reinterpret_cast<uint4*>(ws + jo * STRIDE + v8 * 8) =
          *reinterpret_cast<const uint4*>(
              w + ((size_t)j * Cout + o0 + o) * CinP + c0 + v8 * 8);
    }
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < 9; ++j) {
      const int off = (j / 3) * WP + (j % 3);
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const __nv_bfloat16* wa =
              ws + (j * BM + mt * 16 + g) * STRIDE + kk + 2 * q;
          a[mt][0] = *reinterpret_cast<const uint32_t*>(wa);
          a[mt][1] = *reinterpret_cast<const uint32_t*>(wa + 8 * STRIDE);
          a[mt][2] = *reinterpret_cast<const uint32_t*>(wa + 8);
          a[mt][3] = *reinterpret_cast<const uint32_t*>(wa + 8 * STRIDE + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const __nv_bfloat16* xp =
              xs + (base[nt] + off) * STRIDE + kk + 2 * q;
          uint32_t bf[2];
          bf[0] = *reinterpret_cast<const uint32_t*>(xp);
          bf[1] = *reinterpret_cast<const uint32_t*>(xp + 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], bf);
        }
      }
    }
  }

  // epilogue: this lane's outputs are rows o = o0 + mt*16 + g (+8) and
  // positions n = warp*32 + nt*8 + 2q (+1)
  size_t pos[4][2];
  bool ok[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = warp * 32 + nt * 8 + 2 * q + e;
      const int t = t0 + n / W;
      ok[nt][e] = t < T;
      pos[nt][e] = (size_t)t * W + (n % W);
    }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float bo = bias[o0 + mt * 16 + g + half * 8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = acc[mt][nt][half * 2 + e];
          v = fmaxf(v + bo, 0.f);
        }
    }
  if (sc) {
    // 1x1 shortcut over the fp32 block input: per input channel, this
    // lane's 2*MT weights times its 8 positions
    const float* rb = res + (size_t)b * Cres * plane;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float s = sb[o0 + mt * 16 + g + half * 8];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[mt][nt][half * 2 + e] += s;
      }
    for (int c = 0; c < Cres; ++c) {
      float rv[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          rv[nt][e] = ok[nt][e] ? rb[(size_t)c * plane + pos[nt][e]] : 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float s = sc[(size_t)(o0 + mt * 16 + g + half * 8) * Cres + c];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              acc[mt][nt][half * 2 + e] += s * rv[nt][e];
        }
    }
  } else if (res) {
    const float* rb = res + (size_t)b * Cout * plane;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const size_t ob = (size_t)(o0 + mt * 16 + g + half * 8) * plane;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (ok[nt][e]) acc[mt][nt][half * 2 + e] += rb[ob + pos[nt][e]];
      }
  }
  float* yb = y + (size_t)b * Cout * plane;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t ob = (size_t)(o0 + mt * 16 + g + half * 8) * plane;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (ok[nt][e]) yb[ob + pos[nt][e]] = acc[mt][nt][half * 2 + e];
    }
}

template <int BM>
cudaError_t launch(const float* x, const __nv_bfloat16* w, const float* bias,
                   const float* res, const float* sc, const float* sb,
                   float* y, int B, int Cin, int CinP, int Cout, int Cres,
                   int T, int W, cudaStream_t stream) {
  const int TT = BN / W;
  const size_t smem = (size_t)((TT + 2) * (W + 2) + 9 * BM) * STRIDE *
                      sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      unet_conv3x3_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + TT - 1) / TT, Cout / BM, B);
  unet_conv3x3_kernel<BM><<<grid, THREADS, smem, stream>>>(
      x, w, bias, res, sc, sb, y, Cin, CinP, Cout, Cres, T, W);
  return cudaGetLastError();
}

}  // namespace

// x: (B, Cin, T, W) fp32; w: (9, Cout, CinP) bf16, CinP = Cin rounded up to
// a multiple of 32 with zero channels; bias (Cout,); res: null, or
// (B, Cout, T, W) residual, or with sc/sb the (B, Cres, T, W) block input of
// a (Cout, Cres) fp32 1x1 shortcut; y: (B, Cout, T, W).
// Cout must be a multiple of 16; W must divide 128.
POLGEN_API int unet_conv3x3(const void* x, const void* w, const void* bias,
                            const void* res, const void* sc, const void* sb,
                            void* y, int B, int Cin, int CinP, int Cout,
                            int Cres, int T, int W, void* stream) {
  if (Cout % 16 != 0 || W < 1 || W > BN || BN % W != 0 || CinP % KC != 0 ||
      CinP < Cin || B < 1 || T < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto wb = static_cast<const __nv_bfloat16*>(w);
  auto bf = static_cast<const float*>(bias);
  auto rf = static_cast<const float*>(res);
  auto scf = static_cast<const float*>(sc);
  auto sbf = static_cast<const float*>(sb);
  auto yf = static_cast<float*>(y);
  cudaError_t err;
  if (Cout % 64 == 0)
    err = launch<64>(xf, wb, bf, rf, scf, sbf, yf, B, Cin, CinP, Cout, Cres, T, W, s);
  else if (Cout % 32 == 0)
    err = launch<32>(xf, wb, bf, rf, scf, sbf, yf, B, Cin, CinP, Cout, Cres, T, W, s);
  else
    err = launch<16>(xf, wb, bf, rf, scf, sbf, yf, B, Cin, CinP, Cout, Cres, T, W, s);
  return (int)err;
}
