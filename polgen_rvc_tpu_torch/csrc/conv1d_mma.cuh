// A 1-D convolution as an implicit GEMM on the tensor cores, shared by the
// resblock-group and conv-transpose kernels:
//
//   v[b,o,t] = bias[o] + sum_{c,j} W[p][j,o,c] * lrelu(x[b,c,t+(j-ctr)*dil])
//
// with x read as zero outside [0, T) and ctr = (k-1)/2, for each of P
// phases p (P = 1 for an ordinary conv), written to
// y[b, o, t*P + p] (a (B, Cout, T*P) tensor) as
//
//   mode 0: y = v (+ res)            mode 1: y = (v (+ res)) * scale
//   mode 2: y += (v (+ res)) * scale
//
// res (B, Cout, T*P) may be null and may alias y.
//
// Design: M = Cout, N = time, K = Cin * k, on mma.sync m16n8k16 with bf16
// operands and an fp32 accumulator. A block owns BM output channels of one
// phase x 128 time steps; four warps each own 32 time steps. For each chunk
// of 32 input channels it stages lrelu(x) over the tile plus its (k-1)*dil
// halo in shared memory once, time-major with channels contiguous, so every
// tap j reads the same buffer shifted by j*dil rows: the im2col is never
// built. All k taps of the weight chunk sit beside it. Not pipelined: the
// next chunk's loads wait for this chunk's products (later work: cp.async or
// TMA double buffering, wgmma).
#pragma once

#include "common.cuh"

// internal linkage: each kernel library carries its own copy
namespace {
namespace conv1d_mma {

constexpr int BN = 128;      // time steps per block
constexpr int KC = 32;       // input channels per staged chunk
constexpr int STRIDE = 40;   // smem row stride in bf16 (80 bytes: 16-aligned)
constexpr int THREADS = 128; // four warps, each 32 time steps wide

// W: (P, k, Cout, Cin) bf16. Cin and Cout are multiples of 32 (BM divides
// Cout); the grid is (ceil(T / BN), P * Cout / BM, B). GENERAL = false is the
// square ordinary conv, P = 1 and Cin = Cout: telling the compiler so made
// the C = 128 resblock convs ~1.4x faster on the H100 than leaving Cin and
// Cout free (same SASS register count, same results bit for bit).
template <int BM, bool GENERAL>
__global__ void __launch_bounds__(THREADS)
kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
       const float* __restrict__ bias, const float* res, float* y, int Cin,
       int Cout, int T, int P_, int k, int dil, float slope, int mode,
       float scale) {
  const int P = GENERAL ? P_ : 1;
  if (!GENERAL) Cin = Cout;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int rows = BN + (k - 1) * dil;
  __nv_bfloat16* ws = xs + rows * STRIDE;

  const int o_tiles = Cout / BM;
  const int phase = GENERAL ? blockIdx.y / o_tiles : 0;
  const int t0 = blockIdx.x * BN;
  const int o0 = (blockIdx.y - phase * o_tiles) * BM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int ctr = (k - 1) / 2;
  const int tlo = t0 - ctr * dil;
  const __nv_bfloat16* wp = w + (size_t)phase * k * Cout * Cin;

  constexpr int MT = BM / 16;
  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const float* xb = x + (size_t)b * Cin * T;
  for (int c0 = 0; c0 < Cin; c0 += KC) {
    __syncthreads();
    // lrelu(x) as bf16 pairs: consecutive threads read consecutive t of two
    // channels and store one 32-bit word
    for (int idx = tid; idx < (KC / 2) * rows; idx += THREADS) {
      const int cp = idx / rows, r = idx - cp * rows;
      const int t = tlo + r;
      float v0 = 0.f, v1 = 0.f;
      if (t >= 0 && t < T) {
        const float* xp = xb + (size_t)(c0 + 2 * cp) * T + t;
        v0 = xp[0];
        v1 = xp[T];
        v0 = v0 > 0.f ? v0 : v0 * slope;
        v1 = v1 > 0.f ? v1 : v1 * slope;
      }
      *reinterpret_cast<uint32_t*>(xs + r * STRIDE + 2 * cp) =
          pack_bf16x2(__float2bfloat16(v0), __float2bfloat16(v1));
    }
    // weights: each (tap, out) row of the chunk is KC bf16 = four 16-byte
    // vectors, 16-byte aligned in global (Cin % 32 == 0) and shared memory
    for (int idx = tid; idx < k * BM * (KC / 8); idx += THREADS) {
      const int v8 = idx & (KC / 8 - 1);
      const int jo = idx / (KC / 8);  // j * BM + o
      const int j = jo / BM, o = jo - j * BM;
      *reinterpret_cast<uint4*>(ws + jo * STRIDE + v8 * 8) =
          *reinterpret_cast<const uint4*>(
              wp + ((size_t)j * Cout + o0 + o) * Cin + c0 + v8 * 8);
    }
    __syncthreads();
    for (int j = 0; j < k; ++j) {
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
          const int n = warp * 32 + nt * 8 + g;
          const __nv_bfloat16* xp = xs + (n + j * dil) * STRIDE + kk + 2 * q;
          uint32_t bf[2];
          bf[0] = *reinterpret_cast<const uint32_t*>(xp);
          bf[1] = *reinterpret_cast<const uint32_t*>(xp + 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], bf);
        }
      }
    }
  }

  const size_t TP = (size_t)T * P;
  float* yb = y + (size_t)b * Cout * TP;
  const float* rb = res ? res + (size_t)b * Cout * TP : nullptr;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = o0 + mt * 16 + g + half * 8;
      const float bo = bias[o];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + warp * 32 + nt * 8 + 2 * q + e;
          if (t >= T) continue;
          const size_t i = (size_t)o * TP + (size_t)t * P + phase;
          float v = acc[mt][nt][half * 2 + e] + bo;
          if (rb) v += rb[i];
          if (mode == 0) yb[i] = v;
          else if (mode == 1) yb[i] = v * scale;
          else yb[i] += v * scale;
        }
      }
    }
  }
}

template <int BM, bool GENERAL>
cudaError_t launch_bm(const float* x, const __nv_bfloat16* w,
                      const float* bias, const float* res, float* y, int B,
                      int Cin, int Cout, int T, int P, int k, int dil,
                      float slope, int mode, float scale,
                      cudaStream_t stream) {
  const size_t smem =
      (size_t)(BN + (k - 1) * dil + k * BM) * STRIDE * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      kernel<BM, GENERAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BN - 1) / BN, P * (Cout / BM), B);
  kernel<BM, GENERAL><<<grid, THREADS, smem, stream>>>(
      x, w, bias, res, y, Cin, Cout, T, P, k, dil, slope, mode, scale);
  return cudaGetLastError();
}

// Checks the shapes the kernel takes and picks the tile height.
inline cudaError_t launch(const void* x, const void* w, const void* bias,
                          const void* res, void* y, int B, int Cin, int Cout,
                          int T, int P, int k, int dil, float slope, int mode,
                          float scale, void* stream) {
  if (Cin % KC != 0 || Cout % 32 != 0 || B < 1 || T < 1 || P < 1 || k < 1 ||
      dil < 1 || mode < 0 || mode > 2 || P * (Cout / 32) > 65535)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto wb = static_cast<const __nv_bfloat16*>(w);
  auto bf = static_cast<const float*>(bias);
  auto rf = static_cast<const float*>(res);
  auto yf = static_cast<float*>(y);
  if (P > 1 || Cin != Cout)
    return Cout % 64 == 0
               ? launch_bm<64, true>(xf, wb, bf, rf, yf, B, Cin, Cout, T, P, k,
                                     dil, slope, mode, scale, s)
               : launch_bm<32, true>(xf, wb, bf, rf, yf, B, Cin, Cout, T, P, k,
                                     dil, slope, mode, scale, s);
  return Cout % 64 == 0
             ? launch_bm<64, false>(xf, wb, bf, rf, yf, B, Cin, Cout, T, 1, k,
                                    dil, slope, mode, scale, s)
             : launch_bm<32, false>(xf, wb, bf, rf, yf, B, Cin, Cout, T, 1, k,
                                    dil, slope, mode, scale, s);
}

}  // namespace conv1d_mma
}  // namespace
