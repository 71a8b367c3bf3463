// ConvTranspose1d for kernel k, stride u and padding p with k - 2p = u and
// 0 <= p <= 2u: the NSF decoder's upsampling, T_out = T_in * u. Output
// sample t = m*u + r draws on input m + d only for the offsets d of D(r) =
// {d : 0 <= r + p - d*u < k}, the run floor((r - p)/u) .. floor((r + p)/u).
// So
//
//   y[b,o,m*u+r] = bias[o] + sum_c sum_{d in D(r)} W[c,o,r+p-d*u] x[b,c,m+d]
//
// with x read as zero outside [0, T_in). Every offset lies within -H..H for
// the halo H = ceil(p/u) <= 2 (v1 32 kHz's u = 4, k = 16, p = 6 has H = 2,
// every other published stage H = 1). Every kernel tap belongs to exactly
// one (r, d) pair, so the packed weights (ops/conv_transpose.py,
// pack_phase_taps) are the k taps as (k, C_out, C_in) bf16 in phase order:
// phase r's taps start at block sum_{r' < r} |D(r')|, in ascending d. No
// zero tap is stored or multiplied: at k = 2u each phase has two taps, at
// 40 kHz's k = 16, u = 10 phases 3..6 have one, at v1 32 kHz's k = 16,
// u = 4 every phase has four.
//
// Replaces polgen_rvc_tpu/ops/pallas_convtranspose.py:conv_transpose1d_pallas
// (all u phases stacked on M over a 3-tap im2col, bf16 operands, fp32
// accumulation and bias, the result in x's dtype), which this computes in
// the same precision. That kernel packs offsets -1..1 only, so where p > u
// it drops the outer taps; this one keeps them, as the JAX package's XLA
// conv_transpose does.
//
// Bound: operations at u = 12 and 10 (2 k C_in C_out T_in FLOP against few
// bytes), bytes at u = 2 (each output written once, at T_out = 2 T_in).
// Design: bf16 in and out with no cast pass around the kernel (fp32 in and
// out for checks at fp32 summation order). A block of eight warps owns one
// batch row, BN input positions and BM output channels, for all u phases.
// It stages x[:, m0-H : m0+BN+H] once (H, a template argument, at least
// 1), for the whole of C_in, as bf16 in shared memory (time-major, channels
// contiguous, so every tap offset d is the same buffer shifted by d rows).
// Each phase's run of offsets and the packed block of its first tap are
// closed forms at H = 1 and short sums over the earlier phases at H = 2.
// Warps then take tasks of (phase, 32 channels, 64 positions):
// mma.sync m16n8k16 with the taps' weights as A
// fragments straight from global memory (L2-resident; each weight element
// is read by one warp of the block, one step ahead of its use) and x as B
// fragments through ldmatrix, over K = |D(r)| * C_in. Each task adds the
// fp32 bias, rounds once to the output type and writes its phase into an
// output tile in shared memory at stride u; after all phases the tile
// (BM x BN*u) goes out in time order as 16-byte vectors. Not pipelined
// beyond the one-step weight prefetch, no wgmma (later work).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;      // eight warps
constexpr int WARPS = THREADS / 32;
constexpr int WM = 32;            // output channels of a warp task (2 m16 tiles)
constexpr int WN = 64;            // input positions of a warp task (8 n8 tiles)
constexpr int MAX_SMEM = 232448;  // 227 KB a block, H100

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, which lands in r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const __nv_bfloat16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Bytes of shared memory: the staged input (BN + 2H rows), then the output
// tile.
template <typename T>
size_t smem_bytes(int Cin, int BM, int BN, int u, int H) {
  return align16((size_t)(BN + 2 * H) * (Cin + 8) * sizeof(__nv_bfloat16)) +
         (size_t)BM * (BN * u + 16 / sizeof(T)) * sizeof(T);
}

// floor(a / u) for u > 0 and any sign of a
__host__ __device__ __forceinline__ int floor_div(int a, int u) {
  return a >= 0 ? a / u : -((u - 1 - a) / u);
}

// x: (B, Cin, Tin) T; w: (k, Cout, Cin) bf16 phase-packed taps; bias: (Cout,)
// fp32; y: (B, Cout, Tin*u) T. Grid (ceil(Tin / BN), Cout / BM, B); BM is a
// multiple of WM, BN of WN, Cin and Cout of 32; H = 1 for pad <= u, else 2.
template <typename T, int H>
__global__ void __launch_bounds__(THREADS, 2)
convt_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ w,
             const float* __restrict__ bias, T* __restrict__ y, int Cin,
             int Cout, int Tin, int u, int pad, int BM, int BN) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int VEC = 16 / sizeof(T);
  const int CS = Cin + 8;  // staged row stride in bf16: rows 16 bytes apart mod 128
  const int rows = BN + 2 * H;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  T* ys = reinterpret_cast<T*>(
      smem_raw + align16((size_t)rows * CS * sizeof(__nv_bfloat16)));
  const int YS = BN * u + VEC;  // output tile row stride

  const int m0 = blockIdx.x * BN;
  const int o0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;

  // x[b, :, m0-H .. m0+BN+H-1] as bf16 pairs of channels: consecutive
  // threads read consecutive t of two channels and store one 32-bit word
  const T* xb = x + (size_t)b * Cin * Tin;
  for (int idx = tid; idx < (Cin / 2) * rows; idx += THREADS) {
    const int cp = idx / rows, j = idx - cp * rows;
    const int t = m0 - H + j;
    float v0 = 0.f, v1 = 0.f;
    if (t >= 0 && t < Tin) {
      const T* xp = xb + (size_t)(2 * cp) * Tin + t;
      v0 = to_f(xp[0]);
      v1 = to_f(xp[Tin]);
    }
    *reinterpret_cast<uint32_t*>(xs + j * CS + 2 * cp) =
        pack_bf16x2(__float2bfloat16(v0), __float2bfloat16(v1));
  }
  __syncthreads();

  const int n_og = BM / WM, n_ng = BN / WN;
  const int n_tasks = u * n_og * n_ng;
  const int ksteps = Cin / 16;
  // this lane's ldmatrix row within a pair of n8 tiles, and its k half
  const int ld_row = ((lane >> 4) << 3) + (lane & 7);
  const int ld_k = ((lane >> 3) & 1) * 8;

  for (int task = warp; task < n_tasks; task += WARPS) {
    const int r = task / (n_og * n_ng);
    const int rem = task - r * n_og * n_ng;
    const int og = rem / n_ng, ng = rem - og * n_ng;
    // D(r) is the run d0 .. d0 + ntap - 1 within -H..H; its taps start at
    // packed block `start`, after the taps of phases 0 .. r-1
    int d0, ntap, start;
    if constexpr (H == 1) {
      // d = 0 always, d = -1 when r < pad, d = +1 when r >= u - pad
      d0 = r < pad ? -1 : 0;
      ntap = 1 + (r < pad) + (r >= u - pad);
      start = r + min(r, pad) + max(0, r - (u - pad));
    } else {
      d0 = floor_div(r - pad, u);
      ntap = floor_div(r + pad, u) - d0 + 1;
      start = 0;
      for (int rr = 0; rr < r; ++rr)
        start += floor_div(rr + pad, u) - floor_div(rr - pad, u) + 1;
    }
    const __nv_bfloat16* wr =
        w + ((size_t)start * Cout + o0 + og * WM + g) * Cin + 2 * q;
    const size_t tap_stride = (size_t)Cout * Cin;

    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    // A fragments of step s = ti * ksteps + kc: rows g, g+8 of each m16 tile
    auto load_a = [&](uint32_t (*a)[4], int ti, int kc) {
      const __nv_bfloat16* p = wr + ti * tap_stride + kc * 16;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* pm = p + (size_t)mt * 16 * Cin;
        a[mt][0] = ldg32(pm);
        a[mt][1] = ldg32(pm + 8 * Cin);
        a[mt][2] = ldg32(pm + 8);
        a[mt][3] = ldg32(pm + 8 * Cin + 8);
      }
    };

    uint32_t a[2][4], an[2][4];
    load_a(a, 0, 0);
    int ti = 0, kc = 0;
    const int steps = ntap * ksteps;
    for (int s = 0; s < steps; ++s) {
      int nti = ti, nkc = kc + 1;
      if (nkc == ksteps) { nkc = 0; ++nti; }
      if (s + 1 < steps) load_a(an, nti, nkc);
      // B: x rows ng*WN + H + d + n, channels kc*16 .. +15
      const __nv_bfloat16* xrow =
          xs + (ng * WN + H + d0 + ti + ld_row) * CS + kc * 16 + ld_k;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, xrow + np * 16 * CS);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16816(acc[mt][2 * np], a[mt], bf);
          mma_bf16_16816(acc[mt][2 * np + 1], a[mt], bf + 2);
        }
      }
      if (s + 1 < steps) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = an[mt][e];
      }
      ti = nti;
      kc = nkc;
    }

    // bias in fp32, one rounding, phase r of the tile at stride u
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ol = og * WM + mt * 16 + g + half * 8;
        const float bo = __ldg(bias + o0 + ol);
        T* yrow = ys + ol * YS + r;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ml = ng * WN + nt * 8 + 2 * q + e;
            yrow[ml * u] = from_f<T>(acc[mt][nt][half * 2 + e] + bo);
          }
        }
      }
    }
  }
  __syncthreads();

  // the tile in time order: row o holds samples m0*u .. (m0+mlen)*u - 1
  const int mlen = min(BN, Tin - m0);
  const int L = mlen * u;
  const size_t Tout = (size_t)Tin * u;
  T* yb = y + ((size_t)b * Cout + o0) * Tout + (size_t)m0 * u;
  if (Tout % VEC == 0) {
    // row starts and L are multiples of VEC: 16-byte aligned vectors
    const int nv = L / VEC;
    for (int o = warp; o < BM; o += WARPS)
      for (int v = lane; v < nv; v += 32)
        *reinterpret_cast<uint4*>(yb + (size_t)o * Tout + v * VEC) =
            *reinterpret_cast<const uint4*>(ys + o * YS + v * VEC);
  } else {
    for (int o = warp; o < BM; o += WARPS)
      for (int i = lane; i < L; i += 32) yb[(size_t)o * Tout + i] = ys[o * YS + i];
  }
}

template <typename T, int H>
cudaError_t launch_t(const void* x, const void* w, const void* bias, void* y,
                     int B, int Cin, int Cout, int Tin, int u, int pad,
                     cudaStream_t stream) {
  int BM = Cout % 64 == 0 ? 64 : 32;
  // widen the block in time until its tasks cover the eight warps
  int BN = WN;
  while (BN < 4 * WN && u * (BM / WM) * (BN / WN) < WARPS && BN < Tin) BN *= 2;
  while (smem_bytes<T>(Cin, BM, BN, u, H) > MAX_SMEM) {
    if (BN > WN) BN /= 2;
    else if (BM > WM) BM /= 2;
    else return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes<T>(Cin, BM, BN, u, H);
  cudaError_t err = cudaFuncSetAttribute(
      convt_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tin + BN - 1) / BN, Cout / BM, B);
  convt_kernel<T, H><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y), Cin, Cout, Tin, u,
      pad, BM, BN);
  return cudaGetLastError();
}

// The staged halo H = ceil(pad / u), at least one row: every p <= u stage
// runs the H = 1 instance, whose phase runs are closed forms; p > u stages
// (v1 32 kHz's second) the H = 2 one.
template <typename T>
cudaError_t launch_h(const void* x, const void* w, const void* bias, void* y,
                     int B, int Cin, int Cout, int Tin, int u, int pad,
                     cudaStream_t stream) {
  return pad > u ? launch_t<T, 2>(x, w, bias, y, B, Cin, Cout, Tin, u, pad, stream)
                 : launch_t<T, 1>(x, w, bias, y, B, Cin, Cout, Tin, u, pad, stream);
}

}  // namespace

// x: (B, Cin, Tin) and y: (B, Cout, Tin*u), both bf16 when bf16_io, else
// fp32; w: (k, Cout, Cin) bf16 as pack_phase_taps lays it out, k = u + 2*pad;
// bias: (Cout,) fp32. Cin and Cout are multiples of 32; pad <= 2u (H <= 2).
POLGEN_API int conv_transpose_upsample(const void* x, const void* w,
                                       const void* bias, void* y, int B,
                                       int Cin, int Cout, int Tin, int u,
                                       int pad, int bf16_io, void* stream) {
  if (Cin % 32 != 0 || Cout % 32 != 0 || Cin < 32 || Cout < 32 || B < 1 ||
      B > 65535 || Tin < 1 || u < 1 || pad < 0 || pad > 2 * u)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(bf16_io
                   ? launch_h<__nv_bfloat16>(x, w, bias, y, B, Cin, Cout, Tin,
                                             u, pad, s)
                   : launch_h<float>(x, w, bias, y, B, Cin, Cout, Tin, u, pad, s));
}
