// The song's conversion head: scipy's filtfilt(b, a, x) with the 5th-order
// 48 Hz Butterworth high-pass at 16 kHz (padtype "odd", padlen 18, initial
// state lfilter_zi * the pass's first sample), in float64; then the float32
// cast, the reflect pad by t_pad, the int16 quantize against the padded
// signal's own max into a zero-tailed bucket (numpy's float32 product and
// round-half-even), and the dequantized float32 buffer q * inv_scale.
//
// Replaces no TPU kernel: the JAX package runs this head on the host (scipy,
// or its C++ twin native/dsp.cpp), and so did the port, leaving the card
// idle for a fifth to a third of a song's wall time. Here it runs on the
// card, so the F0 pass queues behind it with no host sync.
//
// Bound: bytes. A 240 s song (3.84 M samples, 3.84 M + 36 extended) moves
// ~255 MB as designed: the float32 input read once, the float64 extension
// written, read twice and overwritten by the forward pass, read twice
// more by the backward pass, the float32 signal written and read again,
// and the int16 and float32 buffers of the 3.93 M-sample bucket written:
// ~76 us at 3.35 TB/s (~54 MB, ~16 us, counting each input and output
// once). The float64 work, 21 operations a sample and run, four runs (zero
// start and rerun, both directions), is ~0.32 GFLOP: ~10 us at 33.5
// TFLOP/s. Neither sets the time: a tile is one lane's dependent chain of
// TILE steps (three float64 operations deep, 21 issued a step), so each of
// the four tile launches takes that chain's latency.
//
// Design. An IIR filter is one dependent chain of float64 operations a
// sample; one thread over 3.84 M samples would take longer than the host.
// lfilter's direct form II transposed is the state-space recurrence
// z[n+1] = A z[n] + B x[n], y[n] = z0[n] + b0 x[n], linear in z, so each
// pass runs as a blocked scan over tiles of TILE samples, one lane a tile,
// one warp a block of 32 consecutive tiles:
//   tile_ends     each tile from a zero state: its end state E_k;
//   carry         one block of SCAN_THREADS threads: the start states
//                 S_{k+1} = A^TILE S_k + E_k from S_0 = zi * (first sample).
//                 Thread j composes its group of g consecutive tiles, a
//                 Hillis-Steele scan over the groups joins them with the
//                 powers A^(g TILE 2^d), and thread j walks its tiles again
//                 to write each one's start state; never one thread over
//                 every tile;
//   tile_outputs  each tile reruns the recurrence from its start state and
//                 writes its outputs.
// A warp stages its tiles' samples through shared memory CHUNK steps at a
// time, so every load and store of device memory is a coalesced row.
// The rerun needs no per-sample powers of A. TILE is set by A's transient,
// not by its poles: with five poles near 1 (radii 0.981-0.994) the entries
// of A^k reach 1.7e7 at k = 193 and fall below 1 only from k = 2,608, so at
// a shorter tile the carry's products cancel and their rounding reaches the
// output amplified; at 4,096 they are below 1.9e-3 and the carry rounds
// like one step of the recurrence (the host computes the powers to 60
// digits). First, scipy's odd extension of the raw input is written in
// float64 (extend); the forward pass runs over it in place. The backward
// pass reads the forward output reversed, its initial state scaled by the
// forward pass's last output, which its carry reads from device memory: a
// grid-wide dependency, so each pass is three launches. The backward
// pass's epilogue casts to float32, keeps the unpadded samples and takes
// their max (one atomicMax a warp); one last launch reflect-pads,
// quantizes and dequantizes. Eight launches and a 4-byte memset; nothing
// returns to the host.
//
// Every step does scipy's operations in scipy's order with explicit
// round-to-nearest intrinsics (no contraction into FMAs): y = z0 + x b0,
// z_i = (z_{i+1} + x b_{i+1}) - y a_{i+1}, z_4 = x b5 - y a5; each
// matrix-vector product sums its five terms in index order. The plain twin
// (ops/highpass.py) does the same operations in the same order, so the two
// agree bit for bit. scipy's own sequential pass rounds differently, ~1e-7
// of the peak away (its state's transient amplifies each step's rounding).
#include <math.h>
#include <string.h>

#include "common.cuh"

namespace {

constexpr int ORDER = 5;
constexpr int PADLEN = 3 * (ORDER + 1);
constexpr int TILE = 4096;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_STEPS = 10;  // log2(SCAN_THREADS)
constexpr int WARP = 32;        // a tile kernel's block: one warp, one tile a lane
constexpr int CHUNK = 32;       // steps a warp stages through shared memory at once
constexpr int QUANT_THREADS = 256;
constexpr int QUANT_BLOCKS = 2048;
constexpr unsigned FULL = 0xffffffffu;

struct Coefs {
  double b[ORDER + 1];
  double a[ORDER + 1];
  double zi[ORDER];
};

struct Powers {
  double tile[ORDER * ORDER];              // A^TILE, row-major
  double scan[SCAN_STEPS][ORDER * ORDER];  // A^(g TILE 2^d)
};

// scipy's odd extension of the raw signal, 2 x[0] - x[18..1], x,
// 2 x[n-1] - x[n-2..n-19], in float64: the forward pass's input.
template <typename T>
__device__ __forceinline__ double odd_ext(const T* x, long long n, long long e) {
  if (e < PADLEN) return __dsub_rn(2.0 * (double)x[0], (double)x[PADLEN - e]);
  const long long i = e - PADLEN;
  if (i < n) return (double)x[i];
  return __dsub_rn(2.0 * (double)x[n - 1], (double)x[2 * n - 2 - i]);
}

// A pass's input read forward (the forward pass: the odd extension) or
// reversed (the backward pass: the forward pass's output).
struct Forward {
  const double* y;
  __device__ double operator()(long long e) const { return y[e]; }
};

struct Reversed {
  const double* y;
  long long len;
  __device__ double operator()(long long r) const { return y[len - 1 - r]; }
};

// The forward pass's outputs, stored as they are.
struct Store {
  double* y;
  long long len;
  __device__ void operator()(long long e, double v) {
    if (e < len) y[e] = v;
  }
  __device__ void finish() {}
};

// The backward pass's outputs: reversed again, the padlen samples at each
// end dropped, cast to float32; the max of their magnitudes, one atomicMax
// a warp on the bits (non-negative floats order as unsigned integers).
struct Final {
  float* audio;
  unsigned* amax;
  long long n;
  long long len;
  float m;
  __device__ void operator()(long long r, double v) {
    const long long i = len - 1 - r - PADLEN;
    if (r < len && i >= 0 && i < n) {
      const float f = __double2float_rn(v);
      audio[i] = f;
      m = fmaxf(m, fabsf(f));
    }
  }
  __device__ void finish() {
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    if ((threadIdx.x & 31) == 0 && m > 0.f) atomicMax(amax, __float_as_uint(m));
  }
};

__device__ __forceinline__ double step(const Coefs& c, double x, double* z) {
  const double y = __dadd_rn(z[0], __dmul_rn(x, c.b[0]));
#pragma unroll
  for (int i = 0; i < ORDER - 1; ++i)
    z[i] = __dsub_rn(__dadd_rn(z[i + 1], __dmul_rn(x, c.b[i + 1])),
                     __dmul_rn(y, c.a[i + 1]));
  z[ORDER - 1] = __dsub_rn(__dmul_rn(x, c.b[ORDER]), __dmul_rn(y, c.a[ORDER]));
  return y;
}

// out = M v, each row summed in index order.
__device__ __forceinline__ void matvec(const double* m, const double* v, double* out) {
#pragma unroll
  for (int i = 0; i < ORDER; ++i) {
    double acc = __dmul_rn(m[i * ORDER], v[0]);
#pragma unroll
    for (int j = 1; j < ORDER; ++j) acc = __dadd_rn(acc, __dmul_rn(m[i * ORDER + j], v[j]));
    out[i] = acc;
  }
}

// v = M v + e.
__device__ __forceinline__ void affine(const double* m, double* v, const double* e) {
  double out[ORDER];
  matvec(m, v, out);
#pragma unroll
  for (int i = 0; i < ORDER; ++i) v[i] = __dadd_rn(out[i], e[i]);
}

template <typename T>
__global__ void __launch_bounds__(QUANT_THREADS)
extend_kernel(const T* x, long long n, double* ext) {
  const long long len = n + 2 * PADLEN;
  const long long stride = (long long)gridDim.x * QUANT_THREADS;
  for (long long e = blockIdx.x * (long long)QUANT_THREADS + threadIdx.x; e < len; e += stride)
    ext[e] = odd_ext(x, n, e);
}

// The warp's WARP tiles (one a lane) from states z, CHUNK steps at a time:
// the warp loads the chunk's inputs of all its tiles row by row (lanes on
// consecutive samples: coalesced), one chunk ahead in registers, and
// transposes them through shared memory; each lane steps its own tile; the
// outputs go back the same way, row by row. Samples past len read as 0
// (only the last tile has them; its end state is never used).
template <bool kStores, class Src, class Out>
__device__ __forceinline__ void run_tiles(const Coefs& c, const Src& src, long long len,
                                          long long n_tiles, double* z, Out& out) {
  __shared__ double xs[WARP][CHUNK + 1];
  __shared__ double ys[WARP][CHUNK + 1];
  const int lane = threadIdx.x;
  const long long k0 = (long long)blockIdx.x * WARP;
  const bool live = k0 + lane < n_tiles;
  double nxt[WARP];
#pragma unroll
  for (int t = 0; t < WARP; ++t) {
    const long long e = (k0 + t) * TILE + lane;
    nxt[t] = e < len ? src(e) : 0.0;
  }
  for (int i0 = 0; i0 < TILE; i0 += CHUNK) {
#pragma unroll
    for (int t = 0; t < WARP; ++t) xs[t][lane] = nxt[t];
    __syncwarp();
    if (i0 + CHUNK < TILE) {
#pragma unroll
      for (int t = 0; t < WARP; ++t) {
        const long long e = (k0 + t) * TILE + i0 + CHUNK + lane;
        nxt[t] = e < len ? src(e) : 0.0;
      }
    }
    if (live) {
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const double y = step(c, xs[lane][u], z);
        if (kStores) ys[lane][u] = y;
      }
    }
    __syncwarp();
    if (kStores) {
#pragma unroll
      for (int t = 0; t < WARP; ++t) out((k0 + t) * TILE + i0 + lane, ys[t][lane]);
    }
  }
}

template <class Src>
__global__ void __launch_bounds__(WARP)
tile_ends_kernel(const __grid_constant__ Coefs c, const __grid_constant__ Src src, long long len,
                 long long n_tiles, double* ends) {
  const long long k = blockIdx.x * (long long)WARP + threadIdx.x;
  double z[ORDER] = {0.0, 0.0, 0.0, 0.0, 0.0};
  Store none{nullptr, 0};
  run_tiles<false>(c, src, len, n_tiles, z, none);
  if (k < n_tiles) {
#pragma unroll
    for (int i = 0; i < ORDER; ++i) ends[k * ORDER + i] = z[i];
  }
}

template <class Src>
__global__ void __launch_bounds__(SCAN_THREADS)
carry_kernel(const __grid_constant__ Coefs c, const __grid_constant__ Powers p,
             const __grid_constant__ Src src, long long n_tiles, int group,
             const double* ends, double* starts) {
  __shared__ double acc[SCAN_THREADS][ORDER];
  const int j = threadIdx.x;
  const double first = src(0);
  double s0[ORDER], u[ORDER];
#pragma unroll
  for (int i = 0; i < ORDER; ++i) {
    s0[i] = __dmul_rn(c.zi[i], first);
    u[i] = j == 0 ? s0[i] : 0.0;
  }
  const long long k0 = (long long)j * group;
  for (int k = 0; k < group && k0 + k < n_tiles; ++k) affine(p.tile, u, ends + (k0 + k) * ORDER);
#pragma unroll
  for (int i = 0; i < ORDER; ++i) acc[j][i] = u[i];
  __syncthreads();
#pragma unroll
  for (int d = 0; d < SCAN_STEPS; ++d) {
    const int off = 1 << d;
    double t[ORDER];
    if (j >= off) matvec(p.scan[d], acc[j - off], t);
    __syncthreads();
    if (j >= off) {
#pragma unroll
      for (int i = 0; i < ORDER; ++i) acc[j][i] = __dadd_rn(acc[j][i], t[i]);
    }
    __syncthreads();
  }
  const double* start = j == 0 ? s0 : acc[j - 1];
#pragma unroll
  for (int i = 0; i < ORDER; ++i) u[i] = start[i];
  for (int k = 0; k < group && k0 + k < n_tiles; ++k) {
#pragma unroll
    for (int i = 0; i < ORDER; ++i) starts[(k0 + k) * ORDER + i] = u[i];
    affine(p.tile, u, ends + (k0 + k) * ORDER);
  }
}

// No early return: the staging and Final's finish() take whole warps.
template <class Src, class Out>
__global__ void __launch_bounds__(WARP)
tile_outputs_kernel(const __grid_constant__ Coefs c, const __grid_constant__ Src src,
                    long long len, long long n_tiles, const double* starts, Out out) {
  const long long k = blockIdx.x * (long long)WARP + threadIdx.x;
  double z[ORDER] = {0.0, 0.0, 0.0, 0.0, 0.0};
  if (k < n_tiles) {
#pragma unroll
    for (int i = 0; i < ORDER; ++i) z[i] = starts[k * ORDER + i];
  }
  run_tiles<true>(c, src, len, n_tiles, z, out);
  out.finish();
}

__global__ void __launch_bounds__(QUANT_THREADS)
quantize_kernel(const float* audio, long long n, long long t_pad, long long bucket,
                const unsigned* amax_bits, short* q, float* buf, float* inv_out) {
  const float amax = __uint_as_float(*amax_bits);
  const double scale = amax > 0.f ? 32767.0 / (double)amax : 1.0;
  const float sf = __double2float_rn(scale);
  const float inv = __double2float_rn(1.0 / scale);
  if (blockIdx.x == 0 && threadIdx.x == 0) *inv_out = inv;
  const long long t = n + 2 * t_pad;
  const long long period = 2 * (n - 1);
  const long long stride = (long long)gridDim.x * QUANT_THREADS;
  for (long long p = blockIdx.x * (long long)QUANT_THREADS + threadIdx.x; p < bucket;
       p += stride) {
    short v = 0;
    if (p < t) {
      long long idx = p - t_pad;
      if (idx < 0 || idx >= n) {  // numpy's reflect, for any pad width
        idx %= period;
        if (idx < 0) idx += period;
        if (idx >= n) idx = period - idx;
      }
      v = (short)rintf(__fmul_rn(audio[idx], sf));
    }
    q[p] = v;
    buf[p] = __fmul_rn((float)v, inv);
  }
}

unsigned grid_of(long long items, int threads) {
  const long long blocks = (items + threads - 1) / threads;
  return (unsigned)(blocks < QUANT_BLOCKS ? blocks : QUANT_BLOCKS);
}

// One lfilter pass over len samples from src into out: tile ends, carry,
// tile outputs.
template <class Src, class Out>
cudaError_t lfilter_pass(const Coefs& c, const Powers& p, const Src& src, long long len,
                         long long n_tiles, int group, double* ends, double* starts,
                         const Out& out, cudaStream_t s) {
  const unsigned grid = (unsigned)((n_tiles + WARP - 1) / WARP);
  tile_ends_kernel<<<grid, WARP, 0, s>>>(c, src, len, n_tiles, ends);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carry_kernel<<<1, SCAN_THREADS, 0, s>>>(c, p, src, n_tiles, group, ends, starts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  tile_outputs_kernel<<<grid, WARP, 0, s>>>(c, src, len, n_tiles, starts, out);
  return cudaGetLastError();
}

}  // namespace

// params: b (6), a (6), zi (5), A^TILE (25), A^(group TILE 2^d) (10 x 25),
// float64 on the host (copied into the launches' arguments). fwd: (n + 36)
// float64; ends, starts: (ceil((n + 36) / TILE), 5) float64 scratch;
// audio: (n,) float32; amax: one 32-bit word; q, buf: (bucket,) int16 and
// float32; inv_scale: one float32.
POLGEN_API int highpass_pad_quant(const void* x, const void* params, void* fwd, void* ends,
                                  void* starts, void* audio, void* amax, void* q, void* buf,
                                  void* inv_scale, int x_f64, long long n, long long t_pad,
                                  long long bucket, int group, void* stream) {
  const long long len = n + 2 * PADLEN;
  const long long n_tiles = (len + TILE - 1) / TILE;
  if (n <= PADLEN || t_pad < 0 || group < 1 || bucket < n + 2 * t_pad ||
      (long long)group * SCAN_THREADS < n_tiles)
    return (int)cudaErrorInvalidValue;
  Coefs c;
  Powers p;
  const double* host = static_cast<const double*>(params);
  memcpy(&c, host, sizeof(c));
  memcpy(&p, host + sizeof(c) / sizeof(double), sizeof(p));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  double* y = static_cast<double*>(fwd);
  double* e = static_cast<double*>(ends);
  double* st = static_cast<double*>(starts);
  // the odd extension into fwd, then the forward pass over it in place (a
  // lane reads each chunk of its tile before it writes the chunk's outputs)
  if (x_f64)
    extend_kernel<<<grid_of(len, QUANT_THREADS), QUANT_THREADS, 0, s>>>(
        static_cast<const double*>(x), n, y);
  else
    extend_kernel<<<grid_of(len, QUANT_THREADS), QUANT_THREADS, 0, s>>>(
        static_cast<const float*>(x), n, y);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = lfilter_pass(c, p, Forward{y}, len, n_tiles, group, e, st, Store{y, len}, s);
  if (err != cudaSuccess) return (int)err;
  unsigned* amax_bits = static_cast<unsigned*>(amax);
  if ((err = cudaMemsetAsync(amax_bits, 0, sizeof(unsigned), s)) != cudaSuccess) return (int)err;
  err = lfilter_pass(c, p, Reversed{y, len}, len, n_tiles, group, e, st,
                     Final{static_cast<float*>(audio), amax_bits, n, len, 0.f}, s);
  if (err != cudaSuccess) return (int)err;

  quantize_kernel<<<grid_of(bucket, QUANT_THREADS), QUANT_THREADS, 0, s>>>(
      static_cast<const float*>(audio), n, t_pad, bucket, amax_bits, static_cast<short*>(q),
      static_cast<float*>(buf), static_cast<float*>(inv_scale));
  return (int)cudaGetLastError();
}
