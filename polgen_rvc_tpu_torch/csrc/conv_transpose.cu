// ConvTranspose1d for kernel k, stride u and padding p with k - 2p = u: the
// NSF decoder's upsampling, T_out = T_in * u. Output sample t = m*u + r
// draws only on input positions m-1, m, m+1, so each phase r is an
// ordinary 3-tap convolution from C_in to C_out:
//
//   y[b,o,m*u+r] = bias[o] + sum_{c, d in -1..1} P[r,d+1,o,c] * x[b,c,m+d]
//
// with the phase-tap weights P[r,d+1,o,c] = W[c,o,r+p-d*u] (zero where that
// tap falls outside the kernel), packed by ops/conv_transpose.py.
//
// Replaces polgen_rvc_tpu/ops/pallas_convtranspose.py:conv_transpose1d_pallas,
// whose phase-stacked GEMM then needed an interleave pass back to time
// order; here each phase's block writes its samples in place (stride u).
//
// Bound: bytes at the wide-T stages (each output sample is written once in
// fp32; 3*C_in*C_out*u*T_in multiply-adds are few per byte at u = 2),
// operations at u = 12. Design: the tensor-core implicit GEMM of
// conv1d_mma.cuh with k = 3, one phase per block row (grid.y = u * C_out /
// BM), bf16 operands and an fp32 accumulator. Taps that fall outside the
// kernel are multiplied as zeros (a third more work at k = 2u).
#include "conv1d_mma.cuh"

// x: (B, Cin, Tin) fp32; p: (u, 3, Cout, Cin) bf16 phase-tap weights;
// bias: (Cout,) fp32; y: (B, Cout, Tin*u) fp32. Cin and Cout are multiples
// of 32.
POLGEN_API int conv_transpose_upsample(const void* x, const void* p,
                                       const void* bias, void* y, int B,
                                       int Cin, int Cout, int Tin, int u,
                                       void* stream) {
  return (int)conv1d_mma::launch(x, p, bias, nullptr, y, B, Cin, Cout, Tin,
                                 u, 3, 1, 1.0f, 0, 1.0f, stream);
}
