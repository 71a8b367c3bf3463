// One convolution of a HiFi-GAN ResBlock1 group, fused with its
// activation, edge zeroing, bias, residual and mean accumulation:
//
//   v[b,o,t] = bias[o] + sum_{c,j} W[j,o,c] * lrelu(x[b,c,t+(j-ctr)*dil])
//              (x read as zero outside [0, T)), then
//   mode 0: y = v (+ res)            mode 1: y = (v (+ res)) * scale
//   mode 2: y += (v (+ res)) * scale
//
// Replaces polgen_rvc_tpu/ops/pallas_resblock.py:fused_resblock_group (and
// its time-folded twin fused_resblock_group_folded): the wrapper in
// ops/resblock_group.py launches this 18 times per decoder stage.
//
// Bound: operations. One group is 252*C^2*T FLOP (C = 256..32, T up to
// 1.9M samples per row); bytes are ~18 fp32 reads and writes of (C, T).
// Design: the tensor-core implicit GEMM of conv1d_mma.cuh (M = C_out,
// N = time, K = C_in * k; mma.sync bf16 operands, fp32 accumulator; the
// im2col is never built). The TPU kernel's time fold, a matrix-unit trick,
// is not reproduced: 64- and 32-row tiles serve every width.
// Later work: wgmma/TMA, and the whole group in one pass.
#include "conv1d_mma.cuh"

// x, res, y: (B, C, T) fp32; w: (k, C, C) bf16 [tap][out][in]; bias (C,).
// res may be null and may alias y. C must be a multiple of 32.
POLGEN_API int resblock_conv(const void* x, const void* w, const void* bias,
                             const void* res, void* y, int B, int C, int T,
                             int k, int dil, float slope, int mode,
                             float scale, void* stream) {
  return (int)conv1d_mma::launch(x, w, bias, res, y, B, C, C, T, 1, k, dil,
                                 slope, mode, scale, stream);
}
