// Shared helpers for the port's kernels: bf16 operand packing and the
// m16n8k16 bf16 tensor-core product (mma.sync, fp32 accumulate). Products
// of two bf16 values are exact in fp32, so against a plain version on the
// same bf16-rounded operands only the fp32 summation order differs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define POLGEN_API extern "C" __attribute__((visibility("default")))

// Two bf16 values packed into one 32-bit register, lower index in the low
// half (the fragment layout of mma.sync).
__device__ __forceinline__ uint32_t pack_bf16x2(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// D(16x8, f32) += A(16x16, bf16, row-major) * B(16x8, bf16, column-major).
// Per lane (g = lane / 4, q = lane % 4):
//   a[0] = A[g][2q..2q+1]    a[1] = A[g+8][2q..2q+1]
//   a[2] = A[g][2q+8..+9]    a[3] = A[g+8][2q+8..+9]
//   b[0] = B[2q..2q+1][g]    b[1] = B[2q+8..+9][g]
//   d[0..1] = D[g][2q..2q+1] d[2..3] = D[g+8][2q..2q+1]
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
