// The TF32 tier's device primitives, shared by the TD-MLP cores
// (sweep_cluster.cuh, solve_cluster.cuh) and the conv GEMM core
// (conv_core.cuh).
//
// The reference's 'default' precision (a dot at the backend's default, which
// on this card is TF32): each operand of a product is rounded to TF32 with
// cvt.rna.tf32.f32 (round to nearest, ties away from zero: 10 mantissa bits,
// the low 13 cleared), the products run on the tensor cores (mma.sync
// m16n8k8 with .tf32 operands) and accumulate in FP32. A product of two TF32
// operands is exact in FP32, so a kernel at this tier and its plain version
// (nn.basic.round_tf32 on both operands, then an FP32 product) differ only
// in how their FP32 sums are ordered and rounded: the tensor cores round
// their internal sums toward zero. Elementwise work (biases, the time
// channel's s·tmap, activations, BatchNorm, the stage combinations, ũ, the
// error norm) stays FP32.
#pragma once

namespace lrnde {

// x rounded to TF32 (its bit pattern, as mma.sync reads a .tf32 operand)
__device__ __forceinline__ unsigned tf32_bits(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float to_tf32(float x) {
  return __uint_as_float(tf32_bits(x));
}

// d += A·B for one warp: A 16 × 8 (a0: row g, col q; a1: row g + 8, col q;
// a2: row g, col q + 4; a3: row g + 8, col q + 4), B 8 × 8 (b0: row q, col
// g; b1: row q + 4, col g), d 16 × 8 (d0, d1: row g, cols 2q, 2q + 1; d2,
// d3: row g + 8, the same cols), with g = lane / 4 and q = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(d[0]), "f"(d[1]), "f"(d[2]), "f"(d[3]));
}

}  // namespace lrnde
