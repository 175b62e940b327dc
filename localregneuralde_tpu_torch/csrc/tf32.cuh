// The TF32 tier's device primitives, shared by the TD-MLP cores
// (sweep_cluster.cuh, solve_cluster.cuh), the conv GEMM core
// (conv_core.cuh), and the SDE, score and chain families' row tiles
// (sde.cuh, score.cuh, score_rows.cuh, chain_rows.cuh).
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

// ---------------------------------------------------------------- row tiles
// A product out[n][m] = Σ_k x[n][k]·A[m][k] of a few rows n < 8 (the
// columns of mma.sync m16n8k8) runs on one warp per 16 outputs m: a chain
// of one mma a k-step, in order, so each output has the same bits whatever
// the other columns hold and wherever its row lands. A (M × K) is a weight
// matrix fixed for the launch, rounded to TF32 once, where it is staged,
// into a fragment copy: for m-tile mt and k-step ks, lane l holds
// mma_tf32's {a0, a1, a2, a3} as one uint4, zero past M and K, and a
// k-step's A operand is one 16-byte load a lane. x, the rows' activations,
// is rounded as it is read.
__host__ __device__ inline int frag_mtiles(int M) { return (M + 15) / 16; }
__host__ __device__ inline int frag_ksteps(int K) { return (K + 7) / 8; }

// Floats of the fragment copy of an M × K operand.
__host__ __device__ inline size_t frag_floats(int M, int K) {
  return static_cast<size_t>(frag_mtiles(M)) * frag_ksteps(K) * 128;
}

// Stage A[m][k] = src[m·sm + k·sk] (M × K, in global memory) into its
// fragment copy at dst. The caller synchronises.
__device__ inline void stage_frag(uint4* dst, const float* src, int M, int K,
                                  int sm, int sk) {
  const int Kt = frag_ksteps(K), n = frag_mtiles(M) * Kt * 32;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int lane = i & 31, tile = i >> 5;
    const int mt = tile / Kt, ks = tile - mt * Kt;
    const int m = mt * 16 + (lane >> 2), k = ks * 8 + (lane & 3);
    auto at = [&](int mm, int kk) {
      return mm < M && kk < K ? tf32_bits(src[mm * sm + kk * sk]) : 0u;
    };
    dst[i] = make_uint4(at(m, k), at(m + 8, k), at(m, k + 4), at(m + 8, k + 4));
  }
}

// d = the 16 × 8 tile mt of out for rows n < nrows of x ([row][ldx], K
// wide): one mma.sync chain over the k-steps, in order, on the calling warp.
__device__ __forceinline__ void tile_tf32(const uint4* frag, int mt, int K,
                                          const float* x, int ldx, int nrows,
                                          float (&d)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int Kt = frag_ksteps(K);
  const bool live = g < nrows;
  const float* xr = x + g * ldx;
  const uint4* fr = frag + static_cast<size_t>(mt) * Kt * 32 + lane;
  d[0] = d[1] = d[2] = d[3] = 0.f;
  for (int ks = 0; ks < Kt; ++ks) {
    const uint4 a4 = fr[ks * 32];
    const int k0 = ks * 8 + q;
    const unsigned a[4] = {a4.x, a4.y, a4.z, a4.w};
    const unsigned b[2] = {live && k0 < K ? tf32_bits(xr[k0]) : 0u,
                           live && k0 + 4 < K ? tf32_bits(xr[k0 + 4]) : 0u};
    mma_tf32(d, a, b);
  }
}

// The tile's outputs, out[row][m] for rows < nrows (of at most Cols) and m
// < M: lane (g, q) holds rows 2q and 2q + 1 of outputs mt·16 + g (d0, d1)
// and + 8 (d2, d3). put(row, m, value) stores one.
template <int Cols, typename Put>
__device__ __forceinline__ void tile_put(const float (&d)[4], int mt, int M,
                                         int nrows, Put put) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  if (2 * q >= Cols) return;  // columns past the rows
  const int m = mt * 16 + g, r = 2 * q;
  if (m < M) {
    if (r < nrows) put(r, m, d[0]);
    if (r + 1 < nrows) put(r + 1, m, d[1]);
  }
  if (m + 8 < M) {
    if (r < nrows) put(r, m + 8, d[2]);
    if (r + 1 < nrows) put(r + 1, m + 8, d[3]);
  }
}

}  // namespace lrnde
