// The transposed Tsit5 step of the TD-MLP on a thread-block cluster: the
// step transpose of kernels 7 and 8 (adjoint_sweep.cu) and of kernel 3
// (tsit5_step_bwd.cu), one function (transpose_rows) with a seed argument.
//
// Layout. A cluster of kSweepCluster CTAs owns a block of kSweepRows batch
// rows. CTA c of the cluster owns a slice S_c of the F state features
// (sweep_slice: ceil(F / C) wide, the last ones shorter or empty) and keeps
// in shared memory, loaded once per launch:
//   W1's rows S_c        [S][ldW]     (a K slice of the first product)
//   W2's columns S_c     [H + 1][ldS] (an N slice of the second, time row
//                                      last), b2 on S_c, all of b1 and w1t
// and, for the whole sweep, the gradient slices of the same shapes
// (dW1[S_c, :], dW2[:, S_c] with its time row, db2 on S_c; db1 and dw1t in
// rank 0). With F sliced the same way in both weights, every Tsit5 stage
// combination, the cotangents of k1..k7 and of u, and these products are
// local to the CTA:
//   forward second   k[:, S_c] = h·W2[:, S_c]
//   reverse          dx[:, S_c] = dz·W1[S_c, :]ᵀ
//   weight gradient  dW1[S_c, :] += x_i[:, S_c]ᵀ·dz_i,
//                    dW2[:, S_c] += h_iᵀ·dk_i[:, S_c]
// Two products need the whole of F and are summed across the cluster:
//   forward first    z = Σ_c x[:, S_c]·W1[S_c, :]
//   reverse          dh = Σ_c dk[:, S_c]·W2[:, S_c]ᵀ
// Entry e of the R × H sum belongs to CTA e mod C: each CTA's product
// pushes its partial of e into that CTA's inbox through DSMEM, which then
// adds the C partials in rank order 0, 1, ..., C−1 (a fixed order: the
// result does not depend on timing), applies the epilogue (tanh, or the
// tanh derivative) and stores the result into every CTA's copy
// (cluster_reduce). Remote accesses are stores only. One transposed step
// has 13 such reductions (7 evaluations, 6 reverse stages), two cluster
// barriers each, and no grid-wide barrier.
//
// Products are FP32 FFMA on 3 × 4 or 4 × 4 register tiles (tile_gemm),
// their operands float4 reads of shared memory; at the TF32 tier (the
// reference's 'default' precision: kTierRecompute, kTierGrad below) they run
// on the tensor cores instead (tile_gemm_tf32). The weight gradients
// accumulate in shared memory over every step of the sweep; at the end each
// cluster writes ONE partial (grad_floats), and reduce_partials
// (tsit5_bwd.cuh) sums the clusters' partials in cluster order. No float
// atomics: the sweep is bitwise repeatable.
//
// Memory. Per CTA at F = 784, H = 100 (S = 98, leading dimensions 100): the
// weight slices and the gradient slices take 80.8 KB each, the four work
// tiles 57.6 KB: 214.1 KB of the 227 KB a CTA can have (sweep_smem_floats).
// What does not fit stays in global scratch, which the 50 MB L2 holds: the
// stage derivatives k1..k7 and their cotangents, the stage inputs x_i (each
// CTA its own rows and slice), and the hidden rows h_i of the six stages
// (per cluster, written by the CTA that reduced them). A wider TD-MLP,
// whose gradient slices do not fit beside the rest (at F = 784: H > 102),
// adds its gradient straight into the cluster's partial in global memory
// (GradSink<false>), the same elements in the same order.
//
// What bounds it on an H100 (measured, NVIDIA H100 80GB HBM3, 700 W): a
// product is 0.35 M FFMA a CTA, ~1.5 µs at an SM's FP32 peak, and takes
// 4.6–6.5 µs: its operands come from shared memory at ~2 FFMA a wavefront
// (a 36-row product leaves no room for larger register tiles). A cluster
// reduction takes ~5 µs, 1.5 of it its two barriers. The 38 products are
// ~45% of a ~420 µs step, the reductions ~18%, the passes over global
// scratch and the barriers the rest (PERF.md §6).
#pragma once

#include <cooperative_groups.h>

#include "tsit5_bwd.cuh"

namespace lrnde {

namespace cg = cooperative_groups;

constexpr int kSweepCluster = 8;  // CTAs per cluster (the portable maximum)
// Batch rows per cluster (row block): 36, so that B = 512 takes 15 row
// blocks, as many clusters of 8 as an H100 runs at once (its
// cudaOccupancyMaxActiveClusters at this shared memory; with 32 rows one
// cluster swept two blocks, twice the time).
constexpr int kSweepRows = 36;
// Threads per CTA: 512 leave each 128 registers, so the 4 × 4 tiles and the
// passes run without spilling (at 1,024 threads and 64 registers the kernel
// spilled, and local memory went to L2: the L1 keeps only what the shared
// memory leaves, 28 KB).
constexpr int kSweepThreads = 512;

// The feature slice of rank c: [f0, f0 + n).
struct SweepSlice {
  int f0, n;
};

__host__ __device__ inline int sweep_slice_width(int F) {
  return (F + kSweepCluster - 1) / kSweepCluster;
}

__host__ __device__ inline SweepSlice sweep_slice(int F, int c) {
  const int S = sweep_slice_width(F);
  const int f0 = min(F, c * S);
  return SweepSlice{f0, min(F, f0 + S) - f0};
}

// Leading dimensions of the shared tiles: a multiple of 4 floats (16-byte
// rows, for float4 reads) whose quotient by 4 is odd, so that the 16-byte
// chunks at one column of 4 or 8 consecutive rows fall in distinct banks.
__host__ __device__ inline int vec_ld(int n) {
  const int q = (n + 3) / 4;
  return 4 * (q % 2 == 1 ? q : q + 1);
}

__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }

// Entries of a row block's R × H partial that each CTA sums
// (cluster_reduce): its inbox holds that many from every CTA.
__host__ __device__ inline int sweep_inbox_len(int H) {
  return (kSweepRows * H + kSweepCluster - 1) / kSweepCluster;
}

// Floats of the gradient slices, and of the weight slices (the same
// shapes): W1's rows [S][ldW], W2's columns [H + 1][ldS], b2 on the slice,
// b1 and w1t (the gradients' db1 and dw1t), each a multiple of 4.
__host__ __device__ inline int sweep_slice_floats(int F, int H) {
  const int S = sweep_slice_width(F);
  return S * vec_ld(H) + (H + 1) * vec_ld(S) + r4(S) + 2 * r4(H);
}

// Floats of the four work tiles: x (or a stage input, or dx) and dk
// [R][ldS], the inbox [C][L] (which also holds h_i [R][ldW]), and the
// reduced h (or dz) [R][ldW].
__host__ __device__ inline int sweep_tile_floats(int F, int H) {
  const int ldS = vec_ld(sweep_slice_width(F)), ldW = vec_ld(H);
  const int inbox = kSweepCluster * sweep_inbox_len(H);
  const int hrow = kSweepRows * ldW;
  return 2 * kSweepRows * ldS + r4(inbox > hrow ? inbox : hrow) + hrow;
}

// Dynamic shared memory a sweep CTA may have: 227 KB less the kernel's
// static shared memory (the slot-sum buffer, the step weights and the
// replay's controller: under 2.5 KB).
constexpr size_t kSweepSmemLimit = (227 * 1024 - 2560) / 4;  // floats

// The weight slices with the work tiles, or the replay's Smem (tdmlp.cuh)
// that the two-level mode lays over them between windows: the larger.
__host__ __device__ inline size_t sweep_work_floats(int F, int H) {
  const size_t work = sweep_slice_floats(F, H) + sweep_tile_floats(F, H);
  const size_t replay = smem_floats(F, H);
  return work > replay ? work : replay;
}

// Whether the gradient slices stay in shared memory, before the work region
// (at F = 784, H = 100: 214 KB in all). Otherwise (wider TD-MLPs) each CTA
// adds its gradient straight into its cluster's partial in global memory,
// at the same elements and in the same order.
__host__ __device__ inline bool sweep_grads_shared(int F, int H) {
  return sweep_slice_floats(F, H) + sweep_work_floats(F, H) <= kSweepSmemLimit;
}

// Dynamic shared memory of one sweep CTA.
__host__ __device__ inline size_t sweep_smem_floats(int F, int H) {
  return (sweep_grads_shared(F, H) ? sweep_slice_floats(F, H) : 0) +
         sweep_work_floats(F, H);
}

// The dynamic shared memory of the sweep kernel. Buffers are addressed by
// offsets into it, so every access is a 32-bit shared-memory access.
extern __shared__ __align__(16) float sweep_smem[];

// Offsets (floats) of the sweep's buffers in sweep_smem, all multiples of 4.
struct SweepSmem {
  int S, ldS, ldW;
  // gradient slices
  int g1, g2, gb2, gb1, gw1t;
  // weight slices
  int w1, w2, b2, b1, w1t;
  // work tiles
  int xa, ka, zp, hb;
  int work;  // the region the replay's Smem is carved from
};

__device__ inline SweepSmem carve_sweep_smem(int F, int H) {
  SweepSmem s;
  s.S = sweep_slice_width(F);
  s.ldS = vec_ld(s.S);
  s.ldW = vec_ld(H);
  s.g1 = 0;
  s.g2 = s.g1 + s.S * s.ldW;
  s.gb2 = s.g2 + (H + 1) * s.ldS;
  s.gb1 = s.gb2 + r4(s.S);
  s.gw1t = s.gb1 + r4(H);
  s.work = sweep_grads_shared(F, H) ? sweep_slice_floats(F, H) : 0;
  s.w1 = s.work;
  s.w2 = s.w1 + s.S * s.ldW;
  s.b2 = s.w2 + (H + 1) * s.ldS;
  s.b1 = s.b2 + r4(s.S);
  s.w1t = s.b1 + r4(H);
  s.xa = s.w1t + r4(H);
  s.ka = s.xa + kSweepRows * s.ldS;
  s.zp = s.ka + kSweepRows * s.ldS;
  const int inbox = kSweepCluster * sweep_inbox_len(H);
  const int hrow = kSweepRows * s.ldW;
  s.hb = s.zp + r4(inbox > hrow ? inbox : hrow);
  return s;
}

// Load this CTA's weight slices (again after a replay overwrote them).
__device__ inline void load_weight_slices(const TDMLP& w, const SweepSmem& s,
                                          SweepSlice sl) {
  const int F = w.F, H = w.H;
  float* const sm = sweep_smem;
  for (int i = threadIdx.x; i < sl.n * H; i += kSweepThreads) {
    const int f = i / H, h = i - f * H;
    sm[s.w1 + f * s.ldW + h] = w.w1[static_cast<size_t>(sl.f0 + f) * H + h];
  }
  for (int i = threadIdx.x; i < (H + 1) * sl.n; i += kSweepThreads) {
    const int h = i / sl.n, f = i - h * sl.n;
    sm[s.w2 + h * s.ldS + f] = w.w2[static_cast<size_t>(h) * F + sl.f0 + f];
  }
  for (int f = threadIdx.x; f < sl.n; f += kSweepThreads)
    sm[s.b2 + f] = w.b2[sl.f0 + f];
  for (int h = threadIdx.x; h < H; h += kSweepThreads) {
    sm[s.b1 + h] = w.b1[h];
    sm[s.w1t + h] = w.w1[static_cast<size_t>(F) * H + h];
  }
}

// Where a CTA adds its weight gradient: its slices in shared memory
// (kShared), written to its cluster's partial g (grad_floats, the layout of
// tsit5_bwd.cuh) at the end, or that partial itself. Either way a CTA owns
// its rows of dW1, its columns of dW2 with the time row and its b2 entries,
// rank 0 db1 and dw1t, and one thread adds each element.
template <bool kShared>
struct GradSink;

template <>
struct GradSink<true> {
  int g1, g2, gb2, gb1, gw1t, ldW, ldS, H;
  __device__ GradSink(const SweepSmem& s, SweepSlice, int, int H_, float*)
      : g1(s.g1), g2(s.g2), gb2(s.gb2), gb1(s.gb1), gw1t(s.gw1t),
        ldW(s.ldW), ldS(s.ldS), H(H_) {}
  __device__ void w1(int f, int h, float v) const {
    sweep_smem[g1 + f * ldW + h] += v;
  }
  __device__ void w2(int h, int f, float v) const {
    sweep_smem[g2 + h * ldS + f] += v;
  }
  // db1 += sum, dw1t += st·sum
  __device__ void b1(int h, float sum, float st) const {
    sweep_smem[gb1 + h] += sum;
    sweep_smem[gw1t + h] = fmaf(st, sum, sweep_smem[gw1t + h]);
  }
  // db2 += sum, the time row += st·sum
  __device__ void b2(int f, float sum, float st) const {
    sweep_smem[gb2 + f] += sum;
    sweep_smem[g2 + H * ldS + f] = fmaf(st, sum, sweep_smem[g2 + H * ldS + f]);
  }
};

template <>
struct GradSink<false> {
  float* g;
  int F, H, f0;
  __device__ GradSink(const SweepSmem&, SweepSlice sl, int F_, int H_,
                      float* g_)
      : g(g_), F(F_), H(H_), f0(sl.f0) {}
  __device__ float* gw2() const {
    return g + static_cast<size_t>(F) * H + 2 * H;
  }
  __device__ void w1(int f, int h, float v) const {
    g[static_cast<size_t>(f0 + f) * H + h] += v;
  }
  __device__ void w2(int h, int f, float v) const {
    gw2()[static_cast<size_t>(h) * F + f0 + f] += v;
  }
  __device__ void b1(int h, float sum, float st) const {
    float* const gw1t = g + static_cast<size_t>(F) * H;
    gw1t[H + h] += sum;
    gw1t[h] = fmaf(st, sum, gw1t[h]);
  }
  __device__ void b2(int f, float sum, float st) const {
    float* const w2t = gw2() + static_cast<size_t>(H) * F;
    w2t[F + f0 + f] += sum;
    w2t[f0 + f] = fmaf(st, sum, w2t[f0 + f]);
  }
};

// Zero this CTA's gradient elements (in shared memory, or its own elements
// of the cluster's partial g).
template <bool kShared>
__device__ inline void zero_grads(int F, int H, SweepSlice sl, int rank,
                                  float* g) {
  if constexpr (kShared) {
    const int n = sweep_slice_floats(F, H);
    for (int i = threadIdx.x; i < n; i += kSweepThreads) sweep_smem[i] = 0.f;
  } else {
    float* const gw1t = g + static_cast<size_t>(F) * H;
    float* const gw2 = gw1t + 2 * H;
    for (int i = threadIdx.x; i < sl.n * H; i += kSweepThreads)
      g[static_cast<size_t>(sl.f0) * H + i] = 0.f;
    for (int i = threadIdx.x; i < (H + 2) * sl.n; i += kSweepThreads) {
      const int h = i / sl.n, f = i - h * sl.n;  // rows H, H + 1: w2t, b2
      gw2[static_cast<size_t>(h) * F + sl.f0 + f] = 0.f;
    }
    if (rank == 0)
      for (int i = threadIdx.x; i < 2 * H; i += kSweepThreads) gw1t[i] = 0.f;
  }
}

// Write this CTA's gradient slices to its cluster's partial g (shared mode
// only; the other mode wrote there all along).
__device__ inline void store_grad_slices(const SweepSmem& s, SweepSlice sl,
                                         int F, int H, int rank, float* g) {
  const float* const sm = sweep_smem;
  float* const gw1 = g;
  float* const gw1t = g + static_cast<size_t>(F) * H;
  float* const gb1 = gw1t + H;
  float* const gw2 = gb1 + H;
  float* const gb2 = gw2 + static_cast<size_t>(H + 1) * F;
  for (int i = threadIdx.x; i < sl.n * H; i += kSweepThreads) {
    const int f = i / H, h = i - f * H;
    gw1[static_cast<size_t>(sl.f0 + f) * H + h] = sm[s.g1 + f * s.ldW + h];
  }
  for (int i = threadIdx.x; i < (H + 1) * sl.n; i += kSweepThreads) {
    const int h = i / sl.n, f = i - h * sl.n;
    gw2[static_cast<size_t>(h) * F + sl.f0 + f] = sm[s.g2 + h * s.ldS + f];
  }
  for (int f = threadIdx.x; f < sl.n; f += kSweepThreads)
    gb2[sl.f0 + f] = sm[s.gb2 + f];
  if (rank == 0) {
    for (int h = threadIdx.x; h < H; h += kSweepThreads) {
      gb1[h] = sm[s.gb1 + h];
      gw1t[h] = sm[s.gw1t + h];
    }
  }
}

__device__ inline float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// ---- the TF32 tier
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
// channel, tanh, the stage combinations, ũ, the error norm) stays FP32.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): not
// the tensor cores but their feed, one scalar load and one cvt an operand
// from shared memory; two chains a warp sharing the A fragment took K8's
// TF32-gradient sweep from 13.6 to 12.6 ms, where its FFMA instantiation
// takes 11.05 (16-byte loads into register tiles of twelve sums).
//
// The product tiers of a transposed step and of the sweeps, as bits of one
// template argument: the stage recompute (k1 and the six stages), the
// cotangent and weight-gradient products, and the two-level window replay.
// A clear bit is FP32 FFMA, a set bit TF32.
constexpr int kTierRecompute = 1, kTierGrad = 2, kTierReplay = 4;

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

// tile_gemm at the TF32 tier, with its operand layouts and its epilogue:
// warp tiles of 16 rows by 16 columns, two mma_tf32 a k-step of 8 (two
// independent chains sharing the A fragment), each output one chain of mma
// over k = 0, 8, 16, ... in that order (the operands past K zero). Both
// operands are rounded to TF32 as their fragments are built, so the FP32
// tiers of the same launch read the same unrounded slices. Reads past an
// edge stay inside the tiles; their outputs are not handed out.
template <bool kAM, bool kBN, typename Epi>
__device__ inline void tile_gemm_tf32(int M, int N, int K, int a, int lda,
                                      int b, int ldb, Epi epi) {
  if (M <= 0 || N <= 0) return;
  const float* const sm = sweep_smem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mt = (M + 15) / 16, nt = (N + 15) / 16;
  for (int tile = warp; tile < mt * nt; tile += kSweepThreads / 32) {
    const int m0 = (tile % mt) * 16, n0 = (tile / mt) * 16;
    const int ma = min(m0 + g, M - 1), mb = min(m0 + g + 8, M - 1);
    const int nb[2] = {min(n0 + g, N - 1), min(n0 + 8 + g, N - 1)};
    auto A = [&](int m, int k) {
      return kAM ? sm[a + k * lda + m] : sm[a + m * lda + k];
    };
    auto Bk = [&](int k, int n) {
      return kBN ? sm[b + k * ldb + n] : sm[b + n * ldb + k];
    };
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 8) {
      const int ka = k0 + q, kb = ka + 4;
      const int ca = min(ka, K - 1), cb = min(kb, K - 1);
      const unsigned af[4] = {ka < K ? tf32_bits(A(ma, ca)) : 0u,
                              ka < K ? tf32_bits(A(mb, ca)) : 0u,
                              kb < K ? tf32_bits(A(ma, cb)) : 0u,
                              kb < K ? tf32_bits(A(mb, cb)) : 0u};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned bf[2] = {ka < K ? tf32_bits(Bk(ca, nb[h])) : 0u,
                                kb < K ? tf32_bits(Bk(cb, nb[h])) : 0u};
        mma_tf32(d[h], af, bf);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nc = n0 + 8 * h + 2 * q;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + g + 8 * r;
        if (m >= M) continue;
        if (nc < N) epi(m, nc, d[h][2 * r]);
        if (nc + 1 < N) epi(m, nc + 1, d[h][2 * r + 1]);
      }
    }
  }
}

// C(m, n) = Σ_k A(m, k)·B(k, n) for m < M, n < N, handed to epi(m, n, c),
// with A and B in sweep_smem at offsets a and b, every leading dimension a
// vec_ld: A(m, k) = [a + k·lda + m] (kAM, contiguous along m) or
// [a + m·lda + k]; B(k, n) = [b + k·ldb + n] (kBN) or [b + n·ldb + k].
// A warp's lanes are 4 row groups (ly) by 8 column groups (lx); a thread
// holds TM × 4 sums: rows m0 + 4·ly + i (kAM, TM = 4) or m0 + ly + 4·i,
// columns n0 + 4·lx + j (kBN) or n0 + lx + 8·j. Operands are float4 reads:
// along m or n where contiguous, else 4 k at a time (the K % 4 tail
// scalar); each read serves 4 or 8 distinct 16-byte chunks, one wavefront.
// One running FP32 sum per output, in k order. Reads past an edge stay in
// the row (or hit the last valid one) and their outputs are not handed
// out. No synchronisation.
template <int TM, bool kAM, bool kBN, typename Epi>
__device__ inline void tile_gemm(int M, int N, int K, int a, int lda, int b,
                                 int ldb, Epi epi) {
  static_assert(!kAM || (TM == 4 && kBN), "contiguous-m A takes 4 x 4 tiles");
  if (M <= 0 || N <= 0) return;
  const float* const sm = sweep_smem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ly = lane >> 3, lx = lane & 7;
  const int mt = (M + 4 * TM - 1) / (4 * TM), nt = (N + 31) / 32;
  for (int tile = warp; tile < mt * nt; tile += kSweepThreads / 32) {
    const int m0 = (tile % mt) * 4 * TM, n0 = (tile / mt) * 32;
    int mrow[TM], ncol[4];
#pragma unroll
    for (int i = 0; i < TM; ++i) mrow[i] = kAM ? m0 + 4 * ly + i : m0 + ly + 4 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) ncol[j] = kBN ? n0 + 4 * lx + j : n0 + lx + 8 * j;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    // the first n of the thread's float4 along n, kept inside the row
    const int nB = min(n0 + 4 * lx, r4(N) - 4);
    if constexpr (kAM) {
      const int mA = min(m0 + 4 * ly, r4(M) - 4);
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(sm + a + k * lda + mA);
        const float4 bv = *reinterpret_cast<const float4*>(sm + b + k * ldb + nB);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(comp(av, i), comp(bv, j), acc[i][j]);
      }
    } else {
      int ao[TM], bo[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) ao[i] = a + min(mrow[i], M - 1) * lda;
#pragma unroll
      for (int j = 0; j < 4; ++j) bo[j] = b + min(ncol[j], N - 1) * ldb;
      const int K4 = K & ~3;
#pragma unroll 2
      for (int k = 0; k < K4; k += 4) {
        float4 av[TM], bv[4];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          av[i] = *reinterpret_cast<const float4*>(sm + ao[i] + k);
        if constexpr (kBN) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            bv[q] = *reinterpret_cast<const float4*>(sm + b + (k + q) * ldb + nB);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = *reinterpret_cast<const float4*>(sm + bo[j] + k);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(comp(av[i], q),
                               kBN ? comp(bv[q], j) : comp(bv[j], q),
                               acc[i][j]);
      }
      for (int k = K4; k < K; ++k) {
        float av[TM], bv[4];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = sm[ao[i] + k];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = kBN ? sm[b + k * ldb + nB + j] : sm[bo[j] + k];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (mrow[i] < M && ncol[j] < N) epi(mrow[i], ncol[j], acc[i][j]);
  }
}

// 32-bit shared::cluster addressing: the address of a word of this CTA's
// shared memory, the same word in CTA `rank` of the cluster, and a store
// there.
__device__ inline unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ inline unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ inline void st_cluster(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(addr), "f"(v) : "memory");
}

// The cluster-wide sum of the CTAs' R × H partials, entry e = m·H + n of
// which CTA e mod C sums. A product's epilogue pushes its partial entry
// into that CTA's inbox (push_partial: a remote store, nothing waits on
// it); cluster_reduce then waits at a cluster barrier, sums the inbox in
// rank order 0, 1, ..., C−1 (a fixed order, whatever the timing), maps
// each sum through epi(e, sum, aux[e]) (aux, when not null, is read before
// the first barrier, its latency hidden behind it; 0 otherwise), stores the
// result at [hb + m·ldW + n] of every CTA of the cluster, and waits at a
// second barrier: on return every CTA holds the whole result at hb. Remote
// accesses are stores only.
struct Inbox {
  unsigned addr;  // shared::cta address of this CTA's inbox
  int off;        // its offset in sweep_smem
  int len;        // entries a CTA sums (sweep_inbox_len)
  int rank;
};

__device__ inline Inbox sweep_inbox(const SweepSmem& s, int H, int rank) {
  return Inbox{smem_addr(sweep_smem + s.zp), s.zp, sweep_inbox_len(H), rank};
}

__device__ inline void push_partial(const Inbox& in, int e, float v) {
  const int owner = e % kSweepCluster, l = e / kSweepCluster;
  st_cluster(map_rank(in.addr + 4u * (in.rank * in.len + l), owner), v);
}

template <typename Epi>
__device__ inline void cluster_reduce(const Inbox& in, int hb, int H, int ldW,
                                      int E, const float* aux, Epi epi) {
  cg::cluster_group cl = cg::this_cluster();
  // the entry of the first pass's thread (in.len ≤ kSweepThreads at the
  // sizes the plan admits; later passes read aux after the barrier)
  const int e0 = static_cast<int>(threadIdx.x) * kSweepCluster + in.rank;
  const float aux0 = aux != nullptr && e0 < E ? aux[e0] : 0.f;
  cl.sync();
  const unsigned ha = smem_addr(sweep_smem + hb);
  const float* const box = sweep_smem + in.off;
  for (int l = threadIdx.x; l < in.len; l += kSweepThreads) {
    const int e = l * kSweepCluster + in.rank;
    if (e >= E) break;
    float sum = box[l];
#pragma unroll
    for (int q = 1; q < kSweepCluster; ++q) sum = __fadd_rn(sum, box[q * in.len + l]);
    const float av = aux == nullptr ? 0.f : e == e0 ? aux0 : aux[e];
    const float out = epi(e, sum, av);
    const unsigned dst = ha + 4u * ((e / H) * ldW + e % H);
#pragma unroll
    for (int q = 0; q < kSweepCluster; ++q) st_cluster(map_rank(dst, q), out);
  }
  cl.sync();
}

// One TD-MLP evaluation of the cluster's rows at time st, from the stage
// input's slice in the tile xa: z (cluster sum), h = tanh(z + b1 + st·w1t)
// into every CTA's hb (and, when hs is not null, into hs: (nrows, H), the
// entries this CTA reduced), then k[:, S_c] = h·W2[:, S_c] + b2 + st·w2t
// into out (row-major, stride F, already offset to the slice); both products
// at the TF32 tier with kTf32. The caller synchronises the CTA after xa is
// written; this returns synchronised.
template <bool kTf32>
__device__ inline void cluster_eval(const SweepSmem& s, const Inbox& in,
                                    SweepSlice sl, int H, int F, int nrows,
                                    float st, float* hs, float* out) {
  float* const sm = sweep_smem;
  const int b1 = s.b1, w1t = s.w1t, b2 = s.b2;
  const int w2t = s.w2 + H * s.ldS;
  auto push = [=](int m, int n, float v) { push_partial(in, m * H + n, v); };
  if constexpr (kTf32) {
    tile_gemm_tf32<false, true>(nrows, H, sl.n, s.xa, s.ldS, s.w1, s.ldW,
                                push);
  } else {
    tile_gemm<3, false, true>(nrows, H, sl.n, s.xa, s.ldS, s.w1, s.ldW, push);
  }
  cluster_reduce(in, s.hb, H, s.ldW, nrows * H, nullptr,
                 [=](int e, float z, float) {
    const int h = e % H;
    const float hv = tanhf(fmaf(st, sm[w1t + h], __fadd_rn(z, sm[b1 + h])));
    if (hs != nullptr) hs[e] = hv;
    return hv;
  });
  auto store = [=](int m, int n, float v) {
    out[static_cast<size_t>(m) * F + n] =
        fmaf(st, sm[w2t + n], __fadd_rn(v, sm[b2 + n]));
  };
  if constexpr (kTf32) {
    tile_gemm_tf32<false, true>(nrows, sl.n, H, s.hb, s.ldW, s.w2, s.ldS,
                                store);
  } else {
    tile_gemm<3, false, true>(nrows, sl.n, H, s.hb, s.ldW, s.w2, s.ldS, store);
  }
  __syncthreads();
}

// ---- the transposed step of one row block (kernels 3, 7 and 8)

// Global scratch of a transposed step: k1..k7 and their cotangents (7
// (B, F) each), d_u and the six stage inputs ((B, F) each), and the six
// stages' hidden rows (6 (B, H)). The sweep's window replay lays its
// working buffers (u, k1..k7, u_new) over the first nine (B, F).
__host__ __device__ inline size_t sweep_scratch_floats(int B, int F, int H) {
  return 21 * static_cast<size_t>(B) * F + 6 * static_cast<size_t>(B) * H;
}

// The attribution phases of one transposed step, timed by CTA 0's thread 0
// on %globaltimer in the instantiation with kTime (chip_smoke.py's
// [sweep attribution] only): the k1 recompute, the six stage recomputes,
// the seeding of the stage cotangents, each reverse stage's dh, dz and dx
// (stage 6 first), the two weight-gradient updates and the carries.
enum SweepPhase {
  kSwK1, kSwStage1, kSwSeed = kSwStage1 + 6, kSwRev,
  kSwDW1 = kSwRev + 18, kSwDW2, kSwCarry, kSwPhases
};

template <bool kOn>
struct SweepClock {
  unsigned long long last = 0, acc[kSwPhases] = {};
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ bool owner() const { return blockIdx.x == 0 && threadIdx.x == 0; }
  __device__ void start() {
    if constexpr (kOn) if (owner()) last = now();
  }
  // the timed instantiation waits for the whole CTA first; the untimed one
  // does nothing
  __device__ void mark(int phase) {
    if constexpr (kOn) {
      __syncthreads();
      if (owner()) {
        const unsigned long long t = now();
        acc[phase] += t - last;
        last = t;
      }
    }
  }
  __device__ void stage(int i) { mark(kSwStage1 + i); }
  __device__ void rev(int i, int part) { mark(kSwRev + 3 * (5 - i) + part); }
  __device__ void grad(int which) { mark(kSwDW1 + which); }
  // per-phase nanoseconds, then the number of steps transposed
  __device__ void write(unsigned long long* out, int steps) const {
    if constexpr (kOn) {
      if (owner()) {
        for (int i = 0; i < kSwPhases; ++i) out[i] = acc[i];
        out[kSwPhases] = static_cast<unsigned long long>(steps);
      }
    }
  }
};

// The time of stage i + 2 (i = 0..5) of a step from t with step dt.
__device__ inline float stage_time(int i, float t, float dt) {
  const float c = i == 0 ? C1 : i == 1 ? C2 : i == 2 ? C3 : C4;
  return i < 4 ? fmaf(c, dt, t) : __fadd_rn(t, dt);
}

// Passes over this CTA's slice of a row block (nrows × Sn elements, at
// rows of stride F in global memory): loads first, then stores, through
// __restrict__ pointers and unrolled, so each thread has several global
// loads in flight. Products and sums are written out (fmaf, __fmul_rn,
// __fadd_rn): the compiler contracts nothing, so the timed instantiation
// computes the same bits.

// tile[r][f] = src[r·F + f]
__device__ inline void load_tile(const float* __restrict__ src, int tile,
                                 int ld, int nrows, int Sn, int F) {
  const int nel = nrows * Sn;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < nel; idx += kSweepThreads) {
    const int r = idx / Sn, f = idx - r * Sn;
    sweep_smem[tile + r * ld + f] = src[static_cast<size_t>(r) * F + f];
  }
}

// dst[r·F + f] = src[r·F + f] on the slice
__device__ inline void copy_slice(const float* __restrict__ src,
                                  float* __restrict__ dst, int nrows, int Sn,
                                  int F) {
  const int nel = nrows * Sn;
  for (int idx = threadIdx.x; idx < nel; idx += kSweepThreads) {
    const size_t o = static_cast<size_t>(idx / Sn) * F + idx % Sn;
    dst[o] = src[o];
  }
}

// The input of stage i + 2: x = u + dt·Σ_{q ≤ i} a_iq·k_q, into the tile
// xa and into xs.
__device__ inline void stage_input_pass(int i, float dt,
                                        const float* __restrict__ u,
                                        const float* __restrict__ ks,
                                        size_t BF, float* __restrict__ xs,
                                        int xa, int ld, int nrows, int Sn,
                                        int F) {
  const int nel = nrows * Sn;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < nel; idx += kSweepThreads) {
    const int r = idx / Sn, f = idx - r * Sn;
    const size_t o = static_cast<size_t>(r) * F + f;
    float kv[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) kv[q] = q <= i ? ks[q * BF + o] : 0.f;
    const float uv = u[o];
    float acc = __fmul_rn(kA[i][0], kv[0]);
#pragma unroll
    for (int q = 1; q < 6; ++q)
      if (q <= i) acc = fmaf(kA[i][q], kv[q], acc);
    const float v = fmaf(dt, acc, uv);
    sweep_smem[xa + r * ld + f] = v;
    xs[o] = v;
  }
}

// The seed of a transposed step: what its caller (kernels 7 and 8:
// adjoint_sweep.cu::SweepSeed; kernel 3: tsit5_step_bwd.cu::StepSeed)
// injects, at element o of the CTA's corner of the row block (a (B, F)
// offset), provides
//   float k7(o)                   the cotangent on k7;
//   void ks(o, float (&dk)[6])    the cotangents on k1..k6;
//   float x(i, o, dx)             dx plus the direct cotangent on stage
//                                 input i (i = 5 is u_new, i = 4 is g6);
//   void finish(o, du, dk1)       the step's results: the cotangents on u
//                                 and k1.

// The cotangent dx of stage input i (in the tile xa) with its seed flows to
// u (du) and to the k_q it was built from. At i = 5 the cotangents on
// k1..k6 start from their seeds, computed here rather than stored and read
// back.
template <typename Seed>
__device__ inline void dx_pass(int i, float dt, int xa, int ld,
                               const Seed& seed, float* __restrict__ du,
                               float* __restrict__ dks, size_t BF, int nrows,
                               int Sn, int F) {
  const int nel = nrows * Sn;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < nel; idx += kSweepThreads) {
    const int r = idx / Sn, f = idx - r * Sn;
    const size_t o = static_cast<size_t>(r) * F + f;
    float dk[6];
    if (i == 5) {
      seed.ks(o, dk);
    } else {
#pragma unroll
      for (int q = 0; q < 6; ++q) dk[q] = q <= i ? dks[q * BF + o] : 0.f;
    }
    const float prev = i == 5 ? 0.f : du[o];
    const float dx = seed.x(i, o, sweep_smem[xa + r * ld + f]);
    du[o] = i == 5 ? dx : __fadd_rn(prev, dx);
#pragma unroll
    for (int q = 0; q < 6; ++q)
      if (q <= i) dks[q * BF + o] = fmaf(__fmul_rn(dt, kA[i][q]), dx, dk[q]);
  }
}

// The cotangent on k7 into the tile ka.
template <typename Seed>
__device__ inline void seed_k7_pass(const Seed& seed, int ka, int ld,
                                    int nrows, int Sn, int F) {
  const int nel = nrows * Sn;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < nel; idx += kSweepThreads) {
    const int r = idx / Sn, f = idx - r * Sn;
    sweep_smem[ka + r * ld + f] = seed.k7(static_cast<size_t>(r) * F + f);
  }
}

// seed.finish with the step's cotangents on u and k1
template <typename Seed>
__device__ inline void finish_pass(const Seed& seed,
                                   const float* __restrict__ du,
                                   const float* __restrict__ dk1, int nrows,
                                   int Sn, int F) {
  const int nel = nrows * Sn;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < nel; idx += kSweepThreads) {
    const int r = idx / Sn, f = idx - r * Sn;
    const size_t o = static_cast<size_t>(r) * F + f;
    seed.finish(o, du[o], dk1[o]);
  }
}

// The transpose of one Tsit5 step from (u, t) with step dt for this
// cluster's row block (row0, nrows) and this CTA's slice, started from the
// seed's cotangents (see above), with its weight gradient added into gs.
// u, k1 and the seed are offset to the CTA's corner (row0, f0) of a (B, F)
// array; k1 null recomputes k1 from u (the sweep's knots), otherwise it is
// copied into the scratch (sweep_scratch_floats). kTiers: the recompute's
// and the reverse's product tiers (kTierRecompute, kTierGrad).
template <bool kTime, bool kShared, int kTiers, typename Seed>
__device__ void transpose_rows(const TDMLP& w, const SweepSmem& s,
                               SweepSlice sl, const GradSink<kShared>& gs,
                               int rank, int B, int row0, int nrows, float t,
                               float dt, const float* u, const float* k1,
                               float* scratch, const Seed& seed,
                               SweepClock<kTime>& clk) {
  const int F = w.F, H = w.H, tid = threadIdx.x;
  const int ldS = s.ldS, ldW = s.ldW, Sn = sl.n;
  const int xa = s.xa, ka = s.ka, zp = s.zp, hb = s.hb;
  const Inbox in = sweep_inbox(s, H, rank);
  float* const sm = sweep_smem;
  const size_t BF = static_cast<size_t>(B) * F;
  const size_t BH = static_cast<size_t>(B) * H;
  // this CTA's corner (row0, f0) of a (B, F) array
  constexpr bool kRec = (kTiers & kTierRecompute) != 0;
  constexpr bool kGrad = (kTiers & kTierGrad) != 0;
  const size_t off = static_cast<size_t>(row0) * F + sl.f0;
  float* const ks = scratch + off;             // k1..k7: 7 (B, F)
  float* const dks = scratch + 7 * BF + off;   // cotangents on k1..k7
  float* const du = scratch + 14 * BF + off;   // (B, F)
  float* const xs = scratch + 15 * BF + off;   // stage inputs: 6 (B, F)
  float* const hs = scratch + 21 * BF + static_cast<size_t>(row0) * H;
  if (k1 == nullptr) {
    // k1 of the step, recomputed from its knot
    load_tile(u, xa, ldS, nrows, Sn, F);
    __syncthreads();
    cluster_eval<kRec>(s, in, sl, H, F, nrows, t, nullptr, ks);
  } else {
    copy_slice(k1, ks, nrows, Sn, F);
    __syncthreads();
  }
  clk.mark(kSwK1);
  // the six stages, keeping x_i (global) and h_i (global, per cluster)
  for (int i = 0; i < 6; ++i) {
    stage_input_pass(i, dt, u, ks, BF, xs + i * BF, xa, ldS, nrows, Sn, F);
    __syncthreads();
    cluster_eval<kRec>(s, in, sl, H, F, nrows, stage_time(i, t, dt),
                       hs + i * BH, ks + (i + 1) * BF);
    clk.stage(i);
  }
  // (the seeds of the stage cotangents enter at stage 6 below)
  clk.mark(kSwSeed);
  // ---- reverse pass through the stage chain
  for (int i = 5; i >= 0; --i) {
    const float st = stage_time(i, t, dt);
    // dh = dk·W2ᵀ: this slice's partial, pushed to the summing CTAs
    if (i == 5) {
      seed_k7_pass(seed, ka, ldS, nrows, Sn, F);
    } else {
      load_tile(dks + (i + 1) * BF, ka, ldS, nrows, Sn, F);
    }
    __syncthreads();
    auto push = [=](int m, int n, float v) { push_partial(in, m * H + n, v); };
    if constexpr (kGrad) {
      tile_gemm_tf32<false, false>(nrows, H, Sn, ka, ldS, s.w2, ldS, push);
    } else {
      tile_gemm<3, false, false>(nrows, H, Sn, ka, ldS, s.w2, ldS, push);
    }
    clk.rev(i, 0);
    // dz = dh·(1 − h²), from the h_i this CTA reduced in the recompute
    const float* const hsi = hs + i * BH;
    cluster_reduce(in, hb, H, ldW, nrows * H, hsi,
                   [=](int e, float d, float hv) {
                     return __fmul_rn(d, fmaf(-hv, hv, 1.f));
                   });
    clk.rev(i, 1);
    // dx = dz·W1ᵀ on the slice, into xa; then its flow to u and k
    auto put_dx = [=](int m, int n, float v) { sm[xa + m * ldS + n] = v; };
    if constexpr (kGrad) {
      tile_gemm_tf32<false, false>(nrows, Sn, H, hb, ldW, s.w1, ldW, put_dx);
    } else {
      tile_gemm<3, false, false>(nrows, Sn, H, hb, ldW, s.w1, ldW, put_dx);
    }
    __syncthreads();
    dx_pass(i, dt, xa, ldS, seed, du, dks, BF, nrows, Sn, F);
    __syncthreads();
    // x_i of the slice for dW1, and h_i of the cluster's rows for dW2
    // in the inbox (free until the cluster barrier that ends the stage)
    load_tile(xs + i * BF, xa, ldS, nrows, Sn, F);
    load_tile(hsi, zp, ldW, nrows, H, H);
    __syncthreads();
    clk.rev(i, 2);
    // dW1[S_c, :] += x_iᵀ·dz_i; rank 0: db1 and dw1t
    auto add_w1 = [=](int m, int n, float v) { gs.w1(m, n, v); };
    if constexpr (kGrad) {
      tile_gemm_tf32<true, true>(Sn, H, nrows, xa, ldS, hb, ldW, add_w1);
    } else {
      tile_gemm<4, true, true>(Sn, H, nrows, xa, ldS, hb, ldW, add_w1);
    }
    if (rank == 0) {
      for (int h = tid; h < H; h += kSweepThreads) {
        float sum = 0.f;
        for (int r = 0; r < nrows; ++r) sum += sm[hb + r * ldW + h];
        gs.b1(h, sum, st);
      }
    }
    clk.grad(0);
    // dW2[:, S_c] += h_iᵀ·dk_i, with its time row and db2
    auto add_w2 = [=](int m, int n, float v) { gs.w2(m, n, v); };
    if constexpr (kGrad) {
      tile_gemm_tf32<true, true>(H, Sn, nrows, zp, ldW, ka, ldS, add_w2);
    } else {
      tile_gemm<4, true, true>(H, Sn, nrows, zp, ldW, ka, ldS, add_w2);
    }
    for (int f = tid; f < Sn; f += kSweepThreads) {
      float sum = 0.f;
      for (int r = 0; r < nrows; ++r) sum += sm[ka + r * ldS + f];
      gs.b2(f, sum, st);
    }
    // no CTA pushes into this inbox before every CTA is done with h_i
    cg::this_cluster().sync();
    clk.grad(1);
  }
  finish_pass(seed, du, dks, nrows, Sn, F);
  __syncthreads();
  clk.mark(kSwCarry);
}

// ---- the window replay at the sweep's thread count
//
// The two-level mode replays a window with the forward kernel's attempt
// (solve.cuh::replay_window), which must repeat the forward's accept and dt
// sequence bitwise. tdmlp.cuh's TD-MLP runs it at 1,024 threads; the
// sweep's CTAs have 512. TDMLPSweep is the same dynamics at 512 threads:
// its evaluation (sweep_eval_rows) computes every item of tdmlp_rows with
// the same operations in the same order, only more items a thread, and its
// step (the tsit5_rows overload below) keeps two error accumulators a
// thread, those of threads t and t + 512 of the forward, and sums them in
// block_sum<1024>'s tree. So the replay's error norm, accepts and states
// are bitwise the forward's (chip_smoke.py's "K8 replay" digest).
struct TDMLPSweep {
  static constexpr int rows = kRows;
  static constexpr int threads = kSweepThreads;
  using Shared = Smem;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  int F;
  int H;
};
static_assert(kThreads == 2 * kSweepThreads,
              "the replay's error sum emulates two forward threads a thread");

// tdmlp.cuh::tdmlp_rows at kSweepThreads threads (each item's arithmetic
// unchanged).
__device__ inline void eval_rows(const TDMLPSweep& w, const Smem& sm, float s,
                                 float* out, int nrows) {
  const int F = w.F, H = w.H;
  for (int item = threadIdx.x; item < H * kSplit; item += kSweepThreads) {
    const int h = item % H, q = item / H;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = q; k < F; k += kSplit) {
      const float wv = __ldg(w.w1 + static_cast<size_t>(k) * H + h);
      const float4 x0 = *reinterpret_cast<const float4*>(sm.xs + k * kRows);
      const float4 x1 = *reinterpret_cast<const float4*>(sm.xs + k * kRows + 4);
      acc[0] = fmaf(x0.x, wv, acc[0]);
      acc[1] = fmaf(x0.y, wv, acc[1]);
      acc[2] = fmaf(x0.z, wv, acc[2]);
      acc[3] = fmaf(x0.w, wv, acc[3]);
      acc[4] = fmaf(x1.x, wv, acc[4]);
      acc[5] = fmaf(x1.y, wv, acc[5]);
      acc[6] = fmaf(x1.z, wv, acc[6]);
      acc[7] = fmaf(x1.w, wv, acc[7]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) sm.part[(q * H + h) * kRows + r] = acc[r];
  }
  __syncthreads();
  const float* w1t = w.w1 + static_cast<size_t>(F) * H;
  for (int i = threadIdx.x; i < H * kRows; i += kSweepThreads) {
    const int h = i / kRows, r = i - h * kRows;
    float z = 0.f;
    for (int q = 0; q < kSplit; ++q) z += sm.part[(q * H + h) * kRows + r];
    z = z + __ldg(w.b1 + h) + s * __ldg(w1t + h);
    sm.hid[h * kRows + r] = tanhf(z);
  }
  __syncthreads();
  const float* w2t = w.w2 + static_cast<size_t>(H) * F;
  for (int j = threadIdx.x; j < F; j += kSweepThreads) {
    float acc[kAcc2][kRows];
#pragma unroll
    for (int a = 0; a < kAcc2; ++a)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[a][r] = 0.f;
    for (int h0 = 0; h0 < H; h0 += kAcc2) {
#pragma unroll
      for (int a = 0; a < kAcc2; ++a) {
        const int h = h0 + a;
        if (h < H) {
          const float wv = __ldg(w.w2 + static_cast<size_t>(h) * F + j);
          const float4 h0v = *reinterpret_cast<const float4*>(sm.hid + h * kRows);
          const float4 h1v = *reinterpret_cast<const float4*>(sm.hid + h * kRows + 4);
          acc[a][0] = fmaf(h0v.x, wv, acc[a][0]);
          acc[a][1] = fmaf(h0v.y, wv, acc[a][1]);
          acc[a][2] = fmaf(h0v.z, wv, acc[a][2]);
          acc[a][3] = fmaf(h0v.w, wv, acc[a][3]);
          acc[a][4] = fmaf(h1v.x, wv, acc[a][4]);
          acc[a][5] = fmaf(h1v.y, wv, acc[a][5]);
          acc[a][6] = fmaf(h1v.z, wv, acc[a][6]);
          acc[a][7] = fmaf(h1v.w, wv, acc[a][7]);
        }
      }
    }
    const float bias = __ldg(w.b2 + j), tw = __ldg(w2t + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float y = (acc[0][r] + acc[1][r]) + (acc[2][r] + acc[3][r]);
      if (r < nrows) out[static_cast<size_t>(r) * F + j] = y + bias + s * tw;
    }
  }
}

// tdmlp.cuh::tsit5_rows for TDMLPSweep: the same stages, and the error sum
// of the forward's 1,024 threads (see above).
__device__ inline float tsit5_rows(const TDMLPSweep& w, const Smem& sm,
                                   const StepRows& p, float t, float dt,
                                   int nrows, bool want_err, float atol,
                                   float rtol) {
  using D = TDMLPSweep;
  const int F = w.F;
  const float* k[7] = {p.k[0], p.k[1], p.k[2], p.k[3], p.k[4], p.k[5], p.k[6]};
  {
    const float a[1] = {A21};
    stage_input<D>(sm.xs, p.u, k, a, dt, F, nrows, nullptr);
  }
  __syncthreads();
  eval_rows(w, sm, t + C1 * dt, p.k[1], nrows);
  __syncthreads();
  {
    const float a[2] = {A31, A32};
    stage_input<D>(sm.xs, p.u, k, a, dt, F, nrows, nullptr);
  }
  __syncthreads();
  eval_rows(w, sm, t + C2 * dt, p.k[2], nrows);
  __syncthreads();
  {
    const float a[3] = {A41, A42, A43};
    stage_input<D>(sm.xs, p.u, k, a, dt, F, nrows, nullptr);
  }
  __syncthreads();
  eval_rows(w, sm, t + C3 * dt, p.k[3], nrows);
  __syncthreads();
  {
    const float a[4] = {A51, A52, A53, A54};
    stage_input<D>(sm.xs, p.u, k, a, dt, F, nrows, nullptr);
  }
  __syncthreads();
  eval_rows(w, sm, t + C4 * dt, p.k[4], nrows);
  __syncthreads();
  {
    const float a[5] = {A61, A62, A63, A64, A65};
    stage_input<D>(sm.xs, p.u, k, a, dt, F, nrows, p.g6);
  }
  __syncthreads();
  eval_rows(w, sm, t + dt, p.k[5], nrows);
  __syncthreads();
  {
    const float a[6] = {A71, A72, A73, A74, A75, A76};
    stage_input<D>(sm.xs, p.u, k, a, dt, F, nrows, p.unew);
  }
  __syncthreads();
  eval_rows(w, sm, t + dt, p.k[6], nrows);
  __syncthreads();
  // the forward's threads t and t + kSweepThreads, one accumulator each
  float err[2] = {0.f, 0.f};
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    for (int i = threadIdx.x + v * kSweepThreads; i < nrows * F; i += kThreads) {
      float acc = BT1 * k[0][i];
      acc = acc + BT2 * k[1][i];
      acc = acc + BT3 * k[2][i];
      acc = acc + BT4 * k[3][i];
      acc = acc + BT5 * k[4][i];
      acc = acc + BT6 * k[5][i];
      acc = acc + BT7 * k[6][i];
      const float ut = dt * acc;
      if (p.utilde != nullptr) p.utilde[i] = ut;
      if (want_err) {
        const float res =
            ut / (atol + fmaxf(fabsf(p.u[i]), fabsf(p.unew[i])) * rtol);
        err[v] = fmaf(res, res, err[v]);
      }
    }
  }
  if (!want_err) return 0.f;
  // block_sum<kThreads>'s tree over the 2 · kSweepThreads accumulators
  float* const red = sm.red;
  red[threadIdx.x] = err[0];
  red[threadIdx.x + kSweepThreads] = err[1];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

}  // namespace lrnde
