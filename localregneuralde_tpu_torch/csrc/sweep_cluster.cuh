// The transposed Tsit5 step of the TD-MLP on a thread-block cluster: the
// step transpose of kernels 7 and 8 (adjoint_sweep.cu).
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
// their operands float4 reads of shared memory. The weight gradients
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
// into out (row-major, stride F, already offset to the slice). The caller
// synchronises the CTA after xa is written; this returns synchronised.
__device__ inline void cluster_eval(const SweepSmem& s, const Inbox& in,
                                    SweepSlice sl, int H, int F, int nrows,
                                    float st, float* hs, float* out) {
  float* const sm = sweep_smem;
  const int b1 = s.b1, w1t = s.w1t, b2 = s.b2;
  const int w2t = s.w2 + H * s.ldS;
  tile_gemm<3, false, true>(nrows, H, sl.n, s.xa, s.ldS, s.w1, s.ldW,
                            [=](int m, int n, float v) {
                              push_partial(in, m * H + n, v);
                            });
  cluster_reduce(in, s.hb, H, s.ldW, nrows * H, nullptr,
                 [=](int e, float z, float) {
    const int h = e % H;
    const float hv = tanhf(fmaf(st, sm[w1t + h], __fadd_rn(z, sm[b1 + h])));
    if (hs != nullptr) hs[e] = hv;
    return hv;
  });
  tile_gemm<3, false, true>(nrows, sl.n, H, s.hb, s.ldW, s.w2, s.ldS,
                            [=](int m, int n, float v) {
                              out[static_cast<size_t>(m) * F + n] =
                                  fmaf(st, sm[w2t + n], __fadd_rn(v, sm[b2 + n]));
                            });
  __syncthreads();
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
