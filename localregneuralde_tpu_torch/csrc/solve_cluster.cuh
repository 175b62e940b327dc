// Kernel 4's cluster layout and its one evaluation of the TD-MLP, shared by
// the three TD-MLP forward kernels that run on it: the whole solve (kernel
// 4, persistent_solve.cu), one evaluation (kernel 1) and one Tsit5 step
// (kernel 2, both tdmlp_cluster.cu).
//
// Layout. A cluster of kSweepCluster = 8 CTAs owns a block of R batch rows.
// CTA c of the cluster owns the features k ≡ c (mod 8) and keeps in shared
// memory, loaded once per launch, W1's rows and W2's columns of those
// features, b2 and w2t on them, and all of b1 and w1t. Its features sit in
// a segment of its own in every state buffer (solve_seg), the even-numbered
// ones (k ≡ c mod 16) first, then the odd ones (k ≡ c + 8 mod 16), so the
// state, the stage derivatives and the stage inputs never cross the
// cluster, and a CTA's loads are contiguous.
//
// The evaluation (solve_eval) is bitwise the first port's one-CTA-per-8-
// rows kernel (tdmlp.cuh's TD-MLP at 1,024 threads):
//  - first product: hidden unit h of a row was summed as 16 partials, the
//    k ≡ q (mod 16) terms in increasing k, added in q order 0..15, then b1
//    and s·w1t. CTA c holds exactly the partials q = c and q = c + 8 (its
//    even and odd features): it sums both over its rows and pushes them
//    through DSMEM into the inbox of the owner CTA of their group of four
//    units (g mod 8 for group g = row·ceil(H / 4) + h / 4), which adds the
//    16 in q order, applies the epilogue and tanh, and stores the hidden
//    units into every CTA of the cluster (hidden_reduce). Remote accesses
//    are 16-byte stores only; a CTA pushes into an inbox only after the
//    cluster barrier that follows its last read.
//  - second product: each output of the CTA's features is summed over H in
//    four interleaved accumulators, h ≡ a (mod 4), added (a0 + a1) +
//    (a2 + a3), then b2, then s·w2t rounded on its own (the old kernel
//    computed that product once for its eight rows, so nothing contracted
//    it; the hidden epilogue's s·w1t it did contract: fmaf).
//  - the stage inputs (solve_stage_input) are elementwise, written with the
//    old kernel's expression, and the six stages of an attempt are one
//    function (solve_stages) that kernels 4 and 2 both call.
// Each output is one thread's sum in that order, whichever rows a cluster
// holds, so the row count of a cluster does not change a bit. Every
// product is true FP32 FFMA (at the mlp.yaml tolerance ũ is f32 rounding
// noise). A TD-MLP whose weight slices do not fit beside the work tiles
// reads them from global memory in the same order (kShared false).
//
// The TF32 tier (kTf32; the reference's 'default' precision, which 'auto'
// takes at rtol ≥ 1e-4, sweep_cluster.cuh): the same layout, reductions and
// epilogues, the two products on the tensor cores (slice_gemm_tf32). The
// weight slices are rounded to TF32 once as they are loaded (from global
// memory, as they are read), the stage inputs and hidden rows as fragments
// are built. Each output is one chain of mma.sync over k = 0, 8, 16, ... of
// its partial (a new order on purpose, the same whichever rows a cluster
// holds), so kernels 1, 2 and 4 and kernel 8's TF32 replay agree bitwise.
#pragma once

#include "solve.cuh"
#include "sweep_cluster.cuh"

namespace lrnde {

constexpr int kSolveThreads = kSweepThreads;  // 512: 128 registers a thread
constexpr int kSolveRowsMax = 40;
constexpr int kSolveParts = 2 * kSweepCluster;  // partials of a hidden unit
static_assert(kSolveParts == kSplit,
              "the residue split reproduces tdmlp_rows' 16 partials");
static_assert(kThreads == 2 * kSolveThreads,
              "the error sum emulates two of the old threads a thread");
static_assert(kSolveRowsMax % kRows == 0 && kSolveRowsMax <= 8 * kRows,
              "error blocks lie in one cluster, one a CTA");

// ---- the layout

// Features of rank c: k = 8m + c, m < solve_count(F, c); the even m first.
__host__ __device__ inline int solve_count(int F, int c) {
  return F > c ? (F - c + kSweepCluster - 1) / kSweepCluster : 0;
}

// Offset of the odd features in a segment, and the segment's width: each
// part a multiple of 4 floats (float4 reads along k).
__host__ __device__ inline int solve_odd0(int F) {
  return r4((solve_count(F, 0) + 1) / 2);
}

__host__ __device__ inline int solve_seg(int F) {
  return solve_odd0(F) + r4(solve_count(F, 0) / 2);
}

// Groups of 4 consecutive hidden units of a row block's R × H hidden sum
// (group g = row·ceil(H / 4) + h / 4) that each CTA adds up: group g
// belongs to CTA g mod 8, so every push and broadcast is one 16-byte store.
__host__ __device__ inline int solve_inbox_len(int R, int H) {
  return (R * ((H + 3) / 4) + kSweepCluster - 1) / kSweepCluster;
}

// Floats of the weight slices: W1's rows [seg][ldW], W2's columns
// [H][ldX].
__host__ __device__ inline size_t solve_weight_floats(int F, int H) {
  const int seg = solve_seg(F);
  return static_cast<size_t>(seg) * vec_ld(H) +
         static_cast<size_t>(H) * vec_ld(seg);
}

// Floats of the vectors (b1, w1t; b2, w2t on the slice) and the tiles of
// one evaluation at R rows: the stage input [R][ldX], the hidden row
// [R][ldW] and the inbox [16][len][4].
__host__ __device__ inline size_t eval_tile_floats(int F, int H, int R) {
  const int seg = solve_seg(F);
  return 2 * static_cast<size_t>(r4(H)) + 2 * seg +
         static_cast<size_t>(R) * vec_ld(seg) +
         static_cast<size_t>(R) * vec_ld(H) +
         static_cast<size_t>(kSolveParts) * 4 * solve_inbox_len(R, H);
}

// The solve's tiles: those of an evaluation, then the residual tile
// [8 rows][8 ranks][seg] and the error tree [512].
__host__ __device__ inline size_t solve_tile_floats(int F, int H, int R) {
  return eval_tile_floats(F, H, R) +
         static_cast<size_t>(kRows) * kSweepCluster * solve_seg(F) +
         kSolveThreads;
}

// Dynamic shared memory a CTA may have: 227 KB less the static shared
// memory (the controller and the slot-sum buffer: under 2.5 KB).
constexpr size_t kSolveSmemLimit = kSweepSmemLimit;

// The plan at (F, H): the rows of a cluster and whether the weight slices
// stay in shared memory. False when not even 8 rows fit.
__host__ __device__ inline bool solve_plan(int F, int H, int* rows,
                                           bool* shared) {
  if (solve_weight_floats(F, H) + solve_tile_floats(F, H, kSolveRowsMax) <=
      kSolveSmemLimit) {
    *rows = kSolveRowsMax;
    *shared = true;
    return true;
  }
  *shared = false;
  for (int R = kSolveRowsMax; R >= kRows; R -= kRows) {
    if (solve_tile_floats(F, H, R) <= kSolveSmemLimit) {
      *rows = R;
      return true;
    }
  }
  return false;
}

__host__ __device__ inline size_t solve_smem_floats(int F, int H, int R,
                                                    bool shared) {
  return (shared ? solve_weight_floats(F, H) : 0) + solve_tile_floats(F, H, R);
}

// The plan of the kernels without an error norm (kernels 1 and 2,
// tdmlp_cluster.cu) at (F, H): the most rows of a cluster and whether the
// weight slices stay in shared memory. A row block need not hold whole
// 8-row error blocks, so any count of rows from 1 will do, and the tiles
// are only an evaluation's. False when not even one row fits.
__host__ __device__ inline bool eval_plan(int F, int H, int* rows,
                                          bool* shared) {
  if (solve_weight_floats(F, H) + eval_tile_floats(F, H, kSolveRowsMax) <=
      kSolveSmemLimit) {
    *rows = kSolveRowsMax;
    *shared = true;
    return true;
  }
  *shared = false;
  for (int R = kSolveRowsMax; R >= 1; --R) {
    if (eval_tile_floats(F, H, R) <= kSolveSmemLimit) {
      *rows = R;
      return true;
    }
  }
  return false;
}

__host__ __device__ inline size_t eval_smem_floats(int F, int H, int R,
                                                   bool shared) {
  return (shared ? solve_weight_floats(F, H) : 0) + eval_tile_floats(F, H, R);
}

// Global scratch: u, u_new and k1..k7 in the segment layout, B rows of
// 8 segments each.
__host__ __device__ inline size_t solve_scratch_floats(int B, int F) {
  return 9 * static_cast<size_t>(B) * kSweepCluster * solve_seg(F);
}

// Offsets (floats) of a CTA's buffers in the dynamic shared memory (rt and
// red, the error tiles, exist only in the solve's).
struct SolveSmem {
  int seg, odd0, ldW, ldX, len;
  int w1, w2;              // weight slices (kShared)
  int b1, w1t, b2, w2t;    // vectors
  int xa, hb, inbox, rt, red;
};

__device__ inline SolveSmem carve_solve_smem(int F, int H, int R,
                                             bool shared) {
  SolveSmem s;
  s.seg = solve_seg(F);
  s.odd0 = solve_odd0(F);
  s.ldW = vec_ld(H);
  s.ldX = vec_ld(s.seg);
  s.len = solve_inbox_len(R, H);
  s.w1 = 0;
  s.w2 = s.w1 + (shared ? s.seg * s.ldW : 0);
  s.b1 = s.w2 + (shared ? H * s.ldX : 0);
  s.w1t = s.b1 + r4(H);
  s.b2 = s.w1t + r4(H);
  s.w2t = s.b2 + s.seg;
  s.xa = s.w2t + s.seg;
  s.hb = s.xa + R * s.ldX;
  s.inbox = s.hb + R * s.ldW;
  s.rt = s.inbox + kSolveParts * 4 * s.len;
  s.red = s.rt + kRows * kSweepCluster * s.seg;
  return s;
}

// This CTA's features: local index l is valid when l < ne or odd0 ≤ l <
// odd0 + no; each pass runs over j < ne + no (solve_local).
struct SolveSlice {
  int c, ne, no, odd0;
};

__device__ inline int solve_local(const SolveSlice& sl, int j) {
  return j < sl.ne ? j : sl.odd0 + (j - sl.ne);
}

__device__ inline int slice_feature(const SolveSlice& sl, int l) {
  return l < sl.odd0 ? 16 * l + sl.c : 16 * (l - sl.odd0) + 8 + sl.c;
}

// The elementwise passes take four segment positions a thread (float4
// loads and stores): group i of a row block, n_g4 groups a row, the first
// n_e4 over the even features, the rest over the odd ones. Returns the
// group's offset (row · rs + local index); positions between or past the
// features fall in the buffers' padding and are never read as state.
__device__ inline size_t solve_group(const SolveSmem& s, const SolveSlice& sl,
                                     int i, int n_e4, int n_g4, size_t rs) {
  const int r = i / n_g4, g = i - r * n_g4;
  return r * rs + (g < n_e4 ? 4 * g : s.odd0 + 4 * (g - n_e4));
}

// A weight as its slice keeps it: rounded to TF32 at that tier.
template <bool kTf32>
__device__ __forceinline__ float slice_weight(float v) {
  if constexpr (kTf32) return to_tf32(v);
  return v;
}

// Load the weight slices (kShared) and the vectors, each CTA its own
// (kernel 4, once a solve).
template <bool kShared, bool kTf32 = false>
__device__ inline void load_solve_weights(const TDMLP& w, const SolveSmem& s,
                                          const SolveSlice& sl) {
  const int F = w.F, H = w.H, n = sl.ne + sl.no;
  float* const sm = sweep_smem;
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < n * H; i += kSolveThreads) {
      const int l = solve_local(sl, i / H), h = i % H;
      sm[s.w1 + l * s.ldW + h] = slice_weight<kTf32>(
          w.w1[static_cast<size_t>(slice_feature(sl, l)) * H + h]);
    }
    for (int i = threadIdx.x; i < H * n; i += kSolveThreads) {
      const int h = i / n, l = solve_local(sl, i % n);
      sm[s.w2 + h * s.ldX + l] = slice_weight<kTf32>(
          w.w2[static_cast<size_t>(h) * F + slice_feature(sl, l)]);
    }
  }
  for (int h = threadIdx.x; h < H; h += kSolveThreads) {
    sm[s.b1 + h] = w.b1[h];
    sm[s.w1t + h] = w.w1[static_cast<size_t>(F) * H + h];
  }
  for (int j = threadIdx.x; j < n; j += kSolveThreads) {
    const int l = solve_local(sl, j), f = slice_feature(sl, l);
    sm[s.b2 + l] = w.b2[f];
    sm[s.w2t + l] = w.w2[static_cast<size_t>(H) * F + f];
  }
}

// Kernels 1 and 2 load the weights at every launch: W1's rows of this
// CTA's features (each contiguous in global memory) and the vectors as
// asynchronous copies (cp.async), all in flight at once, 16 bytes a copy
// where the rows allow it; W2's columns through the cluster
// (load_eval_weights).
__device__ inline void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ inline void copy_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// Waits for this thread's asynchronous copies; a barrier then shows them to
// the CTA.
__device__ inline void copy_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// W1's rows [seg][ldW] (kShared), b1 and w1t, and b2 and w2t on this CTA's
// features, as asynchronous copies.
template <bool kShared>
__device__ inline void copy_w1_and_vectors(const TDMLP& w, const SolveSmem& s,
                                           const SolveSlice& sl) {
  const int F = w.F, H = w.H, n = sl.ne + sl.no;
  float* const sm = sweep_smem;
  if constexpr (kShared) {
    const int q = (H % 4 == 0 && reinterpret_cast<size_t>(w.w1) % 16 == 0)
                      ? 4 : 1;
    const int Hq = H / q;
    for (int i = threadIdx.x; i < n * Hq; i += kSolveThreads) {
      const int l = solve_local(sl, i / Hq), h = q * (i % Hq);
      float* const dst = sm + s.w1 + l * s.ldW + h;
      const float* const src =
          w.w1 + static_cast<size_t>(slice_feature(sl, l)) * H + h;
      if (q == 4) copy_async16(dst, src);
      else copy_async4(dst, src);
    }
  }
  for (int h = threadIdx.x; h < H; h += kSolveThreads) {
    copy_async4(sm + s.b1 + h, w.b1 + h);
    copy_async4(sm + s.w1t + h, w.w1 + static_cast<size_t>(F) * H + h);
  }
  for (int j = threadIdx.x; j < n; j += kSolveThreads) {
    const int l = solve_local(sl, j), f = slice_feature(sl, l);
    copy_async4(sm + s.b2 + l, w.b2 + f);
    copy_async4(sm + s.w2t + l, w.w2 + static_cast<size_t>(H) * F + f);
  }
}

// ---- the products

// B(k, n0 .. n0 + 3) of a product, from shared memory ([b + k·ld + n]) or
// from the weights in global memory: W1's row of this CTA's feature k0 + k
// (first product), or W2's row k at this CTA's features n0.. (second).
// tf32(k, n) is B(k, n) as a TF32 operand (slice_gemm_tf32; n < N): the
// slices in shared memory hold it already, the weights in global memory are
// rounded as they are read.
struct SharedB {
  int b, ld;
  __device__ float4 operator()(int k, int n0, int) const {
    return *reinterpret_cast<const float4*>(sweep_smem + b + k * ld + n0);
  }
  __device__ unsigned tf32(int k, int n) const {
    return __float_as_uint(sweep_smem[b + k * ld + n]);
  }
};

struct GlobalW1 {
  const float* w1;
  int H, c, k0;  // k0: 0 for the even features, odd0 for the odd ones
  int odd0;
  __device__ const float* row(int k) const {
    const int l = k0 + k;
    const int f = l < odd0 ? 16 * l + c : 16 * (l - odd0) + 8 + c;
    return w1 + static_cast<size_t>(f) * H;
  }
  __device__ float4 operator()(int k, int n0, int N) const {
    const float* const r = row(k);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(r + min(n0 + j, N - 1));
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ unsigned tf32(int k, int n) const {
    return tf32_bits(__ldg(row(k) + n));
  }
};

struct GlobalW2 {
  const float* w2;
  SolveSlice sl;
  int F;
  __device__ bool valid(int l) const {
    return l < sl.ne || (l >= sl.odd0 && l < sl.odd0 + sl.no);
  }
  __device__ float4 operator()(int k, int n0, int) const {
    const float* row = w2 + static_cast<size_t>(k) * F;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = n0 + j;
      v[j] = valid(l) ? __ldg(row + slice_feature(sl, l)) : 0.f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ unsigned tf32(int k, int n) const {
    return valid(n) ? tf32_bits(__ldg(w2 + static_cast<size_t>(k) * F +
                                      slice_feature(sl, n)))
                    : 0u;
  }
};

// C(m, n) = Σ_k A(m, k)·B(k, n) for m < M, handed to epi(m, n, c) four
// columns at a time: c = C(m, n .. n + 3), n a multiple of 4 below N (the
// columns from N on hold sums of whatever B reads there; the epilogue
// masks or ignores them).
// A is in the dynamic shared memory at a, row-major with leading dimension
// lda (a multiple of 4: float4 reads along k); B comes from bl. The sum of
// an output runs in NACC interleaved accumulators, term k into
// accumulator k mod NACC in increasing k from 0 (fmaf(A, B, acc)), then
// c = acc0 (NACC = 1) or (acc0 + acc1) + (acc2 + acc3) (NACC = 4): the
// order of tdmlp_rows. A warp's lanes are 4 row groups (ly) by 8 column
// groups (lx); a thread holds rows m0 + ly + 4i (i < TM) and columns
// n0 + 4lx + j (j < 4). Reads past an edge stay inside the tiles. No
// synchronisation. UNR unrolls the k loop: the second product, with four
// times the accumulators, ran fastest on 2-row tiles unrolled once (one
// cluster evaluation 45.4 → 40.8 µs, NVIDIA H100 80GB HBM3, 700 W).
template <int TM, int NACC, int UNR = 2, typename BLoad, typename Epi>
__device__ inline void slice_gemm(int M, int N, int K, int a, int lda,
                                  BLoad bl, Epi epi) {
  static_assert(NACC == 1 || NACC == 4, "one or four accumulators");
  if (M <= 0 || N <= 0) return;
  const float* const sm = sweep_smem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ly = lane >> 3, lx = lane & 7;
  const int mt = (M + 4 * TM - 1) / (4 * TM), nt = (N + 31) / 32;
  for (int tile = warp; tile < mt * nt; tile += kSolveThreads / 32) {
    const int m0 = (tile % mt) * 4 * TM, n0 = (tile / mt) * 32;
    const int nB = min(n0 + 4 * lx, r4(N) - 4);
    int ao[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) ao[i] = a + min(m0 + ly + 4 * i, M - 1) * lda;
    float acc[NACC][TM][4];
#pragma unroll
    for (int q = 0; q < NACC; ++q)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.f;
    const int K4 = K & ~3;
#pragma unroll (UNR)
    for (int k = 0; k < K4; k += 4) {
      float4 av[TM], bv[4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(sm + ao[i] + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = bl(k + q, nB, N);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[q % NACC][i][j] =
                fmaf(comp(av[i], q), comp(bv[q], j), acc[q % NACC][i][j]);
    }
    for (int k = K4; k < K; ++k) {
      const float4 bv = bl(k, nB, N);
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = sm[ao[i] + k];
#pragma unroll
      for (int q = 0; q < NACC; ++q) {
        if (q != (k - K4) % NACC) continue;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[q][i][j] = fmaf(av[i], comp(bv, j), acc[q][i][j]);
      }
    }
    const int n = n0 + 4 * lx;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ly + 4 * i;
      if (m >= M || n >= N) continue;
      float c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (NACC == 1) {
          c[j] = acc[0][i][j];
        } else {
          c[j] = __fadd_rn(__fadd_rn(acc[0][i][j], acc[1][i][j]),
                           __fadd_rn(acc[2][i][j], acc[3][i][j]));
        }
      }
      epi(m, n, make_float4(c[0], c[1], c[2], c[3]));
    }
  }
}

// slice_gemm at the TF32 tier, with its operands and its epilogue: warp
// tiles of 16 rows by 16 columns, two mma_tf32 (sweep_cluster.cuh) a k-step
// of 8 (two independent chains sharing the A fragment), so each output is
// one chain of mma over k = 0, 8, 16, ... (operands past K zero), whichever
// rows a cluster holds. A is rounded to TF32 as its fragments are built, B
// comes rounded from bl.tf32. The lanes of a pair swap half their
// accumulators, so that each holds four consecutive columns of one row for
// epi. Reads past an edge stay inside the tiles.
template <typename BLoad, typename Epi>
__device__ inline void slice_gemm_tf32(int M, int N, int K, int a, int lda,
                                       BLoad bl, Epi epi) {
  if (M <= 0 || N <= 0) return;
  const float* const sm = sweep_smem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mt = (M + 15) / 16, nt = (N + 15) / 16;
  for (int tile = warp; tile < mt * nt; tile += kSolveThreads / 32) {
    const int m0 = (tile % mt) * 16, n0 = (tile / mt) * 16;
    const int ra = a + min(m0 + g, M - 1) * lda;
    const int rb = a + min(m0 + g + 8, M - 1) * lda;
    const int nb[2] = {min(n0 + g, N - 1), min(n0 + 8 + g, N - 1)};
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 8) {
      const int ka = k0 + q, kb = ka + 4;
      const int ca = min(ka, K - 1), cb = min(kb, K - 1);
      const unsigned af[4] = {ka < K ? tf32_bits(sm[ra + ca]) : 0u,
                              ka < K ? tf32_bits(sm[rb + ca]) : 0u,
                              kb < K ? tf32_bits(sm[ra + cb]) : 0u,
                              kb < K ? tf32_bits(sm[rb + cb]) : 0u};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned bf[2] = {ka < K ? bl.tf32(ca, nb[h]) : 0u,
                                kb < K ? bl.tf32(cb, nb[h]) : 0u};
        mma_tf32(d[h], af, bf);
      }
    }
    // lane q even keeps row g and takes cols 2q + 2, 2q + 3 from lane q + 1;
    // lane q odd keeps row g + 8 and takes cols 2q − 2, 2q − 1
    const bool odd = (q & 1) != 0;
    const int m = m0 + g + (odd ? 8 : 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? d[h][0] : d[h][2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? d[h][1] : d[h][3], 1);
      const int nc = n0 + 8 * h + 2 * (q & 2);
      if (m < M && nc < N)
        epi(m, nc, odd ? make_float4(r0, r1, d[h][2], d[h][3])
                       : make_float4(d[h][0], d[h][1], r0, r1));
    }
  }
}

// ---- one evaluation of the cluster's rows

// A 16-byte store into the shared memory of CTA `rank` of the cluster.
__device__ inline void st_cluster4(unsigned addr, int rank, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "r"(map_rank(addr, rank)), "f"(v.x), "f"(v.y), "f"(v.z),
                  "f"(v.w) : "memory");
}

// The first product's partials of hidden group g (four units) and residue
// q, pushed into the owner CTA's inbox [16][len][4].
__device__ inline void push_hidden(unsigned inbox_addr, int len, int q, int g,
                                   float4 v) {
  const int owner = g % kSweepCluster, l = g / kSweepCluster;
  st_cluster4(inbox_addr + 16u * (q * len + l), owner, v);
}

// The hidden rows of the cluster: wait for every CTA's partials, add each
// of this CTA's units' 16 partials in q order (z = 0, z += p_q), then b1
// and st·w1t, apply tanh and store each group into every CTA's hb (units
// past H into hb's padding); returns after the second cluster barrier,
// with the whole hidden tile in hb.
__device__ inline void hidden_reduce(const SolveSmem& s, int rank, int H,
                                     int nrows, float st) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const float* const sm = sweep_smem;
  const unsigned ha = smem_addr(sweep_smem + s.hb);
  const int H4 = (H + 3) / 4;
  for (int l = threadIdx.x; l < s.len; l += kSolveThreads) {
    const int g = l * kSweepCluster + rank;
    if (g >= nrows * H4) break;
    float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kSolveParts; ++q) {
      const float4 p =
          *reinterpret_cast<const float4*>(sm + s.inbox + 4 * (q * s.len + l));
      z[0] = __fadd_rn(z[0], p.x);
      z[1] = __fadd_rn(z[1], p.y);
      z[2] = __fadd_rn(z[2], p.z);
      z[3] = __fadd_rn(z[3], p.w);
    }
    const int h0 = 4 * (g % H4);
    float hv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int h = min(h0 + j, H - 1);
      hv[j] = tanhf(fmaf(st, sm[s.w1t + h], __fadd_rn(z[j], sm[s.b1 + h])));
    }
    const unsigned dst = ha + 4u * ((g / H4) * s.ldW + h0);
#pragma unroll
    for (int q = 0; q < kSweepCluster; ++q)
      st_cluster4(dst, q, make_float4(hv[0], hv[1], hv[2], hv[3]));
  }
  cl.sync();
}

// The attribution phases of an attempt (the kTime instantiation): the six
// stage inputs, the six evaluations' first products, hidden rows and second
// products, the error pass (ũ, the residuals' pushes, the dense output), the
// wait at the cluster barrier after it, the block sums, the grid barrier,
// the slot sum, and the controller with the commit and the recording.
enum SolvePhase {
  kSpStage = 0, kSpProd1 = 6, kSpHidden = 12, kSpProd2 = 18, kSpError = 24,
  kSpErrorWait, kSpErrorSum, kSpBarrier, kSpSlotSum, kSpCommit, kSpPhases
};

// Kernel 2's step (tdmlp_cluster.cu): the six stages' phases as above, then
// the weights' load, the layout in (u and k1 into the segment layout) and
// the layout out (ũ and the nine row-major outputs).
enum StepPhase { kStWeights = kSpError, kStLayoutIn, kStLayoutOut, kStPhases };

template <bool kOn, int kN = kSpPhases>
struct SolveClock {
  unsigned long long* acc;  // kN sums, in shared memory (kOn)
  unsigned long long last = 0;
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ bool owner() const { return blockIdx.x == 0 && threadIdx.x == 0; }
  __device__ void start() {
    if constexpr (kOn) {
      if (owner()) {
        for (int i = 0; i < kN; ++i) acc[i] = 0;
        last = now();
      }
    }
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
  // per-phase nanoseconds, then the number of attempts
  __device__ void write(unsigned long long* out, int attempts) const {
    if constexpr (kOn) {
      if (owner()) {
        for (int i = 0; i < kN; ++i) out[i] = acc[i];
        out[kN] = static_cast<unsigned long long>(attempts);
      }
    }
  }
};

// One TD-MLP evaluation of the cluster's rows at time st (stage i + 2) from
// the stage input in xa: out (this CTA's segment of row 0, row stride rs)
// receives k on this CTA's features, four segment positions a float4
// store (those between or past the features land in the padding). The
// caller synchronises the CTA after xa is written; this returns
// synchronised, after which xa is free. Not inlined: the products keep a
// register allocation of their own (inlined into the solve they spilled).
// The output stays a pointer argument: the compiler then knows kernel 4's
// is global (behind a struct its stores went generic, kernel 4 1% slower).
// kTf32: both products at the TF32 tier.
template <bool kShared, bool kTf32, typename Clock>
__device__ __noinline__ void solve_eval(const TDMLP& w, const SolveSmem& s,
                                  const SolveSlice& sl, int rank, int nrows,
                                  float st, float* out, size_t rs,
                                  Clock& clk, int i) {
  const int H = w.H;
  float* const sm = sweep_smem;
  const unsigned inbox = smem_addr(sweep_smem + s.inbox);
  const int len = s.len;
  // the two partials: even features (q = c), odd features (q = c + 8)
  for (int part = 0; part < 2; ++part) {
    const int k0 = part == 0 ? 0 : s.odd0;
    const int K = part == 0 ? sl.ne : sl.no;
    const int q = sl.c + kSweepCluster * part;
    const int H4 = (H + 3) / 4;
    auto epi = [=](int m, int n, float4 v) {
      push_hidden(inbox, len, q, m * H4 + n / 4, v);
    };
    if constexpr (kTf32 && kShared) {
      slice_gemm_tf32(nrows, H, K, s.xa + k0, s.ldX,
                      SharedB{s.w1 + k0 * s.ldW, s.ldW}, epi);
    } else if constexpr (kTf32) {
      slice_gemm_tf32(nrows, H, K, s.xa + k0, s.ldX,
                      GlobalW1{w.w1, H, sl.c, k0, s.odd0}, epi);
    } else if constexpr (kShared) {
      slice_gemm<3, 1>(nrows, H, K, s.xa + k0, s.ldX,
                       SharedB{s.w1 + k0 * s.ldW, s.ldW}, epi);
    } else {
      slice_gemm<3, 1>(nrows, H, K, s.xa + k0, s.ldX,
                       GlobalW1{w.w1, H, sl.c, k0, s.odd0}, epi);
    }
  }
  clk.mark(kSpProd1 + i);
  hidden_reduce(s, rank, H, nrows, st);
  clk.mark(kSpHidden + i);
  const int N = sl.odd0 + sl.no;
  // four consecutive segment positions (those in the gap between the even
  // and odd features, or past them, land in the buffers' padding)
  auto epi2 = [=](int m, int n, float4 v) {
    const float4 b = *reinterpret_cast<const float4*>(sm + s.b2 + n);
    const float4 tw = *reinterpret_cast<const float4*>(sm + s.w2t + n);
    const float4 y = make_float4(
        __fadd_rn(__fadd_rn(v.x, b.x), __fmul_rn(st, tw.x)),
        __fadd_rn(__fadd_rn(v.y, b.y), __fmul_rn(st, tw.y)),
        __fadd_rn(__fadd_rn(v.z, b.z), __fmul_rn(st, tw.z)),
        __fadd_rn(__fadd_rn(v.w, b.w), __fmul_rn(st, tw.w)));
    *reinterpret_cast<float4*>(out + m * rs + n) = y;
  };
  if constexpr (kTf32 && kShared) {
    slice_gemm_tf32(nrows, N, H, s.hb, s.ldW, SharedB{s.w2, s.ldX}, epi2);
  } else if constexpr (kTf32) {
    slice_gemm_tf32(nrows, N, H, s.hb, s.ldW, GlobalW2{w.w2, sl, w.F}, epi2);
  } else if constexpr (kShared) {
    slice_gemm<2, 4, 1>(nrows, N, H, s.hb, s.ldW, SharedB{s.w2, s.ldX},
                        epi2);
  } else {
    slice_gemm<2, 4, 1>(nrows, N, H, s.hb, s.ldW, GlobalW2{w.w2, sl, w.F},
                        epi2);
  }
  __syncthreads();
  clk.mark(kSpProd2 + i);
}

// The input of stage i + 2 on this CTA's slice of the row block: x = u +
// dt·(a[0]·k1 + ... + a[N-1]·kN) (the old kernel's stage_input, summed left
// to right), into xa and, when keep is not null, into keep (u_new).
template <int N>
__device__ inline void solve_stage_input(const SolveSmem& s,
                                         const SolveSlice& sl,
                                         const float* const* k,
                                         const float* u, const float (&a)[N],
                                         float dt, int nrows, size_t rs,
                                         float* keep) {
  const int n_e4 = r4(sl.ne) / 4, n_g4 = n_e4 + r4(sl.no) / 4;
  for (int i = threadIdx.x; i < nrows * n_g4; i += kSolveThreads) {
    const size_t o = solve_group(s, sl, i, n_e4, n_g4, rs);
    const int r = i / n_g4, l0 = static_cast<int>(o - r * rs);
    float4 kv[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      kv[j] = *reinterpret_cast<const float4*>(k[j] + o);
    const float4 uv = *reinterpret_cast<const float4*>(u + o);
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = a[0] * comp(kv[0], c);
#pragma unroll
      for (int j = 1; j < N; ++j) acc = acc + a[j] * comp(kv[j], c);
      v[c] = comp(uv, c) + dt * acc;
    }
    const float4 vv = make_float4(v[0], v[1], v[2], v[3]);
    if (keep != nullptr) *reinterpret_cast<float4*>(keep + o) = vv;
    *reinterpret_cast<float4*>(sweep_smem + s.xa + r * s.ldX + l0) = vv;
  }
}

// The six stages of a Tsit5 attempt on this CTA's slice of a row block (the
// first port's tdmlp.cuh::tsit5_rows): the input of stage i + 2 from u and
// k1 .. k(i+1) into xa, then its evaluation into k(i+2). k[0..6] (k1..k7)
// and u are at the block's row 0 in the segment layout (row stride rs);
// the stage-6 input (g6) also goes to keep6 and the stage-7 input (u_new)
// to keep7, each when not null. Kernel 4's attempt and kernel 2's step
// run it (and kernel 8's replay at the TF32 tier); kTf32: the products at
// that tier. Returns synchronised.
template <bool kShared, bool kTf32, typename Clock>
__device__ __forceinline__ void solve_stages(
    const TDMLP& w, const SolveSmem& s, const SolveSlice& sl, int rank,
    int nrows, float t, float dt, float* const* k, const float* u,
    float* keep6, float* keep7, size_t rs, Clock& clk) {
  const float* kr[7];
  for (int j = 0; j < 7; ++j) kr[j] = k[j];
  {
    const float c[1] = {A21};
    solve_stage_input(s, sl, kr, u, c, dt, nrows, rs, nullptr);
  }
  __syncthreads();
  clk.mark(kSpStage + 0);
  solve_eval<kShared, kTf32>(w, s, sl, rank, nrows, t + C1 * dt, k[1], rs,
                      clk, 0);
  {
    const float c[2] = {A31, A32};
    solve_stage_input(s, sl, kr, u, c, dt, nrows, rs, nullptr);
  }
  __syncthreads();
  clk.mark(kSpStage + 1);
  solve_eval<kShared, kTf32>(w, s, sl, rank, nrows, t + C2 * dt, k[2], rs,
                      clk, 1);
  {
    const float c[3] = {A41, A42, A43};
    solve_stage_input(s, sl, kr, u, c, dt, nrows, rs, nullptr);
  }
  __syncthreads();
  clk.mark(kSpStage + 2);
  solve_eval<kShared, kTf32>(w, s, sl, rank, nrows, t + C3 * dt, k[3], rs,
                      clk, 2);
  {
    const float c[4] = {A51, A52, A53, A54};
    solve_stage_input(s, sl, kr, u, c, dt, nrows, rs, nullptr);
  }
  __syncthreads();
  clk.mark(kSpStage + 3);
  solve_eval<kShared, kTf32>(w, s, sl, rank, nrows, t + C4 * dt, k[4], rs,
                      clk, 3);
  {
    const float c[5] = {A61, A62, A63, A64, A65};
    solve_stage_input(s, sl, kr, u, c, dt, nrows, rs, keep6);
  }
  __syncthreads();
  clk.mark(kSpStage + 4);
  solve_eval<kShared, kTf32>(w, s, sl, rank, nrows, t + dt, k[5], rs, clk,
                      4);
  {
    const float c[6] = {A71, A72, A73, A74, A75, A76};
    solve_stage_input(s, sl, kr, u, c, dt, nrows, rs, keep7);
  }
  __syncthreads();
  clk.mark(kSpStage + 5);
  solve_eval<kShared, kTf32>(w, s, sl, rank, nrows, t + dt, k[6], rs, clk,
                      5);
}

// Kernel 4's error pass over this CTA's slice of a row block after an
// attempt's stages (kr: k1..k7, ur: u, unr: u_new, at the block's row 0):
// ũ and the scaled residuals, four segment positions a thread, pushed into
// the residual tile (rt) of the CTA that sums their 8-row block (rank r / 8
// of the cluster). Kernel 8's TF32 replay repeats it.
__device__ __forceinline__ void solve_push_residuals(
    const SolveSmem& s, const SolveSlice& sl, int rank, int nrows, float dt,
    const float* const* kr, const float* ur, const float* unr, size_t rs,
    float atol, float rtol) {
  const unsigned rt_addr = smem_addr(sweep_smem + s.rt);
  // groups of four segment positions a row: the even part's, then the odd
  const int n_e4 = r4(sl.ne) / 4, n_g4 = n_e4 + r4(sl.no) / 4;
  for (int i = threadIdx.x; i < nrows * n_g4; i += kSolveThreads) {
    const size_t o = solve_group(s, sl, i, n_e4, n_g4, rs);
    const int r = i / n_g4, l0 = static_cast<int>(o - r * rs);
    float4 kv[7];
#pragma unroll
    for (int j = 0; j < 7; ++j)
      kv[j] = *reinterpret_cast<const float4*>(kr[j] + o);
    const float4 uv = *reinterpret_cast<const float4*>(ur + o);
    const float4 nv = *reinterpret_cast<const float4*>(unr + o);
    float res4[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = BT1 * comp(kv[0], c);
      acc = acc + BT2 * comp(kv[1], c);
      acc = acc + BT3 * comp(kv[2], c);
      acc = acc + BT4 * comp(kv[3], c);
      acc = acc + BT5 * comp(kv[4], c);
      acc = acc + BT6 * comp(kv[5], c);
      acc = acc + BT7 * comp(kv[6], c);
      const float ut = dt * acc;
      res4[c] = ut / (atol + fmaxf(fabsf(comp(uv, c)),
                                   fabsf(comp(nv, c))) * rtol);
    }
    st_cluster4(rt_addr + 4u * (((r % kRows) * kSweepCluster + rank) *
                                    s.seg + l0),
                r / kRows, make_float4(res4[0], res4[1], res4[2], res4[3]));
  }
}

// After the cluster barrier that follows every CTA's pushes: this CTA's
// 8-row block of the row block at row0 (when it has one, rank < the
// blocks), summed as the first port's kernel summed it: its 1,024 strided
// fmaf chains, two a thread (threads t and t + 512), then block_sum<1024>'s
// tree, into the block's slot.
__device__ __forceinline__ void solve_block_error(const SolveSmem& s,
                                                  int rank, int nrows, int F,
                                                  int row0, float* slots) {
  const int tid = threadIdx.x;
  const int n8 = (nrows + kRows - 1) / kRows;
  if (rank >= n8) return;
  const int n = min(kRows, nrows - rank * kRows) * F;
  float* const sm = sweep_smem;
  float err[2] = {0.f, 0.f};
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    for (int i = tid + v * kSolveThreads; i < n; i += kThreads) {
      // element i of the block, row-major: row r, feature f = 8m + c
      const int r = i / F, f = i - r * F, m = f >> 3;
      const float x = sm[s.rt + (r * kSweepCluster + (f & 7)) * s.seg +
                         ((m & 1) ? s.odd0 : 0) + (m >> 1)];
      err[v] = fmaf(x, x, err[v]);
    }
  }
  // the tree's first level in registers, its last five in warp 0
  float* const red = sm + s.red;
  red[tid] = __fadd_rn(err[0], err[1]);
  __syncthreads();
  for (int st = kSolveThreads / 2; st >= 32; st >>= 1) {
    if (tid < st) red[tid] = __fadd_rn(red[tid], red[tid + st]);
    __syncthreads();
  }
  if (tid < 32) {
    float v = red[tid];
#pragma unroll
    for (int st = 16; st > 0; st >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, st));
    if (tid == 0) __stcg(slots + row0 / kRows + rank, v);
  }
}

// A 16-byte load from the shared memory of CTA `rank` of the cluster.
__device__ inline float4 ld_cluster4(unsigned addr, int rank) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(map_rank(addr, rank)) : "memory");
  return v;
}

// ---- the transposes between a row-major (., F) array and the segments
//
// One float4 of a segment a lane. Item j of a block of rows is (row r, span
// s of 64 features, owner rank c, parity p), (c, p) fastest: its features
// f0 + 16i (i < 4, f0 = 64s + 8p + c) are positions pos .. pos + 3 of CTA
// c's segment (pos = 4s, or odd0 + 4s for the odd features; the even part
// holds exactly 4·ceil(F / 64) positions). The 32 items of a warp cover two
// spans whole, so both its row-major accesses (four scalars a lane, 16
// floats apart) and its segment accesses (a float4 a lane) touch each
// 32-byte sector of the spans once, where a CTA's own features, every 8th
// of a row, take a sector each. Any CTA of the cluster may move any item:
// each takes every 8th batch of 512.
struct SegItem {
  int r, c, pos, f0;
};

__device__ inline int seg_spans(int F) { return (F + 63) / 64; }

__device__ inline SegItem seg_item(int j, int n_span, int odd0) {
  const int cp = j & 15, q = j >> 4, s = q % n_span, p = cp >> 3;
  return SegItem{q / n_span, cp & 7, (p ? odd0 : 0) + 4 * s,
                 64 * s + 8 * p + (cp & 7)};
}

// Items a thread loads before it stores them, in the longer transposes.
constexpr int kItemBatch = 4;

// The first item of this thread and the stride of a cluster's items.
__device__ inline int seg_item0(int rank) {
  return rank * kSolveThreads + static_cast<int>(threadIdx.x);
}
constexpr int kItemStride = kSweepCluster * kSolveThreads;

// An item's four values from a row-major row (zeros past F).
__device__ inline float4 load_item(const float* row, const SegItem& it,
                                   int F) {
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = it.f0 + 16 * i < F ? __ldg(row + it.f0 + 16 * i) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// An item's four values into a row-major row (those before F).
__device__ inline void store_item(float* row, const SegItem& it, int F,
                                  float4 v) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (it.f0 + 16 * i < F) row[it.f0 + 16 * i] = comp(v, i);
}

// Kernels 1 and 2's weights: W1's rows and the vectors as each CTA copies
// them; W2's columns, every 8th of a row and so a sector each, through the
// cluster: each CTA loads a share of W2's rows as items and pushes each
// float4 into its owner's slice. Returns after the cluster barrier that
// precedes the first push (every CTA runs) with pushes in flight: the
// caller's next cluster barrier completes them and shows the copies. At the
// TF32 tier the pushes carry W2 rounded, and each thread rounds the W1
// entries it copied once its copies have landed.
template <bool kShared, bool kTf32 = false>
__device__ inline void load_eval_weights(const TDMLP& w, const SolveSmem& s,
                                         const SolveSlice& sl, int rank) {
  const int F = w.F, H = w.H;
  copy_w1_and_vectors<kShared>(w, s, sl);
  cg::this_cluster().sync();
  if constexpr (kShared) {
    // kItemBatch items a thread at a time: their loads all go out before
    // the first push
    constexpr int U = kItemBatch;
    const unsigned w2 = smem_addr(sweep_smem + s.w2);
    const int n_span = seg_spans(F), n = H * seg_spans(F) * 16;
    for (int j0 = seg_item0(rank); j0 < n; j0 += U * kItemStride) {
      SegItem it[U];
      float4 v[U];
#pragma unroll
      for (int b = 0; b < U; ++b) {
        it[b] = seg_item(j0 + b * kItemStride, n_span, s.odd0);
        const bool ok = j0 + b * kItemStride < n && it[b].f0 < F;
        v[b] = ok ? load_item(w.w2 + static_cast<size_t>(it[b].r) * F, it[b],
                              F)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (kTf32)
          v[b] = make_float4(to_tf32(v[b].x), to_tf32(v[b].y),
                             to_tf32(v[b].z), to_tf32(v[b].w));
      }
#pragma unroll
      for (int b = 0; b < U; ++b)
        if (j0 + b * kItemStride < n && it[b].f0 < F)
          st_cluster4(w2 + 4u * (it[b].r * s.ldX + it[b].pos), it[b].c, v[b]);
    }
  }
  copy_async_wait();
  if constexpr (kShared && kTf32) {
    // the W1 entries this thread copied (copy_w1_and_vectors' walk)
    const int n = sl.ne + sl.no;
    const int q = (H % 4 == 0 && reinterpret_cast<size_t>(w.w1) % 16 == 0)
                      ? 4 : 1;
    const int Hq = H / q;
    for (int i = threadIdx.x; i < n * Hq; i += kSolveThreads) {
      float* const p =
          sweep_smem + s.w1 + solve_local(sl, i / Hq) * s.ldW + q * (i % Hq);
      for (int j = 0; j < q; ++j) p[j] = to_tf32(p[j]);
    }
  }
}

// The launch configuration of a kernel on clusters of kSweepCluster CTAs,
// one cluster per row block of R rows, at most as many as can be resident
// at once (the solve's grid barrier needs that; the kernels without one
// fill one wave). *clusters returns the count.
template <typename Kernel>
static cudaError_t cluster_config(Kernel kernel, int B, int R, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr,
                                  cudaLaunchConfig_t* cfg, int* clusters) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kSweepCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  const int n_rb = (B + R - 1) / R;
  cfg->gridDim = dim3(n_rb * kSweepCluster);
  cfg->blockDim = dim3(kSolveThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  // the opt-in and the query cost host time: once per kernel and
  // shared-memory size
  static const void* known_fn = nullptr;
  static size_t known_smem = 0;
  static int known = 0;
  if (reinterpret_cast<const void*>(kernel) != known_fn ||
      smem != known_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int max_clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&max_clusters, kernel, cfg);
    if (err != cudaSuccess) return err;
    known_fn = reinterpret_cast<const void*>(kernel);
    known_smem = smem;
    known = max_clusters;
  }
  if (known < 1) return cudaErrorCooperativeLaunchTooLarge;
  *clusters = min(n_rb, known);
  cfg->gridDim = dim3(*clusters * kSweepCluster);
  return cudaSuccess;
}

}  // namespace lrnde
