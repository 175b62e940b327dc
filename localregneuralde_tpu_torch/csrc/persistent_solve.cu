// Kernel 4: the whole adaptive Tsit5 solve of the TD-MLP dynamics in one
// launch on thread-block clusters, with the knot and checkpoint recording of
// the stored adjoint and the reservoir sample of the biased regulariser.
//
// Replaces localregneuralde_tpu/ops/pallas/fused_solve.py::_make_kernel
// (family ("tdmlp",), built by _build_call and called from
// persistent_tsit5_solve). On the TPU one core ran the accept/reject loop
// with the state resident in VMEM.
//
// Layout. A cluster of kSweepCluster = 8 CTAs owns a block of R batch rows
// (solve_rows: 40 where the weights fit, so B = 512 takes 13 clusters; R is
// a multiple of 8, so each 8-row error block lies in one cluster). CTA c of
// the cluster owns the features k ≡ c (mod 8) and keeps in shared memory,
// loaded once per launch, W1's rows and W2's columns of those features, b2
// and w2t on them, and all of b1 and w1t. Its features sit in a segment of
// its own in every state buffer (solve_seg), the even-numbered ones
// (k ≡ c mod 16) first, then the odd ones (k ≡ c + 8 mod 16), so the
// state, the stage derivatives k1..k7, the candidate u_new and the stage
// inputs never cross the cluster, and a CTA's loads are contiguous.
//
// Bitwise the kernel it replaced (a CTA of 1,024 threads per 8-row block,
// weights from L2; tdmlp.cuh::tdmlp_rows and solve.cuh::attempt_eest):
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
//  - the stage inputs, ũ, the scaled residuals and the dense output are
//    elementwise, written with the old kernel's expressions.
//  - error norm: each CTA pushes its scaled residuals (its segment, four at
//    a time) into the tile of the CTA that sums their 8-row block; after a
//    cluster barrier that CTA sums the block as the old 1,024 threads did,
//    reading the tile in the old row-major element order (two of their
//    strided fmaf chains a thread, then block_sum<1024>'s tree) into the
//    block's slot. A grid barrier follows, and every CTA sums the ceil(B / 8)
//    slots in order (solve.cuh::ordered_slot_sum).
// So y_final, ys, the step counts and the recordings keep every bit
// (chip_smoke.py's "K4" digests), and the sweeps' window replay, which
// emulates the old kernel (sweep_cluster.cuh::TDMLPSweep), still repeats it.
// Every product is true FP32 FFMA (at the mlp.yaml tolerance ũ is f32
// rounding noise: no TF32).
//
// Per attempt and row block: six evaluations (two products of R × ~100 ×
// ~100 a CTA and one cluster reduction each) and the error pass; then one
// grid barrier and the slot sum. Accepting swaps buffers (u with u_new, k1
// with k7) instead of copying. The grid is at most the clusters that are
// resident at once (cudaOccupancyMaxActiveClusters), which the grid barrier
// needs; the clusters loop over the row blocks when B is larger. A TD-MLP
// whose weight slices do not fit beside the work tiles (at F = 784 from
// H = 134) reads them from global memory in the same order (kShared false),
// with fewer rows a cluster where the tiles alone need it.
//
// The clocked instantiation (kTime) splits CTA 0's attempt by phase for
// chip_smoke.py's [solve attribution]; its arithmetic is the same.
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

// Floats of the vectors (b1, w1t; b2, w2t on the slice) and the work tiles
// at R rows: the stage input [R][ldX], the hidden row [R][ldW], the inbox
// [16][len][4], the residual tile [8 rows][8 ranks][seg] and the error tree
// [512].
__host__ __device__ inline size_t solve_tile_floats(int F, int H, int R) {
  const int seg = solve_seg(F);
  return 2 * static_cast<size_t>(r4(H)) + 2 * seg +
         static_cast<size_t>(R) * vec_ld(seg) +
         static_cast<size_t>(R) * vec_ld(H) +
         static_cast<size_t>(kSolveParts) * 4 * solve_inbox_len(R, H) +
         static_cast<size_t>(kRows) * kSweepCluster * seg + kSolveThreads;
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

// Global scratch: u, u_new and k1..k7 in the segment layout, B rows of
// 8 segments each.
__host__ __device__ inline size_t solve_scratch_floats(int B, int F) {
  return 9 * static_cast<size_t>(B) * kSweepCluster * solve_seg(F);
}

// Offsets (floats) of a CTA's buffers in the dynamic shared memory.
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

// Load the weight slices (kShared) and the vectors.
template <bool kShared>
__device__ inline void load_solve_weights(const TDMLP& w, const SolveSmem& s,
                                          const SolveSlice& sl) {
  const int F = w.F, H = w.H, n = sl.ne + sl.no;
  float* const sm = sweep_smem;
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < n * H; i += kSolveThreads) {
      const int l = solve_local(sl, i / H), h = i % H;
      sm[s.w1 + l * s.ldW + h] =
          w.w1[static_cast<size_t>(slice_feature(sl, l)) * H + h];
    }
    for (int i = threadIdx.x; i < H * n; i += kSolveThreads) {
      const int h = i / n, l = solve_local(sl, i % n);
      sm[s.w2 + h * s.ldX + l] =
          w.w2[static_cast<size_t>(h) * F + slice_feature(sl, l)];
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

// ---- the products

// B(k, n0 .. n0 + 3) of a product, from shared memory ([b + k·ld + n]) or
// from the weights in global memory: W1's row of this CTA's feature k0 + k
// (first product), or W2's row k at this CTA's features n0.. (second).
struct SharedB {
  int b, ld;
  __device__ float4 operator()(int k, int n0, int) const {
    return *reinterpret_cast<const float4*>(sweep_smem + b + k * ld + n0);
  }
};

struct GlobalW1 {
  const float* w1;
  int H, c, k0;  // k0: 0 for the even features, odd0 for the odd ones
  int odd0;
  __device__ float4 operator()(int k, int n0, int N) const {
    const int l = k0 + k;
    const int f = l < odd0 ? 16 * l + c : 16 * (l - odd0) + 8 + c;
    const float* row = w1 + static_cast<size_t>(f) * H;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(row + min(n0 + j, N - 1));
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

struct GlobalW2 {
  const float* w2;
  SolveSlice sl;
  int F;
  __device__ float4 operator()(int k, int n0, int) const {
    const float* row = w2 + static_cast<size_t>(k) * F;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = n0 + j;
      const bool ok = l < sl.ne || (l >= sl.odd0 && l < sl.odd0 + sl.no);
      v[j] = ok ? __ldg(row + slice_feature(sl, l)) : 0.f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
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

template <bool kOn>
struct SolveClock {
  unsigned long long* acc;  // kSpPhases sums, in shared memory (kOn)
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
        for (int i = 0; i < kSpPhases; ++i) acc[i] = 0;
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
        for (int i = 0; i < kSpPhases; ++i) out[i] = acc[i];
        out[kSpPhases] = static_cast<unsigned long long>(attempts);
      }
    }
  }
};

// One TD-MLP evaluation of the cluster's rows at time st (stage i + 2) from
// the stage input in xa: out (this CTA's segment of row 0, row stride rs)
// receives k on this CTA's features. The caller synchronises the CTA after
// xa is written; this returns synchronised. Not inlined: the products keep
// a register allocation of their own (inlined into the solve they spilled).
template <bool kShared, bool kTime>
__device__ __noinline__ void solve_eval(const TDMLP& w, const SolveSmem& s,
                                  const SolveSlice& sl, int rank, int nrows,
                                  float st, float* out, size_t rs,
                                  SolveClock<kTime>& clk, int i) {
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
    if constexpr (kShared) {
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
    *reinterpret_cast<float4*>(out + m * rs + n) = make_float4(
        __fadd_rn(__fadd_rn(v.x, b.x), __fmul_rn(st, tw.x)),
        __fadd_rn(__fadd_rn(v.y, b.y), __fmul_rn(st, tw.y)),
        __fadd_rn(__fadd_rn(v.z, b.z), __fmul_rn(st, tw.z)),
        __fadd_rn(__fadd_rn(v.w, b.w), __fmul_rn(st, tw.w)));
  };
  if constexpr (kShared) {
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

struct ClusterSolveArgs {
  const float* u0;
  const float* k10;
  const float* sc;      // t0, t_end, dt0
  const float* saveat;  // (n_save)
  int n_save;
  TDMLP w;
  float* y;             // (B, F) y_final
  float* ys;            // (n_save, B, F)
  int* stats_i;         // naccept, nreject, done, natt
  float* stats_f;       // t_final, reservoir_t
  float* scratch;       // solve_scratch_floats(B, F)
  float* slots;         // (2, ceil(B / kRows)) error-block partials
  unsigned int* barrier;  // arrival counter, zero at launch
  int B, R;
  int max_steps;
  float rtol, atol, inv_n;
  float* knot_ts;
  float* knot_us;
  int n_dense;
  float* ckpt_ts;
  float* ckpt_us;
  float* ckpt_ks;
  float* ckpt_dts;
  float* ckpt_qolds;
  int n_ckpt;
  int stride;
  const float* rand;
  float* res_u;
  unsigned long long* timing;  // kTime: (kSpPhases + 1)
};

template <bool kShared, bool kTime>
__global__ void __launch_bounds__(kSolveThreads, 1)
cluster_solve_kernel(ClusterSolveArgs a) {
  __shared__ Ctl ctl;
  const TDMLP& w = a.w;
  const int F = w.F, H = w.H, B = a.B, R = a.R, tid = threadIdx.x;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int cid = blockIdx.x / kSweepCluster;
  const int ncl = gridDim.x / kSweepCluster;
  const SolveSmem s = carve_solve_smem(F, H, R, kShared);
  const SolveSlice sl{rank, (solve_count(F, rank) + 1) / 2,
                      solve_count(F, rank) / 2, s.odd0};
  const int n_el = sl.ne + sl.no;
  // groups of four segment positions a row: the even part's, then the odd
  const int n_e4 = r4(sl.ne) / 4, n_g4 = n_e4 + r4(sl.no) / 4;
  const size_t rs = static_cast<size_t>(kSweepCluster) * s.seg;  // row stride
  const size_t BS = static_cast<size_t>(B) * rs;
  const size_t BF = static_cast<size_t>(B) * F;
  const int n_rb = (B + R - 1) / R;
  const int n_blocks = (B + kRows - 1) / kRows;
  const float t_end = a.sc[1];
  __shared__ unsigned long long clk_acc[kTime ? kSpPhases : 1];
  SolveClock<kTime> clk{clk_acc};
  // the state buffers, segment layout: u, u_new, k1..k7
  float* u = a.scratch + rank * s.seg;
  float* unew = u + BS;
  float* k[7];
  for (int j = 0; j < 7; ++j) k[j] = u + (2 + j) * BS;

  // each element (row, local index) of this CTA's rows and features:
  // fn(row, offset in the segment layout, feature)
  auto each = [&](auto fn) {
    for (int rb = cid; rb < n_rb; rb += ncl) {
      const int row0 = rb * R, nrows = min(R, B - row0);
      for (int i = tid; i < nrows * n_el; i += kSolveThreads) {
        const int r = row0 + i / n_el, l = solve_local(sl, i % n_el);
        fn(r, r * rs + l, slice_feature(sl, l));
      }
    }
  };
  load_solve_weights<kShared>(w, s, sl);
  each([&](int r, size_t o, int f) {
    const size_t on = static_cast<size_t>(r) * F + f;
    const float v = a.u0[on];
    u[o] = v;
    k[0][o] = a.k10[on];
    for (int q = 0; q < a.n_save; ++q) a.ys[q * BF + on] = v;
    if (a.n_dense > 0) a.knot_us[on] = v;
    if (a.res_u != nullptr) a.res_u[on] = v;
    if (a.n_ckpt > 0) {
      a.ckpt_us[on] = v;
      a.ckpt_ks[on] = a.k10[on];
    }
  });
  if (blockIdx.x == 0) {
    for (int i = tid; i < a.n_dense; i += kSolveThreads)
      a.knot_ts[i] = i == 0 ? a.sc[0] : t_end;
    for (int i = tid; i < a.n_ckpt; i += kSolveThreads) {
      a.ckpt_ts[i] = i == 0 ? a.sc[0] : t_end;
      a.ckpt_dts[i] = i == 0 ? a.sc[2] : 0.f;
      a.ckpt_qolds[i] = kQoldInit;
    }
  }
  if (tid == 0) {
    ctl.t = a.sc[0];
    ctl.dt = a.sc[2];
    ctl.qold = kQoldInit;
    ctl.res_t = ctl.t;
    ctl.done = ctl.t >= t_end;
    ctl.natt = ctl.nacc = ctl.nrej = 0;
  }
  // every CTA of the cluster runs before any remote store
  cg::this_cluster().sync();

  unsigned int epoch = 0;
  const unsigned rt_addr = smem_addr(sweep_smem + s.rt);
  clk.start();
  while (!ctl.done && ctl.natt < a.max_steps) {
    if (tid == 0) ctl.plan = plan_attempt(ctl.t, ctl.dt, t_end);
    __syncthreads();
    const float t = ctl.t, dt = ctl.plan.dt_c, t_new = ctl.plan.t_new;
    float* const slots = a.slots + (epoch & 1u) * n_blocks;
    for (int rb = cid; rb < n_rb; rb += ncl) {
      const int row0 = rb * R, nrows = min(R, B - row0);
      const size_t off = row0 * rs;
      const float* kr[7];
      for (int j = 0; j < 7; ++j) kr[j] = k[j] + off;
      const float* const ur = u + off;
      // the six stages (tdmlp.cuh::tsit5_rows)
      {
        const float c[1] = {A21};
        solve_stage_input(s, sl, kr, ur, c, dt, nrows, rs, nullptr);
      }
      __syncthreads();
      clk.mark(kSpStage + 0);
      solve_eval<kShared>(w, s, sl, rank, nrows, t + C1 * dt, k[1] + off, rs,
                          clk, 0);
      {
        const float c[2] = {A31, A32};
        solve_stage_input(s, sl, kr, ur, c, dt, nrows, rs, nullptr);
      }
      __syncthreads();
      clk.mark(kSpStage + 1);
      solve_eval<kShared>(w, s, sl, rank, nrows, t + C2 * dt, k[2] + off, rs,
                          clk, 1);
      {
        const float c[3] = {A41, A42, A43};
        solve_stage_input(s, sl, kr, ur, c, dt, nrows, rs, nullptr);
      }
      __syncthreads();
      clk.mark(kSpStage + 2);
      solve_eval<kShared>(w, s, sl, rank, nrows, t + C3 * dt, k[3] + off, rs,
                          clk, 2);
      {
        const float c[4] = {A51, A52, A53, A54};
        solve_stage_input(s, sl, kr, ur, c, dt, nrows, rs, nullptr);
      }
      __syncthreads();
      clk.mark(kSpStage + 3);
      solve_eval<kShared>(w, s, sl, rank, nrows, t + C4 * dt, k[4] + off, rs,
                          clk, 3);
      {
        const float c[5] = {A61, A62, A63, A64, A65};
        solve_stage_input(s, sl, kr, ur, c, dt, nrows, rs, nullptr);
      }
      __syncthreads();
      clk.mark(kSpStage + 4);
      solve_eval<kShared>(w, s, sl, rank, nrows, t + dt, k[5] + off, rs, clk,
                          4);
      {
        const float c[6] = {A71, A72, A73, A74, A75, A76};
        solve_stage_input(s, sl, kr, ur, c, dt, nrows, rs, unew + off);
      }
      __syncthreads();
      clk.mark(kSpStage + 5);
      solve_eval<kShared>(w, s, sl, rank, nrows, t + dt, k[6] + off, rs, clk,
                          5);
      // ũ and the scaled residuals, four segment positions a thread, pushed
      // into the tile of the CTA that sums their 8-row block
      const float* const unr = unew + off;
      for (int i = tid; i < nrows * n_g4; i += kSolveThreads) {
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
          res4[c] = ut / (a.atol + fmaxf(fabsf(comp(uv, c)),
                                         fabsf(comp(nv, c))) * a.rtol);
        }
        st_cluster4(rt_addr + 4u * (((r % kRows) * kSweepCluster + rank) *
                                        s.seg + l0),
                    r / kRows, make_float4(res4[0], res4[1], res4[2], res4[3]));
      }
      // the speculative dense output of the saveat times this attempt
      // would cross (the accepted attempt that crosses one writes last)
      for (int q = 0; q < a.n_save; ++q) {
        const float ts = a.saveat[q];
        if (!(ts > t && ts <= t_new)) continue;
        float b[7];
        interp_weights(fminf(fmaxf((ts - t) / dt, 0.f), 1.f), b);
        float* const ys = a.ys + q * BF + static_cast<size_t>(row0) * F;
        for (int i = tid; i < nrows * n_el; i += kSolveThreads) {
          const int r = i / n_el, l = solve_local(sl, i - r * n_el);
          const size_t o = r * rs + l;
          float acc = b[0] * kr[0][o];
#pragma unroll
          for (int j = 1; j < 7; ++j) acc = acc + b[j] * kr[j][o];
          ys[static_cast<size_t>(r) * F + slice_feature(sl, l)] =
              ur[o] + dt * acc;
        }
      }
      clk.mark(kSpError);
      cg::this_cluster().sync();
      clk.mark(kSpErrorWait);
      // this CTA's 8-row block: the old kernel's 1,024 strided fmaf chains,
      // two a thread (threads t and t + 512), then block_sum<1024>'s tree
      const int n8 = (nrows + kRows - 1) / kRows;
      if (rank < n8) {
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
      clk.mark(kSpErrorSum);
    }
    ++epoch;
    grid_barrier(a.barrier, epoch * gridDim.x);
    clk.mark(kSpBarrier);
    const float err_sq = ordered_slot_sum<kSolveThreads>(slots, n_blocks);
    clk.mark(kSpSlotSum);

    if (tid == 0) {
      const float eest = sqrtf(err_sq * a.inv_n);
      const bool accept = eest <= 1.f;
      float dt_acc, dt_rej, qold_acc;
      propose(eest, dt, ctl.qold, &dt_acc, &dt_rej, &qold_acc);
      ctl.accept = accept;
      ctl.take = accept && a.rand != nullptr &&
                 a.rand[ctl.natt] * static_cast<float>(ctl.nacc + 1) < 1.f;
      if (accept) {
        if (ctl.take) ctl.res_t = t;
        ctl.t = t_new;
        ctl.dt = dt_acc;
        ctl.qold = qold_acc;
        ctl.done = ctl.plan.is_last;
        ++ctl.nacc;
      } else {
        ctl.dt = dt_rej;
        ++ctl.nrej;
      }
      ++ctl.natt;
    }
    __syncthreads();
    if (ctl.accept) {
      if (ctl.take)
        each([&](int r, size_t o, int f) {
          a.res_u[static_cast<size_t>(r) * F + f] = u[o];
        });
      // commit: u <- u_new, k1 <- k7, by swapping the buffers
      float* const swap_u = u;
      u = unew;
      unew = swap_u;
      float* const swap_k = k[0];
      k[0] = k[6];
      k[6] = swap_k;
      const int cnt = ctl.nacc;
      const bool knot = cnt < a.n_dense;
      const bool ckpt = a.n_ckpt > 0 && cnt % a.stride == 0;
      const int ci = ckpt ? cnt / a.stride : 0;
      if (knot || ckpt)
        each([&](int r, size_t o, int f) {
          const size_t on = static_cast<size_t>(r) * F + f;
          if (knot) a.knot_us[cnt * BF + on] = u[o];
          if (ckpt) {
            a.ckpt_us[ci * BF + on] = u[o];
            a.ckpt_ks[ci * BF + on] = k[0][o];
          }
        });
      if (blockIdx.x == 0 && tid == 0) {
        if (knot) a.knot_ts[cnt] = ctl.t;
        if (ckpt) {
          a.ckpt_ts[ci] = ctl.t;
          a.ckpt_dts[ci] = ctl.dt;
          a.ckpt_qolds[ci] = ctl.qold;
        }
      }
    }
    __syncthreads();
    clk.mark(kSpCommit);
  }

  // y_final; saveat entries never covered by an accepted step revert to u0,
  // so a failed solve matches the loop's accept-only commits
  const float t_fin = ctl.t;
  each([&](int r, size_t o, int f) {
    const size_t on = static_cast<size_t>(r) * F + f;
    a.y[on] = u[o];
    for (int q = 0; q < a.n_save; ++q)
      if (a.saveat[q] > t_fin) a.ys[q * BF + on] = a.u0[on];
  });
  if (blockIdx.x == 0 && tid == 0) {
    a.stats_i[0] = ctl.nacc;
    a.stats_i[1] = ctl.nrej;
    a.stats_i[2] = ctl.done;
    a.stats_i[3] = ctl.natt;
    a.stats_f[0] = ctl.t;
    a.stats_f[1] = ctl.res_t;
  }
  clk.write(a.timing, ctl.natt);
}

// The launch configuration of a kernel on clusters of kSweepCluster CTAs,
// one cluster per row block of R rows, at most as many as can be resident
// at once (the solve's grid barrier needs that). *clusters returns the
// count.
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

// Launch (or, with a null, only size) the cluster solve at (B, F, H).
template <bool kShared, bool kTime>
static cudaError_t launch_cluster_solve(const ClusterSolveArgs* a, int B,
                                        int F, int H, int R,
                                        cudaStream_t stream, int* clusters) {
  auto kernel = cluster_solve_kernel<kShared, kTime>;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err =
      cluster_config(kernel, B, R,
                     solve_smem_floats(F, H, R, kShared) * sizeof(float),
                     stream, &attr, &cfg, clusters);
  if (err != cudaSuccess || a == nullptr) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, *a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One evaluation out = f(x, *s) (B, F) through the solve's cluster path
// (solve_eval), for the card tests: each cluster loads its row blocks into
// the stage-input tile, evaluates them, and copies its outputs from the
// segment layout (scratch: B rows of 8 segments) to out.
template <bool kShared>
__global__ void __launch_bounds__(kSolveThreads, 1)
cluster_eval_kernel(TDMLP w, const float* x, const float* s_ptr, float* out,
                    float* scratch, int B, int R) {
  const int F = w.F, H = w.H, tid = threadIdx.x;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const SolveSmem s = carve_solve_smem(F, H, R, kShared);
  const SolveSlice sl{rank, (solve_count(F, rank) + 1) / 2,
                      solve_count(F, rank) / 2, s.odd0};
  const int n_el = sl.ne + sl.no;
  const size_t rs = static_cast<size_t>(kSweepCluster) * s.seg;
  const int n_rb = (B + R - 1) / R;
  const float st = *s_ptr;
  SolveClock<false> clk{nullptr};
  load_solve_weights<kShared>(w, s, sl);
  cg::this_cluster().sync();
  for (int rb = blockIdx.x / kSweepCluster; rb < n_rb;
       rb += gridDim.x / kSweepCluster) {
    const int row0 = rb * R, nrows = min(R, B - row0);
    for (int i = tid; i < nrows * n_el; i += kSolveThreads) {
      const int r = i / n_el, l = solve_local(sl, i % n_el);
      sweep_smem[s.xa + r * s.ldX + l] =
          x[static_cast<size_t>(row0 + r) * F + slice_feature(sl, l)];
    }
    __syncthreads();
    float* const seg = scratch + row0 * rs + rank * s.seg;
    solve_eval<kShared>(w, s, sl, rank, nrows, st, seg, rs, clk, 0);
    for (int i = tid; i < nrows * n_el; i += kSolveThreads) {
      const int r = i / n_el, l = solve_local(sl, i % n_el);
      out[static_cast<size_t>(row0 + r) * F + slice_feature(sl, l)] =
          seg[r * rs + l];
    }
  }
}

template <bool kTime>
static cudaError_t cluster_solve(const ClusterSolveArgs* a, int B, int F,
                                 int H, cudaStream_t stream, int* clusters) {
  int R = 0;
  bool shared = false;
  if (!solve_plan(F, H, &R, &shared)) return cudaErrorInvalidValue;
  return shared ? launch_cluster_solve<true, kTime>(a, B, F, H, R, stream,
                                                    clusters)
                : launch_cluster_solve<false, kTime>(a, B, F, H, R, stream,
                                                     clusters);
}

template <bool kTime>
static int persistent_tsit5(
    const float* u0, const float* k10, const float* sc, const float* saveat,
    int n_save, const float* w1, const float* b1, const float* w2,
    const float* b2, float* u, float* ys, int* stats_i, float* stats_f,
    float* scratch, float* slots, unsigned int* barrier, int B, int F, int H,
    int max_steps, float rtol, float atol, float inv_n, float* knot_ts,
    float* knot_us, int n_dense, float* ckpt_ts, float* ckpt_us,
    float* ckpt_ks, float* ckpt_dts, float* ckpt_qolds, int n_ckpt,
    int stride, const float* rand, float* res_u, unsigned long long* timing,
    void* stream) {
  if ((n_ckpt > 0 && stride < 1) || (rand == nullptr) != (res_u == nullptr) ||
      (kTime && timing == nullptr))
    return cudaErrorInvalidValue;
  int R = 0;
  bool shared = false;
  if (!solve_plan(F, H, &R, &shared)) return cudaErrorInvalidValue;
  const ClusterSolveArgs a{
      u0, k10, sc, saveat, n_save, TDMLP{w1, b1, w2, b2, F, H}, u, ys,
      stats_i, stats_f, scratch, slots, barrier, B, R, max_steps, rtol, atol,
      inv_n, knot_ts, knot_us, n_dense, ckpt_ts, ckpt_us, ckpt_ks, ckpt_dts,
      ckpt_qolds, n_ckpt, stride, rand, res_u, timing};
  int clusters = 0;
  return cluster_solve<kTime>(&a, B, F, H, static_cast<cudaStream_t>(stream),
                              &clusters);
}

static __global__ void __launch_bounds__(128)
slot_sum_kernel(const float* slots, int n, float* out) {
  const float s = ordered_slot_sum<128>(slots, n);
  if (threadIdx.x == 0) out[0] = s;
}

}  // namespace lrnde

// The whole adaptive solve from (u0, k1_0) with sc = (t0, t_end, dt0) on the
// device. scratch holds lrnde_solve_scratch_floats(B, F, H) floats, slots
// 2·ceil(B / 8), barrier one zeroed unsigned int. With n_dense > 0 it
// records knots, with n_ckpt > 0 checkpoints every `stride` accepts (null
// pointers otherwise). With rand (max_steps uniforms) it keeps the
// reservoir sample in res_u (B, F) and stats_f[1] (both null otherwise;
// stats_f holds 2 floats). Fails with cudaErrorInvalidValue where not even
// 8 rows of a cluster fit a CTA (lrnde_solve_rows = 0), and with
// cudaErrorCooperativeLaunchTooLarge when no cluster can be resident.
// Returns cudaGetLastError().
extern "C" int lrnde_persistent_tsit5(
    const float* u0, const float* k10, const float* sc, const float* saveat,
    int n_save, const float* w1, const float* b1, const float* w2,
    const float* b2, float* u, float* ys, int* stats_i, float* stats_f,
    float* scratch, float* slots, unsigned int* barrier, int B, int F, int H,
    int max_steps, float rtol, float atol, float inv_n, float* knot_ts,
    float* knot_us, int n_dense, float* ckpt_ts, float* ckpt_us,
    float* ckpt_ks, float* ckpt_dts, float* ckpt_qolds, int n_ckpt,
    int stride, const float* rand, float* res_u, void* stream) {
  return lrnde::persistent_tsit5<false>(
      u0, k10, sc, saveat, n_save, w1, b1, w2, b2, u, ys, stats_i, stats_f,
      scratch, slots, barrier, B, F, H, max_steps, rtol, atol, inv_n, knot_ts,
      knot_us, n_dense, ckpt_ts, ckpt_us, ckpt_ks, ckpt_dts, ckpt_qolds,
      n_ckpt, stride, rand, res_u, nullptr, stream);
}

// The solve with its attempts' phases timed: lrnde_persistent_tsit5's
// contract, plus timing (kSpPhases + 1 unsigned 64-bit integers): CTA 0's
// nanoseconds in each SolvePhase, summed over the attempts, then the number
// of attempts. A separate instantiation; the untimed kernel carries no clock
// reads and no extra barriers.
extern "C" int lrnde_persistent_tsit5_timed(
    const float* u0, const float* k10, const float* sc, const float* saveat,
    int n_save, const float* w1, const float* b1, const float* w2,
    const float* b2, float* u, float* ys, int* stats_i, float* stats_f,
    float* scratch, float* slots, unsigned int* barrier, int B, int F, int H,
    int max_steps, float rtol, float atol, float inv_n, float* knot_ts,
    float* knot_us, int n_dense, float* ckpt_ts, float* ckpt_us,
    float* ckpt_ks, float* ckpt_dts, float* ckpt_qolds, int n_ckpt,
    int stride, const float* rand, float* res_u, unsigned long long* timing,
    void* stream) {
  return lrnde::persistent_tsit5<true>(
      u0, k10, sc, saveat, n_save, w1, b1, w2, b2, u, ys, stats_i, stats_f,
      scratch, slots, barrier, B, F, H, max_steps, rtol, atol, inv_n, knot_ts,
      knot_us, n_dense, ckpt_ts, ckpt_us, ckpt_ks, ckpt_dts, ckpt_qolds,
      n_ckpt, stride, rand, res_u, timing, stream);
}

// The number of attribution phases of lrnde_persistent_tsit5_timed.
extern "C" int lrnde_solve_phases() { return lrnde::kSpPhases; }

// The solve's layout at (F, H), for the wrapper's plan (fused_solve.py::
// solve_plan) to check against: the rows of a cluster (0: no width fits),
// whether the weight slices stay in shared memory, the floats of dynamic
// shared memory and of global scratch.
extern "C" int lrnde_solve_rows(int F, int H) {
  int R = 0;
  bool shared = false;
  return lrnde::solve_plan(F, H, &R, &shared) ? R : 0;
}
extern "C" int lrnde_solve_weights_shared(int F, int H) {
  int R = 0;
  bool shared = false;
  return lrnde::solve_plan(F, H, &R, &shared) && shared ? 1 : 0;
}
extern "C" long long lrnde_solve_smem_floats(int F, int H) {
  int R = 0;
  bool shared = false;
  if (!lrnde::solve_plan(F, H, &R, &shared)) return 0;
  return static_cast<long long>(lrnde::solve_smem_floats(F, H, R, shared));
}
extern "C" long long lrnde_solve_scratch_floats(int B, int F, int H) {
  (void)H;
  return static_cast<long long>(lrnde::solve_scratch_floats(B, F));
}

// The clusters a solve launch at (B, F, H) takes on this card: the row
// blocks, at most as many as can run at once. Negative: a CUDA error.
extern "C" int lrnde_solve_clusters(int B, int F, int H) {
  int clusters = 0;
  const cudaError_t err =
      lrnde::cluster_solve<false>(nullptr, B, F, H, nullptr, &clusters);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// out = f(x, *s) for x (B, F) through the solve's cluster evaluation,
// for the card tests (bitwise kernel 1's tdmlp_rows); scratch holds
// lrnde_solve_scratch_floats(B, F, H) / 9 floats. Returns
// cudaGetLastError().
extern "C" int lrnde_solve_eval(const float* x, const float* s,
                                const float* w1, const float* b1,
                                const float* w2, const float* b2, float* out,
                                float* scratch, int B, int F, int H,
                                void* stream) {
  using namespace lrnde;
  int R = 0, clusters = 0;
  bool shared = false;
  if (!solve_plan(F, H, &R, &shared)) return cudaErrorInvalidValue;
  const TDMLP w{w1, b1, w2, b2, F, H};
  const size_t smem = solve_smem_floats(F, H, R, shared) * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  auto kernel = shared ? cluster_eval_kernel<true> : cluster_eval_kernel<false>;
  cudaError_t err =
      cluster_config(kernel, B, R, smem, st, &attr, &cfg, &clusters);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, w, x, s, out, scratch, B, R);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// solve.cuh::ordered_slot_sum alone on n slots, out[0] = the in-order sum:
// one CTA of 128 threads, for the card tests. Returns cudaGetLastError().
extern "C" int lrnde_slot_sum(const float* slots, int n, float* out,
                              void* stream) {
  lrnde::slot_sum_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      slots, n, out);
  return cudaGetLastError();
}
