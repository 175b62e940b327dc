// The conv GEMM core of kernels 13 and 14: the 3x3 SAME convolution over
// NHWC as an implicit GEMM on the H100, in its three orientations.
//
// - forward and data gradient (conv_gemm_kernel): out (M = B·H·W, cout) =
//   A (M, K = 9·cin) · Wk (K, cout), with A[p, tap·cin + ci] = in[p + d_tap,
//   ci] inside the image and 0 outside, Wk the HWIO weight's rows
//   tap·w_cin + ci. The data gradient is the forward over the output
//   cotangent with the weight's taps flipped and its channel axes swapped,
//   which transpose_w_kernel copies once per call (a 16-byte copy cannot
//   gather the swapped axes in place).
// - weight gradient (wgrad_gemm_kernel): dW (9·cin, cout) = Aᵀ · dy summed
//   over a split of the pixels, Aᵀ[tap·cin + ci, p] = src[p + d_tap, ci];
//   each split adds into its own partial slot (summed in split order by
//   tsit5_bwd.cuh::reduce_partials); the time channel's rows, whose value
//   s is a constant, are border-corrected column sums of dy
//   (wgrad_time_kernel).
//
// Design (no float atomics, bitwise repeatable; FP32 FFMA, and a TF32
// instantiation of each product loop, below):
// - Tap-major K: k = tap·cin + ci, so four consecutive k with cin % 4 == 0
//   are four contiguous channels of one shifted pixel: one border test and
//   one 16-byte cp.async per four elements, zero-filled outside the image
//   through the copy's source size. Channel counts that are not multiples of
//   4 take 4-byte copies in the same template (kVec = false).
// - A ring of ST stages of A and B tiles in dynamic shared memory
//   (cp.async.commit/wait_group): the copies of chunk c + ST − 1 are in
//   flight while chunk c is multiplied.
// - Register micro-tiles: each thread owns TM rows, interleaved at a stride
//   of BM / TM, and 8 columns, two float4 halves at tx·4 and BN / 2 + tx·4,
//   so every shared-memory read of a warp is a broadcast or 32 contiguous
//   floats (no bank conflicts). The forward's A tile is pixel-major with a
//   row stride of BK + 4 floats and read as float4 along k; the weight
//   gradient's is k-major (pixel rows of channel columns) and read along
//   its rows.
// - Two tile shapes: N = 64 (128 pixels x 64 channels, 8 x 8 a thread) and
//   N = 8, the thin convs (conv3's forward, conv1's data gradient, conv3's
//   weight gradient), 128 pixels or rows x 8 with a full 8-wide output row
//   a thread, so no thread holds a slice of an empty N = 64 tile.
// - The operands are plain activations: gelu(BN(z)) is written once per
//   evaluation by bn_act_kernel (conv.cuh), not recomputed in every gather.
// - The thin forward convs (N = 8, 16-byte operands) run on a halo tile
//   (conv_halo_kernel): a CTA stages the image rows its 128 pixels lie in,
//   with a one-pixel border, and the whole weight in shared memory once,
//   through cp.async, and reads the nine taps from there. Each output keeps
//   the gather tile's tap-major FFMA chain, so its bits.
// - An epilogue (ConvEpilogue) may, instead of or beside the plain store:
//   apply BatchNorm with given statistics and gelu (eval with the running
//   stats); write each 128-pixel tile's per-channel sum and M2 into a fixed
//   slot, the last CTA by ticket folding the slots in tile order into the
//   batch mean and variance (Chan's combination, all tiles at once: mean =
//   Σ S_t / M, M2 = Σ [M2_t + n_t (S_t / n_t − mean)²]) and, after the last
//   evaluation, the running stats' EMA chain; or compute the next Tsit5
//   stage input (and g6, u_new, ũ) from the k it writes. The statistics
//   need the N = 64 tile (launch_conv routes them there).
// - The TF32 tier (tf32.cuh; the reference's 'default' precision): each
//   kernel has a kTf32 instantiation whose product loop is mma.sync
//   m16n8k8 .tf32 over the same cp.async ring (the halo tile's staged halo
//   and weight), and whose epilogue is the FFMA one: the warps' accumulator
//   fragments go through shared memory into the FFMA micro-tile layout
//   (stage_tf32), so the statistics, the BatchNorm-apply, the stage algebra
//   and the weight gradient's partial slots are the same code. Each output
//   is one chain of mma over k = 0, 8, 16, ... (zeros past K), so the gather
//   and the halo tile agree bitwise at TF32 too (the halo tile takes TF32
//   only at cin % 8 == 0, where its tap-by-tap k-steps are the gather
//   tile's). mma.sync, not K15's wgmma core: the N = 8 convs are one n8
//   tile, which a wgmma's 64-row, 8-column-step M x N x 8 suits no better,
//   and mma.sync's fragments come from the existing ring and its epilogue.
//   The TD-MLP family's TF32 products (PERF.md §6) showed that a chain fed
//   one scalar load and one cvt per use is no faster than FFMA; here a
//   warp's 64 x 32 tile (4 x 4 mma a k-step) reuses each A fragment four
//   times and each B fragment four times, the loads are conflict-free (the
//   ring's row strides are 8 banks apart, B's padded to BN + 8 at N = 64),
//   and the halo tile rounds its halo and weight once where they are
//   staged. The time maps sum TF32-rounded taps, the time rows of the
//   weight gradient TF32-rounded dy (a tap mask is exact in TF32).
//
// What bounds it on an H100: the products (2·M·9·cin·cout FLOP, 36 µs a
// 64 -> 64 conv at B = 32, 32x32 at 67 TFLOP/s) for N = 64; for N = 8 the
// shared-memory reads of the operands (nine per 32 FFMA a thread).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tdmlp.cuh"
#include "tf32.cuh"
#include "tsit5_bwd.cuh"

namespace lrnde {
namespace conv {

__host__ __device__ inline int cdiv(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// ---------------------------------------------------------------------------
// The TF32 product (mma.sync m16n8k8 .tf32): the warp tiling of a BM x BN
// CTA tile of NT threads (warps of WN = min(BN, 32) columns and WM rows,
// MI x NJ mma tiles a warp), the k-step, and the accumulators' way back
// into the FFMA micro-tile layout.

template <int BM, int BN, int NT>
struct Tf32Warps {
  static constexpr int NW = NT / 32, WN = BN < 32 ? BN : 32;
  static constexpr int WARPS_N = BN / WN, WARPS_M = NW / WARPS_N;
  static constexpr int WM = BM / WARPS_M, MI = WM / 16, NJ = WN / 8;
  static_assert(NT % 32 == 0 && BN % WN == 0 && NW % WARPS_N == 0 &&
                    BM % (16 * WARPS_M) == 0 && WN % 8 == 0,
                "TF32 warp tiling");
};

// The row stride of a ring's operand tile read along its columns by a
// fragment (lane (g, q) at row q, column g): 8 banks apart row to row.
template <int N>
__host__ __device__ constexpr int tf32_ld(int fp32_ld) {
  return N % 32 == 0 ? N + 8 : fp32_ld;
}

// One k-step of 8: d[mi][nj] += A(mi) · B(nj), the fragments built by
// a(mi, af) (4 TF32 words) and b(nj, bf) (2), each once a k-step.
template <int MI, int NJ, typename AFrag, typename BFrag>
__device__ __forceinline__ void mma_k8_tf32(float (&d)[MI][NJ][4], AFrag a, BFrag b) {
  unsigned af[MI][4], bf[NJ][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) a(mi, af[mi]);
#pragma unroll
  for (int nj = 0; nj < NJ; ++nj) b(nj, bf[nj]);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) mma_tf32(d[mi][nj], af[mi], bf[nj]);
}

// A warp's accumulators (rows wm0 + 16 mi + g and + 8, columns wn0 + 8 nj +
// 2q and + 1) into c[row * ldc + col].
template <int MI, int NJ>
__device__ __forceinline__ void stage_tf32(const float (&d)[MI][NJ][4], float* c,
                                           int ldc, int wm0, int wn0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      float* p = c + (wm0 + 16 * mi + g) * ldc + wn0 + 8 * nj + 2 * q;
      *reinterpret_cast<float2*>(p) = make_float2(d[mi][nj][0], d[mi][nj][1]);
      *reinterpret_cast<float2*>(p + 8 * ldc) = make_float2(d[mi][nj][2], d[mi][nj][3]);
    }
}

// ---------------------------------------------------------------------------
// cp.async

__device__ inline void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ inline void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The column of a thread's j-th output (j < 8): two float4 halves.
template <int BN>
__device__ inline int out_col(int tx, int j) {
  return j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4);
}

// ---------------------------------------------------------------------------
// The epilogue of a forward conv

constexpr float kGeluA = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluB = 0.044715f;

__device__ inline float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(kGeluA * (x + kGeluB * x * x * x)));
}

// BatchNorm-apply and gelu of v in a channel of mean m, 1 / sqrt(var + eps)
// inv, scale g and shift b
__device__ __forceinline__ float bn_gelu(float v, float m, float inv, float g, float b) {
  return gelu_tanh(((v - m) * inv) * g + b);
}

// The input of evaluation e of a Tsit5 step: u + dt Σ_{j <= e} a_ej k_j,
// kv[j] = k_{j+1} (register-indexed: the loop is unrolled).
__device__ inline float stage_input(int e, float u, const float (&kv)[7], float dt) {
  float acc = kA[e][0] * kv[0];
#pragma unroll
  for (int j = 1; j < 6; ++j)
    if (j <= e) acc = acc + kA[e][j] * kv[j];
  return u + dt * acc;
}

// u~ = dt Σ_j btilde_j k_j
__device__ inline float utilde_value(const float (&kv)[7], float dt) {
  const float acc = BT1 * kv[0] + BT2 * kv[1] + BT3 * kv[2] + BT4 * kv[3] +
                    BT5 * kv[4] + BT6 * kv[5] + BT7 * kv[6];
  return dt * acc;
}

// What a forward conv does with its output v beside (or instead of) the
// plain store; all null (stage 0) is the plain store.
struct ConvEpilogue {
  // BatchNorm statistics (N = 64 tile only): each tile's per-channel sum
  // and M2 into part (tile_stats), folded through groups of tiles (the
  // kStatTickets tickets) into stats = (mean[cout], var[cout]) and, with
  // ema_out, the EMA chain
  // r = omm r + mom stat_e over the six evaluations of ema_stats
  // (6 x 4 x cout) from ema_in into ema_out (4 x cout)
  float* part;
  unsigned* ticket;
  float* stats;
  const float* ema_stats;
  const float* ema_in;
  float* ema_out;
  float mom, omm;
  int probe_levels;  // a timing probe's cut: 1 no final fold, 2 no group fold
  // store gelu(BN(v)) with these statistics instead of v
  const float* bn_mean;
  const float* bn_var;
  const float* gamma;
  const float* beta;
  float eps;
  // the conv is evaluation e's last and v is k_{e+2}: with stage = e + 1
  // <= 5 write the next input x = u + dt Σ a k (and g6 at 4, u_new at 5),
  // with stage = 6 u~ (where utilde is given); k[j] = k_{j+1}
  int stage;
  const float* u;
  const float* k[7];
  float* x;
  float* g6;
  float* unew;
  float* utilde;
};

// ---------------------------------------------------------------------------
// Forward and data gradient

struct ConvArgs {
  const float* in;    // (M, cin), NHWC
  int cin;
  const float* w;     // HWIO (3, 3, w_cin, cout): rows tap·w_cin + ci, ci < cin
  int w_cin;
  int cout;
  const float* tmap;  // (H·W, cout), added as s·tmap; may be null
  const float* sc;    // (t, dt) on the device
  float c;            // s = t + c·dt
  float* out;         // (M, cout)
  int B, H, W;
  ConvEpilogue epi;   // zero: the plain store
};

// The epilogue of output element i = p·cout + co of value v (after the
// time channel): the stored value, then the stage algebra.
__device__ inline void conv_store(const ConvArgs& a, size_t i, int co, float v, float dt) {
  const ConvEpilogue& e = a.epi;
  a.out[i] = e.bn_mean == nullptr
                 ? v
                 : bn_gelu(v, e.bn_mean[co], rsqrtf(e.bn_var[co] + e.eps), e.gamma[co],
                           e.beta[co]);
  if (e.stage <= 0) return;
  float kv[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) kv[j] = j < e.stage ? e.k[j][i] : v;
  if (e.stage == 6) {
    if (e.utilde != nullptr) e.utilde[i] = utilde_value(kv, dt);
    return;
  }
  const float x = stage_input(e.stage, e.u[i], kv, dt);
  e.x[i] = x;
  if (e.stage == 4 && e.g6 != nullptr) e.g6[i] = x;
  if (e.stage == 5 && e.unew != nullptr) e.unew[i] = x;
}

__device__ inline void conv_store4(const ConvArgs& a, size_t i, int co, float4 v,
                                   float dt) {
  if (a.epi.bn_mean == nullptr && a.epi.stage <= 0) {
    *reinterpret_cast<float4*>(a.out + i) = v;
    return;
  }
  conv_store(a, i, co, v.x, dt);
  conv_store(a, i + 1, co + 1, v.y, dt);
  conv_store(a, i + 2, co + 2, v.z, dt);
  conv_store(a, i + 3, co + 3, v.w, dt);
}

constexpr int kStatGroups = 16;  // groups of tiles the statistics fold through

// Tickets of one conv's statistics: one a group of tiles, then the last.
constexpr int kStatTickets = kStatGroups + 1;

// Tiles a group at T tiles: at most kStatGroups groups.
__host__ __device__ inline int stat_group_tiles(int T) {
  return (T + kStatGroups - 1) / kStatGroups;
}

// Chan's combination, all at once, of `count` moment slots src[i] = (S_i,
// M2_i) (each 2·C floats, item i of n_i = min(R, M − i·R) rows), items
// first.. in order: S = Σ S_i, mean = S / n, M2 = Σ [M2_i + n_i (S_i / n_i −
// mean)²], n the items' rows. Lane l of a channel sums every L-th block of
// items in order, the lanes are added in order. Writes (S, M2) to dst, or
// with final (mean, M2 / n) to dst. red: 2·NT floats of shared memory.
constexpr int kFoldRegs = 8;  // items a lane keeps in registers in a fold

template <int NT>
__device__ void fold_moments(const float* src, int first, int count, int C,
                             int R, int M, float* dst, bool final, float* red) {
  const int tid = threadIdx.x;
  const int L = NT >= C ? NT / C : 1;  // lanes a channel
  const int CP = NT / L;               // channels a pass
  const int lane = tid / CP, cl = tid - lane * CP;
  const int per = (count + L - 1) / L;
  const int i0 = first + lane * per, i1 = min(first + count, i0 + per);
  const int rows = min(count * R, M - first * R);
  // up to kFoldRegs items a lane: one round trip to L2 for both sums
  const bool regs = per <= kFoldRegs;
  for (int cb = 0; cb < C; cb += CP) {
    const int c = cb + cl;
    const bool on = c < C && lane < L;
    float sv[kFoldRegs], mv[kFoldRegs];
    float s = 0.f;
    if (on && regs) {
#pragma unroll
      for (int q = 0; q < kFoldRegs; ++q) {
        const size_t o = static_cast<size_t>(i0 + q) * 2 * C + c;
        sv[q] = i0 + q < i1 ? __ldcg(src + o) : 0.f;
        mv[q] = i0 + q < i1 ? __ldcg(src + o + C) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kFoldRegs; ++q)
        if (i0 + q < i1) s += sv[q];
    } else if (on) {
#pragma unroll 8
      for (int i = i0; i < i1; ++i) s += __ldcg(src + static_cast<size_t>(i) * 2 * C + c);
    }
    if (lane < L) red[lane * CP + cl] = s;
    __syncthreads();
    if (lane == 0 && on) {
      float sum = 0.f;
      for (int l = 0; l < L; ++l) sum += red[l * CP + cl];
      red[NT + cl] = sum;
    }
    __syncthreads();
    const float sum = red[NT + cl], mean = sum / static_cast<float>(rows);
    float m2 = 0.f;
    if (on && regs) {
#pragma unroll
      for (int q = 0; q < kFoldRegs; ++q) {
        const int i = i0 + q;
        if (i >= i1) break;
        const float n_i = static_cast<float>(min(R, M - i * R));
        const float d = sv[q] / n_i - mean;
        m2 = m2 + (mv[q] + n_i * (d * d));
      }
    } else if (on) {
#pragma unroll 8
      for (int i = i0; i < i1; ++i) {
        const float n_i = static_cast<float>(min(R, M - i * R));
        const size_t o = static_cast<size_t>(i) * 2 * C + c;
        const float d = __ldcg(src + o) / n_i - mean;
        m2 = m2 + (__ldcg(src + o + C) + n_i * (d * d));
      }
    }
    if (lane < L) red[lane * CP + cl] = m2;
    __syncthreads();
    if (lane == 0 && on) {
      float m2s = 0.f;
      for (int l = 0; l < L; ++l) m2s += red[l * CP + cl];
      dst[c] = final ? mean : sum;
      dst[C + c] = final ? m2s / static_cast<float>(rows) : m2s;
    }
    __syncthreads();
  }
}

// The BatchNorm statistics of a tile's outputs (the values the threads hold
// in acc, rows m0 + ty + i·(BM/TM)): the tile's per-channel sum and M2
// (about its own mean) into its slot of part ([T][2][C], then [groups][2][C]
// for the groups); the last CTA of a group of tiles (a ticket) folds the
// group's slots into the group's slot, the last group the groups' into the
// statistics, then (with ema_out) the running stats' EMA chain. red: free
// shared memory of at least (BM/TM + 2)·BN + 1 and 2·NT + 1 floats.
template <int BM, int BN, int TM>
__device__ __forceinline__ void tile_stats(const ConvArgs& a,
                                           const float (&acc)[TM][8], int m0,
                                           int n0, float* red) {
  constexpr int NY = BM / TM, NT = NY * (BN / 8);
  const int tid = threadIdx.x, tx = tid % (BN / 8), ty = tid / (BN / 8);
  const int M = a.B * a.H * a.W, C = a.cout, rows = min(BM, M - m0);
  float* tot = red + NY * BN;  // the tile's column sums
  float* mu = tot + BN;        // its column means
  float* part = a.epi.part;
  // the tile's sums: a thread's rows in order, then the NY threads in order
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i)
      if (ty + i * NY < rows) s += acc[i][j];
    red[ty * BN + out_col<BN>(tx, j)] = s;
  }
  __syncthreads();
  if (tid < BN) {
    float s = 0.f;
    for (int y = 0; y < NY; ++y) s += red[y * BN + tid];
    tot[tid] = s;
    mu[tid] = s / static_cast<float>(rows);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float m = mu[out_col<BN>(tx, j)];
    float d2 = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float d = acc[i][j] - m;
      if (ty + i * NY < rows) d2 = fmaf(d, d, d2);
    }
    red[ty * BN + out_col<BN>(tx, j)] = d2;
  }
  __syncthreads();
  if (tid < BN && n0 + tid < C) {
    float m2 = 0.f;
    for (int y = 0; y < NY; ++y) m2 += red[y * BN + tid];
    const size_t slot = static_cast<size_t>(blockIdx.x) * 2 * C;
    part[slot + n0 + tid] = tot[tid];
    part[slot + C + n0 + tid] = m2;
  }
  if (a.epi.probe_levels == 2) return;
  // the last CTA of the tile's group folds the group (the barrier orders
  // the CTA's slot writes before thread 0's fence and ticket, which release
  // them to the CTA that folds)
  const int T = gridDim.x, G = stat_group_tiles(T), n_groups = (T + G - 1) / G;
  const int grp = blockIdx.x / G, g0 = grp * G, gn = min(G, T - g0);
  unsigned* flag = reinterpret_cast<unsigned*>(red + 2 * NT);
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *flag = atomicAdd(a.epi.ticket + grp, 1u) == gn * gridDim.y - 1;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  float* groups = part + static_cast<size_t>(T) * 2 * C;
  fold_moments<NT>(part, g0, gn, C, BM, M, groups + static_cast<size_t>(grp) * 2 * C,
                   false, red);
  if (a.epi.probe_levels == 1) return;
  // the last group folds the groups
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    *flag = atomicAdd(a.epi.ticket + kStatGroups, 1u) == n_groups - 1;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  fold_moments<NT>(groups, 0, n_groups, C, G * BM, M, a.epi.stats, true, red);
  if (a.epi.ema_out == nullptr) return;
  // every evaluation's statistics are written: this CTA's above, the
  // earlier ones by earlier launches
  for (int idx = tid; idx < 4 * C; idx += NT) {
    float r = a.epi.ema_in[idx];
    for (int e = 0; e < 6; ++e) r = a.epi.omm * r + a.epi.mom * a.epi.ema_stats[e * 4 * C + idx];
    a.epi.ema_out[idx] = r;
  }
}

template <int BM, int BN, int BK, int ST, bool kTf32 = false>
__host__ __device__ constexpr size_t gemm_smem_floats() {
  return static_cast<size_t>(ST) *
         (BM * (BK + 4) + BK * (kTf32 ? tf32_ld<BN>(BN) : BN));
}

// kEpi: the epilogue (ConvEpilogue) is compiled in; without it the plain
// store, so the plain convs' code is the first port's. kTf32: the products
// at the TF32 tier (mma.sync), the FP32 instantiations unchanged.
template <int BM, int BN, int TM, int BK, int ST, bool kVec, bool kEpi, bool kTf32>
static __global__ void __launch_bounds__((BM / TM) * (BN / 8))
conv_gemm_kernel(ConvArgs a) {
  constexpr int TN = 8, NT = (BM / TM) * (BN / TN), LDA = BK + 4;
  constexpr int LDB = kTf32 ? tf32_ld<BN>(BN) : BN;
  constexpr int KG = kVec ? BK / 4 : BK;  // A copies per pixel row and chunk
  static_assert(BK % 4 == 0 && NT % KG == 0 && (BM * KG) % NT == 0,
                "A-tile mapping");
  extern __shared__ float4 smem4[];
  float* const As = reinterpret_cast<float*>(smem4);  // [ST][BM][LDA]
  float* const Bs = As + ST * BM * LDA;               // [ST][BK][LDB]
  const int tid = threadIdx.x;
  const int H = a.H, W = a.W, HW = H * W, M = a.B * HW;
  const int cin = a.cin, K = 9 * cin, cout = a.cout;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nchunks = cdiv(K, BK);

  // this thread's A copies: a fixed group of 4 k (kVec) or one k, and fixed
  // pixel rows
  constexpr int GA = BM * KG / NT;
  const int kg = tid % KG;
  int ph[GA], pw[GA], prow[GA];
#pragma unroll
  for (int j = 0; j < GA; ++j) {
    const int row = tid / KG + j * (NT / KG);
    const int p = m0 + row;
    const int r = p % HW;
    prow[j] = p < M ? p : -1;
    ph[j] = r / W;
    pw[j] = r - (r / W) * W;
  }

  auto load = [&](int chunk, int st) {
    const int k0 = chunk * BK;
    float* as = As + st * BM * LDA;
    float* bs = Bs + st * BK * LDB;
    {
      const int kk = kVec ? 4 * kg : kg;
      const int k = k0 + kk;
      const int tap = k / cin, ci = k - tap * cin;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
      for (int j = 0; j < GA; ++j) {
        const int row = tid / KG + j * (NT / KG);
        const int hs = ph[j] + dy, ws = pw[j] + dx;
        const bool ok = k < K && prow[j] >= 0 && hs >= 0 && hs < H && ws >= 0 && ws < W;
        const float* src = ok ? a.in + (static_cast<size_t>(prow[j] + dy * W + dx) * cin + ci)
                              : a.in;
        if constexpr (kVec) cp_async16(as + row * LDA + kk, src, ok);
        else cp_async4(as + row * LDA + kk, src, ok);
      }
    }
    constexpr int NB = kVec ? BK * BN / 4 : BK * BN;
    for (int e = tid; e < NB; e += NT) {
      const int kk = kVec ? e / (BN / 4) : e / BN;
      const int n = kVec ? 4 * (e - kk * (BN / 4)) : e - kk * BN;
      const int k = k0 + kk, co = n0 + n;
      const bool ok = k < K && co < cout;
      const int tap = k / cin, ci = k - tap * cin;
      const float* src =
          ok ? a.w + (static_cast<size_t>(tap) * a.w_cin + ci) * cout + co : a.w;
      if constexpr (kVec) cp_async16(bs + kk * LDB + n, src, ok);
      else cp_async4(bs + kk * LDB + n, src, ok);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  // the TF32 instantiation's warp tile, the lane's fragment row and
  // column (fg, fq), and its accumulators
  using TW = Tf32Warps<BM, BN, NT>;
  [[maybe_unused]] const int fg = (tid & 31) >> 2, fq = tid & 3;
  [[maybe_unused]] const int wm0 = (tid / 32 / TW::WARPS_N) * TW::WM;
  [[maybe_unused]] const int wn0 = (tid / 32 % TW::WARPS_N) * TW::WN;
  [[maybe_unused]] float d[TW::MI][TW::NJ][4];
  if constexpr (kTf32) {
#pragma unroll
    for (int mi = 0; mi < TW::MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < TW::NJ; ++nj)
#pragma unroll
        for (int r = 0; r < 4; ++r) d[mi][nj][r] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nchunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    {
      const int nc = c + ST - 1;
      if (nc < nchunks) load(nc, nc % ST);
      cp_async_commit();
    }
    const float* as = As + (c % ST) * BM * LDA;
    const float* bs = Bs + (c % ST) * BK * LDB;
    if constexpr (kTf32) {
      // A (pixel-major, rows wm0 + 16 mi + g) and B (k-major) as TF32
      // fragments, each rounded once as it is built
#pragma unroll
      for (int k0 = 0; k0 < BK; k0 += 8) {
        mma_k8_tf32(
            d,
            [&](int mi, unsigned(&f)[4]) {
              const float* p = as + (wm0 + 16 * mi + fg) * LDA + k0 + fq;
              f[0] = tf32_bits(p[0]);
              f[1] = tf32_bits(p[8 * LDA]);
              f[2] = tf32_bits(p[4]);
              f[3] = tf32_bits(p[8 * LDA + 4]);
            },
            [&](int nj, unsigned(&f)[2]) {
              const float* p = bs + (k0 + fq) * LDB + wn0 + 8 * nj + fg;
              f[0] = tf32_bits(p[0]);
              f[1] = tf32_bits(p[4 * LDB]);
            });
      }
      continue;
    }
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (ty + i * (BM / TM)) * LDA + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 = *reinterpret_cast<const float4*>(bs + (kk + q) * BN + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + (kk + q) * BN + BN / 2 + tx * 4);
        const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = q == 0 ? av[i].x : q == 1 ? av[i].y : q == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(x, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (kTf32) {  // the fragments into the FFMA layout, via the ring
    constexpr int LDC = BN + 4;
    __syncthreads();
    stage_tf32(d, As, LDC, wm0, wn0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = As[(ty + i * (BM / TM)) * LDC + out_col<BN>(tx, j)];
  }

  const float s = a.sc[0] + a.c * a.sc[1];
  if constexpr (!kEpi) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int p = m0 + ty + i * (BM / TM);
      if (p >= M) continue;
      if constexpr (kVec) {  // two float4 stores a row
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int co = n0 + h * (BN / 2) + tx * 4;
          if (co >= cout) continue;
          float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                                 acc[i][4 * h + 3]);
          if (a.tmap != nullptr) {
            const float4 m = *reinterpret_cast<const float4*>(
                a.tmap + static_cast<size_t>(p % HW) * cout + co);
            v.x = v.x + s * m.x;
            v.y = v.y + s * m.y;
            v.z = v.z + s * m.z;
            v.w = v.w + s * m.w;
          }
          *reinterpret_cast<float4*>(a.out + static_cast<size_t>(p) * cout + co) = v;
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int co = n0 + out_col<BN>(tx, j);
        if (co >= cout) continue;
        float v = acc[i][j];
        if (a.tmap != nullptr) v = v + s * a.tmap[static_cast<size_t>(p % HW) * cout + co];
        a.out[static_cast<size_t>(p) * cout + co] = v;
      }
    }
    return;
  }
  // the epilogue: BatchNorm-apply and gelu with the thread's columns'
  // parameters loaded once, or the plain store with the stage algebra; then
  // the statistics of the tile (N = 64)
  const float dt = a.sc[1];
  const bool bn = a.epi.bn_mean != nullptr;
  float bm[TN], bi[TN], bg[TN], bb[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int co = n0 + out_col<BN>(tx, j);
    const bool on = bn && co < cout;
    bm[j] = on ? a.epi.bn_mean[co] : 0.f;
    bi[j] = on ? rsqrtf(a.epi.bn_var[co] + a.epi.eps) : 0.f;
    bg[j] = on ? a.epi.gamma[co] : 0.f;
    bb[j] = on ? a.epi.beta[co] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = m0 + ty + i * (BM / TM);
    if (p >= M) continue;
    if constexpr (kVec) {  // two float4 stores a row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = n0 + h * (BN / 2) + tx * 4;
        if (co >= cout) continue;
        float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                               acc[i][4 * h + 3]);
        if (a.tmap != nullptr) {
          const float4 m = *reinterpret_cast<const float4*>(
              a.tmap + static_cast<size_t>(p % HW) * cout + co);
          v.x = v.x + s * m.x;
          v.y = v.y + s * m.y;
          v.z = v.z + s * m.z;
          v.w = v.w + s * m.w;
        }
        acc[i][4 * h] = v.x;
        acc[i][4 * h + 1] = v.y;
        acc[i][4 * h + 2] = v.z;
        acc[i][4 * h + 3] = v.w;
        const size_t o = static_cast<size_t>(p) * cout + co;
        if (bn) {
          const int q = 4 * h;
          *reinterpret_cast<float4*>(a.out + o) = make_float4(
              bn_gelu(v.x, bm[q], bi[q], bg[q], bb[q]),
              bn_gelu(v.y, bm[q + 1], bi[q + 1], bg[q + 1], bb[q + 1]),
              bn_gelu(v.z, bm[q + 2], bi[q + 2], bg[q + 2], bb[q + 2]),
              bn_gelu(v.w, bm[q + 3], bi[q + 3], bg[q + 3], bb[q + 3]));
        } else {
          conv_store4(a, o, co, v, dt);
        }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + out_col<BN>(tx, j);
      if (co >= cout) continue;
      float v = acc[i][j];
      if (a.tmap != nullptr) v = v + s * a.tmap[static_cast<size_t>(p % HW) * cout + co];
      acc[i][j] = v;
      conv_store(a, static_cast<size_t>(p) * cout + co, co, v, dt);
    }
  }
  if constexpr (BN == 64) {
    if (a.epi.part != nullptr) {
      __syncthreads();  // the operand ring is free: the statistics use it
      tile_stats<BM, BN, TM>(a, acc, m0, n0, As);
    }
  }
}

constexpr int kConvBK = 32;  // k per chunk
constexpr int kConvST = 3;   // cp.async stages

template <int BM, int BN, int TM, bool kVec, bool kEpi, bool kTf32>
static inline cudaError_t launch_gemm(const ConvArgs& a, cudaStream_t st) {
  auto kernel = conv_gemm_kernel<BM, BN, TM, kConvBK, kConvST, kVec, kEpi, kTf32>;
  const size_t smem =
      gemm_smem_floats<BM, BN, kConvBK, kConvST, kTf32>() * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const int M = a.B * a.H * a.W;
  const dim3 grid(cdiv(M, BM), cdiv(a.cout, BN));
  kernel<<<grid, (BM / TM) * (BN / 8), smem, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The halo tile of the thin forward convs (cout <= 8, 16-byte operands)

constexpr int kHaloPix = 128;  // pixels (threads) a CTA, one a thread

__host__ __device__ inline int gcd_int(int a, int b) {
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Halo rows a CTA stages: the most image rows kHaloPix consecutive pixels
// from a multiple of kHaloPix span at width W, plus one above and below.
__host__ __device__ inline int halo_rows(int W) {
  return (W - gcd_int(kHaloPix, W) + kHaloPix - 1) / W + 3;
}

// Shared memory of a halo CTA: the halo, each pixel's cin channels padded
// by 4 floats (conflict-free 16-byte reads down a warp's pixels), then the
// weight's 9·cin rows of 8 output channels.
__host__ __device__ inline size_t halo_smem_floats(int W, int cin) {
  return static_cast<size_t>(halo_rows(W)) * (W + 2) * (cin + 4) +
         static_cast<size_t>(9) * cin * 8;
}

// The TF32 product of a halo CTA (cin % 8 == 0): warp w owns pixels m0 +
// 32 w .. + 31, two m16 tiles of the one n8 tile, and runs the gather
// tile's chain, tap by tap and 8 channels a k-step, over the halo and the
// weight, both rounded to TF32 where they were staged. Returns the
// thread's own pixel's 8 outputs (m0 + tid), through shared memory c
// (kHaloPix x 12 floats; the halo is free by then).
__device__ __forceinline__ void halo_mma_tf32(const ConvArgs& a, const float* halo,
                                              const float* ws, int g0, float* c,
                                              float (&acc)[8]) {
  const int H = a.H, W = a.W, M = a.B * H * W, cin = a.cin, LDH = cin + 4;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int base = blockIdx.x * kHaloPix + (tid & ~31);
  // the lane's four pixel rows: tile mi, row g and g + 8
  int gr[2][2], wc[2][2], hh[2][2];
  bool in[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = base + 16 * mi + 8 * r + g;
      in[mi][r] = p < M;
      gr[mi][r] = p / W;
      wc[mi][r] = p - gr[mi][r] * W;
      hh[mi][r] = gr[mi][r] % H;
    }
  float d[2][1][4] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const float* ap[2][2];
    bool ok[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ok[mi][r] = in[mi][r] && hh[mi][r] + dy >= 0 && hh[mi][r] + dy < H &&
                    wc[mi][r] + dx >= 0 && wc[mi][r] + dx < W;
        ap[mi][r] = halo + static_cast<size_t>((gr[mi][r] - g0 + 1 + dy) * (W + 2) +
                                               wc[mi][r] + 1 + dx) * LDH + q;
      }
    const float* bp = ws + (tap * cin + q) * 8 + g;
#pragma unroll 2
    for (int ci = 0; ci < cin; ci += 8) {
      mma_k8_tf32(
          d,
          [&](int mi, unsigned(&f)[4]) {
            f[0] = ok[mi][0] ? __float_as_uint(ap[mi][0][ci]) : 0u;
            f[1] = ok[mi][1] ? __float_as_uint(ap[mi][1][ci]) : 0u;
            f[2] = ok[mi][0] ? __float_as_uint(ap[mi][0][ci + 4]) : 0u;
            f[3] = ok[mi][1] ? __float_as_uint(ap[mi][1][ci + 4]) : 0u;
          },
          [&](int, unsigned(&f)[2]) {
            f[0] = __float_as_uint(bp[ci * 8]);
            f[1] = __float_as_uint(bp[(ci + 4) * 8]);
          });
    }
  }
  constexpr int LDC = 12;
  __syncthreads();  // every warp is done with the halo
  stage_tf32(d, c, LDC, tid & ~31, 0);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = c[tid * LDC + j];
}

// out (M, cout <= 8) = conv3x3(in), pixel p = m0 + tid a thread: tap by tap
// (k = tap·cin + ci ascending, the gather tile's order) from the halo,
// zero where the tap leaves the image (the image's own rows: a tile may
// span two images). kTf32: the products at the TF32 tier (cin % 8 == 0).
template <bool kTf32>
static __global__ void __launch_bounds__(kHaloPix) conv_halo_kernel(ConvArgs a) {
  extern __shared__ float4 smem4[];
  const int H = a.H, W = a.W, HW = H * W, M = a.B * HW, G = a.B * H;
  const int cin = a.cin, cout = a.cout, LDH = cin + 4, tid = threadIdx.x;
  const int m0 = blockIdx.x * kHaloPix, g0 = m0 / W;
  const int rows = (min(m0 + kHaloPix, M) - 1) / W - g0 + 3;
  float* const halo = reinterpret_cast<float*>(smem4);  // [rows][W + 2][LDH]
  float* const ws = halo + static_cast<size_t>(halo_rows(W)) * (W + 2) * LDH;
  const int c4 = cin / 4, n_halo = rows * (W + 2) * c4;
  for (int idx = tid; idx < n_halo; idx += kHaloPix) {
    const int pix = idx / c4, q = idx - pix * c4;
    const int hr = pix / (W + 2), hc = pix - hr * (W + 2);
    const int gr = g0 - 1 + hr, wc = hc - 1;
    const bool ok = gr >= 0 && gr < G && wc >= 0 && wc < W;
    const float* src =
        ok ? a.in + (static_cast<size_t>(gr) * W + wc) * cin + 4 * q : a.in;
    cp_async16(halo + static_cast<size_t>(pix) * LDH + 4 * q, src, ok);
  }
  for (int idx = tid; idx < 9 * cin * 2; idx += kHaloPix) {
    const int k = idx / 2, co = 4 * (idx - 2 * k);
    const int tap = k / cin, ci = k - tap * cin;
    const bool ok = co < cout;
    const float* src =
        ok ? a.w + (static_cast<size_t>(tap) * a.w_cin + ci) * cout + co : a.w;
    cp_async16(ws + k * 8 + co, src, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int p = m0 + tid;
  float acc[8];
  if constexpr (kTf32) {
    // round the staged halo and weight once, then the tensor cores
    for (int idx = tid; idx < n_halo + 9 * cin * 2; idx += kHaloPix) {
      float4* v = reinterpret_cast<float4*>(
          idx < n_halo ? halo + static_cast<size_t>(idx / c4) * LDH + 4 * (idx % c4)
                       : ws + 4 * (idx - n_halo));
      const float4 x = *v;
      *v = make_float4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z), to_tf32(x.w));
    }
    __syncthreads();
    halo_mma_tf32(a, halo, ws, g0, halo, acc);
    if (p >= M) return;
  } else {
    if (p >= M) return;
    const int g = p / W, wc = p - g * W, h = g % H;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const bool ok = h + dy >= 0 && h + dy < H && wc + dx >= 0 && wc + dx < W;
      const float* ap =
          halo + static_cast<size_t>((g - g0 + 1 + dy) * (W + 2) + wc + 1 + dx) * LDH;
      const float* bp = ws + tap * cin * 8;
#pragma unroll 4
      for (int ci = 0; ci < cin; ci += 4) {
        const float4 av = ok ? *reinterpret_cast<const float4*>(ap + ci)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 b0 = *reinterpret_cast<const float4*>(bp + (ci + q) * 8);
          const float4 b1 = *reinterpret_cast<const float4*>(bp + (ci + q) * 8 + 4);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
          const float x = q == 0 ? av.x : q == 1 ? av.y : q == 2 ? av.z : av.w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = fmaf(x, bv[j], acc[j]);
        }
      }
    }
  }
  const float s = a.sc[0] + a.c * a.sc[1], dt = a.sc[1];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int co = 4 * hf;
    if (co >= cout) continue;
    float4 v = make_float4(acc[co], acc[co + 1], acc[co + 2], acc[co + 3]);
    if (a.tmap != nullptr) {
      const float4 m = *reinterpret_cast<const float4*>(
          a.tmap + static_cast<size_t>(p % HW) * cout + co);
      v.x = v.x + s * m.x;
      v.y = v.y + s * m.y;
      v.z = v.z + s * m.z;
      v.w = v.w + s * m.w;
    }
    conv_store4(a, static_cast<size_t>(p) * cout + co, co, v, dt);
  }
}

template <bool kTf32>
static inline cudaError_t launch_halo(const ConvArgs& a, cudaStream_t st) {
  const size_t smem = halo_smem_floats(a.W, a.cin) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(conv_halo_kernel<kTf32>, smem, &granted);
  if (err != cudaSuccess) return err;
  conv_halo_kernel<kTf32>
      <<<cdiv(static_cast<long long>(a.B) * a.H * a.W, kHaloPix), kHaloPix, smem, st>>>(a);
  return cudaGetLastError();
}

static inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The 16-byte path needs 4-aligned channel counts and 16-byte aligned
// operands.
static inline bool conv_vec(const ConvArgs& a) {
  return a.cin % 4 == 0 && a.cout % 4 == 0 && aligned16(a.in) && aligned16(a.w) &&
         aligned16(a.out) && (a.tmap == nullptr || aligned16(a.tmap));
}

// Shared memory a halo CTA may take: two CTAs an SM.
constexpr size_t kHaloSmemBytes = 113 * 1024;

// The tile of a forward conv: the halo tile for a thin 16-byte conv whose
// halo fits (unless gather is set; at TF32 only for cin % 8 == 0), the
// N = 8 gather tile for another thin one, the N = 64 tile otherwise and for
// every conv that takes BatchNorm statistics. tf32: the products at the
// TF32 tier.
template <int BM, int BN, int TM, bool kTf32>
static inline cudaError_t launch_tile(const ConvArgs& a, cudaStream_t st, bool vec,
                                      bool epi) {
  if (epi)
    return vec ? launch_gemm<BM, BN, TM, true, true, kTf32>(a, st)
               : launch_gemm<BM, BN, TM, false, true, kTf32>(a, st);
  return vec ? launch_gemm<BM, BN, TM, true, false, kTf32>(a, st)
             : launch_gemm<BM, BN, TM, false, false, kTf32>(a, st);
}

template <bool kTf32>
static inline cudaError_t launch_conv_at(const ConvArgs& a, cudaStream_t st, bool gather) {
  const bool vec = conv_vec(a);
  const bool epi = a.epi.part != nullptr || a.epi.bn_mean != nullptr || a.epi.stage > 0;
  if (a.cout <= 8 && a.epi.part == nullptr) {
    if (vec && !gather && (!kTf32 || a.cin % 8 == 0) &&
        halo_smem_floats(a.W, a.cin) * sizeof(float) <= kHaloSmemBytes)
      return launch_halo<kTf32>(a, st);
    return launch_tile<128, 8, 1, kTf32>(a, st, vec, epi);
  }
  return launch_tile<128, 64, 8, kTf32>(a, st, vec, epi);
}

static inline cudaError_t launch_conv(const ConvArgs& a, cudaStream_t st, bool tf32,
                                      bool gather = false) {
  return tf32 ? launch_conv_at<true>(a, st, gather) : launch_conv_at<false>(a, st, gather);
}

// The data gradient's weight: wt (3, 3, w_cout, w_cin − 1) with
// wt[tap, co, ci] = w[8 − tap, ci, co] (taps flipped, channel axes swapped,
// the time channel dropped), so that the data gradient of a conv with the
// HWIO weight w (3, 3, w_cin, w_cout) is conv_gemm over the cotangent with
// wt.
static __global__ void transpose_w_kernel(const float* __restrict__ w, int w_cin,
                                          int w_cout, float* __restrict__ wt) {
  const int ci_n = w_cin - 1;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 9 * w_cout * ci_n) return;
  const int tap = idx / (w_cout * ci_n), r = idx - tap * (w_cout * ci_n);
  const int co = r / ci_n, ci = r - co * ci_n;
  wt[idx] = w[(static_cast<size_t>(8 - tap) * w_cin + ci) * w_cout + co];
}

static inline cudaError_t transpose_w(const float* w, int w_cin, int w_cout,
                                      float* wt, cudaStream_t st) {
  const int n = 9 * w_cout * (w_cin - 1);
  transpose_w_kernel<<<cdiv(n, 256), 256, 0, st>>>(w, w_cin, w_cout, wt);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Weight gradient

constexpr int kWgradBlocks = 264;  // weight-gradient blocks to aim for (2 per SM)
constexpr int kSplitRows = 256;    // fewest pixels of a weight-gradient split
constexpr int kWgradBM = 128;      // rows (tap, ci) of a weight-gradient tile

// Output tiles of a weight gradient's GEMM (9·cin rows x cout): 128 x 8 for
// a thin output, else 128 x 64.
static inline int wgrad_tiles(int cin, int cout) {
  return cdiv(9 * cin, kWgradBM) * (cout <= 8 ? cdiv(cout, 8) : cdiv(cout, 64));
}

// Splits of the pixel axis for a weight gradient: as many blocks as fill
// the card without a partial second round (at most kWgradBlocks), each over
// at least kSplitRows pixels.
static inline int wgrad_splits(int M, int cin, int cout) {
  const int per = kWgradBlocks / wgrad_tiles(cin, cout);
  const int want = per < 1 ? 1 : per;
  const int cap = M / kSplitRows < 1 ? 1 : M / kSplitRows;
  return want < cap ? want : cap;
}

struct WgradArgs {
  const float* src;  // the conv's input (M, cin), plain
  int cin;
  const float* sc;
  float c;           // s = t + c·dt, the time channel's value
  const float* dy;   // (M, cout)
  int cout;
  float* part;       // [split][9 (cin + 1)][cout], accumulated
  int rows_per_split;
  int B, H, W;
};

template <int BM, int BN, int BK, int ST, bool kTf32 = false>
__host__ __device__ constexpr size_t wgrad_smem_floats() {
  return static_cast<size_t>(ST) * BK *
         (kTf32 ? tf32_ld<BM>(BM + 4) + tf32_ld<BN>(BN) : (BM + 4) + BN);
}

// Advance a pixel's (h, w) by n pixels (n < H·W is not needed: whole rows
// wrap through the images).
__device__ inline void advance_pixel(int& h, int& w, int n, int H, int W) {
  w += n;
  while (w >= W) {
    w -= W;
    if (++h == H) h = 0;
  }
}

// kTf32: the products at the TF32 tier (mma.sync), the FP32
// instantiations unchanged.
template <int BM, int BN, int TM, int BK, int ST, bool kVec, bool kTf32>
static __global__ void __launch_bounds__((BM / TM) * (BN / 8))
wgrad_gemm_kernel(WgradArgs a) {
  constexpr int TN = 8, NT = (BM / TM) * (BN / TN);
  constexpr int LDA = kTf32 ? tf32_ld<BM>(BM + 4) : BM + 4;
  constexpr int LDB = kTf32 ? tf32_ld<BN>(BN) : BN;
  constexpr int MG = kVec ? BM / 4 : BM;  // copies per pixel of the A tile
  static_assert(NT % MG == 0 && (BK * MG) % NT == 0, "A-tile mapping");
  extern __shared__ float4 smem4[];
  float* const As = reinterpret_cast<float*>(smem4);  // [ST][BK][LDA]
  float* const Bs = As + ST * BK * LDA;               // [ST][BK][LDB]
  const int tid = threadIdx.x;
  const int H = a.H, W = a.W, HW = H * W, M = a.B * HW;
  const int cin = a.cin, R = 9 * cin, cout = a.cout;
  const int r0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int p_begin = blockIdx.z * a.rows_per_split;
  const int p_end = min(M, p_begin + a.rows_per_split);
  const int nchunks = p_end > p_begin ? cdiv(p_end - p_begin, BK) : 0;

  // this thread's A copies: a fixed (tap, ci) group and pixels kk0 + j·KS of
  // every chunk, their (h, w) advanced chunk by chunk
  constexpr int GA = BK * MG / NT, KS = NT / MG;
  const int mg = tid % MG, kk0 = tid / MG;
  const int r = r0 + (kVec ? 4 * mg : mg);
  const int tap = r / cin, ci = r - tap * cin;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  const bool r_ok = r < R;
  int ph[GA], pw[GA];
#pragma unroll
  for (int j = 0; j < GA; ++j) {
    const int q = (p_begin + kk0 + j * KS) % HW;
    ph[j] = q / W;
    pw[j] = q - (q / W) * W;
  }

  auto load = [&](int chunk, int st) {
    const int p0 = p_begin + chunk * BK;
    float* as = As + st * BK * LDA;
    float* bs = Bs + st * BK * LDB;
#pragma unroll
    for (int j = 0; j < GA; ++j) {
      const int kk = kk0 + j * KS, p = p0 + kk;
      const int hs = ph[j] + dy, ws = pw[j] + dx;
      const bool ok = r_ok && p < p_end && hs >= 0 && hs < H && ws >= 0 && ws < W;
      const float* src = ok ? a.src + (static_cast<size_t>(p + dy * W + dx) * cin + ci)
                            : a.src;
      float* dst = as + kk * LDA + (kVec ? 4 * mg : mg);
      if constexpr (kVec) cp_async16(dst, src, ok);
      else cp_async4(dst, src, ok);
      advance_pixel(ph[j], pw[j], BK, H, W);
    }
    constexpr int NB = kVec ? BK * BN / 4 : BK * BN;
    for (int e = tid; e < NB; e += NT) {
      const int kk = kVec ? e / (BN / 4) : e / BN;
      const int n = kVec ? 4 * (e - kk * (BN / 4)) : e - kk * BN;
      const int p = p0 + kk, co = n0 + n;
      const bool ok = p < p_end && co < cout;
      const float* src = ok ? a.dy + static_cast<size_t>(p) * cout + co : a.dy;
      if constexpr (kVec) cp_async16(bs + kk * LDB + n, src, ok);
      else cp_async4(bs + kk * LDB + n, src, ok);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  // the TF32 instantiation's warp tile, the lane's fragment row and
  // column (fg, fq), and its accumulators
  using TW = Tf32Warps<BM, BN, NT>;
  [[maybe_unused]] const int fg = (tid & 31) >> 2, fq = tid & 3;
  [[maybe_unused]] const int wm0 = (tid / 32 / TW::WARPS_N) * TW::WM;
  [[maybe_unused]] const int wn0 = (tid / 32 % TW::WARPS_N) * TW::WN;
  [[maybe_unused]] float d[TW::MI][TW::NJ][4];
  if constexpr (kTf32) {
#pragma unroll
    for (int mi = 0; mi < TW::MI; ++mi)
#pragma unroll
      for (int nj = 0; nj < TW::NJ; ++nj)
#pragma unroll
        for (int r = 0; r < 4; ++r) d[mi][nj][r] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nchunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    {
      const int nc = c + ST - 1;
      if (nc < nchunks) load(nc, nc % ST);
      cp_async_commit();
    }
    const float* as = As + (c % ST) * BK * LDA;
    const float* bs = Bs + (c % ST) * BK * LDB;
    if constexpr (kTf32) {
      // A (k-major: pixel rows of (tap, ci) columns, read as rows wm0 + 16 mi
      // + g of Aᵀ) and B as TF32 fragments, each rounded once as it is built
#pragma unroll
      for (int k0 = 0; k0 < BK; k0 += 8) {
        mma_k8_tf32(
            d,
            [&](int mi, unsigned(&f)[4]) {
              const float* p = as + (k0 + fq) * LDA + wm0 + 16 * mi + fg;
              f[0] = tf32_bits(p[0]);
              f[1] = tf32_bits(p[8]);
              f[2] = tf32_bits(p[4 * LDA]);
              f[3] = tf32_bits(p[4 * LDA + 8]);
            },
            [&](int nj, unsigned(&f)[2]) {
              const float* p = bs + (k0 + fq) * LDB + wn0 + 8 * nj + fg;
              f[0] = tf32_bits(p[0]);
              f[1] = tf32_bits(p[4 * LDB]);
            });
      }
      continue;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk * LDA + ty + i * (BM / TM)];
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * BN + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * BN + BN / 2 + tx * 4);
      const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  if constexpr (kTf32) {  // the fragments into the FFMA layout, via the ring
    constexpr int LDC = BN + 4;
    __syncthreads();
    stage_tf32(d, As, LDC, wm0, wn0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = As[(ty + i * (BM / TM)) * LDC + out_col<BN>(tx, j)];
  }

  float* part = a.part + static_cast<size_t>(blockIdx.z) * 9 * (cin + 1) * cout;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rr = r0 + ty + i * (BM / TM);
    if (rr >= R) continue;
    const int t = rr / cin;
    const size_t row = static_cast<size_t>(t) * (cin + 1) + (rr - t * cin);
    if constexpr (kVec) {  // two float4 read-add-writes a row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = n0 + h * (BN / 2) + tx * 4;
        if (co >= cout) continue;
        float4* q = reinterpret_cast<float4*>(part + row * cout + co);
        float4 v = *q;
        v.x += acc[i][4 * h];
        v.y += acc[i][4 * h + 1];
        v.z += acc[i][4 * h + 2];
        v.w += acc[i][4 * h + 3];
        *q = v;
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + out_col<BN>(tx, j);
      if (co < cout) part[row * cout + co] += acc[i][j];
    }
  }
}

constexpr int kTimeThreads = 1024;  // threads of wgrad_time_kernel

// The time channel's rows of a weight gradient's partial slot. Its value s
// is a constant, so row (tap, cin) is s · Σ dy[p, :] over the split's pixels
// whose source p + d_tap lies in the image: all the pixels, less those on
// the image border rows and columns the tap's source leaves, plus the
// corner counted twice. One block per split; thread (lane, co) takes every
// L-th pixel (L = kTimeThreads / cout lanes) into nine sums (all, top,
// bottom, left, right rows and the four corners); the lanes' sums are added
// in lane order. Needs cout <= kTimeThreads. kTf32: the sums of dy rounded
// to TF32 (the reference's product of the tap mask, exact, and dy at the
// gradients' tier).
template <bool kTf32>
static __global__ void __launch_bounds__(kTimeThreads) wgrad_time_kernel(WgradArgs a) {
  __shared__ float red[kTimeThreads * 9];
  const int cout = a.cout, cin = a.cin, tid = threadIdx.x;
  const int L = kTimeThreads / cout, lane = tid / cout, co = tid - lane * cout;
  const int H = a.H, W = a.W, HW = H * W, M = a.B * HW;
  const int p_begin = blockIdx.x * a.rows_per_split;
  const int p_end = min(M, p_begin + a.rows_per_split);
  float acc[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) acc[k] = 0.f;
  if (lane < L) {
    const int q = (p_begin + lane) % HW;
    int h = q / W, w = q - (q / W) * W;
    constexpr int U = 8;  // pixels whose loads are issued together
    for (int p0 = p_begin + lane; p0 < p_end; p0 += U * L) {
      float vs[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u * L;
        vs[u] = p < p_end ? a.dy[static_cast<size_t>(p) * cout + co] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (p0 + u * L >= p_end) break;
        const float v = kTf32 ? to_tf32(vs[u]) : vs[u];
        acc[0] += v;
        if (h == 0) {
          acc[1] += v;
          if (w == 0) acc[5] += v;
          if (w == W - 1) acc[6] += v;
        }
        if (h == H - 1) {
          acc[2] += v;
          if (w == 0) acc[7] += v;
          if (w == W - 1) acc[8] += v;
        }
        if (w == 0) acc[3] += v;
        if (w == W - 1) acc[4] += v;
        advance_pixel(h, w, L, H, W);
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) red[(lane * 9 + k) * cout + co] = acc[k];
  }
  __syncthreads();
  if (tid >= cout) return;
  float sum[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    sum[k] = 0.f;
    for (int l = 0; l < L; ++l) sum[k] += red[(l * 9 + k) * cout + tid];
  }
  const float s = a.sc[0] + a.c * a.sc[1];
  float* part = a.part + static_cast<size_t>(blockIdx.x) * 9 * (cin + 1) * cout;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int dy = t / 3 - 1, dx = t % 3 - 1;
    float v = sum[0];
    if (dy < 0) v -= sum[1];
    if (dy > 0) v -= sum[2];
    if (dx < 0) v -= sum[3];
    if (dx > 0) v -= sum[4];
    if (dy < 0 && dx < 0) v += sum[5];
    if (dy < 0 && dx > 0) v += sum[6];
    if (dy > 0 && dx < 0) v += sum[7];
    if (dy > 0 && dx > 0) v += sum[8];
    part[(static_cast<size_t>(t) * (cin + 1) + cin) * cout + tid] += s * v;
  }
}

template <int BN, int TM, bool kVec, bool kTf32>
static inline cudaError_t launch_wgrad_gemm(const WgradArgs& a, int splits,
                                            cudaStream_t st) {
  constexpr int BM = kWgradBM;
  auto kernel = wgrad_gemm_kernel<BM, BN, TM, kConvBK, kConvST, kVec, kTf32>;
  const size_t smem =
      wgrad_smem_floats<BM, BN, kConvBK, kConvST, kTf32>() * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(9 * a.cin, BM), cdiv(a.cout, BN), splits);
  kernel<<<grid, (BM / TM) * (BN / 8), smem, st>>>(a);
  return cudaGetLastError();
}

template <bool kTf32>
static inline cudaError_t launch_wgrad_at(const WgradArgs& a, int splits, cudaStream_t st) {
  if (a.cout > kTimeThreads) return cudaErrorInvalidValue;
  const bool vec = a.cin % 4 == 0 && a.cout % 4 == 0 && aligned16(a.src) &&
                   aligned16(a.dy) && aligned16(a.part);
  cudaError_t err;
  if (a.cout <= 8)
    err = vec ? launch_wgrad_gemm<8, 1, true, kTf32>(a, splits, st)
              : launch_wgrad_gemm<8, 1, false, kTf32>(a, splits, st);
  else
    err = vec ? launch_wgrad_gemm<64, 8, true, kTf32>(a, splits, st)
              : launch_wgrad_gemm<64, 8, false, kTf32>(a, splits, st);
  if (err != cudaSuccess) return err;
  wgrad_time_kernel<kTf32><<<splits, kTimeThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// dW of one conv into its partial slots: the GEMM over the image channels,
// then the time channel's rows; tf32: at the TF32 tier.
static inline cudaError_t launch_wgrad(const WgradArgs& a, int splits, cudaStream_t st,
                                       bool tf32) {
  return tf32 ? launch_wgrad_at<true>(a, splits, st) : launch_wgrad_at<false>(a, splits, st);
}

}  // namespace conv
}  // namespace lrnde
