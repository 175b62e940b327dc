// The Dense chain of the latent ODE a warp a row: the shared device code of
// kernel 5 (the persistent solve, chain_solve.cu) and kernel 9 (the stored
// adjoint sweep, chain_sweep.cu, whose two-level mode replays kernel 5's
// attempt through the same functions).
//
// Layout. A CTA of kChainThreads threads owns error blocks of kChainRows = 4
// consecutive batch rows (the old kernels' row blocks: block b holds rows
// 4b..4b + 3), and warp r of the CTA owns row r of each. The warp carries
// its row through the stage inputs, the leading tanh and the L layers with
// __syncwarp between passes; the CTA synchronises only to sum a block's
// error and around the commit. A CTA keeps the chain's weights and its
// rows' state (u, the stage derivatives k1..k7, the candidate u_new) in
// shared memory for the whole launch; an accepted attempt swaps u with
// u_new and k1 with k7 instead of copying.
//
// Bitwise the kernels they replaced (a CTA of 256 threads a row block,
// every pass CTA-wide, the state in global memory):
//  - a layer's output o of a row is kChainAcc = 4 interleaved FFMA
//    accumulators over its input k in increasing k, added (0+1)+(2+3), then
//    the bias, then tanh (chain.cuh::chain_forward), whichever lane sums it;
//  - the stage inputs, ũ, the scaled residuals and the dense output are
//    elementwise, written with the old expressions in the old shapes (the
//    compiled contraction of a sum of products depends on them);
//  - the error norm is the old one: a block's ≤ 4F squared residuals as the
//    old 256 threads summed them (thread t's fmaf chain over elements t,
//    t + 256, ..., then block_sum<256>'s tree), one warp emulating the 256
//    threads (block_error), then the blocks' partials in block order
//    (solve.cuh::ordered_slot_sum) after a grid barrier.
// So the outputs, the step counts and the recordings keep every bit.
//
// The TF32 tier (the reference's 'default'; warp_chain_tf32, chain_attempt
// <true>): a warp's row is one column of mma.sync m16n8k8 tiles, each
// layer's outputs in m-tiles of 16 on the warp, one k-chain an output in
// order, the A operands from fragment copies of W_lᵀ rounded to TF32 once
// at load (chain_frags), the row's activations rounded as they are read;
// the bias and tanh FP32. One live column of eight keeps kernel 5's blocks,
// its warp a row and its error sums, and with them kernel 9's replay of
// kernel 5's attempt (the same function): an output's bits depend only on
// its own row.
#pragma once

#include "chain.cuh"
#include "solve.cuh"
#include "tf32.cuh"
#include "tsit5_bwd.cuh"

namespace lrnde {

constexpr int kChainRows = 4;                   // rows of an error block
constexpr int kChainThreads = 32 * kChainRows;  // a warp a row
constexpr int kChainOldThreads = 256;  // block_sum's width in the old kernels

using ChainNet = DenseChainT<kChainRows, kChainThreads, false>;

// Floats of a warp's activation buffer: the widest layer, rounded up to 4
// (16-byte rows for the float4 reads along k).
template <int R, int T, bool TR>
__host__ __device__ inline int chain_act_width(const DenseChainT<R, T, TR>& w) {
  return (w.maxw + 3) & ~3;
}

// Floats of one error block's resident state: [9][kChainRows][F].
__host__ __device__ inline size_t chain_block_floats(int F) {
  return 9 * static_cast<size_t>(kChainRows) * F;
}

// A leading dimension of n floats: a multiple of 4 whose quotient by 4 is
// odd, so the 16-byte reads of 8 consecutive lanes at one column of 8
// consecutive rows fall in distinct banks.
__host__ __device__ inline int chain_ld(int n) {
  const int q = (n + 3) / 4;
  return 4 * (q % 2 == 1 ? q : q + 1);
}

// The weights in shared memory. The forward of layer l reads W_lᵀ, a row
// of ld = chain_ld(d_l) floats an output unit (lane o reads its weights
// four at a time), at fwd[l], with b_l after it; kernel 9's transpose reads
// W_l itself, a row of chain_ld(d_{l+1}) floats an input unit, at rev[l].
struct ChainLayout {
  int fwd[kChainMaxLayers];
  int rev[kChainMaxLayers];
  int n_fwd, n_rev;  // floats of each part
};

template <int R, int T, bool TR>
__host__ __device__ inline ChainLayout chain_layout(
    const DenseChainT<R, T, TR>& w) {
  ChainLayout c;
  c.n_fwd = c.n_rev = 0;
  for (int l = 0; l < w.L; ++l) {
    const int din = w.dims[l], dout = w.dims[l + 1];
    c.fwd[l] = c.n_fwd;
    c.n_fwd += dout * chain_ld(din) + ((dout + 3) & ~3);
    c.rev[l] = c.n_rev;
    c.n_rev += din * chain_ld(dout);
  }
  return c;
}

// Each layer's (d_l, d_{l+1}, ChainLayout::fwd[l], ChainLayout::rev[l]) in
// shared memory, read with one 16-byte load a layer, the next layer's ahead
// of the current one's sums (indexed loads from the kernel's parameters
// would hold up the layer's first weight loads).
struct ChainMeta {
  int4 layer[kChainMaxLayers + 1];
  int2 stash[kChainMaxLayers + 1];  // kernel 9: a_l's and dz_l's offsets
};

// Copy the weights into shared memory: W_lᵀ and b_l (the forward), and
// with rev, W_l (the transpose); the padding is zero. Also fills meta.
__device__ inline void load_chain_weights(const ChainNet& w,
                                          const ChainLayout& lay, float* fwd,
                                          float* rev, ChainMeta& meta) {
  for (int l = threadIdx.x; l <= kChainMaxLayers; l += kChainThreads)
    meta.layer[l] = l < w.L ? make_int4(w.dims[l], w.dims[l + 1], lay.fwd[l],
                                        lay.rev[l])
                            : make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < lay.n_fwd; i += kChainThreads) fwd[i] = 0.f;
  if (rev != nullptr)
    for (int i = threadIdx.x; i < lay.n_rev; i += kChainThreads) rev[i] = 0.f;
  __syncthreads();
  for (int l = 0; l < w.L; ++l) {
    const int din = w.dims[l], dout = w.dims[l + 1];
    const int ldk = chain_ld(din), ldo = chain_ld(dout);
    float* t = fwd + lay.fwd[l];
    for (int e = threadIdx.x; e < din * dout; e += kChainThreads) {
      const int k = e / dout, o = e - k * dout;
      const float v = __ldg(w.wp[l] + e);
      t[o * ldk + k] = v;
      if (rev != nullptr) rev[lay.rev[l] + k * ldo + o] = v;
    }
    for (int o = threadIdx.x; o < dout; o += kChainThreads)
      t[dout * ldk + o] = __ldg(w.bp[l] + o);
  }
}

// Float4 pairs a dot product loads into registers before it sums them, so
// that several shared-memory round trips overlap.
constexpr int kDotChunk = 5;

// fmaf(x[k], w_i[k], acc_i[k mod 4]) over k < n, in increasing k, for the
// NW rows w_i, reading 16-byte-aligned x and w_i four floats at a time
// (x's loads shared by the rows), then each row's four accumulators added
// (0+1)+(2+3) into out[i]: a layer's sum (chain.cuh::chain_forward) or its
// transpose's.
template <int NW>
__device__ inline void chain_dots(const float* x, const float* const (&w)[NW],
                                  int n, float (&out)[NW]) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float a[NW][4];
#pragma unroll
  for (int i = 0; i < NW; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
  const int n4 = n >> 2;
  auto sum = [](const float4& xv, const float4& wv, float (&acc)[4]) {
    acc[0] = fmaf(xv.x, wv.x, acc[0]);
    acc[1] = fmaf(xv.y, wv.y, acc[1]);
    acc[2] = fmaf(xv.z, wv.z, acc[2]);
    acc[3] = fmaf(xv.w, wv.w, acc[3]);
  };
  int c = 0;
  for (; c + kDotChunk <= n4; c += kDotChunk) {
    float4 xv[kDotChunk], wv[NW][kDotChunk];
#pragma unroll
    for (int j = 0; j < kDotChunk; ++j) {
      xv[j] = x4[c + j];
#pragma unroll
      for (int i = 0; i < NW; ++i)
        wv[i][j] = reinterpret_cast<const float4*>(w[i])[c + j];
    }
#pragma unroll
    for (int j = 0; j < kDotChunk; ++j)
#pragma unroll
      for (int i = 0; i < NW; ++i) sum(xv[j], wv[i][j], a[i]);
  }
  for (; c < n4; ++c) {
    const float4 xv = x4[c];
#pragma unroll
    for (int i = 0; i < NW; ++i)
      sum(xv, reinterpret_cast<const float4*>(w[i])[c], a[i]);
  }
  const int r = n & 3;
  if (r != 0) {
    const float4 xv = x4[n4];
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const float4 wv = reinterpret_cast<const float4*>(w[i])[n4];
      a[i][0] = fmaf(xv.x, wv.x, a[i][0]);
      if (r > 1) a[i][1] = fmaf(xv.y, wv.y, a[i][1]);
      if (r > 2) a[i][2] = fmaf(xv.z, wv.z, a[i][2]);
    }
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) out[i] = (a[i][0] + a[i][1]) + (a[i][2] + a[i][3]);
}

__device__ inline float chain_dot(const float* x, const float* w, int n) {
  const float* const ws[1] = {w};
  float out[1];
  chain_dots<1>(x, ws, n, out);
  return out[0];
}

// One row's state in a block: the nine buffers through the swap parity.
struct ChainRow {
  float* u;
  float* k[7];
  float* unew;
};

__device__ inline ChainRow chain_row(float* block, int F, int r, int par) {
  auto buf = [&](int b) { return block + (b * kChainRows + r) * F; };
  ChainRow p;
  p.u = buf(par ? 8 : 0);
  p.unew = buf(par ? 0 : 8);
  p.k[0] = buf(par ? 7 : 1);
  for (int j = 1; j < 6; ++j) p.k[j] = buf(j + 1);
  p.k[6] = buf(par ? 1 : 7);
  return p;
}

// One evaluation of the chain for one row by a warp, a_0 in act(0): the L
// layers, lane o computing output o (and o + 32, ...) of each as
// chain_forward does (chain_dots over W_lᵀ's row o), so the same bits. a_l
// goes to act(l) for 0 < l < L and a_L to out. The caller __syncwarp()s
// after a_0 is written; this returns after a __syncwarp.
template <typename Act>
__device__ inline void warp_chain(const ChainNet& w, const ChainMeta& meta,
                                  const float* fwd, Act act, float* out,
                                  int lane) {
  static_assert(kChainAcc == 4, "chain_dots' four accumulators");
  const int L = w.L;
  const unsigned int acts = w.acts;
  int4 m = meta.layer[0];
  for (int l = 0; l < L; ++l) {
    const int din = m.x, dout = m.y, ldk = chain_ld(din);
    const float* Wt = fwd + m.z;
    m = meta.layer[l + 1];
    const float* bl = Wt + dout * ldk;
    const float* ain = act(l);
    float* aout = l + 1 < L ? act(l + 1) : out;
    const bool tanh_l = (acts >> l) & 1u;
    if (dout > 32 && dout <= 64) {
      // two outputs a lane, their sums and tanh interleaved: lanes past the
      // second output repeat the layer's last one and store nothing
      const int o1 = min(lane + 32, dout - 1);
      const float* const ws[2] = {Wt + lane * ldk, Wt + o1 * ldk};
      float z[2];
      chain_dots<2>(ain, ws, din, z);
      float z0 = z[0] + bl[lane];
      float z1 = z[1] + bl[o1];
      if (tanh_l) {
        z0 = tanhf(z0);
        z1 = tanhf(z1);
      }
      aout[lane] = z0;
      if (lane + 32 < dout) aout[o1] = z1;
    } else {
      for (int o = lane; o < dout; o += 32) {
        float z = chain_dot(ain, Wt + o * ldk, din);
        z = z + bl[o];
        if (tanh_l) z = tanhf(z);
        aout[o] = z;
      }
    }
    __syncwarp();
  }
}

// Floats of the chain's fragment copies: the forward's A = W_lᵀ (d_{l+1} ×
// d_l), layer after layer (transposed: the transpose's A = W_l, d_l ×
// d_{l+1}).
template <int R, int T, bool TR>
__host__ __device__ inline size_t chain_frag_floats(
    const DenseChainT<R, T, TR>& w, bool transposed = false) {
  size_t n = 0;
  for (int l = 0; l < w.L; ++l)
    n += transposed ? frag_floats(w.dims[l], w.dims[l + 1])
                    : frag_floats(w.dims[l + 1], w.dims[l]);
  return n;
}

// Stage the fragment copies at frag (16-byte aligned) from the weights in
// global memory: the forward's (A[o][k] = W_l[k][o]) or the transpose's
// (A[k][o] = W_l[k][o]). The caller synchronises.
__device__ inline void stage_chain_frags(const ChainNet& w, float* frag,
                                         bool transposed) {
  for (int l = 0; l < w.L; ++l) {
    const int din = w.dims[l], dout = w.dims[l + 1];
    uint4* dst = reinterpret_cast<uint4*>(frag);
    if (transposed) {
      stage_frag(dst, w.wp[l], din, dout, dout, 1);
      frag += frag_floats(din, dout);
    } else {
      stage_frag(dst, w.wp[l], dout, din, 1, dout);
      frag += frag_floats(dout, din);
    }
  }
}

// warp_chain at the TF32 tier, the same contract: each layer's products on
// the warp's mma.sync tiles (the row the one live column) from the
// forward's fragment copies at frag, then the bias and tanh.
template <typename Act>
__device__ inline void warp_chain_tf32(const ChainNet& w,
                                       const ChainMeta& meta,
                                       const float* fwd, const float* frag,
                                       Act act, float* out) {
  const int L = w.L;
  const unsigned int acts = w.acts;
  for (int l = 0; l < L; ++l) {
    const int4 m = meta.layer[l];
    const int din = m.x, dout = m.y;
    const float* bl = fwd + m.z + dout * chain_ld(din);
    const float* ain = act(l);
    float* aout = l + 1 < L ? act(l + 1) : out;
    const bool tanh_l = (acts >> l) & 1u;
    const uint4* fr = reinterpret_cast<const uint4*>(frag);
    for (int mt = 0; mt < frag_mtiles(dout); ++mt) {
      float d[4];
      tile_tf32(fr, mt, din, ain, 0, 1, d);
      tile_put<1>(d, mt, dout, 1, [&](int, int o, float z) {
        z = z + bl[o];
        if (tanh_l) z = tanhf(z);
        aout[o] = z;
      });
    }
    frag += frag_floats(dout, din);
    __syncwarp();
  }
}

// One evaluation of the row at the tier kTf32 names: warp_chain_tf32 from
// the forward's fragment copies at frag, or warp_chain.
template <bool kTf32, typename Act>
__device__ inline void warp_chain_at(const ChainNet& w, const ChainMeta& meta,
                                     const float* fwd, const float* frag,
                                     Act act, float* out, int lane) {
  if constexpr (kTf32)
    warp_chain_tf32(w, meta, fwd, frag, act, out);
  else
    warp_chain(w, meta, fwd, act, out, lane);
}

// The attribution clock of a clocked instantiation: CTA 0's %globaltimer
// nanoseconds summed by phase (N phases) in shared memory, recorded by
// thread 0 after a warp barrier (warp) or a CTA barrier (cta). Off, every
// call is empty.
constexpr int kChainClockCtas = 1024;

template <bool kOn, int N>
struct ChainClock {
  unsigned long long* acc;  // N sums, then the last reading (kOn)
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ bool owner() const { return blockIdx.x == 0 && threadIdx.x == 0; }
  __device__ void record(int phase) {
    if (owner()) {
      const unsigned long long t = now();
      if (phase >= 0) acc[phase] += t - acc[N];
      acc[N] = t;
    }
  }
  __device__ void start() {
    if constexpr (kOn) {
      if (owner())
        for (int i = 0; i < N; ++i) acc[i] = 0;
      record(-1);
    }
  }
  __device__ void warp(int phase) {
    if constexpr (kOn) {
      __syncwarp();
      record(phase);
    }
  }
  __device__ void cta(int phase) {
    if constexpr (kOn) {
      __syncthreads();
      record(phase);
    }
  }
  // per-phase nanoseconds, then the count (attempts or steps), then for
  // each of the first kChainClockCtas CTAs its SM's index + 1
  __device__ void write(unsigned long long* out, int count) const {
    if constexpr (kOn) {
      if (owner()) {
        for (int i = 0; i < N; ++i) out[i] = acc[i];
        out[N] = static_cast<unsigned long long>(count);
      }
      if (threadIdx.x == 0 && blockIdx.x < kChainClockCtas) {
        unsigned int sm;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
        out[N + 1 + blockIdx.x] = sm + 1ull;
      }
    }
  }
};

// The phases of kernel 5's attempt (and of kernel 9's replayed attempts):
// warp 0's stage inputs, layer passes and scaled residuals, the CTA barrier
// before the error sum (the other rows' lag), warp 0's error tree, the grid
// barrier, the slot sum, and the controller with the commit, the dense
// output and the recording.
enum ChainSolvePhase {
  kCsStage, kCsLayers, kCsResidual, kCsErrorWait, kCsErrorTree, kCsBarrier,
  kCsSlotSum, kCsCommit, kCsPhases
};

// Stage input u + dt·(a[0]·k[0] + ... + a[N-1]·k[N-1]) of one row
// (tdmlp.cuh::stage_input's arithmetic in its unrolled shape), through the
// leading tanh into a0; also into keep when it is not null.
template <int N>
__device__ inline void warp_stage_input(const ChainNet& w, const ChainRow& p,
                                        const float (&a)[N], float dt,
                                        float* a0, float* keep, int lane) {
  for (int c = lane; c < w.F; c += 32) {
    float acc = a[0] * p.k[0][c];
#pragma unroll
    for (int j = 1; j < N; ++j) acc = acc + a[j] * p.k[j][c];
    const float v = p.u[c] + dt * acc;
    if (keep != nullptr) keep[c] = v;
    a0[c] = w.lead ? tanhf(v) : v;
  }
  __syncwarp();
}

// One Tsit5 step of one row by its warp (tdmlp.cuh::tsit5_rows): the six
// stage evaluations into k2..k7, u_new, and the row's scaled residuals
// ũ / (atol + max(|u|, |u_new|)·rtol) into res. act holds the warp's two
// ping-pong activation buffers of aw floats. kTf32: the evaluations at the
// TF32 tier from the fragment copies at frag.
template <bool kTf32, typename Clock>
__device__ inline void warp_step(const ChainNet& w, const ChainMeta& meta,
                                 const float* W, const ChainRow& p, float* act,
                                 int aw,
                                 float dt, float atol, float rtol, float* res,
                                 int lane, Clock& clk, const float* frag) {
  auto acts = [&](int l) { return act + (l & 1) * aw; };
  {
    const float a[1] = {A21};
    warp_stage_input(w, p, a, dt, act, nullptr, lane);
  }
  clk.warp(kCsStage);
  warp_chain_at<kTf32>(w, meta, W, frag, acts, p.k[1], lane);
  clk.warp(kCsLayers);
  {
    const float a[2] = {A31, A32};
    warp_stage_input(w, p, a, dt, act, nullptr, lane);
  }
  clk.warp(kCsStage);
  warp_chain_at<kTf32>(w, meta, W, frag, acts, p.k[2], lane);
  clk.warp(kCsLayers);
  {
    const float a[3] = {A41, A42, A43};
    warp_stage_input(w, p, a, dt, act, nullptr, lane);
  }
  clk.warp(kCsStage);
  warp_chain_at<kTf32>(w, meta, W, frag, acts, p.k[3], lane);
  clk.warp(kCsLayers);
  {
    const float a[4] = {A51, A52, A53, A54};
    warp_stage_input(w, p, a, dt, act, nullptr, lane);
  }
  clk.warp(kCsStage);
  warp_chain_at<kTf32>(w, meta, W, frag, acts, p.k[4], lane);
  clk.warp(kCsLayers);
  {
    const float a[5] = {A61, A62, A63, A64, A65};
    warp_stage_input(w, p, a, dt, act, nullptr, lane);
  }
  clk.warp(kCsStage);
  warp_chain_at<kTf32>(w, meta, W, frag, acts, p.k[5], lane);
  clk.warp(kCsLayers);
  {
    const float a[6] = {A71, A72, A73, A74, A75, A76};
    warp_stage_input(w, p, a, dt, act, p.unew, lane);
  }
  clk.warp(kCsStage);
  warp_chain_at<kTf32>(w, meta, W, frag, acts, p.k[6], lane);
  clk.warp(kCsLayers);
  const float* const* k = p.k;
  for (int c = lane; c < w.F; c += 32) {
    float acc = BT1 * k[0][c];
    acc = acc + BT2 * k[1][c];
    acc = acc + BT3 * k[2][c];
    acc = acc + BT4 * k[3][c];
    acc = acc + BT5 * k[4][c];
    acc = acc + BT6 * k[5][c];
    acc = acc + BT7 * k[6][c];
    const float ut = dt * acc;
    res[c] = ut / (atol + fmaxf(fabsf(p.u[c]), fabsf(p.unew[c])) * rtol);
  }
  clk.warp(kCsResidual);
}

// The error partial of one block from its n scaled residuals (row-major),
// as the old kernel's 256 threads summed them (tdmlp.cuh::
// warp_block_sum_sq). The sum is in lane 0.
__device__ inline float block_error(const float* res, int n, int lane) {
  return warp_block_sum_sq<kChainOldThreads>(res, n, lane);
}

// What an attempt needs of a CTA: its shared buffers and its blocks.
struct ChainCta {
  const float* W;  // the forward's weights (ChainLayout::fwd)
  const float* frag;  // the TF32 tier: the forward's fragment copies
  float* act;      // [kChainRows][2][aw] the warps' activations
  int aw;
  float* state;    // [nb][9][kChainRows][F] the blocks' rows
  float* res;      // [nb][kChainRows][F] their scaled residuals
  int first, nb;   // the CTA's blocks: first .. first + nb - 1
  int n_blk, B;
};

__device__ inline int block_rows(const ChainCta& c, int j) {
  return min(kChainRows, c.B - (c.first + j) * kChainRows);
}

// One attempt over the whole batch with step dt: every CTA runs the Tsit5
// step of its blocks' rows (a warp a row), sums each block's error
// (block_error) into the block's slot, waits at the grid barrier and sums
// the slots in block order. Returns the scaled error norm in thread 0 (0
// elsewhere). The slots are double-buffered by the parity of the barrier
// count, so a CTA that runs ahead into the next attempt never overwrites
// slots another is still summing. kTf32: the steps at the TF32 tier, from
// the forward's fragment copies at c.frag.
template <bool kTf32, typename Clock>
__device__ inline float chain_attempt(const ChainNet& w,
                                      const ChainMeta& meta,
                                      const ChainCta& c, int par, float dt,
                                      float atol,
                                      float rtol, float inv_n, float* slots,
                                      unsigned int* barrier,
                                      unsigned int& epoch, Clock& clk) {
  const int F = w.F, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const s = slots + (epoch & 1u) * c.n_blk;
  for (int j = 0; j < c.nb; ++j) {
    const int nrows = block_rows(c, j);
    float* const res = c.res + static_cast<size_t>(j) * kChainRows * F;
    if (warp < nrows)
      warp_step<kTf32>(
          w, meta, c.W,
          chain_row(c.state + j * chain_block_floats(F), F, warp, par),
          c.act + warp * 2 * c.aw, c.aw, dt, atol, rtol, res + warp * F, lane,
          clk, c.frag);
    clk.cta(kCsErrorWait);
    __syncthreads();
    if (warp == 0) {
      const float err = block_error(res, nrows * F, lane);
      if (lane == 0) __stcg(s + c.first + j, err);
    }
    clk.warp(kCsErrorTree);
  }
  ++epoch;
  grid_barrier(barrier, epoch * gridDim.x);
  clk.cta(kCsBarrier);
  const float err_sq = ordered_slot_sum<kChainThreads>(s, c.n_blk);
  clk.cta(kCsSlotSum);
  return threadIdx.x == 0 ? sqrtf(err_sq * inv_n) : 0.f;
}

// CTAs of a kernel of `threads` threads resident on one SM at a shared
// memory size, remembered per (kernel, size): the query costs host time,
// the launches repeat. The kernel's opt-in to dynamic shared memory only
// grows (a kernel has one limit, and a smaller chain must not lower it
// below a larger one's).
inline cudaError_t chain_occupancy(const void* kernel, size_t bytes,
                                   int* per_sm,
                                   int threads = kChainThreads) {
  struct Entry {
    const void* fn;
    size_t bytes;
    int per_sm;
  };
  struct Granted {
    const void* fn;
    size_t bytes;
  };
  static Entry cache[8] = {};
  static Granted granted[32] = {};  // every kernel that asks
  static int next = 0;
  for (const Entry& e : cache)
    if (e.fn == kernel && e.bytes == bytes) {
      *per_sm = e.per_sm;
      return cudaSuccess;
    }
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  *per_sm = 0;
  if (bytes + fa.sharedSizeBytes <= 232448) {  // 227 KB a CTA on Hopper
    Granted* g = nullptr;
    for (Granted& e : granted)
      if (e.fn == kernel || (g == nullptr && e.fn == nullptr)) {
        g = &e;
        if (e.fn == kernel) break;
      }
    if (g == nullptr) return cudaErrorInvalidValue;
    if (g->fn != kernel) *g = Granted{kernel, 48 * 1024};
    if (bytes > g->bytes) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(bytes));
      if (err != cudaSuccess) return err;
      g->bytes = bytes;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        threads, bytes);
    if (err != cudaSuccess) return err;
  }
  cache[next] = Entry{kernel, bytes, *per_sm};
  next = (next + 1) % 8;
  return cudaSuccess;
}

// The grid of a whole-grid chain kernel: CTAs of kChainThreads threads,
// each owning J consecutive error blocks, J the least (up to max_J) that
// lets ceil(n_blk / J) CTAs be resident at once at the shared memory
// smem(J) floats. Returns cudaErrorCooperativeLaunchTooLarge where none
// can.
template <typename Smem>
inline cudaError_t chain_grid(const void* kernel, int n_blk, Smem smem,
                              int max_J, int* J_out, int* grid_out) {
  int dev = 0, n_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  for (int J = 1; J <= max_J; ++J) {
    int per_sm = 0;
    err = chain_occupancy(kernel, smem(J) * sizeof(float), &per_sm);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) break;  // larger J only needs more shared memory
    const int grid = (n_blk + J - 1) / J;
    if (grid <= per_sm * n_sm) {
      *J_out = J;
      *grid_out = grid;
      return cudaSuccess;
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

// Launch a whole-grid chain kernel cooperatively (its grid barrier needs
// every CTA resident).
template <typename Args>
inline cudaError_t launch_chain_cooperative(const void* kernel, Args* args,
                                            int grid, size_t smem_floats,
                                            cudaStream_t stream) {
  void* kargs[] = {args};
  cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kChainThreads), kargs,
      smem_floats * sizeof(float), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace lrnde
