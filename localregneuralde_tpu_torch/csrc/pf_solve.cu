// Kernel 6: the whole adaptive Tsit5 solve of the probability-flow ODE of
// the score samplers, du/dτ = ½β(t)·(u + s_θ(u, t)) with t = t1 − τ, in one
// cooperative launch, a warp a group of 4 rows (score_rows.cuh), with no
// knots and no reservoir (sampling is never differentiated).
//
// Replaces localregneuralde_tpu/ops/pallas/fused_solve.py::
// persistent_pf_solve (_make_kernel built for the ("pfode", pads, acts,
// beta_min, beta_max, t1) family, family_make_f). The TPU kernel ran
// whole-batch tiles with the lane-padded weights in VMEM; here every CTA
// keeps the unpadded score network and its rows' state (u, k1..k7, u_new)
// in shared memory for the whole launch. As in the reference, k1 and the
// Hairer initial step are computed outside the kernel.
//
// What bounds it on an H100: serial latency and shared-memory reads. At the
// demo's widths (B = 4096, F = 2, 2 -> 64 -> 64 -> 2) an attempt is 0.22
// GFLOP (3.3 µs at the FP32 peak) over 18 dependent layer passes and a
// grid-wide reduction. The first port ran every pass CTA-wide (a CTA of 128
// threads an 8-row block, 512 CTAs: a barrier after each pass, the 64 -> 2
// layer on 16 of the threads, 512 grid arrivals an attempt). Here a CTA of
// eight warps owns J 8-row error blocks (J = 4 at B = 4096: 128 CTAs, one
// an SM, 128 arrivals), each warp a 4-row group, and the warps meet only to
// sum an error block and around the commit. The 64 -> 64 pass measured as
// if a 128-bit read cost four wavefronts even where every lane reads the
// same address (PERF.md), so the weights' reads are what a layout can
// save: lane o sums outputs o and o + 32 of its four rows, the 64 -> 64
// layer from weights held in the lane's registers for the whole launch
// (only the inputs are read), the 64 -> 2 layer with each (row, output)
// item's four accumulators on four lanes (all 32 lanes busy). The six
// stages run through one copy of the evaluation: six inlined copies cost a
// quarter of the layers' time, most likely in the instruction cache
// (PfMain; lrnde_pf_solve_probe runs the other layouts chip_smoke.py's
// [pf probe] compares).
//
// Bitwise the first port: the layer sums of score_rows.cuh; the stage
// inputs, ũ, the scaled residuals and the dense output in the old
// expressions and shapes (tdmlp.cuh::stage_input and tsit5_rows, the old
// kernel's dense output, score.cuh's ½β(u + s)); an 8-row block's
// error partial as the old 128 threads summed it (tdmlp.cuh::
// warp_block_sum_sq), then the blocks' partials in block order
// (solve.cuh::ordered_slot_sum) after the grid barrier. So the outputs and
// the step counts keep every bit.
//
// The clocked instantiation (kTime) splits CTA 0's attempt by phase for
// chip_smoke.py's [pf solve attribution]; its arithmetic is the same.
//
// At the TF32 tier (PfTf32, lrnde_persistent_pf_tf32; the reference's
// 'default', which its sampler takes) each warp's four rows go through the
// layers as four of the eight columns of mma.sync m16n8k8 tiles
// (score_rows.cuh::warp_score_rows_tf32), the network's weights rounded
// once into fragment copies after the FP32 layout (which keeps the time
// rows and biases); the stage inputs, ũ, the error norm and the controller
// are the FP32 kernel's.
#include <type_traits>

#include "score_rows.cuh"

namespace lrnde {

constexpr int kPfErrorRows = 8;     // rows of an error block (one slot)
constexpr int kPfOldThreads = 128;  // block_sum's width in the first port
constexpr int kPfCtaRows = 32;      // rows a CTA's warps carry at once
// At most this many error blocks a CTA (past them a batch is refused).
constexpr int kPfMaxJ = 128;

// A layout of kernel 6: RW rows a warp, kPfCtaRows / RW warps a CTA; with
// kSplit the last layer's (two outputs) accumulators on four lanes
// (score_rows.cuh::split_layer), the other layers a lane an output; with
// kRegW the 64 -> 64 layer's weights in each lane's registers. The
// kernel's, PfMain, is the fastest of chip_smoke.py's [pf probe]. With
// kTf32 the layers run at the TF32 tier (neither registers nor the split).
template <int RW, bool kSplit, bool kRegW, bool kTf32 = false>
struct PfCfg {
  static constexpr int rows = RW;
  static constexpr int warps = kPfCtaRows / RW;
  static constexpr int threads = 32 * warps;
  static constexpr int groups = kPfErrorRows / RW;  // groups a block
  static constexpr bool split = kSplit;
  static constexpr bool tf32 = kTf32;
  using Reg = typename std::conditional<kRegW, RegW64, NoRegW>::type;
};
using PfMain = PfCfg<4, true, true>;
using PfTf32 = PfCfg<4, false, false, true>;

// The attribution phases of an attempt (CTA 0, warp 0's groups and the
// CTA's barriers): the stage inputs, the three kinds of layer pass
// (score_rows.cuh::ScorePhase), the residuals, the wait for the other
// warps, the block sums, the grid barrier, the slot sum with the
// controller, the dense output and commit.
enum PfPhase {
  kPfStage, kPfLayerIn, kPfLayerMid, kPfLayerOut, kPfResidual,
  kPfErrorWait, kPfErrorTree, kPfBarrier, kPfSlotSum, kPfCommit, kPfPhases
};

struct PfSolveArgs {
  const float* u0;
  const float* k10;
  const float* sc;      // t0, t_end, dt0
  const float* saveat;  // (n_save)
  int n_save;
  PfScore w;
  ScoreLayout lay;
  float* y;             // (B, F) y_final
  float* ys;            // (n_save, B, F)
  int* stats_i;         // naccept, nreject, done, natt
  float* stats_f;       // t_final
  float* slots;         // (2, n_blk) error-block partials
  unsigned int* barrier;  // arrival counter, zero at launch
  int B;
  int J;                // error blocks a CTA
  int max_steps;
  float rtol, atol, inv_n;  // inv_n = 1 / (B·F)
  int reg_l;            // the 64 -> 64 layer (register weights), or -1
  unsigned long long* timing;  // kTime: (kPfPhases + 1 + CTAs)
  ScoreFragLayout fl;   // the TF32 tier's fragment copies
};

// Floats of one error block's resident state, [9][kPfErrorRows][F] (u,
// k1..k7, u_new through the swap parity), and of its scaled residuals.
__host__ __device__ inline size_t pf_block_floats(int F) {
  return 10 * static_cast<size_t>(kPfErrorRows) * F;
}

// Floats of a kernel-6 CTA's dynamic shared memory at J blocks: the
// network (and at the TF32 tier its frags floats of fragment copies), each
// warp's stage-input rows and two activation buffers (the same for every
// layout: kPfCtaRows rows), the blocks' state and residuals.
__host__ __device__ inline size_t pf_smem_floats(const ScoreNet& w, int J,
                                                 int frags = 0) {
  return score_layout(w).n + frags
       + static_cast<size_t>(kPfCtaRows)
             * (score_in_width(w) + 2 * score_act_width(w))
       + J * pf_block_floats(w.F);
}

// One row's state in a block through the swap parity (chain_rows.cuh::
// chain_row at 8 rows a block).
__device__ inline ChainRow pf_row(float* block, int F, int r, int par) {
  auto buf = [&](int b) { return block + (b * kPfErrorRows + r) * F; };
  ChainRow p;
  p.u = buf(par ? 8 : 0);
  p.unew = buf(par ? 0 : 8);
  p.k[0] = buf(par ? 7 : 1);
  for (int j = 1; j < 6; ++j) p.k[j] = buf(j + 1);
  p.k[6] = buf(par ? 1 : 7);
  return p;
}

// k_{j+1} of row r (pf_row(...).k[j] without the array, for a j known only
// at run time).
__device__ inline float* pf_k(float* block, int F, int r, int par, int j) {
  const int b = j == 0 ? (par ? 7 : 1) : j == 6 ? (par ? 1 : 7) : j + 1;
  return block + (b * kPfErrorRows + r) * F;
}

// A warp's group: RW rows from row r0 of an error block, nrows of them in
// the batch.
struct PfGroup {
  float* block;  // the block's state
  float* res;    // the block's residuals
  int r0, nrows;
};

// Stage input u + dt·(a[0]·k[0] + ... + a[N-1]·k[N-1]) of the group's rows
// in tdmlp.cuh::stage_input's unrolled shape (the old kernel's compiled
// contraction: the first two products in one fused multiply-add, then one
// a term) into xs, zero past nrows; the last stage's (N = 6) also into
// u_new.
template <int RW, int N>
__device__ inline void pf_stage_input(const PfGroup& g, int F, int par,
                                      const float (&a)[N], float dt,
                                      float* xs, int xw, int lane) {
  for (int i = lane; i < RW * F; i += 32) {
    const int r = i / F, c = i - r * F;
    float v = 0.f;
    if (r < g.nrows) {
      const ChainRow p = pf_row(g.block, F, g.r0 + r, par);
      float acc = a[0] * p.k[0][c];
#pragma unroll
      for (int j = 1; j < N; ++j) acc = acc + a[j] * p.k[j][c];
      v = p.u[c] + dt * acc;
      if (N == 6) p.unew[c] = v;
    }
    xs[r * xw + c] = v;
  }
  __syncwarp();
}

// One Tsit5 step of the group's rows (tdmlp.cuh::tsit5_rows): the six
// stage evaluations into k2..k7, u_new, and the rows' scaled residuals
// ũ / (atol + max(|u|, |u_new|)·rtol) into the block's residuals.
template <typename Cfg, typename Clock>
__device__ inline void pf_group_step(
    const PfScore& w, const ScoreMeta& meta, const float* W,
    const typename Cfg::Reg& reg, const PfGroup& g, int par, float* xs,
    float* act, float t, float dt, float atol, float rtol, int lane,
    Clock& clk, const float* frag, const ScoreFragLayout& fl) {
  constexpr int RW = Cfg::rows;
  const int F = w.F, xw = score_in_width(w), aw = score_act_width(w);
  // the six stages run through one copy of the evaluation (six inlined
  // copies cost a quarter of the layers' time); each stage input keeps its
  // own unrolled shape, and the stage time t + c·dt is the old kernel's
  // contracted one, written out (the switch would let the compiler sink
  // the addition away from its product)
#pragma unroll 1
  for (int s = 0; s < 6; ++s) {
    float st;  // the stage time
    switch (s) {
      case 0: {
        const float a[1] = {A21};
        pf_stage_input<RW>(g, F, par, a, dt, xs, xw, lane);
        st = fmaf(C1, dt, t);
        break;
      }
      case 1: {
        const float a[2] = {A31, A32};
        pf_stage_input<RW>(g, F, par, a, dt, xs, xw, lane);
        st = fmaf(C2, dt, t);
        break;
      }
      case 2: {
        const float a[3] = {A41, A42, A43};
        pf_stage_input<RW>(g, F, par, a, dt, xs, xw, lane);
        st = fmaf(C3, dt, t);
        break;
      }
      case 3: {
        const float a[4] = {A51, A52, A53, A54};
        pf_stage_input<RW>(g, F, par, a, dt, xs, xw, lane);
        st = fmaf(C4, dt, t);
        break;
      }
      case 4: {
        const float a[5] = {A61, A62, A63, A64, A65};
        pf_stage_input<RW>(g, F, par, a, dt, xs, xw, lane);
        st = __fadd_rn(t, dt);
        break;
      }
      default: {
        const float a[6] = {A71, A72, A73, A74, A75, A76};
        pf_stage_input<RW>(g, F, par, a, dt, xs, xw, lane);
        st = __fadd_rn(t, dt);
        break;
      }
    }
    clk.warp(kPfStage);
    // k_{s+2} = ½β(τ)·(x + s_θ(x, τ)) at the stage time, τ = t1 − time
    const float tr = score_time(w, st);
    const float hb = __fmul_rn(0.5f, score_beta(w, tr));
    auto fin = [&](int r, int c, float z) {
      pf_k(g.block, F, g.r0 + r, par, s + 1)[c] =
          __fmul_rn(hb, __fadd_rn(xs[r * xw + c], z));
    };
    if constexpr (Cfg::tf32)
      warp_score_rows_tf32<RW>(w, meta, W, frag, fl, xs, xw, act, aw, tr,
                               g.nrows, clk, kPfLayerIn, fin);
    else
      warp_score_rows<RW, Cfg::split>(w, meta, W, xs, xw, act, aw, tr,
                                      g.nrows, lane, reg, clk, kPfLayerIn,
                                      fin);
  }
  for (int i = lane; i < g.nrows * F; i += 32) {
    const int r = i / F, c = i - r * F;
    const ChainRow p = pf_row(g.block, F, g.r0 + r, par);
    const float* const* k = p.k;
    float acc = BT1 * k[0][c];
    acc = acc + BT2 * k[1][c];
    acc = acc + BT3 * k[2][c];
    acc = acc + BT4 * k[3][c];
    acc = acc + BT5 * k[4][c];
    acc = acc + BT6 * k[5][c];
    acc = acc + BT7 * k[6][c];
    const float ut = dt * acc;
    g.res[(g.r0 + r) * F + c] =
        ut / (atol + fmaxf(fabsf(p.u[c]), fabsf(p.unew[c])) * rtol);
  }
  clk.warp(kPfResidual);
}

template <typename Cfg, bool kTime>
__global__ void __launch_bounds__(Cfg::threads)
pf_solve_kernel(PfSolveArgs a) {
  constexpr int RW = Cfg::rows, NW = Cfg::warps, NG = Cfg::groups;
  extern __shared__ float4 smem_raw[];
  __shared__ Ctl ctl;
  __shared__ ScoreMeta meta;
  __shared__ unsigned long long clk_acc[kTime ? kPfPhases + 1 : 1];
  ChainClock<kTime, kPfPhases> clk{clk_acc};
  const PfScore& w = a.w;
  const int F = w.F, B = a.B, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int xw = score_in_width(w), aw = score_act_width(w);
  float* const W = reinterpret_cast<float*>(smem_raw);
  float* const frag = W + a.lay.n;  // the TF32 tier's fragment copies
  float* const rows = frag + (Cfg::tf32 ? a.fl.n : 0);
  float* const xs = rows + warp * RW * (xw + 2 * aw);
  float* const act = xs + RW * xw;
  float* const state = rows + kPfCtaRows * (xw + 2 * aw);
  const int n_blk = (B + kPfErrorRows - 1) / kPfErrorRows;
  const int first = blockIdx.x * a.J;
  const int nb = max(0, min(a.J, n_blk - first));
  const size_t BF = static_cast<size_t>(B) * F;
  const float t_end = a.sc[1];
  load_score_weights<Cfg::threads>(w, a.lay, W, meta);
  if constexpr (Cfg::tf32) stage_score_frags(w, a.fl, frag);

  auto block_rows = [&](int j) {
    return min(kPfErrorRows, B - (first + j) * kPfErrorRows);
  };
  // this warp's groups: fn(group, its first row in the batch)
  auto each_group = [&](auto fn) {
    for (int q = warp; q < NG * nb; q += NW) {
      const int j = q / NG, r0 = (q - j * NG) * RW;
      PfGroup g;
      g.block = state + j * pf_block_floats(F);
      g.res = g.block + 9 * kPfErrorRows * F;
      g.r0 = r0;
      g.nrows = min(RW, block_rows(j) - r0);
      if (g.nrows > 0) fn(g, (first + j) * kPfErrorRows + r0);
    }
  };
  int par = 0;
  each_group([&](const PfGroup& g, int row0) {
    for (int i = lane; i < g.nrows * F; i += 32) {
      const int r = i / F, c = i - r * F;
      const ChainRow p = pf_row(g.block, F, g.r0 + r, 0);
      const size_t on = static_cast<size_t>(row0 + r) * F + c;
      const float v = a.u0[on];
      p.u[c] = v;
      p.k[0][c] = a.k10[on];
      for (int s = 0; s < a.n_save; ++s) a.ys[s * BF + on] = v;
    }
  });
  if (tid == 0) {
    ctl.t = a.sc[0];
    ctl.dt = a.sc[2];
    ctl.qold = kQoldInit;
    ctl.done = ctl.t >= t_end;
    ctl.natt = ctl.nacc = ctl.nrej = 0;
  }
  __syncthreads();
  typename Cfg::Reg reg;
  reg.l = a.reg_l;
  load_reg_weights(a.lay, W, reg, lane);

  unsigned int epoch = 0;
  clk.start();
  // ctl changes only in thread 0 after the attempt's grid barrier, which
  // every thread reaches after reading it
  while (!ctl.done && ctl.natt < a.max_steps) {
    const float t = ctl.t;
    const AttemptPlan plan = plan_attempt(t, ctl.dt, t_end);
    const float dt = plan.dt_c, t_new = plan.t_new;
    float* const slot = a.slots + (epoch & 1u) * n_blk;
    each_group([&](const PfGroup& g, int) {
      pf_group_step<Cfg>(w, meta, W, reg, g, par, xs, act, t, dt, a.atol,
                         a.rtol, lane, clk, frag, a.fl);
    });
    clk.cta(kPfErrorWait);
    __syncthreads();
    for (int j = warp; j < nb; j += NW) {
      const float* res = state + j * pf_block_floats(F)
                       + 9 * kPfErrorRows * F;
      const float e =
          warp_block_sum_sq<kPfOldThreads>(res, block_rows(j) * F, lane);
      if (lane == 0) __stcg(slot + first + j, e);
    }
    clk.warp(kPfErrorTree);
    ++epoch;
    grid_barrier(a.barrier, epoch * gridDim.x);
    clk.cta(kPfBarrier);
    const float err_sq = ordered_slot_sum<Cfg::threads>(slot, n_blk);
    if (tid == 0) {
      const float eest = sqrtf(err_sq * a.inv_n);
      const bool accept = eest <= 1.f;
      float dt_acc, dt_rej, qold_acc;
      propose(eest, dt, ctl.qold, &dt_acc, &dt_rej, &qold_acc);
      ctl.accept = accept;
      if (accept) {
        ctl.t = t_new;
        ctl.dt = dt_acc;
        ctl.qold = qold_acc;
        ctl.done = plan.is_last;
        ++ctl.nacc;
      } else {
        ctl.dt = dt_rej;
        ++ctl.nrej;
      }
      ++ctl.natt;
    }
    clk.cta(kPfSlotSum);
    __syncthreads();
    if (ctl.accept) {
      // the dense output of the saveat times this step crossed, from the
      // step-start state (the old kernel's expression); then the committed
      // state is u_new, its FSAL derivative k7
      each_group([&](const PfGroup& g, int row0) {
        for (int s = 0; s < a.n_save; ++s) {
          const float ts = a.saveat[s];
          if (!(ts > t && ts <= t_new)) continue;
          float b[7];
          interp_weights(fminf(fmaxf((ts - t) / dt, 0.f), 1.f), b);
          for (int i = lane; i < g.nrows * F; i += 32) {
            const int r = i / F, c = i - r * F;
            const ChainRow p = pf_row(g.block, F, g.r0 + r, par);
            float acc = b[0] * p.k[0][c];
#pragma unroll
            for (int j = 1; j < 7; ++j) acc = acc + b[j] * p.k[j][c];
            a.ys[s * BF + static_cast<size_t>(row0 + r) * F + c] =
                p.u[c] + dt * acc;
          }
        }
      });
      par ^= 1;
    }
    clk.cta(kPfCommit);
  }

  // y_final; saveat entries never covered by an accepted step revert to u0,
  // so a failed solve matches the loop's accept-only commits
  const float t_fin = ctl.t;
  each_group([&](const PfGroup& g, int row0) {
    for (int i = lane; i < g.nrows * F; i += 32) {
      const int r = i / F, c = i - r * F;
      const size_t on = static_cast<size_t>(row0 + r) * F + c;
      a.y[on] = pf_row(g.block, F, g.r0 + r, par).u[c];
      for (int s = 0; s < a.n_save; ++s)
        if (a.saveat[s] > t_fin) a.ys[s * BF + on] = a.u0[on];
    }
  });
  if (blockIdx.x == 0 && tid == 0) {
    a.stats_i[0] = ctl.nacc;
    a.stats_i[1] = ctl.nrej;
    a.stats_i[2] = ctl.done;
    a.stats_i[3] = ctl.natt;
    a.stats_f[0] = ctl.t;
  }
  clk.write(a.timing, ctl.natt);
}

// The grid of kernel 6 for B rows: J error blocks a CTA, the least that
// keeps the grid within one CTA an SM (fewer grid arrivals; a warp carries
// more groups past J = 4), raised until the grid is resident at the shared
// memory of J blocks. Returns cudaErrorCooperativeLaunchTooLarge where no J
// up to kPfMaxJ is.
template <typename Cfg>
static cudaError_t pf_grid(const PfScore& c, int B, int* J_out,
                           int* grid_out) {
  int dev = 0, n_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n_blk = (B + kPfErrorRows - 1) / kPfErrorRows;
  const void* kernel =
      reinterpret_cast<const void*>(pf_solve_kernel<Cfg, false>);
  const int frags = Cfg::tf32 ? score_frags(c).n : 0;
  for (int J = max(1, (n_blk + n_sm - 1) / n_sm); J <= kPfMaxJ; ++J) {
    int per_sm = 0;
    err = chain_occupancy(kernel, pf_smem_floats(c, J, frags) * sizeof(float),
                          &per_sm, Cfg::threads);
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

#define LRNDE_PF_PARAMS                                                     \
  const float *u0, const float *k10, const float *sc, const float *saveat,  \
      int n_save, const void *const *wb, const int *dims, int L,            \
      unsigned int acts, float beta_min, float d_beta, float t1, float *u,  \
      float *ys, int *stats_i, float *stats_f, float *slots,                \
      unsigned int *barrier, int B, int max_steps, float rtol, float atol,  \
      float inv_n
#define LRNDE_PF_ARGS                                                       \
  u0, k10, sc, saveat, n_save, wb, dims, L, acts, beta_min, d_beta, t1, u,  \
      ys, stats_i, stats_f, slots, barrier, B, max_steps, rtol, atol, inv_n

template <typename Cfg, bool kTime>
static int persistent_pf(LRNDE_PF_PARAMS, unsigned long long* timing,
                         void* stream) {
  PfScore c;
  if (!make_score(&c, wb, dims, L, acts, beta_min, d_beta, t1) || B < 1
      || (kTime && timing == nullptr))
    return cudaErrorInvalidValue;
  int J = 0, grid = 0;
  cudaError_t err = pf_grid<Cfg>(c, B, &J, &grid);
  if (err != cudaSuccess) return err;
  const ScoreFragLayout fl = score_frags(c);
  const size_t smem = pf_smem_floats(c, J, Cfg::tf32 ? fl.n : 0);
  int per_sm = 0;  // the timed kernel's own opt-in
  const void* kernel =
      reinterpret_cast<const void*>(pf_solve_kernel<Cfg, kTime>);
  err = chain_occupancy(kernel, smem * sizeof(float), &per_sm, Cfg::threads);
  if (err != cudaSuccess) return err;
  int reg_l = -1;
  for (int l = 0; l < L && reg_l < 0; ++l)
    if (dims[l] == 64 && dims[l + 1] == 64) reg_l = l;
  PfSolveArgs a{u0, k10, sc, saveat, n_save, c, score_layout(c), u, ys,
                stats_i, stats_f, slots, barrier, B, J, max_steps, rtol,
                atol, inv_n, reg_l, timing, fl};
  void* kargs[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(Cfg::threads),
                                    kargs, smem * sizeof(float),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace lrnde

// Rows of kernel 6's error blocks (slots holds 2·ceil(B / rows) floats),
// threads a CTA and rows a warp.
extern "C" int lrnde_pf_error_rows() { return lrnde::kPfErrorRows; }
extern "C" int lrnde_pf_solve_threads() { return lrnde::PfMain::threads; }
extern "C" int lrnde_pf_warp_rows() { return lrnde::PfMain::rows; }

// Floats of dynamic shared memory of one kernel-6 CTA owning one error
// block (0: outside limits).
extern "C" long long lrnde_pf_solve_smem_floats(const int* dims, int L) {
  using namespace lrnde;
  PfScore c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_score(&c, none, dims, L, 0u, 0.f, 0.f, 0.f)) return 0;
  return static_cast<long long>(pf_smem_floats(c, 1));
}

// The same at the TF32 tier: the layers' fragment copies after the network.
extern "C" long long lrnde_pf_solve_smem_floats_tf32(const int* dims, int L) {
  using namespace lrnde;
  PfScore c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_score(&c, none, dims, L, 0u, 0.f, 0.f, 0.f)) return 0;
  return static_cast<long long>(pf_smem_floats(c, 1, score_frags(c).n));
}

// Kernel 6's grid for B rows: out = (error blocks a CTA, CTAs). Returns the
// occupancy query's error, or the refusal.
extern "C" int lrnde_pf_solve_grid(const int* dims, int L, int B, int* out) {
  using namespace lrnde;
  PfScore c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_score(&c, none, dims, L, 0u, 0.f, 0.f, 0.f) || B < 1)
    return cudaErrorInvalidValue;
  return pf_grid<PfMain>(c, B, out, out + 1);
}

// The same for the TF32 instantiation.
extern "C" int lrnde_pf_solve_grid_tf32(const int* dims, int L, int B,
                                        int* out) {
  using namespace lrnde;
  PfScore c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_score(&c, none, dims, L, 0u, 0.f, 0.f, 0.f) || B < 1)
    return cudaErrorInvalidValue;
  return pf_grid<PfTf32>(c, B, out, out + 1);
}

// The whole adaptive solve from (u0, k1_0) with sc = (t0, t_end, dt0) on the
// device, without recording: the score network given by wb (2L pointers:
// W_0, b_0, W_1, ...; W_l the (d_l + 1, d_{l+1}) TD matrix), dims (L + 1)
// and acts (bit l: tanh after layer l), β(t) = beta_min + t·d_beta at t =
// t1 − τ; u receives y_final. slots holds 2·ceil(B / lrnde_pf_error_rows())
// floats. Returns cudaGetLastError().
extern "C" int lrnde_persistent_pf(LRNDE_PF_PARAMS, void* stream) {
  return lrnde::persistent_pf<lrnde::PfMain, false>(LRNDE_PF_ARGS, nullptr,
                                                    stream);
}

// Kernel 6 at the TF32 tier (the reference's 'default', which its sampler
// takes): lrnde_persistent_pf's contract, every layer's product on the
// tensor cores (score_rows.cuh::warp_score_rows_tf32) on operands rounded
// to TF32, accumulated in FP32; the time terms, the biases, β, the stage
// combinations and the error norm FP32.
extern "C" int lrnde_persistent_pf_tf32(LRNDE_PF_PARAMS, void* stream) {
  return lrnde::persistent_pf<lrnde::PfTf32, false>(LRNDE_PF_ARGS, nullptr,
                                                    stream);
}

// The same solve with CTA 0's nanoseconds per phase of
// lrnde_pf_solve_phase_names, the attempt count and each CTA's SM + 1 in
// timing (kPfPhases + 1 + CTAs). A separate instantiation; the untimed
// kernel carries no clock.
extern "C" int lrnde_persistent_pf_timed(LRNDE_PF_PARAMS,
                                         unsigned long long* timing,
                                         void* stream) {
  return lrnde::persistent_pf<lrnde::PfMain, true>(LRNDE_PF_ARGS, timing,
                                                   stream);
}

extern "C" const char* lrnde_pf_solve_phase_names() {
  return "stage inputs,first layer,hidden layers,last layer,residuals,"
         "error wait,error tree,grid barrier,slot sum,commit and dense output";
}

// The solve in another layout, for chip_smoke.py's [pf probe] (the same
// arithmetic, so the same bits): variant 0 PfMain (4 rows a warp, the
// 64 -> 64 weights in registers, the last layer's accumulators on four
// lanes); 1 the registers alone; 2 a lane an output everywhere, the
// weights in shared memory; 3 and 4 the same with 8 and 2 rows a warp.
extern "C" int lrnde_pf_solve_probe(int variant, LRNDE_PF_PARAMS,
                                    void* stream) {
  using namespace lrnde;
  switch (variant) {
    case 0: return persistent_pf<PfMain, false>(LRNDE_PF_ARGS, nullptr, stream);
    case 1:
      return persistent_pf<PfCfg<4, false, true>, false>(LRNDE_PF_ARGS,
                                                         nullptr, stream);
    case 2:
      return persistent_pf<PfCfg<4, false, false>, false>(LRNDE_PF_ARGS,
                                                          nullptr, stream);
    case 3:
      return persistent_pf<PfCfg<8, false, false>, false>(LRNDE_PF_ARGS,
                                                          nullptr, stream);
    case 4:
      return persistent_pf<PfCfg<2, false, false>, false>(LRNDE_PF_ARGS,
                                                          nullptr, stream);
    default: return cudaErrorInvalidValue;
  }
}
