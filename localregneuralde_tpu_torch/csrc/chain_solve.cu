// Kernel 5: the whole adaptive Tsit5 solve of the autonomous Dense chain (the
// latent ODE's generative dynamics) in one cooperative launch, with the knot
// and checkpoint recording of the stored adjoint and the reservoir sample of
// the biased regulariser, a warp a row (chain_rows.cuh).
//
// Replaces localregneuralde_tpu/ops/pallas/fused_solve.py::
// persistent_chain_solve (_make_kernel built for the ("chain", pads, acts,
// lead) family, family_make_f). The TPU kernel ran whole-batch tiles with
// the weights in VMEM; here every CTA keeps the whole chain and its rows'
// state in shared memory: a CTA a 4-row error block (B = 512: 128 CTAs, one
// an SM), a warp a row.
//
// What bounds it on an H100: serial latency. At the PhysioNet widths (B =
// 512, F = 20, eight layers 20 <-> 40) an attempt is 39 MFLOP (0.6 µs at
// the FP32 peak) over 6·(L + 1) dependent passes of each row and a
// grid-wide reduction. The kernel it replaced ran each pass CTA-wide with a
// barrier after it (0.74 µs a pass, 40 of a 52 µs attempt, NVIDIA H100 80GB
// HBM3, 700 W: PERF.md); here a warp runs its row's passes back to back, a
// lane an output.
//
// One attempt (chain_rows.cuh::chain_attempt): every warp runs the Tsit5
// step of its row; each block's error partial (emulating the old kernel's
// block sum) goes to a slot of its own; a grid barrier follows, and every
// CTA sums the slots in block order, so every CTA reaches a bitwise-
// identical error norm, accept decision, dt and qold, and the solve is
// deterministic run to run. The controller follows fused_solve.py::_propose.
// On an accept each warp writes its row's dense output of the saveat times
// the step crossed (in any order: an entry at t ≤ t0 keeps u0, entries past
// the last accepted step revert to u0 after the loop), the reservoir sample
// and the recordings, and the CTA swaps its buffers. Recording only copies
// committed values, so it changes no accept decision.
//
// The clocked instantiation (kTime) splits CTA 0's attempt by phase for
// chip_smoke.py's [chain solve attribution]; its arithmetic is the same.
//
// At the TF32 tier (kTf32, lrnde_persistent_chain_tf32; the reference's
// 'default', which 'auto' takes at rtol ≥ 1e-4) every layer's product runs
// on mma.sync m16n8k8 (chain_rows.cuh::warp_chain_tf32, a warp's row the
// one live column), from the forward's fragment copies staged once after
// the FP32 layout (which keeps the biases); the stage inputs, ũ, the error
// norm, the controller and the recording are the FP32 kernel's. TF32's
// noise in ũ swamps the controller below rtol 1e-4, where the wrapper
// refuses the tier.
#include "chain_rows.cuh"

namespace lrnde {

struct ChainSolveArgs {
  const float* u0;
  const float* k10;
  const float* sc;      // t0, t_end, dt0
  const float* saveat;  // (n_save)
  int n_save;
  ChainNet w;
  ChainLayout lay;
  float* y;             // (B, F) y_final
  float* ys;            // (n_save, B, F)
  int* stats_i;         // naccept, nreject, done, natt
  float* stats_f;       // t_final, reservoir_t
  float* slots;         // (2, n_blk) error-block partials
  unsigned int* barrier;  // arrival counter, zero at launch
  int B;
  int J;                // error blocks a CTA
  int max_steps;
  float rtol, atol, inv_n;  // inv_n = 1 / (B·F)
  // recording (n_dense = 0: none; n_ckpt = 0: no checkpoints)
  float* knot_ts;       // (n_dense)
  float* knot_us;       // (n_dense, B, F)
  int n_dense;
  float* ckpt_ts;       // (n_ckpt)
  float* ckpt_us;       // (n_ckpt, B, F)
  float* ckpt_ks;       // (n_ckpt, B, F)
  float* ckpt_dts;      // (n_ckpt)
  float* ckpt_qolds;    // (n_ckpt)
  int n_ckpt;
  int stride;
  const float* rand;    // (max_steps) reservoir uniforms, or null
  float* res_u;         // (B, F) reservoir sample, or null
  unsigned long long* timing;  // kTime: (kCsPhases + 1)
};

// Floats of a kernel-5 CTA's dynamic shared memory at J blocks: the
// forward's weights, the warps' activations, the blocks' state and
// residuals; with tf32, then the forward's fragment copies.
__host__ __device__ inline size_t chain_solve_smem_floats(const ChainNet& w,
                                                          int J,
                                                          bool tf32 = false) {
  const size_t n = chain_layout(w).n_fwd +
         2 * static_cast<size_t>(kChainRows) * chain_act_width(w) +
         J * (chain_block_floats(w.F) + static_cast<size_t>(kChainRows) * w.F);
  return tf32 ? round_up4(n) + chain_frag_floats(w) : n;
}

__device__ inline ChainCta carve_chain_cta(const ChainNet& w,
                                           const ChainLayout& lay, float* raw,
                                           int J, int B) {
  ChainCta c;
  c.W = raw;
  c.aw = chain_act_width(w);
  c.act = raw + lay.n_fwd;
  c.state = c.act + 2 * kChainRows * c.aw;
  c.res = c.state + J * chain_block_floats(w.F);
  c.n_blk = (B + kChainRows - 1) / kChainRows;
  c.first = blockIdx.x * J;
  c.nb = max(0, min(J, c.n_blk - c.first));
  c.B = B;
  c.frag = nullptr;
  return c;
}

template <bool kTime, bool kTf32 = false>
__global__ void __launch_bounds__(kChainThreads)
chain_solve_kernel(ChainSolveArgs a) {
  extern __shared__ float4 smem_raw[];
  __shared__ Ctl ctl;
  __shared__ ChainMeta meta;
  __shared__ unsigned long long clk_acc[kTime ? kCsPhases + 1 : 1];
  ChainClock<kTime, kCsPhases> clk{clk_acc};
  const ChainNet& w = a.w;
  const int F = w.F, B = a.B, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  ChainCta c =
      carve_chain_cta(w, a.lay, reinterpret_cast<float*>(smem_raw), a.J, B);
  if constexpr (kTf32)
    c.frag = reinterpret_cast<float*>(smem_raw)
           + round_up4(chain_solve_smem_floats(w, a.J));
  const size_t BF = static_cast<size_t>(B) * F;
  const float t_end = a.sc[1];
  load_chain_weights(w, a.lay, const_cast<float*>(c.W), nullptr, meta);
  if constexpr (kTf32) stage_chain_frags(w, const_cast<float*>(c.frag), false);

  // each of this warp's rows: fn(block index j, global row, row state)
  int par = 0;
  auto each_row = [&](auto fn) {
    for (int j = 0; j < c.nb; ++j) {
      if (warp >= block_rows(c, j)) continue;
      const int row = (c.first + j) * kChainRows + warp;
      fn(j, row, chain_row(c.state + j * chain_block_floats(F), F, warp, par));
    }
  };
  each_row([&](int, int row, const ChainRow& p) {
    const size_t on = static_cast<size_t>(row) * F;
    for (int i = lane; i < F; i += 32) {
      const float v = a.u0[on + i];
      p.u[i] = v;
      p.k[0][i] = a.k10[on + i];
      for (int s = 0; s < a.n_save; ++s) a.ys[s * BF + on + i] = v;
      if (a.n_dense > 0) a.knot_us[on + i] = v;
      if (a.res_u != nullptr) a.res_u[on + i] = v;
      if (a.n_ckpt > 0) {
        a.ckpt_us[on + i] = v;
        a.ckpt_ks[on + i] = a.k10[on + i];
      }
    }
  });
  if (blockIdx.x == 0) {
    for (int i = tid; i < a.n_dense; i += kChainThreads)
      a.knot_ts[i] = i == 0 ? a.sc[0] : t_end;
    for (int i = tid; i < a.n_ckpt; i += kChainThreads) {
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
  __syncthreads();

  unsigned int epoch = 0;
  clk.start();
  // ctl changes only in thread 0 after the attempt's grid barrier, which
  // every thread reaches after reading it
  while (!ctl.done && ctl.natt < a.max_steps) {
    const float t = ctl.t;
    const AttemptPlan plan = plan_attempt(t, ctl.dt, t_end);
    const float dt = plan.dt_c, t_new = plan.t_new;
    const float eest =
        chain_attempt<kTf32>(w, meta, c, par, dt, a.atol, a.rtol, a.inv_n,
                             a.slots, a.barrier, epoch, clk);
    if (tid == 0) {
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
        ctl.done = plan.is_last;
        ++ctl.nacc;
      } else {
        ctl.dt = dt_rej;
        ++ctl.nrej;
      }
      ++ctl.natt;
    }
    __syncthreads();
    if (ctl.accept) {
      const bool take = ctl.take;
      const int cnt = ctl.nacc;
      const bool knot = cnt < a.n_dense;
      const bool ckpt = a.n_ckpt > 0 && cnt % a.stride == 0;
      const int ci = ckpt ? cnt / a.stride : 0;
      each_row([&](int, int row, const ChainRow& p) {
        const size_t on = static_cast<size_t>(row) * F;
        // the dense output of the saveat times this step crossed, from the
        // step-start state (the old hook's expression); the warp tests 32
        // times at once
        for (int s0 = 0; s0 < a.n_save; s0 += 32) {
          const int sl = s0 + lane;
          const float tl = sl < a.n_save ? __ldg(a.saveat + sl) : 0.f;
          unsigned int hits =
              __ballot_sync(0xffffffffu, sl < a.n_save && tl > t && tl <= t_new);
          while (hits != 0u) {
            const int h = __ffs(hits) - 1;
            hits &= hits - 1u;
            const float ts = __shfl_sync(0xffffffffu, tl, h);
            float b[7];
            interp_weights(fminf(fmaxf((ts - t) / dt, 0.f), 1.f), b);
            float* ys = a.ys + (s0 + h) * BF + on;
            for (int i = lane; i < F; i += 32) {
              float acc = b[0] * p.k[0][i];
#pragma unroll
              for (int j = 1; j < 7; ++j) acc = acc + b[j] * p.k[j][i];
              ys[i] = p.u[i] + dt * acc;
            }
          }
        }
        // the committed state is u_new, its FSAL derivative k7
        for (int i = lane; i < F; i += 32) {
          if (take) a.res_u[on + i] = p.u[i];
          if (knot) a.knot_us[cnt * BF + on + i] = p.unew[i];
          if (ckpt) {
            a.ckpt_us[ci * BF + on + i] = p.unew[i];
            a.ckpt_ks[ci * BF + on + i] = p.k[6][i];
          }
        }
      });
      par ^= 1;
      if (blockIdx.x == 0 && tid == 0) {
        if (knot) a.knot_ts[cnt] = ctl.t;
        if (ckpt) {
          a.ckpt_ts[ci] = ctl.t;
          a.ckpt_dts[ci] = ctl.dt;
          a.ckpt_qolds[ci] = ctl.qold;
        }
      }
    }
    clk.cta(kCsCommit);
  }

  // y_final; saveat entries never covered by an accepted step revert to u0,
  // so a failed solve matches the loop's accept-only commits
  const float t_fin = ctl.t;
  each_row([&](int, int row, const ChainRow& p) {
    const size_t on = static_cast<size_t>(row) * F;
    for (int i = lane; i < F; i += 32) {
      a.y[on + i] = p.u[i];
      for (int s = 0; s < a.n_save; ++s)
        if (a.saveat[s] > t_fin) a.ys[s * BF + on + i] = a.u0[on + i];
    }
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

// At most this many error blocks a CTA (a batch past 128 blocks an SM, B ≈
// 67,000 on an H100, is refused).
constexpr int kChainMaxJ = 128;

// The grid of kernel 5 for B rows: J blocks a CTA and the CTAs.
template <bool kTf32 = false>
static cudaError_t chain_solve_grid(const ChainNet& c, int B, int* J,
                                    int* grid) {
  const int n_blk = (B + kChainRows - 1) / kChainRows;
  return chain_grid(
      reinterpret_cast<const void*>(chain_solve_kernel<false, kTf32>), n_blk,
      [&](int j) { return chain_solve_smem_floats(c, j, kTf32); }, kChainMaxJ,
      J, grid);
}

template <bool kTime, bool kTf32 = false>
static int persistent_chain(
    const float* u0, const float* k10, const float* sc, const float* saveat,
    int n_save, const void* const* wb, const int* dims, int L,
    unsigned int acts, int lead, float* u, float* ys, int* stats_i,
    float* stats_f, float* slots, unsigned int* barrier, int B,
    int max_steps, float rtol, float atol, float inv_n, float* knot_ts,
    float* knot_us, int n_dense, float* ckpt_ts, float* ckpt_us,
    float* ckpt_ks, float* ckpt_dts, float* ckpt_qolds, int n_ckpt,
    int stride, const float* rand, float* res_u, unsigned long long* timing,
    void* stream) {
  ChainNet c;
  if (!make_chain(&c, wb, dims, L, acts, lead) || (n_ckpt > 0 && stride < 1)
      || (rand == nullptr) != (res_u == nullptr) || B < 1
      || (kTime && timing == nullptr))
    return cudaErrorInvalidValue;
  int J = 0, grid = 0;
  cudaError_t err = chain_solve_grid<kTf32>(c, B, &J, &grid);
  if (err != cudaSuccess) return err;
  const size_t smem = chain_solve_smem_floats(c, J, kTf32);
  int per_sm = 0;  // the timed kernel's own opt-in
  auto kernel = chain_solve_kernel<kTime, kTf32>;
  err = chain_occupancy(reinterpret_cast<const void*>(kernel),
                        smem * sizeof(float), &per_sm);
  if (err != cudaSuccess) return err;
  ChainSolveArgs a{u0, k10, sc, saveat, n_save, c, chain_layout(c), u, ys,
                   stats_i, stats_f,
                   slots, barrier, B, J, max_steps, rtol, atol, inv_n,
                   knot_ts, knot_us, n_dense, ckpt_ts, ckpt_us, ckpt_ks,
                   ckpt_dts, ckpt_qolds, n_ckpt, stride, rand, res_u, timing};
  return launch_chain_cooperative(reinterpret_cast<const void*>(kernel), &a,
                                  grid, smem,
                                  static_cast<cudaStream_t>(stream));
}

}  // namespace lrnde

// Rows of an error block: the error norm sums one partial per block, so
// slots holds 2·ceil(B / rows) floats.
extern "C" int lrnde_chain_error_rows() { return lrnde::kChainRows; }

// Floats of dynamic shared memory of one kernel-5 CTA owning one error
// block (0: outside limits).
extern "C" long long lrnde_chain_solve_smem_floats(const int* dims, int L) {
  using namespace lrnde;
  ChainNet c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_chain(&c, none, dims, L, 0u, 0)) return 0;
  return static_cast<long long>(chain_solve_smem_floats(c, 1));
}

// The same at the TF32 tier: the forward's fragment copies after the rest.
extern "C" long long lrnde_chain_solve_smem_floats_tf32(const int* dims,
                                                        int L) {
  using namespace lrnde;
  ChainNet c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_chain(&c, none, dims, L, 0u, 0)) return 0;
  return static_cast<long long>(chain_solve_smem_floats(c, 1, true));
}

// Kernel 5's grid for B rows: out = (error blocks a CTA, CTAs). Returns
// cudaGetLastError() of the occupancy query, or the refusal.
extern "C" int lrnde_chain_solve_grid(const int* dims, int L, int B,
                                      int* out) {
  using namespace lrnde;
  ChainNet c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_chain(&c, none, dims, L, 0u, 0) || B < 1)
    return cudaErrorInvalidValue;
  return chain_solve_grid(c, B, out, out + 1);
}

// The same for the TF32 instantiation.
extern "C" int lrnde_chain_solve_grid_tf32(const int* dims, int L, int B,
                                           int* out) {
  using namespace lrnde;
  ChainNet c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_chain(&c, none, dims, L, 0u, 0) || B < 1)
    return cudaErrorInvalidValue;
  return chain_solve_grid<true>(c, B, out, out + 1);
}

// The whole adaptive solve of the chain from (u0, k1_0) with sc = (t0,
// t_end, dt0) on the device: the contract of lrnde_persistent_tsit5, with
// the chain given by wb (2L pointers: W_0, b_0, W_1, ...), dims (L + 1),
// acts (bit l: tanh after layer l) and lead (tanh on the input); u receives
// y_final. slots holds 2·ceil(B / lrnde_chain_error_rows()) floats.
// Returns cudaGetLastError().
extern "C" int lrnde_persistent_chain(
    const float* u0, const float* k10, const float* sc, const float* saveat,
    int n_save, const void* const* wb, const int* dims, int L,
    unsigned int acts, int lead, float* u, float* ys, int* stats_i,
    float* stats_f, float* slots, unsigned int* barrier, int B,
    int max_steps, float rtol, float atol, float inv_n, float* knot_ts,
    float* knot_us, int n_dense, float* ckpt_ts, float* ckpt_us,
    float* ckpt_ks, float* ckpt_dts, float* ckpt_qolds, int n_ckpt,
    int stride, const float* rand, float* res_u, void* stream) {
  return lrnde::persistent_chain<false>(
      u0, k10, sc, saveat, n_save, wb, dims, L, acts, lead, u, ys, stats_i,
      stats_f, slots, barrier, B, max_steps, rtol, atol, inv_n, knot_ts,
      knot_us, n_dense, ckpt_ts, ckpt_us, ckpt_ks, ckpt_dts, ckpt_qolds,
      n_ckpt, stride, rand, res_u, nullptr, stream);
}

// Kernel 5 at the TF32 tier: lrnde_persistent_chain's contract, every
// layer's product on the tensor cores (chain_rows.cuh::warp_chain_tf32) on
// operands rounded to TF32, accumulated in FP32; the biases, tanh, the
// stage combinations, the error norm and the controller FP32.
extern "C" int lrnde_persistent_chain_tf32(
    const float* u0, const float* k10, const float* sc, const float* saveat,
    int n_save, const void* const* wb, const int* dims, int L,
    unsigned int acts, int lead, float* u, float* ys, int* stats_i,
    float* stats_f, float* slots, unsigned int* barrier, int B,
    int max_steps, float rtol, float atol, float inv_n, float* knot_ts,
    float* knot_us, int n_dense, float* ckpt_ts, float* ckpt_us,
    float* ckpt_ks, float* ckpt_dts, float* ckpt_qolds, int n_ckpt,
    int stride, const float* rand, float* res_u, void* stream) {
  return lrnde::persistent_chain<false, true>(
      u0, k10, sc, saveat, n_save, wb, dims, L, acts, lead, u, ys, stats_i,
      stats_f, slots, barrier, B, max_steps, rtol, atol, inv_n, knot_ts,
      knot_us, n_dense, ckpt_ts, ckpt_us, ckpt_ks, ckpt_dts, ckpt_qolds,
      n_ckpt, stride, rand, res_u, nullptr, stream);
}

// The same solve with CTA 0's nanoseconds per phase (kCsPhases) and the
// number of attempts in timing. A separate instantiation; the untimed
// kernel carries no clock.
extern "C" int lrnde_persistent_chain_timed(
    const float* u0, const float* k10, const float* sc, const float* saveat,
    int n_save, const void* const* wb, const int* dims, int L,
    unsigned int acts, int lead, float* u, float* ys, int* stats_i,
    float* stats_f, float* slots, unsigned int* barrier, int B,
    int max_steps, float rtol, float atol, float inv_n, float* knot_ts,
    float* knot_us, int n_dense, float* ckpt_ts, float* ckpt_us,
    float* ckpt_ks, float* ckpt_dts, float* ckpt_qolds, int n_ckpt,
    int stride, const float* rand, float* res_u, unsigned long long* timing,
    void* stream) {
  return lrnde::persistent_chain<true>(
      u0, k10, sc, saveat, n_save, wb, dims, L, acts, lead, u, ys, stats_i,
      stats_f, slots, barrier, B, max_steps, rtol, atol, inv_n, knot_ts,
      knot_us, n_dense, ckpt_ts, ckpt_us, ckpt_ks, ckpt_dts, ckpt_qolds,
      n_ckpt, stride, rand, res_u, timing, stream);
}

extern "C" const char* lrnde_chain_solve_phase_names() {
  return "stage inputs,layer passes,residuals,error wait,error tree,"
         "grid barrier,slot sum,commit and recording";
}
