// The whole adaptive Tsit5 solve in one cooperative launch, templated on
// the dynamics type: kernel 5 (chain.cuh::DenseChain, chain_solve.cu) and
// kernel 6 (score.cuh::PfScore, pf_solve.cu), with the knot and checkpoint
// recording of the stored adjoint and the reservoir sample of the biased
// regulariser. Kernel 4 (the TD-MLP) ran here too; it now runs on
// thread-block clusters (persistent_solve.cu), which keep its arithmetic
// bit for bit, and its attempt at this row blocking remains the sweeps'
// window replay (sweep_cluster.cuh::TDMLPSweep).
//
// Replaces localregneuralde_tpu/ops/pallas/fused_solve.py::_make_kernel
// (built by _build_call for the ("chain", ...) and ("pfode", ...) families). On
// the TPU one core ran the accept/reject loop with the state resident in
// VMEM. Here every CTA owns fixed row blocks (D::rows rows) for the whole
// solve and loops over them; the state u (the y_final output), the FSAL
// derivative k1, the stage derivatives k2..k7 and the candidate u_new live
// in global scratch (8·B·F f32: 0.33 MB for the latent chain at B = 512,
// F = 20), which stays in the 50 MB L2.
//
// One attempt (solve.cuh::attempt_eest): each CTA runs the Tsit5 step of its
// rows, writes the speculative dense output of every saveat time the
// attempt would cross, and stores its row block's sum of squared scaled
// residuals into a slot of its own. A grid barrier follows; then thread 0 of
// every CTA sums all slots in row-block order, so every CTA reaches a
// bitwise-identical error norm, accept decision, dt and qold, and the solve
// is deterministic run to run. No float atomic touches the norm. t, dt and
// qold stay f32, as in the reference, and the controller follows
// fused_solve.py::_propose. The saveat times need not be sorted; an entry
// at t ≤ t0 keeps u0, and entries past the last accepted step revert to u0
// after the loop.
//
// Recording (n_dense > 0): on every accept each CTA copies its rows of the
// committed u to the dense knot buffer while naccept < n_dense, and with a
// stride W > 1 every W-th accept also to the checkpoint buffers with k1;
// CTA 0 writes the times and the controller state (dt_next, qold). Recording
// only copies committed values, so it changes no accept decision, and with
// n_dense = n_ckpt = 0 the kernel runs exactly the eval solve.
//
// Reservoir (rand not null): an accepted attempt number natt replaces the
// sample with its step-start (t, u) when rand[natt]·(naccept + 1) < 1, the
// uniforms drawn in advance by the caller (fused_solve.py:424-432 of the
// reference). The decision is grid-uniform, so each CTA copies its own rows
// before the commit.
//
// A dynamics type D provides, besides what tsit5_rows needs, carve_shared()
// (its shared memory from the dynamic buffer), load_shared() (what it keeps
// there for the whole solve, before the first attempt) and, on the host,
// shared_floats() (the size of that buffer).
#pragma once

#include "solve.cuh"

namespace lrnde {

template <typename D>
struct SolveArgs {
  const float* u0;
  const float* k10;
  const float* sc;      // t0, t_end, dt0
  const float* saveat;  // (n_save)
  int n_save;
  D w;
  float* u;             // (B, F) working state; y_final on exit
  float* ys;            // (n_save, B, F)
  int* stats_i;         // naccept, nreject, done, natt
  float* stats_f;       // t_final, reservoir_t
  float* scratch;       // 8 (B, F) buffers: k1, k2..k7, u_new
  float* slots;         // (2, n_blocks) row-block error partials
  unsigned int* barrier;  // arrival counter, zero at launch
  int B;
  int max_steps;
  float rtol;
  float atol;
  float inv_n;          // 1 / (B·F)
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
};

struct Ctl {
  float t, dt, qold, res_t;
  AttemptPlan plan;
  int accept, take, done, natt, nacc, nrej;
};

template <typename D>
__global__ void __launch_bounds__(D::threads)
persistent_solve_kernel(SolveArgs<D> a) {
  constexpr int R = D::rows, T = D::threads;
  extern __shared__ float4 smem_raw[];
  __shared__ Ctl ctl;
  const int F = a.w.F, B = a.B, tid = threadIdx.x;
  const typename D::Shared sm =
      carve_shared(a.w, reinterpret_cast<float*>(smem_raw));
  load_shared(a.w, sm);
  const int n_blocks = (B + R - 1) / R;
  const size_t BF = static_cast<size_t>(B) * F;
  const AttemptBufs bufs{a.u, a.scratch, a.scratch + 7 * BF, BF, B};
  const float t_end = a.sc[1];

  for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
    const size_t off = static_cast<size_t>(rb) * R * F;
    const int n = min(R, B - rb * R) * F;
    for (int i = tid; i < n; i += T) {
      const float v = a.u0[off + i];
      a.u[off + i] = v;
      bufs.k[off + i] = a.k10[off + i];
      for (int s = 0; s < a.n_save; ++s) a.ys[s * BF + off + i] = v;
      if (a.n_dense > 0) a.knot_us[off + i] = v;
      if (a.res_u != nullptr) a.res_u[off + i] = v;
      if (a.n_ckpt > 0) {
        a.ckpt_us[off + i] = v;
        a.ckpt_ks[off + i] = a.k10[off + i];
      }
    }
  }
  if (blockIdx.x == 0) {
    for (int i = tid; i < a.n_dense; i += T)
      a.knot_ts[i] = i == 0 ? a.sc[0] : t_end;
    for (int i = tid; i < a.n_ckpt; i += T) {
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
  while (!ctl.done && ctl.natt < a.max_steps) {
    if (tid == 0) ctl.plan = plan_attempt(ctl.t, ctl.dt, t_end);
    __syncthreads();
    const float t = ctl.t, dt_c = ctl.plan.dt_c, t_new = ctl.plan.t_new;
    // speculative dense output: the hit test needs only pre-step scalars,
    // and the accepted attempt that crosses a saveat time writes last
    auto dense_output = [&](int rb, const StepRows& p, int nrows) {
      const size_t off = static_cast<size_t>(rb) * R * F;
      for (int s = 0; s < a.n_save; ++s) {
        const float ts = a.saveat[s];
        if (!(ts > t && ts <= t_new)) continue;
        float b[7];
        interp_weights(fminf(fmaxf((ts - t) / dt_c, 0.f), 1.f), b);
        float* ys = a.ys + s * BF + off;
        for (int i = tid; i < nrows * F; i += T) {
          float acc = b[0] * p.k[0][i];
#pragma unroll
          for (int j = 1; j < 7; ++j) acc = acc + b[j] * p.k[j][i];
          ys[i] = p.u[i] + dt_c * acc;
        }
      }
    };
    const float eest = attempt_eest(a.w, sm, bufs, t, dt_c, a.atol, a.rtol,
                                    a.inv_n, a.slots, a.barrier, epoch,
                                    dense_output);

    if (tid == 0) {
      const bool accept = eest <= 1.f;
      float dt_acc, dt_rej, qold_acc;
      propose(eest, dt_c, ctl.qold, &dt_acc, &dt_rej, &qold_acc);
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
      if (ctl.take) copy_rows<D>(a.res_u, a.u, B, F);
      commit_rows<D>(bufs, F);
      const int cnt = ctl.nacc;
      if (cnt < a.n_dense) {
        __syncthreads();
        copy_rows<D>(a.knot_us + cnt * BF, a.u, B, F);
        if (blockIdx.x == 0 && tid == 0) a.knot_ts[cnt] = ctl.t;
      }
      if (a.n_ckpt > 0 && cnt % a.stride == 0) {
        const int ci = cnt / a.stride;
        __syncthreads();
        copy_rows<D>(a.ckpt_us + ci * BF, a.u, B, F);
        copy_rows<D>(a.ckpt_ks + ci * BF, bufs.k, B, F);
        if (blockIdx.x == 0 && tid == 0) {
          a.ckpt_ts[ci] = ctl.t;
          a.ckpt_dts[ci] = ctl.dt;
          a.ckpt_qolds[ci] = ctl.qold;
        }
      }
    }
    __syncthreads();
  }

  // saveat entries never covered by an accepted step revert to u0, so a
  // failed solve matches the loop's accept-only commits
  for (int s = 0; s < a.n_save; ++s) {
    if (!(a.saveat[s] > ctl.t)) continue;
    copy_rows<D>(a.ys + s * BF, a.u0, B, F);
  }
  if (blockIdx.x == 0 && tid == 0) {
    a.stats_i[0] = ctl.nacc;
    a.stats_i[1] = ctl.nrej;
    a.stats_i[2] = ctl.done;
    a.stats_i[3] = ctl.natt;
    a.stats_f[0] = ctl.t;
    a.stats_f[1] = ctl.res_t;
  }
}

}  // namespace lrnde
