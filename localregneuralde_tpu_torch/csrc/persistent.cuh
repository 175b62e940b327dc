// The whole adaptive Tsit5 solve in one cooperative launch, templated on
// the dynamics type: kernel 6 (score.cuh::PfScore, pf_solve.cu). Kernel 4
// (the TD-MLP) ran here before it moved to thread-block clusters
// (persistent_solve.cu), and kernel 5 (the Dense chain) before it moved to
// a warp a row (chain_solve.cu); both kept their arithmetic bit for bit,
// and kernel 4's attempt at this row blocking remains the sweeps' window
// replay (sweep_cluster.cuh::TDMLPSweep).
//
// Replaces localregneuralde_tpu/ops/pallas/fused_solve.py::_make_kernel
// (built by _build_call for the ("pfode", ...) family). On
// the TPU one core ran the accept/reject loop with the state resident in
// VMEM. Here every CTA owns fixed row blocks (D::rows rows) for the whole
// solve and loops over them; the state u (the y_final output), the FSAL
// derivative k1, the stage derivatives k2..k7 and the candidate u_new live
// in global scratch (8·B·F f32), which stays in the 50 MB L2.
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
// after the loop. Sampling is never differentiated, so nothing is recorded.
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
  float* stats_f;       // t_final
  float* scratch;       // 8 (B, F) buffers: k1, k2..k7, u_new
  float* slots;         // (2, n_blocks) row-block error partials
  unsigned int* barrier;  // arrival counter, zero at launch
  int B;
  int max_steps;
  float rtol;
  float atol;
  float inv_n;          // 1 / (B·F)
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
    }
  }
  if (tid == 0) {
    ctl.t = a.sc[0];
    ctl.dt = a.sc[2];
    ctl.qold = kQoldInit;
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
      if (accept) {
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
    if (ctl.accept) commit_rows<D>(bufs, F);
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
  }
}

}  // namespace lrnde
