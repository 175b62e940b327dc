// Kernel 4: the whole adaptive Tsit5 solve of the TD-MLP dynamics in one
// cooperative launch (eval features: no knots, checkpoints or reservoir).
//
// Replaces localregneuralde_tpu/ops/pallas/fused_solve.py::_make_kernel
// (family ("tdmlp",), built by _build_call and called from
// persistent_tsit5_solve). On the TPU one core ran the accept/reject loop
// with the state resident in VMEM. Here every CTA owns fixed row blocks for
// the whole solve and loops over them; the state u (the y_final output), the
// FSAL derivative k1, the stage derivatives k2..k7 and the candidate u_new
// live in global scratch (8·B·F f32, 13 MB at B = 512, F = 784), which stays
// in the 50 MB L2.
//
// One attempt: each CTA runs the Tsit5 step of its rows (tdmlp.cuh), writes
// the speculative dense output of every saveat time the attempt would cross,
// and stores its row block's sum of squared scaled residuals into a slot of
// its own. A grid barrier follows; then thread 0 of every CTA sums all slots
// in row-block order, so every CTA reaches a bitwise-identical error norm,
// accept decision, dt and qold, and the solve is deterministic run to run.
// No float atomic touches the norm. The slots are double-buffered by attempt
// parity, so a CTA that runs ahead never overwrites slots another CTA is
// still reading. t, dt and qold stay f32, as in the reference, and the
// controller follows fused_solve.py::_propose.
//
// What bounds it: per attempt, six TD-MLP evaluations (see tdmlp.cuh) plus
// one grid barrier. Measured on an H100 at B = 512, an attempt takes 0.21 ms,
// the time of one launch of the step kernel (six 35 µs evaluations), so the
// barrier and the controller cost nothing visible next to the evaluations.
#include "tdmlp.cuh"

namespace lrnde {

// PIController defaults of ode/controller.py, rounded like the reference.
constexpr float kGamma = static_cast<float>(0.9);
constexpr float kBeta1 = static_cast<float>(0.14);
constexpr float kBeta2 = static_cast<float>(0.08);
constexpr float kInvQmax = static_cast<float>(1.0 / 10.0);
constexpr float kInvQmin = static_cast<float>(1.0 / 0.2);
constexpr float kQoldInit = static_cast<float>(1e-4);

struct SolveArgs {
  const float* u0;
  const float* k10;
  const float* sc;      // t0, t_end, dt0
  const float* saveat;  // (n_save)
  int n_save;
  TDMLP w;
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

struct Ctl {
  float t, dt, qold, dt_c, t_new;
  int is_last, accept, done, natt, nacc, nrej;
};

// Grid-wide barrier on a monotonically increasing arrival counter; needs
// every CTA co-resident, which the cooperative launch guarantees. A CTA that
// waits far longer than any solve needs traps instead of hanging the card.
__device__ inline void grid_barrier(unsigned int* counter, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned int polls = 0, seen = 0;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(counter) : "memory");
      if (seen >= target) break;
      __nanosleep(128);
      if (++polls > (1u << 27)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ inline void propose(float eest, float dt, float qold, float* dt_acc,
                               float* dt_rej, float* qold_acc) {
  const bool finite = isfinite(eest);
  const float e = finite ? fmaxf(eest, 0.f) : 1.f;
  const float q11 = powf(e, kBeta1);
  float q = q11 / powf(qold, kBeta2);
  q = fmaxf(kInvQmax, fminf(kInvQmin, q / kGamma));
  *dt_acc = finite ? dt / q : dt * 0.5f;
  *dt_rej = finite ? dt / fminf(kInvQmin, q11 / kGamma) : dt * 0.5f;
  *qold_acc = fmaxf(e, kQoldInit);
}

// Tsit5 free-interpolant weights b_i(θ) (ode/tableaus.py).
__device__ inline void interp_weights(float t, float (&b)[7]) {
  const float t2 = t * t;
  b[0] = static_cast<float>(-1.0530884977290216) * t *
         (t - static_cast<float>(1.3299890189751412)) *
         (t2 - static_cast<float>(1.4364028541716351) * t +
          static_cast<float>(0.7139816917074209));
  b[1] = static_cast<float>(0.1017) * t2 *
         (t2 - static_cast<float>(2.1966568338249754) * t +
          static_cast<float>(1.2949852507374631));
  b[2] = static_cast<float>(2.490627285651252793) * t2 *
         (t2 - static_cast<float>(2.38535645472061657) * t +
          static_cast<float>(1.57803468208092486));
  b[3] = static_cast<float>(-16.54810288924490272) *
         (t - static_cast<float>(1.21712927295533244)) *
         (t - static_cast<float>(0.61620406037800089)) * t2;
  b[4] = static_cast<float>(47.37952196281928122) *
         (t - static_cast<float>(1.203071208372362603)) *
         (t - static_cast<float>(0.658047292653547382)) * t2;
  b[5] = static_cast<float>(-34.87065786149660974) *
         (t - static_cast<float>(1.2)) *
         (t - static_cast<float>(0.666666666666666667)) * t2;
  b[6] = static_cast<float>(2.5) * (t - 1.f) * (t - static_cast<float>(0.6)) * t2;
}

__global__ void __launch_bounds__(kThreads)
persistent_tsit5_kernel(SolveArgs a) {
  extern __shared__ float4 smem_raw[];
  __shared__ Ctl ctl;
  const int F = a.w.F, B = a.B, tid = threadIdx.x;
  const Smem sm = carve_smem(reinterpret_cast<float*>(smem_raw), F, a.w.H);
  const int n_blocks = (B + kRows - 1) / kRows;
  const size_t BF = static_cast<size_t>(B) * F;
  float* const kbuf = a.scratch;               // k1..k7: kbuf + j·BF
  float* const unew = a.scratch + 7 * BF;
  const float t_end = a.sc[1];

  for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
    const size_t off = static_cast<size_t>(rb) * kRows * F;
    const int n = min(kRows, B - rb * kRows) * F;
    for (int i = tid; i < n; i += kThreads) {
      const float v = a.u0[off + i];
      a.u[off + i] = v;
      kbuf[off + i] = a.k10[off + i];
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
    if (tid == 0) {
      const float t_rem = t_end - ctl.t;
      ctl.dt_c = fminf(ctl.dt, t_rem);
      ctl.is_last = ctl.dt >= t_rem;
      ctl.t_new = ctl.is_last ? t_end : ctl.t + ctl.dt_c;
    }
    __syncthreads();
    const float t = ctl.t, dt_c = ctl.dt_c, t_new = ctl.t_new;
    float* const slots = a.slots + (ctl.natt & 1) * n_blocks;

    for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
      const size_t off = static_cast<size_t>(rb) * kRows * F;
      const int nrows = min(kRows, B - rb * kRows);
      StepRows p;
      p.u = a.u + off;
      for (int j = 0; j < 7; ++j) p.k[j] = kbuf + j * BF + off;
      p.unew = unew + off;
      p.utilde = nullptr;
      p.g6 = nullptr;
      const float err =
          tsit5_rows(a.w, sm, p, t, dt_c, nrows, true, a.atol, a.rtol);
      // speculative dense output: the hit test needs only pre-step scalars,
      // and the accepted attempt that crosses a saveat time writes last
      for (int s = 0; s < a.n_save; ++s) {
        const float ts = a.saveat[s];
        if (!(ts > t && ts <= t_new)) continue;
        float b[7];
        interp_weights(fminf(fmaxf((ts - t) / dt_c, 0.f), 1.f), b);
        float* ys = a.ys + s * BF + off;
        for (int i = tid; i < nrows * F; i += kThreads) {
          float acc = b[0] * p.k[0][i];
#pragma unroll
          for (int j = 1; j < 7; ++j) acc = acc + b[j] * p.k[j][i];
          ys[i] = p.u[i] + dt_c * acc;
        }
      }
      if (tid == 0) __stcg(slots + rb, err);
    }

    ++epoch;
    grid_barrier(a.barrier, epoch * gridDim.x);

    if (tid == 0) {
      float err_sq = 0.f;
      for (int i = 0; i < n_blocks; ++i) err_sq += __ldcg(slots + i);
      const float eest = sqrtf(err_sq * a.inv_n);
      const bool accept = eest <= 1.f;
      float dt_acc, dt_rej, qold_acc;
      propose(eest, ctl.dt_c, ctl.qold, &dt_acc, &dt_rej, &qold_acc);
      ctl.accept = accept;
      if (accept) {
        ctl.t = ctl.t_new;
        ctl.dt = dt_acc;
        ctl.qold = qold_acc;
        ctl.done = ctl.is_last;
        ++ctl.nacc;
      } else {
        ctl.dt = dt_rej;
        ++ctl.nrej;
      }
      ++ctl.natt;
    }
    __syncthreads();
    if (ctl.accept) {
      for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
        const size_t off = static_cast<size_t>(rb) * kRows * F;
        const int n = min(kRows, B - rb * kRows) * F;
        for (int i = tid; i < n; i += kThreads) {
          a.u[off + i] = unew[off + i];
          kbuf[off + i] = kbuf[6 * BF + off + i];
        }
      }
    }
    __syncthreads();
  }

  // saveat entries never covered by an accepted step revert to u0, so a
  // failed solve matches the loop's accept-only commits
  for (int s = 0; s < a.n_save; ++s) {
    if (!(a.saveat[s] > ctl.t)) continue;
    for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
      const size_t off = static_cast<size_t>(rb) * kRows * F;
      const int n = min(kRows, B - rb * kRows) * F;
      for (int i = tid; i < n; i += kThreads) a.ys[s * BF + off + i] = a.u0[off + i];
    }
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

// The whole adaptive solve from (u0, k1_0) with sc = (t0, t_end, dt0) on the
// device. scratch holds 8·B·F floats, slots 2·ceil(B / kRows), barrier one
// zeroed unsigned int. Fails with cudaErrorCooperativeLaunchTooLarge when
// not even one CTA fits on an SM. Returns cudaGetLastError().
extern "C" int lrnde_persistent_tsit5(
    const float* u0, const float* k10, const float* sc, const float* saveat,
    int n_save, const float* w1, const float* b1, const float* w2,
    const float* b2, float* u, float* ys, int* stats_i, float* stats_f,
    float* scratch, float* slots, unsigned int* barrier, int B, int F, int H,
    int max_steps, float rtol, float atol, float inv_n, void* stream) {
  using namespace lrnde;
  SolveArgs a{u0, k10, sc, saveat, n_save, TDMLP{w1, b1, w2, b2, F, H},
              u, ys, stats_i, stats_f, scratch, slots, barrier, B, max_steps,
              rtol, atol, inv_n};
  const size_t smem = smem_floats(F, H) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(persistent_tsit5_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, persistent_tsit5_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int n_blocks = (B + kRows - 1) / kRows;
  const int grid = min(n_blocks, per_sm * n_sm);
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(persistent_tsit5_kernel), dim3(grid),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
