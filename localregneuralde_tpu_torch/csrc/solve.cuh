// Shared device code of the whole-solve kernels: the grid barrier, the PI
// controller, the Tsit5 interpolant weights and ONE ATTEMPT of the adaptive
// loop over the whole batch.
//
// The two-level window replay of kernel 8 (replay_window in
// adjoint_sweep.cu, replaying the TD-MLP with the arithmetic of kernel 4)
// calls attempt_eest(), the counterpart of the reference's
// fused_solve.py::run_attempt_tiles, templated on the dynamics type
// (sweep_cluster.cuh::TDMLPSweep). Each row block's squared scaled
// residuals go into a slot of its own, and every CTA sums the slots in
// row-block order (ordered_slot_sum, which kernels 4, 5, 6, 9, 10 and 11
// call too), so the error norm does not depend on the grid size or on which
// CTA ran which row block. A replay from a checkpoint therefore repeats its
// forward's accept decisions and dt sequence bitwise. Kernels 5 and 9 (the
// Dense chain) run their own attempt a warp a row (chain_rows.cuh::
// chain_attempt), kernel 6 a warp a group of rows (pf_solve.cu), on the same
// barrier, slots and sum.
#pragma once

#include "tdmlp.cuh"

namespace lrnde {

// PIController defaults of ode/controller.py, rounded like the reference.
constexpr float kGamma = static_cast<float>(0.9);
constexpr float kBeta1 = static_cast<float>(0.14);
constexpr float kBeta2 = static_cast<float>(0.08);
constexpr float kInvQmax = static_cast<float>(1.0 / 10.0);
constexpr float kInvQmin = static_cast<float>(1.0 / 0.2);
constexpr float kQoldInit = static_cast<float>(1e-4);

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

// Slots loaded per round of ordered_slot_sum (2 KB of static shared memory).
constexpr int kSlotChunk = 512;

// The sum of slots[0, n) in index order, ((0 + s_0) + s_1) + ..., bitwise
// the sum of a one-thread loop over them, returned in thread 0 (0
// elsewhere). Every thread of the CTA (T of them) issues its slots' loads
// at once, coalesced, from L2 (the slots are written by other CTAs) into
// shared memory, and thread 0 folds them from there: one L2 round trip per
// kSlotChunk slots instead of one per slot on the thread that sums. All
// threads must call it; it synchronises the CTA.
template <int T>
__device__ inline float ordered_slot_sum(const float* slots, int n) {
  __shared__ float buf[kSlotChunk];
  float sum = 0.f;
  for (int c0 = 0; c0 < n; c0 += kSlotChunk) {
    const int m = min(kSlotChunk, n - c0);
#pragma unroll 4
    for (int i = threadIdx.x; i < m; i += T) buf[i] = __ldcg(slots + c0 + i);
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 8
      for (int i = 0; i < m; ++i) sum += buf[i];
    }
    __syncthreads();
  }
  return sum;
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

// The working buffers of an attempt, full batch, row-major (B, F):
// u is the committed state, k + j·BF holds k_{j+1} (k[0] the FSAL k1, read;
// k1..k6 receive k2..k7), unew the candidate state.
struct AttemptBufs {
  float* u;
  float* k;
  float* unew;
  size_t BF;
  int B;
};

// The step an attempt takes: dt clipped to the span, and the time reached.
struct AttemptPlan {
  float dt_c, t_new;
  int is_last;
};

__device__ inline AttemptPlan plan_attempt(float t, float dt, float t_end) {
  const float t_rem = t_end - t;
  AttemptPlan p;
  p.dt_c = fminf(dt, t_rem);
  p.is_last = dt >= t_rem;
  p.t_new = p.is_last ? t_end : t + p.dt_c;
  return p;
}

// The controller state of a whole solve, in shared memory.
struct Ctl {
  float t, dt, qold, res_t;
  AttemptPlan plan;
  int accept, take, done, natt, nacc, nrej;
};

struct NoHook {
  __device__ void operator()(int, const StepRows&, int) const {}
};

// One attempt over the whole batch from (u, t) with step dt_c: every CTA
// runs the Tsit5 step of the dynamics D (its tsit5_rows overload) on its row
// blocks of D::rows rows, calls hook(rb, rows, nrows) after each, stores the
// row block's error partial into its slot, then waits at the grid barrier
// and sums the slots (ordered_slot_sum). Returns the scaled error norm in
// thread 0 (0 elsewhere). The slots are
// double-buffered by the parity of the barrier count, so a CTA that runs
// ahead into the next attempt never overwrites slots another is still
// summing.
template <typename D, typename Hook>
__device__ inline float attempt_eest(const D& w, const typename D::Shared& sm,
                                     const AttemptBufs& b, float t,
                                     float dt_c, float atol, float rtol,
                                     float inv_n, float* slots,
                                     unsigned int* barrier,
                                     unsigned int& epoch, Hook hook) {
  constexpr int R = D::rows;
  const int F = w.F;
  const int n_blocks = (b.B + R - 1) / R;
  float* const s = slots + (epoch & 1u) * n_blocks;
  for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
    const size_t off = static_cast<size_t>(rb) * R * F;
    const int nrows = min(R, b.B - rb * R);
    StepRows p;
    p.u = b.u + off;
    for (int j = 0; j < 7; ++j) p.k[j] = b.k + j * b.BF + off;
    p.unew = b.unew + off;
    p.utilde = nullptr;
    p.g6 = nullptr;
    const float err = tsit5_rows(w, sm, p, t, dt_c, nrows, true, atol, rtol);
    hook(rb, p, nrows);
    if (threadIdx.x == 0) __stcg(s + rb, err);
  }
  ++epoch;
  grid_barrier(barrier, epoch * gridDim.x);
  const float err_sq = ordered_slot_sum<D::threads>(s, n_blocks);
  return threadIdx.x == 0 ? sqrtf(err_sq * inv_n) : 0.f;
}

// Commit an accepted attempt for this CTA's row blocks: u <- unew and
// k1 <- k7.
template <typename D>
__device__ inline void commit_rows(const AttemptBufs& b, int F) {
  constexpr int R = D::rows;
  const int n_blocks = (b.B + R - 1) / R;
  for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
    const size_t off = static_cast<size_t>(rb) * R * F;
    const int n = min(R, b.B - rb * R) * F;
    for (int i = threadIdx.x; i < n; i += D::threads) {
      b.u[off + i] = b.unew[off + i];
      b.k[off + i] = b.k[6 * b.BF + off + i];
    }
  }
}

// Copy this CTA's row blocks of src (B, F) to dst (B, F).
template <typename D>
__device__ inline void copy_rows(float* dst, const float* src, int B, int F) {
  constexpr int R = D::rows;
  const int n_blocks = (B + R - 1) / R;
  for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
    const size_t off = static_cast<size_t>(rb) * R * F;
    const int n = min(R, B - rb * R) * F;
    for (int i = threadIdx.x; i < n; i += D::threads) dst[off + i] = src[off + i];
  }
}

// The controller state of a two-level window replay (adjoint sweeps).
struct ReplayCtl {
  float t, dt, qold;
  AttemptPlan plan;
  int i, att, accept;
};

// Replay window w of a two-level solve from its checkpoint: re-run the
// forward's attempts (attempt_eest at the forward's row blocking) until
// n_steps are accepted or max_steps attempted, recording the accepted
// states of this CTA's rows in local_us (W + 1, B, F) and their times in
// lts (thread 0 of each CTA keeps its own copy). The replay repeats the
// forward's accept decisions and dt sequence bitwise. Returns the number
// of steps accepted.
template <typename D>
__device__ inline int replay_window(
    const D& w, const typename D::Shared& sm, const AttemptBufs& bufs,
    const float* ckpt_ts, const float* ckpt_us, const float* ckpt_ks,
    const float* ckpt_dts, const float* ckpt_qolds, int win, int n_steps,
    int max_steps, float t_end, float atol, float rtol, float inv_n,
    float* slots, unsigned int* barrier, unsigned int& epoch,
    ReplayCtl& ctl, float* lts, float* local_us) {
  const int B = bufs.B, F = w.F, tid = threadIdx.x;
  const size_t BF = bufs.BF;
  copy_rows<D>(bufs.u, ckpt_us + win * BF, B, F);
  copy_rows<D>(bufs.k, ckpt_ks + win * BF, B, F);
  copy_rows<D>(local_us, ckpt_us + win * BF, B, F);
  if (tid == 0) {
    ctl.t = ckpt_ts[win];
    ctl.dt = ckpt_dts[win];
    ctl.qold = ckpt_qolds[win];
    ctl.i = ctl.att = 0;
    lts[0] = ctl.t;
  }
  __syncthreads();
  while (ctl.i < n_steps && ctl.att < max_steps) {
    if (tid == 0) ctl.plan = plan_attempt(ctl.t, ctl.dt, t_end);
    __syncthreads();
    const float eest = attempt_eest(w, sm, bufs, ctl.t, ctl.plan.dt_c, atol,
                                    rtol, inv_n, slots, barrier, epoch,
                                    NoHook{});
    if (tid == 0) {
      const bool accept = eest <= 1.f;
      float dt_acc, dt_rej, qold_acc;
      propose(eest, ctl.plan.dt_c, ctl.qold, &dt_acc, &dt_rej, &qold_acc);
      ctl.accept = accept;
      if (accept) {
        ctl.t = ctl.plan.t_new;
        ctl.dt = dt_acc;
        ctl.qold = qold_acc;
        ++ctl.i;
        lts[ctl.i] = ctl.t;
      } else {
        ctl.dt = dt_rej;
      }
      ++ctl.att;
    }
    __syncthreads();
    if (ctl.accept) {
      commit_rows<D>(bufs, F);
      copy_rows<D>(local_us + ctl.i * BF, bufs.u, B, F);
    }
    __syncthreads();
  }
  return ctl.i;
}

// Cooperative launch of a whole-grid kernel: one CTA of D::threads threads
// per row block of D::rows rows, capped at what can be co-resident; the
// launch refuses a grid that cannot be.
template <typename D, typename Kernel, typename Args>
inline cudaError_t launch_cooperative(Kernel kernel, Args* args, int B,
                                      size_t smem, cudaStream_t stream,
                                      int* grid_out) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      D::threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int n_blocks = (B + D::rows - 1) / D::rows;
  const int grid = min(n_blocks, per_sm * n_sm);
  if (grid_out != nullptr) *grid_out = grid;
  void* kargs[] = {args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(grid), dim3(D::threads), kargs, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace lrnde
