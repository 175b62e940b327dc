// Kernel 4: the whole adaptive Tsit5 solve of the TD-MLP dynamics in one
// launch on thread-block clusters, with the knot and checkpoint recording of
// the stored adjoint and the reservoir sample of the biased regulariser.
//
// Replaces localregneuralde_tpu/ops/pallas/fused_solve.py::_make_kernel
// (family ("tdmlp",), built by _build_call and called from
// persistent_tsit5_solve). On the TPU one core ran the accept/reject loop
// with the state resident in VMEM.
//
// Layout (solve_cluster.cuh). A cluster of kSweepCluster = 8 CTAs owns a
// block of R batch rows (solve_rows: 40 where the weights fit, so B = 512
// takes 13 clusters; R is a multiple of 8, so each 8-row error block lies
// in one cluster); CTA c owns the features k ≡ c (mod 8), with its weight
// slices resident, and its segment of u, u_new and k1..k7.
//
// Bitwise the kernel it replaced (a CTA of 1,024 threads per 8-row block,
// weights from L2; the first port's TD-MLP evaluation and
// solve.cuh::attempt_eest):
//  - the six stages: solve_cluster.cuh::solve_stages, whose evaluation
//    keeps the first port's summation orders.
//  - ũ, the scaled residuals and the dense output are elementwise, written
//    with the old kernel's expressions.
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
// rounding noise). The TF32 instantiation (kTf32, the reference's 'default'
// precision, which 'auto' takes at rtol ≥ 1e-4; lrnde_persistent_tsit5_tf32)
// runs the same attempt with solve_cluster.cuh's TF32 products; its error
// norm, controller and recording are the FP32 kernel's.
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
#include "solve_cluster.cuh"

namespace lrnde {

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

template <bool kShared, bool kTime, bool kTf32>
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
  load_solve_weights<kShared, kTf32>(w, s, sl);
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
  clk.start();
  while (!ctl.done && ctl.natt < a.max_steps) {
    if (tid == 0) ctl.plan = plan_attempt(ctl.t, ctl.dt, t_end);
    __syncthreads();
    const float t = ctl.t, dt = ctl.plan.dt_c, t_new = ctl.plan.t_new;
    float* const slots = a.slots + (epoch & 1u) * n_blocks;
    for (int rb = cid; rb < n_rb; rb += ncl) {
      const int row0 = rb * R, nrows = min(R, B - row0);
      const size_t off = row0 * rs;
      float* kr[7];
      for (int j = 0; j < 7; ++j) kr[j] = k[j] + off;
      const float* const ur = u + off;
      solve_stages<kShared, kTf32>(w, s, sl, rank, nrows, t, dt, kr, ur,
                                   nullptr, unew + off, rs, clk);
      // ũ and the scaled residuals into the tiles that sum their blocks
      solve_push_residuals(s, sl, rank, nrows, dt, kr, ur, unew + off, rs,
                           a.atol, a.rtol);
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
      solve_block_error(s, rank, nrows, F, row0, slots);
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

// Launch (or, with a null, only size) the cluster solve at (B, F, H).
template <bool kShared, bool kTime, bool kTf32>
static cudaError_t launch_cluster_solve(const ClusterSolveArgs* a, int B,
                                        int F, int H, int R,
                                        cudaStream_t stream, int* clusters) {
  auto kernel = cluster_solve_kernel<kShared, kTime, kTf32>;
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

template <bool kTime, bool kTf32 = false>
static cudaError_t cluster_solve(const ClusterSolveArgs* a, int B, int F,
                                 int H, cudaStream_t stream, int* clusters) {
  int R = 0;
  bool shared = false;
  if (!solve_plan(F, H, &R, &shared)) return cudaErrorInvalidValue;
  return shared ? launch_cluster_solve<true, kTime, kTf32>(a, B, F, H, R,
                                                           stream, clusters)
                : launch_cluster_solve<false, kTime, kTf32>(a, B, F, H, R,
                                                            stream, clusters);
}

template <bool kTime, bool kTf32 = false>
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
  return cluster_solve<kTime, kTf32>(&a, B, F, H,
                                     static_cast<cudaStream_t>(stream),
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

// lrnde_persistent_tsit5 at the TF32 tier: its products on the tensor cores
// (solve_cluster.cuh), the rest as the FP32 kernel's.
extern "C" int lrnde_persistent_tsit5_tf32(
    const float* u0, const float* k10, const float* sc, const float* saveat,
    int n_save, const float* w1, const float* b1, const float* w2,
    const float* b2, float* u, float* ys, int* stats_i, float* stats_f,
    float* scratch, float* slots, unsigned int* barrier, int B, int F, int H,
    int max_steps, float rtol, float atol, float inv_n, float* knot_ts,
    float* knot_us, int n_dense, float* ckpt_ts, float* ckpt_us,
    float* ckpt_ks, float* ckpt_dts, float* ckpt_qolds, int n_ckpt,
    int stride, const float* rand, float* res_u, void* stream) {
  return lrnde::persistent_tsit5<false, true>(
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

// The rows of the first port's error blocks, which the solve's and the
// sweeps' slots keep.
extern "C" int lrnde_rows_per_block() { return lrnde::kRows; }

extern "C" const char* lrnde_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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

// solve.cuh::ordered_slot_sum alone on n slots, out[0] = the in-order sum:
// one CTA of 128 threads, for the card tests. Returns cudaGetLastError().
extern "C" int lrnde_slot_sum(const float* slots, int n, float* out,
                              void* stream) {
  lrnde::slot_sum_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      slots, n, out);
  return cudaGetLastError();
}
