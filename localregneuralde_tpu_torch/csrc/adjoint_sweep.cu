// Kernels 7 and 8: the whole reverse sweep of the stored adjoint for the
// TD-MLP dynamics, dense (two_level = 0) or two-level, in one launch.
//
// Replaces localregneuralde_tpu/ops/pallas/fused_solve_bwd.py::_make_kernel
// (called from persistent_stored_sweep and persistent_two_level_sweep). On
// the TPU one core swept the whole batch, tile by tile, step by step, with
// the weight gradients accumulating in VMEM across the sequential grid.
// Here rows are independent in the backward, and only the weight gradients
// couple them: each thread-block cluster sweeps its own blocks of
// kSweepRows rows through all accepted steps in reverse, each CTA of it on
// its slice of the features (sweep_cluster.cuh), carrying a_u (state
// cotangent) and a_k (the FSAL cotangent on the incoming k1) in the output
// buffers. Per step it recomputes k1 from the knot (u_j, t_j) and the six
// stages, seeds the stage cotangents with the saveat cotangents (Tsit5
// interpolant weights, where s ∈ (t_j, t_j+1]) and a_k, and transposes the
// stages, adding the weight gradient into the gradient slices it keeps in
// shared memory for the whole sweep (or, for a TD-MLP too wide for that,
// into its cluster's partial); each cluster writes one partial and a
// second kernel sums the partials in cluster order. naccept is
// read on the device.
//
// Two-level mode, when naccept > dense_cap: one W-step window at a time, in
// reverse, every CTA replays the window from its checkpoint with the forward
// kernel's own attempt (solve.cuh::replay_window at the forward's row
// blocking, grid-stride, one grid barrier per attempt, at 512 threads a CTA
// with the forward's arithmetic: TDMLPSweep in sweep_cluster.cuh; its Smem
// lies over the weight slices, which are loaded again after it), recording
// the accepted states in local_us, and then the clusters sweep the count
// the replay actually accepted, min(replayed, n_steps). The replay repeats the
// forward's accept and dt sequence bitwise whatever the grid. Its row blocks
// are not the sweep's, so a grid barrier follows each replay and precedes
// the next. The grid barrier needs every CTA resident: the grid is at most
// cudaOccupancyMaxActiveClusters clusters (the clusters then loop over the
// row blocks), in both modes; a launch the card refuses raises.
//
// Tiers (lrnde_adjoint_sweep_tiered; sweep_cluster.cuh's kTier bits): the
// stage recompute, the cotangent and weight-gradient products, and the
// window replay each at FP32 or TF32, as the reference routes its
// recompute_precision, grad_precision and precision. The TF32 replay must
// repeat kernel 4's TF32 forward bitwise, whose products group each CTA's
// k ≡ c (mod 8) features (solve_cluster.cuh); TDMLPSweep's attempt sums in
// the first port's order and cannot. So it runs kernel 4's own attempt
// inside this kernel (replay_tf32 below): kernel 4's layout with its tiles
// over this CTA's work region and the weights read from global memory in
// kernel 4's order (kShared false), on the sweep's clusters, one launch, no
// host read. (The other way, a kernel-4 launch a window from the wrapper,
// would need the window count, naccept, on the host, which a captured step
// cannot read.)
//
// What bounds it on an H100: per step, 38 FP32 products of 36 × ~100 ×
// ~100 per CTA (the seven evaluations, the six stages' dh and dx, and the
// two weight-gradient updates) and 13 cluster reductions; ~420 µs a step on
// an NVIDIA H100 80GB HBM3 at 700 W, against 1,177 µs for the design it replaced
// (one CTA of 8 rows, weights from L2, a 0.63 MB read-modify-write of a
// per-CTA gradient partial every step) and a bound of ~46 µs (PERF.md
// §6). The replay runs the forward's attempt at 512 threads a CTA, half
// the forward's, on 64 of the 120 CTAs: ~2x the forward's time.
#include "solve_cluster.cuh"

namespace lrnde {

constexpr int kMaxSave = 8;

struct SweepArgs {
  int two_level;
  TDMLP w;
  const float* knot_ts;   // (n_dense)
  const float* knot_us;   // (n_dense, B, F)
  const int* naccept;
  const float* saveat;    // (n_save)
  int n_save;
  const float* ct_ys;     // (n_save, B, F)
  const float* ct_y;      // (B, F)
  const float* ckpt_ts;   // two-level only: (n_ckpt)
  const float* ckpt_us;   // (n_ckpt, B, F)
  const float* ckpt_ks;   // (n_ckpt, B, F)
  const float* ckpt_dts;
  const float* ckpt_qolds;
  float t_end, rtol, atol;
  int max_steps, stride, dense_cap;
  float* a_u;             // (B, F)
  float* a_k;             // (B, F)
  float* scratch;         // sweep_scratch_floats(B, F, H)
  float* part;            // (clusters, grad_floats)
  float* slots;           // two-level: (2, ceil(B / kRows))
  unsigned int* barrier;  // two-level: zero at launch
  float* local_ts;        // two-level: (gridDim.x, W + 1)
  float* local_us;        // two-level: (W + 1, B, F)
  int B;
  float inv_n;
  unsigned long long* timing;  // timed instantiation: (kSwPhases + 1)
};

struct StepWeights {
  float wt[kMaxSave][7];  // dt·b_m(θ_s)·hit_s
  float hit[kMaxSave];
  float t, dt;
};

// The seed of the stage cotangents: column m of the saveat hits (weights
// sw.wt) at one element, Σ_q wt[q][m]·ct_q in q order.
__device__ inline float seed_of(const StepWeights& sw, int n_save,
                                const float (&ct)[kMaxSave], int m) {
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxSave; ++q)
    if (q < n_save) acc = fmaf(sw.wt[q][m], ct[q], acc);
  return acc;
}

__device__ inline void load_cts(const float* __restrict__ ct_ys, size_t o,
                                size_t BF, int n_save, float (&ct)[kMaxSave]) {
#pragma unroll
  for (int q = 0; q < kMaxSave; ++q) ct[q] = q < n_save ? ct_ys[q * BF + o] : 0.f;
}

// The seed of the sweep's transposed step (sweep_cluster.cuh::
// transpose_rows) at one row block: the saveat cotangents through the
// interpolant weights (sw), the FSAL carry a_k on k7 and the state carry
// a_u on u_new; it writes the carries of the step before.
struct SweepSeed {
  const StepWeights& sw;
  int n_save;
  size_t BF;
  const float* __restrict__ ct_ys;  // offset to the CTA's corner
  float* a_u;
  float* a_k;
  __device__ float k7(size_t o) const {
    float ct[kMaxSave];
    load_cts(ct_ys, o, BF, n_save, ct);
    return __fadd_rn(seed_of(sw, n_save, ct, 6), a_k[o]);
  }
  __device__ void ks(size_t o, float (&dk)[6]) const {
    float ct[kMaxSave];
    load_cts(ct_ys, o, BF, n_save, ct);
#pragma unroll
    for (int q = 0; q < 6; ++q) dk[q] = seed_of(sw, n_save, ct, q);
  }
  __device__ float x(int i, size_t o, float dx) const {
    return i == 5 ? __fadd_rn(dx, a_u[o]) : dx;
  }
  // a_u <- d_u + Σ_hit ct_ys ; a_k <- d_k1
  __device__ void finish(size_t o, float du, float dk1) const {
    float ct[kMaxSave];
    load_cts(ct_ys, o, BF, n_save, ct);
    float dint = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSave; ++q)
      if (q < n_save) dint = fmaf(ct[q], sw.hit[q], dint);
    a_u[o] = __fadd_rn(du, dint);
    a_k[o] = dk1;
  }
};

// Transpose accepted steps n_hi-1 .. 0 whose start times are ts[j] and start
// states us + j·BF, for this cluster's row blocks and this CTA's slice,
// adding the weight gradient into gs.
template <bool kTime, bool kShared, int kTiers>
__device__ void sweep_range(const SweepArgs& a, const SweepSmem& s,
                            const GradSink<kShared>& gs, StepWeights& sw,
                            int n_hi, const float* ts, const float* us,
                            SweepClock<kTime>& clk) {
  const int F = a.w.F, B = a.B, tid = threadIdx.x;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const SweepSlice sl = sweep_slice(F, rank);
  const int n_rb = (B + kSweepRows - 1) / kSweepRows;
  const int cid = blockIdx.x / kSweepCluster;
  const int ncl = gridDim.x / kSweepCluster;
  const size_t BF = static_cast<size_t>(B) * F;
  const int n_save = a.n_save;
  for (int j = n_hi - 1; j >= 0; --j) {
    clk.start();
    if (tid == 0) {
      const float t = ts[j], tn = ts[j + 1];
      const float dt = tn - t;
      sw.t = t;
      sw.dt = dt;
      for (int q = 0; q < n_save; ++q) {
        const float st = a.saveat[q];
        const float hit = (st > t && st <= tn) ? 1.f : 0.f;
        float b[7];
        interp_weights(fminf(fmaxf((st - t) / dt, 0.f), 1.f), b);
        for (int m = 0; m < 7; ++m) sw.wt[q][m] = dt * b[m] * hit;
        sw.hit[q] = hit;
      }
    }
    __syncthreads();
    for (int rb = cid; rb < n_rb; rb += ncl) {
      const int row0 = rb * kSweepRows;
      const int nrows = min(kSweepRows, B - row0);
      const size_t off = static_cast<size_t>(row0) * F + sl.f0;
      const SweepSeed seed{sw, n_save, BF, a.ct_ys + off, a.a_u + off,
                           a.a_k + off};
      transpose_rows<kTime, kShared, kTiers>(
          a.w, s, sl, gs, rank, B, row0, nrows, sw.t, sw.dt, us + j * BF + off,
          nullptr, a.scratch, seed, clk);
    }
  }
}

// solve.cuh::replay_window at the sweep's thread count (TDMLPSweep,
// sweep_cluster.cuh), not inlined: the attempt code keeps its own register
// allocation, apart from the sweep's.
__device__ __noinline__ int replay(
    TDMLPSweep w, Smem rs, AttemptBufs bufs, const float* ckpt_ts,
    const float* ckpt_us, const float* ckpt_ks, const float* ckpt_dts,
    const float* ckpt_qolds, int win, int n_steps, int max_steps, float t_end,
    float atol, float rtol, float inv_n, float* slots, unsigned int* barrier,
    unsigned int& epoch, ReplayCtl& ctl, float* lts, float* local_us) {
  return replay_window(w, rs, bufs, ckpt_ts, ckpt_us, ckpt_ks, ckpt_dts,
                       ckpt_qolds, win, n_steps, max_steps, t_end, atol, rtol,
                       inv_n, slots, barrier, epoch, ctl, lts, local_us);
}

// The rows of a cluster in the TF32 replay: the most, a multiple of kRows,
// whose kernel-4 tiles (without the weight slices) fit the sweep's work
// region; 0 where none do.
__host__ __device__ inline int replay_cluster_rows(int F, int H) {
  for (int R = kSolveRowsMax; R >= kRows; R -= kRows)
    if (solve_tile_floats(F, H, R) <= sweep_work_floats(F, H)) return R;
  return 0;
}

// Window win of a two-level sweep replayed at the TF32 tier from its
// checkpoint with kernel 4's attempt (persistent_solve.cu: solve_stages, the
// error pass, the grid barrier, the slot sum and the controller), until
// n_steps are accepted or max_steps attempted; R rows a cluster
// (replay_cluster_rows), the clusters looping over the row blocks. The error
// norm does not depend on the grid, so the replay repeats kernel 4's TF32
// forward bitwise. It records as replay_window does: the accepted states
// row-major in local_us, their times in lts. Returns the steps accepted.
__device__ __noinline__ int replay_tf32(const SweepArgs& a, int work, int win,
                                        int n_steps, unsigned int& epoch,
                                        ReplayCtl& ctl, float* lts) {
  const TDMLP& w = a.w;
  const int F = w.F, H = w.H, B = a.B, tid = threadIdx.x;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int cid = blockIdx.x / kSweepCluster;
  const int ncl = gridDim.x / kSweepCluster;
  const int R = replay_cluster_rows(F, H);
  SolveSmem s = carve_solve_smem(F, H, R, false);
  s.w1 += work;
  s.w2 += work;
  s.b1 += work;
  s.w1t += work;
  s.b2 += work;
  s.w2t += work;
  s.xa += work;
  s.hb += work;
  s.inbox += work;
  s.rt += work;
  s.red += work;
  const SolveSlice sl{rank, (solve_count(F, rank) + 1) / 2,
                      solve_count(F, rank) / 2, s.odd0};
  const int n_el = sl.ne + sl.no;
  const size_t rs = static_cast<size_t>(kSweepCluster) * s.seg;
  const size_t BS = static_cast<size_t>(B) * rs;
  const size_t BF = static_cast<size_t>(B) * F;
  const int n_rb = (B + R - 1) / R;
  const int n_blocks = (B + kRows - 1) / kRows;
  SolveClock<false> clk{nullptr};
  // kernel 4's state buffers in the segment layout, over the scratch
  float* u = a.scratch + rank * s.seg;
  float* unew = u + BS;
  float* k[7];
  for (int j = 0; j < 7; ++j) k[j] = u + (2 + j) * BS;
  auto each = [&](auto fn) {
    for (int rb = cid; rb < n_rb; rb += ncl) {
      const int row0 = rb * R, nrows = min(R, B - row0);
      for (int i = tid; i < nrows * n_el; i += kSolveThreads) {
        const int r = row0 + i / n_el, l = solve_local(sl, i % n_el);
        fn(static_cast<size_t>(r) * F + slice_feature(sl, l), r * rs + l);
      }
    }
  };
  load_solve_weights<false, true>(w, s, sl);
  const float* const cu = a.ckpt_us + win * BF;
  const float* const ck = a.ckpt_ks + win * BF;
  each([&](size_t on, size_t o) {
    u[o] = cu[on];
    k[0][o] = ck[on];
    a.local_us[on] = cu[on];
  });
  if (tid == 0) {
    ctl.t = a.ckpt_ts[win];
    ctl.dt = a.ckpt_dts[win];
    ctl.qold = a.ckpt_qolds[win];
    ctl.i = ctl.att = 0;
    lts[0] = ctl.t;
  }
  // every CTA of the cluster runs before any remote store
  cg::this_cluster().sync();
  while (ctl.i < n_steps && ctl.att < a.max_steps) {
    if (tid == 0) ctl.plan = plan_attempt(ctl.t, ctl.dt, a.t_end);
    __syncthreads();
    const float t = ctl.t, dt = ctl.plan.dt_c;
    float* const slots = a.slots + (epoch & 1u) * n_blocks;
    for (int rb = cid; rb < n_rb; rb += ncl) {
      const int row0 = rb * R, nrows = min(R, B - row0);
      const size_t off = row0 * rs;
      float* kr[7];
      for (int j = 0; j < 7; ++j) kr[j] = k[j] + off;
      solve_stages<false, true>(w, s, sl, rank, nrows, t, dt, kr, u + off,
                                nullptr, unew + off, rs, clk);
      solve_push_residuals(s, sl, rank, nrows, dt, kr, u + off, unew + off,
                           rs, a.atol, a.rtol);
      cg::this_cluster().sync();
      solve_block_error(s, rank, nrows, F, row0, slots);
    }
    ++epoch;
    grid_barrier(a.barrier, epoch * gridDim.x);
    const float err_sq = ordered_slot_sum<kSolveThreads>(slots, n_blocks);
    if (tid == 0) {
      const float eest = sqrtf(err_sq * a.inv_n);
      float dt_acc, dt_rej, qold_acc;
      propose(eest, dt, ctl.qold, &dt_acc, &dt_rej, &qold_acc);
      ctl.accept = eest <= 1.f;
      if (ctl.accept) {
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
      // commit: u <- u_new, k1 <- k7, by swapping the buffers
      float* const swap_u = u;
      u = unew;
      unew = swap_u;
      float* const swap_k = k[0];
      k[0] = k[6];
      k[6] = swap_k;
      float* const dst = a.local_us + ctl.i * BF;
      each([&](size_t on, size_t o) { dst[on] = u[o]; });
    }
    __syncthreads();
  }
  return ctl.i;
}

template <bool kTime, bool kShared, int kTiers>
__global__ void __launch_bounds__(kSweepThreads)
adjoint_sweep_kernel(SweepArgs a) {
  __shared__ StepWeights sw;
  __shared__ ReplayCtl ctl;
  const int F = a.w.F, H = a.w.H, B = a.B, tid = threadIdx.x;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const SweepSlice sl = sweep_slice(F, rank);
  const SweepSmem s = carve_sweep_smem(F, H);
  const size_t BF = static_cast<size_t>(B) * F;
  const int cid = blockIdx.x / kSweepCluster;
  const int ncl = gridDim.x / kSweepCluster;
  const int n = *a.naccept;
  SweepClock<kTime> clk;

  float* const part = a.part + cid * grad_floats(F, H);
  const GradSink<kShared> gs(s, sl, F, H, part);
  zero_grads<kShared>(F, H, sl, rank, part);
  load_weight_slices(a.w, s, sl);
  const int n_rb = (B + kSweepRows - 1) / kSweepRows;
  for (int rb = cid; rb < n_rb; rb += ncl) {
    const int row0 = rb * kSweepRows;
    const int nel = min(kSweepRows, B - row0) * sl.n;
    for (int i = tid; i < nel; i += kSweepThreads) {
      const size_t o = static_cast<size_t>(row0 + i / sl.n) * F + sl.f0 +
                       i % sl.n;
      a.a_u[o] = a.ct_y[o];
      a.a_k[o] = 0.f;
    }
  }
  // every CTA of the cluster runs before any writes into another's inbox
  cg::this_cluster().sync();

  if (!a.two_level || n <= a.dense_cap) {
    sweep_range<kTime, kShared, kTiers>(a, s, gs, sw, n, a.knot_ts, a.knot_us,
                                        clk);
  } else {
    // ---- windowed replay from the checkpoints, last window first
    const int W = a.stride;
    float* const lts = a.local_ts + blockIdx.x * (W + 1);
    const AttemptBufs bufs{a.scratch, a.scratch + BF, a.scratch + 8 * BF, BF,
                           B};
    const Smem rs = carve_smem(sweep_smem + s.work, F, H);
    unsigned int epoch = 0;
    for (int w = (n - 1) / W; w >= 0; --w) {
      const int n_steps = min(max(n - w * W, 0), W);
      // every CTA is done with the last window's local_us and scratch
      ++epoch;
      grid_barrier(a.barrier, epoch * gridDim.x);
      int got;
      if constexpr ((kTiers & kTierReplay) != 0) {
        got = replay_tf32(a, s.work, w, n_steps, epoch, ctl, lts);
      } else {
        const TDMLPSweep wr{a.w.w1, a.w.b1, a.w.w2, a.w.b2, F, H};
        got = replay(wr, rs, bufs, a.ckpt_ts, a.ckpt_us, a.ckpt_ks,
                     a.ckpt_dts, a.ckpt_qolds, w, n_steps, a.max_steps,
                     a.t_end, a.atol, a.rtol, a.inv_n, a.slots, a.barrier,
                     epoch, ctl, lts, a.local_us);
      }
      // every replayed row is in local_us
      ++epoch;
      grid_barrier(a.barrier, epoch * gridDim.x);
      load_weight_slices(a.w, s, sl);
      __syncthreads();
      // sweep what the replay accepted: an accept flip must not sweep slots
      // it never wrote
      sweep_range<kTime, kShared, kTiers>(a, s, gs, sw, min(got, n_steps),
                                          lts, a.local_us, clk);
    }
  }
  if constexpr (kShared) {
    __syncthreads();
    store_grad_slices(s, sl, F, H, rank, part);
  }
  clk.write(a.timing, n);
}

// The launch configuration of the sweep: clusters of kSweepCluster CTAs,
// as many as there are row blocks of kSweepRows and at most as many as can
// be resident at once (the two-level mode's grid barrier needs that).
// *clusters returns the count, which is also the number of partials.
template <typename Kernel>
inline cudaError_t sweep_config(Kernel kernel, int B, size_t smem,
                                cudaStream_t stream, cudaLaunchAttribute* attr,
                                cudaLaunchConfig_t* cfg, int* clusters) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kSweepCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  const int n_rb = (B + kSweepRows - 1) / kSweepRows;
  cfg->gridDim = dim3(n_rb * kSweepCluster);
  cfg->blockDim = dim3(kSweepThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  // the query costs host time: once per shared-memory size
  static size_t known_smem = 0;
  static int known = 0;
  if (smem != known_smem) {
    int max_clusters = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&max_clusters, kernel, cfg);
    if (err != cudaSuccess) return err;
    known_smem = smem;
    known = max_clusters;
  }
  if (known < 1) return cudaErrorCooperativeLaunchTooLarge;
  *clusters = min(n_rb, known);
  cfg->gridDim = dim3(*clusters * kSweepCluster);
  return cudaSuccess;
}

// Launch the sweep kernel for SweepArgs a (or, with a null, only find the
// cluster count) with the gradient slices in shared memory or not, as
// sweep_grads_shared says for (F, H). *clusters returns the count.
template <bool kTime, bool kShared, int kTiers = 0>
static cudaError_t launch_sweep(const SweepArgs* a, int B, int F, int H,
                                cudaStream_t stream, int* clusters) {
  const auto kernel = adjoint_sweep_kernel<kTime, kShared, kTiers>;
  const size_t smem = sweep_smem_floats(F, H) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  err = sweep_config(kernel, B, smem, stream, &attr, &cfg, clusters);
  if (err != cudaSuccess || a == nullptr) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, *a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The reverse sweep of the stored adjoint over *naccept recorded steps
// (dense), or, with two_level and *naccept > dense_cap, over windows
// replayed from the checkpoints. Writes a_u, a_k and the flat weight
// gradient d_w; part holds one partial per cluster (at most ceil(B /
// kSweepRows)). Returns cudaGetLastError().
template <bool kTime, int kTiers = 0>
static int adjoint_sweep(
    int two_level, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* knot_ts, const float* knot_us,
    const int* naccept, const float* saveat, int n_save, const float* ct_ys,
    const float* ct_y, const float* ckpt_ts, const float* ckpt_us,
    const float* ckpt_ks, const float* ckpt_dts, const float* ckpt_qolds,
    float t_end, float rtol, float atol, int max_steps, int stride,
    int dense_cap, float* a_u, float* a_k, float* d_w, float* scratch,
    float* part, float* slots, unsigned int* barrier, float* local_ts,
    float* local_us, int B, int F, int H, float inv_n,
    unsigned long long* timing, void* stream) {
  if (n_save > kMaxSave || (two_level && stride < 1))
    return cudaErrorInvalidValue;
  SweepArgs a{two_level, TDMLP{w1, b1, w2, b2, F, H}, knot_ts, knot_us,
              naccept, saveat, n_save, ct_ys, ct_y, ckpt_ts, ckpt_us,
              ckpt_ks, ckpt_dts, ckpt_qolds, t_end, rtol, atol, max_steps,
              stride, dense_cap, a_u, a_k, scratch, part, slots, barrier,
              local_ts, local_us, B, inv_n, timing};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int clusters = 0;
  if ((kTiers & kTierReplay) != 0 && two_level &&
      replay_cluster_rows(F, H) < kRows)
    return cudaErrorInvalidValue;
  const cudaError_t err =
      sweep_grads_shared(F, H)
          ? launch_sweep<kTime, true, kTiers>(&a, B, F, H, s, &clusters)
          : launch_sweep<kTime, false, kTiers>(&a, B, F, H, s, &clusters);
  if (err != cudaSuccess) return err;
  return reduce_partials(part, clusters, grad_floats(F, H), d_w, s);
}

}  // namespace lrnde

// The sweep's layout, for the wrapper's plan (fused_solve_bwd.py::
// sweep_plan) to check against: CTAs per cluster, rows per cluster, and
// the floats of dynamic shared memory and of global scratch.
extern "C" int lrnde_sweep_cluster() { return lrnde::kSweepCluster; }
extern "C" int lrnde_sweep_rows() { return lrnde::kSweepRows; }
extern "C" long long lrnde_sweep_smem_floats(int F, int H) {
  return static_cast<long long>(lrnde::sweep_smem_floats(F, H));
}
extern "C" long long lrnde_sweep_scratch_floats(int B, int F, int H) {
  return static_cast<long long>(lrnde::sweep_scratch_floats(B, F, H));
}

// The clusters a sweep launch at (B, F, H) takes on this card: the row
// blocks, at most as many as can run at once. Negative: a CUDA error.
extern "C" int lrnde_sweep_clusters(int B, int F, int H) {
  using namespace lrnde;
  int clusters = 0;
  const cudaError_t err =
      sweep_grads_shared(F, H)
          ? launch_sweep<false, true>(nullptr, B, F, H, nullptr, &clusters)
          : launch_sweep<false, false>(nullptr, B, F, H, nullptr, &clusters);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

extern "C" int lrnde_adjoint_sweep(
    int two_level, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* knot_ts, const float* knot_us,
    const int* naccept, const float* saveat, int n_save, const float* ct_ys,
    const float* ct_y, const float* ckpt_ts, const float* ckpt_us,
    const float* ckpt_ks, const float* ckpt_dts, const float* ckpt_qolds,
    float t_end, float rtol, float atol, int max_steps, int stride,
    int dense_cap, float* a_u, float* a_k, float* d_w, float* scratch,
    float* part, float* slots, unsigned int* barrier, float* local_ts,
    float* local_us, int B, int F, int H, float inv_n, void* stream) {
  return lrnde::adjoint_sweep<false>(
      two_level, w1, b1, w2, b2, knot_ts, knot_us, naccept, saveat, n_save,
      ct_ys, ct_y, ckpt_ts, ckpt_us, ckpt_ks, ckpt_dts, ckpt_qolds, t_end,
      rtol, atol, max_steps, stride, dense_cap, a_u, a_k, d_w, scratch, part,
      slots, barrier, local_ts, local_us, B, F, H, inv_n, nullptr, stream);
}

// lrnde_adjoint_sweep at the product tiers `tiers` (sweep_cluster.cuh's
// kTier bits; all FP32 is lrnde_adjoint_sweep): kTierGrad (the reference's
// default-tier gradients behind an FP32 recompute and replay),
// kTierRecompute | kTierGrad (also the recompute: grad_precision='default'),
// or all three (the forward at TF32: its replay too); any other value, or a
// TF32 replay whose tiles fit no 8 rows (lrnde_sweep_replay_rows = 0), fails
// with cudaErrorInvalidValue.
extern "C" int lrnde_adjoint_sweep_tiered(
    int tiers, int two_level, const float* w1, const float* b1,
    const float* w2, const float* b2, const float* knot_ts,
    const float* knot_us, const int* naccept, const float* saveat, int n_save,
    const float* ct_ys, const float* ct_y, const float* ckpt_ts,
    const float* ckpt_us, const float* ckpt_ks, const float* ckpt_dts,
    const float* ckpt_qolds, float t_end, float rtol, float atol,
    int max_steps, int stride, int dense_cap, float* a_u, float* a_k,
    float* d_w, float* scratch, float* part, float* slots,
    unsigned int* barrier, float* local_ts, float* local_us, int B, int F,
    int H, float inv_n, void* stream) {
  using namespace lrnde;
#define LRNDE_SWEEP(T)                                                        \
  adjoint_sweep<false, T>(two_level, w1, b1, w2, b2, knot_ts, knot_us,        \
                          naccept, saveat, n_save, ct_ys, ct_y, ckpt_ts,      \
                          ckpt_us, ckpt_ks, ckpt_dts, ckpt_qolds, t_end,      \
                          rtol, atol, max_steps, stride, dense_cap, a_u, a_k, \
                          d_w, scratch, part, slots, barrier, local_ts,       \
                          local_us, B, F, H, inv_n, nullptr, stream)
  switch (tiers) {
    case kTierGrad:
      return LRNDE_SWEEP(kTierGrad);
    case kTierRecompute | kTierGrad:
      return LRNDE_SWEEP(kTierRecompute | kTierGrad);
    case kTierRecompute | kTierGrad | kTierReplay:
      return LRNDE_SWEEP(kTierRecompute | kTierGrad | kTierReplay);
    default:
      return cudaErrorInvalidValue;
  }
#undef LRNDE_SWEEP
}

// The rows of a cluster in the TF32 window replay at (F, H) (0: none fit).
extern "C" int lrnde_sweep_replay_rows(int F, int H) {
  return lrnde::replay_cluster_rows(F, H);
}

// The sweep with its transposed steps' phases timed: lrnde_adjoint_sweep's
// contract, plus timing (kSwPhases + 1 unsigned 64-bit integers): CTA 0's
// nanoseconds in each SweepPhase, summed over the steps, then the number of
// steps. A separate instantiation; the untimed kernel carries no clock
// reads and no extra barriers.
extern "C" int lrnde_adjoint_sweep_timed(
    int two_level, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* knot_ts, const float* knot_us,
    const int* naccept, const float* saveat, int n_save, const float* ct_ys,
    const float* ct_y, const float* ckpt_ts, const float* ckpt_us,
    const float* ckpt_ks, const float* ckpt_dts, const float* ckpt_qolds,
    float t_end, float rtol, float atol, int max_steps, int stride,
    int dense_cap, float* a_u, float* a_k, float* d_w, float* scratch,
    float* part, float* slots, unsigned int* barrier, float* local_ts,
    float* local_us, int B, int F, int H, float inv_n,
    unsigned long long* timing, void* stream) {
  if (timing == nullptr) return cudaErrorInvalidValue;
  return lrnde::adjoint_sweep<true>(
      two_level, w1, b1, w2, b2, knot_ts, knot_us, naccept, saveat, n_save,
      ct_ys, ct_y, ckpt_ts, ckpt_us, ckpt_ks, ckpt_dts, ckpt_qolds, t_end,
      rtol, atol, max_steps, stride, dense_cap, a_u, a_k, d_w, scratch, part,
      slots, barrier, local_ts, local_us, B, F, H, inv_n, timing, stream);
}

// The number of attribution phases of lrnde_adjoint_sweep_timed.
extern "C" int lrnde_sweep_phases() { return lrnde::kSwPhases; }
