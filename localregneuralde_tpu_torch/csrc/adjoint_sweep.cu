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
// What bounds it on an H100: per step, 38 FP32 products of 36 × ~100 ×
// ~100 per CTA (the seven evaluations, the six stages' dh and dx, and the
// two weight-gradient updates) and 13 cluster reductions; ~420 µs a step on
// an NVIDIA H100 80GB HBM3 at 700 W, against 1,177 µs for the design it replaced
// (one CTA of 8 rows, weights from L2, a 0.63 MB read-modify-write of a
// per-CTA gradient partial every step) and a bound of ~46 µs (PERF.md
// §6). The replay runs the forward's attempt at 512 threads a CTA, half
// the forward's, on 64 of the 120 CTAs: ~2x the forward's time.
#include "solve.cuh"
#include "sweep_cluster.cuh"

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
template <bool kTime, bool kShared>
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
      transpose_rows(a.w, s, sl, gs, rank, B, row0, nrows, sw.t, sw.dt,
                     us + j * BF + off, nullptr, a.scratch, seed, clk);
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

template <bool kTime, bool kShared>
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
    sweep_range(a, s, gs, sw, n, a.knot_ts, a.knot_us, clk);
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
      const TDMLPSweep wr{a.w.w1, a.w.b1, a.w.w2, a.w.b2, F, H};
      const int got = replay(wr, rs, bufs, a.ckpt_ts, a.ckpt_us, a.ckpt_ks,
                             a.ckpt_dts, a.ckpt_qolds, w, n_steps,
                             a.max_steps, a.t_end, a.atol, a.rtol, a.inv_n,
                             a.slots, a.barrier, epoch, ctl, lts,
                             a.local_us);
      // every replayed row is in local_us
      ++epoch;
      grid_barrier(a.barrier, epoch * gridDim.x);
      load_weight_slices(a.w, s, sl);
      __syncthreads();
      // sweep what the replay accepted: an accept flip must not sweep slots
      // it never wrote
      sweep_range(a, s, gs, sw, min(got, n_steps), lts, a.local_us, clk);
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
template <bool kTime, bool kShared>
static cudaError_t launch_sweep(const SweepArgs* a, int B, int F, int H,
                                cudaStream_t stream, int* clusters) {
  const size_t smem = sweep_smem_floats(F, H) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err =
      allow_smem(adjoint_sweep_kernel<kTime, kShared>, smem, &granted);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  err = sweep_config(adjoint_sweep_kernel<kTime, kShared>, B, smem, stream,
                     &attr, &cfg, clusters);
  if (err != cudaSuccess || a == nullptr) return err;
  err = cudaLaunchKernelEx(&cfg, adjoint_sweep_kernel<kTime, kShared>, *a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The reverse sweep of the stored adjoint over *naccept recorded steps
// (dense), or, with two_level and *naccept > dense_cap, over windows
// replayed from the checkpoints. Writes a_u, a_k and the flat weight
// gradient d_w; part holds one partial per cluster (at most ceil(B /
// kSweepRows)). Returns cudaGetLastError().
template <bool kTime>
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
  const cudaError_t err =
      sweep_grads_shared(F, H)
          ? launch_sweep<kTime, true>(&a, B, F, H, s, &clusters)
          : launch_sweep<kTime, false>(&a, B, F, H, s, &clusters);
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
