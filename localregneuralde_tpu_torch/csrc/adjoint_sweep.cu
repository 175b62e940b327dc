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

// Global scratch of the sweep: k1..k7 and their cotangents (7 (B, F)
// each), d_u and the six stage inputs ((B, F) each), and the six stages'
// hidden rows (6 (B, H)). The window replay's working buffers (u, k1..k7,
// u_new) lie over the first nine (B, F).
__host__ __device__ inline size_t sweep_scratch_floats(int B, int F, int H) {
  return 21 * static_cast<size_t>(B) * F + 6 * static_cast<size_t>(B) * H;
}

// The attribution phases of one transposed step, timed by CTA 0's thread 0
// on %globaltimer in the instantiation with kTime (chip_smoke.py's
// [sweep attribution] only): the k1 recompute, the six stage recomputes,
// the seeding of the stage cotangents, each reverse stage's dh, dz and dx
// (stage 6 first), the two weight-gradient updates and the carries.
enum SweepPhase {
  kSwK1, kSwStage1, kSwSeed = kSwStage1 + 6, kSwRev,
  kSwDW1 = kSwRev + 18, kSwDW2, kSwCarry, kSwPhases
};

template <bool kOn>
struct SweepClock {
  unsigned long long last = 0, acc[kSwPhases] = {};
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ bool owner() const { return blockIdx.x == 0 && threadIdx.x == 0; }
  __device__ void start() {
    if constexpr (kOn) if (owner()) last = now();
  }
  // the timed instantiation waits for the whole CTA first; the untimed one
  // does nothing
  __device__ void mark(int phase) {
    if constexpr (kOn) {
      __syncthreads();
      if (owner()) {
        const unsigned long long t = now();
        acc[phase] += t - last;
        last = t;
      }
    }
  }
  __device__ void stage(int i) { mark(kSwStage1 + i); }
  __device__ void rev(int i, int part) { mark(kSwRev + 3 * (5 - i) + part); }
  __device__ void grad(int which) { mark(kSwDW1 + which); }
  // per-phase nanoseconds, then the number of steps transposed
  __device__ void write(unsigned long long* out, int steps) const {
    if constexpr (kOn) {
      if (owner()) {
        for (int i = 0; i < kSwPhases; ++i) out[i] = acc[i];
        out[kSwPhases] = static_cast<unsigned long long>(steps);
      }
    }
  }
};

struct StepWeights {
  float wt[kMaxSave][7];  // dt·b_m(θ_s)·hit_s
  float hit[kMaxSave];
  float t, dt;
};

// The time of stage i + 2 (i = 0..5) of a step from t with step dt.
__device__ inline float stage_time(int i, float t, float dt) {
  const float c = i == 0 ? C1 : i == 1 ? C2 : i == 2 ? C3 : C4;
  return i < 4 ? fmaf(c, dt, t) : __fadd_rn(t, dt);
}

// Passes over this CTA's slice of a row block (nrows × Sn elements, at
// rows of stride F in global memory): loads first, then stores, through
// __restrict__ pointers and unrolled, so each thread has several global
// loads in flight. Products and sums are written out (fmaf, __fmul_rn,
// __fadd_rn): the compiler contracts nothing, so the timed instantiation
// computes the same bits.

// tile[r][f] = src[r·F + f]
__device__ inline void load_tile(const float* __restrict__ src, int tile,
                                 int ld, int nrows, int Sn, int F) {
  const int nel = nrows * Sn;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < nel; idx += kSweepThreads) {
    const int r = idx / Sn, f = idx - r * Sn;
    sweep_smem[tile + r * ld + f] = src[static_cast<size_t>(r) * F + f];
  }
}

// The input of stage i + 2: x = u + dt·Σ_{q ≤ i} a_iq·k_q, into the tile
// xa and into xs.
__device__ inline void stage_input_pass(int i, float dt,
                                        const float* __restrict__ u,
                                        const float* __restrict__ ks,
                                        size_t BF, float* __restrict__ xs,
                                        int xa, int ld, int nrows, int Sn,
                                        int F) {
  const int nel = nrows * Sn;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < nel; idx += kSweepThreads) {
    const int r = idx / Sn, f = idx - r * Sn;
    const size_t o = static_cast<size_t>(r) * F + f;
    float kv[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) kv[q] = q <= i ? ks[q * BF + o] : 0.f;
    const float uv = u[o];
    float acc = __fmul_rn(kA[i][0], kv[0]);
#pragma unroll
    for (int q = 1; q < 6; ++q)
      if (q <= i) acc = fmaf(kA[i][q], kv[q], acc);
    const float v = fmaf(dt, acc, uv);
    sweep_smem[xa + r * ld + f] = v;
    xs[o] = v;
  }
}

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

// The cotangent on k7 (the last stage's output), into the tile ka: its
// saveat seed plus the FSAL carry a_k.
__device__ inline void seed_k7_pass(const StepWeights& sw, int n_save,
                                    const float* __restrict__ ct_ys,
                                    const float* __restrict__ a_k, size_t BF,
                                    int ka, int ld, int nrows, int Sn, int F) {
  const int nel = nrows * Sn;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < nel; idx += kSweepThreads) {
    const int r = idx / Sn, f = idx - r * Sn;
    const size_t o = static_cast<size_t>(r) * F + f;
    float ct[kMaxSave];
    load_cts(ct_ys, o, BF, n_save, ct);
    const float ak = a_k[o];
    sweep_smem[ka + r * ld + f] = __fadd_rn(seed_of(sw, n_save, ct, 6), ak);
  }
}

// The cotangent dx of stage input i (in the tile xa) flows to u (du; at
// stage i = 5, which is u_new, with the carried a_u) and to the k_q it was
// built from. At i = 5 the cotangents on k1..k6 start from their saveat
// seeds, computed here rather than stored and read back.
__device__ inline void dx_pass(int i, float dt, int xa, int ld,
                               const StepWeights& sw, int n_save,
                               const float* __restrict__ ct_ys,
                               const float* __restrict__ a_u,
                               float* __restrict__ du,
                               float* __restrict__ dks, size_t BF, int nrows,
                               int Sn, int F) {
  const int nel = nrows * Sn;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < nel; idx += kSweepThreads) {
    const int r = idx / Sn, f = idx - r * Sn;
    const size_t o = static_cast<size_t>(r) * F + f;
    float dk[6];
    if (i == 5) {
      float ct[kMaxSave];
      load_cts(ct_ys, o, BF, n_save, ct);
#pragma unroll
      for (int q = 0; q < 6; ++q) dk[q] = seed_of(sw, n_save, ct, q);
    } else {
#pragma unroll
      for (int q = 0; q < 6; ++q) dk[q] = q <= i ? dks[q * BF + o] : 0.f;
    }
    const float prev = i == 5 ? a_u[o] : du[o];
    float dx = sweep_smem[xa + r * ld + f];
    float dup;
    if (i == 5) {
      dx = __fadd_rn(dx, prev);
      dup = dx;
    } else {
      dup = __fadd_rn(prev, dx);
    }
    du[o] = dup;
#pragma unroll
    for (int q = 0; q < 6; ++q)
      if (q <= i) dks[q * BF + o] = fmaf(__fmul_rn(dt, kA[i][q]), dx, dk[q]);
  }
}

// a_u <- d_u + Σ_hit ct_ys ; a_k <- d_k1
__device__ inline void carry_pass(const StepWeights& sw, int n_save,
                                  const float* __restrict__ ct_ys,
                                  const float* __restrict__ du,
                                  const float* __restrict__ dk1, size_t BF,
                                  float* __restrict__ a_u,
                                  float* __restrict__ a_k, int nrows, int Sn,
                                  int F) {
  const int nel = nrows * Sn;
#pragma unroll 2
  for (int idx = threadIdx.x; idx < nel; idx += kSweepThreads) {
    const int r = idx / Sn, f = idx - r * Sn;
    const size_t o = static_cast<size_t>(r) * F + f;
    float ct[kMaxSave];
    load_cts(ct_ys, o, BF, n_save, ct);
    const float duv = du[o], dk1v = dk1[o];
    float dint = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSave; ++q)
      if (q < n_save) dint = fmaf(ct[q], sw.hit[q], dint);
    a_u[o] = __fadd_rn(duv, dint);
    a_k[o] = dk1v;
  }
}

// Transpose accepted steps n_hi-1 .. 0 whose start times are ts[j] and start
// states us + j·BF, for this cluster's row blocks and this CTA's slice,
// adding the weight gradient into gs.
template <bool kTime, bool kShared>
__device__ void sweep_range(const SweepArgs& a, const SweepSmem& s,
                            const GradSink<kShared>& gs, StepWeights& sw,
                            int n_hi, const float* ts, const float* us,
                            SweepClock<kTime>& clk) {
  const int F = a.w.F, H = a.w.H, B = a.B, tid = threadIdx.x;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const SweepSlice sl = sweep_slice(F, rank);
  const int n_rb = (B + kSweepRows - 1) / kSweepRows;
  const int cid = blockIdx.x / kSweepCluster;
  const int ncl = gridDim.x / kSweepCluster;
  const int ldS = s.ldS, ldW = s.ldW, Sn = sl.n;
  const int xa = s.xa, ka = s.ka, zp = s.zp, hb = s.hb;
  const Inbox in = sweep_inbox(s, H, rank);
  float* const sm = sweep_smem;
  const size_t BF = static_cast<size_t>(B) * F;
  const size_t BH = static_cast<size_t>(B) * H;
  float* const ks = a.scratch;             // k1..k7: 7 (B, F)
  float* const dks = a.scratch + 7 * BF;   // cotangents on k1..k7
  float* const du = a.scratch + 14 * BF;   // (B, F)
  float* const xs = a.scratch + 15 * BF;   // stage inputs: 6 (B, F)
  float* const hs = a.scratch + 21 * BF;   // hidden rows: 6 (B, H)
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
    const float t = sw.t, dt = sw.dt;
    for (int rb = cid; rb < n_rb; rb += ncl) {
      const int row0 = rb * kSweepRows;
      const int nrows = min(kSweepRows, B - row0);
      // this CTA's corner (row0, f0) of a (B, F) array
      const size_t off = static_cast<size_t>(row0) * F + sl.f0;
      const float* const u = us + j * BF + off;
      // k1 of the step, recomputed from its knot
      load_tile(u, xa, ldS, nrows, Sn, F);
      __syncthreads();
      cluster_eval(s, in, sl, H, F, nrows, t, nullptr, ks + off);
      clk.mark(kSwK1);
      // the six stages, keeping x_i (global) and h_i (global, per cluster)
      for (int i = 0; i < 6; ++i) {
        stage_input_pass(i, dt, u, ks + off, BF, xs + i * BF + off, xa, ldS,
                         nrows, Sn, F);
        __syncthreads();
        cluster_eval(s, in, sl, H, F, nrows, stage_time(i, t, dt),
                     hs + i * BH + static_cast<size_t>(row0) * H,
                     ks + (i + 1) * BF + off);
        clk.stage(i);
      }
      // (the saveat seeds of the stage cotangents enter at stage 6 below)
      clk.mark(kSwSeed);
      // ---- reverse pass through the stage chain
      for (int i = 5; i >= 0; --i) {
        const float st = stage_time(i, t, dt);
        // dh = dk·W2ᵀ: this slice's partial, pushed to the summing CTAs
        if (i == 5) {
          seed_k7_pass(sw, n_save, a.ct_ys + off, a.a_k + off, BF, ka, ldS,
                       nrows, Sn, F);
        } else {
          load_tile(dks + (i + 1) * BF + off, ka, ldS, nrows, Sn, F);
        }
        __syncthreads();
        tile_gemm<3, false, false>(
            nrows, H, Sn, ka, ldS, s.w2, ldS,
            [=](int m, int n, float v) { push_partial(in, m * H + n, v); });
        clk.rev(i, 0);
        // dz = dh·(1 − h²), from the h_i this CTA reduced in the recompute
        const float* const hsi = hs + i * BH + static_cast<size_t>(row0) * H;
        cluster_reduce(in, hb, H, ldW, nrows * H, hsi,
                       [=](int e, float d, float hv) {
                         return __fmul_rn(d, fmaf(-hv, hv, 1.f));
                       });
        clk.rev(i, 1);
        // dx = dz·W1ᵀ on the slice, into xa; then its flow to u and k
        tile_gemm<3, false, false>(
            nrows, Sn, H, hb, ldW, s.w1, ldW,
            [=](int m, int n, float v) { sm[xa + m * ldS + n] = v; });
        __syncthreads();
        dx_pass(i, dt, xa, ldS, sw, n_save, a.ct_ys + off, a.a_u + off,
                du + off, dks + off, BF, nrows, Sn, F);
        __syncthreads();
        // x_i of the slice for dW1, and h_i of the cluster's rows for dW2
        // in the inbox (free until the cluster barrier that ends the stage)
        load_tile(xs + i * BF + off, xa, ldS, nrows, Sn, F);
        load_tile(hsi, zp, ldW, nrows, H, H);
        __syncthreads();
        clk.rev(i, 2);
        // dW1[S_c, :] += x_iᵀ·dz_i; rank 0: db1 and dw1t
        tile_gemm<4, true, true>(
            Sn, H, nrows, xa, ldS, hb, ldW,
            [=](int m, int n, float v) { gs.w1(m, n, v); });
        if (rank == 0) {
          for (int h = tid; h < H; h += kSweepThreads) {
            float sum = 0.f;
            for (int r = 0; r < nrows; ++r) sum += sm[hb + r * ldW + h];
            gs.b1(h, sum, st);
          }
        }
        clk.grad(0);
        // dW2[:, S_c] += h_iᵀ·dk_i, with its time row and db2
        tile_gemm<4, true, true>(
            H, Sn, nrows, zp, ldW, ka, ldS,
            [=](int m, int n, float v) { gs.w2(m, n, v); });
        for (int f = tid; f < Sn; f += kSweepThreads) {
          float sum = 0.f;
          for (int r = 0; r < nrows; ++r) sum += sm[ka + r * ldS + f];
          gs.b2(f, sum, st);
        }
        // no CTA pushes into this inbox before every CTA is done with h_i
        cg::this_cluster().sync();
        clk.grad(1);
      }
      carry_pass(sw, n_save, a.ct_ys + off, du + off, dks + off, BF,
                 a.a_u + off, a.a_k + off, nrows, Sn, F);
      __syncthreads();
      clk.mark(kSwCarry);
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
