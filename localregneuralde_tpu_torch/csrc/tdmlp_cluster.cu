// Kernels 1 and 2: one TD-MLP dynamics evaluation y = f(x, s) over the batch,
// and one whole Tsit5 step of it, on kernel 4's thread-block clusters.
//
// Replace localregneuralde_tpu/ops/pallas/fused_mlp.py::_tdmlp_kernel
// (kernel 1, called from _fused_tdmlp_impl) and ::_step_kernel (kernel 2,
// from _fused_step_impl). On the TPU each grid step held a batch tile and
// the whole weights in VMEM. Kernel 1 serves k1 at t0 and the initial-step
// probe of every persistent solve, the regulariser's k1 and probe, and the
// eager loop's dynamics; kernel 2 the regulariser's step (the forward of
// kernel 3) and the eager loop's attempts, the whole route of a TD-MLP too
// wide for the persistent solve's sweep.
//
// Both run on the layout of solve_cluster.cuh: a cluster of 8 CTAs of 512
// threads owns a block of R rows, CTA c the features k ≡ c (mod 8) with its
// weight slices loaded into shared memory once per launch (from global
// memory in the same order where they do not fit: kShared false). Kernel 1
// is one solve_eval of each block; kernel 2 runs the six stages of kernel
// 4's attempt (solve_stages) with g6 kept as the stage-6 input, then ũ in
// the first port's expression (acc = BT1·k1, acc = acc + BTj·kj left to
// right, then dt·acc). So both keep every bit of the first port (one CTA of
// 1,024 threads an 8-row block, weights streamed from L2; chip_smoke.py's
// "K1" and "K2" digests), and kernel 2's u_new and stage derivatives are
// those of kernel 4's attempt from the same state.
//
// Neither has an error norm, so a row block need not hold whole 8-row
// error blocks and no grid barrier ties the clusters together: R is the
// fewest rows (at most the plan's, eval_plan) that fill the clusters the
// card keeps resident in one wave (B = 512: 15 clusters of 35 rows on an
// H100), and never more clusters are launched than are resident; a larger
// batch loops its clusters over the blocks.
//
// Layout in and out. The inputs and outputs are row-major (B, F); a CTA's
// features are every 8th of a row, a 32-byte sector each, so a CTA that
// moved only its own would move 8 sectors for one. Instead every transpose
// goes by items (solve_cluster.cuh::seg_item), which any CTA of the cluster
// moves for any owner, sector for sector: kernel 1 pushes x into its
// owners' stage-input tiles through DSMEM, and W2's columns into their
// weight slices (load_eval_weights), writes its outputs into the
// stage-input tile, and after a cluster barrier the CTAs read them out as
// items through DSMEM (5 µs less on an NVIDIA H100 80GB HBM3, 700 W, than
// storing them from the second product's epilogue, a sector a feature).
// Kernel 2 moves u and k1 into the segment
// layout of its global scratch (which the 50 MB L2 holds), keeps u_new,
// g6 and k1..k7 there as kernel 4 does, and after a cluster barrier moves
// the nine outputs (u_new, ũ, k2..k7, g6) out of it as items.
//
// The TF32 instantiations (kTf32: lrnde_tdmlp_tf32, lrnde_tsit5_step_tf32;
// the reference's 'default' precision) round the weight slices to TF32 as
// they load them and run solve_cluster.cuh's TF32 products; the layout, the
// transposes and the elementwise work are the FP32 kernels'.
//
// What bounds them on an H100: the products are FP32 FFMA on register tiles
// fed from shared memory (~2 FFMA a wavefront, solve_cluster.cuh), and each
// evaluation has one cluster reduction with two cluster barriers, so an
// evaluation takes some 15-20 µs where the card's FP32 peak would need 2.4;
// kernel 1 adds the weight slices' load (~83 KB a CTA from L2) to every
// launch. The clocked instantiation of kernel 2 (kTime) splits CTA 0's step
// by phase for chip_smoke.py's [tdmlp attribution]; its arithmetic is the
// same.
#include "solve_cluster.cuh"

namespace lrnde {

template <bool kShared, bool kTf32>
__global__ void __launch_bounds__(kSolveThreads, 1)
tdmlp_cluster_kernel(TDMLP w, const float* x, const float* s_ptr, float* out,
                     int B, int R) {
  const int F = w.F, H = w.H;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const SolveSmem s = carve_solve_smem(F, H, R, kShared);
  const SolveSlice sl{rank, (solve_count(F, rank) + 1) / 2,
                      solve_count(F, rank) / 2, s.odd0};
  const int n_rb = (B + R - 1) / R, n_span = seg_spans(F);
  const unsigned xa = smem_addr(sweep_smem + s.xa);
  const float st = *s_ptr;
  SolveClock<false> clk{nullptr};
  load_eval_weights<kShared, kTf32>(w, s, sl, rank);
  for (int rb = blockIdx.x / kSweepCluster; rb < n_rb;
       rb += gridDim.x / kSweepCluster) {
    const int row0 = rb * R, nrows = min(R, B - row0);
    const float* const xr = x + static_cast<size_t>(row0) * F;
    float* const o = out + static_cast<size_t>(row0) * F;
    // the block's x into its owners' stage-input tiles
    for (int j = seg_item0(rank); j < nrows * n_span * 16; j += kItemStride) {
      const SegItem it = seg_item(j, n_span, s.odd0);
      if (it.f0 < F)
        st_cluster4(xa + 4u * (it.r * s.ldX + it.pos), it.c,
                    load_item(xr + static_cast<size_t>(it.r) * F, it, F));
    }
    cg::this_cluster().sync();
    // the outputs into the stage-input tile, then out of the owners' tiles
    solve_eval<kShared, kTf32>(w, s, sl, rank, nrows, st, sweep_smem + s.xa,
                               s.ldX, clk, 0);
    cg::this_cluster().sync();
    for (int j = seg_item0(rank); j < nrows * n_span * 16; j += kItemStride) {
      const SegItem it = seg_item(j, n_span, s.odd0);
      if (it.f0 < F)
        store_item(o + static_cast<size_t>(it.r) * F, it, F,
                   ld_cluster4(xa + 4u * (it.r * s.ldX + it.pos), it.c));
    }
    // no CTA rewrites its tile (or exits) while another reads it
    cg::this_cluster().sync();
  }
}

struct StepArgs {
  const float* u;
  const float* k1;
  const float* sc;    // t, dt
  TDMLP w;
  float* out[9];      // u_new, ũ, k2..k7, g6: (B, F) row-major
  float* scratch;     // step_scratch_floats(B, F)
  int B, R;
  unsigned long long* timing;  // kTime: kStPhases + 1
};

// Global scratch of kernel 2: u, u_new, g6 and k1..k7 in the segment
// layout, B rows of 8 segments each.
__host__ __device__ inline size_t step_scratch_floats(int B, int F) {
  return 10 * static_cast<size_t>(B) * kSweepCluster * solve_seg(F);
}

template <bool kShared, bool kTime, bool kTf32>
__global__ void __launch_bounds__(kSolveThreads, 1)
step_cluster_kernel(StepArgs a) {
  const TDMLP& w = a.w;
  const int F = w.F, H = w.H, B = a.B, R = a.R;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const SolveSmem s = carve_solve_smem(F, H, R, kShared);
  const SolveSlice sl{rank, (solve_count(F, rank) + 1) / 2,
                      solve_count(F, rank) / 2, s.odd0};
  const size_t rs = static_cast<size_t>(kSweepCluster) * s.seg;  // row stride
  const size_t BS = static_cast<size_t>(B) * rs;
  const int n_rb = (B + R - 1) / R, n_span = seg_spans(F);
  __shared__ unsigned long long clk_acc[kTime ? kStPhases : 1];
  SolveClock<kTime, kStPhases> clk{clk_acc};
  // the buffers in the segment layout: u, u_new, g6, k1..k7 (segment 0;
  // this CTA's at rank · seg)
  float* const u = a.scratch;
  float* const unew = u + BS;
  float* const g6 = u + 2 * BS;
  float* const k1 = u + 3 * BS;
  const float t = a.sc[0], dt = a.sc[1];
  clk.start();
  load_eval_weights<kShared, kTf32>(w, s, sl, rank);
  clk.mark(kStWeights);
  for (int rb = blockIdx.x / kSweepCluster; rb < n_rb;
       rb += gridDim.x / kSweepCluster) {
    const int row0 = rb * R, nrows = min(R, B - row0);
    const size_t off = row0 * rs, own = off + rank * s.seg;
    // u and k1 into the segments, each CTA a share of the block's items
    for (int j = seg_item0(rank); j < nrows * n_span * 16; j += kItemStride) {
      const SegItem it = seg_item(j, n_span, s.odd0);
      if (it.f0 >= F) continue;
      const size_t e = static_cast<size_t>(row0 + it.r) * F;
      const size_t o = off + it.r * rs + it.c * s.seg + it.pos;
      *reinterpret_cast<float4*>(u + o) = load_item(a.u + e, it, F);
      *reinterpret_cast<float4*>(k1 + o) = load_item(a.k1 + e, it, F);
    }
    cg::this_cluster().sync();
    clk.mark(kStLayoutIn);
    float* kr[7];
    for (int j = 0; j < 7; ++j) kr[j] = k1 + j * BS + own;
    solve_stages<kShared, kTf32>(w, s, sl, rank, nrows, t, dt, kr, u + own,
                                 g6 + own, unew + own, rs, clk);
    cg::this_cluster().sync();
    // ũ, and the nine outputs row-major, each CTA a share of the items
    for (int j = seg_item0(rank); j < nrows * n_span * 16; j += kItemStride) {
      const SegItem it = seg_item(j, n_span, s.odd0);
      if (it.f0 >= F) continue;
      const size_t o = off + it.r * rs + it.c * s.seg + it.pos;
      float4 kv[7];
#pragma unroll
      for (int q = 0; q < 7; ++q)
        kv[q] = *reinterpret_cast<const float4*>(k1 + q * BS + o);
      float ut[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float acc = BT1 * comp(kv[0], c);
        acc = acc + BT2 * comp(kv[1], c);
        acc = acc + BT3 * comp(kv[2], c);
        acc = acc + BT4 * comp(kv[3], c);
        acc = acc + BT5 * comp(kv[4], c);
        acc = acc + BT6 * comp(kv[5], c);
        acc = acc + BT7 * comp(kv[6], c);
        ut[c] = dt * acc;
      }
      const size_t e = static_cast<size_t>(row0 + it.r) * F;
      store_item(a.out[0] + e, it, F,
                 *reinterpret_cast<const float4*>(unew + o));
      store_item(a.out[1] + e, it, F, make_float4(ut[0], ut[1], ut[2], ut[3]));
#pragma unroll
      for (int q = 1; q < 7; ++q) store_item(a.out[1 + q] + e, it, F, kv[q]);
      store_item(a.out[8] + e, it, F, *reinterpret_cast<const float4*>(g6 + o));
    }
    clk.mark(kStLayoutOut);
  }
  clk.write(a.timing, 1);
}

// The launch of a kernel without an error norm at (B, F, H): the plan's
// shared memory, and R rows a cluster: `rows` (at most the plan's) when
// positive, else the fewest that fill the resident clusters in one wave.
// *R and *clusters return the grid.
template <typename Kernel>
static cudaError_t eval_config(Kernel kernel, int B, int F, int H, int rows,
                               bool shared, cudaStream_t stream,
                               cudaLaunchAttribute* attr,
                               cudaLaunchConfig_t* cfg, int* R,
                               int* clusters) {
  int rmax = 0;
  bool fits = false;
  if (!eval_plan(F, H, &rmax, &fits) || (shared && !fits))
    return cudaErrorInvalidValue;
  const size_t smem = eval_smem_floats(F, H, rmax, shared) * sizeof(float);
  // one row a cluster: min(B, resident) clusters
  cudaError_t err =
      cluster_config(kernel, B, 1, smem, stream, attr, cfg, clusters);
  if (err != cudaSuccess) return err;
  *R = rows > 0 ? min(rows, rmax) : min(rmax, (B + *clusters - 1) / *clusters);
  return cluster_config(kernel, B, *R, smem, stream, attr, cfg, clusters);
}

template <bool kTf32 = false>
static cudaError_t tdmlp_launch(const TDMLP& w, const float* x,
                                const float* s, float* out, int B, int rows,
                                cudaStream_t stream, int* R, int* clusters) {
  int rmax = 0;
  bool shared = false;
  if (!eval_plan(w.F, w.H, &rmax, &shared)) return cudaErrorInvalidValue;
  auto kernel = shared ? tdmlp_cluster_kernel<true, kTf32>
                       : tdmlp_cluster_kernel<false, kTf32>;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = eval_config(kernel, B, w.F, w.H, rows, shared, stream,
                                &attr, &cfg, R, clusters);
  if (err != cudaSuccess || x == nullptr) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, w, x, s, out, B, *R);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kTf32 = false>
static cudaError_t step_launch(StepArgs a, int rows, cudaStream_t stream,
                               int* R, int* clusters) {
  int rmax = 0;
  bool shared = false;
  if (!eval_plan(a.w.F, a.w.H, &rmax, &shared)) return cudaErrorInvalidValue;
  // the TF32 tier has no clocked instantiation
  const bool timed = a.timing != nullptr;
  if (kTf32 && timed) return cudaErrorInvalidValue;
  auto kernel =
      kTf32 ? (shared ? step_cluster_kernel<true, false, true>
                      : step_cluster_kernel<false, false, true>)
            : shared ? (timed ? step_cluster_kernel<true, true, false>
                              : step_cluster_kernel<true, false, false>)
                     : (timed ? step_cluster_kernel<false, true, false>
                              : step_cluster_kernel<false, false, false>);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = eval_config(kernel, a.B, a.w.F, a.w.H, rows, shared,
                                stream, &attr, &cfg, R, clusters);
  if (err != cudaSuccess || a.u == nullptr) return err;
  a.R = *R;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace lrnde

// out = f(x, *s) for x (B, F); s is a device scalar. rows: the rows of a
// cluster (0: the fewest that fill the resident clusters; else at most the
// plan's, for the grid probe). Fails with cudaErrorInvalidValue where not
// even one row fits a CTA (lrnde_eval_rows = 0). Returns
// cudaGetLastError().
extern "C" int lrnde_tdmlp(const float* x, const float* s, const float* w1,
                           const float* b1, const float* w2, const float* b2,
                           float* out, int B, int F, int H, int rows,
                           void* stream) {
  int R = 0, clusters = 0;
  return lrnde::tdmlp_launch(lrnde::TDMLP{w1, b1, w2, b2, F, H}, x, s, out,
                             B, rows, static_cast<cudaStream_t>(stream), &R,
                             &clusters);
}

// One Tsit5 step from (u, t) with step dt and FSAL derivative k1; sc holds
// (t, dt) on the device; scratch lrnde_step_scratch_floats(B, F) floats.
// rows as for lrnde_tdmlp. With timing (lrnde_step_phases() + 1 unsigned
// 64-bit integers) the clocked instantiation fills it with CTA 0's
// nanoseconds in each StepPhase, then 1; null, the untimed one. Returns
// cudaGetLastError().
extern "C" int lrnde_tsit5_step(const float* u, const float* k1,
                                const float* sc, const float* w1,
                                const float* b1, const float* w2,
                                const float* b2, float* unew, float* utilde,
                                float* k2, float* k3, float* k4, float* k5,
                                float* k6, float* k7, float* g6,
                                float* scratch, int B, int F, int H, int rows,
                                unsigned long long* timing, void* stream) {
  using namespace lrnde;
  const StepArgs a{u, k1, sc, TDMLP{w1, b1, w2, b2, F, H},
                   {unew, utilde, k2, k3, k4, k5, k6, k7, g6}, scratch, B, 0,
                   timing};
  int R = 0, clusters = 0;
  return step_launch(a, rows, static_cast<cudaStream_t>(stream), &R,
                     &clusters);
}

// lrnde_tdmlp and lrnde_tsit5_step (without timing) at the TF32 tier.
extern "C" int lrnde_tdmlp_tf32(const float* x, const float* s,
                                const float* w1, const float* b1,
                                const float* w2, const float* b2, float* out,
                                int B, int F, int H, int rows, void* stream) {
  int R = 0, clusters = 0;
  return lrnde::tdmlp_launch<true>(lrnde::TDMLP{w1, b1, w2, b2, F, H}, x, s,
                                   out, B, rows,
                                   static_cast<cudaStream_t>(stream), &R,
                                   &clusters);
}

extern "C" int lrnde_tsit5_step_tf32(const float* u, const float* k1,
                                     const float* sc, const float* w1,
                                     const float* b1, const float* w2,
                                     const float* b2, float* unew,
                                     float* utilde, float* k2, float* k3,
                                     float* k4, float* k5, float* k6,
                                     float* k7, float* g6, float* scratch,
                                     int B, int F, int H, int rows,
                                     void* stream) {
  using namespace lrnde;
  const StepArgs a{u, k1, sc, TDMLP{w1, b1, w2, b2, F, H},
                   {unew, utilde, k2, k3, k4, k5, k6, k7, g6}, scratch, B, 0,
                   nullptr};
  int R = 0, clusters = 0;
  return step_launch<true>(a, rows, static_cast<cudaStream_t>(stream), &R,
                           &clusters);
}

// The plan at (F, H), for the wrappers' (fused_solve.py::eval_plan) to
// check against: the most rows of a cluster (0: no width fits), whether the
// weight slices stay in shared memory, the floats of dynamic shared memory
// (at the most rows) and of kernel 2's global scratch.
extern "C" int lrnde_eval_rows(int F, int H) {
  int R = 0;
  bool shared = false;
  return lrnde::eval_plan(F, H, &R, &shared) ? R : 0;
}
extern "C" int lrnde_eval_weights_shared(int F, int H) {
  int R = 0;
  bool shared = false;
  return lrnde::eval_plan(F, H, &R, &shared) && shared ? 1 : 0;
}
extern "C" long long lrnde_eval_smem_floats(int F, int H) {
  int R = 0;
  bool shared = false;
  if (!lrnde::eval_plan(F, H, &R, &shared)) return 0;
  return static_cast<long long>(lrnde::eval_smem_floats(F, H, R, shared));
}
extern "C" long long lrnde_step_scratch_floats(int B, int F) {
  return static_cast<long long>(lrnde::step_scratch_floats(B, F));
}

// The grid a launch at (B, F, H) with `rows` takes on this card: grid[0]
// the rows of a cluster, grid[1] the clusters; kernel 1 (step 0) or kernel
// 2 (step 1). Returns 0 or a CUDA error.
extern "C" int lrnde_eval_grid(int B, int F, int H, int rows, int step,
                               int* grid) {
  using namespace lrnde;
  cudaError_t err;
  if (step) {
    const StepArgs a{nullptr, nullptr, nullptr, TDMLP{nullptr, nullptr,
                     nullptr, nullptr, F, H}, {}, nullptr, B, 0, nullptr};
    err = step_launch(a, rows, nullptr, &grid[0], &grid[1]);
  } else {
    err = tdmlp_launch(TDMLP{nullptr, nullptr, nullptr, nullptr, F, H},
                       nullptr, nullptr, nullptr, B, rows, nullptr, &grid[0],
                       &grid[1]);
  }
  return static_cast<int>(err);
}

// The number of attribution phases of kernel 2's clocked instantiation.
extern "C" int lrnde_step_phases() { return lrnde::kStPhases; }
