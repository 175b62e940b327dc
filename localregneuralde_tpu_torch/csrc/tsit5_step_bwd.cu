// Kernel 3: the VJP of one whole Tsit5 step of the TD-MLP dynamics.
//
// Replaces localregneuralde_tpu/ops/pallas/fused_mlp_bwd.py::_bwd_kernel
// (called from fused_step_bwd). On the TPU the sequential grid carried the
// weight-gradient sums from one batch tile to the next in VMEM. Here the
// step runs on thread-block clusters, through the transposed step of the
// stored-adjoint sweep (sweep_cluster.cuh::transpose_rows, kernels 7 and
// 8): a cluster of 8 CTAs of 512 threads owns a block of kSweepRows = 36
// rows, each CTA a contiguous slice of the features with its slices of the
// weights and of their gradients in shared memory. It copies k1 in,
// recomputes the six stages and transposes them (12 cluster reductions),
// seeded with the step's nine cotangents (StepSeed): on k1 (dt·b̃1)·d_ũ, on
// k_j (dt·b̃_j)·d_ũ + d_k_j for j = 2..7, on the stage inputs u_new and g6
// their own. Each cluster writes one gradient partial; a second kernel sums
// them in cluster order, so the gradients are bitwise repeatable.
// Cotangents for t and dt are not produced: the controller fence makes
// them zero.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W): what bounds the sweep's
// transposed step, whose cost it has: 0.394 ms at B = 512 (PERF.md §6),
// against 1.11 ms for the design it replaced (a CTA of 8 rows streaming the
// weights from L2 per stage and a 0.63 MB read-modify-write of its own
// gradient partial).
#include "sweep_cluster.cuh"

namespace lrnde {

// The seed of kernel 3's transposed step at one row block (pointers offset
// to the CTA's corner): the nine cotangents of (u_new, ũ, k2..k7, g6); it
// writes d_u and d_k1.
struct StepSeed {
  const float* d_unew;
  const float* d_ut;
  const float* d_k[6];  // on k2..k7
  const float* d_g6;
  float* d_u;
  float* d_k1;
  float dt;
  __device__ StepSeed at(size_t off) const {
    StepSeed s = *this;
    s.d_unew += off;
    s.d_ut += off;
    for (int j = 0; j < 6; ++j) s.d_k[j] += off;
    s.d_g6 += off;
    s.d_u += off;
    s.d_k1 += off;
    return s;
  }
  __device__ float k7(size_t o) const {
    return fmaf(__fmul_rn(dt, BT7), d_ut[o], d_k[5][o]);
  }
  __device__ void ks(size_t o, float (&dk)[6]) const {
    const float bt[6] = {BT1, BT2, BT3, BT4, BT5, BT6};
    const float ut = d_ut[o];
    dk[0] = __fmul_rn(__fmul_rn(dt, bt[0]), ut);
#pragma unroll
    for (int q = 1; q < 6; ++q)
      dk[q] = fmaf(__fmul_rn(dt, bt[q]), ut, d_k[q - 1][o]);
  }
  __device__ float x(int i, size_t o, float dx) const {
    return i == 5 ? __fadd_rn(dx, d_unew[o])
                  : i == 4 ? __fadd_rn(dx, d_g6[o]) : dx;
  }
  __device__ void finish(size_t o, float du, float dk1) const {
    d_u[o] = du;
    d_k1[o] = dk1;
  }
};

struct StepBwdArgs {
  const float* u;
  const float* k1;
  const float* sc;  // t, dt
  TDMLP w;
  StepSeed seed;
  float* scratch;   // sweep_scratch_floats(B, F, H)
  float* part;      // (clusters, grad_floats)
  int B;
};

template <bool kShared>
__global__ void __launch_bounds__(kSweepThreads)
tsit5_step_bwd_kernel(StepBwdArgs a) {
  const int F = a.w.F, H = a.w.H, B = a.B;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const SweepSlice sl = sweep_slice(F, rank);
  const SweepSmem s = carve_sweep_smem(F, H);
  const int cid = blockIdx.x / kSweepCluster;
  const int ncl = gridDim.x / kSweepCluster;
  const float t = a.sc[0];
  StepSeed seed = a.seed;
  seed.dt = a.sc[1];
  SweepClock<false> clk;

  float* const part = a.part + cid * grad_floats(F, H);
  const GradSink<kShared> gs(s, sl, F, H, part);
  zero_grads<kShared>(F, H, sl, rank, part);
  load_weight_slices(a.w, s, sl);
  // every CTA of the cluster runs before any writes into another's inbox
  cg::this_cluster().sync();
  const int n_rb = (B + kSweepRows - 1) / kSweepRows;
  for (int rb = cid; rb < n_rb; rb += ncl) {
    const int row0 = rb * kSweepRows;
    const size_t off = static_cast<size_t>(row0) * F + sl.f0;
    transpose_rows(a.w, s, sl, gs, rank, B, row0, min(kSweepRows, B - row0),
                   t, seed.dt, a.u + off, a.k1 + off, a.scratch, seed.at(off),
                   clk);
  }
  if constexpr (kShared) {
    __syncthreads();
    store_grad_slices(s, sl, F, H, rank, part);
  }
}

// One cluster per row block of kSweepRows rows (no grid barrier: the
// clusters need not be resident at once), one gradient partial each.
template <bool kShared>
static cudaError_t launch_step_bwd(const StepBwdArgs& a, int F, int H,
                                   cudaStream_t stream, int clusters) {
  auto kernel = tsit5_step_bwd_kernel<kShared>;
  const size_t smem = sweep_smem_floats(F, H) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kSweepCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kSweepCluster);
  cfg.blockDim = dim3(kSweepThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace lrnde

// VJP of one Tsit5 step from (u, t) with step dt and FSAL derivative k1;
// sc = (t, dt) on the device. The nine cotangents are those of (u_new, ũ,
// k2..k7, g6). Writes d_u, d_k1 and the flat weight gradient d_w
// (grad_floats(F, H)); part holds ceil(B / kSweepRows) partials, scratch
// lrnde_sweep_scratch_floats(B, F, H) floats. Returns cudaGetLastError().
extern "C" int lrnde_tsit5_step_bwd(
    const float* u, const float* k1, const float* sc, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* d_unew,
    const float* d_utilde, const float* d_k2, const float* d_k3,
    const float* d_k4, const float* d_k5, const float* d_k6,
    const float* d_k7, const float* d_g6, float* d_u, float* d_k1,
    float* d_w, float* scratch, float* part, int B, int F, int H,
    void* stream) {
  using namespace lrnde;
  const StepBwdArgs a{u, k1, sc, TDMLP{w1, b1, w2, b2, F, H},
                      StepSeed{d_unew, d_utilde,
                               {d_k2, d_k3, d_k4, d_k5, d_k6, d_k7}, d_g6,
                               d_u, d_k1, 0.f},
                      scratch, part, B};
  const int clusters = (B + kSweepRows - 1) / kSweepRows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      sweep_grads_shared(F, H)
          ? launch_step_bwd<true>(a, F, H, s, clusters)
          : launch_step_bwd<false>(a, F, H, s, clusters);
  if (err != cudaSuccess) return err;
  return reduce_partials(part, clusters, grad_floats(F, H), d_w, s);
}
