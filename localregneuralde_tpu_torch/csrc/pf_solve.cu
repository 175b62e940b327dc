// Kernel 6: the whole adaptive Tsit5 solve of the probability-flow ODE of
// the score samplers, du/dτ = ½β(t)·(u + s_θ(u, t)) with t = t1 − τ, in one
// cooperative launch: the solve of persistent.cuh instantiated for
// score.cuh::PfScore, with no knots and no reservoir (sampling is never
// differentiated).
//
// Replaces localregneuralde_tpu/ops/pallas/fused_solve.py::
// persistent_pf_solve (_make_kernel built for the ("pfode", pads, acts,
// beta_min, beta_max, t1) family, family_make_f). The TPU kernel ran
// whole-batch tiles with the lane-padded weights in VMEM; here every CTA
// keeps the unpadded score network in shared memory and owns kScoreRows
// rows, so an attempt is 6·L dependent layer passes per CTA and one grid
// barrier. As in the reference, k1 and the Hairer initial step are computed
// outside the kernel.
//
// What bounds it on an H100: serial latency. At the demo's widths (B = 4096,
// F = 2, 2 -> 64 -> 64 -> 2) an attempt is 0.22 GFLOP (3.3 µs at the FP32
// peak) over 18 dependent layer passes and a grid-wide reduction of 512
// row-block partials.
#include "score.cuh"
#include "persistent.cuh"

// Floats of dynamic shared memory of one kernel-6 CTA (0: outside limits).
extern "C" long long lrnde_pf_solve_smem_floats(const int* dims, int L) {
  using namespace lrnde;
  PfScore c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_score(&c, none, dims, L, 0u, 0.f, 0.f, 0.f)) return 0;
  return static_cast<long long>(shared_floats(c));
}

// The whole adaptive solve from (u0, k1_0) with sc = (t0, t_end, dt0) on the
// device, the contract of lrnde_persistent_tsit5 without recording: the
// score network given by wb (2L pointers: W_0, b_0, W_1, ...; W_l the
// (d_l + 1, d_{l+1}) TD matrix), dims (L + 1) and acts (bit l: tanh after
// layer l), β(t) = beta_min + t·d_beta at t = t1 − τ. slots holds
// 2·ceil(B / kScoreRows) floats. Returns cudaGetLastError().
extern "C" int lrnde_persistent_pf(
    const float* u0, const float* k10, const float* sc, const float* saveat,
    int n_save, const void* const* wb, const int* dims, int L,
    unsigned int acts, float beta_min, float d_beta, float t1, float* u,
    float* ys, int* stats_i, float* stats_f, float* scratch, float* slots,
    unsigned int* barrier, int B, int max_steps, float rtol, float atol,
    float inv_n, void* stream) {
  using namespace lrnde;
  PfScore c;
  if (!make_score(&c, wb, dims, L, acts, beta_min, d_beta, t1))
    return cudaErrorInvalidValue;
  SolveArgs<PfScore> a{u0, k10, sc, saveat, n_save, c, u, ys, stats_i,
                       stats_f, scratch, slots, barrier, B, max_steps, rtol,
                       atol, inv_n};
  const size_t smem = shared_floats(c) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(persistent_solve_kernel<PfScore>, smem, &granted);
  if (err != cudaSuccess) return err;
  return launch_cooperative<PfScore>(persistent_solve_kernel<PfScore>, &a, B,
                                     smem, static_cast<cudaStream_t>(stream),
                                     nullptr);
}
