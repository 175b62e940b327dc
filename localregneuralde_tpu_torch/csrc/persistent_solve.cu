// Kernel 4: the whole adaptive Tsit5 solve of the TD-MLP dynamics in one
// cooperative launch (persistent.cuh, instantiated for tdmlp.cuh::TDMLP),
// with the knot and checkpoint recording of the stored adjoint and the
// reservoir sample of the biased regulariser.
//
// Replaces localregneuralde_tpu/ops/pallas/fused_solve.py::_make_kernel
// (family ("tdmlp",), built by _build_call and called from
// persistent_tsit5_solve).
//
// What bounds it: per attempt, six TD-MLP evaluations (see tdmlp.cuh) plus
// one grid barrier. Measured on an H100 at B = 512, an attempt takes 0.21 ms,
// the time of one launch of the step kernel (six 35 µs evaluations), so the
// barrier and the controller cost nothing visible next to the evaluations.
// A recorded accept adds one 1.6 MB copy to L2/HBM.
#include "persistent.cuh"

// The whole adaptive solve from (u0, k1_0) with sc = (t0, t_end, dt0) on the
// device. scratch holds 8·B·F floats, slots 2·ceil(B / kRows), barrier one
// zeroed unsigned int. With n_dense > 0 it records knots, with n_ckpt > 0
// checkpoints every `stride` accepts (null pointers otherwise). With rand
// (max_steps uniforms) it keeps the reservoir sample in res_u (B, F) and
// stats_f[1] (both null otherwise; stats_f holds 2 floats). Fails with
// cudaErrorCooperativeLaunchTooLarge when not even one CTA fits on an SM.
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
  using namespace lrnde;
  if ((n_ckpt > 0 && stride < 1) || (rand == nullptr) != (res_u == nullptr))
    return cudaErrorInvalidValue;
  SolveArgs<TDMLP> a{u0, k10, sc, saveat, n_save, TDMLP{w1, b1, w2, b2, F, H},
              u, ys, stats_i, stats_f, scratch, slots, barrier, B, max_steps,
              rtol, atol, inv_n, knot_ts, knot_us, n_dense, ckpt_ts, ckpt_us,
              ckpt_ks, ckpt_dts, ckpt_qolds, n_ckpt, stride, rand, res_u};
  const size_t smem = shared_floats(a.w) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(persistent_solve_kernel<TDMLP>, smem, &granted);
  if (err != cudaSuccess) return err;
  return launch_cooperative(persistent_solve_kernel<TDMLP>, &a, B, smem,
                            static_cast<cudaStream_t>(stream), nullptr);
}
