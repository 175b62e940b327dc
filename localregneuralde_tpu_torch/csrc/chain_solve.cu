// Kernel 5: the whole adaptive Tsit5 solve of the autonomous Dense chain (the
// latent ODE's generative dynamics) in one cooperative launch: the solve of
// persistent.cuh instantiated for chain.cuh::DenseChain, with the same knot
// and checkpoint recording and reservoir as kernel 4.
//
// Replaces localregneuralde_tpu/ops/pallas/fused_solve.py::
// persistent_chain_solve (_make_kernel built for the ("chain", pads, acts,
// lead) family, family_make_f). The TPU kernel ran whole-batch tiles with
// the weights in VMEM; here every CTA keeps the whole chain in shared memory
// and owns kChainRows rows, so an attempt is 6·L dependent layer passes per
// CTA and one grid barrier.
//
// What bounds it on an H100: serial latency. At the PhysioNet widths (B =
// 512, F = 20, eight layers 20 <-> 40) an attempt is 39 MFLOP (0.6 µs at
// the FP32 peak) over 48 dependent layer passes and a grid-wide reduction;
// the 26 KB of weights are read from device memory once per CTA and launch.
#include "chain.cuh"
#include "persistent.cuh"

// Batch rows per CTA of kernels 5 and 9.
extern "C" int lrnde_chain_rows_per_block() { return lrnde::kChainRows; }

// Floats of dynamic shared memory of one kernel-5 CTA (0: outside limits).
extern "C" long long lrnde_chain_solve_smem_floats(const int* dims, int L) {
  using namespace lrnde;
  DenseChain c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_chain(&c, none, dims, L, 0u, 0)) return 0;
  return static_cast<long long>(shared_floats(c));
}

// The whole adaptive solve of the chain from (u0, k1_0) with sc = (t0,
// t_end, dt0) on the device: the contract of lrnde_persistent_tsit5, with
// the chain given by wb (2L pointers: W_0, b_0, W_1, ...), dims (L + 1),
// acts (bit l: tanh after layer l) and lead (tanh on the input). slots holds
// 2·ceil(B / kChainRows) floats. Returns cudaGetLastError().
extern "C" int lrnde_persistent_chain(
    const float* u0, const float* k10, const float* sc, const float* saveat,
    int n_save, const void* const* wb, const int* dims, int L,
    unsigned int acts, int lead, float* u, float* ys, int* stats_i,
    float* stats_f, float* scratch, float* slots, unsigned int* barrier,
    int B, int max_steps, float rtol, float atol, float inv_n,
    float* knot_ts, float* knot_us, int n_dense, float* ckpt_ts,
    float* ckpt_us, float* ckpt_ks, float* ckpt_dts, float* ckpt_qolds,
    int n_ckpt, int stride, const float* rand, float* res_u, void* stream) {
  using namespace lrnde;
  DenseChain c;
  if (!make_chain(&c, wb, dims, L, acts, lead) || (n_ckpt > 0 && stride < 1)
      || (rand == nullptr) != (res_u == nullptr))
    return cudaErrorInvalidValue;
  SolveArgs<DenseChain> a{u0, k10, sc, saveat, n_save, c, u, ys, stats_i,
                          stats_f, scratch, slots, barrier, B, max_steps,
                          rtol, atol, inv_n, knot_ts, knot_us, n_dense,
                          ckpt_ts, ckpt_us, ckpt_ks, ckpt_dts, ckpt_qolds,
                          n_ckpt, stride, rand, res_u};
  const size_t smem = shared_floats(c) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err =
      allow_smem(persistent_solve_kernel<DenseChain>, smem, &granted);
  if (err != cudaSuccess) return err;
  return launch_cooperative<DenseChain>(
      persistent_solve_kernel<DenseChain>, &a, B, smem,
      static_cast<cudaStream_t>(stream), nullptr);
}
