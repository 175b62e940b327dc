// Kernel 3: the VJP of one whole Tsit5 step of the TD-MLP dynamics.
//
// Replaces localregneuralde_tpu/ops/pallas/fused_mlp_bwd.py::_bwd_kernel
// (called from fused_step_bwd). On the TPU the sequential grid carried the
// weight-gradient sums from one batch tile to the next in VMEM. Here the row
// blocks run in parallel: each CTA transposes the step for its kRows rows
// (tsit5_bwd.cuh: six-stage recompute, reverse pass, stage-batched weight
// gradients), writes d_u and d_k1 for its rows and its own weight-gradient
// partial, and a second kernel sums the partials in CTA order, so the
// gradients are deterministic. Cotangents for t and dt are not produced:
// the controller fence makes them zero. What bounds it is what bounds the
// step kernel (L2 weight reads, see tdmlp.cuh), twice over, plus one pass
// over the 0.63 MB partial per CTA.
#include "tsit5_bwd.cuh"

namespace lrnde {

struct StepCts {
  const float* d_unew;
  const float* d_utilde;
  const float* d_k[6];  // cotangents on k2..k7
  const float* d_g6;
};

__global__ void __launch_bounds__(kThreads)
tsit5_step_bwd_kernel(const float* u, const float* k1, const float* sc,
                      TDMLP w, StepCts c, float* d_u, float* d_k1,
                      float* scratch, float* part, int B) {
  extern __shared__ float4 smem_raw[];
  const int F = w.F;
  const BwdSmem bs = carve_bwd_smem(reinterpret_cast<float*>(smem_raw), F, w.H);
  const int rb = blockIdx.x;
  const int nrows = min(kRows, B - rb * kRows);
  const size_t BF = static_cast<size_t>(B) * F;
  const size_t off = static_cast<size_t>(rb) * kRows * F;
  const float t = sc[0], dt = sc[1];
  float* const ks = scratch;            // k2..k7: 6 (B, F)
  float* const dks = scratch + 6 * BF;  // cotangents on k2..k7: 6 (B, F)
  float* const blk = scratch + 12 * BF + rb * bwd_block_floats(F);
  float* const g = part + rb * grad_floats(F, w.H);

  zero_partial(g, grad_floats(F, w.H));
  // seeds: ũ = dt·Σ btilde_j k_j, plus the direct cotangents on k2..k7
  const float bt[7] = {BT1, BT2, BT3, BT4, BT5, BT6, BT7};
  for (int i = threadIdx.x; i < nrows * F; i += kThreads) {
    const size_t o = off + i;
    const float ut = c.d_utilde[o];
    d_k1[o] = (dt * bt[0]) * ut;
#pragma unroll
    for (int j = 0; j < 6; ++j) dks[j * BF + o] = (dt * bt[j + 1]) * ut + c.d_k[j][o];
  }
  __syncthreads();
  BwdRows p;
  p.u = u + off;
  p.k[0] = const_cast<float*>(k1) + off;  // read only
  p.dk[0] = d_k1 + off;
  for (int j = 0; j < 6; ++j) {
    p.k[j + 1] = ks + j * BF + off;
    p.dk[j + 1] = dks + j * BF + off;
  }
  p.d_unew = c.d_unew + off;
  p.d_g6 = c.d_g6 + off;
  p.d_u = d_u + off;
  p.blk = blk;
  tsit5_rows_bwd(w, bs, p, t, dt, nrows, g);
}

}  // namespace lrnde

// Floats of scratch the step VJP needs at (B, F, H).
extern "C" long long lrnde_bwd_scratch_floats(int B, int F, int H) {
  using namespace lrnde;
  (void)H;
  const long long n_blocks = (B + kRows - 1) / kRows;
  return 12LL * B * F + n_blocks * static_cast<long long>(bwd_block_floats(F));
}

// VJP of one Tsit5 step from (u, t) with step dt and FSAL derivative k1;
// sc = (t, dt) on the device. The nine cotangents are those of (u_new, ũ,
// k2..k7, g6). Writes d_u, d_k1 and the flat weight gradient d_w
// (grad_floats(F, H)); part holds ceil(B / kRows) partials. Returns
// cudaGetLastError().
extern "C" int lrnde_tsit5_step_bwd(
    const float* u, const float* k1, const float* sc, const float* w1,
    const float* b1, const float* w2, const float* b2, const float* d_unew,
    const float* d_utilde, const float* d_k2, const float* d_k3,
    const float* d_k4, const float* d_k5, const float* d_k6,
    const float* d_k7, const float* d_g6, float* d_u, float* d_k1,
    float* d_w, float* scratch, float* part, int B, int F, int H,
    void* stream) {
  using namespace lrnde;
  const TDMLP w{w1, b1, w2, b2, F, H};
  const StepCts c{d_unew, d_utilde, {d_k2, d_k3, d_k4, d_k5, d_k6, d_k7}, d_g6};
  const size_t smem = bwd_smem_floats(F, H) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(tsit5_step_bwd_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const int grid = (B + kRows - 1) / kRows;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  tsit5_step_bwd_kernel<<<grid, kThreads, smem, s>>>(u, k1, sc, w, c, d_u,
                                                     d_k1, scratch, part, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(part, grid, grad_floats(F, H), d_w, s);
}
