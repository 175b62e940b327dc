// Kernel 2: one whole Tsit5 step of the TD-MLP dynamics over the batch.
//
// Replaces localregneuralde_tpu/ops/pallas/fused_mlp.py::_step_kernel
// (called from _fused_step_impl). Each CTA runs the six stage evaluations of
// its kRows rows back to back with the same device function as kernel 1
// (tdmlp.cuh), so the twelve products never leave the SM except for the
// stage derivatives, which are outputs anyway: a stage reads the earlier
// ones back from L2. It writes the nine outputs of the ode/step.py contract:
// (u_new, ũ, k2, k3, k4, k5, k6, k7, g6). The bound is the one of kernel 1,
// six times over: every stage streams the weights from L2 once per CTA.
#include "tdmlp.cuh"

namespace lrnde {

struct StepOut {
  float* unew;
  float* utilde;
  float* k[6];  // k2..k7
  float* g6;
};

__global__ void __launch_bounds__(kThreads)
tsit5_step_kernel(const float* u, const float* k1, const float* sc, TDMLP w,
                  StepOut o, int B) {
  extern __shared__ float4 smem_raw[];
  const Smem sm = carve_smem(reinterpret_cast<float*>(smem_raw), w.F, w.H);
  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - r0);
  const size_t off = static_cast<size_t>(r0) * w.F;
  const float t = sc[0], dt = sc[1];
  StepRows p;
  p.u = u + off;
  p.k[0] = const_cast<float*>(k1) + off;  // read only
  for (int j = 0; j < 6; ++j) p.k[j + 1] = o.k[j] + off;
  p.unew = o.unew + off;
  p.utilde = o.utilde + off;
  p.g6 = o.g6 + off;
  tsit5_rows(w, sm, p, t, dt, nrows, false, 0.f, 0.f);
}

}  // namespace lrnde

// One Tsit5 step from (u, t) with step dt and FSAL derivative k1; sc holds
// (t, dt) on the device. Returns cudaGetLastError().
extern "C" int lrnde_tsit5_step(const float* u, const float* k1,
                                const float* sc, const float* w1,
                                const float* b1, const float* w2,
                                const float* b2, float* unew, float* utilde,
                                float* k2, float* k3, float* k4, float* k5,
                                float* k6, float* k7, float* g6, int B, int F,
                                int H, void* stream) {
  using namespace lrnde;
  const TDMLP w{w1, b1, w2, b2, F, H};
  const StepOut o{unew, utilde, {k2, k3, k4, k5, k6, k7}, g6};
  const size_t smem = smem_floats(F, H) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(tsit5_step_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const int grid = (B + kRows - 1) / kRows;
  tsit5_step_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(u, k1, sc, w, o, B);
  return cudaGetLastError();
}
