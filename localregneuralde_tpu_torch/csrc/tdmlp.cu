// Kernel 1: one TD-MLP dynamics evaluation y = f(x, s) over the batch.
//
// Replaces localregneuralde_tpu/ops/pallas/fused_mlp.py::_tdmlp_kernel
// (called from _fused_tdmlp_impl). On the TPU each grid step held a batch
// tile and the whole weights in VMEM; here each CTA owns kRows rows, keeps
// their input and hidden row in shared memory, and reads the weights from L2
// (see tdmlp.cuh for what bounds it). It serves k1 at t0 and the
// initial-step probe of the persistent solve.
#include "tdmlp.cuh"

namespace lrnde {

__global__ void __launch_bounds__(kThreads)
tdmlp_kernel(const float* __restrict__ x, const float* __restrict__ s_ptr,
             TDMLP w, float* __restrict__ out, int B) {
  extern __shared__ float4 smem_raw[];
  const Smem sm = carve_smem(reinterpret_cast<float*>(smem_raw), w.F, w.H);
  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - r0);
  const float s = *s_ptr;
  load_rows(sm, x + static_cast<size_t>(r0) * w.F, w.F, nrows);
  __syncthreads();
  tdmlp_rows(w, sm, s, out + static_cast<size_t>(r0) * w.F, nrows);
}

}  // namespace lrnde

extern "C" int lrnde_rows_per_block() { return lrnde::kRows; }

extern "C" const char* lrnde_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out = f(x, *s) for x (B, F); s is a device scalar. Returns cudaGetLastError().
extern "C" int lrnde_tdmlp(const float* x, const float* s, const float* w1,
                           const float* b1, const float* w2, const float* b2,
                           float* out, int B, int F, int H, void* stream) {
  using namespace lrnde;
  const TDMLP w{w1, b1, w2, b2, F, H};
  const size_t smem = smem_floats(F, H) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(tdmlp_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const int grid = (B + kRows - 1) / kRows;
  tdmlp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, s, w, out, B);
  return cudaGetLastError();
}
