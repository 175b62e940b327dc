// Shared device code of the backward kernels: the Tsit5 stage coefficients
// of the transposes, the layout of a flat TD-MLP weight gradient, and the
// fixed-order reduction of per-CTA (or per-cluster) gradient partials.
//
// Per stage evaluation at time s the TD-MLP transposes as
//   z = x·W1 + b1 + s·w1t ; h = tanh(z) ; k = h·W2 + b2 + s·w2t
//   dh = dk·W2ᵀ ; dz = dh·(1−h²) ; dx = dz·W1ᵀ
// (sweep_cluster.cuh::transpose_rows, kernels 3, 7 and 8). The partials
// are summed in a fixed order by a second kernel, so the gradients are the
// same from run to run; no float atomics.
#pragma once

#include "tdmlp.cuh"

namespace lrnde {

// Stage coefficients a_ij (row i gives the input of the (i+2)-th stage
// derivative) and stage-time fractions.
static __constant__ float kA[6][6] = {
    {A21},
    {A31, A32},
    {A41, A42, A43},
    {A51, A52, A53, A54},
    {A61, A62, A63, A64, A65},
    {A71, A72, A73, A74, A75, A76},
};

// Floats of one flat weight gradient: w1 (F+1, H), b1 (H), w2 (H+1, F),
// b2 (F), the layout of ops/cuda/fused_mlp_bwd.py::split_weight_grad.
__host__ __device__ inline size_t grad_floats(int F, int H) {
  return static_cast<size_t>(F + 1) * H + H + static_cast<size_t>(H + 1) * F +
         F;
}

// out[e] = Σ_c part[c·n + e] over the n_parts partials, in order c = 0, 1, ...
static __global__ void reduce_partials_kernel(const float* __restrict__ part,
                                              int n_parts, size_t n,
                                              float* __restrict__ out) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int c = 0; c < n_parts; ++c) acc += part[c * n + e];
  out[e] = acc;
}

inline cudaError_t reduce_partials(const float* part, int n_parts, size_t n,
                                   float* out, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = static_cast<int>((n + threads - 1) / threads);
  reduce_partials_kernel<<<blocks, threads, 0, stream>>>(part, n_parts, n, out);
  return cudaGetLastError();
}

}  // namespace lrnde
