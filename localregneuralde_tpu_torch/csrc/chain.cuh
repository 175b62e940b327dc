// The autonomous Dense chain as a dynamics type of the Tsit5 attempt code
// (tdmlp.cuh::tsit5_rows, solve.cuh::attempt_eest, persistent.cuh): the
// latent ODE's generative dynamics,
//   f(x) = a_L,  a_0 = tanh(x) (or x),  a_{l+1} = act_l(a_l·W_l + b_l),
// with act_l tanh or the identity and d_0 = d_L = F. Weights are in the JAX
// layout, W_l (d_l, d_{l+1}) row-major.
//
// Counterpart of the ("chain", dims, acts, lead) family of the reference
// (localregneuralde_tpu/ops/pallas/fused_solve.py::family_make_f and
// fused_solve_bwd.py::_family_hooks).
//
// Work split: one CTA of kChainThreads threads owns kChainRows batch rows.
// The chain is narrow (the PhysioNet config: 8 layers alternating 20 -> 40
// -> 20, 26 KB of weights), so every CTA copies all weights into shared
// memory once per launch, and an evaluation is L dependent layer passes, one
// thread per (row, output unit), each a short FP32 FFMA sum over the layer's
// input from shared memory. What bounds it on an H100 is that serial chain:
// one attempt is 6·L dependent layer passes with a __syncthreads between
// them, plus the grid barrier; the FLOPs (13 kFLOP per row and evaluation at
// the PhysioNet widths) are negligible. Small row blocks give many CTAs
// (B = 512: 128 CTAs, one per SM), which keeps every pass short.
#pragma once

#include "tdmlp.cuh"

namespace lrnde {

constexpr int kChainRows = 4;       // batch rows per CTA
constexpr int kChainThreads = 256;  // threads per CTA
constexpr int kChainMaxLayers = 16;
// interleaved accumulators of a layer's sum, added as (0+1)+(2+3)
constexpr int kChainAcc = 4;

struct ChainSmem {
  float* w;    // the packed weights: per layer W_l, then b_l
  float* xs;   // [F][kChainRows] stage input, transposed
  float* act;  // 2 x [kChainRows][maxw] activations, ping-pong
  float* red;  // [kChainThreads] block reduction
};

struct DenseChain {
  static constexpr int rows = kChainRows;
  static constexpr int threads = kChainThreads;
  using Shared = ChainSmem;
  const float* wp[kChainMaxLayers];  // W_l in global memory
  const float* bp[kChainMaxLayers];  // b_l in global memory
  int off[kChainMaxLayers];          // offset of W_l in the packed weights
  int dims[kChainMaxLayers + 1];
  int L;
  unsigned int acts;  // bit l: tanh after layer l
  int lead;           // tanh on the input
  int F;              // dims[0] == dims[L]
  int maxw;           // the widest layer
  int n_params;       // floats of the packed weights
};

// Floats of the shared memory of a forward CTA (persistent.cuh).
__host__ __device__ inline size_t shared_floats(const DenseChain& w) {
  return static_cast<size_t>(w.n_params) + static_cast<size_t>(w.F) * kChainRows
       + 2 * static_cast<size_t>(kChainRows) * w.maxw + kChainThreads;
}

__device__ inline ChainSmem carve_shared(const DenseChain& w, float* raw) {
  ChainSmem s;
  s.w = raw;
  s.xs = s.w + w.n_params;
  s.act = s.xs + static_cast<size_t>(w.F) * kChainRows;
  s.red = s.act + 2 * kChainRows * w.maxw;
  return s;
}

// Copy the weights into the CTA's shared memory (once per launch).
__device__ inline void load_shared(const DenseChain& w, const ChainSmem& sm) {
  for (int l = 0; l < w.L; ++l) {
    const int n = w.dims[l] * w.dims[l + 1], m = w.dims[l + 1];
    float* dst = sm.w + w.off[l];
    for (int i = threadIdx.x; i < n; i += kChainThreads) dst[i] = __ldg(w.wp[l] + i);
    for (int i = threadIdx.x; i < m; i += kChainThreads) dst[n + i] = __ldg(w.bp[l] + i);
  }
  __syncthreads();
}

// Activation l of the row block: with `keep`, slot l of keep ((L + 1) x
// [rows][maxw]); otherwise one of the two ping-pong buffers of sm.act.
__device__ inline float* chain_act(const DenseChain& w, float* buf, int l,
                                   bool keep) {
  return buf + static_cast<size_t>(keep ? l : (l & 1)) * kChainRows * w.maxw;
}

// One evaluation of the chain on the stage input in xs ([F][rows],
// transposed): a_0 from xs, then the L layers; the last writes rows
// [0, nrows) of out (row-major, stride F). The activations a_0..a_L go to
// `acts` (keep = true: (L + 1) x [rows][maxw], for the backward) or to the
// two ping-pong buffers there. The caller synchronises before xs is loaded
// and after this returns.
__device__ inline void chain_forward(const DenseChain& w, const float* W,
                                     const float* xs, float* acts, bool keep,
                                     float* out, int nrows) {
  constexpr int R = kChainRows, T = kChainThreads;
  const int F = w.F, M = w.maxw;
  float* a0 = chain_act(w, acts, 0, keep);
  for (int i = threadIdx.x; i < R * F; i += T) {
    const int r = i / F, c = i - r * F;
    const float v = xs[c * R + r];
    a0[r * M + c] = w.lead ? tanhf(v) : v;
  }
  __syncthreads();
  for (int l = 0; l < w.L; ++l) {
    const int din = w.dims[l], dout = w.dims[l + 1];
    const float* Wl = W + w.off[l];
    const float* bl = Wl + din * dout;
    const float* ain = chain_act(w, acts, l, keep);
    float* aout = chain_act(w, acts, l + 1, keep);
    const bool tanh_l = (w.acts >> l) & 1u;
    const bool last = l == w.L - 1;
    for (int i = threadIdx.x; i < R * dout; i += T) {
      const int r = i / dout, o = i - r * dout;
      const float* x = ain + r * M;
      float acc[kChainAcc] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < din; k += kChainAcc) {
#pragma unroll
        for (int q = 0; q < kChainAcc; ++q)
          if (k + q < din) acc[q] = fmaf(x[k + q], Wl[(k + q) * dout + o], acc[q]);
      }
      float z = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + bl[o];
      if (tanh_l) z = tanhf(z);
      aout[r * M + o] = z;
      if (last && r < nrows) out[r * F + o] = z;
    }
    __syncthreads();
  }
}

// The eval of the Tsit5 attempt code (tsit5_rows): the chain is autonomous,
// so the stage time s is not read.
__device__ inline void eval_rows(const DenseChain& w, const ChainSmem& sm,
                                 float /*s*/, float* out, int nrows) {
  chain_forward(w, sm.w, sm.xs, sm.act, false, out, nrows);
}

// A DenseChain from its host description: weight pointers (W_0, b_0, W_1,
// b_1, ...), dims (L + 1) and flags. False outside the kernel's limits
// (1 <= L <= kChainMaxLayers, positive widths, d_0 = d_L).
inline bool make_chain(DenseChain* c, const void* const* wb, const int* dims,
                       int L, unsigned int acts, int lead) {
  if (L < 1 || L > kChainMaxLayers || dims[0] != dims[L]) return false;
  int off = 0, maxw = 0;
  for (int l = 0; l <= L; ++l) {
    if (dims[l] < 1) return false;
    c->dims[l] = dims[l];
    maxw = dims[l] > maxw ? dims[l] : maxw;
  }
  for (int l = 0; l < L; ++l) {
    c->wp[l] = static_cast<const float*>(wb[2 * l]);
    c->bp[l] = static_cast<const float*>(wb[2 * l + 1]);
    c->off[l] = off;
    off += dims[l] * dims[l + 1] + dims[l + 1];
  }
  c->L = L;
  c->acts = acts;
  c->lead = lead;
  c->F = dims[0];
  c->maxw = maxw;
  c->n_params = off;
  return true;
}

}  // namespace lrnde
