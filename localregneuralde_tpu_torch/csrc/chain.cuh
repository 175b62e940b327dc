// The Dense chain as a dynamics type of the Tsit5 attempt code
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
// DenseChainT<Rows, Threads, TimeRow> is the chain with its row blocking as
// template parameters; DenseChain is kernels 5 and 9's. With TimeRow, W_l is
// a (d_l + 1, d_{l+1}) TD matrix whose last row is the time weight, and a
// layer reads the time t: a_{l+1} = act_l(a_l·W_l[0:d_l] + t·W_l[d_l] + b_l)
// (the score network of kernels 6 and 11, score.cuh).
//
// Work split: one CTA of Threads threads owns Rows batch rows. The chain is
// narrow (the PhysioNet config: 8 layers alternating 20 -> 40 -> 20, 26 KB of
// weights), so every CTA copies all weights into shared memory once per
// launch, and an evaluation is L dependent layer passes, one thread per (row,
// output unit), each a short FP32 FFMA sum over the layer's input from shared
// memory. What bounds it on an H100 is that serial chain: one attempt is 6·L
// dependent layer passes with a __syncthreads between them, plus the grid
// barrier; the FLOPs (13 kFLOP per row and evaluation at the PhysioNet
// widths) are negligible. Small row blocks give many CTAs (B = 512: 128
// CTAs, one per SM), which keeps every pass short.
#pragma once

#include "tdmlp.cuh"

namespace lrnde {

constexpr int kChainRows = 4;       // batch rows per CTA of kernels 5 and 9
constexpr int kChainThreads = 256;  // threads per CTA
constexpr int kChainMaxLayers = 16;
// interleaved accumulators of a layer's sum, added as (0+1)+(2+3)
constexpr int kChainAcc = 4;

struct ChainSmem {
  float* w;    // the packed weights: per layer W_l, then b_l
  float* xs;   // [F][rows] stage input, transposed
  float* act;  // 2 x [rows][stride] activations, ping-pong
  float* red;  // [threads] block reduction
};

template <int Rows, int Threads, bool TimeRow>
struct DenseChainT {
  static constexpr int rows = Rows;
  static constexpr int threads = Threads;
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

using DenseChain = DenseChainT<kChainRows, kChainThreads, false>;

// Row stride of the activation buffers: the widest layer rounded up to an
// odd count of floats, so the rows a warp reads in a narrow layer fall in
// different shared-memory banks (the score chain's 2-wide last layer reads
// 8 rows at once, which at a stride of 64 would share one bank).
template <int R, int T, bool TR>
__host__ __device__ inline int chain_stride(const DenseChainT<R, T, TR>& w) {
  return w.maxw | 1;
}

// Floats of the shared memory of a forward CTA (persistent.cuh).
template <int R, int T, bool TR>
__host__ __device__ inline size_t shared_floats(const DenseChainT<R, T, TR>& w) {
  return static_cast<size_t>(w.n_params) + static_cast<size_t>(w.F) * R
       + 2 * static_cast<size_t>(R) * chain_stride(w) + T;
}

template <int R, int T, bool TR>
__device__ inline ChainSmem carve_shared(const DenseChainT<R, T, TR>& w,
                                         float* raw) {
  ChainSmem s;
  s.w = raw;
  s.xs = s.w + w.n_params;
  s.act = s.xs + static_cast<size_t>(w.F) * R;
  s.red = s.act + 2 * R * chain_stride(w);
  return s;
}

// Copy the weights into the CTA's shared memory (once per launch).
template <int R, int T, bool TR>
__device__ inline void load_shared(const DenseChainT<R, T, TR>& w,
                                   const ChainSmem& sm) {
  for (int l = 0; l < w.L; ++l) {
    const int n = (w.dims[l] + TR) * w.dims[l + 1], m = w.dims[l + 1];
    float* dst = sm.w + w.off[l];
    for (int i = threadIdx.x; i < n; i += T) dst[i] = __ldg(w.wp[l] + i);
    for (int i = threadIdx.x; i < m; i += T) dst[n + i] = __ldg(w.bp[l] + i);
  }
  __syncthreads();
}

// Activation l of the row block: with `keep`, slot l of keep ((L + 1) x
// [rows][stride]); otherwise one of the two ping-pong buffers of sm.act.
template <int R, int T, bool TR>
__device__ inline float* chain_act(const DenseChainT<R, T, TR>& w, float* buf,
                                   int l, bool keep) {
  return buf + static_cast<size_t>(keep ? l : (l & 1)) * R * chain_stride(w);
}

// One evaluation of the chain at time t (read with TimeRow only) on the
// stage input x, x(r, c) at x[r·rs + c·cs]: a_0 from x, then the L layers;
// the last writes rows [0, nrows) of out (row-major, stride F). The
// activations a_0..a_L go to `acts` (keep = true: (L + 1) x [rows][stride],
// for the backward) or to the two ping-pong buffers there. The caller
// synchronises before x is loaded and after this returns.
template <int R, int T, bool TR>
__device__ inline void chain_forward(const DenseChainT<R, T, TR>& w,
                                     const float* W, const float* x, int rs,
                                     int cs, float t, float* acts, bool keep,
                                     float* out, int nrows) {
  const int F = w.F, M = chain_stride(w);
  float* a0 = chain_act(w, acts, 0, keep);
  for (int i = threadIdx.x; i < R * F; i += T) {
    const int r = i / F, c = i - r * F;
    const float v = x[r * rs + c * cs];
    a0[r * M + c] = w.lead ? tanhf(v) : v;
  }
  __syncthreads();
  for (int l = 0; l < w.L; ++l) {
    const int din = w.dims[l], dout = w.dims[l + 1];
    const float* Wl = W + w.off[l];
    const float* bl = Wl + (din + TR) * dout;
    const float* ain = chain_act(w, acts, l, keep);
    float* aout = chain_act(w, acts, l + 1, keep);
    const bool tanh_l = (w.acts >> l) & 1u;
    const bool last = l == w.L - 1;
    for (int i = threadIdx.x; i < R * dout; i += T) {
      const int r = i / dout, o = i - r * dout;
      const float* xr = ain + r * M;
      float acc[kChainAcc] = {0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < din; k += kChainAcc) {
#pragma unroll
        for (int q = 0; q < kChainAcc; ++q)
          if (k + q < din) acc[q] = fmaf(xr[k + q], Wl[(k + q) * dout + o], acc[q]);
      }
      float z = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      // the time term, rounded as the plain version rounds it
      if constexpr (TR) z = __fadd_rn(z, __fmul_rn(t, Wl[din * dout + o]));
      z = z + bl[o];
      if (tanh_l) z = tanhf(z);
      aout[r * M + o] = z;
      if (last && r < nrows) out[r * F + o] = z;
    }
    __syncthreads();
  }
}

// The eval of the Tsit5 attempt code (tsit5_rows) for kernel 5: the chain is
// autonomous, so the stage time s is not read.
__device__ inline void eval_rows(const DenseChain& w, const ChainSmem& sm,
                                 float /*s*/, float* out, int nrows) {
  chain_forward(w, sm.w, sm.xs, 1, kChainRows, 0.f, sm.act, false, out, nrows);
}

// A chain from its host description: weight pointers (W_0, b_0, W_1, b_1,
// ...), dims (L + 1) and flags. False outside the kernel's limits
// (1 <= L <= kChainMaxLayers, positive widths, d_0 = d_L).
template <int R, int T, bool TR>
inline bool make_chain(DenseChainT<R, T, TR>* c, const void* const* wb,
                       const int* dims, int L, unsigned int acts, int lead) {
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
    off += (dims[l] + TR) * dims[l + 1] + dims[l + 1];
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
