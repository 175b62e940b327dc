// The Dense chain:
//   f(x) = a_L,  a_0 = tanh(x) (or x),  a_{l+1} = act_l(a_l·W_l + b_l),
// with act_l tanh or the identity and d_0 = d_L = F. Weights are in the JAX
// layout, W_l (d_l, d_{l+1}) row-major.
//
// Counterpart of the ("chain", dims, acts, lead) family of the reference
// (localregneuralde_tpu/ops/pallas/fused_solve.py::family_make_f and
// fused_solve_bwd.py::_family_hooks).
//
// DenseChainT<Rows, Threads, TimeRow> is the chain with its row blocking as
// template parameters. With TimeRow, W_l is a (d_l + 1, d_{l+1}) TD matrix
// whose last row is the time weight, and a layer reads the time t:
// a_{l+1} = act_l(a_l·W_l[0:d_l] + t·W_l[d_l] + b_l) (the score network of
// kernels 6 and 11, score.cuh). Kernel 11 evaluates it with chain_forward,
// below; the latent ODE's kernels 5 and 9 evaluate the chain a warp a row
// (chain_rows.cuh) and kernel 6 a warp a group of rows (score_rows.cuh),
// with the same sums.
//
// Work split of chain_forward: one CTA of Threads threads owns Rows batch
// rows and keeps the whole chain in shared memory; an evaluation is L
// dependent layer passes, one thread per (output unit, group of rows), each
// a short FP32 FFMA sum over the layer's input from shared memory (a weight
// loaded once serves the thread's rows), with a CTA barrier between passes.
#pragma once

#include "tdmlp.cuh"

namespace lrnde {

constexpr int kChainMaxLayers = 16;
// interleaved accumulators of a layer's sum, added as (0+1)+(2+3)
constexpr int kChainAcc = 4;

struct ChainSmem {
  float* w;    // the packed weights: per layer W_l, then b_l
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

// Row stride of the activation buffers: the smallest count of floats at
// least the widest layer that is 4 modulo 8. A multiple of 4 keeps every
// row 16-byte aligned for chain_forward's float4 reads along a row; 4
// modulo 8 puts rows r = 0..7 at banks 4r (mod 32), so the rows a warp
// reads at once in a narrow layer never share a bank (the score chain's
// 2-wide last layer reads 8 rows, which at a stride of 64 would share one).
template <int R, int T, bool TR>
__host__ __device__ inline int chain_stride(const DenseChainT<R, T, TR>& w) {
  return ((w.maxw + 3) / 8) * 8 + 4;
}


// Floats of the shared memory of a chain_forward CTA (kernel 11).
template <int R, int T, bool TR>
__host__ __device__ inline size_t shared_floats(const DenseChainT<R, T, TR>& w) {
  return round_up4(w.n_params) + 2 * static_cast<size_t>(R) * chain_stride(w)
       + T;
}

template <int R, int T, bool TR>
__device__ inline ChainSmem carve_shared(const DenseChainT<R, T, TR>& w,
                                         float* raw) {
  ChainSmem s;
  s.w = raw;
  s.act = s.w + round_up4(w.n_params);
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

// Activation l of the row block: one of the two ping-pong buffers of
// sm.act.
template <int R, int T, bool TR>
__device__ inline float* chain_act(const DenseChainT<R, T, TR>& w, float* buf,
                                   int l) {
  return buf + static_cast<size_t>(l & 1) * R * chain_stride(w);
}

// One evaluation of the chain at time t (read with TimeRow only) on the
// stage input x ([rows][F] row-major): a_0 from x, then the L layers; the
// last writes rows [0, nrows) of out (row-major, stride F). The activations
// a_0..a_L go to the two ping-pong buffers at `acts` (16-byte aligned). The
// caller synchronises before x is loaded and after this returns.
//
// A layer pass: when the CTA has fewer threads than rows x outputs (G =
// T / d_out row groups, fewer than the rows), thread (g, o) computes output
// o for the rows g, g + G, ..., so each weight W_l[k, o] it loads serves
// several rows, and it reads each row's inputs four at a time (one float4);
// otherwise one thread takes one (row, output). Every output is the sum of
// kChainAcc interleaved accumulators over k, added as (0+1)+(2+3), whatever
// the mapping, so both give the same bits.
template <int R, int T, bool TR>
__device__ inline void chain_forward(const DenseChainT<R, T, TR>& w,
                                     const float* W, const float* x,
                                     float t, float* acts, float* out,
                                     int nrows) {
  static_assert(kChainAcc == 4, "a float4 of inputs per accumulator round");
  const int F = w.F, M = chain_stride(w);
  float* a0 = chain_act(w, acts, 0);
  for (int i = threadIdx.x; i < R * F; i += T) {
    const int r = i / F, c = i - r * F;
    const float v = x[r * F + c];
    a0[r * M + c] = w.lead ? tanhf(v) : v;
  }
  __syncthreads();
  for (int l = 0; l < w.L; ++l) {
    const int din = w.dims[l], dout = w.dims[l + 1];
    const float* Wl = W + w.off[l];
    const float* bl = Wl + (din + TR) * dout;
    const float* ain = chain_act(w, acts, l);
    float* aout = chain_act(w, acts, l + 1);
    const bool tanh_l = (w.acts >> l) & 1u;
    const bool last = l == w.L - 1;
    const int G = dout < T ? T / dout : 1;
    if (G >= R) {
      // one (row, output) per thread: nothing to share between rows
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
      continue;
    }
    for (int it = threadIdx.x; it < G * dout; it += T) {
      const int g = it / dout, o = it - g * dout;
      float acc[R][kChainAcc];
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int q = 0; q < kChainAcc; ++q) acc[j][q] = 0.f;
      for (int k = 0; k < din; k += kChainAcc) {
        float wk[kChainAcc];
#pragma unroll
        for (int q = 0; q < kChainAcc; ++q)
          wk[q] = k + q < din ? Wl[(k + q) * dout + o] : 0.f;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = g + j * G;
          if (r >= R) break;
          const float4 xv = *reinterpret_cast<const float4*>(ain + r * M + k);
          const float xq[kChainAcc] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int q = 0; q < kChainAcc; ++q)
            if (k + q < din) acc[j][q] = fmaf(xq[q], wk[q], acc[j][q]);
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = g + j * G;
        if (r >= R) break;
        float z = (acc[j][0] + acc[j][1]) + (acc[j][2] + acc[j][3]);
        if constexpr (TR) z = __fadd_rn(z, __fmul_rn(t, Wl[din * dout + o]));
        z = z + bl[o];
        if (tanh_l) z = tanhf(z);
        aout[r * M + o] = z;
        if (last && r < nrows) out[r * F + o] = z;
      }
    }
    __syncthreads();
  }
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
