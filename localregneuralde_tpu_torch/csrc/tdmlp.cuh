// Shared device code of the TD-MLP kernels: one dynamics evaluation of a
// row block, the Tsit5 stage algebra around it, and the Tsit5 constants.
//
// The dynamics is TDChain(Dense(F+1 -> H, tanh), Dense(H+1 -> F)):
//   y = tanh(x·W1 + b1 + s·w1t)·W2 + b2 + s·w2t
// with the weights in the JAX layout, (in, out) row-major, and the time
// channel as the LAST input row: W1 is rows 0..F-1 of the (F+1, H) weight and
// w1t its row F; W2 is rows 0..H-1 of the (H+1, F) weight and w2t its row H.
// No copy or padding of the weights is made.
//
// Work split: one CTA of kThreads threads owns a block of kRows batch rows.
// The stage input of the block sits transposed in shared memory ([F][kRows],
// so one k reads the kRows values as two float4s), the hidden row
// tanh(x·W1 + ...) sits in shared memory ([H][kRows]); H is not padded, the
// loops run to H. The weights are read through the read-only path and stay
// L2-resident (0.63 MB at F = 784, H = 100). Every product is true FP32 FFMA.
//
// Summation order is part of the design. Below rtol ~1e-6 the solver's
// embedded error estimate ũ, a cancelling sum of the stage derivatives, is
// dominated by their f32 rounding error, so the step count follows how
// accurately f is summed (measured on an H100 at rtol 1.4e-8: a float64 step
// has a ~50x smaller error estimate). Each hidden unit's 784-term product is
// therefore split into kSplit interleaved partial sums, added in a fixed
// order, and each output's 100-term product into 4 interleaved accumulators.
// That sums more accurately than one running sum, and the independent
// accumulators keep several L2 loads in flight per thread.
//
// What bounds it on an H100: the weight loads from L2 are latency-bound, and
// each CTA streams the whole of W1 and W2 (0.63 MB) from L2 once per
// evaluation. B = 512 gives 64 CTAs, one per SM, so the CTA is made as wide
// as an SM allows (1024 threads) to keep the most loads in flight: measured
// on an H100, 1024 threads ran one evaluation in 35 µs where 256 took 67 µs,
// and the Tsit5 step in 0.22 ms where 256 took 0.62 ms. Kernels 1 and 2
// run this way. The persistent solve (kernel 4, persistent_solve.cu) keeps
// this arithmetic bit for bit on thread-block clusters instead, each CTA
// with its residue slice of the weights resident in shared memory; the
// stored-adjoint kernels 3, 7 and 8 run on the clusters of
// sweep_cluster.cuh.
#pragma once

#include <cuda_runtime.h>

namespace lrnde {

constexpr int kThreads = 1024;  // threads per CTA (so at most 64 registers)
constexpr int kRows = 8;       // batch rows per CTA (row block)

// Tsitouras 5(4) coefficients, rounded from the double values exactly as
// the reference rounds its Python floats to f32.
constexpr float C1 = static_cast<float>(0.161);
constexpr float C2 = static_cast<float>(0.327);
constexpr float C3 = static_cast<float>(0.9);
constexpr float C4 = static_cast<float>(0.9800255409045097);
constexpr float A21 = static_cast<float>(0.161);
constexpr float A31 = static_cast<float>(-0.008480655492356989);
constexpr float A32 = static_cast<float>(0.335480655492357);
constexpr float A41 = static_cast<float>(2.8971530571054935);
constexpr float A42 = static_cast<float>(-6.359448489975075);
constexpr float A43 = static_cast<float>(4.3622954328695815);
constexpr float A51 = static_cast<float>(5.325864828439257);
constexpr float A52 = static_cast<float>(-11.748883564062828);
constexpr float A53 = static_cast<float>(7.4955393428898365);
constexpr float A54 = static_cast<float>(-0.09249506636175525);
constexpr float A61 = static_cast<float>(5.86145544294642);
constexpr float A62 = static_cast<float>(-12.92096931784711);
constexpr float A63 = static_cast<float>(8.159367898576159);
constexpr float A64 = static_cast<float>(-0.071584973281401);
constexpr float A65 = static_cast<float>(-0.028269050394068383);
constexpr float A71 = static_cast<float>(0.09646076681806523);
constexpr float A72 = static_cast<float>(0.01);
constexpr float A73 = static_cast<float>(0.4798896504144996);
constexpr float A74 = static_cast<float>(1.379008574103742);
constexpr float A75 = static_cast<float>(-3.290069515436081);
constexpr float A76 = static_cast<float>(2.324710524099774);
constexpr float BT1 = static_cast<float>(-0.00178001105222577714);
constexpr float BT2 = static_cast<float>(-0.0008164344596567469);
constexpr float BT3 = static_cast<float>(0.007880878010261995);
constexpr float BT4 = static_cast<float>(-0.1447110071732629);
constexpr float BT5 = static_cast<float>(0.5823571654525552);
constexpr float BT6 = static_cast<float>(-0.45808210592918697);
constexpr float BT7 = static_cast<float>(0.015151515151515152);

struct Smem;

// A dynamics type of the Tsit5 attempt code (tsit5_rows, solve.cuh) names
// its row blocking (rows per CTA, threads per CTA) and its shared memory
// type, and has an eval_rows() overload.
struct TDMLP {
  static constexpr int rows = kRows;
  static constexpr int threads = kThreads;
  using Shared = Smem;
  const float* w1;  // (F + 1, H)
  const float* b1;  // (H)
  const float* w2;  // (H + 1, F)
  const float* b2;  // (F)
  int F;
  int H;
};

// K-split of the first product: kSplit threads share one hidden unit, each
// summing every kSplit-th input feature.
constexpr int kSplit = 16;
// Interleaved accumulators of the second product, added pairwise.
constexpr int kAcc2 = 4;
static_assert(kAcc2 == 4, "tdmlp_rows adds the accumulators as (0+1)+(2+3)");

// Dynamic shared memory of one CTA, in floats. Every part is a multiple of
// kRows floats, so each part stays 32-byte aligned.
__host__ __device__ inline size_t smem_floats(int F, int H) {
  return static_cast<size_t>(F) * kRows
       + static_cast<size_t>(kSplit) * H * kRows
       + static_cast<size_t>(H) * kRows + kThreads;
}

struct Smem {
  float* xs;    // [F][kRows] stage input, transposed
  float* part;  // [kSplit][H][kRows] partial sums of x·W1
  float* hid;   // [H][kRows] hidden row
  float* red;   // [kThreads] block reduction
};

__device__ inline Smem carve_smem(float* base, int F, int H) {
  Smem s;
  s.xs = base;
  s.part = s.xs + static_cast<size_t>(F) * kRows;
  s.hid = s.part + static_cast<size_t>(kSplit) * H * kRows;
  s.red = s.hid + static_cast<size_t>(H) * kRows;
  return s;
}

// Load rows [0, nrows) of x (row-major, stride F) into sm.xs; rows past
// nrows are zero.
__device__ inline void load_rows(const Smem& sm, const float* x, int F,
                                 int nrows) {
  for (int i = threadIdx.x; i < kRows * F; i += kThreads) {
    const int r = i / F, c = i - r * F;
    sm.xs[c * kRows + r] = r < nrows ? x[static_cast<size_t>(r) * F + c] : 0.f;
  }
}

// One TD-MLP evaluation of the stage input in sm.xs at stage time s; writes
// rows [0, nrows) of out (row-major, stride F). The caller synchronises
// before sm.xs is loaded and after this returns.
__device__ inline void tdmlp_rows(const TDMLP& w, const Smem& sm, float s,
                                  float* out, int nrows) {
  const int F = w.F, H = w.H;
  for (int item = threadIdx.x; item < H * kSplit; item += kThreads) {
    const int h = item % H, q = item / H;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = q; k < F; k += kSplit) {
      const float wv = __ldg(w.w1 + static_cast<size_t>(k) * H + h);
      const float4 x0 = *reinterpret_cast<const float4*>(sm.xs + k * kRows);
      const float4 x1 = *reinterpret_cast<const float4*>(sm.xs + k * kRows + 4);
      acc[0] = fmaf(x0.x, wv, acc[0]);
      acc[1] = fmaf(x0.y, wv, acc[1]);
      acc[2] = fmaf(x0.z, wv, acc[2]);
      acc[3] = fmaf(x0.w, wv, acc[3]);
      acc[4] = fmaf(x1.x, wv, acc[4]);
      acc[5] = fmaf(x1.y, wv, acc[5]);
      acc[6] = fmaf(x1.z, wv, acc[6]);
      acc[7] = fmaf(x1.w, wv, acc[7]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) sm.part[(q * H + h) * kRows + r] = acc[r];
  }
  __syncthreads();
  const float* w1t = w.w1 + static_cast<size_t>(F) * H;
  for (int i = threadIdx.x; i < H * kRows; i += kThreads) {
    const int h = i / kRows, r = i - h * kRows;
    float z = 0.f;
    for (int q = 0; q < kSplit; ++q) z += sm.part[(q * H + h) * kRows + r];
    z = z + __ldg(w.b1 + h) + s * __ldg(w1t + h);
    sm.hid[h * kRows + r] = tanhf(z);
  }
  __syncthreads();
  const float* w2t = w.w2 + static_cast<size_t>(H) * F;
  for (int j = threadIdx.x; j < F; j += kThreads) {
    float acc[kAcc2][kRows];
#pragma unroll
    for (int a = 0; a < kAcc2; ++a)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[a][r] = 0.f;
    for (int h0 = 0; h0 < H; h0 += kAcc2) {
#pragma unroll
      for (int a = 0; a < kAcc2; ++a) {
        const int h = h0 + a;
        if (h < H) {
          const float wv = __ldg(w.w2 + static_cast<size_t>(h) * F + j);
          const float4 h0v = *reinterpret_cast<const float4*>(sm.hid + h * kRows);
          const float4 h1v = *reinterpret_cast<const float4*>(sm.hid + h * kRows + 4);
          acc[a][0] = fmaf(h0v.x, wv, acc[a][0]);
          acc[a][1] = fmaf(h0v.y, wv, acc[a][1]);
          acc[a][2] = fmaf(h0v.z, wv, acc[a][2]);
          acc[a][3] = fmaf(h0v.w, wv, acc[a][3]);
          acc[a][4] = fmaf(h1v.x, wv, acc[a][4]);
          acc[a][5] = fmaf(h1v.y, wv, acc[a][5]);
          acc[a][6] = fmaf(h1v.z, wv, acc[a][6]);
          acc[a][7] = fmaf(h1v.w, wv, acc[a][7]);
        }
      }
    }
    const float bias = __ldg(w.b2 + j), tw = __ldg(w2t + j);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float y = (acc[0][r] + acc[1][r]) + (acc[2][r] + acc[3][r]);
      if (r < nrows) out[static_cast<size_t>(r) * F + j] = y + bias + s * tw;
    }
  }
}

__device__ inline void eval_rows(const TDMLP& w, const Smem& sm, float s,
                                 float* out, int nrows) {
  tdmlp_rows(w, sm, s, out, nrows);
}

// Stage input u + dt·(a[0]·k[0] + ... + a[N-1]·k[N-1]) of the row block into
// xs ([F][D::rows], transposed; summed left to right, as the reference
// does); also stored row-major into `keep` when it is not null.
template <typename D, int N>
__device__ inline void stage_input(float* xs, const float* u,
                                   const float* const* k, const float (&a)[N],
                                   float dt, int F, int nrows, float* keep) {
  constexpr int R = D::rows;
  for (int i = threadIdx.x; i < R * F; i += D::threads) {
    const int r = i / F, c = i - r * F;
    float v = 0.f;
    if (r < nrows) {
      const size_t o = static_cast<size_t>(r) * F + c;
      float acc = a[0] * k[0][o];
#pragma unroll
      for (int j = 1; j < N; ++j) acc = acc + a[j] * k[j][o];
      v = u[o] + dt * acc;
      if (keep != nullptr) keep[o] = v;
    }
    xs[c * R + r] = v;
  }
}

// Sum of v over the CTA of T threads in a fixed tree order; every thread
// gets the sum.
template <int T>
__device__ inline float block_sum(float v, float* red) {
  static_assert((T & (T - 1)) == 0, "block_sum needs a power of two");
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

// Row-block pointers of one Tsit5 step (row-major, stride F). k[0] is the
// FSAL derivative k1 (read); k[1..6] receive k2..k7. utilde and g6 may be
// null.
struct StepRows {
  const float* u;
  float* k[7];
  float* unew;
  float* utilde;
  float* g6;
};

// One Tsit5 step of the row block from (u, t) with step dt: the six stage
// evaluations of the dynamics D (eval_rows), u_new, and optionally ũ and g6.
// With want_err it returns the block's Σ (ũ / (atol + max(|u|,
// |u_new|)·rtol))² to every thread, summed in a fixed order; otherwise 0.
template <typename D>
__device__ inline float tsit5_rows(const D& w, const typename D::Shared& sm,
                                   const StepRows& p, float t, float dt,
                                   int nrows, bool want_err, float atol,
                                   float rtol) {
  const int F = w.F;
  const float* k[7] = {p.k[0], p.k[1], p.k[2], p.k[3], p.k[4], p.k[5], p.k[6]};
  {
    const float a[1] = {A21};
    stage_input<D>(sm.xs, p.u, k, a, dt, F, nrows, nullptr);
  }
  __syncthreads();
  eval_rows(w, sm, t + C1 * dt, p.k[1], nrows);
  __syncthreads();
  {
    const float a[2] = {A31, A32};
    stage_input<D>(sm.xs, p.u, k, a, dt, F, nrows, nullptr);
  }
  __syncthreads();
  eval_rows(w, sm, t + C2 * dt, p.k[2], nrows);
  __syncthreads();
  {
    const float a[3] = {A41, A42, A43};
    stage_input<D>(sm.xs, p.u, k, a, dt, F, nrows, nullptr);
  }
  __syncthreads();
  eval_rows(w, sm, t + C3 * dt, p.k[3], nrows);
  __syncthreads();
  {
    const float a[4] = {A51, A52, A53, A54};
    stage_input<D>(sm.xs, p.u, k, a, dt, F, nrows, nullptr);
  }
  __syncthreads();
  eval_rows(w, sm, t + C4 * dt, p.k[4], nrows);
  __syncthreads();
  {
    const float a[5] = {A61, A62, A63, A64, A65};
    stage_input<D>(sm.xs, p.u, k, a, dt, F, nrows, p.g6);
  }
  __syncthreads();
  eval_rows(w, sm, t + dt, p.k[5], nrows);
  __syncthreads();
  {
    const float a[6] = {A71, A72, A73, A74, A75, A76};
    stage_input<D>(sm.xs, p.u, k, a, dt, F, nrows, p.unew);
  }
  __syncthreads();
  eval_rows(w, sm, t + dt, p.k[6], nrows);
  __syncthreads();
  float err = 0.f;
  for (int i = threadIdx.x; i < nrows * F; i += D::threads) {
    float acc = BT1 * k[0][i];
    acc = acc + BT2 * k[1][i];
    acc = acc + BT3 * k[2][i];
    acc = acc + BT4 * k[3][i];
    acc = acc + BT5 * k[4][i];
    acc = acc + BT6 * k[5][i];
    acc = acc + BT7 * k[6][i];
    const float ut = dt * acc;
    if (p.utilde != nullptr) p.utilde[i] = ut;
    if (want_err) {
      const float res =
          ut / (atol + fmaxf(fabsf(p.u[i]), fabsf(p.unew[i])) * rtol);
      err = fmaf(res, res, err);
    }
  }
  if (!want_err) return 0.f;
  return block_sum<D::threads>(err, sm.red);
}

// n floats rounded up to a multiple of 4 (16 bytes), so that a buffer
// carved after them can take float4 reads and 16-byte copies.
__host__ __device__ inline size_t round_up4(size_t n) { return (n + 3) & ~size_t{3}; }

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
// *granted remembers the largest size opted in, so the call (tens of
// microseconds of host time) is made once, not at every launch.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

}  // namespace lrnde
