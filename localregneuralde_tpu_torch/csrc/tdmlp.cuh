// Shared device code of the TD-MLP kernels: the Tsit5 constants, the
// weights, and the first port's row block (8 rows a CTA of 1,024 threads),
// whose arithmetic the Hopper kernels keep bitwise and which kernel 8's
// window replay still runs at 512 threads (sweep_cluster.cuh::TDMLPSweep).
//
// The dynamics is TDChain(Dense(F+1 -> H, tanh), Dense(H+1 -> F)):
//   y = tanh(x·W1 + b1 + s·w1t)·W2 + b2 + s·w2t
// with the weights in the JAX layout, (in, out) row-major, and the time
// channel as the LAST input row: W1 is rows 0..F-1 of the (F+1, H) weight and
// w1t its row F; W2 is rows 0..H-1 of the (H+1, F) weight and w2t its row H.
// No copy or padding of the weights is made.
//
// The first port's work split: one CTA of kThreads threads owned a block of
// kRows batch rows. The stage input of the block sat transposed in shared
// memory ([F][kRows], so one k reads the kRows values as two float4s), the
// hidden row tanh(x·W1 + ...) in shared memory ([H][kRows]); H is not
// padded, the loops run to H. The weights were read through the read-only
// path from L2 (0.63 MB at F = 784, H = 100). Every product is true FP32
// FFMA.
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
// What bounded it on an H100: the weight loads from L2 were latency-bound,
// and each CTA streamed the whole of W1 and W2 (0.63 MB) from L2 once per
// evaluation, at B = 512 on 64 CTAs (measured: one evaluation 35 µs, a
// Tsit5 step 0.22 ms). Kernels 1, 2 and 4 keep this arithmetic bit for bit
// on thread-block clusters instead (solve_cluster.cuh), each CTA with its
// residue slice of the weights resident in shared memory; the
// stored-adjoint kernels 3, 7 and 8 run on the clusters of
// sweep_cluster.cuh.
#pragma once

#include <cuda_runtime.h>

namespace lrnde {

constexpr int kThreads = 1024;  // threads per CTA of the first port
constexpr int kRows = 8;       // batch rows per CTA (row block, error block)

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

// The TD-MLP's weights, read in place.
struct TDMLP {
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
static_assert(kAcc2 == 4, "the accumulators are added as (0+1)+(2+3)");

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

// The sum block_sum<T> formed in a kernel of T threads over a block's n
// values v (row-major), each thread t holding the fmaf chain of v[i]² over
// i = t, t + T, ... in increasing i; emulated by the calling warp, lane l
// holding the chains of threads l + 32m (m < T / 32): the tree's levels s
// >= 32 in registers (e[m] += e[m + s / 32]), the last five as shuffles,
// so the same additions in the same order. The sum is in lane 0.
template <int T>
__device__ inline float warp_block_sum_sq(const float* v, int n, int lane) {
  constexpr int M = T / 32;
  static_assert(M >= 1 && (M & (M - 1)) == 0, "T a power of two, >= 32");
  float e[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    e[m] = 0.f;
    for (int i = lane + 32 * m; i < n; i += T) e[m] = fmaf(v[i], v[i], e[m]);
  }
#pragma unroll
  for (int h = M / 2; h > 0; h >>= 1)
#pragma unroll
    for (int m = 0; m < h; ++m) e[m] = e[m] + e[m + h];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    e[0] = e[0] + __shfl_down_sync(0xffffffffu, e[0], s);
  return e[0];
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

// n floats rounded up to a multiple of 4 (16 bytes), so that a buffer
// carved after them can take float4 reads and 16-byte copies.
__host__ __device__ inline size_t round_up4(size_t n) { return (n + 3) & ~size_t{3}; }

// A CTA's shared memory above the 48 KB default needs an opt-in per
// kernel: the limit holds the kernel's static shared memory and its dynamic
// bytes together, so a dynamic size just under 48 KB beside a static
// control block needs the opt-in too. *granted remembers the largest
// dynamic size made launchable, so the calls (tens of microseconds of host
// time) are made once, not at every launch.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* granted) {
  if (bytes <= *granted) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (bytes + attr.sharedSizeBytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  *granted = bytes;
  return cudaSuccess;
}

}  // namespace lrnde
