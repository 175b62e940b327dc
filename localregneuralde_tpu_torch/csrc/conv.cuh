// Shared device code of the conv-family kernels (kernels 13 and 14): the
// 3x3 SAME convolution as an implicit GEMM, the BatchNorm statistics and
// their backward, the Tsit5 stage algebra around them, and the host-side
// launch sequence of one Tsit5 step of the CIFAR dynamics
//
//   TDChain(Chain(Conv3x3 Cs+1 -> Ch, BN(Ch, gelu)),
//           Chain(Conv3x3 Ch+1 -> Ch, BN(Ch, gelu)),
//           Conv3x3 Ch+1 -> Cs)
//
// in NHWC, with the HWIO weights (3, 3, Cin+1, Cout) read in place (the last
// input channel is the time channel). Replaces the conv evaluation of
// localregneuralde_tpu/ops/pallas/fused_conv.py::_make_step_kernel and its
// transpose in fused_conv_bwd.py::_make_bwd_kernel.
//
// Design, against the TPU kernel:
// - The TPU kept (C, B*H*W) channels-first for VMEM lanes and built each conv
//   from nine (roll, mask, matmul) taps. Here a conv is one implicit GEMM:
//   M = B*H*W output pixels, K = 9*Cin (tap-major, then input channel, the
//   contiguous axis of NHWC), N = Cout. A CTA owns a BM x BN output tile; the
//   A tile is gathered from the shifted pixels with the border mask computed
//   from the pixel index (zero outside the image), the B tile from the HWIO
//   weight. The data gradient is the same GEMM over the output cotangent with
//   the taps flipped and the weight's channel axes swapped (read in place).
// - The time channel is concat-free: conv(concat(x, s)) = conv(x, W[:, :, :C])
//   + s * tmap with tmap[h, w, :] the sum of the time taps that fall inside
//   the image at (h, w), computed once per call (time_map_kernel).
// - BatchNorm-apply plus gelu(tanh) of the previous layer is applied to the A
//   tile as it is loaded (zero padding stays zero: it pads the activation).
// - Batch statistics are two passes, as the reference's (mean, then the mean
//   of squared deviations). Each pass writes per-block partials into fixed
//   slots; the last block to finish (an integer ticket) sums them in block
//   order. No float atomics, so a step is bitwise repeatable.
// - Every product is FP32 FFMA from shared-memory tiles; TF32, wgmma and TMA
//   are later work.
//
// What bounds it on an H100: the products. One dynamics evaluation at
// B = 32, 32x32, Cs 8, Ch 64 is 2*32768*(72*64 + 576*64 + 576*8) = 3.02 GFLOP
// and moves ~30 MB (the activations stay in the 50 MB L2), so the step's
// 18 GFLOP bound it at ~0.27 ms at 67 TFLOP/s; a plain FFMA tile GEMM reaches
// a fraction of that.
#pragma once

#include "tsit5_bwd.cuh"

namespace lrnde {
namespace conv {

constexpr int kMaxC = 256;        // channels a BatchNorm transform holds
constexpr int kStatThreads = 256;  // 8 row lanes x 32 channel lanes
constexpr int kStatRows = 256;     // rows per block of a statistics pass
constexpr int kEw = 256;           // threads of the elementwise kernels
constexpr int kTickets = 64;       // ticket counters carved from the scratch
constexpr int kWgradBlocks = 264;  // weight-gradient blocks to aim for (2 per SM)
constexpr int kSplitRows = 256;    // fewest pixels of a weight-gradient split

constexpr float kGeluA = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluB = 0.044715f;

__device__ inline float gelu_tanh(float x) {
  return 0.5f * x * (1.f + tanhf(kGeluA * (x + kGeluB * x * x * x)));
}

// d gelu / dx of the tanh form (fused_conv_bwd.py::_gelu_grad)
__device__ inline float gelu_tanh_grad(float x) {
  const float th = tanhf(kGeluA * (x + kGeluB * x * x * x));
  const float d_inner = kGeluA * (1.f + 3.f * kGeluB * x * x);
  return 0.5f * (1.f + th) + 0.5f * x * (1.f - th * th) * d_inner;
}

// gelu(BN(.)) of one channel: mean == nullptr means the identity
struct BnIn {
  const float* mean;
  const float* var;
  const float* gamma;
  const float* beta;
  float eps;
};

// Stage times of the six evaluations: s_e = t + c_e * dt
__host__ __device__ inline float stage_c(int e) {
  return e == 0 ? C1 : e == 1 ? C2 : e == 2 ? C3 : e == 3 ? C4 : 1.f;
}

static inline int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// Output tiles of a weight gradient (9 (cin + 1) x cout): 256 x 8 for a thin
// output, else 64 x 64 (launch_wgrad).
static inline int wgrad_tiles(int cin, int cout) {
  const int K = 9 * (cin + 1);
  return cout <= 8 ? cdiv(K, 256) * cdiv(cout, 8) : cdiv(K, 64) * cdiv(cout, 64);
}

// Splits of the pixel axis for a weight gradient: enough blocks to fill the
// card, each over at least kSplitRows pixels.
static inline int wgrad_splits(int M, int cin, int cout) {
  const int want = cdiv(kWgradBlocks, wgrad_tiles(cin, cout));
  const int cap = M / kSplitRows < 1 ? 1 : M / kSplitRows;
  return want < cap ? want : cap;
}

// ---------------------------------------------------------------------------
// The convolution as an implicit GEMM

struct ConvArgs {
  const float* in;    // (M, cin), NHWC
  int cin;
  const float* w;     // HWIO (3, 3, w_cin, w_cout)
  int w_cin, w_cout;
  int dgrad;          // 0: out = conv(in, W[:, :, :cin, :]); 1: the data
                      //    gradient, in = the cotangent (cin = w_cout),
                      //    cout = w_cin - 1, taps flipped, channels swapped
  int cout;
  const float* tmap;  // (H*W, cout), added as s * tmap; may be null
  const float* sc;    // (t, dt) on the device
  float c;            // s = t + c * dt
  BnIn bn;            // transform of the input as it is loaded
  float* out;         // (M, cout)
  int B, H, W;
};

template <int BM, int BN, int TM, int TN, int BK>
static __global__ void __launch_bounds__((BM / TM) * (BN / TN))
conv3x3_kernel(ConvArgs a) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int NA = BM * BK / NT;  // A elements a thread loads per chunk
  static_assert(NT % BK == 0 && (BM * BK) % NT == 0, "A-tile mapping");
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];
  __shared__ float bnm[kMaxC], bni[kMaxC], bng[kMaxC], bnb[kMaxC];
  const int tid = threadIdx.x;
  const int H = a.H, W = a.W, HW = H * W, M = a.B * HW;
  const int cin = a.cin, K = 9 * cin;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool bn = a.bn.mean != nullptr;
  if (bn) {
    for (int c = tid; c < cin; c += NT) {
      bnm[c] = a.bn.mean[c];
      bni[c] = rsqrtf(a.bn.var[c] + a.bn.eps);
      bng[c] = a.bn.gamma[c];
      bnb[c] = a.bn.beta[c];
    }
  }
  // this thread's A-tile column (fixed) and pixels (fixed across chunks)
  const int kk_a = tid % BK;
  int pix[NA], hw_h[NA], hw_w[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int p = m0 + tid / BK + i * (NT / BK);
    pix[i] = p < M ? p : -1;
    const int r = p % HW;
    hw_h[i] = r / W;
    hw_w[i] = r - (r / W) * W;
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // A: shifted input pixels, masked at the border
      const int k = k0 + kk_a;
      const int tap = k / cin, ci = k - tap * cin;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        float v = 0.f;
        const int hs = hw_h[i] + dy, ws = hw_w[i] + dx;
        if (k < K && pix[i] >= 0 && hs >= 0 && hs < H && ws >= 0 && ws < W) {
          v = a.in[static_cast<size_t>(pix[i] + dy * W + dx) * cin + ci];
          if (bn) v = gelu_tanh(((v - bnm[ci]) * bni[ci]) * bng[ci] + bnb[ci]);
        }
        As[kk_a][tid / BK + i * (NT / BK)] = v;
      }
    }
    // B: the weight, read in place
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN, n = e - kk * BN;
      const int k = k0 + kk, co = n0 + n;
      float v = 0.f;
      if (k < K && co < a.cout) {
        const int tap = k / cin, ci = k - tap * cin;
        v = a.dgrad == 0
                ? a.w[(static_cast<size_t>(tap) * a.w_cin + ci) * a.w_cout + co]
                : a.w[(static_cast<size_t>(8 - tap) * a.w_cin + co) * a.w_cout + ci];
      }
      Bs[kk][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float s = a.sc[0] + a.c * a.sc[1];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = m0 + ty * TM + i;
    if (p >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tx * TN + j;
      if (co >= a.cout) continue;
      float v = acc[i][j];
      if (a.tmap != nullptr) v = v + s * a.tmap[static_cast<size_t>(p % HW) * a.cout + co];
      a.out[static_cast<size_t>(p) * a.cout + co] = v;
    }
  }
}

static inline cudaError_t launch_conv(const ConvArgs& a, cudaStream_t st) {
  const int M = a.B * a.H * a.W;
  if (a.cin > kMaxC) return cudaErrorInvalidValue;
  if (a.cout <= 8) {
    const dim3 grid(cdiv(M, 128), cdiv(a.cout, 8));
    conv3x3_kernel<128, 8, 4, 2, 16><<<grid, 128, 0, st>>>(a);
  } else {
    const dim3 grid(cdiv(M, 128), cdiv(a.cout, 64));
    conv3x3_kernel<128, 64, 8, 4, 16><<<grid, 256, 0, st>>>(a);
  }
  return cudaGetLastError();
}

// tmap[h, w, co] = sum over the taps inside the image at (h, w) of the time
// channel's weight W[dy, dx, w_cin - 1, co]
static __global__ void time_map_kernel(const float* __restrict__ w, int w_cin,
                                       int cout, int H, int W,
                                       float* __restrict__ tmap) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * W * cout) return;
  const int hw = idx / cout, co = idx - hw * cout;
  const int h = hw / W, x = hw - h * W;
  float s = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const int hs = h + tap / 3 - 1, ws = x + tap % 3 - 1;
    if (hs >= 0 && hs < H && ws >= 0 && ws < W)
      s += w[(static_cast<size_t>(tap) * w_cin + (w_cin - 1)) * cout + co];
  }
  tmap[idx] = s;
}

// ---------------------------------------------------------------------------
// BatchNorm statistics: deterministic two-level per-channel sums

// One pass over z (M, C): with mean == nullptr out[c] = mean of column c,
// else out[c] = mean of (z - mean[c])^2. Per-block sums go to part[block][c];
// the last block to take a ticket sums them in block order.
static __global__ void __launch_bounds__(kStatThreads)
bn_stats_kernel(const float* __restrict__ z, int M, int C,
                const float* __restrict__ mean, float* part,
                unsigned* ticket, float* __restrict__ out) {
  __shared__ float red[8][32];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, rl = tid >> 5;
  const int r0 = blockIdx.x * kStatRows, r1 = min(r0 + kStatRows, M);
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.f;
    if (c < C) {
      const float mu = mean != nullptr ? mean[c] : 0.f;
      for (int r = r0 + rl; r < r1; r += 8) {
        const float v = z[static_cast<size_t>(r) * C + c];
        if (mean != nullptr) {
          const float d = v - mu;
          acc = fmaf(d, d, acc);
        } else {
          acc += v;
        }
      }
    }
    red[rl][lane] = acc;
    __syncthreads();
    if (rl == 0 && c < C) {
      float s = red[0][lane];
      for (int i = 1; i < 8; ++i) s += red[i][lane];
      part[static_cast<size_t>(blockIdx.x) * C + c] = s;
    }
    __syncthreads();
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = tid; c < C; c += kStatThreads) {
    float s = 0.f;
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b)
      s += __ldcg(part + static_cast<size_t>(b) * C + c);
    out[c] = s / static_cast<float>(M);
  }
}

static inline cudaError_t launch_bn_stats(const float* z, int M, int C,
                                   const float* mean, float* part,
                                   unsigned* ticket, float* out,
                                   cudaStream_t st) {
  bn_stats_kernel<<<cdiv(M, kStatRows), kStatThreads, 0, st>>>(
      z, M, C, mean, part, ticket, out);
  return cudaGetLastError();
}

// The running-stat EMA chain of one step, in evaluation order:
// r = (1 - m) r + m stat_e for e = 0..5. stats holds per evaluation
// (mean1, var1, mean2, var2), each C; rin/rout are (4, C) in that order.
static __global__ void bn_ema_kernel(const float* __restrict__ stats,
                                     const float* __restrict__ rin,
                                     float* __restrict__ rout, int C,
                                     float mom, float omm) {
  for (int idx = threadIdx.x; idx < 4 * C; idx += blockDim.x) {
    float r = rin[idx];
    for (int e = 0; e < 6; ++e) r = omm * r + mom * stats[e * 4 * C + idx];
    rout[idx] = r;
  }
}

// ---------------------------------------------------------------------------
// Stage algebra (elementwise over the M*Cs state)

struct KPtrs {
  const float* k[7];  // k1..k7
};

// x = u + dt * sum_{j <= e} a_ej k_j, written to x (and g6 at e = 4, u_new at
// e = 5 when given)
static __global__ void stage_kernel(const float* __restrict__ u, KPtrs ks,
                                    const float* __restrict__ sc, int e,
                                    float* __restrict__ x, float* g6,
                                    float* unew, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float dt = sc[1];
  float acc = kA[e][0] * ks.k[0][i];
  for (int j = 1; j <= e; ++j) acc = acc + kA[e][j] * ks.k[j][i];
  const float v = u[i] + dt * acc;
  x[i] = v;
  if (e == 4 && g6 != nullptr) g6[i] = v;
  if (e == 5 && unew != nullptr) unew[i] = v;
}

// u~ = dt * sum_j btilde_j k_j
static __global__ void utilde_kernel(KPtrs ks, const float* __restrict__ sc,
                                     float* __restrict__ ut, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float acc = BT1 * ks.k[0][i] + BT2 * ks.k[1][i] + BT3 * ks.k[2][i] +
                    BT4 * ks.k[3][i] + BT5 * ks.k[4][i] + BT6 * ks.k[5][i] +
                    BT7 * ks.k[6][i];
  ut[i] = sc[1] * acc;
}

// ---------------------------------------------------------------------------
// One forward Tsit5 step: the launch sequence

enum Mode { kTrain = 0, kEvalRunning = 1, kEvalBatch = 2 };

struct StepArgs {
  const float* u;
  const float* k1;
  const float* sc;           // (t, dt)
  const float* w1;           // (3, 3, Cs+1, Ch)
  const float* g1;
  const float* b1;
  const float* w2;           // (3, 3, Ch+1, Ch)
  const float* g2;
  const float* b2;
  const float* w3;           // (3, 3, Ch+1, Cs)
  float* k[6];               // k2..k7
  float* unew;               // may be null
  float* utilde;             // may be null
  float* g6;                 // may be null
  float* x;                  // stage inputs, stride x_stride per evaluation
  size_t x_stride;
  float* z1;                 // pre-BN conv outputs, stride z_stride
  float* z2;
  size_t z_stride;
  float* tmap;               // H*W*(2 Ch + Cs)
  float* stats;              // 6 x (mean1, var1, mean2, var2) x Ch
  float* part;               // statistics partials: cdiv(M, kStatRows) x Ch
  unsigned* tickets;         // 24, zero
  int mode;
  const float* rstats;       // (4, Ch): running stats (eval) or EMA seeds
  float* rstats_out;         // (4, Ch) EMA chain (training), may be null
  float mom, omm, eps;
  int B, H, W, Cs, Ch;
};

static inline cudaError_t time_maps(const StepArgs& a, cudaStream_t st) {
  const int HW = a.H * a.W;
  const float* ws[3] = {a.w1, a.w2, a.w3};
  const int wcin[3] = {a.Cs + 1, a.Ch + 1, a.Ch + 1};
  const int cout[3] = {a.Ch, a.Ch, a.Cs};
  float* t = a.tmap;
  for (int l = 0; l < 3; ++l) {
    time_map_kernel<<<cdiv(static_cast<long long>(HW) * cout[l], kEw), kEw, 0, st>>>(
        ws[l], wcin[l], cout[l], a.H, a.W, t);
    t += static_cast<size_t>(HW) * cout[l];
  }
  return cudaGetLastError();
}

static inline const float* tmap_of(const StepArgs& a, int layer) {
  const size_t HW = static_cast<size_t>(a.H) * a.W;
  return a.tmap + (layer == 0 ? 0 : layer == 1 ? HW * a.Ch : 2 * HW * a.Ch);
}

// The batch statistics of z (M, Ch) into mean/var, or nothing in eval mode
// with running stats.
static inline cudaError_t batch_stats(const StepArgs& a, const float* z, float* mean,
                               float* var, unsigned* tickets,
                               cudaStream_t st) {
  const int M = a.B * a.H * a.W;
  cudaError_t err = launch_bn_stats(z, M, a.Ch, nullptr, a.part, tickets, mean, st);
  if (err != cudaSuccess) return err;
  return launch_bn_stats(z, M, a.Ch, mean, a.part, tickets + 1, var, st);
}

static inline cudaError_t forward_step(const StepArgs& a, cudaStream_t st) {
  const int M = a.B * a.H * a.W;
  const size_t n = static_cast<size_t>(M) * a.Cs;
  const int Ch = a.Ch;
  cudaError_t err = time_maps(a, st);
  if (err != cudaSuccess) return err;
  KPtrs ks;
  ks.k[0] = a.k1;
  for (int j = 0; j < 6; ++j) ks.k[j + 1] = a.k[j];
  for (int e = 0; e < 6; ++e) {
    float* x = a.x + e * a.x_stride;
    float* z1 = a.z1 + e * a.z_stride;
    float* z2 = a.z2 + e * a.z_stride;
    float* se = a.stats + static_cast<size_t>(e) * 4 * Ch;
    const float c = stage_c(e);
    stage_kernel<<<cdiv(n, kEw), kEw, 0, st>>>(a.u, ks, a.sc, e, x, a.g6, a.unew, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;

    ConvArgs c1{x, a.Cs, a.w1, a.Cs + 1, Ch, 0, Ch, tmap_of(a, 0), a.sc, c,
                BnIn{nullptr, nullptr, nullptr, nullptr, 0.f}, z1, a.B, a.H, a.W};
    if ((err = launch_conv(c1, st)) != cudaSuccess) return err;
    const float *m1 = se, *v1 = se + Ch;
    if (a.mode == kEvalRunning) {
      m1 = a.rstats;
      v1 = a.rstats + Ch;
    } else if ((err = batch_stats(a, z1, se, se + Ch, a.tickets + 4 * e, st)) != cudaSuccess) {
      return err;
    }

    ConvArgs c2{z1, Ch, a.w2, Ch + 1, Ch, 0, Ch, tmap_of(a, 1), a.sc, c,
                BnIn{m1, v1, a.g1, a.b1, a.eps}, z2, a.B, a.H, a.W};
    if ((err = launch_conv(c2, st)) != cudaSuccess) return err;
    const float *m2 = se + 2 * Ch, *v2 = se + 3 * Ch;
    if (a.mode == kEvalRunning) {
      m2 = a.rstats + 2 * Ch;
      v2 = a.rstats + 3 * Ch;
    } else if ((err = batch_stats(a, z2, se + 2 * Ch, se + 3 * Ch,
                                  a.tickets + 4 * e + 2, st)) != cudaSuccess) {
      return err;
    }

    ConvArgs c3{z2, Ch, a.w3, Ch + 1, a.Cs, 0, a.Cs, tmap_of(a, 2), a.sc, c,
                BnIn{m2, v2, a.g2, a.b2, a.eps}, a.k[e], a.B, a.H, a.W};
    if ((err = launch_conv(c3, st)) != cudaSuccess) return err;
  }
  if (a.utilde != nullptr) {
    utilde_kernel<<<cdiv(n, kEw), kEw, 0, st>>>(ks, a.sc, a.utilde, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (a.mode == kTrain && a.rstats_out != nullptr) {
    bn_ema_kernel<<<1, 256, 0, st>>>(a.stats, a.rstats, a.rstats_out, Ch,
                                     a.mom, a.omm);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace conv
}  // namespace lrnde
