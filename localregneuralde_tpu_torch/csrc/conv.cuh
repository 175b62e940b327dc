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
//   from nine (roll, mask, matmul) taps. Here a conv is one implicit GEMM
//   over NHWC (conv_core.cuh): forward, data gradient and weight gradient
//   in tap-major K, with cp.async stages and register micro-tiles.
// - The time channel is concat-free: conv(concat(x, s)) = conv(x, W[:, :, :C])
//   + s * tmap with tmap[h, w, :] the sum of the time taps that fall inside
//   the image at (h, w), computed once per call (time_map_kernel).
// - BatchNorm-apply plus gelu(tanh) of a layer is written once per
//   evaluation into a plain activation buffer (bn_act_kernel), which the next
//   conv gathers (zero padding stays zero: it pads the activation); in eval
//   with the running stats the conv's epilogue writes it instead of z.
// - Batch statistics come from the conv's epilogue: each 128-pixel tile's
//   per-channel sum and M2 in a fixed slot, folded in tile order by the last
//   CTA to finish (an integer ticket) into the mean and the variance
//   (conv_core.cuh::tile_stats). No float atomics, so a step is bitwise
//   repeatable. The reference's are two passes (mean, then the mean of
//   squared deviations); the tile moments are as accurate (chip_smoke.py's
//   [conv stats fp64] holds them against float64).
// - The stage algebra rides on the convs: evaluation e's last conv writes
//   k_{e+2} and, from it, the next evaluation's input (g6, u_new, and after
//   the sixth ũ); only the first input has a launch of its own.
// - Every product is FP32 FFMA; TF32, wgmma and TMA are later work.
//
// What bounds it on an H100: the products. One dynamics evaluation at
// B = 32, 32x32, Cs 8, Ch 64 is 2*32768*(72*64 + 576*64 + 576*8) = 3.02 GFLOP
// and moves ~30 MB (the activations stay in the 50 MB L2), so the step's
// 18 GFLOP bound it at ~0.27 ms at 67 TFLOP/s.
#pragma once

#include "conv_core.cuh"
#include "tsit5_bwd.cuh"

namespace lrnde {
namespace conv {

constexpr int kMaxC = 256;         // the most channels the kernels take
constexpr int kStatRows = 256;     // rows per block of the BatchNorm backward
constexpr int kStatTile = 128;     // rows of a statistics tile (the N = 64 tile's)
constexpr int kEw = 256;           // threads of the elementwise kernels
// ticket counters carved from the scratch: the forward's statistics (12
// convs), then kernel 14's BatchNorm backward
constexpr int kFwdTickets = 12 * kStatTickets;
constexpr int kTickets = kFwdTickets + 16;

// Floats of the statistics' slots at M pixels and C channels: a tile's
// moments each, then a group's.
inline size_t stat_slot_floats(int M, int C) {
  return static_cast<size_t>(cdiv(M, kStatTile) + kStatGroups) * 2 * C;
}

// d gelu / dx of the tanh form (fused_conv_bwd.py::_gelu_grad)
__device__ inline float gelu_tanh_grad(float x) {
  const float th = tanhf(kGeluA * (x + kGeluB * x * x * x));
  const float d_inner = kGeluA * (1.f + 3.f * kGeluB * x * x);
  return 0.5f * (1.f + th) + 0.5f * x * (1.f - th * th) * d_inner;
}

// Stage times of the six evaluations: s_e = t + c_e * dt
__host__ __device__ inline float stage_c(int e) {
  return e == 0 ? C1 : e == 1 ? C2 : e == 2 ? C3 : e == 3 ? C4 : 1.f;
}

// The three layers' time maps, one after the other in tmap:
// tmap_l[h, w, co] = sum over the taps inside the image at (h, w) of the
// time channel's weight W_l[dy, dx, w_cin - 1, co]
struct TimeMaps {
  const float* w[3];
  int w_cin[3], cout[3];
};

static __global__ void time_map_kernel(TimeMaps m, int H, int W,
                                       float* __restrict__ tmap) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int HW = H * W;
  int l = 0;
  while (l < 3 && idx >= HW * m.cout[l]) idx -= HW * m.cout[l++];
  if (l == 3) return;
  const int cout = m.cout[l], w_cin = m.w_cin[l];
  const float* w = m.w[l];
  const int hw = idx / cout, co = idx - hw * cout;
  const int h = hw / W, x = hw - h * W;
  float s = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const int hs = h + tap / 3 - 1, ws = x + tap % 3 - 1;
    if (hs >= 0 && hs < H && ws >= 0 && ws < W)
      s += w[(static_cast<size_t>(tap) * w_cin + (w_cin - 1)) * cout + co];
  }
  tmap[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// act = gelu(BN(z)) of one layer, elementwise over (M, C), written once
// per evaluation for the next conv to gather (and the weight gradient).
static __global__ void bn_act_kernel(const float* __restrict__ z,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ var,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta, float eps,
                                     size_t n, int C, float* __restrict__ act) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = static_cast<int>(i % C);
  act[i] = bn_gelu(z[i], mean[c], rsqrtf(var[c] + eps), gamma[c], beta[c]);
}

static inline cudaError_t bn_act(const float* z, const float* mean,
                                 const float* var, const float* gamma,
                                 const float* beta, float eps, int M, int C,
                                 float* act, cudaStream_t st) {
  const size_t n = static_cast<size_t>(M) * C;
  bn_act_kernel<<<cdiv(n, kEw), kEw, 0, st>>>(z, mean, var, gamma, beta, eps, n, C, act);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Stage algebra (elementwise over the M*Cs state)

struct KPtrs {
  const float* k[7];  // k1..k7
};

// x = u + dt * a_00 k1, the first evaluation's input (the others come from
// the convs' epilogue, conv_core.cuh::conv_store)
static __global__ void stage_kernel(const float* __restrict__ u,
                                    const float* __restrict__ k1,
                                    const float* __restrict__ sc,
                                    float* __restrict__ x, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float k = k1[i];
  const float kv[7] = {k, k, k, k, k, k, k};
  x[i] = stage_input(0, u[i], kv, sc[1]);
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
  float* act;                // gelu(BN(z)) of layer 1, then 2, of evaluation e
  size_t act_stride;         //   at act + e * act_eval_stride + layer * act_stride
  size_t act_eval_stride;    //   (two buffers at least: a layer's conv in eval
                             //   writes its activation while its input's is read)
  float* tmap;               // H*W*(2 Ch + Cs)
  float* stats;              // 6 x (mean1, var1, mean2, var2) x Ch
  float* part;               // statistics slots: stat_slot_floats(M, Ch)
  unsigned* tickets;         // kFwdTickets, zero (modes 0 and 2)
  int mode;
  const float* rstats;       // (4, Ch): running stats (eval) or EMA seeds
  float* rstats_out;         // (4, Ch) EMA chain (training), may be null
  float mom, omm, eps;
  int B, H, W, Cs, Ch;
};

static inline cudaError_t time_maps(const StepArgs& a, cudaStream_t st) {
  const TimeMaps m{{a.w1, a.w2, a.w3}, {a.Cs + 1, a.Ch + 1, a.Ch + 1},
                   {a.Ch, a.Ch, a.Cs}};
  const long long n = static_cast<long long>(a.H) * a.W * (2 * a.Ch + a.Cs);
  time_map_kernel<<<cdiv(n, kEw), kEw, 0, st>>>(m, a.H, a.W, a.tmap);
  return cudaGetLastError();
}

static inline const float* tmap_of(const StepArgs& a, int layer) {
  const size_t HW = static_cast<size_t>(a.H) * a.W;
  return a.tmap + (layer == 0 ? 0 : layer == 1 ? HW * a.Ch : 2 * HW * a.Ch);
}

// Layer `layer` (0, 1) of evaluation e: with batch statistics the conv
// writes z and the statistics of the evaluation's slot se (mean, var), and
// bn_act writes the activation; with the running stats the conv writes the
// activation. After the sixth evaluation's second statistics the EMA chain
// (training with rstats_out).
static inline cudaError_t conv_bn_layer(const StepArgs& a, int e, int layer,
                                        const float* in, cudaStream_t st) {
  const int M = a.B * a.H * a.W, Ch = a.Ch;
  const bool batch = a.mode != kEvalRunning;
  const int cin = layer == 0 ? a.Cs : Ch;
  float* z = (layer == 0 ? a.z1 : a.z2) + e * a.z_stride;
  float* act = a.act + e * a.act_eval_stride + layer * a.act_stride;
  const float* gamma = layer == 0 ? a.g1 : a.g2;
  const float* beta = layer == 0 ? a.b1 : a.b2;
  float* se = a.stats + static_cast<size_t>(e) * 4 * Ch + 2 * layer * Ch;
  ConvArgs c{in, cin, layer == 0 ? a.w1 : a.w2, cin + 1, Ch, tmap_of(a, layer),
             a.sc, stage_c(e), batch ? z : act, a.B, a.H, a.W};
  if (batch) {
    c.epi.part = a.part;
    c.epi.ticket = a.tickets + (2 * e + layer) * kStatTickets;
    c.epi.stats = se;
    if (e == 5 && layer == 1 && a.mode == kTrain && a.rstats_out != nullptr) {
      c.epi.ema_stats = a.stats;
      c.epi.ema_in = a.rstats;
      c.epi.ema_out = a.rstats_out;
      c.epi.mom = a.mom;
      c.epi.omm = a.omm;
    }
  } else {
    c.epi.bn_mean = a.rstats + 2 * layer * Ch;
    c.epi.bn_var = a.rstats + (2 * layer + 1) * Ch;
    c.epi.gamma = gamma;
    c.epi.beta = beta;
    c.epi.eps = a.eps;
  }
  cudaError_t err = launch_conv(c, st);
  if (err != cudaSuccess || !batch) return err;
  return bn_act(z, se, se + Ch, gamma, beta, a.eps, M, Ch, act, st);
}

static inline cudaError_t forward_step(const StepArgs& a, cudaStream_t st) {
  const int M = a.B * a.H * a.W;
  const size_t n = static_cast<size_t>(M) * a.Cs;
  cudaError_t err = time_maps(a, st);
  if (err != cudaSuccess) return err;
  stage_kernel<<<cdiv(n, kEw), kEw, 0, st>>>(a.u, a.k1, a.sc, a.x, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int e = 0; e < 6; ++e) {
    const float* x = a.x + e * a.x_stride;
    float* act1 = a.act + e * a.act_eval_stride;
    if ((err = conv_bn_layer(a, e, 0, x, st)) != cudaSuccess ||
        (err = conv_bn_layer(a, e, 1, act1, st)) != cudaSuccess)
      return err;
    // conv3 writes k_{e+2} and, from it, the next input (or u~ after the
    // sixth evaluation)
    ConvArgs c3{act1 + a.act_stride, a.Ch, a.w3, a.Ch + 1, a.Cs, tmap_of(a, 2),
                a.sc, stage_c(e), a.k[e], a.B, a.H, a.W};
    ConvEpilogue& ep = c3.epi;
    ep.stage = e < 5 || a.utilde != nullptr ? e + 1 : 0;
    ep.u = a.u;
    ep.k[0] = a.k1;
    for (int j = 0; j < 6; ++j) ep.k[j + 1] = a.k[j];
    ep.x = e < 5 ? a.x + (e + 1) * a.x_stride : nullptr;
    ep.g6 = a.g6;
    ep.unew = a.unew;
    ep.utilde = a.utilde;
    if ((err = launch_conv(c3, st)) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace conv
}  // namespace lrnde
