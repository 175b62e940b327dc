// Kernel 13: one whole Tsit5 step of the CIFAR conv dynamics (six
// evaluations of conv -> BN -> gelu -> conv -> BN -> gelu -> conv, the stage
// sums, u~ and, in training, the BatchNorm running-stat EMA chain).
//
// Replaces localregneuralde_tpu/ops/pallas/fused_conv.py::_make_step_kernel
// (called at fused_conv.py:349 through conv_step_apply and
// make_fused_conv_step). The TPU ran the step as one program in VMEM; on the
// H100 it is a fixed sequence of this file's launches behind one C call
// (conv.cuh::forward_step): the time maps and the first stage input, then
// per evaluation three implicit-GEMM convolutions and, with batch
// statistics, two BatchNorm-apply passes. The first port (its sequence,
// 65 launches a training call) also had two reduction passes per BatchNorm
// and a launch per stage input; measured on an H100 (PERF.md §6) those, the
// launch gaps and the thin conv3's gather took 0.57 of its 1.31 ms. Now the
// statistics come from conv1's and conv2's epilogue (per-tile moments
// folded by the last CTA), conv3's epilogue writes the next stage input
// (and u~), conv3 runs on the halo tile, and in eval with the running
// stats conv1 and conv2 write the activation themselves: 32 launches a
// training call, 20 in eval with the running stats. A persistent kernel
// with grid barriers would save the remaining gaps but hold every SM for the
// whole step, and its tiles would have to fit the worst of three GEMM
// shapes.
//
// Modes: 0 training (batch statistics, EMA chain of the running stats into
// rstats_out), 1 eval with the running stats, 2 eval with batch statistics
// (BatchNorm eval_stats='batch'; running stats untouched).
//
// Bound: the products, 18.1 GFLOP per step at B = 32, 32x32, Cs 8, Ch 64
// (0.27 ms at 67 TFLOP/s FP32); see conv.cuh.
#include "conv.cuh"

namespace lrnde {
namespace conv {

// The forward scratch: x, z1, z2, the two activations, the time maps, the
// statistics, their tiles' slots, then the tickets, each 16-byte aligned.
struct FwdLayout {
  float *x, *z1, *z2, *act, *tmap, *stats, *part;
  unsigned* tickets;
  size_t total;
};

static inline FwdLayout fwd_layout(float* base, int B, int H, int W, int Cs, int Ch) {
  const size_t M = static_cast<size_t>(B) * H * W, HW = static_cast<size_t>(H) * W;
  FwdLayout l{};
  size_t o = 0;
  auto take = [&](size_t n) {
    float* q = base == nullptr ? nullptr : base + o;
    o += round_up4(n);
    return q;
  };
  l.x = take(M * Cs);
  l.z1 = take(M * Ch);
  l.z2 = take(M * Ch);
  l.act = take(2 * M * Ch);  // act1, act2
  l.tmap = take(HW * (2 * Ch + Cs));
  l.stats = take(24 * static_cast<size_t>(Ch));
  l.part = take(stat_slot_floats(static_cast<int>(M), Ch));
  l.tickets = reinterpret_cast<unsigned*>(take(kTickets));
  l.total = o;
  return l;
}

}  // namespace conv
}  // namespace lrnde

extern "C" long long lrnde_conv_step_scratch_floats(int B, int H, int W, int Cs,
                                                    int Ch) {
  return static_cast<long long>(
      lrnde::conv::fwd_layout(nullptr, B, H, W, Cs, Ch).total);
}

// Where a buffer of the forward scratch starts, in floats: which = 0 the
// last evaluation's z1, 1 its z2, 2 the statistics (6 x (mean1, var1,
// mean2, var2) x Ch). For holding the statistics against z (chip_smoke.py).
extern "C" long long lrnde_conv_step_offset(int which, int B, int H, int W,
                                            int Cs, int Ch) {
  using namespace lrnde::conv;
  float* const base = reinterpret_cast<float*>(alignof(float4));  // not null
  const FwdLayout l = fwd_layout(base, B, H, W, Cs, Ch);
  const float* q = which == 0 ? l.z1 : which == 1 ? l.z2 : l.stats;
  return static_cast<long long>(q - base);
}

// One Tsit5 step from (u, t) with step dt and FSAL derivative k1, NHWC
// (B, H, W, Cs); sc = (t, dt) on the device. Writes u_new, u~, k2..k7 and g6;
// in training mode the EMA chain of rstats (4, Ch: mean1, var1, mean2, var2)
// into rstats_out. Returns the first CUDA error.
extern "C" int lrnde_conv_step(
    const float* u, const float* k1, const float* sc, const float* w1,
    const float* g1, const float* b1, const float* w2, const float* g2,
    const float* b2, const float* w3, float* unew, float* utilde, float* k2,
    float* k3, float* k4, float* k5, float* k6, float* k7, float* g6,
    const float* rstats, float* rstats_out, float* scratch, int mode,
    float mom, float omm, float eps, int B, int H, int W, int Cs, int Ch,
    void* stream) {
  using namespace lrnde::conv;
  if (Cs > kMaxC || Ch > kMaxC || mode < 0 || mode > 2) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FwdLayout l = fwd_layout(scratch, B, H, W, Cs, Ch);
  StepArgs a{};
  a.u = u;
  a.k1 = k1;
  a.sc = sc;
  a.w1 = w1;
  a.g1 = g1;
  a.b1 = b1;
  a.w2 = w2;
  a.g2 = g2;
  a.b2 = b2;
  a.w3 = w3;
  float* ks[6] = {k2, k3, k4, k5, k6, k7};
  for (int j = 0; j < 6; ++j) a.k[j] = ks[j];
  a.unew = unew;
  a.utilde = utilde;
  a.g6 = g6;
  a.x = l.x;
  a.x_stride = 0;
  a.z1 = l.z1;
  a.z2 = l.z2;
  a.z_stride = 0;
  a.act = l.act;
  a.act_stride = static_cast<size_t>(B) * H * W * Ch;
  a.act_eval_stride = 0;
  a.tmap = l.tmap;
  a.stats = l.stats;
  a.part = l.part;
  a.tickets = l.tickets;
  if (mode != kEvalRunning) {  // the statistics' tickets
    const cudaError_t err =
        cudaMemsetAsync(a.tickets, 0, kTickets * sizeof(unsigned), st);
    if (err != cudaSuccess) return err;
  }
  a.mode = mode;
  a.rstats = rstats;
  a.rstats_out = rstats_out;
  a.mom = mom;
  a.omm = omm;
  a.eps = eps;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cs = Cs;
  a.Ch = Ch;
  return forward_step(a, st);
}
