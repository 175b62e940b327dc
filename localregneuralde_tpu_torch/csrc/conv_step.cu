// Kernel 13: one whole Tsit5 step of the CIFAR conv dynamics (six
// evaluations of conv -> BN -> gelu -> conv -> BN -> gelu -> conv, the stage
// sums, u~ and, in training, the BatchNorm running-stat EMA chain).
//
// Replaces localregneuralde_tpu/ops/pallas/fused_conv.py::_make_step_kernel
// (called at fused_conv.py:349 through conv_step_apply and
// make_fused_conv_step). The TPU ran the step as one program in VMEM; on the
// H100 it is a fixed sequence of this file's launches behind one C call
// (conv.cuh::forward_step): per evaluation the stage input, three
// implicit-GEMM convolutions and, for batch statistics, two deterministic
// reduction passes per BatchNorm. A persistent kernel with grid barriers
// would save the ~8 launch gaps per evaluation but holds every SM for the
// whole step, and its tiles would have to fit the worst of three GEMM
// shapes; separate launches let each GEMM pick its tile (Cout 64 or 8), and
// the gaps are a few microseconds against a step of about a millisecond.
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

// The forward scratch: x, z1, z2, the activation, the time maps, the
// statistics, their partials, then the tickets, each 16-byte aligned.
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
  l.act = take(M * Ch);
  l.tmap = take(HW * (2 * Ch + Cs));
  l.stats = take(24 * static_cast<size_t>(Ch));
  l.part = take(static_cast<size_t>(cdiv(M, kStatRows)) * Ch);
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
  a.act_stride = 0;
  a.tmap = l.tmap;
  a.stats = l.stats;
  a.part = l.part;
  a.tickets = l.tickets;
  cudaError_t err = cudaMemsetAsync(a.tickets, 0, kTickets * sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
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
