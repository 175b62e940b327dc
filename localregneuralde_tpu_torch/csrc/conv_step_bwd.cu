// Kernel 14: the VJP of one Tsit5 step of the CIFAR conv dynamics in
// training mode (batch-statistics BatchNorm).
//
// Replaces localregneuralde_tpu/ops/pallas/fused_conv_bwd.py::_make_bwd_kernel
// (called at fused_conv_bwd.py:308 through fused_conv_step_bwd). As there:
// recompute the step's six evaluations, then walk them in reverse, per
// evaluation conv3^T -> BN2/gelu' -> conv2^T -> BN1/gelu' -> conv1^T, and
// carry the stage-chain cotangents as kernel 3 does (tsit5_bwd.cuh). The
// TPU recomputed each evaluation's activations a second time right before
// its transpose to fit VMEM; here the forward pass keeps every evaluation's
// stage input, pre-BN conv outputs and activations in global scratch
// (24 x 8 MB at the CIFAR shapes), so the step is recomputed once.
//
// Per evaluation and conv, with dy the output cotangent, on the conv GEMM
// core (conv_core.cuh):
// - dgrad: the forward GEMM over dy with the weight's taps flipped and its
//   channel axes swapped, copied once per call (transpose_w);
// - wgrad: dW[tap, ci, co] = sum_p src[p + d_tap, ci] dy[p, co] over the
//   pixels whose source lies in the image, the time channel (ci = Cin, value
//   s) included, so the gradient comes out in the HWIO layout; src is the
//   plain activation gelu(BN(z)), written once per evaluation by the
//   forward (bn_act) and kept, 12 x M x Ch floats (96 MB at the CIFAR
//   shapes) beside the 12 pre-BN outputs the BatchNorm backward needs. Each
//   block owns a (K tile, N tile, pixel split) and adds its sums into its own
//   partial slot; the six evaluations accumulate there, and one pass sums the
//   splits in order at the end;
// - BatchNorm backward on the batch statistics: with dg = da * gelu'(g),
//   dgamma += sum dg*xhat, dbeta += sum dg, dz = inv * (gamma dg -
//   gamma sum(dg)/N - xhat gamma sum(dg*xhat)/N); the sums are two-level
//   and reduced in block order.
// Cotangents for t and dt are not produced (the controller fence makes them
// zero). No float atomics: the gradients are the same from run to run.
//
// The recompute is kernel 13's forward (conv.cuh::forward_step), so the
// VJP is of exactly the function kernel 13 computes: its BatchNorm
// statistics from the convs' tile moments, its stage inputs from conv3's
// epilogue, its thin data gradient (conv1^T, N = 8) on the halo tile.
//
// Bound: the products, about three forward steps' worth (the recompute, the
// data and the weight gradients): ~54 GFLOP, 0.8 ms at 67 TFLOP/s FP32.
#include "conv.cuh"

namespace lrnde {
namespace conv {

// ---------------------------------------------------------------------------
// BatchNorm backward on batch statistics

constexpr int kBwdLanes = 32;                // row lanes of the reduction
constexpr int kBwdThreads = kBwdLanes * 32;  // x 32 channel lanes

// S1[c] = sum dg, S2[c] = sum dg * xhat over the M rows, with
// xhat = (z - mean) / sqrt(var + eps), g = xhat gamma + beta and
// dg = da * gelu'(g). Per-block sums go to part[block][2][C]; the last block
// sums them in block order into sums (2, C) and adds S2 to dgamma, S1 to
// dbeta.

static __global__ void __launch_bounds__(kBwdThreads)
bn_bwd_reduce_kernel(const float* __restrict__ da, const float* __restrict__ z,
                     const float* __restrict__ mean, const float* __restrict__ var,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     float eps, int M, int C, float* part, unsigned* ticket,
                     float* __restrict__ sums, float* __restrict__ dgamma,
                     float* __restrict__ dbeta) {
  __shared__ float red1[kBwdLanes][32], red2[kBwdLanes][32];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, rl = tid >> 5;
  const int r0 = blockIdx.x * kStatRows, r1 = min(r0 + kStatRows, M);
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float a1 = 0.f, a2 = 0.f;
    if (c < C) {
      const float mu = mean[c], inv = rsqrtf(var[c] + eps), g = gamma[c], b = beta[c];
      for (int r = r0 + rl; r < r1; r += kBwdLanes) {
        const size_t o = static_cast<size_t>(r) * C + c;
        const float xh = (z[o] - mu) * inv;
        const float dg = da[o] * gelu_tanh_grad(xh * g + b);
        a1 += dg;
        a2 = fmaf(dg, xh, a2);
      }
    }
    red1[rl][lane] = a1;
    red2[rl][lane] = a2;
    __syncthreads();
    if (rl == 0 && c < C) {
      float s1 = red1[0][lane], s2 = red2[0][lane];
      for (int i = 1; i < kBwdLanes; ++i) {
        s1 += red1[i][lane];
        s2 += red2[i][lane];
      }
      part[(static_cast<size_t>(blockIdx.x) * 2) * C + c] = s1;
      part[(static_cast<size_t>(blockIdx.x) * 2 + 1) * C + c] = s2;
    }
    __syncthreads();
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = tid; c < C; c += kBwdThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b) {
      s1 += __ldcg(part + (static_cast<size_t>(b) * 2) * C + c);
      s2 += __ldcg(part + (static_cast<size_t>(b) * 2 + 1) * C + c);
    }
    sums[c] = s1;
    sums[C + c] = s2;
    dbeta[c] += s1;
    dgamma[c] += s2;
  }
}

// dz = inv * (dxh - sum(dxh)/N - xhat * sum(dxh * xhat)/N), dxh = gamma dg
static __global__ void bn_bwd_apply_kernel(
    const float* __restrict__ da, const float* __restrict__ z,
    const float* __restrict__ mean, const float* __restrict__ var,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ sums, float eps, int M, int C,
    float* __restrict__ dz) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(M) * C) return;
  const int c = static_cast<int>(i % C);
  const float inv = rsqrtf(var[c] + eps), g = gamma[c];
  const float xh = (z[i] - mean[c]) * inv;
  const float dxh = da[i] * gelu_tanh_grad(xh * g + beta[c]) * g;
  const float inv_n = 1.f / static_cast<float>(M);
  dz[i] = inv * (dxh - inv_n * (g * sums[c]) - xh * (inv_n * (g * sums[C + c])));
}

// ---------------------------------------------------------------------------
// Stage-chain cotangents (elementwise over the M*Cs state)

struct KMut {
  float* k[7];
};

// dks[0] = dt bt1 du~; dks[j] = dt bt_{j+1} du~ + d_k_{j+1} (j = 1..6)
static __global__ void seed_kernel(const float* __restrict__ d_ut, KPtrs dk_in,
                                   const float* __restrict__ sc, KMut dks,
                                   size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float bt[7] = {BT1, BT2, BT3, BT4, BT5, BT6, BT7};
  const float dt = sc[1], ut = d_ut[i];
  dks.k[0][i] = (dt * bt[0]) * ut;
  for (int j = 1; j < 7; ++j) dks.k[j][i] = (dt * bt[j]) * ut + dk_in.k[j][i];
}

// The cotangent of evaluation e's stage input, dx (+ d_unew at e = 5, + d_g6
// at e = 4), flows to u and to the k_j it was built from.
static __global__ void stage_bwd_kernel(const float* __restrict__ dx,
                                        const float* __restrict__ d_unew,
                                        const float* __restrict__ d_g6,
                                        const float* __restrict__ sc, int e,
                                        float* __restrict__ du, KMut dks,
                                        size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float d = dx[i];
  if (e == 5) d = d + d_unew[i];
  if (e == 4) d = d + d_g6[i];
  du[i] = e == 5 ? d : du[i] + d;
  const float dt = sc[1];
  for (int j = 0; j <= e; ++j) dks.k[j][i] = dks.k[j][i] + (dt * kA[e][j]) * d;
}

struct BwdLayout {
  float *ks, *dks, *x, *z1, *z2, *act, *tmap, *stats, *part, *sums, *da, *dz, *dx;
  float *wt1, *wt2, *wt3, *wp1, *wp2, *wp3;
  unsigned* tickets;
  size_t total;
};

static inline BwdLayout bwd_layout(float* base, int B, int H, int W, int Cs, int Ch) {
  const size_t M = static_cast<size_t>(B) * H * W, HW = static_cast<size_t>(H) * W;
  const int m = static_cast<int>(M);
  BwdLayout l{};
  size_t o = 0;
  auto take = [&](size_t n) {
    float* q = base == nullptr ? nullptr : base + o;
    o += round_up4(n);
    return q;
  };
  l.ks = take(6 * M * Cs);
  l.dks = take(6 * M * Cs);
  l.x = take(6 * M * Cs);
  l.z1 = take(6 * M * Ch);
  l.z2 = take(6 * M * Ch);
  l.act = take(12 * M * Ch);  // act1, act2 of each evaluation
  l.tmap = take(HW * (2 * Ch + Cs));
  l.stats = take(24 * static_cast<size_t>(Ch));
  // the forward's statistics slots, later the BatchNorm backward's partials
  static_assert(kStatTile <= kStatRows, "the partials fit the slots");
  l.part = take(stat_slot_floats(m, Ch));
  l.sums = take(2 * static_cast<size_t>(Ch));
  l.da = take(M * Ch);
  l.dz = take(M * Ch);
  l.dx = take(M * Cs);
  l.wt1 = take(9 * static_cast<size_t>(Ch) * Cs);
  l.wt2 = take(9 * static_cast<size_t>(Ch) * Ch);
  l.wt3 = take(9 * static_cast<size_t>(Cs) * Ch);
  // the partial slots, contiguous (one memset zeroes them)
  const size_t n1 = static_cast<size_t>(wgrad_splits(m, Cs, Ch)) * 9 * (Cs + 1) * Ch;
  const size_t n2 = static_cast<size_t>(wgrad_splits(m, Ch, Ch)) * 9 * (Ch + 1) * Ch;
  const size_t n3 = static_cast<size_t>(wgrad_splits(m, Ch, Cs)) * 9 * (Ch + 1) * Cs;
  l.wp1 = take(n1 + n2 + n3);
  l.wp2 = l.wp1 == nullptr ? nullptr : l.wp1 + n1;
  l.wp3 = l.wp2 == nullptr ? nullptr : l.wp2 + n2;
  l.tickets = reinterpret_cast<unsigned*>(take(kTickets));
  l.total = o;
  return l;
}

}  // namespace conv
}  // namespace lrnde

extern "C" long long lrnde_conv_step_bwd_scratch_floats(int B, int H, int W,
                                                        int Cs, int Ch) {
  return static_cast<long long>(
      lrnde::conv::bwd_layout(nullptr, B, H, W, Cs, Ch).total);
}

// VJP of one training-mode Tsit5 step from (u, t) with step dt and FSAL
// derivative k1 (NHWC (B, H, W, Cs)); sc = (t, dt) on the device. The nine
// cotangents are those of (u_new, u~, k2..k7, g6). Writes d_u, d_k1, the
// HWIO weight gradients d_w1 (3, 3, Cs+1, Ch), d_w2 (3, 3, Ch+1, Ch),
// d_w3 (3, 3, Ch+1, Cs) and the BatchNorm affine gradients. Returns the
// first CUDA error.
extern "C" int lrnde_conv_step_bwd(
    const float* u, const float* k1, const float* sc, const float* w1,
    const float* g1, const float* b1, const float* w2, const float* g2,
    const float* b2, const float* w3, const float* d_unew,
    const float* d_utilde, const float* d_k2, const float* d_k3,
    const float* d_k4, const float* d_k5, const float* d_k6,
    const float* d_k7, const float* d_g6, float* d_u, float* d_k1,
    float* d_w1, float* d_g1, float* d_b1, float* d_w2, float* d_g2,
    float* d_b2, float* d_w3, float* scratch, float eps, int B, int H, int W,
    int Cs, int Ch, void* stream) {
  using namespace lrnde;
  using namespace lrnde::conv;
  if (Cs > kMaxC || Ch > kMaxC) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * H * W;
  const size_t n = static_cast<size_t>(M) * Cs;
  const BwdLayout l = bwd_layout(scratch, B, H, W, Cs, Ch);
  const int S1 = wgrad_splits(M, Cs, Ch), S2 = wgrad_splits(M, Ch, Ch);
  const int S3 = wgrad_splits(M, Ch, Cs);
  const size_t nw1 = 9 * static_cast<size_t>(Cs + 1) * Ch;
  const size_t nw2 = 9 * static_cast<size_t>(Ch + 1) * Ch;
  const size_t nw3 = 9 * static_cast<size_t>(Ch + 1) * Cs;
  cudaError_t err;
  // zero the tickets, the weight-gradient partials (contiguous) and the
  // BatchNorm affine accumulators
  const size_t n_part = S1 * nw1 + S2 * nw2 + S3 * nw3;
  if ((err = cudaMemsetAsync(l.tickets, 0, kTickets * sizeof(unsigned), st)) != cudaSuccess ||
      (err = cudaMemsetAsync(l.wp1, 0, n_part * sizeof(float), st)) != cudaSuccess)
    return err;
  float* affine[4] = {d_g1, d_b1, d_g2, d_b2};
  for (float* q : affine)
    if ((err = cudaMemsetAsync(q, 0, Ch * sizeof(float), st)) != cudaSuccess) return err;

  // ---- the forward, keeping every evaluation's stage input and conv outputs
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
  for (int j = 0; j < 6; ++j) a.k[j] = l.ks + j * n;
  a.x = l.x;
  a.x_stride = n;
  a.z1 = l.z1;
  a.z2 = l.z2;
  a.z_stride = static_cast<size_t>(M) * Ch;
  a.act = l.act;
  a.act_stride = static_cast<size_t>(M) * Ch;
  a.act_eval_stride = 2 * a.act_stride;
  a.tmap = l.tmap;
  a.stats = l.stats;
  a.part = l.part;
  a.tickets = l.tickets;
  a.mode = kTrain;
  a.eps = eps;
  a.B = B;
  a.H = H;
  a.W = W;
  a.Cs = Cs;
  a.Ch = Ch;
  if ((err = forward_step(a, st)) != cudaSuccess) return err;
  // the data gradients' weights: taps flipped, channel axes swapped
  if ((err = transpose_w(w1, Cs + 1, Ch, l.wt1, st)) != cudaSuccess ||
      (err = transpose_w(w2, Ch + 1, Ch, l.wt2, st)) != cudaSuccess ||
      (err = transpose_w(w3, Ch + 1, Cs, l.wt3, st)) != cudaSuccess)
    return err;

  // ---- stage cotangent seeds
  KPtrs dk_in;
  dk_in.k[0] = nullptr;
  const float* dks_in[6] = {d_k2, d_k3, d_k4, d_k5, d_k6, d_k7};
  for (int j = 0; j < 6; ++j) dk_in.k[j + 1] = dks_in[j];
  KMut dks;
  dks.k[0] = d_k1;
  for (int j = 0; j < 6; ++j) dks.k[j + 1] = l.dks + j * n;
  seed_kernel<<<cdiv(n, kEw), kEw, 0, st>>>(d_utilde, dk_in, sc, dks, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int nstat = cdiv(M, kStatRows);
  const size_t MCh = static_cast<size_t>(M) * Ch;
  for (int e = 5; e >= 0; --e) {
    const float c = stage_c(e);
    const float* se = l.stats + static_cast<size_t>(e) * 4 * Ch;
    const float *m1 = se, *v1 = se + Ch, *m2 = se + 2 * Ch, *v2 = se + 3 * Ch;
    const float* x = l.x + e * n;
    const float* z1 = l.z1 + e * MCh;
    const float* z2 = l.z2 + e * MCh;
    const float* dk = dks.k[e + 1];
    unsigned* tk = l.tickets + kFwdTickets + 2 * (5 - e);

    const float* act1 = l.act + 2 * e * MCh;  // gelu(BN1(z1)), kept by the forward
    const float* act2 = act1 + MCh;           // gelu(BN2(z2))

    // conv3^T
    WgradArgs wg3{act2, Ch, sc, c, dk, Cs, l.wp3, cdiv(M, S3), B, H, W};
    if ((err = launch_wgrad(wg3, S3, st)) != cudaSuccess) return err;
    ConvArgs dg3{dk, Cs, l.wt3, Cs, Ch, nullptr, sc, c, l.da, B, H, W};
    if ((err = launch_conv(dg3, st)) != cudaSuccess) return err;
    // BN2 / gelu'
    bn_bwd_reduce_kernel<<<nstat, kBwdThreads, 0, st>>>(
        l.da, z2, m2, v2, g2, b2, eps, M, Ch, l.part, tk, l.sums, d_g2, d_b2);
    bn_bwd_apply_kernel<<<cdiv(MCh, kEw), kEw, 0, st>>>(
        l.da, z2, m2, v2, g2, b2, l.sums, eps, M, Ch, l.dz);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // conv2^T
    WgradArgs wg2{act1, Ch, sc, c, l.dz, Ch, l.wp2, cdiv(M, S2), B, H, W};
    if ((err = launch_wgrad(wg2, S2, st)) != cudaSuccess) return err;
    ConvArgs dg2{l.dz, Ch, l.wt2, Ch, Ch, nullptr, sc, c, l.da, B, H, W};
    if ((err = launch_conv(dg2, st)) != cudaSuccess) return err;
    // BN1 / gelu'
    bn_bwd_reduce_kernel<<<nstat, kBwdThreads, 0, st>>>(
        l.da, z1, m1, v1, g1, b1, eps, M, Ch, l.part, tk + 1, l.sums, d_g1, d_b1);
    bn_bwd_apply_kernel<<<cdiv(MCh, kEw), kEw, 0, st>>>(
        l.da, z1, m1, v1, g1, b1, l.sums, eps, M, Ch, l.dz);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // conv1^T
    WgradArgs wg1{x, Cs, sc, c, l.dz, Ch, l.wp1, cdiv(M, S1), B, H, W};
    if ((err = launch_wgrad(wg1, S1, st)) != cudaSuccess) return err;
    ConvArgs dg1{l.dz, Ch, l.wt1, Ch, Cs, nullptr, sc, c, l.dx, B, H, W};
    if ((err = launch_conv(dg1, st)) != cudaSuccess) return err;
    stage_bwd_kernel<<<cdiv(n, kEw), kEw, 0, st>>>(l.dx, d_unew, d_g6, sc, e,
                                                   d_u, dks, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = reduce_partials(l.wp1, S1, nw1, d_w1, st)) != cudaSuccess) return err;
  if ((err = reduce_partials(l.wp2, S2, nw2, d_w2, st)) != cudaSuccess) return err;
  return reduce_partials(l.wp3, S3, nw3, d_w3, st);
}

// ---------------------------------------------------------------------------
// The conv GEMM core alone, one orientation at a time, for timing each
// against cuDNN (chip_smoke.py; on no model path). orient 0, the forward:
// out (M, cout) = conv3x3(x (M, cin), w (3, 3, cin, cout)); 1, the data
// gradient: x is the cotangent (M, cin), w the layer's HWIO weight
// (3, 3, cout + 1, cin) with its time channel, out (M, cout) the gradient of
// the first cout input channels; 2, the weight gradient: x is the layer's
// input (M, cin), w the output cotangent (M, cout), out (3, 3, cin + 1,
// cout) with the time channel at the value sc[0]; 3 and 4, orientations 0
// and 1 on the N = 8 gather tile where a thin conv would take the halo
// tile (its outputs must be bitwise the halo tile's); 5, the forward with
// the BatchNorm statistics epilogue (the tickets' memset included), the
// statistics (mean, var) at scratch; 6 and 7, the same without the final
// fold, and without the groups' fold either (timing probes). scratch holds
// lrnde_conv_core_scratch_floats floats.
extern "C" long long lrnde_conv_core_scratch_floats(int orient, int B, int H,
                                                    int W, int cin, int cout) {
  using namespace lrnde::conv;
  if (orient == 1 || orient == 4) return 9LL * cin * cout;  // the transposed weight
  if (orient >= 5)  // the statistics, the tickets, the slots
    return 2LL * cout + kStatTickets + stat_slot_floats(B * H * W, cout);
  if (orient != 2) return 1;
  return static_cast<long long>(wgrad_splits(B * H * W, cin, cout)) * 9 *
         (cin + 1) * cout;
}

extern "C" int lrnde_conv_core(int orient, const float* x, const float* w,
                               const float* sc, float* out, float* scratch,
                               int B, int H, int W, int cin, int cout,
                               void* stream) {
  using namespace lrnde;
  using namespace lrnde::conv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool gather = orient == 3 || orient == 4;
  if (gather) orient -= 3;
  cudaError_t err;
  if (orient >= 5 && orient <= 7) {
    ConvArgs a{x, cin, w, cin, cout, nullptr, sc, 0.f, out, B, H, W};
    a.epi.probe_levels = orient - 5;
    a.epi.stats = scratch;
    a.epi.ticket = reinterpret_cast<unsigned*>(scratch + 2 * cout);
    a.epi.part = scratch + 2 * cout + kStatTickets;
    if ((err = cudaMemsetAsync(a.epi.ticket, 0, kStatTickets * sizeof(unsigned), st)) !=
        cudaSuccess)
      return err;
    return launch_conv(a, st);
  }
  if (orient == 0) {
    const ConvArgs a{x, cin, w, cin, cout, nullptr, sc, 0.f, out, B, H, W};
    return launch_conv(a, st, gather);
  }
  if (orient == 1) {
    if ((err = transpose_w(w, cout + 1, cin, scratch, st)) != cudaSuccess) return err;
    const ConvArgs a{x, cin, scratch, cin, cout, nullptr, sc, 0.f, out, B, H, W};
    return launch_conv(a, st, gather);
  }
  if (orient != 2) return cudaErrorInvalidValue;
  const int M = B * H * W, S = wgrad_splits(M, cin, cout);
  const size_t nw = 9 * static_cast<size_t>(cin + 1) * cout;
  if ((err = cudaMemsetAsync(scratch, 0, S * nw * sizeof(float), st)) != cudaSuccess)
    return err;
  const WgradArgs a{x, cin, sc, 0.f, w, cout, scratch, cdiv(M, S), B, H, W};
  if ((err = launch_wgrad(a, S, st)) != cudaSuccess) return err;
  return reduce_partials(scratch, S, nw, out, st);
}
