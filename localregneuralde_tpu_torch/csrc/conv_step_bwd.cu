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
// stage input and pre-BN conv outputs in global scratch (12 x 8 MB at the
// CIFAR shapes), so the step is recomputed once.
//
// Per evaluation and conv, with dy the output cotangent:
// - dgrad: conv3x3_kernel over dy with the taps flipped and the weight's
//   channel axes swapped (read in place);
// - wgrad: dW[tap, ci, co] = sum_p src[p + d_tap, ci] dy[p, co] over the
//   pixels whose source lies in the image, the time channel (ci = Cin, value
//   s) included, so the gradient comes out in the HWIO layout. Each block
//   owns a (K tile, N tile, pixel split) and adds its sums into its own
//   partial slot; the six evaluations accumulate there, and one pass sums the
//   splits in order at the end;
// - BatchNorm backward on the batch statistics: with dg = da * gelu'(g),
//   dgamma += sum dg*xhat, dbeta += sum dg, dz = inv * (gamma dg -
//   gamma sum(dg)/N - xhat gamma sum(dg*xhat)/N); the sums are two-level
//   and reduced in block order.
// Cotangents for t and dt are not produced (the controller fence makes them
// zero). No float atomics: the gradients are the same from run to run.
//
// Bound: the products, about three forward steps' worth (the recompute, the
// data and the weight gradients): ~54 GFLOP, 0.8 ms at 67 TFLOP/s FP32.
#include "conv.cuh"

namespace lrnde {
namespace conv {

// ---------------------------------------------------------------------------
// Weight gradient

struct WgradArgs {
  const float* src;  // the conv's input (M, cin); the time channel is added
  int cin;
  BnIn bn;           // gelu(BN(.)) of src as it is loaded, or the identity
  const float* sc;
  float c;           // s = t + c * dt, the time channel's value
  const float* dy;   // (M, cout)
  int cout;
  float* part;       // [split][9 (cin + 1)][cout], accumulated
  int rows_per_split;
  int B, H, W;
};

template <int BKO, int BNO, int TK, int TN, int BMS>
static __global__ void __launch_bounds__((BKO / TK) * (BNO / TN))
wgrad_kernel(WgradArgs a) {
  constexpr int NT = (BKO / TK) * (BNO / TN);
  constexpr int NA = BMS * BKO / NT;
  static_assert(NT % BKO == 0 && (BMS * BKO) % NT == 0, "A-tile mapping");
  __shared__ float As[BMS][BKO];
  __shared__ float Bs[BMS][BNO];
  __shared__ float bnm[kMaxC], bni[kMaxC], bng[kMaxC], bnb[kMaxC];
  const int tid = threadIdx.x;
  const int H = a.H, W = a.W, HW = H * W, M = a.B * HW;
  const int cin = a.cin, cin1 = cin + 1, K = 9 * cin1;
  const int k0 = blockIdx.x * BKO, n0 = blockIdx.y * BNO;
  const int p_begin = blockIdx.z * a.rows_per_split;
  const int p_end = min(M, p_begin + a.rows_per_split);
  const bool bn = a.bn.mean != nullptr;
  if (bn) {
    for (int c = tid; c < cin; c += NT) {
      bnm[c] = a.bn.mean[c];
      bni[c] = rsqrtf(a.bn.var[c] + a.bn.eps);
      bng[c] = a.bn.gamma[c];
      bnb[c] = a.bn.beta[c];
    }
  }
  const float s = a.sc[0] + a.c * a.sc[1];
  // this thread's A column: a fixed (tap, input channel)
  const int kk_a = tid % BKO, k = k0 + kk_a;
  const int tap = k / cin1, ci = k - tap * cin1;
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  float acc[TK][TN];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int tn = tid % (BNO / TN), tk = tid / (BNO / TN);
  __syncthreads();

  for (int p0 = p_begin; p0 < p_end; p0 += BMS) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int m = tid / BKO + i * (NT / BKO);
      const int p = p0 + m;
      float v = 0.f;
      if (k < K && p < p_end) {
        const int r = p % HW, h = r / W, x = r - (r / W) * W;
        const int hs = h + dy, ws = x + dx;
        if (hs >= 0 && hs < H && ws >= 0 && ws < W) {
          if (ci == cin) {
            v = s;
          } else {
            v = a.src[static_cast<size_t>(p + dy * W + dx) * cin + ci];
            if (bn) v = gelu_tanh(((v - bnm[ci]) * bni[ci]) * bng[ci] + bnb[ci]);
          }
        }
      }
      As[m][kk_a] = v;
    }
    for (int e = tid; e < BMS * BNO; e += NT) {
      const int m = e / BNO, n = e - m * BNO;
      const int p = p0 + m, co = n0 + n;
      Bs[m][n] = (p < p_end && co < a.cout) ? a.dy[static_cast<size_t>(p) * a.cout + co] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < BMS; ++m) {
      float av[TK], bv[TN];
#pragma unroll
      for (int i = 0; i < TK; ++i) av[i] = As[m][tk * TK + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[m][tn * TN + j];
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* part = a.part + static_cast<size_t>(blockIdx.z) * K * a.cout;
#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int kr = k0 + tk * TK + i;
    if (kr >= K) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tn * TN + j;
      if (co < a.cout) part[static_cast<size_t>(kr) * a.cout + co] += acc[i][j];
    }
  }
}

static inline cudaError_t launch_wgrad(const WgradArgs& a, int splits, cudaStream_t st) {
  const int K = 9 * (a.cin + 1);
  if (a.cin > kMaxC) return cudaErrorInvalidValue;
  if (a.cout <= 8) {
    const dim3 grid(cdiv(K, 256), cdiv(a.cout, 8), splits);
    wgrad_kernel<256, 8, 4, 2, 16><<<grid, 256, 0, st>>>(a);
  } else {
    const dim3 grid(cdiv(K, 64), cdiv(a.cout, 64), splits);
    wgrad_kernel<64, 64, 4, 4, 16><<<grid, 256, 0, st>>>(a);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// BatchNorm backward on batch statistics

// S1[c] = sum dg, S2[c] = sum dg * xhat over the M rows, with
// xhat = (z - mean) / sqrt(var + eps), g = xhat gamma + beta and
// dg = da * gelu'(g). Per-block sums go to part[block][2][C]; the last block
// sums them in block order into sums (2, C) and adds S2 to dgamma, S1 to
// dbeta.
static __global__ void __launch_bounds__(kStatThreads)
bn_bwd_reduce_kernel(const float* __restrict__ da, const float* __restrict__ z,
                     const float* __restrict__ mean, const float* __restrict__ var,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     float eps, int M, int C, float* part, unsigned* ticket,
                     float* __restrict__ sums, float* __restrict__ dgamma,
                     float* __restrict__ dbeta) {
  __shared__ float red1[8][32], red2[8][32];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, rl = tid >> 5;
  const int r0 = blockIdx.x * kStatRows, r1 = min(r0 + kStatRows, M);
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float a1 = 0.f, a2 = 0.f;
    if (c < C) {
      const float mu = mean[c], inv = rsqrtf(var[c] + eps), g = gamma[c], b = beta[c];
      for (int r = r0 + rl; r < r1; r += 8) {
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
      for (int i = 1; i < 8; ++i) {
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
  for (int c = tid; c < C; c += kStatThreads) {
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
  float *ks, *dks, *x, *z1, *z2, *tmap, *stats, *part, *sums, *da, *dz, *dx;
  float *wp1, *wp2, *wp3;
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
    o += n;
    return q;
  };
  l.ks = take(6 * M * Cs);
  l.dks = take(6 * M * Cs);
  l.x = take(6 * M * Cs);
  l.z1 = take(6 * M * Ch);
  l.z2 = take(6 * M * Ch);
  l.tmap = take(HW * (2 * Ch + Cs));
  l.stats = take(24 * static_cast<size_t>(Ch));
  l.part = take(static_cast<size_t>(cdiv(M, kStatRows)) * 2 * Ch);
  l.sums = take(2 * static_cast<size_t>(Ch));
  l.da = take(M * Ch);
  l.dz = take(M * Ch);
  l.dx = take(M * Cs);
  l.wp1 = take(static_cast<size_t>(wgrad_splits(m, Cs, Ch)) * 9 * (Cs + 1) * Ch);
  l.wp2 = take(static_cast<size_t>(wgrad_splits(m, Ch, Ch)) * 9 * (Ch + 1) * Ch);
  l.wp3 = take(static_cast<size_t>(wgrad_splits(m, Ch, Cs)) * 9 * (Ch + 1) * Cs);
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
    const BnIn bn1{se, se + Ch, g1, b1, eps};
    const BnIn bn2{se + 2 * Ch, se + 3 * Ch, g2, b2, eps};
    const BnIn none{nullptr, nullptr, nullptr, nullptr, 0.f};
    const float* x = l.x + e * n;
    const float* z1 = l.z1 + e * MCh;
    const float* z2 = l.z2 + e * MCh;
    const float* dk = dks.k[e + 1];
    unsigned* tk = l.tickets + 24 + 2 * (5 - e);

    // conv3^T
    WgradArgs wg3{z2, Ch, bn2, sc, c, dk, Cs, l.wp3, cdiv(M, S3), B, H, W};
    if ((err = launch_wgrad(wg3, S3, st)) != cudaSuccess) return err;
    ConvArgs dg3{dk, Cs, w3, Ch + 1, Cs, 1, Ch, nullptr, sc, c, none, l.da, B, H, W};
    if ((err = launch_conv(dg3, st)) != cudaSuccess) return err;
    // BN2 / gelu'
    bn_bwd_reduce_kernel<<<nstat, kStatThreads, 0, st>>>(
        l.da, z2, bn2.mean, bn2.var, g2, b2, eps, M, Ch, l.part, tk, l.sums,
        d_g2, d_b2);
    bn_bwd_apply_kernel<<<cdiv(MCh, kEw), kEw, 0, st>>>(
        l.da, z2, bn2.mean, bn2.var, g2, b2, l.sums, eps, M, Ch, l.dz);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // conv2^T
    WgradArgs wg2{z1, Ch, bn1, sc, c, l.dz, Ch, l.wp2, cdiv(M, S2), B, H, W};
    if ((err = launch_wgrad(wg2, S2, st)) != cudaSuccess) return err;
    ConvArgs dg2{l.dz, Ch, w2, Ch + 1, Ch, 1, Ch, nullptr, sc, c, none, l.da, B, H, W};
    if ((err = launch_conv(dg2, st)) != cudaSuccess) return err;
    // BN1 / gelu'
    bn_bwd_reduce_kernel<<<nstat, kStatThreads, 0, st>>>(
        l.da, z1, bn1.mean, bn1.var, g1, b1, eps, M, Ch, l.part, tk + 1,
        l.sums, d_g1, d_b1);
    bn_bwd_apply_kernel<<<cdiv(MCh, kEw), kEw, 0, st>>>(
        l.da, z1, bn1.mean, bn1.var, g1, b1, l.sums, eps, M, Ch, l.dz);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // conv1^T
    WgradArgs wg1{x, Cs, none, sc, c, l.dz, Ch, l.wp1, cdiv(M, S1), B, H, W};
    if ((err = launch_wgrad(wg1, S1, st)) != cudaSuccess) return err;
    ConvArgs dg1{l.dz, Ch, w1, Cs + 1, Ch, 1, Cs, nullptr, sc, c, none, l.dx, B, H, W};
    if ((err = launch_conv(dg1, st)) != cudaSuccess) return err;
    stage_bwd_kernel<<<cdiv(n, kEw), kEw, 0, st>>>(l.dx, d_unew, d_g6, sc, e,
                                                   d_u, dks, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = reduce_partials(l.wp1, S1, nw1, d_w1, st)) != cudaSuccess) return err;
  if ((err = reduce_partials(l.wp2, S2, nw2, d_w2, st)) != cudaSuccess) return err;
  return reduce_partials(l.wp3, S3, nw3, d_w3, st);
}
