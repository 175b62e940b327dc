// Kernel 12: the whole stored-adjoint sweep of the NeuralDSDE family over
// the recorded steps, in one launch, plus the ordered sum of the weight-
// gradient partials.
//
// Replaces localregneuralde_tpu/ops/pallas/fused_sde_sweep.py::_make_kernel
// (built by _build_call, called from persistent_sde_sweep). On the TPU one
// core swept the whole batch step by step, streaming the knot triples in by
// DMA and accumulating the weight gradients in VMEM. Here the rows are
// independent in the backward (SRI has no FSAL chain, so the state
// cotangent a_u is the only carry) and only the weight gradients couple
// them: each CTA sweeps its own row blocks through all naccept steps in
// reverse (naccept is read on the device) with no grid barrier. Per step it
//
// 1. recomputes k1..k4 and g1..g4 from the knot (u_j, dW_j, dZ_j), keeping
//    the stage inputs and the hidden rows in shared memory (the recorded
//    increments make the transpose exact for the realised path);
// 2. splits the saveat cotangents linearly (y_s = u + θ(u_new − u));
// 3. seeds the stage cotangents from the u_new expression and reverses
//    through the H0/H1 stage structure (no eest branch: the error estimate
//    feeds only the fenced controller);
// 4. adds the stage-batched weight gradients (K = 4 stages × rows) to its
//    CTA's partial, which stays in shared memory for the whole sweep.
//
// A second kernel sums the partials in CTA order (tsit5_bwd.cuh), so the
// gradients are deterministic with no float atomics.
//
// What bounds it on an H100: latency. Per step a CTA runs eight small
// products forward, eight transposed and three weight-gradient contractions
// of K = 16; at B = 512 the 128 CTAs use one SM each, so each SM has only
// its CTA's work in flight. The first port ran it on 64 threads: every
// product's outputs came four or eight to a thread, one after the other,
// and the 5,248 gradient elements 82 to a thread (half the step's time).
// The Hopper design keeps the row blocks, the shared-memory layout and
// every sum (each output and each gradient element is still one thread's
// left-to-right sum, so a_u and the gradients keep their bits) and gives
// the CTA twelve warps: the H-wide outputs of a product run beside the
// independent diffusion outputs (8 + 4 warps), the drift outputs next, and
// the gradient elements fourteen to a thread, two at a time.
//
// The clocked instantiation (kTime) splits CTA 0's step by phase for
// chip_smoke.py's [sde sweep attribution]; its arithmetic is the same.
//
// The TF32 tier (the reference's 'default'): the stage recompute (kRecTf32,
// the reference's precision) and the eight transposed products and three
// weight-gradient contractions of a stage set (kGradTf32, its
// grad_precision, which NeuralDSDE leaves at the default tier whatever the
// forward's) each run on mma.sync m16n8k8 (sde.cuh): the weights' fragment
// copies staged once after the FP32 layout, one warp's chain an output
// tile, the weight-gradient tiles' two k-steps (4 stages × 4 rows) added to
// the same per-CTA partials, still summed in CTA order.
#include "sde.cuh"
#include "tsit5_bwd.cuh"

namespace lrnde {

struct SdeSweepArgs {
  SdeWeights w;
  const float* knot_ts;   // (>= naccept + 1)
  const float* knot_us;   // (>= naccept + 1, B, F)
  const float* knot_dws;  // (>= naccept, B, F)
  const float* knot_dzs;  // (>= naccept, B, F)
  const int* naccept;
  const float* saveat;    // (n_save)
  int n_save;
  const float* ct_ys;     // (n_save, B, F)
  const float* ct_y;      // (B, F)
  float* a_u;             // (B, F)
  float* part;            // (gridDim.x, sde_grad_floats)
  int B;
  unsigned long long* timing;  // kTime: (kSdeSwPhases + 1)
};

// The phases of a step (CTA 0, each closed by a CTA barrier): the
// recompute of the four stages, the saveat split with the seeding of the
// stage cotangents, the reverse through the stages, the weight-gradient
// contractions; then, once, the write of the CTA's partial.
enum SdeSweepPhase {
  kSdeRecompute, kSdeSaveat, kSdeReverse, kSdeWgrad, kSdePartial,
  kSdeSwPhases
};

// CTA 0's nanoseconds per phase (%globaltimer), read by thread 0 after a
// CTA barrier; a no-op unless kOn.
template <bool kOn>
struct SdeClock {
  unsigned long long acc[kOn ? kSdeSwPhases + 1 : 1];
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ void start() {
    if constexpr (kOn) {
      for (int i = 0; i < kSdeSwPhases; ++i) acc[i] = 0;
      acc[kSdeSwPhases] = now();
    }
  }
  __device__ void mark(int phase) {
    if constexpr (kOn) {
      __syncthreads();
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        const unsigned long long t = now();
        acc[phase] += t - acc[kSdeSwPhases];
        acc[kSdeSwPhases] = t;
      }
    }
  }
  __device__ void write(unsigned long long* out, int count) const {
    if constexpr (kOn) {
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        for (int i = 0; i < kSdeSwPhases; ++i) out[i] = acc[i];
        out[kSdeSwPhases] = static_cast<unsigned long long>(count);
      }
    }
  }
};

__host__ __device__ inline size_t sde_grad_floats(int F, int H) {
  return static_cast<size_t>(F) * H + H + static_cast<size_t>(H) * F + F
       + static_cast<size_t>(F) * F + F;
}

__host__ __device__ inline size_t sde_sweep_smem_floats(int F, int H) {
  const size_t RF = static_cast<size_t>(kSdeRows) * F;
  const size_t RH = static_cast<size_t>(kSdeRows) * H;
  return sde_weight_smem_floats(F, H) + sde_grad_floats(F, H)
       + 6 * RF            // u, dW, dZ, dxf, dxg, d_u
       + RF                // the saveat share of d_u
       + 6 * 4 * RF        // xf, xg, k, g, dk, dg per stage
       + 2 * 4 * RH;       // hidden rows and their cotangents per stage
}

// The tiers of kernel 12 (lrnde_sde_sweep's first argument): the stage
// recompute's products at TF32, the transposed and weight-gradient
// products at TF32 (fused_mlp_bwd.py::tier_bits' bits).
constexpr int kSdeTierRecompute = 1, kSdeTierGrad = 2;

// With a TF32 tier, its fragment copies (sde.cuh) follow the FP32 layout,
// 16-byte aligned: the forward's for the recompute, the transposed
// products' for the gradients.
__host__ __device__ inline size_t sde_sweep_smem_floats_at(int F, int H,
                                                           bool rec_tf32,
                                                           bool grad_tf32) {
  const size_t base = sde_sweep_smem_floats(F, H);
  if (!rec_tf32 && !grad_tf32) return base;
  return round_up4(base) + (rec_tf32 + grad_tf32) * sde_frag_set_floats(F, H);
}

// g[i] += Σ_{e < 4, r < nrows} A[e·SA + r·LA + i / ncol] · Bv[e·SB + r·LB +
// i % ncol] for the gradient elements i ≡ tid (mod kSdeThreads), i < n,
// summed in that order (the first port's); two elements at a time, so two
// independent chains are in flight.
__device__ __forceinline__ void grad_contract(const float* A, int SA, int LA,
                                     const float* Bv, int SB, int LB, int ncol,
                                     int n, int nrows, float* g) {
  for (int i = threadIdx.x; i < n; i += 2 * kSdeThreads) {
    const int i2 = i + kSdeThreads;
    const bool two = i2 < n;
    const int a1 = i / ncol, b1 = i - a1 * ncol;
    const int a2 = two ? i2 / ncol : a1, b2 = two ? i2 - a2 * ncol : b1;
    float acc1 = 0.f, acc2 = 0.f;
    for (int e = 0; e < 4; ++e)
      for (int r = 0; r < nrows; ++r) {
        const float* ar = A + e * SA + r * LA;
        const float* br = Bv + e * SB + r * LB;
        acc1 = fmaf(ar[a1], br[b1], acc1);
        acc2 = fmaf(ar[a2], br[b2], acc2);
      }
    g[i] += acc1;
    if (two) g[i2] += acc2;
  }
}

// grad_contract at the TF32 tier, for the M × N gradient elements g[m·N +
// n] (A M wide, Bv N wide): 16 × 8 tiles over all warps, the K = 4 stages ×
// kSdeRows rows of a step (k = e·kSdeRows + r, two k-steps) one mma.sync
// chain a tile on operands rounded as they are read (zero past nrows), its
// FP32 sum added to the partial once.
__device__ __forceinline__ void grad_contract_tf32(const float* A, int SA,
                                                   int LA, int M,
                                                   const float* Bv, int SB,
                                                   int LB, int N, int nrows,
                                                   float* g) {
  static_assert(kSdeRows == 4, "a k-step is two stages of four rows");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, q = lane & 3;
  const int Nt = (N + 7) / 8, tiles = frag_mtiles(M) * Nt;
  const bool live = q < nrows;
  for (int t = warp; t < tiles; t += kSdeThreads / 32) {
    const int mt = t / Nt, nt = t - mt * Nt;
    const int m0 = mt * 16 + gr, m1 = m0 + 8, n = nt * 8 + gr;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float* a0 = A + (2 * ks) * SA + q * LA;
      const float* a1 = a0 + SA;
      const float* b0 = Bv + (2 * ks) * SB + q * LB;
      const float* b1 = b0 + SB;
      const unsigned a[4] = {live && m0 < M ? tf32_bits(a0[m0]) : 0u,
                             live && m1 < M ? tf32_bits(a0[m1]) : 0u,
                             live && m0 < M ? tf32_bits(a1[m0]) : 0u,
                             live && m1 < M ? tf32_bits(a1[m1]) : 0u};
      const unsigned b[2] = {live && n < N ? tf32_bits(b0[n]) : 0u,
                             live && n < N ? tf32_bits(b1[n]) : 0u};
      mma_tf32(d, a, b);
    }
    const int c = nt * 8 + 2 * q;
    if (m0 < M) {
      if (c < N) g[m0 * N + c] += d[0];
      if (c + 1 < N) g[m0 * N + c + 1] += d[1];
    }
    if (m1 < M) {
      if (c < N) g[m1 * N + c] += d[2];
      if (c + 1 < N) g[m1 * N + c + 1] += d[3];
    }
  }
}

// kF, kH > 0: the widths at compile time (the MNIST-SDE width), so the
// products' loops unroll with immediate offsets; 0: read from the arguments.
// kRecTf32: the stage recompute at the TF32 tier; kGradTf32: the transposed
// and weight-gradient products at the TF32 tier (the stage combinations,
// the tanh derivative, the bias gradients and the partials FP32).
template <bool kSosri, bool kTime, int kF, int kH, bool kRecTf32 = false,
          bool kGradTf32 = false>
__global__ void __launch_bounds__(kSdeThreads)
sde_sweep_kernel(SdeSweepArgs a) {
  SdeClock<kTime> clk;
  clk.start();
  extern __shared__ float4 smem_raw[];
  const int F = kF > 0 ? kF : a.w.F, H = kH > 0 ? kH : a.w.H;
  const int B = a.B, tid = threadIdx.x;
  const int n_blocks = (B + kSdeRows - 1) / kSdeRows;
  const size_t BF = static_cast<size_t>(B) * F;
  const int RF = kSdeRows * F, RH = kSdeRows * H;
  SdeSmemW w;
  float* gw1 = load_sde_weights(a.w, reinterpret_cast<float*>(smem_raw), &w);
  float* gb1 = gw1 + F * H;
  float* gw2 = gb1 + H;
  float* gb2 = gw2 + H * F;
  float* gwd = gb2 + F;
  float* gbd = gwd + F * F;
  float* u = gbd + F;
  float* dw = u + RF;
  float* dz = dw + RF;
  float* dxf = dz + RF;
  float* dxg = dxf + RF;
  float* du = dxg + RF;
  float* dint = du + RF;
  float* xf = dint + RF;     // [4][RF] each, below
  float* xg = xf + 4 * RF;
  float* k = xg + 4 * RF;
  float* g = k + 4 * RF;
  float* dk = g + 4 * RF;
  float* dg = dk + 4 * RF;
  float* hid = dg + 4 * RF;  // [4][RH]
  float* dzh = hid + 4 * RH;
  for (size_t i = tid; i < sde_grad_floats(F, H); i += kSdeThreads) gw1[i] = 0.f;
  SdeFrags fwd{}, tr{};
  if constexpr (kRecTf32 || kGradTf32) {
    float* base = reinterpret_cast<float*>(smem_raw);
    float* f = base + round_up4(dzh + 4 * RH - base);
    if constexpr (kRecTf32) f = stage_sde_frags(a.w, f, false, &fwd);
    if constexpr (kGradTf32) stage_sde_frags(a.w, f, true, &tr);
  }
  const SriTableau T = sri_tableau(kSosri);
  const float sqrt3 = LRNDE_F(1.7320508075688772);
  const int n_steps = *a.naccept;
  __syncthreads();

  for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
    const size_t off = static_cast<size_t>(rb) * kSdeRows * F;
    const int nrows = min(kSdeRows, B - rb * kSdeRows), n = nrows * F;
    for (int i = tid; i < n; i += kSdeThreads) a.a_u[off + i] = a.ct_y[off + i];
    for (int j = n_steps - 1; j >= 0; --j) {
      const float t = a.knot_ts[j], tn = a.knot_ts[j + 1];
      const float dt = tn - t, sqdt = sqrtf(dt);
      // ---- forward recompute of the step
      for (int i = tid; i < n; i += kSdeThreads) {
        const size_t o = j * BF + off + i;
        u[i] = a.knot_us[o];
        dw[i] = a.knot_dws[o];
        dz[i] = a.knot_dzs[o];
        xf[i] = u[i];
        xg[i] = u[i];
      }
      __syncthreads();
      if constexpr (kRecTf32)
        sde_stage_eval_tf32(w, fwd, F, H, xf, xg, hid, k, g, nrows);
      else
        sde_stage_eval(w, F, H, xf, xg, hid, k, g, nrows);
      for (int e = 1; e < 4; ++e) {
        for (int i = tid; i < n; i += kSdeThreads) {
          const float chi2 = (dw[i] + dz[i] / sqrt3) / 2.f;
          float f_in, g_in;
          if (e == 1) {
            f_in = u[i] + dt * T.A0[0][0] * k[i] + T.B0[0][0] * chi2 * g[i];
            g_in = u[i] + dt * T.A1[0][0] * k[i] + sqdt * T.B1[0][0] * g[i];
          } else {
            float kf = T.A0[e - 1][0] * k[i], kg = T.A1[e - 1][0] * k[i];
            float gf = T.B0[e - 1][0] * g[i], gg = T.B1[e - 1][0] * g[i];
            for (int q = 1; q < e; ++q) {
              kf = kf + T.A0[e - 1][q] * k[q * RF + i];
              kg = kg + T.A1[e - 1][q] * k[q * RF + i];
              gf = gf + T.B0[e - 1][q] * g[q * RF + i];
              gg = gg + T.B1[e - 1][q] * g[q * RF + i];
            }
            f_in = u[i] + dt * kf + chi2 * gf;
            g_in = u[i] + dt * kg + sqdt * gg;
          }
          xf[e * RF + i] = f_in;
          xg[e * RF + i] = g_in;
        }
        __syncthreads();
        if constexpr (kRecTf32)
          sde_stage_eval_tf32(w, fwd, F, H, xf + e * RF, xg + e * RF,
                              hid + e * RH, k + e * RF, g + e * RF, nrows);
        else
          sde_stage_eval(w, F, H, xf + e * RF, xg + e * RF, hid + e * RH,
                         k + e * RF, g + e * RF, nrows);
      }
      clk.mark(kSdeRecompute);
      // ---- saveat split and the cotangents of the u_new expression
      for (int i = tid; i < n; i += kSdeThreads) {
        const size_t o = off + i;
        float d_unew = 0.f, d_int = 0.f;
        for (int q = 0; q < a.n_save; ++q) {
          const float st = a.saveat[q];
          if (!(st > t && st <= tn)) continue;
          const float theta = fminf(fmaxf((st - t) / dt, 0.f), 1.f);
          const float ct = a.ct_ys[q * BF + o];
          d_unew = d_unew + theta * ct;
          d_int = d_int + (1.f - theta) * ct;
        }
        const float A = a.a_u[o] + d_unew;
        const float dW = dw[i];
        const float chi1 = (dW * dW - dt) / (2.f * sqdt);
        const float chi2 = (dW + dz[i] / sqrt3) / 2.f;
        const float chi3 = (dW * dW * dW - 3.f * dW * dt) / (6.f * dt);
        for (int e = 0; e < 4; ++e) {
          dk[e * RF + i] = (dt * T.alpha[e]) * A;
          dg[e * RF + i] = (dW * T.beta1[e] + chi1 * T.beta2[e] +
                            chi2 * T.beta3[e] + chi3 * T.beta4[e]) * A;
        }
        du[i] = A;
        dint[i] = d_int;
      }
      __syncthreads();
      clk.mark(kSdeSaveat);
      // ---- reverse through the stages: the hidden cotangents beside the
      // transposed diffusion, then the transposed first layer, then the
      // carries
      for (int e = 3; e >= 0; --e) {
        const float* dke = dk + e * RF;
        const float* dge = dg + e * RF;
        if constexpr (kGradTf32) {
          // the same products on the tensor cores: the hidden cotangents'
          // tiles beside the transposed diffusion's, then the first layer's
          constexpr int kHidWarps = kSdeHidThreads / 32;
          const int warp = tid >> 5;
          float d[4];
          if (warp < kHidWarps) {
            for (int mt = warp; mt < frag_mtiles(H); mt += kHidWarps) {
              tile_tf32(tr.a1, mt, F, dke, F, nrows, d);
              tile_put<kSdeRows>(d, mt, H, nrows, [&](int r, int h, float v) {
                const float hv = hid[e * RH + r * H + h];
                dzh[e * RH + r * H + h] = v * (1.f - hv * hv);
              });
            }
          } else {
            for (int mt = warp - kHidWarps; mt < frag_mtiles(F);
                 mt += kSdeDiffThreads / 32) {
              tile_tf32(tr.ad, mt, F, dge, F, nrows, d);
              tile_put<kSdeRows>(d, mt, F, nrows, [&](int r, int c, float v) {
                dxg[r * F + c] = v;
              });
            }
          }
          __syncthreads();
          for (int mt = warp; mt < frag_mtiles(F); mt += kSdeThreads / 32) {
            tile_tf32(tr.a2, mt, H, dzh + e * RH, H, nrows, d);
            tile_put<kSdeRows>(d, mt, F, nrows, [&](int r, int c, float v) {
              dxf[r * F + c] = v;
            });
          }
        } else {
          if (tid < kSdeHidThreads) {
            for (int i = tid; i < nrows * H; i += kSdeHidThreads) {
              const int r = i / H, h = i - r * H;
              float acc = 0.f;
              for (int c = 0; c < F; ++c) acc = fmaf(dke[r * F + c], w.w2[h * (F + 1) + c], acc);
              const float hv = hid[e * RH + i];
              dzh[e * RH + i] = acc * (1.f - hv * hv);
            }
          } else {
            for (int i = tid - kSdeHidThreads; i < n; i += kSdeDiffThreads) {
              const int r = i / F, c = i - r * F;
              float acc = 0.f;
              for (int q = 0; q < F; ++q) acc = fmaf(dge[r * F + q], w.wd[c * (F + 1) + q], acc);
              dxg[i] = acc;
            }
          }
          __syncthreads();
          for (int i = tid; i < n; i += kSdeThreads) {
            const int r = i / F, c = i - r * F;
            const float* dzr = dzh + e * RH + r * H;
            float acc = 0.f;
            for (int h = 0; h < H; ++h) acc = fmaf(dzr[h], w.w1[c * (H + 1) + h], acc);
            dxf[i] = acc;
          }
        }
        __syncthreads();
        for (int i = tid; i < n; i += kSdeThreads) {
          const float xf_ = dxf[i], xg_ = dxg[i];
          du[i] = du[i] + xf_ + xg_;
          if (e == 0) continue;
          const float chi2 = (dw[i] + dz[i] / sqrt3) / 2.f;
          for (int q = 0; q < e; ++q) {
            float& kq = dk[q * RF + i];
            float& gq = dg[q * RF + i];
            kq = kq + (dt * T.A0[e - 1][q]) * xf_;
            gq = gq + (chi2 * T.B0[e - 1][q]) * xf_;
            kq = kq + (dt * T.A1[e - 1][q]) * xg_;
            gq = gq + (sqdt * T.B1[e - 1][q]) * xg_;
          }
        }
        __syncthreads();
      }
      for (int i = tid; i < n; i += kSdeThreads) a.a_u[off + i] = du[i] + dint[i];
      clk.mark(kSdeReverse);
      // ---- stage-batched weight gradients of this step: every element of
      // the partial on one thread, its K = 4 stages x rows sum as before
      if constexpr (kGradTf32) {
        grad_contract_tf32(xf, RF, F, F, dzh, RH, H, H, nrows, gw1);
        grad_contract_tf32(hid, RH, H, H, dk, RF, F, F, nrows, gw2);
        grad_contract_tf32(xg, RF, F, F, dg, RF, F, F, nrows, gwd);
      } else {
        grad_contract(xf, RF, F, dzh, RH, H, H, F * H, nrows, gw1);
        grad_contract(hid, RH, H, dk, RF, F, F, H * F, nrows, gw2);
        grad_contract(xg, RF, F, dg, RF, F, F, F * F, nrows, gwd);
      }
      for (int i = tid; i < H; i += kSdeThreads) {
        float acc = 0.f;
        for (int e = 0; e < 4; ++e)
          for (int r = 0; r < nrows; ++r) acc += dzh[e * RH + r * H + i];
        gb1[i] += acc;
      }
      for (int i = tid; i < F; i += kSdeThreads) {
        float ak = 0.f, ag = 0.f;
        for (int e = 0; e < 4; ++e)
          for (int r = 0; r < nrows; ++r) {
            ak += dk[e * RF + r * F + i];
            ag += dg[e * RF + r * F + i];
          }
        gb2[i] += ak;
        gbd[i] += ag;
      }
      __syncthreads();
      clk.mark(kSdeWgrad);
    }
  }
  float* out = a.part + blockIdx.x * sde_grad_floats(F, H);
  for (size_t i = tid; i < sde_grad_floats(F, H); i += kSdeThreads) out[i] = gw1[i];
  clk.mark(kSdePartial);
  clk.write(a.timing, n_steps);
}

}  // namespace lrnde

// Batch rows per row block (one CTA's unit of work) of the SDE kernels.
extern "C" int lrnde_sde_rows_per_block() { return lrnde::kSdeRows; }

// Floats of dynamic shared memory per CTA at the tiers (lrnde_sde_sweep's
// bits), and of one weight-gradient partial, at (F, H).
extern "C" long long lrnde_sde_sweep_smem_floats(int tiers, int F, int H) {
  return static_cast<long long>(lrnde::sde_sweep_smem_floats_at(
      F, H, tiers & lrnde::kSdeTierRecompute, tiers & lrnde::kSdeTierGrad));
}

// Threads of a sweep CTA: the hidden group, then the diffusion group.
extern "C" int lrnde_sde_sweep_threads() { return lrnde::kSdeThreads; }
extern "C" int lrnde_sde_sweep_hid_threads() { return lrnde::kSdeHidThreads; }

extern "C" long long lrnde_sde_grad_floats(int F, int H) {
  return static_cast<long long>(lrnde::sde_grad_floats(F, H));
}

#define LRNDE_SDE_SWEEP_PARAMS                                              \
  int sosri, const float *w1, const float *b1, const float *w2,             \
      const float *b2, const float *wd, const float *bd,                    \
      const float *knot_ts, const float *knot_us, const float *knot_dws,    \
      const float *knot_dzs, const int *naccept, const float *saveat,       \
      int n_save, const float *ct_ys, const float *ct_y, float *a_u,        \
      float *d_w, float *part, int B, int F, int H
#define LRNDE_SDE_SWEEP_ARGS                                                \
  sosri, w1, b1, w2, b2, wd, bd, knot_ts, knot_us, knot_dws, knot_dzs,      \
      naccept, saveat, n_save, ct_ys, ct_y, a_u, d_w, part, B, F, H

namespace lrnde {

template <bool kTime, bool kRec = false, bool kGrad = false>
static int sde_sweep(LRNDE_SDE_SWEEP_PARAMS, unsigned long long* timing,
                     void* stream) {
  SdeSweepArgs a{SdeWeights{w1, b1, w2, b2, wd, bd, F, H}, knot_ts, knot_us,
                 knot_dws, knot_dzs, naccept, saveat, n_save, ct_ys, ct_y,
                 a_u, part, B, timing};
  const size_t smem = sde_sweep_smem_floats_at(F, H, kRec, kGrad)
                    * sizeof(float);
  const bool mnist = F == 32 && H == 64;  // experiments/mnist_sde/mlp.yaml
  auto kernel =
      sosri ? (mnist ? sde_sweep_kernel<true, kTime, 32, 64, kRec, kGrad>
                     : sde_sweep_kernel<true, kTime, 0, 0, kRec, kGrad>)
            : (mnist ? sde_sweep_kernel<false, kTime, 32, 64, kRec, kGrad>
                     : sde_sweep_kernel<false, kTime, 0, 0, kRec, kGrad>);
  static size_t granted[4] = {0, 0, 0, 0};
  cudaError_t err = allow_smem(kernel, smem, &granted[2 * sosri + mnist]);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = sde_row_blocks(B);
  kernel<<<grid, kSdeThreads, smem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(part, grid, sde_grad_floats(F, H), d_w, s);
}

}  // namespace lrnde

// The reverse sweep over *naccept recorded SRI (sosri = 0) or SOSRI
// (sosri = 1) steps at the tiers (bit kSdeTierRecompute: the stage
// recompute at TF32; kSdeTierGrad: the transposed and weight-gradient
// products at TF32; 0: FP32 throughout): writes a_u and the flat weight
// gradient d_w (dW1, db1, dW2, db2, dWd, dbd); part holds ceil(B / 4)
// partials. Two launches on the stream: the sweep and the ordered sum of
// its partials. Returns cudaGetLastError().
extern "C" int lrnde_sde_sweep(int tiers, LRNDE_SDE_SWEEP_PARAMS,
                               void* stream) {
  using namespace lrnde;
  switch (tiers) {
    case 0:
      return sde_sweep<false>(LRNDE_SDE_SWEEP_ARGS, nullptr, stream);
    case kSdeTierRecompute:
      return sde_sweep<false, true, false>(LRNDE_SDE_SWEEP_ARGS, nullptr,
                                           stream);
    case kSdeTierGrad:
      return sde_sweep<false, false, true>(LRNDE_SDE_SWEEP_ARGS, nullptr,
                                           stream);
    case kSdeTierRecompute | kSdeTierGrad:
      return sde_sweep<false, true, true>(LRNDE_SDE_SWEEP_ARGS, nullptr,
                                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The FP32 sweep with CTA 0's nanoseconds per phase (kSdeSwPhases) and the
// number of steps in timing. A separate instantiation.
extern "C" int lrnde_sde_sweep_timed(LRNDE_SDE_SWEEP_PARAMS,
                                     unsigned long long* timing,
                                     void* stream) {
  return lrnde::sde_sweep<true>(LRNDE_SDE_SWEEP_ARGS, timing, stream);
}

extern "C" const char* lrnde_sde_sweep_phase_names() {
  return "recompute,saveat split,reverse,weight gradients,partial write";
}
