// Shared device code of the SDE kernels (sde_solve.cu, kernel 10, and
// sde_sweep.cu, kernel 12): the SRI tableaus, the counter-based normals of
// the virtual Brownian tree, the I-controller, and the drift/diffusion
// evaluation of a row block of the NeuralDSDE family
//   drift(x)     = tanh(x·W1 + b1)·W2 + b2      W1 (F, H), W2 (H, F)
//   diffusion(x) = x·Wd + bd                    Wd (F, F)
// with the weights in the JAX layout, (in, out) row-major.
//
// Work split: a CTA of kSdeThreads threads owns blocks of kSdeRows batch
// rows. The state is narrow (F = 32 at the MNIST-SDE width), so every CTA
// keeps all six weights in shared memory for the whole launch, each matrix
// row padded by one float: a padded stride makes both the forward (over
// output columns) and the transposed (over input rows) products free of
// bank conflicts.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "solve.cuh"

namespace lrnde {

constexpr int kSdeThreads = 64;  // threads per CTA
constexpr int kSdeRows = 4;      // batch rows per row block

// ---------------------------------------------------------------- tableaus
// sde/tableaus.py, rounded from the Python floats to float32. Rows of the
// stage coefficients are indexed [stage e = 2..4 → e-2][j]; c0 and c1 are
// the stage times of the drift and diffusion evaluations (c0[0] = 0).
struct SriTableau {
  float A0[3][3], B0[3][3], A1[3][3], B1[3][3];
  float alpha[4], beta1[4], beta2[4], beta3[4], beta4[4];
  float c0[4], c1[4];
};

#define LRNDE_F(x) static_cast<float>(x)
__host__ __device__ inline SriTableau sri_tableau(bool sosri) {
  SriTableau T = {
      {{LRNDE_F(3.0 / 4.0), 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}},
      {{LRNDE_F(3.0 / 2.0), 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}},
      {{LRNDE_F(1.0 / 4.0), 0.f, 0.f},
       {1.f, 0.f, 0.f},
       {0.f, 0.f, LRNDE_F(1.0 / 4.0)}},
      {{LRNDE_F(1.0 / 2.0), 0.f, 0.f},
       {-1.f, 0.f, 0.f},
       {-5.f, 3.f, LRNDE_F(1.0 / 2.0)}},
      {LRNDE_F(1.0 / 3.0), LRNDE_F(2.0 / 3.0), 0.f, 0.f},
      {-1.f, LRNDE_F(4.0 / 3.0), LRNDE_F(2.0 / 3.0), 0.f},
      {-1.f, LRNDE_F(4.0 / 3.0), LRNDE_F(-1.0 / 3.0), 0.f},
      {2.f, LRNDE_F(-4.0 / 3.0), LRNDE_F(-2.0 / 3.0), 0.f},
      {-2.f, LRNDE_F(5.0 / 3.0), LRNDE_F(-2.0 / 3.0), 1.f},
      {0.f, LRNDE_F(3.0 / 4.0), 0.f, 0.f},
      {0.f, LRNDE_F(1.0 / 4.0), 1.f, LRNDE_F(1.0 / 4.0)},
  };
  if (sosri) {  // the re-derived drift block; the diffusion block is SRIW1's
    T.A0[0][0] = 0.5f;
    T.A0[1][1] = 0.75f;
    T.A0[2][2] = 1.f;
    T.B0[0][0] = LRNDE_F(1.5513640431410758);
    T.alpha[0] = LRNDE_F(0.12308703268250232);
    T.alpha[1] = LRNDE_F(0.6445940296355466);
    T.alpha[2] = LRNDE_F(0.2184638099988976);
    T.alpha[3] = LRNDE_F(0.0138551276830535);
    T.c0[1] = 0.5f;
    T.c0[2] = 0.75f;
    T.c0[3] = 1.f;
  }
  return T;
}

// ------------------------------------------------------------------- noise
// Philox4x32-10 (Salmon et al. 2011) of counter c under key (k0, k1).
__device__ inline uint4 philox4x32(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// 32 bits → the top 24 as a half-ulp-centred uniform, clamped to
// [1e-7, 1 − 1e-7] (the largest pattern rounds to exactly 1.0f).
__device__ inline float bits_to_uniform(uint32_t bits) {
  const float u = __fadd_rn(__fmul_rn(static_cast<float>(bits >> 8),
                                      LRNDE_F(1.0 / 16777216.0)),
                            LRNDE_F(1.0 / 33554432.0));
  return fminf(fmaxf(u, LRNDE_F(1e-7)), LRNDE_F(1.0 - 1e-7));
}

// Horner step a·x + c without contraction, so the product rounds as the
// plain PyTorch version's separate multiply and add do.
__device__ inline float horner(float a, float x, float c) {
  return __fadd_rn(__fmul_rn(a, x), c);
}

// Acklam's inverse normal CDF (sde/brownian.py::norm_icdf).
__device__ inline float norm_icdf(float p) {
  const float q = __fadd_rn(p, -0.5f);
  const float pt = fminf(p, __fadd_rn(1.f, -p));
  if (pt >= LRNDE_F(0.02425)) {
    const float r = __fmul_rn(q, q);
    float num = LRNDE_F(-3.969683028665376e+01);
    num = horner(num, r, LRNDE_F(2.209460984245205e+02));
    num = horner(num, r, LRNDE_F(-2.759285104469687e+02));
    num = horner(num, r, LRNDE_F(1.383577518672690e+02));
    num = horner(num, r, LRNDE_F(-3.066479806614716e+01));
    num = horner(num, r, LRNDE_F(2.506628277459239e+00));
    float den = LRNDE_F(-5.447609879822406e+01);
    den = horner(den, r, LRNDE_F(1.615858368580409e+02));
    den = horner(den, r, LRNDE_F(-1.556989798598866e+02));
    den = horner(den, r, LRNDE_F(6.680131188771972e+01));
    den = horner(den, r, LRNDE_F(-1.328068155288572e+01));
    den = horner(den, r, 1.f);
    return __fdiv_rn(__fmul_rn(num, q), den);
  }
  const float qt = __fsqrt_rn(__fmul_rn(-2.f, logf(fmaxf(pt, LRNDE_F(1e-30)))));
  float nu = LRNDE_F(-7.784894002430293e-03);
  nu = horner(nu, qt, LRNDE_F(-3.223964580411365e-01));
  nu = horner(nu, qt, LRNDE_F(-2.400758277161838e+00));
  nu = horner(nu, qt, LRNDE_F(-2.549732539343734e+00));
  nu = horner(nu, qt, LRNDE_F(4.374664141464968e+00));
  nu = horner(nu, qt, LRNDE_F(2.938163982698783e+00));
  float de = LRNDE_F(7.784695709041462e-03);
  de = horner(de, qt, LRNDE_F(3.224671290700398e-01));
  de = horner(de, qt, LRNDE_F(2.445134137142996e+00));
  de = horner(de, qt, LRNDE_F(3.754408661907416e+00));
  de = horner(de, qt, 1.f);
  const float x = __fdiv_rn(nu, de);
  return p < 0.5f ? x : -x;
}

// The four normals of (column pair, row, node): W and Z of columns 2p and
// 2p + 1 (sde/brownian.py::PhiloxNormals).
__device__ inline float4 pair_normals(uint32_t seed, int pair, int row,
                                      int node) {
  const uint4 w = philox4x32(
      make_uint4(static_cast<uint32_t>(pair), static_cast<uint32_t>(row),
                 static_cast<uint32_t>(node), 0u),
      seed, 0u);
  return make_float4(norm_icdf(bits_to_uniform(w.x)),
                     norm_icdf(bits_to_uniform(w.y)),
                     norm_icdf(bits_to_uniform(w.z)),
                     norm_icdf(bits_to_uniform(w.w)));
}

// ---------------------------------------------------------------- control
// The SDE loop's I-controller: γ 0.9, qmin 0.2, qmax 1.2, β1 = 1/2.5,
// β2 = 0 (so the qold factor is 1).
__device__ inline void propose_sde(float eest, float dt, float* dt_acc,
                                   float* dt_rej, float* qold_acc) {
  const bool finite = isfinite(eest);
  const float e = finite ? fmaxf(eest, 0.f) : 1.f;
  const float q11 = powf(e, LRNDE_F(1.0 / 2.5));
  const float q = fmaxf(LRNDE_F(1.0 / 1.2), fminf(5.f, q11 / LRNDE_F(0.9)));
  *dt_acc = finite ? dt / q : dt * 0.5f;
  *dt_rej = finite ? dt / fminf(5.f, q11 / LRNDE_F(0.9)) : dt * 0.5f;
  *qold_acc = fmaxf(e, LRNDE_F(1e-4));
}

// ------------------------------------------------------------- the family
struct SdeMlpShared;

// A dynamics type of the solve kernel (sde_solve.cu) names its row blocking
// and its shared memory type, and has sde_shared_floats(),
// sde_carve_load() and sde_stage() overloads (score.cuh::VpScore is the
// other).
struct SdeWeights {
  static constexpr int rows = kSdeRows;
  static constexpr int threads = kSdeThreads;
  using Shared = SdeMlpShared;
  const float* w1;  // (F, H)
  const float* b1;  // (H)
  const float* w2;  // (H, F)
  const float* b2;  // (F)
  const float* wd;  // (F, F)
  const float* bd;  // (F)
  int F;
  int H;
};

// The weights in shared memory, rows padded by one float.
struct SdeSmemW {
  float *w1, *b1, *w2, *b2, *wd, *bd;
  int F, H;
  __device__ float W1(int k, int h) const { return w1[k * (H + 1) + h]; }
  __device__ float W2(int h, int j) const { return w2[h * (F + 1) + j]; }
  __device__ float Wd(int k, int j) const { return wd[k * (F + 1) + j]; }
};

__host__ __device__ inline size_t sde_weight_smem_floats(int F, int H) {
  return static_cast<size_t>(F) * (H + 1) + H + static_cast<size_t>(H) * (F + 1)
       + F + static_cast<size_t>(F) * (F + 1) + F;
}

// Carve the weights from base and copy them in; returns the first float
// after them. The caller synchronises.
__device__ inline float* load_sde_weights(const SdeWeights& w, float* base,
                                          SdeSmemW* s) {
  const int F = w.F, H = w.H;
  s->F = F;
  s->H = H;
  s->w1 = base;
  s->b1 = s->w1 + F * (H + 1);
  s->w2 = s->b1 + H;
  s->b2 = s->w2 + H * (F + 1);
  s->wd = s->b2 + F;
  s->bd = s->wd + F * (F + 1);
  for (int i = threadIdx.x; i < F * H; i += blockDim.x)
    s->w1[(i / H) * (H + 1) + i % H] = w.w1[i];
  for (int i = threadIdx.x; i < H * F; i += blockDim.x)
    s->w2[(i / F) * (F + 1) + i % F] = w.w2[i];
  for (int i = threadIdx.x; i < F * F; i += blockDim.x)
    s->wd[(i / F) * (F + 1) + i % F] = w.wd[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) s->b1[i] = w.b1[i];
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    s->b2[i] = w.b2[i];
    s->bd[i] = w.bd[i];
  }
  return s->bd + F;
}

// One stage of the row block: k = drift(xf), g = diffusion(xg) for rows
// [0, nrows), all [kSdeRows][F] (hid [kSdeRows][H]) in shared memory, each
// product summed left to right in FP32. Synchronises before returning.
__device__ inline void sde_stage_eval(const SdeSmemW& w, const float* xf,
                                      const float* xg, float* hid, float* k,
                                      float* g, int nrows) {
  const int F = w.F, H = w.H;
  for (int i = threadIdx.x; i < nrows * H; i += blockDim.x) {
    const int r = i / H, h = i - r * H;
    const float* x = xf + r * F;
    float acc = 0.f;
    for (int c = 0; c < F; ++c) acc = fmaf(x[c], w.W1(c, h), acc);
    hid[i] = tanhf(acc + w.b1[h]);
  }
  for (int i = threadIdx.x; i < nrows * F; i += blockDim.x) {
    const int r = i / F, j = i - r * F;
    const float* x = xg + r * F;
    float acc = 0.f;
    for (int c = 0; c < F; ++c) acc = fmaf(x[c], w.Wd(c, j), acc);
    g[i] = acc + w.bd[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * F; i += blockDim.x) {
    const int r = i / F, j = i - r * F;
    const float* hr = hid + r * H;
    float acc = 0.f;
    for (int h = 0; h < H; ++h) acc = fmaf(hr[h], w.W2(h, j), acc);
    k[i] = acc + w.b2[j];
  }
  __syncthreads();
}

// The MLP family as a dynamics type of the solve kernel: its weights and
// the hidden rows of a stage evaluation ([kSdeRows][H]) in shared memory.
struct SdeMlpShared {
  SdeSmemW w;
  float* hid;
};

__host__ __device__ inline size_t sde_shared_floats(const SdeWeights& w) {
  return sde_weight_smem_floats(w.F, w.H) + static_cast<size_t>(kSdeRows) * w.H;
}

// Carve and load the weights; returns the first float after the type's
// shared memory. The caller synchronises.
__device__ inline float* sde_carve_load(const SdeWeights& w, float* base,
                                        SdeMlpShared* s) {
  s->hid = load_sde_weights(w, base, &s->w);
  return s->hid + kSdeRows * w.H;
}

// The family is autonomous: the stage times are not read.
__device__ inline void sde_stage(const SdeWeights&, const SdeMlpShared& s,
                                 const float* xf, const float* xg,
                                 float /*tf*/, float /*tg*/, float* k,
                                 float* g, int nrows) {
  sde_stage_eval(s.w, xf, xg, s.hid, k, g, nrows);
}

inline int sde_row_blocks(int B) { return (B + kSdeRows - 1) / kSdeRows; }

}  // namespace lrnde
