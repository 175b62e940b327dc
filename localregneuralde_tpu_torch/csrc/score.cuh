// The score network of the score-SDE samplers as dynamics types of the
// whole-solve kernels: PfScore for kernel 6 (persistent.cuh, pf_solve.cu)
// and VpScore for kernel 11 (sde_solve.cu).
//
// s_θ is a TDChain of biased Dense layers (the reference's time-appended
// channel, fused_sde_solve.py::match_td_score_chain): the Dense chain of
// chain.cuh with a time row in every layer (ScoreChain), at the real time t.
// The samplers integrate on the clock τ = t1 − t, with β(t) = β_min + t·Δβ:
//   PfScore (probability flow): f(x, τ) = ½β(t)·(x + s_θ(x, t))
//   VpScore (reverse VP-SDE):   drift ½β(t)·x + β(t)·s_θ(x, t),
//                               diffusion √β(t) (diagonal, state-free)
// Counterparts of the reference's ("pfode", ...) family
// (fused_solve.py::family_make_f) and ("vpsde", ...) family
// (fused_sde_solve.py::_family_make_fg). The TPU padded every width to 128
// lanes and masked the diffusion out of the padded lanes; here nothing is
// padded, so there is no mask, and the error norm divides by the logical
// B·F (inv_n).
//
// Row blocking: the state is narrow (F = 2) and the batch wide (B = 4096),
// so a CTA of kScoreThreads threads owns kScoreRows rows: 512 row blocks, all
// co-resident, each CTA running one. The demo's network (2 -> 64 -> 64 -> 2)
// is 18 KB of shared memory, and its products 9.0 kFLOP a row and
// evaluation; what bounds the kernels is the serial chain of layer passes
// and the grid barrier of every attempt.
//
// Every scalar of the time and β arithmetic is rounded as the plain PyTorch
// versions round it (separate multiply and add, no contraction).
#pragma once

#include "chain.cuh"
#include "solve.cuh"

namespace lrnde {

constexpr int kScoreRows = 8;       // batch rows per CTA
constexpr int kScoreThreads = 128;  // threads per CTA

using ScoreChain = DenseChainT<kScoreRows, kScoreThreads, true>;

struct ScoreNet : ScoreChain {
  float beta_min, d_beta, t1;
};

// Kernel 6's dynamics and kernel 11's drift and diffusion: the same network,
// told apart by type.
struct PfScore : ScoreNet {};
struct VpScore : ScoreNet {};

// The real time t = t1 − τ of the clock τ, and β there.
__device__ inline float score_time(const ScoreNet& w, float tau) {
  return __fadd_rn(w.t1, -tau);
}

__device__ inline float score_beta(const ScoreNet& w, float t) {
  return __fadd_rn(w.beta_min, __fmul_rn(t, w.d_beta));
}

// Kernel 6's evaluation for the Tsit5 attempt code (tdmlp.cuh::tsit5_rows):
// the stage input in sm.xs ([F][rows], transposed), stage time s on the τ
// clock; writes rows [0, nrows) of out (row-major, stride F).
__device__ inline void eval_rows(const PfScore& w, const ChainSmem& sm,
                                 float s, float* out, int nrows) {
  constexpr int R = kScoreRows;
  const float t = score_time(w, s);
  const float hb = __fmul_rn(0.5f, score_beta(w, t));
  chain_forward(w, sm.w, sm.xs, 1, R, t, sm.act, false, out, nrows);
  const int F = w.F;
  for (int i = threadIdx.x; i < nrows * F; i += kScoreThreads) {
    const int r = i / F, c = i - r * F;
    out[i] = __fmul_rn(hb, __fadd_rn(sm.xs[c * R + r], out[i]));
  }
}

// Kernel 11's dynamics-type interface of sde_solve.cu: the type's shared
// memory, carved and loaded (returns the first float after it).
__host__ __device__ inline size_t sde_shared_floats(const VpScore& w) {
  return shared_floats(w);
}

__device__ inline float* sde_carve_load(const VpScore& w, float* base,
                                        ChainSmem* s) {
  *s = carve_shared(w, base);
  load_shared(w, *s);
  return base + shared_floats(w);
}

// Kernel 11's stage (sde_solve.cu): k = drift(xf, τ_f), g = diffusion at τ_g
// for rows [0, nrows), both [rows][F] row-major; xg is not read (the
// diffusion does not depend on the state). Synchronises before returning.
__device__ inline void sde_stage(const VpScore& w, const ChainSmem& sm,
                                 const float* xf, const float* /*xg*/,
                                 float tf, float tg, float* k, float* g,
                                 int nrows) {
  const float t = score_time(w, tf);
  const float b = score_beta(w, t);
  const float hb = __fmul_rn(0.5f, b);
  const float sg = __fsqrt_rn(score_beta(w, score_time(w, tg)));
  const int F = w.F;
  chain_forward(w, sm.w, xf, F, 1, t, sm.act, false, k, nrows);
  for (int i = threadIdx.x; i < nrows * F; i += kScoreThreads) {
    k[i] = __fadd_rn(__fmul_rn(hb, xf[i]), __fmul_rn(b, k[i]));
    g[i] = sg;
  }
  __syncthreads();
}

// A ScoreNet from its host description: pointers (W_0, b_0, W_1, b_1, ...;
// W_l the (d_l + 1, d_{l+1}) TD matrix), dims (L + 1), the tanh mask and the
// VP-SDE's schedule on the τ clock. False outside make_chain's limits.
inline bool make_score(ScoreNet* c, const void* const* wb, const int* dims,
                       int L, unsigned int acts, float beta_min, float d_beta,
                       float t1) {
  if (!make_chain(c, wb, dims, L, acts, 0)) return false;
  c->beta_min = beta_min;
  c->d_beta = d_beta;
  c->t1 = t1;
  return true;
}

}  // namespace lrnde
