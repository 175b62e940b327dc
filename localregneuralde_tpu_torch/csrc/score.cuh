// The score network of the score-SDE samplers as dynamics types of the
// whole-solve kernels: PfScore for kernel 6 (pf_solve.cu, evaluated a warp a
// group of rows by score_rows.cuh) and VpScore for kernel 11 (sde_solve.cu,
// evaluated CTA-wide by chain.cuh::chain_forward).
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
// Row blocking of kernel 11: the state is narrow (F = 2) and the batch wide
// (B = 4096), so a CTA of kScoreThreads threads owns kScoreRows rows: 512
// row blocks, all co-resident, each CTA running one. The demo's network
// (2 -> 64 -> 64 -> 2) is 18 KB of shared memory, and its products 9.0
// kFLOP a row and evaluation; what bounds the kernel is the serial chain of
// layer passes (their shared-memory reads: chain.cuh::chain_forward) and
// the grid barrier with its slot sum of every attempt.
//
// Every scalar of the time and β arithmetic is rounded as the plain PyTorch
// versions round it (separate multiply and add, no contraction).
//
// The TF32 tier (the reference's 'default', which its samplers take): each
// layer's a·W_l[0:d_l] on mma.sync m16n8k8 (tf32.cuh's row tiles) on
// operands rounded to TF32, W_l's rows rounded once into fragment copies
// where they are staged (score_frags); the time term t·W_l[d_l], the bias,
// tanh and the samplers' β arithmetic stay FP32, as in the reference's
// kernel and its pure twin. Kernel 11's VpScoreTf32 takes its CTA's eight
// rows as the eight columns of a tile, a warp an m-tile of 16 outputs
// (chain_forward_tf32); kernel 6 takes a warp's four rows as four of them
// (score_rows.cuh::warp_score_rows_tf32).
#pragma once

#include "chain.cuh"
#include "solve.cuh"
#include "tf32.cuh"

namespace lrnde {

constexpr int kScoreRows = 8;       // batch rows per CTA of kernel 11
constexpr int kScoreThreads = 128;  // threads per CTA of kernel 11

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
// The stage with the score network's evaluation forward(t) into k (which
// synchronises), at either tier.
template <typename Forward>
__device__ __forceinline__ void vp_stage(const ScoreNet& w, const float* xf,
                                         float tf, float tg, float* k,
                                         float* g, int nrows,
                                         Forward forward) {
  const float t = score_time(w, tf);
  const float b = score_beta(w, t);
  const float hb = __fmul_rn(0.5f, b);
  const float sg = __fsqrt_rn(score_beta(w, score_time(w, tg)));
  const int F = w.F;
  forward(t);
  for (int i = threadIdx.x; i < nrows * F; i += kScoreThreads) {
    k[i] = __fadd_rn(__fmul_rn(hb, xf[i]), __fmul_rn(b, k[i]));
    g[i] = sg;
  }
  __syncthreads();
}

__device__ inline void sde_stage(const VpScore& w, const ChainSmem& sm,
                                 const float* xf, const float* /*xg*/,
                                 float tf, float tg, float* k, float* g,
                                 int nrows) {
  vp_stage(w, xf, tf, tg, k, g, nrows, [&](float t) {
    chain_forward(w, sm.w, xf, t, sm.act, k, nrows);
  });
}

// ------------------------------------------------------------ the TF32 tier
// Offsets (floats) of each layer's fragment copy of A = W_l[0:d_l]ᵀ (d_{l+1}
// × d_l, the time row left out) in the network's fragment copies, and
// their total.
struct ScoreFragLayout {
  int off[kChainMaxLayers];
  int n;
};

template <int R, int T, bool TR>
__host__ __device__ inline ScoreFragLayout score_frags(
    const DenseChainT<R, T, TR>& w) {
  ScoreFragLayout f;
  f.n = 0;
  for (int l = 0; l < w.L; ++l) {
    f.off[l] = f.n;
    f.n += static_cast<int>(frag_floats(w.dims[l + 1], w.dims[l]));
  }
  return f;
}

// Stage every layer's fragment copy at frag (16-byte aligned) from the
// weights in global memory. The caller synchronises.
template <int R, int T, bool TR>
__device__ inline void stage_score_frags(const DenseChainT<R, T, TR>& w,
                                         const ScoreFragLayout& fl,
                                         float* frag) {
  for (int l = 0; l < w.L; ++l)
    stage_frag(reinterpret_cast<uint4*>(frag + fl.off[l]), w.wp[l],
               w.dims[l + 1], w.dims[l], 1, w.dims[l + 1]);
}

// chain_forward at the TF32 tier, the same contract, for at most 8 rows:
// layer l's d_{l+1} outputs in m-tiles of 16, m-tile mt on warp mt mod
// (T / 32), the R rows the tile's columns; each output's k-chain in order,
// then the time term, the bias and tanh in FP32.
template <int R, int T, bool TR>
__device__ inline void chain_forward_tf32(const DenseChainT<R, T, TR>& w,
                                          const float* W, const float* frag,
                                          const ScoreFragLayout& fl,
                                          const float* x, float t,
                                          float* acts, float* out,
                                          int nrows) {
  static_assert(R <= 8, "the rows are the columns of one m16n8k8 tile");
  const int F = w.F, M = chain_stride(w), warp = threadIdx.x >> 5;
  float* a0 = chain_act(w, acts, 0);
  for (int i = threadIdx.x; i < R * F; i += T) {
    const int r = i / F, c = i - r * F;
    const float v = x[r * F + c];
    a0[r * M + c] = w.lead ? tanhf(v) : v;
  }
  __syncthreads();
  for (int l = 0; l < w.L; ++l) {
    const int din = w.dims[l], dout = w.dims[l + 1];
    const float* Wl = W + w.off[l];
    const float* bl = Wl + (din + TR) * dout;
    const float* ain = chain_act(w, acts, l);
    float* aout = chain_act(w, acts, l + 1);
    const bool tanh_l = (w.acts >> l) & 1u;
    const bool last = l == w.L - 1;
    const uint4* fr = reinterpret_cast<const uint4*>(frag + fl.off[l]);
    for (int mt = warp; mt < frag_mtiles(dout); mt += T / 32) {
      float d[4];
      tile_tf32(fr, mt, din, ain, M, R, d);
      tile_put<R>(d, mt, dout, R, [&](int r, int o, float z) {
        if constexpr (TR) z = __fadd_rn(z, __fmul_rn(t, Wl[din * dout + o]));
        z = z + bl[o];
        if (tanh_l) z = tanhf(z);
        aout[r * M + o] = z;
        if (last && r < nrows) out[r * F + o] = z;
      });
    }
    __syncthreads();
  }
}

// Kernel 11's dynamics type at the TF32 tier: VpScore's shared memory,
// then the fragment copies (frag, laid out by fl).
struct ScoreSmemTf32 : ChainSmem {
  const float* frag;
};

struct VpScoreTf32 : ScoreNet {
  using Shared = ScoreSmemTf32;
  ScoreFragLayout fl;
};

__host__ __device__ inline size_t sde_shared_floats(const VpScoreTf32& w) {
  return round_up4(shared_floats(w)) + w.fl.n;
}

__device__ inline float* sde_carve_load(const VpScoreTf32& w, float* base,
                                        ScoreSmemTf32* s) {
  *static_cast<ChainSmem*>(s) = carve_shared(w, base);
  float* frag = base + round_up4(shared_floats(w));
  stage_score_frags(w, w.fl, frag);
  load_shared(w, *s);  // synchronises
  s->frag = frag;
  return frag + w.fl.n;
}

__device__ inline void sde_stage(const VpScoreTf32& w, const ScoreSmemTf32& sm,
                                 const float* xf, const float* /*xg*/,
                                 float tf, float tg, float* k, float* g,
                                 int nrows) {
  vp_stage(w, xf, tf, tg, k, g, nrows, [&](float t) {
    chain_forward_tf32(w, sm.w, sm.frag, w.fl, xf, t, sm.act, k, nrows);
  });
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
