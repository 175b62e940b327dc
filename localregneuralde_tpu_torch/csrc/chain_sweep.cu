// Kernel 9: the whole reverse sweep of the stored adjoint for the autonomous
// Dense chain (the latent ODE's generative dynamics), dense (two_level = 0)
// or two-level, in one launch, and the sum of its gradient partials.
//
// Replaces localregneuralde_tpu/ops/pallas/fused_solve_bwd.py::
// persistent_chain_sweep (_make_kernel with the chain hooks of
// _family_hooks: eval_keep, vjp, and the stage-batched flush). Rows are
// independent in the backward and only the weight gradients couple them.
// A CTA owns error blocks of kChainRows rows (chain_rows.cuh, kernel 5's
// blocking) and warp r of it row r of each; the warps sweep their rows
// through all accepted steps in reverse, carrying a_u (state cotangent) and
// a_k (the FSAL cotangent on the incoming k1) in the output buffers. Per
// step a warp
//   - recomputes k1 from the knot (u_j, t_j) and the six stages, keeping its
//     row's activations a_0..a_{L-1} of every stage in shared memory (the
//     stash; a_L is the stage derivative itself);
//   - seeds the stage cotangents with the saveat cotangents of the output
//     times in (t_j, t_j+1] (Tsit5 interpolant weights, computed once per
//     step for the times hit, up to kChainMaxSave) and with a_k on k7;
//   - runs the stage chain in reverse, each stage through the layers:
//     dz_l = da·act_l'(a_{l+1}) into the stash, da <- dz_l·W_lᵀ (a lane an
//     input unit), then the leading tanh;
//   - updates the carries.
// Then the CTA adds the weight gradients Σ_stages a_lᵀ·dz_l and Σ dz_l of
// its rows, batched over the six stages as the reference's flush is, into
// its partial in shared memory: the only CTA barriers of a step are the
// step's set-up and the two around this flush. A second kernel sums the
// partials in CTA order, so the gradients are the same from run to run.
// naccept is read on the device.
//
// The per-row arithmetic (the recompute, the seeding, the transposed layer
// sums with kChainAcc interleaved accumulators, the stage-input cotangents
// and the carries) is the old kernel's, expression for expression, and so
// is the order of the flush's sums over stages and rows: a_u, a_k and the
// gradients keep their bits.
//
// Two-level mode, when naccept > dense_cap: one W-step window at a time, in
// reverse, every CTA replays the window from its checkpoint with kernel 5's
// attempt (chain_rows.cuh::chain_attempt, the same function, so the replay
// repeats the forward bitwise; its rows live in shared memory, one grid
// barrier an attempt: a cooperative launch), and then sweeps it.
//
// What bounds it on an H100: serial latency, as in kernel 5. A step is 7 + 6
// chain evaluations' worth of dependent layer passes of each row (the
// recompute, and the transpose, two passes a layer) and the weight-gradient
// products (K = 6·kChainRows a weight); all operands are in shared memory,
// the weights twice (W_lᵀ for the forward, W_l for the transpose, each read
// four floats at a time along its sum). At the PhysioNet widths a CTA holds
// 139 KB, so one CTA an SM.
//
// The clocked instantiation (kTime) splits CTA 0's step by phase for
// chip_smoke.py's [chain sweep attribution]; its arithmetic is the same.
//
// The TF32 tier (the reference's 'default'), by the bits of kTiers
// (lrnde_chain_sweep_tiered): kChainTierGrad puts the transposed products
// (dz_l·W_lᵀ, a warp's row the one live column of mma.sync m16n8k8 tiles
// from fragment copies of W_l rounded once at load) and the weight
// gradients (a block's Σ over its 24 (row, stage) items of a_lᵀ·dz_l, one
// 16 × 8 tile of a gradient a warp, three k-steps, added to the CTA's
// partial in a fixed order: no atomics) on the tensor cores, as the
// reference's grad_precision=None does whatever the forward's tier;
// kChainTierRecompute the recompute of k1 and the six stages
// (chain_rows.cuh::warp_chain_tf32); kChainTierReplay the two-level
// replay, which runs kernel 5's own TF32 attempt (chain_attempt<true>), so
// it repeats a TF32 forward bitwise. The bias gradients, the seeding, the
// tanh derivatives and the carries stay FP32.
#include "chain_rows.cuh"

namespace lrnde {

constexpr int kChainMaxSave = 64;
// The tier bits of kTiers (ops/cuda/fused_mlp_bwd.py::tier_bits): a set bit
// is TF32 on mma.sync, a clear one FP32 FFMA.
constexpr int kChainTierRecompute = 1, kChainTierGrad = 2,
              kChainTierReplay = 4;

// The stash of one row and stage: a_l at aoff[l] and dz_l at zoff[l], l <
// L, each rounded up to 4 floats (the flush reads dz four outputs at a
// time; its pads stay zero); aoff[L] and zoff[L] are the totals.
struct ChainStash {
  int aoff[kChainMaxLayers + 1];
  int zoff[kChainMaxLayers + 1];
};

__host__ __device__ inline ChainStash chain_stash(const ChainNet& w) {
  ChainStash s{};
  s.aoff[0] = s.zoff[0] = 0;
  for (int l = 0; l < w.L; ++l) {
    s.aoff[l + 1] = s.aoff[l] + ((w.dims[l] + 3) & ~3);
    s.zoff[l + 1] = s.zoff[l] + ((w.dims[l + 1] + 3) & ~3);
  }
  return s;
}

__host__ __device__ inline int stash_stage_floats(const ChainNet& w,
                                                  const ChainStash& s) {
  return s.aoff[w.L] + s.zoff[w.L];
}

struct ChainSweepArgs {
  int two_level;
  ChainNet w;
  ChainLayout lay;
  ChainStash st;
  const float* knot_ts;   // (n_dense)
  const float* knot_us;   // (n_dense, B, F)
  const int* naccept;
  const float* saveat;    // (n_save)
  int n_save;
  const float* ct_ys;     // (n_save, B, F)
  const float* ct_y;      // (B, F)
  const float* ckpt_ts;   // two-level only: (n_ckpt)
  const float* ckpt_us;   // (n_ckpt, B, F)
  const float* ckpt_ks;   // (n_ckpt, B, F)
  const float* ckpt_dts;
  const float* ckpt_qolds;
  float t_end, rtol, atol;
  int max_steps, stride, dense_cap;
  float* a_u;             // (B, F)
  float* a_k;             // (B, F)
  float* part;            // (gridDim.x, n_params)
  float* slots;           // two-level: (2, n_blk)
  unsigned int* barrier;  // two-level: zero at launch
  float* local_ts;        // two-level: (gridDim.x, W + 1)
  float* local_us;        // two-level: (W + 1, B, F)
  int B;
  int J;                  // error blocks a CTA
  float inv_n;
  unsigned long long* timing;  // kTime: (kSwPhases + 1)
};

// The phases of a step (CTA 0): thread 0's set-up of the saveat hits, warp
// 0's recompute (k1, the seeding, the six stages) and transpose (with the
// carries), the CTA barrier before the flush (the other rows' lag), the
// flush, and the window replays of the two-level mode.
enum ChainSweepPhase {
  kSwSetup, kSwRecompute, kSwTranspose, kSwFlushWait, kSwFlush, kSwReplay,
  kSwPhases
};

// Shared memory of a sweep CTA (offsets in floats, all multiples of 4).
struct ChainSweepSmem {
  ChainMeta* meta;  // the layers' widths and offsets (static)
  float* W;      // the forward's weights (ChainLayout::fwd: W_lᵀ, b_l)
  float* Wr;     // the transpose's (ChainLayout::rev: W_l)
  float* g;      // the CTA's gradient partial, packed (W_0, b_0, W_1, ...)
  float* stash;  // [rows][6][stage floats]
  float* rows;   // [rows][15][F4]: k1..k7, their cotangents, d_u
  float* act;    // [rows][2][aw] a row's activations or cotangents
  float* state;  // [J][9][rows][F] the replay's rows
  float* res;    // [J][rows][F] their scaled residuals
  float* wt;     // [kChainMaxSave][7] dt·b_m(θ) of the saveat times hit
  int* hit;      // [kChainMaxSave] their indexes
  float* ffrag;  // TF32 recompute or replay: the forward's fragment copies
  float* rfrag;  // TF32 gradients: the transpose's fragment copies
};

// Floats of a sweep CTA's shared memory at J blocks; with TF32 tiers, then
// the forward's fragment copies (the recompute's or the replay's) and the
// transpose's (the gradients').
__host__ __device__ inline size_t chain_sweep_smem_floats(const ChainNet& w,
                                                          int J,
                                                          int tiers = 0) {
  const ChainStash st = chain_stash(w);
  const size_t F4 = (w.F + 3) & ~3;
  const ChainLayout lay = chain_layout(w);
  const size_t n = lay.n_fwd + lay.n_rev + round_up4(w.n_params) +
         kChainRows * (6 * static_cast<size_t>(stash_stage_floats(w, st)) +
                       15 * F4 + 2 * static_cast<size_t>(chain_act_width(w))) +
         J * (chain_block_floats(w.F) + static_cast<size_t>(kChainRows) * w.F) +
         8 * kChainMaxSave;
  if (tiers == 0) return n;
  const bool fwd = (tiers & (kChainTierRecompute | kChainTierReplay)) != 0;
  return round_up4(n) + (fwd ? chain_frag_floats(w) : 0) +
         ((tiers & kChainTierGrad) != 0 ? chain_frag_floats(w, true) : 0);
}

__device__ inline ChainSweepSmem carve_chain_sweep(const ChainNet& w,
                                                   const ChainLayout& lay,
                                                   const ChainStash& st,
                                                   float* raw, int J) {
  const int F4 = (w.F + 3) & ~3, aw = chain_act_width(w);
  ChainSweepSmem s;
  s.W = raw;
  s.Wr = s.W + lay.n_fwd;
  s.g = s.Wr + lay.n_rev;
  s.stash = s.g + round_up4(w.n_params);
  s.rows = s.stash + kChainRows * 6 * stash_stage_floats(w, st);
  s.act = s.rows + kChainRows * 15 * F4;
  s.state = s.act + kChainRows * 2 * aw;
  s.res = s.state + J * chain_block_floats(w.F);
  s.wt = s.res + J * kChainRows * w.F;
  s.hit = reinterpret_cast<int*>(s.wt + 7 * kChainMaxSave);
  s.ffrag = raw + round_up4(chain_sweep_smem_floats(w, J));
  s.rfrag = s.ffrag;  // after the forward's, where the tiers have them
  return s;
}

struct ChainStep {
  float dt;
  int n_hit;
};

// Recompute and transpose one accepted step of one row (this warp's) from
// its start state u (global, F floats) with step dt, seeded from the saveat
// cotangents in s.wt / s.hit; update the carries a_u, a_k of the row. The
// recompute and the transposed products at the tiers of kTiers.
template <int kTiers, typename Clock>
__device__ void chain_row_bwd(const ChainSweepArgs& a, const ChainSweepSmem& s,
                              int r, int row, const float* u, float dt,
                              int n_hit, Clock& clk) {
  const ChainNet& w = a.w;
  const int F = w.F, L = w.L, F4 = (F + 3) & ~3, aw = chain_act_width(w);
  const int lane = threadIdx.x & 31, SS = stash_stage_floats(w, a.st);
  const size_t BF = static_cast<size_t>(a.B) * F, on = static_cast<size_t>(row) * F;
  float* const ks = s.rows + r * 15 * F4;  // k1..k7
  float* const dks = ks + 7 * F4;          // their cotangents
  float* const du = dks + 7 * F4;
  float* const buf = s.act + r * 2 * aw;
  float* const stash = s.stash + r * 6 * SS;
  auto pingpong = [&](int l) { return buf + (l & 1) * aw; };
  constexpr bool kRecTf32 = (kTiers & kChainTierRecompute) != 0;

  // ---- k1 of the step, recomputed from its knot
  for (int c = lane; c < F; c += 32) {
    const float v = u[c];
    buf[c] = w.lead ? tanhf(v) : v;
  }
  __syncwarp();
  warp_chain_at<kRecTf32>(w, *s.meta, s.W, s.ffrag, pingpong, ks, lane);

  // ---- stage cotangents from the saveat hits, and the FSAL carry on k7
  for (int c = lane; c < F; c += 32) {
    float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int h = 0; h < n_hit; ++h) {
      const float cv = a.ct_ys[s.hit[h] * BF + on + c];
#pragma unroll
      for (int m = 0; m < 7; ++m) acc[m] = acc[m] + s.wt[h * 7 + m] * cv;
    }
    acc[6] = acc[6] + a.a_k[on + c];
#pragma unroll
    for (int m = 0; m < 7; ++m) dks[m * F4 + c] = acc[m];
  }

  // ---- forward recompute of the six stages, keeping the activations
  for (int si = 0; si < 6; ++si) {
    float* const keep = stash + si * SS;
    for (int c = lane; c < F; c += 32) {
      float acc = kA[si][0] * ks[c];
      for (int j = 1; j <= si; ++j) acc = acc + kA[si][j] * ks[j * F4 + c];
      const float v = u[c] + dt * acc;
      keep[c] = w.lead ? tanhf(v) : v;
    }
    __syncwarp();
    warp_chain_at<kRecTf32>(
        w, *s.meta, s.W, s.ffrag,
        [&](int l) { return keep + s.meta->stash[l].x; }, ks + (si + 1) * F4,
        lane);
  }
  clk.warp(kSwRecompute);

  // ---- reverse pass through the stage chain
  for (int si = 5; si >= 0; --si) {
    const float* const keep = stash + si * SS;
    float* const zs = stash + si * SS + a.st.aoff[L];
    for (int c = lane; c < F; c += 32) buf[c] = dks[(si + 1) * F4 + c];
    __syncwarp();
    int cur = 0;
    // the transpose's fragment copies, layer L - 1 first
    int rfo = static_cast<int>(chain_frag_floats(w, true));
    int4 m = s.meta->layer[L - 1];
    for (int l = L - 1; l >= 0; --l) {
      const int din = m.x, dout = m.y;
      const float* Wl = s.Wr + m.w;  // W_l's row k, four outputs at a time
      m = s.meta->layer[l > 0 ? l - 1 : 0];
      const bool tanh_l = (w.acts >> l) & 1u;
      const int2 so = s.meta->stash[l];
      const float* aout = l + 1 < L ? keep + s.meta->stash[l + 1].x
                                    : ks + (si + 1) * F4;
      const float* din_ct = pingpong(cur);
      float* dzl = zs + so.y;
      for (int o = lane; o < dout; o += 32) {
        float d = din_ct[o];
        if (tanh_l) {
          const float av = aout[o];
          d = d * (1.f - av * av);
        }
        dzl[o] = d;
      }
      __syncwarp();
      // two rows a lane, their sums interleaved, when the layer's input is
      // 33 to 64 wide
      const int ldo = chain_ld(dout);
      float* dout_ct = pingpong(cur ^ 1);
      if constexpr ((kTiers & kChainTierGrad) != 0) {
        rfo -= static_cast<int>(frag_floats(din, dout));
        const uint4* fr = reinterpret_cast<const uint4*>(s.rfrag + rfo);
        for (int mt = 0; mt < frag_mtiles(din); ++mt) {
          float d[4];
          tile_tf32(fr, mt, dout, dzl, 0, 1, d);
          tile_put<1>(d, mt, din, 1,
                      [&](int, int k, float v) { dout_ct[k] = v; });
        }
      } else if (din > 32 && din <= 64) {
        const int k1 = min(lane + 32, din - 1);
        const float* const ws[2] = {Wl + lane * ldo, Wl + k1 * ldo};
        float d[2];
        chain_dots<2>(dzl, ws, dout, d);
        dout_ct[lane] = d[0];
        if (lane + 32 < din) dout_ct[k1] = d[1];
      } else {
        for (int k = lane; k < din; k += 32)
          dout_ct[k] = chain_dot(dzl, Wl + k * ldo, dout);
      }
      __syncwarp();
      cur ^= 1;
    }
    // through the leading tanh to the stage input, whose cotangent flows to
    // u (and u_new's, at the last stage) and to the k_j it was built from
    const float* dfin = pingpong(cur);
    for (int c = lane; c < F; c += 32) {
      float dx = dfin[c];
      if (w.lead) {
        const float av = keep[c];
        dx = dx * (1.f - av * av);
      }
      if (si == 5) dx = dx + a.a_u[on + c];
      du[c] = si == 5 ? dx : du[c] + dx;
      for (int j = 0; j <= si; ++j)
        dks[j * F4 + c] = dks[j * F4 + c] + (dt * kA[si][j]) * dx;
    }
    __syncwarp();
  }

  // ---- carries: a_u <- d_u + Σ_hit ct_ys ; a_k <- d_k1
  for (int c = lane; c < F; c += 32) {
    float dint = 0.f;
    for (int h = 0; h < n_hit; ++h)
      dint = dint + a.ct_ys[s.hit[h] * BF + on + c];
    a.a_u[on + c] = du[c] + dint;
    a.a_k[on + c] = dks[c];
  }
  clk.warp(kSwTranspose);
}

// A weight gradient's block contribution at the TF32 tier: gW (din × dout)
// += Σ_e a_e ⊗ dz_e over the block's 6·kChainRows (row, stage) items e
// (stash item e = r·6 + s at e·SS: a at ao, dz at zo), one 16 × 8 tile of
// gW a warp (the items three k-steps of 8), its sums added to the CTA's
// partial by the one lane that holds them.
__device__ inline void flush_tf32(const float* stash, int SS, int ao, int zo,
                                  int din, int dout, float* gW) {
  static_assert(6 * kChainRows == 24, "three k-steps of (row, stage) items");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int Nt = (dout + 7) / 8, tiles = frag_mtiles(din) * Nt;
  for (int tile = warp; tile < tiles; tile += kChainThreads / 32) {
    const int mt = tile / Nt, nt = tile - mt * Nt;
    const int m = mt * 16 + g, n = nt * 8 + g;
    auto av = [&](int mm, int e) {
      return mm < din ? tf32_bits(stash[e * SS + ao + mm]) : 0u;
    };
    auto zv = [&](int e) {
      return n < dout ? tf32_bits(stash[e * SS + zo + n]) : 0u;
    };
    float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) {
      const int e = ks * 8 + q;
      const unsigned A[4] = {av(m, e), av(m + 8, e), av(m, e + 4),
                             av(m + 8, e + 4)};
      const unsigned Bf[2] = {zv(e), zv(e + 4)};
      mma_tf32(d, A, Bf);
    }
    // d0, d1: row m, columns nt·8 + 2q, + 1; d2, d3: row m + 8
    const int o = nt * 8 + 2 * q;
    auto add = [&](int k, int oo, float v) {
      if (k < din && oo < dout) gW[k * dout + oo] += v;
    };
    add(m, o, d[0]);
    add(m, o + 1, d[1]);
    add(m + 8, o, d[2]);
    add(m + 8, o + 1, d[3]);
  }
}

// The stage-batched weight gradients of a block's rows into the CTA's
// partial: each weight's sum over the stages, then over the kChainRows rows,
// in one fmaf chain (the old kernel's order), four outputs a thread, every
// load of the chain issued ahead of its sums. A row past the block's end
// has a zero stash (chain_sweep_range), so it adds fmaf(a, 0, acc) = acc,
// as the old kernel's zero rows did. With kChainTierGrad the weights' sums
// run on mma.sync (flush_tf32); the biases' stay FP32.
template <int kTiers>
__device__ inline void chain_flush(const ChainSweepArgs& a,
                                   const ChainSweepSmem& s) {
  const ChainNet& w = a.w;
  const int L = w.L, SS = stash_stage_floats(w, a.st);
  for (int l = 0; l < L; ++l) {
    const int din = w.dims[l], dout = w.dims[l + 1], q4 = (dout + 3) / 4;
    float* gW = s.g + w.off[l];
    float* gb = gW + din * dout;
    const int ao = a.st.aoff[l], zo = a.st.aoff[L] + a.st.zoff[l];
    if constexpr ((kTiers & kChainTierGrad) != 0) {
      flush_tf32(s.stash, SS, ao, zo, din, dout, gW);
    } else {
      for (int e = threadIdx.x; e < din * q4; e += kChainThreads) {
        const int k = e / q4, o0 = 4 * (e - k * q4);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const float* sa = s.stash + ao + k;
        const float* sz = s.stash + zo + o0;
        // two stages' loads at a time, all in flight before their sums
#pragma unroll
        for (int s2 = 0; s2 < 6; s2 += 2) {
          float av[2][kChainRows];
          float4 z[2][kChainRows];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < kChainRows; ++r) {
              const int st = (r * 6 + s2 + h) * SS;
              av[h][r] = sa[st];
              z[h][r] = *reinterpret_cast<const float4*>(sz + st);
            }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < kChainRows; ++r) {
              acc[0] = fmaf(av[h][r], z[h][r].x, acc[0]);
              acc[1] = fmaf(av[h][r], z[h][r].y, acc[1]);
              acc[2] = fmaf(av[h][r], z[h][r].z, acc[2]);
              acc[3] = fmaf(av[h][r], z[h][r].w, acc[3]);
            }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (o0 + q < dout) gW[k * dout + o0 + q] += acc[q];
      }
    }
    for (int o = threadIdx.x; o < dout; o += kChainThreads) {
      float sb = 0.f;
#pragma unroll
      for (int si = 0; si < 6; ++si) {
        float sr = 0.f;
#pragma unroll
        for (int r = 0; r < kChainRows; ++r)
          sr += s.stash[(r * 6 + si) * SS + zo + o];
        sb += sr;
      }
      gb[o] += sb;
    }
  }
}

// Transpose accepted steps n_hi-1 .. 0, whose start times are ts[j] and
// start states us + j·BF, for this CTA's blocks, at the tiers of kTiers.
template <int kTiers, typename Clock>
__device__ void chain_sweep_range(const ChainSweepArgs& a,
                                  const ChainSweepSmem& s, const ChainCta& c,
                                  ChainStep& st, int n_hi, const float* ts,
                                  const float* us, Clock& clk) {
  const int F = a.w.F, warp = threadIdx.x >> 5;
  const size_t BF = static_cast<size_t>(a.B) * F;
  for (int j = n_hi - 1; j >= 0; --j) {
    // the saveat times in (t_j, t_j+1], in index order: warp 0 tests 32 at
    // once and lane 0 writes each hit's weights
    if (warp == 0) {
      const int lane = threadIdx.x & 31;
      const float t = ts[j], tn = ts[j + 1];
      const float dt = tn - t;
      int nh = 0;
      for (int q0 = 0; q0 < a.n_save; q0 += 32) {
        const int q = q0 + lane;
        const float sv = q < a.n_save ? __ldg(a.saveat + q) : 0.f;
        unsigned int hits =
            __ballot_sync(0xffffffffu, q < a.n_save && sv > t && sv <= tn);
        while (hits != 0u) {
          const int h = __ffs(hits) - 1;
          hits &= hits - 1u;
          const float svh = __shfl_sync(0xffffffffu, sv, h);
          if (lane == 0) {
            float b[7];
            interp_weights(fminf(fmaxf((svh - t) / dt, 0.f), 1.f), b);
            for (int m = 0; m < 7; ++m) s.wt[nh * 7 + m] = dt * b[m];
            s.hit[nh] = q0 + h;
          }
          ++nh;
        }
      }
      if (lane == 0) {
        st.dt = dt;
        st.n_hit = nh;
      }
    }
    __syncthreads();
    clk.cta(kSwSetup);
    const float dt = st.dt;
    const int n_hit = st.n_hit;
    for (int b = 0; b < c.nb; ++b) {
      const int nrows = block_rows(c, b);
      const int row = (c.first + b) * kChainRows + warp;
      if (warp < nrows) {
        chain_row_bwd<kTiers>(a, s, warp, row, us + j * BF + row * F, dt,
                              n_hit, clk);
      } else {
        // a row past the batch's end (the last block): a zero stash
        float* const st = s.stash + warp * 6 * stash_stage_floats(a.w, a.st);
        for (int i = threadIdx.x & 31; i < 6 * stash_stage_floats(a.w, a.st);
             i += 32)
          st[i] = 0.f;
      }
      clk.cta(kSwFlushWait);
      __syncthreads();
      chain_flush<kTiers>(a, s);
      __syncthreads();
      clk.cta(kSwFlush);
    }
  }
}

// Replay window win of a two-level solve from its checkpoint with kernel 5's
// attempt (chain_attempt) until n_steps are accepted or max_steps
// attempted, recording the accepted states of this CTA's rows in local_us
// (W + 1, B, F) and their times in lts (thread 0 of each CTA keeps its
// own copy). Returns the number of steps accepted. kTf32: kernel 5's TF32
// attempt, from the forward's fragment copies at c.frag.
template <bool kTf32>
__device__ inline int chain_replay(const ChainSweepArgs& a,
                                   const ChainMeta& meta, const ChainCta& c,
                                   int win, int n_steps, unsigned int& epoch,
                                   ReplayCtl& rc, float* lts) {
  const ChainNet& w = a.w;
  const int F = w.F, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t BF = static_cast<size_t>(a.B) * F;
  int par = 0;
  auto each_row = [&](auto fn) {
    for (int j = 0; j < c.nb; ++j) {
      if (warp >= block_rows(c, j)) continue;
      const size_t on =
          static_cast<size_t>((c.first + j) * kChainRows + warp) * F;
      fn(on, chain_row(c.state + j * chain_block_floats(F), F, warp, par));
    }
  };
  each_row([&](size_t on, const ChainRow& p) {
    for (int i = lane; i < F; i += 32) {
      p.u[i] = a.ckpt_us[win * BF + on + i];
      p.k[0][i] = a.ckpt_ks[win * BF + on + i];
      a.local_us[on + i] = p.u[i];
    }
  });
  if (threadIdx.x == 0) {
    rc.t = a.ckpt_ts[win];
    rc.dt = a.ckpt_dts[win];
    rc.qold = a.ckpt_qolds[win];
    rc.i = rc.att = 0;
    lts[0] = rc.t;
  }
  __syncthreads();
  ChainClock<false, kCsPhases> off{nullptr};
  while (rc.i < n_steps && rc.att < a.max_steps) {
    const AttemptPlan plan = plan_attempt(rc.t, rc.dt, a.t_end);
    const float eest = chain_attempt<kTf32>(w, meta, c, par, plan.dt_c,
                                            a.atol, a.rtol, a.inv_n, a.slots,
                                            a.barrier, epoch, off);
    if (threadIdx.x == 0) {
      const bool accept = eest <= 1.f;
      float dt_acc, dt_rej, qold_acc;
      propose(eest, plan.dt_c, rc.qold, &dt_acc, &dt_rej, &qold_acc);
      rc.accept = accept;
      if (accept) {
        rc.t = plan.t_new;
        rc.dt = dt_acc;
        rc.qold = qold_acc;
        ++rc.i;
        lts[rc.i] = rc.t;
      } else {
        rc.dt = dt_rej;
      }
      ++rc.att;
    }
    __syncthreads();
    if (rc.accept) {
      par ^= 1;
      const int i = rc.i;
      each_row([&](size_t on, const ChainRow& p) {
        for (int q = lane; q < F; q += 32) a.local_us[i * BF + on + q] = p.u[q];
      });
    }
  }
  return rc.i;
}

template <bool kTime, int kTiers = 0>
__global__ void __launch_bounds__(kChainThreads)
chain_sweep_kernel(ChainSweepArgs a) {
  constexpr bool kFwdTf32 =
      (kTiers & (kChainTierRecompute | kChainTierReplay)) != 0;
  extern __shared__ float4 smem_raw[];
  __shared__ ChainMeta meta;
  __shared__ ChainStep st;
  __shared__ ReplayCtl rc;
  __shared__ unsigned long long clk_acc[kTime ? kSwPhases + 1 : 1];
  ChainClock<kTime, kSwPhases> clk{clk_acc};
  const ChainNet& w = a.w;
  const int F = w.F, B = a.B, tid = threadIdx.x;
  ChainSweepSmem s = carve_chain_sweep(
      w, a.lay, a.st, reinterpret_cast<float*>(smem_raw), a.J);
  s.meta = &meta;
  ChainCta c;
  c.W = s.W;
  c.act = s.act;
  c.aw = chain_act_width(w);
  c.state = s.state;
  c.res = s.res;
  c.n_blk = (B + kChainRows - 1) / kChainRows;
  c.first = blockIdx.x * a.J;
  c.nb = max(0, min(a.J, c.n_blk - c.first));
  c.B = B;
  const int n = *a.naccept;

  load_chain_weights(w, a.lay, s.W, s.Wr, meta);
  if constexpr (kFwdTf32) stage_chain_frags(w, s.ffrag, false);
  if constexpr ((kTiers & kChainTierGrad) != 0) {
    if constexpr (kFwdTf32) s.rfrag = s.ffrag + chain_frag_floats(w);
    stage_chain_frags(w, s.rfrag, true);
  }
  if constexpr ((kTiers & kChainTierReplay) != 0) c.frag = s.ffrag;
  for (int l = tid; l <= kChainMaxLayers; l += kChainThreads)
    meta.stash[l] = make_int2(a.st.aoff[l], a.st.zoff[l]);
  for (int e = tid; e < w.n_params; e += kChainThreads) s.g[e] = 0.f;
  const int stash = kChainRows * 6 * stash_stage_floats(w, a.st);
  for (int e = tid; e < stash; e += kChainThreads) s.stash[e] = 0.f;
  for (int r = c.first * kChainRows; r < min(B, (c.first + c.nb) * kChainRows);
       ++r) {
    for (int i = tid; i < F; i += kChainThreads) {
      a.a_u[r * F + i] = a.ct_y[r * F + i];
      a.a_k[r * F + i] = 0.f;
    }
  }
  __syncthreads();
  clk.start();

  if (!a.two_level || n <= a.dense_cap) {
    chain_sweep_range<kTiers>(a, s, c, st, n, a.knot_ts, a.knot_us, clk);
  } else {
    // ---- windowed replay from the checkpoints, last window first
    const int W = a.stride;
    float* const lts = a.local_ts + blockIdx.x * (W + 1);
    unsigned int epoch = 0;
    for (int win = (n - 1) / W; win >= 0; --win) {
      const int n_steps = min(max(n - win * W, 0), W);
      const int got = chain_replay<(kTiers & kChainTierReplay) != 0>(
          a, meta, c, win, n_steps, epoch, rc, lts);
      clk.cta(kSwReplay);
      // sweep what the replay accepted: an accept flip must not sweep
      // slots it never wrote
      chain_sweep_range<kTiers>(a, s, c, st, min(got, n_steps), lts,
                                a.local_us, clk);
    }
  }
  __syncthreads();
  float* const part = a.part + static_cast<size_t>(blockIdx.x) * w.n_params;
  for (int e = tid; e < w.n_params; e += kChainThreads) part[e] = s.g[e];
  clk.write(a.timing, n);
}

// At most this many error blocks a CTA in the two-level mode.
constexpr int kChainSweepMaxJ = 32;

// The grid of kernel 9 for B rows: dense, a CTA a block; two-level, the
// fewest blocks a CTA (J) whose grid is resident at once.
template <int kTiers = 0>
static cudaError_t chain_sweep_grid(const ChainNet& c, int B, int two_level,
                                    int* J, int* grid) {
  const int n_blk = (B + kChainRows - 1) / kChainRows;
  const void* kernel =
      reinterpret_cast<const void*>(chain_sweep_kernel<false, kTiers>);
  if (!two_level) {
    *J = 1;
    *grid = n_blk;
    int per_sm = 0;  // the opt-in above 48 KB, and the fit
    cudaError_t err = chain_occupancy(
        kernel, chain_sweep_smem_floats(c, 1, kTiers) * sizeof(float),
        &per_sm);
    if (err != cudaSuccess) return err;
    return per_sm > 0 ? cudaSuccess : cudaErrorInvalidValue;
  }
  return chain_grid(
      kernel, n_blk,
      [&](int j) { return chain_sweep_smem_floats(c, j, kTiers); },
      kChainSweepMaxJ, J, grid);
}

template <bool kTime, int kTiers = 0>
static int chain_sweep(
    int two_level, const void* const* wb, const int* dims, int L,
    unsigned int acts, int lead, const float* knot_ts, const float* knot_us,
    const int* naccept, const float* saveat, int n_save, const float* ct_ys,
    const float* ct_y, const float* ckpt_ts, const float* ckpt_us,
    const float* ckpt_ks, const float* ckpt_dts, const float* ckpt_qolds,
    float t_end, float rtol, float atol, int max_steps, int stride,
    int dense_cap, float* a_u, float* a_k, float* d_w, float* part,
    float* slots, unsigned int* barrier, float* local_ts, float* local_us,
    int B, float inv_n, unsigned long long* timing, void* stream) {
  ChainNet c;
  if (!make_chain(&c, wb, dims, L, acts, lead) || n_save > kChainMaxSave
      || (two_level && stride < 1) || B < 1 || (kTime && timing == nullptr))
    return cudaErrorInvalidValue;
  int J = 0, grid = 0;
  cudaError_t err = chain_sweep_grid<kTiers>(c, B, two_level, &J, &grid);
  if (err != cudaSuccess) return err;
  const size_t smem = chain_sweep_smem_floats(c, J, kTiers);
  auto kernel = chain_sweep_kernel<kTime, kTiers>;
  int per_sm = 0;  // the timed kernel's own opt-in
  err = chain_occupancy(reinterpret_cast<const void*>(kernel),
                        smem * sizeof(float), &per_sm);
  if (err != cudaSuccess) return err;
  ChainSweepArgs a{two_level, c, chain_layout(c), chain_stash(c), knot_ts,
                   knot_us, naccept,
                   saveat, n_save, ct_ys, ct_y, ckpt_ts, ckpt_us, ckpt_ks,
                   ckpt_dts, ckpt_qolds, t_end, rtol, atol, max_steps, stride,
                   dense_cap, a_u, a_k, part, slots, barrier, local_ts,
                   local_us, B, J, inv_n, timing};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (two_level) {
    err = launch_chain_cooperative(reinterpret_cast<const void*>(kernel), &a,
                                   grid, smem, s);
  } else {
    kernel<<<grid, kChainThreads, smem * sizeof(float), s>>>(a);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  return reduce_partials(part, grid, c.n_params, d_w, s);
}

}  // namespace lrnde

// Floats of dynamic shared memory of one kernel-9 CTA owning one error
// block (0: outside limits).
extern "C" long long lrnde_chain_sweep_smem_floats(const int* dims, int L) {
  using namespace lrnde;
  ChainNet c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_chain(&c, none, dims, L, 0u, 0)) return 0;
  return static_cast<long long>(chain_sweep_smem_floats(c, 1));
}

// The same at the tier bits `tiers` (lrnde_chain_sweep_tiered's).
extern "C" long long lrnde_chain_sweep_smem_floats_tiered(int tiers,
                                                          const int* dims,
                                                          int L) {
  using namespace lrnde;
  ChainNet c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_chain(&c, none, dims, L, 0u, 0)) return 0;
  return static_cast<long long>(chain_sweep_smem_floats(c, 1, tiers));
}

// Kernel 9's grid for B rows: out = (error blocks a CTA, CTAs, which is the
// number of gradient partials). Returns cudaGetLastError() of the occupancy
// query, or the refusal.
extern "C" int lrnde_chain_sweep_grid(const int* dims, int L, int B,
                                      int two_level, int* out) {
  using namespace lrnde;
  ChainNet c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_chain(&c, none, dims, L, 0u, 0) || B < 1)
    return cudaErrorInvalidValue;
  return chain_sweep_grid(c, B, two_level, out, out + 1);
}

// The same for the instantiation at the tier bits `tiers`.
extern "C" int lrnde_chain_sweep_grid_tiered(int tiers, const int* dims,
                                             int L, int B, int two_level,
                                             int* out) {
  using namespace lrnde;
  ChainNet c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_chain(&c, none, dims, L, 0u, 0) || B < 1)
    return cudaErrorInvalidValue;
  switch (tiers) {
    case kChainTierGrad:
      return chain_sweep_grid<kChainTierGrad>(c, B, two_level, out, out + 1);
    case kChainTierRecompute | kChainTierGrad:
      return chain_sweep_grid<kChainTierRecompute | kChainTierGrad>(
          c, B, two_level, out, out + 1);
    case kChainTierRecompute | kChainTierGrad | kChainTierReplay:
      return chain_sweep_grid<kChainTierRecompute | kChainTierGrad |
                              kChainTierReplay>(c, B, two_level, out,
                                                out + 1);
    default:
      return cudaErrorInvalidValue;
  }
}

#define LRNDE_CHAIN_SWEEP_PARAMS                                             \
  int two_level, const void* const* wb, const int* dims, int L,              \
      unsigned int acts, int lead, const float* knot_ts,                     \
      const float* knot_us, const int* naccept, const float* saveat,         \
      int n_save, const float* ct_ys, const float* ct_y,                     \
      const float* ckpt_ts, const float* ckpt_us, const float* ckpt_ks,      \
      const float* ckpt_dts, const float* ckpt_qolds, float t_end,           \
      float rtol, float atol, int max_steps, int stride, int dense_cap,      \
      float* a_u, float* a_k, float* d_w, float* part, float* slots,         \
      unsigned int* barrier, float* local_ts, float* local_us, int B,        \
      float inv_n
#define LRNDE_CHAIN_SWEEP_ARGS                                               \
  two_level, wb, dims, L, acts, lead, knot_ts, knot_us, naccept, saveat,     \
      n_save, ct_ys, ct_y, ckpt_ts, ckpt_us, ckpt_ks, ckpt_dts, ckpt_qolds,  \
      t_end, rtol, atol, max_steps, stride, dense_cap, a_u, a_k, d_w, part,  \
      slots, barrier, local_ts, local_us, B, inv_n

// The reverse sweep of the stored adjoint of the chain over *naccept
// recorded steps (dense), or, with two_level and *naccept > dense_cap, over
// windows replayed from the checkpoints. The chain is given as for
// lrnde_persistent_chain. Writes a_u, a_k and the flat weight gradient d_w
// (the packed layout W_0, b_0, W_1, ...); part holds one partial a CTA
// (lrnde_chain_sweep_grid), slots 2·ceil(B / 4) floats and local_ts one row
// of W + 1 times a CTA (two-level). At most kChainMaxSave saveat times.
// Returns cudaGetLastError().
extern "C" int lrnde_chain_sweep(LRNDE_CHAIN_SWEEP_PARAMS, void* stream) {
  return lrnde::chain_sweep<false>(LRNDE_CHAIN_SWEEP_ARGS, nullptr, stream);
}

// lrnde_chain_sweep at the product tiers `tiers` (kChainTier bits; all
// FP32 is lrnde_chain_sweep): kChainTierGrad (the reference's default-tier
// gradients behind an FP32 recompute and replay: physionet.yaml's route),
// kChainTierRecompute | kChainTierGrad (also the recompute:
// grad_precision='default'), or all three (the forward at TF32: its replay
// too, kernel 5's TF32 attempt); any other value fails with
// cudaErrorInvalidValue.
extern "C" int lrnde_chain_sweep_tiered(int tiers, LRNDE_CHAIN_SWEEP_PARAMS,
                                        void* stream) {
  using namespace lrnde;
  switch (tiers) {
    case kChainTierGrad:
      return chain_sweep<false, kChainTierGrad>(LRNDE_CHAIN_SWEEP_ARGS,
                                                nullptr, stream);
    case kChainTierRecompute | kChainTierGrad:
      return chain_sweep<false, kChainTierRecompute | kChainTierGrad>(
          LRNDE_CHAIN_SWEEP_ARGS, nullptr, stream);
    case kChainTierRecompute | kChainTierGrad | kChainTierReplay:
      return chain_sweep<false, kChainTierRecompute | kChainTierGrad |
                                    kChainTierReplay>(
          LRNDE_CHAIN_SWEEP_ARGS, nullptr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The same sweep with CTA 0's nanoseconds per phase (kSwPhases) and the
// number of steps in timing. A separate instantiation.
extern "C" int lrnde_chain_sweep_timed(LRNDE_CHAIN_SWEEP_PARAMS,
                                       unsigned long long* timing,
                                       void* stream) {
  return lrnde::chain_sweep<true>(LRNDE_CHAIN_SWEEP_ARGS, timing, stream);
}

extern "C" const char* lrnde_chain_sweep_phase_names() {
  return "step setup,recompute,transpose,flush wait,flush,window replay";
}
