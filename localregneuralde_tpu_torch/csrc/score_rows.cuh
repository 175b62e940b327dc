// The score network of the samplers (score.cuh::ScoreNet, a TDChain of
// biased Dense layers with a time row in every layer) a warp a group of
// rows: kernel 6's evaluator (pf_solve.cu), written for any dynamics that
// evaluates the chain at one time for a group of rows (kernel 11's drift
// can take it unchanged).
//
// Layout. Every layer's weights stay in shared memory for the whole launch
// as W_lᵀ, a row of chain_ld(d_l) floats an output unit (16-byte reads
// along k, eight lanes' reads in distinct banks), then its time row and
// its bias, each padded to 4 floats. A warp carries RW rows (kernel 6: 4)
// through the L layers with __syncwarp between passes: lane o computes
// output o (and o + 32) of every row it carries, so each weight float4 it
// loads serves all of them and each row's inputs are broadcast reads; a
// layer narrower than 32 / RW outputs gives each lane one (row, output)
// instead. Kernel 6 holds its 64 -> 64 layer's weights in registers
// (RegW64) and runs its 64 -> 2 layer with an item's accumulators on four
// lanes (split_layer). The stage input stays in its own buffer (the
// ½β(u + s) combination reads it after the last layer), the hidden
// activations ping-pong between two.
//
// Bitwise the CTA-wide evaluator (chain.cuh::chain_forward) of the kernels
// before: an output is kChainAcc = 4 interleaved FFMA accumulators over k
// in increasing k, added (0+1)+(2+3), then the time term t·W_l[d_l, o]
// rounded on its own, then the bias, then tanh, whichever lane sums it.
//
// At the TF32 tier (warp_score_rows_tf32) a warp's RW rows are RW of the
// eight columns of mma.sync m16n8k8 tiles: each layer's outputs in m-tiles
// of 16 on the warp, one k-chain each in order, the A operands from the
// fragment copies of score.cuh::stage_score_frags (rounded once at load),
// the activations rounded as they are read; then the same time term, bias
// and tanh in FP32. The 2 -> 64 and 64 -> 2 layers pad to the tile's K = 8
// and M = 16 with zeros.
#pragma once

#include "chain_rows.cuh"
#include "score.cuh"

namespace lrnde {

// Offsets of each layer's W_lᵀ (its time row and bias follow) in the
// packed shared weights, and their size.
struct ScoreLayout {
  int off[kChainMaxLayers];
  int n;
};

__host__ __device__ inline ScoreLayout score_layout(const ScoreNet& w) {
  ScoreLayout s;
  s.n = 0;
  for (int l = 0; l < w.L; ++l) {
    const int dout = w.dims[l + 1];
    s.off[l] = s.n;
    s.n += dout * chain_ld(w.dims[l]) + 2 * ((dout + 3) & ~3);
  }
  return s;
}

// Floats of a warp's stage-input row and of its activation rows (a
// chain_ld stride, so that one row's reads and four rows' reads at one k
// fall in distinct banks).
__host__ __device__ inline int score_in_width(const ScoreNet& w) {
  return (w.F + 3) & ~3;
}
__host__ __device__ inline int score_act_width(const ScoreNet& w) {
  return chain_ld(w.maxw);
}

// Each layer's (d_l, d_{l+1}, offset, tanh) in shared memory, read a layer
// ahead of the current one's sums.
struct ScoreMeta {
  int4 layer[kChainMaxLayers + 1];
};

// Copy the network into shared memory (the padding zero) and fill meta.
// T threads; the caller synchronises.
template <int T>
__device__ inline void load_score_weights(const ScoreNet& w,
                                          const ScoreLayout& lay, float* W,
                                          ScoreMeta& meta) {
  for (int l = threadIdx.x; l <= kChainMaxLayers; l += T)
    meta.layer[l] = l < w.L ? make_int4(w.dims[l], w.dims[l + 1], lay.off[l],
                                        static_cast<int>((w.acts >> l) & 1u))
                            : make_int4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < lay.n; i += T) W[i] = 0.f;
  __syncthreads();
  for (int l = 0; l < w.L; ++l) {
    const int din = w.dims[l], dout = w.dims[l + 1], ld = chain_ld(din);
    float* t = W + lay.off[l];
    float* tw = t + dout * ld;
    float* bl = tw + ((dout + 3) & ~3);
    for (int e = threadIdx.x; e < (din + 1) * dout; e += T) {
      const int k = e / dout, o = e - k * dout;
      const float v = __ldg(w.wp[l] + e);
      if (k < din)
        t[o * ld + k] = v;
      else
        tw[o] = v;
    }
    for (int o = threadIdx.x; o < dout; o += T) bl[o] = __ldg(w.bp[l] + o);
  }
}

// Float4 pairs a group's dot products load before they sum them.
constexpr int kRowsChunk = 2;

// chain_rows.cuh::chain_dots for NX rows x_r at once: fmaf(x_r[k], w_i[k],
// acc_ri[k mod 4]) over k < n in increasing k, each w_i float4 loaded once
// for all rows, then out[r][i] = (acc0 + acc1) + (acc2 + acc3).
template <int NX, int NW>
__device__ inline void rows_dots(const float* const* x, const float* const* w,
                                 int n, float (&out)[NX][NW]) {
  float a[NX][NW][4];
#pragma unroll
  for (int r = 0; r < NX; ++r)
#pragma unroll
    for (int i = 0; i < NW; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[r][i][q] = 0.f;
  auto sum = [](const float4& xv, const float4& wv, float (&acc)[4]) {
    acc[0] = fmaf(xv.x, wv.x, acc[0]);
    acc[1] = fmaf(xv.y, wv.y, acc[1]);
    acc[2] = fmaf(xv.z, wv.z, acc[2]);
    acc[3] = fmaf(xv.w, wv.w, acc[3]);
  };
  const int n4 = n >> 2;
  int c = 0;
  for (; c + kRowsChunk <= n4; c += kRowsChunk) {
    float4 wv[NW][kRowsChunk], xv[NX][kRowsChunk];
#pragma unroll
    for (int j = 0; j < kRowsChunk; ++j) {
#pragma unroll
      for (int i = 0; i < NW; ++i)
        wv[i][j] = reinterpret_cast<const float4*>(w[i])[c + j];
#pragma unroll
      for (int r = 0; r < NX; ++r)
        xv[r][j] = reinterpret_cast<const float4*>(x[r])[c + j];
    }
#pragma unroll
    for (int j = 0; j < kRowsChunk; ++j)
#pragma unroll
      for (int r = 0; r < NX; ++r)
#pragma unroll
        for (int i = 0; i < NW; ++i) sum(xv[r][j], wv[i][j], a[r][i]);
  }
  for (; c < n4; ++c) {
    float4 wv[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i)
      wv[i] = reinterpret_cast<const float4*>(w[i])[c];
#pragma unroll
    for (int r = 0; r < NX; ++r) {
      const float4 xv = reinterpret_cast<const float4*>(x[r])[c];
#pragma unroll
      for (int i = 0; i < NW; ++i) sum(xv, wv[i], a[r][i]);
    }
  }
  const int rem = n & 3;
  if (rem != 0) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const float4 wv = reinterpret_cast<const float4*>(w[i])[n4];
#pragma unroll
      for (int r = 0; r < NX; ++r) {
        const float4 xv = reinterpret_cast<const float4*>(x[r])[n4];
        a[r][i][0] = fmaf(xv.x, wv.x, a[r][i][0]);
        if (rem > 1) a[r][i][1] = fmaf(xv.y, wv.y, a[r][i][1]);
        if (rem > 2) a[r][i][2] = fmaf(xv.z, wv.z, a[r][i][2]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NX; ++r)
#pragma unroll
    for (int i = 0; i < NW; ++i)
      out[r][i] = (a[r][i][0] + a[r][i][1]) + (a[r][i][2] + a[r][i][3]);
}

// A lane's weights of one 64 -> 64 layer held in registers for the whole
// launch (W_lᵀ rows o and o + 32 of lane o): layer l of the network, or
// none (l < 0, or the type without them).
struct RegW64 {
  static constexpr bool kOn = true;
  int l;
  float w[2][64];
};
struct NoRegW {
  static constexpr bool kOn = false;
  int l;
  float w[1][1];
};

// Fill a lane's register weights from the shared W_lᵀ of layer reg.l.
template <typename RegW>
__device__ __forceinline__ void load_reg_weights(const ScoreLayout& lay,
                                                 const float* W, RegW& reg,
                                                 int lane) {
  if constexpr (RegW::kOn) {
    if (reg.l < 0) return;
    const float* Wt = W + lay.off[reg.l];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 64; ++k)
        reg.w[i][k] = Wt[(lane + 32 * i) * chain_ld(64) + k];
  }
}

// rows_dots<NX, 2> of a 64-input layer against the lane's register
// weights: the same accumulators in the same order.
template <int NX>
__device__ __forceinline__ void reg_dots(const float* const* x,
                                         const float (&w)[2][64],
                                         float (&out)[NX][2]) {
  float a[NX][2][4];
#pragma unroll
  for (int r = 0; r < NX; ++r)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[r][i][q] = 0.f;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
#pragma unroll
    for (int r = 0; r < NX; ++r) {
      const float4 xv = reinterpret_cast<const float4*>(x[r])[c];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        a[r][i][0] = fmaf(xv.x, w[i][4 * c], a[r][i][0]);
        a[r][i][1] = fmaf(xv.y, w[i][4 * c + 1], a[r][i][1]);
        a[r][i][2] = fmaf(xv.z, w[i][4 * c + 2], a[r][i][2]);
        a[r][i][3] = fmaf(xv.w, w[i][4 * c + 3], a[r][i][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NX; ++r)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      out[r][i] = (a[r][i][0] + a[r][i][1]) + (a[r][i][2] + a[r][i][3]);
}

// A layer of at most two outputs for four rows (the score's last, whose
// eight (row, output) items would leave 24 of 32 lanes idle a lane an
// item), each item's four accumulators on four lanes: lane (g, q) = (lane /
// 4, lane % 4) sums accumulator q of item g = (row g / dout, output g %
// dout), the inputs k ≡ q (mod 4) in increasing k; two butterfly additions
// give (a0 + a1) + (a2 + a3) in each of the four lanes (IEEE addition
// commutes), and lane q = 0 finishes the item: chain_forward's sum, every
// read one shared-memory wavefront (W_lᵀ rows and activation rows of
// chain_ld floats).
template <typename Finish>
__device__ __forceinline__ void split_layer(const float* ain, int iw,
                                            const float* Wt, int ld, int din,
                                            int dout, int lane,
                                            Finish finish) {
  constexpr unsigned kFull = 0xffffffffu;
  const int q = lane & 3, g = lane >> 2;
  const int r = g / dout, o = g - r * dout;
  const bool on = g < 4 * dout;
  float a = 0.f;
  if (on)
    for (int k = q; k < din; k += 4)
      a = fmaf(ain[r * iw + k], Wt[o * ld + k], a);
  a = a + __shfl_xor_sync(kFull, a, 1);
  a = a + __shfl_xor_sync(kFull, a, 2);
  if (on && q == 0) finish(r, o, a);
}

// The attribution phases of a score evaluation (kernel 6's clocked
// instantiation): the first layer, the hidden ones, the last with the
// caller's epilogue.
enum ScorePhase { kScLayerIn, kScLayerMid, kScLayerOut };

// One evaluation of the chain at time t for the warp's RW rows, their
// inputs in xs (a row of xw floats each), the hidden activations through
// act (two buffers of RW rows of aw floats): each layer's outputs through
// fin(r, o, z), z the output after the time term, the bias and the
// activation; the last layer's for rows r < nrows only, the others' into
// act. A 64 -> 64 layer reg.l takes its weights from reg; with kSplit
// (four rows a warp) a layer of at most two outputs runs through
// split_layer, the others a lane an output. clk.warp(p0 + ScorePhase)
// after each layer. The caller __syncwarp()s after xs is written; this
// returns after a __syncwarp.
template <int RW, bool kSplit, typename RegW, typename Clock, typename Fin>
__device__ __forceinline__ void warp_score_rows(
    const ScoreNet& w, const ScoreMeta& meta, const float* W,
    const float* xs, int xw, float* act, int aw, float t, int nrows,
    int lane, const RegW& reg, Clock& clk, int p0, Fin fin) {
  const int L = w.L;
  int4 m = meta.layer[0];
  for (int l = 0; l < L; ++l) {
    const int din = m.x, dout = m.y, ld = chain_ld(din);
    const float* Wt = W + m.z;
    const bool tanh_l = m.w != 0;
    m = meta.layer[l + 1];
    const float* tw = Wt + dout * ld;
    const float* bl = tw + ((dout + 3) & ~3);
    const float* ain = l == 0 ? xs : act + ((l - 1) & 1) * RW * aw;
    const int iw = l == 0 ? xw : aw;
    float* aout = act + (l & 1) * RW * aw;
    const bool last = l + 1 == L;
    auto finish = [&](int r, int o, float z) {
      z = __fadd_rn(z, __fmul_rn(t, tw[o]));
      z = z + bl[o];
      if (tanh_l) z = tanhf(z);
      if (!last)
        aout[r * aw + o] = z;
      else if (r < nrows)
        fin(r, o, z);
    };
    const float* xr[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) xr[r] = ain + r * iw;
    if constexpr (RegW::kOn) {
      if (l == reg.l) {
        // the 64 -> 64 layer from the lane's registers
        float z[RW][2];
        reg_dots<RW>(xr, reg.w, z);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          finish(r, lane, z[r][0]);
          finish(r, lane + 32, z[r][1]);
        }
        __syncwarp();
        clk.warp(p0 + (l == 0 ? kScLayerIn : last ? kScLayerOut
                                                  : kScLayerMid));
        continue;
      }
    }
    if constexpr (kSplit && RW == 4) {
      if (dout <= 2) {
        split_layer(ain, iw, Wt, ld, din, dout, lane, finish);
        __syncwarp();
        clk.warp(p0 + (l == 0 ? kScLayerIn : last ? kScLayerOut
                                                  : kScLayerMid));
        continue;
      }
    }
    if (dout * RW <= 32) {
      // one (row, output) a lane
      if (lane < dout * RW) {
        const int r = lane / dout, o = lane - r * dout;
        finish(r, o, chain_dot(ain + r * iw, Wt + o * ld, din));
      }
    } else if (dout > 32 && dout <= 64) {
      // two outputs a lane for every row: lanes past the second output
      // repeat the layer's last one and store nothing
      const int o1 = min(lane + 32, dout - 1);
      const float* const ws[2] = {Wt + lane * ld, Wt + o1 * ld};
      float z[RW][2];
      rows_dots<RW, 2>(xr, ws, din, z);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        finish(r, lane, z[r][0]);
        if (lane + 32 < dout) finish(r, o1, z[r][1]);
      }
    } else {
      for (int o = lane; o < dout; o += 32) {
        const float* const ws[1] = {Wt + o * ld};
        float z[RW][1];
        rows_dots<RW, 1>(xr, ws, din, z);
#pragma unroll
        for (int r = 0; r < RW; ++r) finish(r, o, z[r][0]);
      }
    }
    __syncwarp();
    clk.warp(p0 + (l == 0 ? kScLayerIn : last ? kScLayerOut : kScLayerMid));
  }
}

// warp_score_rows at the TF32 tier: the same contract (no register weights,
// no split layer), each layer's products on the warp's mma.sync tiles from
// the fragment copies at frag (laid out by fl).
template <int RW, typename Clock, typename Fin>
__device__ __forceinline__ void warp_score_rows_tf32(
    const ScoreNet& w, const ScoreMeta& meta, const float* W,
    const float* frag, const ScoreFragLayout& fl, const float* xs, int xw,
    float* act, int aw, float t, int nrows, Clock& clk, int p0, Fin fin) {
  const int L = w.L;
  for (int l = 0; l < L; ++l) {
    const int4 m = meta.layer[l];
    const int din = m.x, dout = m.y, ld = chain_ld(din);
    const float* tw = W + m.z + dout * ld;
    const float* bl = tw + ((dout + 3) & ~3);
    const bool tanh_l = m.w != 0;
    const float* ain = l == 0 ? xs : act + ((l - 1) & 1) * RW * aw;
    const int iw = l == 0 ? xw : aw;
    float* aout = act + (l & 1) * RW * aw;
    const bool last = l + 1 == L;
    const uint4* fr = reinterpret_cast<const uint4*>(frag + fl.off[l]);
    for (int mt = 0; mt < frag_mtiles(dout); ++mt) {
      float d[4];
      tile_tf32(fr, mt, din, ain, iw, RW, d);
      tile_put<RW>(d, mt, dout, RW, [&](int r, int o, float z) {
        z = __fadd_rn(z, __fmul_rn(t, tw[o]));
        z = z + bl[o];
        if (tanh_l) z = tanhf(z);
        if (!last)
          aout[r * aw + o] = z;
        else if (r < nrows)
          fin(r, o, z);
      });
    }
    __syncwarp();
    clk.warp(p0 + (l == 0 ? kScLayerIn : last ? kScLayerOut : kScLayerMid));
  }
}

}  // namespace lrnde
