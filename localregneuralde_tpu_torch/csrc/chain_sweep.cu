// Kernel 9: the whole reverse sweep of the stored adjoint for the autonomous
// Dense chain (the latent ODE's generative dynamics), dense (two_level = 0)
// or two-level, in one launch, and the sum of its gradient partials.
//
// Replaces localregneuralde_tpu/ops/pallas/fused_solve_bwd.py::
// persistent_chain_sweep (_make_kernel with the chain hooks of
// _family_hooks: eval_keep, vjp, and the stage-batched flush). As in kernels
// 7 and 8 (adjoint_sweep.cu), rows are independent in the backward and only
// the weight gradients couple them: each CTA sweeps its row blocks
// (kChainRows rows, the forward's blocking) through all accepted steps in
// reverse, carrying a_u (state cotangent) and a_k (the FSAL cotangent on the
// incoming k1) in the output buffers. Per step and row block it
//   - recomputes k1 from the knot (u_j, t_j) and the six stages, keeping
//     every layer's activation a_0..a_L of every stage in shared memory;
//   - seeds the stage cotangents with the saveat cotangents of the output
//     times in (t_j, t_j+1] (Tsit5 interpolant weights, computed per step
//     for the times hit only, in shared memory; up to kChainMaxSave times)
//     and with a_k on k7;
//   - runs the stage chain in reverse, each stage's vjp through the layers:
//     dz_l = da·act_l'(a_{l+1}), da <- dz_l·W_lᵀ, then the leading tanh;
//   - adds the weight gradients Σ_stages a_lᵀ·dz_l and Σ dz_l, batched over
//     the six stages as the reference's flush is, into the CTA's partial in
//     shared memory.
// A second kernel sums the partials in CTA order, so the gradients are the
// same from run to run. naccept is read on the device.
//
// Two-level mode, when naccept > dense_cap: one W-step window at a time, in
// reverse, every CTA replays the window from its checkpoint with kernel 5's
// own attempt (solve.cuh::replay_window over attempt_eest<DenseChain>, at
// kernel 5's row blocking, one grid barrier per attempt: a cooperative
// launch), so the replay repeats the forward bitwise, and then sweeps it.
//
// What bounds it on an H100: serial latency, as in kernel 5. A step is
// 7 + 6 chain evaluations' worth of dependent layer passes (the recompute,
// and the transpose, which has two passes per layer) and the weight-gradient
// products (K = 6·kChainRows per weight); all operands are in shared memory.
#include "chain.cuh"
#include "solve.cuh"
#include "tsit5_bwd.cuh"

namespace lrnde {

constexpr int kChainMaxSave = 64;

struct ChainSweepArgs {
  int two_level;
  DenseChain w;
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
  float* scratch;         // two-level: 9 (B, F) replay buffers
  float* part;            // (gridDim.x, n_params)
  float* slots;           // two-level: (2, n_blocks)
  unsigned int* barrier;  // two-level: zero at launch
  float* local_ts;        // two-level: (gridDim.x, W + 1)
  float* local_us;        // two-level: (W + 1, B, F)
  int B;
  float inv_n;
};

// Shared memory of a sweep CTA: the forward's (ChainSmem), then the
// backward's buffers.
struct ChainBwdSmem {
  ChainSmem base;
  float* g;     // [n_params] the CTA's gradient partial
  float* keep;  // [6][L + 1][rows][stride] stage activations a_0..a_L
  float* dz;    // [6][L][rows][stride] layer cotangents before W_l
  float* ks;    // [7][rows][F] k1..k7 of the row block
  float* dks;   // [7][rows][F] their cotangents
  float* du;    // [rows][F]
  float* da;    // [2][rows][stride] the cotangent flowing down the layers
  float* wt;    // [kChainMaxSave][7] dt·b_m(θ) of the saveat times hit
  int* hit;     // [kChainMaxSave] their indexes
};

__host__ __device__ inline size_t chain_bwd_smem_floats(const DenseChain& w) {
  const size_t RM = static_cast<size_t>(kChainRows) * chain_stride(w);
  const size_t RF = static_cast<size_t>(kChainRows) * w.F;
  return shared_floats(w) + w.n_params + 6 * (w.L + 1) * RM + 6 * w.L * RM
       + 15 * RF + 2 * RM + 8 * kChainMaxSave;
}

__device__ inline ChainBwdSmem carve_chain_bwd(const DenseChain& w,
                                               float* raw) {
  const size_t RM = static_cast<size_t>(kChainRows) * chain_stride(w);
  const size_t RF = static_cast<size_t>(kChainRows) * w.F;
  ChainBwdSmem s;
  s.base = carve_shared(w, raw);
  s.g = raw + shared_floats(w);
  s.keep = s.g + w.n_params;
  s.dz = s.keep + 6 * (w.L + 1) * RM;
  s.ks = s.dz + 6 * w.L * RM;
  s.dks = s.ks + 7 * RF;
  s.du = s.dks + 7 * RF;
  s.da = s.du + RF;
  s.wt = s.da + 2 * RM;
  s.hit = reinterpret_cast<int*>(s.wt + 7 * kChainMaxSave);
  return s;
}

struct ChainStep {
  float t, dt;
  int n_hit;
};

// Transpose one accepted step of the row block at off (nrows rows) from its
// start state u (row-major, stride F) with step dt, seeded from the saveat
// cotangents in bs.wt / bs.hit, and update the carries a_u, a_k.
__device__ void chain_step_bwd(const ChainSweepArgs& a, const ChainBwdSmem& bs,
                               const float* u, size_t off, int nrows,
                               float dt, int n_hit) {
  constexpr int R = kChainRows, T = kChainThreads;
  const DenseChain& w = a.w;
  const int F = w.F, M = chain_stride(w), L = w.L, tid = threadIdx.x;
  const int RF = R * F, RM = R * M;
  const size_t BF = static_cast<size_t>(a.B) * F;
  float* const xs = bs.base.xs;

  // ---- k1 of the step, recomputed from its knot
  for (int i = tid; i < RF; i += T) {
    const int r = i / F, c = i - r * F;
    xs[c * R + r] = r < nrows ? u[i] : 0.f;
  }
  __syncthreads();
  chain_forward(w, bs.base.w, xs, 1, R, 0.f, bs.base.act, false, bs.ks,
                nrows);

  // ---- stage cotangents from the saveat hits, and the FSAL carry on k7
  for (int i = tid; i < RF; i += T) {
    const int r = i / F;
    float acc[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < nrows) {
      for (int h = 0; h < n_hit; ++h) {
        const float cv = a.ct_ys[bs.hit[h] * BF + off + i];
#pragma unroll
        for (int m = 0; m < 7; ++m) acc[m] = acc[m] + bs.wt[h * 7 + m] * cv;
      }
      acc[6] = acc[6] + a.a_k[off + i];
    }
#pragma unroll
    for (int m = 0; m < 7; ++m) bs.dks[m * RF + i] = acc[m];
  }

  // ---- forward recompute of the six stages, keeping the activations
  for (int si = 0; si < 6; ++si) {
    for (int i = tid; i < RF; i += T) {
      const int r = i / F, c = i - r * F;
      float v = 0.f;
      if (r < nrows) {
        float acc = kA[si][0] * bs.ks[i];
        for (int j = 1; j <= si; ++j) acc = acc + kA[si][j] * bs.ks[j * RF + i];
        v = u[i] + dt * acc;
      }
      xs[c * R + r] = v;
    }
    __syncthreads();
    chain_forward(w, bs.base.w, xs, 1, R, 0.f, bs.keep + si * (L + 1) * RM,
                  true, bs.ks + (si + 1) * RF, nrows);
  }

  // ---- reverse pass through the stage chain
  for (int si = 5; si >= 0; --si) {
    const float* keep = bs.keep + si * (L + 1) * RM;
    for (int i = tid; i < RF; i += T) {
      const int r = i / F, c = i - r * F;
      bs.da[r * M + c] = bs.dks[(si + 1) * RF + i];
    }
    __syncthreads();
    int cur = 0;
    for (int l = L - 1; l >= 0; --l) {
      const int din = w.dims[l], dout = w.dims[l + 1];
      const bool tanh_l = (w.acts >> l) & 1u;
      const float* aout = keep + (l + 1) * RM;
      const float* din_ct = bs.da + cur * RM;
      float* dzl = bs.dz + (si * L + l) * RM;
      for (int i = tid; i < R * dout; i += T) {
        const int r = i / dout, o = i - r * dout;
        float d = din_ct[r * M + o];
        if (tanh_l) {
          const float av = aout[r * M + o];
          d = d * (1.f - av * av);
        }
        dzl[r * M + o] = d;
      }
      __syncthreads();
      const float* Wl = bs.base.w + w.off[l];
      float* dout_ct = bs.da + (cur ^ 1) * RM;
      for (int i = tid; i < R * din; i += T) {
        const int r = i / din, k = i - r * din;
        const float* wrow = Wl + k * dout;
        const float* z = dzl + r * M;
        float acc[kChainAcc] = {0.f, 0.f, 0.f, 0.f};
        for (int o = 0; o < dout; o += kChainAcc) {
#pragma unroll
          for (int q = 0; q < kChainAcc; ++q)
            if (o + q < dout) acc[q] = fmaf(z[o + q], wrow[o + q], acc[q]);
        }
        dout_ct[r * M + k] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
      __syncthreads();
      cur ^= 1;
    }
    // through the leading tanh to the stage input, whose cotangent flows to
    // u (and u_new's, at the last stage) and to the k_j it was built from
    const float* dfin = bs.da + cur * RM;
    for (int i = tid; i < nrows * F; i += T) {
      const int r = i / F, c = i - r * F;
      float dx = dfin[r * M + c];
      if (w.lead) {
        const float av = keep[r * M + c];
        dx = dx * (1.f - av * av);
      }
      if (si == 5) dx = dx + a.a_u[off + i];
      bs.du[i] = si == 5 ? dx : bs.du[i] + dx;
      for (int j = 0; j <= si; ++j)
        bs.dks[j * RF + i] = bs.dks[j * RF + i] + (dt * kA[si][j]) * dx;
    }
    __syncthreads();
  }

  // ---- stage-batched weight gradients into the CTA's partial (rows past
  // nrows carry zero cotangents)
  for (int l = 0; l < L; ++l) {
    const int din = w.dims[l], dout = w.dims[l + 1];
    float* gW = bs.g + w.off[l];
    float* gb = gW + din * dout;
    for (int e = tid; e < din * dout; e += T) {
      const int k = e / dout, o = e - k * dout;
      float acc = 0.f;
      for (int si = 0; si < 6; ++si) {
        const float* al = bs.keep + (si * (L + 1) + l) * RM;
        const float* dzl = bs.dz + (si * L + l) * RM;
#pragma unroll
        for (int r = 0; r < R; ++r) acc = fmaf(al[r * M + k], dzl[r * M + o], acc);
      }
      gW[e] += acc;
    }
    for (int o = tid; o < dout; o += T) {
      float sb = 0.f;
      for (int si = 0; si < 6; ++si) {
        const float* dzl = bs.dz + (si * L + l) * RM;
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) s += dzl[r * M + o];
        sb += s;
      }
      gb[o] += sb;
    }
  }

  // ---- carries: a_u <- d_u + Σ_hit ct_ys ; a_k <- d_k1
  for (int i = tid; i < nrows * F; i += T) {
    float dint = 0.f;
    for (int h = 0; h < n_hit; ++h)
      dint = dint + a.ct_ys[bs.hit[h] * BF + off + i];
    a.a_u[off + i] = bs.du[i] + dint;
    a.a_k[off + i] = bs.dks[i];
  }
  __syncthreads();
}

// Transpose accepted steps n_hi-1 .. 0 whose start times are ts[j] and start
// states us + j·BF, for this CTA's row blocks.
__device__ void chain_sweep_range(const ChainSweepArgs& a,
                                  const ChainBwdSmem& bs, ChainStep& st,
                                  int n_hi, const float* ts, const float* us) {
  constexpr int R = kChainRows;
  const int F = a.w.F, B = a.B;
  const int n_blocks = (B + R - 1) / R;
  const size_t BF = static_cast<size_t>(B) * F;
  for (int j = n_hi - 1; j >= 0; --j) {
    if (threadIdx.x == 0) {
      const float t = ts[j], tn = ts[j + 1];
      const float dt = tn - t;
      int nh = 0;
      for (int s = 0; s < a.n_save; ++s) {
        const float sv = a.saveat[s];
        if (!(sv > t && sv <= tn)) continue;
        float b[7];
        interp_weights(fminf(fmaxf((sv - t) / dt, 0.f), 1.f), b);
        for (int m = 0; m < 7; ++m) bs.wt[nh * 7 + m] = dt * b[m];
        bs.hit[nh++] = s;
      }
      st.t = t;
      st.dt = dt;
      st.n_hit = nh;
    }
    __syncthreads();
    const float dt = st.dt;
    const int n_hit = st.n_hit;
    for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
      const size_t off = static_cast<size_t>(rb) * R * F;
      chain_step_bwd(a, bs, us + j * BF + off, off, min(R, B - rb * R), dt,
                     n_hit);
    }
  }
}

__global__ void __launch_bounds__(kChainThreads)
chain_sweep_kernel(ChainSweepArgs a) {
  constexpr int R = kChainRows, T = kChainThreads;
  extern __shared__ float4 smem_raw[];
  __shared__ ChainStep st;
  __shared__ ReplayCtl ctl;
  const int F = a.w.F, B = a.B, tid = threadIdx.x;
  const ChainBwdSmem bs =
      carve_chain_bwd(a.w, reinterpret_cast<float*>(smem_raw));
  const size_t BF = static_cast<size_t>(B) * F;
  const int n = *a.naccept;

  for (int e = tid; e < a.w.n_params; e += T) bs.g[e] = 0.f;
  load_shared(a.w, bs.base);
  const int n_blocks = (B + R - 1) / R;
  for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
    const size_t off = static_cast<size_t>(rb) * R * F;
    const int m = min(R, B - rb * R) * F;
    for (int i = tid; i < m; i += T) {
      a.a_u[off + i] = a.ct_y[off + i];
      a.a_k[off + i] = 0.f;
    }
  }
  __syncthreads();

  if (!a.two_level || n <= a.dense_cap) {
    chain_sweep_range(a, bs, st, n, a.knot_ts, a.knot_us);
  } else {
    // ---- windowed replay from the checkpoints, last window first
    const int W = a.stride;
    float* const lts = a.local_ts + blockIdx.x * (W + 1);
    const AttemptBufs bufs{a.scratch, a.scratch + BF, a.scratch + 8 * BF,
                           BF, B};
    unsigned int epoch = 0;
    for (int win = (n - 1) / W; win >= 0; --win) {
      const int n_steps = min(max(n - win * W, 0), W);
      const int got = replay_window(
          a.w, bs.base, bufs, a.ckpt_ts, a.ckpt_us, a.ckpt_ks, a.ckpt_dts,
          a.ckpt_qolds, win, n_steps, a.max_steps, a.t_end, a.atol, a.rtol,
          a.inv_n, a.slots, a.barrier, epoch, ctl, lts, a.local_us);
      // sweep what the replay accepted: an accept flip must not sweep
      // slots it never wrote
      chain_sweep_range(a, bs, st, min(got, n_steps), lts, a.local_us);
    }
  }
  __syncthreads();
  float* const part = a.part + static_cast<size_t>(blockIdx.x) * a.w.n_params;
  for (int e = tid; e < a.w.n_params; e += T) part[e] = bs.g[e];
}

}  // namespace lrnde

// Floats of dynamic shared memory of one kernel-9 CTA (0: outside limits).
extern "C" long long lrnde_chain_sweep_smem_floats(const int* dims, int L) {
  using namespace lrnde;
  DenseChain c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_chain(&c, none, dims, L, 0u, 0)) return 0;
  return static_cast<long long>(chain_bwd_smem_floats(c));
}

// The reverse sweep of the stored adjoint of the chain over *naccept
// recorded steps (dense), or, with two_level and *naccept > dense_cap, over
// windows replayed from the checkpoints. The chain is given as for
// lrnde_persistent_chain. Writes a_u, a_k and the flat weight gradient d_w
// (the packed layout W_0, b_0, W_1, ...); part holds ceil(B / kChainRows)
// partials; scratch 9·B·F floats (two-level). At most kChainMaxSave saveat
// times. Returns cudaGetLastError().
extern "C" int lrnde_chain_sweep(
    int two_level, const void* const* wb, const int* dims, int L,
    unsigned int acts, int lead, const float* knot_ts, const float* knot_us,
    const int* naccept, const float* saveat, int n_save, const float* ct_ys,
    const float* ct_y, const float* ckpt_ts, const float* ckpt_us,
    const float* ckpt_ks, const float* ckpt_dts, const float* ckpt_qolds,
    float t_end, float rtol, float atol, int max_steps, int stride,
    int dense_cap, float* a_u, float* a_k, float* d_w, float* scratch,
    float* part, float* slots, unsigned int* barrier, float* local_ts,
    float* local_us, int B, float inv_n, void* stream) {
  using namespace lrnde;
  DenseChain c;
  if (!make_chain(&c, wb, dims, L, acts, lead) || n_save > kChainMaxSave
      || (two_level && stride < 1))
    return cudaErrorInvalidValue;
  ChainSweepArgs a{two_level, c, knot_ts, knot_us, naccept, saveat, n_save,
                   ct_ys, ct_y, ckpt_ts, ckpt_us, ckpt_ks, ckpt_dts,
                   ckpt_qolds, t_end, rtol, atol, max_steps, stride,
                   dense_cap, a_u, a_k, scratch, part, slots, barrier,
                   local_ts, local_us, B, inv_n};
  const size_t smem = chain_bwd_smem_floats(c) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(chain_sweep_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = (B + kChainRows - 1) / kChainRows;
  if (two_level) {
    err = launch_cooperative<DenseChain>(chain_sweep_kernel, &a, B, smem, s,
                                         &grid);
  } else {
    chain_sweep_kernel<<<grid, kChainThreads, smem, s>>>(a);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  return reduce_partials(part, grid, c.n_params, d_w, s);
}
