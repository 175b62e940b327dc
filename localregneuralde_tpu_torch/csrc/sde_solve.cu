// Kernels 10 and 11: the whole adaptive SRI/SOSRI solve in one cooperative
// launch, with the virtual Brownian tree drawn inside, templated on the
// dynamics type: kernel 10 for the NeuralDSDE family (sde.cuh::SdeWeights),
// kernel 11 for the reverse-time VP-SDE of the score samplers
// (score.cuh::VpScore).
//
// Replaces localregneuralde_tpu/ops/pallas/fused_sde_solve.py::_make_kernel
// (families ("mlp", H), called from persistent_sde_solve, and ("vpsde",
// ...), called from persistent_vpsde_solve). On the TPU one core ran the
// accept/reject loop over the whole batch with its state in VMEM and drew
// the tree from the TPU's hardware PRNG. Here every CTA owns fixed row
// blocks of D::rows rows for the whole solve, keeps the dynamics' weights in
// shared memory, and per attempt:
//
// 1. descends the Brownian bridge to t + dt for its elements: 24 levels,
//    one Philox4x32-10 draw per level per column pair, giving W and Z of two
//    columns (sde.cuh::pair_normals). The noise is a pure function of
//    (seed, node, channel, row, column), so a retried step sees the same path
//    and the split of rows over CTAs does not matter; W/Z at the last
//    accepted time stay in global scratch, and dW = W(t + dt) − W(t);
// 2. takes the four-stage SRI step of its rows with the stage inputs and
//    k1..k4, g1..g4 in shared memory (the drift at t + c0_i·dt, the
//    diffusion at t + c1_i·dt, as sde/step.py), writes the candidate
//    state to global scratch, and stores its row block's sum of squared
//    scaled residuals (δ·E1 + E2)/(atol + max(|u|, |u_new|)·rtol) into a slot
//    of its own;
// 3. waits at the grid barrier (solve.cuh); thread 0 of every CTA then sums
//    the slots in row-block order, so every CTA reaches the same error norm,
//    accept decision and dt, with no float atomics, and the solve is
//    deterministic run to run.
//
// On accept each CTA, for its own rows: writes the saveat outputs the step
// crosses by linear interpolation, copies the step-start state to the
// reservoir when the uniform drawn for this attempt says so (uniforms drawn
// in advance by the caller; the decision is grid-uniform), records the knot
// u_new and the increments (dW, dZ) in global buffers of max_steps + 1 and
// max_steps entries, and commits u and W/Z. The first dt (one drift
// evaluation) is computed by the caller, as in the reference.
//
// What bounds kernel 10 on an H100: the tree. An attempt draws 2·24·B·F
// normals (786k at B = 512, F = 32) against 8 small products per row, so the
// noise arithmetic (Philox, the inverse CDF with its logf in the tails) and
// the latency of the grid barrier set the time per attempt; B = 512 gives
// 128 CTAs of 64 threads, one per SM. Kernel 11 (B = 4096, F = 2) draws one
// column pair a row, and its four drift evaluations are three dependent
// layer passes each (score.cuh); it records no knots and keeps no
// reservoir.
#include "score.cuh"
#include "sde.cuh"

namespace lrnde {

template <typename D>
struct SdeSolveArgs {
  const float* u0;
  const float* sc;        // t0, t_end, dt0
  const float* saveat;    // (n_save)
  int n_save;
  D w;
  uint32_t seed;
  int depth;
  float* u;               // (B, F) working state; y_final on exit
  float* ys;              // (n_save, B, F)
  int* stats_i;           // naccept, nreject, done, natt
  float* stats_f;         // t_final, reservoir_t
  float* unew;            // (B, F) candidate
  float* wz0;             // (2, B, F) W, Z at the accepted time
  float* wz1;             // (2, B, F) W, Z at the attempted time
  float* slots;           // (2, n_blocks) row-block error partials
  unsigned int* barrier;  // arrival counter, zero at launch
  const float* rand;      // (max_steps) reservoir uniforms, or null
  float* res_u;           // (B, F) reservoir sample, or null
  float* knot_ts;         // (max_steps + 1), or null: no recording
  float* knot_us;         // (max_steps + 1, B, F)
  float* knot_dws;        // (max_steps, B, F)
  float* knot_dzs;        // (max_steps, B, F)
  int B;
  int max_steps;
  float rtol, atol, delta, inv_n;
};

struct SdeCtl {
  float t, dt, qold, dt_c, t_new, tau, res_t;
  int is_last, accept, take, done, natt, nacc, nrej;
};

struct SdeStepSmem {
  float *u, *dw, *dz, *xf, *xg, *k, *g, *red;
};

// Floats of dynamic shared memory per CTA: the dynamics type's, then the
// step's row-block buffers.
template <typename D>
__host__ __device__ inline size_t sde_solve_smem_floats(const D& w) {
  const size_t RF = static_cast<size_t>(D::rows) * w.F;
  return sde_shared_floats(w) + 13 * RF + D::threads;
}

// W/Z of this CTA's elements of row block rb at normalised time tau into
// wz1; dW, dZ (against wz0) into the row block's shared buffers.
template <typename D>
__device__ void descend(const SdeSolveArgs<D>& a, const SdeStepSmem& s,
                        int rb, int nrows, float tau, float span) {
  const int F = a.w.F, P = (F + 1) / 2;
  const size_t BF = static_cast<size_t>(a.B) * F;
  for (int item = threadIdx.x; item < nrows * P; item += blockDim.x) {
    const int r = item / P, p = item - r * P;
    const int row = rb * D::rows + r;
    const float4 e = pair_normals(a.seed, p, row, 1);
    const float root = __fsqrt_rn(span);
    float wb[4] = {__fmul_rn(e.x, root), __fmul_rn(e.y, root),
                   __fmul_rn(e.z, root), __fmul_rn(e.w, root)};
    float wa[4] = {0.f, 0.f, 0.f, 0.f};
    float lo = 0.f, hi = 1.f;
    int node = 1;
    for (int lvl = 0; lvl < a.depth; ++lvl) {
      const float m = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
      const float scale =
          __fsqrt_rn(__fmul_rn(__fmul_rn(__fadd_rn(hi, -lo), 0.25f), span));
      const float4 n = pair_normals(a.seed, p, row, 2 * node + 2);
      const float eps[4] = {n.x, n.y, n.z, n.w};
      const bool right = tau >= m;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float mid = __fadd_rn(__fmul_rn(__fadd_rn(wa[c], wb[c]), 0.5f),
                                    __fmul_rn(eps[c], scale));
        if (right) wa[c] = mid; else wb[c] = mid;
      }
      if (right) lo = m; else hi = m;
      node = 2 * node + (right ? 1 : 0);
    }
    const float frac = hi > lo ? __fdiv_rn(__fadd_rn(tau, -lo), __fadd_rn(hi, -lo))
                               : 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = 2 * p + (c & 1);
      if (col >= F) continue;
      const int ch = c >> 1;  // 0: W, 1: Z
      const float v = __fadd_rn(wa[c], __fmul_rn(__fadd_rn(wb[c], -wa[c]), frac));
      const size_t o = ch * BF + static_cast<size_t>(row) * F + col;
      a.wz1[o] = v;
      (ch == 0 ? s.dw : s.dz)[r * F + col] = v - a.wz0[o];
    }
  }
}

// Stage time t + c·dt, rounded as sde/step.py rounds it.
__device__ inline float stage_time(float t, float c, float dt) {
  return __fadd_rn(t, __fmul_rn(c, dt));
}

// One SRI step of row block rb from time t; returns its Σ residual² to
// every thread.
template <typename D>
__device__ float sri_rows(const SdeSolveArgs<D>& a,
                          const typename D::Shared& w, const SdeStepSmem& s,
                          const SriTableau& T, int rb, int nrows, float t,
                          float dt) {
  const int F = a.w.F, n = nrows * F;
  const size_t off = static_cast<size_t>(rb) * D::rows * F;
  const float sqdt = sqrtf(dt);
  const float sqrt3 = LRNDE_F(1.7320508075688772);
  const int RF = D::rows * F;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s.u[i] = a.u[off + i];
    s.xf[i] = s.u[i];
    s.xg[i] = s.u[i];
  }
  __syncthreads();
  sde_stage(a.w, w, s.xf, s.xg, t, stage_time(t, T.c1[0], dt), s.k, s.g,
            nrows);
  // stage inputs in sde/step.py's order of operations
  for (int e = 1; e < 4; ++e) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float chi2 = (s.dw[i] + s.dz[i] / sqrt3) / 2.f;
      const float u = s.u[i];
      if (e == 1) {  // u + dt·a·k1 + b·χ2·g1
        s.xf[i] = u + dt * T.A0[0][0] * s.k[i] + T.B0[0][0] * chi2 * s.g[i];
        s.xg[i] = u + dt * T.A1[0][0] * s.k[i] + sqdt * T.B1[0][0] * s.g[i];
        continue;
      }
      float kf = T.A0[e - 1][0] * s.k[i], kg = T.A1[e - 1][0] * s.k[i];
      float gf = T.B0[e - 1][0] * s.g[i], gg = T.B1[e - 1][0] * s.g[i];
      for (int j = 1; j < e; ++j) {
        kf = kf + T.A0[e - 1][j] * s.k[j * RF + i];
        kg = kg + T.A1[e - 1][j] * s.k[j * RF + i];
        gf = gf + T.B0[e - 1][j] * s.g[j * RF + i];
        gg = gg + T.B1[e - 1][j] * s.g[j * RF + i];
      }
      s.xf[i] = u + dt * kf + chi2 * gf;
      s.xg[i] = u + dt * kg + sqdt * gg;
    }
    __syncthreads();
    sde_stage(a.w, w, s.xf, s.xg, stage_time(t, T.c0[e], dt),
              stage_time(t, T.c1[e], dt), s.k + e * RF, s.g + e * RF, nrows);
  }
  float err = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float dW = s.dw[i], dZ = s.dz[i], u = s.u[i];
    const float chi1 = (dW * dW - dt) / (2.f * sqdt);
    const float chi2 = (dW + dZ / sqrt3) / 2.f;
    const float chi3 = (dW * dW * dW - 3.f * dW * dt) / (6.f * dt);
    float g[4], k[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      g[e] = s.g[e * RF + i];
      k[e] = s.k[e * RF + i];
    }
    const float E2 =
        chi2 * (T.beta3[0] * g[0] + T.beta3[1] * g[1] + T.beta3[2] * g[2] +
                T.beta3[3] * g[3]) +
        chi3 * (T.beta4[0] * g[0] + T.beta4[1] * g[1] + T.beta4[2] * g[2] +
                T.beta4[3] * g[3]);
    const float un =
        u +
        dt * (T.alpha[0] * k[0] + T.alpha[1] * k[1] + T.alpha[2] * k[2] +
              T.alpha[3] * k[3]) +
        E2 +
        dW * (T.beta1[0] * g[0] + T.beta1[1] * g[1] + T.beta1[2] * g[2] +
              T.beta1[3] * g[3]) +
        chi1 * (T.beta2[0] * g[0] + T.beta2[1] * g[1] + T.beta2[2] * g[2] +
                T.beta2[3] * g[3]);
    const float E1 = dt * (k[0] + k[1] + k[2] + k[3]);
    const float res =
        (a.delta * E1 + E2) / (a.atol + fmaxf(fabsf(u), fabsf(un)) * a.rtol);
    err = fmaf(res, res, err);
    a.unew[off + i] = un;
  }
  return block_sum<D::threads>(err, s.red);
}

template <typename D, bool kSosri>
__global__ void __launch_bounds__(D::threads)
sde_solve_kernel(SdeSolveArgs<D> a) {
  constexpr int R = D::rows;
  extern __shared__ float4 smem_raw[];
  __shared__ SdeCtl ctl;
  const int F = a.w.F, B = a.B, tid = threadIdx.x;
  const int n_blocks = (B + R - 1) / R;
  const size_t BF = static_cast<size_t>(B) * F;
  const int RF = R * F;
  typename D::Shared w;
  float* p = sde_carve_load(a.w, reinterpret_cast<float*>(smem_raw), &w);
  SdeStepSmem s;
  s.u = p;
  s.dw = s.u + RF;
  s.dz = s.dw + RF;
  s.xf = s.dz + RF;
  s.xg = s.xf + RF;
  s.k = s.xg + RF;
  s.g = s.k + 4 * RF;
  s.red = s.g + 4 * RF;
  const SriTableau T = sri_tableau(kSosri);
  const float t0 = a.sc[0], t_end = a.sc[1], span = t_end - t0;
  const bool record = a.knot_ts != nullptr;

  for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
    const size_t off = static_cast<size_t>(rb) * R * F;
    const int n = min(R, B - rb * R) * F;
    for (int i = tid; i < n; i += blockDim.x) {
      const float v = a.u0[off + i];
      a.u[off + i] = v;
      a.wz0[off + i] = 0.f;
      a.wz0[BF + off + i] = 0.f;
      for (int q = 0; q < a.n_save; ++q) a.ys[q * BF + off + i] = v;
      if (a.res_u != nullptr) a.res_u[off + i] = v;
      if (record) a.knot_us[off + i] = v;
    }
  }
  if (record && blockIdx.x == 0)
    for (int i = tid; i <= a.max_steps; i += blockDim.x)
      a.knot_ts[i] = i == 0 ? t0 : t_end;
  if (tid == 0) {
    ctl.t = t0;
    ctl.dt = a.sc[2];
    ctl.qold = LRNDE_F(1e-4);
    ctl.res_t = t0;
    ctl.done = t0 >= t_end;
    ctl.natt = ctl.nacc = ctl.nrej = 0;
  }
  __syncthreads();

  unsigned int epoch = 0;
  while (!ctl.done && ctl.natt < a.max_steps) {
    if (tid == 0) {
      const AttemptPlan plan = plan_attempt(ctl.t, ctl.dt, t_end);
      ctl.dt_c = plan.dt_c;
      ctl.t_new = plan.t_new;
      ctl.is_last = plan.is_last;
      ctl.tau = fminf(fmaxf((ctl.t + plan.dt_c - t0) / span, 0.f), 1.f);
    }
    __syncthreads();
    const float t = ctl.t, dt_c = ctl.dt_c, t_new = ctl.t_new;
    float* const slot = a.slots + (epoch & 1u) * n_blocks;
    for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
      const int nrows = min(R, B - rb * R);
      descend(a, s, rb, nrows, ctl.tau, span);
      __syncthreads();
      const float err = sri_rows(a, w, s, T, rb, nrows, t, dt_c);
      if (tid == 0) __stcg(slot + rb, err);
    }
    ++epoch;
    grid_barrier(a.barrier, epoch * gridDim.x);
    if (tid == 0) {
      float err_sq = 0.f;
      for (int i = 0; i < n_blocks; ++i) err_sq += __ldcg(slot + i);
      const float eest = sqrtf(err_sq * a.inv_n);
      const bool accept = eest <= 1.f;
      float dt_acc, dt_rej, qold_acc;
      propose_sde(eest, dt_c, &dt_acc, &dt_rej, &qold_acc);
      ctl.accept = accept;
      ctl.take = accept && a.rand != nullptr &&
                 a.rand[ctl.natt] * static_cast<float>(ctl.nacc + 1) < 1.f;
      if (accept) {
        if (ctl.take) ctl.res_t = t;
        ctl.t = t_new;
        ctl.dt = dt_acc;
        ctl.qold = qold_acc;
        ctl.done = ctl.is_last;
        ++ctl.nacc;
      } else {
        ctl.dt = dt_rej;
        ++ctl.nrej;
      }
      ++ctl.natt;
    }
    __syncthreads();
    if (ctl.accept) {
      const int cnt = ctl.nacc;  // knot index of the new state
      for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
        const size_t off = static_cast<size_t>(rb) * R * F;
        const int n = min(R, B - rb * R) * F;
        for (int i = tid; i < n; i += blockDim.x) {
          const size_t o = off + i;
          const float u = a.u[o], un = a.unew[o];
          for (int q = 0; q < a.n_save; ++q) {
            const float st = a.saveat[q];
            if (!(st > t && st <= t_new)) continue;
            const float theta = fminf(fmaxf((st - t) / dt_c, 0.f), 1.f);
            a.ys[q * BF + o] = u + theta * (un - u);
          }
          if (ctl.take) a.res_u[o] = u;
          const float w1 = a.wz1[o], z1 = a.wz1[BF + o];
          if (record) {
            a.knot_us[cnt * BF + o] = un;
            a.knot_dws[(cnt - 1) * BF + o] = w1 - a.wz0[o];
            a.knot_dzs[(cnt - 1) * BF + o] = z1 - a.wz0[BF + o];
          }
          a.u[o] = un;
          a.wz0[o] = w1;
          a.wz0[BF + o] = z1;
        }
      }
      if (record && blockIdx.x == 0 && tid == 0) a.knot_ts[cnt] = t_new;
    }
    __syncthreads();
  }
  if (blockIdx.x == 0 && tid == 0) {
    a.stats_i[0] = ctl.nacc;
    a.stats_i[1] = ctl.nrej;
    a.stats_i[2] = ctl.done;
    a.stats_i[3] = ctl.natt;
    a.stats_f[0] = ctl.t;
    a.stats_f[1] = ctl.res_t;
  }
}

// Launch the solve of dynamics D (sosri: the SOSRI tableau, else SRIW1).
template <typename D>
static int launch_sde_solve(int sosri, SdeSolveArgs<D>* a, void* stream) {
  const size_t smem = sde_solve_smem_floats(a->w) * sizeof(float);
  auto kernel = sosri ? sde_solve_kernel<D, true> : sde_solve_kernel<D, false>;
  static size_t granted[2] = {0, 0};
  cudaError_t err = allow_smem(kernel, smem, &granted[sosri ? 1 : 0]);
  if (err != cudaSuccess) return err;
  return launch_cooperative<D>(kernel, a, a->B, smem,
                               static_cast<cudaStream_t>(stream), nullptr);
}

}  // namespace lrnde

// Floats of dynamic shared memory kernel 10 needs per CTA at (F, H).
extern "C" long long lrnde_sde_solve_smem_floats(int F, int H) {
  lrnde::SdeWeights w{};
  w.F = F;
  w.H = H;
  return static_cast<long long>(lrnde::sde_solve_smem_floats(w));
}

// Kernel 10: the whole adaptive SRI (sosri = 0) or SOSRI (sosri = 1) solve
// from u0 with sc = (t0, t_end, dt0) on the device. unew holds B·F floats,
// wz0 and wz1 2·B·F each, slots 2·ceil(B / 4), barrier one zeroed unsigned
// int. rand and res_u (the reservoir) and the four knot buffers may be null.
// Returns cudaGetLastError().
extern "C" int lrnde_sde_solve(
    int sosri, const float* u0, const float* sc, const float* saveat,
    int n_save, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* wd, const float* bd, unsigned int seed,
    int depth, float* u, float* ys, int* stats_i, float* stats_f,
    float* unew, float* wz0, float* wz1, float* slots, unsigned int* barrier,
    const float* rand, float* res_u, float* knot_ts, float* knot_us,
    float* knot_dws, float* knot_dzs, int B, int F, int H, int max_steps,
    float rtol, float atol, float delta, float inv_n, void* stream) {
  using namespace lrnde;
  if ((rand == nullptr) != (res_u == nullptr) || depth < 0 || depth > 30)
    return cudaErrorInvalidValue;
  SdeSolveArgs<SdeWeights> a{
      u0, sc, saveat, n_save, SdeWeights{w1, b1, w2, b2, wd, bd, F, H}, seed,
      depth, u, ys, stats_i, stats_f, unew, wz0, wz1, slots, barrier, rand,
      res_u, knot_ts, knot_us, knot_dws, knot_dzs, B, max_steps, rtol, atol,
      delta, inv_n};
  return launch_sde_solve(sosri, &a, stream);
}

// Batch rows per CTA of kernels 6 and 11.
extern "C" int lrnde_score_rows_per_block() { return lrnde::kScoreRows; }

// Floats of dynamic shared memory of one kernel-11 CTA for the score
// network of widths dims (L + 1); 0 outside the kernel's limits.
extern "C" long long lrnde_vpsde_solve_smem_floats(const int* dims, int L) {
  using namespace lrnde;
  VpScore c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_score(&c, none, dims, L, 0u, 0.f, 0.f, 0.f)) return 0;
  return static_cast<long long>(sde_solve_smem_floats(c));
}

// Kernel 11: the whole adaptive SRI or SOSRI solve of the reverse VP-SDE on
// the τ clock from u0 with sc = (t0, t_end, dt0), the score network given by
// wb (2L pointers: W_0, b_0, W_1, ...; W_l the (d_l + 1, d_{l+1}) TD
// matrix), dims (L + 1) and acts (bit l: tanh after layer l), and β(t) =
// beta_min + t·d_beta at t = t1 − τ. The buffers are kernel 10's, with slots
// 2·ceil(B / kScoreRows); no reservoir and no knots. Returns
// cudaGetLastError().
extern "C" int lrnde_vpsde_solve(
    int sosri, const float* u0, const float* sc, const float* saveat,
    int n_save, const void* const* wb, const int* dims, int L,
    unsigned int acts, float beta_min, float d_beta, float t1,
    unsigned int seed, int depth, float* u, float* ys, int* stats_i,
    float* stats_f, float* unew, float* wz0, float* wz1, float* slots,
    unsigned int* barrier, int B, int max_steps, float rtol, float atol,
    float delta, float inv_n, void* stream) {
  using namespace lrnde;
  VpScore c;
  if (!make_score(&c, wb, dims, L, acts, beta_min, d_beta, t1) || depth < 0
      || depth > 30)
    return cudaErrorInvalidValue;
  SdeSolveArgs<VpScore> a{u0, sc, saveat, n_save, c, seed, depth, u, ys,
                          stats_i, stats_f, unew, wz0, wz1, slots, barrier,
                          nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, B, max_steps, rtol, atol, delta, inv_n};
  return launch_sde_solve(sosri, &a, stream);
}
