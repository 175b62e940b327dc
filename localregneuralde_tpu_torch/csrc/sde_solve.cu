// Kernels 10 and 11: the whole adaptive SRI/SOSRI solve in one cooperative
// launch, with the virtual Brownian tree drawn inside, templated on the
// dynamics type: kernel 10 for the NeuralDSDE family (sde.cuh::SdeNet),
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
//    accepted time stay in global scratch, and dW = W(t + dt) − W(t). When
//    a row block has fewer column pairs than the CTA has threads (kernel
//    11: 8 of 128, kernel 10: 64 of 384) the walk to τ is taken once and the
//    levels' draws spread over all threads (descend);
// 2. takes the four-stage SRI step of its rows with the stage inputs and
//    k1..k4, g1..g4 in shared memory (the drift at t + c0_i·dt, the
//    diffusion at t + c1_i·dt, as sde/step.py), writes the candidate
//    state to global scratch, and stores its row block's sum of squared
//    scaled residuals (δ·E1 + E2)/(atol + max(|u|, |u_new|)·rtol) into a slot
//    of its own;
// 3. waits at the grid barrier (solve.cuh); every CTA then sums the slots in
//    row-block order (solve.cuh::ordered_slot_sum: the loads in parallel,
//    the additions in order), so every CTA reaches the same error norm,
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
// What bounds kernel 10 on an H100: latency. An attempt draws 2·25·B·F
// normals (819k at B = 512, F = 32; ~0.8 µs of the card's FP32 and INT32
// pipes) against 8 small products per row, and B = 512 gives 128 CTAs, one
// an SM, so each SM has one row block's dependent chain in flight. The first
// port ran a CTA of 64 threads: each walked its own (column pair, row) down
// the tree, 25 Philox draws and 100 inverse CDFs in one chain, and summed
// its stage outputs four or two at a time. The Hopper design keeps the row
// blocks, the shared-memory layout and every sum, and gives the CTA twelve
// warps (SdeNet, sde.cuh): the descent takes its buffered form (the levels'
// draws spread over all 384 threads), a stage's hidden outputs run on eight
// warps beside the diffusion outputs on four (sde.cuh::sde_stage_eval, the
// evaluator kernel 12 shares), and the error partial is the first port's
// 64-thread sum emulated by one warp (tdmlp.cuh::warp_block_sum_sq), so
// every output keeps its bits. Kernel 11 (B = 4096, F = 2) draws one
// column pair a row, and its four drift evaluations are three dependent
// layer passes each (score.cuh); it records no knots and keeps no
// reservoir. Its split per attempt on an H100 (the timed instantiation,
// chip_smoke.py's attribution phase) was 34 µs of slot sum and 20 of
// descent of ~99 before the parallel slot loads and the spread descent;
// the layer passes of its four stages now take most of an attempt.
//
// Kernel 10 at the TF32 tier (sde.cuh::SdeNetTf32, lrnde_sde_solve_tf32) is
// the same kernel with the stage evaluator's products on mma.sync m16n8k8:
// the weights rounded once into fragment copies beside the FP32 layout;
// the draws, the stage combinations, the error partial (still the first
// port's 64-thread order) and the controller are the FP32 kernel's. Kernel
// 11 at the TF32 tier (score.cuh::VpScoreTf32, lrnde_vpsde_solve_tf32) is
// kernel 11 with its layers' products on mma.sync, its eight rows a CTA the
// columns of each tile.
#include <type_traits>

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
  const unsigned int* seed;  // the tree's Philox key word, in device memory
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
  unsigned long long* timing;  // (kPhases + 1) of the timed instantiation
  int B;
  int max_steps;
  float rtol, atol, delta, inv_n;
};

struct SdeCtl {
  float t, dt, qold, dt_c, t_new, tau, res_t;
  int is_last, accept, take, done, natt, nacc, nrej;
};

// The attribution phases of one attempt, timed by CTA 0's thread 0 on
// %globaltimer in the instantiation with kTime (chip_smoke.py's K10 and K11
// attribution phases only): the descent's walk to τ, its draws and its
// combination of the levels with the increments (the buffered descent; the
// other counts as the last), the four stages, the residual and slot store,
// the grid barrier's wait, the slot sum with the controller, the commit,
// and the plan of the next attempt.
enum SdePhase {
  kPhWalk, kPhDraws, kPhDescent, kPhStage1, kPhStage2, kPhStage3, kPhStage4,
  kPhSlotStore, kPhBarrier, kPhSlotSum, kPhCommit, kPhPlan, kPhases
};

template <bool kOn>
struct PhaseClock {
  unsigned long long last = 0, acc[kPhases] = {};
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ bool owner() const { return blockIdx.x == 0 && threadIdx.x == 0; }
  __device__ void start() {
    if constexpr (kOn) if (owner()) last = now();
  }
  __device__ void mark(int phase) {
    if constexpr (kOn) {
      if (owner()) {
        const unsigned long long t = now();
        acc[phase] += t - last;
        last = t;
      }
    }
  }
  // per-phase nanoseconds, then the attempt count
  __device__ void write(unsigned long long* out, int natt) const {
    if constexpr (kOn) {
      if (owner()) {
        for (int i = 0; i < kPhases; ++i) out[i] = acc[i];
        out[kPhases] = static_cast<unsigned long long>(natt);
      }
    }
  }
};

struct SdeStepSmem {
  float *u, *dw, *dz, *xf, *xg, *k, *g, *red;
  float4* nrm;  // the descent's normals: [level][row][column pair]
};

// Deepest Brownian tree the kernel takes (the wrappers' default is 24).
constexpr int kMaxDepth = 30;

// The bridge's walk to τ, the same for every row (τ is grid-uniform):
// per level the child taken and the bridge scale, and the last cell.
struct DescentPath {
  int node[kMaxDepth + 1];     // the node drawn at each level (level 0: 1)
  float scale[kMaxDepth + 1];  // the bridge scale of levels 1..depth
  unsigned int right;          // bit l - 1: level l went right
  float lo, hi;                // the last cell
};

// The descent's normals a CTA keeps (float4s): one per (column pair, row,
// level) when a row block has fewer column pairs than the CTA has threads
// (kernel 11: 8 of 128, kernel 10: 64 of 384), else none, and each thread
// descends whole (column pair, row) items on its own.
template <typename D>
__host__ __device__ inline int descent_buffer(const D& w) {
  const int items = D::rows * ((w.F + 1) / 2);
  return items < D::threads ? items * (kMaxDepth + 1) : 0;
}

// Kernel 10's own forms of the shared code (kernel 11 keeps the first
// port's): the walk to τ on one warp's lanes, and the error partial of the
// first port's 64 threads emulated by one warp.
template <typename D>
constexpr bool kWideSde = false;
template <int kF, int kH>
constexpr bool kWideSde<SdeNet<kF, kH>> = true;
template <int kF, int kH>
constexpr bool kWideSde<SdeNetTf32<kF, kH>> = true;
template <typename D>
constexpr bool kTf32Sde = false;
template <int kF, int kH>
constexpr bool kTf32Sde<SdeNetTf32<kF, kH>> = true;

// Floats of dynamic shared memory per CTA: the dynamics type's, then the
// step's row-block buffers (the last one the block reduction's, or kernel
// 10's scaled residuals), then the descent's normals.
template <typename D>
__host__ __device__ inline size_t sde_solve_smem_floats(const D& w) {
  const size_t RF = static_cast<size_t>(D::rows) * w.F;
  const size_t red = RF > D::threads ? RF : D::threads;
  return round_up4(sde_shared_floats(w) + 13 * RF + red)
       + 4 * static_cast<size_t>(descent_buffer(w));
}

// W/Z of row block rb at normalised time tau into wz1; dW, dZ (against
// wz0) into the row block's shared buffers: a bridge descent of a.depth
// levels per (column pair, row), then linear interpolation in the last
// cell. Synchronises the CTA.
//
// With a descent buffer (descent_buffer), three phases, each the work of
// the whole CTA: thread 0 walks the bridge to τ (the walk does not depend on
// the row: τ is grid-uniform); every thread draws its share of the (column
// pair, row, level) normals, all independent, into shared memory; one
// thread per (column pair, row) combines its levels in order. Without one,
// each thread walks and draws its items level by level. Both round every
// operation alike, so W and Z are the same bits either way.
template <typename D, typename Clock>
__device__ void descend(const SdeSolveArgs<D>& a, const SdeStepSmem& s,
                        DescentPath& path, int rb, int nrows, float tau,
                        float span, uint32_t seed, Clock& clock) {
  const int F = a.w.F, P = (F + 1) / 2, depth = a.depth;
  const int items = nrows * P;
  const size_t BF = static_cast<size_t>(a.B) * F;
  const bool buffered = items * (depth + 1) <= descent_buffer(a.w);
  if (buffered && kWideSde<D>) {
    // kernel 10: lane l of warp 0 walks to level l, keeping that level's
    // cell, and takes its bridge scale, so the 30 square roots run side by
    // side (the same operations as one thread's walk)
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      float lo = 0.f, hi = 1.f, my_lo = 0.f, my_hi = 1.f;
      int node = 1, my_node = 1;
      unsigned int right = 0u;
      for (int lvl = 0; lvl < depth; ++lvl) {
        if (lvl == lane) {
          my_lo = lo;
          my_hi = hi;
          my_node = node;
        }
        const float m = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
        const bool r = tau >= m;
        if (r) lo = m; else hi = m;
        right |= (r ? 1u : 0u) << lvl;
        node = 2 * node + (r ? 1 : 0);
      }
      if (lane < depth) {
        path.scale[lane + 1] = __fsqrt_rn(
            __fmul_rn(__fmul_rn(__fadd_rn(my_hi, -my_lo), 0.25f), span));
        path.node[lane + 1] = 2 * my_node + 2;
      }
      if (lane == 0) {
        path.node[0] = 1;
        path.right = right;
        path.lo = lo;
        path.hi = hi;
      }
    }
  } else if (buffered) {
    if (threadIdx.x == 0) {
      float lo = 0.f, hi = 1.f;
      int node = 1;
      unsigned int right = 0u;
      path.node[0] = 1;
      for (int lvl = 0; lvl < depth; ++lvl) {
        const float m = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
        path.scale[lvl + 1] =
            __fsqrt_rn(__fmul_rn(__fmul_rn(__fadd_rn(hi, -lo), 0.25f), span));
        path.node[lvl + 1] = 2 * node + 2;
        const bool r = tau >= m;
        if (r) lo = m; else hi = m;
        right |= (r ? 1u : 0u) << lvl;
        node = 2 * node + (r ? 1 : 0);
      }
      path.right = right;
      path.lo = lo;
      path.hi = hi;
    }
  }
  if (buffered) {
    __syncthreads();
    clock.mark(kPhWalk);
    for (int d = threadIdx.x; d < items * (depth + 1); d += blockDim.x) {
      const int lvl = d / items, item = d - lvl * items;
      const int r = item / P, p = item - r * P;
      s.nrm[d] = pair_normals(seed, p, rb * D::rows + r, path.node[lvl]);
    }
    __syncthreads();
    clock.mark(kPhDraws);
  }
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int r = item / P, p = item - r * P;
    const int row = rb * D::rows + r;
    const float4 e = buffered ? s.nrm[item] : pair_normals(seed, p, row, 1);
    const float root = __fsqrt_rn(span);
    float wb[4] = {__fmul_rn(e.x, root), __fmul_rn(e.y, root),
                   __fmul_rn(e.z, root), __fmul_rn(e.w, root)};
    float wa[4] = {0.f, 0.f, 0.f, 0.f};
    float lo = 0.f, hi = 1.f;
    int node = 1;
    for (int lvl = 0; lvl < depth; ++lvl) {
      float scale;
      bool right;
      float4 n;
      if (buffered) {
        scale = path.scale[lvl + 1];
        right = (path.right >> lvl) & 1u;
        n = s.nrm[(lvl + 1) * items + item];
      } else {
        const float m = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
        scale = __fsqrt_rn(__fmul_rn(__fmul_rn(__fadd_rn(hi, -lo), 0.25f), span));
        n = pair_normals(seed, p, row, 2 * node + 2);
        right = tau >= m;
        if (right) lo = m; else hi = m;
        node = 2 * node + (right ? 1 : 0);
      }
      const float eps[4] = {n.x, n.y, n.z, n.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float mid = __fadd_rn(__fmul_rn(__fadd_rn(wa[c], wb[c]), 0.5f),
                                    __fmul_rn(eps[c], scale));
        if (right) wa[c] = mid; else wb[c] = mid;
      }
    }
    if (buffered) {
      lo = path.lo;
      hi = path.hi;
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
  __syncthreads();
}

// Stage time t + c·dt, rounded as sde/step.py rounds it.
__device__ inline float stage_time(float t, float c, float dt) {
  return __fadd_rn(t, __fmul_rn(c, dt));
}

// One SRI step of row block rb from time t; returns its Σ residual² in
// thread 0, summed as the kernel's first port summed it: kernel 11 as its
// CTA does (block_sum over its threads), kernel 10's twelve warps as the
// first port's 64 threads did (one warp emulating them).
template <typename D, typename Clock>
__device__ float sri_rows(const SdeSolveArgs<D>& a,
                          const typename D::Shared& w, const SdeStepSmem& s,
                          const SriTableau& T, int rb, int nrows, float t,
                          float dt, Clock& clock) {
  const int F = a.w.F, n = nrows * F;
  const size_t off = static_cast<size_t>(rb) * D::rows * F;
  const float sqdt = sqrtf(dt);
  const float sqrt3 = LRNDE_F(1.7320508075688772);
  const int RF = D::rows * F;
  constexpr int PT = kWideSde<D> ? kSdeOldThreads : D::threads;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s.u[i] = a.u[off + i];
    s.xf[i] = s.u[i];
    s.xg[i] = s.u[i];
  }
  __syncthreads();
  sde_stage(a.w, w, s.xf, s.xg, t, stage_time(t, T.c1[0], dt), s.k, s.g,
            nrows);
  clock.mark(kPhStage1);
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
    clock.mark(kPhStage1 + e);
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
    if constexpr (PT == D::threads)
      err = fmaf(res, res, err);
    else
      s.red[i] = res;
    a.unew[off + i] = un;
  }
  if constexpr (PT == D::threads) {
    return block_sum<D::threads>(err, s.red);
  } else {
    __syncthreads();
    return threadIdx.x < 32 ? warp_block_sum_sq<PT>(s.red, n, threadIdx.x)
                            : 0.f;
  }
}

template <typename D, bool kSosri, bool kTime>
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
  {  // the normals start 16-byte aligned
    const float* base = reinterpret_cast<const float*>(smem_raw);
    const size_t o = round_up4(s.red + D::threads - base);
    s.nrm = reinterpret_cast<float4*>(reinterpret_cast<float*>(smem_raw) + o);
  }
  __shared__ DescentPath path;
  const SriTableau T = sri_tableau(kSosri);
  const float t0 = a.sc[0], t_end = a.sc[1], span = t_end - t0;
  // read at launch, so a replayed graph draws the seed of its replay
  const uint32_t seed = *a.seed;
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
  PhaseClock<kTime> clock;
  clock.start();
  while (!ctl.done && ctl.natt < a.max_steps) {
    if (tid == 0) {
      const AttemptPlan plan = plan_attempt(ctl.t, ctl.dt, t_end);
      ctl.dt_c = plan.dt_c;
      ctl.t_new = plan.t_new;
      ctl.is_last = plan.is_last;
      ctl.tau = fminf(fmaxf((ctl.t + plan.dt_c - t0) / span, 0.f), 1.f);
    }
    __syncthreads();
    clock.mark(kPhPlan);
    const float t = ctl.t, dt_c = ctl.dt_c, t_new = ctl.t_new;
    float* const slot = a.slots + (epoch & 1u) * n_blocks;
    for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
      const int nrows = min(R, B - rb * R);
      descend(a, s, path, rb, nrows, ctl.tau, span, seed, clock);
      clock.mark(kPhDescent);
      const float err = sri_rows(a, w, s, T, rb, nrows, t, dt_c, clock);
      if (tid == 0) __stcg(slot + rb, err);
      clock.mark(kPhSlotStore);
    }
    ++epoch;
    grid_barrier(a.barrier, epoch * gridDim.x);
    clock.mark(kPhBarrier);
    const float err_sq = ordered_slot_sum<D::threads>(slot, n_blocks);
    if (tid == 0) {
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
    clock.mark(kPhSlotSum);
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
    clock.mark(kPhCommit);
  }
  clock.write(a.timing, ctl.natt);
  if (blockIdx.x == 0 && tid == 0) {
    a.stats_i[0] = ctl.nacc;
    a.stats_i[1] = ctl.nrej;
    a.stats_i[2] = ctl.done;
    a.stats_i[3] = ctl.natt;
    a.stats_f[0] = ctl.t;
    a.stats_f[1] = ctl.res_t;
  }
}

// Launch the solve of dynamics D (sosri: the SOSRI tableau, else SRIW1);
// kTime: the instantiation that times the attempt's phases into a->timing.
template <typename D, bool kTime = false>
static int launch_sde_solve(int sosri, SdeSolveArgs<D>* a, void* stream) {
  const size_t smem = sde_solve_smem_floats(a->w) * sizeof(float);
  auto kernel = sosri ? sde_solve_kernel<D, true, kTime>
                      : sde_solve_kernel<D, false, kTime>;
  static size_t granted[2] = {0, 0};
  cudaError_t err = allow_smem(kernel, smem, &granted[sosri ? 1 : 0]);
  if (err != cudaSuccess) return err;
  return launch_cooperative<D>(kernel, a, a->B, smem,
                               static_cast<cudaStream_t>(stream), nullptr);
}

}  // namespace lrnde

// Floats of dynamic shared memory kernel 10 needs per CTA at (F, H).
extern "C" long long lrnde_sde_solve_smem_floats(int F, int H) {
  lrnde::SdeNet<0, 0> w{};
  w.F = F;
  w.H = H;
  return static_cast<long long>(lrnde::sde_solve_smem_floats(w));
}

// The same at the TF32 tier: the forward's fragment copies beside the
// weights.
extern "C" long long lrnde_sde_solve_smem_floats_tf32(int F, int H) {
  lrnde::SdeNetTf32<0, 0> w{};
  w.F = F;
  w.H = H;
  return static_cast<long long>(lrnde::sde_solve_smem_floats(w));
}

// Threads of a kernel-10 CTA.
extern "C" int lrnde_sde_solve_threads() { return lrnde::kSdeThreads; }

// Kernel 10's grid for B rows at (F, H): out = (CTAs, CTAs an SM resident
// at its shared memory), the CTAs looping over the row blocks past the
// resident ones. Returns the occupancy query's error.
extern "C" int lrnde_sde_solve_grid(int F, int H, int B, int* out) {
  using namespace lrnde;
  SdeNet<0, 0> w{};
  w.F = F;
  w.H = H;
  const size_t smem = sde_solve_smem_floats(w) * sizeof(float);
  const bool mnist = F == 32 && H == 64;
  const void* kernel =
      mnist ? reinterpret_cast<const void*>(
                  sde_solve_kernel<SdeNet<32, 64>, true, false>)
            : reinterpret_cast<const void*>(
                  sde_solve_kernel<SdeNet<0, 0>, true, false>);
  static size_t granted[2] = {0, 0};
  cudaError_t err = allow_smem(kernel, smem, &granted[mnist ? 1 : 0]);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kSdeThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = min((B + kSdeRows - 1) / kSdeRows, per_sm * n_sm);
  out[1] = per_sm;
  return cudaSuccess;
}

// Kernel 10: the whole adaptive SRI (sosri = 0) or SOSRI (sosri = 1) solve
// from u0 with sc = (t0, t_end, dt0) on the device. unew holds B·F floats,
// wz0 and wz1 2·B·F each, slots 2·ceil(B / 4), barrier one zeroed unsigned
// int, seed the Brownian tree's Philox key word (one unsigned int in device
// memory, read at launch, so a captured launch takes each replay's seed).
// rand and res_u (the reservoir) and the four knot buffers may be null.
// Returns cudaGetLastError().
#define LRNDE_SDE_SOLVE_PARAMS                                              \
  int sosri, const float *u0, const float *sc, const float *saveat,         \
      int n_save, const float *w1, const float *b1, const float *w2,        \
      const float *b2, const float *wd, const float *bd,                    \
      const unsigned int *seed, int depth, float *u, float *ys,             \
      int *stats_i, float *stats_f,                                         \
      float *unew, float *wz0, float *wz1, float *slots,                    \
      unsigned int *barrier, const float *rand, float *res_u,               \
      float *knot_ts, float *knot_us, float *knot_dws, float *knot_dzs,     \
      int B, int F, int H, int max_steps, float rtol, float atol,           \
      float delta, float inv_n
#define LRNDE_SDE_SOLVE_ARGS                                                \
  sosri, u0, sc, saveat, n_save, w1, b1, w2, b2, wd, bd, seed, depth, u,    \
      ys, stats_i, stats_f, unew, wz0, wz1, slots, barrier, rand, res_u,    \
      knot_ts, knot_us, knot_dws, knot_dzs, B, F, H, max_steps, rtol, atol, \
      delta, inv_n

namespace lrnde {

static int sde_solve(LRNDE_SDE_SOLVE_PARAMS, bool tf32,
                     unsigned long long* timing, void* stream) {
  if ((rand == nullptr) != (res_u == nullptr) || depth < 0 || depth > kMaxDepth)
    return cudaErrorInvalidValue;
  const SdeWeights w{w1, b1, w2, b2, wd, bd, F, H};
  auto run = [&](auto net) {
    using D = decltype(net);
    SdeSolveArgs<D> a{
        u0, sc, saveat, n_save, net, seed, depth, u, ys, stats_i, stats_f,
        unew, wz0, wz1, slots, barrier, rand, res_u, knot_ts, knot_us,
        knot_dws, knot_dzs, timing, B, max_steps, rtol, atol, delta, inv_n};
    if constexpr (kTf32Sde<D>)  // no clocked TF32 instantiation
      return launch_sde_solve<D, false>(sosri, &a, stream);
    else
      return timing == nullptr ? launch_sde_solve<D, false>(sosri, &a, stream)
                               : launch_sde_solve<D, true>(sosri, &a, stream);
  };
  // experiments/mnist_sde/mlp.yaml's widths at compile time
  const bool mnist = F == 32 && H == 64;
  if (tf32)
    return mnist ? run(SdeNetTf32<32, 64>{w}) : run(SdeNetTf32<0, 0>{w});
  return mnist ? run(SdeNet<32, 64>{w}) : run(SdeNet<0, 0>{w});
}

}  // namespace lrnde

extern "C" int lrnde_sde_solve(LRNDE_SDE_SOLVE_PARAMS, void* stream) {
  return lrnde::sde_solve(LRNDE_SDE_SOLVE_ARGS, false, nullptr, stream);
}

// Kernel 10 at the TF32 tier (the reference's 'default'): lrnde_sde_solve's
// contract, every drift and diffusion product on the tensor cores
// (sde.cuh::sde_stage_eval_tf32) on operands rounded to TF32, accumulated
// in FP32; the stage combinations, the error norm and the tree FP32.
extern "C" int lrnde_sde_solve_tf32(LRNDE_SDE_SOLVE_PARAMS, void* stream) {
  return lrnde::sde_solve(LRNDE_SDE_SOLVE_ARGS, true, nullptr, stream);
}

// Kernel 10 with its attempt's phases timed (sde_solve.cu's SdePhase, CTA
// 0's nanoseconds summed over the attempts, then the attempt count, in
// timing): a separate instantiation; the untimed kernel carries no clock.
extern "C" int lrnde_sde_solve_timed(LRNDE_SDE_SOLVE_PARAMS,
                                     unsigned long long* timing,
                                     void* stream) {
  if (timing == nullptr) return cudaErrorInvalidValue;
  return lrnde::sde_solve(LRNDE_SDE_SOLVE_ARGS, false, timing, stream);
}

// Batch rows per CTA of kernel 11.
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

// The same at the TF32 tier: the layers' fragment copies beside the
// weights.
extern "C" long long lrnde_vpsde_solve_smem_floats_tf32(const int* dims,
                                                        int L) {
  using namespace lrnde;
  VpScoreTf32 c;
  const void* none[2 * kChainMaxLayers] = {};
  if (!make_score(&c, none, dims, L, 0u, 0.f, 0.f, 0.f)) return 0;
  c.fl = score_frags(c);
  return static_cast<long long>(sde_solve_smem_floats(c));
}

// Kernel 11: the whole adaptive SRI or SOSRI solve of the reverse VP-SDE on
// the τ clock from u0 with sc = (t0, t_end, dt0), the score network given by
// wb (2L pointers: W_0, b_0, W_1, ...; W_l the (d_l + 1, d_{l+1}) TD
// matrix), dims (L + 1) and acts (bit l: tanh after layer l), and β(t) =
// beta_min + t·d_beta at t = t1 − τ. The buffers are kernel 10's, with slots
// 2·ceil(B / kScoreRows); no reservoir and no knots. Returns
// cudaGetLastError().
static int vpsde_solve(
    int sosri, const float* u0, const float* sc, const float* saveat,
    int n_save, const void* const* wb, const int* dims, int L,
    unsigned int acts, float beta_min, float d_beta, float t1,
    const unsigned int* seed, int depth, float* u, float* ys, int* stats_i,
    float* stats_f, float* unew, float* wz0, float* wz1, float* slots,
    unsigned int* barrier, int B, int max_steps, float rtol, float atol,
    float delta, float inv_n, unsigned long long* timing, bool tf32,
    void* stream) {
  using namespace lrnde;
  VpScoreTf32 c;
  if (!make_score(&c, wb, dims, L, acts, beta_min, d_beta, t1) || depth < 0
      || depth > kMaxDepth || (tf32 && timing != nullptr))
    return cudaErrorInvalidValue;
  auto run = [&](auto net) {
    using D = decltype(net);
    SdeSolveArgs<D> a{u0, sc, saveat, n_save, net, seed, depth, u, ys,
                      stats_i, stats_f, unew, wz0, wz1, slots, barrier,
                      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      timing, B, max_steps, rtol, atol, delta, inv_n};
    if constexpr (std::is_same_v<D, VpScoreTf32>)  // no clocked TF32 kernel
      return launch_sde_solve<D, false>(sosri, &a, stream);
    else
      return timing == nullptr ? launch_sde_solve<D, false>(sosri, &a, stream)
                               : launch_sde_solve<D, true>(sosri, &a, stream);
  };
  if (tf32) {
    c.fl = score_frags(c);
    return run(c);
  }
  VpScore fp;
  static_cast<ScoreNet&>(fp) = c;
  return run(fp);
}

extern "C" int lrnde_vpsde_solve(
    int sosri, const float* u0, const float* sc, const float* saveat,
    int n_save, const void* const* wb, const int* dims, int L,
    unsigned int acts, float beta_min, float d_beta, float t1,
    const unsigned int* seed, int depth, float* u, float* ys, int* stats_i,
    float* stats_f, float* unew, float* wz0, float* wz1, float* slots,
    unsigned int* barrier, int B, int max_steps, float rtol, float atol,
    float delta, float inv_n, void* stream) {
  return vpsde_solve(sosri, u0, sc, saveat, n_save, wb, dims, L, acts,
                     beta_min, d_beta, t1, seed, depth, u, ys, stats_i,
                     stats_f, unew, wz0, wz1, slots, barrier, B, max_steps,
                     rtol, atol, delta, inv_n, nullptr, false, stream);
}

// Kernel 11 at the TF32 tier (the reference's 'default', which its sampler
// takes): lrnde_vpsde_solve's contract, every layer's product on the tensor
// cores (score.cuh::chain_forward_tf32) on operands rounded to TF32,
// accumulated in FP32; the time terms, the biases, the drift's β
// arithmetic, the error norm and the tree FP32.
extern "C" int lrnde_vpsde_solve_tf32(
    int sosri, const float* u0, const float* sc, const float* saveat,
    int n_save, const void* const* wb, const int* dims, int L,
    unsigned int acts, float beta_min, float d_beta, float t1,
    const unsigned int* seed, int depth, float* u, float* ys, int* stats_i,
    float* stats_f, float* unew, float* wz0, float* wz1, float* slots,
    unsigned int* barrier, int B, int max_steps, float rtol, float atol,
    float delta, float inv_n, void* stream) {
  return vpsde_solve(sosri, u0, sc, saveat, n_save, wb, dims, L, acts,
                     beta_min, d_beta, t1, seed, depth, u, ys, stats_i,
                     stats_f, unew, wz0, wz1, slots, barrier, B, max_steps,
                     rtol, atol, delta, inv_n, nullptr, true, stream);
}

// Kernel 11 with its attempt's phases timed: lrnde_vpsde_solve's contract,
// plus timing (kPhases + 1 unsigned 64-bit integers): CTA 0's nanoseconds
// in each phase of sde_solve.cu's SdePhase, summed over the attempts, then
// the attempt count. A separate instantiation; the untimed kernel carries
// no clock reads.
extern "C" int lrnde_vpsde_solve_timed(
    int sosri, const float* u0, const float* sc, const float* saveat,
    int n_save, const void* const* wb, const int* dims, int L,
    unsigned int acts, float beta_min, float d_beta, float t1,
    const unsigned int* seed, int depth, float* u, float* ys, int* stats_i,
    float* stats_f, float* unew, float* wz0, float* wz1, float* slots,
    unsigned int* barrier, int B, int max_steps, float rtol, float atol,
    float delta, float inv_n, unsigned long long* timing, void* stream) {
  if (timing == nullptr) return cudaErrorInvalidValue;
  return vpsde_solve(sosri, u0, sc, saveat, n_save, wb, dims, L, acts,
                     beta_min, d_beta, t1, seed, depth, u, ys, stats_i,
                     stats_f, unew, wz0, wz1, slots, barrier, B, max_steps,
                     rtol, atol, delta, inv_n, timing, false, stream);
}

// The number of attribution phases of lrnde_vpsde_solve_timed.
extern "C" int lrnde_sde_phases() { return lrnde::kPhases; }
