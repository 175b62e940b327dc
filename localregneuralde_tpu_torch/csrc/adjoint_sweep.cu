// Kernels 7 and 8: the whole reverse sweep of the stored adjoint for the
// TD-MLP dynamics, dense (two_level = 0) or two-level, in one launch.
//
// Replaces localregneuralde_tpu/ops/pallas/fused_solve_bwd.py::_make_kernel
// (called from persistent_stored_sweep and persistent_two_level_sweep). On
// the TPU one core swept the whole batch, tile by tile, step by step, with
// the weight gradients accumulating in VMEM across the sequential grid.
// Here rows are independent in the backward, and only the weight gradients
// couple them: each CTA sweeps its own row blocks through all accepted steps
// in reverse, carrying a_u (state cotangent) and a_k (the FSAL cotangent on
// the incoming k1) in the output buffers. Per step it recomputes k1 from the
// knot (u_j, t_j), seeds the stage cotangents with the saveat cotangents
// (Tsit5 interpolant weights, where s ∈ (t_j, t_j+1]) and a_k, and
// transposes the step (tsit5_bwd.cuh), adding the weight gradient into its
// own partial; a second kernel sums the partials in CTA order. naccept is
// read on the device.
//
// Two-level mode, when naccept > dense_cap: one W-step window at a time, in
// reverse, every CTA replays the window from its checkpoint with the forward
// kernel's own attempt (solve.cuh::replay_window, one grid barrier per
// attempt, so this mode is a cooperative launch), recording the accepted
// states of its rows, and then sweeps the count the replay actually
// accepted, min(replayed, n_steps). The replay repeats the forward's accept
// and dt sequence bitwise. Otherwise the dense knots are swept directly.
//
// What bounds it on an H100: per step, seven TD-MLP evaluations (k1 and the
// six stages), the reverse pass (two products per stage) and a 0.63 MB
// read-modify-write of the CTA's weight-gradient partial; at B = 512 the 64
// CTAs use half the SMs.
#include "solve.cuh"
#include "tsit5_bwd.cuh"

namespace lrnde {

constexpr int kMaxSave = 8;

struct SweepArgs {
  int two_level;
  TDMLP w;
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
  float* scratch;
  float* part;            // (gridDim.x, grad_floats)
  float* slots;           // two-level: (2, n_blocks)
  unsigned int* barrier;  // two-level: zero at launch
  float* local_ts;        // two-level: (gridDim.x, W + 1)
  float* local_us;        // two-level: (W + 1, B, F)
  int B;
  float inv_n;
};

struct StepWeights {
  float wt[kMaxSave][7];  // dt·b_m(θ_s)·hit_s
  float hit[kMaxSave];
  float t, dt;
};

// Transpose accepted steps n_hi-1 .. 0 whose start times are ts[j] and start
// states us + j·BF, for this CTA's row blocks.
__device__ void sweep_range(const SweepArgs& a, const BwdSmem& bs,
                            StepWeights& sw, int n_hi, const float* ts,
                            const float* us, float* g) {
  const int F = a.w.F, B = a.B, tid = threadIdx.x;
  const int n_blocks = (B + kRows - 1) / kRows;
  const size_t BF = static_cast<size_t>(B) * F;
  float* const ks = a.scratch;               // k1..k7: 7 (B, F)
  float* const dks = a.scratch + 7 * BF;     // cotangents on k1..k7
  float* const du = a.scratch + 14 * BF;     // (B, F)
  float* const blks = a.scratch + 24 * BF;   // per row block
  for (int j = n_hi - 1; j >= 0; --j) {
    if (tid == 0) {
      const float t = ts[j], tn = ts[j + 1];
      const float dt = tn - t;
      sw.t = t;
      sw.dt = dt;
      for (int s = 0; s < a.n_save; ++s) {
        const float st = a.saveat[s];
        const float hit = (st > t && st <= tn) ? 1.f : 0.f;
        float b[7];
        interp_weights(fminf(fmaxf((st - t) / dt, 0.f), 1.f), b);
        for (int m = 0; m < 7; ++m) sw.wt[s][m] = dt * b[m] * hit;
        sw.hit[s] = hit;
      }
    }
    __syncthreads();
    const float t = sw.t, dt = sw.dt;
    for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
      const size_t off = static_cast<size_t>(rb) * kRows * F;
      const int nrows = min(kRows, B - rb * kRows);
      const float* u = us + j * BF + off;
      // k1 of the step, recomputed from its knot
      load_rows(bs.base, u, F, nrows);
      __syncthreads();
      tdmlp_rows(a.w, bs.base, t, ks + off, nrows);
      __syncthreads();
      // stage cotangents from the saveat hits, and the FSAL carry on k7
      for (int i = tid; i < nrows * F; i += kThreads) {
        const size_t o = off + i;
        for (int m = 0; m < 7; ++m) {
          float acc = 0.f;
          for (int s = 0; s < a.n_save; ++s)
            acc = acc + sw.wt[s][m] * a.ct_ys[s * BF + o];
          dks[m * BF + o] = m == 6 ? acc + a.a_k[o] : acc;
        }
      }
      __syncthreads();
      BwdRows p;
      p.u = u;
      for (int m = 0; m < 7; ++m) {
        p.k[m] = ks + m * BF + off;
        p.dk[m] = dks + m * BF + off;
      }
      p.d_unew = a.a_u + off;
      p.d_g6 = nullptr;
      p.d_u = du + off;
      p.blk = blks + rb * bwd_block_floats(F);
      tsit5_rows_bwd(a.w, bs, p, t, dt, nrows, g);
      // carries: a_u <- d_u + Σ_hit ct_ys ; a_k <- d_k1
      for (int i = tid; i < nrows * F; i += kThreads) {
        const size_t o = off + i;
        float dint = 0.f;
        for (int s = 0; s < a.n_save; ++s)
          dint = dint + a.ct_ys[s * BF + o] * sw.hit[s];
        a.a_u[o] = du[o] + dint;
        a.a_k[o] = dks[o];
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
adjoint_sweep_kernel(SweepArgs a) {
  extern __shared__ float4 smem_raw[];
  __shared__ StepWeights sw;
  __shared__ ReplayCtl ctl;
  const int F = a.w.F, B = a.B, tid = threadIdx.x;
  const BwdSmem bs = carve_bwd_smem(reinterpret_cast<float*>(smem_raw), F, a.w.H);
  const size_t BF = static_cast<size_t>(B) * F;
  float* const g = a.part + blockIdx.x * grad_floats(F, a.w.H);
  const int n = *a.naccept;

  zero_partial(g, grad_floats(F, a.w.H));
  const int n_blocks = (B + kRows - 1) / kRows;
  for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
    const size_t off = static_cast<size_t>(rb) * kRows * F;
    const int m = min(kRows, B - rb * kRows) * F;
    for (int i = tid; i < m; i += kThreads) {
      a.a_u[off + i] = a.ct_y[off + i];
      a.a_k[off + i] = 0.f;
    }
  }
  __syncthreads();

  if (!a.two_level || n <= a.dense_cap) {
    sweep_range(a, bs, sw, n, a.knot_ts, a.knot_us, g);
    return;
  }

  // ---- windowed replay from the checkpoints, last window first
  const int W = a.stride;
  float* const lts = a.local_ts + blockIdx.x * (W + 1);
  const AttemptBufs bufs{a.scratch + 15 * BF, a.scratch + 16 * BF,
                         a.scratch + 23 * BF, BF, B};
  unsigned int epoch = 0;
  for (int w = (n - 1) / W; w >= 0; --w) {
    const int n_steps = min(max(n - w * W, 0), W);
    const int got = replay_window(
        a.w, bs.base, bufs, a.ckpt_ts, a.ckpt_us, a.ckpt_ks, a.ckpt_dts,
        a.ckpt_qolds, w, n_steps, a.max_steps, a.t_end, a.atol, a.rtol,
        a.inv_n, a.slots, a.barrier, epoch, ctl, lts, a.local_us);
    // sweep what the replay accepted: an accept flip must not sweep slots
    // it never wrote
    sweep_range(a, bs, sw, min(got, n_steps), lts, a.local_us, g);
  }
}

}  // namespace lrnde

// Floats of scratch the sweep needs at (B, F, H).
extern "C" long long lrnde_sweep_scratch_floats(int B, int F, int H) {
  using namespace lrnde;
  (void)H;
  const long long n_blocks = (B + kRows - 1) / kRows;
  return 24LL * B * F + n_blocks * static_cast<long long>(bwd_block_floats(F));
}

// The reverse sweep of the stored adjoint over *naccept recorded steps
// (dense), or, with two_level and *naccept > dense_cap, over windows
// replayed from the checkpoints. Writes a_u, a_k and the flat weight
// gradient d_w; part holds ceil(B / kRows) partials. The two-level mode is
// a cooperative launch. Returns cudaGetLastError().
extern "C" int lrnde_adjoint_sweep(
    int two_level, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* knot_ts, const float* knot_us,
    const int* naccept, const float* saveat, int n_save, const float* ct_ys,
    const float* ct_y, const float* ckpt_ts, const float* ckpt_us,
    const float* ckpt_ks, const float* ckpt_dts, const float* ckpt_qolds,
    float t_end, float rtol, float atol, int max_steps, int stride,
    int dense_cap, float* a_u, float* a_k, float* d_w, float* scratch,
    float* part, float* slots, unsigned int* barrier, float* local_ts,
    float* local_us, int B, int F, int H, float inv_n, void* stream) {
  using namespace lrnde;
  if (n_save > kMaxSave || (two_level && stride < 1))
    return cudaErrorInvalidValue;
  SweepArgs a{two_level, TDMLP{w1, b1, w2, b2, F, H}, knot_ts, knot_us,
              naccept, saveat, n_save, ct_ys, ct_y, ckpt_ts, ckpt_us,
              ckpt_ks, ckpt_dts, ckpt_qolds, t_end, rtol, atol, max_steps,
              stride, dense_cap, a_u, a_k, scratch, part, slots, barrier,
              local_ts, local_us, B, inv_n};
  const size_t smem = bwd_smem_floats(F, H) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(adjoint_sweep_kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int grid = (B + kRows - 1) / kRows;
  if (two_level) {
    err = launch_cooperative(adjoint_sweep_kernel, &a, B, smem, s, &grid);
  } else {
    adjoint_sweep_kernel<<<grid, kThreads, smem, s>>>(a);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  return reduce_partials(part, grid, grad_floats(F, H), d_w, s);
}
