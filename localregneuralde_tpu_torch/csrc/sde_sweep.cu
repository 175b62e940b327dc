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
// What bounds it on an H100: latency. Per step a CTA of 64 threads runs
// eight small products forward, eight transposed and three weight-gradient
// contractions of K = 16; at B = 512 the 128 CTAs use one SM each.
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

template <bool kSosri>
__global__ void __launch_bounds__(kSdeThreads)
sde_sweep_kernel(SdeSweepArgs a) {
  extern __shared__ float4 smem_raw[];
  const int F = a.w.F, H = a.w.H, B = a.B, tid = threadIdx.x;
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
  for (size_t i = tid; i < sde_grad_floats(F, H); i += blockDim.x) gw1[i] = 0.f;
  const SriTableau T = sri_tableau(kSosri);
  const float sqrt3 = LRNDE_F(1.7320508075688772);
  const int n_steps = *a.naccept;
  __syncthreads();

  for (int rb = blockIdx.x; rb < n_blocks; rb += gridDim.x) {
    const size_t off = static_cast<size_t>(rb) * kSdeRows * F;
    const int nrows = min(kSdeRows, B - rb * kSdeRows), n = nrows * F;
    for (int i = tid; i < n; i += blockDim.x) a.a_u[off + i] = a.ct_y[off + i];
    for (int j = n_steps - 1; j >= 0; --j) {
      const float t = a.knot_ts[j], tn = a.knot_ts[j + 1];
      const float dt = tn - t, sqdt = sqrtf(dt);
      // ---- forward recompute of the step
      for (int i = tid; i < n; i += blockDim.x) {
        const size_t o = j * BF + off + i;
        u[i] = a.knot_us[o];
        dw[i] = a.knot_dws[o];
        dz[i] = a.knot_dzs[o];
        xf[i] = u[i];
        xg[i] = u[i];
      }
      __syncthreads();
      sde_stage_eval(w, xf, xg, hid, k, g, nrows);
      for (int e = 1; e < 4; ++e) {
        for (int i = tid; i < n; i += blockDim.x) {
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
        sde_stage_eval(w, xf + e * RF, xg + e * RF, hid + e * RH, k + e * RF,
                       g + e * RF, nrows);
      }
      // ---- saveat split and the cotangents of the u_new expression
      for (int i = tid; i < n; i += blockDim.x) {
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
      // ---- reverse through the stages
      for (int e = 3; e >= 0; --e) {
        const float* dke = dk + e * RF;
        const float* dge = dg + e * RF;
        for (int i = tid; i < nrows * H; i += blockDim.x) {
          const int r = i / H, h = i - r * H;
          float acc = 0.f;
          for (int c = 0; c < F; ++c) acc = fmaf(dke[r * F + c], w.W2(h, c), acc);
          const float hv = hid[e * RH + i];
          dzh[e * RH + i] = acc * (1.f - hv * hv);
        }
        for (int i = tid; i < n; i += blockDim.x) {
          const int r = i / F, c = i - r * F;
          float acc = 0.f;
          for (int q = 0; q < F; ++q) acc = fmaf(dge[r * F + q], w.Wd(c, q), acc);
          dxg[i] = acc;
        }
        __syncthreads();
        for (int i = tid; i < n; i += blockDim.x) {
          const int r = i / F, c = i - r * F;
          const float* dzr = dzh + e * RH + r * H;
          float acc = 0.f;
          for (int h = 0; h < H; ++h) acc = fmaf(dzr[h], w.W1(c, h), acc);
          dxf[i] = acc;
        }
        __syncthreads();
        for (int i = tid; i < n; i += blockDim.x) {
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
      for (int i = tid; i < n; i += blockDim.x) a.a_u[off + i] = du[i] + dint[i];
      // ---- stage-batched weight gradients of this step
      for (int i = tid; i < F * H; i += blockDim.x) {
        const int c = i / H, h = i - c * H;
        float acc = 0.f;
        for (int e = 0; e < 4; ++e)
          for (int r = 0; r < nrows; ++r)
            acc = fmaf(xf[e * RF + r * F + c], dzh[e * RH + r * H + h], acc);
        gw1[i] += acc;
      }
      for (int i = tid; i < H * F; i += blockDim.x) {
        const int h = i / F, c = i - h * F;
        float acc = 0.f;
        for (int e = 0; e < 4; ++e)
          for (int r = 0; r < nrows; ++r)
            acc = fmaf(hid[e * RH + r * H + h], dk[e * RF + r * F + c], acc);
        gw2[i] += acc;
      }
      for (int i = tid; i < F * F; i += blockDim.x) {
        const int c = i / F, q = i - c * F;
        float acc = 0.f;
        for (int e = 0; e < 4; ++e)
          for (int r = 0; r < nrows; ++r)
            acc = fmaf(xg[e * RF + r * F + c], dg[e * RF + r * F + q], acc);
        gwd[i] += acc;
      }
      for (int i = tid; i < H; i += blockDim.x) {
        float acc = 0.f;
        for (int e = 0; e < 4; ++e)
          for (int r = 0; r < nrows; ++r) acc += dzh[e * RH + r * H + i];
        gb1[i] += acc;
      }
      for (int i = tid; i < F; i += blockDim.x) {
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
    }
  }
  float* out = a.part + blockIdx.x * sde_grad_floats(F, H);
  for (size_t i = tid; i < sde_grad_floats(F, H); i += blockDim.x) out[i] = gw1[i];
}

}  // namespace lrnde

// Batch rows per row block (one CTA's unit of work) of the SDE kernels.
extern "C" int lrnde_sde_rows_per_block() { return lrnde::kSdeRows; }

// Floats of dynamic shared memory per CTA, and of one weight-gradient
// partial, at (F, H).
extern "C" long long lrnde_sde_sweep_smem_floats(int F, int H) {
  return static_cast<long long>(lrnde::sde_sweep_smem_floats(F, H));
}

extern "C" long long lrnde_sde_grad_floats(int F, int H) {
  return static_cast<long long>(lrnde::sde_grad_floats(F, H));
}

// The reverse sweep over *naccept recorded SRI (sosri = 0) or SOSRI
// (sosri = 1) steps: writes a_u and the flat weight gradient d_w
// (dW1, db1, dW2, db2, dWd, dbd); part holds ceil(B / 4) partials. Two
// launches on the stream: the sweep and the ordered sum of its partials.
// Returns cudaGetLastError().
extern "C" int lrnde_sde_sweep(
    int sosri, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* wd, const float* bd, const float* knot_ts,
    const float* knot_us, const float* knot_dws, const float* knot_dzs,
    const int* naccept, const float* saveat, int n_save, const float* ct_ys,
    const float* ct_y, float* a_u, float* d_w, float* part, int B, int F,
    int H, void* stream) {
  using namespace lrnde;
  SdeSweepArgs a{SdeWeights{w1, b1, w2, b2, wd, bd, F, H}, knot_ts, knot_us,
                 knot_dws, knot_dzs, naccept, saveat, n_save, ct_ys, ct_y,
                 a_u, part, B};
  const size_t smem = sde_sweep_smem_floats(F, H) * sizeof(float);
  auto kernel = sosri ? sde_sweep_kernel<true> : sde_sweep_kernel<false>;
  static size_t granted[2] = {0, 0};
  cudaError_t err = allow_smem(kernel, smem, &granted[sosri ? 1 : 0]);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = sde_row_blocks(B);
  kernel<<<grid, kSdeThreads, smem, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return reduce_partials(part, grid, sde_grad_floats(F, H), d_w, s);
}
