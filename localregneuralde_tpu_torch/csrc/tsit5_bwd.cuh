// Shared device code of the backward kernels: the transpose of one Tsit5
// step of the TD-MLP for one row block, and the fixed-order reduction of the
// per-CTA weight-gradient partials.
//
// Counterpart of the reference's stage transpose, which fused_mlp_bwd.py
// (kernel 3) and fused_solve_bwd.py::_family_hooks (kernels 7 and 8) share.
// Per stage evaluation at time s:
//   z = x·W1 + b1 + s·w1t ; h = tanh(z) ; k = h·W2 + b2 + s·w2t
//   dh = dk·W2ᵀ ; dz = dh·(1−h²) ; dx = dz·W1ᵀ
// tsit5_rows_bwd() recomputes the six stages of the row block and keeps each
// stage input x_i (transposed, in global scratch) and hidden row h_i (shared
// memory), runs the reverse pass through the stage chain, and then adds the
// stage-batched weight gradients Σ_i x_iᵀ·dz_i and Σ_i h_iᵀ·dk_i (a K = 6·8
// product per weight), with the bias and time rows, into the CTA's partial.
// The partials are summed over CTAs in a fixed order by a second kernel, so
// the gradients are the same from run to run; no float atomics.
//
// What bounds it on an H100: like the forward, the products read the
// weights from L2 once per CTA and stage (two products per stage in the
// recompute and two in the reverse pass); the weight gradient is a
// 0.63 MB read-modify-write of the CTA's partial per transposed step.
#pragma once

#include "tdmlp.cuh"

namespace lrnde {

// Stage coefficients a_ij (row i gives the input of the (i+2)-th stage
// derivative) and stage-time fractions.
static __constant__ float kA[6][6] = {
    {A21},
    {A31, A32},
    {A41, A42, A43},
    {A51, A52, A53, A54},
    {A61, A62, A63, A64, A65},
    {A71, A72, A73, A74, A75, A76},
};

// Floats of one flat weight gradient: w1 (F+1, H), b1 (H), w2 (H+1, F),
// b2 (F), the layout of ops/cuda/fused_mlp_bwd.py::split_weight_grad.
__host__ __device__ inline size_t grad_floats(int F, int H) {
  return static_cast<size_t>(F + 1) * H + H + static_cast<size_t>(H + 1) * F +
         F;
}

// Dynamic shared memory of a backward CTA, in floats: the forward Smem, then
// the six hidden rows, the six dz rows ([H][kRows] each) and the current
// stage's dk, transposed ([F][kRows]).
__host__ __device__ inline size_t bwd_smem_floats(int F, int H) {
  return smem_floats(F, H) + 12 * static_cast<size_t>(H) * kRows +
         static_cast<size_t>(F) * kRows;
}

struct BwdSmem {
  Smem base;
  float* hall;   // [6][H][kRows]
  float* dzall;  // [6][H][kRows]
  float* dkT;    // [F][kRows]
};

__device__ inline BwdSmem carve_bwd_smem(float* raw, int F, int H) {
  BwdSmem s;
  s.base = carve_smem(raw, F, H);
  s.hall = raw + smem_floats(F, H);
  s.dzall = s.hall + 6 * H * kRows;
  s.dkT = s.dzall + 6 * H * kRows;
  return s;
}

// Global scratch of one row block's transpose, per row block: the stage
// inputs and the stage-output cotangents, transposed ([6][F][kRows] each).
__host__ __device__ inline size_t bwd_block_floats(int F) {
  return 12 * static_cast<size_t>(F) * kRows;
}

// Row-block pointers of one step transpose (row-major, stride F).
struct BwdRows {
  const float* u;       // step start state
  float* k[7];          // k[0] = k1 (read); k[1..6] receive k2..k7
  float* dk[7];         // cotangents on k1..k7, seeded by the caller;
                        // dk[0] returns d_k1
  const float* d_unew;  // cotangent on u_new, may be null
  const float* d_g6;    // cotangent on g6, may be null
  float* d_u;           // out
  float* blk;           // bwd_block_floats(F) of scratch
};

// Transpose one Tsit5 step of the row block from (u, t) with step dt and
// add its weight gradient into the partial g (grad_floats(F, H)).
__device__ inline void tsit5_rows_bwd(const TDMLP& w, const BwdSmem& bs,
                                      const BwdRows& p, float t, float dt,
                                      int nrows, float* g) {
  const int F = w.F, H = w.H, tid = threadIdx.x;
  const int FR = F * kRows, HR = H * kRows;
  float* const xT = p.blk;
  float* const dkT = p.blk + 6 * FR;
  float s_i[6];

  // ---- forward recompute, keeping x_i (global) and h_i (shared)
  for (int i = 0; i < 6; ++i) {
    for (int idx = tid; idx < FR; idx += kThreads) {
      const int r = idx / F, c = idx - r * F;
      float v = 0.f;
      if (r < nrows) {
        const size_t o = static_cast<size_t>(r) * F + c;
        float acc = kA[i][0] * p.k[0][o];
        for (int j = 1; j <= i; ++j) acc = acc + kA[i][j] * p.k[j][o];
        v = p.u[o] + dt * acc;
      }
      bs.base.xs[c * kRows + r] = v;
    }
    __syncthreads();
    for (int idx = tid; idx < FR; idx += kThreads)
      xT[i * FR + idx] = bs.base.xs[idx];
    Smem si = bs.base;
    si.hid = bs.hall + i * HR;
    const float c = i == 0 ? C1 : i == 1 ? C2 : i == 2 ? C3 : i == 3 ? C4 : 1.f;
    s_i[i] = i < 4 ? t + c * dt : t + dt;
    tdmlp_rows(w, si, s_i[i], p.k[i + 1], nrows);
    __syncthreads();
  }

  // ---- reverse pass through the stage chain
  for (int i = 5; i >= 0; --i) {
    for (int idx = tid; idx < FR; idx += kThreads) {
      const int r = idx / F, c = idx - r * F;
      const float v = r < nrows ? p.dk[i + 1][static_cast<size_t>(r) * F + c] : 0.f;
      bs.dkT[c * kRows + r] = v;
      dkT[i * FR + c * kRows + r] = v;
    }
    __syncthreads();
    // dh = dk·W2ᵀ: kSplit threads share a hidden unit, each summing every
    // kSplit-th output feature of W2's row h (adjacent threads read
    // adjacent weights)
    for (int item = tid; item < H * kSplit; item += kThreads) {
      const int q = item % kSplit, h = item / kSplit;
      const float* w2h = w.w2 + static_cast<size_t>(h) * F;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int f = q; f < F; f += kSplit) {
        const float wv = __ldg(w2h + f);
        const float4 d0 = *reinterpret_cast<const float4*>(bs.dkT + f * kRows);
        const float4 d1 = *reinterpret_cast<const float4*>(bs.dkT + f * kRows + 4);
        acc[0] = fmaf(d0.x, wv, acc[0]);
        acc[1] = fmaf(d0.y, wv, acc[1]);
        acc[2] = fmaf(d0.z, wv, acc[2]);
        acc[3] = fmaf(d0.w, wv, acc[3]);
        acc[4] = fmaf(d1.x, wv, acc[4]);
        acc[5] = fmaf(d1.y, wv, acc[5]);
        acc[6] = fmaf(d1.z, wv, acc[6]);
        acc[7] = fmaf(d1.w, wv, acc[7]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        bs.base.part[(q * H + h) * kRows + r] = acc[r];
    }
    __syncthreads();
    float* const dz = bs.dzall + i * HR;
    const float* const hh = bs.hall + i * HR;
    for (int idx = tid; idx < HR; idx += kThreads) {
      const int h = idx / kRows, r = idx - h * kRows;
      float d = 0.f;
      for (int q = 0; q < kSplit; ++q) d += bs.base.part[(q * H + h) * kRows + r];
      const float hv = hh[idx];
      dz[idx] = d * (1.f - hv * hv);
    }
    __syncthreads();
    // dx = dz·W1ᵀ, one output feature per thread; then the stage input's
    // cotangent flows to u and to the k_j it was built from
    for (int f = tid; f < F; f += kThreads) {
      const float* w1f = w.w1 + static_cast<size_t>(f) * H;
      float acc[kAcc2][kRows];
#pragma unroll
      for (int a = 0; a < kAcc2; ++a)
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[a][r] = 0.f;
      for (int h0 = 0; h0 < H; h0 += kAcc2) {
#pragma unroll
        for (int a = 0; a < kAcc2; ++a) {
          const int h = h0 + a;
          if (h < H) {
            const float wv = __ldg(w1f + h);
            const float4 z0 = *reinterpret_cast<const float4*>(dz + h * kRows);
            const float4 z1 = *reinterpret_cast<const float4*>(dz + h * kRows + 4);
            acc[a][0] = fmaf(z0.x, wv, acc[a][0]);
            acc[a][1] = fmaf(z0.y, wv, acc[a][1]);
            acc[a][2] = fmaf(z0.z, wv, acc[a][2]);
            acc[a][3] = fmaf(z0.w, wv, acc[a][3]);
            acc[a][4] = fmaf(z1.x, wv, acc[a][4]);
            acc[a][5] = fmaf(z1.y, wv, acc[a][5]);
            acc[a][6] = fmaf(z1.z, wv, acc[a][6]);
            acc[a][7] = fmaf(z1.w, wv, acc[a][7]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= nrows) continue;
        const size_t o = static_cast<size_t>(r) * F + f;
        float dx = (acc[0][r] + acc[1][r]) + (acc[2][r] + acc[3][r]);
        if (i == 5 && p.d_unew != nullptr) dx = dx + p.d_unew[o];
        if (i == 4 && p.d_g6 != nullptr) dx = dx + p.d_g6[o];
        p.d_u[o] = i == 5 ? dx : p.d_u[o] + dx;
        for (int j = 0; j <= i; ++j) p.dk[j][o] = p.dk[j][o] + (dt * kA[i][j]) * dx;
      }
    }
    __syncthreads();
  }

  // ---- stage-batched weight gradients into the CTA's partial
  float* const gw1 = g;                                  // (F, H)
  float* const gw1t = g + static_cast<size_t>(F) * H;    // (H)
  float* const gb1 = gw1t + H;                           // (H)
  float* const gw2 = gb1 + H;                            // (H, F)
  float* const gw2t = gw2 + static_cast<size_t>(H) * F;  // (F)
  float* const gb2 = gw2t + F;                           // (F)
  for (int e = tid; e < F * H; e += kThreads) {
    const int f = e / H, h = e - f * H;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float4 x0 = *reinterpret_cast<const float4*>(xT + i * FR + f * kRows);
      const float4 x1 = *reinterpret_cast<const float4*>(xT + i * FR + f * kRows + 4);
      const float* z = bs.dzall + i * HR + h * kRows;
      const float4 z0 = *reinterpret_cast<const float4*>(z);
      const float4 z1 = *reinterpret_cast<const float4*>(z + 4);
      acc = fmaf(x0.x, z0.x, acc);
      acc = fmaf(x0.y, z0.y, acc);
      acc = fmaf(x0.z, z0.z, acc);
      acc = fmaf(x0.w, z0.w, acc);
      acc = fmaf(x1.x, z1.x, acc);
      acc = fmaf(x1.y, z1.y, acc);
      acc = fmaf(x1.z, z1.z, acc);
      acc = fmaf(x1.w, z1.w, acc);
    }
    gw1[e] += acc;
  }
  for (int h = tid; h < H; h += kThreads) {
    float sb = 0.f, st = 0.f;
    for (int i = 0; i < 6; ++i) {
      float si = 0.f;
      for (int r = 0; r < kRows; ++r) si += bs.dzall[i * HR + h * kRows + r];
      sb += si;
      st = fmaf(s_i[i], si, st);
    }
    gb1[h] += sb;
    gw1t[h] += st;
  }
  for (int e = tid; e < H * F; e += kThreads) {
    const int h = e / F, f = e - h * F;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float* hv = bs.hall + i * HR + h * kRows;
      const float4 h0 = *reinterpret_cast<const float4*>(hv);
      const float4 h1 = *reinterpret_cast<const float4*>(hv + 4);
      const float4 d0 = *reinterpret_cast<const float4*>(dkT + i * FR + f * kRows);
      const float4 d1 = *reinterpret_cast<const float4*>(dkT + i * FR + f * kRows + 4);
      acc = fmaf(h0.x, d0.x, acc);
      acc = fmaf(h0.y, d0.y, acc);
      acc = fmaf(h0.z, d0.z, acc);
      acc = fmaf(h0.w, d0.w, acc);
      acc = fmaf(h1.x, d1.x, acc);
      acc = fmaf(h1.y, d1.y, acc);
      acc = fmaf(h1.z, d1.z, acc);
      acc = fmaf(h1.w, d1.w, acc);
    }
    gw2[e] += acc;
  }
  for (int f = tid; f < F; f += kThreads) {
    float sb = 0.f, st = 0.f;
    for (int i = 0; i < 6; ++i) {
      float si = 0.f;
      for (int r = 0; r < kRows; ++r) si += dkT[i * FR + f * kRows + r];
      sb += si;
      st = fmaf(s_i[i], si, st);
    }
    gb2[f] += sb;
    gw2t[f] += st;
  }
  __syncthreads();
}

// Zero this CTA's partial.
__device__ inline void zero_partial(float* g, size_t n) {
  for (size_t e = threadIdx.x; e < n; e += kThreads) g[e] = 0.f;
}

// out[e] = Σ_c part[c·n + e] over the n_parts partials, in order c = 0, 1, ...
static __global__ void reduce_partials_kernel(const float* __restrict__ part,
                                              int n_parts, size_t n,
                                              float* __restrict__ out) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int c = 0; c < n_parts; ++c) acc += part[c * n + e];
  out[e] = acc;
}

inline cudaError_t reduce_partials(const float* part, int n_parts, size_t n,
                                   float* out, cudaStream_t stream) {
  const int threads = 256;
  const int blocks = static_cast<int>((n + threads - 1) / threads);
  reduce_partials_kernel<<<blocks, threads, 0, stream>>>(part, n_parts, n, out);
  return cudaGetLastError();
}

}  // namespace lrnde
