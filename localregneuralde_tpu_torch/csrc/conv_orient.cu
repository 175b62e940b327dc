// Kernel 15: one 3x3 SAME convolution of an NHWC batch, flattened to
// (M = B·H·W, Cin) -> (M, Cout) with an HWIO (3, 3, Cin, Cout) weight, in
// the two layouts of the conv-orientation probe. FP32 FFMA throughout.
//
// Replaces scripts/conv_orient_probe.py::conv_pallas_tap (:93, _tap_kernel)
// and ::conv_pallas_im2col (:120, _im2col_kernel). The TPU probe asked
// whether the batch-first flat layout suits the MXU; here the same two
// layouts are timed beside the conv GEMM core of K13 and K14
// (conv_core.cuh, exported as conv_step_bwd.cu::lrnde_conv_core) and cuDNN, to ask whether the CIFAR conv kernels'
// distance from their bound is a layout or a tiling problem.
//
// - tap: nine shifted (M, Cin) @ (Cin, Cout) products. Each product reads
//   the input rows p + dy·W + dx unmasked (zero outside [0, M), as the TPU
//   kernel's halo), and its border mask, computed from the pixel index, is
//   folded into the accumulate: acc += mask·y_tap. The CTA tile is K13's
//   (128 pixels x 64 channels, 8 x 4 outputs a thread), with K streamed in
//   chunks of 16 input channels per tap.
// - im2col: a CTA gathers the masked (64, 9·Cin) im2col tile of its pixels
//   into shared memory once (147 KB at Cin = 64), then runs one
//   (64, 9·Cin) @ (9·Cin, Cout) product with the weight streamed in chunks
//   of 16 rows.
//
// What bounds it on an H100: the products, 2·M·9·Cin·Cout = 2.42 GFLOP at
// the probe's (32, 32, 32, 64): 36 µs at the FP32 peak, against 17 MB of
// input, weight and output (5 µs at 3.35 TB/s).
#include "conv.cuh"

namespace lrnde {
namespace orient {

constexpr int kBK = 16;  // input channels (tap) or im2col columns per chunk

template <int BM, int BN, int TM, int TN>
static __global__ void __launch_bounds__((BM / TM) * (BN / TN))
tap_kernel(const float* __restrict__ x, const float* __restrict__ w,
           float* __restrict__ out, int B, int H, int W, int cin, int cout) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int NA = BM * kBK / NT;  // A elements a thread loads per chunk
  static_assert(NT % kBK == 0 && (BM * kBK) % NT == 0, "A-tile mapping");
  __shared__ float As[kBK][BM + 4];
  __shared__ float Bs[kBK][BN];
  const int tid = threadIdx.x, HW = H * W, M = B * HW;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kk_a = tid % kBK;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  int oh[TM], ow[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = (m0 + ty * TM + i) % HW;
    oh[i] = r / W;
    ow[i] = r - (r / W) * W;
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1, d = dy * W + dx;
    float y[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) y[i][j] = 0.f;
    for (int k0 = 0; k0 < cin; k0 += kBK) {
      const int ci = k0 + kk_a;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int r = tid / kBK + i * (NT / kBK);
        const int ps = m0 + r + d;
        As[kk_a][r] = (m0 + r < M && ps >= 0 && ps < M && ci < cin)
                          ? x[static_cast<size_t>(ps) * cin + ci] : 0.f;
      }
      for (int e = tid; e < kBK * BN; e += NT) {
        const int kk = e / BN, n = e - kk * BN;
        const int k = k0 + kk, co = n0 + n;
        Bs[kk][n] = (k < cin && co < cout)
                        ? w[(static_cast<size_t>(tap) * cin + k) * cout + co] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) y[i][j] = fmaf(av[i], bv[j], y[i][j]);
      }
      __syncthreads();
    }
    // the tap's border mask, folded into the accumulate
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int hs = oh[i] + dy, ws = ow[i] + dx;
      const float m = (hs >= 0 && hs < H && ws >= 0 && ws < W) ? 1.f : 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(m, y[i][j]));
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = m0 + ty * TM + i;
    if (p >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tx * TN + j;
      if (co < cout) out[static_cast<size_t>(p) * cout + co] = acc[i][j];
    }
  }
}

constexpr int kColRows = 64;  // pixels of an im2col tile

__host__ __device__ inline size_t im2col_smem_floats(int cin) {
  return static_cast<size_t>(9) * cin * (kColRows + 4);
}

template <int BM, int BN, int TM, int TN>
static __global__ void __launch_bounds__((BM / TM) * (BN / TN))
im2col_kernel(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, int B, int H, int W, int cin,
              int cout) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int LDA = BM + 4;
  extern __shared__ float4 smem_raw[];
  float* col = reinterpret_cast<float*>(smem_raw);  // [9·cin][BM + 4]
  __shared__ float Bs[kBK][BN];
  const int tid = threadIdx.x, HW = H * W, M = B * HW, K = 9 * cin;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);

  // the masked gather: column tap·cin + ci of pixel p is x[p + dy·W + dx, ci]
  // inside the image, else 0
  for (int e = tid; e < BM * K; e += NT) {
    const int r = e / K, k = e - r * K;
    const int tap = k / cin, ci = k - tap * cin;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int p = m0 + r, q = p % HW;
    const int hs = q / W + dy, ws = q - (q / W) * W + dx;
    float v = 0.f;
    if (p < M && hs >= 0 && hs < H && ws >= 0 && ws < W)
      v = x[static_cast<size_t>(p + dy * W + dx) * cin + ci];
    col[k * LDA + r] = v;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBK * BN; e += NT) {
      const int kk = e / BN, n = e - kk * BN;
      const int k = k0 + kk, co = n0 + n;
      Bs[kk][n] = (k < K && co < cout) ? w[static_cast<size_t>(k) * cout + co] : 0.f;
    }
    __syncthreads();
    const int kn = min(kBK, K - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float* a = col + (k0 + kk) * LDA + ty * TM;
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a[i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = m0 + ty * TM + i;
    if (p >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tx * TN + j;
      if (co < cout) out[static_cast<size_t>(p) * cout + co] = acc[i][j];
    }
  }
}

}  // namespace orient
}  // namespace lrnde

// The tap layout: out (M, cout) = conv3x3(x (M, cin), w HWIO). Returns
// cudaGetLastError().
extern "C" int lrnde_conv_orient_tap(const float* x, const float* w,
                                     float* out, int B, int H, int W, int cin,
                                     int cout, void* stream) {
  using namespace lrnde;
  const int M = B * H * W;
  const dim3 grid(conv::cdiv(M, 128), conv::cdiv(cout, 64));
  orient::tap_kernel<128, 64, 8, 4>
      <<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, w, out, B, H, W,
                                                            cin, cout);
  return cudaGetLastError();
}

// Floats of dynamic shared memory of one im2col CTA at cin.
extern "C" long long lrnde_conv_orient_im2col_smem_floats(int cin) {
  return static_cast<long long>(lrnde::orient::im2col_smem_floats(cin));
}

// The im2col layout: the same function as lrnde_conv_orient_tap. Returns
// cudaGetLastError().
extern "C" int lrnde_conv_orient_im2col(const float* x, const float* w,
                                        float* out, int B, int H, int W,
                                        int cin, int cout, void* stream) {
  using namespace lrnde;
  constexpr int BM = orient::kColRows;
  auto kernel = orient::im2col_kernel<BM, 64, 4, 4>;
  const size_t smem = orient::im2col_smem_floats(cin) * sizeof(float);
  static size_t granted = 0;
  cudaError_t err = allow_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const int M = B * H * W;
  const dim3 grid(conv::cdiv(M, BM), conv::cdiv(cout, 64));
  kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, out, B, H, W, cin, cout);
  return cudaGetLastError();
}
