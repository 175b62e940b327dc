// Kernel 15: one 3x3 SAME convolution of an NHWC batch, flattened to
// (M = B·H·W, Cin) -> (M, Cout) with an HWIO (3, 3, Cin, Cout) weight, in
// the two layouts of the conv-orientation probe, on Hopper's tensor cores:
// TMA tiles into wgmma, with FP32-accurate products as 3xTF32.
//
// Replaces scripts/conv_orient_probe.py::conv_pallas_tap (:93, _tap_kernel)
// and ::conv_pallas_im2col (:120, _im2col_kernel). The TPU probe asked
// whether the batch-first flat layout suits the MXU; here the same two
// layouts are timed beside the conv GEMM core of K13 and K14
// (conv_core.cuh, FP32 FFMA) and cuDNN, and are the repo's first kernels on
// wgmma, TMA and mbarriers.
//
// - tap: per tap (dy, dx) the rows p + dy·W + dx of the flat (M, Cin)
//   matrix, loaded by a 2-D tensor map that zero-fills the rows outside
//   [0, M) (the TPU kernel's halo). Each tap's product goes into its own
//   accumulator, which is folded into the sum with the pixel's border mask,
//   acc += mask·y_tap: the mask is applied in the accumulate, as in
//   _tap_kernel.
// - im2col: a 4-D tensor map over NHWC loaded at (c0, w0 + dx, h0 + dy, b);
//   TMA zero-fills the elements outside the image, so the mask sits on A
//   (_im2col_kernel) and each tap's product is added into the sum as it
//   is. A tile is R whole image rows of Wb pixels (4 rows of 32 at the
//   probe's W). One wgmma accumulator over all of K = 9·Cin, the TPU
//   kernel's single product, is kept as a probe (kOneAcc): it drifts.
//
// Design for the H100:
// - Products on wgmma.mma_async m64n64k8 with TF32 operands and FP32
//   accumulators, in 3xTF32: wgmma reads an FP32 bit pattern as TF32 by
//   ignoring its low 13 mantissa bits, so the raw value is the "hi"
//   operand and lo = a − hi (exact) rounded to the nearest TF32. Each 8-deep
//   slice issues lo·hi, hi·lo (into one accumulator), then hi·hi (into
//   another), small terms first; lo·lo is dropped. Rounding lo, rather than
//   letting wgmma truncate it, halves the products' error.
// - A (the pixels) goes to wgmma from registers: each warp loads its 16
//   rows' fragments from the swizzled tile and splits them there, so the
//   shared memory serves B only (an m64n64k8 with both operands in shared
//   memory reads 4 KB in its 32 cycles, the SM's whole 128 B a clock, and
//   3xTF32 runs three of them a slice).
// - The tensor cores round each wgmma's sum into its accumulator toward
//   zero, so the accumulators restart at each tap and are added into the
//   FP32 sum with round-to-nearest (Mode, below; the arithmetic is modelled
//   in tests/test_torch_conv_orient_plan.py).
// - TF32 wgmma takes A and B only K-major, and HWIO is N-major: the
//   producer warpgroup reads each k-step's (32 Cin x 64 Cout) weight block,
//   splits it and writes hi and lo transposed, (Cout, Cin) per tap, into
//   the stage's B tiles. So the weights' preparation runs inside the call.
// - A CTA is two consumer warpgroups (64 pixel rows each) and one producer
//   warpgroup around a ring of kStages stages in dynamic shared memory (A,
//   B hi, B lo; 32 KB a stage), full and empty mbarriers a stage. Tiles are
//   128-byte rows under the 128-byte swizzle, the layout TMA writes and the
//   wgmma descriptors name (SBO 1024 bytes, a k-slice 32 bytes further on).
//   The producer loads the next k-step's weights while it waits for a free
//   stage.
// - Where Cin·4 is not a multiple of 16 (or x is not 16-byte aligned), a
//   tensor map cannot describe x; there the producer threads write the A
//   tile with 4-byte copies and zero fill, followed by fence.proxy.async,
//   and the same consumers run. Both paths give the same bits.
// - Deterministic: no float atomics, no split-K; the sum over K runs in
//   wgmma's order, so two launches are bitwise equal.
//
// What bounds it on an H100: the products, 2·M·9·Cin·Cout = 2.42 GFLOP at
// the probe's (32, 32, 32, 64); as 3xTF32 three times that at 495 TFLOP/s,
// 14.6 µs (36.1 µs as FFMA at 67 TFLOP/s), against 17 MB of input, weight
// and output (5.0 µs at 3.35 TB/s).
#include <cuda.h>
#include <stdint.h>
#include <string.h>

#include "tdmlp.cuh"

namespace lrnde {
namespace orient {

enum Layout { kTap = 0, kIm2col = 1 };
constexpr int kBK = 32;             // channels of a k-step: one 128-byte row
constexpr int kBN = 64;             // output channels of a CTA
constexpr int kRow = kBK * 4;       // bytes of a tile row
constexpr int kBTile = kBN * kRow;  // bytes of a weight tile
constexpr unsigned kHiMask = 0xFFFFE000u;  // the bits a TF32 operand keeps

// The phases of the clocked instantiation (CTA 0's consumer warpgroup 0):
// waiting on TMA (the full barrier), the A fragments' load and lo split,
// issuing wgmma and waiting on it, the tap's fold, the output's store.
enum Phase { kPhWait, kPhSplit, kPhMma, kPhFold, kPhStore, kPhases };

struct Args {
  const float* x;
  const float* w;
  float* out;
  int B, H, W, cin, cout;
  int wb, r, th, tw;  // im2col: a tile is r image rows of wb pixels, th x tw tiles an image
  int tma;            // A tiles by TMA, else by the producer threads
  unsigned long long* timing;  // the clocked instantiation: kPhases + 1
};

// The byte offset of element (row, k) of a tile of 128-byte rows under the
// 128-byte swizzle: the 16-byte chunk k / 4 of a row moves to chunk
// (k / 4) ^ (row % 8). TMA's CU_TENSOR_MAP_SWIZZLE_128B writes this layout
// into a 1024-byte aligned tile.
__host__ __device__ constexpr uint32_t sw128(int row, int k) {
  return static_cast<uint32_t>(row * kRow + (((k >> 2) ^ (row & 7)) << 4) + ((k & 3) << 2));
}

// A wgmma shared-memory descriptor of a K-major operand under the 128-byte
// swizzle: start address >> 4, LBO 1 (unused for swizzled K-major), SBO
// 1024 bytes (eight 128-byte rows) >> 4, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The lo operand of a: a − hi, exact (hi = a with its low 13 mantissa bits
// cleared, what wgmma reads of a), rounded to the nearest TF32 so that
// wgmma reads it whole.
__device__ __forceinline__ float tf32_lo(float a) {
  const float lo = __fsub_rn(a, __uint_as_float(__float_as_uint(a) & kHiMask));
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(lo));
  return __uint_as_float(r);
}

__device__ __forceinline__ float4 tf32_lo4(float4 v) {
  return make_float4(tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z), tf32_lo(v.w));
}

// ---------------------------------------------------------------------------
// mbarriers, TMA and wgmma

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// Make the threads' shared-memory writes visible to the async proxy (TMA,
// wgmma) before a barrier hands them over.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, FP32) = A (64 x 8) · B (8 x 64) + (scale_d ? d : 0), TF32
// operands: A from registers, B K-major from shared memory. Warp w of the
// warpgroup holds A's rows 16w + g and 16w + g + 8 (g = lane / 4) at
// columns c = lane % 4 and c + 4: a = {(g, c), (g + 8, c), (g, c + 4),
// (g + 8, c + 4)}. Thread t holds d's rows 16·(t / 32) + g + {0, 8} and
// columns 8j + 2·(t % 4) + {0, 1}: d[4j + q] is row + 8·(q / 2), column
// + q % 2.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// How a k-step's products are accumulated. The tensor cores round each
// wgmma's sum into its accumulator toward zero, so an accumulator that runs
// long drifts (measured on an H100: 1.7e-5 against a float64 conv at the
// probe's inputs over K = 576, five times the FFMA kernel's error).
// - kSplit3 (the kernel): the small terms lo·hi and hi·lo into one
//   accumulator, hi·hi into another, both restarted at each tap and then
//   added into the FP32 sum with round-to-nearest.
// - kHiHi: hi·hi alone (one TF32 product, a probe of what the split costs),
//   restarted at each tap.
// - kOneAcc: lo·hi, hi·lo, hi·hi into one accumulator, restarted at each
//   tap in the tap layout and never in im2col (a probe: the design before
//   that measurement).
enum Mode { kSplit3 = 0, kHiHi = 1, kOneAcc = 2 };

// A warp's A fragments of a k-step: four 8-deep slices.
using Frag = uint32_t[kBK / 8][4];

// Keep the compiler from reusing a fragment's registers while a wgmma
// reads them.
__device__ __forceinline__ void fence_frag(Frag& f) {
#pragma unroll
  for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(f[i][e])::"memory");
}

// A warp's A fragments of a k-step from the swizzled tile, rows r16.. of
// the tile: hi the raw bits, lo split.
template <int kMode>
__device__ __forceinline__ void load_a(const uint8_t* tile, int r16, int lane, Frag& ah,
                                       Frag& al) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r16 + g + 8 * (e & 1), k = 8 * i + c + 4 * (e >> 1);
      const float v = *reinterpret_cast<const float*>(tile + sw128(row, k));
      ah[i][e] = __float_as_uint(v);
      if constexpr (kMode != kHiHi) al[i][e] = __float_as_uint(tf32_lo(v));
    }
  }
}

// The wgmma of a k-step, small terms first; `first` restarts the
// accumulators.
template <int kMode>
__device__ __forceinline__ void kstep_mma(float (&yh)[32], float (&yl)[32], const Frag& ah,
                                          const Frag& al, uint32_t b_hi, uint32_t b_lo,
                                          bool first) {
#pragma unroll
  for (int i = 0; i < kBK / 8; ++i) {
    const uint32_t o = 32 * i;
    const int acc = (first && i == 0) ? 0 : 1;
    if constexpr (kMode == kSplit3) {
      wgmma_tf32(yl, al[i], desc_sw128(b_hi + o), acc);
      wgmma_tf32(yl, ah[i], desc_sw128(b_lo + o), 1);
      wgmma_tf32(yh, ah[i], desc_sw128(b_hi + o), acc);
    } else if constexpr (kMode == kOneAcc) {
      wgmma_tf32(yh, al[i], desc_sw128(b_hi + o), acc);
      wgmma_tf32(yh, ah[i], desc_sw128(b_lo + o), 1);
      wgmma_tf32(yh, ah[i], desc_sw128(b_hi + o), 1);
    } else {
      wgmma_tf32(yh, ah[i], desc_sw128(b_hi + o), acc);
    }
  }
}

// The clock of the clocked instantiation: %globaltimer nanoseconds per
// phase, kept by every consumer thread and written by CTA 0's thread 0; a
// no-op unless kOn.
template <bool kOn>
struct Clock {
  unsigned long long acc[kOn ? kPhases + 1 : 1];
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ void start() {
    if constexpr (kOn) {
#pragma unroll
      for (int i = 0; i < kPhases; ++i) acc[i] = 0;
      acc[kPhases] = now();
    }
  }
  __device__ void mark(int phase) {
    if constexpr (kOn) {
      const unsigned long long t = now();
#pragma unroll
      for (int i = 0; i < kPhases; ++i)
        if (i == phase) acc[i] += t - acc[kPhases];
      acc[kPhases] = t;
    }
  }
  __device__ void write(unsigned long long* out, bool rec) const {
    if constexpr (kOn) {
      if (rec) {
        for (int i = 0; i < kPhases; ++i) out[i] = acc[i];
        out[kPhases] = 1;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// The kernel: kNwg consumer warpgroups of 64 pixel rows and one producer
// warpgroup, a CTA a (64·kNwg pixels x 64 output channels) tile. A stage
// holds the A tile (64·kNwg rows) and the weights' hi and lo tiles.

template <int kNwg>
__host__ __device__ constexpr int stage_bytes() {
  return 64 * kNwg * kRow + 2 * kBTile;
}

template <int kNwg, int kStages>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(kStages) * stage_bytes<kNwg>() + 1024;  // + the 1024-byte alignment
}

// The producer's weights of one k-step: output channel n0 + (t % 64), the
// 16-byte chunks t / 64 + 2q of the (tap, cb) block, zero past cin and cout.
__device__ __forceinline__ void load_w(const Args& a, int ks, int cbn, int n0, int t,
                                       float (&v)[4][4]) {
  const int tap = ks / cbn, cb = ks - tap * cbn;
  const int n = t & 63, kc0 = t >> 6, co = n0 + n;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = cb * kBK + (kc0 + 2 * q) * 4 + e;
      v[q][e] = (k < a.cin && co < a.cout)
                    ? __ldg(a.w + (static_cast<size_t>(tap) * a.cin + k) * a.cout + co)
                    : 0.f;
    }
  }
}

template <int kLayout, int kNwg, int kStages, int kMode, bool kTime>
static __global__ void __launch_bounds__((kNwg + 1) * 128, kNwg == 1 ? 2 : 1)
orient_kernel(const __grid_constant__ CUtensorMap tmap, const Args a) {
  constexpr int BM = 64 * kNwg;
  constexpr int kA = BM * kRow;  // bytes of an A tile
  constexpr int kStage = stage_bytes<kNwg>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[2 * kStages];  // full, then empty
  const uint32_t raw_u = smem_u32(smem_raw);
  const uint32_t base_u = (raw_u + 1023) & ~1023u;
  uint8_t* base = smem_raw + (base_u - raw_u);
  const uint32_t bars_u = smem_u32(bars);
  auto full = [&](int s) { return bars_u + 8 * s; };
  auto empty = [&](int s) { return bars_u + 8 * (kStages + s); };

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int HW = a.H * a.W, M = a.B * HW;
  const int n0 = blockIdx.y * kBN;
  const int cbn = (a.cin + kBK - 1) / kBK, ksteps = 9 * cbn;
  // the tile: tap, BM flat rows from m0; im2col, image b's rows h0.. and
  // columns w0.., its rows hh·wb + ww
  int m0 = 0, b = 0, h0 = 0, w0 = 0;
  if constexpr (kLayout == kTap) {
    m0 = blockIdx.x * BM;
  } else {
    const int per = a.th * a.tw, rem = blockIdx.x % per;
    b = blockIdx.x / per;
    h0 = (rem / a.tw) * a.r;
    w0 = (rem % a.tw) * a.wb;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 129);       // the TMA's arrival and the producer's 128
      mbar_init(empty(s), 4 * kNwg); // a consumer warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kNwg) {
    // ---- the producer warpgroup: A by TMA (or the threads), the weights'
    // hi and lo; the next k-step's weights load while this one's wait
    const uint32_t a_bytes = kLayout == kTap ? kA : kRow * a.wb * a.r;
    float wv[4][4];
    load_w(a, 0, cbn, n0, t, wv);
    for (int ks = 0; ks < ksteps; ++ks) {
      const int s = ks % kStages, round = ks / kStages;
      const int tap = ks / cbn, cb = ks - tap * cbn;
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const uint32_t st_u = base_u + s * kStage;
      uint8_t* st = base + s * kStage;
      float cur[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) cur[q][e] = wv[q][e];
      if (ks + 1 < ksteps) load_w(a, ks + 1, cbn, n0, t, wv);
      mbar_wait(empty(s), (round & 1) ^ 1);
      if (t == 0) {
        if (a.tma) {
          mbar_arrive_tx(full(s), a_bytes);
          if constexpr (kLayout == kTap)
            tma_load_2d(st_u, &tmap, full(s), cb * kBK, m0 + dy * a.W + dx);
          else
            tma_load_4d(st_u, &tmap, full(s), cb * kBK, w0 + dx, h0 + dy, b);
        } else {
          mbar_arrive(full(s));
        }
      }
      if (!a.tma) {
        // the A tile by 4-byte copies, zero outside the image (or [0, M))
        // and past cin, into the swizzled layout TMA would write
#pragma unroll 1
        for (int f = t; f < BM * 8; f += 128) {
          const int row = f >> 3, kc = f & 7;
          const float* src = nullptr;
          if constexpr (kLayout == kTap) {
            const int ps = m0 + row + dy * a.W + dx;
            if (ps >= 0 && ps < M) src = a.x + static_cast<size_t>(ps) * a.cin;
          } else {
            const int hh = row / a.wb, ww = row - hh * a.wb;
            const int hs = h0 + hh + dy, ws = w0 + ww + dx;
            if (hh < a.r && hs >= 0 && hs < a.H && ws >= 0 && ws < a.W)
              src = a.x + (static_cast<size_t>(b * a.H + hs) * a.W + ws) * a.cin;
          }
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = cb * kBK + kc * 4 + e;
            v[e] = (src != nullptr && c < a.cin) ? src[c] : 0.f;
          }
          *reinterpret_cast<float4*>(st + sw128(row, kc * 4)) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
      // the weights' block, split and transposed: (Cout, Cin) rows
      const int n = t & 63, kc0 = t >> 6;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 hi = make_float4(cur[q][0], cur[q][1], cur[q][2], cur[q][3]);
        const uint32_t o = sw128(n, (kc0 + 2 * q) * 4);
        *reinterpret_cast<float4*>(st + kA + o) = hi;
        if constexpr (kMode != kHiHi)
          *reinterpret_cast<float4*>(st + kA + kBTile + o) = tf32_lo4(hi);
      }
      fence_async_smem();
      mbar_arrive(full(s));
    }
    return;
  }

  // ---- a consumer warpgroup: rows 64·wg.. of the tile, warp w its rows
  // 16w.. as wgmma's A fragments in registers
  const int warp = t / 32, lane = t % 32;
  const int r0 = 64 * wg + warp * 16 + lane / 4;  // and r0 + 8: the output rows
  Clock<kTime> clk;
  clk.start();
  // the accumulators of the current tap (hi·hi, then the small terms) and
  // the FP32 sum; im2col's kOneAcc runs yh over all K
  constexpr bool kFold = !(kMode == kOneAcc && kLayout == kIm2col);
  float yh[32], yl[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) yh[i] = yl[i] = acc[i] = 0.f;
  // the tap layout's two pixels (image row, column) for the border masks
  int ph[2] = {0, 0}, pw[2] = {0, 0};
  if constexpr (kLayout == kTap) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int q = (m0 + r0 + 8 * hf) % HW;
      ph[hf] = q / a.W;
      pw[hf] = q - ph[hf] * a.W;
    }
  }
  // Each k-step's wgmma run while the other warpgroup loads and splits its
  // fragments (measured: pipelining half k-steps within a warpgroup, in the
  // same registers, gained nothing on an H100)
  for (int ks = 0; ks < ksteps; ++ks) {
    const int s = ks % kStages, tap = ks / cbn, cb = ks - tap * cbn;
    const uint32_t b_hi = base_u + s * kStage + kA;
    mbar_wait(full(s), (ks / kStages) & 1);
    clk.mark(kPhWait);
    Frag ah, al;
    load_a<kMode>(base + s * kStage, 64 * wg + 16 * warp, lane, ah, al);
    clk.mark(kPhSplit);
    fence_regs(yh);
    fence_regs(yl);
    fence_frag(ah);
    fence_frag(al);
    wgmma_fence();
    kstep_mma<kMode>(yh, yl, ah, al, b_hi, b_hi + kBTile, kFold ? cb == 0 : ks == 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yh);
    fence_regs(yl);
    fence_frag(ah);
    fence_frag(al);
    if (lane == 0) mbar_arrive(empty(s));
    clk.mark(kPhMma);
    if (kFold && cb == cbn - 1) {
      // the tap into the FP32 sum; the tap layout's border mask is folded
      // into the accumulate, im2col's sits on A
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      float m[2] = {1.f, 1.f};
      if constexpr (kLayout == kTap) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int hs = ph[hf] + dy, ws = pw[hf] + dx;
          m[hf] = (hs >= 0 && hs < a.H && ws >= 0 && ws < a.W) ? 1.f : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float v = kMode == kSplit3 ? __fadd_rn(yh[i], yl[i]) : yh[i];
        acc[i] = __fadd_rn(acc[i], kLayout == kTap ? __fmul_rn(m[(i >> 1) & 1], v) : v);
      }
      clk.mark(kPhFold);
    }
  }
  // the store: row r0 + 8·hf, columns n0 + 8j + 2·(lane % 4) + {0, 1}
  if constexpr (!kFold) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = yh[i];
  }
  const int c0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = r0 + 8 * hf;
    long long p = -1;
    if constexpr (kLayout == kTap) {
      if (m0 + row < M) p = m0 + row;
    } else {
      const int hh = row / a.wb, ww = row - hh * a.wb;
      if (hh < a.r && h0 + hh < a.H && w0 + ww < a.W)
        p = (static_cast<long long>(b) * a.H + h0 + hh) * a.W + w0 + ww;
    }
    if (p < 0) continue;
    float* dst = a.out + p * a.cout;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = c0 + 8 * j;
      const float v0 = acc[4 * j + 2 * hf], v1 = acc[4 * j + 2 * hf + 1];
      if (c + 1 < a.cout && (a.cout & 1) == 0) {
        *reinterpret_cast<float2*>(dst + c) = make_float2(v0, v1);
      } else {
        if (c < a.cout) dst[c] = v0;
        if (c + 1 < a.cout) dst[c + 1] = v1;
      }
    }
  }
  clk.mark(kPhStore);
  clk.write(a.timing, blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0);
}

// ---------------------------------------------------------------------------
// The single-tile bring-up of the operands: one warpgroup computes
// d (64 x 64) = a (64 x 32) · bᵀ (b: 64 x 32, both K-major) through the
// kernel's swizzle, A fragments, split and wgmma sequence (3xTF32 or
// hi·hi); a by TMA (a 2-D map over a) or by the threads.
static __global__ void __launch_bounds__(128)
tile_test_kernel(const __grid_constant__ CUtensorMap tmap, const float* a, const float* b,
                 float* d, int split, int tma) {
  constexpr int kT = 64 * kRow;  // 8 KB a tile: a, b hi, b lo
  __shared__ __align__(1024) uint8_t raw[3 * kT + 1024];
  __shared__ uint64_t bar;
  const uint32_t raw_u = smem_u32(raw);
  const uint32_t base_u = (raw_u + 1023) & ~1023u;
  uint8_t* base = raw + (base_u - raw_u);
  const int t = threadIdx.x;
  const uint32_t bar_u = smem_u32(&bar);
  if (t == 0) {
    mbar_init(bar_u, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tma && t == 0) {
    mbar_arrive_tx(bar_u, kT);
    tma_load_2d(base_u, &tmap, bar_u, 0, 0);
  }
  for (int f = t; f < 64 * 8; f += 128) {
    const int row = f >> 3, kc = f & 7;
    const float4 vb = *reinterpret_cast<const float4*>(b + row * kBK + kc * 4);
    *reinterpret_cast<float4*>(base + kT + sw128(row, kc * 4)) = vb;
    *reinterpret_cast<float4*>(base + 2 * kT + sw128(row, kc * 4)) = tf32_lo4(vb);
    if (!tma)
      *reinterpret_cast<float4*>(base + sw128(row, kc * 4)) =
          *reinterpret_cast<const float4*>(a + row * kBK + kc * 4);
  }
  if (tma) mbar_wait(bar_u, 0);
  fence_async_smem();
  __syncthreads();
  const int warp = t / 32, lane = t % 32;
  Frag ah, al;
  float acc[32], lo[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = lo[i] = 0.f;
  if (split)
    load_a<kSplit3>(base, 16 * warp, lane, ah, al);
  else
    load_a<kHiHi>(base, 16 * warp, lane, ah, al);
  fence_regs(acc);
  fence_regs(lo);
  fence_frag(ah);
  fence_frag(al);
  wgmma_fence();
  if (split)
    kstep_mma<kSplit3>(acc, lo, ah, al, base_u + kT, base_u + 2 * kT, true);
  else
    kstep_mma<kHiHi>(acc, lo, ah, al, base_u + kT, base_u + 2 * kT, true);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(lo);
  fence_frag(ah);
  fence_frag(al);
  const int r0 = warp * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = r0 + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    d[row * 64 + col] = split ? __fadd_rn(acc[i], lo[i]) : acc[i];
  }
}

// ---------------------------------------------------------------------------
// Host side

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from libcuda, through the runtime (no -lcuda)
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of FP32 data under the 128-byte swizzle, zero fill outside
static bool encode(CUtensorMap* map, const float* ptr, int rank, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<float*>(ptr), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch one instantiation; `tma` = 0 forces the threads' A path.
template <int kLayout, int kNwg, int kStages, int kMode, bool kTime>
static int launch(const float* x, const float* w, float* out, int B, int H, int W, int cin,
                  int cout, bool tma, unsigned long long* timing, cudaStream_t st) {
  constexpr int BM = 64 * kNwg;
  Args a{x, w, out, B, H, W, cin, cout, 0, 0, 0, 0, 0, timing};
  long long tiles;
  if (kLayout == kTap) {
    tiles = (static_cast<long long>(B) * H * W + BM - 1) / BM;
  } else {
    a.wb = W < BM ? W : BM;
    a.r = W <= BM ? (H < BM / W ? H : BM / W) : 1;
    a.th = (H + a.r - 1) / a.r;
    a.tw = (W + a.wb - 1) / a.wb;
    tiles = static_cast<long long>(B) * a.th * a.tw;
  }
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  a.tma = tma && cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (a.tma) {
    const cuuint64_t c4 = static_cast<cuuint64_t>(cin) * 4;
    bool ok;
    if (kLayout == kTap) {
      const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cin),
                                  static_cast<cuuint64_t>(B) * H * W};
      const cuuint64_t strides[1] = {c4};
      const cuuint32_t box[2] = {kBK, BM};
      ok = encode(&map, x, 2, dims, strides, box);
    } else {
      const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(W),
                                  static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
      const cuuint64_t strides[3] = {c4, c4 * W, c4 * W * H};
      const cuuint32_t box[4] = {kBK, static_cast<cuuint32_t>(a.wb),
                                 static_cast<cuuint32_t>(a.r), 1};
      ok = encode(&map, x, 4, dims, strides, box);
    }
    if (!ok) return cudaErrorInvalidValue;
  }
  auto kernel = orient_kernel<kLayout, kNwg, kStages, kMode, kTime>;
  const size_t smem = smem_bytes<kNwg, kStages>();
  static size_t granted = 0;
  cudaError_t err = allow_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(tiles), (cout + kBN - 1) / kBN);
  kernel<<<grid, (kNwg + 1) * 128, smem, st>>>(map, a);
  return cudaGetLastError();
}

// The kernel's tile: 128 pixels (two consumer warpgroups), six stages of
// 32 KB (one CTA an SM). The probe's alternative: 64 pixels, four stages
// of 24 KB (two CTAs an SM).
constexpr int kNwgMain = 2, kStagesMain = 6;
constexpr int kNwgAlt = 1, kStagesAlt = 4;

template <int kLayout>
static int run(int variant, const float* x, const float* w, float* out, int B, int H, int W,
               int cin, int cout, unsigned long long* timing, cudaStream_t st) {
  constexpr int N = kNwgMain, S = kStagesMain;
  switch (variant) {
    case 0:
      if (timing != nullptr)
        return launch<kLayout, N, S, kSplit3, true>(x, w, out, B, H, W, cin, cout, true,
                                                    timing, st);
      return launch<kLayout, N, S, kSplit3, false>(x, w, out, B, H, W, cin, cout, true,
                                                   nullptr, st);
    case 1:
      return launch<kLayout, kNwgAlt, kStagesAlt, kSplit3, false>(x, w, out, B, H, W, cin,
                                                                  cout, true, nullptr, st);
    case 2:
      return launch<kLayout, N, S, kHiHi, false>(x, w, out, B, H, W, cin, cout, true, nullptr,
                                                 st);
    case 3:
      return launch<kLayout, N, S, kSplit3, false>(x, w, out, B, H, W, cin, cout, false,
                                                   nullptr, st);
    case 4:
      return launch<kLayout, N, S, kOneAcc, false>(x, w, out, B, H, W, cin, cout, true,
                                                   nullptr, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace orient
}  // namespace lrnde

// The tap layout: out (M, cout) = conv3x3(x (M, cin), w HWIO). Returns
// cudaGetLastError().
extern "C" int lrnde_conv_orient_tap(const float* x, const float* w, float* out, int B, int H,
                                     int W, int cin, int cout, void* stream) {
  return lrnde::orient::run<lrnde::orient::kTap>(0, x, w, out, B, H, W, cin, cout, nullptr,
                                                 static_cast<cudaStream_t>(stream));
}

// The im2col layout: the same function as lrnde_conv_orient_tap. Returns
// cudaGetLastError().
extern "C" int lrnde_conv_orient_im2col(const float* x, const float* w, float* out, int B,
                                        int H, int W, int cin, int cout, void* stream) {
  return lrnde::orient::run<lrnde::orient::kIm2col>(0, x, w, out, B, H, W, cin, cout,
                                                    nullptr, static_cast<cudaStream_t>(stream));
}

// chip_smoke.py's probe of layout 0 (tap) or 1 (im2col): variant 0 the
// kernel (clocked into `timing` when it is given: kPhases nanosecond sums of
// CTA 0's consumer warpgroup 0, then a count of 1), 1 the 64-pixel tile, 2
// hi·hi only (one TF32 product, not FP32-accurate), 3 the A tiles by the
// producer threads' 4-byte copies where TMA would run, 4 one wgmma
// accumulator (kOneAcc).
extern "C" int lrnde_conv_orient_probe(int layout, int variant, const float* x, const float* w,
                                       float* out, int B, int H, int W, int cin, int cout,
                                       unsigned long long* timing, void* stream) {
  using namespace lrnde::orient;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == kTap) return run<kTap>(variant, x, w, out, B, H, W, cin, cout, timing, st);
  return run<kIm2col>(variant, x, w, out, B, H, W, cin, cout, timing, st);
}

extern "C" const char* lrnde_conv_orient_phase_names() {
  return "TMA wait,A load and split,wgmma,fold,store";
}

// The descriptors' bring-up on one tile: d (64, 64) = a (64, 32) · bᵀ (b:
// 64, 32), 3xTF32 (split) or hi·hi, a by TMA (tma) or by the threads.
extern "C" int lrnde_conv_orient_tile_test(const float* a, const float* b, float* d, int split,
                                           int tma, void* stream) {
  using namespace lrnde::orient;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma) {
    const cuuint64_t dims[2] = {kBK, 64};
    const cuuint64_t strides[1] = {kBK * 4};
    const cuuint32_t box[2] = {kBK, 64};
    if (!encode(&map, a, 2, dims, strides, box)) return cudaErrorInvalidValue;
  }
  tile_test_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(map, a, b, d, split, tma);
  return cudaGetLastError();
}
