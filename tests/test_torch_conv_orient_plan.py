"""Models of kernel 15 (``csrc/conv_orient.cu``, the conv-orientation
probe's tap and im2col layouts on ``wgmma``) that hold on the CPU what the
card can only confirm.

- The arithmetic: hi = the FP32 value with its low 13 mantissa bits cleared
  (what ``wgmma`` reads of a raw TF32 operand), lo = a − hi (exact) rounded
  to the nearest TF32; each 8-deep slice's lo·hi and hi·lo added into one
  accumulator and hi·hi into another, each slice's sum exact and then
  rounded toward zero into its accumulator (the tensor cores' way), both
  restarted at each tap and added into the FP32 sum with round-to-nearest.
  Against a float64 conv its error stays within twice the FP32 conv's, so
  the card's float64 gate (``model_error``) is known before the card runs;
  lo truncated, as ``wgmma`` would read it raw, is never better, and one
  accumulator over all of im2col's K drifts.
- The tile plans (the grid, ``orient_plan``): which source pixel and
  channel each A-tile element reads for each tap and channel block (zero
  where TMA fills), and which pixel each tile row stores, mirrored in
  Python from the kernel; with integer
  inputs they reproduce the conv exactly in float64, every output once.
- The 128-byte swizzle: the layout TMA writes (and the threads' copies
  write, ``sw128``) is what the ``wgmma`` descriptors read (SBO 1024 bytes,
  each 8-deep slice 32 bytes further on), a bijection onto the tile.

No JAX and no card: ``tests/test_torch_cuda.py`` runs the kernels.
"""
from typing import NamedTuple

import numpy as np
import pytest
import torch

BK = 32          # channels of a k-step: one 128-byte row (conv_orient.cu::kBK)
ROW = 4 * BK     # bytes of a tile row
HI_MASK = np.uint32(0xFFFFE000)
TILE_PIXELS = 128   # the kernel's tile: kNwgMain warpgroups of 64 pixels
TILE_CHANNELS = 64  # by kBN output channels


class OrientPlan(NamedTuple):
    """A layout's grid (conv_orient.cu::launch): ``tiles`` x
    ``channel_tiles`` CTAs of ``pixels`` rows. The im2col tile is ``r`` image
    rows of ``wb`` pixels, ``th`` x ``tw`` tiles an image; the tap tile is
    ``pixels`` consecutive flat rows (``wb = r = th = tw = 0``)."""

    pixels: int
    tiles: int
    channel_tiles: int
    wb: int
    r: int
    th: int
    tw: int


def orient_plan(layout, B, H, W, cout, pixels=TILE_PIXELS):
    """The grid of ``layout`` ("tap" or "im2col") at (B, H, W) -> cout."""
    ct = -(-cout // TILE_CHANNELS)
    if layout == "tap":
        return OrientPlan(pixels, -(-B * H * W // pixels), ct, 0, 0, 0, 0)
    wb = min(W, pixels)
    r = min(H, pixels // W) if W <= pixels else 1
    th, tw = -(-H // r), -(-W // wb)
    return OrientPlan(pixels, B * th * tw, ct, wb, r, th, tw)


def tf32_hi(a):
    """What wgmma reads of a raw FP32 operand: the low 13 mantissa bits
    cleared."""
    a = np.ascontiguousarray(a, np.float32)
    return (a.view(np.uint32) & HI_MASK).view(np.float32)


def tf32_rna(a):
    """cvt.rna.tf32.f32: to the nearest TF32, ties away from zero."""
    a = np.ascontiguousarray(a, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _split(a, lo_round):
    hi = tf32_hi(a)
    lo = (a - hi).astype(np.float32)  # exact
    return hi, (tf32_rna(lo) if lo_round else tf32_hi(lo))


def _taps(x, w):
    """The nine shifted (M, Cin) operands (zero outside the image) and
    weight blocks (Cin, Cout), K padded to whole 32-channel blocks."""
    B, H, W, cin = x.shape
    kp = -(-cin // BK) * BK
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, kp - cin)))
    wp = np.pad(w, ((0, 0), (0, 0), (0, kp - cin), (0, 0)))
    return ([xp[:, dy:dy + H, dx:dx + W].reshape(-1, kp)
             for dy in range(3) for dx in range(3)],
            [wp[dy, dx] for dy in range(3) for dx in range(3)])


def rz32(v):
    """float64 -> float32 rounded toward zero: how the tensor cores add a
    wgmma's sum into its FP32 accumulator."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def kernel_model(x, w, layout, lo_round=True, one_acc=False):
    """Kernel 15's arithmetic in float32. Each wgmma adds its 8-deep
    slice's sum (exact) into its accumulator rounded toward zero: lo·hi and
    hi·lo into one, hi·hi into another, both restarted at each tap and then
    added into the sum with round-to-nearest (the tap layout's mask is
    already in the zero-padded operand: 0·y adds nothing). ``one_acc``:
    the three products into one accumulator, restarted at each tap in the
    tap layout and never in im2col (the kOneAcc probe)."""
    taps, ws = _taps(x, w)
    shape = (taps[0].shape[0], w.shape[3])
    out = np.zeros(shape, np.float32)
    yh = np.zeros(shape, np.float32)
    for a, b in zip(taps, ws):
        ah, al = _split(a, lo_round)
        bh, bl = _split(b, lo_round)
        if not (one_acc and layout == "im2col"):
            yh = np.zeros(shape, np.float32)
        yl = np.zeros(shape, np.float32)
        for k0 in range(0, a.shape[1], 8):
            s = slice(k0, k0 + 8)
            for p, q in ((al, bh), (ah, bl)):
                prod = p[:, s].astype(np.float64) @ q[s].astype(np.float64)
                if one_acc:
                    yh = rz32(yh + prod)
                else:
                    yl = rz32(yl + prod)
            yh = rz32(yh + ah[:, s].astype(np.float64) @ bh[s].astype(np.float64))
        if not (one_acc and layout == "im2col"):
            out = (out + (yh + yl).astype(np.float32)).astype(np.float32)
    out = yh if one_acc and layout == "im2col" else out
    return out.reshape(x.shape[:3] + (w.shape[3],))


def conv64(x, w):
    taps, ws = _taps(x.astype(np.float64), w.astype(np.float64))
    return sum(a @ b for a, b in zip(taps, ws)).reshape(
        x.shape[:3] + (w.shape[3],))


def probe_inputs(shape, seed=1):
    """chip_smoke.py's [conv orient] inputs: x uniform, w 0.05·N(0, 1)."""
    b, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(b, h, w, cin, generator=g)
    wt = 0.05 * torch.randn(3, 3, cin, cout, generator=g)
    return x.numpy(), wt.numpy()


def model_error(shape, layout, lo_round=True):
    """The model's max-abs error against a float64 conv of the card test's
    inputs at ``shape`` (the card gate's base)."""
    x, w = probe_inputs(shape)
    return float(np.abs(kernel_model(x, w, layout, lo_round)
                        - conv64(x, w)).max())


@pytest.mark.parametrize("layout", ["tap", "im2col"])
@pytest.mark.parametrize("shape", [(2, 5, 7, 16, 24), (1, 8, 8, 64, 64)])
def test_3xtf32_model_within_twice_fp32(shape, layout):
    # the model's max-abs error against float64 within twice the FP32 conv's
    # (torch on the CPU): at (2, 5, 7, 16, 24) 2.8e-7 against 4.0e-7, at
    # (1, 8, 8, 64, 64) (max|y| 2.4) 8.0e-7 against 1.0e-6, the same for
    # both layouts (the same sums: a masked tap adds 0 either way). lo
    # truncated (wgmma reading it raw) is never better; the hi·hi product
    # alone is TF32's ~1e-3
    x, w = probe_inputs(shape)
    ref = conv64(x, w)
    fp32 = torch.nn.functional.conv2d(
        torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(w).permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1).numpy()
    e32 = float(np.abs(fp32 - ref).max())
    err = float(np.abs(kernel_model(x, w, layout) - ref).max())
    assert err <= 2 * e32
    assert err <= 1e-6 * float(np.abs(ref).max())
    assert err <= float(np.abs(kernel_model(x, w, layout, False) - ref).max())
    hh = tf32_hi(x).astype(np.float64)
    assert float(np.abs(conv64(hh, tf32_hi(w)) - ref).max()) > 100 * err


def test_one_accumulator_drifts_at_the_probe_width():
    # why the accumulators restart at each tap: at (2, 32, 32, 64, 64) one
    # accumulator over im2col's K = 576 (kOneAcc) drifts to several times
    # the kernel's error, as on the card (1.68e-5 against the FFMA port's
    # 3.25e-6 at the probe's 32 images, NVIDIA H100 80GB HBM3, 700 W)
    x, w = probe_inputs((2, 32, 32, 64, 64))
    ref = conv64(x, w)
    err = float(np.abs(kernel_model(x, w, "im2col") - ref).max())
    drift = float(np.abs(kernel_model(x, w, "im2col", one_acc=True)
                         - ref).max())
    assert drift > 3 * err


# ---------------------------------------------------------------------------
# the tile plans

def a_tile_sources(layout, plan, tile, tap, cb, B, H, W, cin):
    """The flat index into x (B·H·W·cin) each element (row, k) of the A
    tile reads for (tap, channel block cb), -1 where TMA zero-fills (or the
    threads' copies write zero): conv_orient.cu's producer."""
    dy, dx = tap // 3 - 1, tap % 3 - 1
    rows = np.arange(plan.pixels)[:, None]
    c = cb * BK + np.arange(BK)[None, :]
    if layout == "tap":
        ps = tile * plan.pixels + rows + dy * W + dx
        ok = (ps >= 0) & (ps < B * H * W) & (c < cin)
        src = ps * cin + c
    else:
        per = plan.th * plan.tw
        b, rem = divmod(tile, per)
        h0, w0 = (rem // plan.tw) * plan.r, (rem % plan.tw) * plan.wb
        hh, ww = rows // plan.wb, rows % plan.wb
        hs, ws = h0 + hh + dy, w0 + ww + dx
        ok = ((hh < plan.r) & (hs >= 0) & (hs < H) & (ws >= 0) & (ws < W)
              & (c < cin))
        src = ((b * H + hs) * W + ws) * cin + c
    return np.where(ok, src, -1)


def tile_pixels(layout, plan, tile, B, H, W):
    """The output pixel of each tile row, -1 for a row that stores
    nothing; and for the tap layout each row's (image row, column) for its
    border masks."""
    rows = np.arange(plan.pixels)
    if layout == "tap":
        p = tile * plan.pixels + rows
        return np.where(p < B * H * W, p, -1)
    b, rem = divmod(tile, plan.th * plan.tw)
    h0, w0 = (rem // plan.tw) * plan.r, (rem % plan.tw) * plan.wb
    hh, ww = rows // plan.wb, rows % plan.wb
    ok = (hh < plan.r) & (h0 + hh < H) & (w0 + ww < W)
    return np.where(ok, (b * H + h0 + hh) * W + w0 + ww, -1)


def plan_conv(layout, x, w, pixels=TILE_PIXELS):
    """The conv through the tile plan in float64, each output element's
    writes counted."""
    B, H, W, cin = x.shape
    cout = w.shape[3]
    plan = orient_plan(layout, B, H, W, cout, pixels)
    xf = np.append(x.reshape(-1).astype(np.float64), 0.0)  # [-1] reads 0
    out = np.zeros((B * H * W, cout))
    writes = np.zeros((B * H * W, cout), int)
    cbn = -(-cin // BK)
    for tile in range(plan.tiles):
        pix = tile_pixels(layout, plan, tile, B, H, W)
        for nt in range(plan.channel_tiles):
            n = nt * TILE_CHANNELS + np.arange(TILE_CHANNELS)
            nv = n[n < cout]
            acc = np.zeros((plan.pixels, TILE_CHANNELS))
            for tap in range(9):
                y = np.zeros_like(acc)
                for cb in range(cbn):
                    a = xf[a_tile_sources(layout, plan, tile, tap, cb, B, H,
                                          W, cin)]
                    k = cb * BK + np.arange(BK)
                    bt = np.zeros((BK, TILE_CHANNELS))
                    kv = k < cin
                    bt[np.ix_(kv, n < cout)] = w[tap // 3, tap % 3][
                        np.ix_(k[kv], nv)]
                    y += a @ bt
                if layout == "tap":
                    # the border mask folded into the accumulate
                    q = tile * plan.pixels + np.arange(plan.pixels)
                    hw = q % (H * W)
                    hs = hw // W + tap // 3 - 1
                    ws = hw % W + tap % 3 - 1
                    m = (hs >= 0) & (hs < H) & (ws >= 0) & (ws < W)
                    acc += m[:, None] * y
                else:
                    acc += y
            rows = pix >= 0
            out[np.ix_(pix[rows], nv)] = acc[rows][:, :len(nv)]
            writes[np.ix_(pix[rows], nv)] += 1
    return out.reshape(B, H, W, cout), writes


PLAN_SHAPES = [(2, 5, 7, 16, 24), (1, 8, 8, 64, 64), (2, 6, 9, 3, 16),
               (1, 3, 130, 12, 9), (2, 7, 5, 13, 70)]


@pytest.mark.parametrize("pixels", [TILE_PIXELS, 64])
@pytest.mark.parametrize("layout", ["tap", "im2col"])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_tile_plan_reproduces_the_conv(shape, layout, pixels):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(7)
    x = rng.integers(-4, 5, (b, h, w, cin)).astype(np.float64)
    wt = rng.integers(-4, 5, (3, 3, cin, cout)).astype(np.float64)
    got, writes = plan_conv(layout, x, wt, pixels)
    assert (writes == 1).all()
    assert np.array_equal(got, conv64(x, wt))


def test_plan_at_the_probe_shape():
    # (32, 32, 32) -> 64: 256 CTAs of 128 pixels, im2col's 4 image rows of
    # 32; 64-pixel tiles double the grid
    tap = orient_plan("tap", 32, 32, 32, 64)
    im = orient_plan("im2col", 32, 32, 32, 64)
    assert (tap.tiles, tap.channel_tiles) == (256, 1)
    assert (im.tiles, im.wb, im.r, im.th, im.tw) == (256, 32, 4, 8, 1)
    assert orient_plan("im2col", 32, 32, 32, 64, 64).tiles == 512
    # a W past the tile: one image row a tile, in column segments
    wide = orient_plan("im2col", 1, 3, 300, 8)
    assert (wide.wb, wide.r, wide.tw) == (128, 1, 3)


# ---------------------------------------------------------------------------
# the 128-byte swizzle and the wgmma descriptors

def sw128(row, k):
    """conv_orient.cu::sw128: the byte offset of (row, k) in a tile of
    128-byte rows, chunk k / 4 moved to (k / 4) ^ (row % 8)."""
    return row * ROW + (((k >> 2) ^ (row & 7)) << 4) + ((k & 3) << 2)


def swizzle_address(addr):
    """The 128-byte swizzle on an address of a 1024-byte aligned region
    (TMA's CU_TENSOR_MAP_SWIZZLE_128B, wgmma's layout type 1): bits [4, 7)
    XOR bits [7, 10)."""
    return addr ^ (((addr >> 7) & 7) << 4)


SBO = 1024  # conv_orient.cu::desc_sw128: eight 128-byte rows
LBO = 16    # unused by a swizzled K-major operand (field 1)


def descriptor_read(start, m, k):
    """The byte a K-major wgmma operand under the 128-byte swizzle reads
    for element (m, k) of an 8-deep slice whose descriptor starts at
    ``start`` (relative to the 1024-byte aligned tile): the 8-row core
    matrices SBO apart, each row 128 bytes, k at 4 bytes, then the
    swizzle on the address."""
    return swizzle_address(start + (m // 8) * SBO + (m % 8) * ROW + 4 * k)


@pytest.mark.parametrize("rows", [64, 128])
def test_swizzle_is_a_bijection_and_what_the_descriptors_read(rows):
    # a tile of `rows` rows x 32 channels: the threads' sw128, TMA's
    # swizzled box and the descriptors' reads agree on every element, and
    # cover each 4-byte word of the tile once
    r, k = np.meshgrid(np.arange(rows), np.arange(BK), indexing="ij")
    threads = sw128(r, k)
    assert sorted(threads.ravel()) == list(range(0, rows * ROW, 4))
    tma = swizzle_address(r * ROW + 4 * k)  # the box row-major, swizzled
    assert np.array_equal(tma, threads)
    # A: each consumer warpgroup's 64 rows from 8 KB · wg; B: 64 channel
    # rows; slice kk of a k-step starts 32 bytes further on, never past the
    # 128-byte row (so LBO is never applied)
    for base in range(0, rows * ROW, 64 * ROW):
        for kk in range(BK // 8):
            assert 32 * (kk + 1) <= ROW
            m, kq = np.meshgrid(np.arange(64), np.arange(8), indexing="ij")
            got = descriptor_read(base + 32 * kk, m, kq)
            assert np.array_equal(got, base + sw128(m, 8 * kk + kq))


def test_descriptor_fields():
    # conv_orient.cu::desc_sw128's fields: start >> 4 (14 bits), LBO >> 4
    # at bit 16, SBO >> 4 at bit 32, layout type 1 (128-byte swizzle) at
    # bit 62; the largest stage offset fits the start field
    def desc(addr):
        return ((addr & 0x3FFFF) >> 4) | ((LBO >> 4) << 16) | (
            (SBO >> 4) << 32) | (1 << 62)

    d = desc(0x12400 + 96)
    assert d & 0x3FFF == (0x12400 + 96) >> 4
    assert (d >> 16) & 0x3FFF == 1 and (d >> 32) & 0x3FFF == 64
    assert d >> 62 == 1 and (d >> 49) & 7 == 0
    assert (227 * 1024) >> 4 < 1 << 14
