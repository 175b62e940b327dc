"""CPU models of kernel 13's new arithmetic (``csrc/conv_core.cuh``).

1. The BatchNorm statistics from the conv epilogue. Each 128-pixel tile of
   the N = 64 GEMM tile sums its outputs per channel (a thread's eight rows
   ty + 16·i in order, then the sixteen threads in order), takes the tile
   mean and the M2 about it; the last CTA of each group of sixteen tiles
   folds the group's (sum, M2) slots and the last group the groups', by
   Chan's combination of all items at once (two lanes a channel, each over
   half the items in order, the lanes added in order):

       S = Σ S_i,  mean = S / n,  M2 = Σ [M2_i + n_i (S_i / n_i − mean)²].

   The model repeats that order in float32 (an FMA as a multiply and an
   add) at cnn.yaml's M = 32,768 pixels and C = 64 channels, on z from the
   port's conv of numpy-seeded inputs, and is held against float64
   two-pass statistics and against the JAX reference's BatchNorm batch
   statistics. Tolerance: 1e-6 of the std for the mean and 1e-6 relative
   for the variance (a float32 mean near 6 at unit std resolves to 2.4e-7
   of the std), and at most twice the error of float32 two-pass statistics
   of the same z; against the reference's own float32 statistics (whose
   mean is 1.3e-6 of the std from float64 here), 3e-6 and 1e-6. On the
   card (chip_smoke.py's [conv stats fp64], NVIDIA H100 80GB HBM3, 700 W)
   the kernel's error is 6.3e-8 of the std and 1.2e-7 relative, the first
   port's two-pass kernel's 5.1e-7 and 4.8e-7.
2. The halo tile of the thin convs: which pixels a CTA stages (the image
   rows its 128 pixels span, one above and below, a zero column each side)
   and which halo cell each tap reads (zero where the tap leaves the
   pixel's own image, since a tile may span two images), against a direct
   3x3 SAME convolution, exactly in float64.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.nn import BatchNorm as JBatchNorm
from localregneuralde_tpu_torch.nn.basic import conv2d_nhwc, conv2d_nhwc_td

TILE, NY, GROUPS, LANES = 128, 16, 16, 2  # rows a tile, row threads, groups, lanes


def _z(seed=0, B=32, H=32, W=32, cin=8, cout=64):
    """A conv1 output at cnn.yaml's shapes: (B·H·W, cout) float32."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((B, H, W, cin)), dtype=torch.float32)
    lim = math.sqrt(6.0 / (9 * (cin + 1) + cout))
    w = torch.tensor(rng.uniform(-lim, lim, (3, 3, cin + 1, cout)),
                     dtype=torch.float32)
    # an offset per channel makes the mean large beside the spread, where a
    # one-pass variance would cancel
    z = conv2d_nhwc_td(x, w, 0.3) + torch.linspace(-4.0, 6.0, cout)
    return z.reshape(-1, cout)


def _fold(S, M2, n, rows):
    """fold_moments over items (S, M2, n) in order: LANES lanes, each over
    ceil(count / LANES) items in order, the lanes added in order."""
    count = S.shape[0]
    per = -(-count // LANES)
    lanes = [slice(l * per, min(count, (l + 1) * per)) for l in range(LANES)]

    def lane_sum(vals):
        out = torch.zeros_like(S[0])
        for v in vals:
            out = out + v
        return out

    s = lane_sum([lane_sum(list(S[sl])) for sl in lanes])
    mean = s / rows
    terms = M2 + n[:, None] * (S / n[:, None] - mean) ** 2
    m2 = lane_sum([lane_sum(list(terms[sl])) for sl in lanes])
    return s, mean, m2


def epilogue_stats(z):
    """The kernel's batch mean and variance of z (M, C) in its order."""
    M, C = z.shape
    T = -(-M // TILE)
    zt = torch.zeros(T * TILE, C)
    zt[:M] = z
    rows = torch.tensor([min(TILE, M - t * TILE) for t in range(T)],
                        dtype=torch.float32)
    valid = (torch.arange(T * TILE) < M).reshape(T, TILE // NY, NY, 1)
    v = zt.reshape(T, TILE // NY, NY, C)  # [tile, i, ty, c]: row ty + NY·i

    def ordered(x):  # a thread's rows in order, then the threads in order
        per_thread = torch.zeros(T, NY, C)
        for i in range(TILE // NY):
            per_thread = per_thread + torch.where(valid[:, i], x[:, i], 0.0)
        tot = torch.zeros(T, C)
        for y in range(NY):
            tot = tot + per_thread[:, y]
        return tot

    S = ordered(v)
    mean_t = S / rows[:, None]
    M2 = ordered((v - mean_t[:, None, None]) ** 2)
    G = -(-T // GROUPS)
    gS, gM2, gn = [], [], []
    for g0 in range(0, T, G):
        sl = slice(g0, min(T, g0 + G))
        n_g = float(rows[sl].sum())
        s, _, m2 = _fold(S[sl], M2[sl], rows[sl], n_g)
        gS.append(s)
        gM2.append(m2)
        gn.append(n_g)
    _, mean, m2 = _fold(torch.stack(gS), torch.stack(gM2),
                        torch.tensor(gn), float(M))
    return mean, m2 / M


def _errors(mean, var, z64):
    m64 = z64.mean(0)
    v64 = ((z64 - m64) ** 2).mean(0)
    return (float(((mean.double() - m64).abs() / v64.sqrt()).max()),
            float(((var.double() - v64).abs() / v64).max()))


@pytest.mark.parametrize("seed", [0, 1])
def test_epilogue_statistics_against_float64(seed):
    z = _z(seed)
    assert z.shape == (32768, 64)
    mean, var = epilogue_stats(z)
    e_mean, e_var = _errors(mean, var, z.double())
    m32 = z.mean(0)
    two_pass = _errors(m32, ((z - m32) ** 2).mean(0), z.double())
    assert e_mean <= 1e-6 and e_var <= 1e-6, (e_mean, e_var)
    assert e_mean <= 2 * two_pass[0] and e_var <= 2 * two_pass[1], (
        (e_mean, e_var), two_pass)


def test_epilogue_statistics_against_the_reference():
    """JAX's BatchNorm in training mode with momentum 1 returns its batch
    statistics as the new running stats (0·r + 1·stat)."""
    z = _z(2)
    mean, var = epilogue_stats(z)
    bn = JBatchNorm(64, momentum=1.0)
    params, state = bn.init(jax.random.PRNGKey(0))
    _, st = bn.apply(params, state, jnp.asarray(z.numpy()), training=True)
    ref_mean, ref_var = np.asarray(st["mean"]), np.asarray(st["var"])
    std = np.sqrt(ref_var)
    assert float((np.abs(mean.numpy() - ref_mean) / std).max()) <= 3e-6
    assert float((np.abs(var.numpy() - ref_var) / ref_var).max()) <= 1e-6


def test_ragged_tiles_and_groups():
    """M not a multiple of the tile, nor the tiles of the groups: the
    last tile's and group's counts follow min(R, M − i·R)."""
    z = _z(3, B=3, H=9, W=17, cin=4, cout=6)
    assert z.shape[0] % TILE != 0
    mean, var = epilogue_stats(z)
    e_mean, e_var = _errors(mean, var, z.double())
    assert e_mean <= 1e-6 and e_var <= 1e-6, (e_mean, e_var)


# ---------------------------------------------------------------------------
# the halo tile (conv_core.cuh::conv_halo_kernel, halo_rows)

HALO_PIX = 128


def halo_rows(W):
    """The most image rows HALO_PIX consecutive pixels from a multiple of
    HALO_PIX span at width W, plus one above and below."""
    return (W - math.gcd(HALO_PIX, W) + HALO_PIX - 1) // W + 3


def halo_conv(x, w):
    """conv_halo_kernel's reads, CTA by CTA: out (B, H, W, cout)."""
    B, H, W, cin = x.shape
    M, G = B * H * W, B * H
    rows_x = x.reshape(G, W, cin)
    out = torch.zeros(M, w.shape[-1], dtype=x.dtype)
    spans = []
    for m0 in range(0, M, HALO_PIX):
        g0 = m0 // W
        rows = (min(m0 + HALO_PIX, M) - 1) // W - g0 + 3
        spans.append(rows)
        halo = torch.zeros(rows, W + 2, cin, dtype=x.dtype)
        for hr in range(rows):
            gr = g0 - 1 + hr
            if 0 <= gr < G:
                halo[hr, 1:W + 1] = rows_x[gr]
        p = torch.arange(m0, min(m0 + HALO_PIX, M))
        g, wc = p // W, p % W
        h = g % H
        for tap in range(9):
            dy, dx = tap // 3 - 1, tap % 3 - 1
            ok = (h + dy >= 0) & (h + dy < H) & (wc + dx >= 0) & (wc + dx < W)
            a = halo[g - g0 + 1 + dy, wc + 1 + dx]
            out[p] += torch.where(ok[:, None], a, 0.0) @ w[dy + 1, dx + 1]
    return out.reshape(B, H, W, -1), spans


@pytest.mark.parametrize("B, H, W", [(2, 8, 8), (1, 32, 32), (3, 5, 24),
                                     (2, 9, 7), (1, 3, 130)])
def test_halo_tile_reads_the_direct_conv(B, H, W):
    rng = np.random.default_rng(B * 1000 + H * 10 + W)
    cin, cout = 8, 8
    x = torch.tensor(rng.standard_normal((B, H, W, cin)))
    w = torch.tensor(rng.standard_normal((3, 3, cin, cout)))
    ours, spans = halo_conv(x, w)
    torch.testing.assert_close(ours, conv2d_nhwc(x, w), rtol=0, atol=1e-12)
    # the staged rows fit the smem plan, which is tight where tiles align
    assert max(spans) <= halo_rows(W)


def test_halo_rows_bound_is_attained():
    for W in (8, 24, 32, 7, 130):
        M = 40 * W * HALO_PIX
        spans = [(min(m0 + HALO_PIX, M) - 1) // W - m0 // W + 3
                 for m0 in range(0, M, HALO_PIX)]
        assert max(spans) == halo_rows(W), W
    # cnn.yaml's 32x32 images, Ch 64: 6 rows of 34 pixels of 68 floats and
    # the 9 x 64 x 8 weight, 73,920 bytes a CTA (three CTAs an SM)
    assert 4 * (halo_rows(32) * 34 * 68 + 9 * 64 * 8) == 73920
