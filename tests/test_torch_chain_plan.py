"""The grid of the Dense-chain kernels (kernels 5 and 9, a warp a row) and
float32 models of the sums they must keep bitwise.

- ``chain_plan`` mirrors the CUDA grid (``csrc/chain_rows.cuh::chain_grid``):
  every batch row lies in exactly one 4-row error block, every error block
  belongs to exactly one CTA (one warp a row), the grid stays within the
  resident CTAs (J blocks a CTA where it would not), a CTA's shared memory
  fits an H100's, and what cannot run is refused.
- The error norm: the old kernel's order (per 4-row block, 256 strided fmaf
  chains, then block_sum<256>'s tree, then the blocks' partials in order)
  against the new one (one warp holding the 256 chains, eight a lane, the
  tree's first three levels in registers and its last five as shuffles,
  then the same fold), bitwise in float32.
- A layer's sums: each output's four interleaved FFMA accumulators, added
  (0+1)+(2+3), computed through the old CTA-wide thread mappings and
  through the new lane-an-output mapping of a warp, bitwise in float32.

float32 fmaf is modelled exactly: the product of two float32 values is
exact in float64, the sum's rounding error is recovered (TwoSum), and the
one rounding to float32 resolves a float64 tie by that error.
"""
import numpy as np
import pytest

from localregneuralde_tpu_torch.ops.cuda.fused_solve import (
    CHAIN_MAX_J,
    CHAIN_ROWS,
    CHAIN_SMEM_BYTES,
    CHAIN_SWEEP_MAX_J,
    DenseChainSpec,
    chain_limits,
    chain_plan,
    chain_smem_floats,
)

F32, F64 = np.float32, np.float64
PHYSIONET = (20, 40, 20, 40, 20, 40, 20, 40, 20)
N_SM = 132  # an H100 SXM


def fma32(a, b, c):
    """float32 fmaf(a, b, c), elementwise, with one rounding."""
    a, b, c = (np.asarray(v, F32) for v in (a, b, c))
    p = a.astype(F64) * b.astype(F64)  # exact
    c64 = c.astype(F64)
    s = p + c64
    bv = s - p
    e = (p - (s - bv)) + (c64 - bv)  # s + e == p + c exactly
    r = s.astype(F32)
    r64 = r.astype(F64)
    toward = np.where(s > r64, np.inf, -np.inf).astype(F32)
    other = np.nextafter(r, toward)
    tie = (s != r64) & (2 * s == r64 + other.astype(F64)) & (e != 0)
    # a tie that the float64 sum's error breaks: round toward the error
    up = np.where(e > 0, np.maximum(r, other), np.minimum(r, other))
    return np.where(tie, up, r).astype(F32)


def test_fma32_rounds_once():
    a = F32(1 + 2 ** -12)
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24, halfway between two float32s: an
    # fma adds -1 and keeps the low bit a rounded product would lose
    assert fma32(a, a, F32(-1)) == F32(2 ** -11 + 2 ** -24)
    assert F32(a * a) - F32(1) == F32(2 ** -11)


def h100_resident(threads=128, regs=64):
    """CTAs of the chain kernels an H100 holds at a shared memory size: a
    model of the occupancy query (227 KB and 2,048 threads an SM, 1 KB of
    each CTA's shared memory reserved, the kernels' ~2.5 KB of static
    shared memory)."""
    def resident(smem):
        if smem + 2560 > 232448:
            return 0
        by_smem = (228 * 1024) // (smem + 2560 + 1024)
        by_threads = 2048 // threads
        by_regs = 65536 // (threads * regs)
        return N_SM * min(by_smem, by_threads, by_regs)

    return resident


@pytest.mark.parametrize("B", [7, 410, 512, 1000])
@pytest.mark.parametrize("kernel", ["solve", "sweep dense", "sweep two-level"])
def test_every_row_and_block_once(B, kernel):
    resident = h100_resident()
    sweep = kernel != "solve"
    plan = chain_plan(B, PHYSIONET, resident, sweep=sweep,
                      two_level=kernel == "sweep two-level")
    n_blk = -(-B // CHAIN_ROWS)
    owner = np.full(n_blk, -1)
    for cta, (first, count) in enumerate(plan.blocks):
        assert 1 <= count <= plan.J
        assert (owner[first:first + count] == -1).all()
        owner[first:first + count] = cta
    assert (owner >= 0).all() and len(plan.blocks) == plan.grid
    # blocks of 4 rows from row 0: each row in exactly one, a warp a row
    rows = np.zeros(B, int)
    for b in range(n_blk):
        rows[4 * b:min(B, 4 * b + 4)] += 1
    assert (rows == 1).all()
    assert plan.smem_bytes <= CHAIN_SMEM_BYTES
    if kernel != "sweep dense":
        assert plan.grid <= resident(plan.smem_bytes)
    else:
        assert plan.J == 1 and plan.grid == n_blk


def test_physionet_grids_and_shared_memory():
    resident = h100_resident()
    solve = chain_plan(512, PHYSIONET, resident)
    sweep = chain_plan(512, PHYSIONET, resident, sweep=True)
    # 128 CTAs of one block each, one an SM; kernel 5 takes 32 KB a CTA
    # (W_lᵀ with rows of 20 or 44 floats, and b_l: 6,960 floats), kernel 9
    # 139 KB (W_lᵀ, W_l with rows of 44 or 20 floats, the gradient partial,
    # the four rows' stash of six stages and the replay's rows)
    assert (solve.J, solve.grid) == (1, 128) and (sweep.J, sweep.grid) == (1, 128)
    fwd = 4 * (40 * 20 + 40) + 4 * (20 * 44 + 20)
    rev = 4 * (20 * 44) + 4 * (40 * 20)
    assert (fwd, rev) == (6960, 6720)
    assert solve.smem_bytes == 4 * (fwd + 2 * 4 * 40 + 9 * 80 + 80) == 32320
    assert sweep.smem_bytes == 4 * (fwd + rev + 6640
                                    + 4 * (6 * 480 + 15 * 20 + 80)
                                    + 9 * 80 + 80 + 512) == 138688
    assert chain_limits(DenseChainSpec(PHYSIONET, (True,) * 8, True), 50,
                        cuda=False) is None


def test_shared_memory_limit():
    # the widest 2-layer chain F -> H -> F whose sweep fits CHAIN_SMEM_BYTES
    # runs; one unit wider is refused
    F = 64
    fits = [H for H in range(8, 400)
            if 4 * chain_smem_floats((F, H, F), 1, sweep=True)
            <= CHAIN_SMEM_BYTES]
    H = max(fits)
    resident = h100_resident()
    assert chain_plan(512, (F, H, F), resident, sweep=True).J == 1
    with pytest.raises(ValueError, match="does not fit"):
        chain_plan(512, (F, H + 1, F), resident, sweep=True)
    # kernel 5 alone takes a wider chain
    assert 4 * chain_smem_floats((F, H + 1, F), 1) <= CHAIN_SMEM_BYTES


def test_more_blocks_a_cta_and_refusal():
    # a card that holds only 64 CTAs: B = 1000 (250 blocks) needs 4 blocks a
    # CTA; a batch past CHAIN_MAX_J blocks a resident CTA is refused
    few = lambda smem: 64 if 4 * smem <= 4 * CHAIN_SMEM_BYTES else 0  # noqa
    plan = chain_plan(1000, PHYSIONET, few)
    assert (plan.J, plan.grid) == (4, 63)
    sweep = chain_plan(1000, PHYSIONET, few, sweep=True)
    assert sweep.J == 4 and sweep.smem_bytes <= CHAIN_SMEM_BYTES
    with pytest.raises(ValueError):
        chain_plan(4 * 64 * CHAIN_MAX_J + 4, PHYSIONET, few)
    with pytest.raises(ValueError):
        chain_plan(4 * 64 * CHAIN_SWEEP_MAX_J + 4, PHYSIONET, few, sweep=True)


# ---- the error norm


def old_block_partial(res):
    """block_sum<256> over a block's residuals as the old kernel's 256
    threads formed it: thread t's fmaf chain over elements t, t + 256, ...,
    then red[t] += red[t + s] for s = 128, ..., 1."""
    red = np.zeros(256, F32)
    for i, v in enumerate(res):
        red[i % 256] = fma32(v, v, red[i % 256])
    s = 128
    while s:
        red[:s] = red[:s] + red[s:2 * s]
        s //= 2
    return red[0]


def new_block_partial(res):
    """chain_rows.cuh::block_error: lane l holds the chains of threads l +
    32m, m < 8; e[m] += e[m + 4], then e[m] += e[m + 2], then e[0] += e[1];
    then v += shfl_down(v, s) for s = 16, ..., 1 (lane 0 keeps the sum)."""
    e = np.zeros((32, 8), F32)
    for i, v in enumerate(res):
        t = i % 256
        e[t % 32, t // 32] = fma32(v, v, e[t % 32, t // 32])
    e[:, :4] = e[:, :4] + e[:, 4:]
    e[:, 0] = e[:, 0] + e[:, 2]
    e[:, 1] = e[:, 1] + e[:, 3]
    v = e[:, 0] + e[:, 1]
    s = 16
    while s:
        down = np.concatenate([v[s:], v[:s]])  # lanes past 31 wrap, unused
        v = v + down
        s //= 2
    return v[0]


def ordered_fold(partials):
    total = F32(0)
    for p in partials:
        total = F32(total + p)
    return total


@pytest.mark.parametrize("B, F", [(7, 20), (410, 20), (64, 70), (9, 96)])
def test_error_norm_bitwise(B, F):
    # random scaled residuals of every magnitude, whole and partial blocks
    # (B = 410 ends in a 2-row block; F = 70 and 96 give blocks over 256
    # elements, so threads hold chains of two)
    rng = np.random.default_rng(B * F)
    res = (rng.standard_normal((B, F))
           * 10.0 ** rng.uniform(-6, 3, (B, F))).astype(F32)
    old, new = [], []
    for b in range(-(-B // CHAIN_ROWS)):
        blk = res[4 * b:4 * b + 4].reshape(-1)
        old.append(old_block_partial(blk))
        new.append(new_block_partial(blk))
    assert np.array_equal(np.array(old), np.array(new))
    assert ordered_fold(old).tobytes() == ordered_fold(new).tobytes()


# ---- a layer's sums


def layer_sum(x, W, o):
    """One output of the layer for one row: four interleaved fmaf
    accumulators over k, added (0+1)+(2+3)."""
    acc = np.zeros(4, F32)
    for k in range(x.shape[0]):
        acc[k % 4] = fma32(x[k], W[k, o], acc[k % 4])
    return F32(F32(acc[0] + acc[1]) + F32(acc[2] + acc[3]))


def old_layer(x, W, threads=256):
    """chain.cuh::chain_forward's mappings: with G = threads // dout row
    groups of at least the rows, thread i takes (row i // dout, output
    i % dout); otherwise thread (g, o) takes output o of rows g, g + G, ...
    (a weight loaded once for its rows)."""
    R, dout = x.shape[0], W.shape[1]
    out = np.zeros((R, dout), F32)
    G = threads // dout if dout < threads else 1
    if G >= R:
        for i in range(R * dout):
            out[i // dout, i % dout] = layer_sum(x[i // dout], W, i % dout)
        return out
    for it in range(G * dout):
        g, o = it // dout, it % dout
        for r in range(g, R, G):
            out[r, o] = layer_sum(x[r], W, o)
    return out


def new_layer(x, W):
    """chain_rows.cuh::warp_chain: warp r owns row r; lane l takes outputs
    l, l + 32, ... of it."""
    R, dout = x.shape[0], W.shape[1]
    out = np.zeros((R, dout), F32)
    for r in range(R):
        for lane in range(32):
            for o in range(lane, dout, 32):
                out[r, o] = layer_sum(x[r], W, o)
    return out


@pytest.mark.parametrize("din, dout, threads",
                         [(20, 40, 256), (40, 20, 256), (64, 96, 64),
                          (13, 7, 16)])
def test_layer_sum_order_independent_of_mapping(din, dout, threads):
    rng = np.random.default_rng(din * dout)
    x = rng.standard_normal((4, din)).astype(F32)
    W = rng.standard_normal((din, dout)).astype(F32)
    old = old_layer(x, W, threads)
    assert np.array_equal(old, new_layer(x, W))
    # and not the same as one running sum: the order matters
    run = np.zeros((4, dout), F32)
    for k in range(din):
        run = fma32(x[:, k:k + 1], W[k], run)
    assert not np.array_equal(old, run) or din < 5
