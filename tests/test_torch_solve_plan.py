"""The cluster plan of the persistent TD-MLP solve (kernel 4) and float32
models of the two summation orders it must keep bitwise.

- ``solve_plan`` mirrors the CUDA layout (``csrc/persistent_solve.cu``):
  every batch row lies in exactly one row block, every feature in exactly
  one CTA's residue slice, every 8-row error block in one cluster; a CTA's
  residue slice holds exactly the partials q = c and q = c + 8 of the old
  kernel's 16-way split of the first product; its shared memory fits an
  H100's 227 KB; a width no CTA can take is refused.
- The error norm: the old kernel's order (per 8-row block, 1,024 strided
  fmaf chains, then block_sum's tree, then the slots in order) against the
  new one (residuals in each CTA's segment, scattered into the natural
  tile of the block's owner, two chains a thread on 512 threads, the same
  tree), bitwise in float32.
- The first product: the old contiguous-k loop (partial q sums k ≡ q mod
  16 in increasing k, the 16 added in q order) against the residue split
  (CTA c sums its even and odd features, the owner adds the 16 pushed
  partials in q order), bitwise in float32.

float32 fmaf is modelled exactly: the product of two float32 values is
exact in float64, the sum's rounding error is recovered (TwoSum), and the
one rounding to float32 resolves a float64 tie by that error.
"""
import numpy as np
import pytest
import torch

from localregneuralde_tpu_torch.ops.cuda import TDMLPWeights, fused_solve
from localregneuralde_tpu_torch.ops.cuda.fused_solve import (
    CLUSTER_CTAS,
    CLUSTER_SMEM_BYTES,
    SOLVE_ERROR_ROWS,
    SOLVE_ROWS_MAX,
    solve_plan,
)

F32, F64 = np.float32, np.float64


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
    # exact tie rounds to even, but adding 2^-80 (lost in the float64 sum)
    # breaks it upward, which two roundings would miss
    assert fma32(a, a, F32(0.0)) == F32(1 + 2 ** -11)
    assert fma32(a, a, F32(2.0 ** -80)) == F32(1 + 2 ** -11 + 2 ** -23)
    assert fma32(a, a, F32(-2.0 ** -80)) == F32(1 + 2 ** -11)
    x = np.random.default_rng(0).standard_normal(1000).astype(F32)
    assert np.array_equal(fma32(x, x, np.zeros_like(x)), x * x)


SHAPES = [(1, 784, 100), (13, 40, 7), (410, 784, 100), (512, 784, 100),
          (1000, 785, 150)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_rows_features_and_error_blocks_once(shape):
    B, F, H = shape
    plan = solve_plan(B, F, H)
    assert plan.cluster == CLUSTER_CTAS
    assert plan.rows % SOLVE_ERROR_ROWS == 0 and plan.rows <= SOLVE_ROWS_MAX
    rows = np.zeros(B, int)
    for r0, n in plan.row_blocks:
        assert 0 < n <= plan.rows and r0 % plan.rows == 0
        rows[r0:r0 + n] += 1
    assert (rows == 1).all()
    feats = np.zeros(F, int)
    assert len(plan.features) == plan.cluster
    for fs in plan.features:
        feats[list(fs)] += 1
    assert (feats == 1).all()
    # each 8-row error block in one row block, summed by one CTA, its slot
    # the old kernel's (row / 8)
    slots = []
    for (r0, n), blocks in zip(plan.row_blocks, plan.error_blocks):
        assert len(blocks) == -(-n // SOLVE_ERROR_ROWS) <= plan.cluster
        for j, (slot, rank) in enumerate(blocks):
            assert rank == j and slot * SOLVE_ERROR_ROWS == r0 + 8 * j
            slots.append(slot)
    assert slots == list(range(-(-B // SOLVE_ERROR_ROWS)))
    assert plan.scratch_floats == 9 * B * plan.cluster * plan.seg


@pytest.mark.parametrize("F", [7, 16, 40, 784, 785])
def test_residue_slices_hold_partials_c_and_c_plus_8(F):
    plan = solve_plan(8, F, 16)
    for c, fs in enumerate(plan.features):
        assert all(f % CLUSTER_CTAS == c for f in fs)
        ne = -(-len(fs) // 2)
        even, odd = fs[:ne], fs[ne:]
        assert all(f % 16 == c for f in even) and list(even) == sorted(even)
        assert all(f % 16 == c + 8 for f in odd) and list(odd) == sorted(odd)
        assert {f % 16 for f in fs} <= {c, c + 8}
        # the even ones first, the odd ones from odd0, inside the segment
        assert ne <= plan.odd0 and plan.odd0 + len(odd) <= plan.seg
        assert plan.odd0 % 4 == 0 and plan.seg % 4 == 0


@pytest.mark.parametrize("H,shared", [(100, True), (150, False),
                                      (360, False)])
def test_shared_memory_fits_a_cta_at_784(H, shared):
    plan = solve_plan(512, 784, H)
    assert plan.smem_bytes <= CLUSTER_SMEM_BYTES < 227 * 1024
    assert plan.weights_shared == shared
    assert plan.rows == SOLVE_ROWS_MAX
    if H == 100:
        # 13 clusters of 40 rows at B = 512, 180.4 KB a CTA
        assert len(plan.row_blocks) == 13 and plan.smem_bytes == 180384


def test_plan_takes_every_width_the_old_kernel_took():
    """The old kernel took F = 784 up to H = 373 (its shared memory,
    tdmlp.cuh::smem_floats); the plan takes all of them, with fewer rows a
    cluster at the widest."""
    for H in range(1, 374, 31):
        plan = solve_plan(64, 784, H)
        assert plan.smem_bytes <= CLUSTER_SMEM_BYTES
    assert solve_plan(64, 784, 373).rows < SOLVE_ROWS_MAX


def test_launch_refuses_what_cannot_run():
    """A width whose tiles overflow a CTA even at 8 rows a cluster raises
    before any library load."""
    for F, H in ((784, 6000), (8000, 16)):
        with pytest.raises(ValueError, match="shared memory"):
            solve_plan(8, F, H)
    b, f, h = 2, 784, 6000
    w = TDMLPWeights(torch.zeros(f + 1, h), torch.zeros(h),
                     torch.zeros(h + 1, f), torch.zeros(f))
    with pytest.raises(ValueError, match="shared memory"):
        fused_solve._launch_solve(w, torch.zeros(b, f), (0.0, 1.0), rtol=1e-4,
                                  atol=1e-4, saveat_arr=torch.ones(1),
                                  max_steps=4)


def _tree(red):
    """csrc/tdmlp.cuh::block_sum's tree over 1,024 values."""
    red = red.copy()
    s = red.size // 2
    while s > 0:
        red[:s] = red[:s] + red[s:2 * s]
        s //= 2
    return red[0]


def _chains(vals, first, stride, count):
    """``count`` fmaf chains of squares: chain t over vals[first + t + stride
    n], from 0, in n order (zeros past the end add nothing)."""
    n = -(-max(vals.size - first, 0) // stride) * stride
    padded = np.zeros(max(n, stride) + stride, F32)
    padded[:max(vals.size - first, 0)] = vals[first:]
    acc = np.zeros(count, F32)
    for r in range(0, n, stride):
        v = padded[r:r + count]
        acc = fma32(v, v, acc)
    return acc


def _old_norm(res):
    """The old kernel: per 8-row block, thread t of 1,024 chains the block's
    elements t, t + 1024, ... (row-major), then the tree; the slots in
    order."""
    B, F = res.shape
    total = F32(0)
    for b0 in range(0, B, SOLVE_ERROR_ROWS):
        block = res[b0:b0 + SOLVE_ERROR_ROWS].reshape(-1)
        total = F32(total + _tree(_chains(block, 0, 1024, 1024)))
    return total


def _new_norm(res, plan):
    """The cluster kernel: each CTA holds its residuals in its segment
    (plan.features' order); it scatters them into the natural-layout tile
    of the CTA that owns their 8-row block; the owner's thread t chains the
    old threads t and t + 512, then the same tree; the slots in order."""
    B, F = res.shape
    slots = {}
    for (r0, n), blocks in zip(plan.row_blocks, plan.error_blocks):
        segs = [res[r0:r0 + n][:, list(fs)] for fs in plan.features]
        tiles = {}
        for c, fs in enumerate(plan.features):
            for r in range(n):
                owner = r // SOLVE_ERROR_ROWS
                tile = tiles.setdefault(owner, np.full(8 * F, np.nan, F32))
                tile[(r % 8) * F + np.array(fs, int)] = segs[c][r]
        for slot, rank in blocks:
            m = min(SOLVE_ERROR_ROWS, n - SOLVE_ERROR_ROWS * rank) * F
            tile = tiles[rank][:m]
            assert not np.isnan(tile).any()
            red = np.concatenate([_chains(tile, 0, 1024, 512),
                                  _chains(tile, 512, 1024, 512)])
            slots[slot] = _tree(red)
    total = F32(0)
    for slot in sorted(slots):
        total = F32(total + slots[slot])
    return total


@pytest.mark.parametrize("B", [8, 40, 410, 512])
def test_error_norm_order_is_bitwise_the_old(B):
    F, H = 784, 100
    rng = np.random.default_rng(B)
    # scaled residuals spread over orders of magnitude
    res = (rng.standard_normal((B, F))
           * np.exp(rng.uniform(-8, 2, (B, F)))).astype(F32)
    plan = solve_plan(B, F, H)
    old, new = _old_norm(res), _new_norm(res, plan)
    assert np.isfinite(old) and old.tobytes() == new.tobytes()


def _old_first_product(x, w1):
    """tdmlp.cuh::tdmlp_rows: partial q = fmaf chain over k ≡ q (mod 16) in
    increasing k; z = 0, z += partial q in q order."""
    B, F = x.shape
    z = np.zeros((B, w1.shape[1]), F32)
    for q in range(16):
        acc = np.zeros_like(z)
        for k in range(q, F, 16):
            acc = fma32(x[:, k, None], w1[None, k, :], acc)
        z = (z + acc).astype(F32)
    return z


def _new_first_product(x, w1, plan):
    """The cluster kernel: CTA c chains its even features (partial c) and
    its odd ones (partial c + 8) in segment order and pushes both into the
    owner's inbox; the owner adds the 16 in q order from 0."""
    B = x.shape[0]
    inbox = [None] * 16
    for c, fs in enumerate(plan.features):
        ne = -(-len(fs) // 2)
        for q, part in ((c, fs[:ne]), (c + 8, fs[ne:])):
            acc = np.zeros((B, w1.shape[1]), F32)
            for k in part:
                acc = fma32(x[:, k, None], w1[None, k, :], acc)
            inbox[q] = acc
    z = np.zeros_like(inbox[0])
    for q in range(16):
        z = (z + inbox[q]).astype(F32)
    return z


@pytest.mark.parametrize("shape", [(40, 784, 100), (9, 37, 7), (3, 12, 5)])
def test_first_product_residue_split_is_bitwise_the_old(shape):
    B, F, H = shape
    rng = np.random.default_rng(F)
    x = rng.standard_normal((B, F)).astype(F32)
    w1 = (rng.standard_normal((F, H)) / np.sqrt(F)).astype(F32)
    plan = solve_plan(B, F, H)
    old, new = _old_first_product(x, w1), _new_first_product(x, w1, plan)
    assert old.tobytes() == new.tobytes()
    # and not an order-blind check: one running sum over k differs
    one = np.zeros_like(old)
    for k in range(F):
        one = fma32(x[:, k, None], w1[None, k, :], one)
    if F >= 16:
        assert old.tobytes() != one.tobytes()
