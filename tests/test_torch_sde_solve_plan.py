"""Kernel 10's CTA layout (``fused_sde_solve.sde_solve_plan``, mirroring
``csrc/sde_solve.cu``) and a float32 model of its error partial, without
the card.

A CTA of twelve warps owns a block of four rows: the descent's draws spread
over every thread, a stage's outputs on the two thread groups of
``sde.cuh::sde_stage_eval`` (each output still one thread's sum), and the
block's error partial as the first port's 64 threads summed it (their
strided fmaf chains, then block_sum<64>'s tree), which one warp emulates
(``tdmlp.cuh::warp_block_sum_sq``). The tests check the plan at batches
from 7 to 4,096 (every row block on one CTA, the shared memory, the grid
capped at the resident CTAs), its refusal past an H100's block, and the
emulated partial against the old one, bitwise. No JAX needed.
"""
import numpy as np
import pytest

from localregneuralde_tpu_torch.ops.cuda.fused_sde_solve import (
    SDE_HID_THREADS,
    SDE_OLD_THREADS,
    SDE_ROWS,
    SDE_SMEM_BYTES,
    SDE_THREADS,
    frag_floats,
    frag_set_floats,
    sde_solve_plan,
    sde_solve_smem_floats,
)
from tests.test_torch_chain_plan import fma32

F32 = np.float32
N_SM = 132  # an H100 SXM


def resident(per_sm):
    """The CTAs an H100 holds at once, per_sm an SM, whatever the shared
    memory (the card's occupancy query, modelled)."""
    return lambda smem: N_SM * per_sm


@pytest.mark.parametrize("B", [7, 13, 410, 512, 1000, 4096])
def test_plan_covers_every_row_block_once(B):
    plan = sde_solve_plan(B, 32, 64, resident(2))
    assert (plan.rows, plan.threads, plan.hid_threads) == (
        SDE_ROWS, SDE_THREADS, SDE_HID_THREADS) == (4, 384, 256)
    assert plan.n_blocks == -(-B // 4)
    assert plan.grid == min(plan.n_blocks, 2 * N_SM)
    # CTA g takes the row blocks b ≡ g (mod grid): each once
    owner = [b % plan.grid for b in range(plan.n_blocks)]
    assert sorted(set(owner)) == list(range(plan.grid))
    rows = np.zeros(B, int)
    for b in range(plan.n_blocks):
        rows[4 * b:min(B, 4 * b + 4)] += 1
    assert (rows == 1).all()
    # 64 (column pair, row) items of 384 threads: the buffered descent
    assert plan.items == 64 and plan.buffered
    # the weights (5,376 floats) and the hidden rows (256), 13 row-block
    # buffers of 128, the residuals' buffer (384), the descent's normals
    # (64 items x 31 levels, a float4 each)
    assert plan.smem_bytes == 4 * (5376 + 256 + 13 * 128 + 384
                                   + 4 * 64 * 31) == 62464
    assert plan.smem_bytes <= SDE_SMEM_BYTES


def test_plan_at_the_mnist_sde_width_one_cta_an_sm():
    # B = 512: 128 row blocks, every one on its own CTA
    plan = sde_solve_plan(512, 32, 64, resident(1))
    assert (plan.n_blocks, plan.grid) == (128, 128)
    assert sde_solve_plan(512, 32, 64).grid == 128


@pytest.mark.parametrize("F, H", [(13, 40), (33, 70), (7, 9), (200, 8)])
def test_generic_widths(F, H):
    plan = sde_solve_plan(410, F, H, resident(3))
    assert plan.items == 4 * (-(-F // 2))
    # past 384 items a thread descends whole items on its own
    assert plan.buffered == (plan.items < SDE_THREADS)
    assert plan.smem_bytes == 4 * sde_solve_smem_floats(F, H)


@pytest.mark.parametrize("F, H", [(32, 64), (13, 40), (33, 70)])
def test_tf32_plan_adds_the_forward_fragment_copies(F, H):
    """At the TF32 tier a CTA keeps, after the FP32 weights and the hidden
    rows (16-byte aligned), the forward's fragment copies of W1ᵀ, W2ᵀ and
    Wdᵀ (csrc/sde.cuh): 16 × 8 tiles of 128 floats, zero past M and K. At
    the MNIST-SDE width they are the three matrices' 5,120 floats (20 KB),
    and B = 512 still takes one CTA a row block, resident at once."""
    frag = frag_set_floats(F, H)
    assert frag == frag_floats(H, F) + frag_floats(F, H) + frag_floats(F, F)
    assert frag % 128 == 0 and frag >= 2 * F * H + F * F
    extra = sde_solve_smem_floats(F, H, "tf32") - sde_solve_smem_floats(F, H)
    assert frag <= extra < frag + 4
    plan = sde_solve_plan(512, F, H, resident(1), tier="tf32")
    assert plan.smem_bytes == 4 * sde_solve_smem_floats(F, H, "tf32")
    assert plan.smem_bytes <= SDE_SMEM_BYTES and plan.grid == 128
    if (F, H) == (32, 64):
        assert frag == 2 * F * H + F * F == 5120


def test_plan_refuses_past_a_block():
    """The widest hidden layer at F = 32 and the widest state at H = 64
    whose CTA fits 227 KB; one unit wider is refused before the library
    loads."""
    H = max(h for h in range(64, 2000)
            if 4 * sde_solve_smem_floats(32, h) <= SDE_SMEM_BYTES)
    F = max(f for f in range(32, 400)
            if 4 * sde_solve_smem_floats(f, 64) <= SDE_SMEM_BYTES)
    assert sde_solve_plan(512, 32, H).smem_bytes <= SDE_SMEM_BYTES
    assert sde_solve_plan(512, F, 64).smem_bytes <= SDE_SMEM_BYTES
    for f, h in ((32, H + 1), (F + 1, 64)):
        with pytest.raises(ValueError, match="shared memory"):
            sde_solve_plan(512, f, h)
    with pytest.raises(ValueError, match="resident"):
        sde_solve_plan(512, 32, 64, lambda smem: 0)


# ---- the error partial


def old_partial(res, threads=SDE_OLD_THREADS):
    """block_sum<64> of the first port: thread t's fmaf chain over elements
    t, t + 64, ..., then red[t] += red[t + s] for s = 32, ..., 1."""
    red = np.zeros(threads, F32)
    for i, v in enumerate(res):
        red[i % threads] = fma32(v, v, red[i % threads])
    s = threads // 2
    while s:
        red[:s] = red[:s] + red[s:2 * s]
        s //= 2
    return red[0]


def warp_partial(res, threads=SDE_OLD_THREADS):
    """tdmlp.cuh::warp_block_sum_sq<T>: lane l holds the chains of threads
    l + 32m; e[m] += e[m + h] for h = T / 64, ..., 1; then v += shfl_down(v,
    s) for s = 16, ..., 1 (lane 0 keeps the sum)."""
    M = threads // 32
    e = np.zeros((32, M), F32)
    for i, v in enumerate(res):
        t = i % threads
        e[t % 32, t // 32] = fma32(v, v, e[t % 32, t // 32])
    h = M // 2
    while h:
        e[:, :h] = e[:, :h] + e[:, h:2 * h]
        h //= 2
    v = e[:, 0]
    s = 16
    while s:
        v = v + np.concatenate([v[s:], v[:s]])  # lanes past 31: unused
        s //= 2
    return v[0]


@pytest.mark.parametrize("F", [32, 20, 70, 5])
def test_error_partial_bitwise(F):
    # scaled residuals of every magnitude; blocks of 1 to 4 rows (F = 70:
    # 280 elements, chains of up to five)
    rng = np.random.default_rng(F)
    for nrows in (4, 3, 1):
        res = (rng.standard_normal(nrows * F)
               * 10.0 ** rng.uniform(-6, 3, nrows * F)).astype(F32)
        old, new = old_partial(res), warp_partial(res)
        assert old.tobytes() == new.tobytes()
