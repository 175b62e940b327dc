"""Kernel 6's grid (``fused_solve.pf_plan``, mirroring
``csrc/pf_solve.cu::pf_grid``) and float32 models of the sums its warp-row
layout must keep bitwise, without the card.

- The plan: CTAs of eight warps, each owning J 8-row error blocks (the
  least J that keeps one CTA an SM, raised until the grid is resident),
  warp w the 4-row groups q ≡ w (mod 8) of them: every batch row on one
  warp of one CTA, every error block on one CTA, the shared memory, and
  the refusal where nothing fits.
- The error partial of an 8-row block: the first port's 128 threads
  (strided fmaf chains, then block_sum<128>'s tree) against one warp's
  emulation (``tdmlp.cuh::warp_block_sum_sq``).
- An evaluation of the score chain with a time row in every layer: the
  first port's CTA-wide mappings (``chain.cuh::chain_forward``, 128
  threads and 8 rows: a thread an output for a group of rows, or a thread a
  (row, output)) against the warp-row mappings of ``score_rows.cuh``: a
  lane an output (lane o takes outputs o and o + 32 of four rows, the
  float4 chunks of ``rows_dots`` in their order, or a lane a (row, output)
  in a narrow layer) and the kernel's, whose last layer (two outputs) has
  each item's four accumulators on four lanes, gathered by butterfly
  additions (``split_layer``); then the ½β(x + s) combination, bitwise.

float32 fmaf is ``tests/test_torch_chain_plan.fma32``. No JAX needed.
"""
import numpy as np
import pytest

from localregneuralde_tpu_torch.ops.cuda.fused_solve import (
    CHAIN_SMEM_BYTES,
    PF_ERROR_ROWS,
    PF_MAX_J,
    PF_OLD_THREADS,
    PF_THREADS,
    PF_WARP_ROWS,
    PF_WARPS,
    pf_plan,
    pf_smem_floats,
)
from tests.test_torch_chain_plan import fma32, h100_resident
from tests.test_torch_sde_solve_plan import old_partial, warp_partial

F32 = np.float32
DEMO = (2, 64, 64, 2)  # scripts/score_sde_demo.py:66


def _rows_of(plan, B):
    """(CTA, warp) of every batch row under the plan's group assignment."""
    owner = {}
    for cta, (first, count) in enumerate(plan.blocks):
        for q in range(2 * count):
            warp = q % PF_WARPS
            j, r0 = q // 2, (q % 2) * PF_WARP_ROWS
            for r in range(PF_WARP_ROWS):
                row = (first + j) * PF_ERROR_ROWS + r0 + r
                if row < B:
                    assert row not in owner
                    owner[row] = (cta, warp)
    return owner


@pytest.mark.parametrize("B", [7, 13, 410, 512, 1000, 4096])
def test_every_row_on_one_warp(B):
    resident = h100_resident(threads=PF_THREADS)
    plan = pf_plan(B, DEMO, resident)
    n_blk = -(-B // 8)
    assert plan.threads == PF_THREADS == 256
    assert plan.J == max(1, -(-n_blk // 132)) and plan.grid <= 132
    assert plan.grid == -(-n_blk // plan.J) <= resident(plan.smem_bytes)
    blocks = [b for first, count in plan.blocks
              for b in range(first, first + count)]
    assert blocks == list(range(n_blk))
    assert sorted(_rows_of(plan, B)) == list(range(B))
    assert plan.smem_bytes == 4 * pf_smem_floats(DEMO, plan.J)
    assert plan.smem_bytes <= CHAIN_SMEM_BYTES


def test_demo_grid_and_shared_memory():
    plan = pf_plan(4096, DEMO, h100_resident(threads=PF_THREADS))
    # 512 error blocks, four a CTA: 128 CTAs of 32 rows, a 4-row group a
    # warp. The network as W_lᵀ (rows of 4 and 68 floats) with its time
    # rows and biases: 5,008 floats; each warp's stage input and two
    # activation buffers: 4 x (4 + 2 x 68); four blocks of 8 rows x F = 2,
    # ten buffers each (u, k1..k7, u_new, the residuals)
    assert (plan.J, plan.grid) == (4, 128)
    net = 64 * 4 + 2 * 64 + 64 * 68 + 2 * 64 + 2 * 68 + 2 * 4
    assert net == 5008
    assert plan.smem_bytes == 4 * (net + 8 * 4 * (4 + 2 * 68)
                                   + 4 * 10 * 8 * 2) == 40512
    # rows carried a warp: every warp of every CTA busy
    owner = _rows_of(plan, 4096)
    assert all(sum(1 for v in owner.values() if v == (c, w)) == 4
               for c in range(128) for w in range(8))


def test_refusal():
    # a card holding 64 CTAs takes B = 8 * 64 * PF_MAX_J, not one block more
    few = lambda smem: 64  # noqa: E731
    assert pf_plan(8 * 64 * PF_MAX_J, DEMO, few).J == PF_MAX_J
    with pytest.raises(ValueError, match="does not fit"):
        pf_plan(8 * 64 * PF_MAX_J + 8, DEMO, few)
    # a network whose CTA outgrows the shared memory
    with pytest.raises(ValueError, match="does not fit"):
        pf_plan(512, (2, 256, 256, 2), h100_resident(threads=PF_THREADS))
    assert 4 * pf_smem_floats((2, 256, 256, 2), 1) > CHAIN_SMEM_BYTES


# ---- the error partial


@pytest.mark.parametrize("F", [2, 20, 3])
def test_error_partial_bitwise(F):
    # 8-row blocks (F = 20: 160 elements, two a thread) and ragged ones
    rng = np.random.default_rng(F)
    for nrows in (8, 5, 1):
        res = (rng.standard_normal(nrows * F)
               * 10.0 ** rng.uniform(-6, 3, nrows * F)).astype(F32)
        old = old_partial(res, PF_OLD_THREADS)
        assert old.tobytes() == warp_partial(res, PF_OLD_THREADS).tobytes()


# ---- an evaluation of the score chain


def out_sum(x, Wt, o):
    """Output o of one row before its epilogue: four interleaved fmaf
    accumulators over k in increasing k, added (0+1)+(2+3)."""
    acc = np.zeros(4, F32)
    for k in range(x.shape[0]):
        acc[k % 4] = fma32(x[k], Wt[o, k], acc[k % 4])
    return F32(F32(acc[0] + acc[1]) + F32(acc[2] + acc[3]))


def epilogue(z, t, tw, b, tanh):
    """The time term rounded on its own, then the bias, then tanh."""
    z = F32(z + F32(F32(t) * tw))
    z = F32(z + b)
    return np.tanh(z, dtype=F32) if tanh else z


def old_eval(x, layers, t, threads=128):
    """chain.cuh::chain_forward for a block of rows: per layer, with G =
    threads // dout row groups, G >= rows: thread i takes (row i // dout,
    output i % dout); otherwise thread (g, o) output o of rows g, g + G,
    ...; each output the same sum and epilogue."""
    a = x
    for Wt, tw, b, tanh in layers:
        R, dout = a.shape[0], Wt.shape[0]
        out = np.zeros((R, dout), F32)
        G = threads // dout if dout < threads else 1
        if G >= R:
            items = [(i // dout, i % dout) for i in range(R * dout)]
        else:
            items = [(r, it % dout) for it in range(G * dout)
                     for r in range(it // dout, R, G)]
        for r, o in items:
            out[r, o] = epilogue(out_sum(a[r], Wt, o), t, tw[o], b[o], tanh)
        a = out
    return a


def rows_dots(xs, ws, n, chunk=2):
    """score_rows.cuh::rows_dots: the float4 chunks of every (row, weight
    row) pair in its order, the tail's partial float4 last."""
    acc = np.zeros((len(xs), len(ws), 4), F32)

    def step(c):
        for r, x in enumerate(xs):
            for i, w in enumerate(ws):
                for q in range(4):
                    k = 4 * c + q
                    if k < n:
                        acc[r, i, q] = fma32(x[k], w[k], acc[r, i, q])

    n4, c = n // 4, 0
    while c + chunk <= n4:
        for j in range(chunk):
            step(c + j)
        c += chunk
    while c < n4:
        step(c)
        c += 1
    if n % 4:
        step(n4)
    return np.array([[F32(F32(a[0] + a[1]) + F32(a[2] + a[3])) for a in row]
                     for row in acc])


def new_eval(x, layers, t, rw=PF_WARP_ROWS):
    """score_rows.cuh::warp_score_rows for each warp's group of rw rows:
    dout * rw <= 32, lane (r, o) = (l // dout, l % dout); 32 < dout <= 64,
    lane l outputs l and min(l + 32, dout - 1) of every row; otherwise
    lane l outputs l, l + 32, ... of every row."""
    outs = []
    for g0 in range(0, x.shape[0], rw):
        a = x[g0:g0 + rw]
        for Wt, tw, b, tanh in layers:
            dout = Wt.shape[0]
            out = np.zeros((a.shape[0], dout), F32)
            if dout * rw <= 32:
                for lane in range(dout * rw):
                    r, o = lane // dout, lane % dout
                    if r < a.shape[0]:
                        z = rows_dots([a[r]], [Wt[o]], a.shape[1])[0, 0]
                        out[r, o] = epilogue(z, t, tw[o], b[o], tanh)
            elif 32 < dout <= 64:
                for lane in range(32):
                    o1 = min(lane + 32, dout - 1)
                    z = rows_dots(list(a), [Wt[lane], Wt[o1]], a.shape[1])
                    for r in range(a.shape[0]):
                        out[r, lane] = epilogue(z[r, 0], t, tw[lane],
                                                b[lane], tanh)
                        if lane + 32 < dout:
                            out[r, o1] = epilogue(z[r, 1], t, tw[o1], b[o1],
                                                  tanh)
            else:
                for lane in range(32):
                    for o in range(lane, dout, 32):
                        z = rows_dots(list(a), [Wt[o]], a.shape[1])
                        for r in range(a.shape[0]):
                            out[r, o] = epilogue(z[r, 0], t, tw[o], b[o],
                                                 tanh)
            a = out
        outs.append(a)
    return np.concatenate(outs)


def kernel_eval(x, layers, t):
    """The kernel's layout: a layer of at most two outputs through
    score_rows.cuh::split_layer for each warp's group of four rows (lane
    (g, q) sums accumulator q, k ≡ q mod 4 in increasing k, of item g =
    (row g // dout, output g % dout); two butterfly additions; lane q = 0's
    sum), the others as new_eval (the 64 -> 64 layer's register weights sum
    each accumulator in the same order as the shared-memory reads)."""
    def acc_q(xr, w, q):
        a = F32(0)
        for k in range(q, xr.shape[0], 4):
            a = fma32(xr[k], w[k], a)
        return a

    outs = []
    for g0 in range(0, x.shape[0], 4):
        a_in = x[g0:g0 + 4]
        for Wt, tw, b, tanh in layers:
            dout = Wt.shape[0]
            if dout > 2:
                a_in = new_eval(a_in, [(Wt, tw, b, tanh)], t)
                continue
            out = np.zeros((a_in.shape[0], dout), F32)
            for g in range(4 * dout):
                r, o = g // dout, g % dout
                if r >= a_in.shape[0]:
                    continue
                a = [acc_q(a_in[r], Wt[o], q) for q in range(4)]
                s1 = [F32(a[q] + a[q ^ 1]) for q in range(4)]
                out[r, o] = epilogue(F32(s1[0] + s1[2]), t, tw[o], b[o],
                                     tanh)
            a_in = out
        outs.append(a_in)
    return np.concatenate(outs)


def combine(x, s, hb):
    """score.cuh's ½β·(x + s): hb · (x + s), each rounded."""
    return (F32(hb) * (x + s).astype(F32)).astype(F32)


@pytest.mark.parametrize("dims", [DEMO, (3, 13, 5, 3), (5, 70, 5),
                                  (2, 33, 2)])
def test_score_evaluation_bitwise(dims):
    rng = np.random.default_rng(sum(dims))
    layers = []
    for i in range(len(dims) - 1):
        layers.append((rng.standard_normal((dims[i + 1], dims[i])).astype(F32)
                       / np.sqrt(dims[i]).astype(F32),
                       rng.standard_normal(dims[i + 1]).astype(F32),
                       (0.1 * rng.standard_normal(dims[i + 1])).astype(F32),
                       i + 2 < len(dims)))
    x = rng.standard_normal((8, dims[0])).astype(F32)
    t, hb = F32(0.7133), F32(3.25)
    old = combine(x, old_eval(x, layers, t), hb)
    new = combine(x, new_eval(x, layers, t), hb)
    assert old.tobytes() == new.tobytes()
    kernel = combine(x, kernel_eval(x, layers, t), hb)
    assert old.tobytes() == kernel.tobytes()
    # the time row matters: without it the outputs differ
    t0 = combine(x, new_eval(x, layers, F32(0)), hb)
    assert not np.array_equal(t0, new)
