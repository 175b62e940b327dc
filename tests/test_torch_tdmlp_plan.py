"""The cluster grid of the TD-MLP evaluation and step kernels (kernels 1 and
2, ``csrc/tdmlp_cluster.cu``) and float32 models of what they must keep
bitwise.

- ``eval_plan`` mirrors their grid: every batch row in exactly one row
  block of one cluster, never more clusters than are resident, the fewest
  rows a cluster that fill the resident clusters in one wave; it takes
  every (F, H) the first port's shared-memory plan took
  (``tdmlp.cuh::smem_floats``), and refuses only widths far past them.
- The row-major <-> segment mapping (``fused_solve.segment_index``, the
  Python mirror of ``solve_cluster.cuh``'s ``solve_seg``, ``solve_local``
  and ``slice_feature``) is a bijection between the features and the
  segments' valid positions.
- Kernel 2's stage inputs and ũ, computed in the segment layout four
  positions a thread (kernel 4's passes, padding included) and mapped back,
  are bitwise the first port's row-major passes, with fmaf modelled
  exactly (``test_torch_solve_plan.fma32``).

No JAX: the kernels' plain versions are held against JAX in
``tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from localregneuralde_tpu_torch.ops.cuda import fused_solve
from localregneuralde_tpu_torch.ops.cuda.fused_solve import (
    CLUSTER_CTAS,
    CLUSTER_SMEM_BYTES,
    SOLVE_ROWS_MAX,
    eval_plan,
    segment_index,
    solve_count,
    solve_odd0,
    solve_plan,
    solve_seg,
)
from test_torch_solve_plan import fma32

F32 = np.float32

# the first port's shared memory a CTA (tdmlp.cuh::smem_floats) and its
# limit: the H100's 227 KB opt-in, no static shared memory
OLD_LIMIT_FLOATS = 227 * 1024 // 4


def old_smem_floats(F, H):
    return 8 * F + 16 * H * 8 + H * 8 + 1024


@pytest.mark.parametrize("B", [1, 7, 410, 512, 1000])
@pytest.mark.parametrize("resident", [1, 3, 15, 16])
def test_grid_covers_every_row_once_within_the_resident_clusters(B,
                                                                 resident):
    plan = eval_plan(B, 784, 100, resident)
    assert plan.cluster == CLUSTER_CTAS
    assert 1 <= plan.clusters <= resident
    assert 1 <= plan.rows <= plan.rows_max == SOLVE_ROWS_MAX
    # the fewest rows that fill min(B, resident) clusters, capped
    assert plan.rows == min(SOLVE_ROWS_MAX, -(-B // min(B, resident)))
    rows = np.zeros(B, int)
    assert len(plan.blocks_of) == plan.clusters
    seen = sorted(b for blocks in plan.blocks_of for b in blocks)
    assert seen == list(range(len(plan.row_blocks)))
    for blocks in plan.blocks_of:
        for b in blocks:
            r0, n = plan.row_blocks[b]
            assert 0 < n <= plan.rows and r0 == b * plan.rows
            rows[r0:r0 + n] += 1
    assert (rows == 1).all()
    # one wave wherever the resident clusters can hold the batch
    if B <= resident * SOLVE_ROWS_MAX:
        assert all(len(blocks) == 1 for blocks in plan.blocks_of)
    assert plan.scratch_floats == 10 * B * CLUSTER_CTAS * solve_seg(784)


def test_grid_at_the_main_path_and_the_row_probe():
    """B = 512 on an H100's 15 resident clusters: 15 clusters of 35 rows
    (kernel 4 takes 13 of 40); the probe's 40 rows a cluster gives 13."""
    filled = eval_plan(512, 784, 100, 15)
    assert (filled.clusters, filled.rows) == (15, 35)
    assert filled.weights_shared
    probe = eval_plan(512, 784, 100, 15, rows=40)
    assert (probe.clusters, probe.rows) == (13, 40)
    assert len(solve_plan(512, 784, 100).row_blocks) == 13
    assert eval_plan(1000, 784, 100, 15).clusters == 15


def test_plan_takes_every_width_the_first_port_took():
    """The first port took (F, H) wherever its shared memory fitted: at F =
    784 up to H = 373. The plan takes all of them (and more), in a CTA's
    shared memory."""
    assert old_smem_floats(784, 373) <= OLD_LIMIT_FLOATS
    assert old_smem_floats(784, 374) > OLD_LIMIT_FLOATS
    for H in range(1, 374):
        plan = eval_plan(512, 784, H, 15)
        assert plan.smem_bytes <= CLUSTER_SMEM_BYTES
        assert plan.rows_max == SOLVE_ROWS_MAX
    for F, H in [(13, 30), (33, 70), (1, 1), (40, 7), (785, 150)]:
        assert old_smem_floats(F, H) <= OLD_LIMIT_FLOATS
        assert eval_plan(64, F, H, 15).smem_bytes <= CLUSTER_SMEM_BYTES
    # the first port's whole range: the widest H at each F
    for F in (1, 100, 784, 2000, 4000, 6000, 7000):
        H = (OLD_LIMIT_FLOATS - 1024 - 8 * F) // 136
        assert H >= 1 and old_smem_floats(F, H) <= OLD_LIMIT_FLOATS
        assert eval_plan(8, F, H, 15).smem_bytes <= CLUSTER_SMEM_BYTES


@pytest.mark.parametrize("H,shared", [(100, True), (150, True),
                                      (160, False), (373, False)])
def test_weight_slices_in_shared_memory_where_they_fit(H, shared):
    """Without the solve's error tiles the slices stay resident further
    than kernel 4's (which keeps them to H = 133 at F = 784)."""
    plan = eval_plan(512, 784, H, 15)
    assert plan.weights_shared == shared
    assert solve_plan(512, 784, H).weights_shared == (H < 134)


def test_refuses_only_past_one_row_a_cluster():
    """A width whose tiles overflow a CTA even at one row a cluster raises
    before any library load (the first port refused it too)."""
    for F, H in ((200_000, 4), (784, 20_000)):
        assert old_smem_floats(F, H) > OLD_LIMIT_FLOATS
        with pytest.raises(ValueError, match="shared memory"):
            eval_plan(8, F, H, 15)
        with pytest.raises(ValueError, match="shared memory"):
            fused_solve.eval_layout(8, F, H)


@pytest.mark.parametrize("F", [1, 13, 33, 784])
def test_segment_mapping_is_a_bijection(F):
    idx = segment_index(F).numpy()
    seg, odd0 = solve_seg(F), solve_odd0(F)
    valid = set()
    for c in range(CLUSTER_CTAS):
        n = solve_count(F, c)
        ne, no = (n + 1) // 2, n // 2
        assert ne <= odd0 and odd0 + no <= seg
        valid |= {c * seg + l for l in range(ne)}
        valid |= {c * seg + odd0 + l for l in range(no)}
    assert len(set(idx.tolist())) == F
    assert set(idx.tolist()) == valid
    # each feature k = 8m + c sits in CTA c's segment: even m first, odd m
    # from odd0, in increasing m
    for f in range(F):
        c, m = f % 8, f // 8
        assert idx[f] == c * seg + (odd0 + m // 2 if m % 2 else m // 2)
    # the segments agree with solve_plan's features
    for c, fs in enumerate(solve_plan(8, F, 16).features):
        assert list(idx[list(fs)]) == sorted(idx[list(fs)])
        assert all(idx[f] // seg == c for f in fs)
    # rows -> segments -> rows is the identity
    x = torch.randn(5, F)
    buf = torch.full((5, CLUSTER_CTAS * seg), float("nan"))
    buf[:, segment_index(F)] = x
    assert torch.equal(buf[:, segment_index(F)], x)
    assert int(torch.isnan(buf).sum()) == 5 * (CLUSTER_CTAS * seg - F)


A = {2: [0.161], 3: [-0.008480655492356989, 0.335480655492357],
     4: [2.8971530571054935, -6.359448489975075, 4.3622954328695815],
     5: [5.325864828439257, -11.748883564062828, 7.4955393428898365,
         -0.09249506636175525],
     6: [5.86145544294642, -12.92096931784711, 8.159367898576159,
         -0.071584973281401, -0.028269050394068383],
     7: [0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
         -3.290069515436081, 2.324710524099774]}
BT = [-0.00178001105222577714, -0.0008164344596567469, 0.007880878010261995,
      -0.1447110071732629, 0.5823571654525552, -0.45808210592918697,
      0.015151515151515152]


def _stage_input(u, ks, a, dt):
    """The first port's stage_input on any layout, elementwise: acc =
    a0·k0, acc = fmaf(aj, kj, acc) left to right, then fmaf(dt, acc, u)."""
    acc = (F32(a[0]) * ks[0]).astype(F32)
    for aj, kj in zip(a[1:], ks[1:]):
        acc = fma32(F32(aj), kj, acc)
    return fma32(dt, acc, u)


def _utilde(ks, dt):
    """ũ: acc = BT1·k1, acc = fmaf(BTj, kj, acc), then dt·acc rounded."""
    acc = (F32(BT[0]) * ks[0]).astype(F32)
    for bj, kj in zip(BT[1:], ks[1:]):
        acc = fma32(F32(bj), kj, acc)
    return (dt * acc).astype(F32)


def _to_segments(x, F):
    """(B, F) row-major into the (B, 8·seg) segment layout, zero padding
    (kernel 2's layout in)."""
    seg = solve_seg(F)
    buf = np.zeros((x.shape[0], CLUSTER_CTAS * seg), F32)
    buf[:, segment_index(F).numpy()] = x
    return buf


def _by_groups(fn, arrays, F):
    """fn over a segment buffer four positions at a time, as kernel 4's
    passes (solve_group: each CTA's even groups, then its odd ones)."""
    seg, odd0 = solve_seg(F), solve_odd0(F)
    n_e4 = odd0 // 4
    out = np.full(arrays[0].shape, np.nan, F32)
    for c in range(CLUSTER_CTAS):
        for g in range(seg // 4):
            lo = c * seg + (4 * g if g < n_e4 else odd0 + 4 * (g - n_e4))
            sl = slice(lo, lo + 4)
            out[:, sl] = fn([a[:, sl] for a in arrays])
    return out


@pytest.mark.parametrize("shape", [(35, 784), (7, 33), (3, 13), (2, 1)])
def test_stage_inputs_and_utilde_in_the_segments_are_bitwise_the_old(shape):
    B, F = shape
    rng = np.random.default_rng(F)
    u = rng.standard_normal((B, F)).astype(F32)
    ks = [(rng.standard_normal((B, F)) * np.exp(rng.uniform(-3, 3, (B, F))))
          .astype(F32) for _ in range(7)]
    dt = F32(0.0517)
    idx = segment_index(F).numpy()
    seg_u, seg_ks = _to_segments(u, F), [_to_segments(k, F) for k in ks]
    for stage, a in A.items():
        old = _stage_input(u, ks[:len(a)], a, dt)
        new = _by_groups(
            lambda v, a=a: _stage_input(v[0], v[1:], a, dt),
            [seg_u, *seg_ks[:len(a)]], F)[:, idx]
        assert old.tobytes() == new.tobytes(), stage
    old = _utilde(ks, dt)
    new = _by_groups(lambda v: _utilde(v, dt), seg_ks, F)[:, idx]
    assert np.isfinite(old).all() and old.tobytes() == new.tobytes()
    # and not an order-blind check: ũ summed right to left differs
    if F >= 13:
        acc = (F32(BT[6]) * ks[6]).astype(F32)
        for bj, kj in zip(BT[5::-1], ks[5::-1]):
            acc = fma32(F32(bj), kj, acc)
        assert (dt * acc).astype(F32).tobytes() != old.tobytes()
