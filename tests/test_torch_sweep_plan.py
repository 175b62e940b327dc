"""The cluster plan of the TD-MLP sweep (kernels 7 and 8) and the float64
reference that the card holds the sweep against.

- ``sweep_plan`` mirrors the CUDA layout (``csrc/sweep_cluster.cuh``): every
  batch row lies in exactly one row block and every feature in exactly one
  CTA's slice, and a CTA's shared memory fits an H100's 227 KB.
- The plain sweep in float64 (weights, knots and cotangents cast) against
  JAX's ``persistent_stored_sweep`` on the same knots, at the tolerance of
  ``tests/test_torch_adjoint.py::_compare_sweep`` (rtol 1e-4, atol 1e-5,
  1e-4 of the largest value for the weight gradients: the JAX kernel sums in
  FP32), and against the port's FP32 plain sweep, which it must bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.models import TDChain as JTDChain
from localregneuralde_tpu.nn import Dense as JDense
from localregneuralde_tpu.ops.pallas.fused_solve import (
    persistent_tsit5_solve as jax_persistent_solve,
)
from localregneuralde_tpu.ops.pallas.fused_solve_bwd import (
    persistent_stored_sweep as jax_stored_sweep,
)
from localregneuralde_tpu_torch.ops.cuda import (
    TDMLPWeights,
    persistent_stored_sweep_plain,
)
from localregneuralde_tpu_torch.ops.cuda.fused_solve_bwd import (
    SWEEP_CLUSTER,
    SWEEP_ROWS,
    SWEEP_SMEM_BYTES,
    sweep_plan,
)

SHAPES = [(13, 40, 7), (64, 784, 100), (512, 784, 100), (520, 785, 100)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_rows_and_features_once(shape):
    B, F, H = shape
    plan = sweep_plan(B, F, H)
    assert (plan.cluster, plan.rows) == (SWEEP_CLUSTER, SWEEP_ROWS)
    rows = np.zeros(B, int)
    for r0, n in plan.row_blocks:
        assert 0 < n <= plan.rows
        rows[r0:r0 + n] += 1
    assert (rows == 1).all()
    assert plan.max_partials == -(-B // plan.rows)
    feats = np.zeros(F, int)
    assert len(plan.slices) == plan.cluster
    for f0, n in plan.slices:
        assert 0 <= n <= -(-F // plan.cluster)
        feats[f0:f0 + n] += 1
    assert (feats == 1).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_shared_memory_fits_a_cta(shape):
    B, F, H = shape
    plan = sweep_plan(B, F, H)
    assert plan.grads_shared
    assert plan.smem_bytes <= SWEEP_SMEM_BYTES < 227 * 1024
    # the weight and gradient slices alone: twice (S, ldW) + (H + 1, ldS),
    # leading dimensions a multiple of 4 floats with an odd quotient
    S = -(-F // SWEEP_CLUSTER)

    def ld(n):
        q = -(-n // 4)
        return 4 * (q | 1)

    assert ld(98) == 100 and ld(7) == 12 and ld(100) == 100
    slices = 4 * 2 * (S * ld(H) + (H + 1) * ld(S))
    assert slices < plan.smem_bytes
    # the scratch: 21 (B, F) and 6 (B, H) float buffers
    assert plan.scratch_floats == 21 * B * F + 6 * B * H


def test_plan_moves_gradients_out_of_shared_memory_when_wide():
    """At F = 784 the gradient slices stay in shared memory up to H = 102;
    wider, the CTAs add into their cluster's partial in global memory and
    shared memory holds the weights and the tiles (up to H ≈ 185)."""
    assert sweep_plan(512, 784, 100).grads_shared
    assert sweep_plan(512, 784, 102).grads_shared
    for h in (103, 150, 180):
        plan = sweep_plan(64, 784, h)
        assert not plan.grads_shared
        assert plan.smem_bytes <= SWEEP_SMEM_BYTES
    assert sweep_plan(64, 784, 200).smem_bytes > SWEEP_SMEM_BYTES


def test_launch_refuses_what_does_not_fit():
    """A width whose weight slices and tiles overflow a CTA raises before
    any library load (H = 200 at F = 784 needs 250 KB)."""
    from localregneuralde_tpu_torch.ops.cuda import fused_solve_bwd

    b, f, h = 2, 784, 200
    assert sweep_plan(b, f, h).smem_bytes > SWEEP_SMEM_BYTES
    w = TDMLPWeights(torch.zeros(f + 1, h), torch.zeros(h),
                     torch.zeros(h + 1, f), torch.zeros(f))
    u = torch.zeros(b, f)
    with pytest.raises(ValueError, match="shared memory"):
        fused_solve_bwd._launch(w, torch.zeros(2), u[None], torch.tensor(1),
                                torch.tensor([1.0]), u[None], u)


F, H, B = 32, 16, 8


def _setup(seed):
    ps, _ = JTDChain(JDense(F + 1, H, "tanh"), JDense(H + 1, F)).init(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    ps = jax.tree_util.tree_map(np.asarray, ps)
    ps["layer_0"]["b"] = rng.standard_normal(H).astype(np.float32) * 0.1
    ps["layer_1"]["b"] = rng.standard_normal(F).astype(np.float32) * 0.1
    x = (0.5 * rng.standard_normal((B, F))).astype(np.float32)
    w = TDMLPWeights(*(torch.tensor(ps[l][k]) for l, k in (
        ("layer_0", "w"), ("layer_0", "b"), ("layer_1", "w"),
        ("layer_1", "b"))))
    rec = jax_persistent_solve(
        ps, jnp.asarray(x), (0.0, 1.0), rtol=1e-4, atol=1e-4,
        saveat_arr=jnp.asarray([0.5, 1.0]), max_steps=64, record_knots=True,
        record_ks=False)
    rng = np.random.default_rng(9)
    cts = (rng.standard_normal((2, B, F)).astype(np.float32),
           rng.standard_normal((B, F)).astype(np.float32))
    return ps, w, rec, cts


def _flat_jax(ref):
    ps = ref[2]
    return [np.asarray(ref[0]), np.asarray(ref[1]),
            np.asarray(ps["layer_0"]["w"]), np.asarray(ps["layer_0"]["b"]),
            np.asarray(ps["layer_1"]["w"]), np.asarray(ps["layer_1"]["b"])]


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("seed", [5, 11])
def test_float64_plain_sweep_matches_jax_and_bounds_fp32(seed):
    ps, w, rec, (ct_ys, ct_y) = _setup(seed)
    ref = _flat_jax(jax_stored_sweep(
        ps, rec["knot_ts"], rec["knot_us"], rec["naccept"],
        jnp.asarray([0.5, 1.0]), jnp.asarray(ct_ys), jnp.asarray(ct_y)))
    # the JAX kernel's knots are padded to 128 lanes; the port's are not
    args = (torch.tensor(np.asarray(rec["knot_ts"])),
            torch.tensor(np.asarray(rec["knot_us"])[:, :, :F]),
            torch.tensor(int(rec["naccept"])), torch.tensor([0.5, 1.0]),
            torch.tensor(ct_ys), torch.tensor(ct_y))
    w64 = TDMLPWeights(*(p.double() for p in w))
    args64 = [a.double() if a.is_floating_point() else a for a in args]
    out64 = persistent_stored_sweep_plain(w64, *args64)
    out32 = persistent_stored_sweep_plain(w, *args)
    flat64 = [out64[0], out64[1], *out64[2]]
    flat32 = [out32[0], out32[1], *out32[2]]
    assert all(t.dtype == torch.float64 for t in flat64)
    for i, (a, b) in enumerate(zip(flat64, ref)):
        if i < 2:  # a_u and a_k, as _compare_sweep holds them
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)
        else:
            assert _rel(a.numpy(), b) <= 1e-4
    # the FP32 sweep sits within FP32 rounding of the float64 one
    for a, b in zip(flat32, flat64):
        assert _rel(a.double().numpy(), b.numpy()) <= 1e-4
