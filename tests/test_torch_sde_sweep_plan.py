"""Kernel 12's CTA layout (``fused_sde_sweep.sde_sweep_plan``, mirroring
``csrc/sde_sweep.cu``), without the card.

A CTA sweeps a block of four rows with twelve warps: the hidden group (eight
warps) takes the H-wide outputs of a product while the diffusion group (four
warps) takes the F-wide diffusion outputs, then every thread the drift
outputs and the weight-gradient elements. Each output stays one thread's
sum, so the layout decides only who computes it: the tests check that every
output of every phase has exactly one thread, the work a thread has at the
MNIST-SDE width (F = 32, H = 64), the shared memory there, and where the
plan declines. No JAX needed.
"""
import pytest

from localregneuralde_tpu_torch.ops.cuda.fused_sde_sweep import (
    SDE_SMEM_BYTES,
    sde_grad_floats,
    sde_sweep_plan,
)


def _owners(n_items, first, count):
    """The thread of each of n_items outputs on threads [first, first +
    count), strided as the kernel's loops stride."""
    return [first + i % count for i in range(n_items)]


def _phases(plan, nrows, F, H):
    """(outputs, owning threads) of each phase of a step."""
    diff = plan.threads - plan.hid_threads
    return {
        "hidden": _owners(nrows * H, 0, plan.hid_threads),
        "diffusion": _owners(nrows * F, plan.hid_threads, diff),
        "drift": _owners(nrows * F, 0, plan.threads),
        "gradients": _owners(sde_grad_floats(F, H), 0, plan.threads),
    }


def test_plan_at_the_mnist_sde_width():
    plan = sde_sweep_plan(512, 32, 64)
    assert (plan.rows, plan.ctas, plan.threads, plan.hid_threads) == (
        4, 128, 384, 256)
    assert plan.grad_floats == 5248
    # weights 5,376 floats, the partial 5,248, the row block's buffers 6,016
    assert plan.smem_bytes == 4 * (5376 + 5248 + 6016) == 66560
    per_thread = {name: max(owners.count(t) for t in set(owners))
                  for name, owners in _phases(plan, 4, 32, 64).items()}
    # one output a thread in each product phase, 14 gradient elements
    assert per_thread == {"hidden": 1, "diffusion": 1, "drift": 1,
                          "gradients": 14}


@pytest.mark.parametrize("B, F, H", [(512, 32, 64), (13, 32, 64),
                                     (7, 20, 9), (33, 5, 300)])
def test_every_output_once_on_its_group(B, F, H):
    plan = sde_sweep_plan(B, F, H)
    assert plan.ctas == -(-B // plan.rows)
    for rb in range(plan.ctas):
        nrows = min(plan.rows, B - rb * plan.rows)
        assert nrows >= 1
        phases = _phases(plan, nrows, F, H)
        for name, owners in phases.items():
            # one owner an output, within the CTA's threads
            assert all(0 <= t < plan.threads for t in owners), name
        assert max(phases["hidden"]) < plan.hid_threads
        assert min(phases["diffusion"]) >= plan.hid_threads


@pytest.mark.parametrize("tiers, sets", [
    (("fp32", "fp32"), 0), (("tf32", "tf32"), 2), (("fp32", "tf32"), 1),
    (("tf32", "fp32"), 1)])
def test_tf32_plan_adds_a_fragment_set_per_tf32_tier(tiers, sets):
    """Each TF32 tier (the recompute's, the gradients') adds one set of the
    three weights' fragment copies (csrc/sde.cuh) after the FP32 layout:
    the forward's for the recompute, the transposed products' for the
    gradients, 5,120 floats each at the MNIST-SDE width, within a block."""
    plan = sde_sweep_plan(512, 32, 64, *tiers)
    fp32 = sde_sweep_plan(512, 32, 64)
    assert plan.smem_bytes - fp32.smem_bytes == 4 * sets * 5120
    assert plan.smem_bytes <= SDE_SMEM_BYTES
    assert plan[:4] == fp32[:4]


def test_plan_declines_where_shared_memory_overflows():
    """At F = 32 the widest hidden layer is H = 318, at H = 64 the widest
    state F = 96; past them the wrapper raises before the library loads."""
    assert sde_sweep_plan(512, 32, 318).smem_bytes <= SDE_SMEM_BYTES
    assert sde_sweep_plan(512, 96, 64).smem_bytes <= SDE_SMEM_BYTES
    for F, H in ((32, 319), (97, 64), (128, 100)):
        with pytest.raises(ValueError, match="shared memory"):
            sde_sweep_plan(512, F, H)
