"""The TD-MLP family's kernel route declines a width its kernels cannot
plan, as the reference does.

The reference hands its persistent solve and sweep over only where
``sweep_feasible`` says the kernel plan fits, and otherwise trains through
the XLA loop (``localregneuralde_tpu/models/neural_ode.py:357-380``). The
port asks ``sweep_feasible`` (kernel 4's ``solve_plan`` and the sweep's
``sweep_plan``, both Python) up front: where either does not fit, neither
the persistent solve nor the sweep runs, and the regulariser step's VJP
(kernel 3, on the sweep's transposed step) takes its plain twin. At F = 784
the sweep's CTA overflows from H = 181, and at H = 100 from F = 1,441.

No JAX: the declined route is held against the generic route of the same
model on the CPU, to 1e-5 of the largest value (the same plain arithmetic
in another grouping).
"""
import numpy as np
import pytest
import torch

from localregneuralde_tpu_torch import ops
from localregneuralde_tpu_torch.models import NeuralODE, TDChain, neural_ode
from localregneuralde_tpu_torch.nn import Dense
from localregneuralde_tpu_torch.ops.cuda import (
    fused_step_bwd,
    step_bwd_feasible,
    sweep_feasible,
)
from localregneuralde_tpu_torch.ops.cuda.fused_mlp_bwd import step_bwd_plain_at
from localregneuralde_tpu_torch.ops.cuda.fused_solve_bwd import (
    SWEEP_MAX_SAVE,
    sweep_layout,
)

WIDE = [(784, 184), (1500, 100)]
NODE_KW = dict(regularize="unbiased", adjoint="stored", rtol=3e-2, atol=3e-2,
               max_steps=32)


def _node(F, H, use_pallas):
    return NeuralODE(TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F)),
                     use_pallas=use_pallas, **NODE_KW)


def _route(F, H, B=4, n_save=2):
    node = _node(F, H, "on")
    names = [n for n, _ in node.model.named_parameters()]
    x = torch.zeros(B, F)
    return node._stored_kwargs(True, names, x, n_save)


@pytest.mark.parametrize("F, H", WIDE)
def test_wide_route_declines_solve_and_sweep(F, H):
    assert not sweep_feasible(512, F, H, 2)
    kw = _route(F, H)
    assert "persistent_fn" not in kw and "sweep_fn" not in kw
    assert {"f", "step_fn", "step_vjp", "fsal_fn"} <= set(kw)


@pytest.mark.parametrize("F, H", WIDE)
def test_wide_step_vjp_takes_its_twin(F, H):
    assert not step_bwd_feasible(F, H)
    assert neural_ode.step_vjp_at(F, H, "highest", "match").func is (
        step_bwd_plain_at)


def test_mlp_yaml_width_keeps_the_kernels():
    """mlp.yaml's (784, 100) keeps kernel 4, the sweep and kernel 3."""
    assert sweep_feasible(512, 784, 100, 2)
    kw = _route(784, 100)
    assert "persistent_fn" in kw and "sweep_fn" in kw
    assert neural_ode.step_vjp_at(784, 100, "highest", "match").func is (
        fused_step_bwd)


def test_sweep_limits():
    """The edges: H = 180 is the widest at F = 784 and F = 1,440 at H =
    100, the sweep's saveat limit declines too, and ``sweep_layout`` still
    raises when called directly (before the library loads)."""
    assert sweep_feasible(512, 784, 180, SWEEP_MAX_SAVE)
    assert not sweep_feasible(512, 784, 181, 2)
    assert sweep_feasible(512, 1440, 100, 2)
    assert not sweep_feasible(512, 1441, 100, 2)
    assert not sweep_feasible(512, 784, 100, SWEEP_MAX_SAVE + 1)
    assert "persistent_fn" not in _route(784, 100, n_save=SWEEP_MAX_SAVE + 1)
    with pytest.raises(ValueError, match="shared memory"):
        sweep_layout(512, 784, 184, "adjoint_sweep")


@pytest.mark.parametrize("F, H", [(784, 184)])
def test_wide_training_runs_the_plain_route(F, H, monkeypatch):
    """A training forward and backward at a declined width: the kernels
    that cannot take it are never called, and the result is the generic
    route's."""
    def refuse(*a, **k):
        raise AssertionError("a kernel the route declines was called")

    for name in ("persistent_tsit5_solve", "persistent_stored_sweep",
                 "persistent_two_level_sweep", "fused_step_bwd"):
        monkeypatch.setattr(ops.cuda, name, refuse)
    monkeypatch.setattr(neural_ode, "sample_t1", lambda g, t0, t2: 0.6)
    x0 = 0.5 * np.random.default_rng(3).standard_normal((3, F))
    results = []
    for use_pallas in ("on", "off"):
        torch.manual_seed(5)
        node = _node(F, H, use_pallas)
        x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
        sol, st = node(x, node.init_state(), training=True)
        loss = sol.ys[-1].sum() + st["reg_val"]
        grads = torch.autograd.grad(loss, [x, *node.model.parameters()])
        results.append((float(loss.detach()), int(st["nfe"]), grads))
    (l_on, nfe_on, g_on), (l_off, nfe_off, g_off) = results
    assert nfe_on == nfe_off
    np.testing.assert_allclose(l_on, l_off, rtol=1e-5)
    for a, b in zip(g_on, g_off):
        scale = max(float(b.abs().max()), 1e-12)
        assert float((a - b).abs().max()) <= 1e-5 * scale
