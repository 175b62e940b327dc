"""The serving slice end to end: the JAX package's ``construct_model`` →
``make_eval_step`` (``use_pallas: off``) against the port's, on a tiny MNIST
MLP Neural ODE config, with the JAX parameters carried over by
``parity.py`` and the same numpy-seeded batch.

The port runs both its kernel route (``use_pallas: on``: the wrappers run
their plain versions on the CPU, through the persistent solve or, with
``use_persistent: false``, the step loop) and its generic route
(``use_pallas: off``).
"""
import jax
import numpy as np
import pytest
import torch

from localregneuralde_tpu.harness import (
    construct_loss as jax_construct_loss,
    construct_model as jax_construct_model,
    define_configuration as jax_define_configuration,
)
from localregneuralde_tpu.harness.train import (
    TrainState as JTrainState,
    make_eval_step as jax_make_eval_step,
)
from localregneuralde_tpu_torch.harness import (
    construct_loss,
    construct_model,
    create_train_state,
    define_configuration,
    make_eval_step,
    one_hot,
    synthetic_classification,
)
from localregneuralde_tpu_torch.parity import load_jax_params

CONFIG = "experiments/mnist_ode/mlp.yaml"
OVERRIDES = [
    "--model.mlp_hidden_state_size=16",
    "--model.solver.reltol=1e-4",
    "--model.solver.abstol=1e-4",
    "--model.solver.max_steps=64",
]


def _cfg(define, extra=()):
    cfg = define(OVERRIDES + list(extra), CONFIG)
    cfg.model.image_size = [4, 8]
    cfg.model.in_channels = 1
    return cfg


@pytest.fixture(scope="module")
def jax_reference():
    cfg = _cfg(jax_define_configuration, ["--model.use_pallas=off"])
    model = jax_construct_model(cfg)
    loss_fn, w_reg = jax_construct_loss(cfg)
    params, state = model.init(jax.random.PRNGKey(0))
    ts = JTrainState(params=params, state=state, opt_state=None, step=0)
    x, y, _, _ = synthetic_classification((4, 8), 1, 10, n_train=8,
                                          n_test=1, seed=3)
    y1 = one_hot(y, 10)
    loss, stats = jax_make_eval_step(model, loss_fn)(ts, (x, y1), w_reg(1))
    return params, x, y1, float(loss), stats


@pytest.mark.parametrize("use_pallas,use_persistent", [
    ("on", True), ("on", False), ("off", True),
])
def test_eval_slice_matches_jax(jax_reference, use_pallas, use_persistent):
    params, x, y1, ref_loss, ref_stats = jax_reference
    cfg = _cfg(define_configuration, [
        f"--model.use_pallas={use_pallas}",
        f"--model.solver.use_persistent={str(use_persistent).lower()}",
    ])
    model = construct_model(cfg, device="cpu")
    load_jax_params(model, params)
    loss_fn, w_reg = construct_loss(cfg)
    loss, stats = make_eval_step(model, loss_fn)(
        create_train_state(model), (torch.tensor(x), torch.tensor(y1)),
        w_reg(1),
    )
    np.testing.assert_allclose(
        stats["y_pred"].numpy(), np.asarray(ref_stats["y_pred"]), atol=1e-4
    )
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-4)
    assert abs(int(stats["nfe"]) - int(ref_stats["nfe"])) <= 12
    assert bool(stats["solver_success"]) == bool(ref_stats["solver_success"])
    assert float(stats["reg_val"]) == float(ref_stats["reg_val"]) == 0.0


def test_parameter_names_carry_over(jax_reference):
    params = jax_reference[0]
    cfg = _cfg(define_configuration)
    names = dict(construct_model(cfg, device="cpu").named_parameters())
    assert set(names) == {
        "neural_ode.model.layer_0.w", "neural_ode.model.layer_0.b",
        "neural_ode.model.layer_1.w", "neural_ode.model.layer_1.b",
        "classifier.w", "classifier.b",
    }
    assert names["neural_ode.model.layer_0.w"].shape == tuple(
        params["neural_ode"]["model"]["layer_0"]["w"].shape
    )
