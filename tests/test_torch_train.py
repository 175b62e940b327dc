"""The port's training path against the JAX package: ``NeuralODE`` in
unbiased training with the stored adjoint, the optimizers, and one whole
``make_train_step``, on the same numpy-seeded inputs at small size, with
the JAX parameters carried over by ``parity.py``.

JAX draws t1 with threefry and the port with a ``torch.Generator``, so each
test takes JAX's draw and injects it into the port (``sample_t1``).

Tolerances: the regulariser is the error estimate of one step at the
Hairer initial dt, a cancelling f32 sum. At rtol 1e-3 that sum sits at its
rounding noise (the port and JAX differed by 12-22% there), so these tests
run at rtol = atol = 3e-2, where the step error is well above the noise
and ``reg_val`` agrees to 1e-3 (measured 2e-4). The gradients agree to
1e-3 of the largest gradient (as the reference's stored-vs-direct check,
tests/test_stored_adjoint.py:97); the loss and NFE as in
tests/test_torch_slice.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from localregneuralde_tpu.harness import (
    construct_loss as jax_construct_loss,
    construct_model as jax_construct_model,
    define_configuration as jax_define_configuration,
)
from localregneuralde_tpu.harness.construct import (
    construct_optimizer as jax_construct_optimizer,
)
from localregneuralde_tpu.harness.train import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)
from localregneuralde_tpu.models import (
    NeuralODE as JNeuralODE,
    TDChain as JTDChain,
    diffeqsol_to_array as jax_sol_to_array,
)
from localregneuralde_tpu.nn import Dense as JDense
from localregneuralde_tpu_torch.harness import (
    OptimizerSpec,
    construct_loss,
    construct_model,
    construct_optimizer,
    create_train_state,
    define_configuration,
    make_train_step,
    one_hot,
    synthetic_classification,
)
from localregneuralde_tpu_torch.models import NeuralODE, TDChain, neural_ode
from localregneuralde_tpu_torch.nn import Chain, Dense
from localregneuralde_tpu_torch.parity import load_jax_params

F, H, B = 32, 16, 8
NODE_KW = dict(regularize="unbiased", adjoint="stored", rtol=3e-2, atol=3e-2,
               max_steps=32)


def _jax_t1(state, t0=0.0, t2=1.0):
    """The t1 JAX's NeuralODE draws from its layer state."""
    _, tkey, _ = jax.random.split(state["rng"], 3)
    return float(jax.random.uniform(tkey, (), jnp.float32, minval=t0,
                                    maxval=t2))


def _close_rel(ours, ref, rel):
    ours, ref = np.asarray(ours), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert float(np.abs(ours - ref).max()) <= rel * scale


@pytest.fixture(scope="module")
def jax_node():
    node = JNeuralODE(JTDChain(JDense(F + 1, H, "tanh"), JDense(H + 1, F)),
                      **NODE_KW)
    ps, st = node.init(jax.random.PRNGKey(0))
    x = (0.5 * np.random.default_rng(1).standard_normal((B, F))).astype(
        np.float32)

    def loss(ps, x):
        sol, st_ = node(ps, st, x, training=True)
        return jnp.sum(jax_sol_to_array(sol)) + st_["reg_val"], st_

    (val, st_), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                              has_aux=True)(ps, jnp.asarray(x))
    return dict(ps=ps, x=x, t1=_jax_t1(st), loss=float(val),
                reg_val=float(st_["reg_val"]), nfe=int(st_["nfe"]),
                gp=gp["model"], gx=np.asarray(gx))


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_unbiased_training_matches_jax(jax_node, use_pallas, monkeypatch):
    ref = jax_node
    monkeypatch.setattr(neural_ode, "sample_t1", lambda g, t0, t2: ref["t1"])
    node = NeuralODE(TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F)),
                     use_pallas=use_pallas, **NODE_KW)
    load_jax_params(node, {"model": ref["ps"]["model"]})
    x = torch.tensor(ref["x"], requires_grad=True)
    sol, st = node(x, node.init_state(), training=True)
    loss = sol.ys[-1].sum() + st["reg_val"]
    loss.backward()
    assert int(st["nfe"]) == ref["nfe"]
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(st["reg_val"].detach()), ref["reg_val"],
                               rtol=1e-3)
    for name, p in node.model.named_parameters():
        layer, leaf = name.split(".")
        _close_rel(p.grad.numpy(), ref["gp"][layer][leaf], 1e-3)
    _close_rel(x.grad.numpy(), ref["gx"], 1e-4)


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_regulariser_gradient_reaches_params_only(use_pallas):
    """The locality fence (tests/test_neural_ode.py:65-70): ∂reg/∂x ≡ 0,
    while ∂reg/∂params is finite and nonzero."""
    node = NeuralODE(TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F)),
                     use_pallas=use_pallas, **NODE_KW)
    x = torch.randn(B, F, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    _, st = node(x, node.init_state(), training=True)
    params = list(node.model.parameters())
    gx, *gp = torch.autograd.grad(st["reg_val"], [x] + params,
                                  allow_unused=True)
    assert gx is None or float(gx.abs().max()) == 0.0
    flat = torch.cat([g.reshape(-1) for g in gp])
    assert bool(torch.isfinite(flat).all()) and bool((flat != 0).any())
    assert float(st["reg_val"].detach()) > 0.0


def test_unbiased_saveat_strips_t1():
    """tests/test_neural_ode.py:104 on the port."""
    ts = torch.tensor([0.25, 0.5, 1.0])
    node = NeuralODE(Chain(Dense(2, 4, "tanh"), Dense(4, 2)),
                     regularize="unbiased", saveat=ts, max_steps=32)
    x = torch.randn(4, 2, generator=torch.Generator().manual_seed(1))
    sol, st = node(x, node.init_state(), training=True)
    assert tuple(sol.ys.shape) == (3, 4, 2)
    assert torch.equal(sol.ts, ts)
    _, st2 = node(x, st, training=True)  # the generator advances
    assert float(st["reg_val"]) != float(st2["reg_val"])


# ---------------------------------------------------------------- optimizers

@pytest.mark.parametrize("spec,make", [
    (OptimizerSpec("adam"), lambda: optax.adam(0.05)),
    (OptimizerSpec("adamw"), lambda: optax.adamw(0.05)),
    (OptimizerSpec("adamax"), lambda: optax.adamax(0.05)),
    (OptimizerSpec("sgd"), lambda: optax.sgd(0.05)),
    (OptimizerSpec("sgd", momentum=0.9), lambda: optax.sgd(0.05, momentum=0.9)),
    (OptimizerSpec("sgd", momentum=0.9, nesterov=True),
     lambda: optax.sgd(0.05, momentum=0.9, nesterov=True)),
    # decoupled decay scaled by the learning rate (harness/optim.py)
    (OptimizerSpec("adam", weight_decay=0.01),
     lambda: optax.chain(optax.adam(0.05),
                         optax.add_decayed_weights(-0.05 * 0.01))),
    (OptimizerSpec("adam", gradient_clip_norm=0.5),
     lambda: optax.chain(optax.clip_by_global_norm(0.5), optax.adam(0.05))),
])
def test_optimizer_matches_optax(spec, make):
    """Three steps on the same gradients (a zero entry included, where
    adamax's eps placement matters); f32 rounding only: rtol 1e-5."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    for g in grads:
        g["b"][0] = 0.0
    opt = make()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = opt.init(jp)
    params = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = spec.init(params)
    for g in grads:
        up, st = opt.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, up)
        spec.apply(topt, list(params.values()),
                   [torch.tensor(g[k]) for k in params], 0.05)
    for k in params:
        np.testing.assert_allclose(params[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- train step

CONFIG = "experiments/mnist_ode/mlp.yaml"
OVERRIDES = [
    "--model.mlp_hidden_state_size=16",
    "--model.solver.reltol=3e-2",
    "--model.solver.abstol=3e-2",
    "--model.solver.max_steps=64",
    "--model.regularize=unbiased",
    "--optimizer.optimizer=sgd",
    "--optimizer.learning_rate=0.1",
]


def _cfg(define, extra=()):
    cfg = define(OVERRIDES + list(extra), CONFIG)
    cfg.model.image_size = [4, 8]
    cfg.model.in_channels = 1
    return cfg


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_train_step_matches_jax(use_pallas, monkeypatch):
    """One ``make_train_step`` from the same parameters and batch: loss,
    reg_val, NFE and the updated parameters (SGD, so the update is the
    gradient itself; Adam is held against optax above). At these initial
    weights one step's error estimate is ~1e-10, at its f32 rounding noise,
    so reg_val agrees to 20% only (measured 12%); the regulariser's tight
    check is test_unbiased_training_matches_jax."""
    jcfg = _cfg(jax_define_configuration, ["--model.use_pallas=off"])
    jmodel = jax_construct_model(jcfg)
    jloss, jw = jax_construct_loss(jcfg)
    jopt, jsched = jax_construct_optimizer(jcfg)
    jts = jax_create_train_state(jmodel, jopt, jax.random.PRNGKey(0))
    t1 = _jax_t1(jts.state["neural_ode"])
    p0 = jax.tree_util.tree_map(np.asarray, jts.params)
    x, y, _, _ = synthetic_classification((4, 8), 1, 10, n_train=8,
                                          n_test=1, seed=3)
    y1 = one_hot(y, 10)
    jts2, jl, jstats = jax_make_train_step(jmodel, jloss, jopt)(
        jts, (jnp.asarray(x), jnp.asarray(y1)), jw(1), jsched(1))

    monkeypatch.setattr(neural_ode, "sample_t1", lambda g, t0, t2: t1)
    cfg = _cfg(define_configuration, [f"--model.use_pallas={use_pallas}"])
    model = construct_model(cfg, device="cpu")
    load_jax_params(model, p0)
    loss_fn, w_reg = construct_loss(cfg)
    opt, sched = construct_optimizer(cfg)
    ts = create_train_state(model, opt)
    ts2, loss, stats = make_train_step(model, loss_fn, opt)(
        ts, (torch.tensor(x), torch.tensor(y1)), w_reg(1), sched(1))

    assert ts2.step == 1
    assert int(stats["nfe"]) == int(jstats["nfe"])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(stats["reg_val"]),
                               float(jstats["reg_val"]), rtol=0.2)
    lr = sched(1)
    jflat = jax.tree_util.tree_leaves_with_path(jts2.params)
    for path, new in jflat:
        name = ".".join(k.key for k in path)
        old = p0
        for k in path:
            old = old[k.key]
        # compare the updates (lr·grad), relative to the largest update
        _close_rel((ts2.params[name].detach().numpy() - old) / lr,
                   (np.asarray(new) - old) / lr, 1e-3)
