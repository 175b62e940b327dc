"""The port's MNIST Neural SDE and the biased regulariser against the JAX
package: ``NeuralDSDE`` in each mode, the whole model of
``experiments/mnist_sde/mlp.yaml`` through one ``make_train_step``, and
``NeuralODE`` with ``regularize='biased'``, on the same numpy-seeded inputs
at small size (B = 8, F = 32, H = 64, an 8×8 image), the JAX parameters
carried over by ``parity.py``.

JAX draws its randomness from keys and the port from a ``torch.Generator``,
so each test takes JAX's draws and injects them through the port's hooks
(``models/neural_sde.py``: the tree's normal source, t1, the reservoir's
uniforms and the regulariser step's normals; ``models/neural_ode.py``:
t1 and the reservoir's uniforms). ``use_pallas='off'`` is held against
JAX's XLA loop, ``'on'`` (the kernels' plain versions on the CPU) against
JAX's Pallas kernels in interpret mode, each with that path's noise.

Tolerances: the solves take the same steps, but each side sums its error
norm in its own order, and a one-ulp shift of a step time moves the
Brownian path by ~2e-4 (tests/test_torch_sde.py), so logits and loss agree
to 2e-3 and gradients to 1e-2 of the largest; ``reg_val`` to 3e-2 relative,
the regulariser's error estimate being a cancelling sum (the bound of
tests/test_torch_train.py). The ODE's biased mode runs the arithmetic of
its unbiased mode (tests/test_torch_train.py: loss 1e-5, gradients 1e-3),
but its t1 is an accepted step's start, where this model's one-step error
estimate is ~3e-6, nearer its float32 noise: reg_val to 3e-2 (measured
3.2e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
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
)
from localregneuralde_tpu.models.neural_sde import NeuralDSDE as JNeuralDSDE
from localregneuralde_tpu.nn import Chain as JChain
from localregneuralde_tpu.nn import Dense as JDense
from localregneuralde_tpu_torch.harness import (
    construct_loss,
    construct_model,
    construct_optimizer,
    create_train_state,
    define_configuration,
    make_eval_step,
    make_train_step,
    one_hot,
    synthetic_classification,
)
from localregneuralde_tpu_torch.models import (
    NeuralDSDE,
    NeuralODE,
    TDChain,
    neural_ode,
    neural_sde,
)
from localregneuralde_tpu_torch.nn import Chain, Dense
from localregneuralde_tpu_torch.parity import load_jax_params
from test_torch_sde import (
    _jax_loop_uniforms,
    _params,
    _weights,
    pallas_interpret_source,
    xla_tree_source,
)

B, F, H = 8, 32, 64
TOL = 0.14
MAX_STEPS = 48
MODES = ["none", "unbiased", "biased"]


def _close_rel(ours, ref, rel):
    ours, ref = np.asarray(ours), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert float(np.abs(ours - ref).max()) <= rel * scale


def inject_sde_draws(monkeypatch, rng_key, pallas: bool, max_steps, t0=0.0,
                     t2=1.0):
    """Feed the port's NeuralDSDE the draws JAX's takes from ``rng_key``."""
    _, noise_key, tkey, rkey, wkey = jax.random.split(rng_key, 5)
    src = (pallas_interpret_source if pallas else xla_tree_source)(noise_key)
    t1 = float(jax.random.uniform(tkey, (), jnp.float32, minval=t0,
                                  maxval=t2))
    uniforms = (torch.tensor(np.asarray(jax.random.uniform(rkey, (max_steps,))))
                if pallas else _jax_loop_uniforms(rkey, max_steps))
    kw, kz = jax.random.split(wkey)
    monkeypatch.setattr(neural_sde, "noise_source", lambda seed, x: src)
    monkeypatch.setattr(neural_sde, "sample_t1", lambda g, a, b: t1)
    monkeypatch.setattr(neural_sde, "sample_reservoir_uniforms",
                        lambda g, n: uniforms[:n])
    monkeypatch.setattr(
        neural_sde, "sample_reg_noise",
        lambda g, shape: torch.tensor(np.stack([
            np.asarray(jax.random.normal(kw, tuple(shape))),
            np.asarray(jax.random.normal(kz, tuple(shape)))])))


@pytest.mark.parametrize("use_pallas", ["off", "on"])
@pytest.mark.parametrize("mode", MODES)
def test_neural_dsde_training_matches_jax(mode, use_pallas, monkeypatch):
    pallas = use_pallas == "on"
    kw = dict(regularize=mode, rtol=TOL, atol=TOL, max_steps=MAX_STEPS,
              solver="sosri")
    jnode = JNeuralDSDE(JChain(JDense(F, H, "tanh"), JDense(H, F)),
                        JDense(F, F), use_pallas=pallas, **kw)
    _, st = jnode.init(jax.random.PRNGKey(0))
    ps = _params()
    x = (0.5 * np.random.default_rng(1).standard_normal((B, F))).astype(
        np.float32)

    def jloss(p, x_):
        sol, st_ = jnode(p, st, x_, training=True)
        return jnp.sum(jnp.tanh(sol.ys[-1])) + 10.0 * st_["reg_val"], st_

    (val, jst), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(ps, jnp.asarray(x))

    inject_sde_draws(monkeypatch, st["rng"], pallas, MAX_STEPS)
    node = NeuralDSDE(Chain(Dense(F, H, "tanh"), Dense(H, F)), Dense(F, F),
                      use_pallas=use_pallas, **kw)
    load_jax_params(node, ps)
    xt = torch.tensor(x, requires_grad=True)
    sol, nst = node(xt, node.init_state(), training=True)
    loss = torch.sum(torch.tanh(sol.ys[-1])) + 10.0 * nst["reg_val"]
    loss.backward()
    assert int(nst["nfe_drift"]) == int(jst["nfe_drift"])
    assert int(nst["nfe_diffusion"]) == int(jst["nfe_diffusion"])
    assert bool(nst["success"]) and bool(jst["success"])
    if mode == "none":
        assert float(nst["reg_val"]) == 0.0
    else:
        np.testing.assert_allclose(float(nst["reg_val"].detach()),
                                   float(jst["reg_val"]), rtol=3e-2)
        assert float(nst["reg_val"].detach()) > 0
    np.testing.assert_allclose(float(loss.detach()), float(val), rtol=2e-3)
    for name, p in node.named_parameters():
        ref = gp
        for k in name.split("."):
            ref = ref[k]
        _close_rel(p.grad.numpy(), ref, 1e-2)
    _close_rel(xt.grad.numpy(), gx, 1e-2)


@pytest.mark.parametrize("use_pallas", ["off", "on"])
@pytest.mark.parametrize("mode", ["unbiased", "biased"])
def test_sde_regulariser_gradient_reaches_params_only(mode, use_pallas):
    """The locality fence: ∂reg/∂x ≡ 0, while ∂reg/∂params is finite and
    nonzero."""
    node = NeuralDSDE(Chain(Dense(F, H, "tanh"), Dense(H, F)), Dense(F, F),
                      regularize=mode, rtol=TOL, atol=TOL,
                      max_steps=MAX_STEPS, use_pallas=use_pallas)
    x = torch.randn(B, F, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    _, st = node(x, node.init_state(), training=True)
    params = list(node.parameters())
    gx, *gp = torch.autograd.grad(st["reg_val"], [x] + params,
                                  allow_unused=True)
    assert gx is None or float(gx.abs().max()) == 0.0
    flat = torch.cat([g.reshape(-1) for g in gp if g is not None])
    assert bool(torch.isfinite(flat).all()) and bool((flat != 0).any())
    assert float(st["reg_val"].detach()) > 0.0


def test_biased_reservoir_is_an_accepted_step_start():
    """tests/test_fused_sde.py:195 on the port's kernel twin: the sample is
    the state at an accepted step's start, never t_end."""
    from localregneuralde_tpu_torch.ops.cuda import persistent_sde_solve
    from localregneuralde_tpu_torch.sde import PhiloxNormals

    w = _weights(_params(7))
    x = torch.tensor(0.5 * np.random.default_rng(8).standard_normal((B, F)),
                     dtype=torch.float32)
    for seed in range(3):
        out = persistent_sde_solve(
            w, x, (0.0, 1.0), noise=PhiloxNormals(seed, B, F), rtol=TOL,
            atol=TOL, solver="sosri", delta=1 / 6,
            saveat_arr=torch.tensor([1.0]), max_steps=MAX_STEPS,
            record_knots=True,
            reservoir=torch.rand(MAX_STEPS,
                                 generator=torch.Generator().manual_seed(seed)))
        n = int(out["naccept"])
        j = int(torch.argmin((out["knot_ts"][:n] - out["reservoir_t"]).abs()))
        assert float(out["knot_ts"][j]) == float(out["reservoir_t"]) < 1.0
        assert torch.equal(out["knot_us"][j], out["reservoir_u"])


# ------------------------------------------------------------- whole model

CONFIG = "experiments/mnist_sde/mlp.yaml"


def _cfg(define, mode, use_pallas):
    cfg = define([f"--model.regularize={mode}",
                  f"--model.use_pallas={use_pallas}",
                  f"--model.solver.max_steps={MAX_STEPS}",
                  "--optimizer.optimizer=sgd", "--optimizer.learning_rate=0.1",
                  "--optimizer.scheduler.lr_scheduler=constant"], CONFIG)
    cfg.model.image_size = [8, 8]
    return cfg


@pytest.mark.parametrize("use_pallas", ["off", "on"])
@pytest.mark.parametrize("mode", MODES)
def test_mnist_sde_train_step_matches_jax(mode, use_pallas, monkeypatch):
    """One ``make_train_step`` of the yaml's model (w_reg 1000) from the
    same parameters and batch: loss, cross-entropy, reg_val, NFE and the
    update (SGD, so the update is the gradient), then one eval step."""
    jcfg = _cfg(jax_define_configuration, mode, use_pallas)
    jmodel = jax_construct_model(jcfg)
    jloss, jw = jax_construct_loss(jcfg)
    jopt, jsched = jax_construct_optimizer(jcfg)
    jts = jax_create_train_state(jmodel, jopt, jax.random.PRNGKey(0))
    p0 = jax.tree_util.tree_map(np.asarray, jts.params)
    x, y, _, _ = synthetic_classification((8, 8), 1, 10, n_train=B, n_test=1,
                                          seed=3)
    y1 = one_hot(y, 10)
    # a copy: the train step donates the state's buffers
    rng_key = jnp.asarray(np.asarray(jts.state["neural_dsde"]["rng"]))
    jts2, jl, jstats = jax_make_train_step(jmodel, jloss, jopt)(
        jts, (jnp.asarray(x), jnp.asarray(y1)), jw(1), jsched(1))

    inject_sde_draws(monkeypatch, rng_key, use_pallas == "on", MAX_STEPS)
    cfg = _cfg(define_configuration, mode, use_pallas)
    model = construct_model(cfg, device="cpu")
    load_jax_params(model, p0)
    loss_fn, w_reg = construct_loss(cfg)
    opt, sched = construct_optimizer(cfg)
    ts = create_train_state(model, opt)
    data = (torch.tensor(x), torch.tensor(y1))
    ts2, loss, stats = make_train_step(model, loss_fn, opt)(
        ts, data, w_reg(1), sched(1))

    assert [int(n) for n in stats["nfe"]] == [int(n) for n in jstats["nfe"]]
    np.testing.assert_allclose(float(stats["ce_loss"]),
                               float(jstats["ce_loss"]), rtol=2e-3)
    if mode != "none":
        np.testing.assert_allclose(float(stats["reg_val"]),
                                   float(jstats["reg_val"]), rtol=3e-2)
        np.testing.assert_allclose(float(loss), float(jl), rtol=3e-2)
    else:
        np.testing.assert_allclose(float(loss), float(jl), rtol=2e-3)
    lr = sched(1)
    for path, new in jax.tree_util.tree_leaves_with_path(jts2.params):
        name = ".".join(k.key for k in path)
        old = p0
        for k in path:
            old = old[k.key]
        _close_rel((ts2.params[name].detach().numpy() - old) / lr,
                   (np.asarray(new) - old) / lr, 3e-2 if mode != "none"
                   else 1e-2)
    # serving: one eval step, logits of the same shape, finite
    _, estats = make_eval_step(model, loss_fn)(ts2, data, w_reg(1))
    assert tuple(estats["y_pred"].shape) == (B, 10)
    assert bool(torch.isfinite(estats["y_pred"]).all())


# ------------------------------------------------------------- ODE biased

@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_neural_ode_biased_matches_jax(use_pallas, monkeypatch):
    """NeuralODE with the reservoir-sampled regulariser against JAX's, the
    reservoir's uniforms injected: JAX's XLA loop draws one per attempt by
    splitting its key."""
    Fo, Ho = 32, 16
    kw = dict(regularize="biased", adjoint="stored", rtol=3e-2, atol=3e-2,
              max_steps=32)
    jnode = JNeuralODE(JTDChain(JDense(Fo + 1, Ho, "tanh"),
                                JDense(Ho + 1, Fo)), **kw)
    ps, st = jnode.init(jax.random.PRNGKey(0))
    x = (0.5 * np.random.default_rng(1).standard_normal((B, Fo))).astype(
        np.float32)

    def jloss(p, x_):
        sol, st_ = jnode(p, st, x_, training=True)
        return jnp.sum(sol.ys[-1]) + st_["reg_val"], st_

    (val, jst), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(ps, jnp.asarray(x))
    _, _, rkey = jax.random.split(st["rng"], 3)
    uniforms = _jax_loop_uniforms(rkey, 32)
    monkeypatch.setattr(neural_ode, "sample_reservoir_uniforms",
                        lambda g, n: uniforms[:n])
    node = NeuralODE(TDChain(Dense(Fo + 1, Ho, "tanh"), Dense(Ho + 1, Fo)),
                     use_pallas=use_pallas, **kw)
    load_jax_params(node, {"model": ps["model"]})
    xt = torch.tensor(x, requires_grad=True)
    sol, nst = node(xt, node.init_state(), training=True)
    loss = sol.ys[-1].sum() + nst["reg_val"]
    loss.backward()
    assert int(nst["nfe"]) == int(jst["nfe"])
    np.testing.assert_allclose(float(loss.detach()), float(val), rtol=1e-5)
    np.testing.assert_allclose(float(nst["reg_val"].detach()),
                               float(jst["reg_val"]), rtol=3e-2)
    for name, p in node.model.named_parameters():
        layer, leaf = name.split(".")
        _close_rel(p.grad.numpy(), gp["model"][layer][leaf], 1e-3)
    _close_rel(xt.grad.numpy(), gx, 1e-4)
