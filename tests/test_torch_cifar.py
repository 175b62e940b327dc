"""The port's CIFAR-10 conv slice against the JAX package on the CPU: the
layers (Conv, BatchNorm, the TDChain's concat-free conv path,
AugmenterLayer), the plain versions of kernels 13 and 14 against JAX's
Pallas kernels in interpret mode, the conv ``NeuralODE`` (eval and
training, with the BatchNorm state threaded), one whole CIFAR
``make_train_step`` in both arms, and the classification runner.

Inputs come from numpy seeds; JAX's parameters and BatchNorm state carry
over through ``parity.py``. Sizes: B = 4, 8×8, Cs 8, Ch 16
(``tests/test_fused_conv.py:21``), the whole model at 8×8 images.

Tolerances, relative to the largest magnitude of the reference: states
1e-5 (f32 sums in another order: PyTorch's CPU convolutions against XLA's
and the Pallas kernel's roll-and-matmul taps), gradients 1e-4; ũ, a
cancelling sum of the stage derivatives, to 1e-5 of dt·max|k|.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.core import ArrayAndTime as JArrayAndTime
from localregneuralde_tpu.harness import (
    construct_loss as jax_construct_loss,
    construct_model as jax_construct_model,
    define_configuration as jax_define_configuration,
)
from localregneuralde_tpu.harness.construct import (
    construct_optimizer as jax_construct_optimizer,
)
from localregneuralde_tpu.harness.data import (
    get_classification_data as jax_get_classification_data,
    load_cifar10 as jax_load_cifar10,
)
from localregneuralde_tpu.harness.train import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)
from localregneuralde_tpu.models import (
    AugmenterLayer as JAugmenterLayer,
    NeuralODE as JNeuralODE,
    TDChain as JTDChain,
    diffeqsol_to_array as jax_sol_to_array,
)
from localregneuralde_tpu.nn import (
    BatchNorm as JBatchNorm,
    Chain as JChain,
    Conv as JConv,
    Dense as JDense,
)
from localregneuralde_tpu.ode.step import tsit5_step as jax_tsit5_step
from localregneuralde_tpu.ops.pallas.fused_conv import (
    conv_step_apply as jax_conv_step_apply,
    match_conv_family as jax_match_conv_family,
)
from localregneuralde_tpu.ops.pallas.fused_conv_bwd import (
    fused_conv_step_bwd as jax_fused_conv_step_bwd,
)
from localregneuralde_tpu_torch.core import ArrayAndTime
from localregneuralde_tpu_torch.harness import (
    construct_loss,
    construct_model,
    construct_optimizer,
    create_train_state,
    define_configuration,
    get_classification_data,
    load_cifar10,
    make_train_step,
)
from localregneuralde_tpu_torch.harness import runner
from localregneuralde_tpu_torch.harness.checkpoint import load_checkpoint
from localregneuralde_tpu_torch.models import (
    AugmenterLayer,
    NeuralODE,
    TDChain,
    neural_ode,
)
from localregneuralde_tpu_torch.nn import BatchNorm, Chain, Conv, Dense
from localregneuralde_tpu_torch.ops.cuda import (
    ConvWeights,
    conv_step_plain,
    fused_conv_step,
    fused_conv_step_bwd,
    match_conv_family,
)
from localregneuralde_tpu_torch.parity import (
    cifar_tree,
    load_jax_params,
    state_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "experiments", "cifar10", "cnn.yaml")
B, H, W, Cs, Ch = 4, 8, 8, 8, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these convolutions are small, and with the
    suite's workers (and XLA's pool) sharing the cores, PyTorch's default
    of one thread per core spends its time waiting on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_rel(ours, ref, rel, scale=None):
    ours = np.asarray(ours.detach() if isinstance(ours, torch.Tensor) else ours)
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12) if scale is None else scale
    err = float(np.abs(ours - ref).max())
    assert err <= rel * scale, f"max-abs {err:.3e} > {rel:.0e} x {scale:.3e}"


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _jax_dynamics(eval_stats="running"):
    return JTDChain(
        JChain(JConv((3, 3), Cs + 1, Ch, use_bias=False),
               JBatchNorm(Ch, "gelu", eval_stats=eval_stats)),
        JChain(JConv((3, 3), Ch + 1, Ch, use_bias=False),
               JBatchNorm(Ch, "gelu", eval_stats=eval_stats)),
        JConv((3, 3), Ch + 1, Cs, use_bias=False),
    )


def _dynamics(eval_stats="running"):
    return TDChain(
        Chain(Conv((3, 3), Cs + 1, Ch, use_bias=False),
              BatchNorm(Ch, "gelu", eval_stats=eval_stats)),
        Chain(Conv((3, 3), Ch + 1, Ch, use_bias=False),
              BatchNorm(Ch, "gelu", eval_stats=eval_stats)),
        Conv((3, 3), Ch + 1, Cs, use_bias=False),
    )


def _pair(seed=0, eval_stats="running"):
    """The JAX dynamics and the port's with the same parameters, and a
    non-trivial BatchNorm state in both."""
    jtd = _jax_dynamics(eval_stats)
    ps, st = jtd.init(jax.random.PRNGKey(seed))
    st = jax.tree_util.tree_map(lambda a: a + 0.1 * jnp.tanh(a + 1.0), st)
    td = _dynamics(eval_stats)
    load_jax_params(td, ps)
    return jtd, ps, st, td, state_from_jax(td.init_state(), st)


def _port_bn_stats(state):
    return [state[layer]["layer_1"][k] for layer in ("layer_0", "layer_1")
            for k in ("mean", "var")]


def _jax_bn_stats(state):
    return [state[layer]["layer_1"][k] for layer in ("layer_0", "layer_1")
            for k in ("mean", "var")]


# ---------------------------------------------------------------- layers

def test_conv_matches_jax():
    x = _normal(1, (B, H, W, 3))
    for kw in (dict(activation="gelu"), dict(use_bias=False)):
        jconv = JConv((3, 3), 3, 5, **kw)
        ps, _ = jconv.init(jax.random.PRNGKey(2))
        ps = jax.tree_util.tree_map(lambda a: a + 0.1, ps)  # a nonzero bias
        ref, _ = jconv(ps, {}, jnp.asarray(x))
        conv = Conv((3, 3), 3, 5, **kw)
        load_jax_params(conv, ps)
        ours, _ = conv(torch.tensor(x), {})
        _close_rel(ours, ref, 1e-5)
    # the Glorot fan over (kh, kw, in) -> out
    w = Conv((3, 3), 64, 32, generator=torch.Generator().manual_seed(0)).w
    w = w.detach()
    limit = np.sqrt(6.0 / (9 * 64 + 32))
    assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.9 * limit


@pytest.mark.parametrize("mode", ["train", "running", "batch"])
def test_batchnorm_matches_jax(mode):
    """Training: batch statistics, the biased variance in the EMA; eval:
    the running stats, or the batch's under eval_stats='batch'."""
    es = "batch" if mode == "batch" else "running"
    x = _normal(3, (B, H, W, Ch), 2.0) + 0.5
    jbn = JBatchNorm(Ch, "gelu", eval_stats=es)
    ps, st = jbn.init(jax.random.PRNGKey(0))
    ps = {"scale": jnp.asarray(1.0 + _normal(4, (Ch,), 0.1)),
          "bias": jnp.asarray(_normal(5, (Ch,), 0.1))}
    st = {"mean": jnp.asarray(_normal(6, (Ch,), 0.3)),
          "var": jnp.asarray(1.0 + np.abs(_normal(7, (Ch,), 0.3)))}
    training = mode == "train"
    ref, ref_st = jbn(ps, st, jnp.asarray(x), training=training)
    bn = BatchNorm(Ch, "gelu", eval_stats=es)
    load_jax_params(bn, ps)
    ours, our_st = bn(torch.tensor(x), state_from_jax(bn.init_state(), st),
                      training=training)
    _close_rel(ours, ref, 1e-5)
    for k in ("mean", "var"):
        _close_rel(our_st[k], ref_st[k], 1e-6)
    if training:  # the biased variance: the unbiased one is 1.0002x larger
        var = np.var(x.reshape(-1, Ch), axis=0)
        _close_rel(our_st["var"], 0.9 * np.asarray(st["var"]) + 0.1 * var, 1e-6)


@pytest.mark.parametrize("training", [True, False])
def test_tdchain_conv_path_and_augmenter_match_jax(training):
    jtd, ps, st, td, tst = _pair(seed=1)
    x = _normal(8, (B, H, W, Cs), 0.5)
    ref, ref_st = jtd(ps, st, JArrayAndTime(jnp.asarray(x), 0.3),
                      training=training)
    ours, our_st = td(ArrayAndTime(torch.tensor(x), torch.tensor(0.3)), tst,
                      training=training)
    _close_rel(ours.array, ref.array, 1e-5)
    for a, b in zip(_port_bn_stats(our_st), _jax_bn_stats(ref_st)):
        _close_rel(a, b, 1e-5)
    # AugmenterLayer(Conv 3 -> 5): the input and the conv's output
    jaug = JAugmenterLayer(JConv((3, 3), 3, 5))
    aps, _ = jaug.init(jax.random.PRNGKey(3))
    img = _normal(9, (B, H, W, 3))
    ref_a, _ = jaug(aps, {}, jnp.asarray(img))
    aug = AugmenterLayer(Conv((3, 3), 3, 5))
    load_jax_params(aug, {"augment": aps})
    ours_a, _ = aug(torch.tensor(img), aug.init_state())
    assert tuple(ours_a.shape) == (B, H, W, 8)
    _close_rel(ours_a, ref_a, 1e-5)


def test_match_conv_family():
    spec = match_conv_family(_dynamics())
    jspec = jax_match_conv_family(_jax_dynamics())
    assert (spec.Cs, spec.Ch, spec.momentum, spec.eps) == (
        jspec.Cs, jspec.Ch, jspec.momentum, jspec.eps)
    assert match_conv_family(TDChain(Dense(Cs + 1, Cs))) is None
    assert match_conv_family(_dynamics("batch")).eval_stats == "batch"
    node = NeuralODE(_dynamics())
    assert node.family == "conv" and node.use_pallas == "auto"
    assert not node.uses_kernels(torch.zeros(1))


# ------------------------------------------------------- the kernels' plain versions

def _step_inputs(seed):
    u = _normal(seed, (B, H, W, Cs), 0.5)
    k1 = _normal(seed + 1, (B, H, W, Cs), 0.5)
    return u, k1


@pytest.mark.parametrize("training", [True, False])
def test_conv_step_plain_matches_jax_kernel(training):
    """conv_step_plain (what fused_conv_step runs on CPU tensors) against
    JAX's Pallas step in interpret mode: u_new, ũ, k1..k7, g6 and, in
    training, the running stats after the six-evaluation EMA chain."""
    jtd, ps, st, td, tst = _pair(seed=2)
    u, k1 = _step_inputs(20)
    t, dt = 0.2, 0.07
    ref = jax_conv_step_apply(jax_match_conv_family(jtd), ps, st,
                              jnp.asarray(u), jnp.float32(t), jnp.float32(dt),
                              jnp.asarray(k1), training=training)
    spec = match_conv_family(td)
    w = ConvWeights(*td.parameters())
    rstats = _port_bn_stats(tst)
    out = fused_conv_step(w, spec, torch.tensor(u), torch.tensor(t),
                          torch.tensor(dt), torch.tensor(k1),
                          training=training, rstats=rstats)
    u_new, utilde, *ks, g6, stats = out
    ks_ref = ref[2]
    _close_rel(u_new, ref[0], 1e-5)
    kscale = max(float(np.abs(np.asarray(k)).max()) for k in ks_ref)
    _close_rel(utilde, ref[1], 1e-5, scale=dt * kscale)
    for a, b in zip(ks, ks_ref[1:]):
        _close_rel(a, b, 1e-5)
    _close_rel(g6, ref[3], 1e-5)
    if training:
        for a, b in zip(stats, _jax_bn_stats(ref[4])):
            _close_rel(a, b, 1e-5)
    else:
        assert stats is None


def test_conv_step_bwd_plain_matches_jax_kernel():
    """K14's plain version (the autograd VJP of conv_step_plain in training
    mode) against JAX's hand-fused backward in interpret mode."""
    jtd, ps, st, td, _ = _pair(seed=4)
    u, k1 = _step_inputs(30)
    cts = [_normal(40 + i, (B, H, W, Cs)) for i in range(9)]
    t, dt = 0.1, 0.08
    d_p, d_u, d_k1 = jax_fused_conv_step_bwd(
        jax_match_conv_family(jtd), ps, jnp.asarray(u), jnp.float32(t),
        jnp.float32(dt), jnp.asarray(k1), tuple(jnp.asarray(c) for c in cts))
    d_w, ours_u, ours_k1 = fused_conv_step_bwd(
        ConvWeights(*td.parameters()), match_conv_family(td), torch.tensor(u),
        torch.tensor(t), torch.tensor(dt), torch.tensor(k1),
        [torch.tensor(c) for c in cts])
    _close_rel(ours_u, d_u, 1e-4)
    _close_rel(ours_k1, d_k1, 1e-4)
    ref = [d_p["layer_0"]["layer_0"]["w"], d_p["layer_0"]["layer_1"]["scale"],
           d_p["layer_0"]["layer_1"]["bias"], d_p["layer_1"]["layer_0"]["w"],
           d_p["layer_1"]["layer_1"]["scale"], d_p["layer_1"]["layer_1"]["bias"],
           d_p["layer_2"]["w"]]
    for ours, r in zip(d_w, ref):
        _close_rel(ours, r, 1e-4)


def test_eval_stats_batch_follows_the_layer():
    """With eval_stats='batch' the port's eval step normalises with the
    batch's statistics, as the reference's XLA path does (its fused step
    takes the running stats whatever the layer says; ROADMAP Queue 3), and
    leaves the running stats alone."""
    jtd, ps, st, td, tst = _pair(seed=5, eval_stats="batch")
    u, k1 = _step_inputs(50)

    def f(x, s, p, stt):
        y, st2 = jtd(p, stt, JArrayAndTime(x, s), training=False)
        return y.array, st2

    ref = jax_tsit5_step(f, jnp.asarray(u), jnp.float32(0.3),
                         jnp.float32(0.05), jnp.asarray(k1), ps, st)
    spec = match_conv_family(td)
    out = fused_conv_step(ConvWeights(*td.parameters()), spec, torch.tensor(u),
                          torch.tensor(0.3), torch.tensor(0.05),
                          torch.tensor(k1), training=False,
                          rstats=_port_bn_stats(tst))
    _close_rel(out[0], ref.u_new, 1e-5)
    assert out[-1] is None
    running = fused_conv_step(ConvWeights(*td.parameters()),
                              spec._replace(eval_stats="running"),
                              torch.tensor(u), torch.tensor(0.3),
                              torch.tensor(0.05), torch.tensor(k1),
                              training=False, rstats=_port_bn_stats(tst))
    assert float((running[0] - out[0]).abs().max()) > 1e-3


# ---------------------------------------------------------------- NeuralODE

NODE_KW = dict(regularize="unbiased", adjoint="stored", rtol=1e-2, atol=1e-2,
               max_steps=32)


def _jax_t1(state, t0=0.0, t2=1.0):
    _, tkey, _ = jax.random.split(state["rng"], 3)
    return float(jax.random.uniform(tkey, (), jnp.float32, minval=t0,
                                    maxval=t2))


@pytest.fixture(scope="module")
def jax_conv_node():
    """JAX's conv NeuralODE with its fused kernels (interpret mode): an eval
    solve, and a training forward with its gradients and state."""
    node = JNeuralODE(_jax_dynamics(), use_pallas=True, **NODE_KW)
    ps, st = node.init(jax.random.PRNGKey(0))
    x = _normal(11, (B, H, W, Cs), 0.5)
    ct = _normal(12, (B, H, W, Cs))
    sol_e, st_e = node(ps, st, jnp.asarray(x), training=False)

    def loss(ps, x):
        sol, st_ = node(ps, st, x, training=True)
        y = jax_sol_to_array(sol)
        return jnp.sum(y * ct) + 10.0 * st_["reg_val"], (st_, y)

    (val, (st_t, y)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(ps, jnp.asarray(x))
    return dict(ps=ps, st=st, x=x, ct=ct, t1=_jax_t1(st), ys=sol_e.ys,
                nfe_eval=int(st_e["nfe"]), loss=float(val), y=y,
                reg_val=float(st_t["reg_val"]), nfe=int(st_t["nfe"]),
                model_state=st_t["model"], gp=gp["model"], gx=np.asarray(gx))


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_conv_neural_ode_matches_jax(jax_conv_node, use_pallas, monkeypatch):
    """The eval solve, and unbiased training through the stored adjoint
    (kernels 13 and 14 on CUDA tensors, their plain versions here): loss,
    NFE, the gradients of the parameters and the input, and the BatchNorm
    running stats threaded through the accepted steps and the regulariser's
    step. The regulariser is compared at 1e-3 (its error estimate is a
    cancelling f32 sum; tests/test_torch_train.py), the loss, a cancelling
    sum of 2048 products, at 1e-4 (measured 1.1e-5), and the running stats,
    an EMA over the batch means of 4 accepted steps' evaluations and the
    regulariser's, at 1e-4 (measured 1.8e-5)."""
    ref = jax_conv_node
    monkeypatch.setattr(neural_ode, "sample_t1", lambda g, t0, t2: ref["t1"])
    node = NeuralODE(_dynamics(), use_pallas=use_pallas, **NODE_KW)
    load_jax_params(node, {"model": ref["ps"]["model"]})
    st0 = node.init_state()
    assert node.uses_kernels(torch.zeros(1)) == (use_pallas == "on")
    sol_e, st_e = node(torch.tensor(ref["x"]), st0, training=False)
    assert int(st_e["nfe"]) == ref["nfe_eval"]
    _close_rel(sol_e.ys, ref["ys"], 1e-5)
    x = torch.tensor(ref["x"], requires_grad=True)
    sol, st = node(x, st0, training=True)
    loss = (sol.ys[-1] * torch.tensor(ref["ct"])).sum() + 10.0 * st["reg_val"]
    loss.backward()
    assert int(st["nfe"]) == ref["nfe"]
    _close_rel(sol.ys[-1], ref["y"], 1e-5)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-4)
    np.testing.assert_allclose(float(st["reg_val"].detach()), ref["reg_val"],
                               rtol=1e-3)
    for name, p in node.model.named_parameters():
        r = ref["gp"]
        for k in name.split("."):
            r = r[k]
        _close_rel(p.grad, r, 1e-4)
    _close_rel(x.grad, ref["gx"], 1e-4)
    for a, b in zip(_port_bn_stats(st["model"]),
                    _jax_bn_stats(ref["model_state"])):
        _close_rel(a, b, 1e-4)


def _bn_mlp(jax_side):
    """A dynamics with BatchNorm inside that no kernel family covers."""
    if jax_side:
        return JTDChain(JChain(JDense(7, 12), JBatchNorm(12, "tanh")),
                        JDense(13, 6))
    return TDChain(Chain(Dense(7, 12), BatchNorm(12, "tanh")), Dense(13, 6))


def test_generic_stored_adjoint_trains_batchnorm_like_jax():
    """The generic (non-kernel) training path: the dynamics runs in training
    mode, its BatchNorm state is threaded through the accepted steps of the
    stored adjoint's forward (fenced), and the gradients are those of JAX's
    stored adjoint. Before the repair the port ran eval-mode BN on the
    initial running stats and never advanced them. At rtol 1e-2 the two
    take the same steps (at 1e-3 their second step times differ by 1e-3,
    f32 noise in the error estimate, and the stats with them)."""
    kw = dict(regularize="none", adjoint="stored", rtol=1e-2, atol=1e-2,
              max_steps=64)
    jnode = JNeuralODE(_bn_mlp(True), use_pallas=False, **kw)
    ps, st = jnode.init(jax.random.PRNGKey(3))
    x = _normal(13, (16, 6), 0.7)
    ct = _normal(14, (16, 6))

    def loss(ps, x):
        sol, st_ = jnode(ps, st, x, training=True)
        return jnp.sum(jax_sol_to_array(sol) * ct), st_

    (val, st_j), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(ps, jnp.asarray(x))
    node = NeuralODE(_bn_mlp(False), **kw)
    assert node.family is None
    load_jax_params(node, {"model": ps["model"]})
    xt = torch.tensor(x, requires_grad=True)
    sol, st_t = node(xt, node.init_state(), training=True)
    (sol.ys[-1] * torch.tensor(ct)).sum().backward()
    assert int(st_t["nfe"]) == int(st_j["nfe"])
    bn_t = st_t["model"]["layer_0"]["layer_1"]
    bn_j = st_j["model"]["layer_0"]["layer_1"]
    for k in ("mean", "var"):
        _close_rel(bn_t[k], bn_j[k], 1e-5)
    assert float(bn_t["mean"].abs().max()) > 0  # the state advanced
    # relative to the largest gradient: the Dense bias before the
    # BatchNorm has a zero one (the batch mean removes it)
    grads = {name: p.grad for name, p in node.model.named_parameters()}
    refs = {}
    for name in grads:
        r = gp["model"]
        for k in name.split("."):
            r = r[k]
        refs[name] = np.asarray(r)
    scale = max(float(np.abs(r).max()) for r in refs.values())
    for name in grads:
        _close_rel(grads[name], refs[name], 1e-4, scale=scale)
    _close_rel(xt.grad, gx, 1e-4)


# ---------------------------------------------------------------- whole model

SMALL = ["--model.solver.reltol=1e-2", "--model.solver.abstol=1e-2",
         "--model.solver.max_steps=32", "--optimizer.optimizer=sgd",
         "--optimizer.learning_rate=0.1"]


def _small_cfg(define, extra=()):
    cfg = define(SMALL + list(extra), CONFIG)
    cfg.model.image_size = [8, 8]
    return cfg


@pytest.mark.parametrize("regularize", ["none", "unbiased"])
def test_cifar_train_step_matches_jax(regularize, monkeypatch):
    """One make_train_step of the whole CIFAR model (augmenter, BatchNorm,
    the conv NeuralODE through the kernels' plain versions, the conv
    classifier) from JAX's parameters, with JAX's t1 injected: loss, NFE,
    the updated parameters (SGD: the update is the gradient) and every
    BatchNorm running stat (1e-4, as for the NeuralODE: an EMA over every
    accepted evaluation's batch means)."""
    extra = [f"--model.regularize={regularize}"]
    jcfg = _small_cfg(jax_define_configuration, extra + ["--model.use_pallas=on"])
    jmodel = jax_construct_model(jcfg)
    jloss, jw = jax_construct_loss(jcfg)
    jopt, jsched = jax_construct_optimizer(jcfg)
    jts = jax_create_train_state(jmodel, jopt, jax.random.PRNGKey(0))
    t1 = _jax_t1(jts.state["neural_ode"])
    p0 = jax.tree_util.tree_map(np.asarray, jts.params)
    x = np.random.default_rng(7).uniform(size=(B, 8, 8, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[[0, 3, 5, 9]]
    jts2, jl, jstats = jax_make_train_step(jmodel, jloss, jopt)(
        jts, (jnp.asarray(x), jnp.asarray(y)), jw(1), jsched(1))

    monkeypatch.setattr(neural_ode, "sample_t1", lambda g, t0, t2: t1)
    cfg = _small_cfg(define_configuration, extra + ["--model.use_pallas=on"])
    model = construct_model(cfg, device="cpu")
    load_jax_params(model, cifar_tree(p0))
    loss_fn, w_reg = construct_loss(cfg)
    opt, sched = construct_optimizer(cfg)
    ts = create_train_state(model, opt)
    ts2, loss, stats = make_train_step(model, loss_fn, opt)(
        ts, (torch.tensor(x), torch.tensor(y)), w_reg(1), sched(1))

    assert int(stats["nfe"]) == int(jstats["nfe"])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    lr = sched(1)
    new = {".".join(k.key for k in path): np.asarray(v) for path, v in
           jax.tree_util.tree_leaves_with_path(cifar_tree(
               jax.tree_util.tree_map(np.asarray, jts2.params)))}
    old = {".".join(k.key for k in path): v for path, v in
           jax.tree_util.tree_leaves_with_path(cifar_tree(p0))}
    # the updates relative to the largest one: the augmenter's bias has a
    # zero gradient (the BatchNorm after it removes a per-channel shift)
    scale = max(float(np.abs(new[k] - old[k]).max()) for k in new) / lr
    for name, p in ts2.params.items():
        _close_rel((p.detach().numpy() - old[name]) / lr,
                   (new[name] - old[name]) / lr, 1e-3, scale=scale)
    for path, v in jax.tree_util.tree_leaves_with_path(jts2.state):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] in ("mean", "var"):
            ours = ts2.state
            for k in keys:
                ours = ours[k]
            _close_rel(ours, v, 1e-4)


# ---------------------------------------------------------------- data, runner

def test_cifar_data_is_bitwise_jax():
    cfg = _small_cfg(define_configuration)
    jcfg = _small_cfg(jax_define_configuration)
    for a, b in zip(get_classification_data(cfg),
                    jax_get_classification_data(jcfg)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    root = os.path.join(ROOT, "tests", "fixtures", "cifar_npz")
    for a, b in zip(load_cifar10(root), jax_load_cifar10(root)):
        np.testing.assert_array_equal(a, b)
    assert load_cifar10("") is None


def _runner_cfg(tmp, steps, extra=()):
    cfg = _small_cfg(define_configuration, [
        f"--train.total_steps={steps}", "--train.print_frequency=1",
        "--train.evaluate_every=2", "--dataset.train_batchsize=4",
        "--dataset.eval_batchsize=512", "--model.regularize=unbiased",
        f"--train.checkpoint_dir={tmp}/ckpt", f"--train.log_dir={tmp}/logs",
        *extra])
    return cfg


class _Killed(Exception):
    pass


def test_runner_resumes_the_uninterrupted_run(tmp_path, monkeypatch):
    """run_classification_experiment for 3 steps on the CPU, against a run
    killed after its step-2 checkpoint and resumed from model_current: the
    resumed run sees the same batches and ends with the same parameters,
    BatchNorm state and eval metrics (the same arithmetic: rtol 1e-6)."""
    seen, kill_at = [], [None]
    make = runner.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def wrapped(ts, batch, w, lr):
            if len(seen) == kill_at[0]:
                raise _Killed
            seen.append(float(batch[0].sum()))
            return step(ts, batch, w, lr)

        return wrapped

    monkeypatch.setattr(runner, "make_train_step", recording)
    # the stand-in's first 512 train and 64 test images: an evaluation is
    # one batch, not the 2,048-image split
    x_tr, y_tr, x_te, y_te, real = get_classification_data(
        _runner_cfg(tmp_path / "a", 3))
    monkeypatch.setattr(runner, "get_classification_data", lambda cfg: (
        x_tr[:512], y_tr[:512], x_te[:64], y_te[:64], real))
    run = runner.run_classification_experiment
    full = run(_runner_cfg(tmp_path / "a", 3), normalize=runner.cifar_normalize,
               device="cpu")
    # the warm-up step runs on a copy and counts as a batch seen
    batches_full, seen[:] = list(seen), []
    kill_at[0] = 3
    with pytest.raises(_Killed):
        run(_runner_cfg(tmp_path / "b", 3), normalize=runner.cifar_normalize,
            device="cpu")
    kill_at[0] = None
    seen[:] = seen[:1]  # keep the killed run's warm-up, drop its steps
    resumed = run(_runner_cfg(tmp_path / "b", 3),
                  normalize=runner.cifar_normalize, device="cpu")
    assert len(batches_full) == 4
    assert seen[-1] == batches_full[-1]
    assert os.path.islink(os.path.join(resumed["ckpt_dir"],
                                       "model_current.ckpt"))
    a = load_checkpoint(os.path.join(full["ckpt_dir"], "model_current.ckpt"))
    b = load_checkpoint(os.path.join(resumed["ckpt_dir"],
                                     "model_current.ckpt"))
    assert int(a["step"]) == int(b["step"]) == 3
    for k, v in a["tstate"]["params"].items():
        np.testing.assert_allclose(b["tstate"]["params"][k], v, rtol=1e-6)
    bn_a = a["tstate"]["state"]["neural_ode"]["model"]["layer_0"]["layer_1"]
    bn_b = b["tstate"]["state"]["neural_ode"]["model"]["layer_0"]["layer_1"]
    np.testing.assert_allclose(bn_b["mean"], bn_a["mean"], rtol=1e-6)
    for k, v in full["final_eval"].items():
        np.testing.assert_allclose(resumed["final_eval"][k], v, rtol=1e-6)
    assert not full["real_data"] and full["final_step"] == 3


def test_runner_refuses_unported_options(tmp_path):
    """The JAX runner's check of the grid: ``tensor_parallel=2`` on the
    global grid of one process raises ValueError before a process group is
    made, its degree not dividing the ranks (tensor parallelism keeps every
    CIFAR leaf whole, ``tests/test_torch_parallel_tp.py``; the global grid
    runs CIFAR, ``tests/test_torch_parallel_conv.py``)."""
    import torch.distributed as dist

    initialised = dist.is_initialized()
    with pytest.raises(ValueError, match="does not divide the"):
        runner.run_classification_experiment(
            _runner_cfg(tmp_path, 1, ["--train.data_parallel=gspmd",
                                      "--train.tensor_parallel=2"]),
            device="cpu")
    assert dist.is_initialized() == initialised


def test_runner_k_steps_with_accumulation_and_ema(tmp_path, monkeypatch):
    """steps_per_call=2 with grad_accumulation=2 and ema_decay=0.9 on the
    conv family: the K-step calls run eagerly (the adaptive loop accepts on
    the host), and end where the single-step loop ends, bitwise on the CPU;
    the checkpoint keeps the EMA."""
    x_tr, y_tr, x_te, y_te, real = get_classification_data(
        _runner_cfg(tmp_path, 2))
    monkeypatch.setattr(runner, "get_classification_data", lambda cfg: (
        x_tr[:64], y_tr[:64], x_te[:16], y_te[:16], real))
    out = {}
    for spc in (1, 2):
        out[spc] = runner.run_classification_experiment(
            _runner_cfg(tmp_path / f"k{spc}", 2, [
                f"--train.steps_per_call={spc}", "--train.print_frequency=2",
                "--train.grad_accumulation=2", "--train.ema_decay=0.9",
                "--dataset.eval_batchsize=16"]),
            normalize=runner.cifar_normalize, device="cpu")
    assert out[2]["steps_per_call"] == 2 and not out[2]["captured"]
    a, b = (load_checkpoint(os.path.join(out[k]["ckpt_dir"],
                                         "model_current.ckpt"))["tstate"]
            for k in (1, 2))
    for part in ("params", "ema"):
        assert set(a[part]) == set(b[part])
        for k, v in a[part].items():
            np.testing.assert_array_equal(b[part][k], v)
    assert out[1]["final_eval"] == out[2]["final_eval"]
