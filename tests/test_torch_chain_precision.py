"""The chain family's precision tiers (the latent ODE: kernels 5 and 9, and
the latent model's layers outside its DE layer) against the JAX package on
the CPU.

The reference routes the Dense chain as it routes the TD-MLP: kernel 5 at
``mm_precision``, kernel 9 with its replay at ``mm_precision``, its
recompute at ``bwd_precision`` and its gradient products at the backend
default (``grad_precision=None``), TF32 on a card whatever the forward's
tier; the encoder cell, ``rec_to_gen`` and ``gen_to_data`` are built with
``precision=None``. On the CPU every tier computes FP32, as JAX does
there, so the existing parity tests hold as they stand. The TF32 plain
versions round each product's operands with ``nn.basic.round_tf32`` and
multiply in FP32:

- one Dense layer at TF32 (the chain's, or an outer layer) is held against
  JAX's FP32 product of operands rounded by ``jax.lax.reduce_precision(·,
  8, 10)`` (inputs nudged off the ties), within FP32's summation error
  over its K terms;
- the four-layer chain element by element within the first-order bound of
  its rounded products against JAX's FP32 chain;
- kernel 5's plain version at TF32 against JAX's Pallas kernel (interpret
  mode, FP32) at rtol 1e-3: NFE within two attempts, the saveat states
  within 1e-4 of their scale (two solves of one ODE at rtol 1e-3 whose
  steps TF32's noise in ũ sets apart by an attempt) plus one evaluation's
  TF32 rounding, 2·2^-11 a layer;
- kernel 9's plain version at tiers 2 (TF32 gradient products: the
  reference's route at physionet.yaml's rtol) and 3 (the recompute too),
  dense and two-level, against JAX's FP32 sweep on JAX's knots: a_u, a_k
  and each weight gradient within one swept step's TF32 rounding of their
  scale (2·2^-11 per product in sequence: the reverse chain's 6·4 + 1, and
  the recompute's 7·4 at tiers 3);
- a latent train step at the card's tiers (``nn.tiers_of("cuda")``)
  against JAX's FP32 step: the update within one swept step's TF32
  rounding, at rtol 1e-3 where 'auto' takes the TF32 forward.

The routing of the latent model's tiers is checked through the tiers each
wrapper and each Dense layer is called at. Sizes: the chain of
``tests/test_torch_latent.py`` (F = 6, H = 10, four layers, B = 8), its
small latent model; one intra-op thread.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.harness.construct import (
    construct_loss as jax_construct_loss,
    construct_optimizer as jax_construct_optimizer,
)
from localregneuralde_tpu.harness.train import (
    make_train_step as jax_make_train_step,
)
from localregneuralde_tpu.ops.pallas.fused_solve import chain_eval_pure
from localregneuralde_tpu.ops.pallas.fused_solve_bwd import (
    persistent_chain_sweep as jax_chain_sweep,
)
from localregneuralde_tpu_torch import ops
from localregneuralde_tpu_torch.harness import (
    construct_loss,
    construct_optimizer,
    construct_time_series,
    create_train_state,
    define_configuration,
    make_train_step,
)
from localregneuralde_tpu_torch.models import common, neural_ode
from localregneuralde_tpu_torch.nn import basic
from localregneuralde_tpu_torch.nn.basic import SCOPE, tiers_of
from localregneuralde_tpu_torch.ops.cuda import (
    DenseChainSpec,
    chain_eval,
    persistent_chain_solve,
    persistent_chain_solve_plain,
    persistent_chain_sweep,
    persistent_chain_sweep_plain,
)
from localregneuralde_tpu_torch.ops.cuda.fused_solve_bwd import sweep_tiers
from localregneuralde_tpu_torch.parity import latent_tree, params_from_jax
from test_torch_latent import (
    B,
    CF,
    CH,
    CONFIG,
    CRTOL,
    CSAVE,
    NODE,
    SMALL,
    _chain_setup,
    _jax_model,
    _port_model,
    _series,
    _spec,
    jax_chain_run,  # noqa: F401 (the fixture)
)
from test_torch_sde_precision import (
    U,
    _normal,
    _off_ties,
    _rel,
    _rp,
    _within_fp32_sums,
    tf32_tol,
)

L = 4                       # the test chain's layers
GRAD_DEPTH = 6 * L + 1      # a transposed step: six stages' and the flush
RECOMPUTE_DEPTH = 7 * L     # k1 and the six stages
SOLVE_REL = 1e-4            # two rtol-1e-3 solves an attempt apart


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the chain

def test_chain_layer_tf32_matches_jax_on_rounded_operands():
    """One Dense layer of the chain at TF32: JAX's FP32 product of the
    rounded operands plus the bias, within FP32's summation error; the
    tiers differ."""
    _, ps, _, _ = _chain_setup(1)
    w = _off_ties(ps["layer_1"]["w"])
    b = ps["layer_1"]["b"]
    x = _normal(2, (B, CF))
    spec = DenseChainSpec((CF, CH), (False,), False)
    params = [torch.tensor(w), torch.tensor(b)]
    ours = chain_eval(params, spec, torch.tensor(x), "tf32").numpy()
    ref = np.asarray(_rp(x) @ _rp(w) + b)
    assert _within_fp32_sums(ours, ref, x, w, CF)
    assert _rel(ours, chain_eval(params, spec, torch.tensor(x)).numpy()) > 1e-6


def test_chain_eval_tf32_within_tf32_rounding_of_jax():
    """The four-layer chain (leading tanh, tanh after each layer) at TF32
    against JAX's FP32 ``chain_eval_pure``, element by element within the
    first-order bound of its rounded products:
    |Δa_{l+1}| ≤ (2u·|a_l| + |Δa_l|)·|W_l| (tanh' ≤ 1)."""
    _, ps, x, params = _chain_setup(3)
    keys = ("layer_1", "layer_2", "layer_3", "layer_4")
    ours = chain_eval(params, _spec(), torch.tensor(x), "tf32").numpy()
    ref = np.asarray(chain_eval_pure(ps, keys, (True,) * L, True,
                                     jnp.asarray(x)))
    a = np.tanh(x.astype(np.float64))
    da = np.zeros_like(a)
    for k in keys:
        w = np.abs(ps[k]["w"]).astype(np.float64)
        da = (2 * U * np.abs(a) + da) @ w
        a = np.tanh(a @ ps[k]["w"] + ps[k]["b"])
    assert np.all(np.abs(ours - ref) <= 1.01 * da + 1e-6)
    assert _rel(ours, ref) > 1e-6


# ------------------------------------------------------------ kernel 5

def test_k5_tf32_plain_against_jax_kernel(jax_chain_run):
    """Kernel 5's plain version at TF32 against the JAX kernel (interpret
    mode, FP32) at rtol 1e-3: NFE within two attempts, ys and y_final
    within 1e-4 of their scale plus one evaluation's TF32 rounding; t0's
    saveat entry returns u0 exactly. The wrapper on the CPU inside
    ``tiers_of("cuda")`` at the backend default is bitwise the TF32 plain
    version, with no launch counted."""
    r = jax_chain_run
    ref = r["out"]
    xt = torch.tensor(r["x"])
    kw = dict(rtol=CRTOL, atol=CRTOL, saveat_arr=torch.tensor(CSAVE),
              max_steps=64)
    ours = persistent_chain_solve_plain(r["params"], _spec(), xt, (0.0, 1.0),
                                        tier="tf32", **kw)
    assert bool(ours["success"])
    assert abs(int(ours["nfe"]) - int(ref["nfe"])) <= 12
    scale = float(np.abs(ref["ys"]).max())
    for k in ("ys", "y_final"):
        err = float(np.abs(ours[k].numpy() - ref[k]).max())
        assert err <= (SOLVE_REL + tf32_tol(L)) * scale, (k, err)
    np.testing.assert_array_equal(ours["ys"][1].numpy(), r["x"])
    with tiers_of("cuda"):
        card = persistent_chain_solve(r["params"], _spec(), xt, (0.0, 1.0),
                                      precision=None, **kw)
    assert torch.equal(card["ys"], ours["ys"])
    assert ops.cuda.tier_launch_counts()["persistent_chain_solve"] == {}


# ------------------------------------------------------------ kernel 9

@pytest.mark.parametrize("two_level", [False, True], ids=["dense",
                                                          "two-level"])
@pytest.mark.parametrize("tiers,depth", [
    (("fp32", "fp32", "tf32"), GRAD_DEPTH),
    (("fp32", "tf32", "tf32"), GRAD_DEPTH + RECOMPUTE_DEPTH),
], ids=["tiers 2", "tiers 3"])
def test_k9_tf32_plain_against_jax_sweep(jax_chain_run, tiers, depth,
                                         two_level):
    """Kernel 9's plain version at tiers 2 (TF32 gradient products behind
    FP32 replay and recompute) and 3 (the recompute too) against JAX's
    FP32 sweep kernel on JAX's knots, dense and two-level (capacity 2,
    every window replayed from JAX's checkpoints at FP32): a_u, a_k and
    every gradient within one swept step's TF32 rounding; the wrapper on
    the CPU inside ``tiers_of("cuda")`` at the reference's tiers bitwise
    the plain version."""
    r = jax_chain_run
    ref = r["out"]
    rng = np.random.default_rng(10)
    ct_ys = rng.standard_normal((len(CSAVE), B, CF)).astype(np.float32)
    ct_y = rng.standard_normal((B, CF)).astype(np.float32)
    ctx = jctx = None
    if two_level:
        ck = ("ckpt_ts", "ckpt_us", "ckpt_ks", "ckpt_dts", "ckpt_qolds")
        jctx = {k: jnp.asarray(ref[k]) for k in ck}
        jctx.update(t_end=1.0, rtol=CRTOL, atol=CRTOL, max_steps=64,
                    stride=2, dense_cap=2, use_reservoir=False)
        ctx = {k: torch.tensor(ref[k][..., :CF] if ref[k].ndim == 3
                               else ref[k]) for k in ck}
        ctx.update(t_end=1.0, rtol=CRTOL, atol=CRTOL, max_steps=64, stride=2,
                   dense_cap=2)
    ja_u, ja_k, jd = jax_chain_sweep(
        r["ps"], r["info"], jnp.asarray(ref["knot_ts"]),
        jnp.asarray(ref["knot_us"]), jnp.asarray(ref["naccept"]),
        jnp.asarray(CSAVE), jnp.asarray(ct_ys), jnp.asarray(ct_y),
        two_level_ctx=jctx)
    args = (r["params"], _spec(), torch.tensor(ref["knot_ts"]),
            torch.tensor(ref["knot_us"][..., :CF]),
            torch.tensor(ref["naccept"]), torch.tensor(CSAVE),
            torch.tensor(ct_ys), torch.tensor(ct_y))
    a_u, a_k, grads = persistent_chain_sweep_plain(*args, two_level_ctx=ctx,
                                                   tiers=tiers)
    jg = [jd[k][n] for k in ("layer_1", "layer_2", "layer_3", "layer_4")
          for n in ("w", "b")]
    for ours, refg in zip([a_u, a_k, *grads], [ja_u, ja_k, *jg]):
        assert _rel(ours.numpy(), refg) <= tf32_tol(depth)
    assert max(_rel(g.numpy(), j) for g, j in zip(grads, jg)) > 1e-6
    rec = None if tiers[1] == "tf32" else "highest"
    with tiers_of("cuda"):
        assert sweep_tiers("highest", None, rec or "default",
                           torch.device("cuda")) == tiers
        w_u, w_k, w_g = persistent_chain_sweep(
            *args, two_level_ctx=ctx, precision="highest",
            grad_precision=None, recompute_precision=rec or "default")
    assert torch.equal(w_u, a_u) and torch.equal(w_k, a_k)
    assert all(torch.equal(a, b) for a, b in zip(w_g, grads))


# --------------------------------------------------- the latent model's tiers

def _small_model(extra=()):
    cfg = define_configuration(SMALL + list(extra), CONFIG)
    _, tgrid = _series(11)
    return cfg, construct_time_series(cfg, saveat=torch.tensor(tgrid),
                                      device="cpu")


def test_latent_outer_layers_at_the_backend_default():
    """The encoder cell's six Dense layers, ``rec_to_gen``'s two and
    ``gen_to_data`` take the reference's ``precision=None``: TF32 inside
    ``tiers_of("cuda")``, JAX's FP32 product of the rounded operands within
    FP32's summation error; bitwise the FP32 layer outside it. The
    generative dynamics' Dense layers keep following their solver's
    scope."""
    _, model = _small_model()
    outer = [(n, m) for n, m in model.named_modules()
             if isinstance(m, basic.Dense) and not n.startswith("neural_ode")]
    assert [n.split(".")[0] for n, _ in outer] == (
        ["gru"] * 6 + ["rec_to_gen"] * 2 + ["gen_to_data"])
    assert all(m.precision is None for _, m in outer)
    inner = [m for n, m in model.named_modules()
             if n.startswith("neural_ode") and isinstance(m, basic.Dense)]
    assert len(inner) == 8 and all(m.precision == SCOPE for m in inner)
    for i, (name, layer) in enumerate(outer):
        w = _off_ties(layer.w.detach().numpy())
        with torch.no_grad():
            layer.w.copy_(torch.tensor(w))
        x = _normal(40 + i, (4, layer.in_dim))
        ref = np.asarray(_rp(x) @ _rp(w)) + layer.b.detach().numpy()
        mag = np.abs(np.asarray(_rp(x), np.float64)) @ np.abs(
            np.asarray(_rp(w), np.float64))
        xt = torch.tensor(x)
        with torch.no_grad(), tiers_of("cuda"):
            card, _ = layer(xt, layer.init_state())
        with torch.no_grad():
            cpu, _ = layer(xt, layer.init_state())
        # the activations (tanh, sigmoid) are 1-Lipschitz
        bound = 2 * (layer.in_dim + 1) * 2.0 ** -24 * (mag + 1.0)
        want = layer.activation(torch.tensor(ref)).numpy()
        assert np.all(np.abs(card.numpy() - want) <= bound), name
        assert not torch.equal(card, cpu), name
        with torch.no_grad():
            assert torch.equal(cpu, layer.activation(xt @ layer.w + layer.b))


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_latent_train_step_at_the_card_tiers(use_pallas, monkeypatch):
    """One ``make_train_step`` (SGD) of the small latent model inside
    ``tiers_of("cuda")`` ('auto' at rtol = atol 0.1: the TF32 forward,
    kernels 5 and 9's plain versions at TF32 on 'on', the modules at TF32
    on 'off'; the outer layers at TF32) against JAX's FP32 step from JAX's
    parameters with JAX's t1 and ε injected and w_reg = 0: NFE within two
    attempts, the loss within one evaluation's TF32 rounding, every
    parameter's update within one swept step's (the chain's reverse chain
    and recompute, and the outer layers' products); apart from the FP32
    step's. At rtol 0.1 TF32's noise in ũ does not set the steps: at 1e-3
    the TF32 solve takes other steps than the FP32 one, and this chain's
    gradients move by tens of percent between any two step sequences (FP32
    at 1e-3 against FP32 at 1e-4 as much), so no gradient gate holds
    there."""
    loose = ["--model.solver.reltol=0.1", "--model.solver.abstol=0.1"]
    jcfg, jmodel, jts, batch, tgrid = _jax_model(loose)
    p = jax.tree_util.tree_map(np.asarray, jts.params)
    jloss, (jw_reg, _) = jax_construct_loss(jcfg)
    jopt, jsched = jax_construct_optimizer(jcfg)
    # w_reg = 0: the regulariser's error estimate is the quantity TF32's
    # noise swamps (the reason for the refusal below rtol 1e-4), so the
    # step is held on the likelihood and the KL term
    w = (0.0, 0.5)
    _, tkey, _ = jax.random.split(jts.state["neural_ode"]["rng"], 3)
    t1 = float(jax.random.uniform(tkey, (), jnp.float32, minval=0.0,
                                  maxval=1.0))
    eps = np.asarray(jax.random.normal(
        jax.random.split(jts.state["reparam"]["rng"])[1], (B, NODE)))
    ports = {scope: _port_model(use_pallas, tgrid, jts, loose)
             for scope in ("fp32", "tf32")}
    jts2, jl, jstats = jax_make_train_step(jmodel, jloss, jopt)(
        jts, tuple(jnp.asarray(a) for a in batch), w, jsched(1))
    monkeypatch.setattr(neural_ode, "sample_t1", lambda g, t0, t2: t1)
    monkeypatch.setattr(common, "reparam_noise",
                        lambda g, shape, like: torch.tensor(eps))
    updates = {}
    for scope, (cfg, model) in ports.items():
        loss_fn, _ = construct_loss(cfg)
        opt, sched = construct_optimizer(cfg)
        ts = create_train_state(model, opt)
        before = {k: v.detach().clone() for k, v in ts.params.items()}
        with (tiers_of("cuda") if scope == "tf32"
              else contextlib.nullcontext()):
            ts2, loss, stats = make_train_step(model, loss_fn, opt)(
                ts, tuple(torch.tensor(a) for a in batch), w, sched(1))
        updates[scope] = {k: (ts2.params[k].detach() - before[k])
                          for k in before}
    assert abs(int(stats["nfe"]) - int(jstats["nfe"])) <= 12
    np.testing.assert_allclose(float(loss), float(jl),
                               rtol=tf32_tol(L + 5))
    ref = params_from_jax(latent_tree(jax.tree_util.tree_map(
        np.asarray, jts2.params)))
    old = params_from_jax(latent_tree(p))
    depth = GRAD_DEPTH + RECOMPUTE_DEPTH + 2 * 5
    for name, new in ref.items():
        assert _rel(updates["tf32"][name].numpy(),
                    (new - old[name]).numpy()) <= tf32_tol(depth), name
    assert max(_rel(updates["tf32"][k].numpy(), updates["fp32"][k].numpy())
               for k in ref) > 1e-6


class _Recorder:
    """Wraps kernels 5's and 9's wrappers (where the model looks them up)
    and ``nn.basic.layer_tier``, and records the tiers each is called at:
    the wrappers', and every Dense layer's by the layer's name."""

    def __init__(self, monkeypatch, model):
        self.k5, self.k9, self.dense = [], [], {}
        k5, k9 = ops.cuda.persistent_chain_solve, ops.cuda.persistent_chain_sweep

        def rec5(*a, precision="highest", **kw):
            self.k5.append(basic.product_tier(precision, a[2].device))
            return k5(*a, precision=precision, **kw)

        def rec9(*a, precision="highest", grad_precision="highest",
                 recompute_precision="match", **kw):
            self.k9.append("/".join(sweep_tiers(
                precision, grad_precision, recompute_precision,
                a[-1].device)))
            return k9(*a, precision=precision, grad_precision=grad_precision,
                      recompute_precision=recompute_precision, **kw)

        monkeypatch.setattr(ops.cuda, "persistent_chain_solve", rec5)
        monkeypatch.setattr(ops.cuda, "persistent_chain_sweep", rec9)
        names = {id(m): n.split(".")[0] for n, m in model.named_modules()}
        layer_tier = basic.layer_tier
        forward = basic.Dense.apply_layer

        def apply_layer(layer, x, state, **kw):
            self.current = names.get(id(layer))
            return forward(layer, x, state, **kw)

        def rec_tier(precision, x):
            tier = layer_tier(precision, x)
            self.dense.setdefault(self.current, set()).add(tier)
            return tier

        monkeypatch.setattr(basic.Dense, "apply_layer", apply_layer)
        monkeypatch.setattr(basic, "layer_tier", rec_tier)


@pytest.mark.parametrize("route", [
    # (options, K5's tier, K9's tiers, the generative dynamics' Dense tier)
    (["--model.use_pallas=on", "--model.solver.reltol=1e-5",
      "--model.solver.abstol=1e-5"], "fp32", "fp32/fp32/tf32", "fp32"),
    (["--model.use_pallas=on"], "tf32", "tf32/tf32/tf32", "tf32"),
    (["--model.use_pallas=on", "--model.solver.precision=highest",
      "--model.solver.grad_precision=default"], "fp32", "fp32/tf32/tf32",
     "fp32"),
    (["--model.use_pallas=off"], None, None, "tf32"),
], ids=["auto below 1e-4", "auto 1e-3", "highest, grad default", "plain"])
def test_latent_routes_take_the_reference_tiers(route, monkeypatch):
    """A latent train forward and backward on the CPU inside
    ``tiers_of("cuda")`` calls kernel 5 at ``mm_precision``'s tier, kernel
    9 with its replay at it, its recompute at ``bwd_precision``'s and its
    gradient products at TF32 always, and the generative dynamics' Dense
    layers (the regulariser's step; the plain route's solve) at
    ``mm_precision``'s tier; the encoder, ``rec_to_gen`` and
    ``gen_to_data`` at TF32. Outside the scope every tier is FP32."""
    extra, t5, t9, tgen = route
    (data, mask, dt), _ = _series(12)
    x = torch.tensor(np.concatenate([data, mask, dt], axis=-1))
    for scope in (tiers_of("cuda"), contextlib.nullcontext()):
        _, model = _small_model(extra)
        rec = _Recorder(monkeypatch, model)
        with scope:
            y, st = model(x, model.init_state(), training=True)
            (y ** 2).sum().backward()
        assert bool(st["neural_ode"]["success"])
        if isinstance(scope, contextlib.nullcontext):
            assert set(rec.k5) | {t for s in rec.dense.values() for t in s} \
                <= {"fp32"}
            assert set(rec.k9) <= {"fp32/fp32/fp32"}
            continue
        assert set(rec.k5) == ({t5} if t5 else set())
        assert set(rec.k9) == ({t9} if t9 else set())
        assert rec.dense["neural_ode"] == {tgen}
        for name in ("gru", "rec_to_gen", "gen_to_data"):
            assert rec.dense[name] == {"tf32"}, name


def test_latent_tf32_forward_refuses_tight_tolerances():
    """The chain's forward at the TF32 tier below rtol 1e-4 raises: on the
    card's tiers with precision 'default', not with 'auto' (FP32 below
    1e-4); the kernel's plain version at TF32 too; on the CPU's tiers the
    same model runs."""
    tight = ["--model.solver.reltol=1e-5", "--model.solver.abstol=1e-5"]
    (data, mask, dt), _ = _series(13)
    x = torch.tensor(np.concatenate([data, mask, dt], axis=-1))
    _, model = _small_model(tight + ["--model.solver.precision=default"])
    assert model.neural_ode.forward_tier(torch.device("cuda")) == "tf32"
    with torch.no_grad(), tiers_of("cuda"), pytest.raises(ValueError,
                                                           match="1e-4"):
        model(x, model.init_state(), training=False)
    with torch.no_grad():
        y, _ = model(x, model.init_state(), training=False)
    assert bool(torch.isfinite(y).all())
    _, auto = _small_model(tight)
    assert auto.neural_ode.forward_tier(torch.device("cuda")) == "fp32"
    _, _, xc, params = _chain_setup()
    with pytest.raises(ValueError, match="1e-4"):
        persistent_chain_solve_plain(
            params, _spec(), torch.tensor(xc), (0.0, 1.0), rtol=1e-5,
            atol=1e-5, saveat_arr=torch.tensor([1.0]), max_steps=4,
            tier="tf32")
