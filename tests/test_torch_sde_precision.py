"""The SDE family's precision tiers (the reference's 'highest' and
'default', which on a card is TF32) and the tier of the layers outside the
DE layers, against the JAX package.

On the CPU every tier computes FP32, as JAX does there, so the existing
parity tests hold as they stand. The TF32 tier's plain versions
(``tier="tf32"``, which kernels 10 and 12's TF32 instantiations are held
against on the card) round each product's operands with
``nn.basic.round_tf32`` and multiply in FP32:

- one product at TF32 (the diffusion, an outer Dense layer or conv) is held
  against JAX's FP32 product of operands rounded by
  ``jax.lax.reduce_precision(·, 8, 10)``, on inputs nudged off the ties
  (``cvt.rna`` rounds a tie away from zero, ``reduce_precision`` to even),
  within FP32's summation error over its K terms;
- the drift, two products in sequence, within the first-order bound of its
  rounded products against JAX's FP32 drift;
- kernel 10's plain version at TF32 against JAX's Pallas kernel (interpret
  mode, FP32) with its interpret-mode normals injected: the same accepts
  give states within the FP32 route's 2e-3 (the Hölder-1/2 path under
  step times an ulp apart) plus one evaluation's TF32 rounding of the
  state's scale, 2·2^-11·2 (a state is a dt-weighted sum of evaluations,
  Σ dt = T); NFE in a band of two attempts;
- kernel 12's plain version at (tf32, tf32) and (fp32, tf32) against JAX's
  FP32 sweep kernel on JAX's knots, within one swept step's TF32 rounding:
  a weight gradient is a sum of the steps' contributions and a_u a product
  of I + O(dt) step Jacobians, so each moves by one transposed step's
  rounding, 2·2^-11 per product in sequence (the recompute's 8: four
  stages of the drift's two; the reverse chain's 9: two a stage and the
  weight gradient's).

The routing (``models/neural_sde.py``) is checked on a CPU layer inside
``nn.tiers_of("cuda")``, through the tiers each wrapper and each Dense
layer is called at. Sizes: the MNIST-SDE widths (F = 32, H = 64) at B = 8,
one intra-op thread.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.ops.pallas.fused_sde_solve import (
    persistent_sde_solve as jax_persistent_sde_solve,
)
from localregneuralde_tpu.ops.pallas.fused_sde_sweep import (
    persistent_sde_sweep as jax_persistent_sde_sweep,
)
from localregneuralde_tpu.sde import sdesolve as jax_sdesolve
from localregneuralde_tpu_torch import ops
from localregneuralde_tpu_torch.harness import (
    construct_model,
    construct_time_series,
    define_configuration,
)
from localregneuralde_tpu_torch.models import (
    VPSDE,
    NeuralDSDE,
    TDChain,
    sample_vpsde,
)
from localregneuralde_tpu_torch.nn import Chain, Dense, basic
from localregneuralde_tpu_torch.nn.basic import (
    SCOPE,
    product_tier,
    round_tf32,
    tiers_of,
)
from localregneuralde_tpu_torch.ops.cuda import (
    SDEWeights,
    persistent_sde_solve,
    persistent_sde_solve_plain,
    persistent_sde_sweep,
    persistent_sde_sweep_plain,
)
from localregneuralde_tpu_torch.ops.cuda.fused_mlp_bwd import step_bwd_tiers
from localregneuralde_tpu_torch.ops.cuda.fused_sde_solve import (
    diffusion_plain,
    drift_plain,
)
from localregneuralde_tpu_torch.parity import load_jax_params
from tests.test_torch_sde import (
    _jf,
    _jg,
    _params,
    _weights,
    _x,
    pallas_interpret_source,
)

B, F, H = 8, 32, 64
TOL = 0.14                 # experiments/mnist_sde/mlp.yaml
STATE_TOL = 2e-3           # the FP32 route's, tests/test_torch_sde.py
U = 2.0 ** -11             # TF32's unit roundoff
U32 = 2.0 ** -24           # FP32's
EVAL_DEPTH = 2             # the drift's two products in sequence
RECOMPUTE_DEPTH = 8        # four stages of the drift's two
GRAD_DEPTH = 9             # two transposed products a stage, one gradient


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32_tol(depth):
    """Across tiers: 2·2^-11 per product in sequence, of the scale."""
    return 2 * U * depth


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max()) / max(float(np.abs(ref).max()),
                                                  1e-30)


def _off_ties(x):
    """float32 ``x`` with every TF32 tie (the 13 dropped bits exactly
    0x1000) moved one ulp off it."""
    bits = np.asarray(x, np.float32).copy().view(np.uint32)
    bits[(bits & 0x1FFF) == 0x1000] += 1
    return bits.view(np.float32)


def _normal(seed, shape, scale=1.0):
    x = scale * np.random.default_rng(seed).standard_normal(shape)
    return _off_ties(x.astype(np.float32))


def _rp(x):
    return jax.lax.reduce_precision(jnp.asarray(x), 8, 10)


def _within_fp32_sums(ours, ref, a, b, k):
    """``ours`` against JAX's FP32 product ``ref`` of the rounded operands
    ``a`` and ``b`` (K = ``k`` terms, plus a bias): each within twice
    FP32's summation error over the terms' magnitudes (two sum orders)."""
    mag = np.abs(np.asarray(_rp(a), np.float64)) @ np.abs(
        np.asarray(_rp(b), np.float64))
    bound = 2 * (k + 1) * U32 * (mag + 1.0) + 1e-30
    return bool(np.all(np.abs(np.asarray(ours, np.float64)
                              - np.asarray(ref, np.float64)) <= bound))


# ------------------------------------------------------------ one product

def test_diffusion_tf32_matches_jax_on_rounded_operands():
    """The diffusion at TF32, one product: JAX's FP32 product of the
    rounded operands, within FP32's summation error; the tiers differ."""
    ps = _params(1)
    ps["diffusion"]["w"] = _off_ties(ps["diffusion"]["w"])
    w = _weights(ps)
    x = _normal(2, (B, F), 0.5)
    ours = diffusion_plain(w, torch.tensor(x), "tf32").numpy()
    ref = np.asarray(_rp(x) @ _rp(ps["diffusion"]["w"])
                     + ps["diffusion"]["b"])
    assert _within_fp32_sums(ours, ref, x, ps["diffusion"]["w"], F)
    assert _rel(ours, diffusion_plain(w, torch.tensor(x)).numpy()) > 1e-6


def test_drift_tf32_within_tf32_rounding_of_jax():
    """The drift at TF32 against JAX's FP32 drift, element by element
    within the first-order bound of its two rounded products:
    |Δz| ≤ 2u·|x|·|W1| and |Δy| ≤ 2u·|h|·|W2| + |Δz|·|W2| (tanh' ≤ 1)."""
    ps = _params(3)
    w = _weights(ps)
    x = _normal(4, (B, F), 0.5)
    ours = drift_plain(w, torch.tensor(x), "tf32").numpy()
    ref = np.asarray(_jf(jnp.asarray(x), 0.0, ps))
    d = ps["drift"]
    w1 = np.abs(d["layer_0"]["w"]).astype(np.float64)
    w2 = np.abs(d["layer_1"]["w"]).astype(np.float64)
    h = np.abs(np.tanh(x.astype(np.float64) @ d["layer_0"]["w"]
                       + d["layer_0"]["b"]))
    dz = 2 * U * (np.abs(x) @ w1)
    bound = 2 * U * (h @ w2) + dz @ w2
    assert np.all(np.abs(ours - ref) <= 1.01 * bound + 1e-6)
    assert _rel(ours, ref) > 1e-6


def test_dynamics_tf32_backward_is_the_rounded_products():
    """Under autograd the drift's and diffusion's transposes at the
    gradient tier: the diffusion's weight gradient at TF32 is the FP32
    product of the rounded operands; at (tf32, fp32) the forward is the
    rounded one and the backward FP32's."""
    g = torch.Generator().manual_seed(5)
    w = SDEWeights(*(torch.randn(s, generator=g) * 0.3 for s in (
        (F, H), (H,), (H, F), (F,), (F, F), (F,))))
    x = torch.randn(B, F, generator=g)
    ct = torch.randn(B, F, generator=g)
    for tier, grad_tier in (("tf32", "tf32"), ("tf32", "fp32"),
                            ("fp32", "tf32")):
        wd = w.wd.clone().requires_grad_()
        y = diffusion_plain(w._replace(wd=wd), x, tier, grad_tier)
        y.backward(ct)
        ref = (round_tf32(x).double().T @ round_tf32(ct).double()
               if grad_tier == "tf32" else x.double().T @ ct.double())
        assert float((wd.grad.double() - ref).abs().max()) <= (
            2 * B * U32 * float(ref.abs().max()))
        fwd = (round_tf32(x) @ round_tf32(w.wd) if tier == "tf32"
               else x @ w.wd) + w.bd
        assert torch.equal(y.detach(), fwd)


# ------------------------------------------------------------ kernel 10

def test_k10_tf32_plain_against_jax_pallas():
    """Kernel 10's plain version at TF32 against the JAX Pallas kernel in
    interpret mode (FP32), with the kernel's interpret-mode noise
    injected: NFE within two attempts, states within the FP32 route's
    2e-3 plus one evaluation's TF32 rounding of their scale; and the FP32
    plain version on the same path closer to JAX than the TF32 one."""
    ps = _params(2)
    w = _weights(ps)
    x = _x(3)
    nk = jax.random.PRNGKey(7)
    saveat = np.asarray([0.5, 1.0], np.float32)
    kw = dict(rtol=TOL, atol=TOL, solver="sosri", delta=1 / 6, max_steps=48,
              record_knots=True)
    ref = jax_persistent_sde_solve(ps, jnp.asarray(x), (0.0, 1.0),
                                   noise_key=nk, saveat_arr=jnp.asarray(saveat),
                                   **kw)
    outs = {tier: persistent_sde_solve_plain(
        w, torch.tensor(x), (0.0, 1.0), noise=pallas_interpret_source(nk),
        saveat_arr=torch.tensor(saveat), tier=tier, **kw)
        for tier in ("fp32", "tf32")}
    ours = outs["tf32"]
    assert bool(ours["success"])
    assert abs(1 + 4 * int(ours["natt"]) - int(ref["nfe_drift"])) <= 8
    scale = float(np.abs(np.asarray(ref["ys"])).max())
    tol = STATE_TOL + tf32_tol(EVAL_DEPTH) * scale
    for k in ("ys", "y_final"):
        err = float(np.abs(ours[k].numpy() - np.asarray(ref[k])).max())
        assert err <= tol, (k, err, tol)
    # the tiers do differ on the same path
    assert not torch.equal(outs["fp32"]["ys"], ours["ys"])


def test_k10_wrapper_resolves_its_precision_on_the_cpu():
    """``persistent_sde_solve`` on a CPU tensor runs the plain version at
    ``product_tier(precision, cpu)``: FP32 at every precision outside
    ``tiers_of("cuda")`` (bitwise the default), TF32 for the default tier
    inside it, bitwise the plain version at TF32; no launch counted."""
    ps = _params(4)
    w = _weights(ps)
    xt = torch.tensor(_x(5))
    kw = dict(noise=pallas_interpret_source(jax.random.PRNGKey(1)), rtol=TOL,
              atol=TOL, solver="sosri", delta=1 / 6,
              saveat_arr=torch.tensor([1.0]), max_steps=24)
    fp = persistent_sde_solve(w, xt, (0.0, 1.0), **kw)
    assert torch.equal(persistent_sde_solve(w, xt, (0.0, 1.0), precision=None,
                                            **kw)["ys"], fp["ys"])
    with tiers_of("cuda"):
        card = persistent_sde_solve(w, xt, (0.0, 1.0), precision=None, **kw)
        high = persistent_sde_solve(w, xt, (0.0, 1.0), **kw)
    tf = persistent_sde_solve_plain(w, xt, (0.0, 1.0), tier="tf32", **kw)
    assert torch.equal(card["ys"], tf["ys"])
    assert torch.equal(high["ys"], fp["ys"])
    assert not torch.equal(card["ys"], fp["ys"])
    assert ops.cuda.tier_launch_counts()["persistent_sde_solve"] == {}


# ------------------------------------------------------------ kernel 12

def _jax_knots(ps, x, saveat):
    return jax_sdesolve(_jf, _jg, jnp.asarray(x), (0.0, 1.0), ps,
                        noise_key=jax.random.PRNGKey(12), rtol=TOL, atol=TOL,
                        solver="sosri", saveat=jnp.asarray(saveat),
                        max_steps=64, adjoint="none", record_knots=True)


@pytest.mark.parametrize("tiers,depth", [
    (("tf32", "tf32"), RECOMPUTE_DEPTH + GRAD_DEPTH),
    (("fp32", "tf32"), GRAD_DEPTH),
], ids=["tf32/tf32", "fp32/tf32"])
def test_k12_tf32_plain_against_jax_sweep(tiers, depth):
    """Kernel 12's plain version at the model's two pairs of tiers (TF32
    throughout: mnist_sde's 'auto'; FP32 recompute with TF32 gradient
    products: 'highest') against the JAX sweep kernel (interpret mode,
    FP32) on JAX's knots: a_u and each weight gradient within one swept
    step's TF32 rounding of its scale, ``tf32_tol(depth)``; the wrapper
    on the CPU inside ``tiers_of("cuda")`` bitwise the plain version."""
    ps = _params(4)
    w = _weights(ps)
    saveat = np.asarray([0.4, 1.0], np.float32)
    sol = _jax_knots(ps, _x(5), saveat)
    n = int(sol.naccept)
    assert n >= 3
    rng = np.random.default_rng(6)
    ct_ys = rng.standard_normal((2, B, F)).astype(np.float32)
    ct_y = rng.standard_normal((B, F)).astype(np.float32)
    knots = [np.asarray(k) for k in (sol.knot_ts, sol.knot_us, sol.knot_dws,
                                     sol.knot_dzs)]
    ref_au, ref_dp = jax_persistent_sde_sweep(
        ps, *[jnp.asarray(k) for k in knots], jnp.int32(n),
        jnp.asarray(saveat), jnp.asarray(ct_ys), jnp.asarray(ct_y),
        solver="sosri", delta=1 / 6)
    ref_w = _weights(jax.tree_util.tree_map(np.asarray, ref_dp))
    args = ([torch.tensor(k) for k in knots]
            + [torch.tensor(n), torch.tensor(saveat), torch.tensor(ct_ys),
               torch.tensor(ct_y)])
    au, dw = persistent_sde_sweep_plain(w, *args, solver="sosri", delta=1 / 6,
                                        tier=tiers[0], grad_tier=tiers[1])
    assert _rel(au, ref_au) <= tf32_tol(depth)
    for ours, ref in zip(dw, ref_w):
        assert _rel(ours, ref) <= tf32_tol(depth)
    assert _rel(au, ref_au) > 1e-6  # the tiers do differ
    prec = None if tiers[0] == "tf32" else "highest"
    with tiers_of("cuda"):
        wau, wdw = persistent_sde_sweep(w, *args, solver="sosri", delta=1 / 6,
                                        precision=prec, grad_precision=None)
    assert torch.equal(wau, au)
    assert all(torch.equal(a, b) for a, b in zip(wdw, dw))


# ------------------------------------------------------------ the routing

ROUTE_KW = dict(rtol=TOL, atol=TOL, max_steps=64)


class _Recorder:
    """Wraps kernel 10's and 12's wrappers and ``nn.basic.layer_tier``, and
    records the tiers each is called at (resolved where it is called): the
    wrappers', and the drift's and diffusion's Dense layers'."""

    def __init__(self, monkeypatch):
        self.k10, self.k12, self.dense = [], [], []
        k10, k12 = ops.cuda.persistent_sde_solve, ops.cuda.persistent_sde_sweep
        layer_tier = basic.layer_tier

        def rec10(*a, precision="highest", **kw):
            self.k10.append(product_tier(precision, a[1].device))
            return k10(*a, precision=precision, **kw)

        def rec12(*a, precision="highest", grad_precision="match", **kw):
            self.k12.append("/".join(step_bwd_tiers(precision, grad_precision,
                                                    a[-1].device)))
            return k12(*a, precision=precision, grad_precision=grad_precision,
                       **kw)

        def rec_tier(precision, x):
            tier = layer_tier(precision, x)
            self.dense.append(tier)
            return tier

        monkeypatch.setattr(ops.cuda, "persistent_sde_solve", rec10)
        monkeypatch.setattr(ops.cuda, "persistent_sde_sweep", rec12)
        monkeypatch.setattr(basic, "layer_tier", rec_tier)

    def clear(self):
        self.k10.clear(), self.k12.clear(), self.dense.clear()


def _layer(**kw):
    g = torch.Generator().manual_seed(0)
    drift = Chain(Dense(F, H, "tanh", generator=g), Dense(H, F, generator=g))
    noise_dims = kw.get("noise_dims")
    diffusion = Dense(F, F * (noise_dims or 1), generator=g)
    return NeuralDSDE(drift, diffusion, **{**ROUTE_KW, **kw})


def _drive(layer, training, scope):
    x = torch.tensor(_x(8))
    with scope:
        sol, st = layer(x, layer.init_state(), training=training)
        if training:
            ((sol.ys[-1] ** 2).sum() + st["reg_val"]).backward()
    return sol, st


@pytest.mark.parametrize("route", [
    # (NeuralDSDE options, training, K10's tier, K12's tiers, the modules')
    (dict(use_pallas="on"), False, "tf32", None, None),
    (dict(use_pallas="on"), True, "tf32", "tf32/tf32", "tf32"),
    (dict(use_pallas="on", precision="highest"), True, "fp32", "fp32/tf32",
     "fp32"),
    (dict(use_pallas="off"), True, None, None, "tf32"),
    (dict(use_pallas="off", precision="highest"), True, None, None, "fp32"),
    (dict(use_pallas="on", adjoint="direct"), True, None, None, "tf32"),
    (dict(solver="milstein", noise_dims=3, regularize="biased"), True, None,
     None, "tf32"),
    (dict(solver="euler_heun"), True, None, None, "tf32"),
], ids=["eval auto", "stored auto", "stored highest", "plain auto",
        "plain highest", "direct auto", "matrix milstein", "euler heun"])
def test_sde_routes_take_the_reference_tiers(route, monkeypatch):
    """A NeuralDSDE on the CPU inside ``tiers_of("cuda")`` (rtol 0.14:
    'auto' is the default tier) calls kernel 10 at ``mm_precision``'s
    tier, kernel 12 recomputing at it with its gradient products at TF32
    always, and the drift's and diffusion's Dense layers (the eager loops,
    the direct adjoint, the plain stored adjoint's step VJP, the
    regulariser's step and its dt probe) at ``mm_precision``'s tier; every
    tier FP32 outside the scope."""
    kw, training, t10, t12, tdense = route
    rec = _Recorder(monkeypatch)
    _, st = _drive(_layer(**kw), training, tiers_of("cuda"))
    assert bool(st["success"])
    assert set(rec.k10) == ({t10} if t10 else set())
    assert set(rec.k12) == ({t12} if t12 else set())
    assert set(rec.dense) == ({tdense} if tdense else set())
    rec.clear()
    _drive(_layer(**kw), training, contextlib.nullcontext())
    assert set(rec.k10 + rec.dense) <= {"fp32"}
    assert set(rec.k12) <= {"fp32/fp32"}


def test_sde_plain_route_gradients_at_the_forward_tier():
    """The plain route's gradients through the stored adjoint inside
    ``tiers_of("cuda")``: the modules' transposes at the forward's tier,
    within one swept step's TF32 rounding of the FP32 route's gradients
    on the same Brownian path, and apart from them."""
    grads = {}
    for name, scope in (("fp32", contextlib.nullcontext()),
                        ("tf32", tiers_of("cuda"))):
        layer = _layer(use_pallas="off", regularize="none")
        _drive(layer, True, scope)
        grads[name] = [p.grad for p in layer.parameters()]
    rel = max(_rel(a, b) for a, b in zip(grads["tf32"], grads["fp32"]))
    assert 1e-6 < rel <= tf32_tol(RECOMPUTE_DEPTH + GRAD_DEPTH)


def test_sde_tf32_forward_refuses_tight_tolerances():
    """An SDE forward at the TF32 tier below rtol 1e-4 raises (the
    reference saturates max_steps there): on the card's tiers with
    precision 'default', not with 'auto' (FP32 below 1e-4); the kernel's
    plain version at TF32 too; on the CPU's tiers the same layer runs."""
    layer = _layer(rtol=1e-5, atol=1e-5, precision="default",
                   regularize="none", max_steps=256)
    assert layer.forward_tier(torch.device("cuda")) == "tf32"
    assert layer.forward_tier("cpu") == "fp32"
    with pytest.raises(ValueError, match="1e-4"):
        _drive(layer, False, tiers_of("cuda"))
    auto = _layer(rtol=1e-5, atol=1e-5, regularize="none")
    assert auto.forward_tier(torch.device("cuda")) == "fp32"
    with pytest.raises(ValueError, match="1e-4"):
        persistent_sde_solve_plain(
            _weights(_params()), torch.tensor(_x()), (0.0, 1.0),
            noise=pallas_interpret_source(jax.random.PRNGKey(0)), rtol=1e-5,
            atol=1e-5, solver="sosri", delta=1 / 6,
            saveat_arr=torch.tensor([1.0]), max_steps=4, tier="tf32")
    sol, _ = _drive(layer, False, contextlib.nullcontext())
    assert bool(torch.isfinite(sol.ys).all())


# ---------------------------------------- the layers outside the DE layers

def _outer_layers(model):
    """The outer layers of a classifier: (name, layer) of every Dense and
    Conv outside its NeuralODE or NeuralDSDE."""
    out = []
    for name, m in model.named_modules():
        if ".neural_" in f".{name}" or not name:
            continue
        if isinstance(m, (basic.Dense, basic.Conv)):
            out.append((name, m))
    return out


CLASSIFIERS = {
    "mnist_ode": ("experiments/mnist_ode/mlp.yaml",
                  ["classifier"]),
    "mnist_sde": ("experiments/mnist_sde/mlp.yaml",
                  ["downsample", "classifier"]),
    "cifar10": ("experiments/cifar10/cnn.yaml",
                ["augment.augment", "classifier.layer_0",
                 "classifier.layer_2"]),
}


@pytest.mark.parametrize("family", list(CLASSIFIERS))
def test_outer_layers_at_the_backend_default(family):
    """The layers outside the DE layers take the reference's
    ``precision=None``: TF32 inside ``tiers_of("cuda")``, JAX's FP32
    product (or conv) of the rounded operands within FP32's summation
    error; bitwise the FP32 layer outside it. The DE layers' dynamics keep
    following their solver's scope."""
    config, names = CLASSIFIERS[family]
    model = construct_model(define_configuration([], config), device="cpu")
    outer = _outer_layers(model)
    assert [n for n, _ in outer] == names
    assert all(m.precision is None for _, m in outer)
    inner = [m for n, m in model.named_modules()
             if n.startswith("neural_") and isinstance(m, (basic.Dense,
                                                           basic.Conv))]
    assert inner and all(m.precision == SCOPE for m in inner)
    for i, (name, layer) in enumerate(outer):
        w = layer.w.detach().numpy()
        if isinstance(layer, basic.Dense):
            x = _normal(10 + i, (4, layer.in_dim))
            conv, k = (lambda a, b: a @ b), layer.in_dim
        else:
            x = _normal(10 + i, (2, 8, 8, layer.in_channels))
            k = 9 * layer.in_channels

            def conv(a, b):
                return jax.lax.conv_general_dilated(
                    a, b, (1, 1), "SAME",
                    dimension_numbers=("NHWC", "HWIO", "NHWC"))
        ref = np.asarray(conv(_rp(x), _rp(w))) + layer.b.detach().numpy()
        mag = np.asarray(conv(jnp.abs(_rp(x)), jnp.abs(_rp(w))), np.float64)
        xt = torch.tensor(x)
        with torch.no_grad(), tiers_of("cuda"):
            card, _ = layer(xt, layer.init_state())
        with torch.no_grad():
            cpu, _ = layer(xt, layer.init_state())
        # the activation (the classifier conv's gelu) is 1.13-Lipschitz
        bound = 1.13 * 2 * (k + 1) * U32 * (mag + 1.0)
        want = layer.activation(torch.tensor(ref)).numpy()
        assert np.all(np.abs(card.numpy() - want) <= bound), name
        assert not torch.equal(card, cpu), name
        with torch.no_grad():
            z = (xt @ layer.w if isinstance(layer, basic.Dense)
                 else basic.conv2d_nhwc(xt, layer.w)) + layer.b
        assert torch.equal(cpu, layer.activation(z)), name


def test_mnist_sde_model_moves_at_the_card_tiers():
    """The MNIST-SDE model (narrow input) inside ``tiers_of("cuda")``:
    the downsample, the dynamics (kernel 10's plain version) and the
    classifier at TF32, logits within one evaluation's TF32 rounding of
    the FP32 model's per layer in sequence (downsample, the SDE's drift,
    classifier) on the same Brownian path, and apart from them."""
    cfg = define_configuration(["--model.image_size=[4,4]"],
                               "experiments/mnist_sde/mlp.yaml")
    model = construct_model(cfg, device="cpu")
    x = torch.tensor(_normal(20, (B, 4, 4, 1)))
    outs = {}
    for name, scope in (("fp32", contextlib.nullcontext()),
                        ("tf32", tiers_of("cuda"))):
        with torch.no_grad(), scope:
            y, st = model(x, model.init_state(), training=False)
        outs[name] = y
        assert bool(st["neural_dsde"]["success"])
    rel = _rel(outs["tf32"], outs["fp32"])
    assert 1e-7 < rel <= tf32_tol(EVAL_DEPTH + 2)


# ------------------------ the latent model and the score samplers' tiers

def test_latent_model_bitwise_at_the_card_tiers():
    """The latent ODE's layers take the reference's tiers (the chain
    family's slice): inside ``tiers_of("cuda")`` the GRU encoder,
    ``rec_to_gen`` and ``gen_to_data`` compute at TF32 and the chain
    dynamics at 'auto''s tier (TF32 at rtol 1e-3), so the eval output moves
    off the FP32 one, within one evaluation's TF32 rounding per layer in
    sequence (the encoder gate's two, rec_to_gen's two, the chain's two,
    gen_to_data's one); outside the scope it is bitwise the FP32 model's
    on every call."""
    small = ["--model.ts_in_dims=3", "--model.ts_hidden_dims=6",
             "--model.ts_latent_dims=4", "--model.ts_node_dims=4",
             "--model.solver.reltol=1e-3", "--model.solver.abstol=1e-3",
             "--model.solver.max_steps=32"]
    cfg = define_configuration(small, "experiments/physionet/physionet.yaml")
    grid = torch.linspace(0.0, 1.0, 5)
    model = construct_time_series(cfg, saveat=grid, device="cpu")
    x = torch.tensor(_normal(30, (4, 5, 7), 0.5))
    outs = []
    for scope in (contextlib.nullcontext(), tiers_of("cuda"),
                  contextlib.nullcontext()):
        with torch.no_grad(), scope:
            y, _ = model(x, model.init_state(), training=False)
        outs.append(y)
    assert torch.equal(outs[0], outs[2])
    assert 1e-7 < _rel(outs[1], outs[0]) <= tf32_tol(7)


def test_score_sampler_bitwise_at_the_card_tiers():
    """The score samplers take the reference's backend default (the score
    family's slice): a reverse-SDE draw through kernel 11's plain version
    inside ``tiers_of("cuda")`` runs the score net at TF32, the same
    Brownian path and steps as the FP32 draw, its samples apart from the
    FP32 ones and within 1e-2 of their scale (the net's TF32 rounding,
    2·2^-11 a layer, grows along the reverse path through the drift's β·s;
    tests/test_torch_score_precision.py holds the TF32 solve to JAX's);
    outside the scope it is bitwise the FP32 draw on every call."""
    g = torch.Generator().manual_seed(3)
    mod = TDChain(Dense(3, 8, "tanh", generator=g), Dense(9, 2, generator=g))
    draws = []
    for scope in (contextlib.nullcontext(), tiers_of("cuda"),
                  contextlib.nullcontext()):
        with torch.no_grad(), scope:
            s, sol = sample_vpsde(None, (8, 2),
                                  torch.Generator().manual_seed(4),
                                  score_module=mod, sde=VPSDE(0.1, 5.0),
                                  rtol=1e-2, atol=1e-2, max_steps=64,
                                  device="cpu")
        draws.append((s, int(sol.naccept)))
    assert torch.equal(draws[0][0], draws[2][0])
    assert draws[1][1] == draws[0][1]
    assert 1e-7 < _rel(draws[1][0], draws[0][0]) <= 1e-2
