"""The conv family's precision tiers (the reference's 'highest' and
'default', which on a card is TF32) against the JAX package.

On the CPU every tier computes FP32, as JAX does there. The TF32 tier's
plain versions (``tier="tf32"``, which kernels 13 and 14's TF32
instantiations are held against on the card) round each conv's operands
with ``nn.basic.round_tf32`` and convolve in FP32:

- one conv at TF32 is held against JAX's FP32 conv of operands rounded by
  ``jax.lax.reduce_precision(·, 8, 10)``, on inputs nudged off the ties
  (``cvt.rna`` rounds a tie away from zero, ``reduce_precision`` to even;
  off the ties both are the one nearest value), to FP32's summation error
  over its K terms, and its backward (and the time channel's) against a
  float64 model of the rounded products;
- the Tsit5 step and its VJP at TF32 are held against JAX's FP32 step and
  its VJP (its XLA twin: the generic Tsit5 step over the JAX dynamics). A
  TF32 product rounds both operands by at most 2^-11 relative, so an output
  that passes through ``depth`` products in sequence moves by at most
  2·2^-11·depth of its scale to first order (``tf32_tol``): a step is six
  evaluations of three convs (depth 18); its VJP adds the reverse chain,
  three data-gradient products an evaluation and the weight gradient's
  (19).

The routing (``models/neural_ode.py``) is checked on a CPU node inside
``nn.tiers_of("cuda")``, through the tiers each wrapper and each plain conv
is called at. Sizes are small (B = 2, 8×8, Cs 8, Ch 16; 6×6 and Ch 8 for
the routes), one intra-op thread.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.core import ArrayAndTime as JArrayAndTime
from localregneuralde_tpu.models import TDChain as JTDChain
from localregneuralde_tpu.nn import BatchNorm as JBatchNorm
from localregneuralde_tpu.nn import Chain as JChain
from localregneuralde_tpu.nn import Conv as JConv
from localregneuralde_tpu.ode.step import tsit5_step as jax_tsit5_step
from localregneuralde_tpu_torch import ops
from localregneuralde_tpu_torch.models import NeuralODE, TDChain, common
from localregneuralde_tpu_torch.nn import BatchNorm, Chain, Conv
from localregneuralde_tpu_torch.nn.basic import (
    conv2d_nhwc, conv2d_nhwc_td, product_tier, round_tf32, tiers_of,
)
from localregneuralde_tpu_torch.ops.cuda import (
    ConvWeights, conv_step_plain, fused_conv_step, fused_conv_step_bwd,
    fused_conv_step_bwd_plain, match_conv_family,
)
from localregneuralde_tpu_torch.ops.cuda import fused_conv_bwd, serving
from localregneuralde_tpu_torch.ops.cuda.fused_mlp_bwd import step_bwd_tiers
from localregneuralde_tpu_torch.parity import load_jax_params, state_from_jax

B, H, W, Cs, Ch = 2, 8, 8, 8, 16
U = 2.0 ** -11        # TF32's unit roundoff
U32 = 2.0 ** -24      # FP32's
STEP_DEPTH = 18       # six evaluations of three convs in sequence
VJP_DEPTH = 19        # the reverse chain's data gradients and a weight gradient


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
    tie = (bits & 0x1FFF) == 0x1000
    bits[tie] += 1
    return bits.view(np.float32)


def _normal(seed, shape, scale=1.0):
    x = scale * np.random.default_rng(seed).standard_normal(shape)
    return _off_ties(x.astype(np.float32))


def _nchw_conv64(x, w):
    """A SAME conv in float64 of NHWC ``x`` and HWIO ``w`` (the model of
    the rounded products: each is exact in float64)."""
    y = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2),
                                   w.double().permute(3, 2, 0, 1),
                                   padding="same")
    return y.permute(0, 2, 3, 1)


# ------------------------------------------------------------- one conv

@pytest.mark.parametrize("cin,cout", [(3, 5), (Ch + 1, Ch)])
def test_conv_tf32_matches_jax_on_rounded_operands(cin, cout):
    """``conv2d_nhwc`` at TF32 is JAX's FP32 conv of the reduce_precision-
    rounded operands (the same values off the ties), to FP32's summation
    error over K = 9·cin terms of each output, both sides."""
    x = _normal(1, (B, H, W, cin))
    w = _normal(2, (3, 3, cin, cout), 0.3)
    ours = conv2d_nhwc(torch.tensor(x), torch.tensor(w), "tf32").numpy()
    rx, rw = (jax.lax.reduce_precision(jnp.asarray(a), 8, 10) for a in (x, w))
    np.testing.assert_array_equal(
        np.asarray(rx), round_tf32(torch.tensor(x)).numpy())
    ref = np.asarray(jax.lax.conv_general_dilated(
        rx, rw, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision="highest"))
    mag = _nchw_conv64(torch.tensor(np.abs(np.asarray(rx))),
                       torch.tensor(np.abs(np.asarray(rw)))).numpy()
    bound = 2 * 9 * cin * U32 * mag
    assert np.all(np.abs(ours.astype(np.float64) - ref) <= bound + 1e-30)
    # the tiers do differ
    fp = conv2d_nhwc(torch.tensor(x), torch.tensor(w)).numpy()
    assert _rel(ours, fp) > 1e-5


def _within_rounded(ours, model, mag, k):
    """|ours − model| ≤ K·2^-24·mag elementwise (FP32's summation error
    over K terms of the exact rounded products)."""
    err = np.abs(ours.detach().double().numpy() - model.numpy())
    return bool(np.all(err <= k * U32 * mag.numpy() + 1e-30))


@pytest.mark.parametrize("grad_tier", ["tf32", "fp32"])
def test_conv_tf32_backward_is_the_rounded_products(grad_tier):
    """``conv2d_nhwc_td`` at a TF32 forward and either gradient tier:
    forward conv(round x, round W) + t·Σ round(w_t taps); backward at the
    gradient tier: the data and weight gradients of the rounded cotangent
    and operands, and the time channel's t·Σ of the rounded cotangent over
    the pixels each tap reaches (the reference rounds dy before that sum),
    each against a float64 model."""
    c = Ch
    t = torch.tensor(0.37)
    tv = float(t)
    x = torch.tensor(_normal(3, (B, H, W, c)), requires_grad=True)
    w = torch.tensor(_normal(4, (3, 3, c + 1, Cs), 0.2), requires_grad=True)
    ct = torch.tensor(_normal(5, (B, H, W, Cs)))
    y = conv2d_nhwc_td(x, w, t, "tf32", grad_tier)
    y.backward(ct)
    r = round_tf32
    rx, rw = r(x.detach()), r(w.detach())
    ones = torch.ones(1, H, W, 1)
    tmap = _nchw_conv64(ones, rw[:, :, c:])
    model = _nchw_conv64(rx, rw[:, :, :c]) + tv * tmap
    mag = _nchw_conv64(rx.abs(), rw[:, :, :c].abs()) + _nchw_conv64(
        ones, rw[:, :, c:].abs())
    assert _within_rounded(y, model, mag, 9 * (c + 1) + 1)
    g = r(ct) if grad_tier == "tf32" else ct
    xg = rx if grad_tier == "tf32" else x.detach()
    wg = rw if grad_tier == "tf32" else w.detach()
    # data gradient: the transposed conv over the flipped taps
    wt = wg[:, :, :c].flip(0, 1).transpose(2, 3)
    assert _within_rounded(x.grad, _nchw_conv64(g, wt),
                           _nchw_conv64(g.abs(), wt.abs()), 9 * Cs)
    # weight gradient: Σ_p x[p + d_tap] g[p], the time channel's x = t
    x1 = torch.cat([xg, torch.full((B, H, W, 1), tv)], dim=-1).double()
    xp = torch.nn.functional.pad(x1, (0, 0, 1, 1, 1, 1))
    gw = torch.zeros(3, 3, c + 1, Cs, dtype=torch.float64)
    mw = torch.zeros_like(gw)
    for i in range(3):
        for j in range(3):
            win = xp[:, i:i + H, j:j + W]
            gw[i, j] = torch.einsum("bhwc,bhwo->co", win, g.double())
            mw[i, j] = torch.einsum("bhwc,bhwo->co", win.abs(),
                                    g.double().abs())
    assert _within_rounded(w.grad, gw, mw, B * H * W + 1)
    if grad_tier == "tf32":  # the tiers do differ
        xs = x.detach().requires_grad_()
        conv2d_nhwc_td(xs, w.detach(), t).backward(ct)
        assert float((x.grad - xs.grad).abs().max()) > 0


# ------------------------------------------------- the step and its VJP

def _jax_dynamics(eval_stats):
    return JTDChain(
        JChain(JConv((3, 3), Cs + 1, Ch, use_bias=False),
               JBatchNorm(Ch, "gelu", eval_stats=eval_stats)),
        JChain(JConv((3, 3), Ch + 1, Ch, use_bias=False),
               JBatchNorm(Ch, "gelu", eval_stats=eval_stats)),
        JConv((3, 3), Ch + 1, Cs, use_bias=False))


def _dynamics(eval_stats="running", cs=Cs, ch=Ch):
    return TDChain(
        Chain(Conv((3, 3), cs + 1, ch, use_bias=False),
              BatchNorm(ch, "gelu", eval_stats=eval_stats)),
        Chain(Conv((3, 3), ch + 1, ch, use_bias=False),
              BatchNorm(ch, "gelu", eval_stats=eval_stats)),
        Conv((3, 3), ch + 1, cs, use_bias=False))


def _pair(seed, eval_stats="running"):
    """The JAX dynamics and the port's with the same parameters and a
    non-trivial BatchNorm state."""
    jtd = _jax_dynamics(eval_stats)
    ps, st = jtd.init(jax.random.PRNGKey(seed))
    st = jax.tree_util.tree_map(lambda a: a + 0.1 * jnp.tanh(a + 1.0), st)
    td = _dynamics(eval_stats)
    load_jax_params(td, ps)
    return jtd, ps, st, td, state_from_jax(td.init_state(), st)


def _bn_stats(state):
    return [state[layer]["layer_1"][k] for layer in ("layer_0", "layer_1")
            for k in ("mean", "var")]


def _jax_step_fn(jtd, training):
    def f(x, s, p, stt):
        y, st2 = jtd(p, stt, JArrayAndTime(x, s), training=training)
        return y.array, st2
    return f


@pytest.mark.parametrize("mode", ["train", "running", "batch"])
def test_conv_step_tf32_plain_within_tf32_rounding_of_jax(mode):
    """Kernel 13's TF32 plain version (what it runs on CPU tensors at the
    TF32 tier) against JAX's FP32 step: u_new, k2..k7, g6 and, in training,
    the running stats after the EMA chain, each within one step's TF32
    rounding (depth 18); ũ cancels, so it is held to dt·max|Δk| (Σ|b̃_i| <
    1), not to its own scale."""
    es = "batch" if mode == "batch" else "running"
    training = mode == "train"
    jtd, ps, st, td, tst = _pair(seed=2, eval_stats=es)
    u = _normal(20, (B, H, W, Cs), 0.5)
    k1 = _normal(21, (B, H, W, Cs), 0.5)
    t, dt = 0.2, 0.07
    ref = jax_tsit5_step(_jax_step_fn(jtd, training), jnp.asarray(u),
                         jnp.float32(t), jnp.float32(dt), jnp.asarray(k1), ps,
                         st)
    spec = match_conv_family(td)
    w = ConvWeights(*(p.detach() for p in td.parameters()))
    args = (w, spec, torch.tensor(u), torch.tensor(t), torch.tensor(dt),
            torch.tensor(k1))
    kw = dict(training=training, rstats=_bn_stats(tst))
    ours = conv_step_plain(*args, **kw, tier="tf32")
    fp = conv_step_plain(*args, **kw)
    # on the CPU the wrapper's default and 'default' are FP32
    assert all(torch.equal(a, b) for a, b in zip(
        fused_conv_step(*args, **kw, precision=None)[:9], fp[:9]))
    u_new, utilde, *ks, g6, stats = ours
    tol = tf32_tol(STEP_DEPTH)
    assert _rel(u_new.numpy(), ref.u_new) <= tol
    assert _rel(g6.numpy(), ref.g6) <= tol
    dk = 0.0
    for a, b in zip(ks, ref.ks[1:]):
        assert _rel(a.numpy(), b) <= tol
        dk = max(dk, float(np.abs(a.numpy() - np.asarray(b)).max()))
    assert float(np.abs(utilde.numpy() - np.asarray(ref.utilde)).max()) <= (
        dt * dk)
    if training:
        for a, b in zip(stats, _bn_stats(ref.f_state)):
            assert _rel(a.numpy(), b) <= tol
    else:
        assert stats is None
    assert _rel(u_new.numpy(), fp[0].numpy()) > 1e-7  # the tiers differ


@pytest.mark.parametrize("tiers,depth", [(("tf32", "tf32"),
                                          STEP_DEPTH + VJP_DEPTH),
                                         (("fp32", "tf32"), VJP_DEPTH)])
def test_conv_step_bwd_tf32_plain_within_tf32_rounding_of_jax(tiers, depth):
    """Kernel 14's plain version at both of its routes' tiers (TF32
    throughout, ``cnn.yaml``'s; FP32 recompute with TF32 gradients,
    'highest''s) against the VJP of JAX's FP32 training step: d_u, d_k1 and
    the seven parameter gradients, each within the TF32 rounding of the
    products it passes."""
    jtd, ps, st, td, _ = _pair(seed=4)
    u = _normal(30, (B, H, W, Cs), 0.5)
    k1 = _normal(31, (B, H, W, Cs), 0.5)
    cts = [_normal(40 + i, (B, H, W, Cs)) for i in range(9)]
    t, dt = 0.1, 0.08
    f = _jax_step_fn(jtd, True)

    def outs(p, u_, k1_):
        r = jax_tsit5_step(f, u_, jnp.float32(t), jnp.float32(dt), k1_, p, st)
        return (r.u_new, r.utilde, *r.ks[1:], r.g6)

    _, vjp = jax.vjp(outs, ps, jnp.asarray(u), jnp.asarray(k1))
    d_p, d_u, d_k1 = vjp(tuple(jnp.asarray(c) for c in cts))
    ref = [d_u, d_k1, d_p["layer_0"]["layer_0"]["w"],
           d_p["layer_0"]["layer_1"]["scale"], d_p["layer_0"]["layer_1"]["bias"],
           d_p["layer_1"]["layer_0"]["w"], d_p["layer_1"]["layer_1"]["scale"],
           d_p["layer_1"]["layer_1"]["bias"], d_p["layer_2"]["w"]]
    w = ConvWeights(*td.parameters())
    args = (w, match_conv_family(td), torch.tensor(u), torch.tensor(t),
            torch.tensor(dt), torch.tensor(k1), [torch.tensor(c) for c in cts])
    d_w, ou, ok1 = fused_conv_step_bwd_plain(*args, *tiers)
    for a, b in zip([ou, ok1, *d_w], ref):
        assert _rel(a.numpy(), b) <= tf32_tol(depth), tiers
    fp = fused_conv_step_bwd_plain(*args)
    assert _rel(ou.numpy(), fp[1].numpy()) > 1e-7  # the tiers differ
    # on the CPU the wrapper's default-tier gradients are FP32
    d_w2, ou2, _ = fused_conv_step_bwd(*args, precision=None,
                                       grad_precision=None)
    assert torch.equal(ou2, fp[1])


# --------------------------------------------------------------- routing

ROUTE_KW = dict(rtol=1e-2, atol=1e-2, max_steps=16, regularize="unbiased")
RB, RHW, RCs, RCh = 2, 6, 4, 8


class _Recorder:
    """Wraps the conv family's wrappers and the plain module's convs and
    records the tiers each is called at (resolved where it is called). The
    eval route's solve is the operator ``lrnde::conv_solve``, whose loop
    (``ops/cuda/serving.py``) calls kernel 13's wrapper with the resolved
    tier and the plain dynamics (the module's computation) for k1 and the
    dt probe: both are wrapped where that loop looks them up."""

    def __init__(self, monkeypatch):
        self.k13, self.k14, self.convs = [], [], []
        k13, k14 = ops.cuda.fused_conv_step, ops.cuda.fused_conv_step_bwd
        td = common.conv2d_nhwc_td
        dynamics = serving.conv_dynamics_plain

        def rec13(w, spec, u, t, dt, k1, *, training, rstats=None,
                  precision="highest", tier=None):
            self.k13.append(tier or product_tier(precision, u.device))
            return k13(w, spec, u, t, dt, k1, training=training,
                       rstats=rstats, precision=precision, tier=tier)

        def rec_dynamics(w, spec, x, s, norm=None, tier="fp32",
                         grad_tier=None):
            self.convs.append(tier)
            return dynamics(w, spec, x, s, norm, tier, grad_tier)

        def rec14(w, spec, u, t, dt, k1, cts, precision="highest",
                  grad_precision="match"):
            self.k14.append("/".join(step_bwd_tiers(precision, grad_precision,
                                                    u.device)))
            return k14(w, spec, u, t, dt, k1, cts, precision, grad_precision)

        def rec_td(x, w, t, tier="fp32", grad_tier=None):
            self.convs.append(tier)
            return td(x, w, t, tier, grad_tier)

        for mod in (ops.cuda, fused_conv_bwd):
            monkeypatch.setattr(mod, "fused_conv_step", rec13)
            monkeypatch.setattr(mod, "fused_conv_step_bwd", rec14)
        monkeypatch.setattr(serving, "fused_conv_step", rec13)
        monkeypatch.setattr(serving, "conv_dynamics_plain", rec_dynamics)
        monkeypatch.setattr(common, "conv2d_nhwc_td", rec_td)


def _route_node(**kw):
    torch.manual_seed(0)
    return NeuralODE(_dynamics(cs=RCs, ch=RCh), **{**ROUTE_KW, **kw})


def _drive(node, training, scope):
    x = 0.5 * torch.randn(RB, RHW, RHW, RCs,
                          generator=torch.Generator().manual_seed(1))
    with scope:
        sol, st = node(x, node.init_state(), training=training)
        if training:
            ((sol.ys[-1] ** 2).sum() + st["reg_val"]).backward()
    return sol, st


@pytest.mark.parametrize("route", [
    # (NeuralODE options, training, K13's tier, K14's tiers, the plain convs')
    (dict(use_pallas="on"), False, "tf32", None, "tf32"),
    (dict(use_pallas="on"), True, "tf32", {"tf32/tf32"}, "tf32"),
    (dict(use_pallas="on", precision="highest"), True, "fp32",
     {"fp32/tf32"}, "fp32"),
    (dict(use_pallas="on", precision="highest", grad_precision="default"),
     True, "fp32", {"tf32/tf32", "fp32/tf32"}, "fp32"),
    (dict(use_pallas="on", adjoint="direct"), True, "tf32", {"tf32/tf32"},
     "tf32"),
    (dict(use_pallas="on", adjoint="direct", precision="highest"), True,
     "fp32", {"fp32/tf32"}, "fp32"),
    (dict(use_pallas="off"), True, None, None, "tf32"),
    (dict(use_pallas="off", precision="highest"), True, None, None, "fp32"),
], ids=["eval auto", "stored auto", "stored highest",
        "stored highest grad default", "direct auto", "direct highest",
        "plain auto", "plain highest"])
def test_conv_routes_take_the_reference_tiers(route, monkeypatch):
    """A conv NeuralODE on the CPU inside ``tiers_of("cuda")`` (rtol 1e-2:
    'auto' is the default tier) calls kernel 13 at ``mm_precision``'s tier,
    kernel 14 recomputing at the forward's tier (the regulariser's and the
    direct adjoint's fused step) or at ``bwd_precision``'s (the stored
    adjoint's step VJP) with its gradient products at TF32 always, and the
    plain module's convs (k1, the dt probe, the FSAL closure, the whole
    plain route) at ``mm_precision``'s tier; every tier FP32 outside the
    scope."""
    kw, training, t13, t14, tconv = route
    rec = _Recorder(monkeypatch)
    node = _route_node(**kw)
    _, st = _drive(node, training, tiers_of("cuda"))
    assert bool(st["success"])
    assert set(rec.k13) == ({t13} if t13 else set())
    assert set(rec.k14) == (t14 or set())
    assert rec.convs and set(rec.convs) == {tconv}
    if kw.get("grad_precision") == "default":
        # the stored adjoint's recompute at bwd_precision (default), the
        # regulariser's fused step at the forward's
        assert rec.k14.count("fp32/tf32") == 1 and len(rec.k14) > 1
    rec.k13.clear(), rec.k14.clear(), rec.convs.clear()
    _drive(_route_node(**kw), training, contextlib.nullcontext())
    assert set(rec.k13 + rec.convs) <= {"fp32"}
    assert set(rec.k14) <= {"fp32/fp32"}


def test_conv_tf32_forward_refuses_tight_tolerances():
    """A conv forward at the TF32 tier below rtol 1e-4 raises (the
    reference saturates max_steps there): on the card's tiers with
    precision 'default', and not with 'auto' (FP32 below 1e-4); on the CPU's
    tiers the same layer solves."""
    node = _route_node(rtol=1e-5, atol=1e-5, precision="default",
                       regularize="none", max_steps=256)
    assert node.forward_tier(torch.device("cuda")) == "tf32"
    assert node.forward_tier("cpu") == "fp32"
    with pytest.raises(ValueError, match="1e-4"):
        _drive(node, False, tiers_of("cuda"))
    auto = _route_node(rtol=1e-5, atol=1e-5, regularize="none",
                       max_steps=256)
    assert auto.forward_tier(torch.device("cuda")) == "fp32"
    sol, st = _drive(node, False, contextlib.nullcontext())
    assert bool(st["success"]) and bool(torch.isfinite(sol.ys).all())


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_conv_grad_precision_knob(use_pallas):
    """tests/test_misc.py:102-137 on the conv family: grad_precision
    'default' moves the stored adjoint's recompute to the default tier,
    FP32 on the CPU, so its gradients equal 'match''s to rtol 1e-6, and the
    knob validates."""
    grads = {}
    for gp in ("match", "default"):
        node = _route_node(use_pallas=use_pallas, grad_precision=gp,
                           precision="highest", rtol=1e-3, atol=1e-3,
                           regularize="none", max_steps=32)
        assert node.bwd_precision == (None if gp == "default" else "highest")
        _drive(node, True, contextlib.nullcontext())
        grads[gp] = [p.grad for p in node.model.parameters()]
    for a, b in zip(grads["default"], grads["match"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="grad_precision"):
        _route_node(grad_precision="fast")
