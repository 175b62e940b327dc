"""The precision tiers of the port (the reference's 'highest' and
'default', which on a card is TF32) against the JAX package.

On the CPU every tier computes FP32, as JAX does there, so the reference's
own tests of the knob port as they stand (rtol 1e-6, and bitwise). The TF32
tier's plain versions (``tier="tf32"``, which the kernels' TF32
instantiations are held against on the card) are held here against the
JAX package's FP32 functions: a TF32 product rounds both operands to 10
mantissa bits (at most 2^-11 relative each), so an output that passes
through ``depth`` products in sequence moves by at most 2·2^-11·depth of
its scale to first order, the tolerance of every comparison across tiers
below. ``round_tf32`` is held bitwise against ``jax.lax.reduce_precision``,
which rounds ties to even where ``cvt.rna`` rounds them away from zero.
"""
import contextlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.models import NeuralODE as JNeuralODE
from localregneuralde_tpu.models import TDChain as JTDChain
from localregneuralde_tpu.models import diffeqsol_to_array
from localregneuralde_tpu.nn import Dense as JDense
from localregneuralde_tpu.ops.pallas.fused_mlp import _pure_step, _pure_tdmlp
from localregneuralde_tpu.ops.pallas.fused_mlp_bwd import (
    fused_step_bwd as jax_fused_step_bwd,
)
from localregneuralde_tpu.ops.pallas.fused_solve import (
    persistent_tsit5_solve as jax_persistent_solve,
)
from localregneuralde_tpu.ops.pallas.fused_solve_bwd import (
    persistent_stored_sweep as jax_stored_sweep,
)
from localregneuralde_tpu_torch.models import NeuralODE, TDChain, neural_ode
from localregneuralde_tpu_torch.nn import Dense
from localregneuralde_tpu_torch.nn.basic import (
    check_product_tier, product_tier, product_tier_scope,
    resolve_solver_precision, round_tf32, tier_matmul, tiers_of,
)
from localregneuralde_tpu_torch.ops.cuda import (
    TDMLPWeights, fused_step_bwd_plain, persistent_stored_sweep_plain,
    persistent_tsit5_solve_plain, persistent_two_level_sweep_plain,
    tdmlp_plain, tsit5_step_plain,
)
from localregneuralde_tpu_torch.parity import load_jax_params

torch.set_num_threads(1)
F, H, B = 32, 16, 8
U = 2.0 ** -11  # TF32's unit roundoff


def tf32_tol(depth):
    """Across tiers: 2·2^-11 per product in sequence, of the scale."""
    return 2 * U * depth


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max()) / max(float(np.abs(ref).max()),
                                                  1e-30)


def _weights(seed=0):
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
    return ps, w, x


def _jlist(ps):
    return [np.asarray(ps["layer_0"]["w"]), np.asarray(ps["layer_0"]["b"]),
            np.asarray(ps["layer_1"]["w"]), np.asarray(ps["layer_1"]["b"])]


# ------------------------------------------------------------- the rounding

def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_round_tf32_matches_reduce_precision_off_ties():
    """Off the ties, round-to-nearest is one rounding whatever the tie rule:
    bitwise ``jax.lax.reduce_precision(x, 8, 10)``, over magnitudes from
    1e-30 to 1e30 and both signs."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-30, 30, 20000)
         ).astype(np.float32)
    x = x[(_bits(x) & 0x1FFF) != 0x1000]
    ours = round_tf32(torch.tensor(x)).numpy()
    ref = np.asarray(jax.lax.reduce_precision(jnp.asarray(x), 8, 10))
    np.testing.assert_array_equal(_bits(ours), _bits(ref))
    assert not np.any(_bits(ours) & 0x1FFF)


def test_round_tf32_rounds_ties_away_from_zero():
    """On a tie (the 13 dropped bits exactly 0x1000) cvt.rna rounds the
    magnitude up; reduce_precision rounds to even, so the two differ
    exactly where the kept last bit is 0."""
    rng = np.random.default_rng(1)
    kept = rng.integers(0x00800000, 0x7F000000, 4000, dtype=np.uint32)
    bits = (kept & ~np.uint32(0x1FFF)) | np.uint32(0x1000)
    bits[::2] |= np.uint32(0x80000000)  # negative half
    x = bits.view(np.float32)
    ours = _bits(round_tf32(torch.tensor(x)).numpy())
    away = (bits & ~np.uint32(0x1FFF)) + np.uint32(0x2000)
    np.testing.assert_array_equal(ours, away)
    rne = _bits(np.asarray(jax.lax.reduce_precision(jnp.asarray(x), 8, 10)))
    odd = (bits & np.uint32(0x2000)) != 0
    np.testing.assert_array_equal(ours[odd], rne[odd])
    assert np.all(ours[~odd] != rne[~odd])


# ---------------------------------------------------------------- the tiers

@pytest.mark.parametrize("precision", ["auto", "default", None, "high",
                                       "highest"])
@pytest.mark.parametrize("rtol", [1e-8, 9.9e-5, 1e-4, 1e-3])
@pytest.mark.parametrize("device", ["cpu", torch.device("cuda")])
def test_product_tier(precision, rtol, device):
    """TF32 exactly for the backend default (None, 'default', 'auto' at
    rtol ≥ 1e-4) on CUDA; FP32 otherwise, on the CPU always. No card is
    needed: the tier is a function of the device's type."""
    resolved = resolve_solver_precision(precision, rtol)
    want = ("tf32" if resolved is None and torch.device(device).type == "cuda"
            else "fp32")
    assert product_tier(resolved, device) == want
    with pytest.raises(ValueError):
        product_tier("auto", device)


@pytest.mark.parametrize("precision", [None, "default", "high", "highest"])
def test_tiers_of_answers_for_the_named_device(precision):
    """Inside ``tiers_of("cuda")`` a CPU tensor's products take the card's
    tier; the scope nests and restores."""
    cuda = torch.device("cuda")
    assert product_tier(precision, "cpu") == "fp32"
    with tiers_of("cuda"):
        assert product_tier(precision, "cpu") == product_tier(precision,
                                                              cuda)
        with tiers_of("cpu"):
            assert product_tier(precision, cuda) == "fp32"
        assert product_tier(precision, "cpu") == product_tier(precision,
                                                              cuda)
    assert product_tier(precision, "cpu") == "fp32"


def _node_grads(use_pallas, precision, rtol, scope):
    torch.manual_seed(0)
    node = NeuralODE(TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F)),
                     rtol=rtol, atol=rtol, max_steps=256, precision=precision,
                     regularize="none", use_pallas=use_pallas)
    x = torch.tensor(_weights()[2])
    params = list(node.model.parameters())
    with scope:
        sol, _ = node(x, node.init_state(), training=True)
        grads = torch.autograd.grad((sol.ys ** 2).sum(), params)
    return sol.ys.detach(), grads


@pytest.mark.parametrize("use_pallas", ["on", "off"])
def test_tiers_of_routes_a_cpu_node_as_the_card(use_pallas):
    """A CPU node inside ``tiers_of("cuda")`` routes the tiers as the card
    does. At rtol 1e-6 ('auto' is FP32) the forward is bitwise the FP32
    one; the kernel route's cotangent and weight-gradient products are TF32
    (the reference's default tier), so its gradients leave the FP32 ones
    by TF32's rounding, while the plain route transposes at the forward's
    tier, bitwise FP32. At rtol 1e-3 ('auto' is the default tier) the
    forward moves too."""
    fp = _node_grads(use_pallas, "auto", 1e-6, contextlib.nullcontext())
    card = _node_grads(use_pallas, "auto", 1e-6, tiers_of("cuda"))
    assert torch.equal(card[0], fp[0])
    same = [torch.equal(a, b) for a, b in zip(card[1], fp[1])]
    assert all(same) == (use_pallas == "off")
    assert max(_rel(a, b) for a, b in zip(card[1], fp[1])) <= tf32_tol(13)
    fp = _node_grads(use_pallas, "auto", 1e-3, contextlib.nullcontext())
    card = _node_grads(use_pallas, "auto", 1e-3, tiers_of("cuda"))
    # the steps differ with the tier: one evaluation's TF32 rounding
    assert not torch.equal(card[0], fp[0])
    assert _rel(card[0], fp[0]) <= tf32_tol(2)


def test_tf32_forward_refuses_tight_tolerances():
    """A forward at the TF32 tier below rtol 1e-4 raises (the reference
    saturates max_steps there); FP32 and rtol 1e-4 pass."""
    with pytest.raises(ValueError, match="1e-4"):
        check_product_tier("tf32", 9.9e-5)
    check_product_tier("tf32", 1e-4)
    check_product_tier("fp32", 1e-12)
    _, w, x = _weights()
    with pytest.raises(ValueError, match="1e-4"):
        persistent_tsit5_solve_plain(
            w, torch.tensor(x), (0.0, 1.0), rtol=1e-5, atol=1e-5,
            saveat_arr=torch.tensor([1.0]), max_steps=8, tier="tf32")
    dyn = TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F))
    node = NeuralODE(dyn, rtol=1e-5, atol=1e-5, precision="default",
                     regularize="none", max_steps=64)
    assert node.forward_tier(torch.device("cuda")) == "tf32"
    assert node.forward_tier("cpu") == "fp32"
    with pytest.raises(ValueError, match="1e-4"):
        check_product_tier(node.forward_tier(torch.device("cuda")), node.rtol)
    # on the CPU every tier is FP32: the same layer solves
    sol, st = node(torch.tensor(x), node.init_state())
    assert bool(st["success"]) and bool(torch.isfinite(sol.ys).all())


# ----------------------------------------------- the tiered products, exact

def _f64(t):
    return t.detach().double()


def _rounded_product(ours, a, b):
    """Whether ``ours`` is the FP32 product of ``a`` and ``b`` rounded to
    TF32: against a float64 model of the rounded products (each exact in
    FP32), within FP32's summation error over the K terms."""
    ra, rb = _f64(round_tf32(a.detach())), _f64(round_tf32(b.detach()))
    bound = a.shape[-1] * 2.0 ** -24 * (ra.abs() @ rb.abs())
    return bool(((_f64(ours) - ra @ rb).abs() <= bound).all())


def test_tf32_matmul_backward_is_the_rounded_products():
    """``tier_matmul`` at TF32: forward and backward each round their
    operands."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(9, 37, generator=g, requires_grad=True)
    b = torch.randn(37, 5, generator=g, requires_grad=True)
    ct = torch.randn(9, 5, generator=g)
    y = tier_matmul(a, b, "tf32")
    y.backward(ct)
    assert _rounded_product(y, a, b)
    assert _rounded_product(a.grad, ct, b.detach().T)
    assert _rounded_product(b.grad, a.detach().T, ct)
    # the unrounded products differ by TF32's rounding, not FP32's
    assert float((y.detach() - a.detach() @ b.detach()).abs().max()) > 1e-5
    assert not _rounded_product(a.detach() @ b.detach(), a, b)


def test_tier_matmul_mixes_tiers_and_keeps_them_for_backward():
    """``tier_matmul(a, b, "fp32", "tf32")`` is the FP32 product forward
    and the rounded products backward; a Dense layer in a TF32 scope saves
    its tier, so its backward outside the scope is still TF32."""
    g = torch.Generator().manual_seed(1)
    a = torch.randn(6, 11, generator=g, requires_grad=True)
    b = torch.randn(11, 4, generator=g, requires_grad=True)
    ct = torch.randn(6, 4, generator=g)
    y = tier_matmul(a, b, "fp32", "tf32")
    assert torch.equal(y.detach(), a.detach() @ b.detach())
    y.backward(ct)
    assert _rounded_product(a.grad, ct, b.detach().T)
    layer = Dense(11, 4, use_bias=False)
    x = torch.randn(6, 11, generator=g, requires_grad=True)
    with product_tier_scope("tf32"):
        out, _ = layer(x, {})
    assert _rounded_product(out, x, layer.w)
    out.backward(ct)  # outside the scope
    assert _rounded_product(x.grad, ct, layer.w.detach().T)
    assert _rounded_product(layer.w.grad, x.detach().T, ct)
    out_fp, _ = layer(x.detach(), {})
    assert torch.equal(out_fp, x.detach() @ layer.w.detach())


# ------------------------------------- the TF32 plain versions against JAX

@pytest.mark.parametrize("s", [0.0, 0.7])
def test_tdmlp_tf32_plain_within_tf32_rounding_of_jax(s):
    """Kernel 1's TF32 plain version against JAX's FP32 evaluation, within
    the first-order bound of its two rounded products, element by element:
    |Δz| ≤ 2u·|x|·|W1| and |Δy| ≤ 2u·|h|·|W2| + |Δz|·|W2|
    (tanh' ≤ 1)."""
    ps, w, x = _weights(seed=2)
    ours = tdmlp_plain(w, torch.tensor(x), s, "tf32").numpy()
    ref = np.asarray(_pure_tdmlp(ps, jnp.asarray(x), jnp.float32(s)))
    w1, w2 = (np.abs(a[:-1]).astype(np.float64) for a in
              (np.asarray(ps["layer_0"]["w"]), np.asarray(ps["layer_1"]["w"])))
    h = np.abs(tdmlp_hidden(ps, x, s))
    dz = 2 * U * (np.abs(x) @ w1)
    bound = 2 * U * (h @ w2) + dz @ w2
    assert np.all(np.abs(ours - ref) <= 1.01 * bound + 1e-6)
    assert _rel(ours, ref) > 1e-6  # the tiers do differ


def tdmlp_hidden(ps, x, s):
    w1 = np.asarray(ps["layer_0"]["w"], np.float64)
    z = x @ w1[:-1] + np.asarray(ps["layer_0"]["b"]) + s * w1[-1]
    return np.tanh(z)


def test_tsit5_step_tf32_plain_within_tf32_rounding_of_jax():
    """Kernel 2's TF32 plain version against JAX's FP32 step: six
    evaluations of two products in sequence. ũ = dt·Σ b̃_i k_i cancels, so
    its error is held to dt·max|Δk| (Σ|b̃_i| < 1), not to its own scale:
    the TF32 noise in ũ that makes the tier unusable below rtol 1e-4."""
    ps, w, x = _weights(seed=3)
    t, dt = 0.2, 0.05
    k1 = np.asarray(_pure_tdmlp(ps, jnp.asarray(x), jnp.float32(t)))
    ref = _pure_step(ps, jnp.asarray(x), jnp.float32(t), jnp.float32(dt),
                     jnp.asarray(k1))
    ours = tsit5_step_plain(w, torch.tensor(x), torch.tensor(t),
                            torch.tensor(dt), torch.tensor(k1), "tf32")
    names = ("u_new", "utilde", "k2", "k3", "k4", "k5", "k6", "k7", "g6")
    dk = 0.0
    for name, a, b in zip(names, ours, ref):
        if name != "utilde":
            assert _rel(a.numpy(), b) <= tf32_tol(12), name
        if name.startswith("k"):
            dk = max(dk, float(np.abs(a.numpy() - np.asarray(b)).max()))
    assert float(np.abs(ours[1].numpy() - np.asarray(ref[1])).max()) <= dt * dk


def test_step_bwd_tf32_plain_within_tf32_rounding_of_jax():
    """Kernel 3's plain version at both of its routes' tiers (TF32
    throughout; FP32 recompute, TF32 gradients) against JAX's FP32 VJP
    kernel (interpret mode): twelve products recomputed, thirteen in the
    reverse chain."""
    ps, w, x = _weights(seed=4)
    t, dt = 0.1, 0.2
    k1 = np.asarray(_pure_tdmlp(ps, jnp.asarray(x), jnp.float32(t)))
    cts = [np.random.default_rng(i).standard_normal((B, F)).astype(np.float32)
           for i in range(9)]
    d_ps, d_u, _, _, d_k1 = jax_fused_step_bwd(
        ps, jnp.asarray(x), jnp.float32(t), jnp.float32(dt), jnp.asarray(k1),
        tuple(map(jnp.asarray, cts)))
    ref = [d_u, d_k1, *_jlist(d_ps)]
    for tiers, depth in ((("tf32", "tf32"), 25), (("fp32", "tf32"), 13)):
        d_w, ou, ok1 = fused_step_bwd_plain(
            w, torch.tensor(x), torch.tensor(t), torch.tensor(dt),
            torch.tensor(k1), [torch.tensor(c) for c in cts], *tiers)
        for a, b in zip([ou, ok1, *d_w], ref):
            assert _rel(a.numpy(), b) <= tf32_tol(depth), tiers


def _jax_solve(ps, x, rtol, **kw):
    return jax_persistent_solve(
        ps, jnp.asarray(x), (0.0, 1.0), rtol=rtol, atol=rtol,
        saveat_arr=jnp.asarray([0.5, 1.0]), max_steps=64, **kw)


def test_solve_tf32_plain_nfe_within_band_of_jax():
    """Kernel 4's TF32 plain version at rtol 1e-3 against JAX's FP32
    persistent solve (interpret mode). TF32's rounding of the stage
    derivatives enters the cancelling ũ as noise (dt·Σ|b̃_i|·2^-10·|k|
    against atol + rtol·|u|) that adds to the error estimate, so the TF32
    solve takes more steps: its NFE lies in [NFE − 6, 2·NFE] of the FP32
    solve's (here 38 against 26), and its solution within TF32's rounding
    over the evaluations taken."""
    ps, w, x = _weights(seed=5)
    ref = _jax_solve(ps, x, 1e-3)
    ours = persistent_tsit5_solve_plain(
        w, torch.tensor(x), (0.0, 1.0), rtol=1e-3, atol=1e-3,
        saveat_arr=torch.tensor([0.5, 1.0]), max_steps=64, tier="tf32")
    nfe, jnfe = int(ours["nfe"]), int(ref["nfe"])
    assert jnfe - 6 <= nfe <= 2 * jnfe and bool(ours["success"])
    assert _rel(ours["ys"].numpy(), ref["ys"]) <= tf32_tol(2 * jnfe)


def test_stored_sweep_tf32_plain_within_tf32_rounding_of_jax():
    """Kernel 7's plain version at TF32 (recompute and gradients) and at
    mlp.yaml's route (FP32 recompute, TF32 gradients) on JAX's knots,
    against JAX's FP32 sweep kernel (interpret mode): a transposed step
    passes fourteen recomputed products and thirteen reverse ones."""
    ps, w, x = _weights(seed=6)
    rec = _jax_solve(ps, x, 1e-4, record_knots=True, record_ks=False)
    rng = np.random.default_rng(9)
    ct_ys = rng.standard_normal((2, B, F)).astype(np.float32)
    ct_y = rng.standard_normal((B, F)).astype(np.float32)
    ref = jax_stored_sweep(ps, rec["knot_ts"], rec["knot_us"], rec["naccept"],
                           jnp.asarray([0.5, 1.0]), jnp.asarray(ct_ys),
                           jnp.asarray(ct_y))
    ref = [ref[0], ref[1], *_jlist(ref[2])]
    args = (w, torch.tensor(np.asarray(rec["knot_ts"])),
            torch.tensor(np.asarray(rec["knot_us"])[:, :, :F]),
            torch.tensor(int(rec["naccept"])), torch.tensor([0.5, 1.0]),
            torch.tensor(ct_ys), torch.tensor(ct_y))
    for rec_tier, depth in (("tf32", 27), ("fp32", 13)):
        a_u, a_k, d_w = persistent_stored_sweep_plain(
            *args, recompute_tier=rec_tier, grad_tier="tf32")
        for a, b in zip([a_u, a_k, *d_w], ref):
            assert _rel(a.numpy(), b) <= tf32_tol(depth), rec_tier


def test_tf32_two_level_equals_dense_on_own_forward():
    """Kernel 8's plain version at TF32: the windowed replay at the TF32
    tier repeats the TF32 forward's accepts, so the two-level sweep equals
    the dense one over the same forward bitwise."""
    _, w, x = _weights(seed=7)
    kw = dict(rtol=1e-4, atol=1e-4, saveat_arr=torch.tensor([0.5, 1.0]),
              max_steps=64, tier="tf32")
    fwd = persistent_tsit5_solve_plain(
        w, torch.tensor(x), (0.0, 1.0), record_knots=True, knot_dense_cap=64,
        knot_stride=4, **kw)
    n = int(fwd["naccept"])
    assert n > 2
    rng = np.random.default_rng(10)
    ct_ys = torch.tensor(rng.standard_normal((2, B, F)).astype(np.float32))
    ct_y = torch.tensor(rng.standard_normal((B, F)).astype(np.float32))
    args = (w, fwd["knot_ts"], fwd["knot_us"], fwd["naccept"],
            torch.tensor([0.5, 1.0]), ct_ys, ct_y)
    tiers = dict(recompute_tier="tf32", grad_tier="tf32")
    dense = persistent_stored_sweep_plain(*args, **tiers)
    win = persistent_two_level_sweep_plain(
        *args, *(fwd[k] for k in ("ckpt_ts", "ckpt_us", "ckpt_ks", "ckpt_dts",
                                  "ckpt_qolds")),
        t_end=1.0, rtol=1e-4, atol=1e-4, max_steps=64, stride=4, dense_cap=2,
        tier="tf32", **tiers)
    for a, b in zip([win[0], win[1], *win[2]],
                    [dense[0], dense[1], *dense[2]]):
        assert torch.equal(a, b)


# ------------------------------------- the reference's tests of the knob

def _loss_port(node, x):
    sol, _ = node(x, node.init_state(), training=True)
    return (sol.ys ** 2).sum()


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_grad_precision_knob(use_pallas):
    """tests/test_misc.py:102-137 on the port: grad_precision 'default'
    moves the stored adjoint's recompute to the default tier, FP32 on the
    CPU, so its gradients equal 'match''s to rtol 1e-6 (and JAX's to the
    port's FP32 parity), and the knob validates."""
    jdyn = JTDChain(JDense(9, 8, "tanh"), JDense(9, 8))
    jnode = JNeuralODE(jdyn, rtol=1e-3, atol=1e-3, max_steps=32,
                       regularize="none", grad_precision="default")
    params, state = jnode.init(jax.random.PRNGKey(0))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 8)))

    def jloss(p):
        sol, _ = jnode.apply(p, state, jnp.asarray(x), training=True)
        return jnp.sum(diffeqsol_to_array(sol) ** 2)

    jg = jax.grad(jloss)(params)["model"]

    def build(gp):
        node = NeuralODE(TDChain(Dense(9, 8, "tanh"), Dense(9, 8)),
                         rtol=1e-3, atol=1e-3, max_steps=32,
                         regularize="none", grad_precision=gp,
                         use_pallas=use_pallas)
        load_jax_params(node, {"model": params["model"]})
        return node

    node_m, node_d = build("match"), build("default")
    assert node_d.bwd_precision is None
    grads = {}
    for gp, node in (("match", node_m), ("default", node_d)):
        _loss_port(node, torch.tensor(x)).backward()
        grads[gp] = {n: p.grad for n, p in node.model.named_parameters()}
    for n in grads["match"]:
        np.testing.assert_allclose(grads["default"][n].numpy(),
                                   grads["match"][n].numpy(), rtol=1e-6)
        layer, leaf = n.split(".")
        assert _rel(grads["default"][n].numpy(), jg[layer][leaf]) <= 1e-4
    with pytest.raises(ValueError, match="grad_precision"):
        build("fast")


def test_two_level_grad_precision_default_bitwise(monkeypatch):
    """tests/test_stored_adjoint.py:304-330 on the port: grad_precision
    'default' on the two-level path (knot_window 8; the kernels' plain
    versions on the CPU, every tier FP32) gives 'match''s gradients
    bitwise, the regulariser included, and JAX's to FP32 parity."""
    Fs, Hs, Bs = 16, 8, 4
    kw = dict(regularize="unbiased", adjoint="stored", rtol=1e-3, atol=1e-5,
              max_steps=64, knot_window=8)
    jnode = JNeuralODE(JTDChain(JDense(Fs + 1, Hs, "tanh"),
                                JDense(Hs + 1, Fs)),
                       use_pallas=True, grad_precision="default", **kw)
    ps, st = jnode.init(jax.random.PRNGKey(0))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (Bs, Fs)))
    _, tkey, _ = jax.random.split(st["rng"], 3)
    t1 = float(jax.random.uniform(tkey, (), jnp.float32, minval=0.0,
                                  maxval=1.0))

    def jloss(p):
        sol, _ = jnode(p, st, jnp.asarray(x), training=True)
        return jnp.sum(diffeqsol_to_array(sol))

    jg = jax.grad(jloss)(ps)["model"]
    monkeypatch.setattr(neural_ode, "sample_t1", lambda g, t0, t2: t1)
    grads, ys_grads = {}, {}
    for gp in ("match", "default"):
        node = NeuralODE(TDChain(Dense(Fs + 1, Hs, "tanh"),
                                 Dense(Hs + 1, Fs)),
                         use_pallas="on", grad_precision=gp, **kw)
        load_jax_params(node, {"model": ps["model"]})
        params = list(node.model.parameters())
        sol, st_ = node(torch.tensor(x), node.init_state(), training=True)
        grads[gp] = torch.autograd.grad(sol.ys.sum() + st_["reg_val"], params)
        sol, _ = node(torch.tensor(x), node.init_state(), training=True)
        ys_grads[gp] = torch.autograd.grad(sol.ys.sum(), params)
    for a, b in zip(grads["default"], grads["match"]):
        assert torch.equal(a, b)
    # against JAX without the regulariser, whose error estimate is f32
    # rounding noise at this tolerance (ROADMAP Queue 3)
    names = [n for n, _ in node.model.named_parameters()]
    for n, a in zip(names, ys_grads["default"]):
        layer, leaf = n.split(".")
        assert _rel(a.numpy(), jg[layer][leaf]) <= 1e-4


def test_grad_precision_warns_on_plain_route():
    """tests/test_resume_parity.py:125-147 on the port: 'default' warns
    where the plain backward cannot honour it (use_pallas off, a tight
    tolerance), and not where the kernels do or where the precision is the
    default already."""
    dyn = TDChain(Dense(5, 8, "tanh"), Dense(9, 4))
    with pytest.warns(UserWarning, match="grad_precision"):
        NeuralODE(dyn, rtol=1e-8, atol=1e-8, use_pallas=False,
                  grad_precision="default")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        NeuralODE(dyn, rtol=1e-8, atol=1e-8, use_pallas=True,
                  grad_precision="default")
        NeuralODE(dyn, rtol=1e-2, atol=1e-2, use_pallas=False,
                  grad_precision="default")
