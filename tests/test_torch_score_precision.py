"""The score family's precision tier (the reference samplers' backend
default, which on a card is TF32) against the JAX package on the CPU.

The reference calls both samplers' kernels with no precision and evaluates
the score module outside any precision scope, so on a card every product
of the score net runs at TF32. On the CPU every tier computes FP32, as JAX
does there, so the existing parity tests hold as they stand. The TF32
plain versions (``tier="tf32"``, which kernels 11 and 6's TF32
instantiations are held against on the card) round each layer's operands
with ``nn.basic.round_tf32`` and multiply in FP32; the time term
t·W[-1], the bias and tanh stay FP32:

- one layer at TF32 is held against JAX's FP32 product of operands rounded
  by ``jax.lax.reduce_precision(·, 8, 10)`` (inputs nudged off the ties:
  ``cvt.rna`` rounds a tie away from zero, ``reduce_precision`` to even),
  within FP32's summation error over its K terms;
- the score chain, two layers in sequence, element by element within the
  first-order bound of its rounded products against JAX's FP32 chain;
- kernel 11's plain version at TF32 against JAX's Pallas kernel
  (interpret mode, FP32) with its interpret-mode normals injected: the
  same accepts and rejects, states within the FP32 route's 1e-3 of their
  largest value plus one evaluation's TF32 rounding, 2·2^-11 a layer;
- kernel 6's plain version at TF32 against JAX's Pallas kernel at rtol =
  atol 1e-2 and β_max = 5, where TF32's noise in ũ (the derivatives
  ½β(u + s) carry TF32's rounding of their scale, up to ten times |u|'s)
  does not set the steps: NFE within two attempts, states within 5e-5 of
  max|y| plus one evaluation's TF32 rounding. At the sampler's rtol 1e-4
  the noise does set them (the flow takes more steps at TF32, as the
  reference does on a GPU).

The samplers' routing is checked on the CPU inside ``nn.tiers_of("cuda")``
through the tiers each wrapper and each Dense layer is called at, and the
refusal of a TF32 solve below rtol 1e-4. Sizes: B = 64, F = 8, H = 16
(``tests/test_torch_score.py``), one intra-op thread.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.ops.pallas.fused_sde_solve import (
    persistent_vpsde_solve as jax_persistent_vpsde_solve,
    td_score_eval_pure,
)
from localregneuralde_tpu.ops.pallas.fused_solve import (
    persistent_pf_solve as jax_persistent_pf_solve,
)
from localregneuralde_tpu_torch import ops
from localregneuralde_tpu_torch.models import (
    VPSDE,
    TDChain,
    sample_probability_flow,
    sample_vpsde,
)
from localregneuralde_tpu_torch.nn import Dense, basic
from localregneuralde_tpu_torch.nn.basic import product_tier, tiers_of
from localregneuralde_tpu_torch.ops.cuda import (
    match_td_score_chain,
    persistent_pf_solve,
    persistent_pf_solve_plain,
    persistent_vpsde_solve,
    persistent_vpsde_solve_plain,
    score_chain_params,
    td_score_eval_plain,
)
from localregneuralde_tpu_torch.sde import PhiloxNormals
from test_torch_score import B, F, H, _jax_params, _modules, _x
from test_torch_sde import pallas_interpret_source
from test_torch_sde_precision import (
    U,
    _normal,
    _off_ties,
    _rel,
    _rp,
    _within_fp32_sums,
    tf32_tol,
)

SDE_TOL = 5e-2
STATE_REL = 1e-3           # the FP32 route's, tests/test_torch_score.py
PF_REL = 5e-5              # the FP32 route's, tests/test_torch_score.py
DEPTH = 2                  # the test chain's two layers in sequence


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(params):
    _, mod = _modules(params)
    chain = match_td_score_chain(mod)
    return mod, chain, [p.detach() for p in score_chain_params(mod, chain)]


# ------------------------------------------------------------ the chain

@pytest.mark.parametrize("t", [0.0, 0.37])
def test_score_layer_tf32_matches_jax_on_rounded_operands(t):
    """One layer of the score chain at TF32, a·W[:-1] + t·W[-1] + b: JAX's
    FP32 product of the rounded operands plus the FP32 time term, within
    FP32's summation error; the tiers differ."""
    params = _jax_params(1)
    w = _off_ties(params["layer_0"]["w"])
    b = params["layer_0"]["b"]
    x = _normal(2, (B, F))
    spec = ops.cuda.ScoreChainSpec((F, H), (False,), ("layer_0",))
    ps = [torch.tensor(w), torch.tensor(b)]
    ours = td_score_eval_plain(ps, spec, torch.tensor(x), t, "tf32").numpy()
    ref = np.asarray(_rp(x) @ _rp(w[:-1]) + t * w[-1] + b)
    assert _within_fp32_sums(ours, ref, x, w[:-1], F)
    assert _rel(ours, td_score_eval_plain(ps, spec, torch.tensor(x),
                                          t).numpy()) > 1e-6


def test_score_chain_tf32_within_tf32_rounding_of_jax():
    """The two-layer score chain at TF32 against JAX's FP32 chain
    (``td_score_eval_pure``), element by element within the first-order
    bound of its rounded products: |Δz| ≤ 2u·|x|·|W0| and
    |Δy| ≤ 2u·|h|·|W1| + |Δz|·|W1| (tanh' ≤ 1)."""
    params = _jax_params(3)
    _, chain, ps = _chain(params)
    x = _normal(4, (B, F))
    t = 0.6
    ours = td_score_eval_plain(ps, chain, torch.tensor(x), t, "tf32").numpy()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = np.asarray(td_score_eval_pure(jp, chain.keys, chain.acts,
                                        jnp.asarray(x), t))
    w0 = np.abs(params["layer_0"]["w"][:-1]).astype(np.float64)
    w1 = np.abs(params["layer_1"]["w"][:-1]).astype(np.float64)
    h = np.abs(np.tanh(x.astype(np.float64) @ params["layer_0"]["w"][:-1]
                       + t * params["layer_0"]["w"][-1]
                       + params["layer_0"]["b"]))
    dz = 2 * U * (np.abs(x) @ w0)
    bound = 2 * U * (h @ w1) + dz @ w1
    assert np.all(np.abs(ours - ref) <= 1.01 * bound + 1e-6)
    assert _rel(ours, ref) > 1e-6


# ------------------------------------------------------------ kernel 11

def test_k11_tf32_plain_against_jax_pallas():
    """Kernel 11's plain version at TF32 against the JAX kernel (interpret
    mode, FP32) with the kernel's interpret-mode noise injected: the same
    accepts and rejects, states within the FP32 route's 1e-3 of their scale
    plus one evaluation's TF32 rounding; the FP32 plain version on the same
    path differs from the TF32 one."""
    params = _jax_params(2, scale=0.3)
    _, chain, ps = _chain(params)
    x = _x(4)
    nk = jax.random.PRNGKey(5)
    saveat = np.asarray([0.4, 0.999], np.float32)
    kw = dict(rtol=SDE_TOL, atol=SDE_TOL, solver="sosri", delta=1 / 6,
              max_steps=64)
    sched = dict(beta_min=0.1, beta_max=5.0, t1=1.0)
    ref = jax_persistent_vpsde_solve(
        jax.tree_util.tree_map(jnp.asarray, params),
        (chain.dims, chain.acts, chain.keys), jnp.asarray(x), (0.0, 0.999),
        noise_key=nk, saveat_arr=jnp.asarray(saveat), **kw, **sched)
    outs = {tier: persistent_vpsde_solve_plain(
        ps, chain, torch.tensor(x), (0.0, 0.999),
        noise=pallas_interpret_source(nk, rows=B, cols=F),
        saveat_arr=torch.tensor(saveat), tier=tier, **kw, **sched)
        for tier in ("fp32", "tf32")}
    ours = outs["tf32"]
    assert bool(ours["success"])
    assert int(ours["naccept"]) == int(ref["naccept"]) >= 3
    assert int(ours["nreject"]) == int(ref["nreject"])
    scale = float(np.abs(np.asarray(ref["ys"])).max())
    for k in ("ys", "y_final"):
        err = float(np.abs(ours[k].numpy() - np.asarray(ref[k])).max())
        assert err <= (STATE_REL + tf32_tol(DEPTH)) * scale, (k, err)
    assert not torch.equal(outs["fp32"]["ys"], ours["ys"])


# ------------------------------------------------------------ kernel 6

def test_k6_tf32_plain_against_jax_pallas():
    """Kernel 6's plain version at TF32 against the JAX kernel (interpret
    mode, FP32) at rtol = atol 1e-2 and β_max = 5: NFE within two
    attempts, y_final and
    ys within the FP32 route's 5e-5 of max|y| plus one evaluation's TF32
    rounding; the wrapper on the CPU inside ``tiers_of("cuda")`` at the
    backend default is bitwise the TF32 plain version, outside it the FP32
    one, with no launch counted."""
    params = _jax_params(8)
    _, chain, ps = _chain(params)
    x = _x(9)
    saveat = np.asarray([0.5, 0.999], np.float32)
    kw = dict(rtol=1e-2, atol=1e-2, max_steps=128, beta_min=0.1,
              beta_max=5.0, t1=1.0)
    ref = jax_persistent_pf_solve(
        jax.tree_util.tree_map(jnp.asarray, params),
        (chain.dims, chain.acts, chain.keys), jnp.asarray(x), (0.0, 0.999),
        saveat_arr=jnp.asarray(saveat), **kw)
    xt, st = torch.tensor(x), torch.tensor(saveat)
    ours = persistent_pf_solve_plain(ps, chain, xt, (0.0, 0.999),
                                     saveat_arr=st, tier="tf32", **kw)
    assert int(ref["naccept"]) >= 3 and bool(ours["success"])
    assert abs(int(ours["nfe"]) - int(ref["nfe"])) <= 12
    scale = float(np.abs(np.asarray(ref["ys"])).max())
    for k in ("ys", "y_final"):
        err = float(np.abs(ours[k].numpy() - np.asarray(ref[k])).max())
        assert err <= (PF_REL + tf32_tol(DEPTH)) * scale, (k, err)
    fp = persistent_pf_solve_plain(ps, chain, xt, (0.0, 0.999), saveat_arr=st,
                                   **kw)
    assert not torch.equal(fp["ys"], ours["ys"])
    with tiers_of("cuda"):
        card = persistent_pf_solve(ps, chain, xt, (0.0, 0.999), saveat_arr=st,
                                   precision=None, **kw)
        high = persistent_pf_solve(ps, chain, xt, (0.0, 0.999), saveat_arr=st,
                                   **kw)
    assert torch.equal(card["ys"], ours["ys"])
    assert torch.equal(high["ys"], fp["ys"])
    assert torch.equal(persistent_pf_solve(
        ps, chain, xt, (0.0, 0.999), saveat_arr=st, precision=None,
        **kw)["ys"], fp["ys"])
    assert ops.cuda.tier_launch_counts()["persistent_pf_solve"] == {}


# ------------------------------------------------------------ the routing

class _Recorder:
    """Wraps kernels 11's and 6's wrappers and ``nn.basic.layer_tier``,
    and records the tiers each is called at: the wrappers' and the score
    module's Dense layers'."""

    def __init__(self, monkeypatch):
        self.kernels, self.dense = [], []
        for name in ("persistent_vpsde_solve", "persistent_pf_solve"):
            fn = getattr(ops.cuda, name)

            def rec(*a, precision="highest", _fn=fn, _name=name, **kw):
                self.kernels.append((_name, product_tier(precision,
                                                         a[2].device)))
                return _fn(*a, precision=precision, **kw)

            module = (ops.cuda.fused_sde_solve if "vpsde" in name
                      else ops.cuda.fused_solve)
            monkeypatch.setattr(ops.cuda, name, rec)
            monkeypatch.setattr(module, name, rec)
        layer_tier = basic.layer_tier

        def rec_tier(precision, x):
            tier = layer_tier(precision, x)
            self.dense.append(tier)
            return tier

        monkeypatch.setattr(basic, "layer_tier", rec_tier)


def _score_module():
    g = torch.Generator().manual_seed(3)
    return TDChain(Dense(F + 1, H, "tanh", generator=g),
                   Dense(H + 1, F, generator=g))


def _draw(sampler, scope, **kw):
    with torch.no_grad(), scope:
        return sampler(None, (16, F), torch.Generator().manual_seed(4),
                       score_module=_score_module(), max_steps=2048,
                       device="cpu", **kw)


@pytest.mark.parametrize("route", [
    # (sampler options, the kernel and its tier, the module's Dense tier)
    ("vpsde", dict(solver="sosri"), ("persistent_vpsde_solve", "tf32"), None),
    ("vpsde", dict(solver="sri", use_pallas=False), None, "tf32"),
    ("vpsde", dict(solver="milstein", rtol=0.1, atol=0.1), None, "tf32"),
    ("vpsde", dict(solver="euler_heun"), None, "tf32"),
    ("pf", dict(), ("persistent_pf_solve", "tf32"), None),
    ("pf", dict(use_pallas=False, rtol=1e-3, atol=1e-3), None, "tf32"),
], ids=["sosri kernel", "sri eager", "milstein", "euler heun", "pf kernel",
        "pf eager"])
def test_samplers_take_the_reference_tiers(route, monkeypatch):
    """Both samplers on the CPU inside ``tiers_of("cuda")`` call kernels 11
    and 6 at the backend default (TF32) and evaluate the score module (the
    eager loops of SRI, Milstein and Euler–Heun, and the dt heuristic) at
    it; every tier FP32 outside the scope."""
    name, kw, kernel, dense = route
    sampler = sample_vpsde if name == "vpsde" else sample_probability_flow
    kw = dict(dict(rtol=1e-2, atol=1e-2) if name == "vpsde" else
              dict(rtol=1e-4, atol=1e-6), **kw)
    if name == "vpsde":
        kw["sde"] = VPSDE(0.1, 5.0)
    rec = _Recorder(monkeypatch)
    s, sol = _draw(sampler, tiers_of("cuda"), **kw)
    assert bool(sol.success) and bool(torch.isfinite(s).all())
    assert rec.kernels == ([kernel] if kernel else [])
    assert set(rec.dense) == ({dense} if dense else set())
    rec.kernels.clear(), rec.dense.clear()
    s_cpu, _ = _draw(sampler, contextlib.nullcontext(), **kw)
    assert {t for _, t in rec.kernels} | set(rec.dense) <= {"fp32"}
    assert not torch.equal(s, s_cpu)


@pytest.mark.parametrize("sampler", ["vpsde", "pf"])
def test_samplers_refuse_tf32_below_1e4(sampler):
    """A sampler whose products are TF32 (the card's tiers) refuses rtol
    below 1e-4 (README, documented deviations), as do the kernels' wrappers
    and plain versions at TF32; at the CPU's tiers the same call runs."""
    fn = sample_vpsde if sampler == "vpsde" else sample_probability_flow
    kw = dict(rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="1e-4"):
        _draw(fn, tiers_of("cuda"), **kw)
    s, sol = _draw(fn, contextlib.nullcontext(), **kw)
    assert bool(torch.isfinite(s).all())
    params = _jax_params(5)
    _, chain, ps = _chain(params)
    xt = torch.tensor(_x(6, rows=8))
    sched = dict(beta_min=0.1, beta_max=5.0, t1=1.0)
    if sampler == "vpsde":
        call = lambda **t: persistent_vpsde_solve(  # noqa: E731
            ps, chain, xt, (0.0, 0.999), noise=PhiloxNormals(1, 8, F),
            rtol=1e-5, atol=1e-5, solver="sosri", delta=1 / 6,
            saveat_arr=torch.tensor([0.999]), max_steps=4, **sched, **t)
        plain = persistent_vpsde_solve_plain
    else:
        call = lambda **t: persistent_pf_solve(  # noqa: E731
            ps, chain, xt, (0.0, 0.999), rtol=1e-5, atol=1e-5,
            saveat_arr=torch.tensor([0.999]), max_steps=4, **sched, **t)
        plain = persistent_pf_solve_plain
    with tiers_of("cuda"), pytest.raises(ValueError, match="1e-4"):
        call(precision=None)
    with tiers_of("cuda"):
        call()  # 'highest' keeps FP32
    with pytest.raises(ValueError, match="1e-4"):
        plain(ps, chain, xt, (0.0, 0.999), rtol=1e-5, atol=1e-5,
              saveat_arr=torch.tensor([0.999]), max_steps=4, tier="tf32",
              **sched, **(dict(noise=PhiloxNormals(1, 8, F), solver="sosri",
                               delta=1 / 6) if sampler == "vpsde" else {}))
