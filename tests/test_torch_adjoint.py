"""The port's gradient path against the JAX package: the local regulariser,
the step VJP's plain version, knot recording, the plain sweeps and the
stored adjoint, on the same numpy-seeded inputs at small size (F = 32,
H = 16, B = 8).

Tolerances: the step VJP and the sweeps follow ``tests/test_pallas_bwd.py``
(rtol 1e-4, atol 1e-5: FP32 sums in another order); stored-adjoint
gradients follow ``tests/test_stored_adjoint.py`` (rtol 1e-4 against JAX,
1e-5 between the port's two levels, which run the same arithmetic).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.models import TDChain as JTDChain
from localregneuralde_tpu.nn import Dense as JDense
from localregneuralde_tpu.ode import odesolve as jax_odesolve
from localregneuralde_tpu.ode.step import (
    Tsit5StepResult as JStep,
    regularization_value as jax_regularization_value,
)
from localregneuralde_tpu.ops.pallas.fused_mlp import _pure_tdmlp
from localregneuralde_tpu.ops.pallas.fused_mlp_bwd import (
    fused_step_bwd as jax_fused_step_bwd,
)
from localregneuralde_tpu.ops.pallas.fused_solve import (
    persistent_tsit5_solve as jax_persistent_solve,
)
from localregneuralde_tpu.ops.pallas.fused_solve_bwd import (
    persistent_stored_sweep as jax_stored_sweep,
    persistent_two_level_sweep as jax_two_level_sweep,
)
from localregneuralde_tpu_torch.ode import Tsit5StepResult, odesolve
from localregneuralde_tpu_torch.ode.step import regularization_value
from localregneuralde_tpu_torch.ode.stored_adjoint import stored_odesolve
from localregneuralde_tpu_torch.ops.cuda import (
    TDMLPWeights,
    fused_step_bwd_plain,
    persistent_stored_sweep,
    persistent_two_level_sweep,
)

F, H, B = 32, 16, 8


def _weights(seed=0):
    ps, _ = JTDChain(JDense(F + 1, H, "tanh"), JDense(H + 1, F)).init(
        jax.random.PRNGKey(seed)
    )
    rng = np.random.default_rng(seed + 1)
    ps = jax.tree_util.tree_map(np.asarray, ps)
    ps["layer_0"]["b"] = rng.standard_normal(H).astype(np.float32) * 0.1
    ps["layer_1"]["b"] = rng.standard_normal(F).astype(np.float32) * 0.1
    x = (0.5 * rng.standard_normal((B, F))).astype(np.float32)
    w = TDMLPWeights(*(torch.tensor(ps[l][k]) for l, k in (
        ("layer_0", "w"), ("layer_0", "b"), ("layer_1", "w"), ("layer_1", "b"))))
    return ps, w, x


def _jparams_as_list(ps):
    return [np.asarray(ps["layer_0"]["w"]), np.asarray(ps["layer_0"]["b"]),
            np.asarray(ps["layer_1"]["w"]), np.asarray(ps["layer_1"]["b"])]


def _close_rel(ours, ref, rel):
    """max-abs difference within ``rel`` of the largest reference value."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert float(np.abs(ours - ref).max()) <= rel * scale


# ---------------------------------------------------------------- regulariser

def _step_arrays(seed, bad=None):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, F)).astype(np.float32) for _ in range(11)]
    if bad == "inf":
        arrs[8][0, 0] = np.inf  # k7
    if bad == "zero_den":
        arrs[9] = arrs[0].copy()  # g6 == u_new
    return arrs


@pytest.mark.parametrize("reg_type,bad", [
    ("error_estimate", None), ("stiffness_estimate", None),
    ("stiffness_estimate", "inf"), ("stiffness_estimate", "zero_den"),
])
def test_regularization_value_matches_jax(reg_type, bad):
    # f32 reductions in another order: rtol 1e-6
    u_new, ut, *ks, g6, u_prev = _step_arrays(3, bad)[:11]
    dt = np.float32(0.07)
    jres = jax_regularization_value(
        reg_type, JStep(jnp.asarray(u_new), jnp.asarray(ut),
                        tuple(map(jnp.asarray, ks)), jnp.asarray(g6), None),
        jnp.asarray(u_prev), jnp.asarray(dt), 1e-4, 1e-4)
    tks = [torch.tensor(k, requires_grad=True) for k in ks]
    ours = regularization_value(
        reg_type, Tsit5StepResult(torch.tensor(u_new), torch.tensor(ut),
                                  tuple(tks), torch.tensor(g6), None),
        torch.tensor(u_prev), torch.tensor(dt), 1e-4, 1e-4)
    np.testing.assert_allclose(float(ours.detach()), float(jres), rtol=1e-6)
    if bad is not None:
        # the fence: a zero value with zero, not NaN, gradients
        assert float(ours.detach()) == 0.0
        ours.backward()
        for k in tks:
            assert k.grad is None or bool(torch.all(k.grad == 0))


# -------------------------------------------------------------- step VJP (K3)

@pytest.mark.parametrize("t,dt", [(0.2, 0.05), (0.0, 0.3)])
def test_step_bwd_plain_matches_jax_kernel(t, dt):
    ps, w, x = _weights(seed=2)
    k1 = np.asarray(_pure_tdmlp(ps, jnp.asarray(x), jnp.float32(t)))
    cts = [np.random.default_rng(i).standard_normal((B, F)).astype(np.float32)
           for i in range(9)]
    d_ps, d_u, _, _, d_k1 = jax_fused_step_bwd(
        ps, jnp.asarray(x), jnp.float32(t), jnp.float32(dt), jnp.asarray(k1),
        tuple(map(jnp.asarray, cts)))
    d_w, ou, ok1 = fused_step_bwd_plain(
        w, torch.tensor(x), torch.tensor(t), torch.tensor(dt),
        torch.tensor(k1), [torch.tensor(c) for c in cts])
    np.testing.assert_allclose(ou.numpy(), np.asarray(d_u), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ok1.numpy(), np.asarray(d_k1), rtol=1e-4, atol=1e-5)
    for a, b in zip(d_w, _jparams_as_list(d_ps)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ knot recording

def test_eager_loop_knots_match_jax():
    """Dense knots and two-level checkpoints of the eager loop against JAX
    ``odesolve(record_knots=True)`` on the same TD-MLP: the same layout,
    fill values and accept count; the first knot and checkpoint agree to
    f32 rounding, the later ones to 1%, since at rtol 1e-4 the f32 noise in
    the error estimate moves each dt proposal by up to a percent
    (tests/test_torch_solver.py::test_max_steps_cap_matches_jax)."""
    ps, w, x = _weights(seed=4)
    from localregneuralde_tpu_torch.ops.cuda import tdmlp_plain

    def jf(u, t, p):
        return _pure_tdmlp(p, u, t)

    kw = dict(rtol=1e-4, atol=1e-4, max_steps=64)
    rec = dict(record_knots=True, knot_stride=2, knot_dense_cap=3)
    ref = jax_odesolve(jf, jnp.asarray(x), (0.0, 1.0), ps, adjoint="none",
                       **rec, **kw)
    with torch.no_grad():
        ours = odesolve(lambda u, t: tdmlp_plain(w, u, t), torch.tensor(x),
                        (0.0, 1.0), **rec, **kw)
    n = int(ref.naccept)
    assert int(ours.naccept) == n and n > 3
    for name in ("knot_ts", "knot_us", "knot_ks", "ckpt_ts", "ckpt_us",
                 "ckpt_ks", "ckpt_dts", "ckpt_qolds"):
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-2, err_msg=name)
    # unwritten slots hold t_end and qoldinit, exactly as in JAX
    np.testing.assert_array_equal(ours.ckpt_ts.numpy()[n // 2 + 1:],
                                  np.asarray(ref.ckpt_ts)[n // 2 + 1:])
    np.testing.assert_array_equal(ours.ckpt_qolds.numpy()[n // 2 + 1:],
                                  np.asarray(ref.ckpt_qolds)[n // 2 + 1:])
    # checkpoints within the dense capacity are the dense knots
    assert torch.equal(ours.ckpt_us[1], ours.knot_us[2])


# ------------------------------------------------------- plain sweeps (K7/K8)

def _jax_recorded(ps, x, rtol, dense_cap=None, stride=1):
    out = jax_persistent_solve(
        ps, jnp.asarray(x), (0.0, 1.0), rtol=rtol, atol=rtol,
        saveat_arr=jnp.asarray([0.5, 1.0]), max_steps=64, record_knots=True,
        knot_dense_cap=dense_cap, knot_stride=stride, record_ks=False)
    return out


def _cts():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((2, B, F)).astype(np.float32),
            rng.standard_normal((B, F)).astype(np.float32))


def _compare_sweep(ours, ref):
    a_u, a_k, d_w = ours
    np.testing.assert_allclose(a_u.numpy(), np.asarray(ref[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a_k.numpy(), np.asarray(ref[1]), rtol=1e-4, atol=1e-5)
    for a, b in zip(d_w, _jparams_as_list(ref[2])):
        _close_rel(a.numpy(), b, 1e-4)


def test_plain_dense_sweep_matches_jax_kernel():
    ps, w, x = _weights(seed=5)
    rec = _jax_recorded(ps, x, 1e-4)
    ct_ys, ct_y = _cts()
    saveat = jnp.asarray([0.5, 1.0])
    ref = jax_stored_sweep(ps, rec["knot_ts"], rec["knot_us"], rec["naccept"],
                           saveat, jnp.asarray(ct_ys), jnp.asarray(ct_y))
    # the JAX kernel's knots are padded to 128 lanes; the port's are not
    ours = persistent_stored_sweep(
        w, torch.tensor(np.asarray(rec["knot_ts"])),
        torch.tensor(np.asarray(rec["knot_us"])[:, :, :F]),
        torch.tensor(int(rec["naccept"])), torch.tensor([0.5, 1.0]),
        torch.tensor(ct_ys), torch.tensor(ct_y))
    _compare_sweep(ours, ref)


def test_plain_two_level_sweep_matches_jax_kernel():
    """A solve longer than the dense capacity: both replay every window from
    the same (JAX-recorded) checkpoints and sweep it. Each replay runs its
    own arithmetic, whose f32 noise in the error estimate moves dt by up to
    a percent against the JAX forward, so the two sweeps agree to 2e-3 of
    the largest value (measured 7e-4), not to rounding."""
    ps, w, x = _weights(seed=6)
    W = 4
    rec = _jax_recorded(ps, x, 1e-5, dense_cap=3, stride=W)
    n = int(rec["naccept"])
    assert n > 3
    ct_ys, ct_y = _cts()
    saveat = jnp.asarray([0.5, 1.0])
    ref = jax_two_level_sweep(
        ps, rec["knot_ts"], rec["knot_us"], rec["naccept"], saveat,
        jnp.asarray(ct_ys), jnp.asarray(ct_y), rec["ckpt_ts"], rec["ckpt_us"],
        rec["ckpt_ks"], rec["ckpt_dts"], rec["ckpt_qolds"], t_end=1.0,
        rtol=1e-5, atol=1e-5, max_steps=64, stride=W, dense_cap=3)
    t = lambda k: torch.tensor(np.asarray(rec[k]))  # noqa: E731
    tu = lambda k: torch.tensor(np.asarray(rec[k])[:, :, :F])  # noqa: E731
    a_u, a_k, d_w = persistent_two_level_sweep(
        w, t("knot_ts"), tu("knot_us"), torch.tensor(n),
        torch.tensor([0.5, 1.0]), torch.tensor(ct_ys), torch.tensor(ct_y),
        t("ckpt_ts"), tu("ckpt_us"), tu("ckpt_ks"), t("ckpt_dts"),
        t("ckpt_qolds"), t_end=1.0, rtol=1e-5, atol=1e-5, max_steps=64,
        stride=W, dense_cap=3)
    for a, b in zip([a_u, a_k, *d_w],
                    [ref[0], ref[1], *_jparams_as_list(ref[2])]):
        _close_rel(a.numpy(), b, 2e-3)


def test_plain_two_level_equals_dense_on_own_forward():
    """Against its own plain forward the plain replay repeats every accept,
    so the windowed sweep equals the dense one bitwise."""
    from localregneuralde_tpu_torch.ops.cuda import persistent_tsit5_solve

    _, w, x = _weights(seed=6)
    saveat = torch.tensor([0.5, 1.0])
    fwd = persistent_tsit5_solve(
        w, torch.tensor(x), (0.0, 1.0), rtol=1e-5, atol=1e-5,
        saveat_arr=saveat, max_steps=64, record_knots=True, knot_stride=4)
    assert int(fwd["naccept"]) > 4
    ct_ys, ct_y = (torch.tensor(a) for a in _cts())
    dense = persistent_stored_sweep(w, fwd["knot_ts"], fwd["knot_us"],
                                    fwd["naccept"], saveat, ct_ys, ct_y)
    win = persistent_two_level_sweep(
        w, fwd["knot_ts"], fwd["knot_us"], fwd["naccept"], saveat, ct_ys,
        ct_y, fwd["ckpt_ts"], fwd["ckpt_us"], fwd["ckpt_ks"], fwd["ckpt_dts"],
        fwd["ckpt_qolds"], t_end=1.0, rtol=1e-5, atol=1e-5, max_steps=64,
        stride=4, dense_cap=3)
    for a, b in zip([win[0], win[1], *win[2]], [dense[0], dense[1], *dense[2]]):
        assert torch.equal(a, b)


# ---------------------------------------------------------- stored adjoint

def _small_problem():
    rng = np.random.default_rng(0)
    w = (0.5 * rng.standard_normal((4, 4))).astype(np.float32)
    b = np.zeros(4, np.float32)
    u0 = rng.standard_normal(4).astype(np.float32)
    return u0, w, b


def _jax_f(u, t, p):
    return jnp.tanh(p["w"] @ u + p["b"]) - 0.5 * u


def _torch_f(u, t, params):
    w, b = params
    return torch.tanh(w @ u + b) - 0.5 * u


def _port_grads(u0, w, b, saveat, loss_of, **kw):
    u0_, w_, b_ = (torch.tensor(a, requires_grad=True) for a in (u0, w, b))
    sol = stored_odesolve(_torch_f, u0_, (0.0, 1.0), [w_, b_],
                          saveat=torch.tensor(saveat), **kw)
    loss = loss_of(sol)
    loss.backward()
    return float(loss), u0_.grad.numpy(), w_.grad.numpy(), b_.grad.numpy()


def test_stored_adjoint_matches_jax():
    """test_stored_adjoint.py:41 on the port: saveat cotangents, the u0
    pass-through at t0 and y_final, against JAX's stored adjoint."""
    u0, w, b = _small_problem()
    saveat = np.array([0.0, 0.4, 1.0], np.float32)
    kw = dict(rtol=1e-7, atol=1e-9, max_steps=128)

    def jloss(u0, p):
        sol = jax_odesolve(_jax_f, u0, (0.0, 1.0), p, saveat=jnp.asarray(saveat),
                           adjoint="stored", **kw)
        return (jnp.sum(sol.y_final ** 2) + jnp.sum(sol.ys[1] ** 2)
                + jnp.sum(sol.ys[0]))

    gu, gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u0),
                                             {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    loss, ou, ow, ob = _port_grads(
        u0, w, b, saveat,
        lambda s: (s.y_final ** 2).sum() + (s.ys[1] ** 2).sum() + s.ys[0].sum(),
        **kw)
    np.testing.assert_allclose(loss, float(jloss(jnp.asarray(u0), {"w": jnp.asarray(w), "b": jnp.asarray(b)})), rtol=1e-5)
    np.testing.assert_allclose(ou, np.asarray(gu), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ow, np.asarray(gp["w"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ob, np.asarray(gp["b"]), rtol=1e-4, atol=1e-6)


def test_two_level_matches_dense_in_port():
    """test_stored_adjoint.py:195 on the port: knot_window 7 replays every
    window; the replay repeats the forward's arithmetic, so gradients agree
    with the dense sweep (rtol 1e-5) and the primal is identical."""
    u0, w, b = _small_problem()
    saveat = np.array([0.0, 0.37, 0.81, 1.0], np.float32)

    def loss_of(s):
        return (s.y_final ** 2).sum() + (s.ys[1] ** 2).sum() + (s.ys[2] * s.ys[0]).sum()

    kw = dict(rtol=1e-7, atol=1e-9, max_steps=128)
    dense = _port_grads(u0, w, b, saveat, loss_of, knot_window=128, **kw)
    windowed = _port_grads(u0, w, b, saveat, loss_of, knot_window=7, **kw)
    assert dense[0] == windowed[0]
    for a, c in zip(dense[1:], windowed[1:]):
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)


def test_truncated_solve_routes_uncovered_saveat_grads_to_u0():
    """test_stored_adjoint.py:263 on the port."""
    u0, w, b = _small_problem()
    _, gu, _, _ = _port_grads(u0, w, b, np.array([0.5, 1.0], np.float32),
                              lambda s: s.ys.sum(), rtol=1e-12, atol=1e-14,
                              max_steps=2)
    np.testing.assert_allclose(gu, 2.0, rtol=1e-6)
