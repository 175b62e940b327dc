"""The port's remaining ODE solver modes against the JAX package: the
direct, interpolating and backsolve adjoints, the VCAB3/VCABM3 Adams
solvers and bfloat16 dynamics, on the same numpy-seeded inputs at small
size (a 4-state ODE, and ``NeuralODE`` with F = 32, H = 16, B = 8), with
the JAX parameters carried over by ``parity.py`` (ports of
``tests/test_gradients.py``, ``test_interp_adjoint.py``,
``test_backsolve.py`` and ``test_multistep.py``).

Tolerances: the direct adjoint's gradients against JAX's at rtol 1e-4 (as
``tests/test_torch_adjoint.py`` holds the stored adjoint), and against the
port's stored adjoint at rtol 1e-4; the continuous adjoints at the
reference's own gates, rtol 1e-3 / atol 1e-5; the Adams solutions at rtol
1e-5 with NFE exact. ``NeuralODE`` gradients with the unbiased regulariser
agree to 1e-3 of the largest (tests/test_torch_train.py: the regulariser
is a cancelling float32 sum), t1 injected through ``sample_t1``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.models import (
    NeuralODE as JNeuralODE,
    TDChain as JTDChain,
)
from localregneuralde_tpu.nn import Dense as JDense
from localregneuralde_tpu.ode import odesolve as jax_odesolve
from localregneuralde_tpu.ode.multistep import adams_solve as jax_adams
from localregneuralde_tpu_torch.models import NeuralODE, TDChain, neural_ode
from localregneuralde_tpu_torch.nn import Dense
from localregneuralde_tpu_torch.ode import adams_solve, odesolve
from localregneuralde_tpu_torch.parity import load_jax_params, numpy_tree

F, H, B = 32, 16, 8
SAVEAT = [0.4, 1.0]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other port tests on small shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_rel(ours, ref, rel):
    ours, ref = np.asarray(ours), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert float(np.abs(ours - ref).max()) <= rel * scale


# ----------------------------------------------------- a 4-state ODE


def _jf(u, t, p):
    return jnp.tanh(p["w"] @ u + p["b"]) - 0.5 * u


def _tf(u, t, ps):
    return torch.tanh(ps[0] @ u + ps[1]) - 0.5 * u


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    p = {"w": (0.5 * rng.standard_normal((4, 4))).astype(np.float32),
         "b": np.zeros(4, np.float32)}
    return rng.standard_normal(4).astype(np.float32), p


def _jax_grads(adjoint, u0, p, *, rtol=1e-7, atol=1e-9, saveat=SAVEAT,
               max_steps=128, loss=None):
    def jloss(u0_, p_):
        sol = jax_odesolve(_jf, u0_, (0.0, 1.0), p_, rtol=rtol, atol=atol,
                           max_steps=max_steps, adjoint=adjoint,
                           saveat=None if saveat is None
                           else jnp.asarray(saveat))
        return (loss or _loss)(sol, jnp)

    val, (gu, gp) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(u0), {k: jnp.asarray(v) for k, v in p.items()})
    return float(val), np.asarray(gu), {k: np.asarray(v) for k, v in gp.items()}


def _loss(sol, xp):
    return xp.sum(sol.y_final ** 2) + xp.sum(sol.ys[0] ** 2)


def _torch_grads(adjoint, u0, p, *, rtol=1e-7, atol=1e-9, saveat=SAVEAT,
                 max_steps=128, loss=None):
    ps = [torch.tensor(p["w"], requires_grad=True),
          torch.tensor(p["b"], requires_grad=True)]
    u = torch.tensor(u0, requires_grad=True)
    kw = dict(rtol=rtol, atol=atol, max_steps=max_steps, saveat=saveat,
              adjoint=adjoint)
    if adjoint == "direct":
        sol = odesolve(lambda x, t: _tf(x, t, ps), u, (0.0, 1.0), **kw)
    else:
        sol = odesolve(_tf, u, (0.0, 1.0), params=ps, **kw)
    val = (loss or _loss)(sol, torch)
    val.backward()
    return (float(val), u.grad.numpy(),
            {"w": ps[0].grad.numpy(), "b": ps[1].grad.numpy()}, sol)


def _fd(u0, p, e_u=None, e_w=None, eps=1e-3):
    """Central difference of the port's |u(1)|² (rtol 1e-6, 64 steps)
    along ``e_u`` or ``e_w``."""
    def val(sign):
        u = u0 + sign * eps * (0 if e_u is None else e_u)
        w = p["w"] + sign * eps * (0 if e_w is None else e_w)
        ps = [torch.tensor(w, dtype=torch.float32), torch.tensor(p["b"])]
        with torch.no_grad():
            sol = odesolve(lambda x, t: _tf(x, t, ps),
                           torch.tensor(u, dtype=torch.float32), (0.0, 1.0),
                           rtol=1e-6, atol=1e-8, max_steps=64)
        return float(torch.sum(sol.y_final ** 2))
    return (val(1) - val(-1)) / (2 * eps)


def _final_loss(sol, xp):
    return xp.sum(sol.y_final ** 2)


@pytest.mark.parametrize("what", ["u0", "params"])
def test_direct_gradients_match_jax_and_finite_differences(what):
    """tests/test_gradients.py: the direct adjoint's gradient of |u(1)|²
    (rtol 1e-6, 64 steps) against JAX's direct scan at rtol 1e-4 and
    against central differences at the reference's 2e-3."""
    u0, p = _setup()
    kw = dict(rtol=1e-6, atol=1e-8, max_steps=64, saveat=None,
              loss=_final_loss)
    _, gu, gp = _jax_grads("direct", u0, p, **kw)
    _, tu, tp, _ = _torch_grads("direct", u0, p, **kw)
    np.testing.assert_allclose(tu, gu, rtol=1e-4, atol=1e-6)
    for k in gp:
        np.testing.assert_allclose(tp[k], gp[k], rtol=1e-4, atol=1e-6)
    if what == "u0":
        for i in range(4):
            e = np.zeros(4, np.float32)
            e[i] = 1.0
            fd = _fd(u0, p, e_u=e)
            assert abs(tu[i] - fd) < 2e-3 * max(1.0, abs(fd))
    else:
        for idx in [(0, 0), (1, 2), (3, 3)]:
            e = np.zeros((4, 4), np.float32)
            e[idx] = 1.0
            fd = _fd(u0, p, e_w=e)
            assert abs(tp["w"][idx] - fd) < 2e-3 * max(1.0, abs(fd))


def test_direct_gradients_finite_through_controller():
    """tests/test_gradients.py::test_no_gradient_through_controller: dt
    and the error estimate are fenced, so the gradients are finite."""
    u0, p = _setup(3)
    _, tu, tp, sol = _torch_grads("direct", u0, p, rtol=1e-6, atol=1e-8,
                                  max_steps=64, saveat=None)
    assert np.isfinite(tu).all() and all(np.isfinite(v).all()
                                         for v in tp.values())
    assert bool(sol.success)


def test_direct_gradient_of_saveat_outputs():
    """tests/test_gradients.py::test_grad_of_saveat_outputs: a loss on an
    interior saveat output, against JAX's direct scan."""
    u0, p = _setup()

    def loss(sol, xp):
        return xp.sum(sol.ys[1] ** 2)

    kw = dict(rtol=1e-5, atol=1e-7, max_steps=64, saveat=[0.3, 0.7, 1.0],
              loss=loss)
    _, gu, gp = _jax_grads("direct", u0, p, **kw)
    _, tu, tp, _ = _torch_grads("direct", u0, p, **kw)
    np.testing.assert_allclose(tu, gu, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tp["w"], gp["w"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("adjoint", ["interpolating", "backsolve"])
def test_continuous_adjoint_matches_jax_and_direct(adjoint):
    """test_interp_adjoint.py / test_backsolve.py ``*_matches_direct``:
    the port's continuous adjoint against JAX's same mode and against the
    port's direct adjoint, at the reference's rtol 1e-3 / atol 1e-5."""
    u0, p = _setup()
    _, gu, gp = _jax_grads(adjoint, u0, p)
    _, du, dp, _ = _torch_grads("direct", u0, p)
    _, tu, tp, _ = _torch_grads(adjoint, u0, p)
    for ref in ((gu, gp), (du, dp)):
        np.testing.assert_allclose(tu, ref[0], rtol=1e-3, atol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_allclose(tp[k], ref[1][k], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("adjoint", ["interpolating", "backsolve"])
def test_continuous_adjoint_primal_identical_to_forward(adjoint):
    """``*_primal_identical_to_forward``: the forward is the adjoint='none'
    solve, bitwise, and its loss is JAX's."""
    u0, p = _setup()
    a = _torch_grads("direct", u0, p)[0]
    b = _torch_grads(adjoint, u0, p)[0]
    with torch.no_grad():
        ps = [torch.tensor(p["w"]), torch.tensor(p["b"])]
        sol = odesolve(lambda x, t: _tf(x, t, ps), torch.tensor(u0),
                       (0.0, 1.0), rtol=1e-7, atol=1e-9, max_steps=128,
                       saveat=SAVEAT, adjoint="none")
        c = float(_loss(sol, torch))
    assert a == b == c
    np.testing.assert_allclose(b, _jax_value(u0, p), rtol=1e-5)


def _jax_value(u0, p):
    sol = jax_odesolve(_jf, jnp.asarray(u0), (0.0, 1.0),
                       {k: jnp.asarray(v) for k, v in p.items()}, rtol=1e-7,
                       atol=1e-9, max_steps=128, saveat=jnp.asarray(SAVEAT),
                       adjoint="none")
    return float(_loss(sol, jnp))


def test_interpolating_dense_grid_matches_stored_49_points():
    """test_interp_adjoint.py's PhysioNet-like 49-point saveat grid: the
    interpolating adjoint against the stored adjoint (port), and against
    JAX's interpolating adjoint, at rtol 2e-3 / atol 1e-5."""
    rng = np.random.default_rng(5)
    p = {"w": (0.4 * rng.standard_normal((4, 4))).astype(np.float32),
         "b": np.full(4, 0.1, np.float32)}
    u0 = rng.standard_normal(4).astype(np.float32)
    grid = np.linspace(0.0, 1.0, 49).astype(np.float32)
    wts = np.arange(1.0, 50.0, dtype=np.float32)[:, None]

    def jf(u, t, q):
        return jnp.tanh(q["w"] @ u + q["b"]) - 0.4 * u

    def jloss(u0_, p_):
        sol = jax_odesolve(jf, u0_, (0.0, 1.0), p_, rtol=1e-6, atol=1e-8,
                           max_steps=128, saveat=jnp.asarray(grid),
                           adjoint="interpolating")
        return jnp.sum(wts * sol.ys ** 2)

    gu, gp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(u0), {k: jnp.asarray(v) for k, v in p.items()})

    def tf(u, t, ps):
        return torch.tanh(ps[0] @ u + ps[1]) - 0.4 * u

    out = {}
    for adjoint in ("stored", "interpolating"):
        ps = [torch.tensor(p["w"], requires_grad=True),
              torch.tensor(p["b"], requires_grad=True)]
        u = torch.tensor(u0, requires_grad=True)
        sol = odesolve(tf, u, (0.0, 1.0), params=ps, rtol=1e-6, atol=1e-8,
                       max_steps=128, saveat=torch.tensor(grid),
                       adjoint=adjoint)
        torch.sum(torch.tensor(wts) * sol.ys ** 2).backward()
        out[adjoint] = (u.grad.numpy(), ps[0].grad.numpy(), ps[1].grad.numpy())
    ti, si = out["interpolating"], out["stored"]
    for a, b in zip(ti, si):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-5)
    for a, b in zip(ti, (gu, gp["w"], gp["b"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-3, atol=1e-5)


# ------------------------------------------------------- NeuralODE


def _jax_t1(state, t0=0.0, t2=1.0):
    _, tkey, _ = jax.random.split(state["rng"], 3)
    return float(jax.random.uniform(tkey, (), jnp.float32, minval=t0,
                                    maxval=t2))


def _jax_reservoir(state, n):
    """The per-attempt uniforms of the JAX loops' reservoir."""
    _, _, key = jax.random.split(state["rng"], 3)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(float(jax.random.uniform(sub, (), jnp.float32)))
    return torch.tensor(out)


_JAX_RUNS = {}


def _jax_node_run(regularize, kw):
    """JAX's NeuralODE training value, state and gradients (cached: the
    port's routes are held against one JAX run)."""
    key = (regularize, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        jnode = JNeuralODE(JTDChain(JDense(F + 1, H, "tanh"),
                                    JDense(H + 1, F)),
                           regularize=regularize, **kw)
        ps, st = jnode.init(jax.random.PRNGKey(0))
        ps = numpy_tree(ps)
        x = (0.5 * np.random.default_rng(1).standard_normal((B, F))).astype(
            np.float32)

        def loss(p_, x_):
            sol, st_ = jnode(p_, st, x_, training=True)
            return jnp.sum(jnp.tanh(sol.ys[-1])) + 10.0 * st_["reg_val"], st_

        (val, jst), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(ps, jnp.asarray(x))
        _JAX_RUNS[key] = (ps, st, x, val, jst, gp, gx)
    return _JAX_RUNS[key]


def _node_pair(monkeypatch, regularize="unbiased", use_pallas="on", **kw):
    """JAX's NeuralODE training value and gradients, and the port's layer
    with JAX's parameters and draws (t1 or the reservoir) injected."""
    kw = dict(dict(rtol=3e-2, atol=3e-2, max_steps=32), **kw)
    ps, st, x, val, jst, gp, gx = _jax_node_run(regularize, kw)
    t1 = _jax_t1(st)
    res = _jax_reservoir(st, kw["max_steps"])
    monkeypatch.setattr(neural_ode, "sample_t1", lambda g, a, b: t1)
    monkeypatch.setattr(neural_ode, "sample_reservoir_uniforms",
                        lambda g, n: res[:n])
    node = NeuralODE(TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F)),
                     regularize=regularize, use_pallas=use_pallas, **kw)
    load_jax_params(node, {"model": ps["model"]})
    xt = torch.tensor(x, requires_grad=True)
    sol, nst = node(xt, node.init_state(), training=True)
    tl = torch.sum(torch.tanh(sol.ys[-1])) + 10.0 * nst["reg_val"]
    tl.backward()
    return dict(val=float(val), nfe=int(jst["nfe"]),
                reg=float(jst["reg_val"]), gp=gp["model"], gx=np.asarray(gx),
                tval=float(tl), tnfe=int(nst["nfe"]),
                treg=float(nst["reg_val"]), node=node, tgx=xt.grad.numpy())


def _check_node_pair(r, reg_rel=3e-2, grad_rel=1e-3):
    assert r["tnfe"] == r["nfe"]
    np.testing.assert_allclose(r["tval"], r["val"], rtol=1e-4)
    if r["reg"] != 0.0:
        np.testing.assert_allclose(r["treg"], r["reg"], rtol=reg_rel)
    for name, p in r["node"].model.named_parameters():
        layer, leaf = name.split(".")
        _close_rel(p.grad.numpy(), r["gp"][layer][leaf], grad_rel)
    _close_rel(r["tgx"], r["gx"], grad_rel)


@pytest.mark.parametrize("use_pallas", ["off", "on"])
@pytest.mark.parametrize("adjoint", ["direct", "interpolating", "backsolve"])
def test_neural_ode_adjoints_match_jax(adjoint, use_pallas, monkeypatch):
    """NeuralODE in unbiased training under each adjoint (JAX's XLA route
    against the port's plain route and its kernel route, whose wrappers
    run their plain versions here): NFE exact, the loss to 1e-4, reg_val
    to 3e-2 and the gradients to 1e-3 of the largest."""
    _check_node_pair(_node_pair(monkeypatch, adjoint=adjoint,
                                use_pallas=use_pallas))


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_direct_matches_stored_on_the_ports_forward(use_pallas):
    """The direct adjoint against the stored adjoint on the same forward
    (NFE equal), gradients at rtol 1e-4, without the regulariser."""
    rng = np.random.default_rng(2)
    x = (0.5 * rng.standard_normal((B, F))).astype(np.float32)
    grads, nfes = [], []
    for adjoint in ("stored", "direct"):
        g = torch.Generator().manual_seed(3)
        node = NeuralODE(
            TDChain(Dense(F + 1, H, "tanh", generator=g),
                    Dense(H + 1, F, generator=g)),
            regularize="none", adjoint=adjoint, use_pallas=use_pallas,
            rtol=1e-4, atol=1e-4, max_steps=64, saveat=[0.5, 1.0])
        xt = torch.tensor(x, requires_grad=True)
        sol, st = node(xt, node.init_state(), training=True)
        torch.sum(torch.tanh(sol.ys) * torch.arange(1.0, 3.0)[:, None, None]
                  ).backward()
        nfes.append(int(st["nfe"]))
        grads.append([xt.grad.numpy()] + [p.grad.numpy() for p in
                                          node.model.parameters()])
    assert nfes[0] == nfes[1]
    for a, b in zip(*grads):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)


# --------------------------------------------------------- Adams


def _vdp_j(u, t, p):
    return jnp.array([u[1], -u[0] - 0.1 * u[1] * (u[0] ** 2 - 1.0)])


def _vdp_t(u, t):
    return torch.stack([u[1], -u[0] - 0.1 * u[1] * (u[0] ** 2 - 1.0)])


@pytest.mark.parametrize("moulton", [False, True])
def test_adams_accuracy_matches_scipy_and_jax(moulton):
    """test_multistep.py::test_adams_accuracy_vs_scipy: the van der Pol
    solve at rtol 1e-6 against scipy at rtol 1e-4 / atol 1e-5 (the
    reference's gate), and JAX's at the same gate. This ODE's ũ is float32
    rounding noise (~1e-8 of u on its first steps), so XLA's fused
    arithmetic and the port's accept different dt sequences (NFE within a
    few of each other); NFE is held exact where ũ is above the noise, in
    ``test_adams_eval_matches_jax`` and the NeuralODE cases below. The
    first Tsit5 attempt is held to one float32 ulp: the same dt0 and
    step end."""
    from scipy.integrate import solve_ivp

    ref = solve_ivp(
        lambda t, u: np.array([u[1], -u[0] - 0.1 * u[1] * (u[0] ** 2 - 1)]),
        (0, 5), [1.0, 0.5], rtol=1e-10, atol=1e-12, t_eval=[2.5, 5.0])
    kw = dict(moulton=moulton, max_steps=1024, adjoint="none")
    sol = adams_solve(_vdp_t, torch.tensor([1.0, 0.5]), (0.0, 5.0),
                      saveat=[2.5, 5.0], rtol=1e-6, atol=1e-8, **kw)
    assert bool(sol.success)
    np.testing.assert_allclose(sol.ys.numpy(), ref.y.T, rtol=1e-4, atol=1e-5)
    jsol = jax_adams(_vdp_j, jnp.array([1.0, 0.5]), (0.0, 5.0), None,
                     saveat=jnp.array([2.5, 5.0]), rtol=1e-6, atol=1e-8, **kw)
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(jsol.ys),
                               rtol=1e-4, atol=1e-5)
    assert abs(int(sol.nfe) - int(jsol.nfe)) <= 6
    one = dict(kw, max_steps=1, rtol=1e-2, atol=1e-4)
    jsol = jax_adams(_vdp_j, jnp.array([1.0, 0.5]), (0.0, 5.0), None, **one)
    sol = adams_solve(_vdp_t, torch.tensor([1.0, 0.5]), (0.0, 5.0), **one)
    assert float(sol.t_final) == float(jsol.t_final)
    np.testing.assert_allclose(sol.y_final.numpy(), np.asarray(jsol.y_final),
                               rtol=1.2e-7)


def test_adams_gradients_match_jax():
    """test_multistep.py::test_adams_gradients: VCABM3's direct gradient
    against JAX's at rtol 1e-4 and against central differences."""
    def jloss(u0):
        sol = jax_adams(_vdp_j, u0, (0.0, 2.0), None, rtol=1e-5, atol=1e-7,
                        moulton=True, max_steps=256, adjoint="direct")
        return jnp.sum(sol.y_final ** 2)

    def tloss(u0):
        sol = adams_solve(_vdp_t, u0, (0.0, 2.0), rtol=1e-5, atol=1e-7,
                          moulton=True, max_steps=256, adjoint="direct")
        return torch.sum(sol.y_final ** 2)

    g = np.asarray(jax.grad(jloss)(jnp.array([1.0, 0.5])))
    u0 = torch.tensor([1.0, 0.5], requires_grad=True)
    tloss(u0).backward()
    np.testing.assert_allclose(u0.grad.numpy(), g, rtol=1e-4, atol=1e-6)
    eps = 1e-3
    with torch.no_grad():
        fd = (float(tloss(torch.tensor([1.0 + eps, 0.5])))
              - float(tloss(torch.tensor([1.0 - eps, 0.5])))) / (2 * eps)
    assert abs(float(u0.grad[0]) - fd) < 2e-3 * max(1.0, abs(fd))


@pytest.mark.parametrize("regularize", ["unbiased", "biased"])
@pytest.mark.parametrize("solver", ["vcab3", "vcabm3"])
def test_neural_ode_with_adams_solver_matches_jax(solver, regularize,
                                                  monkeypatch):
    """test_multistep.py's NeuralODE cases: the Adams solve under the
    direct adjoint with the Tsit5 regulariser step (biased: the reservoir
    rides the Adams loop), on the kernel route (plain versions here),
    against JAX, at rtol 3e-2 as the other regularised parities (at 1e-3
    the regulariser's gradient is float32 noise in both packages: without
    it the gradients there agree to 5e-6)."""
    r = _node_pair(monkeypatch, regularize=regularize, solver=solver,
                   max_steps=64)
    assert r["treg"] > 0.0
    _check_node_pair(r)


def test_biased_with_adams_accepted():
    """test_multistep.py::test_biased_with_adams_accepted."""
    NeuralODE(TDChain(Dense(3, 2)), regularize="biased", solver="vcab3")


def test_adams_eval_matches_jax():
    """Serving with VCABM3 (adjoint 'none'): the output and NFE of JAX's."""
    jnode = JNeuralODE(JTDChain(JDense(F + 1, H, "tanh"), JDense(H + 1, F)),
                       solver="vcabm3", rtol=1e-4, atol=1e-4, max_steps=64)
    ps, st = jnode.init(jax.random.PRNGKey(0))
    x = (0.5 * np.random.default_rng(1).standard_normal((B, F))).astype(
        np.float32)
    jsol, jst = jnode(numpy_tree(ps), st, jnp.asarray(x), training=False)
    node = NeuralODE(TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F)),
                     solver="vcabm3", rtol=1e-4, atol=1e-4, max_steps=64,
                     use_pallas="on")
    load_jax_params(node, {"model": numpy_tree(ps)["model"]})
    with torch.no_grad():
        sol, nst = node(torch.tensor(x), node.init_state())
    assert int(nst["nfe"]) == int(jst["nfe"])
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(jsol.ys),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- bfloat16


def test_bfloat16_dynamics_match_jax(monkeypatch):
    """compute_dtype='bfloat16' on the plain route, unbiased training at
    rtol 1e-3, against JAX's bfloat16 dynamics: both round u, the
    parameters and every layer output to bfloat16, each CPU with its own
    accumulation and rounding, so NFE is equal, the loss agrees to 1e-4
    and the gradients to 3e-2 of the largest (a few bfloat16 ulps, 7.8e-3
    each; measured 1.0e-2)."""
    r = _node_pair(monkeypatch, regularize="none", use_pallas="auto",
                   compute_dtype="bfloat16", rtol=1e-3, atol=1e-3)
    assert r["node"].use_pallas == "off"
    _check_node_pair(r, grad_rel=3e-2)


def test_bfloat16_refusals():
    """The reference's refusals: rtol < 1e-4 ('highest' precision) and the
    kernels ('on'); 'auto' declines to the plain route."""
    dyn = TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F))
    with pytest.raises(ValueError, match="rtol < 1e-4"):
        NeuralODE(dyn, compute_dtype="bfloat16", rtol=1e-5)
    with pytest.raises(ValueError, match="kernels"):
        NeuralODE(dyn, compute_dtype="bfloat16", rtol=1e-3, use_pallas="on")
    node = NeuralODE(dyn, compute_dtype="bfloat16", rtol=1e-3)
    assert node.use_pallas == "off" and not node.uses_kernels(torch.zeros(1))
    assert not node.persistent_step(8, "cuda")


@pytest.mark.parametrize("adjoint", ["direct", "interpolating", "backsolve"])
def test_neural_ode_adjoints_biased_match_jax(adjoint, monkeypatch):
    """The biased regulariser under each adjoint (the reservoir rides the
    adjoint's forward loop), kernel route, against JAX with its reservoir
    uniforms injected: as ``test_neural_ode_adjoints_match_jax``."""
    _check_node_pair(_node_pair(monkeypatch, regularize="biased",
                                adjoint=adjoint, max_steps=64))


def test_new_modes_decline_capture():
    """Every new mode accepts on the host, so no K-step call captures it:
    ``persistent_step`` and ``graph.capturable`` say no on a card, and
    auto-K is 1."""
    from localregneuralde_tpu_torch.harness.graph import capturable
    from localregneuralde_tpu_torch.harness.loop import (
        resolve_steps_per_call,
    )
    from localregneuralde_tpu_torch.nn import Chain

    modes = [dict(adjoint="direct"), dict(adjoint="interpolating"),
             dict(adjoint="backsolve"), dict(solver="vcab3"),
             dict(solver="vcabm3"), dict(compute_dtype="bfloat16")]
    for kw in modes:
        node = NeuralODE(TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F)),
                         rtol=1e-3, **kw)
        assert not node.persistent_step(512, "cuda"), kw
        assert not capturable(Chain(node=node), 512, "cuda"), kw
    stored = NeuralODE(TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F)),
                       rtol=1e-3)
    assert stored.persistent_step(512, "cuda")
    assert resolve_steps_per_call(0, 10, 10, capturable=False) == 1
