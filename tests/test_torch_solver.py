"""The port's solver modules against the JAX package: tableau, controller,
initial step, the eager adaptive loop and the persistent solve's plain
version, on the same numpy-seeded inputs at small size (F = 32, H = 16,
B = 8, as ``tests/test_persistent_solve.py``).

Tolerances follow ``tests/test_persistent_solve.py:67-87``: the error norm
is a cancelling sum whose reduction order differs between implementations,
so an ulp-level difference can flip a rare accept decision; trajectories
agree to solver accuracy and step counts within a band.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.core import ArrayAndTime as JAAT
from localregneuralde_tpu.models import TDChain as JTDChain
from localregneuralde_tpu.nn import Dense as JDense
from localregneuralde_tpu.ode.controller import (
    PIController as JPIController,
    initial_step_size as jax_initial_step_size,
)
from localregneuralde_tpu.ode.solve import odesolve as jax_odesolve
from localregneuralde_tpu.ode.tableaus import (
    Tsit5Tableau as JT,
    tsit5_interp_weights as jax_interp_weights,
)
from localregneuralde_tpu.ops.pallas.fused_solve import (
    persistent_tsit5_solve as jax_persistent_solve,
)
from localregneuralde_tpu_torch.core import ArrayAndTime
from localregneuralde_tpu_torch.models import TDChain
from localregneuralde_tpu_torch.nn import Dense
from localregneuralde_tpu_torch.ode import (
    PIController,
    Tsit5Tableau,
    initial_step_size,
    odesolve,
    tsit5_interp_weights,
)
from localregneuralde_tpu_torch.ops.cuda import (
    TDMLPWeights,
    persistent_tsit5_solve,
)
from localregneuralde_tpu_torch.parity import load_jax_params

F, H, B = 32, 16, 8
RTOL = ATOL = 1e-4


def _setup(seed=0):
    jtd = JTDChain(JDense(F + 1, H, "tanh"), JDense(H + 1, F))
    ps, st = jtd.init(jax.random.PRNGKey(seed))
    x = (0.5 * np.random.default_rng(seed + 1).standard_normal((B, F))).astype(
        np.float32
    )
    td = TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F))
    load_jax_params(td, ps)
    return jtd, ps, st, x, td


def _jax_dynamics(jtd):
    def f(u, t, p, s):
        y, s2 = jtd(p, s, JAAT(u, t))
        return y.array, s2

    return f


def _torch_dynamics(td):
    def f(u, t, st):
        y, st2 = td(ArrayAndTime(u, t), st)
        return y.array, st2

    return f


def _weights(td):
    l0, l1 = td.layers.values()
    return TDMLPWeights(l0.w.detach(), l0.b.detach(), l1.w.detach(), l1.b.detach())


def test_tableau_constants_match():
    names = [n for n in vars(JT) if not n.startswith("_")]
    assert names and all(getattr(Tsit5Tableau, n) == getattr(JT, n) for n in names)


def test_interp_weights_match():
    theta = np.linspace(0.0, 1.0, 11, dtype=np.float32)
    ours = tsit5_interp_weights(torch.tensor(theta))
    ref = jax_interp_weights(jnp.asarray(theta))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize(
    "eest,dt,qold",
    [(0.3, 0.05, 1e-4), (1.7, 0.2, 0.5), (0.0, 0.1, 0.9),
     (float("nan"), 0.1, 0.3), (float("inf"), 0.1, 0.3)],
)
def test_controller_propose_matches(eest, dt, qold):
    ours = PIController().propose(
        torch.tensor(eest), torch.tensor(dt), torch.tensor(qold)
    )
    ref = JPIController().propose(
        jnp.float32(eest), jnp.float32(dt), jnp.float32(qold)
    )
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("rtol", [1e-4, 1.4e-8])
def test_initial_step_size_matches(rtol):
    jtd, ps, st, x, td = _setup(seed=2)
    jf = _jax_dynamics(jtd)
    f0, _ = jf(jnp.asarray(x), jnp.float32(0.0), ps, st)
    ref, nfe = jax_initial_step_size(
        jf, jnp.asarray(x), jnp.float32(0.0), ps, st, order=5, rtol=rtol,
        atol=rtol, f0=f0,
    )
    tf = _torch_dynamics(td)
    with torch.no_grad():
        xt = torch.tensor(x)
        ours, n = initial_step_size(
            lambda u, t: tf(u, t, td.init_state())[0], xt, torch.tensor(0.0), order=5,
            rtol=rtol, atol=rtol, f0=tf(xt, 0.0, td.init_state())[0],
        )
    assert n == nfe
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)


def _compare(ours, ref, ys_atol=3e-4):
    np.testing.assert_allclose(
        ours["y_final"].numpy(), np.asarray(ref["y_final"]), atol=2e-4
    )
    np.testing.assert_allclose(ours["ys"].numpy(), np.asarray(ref["ys"]),
                               atol=ys_atol)
    assert abs(int(ours["naccept"]) - int(ref["naccept"])) <= 1
    assert abs(int(ours["nfe"]) - int(ref["nfe"])) <= 12
    assert bool(ours["success"]) == bool(ref["success"])
    np.testing.assert_allclose(
        float(ours["t_final"]), float(ref["t_final"]), atol=1e-6
    )


def _as_dict(sol):
    return {k: getattr(sol, k) for k in
            ("y_final", "ys", "naccept", "nfe", "success", "t_final")}


@pytest.mark.parametrize("seed,saveat", [
    (0, [1.0]), (3, [0.7, 0.1, 1.0, 0.0, 0.35]),
])
def test_odesolve_matches_jax_loop(seed, saveat):
    jtd, ps, st, x, td = _setup(seed)
    ref = jax_odesolve(
        _jax_dynamics(jtd), jnp.asarray(x), (0.0, 1.0), ps, rtol=RTOL,
        atol=ATOL, saveat=jnp.asarray(saveat), max_steps=64, adjoint="none",
        stateful=True, f_state=st,
    )
    with torch.no_grad():
        ours = odesolve(
            _torch_dynamics(td), torch.tensor(x), (0.0, 1.0), rtol=RTOL,
            atol=ATOL, saveat=saveat, max_steps=64, stateful=True,
            f_state=td.init_state(),
        )
    _compare(_as_dict(ours), _as_dict(ref))


@pytest.mark.parametrize("seed,saveat", [
    (0, [1.0]), (3, [0.7, 0.1, 1.0, 0.0, 0.35]),
])
def test_persistent_plain_matches_jax_persistent(seed, saveat):
    jtd, ps, st, x, td = _setup(seed)
    ref = jax_persistent_solve(
        ps, jnp.asarray(x), (0.0, 1.0), rtol=RTOL, atol=ATOL,
        saveat_arr=jnp.asarray(saveat), max_steps=64,
    )
    ours = persistent_tsit5_solve(
        _weights(td), torch.tensor(x), (0.0, 1.0), rtol=RTOL, atol=ATOL,
        saveat_arr=torch.tensor(saveat), max_steps=64,
    )
    _compare(ours, ref)


def test_max_steps_cap_matches_jax():
    """A truncated solve: success is False, NFE = 2 + 6·max_steps, and
    saveat times past the last accepted step report u0."""
    jtd, ps, st, x, td = _setup(seed=5)
    saveat = [0.05, 1.0]
    ref = jax_odesolve(
        _jax_dynamics(jtd), jnp.asarray(x), (0.0, 1.0), ps, rtol=1e-7,
        atol=1e-7, saveat=jnp.asarray(saveat), max_steps=3, adjoint="none",
        stateful=True, f_state=st,
    )
    with torch.no_grad():
        ours = odesolve(
            _torch_dynamics(td), torch.tensor(x), (0.0, 1.0), rtol=1e-7,
            atol=1e-7, saveat=saveat, max_steps=3, stateful=True,
            f_state=td.init_state(),
        )
    assert not bool(ref.success) and not bool(ours.success)
    assert int(ours.nfe) == int(ref.nfe) == 2 + 6 * 3
    assert int(ours.naccept) == int(ref.naccept)
    np.testing.assert_array_equal(ours.ys[1].numpy(), x)
    np.testing.assert_allclose(ours.ys[0].numpy(), np.asarray(ref.ys[0]),
                               atol=3e-4)
    # at rtol 1e-7 this f32 solve's ũ sits at rounding-noise level (|ũ| ~
    # 1e-9), so the noise moves each dt proposal by about a percent: the
    # truncation point t_final agrees to that (measured 0.3%), not to 1e-6
    np.testing.assert_allclose(float(ours.t_final), float(ref.t_final),
                               rtol=0.02)


def test_gradient_adjoints_are_not_ported():
    """The gradient adjoints are ported now: ``adjoint='direct'`` through
    ``odesolve`` is differentiable and its forward is the ``'none'``
    solve's, and an unknown adjoint is refused."""
    _, _, _, x, td = _setup()
    xt = torch.tensor(x, requires_grad=True)
    sol = odesolve(_torch_dynamics(td), xt, (0.0, 1.0), adjoint="direct",
                   stateful=True, f_state=td.init_state())
    with torch.no_grad():
        ref = odesolve(_torch_dynamics(td), torch.tensor(x), (0.0, 1.0),
                       stateful=True, f_state=td.init_state())
    assert torch.equal(sol.y_final.detach(), ref.y_final)
    assert int(sol.nfe) == int(ref.nfe)
    sol.y_final.sum().backward()
    assert torch.isfinite(xt.grad).all() and bool((xt.grad != 0).any())
    with pytest.raises(ValueError, match="adjoint"):
        odesolve(_torch_dynamics(td), torch.tensor(x), (0.0, 1.0),
                 adjoint="scan", stateful=True, f_state=td.init_state())
