"""The port's remaining SDE solvers against the JAX package: the commutative
Milstein step (diagonal and matrix noise), Lamba–Euler–Heun, the direct
adjoint, matrix-noise ``NeuralDSDE`` and the score sampler's solvers, on
numpy-seeded inputs at small size (ports of the Milstein and Euler–Heun
cases of ``tests/test_sde.py``, ``tests/test_sde_nondiag.py`` and the
solver cases of ``tests/test_score_sde.py``).

JAX's draws are injected through the port's hooks (the tree's normal
source, t1, the regulariser's normals; ``tests/test_torch_sde_train.py``).
Tolerances: one step with the same increments to 1e-6; whole stochastic
solves to 2e-3 of the largest value (Hölder-½ paths: a one-ulp shift of a
step time moves the Brownian path by ~2e-4, ROADMAP Queue 3); gradients
swept over the same recorded knots to 1e-5. The Milstein step's
finite-difference ggprime, ``(g(K + √dt·L) − L)/√dt``, amplifies float32
rounding: on these shapes the port's own float32 Milstein solve differs
from its float64 solve by 2.5e-3 of the largest value (6e-2 where one
reject flips), so whole Milstein solves are held to 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.harness import ExperimentConfig as JConfig
from localregneuralde_tpu.harness.construct import (
    construct_model as jax_construct_model,
)
from localregneuralde_tpu.models.neural_sde import NeuralDSDE as JNeuralDSDE
from localregneuralde_tpu.nn import Chain as JChain
from localregneuralde_tpu.nn import Dense as JDense
from localregneuralde_tpu.sde import sdesolve as jax_sdesolve
from localregneuralde_tpu.sde import step as jstep
from localregneuralde_tpu_torch.harness import (
    ExperimentConfig,
    construct_model,
)
from localregneuralde_tpu_torch.models import NeuralDSDE, neural_sde
from localregneuralde_tpu_torch.nn import Chain, Dense
from localregneuralde_tpu_torch.parity import load_jax_params, numpy_tree
from localregneuralde_tpu_torch.sde import PhiloxNormals, VirtualBrownianTree
from localregneuralde_tpu_torch.sde import sdesolve, step as tstep
from localregneuralde_tpu_torch.sde.stored_adjoint import (
    autograd_step_vjp,
    eager_sde_sweep,
)
from test_torch_sde import xla_tree_source

MILSTEIN_REL = 1e-2


def _tol(solver):
    """rtol = atol of the solves here: Milstein's error estimate (the
    scaled step difference, a reference quirk kept as is) takes ~3x the
    steps of the others at a tolerance, so it runs looser."""
    return 0.3 if solver == "milstein" else 0.1

MU = 0.5
SIGMA = np.array([0.3, 0.2], np.float32)
D, M = 2, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_rel(ours, ref, rel):
    ours, ref = np.asarray(ours), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert float(np.abs(ours - ref).max()) <= rel * scale


# ------------------------------------------------------------------ steps

def _mlp_params(seed, d, h, m=1):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"drift": {"layer_0": {"w": 0.4 * n(d, h), "b": 0.1 * n(h)},
                      "layer_1": {"w": 0.4 * n(h, d), "b": 0.1 * n(d)}},
            "diffusion": {"w": 0.2 * n(d, d * m), "b": 0.1 + 0.05 * n(d * m)}}


def _fg(xp, p, m=None):
    """Drift and diffusion of ``p`` in numpy-like ``xp`` (jnp or torch)."""
    tanh = jnp.tanh if xp is jnp else torch.tanh

    def f(u, t, *_):
        d = p["drift"]
        return tanh(u @ d["layer_0"]["w"] + d["layer_0"]["b"]) \
            @ d["layer_1"]["w"] + d["layer_1"]["b"]

    def g(u, t, *_):
        y = u @ p["diffusion"]["w"] + p["diffusion"]["b"]
        return y if m is None else y.reshape(u.shape + (m,))

    return f, g


def _torch_tree(p):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in p.items()}


def _stateful(fn):
    return lambda u, t, p, st: (fn(u, t), st)


@pytest.mark.parametrize("case", ["milstein", "milstein_strat",
                                  "nondiag", "nondiag_strat", "euler_heun"])
def test_step_matches_jax_with_the_same_increments(case):
    """One step from the same (u, t, dt, dW): u_new and eest to 1e-6."""
    m = 3 if case.startswith("nondiag") else None
    p = _mlp_params(0, 6, 8, m or 1)
    rng = np.random.default_rng(1)
    u = (0.5 * rng.standard_normal((4, 6))).astype(np.float32)
    dt = np.float32(0.05)
    dW = (np.sqrt(dt) * rng.standard_normal((4, m or 6))).astype(np.float32)
    jf, jg = _fg(jnp, numpy_tree(p), m)
    tf, tg = _fg(torch, _torch_tree(p), m)
    interp = "stratonovich" if case.endswith("strat") else "ito"
    args_j = (_stateful(jf), _stateful(jg), jnp.asarray(u), jnp.float32(0.3),
              jnp.asarray(dt), jnp.asarray(dW), None, None, None, 1e-2, 1e-2)
    args_t = (tf, tg, torch.tensor(u), torch.tensor(0.3), torch.tensor(dt),
              torch.tensor(dW), 1e-2, 1e-2)
    if case == "euler_heun":
        ref = jstep.lamba_euler_heun_step(*args_j)
        ours = tstep.lamba_euler_heun_step(*args_t)
    elif m is None:
        ref = jstep.milstein_commute_step(*args_j, interpretation=interp)
        ours = tstep.milstein_commute_step(*args_t, interpretation=interp)
    else:
        ref = jstep.milstein_commute_step_nondiag(*args_j,
                                                  interpretation=interp)
        ours = tstep.milstein_commute_step_nondiag(*args_t,
                                                   interpretation=interp)
    np.testing.assert_allclose(ours.u_new.numpy(), np.asarray(ref.u_new),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(ours.eest), float(ref.eest), rtol=1e-6)
    want = ((3, 3) if case == "euler_heun" else
            (1, 1 + m) if m else (1, 2))
    assert (ref.nfe_drift, ref.nfe_diffusion) == want
    assert tstep.step_nfe("euler_heun" if case == "euler_heun"
                          else "milstein", m) == want


# ------------------------------------------------------------------ solves

@pytest.mark.parametrize("solver,tol,thresh", [("milstein", 5e-2, 2e-2),
                                               ("euler_heun", 1e-2, 2e-2)])
def test_sde_strong_accuracy_gbm(solver, tol, thresh):
    """tests/test_sde.py::test_sde_strong_accuracy_gbm on the port's
    Philox tree: against the exact geometric BM driven by the same tree
    (Itô for Milstein, Stratonovich for Euler–Heun), ten paths. The
    reference solves each path alone; here the ten are the rows of one
    solve, on the batch's shared grid."""
    mu_, sig = 0.5, 0.5
    ito = solver != "euler_heun"
    src = PhiloxNormals(3, 10, 1)
    sol = sdesolve(lambda u, t: mu_ * u, lambda u, t: sig * u,
                   torch.ones(10, 1), (0.0, 1.0), noise=src, rtol=tol,
                   atol=tol, solver=solver, max_steps=1024)
    assert bool(sol.success)
    w1 = VirtualBrownianTree(src, 0.0, 1.0).wz(1.0)[0].double()
    exact = torch.exp(mu_ - (sig ** 2 / 2 if ito else 0.0) + sig * w1)
    err = float((sol.y_final.double() - exact).abs().mean())
    assert err < thresh, err


@pytest.mark.parametrize("solver,m", [("milstein", None), ("milstein", 3),
                                      ("euler_heun", None)])
def test_whole_solve_matches_jax(solver, m):
    """The eager loop against JAX's XLA loop with JAX's tree injected (the
    matrix-noise tree of shape (B, m)): the same accepts, the rejects
    within one, each side's NFE its own attempts' count, and the states to
    2e-3 of their largest value. With matrix noise one attempt's eest sits
    at 1 to the last ulp (the channel sums round in another order in XLA;
    the two trajectories agree to 4e-7 for the first ten steps) and flips:
    after it the two take different grids, and the end states agree to
    5e-3 (measured 3.2e-3)."""
    B, d = 8, 6
    p = _mlp_params(2, d, 8, m or 1)
    u0 = (0.5 * np.random.default_rng(3).standard_normal((B, d))).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    jf, jg = _fg(jnp, numpy_tree(p), m)
    tf, tg = _fg(torch, _torch_tree(p), m)
    kw = dict(rtol=_tol(solver), atol=_tol(solver), solver=solver,
              max_steps=128)
    shape = (B, m) if m else None
    ref = jax_sdesolve(jf, jg, jnp.asarray(u0), (0.0, 1.0), None,
                       noise_key=key, adjoint="none", noise_shape=shape,
                       saveat=jnp.asarray([0.5, 1.0]), **kw)
    ours = sdesolve(tf, tg, torch.tensor(u0), (0.0, 1.0),
                    noise=xla_tree_source(key, shape or (B, d)),
                    noise_shape=shape, saveat=[0.5, 1.0], **kw)
    assert bool(ours.success) and int(ref.naccept) >= 3
    assert int(ours.naccept) == int(ref.naccept)
    assert abs(int(ours.nreject) - int(ref.nreject)) <= 1
    nf, ng = tstep.step_nfe(solver, m)
    for sol in (ours, ref):
        att = int(sol.naccept) + int(sol.nreject)
        assert (int(sol.nfe_drift), int(sol.nfe_diffusion)) == (
            1 + nf * att, ng * att)
    same = int(ours.nreject) == int(ref.nreject)
    _close_rel(ours.ys.numpy(), np.asarray(ref.ys), 2e-3 if same else 5e-3)


@pytest.mark.parametrize("solver,m", [("milstein", None), ("milstein", 3),
                                      ("euler_heun", None)])
def test_stored_sweep_on_jax_knots_matches_jax(solver, m):
    """The port's stored-adjoint sweep over JAX's recorded knots against
    JAX's stored-adjoint gradients (the same knots): parameters and u0 to
    1e-5 of the largest."""
    B, d = 8, 6
    p = _mlp_params(4, d, 8, m or 1)
    u0 = (0.5 * np.random.default_rng(5).standard_normal((B, d))).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    shape = (B, m) if m else None
    saveat = jnp.asarray([0.5, 1.0])
    kw = dict(rtol=_tol(solver), atol=_tol(solver), solver=solver,
              max_steps=128, noise_key=key, noise_shape=shape)
    ct = np.random.default_rng(6).standard_normal((2, B, d)).astype(
        np.float32)

    def jf(u, t, p_):
        return _fg(jnp, p_, m)[0](u, t)

    def jg(u, t, p_):
        return _fg(jnp, p_, m)[1](u, t)

    def jloss(u0_, p_):
        sol = jax_sdesolve(jf, jg, u0_, (0.0, 1.0), p_, adjoint="stored",
                           saveat=saveat, **kw)
        return jnp.sum(jnp.asarray(ct) * sol.ys)

    gu, gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u0), numpy_tree(p))
    rec = jax_sdesolve(jf, jg, jnp.asarray(u0), (0.0, 1.0), numpy_tree(p),
                       adjoint="none", record_knots=True, saveat=saveat, **kw)
    names = [("drift", "layer_0", "w"), ("drift", "layer_0", "b"),
             ("drift", "layer_1", "w"), ("drift", "layer_1", "b"),
             ("diffusion", "w"), ("diffusion", "b")]

    def get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    params = [torch.tensor(np.asarray(get(p, n))) for n in names]

    def unpack(ps):
        return {"drift": {"layer_0": {"w": ps[0], "b": ps[1]},
                          "layer_1": {"w": ps[2], "b": ps[3]}},
                "diffusion": {"w": ps[4], "b": ps[5]}}

    f = lambda u, t, ps: _fg(torch, unpack(ps), m)[0](u, t)  # noqa: E731
    g = lambda u, t, ps: _fg(torch, unpack(ps), m)[1](u, t)  # noqa: E731
    vjp = autograd_step_vjp(f, g, solver=solver, delta=1 / 6,
                            atol=_tol(solver), rtol=_tol(solver),
                            noise_shape=shape)
    knots = [torch.tensor(np.asarray(getattr(rec, k))) for k in
             ("knot_ts", "knot_us", "knot_dws", "knot_dzs")]
    a_u, d_p = eager_sde_sweep(vjp, params, *knots, int(rec.naccept),
                               torch.tensor(np.asarray(saveat)),
                               torch.tensor(ct), torch.zeros(B, d))
    _close_rel(a_u.numpy(), np.asarray(gu), 1e-5)
    for name, dp in zip(names, d_p):
        _close_rel(dp.numpy(), np.asarray(get(gp, name)), 1e-5)


def test_matrix_noise_tree_law_and_rejection_consistency():
    """The Philox tree for a noise shape that is not the state's, (B, m):
    W(1) ~ N(0, 1) per element and uncorrelated with Z; W(t) a pure
    function of t (a retried step sees the same path) and additive; a
    narrower batch's rows are a wider one's."""
    tree = VirtualBrownianTree(PhiloxNormals(4, 6, 3), 0.0, 1.0)
    assert tree.wz(0.5).shape == (2, 6, 3)
    assert torch.equal(tree.wz(0.37), tree.wz(0.37))
    w1, w2 = tree.wz(0.3), tree.wz(0.5)
    np.testing.assert_allclose(((w2 - w1) + w1).numpy(), w2.numpy(),
                               atol=1e-6)
    assert float(tree.wz(0.0).abs().max()) == 0.0
    ws = torch.stack([VirtualBrownianTree(PhiloxNormals(s, 16, 3), 0.0, 1.0)
                      .wz(1.0) for s in range(64)])
    w, z = ws[:, 0].reshape(-1), ws[:, 1].reshape(-1)
    assert abs(float(w.mean())) < 0.1 and abs(float(w.std()) - 1) < 0.1
    assert abs(float(np.corrcoef(w, z)[0, 1])) < 0.1
    narrow = VirtualBrownianTree(PhiloxNormals(4, 2, 3), 0.0, 1.0)
    assert torch.equal(narrow.wz(0.61), tree.wz(0.61)[:, :2])


# ------------------------------------------------ commutative matrix noise

def _fixed_step_final(u0, n, dWs, interpretation="ito"):
    """``n`` fixed Milstein steps over [0, 1] of the linear commutative
    system du_i = μ u_i dt + u_i Σ_j σ_j dW_j, paths batched."""
    def f(u, t):
        return MU * u

    def g(u, t):
        return u[..., :, None] * torch.tensor(SIGMA)[None, :]

    dt = torch.tensor(1.0 / n)
    u = u0
    for k in range(n):
        u = tstep.milstein_commute_step_nondiag(
            f, g, u, torch.tensor(0.0), dt, dWs[:, k], 1e-2, 1e-2,
            interpretation=interpretation).u_new
    return u


def _strong_error(n, seed, interpretation="ito", paths=256):
    u0 = torch.tensor([1.0, 2.0]).expand(paths, D)
    gen = torch.Generator().manual_seed(seed)
    dWs = torch.randn(paths, n, M, generator=gen) * (1.0 / n) ** 0.5
    u = _fixed_step_final(u0, n, dWs, interpretation)
    s2 = float(np.sum(SIGMA ** 2))
    exact = u0 * torch.exp((MU - 0.5 * s2)
                           + (torch.tensor(SIGMA) * dWs.sum(1)).sum(-1,
                                                                   keepdim=True))
    return float(torch.sqrt(((u - exact) ** 2).sum(-1)).mean())


def test_strong_order_one_on_commutative_matrix_noise():
    """tests/test_sde_nondiag.py: quartering dt cuts the strong error ~4x
    (slope ≥ 0.8 over two octaves, 256 paths)."""
    e16, e64, e256 = (_strong_error(n, 7) for n in (16, 64, 256))
    s1, s2 = np.log(e16 / e64) / np.log(4.0), np.log(e64 / e256) / np.log(4.0)
    assert e16 > e64 > e256 and s1 > 0.8 and s2 > 0.8, (e16, e64, e256)


def test_ito_correction_matters():
    """Without the Itô correction the scheme converges to the Stratonovich
    solution: the error against the Itô solution stays above 0.3 of the
    exp(|σ|²/2) gap."""
    e = _strong_error(256, 3, "stratonovich")
    s2 = float(np.sum(SIGMA ** 2))
    gap = float(np.linalg.norm(np.array([1.0, 2.0]) * np.exp(MU - 0.5 * s2)
                               * (np.exp(0.5 * s2) - 1.0)))
    assert e > 0.3 * gap


def test_sdesolve_nondiag_plumbs_and_counts_nfe():
    """1 drift + (1 + m) diffusion evaluations an attempt; a non-Milstein
    solver refuses matrix noise."""
    u0 = torch.ones(4, D)

    def g(u, t):
        return u[..., :, None] * torch.tensor(SIGMA)[None, :]

    sol = sdesolve(lambda u, t: MU * u, g, u0, (0.0, 1.0),
                   noise=PhiloxNormals(0, 4, M), rtol=1e-1, atol=1e-1,
                   solver="milstein", max_steps=256, noise_shape=(4, M))
    assert bool(sol.success) and torch.isfinite(sol.y_final).all()
    att = int(sol.naccept) + int(sol.nreject)
    assert int(sol.nfe_drift) == 1 + att
    assert int(sol.nfe_diffusion) == att * (1 + M)
    with pytest.raises(ValueError):
        sdesolve(lambda u, t: MU * u, g, u0, (0.0, 1.0),
                 noise=PhiloxNormals(0, 4, M), solver="sri",
                 noise_shape=(4, M))


# ------------------------------------------------------------- NeuralDSDE

def _inject(monkeypatch, rng_key, shape, reg_shape, t0=0.0, t2=1.0):
    """Feed the port's NeuralDSDE the draws JAX's takes from ``rng_key``
    (its XLA loop's tree, t1 and the regulariser's normals)."""
    _, noise_key, tkey, _, wkey = jax.random.split(rng_key, 5)
    src = xla_tree_source(noise_key, shape)
    t1 = float(jax.random.uniform(tkey, (), jnp.float32, minval=t0,
                                  maxval=t2))
    kw, kz = jax.random.split(wkey)
    monkeypatch.setattr(neural_sde, "noise_source", lambda s, x, w=None: src)
    monkeypatch.setattr(neural_sde, "sample_t1", lambda g, a, b: t1)
    monkeypatch.setattr(
        neural_sde, "sample_reg_noise",
        lambda g, shape_: torch.tensor(np.stack([
            np.asarray(jax.random.normal(kw, tuple(reg_shape))),
            np.asarray(jax.random.normal(kz, tuple(reg_shape)))])))


def _dsde_pair(monkeypatch, *, solver, m, regularize, adjoint, d=6, h=8,
               b=4, use_pallas="off"):
    kw = dict(solver=solver, noise_dims=m, regularize=regularize,
              rtol=_tol(solver), atol=_tol(solver), max_steps=128,
              adjoint=adjoint)
    jnode = JNeuralDSDE(JChain(JDense(d, h, "tanh"), JDense(h, d)),
                        JDense(d, d * (m or 1)), **kw)
    ps, st = jnode.init(jax.random.PRNGKey(0))
    ps = numpy_tree(ps)
    x = (0.5 * np.random.default_rng(1).standard_normal((b, d))).astype(
        np.float32)

    def loss(p_, x_):
        sol, st_ = jnode(p_, st, x_, training=True)
        return (jnp.sum(jnp.tanh(sol.ys[-1])) + 10.0 * st_["reg_val"],
                (st_, sol.ys))

    (val, (jst, jys)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(ps, jnp.asarray(x))
    shape = (b, m) if m else (b, d)
    _inject(monkeypatch, st["rng"], shape, shape)
    node = NeuralDSDE(Chain(Dense(d, h, "tanh"), Dense(h, d)),
                      Dense(d, d * (m or 1)), use_pallas=use_pallas, **kw)
    load_jax_params(node, ps)
    xt = torch.tensor(x, requires_grad=True)
    sol, nst = node(xt, node.init_state(), training=True)
    tl = torch.sum(torch.tanh(sol.ys[-1])) + 10.0 * nst["reg_val"]
    tl.backward()
    return dict(node=node, sol=sol, nst=nst, jst=jst, val=float(val),
                jys=np.asarray(jys),
                tval=float(tl), gp=gp, gx=np.asarray(gx), tgx=xt.grad.numpy())


@pytest.mark.parametrize("solver,m,adjoint,regularize", [
    ("milstein", None, "stored", "unbiased"),
    ("milstein", 3, "stored", "none"), ("milstein", 3, "direct", "unbiased"),
    ("euler_heun", None, "stored", "unbiased"),
    ("sosri", None, "direct", "unbiased")])
def test_neural_dsde_training_matches_jax(solver, m, adjoint, regularize,
                                          monkeypatch):
    """NeuralDSDE training (test_sde.py::test_neural_dsde_matrix and
    test_sde_nondiag.py's NeuralDSDE cases) against JAX with its draws
    injected: NFE exact, the states to 2e-3 of the largest (Milstein:
    MILSTEIN_REL), reg_val to 3e-2 and the gradients to 1e-2 of the
    largest (tests/test_torch_sde_train.py)."""
    r = _dsde_pair(monkeypatch, solver=solver, m=m, regularize=regularize,
                   adjoint=adjoint)
    nst, jst = r["nst"], r["jst"]
    for k in ("nfe_drift", "nfe_diffusion"):
        assert int(nst[k]) == int(jst[k]), k
    _close_rel(r["sol"].ys.detach().numpy(), r["jys"],
               MILSTEIN_REL if solver == "milstein" else 2e-3)
    if regularize == "none":
        assert float(nst["reg_val"]) == 0.0
    else:
        np.testing.assert_allclose(float(nst["reg_val"]),
                                   float(jst["reg_val"]), rtol=3e-2)
    for name, p in r["node"].named_parameters():
        ref = r["gp"]
        for k in name.split("."):
            ref = ref[k]
        _close_rel(p.grad.numpy(), ref, 1e-2)
    _close_rel(r["tgx"], r["gx"], 1e-2)


@pytest.mark.parametrize("solver,m", [("milstein", 2), ("euler_heun", None)])
def test_neural_dsde_stored_matches_direct(solver, m):
    """test_sde_nondiag.py::test_neural_dsde_nondiag_stored_matches_direct:
    the two adjoints on the port's same forward (the same tree), rtol 1e-4
    / atol 1e-6."""
    d, b = 4, 3
    x = (0.5 * np.random.default_rng(1).standard_normal((b, d))).astype(
        np.float32)
    grads = []
    for adjoint in ("stored", "direct"):
        g = torch.Generator().manual_seed(0)
        node = NeuralDSDE(
            Chain(Dense(d, 8, "tanh", generator=g), Dense(8, d, generator=g)),
            Dense(d, d * (m or 1), generator=g), solver=solver, noise_dims=m,
            regularize="none", rtol=1e-1, atol=1e-1, max_steps=128,
            adjoint=adjoint)
        xt = torch.tensor(x, requires_grad=True)
        sol, _ = node(xt, node.init_state(), training=True)
        sol.ys[-1].sum().backward()
        grads.append([xt.grad.numpy()] + [p.grad.numpy()
                                          for p in node.parameters()])
    for a, c in zip(*grads):
        np.testing.assert_allclose(c, a, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("solver,m", [("milstein", 3), ("euler_heun", None)])
def test_regulariser_fence_and_route(solver, m):
    """The regulariser's gradient reaches the parameters only (∂reg/∂x ≡ 0,
    tests/test_sde.py::test_neural_dsde_matrix), and these solvers decline
    the persistent kernels, so a K-step call of them runs eagerly."""
    d = 4
    node = NeuralDSDE(Chain(Dense(d, 8, "tanh"), Dense(8, d)),
                      Dense(d, d * (m or 1)), solver=solver, noise_dims=m,
                      regularize="unbiased", rtol=_tol(solver),
                      atol=_tol(solver), max_steps=128,
                      use_pallas="on" if m is None else "auto")
    x = torch.randn(4, d, generator=torch.Generator().manual_seed(2),
                    requires_grad=True)
    sol, st = node(x, node.init_state(), training=True)
    assert sol.ys[-1].shape == (4, d) and float(st["reg_val"]) > 0.0
    assert node.kernel_mode() == (solver == "sosri")
    gx, *gp = torch.autograd.grad(st["reg_val"], [x, *node.parameters()],
                                  allow_unused=True)
    assert gx is None or float(gx.abs().max()) == 0.0
    flat = torch.cat([g.reshape(-1) for g in gp if g is not None])
    assert torch.isfinite(flat).all() and bool((flat != 0).any())
    assert not node.uses_kernels(x) and not node.persistent_step(4, "cuda")


def test_nondiagonal_reachable_from_config():
    """test_sde_nondiag.py::test_nondiagonal_reachable_from_config:
    ``sde_noise_dims = 3`` and ``sde_solver = milstein`` build a
    matrix-diffusion NeuralDSDE (Dense(32, 32·3)) in both packages, and
    the port's model trains from JAX's parameters."""
    def cfg_of(cls):
        cfg = cls()
        cfg.model.model_type = "mlp"
        cfg.model.sde = True
        cfg.model.sde_solver = "milstein"
        cfg.model.sde_noise_dims = 3
        cfg.model.image_size = [8, 8]
        cfg.model.in_channels = 1
        cfg.model.solver.abstol = 1e-1
        cfg.model.solver.reltol = 1e-1
        cfg.model.solver.max_steps = 128
        return cfg

    jmodel = jax_construct_model(cfg_of(JConfig))
    ps, _ = jmodel.init(jax.random.PRNGKey(0))
    model = construct_model(cfg_of(ExperimentConfig), device="cpu")
    node = model.neural_dsde
    assert node.solver == "milstein" and node.noise_dims == 3
    assert node.diffusion.out_dim == 32 * 3
    load_jax_params(model, numpy_tree(ps))
    x = torch.rand(4, 8, 8, 1, generator=torch.Generator().manual_seed(1))
    y, st = model(x, model.init_state(), training=True)
    assert torch.isfinite(y).all()
    assert int(st["neural_dsde"]["nfe_diffusion"]) > 0
    y.sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


# ------------------------------------------------------------ score sampler

@pytest.mark.parametrize("solver", ["milstein", "euler_heun"])
def test_sample_vpsde_other_solvers_match_jax(solver, monkeypatch):
    """tests/test_score_sde.py's sampler with Milstein and Euler–Heun: the
    eager loop (kernel 11 serves SRI/SOSRI only) against JAX's, with JAX's
    u_init and tree injected: the same steps and NFE, samples to 1e-3 of
    the largest (tests/test_torch_score.py; Milstein: MILSTEIN_REL)."""
    from localregneuralde_tpu.models.score_sde import (
        VPSDE as JVPSDE, sample_vpsde as jax_sample_vpsde,
    )
    from localregneuralde_tpu_torch.models import VPSDE, sample_vpsde
    from localregneuralde_tpu_torch.models import score_sde
    from test_torch_score import _jax_params, _modules

    from test_torch_score import F

    B = 8
    params = _jax_params(6, scale=0.3)
    jmod, mod = _modules(params)
    key = jax.random.PRNGKey(7)
    key_init, key_noise = jax.random.split(key)
    tol = 0.2 if solver == "milstein" else 5e-2  # Milstein: fewer steps
    kw = dict(rtol=tol, atol=tol, solver=solver, max_steps=512,
              use_pallas=False)
    s_ref, ref = jax_sample_vpsde(
        None, (B, F), key, jax.tree_util.tree_map(jnp.asarray, params),
        score_module=jmod, sde=JVPSDE(0.1, 5.0), **kw)
    u_init = np.asarray(jax.random.normal(key_init, (B, F)))
    monkeypatch.setattr(score_sde, "sample_u_init",
                        lambda g, shape, device: torch.tensor(u_init))
    monkeypatch.setattr(score_sde, "noise_source",
                        lambda g, u: xla_tree_source(key_noise, (B, F)))
    s, ours = sample_vpsde(None, (B, F), torch.Generator(), score_module=mod,
                           sde=VPSDE(0.1, 5.0), device="cpu", **kw)
    assert bool(ours.success) and bool(ref.success)
    for k in ("naccept", "nreject", "nfe_drift", "nfe_diffusion"):
        assert int(getattr(ours, k)) == int(getattr(ref, k)), k
    _close_rel(s.numpy(), np.asarray(s_ref),
               MILSTEIN_REL if solver == "milstein" else 1e-3)


def test_vpsde_sampler_recovers_gaussian():
    """tests/test_score_sde.py::test_vpsde_sampler_recovers_gaussian with
    Euler–Heun on the port's Philox tree: N(2, 0.25) recovered. (Milstein's
    error estimate, the scaled step difference, takes ~1e3 attempts at this
    tolerance; its sampler is held against JAX's above.)"""
    solver = "euler_heun"
    from localregneuralde_tpu_torch.models import (
        gaussian_score_fn, sample_vpsde,
    )

    s, sol = sample_vpsde(gaussian_score_fn(mean=2.0, var=0.25), (1536,),
                          torch.Generator().manual_seed(0), rtol=5e-2,
                          atol=5e-2, max_steps=512, solver=solver,
                          device="cpu")
    assert bool(sol.success)
    assert abs(float(s.mean()) - 2.0) < 0.1
    assert abs(float(s.std()) - 0.5) < 0.1
