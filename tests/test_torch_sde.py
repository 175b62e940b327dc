"""The port's SDE solver modules against the JAX package, on the same
numpy-seeded inputs at the MNIST-SDE width (F = 32, H = 64) and a small
batch (B = 8).

JAX draws its Brownian tree with threefry and the port with Philox, so the
tests that compare paths inject JAX's normals into the port through the
tree's pluggable source: ``fold_in(key_w, node)`` normals for the XLA loop
(``sde/brownian.py``), and for the Pallas kernel in interpret mode its own
draw, ``normal(key(seed ^ node·-1640531527), (2B, 128))[:, :F]`` with the
seed of ``_derive_seed`` (the lanes padded to 128). The default Philox
source is checked on its own: its law, rejection consistency, additivity
and the uniform clamp.

Tolerances: one step's ``u_new`` and ``eest`` to 1e-6 (float32 products in
another order). Whole solves take the same accepts and rejects and reach
the same step times to 1e-6, but the Brownian path is only Hölder-1/2 in
t: the step times come from the controller's power of an error norm that
each side sums in its own order, and a one-ulp shift of a step time moves
W(t) by ~√(3e-8) ≈ 2e-4. So states, saveat outputs and knots agree to
2e-3 and increments to 5e-3 (measured up to 5.3e-4 and 2.0e-3). Sweeps run
on the same recorded knots and agree to 1e-5 of the largest gradient
(tests/test_sde_sweep.py holds the JAX kernel to its own XLA sweep at
2e-4); the stored adjoint, which includes its forward, to 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.ops.pallas.fused_sde_solve import (
    _bits_to_uniform,
    _derive_seed,
    _norm_icdf,
    persistent_sde_solve as jax_persistent_sde_solve,
)
from localregneuralde_tpu.ops.pallas.fused_sde_sweep import (
    persistent_sde_sweep as jax_persistent_sde_sweep,
)
from localregneuralde_tpu.sde import VirtualBrownianTree as JTree
from localregneuralde_tpu.sde import sdesolve as jax_sdesolve
from localregneuralde_tpu.sde.step import sri_step as jax_sri_step
from localregneuralde_tpu.sde.stored_adjoint import (
    stored_sdesolve as jax_stored_sdesolve,
)
from localregneuralde_tpu.sde.tableaus import get_sri_tableau as jax_tableau
from localregneuralde_tpu_torch.ops.cuda import (
    SDEWeights,
    launch_counts,
    persistent_sde_solve,
    persistent_sde_solve_plain,
    persistent_sde_sweep,
    persistent_sde_sweep_plain,
)
from localregneuralde_tpu_torch.ops.cuda.fused_sde_solve import (
    diffusion_plain,
    drift_plain,
)
from localregneuralde_tpu_torch.sde import (
    PhiloxNormals,
    VirtualBrownianTree,
    get_sri_tableau,
    sdesolve,
    sri_step,
)
from localregneuralde_tpu_torch.sde.brownian import (
    bits_to_uniform,
    norm_icdf,
    philox4x32,
)
from localregneuralde_tpu_torch.sde.stored_adjoint import (
    autograd_step_vjp,
    eager_sde_sweep,
)

B, F, H = 8, 32, 64
TOL = 0.14  # experiments/mnist_sde/mlp.yaml
STATE_TOL, NOISE_TOL = 2e-3, 5e-3


def _params(seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {
        "drift": {"layer_0": {"w": 0.3 * n(F, H), "b": 0.1 * n(H)},
                  "layer_1": {"w": 0.3 * n(H, F), "b": 0.1 * n(F)}},
        "diffusion": {"w": 0.05 * n(F, F), "b": 0.01 + 0.01 * n(F)},
    }


def _weights(ps):
    d, g = ps["drift"], ps["diffusion"]
    return SDEWeights(*(torch.tensor(a) for a in (
        d["layer_0"]["w"], d["layer_0"]["b"], d["layer_1"]["w"],
        d["layer_1"]["b"], g["w"], g["b"])))


def _jf(u, t, p):
    d = p["drift"]
    return jnp.tanh(u @ d["layer_0"]["w"] + d["layer_0"]["b"]) \
        @ d["layer_1"]["w"] + d["layer_1"]["b"]


def _jg(u, t, p):
    return u @ p["diffusion"]["w"] + p["diffusion"]["b"]


def _x(seed=1, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal((B, F))
            ).astype(np.float32)


def xla_tree_source(noise_key, shape=(B, F)):
    """The JAX XLA loop's tree normals as a port source."""
    key_w, _ = jax.random.split(jax.random.fold_in(noise_key, 7))

    def normals(node):
        x = jax.random.normal(jax.random.fold_in(key_w, node), (2,) + shape)
        return torch.tensor(np.asarray(x))

    return normals


def pallas_interpret_source(noise_key, rows=B, cols=F):
    """The JAX Pallas kernel's interpret-mode normals as a port source."""
    seed = _derive_seed(noise_key)

    def normals(node):
        s = seed ^ (jnp.int32(node) * jnp.int32(-1640531527))
        x = jax.random.normal(jax.random.key(s.astype(jnp.uint32)),
                              (2 * rows, 128), jnp.float32)[:, :cols]
        return torch.tensor(np.asarray(x).reshape(2, rows, cols))

    return normals


def _close(ours, ref, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=msg)


# ------------------------------------------------------------------ step

@pytest.mark.parametrize("solver", ["sri", "sosri"])
def test_tableaus_match_jax(solver):
    ours, ref = get_sri_tableau(solver), jax_tableau(solver)
    names = [n for n in dir(ref) if n[0] in "abc" and not n.startswith("__")]
    assert names and all(getattr(ours, n) == getattr(ref, n) for n in names)


@pytest.mark.parametrize("solver", ["sri", "sosri"])
def test_sri_step_matches_jax(solver):
    ps = _params()
    w = _weights(ps)
    x = _x()
    rng = np.random.default_rng(5)
    dt = np.float32(0.07)
    dW = (np.sqrt(dt) * rng.standard_normal((B, F))).astype(np.float32)
    dZ = (np.sqrt(dt) * rng.standard_normal((B, F))).astype(np.float32)
    ref = jax_sri_step(
        lambda u, t, p, st: (_jf(u, t, p), st),
        lambda u, t, p, st: (_jg(u, t, p), st), jnp.asarray(x),
        jnp.float32(0.3), jnp.float32(dt), jnp.asarray(dW), jnp.asarray(dZ),
        ps, None, None, TOL, TOL, 1 / 6, tableau=jax_tableau(solver))
    ours = sri_step(lambda u, t: drift_plain(w, u),
                    lambda u, t: diffusion_plain(w, u), torch.tensor(x),
                    torch.tensor(0.3), torch.tensor(dt), torch.tensor(dW),
                    torch.tensor(dZ), TOL, TOL, 1 / 6, get_sri_tableau(solver))
    _close(ours.u_new, ref.u_new, 1e-6)
    _close(float(ours.eest), float(ref.eest), 1e-6, 1e-6)


# ------------------------------------------------------------------ noise

@pytest.mark.parametrize("t", [0.0, 0.3, 0.731, 1.0])
def test_tree_with_jax_source_matches_jax(t):
    key = jax.random.PRNGKey(3)
    ref = JTree(key, 0.0, 1.0, (B, F)).wz(jnp.float32(t))
    ours = VirtualBrownianTree(xla_tree_source(key), 0.0, 1.0).wz(
        torch.tensor(t))
    _close(ours[0], ref[0], 1e-6)
    _close(ours[1], ref[1], 1e-6)


def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors (Salmon et al., Random123)."""
    M = 0xFFFFFFFF
    cases = [
        ((0, 0, 0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((M,) * 6, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822,
          0x299F31D0), (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for args, want in cases:
        assert tuple(int(x) for x in philox4x32(*args)) == want


def test_default_source_law_and_layout():
    src = PhiloxNormals(11, 256, F)
    z = torch.cat([src(n).reshape(-1) for n in range(1, 9)])
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01
    w, zc = src(5)
    assert abs(float(np.corrcoef(w.reshape(-1), zc.reshape(-1))[0, 1])) < 0.03
    # a pure function of (seed, node, channel, row, column): the first rows
    # of a wider batch are the rows of a narrow one, and other seeds differ
    assert torch.equal(PhiloxNormals(11, 8, F)(5), src(5)[:, :8])
    assert torch.equal(src(5), PhiloxNormals(11, 256, F)(5))
    assert not torch.equal(PhiloxNormals(12, 8, F)(5), src(5)[:, :8])


def test_default_tree_rejection_consistent_and_additive():
    """The port of tests/test_sde.py:14-42 on the Philox source."""
    tree = VirtualBrownianTree(PhiloxNormals(2, B, F), 0.0, 1.0)
    assert torch.equal(tree.wz(0.5), tree.wz(0.5))
    w1, w2, w3 = tree.wz(0.3), tree.wz(0.5), tree.wz(0.0)
    assert float(w3.abs().max()) == 0.0
    _close((w2 - w1) + (w1 - w3), w2, 1e-6)
    ws = torch.stack([VirtualBrownianTree(PhiloxNormals(s, 4, 4), 0.0, 1.0)
                      .wz(1.0) for s in range(100)])
    w, z = ws[:, 0].reshape(-1), ws[:, 1].reshape(-1)
    assert abs(float(w.mean())) < 0.15 and abs(float(w.std()) - 1) < 0.15
    assert abs(float(np.corrcoef(w, z)[0, 1])) < 0.15


def _level_by_level_wz(tree, t):
    """The tree's descent written level by level (draw, then combine, then
    step into the child), the order the CUDA kernel used before it walked
    the path first."""
    tau = tree.tau(t)
    half, quarter = np.float32(0.5), np.float32(0.25)
    wb = tree.normals(1) * float(np.sqrt(tree.span))
    wa = torch.zeros_like(wb)
    a, b, node = np.float32(0.0), np.float32(1.0), 1
    for _ in range(tree.depth):
        m = (a + b) * half
        scale = np.sqrt((b - a) * quarter * tree.span)
        wm = (wa + wb) * 0.5 + tree.normals(2 * node + 2) * float(scale)
        if tau >= m:
            wa, a, node = wm, m, 2 * node + 1
        else:
            wb, b, node = wm, m, 2 * node
    frac = (tau - a) / (b - a) if b > a else np.float32(0.0)
    return wa + (wb - wa) * float(frac)


@pytest.mark.parametrize("span", [(0.0, 1.0), (1e-3, 0.7)])
def test_tree_path_first_descent_is_bitwise_level_by_level(span):
    # τ = 0 and 1, τ exactly on a midpoint (the tau >= m edge: 0.5, 0.25,
    # 0.375 at span (0, 1)), and generic times
    t0, t1 = span
    tree = VirtualBrownianTree(PhiloxNormals(7, 5, 3), t0, t1)
    ts = [t0, t1, 0.5, 0.25, 0.375, 0.123456, t0 + 0.61 * (t1 - t0), 2.0]
    for t in ts:
        assert torch.equal(tree.wz(t), _level_by_level_wz(tree, t)), t
    shallow = VirtualBrownianTree(PhiloxNormals(3, 4, 4), t0, t1, depth=3)
    for t in ts:
        assert torch.equal(shallow.wz(t), _level_by_level_wz(shallow, t)), t


def test_uniform_clamp_and_icdf_match_jax():
    """tests/test_fused_sde.py:274 on the port: the clamp keeps every bit
    pattern inside (0, 1), and the transform is the JAX kernel's."""
    bits = torch.tensor([0x7FFFFFFF, 0xFFFFFFFF, 0, 0xFFFFFF00, 0x12345678])
    u = bits_to_uniform(bits)
    assert float(u.max()) < 1.0 and float(u.min()) > 0.0
    ref = _bits_to_uniform(jnp.asarray(bits.numpy().astype(np.uint32)
                                       .view(np.int32)))
    assert np.array_equal(u.numpy(), np.asarray(ref))
    p = torch.linspace(1e-7, 1 - 1e-7, 10001)
    _close(norm_icdf(p), _norm_icdf(jnp.asarray(p.numpy())), 1e-5, 1e-6)
    assert bool(torch.isfinite(norm_icdf(u)).all())


# ------------------------------------------------------------------ solves

def _jax_loop_uniforms(key, n):
    """The per-attempt uniforms of the JAX loop's reservoir."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(float(jax.random.uniform(sub, (), jnp.float32)))
    return torch.tensor(out)


@pytest.mark.parametrize("solver", ["sosri", "sri"])
def test_eager_sdesolve_matches_jax(solver):
    ps = _params(1)
    w = _weights(ps)
    x = _x(2)
    nk, rk = jax.random.PRNGKey(4), jax.random.PRNGKey(6)
    kw = dict(rtol=TOL, atol=TOL, solver=solver, max_steps=64)
    ref = jax_sdesolve(_jf, _jg, jnp.asarray(x), (0.0, 1.0), ps, noise_key=nk,
                       saveat=jnp.asarray([0.25, 0.5, 1.0]), adjoint="none",
                       record_knots=True, reservoir_key=rk, **kw)
    ours = sdesolve(lambda u, t: drift_plain(w, u),
                    lambda u, t: diffusion_plain(w, u), torch.tensor(x),
                    (0.0, 1.0), noise=xla_tree_source(nk),
                    saveat=torch.tensor([0.25, 0.5, 1.0]), record_knots=True,
                    reservoir=_jax_loop_uniforms(rk, 64), **kw)
    n = int(ref.naccept)
    assert n >= 3 and int(ours.naccept) == n
    assert int(ours.nreject) == int(ref.nreject)
    assert int(ours.nfe_drift) == int(ref.nfe_drift)
    assert int(ours.nfe_diffusion) == int(ref.nfe_diffusion)
    _close(ours.ys, ref.ys, STATE_TOL)
    _close(ours.y_final, ref.y_final, STATE_TOL)
    _close(ours.knot_ts, ref.knot_ts[: n + 1], 1e-6)
    _close(ours.knot_us, ref.knot_us[: n + 1], STATE_TOL)
    _close(ours.knot_dws, ref.knot_dws[:n], NOISE_TOL)
    _close(ours.knot_dzs, ref.knot_dzs[:n], NOISE_TOL)
    _close(float(ours.reservoir_t), float(ref.reservoir_t), 1e-6)
    _close(ours.reservoir_u, ref.reservoir_u, STATE_TOL)


@pytest.mark.parametrize("reservoir", [False, True])
def test_kernel_twin_matches_jax_pallas(reservoir):
    """The plain version of kernel 10 against the JAX Pallas kernel in
    interpret mode, with the kernel's interpret-mode noise injected."""
    ps = _params(2)
    w = _weights(ps)
    x = _x(3)
    nk, rk = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    saveat = np.asarray([0.5, 1.0], np.float32)
    kw = dict(rtol=TOL, atol=TOL, solver="sosri", delta=1 / 6, max_steps=48,
              record_knots=True)
    ref = jax_persistent_sde_solve(
        ps, jnp.asarray(x), (0.0, 1.0), noise_key=nk,
        saveat_arr=jnp.asarray(saveat),
        reservoir_key=rk if reservoir else None, **kw)
    uniforms = (torch.tensor(np.asarray(jax.random.uniform(rk, (48,))))
                if reservoir else None)
    ours = persistent_sde_solve_plain(
        w, torch.tensor(x), (0.0, 1.0), noise=pallas_interpret_source(nk),
        saveat_arr=torch.tensor(saveat), reservoir=uniforms, **kw)
    n = int(ref["naccept"])
    assert n >= 3 and int(ours["naccept"]) == n
    assert int(ours["nreject"]) == int(ref["nreject"])
    assert 1 + 4 * int(ours["natt"]) == int(ref["nfe_drift"])
    _close(ours["ys"], ref["ys"], STATE_TOL)
    _close(ours["y_final"], ref["y_final"], STATE_TOL)
    _close(ours["knot_ts"], ref["knot_ts"][: n + 1], 1e-6)
    _close(ours["knot_us"], ref["knot_us"][: n + 1, :, :F], STATE_TOL)
    _close(ours["knot_dws"], ref["knot_dws"][:n, :, :F], NOISE_TOL)
    _close(ours["knot_dzs"], ref["knot_dzs"][:n, :, :F], NOISE_TOL)
    if reservoir:
        _close(float(ours["reservoir_t"]), float(ref["reservoir_t"]), 1e-6)
        _close(ours["reservoir_u"], ref["reservoir_u"], STATE_TOL)


def test_wrappers_run_plain_versions_on_cpu():
    ps = _params(3)
    w = _weights(ps)
    xt = torch.tensor(_x(4))
    before = launch_counts()
    kw = dict(noise=PhiloxNormals(9, B, F), rtol=TOL, atol=TOL,
              solver="sosri", delta=1 / 6, saveat_arr=torch.tensor([1.0]),
              max_steps=32, record_knots=True)
    a = persistent_sde_solve(w, xt, (0.0, 1.0), **kw)
    b = persistent_sde_solve_plain(w, xt, (0.0, 1.0), **kw)
    assert torch.equal(a["y_final"], b["y_final"])
    sweep = (a["knot_ts"], a["knot_us"], a["knot_dws"], a["knot_dzs"],
             a["naccept"], torch.tensor([1.0]), torch.ones(1, B, F),
             torch.ones(B, F))
    s1 = persistent_sde_sweep(w, *sweep, solver="sosri", delta=1 / 6)
    s2 = persistent_sde_sweep_plain(w, *sweep, solver="sosri", delta=1 / 6)
    assert torch.equal(s1[0], s2[0])
    assert launch_counts() == before


# ------------------------------------------------------------------ sweeps

def _jax_knots(solver, ps, x, saveat):
    """JAX's recorded forward (XLA loop): knots and increments."""
    sol = jax_sdesolve(_jf, _jg, jnp.asarray(x), (0.0, 1.0), ps,
                       noise_key=jax.random.PRNGKey(12), rtol=TOL, atol=TOL,
                       solver=solver, saveat=jnp.asarray(saveat),
                       max_steps=64, adjoint="none", record_knots=True)
    return sol


@pytest.mark.parametrize("solver", ["sosri", "sri"])
def test_sweeps_match_jax_on_the_same_knots(solver):
    """The plain version of kernel 12 and the eager sweep against the JAX
    kernel (interpret mode) and JAX's own VJP sweep, on JAX's knots."""
    ps = _params(4)
    w = _weights(ps)
    x = _x(5)
    saveat = np.asarray([0.4, 1.0], np.float32)
    sol = _jax_knots(solver, ps, x, saveat)
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
        solver=solver, delta=1 / 6)
    ref_w = _weights(jax.tree_util.tree_map(np.asarray, ref_dp))
    args = ([torch.tensor(k) for k in knots]
            + [torch.tensor(n), torch.tensor(saveat), torch.tensor(ct_ys),
               torch.tensor(ct_y)])
    twin_au, twin_w = persistent_sde_sweep_plain(w, *args, solver=solver,
                                                 delta=1 / 6)
    step_vjp = autograd_step_vjp(
        lambda u, t, p: drift_plain(SDEWeights(*p), u),
        lambda u, t, p: diffusion_plain(SDEWeights(*p), u), solver=solver,
        delta=1 / 6, atol=TOL, rtol=TOL)
    eager_au, eager_w = eager_sde_sweep(step_vjp, list(w), *args)
    for au, dw in ((twin_au, twin_w), (eager_au, eager_w)):
        scale = float(np.abs(np.asarray(ref_au)).max())
        _close(au, ref_au, 1e-5 * scale)
        for ours, ref in zip(dw, ref_w):
            _close(ours, ref, 1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("truncate", [False, True])
def test_stored_sdesolve_matches_jax(truncate):
    """Gradients of the stored adjoint against JAX's, both on the XLA
    loop's path; ``truncate`` runs out of max_steps, where the unwritten
    saveat entries carry their cotangent to u0."""
    from localregneuralde_tpu_torch.sde.stored_adjoint import stored_sdesolve

    ps = _params(5)
    x = _x(6)
    nk = jax.random.PRNGKey(13)
    max_steps = 3 if truncate else 64
    saveat = np.asarray([0.0, 0.5, 1.0], np.float32)

    def jloss(p, u0):
        sol = jax_stored_sdesolve(_jf, _jg, u0, (0.0, 1.0), p, noise_key=nk,
                                  rtol=TOL, atol=TOL, solver="sosri",
                                  saveat=jnp.asarray(saveat),
                                  max_steps=max_steps)
        wts = jnp.arange(1, sol.ys.size + 1, dtype=jnp.float32)
        return (jnp.sum(sol.ys * wts.reshape(sol.ys.shape)) * 1e-2
                + jnp.sum(jnp.tanh(sol.y_final))), sol.success

    (val, success), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(ps, jnp.asarray(x))
    assert bool(success) != truncate
    w = [p.requires_grad_() for p in _weights(ps)]
    u0 = torch.tensor(x, requires_grad=True)
    sol = stored_sdesolve(
        lambda u, t, p: drift_plain(SDEWeights(*p), u),
        lambda u, t, p: diffusion_plain(SDEWeights(*p), u), u0, (0.0, 1.0),
        w, noise=xla_tree_source(nk), rtol=TOL, atol=TOL, solver="sosri",
        saveat=torch.tensor(saveat), max_steps=max_steps)
    wts = torch.arange(1, sol.ys.numel() + 1, dtype=torch.float32)
    loss = (torch.sum(sol.ys * wts.reshape(sol.ys.shape)) * 1e-2
            + torch.sum(torch.tanh(sol.y_final)))
    loss.backward()
    _close(float(loss.detach()), float(val), STATE_TOL, STATE_TOL)
    _close(u0.grad, gx, STATE_TOL * float(jnp.abs(gx).max()))
    for ours, ref in zip(w, _weights(jax.tree_util.tree_map(np.asarray, gp))):
        _close(ours.grad, ref, STATE_TOL * float(ref.abs().max()))
