"""The port's data-parallel layer (``localregneuralde_tpu_torch/parallel``)
on the CPU: two ranks over Gloo, each a spawned process
(``tests/torch_dp_worker.py``), against single-device steps in this process
and against the JAX package's ``make_shardmap_train_step`` and
``make_sharded_train_step`` on a two-device mesh.

- **Per-rank grid** ('shardmap'): the step is bitwise the mean of two
  single-device steps on the half batches with the same per-rank draws
  (``parallel.rank_state``), that manual estimator is held against JAX's
  shardmap step with JAX's per-shard draws injected (``sample_t1``), and
  the booleans' AND, the float NFE, the latent family's tuple ``w_reg`` and
  the EMA are checked.
- **Global grid** ('gspmd'): against the single-device step on the global
  batch and JAX's sharded step (the reductions add in another order, so
  these agree to the tolerances of ``tests/test_torch_train.py``: loss to
  1e-5, updates to 1e-3 of the largest), the regulariser's gradient alone,
  the solve's grid (accepts within one, NFE within 12, y at the solve's
  tolerance, as ``tests/test_parallel.py``), the K-step call bitwise K
  single calls, gradient accumulation and the EMA
  (``tests/test_parallel_grad_accum.py``, ``tests/test_parallel_ema.py``).
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.harness import (
    construct_loss as jax_construct_loss,
    construct_model as jax_construct_model,
    define_configuration as jax_define_configuration,
)
from localregneuralde_tpu.harness.construct import (
    construct_optimizer as jax_construct_optimizer,
)
from localregneuralde_tpu.harness.train import (
    create_train_state as jax_create_train_state,
    settle_state_shapes,
)
from localregneuralde_tpu.parallel import (
    make_mesh,
    make_sharded_train_step as jax_sharded_step,
    make_shardmap_train_step as jax_shardmap_step,
    shard_batch as jax_shard_batch,
    shard_train_state,
    train_state_shardings,
)
from localregneuralde_tpu_torch.harness import make_train_step
from localregneuralde_tpu_torch.harness.train import step_grads
from localregneuralde_tpu_torch.models import neural_ode
from localregneuralde_tpu_torch.models.draws import (
    cloned_generators, stage_draws,
)
from localregneuralde_tpu_torch.parallel import rank_state
from localregneuralde_tpu_torch.parallel.multihost import free_port
from tests import torch_dp_worker as W

HERE = os.path.dirname(os.path.abspath(__file__))
N = 2
# the JAX train state's key: its layer key draws t1 = 0.53 (the shards'
# 0.38 and 0.85), where the regulariser's step is not clipped to a sliver
# at t_end
KEY = 5


def _jax_t1(key, t0=0.0, t2=1.0):
    """The t1 JAX's NeuralODE draws from a layer key."""
    _, tkey, _ = jax.random.split(key, 3)
    return float(jax.random.uniform(tkey, (), jnp.float32, minval=t0,
                                    maxval=t2))


def _batch(n=W.B, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 8, 8, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)]
    return x, y


@pytest.fixture(scope="module")
def jax_side():
    cfg = W.mlp_cfg(jax_define_configuration)
    model = jax_construct_model(cfg)
    loss_fn, _ = jax_construct_loss(cfg)
    opt, _ = jax_construct_optimizer(cfg)
    params = jax.tree_util.tree_map(
        np.asarray, jax_create_train_state(model, opt,
                                           jax.random.PRNGKey(KEY)).params)
    # the dynamics' weights tripled: the regulariser's error estimate
    # (~7e-4) then stands well above its float32 rounding noise (~1e-10 at
    # the initial weights), so its gradient is a real check
    params["neural_ode"] = jax.tree_util.tree_map(lambda a: 3.0 * a,
                                                  params["neural_ode"])

    def fresh():  # the JAX steps donate their train state
        ts = jax_create_train_state(model, opt, jax.random.PRNGKey(KEY))
        return dataclasses.replace(
            ts, params=jax.tree_util.tree_map(jnp.asarray, params))

    ts = fresh()
    key = np.asarray(ts.state["neural_ode"]["rng"])
    return dict(model=model, loss_fn=loss_fn, opt=opt, fresh=fresh, key=key,
                params=params)


def spawn_ranks(args_of, n=N, timeout=240, env_of=None, cwd=None):
    """Start ``n`` processes (``args_of(rank, port)`` each, with the extra
    environment ``env_of(rank, port)``) and wait for all of them; fail
    with their errors if one does."""
    port = free_port()
    procs = [subprocess.Popen(
        args_of(r, port), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=cwd, env=dict(
            os.environ, OMP_NUM_THREADS="1",
            **({} if env_of is None else env_of(r, port))))
        for r in range(n)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, err[-4000:]
    return outs


@pytest.fixture(scope="module")
def dp(jax_side, tmp_path_factory):
    """Every rank's results of ``torch_dp_worker.py`` on two ranks."""
    d = tmp_path_factory.mktemp("dp")
    x, y = _batch()
    rng = np.random.RandomState(11)
    inp = dict(
        params=jax_side["params"],
        batch=(torch.from_numpy(x), torch.from_numpy(y)),
        batches=[tuple(torch.from_numpy(a) for a in _batch(seed=s))
                 for s in (4, 5)],
        t1=_jax_t1(jnp.asarray(jax_side["key"])),
        ode_w=(rng.randn(6, 6) * 0.5).astype(np.float32),
        ode_u0=rng.randn(16, 6).astype(np.float32),
    )
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    spawn_ranks(lambda r, port: [
        sys.executable, os.path.join(HERE, "torch_dp_worker.py"),
        str(d / "in.pkl"), str(d), str(r), str(N), str(port)])
    out = []
    for r in range(N):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return dict(inp=inp, ranks=out)


def _equal_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_tree(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        for u, v in zip(a, b):
            _equal_tree(u, v)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _close_rel(ours, ref, rel):
    ours, ref = np.asarray(ours), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert float(np.abs(ours - ref).max()) <= rel * scale


def _mean64(a, b, dtype):
    return ((a.double() + b.double()) / 2).to(dtype)


def manual_per_rank(model, loss_fn, opt, ts, batch, w, lr, *,
                    ema_decay=0.0, t1s=None):
    """The per-rank estimator by hand: each half batch through the
    single-device forward and backward with its rank's draws (``t1s``:
    injected t1 per rank), then the rank means as the layer documents them
    (loss and gradients in float32, scalar state and stats in float64, the
    state cast back, booleans by AND), one update and the EMA."""
    import copy

    from localregneuralde_tpu_torch.harness.train import _ema_update

    half = batch[0].shape[0] // N
    res = []
    for r in range(N):
        if t1s is not None:
            neural_ode.sample_t1 = lambda g, t0, t2, v=t1s[r]: v
        st_r = rank_state(cloned_generators(ts.state), r)
        draws = [stage_draws(model, st_r, half)]
        part = tuple(a[r * half:(r + 1) * half] for a in batch)
        res.append(step_grads(model, loss_fn, 1, ts, part, w, draws))
    (l0, s0, x0, g0), (l1, s1, x1, g1) = res
    grads = [(a + b) / 2 for a, b in zip(g0, g1)]
    loss = (l0 + l1) / 2
    ts2 = copy.deepcopy(ts)
    opt.apply(ts2.opt_state, list(ts2.params.values()), grads, lr)
    if ema_decay > 0.0:
        _ema_update(ts2.ema, ts2.params, ema_decay)
    node = {k: _mean64(s0["neural_ode"][k], s1["neural_ode"][k],
                       s0["neural_ode"][k].dtype)
            for k in ("nfe", "reg_val")}
    node["success"] = s0["neural_ode"]["success"] & s1["neural_ode"]["success"]
    stats = dict(nfe=_mean64(x0["nfe"], x1["nfe"], torch.float32))
    for k in ("ce_loss", "reg_val"):
        if k in x0:
            stats[k] = _mean64(x0[k], x1[k], torch.float32)
    return dict(ts=ts2, loss=loss, node=node, stats=stats,
                y_pred=[x0.get("y_pred"), x1.get("y_pred")])


# ------------------------------------------------------------ per-rank grid

def test_per_rank_step_is_bitwise_the_mean_of_two_half_steps(dp):
    """The DP step against the manual estimator from the same parameters:
    the loss, the parameters after SGD, the EMA, NFE (a float mean in the
    stats, truncated in the state), reg_val and y_pred, bitwise; the
    carried generator advanced by one word and replicated."""
    inp = dp["inp"]
    model, loss_fn, opt, ts = W.mlp_setup(inp["params"])
    from localregneuralde_tpu_torch.harness.train import init_ema

    ts = init_ema(ts)
    gen0 = ts.state["neural_ode"]["rng"].get_state()
    ref = manual_per_rank(model, loss_fn, opt, ts, inp["batch"], W.W_REG,
                          W.LR, ema_decay=W.DECAY)
    for r, out in enumerate(dp["ranks"]):
        got = out["shardmap"]["mlp0"]
        assert got["loss"] == ref["loss"].numpy()
        _equal_tree(got["params"], W.host(ref["ts"].params))
        _equal_tree(got["ema"], W.host(ref["ts"].ema))
        for k in ("nfe", "reg_val", "success"):
            _equal_tree(got["state"]["neural_ode"][k], W.host(ref["node"][k]))
        for k, v in ref["stats"].items():
            _equal_tree(got["stats"][k], W.host(v))
        assert got["stats"]["nfe"].dtype == np.float32
        _equal_tree(got["stats"]["y_pred"], W.host(ref["y_pred"][r]))
        g = torch.Generator()
        g.set_state(gen0)
        torch.randint(0, 2 ** 62, (), generator=g)
        _equal_tree(got["state"]["neural_ode"]["rng"], g.get_state().numpy())
    # the ranks drew different t1: their grids differ, so their y_pred rows
    # are of different solves, while the replicated state is one
    _equal_tree(dp["ranks"][0]["shardmap"]["mlp1"]["params"],
                dp["ranks"][1]["shardmap"]["mlp1"]["params"])


def test_manual_per_rank_estimator_matches_jax_shardmap(jax_side,
                                                        monkeypatch):
    """The manual estimator with JAX's per-shard t1 (``fold_in(key, i)``)
    injected, against JAX's ``make_shardmap_train_step`` on a two-device
    mesh: loss, mean NFE and the SGD updates."""
    js = jax_side
    x, y = _batch()
    mesh = make_mesh({"data": N})
    jts = settle_state_shapes(js["model"], js["loss_fn"], js["fresh"](),
                              (jnp.asarray(x), jnp.asarray(y)), W.W_REG)
    jts = shard_train_state(jts, mesh)
    step = jax_shardmap_step(js["model"], js["loss_fn"], js["opt"], mesh)
    jts2, jloss, jstats = step(jts, jax_shard_batch((jnp.asarray(x),
                                                     jnp.asarray(y)), mesh),
                               W.W_REG, W.LR)
    t1s = [_jax_t1(jax.random.fold_in(jnp.asarray(js["key"]), i))
           for i in range(N)]
    monkeypatch.setattr(neural_ode, "sample_t1", neural_ode.sample_t1)
    model, loss_fn, opt, ts = W.mlp_setup(js["params"])
    ref = manual_per_rank(model, loss_fn, opt, ts,
                          (torch.from_numpy(x), torch.from_numpy(y)),
                          W.W_REG, W.LR, t1s=t1s)
    np.testing.assert_allclose(float(ref["loss"]), float(jloss), rtol=2e-5)
    assert float(ref["stats"]["nfe"]) == float(jstats["nfe"])
    for path, new in jax.tree_util.tree_leaves_with_path(jts2.params):
        name = ".".join(k.key for k in path)
        old = js["params"]
        for k in path:
            old = old[k.key]
        _close_rel((ref["ts"].params[name].detach().numpy() - old) / W.LR,
                   (np.asarray(jax.device_get(new)) - old) / W.LR, 1e-3)


def test_per_rank_booleans_reduce_by_and_and_pairs_stay_pairs(dp):
    """``test_shardmap_bool_stats_reduce_by_all_and_dim_collisions``: one
    rank's False flag surfaces on both, as a boolean; a (2,) stats pair at
    a local batch of 4 is reduced, not taken for rows."""
    for out in dp["ranks"]:
        got = out["shardmap"]["flag"]
        assert got["flag"].dtype == np.bool_ and not bool(got["flag"])
        assert got["pair"].shape == (2,)
        assert got["success"].dtype == np.bool_ and bool(got["success"])


def test_per_rank_latent_family_with_tuple_wreg(dp):
    """The latent ODE's step with ``w = (w_reg, w_kl)``: bitwise the manual
    estimator (the reparameterisation's ε from each rank's generator), its
    ``mu`` this rank's rows; a second step runs."""
    model, loss_fn, opt, ts = W.latent_setup()
    batch = W.latent_batch()
    half = W.B // N
    res = []
    for r in range(N):
        st_r = rank_state(cloned_generators(ts.state), r)
        part = tuple(a[r * half:(r + 1) * half] for a in batch)
        res.append(step_grads(model, loss_fn, 1, ts, part, W.LATENT_W,
                              [stage_draws(model, st_r, half)]))
    loss = (res[0][0] + res[1][0]) / 2
    grads = [(a + b) / 2 for a, b in zip(res[0][3], res[1][3])]
    opt.apply(ts.opt_state, list(ts.params.values()), grads, 1e-3)
    for r, out in enumerate(dp["ranks"]):
        got = out["shardmap"]["latent0"]
        assert got["loss"] == loss.numpy()
        _equal_tree(got["params"], W.host(ts.params))
        mu = got["state"]["reparam"]["mu"]
        _equal_tree(mu, W.host(res[r][1]["reparam"]["mu"]))
        assert mu.shape[0] == half
        assert np.isfinite(out["shardmap"]["latent1"]["loss"])


def test_per_rank_ema_updates_and_stays_replicated(dp):
    """``test_shardmap_ema_updates_and_stays_replicated``: from ema =
    params0, one step gives d·params0 + (1 − d)·params1 on every rank."""
    p0 = dp["inp"]["params"]
    flat0 = {".".join(k.key for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(p0)}
    for out in dp["ranks"]:
        got = out["shardmap"]["mlp0"]
        for k, e in got["ema"].items():
            np.testing.assert_allclose(
                W.DECAY * flat0[k] + (1 - W.DECAY) * got["params"][k], e,
                rtol=1e-5, atol=1e-7)
    _equal_tree(dp["ranks"][0]["shardmap"]["mlp1"]["ema"],
                dp["ranks"][1]["shardmap"]["mlp1"]["ema"])


# -------------------------------------------------------------- global grid

def _single_device(inp, monkeypatch, wrap=None, **kw):
    monkeypatch.setattr(neural_ode, "sample_t1",
                        lambda g, t0, t2: inp["t1"])
    model, loss_fn, opt, ts = W.mlp_setup(inp["params"])
    if wrap is not None:
        loss_fn = wrap(loss_fn)
    return make_train_step(model, loss_fn, opt, **kw)(
        ts, inp["batch"], W.W_REG, W.LR)


def _updates(params, p0):
    return {k: (params[k] - p0[k]) / W.LR for k in params}


def _flat(tree):
    return {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("loss", ["step", "reg_only"])
def test_global_step_matches_single_device_on_the_global_batch(
        dp, monkeypatch, loss):
    """The global grid's step against the single-device step on the whole
    batch, with the same t1: the whole loss and the regulariser alone (a
    rank mean of plain per-rank gradients would halve its gradient)."""
    inp = dp["inp"]
    ts, l_ref, s_ref = _single_device(
        inp, monkeypatch, None if loss == "step" else W.reg_only)
    p0 = _flat(inp["params"])
    ref = _updates(W.host(ts.params), p0)
    for out in dp["ranks"]:
        got = out["gspmd"][loss]
        np.testing.assert_allclose(got["loss"], float(l_ref), rtol=1e-5)
        assert int(got["stats"]["nfe"]) == int(s_ref["nfe"])
        np.testing.assert_allclose(got["stats"]["reg_val"],
                                   float(s_ref["reg_val"]), rtol=1e-3)
        upd = _updates(got["params"], p0)
        for k in ref:
            _close_rel(upd[k], ref[k], 1e-3)
    _equal_tree(dp["ranks"][0]["gspmd"][loss]["params"],
                dp["ranks"][1]["gspmd"][loss]["params"])


def test_global_step_matches_jax_sharded_step(dp, jax_side):
    """Against JAX's ``make_sharded_train_step`` on a two-device mesh from
    the same parameters (JAX draws t1 from its replicated key, the port
    took the same value): loss, reg_val, NFE and the SGD updates."""
    js = jax_side
    x, y = _batch()
    mesh = make_mesh({"data": N})
    jts = js["fresh"]()
    sh = train_state_shardings(jts, mesh)
    jts = shard_train_state(jts, mesh, shardings=sh)
    step = jax_sharded_step(js["model"], js["loss_fn"], js["opt"], mesh,
                            ts_shardings=sh)
    jts2, jloss, jstats = step(jts, jax_shard_batch((jnp.asarray(x),
                                                     jnp.asarray(y)), mesh),
                               W.W_REG, W.LR)
    p0 = _flat(js["params"])
    ref = _updates(_flat(jax.device_get(jts2.params)), p0)
    got = dp["ranks"][0]["gspmd"]["step"]
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5)
    assert int(got["stats"]["nfe"]) == int(jstats["nfe"])
    np.testing.assert_allclose(got["stats"]["reg_val"],
                               float(jstats["reg_val"]), rtol=1e-3)
    upd = _updates(got["params"], p0)
    for k in ref:
        _close_rel(upd[k], ref[k], 1e-3)


def test_global_solve_takes_the_single_device_grid(dp):
    """``tests/test_parallel.py::test_dp_accept_reject_sequence_identity``:
    accepts within one and NFE within 12 of the single-device solve, y at
    its tolerance, and every rank the same counts."""
    from localregneuralde_tpu_torch.ode import odesolve

    inp = dp["inp"]
    w = torch.from_numpy(inp["ode_w"])
    sol = odesolve(lambda u, t: torch.tanh(u @ w) - 0.5 * u,
                   torch.from_numpy(inp["ode_u0"]), (0.0, 1.0), rtol=1e-6,
                   atol=1e-8, max_steps=64, adjoint="none")
    got = [out["gspmd"]["solve"] for out in dp["ranks"]]
    for k in ("naccept", "nreject", "nfe"):
        assert got[0][k] == got[1][k]
    assert abs(got[0]["naccept"] - int(sol.naccept)) <= 1
    assert abs(got[0]["nfe"] - int(sol.nfe)) <= 12
    np.testing.assert_allclose(np.concatenate([g["y"] for g in got]),
                               sol.y_final.numpy(), rtol=1e-4, atol=1e-6)
    assert all(out["parting"]["raised"] for out in dp["ranks"])


def test_global_k_step_call_is_k_single_calls(dp):
    """The K-step call (eager K bodies, never captured under data
    parallelism) against two single calls from the same state: bitwise."""
    for out in dp["ranks"]:
        got = out["gspmd"]["kstep"]
        assert got["captured"] is False
        _equal_tree(got["params_multi"], got["params_single"])
        _equal_tree(got["red_multi"], got["red_single"])
        _equal_tree(got["loss_multi"], got["loss_single"])


def test_global_grad_accumulation_matches_single_device(dp, monkeypatch):
    """``tests/test_parallel_grad_accum.py``: two microbatches, each spread
    over the ranks, against the single-device step with
    ``grad_accumulation=2`` on the whole batch: loss, summed NFE, y_pred
    (rank r holds its quarter of each microbatch) and the parameters."""
    inp = dp["inp"]
    ts, l_ref, s_ref = _single_device(inp, monkeypatch, grad_accumulation=2)
    y_ref = s_ref["y_pred"].numpy()
    q = W.B // (2 * N)
    for r, out in enumerate(dp["ranks"]):
        got = out["gspmd"]["ga"]
        np.testing.assert_allclose(got["loss"], float(l_ref), rtol=1e-4)
        assert int(got["stats"]["nfe"]) == int(s_ref["nfe"])
        rows = np.concatenate([y_ref[i * 2 * q + r * q:i * 2 * q + (r + 1) * q]
                               for i in range(2)])
        np.testing.assert_allclose(got["stats"]["y_pred"], rows, atol=2e-5)
        for k, v in W.host(ts.params).items():
            np.testing.assert_allclose(got["params"][k], v, atol=2e-5)


def test_global_ema_follows_its_params_and_rides_through_when_off(dp):
    """``tests/test_parallel_ema.py``: ema_k = d·ema_{k−1} + (1 − d)·params_k
    over two steps, the EMA lagging the parameters; with a carried EMA at
    decay 0 the EMA is unchanged."""
    p0 = _flat(dp["inp"]["params"])
    for out in dp["ranks"]:
        got = out["gspmd"]["ema"]
        ema = dict(p0)
        for snap in got["params"]:
            ema = {k: W.DECAY * ema[k] + (1 - W.DECAY) * snap[k] for k in ema}
        for k in ema:
            np.testing.assert_allclose(got["ema"][k], ema[k], rtol=1e-6,
                                       atol=1e-8)
        k0 = next(iter(ema))
        assert not np.allclose(got["params"][-1][k0], got["ema"][k0])
        off = out["gspmd"]["ema_off"]
        _equal_tree(off["after"], off["before"])


# ---------------------------------------------------------------- plumbing

def test_rows_of_each_rank_and_the_primary():
    """``shard_batch`` and ``process_batch_slice``: rank r's contiguous
    rows, or its slice of each microbatch; outside a group this process
    is the primary."""
    from localregneuralde_tpu_torch.parallel import DPGroup, shard_batch
    from localregneuralde_tpu_torch.parallel.multihost import (
        is_primary, process_batch_slice,
    )

    rows = np.arange(16)[:, None]
    for r in range(N):
        dp_r = DPGroup(group=None, rank=r, size=N)
        assert process_batch_slice(16, dp_r) == slice(8 * r, 8 * r + 8)
        np.testing.assert_array_equal(shard_batch((rows,), dp_r)[0][:, 0],
                                      np.arange(8 * r, 8 * r + 8))
        got = shard_batch((rows,), dp_r, n_micro=2)[0][:, 0]
        np.testing.assert_array_equal(
            got, np.r_[4 * r:4 * r + 4, 8 + 4 * r:8 + 4 * r + 4])
    with pytest.raises(ValueError):
        shard_batch((rows[:6],), DPGroup(group=None, rank=0, size=4))
    assert is_primary()


# ---------------------------------------------------------------- refusals

def test_unported_parallel_modes_raise_with_their_items():
    """The global grid for an Adams solver (14e) raises
    NotImplementedError; a tensor-parallel degree below 1 raises the JAX
    runner's ValueError (tensor parallelism, item 14d, is ported:
    ``tests/test_torch_parallel_tp.py``). The chain (14a), SDE (14b) and
    conv (14c) families take the global grid
    (``tests/test_torch_parallel_families.py``,
    ``tests/test_torch_parallel_conv.py``)."""
    from localregneuralde_tpu_torch.harness import (
        construct_model, define_configuration,
    )
    from localregneuralde_tpu_torch.parallel import make_dp_group
    from localregneuralde_tpu_torch.parallel.sharded_train import (
        check_global_grid,
    )

    with pytest.raises(ValueError, match="must be >= 1"):
        make_dp_group(tensor_parallel=0)
    model, *_ = W.latent_setup()
    assert check_global_grid(model, model.init_state()) == [("neural_ode",)]
    for extra, item in ((["--model.sde=true"], ("neural_dsde",)),
                        (["--model.model_type=cifar10_cnn"], ("neural_ode",)),
                        (["--model.solver.ode_solver=vcab3"], "14e")):
        cfg = define_configuration(extra, None)
        if extra[0].startswith("--model.sde"):
            cfg.model.sde = True
        model = construct_model(cfg, device="cpu")
        if isinstance(item, tuple):
            assert check_global_grid(model, model.init_state()) == [item]
            continue
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            check_global_grid(model, model.init_state())


# ------------------------------------------------------------------ runners

RUN_ARGS = {
    "runner": [
        "experiments/mnist_ode/mlp.yaml", "--model.mlp_hidden_state_size=8",
        "--model.solver.reltol=1e-2", "--model.solver.abstol=1e-2",
        "--model.solver.max_steps=32", "--dataset.train_batchsize=8",
        "--dataset.eval_batchsize=1024", "--model.regularize=unbiased"],
    "latent_runner": ["experiments/physionet/physionet.yaml"] + [
        a for a in W.LATENT_ARGS] + ["--dataset.train_batchsize=8",
                                     "--dataset.eval_batchsize=410"],
}


def _run_two_ranks(tmp_path, module, extra):
    """Both ranks of ``python -m localregneuralde_tpu_torch.harness.MODULE``
    with ``torchrun``'s variables; returns each rank's summary and its
    printed train-window lines."""
    import ast

    root = os.path.dirname(HERE)
    args = RUN_ARGS[module] + [
        "--device=cpu", "--train.total_steps=2", "--train.print_frequency=2",
        "--train.evaluate_every=2", f"--train.checkpoint_dir={tmp_path}/ck",
        f"--train.log_dir={tmp_path}/lg"] + extra
    outs = spawn_ranks(
        lambda r, port: [sys.executable, "-m",
                         f"localregneuralde_tpu_torch.harness.{module}",
                         *args],
        env_of=lambda r, port: dict(
            RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(N),
            LOCAL_WORLD_SIZE=str(N), MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(port)),
        cwd=root)
    res = []
    for _, out, _ in outs:
        summary = [ln for ln in out.splitlines() if ln.startswith("summary:")]
        windows = [ln for ln in out.splitlines() if ln.startswith("[2/2]")]
        res.append((ast.literal_eval(summary[0].split(":", 1)[1].strip()),
                    windows))
    return res


def _window_values(line):
    return {k: v for k, v in (t.split("=") for t in line.split()[1:])
            if not k.endswith("_time")}


@pytest.mark.parametrize("mode,spc", [("shardmap", 1), ("gspmd", 2)])
def test_classification_runner_on_two_ranks(tmp_path, mode, spc):
    """``tests/test_multihost.py``: the runner on two processes, one step a
    call (per-rank grid) and two (global grid): rc 0, the same losses and
    eval on both ranks, one primary (rank 1 under ``proc1``), bitwise equal
    checkpoints, and rank 0's resuming on one process."""
    from localregneuralde_tpu_torch.harness import (
        construct_model, construct_optimizer, create_train_state,
        define_configuration,
    )
    from localregneuralde_tpu_torch.harness.checkpoint import load_checkpoint
    from localregneuralde_tpu_torch.harness.latent_runner import (
        restore_train_state,
    )
    from localregneuralde_tpu_torch.harness.runner import (
        run_classification_experiment,
    )

    (s0, w0), (s1, w1) = _run_two_ranks(
        tmp_path, "runner", [f"--train.data_parallel={mode}",
                             f"--train.steps_per_call={spc}"])
    assert (s0["rank"], s1["rank"], s0["world_size"]) == (0, 1, N)
    assert s0["steps_per_call"] == spc and not s0["captured"]
    assert _window_values(w0[0]) == _window_values(w1[0])
    assert s0["final_eval"] == s1["final_eval"]
    assert "proc" not in s0["ckpt_dir"] and s1["ckpt_dir"].endswith("proc1")
    ck = [load_checkpoint(os.path.join(s["ckpt_dir"], "model_current.ckpt"))
          for s in (s0, s1)]
    _equal_tree(ck[0]["tstate"]["params"], ck[1]["tstate"]["params"])

    cfg = define_configuration(RUN_ARGS["runner"][1:] + [
        "--train.total_steps=3", "--train.print_frequency=1",
        "--train.evaluate_every=3", f"--train.checkpoint_dir={tmp_path}/one",
        f"--train.log_dir={tmp_path}/one",
        f"--train.resume={s0['ckpt_dir']}/model_current.ckpt"],
        RUN_ARGS["runner"][0])
    model = construct_model(cfg, device="cpu")
    opt, _ = construct_optimizer(cfg)
    ts = restore_train_state(create_train_state(model, opt),
                             ck[0]["tstate"], "cpu")
    _equal_tree(W.host(ts.params), ck[0]["tstate"]["params"])
    out = run_classification_experiment(cfg, "one", device="cpu")
    assert out["final_step"] == 3 and "data_parallel" not in out


def test_latent_runner_on_two_ranks(tmp_path):
    """The latent runner on two processes, per-rank grid: rc 0, the same
    losses and eval MSE on both ranks, and a checkpoint whose ``mu`` holds
    the whole batch's rows (gathered from both ranks)."""
    from localregneuralde_tpu_torch.harness.checkpoint import load_checkpoint

    (s0, w0), (s1, w1) = _run_two_ranks(
        tmp_path, "latent_runner", ["--train.data_parallel=shardmap"])
    assert _window_values(w0[0]) == _window_values(w1[0])
    assert s0["final_eval_mse"] == s1["final_eval_mse"]
    assert s1["ckpt_dir"].endswith("proc1")
    ck = load_checkpoint(os.path.join(s0["ckpt_dir"], "model_current.ckpt"))
    assert ck["tstate"]["state"]["reparam"]["mu"].shape[0] == W.B


def test_runner_refuses_what_the_jax_runner_refuses():
    """The JAX runner's checks (``runner.py:67-120`` there), raised before
    anything runs: the per-rank grid with gradient accumulation, an
    explicit K > 1 or tensor parallelism; tensor parallelism without a
    grid, or at a degree below 1, or one that does not divide the ranks
    (here one); a batch that does not divide the data-parallel degree
    (times the microbatches)."""
    from localregneuralde_tpu_torch.harness import define_configuration
    from localregneuralde_tpu_torch.harness.latent_runner import (
        check_supported,
    )
    from localregneuralde_tpu_torch.harness.runner import (
        _wire_data_parallel, start_data_parallel,
    )
    from localregneuralde_tpu_torch.parallel import DPGroup

    for mode, extra, match in (
            ("shardmap", ["--train.grad_accumulation=2"], "grad_acc"),
            ("shardmap", ["--train.steps_per_call=2"], "steps_per_call"),
            ("shardmap", ["--train.tensor_parallel=2"], "shardmap mode"),
            ("none", ["--train.tensor_parallel=2"], "requires"),
            ("gspmd", ["--train.tensor_parallel=0"], "must be >= 1")):
        cfg = define_configuration(
            [f"--train.data_parallel={mode}"] + extra, None)
        with pytest.raises(ValueError, match=match):
            check_supported(cfg)
    cfg = define_configuration(["--train.data_parallel=gspmd",
                                "--train.tensor_parallel=2"], None)
    check_supported(cfg)
    with pytest.raises(ValueError, match="does not divide the 1 ranks"):
        start_data_parallel(cfg, "cpu")
    # a 4 × 2 grid: 6 rows do not split over 4 data ranks, nor 4 rows
    # over 4 data ranks times 2 microbatches
    grid = DPGroup(group=None, rank=0, size=4, model_size=2)
    for bs, ga in ((6, 1), (4, 2)):
        cfg = define_configuration([
            "--train.data_parallel=gspmd", "--train.tensor_parallel=2",
            f"--dataset.train_batchsize={bs}",
            f"--train.grad_accumulation={ga}"], None)
        with pytest.raises(ValueError, match="data-parallel degree 4"):
            _wire_data_parallel(cfg, None, None, None, None, grid, "cpu",
                                train_step=None, eval_step=None)
