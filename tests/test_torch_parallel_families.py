"""The global grid of data parallelism (``train.data_parallel='gspmd'``) for
the chain family (the PhysioNet latent ODE) and the SDE family (the MNIST
NeuralDSDE) on the CPU: two ranks over Gloo, each a spawned process
(``tests/torch_dp_families_worker.py``), against the port's single-device
step on the global batch and against the JAX package's
``make_sharded_train_step`` on a two-device mesh.

Sizes are small: the latent model of ``tests/test_torch_latent.py`` (in 5,
hidden 8, latent 6, node 4, T = 7, B = 8) at rtol 3e-2 with the generative
weights doubled, and ``mnist_sde/mlp.yaml`` at 8×8 images (B = 8, F = 32,
H = 64, rtol 0.14, ``unbiased``), both at ``'highest'`` (the CPU's tier),
SGD so that an update is the gradient.

- **Against the single device**, with the port's own draws: the ranks
  stage the whole batch's draws (t1, ε, the tree's seed, the regulariser's
  normals) from the replicated generators and take their rows, and the
  tree draws the rank's rows by global row, so both sides draw the same
  numbers. ``use_pallas='on'`` runs the persistent solves (kernels 5 and
  10; their plain versions on the CPU) on the whole batch on every rank,
  so the forward is the single device's, and the sweeps (kernels 9 and
  12) on the rank's rows, or on the whole batch where kernel 9's windows
  replay (``knot_window=2``). On the eager route (``'off'``) the norms
  add in another order, which moves a step's dt by an ulp now and then.
  NFE equal and the ranks' parameters bitwise equal.
- **Against JAX's sharded step**, with JAX's draws injected.

Tolerances (``TOL``), set above the rounding floor that
``tests/dp_tolerance_probe.py`` measures (the single-device step's own
change under a 1e-7 relative change of the data; PERF.md §6 has its
readings, and ``test_rounding_floor_of_the_tolerances`` checks them).
The latent model: loss 1e-5, ``reg_val`` 1e-3, updates 1e-3 of the
largest (``tests/test_torch_latent.py``, ``tests/test_torch_parallel.py``),
at rtol 3e-2 with the generative weights doubled: at rtol 1e-3 with the
weights tripled (``test_torch_latent.py``'s setting) the floor of
``reg_val`` is above 1e-3, and so it is at JAX's draws from key 0, so
JAX's draws come from key 10's train state.
The SDE's kernel route: the latent model's bounds. Its eager route: loss
5e-4, ``reg_val`` 1e-3, updates 1e-2, where the floor of the loss is
1.7e-4 (above 1e-5) and a K = 2 call's updates part by 4.7e-3: a one-ulp
shift of a step time moves the Brownian path.
- **The tree by global row**: each rank's normals at four nodes bitwise
  its rows of the single-device tree's, with gradient accumulation 1 and
  2 (a rank's rows of each microbatch).
- Gradient accumulation 2 and a K = 2 call against the single-device
  step and call; both runners on two ranks under ``'gspmd'``.
"""
import ast
import dataclasses
import os
import pickle
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
    construct_time_series as jax_construct_time_series,
)
from localregneuralde_tpu.harness.train import (
    create_train_state as jax_create_train_state,
    settle_state_shapes,
)
from localregneuralde_tpu.parallel import (
    make_mesh,
    make_sharded_train_step as jax_sharded_step,
    shard_batch as jax_shard_batch,
    shard_train_state,
    train_state_shardings,
)
from localregneuralde_tpu_torch.harness import (
    make_multi_train_step,
    make_train_step,
    one_hot,
    synthetic_classification,
)
from localregneuralde_tpu_torch.harness.data import synthetic_physionet
from localregneuralde_tpu_torch.parallel import DPGroup
from localregneuralde_tpu_torch.parity import latent_tree, params_from_jax
from localregneuralde_tpu_torch.sde.brownian import PhiloxNormals
from test_torch_parallel import _close_rel, _equal_tree, spawn_ranks
from tests import torch_dp_families_worker as W

HERE = os.path.dirname(os.path.abspath(__file__))
N, B = 2, W.B
FAMILIES = ("latent", "sde")
# the latent train state's keys (the docstring's tolerances): the port's
# own draws run from key 0's parameters, JAX's from key 10's train state
LATENT_KEY, JAX_LATENT_KEY = 0, 10
# the bounds (tests/dp_tolerance_probe.py measures the floor under them):
# the SDE's kernel route, whose forward is the single device's, at the
# latent model's; its eager route's loss and updates above their rounding
# floor (a one-ulp shift of a step time moves the Brownian path)
TOL = {"latent": dict(loss_rtol=1e-5, reg_rtol=1e-3, upd_rel=1e-3),
       "sde": dict(loss_rtol=5e-4, reg_rtol=1e-3, upd_rel=1e-2),
       "sde kernel": dict(loss_rtol=1e-5, reg_rtol=1e-3, upd_rel=1e-3)}


def _latent_batch(seed):
    data, mask, tgrid = synthetic_physionet(n=B, t_steps=W.T,
                                            features=W.IN, seed=seed)
    dt = np.concatenate([tgrid[1:] - tgrid[:-1], [0.0]]).astype(np.float32)
    dt = np.ascontiguousarray(np.broadcast_to(dt[None, :, None],
                                              (B, W.T, 1)))
    return (data, mask, dt), tgrid


def _sde_batch(seed):
    x, y, _, _ = synthetic_classification((8, 8), 1, 10, n_train=B,
                                          n_test=1, seed=seed)
    return x, one_hot(y, 10)


def _jax_latent(key, scale=2.0, extra=()):
    """JAX's latent model (with ``extra`` overrides), its parameters from
    ``key`` (the generative weights times ``scale``), the batch and the
    draws its train step takes."""
    jcfg = jax_define_configuration(
        W.LATENT_ARGS + ["--model.use_pallas=off"] + list(extra),
        W.LATENT_CONFIG)
    batch, tgrid = _latent_batch(11)
    jmodel = jax_construct_time_series(jcfg, saveat=jnp.asarray(tgrid))
    jopt, _ = jax_construct_optimizer(jcfg)
    jts = jax_create_train_state(jmodel, jopt, jax.random.PRNGKey(key))
    p = jax.tree_util.tree_map(np.asarray, jts.params)
    for layer in p["neural_ode"]["model"].values():
        if "w" in layer:
            layer["w"] = scale * layer["w"]
    _, tkey, _ = jax.random.split(jts.state["neural_ode"]["rng"], 3)
    t1 = float(jax.random.uniform(tkey, (), jnp.float32, minval=0.0,
                                  maxval=1.0))
    eps = np.asarray(jax.random.normal(
        jax.random.split(jts.state["reparam"]["rng"])[1], (B, W.NODE)))
    return dict(cfg=jcfg, model=jmodel, opt=jopt, params=p, batch=batch,
                tgrid=tgrid, t1=t1, eps=eps)


def _jax_sde():
    """JAX's MNIST SDE at 8×8 images, its parameters, the batch and the
    draws its train step takes (``test_torch_sde_train.inject_sde_draws``)."""
    jcfg = jax_define_configuration(
        W.SDE_ARGS + ["--model.use_pallas=off"], W.SDE_CONFIG)
    jcfg.model.image_size = [8, 8]
    jmodel = jax_construct_model(jcfg)
    jopt, _ = jax_construct_optimizer(jcfg)
    jts = jax_create_train_state(jmodel, jopt, jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(np.asarray, jts.params)
    rng_key = jnp.asarray(np.asarray(jts.state["neural_dsde"]["rng"]))
    _, noise_key, tkey, _, wkey = jax.random.split(rng_key, 5)
    features = int(p["neural_dsde"]["diffusion"]["w"].shape[0])
    t1 = float(jax.random.uniform(tkey, (), jnp.float32, minval=0.0,
                                  maxval=1.0))
    kw, kz = jax.random.split(wkey)
    reg = np.stack([np.asarray(jax.random.normal(k, (B, features)))
                    for k in (kw, kz)])
    return dict(cfg=jcfg, model=jmodel, opt=jopt, params=p,
                batch=_sde_batch(3), noise_key=np.asarray(noise_key), t1=t1,
                reg_noise=reg, features=features)


@pytest.fixture(scope="module")
def fam(tmp_path_factory):
    """The inputs, JAX's side and every rank's results of the worker on
    two ranks."""
    torch.set_num_threads(1)
    return rank_results(tmp_path_factory.mktemp("dp_families"))


def rank_results(d, latent_key=LATENT_KEY):
    """``fam``'s dict, the worker's files in the directory ``d`` (the
    latent parameters of the port's own draws from ``latent_key``)."""
    lat, sde = _jax_latent(JAX_LATENT_KEY), _jax_sde()
    tensors = lambda b: tuple(torch.from_numpy(np.asarray(a))  # noqa: E731
                              for a in b)
    inp = dict(
        latent=dict(params=_jax_latent(latent_key)["params"],
                    jax_params=lat["params"], tgrid=lat["tgrid"],
                    batch=tensors(lat["batch"]),
                    batches=[tensors(_latent_batch(s)[0]) for s in (12, 13)],
                    jax_t1=lat["t1"], jax_eps=lat["eps"]),
        sde=dict(params=sde["params"], batch=tensors(sde["batch"]),
                 batches=[tensors(_sde_batch(s)) for s in (4, 5)],
                 jax_noise_key=sde["noise_key"], jax_t1=sde["t1"],
                 jax_reg_noise=sde["reg_noise"], features=sde["features"]),
    )
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    spawn_ranks(lambda r, port: [
        sys.executable, os.path.join(HERE, "torch_dp_families_worker.py"),
        str(d / "in.pkl"), str(d), str(r), str(N), str(port)])
    ranks = []
    for r in range(N):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(inp=inp, ranks=ranks, jax=dict(latent=lat, sde=sde))


def _setup(family, inp, use_pallas="off"):
    if family == "latent":
        return W.latent_setup(inp["latent"]["params"], use_pallas,
                              inp["latent"]["tgrid"])
    return W.sde_setup(inp["sde"]["params"], use_pallas)


def _nfe(stats):
    n = stats["nfe"]
    return [int(v) for v in n] if isinstance(n, (tuple, list)) else int(n)


def _flat(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _updates(new, old, lr=W.LR):
    return {k: (np.asarray(new[k]) - np.asarray(old[k])) / lr for k in new}


def _check_step(got, ref_params, ref_loss, ref_stats, p0, loss_rtol,
                reg_rtol, upd_rel):
    """One rank's step against a reference step from the parameters p0."""
    assert _nfe(got["stats"]) == _nfe(ref_stats)
    np.testing.assert_allclose(got["loss"], float(ref_loss), rtol=loss_rtol)
    np.testing.assert_allclose(got["stats"]["reg_val"],
                               float(ref_stats["reg_val"]), rtol=reg_rtol)
    ref = _updates(ref_params, p0)
    upd = _updates(got["params"], p0)
    assert set(upd) == set(ref)
    for k in ref:
        _close_rel(upd[k], ref[k], upd_rel)


def _single(family, inp, use_pallas="off", **kw):
    """The port's single-device step on the global batch, with the draws
    its own generators give."""
    model, loss_fn, opt, ts, w = _setup(family, inp, use_pallas)
    p0 = W.host(ts.params)
    ts2, loss, stats = make_train_step(model, loss_fn, opt, **kw)(
        ts, inp[family]["batch"], w, W.LR)
    return W.host(ts2.params), loss, stats, p0


# ----------------------------------------------------- against one device

@pytest.mark.parametrize("use_pallas", ["off", "on"])
@pytest.mark.parametrize("family", FAMILIES)
def test_global_step_matches_single_device(fam, family, use_pallas):
    """One global-grid step on two ranks against the single-device step on
    the global batch, each with the port's own draws."""
    params, loss, stats, p0 = _single(family, fam["inp"], use_pallas)
    tol = TOL["sde kernel" if (family, use_pallas) == ("sde", "on")
              else family]
    for out in fam["ranks"]:
        _check_step(out[family][f"step_{use_pallas}"], params, loss, stats,
                    p0, **tol)
    _equal_tree(fam["ranks"][0][family][f"step_{use_pallas}"]["params"],
                fam["ranks"][1][family][f"step_{use_pallas}"]["params"])


@pytest.mark.parametrize("family", FAMILIES)
def test_global_grad_accumulation_matches_single_device(fam, family):
    """Two microbatches, each spread over the ranks (rank r holds its
    quarter of each), against the single-device step with
    ``grad_accumulation=2``: summed NFE, loss, the mean reg_val and the
    updates."""
    params, loss, stats, p0 = _single(family, fam["inp"],
                                      grad_accumulation=2)
    for out in fam["ranks"]:
        _check_step(out[family]["ga"], params, loss, stats, p0,
                    **TOL[family])
    _equal_tree(fam["ranks"][0][family]["ga"]["params"],
                fam["ranks"][1][family]["ga"]["params"])


@pytest.mark.parametrize("family", FAMILIES)
def test_global_k_step_call_matches_single_device(fam, family):
    """A K = 2 call on the global grid (eager bodies, never captured under
    data parallelism) against the single-device K = 2 call on the same two
    global batches: the last loss, the summed (loss, reg_val) and the
    parameters."""
    model, loss_fn, opt, ts, w = _setup(family, fam["inp"])
    multi = make_multi_train_step(
        model, loss_fn, opt, reduce_fn=lambda loss, stats, d: {
            "row": torch.stack([loss, stats["reg_val"]])})
    stack = tuple(torch.stack(s) for s in zip(*fam["inp"][family]["batches"]))
    ws = (tuple(np.full(2, v, np.float32) for v in w)
          if isinstance(w, tuple) else np.full(2, w, np.float32))
    p0, lr, tol = W.host(ts.params), W.K_LR[family], TOL[family]
    ts2, loss, red = multi(ts, stack, ws, np.full(2, lr, np.float32))
    ref = _updates(W.host(ts2.params), p0, lr)
    for out in fam["ranks"]:
        got = out[family]["kstep"]
        assert got["captured"] is False
        np.testing.assert_allclose(got["loss"], float(loss),
                                   rtol=tol["loss_rtol"])
        np.testing.assert_allclose(got["red"], red["row"].numpy(),
                                   rtol=max(tol["loss_rtol"],
                                            tol["reg_rtol"]))
        upd = _updates(got["params"], p0, lr)
        for k in ref:
            _close_rel(upd[k], ref[k], tol["upd_rel"])
    _equal_tree(fam["ranks"][0][family]["kstep"]["params"],
                fam["ranks"][1][family]["kstep"]["params"])


# ------------------------------------------------------------ against JAX

def _jax_sharded(side, loss_w, key):
    """JAX's ``make_sharded_train_step`` on a two-device mesh from the
    side's parameters and the train state of ``key``: (new params, loss,
    stats)."""
    jloss, _ = jax_construct_loss(side["cfg"])
    jts = jax_create_train_state(side["model"], side["opt"],
                                 jax.random.PRNGKey(key))
    jts = dataclasses.replace(jts, params=jax.tree_util.tree_map(
        jnp.asarray, side["params"]))
    batch = tuple(jnp.asarray(a) for a in side["batch"])
    jts = settle_state_shapes(side["model"], jloss, jts, batch, loss_w)
    mesh = make_mesh({"data": N})
    sh = train_state_shardings(jts, mesh)
    jts = shard_train_state(jts, mesh, shardings=sh)
    step = jax_sharded_step(side["model"], jloss, side["opt"], mesh,
                            ts_shardings=sh)
    jts2, jl, jstats = step(jts, jax_shard_batch(batch, mesh), loss_w, W.LR)
    return jax.device_get(jts2.params), jl, jstats


@pytest.mark.parametrize("family", FAMILIES)
def test_global_step_matches_jax_sharded_step(fam, family):
    """The ranks' step with JAX's draws injected (t1 and ε; for the SDE
    the tree's normals, t1 and the regulariser's normals, each rank its
    rows of the whole batch's) against JAX's sharded step on a two-device
    mesh from the same parameters."""
    side = fam["jax"][family]
    _, w_sched = jax_construct_loss(side["cfg"])
    if family == "latent":
        new, jl, jstats = _jax_sharded(side, (float(w_sched[0](1)), 0.5),
                                       JAX_LATENT_KEY)
        ours = params_from_jax(latent_tree(new))
        p0 = params_from_jax(latent_tree(side["params"]))
    else:
        new, jl, jstats = _jax_sharded(side, float(w_sched(1)), 0)
        ours = params_from_jax(new)
        p0 = params_from_jax(side["params"])
    ref = {k: v.numpy() for k, v in ours.items()}
    p0 = {k: v.numpy() for k, v in p0.items()}
    stats = {"nfe": jstats["nfe"], "reg_val": jstats["reg_val"]}
    if family == "sde":
        stats["nfe"] = [int(n) for n in jstats["nfe"]]
    for out in fam["ranks"]:
        _check_step(out[family]["jax"], ref, jl, stats, p0, **TOL[family])


# ------------------------------------------------- the tree by global row

def test_philox_row_offset_is_bitwise_the_whole_batch_rows():
    """``PhiloxNormals`` from a row offset: bitwise those rows of the
    whole batch's normals at every node, whatever the split."""
    full = PhiloxNormals(0x9E3779B9, 12, 5)
    for node in (1, 2, 9, 1 << 20):
        ref = full(node)
        for start, rows in ((0, 12), (0, 5), (5, 7), (11, 1)):
            part = PhiloxNormals(0x9E3779B9, rows, 5, row_offset=start)
            assert torch.equal(part(node), ref[:, start:start + rows])
        assert torch.equal(PhiloxNormals(0x9E3779B9, 4, 5, row_offset=8)
                           .many([node])[0], ref[:, 8:])


@pytest.mark.parametrize("n_micro", [1, 2])
def test_rank_tree_is_the_single_device_trees_rows(fam, n_micro):
    """Every solve's tree on each rank (a step's, and with two
    microbatches each microbatch's): the same seed on both ranks, drawn
    from row ``local_rows(r)`` of the batch (of the microbatch), and its
    normals bitwise those rows of the single-device tree of the whole
    batch (microbatch)."""
    from localregneuralde_tpu_torch.parallel.mesh import local_rows

    key = "step_off" if n_micro == 1 else "ga"
    recs = [out["sde"][key]["noise"] for out in fam["ranks"]]
    assert len(recs[0]) == len(recs[1]) == n_micro
    m = B // n_micro
    for r, rec in enumerate(recs):
        dp = DPGroup(group=None, rank=r, size=N)
        pieces = local_rows(B, dp, n_micro)
        for i, call in enumerate(rec):
            assert call["seed"] == recs[0][i]["seed"]
            rows = slice(pieces[i].start - i * m, pieces[i].stop - i * m)
            assert (call["row_offset"], call["rows"]) == (rows.start,
                                                          B // (N * n_micro))
            full = PhiloxNormals(call["seed"], m, fam["inp"]["sde"]["features"])
            for node, got in call["normals"].items():
                np.testing.assert_array_equal(got, full(node)[:, rows].numpy())


def test_rounding_floor_of_the_tolerances():
    """The single-device step's own change under a 1e-7 relative change
    of the data (``tests/dp_tolerance_probe.py``'s spread): below every
    bound of ``TOL`` at the tests' settings; ``reg_val``'s above
    ``reg_rtol`` at rtol 1e-3 with the weights tripled
    (``test_torch_latent.py``'s setting) and at key 0 with JAX's draws, so
    the tests run at rtol 3e-2 and JAX's draws from key 10; and the SDE
    eager route's loss above the kernel route's 1e-5."""
    import dp_tolerance_probe as P

    torch.set_num_threads(1)
    bounds = lambda t: np.array([t["reg_rtol"], t["loss_rtol"],  # noqa: E731
                                 t["upd_rel"]])
    for label, tol in (("latent key 0, own draws", TOL["latent"]),
                       ("latent key 10, JAX's draws", TOL["latent"]),
                       ("sde, eager route", TOL["sde"])):
        assert np.all(P.spread(label) < bounds(tol)), label
    assert P.spread("latent rtol 1e-3, weights x3")[0] > 1e-3
    assert P.spread("latent key 0, JAX's draws")[0] > 1e-3
    assert P.spread("sde, eager route")[1] > TOL["sde kernel"]["loss_rtol"]


# ----------------------------------------------------------------- routes

@pytest.mark.parametrize("family", FAMILIES)
def test_global_grid_runs_the_kernel_solve_and_sweep(fam, family):
    """At use_pallas 'on' the global grid calls the family's persistent
    solve (kernel 5 or 10; on the CPU its plain version) once a step, on
    the whole batch, and its sweep (kernel 9 or 12) once, on the rank's
    rows of the knots; at 'off' neither."""
    solve, sweep = {"latent": ("persistent_chain_solve",
                               "persistent_chain_sweep"),
                    "sde": ("persistent_sde_solve",
                            "persistent_sde_sweep")}[family]
    for out in fam["ranks"]:
        assert out[family]["step_on"]["calls"] == {solve: 1, sweep: 1}
        assert out[family]["step_on"]["solve_rows"] == [B]
        assert out[family]["step_off"]["calls"] == {}


def test_global_two_level_sweep_matches_single_device(fam):
    """The chain on the kernel route with dense knots for 2 accepts only
    (``knot_window=2``): the sweep replays the whole batch's windows, so
    each rank sweeps the whole batch with both ranks' cotangents and keeps
    its rows and half the parameters' gradients. Against the single-device
    step at the same window, at the latent model's tolerances."""
    inp = fam["inp"]
    model, loss_fn, opt, ts, w = W.latent_setup(
        inp["latent"]["params"], "on", inp["latent"]["tgrid"],
        extra=W.TWO_LEVEL)
    p0 = W.host(ts.params)
    ts2, loss, stats = make_train_step(model, loss_fn, opt)(
        ts, inp["latent"]["batch"], w, W.LR)
    for out in fam["ranks"]:
        got = out["latent"]["two_level"]
        (naccept, rows, two_level), = got["sweeps"]
        assert naccept > 2 and rows == B and two_level
        _check_step(got, W.host(ts2.params), loss, stats, p0,
                    **TOL["latent"])
    _equal_tree(fam["ranks"][0]["latent"]["two_level"]["params"],
                fam["ranks"][1]["latent"]["two_level"]["params"])


def test_check_global_grid_takes_the_chain_and_sde_families():
    """The latent model, the NeuralDSDE (every solver) and the conv family
    take the global grid; the Adams solvers keep their refusal."""
    from localregneuralde_tpu_torch.harness import (
        construct_model, construct_time_series, define_configuration,
    )
    from localregneuralde_tpu_torch.parallel.sharded_train import (
        check_global_grid,
    )

    cfg = define_configuration(W.LATENT_ARGS + ["--model.use_pallas=on"],
                               W.LATENT_CONFIG)
    model = construct_time_series(cfg, saveat=torch.linspace(0, 1, W.T),
                                  device="cpu")
    assert check_global_grid(model) == [("neural_ode",)]
    for solver in ("sosri", "milstein", "euler_heun"):
        cfg = define_configuration(W.SDE_ARGS + [
            f"--model.sde_solver={solver}"], W.SDE_CONFIG)
        assert check_global_grid(construct_model(cfg, device="cpu")) == [
            ("neural_dsde",)]
    model = construct_model(define_configuration(
        ["--model.model_type=cifar10_cnn"], None), device="cpu")
    assert check_global_grid(model) == [("neural_ode",)]
    model = construct_model(define_configuration(
        ["--model.solver.ode_solver=vcab3"], None), device="cpu")
    with pytest.raises(NotImplementedError, match="item 14e"):
        check_global_grid(model)


# ------------------------------------------------------------------ runners

RUNNERS = {
    "latent_runner": ["experiments/physionet/physionet.yaml"] + [
        a for a in W.LATENT_ARGS if "optimizer" not in a] + [
        "--dataset.train_batchsize=8"],
    "runner": ["experiments/mnist_sde/mlp.yaml", "--model.image_size=[8,8]",
               "--model.solver.max_steps=48", "--model.regularize=unbiased",
               "--dataset.train_batchsize=8",
               "--dataset.eval_batchsize=1024"],
}


def _run(tmp, module, extra, n=N):
    """``python -m localregneuralde_tpu_torch.harness.MODULE`` on ``n``
    ranks with ``torchrun``'s variables (one plain process for n = 1):
    each rank's summary, its train-window lines and its stdout."""
    root = os.path.dirname(HERE)
    args = RUNNERS[module] + [
        "--device=cpu", "--train.total_steps=2", "--train.print_frequency=2",
        "--train.evaluate_every=2", f"--train.checkpoint_dir={tmp}/ck",
        f"--train.log_dir={tmp}/lg"] + extra
    env_of = None
    if n > 1:
        env_of = lambda r, port: dict(  # noqa: E731
            RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
            LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(port))
    outs = spawn_ranks(
        lambda r, port: [sys.executable, "-m",
                         f"localregneuralde_tpu_torch.harness.{module}",
                         *args], n=n, env_of=env_of, cwd=root)
    res = []
    for _, out, _ in outs:
        lines = out.splitlines()
        summary = [ln for ln in lines if ln.startswith("summary:")][0]
        res.append((ast.literal_eval(summary.split(":", 1)[1].strip()),
                    [ln for ln in lines if ln.startswith("[2/2]")], out))
    return res


def _windows(lines):
    return [{k: v for k, v in (t.split("=") for t in ln.split()[1:])
             if not k.endswith("_time")} for ln in lines]


def test_latent_runner_gspmd_on_two_ranks(tmp_path):
    """``tests/test_multihost.py::test_latent_runner_two_process``: the
    latent runner on two processes under 'gspmd' with an odd eval size
    (409 of the 410 test series, rounded down to 408 and the rounding
    printed): rc 0, equal windows and eval on both ranks, one primary, and
    the eval MSE and NFE of a single process at eval size 408."""
    (s0, w0, o0), (s1, w1, _) = _run(tmp_path, "latent_runner", [
        "--train.data_parallel=gspmd", "--dataset.eval_batchsize=409"])
    assert "eval batch rounded 409 -> 408 for data-parallel degree 2; " \
        "2 of 410 test samples skipped per eval pass (+1 vs a " \
        "single-process run)" in o0
    assert (s0["rank"], s1["rank"], s0["data_parallel"]) == (0, 1, "gspmd")
    assert _windows(w0) == _windows(w1) and w0
    assert s0["final_eval_mse"] == s1["final_eval_mse"]
    assert s0["final_eval_nfe"] == s1["final_eval_nfe"]
    assert "proc" not in s0["ckpt_dir"] and s1["ckpt_dir"].endswith("proc1")
    ((one, _, _),) = _run(tmp_path / "one", "latent_runner",
                          ["--dataset.eval_batchsize=408"], n=1)
    np.testing.assert_allclose(s0["final_eval_mse"], one["final_eval_mse"],
                               rtol=1e-4)
    assert s0["final_eval_nfe"] == one["final_eval_nfe"]


def test_sde_runner_gspmd_on_two_ranks(tmp_path):
    """The classification runner with ``mnist_sde/mlp.yaml`` (8×8 images)
    on two processes under 'gspmd': rc 0, equal windows and eval on both
    ranks (each eval batch solved on the global grid), one primary."""
    (s0, w0, _), (s1, w1, _) = _run(tmp_path, "runner",
                                    ["--train.data_parallel=gspmd"])
    assert (s0["rank"], s1["rank"], s0["data_parallel"]) == (0, 1, "gspmd")
    assert _windows(w0) == _windows(w1) and w0
    assert s0["final_eval"] == s1["final_eval"]
    assert np.isfinite(s0["final_eval"]["net_loss"])
    assert "proc" not in s0["ckpt_dir"] and s1["ckpt_dir"].endswith("proc1")
