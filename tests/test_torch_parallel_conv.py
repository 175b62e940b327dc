"""The global grid of data parallelism (``train.data_parallel='gspmd'``) for
the CIFAR-10 conv family on the CPU: two ranks over Gloo, each a spawned
process (``tests/torch_dp_conv_worker.py``), against the port's
single-device step on the global batch and against the JAX package's
``make_sharded_train_step`` on a two-device mesh.

Sizes: the whole CIFAR model of ``tests/test_torch_cifar.py`` (8×8 images,
Cs 8, the dynamics' Ch 64 as ``cnn.yaml`` builds it) at B = 8, so 4 rows a
rank, rtol 1e-2, ``'highest'``, SGD so that an update is the gradient; the
dynamics' weights tripled, so that the regulariser's error estimate
(``reg_val``, a cancelling sum of the stage derivatives) stands further
above its float32 rounding noise.

- **Kernel route** (``use_pallas='on'``; on the CPU the plain versions of
  kernels 13 and 14 that their wrappers run): the whole solve, the sweep
  and the regulariser's step run on the whole batch, gathered from the
  ranks, on every rank, so their BatchNorm statistics are the global
  batch's; the outer ``BatchNorm(8)`` takes its moments over the ranks.
- **Eager route** (``'off'``): each rank's rows through the module, every
  norm and every BatchNorm moment over the ranks.
- Both routes and both regularisers (``none``, ``unbiased``), the direct
  adjoint, a sharded eval step, gradient accumulation 2 and a K = 2 call
  against the single device: NFE equal, the ranks' parameters and running
  stats bitwise equal to each other, the loss within 1e-5, the updates and
  the running stats within 1e-4 of the largest (``test_torch_cifar.py``'s
  bounds), ``reg_val`` within 1e-2 (its rounding floor is ~1e-3 here).
- **Against JAX's sharded step** (its Pallas conv kernels run as its own
  CIFAR tests run them on the CPU), with JAX's t1 injected: the same
  bounds, but the updates at 1e-3 of the largest, as
  ``test_torch_cifar.py`` holds the single-device step against JAX's.
- **The group BatchNorm** against one process on the concatenated rows.
- **The classification runner** under ``'gspmd'`` on two ranks.

The tolerances stand above the rounding floor that
``tests/dp_tolerance_probe.py`` measures (the single-device step's own
change under a 1e-7 relative change of the data; PERF.md §6), and
``test_rounding_floor_of_the_conv_tolerances`` checks it.
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
    make_eval_step,
    make_multi_train_step,
    make_train_step,
)
from localregneuralde_tpu_torch.nn import BatchNorm
from localregneuralde_tpu_torch.parity import cifar_tree, params_from_jax
from test_torch_parallel import _close_rel, _equal_tree, spawn_ranks
from tests import torch_dp_conv_worker as W

HERE = os.path.dirname(os.path.abspath(__file__))
N, B = 2, W.B
# JAX's train state: its layer key draws the t1 that the JAX comparison
# injects
KEY = 0
TOL = dict(loss_rtol=1e-5, reg_rtol=1e-2, upd_rel=1e-4, stat_rel=1e-4)
# against JAX's Pallas kernels and XLA's convolutions
JAX_TOL = dict(TOL, upd_rel=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, n=B):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 8, 8, 3)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


def _jax_side(regularize="unbiased"):
    jcfg = W.cifar_cfg(jax_define_configuration, [
        "--model.use_pallas=on", f"--model.regularize={regularize}"])
    jmodel = jax_construct_model(jcfg)
    jopt, _ = jax_construct_optimizer(jcfg)
    jts = jax_create_train_state(jmodel, jopt, jax.random.PRNGKey(KEY))
    _, tkey, _ = jax.random.split(jts.state["neural_ode"]["rng"], 3)
    t1 = float(jax.random.uniform(tkey, (), jnp.float32, minval=0.0,
                                  maxval=1.0))
    params = jax.tree_util.tree_map(np.asarray, jts.params)
    params["neural_ode"] = jax.tree_util.tree_map(
        lambda a: W.DYNAMICS_SCALE * a, params["neural_ode"])
    return dict(cfg=jcfg, model=jmodel, opt=jopt, t1=t1, params=params)


@pytest.fixture(scope="module")
def conv(tmp_path_factory):
    """The inputs and every rank's results of the worker on two ranks."""
    d = tmp_path_factory.mktemp("dp_conv")
    side = _jax_side()
    tensors = lambda b: tuple(torch.from_numpy(a) for a in b)  # noqa: E731
    rng = np.random.default_rng(21)
    inp = dict(
        params=side["params"], batch=tensors(_batch(7)),
        batches=[tensors(_batch(s)) for s in (8, 9)], jax_t1=side["t1"],
        bn_x=torch.from_numpy(
            (2.0 * rng.standard_normal((B, 4, 4, 6)) + 0.5).astype(
                np.float32)),
        bn_ct=torch.from_numpy(rng.standard_normal((B, 4, 4, 6)).astype(
            np.float32)),
        bn_scale=torch.from_numpy(
            (1.0 + 0.1 * rng.standard_normal(6)).astype(np.float32)),
        bn_bias=torch.from_numpy((0.1 * rng.standard_normal(6)).astype(
            np.float32)),
    )
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    spawn_ranks(lambda r, port: [
        sys.executable, os.path.join(HERE, "torch_dp_conv_worker.py"),
        str(d / "in.pkl"), str(d), str(r), str(N), str(port)])
    ranks = []
    for r in range(N):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(inp=inp, ranks=ranks)


def _updates(new, old, lr=W.LR):
    return {k: (np.asarray(new[k]) - np.asarray(old[k])) / lr for k in new}


def _check_step(got, ref_params, ref_loss, ref_stats, ref_state, p0,
                loss_rtol, reg_rtol, upd_rel, stat_rel):
    """One rank's step against a reference step from the parameters p0:
    NFE, loss, reg_val, the updates relative to the largest one (the
    augmenter's bias has a zero gradient) and every running stat."""
    assert int(got["stats"]["nfe"]) == int(ref_stats["nfe"])
    np.testing.assert_allclose(got["loss"], float(ref_loss), rtol=loss_rtol)
    np.testing.assert_allclose(got["stats"]["reg_val"],
                               float(ref_stats["reg_val"]), rtol=reg_rtol,
                               atol=1e-12)
    ref, upd = _updates(ref_params, p0), _updates(got["params"], p0)
    assert set(upd) == set(ref)
    scale = max(float(np.abs(v).max()) for v in ref.values())
    for k in ref:
        err = float(np.abs(upd[k] - ref[k]).max())
        assert err <= upd_rel * scale, (k, err, scale)
    assert set(got["state"]) == set(ref_state)
    for k, v in ref_state.items():
        _close_rel(got["state"][k], v, stat_rel)


def _single(inp, use_pallas="on", regularize="unbiased", extra=(), **kw):
    """The port's single-device step on the global batch, with the draws
    its own generators give."""
    setup = W.cifar_setup(inp["params"], use_pallas, regularize, extra)
    model, loss_fn, opt, ts, w = setup
    p0 = W.host(ts.params)
    ts2, loss, stats = make_train_step(model, loss_fn, opt, **kw)(
        ts, inp["batch"], w, W.LR)
    return (W.host(ts2.params), loss, stats, W.host(W.bn_state(ts2.state)),
            p0)


def _check_ranks(conv, key, ref):
    for out in conv["ranks"]:
        _check_step(out["steps"][key], *ref, **TOL)
    a, b = (out["steps"][key] for out in conv["ranks"])
    _equal_tree(a["params"], b["params"])
    _equal_tree(a["state"], b["state"])


# ----------------------------------------------------- against one device

@pytest.mark.parametrize("regularize", W.REGULARIZE)
@pytest.mark.parametrize("use_pallas", W.ROUTES)
def test_global_step_matches_single_device(conv, use_pallas, regularize):
    """One global-grid step on two ranks against the single-device step on
    the global batch, with the port's own draws; on the kernel route the
    plain kernels 13 and 14 run on the whole batch only."""
    _check_ranks(conv, f"step_{use_pallas}_{regularize}",
                 _single(conv["inp"], use_pallas, regularize))
    for out in conv["ranks"]:
        calls = out["steps"][f"step_{use_pallas}_{regularize}"]["calls"]
        if use_pallas == "off":
            assert calls == {}
            continue
        assert set(calls) == {"conv_step_plain", "fused_conv_step_bwd_plain"}
        assert all(rows == B for c in calls.values() for rows in c)


@pytest.mark.parametrize("use_pallas", W.ROUTES)
def test_global_direct_adjoint_matches_single_device(conv, use_pallas):
    """The direct adjoint on the global grid: the kernel route
    differentiates each rank's loss through the whole batch's solve and
    the gather (``mesh.gather_rows_grad``), the eager route through its
    rows' loop."""
    _check_ranks(conv, f"direct_{use_pallas}", _single(
        conv["inp"], use_pallas, extra=["--model.solver.adjoint=direct"]))


@pytest.mark.parametrize("use_pallas", W.ROUTES)
def test_global_eval_matches_single_device(conv, use_pallas):
    """A sharded eval step: the whole eval batch solved on one grid, each
    rank's loss and predictions its rows'."""
    model, loss_fn, _, ts, w = W.cifar_setup(conv["inp"]["params"],
                                             use_pallas)
    loss, stats = make_eval_step(model, loss_fn)(ts, conv["inp"]["batch"], w)
    ys = [out["steps"][f"eval_{use_pallas}"] for out in conv["ranks"]]
    for y in ys:
        assert int(y["nfe"]) == int(stats["nfe"])
    _close_rel(np.concatenate([y["y_pred"] for y in ys]),
               stats["y_pred"].numpy(), 1e-5)
    np.testing.assert_allclose(np.mean([y["loss"] for y in ys]), float(loss),
                               rtol=1e-5)


def test_global_grad_accumulation_matches_single_device(conv):
    """Two microbatches, each spread over the ranks, against the
    single-device step with ``grad_accumulation=2``."""
    _check_ranks(conv, "ga", _single(conv["inp"], grad_accumulation=2))


def test_global_k_step_call_matches_single_device(conv):
    """A K = 2 call on the global grid (eager bodies) against the
    single-device K = 2 call on the same two global batches."""
    model, loss_fn, opt, ts, w = W.cifar_setup(conv["inp"]["params"])
    multi = make_multi_train_step(
        model, loss_fn, opt, reduce_fn=lambda loss, stats, d: {
            "row": torch.stack([loss, stats["reg_val"]])})
    stack = tuple(torch.stack(s) for s in zip(*conv["inp"]["batches"]))
    p0 = W.host(ts.params)
    ts2, loss, red = multi(ts, stack, np.full(2, w, np.float32),
                           np.full(2, W.LR, np.float32))
    ref = _updates(W.host(ts2.params), p0)
    scale = max(float(np.abs(v).max()) for v in ref.values())
    for out in conv["ranks"]:
        got = out["steps"]["kstep"]
        assert got["captured"] is False
        np.testing.assert_allclose(got["loss"], float(loss),
                                   rtol=TOL["loss_rtol"])
        np.testing.assert_allclose(got["red"][0], float(red["row"][0]),
                                   rtol=TOL["loss_rtol"])
        np.testing.assert_allclose(got["red"][1], float(red["row"][1]),
                                   rtol=TOL["reg_rtol"])
        upd = _updates(got["params"], p0)
        for k in ref:
            assert float(np.abs(upd[k] - ref[k]).max()) <= 1e-4 * scale, k
        for k, v in W.host(W.bn_state(ts2.state)).items():
            _close_rel(got["state"][k], v, 1e-4)
    _equal_tree(conv["ranks"][0]["steps"]["kstep"]["params"],
                conv["ranks"][1]["steps"]["kstep"]["params"])


# ------------------------------------------------------------ against JAX

@pytest.mark.parametrize("regularize", W.REGULARIZE)
def test_global_step_matches_jax_sharded_step(conv, regularize):
    """The ranks' kernel-route step with JAX's t1 injected against JAX's
    sharded step on a two-device mesh from the same parameters (its conv
    kernels replicated custom calls on the whole batch, as GSPMD runs
    them): NFE, loss, reg_val, the updates and every running stat."""
    side = _jax_side(regularize)
    jloss, w_sched = jax_construct_loss(side["cfg"])
    jts = jax_create_train_state(side["model"], side["opt"],
                                 jax.random.PRNGKey(KEY))
    jts = dataclasses.replace(jts, params=jax.tree_util.tree_map(
        jnp.asarray, side["params"]))
    batch = tuple(jnp.asarray(a.numpy()) for a in conv["inp"]["batch"])
    jts = settle_state_shapes(side["model"], jloss, jts, batch, w_sched(1))
    mesh = make_mesh({"data": N})
    sh = train_state_shardings(jts, mesh)
    jts = shard_train_state(jts, mesh, shardings=sh)
    step = jax_sharded_step(side["model"], jloss, side["opt"], mesh,
                            ts_shardings=sh)
    jts2, jl, jstats = step(jts, jax_shard_batch(batch, mesh), w_sched(1),
                            W.LR)
    ref = {k: v.numpy() for k, v in params_from_jax(cifar_tree(
        jax.device_get(jts2.params))).items()}
    p0 = {k: v.numpy() for k, v in params_from_jax(cifar_tree(
        side["params"])).items()}
    state = {}
    for path, v in jax.tree_util.tree_leaves_with_path(
            jax.device_get(jts2.state)):
        keys = [getattr(k, "key", None) for k in path]
        if keys[-1] in ("mean", "var"):
            state[".".join(keys)] = np.asarray(v)
    stats = {"nfe": jstats["nfe"], "reg_val": jstats["reg_val"]}
    for out in conv["ranks"]:
        _check_step(out["steps"][f"jax_{regularize}"], ref, jl, stats,
                    state, p0, **JAX_TOL)


# ------------------------------------------------------ the group's moments

def test_group_batchnorm_matches_one_process(conv):
    """The group BatchNorm on each rank's rows against one process on the
    concatenated rows: the output rows and the running stats (bitwise
    equal on the ranks), the input's cotangent rows, and the scale's and
    bias's gradients summed over the ranks (each rank's loss its rows'
    Σ y·c), to float32 rounding; the state carries no group."""
    inp = conv["inp"]
    bn = BatchNorm(6, "gelu")
    with torch.no_grad():
        bn.scale.copy_(inp["bn_scale"])
        bn.bias.copy_(inp["bn_bias"])
    x = inp["bn_x"].clone().requires_grad_()
    y, st = bn(x, bn.init_state(), training=True)
    gx, gs, gb = torch.autograd.grad((y * inp["bn_ct"]).sum(),
                                     [x, bn.scale, bn.bias])
    outs = [out["bn"] for out in conv["ranks"]]
    for out in outs:
        assert out["keys"] == ["mean", "var"]
    _equal_tree(outs[0]["state"], outs[1]["state"])
    for k in ("mean", "var"):
        _close_rel(outs[0]["state"][k], st[k].detach().numpy(), 1e-6)
    _close_rel(np.concatenate([o["y"] for o in outs]), y.detach().numpy(),
               1e-6)
    _close_rel(np.concatenate([o["d_x"] for o in outs]), gx.numpy(), 1e-5)
    _close_rel(outs[0]["d_scale"] + outs[1]["d_scale"], gs.numpy(), 1e-5)
    _close_rel(outs[0]["d_bias"] + outs[1]["d_bias"], gb.numpy(), 1e-5)


def test_group_batchnorm_of_one_rank_is_bitwise_the_layer(conv):
    """A group of one (each rank's own): the output, the running stats and
    the gradients bitwise those of the layer without a group."""
    for out in conv["ranks"]:
        assert out["bn"]["one_rank_bitwise"] == [True] * 6


# ------------------------------------------------------------ the floor

def test_rounding_floor_of_the_conv_tolerances():
    """The single-device CIFAR step's own change under a 1e-7 relative
    change of the data (``tests/dp_tolerance_probe.py``) below every bound
    of ``TOL``, with the regulariser on both routes (its ``none`` rows
    read the same loss and updates: PERF.md §6)."""
    import dp_tolerance_probe as P

    for label in ("cifar on, unbiased", "cifar off, unbiased"):
        spread = P.spread(label)
        assert np.all(spread < np.array([TOL["reg_rtol"], TOL["loss_rtol"],
                                         TOL["upd_rel"]])), (label, spread)


# ----------------------------------------------------------------- runner

def test_classification_runner_gspmd_on_two_ranks(tmp_path):
    """The classification runner with ``cnn.yaml`` at 8×8 images on two
    processes under 'gspmd': rc 0, equal train windows and eval on both
    ranks (each eval batch solved on the global grid), rank 0's
    checkpoint at the canonical place and rank 1's under ``proc1``."""
    cfg = open(W.CONFIG).read().replace("image_size: [32, 32]",
                                        "image_size: [8, 8]")
    path = tmp_path / "cnn8.yaml"
    path.write_text(cfg)
    args = [str(path), "--device=cpu", "--train.total_steps=2",
            "--train.print_frequency=2", "--train.evaluate_every=2",
            "--model.regularize=unbiased", "--model.solver.reltol=1e-2",
            "--model.solver.abstol=1e-2", "--model.solver.max_steps=32",
            "--dataset.train_batchsize=8", "--dataset.eval_batchsize=512",
            "--train.data_parallel=gspmd",
            f"--train.checkpoint_dir={tmp_path}/ck",
            f"--train.log_dir={tmp_path}/lg"]
    outs = spawn_ranks(
        lambda r, port: [sys.executable, "-m",
                         "localregneuralde_tpu_torch.harness.runner", *args],
        env_of=lambda r, port: dict(
            RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(N),
            LOCAL_WORLD_SIZE=str(N), MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(port)),
        cwd=os.path.dirname(HERE))
    res = []
    for _, out, _ in outs:
        lines = out.splitlines()
        summary = [ln for ln in lines if ln.startswith("summary:")][0]
        windows = [{k: v for k, v in (t.split("=") for t in ln.split()[1:])
                    if not k.endswith("_time")}
                   for ln in lines if ln.startswith("[2/2]")]
        res.append((ast.literal_eval(summary.split(":", 1)[1].strip()),
                    windows))
    (s0, w0), (s1, w1) = res
    assert (s0["rank"], s1["rank"], s0["data_parallel"]) == (0, 1, "gspmd")
    assert w0 and w0 == w1
    assert s0["final_eval"] == s1["final_eval"]
    assert np.isfinite(s0["final_eval"]["net_loss"])
    assert "proc" not in s0["ckpt_dir"] and s1["ckpt_dir"].endswith("proc1")
    assert os.path.exists(os.path.join(s0["ckpt_dir"], "model_current.ckpt"))


def test_check_global_grid_takes_the_conv_family():
    """The CIFAR model takes the global grid: its NeuralODE is the DE layer,
    and the step gives the group to the outer BatchNorm too."""
    from localregneuralde_tpu_torch.harness import (
        construct_model, define_configuration,
    )
    from localregneuralde_tpu_torch.parallel.sharded_train import (
        check_global_grid, group_paths,
    )

    model = construct_model(W.cifar_cfg(define_configuration), device="cpu")
    assert check_global_grid(model) == [("neural_ode",)]
    assert group_paths(model) == [("neural_ode",), ("bn",)]
