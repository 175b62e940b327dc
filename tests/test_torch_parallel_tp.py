"""Tensor parallelism of the port's global grid
(``localregneuralde_tpu_torch/parallel``, ``train.tensor_parallel``) on
the CPU: four ranks over Gloo, spawned once (``tests/torch_dp_tp_worker.py``:
a 2 × 2 grid over the world and a 1 × 2 grid over each pair of ranks),
against single-device steps in this process and against the JAX
package's ``make_sharded_train_step`` with its TP rules on a virtual mesh.
Widths are ``tests/test_parallel.py::_tiny_cfg``'s (8 × 8 images, hidden
16) for the MNIST ODE and ``tests/test_torch_parallel_families.py``'s
small latent ODE (node 4, hidden 8).

- **(a) The specs**: the port's sharded dimension of every parameter of
  the four shipped configs at full width equals JAX's
  ``make_param_shardings`` on a ``{"data": 2, "model": 2}`` and a
  ``{"data": 2, "model": 4}`` mesh.
- **(b) The plain route** (the shards computed on in place, the
  dynamics' products column- and row-parallel) against the single
  device and against JAX's TP step: the loss to 1e-4 and the parameters
  to 2e-5 absolute, the tolerances of JAX's own
  ``test_dp_tp_step_matches_single_device``.
- **(c) The kernel route's plain twins** (``use_pallas='on'``: whole
  weights gathered once a call) bitwise the same data degree's global
  grid.
- **(d)** Adam's moments and the EMA cut like their parameters
  (``test_opt_moments_sharded_like_params``).
- **(e)** ``gradient_clip_norm`` on the whole gradient's norm; gradient
  accumulation and the K-step call under TP.
- **(f)** Both runners at 2 × 2, resuming from a single-device checkpoint
  and writing whole arrays that a single device resumes from.
- **(g)** The CIFAR model and the MNIST SDE at tp = 2: every leaf whole,
  bitwise the same data degree's global grid.
"""
import dataclasses
import functools
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
    make_param_shardings as jax_param_shardings,
    make_sharded_train_step as jax_sharded_step,
    shard_batch as jax_shard_batch,
    shard_train_state as jax_shard_train_state,
    sharding_rules_for_mlp_tp as jax_rules,
    train_state_shardings as jax_train_state_shardings,
)
from localregneuralde_tpu_torch.harness import make_train_step
from localregneuralde_tpu_torch.parallel import (
    make_param_shardings, sharding_rules_for_mlp_tp,
)
from localregneuralde_tpu_torch.parity import (
    cifar_tree, latent_tree, params_from_jax,
)
from tests import test_torch_parallel as P
from tests import test_torch_parallel_families as PF
from tests import torch_dp_tp_worker as TW
from tests import torch_dp_worker as W

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORLD = 4
GRIDS = {"2x2": 2, "1x2": 1}  # the grid and its data degree
# JAX's test_dp_tp_step_matches_single_device: the loss, and the
# parameters after one update
LOSS_RTOL, PARAM_ATOL = 1e-4, 2e-5
CONFIGS = {
    "mnist_ode/mlp.yaml": "experiments/mnist_ode/mlp.yaml",
    "physionet.yaml": "experiments/physionet/physionet.yaml",
    "cnn.yaml": "experiments/cifar10/cnn.yaml",
    "mnist_sde/mlp.yaml": "experiments/mnist_sde/mlp.yaml",
}


# ------------------------------------------------------------ the specs

@functools.lru_cache(maxsize=None)
def _jax_params(config):
    """JAX's parameter tree of ``config`` at its shipped widths (the
    leaves' shapes)."""
    cfg = jax_define_configuration([], os.path.join(ROOT, CONFIGS[config]))
    if config == "physionet.yaml":
        model = jax_construct_time_series(
            cfg, saveat=jnp.linspace(0.0, 1.0, 49))
    else:
        model = jax_construct_model(cfg)
    opt, _ = jax_construct_optimizer(cfg)
    # the leaves' shapes are all the rules read
    return jax.eval_shape(lambda: jax_create_train_state(
        model, opt, jax.random.PRNGKey(0)).params)


def _port_params(config):
    from localregneuralde_tpu_torch.harness import (
        construct_model, construct_time_series, define_configuration,
    )

    cfg = define_configuration([], os.path.join(ROOT, CONFIGS[config]))
    if config == "physionet.yaml":
        model = construct_time_series(cfg, saveat=torch.linspace(0, 1, 49),
                                      device="cpu")
    else:
        model = construct_model(cfg, device="cpu")
    return dict(model.named_parameters())


def _to_port_names(config, tree):
    """A JAX tree (of any leaves) flattened to the port's dotted names."""
    if config == "physionet.yaml":
        tree = latent_tree(tree)
    elif config == "cnn.yaml":
        tree = cifar_tree(tree)
    out = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = v
    walk(tree, "")
    return out


# the specs JAX's rules give the shipped widths at tp = 2 (the others whole)
EXPECTED_TP2 = {
    "mnist_ode/mlp.yaml": {"neural_ode.model.layer_0.w": 1,
                           "neural_ode.model.layer_0.b": 0},
    "physionet.yaml": {f"neural_ode.model.layer_{i}.w": 0
                       for i in range(1, 9)},
    "cnn.yaml": {},
    "mnist_sde/mlp.yaml": {},
}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_param_specs_match_jax(config, tp):
    """(a) Every parameter's sharded dimension (None: whole) from the
    port's ``make_param_shardings`` equals JAX's on a ``{"data": 2,
    "model": tp}`` mesh, with JAX's rules; at tp = 2 they are the table of
    the rules' effect on the shipped widths (layer_1 of the TD-MLP whole,
    its 101 rows odd; the latent chain row-parallel, its Lambda being
    layer_0; the conv and SDE models whole)."""
    jparams = _jax_params(config)
    mesh = make_mesh({"data": 2, "model": tp})
    jspec = jax.tree_util.tree_map(
        lambda s: (list(s.spec).index("model") if "model" in tuple(s.spec)
                   else None),
        jax_param_shardings(jparams, mesh, jax_rules("model")),
        is_leaf=lambda s: hasattr(s, "spec"))
    want = _to_port_names(config, jspec)
    ours = make_param_shardings(_port_params(config), tp,
                                sharding_rules_for_mlp_tp())
    assert ours == want
    if tp == 2:
        assert {k: v for k, v in ours.items() if v is not None} == (
            EXPECTED_TP2[config])


# ---------------------------------------------------------- the spawned job

def _jax_mlp():
    """JAX's tiny MNIST ODE (``test_torch_parallel.jax_side``'s: the
    dynamics' weights tripled, so the regulariser stands above its
    rounding), its config, the batch and its t1."""
    cfg = W.mlp_cfg(jax_define_configuration)
    model = jax_construct_model(cfg)
    opt, _ = jax_construct_optimizer(cfg)
    jts = jax_create_train_state(model, opt, jax.random.PRNGKey(P.KEY))
    params = jax.tree_util.tree_map(np.asarray, jts.params)
    params["neural_ode"] = jax.tree_util.tree_map(lambda a: 3.0 * a,
                                                  params["neural_ode"])
    key = jnp.asarray(np.asarray(jts.state["neural_ode"]["rng"]))
    return dict(cfg=cfg, model=model, opt=opt, params=params,
                batch=P._batch(), t1=P._jax_t1(key), key=P.KEY)


def _single_checkpoint(tmp, module):
    """A single-device run of ``module``'s runner for one step: the path
    of its checkpoint, which the ranks resume from."""
    from localregneuralde_tpu_torch.harness import define_configuration
    from localregneuralde_tpu_torch.harness.latent_runner import (
        run_latent_ode_experiment,
    )
    from localregneuralde_tpu_torch.harness.runner import (
        run_classification_experiment,
    )

    args = RUN_ARGS[module]
    cfg = define_configuration(args[1:] + [
        "--train.total_steps=1", f"--train.checkpoint_dir={tmp}/ck",
        f"--train.log_dir={tmp}/lg"], args[0])
    run = (run_classification_experiment if module == "runner"
           else run_latent_ode_experiment)
    summary = run(cfg, "one", device="cpu")
    return os.path.join(summary["ckpt_dir"], "model_current.ckpt")


RUN_ARGS = {
    module: [os.path.join(ROOT, args[0])] + args[1:] + [
        "--train.print_frequency=1", "--train.evaluate_every=2"]
    for module, args in P.RUN_ARGS.items()}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The inputs, JAX's sides and every rank's results of the worker on
    four ranks."""
    torch.set_num_threads(1)
    d = tmp_path_factory.mktemp("tp")
    mlp, lat = _jax_mlp(), PF._jax_latent(PF.JAX_LATENT_KEY)
    tensors = lambda b: tuple(torch.from_numpy(np.asarray(a))  # noqa: E731
                              for a in b)
    inp = dict(
        mlp_params=mlp["params"], mlp_batch=tensors(mlp["batch"]),
        latent_params=lat["params"], latent_batch=tensors(lat["batch"]),
        tgrid=lat["tgrid"], t1={"mlp": mlp["t1"], "latent": lat["t1"]},
        eps=lat["eps"],
        runners={k: [a for a in v] + ["--train.total_steps=2"]
                 for k, v in RUN_ARGS.items()},
        resume={k: _single_checkpoint(d / f"one_{k}", k) for k in RUN_ARGS})
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    P.spawn_ranks(lambda r, port: [
        sys.executable, os.path.join(HERE, "torch_dp_tp_worker.py"),
        str(d / "in.pkl"), str(d), str(r), str(WORLD), str(port)],
        n=WORLD, timeout=300)
    ranks = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(inp=inp, ranks=ranks, jax=dict(mlp=mlp, latent=lat), dir=d)


# ------------------------------------------------------------ the steps

def _single(inp, family, extra=()):
    """The port's single-device step of ``family`` on the whole batch with
    JAX's draws injected: the parameters after it and the loss."""
    restore = TW.inject(inp)
    try:
        model, loss_fn, opt, ts, w, batch = TW.setup(inp, family, extra)
        ts, loss, _ = make_train_step(model, loss_fn, opt)(ts, batch, w,
                                                           W.LR)
    finally:
        restore()
    return W.host(ts.params), float(loss)


def _jax_tp(side, family, n_data):
    """JAX's ``make_sharded_train_step`` with the TP rules on a
    ``{"data": n_data, "model": 2}`` mesh: the parameters after the step
    (in the port's names) and the loss."""
    cfg = side["cfg"] if family == "mlp" else side["cfg"]
    jloss, w_sched = jax_construct_loss(cfg)
    w = (W.W_REG if family == "mlp"
         else (float(w_sched[0](1)), 0.5))
    key = side["key"] if family == "mlp" else PF.JAX_LATENT_KEY
    jts = jax_create_train_state(side["model"], side["opt"],
                                 jax.random.PRNGKey(key))
    jts = dataclasses.replace(jts, params=jax.tree_util.tree_map(
        jnp.asarray, side["params"]))
    batch = tuple(jnp.asarray(a) for a in side["batch"])
    jts = settle_state_shapes(side["model"], jloss, jts, batch, w)
    mesh = make_mesh({"data": n_data, "model": 2})
    rules = jax_rules("model")
    sh = jax_train_state_shardings(jts, mesh, rules)
    jts = jax_shard_train_state(jts, mesh, shardings=sh)
    step = jax_sharded_step(side["model"], jloss, side["opt"], mesh,
                            rules=rules, ts_shardings=sh)
    jts2, jl, _ = step(jts, jax_shard_batch(batch, mesh), w, W.LR)
    new = jax.tree_util.tree_map(np.asarray, jax.device_get(jts2.params))
    if family == "latent":
        new = latent_tree(new)
    return {k: v.numpy() for k, v in params_from_jax(new).items()}, float(jl)


def _close_params(got, ref, atol):
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol,
                                   err_msg=k)


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("family", ["mlp", "latent"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_plain_route_matches_single_device_and_jax(tp, grid, family):
    """(b) The plain route's TP step (the TD-MLP's first layer
    column-parallel, the latent chain's eight layers row-parallel) on
    every rank: the whole parameters after it and the loss against the
    single-device step and against JAX's TP step on the same data degree's
    mesh, from the same parameters with the same draws, at JAX's test's
    tolerances; every rank the same bytes."""
    ref, ref_loss = _single(tp["inp"], family)
    jref, jloss = _jax_tp(tp["jax"][family], family, GRIDS[grid])
    for out in tp["ranks"]:
        got = out[grid][f"{family} plain"]
        assert got["specs"] and any(d is not None
                                    for d in got["specs"].values())
        for want, want_loss in ((ref, ref_loss), (jref, jloss)):
            if family == "mlp":
                np.testing.assert_allclose(got["loss"], want_loss,
                                           rtol=LOSS_RTOL)
                _close_params(got["params"], want, PARAM_ATOL)
            else:
                _close_updates(got, want, want_loss,
                               tp["inp"]["latent_params"])
        _equal(got["params"], tp["ranks"][0][grid][f"{family} plain"]
               ["params"])


def _close_updates(got, want, want_loss, params0):
    """The latent model's step from the JAX-layout ``params0`` at the DP
    tests' recipe (``tests/test_torch_parallel_families.py::TOL``, above
    the rounding floor that ``tests/dp_tolerance_probe.py`` measures): the
    loss to 1e-5 and the SGD updates to 1e-3 of the largest. JAX's
    parameter tolerance (2e-5 absolute) is not the measure there: the
    model's NLL (~9,500) makes updates of several units, and the row-
    parallel sums' other order of addition parts the TP step's parameters
    from the single device's by up to 6e-4 in an element."""
    tol = PF.TOL["latent"]
    np.testing.assert_allclose(got["loss"], want_loss, rtol=tol["loss_rtol"])
    p0 = {k: v.numpy()
          for k, v in params_from_jax(latent_tree(params0)).items()}
    upd, ref = PF._updates(got["params"], p0), PF._updates(want, p0)
    assert set(upd) == set(ref)
    for k in ref:
        P._close_rel(upd[k], ref[k], tol["upd_rel"])


@pytest.mark.parametrize("family", ["mlp", "latent"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_kernel_route_twins_are_bitwise_the_global_grid(tp, grid, family):
    """(c) ``use_pallas='on'`` (the kernel route, its kernels' plain twins
    on the CPU) under TP, the whole weights gathered once a call: loss,
    NFE, reg_val and the whole parameters after the step bitwise the same
    data degree's global-grid step without TP."""
    for out in tp["ranks"]:
        got = out[grid][f"{family} kernel"]
        ref = out[grid][f"{family} kernel dp"]
        assert got["specs"] and ref["specs"] is None
        for k in ("loss", "nfe", "reg_val"):
            np.testing.assert_array_equal(got[k], ref[k])
        _equal(got["params"], ref["params"])


@pytest.mark.parametrize("grid", list(GRIDS))
def test_moments_and_ema_cut_like_their_params(tp, grid):
    """(d) ``test_opt_moments_sharded_like_params``: after
    ``shard_train_state`` each sharded parameter, its Adam moments and its
    EMA hold this model rank's slice (the shapes of the shard, the values
    of the slice, bitwise the same data degree's global grid's on the
    kernel route); gathered, they are the whole ones."""
    for out in tp["ranks"]:
        m = out[grid]["shape"][3]
        got, ref = out[grid]["moments"], out[grid]["moments dp"]
        specs = got["specs"]
        sharded = {k: d for k, d in specs.items() if d is not None}
        assert sharded
        sh = got["shards"]
        for k, d in sharded.items():
            n = ref["params"][k].shape[d] // 2
            piece = lambda a: np.take(a, range(m * n, (m + 1) * n),  # noqa
                                      axis=d)
            assert sh["params"][k].shape == piece(ref["params"][k]).shape
            np.testing.assert_array_equal(sh["params"][k],
                                          piece(ref["params"][k]))
            np.testing.assert_array_equal(sh["ema"][k], piece(ref["ema"][k]))
            for slot in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_array_equal(
                    sh["opt"][k][slot], piece(ref["opt"][k][slot]))
        for k in specs:
            if k not in sharded:
                assert sh["params"][k].shape == ref["params"][k].shape
        _equal(got["params"], ref["params"])
        _equal(got["ema"], ref["ema"])
        for k in ref["opt"]:
            _equal(got["opt"][k], ref["opt"][k])


@pytest.mark.parametrize("grid", list(GRIDS))
def test_accumulation_and_k_step_call_under_tp(tp, grid):
    """Gradient accumulation (two microbatches, each over the data ranks)
    and the K-step call (K = 2, eager bodies) work under TP as on the
    global grid: the first bitwise the same data degree's global grid
    with two microbatches, the second bitwise two single TP calls."""
    for out in tp["ranks"]:
        got, ref = out[grid]["ga"], out[grid]["ga dp"]
        np.testing.assert_array_equal(got["loss"], ref["loss"])
        _equal(got["params"], ref["params"])
        k = out[grid]["kstep"]
        assert k["captured"] is False
        np.testing.assert_array_equal(k["multi"]["loss"], k["single"]["loss"])
        _equal(k["multi"]["params"], k["single"]["params"])


@pytest.mark.parametrize("grid", list(GRIDS))
def test_clip_norm_takes_the_whole_gradient(tp, grid):
    """(e) ``gradient_clip_norm`` (1e-3, below the gradient's norm, so the
    step clips) under TP: the plain route against the single device at
    JAX's test's tolerances, the kernel route's twins against the same
    data degree's global grid (the squared norm's terms added in another
    order: 1e-6 of the largest parameter change)."""
    ref, ref_loss = _single(tp["inp"], "mlp", TW.CLIP)
    p0 = {k: v.numpy() for k, v in params_from_jax(
        tp["inp"]["mlp_params"]).items()}
    moved = max(float(np.abs(ref[k] - p0[k]).max()) for k in ref)
    assert 0 < moved < 1e-3 * W.LR * 1.01  # the update was clipped
    for out in tp["ranks"]:
        got = out[grid]["clip"]
        np.testing.assert_allclose(got["loss"], ref_loss, rtol=LOSS_RTOL)
        _close_params(got["params"], ref, PARAM_ATOL)
        k, kd = out[grid]["clip kernel"], out[grid]["clip kernel dp"]
        _close_params(k["params"], kd["params"], 1e-6 * moved)


@pytest.mark.parametrize("family", ["cifar", "sde"])
def test_replicated_families_at_tp2(tp, family):
    """(g) ``cnn.yaml``'s and the MNIST SDE's models at tp = 2 on the 2 × 2
    grid: no leaf sharded, and the step bitwise the same data degree's
    global grid."""
    for out in tp["ranks"]:
        res = out["2x2"]
        assert all(d is None for d in res[f"{family} specs"].values())
        _equal(res[f"{family} tp"]["params"], res[f"{family} dp"]["params"])
        np.testing.assert_array_equal(res[f"{family} tp"]["loss"],
                                      res[f"{family} dp"]["loss"])


# ------------------------------------------------------------ the runners

@pytest.mark.parametrize("module", ["runner", "latent_runner"])
def test_checkpoints_round_trip(tp, module):
    """(f) Each runner at 2 × 2 under ``gspmd`` with tensor_parallel=2:
    resumed from a single device's checkpoint at step 1, its windows equal
    on every rank, its checkpoint (world rank 0's) holds whole arrays, as
    a single-device run does, and within JAX's test's tolerances of a
    single device resumed from the same checkpoint; a single device then
    resumes from it."""
    from localregneuralde_tpu_torch.harness import define_configuration
    from localregneuralde_tpu_torch.harness.checkpoint import load_checkpoint
    from localregneuralde_tpu_torch.harness.latent_runner import (
        run_latent_ode_experiment,
    )
    from localregneuralde_tpu_torch.harness.runner import (
        run_classification_experiment,
    )

    summaries = [out["runners"][module] for out in tp["ranks"]]
    assert [s["rank"] for s in summaries] == list(range(WORLD))
    assert all(s["tensor_parallel"] == 2 and s["world_size"] == WORLD
               for s in summaries)
    final = ("final_eval" if module == "runner" else "final_eval_mse")
    assert all(s[final] == summaries[0][final] for s in summaries)
    ck = load_checkpoint(os.path.join(summaries[0]["ckpt_dir"],
                                      "model_current.ckpt"))
    assert ck["step"] == 2
    d = tp["dir"]
    run = (run_classification_experiment if module == "runner"
           else run_latent_ode_experiment)
    args = RUN_ARGS[module]
    cfg = define_configuration(args[1:] + [
        "--train.total_steps=2", f"--train.checkpoint_dir={d}/two_{module}",
        f"--train.log_dir={d}/two_{module}",
        f"--train.resume={tp['inp']['resume'][module]}"], args[0])
    one = run(cfg, "two", device="cpu")
    ref = load_checkpoint(os.path.join(one["ckpt_dir"], "model_current.ckpt"))
    for part in ("params", "ema"):
        if ref["tstate"][part] is None:
            assert ck["tstate"][part] is None
            continue
        _close_params(ck["tstate"][part], ref["tstate"][part], PARAM_ATOL)
    for i, st in ref["tstate"]["opt"]["state"].items():
        for slot, v in st.items():
            assert np.shape(ck["tstate"]["opt"]["state"][i][slot]) == (
                np.shape(v))
    cfg = define_configuration(args[1:] + [
        "--train.total_steps=3", f"--train.checkpoint_dir={d}/three_{module}",
        f"--train.log_dir={d}/three_{module}",
        f"--train.resume={summaries[0]['ckpt_dir']}/model_current.ckpt"],
        args[0])
    three = run(cfg, "three", device="cpu")
    assert "data_parallel" not in three
    ck3 = load_checkpoint(os.path.join(three["ckpt_dir"],
                                       "model_current.ckpt"))
    assert ck3["step"] == 3
