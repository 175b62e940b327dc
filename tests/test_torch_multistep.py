"""The K-step train call, gradient accumulation, the params-EMA and the
runners' block loops of the port, on the CPU at small sizes.

- ``make_multi_train_step`` against K ``make_train_step`` calls in the
  port: bitwise (the same body on the same staged inputs), for the TD-MLP
  ODE, the SDE and the latent families, with and without microbatches and
  the EMA.
- The staged draws (``models/draws.py``) against the draws a layer makes
  inside its call, and the generators' states after both.
- The port's K-step call, microbatched step and EMA against JAX's
  ``make_multi_train_step``, ``make_train_step(grad_accumulation=2)`` and
  ``ema_decay``, from the same parameters without the regulariser (whose t1
  the two packages draw from different generators), at the JAX tests' own
  tolerances (``tests/test_multistep_call.py:57-101``,
  ``test_grad_accum.py:60-109``, ``test_ema.py:47-87``).
- ``resolve_steps_per_call`` against JAX's rule, the validation errors, and
  both runners: block mode against single-step mode (the same logs,
  evaluations and checkpoints), a resume off the K grid, the EMA end to
  end and a checkpoint written without an EMA.
"""
import copy
import os
import pickle

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
from localregneuralde_tpu.harness.runner import (
    resolve_steps_per_call as jax_resolve_steps_per_call,
)
from localregneuralde_tpu.harness.train import (
    create_train_state as jax_create_train_state,
    init_ema as jax_init_ema,
    make_multi_train_step as jax_make_multi_train_step,
    make_train_step as jax_make_train_step,
)
from localregneuralde_tpu_torch.harness import (
    construct_loss,
    construct_model,
    construct_optimizer,
    construct_time_series,
    create_train_state,
    define_configuration,
    init_ema,
    make_multi_train_step,
    make_train_step,
    one_hot,
    resolve_steps_per_call,
    swap_ema_params,
    synthetic_classification,
)
from localregneuralde_tpu_torch.harness.checkpoint import (
    load_checkpoint,
    to_host,
)
from localregneuralde_tpu_torch.harness.graph import capturable
from localregneuralde_tpu_torch.harness.latent_runner import (
    build_physionet_arrays,
    run_latent_ode_experiment,
)
from localregneuralde_tpu_torch.harness.runner import (
    run_classification_experiment,
)
from localregneuralde_tpu_torch.harness.train import stage_step
from localregneuralde_tpu_torch.models import common, neural_ode, neural_sde
from localregneuralde_tpu_torch.models.draws import stage_draws
from localregneuralde_tpu_torch.parity import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ODE = os.path.join(ROOT, "experiments", "mnist_ode", "mlp.yaml")
SDE = os.path.join(ROOT, "experiments", "mnist_sde", "mlp.yaml")
LATENT = os.path.join(ROOT, "experiments", "physionet", "physionet.yaml")
CIFAR = os.path.join(ROOT, "experiments", "cifar10", "cnn.yaml")
K, B = 3, 8
ODE_SMALL = ["--model.mlp_hidden_state_size=16", "--model.solver.reltol=3e-2",
             "--model.solver.abstol=3e-2", "--model.solver.max_steps=64"]
SDE_SMALL = ["--model.solver.max_steps=64"]
LATENT_SMALL = [
    "--model.ts_in_dims=5", "--model.ts_hidden_dims=8",
    "--model.ts_latent_dims=6", "--model.ts_node_dims=4",
    "--model.solver.reltol=1e-3", "--model.solver.abstol=1e-3",
    "--model.solver.max_steps=64",
]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(define, path, extra=()):
    cfg = define(list(extra), path)
    if cfg.model.model_type == "mlp":
        cfg.model.image_size = [4, 8]
        cfg.model.in_channels = 1
    return cfg


def _family(name, extra=()):
    """(model, loss_fn, optimizer, w_regs(k), lrs(k), K batches) of a
    family at small width, on the CPU."""
    if name == "latent":
        cfg = define_configuration(LATENT_SMALL + list(extra), LATENT)
        train, _, tgrid, _ = build_physionet_arrays(cfg)
        model = construct_time_series(cfg, saveat=torch.from_numpy(tgrid),
                                      device="cpu")
        loss_fn, (w_reg, w_kl) = construct_loss(cfg)
        opt, sched = construct_optimizer(cfg)
        batches = [tuple(torch.from_numpy(a[i * B:(i + 1) * B])
                         for a in train) for i in range(K)]
        ws = (np.asarray([w_reg(s + 1) for s in range(K)], np.float32),
              np.asarray([w_kl(s + 1) for s in range(K)], np.float32))
        return model, loss_fn, opt, ws, sched, batches
    path, small = (ODE, ODE_SMALL) if name == "ode" else (SDE, SDE_SMALL)
    cfg = _cfg(define_configuration, path, small + list(extra))
    model = construct_model(cfg, device="cpu")
    loss_fn, w_reg = construct_loss(cfg)
    opt, sched = construct_optimizer(cfg)
    x, y, _, _ = synthetic_classification((4, 8), 1, 10, n_train=B * K,
                                          n_test=1, seed=3)
    y1 = one_hot(y, 10)
    batches = [(torch.tensor(x[i * B:(i + 1) * B]),
                torch.tensor(y1[i * B:(i + 1) * B])) for i in range(K)]
    ws = np.asarray([w_reg(s + 1) for s in range(K)], np.float32)
    return model, loss_fn, opt, ws, sched, batches


def _w_at(ws, k):
    return (tuple(float(w[k]) for w in ws) if isinstance(ws, tuple)
            else float(ws[k]))


def _generators(tree):
    if isinstance(tree, torch.Generator):
        return [tree]
    if isinstance(tree, dict):
        return [g for v in tree.values() for g in _generators(v)]
    return []


def _host(ts):
    """Everything a step updates, on the host: the parameters, the
    optimizer's moments and step counts, the EMA and the layer state (the
    generators as their states)."""
    opt = {k: dict(ts.opt_state.state[p]) for k, p in ts.params.items()}
    return to_host({"params": ts.params, "opt": opt, "ema": ts.ema,
                    "state": ts.state})


def _assert_bitwise(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_bitwise(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


# ---------------------------------------------------------- K-step call


@pytest.mark.parametrize("extras", [(1, 0.0), (2, 0.9)],
                         ids=["plain", "ga2_ema"])
@pytest.mark.parametrize("family", ["ode", "sde", "latent"])
def test_multi_step_equals_single_steps(family, extras):
    """One K-step call from a copy of the train state equals K train steps
    from another, bitwise: parameters, optimizer state, EMA, layer state,
    generators, the last loss and the summed loss and NFE."""
    ga, ed = extras
    model, loss_fn, opt, ws, sched, batches = _family(
        family, ["--model.regularize=unbiased"])
    ts0 = create_train_state(model, opt)
    if ed:
        ts0 = init_ema(ts0)
    lrs = np.asarray([sched(s + 1) for s in range(K)], np.float32)

    def reduce_fn(loss, stats, data):
        nfe = stats["nfe"]
        nfe = nfe[0] if isinstance(nfe, tuple) else nfe
        return {"loss": loss, "nfe": nfe.float(), "reg": stats["reg_val"]}

    step = make_train_step(model, loss_fn, opt, grad_accumulation=ga,
                           ema_decay=ed)
    a, red_a = copy.deepcopy(ts0), None
    for k in range(K):
        a, loss_a, stats = step(a, batches[k], _w_at(ws, k), float(lrs[k]))
        r = reduce_fn(loss_a, stats, batches[k])
        red_a = r if red_a is None else {n: red_a[n] + r[n] for n in r}
    multi = make_multi_train_step(model, loss_fn, opt, reduce_fn,
                                  grad_accumulation=ga, ema_decay=ed)
    stack = tuple(torch.stack([b[i] for b in batches])
                  for i in range(len(batches[0])))
    b, loss_b, red_b = multi(copy.deepcopy(ts0), stack, ws, lrs)
    assert not multi.captured  # the CPU runs the K eager bodies
    assert a.step == b.step == K
    assert torch.equal(loss_a, loss_b)
    for n in red_a:
        assert torch.equal(red_a[n], red_b[n]), n
    _assert_bitwise(_host(a), _host(b))


def _record(monkeypatch, module, name, log):
    fn = getattr(module, name)

    def recorded(*args):
        out = fn(*args)
        log.append((name, torch.as_tensor(out).clone()))
        return out

    monkeypatch.setattr(module, name, recorded)


@pytest.mark.parametrize("family", ["sde", "latent"])
def test_staged_draws_equal_the_calls_draws(family, monkeypatch):
    """The draws a step stages ahead equal, in value and order, the ones
    the layers draw inside K training calls given no staged draws, and leave
    every generator in the same state."""
    model, loss_fn, opt, ws, _, batches = _family(
        family, ["--model.regularize=unbiased"])
    ts = create_train_state(model, opt)
    s_call, s_staged = copy.deepcopy(ts.state), copy.deepcopy(ts.state)
    log = []
    for module, names in ((neural_ode, ("sample_t1",)),
                          (neural_sde, ("sample_noise_seed", "sample_t1",
                                        "sample_reg_noise")),
                          (common, ("reparam_noise",))):
        for name in names:
            _record(monkeypatch, module, name, log)
    for k in range(K):
        _, st, _ = loss_fn(model, ts.params, s_call, batches[k],
                           _w_at(ws, k), training=True)
        s_call = st
    in_call = list(log)
    log.clear()
    staged = [stage_step(model, s_staged, B, 1)[0] for _ in range(K)]
    assert [n for n, _ in log] == [n for n, _ in in_call]
    flat = [v for step in staged for d in step.values() for v in d.values()]
    assert len(flat) == len(in_call)
    for (name, drawn), v in zip(in_call, flat):
        if name == "sample_noise_seed":  # staged as the word's int32 bits
            assert int(drawn) & 0xFFFFFFFF == int(v) & 0xFFFFFFFF
        else:
            assert torch.equal(drawn.to(v.dtype).reshape(v.shape), v), name
    gens_call, gens_staged = _generators(s_call), _generators(s_staged)
    assert len(gens_call) == len(gens_staged) > 0
    for g, h in zip(gens_call, gens_staged):
        assert torch.equal(g.get_state(), h.get_state())


def test_stage_draws_finds_every_stochastic_layer():
    """The latent model stages ε and t1; the SDE its seed, t1 and the
    regulariser's noise; without the regulariser the ODE stages nothing."""
    model, *_ = _family("latent", ["--model.regularize=unbiased"])
    staged = stage_draws(model, model.init_state(), B)
    assert {p: set(d) for p, d in staged.items()} == {
        ("reparam",): {"eps"}, ("neural_ode",): {"t1"}}
    assert tuple(staged[("reparam",)]["eps"].shape) == (B, 4)
    model, *_ = _family("sde", ["--model.regularize=unbiased"])
    staged = stage_draws(model, model.init_state(), B)
    assert set(staged[("neural_dsde",)]) == {"seed", "t1", "reg_noise"}
    assert staged[("neural_dsde",)]["seed"].dtype == torch.int32
    model, *_ = _family("ode", ["--model.regularize=none"])
    assert stage_draws(model, model.init_state(), B) == {(
        "neural_ode",): {}}
    assert not capturable(model, B, "cpu")


# ------------------------------------------------- against the JAX package


def _jax_pair(extra=()):
    """The same MNIST ODE (no regulariser) in both packages from JAX's
    parameters, with K batches of 16."""
    overrides = ODE_SMALL + ["--model.regularize=none"] + list(extra)
    jcfg = _cfg(jax_define_configuration, ODE,
                overrides + ["--model.use_pallas=off"])
    jmodel = jax_construct_model(jcfg)
    jloss, _ = jax_construct_loss(jcfg)
    jopt, _ = jax_construct_optimizer(jcfg)
    jts = jax_create_train_state(jmodel, jopt, jax.random.PRNGKey(0))
    cfg = _cfg(define_configuration, ODE, overrides + ["--model.use_pallas=on"])
    model = construct_model(cfg, device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jts.params))
    loss_fn, _ = construct_loss(cfg)
    opt, _ = construct_optimizer(cfg)
    rng = np.random.RandomState(0)
    xs = rng.rand(K, 16, 4, 8, 1).astype(np.float32)
    ys = np.eye(10, dtype=np.float32)[rng.randint(0, 10, size=(K, 16))]
    return (jmodel, jloss, jopt, jts), (model, loss_fn, opt), (xs, ys)


def _params_close(ts, jparams, rtol, atol):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        name = ".".join(k.key for k in path)
        np.testing.assert_allclose(ts.params[name].detach().numpy(),
                                   np.asarray(leaf), rtol=rtol, atol=atol)


def test_multi_step_matches_jax():
    """tests/test_multistep_call.py:57-101 across the packages: the last
    and summed loss and the parameters within rtol 2e-5 and atol 1e-6, the
    summed NFE exactly."""
    (jmodel, jloss, jopt, jts), (model, loss_fn, opt), (xs, ys) = _jax_pair()
    w_regs = np.asarray([0.3, 0.2, 0.1], np.float32)
    lrs = np.asarray([1e-3, 9e-4, 8e-4], np.float32)

    def jreduce(loss, stats, data):
        return {"loss": loss, "nfe": stats["nfe"].astype(jnp.float32)}

    jms = jax_make_multi_train_step(jmodel, jloss, jopt, reduce_fn=jreduce)
    jts2, jlast, jred = jms(jts, (jnp.asarray(xs), jnp.asarray(ys)),
                            jnp.asarray(w_regs), jnp.asarray(lrs))
    multi = make_multi_train_step(
        model, loss_fn, opt,
        lambda loss, stats, data: {"loss": loss, "nfe": stats["nfe"].float()})
    ts, last, red = multi(create_train_state(model, opt),
                          (torch.tensor(xs), torch.tensor(ys)), w_regs, lrs)
    assert ts.step == int(jts2.step) == K
    np.testing.assert_allclose(float(last), float(jlast), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(red["loss"]), float(jred["loss"]),
                               rtol=2e-5, atol=1e-6)
    assert float(red["nfe"]) == float(jred["nfe"])
    _params_close(ts, jts2.params, 2e-5, 1e-6)


def test_grad_accumulation_matches_jax():
    """tests/test_grad_accum.py:60-109 across the packages: one update on
    the mean of two half-batch gradients (parameters within 2e-6), the mean
    loss (rtol 1e-6), the summed NFE, the re-concatenated y_pred and the
    ANDed solver flag."""
    (jmodel, jloss, jopt, jts), (model, loss_fn, opt), (xs, ys) = _jax_pair()
    x, y = xs[0], ys[0]
    jstep = jax_make_train_step(jmodel, jloss, jopt, grad_accumulation=2)
    jts2, jl, js = jstep(jts, (jnp.asarray(x), jnp.asarray(y)), 1.0, 1e-3)
    step = make_train_step(model, loss_fn, opt, grad_accumulation=2)
    ts, loss, stats = step(create_train_state(model, opt),
                           (torch.tensor(x), torch.tensor(y)), 1.0, 1e-3)
    _params_close(ts, jts2.params, 2e-6, 2e-6)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    assert int(stats["nfe"]) == int(js["nfe"])
    np.testing.assert_allclose(stats["y_pred"].numpy(),
                               np.asarray(js["y_pred"]), rtol=1e-6, atol=1e-6)
    assert bool(stats["solver_success"]) == bool(js["solver_success"])


def test_ema_matches_jax():
    """tests/test_ema.py:47-87 across the packages: two steps at decay 0.75
    from an EMA seeded at the parameters, the EMA within rtol 1e-6 and atol
    1e-7 of JAX's; the swapped view holds the EMA, the raw parameters
    differ from it; without an EMA the swap is the identity."""
    (jmodel, jloss, jopt, jts), (model, loss_fn, opt), (xs, ys) = _jax_pair()
    d = 0.75
    jstep = jax_make_train_step(jmodel, jloss, jopt, ema_decay=d)
    step = make_train_step(model, loss_fn, opt, ema_decay=d)
    jts, ts = jax_init_ema(jts), init_ema(create_train_state(model, opt))
    for k in range(2):
        data = (xs[k], ys[k])
        jts, _, _ = jstep(jts, tuple(jnp.asarray(a) for a in data), 1.0, 1e-3)
        ts, _, _ = step(ts, tuple(torch.tensor(a) for a in data), 1.0, 1e-3)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jts.ema):
        name = ".".join(k.key for k in path)
        np.testing.assert_allclose(ts.ema[name].numpy(), np.asarray(leaf),
                                   rtol=1e-6, atol=1e-7)
    swapped = swap_ema_params(ts)
    assert swapped.params is ts.ema
    assert not torch.equal(ts.params["classifier.w"], ts.ema["classifier.w"])
    plain = create_train_state(model, opt)
    assert plain.ema is None and swap_ema_params(plain) is plain


@pytest.mark.parametrize("spc", [0, 1, 2, 4, 16])
def test_resolve_steps_per_call_matches_jax(spc):
    """JAX's rule with the captured call in the TPU's place, on the shipped
    configs' cadences and a few others: auto is 5 for mlp.yaml, mnist_sde,
    physionet and cnn.yaml where the step is captured, and 1 otherwise."""
    cadences = []
    for path in (ODE, SDE, LATENT, CIFAR):
        cfg = define_configuration([], path)
        cadences.append((cfg.train.print_frequency, cfg.train.evaluate_every))
    cadences += [(2, 4), (7, 14), (3, 5), (8, 16)]
    for pf, ee in cadences:
        assert resolve_steps_per_call(spc, pf, ee, True) == (
            jax_resolve_steps_per_call(spc, pf, ee, backend="tpu"))
        assert resolve_steps_per_call(spc, pf, ee, False) == (
            jax_resolve_steps_per_call(spc, pf, ee, backend="cpu"))
    if spc == 0:
        assert [resolve_steps_per_call(0, pf, ee, capturable=True)
                for pf, ee in cadences[:4]] == [5, 5, 5, 5]


# ------------------------------------------------------------- the runners


def _ode_runner_cfg(tmp, **train):
    cfg = _cfg(define_configuration, ODE, ODE_SMALL + [
        "--model.regularize=unbiased", "--dataset.train_batchsize=16",
        "--dataset.eval_batchsize=64", f"--train.checkpoint_dir={tmp}/ckpt",
        f"--train.log_dir={tmp}/logs"])
    cfg.model.image_size = [8, 8]
    for k, v in dict(dict(total_steps=4, print_frequency=2, evaluate_every=4),
                     **train).items():
        setattr(cfg.train, k, v)
    return cfg


def _latent_runner_cfg(tmp, **train):
    cfg = define_configuration(LATENT_SMALL + [
        "--dataset.train_batchsize=8", "--dataset.eval_batchsize=205",
        f"--train.checkpoint_dir={tmp}/ckpt", f"--train.log_dir={tmp}/logs"],
        LATENT)
    for k, v in dict(dict(total_steps=4, print_frequency=2, evaluate_every=4),
                     **train).items():
        setattr(cfg.train, k, v)
    return cfg


def _rows(summary, name):
    path = os.path.join(summary["log_dir"], name)
    rows = np.genfromtxt(path, delimiter=",", names=True)
    return np.atleast_1d(rows)


def _ckpts(summary):
    return sorted(f for f in os.listdir(summary["ckpt_dir"])
                  if f.startswith("model_step_"))


def _current(summary):
    return load_checkpoint(os.path.join(summary["ckpt_dir"],
                                        "model_current.ckpt"))["tstate"]


@pytest.mark.parametrize("runner", ["classification", "latent"])
def test_runner_block_mode_matches_single(tmp_path, runner):
    """steps_per_call=2 against 1: the same parameters and optimizer state
    (bitwise: the same bodies on the CPU), log rows and evaluations at the
    same steps with the same values, and the same checkpoints."""
    run, make = ((run_classification_experiment, _ode_runner_cfg)
                 if runner == "classification"
                 else (run_latent_ode_experiment, _latent_runner_cfg))
    out = {spc: run(make(tmp_path / f"k{spc}", steps_per_call=spc),
                    device="cpu") for spc in (1, 2)}
    assert out[1]["steps_per_call"] == 1 and out[2]["steps_per_call"] == 2
    assert not out[2]["captured"]
    a, b = (_rows(out[s], "results_train.csv") for s in (1, 2))
    assert list(a["step"]) == list(b["step"]) == [2, 4]
    for name in a.dtype.names:
        if name.endswith("_time"):
            continue
        np.testing.assert_allclose(b[name], a[name], rtol=1e-6)
    assert _ckpts(out[1]) == _ckpts(out[2]) == ["model_step_4.ckpt"]
    _assert_bitwise(_current(out[1])["params"], _current(out[2])["params"])
    _assert_bitwise(_current(out[1])["opt"], _current(out[2])["opt"])
    key = "final_eval" if runner == "classification" else "final_eval_mse"
    assert out[1][key] == out[2][key]


def test_runner_block_mode_realigns_on_resume(tmp_path):
    """A resume off the K grid: a single-step run's checkpoint at step 1,
    resumed at step 2 with K = 2 (one partial block, then a whole one),
    ends where the single-step run ends, bitwise."""
    full = run_classification_experiment(
        _ode_runner_cfg(tmp_path / "a", evaluate_every=1, print_frequency=1),
        device="cpu")
    resumed_cfg = _ode_runner_cfg(tmp_path / "b", steps_per_call=2)
    resumed_cfg.train.resume = os.path.join(full["ckpt_dir"],
                                            "model_step_1.ckpt")
    resumed = run_classification_experiment(resumed_cfg, device="cpu")
    assert resumed["steps_per_call"] == 2
    _assert_bitwise(_current(full)["params"], _current(resumed)["params"])
    assert list(_rows(resumed, "results_train.csv")["step"]) == [2, 4]


@pytest.mark.parametrize("runner", ["classification", "latent"])
def test_runner_ema_end_to_end(tmp_path, runner):
    """ema_decay=0.9 with grad_accumulation=2 and K = 2: the checkpoint
    keeps a finite EMA beside the parameters, and the evaluation is the
    EMA's."""
    run, make = ((run_classification_experiment, _ode_runner_cfg)
                 if runner == "classification"
                 else (run_latent_ode_experiment, _latent_runner_cfg))
    out = run(make(tmp_path, ema_decay=0.9, grad_accumulation=2,
                   steps_per_call=2), device="cpu")
    ck = _current(out)
    assert set(ck["ema"]) == set(ck["params"])
    assert all(np.isfinite(v).all() for v in ck["ema"].values())
    assert any(not np.array_equal(ck["ema"][k], ck["params"][k])
               for k in ck["params"])
    if runner == "classification":
        assert np.isfinite(out["final_eval"]["accuracy_top1"])
        assert out["final_eval"]["nfe"] > 0
    else:
        assert np.isfinite(out["final_eval_mse"]) and out["final_eval_nfe"] > 0
    # the evaluation of the run is that of the EMA weights
    evaluated = run(make(tmp_path / "eval", evaluate=True,
                         resume=os.path.join(out["ckpt_dir"],
                                             "model_current.ckpt")),
                    device="cpu") if runner == "classification" else None
    if evaluated is not None:
        assert evaluated["eval"]["accuracy_top1"] == (
            out["final_eval"]["accuracy_top1"])


def test_checkpoint_without_ema_still_loads(tmp_path):
    """A checkpoint written without an EMA (its train state has no "ema",
    as the port's checkpoints had none before) resumes into an EMA run,
    which seeds the EMA at the restored parameters."""
    first = run_classification_experiment(
        _ode_runner_cfg(tmp_path, total_steps=2, evaluate_every=2),
        device="cpu")
    path = os.path.join(first["ckpt_dir"], "model_step_2.ckpt")
    with open(path, "rb") as f:
        blob = pickle.load(f)
    del blob["tstate"]["ema"]
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    resumed = run_classification_experiment(
        _ode_runner_cfg(tmp_path, ema_decay=0.5), device="cpu")
    assert resumed["final_step"] == 4
    ck = _current(resumed)
    assert set(ck["ema"]) == set(ck["params"])


@pytest.mark.parametrize("train,match", [
    (dict(steps_per_call=3), "must divide both print_frequency"),
    (dict(grad_accumulation=3), "must divide dataset.train_batchsize"),
    (dict(ema_decay=1.5), r"ema_decay must be in \[0, 1\)"),
])
@pytest.mark.parametrize("runner", ["classification", "latent"])
def test_runner_validation_errors(tmp_path, runner, train, match):
    """The JAX runners' checks (runner.py:305-324, 404-416), before any
    step runs."""
    run, make = ((run_classification_experiment, _ode_runner_cfg)
                 if runner == "classification"
                 else (run_latent_ode_experiment, _latent_runner_cfg))
    if runner == "latent" and "grad_accumulation" in train:
        train = dict(grad_accumulation=3)  # 3 does not divide 8 either
    with pytest.raises(ValueError, match=match):
        run(make(tmp_path, **train), device="cpu")
