"""The port's ``utils/profiling.py`` and the runners' phase probes
(``harness/train.py::make_phase_probes``).

``PhaseTimer`` is held to the JAX package's cases (``tests/test_misc.py``),
and its fence to its contract on the CPU (no fence, never a device-wide
synchronise); ``trace`` writes a Chrome trace. The probes fill the
``fwd_time``, ``bwd_time`` and ``opt_time`` columns of both runners with
finite times, and leave the run as it was: its losses and parameters are
bitwise those of the same run with the probe replaced by a no-op, on the
MNIST Neural ODE (t1 draws, one step a call) and the latent ODE (ε and t1
draws, two steps a call through the block loop).
"""
import csv
import glob
import json
import math
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.utils import PhaseTimer as JPhaseTimer
from localregneuralde_tpu_torch.harness import (
    construct_loss,
    construct_model,
    construct_optimizer,
    create_train_state,
    define_configuration,
    latent_runner,
    runner,
)
from localregneuralde_tpu_torch.harness.checkpoint import load_checkpoint
from localregneuralde_tpu_torch.harness.train import make_phase_probes
from localregneuralde_tpu_torch.utils import PhaseTimer, trace
from localregneuralde_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the models are small, and the suite's workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("timer_cls,array", [
    (JPhaseTimer, jnp.ones), (PhaseTimer, torch.ones)])
def test_phase_timer_accumulates(timer_cls, array):
    """JAX's case (``tests/test_misc.py``), on both timers."""
    t = timer_cls()
    x = array((8, 8))
    with t.phase("mm", sync=None):
        y = x @ x
    with t.phase("mm", sync=y):
        y = x @ x
    avgs = t.averages()
    assert "mm" in avgs and avgs["mm"] >= 0
    t.reset()
    assert t.averages() == {}


def test_phase_timer_fences_only_cuda_tensors(monkeypatch):
    """A CPU ``sync`` (a tensor or a tree) needs no fence: no event, and
    never a device-wide synchronise."""
    def refuse(*a, **k):
        raise AssertionError("a CPU phase touched the CUDA runtime")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    t = PhaseTimer()
    x = torch.ones(4, 4)
    for sync in (x, {"a": [x, x @ x], "n": 3}, (x, None)):
        with t.phase("p", sync=sync):
            x @ x
    assert t.counts == {"p": 3} and t.totals["p"] >= 0.0
    profiling.fence({"x": x, "y": 1.0})


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(None):
        torch.ones(3) + 1
    assert not os.listdir(tmp_path)
    with trace(str(tmp_path / "t")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    files = glob.glob(str(tmp_path / "t" / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_phase_probes_leave_the_train_state(tmp_path):
    """One probe on the MNIST Neural ODE (unbiased, so its step draws t1):
    positive times, and the parameters, optimizer state and layer state
    (the generator's position included) as they were."""
    cfg = define_configuration(
        ["--model.mlp_hidden_state_size=8", "--model.solver.reltol=1e-2",
         "--model.solver.abstol=1e-2", "--model.solver.max_steps=32",
         "--model.regularize=unbiased"],
        str(ROOT / "experiments/mnist_ode/mlp.yaml"))
    model = construct_model(cfg, device="cpu")
    loss_fn, _ = construct_loss(cfg)
    optimizer, _ = construct_optimizer(cfg)
    ts = create_train_state(model, optimizer)
    g = torch.Generator().manual_seed(0)
    data = (torch.rand((8, 28, 28, 1), generator=g),
            torch.nn.functional.one_hot(torch.arange(8) % 10, 10).float())
    before = (
        {k: v.detach().clone() for k, v in ts.params.items()},
        ts.state["neural_ode"]["rng"].get_state().clone(),
    )
    t_fwd, t_fwdbwd = make_phase_probes(model, loss_fn, optimizer)(
        ts, data, 0.5)
    assert 0.0 < t_fwd and 0.0 < t_fwdbwd and math.isfinite(t_fwdbwd)
    assert all(torch.equal(ts.params[k], v) for k, v in before[0].items())
    assert torch.equal(ts.state["neural_ode"]["rng"].get_state(), before[1])
    assert all(p.grad is None for p in ts.params.values())
    assert ts.step == 0


def _rows(log_dir):
    path, = glob.glob(os.path.join(log_dir, "**", "results_train.csv"),
                      recursive=True)
    with open(path) as f:
        return list(csv.DictReader(f))


def _params(ckpt_dir):
    path, = glob.glob(os.path.join(ckpt_dir, "**", "model_current.ckpt"),
                      recursive=True)
    return load_checkpoint(path)["tstate"]["params"]


def _no_probe(model, loss_fn, optimizer=None):
    return lambda ts, data, w: (0.0, 0.0)


RUNS = {
    "mnist_ode": (runner.run_classification_experiment, runner,
                  str(ROOT / "experiments/mnist_ode/mlp.yaml"),
                  ["--model.mlp_hidden_state_size=8",
                   "--model.solver.reltol=1e-2", "--model.solver.abstol=1e-2",
                   "--model.solver.max_steps=32",
                   "--dataset.train_batchsize=8",
                   "--dataset.eval_batchsize=1024",
                   "--train.total_steps=3", "--train.print_frequency=1",
                   "--train.evaluate_every=3"],
                  ("net_loss", "ce_loss", "reg_val", "nfe")),
    "physionet": (latent_runner.run_latent_ode_experiment, latent_runner,
                  str(ROOT / "experiments/physionet/physionet.yaml"),
                  ["--model.ts_in_dims=3", "--model.ts_hidden_dims=4",
                   "--model.ts_latent_dims=3", "--model.ts_node_dims=2",
                   "--model.solver.reltol=1e-2",
                   "--model.solver.abstol=1e-2",
                   "--model.solver.max_steps=32",
                   "--dataset.train_batchsize=4",
                   "--train.total_steps=4", "--train.print_frequency=2",
                   "--train.evaluate_every=4", "--train.steps_per_call=2"],
                  ("net_loss", "neg_log_likelihood", "kl_div", "reg_val",
                   "nfe")),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_runner_phase_columns_and_no_disturbance(name, tmp_path, monkeypatch):
    """Both runners on the CPU: finite, non-negative ``fwd_time``,
    ``bwd_time`` and ``opt_time`` (the forward's positive), and losses and
    parameters bitwise those of the run whose probe is a no-op."""
    run, module, config, args, loss_keys = RUNS[name]
    out = {}
    for label in ("probed", "plain"):
        with monkeypatch.context() as m:
            if label == "plain":
                m.setattr(module, "make_phase_probes", _no_probe)
            cfg = define_configuration(
                args + [f"--train.checkpoint_dir={tmp_path}/{label}/c",
                        f"--train.log_dir={tmp_path}/{label}/l"], config)
            run(cfg, name, device="cpu")
        out[label] = (_rows(f"{tmp_path}/{label}/l"),
                      _params(f"{tmp_path}/{label}/c"))
    rows, params = out["probed"]
    rows0, params0 = out["plain"]
    assert len(rows) == len(rows0) >= 2
    for row, row0 in zip(rows, rows0):
        times = [float(row[k]) for k in ("fwd_time", "bwd_time", "opt_time")]
        assert all(math.isfinite(t) and t >= 0.0 for t in times)
        assert times[0] > 0.0
        assert [row[k] for k in loss_keys] == [row0[k] for k in loss_keys]
    assert params.keys() == params0.keys()
    assert all(np.array_equal(np.asarray(params[k]), np.asarray(params0[k]))
               for k in params)
