"""The classification experiment runner: MNIST Neural ODE and SDE, CIFAR-10
conv Neural ODE.

Counterpart of ``localregneuralde_tpu/harness/runner.py``
(``run_classification_experiment``, ``evaluate_classification``; reference
``experiments/*/main.jl``), on one device. Training minimises the cross
entropy plus ``w_reg``·the local regulariser; every ``evaluate_every`` steps
(and at the last) the test split is evaluated and a checkpoint written,
``model_best`` pointing at the best top-1 accuracy so far (``>=``). A
resumed run skips the batches it has already seen, so it consumes the
batches an uninterrupted run would have.

Run on the GPU with::

    python -m localregneuralde_tpu_torch.harness.runner CONFIG.yaml \\
        [--a.b.c=value ...] [--device=cpu]

which normalises CIFAR-10 inputs with the per-channel mean and std of
``experiments/cifar10/main.py`` for ``model_type: cifar10_cnn``.

Not ported (they raise): ``train.steps_per_call`` other than 0 (auto, which
is 1 here) or 1, ``grad_accumulation``, ``ema_decay`` (ROADMAP Queue 1 item
13) and ``data_parallel`` (item 14). The reference's per-window phase probes
are not run; the ``fwd_time``, ``bwd_time`` and ``opt_time`` columns read
NaN.
"""
from __future__ import annotations

import collections
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from .checkpoint import load_checkpoint, save_checkpoint
from .config import (
    ExperimentConfig,
    define_configuration,
    experiment_name,
    flatten_config,
)
from .construct import (
    construct_loss,
    construct_model,
    construct_optimizer,
    resolve_device,
)
from .data import get_classification_data, make_dataloader, one_hot
from .latent_runner import (
    batch_to_device,
    check_supported,
    restore_train_state,
    train_state_to_host,
)
from .logging import create_logger, get_loggable_values, reset_meters
from .losses import accuracy
from .train import (
    create_train_state,
    make_eval_step,
    make_train_step,
    warmup_model,
)

# per-channel statistics of the CIFAR-10 training set
# (experiments/cifar10/main.py:17-18)
CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)


def cifar_normalize(x: np.ndarray) -> np.ndarray:
    return (x - CIFAR_MEAN) / CIFAR_STD


def _stat_keys(sde: bool):
    return (["net_loss", "ce_loss", "reg_val", "accuracy_top1", "accuracy_top5"]
            + (["nfe_drift", "nfe_diffusion"] if sde else ["nfe"]))


def _stat_row(loss, stats, y, sde: bool) -> torch.Tensor:
    """The logged values of one batch, stacked on the device."""
    a1, a5 = accuracy(stats["y_pred"], y, (1, 5))
    nfe = list(stats["nfe"]) if sde else [stats["nfe"]]
    return torch.stack([loss, stats["ce_loss"], stats["reg_val"], a1, a5]
                       + [n.float() for n in nfe])


def device_batches(host_iter, device, size: int):
    """Batches on ``device``, ``size`` of them copied ahead of the one in
    use (``train.device_prefetch``; 0 or 1 copies on demand). The copies go
    through pinned memory without blocking, so they overlap the running
    step."""
    queue = collections.deque()
    for batch in host_iter:
        queue.append(batch_to_device(batch, device))
        if len(queue) >= max(1, size):
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def evaluate_classification(cfg: ExperimentConfig, eval_step, ts, data,
                            w_reg, device) -> dict:
    """Mean loss, regulariser, NFE and top-1/top-5 accuracy over the test
    split in batches of ``eval_batchsize`` (clamped to the split), with one
    host read at the end."""
    x_test, y_test = data
    eval_bs = min(int(cfg.dataset.eval_batchsize), int(x_test.shape[0]))
    sde = cfg.model.sde
    rows, count = [], 0
    for batch in device_batches(
            make_dataloader((x_test, y_test), eval_bs, drop_last=True),
            device, 1):
        loss, stats = eval_step(ts, batch, w_reg)
        bs = int(batch[0].shape[0])
        rows.append(_stat_row(loss, stats, batch[1], sde) * bs)
        count += bs
    totals = torch.stack(rows).sum(dim=0).tolist()
    return {k: v / count for k, v in zip(_stat_keys(sde), totals)}


def run_classification_experiment(
        cfg: ExperimentConfig, config_name: str = "run", *,
        normalize: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        max_steps_override: Optional[int] = None, device=None) -> dict:
    """Train and evaluate the classification model of ``cfg`` on ``device``
    (default: the CUDA device); returns the reference runner's summary."""
    check_supported(cfg)
    device = resolve_device(device)
    name = experiment_name(cfg, config_name)
    ckpt_dir = os.path.join(cfg.train.checkpoint_dir, cfg.train.expt_subdir,
                            name)
    log_dir = os.path.join(cfg.train.log_dir, cfg.train.expt_subdir, name)

    model = construct_model(cfg, device=device)
    loss_fn, w_reg_sched = construct_loss(cfg)
    optimizer, lr_sched = construct_optimizer(cfg)
    ts = create_train_state(model, optimizer)
    train_step = make_train_step(model, loss_fn, optimizer)
    eval_step = make_eval_step(model, loss_fn)

    x_train, y_train, x_test, y_test, is_real = get_classification_data(cfg)
    if normalize is not None:
        x_train, x_test = normalize(x_train), normalize(x_test)
    nc = cfg.model.num_classes
    eval_data = (x_test, one_hot(y_test, nc))

    initial_step, restored_best = 1, None
    resume_path = cfg.train.resume or os.path.join(ckpt_dir,
                                                   "model_current.ckpt")
    if os.path.exists(resume_path):
        restored = load_checkpoint(resume_path)
        if restored is not None:
            ts = restore_train_state(ts, restored["tstate"], device)
            initial_step = int(restored["step"]) + 1
            restored_best = restored.get("best")
            print(f"resumed from {resume_path} at step {initial_step}",
                  flush=True)

    if cfg.train.evaluate:
        metrics = evaluate_classification(cfg, eval_step, ts, eval_data,
                                          float(w_reg_sched(1)), device)
        print(f"[evaluate] {metrics}", flush=True)
        return {"eval": metrics, "real_data": bool(is_real)}

    # after the resume: skip_batches fast-forwards the seeded stream
    train_loader = make_dataloader(
        (x_train, one_hot(y_train, nc)), cfg.dataset.train_batchsize,
        shuffle=True, cycle=True, seed=cfg.seed, skip_batches=initial_step - 1,
    )
    bs = cfg.dataset.train_batchsize
    warm = batch_to_device((x_train[:bs], one_hot(y_train[:bs], nc)), device)
    # first-call set-up (kernel build, cuDNN plans) before the clock starts
    warmup_model(train_step, eval_step, ts, warm, float(w_reg_sched(1)),
                 float(lr_sched(1)))

    total_steps = max_steps_override or cfg.train.total_steps
    sde = cfg.model.sde
    keys = _stat_keys(sde)
    loggers = create_logger(log_dir, total_steps, sde=sde, expt_name=name,
                            config=flatten_config(cfg))
    tm = loggers["train_meters"]
    best = -np.inf if restored_best is None else float(restored_best)
    final_eval: dict = {}
    batches = device_batches(iter(train_loader), device,
                             int(cfg.train.device_prefetch))
    sums = ok = None
    window_n, data_time = 0, 0.0
    t_window = time.perf_counter()
    for step in range(initial_step, total_steps + 1):
        t0 = time.perf_counter()
        batch = next(batches)
        data_time += time.perf_counter() - t0
        w_reg = float(w_reg_sched(step))
        ts, loss, stats = train_step(ts, batch, w_reg, float(lr_sched(step)))
        # accumulated on the device: one host read per print window
        row = _stat_row(loss, stats, batch[1], sde)
        sums = row if sums is None else sums + row
        success = stats["solver_success"]
        ok = success if ok is None else ok & success
        window_n += 1
        if step % cfg.train.print_frequency == 0:
            wall = time.perf_counter() - t_window
            n_rows = int(batch[0].shape[0])
            for k, v in zip(keys, sums.tolist()):
                tm[k].update(v / window_n, window_n * n_rows)
            tm["batch_time"].update(wall / window_n, window_n)
            tm["data_time"].update(data_time / window_n, window_n)
            tm["step_time"].update(wall / window_n, window_n)
            for k in ("fwd_time", "bwd_time", "opt_time"):
                tm[k].update(float("nan"), window_n)
            if not bool(ok):
                print(f"WARNING [{step}]: adaptive solve exhausted max_steps "
                      "within this window (integration truncated; raise "
                      "solver.max_steps or loosen tolerances)", flush=True)
            row = get_loggable_values(tm, loggers["train_header"], step)
            loggers["csv_train"].log(row)
            print(f"[{step}/{total_steps}] " + " ".join(
                f"{k}={tm[k].average:.4f}"
                for k in loggers["train_header"][1:]), flush=True)
            reset_meters(tm)
            sums, ok, window_n, data_time = None, None, 0, 0.0
            t_window = time.perf_counter()
        if step % cfg.train.evaluate_every == 0 or step == total_steps:
            metrics = evaluate_classification(cfg, eval_step, ts, eval_data,
                                              w_reg, device)
            em = loggers["eval_meters"]
            for k, v in metrics.items():
                if k in em:
                    em[k].update(v)
            loggers["csv_eval"].log(
                get_loggable_values(em, loggers["eval_header"], step))
            loggers["wandb"].log({f"eval_{k}": v for k, v in metrics.items()},
                                 step=step)
            print(f"[eval @ {step}] {metrics}", flush=True)
            reset_meters(em)
            final_eval = dict(metrics)
            is_best = metrics["accuracy_top1"] >= best
            best = max(best, metrics["accuracy_top1"])
            save_checkpoint(
                {"tstate": train_state_to_host(ts), "step": step,
                 "best": float(best)},
                fdir=ckpt_dir, fname=f"model_step_{step}.ckpt",
                is_best=is_best,
            )
    return {
        "best_eval_acc": float(best),
        "final_eval": final_eval,
        "final_step": total_steps,
        "real_data": bool(is_real),
        "ckpt_dir": ckpt_dir,
        "log_dir": log_dir,
    }


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("--"):
        print("usage: python -m localregneuralde_tpu_torch.harness.runner "
              "CONFIG.yaml [--a.b.c=value ...] [--device=cpu]",
              file=sys.stderr)
        return 2
    device = None
    for arg in list(argv[1:]):
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
            argv.remove(arg)
    cfg = define_configuration(argv[1:], argv[0])
    config_name = os.path.splitext(os.path.basename(argv[0]))[0]
    normalize = (cifar_normalize if cfg.model.model_type == "cifar10_cnn"
                 else None)
    summary = run_classification_experiment(cfg, config_name,
                                            normalize=normalize, device=device)
    print("summary:", summary, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
