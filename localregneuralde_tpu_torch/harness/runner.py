"""The classification experiment runner: MNIST Neural ODE and SDE, CIFAR-10
conv Neural ODE.

Counterpart of ``localregneuralde_tpu/harness/runner.py``
(``run_classification_experiment``, ``evaluate_classification``; reference
``experiments/*/main.jl``), on one device, or data-parallel over
``torch.distributed`` (``_wire_data_parallel``). Training minimises the cross
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

``train.steps_per_call`` = K > 1 trains K steps a call
(``train.make_multi_train_step``): on CUDA one replay of a captured CUDA
graph where every solve and sweep of the step is a persistent kernel (the
MNIST ODE and SDE), K eager steps otherwise (CIFAR-10, the CPU); 0 picks
K as the JAX runner's auto rule does, with the captured call in the TPU's
place (``loop.resolve_steps_per_call``). ``train.grad_accumulation`` splits
each batch into sequential microbatches with one update on their mean
gradient; ``train.ema_decay`` keeps a params-EMA, which evaluation and the
best checkpoint use.

``train.data_parallel`` = 'shardmap' (each rank its own adaptive grid on its
rows, the persistent kernels on every rank) or 'gspmd' (one grid over the
global batch) trains over the ranks of ``torchrun``::

    torchrun --nproc_per_node=N -m localregneuralde_tpu_torch.harness.runner \
        CONFIG.yaml --train.data_parallel=shardmap [--dp_backend=gloo]

A process started alone runs a group of one. Rank 0 keeps the canonical log
and checkpoint layout, rank r > 0 writes under ``proc{r}``; a checkpoint
keeps the whole (gathered) state. Under 'gspmd' each eval batch (rounded
down to the data-parallel degree) is solved on the global grid over the
ranks (CIFAR-10's conv solve on the whole batch on every rank, its
BatchNorms' moments over the ranks); under 'shardmap' every rank evaluates
whole eval batches itself, the single-device solve.
``train.tensor_parallel`` = tp > 1 (with 'gspmd' only, as the JAX runner
has it) lays the ranks out as world / tp data ranks by tp model ranks and
shards the parameters by JAX's rules (``parallel/sharded_train.py``); the
batch and the eval batch are spread over the data ranks, and a checkpoint
keeps whole arrays::

    torchrun --nproc_per_node=4 -m localregneuralde_tpu_torch.harness.runner \
        CONFIG.yaml --train.data_parallel=gspmd --train.tensor_parallel=2

Once a print window the phase probes (``train.make_phase_probes``) time a
forward and a forward with its backward on the eager step body, outside
the window's wall time, for the ``fwd_time``, ``bwd_time`` and
``opt_time`` columns.
"""
from __future__ import annotations

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
from .graph import capturable
from .latent_runner import (
    check_supported,
    restore_train_state,
    train_state_to_host,
)
from .logging import create_logger, get_loggable_values, reset_meters
from .loop import (
    batch_to_device,
    check_steps_per_call,
    check_train_options,
    device_batches,
    host_stacks,
    resolve_steps_per_call,
    run_block_loop,
)
from .losses import accuracy
from .train import (
    create_train_state,
    init_ema,
    make_eval_step,
    make_multi_train_step,
    make_phase_probes,
    make_train_step,
    swap_ema_params,
    warmup_model,
)

# per-channel statistics of the CIFAR-10 training set
# (experiments/cifar10/main.py:17-18)
CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)


def cifar_normalize(x: np.ndarray) -> np.ndarray:
    return (x - CIFAR_MEAN) / CIFAR_STD


def start_data_parallel(cfg: ExperimentConfig, device=None, backend=None):
    """``(DPGroup or None, device)`` for ``cfg.train.data_parallel``: with
    'gspmd' or 'shardmap' this process joins the process group
    (``parallel.multihost.initialize``: the ``torchrun`` variables, or a
    group of one) on its device (``multihost.local_device`` unless the
    caller names one), laid out as ``train.tensor_parallel`` asks (which
    must divide the ranks: checked before any group is made); with 'none'
    no group."""
    if cfg.train.data_parallel == "none":
        return None, resolve_device(device)
    import torch.distributed as dist

    from ..parallel import make_dp_group, multihost
    from ..parallel.mesh import check_grid

    # the grid's shape, before any process group is made
    check_grid(int(cfg.train.tensor_parallel),
               dist.get_world_size() if dist.is_initialized()
               else int(os.environ.get("WORLD_SIZE", 1)))
    if device is None:
        device = resolve_device(multihost.local_device("cuda"))
        torch.cuda.set_device(device)
    device = resolve_device(device)
    multihost.initialize(backend=backend, device=device)
    return make_dp_group(cfg.train.tensor_parallel), device


class DataParallel:
    """A runner's data-parallel wiring (``_wire_data_parallel``): the train
    and eval steps, the maker of the K-step call, and how a host batch, a
    K-stack, the window's stats and the checkpoint's state are placed.
    Under tensor parallelism ``dp`` carries the parameters' specs
    (``dp.specs``), ``optimizer`` is the ``OptimizerSpec`` (for the
    checkpoint's whole optimizer) and ``state_in`` gives a forward outside
    the step (the phase probes, ``probe_loss``) the grid."""

    def __init__(self, dp, mode, rows, n_micro, train_step, eval_step,
                 make_block, optimizer=None, state_in=None):
        self.dp, self.mode, self.rows, self.n_micro = dp, mode, rows, n_micro
        self.train_step, self.eval_step = train_step, eval_step
        self.make_block = make_block
        self.optimizer, self.state_in = optimizer, state_in

    def probe_loss(self, loss_fn):
        """``loss_fn`` for the phase probes, a forward outside the step:
        under tensor parallelism with the grid in its state (the
        parameters are shards)."""
        if self.state_in is None:
            return loss_fn

        def fn(model, params, state, data, w, training=True):
            return loss_fn(model, params, self.state_in(state), data, w,
                           training=training)

        return fn

    def host(self, batch):
        """This rank's rows of a host batch (all of it without a group)."""
        if self.dp is None:
            return batch
        from ..parallel import shard_batch

        return shard_batch(batch, self.dp, self.n_micro)

    def host_stack(self, stack):
        """This rank's rows of each batch of a host K-stack."""
        if self.dp is None:
            return stack
        return tuple(np.stack(s) for s in zip(*[
            self.host(tuple(a[k] for a in stack))
            for k in range(stack[0].shape[0])]))

    def window(self, sums: torch.Tensor) -> torch.Tensor:
        """A print window's stat sums as the rank mean (each rank's
        accuracy is its rows')."""
        if self.dp is None:
            return sums
        from ..parallel.mesh import mean_over_ranks

        return mean_over_ranks(sums, self.dp)

    def gathered(self, ts):
        """``ts`` with its batch-shaped layer state gathered from every
        data rank and, under tensor parallelism, its parameters, moments
        and EMA from every model rank: the whole state, for the
        checkpoint."""
        if self.dp is None:
            return ts
        import dataclasses

        from ..parallel.multihost import gather_to_host
        from ..parallel.sharded_train import whole_train_state

        if self.dp.specs:
            ts = whole_train_state(ts, self.dp, self.optimizer)
        return dataclasses.replace(ts, state=gather_to_host(
            ts.state, self.dp, self.rows // self.n_micro))

    def restored(self, ts, host: dict, device, global_rows: int):
        """``ts`` with a checkpoint's values (``host``, whole arrays: any
        run's, a single device's included), its parameters, moments and
        EMA cut to this rank's shards under tensor parallelism and its
        batch-shaped state to this rank's rows."""
        if self.dp is not None and self.dp.specs:
            from ..parallel.sharded_train import shard_host_state

            host = shard_host_state(host, self.dp)
        ts = restore_train_state(ts, host, device)
        if self.dp is None:
            return ts
        import dataclasses

        from ..parallel.multihost import local_state

        return dataclasses.replace(
            ts, state=local_state(ts.state, self.dp, global_rows))


def _wire_data_parallel(cfg, model, loss_fn, optimizer, ts, dp, device, *,
                        train_step, eval_step) -> DataParallel:
    """The data-parallel steps for ``cfg.train.data_parallel`` (JAX
    ``runner.py:36-250``): with no group the single-device steps; 'gspmd'
    the global grid (``parallel.make_sharded_train_step``, its eval step
    and K-step call), 'shardmap' the per-rank grid (one step a call, no
    gradient accumulation, whole eval batches on every rank, as the JAX
    package allows). Checks the batch against the data-parallel degree,
    that the replicated parameters start identical, and warns where the
    local batch makes the persistent kernels decline."""
    mode = cfg.train.data_parallel
    ga = max(1, int(cfg.train.grad_accumulation))
    ed = float(cfg.train.ema_decay)
    bs = int(cfg.dataset.train_batchsize)
    if dp is None:
        return DataParallel(None, mode, bs, 1, train_step, eval_step, None)
    from ..parallel import (
        make_sharded_eval_step, make_sharded_multi_train_step,
        make_sharded_train_step, make_shardmap_train_step, multihost,
    )

    if bs % (dp.size * (ga if mode == "gspmd" else 1)):
        raise ValueError(
            f"dataset.train_batchsize={bs} must be divisible by the "
            f"data-parallel degree {dp.size}"
            + (f" times grad_accumulation {ga}" if ga > 1 else ""))
    multihost.place_train_state(ts, dp)
    rows = bs // dp.size
    state_in = None
    if dp.model_size > 1:
        from ..parallel.sharded_train import (
            GlobalGridSync, group_paths, shard_train_state,
            train_state_shardings,
        )

        # JAX's runner shards by its rules whenever tp > 1
        dp = train_state_shardings(ts, dp)
        shard_train_state(ts, dp)
        state_in = GlobalGridSync(dp, group_paths(model)).state_in
    if mode == "gspmd":
        n_micro = ga
        step = make_sharded_train_step(model, loss_fn, optimizer, dp,
                                       ema_decay=ed, grad_accumulation=ga)
        evals = make_sharded_eval_step(model, loss_fn, dp)

        def make_block(reduce_fn):
            return make_sharded_multi_train_step(
                model, loss_fn, optimizer, dp, reduce_fn=reduce_fn,
                ema_decay=ed, grad_accumulation=ga)
    else:
        n_micro = 1
        step = make_shardmap_train_step(model, loss_fn, optimizer, dp,
                                        ema_decay=ed)
        evals, make_block = eval_step, None
        layers = [m for m in model.modules() if hasattr(m, "persistent_step")]
        if torch.device(device).type == "cuda" and not all(
                m.persistent_step(rows, device) for m in layers):
            print(f"WARNING: data_parallel=shardmap with local batch {rows}: "
                  "a persistent kernel declines it, so every rank runs the "
                  "eager loop of its route", flush=True)
    print(f"data_parallel={mode}: {dp.size} rank(s) over {dp.backend}, "
          f"{rows} rows a rank, this rank {dp.rank}"
          + (f"; tensor_parallel={dp.model_size}, model rank "
             f"{dp.model_rank}, "
             f"{sum(d is not None for d in dp.specs.values())}"
             " parameter(s) sharded" if dp.model_size > 1 else ""),
          flush=True)
    return DataParallel(dp, mode, rows, n_micro, step, evals, make_block,
                        optimizer, state_in)


def _stat_keys(sde: bool):
    return (["net_loss", "ce_loss", "reg_val", "accuracy_top1", "accuracy_top5"]
            + (["nfe_drift", "nfe_diffusion"] if sde else ["nfe"]))


def _stat_row(loss, stats, y, sde: bool) -> torch.Tensor:
    """The logged values of one batch, stacked on the device."""
    a1, a5 = accuracy(stats["y_pred"], y, (1, 5))
    nfe = list(stats["nfe"]) if sde else [stats["nfe"]]
    return torch.stack([loss, stats["ce_loss"], stats["reg_val"], a1, a5]
                       + [n.float() for n in nfe])


def evaluate_classification(cfg: ExperimentConfig, eval_step, ts, data,
                            w_reg, device, dp=None) -> dict:
    """Mean loss, regulariser, NFE and top-1/top-5 accuracy over the test
    split in batches of ``eval_batchsize`` (clamped to the split), with one
    host read at the end. With a ``DPGroup`` (the global grid's sharded
    eval step) each batch, rounded down to the data-parallel degree, is
    spread over the ranks and the totals summed over them."""
    x_test, y_test = data
    eval_bs = min(int(cfg.dataset.eval_batchsize), int(x_test.shape[0]))
    if dp is not None:
        # the data-parallel degree, not the process count (JAX
        # runner.py:760 rounds to the devices)
        rounded = eval_bs - eval_bs % dp.size
        if rounded == 0:
            raise ValueError(
                f"test split ({int(x_test.shape[0])} samples) is smaller than "
                f"the data-parallel degree {dp.size}")
        eval_bs = rounded
    sde = cfg.model.sde
    rows, count = [], 0
    loader = make_dataloader((x_test, y_test), eval_bs, drop_last=True)
    if dp is not None:
        from ..parallel import shard_batch

        loader = (shard_batch(b, dp) for b in loader)
    for batch in device_batches(loader, device, 1):
        loss, stats = eval_step(ts, batch, w_reg)
        bs = int(batch[0].shape[0])
        rows.append(_stat_row(loss, stats, batch[1], sde) * bs)
        count += bs
    totals = torch.stack(rows).sum(dim=0)
    if dp is not None:
        from ..parallel.mesh import ordered_sum

        totals = ordered_sum(totals, dp)
        count *= dp.size
    return {k: v / count for k, v in zip(_stat_keys(sde), totals.tolist())}


def run_classification_experiment(
        cfg: ExperimentConfig, config_name: str = "run", *,
        normalize: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        max_steps_override: Optional[int] = None, device=None,
        dp_backend: Optional[str] = None) -> dict:
    """Train and evaluate the classification model of ``cfg`` on ``device``
    (default: the CUDA device, under data parallelism this rank's); returns
    the reference runner's summary, with ``steps_per_call`` and whether the
    K-step calls were ``captured`` CUDA graphs. ``dp_backend`` names the
    process group's backend (default: NCCL when every rank has a card of
    its own, else Gloo)."""
    check_supported(cfg)
    ga, ed = check_train_options(cfg)
    dp, device = start_data_parallel(cfg, device, dp_backend)
    from ..parallel.multihost import checkpoint_subdir

    name = experiment_name(cfg, config_name)
    ckpt_dir = checkpoint_subdir(os.path.join(
        cfg.train.checkpoint_dir, cfg.train.expt_subdir, name), dp)
    log_dir = checkpoint_subdir(os.path.join(
        cfg.train.log_dir, cfg.train.expt_subdir, name), dp)

    model = construct_model(cfg, device=device)
    loss_fn, w_reg_sched = construct_loss(cfg)
    optimizer, lr_sched = construct_optimizer(cfg)
    ts = create_train_state(model, optimizer)
    par = _wire_data_parallel(
        cfg, model, loss_fn, optimizer, ts, dp, device,
        train_step=make_train_step(model, loss_fn, optimizer,
                                   grad_accumulation=ga, ema_decay=ed),
        eval_step=make_eval_step(model, loss_fn))
    train_step, eval_step = par.train_step, par.eval_step
    dp = par.dp  # with the parameters' specs under tensor parallelism
    eval_dp = dp if par.mode == "gspmd" else None
    bs = cfg.dataset.train_batchsize
    spc = resolve_steps_per_call(
        cfg.train.steps_per_call, cfg.train.print_frequency,
        cfg.train.evaluate_every,
        capturable(model, par.rows // ga, device, dp))
    check_steps_per_call(cfg, spc)
    if int(cfg.train.steps_per_call) == 0 and spc > 1:
        print(f"steps_per_call=auto -> K={spc} (one CUDA-graph replay a "
              "call)", flush=True)

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
            ts = par.restored(ts, restored["tstate"], device, bs)
            initial_step = int(restored["step"]) + 1
            restored_best = restored.get("best")
            print(f"resumed from {resume_path} at step {initial_step}",
                  flush=True)
    if ed > 0.0 and ts.ema is None:
        # a fresh start, or a checkpoint written without an EMA
        ts = init_ema(ts)

    if cfg.train.evaluate:
        metrics = evaluate_classification(cfg, eval_step, swap_ema_params(ts),
                                          eval_data, float(w_reg_sched(1)),
                                          device, eval_dp)
        print(f"[evaluate] {metrics}", flush=True)
        return {"eval": metrics, "real_data": bool(is_real)}

    # after the resume: skip_batches fast-forwards the seeded stream
    train_loader = make_dataloader(
        (x_train, one_hot(y_train, nc)), bs,
        shuffle=True, cycle=True, seed=cfg.seed, skip_batches=initial_step - 1,
    )
    warm = batch_to_device(
        par.host((x_train[:bs], one_hot(y_train[:bs], nc))), device)
    # first-call set-up (kernel build, cuDNN plans) before the clock starts;
    # a K-step call warms itself up on its first call
    warmup_model(train_step if spc == 1 else None, eval_step, ts, warm,
                 float(w_reg_sched(1)), float(lr_sched(1)))

    total_steps = max_steps_override or cfg.train.total_steps
    sde = cfg.model.sde
    keys = _stat_keys(sde)
    loggers = create_logger(log_dir, total_steps, sde=sde, expt_name=name,
                            config=flatten_config(cfg))
    tm = loggers["train_meters"]
    best = -np.inf if restored_best is None else float(restored_best)
    final_eval: dict = {}

    # the per-window phase probes (fwd/bwd/opt columns)
    measure_phases = make_phase_probes(model, par.probe_loss(loss_fn),
                                       optimizer)

    def print_window(step, sums, window_n, ok, wall, data_time, n_rows, ts,
                     batch, w_reg):
        for k, v in zip(keys, sums):
            tm[k].update(v / window_n, window_n * n_rows)
        t_fwd, t_fwdbwd = measure_phases(ts, batch, w_reg)
        step_time = wall / window_n
        tm["batch_time"].update(step_time, window_n)
        tm["data_time"].update(data_time / window_n, window_n)
        tm["step_time"].update(step_time, window_n)
        tm["fwd_time"].update(t_fwd, window_n)
        tm["bwd_time"].update(max(t_fwdbwd - t_fwd, 0.0), window_n)
        tm["opt_time"].update(max(step_time - t_fwdbwd, 0.0), window_n)
        if not ok:
            print(f"WARNING [{step}]: adaptive solve exhausted max_steps "
                  "within this window (integration truncated; raise "
                  "solver.max_steps or loosen tolerances)", flush=True)
        row = get_loggable_values(tm, loggers["train_header"], step)
        loggers["csv_train"].log(row)
        print(f"[{step}/{total_steps}] " + " ".join(
            f"{k}={tm[k].average:.4f}"
            for k in loggers["train_header"][1:]), flush=True)
        reset_meters(tm)

    def eval_and_checkpoint(step, w_reg, ts):
        nonlocal best, final_eval
        # with an EMA, evaluation and the best checkpoint see the averaged
        # weights; the raw parameters keep training
        metrics = evaluate_classification(cfg, eval_step, swap_ema_params(ts),
                                          eval_data, w_reg, device, eval_dp)
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
            {"tstate": train_state_to_host(par.gathered(ts)), "step": step,
             "best": float(best)},
            fdir=ckpt_dir, fname=f"model_step_{step}.ckpt",
            is_best=is_best,
        )

    summary = {"final_step": total_steps, "real_data": bool(is_real),
               "ckpt_dir": ckpt_dir, "log_dir": log_dir,
               "steps_per_call": spc, "captured": False}
    if dp is not None:
        summary.update(data_parallel=par.mode, world_size=dp.world_size,
                       rank=dp.world_rank, tensor_parallel=dp.model_size)
    if spc > 1:
        def window_reduce(loss, stats, data):
            return {"row": _stat_row(loss, stats, data[1], sde),
                    "n_fail": (~stats["solver_success"]).float()}

        multi_step = (make_multi_train_step(
            model, loss_fn, optimizer, window_reduce, grad_accumulation=ga,
            ema_decay=ed) if par.make_block is None
            else par.make_block(window_reduce))
        stacks = device_batches(
            (par.host_stack(s) for s in host_stacks(
                iter(train_loader), initial_step, total_steps, spc)),
            device, int(cfg.train.device_prefetch))
        run_block_loop(
            multi_step, ts, stacks, initial_step=initial_step,
            total_steps=total_steps,
            print_frequency=cfg.train.print_frequency,
            evaluate_every=cfg.train.evaluate_every,
            w_of=lambda steps: np.asarray([w_reg_sched(s) for s in steps],
                                          np.float32),
            lr_of=lambda steps: np.asarray([lr_sched(s) for s in steps],
                                           np.float32),
            on_window=print_window, on_eval=eval_and_checkpoint,
            reduce_window=par.window)
        summary["captured"] = bool(multi_step.captured)
        return dict(summary, best_eval_acc=float(best), final_eval=final_eval)

    batches = device_batches(map(par.host, train_loader), device,
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
            print_window(step, par.window(sums).tolist(), window_n, bool(ok),
                         time.perf_counter() - t_window, data_time,
                         int(batch[0].shape[0]), ts, batch, w_reg)
            sums, ok, window_n, data_time = None, None, 0, 0.0
            t_window = time.perf_counter()
        if step % cfg.train.evaluate_every == 0 or step == total_steps:
            eval_and_checkpoint(step, w_reg, ts)
    return dict(summary, best_eval_acc=float(best), final_eval=final_eval)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("--"):
        print("usage: python -m localregneuralde_tpu_torch.harness.runner "
              "CONFIG.yaml [--a.b.c=value ...] [--device=cpu] "
              "[--dp_backend=gloo|nccl]",
              file=sys.stderr)
        return 2
    device, backend = pop_run_options(argv)
    cfg = define_configuration(argv[1:], argv[0])
    config_name = os.path.splitext(os.path.basename(argv[0]))[0]
    normalize = (cifar_normalize if cfg.model.model_type == "cifar10_cnn"
                 else None)
    summary = run_classification_experiment(
        cfg, config_name, normalize=normalize, device=device,
        dp_backend=backend)
    print("summary:", summary, flush=True)
    return 0


def pop_run_options(argv) -> tuple:
    """``(device, dp_backend)`` from ``--device=`` and ``--dp_backend=``
    (None where absent), removed from ``argv``."""
    out = {"--device=": None, "--dp_backend=": None}
    for arg in list(argv[1:]):
        for flag in out:
            if arg.startswith(flag):
                out[flag] = arg.split("=", 1)[1]
                argv.remove(arg)
    return out["--device="], out["--dp_backend="]


if __name__ == "__main__":
    sys.exit(main())
