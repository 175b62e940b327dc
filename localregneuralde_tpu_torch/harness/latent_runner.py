"""The latent-ODE (PhysioNet-style) experiment runner.

Counterpart of ``localregneuralde_tpu/harness/latent_runner.py``
(reference ``experiments/physionet/main.jl``), on one device: training
minimises the masked Gaussian NLL, the annealed KL term and the local
regulariser; evaluation reports the masked MSE. The data tuples are
``(data, mask, dt)``, the Δt channel the forward differences of the
observation grid with a trailing zero (``physionet/main.jl:22-29``).

As in the reference, the best checkpoint is the one with the lowest
masked MSE (``<=``; the reference's Julia code compares ``>=``,
``physionet/main.jl:188``), and a resumed run skips the batches it has
already seen, so it consumes the batches an uninterrupted run would have.

Run on the GPU with::

    python -m localregneuralde_tpu_torch.harness.latent_runner \\
        experiments/physionet/physionet.yaml [--a.b.c=value ...] [--device=cpu]

``train.steps_per_call`` = K > 1 trains K steps a call: on CUDA one replay
of a captured CUDA graph (the encoder's eager GRU steps, kernels 5 and 9
and the optimizer in one graph), on the CPU K eager steps; 0 picks K by the
JAX runner's auto rule with the captured call in the TPU's place.
``train.grad_accumulation`` and ``train.ema_decay`` work as in the
classification runner (``loop.py``); with an EMA, evaluation and the best
checkpoint see the averaged weights. ``train.data_parallel='shardmap'``
trains over the ranks of ``torchrun``, each rank its own grid on its rows
(kernels 5 and 9 on every rank; ``runner._wire_data_parallel``), every rank
evaluating the whole test split. ``'gspmd'`` trains and evaluates on the
global grid (``parallel.make_sharded_train_step``, its K-step call and an
eval solve over the ranks): the batch spread over the ranks, every norm
over all their rows, kernel 5 solving the whole batch on every rank and
kernel 9 sweeping the rank's rows of its knots; as the JAX runner's pod
mode, the eval batch (clamped to the test split) is rounded down to the
data-parallel degree, and each eval batch's masked MSE is the whole
batch's::

    torchrun --nproc_per_node=N -m \\
        localregneuralde_tpu_torch.harness.latent_runner \\
        experiments/physionet/physionet.yaml --train.data_parallel=gspmd

Once a print window the phase probes (``train.make_phase_probes``) time a
forward and a forward with its backward on the eager step body, outside
the window's wall time, for the ``fwd_time``, ``bwd_time`` and
``opt_time`` columns.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from .checkpoint import from_host, load_checkpoint, save_checkpoint, to_host
from .config import (
    ExperimentConfig,
    define_configuration,
    experiment_name,
    flatten_config,
)
from .construct import (
    construct_loss,
    construct_optimizer,
    construct_time_series,
)
from .data import make_dataloader, synthetic_physionet
from .graph import capturable
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
from .train import (
    TrainState,
    create_train_state,
    init_ema,
    make_multi_train_step,
    make_phase_probes,
    make_train_step,
    swap_ema_params,
)

_STAT_KEYS = ("net_loss", "neg_log_likelihood", "kl_div", "reg_val", "nfe")


def build_physionet_arrays(cfg: ExperimentConfig):
    """PhysioNet-like arrays: the real artifact (``physionet.npz`` with keys
    observed_data, observed_mask and observed_tp, feature-major) when
    ``data_root`` holds one, else the synthetic latent-oscillator stand-in
    (2048 series). Returns batch-major ``(data, mask, dt)`` train and test
    splits (80/20 by a permutation seeded with ``cfg.seed``), the 49-point
    saveat grid and whether the data is real."""
    root = cfg.dataset.data_root
    npz_path = os.path.join(root, "physionet.npz") if root else ""
    if npz_path and os.path.exists(npz_path):
        d = np.load(npz_path)
        # feature-major (F, T, N) -> batch-major (N, T, F)
        data = np.transpose(d["observed_data"], (2, 1, 0)).astype(np.float32)
        mask = np.transpose(d["observed_mask"], (2, 1, 0)).astype(np.float32)
        tgrid = d["observed_tp"].astype(np.float32)[:, 0]
        real = True
    else:
        data, mask, tgrid = synthetic_physionet(
            n=2048, t_steps=49, features=cfg.model.ts_in_dims, seed=cfg.seed,
            difficulty=getattr(cfg.dataset, "difficulty", "easy"),
        )
        real = False
    dt = np.concatenate([tgrid[1:] - tgrid[:-1], [0.0]]).astype(np.float32)
    dt = np.ascontiguousarray(
        np.broadcast_to(dt[None, :, None], (data.shape[0], data.shape[1], 1)))
    n = data.shape[0]
    n_train = int(0.8 * n)
    idx = np.random.RandomState(cfg.seed).permutation(n)
    tr, te = idx[:n_train], idx[n_train:]
    return ((data[tr], mask[tr], dt[tr]), (data[te], mask[te], dt[te]),
            tgrid, real)


def check_supported(cfg: ExperimentConfig) -> None:
    """The parallel options of ``cfg.train``, with the JAX runners' checks
    and messages (``runner.py:67-120`` there): ``data_parallel`` one of
    'none', 'gspmd', 'shardmap'; ``tensor_parallel`` at least 1, and above
    1 with 'gspmd' only (its divisibility of the ranks, and of the batch by
    the data-parallel degree, are checked where the grid is made); 'shardmap'
    with neither gradient accumulation nor an explicit K > 1 (the JAX
    package refuses both there)."""
    t = cfg.train
    if t.data_parallel not in ("none", "gspmd", "shardmap"):
        raise ValueError("train.data_parallel must be 'none', 'gspmd' or "
                         f"'shardmap', got {t.data_parallel!r}")
    tp = int(t.tensor_parallel)
    if tp < 1:
        raise ValueError(f"train.tensor_parallel must be >= 1, got {tp}")
    if tp > 1 and t.data_parallel == "none":
        raise ValueError(
            "train.tensor_parallel > 1 requires data_parallel='gspmd'")
    if tp > 1 and t.data_parallel == "shardmap":
        raise ValueError(
            "train.tensor_parallel > 1 requires data_parallel='gspmd' "
            "(the shardmap mode is data-parallel only)")
    if t.data_parallel == "shardmap":
        if int(t.grad_accumulation) > 1:
            raise ValueError("train.grad_accumulation > 1 supports "
                             "data_parallel='none' or 'gspmd' (not 'shardmap')")
        if int(t.steps_per_call) > 1:
            raise ValueError("train.steps_per_call > 1 supports "
                             "data_parallel='none' or 'gspmd' (not 'shardmap')")


def train_state_to_host(ts: TrainState) -> dict:
    """What a checkpoint keeps of the train state: the parameters, the
    optimizer's state, the layer state (with its generators), the step and
    the params-EMA (None without one)."""
    return to_host({"params": ts.params, "opt": ts.opt_state.state_dict(),
                    "state": ts.state, "step": ts.step, "ema": ts.ema})


def restore_train_state(ts: TrainState, host: dict, device) -> TrainState:
    """``ts`` with a checkpoint's values: the parameters are copied into
    the leaves the optimizer is bound to. A checkpoint without an EMA
    (written before it existed, or without one) restores ``ema=None``; the
    runner then seeds it at the parameters (``init_ema``)."""
    with torch.no_grad():
        for name, value in host["params"].items():
            ts.params[name].copy_(torch.from_numpy(np.array(value)))
    ts.opt_state.load_state_dict(from_host(host["opt"], device))
    ema = host.get("ema")
    return TrainState(params=ts.params, state=from_host(host["state"], device),
                      opt_state=ts.opt_state, step=int(host["step"]),
                      ema=None if ema is None else from_host(ema, device))


def eval_forward(model, ts: TrainState, batch, dp=None):
    """The masked MSE of one batch, summed per series over time and
    features, divided by its observed count, averaged over the batch
    (``latent_runner.py:117-125`` of the reference), and the batch's NFE.
    With a ``DPGroup`` (``dp``, the global grid) ``batch`` is this rank's
    rows of an eval batch spread over the ranks: one solve over all of
    them, and the whole batch's MSE (the ranks' sums added in rank
    order)."""
    data, mask, dt = batch
    x = torch.cat([data, mask, dt], dim=-1)
    state = ts.state
    if dp is not None:
        from ..parallel.sharded_train import GlobalGridSync, group_paths

        state = GlobalGridSync(dp, group_paths(model, state)).state_in(state)
    with torch.no_grad():
        y, st_ = torch.func.functional_call(
            model, ts.params, (x, state), {"training": False})
    total = torch.sum(
        torch.sum(torch.square((y - data) * mask), dim=(1, 2))
        / torch.sum(mask, dim=(1, 2))
    )
    if dp is None:
        return total / data.shape[0], st_["neural_ode"]["nfe"]
    from ..parallel.mesh import ordered_sum

    return (ordered_sum(total, dp) / (data.shape[0] * dp.size),
            st_["neural_ode"]["nfe"])


def round_eval_batch(eval_bs: int, n_test: int, n_data: int) -> int:
    """The global grid's eval batch, as the JAX runner's pod mode takes it
    (``latent_runner.py:175-200`` there): ``eval_bs`` (already clamped to
    the ``n_test`` series of the test split) rounded down to the
    data-parallel degree ``n_data``; raises when that leaves none. A
    rounding is printed with the samples it skips beside a
    single-process run's."""
    rounded = eval_bs - eval_bs % n_data
    if rounded == 0:
        raise ValueError(
            f"test split ({n_test} samples) is smaller than the "
            f"data-parallel degree {n_data}; the global grid's latent eval "
            "needs at least one full global batch")
    if rounded != eval_bs:
        # with drop_last a single process also skips its tail batch, so
        # the delta is what the rounding costs
        skipped, single = n_test % rounded, n_test % eval_bs
        print(f"[latent eval] eval batch rounded {eval_bs} -> {rounded} for "
              f"data-parallel degree {n_data}; {skipped} of {n_test} test "
              f"samples skipped per eval pass ({skipped - single:+d} vs a "
              "single-process run)", flush=True)
    return rounded


def run_latent_ode_experiment(cfg: ExperimentConfig,
                              config_name: str = "physionet", *,
                              device=None, dp_backend=None) -> dict:
    """Train and evaluate the latent ODE of ``cfg`` on ``device`` (default:
    the CUDA device). Returns the summary of the reference's runner: the
    best and final masked MSE, the final eval NFE, whether the data is
    real, the checkpoint and log directories, ``steps_per_call`` and
    whether the K-step calls were ``captured`` CUDA graphs. Data
    parallelism and ``dp_backend`` as in the classification runner."""
    from ..parallel.multihost import checkpoint_subdir
    from .runner import _wire_data_parallel, start_data_parallel

    check_supported(cfg)
    ga, ed = check_train_options(cfg)
    dp, device = start_data_parallel(cfg, device, dp_backend)
    name = experiment_name(cfg, config_name)
    ckpt_dir = checkpoint_subdir(os.path.join(
        cfg.train.checkpoint_dir, cfg.train.expt_subdir, name), dp)
    log_dir = checkpoint_subdir(os.path.join(
        cfg.train.log_dir, cfg.train.expt_subdir, name), dp)

    train_arrays, test_arrays, tgrid, is_real = build_physionet_arrays(cfg)
    model = construct_time_series(cfg, saveat=torch.from_numpy(tgrid),
                                  device=device)
    loss_fn, (w_reg_sched, w_kl_sched) = construct_loss(cfg)
    optimizer, lr_sched = construct_optimizer(cfg)
    ts = create_train_state(model, optimizer)
    par = _wire_data_parallel(
        cfg, model, loss_fn, optimizer, ts, dp, device,
        train_step=make_train_step(model, loss_fn, optimizer,
                                   grad_accumulation=ga, ema_decay=ed),
        eval_step=None)
    train_step = par.train_step
    dp = par.dp  # with the parameters' specs under tensor parallelism
    spc = resolve_steps_per_call(
        cfg.train.steps_per_call, cfg.train.print_frequency,
        cfg.train.evaluate_every,
        capturable(model, par.rows // ga, device, dp))
    check_steps_per_call(cfg, spc)
    if int(cfg.train.steps_per_call) == 0 and spc > 1:
        print(f"steps_per_call=auto -> K={spc} (one CUDA-graph replay a "
              "call)", flush=True)

    initial_step, restored_best = 1, None
    resume_path = cfg.train.resume or os.path.join(ckpt_dir,
                                                   "model_current.ckpt")
    if os.path.exists(resume_path):
        restored = load_checkpoint(resume_path)
        if restored is not None:
            ts = par.restored(ts, restored["tstate"], device,
                              cfg.dataset.train_batchsize)
            initial_step = int(restored["step"]) + 1
            restored_best = restored.get("best")
    if ed > 0.0 and ts.ema is None:
        # a fresh start, or a checkpoint written without an EMA
        ts = init_ema(ts)

    # after the resume: skip_batches fast-forwards the seeded stream
    train_loader = make_dataloader(
        train_arrays, cfg.dataset.train_batchsize, shuffle=True, cycle=True,
        seed=cfg.seed, skip_batches=initial_step - 1,
    )
    # the eval batch is clamped to the test split (with drop_last a larger
    # one would yield no batch: 410 series at the shipped eval size 512);
    # the global grid spreads each eval batch over the ranks
    n_test = int(test_arrays[0].shape[0])
    eval_bs = min(int(cfg.dataset.eval_batchsize), n_test)
    eval_dp = dp if par.mode == "gspmd" else None
    if eval_dp is not None:
        eval_bs = round_eval_batch(eval_bs, n_test, dp.size)

    total_steps = cfg.train.total_steps
    loggers = create_logger(log_dir, total_steps, latent_ode=True,
                            expt_name=name, config=flatten_config(cfg))
    tm = loggers["train_meters"]
    best = np.inf if restored_best is None else float(restored_best)
    final_mse, final_nfe = np.inf, 0.0

    # the per-window phase probes (fwd/bwd/opt columns)
    measure_phases = make_phase_probes(model, par.probe_loss(loss_fn),
                                       optimizer)

    def print_window(step, sums, window_n, ok, wall, data_time, bs, ts, batch,
                     w):
        for k, v in zip(_STAT_KEYS, sums):
            tm[k].update(v / window_n, window_n * bs)
        t_fwd, t_fwdbwd = measure_phases(ts, batch, w)
        step_time = wall / window_n
        tm["batch_time"].update(step_time, window_n)
        tm["data_time"].update(data_time / window_n, window_n)
        tm["step_time"].update(step_time, window_n)
        tm["fwd_time"].update(t_fwd, window_n)
        tm["bwd_time"].update(max(t_fwdbwd - t_fwd, 0.0), window_n)
        tm["opt_time"].update(max(step_time - t_fwdbwd, 0.0), window_n)
        if not ok:
            print(f"WARNING [{step}]: adaptive solve exhausted max_steps "
                  "within this window", flush=True)
        row = get_loggable_values(tm, loggers["train_header"], step)
        loggers["csv_train"].log(row)
        print(f"[{step}/{total_steps}] " + " ".join(
            f"{k}={tm[k].average:.4f}"
            for k in loggers["train_header"][1:]), flush=True)
        reset_meters(tm)

    def eval_and_checkpoint(step, w, ts):
        nonlocal best, final_mse, final_nfe
        best, final_mse, final_nfe = _eval_and_checkpoint(
            model, ts, test_arrays, eval_bs, step, best, loggers, ckpt_dir,
            device, par.gathered(ts), eval_dp)

    def stat_row(loss, stats):
        return torch.stack([loss, stats["neg_log_likelihood"],
                            stats["kl_div"], stats["reg_val"],
                            stats["nfe"].float()])

    summary = {"real_data": bool(is_real), "ckpt_dir": ckpt_dir,
               "log_dir": log_dir, "steps_per_call": spc, "captured": False}
    if dp is not None:
        summary.update(data_parallel=par.mode, world_size=dp.world_size,
                       rank=dp.world_rank, tensor_parallel=dp.model_size)
    data_iter = iter(train_loader)
    if spc > 1:
        reduce_fn = (lambda loss, stats, data: {
            "row": stat_row(loss, stats),
            "n_fail": (~stats["solver_success"]).float()})
        multi_step = (make_multi_train_step(
            model, loss_fn, optimizer, reduce_fn, grad_accumulation=ga,
            ema_decay=ed) if par.make_block is None
            else par.make_block(reduce_fn))
        stacks = device_batches(
            (par.host_stack(s) for s in host_stacks(
                data_iter, initial_step, total_steps, spc)), device,
            int(cfg.train.device_prefetch))
        run_block_loop(
            multi_step, ts, stacks, initial_step=initial_step,
            total_steps=total_steps,
            print_frequency=cfg.train.print_frequency,
            evaluate_every=cfg.train.evaluate_every,
            w_of=lambda steps: (
                np.asarray([w_reg_sched(s) for s in steps], np.float32),
                np.asarray([w_kl_sched(s) for s in steps], np.float32)),
            lr_of=lambda steps: np.asarray([lr_sched(s) for s in steps],
                                           np.float32),
            on_window=print_window, on_eval=eval_and_checkpoint,
            reduce_window=par.window)
        summary["captured"] = bool(multi_step.captured)
    else:
        sums = ok = None
        window_n, data_time = 0, 0.0
        t_window = time.perf_counter()
        for step in range(initial_step, total_steps + 1):
            t0 = time.perf_counter()
            batch = batch_to_device(par.host(next(data_iter)), device)
            data_time += time.perf_counter() - t0
            w = (float(w_reg_sched(step)), float(w_kl_sched(step)))
            ts, loss, stats = train_step(ts, batch, w, float(lr_sched(step)))
            # accumulated on the device: one host read per print window
            vals = stat_row(loss, stats)
            success = stats["solver_success"]
            sums = vals if sums is None else sums + vals
            ok = success if ok is None else ok & success
            window_n += 1
            if step % cfg.train.print_frequency == 0:
                print_window(step, par.window(sums).tolist(), window_n,
                             bool(ok),
                             time.perf_counter() - t_window, data_time,
                             int(batch[0].shape[0]), ts, batch, w)
                sums, ok, window_n, data_time = None, None, 0, 0.0
                t_window = time.perf_counter()
            if step % cfg.train.evaluate_every == 0 or step == total_steps:
                eval_and_checkpoint(step, w, ts)
    return dict(summary, best_eval_mse=float(best),
                final_eval_mse=float(final_mse),
                final_eval_nfe=float(final_nfe))


def _eval_and_checkpoint(model, ts, test_arrays, eval_bs, step, best,
                         loggers, ckpt_dir, device, saved=None, dp=None):
    """The masked MSE over the test split, then the step's checkpoint
    (``model_best`` when its MSE is the lowest so far) of ``saved`` (the
    train state with its gathered layer state; default ``ts``). With a
    ``DPGroup`` (``dp``) each eval batch is spread over the ranks and
    solved on the global grid. Returns the best MSE, this evaluation's MSE
    and its mean NFE."""
    mses, nfes, count = 0.0, 0.0, 0
    # with an EMA, evaluation and the best checkpoint see the averaged
    # weights; the checkpoint keeps both
    for host_batch in make_dataloader(test_arrays, eval_bs, drop_last=True):
        part = host_batch
        if dp is not None:
            from ..parallel import shard_batch

            part = shard_batch(host_batch, dp)
        mse, nfe = eval_forward(model, swap_ema_params(ts),
                                batch_to_device(part, device), dp)
        bs = host_batch[0].shape[0]
        mses += float(mse) * bs
        nfes += float(nfe) * bs
        count += bs
    eval_mse = mses / count
    print(f"[eval @ {step}] masked_mse={eval_mse:.5f} nfe={nfes / count:.1f}",
          flush=True)
    loggers["wandb"].log({"eval_masked_mse": eval_mse}, step=step)
    is_best = eval_mse <= best
    best = min(best, eval_mse)
    save_checkpoint(
        {"tstate": train_state_to_host(ts if saved is None else saved),
         "step": step, "best": float(best)},
        fdir=ckpt_dir, fname=f"model_step_{step}.ckpt", is_best=is_best,
    )
    return best, eval_mse, nfes / count


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("--"):
        print("usage: python -m localregneuralde_tpu_torch.harness."
              "latent_runner CONFIG.yaml [--a.b.c=value ...] [--device=cpu] "
              "[--dp_backend=gloo|nccl]",
              file=sys.stderr)
        return 2
    from .runner import pop_run_options

    device, backend = pop_run_options(argv)
    cfg = define_configuration(argv[1:], argv[0])
    config_name = os.path.splitext(os.path.basename(argv[0]))[0]
    summary = run_latent_ode_experiment(cfg, config_name, device=device,
                                        dp_backend=backend)
    print("summary:", summary, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
