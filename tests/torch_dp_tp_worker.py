"""One rank of the port's tensor-parallel checks on the CPU (Gloo).

``python tests/torch_dp_tp_worker.py IN_FILE OUT_DIR RANK WORLD PORT`` joins
a Gloo group of four ranks on 127.0.0.1:PORT and lays out two grids over
it: the whole world as 2 × 2 (``make_dp_group(2)``: data ranks d = r // 2,
model ranks m = r % 2) and each pair of ranks {0, 1}, {2, 3} as a 1 × 2
grid (both pairs run the same steps). On each it runs the jobs below on
the inputs pickled in IN_FILE (the JAX-layout parameters, the batches and
JAX's draws that ``tests/test_torch_parallel_tp.py`` made), each beside
the same data degree's global grid without tensor parallelism
(``DPGroup.data_axis``), and pickles the results to
``OUT_DIR/rank{RANK}.pkl``. On the 2 × 2 grid it also runs both runners.
It imports the port only, never JAX.
"""
from __future__ import annotations

import os
import pickle
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tests import torch_dp_families_worker as FW  # noqa: E402
from tests import torch_dp_worker as W  # noqa: E402
from tests.torch_dp_worker import host  # noqa: E402

TP = 2
# the clipping's bound: well below the gradient's norm, so every step clips
CLIP = ["--optimizer.gradient_clip_norm=1e-3"]
ADAM = ["--optimizer.optimizer=adam", "--optimizer.learning_rate=1e-3"]
KERNEL = ["--model.use_pallas=on"]


def grids():
    """``{"2x2": ..., "1x2": ...}``: this rank's ``DPGroup`` of each grid;
    every rank makes every subgroup, in the same order."""
    import torch.distributed as dist

    from localregneuralde_tpu_torch.parallel import DPGroup, make_dp_group

    g22 = make_dp_group(TP)
    r = dist.get_rank()
    singles = [dist.new_group([k]) for k in range(4)]
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    g12 = DPGroup(group=singles[r], rank=0, size=1, model_group=pairs[r // 2],
                  model_rank=r % 2, model_size=TP, world_rank=r % 2,
                  world_size=TP)
    return {"2x2": g22, "1x2": g12}


def inject(inp):
    """JAX's draws into the port's hooks (t1 of both models, the latent
    model's ε); returns the restorer."""
    from localregneuralde_tpu_torch.models import common, neural_ode

    real = neural_ode.sample_t1, common.reparam_noise
    neural_ode.sample_t1 = lambda g, t0, t2: inp["t1"][inp["which"]]
    common.reparam_noise = lambda g, shape, like: torch.tensor(inp["eps"])

    def restore():
        neural_ode.sample_t1, common.reparam_noise = real

    return restore


def setup(inp, family, extra=()):
    """``(model, loss_fn, opt, ts, w, batch)`` of ``family`` ("mlp": the
    MNIST ODE at 8×8 images and hidden 16; "latent": the small latent ODE)
    from the JAX-layout parameters of ``inp``."""
    inp["which"] = family
    if family == "mlp":
        model, loss_fn, opt, ts = W.mlp_setup(inp["mlp_params"], extra)
        return model, loss_fn, opt, ts, W.W_REG, inp["mlp_batch"]
    model, loss_fn, opt, ts, w = FW.latent_setup(
        inp["latent_params"], "off", inp["tgrid"], extra)
    return model, loss_fn, opt, ts, w, inp["latent_batch"]


def tp_step(inp, family, g, extra=(), ema=False, ga=1):
    """One global-grid step of ``family`` on the grid ``g`` with its
    parameters (their moments and EMA) sharded by JAX's rules (``ga``
    microbatches): the whole train state after it (gathered over the model
    group), the loss and stats, and this rank's shards."""
    from localregneuralde_tpu_torch.harness.train import init_ema
    from localregneuralde_tpu_torch.parallel import (
        make_sharded_train_step, shard_batch, shard_train_state,
        train_state_shardings, whole_train_state,
    )

    model, loss_fn, opt, ts, w, batch = setup(inp, family, extra)
    if ema:
        ts = init_ema(ts)
    g = train_state_shardings(ts, g)
    specs = g.specs or None
    if specs is not None:
        shard_train_state(ts, g)
    step = make_sharded_train_step(model, loss_fn, opt, g,
                                   ema_decay=W.DECAY if ema else 0.0,
                                   grad_accumulation=ga)
    shards = dict(params=host(ts.params))
    ts, loss, stats = step(ts, shard_batch(batch, g, n_micro=ga), w, W.LR)
    out = dict(loss=host(loss), nfe=host(stats["nfe"]),
               reg_val=host(stats["reg_val"]), specs=specs)
    if specs is not None:
        out["shards"] = dict(before=shards["params"],
                             params=host(ts.params),
                             opt={k: {s: host(ts.opt_state.state[p][s])
                                      for s in ts.opt_state.slots}
                                  for k, p in ts.params.items()},
                             ema=host(ts.ema))
        ts = whole_train_state(ts, g, opt)
    out.update(params=host(ts.params), ema=host(ts.ema),
               opt={k: {s: host(ts.opt_state.state[p][s])
                        for s in ts.opt_state.slots}
                    for k, p in ts.params.items()})
    return out


def tp_k_step(inp, g):
    """The K-step call (K = 2, its bodies eager) under TP against two
    single calls from the same sharded state: the whole parameters after
    each."""
    from localregneuralde_tpu_torch.parallel import (
        make_sharded_multi_train_step, make_sharded_train_step, shard_batch,
        shard_train_state, train_state_shardings, whole_train_state,
    )

    out = {}
    for how in ("single", "multi"):
        model, loss_fn, opt, ts, w, batch = setup(inp, "mlp", KERNEL)
        g = train_state_shardings(ts, g)
        shard_train_state(ts, g)
        data = shard_batch(batch, g)
        if how == "single":
            step = make_sharded_train_step(model, loss_fn, opt, g)
            for _ in range(2):
                ts, loss, _ = step(ts, data, w, W.LR)
        else:
            multi = make_sharded_multi_train_step(model, loss_fn, opt, g)
            stack = tuple(torch.stack([a, a]) for a in data)
            ts, loss, _ = multi(ts, stack, torch.full((2,), W.W_REG),
                                torch.full((2,), W.LR))
            out["captured"] = multi.captured
        out[how] = dict(loss=host(loss), params=host(whole_train_state(
            ts, g, opt).params))
    return out


def job_steps(inp, g):
    """Each family on the plain route and on the kernel route's plain
    twins (``use_pallas='on'``), under tensor parallelism and on the same
    data degree's global grid; Adam's moments and the EMA; two
    microbatches; the K-step call; the clipped step."""
    restore = inject(inp)
    out = {}
    try:
        for family in ("mlp", "latent"):
            for route, extra in (("plain", []), ("kernel", KERNEL)):
                out[f"{family} {route}"] = tp_step(inp, family, g, extra)
                out[f"{family} {route} dp"] = tp_step(inp, family,
                                                      g.data_axis(), extra)
        out["moments"] = tp_step(inp, "mlp", g, KERNEL + ADAM, ema=True)
        out["moments dp"] = tp_step(inp, "mlp", g.data_axis(), KERNEL + ADAM,
                                    ema=True)
        out["ga"] = tp_step(inp, "mlp", g, KERNEL, ga=2)
        out["ga dp"] = tp_step(inp, "mlp", g.data_axis(), KERNEL, ga=2)
        out["kstep"] = tp_k_step(inp, g)
        out["clip"] = tp_step(inp, "mlp", g, CLIP)
        out["clip kernel"] = tp_step(inp, "mlp", g, CLIP + KERNEL)
        out["clip kernel dp"] = tp_step(inp, "mlp", g.data_axis(),
                                        CLIP + KERNEL)
    finally:
        restore()
    return out


def replicated_setup(family):
    """``(model, loss_fn, opt, ts, w, batch)`` of the CIFAR model at 8×8
    images or the MNIST SDE at 8×8, with their own initial weights."""
    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, construct_optimizer,
        create_train_state, define_configuration, one_hot,
        synthetic_classification,
    )
    from tests import torch_dp_conv_worker as CW

    if family == "cifar":
        cfg = CW.cifar_cfg(define_configuration, ["--model.use_pallas=on"])
        channels = 3
    else:
        cfg = define_configuration(FW.SDE_ARGS, FW.SDE_CONFIG)
        channels = 1
    model = construct_model(cfg, device="cpu")
    loss_fn, w_reg = construct_loss(cfg)
    opt, _ = construct_optimizer(cfg)
    x, y, _, _ = synthetic_classification((8, 8), channels, 10, n_train=W.B,
                                          n_test=1, seed=4)
    batch = (torch.from_numpy(x), torch.from_numpy(one_hot(y, 10)))
    return (model, loss_fn, opt, create_train_state(model, opt), w_reg(1),
            batch)


def job_replicated(g):
    """The CIFAR model and the MNIST SDE at tp = 2 (every leaf whole) and
    on the same data degree's global grid: one step each."""
    from localregneuralde_tpu_torch.parallel import (
        make_sharded_train_step, shard_batch, shard_train_state,
        train_state_shardings,
    )

    out = {}
    for family in ("cifar", "sde"):
        for tag, grid in (("tp", g), ("dp", g.data_axis())):
            model, loss_fn, opt, ts, w, batch = replicated_setup(family)
            if grid.model_size > 1:
                grid = train_state_shardings(ts, grid)
                shard_train_state(ts, grid)
                out[f"{family} specs"] = grid.specs
            step = make_sharded_train_step(model, loss_fn, opt, grid)
            ts, loss, stats = step(ts, shard_batch(batch, grid), w, W.LR)
            out[f"{family} {tag}"] = dict(params=host(ts.params),
                                          loss=host(loss))
    return out


def job_runners(inp, out_dir):
    """Both runners under ``gspmd`` with ``tensor_parallel=2`` on the 2 × 2
    grid of the whole world, each resuming from the single-device
    checkpoint that the test wrote (``inp["resume"]``): the summaries."""
    from localregneuralde_tpu_torch.harness import define_configuration
    from localregneuralde_tpu_torch.harness.latent_runner import (
        run_latent_ode_experiment,
    )
    from localregneuralde_tpu_torch.harness.runner import (
        run_classification_experiment,
    )

    out = {}
    for module, args in inp["runners"].items():
        cfg = define_configuration(args[1:] + [
            "--train.data_parallel=gspmd", f"--train.tensor_parallel={TP}",
            f"--train.checkpoint_dir={out_dir}/{module}/ck",
            f"--train.log_dir={out_dir}/{module}/lg",
            f"--train.resume={inp['resume'][module]}"], args[0])
        run = (run_classification_experiment if module == "runner"
               else run_latent_ode_experiment)
        out[module] = run(cfg, "tp", device="cpu")
    return out


def main(argv):
    in_file, out_dir, rank, world, port = argv
    from localregneuralde_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(rank=int(rank), world_size=int(world),
                         master_port=int(port), backend="gloo")
    with open(in_file, "rb") as f:
        inp = pickle.load(f)
    out, grid = {}, grids()
    for name, g in grid.items():
        out[name] = job_steps(inp, g)
        out[name]["shape"] = (g.size, g.model_size, g.rank, g.model_rank)
    out["2x2"].update(job_replicated(grid["2x2"]))
    out["runners"] = job_runners(inp, out_dir)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
