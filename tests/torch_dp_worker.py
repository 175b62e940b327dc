"""One rank of the port's data-parallel checks on the CPU (Gloo).

``python tests/torch_dp_worker.py IN_FILE OUT_DIR RANK WORLD PORT`` joins a
Gloo group of WORLD ranks on 127.0.0.1:PORT, runs every job below on the
inputs pickled in IN_FILE (the parameters, the batches and the draws that
``tests/test_torch_parallel.py`` made) and pickles each job's results to
``OUT_DIR/rank{RANK}.pkl``. It imports the port only, never JAX. The setup
functions are shared with the tests.
"""
from __future__ import annotations

import copy
import os
import pickle
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIG = os.path.join(ROOT, "experiments", "mnist_ode", "mlp.yaml")
LATENT_CONFIG = os.path.join(ROOT, "experiments", "physionet",
                             "physionet.yaml")
# rtol 3e-2: the regulariser's error estimate is well above its float32
# rounding noise there (tests/test_torch_train.py)
MLP_ARGS = [
    "--model.mlp_hidden_state_size=16", "--model.solver.reltol=3e-2",
    "--model.solver.abstol=3e-2", "--model.solver.max_steps=16",
    "--model.regularize=unbiased", "--optimizer.optimizer=sgd",
    "--optimizer.learning_rate=0.1",
]
LATENT_ARGS = [
    "--model.ts_in_dims=5", "--model.ts_hidden_dims=8",
    "--model.ts_latent_dims=6", "--model.ts_node_dims=4",
    "--model.solver.reltol=1e-2", "--model.solver.abstol=1e-2",
    "--model.solver.max_steps=32",
]
B, LR, W_REG, DECAY = 8, 0.1, 1.0, 0.9
LATENT_W = (1.0, 0.1)


def mlp_cfg(define, extra=()):
    cfg = define(MLP_ARGS + list(extra), CONFIG)
    cfg.model.image_size = [8, 8]
    cfg.model.in_channels = 1
    return cfg


def mlp_setup(params, extra=()):
    """The port's tiny MNIST ODE with the given (JAX-layout) parameters."""
    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, construct_optimizer,
        create_train_state, define_configuration,
    )
    from localregneuralde_tpu_torch.parity import load_jax_params

    cfg = mlp_cfg(define_configuration, extra)
    model = construct_model(cfg, device="cpu")
    load_jax_params(model, params)
    loss_fn, _ = construct_loss(cfg)
    opt, _ = construct_optimizer(cfg)
    return model, loss_fn, opt, create_train_state(model, opt)


def latent_setup():
    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_optimizer, construct_time_series,
        create_train_state, define_configuration,
    )

    cfg = define_configuration(LATENT_ARGS, LATENT_CONFIG)
    model = construct_time_series(cfg, saveat=torch.linspace(0.0, 1.0, 7),
                                  device="cpu")
    loss_fn, _ = construct_loss(cfg)
    opt, _ = construct_optimizer(cfg)
    return model, loss_fn, opt, create_train_state(model, opt)


def latent_batch(seed=5):
    rng = np.random.RandomState(seed)
    data = rng.randn(B, 7, 5).astype(np.float32)
    mask = (rng.rand(B, 7, 5) < 0.6).astype(np.float32)
    dt = np.full((B, 7, 1), 1.0 / 6, np.float32)
    return tuple(torch.from_numpy(a) for a in (data, mask, dt))


def host(tree):
    """Tensors to numpy, generators to their states, recursively."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, torch.Generator):
        return tree.get_state().numpy()
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(host(v) for v in tree)
    return tree


def _step_out(ts, loss, stats):
    return dict(params=host(ts.params), state=host(ts.state),
                ema=host(ts.ema), loss=host(loss), stats=host(stats))


def job_shardmap(inp, dp):
    """The per-rank grid: two MNIST steps (with the EMA), the flag and pair
    stats, and two latent steps with the tuple w_reg."""
    from localregneuralde_tpu_torch.harness.train import init_ema
    from localregneuralde_tpu_torch.parallel import (
        make_shardmap_train_step, shard_batch,
    )

    out = {}
    model, loss_fn, opt, ts = mlp_setup(inp["params"])
    ts = init_ema(ts)
    step = make_shardmap_train_step(model, loss_fn, opt, dp,
                                    ema_decay=DECAY)
    data = shard_batch(inp["batch"], dp)
    for k in range(2):
        ts, loss, stats = step(ts, data, W_REG, LR)
        out[f"mlp{k}"] = _step_out(ts, loss, stats)

    thresh = float(inp["batch"][0].max())

    def flagged(model_, params, state, data_, w, training=True):
        loss, st_, stats = loss_fn(model_, params, state, data_, w,
                                   training=training)
        stats = dict(stats, flag=data_[0].max() < thresh,
                     pair=torch.zeros(2))
        return loss, st_, stats

    model, _, opt, ts = mlp_setup(inp["params"])
    step = make_shardmap_train_step(model, flagged, opt, dp)
    _, loss, stats = step(ts, data, W_REG, LR)
    out["flag"] = dict(flag=host(stats["flag"]), pair=host(stats["pair"]),
                       success=host(stats["solver_success"]))

    model, loss_fn, opt, ts = latent_setup()
    step = make_shardmap_train_step(model, loss_fn, opt, dp)
    data = shard_batch(latent_batch(), dp)
    for k in range(2):
        ts, loss, stats = step(ts, data, LATENT_W, 1e-3)
        out[f"latent{k}"] = _step_out(ts, loss, stats)
    return out


def reg_only(loss_fn):
    """The loss of ``loss_fn`` with the regulariser alone as its objective:
    its gradient is the one a rank mean of plain gradients would get
    wrong on the global grid."""
    def fn(model, params, state, data, w, training=True):
        _, st_, stats = loss_fn(model, params, state, data, w,
                                training=training)
        return stats["reg_val"], st_, stats

    return fn


def job_gspmd(inp, dp):
    """The global grid: one step with JAX's t1, two steps with the EMA
    (and one with a carried EMA at decay 0), the K-step call against K
    single calls, gradient accumulation, and the solve's grid."""
    from localregneuralde_tpu_torch.harness.train import init_ema
    from localregneuralde_tpu_torch.models import neural_ode
    from localregneuralde_tpu_torch.ode import odesolve
    from localregneuralde_tpu_torch.parallel import (
        make_sharded_multi_train_step, make_sharded_train_step, shard_batch,
    )

    out = {}
    real_t1 = neural_ode.sample_t1
    neural_ode.sample_t1 = lambda g, t0, t2: inp["t1"]
    data = shard_batch(inp["batch"], dp)
    for name, wrap in (("step", None), ("reg_only", reg_only)):
        model, loss_fn, opt, ts = mlp_setup(inp["params"])
        step = make_sharded_train_step(
            model, loss_fn if wrap is None else wrap(loss_fn), opt, dp)
        ts, loss, stats = step(ts, data, W_REG, LR)
        out[name] = _step_out(ts, loss, stats)

    # the EMA: two steps, and a carried EMA through decay 0
    model, loss_fn, opt, ts = mlp_setup(inp["params"])
    ts = init_ema(ts)
    step = make_sharded_train_step(model, loss_fn, opt, dp, ema_decay=DECAY)
    snaps = []
    for _ in range(2):
        ts, _, _ = step(ts, data, W_REG, LR)
        snaps.append(host(ts.params))
    out["ema"] = dict(params=snaps, ema=host(ts.ema))
    model, loss_fn, opt, ts = mlp_setup(inp["params"])
    ts = init_ema(ts)
    ema0 = host(ts.ema)
    step = make_sharded_train_step(model, loss_fn, opt, dp, ema_decay=0.0)
    ts, _, _ = step(ts, data, W_REG, LR)
    out["ema_off"] = dict(before=ema0, after=host(ts.ema))

    # the K-step call: K = 2 against two single calls from copies
    model, loss_fn, opt, ts = mlp_setup(inp["params"])
    ts_a, ts_b = copy.deepcopy(ts), copy.deepcopy(ts)
    single = make_sharded_train_step(model, loss_fn, opt, dp)
    reds = []
    for k in range(2):
        ts_a, la, sa = single(ts_a, shard_batch(inp["batches"][k], dp),
                              W_REG, LR)
        reds.append(torch.stack([la, sa["reg_val"]]))
    multi = make_sharded_multi_train_step(
        model, loss_fn, opt, dp,
        reduce_fn=lambda loss, stats, d: {
            "row": torch.stack([loss, stats["reg_val"]])})
    stack = tuple(torch.stack(s) for s in zip(
        *[shard_batch(b, dp) for b in inp["batches"]]))
    ts_b, lb, red = multi(ts_b, stack, np.full(2, W_REG, np.float32),
                          np.full(2, LR, np.float32))
    out["kstep"] = dict(
        params_single=host(ts_a.params), params_multi=host(ts_b.params),
        red_single=host(reds[0] + reds[1]), red_multi=host(red["row"]),
        loss_single=host(la), loss_multi=host(lb),
        captured=multi.captured)

    # gradient accumulation: two microbatches, each spread over the ranks
    model, loss_fn, opt, ts = mlp_setup(inp["params"])
    step = make_sharded_train_step(model, loss_fn, opt, dp,
                                   grad_accumulation=2)
    ts, loss, stats = step(ts, shard_batch(inp["batch"], dp, n_micro=2),
                           W_REG, LR)
    out["ga"] = _step_out(ts, loss, stats)
    neural_ode.sample_t1 = real_t1

    # the grid of one solve: this rank's rows, every norm global
    w = torch.from_numpy(inp["ode_w"])
    u0 = shard_batch((torch.from_numpy(inp["ode_u0"]),), dp)[0]
    sol = odesolve(lambda u, t: torch.tanh(u @ w) - 0.5 * u, u0, (0.0, 1.0),
                   rtol=1e-6, atol=1e-8, max_steps=64, adjoint="none",
                   group=dp)
    out["solve"] = dict(naccept=int(sol.naccept), nreject=int(sol.nreject),
                        nfe=int(sol.nfe), y=host(sol.y_final))
    return out


def job_parting(inp, dp):
    """A rank whose counts differ makes every rank raise."""
    from localregneuralde_tpu_torch.parallel.mesh import agree

    try:
        agree(torch.tensor([3, dp.rank]), dp, "accepts and rejects")
    except RuntimeError as e:
        return {"raised": "parted" in str(e)}
    return {"raised": False}


def main(argv):
    in_file, out_dir, rank, world, port = argv
    from localregneuralde_tpu_torch.parallel import make_dp_group, multihost

    torch.set_num_threads(1)
    multihost.initialize(rank=int(rank), world_size=int(world),
                         master_port=int(port), backend="gloo")
    dp = make_dp_group()
    with open(in_file, "rb") as f:
        inp = pickle.load(f)
    out = {name: fn(inp, dp) for name, fn in (
        ("shardmap", job_shardmap), ("gspmd", job_gspmd),
        ("parting", job_parting))}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
