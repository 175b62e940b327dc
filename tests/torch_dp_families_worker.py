"""One rank of the global grid's checks for the chain (latent ODE) and SDE
families on the CPU (Gloo).

``python tests/torch_dp_families_worker.py IN_FILE OUT_DIR RANK WORLD PORT``
joins a Gloo group of WORLD ranks on 127.0.0.1:PORT, runs every job below
on the inputs pickled in IN_FILE (the JAX-layout parameters, the batches
and JAX's draws that ``tests/test_torch_parallel_families.py`` made) and
pickles each job's results to ``OUT_DIR/rank{RANK}.pkl``. The jobs that
take the port's own draws import the port only; the SDE job with JAX's
draws imports ``jax`` for the Brownian tree's normals, this rank's rows of
the whole batch's (a tree node's normals are drawn at the batch's shape).
The setup functions are shared with the tests.
"""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tests.torch_dp_worker import host  # noqa: E402

LATENT_CONFIG = os.path.join(ROOT, "experiments", "physionet",
                             "physionet.yaml")
SDE_CONFIG = os.path.join(ROOT, "experiments", "mnist_sde", "mlp.yaml")
IN, HID, LAT, NODE, T = 5, 8, 6, 4, 7
B, LR = 8, 0.1
# the K = 2 call's learning rate: SGD at 0.1 on the latent model's NLL
# (~4e3) overflows in the second step
K_LR = {"latent": 1e-5, "sde": LR}
LATENT_ARGS = [
    f"--model.ts_in_dims={IN}", f"--model.ts_hidden_dims={HID}",
    f"--model.ts_latent_dims={LAT}", f"--model.ts_node_dims={NODE}",
    "--model.solver.reltol=3e-2", "--model.solver.abstol=3e-2",
    "--model.solver.max_steps=64", "--optimizer.optimizer=sgd",
    "--optimizer.learning_rate=0.1",
]
SDE_MAX_STEPS = 48
SDE_ARGS = [
    "--model.regularize=unbiased", "--model.image_size=[8,8]",
    f"--model.solver.max_steps={SDE_MAX_STEPS}", "--optimizer.optimizer=sgd",
    "--optimizer.learning_rate=0.1",
    "--optimizer.scheduler.lr_scheduler=constant",
]
# the chain's dense knots for 2 accepts only: its kernel sweep replays
# windows (the two-level branch)
TWO_LEVEL = ["--model.solver.knot_window=2"]
# the tree nodes whose normals each rank reports: the endpoint, the first
# midpoint and two deeper ones
NODES = (1, 2, 5, 37)


def latent_setup(params, use_pallas="off", tgrid=None, extra=()):
    """The port's small latent ODE with the given (JAX-layout) parameters
    (and ``extra`` overrides): ``(model, loss_fn, opt, ts, w)``, ``w`` the
    step's (w_reg, w_kl) with the KL weight at 0.5 so that its term
    counts."""
    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_optimizer, construct_time_series,
        create_train_state, define_configuration,
    )
    from localregneuralde_tpu_torch.parity import latent_tree, load_jax_params

    cfg = define_configuration(LATENT_ARGS + [
        f"--model.use_pallas={use_pallas}"] + list(extra), LATENT_CONFIG)
    if tgrid is None:
        tgrid = np.linspace(0.0, 1.0, T, dtype=np.float32)
    model = construct_time_series(cfg, saveat=torch.tensor(tgrid),
                                  device="cpu")
    load_jax_params(model, latent_tree(params))
    loss_fn, (w_reg, _) = construct_loss(cfg)
    opt, _ = construct_optimizer(cfg)
    return (model, loss_fn, opt, create_train_state(model, opt),
            (float(w_reg(1)), 0.5))


def sde_setup(params, use_pallas="off"):
    """The port's ``mnist_sde/mlp.yaml`` model at 8×8 images with the given
    (JAX-layout) parameters: ``(model, loss_fn, opt, ts, w_reg)``."""
    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, construct_optimizer,
        create_train_state, define_configuration,
    )
    from localregneuralde_tpu_torch.parity import load_jax_params

    cfg = define_configuration(SDE_ARGS + [
        f"--model.use_pallas={use_pallas}"], SDE_CONFIG)
    model = construct_model(cfg, device="cpu")
    load_jax_params(model, params)
    loss_fn, w_reg = construct_loss(cfg)
    opt, _ = construct_optimizer(cfg)
    return model, loss_fn, opt, create_train_state(model, opt), w_reg(1)


def step_out(ts, loss, stats):
    return dict(params=host(ts.params), loss=host(loss), stats=host(stats),
                state=host(ts.state))


def recording_noise(real, record):
    """A ``noise_source`` that builds the source ``real`` gives (the
    layer's own) and records its normals at ``NODES``, with its seed, rows
    and row offset."""

    def source(seed, x, width=None, row_offset=0):
        src = real(seed, x, width, row_offset=row_offset)
        record.append(dict(seed=src.seed, rows=int(x.shape[0]),
                           row_offset=row_offset,
                           normals={n: host(src(n)) for n in NODES}))
        return src

    return source


def jax_tree_noise(noise_key, shape):
    """JAX's XLA tree normals of the whole batch (``shape``), as a port
    source of this call's rows (``row_offset`` on)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    key_w, _ = jax.random.split(jax.random.fold_in(
        jax.numpy.asarray(noise_key), 7))

    def source(seed, x, width=None, row_offset=0):
        rows = slice(row_offset, row_offset + int(x.shape[0]))

        def normals(node):
            z = jax.random.normal(jax.random.fold_in(key_w, node),
                                  (2,) + tuple(shape))
            return torch.tensor(np.asarray(z)[:, rows])

        return normals

    return source


def counting_wrappers(names, counts, rows=None):
    """Replace each wrapper of ``ops.cuda`` in ``names`` by one that counts
    its calls into ``counts`` (the layers import them at call time), and
    appends the rows of a solve's state (its third argument) to ``rows``;
    returns a function that puts the originals back."""
    from localregneuralde_tpu_torch.ops import cuda

    real = {n: getattr(cuda, n) for n in names}

    def counted(name):
        def fn(*a, **kw):
            counts[name] = counts.get(name, 0) + 1
            if rows is not None and name.endswith("_solve"):
                rows.append(int(a[2 if "chain" in name else 1].shape[0]))
            return real[name](*a, **kw)

        return fn

    for n in names:
        setattr(cuda, n, counted(n))

    def restore():
        for n, f in real.items():
            setattr(cuda, n, f)

    return restore


def spying_sweep(record):
    """Replace ``ops.cuda.persistent_chain_sweep`` by one that appends each
    call's ``(naccept, rows of its cotangent, two-level)`` to ``record``;
    returns a function that puts the original back."""
    from localregneuralde_tpu_torch.ops import cuda

    real = cuda.persistent_chain_sweep

    def sweep(params, chain, knot_ts, knot_us, naccept, saveat_arr, ct_ys,
              ct_y, **kw):
        record.append((int(naccept), int(ct_y.shape[0]),
                       kw.get("two_level_ctx") is not None))
        return real(params, chain, knot_ts, knot_us, naccept, saveat_arr,
                    ct_ys, ct_y, **kw)

    cuda.persistent_chain_sweep = sweep
    return lambda: setattr(cuda, "persistent_chain_sweep", real)


def _k_step(make_multi, setup, batches, w, lr, dp):
    from localregneuralde_tpu_torch.parallel import shard_batch

    model, loss_fn, opt, ts, _ = setup
    multi = make_multi(model, loss_fn, opt, dp, reduce_fn=lambda loss, stats,
                       d: {"row": torch.stack([loss, stats["reg_val"]])})
    stack = tuple(torch.stack(s) for s in zip(
        *[shard_batch(b, dp) for b in batches]))
    ws = (tuple(np.full(2, v, np.float32) for v in w)
          if isinstance(w, tuple) else np.full(2, w, np.float32))
    ts, loss, red = multi(ts, stack, ws, np.full(2, lr, np.float32))
    return dict(params=host(ts.params), loss=host(loss), red=host(red["row"]),
                captured=multi.captured)


def job_latent(inp, dp):
    """The latent ODE on the global grid with the port's own draws (one
    step at use_pallas 'off' and 'on', gradient accumulation 2, a K = 2
    call) and with JAX's t1 and ε injected (one step, 'off')."""
    from localregneuralde_tpu_torch.models import common, neural_ode
    from localregneuralde_tpu_torch.parallel import (
        make_sharded_multi_train_step, make_sharded_train_step, shard_batch,
    )

    out, lat = {}, inp["latent"]
    params, tgrid = lat["params"], lat["tgrid"]
    for up in ("off", "on"):
        counts, rows = {}, []
        restore = counting_wrappers(("persistent_chain_solve",
                                     "persistent_chain_sweep"), counts, rows)
        try:
            model, loss_fn, opt, ts, w = latent_setup(params, up, tgrid)
            step = make_sharded_train_step(model, loss_fn, opt, dp)
            out[f"step_{up}"] = step_out(*step(
                ts, shard_batch(lat["batch"], dp), w, LR))
        finally:
            restore()
        out[f"step_{up}"].update(calls=counts, solve_rows=rows)
    sweeps = []
    restore = spying_sweep(sweeps)
    try:
        model, loss_fn, opt, ts, w = latent_setup(params, "on", tgrid,
                                                  TWO_LEVEL)
        step = make_sharded_train_step(model, loss_fn, opt, dp)
        out["two_level"] = step_out(*step(
            ts, shard_batch(lat["batch"], dp), w, LR))
    finally:
        restore()
    out["two_level"]["sweeps"] = sweeps
    model, loss_fn, opt, ts, w = latent_setup(params, tgrid=tgrid)
    step = make_sharded_train_step(model, loss_fn, opt, dp,
                                   grad_accumulation=2)
    out["ga"] = step_out(*step(ts, shard_batch(lat["batch"], dp, n_micro=2),
                               w, LR))
    setup = latent_setup(params, tgrid=tgrid)
    out["kstep"] = _k_step(make_sharded_multi_train_step, setup,
                           lat["batches"], setup[4], K_LR["latent"], dp)

    real = neural_ode.sample_t1, common.reparam_noise
    neural_ode.sample_t1 = lambda g, t0, t2: lat["jax_t1"]
    common.reparam_noise = lambda g, shape, like: torch.tensor(
        lat["jax_eps"])
    try:
        model, loss_fn, opt, ts, w = latent_setup(lat["jax_params"],
                                                  tgrid=tgrid)
        step = make_sharded_train_step(model, loss_fn, opt, dp)
        out["jax"] = step_out(*step(ts, shard_batch(lat["batch"], dp), w,
                                    LR))
    finally:
        neural_ode.sample_t1, common.reparam_noise = real
    return out


def job_sde(inp, dp):
    """The MNIST SDE on the global grid with the port's own draws (one
    step at use_pallas 'off' and 'on', recording each solve's tree normals;
    gradient accumulation 2, recording them; a K = 2 call) and with JAX's
    tree, t1 and regulariser normals injected (one step, 'off')."""
    from localregneuralde_tpu_torch.models import neural_sde
    from localregneuralde_tpu_torch.parallel import (
        make_sharded_multi_train_step, make_sharded_train_step, shard_batch,
    )

    out, sde = {}, inp["sde"]
    real = (neural_sde.noise_source, neural_sde.sample_t1,
            neural_sde.sample_reg_noise)
    try:
        for up in ("off", "on"):
            rec, counts, rows = [], {}, []
            neural_sde.noise_source = recording_noise(real[0], rec)
            restore = counting_wrappers(("persistent_sde_solve",
                                         "persistent_sde_sweep"), counts,
                                        rows)
            try:
                model, loss_fn, opt, ts, w = sde_setup(sde["params"], up)
                step = make_sharded_train_step(model, loss_fn, opt, dp)
                out[f"step_{up}"] = step_out(*step(
                    ts, shard_batch(sde["batch"], dp), w, LR))
            finally:
                restore()
            out[f"step_{up}"].update(noise=rec, calls=counts,
                                     solve_rows=rows)
        rec = []
        neural_sde.noise_source = recording_noise(real[0], rec)
        model, loss_fn, opt, ts, w = sde_setup(sde["params"])
        step = make_sharded_train_step(model, loss_fn, opt, dp,
                                       grad_accumulation=2)
        out["ga"] = step_out(*step(
            ts, shard_batch(sde["batch"], dp, n_micro=2), w, LR))
        out["ga"]["noise"] = rec
        neural_sde.noise_source = real[0]
        setup = sde_setup(sde["params"])
        out["kstep"] = _k_step(make_sharded_multi_train_step, setup,
                               sde["batches"], setup[4], K_LR["sde"], dp)

        neural_sde.noise_source = jax_tree_noise(
            sde["jax_noise_key"], (B, sde["features"]))
        neural_sde.sample_t1 = lambda g, a, b: sde["jax_t1"]
        neural_sde.sample_reg_noise = lambda g, shape: torch.tensor(
            sde["jax_reg_noise"])
        model, loss_fn, opt, ts, w = sde_setup(sde["params"])
        step = make_sharded_train_step(model, loss_fn, opt, dp)
        out["jax"] = step_out(*step(ts, shard_batch(sde["batch"], dp), w,
                                    LR))
    finally:
        (neural_sde.noise_source, neural_sde.sample_t1,
         neural_sde.sample_reg_noise) = real
    return out


def main(argv):
    in_file, out_dir, rank, world, port = argv
    from localregneuralde_tpu_torch.parallel import make_dp_group, multihost

    torch.set_num_threads(1)
    multihost.initialize(rank=int(rank), world_size=int(world),
                         master_port=int(port), backend="gloo")
    dp = make_dp_group()
    with open(in_file, "rb") as f:
        inp = pickle.load(f)
    out = {name: fn(inp, dp) for name, fn in (("latent", job_latent),
                                              ("sde", job_sde))}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
