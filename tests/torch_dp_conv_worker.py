"""One rank of the global grid's checks for the CIFAR-10 conv family on the
CPU (Gloo).

``python tests/torch_dp_conv_worker.py IN_FILE OUT_DIR RANK WORLD PORT``
joins a Gloo group of WORLD ranks on 127.0.0.1:PORT, runs every job below
on the inputs pickled in IN_FILE (the JAX-layout parameters, the batches,
JAX's t1 and the BatchNorm check's inputs that
``tests/test_torch_parallel_conv.py`` made) and pickles each job's results
to ``OUT_DIR/rank{RANK}.pkl``. It imports the port only, never JAX. The
setup functions are shared with the tests.
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

CONFIG = os.path.join(ROOT, "experiments", "cifar10", "cnn.yaml")
# tests/test_torch_cifar.py's whole-model settings at 'highest' (the CPU
# computes every tier in FP32): 8×8 images, rtol 1e-2, SGD
ARGS = ["--model.solver.reltol=1e-2", "--model.solver.abstol=1e-2",
        "--model.solver.max_steps=32", "--model.solver.precision=highest",
        "--optimizer.optimizer=sgd", "--optimizer.learning_rate=0.1"]
B, LR = 8, 0.1
# the tests' scale of the JAX initial dynamics weights: the regulariser's
# error estimate then stands above its float32 rounding noise
DYNAMICS_SCALE = 3.0
ROUTES = ("on", "off")
REGULARIZE = ("none", "unbiased")


def cifar_cfg(define, extra=()):
    cfg = define(ARGS + list(extra), CONFIG)
    cfg.model.image_size = [8, 8]
    return cfg


def cifar_setup(params, use_pallas="on", regularize="unbiased", extra=()):
    """The port's CIFAR model at 8×8 images with the given (JAX-layout)
    parameters: ``(model, loss_fn, opt, ts, w_reg)``."""
    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, construct_optimizer,
        create_train_state, define_configuration,
    )
    from localregneuralde_tpu_torch.parity import cifar_tree, load_jax_params

    cfg = cifar_cfg(define_configuration, [
        f"--model.use_pallas={use_pallas}",
        f"--model.regularize={regularize}", *extra])
    model = construct_model(cfg, device="cpu")
    load_jax_params(model, cifar_tree(params))
    loss_fn, w_reg = construct_loss(cfg)
    opt, _ = construct_optimizer(cfg)
    return model, loss_fn, opt, create_train_state(model, opt), w_reg(1)


def step_out(ts, loss, stats):
    return dict(params=host(ts.params), loss=host(loss),
                stats={k: host(stats[k]) for k in ("nfe", "reg_val")},
                state=host(bn_state(ts.state)))


def bn_state(state):
    """Every BatchNorm running stat of the CIFAR model's state, by path."""
    out = {}

    def walk(st, path):
        if isinstance(st, dict):
            if "mean" in st and "var" in st:
                out[path + ".mean"], out[path + ".var"] = st["mean"], st["var"]
            for k, v in st.items():
                walk(v, f"{path}.{k}" if path else k)

    walk(state, "")
    return out


def counting_steps(calls):
    """Count the plain versions of kernels 13 and 14 that the wrappers run
    on the CPU (``calls[name]``: the rows of each call's state), and put
    the originals back with the function returned."""
    from localregneuralde_tpu_torch.ops.cuda import fused_conv, fused_conv_bwd

    real = [(fused_conv, "conv_step_plain"),
            (fused_conv_bwd, "fused_conv_step_bwd_plain")]
    saved = [(m, n, getattr(m, n)) for m, n in real]

    def counted(name, fn):
        def plain(w, spec, u, *a, **kw):
            calls.setdefault(name, []).append(int(u.shape[0]))
            return fn(w, spec, u, *a, **kw)

        return plain

    for m, n, fn in saved:
        setattr(m, n, counted(n, fn))
    return lambda: [setattr(m, n, fn) for m, n, fn in saved]


def _step(setup, dp, batch, **kw):
    from localregneuralde_tpu_torch.parallel import (
        make_sharded_train_step, shard_batch,
    )

    model, loss_fn, opt, ts, w = setup
    n_micro = kw.get("grad_accumulation", 1)
    step = make_sharded_train_step(model, loss_fn, opt, dp, **kw)
    return step_out(*step(ts, shard_batch(batch, dp, n_micro=n_micro), w,
                          LR))


def job_steps(inp, dp):
    """One global-grid step for each route and regulariser, counting the
    conv kernels' calls; the direct adjoint on both routes; gradient
    accumulation 2 and a K = 2 call; a sharded eval step on each route;
    one step with JAX's t1 injected."""
    from localregneuralde_tpu_torch.models import neural_ode
    from localregneuralde_tpu_torch.parallel import (
        make_sharded_eval_step, make_sharded_multi_train_step, shard_batch,
    )

    out, params, batch = {}, inp["params"], inp["batch"]
    for up in ROUTES:
        for reg in REGULARIZE:
            calls = {}
            restore = counting_steps(calls)
            try:
                got = _step(cifar_setup(params, up, reg), dp, batch)
            finally:
                restore()
            out[f"step_{up}_{reg}"] = dict(got, calls=calls)
        out[f"direct_{up}"] = _step(cifar_setup(
            params, up, extra=["--model.solver.adjoint=direct"]), dp, batch)
        model, loss_fn, _, ts, w = cifar_setup(params, up)
        loss, stats = make_sharded_eval_step(model, loss_fn, dp)(
            ts, shard_batch(batch, dp), w)
        out[f"eval_{up}"] = dict(loss=host(loss), nfe=host(stats["nfe"]),
                                 y_pred=host(stats["y_pred"]))
    out["ga"] = _step(cifar_setup(params), dp, batch, grad_accumulation=2)

    model, loss_fn, opt, ts, w = cifar_setup(params)
    multi = make_sharded_multi_train_step(
        model, loss_fn, opt, dp, reduce_fn=lambda loss, stats, d: {
            "row": torch.stack([loss, stats["reg_val"]])})
    stack = tuple(torch.stack(s) for s in zip(
        *[shard_batch(b, dp) for b in inp["batches"]]))
    ts2, loss, red = multi(ts, stack, np.full(2, w, np.float32),
                           np.full(2, LR, np.float32))
    out["kstep"] = dict(params=host(ts2.params), loss=host(loss),
                        red=host(red["row"]), captured=multi.captured,
                        state=host(bn_state(ts2.state)))

    real = neural_ode.sample_t1
    neural_ode.sample_t1 = lambda g, t0, t2: inp["jax_t1"]
    try:
        for reg in REGULARIZE:
            out[f"jax_{reg}"] = _step(cifar_setup(params, "on", reg), dp,
                                      batch)
    finally:
        neural_ode.sample_t1 = real
    return out


def job_batchnorm(inp, dp):
    """A BatchNorm in training mode with the group in its state, on this
    rank's rows of ``inp["bn_x"]``: the output, the new running stats and
    the gradients of Σ y·c (c this rank's rows of ``inp["bn_ct"]``) with
    respect to its input, scale and bias."""
    from localregneuralde_tpu_torch.nn import BatchNorm
    from localregneuralde_tpu_torch.nn.basic import GROUP
    from localregneuralde_tpu_torch.parallel import DPGroup, shard_batch

    x, ct = shard_batch((inp["bn_x"], inp["bn_ct"]), dp)
    bn = BatchNorm(x.shape[-1], "gelu")
    with torch.no_grad():
        bn.scale.copy_(inp["bn_scale"])
        bn.bias.copy_(inp["bn_bias"])
    x = x.clone().requires_grad_()
    st = dict(bn.init_state(), **{GROUP: dp})
    y, st2 = bn(x, st, training=True)
    gx, gs, gb = torch.autograd.grad((y * ct).sum(), [x, bn.scale, bn.bias])
    # a group of one, this rank's own: bitwise the layer without a group
    ones = [torch.distributed.new_group([r]) for r in range(dp.size)]
    one = DPGroup(group=ones[dp.rank], rank=0, size=1)
    res = []
    for extra in ({}, {GROUP: one}):
        x1 = x.detach().clone().requires_grad_()
        y1, s1 = bn(x1, dict(bn.init_state(), **extra), training=True)
        res.append([y1, s1["mean"], s1["var"], *torch.autograd.grad(
            (y1 * ct).sum(), [x1, bn.scale, bn.bias])])
    return dict(y=host(y), state=host(st2), keys=sorted(st2), d_x=host(gx),
                d_scale=host(gs), d_bias=host(gb),
                one_rank_bitwise=[bool(torch.equal(a, b))
                                  for a, b in zip(*res)])


def main(argv):
    in_file, out_dir, rank, world, port = argv
    from localregneuralde_tpu_torch.parallel import make_dp_group, multihost

    torch.set_num_threads(1)
    multihost.initialize(rank=int(rank), world_size=int(world),
                         master_port=int(port), backend="gloo")
    dp = make_dp_group()
    with open(in_file, "rb") as f:
        inp = pickle.load(f)
    out = {name: fn(inp, dp) for name, fn in (("bn", job_batchnorm),
                                              ("steps", job_steps))}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
