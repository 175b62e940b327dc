"""The rounding floor under the tolerances of
``tests/test_torch_parallel_families.py`` and
``tests/test_torch_parallel_conv.py`` (the global grid of the chain, SDE
and conv families on the CPU).

    python tests/dp_tolerance_probe.py

prints two tables, each number the largest over its cases:

- **spread**: the single-device step's own change under a 1e-7 relative
  change of the data (``N_DRAWS`` draws of a sign per element), at the
  test's settings and at the ones it avoids: ``reg_val`` and the loss as
  |Δ| / |value|, the SGD updates as max-abs Δ over the largest update.
  Two summation orders of the solve's norms are a change of this size, so
  a tolerance below the spread cannot hold;
- **parted**: the two-rank global grid's distance from the single-device
  step (and from JAX's sharded step) in the same measures, at each
  comparison the tests make.

``spread`` is also what ``test_rounding_floor_of_the_tolerances`` and
``test_rounding_floor_of_the_conv_tolerances`` check. ``--conv`` prints
the conv family's rows only.
"""
from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from tests import torch_dp_families_worker as W  # noqa: E402

N_DRAWS = 4
REL = 1e-7
# (label, family, train state's key, generative weights' factor,
# overrides, use_pallas, JAX's draws): the tests' settings, and the latent
# ones they avoid
SETTINGS = (
    ("latent key 0, own draws", "latent", 0, 2.0, (), "off", False),
    ("latent key 0, JAX's draws", "latent", 0, 2.0, (), "off", True),
    ("latent key 10, JAX's draws", "latent", 10, 2.0, (), "off", True),
    ("latent rtol 1e-3, weights x3", "latent", 0, 3.0,
     ("--model.solver.reltol=1e-3", "--model.solver.abstol=1e-3"), "off",
     False),
    ("sde, eager route", "sde", 0, None, (), "off", False),
    ("sde, kernel route", "sde", 0, None, (), "on", False),
)
# the CIFAR model of tests/test_torch_parallel_conv.py (its dynamics'
# weights tripled), by route and regulariser: (label, use_pallas,
# regularize)
CONV_SETTINGS = tuple(
    (f"cifar {up}, {reg}", up, reg)
    for up in ("on", "off") for reg in ("none", "unbiased"))
CONV_LABELS = tuple(s[0] for s in CONV_SETTINGS)


def _measures(step, ref):
    """(reg_val, loss, updates) of ``step`` against ``ref``, each a
    ``(params, loss, stats, p0)`` of ``_step``."""
    p, loss, stats, p0 = step
    rp, rloss, rstats, _ = ref
    reg = float(stats["reg_val"])
    rreg = float(rstats["reg_val"])
    upd = {k: (np.asarray(p[k]) - p0[k]) for k in p}
    rupd = {k: (np.asarray(rp[k]) - p0[k]) for k in rp}
    scale = max(float(np.abs(v).max()) for v in rupd.values())
    return (abs(reg - rreg) / max(abs(rreg), 1e-30),
            abs(float(loss) - float(rloss)) / abs(float(rloss)),
            max(float(np.abs(upd[k] - rupd[k]).max()) for k in rupd) / scale)


def _step(family, params, use_pallas, extra, batch, tgrid=None):
    from localregneuralde_tpu_torch.harness import make_train_step

    if family == "latent":
        model, loss_fn, opt, ts, w = W.latent_setup(params, use_pallas,
                                                    tgrid, extra)
    else:
        model, loss_fn, opt, ts, w = W.sde_setup(params, use_pallas)
    p0 = W.host(ts.params)
    ts2, loss, stats = make_train_step(model, loss_fn, opt)(ts, batch, w,
                                                            W.LR)
    return W.host(ts2.params), float(loss), W.host(stats), p0


def _worst(step, batch):
    """The largest (reg_val, loss, updates) change of ``step(batch)`` under
    ``N_DRAWS`` 1e-7 relative changes of ``batch[0]``."""
    ref = step(batch)
    rng = np.random.RandomState(0)
    worst = np.zeros(3)
    for _ in range(N_DRAWS):
        sign = torch.from_numpy(rng.choice(
            [-1.0, 1.0], batch[0].shape).astype(np.float32))
        moved = (batch[0] * (1 + REL * sign),) + tuple(batch[1:])
        worst = np.maximum(worst, _measures(step(moved), ref))
    return worst


def _conv_step(params, use_pallas, regularize, batch):
    from localregneuralde_tpu_torch.harness import make_train_step
    from tests import torch_dp_conv_worker as CW

    model, loss_fn, opt, ts, w = CW.cifar_setup(params, use_pallas,
                                                regularize)
    p0 = CW.host(ts.params)
    ts2, loss, stats = make_train_step(model, loss_fn, opt)(ts, batch, w,
                                                            CW.LR)
    return CW.host(ts2.params), float(loss), CW.host(stats), p0


def spread(label):
    """The largest (reg_val, loss, updates) change of the single-device
    step under ``N_DRAWS`` 1e-7 relative changes of the data, at the
    setting ``label`` of ``SETTINGS`` or ``CONV_SETTINGS``."""
    if label in CONV_LABELS:
        import test_torch_parallel_conv as C

        _, up, reg = next(s for s in CONV_SETTINGS if s[0] == label)
        params = C._jax_side()["params"]
        batch = tuple(torch.from_numpy(a) for a in C._batch(7))
        return _worst(lambda b: _conv_step(params, up, reg, b), batch)
    import test_torch_parallel_families as T

    from localregneuralde_tpu_torch.models import common, neural_ode

    _, family, key, scale, extra, up, jax_draws = next(
        s for s in SETTINGS if s[0] == label)
    side = (T._jax_latent(key, scale, extra) if family == "latent"
            else T._jax_sde())
    params, tgrid = side["params"], side.get("tgrid")
    batch = tuple(torch.from_numpy(np.asarray(a)) for a in side["batch"])
    real = neural_ode.sample_t1, common.reparam_noise
    if jax_draws:  # JAX's t1 and ε, as the tests inject them
        neural_ode.sample_t1 = lambda g, t0, t2: side["t1"]
        common.reparam_noise = lambda g, shape, like: torch.tensor(
            side["eps"])
    try:
        worst = _worst(lambda b: _step(family, params, up, extra, b, tgrid),
                       batch)
    finally:
        neural_ode.sample_t1, common.reparam_noise = real
    return worst


def parted(fam):
    """The global grid's (reg_val, loss, updates) distance from the
    single-device step at each comparison of the tests, on ``fam``'s
    ranks (``test_torch_parallel_families.rank_results``), by label."""
    import test_torch_parallel_families as T
    from localregneuralde_tpu_torch.harness import (
        make_multi_train_step, make_train_step,
    )
    from localregneuralde_tpu_torch.parity import latent_tree, params_from_jax

    inp, out = fam["inp"], {}
    for family in T.FAMILIES:
        cases = [("step_off", {}, "off", ()), ("step_on", {}, "on", ()),
                 ("ga", {"grad_accumulation": 2}, "off", ())]
        if family == "latent":
            cases.append(("two_level", {}, "on", W.TWO_LEVEL))
        for key, kw, up, extra in cases:
            if family == "latent":
                model, loss_fn, opt, ts, w = W.latent_setup(
                    inp["latent"]["params"], up, inp["latent"]["tgrid"],
                    extra)
            else:
                model, loss_fn, opt, ts, w = W.sde_setup(
                    inp["sde"]["params"], up)
            p0 = W.host(ts.params)
            ts2, loss, stats = make_train_step(model, loss_fn, opt, **kw)(
                ts, inp[family]["batch"], w, W.LR)
            ref = (W.host(ts2.params), float(loss), W.host(stats), p0)
            out[f"{family} {key}"] = np.max([_measures(
                (r[family][key]["params"], r[family][key]["loss"],
                 r[family][key]["stats"], p0), ref)
                for r in fam["ranks"]], axis=0)
        model, loss_fn, opt, ts, w = T._setup(family, inp)
        multi = make_multi_train_step(
            model, loss_fn, opt, reduce_fn=lambda loss, stats, d: {
                "row": torch.stack([loss, stats["reg_val"]])})
        stack = tuple(torch.stack(s) for s in zip(*inp[family]["batches"]))
        ws = (tuple(np.full(2, v, np.float32) for v in w)
              if isinstance(w, tuple) else np.full(2, w, np.float32))
        p0 = W.host(ts.params)
        ts2, loss, red = multi(ts, stack, ws,
                               np.full(2, W.K_LR[family], np.float32))
        ref = (W.host(ts2.params), float(loss),
               {"reg_val": float(red["row"][1])}, p0)
        out[f"{family} kstep"] = np.max([_measures(
            (r[family]["kstep"]["params"], r[family]["kstep"]["loss"],
             {"reg_val": r[family]["kstep"]["red"][1]}, p0), ref)
            for r in fam["ranks"]], axis=0)
        side = fam["jax"][family]
        _, w_sched = T.jax_construct_loss(side["cfg"])
        if family == "latent":
            new, jl, jstats = T._jax_sharded(
                side, (float(w_sched[0](1)), 0.5), T.JAX_LATENT_KEY)
            ours = params_from_jax(latent_tree(new))
            p0 = params_from_jax(latent_tree(side["params"]))
        else:
            new, jl, jstats = T._jax_sharded(side, float(w_sched(1)), 0)
            ours, p0 = params_from_jax(new), params_from_jax(side["params"])
        p0 = {k: v.numpy() for k, v in p0.items()}
        ref = ({k: v.numpy() for k, v in ours.items()}, float(jl),
               {"reg_val": float(jstats["reg_val"])}, p0)
        out[f"{family} jax"] = np.max([_measures(
            (r[family]["jax"]["params"], r[family]["jax"]["loss"],
             r[family]["jax"]["stats"], p0), ref) for r in fam["ranks"]],
            axis=0)
    return out


def parted_conv(conv):
    """The conv family's global grid's (reg_val, loss, updates) distance
    from the single-device step at each of its tests' comparisons, on
    ``conv``'s ranks (``test_torch_parallel_conv.conv``), by label."""
    import test_torch_parallel_conv as C

    inp, out = conv["inp"], {}
    for up in ("on", "off"):
        for reg in ("none", "unbiased"):
            key = f"step_{up}_{reg}"
            params, loss, stats, _, p0 = C._single(inp, up, reg)
            ref = (params, float(loss), W.host(stats), p0)
            out[f"cifar {key}"] = np.max([_measures(
                (r["steps"][key]["params"], r["steps"][key]["loss"],
                 r["steps"][key]["stats"], p0), ref)
                for r in conv["ranks"]], axis=0)
    return out


def _row(label, m):
    return f"| {label} | {m[0]:.3e} | {m[1]:.3e} | {m[2]:.3e} |"


def main():
    import jax

    # the tests' CPU mesh (tests/conftest.py): JAX's sharded step takes two
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    import test_torch_parallel_families as T

    torch.set_num_threads(1)
    conv_only = "--conv" in sys.argv[1:]
    head = "| case | reg_val | loss | updates |\n|---|---|---|---|"
    print(f"spread: the single device under a {REL:g} relative change of "
          f"the data ({N_DRAWS} draws)")
    print(head)
    for label in ((() if conv_only else tuple(s[0] for s in SETTINGS))
                  + CONV_LABELS):
        print(_row(label, spread(label)))
    print("parted: the two-rank global grid against the single device "
          "(and JAX's sharded step)")
    print(head)
    with tempfile.TemporaryDirectory() as d:
        import test_torch_parallel_conv as C

        for sub in ("fam", "conv"):
            (Path(d) / sub).mkdir()
        rows = {} if conv_only else parted(T.rank_results(Path(d) / "fam"))
        rows.update(parted_conv(C.conv.__wrapped__(_Dir(Path(d) / "conv"))))
    for label, m in rows.items():
        print(_row(label, m))


class _Dir:
    """A ``tmp_path_factory`` that makes every directory at ``path``."""

    def __init__(self, path):
        self.path = path

    def mktemp(self, name):
        return self.path


if __name__ == "__main__":
    main()
