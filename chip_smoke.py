#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It drives the
port's serving path (``localregneuralde_tpu_torch``, no JAX) on the card:

1. builds the CUDA kernels from ``localregneuralde_tpu_torch/csrc`` and
   prints the card's name and power limit;
2. holds each kernel against its plain PyTorch version at the slice's shapes
   (B = 512, F = 784, H = 100) and times both;
3. checks that the persistent solve is deterministic;
4. runs ``experiments/mnist_ode/mlp.yaml`` through ``construct_model`` →
   ``make_eval_step`` on synthetic MNIST batches at the config's tolerance
   and at the bench tolerance, counts the kernel launches of that run, and
   holds the logits against the plain path on the card and on the CPU.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches, error and times. Any failed check
exits non-zero without that line, as does a machine without a CUDA device.
"""
import json
import os
import statistics
import subprocess
import sys
import time

B, F, H = 512, 784, 100
CONFIG = "experiments/mnist_ode/mlp.yaml"
BENCH = ["--model.solver.reltol=1e-4", "--model.solver.abstol=1e-4",
         "--model.solver.max_steps=64"]
TOLERANCES = (("mlp.yaml", []), ("bench", BENCH))
N_BATCHES = 3


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def median_ms(fns, n=30, warmup=3):
    """Median CUDA-event time of each callable, launched in turns."""
    import torch

    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(n):
        for fn, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [statistics.median(ts) for ts in times]


def back_to_back_ms(fns, n=200, warmup=10):
    """Device time per call of each callable: n calls back to back between
    two CUDA events, so the device is never idle as long as the host
    enqueues faster than the device runs. Callables run in turns."""
    import torch

    out = []
    for fn in fns:
        for _ in range(warmup):
            fn()
    for fn in fns + fns[::-1]:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n)
    k = len(fns)
    return [min(out[i], out[2 * k - 1 - i]) for i in range(k)]


def raw_launch(name, *tensors_and_ints):
    """A launch of a C entry with its arguments marshalled once, for timing
    the kernel without the wrapper's per-call Python work."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    args = [_build.ptr(a) if isinstance(a, torch.Tensor) else a
            for a in tensors_and_ints]
    args.append(_build.stream_ptr(torch.device("cuda", 0)))
    fn = getattr(lib, name)
    return lambda: fn(*args)


def max_abs(a, b):
    return float((a - b).abs().max())


def phase_build():
    from localregneuralde_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("[build]", line.strip())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)


def phase_kernels(device):
    """Each kernel against its plain version at the slice's shapes."""
    import torch

    from localregneuralde_tpu_torch.harness import synthetic_classification
    from localregneuralde_tpu_torch.nn import glorot_uniform
    from localregneuralde_tpu_torch.ops.cuda import (
        TDMLPWeights, fused_tdmlp, fused_tsit5_step, persistent_tsit5_solve,
        persistent_tsit5_solve_plain, tdmlp_plain, tsit5_step_plain,
    )

    g = torch.Generator().manual_seed(0)
    w = TDMLPWeights(
        glorot_uniform((F + 1, H), g), 0.1 * torch.randn(H, generator=g),
        glorot_uniform((H + 1, F), g), 0.1 * torch.randn(F, generator=g),
    )
    w = TDMLPWeights(*(t.to(device) for t in w))
    x = torch.tensor(
        synthetic_classification(seed=0)[2][:B].reshape(B, F), device=device
    )
    res = {}

    # kernel 1 — FP32 sums in another order than cuBLAS: expect ≤ 1e-6
    err = max_abs(fused_tdmlp(w, x, 0.3), tdmlp_plain(w, x, 0.3))
    check(err <= 1e-4, f"tdmlp vs plain: max-abs {err}")
    raw = raw_launch("lrnde_tdmlp", x, torch.tensor([0.3], device=device),
                     *w, torch.empty_like(x), B, F, H)
    check(raw() == 0, "tdmlp: raw launch failed")
    ms, plain = back_to_back_ms([raw, lambda: tdmlp_plain(w, x, 0.3)])
    call, = median_ms([lambda: fused_tdmlp(w, x, 0.3)])
    res["tdmlp"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, call_ms=call)

    # kernel 2 — all nine outputs
    t = torch.tensor(0.2, device=device)
    dt = torch.tensor(0.05, device=device)
    k1 = tdmlp_plain(w, x, t)
    err = max(max_abs(a, b) for a, b in zip(
        fused_tsit5_step(w, x, t, dt, k1), tsit5_step_plain(w, x, t, dt, k1)
    ))
    check(err <= 1e-4, f"tsit5_step vs plain: max-abs {err}")
    raw = raw_launch("lrnde_tsit5_step", x, k1, torch.stack([t, dt]), *w,
                     *[torch.empty_like(x) for _ in range(9)], B, F, H)
    check(raw() == 0, "tsit5_step: raw launch failed")
    ms, plain = back_to_back_ms([raw, lambda: tsit5_step_plain(w, x, t, dt, k1)])
    call, = median_ms([lambda: fused_tsit5_step(w, x, t, dt, k1)])
    res["tsit5_step"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             call_ms=call)

    # kernel 4 — the whole solve against the eager loop with the plain step
    saveat = torch.tensor([0.5, 1.0], device=device)
    for name, overrides in TOLERANCES:
        tol = 1e-4 if overrides else 1.4e-8
        kw = dict(rtol=tol, atol=tol, saveat_arr=saveat,
                  max_steps=64 if overrides else 10000)
        out = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
        ref = persistent_tsit5_solve_plain(w, x, (0.0, 1.0), **kw)
        err = max_abs(out["ys"], ref["ys"])
        na, nb = int(out["naccept"]), int(ref["naccept"])
        fa, fb = int(out["nfe"]), int(ref["nfe"])
        print(f"[solve {name}] kernel naccept {na} nfe {fa} | loop naccept "
              f"{nb} nfe {fb} | ys max-abs {err:.3e}")
        check(bool(out["success"]) and bool(ref["success"]),
              f"persistent solve {name}: not successful")
        if overrides:
            # rtol 1e-4: the two agree step for step up to an ulp-level
            # accept flip in the cancelling error sum (measured on an H100:
            # 4 accepts and NFE 26 both, ys max-abs 1.4e-6)
            check(err <= 2e-4 and abs(na - nb) <= 1 and abs(fa - fb) <= 12,
                  f"persistent solve {name} disagrees with the loop")
        else:
            # rtol 1.4e-8 is below the f32 rounding noise of ũ: a float64
            # step at the same point has a ~50x smaller eest, so each
            # implementation's step count follows the accuracy of its sums.
            # Measured on an H100 80GB HBM3 (700 W): kernel 25 accepts, loop
            # 28, both without rejects, ys max-abs 1.1e-6; summation variants
            # of the kernel gave 25-33 accepts against the loop's 28.
            check(err <= 1e-5 and 0.75 <= na / nb <= 1.34,
                  f"persistent solve {name} disagrees with the loop")
        ms, plain = median_ms(
            [lambda: persistent_tsit5_solve(w, x, (0.0, 1.0), **kw),
             lambda: persistent_tsit5_solve_plain(w, x, (0.0, 1.0), **kw)],
            n=10, warmup=1,
        )
        print(f"[solve {name}] kernel {ms:.3f} ms, loop {plain:.3f} ms")
        if overrides:
            res["persistent_tsit5_solve"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, call_ms=ms
            )
    for name, r in res.items():
        print(f"[kernel {name}] max-abs {r['max_abs_err']:.3e} | device "
              f"time per launch {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
              f" | one wrapper call {r.pop('call_ms'):.4f} ms")
    return w, x, res


def phase_determinism(w, x):
    from localregneuralde_tpu_torch.ops.cuda import persistent_tsit5_solve

    import torch

    for name, overrides in TOLERANCES:
        tol = 1e-4 if overrides else 1.4e-8
        kw = dict(rtol=tol, atol=tol, max_steps=64 if overrides else 10000,
                  saveat_arr=torch.tensor([1.0], device=x.device))
        a = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
        b = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
        check(torch.equal(a["y_final"], b["y_final"])
              and int(a["nfe"]) == int(b["nfe"]),
              f"persistent solve {name} is not deterministic")
        print(f"[determinism {name}] bitwise-equal y_final, nfe {int(a['nfe'])}")


def _slice_model(overrides, device, params=None):
    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, create_train_state,
        define_configuration, make_eval_step,
    )

    cfg = define_configuration(overrides, CONFIG)
    model = construct_model(cfg, device=device)
    if params is not None:
        model.load_state_dict(params)
    loss_fn, w_reg = construct_loss(cfg)
    return model, make_eval_step(model, loss_fn), create_train_state(model), w_reg(1)


def phase_slice(device):
    """The serving path at both tolerances, with launch counts."""
    import torch

    from localregneuralde_tpu_torch.harness import (
        accuracy, one_hot, synthetic_classification,
    )
    from localregneuralde_tpu_torch.ops.cuda import (
        launch_counts, reset_launch_counts,
    )

    _, _, x_test, y_test = synthetic_classification((28, 28), 1, 10, seed=0)
    batches = [
        (torch.tensor(x_test[i * B:(i + 1) * B], device=device),
         torch.tensor(one_hot(y_test[i * B:(i + 1) * B], 10), device=device))
        for i in range(N_BATCHES)
    ]
    runs = []
    for name, overrides in TOLERANCES:
        model, step, ts, w_reg = _slice_model(overrides, device)
        loop_model, loop_step, loop_ts, _ = _slice_model(
            overrides + ["--model.solver.use_persistent=false"], device,
            model.state_dict(),
        )
        runs.append((name, overrides, model, step, ts, w_reg, batches))
        runs.append((name + " loop", overrides, loop_model, loop_step,
                     loop_ts, w_reg, batches[:1]))
    for step, ts, w_reg in [(r[3], r[4], r[5]) for r in runs]:
        step(ts, batches[0], w_reg)  # first-call set-up (cuBLAS, allocator)
    torch.cuda.synchronize()

    # --- the main path: every launch from here to launch_counts() counts
    reset_launch_counts()
    results = []
    for name, overrides, model, step, ts, w_reg, bs in runs:
        for i, (x, y) in enumerate(bs):
            t0 = time.perf_counter()
            loss, stats = step(ts, (x, y), w_reg)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            results.append((name, i, loss, stats, ms))
    counts = launch_counts()

    n_persistent = sum(len(r[6]) for r in runs if not r[0].endswith("loop"))
    n_loop = sum(len(r[6]) for r in runs if r[0].endswith("loop"))
    loop_attempts = 0
    for name, i, loss, stats, ms in results:
        nfe = int(stats["nfe"])
        ok = bool(stats["solver_success"])
        top1 = float(accuracy(stats["y_pred"], batches[i][1]))
        print(f"[slice {name}] batch {i}: loss {float(loss):.6f} top-1 "
              f"{top1:.2f}% nfe {nfe} success {ok} {ms:.3f} ms "
              f"{B / (ms / 1e3):.1f} images/s")
        check(ok and bool(torch.isfinite(loss))
              and tuple(stats["y_pred"].shape) == (B, 10)
              and bool(torch.isfinite(stats["y_pred"]).all()),
              f"slice {name} batch {i}: bad output")
        if name.endswith("loop"):
            loop_attempts += (nfe - 2) // 6
    print(f"[slice] launch counts {counts}")
    check(counts["persistent_tsit5_solve"] == n_persistent,
          "the persistent kernel did not run once per batch")
    check(counts["tdmlp"] == 2 * (n_persistent + n_loop),
          "the tdmlp kernel did not run twice per batch")
    check(counts["tsit5_step"] == loop_attempts,
          "the step kernel did not run once per loop attempt")

    # --- the same batches on the plain path, on the card and on the CPU
    for (name, overrides, model, step, ts, w_reg, bs) in runs:
        if name.endswith("loop"):
            continue
        plain = _slice_model(overrides + ["--model.use_pallas=off"], device,
                             model.state_dict())
        for i, (x, y) in enumerate(bs):
            _, ref = plain[1](plain[2], (x, y), w_reg)
            ours = next(r[3] for r in results if r[0] == name and r[1] == i)
            err = max_abs(ours["y_pred"], ref["y_pred"])
            print(f"[slice {name}] batch {i}: logits vs plain path max-abs "
                  f"{err:.3e}, nfe {int(ours['nfe'])} vs {int(ref['nfe'])}")
            check(err <= 1e-4, f"slice {name}: logits disagree with plain")
        # a small batch: the card's kernel path against the CPU
        cpu = _slice_model(overrides, "cpu",
                           {k: v.cpu() for k, v in model.state_dict().items()})
        xs, ys = bs[0][0][:8], bs[0][1][:8]
        _, on_card = step(ts, (xs, ys), w_reg)
        _, on_cpu = cpu[1](cpu[2], (xs.cpu(), ys.cpu()), w_reg)
        err = max_abs(on_card["y_pred"].cpu(), on_cpu["y_pred"])
        print(f"[slice {name}] 8 images, card kernels vs CPU plain: "
              f"logits max-abs {err:.3e}")
        check(err <= 1e-4, f"slice {name}: card disagrees with the CPU")
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    phase_build()
    w, x, res = phase_kernels(device)
    phase_determinism(w, x)
    counts = phase_slice(device)

    sources = {
        "tdmlp": ("localregneuralde_tpu_torch/csrc/tdmlp.cu",
                  "localregneuralde_tpu/ops/pallas/fused_mlp.py:60"),
        "tsit5_step": ("localregneuralde_tpu_torch/csrc/tsit5_step.cu",
                       "localregneuralde_tpu/ops/pallas/fused_mlp.py:69"),
        "persistent_tsit5_solve": (
            "localregneuralde_tpu_torch/csrc/persistent_solve.cu",
            "localregneuralde_tpu/ops/pallas/fused_solve.py:285"),
    }
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=counts[name], **res[name])
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
