"""Median ms a call and device kernels a call of the PyTorch port's serving
paths on one CUDA card, each through its entry point with random weights
from a seed: the MNIST MLP Neural ODE classifier
(``experiments/mnist_ode/mlp.yaml``, B = 512) at its rtol 1.4e-8 (kernel 4,
FP32) and at rtol 1e-4 (``'auto'``: kernel 4 at TF32), the MNIST Neural SDE
(``experiments/mnist_sde/mlp.yaml``, kernel 10) on synthetic images, and a
probability-flow draw of the score demo's network (4096 x 2, kernel 6).

    python scripts/serving_calls_torch.py [--tree DIR] [--label NAME] [--out F]

``--tree`` imports the port from another checkout (DIR holds its
``localregneuralde_tpu_torch``), so that two commits are timed by the same
code on the same card: run them in turns (A, B, B, A) in one session.
Prints one JSON line: for each path the median ms a call between CUDA
events (20 calls after 3 warm-ups), the device kernels of one call under
``torch.profiler`` by name, and their total; ``--out`` also writes it to F.
"""
import argparse
import collections
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCH = ["--model.solver.reltol=1e-4", "--model.solver.abstol=1e-4",
         "--model.solver.max_steps=64"]


def median_ms(fn, n=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernels_of(fn):
    """The device kernels of one call of ``fn`` by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return dict(collections.Counter(
        e.name.split("(")[0] for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="the checkout whose port is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.tree))
    import torch

    if not torch.cuda.is_available():
        sys.exit("serving_calls_torch.py needs a CUDA card")
    from localregneuralde_tpu_torch.harness import (
        construct_model, define_configuration, synthetic_classification,
    )
    from localregneuralde_tpu_torch.models import (
        TDChain, sample_probability_flow,
    )
    from localregneuralde_tpu_torch.nn import Dense

    dev = torch.device("cuda", 0)
    x = torch.tensor(synthetic_classification((28, 28), 1, 10, seed=0)[2][
        :512], device=dev)
    calls = {}
    for name, config, overrides in (
            ("ode mlp.yaml", "mnist_ode", []),
            ("ode bench", "mnist_ode", BENCH),
            ("sde mlp.yaml", "mnist_sde", [])):
        model = construct_model(define_configuration(
            overrides, os.path.join(ROOT, "experiments", config, "mlp.yaml")),
            device=dev)
        state = model.init_state()
        calls[name] = (lambda m=model, s=state: m(x, s, training=False))
    g = torch.Generator().manual_seed(0)
    net = TDChain(Dense(3, 64, "tanh", generator=g, device=dev),
                  Dense(65, 64, "tanh", generator=g, device=dev),
                  Dense(65, 2, generator=g, device=dev))
    calls["pf draw"] = lambda: sample_probability_flow(
        None, (4096, 2), torch.Generator().manual_seed(5), score_module=net,
        max_steps=4096, device=dev)

    res = {"label": a.label, "tree": os.path.abspath(a.tree),
           "card": torch.cuda.get_device_name(0)}
    with torch.no_grad():
        for name, fn in calls.items():
            fn()  # first-call set-up (the kernels' build, cuBLAS)
            ms = median_ms(fn)
            names = kernels_of(fn)
            res[name] = dict(ms=ms, kernels=sum(names.values()),
                             by_name=names)
    line = json.dumps(res)
    print(line)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
