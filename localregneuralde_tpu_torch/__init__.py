"""localregneuralde_tpu_torch — the PyTorch and CUDA port of
``localregneuralde_tpu`` for NVIDIA Hopper GPUs.

It mirrors the JAX package's layout and names (``ode/``, ``nn/``,
``models/``, ``ops/``, ``harness/``, ``utils/``) and keeps its public
shapes: states are batch-major ``(B, F)``, a Dense weight is ``(in, out)``,
and the time channel is the last input row. The JAX package is the reference the port is tested
against; this package never imports JAX.

Ported so far, with hand-written CUDA kernels (``csrc/``) on every path:

- the serving and training paths of the MNIST MLP Neural ODE (the unbiased
  and biased local regulariser, the stored adjoint, the optimizers and the
  train step): the TD-MLP evaluation, the Tsit5 step and its VJP, the
  persistent adaptive solve with knot recording and the reservoir, and the
  dense and two-level adjoint sweeps;
- the MNIST Neural SDE, serving and training: the persistent SRI/SOSRI
  solve with its Brownian tree and the SDE adjoint sweep;
- the PhysioNet latent ODE, training and evaluation through its runner
  (``harness/latent_runner.py``): the persistent solve and the dense and
  two-level sweep of its Dense-chain dynamics;
- the CIFAR-10 conv Neural ODE, serving and training through the
  classification runner (``harness/runner.py``): the conv Tsit5 step and
  its VJP;
- the score-SDE samplers (``models/score_sde.py``): the persistent reverse
  VP-SDE solve and the persistent probability-flow solve of a TDChain score
  network; beside them, on no path, the conv-orientation probe's two conv
  kernels (``ops/cuda/conv_orient.py``).

``utils/`` holds the phase timers and the profiler trace, and the serving
export on ``torch.export``, whose programs record the solves of kernels 4,
10 and 6 as registered operators (``ops/cuda/serving.py``).

The entry points build on the CUDA device unless the caller passes
``device="cpu"``.

Importing the package turns TF32 off for matmuls and cuDNN: the solver's
embedded error estimate is a cancelling sum that TF32 rounding swamps at
tight tolerances. The flags are process-wide, so the solves check them on
CUDA below rtol 1e-4 and raise if a caller turned TF32 on again
(``nn.basic.check_fp32_products``).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

# the top-level names, imported on first use: a serving process that
# imports ``utils/`` to load an artifact imports no model code
# (``models/``)
_LAZY = {
    "ArrayAndTime": "core",
    "get_array": "core",
    "NeuralODE": "models",
    "TDChain": "models",
    "diffeqsol_to_array": "models",
    "ODESolution": "ode",
    "PIController": "ode",
    "odesolve": "ode",
}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        value = getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                        name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ArrayAndTime",
    "NeuralODE",
    "ODESolution",
    "PIController",
    "TDChain",
    "diffeqsol_to_array",
    "get_array",
    "odesolve",
]
