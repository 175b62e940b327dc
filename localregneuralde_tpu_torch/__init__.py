"""localregneuralde_tpu_torch — the PyTorch and CUDA port of
``localregneuralde_tpu`` for NVIDIA Hopper GPUs.

It mirrors the JAX package's layout and names (``ode/``, ``nn/``,
``models/``, ``ops/``, ``harness/``) and keeps its public shapes: states are
batch-major ``(B, F)``, a Dense weight is ``(in, out)``, and the time channel
is the last input row. The JAX package is the reference the port is tested
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

from .core import ArrayAndTime, get_array  # noqa: E402
from .models import NeuralODE, TDChain, diffeqsol_to_array  # noqa: E402
from .ode import ODESolution, PIController, odesolve  # noqa: E402

__version__ = "0.1.0"

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
