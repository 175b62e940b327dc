"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without an NVIDIA GPU (a CUDA kernel has no CPU
mode). This file imports no JAX, so it runs on a machine with only the
port's dependencies; ``--noconftest`` skips the suite's JAX set-up:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from localregneuralde_tpu_torch.ops.cuda import (
    TDMLPWeights,
    fused_tdmlp,
    fused_tsit5_step,
    persistent_tsit5_solve,
    persistent_tsit5_solve_plain,
    tdmlp_plain,
    tsit5_step_plain,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _card_setup(device, batch, features, hidden, seed=0):
    from localregneuralde_tpu_torch.nn import glorot_uniform

    g = torch.Generator().manual_seed(seed)
    w = TDMLPWeights(
        glorot_uniform((features + 1, hidden), g),
        0.1 * torch.randn(hidden, generator=g),
        glorot_uniform((hidden + 1, features), g),
        0.1 * torch.randn(features, generator=g),
    )
    x = torch.rand(batch, features, generator=g)
    return TDMLPWeights(*(t.to(device) for t in w)), x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 32, 16), (13, 40, 7), (512, 784, 100)])
def test_kernels_match_plain_on_card(cuda_device, shape):
    # FP32 sums run in another order than cuBLAS's: at (512, 784, 100) the
    # measured max-abs is 6.0e-7 (tdmlp) and 6.6e-7 (step) on an H100 80GB
    # HBM3 (700 W)
    w, x = _card_setup(cuda_device, *shape)
    y = fused_tdmlp(w, x, 0.3)
    torch.testing.assert_close(y, tdmlp_plain(w, x, 0.3), atol=1e-5, rtol=0)
    t = torch.tensor(0.2, device=cuda_device)
    dt = torch.tensor(0.05, device=cuda_device)
    k1 = tdmlp_plain(w, x, 0.2)
    for a, b in zip(fused_tsit5_step(w, x, t, dt, k1),
                    tsit5_step_plain(w, x, t, dt, k1)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_persistent_kernel_matches_loop_and_is_deterministic(cuda_device):
    w, x = _card_setup(cuda_device, 64, 784, 100)
    kw = dict(rtol=1e-4, atol=1e-4, max_steps=64,
              saveat_arr=torch.tensor([0.0, 0.5, 1.0], device=cuda_device))
    out = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
    ref = persistent_tsit5_solve_plain(w, x, (0.0, 1.0), **kw)
    torch.testing.assert_close(out["ys"], ref["ys"], atol=3e-4, rtol=0)
    assert abs(int(out["naccept"]) - int(ref["naccept"])) <= 1
    assert abs(int(out["nfe"]) - int(ref["nfe"])) <= 12
    assert bool(out["success"]) and bool(ref["success"])
    again = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
    assert torch.equal(out["ys"], again["ys"])
    assert int(out["nfe"]) == int(again["nfe"])
