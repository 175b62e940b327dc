"""Losses and metrics (reference ``experiments/src/utils.jl:71-101``);
counterpart of ``localregneuralde_tpu/harness/losses.py``. Predictions and
one-hot labels are ``(B, C)``; time series are batch-major ``(B, T, F)``."""
from __future__ import annotations

import math

import torch


def logitcrossentropy(y_pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of −Σ_c y·logsoftmax(ŷ)."""
    return torch.mean(-torch.sum(y * torch.log_softmax(y_pred, dim=-1), dim=-1))


def accuracy(y_pred: torch.Tensor, y: torch.Tensor, topk=(1,)):
    """Top-k accuracy in percent; ``y`` is one-hot (B, C)."""
    true_labels = torch.argmax(y, dim=-1)
    top_preds = torch.argsort(-y_pred, dim=-1, stable=True)[:, : max(topk)]
    out = []
    for k in topk:
        correct = (top_preds[:, :k] == true_labels[:, None]).any(dim=-1)
        out.append(100.0 * torch.mean(correct.float()))
    return out[0] if len(topk) == 1 else tuple(out)


def log_likelihood_loss(dpred: torch.Tensor, mask: torch.Tensor,
                        sigma: float = 0.01) -> torch.Tensor:
    """Masked Gaussian log-likelihood per sample, σ = 0.01 (reference
    ``utils.jl:94-98``); ``dpred`` and ``mask`` are (B, T, F). As in the
    reference, every entry adds its constant and the sum is divided by the
    number of observed entries."""
    sample_ll = (-(dpred ** 2) / (2 * sigma ** 2) - math.log(sigma)
                 - math.log(2 * math.pi) / 2)
    return torch.sum(sample_ll, dim=(1, 2)) / torch.sum(mask, dim=(1, 2))


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(μ, σ²) ‖ N(0, 1)) per sample, the mean over the latent axis
    halved (reference ``utils.jl:101``); ``mu`` and ``logvar`` are (B, L)."""
    return torch.mean(torch.exp(logvar) + mu ** 2 - 1 - logvar, dim=-1) / 2
