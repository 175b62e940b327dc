"""Classification loss and metric (reference
``experiments/src/utils.jl:71-91``); counterpart of
``localregneuralde_tpu/harness/losses.py``. Predictions and one-hot labels
are ``(B, C)``."""
from __future__ import annotations

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
