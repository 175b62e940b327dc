"""Hairer-style mixed absolute/relative tolerance residuals and RMS norm.

Counterpart of ``localregneuralde_tpu/ops/residuals.py`` (reference
``src/perform_step.jl:208-220``). Every reduction runs over the whole batch
tensor: one shared adaptive grid, one error norm. Under the global grid of
data parallelism (``parallel/sharded_train.py``) the batch is spread over
the ranks of a ``DPGroup`` and the norm is that of the whole distributed
batch (``group``).
"""
from __future__ import annotations

import torch


def internal_norm(x: torch.Tensor, group=None) -> torch.Tensor:
    """RMS over all elements (reference ``_internalnorm``); with a
    ``DPGroup``, over the elements of every rank's ``x`` (equal shapes): the
    square root of the rank mean of each rank's mean square, summed in rank
    order, so every rank holds the same bytes (and a group of one those of
    the single-device norm)."""
    ms = torch.mean(torch.square(x))
    if group is None:
        return torch.sqrt(ms)
    return torch.sqrt(_RankSum.apply(ms, group) / group.size)


class _RankSum(torch.autograd.Function):
    """The sum over the ranks of a 0-d tensor, added in rank order. Its
    backward is n times the derivative with respect to this rank's term:
    the data-parallel step averages its gradients over the ranks, which
    turns these into their sum, the gradient of a function of the global
    norm (the loss's batch means are local means, whose rank mean is the
    global mean; ``parallel/sharded_train.py``)."""

    @staticmethod
    def forward(ctx, x, group):
        from ..parallel.mesh import ordered_sum

        ctx.size = group.size
        return ordered_sum(x.reshape(1), group).reshape(())

    @staticmethod
    def backward(ctx, g):
        return g * ctx.size, None


def error_residuals(utilde, u0, u1, atol, rtol):
    """ũ / (atol + max(|u0|, |u1|)·rtol)."""
    return utilde / (atol + torch.maximum(torch.abs(u0), torch.abs(u1)) * rtol)


def sde_error_residuals(E1, E2, u0, u1, atol, rtol, delta):
    """(δ·E1 + E2) / (atol + max(|u0|, |u1|)·rtol): the SRI step's
    δ-weighted drift and diffusion error parts (reference
    ``src/perform_step.jl:98-103``)."""
    return (delta * E1 + E2) / (
        atol + torch.maximum(torch.abs(u0), torch.abs(u1)) * rtol
    )


def difference_residuals(u0, u1, atol, rtol):
    """(u1 − u0) / (atol + max(|u0|, |u1|)·rtol): the Milstein step's
    error estimate (reference ``src/perform_step.jl:164-167``)."""
    return (u1 - u0) / (atol + torch.maximum(torch.abs(u0), torch.abs(u1)) * rtol)


def scaled_error_norm(utilde, u0, u1, atol, rtol, group=None) -> torch.Tensor:
    """RMS of the tolerance-scaled residuals: the solver's EEst (over the
    ranks of ``group``)."""
    return internal_norm(error_residuals(utilde, u0, u1, atol, rtol), group)
