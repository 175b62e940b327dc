"""Hairer-style mixed absolute/relative tolerance residuals and RMS norm.

Counterpart of ``localregneuralde_tpu/ops/residuals.py`` (reference
``src/perform_step.jl:208-220``). Every reduction runs over the whole batch
tensor: one shared adaptive grid, one error norm.
"""
from __future__ import annotations

import torch


def internal_norm(x: torch.Tensor) -> torch.Tensor:
    """RMS over all elements (reference ``_internalnorm``)."""
    return torch.sqrt(torch.mean(torch.square(x)))


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


def scaled_error_norm(utilde, u0, u1, atol, rtol) -> torch.Tensor:
    """RMS of the tolerance-scaled residuals: the solver's EEst."""
    return internal_norm(error_residuals(utilde, u0, u1, atol, rtol))
