"""Callable hyperparameter schedulers.

Exact formulas of the reference (``experiments/src/utils.jl:1-68``), used both
for learning rates and the regularization weight ``w_reg``. Steps are
1-based, matching the reference training loop.
"""
from __future__ import annotations

import math
from bisect import bisect_left
from typing import Sequence


class Constant:
    def __init__(self, lam: float):
        self.lam = float(lam)

    def __call__(self, t) -> float:
        return self.lam


class ExponentialDecay:
    """λ₀·e^{−k·t} with k = log(λ₀/λ₁)/nsteps (λ(nsteps) = λ₁)."""

    def __init__(self, lam0: float, lam1: float, nsteps: int):
        self.lam0 = float(lam0)
        self.lam1 = float(lam1)
        self.k = math.log(lam0 / lam1) / nsteps
        self.nsteps = nsteps

    def __call__(self, t) -> float:
        return self.lam0 * math.exp(-self.k * t)


class InverseDecay:
    """λ₀ / (1 + γ·t)."""

    def __init__(self, lam0: float, gamma: float):
        self.lam0 = float(lam0)
        self.gamma = float(gamma)

    def __call__(self, t) -> float:
        return self.lam0 / (1 + self.gamma * t)


class Step:
    """λ₀·γ^(number of milestones passed) (milestones sorted ascending)."""

    def __init__(self, lam0: float, gamma: float, steps: Sequence[int]):
        self.lam0 = float(lam0)
        self.gamma = float(gamma)
        self.steps = sorted(int(s) for s in steps)

    def __call__(self, t) -> float:
        # exponent = number of milestones strictly below t-1
        # (reference: searchsortedfirst(step_sizes, t − 1) − 1)
        return self.lam0 * self.gamma ** bisect_left(self.steps, t - 1)


class CosineAnneal:
    """Cosine annealing between λ₀ and λ₁ over ``period`` steps.

    ``restart=True`` restarts each cycle with the peak divided by
    ``dampen^cycle`` (reference ``utils.jl:46-68``; t is 1-based).
    """

    def __init__(self, lam0: float, lam1: float, period: int, *,
                 restart: bool = False, dampen: float = 1.0):
        self.range = abs(float(lam0) - float(lam1))
        self.offset = min(float(lam0), float(lam1))
        self.period = int(period)
        self.restart = restart
        self.dampen = float(dampen)

    def __call__(self, t) -> float:
        if self.restart:
            d = self.dampen ** ((t - 1) // self.period)
            return (
                self.range
                * (1 + math.cos(math.pi * ((t - 1) % self.period) / self.period))
                / 2
                + self.offset
            ) / d
        return (
            self.range * (1 + math.cos(math.pi * (t - 1) / self.period)) / 2
            + self.offset
        )
