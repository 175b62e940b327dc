"""Optimizers on ``torch.optim`` with the reference's optax semantics
(``construct.jl:104-152`` through ``localregneuralde_tpu/harness/
construct.py::construct_optimizer``).

Where the two libraries differ, the port follows optax, except where the
reference's use of optax is at fault:

- ``adamw``: optax's default decay is 1e-4 (``torch.optim.AdamW``'s is
  1e-2); both decay decoupled, scaled by the learning rate.
- ``adamax``: optax adds eps outside the running max,
  ``u / (max(b2·ν, |g|) + eps)``; ``torch.optim.Adamax`` adds it inside,
  so the port has its own ``Adamax``.
- ``weight_decay`` is decoupled decay scaled by the learning rate,
  ``p ← p + update(lr) − lr·wd·p`` (not ``Adam(weight_decay=)``, which adds
  ``wd·p`` to the gradient). The reference chains
  ``optax.add_decayed_weights(wd)`` after the lr-scaled base update, which
  adds ``+wd·p`` and so grows the weights; the port does not copy that
  fault (no shipped config sets ``weight_decay``).
- ``gradient_clip_norm`` is ``optax.clip_by_global_norm`` before the
  optimizer: ``g·max_norm/‖g‖`` when ``‖g‖ ≥ max_norm``.
- ``sgd`` with ``nesterov`` and momentum 0 is plain SGD, as optax's
  zero-decay trace is.

The learning rate is set on the optimizer's groups before every step, as
optax's ``inject_hyperparams`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import torch


class Adamax(torch.optim.Optimizer):
    """optax ``adamax``: μ ← b1·μ + (1−b1)·g, ν ← max(b2·ν, |g|),
    p ← p − lr·(μ / (1 − b1ᵗ)) / (ν + eps)."""

    def __init__(self, params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                st["step"] += 1
                st["mu"].mul_(b1).add_(p.grad, alpha=1.0 - b1)
                torch.maximum(st["nu"] * b2, p.grad.abs(), out=st["nu"])
                mu_hat = st["mu"] / (1.0 - b1 ** st["step"])
                p.sub_(group["lr"] * mu_hat / (st["nu"] + group["eps"]))


@dataclass
class OptimizerSpec:
    """What ``construct_optimizer`` returns: ``init(params)`` binds a
    ``torch.optim`` optimizer to the train state's parameters, and
    ``apply(opt, params, grads, lr)`` takes one step."""

    name: str
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0
    gradient_clip_norm: float = 0.0

    def init(self, params: Dict[str, torch.Tensor]) -> torch.optim.Optimizer:
        ps = list(params.values())
        if self.name == "adam":
            return torch.optim.Adam(ps, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
        if self.name == "adamw":
            return torch.optim.AdamW(ps, lr=0.0, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=1e-4)
        if self.name == "adamax":
            return Adamax(ps, lr=0.0)
        if self.name == "sgd":
            if self.momentum == 0:
                return torch.optim.SGD(ps, lr=0.0)
            return torch.optim.SGD(ps, lr=0.0, momentum=self.momentum,
                                   nesterov=self.nesterov)
        raise ValueError(
            f"unknown optimizer {self.name!r}; supported: adam, adamw, "
            "adamax, sgd"
        )

    @torch.no_grad()
    def apply(self, opt: torch.optim.Optimizer, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], lr: float) -> None:
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if self.gradient_clip_norm:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.where(norm < self.gradient_clip_norm, 1.0,
                                self.gradient_clip_norm / norm)
            grads = [g * scale for g in grads]
        for p, g in zip(params, grads):
            p.grad = g
        decay = ([-float(lr) * self.weight_decay * p for p in params]
                 if self.weight_decay else None)
        for group in opt.param_groups:
            group["lr"] = float(lr)
        opt.step()
        if decay is not None:
            for p, d in zip(params, decay):
                p.add_(d)
        for p in params:
            p.grad = None
