"""Optimizers with the reference's optax semantics
(``construct.jl:104-152`` through ``localregneuralde_tpu/harness/
construct.py::construct_optimizer``), written on device tensors.

Every number an update reads lives on the parameters' device: the learning
rate is a 0-d float32 tensor given to each update, the step count a
float32 tensor in the optimizer's state, and the moments are created when
the optimizer is, not on its first step. So an update issues device work
only (no host read, no Python number baked into a launch), and a captured
CUDA graph of a train step replays it with the learning rate and step of
each replay (``harness/graph.py``).

The arithmetic is optax's, in float32, where the reference's use of optax
is not at fault:

- ``adam``: μ ← b1·μ + (1−b1)·g, ν ← b2·ν + (1−b2)·g², the bias
  corrections 1 − bᵗ in float32, p ← p − lr·μ̂ / (√ν̂ + eps).
- ``adamw``: the same plus decay 1e-4 (optax's default; torch's AdamW's is
  1e-2) added to the update before the lr scaling.
- ``adamax``: ν ← max(b2·ν, |g|), p ← p − lr·μ̂ / (ν + eps): eps outside the
  running max, as optax has it (``torch.optim.Adamax`` adds it inside).
- ``sgd``: optax's trace, t ← g + m·t, the update t (or g + m·t with
  ``nesterov``); momentum 0 is plain SGD.
- ``weight_decay`` is decoupled decay scaled by the learning rate,
  ``p ← p + update(lr) − lr·wd·p`` (not ``Adam(weight_decay=)``, which adds
  ``wd·p`` to the gradient). The reference chains
  ``optax.add_decayed_weights(wd)`` after the lr-scaled base update, which
  adds ``+wd·p`` and so grows the weights; the port does not copy that
  fault (no shipped config sets ``weight_decay``).
- ``gradient_clip_norm`` is ``optax.clip_by_global_norm`` before the
  optimizer: ``g·max_norm/‖g‖`` when ``‖g‖ ≥ max_norm``.

The optimizers are ``torch.optim.Optimizer`` subclasses for their
``state_dict`` and ``load_state_dict``; the moments keep the names of
``torch.optim.Adam`` and ``SGD`` (``exp_avg``, ``exp_avg_sq``,
``momentum_buffer``), so a checkpoint of either still loads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import torch


class DeviceOptimizer(torch.optim.Optimizer):
    """Base of the port's optimizers: per parameter a float32 ``step``
    tensor and the moments named in ``slots``, all on the parameter's
    device from construction on. ``update(params, grads, lr)`` takes one
    step with the 0-d learning-rate tensor ``lr``. The hyperparameters live
    in ``defaults``, which copies and pickles of an optimizer keep."""

    slots: tuple = ()

    def __init__(self, params, **hyper):
        super().__init__(params, dict(lr=0.0, **hyper))
        for p in self._params():
            st = self.state[p]
            st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            for name in self.slots:
                st[name] = torch.zeros_like(p, memory_format=torch.preserve_format)

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def load_state_dict(self, state_dict):
        """Load, then put every state tensor on its parameter's device in
        float32 (a checkpoint may hold the step as a CPU number)."""
        super().load_state_dict(state_dict)
        for p in self._params():
            st = self.state[p]
            st["step"] = torch.as_tensor(st.get("step", 0.0),
                                         dtype=torch.float32).to(p.device)
            for name in self.slots:
                st[name] = st[name].to(device=p.device, dtype=p.dtype)

    def step(self, closure=None):
        raise TypeError("the port's optimizers step through "
                        "OptimizerSpec.apply(opt, params, grads, lr)")

    def _advance(self, params):
        """Add one to every step count; returns the first (they are
        equal)."""
        steps = [self.state[p]["step"] for p in params]
        for s in steps:
            s.add_(1.0)
        return steps[0]

    def update(self, params, grads, lr) -> None:
        raise NotImplementedError


class Adam(DeviceOptimizer):
    """optax ``adam`` (``decay`` 0) and ``adamw`` (``decay`` > 0: optax's
    decoupled ``decay·p`` added to the update before the lr scaling)."""

    slots = ("exp_avg", "exp_avg_sq")

    def __init__(self, params, betas=(0.9, 0.999), eps=1e-8, decay=0.0):
        super().__init__(params, betas=betas, eps=eps, decay=decay)

    @torch.no_grad()
    def update(self, params, grads, lr):
        (b1, b2), eps, decay = (self.defaults[k]
                                for k in ("betas", "eps", "decay"))
        step = self._advance(params)
        bc1 = 1.0 - torch.pow(b1, step)
        bc2 = 1.0 - torch.pow(b2, step)
        for p, g in zip(params, grads):
            st = self.state[p]
            mu, nu = st["exp_avg"], st["exp_avg_sq"]
            mu.mul_(b1).add_(g * (1.0 - b1))
            nu.mul_(b2).add_((g * g) * (1.0 - b2))
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            if decay:
                upd = upd + p * decay
            p.add_(upd * -lr)


class Adamax(DeviceOptimizer):
    """optax ``adamax``: μ ← b1·μ + (1−b1)·g, ν ← max(b2·ν, |g|),
    p ← p − lr·(μ / (1 − b1ᵗ)) / (ν + eps)."""

    slots = ("mu", "nu")

    def __init__(self, params, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, betas=betas, eps=eps)

    @torch.no_grad()
    def update(self, params, grads, lr):
        (b1, b2), eps = self.defaults["betas"], self.defaults["eps"]
        step = self._advance(params)
        bc1 = 1.0 - torch.pow(b1, step)
        for p, g in zip(params, grads):
            st = self.state[p]
            mu, nu = st["mu"], st["nu"]
            mu.mul_(b1).add_(g * (1.0 - b1))
            torch.maximum(nu * b2, g.abs(), out=nu)
            p.add_(((mu / bc1) / (nu + eps)) * -lr)


class SGD(DeviceOptimizer):
    """optax ``sgd``: with momentum m the trace t ← g + m·t and the update
    t, or g + m·t with ``nesterov``; without, the gradient."""

    def __init__(self, params, momentum=0.0, nesterov=False):
        super().__init__(params, momentum=momentum, nesterov=nesterov)

    @property
    def slots(self):
        return ("momentum_buffer",) if self.defaults["momentum"] else ()

    @torch.no_grad()
    def update(self, params, grads, lr):
        self._advance(params)
        m, nesterov = self.defaults["momentum"], self.defaults["nesterov"]
        for p, g in zip(params, grads):
            upd = g
            if m:
                buf = self.state[p]["momentum_buffer"]
                buf.mul_(m).add_(g)
                upd = g + buf * m if nesterov else buf
            p.add_(upd * -lr)


def device_scalar_like(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a number or a 0-d tensor) as a 0-d float32 tensor on
    ``like``'s device; a number is filled in on the device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32).reshape(())
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


@dataclass
class OptimizerSpec:
    """What ``construct_optimizer`` returns: ``init(params)`` makes the
    optimizer of the train state's parameters, with its state, and
    ``apply(opt, params, grads, lr)`` takes one step."""

    name: str
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0
    gradient_clip_norm: float = 0.0

    def init(self, params: Dict[str, torch.Tensor]) -> DeviceOptimizer:
        ps = list(params.values())
        if self.name == "adam":
            return Adam(ps)
        if self.name == "adamw":
            return Adam(ps, decay=1e-4)
        if self.name == "adamax":
            return Adamax(ps)
        if self.name == "sgd":
            return SGD(ps, momentum=self.momentum, nesterov=self.nesterov)
        raise ValueError(
            f"unknown optimizer {self.name!r}; supported: adam, adamw, "
            "adamax, sgd"
        )

    @torch.no_grad()
    def apply(self, opt: DeviceOptimizer, params: Sequence[torch.Tensor],
              grads: Sequence[torch.Tensor], lr,
              norm_sq: Optional[Callable] = None) -> None:
        """One update of ``params`` in place with ``grads`` (None: zero) at
        learning rate ``lr``, a number or a 0-d tensor. ``norm_sq(grads)``
        gives the whole gradient's squared norm for the clipping where the
        gradients are tensor-parallel shards (default: the sum of their
        squares)."""
        params = list(params)
        lr = device_scalar_like(lr, params[0])
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if self.gradient_clip_norm:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads)
                              if norm_sq is None else norm_sq(grads))
            scale = torch.where(norm < self.gradient_clip_norm, 1.0,
                                self.gradient_clip_norm / norm)
            grads = [g * scale for g in grads]
        decay = ([p * (-lr * self.weight_decay) for p in params]
                 if self.weight_decay else None)
        opt.update(params, grads, lr)
        if decay is not None:
            for p, d in zip(params, decay):
                p.add_(d)
