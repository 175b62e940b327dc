"""LatentGRUCell — the GRU-Bayes encoder cell for irregular time series.

Counterpart of ``localregneuralde_tpu/models/latent_ode.py`` (reference
``src/layers/latent_ode.jl``). The cell takes ``x_t = concat(data_t, mask_t,
dt_t)`` slices of shape (B, 2·in_dim + 1) and carries ``(y_mean, y_std)``;
the observation mask keeps the carried (mean, std) at unobserved steps.

Both of the reference's as-is quirks are kept:

1. ``new_y_mean`` is computed from ``new_state_std``, not from the mean
   half (``latent_ode.jl:37``);
2. the mask sums the second half of x, which includes the Δt channel
   (``latent_ode.jl:40``), so a step with no observation but Δt > 0 still
   updates.

The cell's six Dense layers take ``precision`` (``nn.basic.layer_tier``):
``construct_time_series`` builds them with the reference's None, the
backend default its cell layers compute at, TF32 on a card and FP32 on the
CPU; the default, ``SCOPE``, follows the enclosing ``product_tier_scope``.
"""
from __future__ import annotations

import torch

from ..nn.basic import SCOPE, Chain, Dense
from ..nn.module import Module


class LatentGRUCell(Module):
    def __init__(self, in_dim: int, h_dim: int, latent_dim: int, *,
                 precision=SCOPE, generator=None, device=None):
        super().__init__()
        self.in_dim = in_dim
        self.h_dim = h_dim
        self.latent_dim = latent_dim
        n_in = latent_dim * 2 + in_dim * 2 + 1
        kw = dict(precision=precision, generator=generator, device=device)
        self.update_gate = Chain(Dense(n_in, h_dim, "tanh", **kw),
                                 Dense(h_dim, latent_dim, "sigmoid", **kw))
        self.reset_gate = Chain(Dense(n_in, h_dim, "tanh", **kw),
                                Dense(h_dim, latent_dim, "sigmoid", **kw))
        self.new_state = Chain(Dense(n_in, h_dim, "tanh", **kw),
                               Dense(h_dim, latent_dim * 2, "tanh", **kw))

    def init_state(self) -> dict:
        return {name: gate.init_state()
                for name, gate in self.named_children()}

    def initial_carry(self, x_t: torch.Tensor):
        """First carry: y_mean = 0, y_std = 1 (``latent_ode.jl:19-23``)."""
        shape = (x_t.shape[0], self.latent_dim)
        return x_t.new_zeros(shape), x_t.new_ones(shape)

    def apply_layer(self, xc, state, *, training: bool = False):
        x, (y_mean, y_std) = xc
        L = self.latent_dim
        y_concat = torch.cat([y_mean, y_std, x], dim=-1)
        update, st_u = self.update_gate(y_concat, state["update_gate"],
                                        training=training)
        reset, st_r = self.reset_gate(y_concat, state["reset_gate"],
                                      training=training)
        concat = torch.cat([y_mean * reset, y_std * reset, x], dim=-1)
        new_state_out, st_n = self.new_state(concat, state["new_state"],
                                             training=training)
        new_state_std = new_state_out[..., L:]
        # quirk 1: the mean from new_state_std
        new_y_mean = (1 - update) * new_state_std + update * y_mean
        new_y_std = (1 - update) * new_state_std + update * y_std
        # quirk 2: the mask is the second half of x (mask rows and Δt)
        half = x.shape[-1] // 2
        mask = (torch.sum(x[..., half:], dim=-1, keepdim=True) > 0).to(x.dtype)
        new_y_mean = mask * new_y_mean + (1 - mask) * y_mean
        new_y_std = mask * new_y_std + (1 - mask) * y_std
        y = torch.cat([new_y_mean, new_y_std], dim=-1)
        new_st = {"update_gate": st_u, "reset_gate": st_r, "new_state": st_n}
        return (y, (new_y_mean, new_y_std)), new_st
