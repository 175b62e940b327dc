"""Factories: config → model, loss and optimizer (reference
``experiments/src/construct.jl``); counterpart of
``localregneuralde_tpu/harness/construct.py`` for the MNIST MLP Neural ODE,
the MNIST Neural SDE, the CIFAR-10 conv Neural ODE and the PhysioNet latent
ODE.

``use_pallas='auto'`` routes every family with kernels through them on CUDA
inputs. The reference's ``auto`` leaves the CIFAR family on XLA (its fused
conv kernels measured 3-4× slower than XLA's convolutions on a TPU v5e,
``construct.py:176-179``); that is a TPU measurement, and the port measures
its own kernels (README, deviations).

The models are built on the CUDA device unless the caller passes another
``device`` (``device="cpu"``, as the tests do); asking for CUDA where there
is none raises."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..models import (
    AugmenterLayer,
    LatentGRUCell,
    NeuralDSDE,
    NeuralODE,
    ReparameterizeLayer,
    TDChain,
    diffeqsol_to_array,
    diffeqsol_to_timeseries,
)
from ..nn import (
    BatchNorm,
    Chain,
    Conv,
    Dense,
    Flatten,
    Lambda,
    Recurrence,
    WrappedFunction,
)
from .config import ExperimentConfig
from .losses import kl_divergence, log_likelihood_loss, logitcrossentropy
from .optim import OptimizerSpec
from .schedulers import (
    Constant,
    CosineAnneal,
    ExponentialDecay,
    InverseDecay,
    Step,
)


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: the CUDA device unless the
    caller names another. Raises when CUDA is asked for and none exists."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to "
            "run on the CPU"
        )
    return device


def construct_model(cfg: ExperimentConfig, *, device=None,
                    generator: Optional[torch.Generator] = None):
    """Build the model of ``cfg`` with weights drawn from ``generator``
    (default: a CPU generator seeded with ``cfg.seed``), on ``device``
    (default: the CUDA device)."""
    m = cfg.model
    if m.model_type == "time_series":
        raise ValueError(
            "time_series models need construct_time_series(cfg, saveat)")
    if m.model_type not in ("mlp", "cifar10_cnn"):
        raise ValueError(f"unknown model_type {m.model_type!r}")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    if m.model_type == "cifar10_cnn":
        return _construct_cifar10_cnn(cfg, device, generator)
    if m.sde:
        return _construct_mlp_sde(cfg, device, generator)
    return _construct_mlp_ode(cfg, device, generator)


def _node_kwargs(cfg: ExperimentConfig):
    """NeuralODE's keywords from ``cfg.model.solver``, with the reference's
    checks of ``ode_solver`` and ``adjoint`` (``construct.py:57-81``)."""
    s = cfg.model.solver
    if s.ode_solver not in ("tsit5", "vcab3", "vcabm3"):
        raise ValueError(
            f"unknown ode_solver {s.ode_solver!r}; supported: tsit5, vcab3, "
            "vcabm3 (reference construct.jl:154-164)"
        )
    if s.adjoint not in ("stored", "direct", "interpolating", "backsolve"):
        raise ValueError(
            f"unknown adjoint {s.adjoint!r}; supported: stored, direct, "
            "interpolating, backsolve"
        )
    return dict(
        rtol=s.reltol,
        atol=s.abstol,
        max_steps=s.max_steps,
        checkpoint_every=s.checkpoint_every,
        regularize=cfg.model.regularize,
        regularize_type=cfg.model.regularize_type,
        solver=s.ode_solver,
        adjoint=s.adjoint,
        precision=s.precision,
        grad_precision=s.grad_precision,
        use_persistent=s.use_persistent,
        knot_window=s.knot_window if s.knot_window > 0 else None,
        compute_dtype=cfg.model.dynamics_compute_dtype,
        rng_seed=cfg.seed,
    )


# The layers outside the DE layers take the reference's precision=None:
# called outside any ``jax.default_matmul_precision``, they compute at the
# backend default there, TF32 on a GPU and FP32 on the CPU, forward and
# backward. The port gives them the same keyword (``nn.basic.layer_tier``)
# rather than a scope of the backend default around the model's call, so
# that no scope reaches a layer the reference does not build with it: the
# latent model's encoder cell, ``rec_to_gen`` and ``gen_to_data`` take it
# too. The DE layers' dynamics take their solver's tier in their own
# ``product_tier_scope``.
OUTER = dict(precision=None)


def _construct_mlp_ode(cfg: ExperimentConfig, device, generator):
    """Flatten → NeuralODE(TDChain MLP) → classifier at the backend default
    (reference ``construct.jl:180-200``)."""
    m = cfg.model
    hsize = m.mlp_hidden_state_size
    td = 1 if m.mlp_time_dependent else 0
    insize = m.image_size[0] * m.image_size[1] * m.in_channels
    kw = dict(generator=generator, device=device)
    layers = [Dense(insize + td, hsize, "tanh", **kw)]
    for _ in range(m.mlp_num_hidden_layers - 1):
        layers.append(Dense(hsize + td, hsize, "tanh", **kw))
    layers.append(Dense(hsize + td, insize, **kw))
    dynamics = TDChain(*layers) if m.mlp_time_dependent else Chain(*layers)
    kernels_ok = m.mlp_time_dependent and m.mlp_num_hidden_layers == 1
    use_pallas = m.use_pallas if kernels_ok or m.use_pallas == "on" else "off"
    return Chain(
        flatten=Flatten(),
        neural_ode=NeuralODE(dynamics, use_pallas=use_pallas, **_node_kwargs(cfg)),
        sol_to_arr=WrappedFunction(diffeqsol_to_array),
        classifier=Dense(insize, m.num_classes, **OUTER, **kw),
    )


def _construct_mlp_sde(cfg: ExperimentConfig, device, generator):
    """Flatten → Dense(784 → 32) → NeuralDSDE(drift Chain(Dense(32 → 64,
    tanh), Dense(64 → 32)), diffusion Dense(32 → 32)) → classifier, the
    downsample and the classifier at the backend default (reference
    ``construct.jl:202-210``)."""
    m = cfg.model
    s = m.solver
    insize = m.image_size[0] * m.image_size[1] * m.in_channels
    kw = dict(generator=generator, device=device)
    drift = Chain(Dense(32, 64, "tanh", **kw), Dense(64, 32, **kw))
    diffusion = Dense(32, 32 * (m.sde_noise_dims or 1), **kw)
    return Chain(
        flatten=Flatten(),
        downsample=Dense(insize, 32, **OUTER, **kw),
        neural_dsde=NeuralDSDE(
            drift, diffusion, rtol=s.reltol, atol=s.abstol,
            max_steps=s.max_steps, checkpoint_every=s.checkpoint_every,
            regularize=m.regularize, adjoint=s.adjoint,
            precision=s.precision, grad_precision=s.grad_precision,
            solver=m.sde_solver, noise_dims=m.sde_noise_dims or None,
            use_pallas=m.use_pallas, use_persistent=s.use_persistent,
            rng_seed=cfg.seed,
        ),
        sol_to_arr=WrappedFunction(diffeqsol_to_array),
        classifier=Dense(32, m.num_classes, **OUTER, **kw),
    )


def _construct_cifar10_cnn(cfg: ExperimentConfig, device, generator):
    """AugmenterLayer (conv 3 → 5, concatenated: 8 channels) → BatchNorm →
    NeuralODE(TDChain of convs, kernel 13's and 14's family) → conv
    classifier, the augmenter's conv and the classifier at the backend
    default (reference ``construct.jl:212-228``; NHWC here)."""
    m = cfg.model
    es = m.bn_eval_stats
    kw = dict(generator=generator, device=device)

    def conv_bn(cin):
        return Chain(Conv((3, 3), cin, 64, use_bias=False, **kw),
                     BatchNorm(64, "gelu", eval_stats=es, device=device))

    dynamics = TDChain(conv_bn(9), conv_bn(65),
                       Conv((3, 3), 65, 8, use_bias=False, **kw))
    h, w = m.image_size
    return Chain(
        augment=AugmenterLayer(Conv((3, 3), 3, 5, **OUTER, **kw)),
        bn=BatchNorm(8, eval_stats=es, device=device),
        neural_ode=NeuralODE(dynamics, use_pallas=m.use_pallas,
                             **_node_kwargs(cfg)),
        sol_to_arr=WrappedFunction(diffeqsol_to_array),
        classifier=Chain(Conv((3, 3), 8, 1, "gelu", **OUTER, **kw),
                         Flatten(), Dense(h * w, m.num_classes, **OUTER,
                                          **kw)),
    )


def construct_time_series(cfg: ExperimentConfig, saveat, *, device=None,
                          generator: Optional[torch.Generator] = None):
    """Recurrence(LatentGRUCell) → rec_to_gen → Reparameterize →
    NeuralODE(the Dense-chain generative dynamics, saveat = the observation
    grid) → time series → decoder (reference ``construct.jl:230-252``),
    with weights drawn from ``generator`` (default: a CPU generator seeded
    with ``cfg.seed``), on ``device`` (default: the CUDA device). The
    encoder's ``LatentGRUCell``, ``rec_to_gen`` and ``gen_to_data`` take the
    reference's ``precision=None`` (``OUTER``: TF32 on a card, FP32 on the
    CPU, as the reference's Dense layers, called outside any precision
    scope); the generative dynamics take their solver's tier in the DE
    layer's scope."""
    m = cfg.model
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    kw = dict(generator=generator, device=device)
    N, H, L = m.ts_node_dims, m.ts_hidden_dims, m.ts_latent_dims
    gru = Recurrence(LatentGRUCell(m.ts_in_dims, H, L, **OUTER, **kw))
    rec_to_gen = Chain(Dense(2 * L, L, "tanh", **OUTER, **kw),
                       Dense(L, 2 * N, **OUTER, **kw))
    gen_dynamics = Chain(
        Lambda(torch.tanh),
        *[Dense(N, H, "tanh", **kw) if i % 2 == 0 else Dense(H, N, "tanh", **kw)
          for i in range(8)],
    )
    return Chain(
        gru=gru,
        rec_to_gen=rec_to_gen,
        # a generator of its own, not the NeuralODE's (which draws t1)
        reparam=ReparameterizeLayer(rng_seed=cfg.seed + 1, latent_dims=N),
        # the generative dynamics is kernel 5's and 9's Dense-chain family
        neural_ode=NeuralODE(gen_dynamics, saveat=saveat,
                             use_pallas=m.use_pallas, **_node_kwargs(cfg)),
        sol_to_ts=WrappedFunction(diffeqsol_to_timeseries),
        gen_to_data=Dense(N, m.ts_in_dims, **OUTER, **kw),
    )


def construct_loss(cfg: ExperimentConfig) -> Tuple[Callable, object]:
    """Return ``(loss_fn, w_reg_schedule)``; for time-series models the
    schedule is ``(w_reg, w_kl)``, with the KL weight annealed as
    max(0, 1 − 0.99^(t−100)) (reference ``construct.jl:78-102``)."""
    if cfg.model.model_type not in ("mlp", "cifar10_cnn", "time_series"):
        raise ValueError(f"unknown model_type {cfg.model.model_type!r}")
    if cfg.loss.w_reg_decay == "exponential":
        w_reg = ExponentialDecay(
            cfg.loss.w_reg_start, cfg.loss.w_reg_end, cfg.train.total_steps
        )
    else:
        w_reg = Constant(cfg.loss.w_reg_start)
    if cfg.model.model_type == "time_series":
        w_kl = lambda t: max(0.0, 1 - 0.99 ** (t - 100))  # noqa: E731
        return _latent_ode_loss(cfg), (w_reg, w_kl)
    return _classification_loss(cfg), w_reg


def _classification_loss(cfg: ExperimentConfig):
    regularized = cfg.model.regularize != "none"
    sde = cfg.model.sde

    def loss_fn(model, params, state, data, w_reg, *, training=True):
        x, y = data
        y_pred, st_ = torch.func.functional_call(
            model, params, (x, state), {"training": training}
        )
        ce_loss = logitcrossentropy(y_pred, y)
        if sde:
            node_st = st_["neural_dsde"]
            # as-is reference quirk (construct.jl:9,24): the logged
            # diffusion NFE mirrors the drift NFE
            nfe = (node_st["nfe_drift"], node_st["nfe_drift"])
        else:
            node_st = st_["neural_ode"]
            nfe = node_st["nfe"]
        reg_val = node_st["reg_val"] if regularized else torch.zeros((), device=x.device)
        loss = ce_loss + w_reg * reg_val if regularized else ce_loss
        stats = {
            "y_pred": y_pred,
            "nfe": nfe,
            "ce_loss": ce_loss,
            "reg_val": reg_val,
            "solver_success": node_st["success"],
        }
        return loss, st_, stats

    return loss_fn


def _latent_ode_loss(cfg: ExperimentConfig):
    """Masked Gaussian NLL (σ = 0.01) plus the KL term weighted by w_kl,
    plus w_reg·reg_val when regularised (reference ``construct.jl:9-31``);
    ``data`` is ``(data, mask, dt)``, each (B, T, ·)."""
    regularized = cfg.model.regularize != "none"

    def loss_fn(model, params, state, data, w, *, training=True):
        w_reg, w_kl = w
        data_arr, mask, dt = data
        x = torch.cat([data_arr, mask, dt], dim=-1)
        y, st_ = torch.func.functional_call(
            model, params, (x, state), {"training": training}
        )
        dpred = y * mask - data_arr * mask
        ll = log_likelihood_loss(dpred, mask)
        kl = kl_divergence(st_["reparam"]["mu"], st_["reparam"]["logvar"])
        loss = -torch.mean(ll - w_kl * kl)
        node_st = st_["neural_ode"]
        reg_val = (node_st["reg_val"] if regularized
                   else torch.zeros((), device=x.device))
        if regularized:
            loss = loss + w_reg * reg_val
        stats = {
            "y_pred": y,
            "neg_log_likelihood": -torch.mean(ll),
            "kl_div": torch.mean(kl),
            "nfe": node_st["nfe"],
            "reg_val": reg_val,
            "solver_success": node_st["success"],
        }
        return loss, st_, stats

    return loss_fn


def construct_optimizer(cfg: ExperimentConfig):
    """Return ``(optimizer, lr_schedule)``: an ``OptimizerSpec`` (adam,
    adamw, adamax or sgd with momentum/nesterov, plus ``weight_decay`` and
    ``gradient_clip_norm``, with optax's semantics, ``harness/optim.py``)
    and the schedule whose value the train step takes as its learning rate
    (reference ``construct.jl:104-152``)."""
    o = cfg.optimizer
    opt = OptimizerSpec(
        name=o.optimizer.lower(), momentum=float(o.momentum),
        nesterov=bool(o.nesterov), weight_decay=float(o.weight_decay),
        gradient_clip_norm=float(getattr(o, "gradient_clip_norm", 0.0)),
    )
    if opt.name not in ("adam", "adamw", "adamax", "sgd"):
        raise ValueError(
            f"unknown optimizer {o.optimizer!r}; supported: adam, adamw, "
            "adamax, sgd"
        )
    s = o.scheduler
    kind = s.lr_scheduler.lower()
    if kind == "cosine":
        sched = CosineAnneal(
            o.learning_rate, o.learning_rate / s.cosine_lr_div_factor,
            s.cosine_cycle_length, restart=True, dampen=s.cosine_dampen,
        )
    elif kind == "constant":
        sched = Constant(o.learning_rate)
    elif kind == "step":
        sched = Step(o.learning_rate, s.step_lr_step_decay, s.step_lr_steps)
    elif kind == "inverse":
        sched = InverseDecay(o.learning_rate, s.inverse_decay_factor)
    elif kind == "exponential":
        sched = ExponentialDecay(
            o.learning_rate, o.learning_rate / s.exponential_lr_div_factor,
            cfg.train.total_steps,
        )
    else:
        raise ValueError(
            f"unknown scheduler {s.lr_scheduler!r}; supported: constant, "
            "step, exponential, inverse, cosine"
        )
    return opt, sched
