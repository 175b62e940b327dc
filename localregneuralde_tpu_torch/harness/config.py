"""Typed, nested, defaulted experiment configuration.

Mirror of the reference config system (``experiments/src/config.jl``):
dataclass tree with defaults, loaded from YAML, with ``--a.b.c=value`` CLI
overrides merged on top (the SimpleConfig.define_configuration analog,
``experiments/mnist_ode/main.jl:21``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class SolverConfig:
    ode_solver: str = "tsit5"
    abstol: float = 5.0e-2
    reltol: float = 5.0e-2
    max_steps: int = 256
    checkpoint_every: int = 16
    # gradient path through the solve: stored (default; discretize-through,
    # cost ∝ accepted steps) | direct | interpolating (reference default
    # sensealg, neural_ode.jl:11) | backsolve
    adjoint: str = "stored"
    # MXU input precision for dynamics matmuls: auto (highest iff
    # rtol < 1e-4 — TPU's default one-pass-bf16 f32 matmuls flood the error
    # estimate with noise at tight tolerances) | default | high | highest
    precision: str = "auto"
    # backward-pass precision for the stored-adjoint recompute/cotangent
    # dots: 'match' re-runs them at `precision`; 'default' drops them to
    # the backend-fast one-pass path — the controller's decisions were
    # already made in the forward, so this trades ~1e-3-relative gradient
    # noise (ordinary bf16-training noise) for a large backward speedup at
    # tight tolerances. Two-level windowed replay always keeps `precision`
    # (its replay must track the forward's accept/reject decisions).
    # Effective on the fused Pallas backward families (the XLA-twin
    # backward keeps `precision`).
    grad_precision: str = "match"
    # persistent-loop Pallas kernels (whole solve / whole sweep in one TPU
    # program; automatic fallback outside the dense-knot regime) — only
    # effective when the Pallas kernel family is active
    use_persistent: bool = True
    # stored-adjoint dense-knot capacity (0 = default 512): solves with
    # more accepted steps use two-level windowed replay — memory is
    # O(knot_window + max_steps/sqrt(max_steps))
    knot_window: int = 0


@dataclass
class ModelConfig:
    model_type: str = "mlp"  # mlp | time_series | cifar10_cnn
    regularize: str = "unbiased"
    regularize_type: str = "error_estimate"
    image_size: List[int] = field(default_factory=lambda: [32, 32])
    in_channels: int = 3
    num_classes: int = 10
    sde: bool = False
    # SDE solver family for the NeuralDSDE layer: sosri (default; derived
    # stability-optimized tableau) | sri (classical SRIW1) | milstein |
    # euler_heun. Non-diagonal (matrix) diffusion: set sde_noise_dims = m
    # (requires sde_solver: milstein; the diffusion net then emits d·m
    # features viewed as the noise-rate matrix).
    sde_solver: str = "sosri"
    sde_noise_dims: int = 0
    solver: SolverConfig = field(default_factory=SolverConfig)
    # mlp
    mlp_hidden_state_size: int = 100
    mlp_num_hidden_layers: int = 1
    mlp_time_dependent: bool = True
    # fused Pallas TD-MLP kernels ("auto": on for TPU backends when the
    # dynamics is a 2-layer TDChain; "on"/"off" force)
    use_pallas: str = "auto"
    # low-precision dynamics compute (bandwidth lever for the conv family;
    # float32 | bfloat16); solver math stays f32 regardless
    dynamics_compute_dtype: str = "float32"
    # BatchNorm eval-mode statistics for the conv family: 'running' is the
    # reference (Lux testmode) semantic; 'batch' normalizes with current
    # batch statistics in eval too — an opt-in escape hatch for the
    # BN-inside-ODE-dynamics pathology (one running average cannot track
    # statistics that vary along the trajectory; RESULTS.md round-4
    # diagnosis). Documented deviation; default is reference-faithful.
    bn_eval_stats: str = "running"
    # time_series
    ts_in_dims: int = 37
    ts_hidden_dims: int = 40
    ts_latent_dims: int = 50
    ts_node_dims: int = 20


@dataclass
class LossConfig:
    w_reg_start: float = 100.0
    w_reg_end: float = 10.0
    w_reg_decay: str = "exponential"


@dataclass
class LRSchedulerConfig:
    lr_scheduler: str = "inverse"
    cosine_lr_div_factor: float = 100.0
    cosine_cycle_length: int = 50000
    cosine_dampen: float = 1.0
    step_lr_steps: List[int] = field(
        default_factory=lambda: [1000, 2000, 5000]
    )
    step_lr_step_decay: float = 0.1
    inverse_decay_factor: float = 1.0e-4
    exponential_lr_div_factor: float = 100.0


@dataclass
class OptimizerConfig:
    optimizer: str = "adam"
    learning_rate: float = 0.01
    nesterov: bool = False
    momentum: float = 0.0
    weight_decay: float = 0.0
    # 0 = off. Global-norm gradient clipping BEFORE the optimizer update
    # (TPU-first production knob, no reference counterpart): stochastic
    # regularized dynamics can hit one-step blow-ups late in training
    # (RESULTS.md SDE frontier: w_reg 30-100 destabilization events).
    gradient_clip_norm: float = 0.0
    scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)


@dataclass
class TrainConfig:
    total_steps: int = 10000
    evaluate_every: int = 2500
    resume: str = ""
    evaluate: bool = False
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    expt_subdir: str = ""
    expt_id: str = ""
    print_frequency: int = 100
    # multi-chip training (additive over the reference, SURVEY §2e):
    # 'none' = single device; 'gspmd' = DP(×TP) mesh sharding with the
    # reference-exact shared GLOBAL adaptive grid (parallel/sharded_train);
    # 'shardmap' = opt-in per-shard-grid DP that keeps the persistent
    # Pallas kernels engaged per chip (documented estimator deviation,
    # parallel/shardmap_train).
    data_parallel: str = "none"
    # 'model' mesh-axis size (tensor parallel over the dynamics Dense
    # layers); >1 requires data_parallel=gspmd.
    tensor_parallel: int = 1
    # K > 1 scans K optimizer steps inside ONE donated jit per host
    # dispatch (amortizes dispatch latency + host-side batch handling;
    # train.make_multi_train_step). Must divide print_frequency and
    # evaluate_every; 0 = auto (largest valid K <= 8 on the TPU backend,
    # 1 elsewhere — runner.resolve_steps_per_call). TPU-first addition —
    # no reference counterpart.
    steps_per_call: int = 1
    # N > 1 splits each batch into N sequential microbatches, accumulating
    # gradients in a lax.scan carry before ONE optimizer update (large
    # effective batches on one chip, O(1) memory in N). Must divide
    # dataset.train_batchsize; data_parallel='none' only. Composes with
    # steps_per_call. TPU-first addition — no reference counterpart.
    grad_accumulation: int = 1
    # N >= 2 keeps N batches placed on device ahead of the training loop
    # (async H2D overlaps the running step — harness.data.
    # prefetch_to_device). 0/1 = place-on-demand. Composes with
    # steps_per_call (whole K-stacks are prefetched) and data_parallel
    # (placement is the mesh-sharded/global one). TPU-first addition — no
    # reference counterpart (utils.jl's channel overlaps host assembly
    # only).
    device_prefetch: int = 2
    # decay > 0 maintains an exponential moving average of params inside
    # the fused step (ema' = ema·d + params·(1−d)); evaluation and
    # best-checkpoint selection then use the EMA weights (standard for
    # score-model/serving-quality training). data_parallel='none' only.
    # TPU-first addition — no reference counterpart.
    ema_decay: float = 0.0


@dataclass
class DatasetConfig:
    augment: bool = False
    data_root: str = ""
    # synthetic-fallback hardness: 'easy' saturates at 100% (smoke/perf),
    # 'hard' plateaus below ~93% (matched-accuracy science)
    difficulty: str = "easy"
    eval_batchsize: int = 64
    train_batchsize: int = 64


@dataclass
class ExperimentConfig:
    seed: int = 0
    loss: LossConfig = field(default_factory=LossConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)


def _from_dict(cls, data: dict):
    if not dataclasses.is_dataclass(cls):
        return data
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in (data or {}).items():
        if key not in fields:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        ftype = fields[key].type
        sub = _FIELD_TYPES.get((cls.__name__, key))
        if sub is not None and isinstance(value, dict):
            kwargs[key] = _from_dict(sub, value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


_FIELD_TYPES = {
    ("ExperimentConfig", "loss"): LossConfig,
    ("ExperimentConfig", "model"): ModelConfig,
    ("ExperimentConfig", "optimizer"): OptimizerConfig,
    ("ExperimentConfig", "train"): TrainConfig,
    ("ExperimentConfig", "dataset"): DatasetConfig,
    ("ModelConfig", "solver"): SolverConfig,
    ("OptimizerConfig", "scheduler"): LRSchedulerConfig,
}


def _parse_value(raw: str) -> Any:
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    # list values: --model.image_size=[8,8] or 8,8
    stripped = raw.strip()
    if stripped.startswith("[") and stripped.endswith("]"):
        inner = stripped[1:-1].strip()
        return [_parse_value(v.strip()) for v in inner.split(",")] if inner else []
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


def _apply_override(cfg, dotted: str, value: Any):
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise KeyError(f"unknown override key {dotted!r}")
        obj = getattr(obj, p)
    if not hasattr(obj, parts[-1]):
        raise KeyError(f"unknown override key {dotted!r}")
    setattr(obj, parts[-1], value)


def define_configuration(
    args: Optional[List[str]] = None, config_file: Optional[str] = None
) -> ExperimentConfig:
    """Load YAML config + ``--a.b.c=value`` CLI overrides."""
    data = {}
    if config_file:
        import yaml

        with open(config_file) as f:
            data = yaml.safe_load(f) or {}
    cfg = _from_dict(ExperimentConfig, data)
    for arg in args or []:
        if not arg.startswith("--") or "=" not in arg:
            raise ValueError(f"overrides must look like --a.b.c=value; got {arg!r}")
        key, raw = arg[2:].split("=", 1)
        _apply_override(cfg, key, _parse_value(raw))
    return cfg


def flatten_config(cfg, prefix: str = "") -> dict:
    """Flatten to a dot-keyed dict (for wandb/CSV export)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            out.update(flatten_config(v, key + "."))
        else:
            out[key] = v
    return out


def experiment_name(cfg: ExperimentConfig, config_name: str) -> str:
    """``config-<name>_regularizer-<mode>_seed-<seed>_id-<id>``
    (reference ``experiments/mnist_ode/main.jl:53-54``)."""
    return (
        f"config-{config_name}_regularizer-{cfg.model.regularize}"
        f"_seed-{cfg.seed}_id-{cfg.train.expt_id}"
    )
