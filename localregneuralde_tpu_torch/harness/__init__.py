from .config import (
    ExperimentConfig,
    define_configuration,
    experiment_name,
    flatten_config,
)
from .construct import (
    construct_loss,
    construct_model,
    construct_optimizer,
    construct_time_series,
    resolve_device,
)
from .data import (
    Dataloader,
    get_classification_data,
    load_cifar10,
    load_mnist,
    make_dataloader,
    one_hot,
    synthetic_classification,
    synthetic_physionet,
)
from .losses import (
    accuracy,
    kl_divergence,
    log_likelihood_loss,
    logitcrossentropy,
)
from .schedulers import Constant, ExponentialDecay
from .optim import Adamax, OptimizerSpec
from .loop import resolve_steps_per_call
from .train import (
    TrainState,
    create_train_state,
    init_ema,
    make_eval_step,
    make_multi_train_step,
    make_train_step,
    swap_ema_params,
    warmup_model,
)

__all__ = [
    "Adamax",
    "Constant",
    "Dataloader",
    "ExperimentConfig",
    "ExponentialDecay",
    "TrainState",
    "accuracy",
    "construct_loss",
    "construct_model",
    "construct_optimizer",
    "construct_time_series",
    "create_train_state",
    "define_configuration",
    "experiment_name",
    "flatten_config",
    "get_classification_data",
    "init_ema",
    "kl_divergence",
    "log_likelihood_loss",
    "load_cifar10",
    "load_mnist",
    "logitcrossentropy",
    "make_dataloader",
    "make_eval_step",
    "make_multi_train_step",
    "make_train_step",
    "one_hot",
    "OptimizerSpec",
    "resolve_device",
    "resolve_steps_per_call",
    "synthetic_classification",
    "swap_ema_params",
    "synthetic_physionet",
    "warmup_model",
]
