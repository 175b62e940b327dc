from .config import (
    ExperimentConfig,
    define_configuration,
    experiment_name,
    flatten_config,
)
from .construct import construct_loss, construct_model, construct_optimizer
from .data import load_mnist, one_hot, synthetic_classification
from .losses import accuracy, logitcrossentropy
from .schedulers import Constant, ExponentialDecay
from .optim import Adamax, OptimizerSpec
from .train import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
    warmup_model,
)

__all__ = [
    "Adamax",
    "Constant",
    "ExperimentConfig",
    "ExponentialDecay",
    "TrainState",
    "accuracy",
    "construct_loss",
    "construct_model",
    "construct_optimizer",
    "create_train_state",
    "define_configuration",
    "experiment_name",
    "flatten_config",
    "load_mnist",
    "logitcrossentropy",
    "make_eval_step",
    "make_train_step",
    "one_hot",
    "OptimizerSpec",
    "synthetic_classification",
    "warmup_model",
]
