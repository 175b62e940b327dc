from .config import (
    ExperimentConfig,
    define_configuration,
    experiment_name,
    flatten_config,
)
from .construct import construct_loss, construct_model
from .data import load_mnist, one_hot, synthetic_classification
from .losses import accuracy, logitcrossentropy
from .schedulers import Constant, ExponentialDecay
from .train import TrainState, create_train_state, make_eval_step

__all__ = [
    "Constant",
    "ExperimentConfig",
    "ExponentialDecay",
    "TrainState",
    "accuracy",
    "construct_loss",
    "construct_model",
    "create_train_state",
    "define_configuration",
    "experiment_name",
    "flatten_config",
    "load_mnist",
    "logitcrossentropy",
    "make_eval_step",
    "one_hot",
    "synthetic_classification",
]
