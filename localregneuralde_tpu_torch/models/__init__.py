from .common import (
    AugmenterLayer,
    ReparameterizeLayer,
    TDChain,
    diffeqsol_to_array,
    diffeqsol_to_timeseries,
)
from .latent_ode import LatentGRUCell
from .neural_ode import NeuralODE
from .neural_sde import NeuralDSDE

__all__ = [
    "AugmenterLayer",
    "LatentGRUCell",
    "NeuralDSDE",
    "NeuralODE",
    "ReparameterizeLayer",
    "TDChain",
    "diffeqsol_to_array",
    "diffeqsol_to_timeseries",
]
