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
from .score_sde import (
    VPSDE,
    gaussian_score_fn,
    module_score_fn,
    sample_probability_flow,
    sample_vpsde,
)

__all__ = [
    "AugmenterLayer",
    "LatentGRUCell",
    "NeuralDSDE",
    "NeuralODE",
    "ReparameterizeLayer",
    "TDChain",
    "VPSDE",
    "diffeqsol_to_array",
    "diffeqsol_to_timeseries",
    "gaussian_score_fn",
    "module_score_fn",
    "sample_probability_flow",
    "sample_vpsde",
]
