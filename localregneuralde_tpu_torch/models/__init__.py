from .common import TDChain, diffeqsol_to_array
from .neural_ode import NeuralODE
from .neural_sde import NeuralDSDE

__all__ = ["NeuralDSDE", "NeuralODE", "TDChain", "diffeqsol_to_array"]
