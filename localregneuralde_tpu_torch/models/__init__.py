from .common import TDChain, diffeqsol_to_array
from .neural_ode import NeuralODE

__all__ = ["NeuralODE", "TDChain", "diffeqsol_to_array"]
