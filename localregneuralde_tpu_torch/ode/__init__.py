from .controller import PIController, initial_step_size
from .multistep import adams_solve
from .solve import ODESolution, odesolve
from .step import Tsit5StepResult, regularization_value, tsit5_step
from .tableaus import Tsit5Tableau, tsit5_interp_weights, tsit5_interpolate

__all__ = [
    "PIController",
    "adams_solve",
    "initial_step_size",
    "ODESolution",
    "odesolve",
    "Tsit5StepResult",
    "regularization_value",
    "tsit5_step",
    "Tsit5Tableau",
    "tsit5_interp_weights",
    "tsit5_interpolate",
]
