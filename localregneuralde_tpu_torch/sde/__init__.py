from .brownian import PhiloxNormals, VirtualBrownianTree
from .solve import SDESolution, sdesolve
from .step import SDEStepResult, sri_step
from .stored_adjoint import stored_sdesolve
from .tableaus import SOSRITableau, SRIW1Tableau, get_sri_tableau

__all__ = [
    "PhiloxNormals",
    "SDESolution",
    "SDEStepResult",
    "SOSRITableau",
    "SRIW1Tableau",
    "VirtualBrownianTree",
    "get_sri_tableau",
    "sdesolve",
    "sri_step",
    "stored_sdesolve",
]
