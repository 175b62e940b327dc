"""Four-stage stochastic Runge–Kutta (SRI) tableaus for diagonal Itô noise.

Counterpart of ``localregneuralde_tpu/sde/tableaus.py``: Rößler's SRIW1
(strong order 1.5) and the stability-optimised ``SOSRITableau``, whose drift
block was re-derived for a ~5x longer negative-real stability interval and
whose diffusion block is SRIW1's. The coefficients are the JAX package's
Python floats, so both packages round them to float32 alike.

Stage structure (s = 4):

    H0_i = u + dt·Σ A0_ij k_j + χ2·Σ B0_ij g_j
    H1_i = u + dt·Σ A1_ij k_j + √dt·Σ B1_ij g_j
    u⁺   = u + dt·Σ α_i k_i + dW·Σ β1_i g_i + χ1·Σ β2_i g_i
             + χ2·Σ β3_i g_i + χ3·Σ β4_i g_i

with χ1 = (dW² − dt)/(2√dt), χ2 = (dW + dZ/√3)/2, χ3 = (dW³ − 3·dW·dt)/(6·dt).
"""
from __future__ import annotations


class SRIW1Tableau:
    """Rößler SRIW1: strong order 1.5 for diagonal/commutative Itô noise."""

    order = 1.5

    # drift stage coefficients (A0, strictly lower triangular)
    a021 = 3 / 4
    a031 = 0.0
    a032 = 0.0
    a041 = 0.0
    a042 = 0.0
    a043 = 0.0
    # drift coefficients of the diffusion arguments (A1)
    a121 = 1 / 4
    a131 = 1.0
    a132 = 0.0
    a141 = 0.0
    a142 = 0.0
    a143 = 1 / 4
    # B0 (χ2 weights inside the H0 stages)
    b021 = 3 / 2
    b031 = 0.0
    b032 = 0.0
    b041 = 0.0
    b042 = 0.0
    b043 = 0.0
    # B1 (√dt weights inside the H1 stages)
    b121 = 1 / 2
    b131 = -1.0
    b132 = 0.0
    b141 = -5.0
    b142 = 3.0
    b143 = 1 / 2
    # stage times
    c02 = 3 / 4
    c03 = 0.0
    c04 = 0.0
    c11 = 0.0
    c12 = 1 / 4
    c13 = 1.0
    c14 = 1 / 4
    # solution weights
    alpha1 = 1 / 3
    alpha2 = 2 / 3
    alpha3 = 0.0
    alpha4 = 0.0
    beta11, beta12, beta13, beta14 = -1.0, 4 / 3, 2 / 3, 0.0
    beta21, beta22, beta23, beta24 = -1.0, 4 / 3, -1 / 3, 0.0
    beta31, beta32, beta33, beta34 = 2.0, -4 / 3, -2 / 3, 0.0
    beta41, beta42, beta43, beta44 = -2.0, 5 / 3, -2 / 3, 1.0


class SOSRITableau(SRIW1Tableau):
    """Stability-optimised four-stage SRI: the drift block is re-derived
    (R(z) = 1 + z + z²/2 + p3·z³ + p4·z⁴, stable on [−10.16, 0]); the
    diffusion block is SRIW1's."""

    a021 = 0.5
    a031 = 0.0
    a032 = 0.75
    a041 = 0.0
    a042 = 0.0
    a043 = 1.0
    b021 = 1.5513640431410758
    b031 = 0.0
    b032 = 0.0
    b041 = 0.0
    b042 = 0.0
    b043 = 0.0
    c02 = 0.5
    c03 = 0.75
    c04 = 1.0
    alpha1 = 0.12308703268250232
    alpha2 = 0.6445940296355466
    alpha3 = 0.2184638099988976
    alpha4 = 0.0138551276830535


def get_sri_tableau(solver: str):
    """Tableau of an SRI-family solver name (``'sosri'`` or ``'sri'``)."""
    return SOSRITableau if solver == "sosri" else SRIW1Tableau

