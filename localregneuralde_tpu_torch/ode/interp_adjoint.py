"""The interpolating continuous adjoint (the reference's default
sensitivity, ``InterpolatingAdjoint(autojacvec=ZygoteVJP())``).

Counterpart of ``localregneuralde_tpu/ode/interp_adjoint.py``
(``odesolve(..., adjoint='interpolating')``):

- **Forward**: the eager loop with ``adjoint='none'``, recording the knots
  ``(t, u, k1)`` at t0 and at every accepted step. The reference keeps
  them in static ``max_steps`` buffers (2 × max_steps × state); here they
  are kept as the solve accepts, so the memory is that of the accepted
  steps, with the same numbers.
- **Backward**: one adaptive solve in reversed time of ``(a_u, a_p)``
  (``ode/adjoint.py::reverse_segments``), reading u(t) from the cubic
  Hermite interpolant over the knots (values and FSAL derivatives, the
  interval found by ``searchsorted``), one autograd VJP of the dynamics per
  evaluation, the saveat cotangents injected segment by segment.

``odesolve(..., adjoint='interpolating')`` runs it
(``ode/adjoint.py::continuous_odesolve``); this module holds the
interpolant.
"""
from __future__ import annotations

import torch


def hermite_at(ts, us, ks, t):
    """u(t) from the cubic Hermite over the knots ``(ts, us, ks)`` (times
    ascending), clamped to the knot interval that holds t."""
    n = ts.shape[0] - 1
    if n < 1:
        return us[0]
    i = torch.clamp(torch.searchsorted(ts, t.reshape(1), right=True) - 1,
                    0, n - 1).reshape(())
    t_a, t_b = ts[i], ts[i + 1]
    h = torch.clamp_min(t_b - t_a, 1e-30)
    th = torch.clamp((t - t_a) / h, 0.0, 1.0)
    h00 = 2 * th ** 3 - 3 * th ** 2 + 1
    h10 = th ** 3 - 2 * th ** 2 + th
    h01 = -2 * th ** 3 + 3 * th ** 2
    h11 = th ** 3 - th ** 2
    return h00 * us[i] + h10 * h * ks[i] + h01 * us[i + 1] + h11 * h * ks[i + 1]
