"""Tsitouras 5(4) tableau and its free interpolant.

Counterpart of ``localregneuralde_tpu/ode/tableaus.py``. The coefficients are
plain Python floats; combined with float32 tensors they act in float32, as
the reference's weakly typed constants do. The CUDA kernels carry the same
values in ``csrc/tdmlp.cuh``.
"""
from __future__ import annotations


class Tsit5Tableau:
    """Tsitouras 5(4) coefficients. Each row of A sums to c, b sums to 1,
    btilde (= b − bhat) sums to 0, and b_i(θ=1) equals b_i."""

    order = 5
    c1 = 0.161
    c2 = 0.327
    c3 = 0.9
    c4 = 0.9800255409045097

    a21 = 0.161
    a31 = -0.008480655492356989
    a32 = 0.335480655492357
    a41 = 2.8971530571054935
    a42 = -6.359448489975075
    a43 = 4.3622954328695815
    a51 = 5.325864828439257
    a52 = -11.748883564062828
    a53 = 7.4955393428898365
    a54 = -0.09249506636175525
    a61 = 5.86145544294642
    a62 = -12.92096931784711
    a63 = 8.159367898576159
    a64 = -0.071584973281401
    a65 = -0.028269050394068383
    a71 = 0.09646076681806523
    a72 = 0.01
    a73 = 0.4798896504144996
    a74 = 1.379008574103742
    a75 = -3.290069515436081
    a76 = 2.324710524099774

    btilde1 = -0.00178001105222577714
    btilde2 = -0.0008164344596567469
    btilde3 = 0.007880878010261995
    btilde4 = -0.1447110071732629
    btilde5 = 0.5823571654525552
    btilde6 = -0.45808210592918697
    btilde7 = 0.015151515151515152  # = 1/66

    stability_size = 3.5068


def tsit5_interp_weights(theta):
    """Dense-output weights b_i(θ) with ``u(t + θ·dt) = u + dt·Σ b_i(θ)·k_i``;
    ``theta`` is a float or a tensor (the weights then have its shape)."""
    t = theta
    t2 = t * t
    b1 = -1.0530884977290216 * t * (t - 1.3299890189751412) * (
        t2 - 1.4364028541716351 * t + 0.7139816917074209
    )
    b2 = 0.1017 * t2 * (t2 - 2.1966568338249754 * t + 1.2949852507374631)
    b3 = 2.490627285651252793 * t2 * (
        t2 - 2.38535645472061657 * t + 1.57803468208092486
    )
    b4 = -16.54810288924490272 * (t - 1.21712927295533244) * (
        t - 0.61620406037800089
    ) * t2
    b5 = 47.37952196281928122 * (t - 1.203071208372362603) * (
        t - 0.658047292653547382
    ) * t2
    b6 = -34.87065786149660974 * (t - 1.2) * (t - 0.666666666666666667) * t2
    b7 = 2.5 * (t - 1.0) * (t - 0.6) * t2
    return (b1, b2, b3, b4, b5, b6, b7)


def tsit5_interpolate(u_prev, dt, ks, theta):
    """The Tsit5 interpolant at relative position ``theta`` ∈ [0, 1]. With a
    1-D ``theta`` of length n the result gains a leading axis of length n."""
    bs = tsit5_interp_weights(theta)
    if getattr(theta, "ndim", 0) == 1:
        shape = (-1,) + (1,) * ks[0].ndim
        bs = tuple(b.reshape(shape) for b in bs)
    acc = bs[0] * ks[0]
    for b, k in zip(bs[1:], ks[1:]):
        acc = acc + b * k
    return u_prev + dt * acc
