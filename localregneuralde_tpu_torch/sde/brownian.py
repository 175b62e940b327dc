"""The virtual Brownian tree and its counter-based normal source.

Counterpart of ``localregneuralde_tpu/sde/brownian.py``. ``W(t)`` is a pure
function of the noise source and t: a fixed-depth Brownian-bridge descent
over [t0, t1], so a rejected step that retries with a smaller dt sees the
same path. W and the independent Z of the SRI step's I_(1,0) term share the
descent: every node draws one stacked ``(2, B, F)`` normal, channel 0 for W
and channel 1 for Z. The node numbering is the JAX package's: the endpoint
at node 1, and at each level the midpoint of node n from node ``2·n + 2``,
the walk going to ``2·n + 1`` (right) or ``2·n`` (left).

The normals come from a pluggable source, ``normals(node) -> (2, B, F)``.
The default, ``PhiloxNormals``, is counter-based: Philox4x32-10 of the
counter ``(column pair, row, node, 0)`` under the key ``(seed, 0)``; the
four output words are W and Z of the pair's two columns. Each word becomes
a 24-bit half-ulp-centred uniform clamped to ``[1e-7, 1 − 1e-7]`` and a
normal through Acklam's inverse CDF (the JAX kernel's transform,
``ops/pallas/fused_sde_solve.py:187-248``). A row's noise depends on the
row index, not on the batch size or on how the rows are split over CUDA
blocks, and the uniforms here are bitwise those of the persistent CUDA
solve (``csrc/sde.cuh``), which computes the same words with ``uint32``;
here they are int64 tensors masked to 32 bits.

The descent's scalars (τ, the cell ends, the bridge scales) are float32 on
the host, rounded as the kernel rounds them.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10

# Acklam's rational approximation of the standard-normal quantile
ICDF_A = (-3.969683028665376e+01, 2.209460984245205e+02,
          -2.759285104469687e+02, 1.383577518672690e+02,
          -3.066479806614716e+01, 2.506628277459239e+00)
ICDF_B = (-5.447609879822406e+01, 1.615858368580409e+02,
          -1.556989798598866e+02, 6.680131188771972e+01,
          -1.328068155288572e+01)
ICDF_C = (-7.784894002430293e-03, -3.223964580411365e-01,
          -2.400758277161838e+00, -2.549732539343734e+00,
          4.374664141464968e+00, 2.938163982698783e+00)
ICDF_D = (7.784695709041462e-03, 3.224671290700398e-01,
          2.445134137142996e+00, 3.754408661907416e+00)
ICDF_P_LOW = 0.02425
UNIFORM_EPS = 1e-7


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a·m for a in [0, 2³²) (int64 tensor) and a
    32-bit constant m, without overflowing int64: a is split into 16-bit
    halves, so every partial product stays below 2⁴⁹."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter (c0, c1, c2, c3) (int64 tensors or ints
    in [0, 2³²), broadcast together) under the key (k0, k1). Returns the
    four output words as int64 tensors in [0, 2³²)."""
    c = [torch.as_tensor(x, dtype=torch.int64) for x in (c0, c1, c2, c3)]
    k0, k1 = int(k0) & _MASK32, int(k1) & _MASK32
    for r in range(PHILOX_ROUNDS):
        hi0, lo0 = _mulhilo(c[0], PHILOX_M0)
        hi1, lo1 = _mulhilo(c[2], PHILOX_M1)
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0 = (k0 + PHILOX_W0) & _MASK32
        k1 = (k1 + PHILOX_W1) & _MASK32
    return c


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits → float32 uniform: the top 24 bits, half-ulp
    centred, clamped to [1e-7, 1 − 1e-7] (the largest pattern rounds to
    exactly 1.0f, where the inverse CDF has its pole)."""
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24) + 2.0 ** -25
    return torch.clamp(u, UNIFORM_EPS, 1.0 - UNIFORM_EPS)


def norm_icdf(p: torch.Tensor) -> torch.Tensor:
    """Standard-normal quantile of p ∈ (0, 1), elementwise, in float32."""
    a, b, c, d = ICDF_A, ICDF_B, ICDF_C, ICDF_D
    q = p - 0.5
    r = q * q
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
    den = ((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1.0
    x_c = num * q / den
    pt = torch.minimum(p, 1.0 - p)
    qt = torch.sqrt(-2.0 * torch.log(torch.clamp_min(pt, 1e-30)))
    nu = ((((c[0] * qt + c[1]) * qt + c[2]) * qt + c[3]) * qt + c[4]) * qt + c[5]
    de = (((d[0] * qt + d[1]) * qt + d[2]) * qt + d[3]) * qt + 1.0
    x_t = torch.where(p < 0.5, 1.0, -1.0) * (nu / de)
    return torch.where(pt < ICDF_P_LOW, x_t, x_c)


class PhiloxNormals:
    """The default normal source of a solve: ``normals(node)`` is a
    ``(2, B, F)`` float32 tensor on ``device``, a pure function of
    ``(seed, node)`` and of each element's (channel, row, column)."""

    def __init__(self, seed: int, batch: int, features: int, device=None):
        self.seed = int(seed) & _MASK32
        self.shape = (batch, features)
        pairs = -(-features // 2)
        self._pair = torch.arange(pairs, dtype=torch.int64, device=device)[None, :]
        self._row = torch.arange(batch, dtype=torch.int64, device=device)[:, None]

    def uniforms(self, node: int) -> torch.Tensor:
        """The (2, B, F) uniforms behind ``self(node)``."""
        B, F = self.shape
        w = philox4x32(self._pair, self._row, int(node), 0, self.seed, 0)
        words = [bits_to_uniform(x.expand(B, -1)) for x in w]
        # words 0, 1: W of columns 2p, 2p+1; words 2, 3: Z of the same
        wz = [torch.stack(words[i:i + 2], dim=-1).reshape(B, -1)[:, :F]
              for i in (0, 2)]
        return torch.stack(wz)

    def __call__(self, node: int) -> torch.Tensor:
        return norm_icdf(self.uniforms(node))


def _f32(x) -> np.float32:
    return np.float32(float(x))


class VirtualBrownianTree:
    """(W, Z): [t0, t1] → R^(B, F) with W(t0) = Z(t0) = 0, per-element
    independent paths, from the normal source ``normals``."""

    def __init__(self, normals, t0: float, t1: float, depth: int = 24):
        self.normals = normals
        self.t0 = _f32(t0)
        self.span = np.float32(_f32(t1) - self.t0)
        self.depth = int(depth)

    def tau(self, t) -> np.float32:
        """Normalised time of t, clipped to [0, 1], in float32."""
        return np.float32(min(max((_f32(t) - self.t0) / self.span,
                                  np.float32(0.0)), np.float32(1.0)))

    def wz(self, t) -> torch.Tensor:
        """The stacked ``(2, B, F)`` values (W(t), Z(t)): one bridge descent
        of ``depth`` levels, then linear interpolation in the last cell.

        As the CUDA kernel's descent (``csrc/sde_solve.cu::descend``): the
        walk to τ first (the cells, bridge scales and children, the same for
        every element), then each level's normals, then the levels combined
        in order. Every value rounds as a level-by-level loop's would."""
        tau = self.tau(t)
        half, quarter = np.float32(0.5), np.float32(0.25)
        a, b, node = np.float32(0.0), np.float32(1.0), 1
        walk = []  # per level: (node drawn, bridge scale, went right)
        for _ in range(self.depth):
            m = (a + b) * half
            scale = np.sqrt((b - a) * quarter * self.span)
            right = bool(tau >= m)
            walk.append((2 * node + 2, scale, right))
            if right:
                a, node = m, 2 * node + 1
            else:
                b, node = m, 2 * node
        eps = [self.normals(n) for n, _, _ in walk]
        wb = self.normals(1) * float(np.sqrt(self.span))
        wa = torch.zeros_like(wb)
        for e, (_, scale, right) in zip(eps, walk):
            wm = (wa + wb) * 0.5 + e * float(scale)
            if right:
                wa = wm
            else:
                wb = wm
        frac = (tau - a) / (b - a) if b > a else np.float32(0.0)
        return wa + (wb - wa) * float(frac)
