"""The whole adaptive SRI/SOSRI solve of the NeuralDSDE family in one CUDA
launch, Brownian tree included.

Counterpart of ``localregneuralde_tpu/ops/pallas/fused_sde_solve.py``
(``persistent_sde_solve``, family ``("mlp", H)``). The family is the MNIST
SDE layer's (reference ``construct.jl:202-210``):

    drift(x)     = tanh(x·W1 + b1)·W2 + b2
    diffusion(x) = x·Wd + bd           (diagonal noise)

The kernel (``csrc/sde_solve.cu``) draws the virtual Brownian tree from the
counter-based Philox source of ``sde/brownian.py`` with the source's seed,
runs the I-controlled accept/reject loop, writes the saveat outputs by
linear interpolation on accepted steps, keeps the reservoir sample when
given uniforms, and with ``record_knots`` records the knots ``u`` and the
increments ``(dW, dZ)`` of the accepted steps into buffers of
``max_steps + 1`` and ``max_steps`` entries, which the stored adjoint's
sweep (``ops/cuda/fused_sde_sweep.py``) reads. The first dt (one drift
evaluation) is computed outside, as in the reference; NFE is drift
1 + 4·attempts, diffusion 4·attempts.

The plain version is the eager loop of ``sde/solve.py`` with the plain
family and any normal source; on a CPU tensor the wrapper runs it. On a CUDA
tensor the noise source must be ``PhiloxNormals``, whose numbers the kernel
draws itself (its uniforms bitwise, its normals to the inverse CDF's
rounding).

``precision`` has the reference's meaning (``'highest'``, ``'high'``, or
None/``'default'``, the backend default, which 'auto' resolves to at rtol
≥ 1e-4), and ``nn.basic.product_tier`` says what it computes on a device.
At the TF32 tier every drift and diffusion product (the first dt's drift
evaluation too) rounds its operands to TF32 and accumulates in FP32: the
kernel's ``lrnde_sde_solve_tf32`` on the tensor cores, the plain version
through ``nn.basic.tier_matmul``; the stage combinations, the error norm,
the controller and the tree stay FP32. A TF32 solve below rtol 1e-4
raises (``check_product_tier``). The wrapper's default is ``'highest'``:
a call that names no tier keeps the FP32 kernel, and the model names its
own; ``persistent_sde_solve.tier_launches`` counts the launches by tier.

Kernel 11 (``persistent_vpsde_solve``, the same ``csrc/sde_solve.cu``
instantiated for ``csrc/score.cuh::VpScore``) is the reference's
``persistent_vpsde_solve`` (family ``("vpsde", ...)``): the reverse-time
VP-SDE of the score sampler on the clock τ = t1 − t, with drift
½β(t)·u + β(t)·s_θ(u, t) and diffusion √β(t), s_θ a TDChain of Dense layers
(``match_td_score_chain``). It records no knots and keeps no reservoir; the
first drift evaluation and the dt heuristic run outside at τ = t0. The
kernels take any batch size (the reference declines B % 8 ≠ 0). Its
``precision`` is the family's (default ``'highest'``); at the TF32 tier
(``lrnde_vpsde_solve_tf32``, the reference sampler's backend default)
each layer's a·W_l[:-1] rounds its operands to TF32 and accumulates in
FP32; the time term t·W_l[-1], the biases and the β arithmetic stay FP32,
as in the reference's kernel and its pure twin
(``td_score_eval_plain(..., tier)``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ...nn.basic import (
    check_fp32_products,
    check_product_tier,
    product_tier,
    tier_matmul,
)
from ...sde.brownian import PhiloxNormals
from ...ode.solve import device_scalar
from ...sde.solve import SRI_SOLVERS, initial_dt, sde_loop
from . import _build
from .fused_mlp import count_launch, device_scalars
from .fused_solve import (
    CHAIN_MAX_LAYERS,
    CHAIN_SMEM_BYTES,
    check_reservoir,
    check_tensors,
    net_operands,
    reservoir_operands,
    round4,
    smem_bytes,
)


# csrc/sde.cuh: the rows of a row block (a CTA's unit, one error slot), the
# CTA of both SDE kernels (twelve warps: the hidden group of a product's
# H-wide outputs, then the diffusion group), the first port's CTA width
# whose error partial kernel 10 keeps; the deepest Brownian tree
# (csrc/sde_solve.cu::kMaxDepth) and the shared memory a block can have on
# an H100
SDE_ROWS = 4
SDE_HID_THREADS, SDE_THREADS = 256, 384
SDE_OLD_THREADS = 64
SDE_MAX_DEPTH = 30
SDE_SMEM_BYTES = 232448
# kernel 10's static shared memory (its control block, ``SdeCtl``, as
# ptxas reports it for every instantiation): a CTA's dynamic bytes and
# these together must fit a block (``lrnde_sde_solve_occupancy``)
SDE_STATIC_SMEM_BYTES = 2368


class SdeSolvePlan(NamedTuple):
    """Kernel 10's layout at (B, F, H), as ``csrc/sde_solve.cu`` lays it
    out: one CTA of ``threads`` a row block of ``rows`` rows, ``grid`` CTAs
    (at most the resident ones; a CTA then loops over the row blocks
    ``b ≡ blockIdx (mod grid)``); per attempt the descent's draws of the
    ``items`` (column pair, row) items spread over every thread when the
    descent is buffered, one thread an item combining its levels."""

    rows: int
    n_blocks: int
    grid: int
    threads: int
    hid_threads: int
    items: int             # (column pair, row) items of a row block
    buffered: bool         # the descent's draws in shared memory
    smem_bytes: int


def frag_floats(M: int, K: int) -> int:
    """Floats of the TF32 fragment copy of an M × K product operand
    (``csrc/sde.cuh::sde_frag_floats``): 16 × 8 tiles of 128 floats."""
    return -(-M // 16) * -(-K // 8) * 128


def frag_set_floats(F: int, H: int) -> int:
    """Floats of one set of the family's three fragment copies (W1 and W2
    and Wd, transposed or not)."""
    return frag_floats(H, F) + frag_floats(F, H) + frag_floats(F, F)


def sde_solve_smem_floats(F: int, H: int, tier: str = "fp32") -> int:
    """Floats of a kernel-10 CTA's dynamic shared memory
    (``csrc/sde_solve.cu::sde_solve_smem_floats``): the weights with rows
    padded by one float and the hidden rows (at ``"tf32"`` then, 16-byte
    aligned, the forward's fragment copies), the row block's 13 buffers of
    R·F floats and the reduction's (or the residuals'), then the descent's
    normals, a float4 each (level, item)."""
    R = SDE_ROWS
    weights = F * (H + 1) + H + H * (F + 1) + F + F * (F + 1) + F + R * H
    if tier == "tf32":
        weights = round4(weights) + frag_set_floats(F, H)
    items = R * (-(-F // 2))
    descent = items * (SDE_MAX_DEPTH + 1) if items < SDE_THREADS else 0
    return (round4(weights + 13 * R * F + max(SDE_THREADS, R * F))
            + 4 * descent)


def sde_solve_plan(B: int, F: int, H: int, resident=None,
                   tier: str = "fp32") -> SdeSolvePlan:
    """Kernel 10's layout for B rows at (F, H) and the product ``tier``;
    ``resident(smem_bytes)`` is the CTAs the card holds at once at that
    shared memory (the occupancy query; None: every row block resident).
    Raises ValueError where a CTA's shared memory, its dynamic bytes and
    the kernel's static ``SDE_STATIC_SMEM_BYTES``, exceeds an H100's
    block."""
    smem = 4 * sde_solve_smem_floats(F, H, tier)
    if smem + SDE_STATIC_SMEM_BYTES > SDE_SMEM_BYTES:
        raise ValueError(
            f"persistent_sde_solve: F={F}, H={H} needs {smem} bytes of "
            f"shared memory a CTA beside the kernel's static "
            f"{SDE_STATIC_SMEM_BYTES}, over {SDE_SMEM_BYTES} (the weights "
            f"stay in shared memory)")
    n_blocks = -(-B // SDE_ROWS)
    grid = n_blocks if resident is None else min(n_blocks, resident(smem))
    if grid < 1:
        raise ValueError(f"persistent_sde_solve: no CTA of {smem} bytes "
                         f"is resident")
    items = SDE_ROWS * (-(-F // 2))
    return SdeSolvePlan(SDE_ROWS, n_blocks, grid, SDE_THREADS,
                        SDE_HID_THREADS, items, items < SDE_THREADS, smem)


class SDEWeights(NamedTuple):
    """Dense weights of the family, ``(in, out)`` layout: ``w1`` (F, H),
    ``b1`` (H), ``w2`` (H, F), ``b2`` (F), ``wd`` (F, F), ``bd`` (F)."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    wd: torch.Tensor
    bd: torch.Tensor


def drift_plain(w: SDEWeights, x: torch.Tensor, tier: str = "fp32",
                grad_tier=None) -> torch.Tensor:
    """The family's drift, its products at ``tier`` and under autograd
    their transposes at ``grad_tier`` (default ``tier``;
    ``nn.basic.tier_matmul``)."""
    h = torch.tanh(tier_matmul(x, w.w1, tier, grad_tier) + w.b1)
    return tier_matmul(h, w.w2, tier, grad_tier) + w.b2


def diffusion_plain(w: SDEWeights, x: torch.Tensor, tier: str = "fp32",
                    grad_tier=None) -> torch.Tensor:
    """The family's diagonal diffusion at the tiers of ``drift_plain``."""
    return tier_matmul(x, w.wd, tier, grad_tier) + w.bd


def check_sde_operands(w: SDEWeights, *states: torch.Tensor) -> tuple:
    """Validate kernel operands: float32, contiguous, on one CUDA device,
    states (B, F) and weights of the family at F. Returns (B, F, H)."""
    B, F = states[0].shape
    H = w.b1.shape[0]
    shapes = {"w1": (F, H), "b1": (H,), "w2": (H, F), "b2": (F,),
              "wd": (F, F), "bd": (F,)}
    for name, t in list(zip(w._fields, w)) + [("state", s) for s in states]:
        want = shapes.get(name, (B, F))
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {want}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous float32")
        if t.device != states[0].device:
            raise ValueError(f"{name}: on {t.device}, state on {states[0].device}")
    if B < 1:
        raise ValueError("empty batch")
    return B, F, H


def persistent_sde_solve_plain(w: SDEWeights, u0, tspan, *, noise, rtol, atol,
                               solver, delta, saveat_arr, max_steps,
                               record_knots=False, reservoir=None,
                               brownian_depth=24, tier: str = "fp32"):
    """The plain version: the eager loop with the plain family, its
    products at the resolved ``tier``."""
    check_fp32_products(rtol, u0.device)
    check_product_tier(tier, rtol)
    t0, t_end = float(tspan[0]), float(tspan[1])
    dt_init = initial_dt(u0, drift_plain(w, u0, tier), rtol, atol, t0, t_end)
    out = sde_loop(
        lambda x, t: drift_plain(w, x, tier),
        lambda x, t: diffusion_plain(w, x, tier),
        u0, t0, t_end, dt_init, noise=noise, saveat=saveat_arr, rtol=rtol,
        atol=atol, solver=solver, delta=delta, max_steps=max_steps,
        reservoir=reservoir, brownian_depth=brownian_depth,
        record_knots=record_knots,
    )
    return dict(out, ts=saveat_arr)


def persistent_sde_solve(w: SDEWeights, u0: torch.Tensor, tspan, *, noise,
                         rtol: float, atol: float, solver: str, delta: float,
                         saveat_arr: torch.Tensor, max_steps: int,
                         record_knots=False, reservoir=None,
                         brownian_depth=24, precision="highest"):
    """Run the whole adaptive solve of the family from ``u0``, its products
    at ``precision``.

    Returns a dict of device tensors (no host sync): ``y_final``, ``ys``
    (n_save, B, F), ``naccept``, ``nreject``, ``natt``, ``success``,
    ``t_final``, ``ts``, ``reservoir_t`` and ``reservoir_u`` (None without
    ``reservoir``), and with ``record_knots`` ``knot_ts`` (max_steps + 1),
    ``knot_us`` (max_steps + 1, B, F), ``knot_dws`` and ``knot_dzs``
    (max_steps, B, F), valid up to ``naccept``. A CUDA tensor launches the
    kernel; a CPU tensor runs ``persistent_sde_solve_plain``. (A serving
    solve from a staged seed word is ``serving.sde_solve``, the registered
    operator ``lrnde::sde_solve`` that ``torch.export`` records.)
    """
    tier = product_tier(precision, u0.device)
    kw = dict(rtol=rtol, atol=atol, solver=solver, delta=delta,
              saveat_arr=saveat_arr, max_steps=max_steps,
              record_knots=record_knots, reservoir=reservoir,
              brownian_depth=brownian_depth)
    check_reservoir(reservoir, max_steps)
    if u0.device.type == "cpu":
        return persistent_sde_solve_plain(w, u0, tspan, noise=noise,
                                          tier=tier, **kw)
    if not isinstance(noise, PhiloxNormals):
        raise ValueError(
            "the SDE kernel draws its own Philox noise: a CUDA solve takes "
            f"a PhiloxNormals source, not {type(noise).__name__}"
        )
    if noise.shape != tuple(u0.shape) or noise.row_offset:
        raise ValueError(f"noise source of shape {noise.shape} from row "
                         f"{noise.row_offset}, state {tuple(u0.shape)}: the "
                         "kernel's counter rows start at 0")
    out = _launch_sde_solve(w, u0, noise.seed_word(u0.device), tspan,
                            tier=tier, **kw)
    count_launch(persistent_sde_solve, tier)
    return out


def _launch_sde_solve(w: SDEWeights, u0, seed, tspan, *, rtol, atol, solver,
                      delta, saveat_arr, max_steps, record_knots=False,
                      reservoir=None, brownian_depth=24, tier="fp32"):
    """One launch of kernel 10 on CUDA tensors at ``tier``, its Brownian
    tree drawn from the seed word ``seed`` (a one-element int32 tensor on
    the device); the return dict of ``persistent_sde_solve`` and
    ``stats``, the kernel's int32 counters (naccept, nreject, success,
    attempts), which the serving operator returns whole."""
    check_fp32_products(rtol, u0.device)
    check_product_tier(tier, rtol)
    if solver not in SRI_SOLVERS:
        raise ValueError(f"the SDE kernel runs {SRI_SOLVERS}, not {solver!r}")
    B, F, H = check_sde_operands(w, u0)
    plan = sde_solve_plan(B, F, H, tier=tier)
    tf32 = tier == "tf32"
    lib = _build.load_library()
    smem_query = (lib.lrnde_sde_solve_smem_floats_tf32 if tf32
                  else lib.lrnde_sde_solve_smem_floats)
    if (lib.lrnde_sde_rows_per_block(), lib.lrnde_sde_solve_threads(),
            4 * smem_query(F, H)) != (
            plan.rows, plan.threads, plan.smem_bytes):
        raise RuntimeError("persistent_sde_solve: the library's layout "
                           "differs from sde_solve_plan")
    t0, t_end = float(tspan[0]), float(tspan[1])
    dt_init = initial_dt(u0, drift_plain(w, u0, tier), rtol, atol, t0, t_end)
    sc = device_scalars([t0, t_end, dt_init], u0)
    saveat = saveat_arr.to(device=u0.device, dtype=torch.float32).contiguous()
    n_save = saveat.shape[0]
    dev = u0.device
    y_final = torch.empty_like(u0)
    ys = torch.empty((n_save, B, F), device=dev)
    stats_i = torch.empty(4, dtype=torch.int32, device=dev)
    stats_f = torch.empty(2, device=dev)
    unew = torch.empty_like(u0)
    wz = torch.empty((2, 2, B, F), device=dev)
    slots = torch.empty(2 * plan.n_blocks, device=dev)
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    rand, res_u = reservoir_operands(reservoir, u0)
    knots = {}
    if record_knots:
        knots = dict(
            knot_ts=torch.empty(max_steps + 1, device=dev),
            knot_us=torch.empty((max_steps + 1, B, F), device=dev),
            knot_dws=torch.empty((max_steps, B, F), device=dev),
            knot_dzs=torch.empty((max_steps, B, F), device=dev),
        )
    p = _build.ptr
    null = ctypes.c_void_p(0)
    opt = lambda t: null if t is None else p(t)  # noqa: E731
    entry = lib.lrnde_sde_solve_tf32 if tf32 else lib.lrnde_sde_solve
    err = entry(
        int(solver == "sosri"), p(u0), p(sc), p(saveat), n_save,
        *[p(x) for x in w], p(seed), int(brownian_depth),
        p(y_final), p(ys), p(stats_i), p(stats_f), p(unew), p(wz[0]),
        p(wz[1]), p(slots), p(barrier), opt(rand), opt(res_u),
        *[opt(knots.get(k)) for k in ("knot_ts", "knot_us", "knot_dws",
                                      "knot_dzs")],
        B, F, H, int(max_steps), float(rtol), float(atol), float(delta),
        1.0 / float(B * F), _build.stream_ptr(dev),
    )
    _build.check(lib, err, "persistent_sde_solve")
    return dict(
        y_final=y_final, ys=ys, naccept=stats_i[0], nreject=stats_i[1],
        natt=stats_i[3], success=stats_i[2].bool(), t_final=stats_f[0],
        ts=saveat_arr, stats=stats_i,
        reservoir_t=stats_f[1] if reservoir is not None else None,
        reservoir_u=res_u, **knots,
    )


persistent_sde_solve.tier_launches = {}


# ---------------------------------------------------------------------------
# the score network of the samplers (kernels 6 and 11)


class ScoreChainSpec(NamedTuple):
    """The shape of a ``TDChain`` of biased Dense layers ``Dense(d_i + 1 →
    d_{i+1}, act)`` with d_0 = d_L: the logical widths ``dims``, a tanh
    flag per layer ``acts`` and the layer names ``keys``. Its parameters
    are the list ``[W_0, b_0, W_1, b_1, ...]``, W_i the (d_i + 1, d_{i+1})
    TD matrix whose last row is the time weight."""

    dims: tuple
    acts: tuple
    keys: tuple


def match_td_score_chain(module) -> Optional[ScoreChainSpec]:
    """The spec of ``module`` when it is a ``TDChain`` of biased ``Dense``
    layers (layer i maps d_i + 1 → d_{i+1}, the time channel appended) with
    tanh or identity activations and d_0 = d_L ≥ 1; None otherwise (the
    reference's ``fused_sde_solve.py:763-794``; activations recognised by
    identity)."""
    from ...models.common import TDChain
    from ...nn.basic import _ACTIVATIONS, Dense

    if not isinstance(module, TDChain):
        return None
    items = list(module.layers.items())
    if not items or not all(isinstance(l, Dense) for _, l in items):
        return None
    ident = (_ACTIVATIONS[None], _ACTIVATIONS["identity"])
    dims, acts, keys = [items[0][1].in_dim - 1], [], []
    for key, layer in items:
        if not layer.use_bias or layer.in_dim != dims[-1] + 1:
            return None
        if layer.activation is torch.tanh:
            acts.append(True)
        elif any(layer.activation is fn for fn in ident):
            acts.append(False)
        else:
            return None
        dims.append(layer.out_dim)
        keys.append(key)
    if dims[0] != dims[-1] or dims[0] < 1:
        return None
    return ScoreChainSpec(tuple(dims), tuple(acts), tuple(keys))


def score_chain_params(module, chain: ScoreChainSpec) -> list:
    """The module's parameters in the kernels' order, ``[W_0, b_0, ...]``
    (the tensors themselves, not copies)."""
    layers = module.layers
    return [p for key in chain.keys for p in (layers[key].w, layers[key].b)]


def td_score_eval_plain(params, chain: ScoreChainSpec, x: torch.Tensor, t,
                        tier: str = "fp32"):
    """The score chain at time ``t`` (the reference's ``td_score_eval_pure``):
    layer i is ``act(a·W_i[:-1] + t·W_i[-1] + b_i)``, the TD matrix's last
    row the time weight, the product a·W_i[:-1] at ``tier``
    (``nn.basic.tier_matmul``) and the time term FP32. The plain versions
    of kernels 6 and 11 and their first evaluations outside the kernels."""
    a = x
    for i, act in enumerate(chain.acts):
        w = params[2 * i]
        z = tier_matmul(a, w[:-1], tier) + t * w[-1] + params[2 * i + 1]
        a = torch.tanh(z) if act else z
    return a


def score_limits(chain: ScoreChainSpec, query: str, *,
                 cuda=True) -> Optional[str]:
    """Why kernel 6 (``query`` ``'lrnde_pf_solve_smem_floats'``) or 11
    (``'lrnde_vpsde_solve_smem_floats'``) cannot take ``chain``, or None
    when it can: 1 to ``CHAIN_MAX_LAYERS`` layers and the network with a
    CTA's working rows within ``CHAIN_SMEM_BYTES`` of shared memory (not
    asked with ``cuda=False``)."""
    L = len(chain.dims) - 1
    if not 1 <= L <= CHAIN_MAX_LAYERS:
        return f"score chain: {L} layers, the kernels take 1 to {CHAIN_MAX_LAYERS}"
    if cuda:
        need = smem_bytes(chain.dims, query)
        if not 0 < need <= CHAIN_SMEM_BYTES:
            return (f"score chain {chain.dims}: needs {need} bytes of shared "
                    f"memory per CTA, the kernels take at most "
                    f"{CHAIN_SMEM_BYTES}")
    return None


def check_score_operands(params, chain: ScoreChainSpec, u0, query: str):
    """Validate a score kernel's operands: float32, contiguous, on the
    state's CUDA device, the state (B, F) and the TD matrices matching
    ``chain.dims``, the chain inside ``score_limits``. Returns (B, F)."""
    reason = score_limits(chain, query)
    if reason is not None:
        raise ValueError(reason)
    d = chain.dims
    shapes = [s for i in range(len(d) - 1)
              for s in ((d[i] + 1, d[i + 1]), (d[i + 1],))]
    if len(params) != len(shapes):
        raise ValueError(f"{len(params)} parameters for a score chain of "
                         f"{len(shapes) // 2} layers")
    B, F = u0.shape
    check_tensors([(f"param {i}", p, want)
                   for i, (p, want) in enumerate(zip(params, shapes))]
                  + [("state", u0, (B, d[0]))], u0)
    if B < 1:
        raise ValueError("empty batch")
    return B, F


def score_operands(params, chain: ScoreChainSpec, beta_min, beta_max, t1):
    """The score kernels' C operands: the pointer array (W_0, b_0, ...), the
    dims array, L, the tanh mask and the schedule (β_min, Δβ, t1) as the
    reference rounds it (Δβ in double, then float32)."""
    return net_operands(params, chain.dims, chain.acts) + (
        float(beta_min), float(beta_max) - float(beta_min), float(t1))


def vpsde_dynamics(params, chain: ScoreChainSpec, beta_min, beta_max, t1,
                   tier: str = "fp32"):
    """Kernel 11's drift and diffusion on the τ clock, ``f(x, τ)`` and
    ``g(x, τ)``: with t = t1 − τ and β = β_min + t·Δβ, the drift
    ½β·x + β·s_θ(x, t) (the reference sampler's −(−½β·x − β·s), rounded
    alike; the score's products at ``tier``) and the diffusion √β."""
    d_beta = float(beta_max) - float(beta_min)

    def drift(x, tau):
        t = float(t1) - device_scalar(tau, x)
        b = float(beta_min) + t * d_beta
        return (0.5 * b) * x + b * td_score_eval_plain(params, chain, x, t,
                                                        tier)

    def diffusion(x, tau):
        t = float(t1) - device_scalar(tau, x)
        return torch.sqrt(float(beta_min) + t * d_beta) * torch.ones_like(x)

    return drift, diffusion


def persistent_vpsde_solve_plain(params, chain: ScoreChainSpec, u0, tspan, *,
                                 noise, rtol, atol, solver, delta, saveat_arr,
                                 max_steps, beta_min, beta_max, t1,
                                 brownian_depth=24, tier: str = "fp32"):
    """The plain version of kernel 11: the eager SDE loop with the plain
    score chain, its products at the resolved ``tier``, and the same noise
    source."""
    check_fp32_products(rtol, u0.device)
    check_product_tier(tier, rtol)
    t0, t_end = float(tspan[0]), float(tspan[1])
    drift, diffusion = vpsde_dynamics(params, chain, beta_min, beta_max, t1,
                                      tier)
    dt_init = initial_dt(u0, drift(u0, t0), rtol, atol, t0, t_end)
    out = sde_loop(
        drift, diffusion, u0, t0, t_end, dt_init, noise=noise,
        saveat=saveat_arr, rtol=rtol, atol=atol, solver=solver, delta=delta,
        max_steps=max_steps, brownian_depth=brownian_depth,
    )
    return dict(out, ts=saveat_arr)


def persistent_vpsde_solve(params, chain: ScoreChainSpec, u0: torch.Tensor,
                           tspan, *, noise, rtol: float, atol: float,
                           solver: str, delta: float, saveat_arr: torch.Tensor,
                           max_steps: int, beta_min: float, beta_max: float,
                           t1: float, brownian_depth=24, precision="highest"):
    """Run the whole adaptive reverse VP-SDE solve from ``u0`` (kernel 11),
    the score's products at ``precision``.

    ``params`` are the score chain's ``[W_0, b_0, ...]`` and ``chain`` its
    ``match_td_score_chain`` spec. Returns a dict of device tensors (no host
    sync): ``y_final``, ``ys`` (n_save, B, F), ``naccept``, ``nreject``,
    ``natt``, ``success``, ``t_final`` and ``ts``; NFE is drift 1 +
    4·natt, diffusion 4·natt (``sde.solve.solution_from``). A CUDA tensor
    launches the kernel, which draws the Brownian tree of the
    ``PhiloxNormals`` source ``noise`` itself; a CPU tensor runs
    ``persistent_vpsde_solve_plain``. Any batch size and number of saveat
    times. A TF32 solve below rtol 1e-4 raises (``check_product_tier``).
    """
    tier = product_tier(precision, u0.device)
    kw = dict(noise=noise, rtol=rtol, atol=atol, solver=solver, delta=delta,
              saveat_arr=saveat_arr, max_steps=max_steps, beta_min=beta_min,
              beta_max=beta_max, t1=t1, brownian_depth=brownian_depth)
    if u0.device.type == "cpu":
        return persistent_vpsde_solve_plain(params, chain, u0, tspan,
                                            tier=tier, **kw)
    check_fp32_products(rtol, u0.device)
    check_product_tier(tier, rtol)
    tf32 = tier == "tf32"
    if solver not in SRI_SOLVERS:
        raise ValueError(f"the SDE kernel runs {SRI_SOLVERS}, not {solver!r}")
    if not isinstance(noise, PhiloxNormals):
        raise ValueError(
            "the SDE kernel draws its own Philox noise: a CUDA solve takes "
            f"a PhiloxNormals source, not {type(noise).__name__}"
        )
    B, F = check_score_operands(
        params, chain, u0,
        "lrnde_vpsde_solve_smem_floats" + ("_tf32" if tf32 else ""))
    if noise.shape != (B, F) or noise.row_offset:
        raise ValueError(f"noise source of shape {noise.shape} from row "
                         f"{noise.row_offset}, state {(B, F)}: the kernel's "
                         "counter rows start at 0")
    lib = _build.load_library()
    t0, t_end = float(tspan[0]), float(tspan[1])
    drift, _ = vpsde_dynamics(params, chain, beta_min, beta_max, t1, tier)
    dt_init = initial_dt(u0, drift(u0, t0), rtol, atol, t0, t_end)
    sc = device_scalars([t0, t_end, dt_init], u0)
    saveat = saveat_arr.to(device=u0.device, dtype=torch.float32).contiguous()
    n_save = saveat.shape[0]
    dev = u0.device
    n_blocks = -(-B // lib.lrnde_score_rows_per_block())
    y_final = torch.empty_like(u0)
    ys = torch.empty((n_save, B, F), device=dev)
    stats_i = torch.empty(4, dtype=torch.int32, device=dev)
    stats_f = torch.empty(2, device=dev)
    unew = torch.empty_like(u0)
    wz = torch.empty((2, 2, B, F), device=dev)
    slots = torch.empty(2 * n_blocks, device=dev)
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    seed = noise.seed_word(dev)
    p = _build.ptr
    entry = lib.lrnde_vpsde_solve_tf32 if tf32 else lib.lrnde_vpsde_solve
    err = entry(
        int(solver == "sosri"), p(u0), p(sc), p(saveat), n_save,
        *score_operands(params, chain, beta_min, beta_max, t1), p(seed),
        int(brownian_depth), p(y_final), p(ys), p(stats_i), p(stats_f),
        p(unew), p(wz[0]), p(wz[1]), p(slots), p(barrier), B, int(max_steps),
        float(rtol), float(atol), float(delta), 1.0 / float(B * F),
        _build.stream_ptr(dev),
    )
    _build.check(lib, err, "persistent_vpsde_solve")
    count_launch(persistent_vpsde_solve, tier)
    return dict(
        y_final=y_final, ys=ys, naccept=stats_i[0], nreject=stats_i[1],
        natt=stats_i[3], success=stats_i[2].bool(), t_final=stats_f[0],
        ts=saveat_arr,
    )


persistent_vpsde_solve.tier_launches = {}
