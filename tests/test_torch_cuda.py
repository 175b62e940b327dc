"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without an NVIDIA GPU (a CUDA kernel has no CPU
mode). This file imports no JAX, so it runs on a machine with only the
port's dependencies; ``--noconftest`` skips the suite's JAX set-up:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from localregneuralde_tpu_torch.ops.cuda import (
    TDMLPWeights,
    fused_tdmlp,
    fused_tsit5_step,
    persistent_tsit5_solve,
    persistent_tsit5_solve_plain,
    tdmlp_plain,
    tsit5_step_plain,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _card_setup(device, batch, features, hidden, seed=0):
    from localregneuralde_tpu_torch.nn import glorot_uniform

    g = torch.Generator().manual_seed(seed)
    w = TDMLPWeights(
        glorot_uniform((features + 1, hidden), g),
        0.1 * torch.randn(hidden, generator=g),
        glorot_uniform((hidden + 1, features), g),
        0.1 * torch.randn(features, generator=g),
    )
    x = torch.rand(batch, features, generator=g)
    return TDMLPWeights(*(t.to(device) for t in w)), x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 32, 16), (13, 40, 7), (512, 784, 100)])
def test_kernels_match_plain_on_card(cuda_device, shape):
    # FP32 sums run in another order than cuBLAS's: at (512, 784, 100) the
    # measured max-abs is 6.0e-7 (tdmlp) and 6.6e-7 (step) on an H100 80GB
    # HBM3 (700 W)
    w, x = _card_setup(cuda_device, *shape)
    y = fused_tdmlp(w, x, 0.3)
    torch.testing.assert_close(y, tdmlp_plain(w, x, 0.3), atol=1e-5, rtol=0)
    t = torch.tensor(0.2, device=cuda_device)
    dt = torch.tensor(0.05, device=cuda_device)
    k1 = tdmlp_plain(w, x, 0.2)
    for a, b in zip(fused_tsit5_step(w, x, t, dt, k1),
                    tsit5_step_plain(w, x, t, dt, k1)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_persistent_kernel_matches_loop_and_is_deterministic(cuda_device):
    w, x = _card_setup(cuda_device, 64, 784, 100)
    kw = dict(rtol=1e-4, atol=1e-4, max_steps=64,
              saveat_arr=torch.tensor([0.0, 0.5, 1.0], device=cuda_device))
    out = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
    ref = persistent_tsit5_solve_plain(w, x, (0.0, 1.0), **kw)
    torch.testing.assert_close(out["ys"], ref["ys"], atol=3e-4, rtol=0)
    assert abs(int(out["naccept"]) - int(ref["naccept"])) <= 1
    assert abs(int(out["nfe"]) - int(ref["nfe"])) <= 12
    assert bool(out["success"]) and bool(ref["success"])
    again = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
    assert torch.equal(out["ys"], again["ys"])
    assert int(out["nfe"]) == int(again["nfe"])


def _rel(a, b):
    """max-abs difference relative to the largest magnitude of b."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _launches(wrapper):
    """A TD-MLP wrapper's kernel launches, summed over its tiers."""
    return sum(wrapper.tier_launches.values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 32, 16), (13, 40, 7), (512, 784, 100)])
def test_step_bwd_matches_plain_on_card(cuda_device, shape):
    # FP32 sums in another order than the autograd VJP's cuBLAS products:
    # relative to the largest magnitude, well under 1e-4
    from localregneuralde_tpu_torch.ops.cuda import (
        fused_step_bwd, fused_step_bwd_plain,
    )

    w, x = _card_setup(cuda_device, *shape)
    t = torch.tensor(0.2, device=cuda_device)
    dt = torch.tensor(0.05, device=cuda_device)
    k1 = tdmlp_plain(w, x, t)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    cts = [torch.randn(x.shape, generator=g, device=cuda_device)
           for _ in range(9)]
    ours = fused_step_bwd(w, x, t, dt, k1, cts)
    ref = fused_step_bwd_plain(w, x, t, dt, k1, cts)
    for a, b in zip([ours[1], ours[2], *ours[0]], [ref[1], ref[2], *ref[0]]):
        assert _rel(a, b) <= 1e-4
    again = fused_step_bwd(w, x, t, dt, k1, cts)
    for a, b in zip(again[0], ours[0]):
        assert torch.equal(a, b)


def _recorded(w, x, rtol, **kw):
    return persistent_tsit5_solve(
        w, x, (0.0, 1.0), rtol=rtol, atol=rtol, max_steps=64,
        saveat_arr=torch.tensor([0.5, 1.0], device=x.device),
        record_knots=True, **kw,
    )


@pytest.mark.cuda
def test_persistent_recording_on_card(cuda_device):
    w, x = _card_setup(cuda_device, 64, 784, 100)
    plain = persistent_tsit5_solve(
        w, x, (0.0, 1.0), rtol=1e-6, atol=1e-6, max_steps=64,
        saveat_arr=torch.tensor([0.5, 1.0], device=cuda_device),
    )
    rec = _recorded(w, x, 1e-6, knot_stride=4)
    n = int(rec["naccept"])
    assert n == int(plain["naccept"]) and n >= 5
    assert torch.equal(rec["y_final"], plain["y_final"])
    assert torch.equal(rec["knot_us"][n], rec["y_final"])
    ts = rec["knot_ts"]
    for i in range(n):
        step = fused_tsit5_step(w, rec["knot_us"][i], ts[i], ts[i + 1] - ts[i],
                                tdmlp_plain(w, rec["knot_us"][i], ts[i]))
        torch.testing.assert_close(step[0], rec["knot_us"][i + 1], atol=1e-5,
                                   rtol=0)
    for c in range(n // 4 + 1):
        assert torch.equal(rec["ckpt_us"][c], rec["knot_us"][4 * c])


@pytest.mark.cuda
def test_sweeps_match_plain_on_card(cuda_device):
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_stored_sweep, persistent_stored_sweep_plain,
        persistent_two_level_sweep,
    )

    w, x = _card_setup(cuda_device, 64, 784, 100)
    rec = _recorded(w, x, 1e-6, knot_stride=4)
    n = int(rec["naccept"])
    g = torch.Generator(device=cuda_device).manual_seed(5)
    ct_ys = torch.randn((2, 64, 784), generator=g, device=cuda_device)
    ct_y = torch.randn((64, 784), generator=g, device=cuda_device)
    args = (w, rec["knot_ts"], rec["knot_us"], rec["naccept"],
            torch.tensor([0.5, 1.0], device=cuda_device), ct_ys, ct_y)
    dense = persistent_stored_sweep(*args)
    ref = persistent_stored_sweep_plain(*args)
    for a, b in zip([dense[0], dense[1], *dense[2]],
                    [ref[0], ref[1], *ref[2]]):
        assert _rel(a, b) <= 1e-4
    again = persistent_stored_sweep(*args)
    for a, b in zip([again[0], *again[2]], [dense[0], *dense[2]]):
        assert torch.equal(a, b)
    (win, replay) = persistent_two_level_sweep(
        *args, rec["ckpt_ts"], rec["ckpt_us"], rec["ckpt_ks"],
        rec["ckpt_dts"], rec["ckpt_qolds"], t_end=1.0, rtol=1e-6, atol=1e-6,
        max_steps=64, stride=4, dense_cap=2, return_replay=True,
    )
    assert n > 2
    assert torch.equal(replay[:5], rec["knot_us"][:5])
    for a, b in zip([win[0], win[1], *win[2]],
                    [dense[0], dense[1], *dense[2]]):
        assert _rel(a, b) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 40, 7), (64, 784, 100),
                                   (520, 785, 100), (13, 785, 7),
                                   (64, 784, 150)])
def test_cluster_sweep_ragged_on_card(cuda_device, shape):
    """The cluster sweep where rows do not fill the last row block of 36
    (B = 13, 64, 520), slices are odd or short (F = 40: 5 a CTA; 785: 99
    and a last slice of 92), H = 7 or 100, and H = 150, whose gradients go
    to the clusters' partials in global memory: dense and two-level against
    the plain sweep, bitwise repeatable, two-level equal to dense, and the
    layout the library reports equal to ``sweep_plan``'s."""
    from localregneuralde_tpu_torch.ops.cuda import (
        _build, persistent_stored_sweep, persistent_stored_sweep_plain,
        persistent_two_level_sweep,
    )
    from localregneuralde_tpu_torch.ops.cuda.fused_solve_bwd import (
        sweep_plan,
    )

    B, F, H = shape
    lib = _build.load_library()
    plan = sweep_plan(B, F, H)
    assert lib.lrnde_sweep_smem_floats(F, H) * 4 == plan.smem_bytes
    w, x = _card_setup(cuda_device, B, F, H, seed=3)
    rec = _recorded(w, x, 1e-6, knot_stride=2)
    n = int(rec["naccept"])
    assert n > 2
    g = torch.Generator(device=cuda_device).manual_seed(5)
    ct_ys = torch.randn((2, B, F), generator=g, device=cuda_device)
    ct_y = torch.randn((B, F), generator=g, device=cuda_device)
    args = (w, rec["knot_ts"], rec["knot_us"], rec["naccept"],
            torch.tensor([0.5, 1.0], device=cuda_device), ct_ys, ct_y)
    tl = (rec["ckpt_ts"], rec["ckpt_us"], rec["ckpt_ks"], rec["ckpt_dts"],
          rec["ckpt_qolds"])
    kw = dict(t_end=1.0, rtol=1e-6, atol=1e-6, max_steps=64, stride=2)

    def flat(out):
        return [out[0], out[1], *out[2]]

    dense = flat(persistent_stored_sweep(*args))
    ref = flat(persistent_stored_sweep_plain(*args))
    for a, b in zip(dense, ref):
        assert _rel(a, b) <= 1e-4
    on_path = flat(persistent_two_level_sweep(*args, *tl, **kw, dense_cap=n))
    win, replay = persistent_two_level_sweep(*args, *tl, **kw, dense_cap=2,
                                             return_replay=True)
    win = flat(win)
    assert torch.equal(replay[:3], rec["knot_us"][:3])
    for a, b in zip(win, dense):
        assert _rel(a, b) <= 1e-6
    for a, b in zip(on_path, dense):
        assert torch.equal(a, b)
    again = flat(persistent_stored_sweep(*args))
    win_again = flat(persistent_two_level_sweep(*args, *tl, **kw,
                                                dense_cap=2))
    for a, b in zip(again + win_again, dense + win):
        assert torch.equal(a, b)


def _sde_setup(device, batch, seed=0, features=32, hidden=64):
    from localregneuralde_tpu_torch.ops.cuda import SDEWeights

    g = torch.Generator().manual_seed(seed)
    n = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    w = SDEWeights(0.3 * n(features, hidden), 0.1 * n(hidden),
                   0.3 * n(hidden, features), 0.1 * n(features),
                   0.05 * n(features, features), 0.01 + 0.01 * n(features))
    x = 0.5 * n(batch, features)
    return SDEWeights(*(t.to(device) for t in w)), x.to(device)


def _sde_kw(device, batch, features=32, **extra):
    from localregneuralde_tpu_torch.sde import PhiloxNormals

    return dict(noise=PhiloxNormals(5, batch, features, device=device),
                rtol=0.14, atol=0.14, solver="sosri", delta=1 / 6,
                saveat_arr=torch.tensor([0.5, 1.0], device=device),
                max_steps=64, **extra)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 13, 512, 1000])
def test_sde_solve_matches_plain_on_card(cuda_device, batch):
    # the uniforms are bitwise the plain version's; the normals differ by
    # the inverse CDF's logf in the tails and the products by their FP32
    # summation order, and the path is Hölder-1/2 in the step times, so
    # states agree to 1e-3 (tests/test_torch_sde.py) with equal step counts
    # up to an accept flip at the boundary
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_sde_solve, persistent_sde_solve_plain,
    )

    w, x = _sde_setup(cuda_device, batch)
    kw = _sde_kw(cuda_device, batch, record_knots=True,
                 reservoir=torch.rand(64, device=cuda_device))
    out = persistent_sde_solve(w, x, (0.0, 1.0), **kw)
    ref = persistent_sde_solve_plain(w, x, (0.0, 1.0), **kw)
    assert bool(out["success"]) and bool(ref["success"])
    assert abs(int(out["naccept"]) - int(ref["naccept"])) <= 1
    if int(out["natt"]) == int(ref["natt"]):
        torch.testing.assert_close(out["ys"], ref["ys"], atol=1e-3, rtol=0)
    again = persistent_sde_solve(w, x, (0.0, 1.0), **kw)
    assert torch.equal(out["ys"], again["ys"])
    n = int(out["naccept"])
    ts = out["knot_ts"][: n + 1]
    j = int(torch.argmin((ts[:n] - out["reservoir_t"]).abs()))
    assert torch.equal(out["knot_us"][j], out["reservoir_u"])
    assert float(ts[0]) == 0.0 and float(ts[n]) == 1.0
    assert torch.equal(out["knot_us"][n], out["y_final"])


@pytest.mark.cuda
@pytest.mark.parametrize("features, hidden", [(13, 40), (33, 70)])
def test_sde_solve_odd_widths_on_card(cuda_device, features, hidden):
    # kernel 10's generic instantiation (widths read at run time) against
    # the eager loop, with the library's layout against sde_solve_plan
    import ctypes

    from localregneuralde_tpu_torch.ops.cuda import (
        _build, persistent_sde_solve, persistent_sde_solve_plain,
    )
    from localregneuralde_tpu_torch.ops.cuda.fused_sde_solve import (
        sde_solve_plan,
    )

    lib = _build.load_library()
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    out = (ctypes.c_int * 2)()
    op = ctypes.cast(out, ctypes.c_void_p)
    for B in (7, 410, 4096):
        assert lib.lrnde_sde_solve_grid(features, hidden, B, op) == 0
        plan = sde_solve_plan(B, features, hidden,
                              lambda smem: out[1] * n_sm)
        assert out[0] == plan.grid
    assert 4 * lib.lrnde_sde_solve_smem_floats(features, hidden) == (
        plan.smem_bytes)
    w, x = _sde_setup(cuda_device, 37, features=features, hidden=hidden)
    kw = _sde_kw(cuda_device, 37, features=features, record_knots=True)
    got = persistent_sde_solve(w, x, (0.0, 1.0), **kw)
    ref = persistent_sde_solve_plain(w, x, (0.0, 1.0), **kw)
    assert bool(got["success"]) and bool(ref["success"])
    assert abs(int(got["naccept"]) - int(ref["naccept"])) <= 1
    if int(got["natt"]) == int(ref["natt"]):
        torch.testing.assert_close(got["ys"], ref["ys"], atol=1e-3, rtol=0)
    again = persistent_sde_solve(w, x, (0.0, 1.0), **kw)
    assert torch.equal(got["ys"], again["ys"])


@pytest.mark.cuda
@pytest.mark.parametrize("features, hidden", [(32, 16), (32, 64), (13, 40)])
def test_sde_solve_is_resident_beside_its_static_block(cuda_device, features,
                                                       hidden):
    # kernel 10's static shared memory is the plan's, and every
    # instantiation a launch takes is resident once its opt-in is granted:
    # at F = 32, H = 16 the dynamic bytes stay under 48 KB but not beside
    # the static control block
    import ctypes

    from localregneuralde_tpu_torch.ops.cuda import _build
    from localregneuralde_tpu_torch.ops.cuda.fused_sde_solve import (
        SDE_STATIC_SMEM_BYTES, sde_solve_plan,
    )

    lib = _build.load_library()
    out = (ctypes.c_int * 7)()
    op = ctypes.cast(out, ctypes.c_void_p)
    for sosri in (0, 1):
        for tier in ("fp32", "tf32"):
            assert lib.lrnde_sde_solve_occupancy(
                features, hidden, sosri, int(tier == "tf32"), op) == 0
            static, _, _, _, after, dyn, _ = list(out)
            assert static == SDE_STATIC_SMEM_BYTES
            assert dyn == sde_solve_plan(64, features, hidden,
                                         tier=tier).smem_bytes
            assert after >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("features, hidden", [(32, 64), (13, 40)])
def test_sde_solve_grid_matches_plan_on_card(cuda_device, features, hidden):
    # kernel 10's grid at the resident CTAs the card reports, against
    # sde_solve_plan at the batches of tests/test_torch_sde_solve_plan.py
    import ctypes

    from localregneuralde_tpu_torch.ops.cuda import _build
    from localregneuralde_tpu_torch.ops.cuda.fused_sde_solve import (
        SDE_THREADS, sde_solve_plan,
    )

    lib = _build.load_library()
    assert lib.lrnde_sde_solve_threads() == SDE_THREADS
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    out = (ctypes.c_int * 2)()
    op = ctypes.cast(out, ctypes.c_void_p)
    for B in (7, 13, 410, 512, 1000, 4096):
        assert lib.lrnde_sde_solve_grid(features, hidden, B, op) == 0
        assert out[1] >= 1
        plan = sde_solve_plan(B, features, hidden,
                              lambda smem: out[1] * n_sm)
        assert out[0] == plan.grid
        assert plan.smem_bytes == 4 * lib.lrnde_sde_solve_smem_floats(
            features, hidden)


@pytest.mark.cuda
def test_sde_sweep_matches_plain_on_card(cuda_device):
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_sde_solve, persistent_sde_sweep, persistent_sde_sweep_plain,
    )

    w, x = _sde_setup(cuda_device, 64)
    kw = _sde_kw(cuda_device, 64, record_knots=True)
    out = persistent_sde_solve(w, x, (0.0, 1.0), **kw)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    args = (out["knot_ts"], out["knot_us"], out["knot_dws"], out["knot_dzs"],
            out["naccept"], kw["saveat_arr"],
            torch.randn((2, 64, 32), generator=g, device=cuda_device),
            torch.randn((64, 32), generator=g, device=cuda_device))
    ours = persistent_sde_sweep(w, *args, solver="sosri", delta=1 / 6)
    ref = persistent_sde_sweep_plain(w, *args, solver="sosri", delta=1 / 6)
    for a, b in zip([ours[0], *ours[1]], [ref[0], *ref[1]]):
        assert _rel(a, b) <= 1e-4
    again = persistent_sde_sweep(w, *args, solver="sosri", delta=1 / 6)
    for a, b in zip([again[0], *again[1]], [ours[0], *ours[1]]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_persistent_reservoir_on_card(cuda_device):
    w, x = _card_setup(cuda_device, 64, 784, 100)
    u = torch.rand(64, device=cuda_device)
    rec = _recorded(w, x, 1e-4, reservoir=u)
    n = int(rec["naccept"])
    ts = rec["knot_ts"][:n]
    j = int(torch.argmin((ts - rec["reservoir_t"]).abs()))
    assert float(ts[j]) == float(rec["reservoir_t"]) < 1.0
    assert torch.equal(rec["knot_us"][j], rec["reservoir_u"])


def _chain_setup(device, batch, features=20, hidden=40, layers=8, seed=0):
    """The latent ODE's generative chain (leading tanh, ``layers`` tanh
    Dense layers alternating features -> hidden -> features) with Glorot
    weights and small biases, and a state batch."""
    from localregneuralde_tpu_torch.nn import glorot_uniform
    from localregneuralde_tpu_torch.ops.cuda import DenseChainSpec

    g = torch.Generator().manual_seed(seed)
    dims = [features] + [hidden if i % 2 == 0 else features
                         for i in range(layers)]
    params = []
    for i in range(layers):
        params += [glorot_uniform((dims[i], dims[i + 1]), g),
                   0.1 * torch.randn(dims[i + 1], generator=g)]
    chain = DenseChainSpec(tuple(dims), (True,) * layers, True)
    x = torch.randn(batch, features, generator=g)
    return [p.to(device) for p in params], chain, x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [7, 13, 410, 512, 1000])
def test_chain_solve_matches_plain_on_card(cuda_device, batch):
    # kernel 5 against the eager loop with the plain chain: FP32 sums in
    # another order, so at rtol 1e-4 the two agree step for step up to an
    # ulp-level accept flip; the saveat times are unsorted and one is t0.
    # B = 7, 13 and 410 end in a partial 4-row block; 1000 rows are 250
    # blocks, more than an H100's SMs
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_chain_solve, persistent_chain_solve_plain,
    )

    params, chain, x = _chain_setup(cuda_device, batch)
    saveat = torch.tensor([1.0, 0.0, 0.3, 0.7, 0.5], device=cuda_device)
    kw = dict(rtol=1e-4, atol=1e-4, max_steps=256, saveat_arr=saveat)
    out = persistent_chain_solve(params, chain, x, (0.0, 1.0), **kw)
    ref = persistent_chain_solve_plain(params, chain, x, (0.0, 1.0), **kw)
    assert bool(out["success"]) and bool(ref["success"])
    assert abs(int(out["naccept"]) - int(ref["naccept"])) <= 1
    assert abs(int(out["nfe"]) - int(ref["nfe"])) <= 12
    torch.testing.assert_close(out["ys"], ref["ys"], atol=2e-4, rtol=0)
    assert torch.equal(out["ys"][1], x)
    again = persistent_chain_solve(params, chain, x, (0.0, 1.0), **kw)
    assert torch.equal(out["ys"], again["ys"])
    assert int(out["nfe"]) == int(again["nfe"])


@pytest.mark.cuda
def test_chain_recording_and_sweeps_on_card(cuda_device):
    # the knots of kernel 5 reconstruct their steps; kernel 9 against the
    # autograd sweep on those knots (FP32 sums in another order: relative
    # 1e-4), bitwise from run to run, and its two-level branch replays
    # kernel 5's windows bitwise, so it matches the dense branch
    from localregneuralde_tpu_torch.ode.step import tsit5_step
    from localregneuralde_tpu_torch.ops.cuda import (
        chain_eval, persistent_chain_solve, persistent_chain_sweep,
        persistent_chain_sweep_plain,
    )

    params, chain, x = _chain_setup(cuda_device, 64)
    saveat = torch.linspace(0.0, 1.0, 7, device=cuda_device)
    rec = persistent_chain_solve(params, chain, x, (0.0, 1.0), rtol=1e-6,
                                 atol=1e-6, saveat_arr=saveat, max_steps=64,
                                 record_knots=True, knot_stride=4)
    n = int(rec["naccept"])
    assert n > 4 and bool(rec["success"])
    ts = rec["knot_ts"]
    f = lambda u, t, st: (chain_eval(params, chain, u), st)  # noqa: E731
    for i in range(n):
        u = rec["knot_us"][i]
        step = tsit5_step(f, u, ts[i], ts[i + 1] - ts[i], f(u, 0, None)[0],
                          None)
        torch.testing.assert_close(step.u_new, rec["knot_us"][i + 1],
                                   atol=1e-5, rtol=0)
    for c in range(n // 4 + 1):
        assert torch.equal(rec["ckpt_us"][c], rec["knot_us"][4 * c])
    g = torch.Generator(device=cuda_device).manual_seed(5)
    ct_ys = torch.randn((7, 64, 20), generator=g, device=cuda_device)
    ct_y = torch.randn((64, 20), generator=g, device=cuda_device)
    args = (params, chain, rec["knot_ts"], rec["knot_us"], rec["naccept"],
            saveat, ct_ys, ct_y)
    dense = persistent_chain_sweep(*args)
    ref = persistent_chain_sweep_plain(*args)
    flat = lambda o: [o[0], o[1], *o[2]]  # noqa: E731
    for a, b in zip(flat(dense), flat(ref)):
        assert _rel(a, b) <= 1e-4
    again = persistent_chain_sweep(*args)
    for a, b in zip(flat(again), flat(dense)):
        assert torch.equal(a, b)
    ctx = {k: rec[k] for k in rec if k.startswith("ckpt_")}
    ctx.update(t_end=1.0, rtol=1e-6, atol=1e-6, max_steps=64, stride=4,
               dense_cap=2)
    win, replay = persistent_chain_sweep(*args, two_level_ctx=ctx,
                                         return_replay=True)
    assert torch.equal(replay[:5], rec["knot_us"][:5])
    for a, b in zip(flat(win), flat(dense)):
        assert _rel(a, b) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [7, 410, 1000])
def test_chain_sweeps_at_ragged_batches_on_card(cuda_device, batch):
    # kernel 9's dense and two-level branches against the autograd sweep on
    # kernel 5's knots, bitwise from run to run; the two-level replay repeats
    # the forward bitwise (at B = 1000 a two-level CTA may hold two blocks,
    # so its rows loop)
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_chain_solve, persistent_chain_sweep,
        persistent_chain_sweep_plain,
    )

    params, chain, x = _chain_setup(cuda_device, batch, seed=batch)
    saveat = torch.tensor([0.9, 0.0, 0.25, 0.5, 1.0], device=cuda_device)
    rec = persistent_chain_solve(params, chain, x, (0.0, 1.0), rtol=1e-5,
                                 atol=1e-5, saveat_arr=saveat, max_steps=64,
                                 record_knots=True, knot_stride=3)
    n = int(rec["naccept"])
    assert n > 3 and bool(rec["success"])
    g = torch.Generator(device=cuda_device).manual_seed(batch)
    ct_ys = torch.randn((5, batch, 20), generator=g, device=cuda_device)
    ct_y = torch.randn((batch, 20), generator=g, device=cuda_device)
    args = (params, chain, rec["knot_ts"], rec["knot_us"], rec["naccept"],
            saveat, ct_ys, ct_y)
    flat = lambda o: [o[0], o[1], *o[2]]  # noqa: E731
    dense = persistent_chain_sweep(*args)
    ref = persistent_chain_sweep_plain(*args)
    for a, b in zip(flat(dense), flat(ref)):
        assert _rel(a, b) <= 1e-4
    ctx = {k: rec[k] for k in rec if k.startswith("ckpt_")}
    ctx.update(t_end=1.0, rtol=1e-5, atol=1e-5, max_steps=64, stride=3,
               dense_cap=2)
    win, replay = persistent_chain_sweep(*args, two_level_ctx=ctx,
                                         return_replay=True)
    m = min(n, 3)
    assert torch.equal(replay[:m + 1], rec["knot_us"][:m + 1])
    # the per-row carries match bitwise; the gradients agree to FP32
    # rounding, since at B = 1000 a two-level CTA holds two blocks and so
    # groups the partials otherwise (measured 1.04e-6 on an H100)
    for a, b in zip(flat(win)[:2], flat(dense)[:2]):
        assert torch.equal(a, b)
    for a, b in zip(flat(win)[2:], flat(dense)[2:]):
        assert _rel(a, b) <= 1e-5
    again = persistent_chain_sweep(*args, two_level_ctx=ctx)
    for a, b in zip(flat(again), flat(win)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("features, hidden", [(13, 30), (20, 70)])
def test_chain_kernels_at_odd_widths_on_card(cuda_device, features, hidden):
    # widths that are not multiples of 4 (the sums' last, partial float4)
    # and a layer wider than 64 (three outputs a lane): kernel 5 against
    # the eager loop, kernel 9 dense and two-level against the autograd
    # sweep, the replay bitwise the forward
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_chain_solve, persistent_chain_solve_plain,
        persistent_chain_sweep, persistent_chain_sweep_plain,
    )

    params, chain, x = _chain_setup(cuda_device, 37, features, hidden,
                                    layers=4)
    saveat = torch.tensor([0.5, 1.0, 0.2], device=cuda_device)
    kw = dict(rtol=1e-4, atol=1e-4, max_steps=128, saveat_arr=saveat)
    out = persistent_chain_solve(params, chain, x, (0.0, 1.0), **kw)
    ref = persistent_chain_solve_plain(params, chain, x, (0.0, 1.0), **kw)
    assert bool(out["success"]) and bool(ref["success"])
    assert abs(int(out["naccept"]) - int(ref["naccept"])) <= 1
    torch.testing.assert_close(out["ys"], ref["ys"], atol=2e-4, rtol=0)
    rec = persistent_chain_solve(params, chain, x, (0.0, 1.0), rtol=1e-6,
                                 atol=1e-6, saveat_arr=saveat, max_steps=128,
                                 record_knots=True, knot_stride=3)
    n = int(rec["naccept"])
    assert n > 3
    g = torch.Generator(device=cuda_device).manual_seed(features)
    ct_ys = torch.randn((3, 37, features), generator=g, device=cuda_device)
    ct_y = torch.randn((37, features), generator=g, device=cuda_device)
    args = (params, chain, rec["knot_ts"], rec["knot_us"], rec["naccept"],
            saveat, ct_ys, ct_y)
    flat = lambda o: [o[0], o[1], *o[2]]  # noqa: E731
    dense = persistent_chain_sweep(*args)
    for a, b in zip(flat(dense), flat(persistent_chain_sweep_plain(*args))):
        assert _rel(a, b) <= 1e-4
    ctx = {k: rec[k] for k in rec if k.startswith("ckpt_")}
    ctx.update(t_end=1.0, rtol=1e-6, atol=1e-6, max_steps=128, stride=3,
               dense_cap=2)
    win, replay = persistent_chain_sweep(*args, two_level_ctx=ctx,
                                         return_replay=True)
    assert torch.equal(replay[:4], rec["knot_us"][:4])
    for a, b in zip(flat(win), flat(dense)):
        assert _rel(a, b) <= 1e-6


@pytest.mark.cuda
def test_chain_sweep_fp64_error_on_card(cuda_device):
    # kernel 9's weight gradients against the float64 plain sweep on the
    # PhysioNet chain's knots (chip_smoke.py's [chain sweep fp64] inputs):
    # within twice the error of the kernel before its redesign
    import chip_smoke
    from localregneuralde_tpu_torch.ode.stored_adjoint import knot_layout
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_chain_solve, persistent_chain_sweep,
        persistent_chain_sweep_plain,
    )

    params, chain, u0, saveat, _, _, _ = chip_smoke.chain_inputs(cuda_device)
    dense_cap, _, stride = knot_layout(10000)
    tol = chip_smoke.LATENT_TOL
    rec = persistent_chain_solve(params, chain, u0, (0.0, 1.0), rtol=tol,
                                 atol=tol, saveat_arr=saveat, max_steps=10000,
                                 record_knots=True, knot_dense_cap=dense_cap,
                                 knot_stride=stride)
    g = torch.Generator(device=cuda_device).manual_seed(13)
    ct_ys = torch.randn((saveat.shape[0], *u0.shape), generator=g,
                        device=cuda_device)
    ct_y = torch.randn(u0.shape, generator=g, device=cuda_device)
    args = (params, chain, rec["knot_ts"], rec["knot_us"], rec["naccept"],
            saveat, ct_ys, ct_y)
    args64 = ([p.double() for p in params], chain) + tuple(
        a.double() if a.is_floating_point() else a for a in args[2:])
    grads = persistent_chain_sweep(*args)[2]
    ref = persistent_chain_sweep_plain(*args64)[2]
    err = max(_rel(a.double(), b) for a, b in zip(grads, ref))
    assert err <= 2 * chip_smoke.K9_FP64_BEFORE


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(20, 40, 20, 40, 20, 40, 20, 40, 20),
                                  (13, 7, 13), (64, 96, 64, 96, 64)])
def test_chain_grid_matches_plan_on_card(cuda_device, dims):
    # the library's shared memory and grids against chain_plan's model:
    # the same bytes a CTA at one block, and grids that cover every block
    import ctypes

    from localregneuralde_tpu_torch.ops.cuda import _build
    from localregneuralde_tpu_torch.ops.cuda.fused_solve import (
        CHAIN_ROWS, CHAIN_SMEM_BYTES, chain_smem_floats,
    )

    lib = _build.load_library()
    L = len(dims) - 1
    arr = (ctypes.c_int * (L + 1))(*dims)
    dp = ctypes.cast(arr, ctypes.c_void_p)
    assert lib.lrnde_chain_solve_smem_floats(dp, L) == chain_smem_floats(dims, 1)
    assert lib.lrnde_chain_sweep_smem_floats(dp, L) == chain_smem_floats(
        dims, 1, sweep=True)
    # (64, 96, 64, 96, 64): kernel 9's weights, their transpose and the
    # gradient partial outgrow a CTA's shared memory, and its grid is refused
    sweep_fits = (4 * chain_smem_floats(dims, 1, sweep=True)
                  <= CHAIN_SMEM_BYTES)
    assert sweep_fits == (dims != (64, 96, 64, 96, 64))
    out = (ctypes.c_int * 2)()
    op = ctypes.cast(out, ctypes.c_void_p)
    for B in (7, 410, 512, 1000, 5000):
        n_blk = -(-B // CHAIN_ROWS)
        assert lib.lrnde_chain_solve_grid(dp, L, B, op) == 0
        assert out[1] == -(-n_blk // out[0])
        if not sweep_fits:
            assert lib.lrnde_chain_sweep_grid(dp, L, B, 0, op) != 0
            continue
        assert lib.lrnde_chain_sweep_grid(dp, L, B, 0, op) == 0
        assert tuple(out) == (1, n_blk)
        assert lib.lrnde_chain_sweep_grid(dp, L, B, 1, op) == 0
        assert out[1] == -(-n_blk // out[0])


def _conv_setup(device, batch, height, width, cs, ch, seed=0):
    """The CIFAR conv dynamics' weights (Glorot convs, BatchNorm affine
    near 1 and 0), running stats and a state batch (B, H, W, Cs)."""
    from localregneuralde_tpu_torch.nn import glorot_uniform
    from localregneuralde_tpu_torch.ops.cuda import ConvFamilySpec, ConvWeights

    g = torch.Generator().manual_seed(seed)

    def conv(cin, cout):
        return glorot_uniform((3, 3, cin, cout), g, fan_in=9 * cin,
                              fan_out=cout)

    w = ConvWeights(conv(cs + 1, ch), 1 + 0.1 * torch.randn(ch, generator=g),
                    0.1 * torch.randn(ch, generator=g), conv(ch + 1, ch),
                    1 + 0.1 * torch.randn(ch, generator=g),
                    0.1 * torch.randn(ch, generator=g), conv(ch + 1, cs))
    rstats = (0.1 * torch.randn(ch, generator=g),
              1 + 0.2 * torch.rand(ch, generator=g),
              0.1 * torch.randn(ch, generator=g),
              1 + 0.2 * torch.rand(ch, generator=g))
    u = torch.randn(batch, height, width, cs, generator=g)
    spec = ConvFamilySpec(cs, ch, 0.1, 1e-5, "running",
                          (("layer_0", "layer_1"), ("layer_1", "layer_1")))
    return (ConvWeights(*(t.to(device) for t in w)), spec,
            tuple(r.to(device) for r in rstats), u.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["train", "running", "batch"])
@pytest.mark.parametrize("shape", [(3, 8, 12, 6, 16), (2, 32, 32, 8, 64)])
def test_conv_step_matches_plain_on_card(cuda_device, shape, mode):
    # kernel 13 against conv_step_plain (cuDNN in FP32): the products are
    # summed in another order, so states agree to ~1e-5 of their largest
    # value; bitwise from run to run
    from localregneuralde_tpu_torch.ops.cuda import (
        conv_step_plain, fused_conv_step,
    )

    w, spec, rstats, u = _conv_setup(cuda_device, *shape)
    if mode == "batch":
        spec = spec._replace(eval_stats="batch")
    training = mode == "train"
    t = torch.tensor(0.2, device=cuda_device)
    dt = torch.tensor(0.05, device=cuda_device)
    k1 = 0.5 * torch.randn_like(u)
    out = fused_conv_step(w, spec, u, t, dt, k1, training=training,
                          rstats=rstats)
    ref = conv_step_plain(w, spec, u, t, dt, k1, training=training,
                          rstats=rstats)
    # u~ is a cancelling sum of the k's: held to 1e-5 of dt * max |k|
    kscale = 0.05 * max(float(k.abs().max()) for k in ref[2:8])
    assert float((out[1] - ref[1]).abs().max()) <= 1e-5 * kscale
    for i in (0, *range(2, 9)):
        assert _rel(out[i], ref[i]) <= 1e-5
    if training:
        for a, b in zip(out[9], ref[9]):
            assert _rel(a, b) <= 1e-5
    else:
        assert out[9] is None
    again = fused_conv_step(w, spec, u, t, dt, k1, training=training,
                            rstats=rstats)
    for a, b in zip(again[:9], out[:9]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 8, 12, 6, 16), (2, 32, 32, 8, 64)])
def test_conv_step_bwd_matches_plain_on_card(cuda_device, shape):
    # kernel 14 against the autograd VJP of the plain training step:
    # relative to the largest magnitude, 1e-4; bitwise from run to run
    from localregneuralde_tpu_torch.ops.cuda import (
        fused_conv_step_bwd, fused_conv_step_bwd_plain,
    )

    w, spec, _, u = _conv_setup(cuda_device, *shape)
    t = torch.tensor(0.1, device=cuda_device)
    dt = torch.tensor(0.08, device=cuda_device)
    k1 = 0.5 * torch.randn_like(u)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    cts = [torch.randn(u.shape, generator=g, device=cuda_device)
           for _ in range(9)]
    ours = fused_conv_step_bwd(w, spec, u, t, dt, k1, cts)
    ref = fused_conv_step_bwd_plain(w, spec, u, t, dt, k1, cts)
    for a, b in zip([ours[1], ours[2], *ours[0]], [ref[1], ref[2], *ref[0]]):
        assert _rel(a, b) <= 1e-4
    again = fused_conv_step_bwd(w, spec, u, t, dt, k1, cts)
    for a, b in zip([again[1], again[2], *again[0]],
                    [ours[1], ours[2], *ours[0]]):
        assert torch.equal(a, b)


# the conv GEMM core's tile paths (conv_core.cuh): N = 8 for an output of at
# most 8 channels, N = 64 above; 16-byte copies when the channel counts are
# multiples of 4, 4-byte copies otherwise; 189 pixels, not a multiple of a
# 128-pixel tile
CORE_SHAPES = [(3, 7, 9, 6, 16), (3, 7, 9, 8, 64), (3, 7, 9, 16, 8),
               (3, 7, 9, 6, 6), (3, 7, 9, 64, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CORE_SHAPES)
def test_conv_step_tile_paths_on_card(cuda_device, shape):
    # kernels 13 and 14 over every tile path of the core, at the holds of
    # the full-width tests above, bitwise from run to run
    from localregneuralde_tpu_torch.ops.cuda import (
        conv_step_plain, fused_conv_step, fused_conv_step_bwd,
        fused_conv_step_bwd_plain,
    )

    w, spec, rstats, u = _conv_setup(cuda_device, *shape)
    t = torch.tensor(0.2, device=cuda_device)
    dt = torch.tensor(0.05, device=cuda_device)
    k1 = 0.5 * torch.randn_like(u)
    out = fused_conv_step(w, spec, u, t, dt, k1, training=True, rstats=rstats)
    ref = conv_step_plain(w, spec, u, t, dt, k1, training=True, rstats=rstats)
    kscale = 0.05 * max(float(k.abs().max()) for k in ref[2:8])
    assert float((out[1] - ref[1]).abs().max()) <= 1e-5 * kscale
    for i in (0, *range(2, 9)):
        assert _rel(out[i], ref[i]) <= 1e-5
    again = fused_conv_step(w, spec, u, t, dt, k1, training=True,
                            rstats=rstats)
    assert all(torch.equal(a, b) for a, b in zip(again[:9], out[:9]))
    g = torch.Generator(device=cuda_device).manual_seed(3)
    cts = [torch.randn(u.shape, generator=g, device=cuda_device)
           for _ in range(9)]
    ours = fused_conv_step_bwd(w, spec, u, t, dt, k1, cts)
    ref = fused_conv_step_bwd_plain(w, spec, u, t, dt, k1, cts)
    flat = lambda o: [o[1], o[2], *o[0]]  # noqa: E731
    for a, b in zip(flat(ours), flat(ref)):
        assert _rel(a, b) <= 1e-4
    again = fused_conv_step_bwd(w, spec, u, t, dt, k1, cts)
    assert all(torch.equal(a, b) for a, b in zip(flat(again), flat(ours)))


@pytest.mark.cuda
@pytest.mark.parametrize("orient", ["forward", "data grad", "weight grad"])
@pytest.mark.parametrize("cin,cout", [(6, 8), (8, 16), (16, 6), (64, 64),
                                      (64, 8), (16, 64)])
def test_conv_core_orientations_on_card(cuda_device, orient, cin, cout):
    # the core alone (lrnde_conv_core) against PyTorch's FP32 conv and its
    # gradients at 189 pixels: 1e-5 of the largest value, bitwise from run
    # to run
    from torch.nn.grad import conv2d_input, conv2d_weight

    from localregneuralde_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    b, h, w = 3, 7, 9
    g = torch.Generator().manual_seed(5)
    x = torch.randn(b, h, w, cin, generator=g).to(cuda_device)
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    sc = torch.tensor([0.37, 0.0], device=cuda_device)
    code = ("forward", "data grad", "weight grad").index(orient)
    if code == 0:
        wt = torch.randn(3, 3, cin, cout, generator=g).to(cuda_device)
        ref = torch.nn.functional.conv2d(nchw(x), wt.permute(3, 2, 0, 1),
                                         padding=1).permute(0, 2, 3, 1)
        ops, out = (x, wt), torch.empty(b, h, w, cout, device=cuda_device)
    elif code == 1:
        wt = torch.randn(3, 3, cout + 1, cin, generator=g).to(cuda_device)
        ref = conv2d_input((b, cout, h, w), wt[:, :, :cout].permute(3, 2, 0, 1),
                           nchw(x), padding=1).permute(0, 2, 3, 1)
        ops, out = (x, wt), torch.empty(b, h, w, cout, device=cuda_device)
    else:
        dy = torch.randn(b, h, w, cout, generator=g).to(cuda_device)
        x1 = torch.cat([x, torch.full((b, h, w, 1), 0.37, device=cuda_device)],
                       dim=-1)
        ref = conv2d_weight(nchw(x1), (cout, cin + 1, 3, 3), nchw(dy),
                            padding=1).permute(2, 3, 1, 0)
        ops, out = (x, dy), torch.empty(3, 3, cin + 1, cout,
                                        device=cuda_device)
    scratch = torch.empty(
        lib.lrnde_conv_core_scratch_floats(code, b, h, w, cin, cout),
        device=cuda_device)
    p = _build.ptr

    def run():
        err = lib.lrnde_conv_core(code, 0, p(ops[0]), p(ops[1]), p(sc),
                                  p(out), p(scratch), b, h, w, cin, cout,
                                  _build.stream_ptr(x.device))
        _build.check(lib, err, "conv_core")
        return out.clone()

    first = run()
    assert _rel(first, ref) <= 1e-5
    assert torch.equal(run(), first)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 512, 700, 1100])
def test_ordered_slot_sum_on_card(cuda_device, n):
    # solve.cuh::ordered_slot_sum, the persistent kernels' error-norm sum,
    # at slot counts that are not multiples of the warp width or of its
    # 512-slot chunk: bitwise the one-thread left-to-right float32 sum
    import numpy as np

    from localregneuralde_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    g = torch.Generator().manual_seed(n)
    slots = torch.rand(n, generator=g) * torch.logspace(-6, 2, n)
    want = np.float32(0.0)
    for v in slots.numpy():
        want = np.float32(want + v)
    out = torch.empty(1, device=cuda_device)
    d = slots.to(cuda_device)
    err = lib.lrnde_slot_sum(_build.ptr(d), n, _build.ptr(out),
                             _build.stream_ptr(d.device))
    _build.check(lib, err, "slot_sum")
    assert float(out) == float(want)


@pytest.mark.cuda
def test_sde_kernels_repeat_at_main_path_shapes(cuda_device):
    # kernels 10 (B = 512, F = 32, H = 64, SOSRI at 0.14) and 11 (the score
    # demo: B = 4096, F = 2, SOSRI at 1e-2) run twice on the same inputs and
    # Philox seed: the same outputs and step counts, bitwise
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_sde_solve, persistent_vpsde_solve,
    )
    from localregneuralde_tpu_torch.sde import PhiloxNormals

    keys = ("y_final", "ys", "naccept", "nreject", "natt")
    w, u0 = _sde_setup(cuda_device, 512)
    kw = _sde_kw(cuda_device, 512)
    a = persistent_sde_solve(w, u0, (0.0, 1.0), **kw)
    b = persistent_sde_solve(w, u0, (0.0, 1.0), **kw)
    assert bool(a["success"])
    assert all(torch.equal(a[k], b[k]) for k in keys)
    params, chain, x = _score_setup(cuda_device, 4096)
    kw = dict(noise=PhiloxNormals(1234, 4096, 2, device=cuda_device),
              rtol=1e-2, atol=1e-2, solver="sosri", delta=1 / 6,
              max_steps=4096, saveat_arr=torch.tensor([0.999],
                                                      device=cuda_device),
              **SCHEDULE)
    a = persistent_vpsde_solve(params, chain, x, (0.0, 0.999), **kw)
    b = persistent_vpsde_solve(params, chain, x, (0.0, 0.999), **kw)
    assert bool(a["success"])
    assert all(torch.equal(a[k], b[k]) for k in keys)


def _score_setup(device, batch, features=2, hidden=64, seed=0):
    """The score demo's network (TDChain 2 -> 64 -> 64 -> 2, tanh, tanh,
    identity) with Glorot weights and small biases, and a state batch."""
    from localregneuralde_tpu_torch.nn import glorot_uniform
    from localregneuralde_tpu_torch.ops.cuda import ScoreChainSpec

    g = torch.Generator().manual_seed(seed)
    dims = (features, hidden, hidden, features)
    params = []
    for i in range(3):
        params += [glorot_uniform((dims[i] + 1, dims[i + 1]), g),
                   0.1 * torch.randn(dims[i + 1], generator=g)]
    chain = ScoreChainSpec(dims, (True, True, False),
                           ("layer_0", "layer_1", "layer_2"))
    x = torch.randn(batch, features, generator=g)
    return [p.to(device) for p in params], chain, x.to(device)


SCHEDULE = dict(beta_min=0.1, beta_max=20.0, t1=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["sri", "sosri"])
def test_vpsde_solve_matches_plain_on_card(cuda_device, solver):
    # kernel 11 against the eager loop on the same Philox path, B = 24 (not
    # a multiple of 8: the reference would decline it): the same accepts
    # and rejects, states within 1e-3 of their largest value (the
    # Hölder-1/2 band of kernel 10, scaled by the reverse drift's growth),
    # bitwise from run to run
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_vpsde_solve, persistent_vpsde_solve_plain,
    )
    from localregneuralde_tpu_torch.sde import PhiloxNormals

    params, chain, x = _score_setup(cuda_device, 24)
    kw = dict(noise=PhiloxNormals(7, 24, 2, device=cuda_device), rtol=1e-2,
              atol=1e-2, solver=solver, delta=1 / 6, max_steps=4096,
              saveat_arr=torch.tensor([0.5, 0.999], device=cuda_device),
              **SCHEDULE)
    out = persistent_vpsde_solve(params, chain, x, (0.0, 0.999), **kw)
    ref = persistent_vpsde_solve_plain(params, chain, x, (0.0, 0.999), **kw)
    assert bool(out["success"]) and bool(ref["success"])
    assert int(out["naccept"]) == int(ref["naccept"])
    assert int(out["nreject"]) == int(ref["nreject"])
    assert _rel(out["ys"], ref["ys"]) <= 1e-3
    again = persistent_vpsde_solve(params, chain, x, (0.0, 0.999), **kw)
    assert torch.equal(out["ys"], again["ys"])


@pytest.mark.cuda
def test_pf_solve_matches_plain_on_card(cuda_device):
    # kernel 6 against the eager loop: within one accept and 5e-5 of the
    # largest value (tests/test_vpsde_kernel.py:193-198), bitwise from run
    # to run
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_pf_solve, persistent_pf_solve_plain,
    )

    params, chain, x = _score_setup(cuda_device, 24)
    kw = dict(rtol=1e-4, atol=1e-6, max_steps=512,
              saveat_arr=torch.tensor([0.5, 0.999], device=cuda_device),
              **SCHEDULE)
    out = persistent_pf_solve(params, chain, x, (0.0, 0.999), **kw)
    ref = persistent_pf_solve_plain(params, chain, x, (0.0, 0.999), **kw)
    assert bool(out["success"]) and bool(ref["success"])
    assert abs(int(out["naccept"]) - int(ref["naccept"])) <= 1
    assert _rel(out["ys"], ref["ys"]) <= 5e-5
    again = persistent_pf_solve(params, chain, x, (0.0, 0.999), **kw)
    assert torch.equal(out["ys"], again["ys"])
    assert int(out["nfe"]) == int(again["nfe"])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [4096, 1001])
def test_pf_solve_at_batches_on_card(cuda_device, batch):
    # kernel 6 at the score demo's batch and a ragged one (a last 8-row
    # block of one row, a last 4-row group of one): within one accept and
    # 5e-5 of the largest value of the eager loop, bitwise from run to run
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_pf_solve, persistent_pf_solve_plain,
    )

    params, chain, x = _score_setup(cuda_device, batch)
    kw = dict(rtol=1e-4, atol=1e-6, max_steps=512,
              saveat_arr=torch.tensor([0.5, 0.999], device=cuda_device),
              **SCHEDULE)
    out = persistent_pf_solve(params, chain, x, (0.0, 0.999), **kw)
    ref = persistent_pf_solve_plain(params, chain, x, (0.0, 0.999), **kw)
    assert bool(out["success"]) and bool(ref["success"])
    assert abs(int(out["naccept"]) - int(ref["naccept"])) <= 1
    assert _rel(out["ys"], ref["ys"]) <= 5e-5
    again = persistent_pf_solve(params, chain, x, (0.0, 0.999), **kw)
    assert torch.equal(out["ys"], again["ys"])


@pytest.mark.cuda
@pytest.mark.parametrize("features, hidden", [(3, 13), (5, 70)])
def test_pf_solve_odd_widths_on_card(cuda_device, features, hidden):
    # kernel 6 at widths the demo does not have: a layer narrower than 32
    # outputs (a lane an output, and the last layer a lane a (row,
    # output)) and one wider than 64 (three outputs a lane)
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_pf_solve, persistent_pf_solve_plain,
    )

    params, chain, x = _score_setup(cuda_device, 45, features=features,
                                    hidden=hidden)
    kw = dict(rtol=1e-4, atol=1e-6, max_steps=512,
              saveat_arr=torch.tensor([0.999], device=cuda_device),
              **SCHEDULE)
    out = persistent_pf_solve(params, chain, x, (0.0, 0.999), **kw)
    ref = persistent_pf_solve_plain(params, chain, x, (0.0, 0.999), **kw)
    assert bool(out["success"]) and bool(ref["success"])
    assert abs(int(out["naccept"]) - int(ref["naccept"])) <= 1
    assert _rel(out["ys"], ref["ys"]) <= 5e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(2, 64, 64, 2), (3, 13, 13, 3),
                                  (5, 70, 5)])
def test_pf_grid_matches_plan_on_card(cuda_device, dims):
    # kernel 6's shared memory and grid against pf_plan's model, one CTA
    # an SM being resident at these sizes
    import ctypes

    from localregneuralde_tpu_torch.ops.cuda import _build
    from localregneuralde_tpu_torch.ops.cuda.fused_solve import (
        PF_THREADS, pf_plan, pf_smem_floats,
    )

    lib = _build.load_library()
    assert lib.lrnde_pf_solve_threads() == PF_THREADS
    L = len(dims) - 1
    arr = (ctypes.c_int * (L + 1))(*dims)
    dp = ctypes.cast(arr, ctypes.c_void_p)
    assert lib.lrnde_pf_solve_smem_floats(dp, L) == pf_smem_floats(dims, 1)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    out = (ctypes.c_int * 2)()
    op = ctypes.cast(out, ctypes.c_void_p)
    for B in (7, 13, 410, 512, 1000, 4096):
        assert lib.lrnde_pf_solve_grid(dp, L, B, op) == 0
        plan = pf_plan(B, dims, lambda smem: n_sm, n_sm)
        assert (out[0], out[1]) == (plan.J, plan.grid)


@pytest.mark.cuda
def test_attribution_clocks_bitwise_on_card(cuda_device):
    # the clocked instantiations of kernels 10 and 6 (chip_smoke.py's [sde
    # solve attribution] and [pf solve attribution]) against their untimed
    # kernels: the same outputs, knots and attempt counts, bitwise
    import chip_smoke
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_pf_solve, persistent_sde_solve,
    )

    w, x = _sde_setup(cuda_device, 512)
    kw = _sde_kw(cuda_device, 512, record_knots=True)
    ref = persistent_sde_solve(w, x, (0.0, 1.0), **kw)
    assert chip_smoke.phase_sde_solve_attribution(w, x, kw, ref, runs=1) > 0
    params, chain, u0 = _score_setup(cuda_device, 4096)
    saveat = torch.tensor([0.999], device=cuda_device)
    pkw = dict(rtol=1e-4, atol=1e-6, max_steps=chip_smoke.SCORE_MAX_STEPS,
               saveat_arr=saveat, **SCHEDULE)
    ref = persistent_pf_solve(params, chain, u0, (0.0, 0.999), **pkw)
    split = chip_smoke.phase_pf_solve_attribution(
        params, chain, u0, (0.0, 0.999), saveat, SCHEDULE, ref, runs=1)
    assert sum(split.values()) > 0
    # kernel 6's other layouts keep the bits too
    chip_smoke.phase_pf_probe(params, chain, u0, (0.0, 0.999), saveat,
                              SCHEDULE, ref)


def _orient_tile_test(device, a, b, split, tma):
    """d = a · bᵀ on one 64 x 64 tile through kernel 15's swizzle, lo split
    and wgmma descriptors (``lrnde_conv_orient_tile_test``)."""
    from localregneuralde_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    d = torch.empty(64, 64, device=device)
    p = _build.ptr
    err = lib.lrnde_conv_orient_tile_test(p(a), p(b), p(d), int(split),
                                          int(tma), _build.stream_ptr(device))
    _build.check(lib, err, "lrnde_conv_orient_tile_test")
    torch.cuda.synchronize()
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("tma", [False, True])
@pytest.mark.parametrize("split", [False, True])
def test_conv_orient_wgmma_tile_on_card(cuda_device, split, tma):
    # one 64 x 64 x 32 tile of known matrices: small integers are exact in
    # TF32 and in every partial sum, so any fault of the descriptors (start
    # address, SBO, swizzle) or of TMA's swizzle against the threads' shows
    # as a wrong element; then random floats, where 3xTF32 keeps ~1e-6 of
    # the products' scale and hi·hi alone ~1e-3
    g = torch.Generator().manual_seed(3)
    a = torch.randint(-8, 9, (64, 32), generator=g).float()
    b = torch.randint(-8, 9, (64, 32), generator=g).float()
    want = a.double() @ b.double().T
    got = _orient_tile_test(cuda_device, a.to(cuda_device),
                            b.to(cuda_device), split, tma)
    assert torch.equal(got.cpu().double(), want)
    a = torch.randn(64, 32, generator=g)
    b = torch.randn(64, 32, generator=g)
    want = a.double() @ b.double().T
    scale = float((a.double().abs() @ b.double().abs().T).max())
    got = _orient_tile_test(cuda_device, a.to(cuda_device),
                            b.to(cuda_device), split, tma)
    err = float((got.cpu().double() - want).abs().max()) / scale
    if split:
        assert err <= 1e-6
    else:
        assert 1e-5 <= err <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 5, 7, 16, 24), (4, 32, 32, 64, 64),
                                   (2, 6, 9, 3, 16), (1, 9, 11, 20, 30),
                                   (2, 7, 5, 13, 21), (1, 3, 130, 12, 9)])
def test_conv_orient_matches_plain_on_card(cuda_device, shape):
    # kernel 15's two layouts against cuDNN in FP32: 1e-5 of the largest
    # value (3xTF32 products, sums in another order); against a float64
    # conv within twice the error of the CPU model of the kernel's
    # arithmetic (test_torch_conv_orient_plan.kernel_model, floored at
    # 2**-22 of the largest value); bitwise repeatable, and the threads' A
    # path (Cin = 3 and 13 take it anyway) bitwise TMA's; one launch a call
    from test_torch_conv_orient_plan import model_error

    from localregneuralde_tpu_torch.ops.cuda import (
        _build, conv_orient_im2col, conv_orient_plain, conv_orient_tap,
    )

    b, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(1)
    x = torch.rand(b, h, w, cin, generator=g).to(cuda_device)
    wt = (0.05 * torch.randn(3, 3, cin, cout, generator=g)).to(cuda_device)
    ref = conv_orient_plain(x, wt)
    ref64 = conv_orient_plain(x.double(), wt.double())
    scale = float(ref64.abs().max())
    lib = _build.load_library()
    for layout, fn in enumerate((conv_orient_tap, conv_orient_im2col)):
        base = max(model_error(shape, ("tap", "im2col")[layout]),
                   2**-22 * scale)
        before = fn.launches
        y = fn(x, wt)
        assert fn.launches == before + 1
        assert _rel(y, ref) <= 1e-5
        assert float((y.double() - ref64).abs().max()) <= 2 * base
        assert torch.equal(fn(x, wt), y)
        threads = torch.empty_like(y)
        err = lib.lrnde_conv_orient_probe(
            layout, 3, _build.ptr(x), _build.ptr(wt), _build.ptr(threads), b,
            h, w, cin, cout, None, _build.stream_ptr(cuda_device))
        _build.check(lib, err, "lrnde_conv_orient_probe")
        assert torch.equal(threads, y)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden", [(1, 100), (410, 100), (512, 100),
                                          (1000, 100), (410, 150)])
def test_cluster_solve_on_card(cuda_device, batch, hidden):
    """Kernel 4 on its clusters against the eager loop (rtol 1e-4, as
    above), bitwise repeatable; its first attempt's evaluations bitwise
    kernels 1 and 2 (``_kernel4_attempt_is_kernels_1_and_2``). B = 1000 has
    more row blocks
    than resident clusters; at H = 150 the weight slices do not fit beside
    the tiles and stay in global memory."""
    from localregneuralde_tpu_torch.ops.cuda import _build, fused_solve

    w, x = _card_setup(cuda_device, batch, 784, hidden)
    plan = fused_solve.solve_plan(batch, 784, hidden)
    assert plan.weights_shared == (hidden == 100)
    clusters = _build.load_library().lrnde_solve_clusters(batch, 784, hidden)
    assert 1 <= clusters <= len(plan.row_blocks)
    if batch == 1000:
        assert clusters < len(plan.row_blocks)
    _kernel4_attempt_is_kernels_1_and_2(w, x)
    kw = dict(rtol=1e-4, atol=1e-4, max_steps=64,
              saveat_arr=torch.tensor([0.5, 1.0], device=cuda_device))
    out = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
    ref = persistent_tsit5_solve_plain(w, x, (0.0, 1.0), **kw)
    torch.testing.assert_close(out["ys"], ref["ys"], atol=3e-4, rtol=0)
    assert abs(int(out["naccept"]) - int(ref["naccept"])) <= 1
    assert bool(out["success"]) and bool(ref["success"])
    again = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
    assert torch.equal(out["ys"], again["ys"])
    assert torch.equal(out["y_final"], again["y_final"])


def _kernel4_attempt_is_kernels_1_and_2(w, x):
    """One attempt of kernel 4 (max_steps 1) from the wrapper's own start,
    its buffers read from its scratch (segment layout) through
    ``fused_solve.segment_index``: kernel 2's step from the same state has
    its u_new and k2..k7 bitwise, and kernel 1 at (u_new, dt) its k7 (the
    attempt's last evaluation)."""
    from localregneuralde_tpu_torch.ops.cuda import fused_solve

    B, F = x.shape
    k1_0, dt0, _ = fused_solve._start(lambda u, t: fused_tdmlp(w, u, t), x,
                                      0.0, 1.0, 1e-4, 1e-4)
    scratch = torch.empty(fused_solve.solve_plan(B, F, w.b1.shape[0])
                          .scratch_floats, device=x.device)
    one = fused_solve._launch_solve(
        w, x, (0.0, 1.0), rtol=1e-4, atol=1e-4, max_steps=1,
        saveat_arr=torch.ones(1, device=x.device), scratch=scratch)
    assert int(one["naccept"]) == 1
    bufs = scratch.view(9, B, -1)[:, :, fused_solve.segment_index(F)
                                  .to(x.device)]
    assert torch.equal(bufs[0], x) and torch.equal(bufs[2], k1_0)
    step = fused_tsit5_step(w, x, torch.zeros((), device=x.device), dt0,
                            k1_0)
    assert torch.equal(step[0], one["y_final"])
    assert torch.equal(bufs[1], one["y_final"])
    for j in range(6):
        assert torch.equal(bufs[3 + j], step[2 + j])
    assert torch.equal(fused_tdmlp(w, one["y_final"], dt0), bufs[8])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 784, 100), (7, 784, 100),
                                   (410, 784, 100), (1000, 784, 100),
                                   (13, 13, 30), (410, 784, 150),
                                   (410, 784, 160), (64, 784, 373)])
def test_cluster_tdmlp_and_step_on_card(cuda_device, shape):
    """Kernels 1 and 2 on their clusters against their plain versions
    (FP32 sums in another order than cuBLAS's, as above), bitwise
    repeatable, each call one launch. B = 1 and 7 take one row a cluster;
    B = 1000 loops its clusters over the row blocks; at H = 150 the weight
    slices still fit beside the tiles, from H = 160 they stay in global
    memory; H = 373 is the widest the first port took at F = 784."""
    from localregneuralde_tpu_torch.ops.cuda import fused_solve

    batch, features, hidden = shape
    w, x = _card_setup(cuda_device, *shape)
    plan = fused_solve.eval_layout(batch, features, hidden)[1]
    assert plan.weights_shared == (hidden < 160)
    assert 1 <= plan.clusters and plan.clusters * plan.rows >= min(
        batch, plan.clusters * plan.rows_max)
    t = torch.tensor(0.2, device=cuda_device)
    dt = torch.tensor(0.05, device=cuda_device)
    before = (_launches(fused_tdmlp), _launches(fused_tsit5_step))
    y = fused_tdmlp(w, x, 0.3)
    k1 = fused_tdmlp(w, x, t)
    out = fused_tsit5_step(w, x, t, dt, k1)
    assert (_launches(fused_tdmlp) - before[0],
            _launches(fused_tsit5_step) - before[1]) == (2, 1)
    torch.testing.assert_close(y, tdmlp_plain(w, x, 0.3), atol=1e-5, rtol=0)
    for a, b in zip(out, tsit5_step_plain(w, x, t, dt, k1)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert torch.equal(fused_tdmlp(w, x, 0.3), y)
    assert all(torch.equal(a, b)
               for a, b in zip(fused_tsit5_step(w, x, t, dt, k1), out))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden", [(512, 100), (410, 160)])
def test_cluster_tdmlp_grid_and_clock_on_card(cuda_device, batch, hidden):
    """Both kernels at 40 rows a cluster are bitwise the wrappers'
    results; the library's grid is ``eval_plan``'s; kernel 2's clocked
    instantiation is bitwise its untimed self; and kernel 4's first attempt
    is bitwise kernels 1 and 2."""
    import ctypes

    from localregneuralde_tpu_torch.ops.cuda import _build, fused_solve

    w, x = _card_setup(cuda_device, batch, 784, hidden)
    lib, plan = fused_solve.eval_layout(batch, 784, hidden)
    grid = (ctypes.c_int * 2)()
    assert lib.lrnde_eval_grid(batch, 784, hidden, 40, 1, grid) == 0
    resident = _resident(lib, hidden)
    assert tuple(grid) == fused_solve.eval_plan(batch, 784, hidden, resident,
                                                rows=40)[2:4]
    assert (plan.rows, plan.clusters) == fused_solve.eval_plan(
        batch, 784, hidden, resident)[2:4]
    p, stream = _build.ptr, _build.stream_ptr(x.device)
    s = torch.tensor([0.3], device=cuda_device)
    want = fused_tdmlp(w, x, 0.3)
    for rows in (0, 40):
        out = torch.empty_like(x)
        assert lib.lrnde_tdmlp(p(x), p(s), *[p(t) for t in w], p(out), batch,
                               784, hidden, rows, stream) == 0
        assert torch.equal(out, want), rows
    t = torch.tensor(0.2, device=cuda_device)
    dt = torch.tensor(0.05, device=cuda_device)
    k1 = fused_tdmlp(w, x, t)
    ref = fused_tsit5_step(w, x, t, dt, k1)
    sc = torch.stack([t, dt])
    timing = torch.zeros(lib.lrnde_step_phases() + 1, dtype=torch.int64,
                         device=cuda_device)
    for rows, clock in ((40, None), (0, timing)):
        outs = [torch.empty_like(x) for _ in range(9)]
        scratch = torch.empty(plan.scratch_floats, device=cuda_device)
        assert lib.lrnde_tsit5_step(
            p(x), p(k1), p(sc), *[p(t_) for t_ in w], *[p(o) for o in outs],
            p(scratch), batch, 784, hidden, rows,
            None if clock is None else p(clock), stream) == 0
        assert all(torch.equal(a, b) for a, b in zip(outs, ref)), rows
    assert int(timing[-1]) == 1 and int(timing[:-1].sum()) > 0
    _kernel4_attempt_is_kernels_1_and_2(w, x)


def _resident(lib, hidden):
    """The clusters this card keeps resident for kernels 1 and 2."""
    import ctypes

    grid = (ctypes.c_int * 2)()
    assert lib.lrnde_eval_grid(1 << 20, 784, hidden, 1, 0, grid) == 0
    return grid[1]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden", [(1000, 100), (410, 150)])
def test_cluster_solve_recording_on_card(cuda_device, batch, hidden):
    """Knots, checkpoints and the reservoir of kernel 4 where a cluster
    sweeps several row blocks (B = 1000) and with the weights in global
    memory (H = 150): recording changes nothing, the knots are the accepted
    states, the reservoir sample is one of them."""
    w, x = _card_setup(cuda_device, batch, 784, hidden)
    bare = persistent_tsit5_solve(
        w, x, (0.0, 1.0), rtol=1e-5, atol=1e-5, max_steps=64,
        saveat_arr=torch.tensor([0.5, 1.0], device=cuda_device))
    u = torch.rand(64, device=cuda_device)
    rec = _recorded(w, x, 1e-5, knot_stride=2, reservoir=u)
    n = int(rec["naccept"])
    assert n == int(bare["naccept"]) and n >= 3
    assert torch.equal(rec["y_final"], bare["y_final"])
    assert torch.equal(rec["ys"], bare["ys"])
    assert torch.equal(rec["knot_us"][n], rec["y_final"])
    assert torch.equal(rec["knot_us"][0], x)
    for c in range(n // 2 + 1):
        assert torch.equal(rec["ckpt_us"][c], rec["knot_us"][2 * c])
    ts = rec["knot_ts"][:n]
    j = int(torch.argmin((ts - rec["reservoir_t"]).abs()))
    assert float(ts[j]) == float(rec["reservoir_t"])
    assert torch.equal(rec["knot_us"][j], rec["reservoir_u"])


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden", [(37, 100), (410, 100), (1000, 100),
                                          (410, 150)])
def test_cluster_step_bwd_ragged_on_card(cuda_device, batch, hidden):
    """Kernel 3 on the sweep's clusters at ragged B (and at H = 150, whose
    gradient slices go to the clusters' partials in global memory) against
    its plain version, bitwise repeatable."""
    from localregneuralde_tpu_torch.ops.cuda import (
        fused_step_bwd, fused_step_bwd_plain,
    )

    w, x = _card_setup(cuda_device, batch, 784, hidden)
    t = torch.tensor(0.2, device=cuda_device)
    dt = torch.tensor(0.05, device=cuda_device)
    k1 = tdmlp_plain(w, x, t)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    cts = [torch.randn(x.shape, generator=g, device=cuda_device)
           for _ in range(9)]
    ours = fused_step_bwd(w, x, t, dt, k1, cts)
    ref = fused_step_bwd_plain(w, x, t, dt, k1, cts)
    for a, b in zip([ours[1], ours[2], *ours[0]], [ref[1], ref[2], *ref[0]]):
        assert _rel(a, b) <= 1e-4
    again = fused_step_bwd(w, x, t, dt, k1, cts)
    for a, b in zip([again[1], again[2], *again[0]],
                    [ours[1], ours[2], *ours[0]]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_step_bwd_fp64_error_on_card(cuda_device):
    """Kernel 3 against the float64 VJP on chip_smoke.py's inputs: within
    twice the error of the kernel before its cluster redesign (3.719e-7,
    NVIDIA H100 80GB HBM3, 700 W)."""
    from localregneuralde_tpu_torch.harness import synthetic_classification
    from localregneuralde_tpu_torch.nn import glorot_uniform
    from localregneuralde_tpu_torch.ops.cuda import (
        fused_step_bwd, fused_step_bwd_plain,
    )

    B_, F_, H_ = 512, 784, 100
    g = torch.Generator().manual_seed(0)
    w = TDMLPWeights(
        glorot_uniform((F_ + 1, H_), g), 0.1 * torch.randn(H_, generator=g),
        glorot_uniform((H_ + 1, F_), g), 0.1 * torch.randn(F_, generator=g),
    )
    w = TDMLPWeights(*(p.to(cuda_device) for p in w))
    x = torch.tensor(synthetic_classification(seed=0)[2][:B_].reshape(B_, F_),
                     device=cuda_device)
    gd = torch.Generator(device=cuda_device).manual_seed(7)
    t = torch.tensor(0.2, device=cuda_device)
    dt = torch.tensor(0.05, device=cuda_device)
    k1 = tdmlp_plain(w, x, t)
    cts = [torch.randn(x.shape, generator=gd, device=cuda_device)
           for _ in range(9)]
    ours = fused_step_bwd(w, x, t, dt, k1, cts)
    ref = fused_step_bwd_plain(TDMLPWeights(*[p.double() for p in w]),
                               x.double(), t.double(), dt.double(),
                               k1.double(), [c.double() for c in cts])
    err = max(_rel(a.double(), b) for a, b in zip(
        [ours[1], ours[2], *ours[0]], [ref[1], ref[2], *ref[0]]))
    assert err <= 2 * 3.719e-7


@pytest.mark.cuda
def test_wide_tdmlp_trains_on_the_plain_route(cuda_device):
    """mlp.yaml at H = 184, beyond the sweep's plan, with the regulariser,
    under use_pallas: auto: the route declines the persistent solve, the
    sweep and kernel 3 (the plain loop with the step kernel, the plain
    sweep, the plain step VJP), and two train steps complete with finite
    losses and parameters."""
    from localregneuralde_tpu_torch import ops
    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, construct_optimizer,
        create_train_state, define_configuration, make_train_step, one_hot,
        synthetic_classification,
    )

    cfg = define_configuration(
        ["--model.mlp_hidden_state_size=184", "--model.use_pallas=auto",
         "--model.regularize=unbiased",
         "--model.solver.reltol=1e-4", "--model.solver.abstol=1e-4"],
        "experiments/mnist_ode/mlp.yaml")
    model = construct_model(cfg, device=cuda_device)
    loss_fn, w_reg = construct_loss(cfg)
    opt, sched = construct_optimizer(cfg)
    ts = create_train_state(model, opt)
    step = make_train_step(model, loss_fn, opt)
    x_tr, y_tr, _, _ = synthetic_classification((28, 28), 1, 10, seed=0)
    names = ("persistent_tsit5_solve", "persistent_stored_sweep",
             "persistent_two_level_sweep", "fused_step_bwd",
             "fused_tsit5_step")
    before = {n: _launches(getattr(ops.cuda, n)) for n in names}
    for i in range(2):
        batch = (torch.tensor(x_tr[i * 64:(i + 1) * 64], device=cuda_device),
                 torch.tensor(one_hot(y_tr[i * 64:(i + 1) * 64], 10),
                              device=cuda_device))
        ts, loss, stats = step(ts, batch, w_reg(i + 1), sched(i + 1))
        assert bool(torch.isfinite(loss))
        assert all(bool(torch.isfinite(p).all()) for p in ts.params.values())
    launched = {n: _launches(getattr(ops.cuda, n)) - before[n] for n in names}
    assert launched["fused_tsit5_step"] > 0
    assert all(launched[n] == 0 for n in names[:4]), launched


# ------------------------------------------- the K-step call on the card


def _k_step_family(device, family, K=3, B=64):
    """(model, loss_fn, optimizer, w_regs, lrs, K batches) of a family at
    small width on the card, regularised (unbiased)."""
    import os

    import numpy as np

    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, construct_optimizer,
        construct_time_series, define_configuration, one_hot,
        synthetic_classification,
    )
    from localregneuralde_tpu_torch.harness.latent_runner import (
        build_physionet_arrays,
    )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    exp = os.path.join(root, "experiments")
    unb = ["--model.regularize=unbiased"]
    if family == "latent":
        cfg = define_configuration(unb + [
            "--model.ts_in_dims=5", "--model.ts_hidden_dims=16",
            "--model.ts_latent_dims=6", "--model.ts_node_dims=8",
            "--model.solver.max_steps=256"],
            os.path.join(exp, "physionet", "physionet.yaml"))
        train, _, tgrid, _ = build_physionet_arrays(cfg)
        model = construct_time_series(cfg, saveat=torch.from_numpy(tgrid),
                                      device=device)
        loss_fn, (w_reg, w_kl) = construct_loss(cfg)
        batches = [tuple(torch.from_numpy(a[i * B:(i + 1) * B]).to(device)
                         for a in train) for i in range(K)]
        ws = (np.asarray([w_reg(s + 1) for s in range(K)], np.float32),
              np.asarray([w_kl(s + 1) for s in range(K)], np.float32))
    else:
        path = os.path.join(exp, "mnist_ode" if family == "ode"
                            else "mnist_sde", "mlp.yaml")
        extra = (["--model.mlp_hidden_state_size=32",
                  "--model.solver.reltol=1e-4", "--model.solver.abstol=1e-4",
                  "--model.solver.max_steps=64"] if family == "ode"
                 else ["--model.solver.max_steps=256"])
        cfg = define_configuration(unb + extra, path)
        cfg.model.image_size = [8, 8]
        model = construct_model(cfg, device=device)
        loss_fn, w_reg = construct_loss(cfg)
        x, y, _, _ = synthetic_classification((8, 8), 1, 10, n_train=B * K,
                                              n_test=1, seed=3)
        y1 = one_hot(y, 10)
        batches = [(torch.tensor(x[i * B:(i + 1) * B], device=device),
                    torch.tensor(y1[i * B:(i + 1) * B], device=device))
                   for i in range(K)]
        ws = np.asarray([w_reg(s + 1) for s in range(K)], np.float32)
    opt, sched = construct_optimizer(cfg)
    lrs = np.asarray([sched(s + 1) for s in range(K)], np.float32)
    return model, loss_fn, opt, ws, lrs, batches


def _generators(tree):
    if isinstance(tree, torch.Generator):
        return [tree]
    if isinstance(tree, dict):
        return [g for v in tree.values() for g in _generators(v)]
    return []


@pytest.mark.cuda
@pytest.mark.parametrize("extras", [(1, 0.0), (2, 0.999)],
                         ids=["plain", "ga2_ema"])
@pytest.mark.parametrize("family", ["ode", "sde", "latent"])
def test_k_step_call_captured_equals_eager_on_card(cuda_device, family,
                                                   extras):
    """One CUDA-graph replay of K captured train steps against K eager
    train steps from a copy of the same state: bitwise equal parameters,
    optimizer state, EMA, layer state, generators and summed loss; a second
    call replays the same graph with new draws and stays equal."""
    import copy

    from localregneuralde_tpu_torch.harness import (
        create_train_state, init_ema, make_multi_train_step, make_train_step,
    )
    from localregneuralde_tpu_torch.harness.graph import state_tensors

    ga, ed = extras
    model, loss_fn, opt, ws, lrs, batches = _k_step_family(cuda_device,
                                                           family)
    K = len(batches)
    ts0 = create_train_state(model, opt)
    if ed:
        ts0 = init_ema(ts0)
    step = make_train_step(model, loss_fn, opt, grad_accumulation=ga,
                           ema_decay=ed)
    multi = make_multi_train_step(model, loss_fn, opt, grad_accumulation=ga,
                                  ema_decay=ed)
    stack = tuple(torch.stack([b[i] for b in batches])
                  for i in range(len(batches[0])))

    def w_at(k):
        return (tuple(float(w[k]) for w in ws) if isinstance(ws, tuple)
                else float(ws[k]))

    a, b = copy.deepcopy(ts0), copy.deepcopy(ts0)
    for call in range(2):
        total = None
        for k in range(K):
            a, loss, _ = step(a, batches[k], w_at(k), float(lrs[k]))
            total = loss if total is None else total + loss
        b, _, red = multi(b, stack, ws, lrs)
        assert multi.captured
        assert torch.equal(total, red["loss"]), call
        for x, y in zip(state_tensors(a), state_tensors(b)):
            assert torch.equal(x, y), call
        for g, h in zip(_generators(a.state), _generators(b.state)):
            assert torch.equal(g.get_state(), h.get_state())


@pytest.mark.cuda
def test_k10_seed_in_device_memory_keeps_the_digest_on_card(cuda_device):
    """Kernel 10 reads its seed from a device word: at chip_smoke.py's K10
    digest inputs, a seed given as a number and one given as a device
    tensor both reproduce the stored digest."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    from localregneuralde_tpu_torch.ops.cuda import (
        SDEWeights, persistent_sde_solve,
    )
    from localregneuralde_tpu_torch.sde import PhiloxNormals
    from localregneuralde_tpu_torch.sde.brownian import seed_to_word

    model, _, _, _ = cs._sde_model(cuda_device)
    node = model.neural_dsde
    w = SDEWeights(*(p.detach() for p in list(node.drift.parameters())
                     + list(node.diffusion.parameters())))
    u0 = cs._sde_input(model, cs._mnist_batches(cuda_device, 1)[0][0])
    word = torch.tensor([seed_to_word(1234)], dtype=torch.int32,
                        device=cuda_device)
    for seed in (1234, word):
        out = persistent_sde_solve(
            w, u0, (0.0, 1.0),
            noise=PhiloxNormals(seed, cs.B, u0.shape[1], device=cuda_device),
            rtol=cs.SDE_TOL, atol=cs.SDE_TOL, solver="sosri", delta=1 / 6,
            saveat_arr=torch.tensor([0.5, 1.0], device=cuda_device),
            max_steps=10000, record_knots=True)
        cs.digest("K10", out)  # raises unless the stored digest


# --------------------------------------------------- the TF32 tier (K1-K4,
# K7, K8): each at precision None (the reference's default) against its
# plain version at tier "tf32" on the same inputs. Both round every operand
# of a product to TF32 (cvt.rna), whose products are exact in FP32, so they
# differ only in their FP32 sums, which the tensor cores round toward zero:
# a bias of up to K·2^-24 of a product's scale over its K terms, ``depth``
# products in sequence adding up (chip_smoke.py::tf32_sum_tol).


def _tier_launches(wrapper):
    return dict(wrapper.tier_launches)


def _sum_tol(depth, k=785):
    return depth * k * 2.0 ** -24


def _on_cpu(args):
    return tuple(type(a)(*[t.cpu() for t in a]) if isinstance(a, tuple)
                 else a.cpu() for a in args)


def _against_plains(ours, plain_card, plain_cpu):
    """A TF32 sweep against its plain version on the card and on the CPU.
    TF32 rounds every operand again after each sum, so two FP32 sum orders
    of one TF32 computation part by TF32's rounding (a carried cotangent
    ~1e-3 or more): each output is held to twice the two plains' distance,
    and never below one swept step's truncated sums."""
    for a, c, p in zip(ours, plain_card, plain_cpu):
        assert _rel(a.cpu(), p) <= max(2 * _rel(c.cpu(), p), _sum_tol(27))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 32, 16), (13, 40, 7), (512, 784, 100)])
def test_tf32_kernels_match_plain_on_card(cuda_device, shape):
    w, x = _card_setup(cuda_device, *shape)
    before = _tier_launches(fused_tdmlp).get("tf32", 0)
    y = fused_tdmlp(w, x, 0.3, precision=None)
    assert _tier_launches(fused_tdmlp)["tf32"] == before + 1
    assert _rel(y, tdmlp_plain(w, x, 0.3, "tf32")) <= _sum_tol(2)
    assert torch.equal(y, fused_tdmlp(w, x, 0.3, precision="default"))
    t = torch.tensor(0.2, device=cuda_device)
    dt = torch.tensor(0.05, device=cuda_device)
    k1 = tdmlp_plain(w, x, 0.2, "tf32")
    ours = fused_tsit5_step(w, x, t, dt, k1, precision=None)
    ref = tsit5_step_plain(w, x, t, dt, k1, "tf32")
    for i, (a, b) in enumerate(zip(ours, ref)):
        if i != 1:  # ũ cancels: held to dt·max|Δk| below
            assert _rel(a, b) <= _sum_tol(12), i
    dk = max(float((a - b).abs().max()) for a, b in zip(ours[2:8], ref[2:8]))
    scale = max(float(b.abs().max()) for b in ref[2:8])
    assert float((ours[1] - ref[1]).abs().max()) <= 0.05 * (dk + 1e-6 * scale)


@pytest.mark.cuda
def test_tf32_persistent_solve_on_card(cuda_device):
    w, x = _card_setup(cuda_device, 64, 784, 100)
    kw = dict(rtol=1e-4, atol=1e-4, max_steps=64,
              saveat_arr=torch.tensor([0.0, 0.5, 1.0], device=cuda_device))
    out = persistent_tsit5_solve(w, x, (0.0, 1.0), precision=None, **kw)
    ref = persistent_tsit5_solve_plain(w, x, (0.0, 1.0), tier="tf32", **kw)
    # the step controller reads TF32's noise in ũ, so the kernel and the
    # loop take steps of their own and each solve's TF32 rounding is its
    # own: the state, a dt-weighted sum of evaluations, moves by one
    # evaluation's (two products, both operands rounded by 2^-11)
    assert _rel(out["ys"], ref["ys"]) <= 2 * 2 * 2.0 ** -11
    assert abs(int(out["naccept"]) - int(ref["naccept"])) <= 1
    assert abs(int(out["nfe"]) - int(ref["nfe"])) <= 12
    assert bool(out["success"]) and bool(ref["success"])
    again = persistent_tsit5_solve(w, x, (0.0, 1.0), precision=None, **kw)
    assert torch.equal(out["ys"], again["ys"])
    with pytest.raises(ValueError, match="1e-4"):
        persistent_tsit5_solve(w, x, (0.0, 1.0), precision=None,
                               **{**kw, "rtol": 1e-6, "atol": 1e-6})


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 40, 7), (512, 784, 100)])
@pytest.mark.parametrize("precision", [None, "highest"])
def test_tf32_step_bwd_matches_plain_on_card(cuda_device, shape, precision):
    """Kernel 3 with the reference's default-tier gradients, behind a TF32
    or an FP32 recompute."""
    from localregneuralde_tpu_torch.ops.cuda import (
        fused_step_bwd, fused_step_bwd_plain,
    )

    w, x = _card_setup(cuda_device, *shape)
    t = torch.tensor(0.2, device=cuda_device)
    dt = torch.tensor(0.05, device=cuda_device)
    k1 = tdmlp_plain(w, x, t)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    cts = [torch.randn(x.shape, generator=g, device=cuda_device)
           for _ in range(9)]
    ours = fused_step_bwd(w, x, t, dt, k1, cts, precision=precision,
                          grad_precision=None)
    rec = "tf32" if precision is None else "fp32"
    ref = fused_step_bwd_plain(w, x, t, dt, k1, cts, rec, "tf32")
    for a, b in zip([ours[1], ours[2], *ours[0]], [ref[1], ref[2], *ref[0]]):
        assert _rel(a, b) <= _sum_tol(25)
    again = fused_step_bwd(w, x, t, dt, k1, cts, precision=precision,
                           grad_precision=None)
    for a, b in zip(again[0], ours[0]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="no kernel"):
        fused_step_bwd(w, x, t, dt, k1, cts, precision=None,
                       grad_precision="highest")


@pytest.mark.cuda
def test_tf32_sweeps_match_plain_on_card(cuda_device):
    """Kernel 7 at TF32 over a TF32 forward's knots, kernel 8's TF32
    gradients over an FP32 forward's, and kernel 8's replay at TF32, forced:
    it repeats kernel 4's TF32 forward bitwise (kernel 4's attempt inside
    the sweep), so its gradients equal the dense sweep's."""
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_stored_sweep, persistent_stored_sweep_plain,
        persistent_two_level_sweep,
    )

    w, x = _card_setup(cuda_device, 64, 784, 100)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    ct_ys = torch.randn((2, 64, 784), generator=g, device=cuda_device)
    ct_y = torch.randn((64, 784), generator=g, device=cuda_device)
    saveat = torch.tensor([0.5, 1.0], device=cuda_device)
    tf = dict(precision=None, grad_precision=None)

    def args(r):
        return (w, r["knot_ts"], r["knot_us"], r["naccept"], saveat, ct_ys,
                ct_y)

    def flat(o):
        return [o[0], o[1], *o[2]]

    rec = _recorded(w, x, 1e-4, knot_stride=4, precision=None)
    n = int(rec["naccept"])
    dense = persistent_stored_sweep(*args(rec), **tf)
    ref, cpu = (persistent_stored_sweep_plain(*a, recompute_tier="tf32",
                                              grad_tier="tf32")
                for a in (args(rec), _on_cpu(args(rec))))
    _against_plains(flat(dense), flat(ref), flat(cpu))
    win, replay = persistent_two_level_sweep(
        *args(rec), rec["ckpt_ts"], rec["ckpt_us"], rec["ckpt_ks"],
        rec["ckpt_dts"], rec["ckpt_qolds"], t_end=1.0, rtol=1e-4, atol=1e-4,
        max_steps=64, stride=4, dense_cap=2, return_replay=True, **tf)
    assert n > 2
    m = min(n, 4)
    assert torch.equal(replay[:m + 1], rec["knot_us"][:m + 1])
    for a, b in zip(flat(win), flat(dense)):
        assert _rel(a, b) <= 1e-6
    rec = _recorded(w, x, 1e-6)
    for rp, rec_tier in (("highest", "fp32"), (None, "tf32")):
        ours = persistent_stored_sweep(*args(rec), precision="highest",
                                       grad_precision=None,
                                       recompute_precision=rp)
        ref, cpu = (persistent_stored_sweep_plain(*a, recompute_tier=rec_tier,
                                                  grad_tier="tf32")
                    for a in (args(rec), _on_cpu(args(rec))))
        _against_plains(flat(ours), flat(ref), flat(cpu))


# the conv family at the TF32 tier: the kernel and its TF32 plain version
# round the same operands, but TF32 rounds the activations again after each
# sum (BatchNorm's input, the next conv's operand), so two FP32 sum orders
# of one TF32 step part by TF32's rounding, and the tensor cores' sums round
# toward zero, a bias the plain version's lack: each output of the kernel is
# held against float64 within twice its plain version's own distance from
# it, and never below the truncated sums over the step's longest K
# (9·(Ch + 1)) through its depth of products
def _conv_as_accurate(ours, plain, exact, depth, k):
    for a, p, x in zip(ours, plain, exact):
        assert _rel(a.double(), x) <= max(2 * _rel(p.double(), x),
                                          _sum_tol(depth, k))


def _double(*ts):
    return tuple(type(t)(*(p.double() for p in t)) if isinstance(t, tuple)
                 else t.double() for t in ts)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["train", "running", "batch"])
@pytest.mark.parametrize("shape", [(3, 8, 12, 8, 16), (2, 32, 32, 8, 64)])
def test_conv_step_tf32_matches_plain_on_card(cuda_device, shape, mode):
    # kernel 13 at TF32 as accurate against float64 as its TF32 plain
    # version (u_new, k2..k7, g6 and the running stats; ũ cancels: held to
    # dt·max|Δk| of the plain version's), bitwise from run to run, launched
    # at its tier
    from localregneuralde_tpu_torch.ops.cuda import (
        conv_step_plain, fused_conv_step,
    )

    w, spec, rstats, u = _conv_setup(cuda_device, *shape)
    if mode == "batch":
        spec = spec._replace(eval_stats="batch")
    training = mode == "train"
    t = torch.tensor(0.2, device=cuda_device)
    dt = torch.tensor(0.05, device=cuda_device)
    k1 = 0.5 * torch.randn_like(u)
    before = _tier_launches(fused_conv_step).get("tf32", 0)
    out = fused_conv_step(w, spec, u, t, dt, k1, training=training,
                          rstats=rstats, precision=None)
    assert _tier_launches(fused_conv_step)["tf32"] == before + 1
    args = (w, spec, u, t, dt, k1)
    kw = dict(training=training, rstats=rstats, tier="tf32")
    ref = conv_step_plain(*args, **kw)
    w64, u64, t64, dt64, k1_64 = _double(w, u, t, dt, k1)
    exact = conv_step_plain(w64, spec, u64, t64, dt64, k1_64,
                            training=training, rstats=_double(*rstats))
    pick = lambda o: [o[0], *o[2:9], *(o[9] or ())]  # noqa: E731
    _conv_as_accurate(pick(out), pick(ref), pick(exact), 18,
                      9 * (shape[4] + 1))
    dk = max(float((a - b).abs().max()) for a, b in zip(out[2:8], ref[2:8]))
    scale = max(float(b.abs().max()) for b in ref[2:8])
    assert float((out[1] - ref[1]).abs().max()) <= 0.05 * (dk + 1e-6 * scale)
    again = fused_conv_step(w, spec, u, t, dt, k1, training=training,
                            rstats=rstats, precision="default")
    assert all(torch.equal(a, b) for a, b in zip(again[:9], out[:9]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 8, 12, 8, 16), (2, 32, 32, 8, 64)])
@pytest.mark.parametrize("precision", [None, "highest"])
def test_conv_step_bwd_tf32_matches_plain_on_card(cuda_device, shape,
                                                  precision):
    # kernel 14 with the reference's default-tier gradients behind a TF32
    # (cnn.yaml's route) or an FP32 recompute ('highest''s), as accurate
    # against float64 as its plain version at the same tiers, bitwise from
    # run to run, counted by its tiers
    from localregneuralde_tpu_torch.ops.cuda import (
        fused_conv_step_bwd, fused_conv_step_bwd_plain,
    )

    w, spec, _, u = _conv_setup(cuda_device, *shape)
    t = torch.tensor(0.1, device=cuda_device)
    dt = torch.tensor(0.08, device=cuda_device)
    k1 = 0.5 * torch.randn_like(u)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    cts = [torch.randn(u.shape, generator=g, device=cuda_device)
           for _ in range(9)]
    rec = "tf32" if precision is None else "fp32"
    before = _tier_launches(fused_conv_step_bwd).get(f"{rec}/tf32", 0)
    ours = fused_conv_step_bwd(w, spec, u, t, dt, k1, cts,
                               precision=precision, grad_precision=None)
    assert _tier_launches(fused_conv_step_bwd)[f"{rec}/tf32"] == before + 1
    args = (w, spec, u, t, dt, k1, cts)
    ref = fused_conv_step_bwd_plain(*args, rec, "tf32")
    w64, u64, t64, dt64, k1_64 = _double(w, u, t, dt, k1)
    exact = fused_conv_step_bwd_plain(w64, spec, u64, t64, dt64, k1_64,
                                      [c.double() for c in cts])
    flat = lambda o: [o[1], o[2], *o[0]]  # noqa: E731
    # the recompute's depth where it is TF32 and the reverse chain's 19
    depth = 19 + (18 if rec == "tf32" else 0)
    _conv_as_accurate(flat(ours), flat(ref), flat(exact), depth,
                      9 * (shape[4] + 1))
    again = fused_conv_step_bwd(w, spec, u, t, dt, k1, cts,
                                precision=precision, grad_precision=None)
    assert all(torch.equal(a, b) for a, b in zip(flat(again), flat(ours)))


@pytest.mark.cuda
@pytest.mark.parametrize("orient", ["forward", "data grad", "weight grad"])
@pytest.mark.parametrize("cin,cout", [(6, 8), (8, 16), (16, 6), (64, 64),
                                      (64, 8), (16, 64)])
def test_conv_core_orientations_tf32_on_card(cuda_device, orient, cin, cout):
    # the core alone at TF32 (lrnde_conv_core's tensor-core instantiations)
    # against cuDNN FP32 on the operands rounded to TF32 (the time channel's
    # value s is not an operand of a product: the weight gradient's time
    # row is s times the sums of the rounded cotangent): both sum exact
    # products, in FP32 and with the tensor cores' truncated sums, so each
    # output within 2·K·2^-24 of the sum of its products' magnitudes;
    # bitwise from run to run, the thin convs' halo tile bitwise the gather
    # tile
    from torch.nn.grad import conv2d_input, conv2d_weight

    from localregneuralde_tpu_torch.nn import round_tf32
    from localregneuralde_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    b, h, w = 3, 7, 9
    g = torch.Generator().manual_seed(5)
    x = torch.randn(b, h, w, cin, generator=g).to(cuda_device)
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    r = round_tf32
    sc = torch.tensor([0.37, 0.0], device=cuda_device)
    code = ("forward", "data grad", "weight grad").index(orient)
    if code == 0:
        wt = torch.randn(3, 3, cin, cout, generator=g).to(cuda_device)

        def conv(a, b_):
            return torch.nn.functional.conv2d(
                nchw(a), b_.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)

        ref, mag = conv(r(x), r(wt)), conv(r(x).abs(), r(wt).abs())
        ops, k = (x, wt), 9 * cin
        out = torch.empty(b, h, w, cout, device=cuda_device)
    elif code == 1:
        wt = torch.randn(3, 3, cout + 1, cin, generator=g).to(cuda_device)

        def conv(a, b_):
            return conv2d_input((b, cout, h, w), b_[:, :, :cout].permute(
                3, 2, 0, 1), nchw(a), padding=1).permute(0, 2, 3, 1)

        ref, mag = conv(r(x), r(wt)), conv(r(x).abs(), r(wt).abs())
        ops, k = (x, wt), 9 * cin
        out = torch.empty(b, h, w, cout, device=cuda_device)
    else:
        dy = torch.randn(b, h, w, cout, generator=g).to(cuda_device)
        s_ = torch.full((b, h, w, 1), 0.37, device=cuda_device)

        def conv(a, d):
            return conv2d_weight(nchw(torch.cat([a, s_], dim=-1)),
                                 (cout, cin + 1, 3, 3), nchw(d),
                                 padding=1).permute(2, 3, 1, 0)

        ref, mag = conv(r(x), r(dy)), conv(r(x).abs(), r(dy).abs())
        ops, out, k = (x, dy), torch.empty(3, 3, cin + 1, cout,
                                           device=cuda_device), b * h * w
    scratch = torch.empty(
        lib.lrnde_conv_core_scratch_floats(code, b, h, w, cin, cout),
        device=cuda_device)
    p = _build.ptr

    def run(c=code):
        err = lib.lrnde_conv_core(c, 1, p(ops[0]), p(ops[1]), p(sc), p(out),
                                  p(scratch), b, h, w, cin, cout,
                                  _build.stream_ptr(x.device))
        _build.check(lib, err, "conv_core")
        return out.clone()

    first = run()
    bound = 2 * k * 2.0 ** -24 * mag + 1e-30
    assert bool(((first - ref).abs() <= bound).all())
    assert torch.equal(run(), first)
    if code < 2 and cout <= 8:
        assert torch.equal(run(code + 3), first)


# ------------------------------------------ the SDE family's TF32 tier (K10,
# K12): each at the reference's default tier against its plain version at
# the same tiers, on the same Philox tree and the same knots.


@pytest.mark.cuda
@pytest.mark.parametrize("batch, features, hidden",
                         [(13, 32, 64), (512, 32, 64), (37, 13, 40)])
def test_sde_solve_tf32_matches_plain_on_card(cuda_device, batch, features,
                                              hidden):
    # kernel 10 at TF32 (the MNIST-SDE widths' instantiation and the
    # generic one): the same path gives step counts within two attempts,
    # and with equal counts states within the FP32 test's 1e-3 plus one
    # evaluation's TF32 rounding of their scale; each recorded step, from
    # the kernel's own knot, as accurate against its float64 step as the
    # TF32 plain step; bitwise from run to run, counted at its tier
    from localregneuralde_tpu_torch.ops.cuda import (
        SDEWeights, persistent_sde_solve, persistent_sde_solve_plain,
    )
    from localregneuralde_tpu_torch.ops.cuda.fused_sde_solve import (
        diffusion_plain, drift_plain,
    )
    from localregneuralde_tpu_torch.sde import get_sri_tableau, sri_step

    w, x = _sde_setup(cuda_device, batch, features=features, hidden=hidden)
    kw = _sde_kw(cuda_device, batch, features=features, record_knots=True)
    before = _tier_launches(persistent_sde_solve).get("tf32", 0)
    out = persistent_sde_solve(w, x, (0.0, 1.0), precision=None, **kw)
    assert _tier_launches(persistent_sde_solve)["tf32"] == before + 1
    ref = persistent_sde_solve_plain(w, x, (0.0, 1.0), tier="tf32", **kw)
    assert bool(out["success"]) and bool(ref["success"])
    assert abs(int(out["natt"]) - int(ref["natt"])) <= 2
    if int(out["natt"]) == int(ref["natt"]):
        tol = 1e-3 + 4 * 2.0 ** -11 * float(ref["ys"].abs().max())
        torch.testing.assert_close(out["ys"], ref["ys"], atol=tol, rtol=0)
    n = int(out["naccept"])
    ts, us = out["knot_ts"][: n + 1], out["knot_us"]
    w64 = SDEWeights(*(p.double() for p in w))
    tab = get_sri_tableau("sosri")
    inc = {"kernel": [], "plain": [], "exact": []}
    for j in range(n):
        dt, dw, dz = ts[j + 1] - ts[j], out["knot_dws"][j], out["knot_dzs"][j]
        st = sri_step(lambda v, t: drift_plain(w, v, "tf32"),
                      lambda v, t: diffusion_plain(w, v, "tf32"), us[j],
                      ts[j], dt, dw, dz, 0.14, 0.14, 1 / 6, tab)
        st64 = sri_step(lambda v, t: drift_plain(w64, v),
                        lambda v, t: diffusion_plain(w64, v), us[j].double(),
                        ts[j].double(), dt.double(), dw.double(), dz.double(),
                        0.14, 0.14, 1 / 6, tab)
        inc["kernel"].append(us[j + 1] - us[j])
        inc["plain"].append(st.u_new - us[j])
        inc["exact"].append(st64.u_new - us[j].double())
    k, p, e = (torch.stack(inc[n_]) for n_ in ("kernel", "plain", "exact"))
    assert _rel(k.double(), e) <= max(2 * _rel(p.double(), e),
                                      _sum_tol(8, hidden))
    again = persistent_sde_solve(w, x, (0.0, 1.0), precision=None, **kw)
    assert torch.equal(again["ys"], out["ys"])
    assert torch.equal(again["knot_us"][: n + 1], us[: n + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("features, hidden", [(32, 64), (13, 40)])
@pytest.mark.parametrize("precision", [None, "highest"])
def test_sde_sweep_tf32_matches_plain_on_card(cuda_device, features, hidden,
                                              precision):
    # kernel 12 with the reference's default-tier gradients behind a TF32
    # (mnist_sde's route) or an FP32 recompute ('highest''s), on kernel
    # 10's knots, as accurate against the float64 plain sweep as its plain
    # version at the same tiers (the recompute's 8 products in sequence
    # where it is TF32 and the reverse chain's 9), bitwise from run to run,
    # counted by its tiers
    from localregneuralde_tpu_torch.ops.cuda import (
        SDEWeights, persistent_sde_solve, persistent_sde_sweep,
        persistent_sde_sweep_plain,
    )

    B = 64
    w, x = _sde_setup(cuda_device, B, features=features, hidden=hidden)
    kw = _sde_kw(cuda_device, B, features=features, record_knots=True)
    out = persistent_sde_solve(w, x, (0.0, 1.0), precision=precision, **kw)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    args = (out["knot_ts"], out["knot_us"], out["knot_dws"], out["knot_dzs"],
            out["naccept"], kw["saveat_arr"],
            torch.randn((2, B, features), generator=g, device=cuda_device),
            torch.randn((B, features), generator=g, device=cuda_device))
    rec = "tf32" if precision is None else "fp32"
    sw = dict(solver="sosri", delta=1 / 6)
    before = _tier_launches(persistent_sde_sweep).get(f"{rec}/tf32", 0)
    ours = persistent_sde_sweep(w, *args, **sw, precision=precision,
                                grad_precision=None)
    assert _tier_launches(persistent_sde_sweep)[f"{rec}/tf32"] == before + 1
    ref = persistent_sde_sweep_plain(w, *args, **sw, tier=rec,
                                     grad_tier="tf32")
    args64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    exact = persistent_sde_sweep_plain(
        SDEWeights(*(p.double() for p in w)), *args64, **sw)
    flat = lambda o: [o[0], *o[1]]  # noqa: E731
    depth = 9 + (8 if rec == "tf32" else 0)
    _conv_as_accurate(flat(ours), flat(ref), flat(exact), depth, hidden)
    again = persistent_sde_sweep(w, *args, **sw, precision=precision,
                                 grad_precision=None)
    assert all(torch.equal(a, b) for a, b in zip(flat(again), flat(ours)))


# ------------------------------------ the score and chain families at TF32
# Kernels 11, 6, 5 and 9 at the TF32 tier against their TF32 plain versions
# on the same inputs (both round every operand as cvt.rna does, their FP32
# sums in other orders): as accurate against float64 as the plain versions
# (_conv_as_accurate: within twice the plain's error, the tensor cores'
# truncated sums a floor), bitwise from run to run, launched at their tier.


@pytest.mark.cuda
def test_vpsde_solve_tf32_matches_plain_on_card(cuda_device):
    # kernel 11 at TF32 on the same Philox path as its TF32 plain version
    # and a float64 solve: the same accepts and rejects, y_final as
    # accurate as the plain version's
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_vpsde_solve, persistent_vpsde_solve_plain,
    )
    from localregneuralde_tpu_torch.sde import PhiloxNormals

    params, chain, x = _score_setup(cuda_device, 1000)
    kw = dict(noise=PhiloxNormals(7, 1000, 2, device=cuda_device), rtol=1e-2,
              atol=1e-2, solver="sosri", delta=1 / 6, max_steps=4096,
              saveat_arr=torch.tensor([0.5, 0.999], device=cuda_device),
              **SCHEDULE)
    before = _tier_launches(persistent_vpsde_solve).get("tf32", 0)
    out = persistent_vpsde_solve(params, chain, x, (0.0, 0.999),
                                 precision=None, **kw)
    assert _tier_launches(persistent_vpsde_solve)["tf32"] == before + 1
    ref = persistent_vpsde_solve_plain(params, chain, x, (0.0, 0.999),
                                       tier="tf32", **kw)
    exact = persistent_vpsde_solve_plain([p.double() for p in params], chain,
                                         x.double(), (0.0, 0.999), **kw)
    assert bool(out["success"]) and bool(ref["success"])
    steps = [(int(o["naccept"]), int(o["nreject"])) for o in (out, ref,
                                                                exact)]
    assert steps[0] == steps[1] == steps[2]
    _conv_as_accurate([out["y_final"]], [ref["y_final"]], [exact["y_final"]],
                      3, 65)
    again = persistent_vpsde_solve(params, chain, x, (0.0, 0.999),
                                   precision=None, **kw)
    assert torch.equal(out["ys"], again["ys"])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1001, 4096])
def test_pf_solve_tf32_matches_plain_on_card(cuda_device, batch):
    # kernel 6 at TF32: its steps follow TF32's noise in ũ as its plain
    # version's do, so the two sum orders take other steps (within two
    # attempts or a tenth of the NFE; at B = 24 the error norm averages too
    # few elements and they part by three), y_final as accurate against
    # the float64 solution as the plain version's
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_pf_solve, persistent_pf_solve_plain,
    )

    params, chain, x = _score_setup(cuda_device, batch)
    kw = dict(rtol=1e-4, atol=1e-6, max_steps=2048,
              saveat_arr=torch.tensor([0.5, 0.999], device=cuda_device),
              **SCHEDULE)
    before = _tier_launches(persistent_pf_solve).get("tf32", 0)
    out = persistent_pf_solve(params, chain, x, (0.0, 0.999), precision=None,
                              **kw)
    assert _tier_launches(persistent_pf_solve)["tf32"] == before + 1
    ref = persistent_pf_solve_plain(params, chain, x, (0.0, 0.999),
                                    tier="tf32", **kw)
    exact = persistent_pf_solve_plain(
        [p.double() for p in params], chain, x.double(), (0.0, 0.999),
        **dict(kw, rtol=1e-8, atol=1e-8, max_steps=20000))
    assert bool(out["success"]) and bool(ref["success"])
    assert abs(int(out["nfe"]) - int(ref["nfe"])) <= max(
        12, 0.1 * int(ref["nfe"]))
    _conv_as_accurate([out["y_final"]], [ref["y_final"]], [exact["y_final"]],
                      3, 65)
    again = persistent_pf_solve(params, chain, x, (0.0, 0.999),
                                precision=None, **kw)
    assert torch.equal(out["ys"], again["ys"])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [7, 512])
def test_chain_solve_tf32_matches_plain_on_card(cuda_device, batch):
    # kernel 5 at TF32 (rtol 1e-4): NFE within two attempts of its TF32
    # plain version, ys as accurate against the float64 solution as the
    # plain version's; below rtol 1e-4 the tier is refused
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_chain_solve, persistent_chain_solve_plain,
    )

    params, chain, x = _chain_setup(cuda_device, batch)
    saveat = torch.tensor([1.0, 0.0, 0.3, 0.7, 0.5], device=cuda_device)
    kw = dict(rtol=1e-4, atol=1e-4, max_steps=512, saveat_arr=saveat)
    before = _tier_launches(persistent_chain_solve).get("tf32", 0)
    out = persistent_chain_solve(params, chain, x, (0.0, 1.0), precision=None,
                                 **kw)
    assert _tier_launches(persistent_chain_solve)["tf32"] == before + 1
    ref = persistent_chain_solve_plain(params, chain, x, (0.0, 1.0),
                                       tier="tf32", **kw)
    exact = persistent_chain_solve_plain(
        [p.double() for p in params], chain, x.double(), (0.0, 1.0),
        **dict(kw, rtol=1e-10, atol=1e-10))
    assert bool(out["success"]) and bool(ref["success"])
    assert abs(int(out["nfe"]) - int(ref["nfe"])) <= 12
    assert torch.equal(out["ys"][1], x)
    _conv_as_accurate([out["ys"]], [ref["ys"]], [exact["ys"]], 8, 40)
    again = persistent_chain_solve(params, chain, x, (0.0, 1.0),
                                   precision=None, **kw)
    assert torch.equal(out["ys"], again["ys"])
    with pytest.raises(ValueError, match="1e-4"):
        persistent_chain_solve(params, chain, x, (0.0, 1.0), precision=None,
                               **dict(kw, rtol=1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("tiers", [
    ("highest", "highest"), (None, None), ("highest", "default"),
], ids=["tiers 2", "tiers 7", "tiers 3"])
def test_chain_sweep_tf32_matches_plain_on_card(cuda_device, tiers):
    # kernel 9 at the route's tier mixes (precision, recompute_precision;
    # the gradient products at the default tier: TF32) on kernel 5's knots
    # at that forward tier, checkpoints every 2 accepts: as accurate
    # against the float64 plain sweep as its plain version at the same
    # tiers (the tensor cores' truncated sums over the sweep's steps a
    # floor), bitwise from run to run; its two-level branch (capacity 1)
    # replays the forward bitwise (a TF32 forward with kernel 5's TF32
    # attempt)
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_chain_solve, persistent_chain_sweep,
        persistent_chain_sweep_plain,
    )
    from localregneuralde_tpu_torch.ops.cuda.fused_solve_bwd import (
        sweep_tiers,
    )

    precision, recompute = tiers
    params, chain, x = _chain_setup(cuda_device, 64)
    saveat = torch.linspace(0.0, 1.0, 7, device=cuda_device)
    stride = 2
    rec = persistent_chain_solve(
        params, chain, x, (0.0, 1.0), rtol=1e-4, atol=1e-4,
        saveat_arr=saveat, max_steps=512, record_knots=True,
        knot_stride=stride, precision=precision)
    n = int(rec["naccept"])
    assert n > stride
    g = torch.Generator(device=cuda_device).manual_seed(5)
    ct_ys = torch.randn((7, 64, 20), generator=g, device=cuda_device)
    ct_y = torch.randn((64, 20), generator=g, device=cuda_device)
    args = (params, chain, rec["knot_ts"], rec["knot_us"], rec["naccept"],
            saveat, ct_ys, ct_y)
    kw = dict(precision=precision, grad_precision=None,
              recompute_precision=recompute)
    t = sweep_tiers(precision, None, recompute, cuda_device)
    key = "/".join(t)
    before = _tier_launches(persistent_chain_sweep).get(key, 0)
    ours = persistent_chain_sweep(*args, **kw)
    assert _tier_launches(persistent_chain_sweep)[key] == before + 1
    ref = persistent_chain_sweep_plain(*args, tiers=t)
    args64 = ([p.double() for p in params], chain) + tuple(
        a.double() if a.is_floating_point() else a for a in args[2:])
    exact = persistent_chain_sweep_plain(*args64)
    flat = lambda o: [o[0], o[1], *o[2]]  # noqa: E731
    depth = 6 * 8 + 1 + (7 * 8 if t[1] == "tf32" else 0)
    _conv_as_accurate(flat(ours), flat(ref), flat(exact), n * depth, 40)
    again = persistent_chain_sweep(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(flat(again), flat(ours)))
    ctx = {k: rec[k] for k in rec if k.startswith("ckpt_")}
    ctx.update(t_end=1.0, rtol=1e-4, atol=1e-4, max_steps=512,
               stride=stride, dense_cap=1)
    win, replay = persistent_chain_sweep(*args, two_level_ctx=ctx,
                                         return_replay=True, **kw)
    m = min(n, stride)
    assert torch.equal(replay[:m + 1], rec["knot_us"][:m + 1])
    for a, b in zip(flat(win), flat(ours)):
        assert _rel(a, b) <= 1e-6


@pytest.mark.cuda
def test_solve_operators_pass_opcheck_on_card(cuda_device):
    """The registered serving operators (``ops/cuda/serving.py``) with
    CUDA inputs: schema, fake implementation and dispatch
    (``torch.library.opcheck``), each launching its kernel."""
    from localregneuralde_tpu_torch.ops.cuda import serving

    g = torch.Generator().manual_seed(0)

    def r(*s):
        return (0.3 * torch.randn(*s, generator=g)).to(cuda_device)

    F, H, B = 32, 64, 40
    saveat = torch.tensor([0.5, 1.0], device=cuda_device)
    for tier in ("fp32", "tf32"):
        torch.library.opcheck(serving._tsit5_op, (
            r(F + 1, H), r(H), r(H + 1, F), r(F), r(B, F), saveat, 0.0, 1.0,
            1e-3, 1e-3, 64, tier))
    seed = torch.tensor([5], dtype=torch.int32, device=cuda_device)
    torch.library.opcheck(serving._sde_op, (
        r(F, H), r(H), r(H, F), r(F), r(F, F), r(F), r(B, F), seed, saveat,
        0.0, 1.0, 0.14, 0.14, 1e-3, "sosri", 256, 24, "tf32"))
    torch.library.opcheck(serving._pf_op, (
        [r(3, 16), r(16), r(17, 2), r(2)], r(B, 2), saveat, [2, 16, 2],
        [True, False], 0.0, 0.999, 1e-3, 1e-3, 256, 0.1, 20.0, 1.0, "tf32"))
    for tier in ("fp32", "tf32"):
        torch.library.opcheck(serving._chain_op, (
            [r(20, 40), r(40), r(40, 20), r(20)], [20, 40, 20],
            [True, True], True, r(B, 20), saveat, 0.0, 1.0, 1e-3, 1e-3, 64,
            tier))
    Cs, Ch = 8, 16
    weights = [r(3, 3, Cs + 1, Ch), 1 + r(Ch), r(Ch), r(3, 3, Ch + 1, Ch),
               1 + r(Ch), r(Ch), r(3, 3, Ch + 1, Cs)]
    for eval_stats, tier in (("running", "fp32"), ("running", "tf32"),
                             ("batch", "tf32")):
        torch.library.opcheck(serving._conv_op, (
            weights, [r(Ch), 1 + r(Ch).abs(), r(Ch), 1 + r(Ch).abs()],
            r(4, 8, 8, Cs), saveat, Cs, Ch, 0.1, 1e-5, eval_stats, 0.0, 1.0,
            1e-3, 1e-3, 64, tier))


@pytest.mark.cuda
def test_serving_operators_never_run_a_plain_version(cuda_device,
                                                     monkeypatch):
    """A CUDA input reaches the kernel through each operator, never its
    plain version (made to raise here), and counts one launch (the conv
    family's solve: kernel 13's, one an attempt)."""
    from localregneuralde_tpu_torch.ops.cuda import (
        DenseChainSpec, SDEWeights, ScoreChainSpec, fused_conv,
        persistent_chain_solve, persistent_pf_solve, reset_launch_counts,
        serving, tier_launch_counts,
    )

    def refuse(*a, **k):
        raise AssertionError("a CUDA input reached a plain version")

    for name in ("persistent_tsit5_solve_plain", "persistent_sde_solve_plain",
                 "persistent_pf_solve_plain", "persistent_chain_solve_plain"):
        monkeypatch.setattr(serving, name, refuse)
    monkeypatch.setattr(fused_conv, "conv_step_plain", refuse)
    w, x = _card_setup(cuda_device, 64, 32, 16)
    g = torch.Generator().manual_seed(1)
    sw = SDEWeights(*[(0.3 * torch.randn(s, generator=g)).to(cuda_device)
                      for s in ((32, 16), (16,), (16, 32), (32,), (32, 32),
                                (32,))])
    saveat = torch.tensor([1.0], device=cuda_device)
    reset_launch_counts()
    persistent_tsit5_solve(w, x, (0.0, 1.0), rtol=1e-4, atol=1e-4,
                           max_steps=64, saveat_arr=saveat)
    persistent_chain_solve(
        [p.to(cuda_device) for p in (
            0.3 * torch.randn(32, 16, generator=g), torch.zeros(16),
            0.3 * torch.randn(16, 32, generator=g), torch.zeros(32))],
        DenseChainSpec((32, 16, 32), (True, True), True), x, (0.0, 1.0),
        rtol=1e-4, atol=1e-4, saveat_arr=saveat, max_steps=64)
    Cs, Ch = 8, 16
    cw = [(0.2 * torch.randn(s, generator=g)).to(cuda_device)
          for s in ((3, 3, Cs + 1, Ch), (Ch,), (Ch,), (3, 3, Ch + 1, Ch),
                    (Ch,), (Ch,), (3, 3, Ch + 1, Cs))]
    spec = fused_conv.ConvFamilySpec(Cs, Ch, 0.1, 1e-5, "running", ())
    out = serving.conv_solve(
        fused_conv.ConvWeights(*cw), spec, fused_conv.default_rstats(spec, x),
        torch.rand(4, 8, 8, Cs, generator=g).to(cuda_device), (0.0, 1.0),
        rtol=1e-3, atol=1e-3, saveat_arr=saveat, max_steps=64, tier="fp32")
    counts = tier_launch_counts()
    assert counts["persistent_tsit5_solve"] == {"fp32": 1}
    assert counts["persistent_chain_solve"] == {"fp32": 1}
    assert counts["fused_conv_step"] == {
        "fp32": int(out["naccept"]) + int(out["nreject"])}
    seed = torch.tensor([3], dtype=torch.int32, device=cuda_device)
    serving.sde_solve(sw, x, seed, (0.0, 1.0), rtol=0.14, atol=0.14,
                      solver="sosri", delta=1e-3, saveat_arr=saveat,
                      max_steps=256, tier="fp32")
    params = [p.to(cuda_device) for p in (
        0.3 * torch.randn(3, 16, generator=g), torch.zeros(16),
        0.3 * torch.randn(17, 2, generator=g), torch.zeros(2))]
    persistent_pf_solve(params, ScoreChainSpec((2, 16, 2), (True, False),
                                               ("a", "b")),
                        torch.rand(64, 2, generator=g).to(cuda_device),
                        (0.0, 0.999),
                        rtol=1e-3, atol=1e-3, saveat_arr=saveat,
                        max_steps=256, beta_min=0.1, beta_max=20.0, t1=1.0)
    counts = tier_launch_counts()
    assert counts["persistent_sde_solve"] == {"fp32": 1}
    assert counts["persistent_pf_solve"] == {"fp32": 1}


@pytest.mark.cuda
def test_export_on_card_equals_the_live_model(cuda_device, tmp_path):
    """A tiny TD-MLP classifier on the card: its loaded artifact is
    ``torch.equal`` to the live model, NFE included, through kernel 4."""
    from localregneuralde_tpu_torch.models import (
        NeuralODE, TDChain, diffeqsol_to_array,
    )
    from localregneuralde_tpu_torch.nn import (
        Chain, Dense, Flatten, WrappedFunction,
    )
    from localregneuralde_tpu_torch.ops.cuda import (
        reset_launch_counts, tier_launch_counts,
    )
    from localregneuralde_tpu_torch.utils import (
        export_model, load_exported, save_exported,
    )

    g = torch.Generator().manual_seed(0)
    model = Chain(
        flatten=Flatten(),
        neural_ode=NeuralODE(TDChain(Dense(13, 8, "tanh", generator=g),
                                     Dense(9, 12, generator=g)),
                             rtol=1e-3, atol=1e-3, max_steps=64),
        sol_to_arr=WrappedFunction(diffeqsol_to_array),
        classifier=Dense(12, 3, generator=g)).to(cuda_device)
    st = model.init_state()
    x = torch.rand(40, 3, 4, 1, generator=g).to(cuda_device)
    save_exported(export_model(model, None, st, x, with_state=True),
                  str(tmp_path / "m.lrnde"))
    fn = load_exported(str(tmp_path / "m.lrnde"))
    reset_launch_counts()
    y, st_out = fn(x)
    assert tier_launch_counts()["persistent_tsit5_solve"] == {"tf32": 1}
    with torch.no_grad():
        y_live, st_live = model(x, st, training=False)
    assert torch.equal(y, y_live)
    assert int(st_out["neural_ode"]["nfe"]) == int(st_live["neural_ode"]["nfe"])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["latent", "cifar"])
def test_export_on_card_families(family, cuda_device, tmp_path):
    """The latent ODE (``physionet.yaml`` at small widths) and the CIFAR
    classifier (``cnn.yaml`` at 8×8 images) on the card: each loaded
    artifact is ``torch.equal`` to the live model, NFE included, and runs
    the live model's kernel launches: kernel 5 once, kernel 13 once an
    attempt of the solve."""
    import os

    from localregneuralde_tpu_torch.harness import (
        construct_model, construct_time_series, define_configuration,
    )
    from localregneuralde_tpu_torch.ops.cuda import (
        reset_launch_counts, tier_launch_counts,
    )
    from localregneuralde_tpu_torch.utils import (
        export_model, load_exported, save_exported,
    )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    g = torch.Generator().manual_seed(0)
    if family == "latent":
        cfg = define_configuration([
            "--model.ts_in_dims=5", "--model.ts_hidden_dims=8",
            "--model.ts_latent_dims=6", "--model.ts_node_dims=4",
            "--model.solver.reltol=1e-3", "--model.solver.abstol=1e-3",
            "--model.solver.max_steps=64"],
            os.path.join(root, "experiments", "physionet", "physionet.yaml"))
        model = construct_time_series(
            cfg, saveat=torch.linspace(0.0, 1.0, 7), device=cuda_device)
        x = torch.rand(16, 7, 11, generator=g).to(cuda_device)
        wrapper = "persistent_chain_solve"
    else:
        cfg = define_configuration([
            "--model.solver.reltol=1e-2", "--model.solver.abstol=1e-2",
            "--model.solver.max_steps=64"],
            os.path.join(root, "experiments", "cifar10", "cnn.yaml"))
        cfg.model.image_size = [8, 8]
        model = construct_model(cfg, device=cuda_device)
        x = torch.rand(8, 8, 8, 3, generator=g).to(cuda_device)
        wrapper = "fused_conv_step"
    st = model.init_state()
    ep = export_model(model, None, st, x, with_state=True)
    save_exported(ep, str(tmp_path / "m.lrnde"))
    fn = load_exported(str(tmp_path / "m.lrnde"))
    reset_launch_counts()
    with torch.no_grad():
        y, st_out = fn(x)
    served = tier_launch_counts()[wrapper]
    reset_launch_counts()
    with torch.no_grad():
        y_live, st_live = model(x, st, training=False)
    assert tier_launch_counts()[wrapper] == served
    nfe = int(st_out["neural_ode"]["nfe"])
    assert torch.equal(y, y_live)
    assert nfe == int(st_live["neural_ode"]["nfe"])
    assert served == {"tf32": 1 if family == "latent" else (nfe - 2) // 6}
