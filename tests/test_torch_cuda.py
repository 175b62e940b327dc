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
@pytest.mark.parametrize("batch", [8, 13, 512])
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
        err = lib.lrnde_conv_core(code, p(ops[0]), p(ops[1]), p(sc), p(out),
                                  p(scratch), b, h, w, cin, cout,
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
@pytest.mark.parametrize("shape", [(2, 5, 7, 16, 24), (4, 32, 32, 64, 64)])
def test_conv_orient_matches_plain_on_card(cuda_device, shape):
    # kernel 15's two layouts against cuDNN in FP32: 1e-5 of the largest
    # value (FP32 sums in another order)
    from localregneuralde_tpu_torch.ops.cuda import (
        conv_orient_im2col, conv_orient_plain, conv_orient_tap,
    )

    b, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(1)
    x = torch.rand(b, h, w, cin, generator=g).to(cuda_device)
    wt = (0.05 * torch.randn(3, 3, cin, cout, generator=g)).to(cuda_device)
    ref = conv_orient_plain(x, wt)
    assert _rel(conv_orient_tap(x, wt), ref) <= 1e-5
    assert _rel(conv_orient_im2col(x, wt), ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("batch,hidden", [(1, 100), (410, 100), (512, 100),
                                          (1000, 100), (410, 150)])
def test_cluster_solve_on_card(cuda_device, batch, hidden):
    """Kernel 4 on its clusters against the eager loop (rtol 1e-4, as
    above), bitwise repeatable; its cluster evaluation bitwise kernel 1's.
    B = 1000 has more row blocks than resident clusters; at H = 150 the
    weight slices do not fit beside the tiles and stay in global memory."""
    from localregneuralde_tpu_torch.ops.cuda import _build, fused_solve

    w, x = _card_setup(cuda_device, batch, 784, hidden)
    plan = fused_solve.solve_plan(batch, 784, hidden)
    assert plan.weights_shared == (hidden == 100)
    clusters = _build.load_library().lrnde_solve_clusters(batch, 784, hidden)
    assert 1 <= clusters <= len(plan.row_blocks)
    if batch == 1000:
        assert clusters < len(plan.row_blocks)
    for s in (0.0, 0.3):
        assert torch.equal(fused_solve.solve_eval(w, x, s),
                           fused_tdmlp(w, x, s))
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
