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
@pytest.mark.parametrize("batch", [13, 512])
def test_chain_solve_matches_plain_on_card(cuda_device, batch):
    # kernel 5 against the eager loop with the plain chain: FP32 sums in
    # another order, so at rtol 1e-4 the two agree step for step up to an
    # ulp-level accept flip; the saveat times are unsorted and one is t0
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
