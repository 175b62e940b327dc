"""The latent-ODE slice of the port against the JAX package on the CPU: the
GRU encoder, reparameterisation, losses and data, kernel 5's and kernel 9's
plain versions against JAX's Dense-chain kernels (interpret mode), the whole
``construct_time_series`` model, and the port's runner.

Sizes are small: in_dims 5, hidden 8, latent 6, node 4, T = 7, B = 8; the
chain of ``tests/test_chain_persistent.py`` (F = 6, H = 10, four layers).
Inputs are made from numpy seeds; JAX's random draws (t1, ε, the reservoir's
uniforms) are injected into the port. Tolerances are stated per test.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.harness.config import (
    define_configuration as jax_define_configuration,
)
from localregneuralde_tpu.harness.construct import (
    construct_loss as jax_construct_loss,
    construct_optimizer as jax_construct_optimizer,
    construct_time_series as jax_construct_time_series,
)
from localregneuralde_tpu.harness.data import (
    Dataloader as JDataloader,
    synthetic_physionet as jax_synthetic_physionet,
)
from localregneuralde_tpu.harness.latent_runner import (
    build_physionet_arrays as jax_build_physionet_arrays,
)
from localregneuralde_tpu.harness.losses import (
    kl_divergence as jax_kl_divergence,
    log_likelihood_loss as jax_log_likelihood_loss,
)
from localregneuralde_tpu.harness.train import (
    create_train_state as jax_create_train_state,
    make_train_step as jax_make_train_step,
)
from localregneuralde_tpu.models import (
    LatentGRUCell as JLatentGRUCell,
    ReparameterizeLayer as JReparameterizeLayer,
)
from localregneuralde_tpu.nn import Chain as JChain, Dense as JDense
from localregneuralde_tpu.nn.basic import Lambda as JLambda
from localregneuralde_tpu.nn.recurrence import Recurrence as JRecurrence
from localregneuralde_tpu.ops.pallas.fused_solve import (
    match_dense_chain as jax_match_dense_chain,
    persistent_chain_solve as jax_chain_solve,
)
from localregneuralde_tpu.ops.pallas.fused_solve_bwd import (
    persistent_chain_sweep as jax_chain_sweep,
)
from localregneuralde_tpu_torch.harness import (
    construct_loss,
    construct_model,
    construct_optimizer,
    construct_time_series,
    create_train_state,
    define_configuration,
    make_train_step,
)
from localregneuralde_tpu_torch.harness import latent_runner
from localregneuralde_tpu_torch.harness.checkpoint import load_checkpoint
from localregneuralde_tpu_torch.harness.data import (
    Dataloader,
    synthetic_physionet,
)
from localregneuralde_tpu_torch.harness.latent_runner import (
    build_physionet_arrays,
    eval_forward,
    run_latent_ode_experiment,
)
from localregneuralde_tpu_torch.harness.losses import (
    kl_divergence,
    log_likelihood_loss,
)
from localregneuralde_tpu_torch.models import (
    LatentGRUCell,
    NeuralODE,
    ReparameterizeLayer,
    common,
    diffeqsol_to_timeseries,
    neural_ode,
)
from localregneuralde_tpu_torch.nn import Chain, Dense, Lambda, Recurrence
from localregneuralde_tpu_torch.ode import ODESolution
from localregneuralde_tpu_torch.ops.cuda import (
    DenseChainSpec,
    match_dense_chain,
    persistent_chain_solve_plain,
    persistent_chain_sweep_plain,
)
from localregneuralde_tpu_torch.parity import (
    latent_tree,
    load_jax_params,
    params_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "experiments", "physionet", "physionet.yaml")
IN, HID, LAT, NODE, T, B = 5, 8, 6, 4, 7, 8
SMALL = [
    f"--model.ts_in_dims={IN}", f"--model.ts_hidden_dims={HID}",
    f"--model.ts_latent_dims={LAT}", f"--model.ts_node_dims={NODE}",
    "--model.solver.reltol=1e-3", "--model.solver.abstol=1e-3",
    "--model.solver.max_steps=64",
]


def _close_rel(ours, ref, rel):
    """max-abs difference within ``rel`` of the largest reference value."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert float(np.abs(ours - ref).max()) <= rel * scale


def _series(seed, n=B):
    """(data, mask, dt) of n series on a T-point grid, and the grid."""
    data, mask, tgrid = synthetic_physionet(n=n, t_steps=T, features=IN,
                                            seed=seed)
    dt = np.concatenate([tgrid[1:] - tgrid[:-1], [0.0]]).astype(np.float32)
    dt = np.ascontiguousarray(np.broadcast_to(dt[None, :, None], (n, T, 1)))
    return (data, mask, dt), tgrid


# ------------------------------------------------------------ encoder layers

def _gru(seed=0):
    jcell = JLatentGRUCell(IN, HID, LAT)
    ps, st = jcell.init(jax.random.PRNGKey(seed))
    cell = LatentGRUCell(IN, HID, LAT)
    load_jax_params(cell, jax.tree_util.tree_map(np.asarray, ps))
    return jcell, ps, st, cell


def test_gru_cell_matches_jax_with_both_quirks():
    """One step of the cell from a random carry, f32 sums in another
    order: atol 1e-6. Row 0 has no observation but Δt > 0, so quirk 2 (the
    mask counts Δt) updates it; row 1 has neither, so it keeps its carry;
    quirk 1 (the mean from the std half) shows in every updated row."""
    jcell, ps, st, cell = _gru()
    rng = np.random.default_rng(1)
    data = rng.standard_normal((B, IN)).astype(np.float32)
    mask = (rng.random((B, IN)) < 0.5).astype(np.float32)
    dt = np.full((B, 1), 0.1, np.float32)
    mask[0], mask[1], dt[1] = 0.0, 0.0, 0.0
    x = np.concatenate([data, mask, dt], axis=-1)
    mean = rng.standard_normal((B, LAT)).astype(np.float32)
    std = rng.random((B, LAT)).astype(np.float32)
    (jy, (jm, js)), _ = jcell(ps, st, (jnp.asarray(x), (jnp.asarray(mean),
                                                        jnp.asarray(std))))
    (y, (m, s)), _ = cell((torch.tensor(x), (torch.tensor(mean),
                                             torch.tensor(std))),
                          cell.init_state())
    for ours, ref in ((y, jy), (m, jm), (s, js)):
        np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                                   atol=1e-6)
    assert not np.allclose(m[0].detach().numpy(), mean[0])  # Δt alone updates
    np.testing.assert_array_equal(m[1].detach().numpy(), mean[1])
    np.testing.assert_array_equal(s[1].detach().numpy(), std[1])
    # quirk 1: an updated row's mean mixes the new state's std half
    yc = torch.cat([torch.tensor(mean), torch.tensor(std), torch.tensor(x)], -1)
    u = cell.update_gate(yc, cell.update_gate.init_state())[0]
    r = cell.reset_gate(yc, cell.reset_gate.init_state())[0]
    nc = torch.cat([torch.tensor(mean) * r, torch.tensor(std) * r,
                    torch.tensor(x)], -1)
    std_half = cell.new_state(nc, cell.new_state.init_state())[0][:, LAT:]
    want = (1 - u) * std_half + u * torch.tensor(mean)
    np.testing.assert_allclose(m[0].detach().numpy(), want[0].detach().numpy(),
                               atol=1e-6)


def test_recurrence_matches_jax():
    """The encoder over T = 7 steps of the synthetic series: atol 1e-5
    (seven cells of f32 rounding)."""
    jcell, ps, st, cell = _gru(2)
    (data, mask, dt), _ = _series(3)
    x = np.concatenate([data, mask, dt], axis=-1)
    jy, _ = JRecurrence(jcell)(ps, st, jnp.asarray(x))
    rec = Recurrence(cell)
    y, _ = rec(torch.tensor(x), rec.init_state())
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5)


@pytest.mark.parametrize("training", [True, False])
def test_reparameterize_matches_jax(training, monkeypatch):
    """With JAX's ε injected, μ + exp(logσ²/2)·ε to f32 rounding (rtol
    1e-6); in eval mode μ, with the reference's state quirk logvar = μ."""
    layer = JReparameterizeLayer()
    _, st = layer.init(jax.random.PRNGKey(4))
    x = np.random.default_rng(5).standard_normal((B, 2 * NODE)).astype(
        np.float32)
    jy, jst = layer({}, st, jnp.asarray(x), training=training)
    eps = jax.random.normal(jax.random.split(st["rng"])[1], (B, NODE))
    monkeypatch.setattr(common, "reparam_noise",
                        lambda g, shape, like: torch.tensor(np.asarray(eps)))
    ours = ReparameterizeLayer()
    y, ost = ours(torch.tensor(x), ours.init_state(), training=training)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-7)
    for k in ("mu", "logvar"):
        np.testing.assert_array_equal(ost[k].numpy(), np.asarray(jst[k]))


def test_timeseries_adapter_and_losses_match_jax():
    """diffeqsol_to_timeseries is a transpose (exact); the masked NLL and
    the KL term to f32 rounding (rtol 1e-6)."""
    rng = np.random.default_rng(6)
    ys = rng.standard_normal((T, B, NODE)).astype(np.float32)
    sol = ODESolution(ts=None, ys=torch.tensor(ys), t_final=None,
                      y_final=None, nfe=None, naccept=None, nreject=None,
                      success=None)
    np.testing.assert_array_equal(diffeqsol_to_timeseries(sol).numpy(),
                                  np.moveaxis(ys, 0, 1))
    dpred = rng.standard_normal((B, T, IN)).astype(np.float32) * 0.02
    mask = (rng.random((B, T, IN)) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        log_likelihood_loss(torch.tensor(dpred), torch.tensor(mask)).numpy(),
        np.asarray(jax_log_likelihood_loss(jnp.asarray(dpred),
                                           jnp.asarray(mask))), rtol=1e-6)
    mu = rng.standard_normal((B, NODE)).astype(np.float32)
    logvar = rng.standard_normal((B, NODE)).astype(np.float32)
    np.testing.assert_allclose(
        kl_divergence(torch.tensor(mu), torch.tensor(logvar)).numpy(),
        np.asarray(jax_kl_divergence(jnp.asarray(mu), jnp.asarray(logvar))),
        rtol=1e-6)


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("difficulty", ["easy", "hard"])
def test_synthetic_physionet_is_bitwise_jax(difficulty):
    ours = synthetic_physionet(n=64, t_steps=49, features=37, seed=3,
                               difficulty=difficulty)
    ref = jax_synthetic_physionet(n=64, t_steps=49, features=37, seed=3,
                                  difficulty=difficulty)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fixture", [True, False])
def test_build_physionet_arrays_is_bitwise_jax(fixture):
    """The npz branch on ``tests/fixtures/physionet/physionet.npz`` (40
    series) and the synthetic branch (2048 series; its test split is the
    410 the runner evaluates)."""
    extra = ([f"--dataset.data_root={ROOT}/tests/fixtures/physionet"]
             if fixture else [])
    ours = build_physionet_arrays(define_configuration(extra, CONFIG))
    ref = jax_build_physionet_arrays(jax_define_configuration(extra, CONFIG))
    assert ours[3] == ref[3] == fixture
    if not fixture:
        assert ours[0][0].shape[0] == 1638 and ours[1][0].shape[0] == 410
    for a, b in zip(jax.tree_util.tree_leaves(ours[:3]),
                    jax.tree_util.tree_leaves(ref[:3])):
        np.testing.assert_array_equal(a, b)


def test_dataloader_matches_jax_and_skips_to_nothing():
    """Shuffled, cycling and resumed mid-epoch: JAX's batches exactly. A
    loader that does not cycle and skips all its batches yields nothing
    (the reference's yields a later epoch, ROADMAP Queue 3)."""
    arrays = (np.arange(40, dtype=np.float32).reshape(20, 2),
              np.arange(20, dtype=np.float32))
    kw = dict(shuffle=True, cycle=True, seed=5, skip_batches=3)
    ours, ref = Dataloader(arrays, 6, **kw), JDataloader(arrays, 6, **kw)
    for _, a, b in zip(range(7), ours, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for skip in (3, 4):
        assert list(Dataloader(arrays, 6, shuffle=True, skip_batches=skip)) \
            == []
    assert len(list(Dataloader(arrays, 6, skip_batches=2))) == 1


# ------------------------------------------------- kernels 5 and 9 (plain)

CF, CH = 6, 10
CRTOL = 1e-3
CSAVE = np.array([0.5, 0.0, 1.0, 0.25, 0.75, 0.1, 0.9], np.float32)


def _chain_setup(seed=0):
    jgen = JChain(JLambda(jnp.tanh), JDense(CF, CH, "tanh"),
                  JDense(CH, CF, "tanh"), JDense(CF, CH, "tanh"),
                  JDense(CH, CF, "tanh"))
    ps, _ = jgen.init(jax.random.PRNGKey(seed))
    ps = jax.tree_util.tree_map(np.asarray, ps)
    rng = np.random.default_rng(seed + 1)
    # doubled Glorot weights: the chain then takes six steps at rtol 1e-3
    for k in ("layer_1", "layer_2", "layer_3", "layer_4"):
        ps[k]["w"] = 2.0 * ps[k]["w"]
        ps[k]["b"] = (0.1 * rng.standard_normal(ps[k]["b"].shape)).astype(
            np.float32)
    x = (0.8 * rng.standard_normal((B, CF))).astype(np.float32)
    params = [torch.tensor(ps[k][n]) for k in
              ("layer_1", "layer_2", "layer_3", "layer_4") for n in ("w", "b")]
    return jgen, ps, x, params


def test_match_dense_chain_and_family():
    """The port's matcher finds what the reference's does: dims, acts and
    the leading tanh by identity; NeuralODE admits the chain under
    use_pallas='on' and still refuses other shapes."""
    jgen = _chain_setup()[0]
    spec, _, dims = jax_match_dense_chain(jgen)
    gen = Chain(Lambda(torch.tanh), Dense(CF, CH, "tanh"), Dense(CH, CF))
    assert match_dense_chain(gen) == DenseChainSpec((CF, CH, CF),
                                                    (True, False), True)
    assert dims == (CF, CH, CF, CH, CF) and spec[2] == (True,) * 4
    assert match_dense_chain(Chain(Lambda(torch.sigmoid),
                                   Dense(CF, CF))) is None
    assert match_dense_chain(Chain(Dense(CF, CH, "relu"), Dense(CH, CF))) \
        is None
    assert NeuralODE(gen, use_pallas="on").family == "chain"
    with pytest.raises(ValueError):
        NeuralODE(Chain(Dense(CF, CH, "relu"), Dense(CH, CF)),
                  use_pallas="on")


@pytest.fixture(scope="module")
def jax_chain_run():
    """JAX's chain kernel (interpret mode) recording dense knots and
    checkpoints every 2 accepts, with the reservoir."""
    jgen, ps, x, params = _chain_setup()
    info = jax_match_dense_chain(jgen)
    key = jax.random.PRNGKey(9)
    out = jax_chain_solve(
        ps, info, jnp.asarray(x), (0.0, 1.0), rtol=CRTOL, atol=CRTOL,
        saveat_arr=jnp.asarray(CSAVE), max_steps=64, record_knots=True,
        knot_stride=2, reservoir_key=key,
    )
    uniforms = np.asarray(jax.random.uniform(key, (64,), jnp.float32))
    out = {k: (None if v is None else np.asarray(v)) for k, v in out.items()}
    return dict(ps=ps, x=x, params=params, info=info, out=out,
                uniforms=uniforms)


def _spec():
    return DenseChainSpec((CF, CH, CF, CH, CF), (True,) * 4, True)


def test_chain_solve_plain_matches_jax_kernel(jax_chain_run):
    """Kernel 5's plain version against JAX's persistent_chain_solve at rtol
    1e-3, where both take the same steps: counts and NFE equal, the states
    to atol 1e-5 (f32 sums in another order); the saveat grid is unsorted
    and holds t0, which returns u0 exactly."""
    r = jax_chain_run
    ref = r["out"]
    ours = persistent_chain_solve_plain(
        r["params"], _spec(), torch.tensor(r["x"]), (0.0, 1.0), rtol=CRTOL,
        atol=CRTOL, saveat_arr=torch.tensor(CSAVE), max_steps=64)
    for k in ("naccept", "nreject", "nfe"):
        assert int(ours[k]) == int(ref[k]), k
    assert bool(ours["success"]) and bool(ref["success"])
    np.testing.assert_allclose(ours["ys"].numpy(), ref["ys"], atol=1e-5)
    np.testing.assert_allclose(ours["y_final"].numpy(), ref["y_final"],
                               atol=1e-5)
    np.testing.assert_array_equal(ours["ys"][1].numpy(), r["x"])


def test_chain_recording_and_reservoir_match_jax_kernel(jax_chain_run):
    """With knots, checkpoints every 2 accepts and JAX's reservoir uniforms
    injected: the same accepts, and the reservoir sample at the same
    accepted step. The embedded error estimate carries f32 rounding (~1%
    of ũ at these sizes, ROADMAP Queue 3), so the step sizes after the first
    differ slightly: knot times and states agree to 1e-4 (measured 2.7e-5),
    the recorded controller state to 3% (dt) and 1% (qold) (measured 0.9%
    and 0.2%), the recorded k1 to 1e-3 (measured 1.8e-4)."""
    r = jax_chain_run
    ref = r["out"]
    ours = persistent_chain_solve_plain(
        r["params"], _spec(), torch.tensor(r["x"]), (0.0, 1.0), rtol=CRTOL,
        atol=CRTOL, saveat_arr=torch.tensor(CSAVE), max_steps=64,
        record_knots=True, knot_stride=2,
        reservoir=torch.tensor(r["uniforms"]))
    n = int(ref["naccept"])
    assert int(ours["naccept"]) == n > 4
    np.testing.assert_allclose(ours["knot_ts"][:n + 1].numpy(),
                               ref["knot_ts"][:n + 1], atol=1e-4)
    np.testing.assert_allclose(ours["knot_us"][:n + 1].numpy(),
                               ref["knot_us"][:n + 1, :, :CF], atol=1e-4)
    c = n // 2 + 1
    for k, rtol, atol in (("ckpt_ts", 0, 1e-4), ("ckpt_dts", 3e-2, 0),
                          ("ckpt_qolds", 1e-2, 0), ("ckpt_us", 0, 1e-4),
                          ("ckpt_ks", 0, 1e-3)):
        want = ref[k][:c, :, :CF] if ref[k].ndim == 3 else ref[k][:c]
        np.testing.assert_allclose(ours[k][:c].numpy(), want, rtol=rtol,
                                   atol=atol, err_msg=k)
    j = int(np.argmin(np.abs(ref["knot_ts"][:n] - ref["reservoir_t"])))
    assert float(ref["knot_ts"][j]) == float(ref["reservoir_t"])
    assert int(torch.argmin((ours["knot_ts"][:n]
                             - ours["reservoir_t"]).abs())) == j
    np.testing.assert_allclose(ours["reservoir_u"].numpy(),
                               ref["reservoir_u"], atol=1e-4)


@pytest.mark.parametrize("two_level", [False, True])
def test_chain_sweep_plain_matches_jax_kernel(jax_chain_run, two_level):
    """Kernel 9's plain version against JAX's persistent_chain_sweep, both
    fed the knots JAX recorded: dense, and two-level with capacity 2 so
    both replay every window from JAX's checkpoints (at rtol 1e-3 the
    plain replay takes JAX's accepts, its step times within 1e-4). a_u, a_k
    and every layer's gradients within 1e-4 of the largest value (FP32 sums
    in another order, as in tests/test_torch_adjoint.py; measured 1.6e-5
    dense, 3.9e-5 two-level)."""
    r = jax_chain_run
    ref = r["out"]
    rng = np.random.default_rng(10)
    ct_ys = rng.standard_normal((len(CSAVE), B, CF)).astype(np.float32)
    ct_y = rng.standard_normal((B, CF)).astype(np.float32)
    ctx = jctx = None
    if two_level:
        ck = ("ckpt_ts", "ckpt_us", "ckpt_ks", "ckpt_dts", "ckpt_qolds")
        jctx = {k: jnp.asarray(ref[k]) for k in ck}
        jctx.update(t_end=1.0, rtol=CRTOL, atol=CRTOL, max_steps=64,
                    stride=2, dense_cap=2, use_reservoir=False)
        ctx = {k: torch.tensor(ref[k][..., :CF] if ref[k].ndim == 3
                               else ref[k]) for k in ck}
        ctx.update(t_end=1.0, rtol=CRTOL, atol=CRTOL, max_steps=64, stride=2,
                   dense_cap=2)
    ja_u, ja_k, jd = jax_chain_sweep(
        r["ps"], r["info"], jnp.asarray(ref["knot_ts"]),
        jnp.asarray(ref["knot_us"]), jnp.asarray(ref["naccept"]),
        jnp.asarray(CSAVE), jnp.asarray(ct_ys), jnp.asarray(ct_y),
        two_level_ctx=jctx)
    a_u, a_k, grads = persistent_chain_sweep_plain(
        r["params"], _spec(), torch.tensor(ref["knot_ts"]),
        torch.tensor(ref["knot_us"][..., :CF]),
        torch.tensor(ref["naccept"]), torch.tensor(CSAVE),
        torch.tensor(ct_ys), torch.tensor(ct_y), two_level_ctx=ctx)
    _close_rel(a_u.numpy(), ja_u, 1e-4)
    _close_rel(a_k.numpy(), ja_k, 1e-4)
    jg = [jd[k][n] for k in ("layer_1", "layer_2", "layer_3", "layer_4")
          for n in ("w", "b")]
    for ours, refg in zip(grads, jg):
        _close_rel(ours.numpy(), refg, 1e-4)


# ---------------------------------------------------------- the whole model

def _jax_model(extra=()):
    jcfg = jax_define_configuration(
        SMALL + ["--model.use_pallas=off", "--optimizer.optimizer=sgd",
                 "--optimizer.learning_rate=0.1"] + list(extra), CONFIG)
    (data, mask, dt), tgrid = _series(11)
    jmodel = jax_construct_time_series(jcfg, saveat=jnp.asarray(tgrid))
    jts = jax_create_train_state(jmodel, jax_construct_optimizer(jcfg)[0],
                                 jax.random.PRNGKey(0))
    return jcfg, jmodel, jts, (data, mask, dt), tgrid


def _port_model(use_pallas, tgrid, jts, extra=()):
    cfg = define_configuration(
        SMALL + [f"--model.use_pallas={use_pallas}",
                 "--optimizer.optimizer=sgd",
                 "--optimizer.learning_rate=0.1"] + list(extra), CONFIG)
    model = construct_time_series(cfg, saveat=torch.tensor(tgrid),
                                  device="cpu")
    load_jax_params(model, latent_tree(
        jax.tree_util.tree_map(np.asarray, jts.params)))
    return cfg, model


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_latent_eval_matches_jax(use_pallas):
    """The eval forward (the runner's masked MSE) and its NFE: the same
    steps, the MSE to rtol 1e-5. 'on' runs kernel 5's plain version through
    the chain family's dispatch, 'off' the module in the eager loop."""
    _, jmodel, jts, batch, tgrid = _jax_model()
    x = jnp.concatenate([jnp.asarray(a) for a in batch], axis=-1)
    jy, jst = jmodel(jts.params, jts.state, x, training=False)
    data, mask = batch[0], batch[1]
    jmse = float(np.sum(np.sum(np.square((np.asarray(jy) - data) * mask),
                               axis=(1, 2)) / np.sum(mask, axis=(1, 2))) / B)
    cfg, model = _port_model(use_pallas, tgrid, jts)
    ts = create_train_state(model, construct_optimizer(cfg)[0])
    mse, nfe = eval_forward(model, ts, tuple(torch.tensor(a) for a in batch))
    assert int(nfe) == int(jst["neural_ode"]["nfe"])
    np.testing.assert_allclose(float(mse), jmse, rtol=1e-5)


@pytest.mark.parametrize("use_pallas", ["off", "on"])
def test_latent_train_step_matches_jax(use_pallas, monkeypatch):
    """One make_train_step (SGD, so the update is lr·grad) from JAX's
    parameters with JAX's t1 and ε injected, and w_kl = 0.5 so the KL term
    counts: the same NFE, the loss to rtol 1e-5, reg_val to rtol 1e-3
    (measured 1.1e-5), and every parameter's update within 1e-3 of the
    largest. 'on' runs kernels 5 and 9's plain versions."""
    jcfg, jmodel, jts, batch, tgrid = _jax_model()
    # tripled generative weights: at the initial ones the regulariser's
    # error estimate is ~1e-6, at its f32 rounding (ROADMAP Queue 3), and
    # reg_val differs by 20% between any two implementations
    p = jax.tree_util.tree_map(np.asarray, jts.params)
    for layer in p["neural_ode"]["model"].values():
        if "w" in layer:
            layer["w"] = 3.0 * layer["w"]
    jts = dataclasses.replace(jts, params=jax.tree_util.tree_map(jnp.asarray,
                                                                 p))
    jloss, (jw_reg, _) = jax_construct_loss(jcfg)
    jopt, jsched = jax_construct_optimizer(jcfg)
    w = (float(jw_reg(1)), 0.5)
    _, tkey, _ = jax.random.split(jts.state["neural_ode"]["rng"], 3)
    t1 = float(jax.random.uniform(tkey, (), jnp.float32, minval=0.0,
                                  maxval=1.0))
    eps = np.asarray(jax.random.normal(
        jax.random.split(jts.state["reparam"]["rng"])[1], (B, NODE)))
    p0 = jax.tree_util.tree_map(np.asarray, jts.params)
    jts2, jl, jstats = jax_make_train_step(jmodel, jloss, jopt)(
        jts, tuple(jnp.asarray(a) for a in batch), w, jsched(1))

    monkeypatch.setattr(neural_ode, "sample_t1", lambda g, t0, t2: t1)
    monkeypatch.setattr(common, "reparam_noise",
                        lambda g, shape, like: torch.tensor(eps))
    cfg, model = _port_model(use_pallas, tgrid, jts)
    loss_fn, _ = construct_loss(cfg)
    opt, sched = construct_optimizer(cfg)
    ts = create_train_state(model, opt)
    ts2, loss, stats = make_train_step(model, loss_fn, opt)(
        ts, tuple(torch.tensor(a) for a in batch), w, sched(1))
    assert int(stats["nfe"]) == int(jstats["nfe"])
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(stats["reg_val"]),
                               float(jstats["reg_val"]), rtol=1e-3)
    ours = params_from_jax(latent_tree(jax.tree_util.tree_map(
        np.asarray, jts2.params)))
    old = params_from_jax(latent_tree(p0))
    assert set(ours) == set(ts2.params)
    lr = sched(1)
    for name, new in ours.items():
        _close_rel((ts2.params[name].detach().numpy() - old[name].numpy()) / lr,
                   (new.numpy() - old[name].numpy()) / lr, 1e-3)


# --------------------------------------------------------------- the runner

def _runner_cfg(tmp, total):
    return define_configuration(SMALL + [
        "--dataset.train_batchsize=8", "--dataset.eval_batchsize=205",
        f"--train.total_steps={total}", "--train.print_frequency=1",
        "--train.evaluate_every=1", f"--train.checkpoint_dir={tmp}/ckpt",
        f"--train.log_dir={tmp}/logs",
    ], CONFIG)


def _losses(summary):
    path = os.path.join(summary["log_dir"], "results_train.csv")
    rows = np.genfromtxt(path, delimiter=",", names=True)
    return dict(zip(np.atleast_1d(rows["step"]).astype(int),
                    np.atleast_1d(rows["net_loss"])))


class _Killed(Exception):
    pass


def test_runner_resumes_the_uninterrupted_run(tmp_path, monkeypatch):
    """Three steps in one run, against a run killed after its second step's
    checkpoint and resumed from model_current.ckpt: the resumed run sees
    the uninterrupted run's batches and gives its loss (rtol 1e-6: the
    same arithmetic on the CPU)."""
    seen, kill_at = [], [None]
    make = latent_runner.make_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def wrapped(ts, batch, w, lr):
            if len(seen) == kill_at[0]:
                raise _Killed
            seen.append(float(batch[0].sum()))
            return step(ts, batch, w, lr)

        return wrapped

    monkeypatch.setattr(latent_runner, "make_train_step", recording)
    full = run_latent_ode_experiment(_runner_cfg(tmp_path / "a", 3),
                                     device="cpu")
    batches_full, seen[:] = list(seen), []
    kill_at[0] = 2
    with pytest.raises(_Killed):
        run_latent_ode_experiment(_runner_cfg(tmp_path / "b", 3),
                                  device="cpu")
    kill_at[0] = None
    resumed = run_latent_ode_experiment(_runner_cfg(tmp_path / "b", 3),
                                        device="cpu")
    assert seen == batches_full and len(seen) == 3
    assert os.path.islink(os.path.join(resumed["ckpt_dir"],
                                       "model_current.ckpt"))
    assert list(_losses(resumed)) == [3]
    np.testing.assert_allclose(_losses(resumed)[3], _losses(full)[3],
                               rtol=1e-6)
    np.testing.assert_allclose(resumed["final_eval_mse"],
                               full["final_eval_mse"], rtol=1e-6)
    assert np.isfinite(full["best_eval_mse"]) and not full["real_data"]


def test_runner_refuses_unported_options(tmp_path):
    """The JAX runner's checks raise before anything runs: tensor
    parallelism with 'shardmap', and a tensor-parallel degree that does
    not divide the ranks of the global grid (one process here; tensor
    parallelism runs, ``tests/test_torch_parallel_tp.py``)."""
    for mode, match in (("shardmap", "shardmap mode"),
                        ("gspmd", "does not divide the 1 ranks")):
        cfg = define_configuration([f"--train.data_parallel={mode}",
                                    "--train.tensor_parallel=2"], CONFIG)
        with pytest.raises(ValueError, match=match):
            run_latent_ode_experiment(cfg, device="cpu")


def test_runner_runs_the_train_loop_options(tmp_path):
    """steps_per_call=2, grad_accumulation=2 and ema_decay=0.9 together:
    two K-step calls of two steps, each step on two microbatches of 4, the
    checkpoint with its EMA, and the evaluation of the EMA weights."""
    cfg = _runner_cfg(tmp_path, 4)
    cfg.train.steps_per_call, cfg.train.print_frequency = 2, 2
    cfg.train.evaluate_every = 2
    cfg.train.grad_accumulation, cfg.train.ema_decay = 2, 0.9
    out = run_latent_ode_experiment(cfg, device="cpu")
    assert out["steps_per_call"] == 2 and not out["captured"]
    assert list(_losses(out)) == [2, 4]
    ck = load_checkpoint(os.path.join(out["ckpt_dir"], "model_current.ckpt"))
    assert int(ck["step"]) == 4
    assert set(ck["tstate"]["ema"]) == set(ck["tstate"]["params"])
    assert np.isfinite(out["final_eval_mse"]) and out["final_eval_nfe"] > 0


def test_entry_points_default_to_the_gpu():
    """Without a device the entry points build on CUDA: where there is none
    (as here) they raise, and device='cpu' builds on the CPU."""
    cfg = define_configuration(SMALL, CONFIG)
    mlp = define_configuration([], os.path.join(ROOT, "experiments",
                                                "mnist_ode", "mlp.yaml"))
    calls = (lambda: construct_model(mlp),
             lambda: construct_time_series(cfg, saveat=torch.zeros(3)),
             lambda: run_latent_ode_experiment(cfg))
    if torch.cuda.is_available():
        model = construct_time_series(cfg, saveat=torch.zeros(3))
        assert next(model.parameters()).is_cuda
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    model = construct_time_series(cfg, saveat=torch.zeros(3), device="cpu")
    assert not next(model.parameters()).is_cuda
    with pytest.raises(ValueError, match="construct_time_series"):
        construct_model(cfg, device="cpu")
