"""The port's serving export (``localregneuralde_tpu_torch/utils/export.py``)
against the JAX package's (``tests/test_export.py``, case by case), at its
tiny widths: each loaded artifact of the port against JAX's
``load_exported(export_model(...))`` on the same numpy-seeded inputs, the
JAX parameters carried over by ``parity.py``, and ``torch.equal`` to the
live port model.

The port's models run the TD-MLP's kernel 4 (``use_pallas='on'``: its
plain version on the CPU, through the registered operator
``lrnde::tsit5_solve``), so the live model and its artifact run one code
path; JAX's run its XLA loop. Tolerances: the two solves take the same
steps (equal NFE) and part only by their float32 sums, so the logits agree
to 1e-5 (measured below 1e-6); the SDE's states part by ~1e-3 of their
scale where one-ulp step times move the Brownian path
(``tests/test_torch_sde_train.py``: 2e-3 of the largest logit); the flow
sampler as ``tests/test_torch_score.py``'s (one accept, 5e-5 of the
largest sample). JAX's Brownian tree is injected through the port's hooks
(``models.neural_sde.noise_source`` for the live model's eager loop,
``ops/cuda/serving.py``'s ``noise_source`` for the solve's operator), and
the flow sampler takes JAX's starting noise as its argument.
"""
import functools
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jax_export

from localregneuralde_tpu.models.neural_sde import NeuralDSDE as JNeuralDSDE
from localregneuralde_tpu.models.score_sde import (
    sample_probability_flow as jax_sample_probability_flow,
)
from localregneuralde_tpu.nn import Chain as JChain
from localregneuralde_tpu.nn import Dense as JDense
from localregneuralde_tpu.nn import Flatten as JFlatten
from localregneuralde_tpu.nn import WrappedFunction as JWrappedFunction
from localregneuralde_tpu.models import diffeqsol_to_array as j_to_array
from localregneuralde_tpu.utils.export import export_fn as jax_export_fn
from localregneuralde_tpu.utils.export import export_model as jax_export_model
from localregneuralde_tpu.utils.export import (
    export_model_multi as jax_export_model_multi,
)
from localregneuralde_tpu.utils.export import load_exported as jax_load
from localregneuralde_tpu.utils.export import save_exported as jax_save
from localregneuralde_tpu_torch.models import (
    NeuralDSDE,
    NeuralODE,
    TDChain,
    diffeqsol_to_array,
    neural_sde,
    sample_probability_flow,
)
from localregneuralde_tpu_torch.nn import Chain, Dense, Flatten, WrappedFunction
from localregneuralde_tpu_torch.ops.cuda import serving
from localregneuralde_tpu_torch.parity import load_jax_params, numpy_tree
from localregneuralde_tpu_torch.utils import (
    export_fn,
    export_model,
    export_model_multi,
    load_exported,
    save_exported,
)
from localregneuralde_tpu_torch.utils.export import export_state
import test_torch_export_families as export_families
from test_export import _tiny_model
from test_torch_sde import xla_tree_source

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
LOGIT_TOL = 1e-5
SDE_REL = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the products are small, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_tiny(params, use_pallas="on"):
    """The port's counterpart of ``test_export._tiny_model`` with JAX's
    parameters."""
    F, H = 12, 8
    model = Chain(
        flatten=Flatten(),
        neural_ode=NeuralODE(
            TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F)),
            regularize="unbiased", rtol=1e-3, atol=1e-3, max_steps=32,
            use_pallas=use_pallas),
        sol_to_arr=WrappedFunction(diffeqsol_to_array),
        classifier=Dense(F, 3),
    )
    load_jax_params(model, numpy_tree(params))
    return model, model.init_state()


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, params, state, the port's model and state)."""
    jm, jp, js = _tiny_model(jax.random.PRNGKey(0))
    return (jm, jp, js) + _port_tiny(jp)


def _x(key, shape=(4, 3, 4, 1)):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(key), shape))


def _live(model, state, x):
    with torch.no_grad():
        return model(torch.tensor(x), state, training=False)


def _close(ours, ref, tol):
    np.testing.assert_allclose(np.asarray(ours.detach()), np.asarray(ref),
                               rtol=0, atol=tol)


def test_export_roundtrip_matches_direct_forward(tiny, tmp_path):
    jm, jp, js, model, st = tiny
    x = _x(1)
    jax_save(jax_export_model(jm, jp, js, jnp.asarray(x)),
             str(tmp_path / "m.stablehlo"))
    y_jax = jax_load(str(tmp_path / "m.stablehlo"))(jnp.asarray(x))

    save_exported(export_model(model, None, st, torch.tensor(x)),
                  str(tmp_path / "m.lrnde"))
    y = load_exported(str(tmp_path / "m.lrnde"))(torch.tensor(x))
    assert torch.equal(y, _live(model, st, x)[0])
    _close(y, y_jax, LOGIT_TOL)


def test_export_open_weights_and_state(tiny, tmp_path):
    """freeze=False exports fn(params, x); with_state returns solver
    telemetry (NFE counters) alongside predictions; the model's own
    weights are not baked."""
    jm, jp, js, model, st = tiny
    x = _x(2)
    jax_save(jax_export_model(jm, jp, js, jnp.asarray(x), freeze=False,
                              with_state=True), str(tmp_path / "o.stablehlo"))
    y_jax, st_jax = jax_load(str(tmp_path / "o.stablehlo"))(jp, jnp.asarray(x))

    save_exported(export_model(model, None, st, torch.tensor(x), freeze=False,
                               with_state=True), str(tmp_path / "o.lrnde"))
    fn = load_exported(str(tmp_path / "o.lrnde"))
    params = {k: v.detach() for k, v in model.named_parameters()}
    y, st_out = fn(params, torch.tensor(x))
    y_live, st_live = _live(model, st, x)
    assert torch.equal(y, y_live)
    _close(y, y_jax, LOGIT_TOL)
    nfe = int(st_out["neural_ode"]["nfe"])
    assert nfe == int(st_live["neural_ode"]["nfe"]) == int(
        st_jax["neural_ode"]["nfe"])

    # hot-swapped weights actually change the output
    y2, _ = fn({k: v * 1.5 for k, v in params.items()}, torch.tensor(x))
    assert not torch.allclose(y2, y)


def test_export_multi_batch_ladder_dispatch(tiny, tmp_path):
    jm, jp, js, model, st = tiny
    x8 = _x(3, (8, 3, 4, 1))
    jax_save(jax_export_model_multi(jm, jp, js, jnp.asarray(x8), (4, 8)),
             str(tmp_path / "l.stablehlo"))
    jfn = jax_load(str(tmp_path / "l.stablehlo"))

    save_exported(export_model_multi(model, None, st, torch.tensor(x8),
                                     (4, 8)), str(tmp_path / "l.lrnde"))
    fn = load_exported(str(tmp_path / "l.lrnde"))
    # exact-size dispatch
    y8 = fn(torch.tensor(x8))
    assert torch.equal(y8, _live(model, st, x8)[0])
    _close(y8, jfn(jnp.asarray(x8)), LOGIT_TOL)
    # exact smaller size
    assert fn(torch.tensor(x8[:4])).shape == (4, 3)
    # padded dispatch: 3 rows ride the B=4 program, tail stripped
    y3 = fn(torch.tensor(x8[:3]))
    assert y3.shape == (3, 3)
    _close(y3, jfn(jnp.asarray(x8[:3])), LOGIT_TOL)
    padded = np.concatenate([x8[:3], np.zeros_like(x8[:1])])
    assert torch.equal(y3, _live(model, st, padded)[0][:3])
    # over-capacity is an explicit error
    with pytest.raises(ValueError, match="exceeds largest"):
        fn(torch.zeros((16, 3, 4, 1)))


def _sde_models():
    jm = JChain(
        flatten=JFlatten(),
        neural_dsde=JNeuralDSDE(
            JChain(JDense(6, 8, "tanh"), JDense(8, 6)), JDense(6, 6),
            regularize="none", rtol=1e-1, atol=1e-1, max_steps=64,
        ),
        sol_to_arr=JWrappedFunction(j_to_array),
        classifier=JDense(6, 3),
    )
    jp, js = jm.init(jax.random.PRNGKey(0))
    model = Chain(
        flatten=Flatten(),
        neural_dsde=NeuralDSDE(
            Chain(Dense(6, 8, "tanh"), Dense(8, 6)), Dense(6, 6),
            regularize="none", rtol=1e-1, atol=1e-1, max_steps=64),
        sol_to_arr=WrappedFunction(diffeqsol_to_array),
        classifier=Dense(6, 3),
    )
    load_jax_params(model, numpy_tree(jp))
    return jm, jp, js, model


def test_export_sde_frozen_vs_threaded_state(tmp_path, monkeypatch):
    """A fully frozen NeuralDSDE export bakes one call's draws and replays
    one Brownian path (the live model's next call); freeze_state=False
    threads the state as tensors, its first call the live model's and each
    next call a new path. With JAX's tree injected, both artifacts'
    first calls hold against JAX's."""
    jm, jp, js, model = _sde_models()
    x = _x(4, (4, 2, 3, 1))
    frozen_jax = jax.jit(jax_export_model(jm, jp, js, jnp.asarray(x)).call)
    jax_save(jax_export_model(jm, jp, js, jnp.asarray(x), freeze_state=False),
             str(tmp_path / "sde.stablehlo"))
    y1_jax, _ = jax_load(str(tmp_path / "sde.stablehlo"))(js, jnp.asarray(x))
    _, noise_key = jax.random.split(js["neural_dsde"]["rng"], 5)[:2]
    ref_scale = float(np.abs(np.asarray(y1_jax)).max())

    # JAX's tree, from its state's key (each node's normals drawn once)
    normals = functools.lru_cache(maxsize=None)(
        xla_tree_source(noise_key, (4, 6)))
    with monkeypatch.context() as m:
        m.setattr(neural_sde, "noise_source", lambda seed, u: normals)
        m.setattr(serving, "noise_source", lambda seed, u: normals)
        st = model.init_state()
        y_live = _live(model, st, x)[0]
        frozen = export_model(model, None, st, torch.tensor(x)).module()
        y_frozen = frozen(torch.tensor(x))
        assert torch.equal(y_frozen, y_live)
        _close(y_frozen, frozen_jax(jnp.asarray(x)), SDE_REL * ref_scale)
        save_exported(export_model(model, None, st, torch.tensor(x),
                                   freeze_state=False),
                      str(tmp_path / "sde.lrnde"))
        fn = load_exported(str(tmp_path / "sde.lrnde"))
        y1, _ = fn(export_state(model, st, torch.tensor(x)), torch.tensor(x))
        _close(y1, y1_jax, SDE_REL * ref_scale)
        assert torch.equal(y1, y_live)

    # the port's own Philox tree: the frozen path repeats, the threaded
    # state draws a new one each call, its first the live model's
    st = model.init_state()
    frozen = export_model(model, None, st, torch.tensor(x)).module()
    a = frozen(torch.tensor(x))
    assert torch.equal(a, frozen(torch.tensor(x)))
    save_exported(export_model(model, None, st, torch.tensor(x),
                               freeze_state=False), str(tmp_path / "p.lrnde"))
    fn = load_exported(str(tmp_path / "p.lrnde"))
    y1, st1 = fn(export_state(model, st, torch.tensor(x)), torch.tensor(x))
    y2, st2 = fn(st1, torch.tensor(x))
    assert not torch.allclose(y1, y2)
    assert torch.equal(y1, a) and torch.equal(y1, _live(model, st, x)[0])
    assert int(st2["neural_dsde"]["nfe_drift"]) > 0


def test_export_fn_score_sde_sampler(tmp_path):
    """export_fn serves arbitrary callables — here the probability-flow
    sampler closed over a TDChain score network (kernel 6, through
    ``lrnde::pf_solve``), its starting noise the argument as JAX's key
    is."""
    B, F, H = 64, 2, 16
    rng = np.random.default_rng(10)
    jparams = numpy_tree(
        {"layer_0": {"w": rng.standard_normal((F + 1, H)) * 0.5,
                     "b": rng.standard_normal(H) * 0.5},
         "layer_1": {"w": rng.standard_normal((H + 1, F)) * 0.5,
                     "b": rng.standard_normal(F) * 0.5}})
    from localregneuralde_tpu.models import TDChain as JTDChain

    jmod = JTDChain(JDense(F + 1, H, "tanh"), JDense(H + 1, F))
    mod = TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F))
    load_jax_params(mod, jparams)
    kw = dict(rtol=1e-3, atol=1e-3, max_steps=128)
    p = jax.tree_util.tree_map(jnp.asarray, jparams)

    def jax_draw(key):
        s, sol = jax_sample_probability_flow(
            None, (B, F), key, p, score_module=jmod, use_pallas=False, **kw)
        return s, sol.success

    key = jax.random.PRNGKey(7)
    restored = jax_export.deserialize(jax_export_fn(jax_draw, key).serialize())
    s_jax, ok_jax = restored.call(key)
    assert bool(ok_jax)

    def draw(u):
        s, sol = sample_probability_flow(None, (B, F), None, score_module=mod,
                                         device="cpu", u_init=u, **kw)
        return s, sol.success

    # JAX's starting noise
    u = torch.tensor(np.asarray(jax.random.normal(key, (B, F))))
    save_exported(export_fn(draw, u), str(tmp_path / "pf.lrnde"))
    fn = load_exported(str(tmp_path / "pf.lrnde"))
    s, ok = fn(u)
    assert bool(ok) and torch.equal(s, draw(u)[0])
    scale = float(np.abs(np.asarray(s_jax)).max())
    _close(s, s_jax, 5e-5 * scale)
    # another draw, another input
    assert not torch.allclose(fn(u.flip(0))[0], s)


@pytest.mark.parametrize("family", ["tdmlp", "latent", "cifar"])
def test_export_artifact_loads_in_a_fresh_process(family, tiny, tmp_path):
    """The counterpart of JAX's multi-platform artifact: the artifact is
    portable in the sense the port has (no ``platforms``: it runs on the
    device it was traced on) — a process with JAX blocked loads it through
    ``load_exported`` and runs it, equal to the live model and close to
    JAX's portable artifact, having imported no model code (``models/``,
    ``harness/``). The TD-MLP classifier here (kernel 4's operator), the
    latent ODE (kernel 5's) and the CIFAR conv classifier (the conv
    family's solve operator) of ``tests/test_torch_export_families.py``,
    each held to JAX's as there (1e-5 of the largest output)."""
    if family == "tdmlp":
        jm, jp, js, model, st = tiny
        x = _x(5)
    else:
        f = (export_families._latent() if family == "latent"
             else export_families._cifar())
        jm, jp, js, model, st, x = (f[k] for k in ("jm", "jp", "js", "model",
                                                   "st", "x"))
    jax_save(jax_export_model(jm, jp, js, jnp.asarray(x),
                              platforms=("cpu", "tpu")),
             str(tmp_path / "portable.stablehlo"))
    y_jax = jax_load(str(tmp_path / "portable.stablehlo"))(jnp.asarray(x))
    save_exported(export_model(model, None, st, torch.tensor(x)),
                  str(tmp_path / "portable.lrnde"))
    torch.save(torch.tensor(x), tmp_path / "x.pt")
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import torch\n"
        "from localregneuralde_tpu_torch.utils import load_exported\n"
        "fn = load_exported(sys.argv[1])\n"
        "with torch.no_grad():\n"
        "    torch.save(fn(torch.load(sys.argv[2])), sys.argv[3])\n"
        "zoo = [m for m in sys.modules if m.startswith(("
        "'localregneuralde_tpu_torch.models', "
        "'localregneuralde_tpu_torch.harness'))]\n"
        "assert not zoo, zoo\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "portable.lrnde"),
         str(tmp_path / "x.pt"), str(tmp_path / "y.pt")], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    y = torch.load(tmp_path / "y.pt")
    assert torch.equal(y, _live(model, st, x)[0])
    if family == "tdmlp":
        _close(y, y_jax, LOGIT_TOL)
    else:
        export_families._close_rel(y, y_jax, export_families.REL)


def test_export_artifact_rejects_garbage(tmp_path):
    p = tmp_path / "bad.bin"
    p.write_bytes(b"not an export")
    with pytest.raises(ValueError, match="not an LRNDE export"):
        load_exported(str(p))
    # the container, with a blob that is not a program
    p.write_bytes(b"LRNDE-EXPORT-V1\n" + struct.pack("<I", 1)
                  + struct.pack("<II", 6, 3) + b"singlexyz")
    with pytest.raises(Exception):
        load_exported(str(p))


def test_export_routes_through_the_solve_operator(tiny):
    """A ``use_pallas='auto'`` model on the CPU runs the eager loop live,
    but its export records kernel 4's operator (the eager loop cannot be
    traced): the program equals the kernel route's live model bitwise.
    What cannot be exported says so."""
    jm, jp, js, model, st = tiny
    auto, st_auto = _port_tiny(jp, use_pallas="auto")
    x = torch.tensor(_x(6))
    ep = export_model(auto, None, st_auto, x)
    ops = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert "lrnde.tsit5_solve.default" in ops
    assert torch.equal(ep.module()(x), _live(model, st, x.numpy())[0])
    generic = Chain(flatten=Flatten(), neural_ode=NeuralODE(Dense(12, 12)),
                    sol_to_arr=WrappedFunction(diffeqsol_to_array))
    with pytest.raises(NotImplementedError, match="kernel 4"):
        export_model(generic, None, generic.init_state(), x)


def test_solve_operators_pass_opcheck():
    """The five registered operators: schema, fake implementation (shapes
    and dtypes from the inputs alone) and dispatch, by
    ``torch.library.opcheck`` on small CPU inputs (the chain's and the
    conv family's recorded in their families' programs:
    ``tests/test_torch_export_families.py``)."""
    from localregneuralde_tpu_torch.ops.cuda import serving

    g = torch.Generator().manual_seed(0)
    r = lambda *s: 0.3 * torch.randn(*s, generator=g)  # noqa: E731
    F, H, B = 6, 8, 4
    saveat = torch.tensor([0.5, 1.0])
    torch.library.opcheck(serving._tsit5_op, (
        r(F + 1, H), r(H), r(H + 1, F), r(F), r(B, F), saveat, 0.0, 1.0,
        1e-3, 1e-3, 32, "fp32"))
    torch.library.opcheck(serving._sde_op, (
        r(F, H), r(H), r(H, F), r(F), r(F, F), r(F), r(B, F),
        torch.tensor([5], dtype=torch.int32), saveat, 0.0, 1.0, 0.1, 0.1,
        1e-3, "sosri", 32, 24, "fp32"))
    torch.library.opcheck(serving._pf_op, (
        [r(F + 1, H), r(H), r(H + 1, F), r(F)], r(B, F), saveat, [F, H, F],
        [True, False], 0.0, 0.999, 1e-3, 1e-3, 64, 0.1, 20.0, 1.0, "fp32"))
    torch.library.opcheck(serving._chain_op, (
        [r(F, H), r(H), r(H, F), r(F)], [F, H, F], [True, False], True,
        r(B, F), saveat, 0.0, 1.0, 1e-3, 1e-3, 32, "fp32"))
    Cs, Ch = 2, 3
    weights = [r(3, 3, Cs + 1, Ch), 1 + r(Ch), r(Ch), r(3, 3, Ch + 1, Ch),
               1 + r(Ch), r(Ch), r(3, 3, Ch + 1, Cs)]
    for eval_stats in ("running", "batch"):
        torch.library.opcheck(serving._conv_op, (
            weights, [r(Ch), 1 + r(Ch).abs(), r(Ch), 1 + r(Ch).abs()],
            r(B, 4, 4, Cs), saveat, Cs, Ch, 0.1, 1e-5, eval_stats, 0.0, 1.0,
            1e-3, 1e-3, 32, "fp32"))
