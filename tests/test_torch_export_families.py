"""The serving export of the latent-ODE and CIFAR-10 conv families
(``localregneuralde_tpu_torch/utils/export.py``) against the JAX package's
(``localregneuralde_tpu/utils/export.py``), at small widths.

The latent model is ``tests/test_torch_latent.py``'s (``SMALL``: in 5,
hidden 8, latent 6, node 4, T = 7, B = 8), the CIFAR model
``tests/test_torch_cifar.py``'s whole ``cnn.yaml`` model at 8×8 images
(B = 4), with JAX's parameters carried over by ``parity.py`` and, for
CIFAR, JAX's BatchNorm running stats set away from their initial values.
The port's models take the kernel route (``use_pallas='on'``): on the CPU
kernel 5's plain version through ``lrnde::chain_solve`` and the conv
family's loop with kernel 13's plain version through ``lrnde::conv_solve``,
so the live model and its artifact run one code path; JAX's run their XLA
loops (``use_pallas=off``, whose BatchNorm honours ``eval_stats='batch'``).

Tolerances: each loaded artifact against JAX's loaded artifact on the same
numpy-seeded input takes the same steps (equal NFE) and parts by float32
sums only, to 1e-5 of the largest output (``test_latent_eval_matches_jax``
and ``test_conv_neural_ode_matches_jax``); against the live port model it
is bitwise (``torch.equal``), NFE included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.harness import (
    construct_model as jax_construct_model,
    define_configuration as jax_define_configuration,
)
from localregneuralde_tpu.harness.construct import (
    construct_optimizer as jax_construct_optimizer,
)
from localregneuralde_tpu.harness.train import (
    create_train_state as jax_create_train_state,
)
from localregneuralde_tpu.utils.export import export_model as jax_export_model
from localregneuralde_tpu.utils.export import load_exported as jax_load
from localregneuralde_tpu.utils.export import save_exported as jax_save
from localregneuralde_tpu_torch.harness import (
    construct_model,
    define_configuration,
)
from localregneuralde_tpu_torch.parity import (
    cifar_tree,
    load_jax_params,
    state_from_jax,
)
from localregneuralde_tpu_torch.utils import (
    export_model,
    export_model_multi,
    load_exported,
    save_exported,
)
from localregneuralde_tpu_torch.utils.export import export_state
from test_torch_cifar import CONFIG as CIFAR_CONFIG
from test_torch_cifar import SMALL as CIFAR_SMALL
from test_torch_latent import _jax_model, _port_model

REL = 1e-5
OPS = {"latent": "lrnde.chain_solve.default",
       "cifar": "lrnde.conv_solve.default",
       "cifar batch": "lrnde.conv_solve.default"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the products are small, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _latent():
    _, jmodel, jts, batch, tgrid = _jax_model()
    _, model = _port_model("on", tgrid, jts)
    return dict(jm=jmodel, jp=jts.params, js=jts.state, model=model,
                st=model.init_state(),
                x=np.concatenate(batch, axis=-1).astype(np.float32))


def _cifar(eval_stats="running"):
    """The whole CIFAR model at 8×8 with JAX's parameters and running
    stats (those of the dynamics' and the outer BatchNorm drawn away from
    zero means and unit variances)."""
    extra = [f"--model.bn_eval_stats={eval_stats}"]
    small = lambda define, pallas: define(  # noqa: E731
        CIFAR_SMALL + extra + [f"--model.use_pallas={pallas}"], CIFAR_CONFIG)
    jcfg = small(jax_define_configuration, "off")
    jcfg.model.image_size = [8, 8]
    jmodel = jax_construct_model(jcfg)
    jts = jax_create_train_state(jmodel, jax_construct_optimizer(jcfg)[0],
                                 jax.random.PRNGKey(0))
    rng = np.random.default_rng(21)

    def away(path, v):
        key = getattr(path[-1], "key", None)
        if key == "mean":
            return jnp.asarray(0.1 * rng.standard_normal(v.shape), v.dtype)
        if key == "var":
            return jnp.asarray(1.0 + 0.5 * rng.random(v.shape), v.dtype)
        return v

    js = jax.tree_util.tree_map_with_path(away, jts.state)
    cfg = small(define_configuration, "on")
    cfg.model.image_size = [8, 8]
    model = construct_model(cfg, device="cpu")
    load_jax_params(model, cifar_tree(
        jax.tree_util.tree_map(np.asarray, jts.params)))
    x = np.random.default_rng(7).uniform(size=(4, 8, 8, 3)).astype(np.float32)
    return dict(jm=jmodel, jp=jts.params, js=js, model=model,
                st=state_from_jax(model.init_state(), js), x=x)


@pytest.fixture(scope="module", params=["latent", "cifar", "cifar batch"])
def family(request):
    name = request.param
    built = _latent() if name == "latent" else _cifar(
        "batch" if name == "cifar batch" else "running")
    return dict(built, name=name)


def _live(model, state, x):
    with torch.no_grad():
        return model(torch.as_tensor(x), state, training=False)


def _node(state):
    return state["neural_ode"]


def _close_rel(ours, ref, rel):
    ours, ref = np.asarray(ours.detach()), np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(ours - ref).max())
    assert err <= rel * scale, f"max-abs {err:.3e} > {rel:.0e} x {scale:.3e}"


def test_export_matches_jax_and_the_live_model(family, tmp_path):
    """The frozen artifact with its state (NFE, success) after
    ``save_exported`` and ``load_exported``: the family's operator in the
    program, bitwise the live model, and JAX's loaded artifact's NFE and
    output to 1e-5."""
    f = family
    x = f["x"]
    jax_save(jax_export_model(f["jm"], f["jp"], f["js"], jnp.asarray(x),
                              with_state=True), str(tmp_path / "m.stablehlo"))
    y_jax, st_jax = jax_load(str(tmp_path / "m.stablehlo"))(jnp.asarray(x))

    ep = export_model(f["model"], None, f["st"], torch.tensor(x),
                      with_state=True)
    ops = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert OPS[f["name"]] in ops
    save_exported(ep, str(tmp_path / "m.lrnde"))
    y, st = load_exported(str(tmp_path / "m.lrnde"))(torch.tensor(x))
    y_live, st_live = _live(f["model"], f["st"], x)
    assert torch.equal(y, y_live)
    nfe = int(_node(st)["nfe"])
    assert nfe == int(_node(st_live)["nfe"]) == int(_node(st_jax)["nfe"])
    assert bool(_node(st)["success"])
    _close_rel(y, y_jax, REL)


def test_export_open_weights_and_threaded_state(family, tmp_path):
    """``freeze=False`` exports ``fn(params, x)``, bitwise the live model
    with the same weights, and hot-swapped weights change the output;
    ``freeze_state=False`` exports ``fn(state, x) -> (y, state')`` on the
    state's tensors (no draws in these eval forwards), bitwise the live
    model, its running stats returned as they came in."""
    f = family
    x = torch.tensor(f["x"])
    save_exported(export_model(f["model"], None, f["st"], x, freeze=False,
                               with_state=True), str(tmp_path / "o.lrnde"))
    fn = load_exported(str(tmp_path / "o.lrnde"))
    params = {k: v.detach() for k, v in f["model"].named_parameters()}
    y, st = fn(params, x)
    y_live, st_live = _live(f["model"], f["st"], x)
    assert torch.equal(y, y_live)
    assert int(_node(st)["nfe"]) == int(_node(st_live)["nfe"])
    y2, _ = fn({k: v * 1.1 for k, v in params.items()}, x)
    assert not torch.allclose(y2, y)

    save_exported(export_model(f["model"], None, f["st"], x,
                               freeze_state=False), str(tmp_path / "t.lrnde"))
    fn = load_exported(str(tmp_path / "t.lrnde"))
    st_in = export_state(f["model"], f["st"], x)
    y, st = fn(st_in, x)
    assert torch.equal(y, y_live)
    dyn = _node(st)["model"]
    for a, b in zip(torch.utils._pytree.tree_leaves(dyn),
                    torch.utils._pytree.tree_leaves(_node(st_in)["model"])):
        assert torch.equal(a, b)


def test_export_multi_batch_ladder(family, tmp_path):
    """A two-size ladder in one artifact: an exact size is the live model
    on the batch, a smaller batch rides the next program zero-padded (the
    live model on the padded batch, the tail stripped), and a batch past
    the largest size is refused."""
    f = family
    x = torch.tensor(f["x"])
    B = x.shape[0]
    save_exported(export_model_multi(f["model"], None, f["st"], x,
                                     (B // 2, B)), str(tmp_path / "l.lrnde"))
    fn = load_exported(str(tmp_path / "l.lrnde"))
    assert torch.equal(fn(x), _live(f["model"], f["st"], x)[0])
    half = x[:B // 2]
    assert torch.equal(fn(half), _live(f["model"], f["st"], half)[0])
    short = x[:B // 2 - 1]
    padded = torch.cat([short, short.new_zeros((1,) + tuple(x.shape[1:]))])
    y = fn(short)
    assert y.shape[0] == B // 2 - 1
    assert torch.equal(y, _live(f["model"], f["st"], padded)[0][:-1])
    with pytest.raises(ValueError, match="exceeds largest"):
        fn(torch.cat([x, x]))
