"""The port's fused TD-MLP modules against the JAX package.

The plain PyTorch versions of the CUDA kernels are held against the JAX
Pallas kernels (interpret mode on the CPU) and their pure-JAX twins, on the
same numpy-seeded inputs, at the tolerances of ``tests/test_pallas.py``. On
a CPU tensor each wrapper must run its plain version and launch nothing.
``tests/test_torch_cuda.py`` holds the kernels themselves against these
plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.models import TDChain as JTDChain
from localregneuralde_tpu.nn import Dense as JDense
from localregneuralde_tpu.ops.pallas.fused_mlp import (
    _pure_tdmlp,
    fused_tdmlp as jax_fused_tdmlp,
    fused_tsit5_step as jax_fused_step,
)
from localregneuralde_tpu_torch.ops.cuda import (
    TDMLPWeights,
    fused_tdmlp,
    fused_tsit5_step,
    launch_counts,
    persistent_tsit5_solve,
    persistent_tsit5_solve_plain,
    tdmlp_plain,
    tsit5_step_plain,
)

F, H, B = 32, 16, 8


def _setup(seed=0):
    ps, _ = JTDChain(JDense(F + 1, H, "tanh"), JDense(H + 1, F)).init(
        jax.random.PRNGKey(seed)
    )
    rng = np.random.default_rng(seed + 1)
    # nonzero biases, so the bias terms are exercised too
    ps = jax.tree_util.tree_map(np.asarray, ps)
    ps["layer_0"]["b"] = rng.standard_normal(H).astype(np.float32) * 0.1
    ps["layer_1"]["b"] = rng.standard_normal(F).astype(np.float32) * 0.1
    x = rng.standard_normal((B, F)).astype(np.float32)
    w = TDMLPWeights(*(
        torch.tensor(ps[l][k]) for l, k in (
            ("layer_0", "w"), ("layer_0", "b"), ("layer_1", "w"), ("layer_1", "b")
        )
    ))
    return ps, w, x


@pytest.mark.parametrize("s", [0.0, 0.3, 1.0])
def test_tdmlp_plain_matches_jax(s):
    ps, w, x = _setup()
    ours = tdmlp_plain(w, torch.tensor(x), s).numpy()
    np.testing.assert_allclose(
        ours, np.asarray(jax_fused_tdmlp(ps, jnp.asarray(x), jnp.float32(s))),
        atol=1e-5,
    )
    np.testing.assert_allclose(
        ours, np.asarray(_pure_tdmlp(ps, jnp.asarray(x), jnp.float32(s))),
        atol=1e-5,
    )


@pytest.mark.parametrize("t,dt", [(0.2, 0.05), (0.0, 0.3)])
def test_tsit5_step_plain_matches_jax(t, dt):
    ps, w, x = _setup(seed=2)
    k1 = np.asarray(jax_fused_tdmlp(ps, jnp.asarray(x), jnp.float32(t)))
    ref = jax_fused_step(
        ps, jnp.asarray(x), jnp.float32(t), jnp.float32(dt), jnp.asarray(k1)
    )
    ours = tsit5_step_plain(
        w, torch.tensor(x), torch.tensor(t), torch.tensor(dt), torch.tensor(k1)
    )
    names = ("u_new", "utilde", "k2", "k3", "k4", "k5", "k6", "k7", "g6")
    for name, a, b in zip(names, ours, ref):
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b), atol=1e-6 if name == "utilde" else 1e-5,
            err_msg=name,
        )


def test_wrappers_run_plain_versions_on_cpu():
    _, w, x = _setup(seed=4)
    xt = torch.tensor(x)
    before = launch_counts()
    assert torch.equal(fused_tdmlp(w, xt, 0.4), tdmlp_plain(w, xt, 0.4))
    t, dt, k1 = torch.tensor(0.1), torch.tensor(0.05), tdmlp_plain(w, xt, 0.1)
    for a, b in zip(fused_tsit5_step(w, xt, t, dt, k1),
                    tsit5_step_plain(w, xt, t, dt, k1)):
        assert torch.equal(a, b)
    kw = dict(rtol=1e-4, atol=1e-4, saveat_arr=torch.tensor([1.0]),
              max_steps=64)
    a = persistent_tsit5_solve(w, xt, (0.0, 1.0), **kw)
    b = persistent_tsit5_solve_plain(w, xt, (0.0, 1.0), **kw)
    assert torch.equal(a["y_final"], b["y_final"])
    assert int(a["nfe"]) == int(b["nfe"])
    assert launch_counts() == before


def test_persistent_rejects_training_features():
    """The reservoir sample of the biased mode (kernel 4's plain version
    on the CPU): it is the start of an accepted step, never t_end, and it
    changes nothing else; too few uniforms are refused."""
    _, w, x = _setup()
    kw = dict(rtol=1e-4, atol=1e-4, saveat_arr=torch.tensor([1.0]),
              max_steps=16, record_knots=True)
    bare = persistent_tsit5_solve(w, torch.tensor(x), (0.0, 1.0), **kw)
    for seed in range(3):
        u = torch.rand(16, generator=torch.Generator().manual_seed(seed))
        out = persistent_tsit5_solve(w, torch.tensor(x), (0.0, 1.0), **kw,
                                     reservoir=u)
        n = int(out["naccept"])
        assert n == int(bare["naccept"]) and torch.equal(out["y_final"],
                                                         bare["y_final"])
        ts = out["knot_ts"][:n]
        j = int(torch.argmin((ts - out["reservoir_t"]).abs()))
        assert float(ts[j]) == float(out["reservoir_t"]) < 1.0
        assert torch.equal(out["knot_us"][j], out["reservoir_u"])
    with pytest.raises(ValueError, match="uniforms"):
        persistent_tsit5_solve(w, torch.tensor(x), (0.0, 1.0), **kw,
                               reservoir=torch.rand(4))
