"""The port's score-SDE samplers against the JAX package on the CPU: the
score chain, ``VPSDE`` and the analytic score, the plain versions of
kernels 11 (reverse VP-SDE solve) and 6 (probability-flow solve) against
JAX's Pallas kernels in interpret mode, the whole samplers against JAX's
eager loops, the analytic N(0, I) cases, and kernel 15's plain version
against the conv-orientation probe's two Pallas kernels.

Inputs come from numpy seeds; JAX's parameters carry over through
``parity.load_jax_params``. JAX draws u_init and the Brownian tree with
threefry (or its kernel's interpret-mode draw), so those draws are
injected through ``models.score_sde.sample_u_init`` and ``noise_source``
(``tests/test_torch_sde.py``'s sources). Sizes: B = 64, F = 8, H = 16
(``tests/test_vpsde_kernel.py``).

Tolerances: the score chain and the schedule 1e-6 (f32 sums in another
order); SDE states 1e-3 of their largest value with the same accepts and
rejects (the Brownian path is Hölder-1/2 in the step times,
``tests/test_torch_sde.py``, and the reverse drift ½β·u amplifies the
shifts: the states grow to ~22, measured 1.4e-4 to 4.1e-4); the
probability flow within one accept, the same NFE and 5e-5 of max|y|
(``tests/test_vpsde_kernel.py:193-198``); the conv 1e-5 of its largest
value.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from localregneuralde_tpu.core.containers import ArrayAndTime as JArrayAndTime
from localregneuralde_tpu.core.containers import get_array as jax_get_array
from localregneuralde_tpu.models.common import TDChain as JTDChain
from localregneuralde_tpu.models.score_sde import (
    VPSDE as JVPSDE,
    gaussian_score_fn as jax_gaussian_score_fn,
    sample_probability_flow as jax_sample_probability_flow,
    sample_vpsde as jax_sample_vpsde,
)
from localregneuralde_tpu.nn import Chain as JChain
from localregneuralde_tpu.nn import Dense as JDense
from localregneuralde_tpu.ops.pallas.fused_sde_solve import (
    match_td_score_chain as jax_match_td_score_chain,
    persistent_vpsde_solve as jax_persistent_vpsde_solve,
    td_score_eval_pure,
)
from localregneuralde_tpu.ops.pallas.fused_solve import (
    persistent_pf_solve as jax_persistent_pf_solve,
)
from localregneuralde_tpu_torch.core import ArrayAndTime
from localregneuralde_tpu_torch.models import (
    VPSDE,
    TDChain,
    gaussian_score_fn,
    sample_probability_flow,
    sample_vpsde,
)
from localregneuralde_tpu_torch.models import score_sde
from localregneuralde_tpu_torch.nn import Chain, Dense
from localregneuralde_tpu_torch.ops.cuda import (
    conv_orient_im2col,
    conv_orient_plain,
    conv_orient_tap,
    launch_counts,
    match_td_score_chain,
    persistent_pf_solve,
    persistent_pf_solve_plain,
    persistent_vpsde_solve,
    persistent_vpsde_solve_plain,
    score_chain_params,
    td_score_eval_plain,
)
from localregneuralde_tpu_torch.parity import load_jax_params
from localregneuralde_tpu_torch.sde import PhiloxNormals
from test_torch_sde import pallas_interpret_source, xla_tree_source

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, F, H = 64, 8, 16
SDE_TOL = 5e-2
STATE_REL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the products are small, and the suite's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(seed=0, scale=0.5):
    rng = np.random.default_rng(seed)
    n = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {"layer_0": {"w": n(F + 1, H), "b": n(H)},
            "layer_1": {"w": n(H + 1, F), "b": n(F)}}


def _modules(params):
    """The JAX module and the port's, with JAX's parameters."""
    jmod = JTDChain(JDense(F + 1, H, "tanh"), JDense(H + 1, F))
    mod = TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F))
    load_jax_params(mod, params)
    return jmod, mod


def _neg_identity():
    """s(x, t) = −x, the exact score of N(0, I) data: (JAX module, its
    parameters, the port's module)."""
    w = np.zeros((F + 1, F), np.float32)
    w[:F] = -np.eye(F)
    params = {"layer_0": {"w": w, "b": np.zeros(F, np.float32)}}
    mod = TDChain(Dense(F + 1, F))
    load_jax_params(mod, params)
    return JTDChain(JDense(F + 1, F)), params, mod


def _x(seed=1, rows=B):
    return np.random.default_rng(seed).standard_normal((rows, F)).astype(
        np.float32)


def _close(ours, ref, atol, msg=""):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), atol=atol,
                               rtol=0, err_msg=msg)


def _close_state(ours, ref):
    """SDE states: within STATE_REL of the reference's largest value."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    scale = float(np.abs(ref).max())
    err = float(np.abs(ours - ref).max())
    assert err <= STATE_REL * scale


@pytest.fixture
def inject(monkeypatch):
    """Replace the samplers' draws: ``inject(u_init, source)``."""
    def set_draws(u_init, source):
        monkeypatch.setattr(score_sde, "sample_u_init",
                            lambda g, shape, device: torch.tensor(u_init))
        monkeypatch.setattr(score_sde, "noise_source", lambda g, u: source)
    return set_draws


# ------------------------------------------------------------------ chain

def test_match_td_score_chain_matches_jax():
    """The cases of tests/test_vpsde_kernel.py:39-54: one accepted, five
    declined, the same way in both packages."""
    pairs = [
        (JTDChain(JDense(F + 1, H, "tanh"), JDense(H + 1, F)),
         TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F))),
        (JTDChain(JDense(F + 1, H, "relu"), JDense(H + 1, F)),
         TDChain(Dense(F + 1, H, "relu"), Dense(H + 1, F))),
        (JTDChain(JDense(F + 1, H, "tanh"), JDense(H + 1, F + 2)),
         TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F + 2))),
        (JTDChain(JDense(F + 1, H, "tanh"), JDense(H + 1, F, use_bias=False)),
         TDChain(Dense(F + 1, H, "tanh"), Dense(H + 1, F, use_bias=False))),
        (JChain(JDense(F, F)), Chain(Dense(F, F))),
        (JTDChain(JChain(JDense(F + 1, F))), TDChain(Chain(Dense(F + 1, F)))),
    ]
    got = [(match_td_score_chain(m), jax_match_td_score_chain(j))
           for j, m in pairs]
    assert got[0][0] == ((F, H, F), (True, False), ("layer_0", "layer_1"))
    assert all(ours == ref for ours, ref in got)
    assert all(ours is None for ours, _ in got[1:])


@pytest.mark.parametrize("t", [0.0, 0.37, 1.0])
def test_score_chain_matches_jax(t):
    params = _jax_params()
    jmod, mod = _modules(params)
    chain = match_td_score_chain(mod)
    x = _x()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    ref = td_score_eval_pure(jp, chain.keys, chain.acts, jnp.asarray(x), t)
    ours = td_score_eval_plain(score_chain_params(mod, chain), chain,
                               torch.tensor(x), t)
    _close(ours.detach(), ref, 1e-6)
    ref_mod = jax_get_array(jmod(jp, {"layer_0": {}, "layer_1": {}},
                                 JArrayAndTime(jnp.asarray(x), t))[0])
    ours_mod = mod(ArrayAndTime(torch.tensor(x), t), mod.init_state())[0]
    _close(ours_mod.array.detach(), ref_mod, 1e-6)


def test_vpsde_and_gaussian_score_match_jax():
    ours, ref = VPSDE(0.2, 15.0), JVPSDE(0.2, 15.0)
    ts = np.asarray([1e-3, 0.25, 0.5, 1.0], np.float32)
    tt, tj = torch.tensor(ts), jnp.asarray(ts)
    _close(ours.beta(tt), ref.beta(tj), 1e-6)
    _close(ours.marginal_log_alpha(tt), ref.marginal_log_alpha(tj), 1e-6)
    _close(ours.marginal_std(tt), ref.marginal_std(tj), 1e-6)
    x = _x(3)
    for t in (1e-3, 0.3, 1.0):
        s = gaussian_score_fn(2.0, 0.25, ours)(torch.tensor(x), t, None)
        r = jax_gaussian_score_fn(2.0, 0.25, ref)(jnp.asarray(x), t, None)
        _close(s, r, 1e-6 * float(np.abs(np.asarray(r)).max()))


# ------------------------------------------------------------------ kernel 11

def test_kernel11_plain_matches_jax_pallas():
    """The plain version of kernel 11 against the JAX kernel in interpret
    mode, with the kernel's interpret-mode noise injected."""
    params = _jax_params(2, scale=0.3)
    _, mod = _modules(params)
    chain = match_td_score_chain(mod)
    x = _x(4)
    nk = jax.random.PRNGKey(5)
    saveat = np.asarray([0.4, 0.999], np.float32)
    kw = dict(rtol=SDE_TOL, atol=SDE_TOL, solver="sosri", delta=1 / 6,
              max_steps=64)
    # a milder schedule than the default keeps the step count (and JAX's
    # interpret-mode tree) small: 39 accepts
    sched = dict(beta_min=0.1, beta_max=5.0, t1=1.0)
    ref = jax_persistent_vpsde_solve(
        jax.tree_util.tree_map(jnp.asarray, params),
        (chain.dims, chain.acts, chain.keys), jnp.asarray(x), (0.0, 0.999),
        noise_key=nk, saveat_arr=jnp.asarray(saveat), **kw, **sched)
    ours = persistent_vpsde_solve_plain(
        [p.detach() for p in score_chain_params(mod, chain)], chain,
        torch.tensor(x), (0.0, 0.999),
        noise=pallas_interpret_source(nk, rows=B, cols=F),
        saveat_arr=torch.tensor(saveat), **kw, **sched)
    n = int(ref["naccept"])
    assert n >= 3 and int(ours["naccept"]) == n
    assert int(ours["nreject"]) == int(ref["nreject"])
    assert 1 + 4 * int(ours["natt"]) == int(ref["nfe_drift"])
    assert bool(ours["success"]) and bool(ref["success"])
    _close_state(ours["ys"], ref["ys"])
    _close_state(ours["y_final"], ref["y_final"])


@pytest.mark.parametrize("solver", ["sri", "sosri"])
def test_sample_vpsde_matches_jax(inject, solver):
    """The whole sampler on the eager loop (``use_pallas=False``) against
    JAX's, with JAX's u_init and tree injected."""
    params = _jax_params(6, scale=0.3)
    jmod, mod = _modules(params)
    key = jax.random.PRNGKey(7)
    key_init, key_noise = jax.random.split(key)
    kw = dict(rtol=SDE_TOL, atol=SDE_TOL, solver=solver, max_steps=96,
              use_pallas=False)
    s_ref, ref = jax_sample_vpsde(
        None, (B, F), key, jax.tree_util.tree_map(jnp.asarray, params),
        score_module=jmod, sde=JVPSDE(0.1, 5.0), **kw)
    inject(np.asarray(jax.random.normal(key_init, (B, F))),
           xla_tree_source(key_noise, (B, F)))
    s, ours = sample_vpsde(None, (B, F), torch.Generator(), score_module=mod,
                           sde=VPSDE(0.1, 5.0), device="cpu", **kw)
    n = int(ref.naccept)
    assert n >= 3 and int(ours.naccept) == n and bool(ours.success)
    assert int(ours.nreject) == int(ref.nreject)
    assert int(ours.nfe_drift) == int(ref.nfe_drift)
    assert int(ours.nfe_diffusion) == int(ref.nfe_diffusion)
    _close_state(s, s_ref)


# ------------------------------------------------------------------ kernel 6

def _pf_close(ours, ref):
    assert abs(int(ours["naccept"]) - int(ref["naccept"])) <= 1
    assert int(ours["nfe"]) == int(ref["nfe"])
    scale = float(np.abs(np.asarray(ref["y_final"])).max())
    _close(ours["y_final"], ref["y_final"], 5e-5 * scale)


def test_kernel6_plain_matches_jax_pallas():
    params = _jax_params(8)
    _, mod = _modules(params)
    chain = match_td_score_chain(mod)
    x = _x(9)
    saveat = np.asarray([0.5, 0.999], np.float32)
    kw = dict(rtol=1e-4, atol=1e-6, max_steps=128, beta_min=0.1,
              beta_max=20.0, t1=1.0)
    ref = jax_persistent_pf_solve(
        jax.tree_util.tree_map(jnp.asarray, params),
        (chain.dims, chain.acts, chain.keys), jnp.asarray(x), (0.0, 0.999),
        saveat_arr=jnp.asarray(saveat), **kw)
    ours = persistent_pf_solve_plain(
        [p.detach() for p in score_chain_params(mod, chain)], chain,
        torch.tensor(x), (0.0, 0.999), saveat_arr=torch.tensor(saveat), **kw)
    assert int(ref["naccept"]) >= 3 and bool(ours["success"])
    _pf_close(ours, ref)
    scale = float(np.abs(np.asarray(ref["ys"])).max())
    _close(ours["ys"], ref["ys"], 5e-5 * scale)


def test_sample_probability_flow_matches_jax(inject):
    """The whole sampler on its kernel route (the plain version of kernel 6
    on the CPU) against JAX's eager loop, with JAX's u_init injected."""
    params = _jax_params(10)
    jmod, mod = _modules(params)
    key = jax.random.PRNGKey(11)
    kw = dict(rtol=1e-4, atol=1e-6, max_steps=128)
    s_ref, ref = jax_sample_probability_flow(
        None, (B, F), key, jax.tree_util.tree_map(jnp.asarray, params),
        score_module=jmod, use_pallas=False, **kw)
    inject(np.asarray(jax.random.normal(key, (B, F))), None)
    s, ours = sample_probability_flow(None, (B, F), torch.Generator(),
                                      score_module=mod, device="cpu", **kw)
    _pf_close(dict(naccept=ours.naccept, nfe=ours.nfe, y_final=s),
              dict(naccept=ref.naccept, nfe=ref.nfe, y_final=s_ref))


# ------------------------------------------------------------------ analytic

def test_analytic_gaussian_recovered():
    """With the exact N(0, I) score the reverse SDE recovers N(0, I)
    (tests/test_vpsde_kernel.py:73-101), with the reference's NFE
    accounting, and the probability-flow dynamics vanish: its samples are
    u_init (:201-218)."""
    _, _, mod = _neg_identity()
    s, sol = sample_vpsde(None, (512, F), torch.Generator().manual_seed(0),
                          score_module=mod, rtol=1e-2, atol=1e-2,
                          max_steps=512, device="cpu")
    natt = int(sol.naccept) + int(sol.nreject)
    assert bool(sol.success) and int(sol.naccept) > 3
    assert int(sol.nfe_drift) == 1 + 4 * natt
    assert int(sol.nfe_diffusion) == 4 * natt
    assert abs(float(s.mean())) < 0.05 and abs(float(s.std()) - 1) < 0.05
    g = torch.Generator().manual_seed(3)
    s, sol = sample_probability_flow(None, (B, F), g, score_module=mod,
                                     device="cpu")
    u_init = torch.randn((B, F), generator=torch.Generator().manual_seed(3))
    assert bool(sol.success)
    _close(s, u_init, 1e-4)


def test_gaussian_score_sampler_recovers_its_law():
    """A score function, no module (``examples/sampling.py`` part 1): the
    eager loop on a 1-D state recovers N(2, 0.25)."""
    s, sol = sample_vpsde(gaussian_score_fn(mean=2.0, var=0.25), (2048,),
                          torch.Generator().manual_seed(0), rtol=3e-2,
                          atol=3e-2, max_steps=512, device="cpu")
    assert bool(sol.success) and s.shape == (2048,)
    assert abs(float(s.mean()) - 2.0) < 0.05
    assert abs(float(s.std()) - 0.5) < 0.05


def test_sampler_arguments():
    _, _, mod = _neg_identity()
    g = torch.Generator()
    with pytest.raises(ValueError, match="exactly one"):
        sample_vpsde(lambda u, t, p: -u, (4, F), g, score_module=mod,
                     device="cpu")
    with pytest.raises(ValueError, match="score_fn or score_module"):
        sample_probability_flow(None, (4, F), g, device="cpu")
    # Milstein runs the eager loop (kernel 11 serves SRI/SOSRI only)
    s, sol = sample_vpsde(None, (4, F), g, score_module=mod,
                          solver="milstein", rtol=0.5, atol=0.5,
                          device="cpu")
    assert s.shape == (4, F) and int(sol.nfe_diffusion) == 2 * (
        int(sol.naccept) + int(sol.nreject))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sample_vpsde(None, (4, F), g, score_module=mod)


# ------------------------------------------------------------------ kernel 15

def _probe():
    """``scripts/conv_orient_probe.py`` as a module (the file is the JAX
    package's probe; it is not edited)."""
    spec = importlib.util.spec_from_file_location(
        "conv_orient_probe", os.path.join(ROOT, "scripts",
                                          "conv_orient_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_conv_orient_plain_matches_jax_probe():
    """The plain version of kernel 15 against the probe's tap and im2col
    Pallas kernels in interpret mode, at the probe's (32, 32, 32, 64)."""
    probe = _probe()
    b, h, w, c = probe.B, probe.H, probe.W, probe.C
    rng = np.random.default_rng(12)
    x = rng.random((b, h, w, c), np.float32)
    wt = (0.05 * rng.standard_normal((3, 3, c, c))).astype(np.float32)
    ours = conv_orient_plain(torch.tensor(x), torch.tensor(wt)).numpy()
    xf = jnp.asarray(x.reshape(-1, c))
    tap = probe.conv_pallas_tap(xf, jnp.asarray(wt.reshape(9, c, c)))
    im2col = probe.conv_pallas_im2col(
        jnp.pad(xf, ((probe.PAD, probe.PAD), (0, 0))),
        jnp.asarray(wt.reshape(9 * c, c)))
    scale = float(np.abs(ours).max())
    for ref in (tap, im2col):
        _close(ours.reshape(-1, c), ref, 1e-5 * scale)


# ------------------------------------------------------------------ wrappers

def test_wrappers_run_plain_versions_on_cpu():
    params = _jax_params(13)
    _, mod = _modules(params)
    chain = match_td_score_chain(mod)
    ps = [p.detach() for p in score_chain_params(mod, chain)]
    x = torch.tensor(_x(14, rows=24))
    before = launch_counts()
    sched = dict(beta_min=0.1, beta_max=5.0, t1=1.0)
    kw = dict(noise=PhiloxNormals(3, 24, F), rtol=SDE_TOL, atol=SDE_TOL,
              solver="sosri", delta=1 / 6, saveat_arr=torch.tensor([0.999]),
              max_steps=64, **sched)
    a = persistent_vpsde_solve(ps, chain, x, (0.0, 0.999), **kw)
    b = persistent_vpsde_solve_plain(ps, chain, x, (0.0, 0.999), **kw)
    assert torch.equal(a["y_final"], b["y_final"])
    kw = dict(rtol=1e-4, atol=1e-6, saveat_arr=torch.tensor([0.999]),
              max_steps=64, **sched)
    a = persistent_pf_solve(ps, chain, x, (0.0, 0.999), **kw)
    b = persistent_pf_solve_plain(ps, chain, x, (0.0, 0.999), **kw)
    assert torch.equal(a["y_final"], b["y_final"])
    xi = torch.rand(2, 5, 6, 4, generator=torch.Generator().manual_seed(1))
    wi = torch.rand(3, 3, 4, 3, generator=torch.Generator().manual_seed(2))
    ref = conv_orient_plain(xi, wi)
    assert torch.equal(conv_orient_tap(xi, wi), ref)
    assert torch.equal(conv_orient_im2col(xi, wi), ref)
    assert launch_counts() == before
