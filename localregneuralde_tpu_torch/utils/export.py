"""Serving export: ``torch.export`` programs in an artifact on disk.

Counterpart of ``localregneuralde_tpu/utils/export.py``. A trained model's
eval-mode forward is exported as a static-shape ``ExportedProgram`` that a
serving process loads and runs **without the model builder or any model
code** (nothing of ``models/`` or ``harness/``): ``torch`` and
``ops/cuda/serving.py``, which registers the solves' operators, with the
operator layer under it (``ops/``, ``ode/``, ``sde/``, ``nn/``), are all
that loading imports::

    exp = export_model(model, params, state, example)      # trace + freeze
    save_exported(exp, "model.lrnde")                       # bytes on disk
    ...
    fn = load_exported("model.lrnde")                       # serving process
    y = fn(batch)

Design notes:

- **The solves are operators.** The adaptive loops of kernels 4, 10 and 6
  accept steps inside the kernel; each is one registered operator
  (``lrnde::tsit5_solve``, ``lrnde::sde_solve``, ``lrnde::pf_solve``) that
  the program records as one node, with the tier the live model resolved.
  On CUDA it launches the kernel, on the CPU it runs the plain version.
  The eager loop (host accepts) cannot be traced: a NeuralODE exports on
  the TD-MLP family's kernel 4 only, a NeuralDSDE on kernel 10; the CIFAR
  conv family (host accepts around kernel 13) and the latent model's chain
  (kernel 5, no operator yet) raise ``NotImplementedError``.
- **Static shapes**, as the reference's: one program per batch size;
  ``export_model_multi`` packs a ladder into one artifact and dispatch
  picks by leading dim.
- **Weights are baked** (``freeze=True``); ``freeze=False`` exports
  ``fn(params, x)`` with ``params`` the ``{name: tensor}`` of
  ``named_parameters()``.
- **Eval-mode forward** (``training=False``): no regulariser, no training
  draws.
- **The layer state.** A layer's CPU ``torch.Generator`` cannot enter a
  program, so its eval draws (the NeuralDSDE's Brownian seed word) are
  staged first from a copy of the generators, and the caller's state is
  left as it was. ``freeze_state=True`` bakes one call's draws: every call
  replays the Brownian path of the live model's next call (deterministic
  serving). ``freeze_state=False`` exports ``fn(state, x) -> (y, state')``
  on the state as tensors (``export_state``: the tensors of the layer
  state and the staged draws); the first call equals the live model's,
  and ``state'`` carries the next call's seed words, mixed in the program
  from this call's, so each threaded call draws a new path.
- An artifact runs on the device its program was traced on (the weights'
  and the example's); there is no ``platforms`` option.
"""
from __future__ import annotations

import copy
import io
import os
import struct
from typing import Any, Callable, Sequence

import torch
from torch.utils._pytree import tree_map

_MAGIC = b"LRNDE-EXPORT-V1\n"


def _tensors(tree):
    """The tensor leaves of a layer-state tree, its structure kept (a
    generator or another non-tensor leaf is dropped)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()
                if isinstance(v, (dict, torch.Tensor))}
    return tree


def _merge(tensors, full):
    """``full`` (a layer-state tree) with its tensor leaves and the
    ``draws`` entries taken from ``tensors``."""
    if not isinstance(full, dict):
        return tensors
    out = dict(full)
    for k, v in tensors.items():
        out[k] = _merge(v, full[k]) if k in full else v
    return out


def _next_words(tree):
    """The next call's draws: each int32 seed word mixed into another (a
    bijective 32-bit hash on int64 arithmetic, traceable)."""
    def mix(t):
        if t.dtype != torch.int32:
            return t
        x = t.to(torch.int64) & 0xFFFFFFFF
        x = (x * 0x5BD1E995 + 0x7F4A7C15) & 0xFFFFFFFF
        x = x ^ (x >> 15)
        x = (x * 0x27D4EB2D) & 0xFFFFFFFF
        x = x ^ (x >> 13)
        return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)

    return tree_map(mix, tree)


def _with_next_draws(st_in, st_out):
    """``st_out`` (a call's returned state as tensors) with the draws of
    ``st_in`` advanced, wherever ``st_in`` carried some."""
    from ..models.draws import DRAWS

    out = dict(st_out)
    for k, v in st_in.items():
        if k == DRAWS:
            out[DRAWS] = _next_words(v)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _with_next_draws(v, out[k])
    return out


def export_state(model, state, example_input) -> dict:
    """The threaded state of ``freeze_state=False`` exports: the tensors of
    ``state`` with the draws of the live model's next eval call on a batch
    like ``example_input`` (staged from a copy of the generators; ``state``
    is not advanced)."""
    return _tensors(_staged(model, state, int(example_input.shape[0])))


def _staged(model, state, rows: int):
    """``state`` with the draws of the live model's next eval call on
    ``rows`` rows, staged from a copy of its generators (the model code is
    imported here: loading an artifact needs none of it)."""
    from ..models.draws import cloned_generators, stage_eval_draws, with_draws

    st = cloned_generators(state)
    return with_draws(st, stage_eval_draws(model, st, rows))


class _Forward(torch.nn.Module):
    """The eval-mode forward of ``model`` in the signature of an export:
    ``(x)``, ``(state, x)``, ``(params, x)`` or ``(params, state, x)``."""

    def __init__(self, model, state, rows: int, *, freeze: bool,
                 freeze_state: bool, with_state: bool):
        super().__init__()
        if freeze:
            self.model = model
        else:
            # not a submodule: the program takes the weights as an input
            self.__dict__["model"] = model
        self.__dict__["state"] = _staged(model, state, rows)
        self.freeze, self.freeze_state = freeze, freeze_state
        self.with_state = with_state or not freeze_state

    def _call(self, params, state, x):
        if params is None:
            return self.model(x, state, training=False)
        return torch.func.functional_call(self.model, params, (x, state),
                                          {"training": False})

    def _run(self, params, st_in, x):
        state = self.state if st_in is None else _merge(st_in, self.state)
        y, st = self._call(params, state, x)
        if not self.with_state:
            return y
        st = _tensors(st)
        return y, (st if st_in is None else _with_next_draws(st_in, st))

    def forward(self, *args):
        params = None if self.freeze else args[0]
        rest = args if self.freeze else args[1:]
        st_in = None if self.freeze_state else rest[0]
        return self._run(params, st_in, rest[-1])


def export_model(model, params, state, example_input, *, freeze: bool = True,
                 freeze_state: bool = True, with_state: bool = False
                 ) -> torch.export.ExportedProgram:
    """Trace the eval-mode forward of ``model`` at ``example_input``'s
    shape, dtype and device and export it.

    ``params`` are the weights (``{name: tensor}`` as ``named_parameters``
    gives them, or None for the model's own): ``freeze=True`` bakes them
    into the program; otherwise the program takes them as its first
    argument. ``freeze_state=True`` likewise bakes the layer state with one
    call's staged draws (a NeuralDSDE replays one Brownian path); with
    ``freeze_state=False`` the program is ``fn(state, x) -> (y, state')``
    on ``export_state``'s tensors, each call drawing a new path.
    ``with_state=True`` also returns the post-call state's tensors (NFE,
    success: serving-side solver telemetry); implied by
    ``freeze_state=False``. The model's weights and ``state`` are not
    changed.
    """
    if freeze:
        # a copy, so that the program's weights are a snapshot
        model = copy.deepcopy(model)
        if params is not None:
            own = dict(model.named_parameters())
            with torch.no_grad():
                for k, v in params.items():
                    own[k].copy_(v)
    fwd = _Forward(model, state, int(example_input.shape[0]), freeze=freeze,
                   freeze_state=freeze_state, with_state=with_state)
    args = (example_input,)
    if not freeze_state:
        args = (export_state(model, state, example_input),) + args
    if not freeze:
        p = params if params is not None else dict(model.named_parameters())
        args = ({k: v.detach() for k, v in p.items()},) + args
    with torch.no_grad():
        return torch.export.export(fwd, args)


class _Fn(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.__dict__["fn"] = fn

    def forward(self, *args):
        return self.fn(*args)


def export_fn(fn: Callable, *example_args) -> torch.export.ExportedProgram:
    """Export an arbitrary callable of tensors (e.g. a probability-flow
    sampler closed over its score network, its starting noise an argument:
    ``sample_probability_flow(..., u_init=u)``) at the shapes, dtypes and
    devices of ``example_args``. Tensors and modules the callable closes
    over are baked in; a ``torch.Generator`` cannot enter the program, so
    its draws are arguments."""
    with torch.no_grad():
        return torch.export.export(_Fn(fn), tuple(example_args))


def export_model_multi(model, params, state, example_input,
                       batch_sizes: Sequence[int], **kwargs) -> dict:
    """One exported program per batch size (static-shape serving ladder):
    ``example_input``'s leading axis replaced by each of ``batch_sizes``.
    Returns ``{B: ExportedProgram}``; see ``MultiExported`` for the
    dispatching loader."""
    outs = {}
    for b in batch_sizes:
        x = example_input.new_zeros((int(b),) + tuple(example_input.shape[1:]))
        outs[int(b)] = export_model(model, params, state, x, **kwargs)
    return outs


# ---------------------------------------------------------------------------
# serialization container: MAGIC | n | (name_len | len | name | bytes)*


def _pack(named_blobs) -> bytes:
    out = [_MAGIC, struct.pack("<I", len(named_blobs))]
    for name, blob in named_blobs:
        nb = name.encode()
        out.append(struct.pack("<II", len(nb), len(blob)))
        out.append(nb)
        out.append(bytes(blob))
    return b"".join(out)


def _unpack(data: bytes):
    if not data.startswith(_MAGIC):
        raise ValueError("not an LRNDE export artifact")
    off = len(_MAGIC)
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    blobs = []
    for _ in range(n):
        ln, lb = struct.unpack_from("<II", data, off)
        off += 8
        name = data[off:off + ln].decode()
        off += ln
        blobs.append((name, data[off:off + lb]))
        off += lb
    return blobs


def _serialize(exported) -> bytes:
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def save_exported(exported, path: str) -> None:
    """Serialize one ``ExportedProgram`` (or a ``{batch: ExportedProgram}``
    ladder from ``export_model_multi``) to ``path`` atomically (tmp and
    rename, as ``harness/checkpoint.py`` writes): the LRNDE container, each
    blob the bytes of ``torch.export.save``."""
    if isinstance(exported, dict):
        blobs = [(f"b{b}", _serialize(e)) for b, e in sorted(exported.items())]
    else:
        blobs = [("single", _serialize(exported))]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_pack(blobs))
    os.replace(tmp, path)


class MultiExported:
    """Batch-size-dispatching wrapper over a serving ladder.

    Calls route to the smallest exported batch size ≥ the input's leading
    dim, zero-padding the tail (adaptive-solver note: padding joins the
    shared batch error norm, so tiny remainders on a big program can alter
    step counts — export the ladder you actually serve)."""

    def __init__(self, by_batch):
        self.by_batch = dict(sorted(by_batch.items()))

    def __call__(self, x, *args):
        b = x.shape[0]
        for bb, fn in self.by_batch.items():
            if bb >= b:
                if bb == b:
                    return fn(x, *args)
                pad = x.new_zeros((bb - b,) + tuple(x.shape[1:]))
                y = fn(torch.cat([x, pad]), *args)
                # strip padding only from batch-leading outputs (scalar
                # telemetry like NFE counters passes through untouched)
                return tree_map(
                    lambda a: a[:b] if isinstance(a, torch.Tensor)
                    and a.ndim and a.shape[0] == bb else a, y)
        raise ValueError(
            f"batch {b} exceeds largest exported size {max(self.by_batch)}")


def load_exported(path: str) -> Any:
    """Load an artifact saved by ``save_exported``: a callable module for a
    single export (its baked weights need no gradient), a
    ``MultiExported`` dispatcher for a ladder. Needs
    ``torch`` and the solves' operators (``ops/cuda/serving.py``, imported
    here, with the operator layer under it); no model builder and nothing
    of ``models/``."""
    from ..ops.cuda import serving  # noqa: F401  (registers lrnde::*)

    with open(path, "rb") as f:
        blobs = _unpack(f.read())

    def load(blob):
        module = torch.export.load(io.BytesIO(blob)).module()
        module.requires_grad_(False)  # serving: baked weights are constants
        return module

    if len(blobs) == 1 and blobs[0][0] == "single":
        return load(blobs[0][1])
    return MultiExported({int(name[1:]): load(blob) for name, blob in blobs})
