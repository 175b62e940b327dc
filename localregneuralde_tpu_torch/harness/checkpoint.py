"""Checkpoint save and load with best/current pointers.

Counterpart of ``localregneuralde_tpu/harness/checkpoint.py`` (reference
``experiments/src/utils.jl:169-191``: JLSO blobs and ``model_best`` /
``model_current`` symlinks). A checkpoint is a pickle of a host tree:
nested dicts, lists and tuples of numpy arrays and Python scalars, written
atomically (a temporary file, then a rename). ``to_host`` makes such a tree
from tensors, and from ``torch.Generator``s (their state, so that a resumed
run draws what the uninterrupted run would have drawn); ``from_host``
inverts it. A corrupt or missing checkpoint warns and loads as None, so the
run starts fresh, as the reference's does. The reference's orbax backend is
not ported.
"""
from __future__ import annotations

import os
import pickle
import warnings
from typing import Any, Optional

import numpy as np
import torch

_GENERATOR = "__torch_generator_state__"


def to_host(tree):
    """``tree`` with every tensor as a numpy array and every generator as
    its state."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, torch.Generator):
        return {_GENERATOR: tree.get_state().numpy()}
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def from_host(tree, device=None):
    """Inverse of ``to_host``: numpy arrays become tensors on ``device``,
    generator states CPU generators."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(device)
    if isinstance(tree, dict):
        if set(tree) == {_GENERATOR}:
            g = torch.Generator()
            g.set_state(torch.from_numpy(np.array(tree[_GENERATOR])))
            return g
        return {k: from_host(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_host(v, device) for v in tree)
    return tree


def save_checkpoint(state: Any, *, fdir: str, fname: str,
                    is_best: bool = False) -> str:
    """Write ``to_host(state)`` to ``fdir/fname`` and point
    ``model_current.ckpt`` (and, if ``is_best``, ``model_best.ckpt``) at
    it."""
    os.makedirs(fdir, exist_ok=True)
    path = os.path.join(fdir, fname)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(to_host(state), f)
    os.replace(tmp, path)
    _symlink_safe(path, os.path.join(fdir, "model_current.ckpt"))
    if is_best:
        _symlink_safe(path, os.path.join(fdir, "model_best.ckpt"))
    return path


def load_checkpoint(path: str) -> Optional[Any]:
    """The host tree of a checkpoint, or None (with a warning) when it
    cannot be read."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception as e:  # warn and start fresh (reference utils.jl:182-191)
        warnings.warn(f"could not load checkpoint {path!r}: {e}")
        return None


def _symlink_safe(target: str, link: str):
    try:
        if os.path.islink(link) or os.path.exists(link):
            os.remove(link)
        os.symlink(os.path.abspath(target), link)
    except OSError as e:
        warnings.warn(f"could not create symlink {link!r}: {e}")
