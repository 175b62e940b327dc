"""What evaluation needs of the data pipeline: the MNIST loader, the
deterministic synthetic stand-in and one-hot labels.

Copied from ``localregneuralde_tpu/harness/data.py`` (numpy only, so the
two packages make the same arrays from the same seed). The batching and
prefetch machinery comes with the training slice.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Sequence

import numpy as np


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(dims)


def _find(data_root: str, names: Sequence[str]) -> Optional[str]:
    for name in names:
        for suffix in ("", ".gz"):
            p = os.path.join(data_root, name + suffix)
            if os.path.exists(p):
                return p
    return None


def load_mnist(data_root: str = ""):
    """(x_train, y_train, x_test, y_test); x: (N,28,28,1) float32 ∈ [0,1],
    y: int labels. Returns None if no real data is present."""
    if not data_root:
        return None
    npz = _find(data_root, ["mnist.npz"])
    if npz:
        d = np.load(npz)
        return (
            d["x_train"].reshape(-1, 28, 28, 1).astype(np.float32) / 255.0,
            d["y_train"].astype(np.int32),
            d["x_test"].reshape(-1, 28, 28, 1).astype(np.float32) / 255.0,
            d["y_test"].astype(np.int32),
        )
    xtr = _find(data_root, ["train-images-idx3-ubyte", "train-images.idx3-ubyte"])
    ytr = _find(data_root, ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"])
    xte = _find(data_root, ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"])
    yte = _find(data_root, ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"])
    if xtr and ytr and xte and yte:
        return (
            _read_idx(xtr)[..., None].astype(np.float32) / 255.0,
            _read_idx(ytr).astype(np.int32),
            _read_idx(xte)[..., None].astype(np.float32) / 255.0,
            _read_idx(yte).astype(np.int32),
        )
    return None


def synthetic_classification(
    image_size=(28, 28), channels=1, num_classes=10,
    n_train=8192, n_test=2048, seed=0, difficulty="easy",
):
    """Class-prototype images + Gaussian noise: learnable, fixed seed.
    ``difficulty='hard'`` overlaps the prototypes and resamples 8% of the
    labels, so accuracy plateaus below ~93%."""
    rng = np.random.RandomState(seed)
    h, w = image_size
    # smooth prototypes: low-frequency random fields per class
    freq = rng.randn(num_classes, 4, 4, channels)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    protos = np.zeros((num_classes, h, w, channels), np.float32)
    for c in range(num_classes):
        for i in range(4):
            for j in range(4):
                basis = np.sin(
                    (i + 1) * np.pi * yy / h
                ) * np.sin((j + 1) * np.pi * xx / w)
                protos[c] += freq[c, i, j] * basis[..., None]
    protos = (protos - protos.min()) / (np.ptp(protos) + 1e-8)

    hard = difficulty == "hard"
    if hard:
        protos = 0.5 * protos + 0.5 * protos.mean(axis=0, keepdims=True)
    noise = 0.4 if hard else 0.25
    label_noise = 0.08 if hard else 0.0

    def make(n, seed_):
        r = np.random.RandomState(seed_)
        y = r.randint(0, num_classes, size=n).astype(np.int32)
        x = protos[y] + noise * r.randn(n, h, w, channels).astype(np.float32)
        if label_noise > 0:
            flip = r.rand(n) < label_noise
            y = np.where(
                flip, r.randint(0, num_classes, size=n).astype(np.int32), y
            )
        return np.clip(x, 0, 1).astype(np.float32), y

    x_train, y_train = make(n_train, seed + 1)
    x_test, y_test = make(n_test, seed + 2)
    return x_train, y_train, x_test, y_test


def one_hot(y: np.ndarray, num_classes: int) -> np.ndarray:
    out = np.zeros((y.shape[0], num_classes), np.float32)
    out[np.arange(y.shape[0]), y] = 1.0
    return out
