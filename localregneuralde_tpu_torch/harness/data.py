"""The host data pipeline: the MNIST and CIFAR-10 loaders, the
deterministic synthetic stand-ins (classification and PhysioNet-like
series), one-hot labels and the shuffling batcher.

Copied from ``localregneuralde_tpu/harness/data.py`` (numpy only, so the
two packages make the same arrays and batches from the same seed).
``make_dataloader`` returns the port's native C++ loader
(``native/loader.py``) at ``backend='auto'``, as the JAX package does, so
the runners train on the JAX runners' batches; ``'python'`` names the
Python loader, whose epochs are shuffled in another order.
"""
from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
from typing import Iterator, Optional, Sequence, Tuple

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


def load_cifar10(data_root: str = ""):
    """(x_train, y_train, x_test, y_test); x: (N,32,32,3) float32 ∈ [0,1],
    from ``cifar10.npz`` or the binary batches of ``cifar-10-batches-bin``
    under ``data_root``. Returns None if no real data is present."""
    if not data_root:
        return None
    npz = _find(data_root, ["cifar10.npz"])
    if npz:
        d = np.load(npz)
        return (
            d["x_train"].astype(np.float32) / 255.0,
            d["y_train"].astype(np.int32),
            d["x_test"].astype(np.float32) / 255.0,
            d["y_test"].astype(np.int32),
        )
    batches = [
        os.path.join(data_root, "cifar-10-batches-bin", f"data_batch_{i}.bin")
        for i in range(1, 6)
    ]
    test = os.path.join(data_root, "cifar-10-batches-bin", "test_batch.bin")
    if all(os.path.exists(b) for b in batches) and os.path.exists(test):
        def read_bin(path):
            raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 3073)
            y = raw[:, 0].astype(np.int32)
            x = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            return x.astype(np.float32) / 255.0, y

        xs, ys = zip(*[read_bin(b) for b in batches])
        xte, yte = read_bin(test)
        return np.concatenate(xs), np.concatenate(ys), xte, yte
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


def get_classification_data(cfg):
    """(x_train, y_train, x_test, y_test, is_real) for a config: MNIST for
    28×28×1 images and CIFAR-10 otherwise, read from
    ``cfg.dataset.data_root`` when there, else the synthetic stand-in at the
    config's image shape."""
    size = tuple(cfg.model.image_size)
    if size == (28, 28) and cfg.model.in_channels == 1:
        real = load_mnist(cfg.dataset.data_root)
    else:
        real = load_cifar10(cfg.dataset.data_root)
    if real is not None:
        return real + (True,)
    return synthetic_classification(
        size, cfg.model.in_channels, cfg.model.num_classes, seed=cfg.seed,
        difficulty=getattr(cfg.dataset, "difficulty", "easy"),
    ) + (False,)


def one_hot(y: np.ndarray, num_classes: int) -> np.ndarray:
    out = np.zeros((y.shape[0], num_classes), np.float32)
    out[np.arange(y.shape[0]), y] = 1.0
    return out


def synthetic_physionet(
    n=1024, t_steps=49, features=37, seed=0, observe_prob=0.5,
    difficulty="easy",
):
    """Irregularly observed multivariate series from a latent oscillator,
    shaped like the PhysioNet tuples of the reference
    (``experiments/physionet/main.jl:15-30``): returns (data (N, T, F),
    mask (N, T, F), tgrid (T,)), batch-major. ``difficulty='easy'``: a 2-D
    oscillator; ``'hard'``: a 4-D multi-scale latent with 5× the
    observation noise (see the reference's docstring)."""
    rng = np.random.RandomState(seed)
    tgrid = np.sort(rng.rand(t_steps).astype(np.float32))
    tgrid[0] = 0.0
    hard = difficulty == "hard"
    d_latent = 4 if hard else 2
    decoder = rng.randn(d_latent, features).astype(np.float32) * 0.5
    phase = rng.rand(n, 1).astype(np.float32) * 2 * np.pi
    freqs = 1.0 + rng.rand(n, 1).astype(np.float32)
    z1 = np.sin(2 * np.pi * freqs * tgrid[None, :] + phase)
    z2 = np.cos(2 * np.pi * freqs * tgrid[None, :] + phase)
    comps = [z1, z2]
    if hard:
        phase_f = rng.rand(n, 1).astype(np.float32) * 2 * np.pi
        freqs_f = 4.0 + 4.0 * rng.rand(n, 1).astype(np.float32)
        amp = 0.4
        comps.append(amp * np.sin(2 * np.pi * freqs_f * tgrid[None, :] + phase_f))
        comps.append(amp * np.cos(2 * np.pi * freqs_f * tgrid[None, :] + phase_f))
    latent = np.stack(comps, axis=-1)  # (N, T, d_latent)
    data = latent @ decoder  # (N, T, F)
    noise = 0.25 if hard else 0.05
    data += noise * rng.randn(*data.shape).astype(np.float32)
    mask = (rng.rand(n, t_steps, features) < observe_prob).astype(np.float32)
    return data.astype(np.float32), mask, tgrid


def make_dataloader(arrays, batch_size, *, backend: str = "auto", **kwargs):
    """The batch loader of the JAX package's backends: ``'auto'`` and
    ``'native'`` the native C++ loader (built at first use; a failed build
    raises rather than hand over to the Python loader, whose batches
    differ), ``'python'`` the Python ``Dataloader``. Both have one iterator
    contract."""
    if backend in ("auto", "native"):
        from ..native import NativeDataloader

        return NativeDataloader(arrays, batch_size, **kwargs)
    if backend != "python":
        raise ValueError(
            f"dataloader backend must be 'auto', 'native' or 'python', got "
            f"{backend!r}")
    return Dataloader(arrays, batch_size, **kwargs)


class Dataloader:
    """Shuffling batcher with background-thread prefetch into a bounded
    queue (the reference's ``eachobsparallel`` buffered channel,
    ``utils.jl:155-166``). ``cycle=True`` repeats forever; epoch e is
    shuffled with ``RandomState(seed + e)``. ``skip_batches`` fast-forwards
    the stream by whole batches (exact resume from a checkpoint). A loader
    that does not cycle and skips all its batches yields nothing, as the
    port's native loader does (the JAX package's native loader yields a
    later epoch there; README, documented deviations)."""

    def __init__(
        self,
        arrays: Tuple[np.ndarray, ...],
        batch_size: int,
        *,
        shuffle: bool = False,
        cycle: bool = False,
        seed: int = 0,
        prefetch: int = 4,
        drop_last: bool = True,
        skip_batches: int = 0,
    ):
        self.arrays = arrays
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.cycle = cycle
        self.seed = seed
        self.prefetch = prefetch
        self.skip_batches = max(0, int(skip_batches))
        n = arrays[0].shape[0]
        if drop_last:
            self.n_batches = n // batch_size
        else:
            self.n_batches = -(-n // batch_size)
        self.n = n

    def __len__(self):
        return self.n_batches

    def _indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx

    def _produce(self, q: "queue.Queue"):
        nb = self.n_batches
        if nb == 0 or (not self.cycle and self.skip_batches >= nb):
            q.put(None)
            return
        epoch, b0 = divmod(self.skip_batches, nb)
        while True:
            idx = self._indices(epoch)
            for b in range(b0, nb):
                sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
                q.put(tuple(a[sel] for a in self.arrays))
            if not self.cycle:
                q.put(None)
                return
            epoch += 1
            b0 = 0

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        thread = threading.Thread(target=self._produce, args=(q,), daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item
