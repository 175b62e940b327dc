"""The port's native C++ batch loader (``localregneuralde_tpu_torch/native``)
against the JAX package's: the same batches at the same seed (epoch e
shuffled by ``std::shuffle`` on ``mt19937_64(seed + e)``), the cases of
``tests/test_native_loader.py``, the one repaired deviation (a stream that
does not cycle and skips all its batches yields nothing), the training
runner's batches, and a failed build raising."""
import itertools

import numpy as np
import pytest

from localregneuralde_tpu.harness.data import (
    get_classification_data as jax_classification_data,
    make_dataloader as jax_make_dataloader,
    one_hot as jax_one_hot,
)
from localregneuralde_tpu.native import NativeDataloader as JaxNative
from localregneuralde_tpu_torch.harness.data import Dataloader, make_dataloader
from localregneuralde_tpu_torch.native import NativeDataloader, loader


def _data(n=200, f=8):
    x = np.arange(n * f, dtype=np.float32).reshape(n, f)
    y = np.arange(n, dtype=np.int64)
    return x, y


def _take(dl, n):
    return list(itertools.islice(iter(dl), n))


def _same(a, b):
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert len(u) == len(v)
        for s, t in zip(u, v):
            np.testing.assert_array_equal(s, t)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, cycle=True, seed=7),
    dict(shuffle=True, drop_last=False, seed=3),
    dict(shuffle=True, cycle=True, seed=7, skip_batches=9),
    dict(shuffle=False, drop_last=False),
], ids=["cycle", "ragged", "resume", "ordered"])
def test_batches_equal_the_jax_native_loader(kw):
    """14 batches (more than two epochs where the stream cycles) equal the
    JAX loader's, row for row; a ``skip_batches`` resume mid-epoch too."""
    x, y = _data()
    _same(_take(NativeDataloader((x, y), 32, **kw), 14),
          _take(JaxNative((x, y), 32, **kw), 14))


def test_rows_stay_aligned_across_arrays():
    x, y = _data()
    batches = list(NativeDataloader((x, y), 32, shuffle=True, seed=7))
    assert len(batches) == 200 // 32
    for xb, yb in batches:
        np.testing.assert_array_equal(xb[:, 0], yb.astype(np.float32) * 8)


def test_epoch_covers_rows_without_duplicates():
    x, y = _data()
    seen = np.concatenate([b[1] for b in NativeDataloader(
        (x, y), 32, shuffle=True, seed=7)])
    assert len(set(seen.tolist())) == len(seen)


def test_cycle_mode_streams_forever():
    x, y = _data()
    dl = NativeDataloader((x, y), 32, shuffle=True, cycle=True, seed=7)
    for xb, _ in _take(dl, 20):  # > 3 epochs
        assert xb.shape == (32, 8)
    dl.close()


def test_make_dataloader_backends():
    """'auto' and 'native' give the native loader (as the JAX package's
    'auto' does), 'python' the Python one, anything else raises."""
    x, y = _data()
    assert isinstance(make_dataloader((x, y), 32), NativeDataloader)
    assert isinstance(make_dataloader((x, y), 32, backend="native"),
                      NativeDataloader)
    assert isinstance(make_dataloader((x, y), 32, backend="python"),
                      Dataloader)
    with pytest.raises(ValueError):
        make_dataloader((x, y), 32, backend="cpp")


def test_a_stream_that_skips_all_its_batches_yields_nothing():
    """The repaired fault: without cycling, skipping every batch of the
    epoch (or more) yields nothing, as the Python loader does; the JAX
    package's native loader yields a later epoch there."""
    x, y = _data()
    for skip in (6, 7, 13):
        assert list(NativeDataloader((x, y), 32, skip_batches=skip)) == []
        assert list(Dataloader((x, y), 32, skip_batches=skip)) == []
    assert len(list(JaxNative((x, y), 32, skip_batches=6))) == 6
    assert len(list(NativeDataloader((x, y), 32, skip_batches=5))) == 1


def test_training_runner_sees_the_jax_runners_batches(tmp_path, monkeypatch):
    """The port's classification runner at the default backend trains on
    the batches the JAX runner's loader gives at the same config and seed:
    its first two batches, recorded as the runner takes them, equal JAX's
    ``make_dataloader`` on the JAX runner's arrays and arguments."""
    from localregneuralde_tpu.harness.config import (
        define_configuration as jax_define,
    )
    from localregneuralde_tpu_torch.harness import runner
    from localregneuralde_tpu_torch.harness.config import define_configuration

    args = ["--model.mlp_hidden_state_size=8", "--model.solver.reltol=1e-2",
            "--model.solver.abstol=1e-2", "--model.solver.max_steps=32",
            "--dataset.train_batchsize=16", "--dataset.eval_batchsize=1024",
            "--train.total_steps=2", "--train.print_frequency=1",
            "--train.evaluate_every=2", "--seed=3",
            f"--train.checkpoint_dir={tmp_path}/ck",
            f"--train.log_dir={tmp_path}/lg"]
    config = "experiments/mnist_ode/mlp.yaml"
    seen, made = [], []

    def recording(arrays, batch_size, **kw):
        dl = make_dataloader(arrays, batch_size, **kw)
        made.append(dl)
        if not kw.get("cycle"):
            return dl

        class Recorder:
            def __iter__(self):
                for b in dl:
                    seen.append(tuple(np.array(a) for a in b))
                    yield b

        return Recorder()

    monkeypatch.setattr(runner, "make_dataloader", recording)
    runner.run_classification_experiment(
        define_configuration(args, config), "nl", device="cpu")
    assert all(isinstance(dl, NativeDataloader) for dl in made)

    cfg = jax_define(args, config)
    x, y, _, _, _ = jax_classification_data(cfg)
    ref = jax_make_dataloader(
        (x, jax_one_hot(y, 10)), cfg.dataset.train_batchsize, shuffle=True,
        cycle=True, seed=cfg.seed, skip_batches=0)
    assert isinstance(ref, JaxNative)
    _same(seen[:2], _take(ref, 2))


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises from ``make_dataloader`` (no
    quiet hand-over to the Python loader, whose batches differ)."""
    bad = tmp_path / "dataloader.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "SRC", bad)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(loader, "_lib", None)
    with pytest.raises(RuntimeError, match="did not build"):
        make_dataloader(_data(), 32)
    assert not list((tmp_path / "build").glob("*.so"))
