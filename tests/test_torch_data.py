"""The port's data layer gives the JAX package's arrays and batches bit for bit."""

import gzip
import struct
from pathlib import Path

import numpy as np
import pytest

from tpu_dist import data as jax_data
from tpu_dist.data import mnist as jax_mnist
from tpu_dist_torch import data


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.fixture
def no_idx_files(tmp_path, monkeypatch):
    """Neither side finds IDX files: both generate the synthetic set."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("TPU_DIST_DATA_DIR", raising=False)
    monkeypatch.setattr(jax_mnist, "_SEARCH_DIRS", ())


@pytest.mark.parametrize("n,seed", [(64, 0), (200, 3)])
def test_synthetic_mnist_is_identical(n, seed):
    a = jax_data.synthetic_mnist(n, seed=seed)
    b = data.synthetic_mnist(n, seed=seed)
    _same(b.images, a.images)
    _same(b.labels, a.labels)
    assert b.images.shape == (n, 28, 28, 1) and b.synthetic


@pytest.mark.parametrize("split", ["train", "test"])
def test_load_mnist_synthetic_is_identical(no_idx_files, split):
    a = jax_data.load_mnist(split, synthetic_size=300)
    b = data.load_mnist(split, synthetic_size=300)
    _same(b.images, a.images)
    _same(b.labels, a.labels)
    assert a.synthetic and b.synthetic


def _write_idx(directory, stem, images, labels):
    with gzip.open(directory / f"{stem}-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, len(images), 28, 28) + images.tobytes())
    with gzip.open(directory / f"{stem}-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)) + labels.tobytes())


def test_load_mnist_from_idx_files_is_identical(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(50, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=50, dtype=np.uint8)
    _write_idx(tmp_path, "t10k", images, labels)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TPU_DIST_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jax_mnist, "_SEARCH_DIRS", (str(tmp_path),))
    a = jax_data.load_mnist("test", synthetic_size=40)
    b = data.load_mnist("test", synthetic_size=40)
    assert not a.synthetic and not b.synthetic
    _same(b.images, a.images)
    _same(b.labels, a.labels)
    _same(data.load_idx_labels(tmp_path / "t10k-labels-idx1-ubyte.gz"),
          labels.astype(np.int32))


def test_idx_reader_rejects_bad_magic(tmp_path):
    path = tmp_path / "bad-images-idx3-ubyte.gz"
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">IIII", 1234, 0, 28, 28))
    with pytest.raises(ValueError, match="magic"):
        data.load_idx_images(path)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_partition_indices_are_identical(world):
    a = jax_data.DataPartitioner(range(1000), jax_data.equal_shards(world))
    b = data.DataPartitioner(range(1000), data.equal_shards(world))
    assert b.partitions == a.partitions


@pytest.mark.parametrize("world", [1, 4])
def test_distributed_loader_batches_are_identical(world):
    ds = jax_data.synthetic_mnist(1000, seed=5)
    port_ds = data.synthetic_mnist(1000, seed=5)
    ref = jax_data.DistributedLoader(ds, world, 128, seed=1234)
    ranks = [
        data.DistributedLoader(port_ds, world, 128, rank=r, seed=1234)
        for r in range(world)
    ]
    lb = 128 // world
    for epoch in range(2):
        global_batches = list(ref.epoch(epoch))
        assert len(global_batches) == ref.steps_per_epoch > 0
        for r, loader in enumerate(ranks):
            local = list(loader.epoch(epoch))
            assert loader.steps_per_epoch == len(local) == len(global_batches)
            for (x, y), (gx, gy) in zip(local, global_batches):
                _same(x, gx[r * lb : (r + 1) * lb])
                _same(y, gy[r * lb : (r + 1) * lb])


def test_distributed_loader_rejects_bad_rank_and_batch():
    ds = data.synthetic_mnist(64)
    with pytest.raises(ValueError, match="rank"):
        data.DistributedLoader(ds, 2, 128, rank=2)
    with pytest.raises(ValueError, match="divisible"):
        data.DistributedLoader(ds, 3, 128, rank=0)


# ------------------------------------------------- HostLoader, text, digits


def test_host_loader_keeps_order_and_content():
    rng = np.random.default_rng(0)
    items = [(rng.standard_normal((3, 2)).astype(np.float32), np.arange(i, i + 4))
             for i in range(7)]
    with data.HostLoader(iter(items), "cpu", depth=2) as loader:
        got = list(loader)
    assert len(got) == len(items)
    for (x, y), (a, b) in zip(got, items):
        np.testing.assert_array_equal(x.numpy(), a)
        np.testing.assert_array_equal(y.numpy(), b)
    with data.HostLoader(iter([np.ones(2)] * 3), "cpu", depth=1) as loader:
        assert [t.tolist() for t in loader] == [[1.0, 1.0]] * 3


def test_host_loader_reraises_a_worker_error():
    def broken():
        yield np.zeros(2)
        raise RuntimeError("batch assembly failed")

    loader = data.HostLoader(broken(), "cpu")
    assert next(loader).tolist() == [0.0, 0.0]
    with pytest.raises(RuntimeError, match="batch assembly failed"):
        next(loader)
    with pytest.raises(StopIteration):
        next(loader)
    loader.close()


def test_host_loader_joins_on_an_early_close():
    def endless():
        i = 0
        while True:
            yield np.full(3, i)
            i += 1

    with data.HostLoader(endless(), "cpu", depth=2) as loader:
        assert next(loader).tolist() == [0, 0, 0]
        thread = loader._thread
    assert not thread.is_alive()
    with pytest.raises(StopIteration):
        next(loader)


def test_host_loader_refuses_depth_below_one():
    with pytest.raises(ValueError, match="depth"):
        data.HostLoader(iter([]), "cpu", depth=0)


@pytest.mark.parametrize("seq_len", [64, 256])
def test_text_corpus_and_split_are_identical(seq_len):
    from tpu_dist.data import text as jax_text

    path = Path(__file__).resolve().parents[1] / "docs" / "tutorial.md"
    a = jax_text.load_text(path, seq_len)
    b = data.load_text(path, seq_len)
    assert len(a) == len(b) > 0 and data.TEXT_VOCAB == jax_text.VOCAB == 256
    for i in (0, len(a) // 2, len(a) - 1):
        _same(b[i], a[i])
    assert b.decode(b[0]) == a.decode(a[0])
    ta, va = jax_text.load_text(path, seq_len, val_fraction=0.1)
    tb, vb = data.load_text(path, seq_len, val_fraction=0.1)
    assert tb.indices == ta.indices and vb.indices == va.indices
    _same(np.stack([tb[i] for i in range(len(tb))]), np.stack([ta[i] for i in range(len(ta))]))
    blob = "héllo wörld " * 30
    _same(data.TextCorpus(blob, 16)[3], jax_text.TextCorpus(blob, 16)[3])
    with pytest.raises(ValueError, match="shorter than one window"):
        data.TextCorpus("ab", 16)


@pytest.mark.parametrize("split", ["train", "test"])
def test_real_digits_are_identical(split):
    a = jax_data.load_real_digits(split)
    b = data.load_real_digits(split)
    _same(b.images, a.images)
    _same(b.labels, a.labels)
    assert not b.synthetic and b.images.shape[1:] == (28, 28, 1)
