"""The port's CIFAR-10 and ImageNet-shaped data against `tpu_dist.data.cifar`:
the same numpy code, so the same arrays bit for bit."""

import numpy as np
import pytest

from tpu_dist import data as jax_data
from tpu_dist.data import cifar as jax_cifar
from tpu_dist_torch import data
from tpu_dist_torch.data import cifar


def _assert_same(got, want):
    assert got.images.dtype == want.images.dtype == np.float32
    assert got.labels.dtype == want.labels.dtype == np.int32
    assert np.array_equal(got.images, want.images)
    assert np.array_equal(got.labels, want.labels)
    assert got.synthetic == want.synthetic


@pytest.mark.parametrize("n,seed", [(1, 0), (100, 0), (64, 1), (33, 9)])
def test_synthetic_cifar10_equals_jax(n, seed):
    got = data.synthetic_cifar10(n, seed=seed)
    _assert_same(got, jax_data.synthetic_cifar10(n, seed=seed))
    assert got.images.shape == (n, 32, 32, 3)


@pytest.mark.parametrize(
    "kw",
    [dict(shape=(32, 32, 3), classes=10, seed=0), dict(shape=(48, 40, 3), classes=7, seed=3),
     dict(shape=(224, 224, 3), classes=1000, seed=1)],
    ids=["32px", "48x40", "224px"],
)
def test_synthetic_images_equals_jax(kw):
    _assert_same(data.synthetic_images(6, **kw), jax_data.synthetic_images(6, **kw))


def test_synthetic_images_refuses_sizes_off_eight():
    with pytest.raises(ValueError, match="multiples of 8"):
        data.synthetic_images(2, shape=(30, 32, 3))


def _write_batches(directory, sizes, seed=0):
    """CIFAR-10 binary batches of random records: data_batch_1..5 then
    test_batch, with ``sizes`` records each."""
    rng = np.random.default_rng(seed)
    names = [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]
    for name, n in zip(names, sizes, strict=True):
        rec = np.concatenate([rng.integers(0, 10, (n, 1)), rng.integers(0, 256, (n, 3072))],
                             axis=1).astype(np.uint8)
        (directory / name).write_bytes(rec.tobytes())


@pytest.mark.parametrize("split,limit", [("train", None), ("train", 7), ("train", 4),
                                         ("test", None), ("test", 3)])
def test_load_cifar10_reads_binaries_as_jax(tmp_path, monkeypatch, split, limit):
    """From ``$TPU_DIST_DATA_DIR`` (the JAX module's search list pointed at
    the same directory): labels, channel-major pixels to NHWC, the
    normalization, and the limit that stops reading files early."""
    _write_batches(tmp_path, [3, 3, 3, 3, 3, 5])
    monkeypatch.setenv("TPU_DIST_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jax_cifar, "_SEARCH_DIRS", (str(tmp_path),))
    got = data.load_cifar10(split, limit=limit)
    want = jax_data.load_cifar10(split, limit=limit)
    _assert_same(got, want)
    assert not got.synthetic
    n = {"train": 15, "test": 5}[split]
    assert len(got) == (n if limit is None else min(limit, n))
    raw = np.frombuffer((tmp_path / ("data_batch_1.bin" if split == "train" else
                                     "test_batch.bin")).read_bytes(), np.uint8)
    assert got.labels[0] == raw[0]
    pixel = raw[1 + 2 * 1024 + 5]  # channel 2, row 0, column 5 of record 0
    assert np.isclose(got.images[0, 0, 5, 2],
                      (pixel / 255.0 - cifar.MEAN[2]) / cifar.STD[2], atol=1e-6)


def test_load_cifar10_without_files_is_synthetic(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_DIST_DATA_DIR", str(tmp_path))  # empty
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    got = data.load_cifar10("test", limit=40)
    assert got.synthetic
    _assert_same(got, jax_data.synthetic_cifar10(40, seed=1))


def test_load_cifar10_refuses_a_torn_batch(tmp_path, monkeypatch):
    _write_batches(tmp_path, [2, 2, 2, 2, 2, 2])
    with open(tmp_path / "test_batch.bin", "ab") as f:
        f.write(b"\0" * 10)
    monkeypatch.setenv("TPU_DIST_DATA_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="not a CIFAR-10 binary batch"):
        data.load_cifar10("test")
