"""CIFAR-10 and the ImageNet-shaped stand-in, as `tpu_dist.data.cifar`.

A copy of the JAX package's numpy code, giving the same arrays bit for
bit: NHWC float32 images normalized per channel, int32 labels.
`load_cifar10` reads the standard binary batches (``data_batch_*.bin``,
``test_batch.bin``: records of 1 label byte and 3072 channel-major pixel
bytes) from ``$TPU_DIST_DATA_DIR``, ``data/cifar10``,
``data/cifar-10-batches-bin`` or ``~/data/cifar10``; without them it
generates the deterministic synthetic set.  `synthetic_images` is the
ImageNet-shaped set of BASELINE config 5 (224 x 224 x 3, 1000 classes).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from tpu_dist_torch.data.mnist import Dataset

MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
STD = np.array([0.2470, 0.2435, 0.2616], np.float32)


def _search_dirs() -> tuple[str, ...]:
    return (
        os.environ.get("TPU_DIST_DATA_DIR", ""),
        "data/cifar10",
        "data/cifar-10-batches-bin",
        os.path.expanduser("~/data/cifar10"),
    )


def _parse_bin(path: Path) -> tuple[np.ndarray, np.ndarray]:
    raw = np.frombuffer(path.read_bytes(), np.uint8)
    rec = 1 + 3072
    if raw.size % rec:
        raise ValueError(f"{path}: not a CIFAR-10 binary batch (size {raw.size})")
    raw = raw.reshape(-1, rec)
    labels = raw[:, 0].astype(np.int32)
    # channel-major (3, 32, 32) -> NHWC
    imgs = raw[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return imgs, labels


def _normalize(imgs_u8: np.ndarray) -> np.ndarray:
    return (imgs_u8.astype(np.float32) / 255.0 - MEAN) / STD


def synthetic_cifar10(n: int, *, seed: int = 0) -> Dataset:
    """Deterministic CIFAR-shaped stand-in: each class a fixed smooth
    random template (seed 4242, shared by train and test), each sample its
    template plus Gaussian noise drawn from ``seed``."""
    trng = np.random.default_rng(4242)
    low = trng.normal(size=(10, 8, 8, 3))
    templates = low.repeat(4, axis=1).repeat(4, axis=2)
    templates = (templates - templates.min()) / (np.ptp(templates) + 1e-9)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    noise = rng.normal(scale=0.25, size=(n, 32, 32, 3))
    imgs = np.clip(templates[labels] + noise, 0.0, 1.0)
    return Dataset(_normalize((imgs * 255).astype(np.uint8)), labels, synthetic=True)


def synthetic_images(
    n: int,
    *,
    shape: tuple[int, int, int] = (224, 224, 3),
    classes: int = 1000,
    seed: int = 0,
) -> Dataset:
    """Deterministic image-classification stand-in at any resolution that
    divides by 8 and any class count: fixed class templates (seed 777)
    upsampled 8x per sample, plus noise drawn from ``seed``.  The loop over
    samples keeps memory to one template at a time; at 224 px it takes
    seconds per thousand samples, so build a set once per run."""
    h, w, c = shape
    if h % 8 or w % 8:
        raise ValueError(f"image dims {shape} must be multiples of 8")
    trng = np.random.default_rng(777)
    low = trng.normal(size=(classes, h // 8, w // 8, c)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, size=n).astype(np.int32)
    imgs = np.empty((n, h, w, c), np.float32)
    for i in range(n):
        t = low[labels[i]].repeat(8, axis=0).repeat(8, axis=1)
        t = (t - t.min()) / (np.ptp(t) + 1e-9)
        imgs[i] = np.clip(t + rng.normal(scale=0.25, size=(h, w, c)), 0.0, 1.0)
    return Dataset(imgs, labels, synthetic=True)


def load_cifar10(split: str = "train", *, limit: int | None = None) -> Dataset:
    """The ``split`` ("train" or "test") from the first search directory
    that holds all of its binary batches, at most ``limit`` records (files
    past the limit are not parsed); else the synthetic set of ``limit``
    samples (default 50,000 train, 10,000 test; seed 0 train, 1 test)."""
    files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if split == "train"
             else ["test_batch.bin"])
    for d in _search_dirs():
        if not d:
            continue
        paths = [Path(d) / f for f in files]
        if all(p.exists() for p in paths):
            img_parts, label_parts, have = [], [], 0
            for p in paths:
                imgs, labels = _parse_bin(p)
                img_parts.append(imgs)
                label_parts.append(labels)
                have += len(labels)
                if limit is not None and have >= limit:
                    break
            imgs = np.concatenate(img_parts)[:limit]
            labels = np.concatenate(label_parts)[:limit]
            return Dataset(_normalize(imgs), labels)
    n = limit if limit is not None else (50000 if split == "train" else 10000)
    return synthetic_cifar10(n, seed=0 if split == "train" else 1)
