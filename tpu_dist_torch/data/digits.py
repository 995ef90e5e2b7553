"""Real handwritten digits without a download: scikit-learn's bundled set
(the port's copy of `tpu_dist.data.digits`).

1,797 genuine 8x8 scans of the UCI optical-recognition digits, upsampled to
the MNIST geometry (28, 28, 1) so the ConvNet trains unmodified.
scikit-learn is imported only when the set is loaded.
"""

from __future__ import annotations

import numpy as np

from tpu_dist_torch.data.mnist import MEAN, STD, Dataset

TRAIN_FRACTION = 0.8
_SPLIT_SEED = 1234  # the reference's seed (train_dist.py:35)


def load_real_digits(split: str = "train") -> Dataset:
    """A deterministic 80/20 split of sklearn's digit scans: 8x8 to 28x28 by
    3x nearest-neighbour upsampling (24x24) and a 2-pixel border, then the
    reference's MNIST normalization; the split's shuffle is seeded, so
    every process computes the same disjoint sets."""
    from sklearn.datasets import load_digits

    bunch = load_digits()
    images = bunch.images.astype(np.float32) / 16.0  # (1797, 8, 8) in [0, 1]
    labels = bunch.target.astype(np.int32)
    up = images.repeat(3, axis=1).repeat(3, axis=2)  # (n, 24, 24)
    up = np.pad(up, ((0, 0), (2, 2), (2, 2)))  # (n, 28, 28)
    imgs = ((up - MEAN) / STD)[..., None].astype(np.float32)
    order = np.random.default_rng(_SPLIT_SEED).permutation(len(imgs))
    n_train = int(len(imgs) * TRAIN_FRACTION)
    idx = order[:n_train] if split == "train" else order[n_train:]
    return Dataset(imgs[idx], labels[idx], synthetic=False)
