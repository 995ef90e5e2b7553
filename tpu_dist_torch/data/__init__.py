"""`tpu_dist_torch.data` — MNIST, CIFAR-10 and ImageNet-shaped images, real
digits, byte text, partitioning and loaders."""

from tpu_dist_torch.data.cifar import load_cifar10, synthetic_cifar10, synthetic_images
from tpu_dist_torch.data.digits import load_real_digits
from tpu_dist_torch.data.loader import DistributedLoader, HostLoader, Loader
from tpu_dist_torch.data.mnist import (
    Dataset,
    load_idx_images,
    load_idx_labels,
    load_mnist,
    synthetic_mnist,
)
from tpu_dist_torch.data.partition import DataPartitioner, Partition, equal_shards
from tpu_dist_torch.data.text import VOCAB as TEXT_VOCAB
from tpu_dist_torch.data.text import TextCorpus, load_text

__all__ = [
    "DataPartitioner",
    "Dataset",
    "DistributedLoader",
    "HostLoader",
    "Loader",
    "Partition",
    "TEXT_VOCAB",
    "TextCorpus",
    "equal_shards",
    "load_cifar10",
    "load_idx_images",
    "load_idx_labels",
    "load_mnist",
    "load_real_digits",
    "load_text",
    "synthetic_cifar10",
    "synthetic_images",
    "synthetic_mnist",
]
