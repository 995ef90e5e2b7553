"""Image classification at the extended configs: the port's counterpart of
demos/train_image.py (BASELINE configs 4 and 5).

    python -m tpu_dist_torch.demos.train_image
    python -m tpu_dist_torch.demos.train_image --model vit --dataset imagenet --bf16 1
    python -m tpu_dist_torch.demos.train_image --device cpu --samples 512 --epochs 1
    torchrun --nproc-per-node 4 -m tpu_dist_torch.demos.train_image

ResNet-18 (CIFAR stem) or ViT-Ti (patch 16 at 224 px on the ImageNet-shaped
set, patch 4 at 32 px on CIFAR-10), trained by the data-parallel
``Trainer`` with softmax cross-entropy, SGD lr 0.05, momentum 0.9, global
batch ``--batch``; ``--bf16 1`` computes in bfloat16 on float32 masters.
CIFAR-10 is read from ``$TPU_DIST_DATA_DIR`` when its binary batches are
there, otherwise generated (4096 samples by default, a test set of up to
2000); the ImageNet-shaped set is always generated (224 x 224 x 3, 1000
classes; ``--samples``, or 1024, and a test set of up to 256).  Rank 0
prints each epoch's mean loss and samples/s, then the test accuracy.  Each
process drives one card (``cuda:$LOCAL_RANK``) over NCCL; ``--device cpu``
runs on the CPU over Gloo.  ``TPU_DIST_PALLAS_DENSE=1`` runs the heads
through the fused-dense kernel; ``TPU_DIST_FLASH=1`` runs the ViT's
attention through the flash kernels where it is eligible (197 tokens at
224 px; not the 65 at 32 px).
"""

from __future__ import annotations

import argparse
from typing import Callable

import torch
import torch.distributed as dist

from tpu_dist_torch import comm, data, models, nn
from tpu_dist_torch.device import resolve_device
from tpu_dist_torch.train import TrainConfig, Trainer

SEED = 1234  # the init generator's seed, TrainConfig's default seed


def datasets(dataset: str, samples: int):
    """``(train, test, image_size, classes)`` as the JAX demo builds them."""
    if dataset == "imagenet":
        n = samples or 1024
        train = data.synthetic_images(n, shape=(224, 224, 3), classes=1000)
        test = data.synthetic_images(min(256, n), shape=(224, 224, 3), classes=1000, seed=1)
        return train, test, 224, 1000
    if dataset == "cifar10":
        train = data.load_cifar10("train", limit=samples or None)
        test = data.load_cifar10("test", limit=min(2000, len(train)) if train.synthetic else None)
        return train, test, 32, 10
    raise SystemExit(f"unknown --dataset {dataset!r}")


def build_model(name: str, image_size: int, classes: int) -> torch.nn.Module:
    gen = torch.Generator().manual_seed(SEED)
    if name == "resnet18":
        return models.resnet18(num_classes=classes, generator=gen)
    if name == "vit":
        patch = 16 if image_size == 224 else 4
        return models.vit_tiny(image_size=image_size, patch=patch, num_classes=classes,
                               generator=gen)
    raise SystemExit(f"unknown --model {name!r}")


def main(argv: list[str] | None = None, *, log: Callable[[str], None] = print):
    """Train, then evaluate; returns ``(trainer, history, test_accuracy)``.
    Rank 0 prints through ``log``."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="resnet18", help="resnet18 | vit")
    parser.add_argument("--dataset", default="cifar10",
                        help="cifar10 | imagenet (synthetic, 224px)")
    parser.add_argument("--epochs", type=int, default=2, help="training epochs")
    parser.add_argument("--samples", type=int, default=4096, help="cap dataset size (0 = full)")
    parser.add_argument("--batch", type=int, default=128, help="global batch size")
    parser.add_argument("--bf16", type=int, default=0,
                        help="1 = bfloat16 compute, f32 master weights")
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    train, test, image_size, classes = datasets(args.dataset, args.samples)
    model = build_model(args.model, image_size, classes)
    rank, world = comm.init_process_group(device)
    try:
        if rank != 0:
            log = lambda line: None  # noqa: E731
        kind = "synthetic" if train.synthetic else "real"
        log(f"{args.model} on {args.dataset} ({kind}, {len(train)} samples), "
            f"{world} ranks [{device}]{' bf16' if args.bf16 else ''}")
        cfg = TrainConfig(epochs=args.epochs, global_batch=args.batch, lr=0.05, momentum=0.9,
                          compute_dtype="bfloat16" if args.bf16 else None, log=log)
        trainer = Trainer(model, cfg, device=device, loss=nn.cross_entropy)
        history = trainer.fit(train)
        accuracy = trainer.evaluate(test, batch_size=256)
        log(f"Test accuracy: {accuracy:.4f}")
        return trainer, history, accuracy
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
