"""Distributed synchronous SGD on MNIST: the port's entry point.

    python -m tpu_dist_torch.demos.train_dist --epochs 1
    python -m tpu_dist_torch.demos.train_dist --epochs 2 --ckpt runs/mnist
    torchrun --nproc-per-node 4 -m tpu_dist_torch.demos.train_dist

The reference's train_dist.py: seed 1234, equal-shard partition of MNIST,
global batch 128 (``128 // world`` per rank), the ConvNet, SGD(lr=0.01,
momentum=0.5), per-epoch mean loss printed by every rank, then test
accuracy.  Each process drives one card (``cuda:$LOCAL_RANK``) and joins
the NCCL group from ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``;
``--device cpu`` runs on the CPU over Gloo.  Set ``TPU_DIST_PALLAS_DENSE=1``
to run the dense layers through the fused CUDA kernel.  Real MNIST IDX files
are read from ``$TPU_DIST_DATA_DIR`` when present; otherwise the synthetic
stand-in is generated.  ``--data digits`` trains on real handwriting
(scikit-learn's bundled digit scans).  ``--ckpt DIR`` writes
``ckpt_<epoch>.npz`` after every epoch and, when DIR already holds an
intact checkpoint, resumes from the newest one.
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from tpu_dist_torch import comm, data, models
from tpu_dist_torch.device import resolve_device
from tpu_dist_torch.train import TrainConfig, Trainer, checkpoint


def main(argv: list[str] | None = None):
    """Train, then evaluate; returns ``(trainer, history, test_accuracy)``."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=10, help="reference: 10")
    parser.add_argument("--samples", type=int, default=0,
                        help="cap the dataset size (0 = full 60k)")
    parser.add_argument("--lr", type=float, default=0.01, help="reference: 0.01")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--ckpt", default="",
                        help="checkpoint dir; resumes from the newest intact checkpoint")
    parser.add_argument("--data", default="mnist", choices=("mnist", "digits"),
                        help="mnist, or digits (real bundled handwriting)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    rank, world = comm.init_process_group(device)
    try:
        if args.data == "digits":
            ds = data.load_real_digits("train")
            if args.samples:
                ds = data.Dataset(ds.images[: args.samples], ds.labels[: args.samples])
            about = f"digits (real, {len(ds)} samples)"
        else:
            ds = data.load_mnist("train", synthetic_size=args.samples or None)
            about = f"MNIST ({'synthetic' if ds.synthetic else 'real'}, {len(ds)} samples)"
        if rank == 0:
            print(f"{about} on {world} ranks [{device}]")
        cfg = TrainConfig(epochs=args.epochs, lr=args.lr)
        model = models.mnist_net(torch.Generator().manual_seed(cfg.seed))
        trainer = Trainer(model, cfg, device=device)
        start_epoch = 0
        newest = checkpoint.latest_intact(args.ckpt) if args.ckpt else None
        if newest is not None:
            start_epoch = trainer.restore(newest)
            if rank == 0:
                print(f"resumed from {newest} at epoch {start_epoch}")
        history = trainer.fit(ds, start_epoch=start_epoch, checkpoint_dir=args.ckpt or None)
        if args.data == "digits":
            test = data.load_real_digits("test")
        else:
            test = data.load_mnist(
                "test", synthetic_size=min(10000, len(ds)) if ds.synthetic else None
            )
        accuracy = trainer.evaluate(test)
        if rank == 0:
            print(f"Rank {rank}: test accuracy {accuracy:.4f}")
        return trainer, history, accuracy
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
