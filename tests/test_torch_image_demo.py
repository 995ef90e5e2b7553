"""The port's ``train_image`` demo against the JAX demo's computation, and its
command line on the CPU.

``tpu_dist_torch.demos.train_image`` at ``--samples 96 --batch 32 --epochs
1`` (3 steps of ResNet-18 on synthetic CIFAR-10) against the JAX Trainer
built as demos/train_image.py builds it (cross-entropy, lr 0.05, momentum
0.9), started from the port demo's init converted with `interop`, on the
JAX package's data: the epoch's mean loss to 1e-3 relative, the float32
spread of three ResNet-18 steps (test_torch_image_trainer.py), and the test
accuracy to within 3 of the 96 test samples for the same reason.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_dist import comm as jax_comm
from tpu_dist import data as jax_data
from tpu_dist import models as jax_models
from tpu_dist import nn as jax_nn
from tpu_dist import parallel as jax_parallel
from tpu_dist import train as jax_train
from tpu_dist_torch import interop
from tpu_dist_torch.demos import train_image

REPO = Path(__file__).resolve().parents[1]


# The rendezvous variables the port's init reads: a world of one here,
# whatever another test in this process left behind.
RENDEZVOUS_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                  "LOCAL_WORLD_SIZE", "TPU_DIST_INIT_METHOD", "TORCHELASTIC_USE_AGENT_STORE",
                  "TORCHELASTIC_RESTART_COUNT")


@pytest.fixture(autouse=True)
def _world_of_one(monkeypatch):
    for var in RENDEZVOUS_ENV:
        monkeypatch.delenv(var, raising=False)


def test_demo_matches_jax_demo_computation(monkeypatch):
    monkeypatch.setenv("TPU_DIST_PALLAS_DENSE", "1")
    lines = []
    trainer, (got,), acc = train_image.main(
        ["--device", "cpu", "--samples", "96", "--batch", "32", "--epochs", "1"],
        log=lines.append)
    assert lines[0] == "resnet18 on cifar10 (synthetic, 96 samples), 1 ranks [cpu]"
    assert lines[-1] == f"Test accuracy: {acc:.4f}"

    mesh = jax_comm.make_mesh(1, ("data",), platform="cpu")
    ref = jax_train.Trainer(
        jax_models.resnet18(num_classes=10), (32, 32, 3), mesh,
        jax_train.TrainConfig(epochs=1, global_batch=32, lr=0.05, momentum=0.9,
                              log=lambda line: None),
        loss=jax_nn.cross_entropy)
    init = train_image.build_model("resnet18", 32, 10)
    params, state = interop.module_to_jax(init)
    ref.params, ref.model_state = (jax_parallel.replicate(t, mesh) for t in (params, state))
    train = jax_data.load_cifar10("train", limit=96)
    (want,) = ref.fit(train)
    want_acc = ref.evaluate(jax_data.load_cifar10("test", limit=96), batch_size=256)
    np.testing.assert_allclose(got.mean_loss, want.mean_loss, rtol=1e-3)
    assert abs(acc - want_acc) <= 3 / 96
    assert got.samples_per_sec > 0


def test_vit_on_imagenet_shaped_data_through_flash(monkeypatch):
    """ViT-Ti/16 at 224 px, the 197-token non-causal attention through the
    flash path's plain versions on the CPU: the demo runs, its loss is
    finite, and its accuracy is a share of the 8 test samples."""
    monkeypatch.setenv("TPU_DIST_FLASH", "1")
    monkeypatch.setenv("TPU_DIST_PALLAS_DENSE", "1")
    import importlib

    fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")
    calls = []
    real = fa.flash_fwd_reference
    monkeypatch.setattr(fa, "flash_fwd_reference",
                        lambda q, *a, **k: calls.append((tuple(q.shape), k)) or real(q, *a, **k))
    lines = []
    trainer, (stats,), acc = train_image.main(
        ["--device", "cpu", "--model", "vit", "--dataset", "imagenet", "--samples", "8",
         "--batch", "8", "--epochs", "1"], log=lines.append)
    assert lines[0] == "vit on imagenet (synthetic, 8 samples), 1 ranks [cpu]"
    assert trainer.model.num_tokens == 197
    assert np.isfinite(stats.mean_loss)
    assert acc * 8 == round(acc * 8)
    # 12 blocks in the training step and 12 in evaluation, each (8 * 3, 197, 64)
    assert calls == [((24, 197, 64), dict(causal=False, window=None))] * 24


def test_demo_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_image.main(["--samples", "64"])
    with pytest.raises(SystemExit, match="unknown --model"):
        train_image.main(["--device", "cpu", "--model", "vgg", "--samples", "64"])


def test_command_line_on_the_cpu():
    run = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.demos.train_image", "--device", "cpu",
         "--samples", "64", "--batch", "32", "--epochs", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stderr
    lines = run.stdout.splitlines()
    assert "resnet18 on cifar10 (synthetic, 64 samples), 1 ranks [cpu]" in lines
    epochs = [line for line in lines if line.startswith("Rank 0 of 1, epoch")]
    assert len(epochs) == 2
    assert lines[-1].startswith("Test accuracy: ")
