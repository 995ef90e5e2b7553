"""The port's checkpoints against the JAX package's: either package's file
restores in the other's trainer, digest verified, bit for bit; integrity
(truncation, a flipped byte, a structure mismatch, a writer's error);
resume equal to an uninterrupted run; and a preemption save.

The ConvNet keeps its dropout rates of 0.5 where only the port runs (the
dropout bits are a function of seed, rank and epoch, so a resumed run
draws what an uninterrupted one draws) and sets them to 0 where the
packages are compared.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpu_dist import comm as jax_comm
from tpu_dist import data as jax_data
from tpu_dist import models as jax_models
from tpu_dist import train as jax_train
from tpu_dist.train import checkpoint as jax_ckpt
from tpu_dist_torch import data, models
from tpu_dist_torch.train import LMTrainConfig, LMTrainer, TrainConfig, Trainer, checkpoint

REPO = Path(__file__).resolve().parents[1]
DROPOUT_LAYERS = (4, 10)
LM = dict(vocab=64, dim=32, depth=2, heads=2, max_seq=128, pos_embedding="rope")


def _quiet(_line):
    pass


def _equal_trees(got, want):
    """Two trees of arrays with the same paths and the same bits."""
    got = checkpoint.flatten_with_paths(got)
    want = checkpoint.flatten_with_paths(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _host(trainer):
    """A port trainer's checkpoint tree as numpy arrays in the JAX layout."""
    return jax.tree.map(lambda t: np.array(t.detach()), trainer._ckpt_tree())


@pytest.fixture(scope="module")
def mesh():
    return jax_comm.make_mesh(1, ("data",), platform="cpu")


def _jax_trainer(mesh, **cfg):
    model = jax_models.mnist_net()
    for i in DROPOUT_LAYERS:
        model.layers[i].rate = 0.0
    return jax_train.Trainer(model, jax_models.IN_SHAPE, mesh,
                             jax_train.TrainConfig(epochs=1, log=_quiet, **cfg))


def _port_trainer(seed=0, dropout=False, **cfg):
    net = models.mnist_net(torch.Generator().manual_seed(seed))
    if not dropout:
        for i in DROPOUT_LAYERS:
            net[i].rate = 0.0
    return Trainer(net, TrainConfig(epochs=2, log=_quiet, **cfg), device="cpu")


@pytest.mark.parametrize("guard", [False, True], ids=["plain", "nan_guard"])
def test_trainer_checkpoints_restore_across_packages(mesh, tmp_path, guard):
    cfg = dict(nan_guard=True) if guard else {}
    ds = jax_data.synthetic_mnist(256, seed=7)
    ref = _jax_trainer(mesh, **cfg)
    ref.fit(ds)
    ref.save(tmp_path / "jax.npz", epoch=1)
    assert checkpoint.verify(tmp_path / "jax.npz")
    port = _port_trainer(seed=5, **cfg)
    assert port.restore(tmp_path / "jax.npz") == 1
    _equal_trees(_host(port), jax.device_get(ref._ckpt_tree()))

    port.fit(data.synthetic_mnist(256, seed=3), epochs=1)
    port.save(tmp_path / "port.npz", epoch=1)
    assert jax_ckpt.verify(tmp_path / "port.npz")
    back = _jax_trainer(mesh, **cfg)
    assert back.restore(tmp_path / "port.npz") == 1
    _equal_trees(jax.device_get(back._ckpt_tree()), _host(port))
    paths = [k for k, _ in checkpoint.flatten_with_paths(_host(port))]
    assert "['opt_state']['buf'][0]['w']" in paths or guard
    if guard:
        assert {"['opt_state']['bad_steps']", "['opt_state']['scale']",
                "['opt_state']['inner']['buf'][3]['w']"} <= set(paths)


LM_CONFIGS = {
    "plain": {},
    "grad_clip": dict(grad_clip=0.05),
    "nan_guard": dict(nan_guard=True, grad_clip=0.05),
}


@pytest.mark.parametrize("name", LM_CONFIGS)
def test_lm_trainer_checkpoints_restore_across_packages(mesh, tmp_path, name):
    cfg = dict(epochs=1, global_batch=4, log=_quiet, **LM_CONFIGS[name])
    windows = np.array(jax_models.synthetic_tokens(8, 128, LM["vocab"], seed=2))
    ref = jax_train.LMTrainer(jax_models.TransformerLM(**LM), mesh, jax_train.LMTrainConfig(**cfg))
    ref.fit(windows, checkpoint_dir=str(tmp_path / "jax"))
    path = tmp_path / "jax" / "lm_ckpt_0.npz"
    assert checkpoint.verify(path) and checkpoint.latest_intact(tmp_path / "jax") == path
    port = LMTrainer(models.TransformerLM(**LM, generator=torch.Generator().manual_seed(9)),
                     LMTrainConfig(**cfg), device="cpu")
    assert port.restore(path) == 1
    want = {"params": ref.params, "opt_state": ref.opt_state}
    _equal_trees(_host(port), jax.device_get(want))

    port.fit(windows, checkpoint_dir=str(tmp_path / "port"), start_epoch=1, epochs=2)
    path = tmp_path / "port" / "lm_ckpt_1.npz"
    assert jax_ckpt.verify(path)
    back = jax_train.LMTrainer(jax_models.TransformerLM(**LM), mesh,
                               jax_train.LMTrainConfig(**cfg))
    assert back.restore(path) == 2
    _equal_trees(jax.device_get({"params": back.params, "opt_state": back.opt_state}),
                 _host(port))
    step = "['opt_state']['inner']['step']" if name == "nan_guard" else "['opt_state']['step']"
    assert int(dict(checkpoint.flatten_with_paths(_host(port)))[step]) == 4


def _small_lm_trainer(seed, **cfg):
    lm = models.TransformerLM(vocab=32, dim=16, depth=2, heads=2, max_seq=128,
                              pos_embedding="rope", generator=torch.Generator().manual_seed(seed))
    return LMTrainer(lm, LMTrainConfig(epochs=2, global_batch=4, log=_quiet, **cfg),
                     device="cpu")


def test_truncated_newest_is_skipped_and_a_flipped_byte_fails(tmp_path):
    trainer = _small_lm_trainer(0)
    trainer.fit(models.synthetic_tokens(8, 128, 32), checkpoint_dir=str(tmp_path))
    first, newest = tmp_path / "lm_ckpt_0.npz", tmp_path / "lm_ckpt_1.npz"
    assert checkpoint.latest_intact(tmp_path) == newest
    raw = newest.read_bytes()
    newest.write_bytes(raw[: len(raw) // 2])  # a kill mid-write, by hand
    assert not checkpoint.verify(newest)
    assert checkpoint.latest_intact(tmp_path) == first
    assert jax_ckpt.latest_intact(tmp_path) == first

    raw = bytearray(first.read_bytes())
    raw[len(raw) // 2] ^= 0x40  # one bit inside the archive's leaves
    flipped = tmp_path / "flipped.npz"
    flipped.write_bytes(bytes(raw))
    assert not checkpoint.verify(flipped)
    with pytest.raises(Exception):
        _small_lm_trainer(1).restore(flipped)


def test_flipped_leaf_byte_fails_the_digest(tmp_path):
    """A leaf whose bytes changed under an intact archive: `verify` is
    False and `restore` raises on the checksum."""
    trainer = _small_lm_trainer(0)
    path = tmp_path / "a.npz"
    trainer.save(path, epoch=3)
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}
    arrays["leaf_5"] = arrays["leaf_5"].copy()
    arrays["leaf_5"].reshape(-1)[0] += 1.0
    np.savez(path, **arrays)
    assert not checkpoint.verify(path) and not jax_ckpt.verify(path)
    with pytest.raises(ValueError, match="checksum"):
        _small_lm_trainer(1).restore(path)


def test_structure_mismatch_raises(tmp_path):
    _small_lm_trainer(0).save(tmp_path / "a.npz")
    other = LMTrainer(models.TransformerLM(vocab=32, dim=16, depth=1, heads=2, max_seq=128,
                                           pos_embedding="rope"),
                      LMTrainConfig(log=_quiet), device="cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        other.restore(tmp_path / "a.npz")
    guarded = _small_lm_trainer(0, nan_guard=True)
    with pytest.raises(ValueError, match="structure mismatch"):
        guarded.restore(tmp_path / "a.npz")


def test_async_checkpointer_reraises_the_writers_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    writer = checkpoint.AsyncCheckpointer()
    writer.save(blocker / "sub" / "a.npz", {"x": torch.ones(3)})
    with pytest.raises(OSError):
        writer.wait()
    writer.wait()  # the error is raised once
    with checkpoint.AsyncCheckpointer() as w:
        w.save(tmp_path / "b.npz", {"x": torch.arange(3.0)}, step=7)
    assert checkpoint.restore(tmp_path / "b.npz", {"x": 0})[1] == 7


def test_async_snapshot_is_taken_before_the_next_update(tmp_path):
    """The leaves are copied when ``save`` returns: an in-place update of
    the tensor afterwards does not reach the file."""
    x = torch.zeros(1000)
    with checkpoint.AsyncCheckpointer() as w:
        w.save(tmp_path / "a.npz", {"x": x})
        x.add_(1.0)
    got, _ = checkpoint.restore(tmp_path / "a.npz", {"x": 0})
    np.testing.assert_array_equal(got["x"], np.zeros(1000, np.float32))


def test_trainer_resume_equals_uninterrupted_run(tmp_path):
    ds = data.synthetic_mnist(384, seed=7)
    whole = _port_trainer(dropout=True)
    want = whole.fit(ds)
    first = _port_trainer(dropout=True)
    first.fit(ds, epochs=1, checkpoint_dir=str(tmp_path))
    resumed = _port_trainer(seed=42, dropout=True)
    start = resumed.restore(checkpoint.latest_intact(tmp_path))
    assert start == 1
    (got,) = resumed.fit(ds, start_epoch=start)
    assert got.epoch == 1 and got.mean_loss == want[1].mean_loss
    for name, t in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[name], t), name
    _equal_trees(_host(resumed), _host(whole))


def test_lm_trainer_resume_equals_uninterrupted_run(tmp_path):
    windows = models.synthetic_tokens(8, 128, 32, seed=4)
    cfg = dict(nan_guard=True, loss_scale=2.0**8, grad_clip=1.0, accum_steps=2)
    whole = _small_lm_trainer(0, **cfg)
    want = whole.fit(windows)
    first = _small_lm_trainer(0, **cfg)
    first.fit(windows, epochs=1, checkpoint_dir=str(tmp_path))
    resumed = _small_lm_trainer(7, **cfg)
    assert resumed.restore(tmp_path / "lm_ckpt_0.npz") == 1
    (got,) = resumed.fit(windows, start_epoch=1)
    assert got.mean_loss == want[1].mean_loss
    _equal_trees(_host(resumed), _host(whole))


_PREEMPT = """
import json, os, signal, sys
import torch
from tpu_dist_torch import data, models
from tpu_dist_torch.train import LMTrainConfig, LMTrainer, TrainConfig, Trainer

out, kind = sys.argv[1], sys.argv[2]

def log(line):
    if line.startswith("epoch 0") or ", epoch 0:" in line:
        os.kill(os.getpid(), signal.SIGTERM)

if kind == "lm":
    lm = models.TransformerLM(vocab=32, dim=16, depth=1, heads=2, max_seq=16,
                              generator=torch.Generator().manual_seed(0))
    trainer = LMTrainer(lm, LMTrainConfig(epochs=4, global_batch=8, log=log), device="cpu")
    hist = trainer.fit(models.synthetic_tokens(32, 16, 32), checkpoint_dir=out)
else:
    trainer = Trainer(models.mnist_net(torch.Generator().manual_seed(0)),
                      TrainConfig(epochs=4, global_batch=64, log=log), device="cpu")
    hist = trainer.fit(data.synthetic_mnist(192, seed=1), checkpoint_dir=out)
print(json.dumps([h.epoch for h in hist]))
"""


@pytest.mark.parametrize("kind", ["lm", "mnist"])
def test_sigterm_writes_a_preemption_checkpoint_and_stops(tmp_path, kind):
    """SIGTERM while epoch 1 runs: the process stops cleanly after that
    step, with ``*ckpt_0.npz`` (step 1) and ``*ckpt_preempt.npz`` (step 1,
    the interrupted epoch); ``latest_intact`` picks the preemption file and
    ``restore`` hands back epoch 1."""
    run = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_PREEMPT), str(tmp_path), kind],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=180,
    )
    assert run.returncode == 0, run.stderr
    assert json.loads(run.stdout.strip().splitlines()[-1]) == [0]
    prefix = "lm_ckpt" if kind == "lm" else "ckpt"
    preempt = tmp_path / f"{prefix}_preempt.npz"
    assert checkpoint.verify(preempt) and jax_ckpt.verify(preempt)
    assert not (tmp_path / f"{prefix}_1.npz").exists()
    assert checkpoint.latest_intact(tmp_path) == preempt
    if kind == "lm":
        lm = models.TransformerLM(vocab=32, dim=16, depth=1, heads=2, max_seq=16)
        trainer = LMTrainer(lm, LMTrainConfig(log=_quiet), device="cpu")
    else:
        trainer = Trainer(models.mnist_net(), TrainConfig(log=_quiet), device="cpu")
    assert trainer.restore(preempt) == 1
