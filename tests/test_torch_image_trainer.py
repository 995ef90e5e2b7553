"""The port's Trainer on ResNet-18 against the JAX Trainer: batch-norm state
through steps, accumulation, remat, bfloat16, a Gloo world of 2, the guard
and checkpoints.

Both Trainers start from the JAX init (params and state, converted with
`interop`) and take the same batches of synthetic CIFAR-10 with
cross-entropy, SGD lr 0.05, momentum 0.9, global batch 16.

The trajectories are compared in float64 on both sides (the JAX Trainer
under ``jax.enable_x64``, its loss still in float32 as the Trainer casts
the scores; the port's model in double), where params, momentum and
batch-norm state agree to 1e-7 after three steps (2e-9 measured), and
losses to float32's resolution (2e-7 relative).  In
float32 they cannot agree that closely, in either package: against the
float64 run, float32 gradients of ResNet-18 at batch 16 are off by up to
8 % of their tensor's largest entry on the components that batch norm's
zero-mean backward cancels (both packages alike), and lr 0.05 with
momentum 0.9 grows that tenfold a step.  So the float32 runs, on the
main path's types with the fused head (``TPU_DIST_PALLAS_DENSE=1``, the
JAX kernel in interpret mode, the port's plain version), are held to the
first step at 1e-5 in loss and state and to bounds set from that spread
after it; bfloat16 runs to their own bounds, stated where they are used.
The float64 runs leave the head on the plain product: the kernel takes
16- and 32-bit types.
"""

import jax
import numpy as np
import torch

from tests import torch_image_helpers as h
from tpu_dist import data as jax_data
from tpu_dist import models as jax_models
from tpu_dist import nn as jax_nn
from tpu_dist import parallel as jax_parallel
from tpu_dist import train as jax_train
from tpu_dist.train import checkpoint as jax_ckpt
from tpu_dist_torch import data, interop, models, nn
from tpu_dist_torch.train import TrainConfig, Trainer, checkpoint


def test_float32_steps_with_the_fused_head_match_jax_trainer(monkeypatch):
    """The main path's types: the first step's loss and new state to 1e-5
    and its params to 5e-4 (lr times the float32 gradient spread above:
    9e-5 measured); the third step's loss to 1e-3 relative and the params
    and state after it to 3e-2 (7e-3 and 3e-3 measured), which a wrong
    momentum, a reversed batch-norm momentum or a missing state update
    would each exceed."""
    monkeypatch.setenv("TPU_DIST_PALLAS_DENSE", "1")
    mesh = h.cpu_mesh()
    ref = h.jax_trainer(mesh)
    port = h.port_like(ref)
    batches = h.batches()
    want1, after1 = h.jax_steps(ref, batches[:1], mesh)
    got1 = h.port_steps(port, batches[:1])
    np.testing.assert_allclose(got1, want1, **h.TOL)
    got_params, got_state = interop.module_to_jax(port.model)
    h.close(got_state, after1[1], **h.TOL)
    h.close(got_params, after1[0], atol=5e-4, rtol=0)
    want, (params, state, _) = h.jax_steps(ref, batches[1:], mesh, start=after1)
    got = got1 + h.port_steps(port, batches[1:])
    np.testing.assert_allclose(got, want1 + want, rtol=1e-3)
    got_params, got_state = interop.module_to_jax(port.model)
    h.close(got_params, params, atol=3e-2, rtol=0)
    h.close(got_state, state, atol=3e-2, rtol=0)


def test_evaluate_matches_jax_trainer_evaluate(monkeypatch):
    """The two Trainers' own ``evaluate`` on the same params and state in
    float32 (the ragged set padded alike), after one training step each."""
    monkeypatch.setenv("TPU_DIST_PALLAS_DENSE", "1")
    mesh = h.cpu_mesh()
    ref = h.jax_trainer(mesh)
    port = h.port_like(ref)
    _, (params, state, _) = h.jax_steps(ref, h.batches(16), mesh)
    interop.load_jax(port.model, params, state)
    ref.params, ref.model_state = (jax_parallel.replicate(t, mesh) for t in (params, state))
    want = ref.evaluate(jax_data.synthetic_cifar10(40, seed=1), batch_size=16)
    assert port.evaluate(data.synthetic_cifar10(40, seed=1), batch_size=16) == want


def test_remat_updates_the_statistics_once():
    """The recompute under remat leaves the batch-norm statistics alone:
    a step with remat equals the step without it bit for bit, buffers
    included (updated twice, they would move further)."""
    ref = h.jax_trainer()
    x, y = (torch.from_numpy(a) for a in h.batches()[0])
    trainers = [h.port_like(ref, remat=remat) for remat in (False, True)]
    losses = [t.train_step(x, y) for t in trainers]
    assert torch.equal(losses[0], losses[1])
    want = trainers[0].model.state_dict()
    for name, t in trainers[1].model.state_dict().items():
        assert torch.equal(t, want[name]), name


def test_bfloat16_matches_jax_and_moves_off_float32(monkeypatch):
    """``compute_dtype="bfloat16"``: every convolution and the head see
    bfloat16 inputs, the buffers and masters stay float32.  One step (past
    it the float32 spread grows into the comparison): both packages round
    every activation to bfloat16 at their own places, so the loss agrees to
    1e-2 relative, the new state to 5e-3 and the params to 1e-2 (lr times
    bfloat16-rounded gradients; 9e-4 and 3.8e-3 measured).  Those bounds
    alone would pass a float32 run, and so would "nearer JAX's bfloat16
    step than the float32 port": the two packages' roundings differ from
    each other as much as from float32.  So the cast must move the port's
    loss off its own float32 step by more than ten times the float32
    spread between the packages, and by as much as it moves JAX's, to an
    order of magnitude (0.2 to 1.6 times over three seeds): a port that
    ignored the cast would move it by nothing."""
    monkeypatch.setenv("TPU_DIST_PALLAS_DENSE", "1")
    mesh = h.cpu_mesh()
    ref = h.jax_trainer(mesh, compute_dtype="bfloat16")
    ref32 = h.jax_trainer(mesh)
    port = h.port_like(ref, compute_dtype="bfloat16")
    f32 = h.port_like(ref)
    seen = set()
    for m in port.model.modules():
        if isinstance(m, (nn.Conv2D, nn.Dense)):
            m.register_forward_hook(lambda _m, inputs, _out: seen.add(inputs[0].dtype))
    batch = h.batches(16)
    (want,), (want_params, want_state, _) = h.jax_steps(ref, batch, mesh)
    (want32,), _ = h.jax_steps(ref32, batch, mesh)
    (got,), (got32,) = h.port_steps(port, batch), h.port_steps(f32, batch)
    assert seen == {torch.bfloat16}
    assert all(b.dtype == torch.float32 for b in port.model.buffers())
    assert all(p.dtype == torch.float32 for p in port.model.parameters())
    np.testing.assert_allclose(got, want, rtol=1e-2)
    got_params, got_state = interop.module_to_jax(port.model)
    h.close(got_params, want_params, atol=1e-2, rtol=0)
    h.close(got_state, want_state, atol=5e-3, rtol=0)
    moved, jax_moved = abs(got - got32), abs(want - want32)
    assert moved > 10 * abs(got32 - want32)
    assert 0.1 * jax_moved < moved < 10 * jax_moved


def _equal_trees(got, want):
    got = checkpoint.flatten_with_paths(got)
    want = checkpoint.flatten_with_paths(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def _host(trainer):
    return jax.tree.map(lambda t: np.array(t.detach()), trainer._ckpt_tree())


def test_checkpoints_carry_model_state_across_packages(tmp_path, monkeypatch):
    """A JAX Trainer's file restored by the port, params, batch-norm state
    and momentum bit for bit; then the port's file restored by JAX."""
    monkeypatch.setenv("TPU_DIST_PALLAS_DENSE", "1")
    ref = h.jax_trainer()
    ref.fit(jax_data.synthetic_cifar10(32, seed=7))
    ref.save(tmp_path / "jax.npz", epoch=1)
    port = Trainer(models.resnet18(generator=torch.Generator().manual_seed(3)),
                   TrainConfig(epochs=2, log=h.quiet, **h.CFG), device="cpu",
                   loss=nn.cross_entropy)
    assert port.restore(tmp_path / "jax.npz") == 1
    _equal_trees(_host(port), jax.device_get(ref._ckpt_tree()))
    paths = {k for k, _ in checkpoint.flatten_with_paths(_host(port))}
    assert {"['model_state'][1]['mean']", "['model_state'][3]['bn2']['var']",
            "['model_state'][5]['bn_proj']['mean']"} <= paths

    port.fit(data.synthetic_cifar10(32, seed=3), epochs=1)
    port.save(tmp_path / "port.npz", epoch=1)
    assert jax_ckpt.verify(tmp_path / "port.npz")
    back = h.jax_trainer()
    assert back.restore(tmp_path / "port.npz") == 1
    _equal_trees(jax.device_get(back._ckpt_tree()), _host(port))


def test_vit_trains_through_the_flash_path_as_jax(monkeypatch):
    """A small ViT (depth 2, dim 32, heads 2, image 48, patch 4: 145 tokens)
    under ``TPU_DIST_FLASH=1`` takes the non-causal flash path in both
    Trainers; two steps agree, and its checkpoint tree is the JAX
    Trainer's (a model that is not a Sequential nests by name)."""
    monkeypatch.setenv("TPU_DIST_FLASH", "1")
    monkeypatch.setenv("TPU_DIST_PALLAS_DENSE", "1")
    cfg = dict(image_size=48, patch=4, dim=32, depth=2, heads=2, num_classes=10)
    mesh = h.cpu_mesh()
    ref = jax_train.Trainer(jax_models.ViT(**cfg), (48, 48, 3), mesh,
                            jax_train.TrainConfig(epochs=1, log=h.quiet, **h.CFG),
                            loss=jax_nn.cross_entropy)
    net = models.ViT(**cfg)
    interop.load_jax(net, jax.device_get(ref.params))
    port = Trainer(net, TrainConfig(epochs=1, log=h.quiet, **h.CFG), device="cpu",
                   loss=nn.cross_entropy)
    ds = jax_data.synthetic_images(32, shape=(48, 48, 3), classes=10, seed=2)
    batches = list(jax_data.DistributedLoader(ds, 1, 16, seed=1234).epoch(0))
    want_paths = [k for k, _ in checkpoint.flatten_with_paths(jax.device_get(ref._ckpt_tree()))]
    want_losses, (params, _, opt) = h.jax_steps(ref, batches, mesh)
    got = [port.train_step(torch.from_numpy(x), torch.from_numpy(y)).item() for x, y in batches]
    np.testing.assert_allclose(got, want_losses, **h.TOL)
    h.close(interop.module_to_jax(net)[0], params, **h.TOL)
    got_paths = [k for k, _ in checkpoint.flatten_with_paths(_host(port))]
    assert got_paths == want_paths
    assert "['params']['blocks'][1]['attn']['qkv']['w']" in got_paths
