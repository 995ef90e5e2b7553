"""Shared set-up of the image-trainer parity tests: the JAX Trainer and the
port's Trainer on ResNet-18 from the same params and state, the batches of
synthetic CIFAR-10, and tree comparisons.  test_torch_image_trainer.py
says which tolerance holds where, and why."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpu_dist import comm as jax_comm
from tpu_dist import data as jax_data
from tpu_dist import models as jax_models
from tpu_dist import nn as jax_nn
from tpu_dist import parallel as jax_parallel
from tpu_dist import train as jax_train
from tpu_dist_torch import data, interop, models, nn
from tpu_dist_torch.train import TrainConfig, Trainer

TOL = dict(atol=1e-5, rtol=0)  # float32, one step
TOL64 = dict(atol=1e-7, rtol=0)
LOSS64 = dict(atol=0, rtol=2e-7)  # the JAX Trainer's loss is float32
CFG = dict(global_batch=16, lr=0.05, momentum=0.9)
IN_SHAPE = (32, 32, 3)


def quiet(_line):
    pass


def cpu_mesh(n=1):
    return jax_comm.make_mesh(n, ("data",), platform="cpu")


def jax_trainer(mesh=None, **cfg):
    return jax_train.Trainer(jax_models.resnet18(), IN_SHAPE, mesh or cpu_mesh(),
                             jax_train.TrainConfig(epochs=1, log=quiet, **{**CFG, **cfg}),
                             loss=jax_nn.cross_entropy)


def net_like(ref, dtype=torch.float32):
    net = models.resnet18()
    interop.load_jax(net, jax.device_get(ref.params), jax.device_get(ref.model_state))
    return net.to(dtype)


def port_like(ref, dtype=torch.float32, **cfg):
    """A port Trainer holding the JAX Trainer's params and state."""
    return Trainer(net_like(ref, dtype), TrainConfig(epochs=1, log=quiet, **{**CFG, **cfg}),
                   device="cpu", loss=nn.cross_entropy)


def to64(tree):
    return jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        jax.device_get(tree))


def pair64(mesh, monkeypatch, **cfg):
    """Inside ``jax.enable_x64``: a JAX Trainer whose params, state and
    optimizer state are float64, and the port's Trainer in double."""
    monkeypatch.setenv("TPU_DIST_PALLAS_DENSE", "0")
    ref = jax_trainer(mesh, **cfg)
    port = port_like(ref, torch.float64, **cfg)
    ref.params, ref.model_state, ref.opt_state = (
        jax_parallel.replicate(to64(t), mesh) for t in (ref.params, ref.model_state,
                                                         ref.opt_state))
    return ref, port


def batches(n=48, seed=7, dtype=np.float32, crop=32):
    """The global batches of epoch 0 of synthetic CIFAR-10, images cut to
    their top-left ``crop`` x ``crop`` pixels (the float64 runs take 16: a
    quarter of the work, the same computation)."""
    ds = jax_data.synthetic_cifar10(n, seed=seed)
    return [(x[:, :crop, :crop].astype(dtype), y) for x, y in
            jax_data.DistributedLoader(ds, 1, CFG["global_batch"], seed=1234).epoch(0)]


def cifar(n, seed, dtype=np.float32, *, jax_side=False, crop=32):
    ds = (jax_data if jax_side else data).synthetic_cifar10(n, seed=seed)
    return type(ds)(ds.images[:, :crop, :crop].astype(dtype), ds.labels, synthetic=True)


def close(got, want, **tol):
    got_leaves, got_def = jax.tree.flatten(got)
    want_leaves, want_def = jax.tree.flatten(want)
    assert got_def == want_def
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def momentum(port):
    bufs = {name: port.optimizer.state[p]["momentum_buffer"]
            for name, p in port.model.named_parameters()}
    return interop.params_to_jax(bufs, len(port.model))


def jax_steps(ref, batches, mesh, start=None):
    """The JAX Trainer's step on each batch, from its own state or from
    ``start`` (host trees of params, state and optimizer state); the losses
    and the final trees on the host."""
    if start is None:
        params, state, opt = ref.params, ref.model_state, ref.opt_state
    else:
        params, state, opt = (jax_parallel.replicate(t, mesh) for t in start)
    losses = []
    for x, y in batches:
        params, state, opt, loss, _ = ref.step(
            params, state, opt, jax_parallel.shard_batch((x, y), mesh), jax.random.key(0))
        losses.append(float(loss))
    return losses, jax.device_get((params, state, opt))


def port_steps(port, batches):
    return [port.train_step(torch.from_numpy(x), torch.from_numpy(y)).item()
            for x, y in batches]
