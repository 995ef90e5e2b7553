"""The port's Trainer against the JAX Trainer, and world 2 against world 1.

Both Trainers start from the same params (JAX init, converted with
`interop`), dropout rates 0, ``TPU_DIST_PALLAS_DENSE=1`` (the JAX kernel in
interpret mode, the port's plain version on the CPU), and take the same
batches.  Losses, params and momentum buffers agree to 1e-5.  The world-2
run is two processes over Gloo, held to one process stepping on the same
global batches.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests import torch_collective_workers as workers
from tpu_dist import comm as jax_comm
from tpu_dist import data as jax_data
from tpu_dist import models as jax_models
from tpu_dist import parallel as jax_parallel
from tpu_dist import train as jax_train
from tpu_dist_torch import comm, data, interop, models
from tpu_dist_torch.comm import init as comm_init
from tpu_dist_torch.train import TrainConfig, Trainer

REPO = Path(__file__).resolve().parents[1]
DROPOUT_LAYERS = (4, 10)  # Dropout2D and Dropout in both Sequentials
TOL = dict(atol=1e-5, rtol=0)


def _quiet(_line):
    pass


@pytest.fixture
def pair(monkeypatch):
    """A JAX Trainer on a one-device CPU mesh and a port Trainer on the CPU,
    same params, dropout off."""
    monkeypatch.setenv("TPU_DIST_PALLAS_DENSE", "1")
    jax_model = jax_models.mnist_net()
    for i in DROPOUT_LAYERS:
        jax_model.layers[i].rate = 0.0
    mesh = jax_comm.make_mesh(1, ("data",), platform="cpu")
    ref = jax_train.Trainer(
        jax_model, jax_models.IN_SHAPE, mesh,
        jax_train.TrainConfig(epochs=1, log=_quiet),
    )
    net = models.mnist_net()
    for i in DROPOUT_LAYERS:
        net[i].rate = 0.0
    net.load_state_dict(interop.params_from_jax(jax.device_get(ref.params)))
    port = Trainer(net, TrainConfig(epochs=1, log=_quiet), device="cpu")
    return ref, port, mesh


def _port_params(trainer):
    return interop.params_to_jax(trainer.model.state_dict(), len(trainer.model))


def _port_momentum(trainer):
    bufs = {
        name: trainer.optimizer.state[p]["momentum_buffer"]
        for name, p in trainer.model.named_parameters()
    }
    return interop.params_to_jax(bufs, len(trainer.model))


def _assert_trees_close(got, want):
    for layer_got, layer_want in zip(got, want, strict=True):
        assert layer_got.keys() == layer_want.keys()
        for name in layer_want:
            np.testing.assert_allclose(layer_got[name], layer_want[name], **TOL)


def test_three_steps_match_jax_trainer(pair):
    ref, port, mesh = pair
    ds = jax_data.synthetic_mnist(384, seed=7)
    batches = list(jax_data.DistributedLoader(ds, 1, 128, seed=1234).epoch(0))
    assert len(batches) == 3
    params, model_state, opt_state = ref.params, ref.model_state, ref.opt_state
    for x, y in batches:
        params, model_state, opt_state, want, _ = ref.step(
            params, model_state, opt_state,
            jax_parallel.shard_batch((x, y), mesh), jax.random.key(0),
        )
        got = port.train_step(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(got.item(), float(want), **TOL)
    _assert_trees_close(_port_params(port), jax.device_get(params))
    _assert_trees_close(_port_momentum(port), jax.device_get(opt_state)["buf"])


def test_fit_epoch_loss_matches_jax_trainer(pair):
    ref, port, _ = pair
    want = ref.fit(jax_data.synthetic_mnist(384, seed=7))
    got = port.fit(data.synthetic_mnist(384, seed=7))
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0].mean_loss, want[0].mean_loss, **TOL)
    assert got[0].samples_per_sec > 0
    _assert_trees_close(_port_params(port), jax.device_get(ref.params))


def test_evaluate_matches_jax_trainer_on_ragged_set(pair):
    ref, port, _ = pair
    ref.fit(jax_data.synthetic_mnist(256, seed=7))
    port.fit(data.synthetic_mnist(256, seed=7))
    test = data.synthetic_mnist(300, seed=1)  # 128 + 128 + a padded 44
    want = ref.evaluate(jax_data.synthetic_mnist(300, seed=1), batch_size=128)
    got = port.evaluate(test, batch_size=128)
    assert got == want


def test_fit_refuses_too_little_data():
    trainer = Trainer(models.mnist_net(), TrainConfig(log=_quiet), device="cpu")
    with pytest.raises(ValueError, match="zero steps"):
        trainer.fit(data.synthetic_mnist(64))


def test_port_sgd_has_torch_momentum_semantics():
    """buf = m*buf + g; p -= lr*buf (no dampening): two steps by hand, as
    tests/test_data_parallel.py pins the JAX optimizer."""
    from tpu_dist_torch.train import sgd

    p = torch.nn.Parameter(torch.tensor([1.0]))
    opt = sgd([p], 0.5, momentum=0.5)
    for want in (0.5, -0.25):
        p.grad = torch.tensor([1.0])
        opt.step()
        torch.testing.assert_close(p.detach(), torch.tensor([want]))


_WORKER = """
import sys
import torch
from tpu_dist_torch import comm, data, models
from tpu_dist_torch.train import TrainConfig, Trainer

rank, world = comm.init_process_group(torch.device("cpu"))
# rank 1 builds from another seed: the Trainer makes the replicas equal
net = models.mnist_net(torch.Generator().manual_seed(0 if rank == 0 else 99))
for i in (4, 10):
    net[i].rate = 0.0
trainer = Trainer(net, TrainConfig(epochs=1, log=lambda line: None), device="cpu")
(stats,) = trainer.fit(data.synthetic_mnist(256, seed=7))
torch.save({"loss": stats.mean_loss, "state": trainer.model.state_dict(),
            "world": world}, sys.argv[1])
torch.distributed.destroy_process_group()
"""


def test_gloo_world_two_matches_world_one(tmp_path, monkeypatch):
    """Two processes, 64 samples each per step, 2 steps, against one
    process stepping on the same 128-sample global batches; rank 1 built
    its model from another seed, and the Trainer's broadcast from rank 0
    makes it rank 0's."""
    monkeypatch.setenv("TPU_DIST_PALLAS_DENSE", "1")
    store = comm_init.host_store()  # held here, so no other process can take its port
    env = dict(os.environ, **comm_init.launcher_env(store, "localhost", 2),
               PYTHONPATH=str(REPO))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp_path / f"rank{r}.pt")],
            env=dict(env, RANK=str(r)), cwd=REPO,
        )
        for r in range(2)
    ]
    try:
        codes = [p.wait(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert codes == [0, 0]
    out = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    assert out[0]["world"] == out[1]["world"] == 2

    net = models.mnist_net(torch.Generator().manual_seed(0))
    for i in DROPOUT_LAYERS:
        net[i].rate = 0.0
    single = Trainer(net, TrainConfig(log=_quiet), device="cpu")
    ds = data.synthetic_mnist(256, seed=7)
    shards = [data.DistributedLoader(ds, 2, 128, rank=r).epoch(0) for r in range(2)]
    losses = []
    for (x0, y0), (x1, y1) in zip(*shards):
        x, y = np.concatenate([x0, x1]), np.concatenate([y0, y1])
        losses.append(single.train_step(torch.from_numpy(x), torch.from_numpy(y)).item())
    assert len(losses) == 2
    for rank_out in out:
        np.testing.assert_allclose(rank_out["loss"], np.mean(losses), **TOL)
        for name, want in single.model.state_dict().items():
            torch.testing.assert_close(rank_out["state"][name], want, atol=1e-5, rtol=0)


def test_ring_reduce_at_world_two_matches_jax_trainer_and_psum():
    """``grad_reduce="ring"``: the port's Trainer at Gloo world 2 (the
    chunked ring per tensor, the loss included) against the JAX Trainer's
    ring on a 2-device CPU mesh over 3 steps, same params and batches,
    within the tolerance of test_three_steps_match_jax_trainer; and the
    port's ring run equal to its psum run bit for bit (at world 2 each sum
    is a + b, and both paths divide by 2)."""
    N_LAYERS = len(models.mnist_net())
    jax_model = jax_models.mnist_net()
    for i in DROPOUT_LAYERS:
        jax_model.layers[i].rate = 0.0
    mesh = jax_comm.make_mesh(2, ("data",), platform="cpu")
    ref = jax_train.Trainer(jax_model, jax_models.IN_SHAPE, mesh,
                            jax_train.TrainConfig(epochs=1, grad_reduce="ring", log=_quiet))
    state = interop.params_from_jax(jax.device_get(ref.params))
    ds = jax_data.synthetic_mnist(384, seed=7)
    batches = list(jax_data.DistributedLoader(ds, 1, 128, seed=1234).epoch(0))
    assert len(batches) == 3
    params, model_state, opt_state = ref.params, ref.model_state, ref.opt_state
    want_losses = []
    for x, y in batches:
        params, model_state, opt_state, loss, _ = ref.step(
            params, model_state, opt_state,
            jax_parallel.shard_batch((x, y), mesh), jax.random.key(0))
        want_losses.append(float(loss))

    out = comm.spmd(workers.trainer_steps, state, batches, ("ring", "psum"), world=2,
                    device="cpu", timeout=240)
    ring, psum = out["ring"], out["psum"]
    for r in range(2):
        np.testing.assert_allclose(ring["losses"][r].numpy(), want_losses, **TOL)
        _assert_trees_close(
            interop.params_to_jax({k: v[r] for k, v in ring["params"].items()}, N_LAYERS),
            jax.device_get(params))
        _assert_trees_close(
            interop.params_to_jax({k: v[r] for k, v in ring["momentum"].items()}, N_LAYERS),
            jax.device_get(opt_state)["buf"])
    for what in ("losses", "params", "momentum"):
        got, want = ring[what], psum[what]
        for key in (got if isinstance(got, dict) else [None]):
            a, b = (got, want) if key is None else (got[key], want[key])
            assert torch.equal(a, b), (what, key)
            assert torch.equal(a[0], a[1]), (what, key)  # both ranks hold the same bits


# ------------------------------------------ accumulation, compute type, remat


def _jax_pair(monkeypatch, **cfg):
    """A JAX Trainer and a port Trainer with ``cfg``, same params, dropout
    off, TPU_DIST_PALLAS_DENSE=1."""
    monkeypatch.setenv("TPU_DIST_PALLAS_DENSE", "1")
    jax_model = jax_models.mnist_net()
    for i in DROPOUT_LAYERS:
        jax_model.layers[i].rate = 0.0
    mesh = jax_comm.make_mesh(1, ("data",), platform="cpu")
    ref = jax_train.Trainer(jax_model, jax_models.IN_SHAPE, mesh,
                            jax_train.TrainConfig(epochs=1, log=_quiet, **cfg))
    return ref, Trainer(_net_like(ref), TrainConfig(epochs=1, log=_quiet, **cfg), device="cpu")


def _net_like(ref):
    """The port's ConvNet holding the JAX Trainer's params, dropout off."""
    net = models.mnist_net()
    for i in DROPOUT_LAYERS:
        net[i].rate = 0.0
    net.load_state_dict(interop.params_from_jax(jax.device_get(ref.params)))
    return net


@pytest.mark.parametrize("cfg", [dict(accum_steps=2), dict(remat=True),
                                 dict(compute_dtype="bfloat16")],
                         ids=["accum2", "remat", "bfloat16"])
def test_trainer_options_match_jax_trainer(monkeypatch, cfg):
    """One epoch of 3 steps with each option against the JAX Trainer with
    the same option.  bfloat16 rounds every activation in both packages,
    each at its own places, so its loss agrees to 1e-2 relative and its
    params to 1e-3; the others as test_three_steps_match_jax_trainer.
    Those bounds would also pass a float32 run, so for bfloat16 every
    layer with parameters must see bfloat16 inputs, and the port's loss
    must lie nearer JAX's bfloat16 loss than the same port run in float32
    does."""
    ref, port = _jax_pair(monkeypatch, **cfg)
    seen = set()
    for layer in port.model:
        if any(True for _ in layer.parameters()):
            layer.register_forward_hook(lambda _m, inputs, _out: seen.add(inputs[0].dtype))
    want = ref.fit(jax_data.synthetic_mnist(384, seed=7))
    got = port.fit(data.synthetic_mnist(384, seed=7))
    tol = dict(rtol=1e-2, atol=0) if "compute_dtype" in cfg else TOL
    np.testing.assert_allclose(got[0].mean_loss, want[0].mean_loss, **tol)
    if "compute_dtype" in cfg:
        for a, b in zip(_port_params(port), jax.device_get(ref.params)):
            for name in b:
                np.testing.assert_allclose(a[name], b[name], atol=1e-3, rtol=0)
        assert seen == {torch.bfloat16}
        f32 = Trainer(_net_like(ref), TrainConfig(epochs=1, log=_quiet), device="cpu")
        (got32,) = f32.fit(data.synthetic_mnist(384, seed=7))
        assert (abs(got[0].mean_loss - want[0].mean_loss)
                < abs(got32.mean_loss - want[0].mean_loss))
    else:
        assert seen == {torch.float32}
        _assert_trees_close(_port_params(port), jax.device_get(ref.params))
    assert all(p.dtype == torch.float32 for p in port.model.parameters())


@pytest.mark.parametrize("k", [2, 4])
def test_accumulated_step_equals_one_step(k):
    """accum_steps=k on the same 128-sample batch as accum_steps=1: the
    same loss and the same updated params, up to float32 sums taken in
    another order."""
    x, y = (torch.from_numpy(a) for a in data.synthetic_mnist(128, seed=2)[:])
    trainers = []
    for accum in (1, k):
        net = models.mnist_net(torch.Generator().manual_seed(0))
        for i in DROPOUT_LAYERS:
            net[i].rate = 0.0
        trainers.append(Trainer(net, TrainConfig(accum_steps=accum, log=_quiet), device="cpu"))
    losses = [t.train_step(x, y).item() for t in trainers]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    for name, want in trainers[0].model.state_dict().items():
        torch.testing.assert_close(trainers[1].model.state_dict()[name], want,
                                   atol=1e-6, rtol=0)


def test_indivisible_local_batch_is_refused():
    trainer = Trainer(models.mnist_net(), TrainConfig(accum_steps=3, log=_quiet), device="cpu")
    with pytest.raises(ValueError, match="accum_steps 3"):
        trainer.fit(data.synthetic_mnist(256))


def test_remat_with_dropout_draws_the_same_bits():
    """``remat=True`` recomputes the forward in the backward with the same
    dropout masks: a step equals the step without it, bit for bit, and
    the generator ends where it would have."""
    x, y = (torch.from_numpy(a) for a in data.synthetic_mnist(64, seed=2)[:])
    trainers = [
        Trainer(models.mnist_net(torch.Generator().manual_seed(0)),
                TrainConfig(remat=remat, log=_quiet), device="cpu")
        for remat in (False, True)
    ]
    losses = [t.train_step(x, y) for t in trainers]
    assert torch.equal(losses[0], losses[1])
    for name, want in trainers[0].model.state_dict().items():
        assert torch.equal(trainers[1].model.state_dict()[name], want), name
    assert torch.equal(trainers[0].generator.get_state(), trainers[1].generator.get_state())


def test_eval_dataset_fills_eval_accuracy(pair):
    ref, port, _ = pair
    test = data.synthetic_mnist(300, seed=1)
    (got,) = port.fit(data.synthetic_mnist(256, seed=7), eval_dataset=test)
    (want,) = ref.fit(jax_data.synthetic_mnist(256, seed=7),
                      eval_dataset=jax_data.synthetic_mnist(300, seed=1))
    assert got.eval_accuracy == port.evaluate(test) == want.eval_accuracy
    assert got.bad_steps is None


def test_accumulated_ring_reduce_at_world_two_equals_psum():
    """accum_steps=2 with ``grad_reduce="ring"`` at Gloo world 2: the same
    bits as psum, on both ranks, and within the tolerance of one process
    stepping on the global batches without accumulation."""
    net = models.mnist_net(torch.Generator().manual_seed(0))
    state = net.state_dict()
    ds = jax_data.synthetic_mnist(256, seed=7)
    batches = list(jax_data.DistributedLoader(ds, 1, 128, seed=1234).epoch(0))
    out = comm.spmd(workers.trainer_steps, state, batches, ("ring", "psum"), 2,
                    world=2, device="cpu", timeout=240)
    ring, psum = out["ring"], out["psum"]
    for what in ("losses", "params", "momentum"):
        got, want = ring[what], psum[what]
        for key in (got if isinstance(got, dict) else [None]):
            a, b = (got, want) if key is None else (got[key], want[key])
            assert torch.equal(a, b), (what, key)
            assert torch.equal(a[0], a[1]), (what, key)
    for i in DROPOUT_LAYERS:
        net[i].rate = 0.0
    single = Trainer(net, TrainConfig(log=_quiet), device="cpu")
    losses = [single.train_step(torch.from_numpy(x), torch.from_numpy(y)).item()
              for x, y in batches]
    np.testing.assert_allclose(ring["losses"][0].numpy(), losses, **TOL)
    for name, want in single.model.state_dict().items():
        torch.testing.assert_close(ring["params"][name][0], want, atol=1e-5, rtol=0)
