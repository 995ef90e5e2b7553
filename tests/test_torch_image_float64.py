"""The port's Trainer on ResNet-18 against the JAX Trainer in float64: three
steps, an epoch and evaluation, accumulation, remat, a Gloo world of 2
against a 2-device mesh, and a step the guard skips.

Both sides in float64 (the JAX Trainer under ``jax.enable_x64``, its loss
still float32 as the Trainer casts the scores; the port's model in
double), on 16 x 16 crops of synthetic CIFAR-10: params, momentum and
batch-norm state agree to 1e-7, losses to float32's resolution (2e-7
relative).  test_torch_image_trainer.py says why float32 runs cannot be
held this close over several steps.
"""

import jax
import numpy as np
import pytest
import torch

from tests import torch_collective_workers as workers
from tests import torch_image_helpers as h
from tpu_dist import models as jax_models
from tpu_dist_torch import comm, interop


def test_three_steps_match_jax_trainer_in_float64(monkeypatch):
    mesh = h.cpu_mesh()
    with jax.enable_x64(True):
        ref, port = h.pair64(mesh, monkeypatch)
        batches = h.batches(dtype=np.float64, crop=16)
        want_losses, (params, state, opt) = h.jax_steps(ref, batches, mesh)
    got = h.port_steps(port, batches)
    np.testing.assert_allclose(got, want_losses, **h.LOSS64)
    got_params, got_state = interop.module_to_jax(port.model)
    h.close(got_params, params, **h.TOL64)
    h.close(got_state, state, **h.TOL64)
    h.close(h.momentum(port), opt["buf"], **h.TOL64)
    # the statistics moved: every batch norm's mean left its zeros
    assert all(np.abs(layer["mean"]).max() > 0 for layer in got_state if "mean" in layer)


def test_fit_and_evaluate_match_jax_trainer_in_float64(monkeypatch):
    """An epoch through the port's ``fit`` against the JAX Trainer's steps
    on the same batches, then the port's held-out accuracy, with the
    running statistics, against the JAX model's in eval mode on the same
    params and state, on a ragged set (16 + 16 + a padded 8)."""
    mesh = h.cpu_mesh()
    test = h.cifar(40, 1, np.float64, crop=16)
    with jax.enable_x64(True):
        ref, port = h.pair64(mesh, monkeypatch)
        batches = h.batches(dtype=np.float64, crop=16)
        want_losses, (params, state, _) = h.jax_steps(ref, batches, mesh)
        logits, _ = jax_models.resnet18().apply(params, state, test.images, train=False)
        want_acc = float((np.asarray(logits).argmax(-1) == test.labels).mean())
    (got,) = port.fit(h.cifar(48, 7, np.float64, crop=16))
    np.testing.assert_allclose(got.mean_loss, np.mean(want_losses), **h.LOSS64)
    h.close(interop.module_to_jax(port.model)[1], state, **h.TOL64)
    assert port.evaluate(test, batch_size=16) == want_acc


@pytest.mark.parametrize("cfg", [dict(accum_steps=2), dict(remat=True)],
                         ids=["accum2", "remat"])
def test_options_match_jax_trainer_in_float64(monkeypatch, cfg):
    """accum_steps 2 threads the state through the microbatches in order
    (each normalizes by its own 8 samples); remat recomputes the forward.
    Both against the JAX Trainer's step with the same option, over an
    epoch of 3 steps."""
    mesh = h.cpu_mesh()
    with jax.enable_x64(True):
        ref, port = h.pair64(mesh, monkeypatch, **cfg)
        batches = h.batches(dtype=np.float64, crop=16)
        want_losses, (params, state, _) = h.jax_steps(ref, batches, mesh)
    (got,) = port.fit(h.cifar(48, 7, np.float64, crop=16))
    np.testing.assert_allclose(got.mean_loss, np.mean(want_losses), **h.LOSS64)
    got_params, got_state = interop.module_to_jax(port.model)
    h.close(got_params, params, **h.TOL64)
    h.close(got_state, state, **h.TOL64)


def test_gloo_world_two_matches_jax_two_device_mesh_in_float64(monkeypatch):
    """Two processes under ``comm.spmd``, 8 samples each per step, 3 steps,
    against the JAX Trainer on a 2-device CPU mesh: each rank normalizes by
    its own half and the new statistics are averaged over ranks, as JAX
    pmeans its state.  Under "psum" the statistics ride the gradients'
    all-reduce, under "ring" they take their own; at world 2 both are
    (a + b) / 2, so the two runs hold the same bits, on both ranks."""
    mesh = h.cpu_mesh(2)
    with jax.enable_x64(True):
        ref, port = h.pair64(mesh, monkeypatch)
        batches = h.batches(dtype=np.float64, crop=16)
        want_losses, (params, state, _) = h.jax_steps(ref, batches, mesh)
    net = port.model
    out = comm.spmd(workers.image_trainer_steps, net.state_dict(), batches, ("psum", "ring"),
                    world=2, device="cpu", timeout=300)
    psum, ring = out["psum"], out["ring"]
    for r in range(2):
        np.testing.assert_allclose(psum["losses"][r].numpy(), want_losses, **h.LOSS64)
        net.load_state_dict({k: v[r] for k, v in psum["state"].items()})
        got_params, got_state = interop.module_to_jax(net)
        h.close(got_params, params, **h.TOL64)
        h.close(got_state, state, **h.TOL64)
    assert torch.equal(psum["losses"], ring["losses"])
    for name, t in psum["state"].items():
        assert torch.equal(t, ring["state"][name]), name
        assert torch.equal(t[0], t[1]), name  # both ranks hold the same bits


def test_skipped_step_updates_the_state_as_jax_does(monkeypatch):
    """Under ``nan_guard`` a batch with a NaN pixel is skipped: params and
    momentum stay as they were, bad_steps counts it, and the model state
    takes the step's new statistics (NaN here) in both packages, since the
    JAX step returns its new state whatever the guard decides.  In float64,
    so the params after the good step compare at 1e-7."""
    mesh = h.cpu_mesh()
    (x0, y0), (x1, y1) = h.batches(32, dtype=np.float64, crop=16)
    x1 = x1.copy()
    x1[0, 3, 4, 1] = np.nan
    with jax.enable_x64(True):
        ref, port = h.pair64(mesh, monkeypatch, nan_guard=True)
        want_losses, (params, state, opt) = h.jax_steps(ref, [(x0, y0), (x1, y1)], mesh)
    got = h.port_steps(port, [(x0, y0), (x1, y1)])
    np.testing.assert_allclose(got[0], want_losses[0], **h.LOSS64)
    assert np.isnan(got[1]) and np.isnan(want_losses[1])
    assert int(opt["bad_steps"]) == 1
    from tpu_dist_torch.resilience.guards import bad_steps

    assert bad_steps(port.opt_state) == 1
    got_params, got_state = interop.module_to_jax(port.model)
    h.close(got_params, params, **h.TOL64)
    for a, b in zip(jax.tree.leaves(got_state), jax.tree.leaves(state)):
        assert np.isnan(b).all() and np.isnan(a).all()
