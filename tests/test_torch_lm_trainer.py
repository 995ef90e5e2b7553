"""The port's LMTrainer against the JAX LMTrainer, AdamW against the JAX
optimizer, and world 2 against world 1.

Both trainers start from the JAX init (converted with `interop`) and fit
the same windows with ``TPU_DIST_FLASH=1``, three epochs of one step each,
so each epoch's mean is one step's loss: the losses agree to 1e-5
relative.  Params after AdamW are held more loosely, and on purpose: the
first Adam update is about ``lr * sign(g)``, so a gradient near zero whose
float32 roundoff differs between the packages can flip its sign and move
that one weight by up to ``2 * lr`` per step.  So every element must lie
within that bound, and all but one in a thousand within 1e-5 (the
gradients themselves are held to 5e-5 in test_torch_transformer_lm.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dist import comm as jax_comm
from tpu_dist import models as jax_models
from tpu_dist import train as jax_train
from tpu_dist_torch import interop, models
from tpu_dist_torch.comm import init as comm_init
from tpu_dist_torch.train import (
    LMTrainConfig,
    LMTrainer,
    adamw,
    clip_by_global_norm,
    decay_mask_default,
    global_norm,
    schedule,
)

REPO = Path(__file__).resolve().parents[1]
LM = dict(vocab=64, dim=32, depth=2, heads=2, max_seq=128, pos_embedding="rope")
LR = 3e-3  # LMTrainConfig's default in both packages


def _quiet(_line):
    pass


def _assert_params_close(got: dict, want: dict, steps: int, lr: float = LR):
    assert got.keys() == want.keys()
    diffs = torch.cat([(got[k] - want[k]).abs().reshape(-1) for k in want])
    assert diffs.max().item() <= 2 * lr * steps
    assert (diffs > 1e-5).float().mean().item() <= 1e-3


@pytest.mark.parametrize("grad_clip", [None, 0.05])
def test_fit_matches_jax_lm_trainer(monkeypatch, grad_clip):
    monkeypatch.setenv("TPU_DIST_FLASH", "1")
    mesh = jax_comm.make_mesh(1, ("data",), platform="cpu")
    ref = jax_train.LMTrainer(
        jax_models.TransformerLM(**LM), mesh,
        jax_train.LMTrainConfig(epochs=3, global_batch=4, grad_clip=grad_clip, log=_quiet),
    )
    lm = models.TransformerLM(**LM)
    lm.load_state_dict(interop.params_from_jax(jax.device_get(ref.params)))
    port = LMTrainer(lm, LMTrainConfig(epochs=3, global_batch=4, grad_clip=grad_clip,
                                       log=_quiet), device="cpu")
    windows = np.array(jax_models.synthetic_tokens(4, 128, LM["vocab"], seed=2))
    want = ref.fit(windows)
    got = port.fit(windows)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose([s.mean_loss for s in got], [s.mean_loss for s in want],
                               rtol=1e-5)
    assert got[-1].mean_loss < got[0].mean_loss
    assert all(s.tokens_per_sec > 0 for s in got)
    _assert_params_close(port.lm.state_dict(),
                         interop.params_from_jax(jax.device_get(ref.params)), steps=3)


@pytest.mark.parametrize("compute_dtype", ["float16", "float32"])
def test_compute_dtype_matches_jax_lm_trainer(monkeypatch, compute_dtype):
    """The forward and backward on a float16 (or float32) copy of the float32
    masters, against the JAX LMTrainer with the same ``compute_dtype``.

    Both start from the JAX init with the embedding table scaled up 25x:
    at the init's std of 0.02 the first LayerNorm's rsqrt backward
    (rsqrt(var)^3, about 1.25e5) overflows float16 in both packages alike,
    and every loss after the first step is NaN.  float16 rounds every
    activation in both packages, each at its own places (XLA may fuse
    several operations between roundings), so float16 losses agree to 1e-3
    relative and params within the first-step Adam bound; float32 is held
    as test_fit_matches_jax_lm_trainer holds it."""
    monkeypatch.setenv("TPU_DIST_FLASH", "1")
    mesh = jax_comm.make_mesh(1, ("data",), platform="cpu")
    cfg = dict(epochs=3, global_batch=4, compute_dtype=compute_dtype, log=_quiet)
    ref = jax_train.LMTrainer(jax_models.TransformerLM(**LM), mesh,
                              jax_train.LMTrainConfig(**cfg))
    ref.params["embed"]["table"] = ref.params["embed"]["table"] * 25.0
    lm = models.TransformerLM(**LM)
    lm.load_state_dict(interop.params_from_jax(jax.device_get(ref.params)))
    port = LMTrainer(lm, LMTrainConfig(**cfg), device="cpu")
    windows = np.array(jax_models.synthetic_tokens(4, 128, LM["vocab"], seed=2))
    want, got = ref.fit(windows), port.fit(windows)
    rtol = 1e-3 if compute_dtype == "float16" else 1e-5
    np.testing.assert_allclose([s.mean_loss for s in got], [s.mean_loss for s in want],
                               rtol=rtol)
    assert all(np.isfinite(s.mean_loss) for s in got)
    assert got[-1].mean_loss < got[0].mean_loss
    assert all(p.dtype == torch.float32 for p in port.lm.parameters())
    params = port.lm.state_dict()
    want_params = interop.params_from_jax(jax.device_get(ref.params))
    if compute_dtype == "float32":
        _assert_params_close(params, want_params, steps=3)
    else:
        diffs = torch.cat([(params[k] - want_params[k]).abs().reshape(-1) for k in want_params])
        assert diffs.max().item() <= 2 * LR * 3


def test_validation_perplexity_is_reported():
    lm = models.TransformerLM(vocab=32, dim=16, depth=1, heads=2, max_seq=64,
                              generator=torch.Generator().manual_seed(0))
    trainer = LMTrainer(lm, LMTrainConfig(epochs=1, global_batch=2, log=_quiet), device="cpu")
    (stats,) = trainer.fit(models.synthetic_tokens(4, 64, 32),
                           val_windows=models.synthetic_tokens(3, 64, 32, seed=1))
    assert stats.val_perplexity == pytest.approx(np.exp(stats.val_loss))


def test_unported_options_are_refused():
    lm = models.TransformerLM(vocab=32, dim=16, depth=1, heads=2, max_seq=64)
    with pytest.raises(ValueError, match="accum_steps"):
        LMTrainer(lm, LMTrainConfig(accum_steps=0), device="cpu")
    with pytest.raises(ValueError, match="compute_dtype"):
        LMTrainer(lm, LMTrainConfig(compute_dtype="int32"), device="cpu")
    trainer = LMTrainer(lm, LMTrainConfig(global_batch=8, log=_quiet), device="cpu")
    with pytest.raises(ValueError, match="global batch"):
        trainer.fit(models.synthetic_tokens(4, 64, 32))


def test_bfloat16_compute_keeps_float32_masters():
    lm = models.TransformerLM(vocab=32, dim=16, depth=1, heads=2, max_seq=64,
                              pos_embedding="rope", generator=torch.Generator().manual_seed(0))
    trainer = LMTrainer(lm, LMTrainConfig(epochs=2, global_batch=2, compute_dtype="bfloat16",
                                          lr=1e-2, log=_quiet), device="cpu")
    history = trainer.fit(models.synthetic_tokens(4, 64, 32))
    assert all(p.dtype == torch.float32 for p in trainer.lm.parameters())
    assert all(np.isfinite(s.mean_loss) for s in history)
    assert history[1].mean_loss < history[0].mean_loss


def _random_tree(rng):
    return {
        "w": rng.standard_normal((4, 3)).astype(np.float32),
        "b": rng.standard_normal(3).astype(np.float32),
        "blocks": [{"ln": {"scale": rng.standard_normal(3).astype(np.float32)},
                    "table": rng.standard_normal((2, 5)).astype(np.float32)}],
    }


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_with_cosine_matches_jax(clip):
    """Five steps of AdamW (decay on matrices only, cosine lr with warmup,
    optionally clipped) on a random tree, against the JAX optimizer."""
    rng = np.random.default_rng(0)
    params = _random_tree(rng)
    grads = [_random_tree(rng) for _ in range(5)]
    kw = dict(weight_decay=0.1)
    opt_jax = jax_train.adamw(jax_train.schedule.cosine(1e-2, 10, warmup_steps=2),
                              decay_mask=jax_train.decay_mask_default, **kw)
    opt = adamw(schedule.cosine(1e-2, 10, warmup_steps=2), decay_mask=decay_mask_default, **kw)
    if clip is not None:
        opt_jax = jax_train.clip_by_global_norm(opt_jax, clip)
        opt = clip_by_global_norm(opt, clip)
    p_jax = jax.tree.map(jnp.asarray, params)
    s_jax = opt_jax.init(p_jax)
    p = interop.params_from_jax(params)
    state = opt.init(p)
    for g in grads:
        p_jax, s_jax = opt_jax.update(p_jax, jax.tree.map(jnp.asarray, g), s_jax)
        opt.update(p, interop.params_from_jax(g), state)
    want = interop.params_from_jax(jax.device_get(p_jax))
    for name in want:
        np.testing.assert_allclose(p[name].numpy(), want[name].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    assert state["step"] == 5


def test_schedules_and_norm_match_jax():
    for step in (0, 1, 3, 7, 12):
        for ours, theirs in [
            (schedule.cosine(0.1, 10, warmup_steps=3), jax_train.schedule.cosine(0.1, 10,
                                                                                 warmup_steps=3)),
            (schedule.step_decay(0.1, gamma=0.5, every=4),
             jax_train.schedule.step_decay(0.1, gamma=0.5, every=4)),
            (schedule.constant(0.05), jax_train.schedule.constant(0.05)),
        ]:
            np.testing.assert_allclose(float(ours(step)), float(theirs(step)), rtol=1e-7)
    tree = _random_tree(np.random.default_rng(1))
    np.testing.assert_allclose(float(global_norm(interop.params_from_jax(tree))),
                               float(jax_train.global_norm(tree)), rtol=1e-6)
    for path, leaf in [("blocks.0.attn.qkv.b", torch.zeros(3)), ("ln.scale", torch.zeros(3)),
                       ("blocks.0.mlp.fc1.w", torch.zeros(3, 4)), ("embed.table", torch.zeros(3, 4)),
                       ("pos", torch.zeros(1, 3, 4))]:
        jax_path = "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in path.split("."))
        assert decay_mask_default(path, leaf) == jax_train.decay_mask_default(
            jax_path, np.zeros(tuple(leaf.shape)))


_WORKER = """
import os, sys
import torch
from tpu_dist_torch import comm, models
from tpu_dist_torch.train import LMTrainConfig, LMTrainer

rank, world = comm.init_process_group(torch.device("cpu"))
# rank 1 builds from another seed: the LMTrainer makes the replicas equal
lm = models.TransformerLM(vocab=32, dim=16, depth=1, heads=2, max_seq=128,
                          pos_embedding="rope",
                          generator=torch.Generator().manual_seed(0 if rank == 0 else 99))
trainer = LMTrainer(lm, LMTrainConfig(epochs=1, global_batch=4, log=lambda line: None),
                    device="cpu")
(stats,) = trainer.fit(models.synthetic_tokens(8, 128, 32, seed=5))
torch.save({"loss": stats.mean_loss, "state": trainer.lm.state_dict(), "world": world},
           sys.argv[1])
torch.distributed.destroy_process_group()
"""


def test_gloo_world_two_matches_world_one(tmp_path, monkeypatch):
    """Two processes, 2 windows each per step, 2 steps (flash path at
    S = 128), against one process on the same global batches; rank 1 built
    its model from another seed, and the broadcast from rank 0 at
    construction makes it rank 0's."""
    monkeypatch.setenv("TPU_DIST_FLASH", "1")
    store = comm_init.host_store()  # held here, so no other process can take its port
    env = dict(os.environ, **comm_init.launcher_env(store, "localhost", 2),
               PYTHONPATH=str(REPO))
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, str(tmp_path / f"rank{r}.pt")],
                         env=dict(env, RANK=str(r)), cwd=REPO)
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

    lm = models.TransformerLM(vocab=32, dim=16, depth=1, heads=2, max_seq=128,
                              pos_embedding="rope", generator=torch.Generator().manual_seed(0))
    single = LMTrainer(lm, LMTrainConfig(epochs=1, global_batch=4, log=_quiet), device="cpu")
    (stats,) = single.fit(models.synthetic_tokens(8, 128, 32, seed=5))
    for rank_out in out:
        np.testing.assert_allclose(rank_out["loss"], stats.mean_loss, rtol=1e-5)
        _assert_params_close(rank_out["state"], single.lm.state_dict(), steps=2)
    for name, t in out[0]["state"].items():
        torch.testing.assert_close(t, out[1]["state"][name], rtol=0, atol=0)


def test_accumulated_fit_matches_jax_lm_trainer(monkeypatch):
    """accum_steps=2 in both packages (4 windows a step, 2 a microbatch),
    held as test_fit_matches_jax_lm_trainer holds the plain fit."""
    monkeypatch.setenv("TPU_DIST_FLASH", "1")
    mesh = jax_comm.make_mesh(1, ("data",), platform="cpu")
    cfg = dict(epochs=3, global_batch=4, accum_steps=2, log=_quiet)
    ref = jax_train.LMTrainer(jax_models.TransformerLM(**LM), mesh, jax_train.LMTrainConfig(**cfg))
    lm = models.TransformerLM(**LM)
    lm.load_state_dict(interop.params_from_jax(jax.device_get(ref.params)))
    port = LMTrainer(lm, LMTrainConfig(**cfg), device="cpu")
    windows = np.array(jax_models.synthetic_tokens(4, 128, LM["vocab"], seed=2))
    want, got = ref.fit(windows), port.fit(windows)
    np.testing.assert_allclose([s.mean_loss for s in got], [s.mean_loss for s in want],
                               rtol=1e-5)
    _assert_params_close(port.lm.state_dict(),
                         interop.params_from_jax(jax.device_get(ref.params)), steps=3)


def test_accumulated_step_equals_one_step():
    """accum_steps=4 against accum_steps=1 on the same 8 windows: the
    loss, every gradient and the updated params, up to float32 sums taken
    in another order; a batch of 6 does not split into 4."""
    trainers = [
        LMTrainer(models.TransformerLM(vocab=32, dim=16, depth=2, heads=2, max_seq=128,
                                       pos_embedding="rope",
                                       generator=torch.Generator().manual_seed(0)),
                  LMTrainConfig(global_batch=8, accum_steps=k, log=_quiet), device="cpu")
        for k in (1, 4)
    ]
    tokens = models.synthetic_tokens(8, 128, 32, seed=6)
    losses = [t.loss_and_grads(tokens).item() for t in trainers]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    for name, p in trainers[0].params.items():
        torch.testing.assert_close(trainers[1].params[name].grad, p.grad, rtol=1e-5, atol=1e-7)
    for t in trainers:
        t.train_step(tokens)
    _assert_params_close(trainers[1].lm.state_dict(), trainers[0].lm.state_dict(), steps=2)
    with pytest.raises(ValueError, match="accum_steps 4"):
        trainers[1].train_step(tokens[:6])
