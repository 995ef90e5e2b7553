"""The port's NaN guard and loss scale against the JAX package's.

The guard's scalars (``scale``, ``bad_steps``, ``good_streak``, ``step``)
are held to the JAX `nan_guard`'s at every step of a sequence of good and
bad gradients; a bad step leaves the parameters and the inner state bit
for bit; the LMTrainer in float16 under ``loss_scale`` is held to the JAX
LMTrainer's; at Gloo world 2 a NaN on rank 1 alone makes both ranks skip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_collective_workers as workers
from tpu_dist import comm as jax_comm
from tpu_dist import models as jax_models
from tpu_dist import train as jax_train
from tpu_dist.resilience import guards as jax_guards
from tpu_dist_torch import comm, interop, models
from tpu_dist_torch.resilience import guards
from tpu_dist_torch.train import LMTrainConfig, LMTrainer, TrainConfig, Trainer, adamw, sgd
from tpu_dist_torch.train.optim import sgd_rule

LM = dict(vocab=64, dim=32, depth=2, heads=2, max_seq=128, pos_embedding="rope")


def _quiet(_line):
    pass


def _tree(rng):
    return {
        "w": rng.standard_normal((4, 3)).astype(np.float32),
        "blocks": [{"b": rng.standard_normal(3).astype(np.float32)}],
    }


def _clone(state):
    if isinstance(state, dict):
        return {k: _clone(v) for k, v in state.items()}
    return state.clone()


def _assert_same_bits(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same_bits(a[k], b[k])
    else:
        assert torch.equal(a, b)


GOOD_BAD = [True, True, True, False, True, True, False, False, True, True, True]


@pytest.mark.parametrize("inner", ["adamw", "sgd"])
def test_guard_scalars_follow_jax_step_by_step(inner):
    """growth_interval 2 from a scale of 4: the scale grows every second
    good step and halves on each bad one, clamped to [1, 2**16]."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = dict(init_scale=4.0, growth_interval=2)
    if inner == "adamw":
        opt_jax = jax_guards.nan_guard(jax_train.adamw(1e-2), **kw)
        p = interop.params_from_jax(params)
        opt = guards.nan_guard(adamw(1e-2), **kw)
    else:
        opt_jax = jax_guards.nan_guard(jax_train.sgd(0.1, 0.5), **kw)
        p = {k: torch.nn.Parameter(v) for k, v in interop.params_from_jax(params).items()}
        opt = guards.nan_guard(sgd_rule(sgd(list(p.values()), 0.1, 0.5)), **kw)
    p_jax = jax.tree.map(jnp.asarray, params)
    s_jax = opt_jax.init(p_jax)
    state = opt.init(p)
    for i, good in enumerate(GOOD_BAD):
        g = _tree(rng)
        if not good:
            g["blocks"][0]["b"][1] = np.nan if i % 2 else np.inf
        before = (_clone(p), _clone(state["inner"]))
        p_jax, s_jax = opt_jax.update(p_jax, jax.tree.map(jnp.asarray, g), s_jax)
        opt.update(p, interop.params_from_jax(g), state)
        for key in ("scale", "bad_steps", "good_streak", "step"):
            got, want = state[key], np.asarray(s_jax[key])
            assert str(got.dtype).removeprefix("torch.") == want.dtype.name, key
            assert got.item() == want.item(), (i, key)
        if not good:
            _assert_same_bits(p, before[0])
            _assert_same_bits(state["inner"], before[1])
        want = interop.params_from_jax(jax.device_get(p_jax))
        for name in want:
            np.testing.assert_allclose(p[name].detach().numpy(), want[name].numpy(),
                                       rtol=1e-6, atol=1e-6)
    assert guards.bad_steps(state) == 3 == jax_guards.bad_steps(s_jax)
    assert guards.loss_scale(state) == jax_guards.loss_scale(s_jax)


@pytest.mark.parametrize("momentum", [0.5, 0.0])
def test_sgd_rule_with_ok_true_gives_torch_steps_bits(momentum):
    """`sgd_rule` keeps torch's own step for an unguarded run and writes the
    rule out for a guarded one: with ``ok`` always true, five steps of the
    written rule leave the parameters and momentum buffers bit for bit
    where torch's steps leave them."""
    rng = np.random.default_rng(3)
    shapes = {"conv": (4, 3, 5, 5), "w": (33, 7), "b": (7,)}
    init = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for k, s in shapes.items()}
    runs = []
    for _ in range(2):
        p = {k: torch.nn.Parameter(v.clone()) for k, v in init.items()}
        rule = sgd_rule(sgd(list(p.values()), 0.1, momentum))
        runs.append((p, rule, rule.init(p)))
    ok = torch.tensor(True)
    for _ in range(5):
        g = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in shapes.items()}
        (p0, rule0, s0), (p1, rule1, s1) = runs
        for k in p0:
            p0[k].grad = g[k].clone()
        rule0.update(p0, g, s0)
        rule1.update(p1, g, s1, ok)
        _assert_same_bits({k: v.detach() for k, v in p1.items()},
                          {k: v.detach() for k, v in p0.items()})
        _assert_same_bits(s1, s0)
    assert bool(s0) == bool(momentum)


def test_loss_scale_needs_the_guard():
    lm = models.TransformerLM(vocab=16, dim=16, depth=1, heads=2, max_seq=64)
    with pytest.raises(ValueError, match="loss_scale requires nan_guard"):
        LMTrainer(lm, LMTrainConfig(loss_scale=1024.0), device="cpu")
    with pytest.raises(ValueError, match="loss_scale requires nan_guard"):
        Trainer(models.mnist_net(), TrainConfig(loss_scale=1024.0), device="cpu")


def test_nonfinite_loss_poisons_every_gradient():
    grads = [torch.ones(3), torch.zeros(2, 2), torch.arange(3)]
    guards.poison_if_nonfinite(grads, torch.tensor([1.5]))
    assert all(torch.isfinite(g.float()).all() for g in grads)
    guards.poison_if_nonfinite(grads, torch.tensor([float("inf")]))
    assert torch.isnan(grads[0]).all() and torch.isnan(grads[1]).all()
    assert torch.equal(grads[2], torch.arange(3))  # integers pass through


def test_guarded_step_skips_a_nan_gradient_and_halves_the_scale():
    trainer = Trainer(models.mnist_net(torch.Generator().manual_seed(0)),
                      TrainConfig(nan_guard=True, loss_scale=256.0, log=_quiet), device="cpu")
    x = torch.randn(16, 28, 28, 1, generator=torch.Generator().manual_seed(1))
    y = torch.arange(16) % 10
    trainer.train_step(x, y)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    bufs = {k: v.clone() for k, v in trainer.opt_state["inner"]["buf"].items()}
    x[3, 5, 5, 0] = float("nan")
    loss = trainer.train_step(x, y)
    assert torch.isnan(loss)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in trainer.opt_state["inner"]["buf"].items():
        assert torch.equal(v, bufs[k]), k
    assert guards.bad_steps(trainer.opt_state) == 1
    assert guards.loss_scale(trainer.opt_state) == 128.0


def test_float16_loss_scaled_lm_matches_jax_lm_trainer(monkeypatch):
    """float16 compute, ``nan_guard`` with ``loss_scale=2**10``: both
    packages scale the loss, unscale the gradients and step the same
    way.  As in test_compute_dtype_matches_jax_lm_trainer, the embedding
    table is scaled up 25x so float16's LayerNorm backward stays finite,
    and float16 losses agree to 1e-3 relative."""
    monkeypatch.setenv("TPU_DIST_FLASH", "1")
    mesh = jax_comm.make_mesh(1, ("data",), platform="cpu")
    cfg = dict(epochs=3, global_batch=4, compute_dtype="float16", nan_guard=True,
               loss_scale=2.0**10, log=_quiet)
    ref = jax_train.LMTrainer(jax_models.TransformerLM(**LM), mesh, jax_train.LMTrainConfig(**cfg))
    ref.params["embed"]["table"] = ref.params["embed"]["table"] * 25.0
    lm = models.TransformerLM(**LM)
    lm.load_state_dict(interop.params_from_jax(jax.device_get(ref.params)))
    port = LMTrainer(lm, LMTrainConfig(**cfg), device="cpu")
    windows = np.array(jax_models.synthetic_tokens(4, 128, LM["vocab"], seed=2))
    want, got = ref.fit(windows), port.fit(windows)
    np.testing.assert_allclose([s.mean_loss for s in got], [s.mean_loss for s in want],
                               rtol=1e-3)
    assert [s.bad_steps for s in got] == [s.bad_steps for s in want]
    assert guards.loss_scale(port.opt_state) == jax_guards.loss_scale(ref.opt_state)
    assert got[-1].mean_loss < got[0].mean_loss
    params = port.lm.state_dict()
    want_params = interop.params_from_jax(jax.device_get(ref.params))
    diffs = torch.cat([(params[k] - want_params[k]).abs().reshape(-1) for k in want_params])
    assert diffs.max().item() <= 2 * 3e-3 * 3


def test_nan_on_one_rank_makes_both_ranks_skip():
    """Gloo world 2, the MNIST Trainer under the guard: rank 1's batch
    holds a NaN, so its loss is NaN and its gradients are poisoned before
    the reduce; both ranks skip the step (parameters and buffers as
    before, ``bad_steps`` 1, the scale halved), then a good step moves both
    the same way."""
    out = comm.spmd(workers.guarded_steps, world=2, device="cpu", timeout=240)
    assert out["bad_steps"].tolist() == [1, 1]
    assert out["scale"].tolist() == [128.0, 128.0]
    assert out["unchanged_after_bad"].tolist() == [True, True]
    assert out["moved_after_good"].tolist() == [True, True]
    for name, t in out["params"].items():
        assert torch.equal(t[0], t[1]), name
