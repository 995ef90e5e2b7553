"""The port's LM demo against the JAX demo's computation.

``tpu_dist_torch.demos.train_lm``'s loop is given the JAX demo's init
(``lm.init(key(1234))``, converted with `interop`), its optimizer (AdamW
under ``cosine(3e-3, steps, warmup_steps=steps // 10)``) and the same
batches; its losses over 12 steps are held to the JAX demo's step
(``make_spmd_train_step`` on a one-device mesh) within 1e-4 relative.
The command line refuses ``--tp`` and, on the CPU with a corpus, prints
a falling loss.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_dist import comm as jax_comm
from tpu_dist import models as jax_models
from tpu_dist import parallel as jax_parallel
from tpu_dist import train as jax_train
from tpu_dist_torch import interop, models
from tpu_dist_torch.demos import train_lm

REPO = Path(__file__).resolve().parents[1]
STEPS, BATCH, SEQ, VOCAB = 12, 8, 64, 64


# The rendezvous variables the port's init reads: a world of one here,
# whatever another test in this process left behind.
RENDEZVOUS_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                  "LOCAL_WORLD_SIZE", "TPU_DIST_INIT_METHOD", "TORCHELASTIC_USE_AGENT_STORE",
                  "TORCHELASTIC_RESTART_COUNT")


@pytest.fixture(autouse=True)
def _world_of_one(monkeypatch):
    for var in RENDEZVOUS_ENV:
        monkeypatch.delenv(var, raising=False)


def _jax_demo_losses(tokens: np.ndarray):
    """The JAX demo's data-parallel step (demos/train_lm.py:49-126) on one
    device, ``STEPS`` steps on the fixed batch; returns the init and the
    losses."""
    mesh = jax_comm.make_mesh(1, ("data",), platform="cpu")
    lm = jax_models.TransformerLM(vocab=VOCAB, dim=64, depth=2, heads=4, max_seq=SEQ)
    params, _ = lm.init(jax.random.key(1234))
    opt = jax_train.adamw(jax_train.schedule.cosine(3e-3, STEPS, warmup_steps=STEPS // 10))

    def loss_fn(p, s, batch, key):
        (toks,) = batch
        logits, _ = lm.apply(p, {}, toks)
        return jax_models.lm_loss(logits.astype(jnp.float32), toks), ({}, {})

    step = jax_parallel.make_spmd_train_step(loss_fn, opt, mesh, donate=False)
    p = jax_parallel.replicate(params, mesh)
    ms = jax_parallel.replicate({}, mesh)
    os_ = jax_parallel.replicate(opt.init(params), mesh)
    batch = jax_parallel.shard_batch((jnp.asarray(tokens),), mesh)
    losses = []
    for i in range(STEPS):
        p, ms, os_, loss, _ = step(p, ms, os_, batch, jax.random.key(i))
        losses.append(float(loss))
    return jax.device_get(params), losses


def test_demo_loop_matches_jax_demo():
    tokens = models.synthetic_tokens(BATCH, SEQ, VOCAB).numpy()
    init, want = _jax_demo_losses(tokens)
    lm = models.TransformerLM(vocab=VOCAB, dim=64, depth=2, heads=4, max_seq=SEQ)
    lm.load_state_dict(interop.params_from_jax(init))
    trainer = train_lm.make_trainer(lm, steps=STEPS, batch=BATCH, bf16=False, device="cpu")
    got, seconds = train_lm.run(trainer, lambda i: tokens, STEPS, log=lambda line: None)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0] and seconds > 0


def test_tensor_parallel_is_refused():
    with pytest.raises(SystemExit, match="item 10"):
        train_lm.main(["--tp", "psum", "--device", "cpu"])


def test_command_line_on_the_cpu_learns_the_corpus():
    run = subprocess.run(
        [sys.executable, "-m", "tpu_dist_torch.demos.train_lm", "--device", "cpu",
         "--corpus", "docs/tutorial.md", "--steps", "25"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stderr
    losses = [float(v) for v in re.findall(r"step +\d+ +loss ([0-9.]+)", run.stdout)]
    assert len(losses) >= 2 and losses[-1] < losses[0], run.stdout
    assert "tokens/s" in run.stdout and "held-out: loss" in run.stdout
