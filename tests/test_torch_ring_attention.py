"""The port's ring attention against the JAX package's.

For each world (2, 4) `tpu_dist_torch.comm.spmd` spawns one world of Gloo
CPU processes that runs every case (tests/torch_ring_attention_workers.py);
the JAX package runs the same cases on the same numpy inputs on its CPU
mesh (`tests.conftest.spmd_run`); world 1 runs in this process:

- `ring_attention` at worlds 1, 2 and 4, causal, full, a non-causal window
  and bf16 inputs (float32 accumulation): values to rtol 2e-4, atol 2e-5
  and gradients to 2e-4 in float32, 0.05 in bf16 (the JAX package's
  tests/test_ring_attention.py tolerances); the output keeps its dtype;
- `ring_attention_flash` on the plain blocks against JAX's in interpret
  mode: values to 2e-5, gradients to 2e-4 (its TestRingAttentionFlash);
  the port's flash ring within 2e-5 of its dense ring, and its gradient
  the dense ring's bit for bit (its backward is that ring);
- `RingMultiHeadAttention(core="ring")` with and without ``use_flash``
  and with a window, against the JAX module: 2e-4, 2e-5;
- at world 2, `apply_seq_parallel(attention="ring", flash=False/True)`
  (learned positions; rope with a window, without flash) and
  `lm_loss_seq_parallel`: logits, loss and gradients to 2e-4;
- three steps of ``LMTrainer(sequence_parallel="ring")`` on the (1, 2) and
  (2, 2) meshes (at world 2 also with accumulation, the guard and clipping)
  against the JAX LMTrainer's ``seq_ring``/``dp2_seq_ring``
  (rtol 2e-3, atol 2e-4, test_lm_mode_matrix.py's), every rank the same
  bits;
- `generate_seq_parallel`: greedy tokens at world 4 equal to JAX's
  (learned and rope positions); sampled at world 2 equal to the port's
  dense `generate` with the same generator.

In process: the refusals against the JAX package's, word for word; the
modes demo's ``seq_ring`` at world 4 and the `demos.ring_attention` twin at
world 2 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tests import torch_ring_attention_workers as workers
from tests import torch_seq_workers as seq
from tests.conftest import spmd_run
from tpu_dist import comm as jax_comm
from tpu_dist import models as jax_models
from tpu_dist import parallel as jax_parallel
from tpu_dist import train as jax_train
from tpu_dist.models.transformer_lm import lm_loss_seq_parallel as jax_lm_loss_seq_parallel
from tpu_dist_torch import comm, interop, models

WORLDS = [2, 4]
AXIS = jax_comm.DEFAULT_AXIS
F32 = dict(rtol=2e-4, atol=2e-5)
F32_GRAD = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=0.05, atol=0.05)
FLASH = dict(rtol=2e-5, atol=2e-5)
_PORT: dict = {}
_JAX: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module's tiny tensors."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_mesh(world: int):
    return jax_comm.make_mesh(seq.mesh_shape(world), seq.MESH[1], platform="cpu")


def _states() -> dict:
    """The parameters every world starts from, made once: the port's seeded
    inits, and the trainers' from the JAX LMTrainers' (kept for the JAX
    side)."""
    if "states" not in _JAX:
        def init(cls, *args, seed, **kw):
            return cls(*args, **kw, generator=torch.Generator().manual_seed(seed)).state_dict()

        from tpu_dist_torch.nn import MultiHeadAttention

        def trainer(world, cfg):
            return jax_train.LMTrainer(
                jax_models.TransformerLM(**seq.FIT_LM), _jax_mesh(world),
                jax_train.LMTrainConfig(**cfg, sequence_parallel="ring", log=lambda line: None),
                optimizer=jax_train.sgd(seq.FIT_LR))

        _JAX["fit"] = {(2, "fit_composed"): trainer(2, seq.FIT_COMPOSED)}
        fit = {}
        for world in WORLDS:
            _JAX["fit"][(world, "fit")] = trainer(world, seq.FIT)
            fit[world] = interop.params_from_jax(
                jax.device_get(_JAX["fit"][(world, "fit")].params))
        _JAX["states"] = {
            "mha": init(MultiHeadAttention, workers.MHA_DIM, workers.MHA_HEADS, seed=2),
            "lm": {name: init(models.TransformerLM, **kw, seed=7)
                   for name, kw in seq.LMS.items()},
            "greedy": {name: init(models.TransformerLM, **kw, seed=1)
                       for name, kw in workers.GEN_LMS.items()},
            "sampled": init(models.TransformerLM, **workers.GEN_SAMPLED_LM, seed=2),
            "fit": fit,
        }
    return _JAX["states"]


def _port(world: int) -> dict:
    """Every case of ``world`` in one spawned world (world 1 in this
    process, its results on a leading axis of one rank as `spmd` stacks
    them)."""
    if world not in _PORT:
        states = _states()
        if world == 1:
            _PORT[1] = jax.tree.map(
                lambda t: t[None] if isinstance(t, torch.Tensor) else [t],
                {"ring": workers.ring_cases(1)})
        else:
            mine = dict(states, fit=states["fit"][world])
            _PORT[world] = comm.spmd(workers.run_all, mine, world=world, device="cpu",
                                     timeout=240)
    return _PORT[world]


def _jax_params(state: dict):
    return jax.tree.map(jnp.asarray, interop.params_to_jax(state))


def _local(t, r, s_local, axis=2):
    return lax.dynamic_slice_in_dim(t, r * s_local, s_local, axis)


def _jax_grads(core, q, k, v, w, **kw):
    def loss(q, k, v):
        o = core(q, k, v, AXIS, **kw)
        return jnp.sum(w * o.astype(jnp.float32)), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return {"out": o.astype(jnp.float32),
            "grads": {t: g.astype(jnp.float32) for t, g in zip("qkv", grads)}}


def _jax_ring(world: int) -> dict:
    key = ("ring", world)
    if key not in _JAX:
        inputs = workers.ring_inputs(world)

        def fn():
            r = jax_comm.rank()
            out = {}
            for case, (kw, dtype) in workers.RING.items():
                x = {t: _local(jnp.asarray(a), r, workers.S_LOCAL)
                     for t, a in inputs[case].items()}
                q, k, v = (x[t].astype(dtype) for t in "qkv")
                out[case] = _jax_grads(jax_parallel.ring_attention, q, k, v, x["w"], **kw)
            return out

        _JAX[key] = jax.device_get(spmd_run(fn, world=world))
    return _JAX[key]


def _close(got: torch.Tensor, want, tol, err_msg=""):
    np.testing.assert_allclose(got.float().numpy(), want, **tol, err_msg=err_msg)


@pytest.mark.parametrize("case", sorted(workers.RING))
@pytest.mark.parametrize("world", [1, *WORLDS])
def test_ring_attention_matches_jax(world, case):
    got, want = _port(world)["ring"][case], _jax_ring(world)[case]
    bf16 = workers.RING[case][1] == "bfloat16"
    assert got["dtype"] == ["torch.bfloat16" if bf16 else "torch.float32"] * world
    _close(got["out"], want["out"], BF16 if bf16 else F32)
    for t in "qkv":
        _close(got["grads"][t], want["grads"][t], BF16 if bf16 else F32_GRAD, t)
        assert np.abs(want["grads"][t]).max() > 0


def _jax_flash(world: int) -> dict:
    key = ("flash", world)
    if key not in _JAX:
        x = {t: jnp.asarray(a) for t, a in workers.flash_inputs(world).items()}

        def fn():
            r = jax_comm.rank()
            q, k, v, w = (_local(x[t], r, workers.FLASH_S_LOCAL) for t in "qkvw")
            return {case: _jax_grads(jax_parallel.ring_attention_flash, q, k, v, w,
                                     interpret=True, **kw)
                    for case, kw in workers.FLASH.items()}

        _JAX[key] = jax.device_get(spmd_run(fn, world=world))
    return _JAX[key]


@pytest.mark.parametrize("case", sorted(workers.FLASH))
@pytest.mark.parametrize("world", WORLDS)
def test_ring_attention_flash_matches_jax_and_the_dense_ring(world, case):
    got, want = _port(world)["flash"][case], _jax_flash(world)[case]
    flash, ring = got["flash"], got["ring"]
    _close(flash["out"], want["out"], FLASH)
    _close(flash["out"], ring["out"].numpy(), FLASH)
    for t in "qkv":
        _close(flash["grads"][t], want["grads"][t], F32_GRAD, t)
        # the backward recomputes through the dense ring: its very bits
        assert torch.equal(flash["grads"][t], ring["grads"][t]), t


@pytest.mark.parametrize("case", sorted(workers.MHA))
@pytest.mark.parametrize("world", WORLDS)
def test_ring_module_matches_the_jax_module(world, case):
    key = ("mha", world, case)
    params = _jax_params(_states()["mha"])
    module = jax_parallel.RingMultiHeadAttention(
        workers.MHA_DIM, workers.MHA_HEADS, axis_name=AXIS, interpret=True,
        **workers.MHA[case])
    x = jnp.asarray(workers.mha_input(world))

    def fn(params):
        y, _ = module.apply(params, {}, _local(x, jax_comm.rank(), workers.S_LOCAL, 1))
        return y

    _JAX[key] = jax.device_get(spmd_run(fn, params, world=world))
    _close(_port(world)["mha"][case], _JAX[key], F32)


@pytest.mark.parametrize("name,flash", workers.LM_CASES)
def test_apply_and_loss_seq_parallel_ring_match_jax(name, flash):
    got = _port(2)["lm"][(name, flash)]
    state = _states()["lm"][name]
    jlm = jax_models.TransformerLM(**seq.LMS[name])
    half = seq.LM_TOKENS[1] // 2

    def fn(params, tokens):
        local = _local(tokens, jax_comm.rank(), half, 1)

        def loss(p):
            logits = jlm.apply_seq_parallel(p, local, AXIS, flash=flash, interpret=True)
            return jax_lm_loss_seq_parallel(logits, local, AXIS), logits

        (value, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return logits, value, grads

    logits, loss, grads = jax.device_get(
        spmd_run(fn, _jax_params(state), jnp.asarray(seq.lm_tokens()), world=2))
    _close(got["logits"], logits, F32_GRAD)
    _close(got["loss"], loss, F32_GRAD)
    want = {k: np.stack([interop.params_from_jax(jax.tree.map(lambda a: a[r], grads))[k]
                         for r in range(2)]) for k in state}
    assert got["grads"].keys() == want.keys()
    for key, g in got["grads"].items():
        _close(g, want[key], F32_GRAD, key)


@pytest.mark.parametrize("world,fit", [(2, "fit"), (2, "fit_composed"), (4, "fit")])
def test_ring_trainer_follows_the_jax_trajectory(world, fit):
    """``seq_ring`` on (1, 2), ``dp2_seq_ring`` on (2, 2); ``fit_composed``
    adds accum_steps 2, nan_guard and grad_clip, as
    test_torch_seq_parallel.py does for Ulysses."""
    got = _port(world)[fit]
    trainer = _JAX["fit"][(world, fit)]
    history = trainer.fit(seq.fit_windows())
    want = interop.params_from_jax(jax.device_get(trainer.params))
    tol = dict(rtol=2e-3, atol=2e-4)
    for r in range(world):
        np.testing.assert_allclose(got["losses"][r].numpy(), [s.mean_loss for s in history],
                                   **tol)
    assert got["losses"][0, -1] < got["losses"][0, 0]
    for name, p in got["params"].items():
        np.testing.assert_allclose(p[0].numpy(), want[name].numpy(), **tol, err_msg=name)
        for r in range(1, world):
            np.testing.assert_array_equal(p[r].numpy(), p[0].numpy(), err_msg=name)


@pytest.mark.parametrize("name", sorted(workers.GEN_LMS))
def test_generate_seq_parallel_greedy_matches_jax(name):
    world = 4
    jlm = jax_models.TransformerLM(**workers.GEN_LMS[name])
    prompt = jnp.asarray(workers.gen_prompt("greedy"))
    s_local = prompt.shape[1] // world

    def fn(params):
        return jlm.generate_seq_parallel(
            params, _local(prompt, jax_comm.rank(), s_local, 1), workers.GEN_GREEDY[2], AXIS)

    want = np.asarray(spmd_run(fn, _jax_params(_states()["greedy"][name]), world=world))
    got = _port(world)["greedy"][name]
    for r in range(world):
        np.testing.assert_array_equal(got[r].numpy(), want[r])


def test_generate_seq_parallel_sampled_matches_dense_generate():
    lm = models.TransformerLM(**workers.GEN_SAMPLED_LM)
    lm.load_state_dict(_states()["sampled"])
    dense = lm.generate(torch.from_numpy(workers.gen_prompt("sampled")), workers.GEN_SAMPLED[2],
                        generator=torch.Generator().manual_seed(workers.SAMPLING_SEED),
                        **workers.SAMPLING)
    got = _port(2)["sampled"]
    for r in range(2):
        assert torch.equal(got[r], dense)


# ---- without a process group ------------------------------------------

LM = dict(vocab=16, dim=8, depth=1, heads=2, max_seq=16)


def _raises_like_jax(port_call, jax_call, match):
    with pytest.raises(ValueError, match=match) as e:
        port_call()
    with pytest.raises(ValueError, match=match) as j:
        jax_call()
    assert str(e.value) == str(j.value)


@pytest.mark.parametrize("kw,steps,match", [
    (dict(sliding_window=4), 2, "does not support sliding_window"),
    (dict(kv_heads=1), 2, "requires kv_heads == heads"),
    ({}, 12, "prompt 8 \\+ steps 12 exceeds max_seq 16"),
], ids=["window", "kv_heads", "max_seq"])
def test_generate_seq_parallel_refusals_match_jax(kw, steps, match):
    lm = models.TransformerLM(**LM, **kw)
    jlm = jax_models.TransformerLM(**LM, **kw)
    params = _jax_params(lm.state_dict())
    prompt = np.zeros((1, 8), np.int32)
    _raises_like_jax(
        lambda: lm.generate_seq_parallel(torch.from_numpy(prompt), steps),
        lambda: spmd_run(lambda: jlm.generate_seq_parallel(params, jnp.asarray(prompt), steps,
                                                           AXIS), world=1),
        match)


def test_apply_seq_parallel_checks_kv_heads_before_the_core():
    """The JAX package refuses kv_heads != heads before it builds the ring
    module, so a bogus core on a grouped-query model names kv_heads."""
    lm = models.TransformerLM(**LM, kv_heads=1)
    jlm = jax_models.TransformerLM(**LM, kv_heads=1)
    params = _jax_params(lm.state_dict())
    tokens = np.zeros((1, 8), np.int32)
    _raises_like_jax(
        lambda: lm.apply_seq_parallel(torch.from_numpy(tokens), attention="bogus"),
        lambda: spmd_run(lambda: jlm.apply_seq_parallel(params, jnp.asarray(tokens), AXIS,
                                                        attention="bogus"), world=1),
        "kv_heads == heads")


def _no_rendezvous(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' thread pools


def test_modes_demo_trains_seq_ring_at_world_four(monkeypatch, capsys):
    from tpu_dist_torch.demos import train_lm_modes

    _no_rendezvous(monkeypatch)
    losses = train_lm_modes.main(["--mode", "seq_ring", "--world", "4", "--device", "cpu"])
    assert len(losses) == 2 and losses[1] < losses[0]
    assert "mode=seq_ring  world=4  [cpu]" in capsys.readouterr().out


def test_ring_attention_demo_twin_on_the_cpu(monkeypatch, capsys):
    from tpu_dist_torch.demos import ring_attention

    _no_rendezvous(monkeypatch)
    errors = ring_attention.main(["--world", "2", "--seq", "64", "--heads", "4", "--dim", "16",
                                  "--device", "cpu"])
    assert set(errors) == {"ring", "ulysses"}
    out = capsys.readouterr().out
    assert "S=64 over 2 ranks (32 tokens/rank), causal=True  [cpu]" in out
    for name in errors:
        assert errors[name] < ring_attention.TOL
        assert any(line.strip().startswith(name) and line.endswith("(OK)")
                   for line in out.splitlines()), out
