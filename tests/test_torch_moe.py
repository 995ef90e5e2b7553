"""The port's mixture of experts against the JAX package's.

For each world (2, 4) `tpu_dist_torch.comm.spmd` spawns one world of Gloo
CPU processes that runs every case (tests/torch_moe_workers.py); the JAX
package runs the same cases on the same numpy inputs in one SPMD program
on its CPU mesh (`tests.conftest.spmd_run`):

- the gradients through `comm.all_to_all` and `comm.all_gather` (a
  rank-dependent weighted sum of the output, differentiated on every rank)
  against ``jax.grad`` through the JAX package's collectives, exactly for
  the values and to 1e-6 for the gradients (sums over ranks in another
  order);
- `moe_mlp`, `moe_mlp_top2` and `moe_mlp_expert_choice` with ample
  capacity, with dropped tokens and with the expert-choice capacity
  clamped to the global pool: outputs, stats and the gradients of every
  input, to rtol 1e-4, atol 1e-5 (expert choice: 2e-4, JAX's own
  test_moe.py tolerance);
- at world 2, `TransformerLM.apply_moe_ep` and `loss_moe_ep` with their
  gradients (2e-4) and three steps of ``LMTrainer(moe=True)`` against the
  JAX LMTrainer's (rtol 2e-3, atol 2e-4, test_lm_mode_matrix.py's).

Without a process group: the dense MoE TransformerLM's logits and
gradients (with and without remat), cached prefill and decode against the
JAX package's (2e-5; gradients 5e-5), the dense MoE with identical experts
against the dense-MLP model, paged greedy decode against dense `generate`,
the refusals, checkpoints across packages, and the modes demo.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_moe_workers as workers
from tests.conftest import spmd_run
from tpu_dist import comm as jax_comm
from tpu_dist import models as jax_models
from tpu_dist import train as jax_train
from tpu_dist.parallel import moe as jax_moe
from tpu_dist_torch import comm, interop, models, serve
from tpu_dist_torch.train import LMTrainConfig, LMTrainer, checkpoint

WORLDS = [2, 4]
COLLECTIVES = sorted(workers.collective_cases(2))
MOE = sorted(workers.MOE_CASES)
STATS = {"moe_mlp": ("dropped_fraction", "local_load"),
         "moe_mlp_top2": ("dropped_fraction", "local_load", "balance_loss"),
         "moe_mlp_expert_choice": ("local_pick_count", "mean_experts_per_token")}
AXIS = jax_comm.DEFAULT_AXIS
_PORT: dict = {}
_JAX: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this module's tiny tensors: on a busy host the
    thread pool's wake-ups cost more than the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_trainer(cfg: dict):
    mesh = jax_comm.make_mesh(2, ("data",), platform="cpu")
    return jax_train.LMTrainer(
        jax_models.TransformerLM(**workers.LM), mesh,
        jax_train.LMTrainConfig(**cfg, moe=True, log=lambda line: None),
        optimizer=jax_train.sgd(workers.FIT_LR))


def _port(world: int) -> dict:
    """Every case in one spawned world; at world 2 also the expert-parallel
    LM from the port's seeded init and the fits from the JAX LMTrainers'
    initial parameters (made here, kept for the JAX side)."""
    if world not in _PORT:
        args = ()
        if world == 2:
            tlm = models.TransformerLM(**workers.LM, generator=torch.Generator().manual_seed(7))
            _JAX["lm_state"] = tlm.state_dict()
            _JAX["fit"] = {name: _jax_trainer(cfg) for name, cfg in
                           (("fit", workers.FIT), ("fit_composed", workers.FIT_COMPOSED))}
            fit_state = interop.params_from_jax(jax.device_get(_JAX["fit"]["fit"].params))
            args = (_JAX["lm_state"], fit_state)
        _PORT[world] = comm.spmd(workers.run_all, *args, world=world, device="cpu",
                                 timeout=240)
    return _PORT[world]


def _jax_collectives(world: int) -> dict:
    key = ("collectives", world)
    if key not in _JAX:
        cases, inputs = workers.collective_cases(world), workers.collective_inputs(world)

        def fn():
            r = jax_comm.rank()
            out = {}
            for name, (f, kw, _, _) in cases.items():
                kw = dict(kw)
                if "group" in kw:
                    kw["group"] = jax_comm.new_group(kw["group"])
                xs, ws = inputs[name]
                w = jnp.asarray(ws)[r]

                def collective(x, f=f, kw=kw):
                    return getattr(jax_comm, f)(x, **kw)

                def loss(x, w=w, collective=collective):
                    return jnp.sum(w * collective(x))

                x = jnp.asarray(xs)[r]
                out[name] = {"y": collective(x), "grad": jax.grad(loss)(x)}
            return out

        _JAX[key] = jax.device_get(spmd_run(fn, world=world))
    return _JAX[key]


def _jax_moe(world: int) -> dict:
    key = ("moe", world)
    if key not in _JAX:
        inputs = {k: jnp.asarray(v) for k, v in workers.moe_inputs(world).items()}

        def fn():
            r = jax_comm.rank()
            out = {}
            for name, (f, factor) in workers.MOE_CASES.items():
                def loss(x, gate, up, down, f=f, factor=factor):
                    y, stats = getattr(jax_moe, f)(x, gate, up[r], down[r], axis_name=AXIS,
                                                   capacity_factor=factor)
                    value = jnp.sum(inputs["w"][r] * y)
                    if "balance_loss" in stats:
                        value = value + workers.BALANCE_WEIGHT * stats["balance_loss"]
                    return value, (y, stats)

                (_, (y, stats)), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                                            has_aux=True)(
                    inputs["x"][r], inputs["gate"], inputs["up"], inputs["down"])
                out[name] = {"y": y, "stats": stats,
                             "grads": dict(zip(("x", "gate", "up", "down"), grads))}
            return out

        _JAX[key] = jax.device_get(spmd_run(fn, world=world))
    return _JAX[key]


@pytest.mark.parametrize("case", COLLECTIVES)
@pytest.mark.parametrize("world", WORLDS)
def test_collective_gradients_match_jax_grad(world, case):
    got, want = _port(world)["collectives"][case], _jax_collectives(world)[case]
    np.testing.assert_array_equal(got["y"].numpy(), want["y"])
    np.testing.assert_allclose(got["grad"].numpy(), want["grad"], rtol=1e-6, atol=1e-6)
    if "group" not in case:  # the group case's non-members get no gradient
        assert np.abs(want["grad"]).min(axis=tuple(range(1, want["grad"].ndim))).min() > 0


@pytest.mark.parametrize("case", MOE)
@pytest.mark.parametrize("world", WORLDS)
def test_moe_layers_match_jax(world, case):
    got, want = _port(world)["moe"][case], _jax_moe(world)[case]
    fn = workers.MOE_CASES[case][0]
    tol = (dict(rtol=2e-4, atol=2e-4) if fn == "moe_mlp_expert_choice"
           else dict(rtol=1e-4, atol=1e-5))
    np.testing.assert_allclose(got["y"].numpy(), want["y"], **tol)
    assert set(got["stats"]) == set(want["stats"]) == set(STATS[fn])
    for name in STATS[fn]:
        np.testing.assert_allclose(got["stats"][name].numpy(), want["stats"][name], rtol=1e-6,
                                   err_msg=name)
    for name in ("x", "gate", "up", "down"):
        np.testing.assert_allclose(got["grads"][name].numpy(), want["grads"][name], **tol,
                                   err_msg=name)
        assert np.abs(want["grads"][name]).max() > 0, name
    if case.endswith("drops"):
        assert want["stats"]["dropped_fraction"].min() > 0
    elif fn != "moe_mlp_expert_choice":
        assert want["stats"]["dropped_fraction"].max() <= 0.5
    else:  # every expert takes exactly C = min(T * factor, n * T) tokens
        picks = want["stats"]["mean_experts_per_token"].mean() * world * workers.T
        assert picks == pytest.approx(world * min(int(workers.T * workers.MOE_CASES[case][1]),
                                                  world * workers.T))


def test_apply_and_loss_moe_ep_match_jax():
    got = _port(2)["lm_ep"]
    state = _JAX["lm_state"]
    params = jax.tree.map(jnp.asarray, interop.params_to_jax(state))
    jlm = jax_models.TransformerLM(**workers.LM)

    def fn(params, tokens):
        local = jax.lax.dynamic_slice_in_dim(tokens, jax_comm.rank() * 2, 2, 0)
        logits, balance = jlm.apply_moe_ep(params, local, AXIS)
        loss, grads = jax.value_and_grad(lambda p: jlm.loss_moe_ep(p, local, AXIS))(params)
        return logits, balance, loss, grads

    logits, balance, loss, grads = jax.device_get(
        spmd_run(fn, params, jnp.asarray(workers.lm_tokens()), world=2))
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["logits"].numpy(), logits, **tol)
    np.testing.assert_allclose(got["balance"].numpy(), balance, **tol)
    np.testing.assert_allclose(got["loss"].numpy(), loss, **tol)
    want = {k: np.stack([interop.params_from_jax(jax.tree.map(lambda a: a[r], grads))[k]
                         for r in range(2)]) for k in state}
    assert got["grads"].keys() == want.keys()
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[name], **tol, err_msg=name)
    # each rank's expert gradient lies in its own row
    up = got["grads"]["blocks.0.moe.up"].numpy()
    assert np.abs(up[0, 1]).max() == 0 and np.abs(up[1, 0]).max() == 0
    assert np.abs(up[0, 0]).max() > 0 and np.abs(up[1, 1]).max() > 0


@pytest.mark.parametrize("fit", ["fit", "fit_composed"])
def test_moe_trainer_follows_the_jax_trajectory(fit):
    """Three steps of ``LMTrainer(moe=True)`` at world 2 against the JAX
    LMTrainer's; ``fit_composed`` adds accum_steps 2, nan_guard and
    grad_clip, which the JAX step composes with moe."""
    got = _port(2)[fit]
    trainer = _JAX["fit"][fit]
    history = trainer.fit(workers.fit_windows())
    want = interop.params_from_jax(jax.device_get(trainer.params))
    tol = dict(rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got["losses"][0].numpy(), [s.mean_loss for s in history], **tol)
    assert got["losses"][0, -1] < got["losses"][0, 0]
    for name, p in got["params"].items():
        np.testing.assert_allclose(p[0].numpy(), want[name].numpy(), **tol, err_msg=name)
        np.testing.assert_array_equal(p[0].numpy(), p[1].numpy(), err_msg=name)


# ---- without a process group ------------------------------------------

DENSE = dict(vocab=64, dim=32, depth=2, heads=4, max_seq=32, pos_embedding="rope",
             moe_experts=4)


@pytest.fixture(scope="module")
def pair():
    """The port's MoE LM from its seeded init, the JAX model and its
    parameters carried over by `interop`."""
    tlm = models.TransformerLM(**DENSE, generator=torch.Generator().manual_seed(3))
    params = jax.tree.map(jnp.asarray, interop.params_to_jax(tlm.state_dict()))
    return jax_models.TransformerLM(**DENSE), params, tlm


def _tokens(n=2, seq=32, seed=5):
    return np.array(jax_models.synthetic_tokens(n, seq, DENSE["vocab"], seed=seed))


def test_moe_lm_parameters_are_the_jax_tree(pair):
    jlm, params, tlm = pair
    ref = jax.eval_shape(jlm.init, jax.random.key(0))[0]
    assert jax.tree.structure(interop.params_to_jax(tlm.state_dict())) == \
        jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(interop.params_to_jax(tlm.state_dict())),
                    jax.tree.leaves(ref)):
        assert a.shape == b.shape
    moe = tlm.blocks[0].moe
    assert not hasattr(tlm.blocks[0], "mlp")
    for t, std in ((moe.gate, 0.02), (moe.up, 32**-0.5), (moe.down, 128**-0.5)):
        assert t.std().item() == pytest.approx(std, rel=0.1)


@pytest.mark.parametrize("remat", [False, True])
def test_dense_moe_logits_and_gradients_match_jax(pair, remat):
    jlm, params, tlm = pair
    tokens = _tokens()
    ref = jax_models.TransformerLM(**DENSE, remat=remat)

    def loss(p):
        logits, _ = ref.apply(p, {}, jnp.asarray(tokens))
        return jax_models.lm_loss(logits, jnp.asarray(tokens)), logits

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tlm.remat = remat
    tlm.zero_grad()
    try:
        logits = tlm(torch.from_numpy(tokens))
        models.lm_loss(logits, torch.from_numpy(tokens)).backward()
    finally:
        tlm.remat = False
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    want_grads = interop.params_from_jax(jax.device_get(grads))
    for name, p in tlm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), rtol=5e-5,
                                   atol=5e-5, err_msg=name)


def test_identical_experts_equal_the_dense_mlp_model():
    """Every expert the same: the top-2 gates sum to 1, so the block is
    the MLP block with the same weights and zero biases."""
    moe_lm = models.TransformerLM(**DENSE, generator=torch.Generator().manual_seed(1))
    dense_kw = {k: v for k, v in DENSE.items() if k != "moe_experts"}
    mlp_lm = models.TransformerLM(**dense_kw)
    state = mlp_lm.state_dict()
    with torch.no_grad():
        for i, blk in enumerate(moe_lm.blocks):
            blk.moe.up.copy_(blk.moe.up[:1].expand_as(blk.moe.up))
            blk.moe.down.copy_(blk.moe.down[:1].expand_as(blk.moe.down))
            state[f"blocks.{i}.mlp.fc1.w"] = blk.moe.up[0].clone()
            state[f"blocks.{i}.mlp.fc2.w"] = blk.moe.down[0].clone()
            state[f"blocks.{i}.mlp.fc1.b"].zero_()
            state[f"blocks.{i}.mlp.fc2.b"].zero_()
        for name, t in moe_lm.state_dict().items():
            if ".moe." not in name:
                state[name] = t
    mlp_lm.load_state_dict(state)
    tokens = torch.from_numpy(_tokens())
    torch.testing.assert_close(moe_lm(tokens), mlp_lm(tokens), rtol=2e-5, atol=2e-5)


def test_cached_prefill_and_decode_match_jax(pair):
    jlm, params, tlm = pair
    tokens = _tokens(seq=12)
    cached = jax.jit(jlm.apply_cached)
    want_pre, jcache = cached(params, jnp.asarray(tokens), jlm.init_cache(2, 16), 0)
    nxt = np.asarray(jnp.argmax(want_pre[:, -1], -1))[:, None].astype(np.int32)
    want_dec, _ = cached(params, jnp.asarray(nxt), jcache, 12)
    with torch.no_grad():
        got_pre, cache = tlm.apply_cached(torch.from_numpy(tokens), tlm.init_cache(2, 16), 0)
        got_dec, _ = tlm.apply_cached(torch.from_numpy(nxt), cache, 12)
        dense = tlm(torch.from_numpy(tokens))
    for got, want in ((got_pre, want_pre), (got_dec, want_dec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got_pre, dense, rtol=2e-5, atol=2e-5)


def test_paged_greedy_equals_dense_generate(pair):
    _, _, tlm = pair
    prompts = _tokens(n=3, seq=6, seed=8)
    dense = tlm.generate(torch.from_numpy(prompts), 8, cache_len=16).numpy()
    cfg = serve.ServeConfig(max_batch=4, block_size=4, num_blocks=32, max_seq=16,
                            prefill_chunk=4)
    eng = serve.ServeEngine(tlm, cfg, device="cpu")
    rids = [eng.submit(p, 8) for p in prompts]
    res = eng.run_until_drained()
    np.testing.assert_array_equal(np.stack([res[r].tokens for r in rids]), dense)


def test_refusals_match_jax():
    for experts in (1, -1):
        with pytest.raises(ValueError, match="moe_experts must be 0") as e:
            models.TransformerLM(**{**DENSE, "moe_experts": experts})
        with pytest.raises(ValueError, match="moe_experts must be 0") as j:
            jax_models.TransformerLM(**{**DENSE, "moe_experts": experts})
        assert str(e.value) == str(j.value)
    lm = models.TransformerLM(**{**DENSE, "moe_experts": 2})
    with pytest.raises(ValueError, match="expert-axis size 1"):
        lm.apply_moe_ep(torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="moe_experts") as e:  # world 1, two experts
        LMTrainer(lm, LMTrainConfig(moe=True), device="cpu")
    mesh = jax_comm.make_mesh(1, ("data",), platform="cpu")
    with pytest.raises(ValueError, match="moe_experts") as j:
        jax_train.LMTrainer(jax_models.TransformerLM(**{**DENSE, "moe_experts": 2}), mesh,
                            jax_train.LMTrainConfig(moe=True))
    assert str(e.value) == str(j.value)
    for other in (dict(tensor_parallel="psum"), dict(sequence_parallel="ring"),
                  dict(pipeline="gpipe")):
        with pytest.raises(ValueError, match="mutually exclusive"):
            LMTrainer(lm, LMTrainConfig(moe=True, **other), device="cpu")
        if "sequence_parallel" in other:  # ported: JAX's refusal of the 1-D mesh
            with pytest.raises(ValueError, match="needs a 'seq' mesh axis") as e:
                LMTrainer(lm, LMTrainConfig(**other), device="cpu")
            with pytest.raises(ValueError, match="needs a 'seq' mesh axis") as j:
                jax_train.LMTrainer(jax_models.TransformerLM(**DENSE), mesh,
                                    jax_train.LMTrainConfig(**other))
            assert str(e.value) == str(j.value)
            continue
        with pytest.raises(NotImplementedError, match="item 10"):
            LMTrainer(lm, LMTrainConfig(**other), device="cpu")


def test_moe_checkpoints_cross_packages(tmp_path):
    """A MoE LM's checkpoint from either package's LMTrainer restores in
    the other's, bit for bit (the dense MoE at world 1)."""
    cfg = dict(epochs=1, global_batch=4, log=lambda line: None)
    lm_kw = {**DENSE, "moe_experts": 2}
    windows = _tokens(n=8)
    mesh = jax_comm.make_mesh(1, ("data",), platform="cpu")
    ref = jax_train.LMTrainer(jax_models.TransformerLM(**lm_kw), mesh,
                              jax_train.LMTrainConfig(**cfg))
    ref.fit(windows, checkpoint_dir=str(tmp_path / "jax"))
    port = LMTrainer(models.TransformerLM(**lm_kw, generator=torch.Generator().manual_seed(9)),
                     LMTrainConfig(**cfg), device="cpu")
    assert port.restore(tmp_path / "jax" / "lm_ckpt_0.npz") == 1

    def host():
        return checkpoint.flatten_with_paths(
            jax.tree.map(lambda t: np.array(t.detach()), port._ckpt_tree()))

    def equal(got, want):
        assert [k for k, _ in got] == [k for k, _ in want]
        assert "['params']['blocks'][1]['moe']['up']" in dict(got)
        for (path, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)

    equal(host(), checkpoint.flatten_with_paths(
        jax.device_get({"params": ref.params, "opt_state": ref.opt_state})))
    port.fit(windows, checkpoint_dir=str(tmp_path / "port"), start_epoch=1, epochs=2)
    back = jax_train.LMTrainer(jax_models.TransformerLM(**lm_kw), mesh,
                               jax_train.LMTrainConfig(**cfg))
    assert back.restore(tmp_path / "port" / "lm_ckpt_1.npz") == 2
    equal(checkpoint.flatten_with_paths(
        jax.device_get({"params": back.params, "opt_state": back.opt_state})), host())


def test_modes_demo_trains_moe_at_world_two(monkeypatch, capsys):
    from tpu_dist_torch.demos import train_lm_modes

    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' thread pools
    losses = train_lm_modes.main(["--mode", "moe", "--world", "2", "--device", "cpu"])
    assert len(losses) == 2 and losses[1] < losses[0]
    assert "mode=moe  world=2  [cpu]" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="item 10"):
        train_lm_modes.main(["--mode", "tp_sp", "--device", "cpu"])
