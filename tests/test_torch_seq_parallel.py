"""The port's collective gradients, mesh and Ulysses sequence parallelism
against the JAX package's.

For each world (2, 4) `tpu_dist_torch.comm.spmd` spawns one world of Gloo
CPU processes that runs every case (tests/torch_seq_workers.py), on a
(1, 2) or (2, 2) data x seq mesh; the JAX package runs the same cases on
the same numpy inputs on its CPU mesh (`tests.conftest.spmd_run`, and
``jax.shard_map`` over the (2, 2) mesh for the cases over one of its axes):

- the gradient through every collective (a rank-dependent weighted sum of
  the output, differentiated on every rank) against ``jax.grad`` through
  the JAX package's, world-wide, over a group (0, n - 1) and over an axis
  of the (2, 2) mesh: data-moving calls' values exactly, reductions' to
  rtol 1e-6 (Gloo and XLA add in other orders), every gradient to 1e-6;
  MAX and MIN have none, in either package;
- the mesh's rank layout against ``jax_comm.make_mesh``'s device grid;
- `ulysses_attention` causal, full and windowed: values and gradients to
  1e-5, and the refusal of heads that do not divide;
- at world 2, `TransformerLM.apply_seq_parallel(attention="ulysses")` and
  `lm_loss_seq_parallel` (learned positions; rope with a window): logits,
  loss and gradients to 2e-4;
- three steps of ``LMTrainer(sequence_parallel="ulysses")`` on the (1, 2)
  and (2, 2) meshes (at world 2 also with accumulation, the guard and
  clipping) against the JAX LMTrainer's ``seq_ulysses`` on the same
  meshes (rtol 2e-3, atol 2e-4, test_lm_mode_matrix.py's), and the
  trainer's checkpoint restored bit for bit.

In process: the refusals against the JAX package's, and the modes demo's
``seq_ulysses`` at world 4.
"""

import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from tests import torch_seq_workers as workers
from tests.conftest import spmd_run
from tpu_dist import comm as jax_comm
from tpu_dist import models as jax_models
from tpu_dist import parallel as jax_parallel
from tpu_dist import train as jax_train
from tpu_dist.models.transformer_lm import lm_loss_seq_parallel as jax_lm_loss_seq_parallel
from tpu_dist_torch import comm, interop, models
from tpu_dist_torch.parallel.ring_attention import RingMultiHeadAttention
from tpu_dist_torch.train import LMTrainConfig, LMTrainer

WORLDS = [2, 4]
COLLECTIVES = [(n, name) for n in WORLDS for name in sorted(workers.collective_cases(n))]
AXIS = jax_comm.DEFAULT_AXIS
# the reductions, whose sums Gloo and XLA take in other orders
REDUCING = ("all_reduce", "reduce", "reduce_scatter")
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


def _jax_mesh(world: int):
    return jax_comm.make_mesh(workers.mesh_shape(world), workers.MESH[1], platform="cpu")


def _jax_trainer(world: int, cfg: dict):
    return jax_train.LMTrainer(
        jax_models.TransformerLM(**workers.FIT_LM), _jax_mesh(world),
        jax_train.LMTrainConfig(**cfg, sequence_parallel="ulysses", log=lambda line: None),
        optimizer=jax_train.sgd(workers.FIT_LR))


def _port(world: int) -> dict:
    """Every case in one spawned world, the trainers' from the JAX
    LMTrainers' initial parameters (made here, kept for the JAX side); at
    world 2 also the LM cases from the port's seeded init."""
    if world not in _PORT:
        fits = {"fit": workers.FIT} | ({"fit_composed": workers.FIT_COMPOSED}
                                       if world == 2 else {})
        _JAX[("fit", world)] = {name: _jax_trainer(world, cfg) for name, cfg in fits.items()}
        fit_state = interop.params_from_jax(
            jax.device_get(_JAX[("fit", world)]["fit"].params))
        lm_states = None
        if world == 2:
            lm_states = _JAX["lm_states"] = {
                name: models.TransformerLM(**kw, generator=torch.Generator().manual_seed(7))
                .state_dict() for name, kw in workers.LMS.items()}
        ckpt_dir = tempfile.mkdtemp(prefix="seq_ckpt_")
        try:
            _PORT[world] = comm.spmd(workers.run_all, lm_states, fit_state, ckpt_dir,
                                     world=world, device="cpu", timeout=240)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return _PORT[world]


def _jax_call(fn: str, x, kw: dict, axis: str = AXIS):
    """The JAX package's collective for one case; AVG (which it lacks) is
    its SUM over the participants, as test_torch_collectives.py has it."""
    kw = dict(kw)
    kw.pop("axis", None)
    group = jax_comm.new_group(kw.pop("group")) if "group" in kw else None
    op = kw.pop("op", None)
    if op == "avg":
        count = len(group.ranks) if group is not None else lax.axis_size(axis)
        total = jax_comm.all_reduce(x, jax_comm.ReduceOp.SUM, axis, group=group) / count
        if fn == "reduce":
            return jnp.where(lax.axis_index(axis) == kw["dst"], total, x)
        return total if group is None else jnp.where(group.is_member(axis), total, x)
    if op is not None:
        kw["op"] = jax_comm.ReduceOp[op.upper()]
    if group is not None:
        kw["group"] = group
    if fn in ("reduce", "gather"):
        return getattr(jax_comm, fn)(x, kw.pop("dst"), axis_name=axis, **kw)
    if fn in ("broadcast", "scatter"):
        return getattr(jax_comm, fn)(x, kw.pop("src"), axis_name=axis, **kw)
    if fn == "sendrecv":
        return jax_comm.sendrecv(x, kw["perm"], axis_name=axis)
    return getattr(jax_comm, fn)(x, axis_name=axis, **kw)


def _value_and_grad(fn, kw, x, w, axis=AXIS):
    def loss(x):
        return jnp.sum(w * _jax_call(fn, x, kw, axis))

    return _jax_call(fn, x, kw, axis), jax.grad(loss)(x)


def _jax_collectives(world: int) -> dict:
    key = ("collectives", world)
    if key not in _JAX:
        cases, inputs = workers.collective_cases(world), workers.collective_inputs(world)
        flat = {k: v for k, v in cases.items() if "axis" not in v[1]}

        def fn():
            r = jax_comm.rank()
            out = {}
            for name, (f, kw, _, _) in flat.items():
                xs, ws = inputs[name]
                y, g = _value_and_grad(f, kw, jnp.asarray(xs)[r], jnp.asarray(ws)[r])
                out[name] = {"y": y, "grad": g}
            return out

        out = jax.device_get(spmd_run(fn, world=world))
        on_axes = {k: v for k, v in cases.items() if "axis" in v[1]}
        if on_axes:  # one program over the (2, 2) mesh, ranks data-major
            both = P(workers.MESH[1])

            def body(xs, ws):
                res = {}
                for name, (f, kw, _, _) in on_axes.items():
                    y, g = _value_and_grad(f, kw, xs[name][0], ws[name][0], kw["axis"])
                    res[name] = {"y": y[None], "grad": g[None]}
                return res

            mapped = jax.jit(jax.shard_map(body, mesh=_jax_mesh(world), in_specs=(both, both),
                                           out_specs=both, check_vma=False))
            out.update(jax.device_get(mapped({k: inputs[k][0] for k in on_axes},
                                             {k: inputs[k][1] for k in on_axes})))
        _JAX[key] = out
    return _JAX[key]


@pytest.mark.parametrize("world,case", COLLECTIVES)
def test_collective_gradients_match_jax_grad(world, case):
    got, want = _port(world)["collectives"]["cases"][case], _jax_collectives(world)[case]
    fn = workers.collective_cases(world)[case][0]
    assert got["y"].shape == want["y"].shape
    if fn in REDUCING:
        np.testing.assert_allclose(got["y"].numpy(), want["y"], rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got["y"].numpy(), want["y"])
    np.testing.assert_allclose(got["grad"].numpy(), want["grad"], rtol=1e-6, atol=1e-6)
    assert np.abs(want["grad"]).max() > 0


@pytest.mark.parametrize("case", sorted(workers.NO_GRADIENT))
@pytest.mark.parametrize("world", WORLDS)
def test_max_and_min_have_no_gradient(world, case):
    """JAX's pmax and pmin have no differentiation rule; the port's backward
    raises, naming the call and the op, on every rank."""
    fn, kw = workers.NO_GRADIENT[case]
    op = kw["op"].upper()
    for message in _port(world)["collectives"]["refused"][case]:
        assert f"{fn} with ReduceOp.{op} has no gradient" in message, message

    def grads():
        return jax.grad(lambda x: jnp.sum(_jax_call(fn, x, kw)))(jnp.ones(2 * world))

    with pytest.raises(NotImplementedError, match=f"p{op.lower()}"):
        spmd_run(grads, world=world)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_lays_ranks_out_as_jax_lays_devices(world):
    got = _port(world)["mesh"]
    ids = np.vectorize(lambda d: d.id)(_jax_mesh(world).devices)
    for r in range(world):
        np.testing.assert_array_equal(got["ranks"][r].numpy(), ids)
        d, s = (int(c) for c in got["coords"][r])
        assert ids[d, s] == r
        np.testing.assert_array_equal(got["group_seq"][r].numpy(), ids[d, :])
        np.testing.assert_array_equal(got["group_data"][r].numpy(), ids[:, s])


def _jax_ulysses(world: int) -> dict:
    key = ("ulysses", world)
    if key not in _JAX:
        inputs = {k: jnp.asarray(v) for k, v in workers.ulysses_inputs(world).items()}

        def fn():
            r = jax_comm.rank()

            def shard(t):
                return lax.dynamic_slice_in_dim(t, r * workers.S_LOCAL, workers.S_LOCAL, 2)

            out = {}
            for name, kw in workers.ULYSSES.items():
                def loss(q, k, v, kw=kw):
                    o = jax_parallel.ulysses_attention(q, k, v, AXIS, **kw)
                    return jnp.sum(shard(inputs["w"]) * o), o

                (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
                    *(shard(inputs[t]) for t in ("q", "k", "v")))
                out[name] = {"out": o, "grads": dict(zip(("q", "k", "v"), grads))}
            return out

        _JAX[key] = jax.device_get(spmd_run(fn, world=world))
    return _JAX[key]


@pytest.mark.parametrize("case", sorted(workers.ULYSSES))
@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_attention_matches_jax(world, case):
    got, want = _port(world)["ulysses"][case], _jax_ulysses(world)[case]
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["out"].numpy(), want["out"], **tol)
    for name in ("q", "k", "v"):
        np.testing.assert_allclose(got["grads"][name].numpy(), want["grads"][name], **tol,
                                   err_msg=name)
        assert np.abs(want["grads"][name]).max() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_refuses_heads_that_do_not_divide(world):
    q = jnp.ones((1, 3, workers.S_LOCAL, workers.D))
    with pytest.raises(ValueError, match="heads 3 not divisible") as e:
        spmd_run(lambda: jax_parallel.ulysses_attention(q, q, q, AXIS), world=world)
    assert _port(world)["ulysses"]["refused"] == [str(e.value)] * world


@pytest.mark.parametrize("name", sorted(workers.LMS))
def test_apply_and_loss_seq_parallel_match_jax(name):
    got = _port(2)["lm_seq"][name]
    state = _JAX["lm_states"][name]
    params = jax.tree.map(jnp.asarray, interop.params_to_jax(state))
    jlm = jax_models.TransformerLM(**workers.LMS[name])
    half = workers.LM_TOKENS[1] // 2

    def fn(params, tokens):
        local = lax.dynamic_slice_in_dim(tokens, jax_comm.rank() * half, half, 1)

        def loss(p):
            logits = jlm.apply_seq_parallel(p, local, AXIS, attention="ulysses")
            return jax_lm_loss_seq_parallel(logits, local, AXIS), logits

        (value, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return logits, value, grads

    logits, loss, grads = jax.device_get(
        spmd_run(fn, params, jnp.asarray(workers.lm_tokens()), world=2))
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got["logits"].numpy(), logits, **tol)
    np.testing.assert_allclose(got["loss"].numpy(), loss, **tol)
    # the mean of the shards' losses is the dense loss on the whole sequence
    dense = models.TransformerLM(**workers.LMS[name])
    dense.load_state_dict(state)
    tokens = torch.from_numpy(workers.lm_tokens())
    with torch.no_grad():
        want_loss = models.lm_loss(dense(tokens), tokens)
    np.testing.assert_allclose(got["loss"].mean().item(), want_loss.item(), rtol=1e-5)
    want = {k: np.stack([interop.params_from_jax(jax.tree.map(lambda a: a[r], grads))[k]
                         for r in range(2)]) for k in state}
    assert got["grads"].keys() == want.keys()
    for key, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[key], **tol, err_msg=key)


@pytest.mark.parametrize("world,fit", [(2, "fit"), (2, "fit_composed"), (4, "fit")])
def test_seq_trainer_follows_the_jax_trajectory(world, fit):
    """Three steps of ``LMTrainer(sequence_parallel="ulysses")`` on the
    (1, 2) and (2, 2) meshes against the JAX LMTrainer's; ``fit_composed``
    adds accum_steps 2, nan_guard and grad_clip."""
    got = _port(world)[fit]
    trainer = _JAX[("fit", world)][fit]
    history = trainer.fit(workers.fit_windows())
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


@pytest.mark.parametrize("world", WORLDS)
def test_seq_trainer_checkpoint_restores_bit_for_bit(world):
    got = _port(world)["fit"]
    assert got["restored_epoch"].tolist() == [3] * world
    assert got["restored_equal"].tolist() == [True] * world


# ---- without a process group ------------------------------------------

LM = dict(vocab=32, dim=16, depth=1, heads=4, max_seq=16)


def _raises_like_jax(port_call, jax_call, error=ValueError, match=None):
    with pytest.raises(error, match=match) as e:
        port_call()
    with pytest.raises(error, match=match) as j:
        jax_call()
    assert str(e.value) == str(j.value)


def test_trainer_refusals_match_jax():
    lm = models.TransformerLM(**LM)
    jlm = jax_models.TransformerLM(**LM)
    flat, jax_flat = comm.world_mesh(), jax_comm.make_mesh(1, ("data",), platform="cpu")
    seq, jax_seq = (comm.make_mesh((1, 1), ("data", "seq")),
                    jax_comm.make_mesh((1, 1), ("data", "seq"), platform="cpu"))

    def both(cfg, mesh, jax_mesh, **kw):
        return (lambda: LMTrainer(lm, LMTrainConfig(**cfg), device="cpu", mesh=mesh),
                lambda: jax_train.LMTrainer(jlm, jax_mesh, jax_train.LMTrainConfig(**cfg)))

    _raises_like_jax(*both(dict(sequence_parallel="bogus"), seq, jax_seq),
                     match="must be 'ring' or 'ulysses'")
    _raises_like_jax(*both(dict(sequence_parallel="ulysses"), flat, jax_flat),
                     match="needs a 'seq' mesh axis")
    for other in (dict(moe=True), dict(tensor_parallel="psum"), dict(pipeline="gpipe")):
        _raises_like_jax(*both(dict(sequence_parallel="ulysses", **other), seq, jax_seq),
                         match="mutually exclusive")
    # the ring core builds, as the JAX LMTrainer's does, and wants its mesh axis
    ring = dict(sequence_parallel="ring")
    assert LMTrainer(lm, LMTrainConfig(**ring), device="cpu", mesh=seq).config == \
        LMTrainConfig(**ring)
    jax_train.LMTrainer(jlm, jax_seq, jax_train.LMTrainConfig(**ring))
    _raises_like_jax(*both(ring, flat, jax_flat), match="needs a 'seq' mesh axis")
    with pytest.raises(ValueError, match="the mesh is the 1-D 'data' mesh"):
        LMTrainer(lm, LMTrainConfig(), device="cpu", mesh=seq)
    with pytest.raises(ValueError, match="holds 4 ranks; the world has 1"):
        comm.make_mesh((2, 2), ("data", "seq"))


def test_seq_parallel_refusals_match_jax():
    def refused(kw, call_kw, match, error=ValueError):
        lm = models.TransformerLM(**{**LM, **kw})
        jlm = jax_models.TransformerLM(**{**LM, **kw})
        params = jax.tree.map(jnp.asarray, interop.params_to_jax(lm.state_dict()))
        toks = np.zeros((1, call_kw.pop("seq", 8)), np.int32)
        _raises_like_jax(
            lambda: lm.apply_seq_parallel(torch.from_numpy(toks), **call_kw),
            lambda: spmd_run(lambda: jlm.apply_seq_parallel(params, jnp.asarray(toks), AXIS,
                                                            **call_kw), world=1),
            error, match)

    refused(dict(kv_heads=2), dict(attention="ulysses"), "kv_heads == heads")
    refused({}, dict(attention="ulysses", seq=20), "exceeds max_seq 16")
    refused(dict(sliding_window=4), dict(attention="ring", flash=True),
            "sliding_window is not supported with use_flash")
    refused({}, dict(attention="bogus"), "core must be 'ring' or 'ulysses'")
    # the default core, the ring, at world 1 is the dense forward
    lm = models.TransformerLM(**LM, generator=torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, LM["vocab"], (2, 8)))
    torch.testing.assert_close(lm.apply_seq_parallel(tokens), lm(tokens), rtol=1e-5, atol=1e-5)


def test_ring_module_keeps_the_dense_parameters_and_refusals():
    for kw, match in ((dict(core="bogus"), "core must be"),
                      (dict(core="ring", use_flash=True, sliding_window=4), "sliding_window")):
        _raises_like_jax(lambda: RingMultiHeadAttention(16, 4, **kw),
                         lambda: jax_parallel.RingMultiHeadAttention(16, 4, axis_name=AXIS, **kw),
                         match=match)
    # at world 1 the module is the dense one, on the same state dict, with
    # either core (the ring's default and its flash blocks too)
    from tpu_dist_torch import nn

    dense = nn.MultiHeadAttention(16, 4, causal=True, use_rope=True, sliding_window=3)
    x = torch.randn(2, 8, 16, generator=torch.Generator().manual_seed(3))
    for kw in (dict(core="ulysses", sliding_window=3), dict(sliding_window=3),
               dict(use_flash=True)):
        ring = RingMultiHeadAttention(16, 4, causal=True, use_rope=True, **kw,
                                      generator=torch.Generator().manual_seed(2))
        dense.sliding_window = kw.get("sliding_window")
        dense.load_state_dict(ring.state_dict())
        torch.testing.assert_close(ring(x), dense(x), rtol=1e-6, atol=1e-6, msg=str(kw))


def test_modes_demo_trains_seq_ulysses_at_world_four(monkeypatch, capsys):
    from tpu_dist_torch.demos import train_lm_modes

    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' thread pools
    losses = train_lm_modes.main(["--mode", "seq_ulysses", "--world", "4", "--device", "cpu"])
    assert len(losses) == 2 and losses[1] < losses[0]
    assert "mode=seq_ulysses  world=4  [cpu]" in capsys.readouterr().out
    # seq_ring is ported (it trains in test_torch_ring_attention.py); the
    # modes still to port exit naming their item
    assert train_lm_modes.MODES["seq_ring"] == (((2, 2), ("data", "seq")),
                                                {"sequence_parallel": "ring"})
    with pytest.raises(SystemExit, match="item 10"):
        train_lm_modes.main(["--mode", "tp_psum", "--device", "cpu"])
    with pytest.raises(SystemExit):
        train_lm_modes.main(["--mode", "seq_ulysses", "--world", "2", "--device", "cpu"])
