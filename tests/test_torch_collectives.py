"""The port's collectives against the JAX package, over spawned Gloo worlds.

For each world (2, 3, 4) `tpu_dist_torch.comm.spmd` spawns one world of CPU
processes that runs every case (tests/torch_collective_workers.py): every
collective, every `ReduceOp`, world-wide and over two groups built in one
world, float32 and int32; the JAX package runs the same cases on the same
numpy inputs in one SPMD program on its CPU mesh (`tests.conftest.spmd_run`).
Tolerances: int32 exactly, and every float32 case that moves data without
arithmetic (MAX, MIN, broadcast, gathers, scatter, all-to-all) exactly;
float32 SUM, PRODUCT and AVG rtol 1e-6 with atol 1e-6, since Gloo and XLA
add the n <= 4 terms (of magnitude about 2) in other orders and a sum that
cancels keeps only the absolute error of its terms.  The refusals are the
JAX package's: a root out of range, a root outside the group, scatter's
chunk count.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tests import torch_collective_workers as workers
from tests.conftest import spmd_run
from tpu_dist import comm as jax_comm
from tpu_dist_torch import comm

WORLDS = [2, 3, 4]
CASES = sorted(workers.cases(2))
REFUSALS = sorted(workers.refusals(2))
_PORT: dict = {}
_JAX: dict = {}
_ROOT = {"reduce": "dst", "broadcast": "src", "gather": "dst", "scatter": "src"}


def _port(world: int) -> dict:
    """Every case and refusal in one spawned Gloo world."""
    if world not in _PORT:
        _PORT[world] = comm.spmd(workers.run_all, "cpu", world=world, device="cpu",
                                 timeout=240)
    return _PORT[world]


def _jax_apply(fn, x, kw, made, n):
    kw = dict(kw)
    op = kw.pop("op", None)
    group = made[kw.pop("group")] if "group" in kw else None
    if op == "avg":  # the JAX package has no AVG: its SUM over the participants
        count = len(group.ranks) if group is not None else n
        total = jax_comm.all_reduce(x, jax_comm.ReduceOp.SUM, group=group) / count
        return total if group is None else jnp.where(group.is_member(), total, x)
    if op is not None:
        kw["op"] = getattr(jax_comm.ReduceOp, op.upper())
    if group is not None:
        kw["group"] = group
    if fn in _ROOT:
        return getattr(jax_comm, fn)(x, kw.pop(_ROOT[fn]), **kw)
    return getattr(jax_comm, fn)(x, **kw)


def _jax(world: int) -> dict:
    """The same cases through the JAX package, one SPMD program."""
    if world not in _JAX:
        table = workers.cases(world)

        def fn():
            r = jax_comm.rank()
            made = tuple(jax_comm.new_group(g) for g in workers.groups(world))
            return {name: _jax_apply(f, jnp.asarray(inputs)[r].astype(dtype), kw, made, world)
                    for name, (f, inputs, dtype, kw) in table.items()}

        _JAX[world] = {k: np.asarray(v) for k, v in spmd_run(fn, world=world).items()}
    return _JAX[world]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_port_matches_jax_package(world, case):
    got, want = _port(world)[case].numpy(), _jax(world)[case]
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    fn, _, dtype, kw = workers.cases(world)[case]
    if dtype == "float32" and kw.get("op") in ("sum", "product", "avg"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_known_answers(world):
    """gather of ones: the world size on the root, zeros elsewhere (the
    gather demo); a group's non-members keep their input; every member of
    a group gets the same reduction."""
    out = _port(world)
    for end, dst in (("first", 0), ("last", world - 1)):
        sums = out[f"gather_ones_to_{end}"].sum(dim=(1, 2))
        assert sums.tolist() == [float(world) if r == dst else 0.0 for r in range(world)]
    g0, _ = workers.groups(world)
    inputs = workers.cases(world)["all_reduce_sum_int32_group0"][1]
    got = out["all_reduce_sum_int32_group0"].numpy()
    for r in range(world):
        want = inputs[list(g0)].sum(0) if r in g0 else inputs[r]
        np.testing.assert_array_equal(got[r], want)


@pytest.mark.parametrize("case", REFUSALS)
@pytest.mark.parametrize("world", WORLDS)
def test_refusals_match_jax_package(world, case):
    """Every rank refuses the call with a ValueError, as the JAX package
    does for the same call; the root and group refusals carry its text."""
    fn, kw, shape = workers.refusals(world)[case]
    got = _port(world)[case]
    assert got == [got[0]] * world and got[0].startswith("ValueError: "), got
    made = tuple(jax_comm.new_group(g) for g in workers.groups(world))
    with pytest.raises(ValueError) as jax_error:
        spmd_run(lambda: _jax_apply(fn, jnp.zeros(shape), kw, made, world), world=world)
    if "root" in case or "group" in case or "chunk" in case:
        text = str(jax_error.value)
        key = ("out of range for world size" if "root" in case else
               "not in group" if "outside" in case else
               "one leading-axis chunk per participant" if "chunk" in case else
               "group= supports the default axis=0")
        assert key in text and key in got[0], (text, got[0])


def test_without_a_process_group_every_call_is_a_world_of_one():
    """No process group: the world is rank 0 alone, as the JAX package's
    calls at world 1."""
    import torch

    x = torch.arange(6.0).reshape(2, 3)
    assert comm.all_reduce(x, comm.ReduceOp.PRODUCT) is x
    assert comm.reduce(x, 0, comm.ReduceOp.MAX) is x
    assert comm.broadcast(x, 0) is x
    assert torch.equal(comm.all_gather(x), x[None])
    assert torch.equal(comm.gather(x, 0), x[None])
    assert torch.equal(comm.scatter(x[None], 0), x)
    assert torch.equal(comm.reduce_scatter(x), x)
    assert torch.equal(comm.all_to_all(x, split_axis=0, concat_axis=1), x)
    group = comm.new_group([0, 0])
    assert group.ranks == (0,) and group.pg is None
    with pytest.raises(ValueError, match="out of range for world size 1"):
        comm.new_group([0, 1])
    with pytest.raises(ValueError, match="out of range for world size 1"):
        comm.gather(x, 1)


def test_all_reduce_quantized_waits_for_compress():
    import torch

    with pytest.raises(NotImplementedError, match="item 10"):
        comm.all_reduce_quantized(torch.ones(3))


def test_every_jax_collective_name_is_exported():
    names = {"Group", "ReduceOp", "all_gather", "all_reduce", "all_reduce_quantized",
             "all_to_all", "barrier", "broadcast", "gather", "new_group", "rank", "reduce",
             "reduce_scatter", "ring_perm", "scatter", "send", "sendrecv", "shift",
             "world_size", "InitConfig", "launch", "process_rank", "process_count"}
    assert names <= set(comm.__all__) and names <= set(jax_comm.__all__)
    assert {op.name for op in jax_comm.ReduceOp} <= {op.name for op in comm.ReduceOp}


def test_gather_demo_known_answer(capsys):
    """``python -m tpu_dist_torch.demos.gather --world 4 --device cpu``:
    rank 0's sum is the world size, every other rank's 0.0."""
    from tpu_dist_torch.demos import gather

    out = gather.main(["--world", "4", "--device", "cpu"])
    assert out.tolist() == [4.0, 0.0, 0.0, 0.0]
    printed = capsys.readouterr().out
    assert "Rank 0 sum after gather: 4.0 (expect 4.0" in printed
    assert all(f"Rank {r} sum after gather: 0.0 (expect 0.0" in printed for r in (1, 2, 3))


def test_collectives_card_check_on_cpu_ranks():
    """`ops.checks.check_collectives`, which ``chip_smoke.py`` runs on the
    card, on CPU ranks at world 3: its cases and plain versions agree with
    the collectives."""
    from tpu_dist_torch.ops import checks

    res = checks.check_collectives(3, device="cpu")
    assert res["cases"] == len(checks.collective_cases(3))
