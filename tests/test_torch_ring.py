"""The port's point-to-point functions, its four rings and the ring
kernel's CPU path against the JAX package, over spawned Gloo worlds.

For each world (2, 3, 4) `tpu_dist_torch.comm.spmd` spawns one world of CPU
processes that runs every case (tests/torch_ring_workers.py), and the JAX
package runs the same cases on the same numpy inputs on its CPU mesh
(`tests.conftest.spmd_run`); the Pallas ring kernel runs there in TPU
interpret mode where this jax has it.  Tolerances: the naive ring, the
kernel's CPU path, the plain version and every point-to-point move are
exact (the same float32 adds in the same order, or no arithmetic); the
chunked ring and reduce-scatter rtol 1e-6; bfloat16 rtol 1e-2, as
tests/test_ring.py holds the JAX rings.

Also the kernel's workspace logic, which runs on the host: one workspace
per (device, group), grown only by a call larger than any before it, and
broken for good once a kernel has given up.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_ring_workers as workers
from tests.conftest import spmd_run
from tpu_dist import comm as jax_comm
from tpu_dist import ops as jax_ops
from tpu_dist import parallel as jax_parallel
from tpu_dist.ops.pallas_ring import tpu_interpret_supported
from tpu_dist_torch import comm
from tpu_dist_torch.comm import init as comm_init
from tpu_dist_torch.ops import pallas_ring

WORLDS = [2, 3, 4]
CASES = sorted(workers.cases(2))
_PORT: dict = {}
_JAX: dict = {}


def _port(world: int) -> dict:
    """Every case in one spawned Gloo world of ``world`` processes."""
    if world not in _PORT:
        _PORT[world] = comm.spmd(workers.run_all, world=world, device="cpu", timeout=240)
    return _PORT[world]


def _jax_apply(fn, x, n, collective_ids):
    if fn in ("ring_all_reduce", "ring_all_reduce_chunked", "ring_reduce_scatter",
              "ring_all_gather"):
        return getattr(jax_parallel, fn)(x)
    if fn == "ring_all_gather_offset1":
        return jax_parallel.ring_all_gather(x, owner_offset=1)
    if fn == "ring_all_reduce_pallas":
        if tpu_interpret_supported():  # the TPU kernel itself, simulated
            return jax_ops.ring_all_reduce_pallas(x, interpret=True,
                                                  collective_id=next(collective_ids))
        return jax_parallel.ring_all_reduce(x)
    if fn in ("shift1", "shift2"):
        return jax_comm.shift(x, int(fn[-1]))
    if fn == "send":
        return jax_comm.send(x, dst=n - 1, src=0)
    if fn == "rank_world":
        return jnp.stack([jax_comm.rank(), jax_comm.world_size()]).astype(jnp.float32)
    return jax_comm.sendrecv(x, workers.perms(n)[fn])


def _jax(world: int) -> dict:
    """The same cases through the JAX package, one SPMD program."""
    if world not in _JAX:
        table = workers.cases(world)

        def fn():
            r = jax_comm.rank()
            ids = iter(range(len(table)))
            out = {}
            for name, (f, inputs, dtype) in table.items():
                y = _jax_apply(f, jnp.asarray(inputs)[r].astype(dtype), world, ids)
                out[name] = y.astype(jnp.float32) if y.dtype == jnp.bfloat16 else y
            return out

        _JAX[world] = {k: np.asarray(v) for k, v in spmd_run(fn, world=world).items()}
    return _JAX[world]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_port_matches_jax_package(world, case):
    got, want = _port(world)[case].numpy(), _jax(world)[case]
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    fn, _, dtype = workers.cases(world)[case]
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=1e-2)
    elif fn in ("ring_all_reduce_chunked", "ring_reduce_scatter"):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS)
def test_plain_version_and_cpu_path_match_the_naive_ring(world):
    """`ring_all_reduce_reference` on the stacked inputs equals the JAX naive
    ring, and the kernel's CPU path equals both, exactly."""
    for case in ("pallas_cpu_f32", "pallas_cpu_i32", "naive_f32_ragged"):
        fn, inputs, _ = workers.cases(world)[case]
        plain = pallas_ring.ring_all_reduce_reference(torch.from_numpy(inputs)).numpy()
        xs = jnp.asarray(inputs)
        want = spmd_run(lambda: jax_parallel.ring_all_reduce(xs[jax_comm.rank()]), world=world)
        np.testing.assert_array_equal(plain, np.asarray(want))
        np.testing.assert_array_equal(_port(world)[case].numpy(), plain)


def test_known_answer_send_and_receive_zeros():
    """The ping of demos/ptp.py: rank n-1 gets rank 0's value, every other
    rank keeps its own; a rank that receives nothing gets zeros."""
    world = 3
    out = _port(world)
    inputs = workers.cases(world)["send_f32"][1]
    np.testing.assert_array_equal(out["send_f32"][-1].numpy(), inputs[0])
    np.testing.assert_array_equal(out["send_f32"][:-1].numpy(), inputs[:-1])
    one_pair = out["sendrecv_one_pair"].numpy()
    assert not one_pair[:-1].any()
    np.testing.assert_array_equal(one_pair[-1], workers.cases(world)["sendrecv_one_pair"][1][0])


# ------------------------------------------------- the kernel's workspace


class _FakeWorkspace(pallas_ring.Workspace):
    def __init__(self, world=4, errors=()):
        super().__init__(world)
        self.allocations, self.releases = [], 0
        self._errors = list(errors)

    def _create(self, capacity):
        self.allocations.append(capacity)
        return (1, 2, 3)

    def _release(self):
        self.releases += 1

    def _error(self):
        return self._errors.pop(0) if self._errors else 0


def test_one_workspace_per_device_and_group_grown_only_by_larger_calls(monkeypatch):
    """1,000 calls of random shapes in three dtypes share one workspace,
    sized to the largest payload; it grows exactly when a call is larger
    than any before it, and a second group gets a workspace of its own."""
    monkeypatch.setattr(pallas_ring, "_WORKSPACES", {})
    monkeypatch.setattr(comm_init, "_TEARDOWN", [])
    made = []

    def factory(device, group):
        made.append(_FakeWorkspace())
        return made[-1]

    group, other_group = object(), object()
    device = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    largest, grown_at = 0, []
    for i in range(1000):
        dtype = (torch.float32, torch.bfloat16, torch.int32)[i % 3]
        shape = tuple(int(s) for s in rng.integers(1, 60, size=rng.integers(1, 4)))
        nbytes = math.prod(shape) * dtype.itemsize
        ws = pallas_ring.workspace(device, group, factory=factory)
        grew = ws.reserve(nbytes)
        assert grew == (nbytes > largest), (i, nbytes, largest)
        if grew:
            grown_at.append(nbytes)
        largest = max(largest, nbytes)
        ws.steps += ws.world - 1
    assert len(made) == 1 and ws.capacity == largest
    assert ws.allocations == grown_at and ws.grows == len(grown_at)
    assert ws.releases == len(grown_at) - 1  # each growth frees the smaller one first
    assert pallas_ring.workspace(device, other_group, factory=factory) is not ws
    assert len(made) == 2
    # comm.destroy_process_group's teardown frees every workspace
    comm_init.destroy_process_group()
    assert ws.releases == len(grown_at) and ws.pointers is None
    assert pallas_ring._WORKSPACES == {}


def test_growth_restarts_the_step_count():
    """New memory has zeroed flags, so the steps counted for the kernel
    start again; a smaller call keeps both."""
    ws = _FakeWorkspace(world=3)
    ws.reserve(100)
    ws.steps = 8
    assert not ws.reserve(64) and ws.steps == 8
    assert ws.reserve(101) and ws.steps == 0 and ws.capacity == 101
    assert pallas_ring.slot_stride(101) == 256


def test_a_kernel_that_gave_up_breaks_the_workspace_for_good():
    ws = _FakeWorkspace(errors=[0, 2])
    ws.check()  # no error yet
    with pytest.raises(RuntimeError, match="left neighbour"):
        ws.check()
    with pytest.raises(RuntimeError, match="broken"):  # the word reads 0 again: still broken
        ws.check()
