"""The port's point-to-point functions, its four rings and the ring
kernel's CPU path against the JAX package, over spawned Gloo worlds.

For each world (2, 3, 4) `tpu_dist_torch.comm.spmd` spawns one world of CPU
processes that runs every case (tests/torch_ring_workers.py), and the JAX
package runs the same cases on the same numpy inputs on its CPU mesh
(`tests.conftest.spmd_run`); the Pallas ring kernel runs there in TPU
interpret mode where this jax has it.  Tolerances: the naive ring, every
point-to-point move, and the kernel's CPU path and plain version against
the JAX chunked ring and JAX's off-TPU `ring_all_reduce_pallas` are exact
(the same adds in the same order, or no arithmetic); the chunked ring and
reduce-scatter rtol 1e-6; bfloat16 rtol 1e-2, as tests/test_ring.py holds
the JAX rings; the kernel's CPU path against the TPU kernel (the naive
ring, which sums in another order) int32 exactly and floats within the
error bound of a reordered sum.

Also the kernel's cut (chunks, slices, scalar heads and tails) and its
workspace logic, which run on the host: one workspace per (device, group),
grown only by a call larger than any before it, 2 (n - 1) sends per call,
no control-group collective for a call that fits, growth exchanges that
raise when the ranks disagree, a workspace broken for good once a kernel
has given up, and a teardown that closes every workspace even when one
fails.
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


# unit roundoff of the float dtypes the ring sums in
_ROUNDOFF = {"float32": 2.0**-24, "bfloat16": 2.0**-8}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_port_matches_jax_package(world, case):
    """Every case against the JAX package.  The ring kernel's cases meet the
    TPU kernel in interpret mode, the naive ring, while the port sums in the
    chunked ring's order: int32 exactly, floats within the error bound of a
    sum of n terms taken in two orders, 2 (n - 1) u sum_i |x_i| with u the
    dtype's unit roundoff (rtol alone fails where the terms cancel)."""
    got, want = _port(world)[case].numpy(), _jax(world)[case]
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    fn, inputs, dtype = workers.cases(world)[case]
    if fn == "ring_all_reduce_pallas" and dtype != "int32":
        terms = np.abs(_wide(torch.from_numpy(inputs).to(getattr(torch, dtype))))
        bound = 2 * (world - 1) * _ROUNDOFF[dtype] * terms.sum(0, dtype=np.float64)
        assert np.all(np.abs(got.astype(np.float64) - want) <= bound), \
            np.max(np.abs(got.astype(np.float64) - want) - bound)
    elif dtype == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=1e-2)
    elif fn in ("ring_all_reduce_chunked", "ring_reduce_scatter"):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _stacked(world: int, case: str) -> tuple[torch.Tensor, jnp.ndarray]:
    """The case's stacked inputs for the port and for the JAX package."""
    _, inputs, dtype = workers.cases(world)[case]
    return torch.from_numpy(inputs).to(getattr(torch, dtype)), jnp.asarray(inputs).astype(dtype)


def _wide(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("world", WORLDS)
def test_plain_version_and_cpu_path_match_the_chunked_ring(world):
    """`ring_all_reduce_reference` on the stacked inputs equals the JAX
    chunked ring and the kernel's CPU path, bit for bit, in float32,
    bfloat16 and int32, ragged, 7 elements and fewer elements than ranks;
    every rank's row is the same bits."""
    for case in workers.pallas_cases(world):
        xs, jxs = _stacked(world, case)
        plain = pallas_ring.ring_all_reduce_reference(xs)
        assert plain.dtype == xs.dtype and plain.shape == xs.shape
        assert all(torch.equal(row, plain[0]) for row in plain), case
        want = spmd_run(lambda: jax_parallel.ring_all_reduce_chunked(jxs[jax_comm.rank()]),
                        world=world)
        np.testing.assert_array_equal(_wide(plain), np.asarray(want).astype(_wide(plain).dtype),
                                      err_msg=case)
        np.testing.assert_array_equal(_port(world)[case].numpy(), _wide(plain), err_msg=case)


@pytest.mark.parametrize("case", workers.pallas_cases(2))
@pytest.mark.parametrize("world", WORLDS)
def test_cpu_path_matches_jax_off_tpu_path(world, case):
    """The port's CPU `ring_all_reduce_pallas` against the JAX package's
    `ring_all_reduce_pallas` off the TPU (its chunked fallback), on every
    rank: the same bits (int32 and floats alike)."""
    _, jxs = _stacked(world, case)
    with pytest.warns(RuntimeWarning, match="falling back"):
        want = spmd_run(lambda: jax_ops.ring_all_reduce_pallas(jxs[jax_comm.rank()]),
                        world=world)
    got = _port(world)[case].numpy()
    np.testing.assert_array_equal(got, np.asarray(want).astype(got.dtype))


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_gets_the_same_bits(world):
    for case in workers.pallas_cases(world):
        out = _port(world)[case]
        assert all(torch.equal(row, out[0]) for row in out), case


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


def test_pallas_cpu_path_over_a_subgroup():
    """A `comm.Group` of ranks 1 and 3 of a world of 4: its members get the
    sum of their two inputs, the other ranks keep theirs."""
    out = comm.spmd(workers.pallas_over_a_subgroup, world=4, device="cpu", timeout=120)
    x, y = out["x"], out["y"]
    for r in (1, 3):
        torch.testing.assert_close(y[r], x[1] + x[3], rtol=0, atol=0)
    for r in (0, 2):
        torch.testing.assert_close(y[r], x[r], rtol=0, atol=0)


# ------------------------------------------------- the kernel's cut


@pytest.mark.parametrize("numel,n,item,blocks", [
    (7, 4, 4, 128), (3, 4, 4, 128), (1, 2, 2, 128), (1_000_003, 3, 4, 128),
    (1_000_003, 4, 2, 128), (4096, 2, 4, 128), (4000, 2, 4, 128), (65_536, 3, 4, 64),
    (16_777_216, 4, 4, 128), (1001, 3, 2, 7), (123, 4, 2, 3), (33, 2, 4, 1),
    # below one 16-byte vector a chunk: the loss, fc2's bias, conv2's
    (1, 3, 4, 128), (1, 4, 4, 128), (10, 2, 4, 128), (10, 4, 2, 128), (20, 3, 4, 128),
    (20, 4, 4, 128),
    # every other tensor of the ConvNet's step under grad_reduce="ring"
    (250, 2, 4, 128), (5000, 2, 4, 128), (16_000, 2, 4, 128), (50, 2, 4, 128),
    (500, 2, 4, 128),
])
def test_kernel_cut_covers_every_element_once(numel, n, item, blocks):
    """The Python mirror of the kernel's cut: the chunks are the chunked
    ring's, every element lies in exactly one block's slice, each slice's
    head and tail are shorter than 16 bytes and its body 16-byte aligned on
    both sides, and the slice fits its slot region."""
    v = 16 // item
    seen = np.zeros(numel, np.int64)
    assert pallas_ring.slice_elements(numel, n, item, blocks) % v == 0
    region = pallas_ring.region_bytes(numel * item, n, blocks)
    m = -(-numel // n)
    for c in range(n):
        assert pallas_ring.chunk_bounds(numel, n, c) == (min(c * m, numel),
                                                         min((c + 1) * m, numel))
        for lo, a, e, hi in pallas_ring.cut(numel, n, item, c, blocks):
            assert lo <= a <= e <= hi
            assert a - lo < v and hi - e < v
            assert (a % v == 0 and e % v == 0) or a == e
            assert (hi - (lo - lo % v)) * item <= region  # slot index of hi - 1, plus one
            seen[lo:hi] += 1
    assert (seen == 1).all()


def test_region_fits_every_call_up_to_the_capacity():
    """A region sized for a capacity in bytes holds a slice and its head
    for every call of at most that many bytes, in either element size."""
    rng = np.random.default_rng(0)
    for _ in range(20_000):
        n, blocks, item = int(rng.integers(2, 9)), int(rng.choice([1, 3, 7, 128])), \
            int(rng.choice([2, 4]))
        numel = int(rng.integers(1, 10 ** int(rng.integers(1, 8))))
        capacity = numel * item + int(rng.integers(0, 64))
        need = (pallas_ring.slice_elements(numel, n, item, blocks) + 16 // item) * item
        assert need <= pallas_ring.region_bytes(capacity, n, blocks), (n, blocks, item, numel)


# ------------------------------------------------- the kernel's workspace


class _FakeWorkspace(pallas_ring.Workspace):
    def __init__(self, world=4, errors=(), stamps=None, barrier_fails=False):
        super().__init__(world)
        self.allocations, self.releases, self.barriers = [], 0, 0
        self.error_words = 1
        self._errors = list(errors)
        self._stamps = stamps  # what the other ranks bring to a growth exchange
        self._barrier_fails = barrier_fails

    def _agree(self, stamp):
        if isinstance(self._stamps, Exception):
            raise self._stamps
        return [stamp] + (self._stamps or [stamp] * (self.world - 1))

    def _create(self, capacity):
        self.allocations.append(capacity)
        return (1, 2, 3)

    def _barrier(self):
        self.barriers += 1
        if self._barrier_fails:
            raise TimeoutError("a rank did not come to the teardown barrier")

    def _release(self):
        self.releases += 1

    def _error(self):
        return self._errors.pop(0) if self._errors else 0

    def _free_error_word(self):
        self.error_words -= 1


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
        ws.launched()
    assert len(made) == 1 and ws.capacity == largest
    assert ws.allocations == grown_at and ws.grows == len(grown_at)
    assert ws.releases == len(grown_at) - 1  # each growth frees the smaller one first
    assert pallas_ring.workspace(device, other_group, factory=factory) is not ws
    assert len(made) == 2
    # comm.destroy_process_group's teardown frees every workspace, after a barrier
    comm_init.destroy_process_group()
    assert ws.releases == len(grown_at) and ws.pointers is None and ws.barriers == 1
    assert ws.error_words == 0 and pallas_ring._WORKSPACES == {}


def test_a_teardown_barrier_that_fails_still_closes_every_workspace(monkeypatch):
    """A workspace whose teardown barrier times out raises, but only after
    every workspace was closed: each error word is freed, the failed one's
    memory is left (a neighbour's kernel may still store into it) and the
    others' is released."""
    monkeypatch.setattr(pallas_ring, "_WORKSPACES", {})
    monkeypatch.setattr(comm_init, "_TEARDOWN", [])
    made = iter([_FakeWorkspace(), _FakeWorkspace(barrier_fails=True), _FakeWorkspace()])
    spaces = [pallas_ring.workspace(torch.device("cuda", 0), object(),
                                    factory=lambda device, group: next(made))
              for _ in range(3)]
    for ws in spaces:
        ws.reserve(64)
    with pytest.raises(RuntimeError, match="control-group exchange failed"):
        comm_init.destroy_process_group()
    assert pallas_ring._WORKSPACES == {} and comm_init._TEARDOWN == []
    assert [ws.error_words for ws in spaces] == [0, 0, 0]
    assert [ws.barriers for ws in spaces] == [1, 1, 1]
    assert [ws.releases for ws in spaces] == [1, 0, 1]
    assert all(ws.pointers is None for ws in spaces)
    assert spaces[1].broken and not spaces[0].broken


def test_growth_restarts_the_step_count():
    """New memory has zeroed flags, so the sends counted for the kernel
    start again; a smaller call keeps both.  A slot holds ceil(capacity /
    n) bytes and each slice's padding, so each of the kernel's three slots
    takes 1 / n of the payload."""
    ws = _FakeWorkspace(world=3)
    ws.reserve(100)
    ws.steps = 8
    assert not ws.reserve(64) and ws.steps == 8
    assert ws.reserve(101) and ws.steps == 0 and ws.capacity == 101
    assert ws.region_bytes == pallas_ring.region_bytes(101, 3, ws.blocks) == 48
    payload = 64 << 20
    slot = ws.slot_bytes(payload)
    assert -(-payload // 3) <= slot <= -(-payload // 3) + 48 * ws.blocks
    assert slot / payload < 1 / 3 + 0.001


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_steps_advance_by_two_sends_per_rank_less_one_per_call(world):
    """Each call makes 2 (n - 1) sends (reduce-scatter, then all-gather);
    its stamp carries its numel, dtype, shape and first send."""
    ws = _FakeWorkspace(world=world)
    for call in range(5):
        x = torch.zeros(3, 5, dtype=torch.bfloat16)
        stamp = ws.prepare(x)
        assert stamp == (15, 1, hash((3, 5)) % 2**62, call * 2 * (world - 1))
        ws.launched()
    assert ws.steps == 5 * 2 * (world - 1)


def test_a_call_that_fits_makes_no_control_group_collective():
    """Only growth talks over the control group: two collectives (the stamp
    exchange, the handle exchange) per growth, none for 1,000 calls that
    fit."""
    ws = _FakeWorkspace(world=4)
    ws.prepare(torch.zeros(4096))
    ws.launched()
    assert ws.collectives == 2 and ws.grows == 1
    rng = np.random.default_rng(1)
    for _ in range(1000):
        ws.prepare(torch.zeros(int(rng.integers(1, 4097))))
        ws.launched()
    assert ws.collectives == 2 and ws.grows == 1


def test_a_kernel_that_gave_up_breaks_the_workspace_for_good():
    ws = _FakeWorkspace(errors=[0, 2])
    ws.check()  # no error yet
    with pytest.raises(RuntimeError, match="left neighbour"):
        ws.check()
    with pytest.raises(RuntimeError, match="broken"):  # the word reads 0 again: still broken
        ws.check()


def test_a_mismatch_found_by_the_kernel_breaks_the_workspace_for_good():
    """Error code 3: the left neighbour's call carried another numel, dtype
    or shape.  The broken workspace refuses every later call and is not
    freed (a neighbour's kernel may still store into it)."""
    ws = _FakeWorkspace(errors=[3])
    ws.reserve(64)
    with pytest.raises(RuntimeError, match="different shapes or dtypes"):
        ws.prepare(torch.zeros(4))
    with pytest.raises(RuntimeError, match="different shapes or dtypes.*broken"):
        ws.prepare(torch.zeros(4))
    ws.close()
    assert ws.releases == 0 and ws.barriers == 0 and ws.pointers is None


def test_growth_raises_when_the_ranks_disagree():
    """A growth exchange that finds another stamp raises on this rank (every
    rank finds it), and one that fails (a rank that does not come) raises;
    either breaks the workspace."""
    ws = _FakeWorkspace(world=2, stamps=[(8, 0, 0, 0)])
    with pytest.raises(ValueError, match="different shapes or dtypes"):
        ws.prepare(torch.zeros(4))
    assert ws.broken and ws.allocations == []
    ws = _FakeWorkspace(world=2, stamps=TimeoutError("no rank came"))
    with pytest.raises(RuntimeError, match="control-group exchange failed"):
        ws.prepare(torch.zeros(4))
    assert ws.broken and ws.allocations == []


def test_only_the_stamp_exchange_is_bounded_over_gloo():
    """Over real Gloo control groups (world 2), with a 1 s bound on the
    stamp exchange: a rank that reaches the handle exchange or the teardown
    barrier 2.5 s after the other does not break the workspace."""
    res = comm.spmd(workers.late_rank_after_the_stamps, 1.0, 2.5, world=2, device="cpu",
                    timeout=120)
    assert res["grew"].tolist() == [True, True] and res["freed"].tolist() == [True, True], res
    assert res["broken"].tolist() == [False, False], res
    assert float(res["waited"][0]) > 2.0, res


def test_growth_exchange_is_bounded_over_gloo():
    """Over a real Gloo control group (world 2): ranks that grow for
    different stamps both raise; a growth that only rank 0 makes raises on
    rank 0 after the control group's bound instead of hanging."""
    timeout = 2.0
    res = comm.spmd(workers.growth_disagreements, timeout, world=2, device="cpu", timeout=120)
    assert all("different shapes or dtypes" in m for m in res["different"]), res
    assert res["different_broken"].tolist() == [True, True]
    assert "control-group exchange failed" in res["alone"][0] and res["alone"][1] == ""
    assert res["alone_broken"].tolist() == [True, False]
    assert timeout - 0.5 < float(res["alone_seconds"][0]) < timeout + 10
