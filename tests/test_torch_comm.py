"""The port's process-group plumbing: the backend rule and `comm.spmd`.

`choose_backend` is a pure function: NCCL for a CUDA world unless this host
is known to run more ranks than it has cards (then Gloo carries control),
Gloo on the CPU.  `spmd` is held to the JAX package's contract (results
stacked on a leading world axis) and to its own: a rank that raises makes
it raise with that rank's traceback, a rank that hangs is killed, and
worlds started at once each get their own store (the parent binds it, so
no world can take another's port).
"""

import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from tests import torch_collective_workers as collective_workers
from tests import torch_ring_workers as workers
from tpu_dist_torch import comm


@pytest.mark.parametrize(
    "device_type, world, local_world, cards, backend, control_only",
    [
        ("cuda", 8, None, 4, "nccl", False),  # multi-host launch, one card per rank
        ("cuda", 8, 8, 4, "gloo", True),  # LOCAL_WORLD_SIZE above the card count
        ("cuda", 4, 4, 1, "gloo", True),  # comm.spmd's four ranks on one card
        ("cuda", 4, 4, 4, "nccl", False),  # comm.spmd with a card per rank
        ("cpu", 4, 4, 0, "gloo", False),
    ],
    ids=["no-local-size", "local-above-cards", "spmd-one-card", "spmd-card-each", "cpu"],
)
def test_choose_backend(device_type, world, local_world, cards, backend, control_only):
    choice = comm.choose_backend(device_type, world, local_world, cards)
    assert (choice.backend, choice.control_only) == (backend, control_only)
    assert choice.reason


def test_spmd_stacks_every_rank_on_a_leading_axis():
    ids, extra = comm.spmd(workers.probe, 0.5, world=3, device="cpu")
    assert ids.tolist() == [[0, 3], [1, 3], [2, 3]]
    assert extra["half"].tolist() == [0.0, 0.5, 1.0]
    assert extra["tag"] == ["rank 0", "rank 1", "rank 2"]


def test_eight_spmd_worlds_at_once_each_answer_their_own_ranks():
    """Eight worlds of two ranks started together from a thread pool: every
    rank sees its own world's size and rank, and an all-reduce that only
    its own world's ranks can answer (tag * 200 + 1)."""
    def world(tag):
        return comm.spmd(collective_workers.concurrent_world, tag, world=2, device="cpu",
                         timeout=240)

    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(world, range(8), timeout=300))
    for tag, out in enumerate(outs):
        assert out.tolist() == [[0, 2, tag * 200 + 1], [1, 2, tag * 200 + 1]], (tag, out)


def test_worlds_that_run_no_collective_tear_down_together():
    """Twelve worlds of three ranks, six at a time, whose function runs no
    collective: a rank done first waits at the launcher's barrier before it
    closes its connections, so no peer's Gloo connect finds a socket closed
    ("connectFullMesh failed ... Connection closed by peer")."""
    def world(_):
        return comm.spmd(workers.probe, 0.5, world=3, device="cpu", timeout=240)

    with ThreadPoolExecutor(6) as pool:
        outs = list(pool.map(world, range(12), timeout=300))
    for ids, extra in outs:
        assert ids.tolist() == [[0, 3], [1, 3], [2, 3]]
        assert extra["tag"] == ["rank 0", "rank 1", "rank 2"]


def test_spmd_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 raised:(.|\n)*gives up on purpose"):
        comm.spmd(workers.fail_on_rank_1, world=2, device="cpu")


def test_spmd_kills_a_rank_that_hangs():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"rank\(s\) \[1\]"):
        comm.spmd(workers.hang_on_rank_1, world=2, device="cpu", timeout=8)
    assert time.monotonic() - t0 < 60


def test_spmd_refuses_a_card_it_does_not_have(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        comm.spmd(workers.probe, 1.0, world=2)


@pytest.mark.parametrize("op", [comm.ReduceOp.SUM, comm.ReduceOp.AVG], ids=["sum", "avg"])
def test_all_reduce_without_a_process_group_is_a_world_of_one(op):
    """Without a process group `all_reduce` runs a world of one, as `rank`
    and `world_size` do, and as the JAX package's all_reduce at world 1:
    the input comes back unchanged, SUM and AVG alike."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4) - 5.5
    want = x.clone()
    out = comm.all_reduce(x, op)
    assert out is x
    assert torch.equal(out, want)
    assert (comm.rank(), comm.world_size()) == (0, 1)
