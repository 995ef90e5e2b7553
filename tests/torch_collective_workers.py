"""The port's side of the collectives, launcher and gradient-reduction
parity tests: the cases, their inputs from a seed, and the functions every
spawned rank runs.

Imported by the parent test process and by every rank `comm.spmd` and
`comm.launch` spawn, so it imports neither jax nor the JAX package.  The
JAX side of the same cases is in test_torch_collectives.py and
test_torch_trainer.py.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from tpu_dist_torch import comm, models
from tpu_dist_torch.train import TrainConfig, Trainer

SEED = 11
OPS = ("sum", "product", "max", "min")


def groups(n: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The two groups every world builds, in this order: {0, 2} (rank 1
    alone at world 2) and {1, n - 1} (the whole world at 2)."""
    return ((0, 2) if n > 2 else (1,)), ((1, n - 1) if n > 2 else (0, 1))


def cases(n: int) -> dict[str, tuple[str, np.ndarray, str, dict]]:
    """name -> (function, stacked inputs (n, ...) for every rank, dtype,
    keyword arguments; ``group`` is an index into `groups`)."""
    rng = np.random.default_rng(SEED + n)
    g0, g1 = groups(n)

    def f32(*shape):
        return (rng.standard_normal((n, *shape)) * 2).astype(np.float32)

    def i32(*shape):  # small: an int32 product of n of them stays exact
        return rng.integers(-9, 10, (n, *shape)).astype(np.int32)

    out = {}
    for op in OPS:
        for dtype, make in (("float32", f32), ("int32", i32)):
            out[f"all_reduce_{op}_{dtype}"] = ("all_reduce", make(3, 2), dtype, {"op": op})
            out[f"all_reduce_{op}_{dtype}_group0"] = (
                "all_reduce", make(5), dtype, {"op": op, "group": 0})
        out[f"all_reduce_{op}_float32_group1"] = (
            "all_reduce", f32(4), "float32", {"op": op, "group": 1})
    out["all_reduce_avg_float32"] = ("all_reduce", f32(6), "float32", {"op": "avg"})
    out["all_reduce_avg_float32_group1"] = (
        "all_reduce", f32(6), "float32", {"op": "avg", "group": 1})
    for end, dst in (("first", 0), ("last", n - 1)):
        out[f"reduce_sum_to_{end}"] = ("reduce", f32(7), "float32", {"op": "sum", "dst": dst})
        out[f"reduce_max_int32_to_{end}"] = ("reduce", i32(7), "int32",
                                             {"op": "max", "dst": dst})
        out[f"broadcast_from_{end}"] = ("broadcast", f32(2, 3), "float32", {"src": dst})
        out[f"broadcast_int32_from_{end}"] = ("broadcast", i32(4), "int32", {"src": dst})
        out[f"gather_to_{end}"] = ("gather", f32(3), "float32", {"dst": dst})
        out[f"gather_ones_to_{end}"] = ("gather", np.ones((n, 1), np.float32), "float32",
                                        {"dst": dst})
        out[f"scatter_from_{end}"] = ("scatter", f32(n, 3), "float32", {"src": dst})
    out["reduce_product_group0"] = ("reduce", f32(4), "float32",
                                    {"op": "product", "dst": g0[-1], "group": 0})
    out["reduce_min_int32_group1"] = ("reduce", i32(4), "int32",
                                      {"op": "min", "dst": g1[0], "group": 1})
    out["broadcast_group0"] = ("broadcast", f32(3), "float32", {"src": g0[0], "group": 0})
    out["broadcast_group1"] = ("broadcast", i32(3), "int32", {"src": g1[-1], "group": 1})
    out["all_gather"] = ("all_gather", f32(2, 3), "float32", {})
    out["all_gather_int32"] = ("all_gather", i32(3), "int32", {})
    out["all_gather_axis1"] = ("all_gather", f32(2, 3), "float32", {"axis": 1})
    out["all_gather_tiled"] = ("all_gather", f32(2, 3), "float32", {"tiled": True})
    out["all_gather_group0"] = ("all_gather", f32(3), "float32", {"group": 0})
    out["all_gather_group1"] = ("all_gather", i32(2, 2), "int32", {"group": 1})
    out["gather_group0"] = ("gather", f32(3), "float32", {"dst": g0[0], "group": 0})
    out["gather_group1"] = ("gather", i32(3), "int32", {"dst": g1[-1], "group": 1})
    out["scatter_group0"] = ("scatter", f32(len(g0), 2), "float32", {"src": g0[-1], "group": 0})
    out["scatter_group1"] = ("scatter", i32(len(g1), 3), "int32", {"src": g1[0], "group": 1})
    for op in OPS:
        out[f"reduce_scatter_{op}"] = ("reduce_scatter", f32(2 * n, 3), "float32", {"op": op})
    out["reduce_scatter_sum_axis1"] = ("reduce_scatter", f32(3, 2 * n), "float32",
                                       {"op": "sum", "scatter_axis": 1})
    out["reduce_scatter_max_int32"] = ("reduce_scatter", i32(n, 2), "int32", {"op": "max"})
    out["all_to_all"] = ("all_to_all", f32(2 * n, 3), "float32",
                         {"split_axis": 0, "concat_axis": 0})
    out["all_to_all_int32_1_to_0"] = ("all_to_all", i32(2, 2 * n), "int32",
                                      {"split_axis": 1, "concat_axis": 0})
    out["all_to_all_0_to_1"] = ("all_to_all", f32(n, 3), "float32",
                                {"split_axis": 0, "concat_axis": 1})
    return out


def refusals(n: int) -> dict[str, tuple[str, dict, tuple]]:
    """name -> (function, keyword arguments, input shape): calls that every
    rank refuses before any message moves."""
    g0, _ = groups(n)
    outside = next(r for r in range(n) if r not in g0)
    return {
        "reduce_root_out_of_range": ("reduce", {"dst": n}, (2,)),
        "broadcast_root_out_of_range": ("broadcast", {"src": -1}, (2,)),
        "gather_root_out_of_range": ("gather", {"dst": n + 3}, (2,)),
        "reduce_dst_outside_group": ("reduce", {"dst": outside, "group": 0}, (2,)),
        "broadcast_src_outside_group": ("broadcast", {"src": outside, "group": 0}, (2,)),
        "gather_dst_outside_group": ("gather", {"dst": outside, "group": 0}, (2,)),
        "scatter_src_outside_group": ("scatter", {"src": outside, "group": 0}, (len(g0), 2)),
        "scatter_chunk_count": ("scatter", {"src": 0}, (n + 1, 2)),
        "scatter_chunk_count_group": ("scatter", {"src": g0[0], "group": 0}, (n, 2)),
        "all_gather_group_tiled": ("all_gather", {"tiled": True, "group": 0}, (2,)),
        "reduce_scatter_indivisible": ("reduce_scatter", {}, (n + 1,)),
        "all_to_all_indivisible": ("all_to_all", {"split_axis": 0, "concat_axis": 0},
                                   (n + 1,)),
    }


def apply(fn: str, x: torch.Tensor, kw: dict, made: tuple) -> torch.Tensor:
    """One case on this rank: ``made`` holds the `groups` as `comm.Group`s."""
    kw = dict(kw)
    if "op" in kw:
        kw["op"] = getattr(comm.ReduceOp, kw["op"].upper())
    if "group" in kw:
        kw["group"] = made[kw["group"]]
    if fn == "all_reduce":
        return comm.all_reduce(x.clone(), **kw)
    if fn == "reduce":
        return comm.reduce(x.clone(), kw.pop("dst"), **kw)
    if fn == "broadcast":
        return comm.broadcast(x.clone(), kw.pop("src"), **kw)
    if fn == "gather":
        return comm.gather(x, kw.pop("dst"), **kw)
    if fn == "scatter":
        return comm.scatter(x, kw.pop("src"), **kw)
    return getattr(comm, fn)(x, **kw)


def run_all(device_type: str = "cpu") -> dict:
    """One rank: the groups, then every case on this rank's slice of the
    inputs, then every refusal's message."""
    n, r = comm.world_size(), comm.rank()
    made = tuple(comm.new_group(g) for g in groups(n))  # every rank, in this order
    results = {}
    for name, (fn, table, dtype, kw) in cases(n).items():
        x = torch.from_numpy(table[r]).to(device_type)
        results[name] = apply(fn, x, kw, made)
    for name, (fn, kw, shape) in refusals(n).items():
        try:
            apply(fn, torch.zeros(shape, device=device_type), kw, made)
            results[name] = "no error"
        except ValueError as e:
            results[name] = f"ValueError: {e}"
    comm.barrier()
    return results


# ------------------------------------------------- the launcher's workers


def rank_and_sum(rank: int, world: int) -> dict:
    """The process-group rank `launch` passes, the group's, and an
    all-reduce of ones."""
    return {"rank": rank, "dist_rank": dist.get_rank(), "world": world,
            "sum": float(comm.all_reduce(torch.ones(1)).item()),
            "attempt": int(os.environ.get("TORCHELASTIC_RESTART_COUNT", "-1"))}


def fail_on_rank_1_first_attempt(rank: int, world: int) -> float:
    """Rank 1 of attempt 0 raises; every later attempt all-reduces ones."""
    if rank == 1 and os.environ.get("TORCHELASTIC_RESTART_COUNT") == "0":
        raise RuntimeError("rank 1 fails attempt 0 on purpose")
    return float(comm.all_reduce(torch.ones(1)).item())


def fail_on_rank_1(rank: int, world: int) -> float:
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(60)  # held without the fail-stop
    return 0.0


def concurrent_world(tag: int) -> torch.Tensor:
    """A rank of one of many worlds started at once: its rank, the world
    size, and an all-reduce that only this world's ranks can answer."""
    r, n = comm.rank(), comm.world_size()
    total = comm.all_reduce(torch.tensor([float(tag * 100 + r)]))
    return torch.tensor([r, n, total.item()])


# ------------------------------------------------- the Trainer's reduction


def trainer_steps(state: dict, batches: list, backends: tuple[str, ...],
                  accum_steps: int = 1) -> dict:
    """For each gradient reduction in ``backends``, a Trainer of the ConvNet
    (dropout off, ``accum_steps`` microbatches) from ``state`` takes one
    step on this rank's rows of each global batch (rank-major halves, as
    the JAX package shards a batch); returns, per backend, the losses, the
    params and the momentum buffers."""
    n, r = comm.world_size(), comm.rank()
    out = {}
    for backend in backends:
        net = models.mnist_net()
        for layer in net:
            if hasattr(layer, "rate"):
                layer.rate = 0.0
        net.load_state_dict(state)
        trainer = Trainer(net, TrainConfig(grad_reduce=backend, accum_steps=accum_steps,
                                           log=lambda line: None), device="cpu")
        losses = []
        for x, y in batches:
            rows = slice(r * len(x) // n, (r + 1) * len(x) // n)
            losses.append(trainer.train_step(torch.from_numpy(x[rows]),
                                             torch.from_numpy(y[rows])))
        out[backend] = {
            "losses": torch.stack(losses),
            "params": trainer.model.state_dict(),
            "momentum": {name: trainer.optimizer.state[p]["momentum_buffer"]
                         for name, p in trainer.model.named_parameters()},
        }
    return out


def guarded_steps() -> dict:
    """The ConvNet Trainer (dropout off) under ``nan_guard`` with
    ``loss_scale=256``: one good step, one where rank 1 alone has a NaN in
    its batch, one good step."""
    r = comm.rank()
    net = models.mnist_net(torch.Generator().manual_seed(0))
    for layer in net:
        if hasattr(layer, "rate"):
            layer.rate = 0.0
    trainer = Trainer(net, TrainConfig(nan_guard=True, loss_scale=256.0,
                                       log=lambda line: None), device="cpu")
    gen = torch.Generator().manual_seed(SEED + r)
    x = torch.randn(8, 28, 28, 1, generator=gen)
    y = torch.arange(8) % 10
    trainer.train_step(x, y)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    bad = x.clone()
    if r == 1:
        bad[0, 0, 0, 0] = float("nan")
    trainer.train_step(bad, y)
    unchanged = all(torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())
    bad_steps, scale = int(trainer.opt_state["bad_steps"]), float(trainer.opt_state["scale"])
    trainer.train_step(x, y)
    moved = not any(torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())
    return {"bad_steps": bad_steps, "scale": scale, "unchanged_after_bad": unchanged,
            "moved_after_good": moved, "params": trainer.model.state_dict()}


def image_trainer_steps(state: dict, batches: list, backends: tuple[str, ...]) -> dict:
    """For each gradient reduction in ``backends``, a Trainer of ResNet-18
    (CIFAR stem; cross-entropy, lr 0.05, momentum 0.9) from ``state``, its
    parameters and batch-norm statistics, takes one step on this rank's
    rows of each global batch; returns, per backend, the losses and the
    final parameters and buffers.  The model takes ``state``'s dtype."""
    from tpu_dist_torch import nn

    n, r = comm.world_size(), comm.rank()
    out = {}
    for backend in backends:
        net = models.resnet18().to(next(iter(state.values())).dtype)
        net.load_state_dict(state)
        trainer = Trainer(net, TrainConfig(grad_reduce=backend, lr=0.05, momentum=0.9,
                                           log=lambda line: None),
                          device="cpu", loss=nn.cross_entropy)
        losses = []
        for x, y in batches:
            rows = slice(r * len(x) // n, (r + 1) * len(x) // n)
            losses.append(trainer.train_step(torch.from_numpy(x[rows]),
                                             torch.from_numpy(y[rows])))
        out[backend] = {"losses": torch.stack(losses), "state": trainer.model.state_dict()}
    return out
