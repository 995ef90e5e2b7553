"""All-reduce demo and bandwidth benchmark.

    python -m tpu_dist_torch.demos.allreduce [--world 4] [--device cuda|cpu]
                                             [--bench [ITERS]] [--mib 16]

The port of ``demos/allreduce.py``: four rounds of ``t = all_reduce(t)``
from ones multiply by the world size each round, so every rank ends with
``world**4``; the same four rounds through the chunked ring
(`parallel.ring_all_reduce_chunked`) and through the ring kernel
(`ops.ring_all_reduce_pallas`) must agree elementwise.  ``--bench`` times
``all_reduce``, the naive ring (`parallel.ring_all_reduce`) and the ring
kernel on a float32 payload of ``--mib`` MiB (2^20 bytes, as
``chip_smoke.py``'s ``[ring]``) and reports bus GB/s
(`train.metrics.allreduce_gbps`) from the slowest rank's time; on the card
it also traces the ring kernel (`ops.checks.trace_ring_calls`): its own
device time per launch, the card's idle time between launches, the host's
time per call, the control-group collectives per call, and where each
block's time goes (waiting for arrivals, waiting for a free slot, moving
data).

Every rank is a process started by `comm.spmd`.  With a card per rank the
group is NCCL; ranks that share a card run over the Gloo control group, so
there `all_reduce` and the naive ring go through Gloo and the host.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from tpu_dist_torch import comm, ops, parallel
from tpu_dist_torch.ops.checks import trace_ring_calls
from tpu_dist_torch.train.metrics import allreduce_gbps


def run_known_answer(device_type: str):
    ones = torch.ones(2, 2, device=device_type)
    t_builtin, t_ring, t_kernel = ones.clone(), ones.clone(), ones.clone()
    for _ in range(4):
        t_builtin = comm.all_reduce(t_builtin.clone())
        t_ring = parallel.ring_all_reduce_chunked(t_ring)
        t_kernel = ops.ring_all_reduce_pallas(t_kernel)
    ops.synchronize()
    return (t_builtin[0, 0], t_ring[0, 0], t_kernel[0, 0],
            (t_builtin - t_ring).abs().max(), (t_builtin - t_kernel).abs().max())


def _seconds_per_call(fn, x: torch.Tensor, iters: int) -> float:
    """Mean seconds per call on this rank, after a warm-up and a barrier:
    CUDA events on the card, the host clock on the CPU."""
    fn(x)
    ops.synchronize()
    comm.barrier()
    if x.is_cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(x)
        end.record()
        ops.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    return (time.perf_counter() - t0) / iters


BENCH_PATHS = {
    "all_reduce": comm.all_reduce,
    "ring": parallel.ring_all_reduce,
    "ring_kernel": ops.ring_all_reduce_pallas,
}


def run_bench(device_type: str, n: int, iters: int):
    x = torch.arange(n, dtype=torch.float32, device=device_type)
    seconds = {name: _seconds_per_call(fn, x, iters) for name, fn in BENCH_PATHS.items()}
    if x.is_cuda:
        seconds.update(trace_ring_calls(x, iters))
    return seconds


def bench(world: int, device: str, mib: float, iters: int) -> dict:
    """Bus GB/s of each path, from the slowest rank's seconds per call."""
    n = int(mib * 2**20 / 4)
    seconds = comm.spmd(run_bench, device, n, iters, world=world, device=device)
    results = {}
    for name in BENCH_PATHS:
        dt = float(seconds[name].max())
        results[name] = allreduce_gbps(n * 4, dt, world)
        print(f"{name}: {n * 4 / 2**20:.1f} MiB all-reduce over {world} ranks: "
              f"{dt * 1e3:.4f} ms -> {results[name]:.3f} GB/s bus bandwidth on {device}")
    if "kernel_ms" in seconds:
        traced = {key: float(seconds[key].max())
                  for key in ("kernel_ms", "gap_ms", "host_ms", "control_per_call")}
        traced["kernel_gbps"] = allreduce_gbps(n * 4, traced["kernel_ms"] / 1e3, world)
        traced["phase_ms"] = {key: float(v.max()) for key, v in seconds["phase_ms"].items()}
        print(f"ring_kernel traced over {iters} calls, slowest rank: "
              f"{traced['kernel_ms']:.4f} ms per launch on the card "
              f"({traced['kernel_gbps']:.3f} GB/s bus bandwidth for the kernel alone), the "
              f"card idle {traced['gap_ms']:.4f} ms between launches, the host "
              f"{traced['host_ms']:.4f} ms per call (both slowed by the profiler), "
              f"{traced['control_per_call']:g} control-group collectives per call; per "
              f"launch, a block's thread 0 (mean over blocks, slowest rank) waited "
              f"{traced['phase_ms']['wait_arrival']:.4f} ms for arrivals and "
              f"{traced['phase_ms']['wait_free']:.4f} ms for free slots, and moved data for "
              f"{traced['phase_ms']['move']:.4f} ms")
        results["ring_kernel_traced"] = traced
    return results


def main(argv: list[str] | None = None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=4, help="number of ranks")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--bench", type=int, nargs="?", const=20, default=0,
                        help="run the bandwidth benchmark with this many calls per path")
    parser.add_argument("--mib", type=float, default=16.0,
                        help="payload in MiB (2^20 bytes) for --bench")
    parser.add_argument("--compress", default="",
                        help="compressed all-reduce wire (not ported yet)")
    args = parser.parse_args(argv)
    if args.compress:
        sys.exit("allreduce --compress waits for the port of comm/compress.py (ROADMAP "
                 "queue 1, item 10); nothing was run")
    builtin, ring, kernel, d_ring, d_kernel = comm.spmd(
        run_known_answer, args.device, world=args.world, device=args.device)
    w = args.world
    for r in range(w):
        print(f"Rank {r} after 4 rounds: all_reduce={float(builtin[r]):.0f} "
              f"ring={float(ring[r]):.0f} kernel={float(kernel[r]):.0f} "
              f"(expect {w}^4={w**4}), max|all_reduce-ring|={float(d_ring[r]):.2e}, "
              f"max|all_reduce-kernel|={float(d_kernel[r]):.2e}")
    if args.bench:
        if w < 2:
            print("allreduce --bench needs world >= 2: with one rank there is no "
                  "traffic between ranks to measure — skipping")
            return {}
        return bench(w, args.device, args.mib, args.bench)
    return {}


if __name__ == "__main__":
    main()
