"""Checks of the kernels against their plain versions on the card.

One copy of each check, called by the card tests (`tests/test_torch_cuda.py`)
and by ``chip_smoke.py``:

- `check_flash_kernels`: the flash kernels of the route `flash_route`
  names (tensor-core forward, dK/dV and dQ for bfloat16 and float16 at
  d = 64 and 128, SIMT otherwise) against their plain versions on given
  inputs (any head dim up to 256, float32, bfloat16 or float16), with the
  launch counts that show which kernels ran and the counts of dK and dQ
  elements that differ at all;
- `check_flash_past_2_31`: the flash kernels on (bh, S, d) arrays of more
  than 2^31 elements, held to the plain version on the heads that lie past
  2^31;
- `check_ring`: the ring kernel under `comm.spmd` at a world of ranks on
  the card, bit for bit against `ring_all_reduce_reference` in float32,
  bfloat16, float16 and int32, ragged sizes, 100 calls back to back and a
  workspace that grows and is reused, every rank's output the same bits;
  optionally one timed and traced call size, whose output is held to the
  plain version too (`trace_ring_calls` gives the kernel's own device time,
  its phases and the control-group collectives per call);
- `check_ring_stuck_neighbour`: a neighbour whose kernel cannot start makes
  the call raise within the kernel's bound, on both ranks;
- `check_ring_mismatch`: ranks that pass another numel or dtype, or that
  disagree about growing the workspace, raise on both ranks within the
  bound;
- `check_dp`: the MNIST Trainer at world 2 on the card under
  ``grad_reduce="ring"`` (`average_gradients` takes the ring kernel once
  per gradient and once for the loss each step) equal bit for bit to
  ``"psum"``, with no control-group collective after the first step, and
  a traced run of a few more ring steps (`trace_dp_steps`);
- `check_image_dp`: the ResNet-18 Trainer at a world of ranks under
  ``"psum"``: the batch-norm statistics ride the gradients' all-reduce, and
  every rank ends with the same bits in every parameter and buffer;
- `check_collectives`: every collective of `comm` on ranks sharing the card
  against its plain version on the stacked inputs;
- `check_launch_restart`: `comm.launch` through a ``file://`` store returns
  on attempt 1 after rank 1 fails attempt 0;
- `check_moe_ep`: ``LMTrainer(moe=True)`` at a world of ranks, every rank
  the same bits, optionally held to a reference's parameters, with its
  all_to_all calls, dropped fractions and launch counts, and optionally
  one traced step (`trace_step`);
- `check_moe_card_against_cpu`: a small MoE LM's step on the card against
  the CPU, and its cached prefill against its forward;
- `check_seq_all_to_all`: ``all_to_all`` over a mesh axis on CUDA tensors,
  and its gradient, against the plain version;
- `check_seq_parallel`: ``LMTrainer(sequence_parallel="ulysses"|"ring")``
  on a (data, seq) mesh of ranks, every rank the same bits, optionally
  held to a reference's parameters, with its all_to_all and sendrecv
  calls, launch counts and peak memory, and optionally one traced step
  (`trace_step`);
- `check_ring_attention`: ``ring_attention_flash`` at a world of ranks
  sharing the card against ``ring_attention``, dense attention on the
  gathered sequence and optionally its plain blocks on the CPU, its
  gradient the dense ring's bits, its forward launches a call;
  `check_seq_ring` runs those cases, the full LM's
  ``apply_seq_parallel(flash=True)`` in eval and greedy
  ``generate_seq_parallel`` in one spawned world.

Each raises AssertionError when a check fails (also under ``python -O``)
and returns what it measured.  Nothing here runs without a card.
"""

from __future__ import annotations

import hashlib
import importlib
import time

import torch

from tpu_dist_torch import comm
from tpu_dist_torch.ops import pallas_ring

fa = importlib.import_module("tpu_dist_torch.ops.flash_attention")

FLASH_TOL = {
    torch.float32: dict(rtol=1e-4, atol=1e-4),  # float32 sums in another order
    torch.bfloat16: dict(rtol=1e-2, atol=1e-2),  # one bf16 rounding of the output
    torch.float16: dict(rtol=2e-3, atol=2e-3),  # one f16 rounding of the output
}


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def flash_inputs(bh: int, S: int, d: int, dtype, device, seed: int = 0) -> list[torch.Tensor]:
    """q, k, v and a cotangent dO, (bh, S, d), standard normal from ``seed``."""
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn(bh, S, d, generator=g, device=device, dtype=torch.float32).to(dtype)
            for _ in range(4)]


def _differing(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a != b).sum().item())


def _launch_counts() -> dict:
    return {kernel.__name__: kernel.launches for kernel in fa.KERNELS}


def _require_route(before: dict, route: str) -> None:
    """Since ``before``, the forward, dK/dV and dQ wrappers of ``route`` each
    launched one kernel, and no other wrapper launched any."""
    ran = {f"flash_fwd_{route}", f"flash_dkv_{route}", f"flash_dq_{route}"}
    want = {name: n + (name in ran) for name, n in before.items()}
    got = _launch_counts()
    _require(got == want, f"flash launches {got}, expected {want} (route {route})")


def check_flash_kernels(q, k, v, go, *, causal: bool, window: int | None,
                        exact_dk: bool = False, exact_dq: bool = False) -> dict:
    """Forward (out, lse), dK/dV and dQ against the plain versions, the
    backward kernels fed the plain forward's lse and D = rowsum(dO * out);
    the route's forward, dK/dV and dQ wrappers each launched once, no other
    wrapper.  Returns the route, the plain lse and D (for timing) and,
    per kernel, the max |difference|; ``dk_differing`` and ``dq_differing``
    count dK and dQ elements that differ at all, and ``exact_dk`` and
    ``exact_dq`` require them to be 0: in float32 the kernels sum dS^T Q in
    query order and dS K in key order, each with one FMA accumulator, and
    scale once after the sum, which equals the plain version bit for bit
    wherever its product is one in-order sum too (short S; cuBLAS splits
    long sums)."""
    kw = dict(causal=causal, window=window)
    route = fa.flash_route(q.dtype, q.shape[-1])
    counts = _launch_counts()
    out, lse = fa.flash_fwd(q, k, v, **kw)
    want_out, want_lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = (go.float() * want_out.float()).sum(-1)
    dk, dv = fa.flash_dkv(q, k, v, go, want_lse, delta, **kw)
    dq = fa.flash_dq(q, k, v, go, want_lse, delta, **kw)
    torch.cuda.synchronize()
    _require_route(counts, route)
    want_dk, want_dv = fa.flash_dkv_reference(q, k, v, go, want_lse, delta, **kw)
    want_dq = fa.flash_dq_reference(q, k, v, go, want_lse, delta, **kw)
    tol = FLASH_TOL[q.dtype]
    pairs = {"flash_fwd": [(out, want_out), (lse, want_lse)],
             "flash_dkv": [(dk, want_dk), (dv, want_dv)],
             "flash_dq": [(dq, want_dq)]}
    errs = {}
    for name, checks in pairs.items():
        for got, want in checks:
            _require(got.dtype == want.dtype, f"{name} returned {got.dtype}, not {want.dtype}")
            torch.testing.assert_close(got, want, **(FLASH_TOL[torch.float32]
                                                      if got is lse else tol))
        errs[name] = max((g.float() - w.float()).abs().max().item() for g, w in checks)
    dk_differing, dq_differing = _differing(dk, want_dk), _differing(dq, want_dq)
    _require(not exact_dk or dk_differing == 0, f"{dk_differing} dK elements differ")
    _require(not exact_dq or dq_differing == 0, f"{dq_differing} dQ elements differ")
    return {"max_abs_err": errs, "tol": tol, "dk_differing": dk_differing,
            "dq_differing": dq_differing, "lse": want_lse, "delta": delta, "route": route}


def check_flash_past_2_31(device, *, S: int = 256, d: int = 128, heads_checked: int = 2) -> dict:
    """bfloat16 causal (bh, S, d) with bh * S * d just past 2^31: all three
    kernels of the route (at d = 128 the tensor-core forward, dK/dV and dQ,
    whose TMA coordinates are (d, S, bh)) run on the whole array, and the
    last ``heads_checked`` heads, which start past element 2^31, are held to
    the plain version."""
    bh = 2**31 // (S * d) + heads_checked
    dtype = torch.bfloat16
    route = fa.flash_route(dtype, d)
    g = torch.Generator(device).manual_seed(5)
    q, k, v, go = (torch.randn(bh, S, d, generator=g, device=device, dtype=dtype)
                   for _ in range(4))
    counts = _launch_counts()
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    tail = slice(bh - heads_checked, bh)
    want_out, want_lse = fa.flash_fwd_reference(q[tail], k[tail], v[tail], causal=True)
    delta = torch.empty(bh, S, device=device)
    for c in range(0, bh, 8192):  # D = rowsum(dO * out), without float32 copies of both
        delta[c:c + 8192] = (go[c:c + 8192].float() * out[c:c + 8192].float()).sum(-1)
    dk, dv = fa.flash_dkv(q, k, v, go, lse, delta, causal=True)
    dq = fa.flash_dq(q, k, v, go, lse, delta, causal=True)
    torch.cuda.synchronize()
    _require_route(counts, route)
    args = (q[tail], k[tail], v[tail], go[tail], lse[tail], delta[tail])
    want_dk, want_dv = fa.flash_dkv_reference(*args, causal=True)
    want_dq = fa.flash_dq_reference(*args, causal=True)
    tol = FLASH_TOL[dtype]
    errs = {}
    for name, got, want in [("out", out[tail], want_out), ("lse", lse[tail], want_lse),
                            ("dk", dk[tail], want_dk), ("dv", dv[tail], want_dv),
                            ("dq", dq[tail], want_dq)]:
        torch.testing.assert_close(got, want, **(FLASH_TOL[torch.float32]
                                                  if name == "lse" else tol))
        errs[name] = (got.float() - want.float()).abs().max().item()
    first = (bh - heads_checked) * S * d
    _require(first >= 2**31, "the checked heads must start past element 2^31")
    return {"q": [bh, S, d], "dtype": "bfloat16", "causal": True, "route": route,
            "elements": bh * S * d,
            "checked_heads_start_at": first, "max_abs_err": errs, "tol": tol}


# ------------------------------------------------------------------ the ring

# (label, elements, dtype): the payloads each rank reduces, in this order
RING_CASES = [
    ("f32_8x128", (8, 128), torch.float32),
    ("f32_ragged", 1_000_003, torch.float32),
    ("bf16_ragged", 1_000_003, torch.bfloat16),
    ("f16_ragged", 1_000_003, torch.float16),
    ("i32_ragged", 1_000_003, torch.int32),
]
RING_BACK_TO_BACK = 100
RING_BACK_TO_BACK_ELEMENTS = 65_536
# growing, then shrinking (1, 10 and 20: the loss and the ConvNet's two
# smallest biases, each under one 16-byte vector a chunk), then growing again
RING_SIZES = [1_000, 100_000, 3_000_000, 50_000, 7, 1, 10, 20, 4_000_000]


def ring_payload(shape, dtype, rank: int, seed: int, device) -> torch.Tensor:
    """Rank ``rank``'s input: a ramp plus 1000 * rank, so that a dropped or
    doubled hop shows, plus seeded noise so that rounding shows."""
    g = torch.Generator(device).manual_seed(seed * 1000 + rank)
    numel = torch.Size(shape if isinstance(shape, tuple) else (shape,)).numel()
    ramp = torch.arange(numel, device=device, dtype=torch.float32) % 977
    if dtype == torch.int32:
        noise = torch.randint(-2**20, 2**20, (numel,), generator=g, device=device)
        x = ramp.to(torch.int32) + noise.to(torch.int32) + 1000 * rank
    else:
        x = (ramp + torch.randn(numel, generator=g, device=device) + 1000.0 * rank).to(dtype)
    return x.reshape(shape)


def _bits_differing(a: torch.Tensor, b: torch.Tensor) -> int:
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return int((a.view(view) != b.view(view)).sum().item())


def _digest(t: torch.Tensor) -> str:
    """A digest of ``t``'s bits, to compare ranks' outputs."""
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def _digests_agree(digests: dict, world: int) -> None:
    differing = [k for k, d in digests.items() if d != [d[0]] * world]
    _require(not differing, f"parameters whose bits differ between ranks: {differing[:5]} "
             f"({len(differing)} of {len(digests)})")


def _ring_rank(seed: int, time_mib: float, iters: int) -> dict:
    """One rank of `check_ring`.  Returns, per case, the elements that
    differ from the plain version and a digest of the output's bits, the
    workspace's growth and the launch count of the checks; with
    ``time_mib``, one float32 call of that size per rank: the time per
    call on the stream (``call_ms``, CUDA events around ``iters`` calls,
    the wrapper's host work included), the last call's output against the
    plain version (elements that differ, max |diff|, digest), the kernel's
    own time from a trace (`trace_ring_calls`) and, on rank 0, the plain
    version's time."""
    device = torch.device("cuda", torch.cuda.current_device())
    n, r = comm.world_size(), comm.rank()
    kernel, reference = pallas_ring.ring_all_reduce_pallas, pallas_ring.ring_all_reduce_reference
    kernel.launches = 0
    differing, digests = {}, {}
    for label, shape, dtype in RING_CASES:
        xs = torch.stack([ring_payload(shape, dtype, q, seed, device) for q in range(n)])
        out = kernel(xs[r])
        pallas_ring.synchronize()
        differing[label] = _bits_differing(out, reference(xs)[r])
        digests[label] = _digest(out)

    # back to back: no host sync until the last call
    xs = torch.stack([ring_payload(RING_BACK_TO_BACK_ELEMENTS, torch.float32, q, seed, device)
                      for q in range(n)])
    outs = [kernel(xs[r] * (i + 1)) for i in range(RING_BACK_TO_BACK)]
    pallas_ring.synchronize()
    label = f"{RING_BACK_TO_BACK} back to back"
    differing[label] = sum(
        _bits_differing(o, reference(xs * (i + 1))[r]) for i, o in enumerate(outs))
    digests[label] = _digest(torch.stack(outs))

    ws = pallas_ring.workspace(device)
    grows_before, largest = ws.grows, ws.capacity
    expected_grows = 0
    for i, numel in enumerate(RING_SIZES):
        xs = torch.stack([ring_payload(numel, torch.float32, q, seed + i, device)
                          for q in range(n)])
        out = kernel(xs[r])
        pallas_ring.synchronize()
        differing[f"size {numel}"] = _bits_differing(out, reference(xs)[r])
        digests[f"size {numel}"] = _digest(out)
        if numel * 4 > largest:
            expected_grows, largest = expected_grows + 1, numel * 4
    result = {"differing": differing, "digests": digests, "launches": kernel.launches,
              "grows": ws.grows - grows_before, "expected_grows": expected_grows,
              "capacity": ws.capacity, "largest": largest}

    if time_mib:
        numel = int(time_mib * 2**20 / 4)
        xs = torch.stack([ring_payload(numel, torch.float32, q, seed, device)
                          for q in range(n)])
        x = xs[r]
        kernel(x)  # grows the workspace and warms up
        pallas_ring.synchronize()
        comm.barrier()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            out = kernel(x)
        end.record()
        pallas_ring.synchronize()
        result["call_ms"] = start.elapsed_time(end) / iters
        expected = reference(xs)[r]
        result["timed_differing"] = _bits_differing(out, expected)
        result["timed_max_abs_err"] = float((out - expected).abs().max())
        result["timed_digest"] = _digest(out)
        del expected
        result.update(trace_ring_calls(x, iters))
        result["plain_ms"] = float("nan")
        if r == 0:  # alone on the card: the others wait at the barrier
            reference(xs)
            torch.cuda.synchronize()
            start.record()
            for _ in range(iters):
                reference(xs)
            end.record()
            torch.cuda.synchronize()
            result["plain_ms"] = start.elapsed_time(end) / iters
        comm.barrier()
    return result


def trace_ring_calls(x: torch.Tensor, iters: int) -> dict:
    """``iters`` calls of the ring kernel's wrapper on ``x`` under
    ``torch.profiler`` on this rank, after a warm-up call (which takes the
    profiler's start-up) and a barrier with the group: the device time of
    each launch (``kernel_ms``, its mean), the card's idle time between one
    launch's end and the next one's start on the stream (``gap_ms``, its
    mean: host work that the stream waits for), the host's time per call
    (``host_ms``; the profiler slows the host, so both are upper bounds)
    and the control-group collectives per call (``control_per_call``, 0
    once the workspace fits).  Then ``iters`` calls without the profiler
    that record the kernel's phases: per launch, the mean over blocks of
    the ms each block's thread 0 spent waiting for arrivals, waiting for a
    free slot and moving data (``phase_ms``), behind one unrecorded call
    that takes up the ranks' skew.  Raises if the trace does not hold one
    launch per call."""
    fn, kernel = pallas_ring.ring_all_reduce_pallas, "ring_kernel"
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ws = pallas_ring.workspace(x.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(x)
        pallas_ring.synchronize()
        comm.barrier()
        collectives = ws.collectives
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        host_s = time.perf_counter() - t0
        collectives = ws.collectives - collectives
        pallas_ring.synchronize()
    comm.barrier()
    launches = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA and kernel in e.name),
                      key=lambda e: e.time_range.start)
    _require(len(launches) == iters + 1,
             f"the trace holds {len(launches)} launches of {kernel}, not {iters + 1}")
    launches = launches[1:]  # the warm-up
    gaps = [b.time_range.start - a.time_range.end for a, b in zip(launches, launches[1:])]
    phases = torch.zeros(3 * ws.blocks, dtype=torch.int64, device=x.device)
    fn(x)  # takes up the ranks' skew at the start, so the recorded calls run back to back
    for _ in range(iters):
        pallas_ring.ring_all_reduce_traced(x, phases)
    pallas_ring.synchronize()
    comm.barrier()
    per_block = phases.view(ws.blocks, 3).double().mean(0) / iters / 1e6
    return {"kernel_ms": sum(e.time_range.elapsed_us() for e in launches) / iters / 1e3,
            "gap_ms": sum(gaps) / max(len(gaps), 1) / 1e3,
            "host_ms": host_s / iters * 1e3, "control_per_call": collectives / iters,
            "phase_ms": dict(zip(("wait_arrival", "wait_free", "move"), per_block.tolist()))}


def check_ring(world: int, *, seed: int = 0, time_mib: float = 0.0, iters: int = 20) -> dict:
    """The ring kernel at ``world`` ranks (processes) on the card: every
    case bit for bit equal to the plain version on every rank, every rank's
    output the same bits as rank 0's, one launch per call, the workspace
    grown exactly when a call was larger than any before it, and (with
    ``time_mib``) no control-group collective per timed call.  Returns the
    per-rank results."""
    res = comm.spmd(_ring_rank, seed, time_mib, iters, world=world, device="cuda")
    calls = len(RING_CASES) + RING_BACK_TO_BACK + len(RING_SIZES)
    for label, counts in res["differing"].items():
        _require(counts.tolist() == [0] * world, f"world {world}, {label}: elements that "
                 f"differ per rank {counts.tolist()}")
    digests = dict(res["digests"], **({"timed": res["timed_digest"]} if time_mib else {}))
    for label, per_rank in digests.items():
        _require(per_rank == [per_rank[0]] * world,
                 f"world {world}, {label}: the ranks' outputs differ from rank 0's")
    _require(res["launches"].tolist() == [calls] * world,
             f"launches per rank {res['launches'].tolist()}, not {calls}")
    _require(bool((res["grows"] == res["expected_grows"]).all()),
             f"workspace grew {res['grows'].tolist()} times, not {res['expected_grows'].tolist()}")
    _require(bool((res["capacity"] == res["largest"]).all()),
             f"workspace holds {res['capacity'].tolist()} bytes, not {res['largest'].tolist()}")
    if time_mib:
        _require(res["timed_differing"].tolist() == [0] * world,
                 f"world {world}, the timed {time_mib} MiB call: elements that differ "
                 f"per rank {res['timed_differing'].tolist()}")
        _require(res["control_per_call"].tolist() == [0.0] * world,
                 f"control-group collectives per timed call {res['control_per_call'].tolist()}")
    return res


RING_SMALL = (1, 10, 20)  # the loss and the ConvNet's two smallest biases
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32)


def _ring_small_rank(seed: int) -> dict:
    device = torch.device("cuda", torch.cuda.current_device())
    n, r = comm.world_size(), comm.rank()
    kernel, reference = pallas_ring.ring_all_reduce_pallas, pallas_ring.ring_all_reduce_reference
    differing = {}
    for numel in RING_SMALL:
        for dtype in _DTYPES:
            xs = torch.stack([ring_payload(numel, dtype, q, seed, device) for q in range(n)])
            out = kernel(xs[r])
            pallas_ring.synchronize()
            differing[f"{numel} {str(dtype)[6:]}"] = _bits_differing(out, reference(xs)[r])
    return differing


def check_ring_small(world: int, seed: int = 0) -> dict:
    """The ring kernel at `RING_SMALL` elements, where a chunk holds less
    than one 16-byte vector (or nothing), in every dtype: bit for bit equal
    to the plain version on every rank."""
    res = comm.spmd(_ring_small_rank, seed, world=world, device="cuda", timeout=300)
    for label, counts in res.items():
        _require(counts.tolist() == [0] * world,
                 f"world {world}, {label}: elements that differ per rank {counts.tolist()}")
    return {label: counts.tolist() for label, counts in res.items()}


def _stuck_rank(timeout: float) -> dict:
    """Rank 1 delays its stream past the bound before its second call, so
    rank 0's kernel waits for a neighbour that does not come.  Sets the
    kernel's bound to ``timeout`` in this worker process."""
    pallas_ring.TIMEOUT_S = timeout
    device = torch.device("cuda", torch.cuda.current_device())
    r = comm.rank()
    x = torch.ones(4096, device=device)
    pallas_ring.ring_all_reduce_pallas(x)
    pallas_ring.synchronize()  # the first call completes on both ranks
    comm.barrier()
    if r == 1:
        torch.cuda._sleep(int(2 * timeout * 2e9))  # about 2 timeouts at 2 GHz
    t0 = time.perf_counter()
    raised = ""
    try:
        pallas_ring.ring_all_reduce_pallas(x)
        pallas_ring.synchronize()
    except RuntimeError as e:
        raised = str(e)
    seconds = time.perf_counter() - t0
    again = ""
    try:  # a broken workspace refuses every later call
        pallas_ring.ring_all_reduce_pallas(x)
    except RuntimeError as e:
        again = str(e)
    return {"raised": int(bool(raised)), "again": int(bool(again)), "seconds": seconds,
            "message": raised}


def check_ring_stuck_neighbour(timeout: float = 2.0) -> dict:
    """World 2 on the card: both ranks' second call raises (rank 0 after
    about ``timeout``, rank 1 after its delay plus ``timeout``), later
    calls raise too, and nothing hangs."""
    res = comm.spmd(_stuck_rank, timeout, world=2, device="cuda", timeout=120)
    _require(res["raised"].tolist() == [1, 1], f"raised per rank: {res}")
    _require(res["again"].tolist() == [1, 1], f"a broken workspace took a call: {res}")
    _require(float(res["seconds"][0]) < 4 * timeout,
             f"rank 0 raised after {res['seconds'].tolist()} s, bound {timeout} s")
    return {"seconds": res["seconds"].tolist(), "message": res["message"][0]}


# What rank 0 and rank 1 pass after a 4096-element float32 call: another
# numel, another dtype (both fit the workspace: the kernel's stamp finds
# them), and a size only rank 1 must grow for (the growth exchange's bound
# ends rank 1's wait; rank 0's kernel times out).
RING_MISMATCHES = {
    "numel": ((4096, torch.float32), (4000, torch.float32)),
    "dtype": ((4096, torch.float32), (4096, torch.int32)),
    "growth": ((4096, torch.float32), (8192, torch.float32)),
}


def _mismatch_rank(kind: str, timeout: float) -> dict:
    """One rank of `check_ring_mismatch`; sets the kernel's and the growth
    exchange's bounds to ``timeout`` in this worker process."""
    pallas_ring.TIMEOUT_S = pallas_ring.CONTROL_TIMEOUT_S = timeout
    device = torch.device("cuda", torch.cuda.current_device())
    r = comm.rank()
    pallas_ring.ring_all_reduce_pallas(torch.ones(4096, device=device))
    pallas_ring.synchronize()
    comm.barrier()
    numel, dtype = RING_MISMATCHES[kind][r]
    t0 = time.perf_counter()
    raised = ""
    try:
        pallas_ring.ring_all_reduce_pallas(torch.ones(numel, device=device, dtype=dtype))
        pallas_ring.synchronize()
    except (RuntimeError, ValueError) as e:
        raised = str(e)
    seconds = time.perf_counter() - t0
    again = ""
    try:
        pallas_ring.ring_all_reduce_pallas(torch.ones(4096, device=device))
    except RuntimeError as e:
        again = str(e)
    return {"raised": int(bool(raised)), "again": int(bool(again)), "seconds": seconds,
            "message": raised}


def check_ring_mismatch(timeout: float = 2.0) -> dict:
    """World 2 on the card, a fresh world per case of `RING_MISMATCHES`:
    both ranks raise within ``timeout`` plus a margin (the numel and dtype
    cases with the kernel's mismatch error), later calls raise too, and
    nothing hangs."""
    out = {}
    for kind in RING_MISMATCHES:
        res = comm.spmd(_mismatch_rank, kind, timeout, world=2, device="cuda", timeout=120)
        _require(res["raised"].tolist() == [1, 1], f"{kind}: raised per rank: {res}")
        _require(res["again"].tolist() == [1, 1], f"{kind}: a broken workspace took a call: {res}")
        _require(max(res["seconds"].tolist()) < timeout + 5.0,
                 f"{kind}: raised after {res['seconds'].tolist()} s, bound {timeout} s")
        if kind != "growth":
            _require(all("different shapes or dtypes" in m for m in res["message"]),
                     f"{kind}: messages {res['message']}")
        out[kind] = {"seconds": res["seconds"].tolist(), "messages": res["message"]}
    return out


# ----------------------------------------------------------- the collectives

COLLECTIVE_OPS = ("SUM", "PRODUCT", "MAX", "MIN")


def collectives_group(n: int) -> tuple[int, ...]:
    """The sub-group `check_collectives` builds: {0, 2}, or rank 1 alone at
    world 2."""
    return (0, 2) if n > 2 else (1,)


def collective_cases(n: int, seed: int = 0) -> dict:
    """name -> (function, stacked inputs (n, ...) on the CPU, keyword
    arguments; ``group`` True for `collectives_group`)."""
    g = torch.Generator().manual_seed(1000 * seed + n)

    def f32(*shape):
        return torch.randn((n, *shape), generator=g) * 2

    def i32(*shape):  # small: an int32 product of n of them stays exact
        return torch.randint(-9, 10, (n, *shape), generator=g, dtype=torch.int32)

    cases = {}
    for op in COLLECTIVE_OPS:
        for label, make in (("f32", f32), ("i32", i32)):
            cases[f"all_reduce_{op}_{label}"] = ("all_reduce", make(1000), {"op": op})
            cases[f"all_reduce_{op}_{label}_group"] = ("all_reduce", make(1000),
                                                      {"op": op, "group": True})
    cases["reduce_SUM_to_last"] = ("reduce", f32(1000), {"op": "SUM", "dst": n - 1})
    cases["reduce_MAX_i32_to_first"] = ("reduce", i32(1000), {"op": "MAX", "dst": 0})
    cases["broadcast_from_last"] = ("broadcast", f32(1000), {"src": n - 1})
    cases["broadcast_i32_group"] = ("broadcast", i32(1000),
                                    {"src": collectives_group(n)[0], "group": True})
    cases["all_gather"] = ("all_gather", f32(333), {})
    cases["gather_ones_to_first"] = ("gather", torch.ones(n, 1), {"dst": 0})
    cases["scatter_from_first"] = ("scatter", f32(n, 77), {"src": 0})
    cases["reduce_scatter_SUM"] = ("reduce_scatter", f32(4 * n, 5), {"op": "SUM"})
    cases["all_to_all"] = ("all_to_all", f32(2 * n, 3), {"split_axis": 0, "concat_axis": 0})
    return cases


def collective_expected(fn: str, xs: torch.Tensor, kw: dict) -> torch.Tensor:
    """Every rank's output, stacked, from the stacked inputs: the plain
    version of the case."""
    n = xs.shape[0]
    reduce_ = {"SUM": lambda t: t.sum(0, dtype=t.dtype),
               "PRODUCT": lambda t: t.prod(0, dtype=t.dtype),
               "MAX": lambda t: t.amax(0), "MIN": lambda t: t.amin(0)}.get(kw.get("op"))
    members = list(collectives_group(n)) if kw.get("group") else list(range(n))
    out = []
    for r in range(n):
        if fn == "all_reduce":
            out.append(reduce_(xs[members]) if r in members else xs[r])
        elif fn == "reduce":
            out.append(reduce_(xs) if r == kw["dst"] else xs[r])
        elif fn == "broadcast":
            out.append(xs[kw["src"]] if r in members else xs[r])
        elif fn == "all_gather":
            out.append(xs)
        elif fn == "gather":
            out.append(xs if r == kw["dst"] else torch.zeros_like(xs))
        elif fn == "scatter":
            out.append(xs[kw["src"]][r])
        elif fn == "reduce_scatter":
            piece = xs.shape[1] // n
            out.append(reduce_(xs)[r * piece:(r + 1) * piece])
        else:  # all_to_all, split and concatenated along axis 0
            piece = xs.shape[1] // n
            out.append(torch.cat([xs[i][r * piece:(r + 1) * piece] for i in range(n)]))
    return torch.stack(out)


def _collectives_rank(seed: int, device_type: str) -> dict:
    """One rank of `check_collectives`: the group (every rank builds it),
    then every case on this rank's input on the device; an output that is
    not on that device raises."""
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    n, r = comm.world_size(), comm.rank()
    group = comm.new_group(collectives_group(n))
    out = {}
    for name, (fn, xs, kw) in collective_cases(n, seed).items():
        kw = dict(kw)
        x = xs[r].to(device)
        if "op" in kw:
            kw["op"] = comm.ReduceOp[kw["op"]]
        if kw.pop("group", False):
            kw["group"] = group
        root = kw.pop("dst", kw.pop("src", None))
        args = (x,) if root is None else (x, root)
        y = getattr(comm, fn)(*args, **kw)
        _require(y.device == device, f"{name}: output on {y.device}, not {device}")
        out[name] = y
    return out


def check_collectives(world: int, seed: int = 0, device: str = "cuda") -> dict:
    """Every collective of `comm` on ``world`` ranks sharing the card (the
    Gloo control group, so every call stages through host memory), against
    its plain version on the stacked inputs: int32 and data movement bit for
    bit, float32 SUM and PRODUCT within rtol and atol 1e-5 (Gloo adds in
    another order).  Returns the cases checked and the largest difference.
    ``device="cpu"`` runs the same check on CPU ranks."""
    t0 = time.perf_counter()
    res = comm.spmd(_collectives_rank, seed, device, world=world, device=device, timeout=300)
    worst = 0.0
    for name, (fn, xs, kw) in collective_cases(world, seed).items():
        got, want = res[name], collective_expected(fn, xs, kw)
        _require(got.shape == want.shape and got.dtype == want.dtype,
                 f"world {world}, {name}: {tuple(got.shape)} {got.dtype}, not "
                 f"{tuple(want.shape)} {want.dtype}")
        if want.is_floating_point() and kw.get("op") in ("SUM", "PRODUCT"):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            worst = max(worst, float((got - want).abs().max()))
        else:
            _require(torch.equal(got, want), f"world {world}, {name}: differs from the plain "
                     "version")
    return {"world": world, "cases": len(res), "max_abs_err": worst,
            "seconds": time.perf_counter() - t0}


# ------------------------------------------- the ring on the training path

DP_WORLD, DP_STEPS, DP_BATCH, DP_TRACE_STEPS = 2, 20, 128, 3


def _dp_rank(steps: int, seed: int) -> dict:
    """One rank of `check_dp`: the MNIST Trainer on the card with the fused
    dense kernel, ``steps`` steps under each gradient reduction from the
    same seed; each run's losses, final parameters, launch counts (set to 0
    just before the run, read just after) and seconds per step."""
    import os

    from tpu_dist_torch import data, models
    from tpu_dist_torch.ops import fused_dense
    from tpu_dist_torch.train import TrainConfig, Trainer

    os.environ["TPU_DIST_PALLAS_DENSE"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # the two runs must compute the same bits
    torch.backends.cudnn.benchmark = False
    device = torch.device("cuda", torch.cuda.current_device())
    n, r = comm.world_size(), comm.rank()
    loader = data.DistributedLoader(data.synthetic_mnist(DP_BATCH * steps, seed=seed), n,
                                    DP_BATCH, rank=r)
    batches = [(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
               for x, y in loader.epoch(0)]
    _require(len(batches) == steps, f"{len(batches)} batches, not {steps}")
    kernel = pallas_ring.ring_all_reduce_pallas
    ws = pallas_ring.workspace(device)
    out, trainers = {}, {}
    for backend in ("ring", "psum"):
        net = models.mnist_net(torch.Generator().manual_seed(seed))
        trainer = trainers[backend] = Trainer(
            net, TrainConfig(grad_reduce=backend, log=lambda line: None), device=device)
        torch.cuda.synchronize()
        comm.barrier()
        kernel.launches = fused_dense.launches = 0
        t0 = time.perf_counter()
        losses = [trainer.train_step(*batches[0])]
        pallas_ring.synchronize()
        first = time.perf_counter() - t0
        control = ws.collectives  # the workspace grows in the first step at most
        losses += [trainer.train_step(x, y) for x, y in batches[1:]]
        control = ws.collectives - control
        pallas_ring.synchronize()  # raises if a ring kernel gave up
        seconds = time.perf_counter() - t0
        out[backend] = {"losses": torch.stack(losses),
                        "params": {k: v.clone() for k, v in trainer.model.state_dict().items()},
                        "ring_launches": kernel.launches, "dense_launches": fused_dense.launches,
                        "tensors": len(trainer.params) + 1,  # the gradients and the loss
                        "control_after_step_1": control,
                        "first_step_seconds": first,
                        "seconds_per_step": seconds / steps,
                        "later_seconds_per_step": (seconds - first) / max(steps - 1, 1)}
    out["trace"] = trace_dp_steps(trainers["ring"].train_step,
                                  [batches[i % steps] for i in range(DP_TRACE_STEPS + 1)])
    return out


def trace_dp_steps(step, batches) -> dict:
    """``step(x, y)`` on each of ``batches`` under ``torch.profiler``, the
    first as a warm-up that takes the profiler's start-up, the others
    traced after a barrier with the group: per traced step, this rank's
    ring launches, their mean device time (``ring_kernel_ms``), the device
    time of all its kernels (``busy_ms``, the union of their intervals),
    the step's wall time to the end of its device work (``wall_ms``) and
    host time to enqueue it (``host_ms``), the card's idle share for this
    rank (1 - busy / wall), and the control-group collectives per ring
    call (``control_per_call``, 0 once the workspace fits)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    kernel = pallas_ring.ring_all_reduce_pallas
    ws = pallas_ring.workspace(torch.device("cuda", torch.cuda.current_device()))
    traced = len(batches) - 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=traced, repeat=1)) as prof:
        step(*batches[0])
        pallas_ring.synchronize()
        comm.barrier()
        prof.step()
        launches, collectives = kernel.launches, ws.collectives
        t0 = time.perf_counter()
        for i, (x, y) in enumerate(batches[1:], 1):
            step(x, y)
            if i == traced:  # the trace ends at this prof.step(), after the device work
                host_s = time.perf_counter() - t0
                pallas_ring.synchronize()
                wall_s = time.perf_counter() - t0
            prof.step()
        launches, collectives = kernel.launches - launches, ws.collectives - collectives
    comm.barrier()
    device = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == DeviceType.CUDA), key=lambda e: e[0])
    ring = [end - start for start, end, name in device if "ring_kernel" in name]
    _require(len(ring) == launches, f"the trace holds {len(ring)} ring launches, not the "
             f"{launches} the wrapper counted")
    busy_us, reach = 0.0, float("-inf")
    for start, end, _ in device:  # the union of the intervals
        busy_us += max(end - max(start, reach), 0)
        reach = max(reach, end)
    return {"steps": traced, "ring_launches": launches,
            "ring_kernel_ms": sum(ring) / max(len(ring), 1) / 1e3,
            "busy_ms": busy_us / traced / 1e3, "wall_ms": wall_s / traced * 1e3,
            "host_ms": host_s / traced * 1e3, "idle_share": 1 - busy_us / 1e6 / wall_s,
            "control_per_call": collectives / max(launches, 1)}


def check_dp(world: int = DP_WORLD, steps: int = DP_STEPS, seed: int = 0) -> dict:
    """The MNIST Trainer at ``world`` ranks on the card (ranks that share
    one card, or one card each where the host has enough) under
    ``grad_reduce="ring"`` and ``"psum"``: per rank, the ring kernel
    launched once per gradient and once for the loss each step in the ring
    run and never in the psum run, no control-group collective after the
    first step, the fused dense kernel twice a step in both; every loss and
    final parameter the same bits in both runs (at world 2 each sum is
    a + b and both divide by 2) and on every rank; the losses finite.  Then
    `trace_dp_steps` over ``DP_TRACE_STEPS`` more ring steps, which must
    hold one ring launch per tensor and no control-group collective."""
    res = comm.spmd(_dp_rank, steps, seed, world=world, device="cuda", timeout=600)
    trace = res.pop("trace")
    ring, psum = res["ring"], res["psum"]
    tensors = int(ring["tensors"][0])
    _require(ring["control_after_step_1"].tolist() == [0] * world,
             f"ring run: control-group collectives after step 1 per rank "
             f"{ring['control_after_step_1'].tolist()}, not 0")
    _require(trace["ring_launches"].tolist() == [tensors * DP_TRACE_STEPS] * world,
             f"traced steps: ring launches per rank {trace['ring_launches'].tolist()}")
    _require(trace["control_per_call"].tolist() == [0.0] * world,
             f"traced steps: control-group collectives per call {trace['control_per_call']}")
    _require(ring["ring_launches"].tolist() == [tensors * steps] * world,
             f"ring run: ring launches per rank {ring['ring_launches'].tolist()}, not "
             f"{tensors} x {steps}")
    _require(psum["ring_launches"].tolist() == [0] * world,
             f"psum run: ring launches per rank {psum['ring_launches'].tolist()}")
    for label, run in res.items():
        _require(run["dense_launches"].tolist() == [2 * steps] * world,
                 f"{label} run: fused dense launches {run['dense_launches'].tolist()}, "
                 f"not 2 x {steps}")
    _require(bool(torch.isfinite(ring["losses"]).all()), "non-finite loss")
    pairs = [("losses", ring["losses"], psum["losses"])] + [
        (name, ring["params"][name], psum["params"][name]) for name in ring["params"]]
    differing = {}
    for name, a, b in pairs:
        differing[name] = _bits_differing(a, b)
        _require(differing[name] == 0, f"{name}: ring and psum runs differ in "
                 f"{differing[name]} elements")
        _require(all(torch.equal(a[q], a[0]) for q in range(world)),
                 f"{name}: the ranks hold different bits")
    return {"world": world, "steps": steps, "tensors": tensors,
            "ring_launches": ring["ring_launches"].tolist(),
            "psum_ring_launches": psum["ring_launches"].tolist(),
            "dense_launches": ring["dense_launches"].tolist(),
            "seconds_per_step": {label: run["seconds_per_step"].tolist()
                                 for label, run in res.items()},
            "first_step_seconds": {label: run["first_step_seconds"].tolist()
                                   for label, run in res.items()},
            "later_seconds_per_step": {label: run["later_seconds_per_step"].tolist()
                                       for label, run in res.items()},
            "losses": ring["losses"][0].tolist(),
            "elements_differing": sum(differing.values()),
            "trace": {k: v.tolist() for k, v in trace.items()}}


IMAGE_DP_WORLD, IMAGE_DP_STEPS, IMAGE_DP_BATCH = 4, 10, 128


def _image_dp_rank(steps: int, batch: int, seed: int, device_type: str) -> dict:
    """One rank of `check_image_dp`: ResNet-18 (CIFAR stem, cross-entropy, lr
    0.05, momentum 0.9, the fused dense head) from a seed, ``steps`` steps
    under "psum" on this rank's share of each global batch of synthetic
    CIFAR-10; its losses, final parameters and buffers, fused-dense
    launches (set to 0 just before the steps, read just after), the first
    step's seconds (cuDNN's and NCCL's set-up) and the later steps' seconds
    a step."""
    import os

    from tpu_dist_torch import data, models, nn
    from tpu_dist_torch.ops import fused_dense
    from tpu_dist_torch.train import TrainConfig, Trainer

    os.environ["TPU_DIST_PALLAS_DENSE"] = "1"
    if device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        device = torch.device("cpu")
    n, r = comm.world_size(), comm.rank()
    loader = data.DistributedLoader(data.synthetic_cifar10(batch * steps, seed=seed), n, batch,
                                    rank=r)
    batches = [(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
               for x, y in loader.epoch(0)]
    _require(len(batches) == steps, f"{len(batches)} batches, not {steps}")
    # every rank builds from its own seed: the Trainer's broadcast makes them rank 0's
    net = models.resnet18(generator=torch.Generator().manual_seed(seed + r))
    trainer = Trainer(net, TrainConfig(global_batch=batch, lr=0.05, momentum=0.9,
                                       log=lambda line: None), device=device,
                      loss=nn.cross_entropy)
    if device.type == "cuda":
        torch.cuda.synchronize()
    comm.barrier()
    fused_dense.launches = 0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    losses = [trainer.train_step(*batches[0])]
    sync()
    t1 = time.perf_counter()
    losses += [trainer.train_step(x, y) for x, y in batches[1:]]
    sync()
    return {"losses": torch.stack(losses), "dense_launches": fused_dense.launches,
            "first_step_seconds": t1 - t0,
            "later_seconds_per_step": (time.perf_counter() - t1) / max(steps - 1, 1),
            "state": {k: v.clone() for k, v in trainer.model.state_dict().items()}}


def check_image_dp(world: int = IMAGE_DP_WORLD, steps: int = IMAGE_DP_STEPS,
                   batch: int = IMAGE_DP_BATCH, seed: int = 0, device: str = "cuda") -> dict:
    """ResNet-18 at ``world`` ranks (one card each where the host has them),
    ``grad_reduce="psum"``: each step one flat all-reduce carries the
    gradients, the loss and the batch-norm statistics, so every rank's
    parameters and buffers hold the same bits after ``steps`` steps; the
    losses finite and the same on every rank; the fused dense
    head launched once a step on every rank.  ``device="cpu"`` runs it on
    CPU ranks over Gloo (the head's plain version: no launch)."""
    res = comm.spmd(_image_dp_rank, steps, batch, seed, device, world=world, device=device,
                    timeout=900)
    losses = res["losses"]
    _require(bool(torch.isfinite(losses).all()), "non-finite loss")
    launches = steps if device == "cuda" else 0  # CPU tensors take the plain version
    _require(res["dense_launches"].tolist() == [launches] * world,
             f"fused dense launches per rank {res['dense_launches'].tolist()}, not {launches}")
    differing = {name: sum(_bits_differing(t[q], t[0]) for q in range(world))
                 for name, t in [("losses", losses), *res["state"].items()]}
    bad = {name: d for name, d in differing.items() if d}
    _require(not bad, f"ranks hold different bits in {bad}")
    buffers = [name for name in res["state"] if name.endswith((".mean", ".var"))]
    _require(len(buffers) == 40, f"{len(buffers)} batch-norm buffers, not 40 (20 layers)")
    return {"world": world, "steps": steps, "global_batch": batch,
            "losses": losses[0].tolist(),
            "first_step_seconds": res["first_step_seconds"].tolist(),
            "later_seconds_per_step": res["later_seconds_per_step"].tolist(),
            "dense_launches": res["dense_launches"].tolist(),
            "tensors_compared": len(differing), "batch_norm_buffers": len(buffers),
            "elements_differing": sum(differing.values())}


# ------------------------------------------------------------ the launcher


def _launch_rank(rank: int, world: int) -> tuple[float, int]:
    """Rank 1 of attempt 0 raises; otherwise an all-reduce of ones on the
    card, and the attempt."""
    import os

    from tpu_dist_torch.comm import init

    attempt = int(os.environ[init.ATTEMPT])
    if rank == 1 and attempt == 0:
        raise RuntimeError("rank 1 fails attempt 0 on purpose")
    device = torch.device("cuda", torch.cuda.current_device())
    return float(comm.all_reduce(torch.ones(1, device=device)).item()), attempt


def check_launch_restart(world: int = 2) -> dict:
    """`comm.launch` of ``world`` ranks on the card through a ``file://``
    store with ``restarts=1``: rank 1 fails attempt 0, and the gang's
    attempt 1 returns the all-reduce of ones on every rank."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = comm.launch(_launch_rank, world, device="cuda", init_method=f"file://{tmp}/rdzv",
                          restarts=1, timeout=300)
    _require(out == [(float(world), 1)] * world, f"launch returned {out}")
    return {"results": out, "seconds": time.perf_counter() - t0}


# ------------------------------------------------------------ mixture of experts

# The GPT-2-small-class LM's width (the [lm] model's), for the MoE checks.
MOE_WIDTH = dict(vocab=32768, dim=768, heads=12, max_seq=1024, pos_embedding="rope")
MOE_EP_TOL = dict(rtol=2e-3, atol=2e-4)  # the JAX package's tests/test_lm_mode_matrix.py


class _CommInstruments:
    """While active, this process's all_to_all calls (`dist.all_to_all_single`)
    and `comm.sendrecv` exchanges (`collectives._permute`) are counted, the
    forward's (on the main thread) apart from the backward's (on autograd's
    device thread, the tensors being on the card), with their host
    seconds: ``seconds`` inside the backend's all_to_all (under Gloo the
    exchange of host buffers, the wait for the slowest rank included; under
    NCCL the enqueue alone), ``call_seconds`` inside `comm.all_to_all`'s
    whole exchange (under Gloo also the copy to the host, which first waits
    for the work queued on the card, and the copy back), and
    ``sendrecv_seconds`` inside each whole sendrecv exchange, its copies
    included.  The dropped fraction of every expert-parallel MoE layer
    (`moe_mlp_top2`'s stats) is kept."""

    def __enter__(self):
        import threading

        import torch.distributed as dist

        from tpu_dist_torch.comm import collectives
        from tpu_dist_torch.models import transformer_lm

        ways = ("forward", "backward")
        self.calls = dict.fromkeys(ways, 0)
        self.seconds = dict.fromkeys(ways, 0.0)
        self.call_seconds = dict.fromkeys(ways, 0.0)
        self.sendrecv_calls = dict.fromkeys(ways, 0)
        self.sendrecv_seconds = dict.fromkeys(ways, 0.0)
        self.dropped = []
        self._dist, self._lm, self._collectives = dist, transformer_lm, collectives
        self._a2a, self._top2 = dist.all_to_all_single, transformer_lm.moe_mlp_top2
        self._exchange, self._permute = collectives._exchange, collectives._permute

        def timed(fn, seconds, calls, count):
            def call(*args, **kw):
                main = threading.current_thread() is threading.main_thread()
                way = "forward" if main else "backward"
                calls[way] += count
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    seconds[way] += time.perf_counter() - t0
            return call

        def top2(*args, **kw):
            y, stats = self._top2(*args, **kw)
            self.dropped.append(stats["dropped_fraction"].detach())
            return y, stats

        dist.all_to_all_single = timed(self._a2a, self.seconds, self.calls, 1)
        collectives._exchange = timed(self._exchange, self.call_seconds, self.calls, 0)
        collectives._permute = timed(self._permute, self.sendrecv_seconds, self.sendrecv_calls,
                                     1)
        transformer_lm.moe_mlp_top2 = top2
        return self

    def __exit__(self, *exc):
        self._dist.all_to_all_single, self._lm.moe_mlp_top2 = self._a2a, self._top2
        self._collectives._exchange = self._exchange
        self._collectives._permute = self._permute


def _launches() -> dict:
    from tpu_dist_torch.ops import fused_dense

    return {k.__name__: k.launches
            for k in (*fa.KERNELS, fused_dense, pallas_ring.ring_all_reduce_pallas)}


def _zero_launches() -> None:
    from tpu_dist_torch.ops import fused_dense

    for k in (*fa.KERNELS, fused_dense, pallas_ring.ring_all_reduce_pallas):
        k.launches = 0


def trace_step(step) -> dict:
    """Two ``step()`` calls under ``torch.profiler``, the first as its
    warm-up (the profiler's start-up differs between ranks, and a rank
    that starts first would wait for the others inside its collectives),
    the second traced after a barrier with the group: this rank's device
    ms, its all_to_all kernels' ms (NCCL's send/receive or all-to-all
    kernels), its all-reduce kernels' ms, the step's wall ms to the end of
    its device work, and the host ms inside all_to_all calls
    (`_CommInstruments`: under Gloo, where no kernel moves the data,
    the exchange itself, and the whole calls with their copies) and inside
    sendrecv exchanges with their copies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        step()
        torch.cuda.synchronize()
        comm.barrier()
        prof.step()
        with _CommInstruments() as seen:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        prof.step()
    comm.barrier()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)

    def of(*tags):
        return sum(e.self_device_time_total for e in kernels
                   if any(t in e.key.lower() for t in tags)) / 1e3

    a2a_ms = of("sendrecv", "alltoall")
    host_ms = sum(seen.seconds.values()) * 1e3
    call_ms = sum(seen.call_seconds.values()) * 1e3
    sendrecv_ms = sum(seen.sendrecv_seconds.values()) * 1e3
    return {"device_ms": device_us / 1e3, "all_to_all_ms": a2a_ms,
            "all_reduce_ms": of("allreduce"), "wall_ms": wall * 1e3,
            "all_to_all_share_of_device": a2a_ms * 1e3 / device_us if device_us else None,
            "all_to_all_share_of_wall": a2a_ms / (wall * 1e3),
            "all_to_all_host_ms": host_ms, "all_to_all_host_share_of_wall": host_ms / (wall * 1e3),
            "all_to_all_call_ms": call_ms, "all_to_all_call_share_of_wall": call_ms / (wall * 1e3),
            "sendrecv_host_ms": sendrecv_ms,
            "sendrecv_host_share_of_wall": sendrecv_ms / (wall * 1e3)}


def _fit_rank(mode: dict, mesh_shape: tuple | None, lm_kw: dict, cfg_kw: dict, windows,
              lr: float | None, reference: str | None, trace: bool) -> dict:
    """One rank of `check_moe_ep` and `check_seq_parallel`: ``LMTrainer``
    in ``mode`` (``moe=True``, or ``sequence_parallel="ring"`` or
    ``"ulysses"`` on a (data, seq) mesh of ``mesh_shape``), the LM built
    from seed 0
    (``sgd(lr)``, or AdamW when ``lr`` is None), fit on ``windows`` under
    TPU_DIST_FLASH=1 without TF32.  Returns its losses, seconds and
    tokens/s an epoch, its all_to_all and sendrecv calls and host seconds
    (forward and backward) and launch counts (set to 0 just before the fit, read just
    after), its peak device memory, a digest of every parameter, with MoE
    layers the largest and the mean dropped fraction of their calls, and
    given ``reference`` (a file of parameters) each parameter's largest
    difference from it; with ``trace``, `trace_step` of two more steps."""
    import os

    from tpu_dist_torch import models
    from tpu_dist_torch.device import to_device
    from tpu_dist_torch.train import LMTrainConfig, LMTrainer, sgd, sgd_rule

    os.environ["TPU_DIST_FLASH"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device())
    mesh = None if mesh_shape is None else comm.make_mesh(mesh_shape, ("data", "seq"))
    lm = models.TransformerLM(**lm_kw, generator=torch.Generator().manual_seed(0)).to(device)
    opt = None if lr is None else sgd_rule(sgd(lm.parameters(), lr))
    trainer = LMTrainer(lm, LMTrainConfig(**cfg_kw, **mode, log=lambda line: None),
                        optimizer=opt, device=device, mesh=mesh)
    torch.cuda.synchronize()
    comm.barrier()
    _zero_launches()
    torch.cuda.reset_peak_memory_stats(device)
    with _CommInstruments() as seen:
        history = trainer.fit(windows)
    launches = _launches()
    out = {"losses": torch.tensor([s.mean_loss for s in history], dtype=torch.float64),
           "seconds": torch.tensor([s.seconds for s in history]),
           "tokens_per_sec": torch.tensor([s.tokens_per_sec for s in history]),
           "all_to_all_calls": seen.calls, "all_to_all_seconds": seen.seconds,
           "all_to_all_call_seconds": seen.call_seconds,
           "sendrecv_calls": seen.sendrecv_calls, "sendrecv_seconds": seen.sendrecv_seconds,
           "launches": launches,
           "peak_bytes": torch.cuda.max_memory_allocated(device),
           "digests": {k: _digest(p.detach()) for k, p in lm.named_parameters()}}
    if seen.dropped:
        out["dropped"] = float(torch.stack(seen.dropped).max())
        out["dropped_mean"] = float(torch.stack(seen.dropped).mean())
    if reference is not None:
        want = torch.load(reference)
        diffs, close = {}, True
        for k, p in lm.named_parameters():
            got = p.detach().cpu()
            diffs[k] = float((got - want[k]).abs().max())
            close = close and torch.allclose(got, want[k], **MOE_EP_TOL)
        out["max_param_diff"], out["params_close"] = max(diffs.values()), close
    if trace:
        rows, cols = trainer._batch_slices(cfg_kw["global_batch"], windows.shape[1])
        tokens = to_device(windows[rows, cols], device)
        out["trace"] = trace_step(lambda: trainer.train_step(tokens))
    return out


def _check_fit(world: int, mode: dict, mesh_shape: tuple | None, lm_kw: dict, cfg_kw: dict,
               windows, lr: float | None, reference: str | None, trace: bool) -> dict:
    """`_fit_rank` at ``world`` ranks on the card (ranks sharing one card
    over Gloo, or one card each over NCCL): every rank must end with the
    same bits in every parameter and the same finite losses; with
    ``reference``, the parameters within `MOE_EP_TOL` of it.  Returns rank
    0's numbers and every rank's all_to_all and sendrecv calls and seconds,
    launches,
    peak memory and dropped fractions."""
    res = comm.spmd(_fit_rank, mode, mesh_shape, lm_kw, cfg_kw, windows, lr, reference, trace,
                    world=world, device="cuda", timeout=900)
    digests = res["digests"]
    _digests_agree(digests, world)
    losses = res["losses"]
    _require(all(torch.equal(losses[q], losses[0]) for q in range(world)),
             f"ranks report different losses {losses.tolist()}")
    _require(bool(torch.isfinite(losses).all()), f"non-finite loss {losses.tolist()}")
    if reference is not None:
        _require(all(res["params_close"].tolist()),
                 f"parameters off the reference by up to {res['max_param_diff'].tolist()}")
    out = {"world": world, "losses": losses[0].tolist(),
           "seconds": res["seconds"][0].tolist(),
           "tokens_per_sec": res["tokens_per_sec"][0].tolist(),
           **{key: {k: v.tolist() for k, v in res[key].items()}
              for key in ("all_to_all_calls", "all_to_all_seconds", "all_to_all_call_seconds",
                          "sendrecv_calls", "sendrecv_seconds", "launches")},
           "peak_gb": [b / 1e9 for b in res["peak_bytes"].tolist()],
           "parameters": len(digests)}
    for key in ("dropped", "dropped_mean", "max_param_diff"):
        if key in res:
            out[key] = res[key].tolist()
    if trace:
        out["trace"] = {k: v.tolist() if isinstance(v, torch.Tensor) else v
                        for k, v in res["trace"].items()}
    return out


def check_moe_ep(world: int, lm_kw: dict, cfg_kw: dict, windows, *, lr: float | None = None,
                 reference: str | None = None, trace: bool = False) -> dict:
    """``LMTrainer(moe=True)`` at ``world`` ranks on the card (`_check_fit`),
    with the dropped fractions of its MoE layers' calls (none when the
    capacity suffices)."""
    return _check_fit(world, {"moe": True}, None, lm_kw, cfg_kw, windows, lr, reference, trace)


# ------------------------------------------------------ sequence parallelism


def _seq_all_to_all_rank(shape: tuple, seed: int) -> dict:
    """One rank of `check_seq_all_to_all`: its CUDA tensor through
    ``all_to_all`` over the seq group of a (2, 2) mesh, and the gradient of
    a weighted sum."""
    device = torch.device("cuda", torch.cuda.current_device())
    mesh = comm.make_mesh((2, 2), ("data", "seq"))
    g = torch.Generator().manual_seed(seed + comm.rank())
    x = torch.randn(shape, generator=g).to(device).requires_grad_()
    y = comm.all_to_all(x, split_axis=1, concat_axis=0, group=mesh.group("seq"))
    w = torch.randn(y.shape, generator=g).to(device)
    (w * y).sum().backward()
    return {"x": x.detach().cpu(), "w": w.cpu(), "y": y.detach().cpu(), "grad": x.grad.cpu(),
            "on_card": y.is_cuda and x.grad.is_cuda}


def check_seq_all_to_all(shape: tuple = (3, 4), seed: int = 0) -> dict:
    """``comm.all_to_all(split_axis=1, concat_axis=0)`` over the seq group of
    a (2, 2) mesh, four ranks on the card's CUDA tensors (Gloo, staged
    through host memory), against its plain version on the stacked inputs:
    the output exactly, and the gradient of ``sum(w * y)`` (the exchange
    with the axes swapped) exactly.  Returns the ranks' outputs."""
    res = comm.spmd(_seq_all_to_all_rank, shape, seed, world=4, device="cuda", timeout=300)
    _require(bool(res["on_card"].all()), "all_to_all left the card")
    xs, ws = res["x"], res["w"]
    for r in range(4):
        row = [2 * (r // 2) + j for j in range(2)]  # the seq group of rank r
        me = r % 2
        want_y = torch.cat([xs[j].chunk(2, dim=1)[me] for j in row], dim=0)
        want_g = torch.cat([ws[j].chunk(2, dim=0)[me] for j in row], dim=1)
        _require(torch.equal(res["y"][r], want_y), f"rank {r}: all_to_all output differs")
        _require(torch.equal(res["grad"][r], want_g), f"rank {r}: all_to_all gradient differs")
    return {"y": res["y"], "grad": res["grad"]}


def check_seq_parallel(world: int, mesh_shape: tuple, lm_kw: dict, cfg_kw: dict, windows, *,
                       lr: float | None = None, reference: str | None = None,
                       trace: bool = False, core: str = "ulysses") -> dict:
    """``LMTrainer(sequence_parallel=core)`` at ``world`` ranks on a (data,
    seq) mesh of ``mesh_shape`` on the card (`_check_fit`)."""
    return _check_fit(world, {"sequence_parallel": core}, mesh_shape, lm_kw, cfg_kw,
                      windows, lr, reference, trace)


MOE_SMALL = dict(vocab=512, dim=128, depth=2, heads=2, max_seq=256, pos_embedding="rope",
                 moe_experts=4)


def check_moe_card_against_cpu(seed: int = 1) -> dict:
    """One float32 step of a small MoE LM (`MOE_SMALL`, batch 2 x 256,
    TPU_DIST_FLASH=1) on the card and on the CPU from the same
    parameters: the losses within 1e-5, every gradient within rtol 1e-3,
    atol 1e-5 (float32 sums in another order through a 512-way softmax and
    two blocks), and on the card ``apply_cached``'s prefill logits within
    1e-4 of the forward's (the plain attention against the flash kernels).
    Returns the differences and the flash launches on the card."""
    import os

    from tpu_dist_torch import models
    from tpu_dist_torch.train import LMTrainConfig, LMTrainer

    os.environ["TPU_DIST_FLASH"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", torch.cuda.current_device())
    pair = [LMTrainer(models.TransformerLM(**MOE_SMALL,
                                           generator=torch.Generator().manual_seed(seed)),
                      LMTrainConfig(global_batch=2, log=lambda line: None), device=dev)
            for dev in (device, "cpu")]
    tokens = models.synthetic_tokens(2, 256, MOE_SMALL["vocab"], seed=3)
    _zero_launches()
    loss_card = pair[0].loss_and_grads(tokens.to(device)).item()
    launches = _launches()
    loss_cpu = pair[1].loss_and_grads(tokens).item()
    grad_diff = 0.0
    for name, p in pair[0].params.items():
        want = pair[1].params[name].grad
        torch.testing.assert_close(p.grad.cpu(), want, rtol=1e-3, atol=1e-5)
        grad_diff = max(grad_diff, float((p.grad.cpu() - want).abs().max()))
    _require(abs(loss_card - loss_cpu) <= 1e-5, f"card loss {loss_card}, CPU {loss_cpu}")
    lm = pair[0].lm
    with torch.no_grad():
        dense = lm(tokens.to(device))
        cached, _ = lm.apply_cached(tokens.to(device), lm.init_cache(2, 256), 0)
    torch.testing.assert_close(cached, dense, rtol=1e-4, atol=1e-4)
    return {"loss_card": loss_card, "loss_cpu": loss_cpu, "grad_max_abs_diff": grad_diff,
            "cached_max_abs_diff": float((cached - dense).abs().max()),
            "launches": launches}


# ------------------------------------------------------------- ring attention

# The flash ring against the dense ring and dense attention: float32 sums in
# another order; in bf16 each flash block's output is rounded to bf16 before
# the blocks are joined (the dense ring rounds once, at the end).
RING_ATTENTION_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
                      torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


class _FlashForwards:
    """While active, the ``causal`` flag of every flash forward call
    (`flash_attention.flash_fwd`, which dispatches to the route's kernel),
    in call order."""

    def __enter__(self):
        self.causal = []
        self._fwd = fa.flash_fwd

        def recording(*args, causal=False, window=None):
            self.causal.append(causal)
            return self._fwd(*args, causal=causal, window=window)

        fa.flash_fwd = recording
        return self

    def __exit__(self, *exc):
        fa.flash_fwd = self._fwd


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _ring_attention_case(shape: tuple, dtype: torch.dtype, causal: bool, seed: int,
                         plain: bool, iters: int) -> dict:
    """This rank's shard of q, k, v ``shape`` (the global sequence on axis
    2, from ``seed``) through `ring_attention_flash` and `ring_attention`
    with the gradients of a weighted sum, beside dense attention over the
    gathered sequence (`flash_fwd_reference` in float32); the flash
    ring's launches in its forward and in its backward, each forward
    call's ``causal``; with ``plain`` the flash ring on CPU copies (its
    plain blocks, Gloo); each ring's forward ms, from the host clock
    around ``iters`` calls after a barrier."""
    from tpu_dist_torch.parallel import ring_attention, ring_attention_flash

    device = torch.device("cuda", torch.cuda.current_device())
    n, r = comm.world_size(), comm.rank()
    b, h, S, d = shape
    s_local = S // n
    g = torch.Generator().manual_seed(seed)
    full = [torch.randn(shape, generator=g).to(dtype) for _ in range(3)]
    mine = [t[:, :, r * s_local:(r + 1) * s_local].to(device) for t in full]
    w = torch.randn(b, h, s_local, d, generator=torch.Generator().manual_seed(seed + 1 + r))
    w = w.to(device)

    def run(core):
        leaves = [t.clone().requires_grad_() for t in mine]
        o = core(*leaves, causal=causal)
        torch.cuda.synchronize()
        forward = _launches()
        (w * o.float()).sum().backward()
        torch.cuda.synchronize()
        return o.detach(), [t.grad for t in leaves], forward

    torch.cuda.synchronize()
    comm.barrier()
    _zero_launches()
    torch.cuda.reset_peak_memory_stats(device)
    with _FlashForwards() as seen:
        flash, flash_grads, forward = run(ring_attention_flash)
    backward = {k: v - forward[k] for k, v in _launches().items()}
    ring, ring_grads, _ = run(ring_attention)
    peak = torch.cuda.max_memory_allocated(device)
    out3, _ = fa.flash_fwd_reference(*(t.to(device).float().reshape(b * h, S, d) for t in full),
                                     causal=causal)
    dense = out3.reshape(shape)[:, :, r * s_local:(r + 1) * s_local]
    tol = RING_ATTENTION_TOL[dtype]
    out = {"route": fa.flash_route(dtype, d), "causal_calls": torch.tensor(seen.causal),
           "forward_launches": forward, "backward_launches": backward,
           "flash_vs_ring": _max_err(flash, ring), "flash_vs_dense": _max_err(flash, dense),
           "ring_vs_dense": _max_err(ring, dense),
           "close": [torch.allclose(flash.float(), ring.float(), **tol),
                     torch.allclose(flash.float(), dense, **tol),
                     torch.allclose(ring.float(), dense, **tol)],
           "grads_equal": all(torch.equal(a, e) for a, e in zip(flash_grads, ring_grads)),
           "grad_max_diff": max(_max_err(a, e) for a, e in zip(flash_grads, ring_grads)),
           "grads_finite": all(bool(torch.isfinite(a).all()) for a in flash_grads),
           "peak_bytes": peak}
    del dense, out3, flash_grads, ring_grads
    if plain:
        with torch.no_grad():
            cpu = ring_attention_flash(*(t.cpu() for t in mine), causal=causal)
        out["flash_vs_plain"] = _max_err(flash.cpu(), cpu)
        out["close"].append(torch.allclose(flash.cpu().float(), cpu.float(), **tol))
    out["close"] = torch.tensor(out["close"])  # spmd stacks it: (world, comparisons)
    with torch.no_grad():
        for name, core in (("flash", ring_attention_flash), ("ring", ring_attention)):
            core(*mine, causal=causal)
            torch.cuda.synchronize()
            comm.barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                core(*mine, causal=causal)
            torch.cuda.synchronize()
            out[f"{name}_ms"] = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.empty_cache()
    return out


def _ring_lm_case(lm_kw: dict, batch: int, dtype: torch.dtype, seed: int) -> dict:
    """``TransformerLM.apply_seq_parallel(attention="ring")`` in eval on this
    rank's shard of ``batch`` windows of ``lm_kw["max_seq"]`` tokens, the
    LM from seed 0 in ``dtype``: with ``flash=True`` (its launches counted
    from 0, each forward call's ``causal``, its seconds) and ``flash=False``,
    both against the dense `forward` of the whole windows at world 1
    (TPU_DIST_FLASH=1: the flash kernels over the whole causal window);
    the largest differences as shares of the largest dense logit."""
    import os

    from tpu_dist_torch import models

    os.environ["TPU_DIST_FLASH"] = "1"
    device = torch.device("cuda", torch.cuda.current_device())
    n, r = comm.world_size(), comm.rank()
    S = lm_kw["max_seq"]
    s_local = S // n
    lm = models.TransformerLM(**lm_kw, generator=torch.Generator().manual_seed(0))
    lm = lm.to(device=device, dtype=dtype).eval()
    tokens = models.synthetic_tokens(batch, S, lm_kw["vocab"], seed=seed).to(device)
    local = tokens[:, r * s_local:(r + 1) * s_local]
    with torch.no_grad():
        dense = lm(tokens)[:, r * s_local:(r + 1) * s_local].float()
        torch.cuda.synchronize()
        comm.barrier()
        _zero_launches()
        t0 = time.perf_counter()
        with _FlashForwards() as seen:
            flash = lm.apply_seq_parallel(local, flash=True).float()
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches()
        ring = lm.apply_seq_parallel(local).float()
    scale = float(dense.abs().max())
    out = {"launches": launches, "causal_calls": torch.tensor(seen.causal),
           "flash_seconds": seconds, "max_abs_logit": scale,
           "flash_vs_ring": _max_err(flash, ring) / scale,
           "flash_vs_dense": _max_err(flash, dense) / scale,
           "ring_vs_dense": _max_err(ring, dense) / scale,
           "finite": bool(torch.isfinite(flash).all() and torch.isfinite(ring).all())}
    del lm, dense, flash, ring
    torch.cuda.empty_cache()
    return out


def _ring_generate_case(lm_kw: dict, prompt: torch.Tensor, steps: int) -> dict:
    """Greedy `TransformerLM.generate_seq_parallel` of ``steps`` tokens
    after this rank's shard of ``prompt``, the LM from seed 0 in float32,
    and its seconds."""
    from tpu_dist_torch import models

    device = torch.device("cuda", torch.cuda.current_device())
    n, r = comm.world_size(), comm.rank()
    s_local = prompt.shape[1] // n
    lm = models.TransformerLM(**lm_kw, generator=torch.Generator().manual_seed(0)).to(device)
    local = prompt[:, r * s_local:(r + 1) * s_local].to(device)
    torch.cuda.synchronize()
    comm.barrier()
    t0 = time.perf_counter()
    tokens = lm.generate_seq_parallel(local, steps)
    torch.cuda.synchronize()
    return {"tokens": tokens.cpu(), "seconds": time.perf_counter() - t0}


def _seq_ring_rank(attention: list, lm: list, generate: tuple | None) -> dict:
    """One rank of `check_ring_attention` / `check_seq_ring`: each case in
    turn (every rank runs all of them, so no collective is left waiting);
    the parent checks the results."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"attention": [_ring_attention_case(*case) for case in attention],
           "lm": [_ring_lm_case(*case) for case in lm]}
    if generate is not None:
        out["generate"] = _ring_generate_case(*generate)
    return out


def _check_attention(res: dict, world: int, dtype: torch.dtype, causal: bool) -> None:
    """A `_ring_attention_case`'s gates: every comparison within
    `RING_ATTENTION_TOL`, the flash ring's gradient the dense ring's bits,
    ``world`` forward launches a call of the route's forward (the diagonal
    ``causal``, the rest not) and no other kernel, none in the backward."""
    names = ["flash vs ring", "flash vs dense", "ring vs dense", "flash vs plain"]
    for r in range(world):
        for name, ok in zip(names, res["close"][r].tolist()):
            _require(ok, f"rank {r}: {name} off by more than {RING_ATTENTION_TOL[dtype]}")
    _require(bool(res["grads_equal"].all()), "the flash ring's gradient differs from the "
             f"dense ring's by up to {res['grad_max_diff'].tolist()}")
    _require(bool(res["grads_finite"].all()), "non-finite gradient")
    forward = {k: v.tolist() for k, v in res["forward_launches"].items()}
    want = {k: [world if k == f"flash_fwd_{res['route'][0]}" else 0] * world for k in forward}
    _require(forward == want, f"forward launches {forward}, not {want}")
    backward = {k: v.tolist() for k, v in res["backward_launches"].items()}
    _require(backward == {k: [0] * world for k in backward}, f"backward launches {backward}")
    calls = [causal] + [False] * (world - 1)
    _require(res["causal_calls"].tolist() == [calls] * world,
             f"forward calls' causal {res['causal_calls'].tolist()}, not {calls} a rank")


def check_ring_attention(world: int, shape: tuple, dtype: torch.dtype, *, causal: bool = True,
                         seed: int = 0, plain: bool = False, iters: int = 3) -> dict:
    """`ring_attention_flash` at ``world`` ranks sharing the card (Gloo), q,
    k, v ``shape`` split along the sequence: against `ring_attention` and
    dense attention on the gathered sequence, with ``plain`` against its
    plain blocks on the CPU (`_check_attention`'s gates).  Returns every
    rank's differences, launches, times and peak memory."""
    res = comm.spmd(_seq_ring_rank, [(shape, dtype, causal, seed, plain, iters)], [], None,
                    world=world, device="cuda", timeout=600)["attention"][0]
    _check_attention(res, world, dtype, causal)
    return res


def check_seq_ring(world: int, attention: list, lm: list, generate: tuple) -> dict:
    """In one spawned world of ``world`` ranks sharing the card: each
    ``attention`` case ``(shape, dtype, causal, seed)`` as
    `check_ring_attention` checks it; each ``lm`` case ``(lm_kw, batch,
    dtype, seed)``: the flash ring's launches (``depth * world`` of the
    route's forward, the diagonal causal) and finite logits (the parent
    holds the differences to its tolerance); ``generate`` ``(lm_kw,
    prompt, steps)``: greedy tokens, the same on every rank.  Returns every
    rank's results."""
    res = comm.spmd(_seq_ring_rank, [(*case, False, 3) for case in attention], lm, generate,
                    world=world, device="cuda", timeout=900)
    for (_, dtype, causal, _), case in zip(attention, res["attention"]):
        _check_attention(case, world, dtype, causal)
    for (lm_kw, _, dtype, _), case in zip(lm, res["lm"]):
        _require(bool(case["finite"].all()), "non-finite logits")
        route = fa.flash_route(dtype, lm_kw["dim"] // lm_kw["heads"])
        launches = {k: v.tolist() for k, v in case["launches"].items()}
        depth = lm_kw["depth"]
        want = {k: [depth * world if k == f"flash_fwd_{route}" else 0] * world
                for k in launches}
        _require(launches == want, f"apply_seq_parallel launches {launches}, not {want}")
        calls = ([True] + [False] * (world - 1)) * depth
        _require(case["causal_calls"].tolist() == [calls] * world,
                 f"apply_seq_parallel forward calls' causal {case['causal_calls'].tolist()}")
    tokens = res["generate"]["tokens"]
    _require(all(torch.equal(tokens[r], tokens[0]) for r in range(world)),
             "generate_seq_parallel gives the ranks different tokens")
    return res
