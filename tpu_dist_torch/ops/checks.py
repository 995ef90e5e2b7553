"""Checks of the kernels against their plain versions on the card.

One copy of each check, called by the card tests (`tests/test_torch_cuda.py`)
and by ``chip_smoke.py``:

- `check_flash_kernels`: the flash kernels of the route `flash_route`
  names (tensor-core forward, dK/dV and dQ for bfloat16 and float16 at
  d = 64 and 128, SIMT otherwise) against their plain versions on given
  inputs (any head dim up to 256, float32, bfloat16 or float16), with the
  launch counts that show which kernels ran and the count of dK elements
  that differ at all;
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
  bound.

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
                        exact_dk: bool = False) -> dict:
    """Forward (out, lse), dK/dV and dQ against the plain versions, the
    backward kernels fed the plain forward's lse and D = rowsum(dO * out);
    the route's forward, dK/dV and dQ wrappers each launched once, no other
    wrapper.  Returns the route, the plain lse and D (for timing) and,
    per kernel, the max |difference|; ``dk_differing`` counts dK elements that differ at all,
    and ``exact_dk`` requires it to be 0: in float32 the kernel sums dS^T Q
    in query order with one FMA accumulator and scales once after the sum,
    which equals the plain version bit for bit wherever its product is one
    in-order sum too (short S; cuBLAS splits long sums)."""
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
    dk_differing = _differing(dk, want_dk)
    _require(not exact_dk or dk_differing == 0, f"{dk_differing} dK elements differ")
    return {"max_abs_err": errs, "tol": tol, "dk_differing": dk_differing,
            "lse": want_lse, "delta": delta, "route": route}


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
RING_SIZES = [1_000, 100_000, 3_000_000, 50_000, 7, 4_000_000]  # growing, then shrinking


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
