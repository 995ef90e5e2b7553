"""Checks of the kernels against their plain versions on the card.

One copy of each check, called by the card tests (`tests/test_torch_cuda.py`)
and by ``chip_smoke.py``:

- `check_flash_kernels`: the three flash kernels against their plain
  versions on given inputs (any head dim up to 256, float32, bfloat16 or
  float16), with the count of dK elements that differ at all;
- `check_flash_past_2_31`: the flash kernels on (bh, S, d) arrays of more
  than 2^31 elements, held to the plain version on the heads that lie past
  2^31;
- `check_ring`: the ring kernel under `comm.spmd` at a world of ranks on
  the card, bit for bit against `ring_all_reduce_reference` in float32,
  bfloat16, float16 and int32, ragged sizes, 100 calls back to back and a
  workspace that grows and is reused; optionally one timed and traced
  call size, whose output is held to the plain version too
  (`trace_ring_calls` gives the kernel's own device time);
- `check_ring_stuck_neighbour`: a neighbour whose kernel cannot start makes
  the call raise within the kernel's bound, on both ranks.

Each raises AssertionError when a check fails (also under ``python -O``)
and returns what it measured.  Nothing here runs without a card.
"""

from __future__ import annotations

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


def check_flash_kernels(q, k, v, go, *, causal: bool, window: int | None,
                        exact_dk: bool = False) -> dict:
    """Forward (out, lse), dK/dV and dQ against the plain versions, the
    backward kernels fed the plain forward's lse and D = rowsum(dO * out).
    Returns the plain lse and D (for timing) and, per kernel, the max
    |difference|; ``dk_differing`` counts dK elements that differ at all,
    and ``exact_dk`` requires it to be 0: in float32 the kernel sums dS^T Q
    in query order with one FMA accumulator and scales once after the sum,
    which equals the plain version bit for bit wherever its product is one
    in-order sum too (short S; cuBLAS splits long sums)."""
    kw = dict(causal=causal, window=window)
    counts = [fa.flash_fwd.launches, fa.flash_dkv.launches, fa.flash_dq.launches]
    out, lse = fa.flash_fwd(q, k, v, **kw)
    want_out, want_lse = fa.flash_fwd_reference(q, k, v, **kw)
    delta = (go.float() * want_out.float()).sum(-1)
    dk, dv = fa.flash_dkv(q, k, v, go, want_lse, delta, **kw)
    dq = fa.flash_dq(q, k, v, go, want_lse, delta, **kw)
    torch.cuda.synchronize()
    _require([fa.flash_fwd.launches, fa.flash_dkv.launches, fa.flash_dq.launches]
             == [c + 1 for c in counts], "a flash wrapper did not count its launch")
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
            "lse": want_lse, "delta": delta}


def check_flash_past_2_31(device, *, S: int = 256, d: int = 128, heads_checked: int = 2) -> dict:
    """bfloat16 causal (bh, S, d) with bh * S * d just past 2^31: all three
    kernels run on the whole array, and the last ``heads_checked`` heads,
    which start past element 2^31, are held to the plain version."""
    bh = 2**31 // (S * d) + heads_checked
    dtype = torch.bfloat16
    g = torch.Generator(device).manual_seed(5)
    q, k, v, go = (torch.randn(bh, S, d, generator=g, device=device, dtype=dtype)
                   for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    tail = slice(bh - heads_checked, bh)
    want_out, want_lse = fa.flash_fwd_reference(q[tail], k[tail], v[tail], causal=True)
    delta = torch.empty(bh, S, device=device)
    for c in range(0, bh, 8192):  # D = rowsum(dO * out), without float32 copies of both
        delta[c:c + 8192] = (go[c:c + 8192].float() * out[c:c + 8192].float()).sum(-1)
    dk, dv = fa.flash_dkv(q, k, v, go, lse, delta, causal=True)
    dq = fa.flash_dq(q, k, v, go, lse, delta, causal=True)
    torch.cuda.synchronize()
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
    return {"q": [bh, S, d], "dtype": "bfloat16", "causal": True, "elements": bh * S * d,
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


def _ring_rank(seed: int, time_mbytes: float, iters: int) -> dict:
    """One rank of `check_ring`.  Returns the elements that differ from the
    plain version per case, the workspace's growth and the launch count of
    the checks; with ``time_mbytes``, one float32 call of that size per
    rank: the time per call on the stream (``call_ms``, CUDA events around
    ``iters`` calls, the wrapper's host work included), the last call's
    output against the plain version (elements that differ, max |diff|),
    the kernel's own time from a trace (`trace_ring_calls`) and, on rank 0, the
    plain version's time."""
    device = torch.device("cuda", torch.cuda.current_device())
    n, r = comm.world_size(), comm.rank()
    kernel, reference = pallas_ring.ring_all_reduce_pallas, pallas_ring.ring_all_reduce_reference
    kernel.launches = 0
    differing = {}
    for label, shape, dtype in RING_CASES:
        xs = torch.stack([ring_payload(shape, dtype, q, seed, device) for q in range(n)])
        out = kernel(xs[r])
        pallas_ring.synchronize()
        differing[label] = _bits_differing(out, reference(xs)[r])

    # back to back: no host sync until the last call
    xs = torch.stack([ring_payload(RING_BACK_TO_BACK_ELEMENTS, torch.float32, q, seed, device)
                      for q in range(n)])
    outs = [kernel(xs[r] * (i + 1)) for i in range(RING_BACK_TO_BACK)]
    pallas_ring.synchronize()
    differing[f"{RING_BACK_TO_BACK} back to back"] = sum(
        _bits_differing(o, reference(xs * (i + 1))[r]) for i, o in enumerate(outs))

    ws = pallas_ring.workspace(device)
    grows_before, largest = ws.grows, ws.capacity
    expected_grows = 0
    for i, numel in enumerate(RING_SIZES):
        xs = torch.stack([ring_payload(numel, torch.float32, q, seed + i, device)
                          for q in range(n)])
        out = kernel(xs[r])
        pallas_ring.synchronize()
        differing[f"size {numel}"] = _bits_differing(out, reference(xs)[r])
        if numel * 4 > largest:
            expected_grows, largest = expected_grows + 1, numel * 4
    result = {"differing": differing, "launches": kernel.launches,
              "grows": ws.grows - grows_before, "expected_grows": expected_grows,
              "capacity": ws.capacity, "largest": largest}

    if time_mbytes:
        numel = int(time_mbytes * 2**20 / 4)
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
    mean: host work that the stream waits for) and the host's time per
    call (``host_ms``; the profiler slows the host, so both are upper
    bounds).  Then, without the profiler, the host's time per call of the
    wrapper's shape check over the control group alone (``check_ms``).
    Raises if the trace does not hold one launch per call."""
    fn, kernel = pallas_ring.ring_all_reduce_pallas, "ring_kernel"
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(x)
        pallas_ring.synchronize()
        comm.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        host_s = time.perf_counter() - t0
        pallas_ring.synchronize()
    comm.barrier()
    launches = sorted((e for e in prof.events()
                       if e.device_type == DeviceType.CUDA and kernel in e.name),
                      key=lambda e: e.time_range.start)
    _require(len(launches) == iters + 1,
             f"the trace holds {len(launches)} launches of {kernel}, not {iters + 1}")
    launches = launches[1:]  # the warm-up
    gaps = [b.time_range.start - a.time_range.end for a, b in zip(launches, launches[1:])]
    control = pallas_ring.workspace(x.device).control
    t0 = time.perf_counter()
    for _ in range(iters):
        pallas_ring._check_same_call(control, x)
    check_s = time.perf_counter() - t0
    comm.barrier()
    return {"kernel_ms": sum(e.time_range.elapsed_us() for e in launches) / iters / 1e3,
            "gap_ms": sum(gaps) / max(len(gaps), 1) / 1e3,
            "host_ms": host_s / iters * 1e3, "check_ms": check_s / iters * 1e3}


def check_ring(world: int, *, seed: int = 0, time_mbytes: float = 0.0, iters: int = 20) -> dict:
    """The ring kernel at ``world`` ranks (processes) on the card: every
    case bit for bit equal to the plain version on every rank, one launch
    per call, the workspace grown exactly when a call was larger than any
    before it.  Returns the per-rank results."""
    res = comm.spmd(_ring_rank, seed, time_mbytes, iters, world=world, device="cuda")
    calls = len(RING_CASES) + RING_BACK_TO_BACK + len(RING_SIZES)
    for label, counts in res["differing"].items():
        _require(counts.tolist() == [0] * world, f"world {world}, {label}: elements that "
                 f"differ per rank {counts.tolist()}")
    _require(res["launches"].tolist() == [calls] * world,
             f"launches per rank {res['launches'].tolist()}, not {calls}")
    _require(bool((res["grows"] == res["expected_grows"]).all()),
             f"workspace grew {res['grows'].tolist()} times, not {res['expected_grows'].tolist()}")
    _require(bool((res["capacity"] == res["largest"]).all()),
             f"workspace holds {res['capacity'].tolist()} bytes, not {res['largest'].tolist()}")
    if time_mbytes:
        _require(res["timed_differing"].tolist() == [0] * world,
                 f"world {world}, the timed {time_mbytes} MiB call: elements that differ "
                 f"per rank {res['timed_differing'].tolist()}")
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
