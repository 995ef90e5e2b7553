"""Continuous-batching decode engine: admit and evict at step granularity.

The counterpart of `tpu_dist.serve.engine`, with the same step order, so
the same seeded trace gives the same ``audit`` in both packages.

- A fixed number of decode slots (``max_batch``) over the paged KV pool
  (`serve.paged_kv`): blocks allocated at admission, freed at eviction.
- Every step evicts cancelled requests, admits queued ones into free slots
  (FIFO; the head of the queue blocks when the pool is exhausted), then
  launches one batched decode step over the active slots and one prefill
  round of up to ``prefill_batch`` chunks, both before either is read back.
- Per-request sampling parameters (`sample_slots`), and per-request noise
  keyed by (seed, token index) (`slot_noise`), so a request's tokens do
  not depend on its slot or its neighbours.
- Request-lifecycle telemetry: ``request_admit``, ``prefill``,
  ``decode_step`` and ``request_finish`` events (`observe.events`), the
  occupancy, queue-depth and KV-pool gauges and the TTFT and TPOT
  histograms of `observe.registry.REGISTRY`.

The per-slot state of the decode step lives on the device as one packed
integer tensor and one float tensor, updated in place by the step: a steady
decode step copies nothing from the host; an admission, activation or
eviction repacks both.  The step reads and writes only those tensors, the
model and the pool, so on the card it runs as one CUDA graph
(`device.Replay`), as the JAX engine's step is one compiled program.  A
prefill round always has ``min(prefill_batch, max_batch)`` rows, so a
request's arithmetic does not depend on how many prefill beside it.

Greedy decode through the engine gives the dense `generate`'s tokens:
continuous batching changes when a request computes, not what.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from tpu_dist_torch.device import Replay, resolve_device
from tpu_dist_torch.observe import events as ev_mod
from tpu_dist_torch.observe import flightrec, memory
from tpu_dist_torch.observe.registry import REGISTRY
from tpu_dist_torch.serve.paged_kv import BlockAllocator, init_paged_cache, paged_apply_cached
from tpu_dist_torch.serve.sampling import sample_slots, slot_noise


@dataclass
class SamplingParams:
    """Per-request sampling: ``temperature=0`` is greedy; ``seed`` keys the
    request's own noise."""

    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    seed: int = 0


@dataclass
class ServeConfig:
    """Engine sizing.  ``max_seq`` caps prompt + output per request (at most
    the model's ``max_seq``); the pool holds ``num_blocks`` blocks of
    ``block_size`` positions, shared by all slots; ``prefill_chunk`` is the
    prompt-ingestion quantum, ``prefill_batch`` the chunks a step.
    ``cache_dtype``: a torch dtype, default the embedding table's.
    ``bytes_limit``: the memory budget of the admission check (None reads
    the card's total; the CPU has none)."""

    max_batch: int = 8
    block_size: int = 16
    num_blocks: int = 128
    max_seq: int = 256
    prefill_chunk: int = 32
    prefill_batch: int = 4
    decode_event_every: int = 8
    cache_dtype: torch.dtype | None = None
    bytes_limit: int | None = None


@dataclass
class Request:
    """Internal request record (front ends construct it via
    `ServeEngine.submit`)."""

    request_id: int
    prompt: np.ndarray
    max_new_tokens: int
    sampling: SamplingParams
    stop_token: int | None = None
    state: str = "queued"  # queued | prefill | decode | finished
    slot: int = -1
    blocks: list = field(default_factory=list)
    prefill_pos: int = 0
    tokens: list = field(default_factory=list)
    arrival_time: float = 0.0
    first_token_time: float | None = None
    finish_time: float | None = None
    token_times: list = field(default_factory=list)
    finish_reason: str | None = None


@dataclass
class RequestResult:
    """The emitted tokens and the latency observables of one request."""

    request_id: int
    tokens: np.ndarray
    finish_reason: str
    prompt_len: int
    arrival_time: float
    first_token_time: float | None
    finish_time: float
    token_times: list

    @property
    def emitted(self) -> int:
        return int(self.tokens.size)

    @property
    def ttft(self) -> float | None:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def tpot_mean(self) -> float | None:
        """Mean time per output token after the first (None for
        single-token or unstarted requests)."""
        if self.first_token_time is None or self.emitted < 2:
            return None
        return (self.finish_time - self.first_token_time) / (self.emitted - 1)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class ServeEngine:
    """The continuous-batching step loop over one model and its paged pool.

    ``device``: where the model and pool live (None = the card; ``"cpu"``
    when asked).  ``now``: injectable clock (tests pass a fake one).
    Single-threaded: callers drive `step()` or `run_until_drained()`."""

    # packed int-state columns, after the block-table columns
    _ACTIVE, _TOPK, _SEED, _LASTTOK, _INDEX, _COUNTER = range(6)

    def __init__(self, lm, config: ServeConfig | None = None, *, device=None,
                 now=time.monotonic, events=None):
        cfg = config or ServeConfig()
        if cfg.max_seq > lm.max_seq:
            raise ValueError(
                f"config max_seq {cfg.max_seq} exceeds model max_seq {lm.max_seq}"
            )
        if cfg.prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {cfg.prefill_chunk}")
        if cfg.prefill_batch < 1:
            raise ValueError(f"prefill_batch must be >= 1, got {cfg.prefill_batch}")
        self.device = resolve_device(device)
        self.lm, self.cfg = lm.to(self.device), cfg
        self._now = now
        self.events = events if events is not None else ev_mod.from_env()
        self._flight = flightrec.get()
        self._memory = memory.WatermarkSampler(self.device, flight=self._flight)
        self.blocks_per_seq = math.ceil(cfg.max_seq / cfg.block_size)
        self.context_len = self.blocks_per_seq * cfg.block_size
        self.allocator = BlockAllocator(cfg.num_blocks)
        dtype = cfg.cache_dtype or lm.embed.table.dtype
        self.cache = init_paged_cache(lm, cfg.num_blocks, cfg.block_size, dtype, self.device)
        self.scratch = cfg.num_blocks

        S, MB = cfg.max_batch, self.blocks_per_seq
        self.block_tables = np.full((S, MB), self.scratch, np.int64)
        self.index = np.zeros((S,), np.int64)
        self.active = np.zeros((S,), bool)
        self.last_tok = np.zeros((S,), np.int64)
        self.temperature = np.zeros((S,), np.float32)
        self.top_k = np.zeros((S,), np.int64)
        self.top_p = np.ones((S,), np.float32)
        self.seeds = np.zeros((S,), np.int64)
        self.counters = np.zeros((S,), np.int64)

        self.slots: list[Request | None] = [None] * S
        self.queue: deque[Request] = deque()
        self._prefillq: deque[int] = deque()
        self._cancelled: set[int] = set()
        self.results: dict[int, RequestResult] = {}
        self.step_count = 0
        self.steps_with_decode = 0
        self.steps_with_prefill = 0
        self._next_id = 0
        # (kind, ...) tuples in processing order: the determinism observable
        self.audit: list[tuple] = []
        # the decode step's per-slot state on the device (`_pack_state`),
        # read and advanced by the step, which on the card is one CUDA graph
        # a path (`device.Replay`; greedy and sampled)
        self._dint = torch.zeros((S, MB + 6), dtype=torch.int64, device=self.device)
        self._dflt = torch.zeros((S, 2), dtype=torch.float32, device=self.device)
        self._decode = {greedy: Replay(partial(self._decode_step, greedy=greedy), self.device)
                        for greedy in (False, True)}
        self._dirty = True
        self._warming = False
        self._g_occ = REGISTRY.gauge(
            "tpu_dist_serve_batch_occupancy", "active decode slots in the serving batch")
        self._g_queue = REGISTRY.gauge(
            "tpu_dist_serve_queue_depth", "requests waiting for admission")
        self._g_blocks = REGISTRY.gauge(
            "tpu_dist_serve_kv_blocks_used", "allocated KV pool blocks")
        self._g_util = REGISTRY.gauge(
            "tpu_dist_serve_kv_block_utilization", "allocated fraction of the KV block pool")
        self._h_ttft = REGISTRY.histogram("tpu_dist_serve_ttft_seconds", "time to first token")
        self._h_tpot = REGISTRY.histogram(
            "tpu_dist_serve_tpot_seconds", "per-token decode latency")
        # What the engine keeps resident: weights and the KV pool (allocated
        # in full here; blocks are grants of it).
        self.weights_bytes = _nbytes(lm.parameters())
        self.kv_pool_bytes = _nbytes(t for c in self.cache for t in c.values())
        # the pool holds num_blocks grantable blocks + 1 scratch block
        self.kv_block_bytes = self.kv_pool_bytes // (cfg.num_blocks + 1)
        self.bytes_limit = (
            cfg.bytes_limit if cfg.bytes_limit is not None
            else self._memory.snapshot().get("bytes_limit")
        )
        REGISTRY.gauge("tpu_dist_serve_weights_bytes",
                       "model weight bytes resident").set(self.weights_bytes)
        REGISTRY.gauge("tpu_dist_serve_kv_pool_bytes",
                       "paged KV pool bytes resident (allocated at init)").set(self.kv_pool_bytes)

    # ------------------------------------------------------- device steps

    def _pack_state(self) -> None:
        """Copy the host's per-slot state into the decode step's tensors:
        int64 ``(S, MB + 6)`` (block table, then the `_ACTIVE` .. `_COUNTER`
        columns) and float32 ``(S, 2)`` (temperature, top_p)."""
        MB = self.blocks_per_seq
        ints = np.empty((self.cfg.max_batch, MB + 6), np.int64)
        ints[:, :MB] = self.block_tables
        ints[:, MB + self._ACTIVE] = self.active
        ints[:, MB + self._TOPK] = self.top_k
        ints[:, MB + self._SEED] = self.seeds
        ints[:, MB + self._LASTTOK] = self.last_tok
        ints[:, MB + self._INDEX] = self.index
        ints[:, MB + self._COUNTER] = self.counters
        flt = np.stack([self.temperature, self.top_p], axis=1).astype(np.float32)
        self._dint.copy_(torch.from_numpy(ints))
        self._dflt.copy_(torch.from_numpy(flt))

    @torch.no_grad()
    def _decode_step(self, *, greedy: bool) -> torch.Tensor:
        """One batched decode step over the packed state, which it advances
        in place (last token, position and token counter of active slots).
        ``greedy``: every active slot has temperature 0, so plain argmax
        (`generate`'s greedy op), no sort and no noise."""
        ints, flt, MB = self._dint, self._dflt, self.blocks_per_seq
        active = ints[:, MB + self._ACTIVE].bool()
        last_tok = ints[:, MB + self._LASTTOK]
        logits, _ = paged_apply_cached(
            self.lm, last_tok[:, None], self.cache, ints[:, :MB],
            ints[:, MB + self._INDEX][:, None], active[:, None], self.cfg.block_size,
        )
        logits = logits[:, 0]
        if greedy:
            toks = logits.argmax(-1)
        else:
            noise = slot_noise(ints[:, MB + self._SEED], ints[:, MB + self._COUNTER],
                               logits.shape[-1], self.device).to(logits.dtype)
            toks = sample_slots(logits, noise, flt[:, 0], ints[:, MB + self._TOPK], flt[:, 1])
        ints[:, MB + self._LASTTOK] = torch.where(active, toks, last_tok)
        ints[:, MB + self._INDEX] += active
        ints[:, MB + self._COUNTER] += active
        return toks

    @torch.no_grad()
    def _prefill_round(self, ints: torch.Tensor, flt: torch.Tensor) -> torch.Tensor:
        """One prompt chunk for each of P distinct requests (a request's later
        chunks attend its earlier ones; a row of real length 0 writes only
        scratch).  ``ints`` columns: tokens (C) |
        block table (MB) | start | real length | top_k | seed.  Also draws
        each row's would-be first output token from its last real position
        (noise at token index 0)."""
        C, MB = self.cfg.prefill_chunk, self.blocks_per_seq
        tokens = ints[:, :C]
        start, real_len = ints[:, C + MB], ints[:, C + MB + 1]
        steps = torch.arange(C, device=self.device)
        logits, _ = paged_apply_cached(
            self.lm, tokens, self.cache, ints[:, C : C + MB], start[:, None] + steps,
            steps[None, :] < real_len[:, None], self.cfg.block_size,
        )
        rows = torch.arange(len(ints), device=self.device)
        last = logits[rows, real_len.clamp(min=1) - 1]
        noise = slot_noise(ints[:, C + MB + 3], torch.zeros_like(real_len),
                           last.shape[-1], self.device).to(last.dtype)
        return sample_slots(last, noise, flt[:, 0], ints[:, C + MB + 2], flt[:, 1])

    def analysis_programs(self) -> dict:
        """The JAX engine's compiled programs for `tpu_dist.analysis` have no
        counterpart here."""
        raise NotImplementedError(
            "analysis_programs exposes XLA programs for tpu_dist.analysis, which is not "
            "ported (ROADMAP queue 1, item 12: analysis)"
        )

    # ------------------------------------------------------------- memory

    def memory_breakdown(self) -> dict:
        """Weights, the KV pool (granted blocks apart) and the headroom left
        against ``bytes_limit`` (None without a limit), with the live
        `observe.memory` snapshot."""
        granted = self.allocator.used * self.kv_block_bytes
        headroom = (
            int(self.bytes_limit) - self.weights_bytes - self.kv_pool_bytes
            if self.bytes_limit is not None else None
        )
        return {
            "weights_bytes": self.weights_bytes,
            "kv_pool_bytes": self.kv_pool_bytes,
            "kv_granted_bytes": int(granted),
            "kv_block_bytes": self.kv_block_bytes,
            "bytes_limit": self.bytes_limit,
            "activation_headroom_bytes": headroom,
            "live": self._memory.snapshot(),
        }

    def _resident_rows(self) -> list[dict]:
        return [
            {"class": "weights", "bytes": self.weights_bytes},
            {"class": "kv_pool", "bytes": self.kv_pool_bytes},
        ]

    def _check_block_grant(self, req: Request, need: int) -> None:
        """Warn (a ``warning`` event) when this grant pushes weights + granted
        KV blocks past ``bytes_limit``.  Called after ``alloc(need)``."""
        if self.bytes_limit is None:
            return
        projected = self.weights_bytes + self.allocator.used * self.kv_block_bytes
        if projected <= self.bytes_limit:
            return
        self._flight.record("memory", phase="admit", projected_bytes=int(projected),
                            bytes_limit=int(self.bytes_limit))
        self.events.emit(
            "warning",
            reason="kv_grant_over_limit",
            request_id=req.request_id,
            blocks=need,
            projected_bytes=int(projected),
            bytes_limit=int(self.bytes_limit),
            over_bytes=int(projected - self.bytes_limit),
        )

    def _oom(self, exc: BaseException, phase: str) -> None:
        """An allocation failure on a serving step: the plan-against-live
        report through the flight recorder (`observe.memory.record_oom`)."""
        if not memory.is_resource_exhausted(exc):
            return
        memory.record_oom(exc, phase=phase, sampler=self._memory,
                          resident=self._resident_rows(), plan=self.memory_breakdown(),
                          events_logger=self.events)

    # ---------------------------------------------------------- front door

    def submit(self, prompt, max_new_tokens: int, *, sampling: SamplingParams | None = None,
               stop_token: int | None = None) -> int:
        """Queue one request; returns its id.  Admission happens in `step()`."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.cfg.max_seq:
            raise ValueError(
                f"prompt {prompt.size} + max_new_tokens {max_new_tokens} "
                f"exceeds serve max_seq {self.cfg.max_seq}"
            )
        need = math.ceil((prompt.size + max_new_tokens) / self.cfg.block_size)
        if need > self.cfg.num_blocks:
            # even an empty pool could not admit it: queued, it would block
            # the head of the queue forever
            raise ValueError(
                f"request needs {need} KV blocks but the pool holds only {self.cfg.num_blocks}"
            )
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(
            request_id=rid, prompt=prompt, max_new_tokens=max_new_tokens,
            sampling=sampling or SamplingParams(), stop_token=stop_token,
            arrival_time=self._now(),
        ))
        return rid

    def cancel(self, request_id: int) -> bool:
        """Cancel a queued request (removed now) or a running one (evicted at
        the start of the next step, its tokens so far returned with
        ``finish_reason 'cancelled'``).  False for unknown or finished ids."""
        for i, req in enumerate(self.queue):
            if req.request_id == request_id:
                del self.queue[i]
                self._finalize(req, "cancelled", self._now())
                return True
        for req in self.slots:
            if req is not None and req.request_id == request_id:
                self._cancelled.add(request_id)
                return True
        return False

    @property
    def pending(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def run_until_drained(self, max_steps: int = 100_000) -> dict[int, RequestResult]:
        """`step()` until the queue and the slots are empty; returns the
        results (id -> `RequestResult`)."""
        steps = 0
        while self.pending:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"engine not drained after {max_steps} steps (queue={len(self.queue)}, "
                    f"occupied={sum(r is not None for r in self.slots)})"
                )
        return self.results

    # ------------------------------------------------------------ the step

    def step(self) -> None:
        """One engine step: evict cancels, admit, launch one decode step and
        one batched prefill round before reading either back, then publish
        telemetry.

        Prefill first at low occupancy: while more prefills would remain
        after this round and at most half the slots decode, this step skips
        its decode step, so slots fill faster."""
        self._process_cancels()
        self._admit()
        prefer_prefill = (
            len(self._prefillq) > self.cfg.prefill_batch
            and self.occupancy() <= self.cfg.max_batch // 2
        )
        try:
            decode_toks = None if prefer_prefill else self._decode_dispatch()
        except Exception as e:
            self._oom(e, "decode")
            raise
        try:
            prefill_ctx = self._prefill_dispatch()
        except Exception as e:
            self._oom(e, "prefill")
            raise
        try:
            did_decode = self._decode_complete(decode_toks)
        except Exception as e:
            self._oom(e, "decode")
            raise
        try:
            did_prefill = self._prefill_complete(prefill_ctx)
        except Exception as e:
            self._oom(e, "prefill")
            raise
        if self.events.enabled and not self._warming:
            if did_decode:
                self._memory.sample("decode")
            if did_prefill:
                self._memory.sample("prefill")
        self.steps_with_prefill += bool(did_prefill)
        self.steps_with_decode += bool(did_decode)
        if did_prefill or did_decode:
            self._flight.record("step", step=self.step_count, phase="readback",
                                occupancy=self.occupancy())
        self._publish(did_prefill or did_decode)
        self.step_count += 1

    def _process_cancels(self) -> None:
        if not self._cancelled:
            return
        tnow = self._now()
        for s, req in enumerate(self.slots):
            if req is not None and req.request_id in self._cancelled:
                self._cancelled.discard(req.request_id)
                if s in self._prefillq:
                    self._prefillq.remove(s)
                self._evict(s, "cancelled", tnow)
        self._cancelled.clear()  # ids that had already finished

    def _admit(self) -> None:
        while self.queue:
            free = [s for s, r in enumerate(self.slots) if r is None]
            if not free:
                break
            req = self.queue[0]
            need = math.ceil((req.prompt.size + req.max_new_tokens) / self.cfg.block_size)
            blocks = self.allocator.alloc(need)
            if blocks is None:
                break  # the head of the queue waits; FIFO stays deterministic
            self._check_block_grant(req, need)
            self.queue.popleft()
            s = free[0]
            req.slot, req.blocks, req.state = s, blocks, "prefill"
            self.slots[s] = req
            self.block_tables[s, :] = self.scratch
            self.block_tables[s, : len(blocks)] = blocks
            self.index[s] = 0
            self.active[s] = False
            sp = req.sampling
            self.temperature[s] = sp.temperature
            self.top_k[s] = 0 if sp.top_k is None else sp.top_k
            self.top_p[s] = 1.0 if sp.top_p is None else sp.top_p
            # the seed's low 32 bits, two's complement, as the JAX engine
            # keeps it in its int32 state
            s32 = sp.seed & 0xFFFFFFFF
            self.seeds[s] = s32 - (1 << 32) if s32 >= 1 << 31 else s32
            self.counters[s] = 0
            self._dirty = True
            self._prefillq.append(s)
            self.audit.append(("admit", req.request_id, s, tuple(blocks), self.step_count))
            self.events.emit(
                "request_admit",
                request_id=req.request_id,
                prompt_tokens=int(req.prompt.size),
                max_new_tokens=int(req.max_new_tokens),
                queue_depth=len(self.queue),
            )

    def _prefill_dispatch(self):
        """Assemble and launch one chunk for each of the (up to
        ``prefill_batch``) oldest prefilling requests in one batched call.
        The call always has ``min(prefill_batch, max_batch)`` rows, the
        unused ones writing only the scratch block: every round has the
        same shapes, so a request's arithmetic (and, on the card, its bits)
        does not depend on how many others prefill beside it.  Returns
        ``(chunks, first tokens on the device)``, or None."""
        if not self._prefillq:
            return None
        C, MB = self.cfg.prefill_chunk, self.blocks_per_seq
        rows = min(self.cfg.prefill_batch, self.cfg.max_batch)
        take = list(self._prefillq)[:rows]
        ints = np.zeros((rows, C + MB + 4), np.int64)
        ints[:, C : C + MB] = self.scratch
        flt = np.zeros((rows, 2), np.float32)
        chunks = []
        for r, s in enumerate(take):
            req = self.slots[s]
            start = req.prefill_pos
            chunk = req.prompt[start : start + C]
            chunks.append((s, req, start, chunk.size))
            ints[r, : chunk.size] = chunk
            ints[r, C : C + MB] = self.block_tables[s]
            ints[r, C + MB] = start
            ints[r, C + MB + 1] = chunk.size
            ints[r, C + MB + 2] = self.top_k[s]
            ints[r, C + MB + 3] = self.seeds[s]
            flt[r] = self.temperature[s], self.top_p[s]
        first = self._prefill_round(torch.from_numpy(ints).to(self.device),
                                    torch.from_numpy(flt).to(self.device))
        return chunks, first

    def _prefill_complete(self, ctx) -> bool:
        """Apply a launched prefill round: advance positions; rows whose
        prompt completed get their first output token (the TTFT moment) and
        join the decode batch."""
        if ctx is None:
            return False
        chunks, first = ctx
        finishing = any(start + size >= req.prompt.size for _, req, start, size in chunks)
        toks_np = first.cpu().numpy() if finishing else None
        tnow = self._now()
        for r, (s, req, start, size) in enumerate(chunks):
            req.prefill_pos += size
            self.events.emit(
                "prefill",
                request_id=req.request_id,
                chunk=start // self.cfg.prefill_chunk,
                tokens=size,
                done=req.prefill_pos >= req.prompt.size,
            )
            if req.prefill_pos < req.prompt.size:
                continue
            self._prefillq.remove(s)
            tok = int(toks_np[r])
            req.tokens.append(tok)
            req.token_times.append(tnow)
            req.first_token_time = tnow
            if not self._warming:
                self._h_ttft.observe(tnow - req.arrival_time)
            self.counters[s] += 1
            self.last_tok[s] = tok
            self.index[s] = req.prompt.size
            req.state = "decode"
            self.active[s] = True
            self._dirty = True
            if self._finished_by(req, tok):
                self._evict(s, self._finish_reason(req, tok), tnow)
        return True

    def _decode_dispatch(self):
        """Launch one batched token for every active slot (no readback).
        Returns the tokens on the device, or None."""
        if not self.active.any():
            return None
        if self._dirty:
            self._pack_state()
            self._dirty = False
        return self._decode[not self.temperature[self.active].any()]()

    def _decode_complete(self, toks) -> bool:
        """Read back a launched decode step (the step boundary's host sync),
        then finish and evict the streams that completed."""
        if toks is None:
            return False
        toks_np = toks.cpu().numpy()
        tnow = self._now()
        active = np.nonzero(self.active)[0]
        self.last_tok[active] = toks_np[active]
        self.index[active] += 1
        self.counters[active] += 1
        for s in active:
            req = self.slots[s]
            tok = int(toks_np[s])
            if req.token_times and not self._warming:
                self._h_tpot.observe(tnow - req.token_times[-1])
            req.tokens.append(tok)
            req.token_times.append(tnow)
            if self._finished_by(req, tok):
                self._evict(s, self._finish_reason(req, tok), tnow)
        return True

    @staticmethod
    def _finished_by(req: Request, tok: int) -> bool:
        return len(req.tokens) >= req.max_new_tokens or (
            req.stop_token is not None and tok == req.stop_token
        )

    @staticmethod
    def _finish_reason(req: Request, tok: int) -> str:
        if req.stop_token is not None and tok == req.stop_token:
            return "stop"
        return "length"

    def _evict(self, s: int, reason: str, tnow: float) -> None:
        req = self.slots[s]
        self.allocator.free(req.blocks)
        req.blocks = []
        self.slots[s] = None
        self.block_tables[s, :] = self.scratch
        self.active[s] = False
        self._dirty = True
        self._finalize(req, reason, tnow)

    def _finalize(self, req: Request, reason: str, tnow: float) -> None:
        req.state, req.finish_reason, req.finish_time = "finished", reason, tnow
        result = RequestResult(
            request_id=req.request_id,
            tokens=np.asarray(req.tokens, np.int64),
            finish_reason=reason,
            prompt_len=int(req.prompt.size),
            arrival_time=req.arrival_time,
            first_token_time=req.first_token_time,
            finish_time=tnow,
            token_times=list(req.token_times),
        )
        self.results[req.request_id] = result
        self.audit.append(("finish", req.request_id, reason, len(req.tokens), self.step_count))
        self.events.emit(
            "request_finish",
            request_id=req.request_id,
            emitted=len(req.tokens),
            finish_reason=reason,
            ttft=result.ttft,
            tpot_mean=result.tpot_mean,
        )

    def _publish(self, worked: bool) -> None:
        occ = int(self.active.sum())
        self._g_occ.set(occ)
        self._g_queue.set(len(self.queue))
        self._g_blocks.set(self.allocator.used)
        self._g_util.set(self.allocator.utilization())
        if worked and self.step_count % self.cfg.decode_event_every == 0:
            self.events.emit(
                "decode_step",
                step=self.step_count,
                occupancy=occ,
                queue_depth=len(self.queue),
                kv_blocks_used=self.allocator.used,
                kv_block_utilization=self.allocator.utilization(),
            )

    # ----------------------------------------------------------- accessors

    def occupancy(self) -> int:
        return int(self.active.sum())

    def warmup(self) -> None:
        """Run throwaway requests through every path the engine has (each
        prefill row count up to ``prefill_batch``, the greedy and the
        sampled decode step) so the first real request does not pay the
        card's first-use costs.  Telemetry is off meanwhile (no events, no
        TTFT/TPOT observations); the audit, the step counters and the
        results are left as they were."""
        events, self.events = self.events, ev_mod.NULL
        self._warming = True
        try:
            for p in range(1, min(self.cfg.prefill_batch, self.cfg.max_batch) + 1):
                rids = [self.submit(np.zeros((1,), np.int64), 2) for _ in range(p)]
                self.run_until_drained()
                for rid in rids:
                    del self.results[rid]
            rid = self.submit(np.zeros((1,), np.int64), 2,
                              sampling=SamplingParams(temperature=0.5, top_k=2, top_p=0.9))
            self.run_until_drained()
            del self.results[rid]
        finally:
            self.events = events
            self._warming = False
        self.audit.clear()
        self.step_count = 0
        self.steps_with_decode = 0
        self.steps_with_prefill = 0
