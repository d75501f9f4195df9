"""Continuous batching, the counterpart of
``tpu_bootstrap/workload/serving.py``: the ``PagedPool`` engine behind
``serve(paged=True)`` with its ``BlockAllocator``, the replay-slot
``SlotPool`` behind ``serve(paged=False)``, and the ``Scheduler`` in front
of either.

``SlotPool`` keeps no KV cache between rounds: each round left-pads every
active row's whole history into one batch and runs ``decode.generate``
with ``prompt_lengths`` (or, with a draft model,
``speculative.speculative_generate``) for a chunk of the largest power of
two within every row's remaining budget. Free slots ride as length-1
dummy rows whose output is discarded. Re-prefilling the histories each
round (``replayed_tokens``) is the engine's price of admission.

``PagedPool`` keeps one shared pool of fixed-size KV blocks per layer, a
block table per row, and chunked prefill interleaved into decode rounds:

* Admission reserves the request's history plus a slice of its decode
  budget: the WHOLE budget under refusal admission (``reserve_new`` None,
  ``Scheduler(overcommit=False)``), the Scheduler's expected-length
  estimate under overcommit (the default). A row short of blocks grows its
  table lazily before each decode dispatch (``_capacity_fold``), and when
  the pool cannot cover the growth a row is preempted by the victim
  policy (``preempt_one``) and resumed later, so pressure resolves by
  preemption, never by a write into a block the row does not own.
* Each ``step_round`` first spends up to ``prefill_budget`` prompt tokens
  on rows still prefilling (round-robin, power-of-two chunk widths): the
  prompt chunk runs ``speculative._verify_chunk`` over the row's blocks
  gathered into a window, with no head (its logits would be discarded),
  and the window is written back into the pool.
* Then one decode chunk runs for the rows whose prompts are done:
  ``chunk`` steps of ``decode.paged_decode_step`` (kernel K2 for
  attention, kernels K1 / K6 for every int8 / int4 projection and K1e /
  K6e for a MoE model's expert stacks), greedy ``argmax`` kept on the
  card, and ONE host read of the chunk's tokens. On the card each step is
  a replay of a CUDA graph of one step (``graphs``), one graph per table
  width ``nb`` (``_bucket_blocks``), over static buffers the pool keeps
  (``_paged_graph_step``); on the CPU the eager loop
  ``_paged_chunk_kernel`` runs, the body the graphs are held to.
* The chunk is the largest power of two that at least half the cohort
  can consume (``_majority_chunk``), capped while prompts are pending and,
  under overcommit, by the expected length (``chunk_hint``); rows past
  their budget run on and their overshoot is discarded by the event fold.

Automatic prefix caching (``prefix_cache``, on by default as in the
reference): every FULL block a row fills is registered in the
allocator's content-hash index under the radix-chained hash of the tokens
it covers (``block_hash``), and admission walks a new prompt's chain
against the index: matched blocks are refcount-shared into the new row's
table, their prefill is skipped, and only the uncovered footprint is
allocated. Retirement decrefs; a registered block's last reference parks
it in an LRU cached set that allocation reclaims on demand. When the
matched chain reaches into the block the new row must write, that block
is copied (copy-on-write, ``_copy_block``) instead of shared, so a row
never writes a shared block and K2 only ever reads aliased ones.

The host tier (``HostBlockPool``, on by default with the prefix cache,
as large as the pool): an evicted cached block is demoted to host memory
instead of discarded, a preempted row's registered blocks are swapped out
there when the cost model prices the transfer below re-prefilling them
(``_preempt_arm``), and admission promotes host hits back into fresh
blocks with one batched restore.

The pools are updated IN PLACE (the reference donates them to its
jitted rounds): the frontier write, the prefill window scatter, the
copy-on-write copy, the host restore, defrag's relocation and reset's
zeroing all write into the tensors the pool holds, which also keeps the
addresses the captured steps read.

Exactness: a request's tokens equal its solo greedy
``generate(kv_kernel=False)``, up to the order of float sums inside the
kernels (the slot engine's speculative rounds commit the target's own
argmaxes, so they equal its plain rounds); a preempted and resumed stream
equals its never-preempted one, whichever arm resumed it.

The Scheduler keeps the request log (``RequestLog``: each request's
lifecycle events, a span tree at retirement) and the device ledger (each
round's busy time billed to the rows it advanced, FLOPs-weighted), sheds
or cancels requests past their deadline at the round boundary, and
recovers a failed round of the paged engine as a preemption of every
resident row (``PagedPool.quarantine``), fed by the ``pool.device``,
``alloc``, ``sched.admit`` and ``swap.xfer`` fault seams.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
queue 1 item): sampling, the paged engine's speculative rounds and prompt
lookup, the resident engine and the float-pool gather path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import heapq
import math
import os
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import (
    decode_attention,
    faults,
    graphs,
    quant,
)
from tpu_bootstrap_torch.workload.decode import (
    generate,
    init_paged_cache,
    paged_decode_step,
)
from tpu_bootstrap_torch.workload.model import (
    ModelConfig,
    Params,
    flops_model,
    kv_bytes_per_token,
    resolve_device,
)
from tpu_bootstrap_torch.workload.speculative import (
    _verify_chunk,
    speculative_generate,
)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1 item {item})")


@dataclasses.dataclass
class Request:
    rid: int
    tokens: list  # prompt token ids
    max_new: int  # decode budget
    # Higher ``priority`` admits first; within a class, an earlier
    # ``deadline`` (absolute telemetry.monotonic() seconds, None for none)
    # admits first, and a request still waiting or running past it is
    # shed or cancelled at the next round boundary.
    priority: int = 0
    deadline: float | None = None
    # The client's trace id: the request's span tree roots under it (empty:
    # the process root id).
    trace_id: str = ""


@dataclasses.dataclass
class _Slot:
    rid: int
    history: list  # prompt + generated so far
    remaining: int
    generated: list
    # Victim-selection inputs: preemption evicts the lowest ``priority``
    # first, the latest ``seq`` (arrival order) within it.
    priority: int = 0
    seq: int = 0
    deadline: float | None = None


@dataclasses.dataclass
class _PagedSlot(_Slot):
    prompt_len: int = 0
    prefilled: int = 0  # prompt tokens whose KV has been written
    prefill_chunks: int = 0
    admit_round: int = 0
    blocks: list = dataclasses.field(default_factory=list)
    # Prefix-cache bookkeeping: n_shared counts the references into the
    # content-hash index (prefix hits this row never writes); registered
    # counts leading blocks whose chain key has been computed and entered
    # into (or matched against) the index, and chain_key is that prefix's
    # rolling hash, the parent of the next full block's key.
    n_shared: int = 0
    registered: int = 0
    chain_key: bytes = b""
    cached_tokens: int = 0  # prompt tokens served from cache (not prefilled)


def _bucket_up(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _bucket_down(n: int) -> int:
    b = 1
    while b * 2 <= n:
        b *= 2
    return b


def _majority_chunk(active, max_seq_len: int) -> int:
    """Decode chunk for a round over ``active`` slots: the largest power
    of two that at least half the cohort can consume fully, clamped so
    the longest row's writes stay inside ``max_seq_len``."""
    rems = sorted((s.remaining for s in active), reverse=True)
    majority = rems[(len(rems) - 1) // 2]
    headroom = max_seq_len - max(len(s.history) for s in active) + 1
    return _bucket_down(max(1, min(majority, headroom)))


def block_hash(parent: bytes, tokens) -> bytes:
    """Content key of one FULL KV block: sha256 over the int64 bytes of
    the token ids the block covers, CHAINED on the parent block's key
    (radix-style), so a block's key commits to the entire prefix behind
    it. Keys are stable across processes (and equal to the reference's),
    and collision-proof enough that a hit can be trusted as a content
    match."""
    return hashlib.sha256(
        parent + np.asarray(tokens, np.int64).tobytes()).digest()


def key_fingerprint(key: bytes) -> int:
    """64-bit fingerprint of a block's chain key, the cache-digest unit
    (a routing hint; the full key stays the sharing authority)."""
    return int.from_bytes(key[:8], "big")


def digest_match_len(tokens, digest) -> int:
    """How many LEADING full blocks of ``tokens`` a replica's published
    cache digest covers (``{"block_size": bs, "fps": [...]}``, with an
    optional ``host`` tier of the same form): the radix-chained block
    hashes recomputed locally and walked against the digest's
    fingerprints, stopping at the first miss."""
    if not isinstance(digest, dict):
        return 0
    bs = int(digest.get("block_size") or 0)
    if bs < 1:
        return 0
    fpset = set(digest.get("fps") or ())
    host = digest.get("host")
    if isinstance(host, dict):
        fpset |= set(host.get("fps") or ())
    if not fpset:
        return 0
    key = b""
    n = 0
    for j in range(len(tokens) // bs):
        key = block_hash(key, tokens[j * bs:(j + 1) * bs])
        if key_fingerprint(key) not in fpset:
            break
        n += 1
    return n


def _digest_enabled() -> bool:
    return os.environ.get(
        "TPUBC_CACHE_DIGEST", "1").lower() not in ("0", "false")


REQUEST_EVENTS_ENV = "TPUBC_REQUEST_EVENTS"
DEVICE_LEDGER_ENV = "TPUBC_DEVICE_LEDGER"


def device_ledger_enabled() -> bool:
    """The device-time ledger's switch: on unless ``TPUBC_DEVICE_LEDGER``
    is 0. Off, the Scheduler attaches no token dict to the pool, every
    recording site is one attribute read, and the streams are those of a
    run with the ledger on (the ledger only observes)."""
    return os.environ.get(DEVICE_LEDGER_ENV, "1").lower() not in (
        "0", "false")


def request_events_enabled() -> bool:
    """The request log's switch: off with ``TPUBC_REQUEST_EVENTS=0`` or
    when tracing is off (``TPUBC_TRACE_BUFFER=0``); either way the streams
    are unchanged and the serving path appends no event."""
    if os.environ.get(REQUEST_EVENTS_ENV, "1").lower() in ("0", "false"):
        return False
    try:
        if int(os.environ.get("TPUBC_TRACE_BUFFER", "4096")) <= 0:
            return False
    except ValueError:
        pass
    return True


@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle in the request log: its bounded event list
    and the summary fields the snapshot and the retirement spans read."""

    rid: int
    trace_id: str
    priority: int
    deadline: float | None
    submit_us: int
    state: str = "queued"  # queued | running | preempted | retired
    events: list = dataclasses.field(default_factory=list)
    dropped_events: int = 0
    legs: int = 0          # admissions: 1 + the resumes
    preemptions: int = 0
    retire_reason: str = ""
    generated: int = 0
    footprint_blocks: int = 0
    cached_tokens: int = 0
    # What a replayable arrival record needs (``arrivals``).
    prompt_len: int = 0
    max_new: int = 0
    # The engine busy ms billed to this request by the device ledger, and
    # its split by work kind.
    device_ms: float = 0.0
    device_by_kind: dict = dataclasses.field(default_factory=dict)


# The phase a request is in AFTER each event kind: the gap between two
# events is billed to the phase in effect during it, so the phases
# partition [first event, last event]. prefill_chunk keeps the phase
# (prefill on a first leg, recompute on a resumed one).
_PHASE_AFTER = {
    "enqueued": "queue",
    "preempted": "queue",   # waiting to resume is queue wait
    "admitted": "prefill",
    "resumed": "recompute",
    "decode_round": "decode",
    "grown": "decode",
}


def _phase_segments(events: list) -> list:
    """[(phase, start_us, dur_us)]: the runs of one phase over the gaps
    between consecutive events (the child spans of a request's span)."""
    segs: list = []
    if not events:
        return segs
    cur = "queue"
    prev_t = events[0]["t_us"]
    for e in events[1:]:
        t = e["t_us"]
        if t > prev_t:
            if segs and segs[-1][0] == cur:
                segs[-1] = (cur, segs[-1][1], segs[-1][2] + (t - prev_t))
            else:
                segs.append((cur, prev_t, t - prev_t))
        prev_t = t
        nxt = _PHASE_AFTER.get(e["kind"])
        if nxt is not None:
            cur = nxt
    return segs


class RequestLog:
    """The serving engine's flight recorder: a bounded ring of recent and
    in-flight requests (``TPUBC_REQUESTZ_RING``, default 256; retired
    records evicted first, least recently touched first), each with a
    bounded event list (``TPUBC_REQUEST_EVENT_CAP``, default 512; the
    overflow counted in ``dropped_events``): enqueued, admitted,
    prefill_chunk, decode_round, grown, preempted, resumed, retired,
    appended by the Scheduler and the pool as they happen. At retirement
    a request becomes a ``serve.request`` span in ``telemetry.tracer()``
    with one ``serve.phase.<phase>`` child per phase run, and its phase
    times roll into the ``serve_phase_share_*`` gauges. Off
    (``request_events_enabled``), every method returns at once."""

    PHASES = ("queue", "prefill", "decode", "recompute")

    def __init__(self, capacity: int | None = None,
                 max_events: int | None = None,
                 enabled: bool | None = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("TPUBC_REQUESTZ_RING", "256"))
            except ValueError:
                capacity = 256
        if max_events is None:
            try:
                max_events = int(
                    os.environ.get("TPUBC_REQUEST_EVENT_CAP", "512"))
            except ValueError:
                max_events = 512
        self.capacity = max(1, capacity)
        self.max_events = max(8, max_events)
        self.enabled = (request_events_enabled() if enabled is None
                        else enabled)
        self._lock = threading.Lock()
        self._recs: OrderedDict = OrderedDict()  # rid -> RequestRecord  # guarded-by: _lock
        self._phase_totals = {p: 0.0 for p in self.PHASES}  # guarded-by: _lock

    # ---- recording --------------------------------------------------------

    def start(self, rid: int, *, trace_id: str = "", priority: int = 0,
              deadline: float | None = None, queue_position: int = 0,
              prompt_len: int = 0, max_new: int = 0) -> None:
        if not self.enabled:
            return
        with self._lock:
            t = telemetry.now_us()
            rec = RequestRecord(
                rid=rid, trace_id=trace_id or telemetry.root_trace_id(),
                priority=priority, deadline=deadline, submit_us=t,
                prompt_len=prompt_len, max_new=max_new)
            rec.events.append({
                "kind": "enqueued", "t_us": t, "priority": priority,
                "deadline": deadline, "queue_position": queue_position})
            self._recs[rid] = rec
            self._recs.move_to_end(rid)
            while len(self._recs) > self.capacity:
                # Retired records go first; only a ring smaller than the
                # in-flight set drops a live one.
                victim = next((r for r, v in self._recs.items()
                               if v.state == "retired"), None)
                if victim is None:
                    victim = next(iter(self._recs))
                del self._recs[victim]

    def event(self, rid: int, kind: str, **attrs) -> None:
        if not self.enabled:
            return
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None:
                return  # evicted, or started before the log
            if len(rec.events) >= self.max_events:
                rec.dropped_events += 1
                return
            e = {"kind": kind, "t_us": telemetry.now_us()}
            e.update(attrs)
            rec.events.append(e)
            if kind in ("admitted", "resumed"):
                rec.state = "running"
                rec.legs += 1
                if kind == "admitted":
                    rec.cached_tokens = int(attrs.get("cached_tokens", 0))
            elif kind == "preempted":
                rec.state = "preempted"
                rec.preemptions += 1
            self._recs.move_to_end(rid)

    def add_device(self, rid: int, ms: float,
                   by_kind: dict | None = None) -> None:
        """Bill ``ms`` of engine busy time to a request (the ledger's
        attribution); unknown or evicted rids are ignored."""
        if not self.enabled or ms <= 0:
            return
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None:
                return
            rec.device_ms += ms
            if by_kind:
                for k, v in by_kind.items():
                    rec.device_by_kind[k] = (
                        rec.device_by_kind.get(k, 0.0) + v)

    def retire(self, rid: int) -> None:
        """Close a record: fold its retired event's summary in, emit its
        span tree and roll its phase times into the share gauges.
        Idempotent."""
        if not self.enabled:
            return
        with self._lock:
            rec = self._recs.get(rid)
            if rec is None or rec.state == "retired":
                return
            rec.state = "retired"
            last = rec.events[-1]
            if last["kind"] == "retired":
                rec.retire_reason = last.get("reason", "")
                rec.generated = int(last.get("generated", 0))
                rec.footprint_blocks = int(last.get("footprint_blocks", 0))
            segs = _phase_segments(rec.events)
            tr = telemetry.tracer()
            parent = tr.add_span(
                "serve.request", rec.submit_us,
                last["t_us"] - rec.submit_us,
                trace_id=rec.trace_id, rid=rec.rid, priority=rec.priority,
                reason=rec.retire_reason, tokens=rec.generated,
                preemptions=rec.preemptions, legs=rec.legs,
                cached_tokens=rec.cached_tokens)
            for ph, start, dur in segs:
                tr.add_span(f"serve.phase.{ph}", start, dur,
                            trace_id=rec.trace_id,
                            parent_id=parent.span_id, rid=rec.rid)
                self._phase_totals[ph] += dur
            tot = sum(self._phase_totals.values())
            if tot > 0:
                reg = telemetry.metrics()
                for ph, v in self._phase_totals.items():
                    reg.set_gauge(f"serve_phase_share_{ph}",
                                  round(v / tot, 4))

    def abort_inflight(self, reason: str = "error") -> None:
        """Retire every record still open (a failed round's victims must
        not show as running forever)."""
        if not self.enabled:
            return
        with self._lock:
            rids = [rid for rid, rec in self._recs.items()
                    if rec.state != "retired"]
        for rid in rids:
            self.event(rid, "retired", reason=reason)
            self.retire(rid)

    # ---- reading ----------------------------------------------------------

    def _phases_locked(self, rec: RequestRecord) -> dict:
        out = {f"{p}_ms": 0.0 for p in self.PHASES}
        for ph, _, dur in _phase_segments(rec.events):
            out[f"{ph}_ms"] += dur / 1e3
        out = {k: round(v, 3) for k, v in out.items()}
        out["total_ms"] = round(
            (rec.events[-1]["t_us"] - rec.submit_us) / 1e3, 3)
        out["preemptions"] = rec.preemptions
        out["legs"] = rec.legs
        out["device_ms"] = round(rec.device_ms, 3)
        if rec.device_by_kind:
            out["device_ms_by_kind"] = {
                k: round(v, 3) for k, v in rec.device_by_kind.items()}
        return out

    def phases(self, rid: int) -> dict | None:
        """One request's phase breakdown (queue, prefill, decode and
        recompute ms, total, preemptions, legs, device ms), or None."""
        with self._lock:
            rec = self._recs.get(rid)
            return None if rec is None else self._phases_locked(rec)

    def trace_of(self, rid: int) -> str:
        with self._lock:
            rec = self._recs.get(rid)
            return "" if rec is None else rec.trace_id

    def phase_shares(self) -> dict:
        """The cumulative share of retired-request time in each phase."""
        with self._lock:
            tot = sum(self._phase_totals.values())
            if tot <= 0:
                return {p: 0.0 for p in self.PHASES}
            return {p: round(v / tot, 4)
                    for p, v in self._phase_totals.items()}

    def snapshot(self, rid: int | None = None) -> dict:
        """Every record (or ``rid``'s), most recently touched first."""
        with self._lock:
            recs = list(self._recs.values())
            if rid is not None:
                recs = [r for r in recs if r.rid == rid]
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "requests": [{
                    "rid": r.rid,
                    "trace_id": r.trace_id,
                    "state": r.state,
                    "priority": r.priority,
                    "deadline": r.deadline,
                    "submit_us": r.submit_us,
                    "legs": r.legs,
                    "preemptions": r.preemptions,
                    "reason": r.retire_reason,
                    "generated": r.generated,
                    "footprint_blocks": r.footprint_blocks,
                    "cached_tokens": r.cached_tokens,
                    "dropped_events": r.dropped_events,
                    "phases": self._phases_locked(r),
                    "events": [dict(e) for e in r.events],
                } for r in reversed(recs)],
            }

    def arrivals(self) -> list:
        """One flat record a request in arrival order: what a replay of
        the traffic needs."""
        with self._lock:
            recs = sorted(self._recs.values(), key=lambda r: r.submit_us)
            return [{"rid": r.rid,
                     "t_arrival_us": r.submit_us,
                     "prompt_len": r.prompt_len,
                     "max_new": r.max_new,
                     "priority": r.priority,
                     "deadline": r.deadline,
                     "trace_id": r.trace_id} for r in recs]


class BlockAllocator:
    """Bookkeeping of the shared KV block pool: ids 1..num_blocks (id 0
    is the null block that pads short tables and is never owned),
    lowest-id-first allocation from a min-heap, loud double-free and
    exhaustion errors. Host state only: the device sees the block tables
    built from it.

    Blocks are refcounted and content-addressable (the reference's
    prefix cache): a block is FREE (on the heap), LIVE (refcount >= 1,
    one reference per row table that maps it) or CACHED (refcount 0 but
    registered in the content-hash index, its KV kept for a future
    prefix hit). ``free`` is a decref: the last reference of a registered
    block parks it in an LRU cached set, and ``alloc`` evicts the oldest
    cached blocks when the heap alone cannot cover a request, so cached
    blocks never refuse an admission (``available`` counts them)."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks, self.block_size = num_blocks, block_size
        self._free = list(range(1, num_blocks + 1))  # a valid heap
        self._ref: dict = {}  # live block id -> refcount (>= 1)
        self._cached = OrderedDict()  # ref-0 registered blocks, LRU order
        self._index: dict = {}  # content key -> block id (live or cached)
        self._key_of: dict = {}  # registered block id -> content key
        self.stats = {"allocs": 0, "frees": 0, "peak_used": 0,
                      "evictions": 0, "hash_hits": 0}
        # 64-bit fingerprints of every registered chain key, kept up to
        # date on register and evict (TPUBC_CACHE_DIGEST=0 turns it off;
        # observability only, streams are untouched either way).
        self.digest_enabled = _digest_enabled()
        self._digest: set = set()
        # Demotion seam for the host tier: called with (bid, key) for every
        # cached block an eviction reclaims, before its index entry goes.
        # None: eviction discards.
        self.evict_hook = None

    # ---- accounting -------------------------------------------------------

    def available(self) -> int:
        """Blocks an admission may claim: free plus reclaimable cached."""
        return len(self._free) + len(self._cached)

    def used(self) -> int:
        """LIVE blocks only (cached ones are counted by ``cached``)."""
        return len(self._ref)

    def cached(self) -> int:
        return len(self._cached)

    def is_cached(self, bid: int) -> bool:
        return bid in self._cached

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    # ---- alloc / refcount lifecycle ---------------------------------------

    def alloc(self, n: int) -> list:
        # The injected invariant breach fires before any mutation, so
        # recovery quarantines an allocator that is still self-consistent.
        faults.fire("alloc")
        if n < 1:
            raise ValueError(f"alloc of {n} blocks")
        if n > self.available():
            raise RuntimeError(
                f"KV block pool exhausted: want {n}, free {self.available()} "
                f"of {self.num_blocks} (admission must check admits/"
                "available first)")
        while len(self._free) < n:
            self.evict_one()
        ids = [heapq.heappop(self._free) for _ in range(n)]
        for i in ids:
            self._ref[i] = 1
        self.stats["allocs"] += n
        self.stats["peak_used"] = max(self.stats["peak_used"], len(self._ref))
        return ids

    def evict_one(self) -> int:
        """Reclaim the oldest cached block: it leaves the index and
        returns to the heap (after ``evict_hook``, if set, has seen it).
        Returns its id; raises KeyError when nothing is cached."""
        bid, key = self._cached.popitem(last=False)
        if self.evict_hook is not None:
            self.evict_hook(bid, key)
        del self._index[key]
        del self._key_of[bid]
        if self.digest_enabled:
            self._digest.discard(key_fingerprint(key))
        heapq.heappush(self._free, bid)
        self.stats["evictions"] += 1
        return bid

    def incref(self, bid: int) -> None:
        """Add a table reference to a live or cached block (a prefix hit);
        a cached block revives, and stays registered."""
        if bid in self._cached:
            del self._cached[bid]
            self._ref[bid] = 1
        elif bid in self._ref:
            self._ref[bid] += 1
        else:
            raise ValueError(
                f"incref of KV block {bid} which is neither live nor "
                "cached (sharing a free block would alias its next owner's "
                "KV)")
        self.stats["hash_hits"] += 1
        self.stats["peak_used"] = max(self.stats["peak_used"], len(self._ref))

    def free(self, ids: list) -> None:
        """Decref each id. The last reference of a registered block parks
        it in the cached LRU set (its KV kept); of an unregistered one
        returns it to the heap."""
        for i in ids:
            if i not in self._ref:
                raise ValueError(
                    f"double free of KV block {i} (not currently allocated)")
            self._ref[i] -= 1
            if self._ref[i] == 0:
                del self._ref[i]
                if i in self._key_of:
                    self._cached[i] = self._key_of[i]  # MRU end
                else:
                    heapq.heappush(self._free, i)
        self.stats["frees"] += len(ids)

    # ---- content-hash index -----------------------------------------------

    def register(self, bid: int, key: bytes) -> bool:
        """Enter a FULL live block into the index under ``key``. Returns
        False when the key is already indexed (the existing block keeps
        it, and this duplicate frees to the heap at its last decref) or
        the block already carries a key (one key for life)."""
        if bid not in self._ref:
            raise ValueError(
                f"register of KV block {bid} which is not live (only a "
                "referenced block's content is known to be complete)")
        if key in self._index or bid in self._key_of:
            return False
        self._index[key] = bid
        self._key_of[bid] = key
        if self.digest_enabled:
            self._digest.add(key_fingerprint(key))
        return True

    def lookup(self, key: bytes) -> int | None:
        """The block holding the content ``key`` names, or None
        (read-only: callers incref on use)."""
        return self._index.get(key)

    def remap(self, mapping: dict) -> None:
        """Rewrite every id through ``mapping`` (old -> new) after the
        caller relocated the pool arrays (defrag): refcounts, the cached
        LRU set (order kept) and the index follow; every live and cached
        block must be in ``mapping``. The heap is rebuilt from the
        complement."""
        self._ref = {mapping[b]: c for b, c in self._ref.items()}
        self._cached = OrderedDict(
            (mapping[b], k) for b, k in self._cached.items())
        self._key_of = {mapping[b]: k for b, k in self._key_of.items()}
        self._index = {k: mapping[b] for k, b in self._index.items()}
        taken = set(self._ref) | set(self._cached)
        self._free = [i for i in range(1, self.num_blocks + 1)
                      if i not in taken]
        heapq.heapify(self._free)

    def quarantine_to_cache(self) -> None:
        """Crash recovery's allocator half (``PagedPool.quarantine``): drop
        every live reference (the tables they mirrored died with the
        crashed round's slots), keeping registered content as cached so
        the resumed rows' re-prefill hits it; unregistered live blocks
        return to the heap. Tolerates any refcount state. Afterwards: no
        live block, cached == registered, the heap the rest."""
        for bid in list(self._ref):
            del self._ref[bid]
            if bid in self._key_of:
                self._cached[bid] = self._key_of[bid]
            else:
                heapq.heappush(self._free, bid)

    def digest_json(self) -> dict:
        """The routable digest of the cache: the 64-bit fingerprint of
        every registered chain key (cached and shareable live blocks)."""
        if not self.digest_enabled:
            return {"version": 1, "block_size": self.block_size,
                    "blocks": 0, "fps": []}
        return {"version": 1, "block_size": self.block_size,
                "blocks": len(self._digest), "fps": sorted(self._digest)}

    def compactness(self) -> float:
        """1.0 when the LIVE set is a dense prefix of the id space (cached
        blocks are reclaimable and not counted)."""
        if not self._ref:
            return 1.0
        return len(self._ref) / max(self._ref)


class HostBlockPool:
    """The host-memory tier under the paged KV cache: KV blocks copied off
    the card, keyed by the same radix chain keys as the allocator's
    content index, so a block's life is HBM cached -> host -> gone. Fed by
    demotion (the allocator's LRU evictions) and by preemption victims
    swapped out; drained by admission promoting host hits back into the
    pool, and by its own LRU past ``capacity``.

    An entry is ``{"t": [{name: host tensor} per layer], "d": None,
    "bytes": n}`` (``d`` is the reference's draft-pool slot, which the
    port's paged engine does not have yet). Entries hold no device state,
    so the tier survives ``PagedPool.reset``. A key names token content,
    not a location, so the same key in both tiers is never stale."""

    def __init__(self, capacity: int, block_size: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity, self.block_size = capacity, block_size
        self._entries = OrderedDict()  # chain key -> entry, LRU order
        self.bytes = 0
        self.stats = {"puts": 0, "drops": 0, "promotions": 0,
                      "hit_tokens": 0}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    def keys(self):
        """Chain keys in LRU order, oldest first."""
        return self._entries.keys()

    def put(self, key: bytes, entry: dict) -> None:
        """Park one block. A key already parked only moves to the MRU end
        (its payload is the same content); past capacity the oldest entry
        drops."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        self._entries[key] = entry
        self.bytes += entry["bytes"]
        self.stats["puts"] += 1
        while len(self._entries) > self.capacity:
            _k, dropped = self._entries.popitem(last=False)
            self.bytes -= dropped["bytes"]
            self.stats["drops"] += 1

    def get(self, key: bytes):
        return self._entries.get(key)

    def pop(self, key: bytes) -> dict:
        """Claim a parked block for promotion: it leaves the tier, and the
        promoted block re-enters the content index under the same key."""
        entry = self._entries.pop(key)
        self.bytes -= entry["bytes"]
        self.stats["promotions"] += 1
        return entry

    def clear(self) -> None:
        self._entries.clear()
        self.bytes = 0

    def snapshot_json(self) -> dict:
        return {"blocks": len(self._entries), "capacity": self.capacity,
                "bytes": self.bytes,
                "hit_tokens": self.stats["hit_tokens"],
                "swap_ins": self.stats["promotions"],
                "swap_outs": self.stats["puts"],
                "dropped": self.stats["drops"]}

    def digest_json(self) -> dict:
        """The fingerprints of every parked key, in the HBM digest's unit,
        so ``digest_match_len`` scores host hits too."""
        return {"blocks": len(self._entries), "bytes": self.bytes,
                "fps": sorted(key_fingerprint(k) for k in self._entries)}


def _gather_windows(pools: list, bt: torch.Tensor) -> list:
    """Pools -> per-row contiguous windows (B, nb * bs, ...) through the
    block tables (B, nb); pad entries read the null block, which every
    mask excludes."""
    idx = bt.long()

    def one(a):
        g = a[idx]
        return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])

    return [{n: one(a) for n, a in layer.items()} for layer in pools]


def _scatter_windows(pools: list, windows: list, bt: torch.Tensor) -> None:
    """Write the windows back through the tables, IN PLACE. Duplicate
    indices only ever name the null block, whose content is never
    read."""
    b, nb = bt.shape
    idx = bt.long()
    for layer, window in zip(pools, windows):
        for n, a in layer.items():
            a[idx] = window[n].reshape(b, nb, *a.shape[1:])


def _paged_prefill_chunk(params: Params, pools: list, bt: torch.Tensor,
                         tokens: torch.Tensor, pos: torch.Tensor,
                         cfg: ModelConfig) -> None:
    """One chunk of a row's prefill: tokens (1, w) at positions
    [pos, pos + w) of the row's paged cache, through the vector-pos
    multi-query forward over the gathered window (einsum attention), no
    head; the window is written back into the pools in place."""
    windows = _gather_windows(pools, bt)
    _verify_chunk(params, tokens, pos, windows, cfg, logits=False)
    _scatter_windows(pools, windows, bt)


def _paged_chunk_kernel(params: Params, pools: list, bt: torch.Tensor,
                        last: torch.Tensor, pos: torch.Tensor,
                        cfg: ModelConfig, chunk: int) -> torch.Tensor:
    """``chunk`` greedy decode steps over the paged pools: every step
    writes each row's new KV at its frontier and attends over the row's
    own blocks through kernel K2. Tokens stay on the device; returns
    (B, chunk)."""
    tok, p, toks = last, pos, []
    for _ in range(chunk):
        logits, _ = paged_decode_step(params, tok, p, pools, bt, cfg)
        tok = torch.argmax(logits, dim=-1)
        toks.append(tok)
        p = p + 1
    return torch.stack(toks, dim=1)


def _paged_graph_step(params: Params, pools: list, bt: torch.Tensor,
                      tok: torch.Tensor, pos: torch.Tensor, out: torch.Tensor,
                      step: torch.Tensor, cfg: ModelConfig) -> None:
    """One step of ``_paged_chunk_kernel`` on the pool's static buffers,
    the body its graphs capture: tokens ``tok`` (B,) at frontiers ``pos``
    (B,) through table ``bt`` (B, nb), the argmax written into ``out``
    (B, C) at column ``step``, and all three advanced in place."""
    logits, _ = paged_decode_step(params, tok, pos, pools, bt, cfg)
    graphs.commit(torch.argmax(logits, dim=-1), tok, pos, out, step)


def _copy_block(pools: list, src: int, dst: int) -> None:
    """Copy-on-write: block ``src`` copied into block ``dst`` in every
    layer's K, V and scales, in place, so a row can extend a shared or
    cached prefix block in its private copy."""
    for layer in pools:
        for a in layer.values():
            a[dst].copy_(a[src])


class _PoolBase:
    """What every serving engine shares: admission validation, the
    free-slot scan, the per-round event fold, cancellation and the
    request-log and ledger recording sites."""

    eos_id: int | None = None
    # The Scheduler's RequestLog when its events are on; a pool driven
    # bare keeps None and pays one attribute read a would-be event.
    request_log: RequestLog | None = None
    # The device ledger's scratch for the round: {rid: {"prefill" |
    # "decode": tokens}} advanced this round. The Scheduler attaches a
    # fresh dict before each round and folds it after; None (a bare pool,
    # or the ledger off) makes every recording site a no-op.
    ledger_tokens: dict | None = None

    def _levent(self, rid: int, kind: str, **attrs) -> None:
        """Append one lifecycle event for ``rid`` (no-op without a log)."""
        log = self.request_log
        if log is not None:
            log.event(rid, kind, **attrs)

    def _ledger_add(self, rid: int, kind: str, n: int) -> None:
        """Count ``n`` tokens of ``kind`` work for ``rid`` this round
        (no-op without an attached ledger)."""
        led = self.ledger_tokens
        if led is not None and n > 0:
            row = led.setdefault(rid, {})
            row[kind] = row.get(kind, 0) + n

    def _slot_json(self, i: int, s) -> dict:
        return {"slot": i, "rid": s.rid, "priority": s.priority,
                "seq": s.seq, "deadline": s.deadline,
                "history_tokens": len(s.history),
                "generated": len(s.generated), "remaining": s.remaining}

    def snapshot(self) -> dict:
        """The pool's state: engine, occupancy, each row and the stats.
        Call it from the engine's thread, between rounds."""
        slots = [self._slot_json(i, s)
                 for i, s in enumerate(list(self.slots)) if s is not None]
        return {"engine": type(self).__name__,
                "batch_size": self.batch_size,
                "active": len(slots),
                "free_slots": self.batch_size - len(slots),
                "slots": slots,
                "stats": dict(self.stats)}

    def cancel(self, i: int, reason: str = "deadline") -> dict:
        """Cancel the row in slot ``i`` at a round boundary (deadline
        enforcement): its terminal event, its resources released through
        the retirement hook (the paged engine returns its blocks), the
        slot cleared; returns the terminal stream event with the prefix
        it committed."""
        s = self.slots[i]
        self._levent(s.rid, "retired", reason=reason,
                     generated=len(s.generated),
                     footprint_blocks=len(getattr(s, "blocks", ()) or ()))
        self._on_retire(i, s)
        self.slots[i] = None
        return {"new": [], "done": True, "generated": list(s.generated)}

    @staticmethod
    def validate(r: Request, cfg: ModelConfig) -> None:
        if r.max_new < 1:
            raise ValueError(f"request {r.rid}: max_new must be >= 1")
        if not r.tokens:
            raise ValueError(f"request {r.rid}: empty prompt")
        if _bucket_up(len(r.tokens) + r.max_new) > cfg.max_seq_len:
            raise ValueError(
                f"request {r.rid}: prompt ({len(r.tokens)}) + max_new "
                f"({r.max_new}) buckets to "
                f"{_bucket_up(len(r.tokens) + r.max_new)} > the model's "
                f"max_seq_len ({cfg.max_seq_len})")

    def _on_retire(self, i: int, s) -> None:
        """Called by the event fold just before a finished row's slot is
        cleared."""

    def free_slots(self) -> int:
        return sum(1 for s in self.slots if s is None)

    def has_active(self) -> bool:
        return any(s is not None for s in self.slots)

    def _free_index(self) -> int:
        for i in range(self.batch_size):
            if self.slots[i] is None:
                return i
        raise RuntimeError("no free slot (check free_slots before admit)")

    def _emit_events(self, out: list, counts: list,
                     kind: str = "decode") -> dict:
        """Fold one round's per-slot outputs (``out[i]`` a token list,
        ``counts[i]`` how many it may keep) into slot state: extend
        histories, cut at eos, clamp to each row's remaining budget,
        retire finished rows. The kept steps count as ``kind`` work in
        the ledger. Returns {rid: {"new", "done", "generated"}}."""
        events = {}
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            keep = min(counts[i], s.remaining)
            if keep <= 0:
                continue
            # The ledger bills the executed steps: eos may cut what is
            # delivered below ``keep``, but the device ran every step.
            self._ledger_add(s.rid, kind, keep)
            got = list(out[i][:keep])
            s.generated += got
            s.history += got
            s.remaining -= keep
            if self.eos_id is not None and self.eos_id in got:
                cut = len(s.generated) - len(got) + got.index(self.eos_id) + 1
                got = s.generated[len(s.generated) - len(got):cut]
                s.generated = s.generated[:cut]
                s.remaining = 0
                telemetry.metrics().inc("serve_eos_retired_total")
            done = s.remaining == 0
            events[s.rid] = {"new": got, "done": done,
                             "generated": s.generated}
            if self.request_log is not None and got:
                self._levent(s.rid, "decode_round", tokens=len(got),
                             round=self.stats.get("rounds", 0))
            if done:
                if self.request_log is not None:
                    # Before _on_retire clears the table: the footprint is
                    # part of the record.
                    reason = ("eos" if (self.eos_id is not None and got
                                        and got[-1] == self.eos_id)
                              else "budget")
                    self._levent(
                        s.rid, "retired", reason=reason,
                        generated=len(s.generated),
                        footprint_blocks=len(
                            getattr(s, "blocks", ()) or ()))
                self._on_retire(i, s)
                self.slots[i] = None
        return events


class SlotPool(_PoolBase):
    """The replay-slot engine: ``batch_size`` decode slots, no KV cache
    kept between rounds, every round a ragged left-padded replay of the
    active histories through ``generate`` (greedy, the einsum path: per-row
    masks). With ``draft_params`` each round runs the speculative
    verify-commit loop instead, which commits the target's own argmaxes,
    so the streams are unchanged. Drive it with ``admit`` and
    ``step_round``."""

    def __init__(self, params: Params, cfg: ModelConfig, batch_size: int, *,
                 kv_quant: bool = False, eos_id: int | None = None,
                 temperature: float = 0.0,
                 draft_params: Params | None = None,
                 draft_cfg: ModelConfig | None = None, gamma: int = 4,
                 device=None):
        if temperature != 0.0:
            raise _not_ported("sampling (temperature > 0)",
                              "5: sampling with threefry bit-parity")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if draft_params is not None:
            if draft_cfg is None:
                raise ValueError("draft_params requires draft_cfg")
            if gamma < 1:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
        self.device = resolve_device(device)
        for name, tree in (("params", params), ("draft_params", draft_params)):
            if tree is not None and tree["embed"].device != self.device:
                raise ValueError(f"{name} live on {tree['embed'].device}, "
                                 f"the pool on {self.device}")
        self.params, self.cfg = params, cfg
        self.batch_size = batch_size
        self.kv_quant = kv_quant
        self.eos_id = eos_id
        self.draft_params, self.draft_cfg, self.gamma = (
            draft_params, draft_cfg, gamma)
        self.slots: list = [None] * batch_size
        self.stats = {"rounds": 0, "slot_steps": 0, "active_slot_steps": 0,
                      "replayed_tokens": 0}
        if draft_params is not None:
            self.stats.update({"verify_rounds": 0, "committed_tokens": 0,
                               "draft_steps": 0})
        telemetry.metrics().set_gauge("serve_target_stream_bytes",
                                      quant.decode_stream_bytes(params))

    def reset(self) -> None:
        """Abandon every in-flight row; the pool keeps no device state
        beyond its slots."""
        self.slots = [None] * self.batch_size

    def admits(self, r: Request, *, extra_slots: int = 0,
               extra_blocks: int = 0, reserve_new: int | None = None,
               preload: list | None = None) -> bool:
        """Capacity is slots, not blocks: the Scheduler's block inputs
        (``extra_blocks``, ``reserve_new``, ``preload``) mean nothing
        here."""
        return self.free_slots() > extra_slots

    def admit(self, r: Request, *, reserve_new: int | None = None,
              preload: list | None = None, seq: int = 0) -> None:
        """Place a validated request in a free slot (raises when full:
        callers check ``admits``). The slot engine never overcommits nor
        preempts, so it has nothing to resume."""
        if preload:
            raise ValueError("slot engines never preempt, so they have "
                             "nothing to resume (preload is paged-only)")
        self.validate(r, self.cfg)
        self._levent(r.rid, "admitted", engine="slot",
                     prompt=len(r.tokens))
        self.slots[self._free_index()] = _Slot(
            rid=r.rid, history=list(r.tokens), remaining=r.max_new,
            generated=[], priority=r.priority, seq=seq,
            deadline=r.deadline)

    def step_round(self) -> dict:
        """One round over the active slots; returns the event fold's
        {rid: {"new", "done", "generated"}}."""
        active = [s for s in self.slots if s is not None]
        if not active:
            return {}
        # A device fault or abort: fires only when a round would dispatch.
        faults.fire("pool.device")
        # The largest power of two within every active row's budget: each
        # round retires a row or at least halves the smallest budget.
        chunk = _bucket_down(min(s.remaining for s in active))
        lens = [len(s.history) if s is not None else 1 for s in self.slots]
        width = _bucket_up(max(lens))
        batch = torch.zeros((self.batch_size, width), dtype=torch.long)
        for i, s in enumerate(self.slots):
            if s is not None:
                batch[i, width - len(s.history):] = torch.tensor(s.history)
        batch = batch.to(self.device)
        if self.draft_params is None:
            out = generate(self.params, batch, self.cfg, chunk,
                           kv_quant=self.kv_quant, prompt_lengths=lens,
                           device=self.device)
        else:
            out, spec = speculative_generate(
                self.params, self.draft_params, batch, self.cfg,
                self.draft_cfg, chunk, gamma=self.gamma,
                kv_quant=self.kv_quant, with_stats=True, prompt_lengths=lens,
                device=self.device)
            self.stats["verify_rounds"] += spec["verify_rounds"]
            # gamma + 1 draft steps a verify round (speculative.py's
            # draft-cache-hole note).
            self.stats["draft_steps"] += (spec["verify_rounds"]
                                          * (self.gamma + 1))
            self.stats["committed_tokens"] += len(active) * chunk
        self.stats["rounds"] += 1
        self.stats["replayed_tokens"] += sum(len(s.history) for s in active)
        # The replay is this engine's prefill: a row's share of the round
        # grows with its history, not only its chunk of new tokens.
        for s in active:
            self._ledger_add(s.rid, "prefill", len(s.history))
        self.stats["slot_steps"] += self.batch_size * chunk
        self.stats["active_slot_steps"] += len(active) * chunk
        return self._emit_events(out.tolist(), [chunk] * self.batch_size)


class PagedPool(_PoolBase):
    """Block-paged continuous batching over int8 or int4 weights (dense
    or MoE) and an int8 KV pool: ``batch_size`` rows at most, ``kv_blocks`` blocks of
    ``block_size`` tokens (default: ``batch_size`` max-length rows'
    worth), prompts prefilled in chunks of at most ``prefill_budget``
    tokens per round, full prompt blocks shared through the prefix cache
    unless ``prefix_cache`` is off, and a host tier of ``host_blocks``
    blocks under it (None: ``TPUBC_KV_HOST_BLOCKS``, unset meaning as
    many as ``kv_blocks``; 0: none). ``block_size``, ``prefill_budget``,
    ``prefix_cache`` and ``spec_lookup`` left None read the reference's
    knobs: ``TPUBC_KV_BLOCK`` (64), ``TPUBC_PREFILL_BUDGET`` (64),
    ``TPUBC_PREFIX_CACHE`` (on) and ``TPUBC_SPEC_LOOKUP`` (off). Drive it
    with ``admit`` and ``step_round``; preempted rows' resume records
    collect in ``preempted``."""

    def __init__(self, params: Params, cfg: ModelConfig, batch_size: int, *,
                 kv_blocks: int | None = None, block_size: int | None = None,
                 prefill_budget: int | None = None, kv_quant: bool = False,
                 eos_id: int | None = None, temperature: float = 0.0,
                 draft_params: Params | None = None,
                 spec_lookup: bool | None = None,
                 prefix_cache: bool | None = None,
                 host_blocks: int | None = None, device=None):
        # None reads the reference's knobs, with its defaults:
        # TPUBC_SPEC_LOOKUP (off), TPUBC_KV_BLOCK (64), TPUBC_PREFILL_BUDGET
        # (64) and TPUBC_PREFIX_CACHE (on).
        if spec_lookup is None:
            spec_lookup = os.environ.get(
                "TPUBC_SPEC_LOOKUP", "").lower() in ("1", "true")
        if temperature != 0.0:
            raise _not_ported("sampling (temperature > 0)",
                              "5: sampling with threefry bit-parity")
        if draft_params is not None or spec_lookup:
            raise _not_ported("speculative serving (draft_params, "
                              "spec_lookup)", "5: paged spec rounds")
        if not kv_quant:
            raise _not_ported("the float KV pool (gather/einsum decode)",
                              "8: the other engines")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if block_size is None:
            block_size = int(os.environ.get("TPUBC_KV_BLOCK", "64"))
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if prefill_budget is None:
            prefill_budget = int(os.environ.get("TPUBC_PREFILL_BUDGET", "64"))
        if prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1, got {prefill_budget}")
        if not decode_attention.paged_supports(block_size, cfg.kv_heads,
                                               cfg.head_dim, cfg.num_heads):
            raise ValueError(
                f"block_size={block_size} with (H={cfg.num_heads}, "
                f"Hk={cfg.kv_heads}, D={cfg.head_dim}) is outside the paged "
                "kernel's limits; see decode_attention.paged_supports")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"pool on {self.device}")
        self.block_size = block_size
        self.max_bpr = -(-cfg.max_seq_len // block_size)  # blocks per row cap
        if kv_blocks is None:
            kv_blocks = batch_size * self.max_bpr
        if kv_blocks < 1:
            raise ValueError(f"kv_blocks must be >= 1, got {kv_blocks}")
        self.prefill_budget = prefill_budget
        self.params, self.cfg = params, cfg
        self.batch_size = batch_size
        self.kv_quant = kv_quant
        self.eos_id = eos_id
        if prefix_cache is None:
            prefix_cache = os.environ.get(
                "TPUBC_PREFIX_CACHE", "1").lower() not in ("0", "false")
        self.prefix_cache = prefix_cache
        # Overcommit's decode-chunk cap, set by the Scheduler to its
        # expected-length EMA before every round; None leaves the chunk
        # rule as it is under refusal admission.
        self.chunk_hint: int | None = None
        # rid -> prompt tokens served from cache at admission.
        self.request_cached_tokens: dict = {}
        self.allocator = BlockAllocator(kv_blocks, block_size)
        # kv_blocks usable blocks + the null block (id 0).
        self.pools = init_paged_cache(cfg, kv_blocks + 1, block_size,
                                      quantized=True, device=self.device)
        self.slots: list = [None] * batch_size
        self._pre_rr = 0  # round-robin cursor over prefilling rows
        # Resume records of preempted rows, drained by the Scheduler into
        # its waiting queue after every step.
        self.preempted: list = []
        self.stats = {"rounds": 0, "slot_steps": 0, "active_slot_steps": 0,
                      "prefill_tokens": 0, "prefill_chunks": 0,
                      "blocks_total": kv_blocks, "blocks_peak": 0,
                      "defrags": 0, "prompt_tokens": 0,
                      "prefix_hit_tokens": 0, "prefix_hit_requests": 0,
                      "cow_copies": 0, "preemptions": 0, "grown_blocks": 0}
        # Measured prefill cost per token (an EMA over the prefill phase),
        # the recompute arm's price; None until a prefill chunk has run.
        self._prefill_ms_per_tok: float | None = None
        self._kv_bytes_per_tok = kv_bytes_per_token(cfg, kv_quant)
        # The decode chunk's captured steps (None off the card) and the
        # static buffers they read and advance: last tokens, frontiers, a
        # step counter, the chunk's output (B, the largest chunk) and one
        # table per width nb, all allocated outside any capture.
        self._graphs = graphs.for_device(self.device)
        self._tok = torch.zeros(batch_size, dtype=torch.long,
                                device=self.device)
        self._pos = torch.zeros_like(self._tok)
        self._step = torch.zeros(1, dtype=torch.long, device=self.device)
        self._out = torch.zeros((batch_size, _bucket_down(cfg.max_seq_len)),
                                dtype=torch.long, device=self.device)
        self._tables: dict = {}
        # Set while an in-place write of the pools is under way (a prefill
        # chunk's scatter, a copy-on-write copy, a host restore, a decode
        # chunk, defrag): a failure that leaves it set may have written
        # some layers of a block and not others, so quarantine resets the
        # pools instead of salvaging their content.
        self._torn = False
        self._host_init(host_blocks)
        telemetry.metrics().set_gauge("serve_target_stream_bytes",
                                      quant.decode_stream_bytes(params))
        self._record_block_gauges()

    # ---- capacity ---------------------------------------------------------

    def blocks_needed(self, r: Request) -> int:
        """Blocks the request's whole footprint reserves (refusal
        admission's reservation, and the bound ``validate`` checks)."""
        return -(-(len(r.tokens) + r.max_new) // self.block_size)

    def _reserve_blocks(self, history_len: int, remaining: int,
                        reserve_new: int | None) -> int:
        """Blocks admission reserves now: the whole history plus the
        reserved slice of the decode budget, all of it when
        ``reserve_new`` is None (refusal admission), else the Scheduler's
        estimate clamped into [1, remaining]."""
        new = (remaining if reserve_new is None
               else max(1, min(remaining, reserve_new)))
        return -(-(history_len + new) // self.block_size)

    def admits(self, r: Request, *, extra_slots: int = 0,
               extra_blocks: int = 0, reserve_new: int | None = None,
               preload: list | None = None) -> bool:
        """Whether the pool can take ``r`` (resumed with ``preload``, its
        tokens generated before a preemption) now, reserving
        ``reserve_new`` decode tokens, with ``extra_slots`` and
        ``extra_blocks`` already promised to requests ahead of it. HBM
        prefix hits cost nothing fresh, but a hit on a CACHED block (and a
        cached copy-on-write source, pinned across the copy) revives it
        out of the reclaimable set, so it is debited from ``available``.
        Host hits get no discount: each needs a fresh block to be promoted
        into."""
        if self.free_slots() <= extra_slots:
            return False
        history = list(r.tokens) + list(preload or [])
        remaining = r.max_new - len(preload or [])
        plan, cow, _ = self._prefix_plan(history)
        n_hbm = sum(1 for tier, _b, _k in plan if tier == "hbm")
        pinned = sum(1 for tier, b, _k in plan
                     if tier == "hbm" and self.allocator.is_cached(b))
        if cow is not None and self.allocator.is_cached(cow):
            pinned += 1
        return (self.allocator.available() - extra_blocks - pinned
                >= self._reserve_blocks(len(history), remaining,
                                        reserve_new) - n_hbm)

    def validate(self, r: Request, cfg: ModelConfig) -> None:
        _PoolBase.validate(r, cfg)
        if self.blocks_needed(r) > self.allocator.num_blocks:
            raise ValueError(
                f"request {r.rid}: needs {self.blocks_needed(r)} KV blocks "
                f"but the pool only has {self.allocator.num_blocks} \u2014 it "
                "can never be admitted (raise kv_blocks or shrink the "
                "request)")

    def _prefilling(self, s) -> bool:
        # The last prompt token is never prefilled: the first decode step
        # re-feeds it from the frontier and emits the first logits.
        return s.prefilled < s.prompt_len - 1

    def reset(self) -> None:
        """Abandon every in-flight row and empty the pool: a new allocator
        (its content index described blocks that are zeroed now), the
        pools zeroed, the host tier kept. The reference allocates new
        arrays here; the port zeroes the ones it has IN PLACE, because
        the captured decode steps read these tensors' addresses, and new
        tensors would leave every graph reading freed memory."""
        self.slots = [None] * self.batch_size
        self.request_cached_tokens.clear()
        self.preempted.clear()
        self.allocator = BlockAllocator(self.allocator.num_blocks,
                                        self.block_size)
        for layer in self.pools:
            for a in layer.values():
                a.zero_()
        self._torn = False
        if self.host is not None:
            # Host entries hold no device state, so resumed rows promote
            # from them; only the new allocator needs the seam again.
            self.allocator.evict_hook = self._demote_block
        self._record_block_gauges()

    @contextlib.contextmanager
    def _writing(self):
        """An in-place write of the pools: ``_torn`` stays set if the
        block raises."""
        self._torn = True
        yield
        self._torn = False

    def quarantine(self, reason: str = "crash") -> list:
        """Crash-is-preemption: a failed round preempts every resident row
        at once. Each row becomes the resume record ``_preempt`` parks
        (prompt, and what it generated as preload), with a
        ``preempted(reason=crash)`` event; the records, and any preempted
        ones not yet drained, are returned for the Scheduler to requeue.
        KV is a function of token and position alone, so the resumed
        streams equal uninterrupted ones.

        The reference asks whether its donated arrays were consumed; the
        port writes its pools in place, and asks whether a write was cut
        short (``_torn``). If none was (a failure at ``pool.device``,
        ``alloc``, ``sched.admit`` or ``swap.xfer``, all before or between
        writes), the registered content is salvaged into the cache
        (``quarantine_to_cache``) and the re-prefill mostly hits it; if one
        was, ``reset`` zeroes the pools in place (the captured steps keep
        their addresses) and nothing is salvaged."""
        recs = list(self.preempted)
        self.preempted.clear()
        alive = not self._torn
        for s in self.slots:
            if s is None:
                continue
            self._levent(s.rid, "preempted", reason=reason,
                         phase=("prefill" if self._prefilling(s)
                                else "decode"),
                         generated=len(s.generated),
                         blocks_freed=len(s.blocks))
            self.stats["crash_preempts"] = (
                self.stats.get("crash_preempts", 0) + 1)
            prompt = s.history[:len(s.history) - len(s.generated)]
            recs.append({"request": Request(rid=s.rid, tokens=prompt,
                                            max_new=(len(s.generated)
                                                     + s.remaining),
                                            priority=s.priority,
                                            deadline=s.deadline),
                         "preload": list(s.generated), "seq": s.seq,
                         "t": telemetry.monotonic()})
        if alive:
            try:
                if self.prefix_cache:
                    for s in self.slots:
                        if s is not None:
                            self._register_full(s)
                self.allocator.quarantine_to_cache()
            except Exception:  # noqa: BLE001 - the salvage is best-effort
                alive = False
        self.slots = [None] * self.batch_size
        self.request_cached_tokens.clear()
        if not alive:
            self.reset()
        self._record_block_gauges()
        return recs

    # ---- host tier --------------------------------------------------------

    def _host_init(self, host_blocks: int | None) -> None:
        """Build the host tier, or none. ``host_blocks`` None reads
        TPUBC_KV_HOST_BLOCKS: unset or "auto" sizes the tier at the pool's
        block count, 0 turns it off. The tier exists only with the prefix
        cache (its keys are the cache's)."""
        if host_blocks is None:
            env = os.environ.get("TPUBC_KV_HOST_BLOCKS", "auto").lower()
            host_blocks = (self.allocator.num_blocks
                           if env in ("", "auto") else int(env))
        if host_blocks < 0:
            raise ValueError(f"host_blocks must be >= 0, got {host_blocks}")
        self.host = (HostBlockPool(host_blocks, self.block_size)
                     if host_blocks and self.prefix_cache else None)
        # Measured host-link rate (an EMA over timed transfers); None until
        # the first one, when the cost model prices with the seed.
        self._host_gbps_ema: float | None = None
        if self.host is not None:
            # Demotion runs inside alloc()'s eviction pass, which only
            # admission and the capacity fold call, both before a round's
            # decode chunk: no host copy ever runs inside a graph capture.
            self.allocator.evict_hook = self._demote_block

    def _host_gbps(self) -> float:
        """The rate transfers are priced at: the measured EMA once a
        transfer has been timed, the seed before."""
        return self._host_gbps_ema or telemetry.host_xfer_gbps()

    def _note_bw(self, nbytes: float, secs: float) -> None:
        """Fold one timed host<->device transfer into the rate EMA (the
        prefill EMA's 0.8/0.2 blend) and publish it."""
        if nbytes <= 0 or secs <= 0:
            return
        gbps = nbytes / secs / 1e9
        self._host_gbps_ema = (
            gbps if self._host_gbps_ema is None
            else 0.8 * self._host_gbps_ema + 0.2 * gbps)
        telemetry.metrics().set_gauge(
            "serve_swap_bandwidth_gbps", round(self._host_gbps_ema, 4))

    def _host_fetch(self, bid: int) -> dict:
        """Copy ONE block of every layer (K, V and their scales) to host
        memory: the demotion and swap-out transfer. Each copy waits for the
        device, at a round boundary only. The ``swap.xfer`` fault fires
        before the device is touched, so a failed transfer leaves nothing
        half-copied."""
        faults.fire("swap.xfer")
        t = [{n: a[bid].to("cpu", copy=True) for n, a in layer.items()}
             for layer in self.pools]
        nbytes = sum(x.numel() * x.element_size() for layer in t
                     for x in layer.values())
        return {"t": t, "d": None, "bytes": nbytes}

    def _host_restore(self, ids: list, entries: list) -> int:
        """Promote host entries into blocks ``ids``: per pool tensor ONE
        stacked host-to-device copy and one ``index_copy_`` into the
        tensor the pool holds (in place: the captured steps read its
        address). Waits for the device, so the time is the transfer's.
        Returns the bytes moved."""
        idx = torch.tensor(ids, dtype=torch.long, device=self.device)
        for li, layer in enumerate(self.pools):
            for n, a in layer.items():
                payload = torch.stack([e["t"][li][n] for e in entries])
                a.index_copy_(0, idx, payload.to(self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return sum(e["bytes"] for e in entries)

    def _demote_block(self, bid: int, key: bytes) -> None:
        """``allocator.evict_hook``: an evicted cached block goes to the
        host tier instead of away. A failed transfer degrades to a plain
        eviction; a key already parked needs no second copy."""
        if key in self.host:
            return
        t0 = time.perf_counter()
        try:
            entry = self._host_fetch(bid)
        except faults.InjectedFault:
            return
        self.host.put(key, entry)
        self._note_bw(entry["bytes"], time.perf_counter() - t0)
        telemetry.metrics().inc("serve_swap_out_bytes_total",
                                entry["bytes"])

    def demote_lru(self, n: int = 1) -> int:
        """Demote up to ``n`` of the oldest cached blocks through the
        eviction seam (maintenance and tests; serving demotes in alloc()'s
        own eviction pass). Returns how many were evicted."""
        done = 0
        while done < n and self.allocator.cached():
            self.allocator.evict_one()
            done += 1
        return done

    def _preempt_arm(self, s) -> tuple:
        """Swap or recompute for one victim: the victim's KV bytes over the
        host-link rate against its history re-prefilled at the measured
        prefill cost (before any prefill was timed: the model's prefill
        FLOPs at the card's bf16 peak, the H100 SXM's where no card
        reports one). Returns (arm, swap_ms, recompute_ms); recompute
        when the tier is off."""
        swap_ms = (len(s.history) * self._kv_bytes_per_tok
                   / (self._host_gbps() * 1e9) * 1e3)
        per_tok = self._prefill_ms_per_tok
        if per_tok is None:
            peak = telemetry.peak_tflops() or telemetry.H100_SXM_BF16_TFLOPS
            per_tok = flops_model(self.cfg)["prefill"] / (peak * 1e12) * 1e3
        recomp_ms = max(len(s.history) - 1, 0) * per_tok
        if self.host is None:
            return "recompute", swap_ms, recomp_ms
        return (("swap" if swap_ms < recomp_ms else "recompute"),
                swap_ms, recomp_ms)

    def _swap_out(self, s) -> None:
        """Swap a victim out: park its registered full blocks on the host
        tier (walking the chain keys over its history, skipping content
        already parked), so its resume promotes them instead of
        re-prefilling. A failed transfer stops the walk: what was parked
        still serves the resume, the rest is recomputed."""
        t0 = time.perf_counter()
        bs = self.block_size
        moved = blocks_moved = 0
        key = b""
        for j in range(s.registered):
            key = block_hash(key, s.history[j * bs:(j + 1) * bs])
            if key in self.host:
                continue
            try:
                entry = self._host_fetch(s.blocks[j])
            except faults.InjectedFault:
                break
            self.host.put(key, entry)
            moved += entry["bytes"]
            blocks_moved += 1
        secs = time.perf_counter() - t0
        if moved:
            self._note_bw(moved, secs)
            telemetry.metrics().inc("serve_swap_out_bytes_total", moved)
        self.stats["swap_preempts"] = self.stats.get("swap_preempts", 0) + 1
        self.stats["swap_out_blocks"] = (
            self.stats.get("swap_out_blocks", 0) + blocks_moved)
        telemetry.metrics().observe("serve_preempt_cost",
                                    round(secs * 1e3, 3),
                                    labels={"arm": "swap"})

    def _register_full(self, s) -> None:
        """Enter ``s``'s newly FULL blocks into the content-hash index: a
        block is full once every position it covers holds written KV
        (through ``prefilled`` while the prompt prefills, through
        ``len(history) - 1`` once decoding: the last token's KV is written
        by the next step). Keys chain on the row's running prefix hash; a
        duplicate (another block already holds the content) advances the
        chain without being indexed."""
        written = (s.prefilled if self._prefilling(s)
                   else len(s.history) - 1)
        nfull = min(written // self.block_size, len(s.blocks))
        while s.registered < nfull:
            j = s.registered
            s.chain_key = block_hash(
                s.chain_key,
                s.history[j * self.block_size:(j + 1) * self.block_size])
            self.allocator.register(s.blocks[j], s.chain_key)
            s.registered += 1

    def _register_phase(self) -> None:
        if not self.prefix_cache:
            return
        for s in self.slots:
            if s is not None:
                self._register_full(s)

    def _on_retire(self, i: int, s) -> None:
        # Register the trailing full blocks first (a retiring row is the
        # cache's main producer), then decref every table reference.
        if self.prefix_cache:
            self._register_full(s)
        self.allocator.free(s.blocks)
        s.blocks = []
        self._record_block_gauges()

    def _cache_digest_json(self) -> dict:
        """The allocator's digest, with the host tier's under ``host`` when
        the tier exists (empty when the digest is off)."""
        base = self.allocator.digest_json()
        if self.host is None:
            return base
        return {**base,
                "host": (self.host.digest_json()
                         if self.allocator.digest_enabled
                         else {"blocks": 0, "bytes": 0, "fps": []})}

    def _record_block_gauges(self) -> None:
        a = self.allocator
        live = sum((len(s.history) if not self._prefilling(s)
                    else s.prefilled)
                   for s in self.slots if s is not None)
        telemetry.record_kv_block_pool(
            total=a.num_blocks, used=a.used(), free=a.available(),
            cached=a.cached(), capacity_tokens=a.used() * self.block_size,
            live_tokens=live, peak_used=a.stats["peak_used"],
            compactness=a.compactness())
        if self.stats["prompt_tokens"]:
            telemetry.metrics().set_gauge(
                "serve_prefix_hit_rate",
                round(self.stats["prefix_hit_tokens"]
                      / self.stats["prompt_tokens"], 4))
        telemetry.metrics().set_gauge(
            "serve_kv_live_bytes",
            a.used() * self.block_size * self._kv_bytes_per_tok)
        telemetry.metrics().set_gauge(
            "serve_host_blocks", len(self.host) if self.host is not None else 0)
        self.stats["blocks_peak"] = a.stats["peak_used"]

    # ---- admission --------------------------------------------------------

    def _prefix_plan(self, tokens: list):
        """The longest cached full-block chain covering ``tokens`` (a
        prompt, or a resumed row's prompt + generated): (plan,
        copy-on-write source id or None, chain key of the covered prefix).
        The plan walks through both tiers: each entry is ("hbm", block id,
        key) for a block in the pool or ("host", None, key) for content
        parked on the host tier (admission promotes it into a fresh
        block). Plan blocks lie strictly below the row's first write
        position (its last token, re-fed at decode); an HBM match that
        would contain it is returned as the copy-on-write source, a host
        match there is ignored (a round trip for one partial block).
        Read-only: refcounts and host claims move in ``admit``."""
        if not self.prefix_cache:
            return [], None, b""
        bs = self.block_size
        key = b""
        hits = []
        for j in range(len(tokens) // bs):
            key = block_hash(key, tokens[j * bs:(j + 1) * bs])
            bid = self.allocator.lookup(key)
            if bid is not None:
                hits.append(("hbm", bid, key))
            elif self.host is not None and key in self.host:
                hits.append(("host", None, key))
            else:
                break
        n_sh = min(len(hits), (len(tokens) - 1) // bs)
        cow = (hits[n_sh][1]
               if len(hits) > n_sh and hits[n_sh][0] == "hbm" else None)
        chain = hits[n_sh - 1][2] if n_sh else b""
        return hits[:n_sh], cow, chain

    def admit(self, r: Request, *, reserve_new: int | None = None,
              preload: list | None = None, seq: int = 0) -> None:
        """Reserve the request's blocks and enqueue its prompt. The longest
        cached chain over the history is taken first: HBM hits are
        refcount-shared into the new table, host hits are promoted into
        fresh blocks by one batched restore, and their tokens skip prefill
        (``prefilled`` starts past them); only the uncovered footprint is
        allocated. ``reserve_new`` reserves that many decode tokens (None:
        the whole budget, refusal admission); the capacity fold grows the
        rest lazily. ``preload`` resumes a preempted request: the tokens
        it generated rejoin the history, which is re-prefilled through the
        cache, and its stream goes on unchanged (KV is a function of token
        and position alone). ``seq`` is its arrival order, for the victim
        policy."""
        self.validate(r, self.cfg)
        i = self._free_index()
        if not self.admits(r, reserve_new=reserve_new, preload=preload):
            raise RuntimeError(
                f"request {r.rid}: pool has a free slot but not enough "
                "free KV blocks (callers check admits() before admit)")
        history = list(r.tokens) + list(preload or [])
        remaining = r.max_new - len(preload or [])
        plan, cow, chain = self._prefix_plan(history)
        # Claim host payloads before any refcount moves: a failed transfer
        # truncates the plan there (the tail, and the copy-on-write above
        # it, are recomputed) with the allocator untouched.
        host_pay: dict = {}
        for pi, (tier, _b, k) in enumerate(plan):
            if tier != "host":
                continue
            try:
                faults.fire("swap.xfer")
            except faults.InjectedFault:
                plan = plan[:pi]
                cow = None
                chain = plan[-1][2] if plan else b""
                break
            host_pay[pi] = self.host.pop(k)
        shared = [b for tier, b, _k in plan if tier == "hbm"]
        for b in shared:
            self.allocator.incref(b)
        if cow is not None:
            # Pinned across the alloc below, whose eviction pass must not
            # reclaim it before the copy reads it.
            self.allocator.incref(cow)
        fresh = self.allocator.alloc(
            self._reserve_blocks(len(history), remaining, reserve_new)
            - len(shared))
        # The table in chain order: HBM hits keep their shared block, host
        # hits take fresh blocks to be promoted into, the remaining fresh
        # blocks cover the rest.
        blocks, promote, fi = [], [], 0
        for pi, (tier, b, k) in enumerate(plan):
            if tier == "hbm":
                blocks.append(b)
            else:
                blocks.append(fresh[fi])
                promote.append((fresh[fi], k, host_pay[pi]))
                fi += 1
        blocks += fresh[fi:]
        prompt_len = len(history)
        if promote:
            t0 = time.perf_counter()
            with self._writing():
                moved = self._host_restore([d for d, _k, _e in promote],
                                           [e for _d, _k, e in promote])
            secs = time.perf_counter() - t0
            self._note_bw(moved, secs)
            hit = len(promote) * self.block_size
            reg = telemetry.metrics()
            reg.observe("serve_swap_restore_ms", round(secs * 1e3, 3))
            reg.inc("serve_swap_in_bytes_total", moved)
            reg.inc("serve_host_hit_tokens_total", hit)
            self.host.stats["hit_tokens"] += hit
            self.stats["host_hit_tokens"] = (
                self.stats.get("host_hit_tokens", 0) + hit)
            self.stats["swap_in_blocks"] = (
                self.stats.get("swap_in_blocks", 0) + len(promote))
            for dest, k, _e in promote:
                # Indexed again under its chain key: live (this row's
                # reference) and hittable by the next sharer.
                self.allocator.register(dest, k)
        hit_tokens = len(plan) * self.block_size
        if cow is not None:
            with self._writing():
                _copy_block(self.pools, cow, fresh[fi])
            self.allocator.free([cow])  # unpin
            hit_tokens = min(hit_tokens + self.block_size, prompt_len - 1)
            self.stats["cow_copies"] += 1
        self.stats["prompt_tokens"] += prompt_len
        self.stats["prefix_hit_tokens"] += hit_tokens
        if hit_tokens:
            self.stats["prefix_hit_requests"] += 1
            telemetry.metrics().inc("kv_prefix_hit_tokens_total", hit_tokens)
        if preload is None:
            # A resume keeps the answer of the request's first admission.
            self.request_cached_tokens[r.rid] = hit_tokens
        else:
            # The preemption's price: the tokens the resume re-prefills,
            # what the cache did not keep of the victim's blocks.
            recomp = max(0, prompt_len - 1 - hit_tokens)
            telemetry.metrics().inc("serve_preempt_recompute_tokens_total",
                                    recomp)
            if self._prefill_ms_per_tok is not None:
                telemetry.metrics().observe(
                    "serve_preempt_cost",
                    round(recomp * self._prefill_ms_per_tok, 3),
                    labels={"arm": "recompute"})
        self._levent(
            r.rid, "resumed" if preload else "admitted",
            blocks=len(blocks), shared_blocks=len(shared),
            fresh_blocks=len(fresh), promoted_blocks=len(promote),
            expected_new=reserve_new, remaining=remaining,
            cached_tokens=hit_tokens, cow=int(cow is not None),
            prompt=prompt_len)
        self.slots[i] = _PagedSlot(
            rid=r.rid, history=history, remaining=remaining,
            generated=list(preload or []), priority=r.priority, seq=seq,
            deadline=r.deadline, prompt_len=prompt_len,
            prefilled=hit_tokens, admit_round=self.stats["rounds"],
            blocks=blocks, n_shared=len(shared), registered=len(plan),
            chain_key=chain, cached_tokens=hit_tokens)
        self._record_block_gauges()

    # ---- overcommit: preemption and lazy growth ---------------------------

    def _preempt(self, i: int, reason: str = "capacity") -> dict:
        """Evict row ``i``: register its full blocks (so the resume mostly
        hits the cache), choose its arm (swap parks the registered blocks
        on the host tier now; recompute records the swap it did not take,
        priced, as ``arm=swap_est``), decref its table, clear the slot and
        park a resume record in ``preempted``. ``reason`` names the policy
        key that chose the victim, in the request log's event."""
        s = self.slots[i]
        if self.prefix_cache:
            self._register_full(s)
        arm, swap_ms, _recomp_ms = self._preempt_arm(s)
        if arm == "swap":
            self._swap_out(s)
        else:
            telemetry.metrics().observe("serve_preempt_cost",
                                        round(swap_ms, 3),
                                        labels={"arm": "swap_est"})
        self._levent(s.rid, "preempted", reason=reason, arm=arm,
                     phase=("prefill" if self._prefilling(s) else "decode"),
                     generated=len(s.generated), blocks_freed=len(s.blocks))
        self.allocator.free(s.blocks)
        s.blocks = []
        self.slots[i] = None
        self.stats["preemptions"] += 1
        telemetry.metrics().inc("serve_preempt_total")
        prompt = s.history[:len(s.history) - len(s.generated)]
        rec = {"request": Request(rid=s.rid, tokens=prompt,
                                  max_new=len(s.generated) + s.remaining,
                                  priority=s.priority, deadline=s.deadline),
               "preload": list(s.generated), "seq": s.seq,
               "t": telemetry.monotonic()}  # serve_resume_gap_ms starts
        self.preempted.append(rec)
        self._record_block_gauges()
        return rec

    def preempt_one(self, below: int | None = None) -> dict | None:
        """Evict ONE row by the victim policy: the lowest priority first,
        then decode-phase rows before prefilling ones (a prefilling row has
        shown a client nothing), the latest arrival within that; with
        ``below``, only rows of a priority strictly below it. Returns the
        resume record, or None when no row qualifies."""
        cands = [(s.priority, self._prefilling(s), -s.seq, i)
                 for i, s in enumerate(self.slots) if s is not None]
        if below is not None:
            cands = [c for c in cands if c[0] < below]
        if not cands:
            return None
        cands.sort()
        victim = cands[0]
        if below is not None or any(c[0] != victim[0] for c in cands[1:]):
            reason = "priority"
        elif any(c[1] != victim[1] for c in cands[1:]):
            reason = "phase"
        else:
            reason = "arrival"
        return self._preempt(victim[3], reason)

    def imminent_growth(self, horizon: int | None = None) -> int:
        """Blocks the active rows need within the next ``horizon`` decode
        tokens (default a block's worth): overcommit admission keeps them
        free, since an admission into them would only become the next
        round's preemption. Rows whose reservation covers the horizon add
        nothing, so under refusal admission this is 0."""
        if horizon is None:
            horizon = self.block_size
        need = 0
        for s in self.slots:
            if s is None:
                continue
            short = (len(s.history) + min(horizon, s.remaining)
                     - len(s.blocks) * self.block_size)
            if short > 0:
                need += -(-short // self.block_size)
        return need

    def _capacity_fold(self, dec: list, tokens_of) -> list:
        """Grow each row of ``dec`` to cover ``tokens_of(s)`` positions
        before the decode dispatch, preempting by the victim policy while
        the pool cannot cover the growth. Returns the surviving rows.
        ``validate`` caps a row's whole footprint at the pool, so once
        every other row is evicted the last one fits. Under refusal
        admission every row owns its blocks already: a no-op."""
        while dec:
            need = {id(s): max(0, -(-tokens_of(s) // self.block_size)
                               - len(s.blocks))
                    for s in dec}
            if sum(need.values()) <= self.allocator.available():
                for s in dec:
                    if need[id(s)]:
                        s.blocks += self.allocator.alloc(need[id(s)])
                        self.stats["grown_blocks"] += need[id(s)]
                        self._levent(s.rid, "grown", blocks=need[id(s)],
                                     total_blocks=len(s.blocks))
                break
            self.preempt_one()
            alive = {id(s) for s in self.slots if s is not None}
            dec = [s for s in dec if id(s) in alive]
        return dec

    # ---- rounds -----------------------------------------------------------

    def _table(self, nb: int, rows=None) -> torch.Tensor:
        """(B, nb) int32 block table on the device: each row's blocks,
        clipped or null-padded to nb; slots outside ``rows`` are all-null
        dummies whose writes land on block 0 and whose outputs are
        discarded."""
        keep = None if rows is None else {id(s) for s in rows}
        bt = torch.zeros((self.batch_size, nb), dtype=torch.int32)
        for i, s in enumerate(self.slots):
            if s is None or (keep is not None and id(s) not in keep):
                continue
            own = s.blocks[:nb]
            bt[i, :len(own)] = torch.tensor(own, dtype=torch.int32)
        return bt.to(self.device)

    def _bucket_blocks(self, need: int) -> int:
        return min(_bucket_up(max(1, need)), self.max_bpr)

    def _prefill_phase(self) -> None:
        budget = self.prefill_budget
        pre = [(i, s) for i, s in enumerate(self.slots)
               if s is not None and self._prefilling(s)]
        if not pre:
            return
        t_phase = time.perf_counter()
        toks_phase = 0
        # Round-robin start so one huge prompt cannot starve later
        # arrivals of the budget.
        start = self._pre_rr % len(pre)
        self._pre_rr += 1
        for i, s in pre[start:] + pre[:start]:
            while budget > 0 and self._prefilling(s):
                w = _bucket_down(min(s.prompt_len - 1 - s.prefilled, budget))
                nb = self._bucket_blocks(
                    -(-(s.prefilled + w) // self.block_size))
                bt = self._table(nb, rows=(s,))[i:i + 1]
                tokens = torch.tensor(
                    [s.history[s.prefilled:s.prefilled + w]],
                    dtype=torch.long, device=self.device)
                pos = torch.tensor([s.prefilled], dtype=torch.long,
                                   device=self.device)
                with self._writing():
                    _paged_prefill_chunk(self.params, self.pools, bt,
                                         tokens, pos, self.cfg)
                s.prefilled += w
                s.prefill_chunks += 1
                budget -= w
                toks_phase += w
                self.stats["prefill_tokens"] += w
                self.stats["prefill_chunks"] += 1
                self._ledger_add(s.rid, "prefill", w)
                self._levent(s.rid, "prefill_chunk", tokens=w,
                             prefilled=s.prefilled,
                             round=self.stats["rounds"])
                telemetry.metrics().observe(
                    "serve_prefill_chunk_tokens", w,
                    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512))
            if not self._prefilling(s):
                # Over how many chunks and rounds a prompt's prefill spread.
                telemetry.metrics().observe(
                    "serve_prefill_interleave_chunks", s.prefill_chunks,
                    buckets=(1, 2, 4, 8, 16, 32))
                telemetry.metrics().observe(
                    "serve_prefill_interleave_rounds",
                    self.stats["rounds"] - s.admit_round,
                    buckets=(1, 2, 4, 8, 16, 32, 64))
            if budget <= 0:
                break
        if toks_phase > 0:
            # The recompute arm's price: the phase's host time a token (the
            # reference's clock, the dispatch: no device sync here).
            ms_per_tok = (time.perf_counter() - t_phase) * 1e3 / toks_phase
            self._prefill_ms_per_tok = (
                ms_per_tok if self._prefill_ms_per_tok is None
                else 0.8 * self._prefill_ms_per_tok + 0.2 * ms_per_tok)

    def _decoding(self) -> list:
        return [s for s in self.slots
                if s is not None and not self._prefilling(s)
                and s.remaining > 0]

    def _chunk_len(self, dec: list) -> int:
        """The decode chunk of a round over the rows ``dec``: the majority
        rule, capped at the prefill budget while prompts are pending (so
        prefill chunks interleave at budget cadence, the TTFT bound) and,
        under overcommit, at the expected length (``chunk_hint``: chunks
        follow expectation, which bounds each round's growth)."""
        chunk = _majority_chunk(dec, self.cfg.max_seq_len)
        if any(self._prefilling(s) for s in self.slots if s is not None):
            chunk = min(chunk, _bucket_down(self.prefill_budget))
        if self.chunk_hint is not None:
            chunk = min(chunk, _bucket_down(max(1, self.chunk_hint)))
        return chunk

    def _decode_inputs(self, dec: list, chunk: int) -> tuple:
        """The device inputs of a ``chunk``-step decode over the rows
        ``dec``: (block table (B, nb) on the device, last tokens (B,) and
        frontiers (B,) on the host); rows outside ``dec`` are dummies at
        token 0, position 0 and an all-null table."""
        decoding = {id(s) for s in dec}
        rows = [s if s is not None and id(s) in decoding else None
                for s in self.slots]
        last = torch.tensor([s.history[-1] if s else 0 for s in rows],
                            dtype=torch.long)
        pos = torch.tensor([len(s.history) - 1 if s else 0 for s in rows],
                           dtype=torch.long)
        nb = self._bucket_blocks(max(
            -(-(len(s.history) + chunk - 1) // self.block_size)
            for s in dec))
        return self._table(nb, rows=dec), last, pos

    def _decode_chunk(self, bt: torch.Tensor, last: torch.Tensor,
                      pos: torch.Tensor, chunk: int) -> list:
        """``chunk`` greedy decode steps from ``last`` at ``pos`` through
        table ``bt``; returns the (B, chunk) tokens as lists, read from the
        device once. On the card: the static buffers loaded, then the
        captured step of the table's width replayed ``chunk`` times (the
        first step of a new width is the warm-up, then the capture). Off
        the card: ``_paged_chunk_kernel``."""
        if self._graphs is None:
            return _paged_chunk_kernel(
                self.params, self.pools, bt, last.to(self.device),
                pos.to(self.device), self.cfg, chunk).tolist()
        nb = bt.shape[1]
        if nb not in self._tables:
            self._tables[nb] = torch.zeros_like(bt)
        table = self._tables[nb]
        table.copy_(bt)
        self._tok.copy_(last)
        self._pos.copy_(pos)
        self._step.zero_()
        self._graphs.run(nb, functools.partial(
            _paged_graph_step, self.params, self.pools, table, self._tok,
            self._pos, self._out, self._step, self.cfg), chunk)
        return self._out[:, :chunk].tolist()

    def step_round(self) -> dict:
        """One round: the prefill phase, then the decode chunk's length,
        the capacity fold (growth, or preemption under pressure) and one
        decode chunk for the surviving rows whose prompts are done. Returns
        the event fold's dict."""
        active = [s for s in self.slots if s is not None]
        if not active:
            return {}
        # A device fault or abort, before this round writes anything: the
        # quarantine's salvage case.
        faults.fire("pool.device")
        self.stats["rounds"] += 1
        self._prefill_phase()
        dec = self._decoding()
        chunk = 0
        if dec:
            # The capacity fold before any device input is built: every row
            # of the dispatch must own the blocks of the positions this
            # round keeps (at most its remaining budget: the overshoot is
            # discarded and lands in the null block); under pressure rows
            # are preempted instead.
            chunk = self._chunk_len(dec)
            dec = self._capacity_fold(
                dec, lambda s: len(s.history) + min(chunk, s.remaining) - 1)
        if not dec:
            self._register_phase()  # prefill chunks fill blocks too
            self._record_block_gauges()
            return {}  # an all-prefill (or all-preempted) round
        bt, last, pos = self._decode_inputs(dec, chunk)
        with telemetry.span("serve.decode_chunk", chunk=chunk,
                            nb=bt.shape[1], rows=len(dec)), self._writing():
            out = self._decode_chunk(bt, last, pos, chunk)
        self.stats["slot_steps"] += self.batch_size * chunk
        self.stats["active_slot_steps"] += sum(
            min(chunk, s.remaining) for s in dec)
        decoding = {id(s) for s in dec}
        events = self._emit_events(
            out, [chunk if s is not None and id(s) in decoding else 0
                  for s in self.slots])
        # Surviving rows register their newly full blocks, so live rows
        # share prefixes too (retiring rows registered in _on_retire).
        self._register_phase()
        self._record_block_gauges()
        return events

    # ---- introspection ----------------------------------------------------

    def _slot_json(self, i: int, s) -> dict:
        d = super()._slot_json(i, s)
        d.update({"blocks": len(s.blocks), "shared_blocks": s.n_shared,
                  "registered_blocks": s.registered,
                  "prompt_len": s.prompt_len, "prefilled": s.prefilled,
                  "cached_tokens": s.cached_tokens,
                  "prefilling": self._prefilling(s)})
        return d

    def snapshot(self) -> dict:
        """The pool's state, paged half: the block accounting (live,
        cached and free mirror the allocator exactly), each row's blocks,
        the watermark headroom, the cache digest and the host tier. The
        port's decode always runs the paged kernel K2."""
        snap = super().snapshot()
        a = self.allocator
        imminent = self.imminent_growth()
        snap.update({
            "block_size": self.block_size,
            "prefix_cache": self.prefix_cache,
            "paged_kernel": True,
            "blocks": {"total": a.num_blocks, "live": a.used(),
                       "cached": a.cached(),
                       "free": a.available() - a.cached(),
                       "available": a.available(),
                       "peak_used": a.stats["peak_used"],
                       "evictions": a.stats["evictions"],
                       "hash_hits": a.stats["hash_hits"],
                       "compactness": round(a.compactness(), 4)},
            "imminent_growth_blocks": imminent,
            "watermark_headroom_blocks": a.available() - imminent,
            "cache_digest": self._cache_digest_json(),
            "host": (self.host.snapshot_json() if self.host is not None
                     else {"blocks": 0, "capacity": 0, "bytes": 0,
                           "hit_tokens": 0, "swap_ins": 0,
                           "swap_outs": 0, "dropped": 0}),
        })
        return snap

    # ---- maintenance ------------------------------------------------------

    def defrag(self) -> int:
        """Compact live blocks into the lowest physical ids (one gather per
        pool tensor, written in place), rewrite the tables and rebuild
        the allocator's heap. Shared blocks move once (tables alias), and
        the cached set moves with its content, packed after the live
        blocks in LRU order, its index remapped, so prefix hits survive.
        Returns the number of blocks moved."""
        mapping = {}
        for s in self.slots:
            if s is None:
                continue
            for b in s.blocks:
                if b not in mapping:
                    mapping[b] = len(mapping) + 1
        for b in self.allocator._cached:  # oldest first: the order survives
            if b not in mapping:
                mapping[b] = len(mapping) + 1
        moved = sum(1 for old, new in mapping.items() if old != new)
        if moved == 0:
            return 0
        perm = torch.arange(self.allocator.num_blocks + 1)
        for old, new in mapping.items():
            perm[new] = old
        perm = perm.to(self.device)
        with self._writing():
            for layer in self.pools:
                for a in layer.values():
                    a.copy_(a[perm])
        for s in self.slots:
            if s is not None:
                s.blocks = [mapping[b] for b in s.blocks]
        self.allocator.remap(mapping)
        self.stats["defrags"] += 1
        self._record_block_gauges()
        return moved


def _device_fatal(exc: BaseException) -> bool:
    """An error the CUDA runtime raised (an illegal address, a failed
    launch): it may leave the context unusable for the rest of the
    process, so no in-process recovery is tried."""
    fatal = getattr(torch, "AcceleratorError", None)
    return ((fatal is not None and isinstance(exc, fatal))
            or "CUDA error" in str(exc))


class Scheduler:
    """Admission, queueing, preemption, deadlines and recovery for a pool
    (``PagedPool`` or ``SlotPool``): a waiting queue ordered by priority
    class (higher first), then deadline (EDF; requests without one after
    every deadline of their class), then arrival, admitted at every round
    boundary (head-of-line: a small request does not overtake a big one
    that does not fit yet).

    Overcommit (the paged engine only; on unless ``overcommit`` or
    ``TPUBC_OVERCOMMIT`` says 0): admission reserves the EXPECTED
    footprint, the prompt plus an EMA of observed generated lengths
    (seeded by ``expected_new`` or ``TPUBC_EXPECTED_NEW``, 16), and keeps
    the blocks the running rows are about to grow into free
    (``imminent_growth``); the pool grows tables lazily and preempts under
    pressure. A waiting request that outranks running rows evicts rows of
    strictly lower priority until it fits. Preempted rows re-enter the
    queue under their original key and resume where they stopped. With
    overcommit off, admission reserves the whole footprint and never
    preempts.

    Each round first sheds waiting requests past their deadline and
    cancels running ones (``_shed_expired``: their blocks return to the
    cohort, their stream ends with what it committed). A round of the
    paged engine that raises is recovered as a preemption of every
    resident row (``_recover``), up to ``TPUBC_ENGINE_MAX_RESTARTS``
    failures in a row; then, on the slot engine, or on an error of the
    CUDA runtime, the exception propagates.

    The Scheduler owns the request log (``log``) and the device ledger
    (``ledger``): each round's work section (shed, admit, the pool's round,
    the drain) is its busy time, billed to the rows the round advanced in
    proportion to their FLOPs-weighted tokens (``flops_model``); the time
    since the previous round ended is its wall. On the card the section
    ends in the round's token read for a decode round; an all-prefill
    round reads nothing back, so its device work is billed to the next
    round's busy time, as in the reference."""

    def __init__(self, pool, *, overcommit: bool | None = None,
                 expected_new: int | None = None, ema_alpha: float = 0.25):
        self.pool = pool
        if overcommit is None:
            overcommit = os.environ.get(
                "TPUBC_OVERCOMMIT", "1").lower() not in ("0", "false")
        # Only a block pool can overcommit: the slot engine has nothing to
        # grow into nor to preempt for.
        self.overcommit = bool(overcommit) and hasattr(pool, "allocator")
        if expected_new is None:
            expected_new = int(os.environ.get("TPUBC_EXPECTED_NEW", "16"))
        if expected_new < 1:
            raise ValueError(f"expected_new must be >= 1, got {expected_new}")
        if not 0 < ema_alpha <= 1:
            raise ValueError(f"ema_alpha must be in (0, 1], got {ema_alpha}")
        # The engine thread mutates the queue; readers on other threads
        # take the lock, never across device work.
        self._lock = threading.Lock()
        self._ema = float(expected_new)  # guarded-by: _lock
        self._alpha = ema_alpha
        # Heap entries (-priority, deadline-or-inf, seq, Request, preload):
        # seq is unique, so Request never enters a comparison.
        self._waiting: list = []  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._qstart: dict = {}  # rid -> submit time  # guarded-by: _lock
        self._preempt_t: dict = {}  # rid -> eviction time  # guarded-by: _lock
        self._waits = deque(maxlen=512)  # recent queue waits, ms  # guarded-by: _lock
        self.stats = {"submitted": 0, "admitted": 0, "requeues": 0,  # guarded-by: _lock
                      "retired": 0, "deadline_shed": 0, "recoveries": 0}
        # Crash recovery (engine-thread state): the failures in a row, so a
        # persistent fault re-raises after TPUBC_ENGINE_MAX_RESTARTS.
        self._fail_streak = 0
        self._max_restarts = int(os.environ.get(
            "TPUBC_ENGINE_MAX_RESTARTS", "8"))
        self.last_error = ""  # guarded-by: _lock
        # Retirements a second: the queue-drain estimate of retry_after_s.
        self._retire_window = telemetry.RateWindow()
        # The request log: the Scheduler sees every transition, the pool
        # appends its own events through its request_log.
        self.log = RequestLog()
        pool.request_log = self.log if self.log.enabled else None
        # The device ledger: step() attaches a fresh {rid: {kind: tokens}}
        # to the pool before its round and folds it after; off
        # (TPUBC_DEVICE_LEDGER=0), pool.ledger_tokens stays None.
        self.ledger_enabled = device_ledger_enabled()
        # The price list weighting prefill and decode tokens (and the
        # numerator of serve_mfu), and its denominator (None: no MFU).
        self._flops = flops_model(pool.cfg)
        self._peak = telemetry.peak_tflops()
        self._prio: dict = {}  # rid -> priority class  # guarded-by: _lock
        # Busy ms billed to each live request (retirement pops it into the
        # cumulative ledger below).
        self.device_ms_by_rid: dict = {}
        self.ledger = {"rounds": 0, "busy_ms": 0.0, "idle_ms": 0.0,
                       "wall_ms": 0.0, "attributed_ms": 0.0,
                       "unattributed_ms": 0.0,
                       "retired_device_ms": 0.0, "flops": 0.0}
        self._last_step_end: float | None = None
        telemetry.record_peak_provenance()

    # ---- queue ------------------------------------------------------------

    def expected_new(self, r: Request,
                     preload: list | None = None) -> int | None:
        """Decode tokens admission reserves blocks for now: None (the
        whole budget) without overcommit, else the EMA clamped into [1,
        the remaining budget]."""
        if not self.overcommit:
            return None
        rem = r.max_new - len(preload or [])
        with self._lock:
            return max(1, min(rem, math.ceil(self._ema)))

    def submit(self, r: Request) -> None:
        """Validate loudly and enqueue; admission happens at the next
        step()'s round boundary."""
        self.pool.validate(r, self.pool.cfg)
        with self._lock:
            position = len(self._waiting)
        self.log.start(r.rid, trace_id=r.trace_id, priority=r.priority,
                       deadline=r.deadline, queue_position=position,
                       prompt_len=len(r.tokens), max_new=r.max_new)
        with self._lock:
            self._push_locked(r, None, self._seq)
            self._seq += 1
            self.stats["submitted"] += 1
            self._qstart[r.rid] = telemetry.monotonic()
            self._prio[r.rid] = r.priority
        self._record_gauges()

    def _push_locked(self, r: Request, preload, seq: int) -> None:
        heapq.heappush(self._waiting, (
            -r.priority,
            r.deadline if r.deadline is not None else float("inf"),
            seq, r, preload))

    def _drain_preempted(self) -> None:
        """Re-enqueue every row the pool evicted since the last drain."""
        recs = list(getattr(self.pool, "preempted", ()))
        if not recs:
            return
        self.requeue(recs)
        self.pool.preempted.clear()

    def requeue(self, recs: list) -> None:
        """Re-enqueue resume records under their original keys: ahead of
        everything that arrived after them in their class (preemption and
        crash recovery share it)."""
        with self._lock:
            for rec in recs:
                self._push_locked(rec["request"], rec["preload"], rec["seq"])
                self.stats["requeues"] += 1
                if "t" in rec:
                    self._preempt_t[rec["request"].rid] = rec["t"]

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._waiting)

    def retry_after_s(self, depth: int | None = None) -> int:
        """A Retry-After for a refused request: the queue's depth over the
        observed retirement rate, clamped to [1, 30] s; 1 before any
        retirement."""
        if depth is None:
            depth = self.queue_depth()
        rate = self._retire_window.per_sec()
        if rate <= 0 or depth <= 0:
            return 1
        return max(1, min(30, math.ceil(depth / rate)))

    def pending(self) -> bool:
        with self._lock:
            return bool(self._waiting)

    def queue_wait_p50_ms(self) -> float:
        with self._lock:
            return self._queue_wait_p50_locked()

    def _queue_wait_p50_locked(self) -> float:
        w = sorted(self._waits)
        return w[len(w) // 2] if w else 0.0

    # ---- rounds -----------------------------------------------------------

    def _admit_phase(self) -> None:
        while True:
            with self._lock:
                if not self._waiting:
                    break
                # A peek: the engine thread is the only popper.
                negp, _dl, seq, r, preload = self._waiting[0]
            reserve = self.expected_new(r, preload)
            # The admission watermark: an admission into the blocks the
            # running rows grow into within a block of tokens would only
            # become the next round's preemption.
            extra = self.pool.imminent_growth() if self.overcommit else 0
            if self.pool.admits(r, reserve_new=reserve, preload=preload,
                                extra_blocks=extra):
                faults.fire("sched.admit")
                with self._lock:
                    heapq.heappop(self._waiting)
                try:
                    self.pool.admit(r, reserve_new=reserve, preload=preload,
                                    seq=seq)
                except Exception:
                    # Recovery must not lose the request: it goes back
                    # under its key before the pool is quarantined.
                    with self._lock:
                        self._push_locked(r, preload, seq)
                    raise
                if preload is None:
                    with self._lock:
                        self.stats["admitted"] += 1
                else:
                    with self._lock:
                        tp = self._preempt_t.pop(r.rid, None)
                    if tp is not None:
                        telemetry.metrics().observe(
                            "serve_resume_gap_ms",
                            (telemetry.monotonic() - tp) * 1e3)
                with self._lock:
                    t0 = self._qstart.pop(r.rid, None)
                    if t0 is not None:
                        wait_ms = (telemetry.monotonic() - t0) * 1e3
                        self._waits.append(wait_ms)
                if t0 is not None:
                    reg = telemetry.metrics()
                    reg.observe("serve_queue_wait_ms", wait_ms)
                    reg.observe("serve_queue_wait_ms", wait_ms,
                                labels={"priority": str(r.priority)})
                continue
            # Priority preemption: strictly lower classes only (evicting a
            # peer would thrash arrival order within a class).
            if (self.overcommit
                    and self.pool.preempt_one(below=-negp) is not None):
                self._drain_preempted()
                continue
            break
        self._record_gauges()

    def _shed_expired(self) -> dict:
        """Deadlines at the round boundary: expired waiting requests leave
        the queue, expired residents are cancelled (their blocks freed for
        the cohort); both end with a terminal event carrying the prefix
        they committed."""
        now = telemetry.monotonic()
        events: dict = {}
        with self._lock:
            expired = [e for e in self._waiting if e[1] <= now]
            if expired:
                keep = [e for e in self._waiting if e[1] > now]
                heapq.heapify(keep)
                self._waiting = keep
        for (_negp, _dl, _seq, r, preload) in expired:
            with self._lock:
                self._qstart.pop(r.rid, None)
                self._preempt_t.pop(r.rid, None)
                self.stats["deadline_shed"] += 1
            telemetry.metrics().inc("serve_deadline_shed_total")
            self.log.event(r.rid, "retired", reason="deadline",
                           generated=len(preload or []))
            events[r.rid] = {"new": [], "done": True,
                             "generated": list(preload or []),
                             "deadline": True,
                             "error": "deadline exceeded"}
        for i, s in enumerate(self.pool.slots):
            if s is None or s.deadline is None or s.deadline > now:
                continue
            events[s.rid] = {**self.pool.cancel(i, reason="deadline"),
                             "deadline": True,
                             "error": "deadline exceeded"}
            with self._lock:
                self.stats["deadline_shed"] += 1
            telemetry.metrics().inc("serve_deadline_shed_total")
        return events

    def _recover(self, exc: Exception) -> None:
        """Crash-is-preemption: quarantine the pool and requeue every row
        it held under its original key; the next rounds re-prefill them
        and their streams go on as if uninterrupted."""
        t0 = time.perf_counter()
        self._fail_streak += 1
        recs = self.pool.quarantine()
        self.requeue(recs)
        with self._lock:
            self.stats["recoveries"] += 1
            self.last_error = f"{type(exc).__name__}: {exc}"
        reg = telemetry.metrics()
        reg.inc("serve_engine_restarts_total")
        reg.observe("serve_recovery_ms", (time.perf_counter() - t0) * 1e3)

    def step(self) -> dict:
        """One scheduling round: shed expired deadlines, admit (preempting
        for priority), run the pool's round, drain its preempted rows back
        into the queue, fold the retirements' lengths into the
        expected-length EMA and close the round's ledger. A failed round
        of the paged engine is recovered (``_recover``) up to
        ``TPUBC_ENGINE_MAX_RESTARTS`` failures in a row."""
        t_start = time.perf_counter()
        led: dict | None = None
        if self.ledger_enabled:
            led = {}
            self.pool.ledger_tokens = led
        shed: dict = {}
        try:
            shed = self._shed_expired()
            self._admit_phase()
            if self.overcommit:
                with self._lock:
                    self.pool.chunk_hint = max(1, math.ceil(self._ema))
            events = self.pool.step_round()
            self._fail_streak = 0
        except Exception as e:  # noqa: BLE001 - the recovery boundary
            if led is not None:
                self._ledger_fold(led, t_start, time.perf_counter())
                led = None
            if (not hasattr(self.pool, "quarantine")
                    or self._fail_streak >= self._max_restarts
                    or _device_fatal(e)):
                raise
            self._recover(e)
            events = {}
        events.update(shed)
        self._drain_preempted()
        if led is not None:
            self._ledger_fold(led, t_start, time.perf_counter())
        retired = [rid for rid, ev in events.items() if ev["done"]]
        if retired:
            self._retire_window.add(len(retired))
            with self._lock:
                for rid in retired:
                    self.stats["retired"] += 1
                    if events[rid].get("deadline"):
                        # A shed stream's length says nothing of how long
                        # completed traffic runs.
                        continue
                    self._ema += self._alpha * (
                        len(events[rid]["generated"]) - self._ema)
            for rid in retired:
                self.log.retire(rid)
                self.ledger["retired_device_ms"] += (
                    self.device_ms_by_rid.pop(rid, 0.0))
                with self._lock:
                    self._prio.pop(rid, None)
        self._record_gauges()
        return events

    def _ledger_fold(self, led: dict, t_start: float, t_end: float) -> None:
        """Close one round's ledger. Busy is the work section's wall time;
        the round's wall runs from the end of the previous step (the first
        round: the section itself), so idle = wall - busy and busy + idle
        == wall. Busy is split across the rows the round advanced in
        proportion to their FLOPs-weighted tokens, so the per-request
        device ms sum to the attributed busy time; a round that advanced
        no token is unattributed."""
        self.pool.ledger_tokens = None
        busy_ms = (t_end - t_start) * 1e3
        wall_ms = (busy_ms if self._last_step_end is None
                   else max(busy_ms, (t_end - self._last_step_end) * 1e3))
        self._last_step_end = t_end
        idle_ms = wall_ms - busy_ms
        prices = self._flops
        weights: dict = {}
        flops = 0.0
        for rid, kinds in led.items():
            w = 0.0
            for kind, n in kinds.items():
                w += n * prices.get(kind, prices["decode"])
            if w > 0:
                weights[rid] = w
                flops += w
        reg = telemetry.metrics()
        attributed = 0.0
        if flops > 0:
            with self._lock:
                prio = {rid: self._prio.get(rid, 0) for rid in weights}
            for rid, w in weights.items():
                ms = busy_ms * w / flops
                attributed += ms
                self.device_ms_by_rid[rid] = (
                    self.device_ms_by_rid.get(rid, 0.0) + ms)
                self.log.add_device(rid, ms, {
                    f"{kind}_ms": busy_ms * n * prices.get(
                        kind, prices["decode"]) / flops
                    for kind, n in led[rid].items()})
                reg.inc("serve_device_ms_total", ms,
                        labels={"priority": str(prio[rid])})
            reg.inc("serve_model_flops_total", flops)
        elif busy_ms > 0:
            reg.inc("serve_device_unattributed_ms_total", busy_ms)
        l = self.ledger
        l["rounds"] += 1
        l["busy_ms"] += busy_ms
        l["idle_ms"] += idle_ms
        l["wall_ms"] += wall_ms
        l["attributed_ms"] += attributed
        l["unattributed_ms"] += busy_ms if flops <= 0 else 0.0
        l["flops"] += flops
        if wall_ms > 0:
            reg.set_gauge("serve_engine_busy_frac",
                          round(busy_ms / wall_ms, 4))
            if self._peak is not None:
                reg.set_gauge("serve_mfu", round(
                    flops / (wall_ms * 1e-3 * self._peak * 1e12), 9))

    def request_timing(self, rid: int) -> dict | None:
        """One request's phase breakdown (None with the log off or for an
        unknown rid)."""
        return self.log.phases(rid) if self.log.enabled else None

    def snapshot(self) -> dict:
        """The queue in admission order (priority class, deadline,
        arrival), the overcommit EMA, the ledger and the counters, under
        one lock hold."""
        with self._lock:
            waiting = [{"rid": r.rid, "priority": r.priority,
                        "deadline": (None if dl == float("inf") else dl),
                        "seq": seq, "resume": preload is not None}
                       for (_negp, dl, seq, r, preload)
                       in sorted(self._waiting)]
            return {"overcommit": self.overcommit,
                    "expected_new_ema": round(self._ema, 3),
                    "queue_depth": len(waiting),
                    "waiting": waiting,
                    "queue_wait_p50_ms": round(
                        self._queue_wait_p50_locked(), 2),
                    "ledger": {k: (round(v, 3) if isinstance(v, float)
                                   else v)
                               for k, v in self.ledger.items()},
                    "stats": dict(self.stats)}

    def reset(self, reason: str = "error") -> None:
        """Drop every queued request (a failed or drained engine; resetting
        the pool is the caller's). The EMA survives: it describes the
        traffic. The log retires every open record with ``reason``."""
        with self._lock:
            self._waiting.clear()
            self._qstart.clear()
            self._preempt_t.clear()
            self._prio.clear()
        self.log.abort_inflight(reason)

    def _record_gauges(self) -> None:
        with self._lock:
            depth, ema = len(self._waiting), self._ema
            submitted = self.stats["submitted"]
            admitted = self.stats["admitted"]
        telemetry.record_scheduler(
            queue_depth=depth, expected_new=ema, submitted=submitted,
            admitted=admitted,
            preemptions=getattr(self.pool, "stats", {}).get(
                "preemptions", 0))


def serve(params: Params, cfg: ModelConfig, requests: list,
          batch_size: int, *, kv_quant: bool = False,
          eos_id: int | None = None, temperature: float = 0.0,
          stats: dict | None = None, draft_params: Params | None = None,
          draft_cfg: ModelConfig | None = None, gamma: int = 4,
          resident: bool = False, paged: bool = False,
          kv_blocks: int | None = None, block_size: int | None = None,
          prefill_budget: int | None = None, prefix_cache: bool | None = None,
          overcommit: bool | None = None, spec_lookup: bool | None = None,
          device=None) -> dict:
    """Run every request through a ``batch_size``-row pool; returns {rid:
    generated token list}. Greedy; ``eos_id`` finishes a row at the first
    emission of that token (inclusive). ``paged=True`` is the block-paged
    engine (``kv_quant=True`` only; ``kv_blocks``, ``block_size``,
    ``prefill_budget``, ``prefix_cache`` and ``spec_lookup`` go to it, None
    reading their knobs as ``PagedPool`` does, and its host tier is sized
    by ``TPUBC_KV_HOST_BLOCKS``); admission overcommits and preempts
    unless ``overcommit=False`` (None reads ``TPUBC_OVERCOMMIT``, on by
    default, as in the reference); ``paged=False`` the
    replay-slot engine, whose rounds run the speculative verify-commit
    loop when ``draft_params``/``draft_cfg``/``gamma`` are given (greedy:
    the streams are unchanged). ``stats``, if given, is filled with the
    pool's accounting (rounds, slot_steps, active_slot_steps, and the
    engine's own: prefill_tokens, blocks_peak, preemptions, grown_blocks,
    the swap counters, ... or replayed_tokens, verify_rounds,
    committed_tokens, draft_steps) plus a ``"scheduler"`` sub-dict, and for
    the paged engine the allocator's stats (``"allocator"``), the host
    tier's snapshot (``"host"``, when the tier exists) and, on the card,
    its graphs' (``"graphs"``: captured, capture_s, replays).

    A request's ``deadline`` is honoured as the reference honours it: a
    request still waiting past it returns no token, one running past it
    returns the prefix it committed. A failed round of the paged engine is
    recovered (crash-is-preemption) and the streams go on unchanged.

    ``device`` None means the card (and raises without CUDA); ``params``
    must already live there. The resident engine and the reference's
    other options raise ``NotImplementedError``."""
    if resident:
        raise _not_ported("the resident engine (serve with resident=True)",
                          "8: the other engines")
    if len({r.rid for r in requests}) != len(requests):
        raise ValueError("duplicate request rids (results key by rid)")
    if paged:
        pool = PagedPool(params, cfg, batch_size, kv_blocks=kv_blocks,
                         block_size=block_size,
                         prefill_budget=prefill_budget, kv_quant=kv_quant,
                         eos_id=eos_id, temperature=temperature,
                         draft_params=draft_params, spec_lookup=spec_lookup,
                         prefix_cache=prefix_cache, device=device)
    else:
        if spec_lookup:
            raise ValueError(
                "spec_lookup rides the resident/paged engines' split "
                "draft/verify seam; the replay pool has no per-row "
                "frontier to verify from")
        pool = SlotPool(params, cfg, batch_size, kv_quant=kv_quant,
                        eos_id=eos_id, temperature=temperature,
                        draft_params=draft_params, draft_cfg=draft_cfg,
                        gamma=gamma, device=device)
    for r in requests:
        pool.validate(r, cfg)  # every request fails loudly before compute
    sched = Scheduler(pool, overcommit=overcommit)
    done: dict = {}
    with telemetry.span("serve.batch", requests=len(requests),
                        batch_size=batch_size):
        for r in requests:
            sched.submit(r)
        while sched.pending() or pool.has_active():
            for rid, ev in sched.step().items():
                if ev["done"]:
                    done[rid] = ev["generated"]
    if stats is not None:
        stats.update(pool.stats)
        stats["scheduler"] = dict(sched.stats)
        if paged:
            stats["allocator"] = dict(pool.allocator.stats)
            if pool.host is not None:
                stats["host"] = pool.host.snapshot_json()
            if pool._graphs is not None:
                stats["graphs"] = dict(pool._graphs.stats)
    return done


def serve_demo_from_env(device=None) -> None:
    """``WORKLOAD_MODE=serve`` JobSet entry (dispatched by
    ``train.worker_main``), the counterpart of the reference's: build the
    model WORKLOAD_MODEL names from WORKLOAD_SEED, restore the params of
    the latest checkpoint in WORKLOAD_CHECKPOINT_DIR when one exists,
    quantize them (WORKLOAD_QUANT=int8|int4; WORKLOAD_KV_QUANT=1 for the
    int8 KV pool), then serve: live HTTP on WORKLOAD_SERVE_PORT when it is
    set (``ingress.IngressServer(...).serve_forever()``), else
    WORKLOAD_REQUESTS synthetic requests through WORKLOAD_SERVE_BATCH slots,
    ending in a ``serve done:`` line. WORKLOAD_SPECULATIVE=1 drafts an
    unquantized target with its own int8 copy; WORKLOAD_TEMPERATURE,
    WORKLOAD_TOP_K and WORKLOAD_TOP_P keep the reference's validation;
    WORKLOAD_EOS_ID, WORKLOAD_RESIDENT and WORKLOAD_PAGED pick the eos and
    the engine.

    As in the reference, the engine is the replay-slot one unless
    WORKLOAD_PAGED=1, and the KV pool is float unless WORKLOAD_KV_QUANT=1:
    the port's main path (the paged engine on the int8 pool, kernels K1
    and K2) runs only with both set. WORKLOAD_PAGED=1 alone asks for the
    float pool and raises ``NotImplementedError`` naming ROADMAP queue 1
    item 8, loudly, rather than serving another engine than the one asked
    for; so do WORKLOAD_RESIDENT=1 (item 8) and a nonzero temperature
    (item 5). ``device`` None means the card, and without CUDA raises
    before anything runs."""
    from tpu_bootstrap_torch.workload import checkpoint as ck
    from tpu_bootstrap_torch.workload.model import init_params
    from tpu_bootstrap_torch.workload.train import parse_model_env

    device = resolve_device(device)
    cfg = parse_model_env(os.environ.get("WORKLOAD_MODEL", ""))
    seed = int(os.environ.get("WORKLOAD_SEED", "0"))
    params = init_params(cfg, seed=seed, device=device)
    ckpt = os.environ.get("WORKLOAD_CHECKPOINT_DIR")
    if ckpt:
        mgr = ck.make_manager(ckpt)
        step = ck.latest_step(mgr)
        if step is not None:
            # Params only: the optimizer state is dead weight for serving.
            params, _ = ck.restore(mgr, step, device=device)
            print(f"serve: restored checkpoint step {step} from {ckpt}")

    draft_params = draft_cfg = None
    q = os.environ.get("WORKLOAD_QUANT", "")
    if q == "int8":
        params = quant.quantize_params(params)
    elif q == "int4":
        params = quant.quantize_params4(params)
    elif q:
        raise ValueError(f"WORKLOAD_QUANT must be int8|int4, got {q!r}")
    kv_quant = os.environ.get("WORKLOAD_KV_QUANT", "").lower() in ("1", "true")
    if os.environ.get("WORKLOAD_SPECULATIVE", "").lower() in ("1", "true"):
        if q:
            raise ValueError(
                "WORKLOAD_SPECULATIVE drafts with the target's int8 copy; "
                "combine it with an UNQUANTIZED target (unset WORKLOAD_QUANT)")
        draft_params, draft_cfg = quant.quantize_params(params), cfg

    temperature = float(os.environ.get("WORKLOAD_TEMPERATURE", "0"))
    top_k = int(os.environ.get("WORKLOAD_TOP_K", "0"))
    top_p = float(os.environ.get("WORKLOAD_TOP_P", "1.0"))
    if temperature == 0 and (top_k > 0 or top_p < 1.0):
        raise ValueError(
            "WORKLOAD_TOP_K/WORKLOAD_TOP_P require WORKLOAD_TEMPERATURE > 0 "
            "(greedy decoding ignores the sampling filters)")
    eos_env = os.environ.get("WORKLOAD_EOS_ID", "")
    eos_id = int(eos_env) if eos_env else None
    resident = os.environ.get("WORKLOAD_RESIDENT", "").lower() in ("1", "true")
    paged = os.environ.get("WORKLOAD_PAGED", "").lower() in ("1", "true")

    port = int(os.environ.get("WORKLOAD_SERVE_PORT", "0"))
    if port > 0:
        from tpu_bootstrap_torch.workload.ingress import IngressServer

        IngressServer(params, cfg, port=port,
                      batch_size=int(os.environ.get("WORKLOAD_SERVE_BATCH",
                                                    "8")),
                      kv_quant=kv_quant, draft_params=draft_params,
                      draft_cfg=draft_cfg, resident=resident, paged=paged,
                      eos_id=eos_id, temperature=temperature, top_k=top_k,
                      top_p=top_p, device=device).serve_forever()
        return

    n = int(os.environ.get("WORKLOAD_REQUESTS", "32"))
    batch = int(os.environ.get("WORKLOAD_SERVE_BATCH", "8"))
    rng = np.random.default_rng(seed)
    requests = [
        Request(rid=i,
                tokens=rng.integers(1, cfg.vocab_size,
                                    int(rng.integers(4, 17))).tolist(),
                max_new=int(rng.integers(1, 33)))
        for i in range(n)
    ]
    stats: dict = {}
    t0 = time.time()
    done = serve(params, cfg, requests, batch, kv_quant=kv_quant, stats=stats,
                 draft_params=draft_params, draft_cfg=draft_cfg,
                 resident=resident, paged=paged, eos_id=eos_id,
                 temperature=temperature, device=device)
    dt = time.time() - t0
    total = sum(len(v) for v in done.values())
    util = stats["active_slot_steps"] / max(stats["slot_steps"], 1)
    print(f"serve done: {len(done)} requests, {total} tokens, "
          f"{total / dt:.1f} tok/s, rounds={stats['rounds']}, "
          f"slot utilization {util:.2f}")


__all__ = ["BlockAllocator", "HostBlockPool", "PagedPool", "Request",
           "RequestLog", "RequestRecord", "Scheduler", "SlotPool",
           "block_hash", "device_ledger_enabled", "request_events_enabled",
           "serve", "serve_demo_from_env"]
