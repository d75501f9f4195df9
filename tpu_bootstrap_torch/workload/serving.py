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

* Admission reserves a request's WHOLE footprint,
  ceil((prompt + max_new) / block_size) blocks, and is refused when the
  pool cannot cover it, so no round ever runs out of blocks.
* Each ``step_round`` first spends up to ``prefill_budget`` prompt tokens
  on rows still prefilling (round-robin, power-of-two chunk widths): the
  prompt chunk runs ``speculative._verify_chunk`` over the row's blocks
  gathered into a window, with no head (its logits would be discarded),
  and the window is written back into the pool.
* Then one decode chunk runs for the rows whose prompts are done: a
  Python loop of ``decode.paged_decode_step`` (kernel K2 for attention,
  kernels K1 / K6 for every int8 / int4 projection and K1e / K6e for a
  MoE model's expert stacks), greedy ``argmax`` kept on the card, and
  ONE host read of the chunk's tokens.
* The chunk is the largest power of two that at least half the cohort
  can consume (``_majority_chunk``); rows past their budget run on and
  their overshoot is discarded by the event fold.

The pools are updated IN PLACE (the reference donates them to its
jitted rounds): the frontier write, the prefill window scatter and
defrag's relocation all write into the tensors the pool holds.

Exactness: a request's tokens equal its solo greedy
``generate(kv_kernel=False)``, up to the order of float sums inside the
kernels (the slot engine's speculative rounds commit the target's own
argmaxes, so they equal its plain rounds).

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
queue 1 item): the prefix cache, the host tier, overcommit admission and
preemption, sampling, the paged engine's speculative rounds and prompt
lookup, the resident engine, the float-pool gather path, the request
log, the device ledger, the fault seams other than ``pool.device`` and
deadlines.
"""

from __future__ import annotations

import dataclasses
import heapq

import torch

from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import decode_attention, faults, quant
from tpu_bootstrap_torch.workload.decode import (
    generate,
    init_paged_cache,
    paged_decode_step,
)
from tpu_bootstrap_torch.workload.model import (
    ModelConfig,
    Params,
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
    # Higher ``priority`` admits first. Deadlines are not ported: a request
    # with one is refused at submit.
    priority: int = 0
    deadline: float | None = None


@dataclasses.dataclass
class _Slot:
    rid: int
    history: list  # prompt + generated so far
    remaining: int
    generated: list


@dataclasses.dataclass
class _PagedSlot(_Slot):
    prompt_len: int = 0
    prefilled: int = 0  # prompt tokens whose KV has been written
    blocks: list = dataclasses.field(default_factory=list)


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


class BlockAllocator:
    """Bookkeeping of the shared KV block pool: ids 1..num_blocks (id 0
    is the null block that pads short tables and is never owned),
    lowest-id-first allocation from a min-heap, refcounts, loud
    double-free and exhaustion errors. Host state only: the device sees
    the block tables built from it. The content-hash index of the
    reference comes with the prefix cache."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks, self.block_size = num_blocks, block_size
        self._free = list(range(1, num_blocks + 1))  # a valid heap
        self._ref: dict = {}  # live block id -> refcount (>= 1)
        self.stats = {"allocs": 0, "frees": 0, "peak_used": 0}

    def available(self) -> int:
        return len(self._free)

    def used(self) -> int:
        return len(self._ref)

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    def alloc(self, n: int) -> list:
        if n < 1:
            raise ValueError(f"alloc of {n} blocks")
        if n > self.available():
            raise RuntimeError(
                f"KV block pool exhausted: want {n}, free {self.available()} "
                f"of {self.num_blocks} (admission must check admits/"
                "available first)")
        ids = [heapq.heappop(self._free) for _ in range(n)]
        for i in ids:
            self._ref[i] = 1
        self.stats["allocs"] += n
        self.stats["peak_used"] = max(self.stats["peak_used"], len(self._ref))
        return ids

    def incref(self, bid: int) -> None:
        if bid not in self._ref:
            raise ValueError(f"incref of KV block {bid} which is not live")
        self._ref[bid] += 1

    def free(self, ids: list) -> None:
        """Decref each id; the last reference returns it to the heap."""
        for i in ids:
            if i not in self._ref:
                raise ValueError(
                    f"double free of KV block {i} (not currently allocated)")
            self._ref[i] -= 1
            if self._ref[i] == 0:
                del self._ref[i]
                heapq.heappush(self._free, i)
        self.stats["frees"] += len(ids)

    def remap(self, mapping: dict) -> None:
        """Rewrite every live id through ``mapping`` (old -> new) after the
        caller relocated the pool arrays; the heap is rebuilt from the
        complement."""
        self._ref = {mapping[b]: c for b, c in self._ref.items()}
        self._free = [i for i in range(1, self.num_blocks + 1)
                      if i not in self._ref]
        heapq.heapify(self._free)

    def compactness(self) -> float:
        """1.0 when the live set is a dense prefix of the id space."""
        if not self._ref:
            return 1.0
        return len(self._ref) / max(self._ref)


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


class _PoolBase:
    """What every serving engine shares: admission validation, the
    free-slot scan and the per-round event fold."""

    eos_id: int | None = None

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

    def _emit_events(self, out: list, counts: list) -> dict:
        """Fold one round's per-slot outputs (``out[i]`` a token list,
        ``counts[i]`` how many it may keep) into slot state: extend
        histories, cut at eos, clamp to each row's remaining budget,
        retire finished rows. Returns {rid: {"new", "done",
        "generated"}}."""
        events = {}
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            keep = min(counts[i], s.remaining)
            if keep <= 0:
                continue
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
            if done:
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

    def admits(self, r: Request) -> bool:
        """Capacity is slots, not blocks."""
        return self.free_slots() > 0

    def admit(self, r: Request) -> None:
        """Place a validated request in a free slot (raises when full:
        callers check ``admits``)."""
        self.validate(r, self.cfg)
        self.slots[self._free_index()] = _Slot(
            rid=r.rid, history=list(r.tokens), remaining=r.max_new,
            generated=[])

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
        self.stats["slot_steps"] += self.batch_size * chunk
        self.stats["active_slot_steps"] += len(active) * chunk
        return self._emit_events(out.tolist(), [chunk] * self.batch_size)


class PagedPool(_PoolBase):
    """Block-paged continuous batching over int8 or int4 weights (dense
    or MoE) and an int8 KV pool: ``batch_size`` rows at most, ``kv_blocks`` blocks of
    ``block_size`` tokens (default: ``batch_size`` max-length rows'
    worth), prompts prefilled in chunks of at most ``prefill_budget``
    tokens per round. Drive it with ``admit`` and ``step_round``."""

    def __init__(self, params: Params, cfg: ModelConfig, batch_size: int, *,
                 kv_blocks: int | None = None, block_size: int = 64,
                 prefill_budget: int = 64, kv_quant: bool = False,
                 eos_id: int | None = None, temperature: float = 0.0,
                 draft_params: Params | None = None,
                 spec_lookup: bool = False, prefix_cache: bool = False,
                 host_blocks: int = 0, device=None):
        if temperature != 0.0:
            raise _not_ported("sampling (temperature > 0)",
                              "5: sampling with threefry bit-parity")
        if draft_params is not None or spec_lookup:
            raise _not_ported("speculative serving (draft_params, "
                              "spec_lookup)", "5: paged spec rounds")
        if prefix_cache:
            raise _not_ported("the prefix cache",
                              "5: prefix cache and hash index")
        if host_blocks:
            raise _not_ported("the host KV tier", "5: host tier")
        if not kv_quant:
            raise _not_ported("the float KV pool (gather/einsum decode)",
                              "8: the other engines")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
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
        self.allocator = BlockAllocator(kv_blocks, block_size)
        # kv_blocks usable blocks + the null block (id 0).
        self.pools = init_paged_cache(cfg, kv_blocks + 1, block_size,
                                      quantized=True, device=self.device)
        self.slots: list = [None] * batch_size
        self._pre_rr = 0  # round-robin cursor over prefilling rows
        self.stats = {"rounds": 0, "slot_steps": 0, "active_slot_steps": 0,
                      "prefill_tokens": 0, "prefill_chunks": 0,
                      "blocks_total": kv_blocks, "blocks_peak": 0,
                      "defrags": 0, "prompt_tokens": 0}
        self._kv_bytes_per_tok = kv_bytes_per_token(cfg, kv_quant)
        telemetry.metrics().set_gauge("serve_target_stream_bytes",
                                      quant.decode_stream_bytes(params))
        self._record_block_gauges()

    # ---- capacity ---------------------------------------------------------

    def blocks_needed(self, r: Request) -> int:
        """Blocks the request's whole footprint reserves."""
        return -(-(len(r.tokens) + r.max_new) // self.block_size)

    def admits(self, r: Request, *, extra_slots: int = 0,
               extra_blocks: int = 0) -> bool:
        """Whether the pool can take ``r`` now, with ``extra_slots`` and
        ``extra_blocks`` already promised to requests ahead of it."""
        if self.free_slots() <= extra_slots:
            return False
        return (self.allocator.available() - extra_blocks
                >= self.blocks_needed(r))

    def validate(self, r: Request, cfg: ModelConfig) -> None:
        _PoolBase.validate(r, cfg)
        if self.blocks_needed(r) > self.allocator.num_blocks:
            raise ValueError(
                f"request {r.rid}: needs {self.blocks_needed(r)} KV blocks "
                f"but the pool only has {self.allocator.num_blocks} - it "
                "can never be admitted (raise kv_blocks or shrink the "
                "request)")

    def _prefilling(self, s) -> bool:
        # The last prompt token is never prefilled: the first decode step
        # re-feeds it from the frontier and emits the first logits.
        return s.prefilled < s.prompt_len - 1

    def _on_retire(self, i: int, s) -> None:
        self.allocator.free(s.blocks)
        s.blocks = []
        self._record_block_gauges()

    def _record_block_gauges(self) -> None:
        a = self.allocator
        live = sum((len(s.history) if not self._prefilling(s)
                    else s.prefilled)
                   for s in self.slots if s is not None)
        telemetry.record_kv_block_pool(
            total=a.num_blocks, used=a.used(), free=a.available(),
            capacity_tokens=a.used() * self.block_size, live_tokens=live,
            peak_used=a.stats["peak_used"], compactness=a.compactness())
        telemetry.metrics().set_gauge(
            "serve_kv_live_bytes",
            a.used() * self.block_size * self._kv_bytes_per_tok)
        self.stats["blocks_peak"] = a.stats["peak_used"]

    # ---- admission --------------------------------------------------------

    def admit(self, r: Request) -> None:
        """Reserve the request's block footprint and enqueue its prompt;
        the prefill itself rides the coming rounds."""
        self.validate(r, self.cfg)
        i = self._free_index()
        if not self.admits(r):
            raise RuntimeError(
                f"request {r.rid}: pool has a free slot but not enough "
                "free KV blocks (callers check admits() before admit)")
        blocks = self.allocator.alloc(self.blocks_needed(r))
        self.stats["prompt_tokens"] += len(r.tokens)
        self.slots[i] = _PagedSlot(
            rid=r.rid, history=list(r.tokens), remaining=r.max_new,
            generated=[], prompt_len=len(r.tokens), blocks=blocks)
        self._record_block_gauges()

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
                _paged_prefill_chunk(self.params, self.pools, bt, tokens,
                                     pos, self.cfg)
                s.prefilled += w
                budget -= w
                self.stats["prefill_tokens"] += w
                self.stats["prefill_chunks"] += 1
                telemetry.metrics().observe(
                    "serve_prefill_chunk_tokens", w,
                    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512))
            if budget <= 0:
                break

    def step_round(self) -> dict:
        """One round: the prefill phase, then one decode chunk for the
        rows whose prompts are done. Returns the event fold's dict."""
        active = [s for s in self.slots if s is not None]
        if not active:
            return {}
        self.stats["rounds"] += 1
        self._prefill_phase()
        dec = [s for s in self.slots
               if s is not None and not self._prefilling(s)
               and s.remaining > 0]
        if not dec:
            self._record_block_gauges()
            return {}  # an all-prefill round
        chunk = _majority_chunk(dec, self.cfg.max_seq_len)
        if any(self._prefilling(s) for s in self.slots if s is not None):
            # Pending prompts keep decode rounds short, so prefill chunks
            # interleave at budget cadence (the TTFT bound).
            chunk = min(chunk, _bucket_down(self.prefill_budget))
        decoding = {id(s) for s in dec}
        live = [s is not None and id(s) in decoding for s in self.slots]
        last = torch.tensor([s.history[-1] if ok else 0
                             for s, ok in zip(self.slots, live)],
                            dtype=torch.long, device=self.device)
        pos = torch.tensor([len(s.history) - 1 if ok else 0
                            for s, ok in zip(self.slots, live)],
                           dtype=torch.long, device=self.device)
        nb = self._bucket_blocks(max(
            -(-(len(s.history) + chunk - 1) // self.block_size)
            for s in dec))
        bt = self._table(nb, rows=dec)
        with telemetry.span("serve.decode_chunk", chunk=chunk, nb=nb,
                            rows=len(dec)):
            out = _paged_chunk_kernel(self.params, self.pools, bt, last,
                                      pos, self.cfg, chunk).tolist()
        self.stats["slot_steps"] += self.batch_size * chunk
        self.stats["active_slot_steps"] += sum(
            min(chunk, s.remaining) for s in dec)
        events = self._emit_events(out, [chunk if ok else 0 for ok in live])
        self._record_block_gauges()
        return events

    # ---- maintenance ------------------------------------------------------

    def defrag(self) -> int:
        """Compact live blocks into the lowest physical ids (one gather per
        pool tensor, written in place), rewrite the tables and rebuild
        the allocator's heap. Returns the number of blocks moved."""
        mapping = {}
        for s in self.slots:
            if s is None:
                continue
            for b in s.blocks:
                if b not in mapping:
                    mapping[b] = len(mapping) + 1
        moved = sum(1 for old, new in mapping.items() if old != new)
        if moved == 0:
            return 0
        perm = torch.arange(self.allocator.num_blocks + 1)
        for old, new in mapping.items():
            perm[new] = old
        perm = perm.to(self.device)
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


class Scheduler:
    """Admission and queueing for a pool (``PagedPool`` or ``SlotPool``): a
    waiting queue ordered by priority class (higher first), then arrival,
    with admission at every round boundary by the pool's ``admits`` (the
    paged pool's whole footprint, the slot pool's free slots;
    head-of-line: a small request does not overtake a big one that does
    not fit yet). Overcommit with
    preemption, deadlines (their EDF order and shedding), the request log
    and the device ledger of the reference are not ported."""

    def __init__(self, pool, *, overcommit: bool = False):
        if overcommit:
            raise _not_ported("overcommit admission and preemption",
                              "5: overcommit and preemption")
        self.pool = pool
        # Heap entries (-priority, seq, Request): seq is unique, so Request
        # never enters a comparison.
        self._waiting: list = []
        self._seq = 0
        self.stats = {"submitted": 0, "admitted": 0, "retired": 0}

    def submit(self, r: Request) -> None:
        """Validate loudly and enqueue; admission happens at the next
        step()'s round boundary."""
        if r.deadline is not None:
            raise _not_ported("deadlines", "5: deadlines")
        self.pool.validate(r, self.pool.cfg)
        heapq.heappush(self._waiting, (-r.priority, self._seq, r))
        self._seq += 1
        self.stats["submitted"] += 1
        self._record_gauges()

    def pending(self) -> bool:
        return bool(self._waiting)

    def _admit_phase(self) -> None:
        while self._waiting and self.pool.admits(self._waiting[0][2]):
            self.pool.admit(heapq.heappop(self._waiting)[2])
            self.stats["admitted"] += 1

    def step(self) -> dict:
        """One scheduling round: admit what fits, run the pool's round,
        count retirements."""
        self._admit_phase()
        events = self.pool.step_round()
        self.stats["retired"] += sum(1 for ev in events.values()
                                     if ev["done"])
        self._record_gauges()
        return events

    def _record_gauges(self) -> None:
        telemetry.record_scheduler(queue_depth=len(self._waiting),
                                   submitted=self.stats["submitted"],
                                   admitted=self.stats["admitted"])


def serve(params: Params, cfg: ModelConfig, requests: list,
          batch_size: int, *, kv_quant: bool = False,
          eos_id: int | None = None, temperature: float = 0.0,
          stats: dict | None = None, draft_params: Params | None = None,
          draft_cfg: ModelConfig | None = None, gamma: int = 4,
          resident: bool = False, paged: bool = False,
          kv_blocks: int | None = None, block_size: int = 64,
          prefill_budget: int = 64, prefix_cache: bool = False,
          overcommit: bool = False, spec_lookup: bool = False,
          device=None) -> dict:
    """Run every request through a ``batch_size``-row pool; returns {rid:
    generated token list}. Greedy; ``eos_id`` finishes a row at the first
    emission of that token (inclusive). ``paged=True`` is the block-paged
    engine (``kv_quant=True`` only; ``kv_blocks``, ``block_size``,
    ``prefill_budget`` go to it); ``paged=False`` the replay-slot engine,
    whose rounds run the speculative verify-commit loop when
    ``draft_params``/``draft_cfg``/``gamma`` are given (greedy: the
    streams are unchanged). ``stats``, if given, is filled with the
    pool's accounting (rounds, slot_steps, active_slot_steps, and the
    engine's own: prefill_tokens, blocks_peak, ... or replayed_tokens,
    verify_rounds, committed_tokens, draft_steps) plus a
    ``"scheduler"`` sub-dict.

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
    sched = Scheduler(pool, overcommit=overcommit)
    for r in requests:
        pool.validate(r, cfg)  # every request fails loudly before compute
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
    return done
