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
  can consume (``_majority_chunk``); rows past their budget run on and
  their overshoot is discarded by the event fold.

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

The pools are updated IN PLACE (the reference donates them to its
jitted rounds): the frontier write, the prefill window scatter, the
copy-on-write copy and defrag's relocation all write into the tensors the
pool holds, which also keeps the addresses the captured steps read.

Exactness: a request's tokens equal its solo greedy
``generate(kv_kernel=False)``, up to the order of float sums inside the
kernels (the slot engine's speculative rounds commit the target's own
argmaxes, so they equal its plain rounds).

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
queue 1 item): the host tier, overcommit admission and preemption,
sampling, the paged engine's speculative rounds and prompt lookup, the
resident engine, the float-pool gather path, the request log, the device
ledger, the fault seams other than ``pool.device`` and deadlines.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import heapq
import os
from collections import OrderedDict

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
        # Demotion seam for the host tier (queue 1 item 5.2): called with
        # (bid, key) for every cached block an eviction reclaims, before
        # its index entry goes. None: eviction discards.
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
    tokens per round, full prompt blocks shared through the prefix cache
    unless ``prefix_cache`` is off. Drive it with ``admit`` and
    ``step_round``."""

    def __init__(self, params: Params, cfg: ModelConfig, batch_size: int, *,
                 kv_blocks: int | None = None, block_size: int = 64,
                 prefill_budget: int = 64, kv_quant: bool = False,
                 eos_id: int | None = None, temperature: float = 0.0,
                 draft_params: Params | None = None,
                 spec_lookup: bool = False, prefix_cache: bool = True,
                 host_blocks: int = 0, device=None):
        if temperature != 0.0:
            raise _not_ported("sampling (temperature > 0)",
                              "5: sampling with threefry bit-parity")
        if draft_params is not None or spec_lookup:
            raise _not_ported("speculative serving (draft_params, "
                              "spec_lookup)", "5: paged spec rounds")
        if host_blocks:
            raise _not_ported("the host KV tier", "5.2: the host tier")
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
        self.prefix_cache = prefix_cache
        # rid -> prompt tokens served from cache at admission.
        self.request_cached_tokens: dict = {}
        self.allocator = BlockAllocator(kv_blocks, block_size)
        # kv_blocks usable blocks + the null block (id 0).
        self.pools = init_paged_cache(cfg, kv_blocks + 1, block_size,
                                      quantized=True, device=self.device)
        self.slots: list = [None] * batch_size
        self._pre_rr = 0  # round-robin cursor over prefilling rows
        self.stats = {"rounds": 0, "slot_steps": 0, "active_slot_steps": 0,
                      "prefill_tokens": 0, "prefill_chunks": 0,
                      "blocks_total": kv_blocks, "blocks_peak": 0,
                      "defrags": 0, "prompt_tokens": 0,
                      "prefix_hit_tokens": 0, "prefix_hit_requests": 0,
                      "cow_copies": 0}
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
        ``extra_blocks`` already promised to requests ahead of it. Shared
        prefix blocks cost nothing fresh, but a hit on a CACHED block (and
        a cached copy-on-write source, pinned across the copy) revives it
        out of the reclaimable set, so it is debited from ``available``."""
        if self.free_slots() <= extra_slots:
            return False
        plan, cow, _ = self._prefix_plan(list(r.tokens))
        pinned = sum(1 for _tier, b, _k in plan
                     if self.allocator.is_cached(b))
        if cow is not None and self.allocator.is_cached(cow):
            pinned += 1
        return (self.allocator.available() - extra_blocks - pinned
                >= self.blocks_needed(r) - len(plan))

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
        """The allocator's digest (the host tier's half comes with it, queue
        1 item 5.2)."""
        return self.allocator.digest_json()

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
        self.stats["blocks_peak"] = a.stats["peak_used"]

    # ---- admission --------------------------------------------------------

    def _prefix_plan(self, tokens: list):
        """The longest cached full-block chain covering ``tokens``: (plan,
        copy-on-write source id or None, chain key of the covered prefix).
        Each plan entry is (tier, block id, key): ("hbm", id, key) for a
        block in the pool (the host tier's ("host", None, key) comes with
        queue 1 item 5.2). Plan blocks lie strictly below the row's first
        write position (its last prompt token, re-fed at decode); a match
        that would contain it is returned as the copy-on-write source.
        Read-only: refcounts move in ``admit``."""
        if not self.prefix_cache:
            return [], None, b""
        bs = self.block_size
        key = b""
        hits = []
        for j in range(len(tokens) // bs):
            key = block_hash(key, tokens[j * bs:(j + 1) * bs])
            bid = self.allocator.lookup(key)
            if bid is None:
                break
            hits.append(("hbm", bid, key))
        n_sh = min(len(hits), (len(tokens) - 1) // bs)
        cow = hits[n_sh][1] if len(hits) > n_sh else None
        chain = hits[n_sh - 1][2] if n_sh else b""
        return hits[:n_sh], cow, chain

    def admit(self, r: Request) -> None:
        """Reserve the request's block footprint and enqueue its prompt.
        With the prefix cache, the longest cached chain over the prompt is
        refcount-shared into the new table first: its tokens skip prefill
        (``prefilled`` starts past them) and only the uncovered footprint
        is allocated. The one device operation here is the occasional
        copy-on-write block copy; the prefill rides the coming rounds."""
        self.validate(r, self.cfg)
        i = self._free_index()
        if not self.admits(r):
            raise RuntimeError(
                f"request {r.rid}: pool has a free slot but not enough "
                "free KV blocks (callers check admits() before admit)")
        history = list(r.tokens)
        plan, cow, chain = self._prefix_plan(history)
        shared = [b for _tier, b, _k in plan]
        for b in shared:
            self.allocator.incref(b)
        if cow is not None:
            # Pinned across the alloc below, whose eviction pass must not
            # reclaim it before the copy reads it.
            self.allocator.incref(cow)
        fresh = self.allocator.alloc(self.blocks_needed(r) - len(shared))
        prompt_len = len(history)
        hit_tokens = len(plan) * self.block_size
        if cow is not None:
            _copy_block(self.pools, cow, fresh[0])
            self.allocator.free([cow])  # unpin
            hit_tokens = min(hit_tokens + self.block_size, prompt_len - 1)
            self.stats["cow_copies"] += 1
        self.stats["prompt_tokens"] += prompt_len
        self.stats["prefix_hit_tokens"] += hit_tokens
        if hit_tokens:
            self.stats["prefix_hit_requests"] += 1
            telemetry.metrics().inc("kv_prefix_hit_tokens_total", hit_tokens)
        self.request_cached_tokens[r.rid] = hit_tokens
        self.slots[i] = _PagedSlot(
            rid=r.rid, history=history, remaining=r.max_new, generated=[],
            prompt_len=prompt_len, prefilled=hit_tokens,
            blocks=shared + fresh, n_shared=len(shared),
            registered=len(plan), chain_key=chain, cached_tokens=hit_tokens)
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

    def _decoding(self) -> list:
        return [s for s in self.slots
                if s is not None and not self._prefilling(s)
                and s.remaining > 0]

    def _decode_plan(self, dec: list) -> tuple:
        """The decode chunk of a round over the rows ``dec``: (chunk, block
        table (B, nb) on the device, last tokens (B,) and frontiers (B,)
        on the host; rows outside ``dec`` are dummies at token 0,
        position 0 and an all-null table)."""
        chunk = _majority_chunk(dec, self.cfg.max_seq_len)
        if any(self._prefilling(s) for s in self.slots if s is not None):
            # Pending prompts keep decode rounds short, so prefill chunks
            # interleave at budget cadence (the TTFT bound).
            chunk = min(chunk, _bucket_down(self.prefill_budget))
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
        return chunk, self._table(nb, rows=dec), last, pos

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
        """One round: the prefill phase, then one decode chunk for the
        rows whose prompts are done. Returns the event fold's dict."""
        active = [s for s in self.slots if s is not None]
        if not active:
            return {}
        self.stats["rounds"] += 1
        self._prefill_phase()
        dec = self._decoding()
        if not dec:
            self._register_phase()  # prefill chunks fill blocks too
            self._record_block_gauges()
            return {}  # an all-prefill round
        chunk, bt, last, pos = self._decode_plan(dec)
        with telemetry.span("serve.decode_chunk", chunk=chunk,
                            nb=bt.shape[1], rows=len(dec)):
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
          prefill_budget: int = 64, prefix_cache: bool = True,
          overcommit: bool = False, spec_lookup: bool = False,
          device=None) -> dict:
    """Run every request through a ``batch_size``-row pool; returns {rid:
    generated token list}. Greedy; ``eos_id`` finishes a row at the first
    emission of that token (inclusive). ``paged=True`` is the block-paged
    engine (``kv_quant=True`` only; ``kv_blocks``, ``block_size``,
    ``prefill_budget``, ``prefix_cache`` go to it); ``paged=False`` the
    replay-slot engine, whose rounds run the speculative verify-commit
    loop when ``draft_params``/``draft_cfg``/``gamma`` are given (greedy:
    the streams are unchanged). ``stats``, if given, is filled with the
    pool's accounting (rounds, slot_steps, active_slot_steps, and the
    engine's own: prefill_tokens, blocks_peak, ... or replayed_tokens,
    verify_rounds, committed_tokens, draft_steps) plus a
    ``"scheduler"`` sub-dict, and for the paged engine the allocator's
    stats (``"allocator"``) and, on the card, its graphs' (``"graphs"``:
    captured, capture_s, replays).

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
        if paged:
            stats["allocator"] = dict(pool.allocator.stats)
            if pool._graphs is not None:
                stats["graphs"] = dict(pool._graphs.stats)
    return done
