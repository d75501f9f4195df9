"""Autoregressive decoding with a KV cache, the counterpart of
``tpu_bootstrap/workload/decode.py``.

Two cache layouts: contiguous ``(B, L, Hk, D)`` caches (``init_cache``,
used by ``prefill``/``decode_step``/``generate``) and block-paged pools
``(N, bs, Hk, D)`` (``init_paged_cache``, used by ``paged_decode_step``
and the paged serving engine). int8 caches carry one f32 scale per
cached vector.

Caches and pools are updated IN PLACE (the reference donates them to its
jitted steps and gets new arrays back): every function that writes KV
writes into the tensors it was given and also returns them, so callers
written against the reference's functional form keep working.

Every int8 projection runs through kernel K1 and every int4 projection
through K6 (a MoE block's expert stacks through K1e / K6e).
``paged_decode_step`` attends through kernel K2. ``_block_step`` (and so
``prefill``, ``decode_step`` and ``generate``) attends a single query over
an int8 cache with one shared mask row through kernel K5 when
``kv_kernel`` is on (the default, as in the reference; ``generate``'s
AUTO resolves to on, the port's params being on one device), and
everything else -- multi-query chunks, per-row masks, float caches,
``kv_kernel=False`` -- on the einsum path, which is the solo oracle the
serving engines are held to. ``prefill(flash=True)`` /
``generate(prefill_flash=True)`` run the prompt's causal self-attention
through the flash kernel K3 instead.

On the card, ``generate``'s decode loop (without ``prompt_lengths``) is a
CUDA graph of one step (``graphs``), replayed for every step after the
first: the counterpart of the reference's jitted scan. ``decode_step``
takes its position as a 0-d device tensor for that.

Sampling (``temperature > 0``) draws as the reference does, bit for bit
in its integer half (``prng``): temperature first, then the top-k and
nucleus filters (``_filter_logits``), then a gumbel ``categorical`` with
the next key of a split chain, or with ``fold_in(row_keys[r], offsets[r]
+ k)`` for token k of row r. The captured step samples too: its keys and
offsets are static buffers the step reads (``Sampler``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import decode_attention, graphs, prng, quant
from tpu_bootstrap_torch.workload.flash_attention import flash_attention
from tpu_bootstrap_torch.workload.moe import moe_mlp
from tpu_bootstrap_torch.workload.model import (
    ModelConfig,
    Params,
    _mlp,
    _rms_norm,
    _rotary,
    resolve_device,
)


def _linear(x: torch.Tensor, w, contract_rank: int, dtype,
            tag: str = "") -> torch.Tensor:
    """Projection of x's trailing dims against w's leading dims, for
    float, int8 or int4 weights (the seam through which K1 and K6 reach
    every block projection and the head)."""
    k = math.prod(w.shape[:contract_rank])
    x2 = x.reshape(-1, k).to(dtype)
    if quant.is_quantized(w):
        y = quant.quantized_matmul(x2, w, tag=tag)
    else:
        y = x2 @ w.to(dtype).reshape(k, -1)
    return y.reshape(*x.shape[: x.ndim - contract_rank],
                     *w.shape[contract_rank:])


def _kv_arrays(cfg: ModelConfig, shape: tuple, quantized: bool,
               device) -> list:
    if quantized:
        sshape = shape[:-1]
        return [{"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "k_scale": torch.zeros(sshape, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v_scale": torch.zeros(sshape, device=device)}
                for _ in range(cfg.num_layers)]
    return [{"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
            for _ in range(cfg.num_layers)]


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               quantized: bool = False, device=None) -> list:
    """One (k, v) buffer pair per block, (batch, max_len, Hk, D)."""
    return _kv_arrays(cfg, (batch, max_len, cfg.kv_heads, cfg.head_dim),
                      quantized, resolve_device(device))


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     quantized: bool = False, device=None) -> list:
    """One physical block pool per layer, (num_blocks, block_size, Hk, D);
    the first axis is the physical block id (serving keeps id 0 as the
    null block that pads short tables)."""
    return _kv_arrays(cfg, (num_blocks, block_size, cfg.kv_heads,
                            cfg.head_dim), quantized, resolve_device(device))


def _quantize_kv(x: torch.Tensor):
    """(..., D) -> int8 values + per-vector f32 scales (max-abs / 127,
    floored at 1e-8), bit-equal to the reference's."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.round(xf / scale[..., None])
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return q.to(dtype) * scale[..., None].to(dtype)


def _qkv(block: Params, h: torch.Tensor, positions: torch.Tensor,
         cfg: ModelConfig):
    """Projections + rotary; a quantized tree's fused ``wqkv`` is one K1
    (int8) or K6 (int4) launch, MoE blocks project wq/wk/wv apart."""
    dtype = cfg.compute_dtype
    wqkv = block.get("wqkv")
    lead = h.shape[:-1]
    if wqkv is not None and quant.is_quantized(wqkv):
        fused = _linear(h, wqkv, 1, dtype, tag="qkv")
        nq = cfg.num_heads * cfg.head_dim
        nk = cfg.kv_heads * cfg.head_dim
        q = fused[..., :nq].reshape(*lead, cfg.num_heads, cfg.head_dim)
        k = fused[..., nq:nq + nk].reshape(*lead, cfg.kv_heads, cfg.head_dim)
        v = fused[..., nq + nk:].reshape(*lead, cfg.kv_heads, cfg.head_dim)
        return _rotary(q, positions), _rotary(k, positions), v
    q = _rotary(_linear(h, block["wq"], 1, dtype), positions)
    k, v = _project_kv(block, h, positions, cfg)
    return q, k, v


def _project_kv(block: Params, h: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig):
    dtype = cfg.compute_dtype
    k = _linear(h, block["wk"], 1, dtype)
    v = _linear(h, block["wv"], 1, dtype)
    return _rotary(k, positions), v


def paged_decode_step(params: Params, token: torch.Tensor, pos: torch.Tensor,
                      pools: list, block_tables: torch.Tensor,
                      cfg: ModelConfig):
    """One token (B,) against the block-paged int8 pools at per-row
    frontiers ``pos`` (B,): row b's new KV is written IN PLACE at block
    ``block_tables[b, pos[b] // bs]``, offset ``pos[b] % bs``, and
    attention streams the row's own blocks through kernel K2 with
    lengths ``pos + 1``. The logical block is clamped to the table width
    as in the reference: overshoot rows of a majority chunk write into
    their own last block (or the null block), beyond every kept token's
    mask. Returns (next-token logits (B, vocab) f32, pools)."""
    bs = pools[0]["k"].shape[1]
    dtype = cfg.compute_dtype
    nb = block_tables.shape[1]
    pos = pos.long()
    logical = torch.clamp(pos // bs, max=nb - 1)
    blk_idx = torch.gather(block_tables.long(), 1, logical[:, None])[:, 0]
    off = pos % bs
    positions = pos[:, None]
    lengths = (pos + 1).to(torch.int32)
    x = params["embed"][token[:, None]].to(dtype)
    for block, pool in zip(params["blocks"], pools):
        h = _rms_norm(x, block["attn_norm"])
        q, k, v = _qkv(block, h, positions, cfg)
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        # Frontier write: block ownership is unique by allocator
        # construction, so live rows never collide; dummy rows all write
        # the null block, which no mask admits.
        pool["k"].index_put_((blk_idx, off), kq[:, 0])
        pool["k_scale"].index_put_((blk_idx, off), ks[:, 0])
        pool["v"].index_put_((blk_idx, off), vq[:, 0])
        pool["v_scale"].index_put_((blk_idx, off), vs[:, 0])
        out = decode_attention.paged_decode_attention_int8(
            q[:, 0].contiguous(), pool["k"], pool["k_scale"], pool["v"],
            pool["v_scale"], block_tables, lengths)
        x = x + _linear(out[:, None], block["wo"], 2, dtype)
        x = _mlp_tail(block, x, cfg)
    return _logits(params, x)[:, 0], pools


def _row_scatter(cache_arr: torch.Tensor, new: torch.Tensor,
                 starts: torch.Tensor) -> None:
    """In place: row b of ``new`` (B, C, ...) lands at ``starts[b]`` of
    row b of the cache (B, L, ...). Starts are clamped to [0, L - C], as
    the reference's dynamic_update_slice clamps them."""
    b, c = new.shape[:2]
    length = cache_arr.shape[1]
    start = torch.clamp(starts.long(), 0, length - c)
    rows = torch.arange(b, device=cache_arr.device)[:, None]
    cols = start[:, None] + torch.arange(c, device=cache_arr.device)[None, :]
    cache_arr.index_put_((rows, cols), new)


def _slice_write(cache_arr: torch.Tensor, new: torch.Tensor,
                 start) -> None:
    """In place: ``new`` (B, C, ...) at slots [start, start + C) of every
    row, start clamped like the reference's dynamic_update_slice. A 0-d
    tensor ``start`` stays on the device (an index write), so a captured
    step copies nothing from the host."""
    c = new.shape[1]
    if isinstance(start, torch.Tensor):
        first = torch.clamp(start.reshape(1), 0, cache_arr.shape[1] - c)
        cache_arr.index_copy_(
            1, first + torch.arange(c, device=cache_arr.device), new)
        return
    start = max(0, min(int(start), cache_arr.shape[1] - c))
    cache_arr[:, start:start + c] = new


@functools.lru_cache(maxsize=None)
def _score_scale(head_dim: int) -> float:
    """head_dim ** -0.5 in f32, bit for bit the reference's
    ``jnp.asarray(head_dim, jnp.float32) ** -0.5``, as a Python float: exact
    in f32, so scores scaled by it round as by that f32 scalar. Computed
    once per head dim on the host, so a step builds no tensor for it and
    copies nothing to the device."""
    return float(np.float32(head_dim) ** np.float32(-0.5))


def _attend(q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
            valid: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q (B, S, H, D) against the (B, L, Hk, D) cache, masked to ``valid``
    ((S, L) shared, or (B, S, L) per row). Scores and softmax in f32, the
    probabilities cast to the compute dtype before the value product."""
    dtype = cfg.compute_dtype
    b, s, heads, d = q.shape
    kv_heads = cache_k.shape[2]
    group = heads // kv_heads
    qg = q.reshape(b, s, kv_heads, group, d)
    scores = torch.einsum("bskgd,blkd->bkgsl", qg.float(),
                          cache_k.float()) * _score_scale(cfg.head_dim)
    mask = valid[:, None, None] if valid.ndim == 3 else valid[None, None, None]
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    out = torch.einsum("bkgsl,blkd->bskgd", probs, cache_v.to(dtype))
    return out.reshape(b, s, heads, d)


def _block_step(block: Params, x: torch.Tensor, cache: dict,
                positions: torch.Tensor, valid: torch.Tensor,
                cfg: ModelConfig, slot=None, prefill_flash: bool = False,
                kv_kernel: bool = True):
    """One block over x (B, S, E): its KV written into ``cache`` (in
    place) at ``positions`` and attention over the whole cache. ``slot``
    as a (B,) tensor writes each row at its own start (per-row
    frontiers); otherwise the chunk starts at ``slot`` or at positions[0]
    for every row. On an int8 cache the chunk's quantized K/V are written
    first, so the chunk sees its own KV at int8 precision, as in the
    reference; then a single query (S == 1) under one shared mask row
    ((1, L) ``valid``) attends through kernel K5 when ``kv_kernel`` is on
    and ``decode_attention.supports`` the cache, and anything else reads
    the dequantized cache on the einsum path. ``prefill_flash`` on a
    multi-token chunk attends causally over the chunk's own (q, k, v)
    through the flash kernel, never reading the cache (a fresh prefill's
    attention is exactly that)."""
    dtype = cfg.compute_dtype
    h = _rms_norm(x, block["attn_norm"])
    q, k, v = _qkv(block, h, positions, cfg)
    start = positions.reshape(-1)[0] if slot is None else slot
    per_row = isinstance(start, torch.Tensor) and start.ndim == 1
    quantized = "k_scale" in cache
    if quantized:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        new = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
    else:
        new = {"k": k, "v": v}
    for name, arr in new.items():
        if per_row:
            _row_scatter(cache[name], arr, start)
        else:
            _slice_write(cache[name], arr, start)
    if (quantized and kv_kernel and q.shape[1] == 1 and valid.ndim == 2
            and decode_attention.supports(cache["k"].shape[1],
                                          cache["k"].shape[2],
                                          cache["k"].shape[3],
                                          q.shape[2])):
        out = decode_attention.decode_attention_int8(
            q[:, 0].contiguous(), cache["k"], cache["k_scale"], cache["v"],
            cache["v_scale"], valid[0].contiguous())
        x = x + _linear(out[:, None], block["wo"], 2, dtype)
        return _mlp_tail(block, x, cfg), cache
    if prefill_flash and q.shape[1] > 1:
        out = flash_attention(q, k, v, causal=True)
    else:
        if quantized:
            cache_k = _dequantize_kv(cache["k"], cache["k_scale"], dtype)
            cache_v = _dequantize_kv(cache["v"], cache["v_scale"], dtype)
        else:
            cache_k, cache_v = cache["k"], cache["v"]
        out = _attend(q, cache_k, cache_v, valid, cfg)
    x = x + _linear(out, block["wo"], 2, dtype)
    return _mlp_tail(block, x, cfg), cache


def _mlp_tail(block: Params, x: torch.Tensor, cfg: ModelConfig):
    """The FFN half of a block: the dense MLP through ``_linear``, or the
    MoE layer, whose expert stacks launch K1e / K6e."""
    if cfg.num_experts > 0:
        out, _ = moe_mlp(block, _rms_norm(x, block["mlp_norm"]), cfg)
        return x + out
    return x + _mlp(block, x, cfg, linear=_linear)


def _logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    x = _rms_norm(x, params["final_norm"])
    head = params.get("lm_head")
    if head is not None and quant.is_quantized(head):
        return _linear(x, head, 1, torch.float32, tag="head")
    # f32 x f32, as the reference promotes a bf16-stored embedding.
    return torch.einsum("bse,ve->bsv", x.float(), params["embed"].float())


def prefill(params: Params, tokens: torch.Tensor, caches: list,
            cfg: ModelConfig, lengths: torch.Tensor | None = None,
            all_logits: bool = False, flash: bool = False,
            kv_kernel: bool = True, logits: bool = True):
    """Run the prompt (B, S) into cache slots [0, S) (in place). Returns
    (logits of the last position (B, vocab), caches), or all positions'
    logits with ``all_logits``; with ``logits=False`` the head is never
    computed and the first item is None (an admission prefill that keeps
    only the cache). ``lengths`` (B,) are the true lengths of
    a LEFT-padded ragged batch: pad columns are masked out and rotary
    phases count from each row's first real token. ``flash`` runs the
    prompt's causal self-attention through kernel K3, in O(S) memory: the
    long-prompt path (not with ``lengths``: its causal mask cannot
    exclude per-row pads). ``kv_kernel`` as in ``_block_step`` (only a
    one-token prompt is a single query)."""
    if flash and lengths is not None:
        raise ValueError(
            "ragged prompts (lengths) do not compose with the flash "
            "prefill — its causal mask cannot exclude per-row pads")
    b, s = tokens.shape
    max_len = caches[0]["k"].shape[1]
    dev = tokens.device
    cols = torch.arange(max_len, device=dev)
    slot = 0
    if lengths is None:
        positions = torch.arange(s, device=dev)
        valid = cols[None, :] <= positions[:, None]
    else:
        pad = (s - lengths).long()
        positions = torch.clamp(torch.arange(s, device=dev)[None, :]
                                - pad[:, None], min=0)
        valid = ((cols[None, None, :] >= pad[:, None, None])
                 & (cols[None, None, :]
                    <= torch.arange(s, device=dev)[None, :, None]))
    x = params["embed"][tokens].to(cfg.compute_dtype)
    for block, cache in zip(params["blocks"], caches):
        x, _ = _block_step(block, x, cache, positions, valid, cfg, slot=slot,
                           prefill_flash=flash, kv_kernel=kv_kernel)
    if not logits:
        return None, caches
    if all_logits:
        return _logits(params, x), caches
    return _logits(params, x[:, -1:])[:, 0], caches


def decode_step(params: Params, token: torch.Tensor, pos, caches: list,
                cfg: ModelConfig, pad: torch.Tensor | None = None,
                kv_kernel: bool = True):
    """One token (B,) at cache slot ``pos``; returns (logits (B, vocab),
    caches). ``pos`` is an int, or a 0-d int64 tensor on the token's
    device: then positions, the mask and the KV write are computed on the
    device, with the same bits, and the step copies nothing from the host
    (``generate``'s captured step). ``pad`` (B,) are the left-pad widths
    of a ragged batch (per-row masks: the einsum path). Without ``pad``,
    an int8 cache attends through kernel K5 unless ``kv_kernel`` is off.
    ``pos`` a (B,) tensor (``pad`` None) is the per-row frontier mode:
    row b writes slot pos[b] of its own cache row, attends columns [0,
    pos[b]] and takes rotary phase pos[b] (per-row masks: the einsum
    path; the paged engine's draft window)."""
    max_len = caches[0]["k"].shape[1]
    dev = token.device
    cols = torch.arange(max_len, device=dev)
    slot = pos if isinstance(pos, torch.Tensor) else int(pos)
    if pad is None and isinstance(pos, torch.Tensor) and pos.ndim == 1:
        positions = pos.long()[:, None]
        valid = (cols[None, :] <= positions)[:, None, :]  # (B, 1, L)
    elif pad is None:
        positions = (slot.reshape(1) if isinstance(slot, torch.Tensor)
                     else torch.tensor([slot], device=dev))
        valid = (cols <= slot)[None, :]
    else:
        positions = (pos - pad)[:, None]
        valid = ((cols[None, :] <= pos) & (cols[None, :] >= pad[:, None])
                 )[:, None, :]
    x = params["embed"][token[:, None]].to(cfg.compute_dtype)
    for block, cache in zip(params["blocks"], caches):
        x, _ = _block_step(block, x, cache, positions, valid, cfg, slot=slot,
                           kv_kernel=kv_kernel)
    return _logits(params, x)[:, 0], caches


def _filter_logits(logits: torch.Tensor, top_k: int,
                   top_p: float) -> torch.Tensor:
    """The reference's sampling filters, static-shape: ``top_k > 0`` keeps
    the logits at or above the k-th largest (every tie survives; k is
    clamped to the vocabulary), ``top_p < 1`` keeps the smallest prefix of
    the sorted vocabulary whose mass reaches p, each entry kept while the
    mass BEFORE it is below p, so the top choice always survives. Dropped
    entries become -inf."""
    if top_k > 0:
        k = min(top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        ordered = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(ordered, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # The cutoff is the smallest kept logit; everything below drops.
        cutoff = ordered.masked_fill((cum - probs) >= top_p,
                                     float("inf")).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


class Sampler:
    """The reference's ``pick`` for sampled decoding, one per call or
    pool: ``temperature`` applied first, then ``_filter_logits``, then a
    gumbel ``categorical``. With ``row_keys`` (B, 2) token k of row r draws
    with ``fold_in(row_keys[r], offsets[r] + k)``, a function of the row's
    own stream position alone; without, every pick takes the next key of
    the split chain held in ``chain`` (2,), advanced in place. The keys
    and offsets are tensors on the logits' device that callers may load
    in place between steps, so a captured step samples from them."""

    def __init__(self, temperature: float, top_k: int = 0,
                 top_p: float = 1.0, chain: torch.Tensor | None = None,
                 row_keys: torch.Tensor | None = None,
                 offsets: torch.Tensor | None = None):
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.chain, self.row_keys, self.offsets = chain, row_keys, offsets

    def __call__(self, logits: torch.Tensor, idx) -> torch.Tensor:
        """The tokens (B,) drawn from ``logits`` (B, V) as pick ``idx`` of
        the stream (an int, or a (1,) device counter)."""
        if self.chain is not None:
            # The reference splits its chain before every pick, also when
            # row keys draw: a consumed key is never reused.
            keys = prng.split(self.chain)
            self.chain.copy_(keys[0])
        filt = _filter_logits(logits / self.temperature, self.top_k,
                              self.top_p)
        if self.row_keys is not None:
            return prng.categorical(
                prng.fold_in(self.row_keys, self.offsets + idx), filt)
        return prng.categorical(keys[1], filt)


def generate(params: Params, prompt, cfg: ModelConfig, steps: int,
             temperature: float = 0.0, key=None, top_k: int = 0,
             top_p: float = 1.0, kv_quant: bool = False,
             kv_kernel: bool | None = None, prefill_flash: bool = False,
             prompt_lengths=None, row_keys=None, row_key_offsets=None,
             device=None) -> torch.Tensor:
    """Greedy (``temperature`` 0) or sampled generation: prompt (B, S) ->
    (B, steps) continuations. The cache is sized S + steps.

    Sampling is the reference's, bit for bit in its integer half
    (``prng``): logits over ``temperature``, then the ``top_k`` and
    ``top_p`` filters (``_filter_logits``), then a gumbel ``categorical``.
    ``key`` (default ``PRNGKey(0)``, an array of two uint32 words) is
    split before the first pick and before every later one. With
    ``row_keys`` (B, 2), token k of row r draws with ``fold_in(row_keys[r],
    row_key_offsets[r] + k)`` instead (offsets default to 0: the tokens a
    row generated before this call), so a row's stream does not depend on
    its batch or on how its decoding was cut into calls.

    ``kv_kernel`` defaults to AUTO, which is on
    (the port's params live on one device): with ``kv_quant`` every decode
    step attends through kernel K5. ``kv_kernel=False`` keeps attention on
    the einsum path, which makes this the solo oracle the serving engines
    are held to; ``prompt_lengths`` (a ragged, left-padded batch: per-row
    masks) forces it off. ``prefill_flash`` runs the prompt through kernel
    K3 (not with ``prompt_lengths``). The decode loop keeps tokens on the
    device and reads them back once at the end. On the card, without
    ``prompt_lengths``, the decode step is a CUDA graph (``graphs``): its
    first run is the eager warm-up, then it is captured once per call (the
    caches are this call's) and replayed for every later step, sampling
    included; the prefill stays eager."""
    if prefill_flash and prompt_lengths is not None:
        raise ValueError(
            "prompt_lengths does not compose with prefill_flash (the "
            "flash causal mask cannot exclude per-row pads)")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if row_key_offsets is not None and row_keys is None:
        raise ValueError("row_key_offsets requires row_keys")
    if row_keys is not None and temperature == 0.0:
        raise ValueError(
            "row_keys given but temperature is 0 (greedy ignores them); "
            "set temperature > 0 for per-row sampled streams")
    device = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=device).long()
    b, s = prompt.shape
    lengths = pad = None
    if prompt_lengths is not None:
        lengths = torch.as_tensor(prompt_lengths, device=device).long()
        if int(lengths.min()) < 1 or int(lengths.max()) > s:
            raise ValueError(f"prompt_lengths must be in [1, {s}]")
        pad = s - lengths
        kv_kernel = False  # per-row masks: the einsum path
    elif kv_kernel is None:
        kv_kernel = True
    with telemetry.span("decode.generate", steps=steps, batch=b,
                        kv_quant=int(kv_quant)):
        caches = init_cache(cfg, b, s + steps, quantized=kv_quant,
                            device=device)
        logits, caches = prefill(params, prompt, caches, cfg, lengths=lengths,
                                 flash=prefill_flash, kv_kernel=kv_kernel)
        sampler = None
        if temperature != 0.0:
            sampler = Sampler(
                temperature, top_k, top_p,
                chain=prng.as_key(prng.key(0) if key is None else key,
                                  device).clone(),
                row_keys=(None if row_keys is None
                          else prng.as_key(row_keys, device)),
                offsets=(None if row_keys is None else torch.as_tensor(
                    0 if row_key_offsets is None else row_key_offsets,
                    device=device).long().expand(b)))
        token = (torch.argmax(logits, dim=-1) if sampler is None
                 else sampler(logits, 0))
        runner = graphs.for_device(device) if pad is None else None
        if runner is not None:
            return _graphed_decode(runner, params, token, s, caches, cfg,
                                   steps, kv_kernel, sampler)
        toks = [token]
        for i in range(steps - 1):
            logits, caches = decode_step(params, token, s + i, caches, cfg,
                                         pad=pad, kv_kernel=kv_kernel)
            token = (torch.argmax(logits, dim=-1) if sampler is None
                     else sampler(logits, i + 1))
            toks.append(token)
        return torch.stack(toks, dim=1).cpu()


def _decode_graph_step(params: Params, tok: torch.Tensor, pos: torch.Tensor,
                       caches: list, out: torch.Tensor, step: torch.Tensor,
                       cfg: ModelConfig, kv_kernel: bool,
                       sampler: Sampler | None = None) -> None:
    """``generate``'s decode step on static buffers, the body its graph
    captures: token ``tok`` (B,) at the 0-d position ``pos``, its argmax
    (or the ``sampler``'s draw, pick ``step`` of the stream) written into
    ``out`` at column ``step``, all three advanced in place."""
    logits, _ = decode_step(params, tok, pos, caches, cfg,
                            kv_kernel=kv_kernel)
    nxt = (torch.argmax(logits, dim=-1) if sampler is None
           else sampler(logits, step))
    graphs.commit(nxt, tok, pos, out, step)


def _graphed_decode(runner, params: Params, token: torch.Tensor, s: int,
                    caches: list, cfg: ModelConfig, steps: int,
                    kv_kernel: bool,
                    sampler: Sampler | None = None) -> torch.Tensor:
    """The ``steps - 1`` decode steps after the prefill's token through
    ``runner``: the first the warm-up, then the capture, the rest replays;
    returns (B, steps) on the host."""
    dev = token.device
    out = torch.empty((token.shape[0], steps), dtype=token.dtype,
                      device=dev)
    out[:, 0] = token
    tok = token.clone()
    pos = torch.tensor(s, dtype=torch.long, device=dev)
    step = torch.ones(1, dtype=torch.long, device=dev)
    runner.run("step", functools.partial(
        _decode_graph_step, params, tok, pos, caches, out, step, cfg,
        kv_kernel, sampler), steps - 1)
    return out.cpu()


def _fed_logits(params: Params, prompt: list, tokens: list,
                cfg: ModelConfig, kv_quant: bool, device):
    """The logits (vocab,) of every step of a run over one prompt that
    emitted ``tokens``: the same prefill and decode steps as
    ``generate(steps=len(tokens), kv_kernel=False)`` (the einsum oracle),
    fed ``tokens`` instead of its own picks."""
    device = resolve_device(device)
    s, steps = len(prompt), len(tokens)
    fed = torch.as_tensor(tokens, device=device).long()
    caches = init_cache(cfg, 1, s + steps, quantized=kv_quant, device=device)
    logits, caches = prefill(params, torch.as_tensor([prompt], device=device)
                             .long(), caches, cfg, kv_kernel=False)
    for i in range(steps):
        if i:
            logits, caches = decode_step(params, fed[i - 1:i], s + i - 1,
                                         caches, cfg, kv_kernel=False)
        yield logits[0].float()


def greedy_margins(params: Params, prompt: list, tokens: list,
                   cfg: ModelConfig, kv_quant: bool = False,
                   device=None) -> list:
    """Top-2 logit margin of every step of a greedy run over one prompt
    that emitted ``tokens``: the same prefill and decode steps as
    ``generate(steps=len(tokens), kv_kernel=False)`` (the einsum oracle),
    fed ``tokens`` instead of its own argmaxes, so on that run's own
    output the logits are the ones it saw. A small margin marks a step
    where another run may fairly pick the other token (a near-tie)."""
    margins = []
    for logits in _fed_logits(params, prompt, tokens, cfg, kv_quant, device):
        top2 = torch.topk(logits, 2).values
        margins.append(top2[0] - top2[1])
    return torch.stack(margins).tolist()


def _pick_margin(logits: torch.Tensor, g: torch.Tensor, temperature: float,
                 top_k: int, top_p: float) -> float:
    """How far one sampled pick (logits (V,), gumbel noise ``g``) is from
    another pick: twice the smallest shift of the logits, in logit units,
    that changes the drawn token, so that it compares with a greedy top-2
    margin. The candidates: the top-two gap of the filtered scaled logits
    plus noise; a dropped token that would win if kept rising past the
    smallest kept logit; the winner leaving the kept set, past the top-k
    cutoff or by the mass before it reaching ``top_p`` (tokens below it
    rising past it, or every mass scaled by at most exp(shift /
    temperature))."""
    t = temperature
    x = logits.float() / t
    z = _filter_logits(x, top_k, top_p) + g
    kept = torch.isfinite(z)
    win = int(torch.argmax(z))
    top2 = torch.topk(z, 2).values
    margins = [float(top2[0] - top2[1]) * t]
    if bool(kept.all()):
        return margins[0]
    # Rivals: a dropped token enters once it passes the smallest kept one.
    c_in = x[kept].min()
    rivals = ~kept & (x + g > z[win])
    if bool(rivals.any()):
        margins.append(float(c_in - x[rivals].max()) * t)
    # The winner leaves past the top-k cutoff ...
    in_k = torch.isfinite(_filter_logits(x, top_k, 1.0))
    if not bool(in_k.all()):
        margins.append(float(x[win] - x[~in_k].max()) * t)
    # ... or once the mass before it reaches top_p.
    if top_p < 1.0:
        xs, order = torch.sort(x.masked_fill(~in_k, float("-inf")),
                               descending=True)
        probs = torch.softmax(xs, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        r = int(torch.nonzero(order == win)[0])
        before = float(cum[r] - probs[r])
        if before > 0:
            margins.append(t * math.log(top_p / before))
        past = torch.nonzero((cum >= top_p + probs[r])
                             & (torch.arange(len(xs), device=x.device) > r)
                             & torch.isfinite(xs))
        if len(past):
            margins.append(float(xs[r] - xs[int(past[0])]) * t)
    return min(margins)


def sampled_margins(params: Params, prompt: list, tokens: list,
                    cfg: ModelConfig, row_key, temperature: float,
                    top_k: int = 0, top_p: float = 1.0, offset: int = 0,
                    kv_quant: bool = False, device=None) -> list:
    """The sampled counterpart of ``greedy_margins``, for a run that drew
    ``tokens`` with row key ``row_key`` from stream position ``offset``:
    each pick's distance from another pick in logit units (``_pick_margin``:
    the top-two gap of logits plus gumbel noise, and the filters' cutoff),
    comparable with a greedy margin. A small margin marks a step where
    another run may fairly draw the other token."""
    row_key = prng.as_key(row_key, resolve_device(device))
    return [_pick_margin(logits, prng.gumbel(prng.fold_in(row_key, offset + i),
                                             tuple(logits.shape)),
                         temperature, top_k, top_p)
            for i, logits in enumerate(_fed_logits(params, prompt, tokens,
                                                   cfg, kv_quant, device))]
