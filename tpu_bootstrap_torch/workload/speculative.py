"""Greedy speculative decoding, the counterpart of
``tpu_bootstrap/workload/speculative.py``: a draft model proposes
``gamma`` tokens, the target scores all ``gamma + 1`` candidate positions
in one multi-query forward, and every committed token is the target's own
argmax, so the output equals the target's greedy ``generate`` whatever
the draft proposes.

The reference runs the loop as one ``lax.while_loop``; here it is a
Python loop with the same state. Acceptance is lockstep across the batch:
a round commits ``min over rows of (accepted + 1)`` tokens, so cache
positions stay equal across rows (one slice write, one shared mask), and
reading that count is the loop's one host read per round. Rejected
speculation stays in the caches beyond the committed frontier, masked,
and is overwritten by the next round.

Under ``kv_quant`` the draft's single-query steps attend through kernel
K5 (``decode_attention.decode_attention_int8``) unless ``kv_kernel`` is
off or the prompts are ragged; the target runs only multi-query chunks
(prefill, the verify chunk), which take the einsum path, so the output
equals ``generate(..., kv_kernel=False)``'s. Draft numerics never reach a
committed token.

``_verify_chunk`` is also the paged serving engine's prefill chunk (its
per-row position mode). Sampled speculative decoding (``temperature >
0``) is not ported.
"""

from __future__ import annotations

import torch

from tpu_bootstrap_torch.workload.decode import (
    _block_step,
    _logits,
    decode_step,
    init_cache,
    prefill,
)
from tpu_bootstrap_torch.workload.model import (
    ModelConfig,
    Params,
    resolve_device,
)


def _verify_chunk(params: Params, tokens: torch.Tensor, pos,
                  caches: list, cfg: ModelConfig, logits: bool = True,
                  pad: torch.Tensor | None = None):
    """Run a (B, C) chunk at cache slots pos .. pos + C - 1, returning the
    logits of every chunk position (B, C, vocab) f32, and the caches
    (written in place). Three modes, as in the reference:

    * ``pos`` a (B,) tensor (``pad`` must be None): per-row frontiers,
      row b's chunk scattered into its own cache row at pos[b], per-row
      masks and rotary phases;
    * ``pos`` an int: one start for every row, chunk row i seeing cache
      columns 0 .. pos + i;
    * ``pos`` an int with ``pad`` (B,) left-pad widths of a ragged batch:
      pad columns excluded from every mask, rotary phases at slot - pad.

    With ``logits=False`` the head is never computed and the first item
    is None (the serving prefill chunk discards it). A chunk of several
    tokens always attends on the einsum path."""
    b, c = tokens.shape
    max_len = caches[0]["k"].shape[1]
    dev = tokens.device
    cols = torch.arange(max_len, device=dev)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        if pad is not None:
            raise ValueError("per-row positions take no pad")
        positions = pos.long()[:, None] + torch.arange(c, device=dev)[None, :]
        valid = cols[None, None, :] <= positions[:, :, None]  # (B, C, L)
        slot = pos
    else:
        slot = int(pos)
        slots = slot + torch.arange(c, device=dev)
        if pad is None:
            positions = slots
            valid = cols[None, :] <= slots[:, None]  # (C, L)
        else:
            positions = slots[None, :] - pad[:, None]  # (B, C)
            valid = ((cols[None, None, :] >= pad[:, None, None])
                     & (cols[None, None, :] <= slots[None, :, None]))
    x = params["embed"][tokens].to(cfg.compute_dtype)
    for block, cache in zip(params["blocks"], caches):
        x, _ = _block_step(block, x, cache, positions, valid, cfg, slot=slot)
    return (_logits(params, x) if logits else None), caches


def _speculative(target_params: Params, draft_params: Params,
                 prompt: torch.Tensor, target_cfg: ModelConfig,
                 draft_cfg: ModelConfig, steps: int, gamma: int,
                 kv_quant: bool, kv_kernel: bool,
                 lengths: torch.Tensor | None):
    """The greedy verify-commit loop; returns ((B, steps) tokens on the
    device, stats)."""
    b, s = prompt.shape
    dev = prompt.device
    cap = s + steps + gamma + 1  # slack: the last round may overshoot
    pad = None if lengths is None else s - lengths
    tcaches = init_cache(target_cfg, b, cap, quantized=kv_quant, device=dev)
    dcaches = init_cache(draft_cfg, b, cap, quantized=kv_quant, device=dev)
    tlogits, _ = prefill(target_params, prompt, tcaches, target_cfg,
                         lengths=lengths, kv_kernel=kv_kernel)
    prefill(draft_params, prompt, dcaches, draft_cfg, lengths=lengths,
            kv_kernel=kv_kernel)
    last = torch.argmax(tlogits, dim=-1)  # exact: the target's own
    out = torch.zeros((b, steps + gamma + 1), dtype=torch.long, device=dev)
    out[:, 0] = last
    # Tokens committed so far, and the cache slot of ``last`` (the newest
    # committed token, not yet fed): equal across rows by lockstep.
    n_out, pos, rounds = 1, s, 0
    while n_out < steps:
        # gamma + 1 draft steps for gamma proposals: the extra step feeds
        # the last proposal through the draft so its KV lands at slot
        # pos + gamma. Without it a full-acceptance round would leave that
        # slot empty inside every later mask (the reference's
        # draft-cache-hole note); the extra proposal is discarded.
        tok, drafts = last, []
        for i in range(gamma + 1):
            logits, _ = decode_step(draft_params, tok, pos + i, dcaches,
                                    draft_cfg, pad=pad, kv_kernel=kv_kernel)
            tok = torch.argmax(logits, dim=-1)
            drafts.append(tok)
        drafts = torch.stack(drafts[:gamma], dim=1)  # (B, gamma)
        chunk = torch.cat([last[:, None], drafts], dim=1)  # (B, gamma + 1)
        vlogits, _ = _verify_chunk(target_params, chunk, pos, tcaches,
                                   target_cfg, pad=pad)
        # greedy[:, i] is the target's token after chunk[:, i]; draft i + 1
        # is accepted iff it matches, and only a matching prefix counts.
        greedy = torch.argmax(vlogits, dim=-1)
        match = (drafts == greedy[:, :-1]).long()
        accepted = torch.cumprod(match, dim=1).sum(dim=1)
        commit = int(accepted.min()) + 1  # the round's host read
        # All gamma + 1 are written; the next round overwrites the tail.
        out[:, n_out:n_out + gamma + 1] = greedy
        last = greedy[:, commit - 1]
        n_out += commit
        pos += commit
        rounds += 1
    # Committed tokens per verify round, with the reference's numerator:
    # every commit (n_out - 1; the first token is free from prefill),
    # overshoot included, so full acceptance reads exactly gamma + 1.
    stats = {"verify_rounds": rounds,
             "mean_committed": (n_out - 1) / max(rounds, 1)}
    return out[:, :steps], stats


def speculative_generate(target_params: Params, draft_params: Params,
                         prompt, target_cfg: ModelConfig,
                         draft_cfg: ModelConfig, steps: int, gamma: int = 4,
                         kv_quant: bool = False,
                         kv_kernel: bool | None = None,
                         with_stats: bool = False,
                         temperature: float = 0.0, key=None,
                         prompt_lengths=None, device=None):
    """Greedy generation of (B, steps) continuations (on the host), equal
    to ``decode.generate(target_params, ..., kv_kernel=False)``'s for
    every row, at up to (gamma + 1)x fewer target weight streams per
    token. A cheap draft that rarely disagrees is the target's own int8
    copy (``quant.quantize_params``).

    ``gamma``: draft proposals per verify chunk. ``kv_quant``: int8 KV
    caches for both models. ``kv_kernel`` defaults to AUTO (on: the
    port's params live on one device) and routes the draft's
    single-query steps through kernel K5. ``with_stats`` also returns
    {"verify_rounds", "mean_committed"} (committed tokens per round,
    gamma + 1 at full acceptance). ``prompt_lengths`` (B,) are the true
    lengths of a LEFT-padded ragged batch, as in ``generate``; they force
    the einsum path (per-row masks). ``device`` None means the card.

    ``temperature > 0`` (the reference's rejection-sampling mode) raises
    NotImplementedError; ``key`` belongs to it."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(
            f"target and draft must share a vocab: {target_cfg.vocab_size} "
            f"vs {draft_cfg.vocab_size}")
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if temperature > 0 and key is None:
        raise ValueError("temperature > 0 requires an explicit PRNG key")
    if temperature > 0:
        raise NotImplementedError(
            "sampled speculative decoding is not ported yet (ROADMAP queue "
            "1 item 5.7: threefry sampling)")
    device = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=device).long()
    lengths = None
    if prompt_lengths is not None:
        lengths = torch.as_tensor(prompt_lengths, device=device).long()
        lo, hi = int(lengths.min()), int(lengths.max())
        if lo < 1 or hi > prompt.shape[1]:
            raise ValueError(
                f"prompt_lengths must be in [1, {prompt.shape[1]}] (the "
                f"padded prompt width); got [{lo}, {hi}]")
        kv_kernel = False  # per-row masks: the einsum path
    elif kv_kernel is None:
        kv_kernel = True
    out, stats = _speculative(target_params, draft_params, prompt,
                              target_cfg, draft_cfg, steps, gamma, kv_quant,
                              kv_kernel, lengths)
    out = out.cpu()
    return (out, stats) if with_stats else out
