"""The multi-query frontier forward of speculative decoding, the
counterpart of ``tpu_bootstrap/workload/speculative.py``
(``_verify_chunk`` in its vector-position mode, which the paged serving
engine runs as its prefill chunk). The draft/verify loop itself is not
ported yet (ROADMAP queue 1 item 8)."""

from __future__ import annotations

import torch

from tpu_bootstrap_torch.workload.decode import _block_step, _logits
from tpu_bootstrap_torch.workload.model import ModelConfig, Params


def _verify_chunk(params: Params, tokens: torch.Tensor, pos: torch.Tensor,
                  caches: list, cfg: ModelConfig, logits: bool = True):
    """Run a (B, C) chunk at per-row cache slots pos[b] .. pos[b] + C - 1
    (``pos`` a (B,) tensor: row b's chunk is scattered into its own cache
    row, with per-row masks and rotary phases). Caches are written in
    place. Returns (logits (B, C, vocab) f32, caches); with
    ``logits=False`` the head is never computed and the first item is
    None (the serving prefill chunk discards it)."""
    if not (isinstance(pos, torch.Tensor) and pos.ndim == 1):
        raise NotImplementedError(
            "_verify_chunk is ported in its vector-pos mode only (the shared "
            "and ragged modes come with speculative decoding, ROADMAP queue "
            "1 item 8)")
    b, c = tokens.shape
    max_len = caches[0]["k"].shape[1]
    dev = tokens.device
    positions = pos.long()[:, None] + torch.arange(c, device=dev)[None, :]
    cols = torch.arange(max_len, device=dev)
    valid = cols[None, None, :] <= positions[:, :, None]  # (B, C, L)
    x = params["embed"][tokens].to(cfg.compute_dtype)
    for block, cache in zip(params["blocks"], caches):
        x, _ = _block_step(block, x, cache, positions, valid, cfg, slot=pos)
    return (_logits(params, x) if logits else None), caches
