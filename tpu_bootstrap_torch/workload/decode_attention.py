"""Single-query attention over an int8 KV cache, the counterpart of
``tpu_bootstrap/workload/decode_attention.py``.

A decode step's attention reads every cached vector of the row to score
one query: a few MB for a batch, too few to keep the card's memory busy,
so what bounds it is latency. Two kernels do it on the card, on one
shared body (``csrc/decode_attention.cuh``): a row's positions are cut
into chunks at fixed logical boundaries, the chunks are spread over a
cluster of CTAs and all requested at once, each chunk yields its own f32
partial softmax (m, l, acc), and the partials are combined in chunk order
(``kernels.paged_plan`` / ``decode_plan`` choose the split; the result
does not depend on it, nor on the batch):

* ``decode_attention_int8`` runs kernel K5 (``csrc/decode_attention.cu``,
  the port of the reference's ``_kernel``) over a contiguous
  ``(B, L, Hk, D)`` cache masked by one validity row shared by the batch,
  in chunks of ``kernels.DECODE_CHUNK`` positions: ``generate``'s decode
  steps and the speculative draft's;
* ``paged_decode_attention_int8`` runs kernel K2
  (``csrc/paged_attention.cu``, the port of ``_paged_kernel``) over the
  block-paged pool, a chunk per block: each row reads only its own blocks
  through its block table, up to its own length.

On a CPU tensor each runs its ``*_plain`` version, the same function in
plain PyTorch; on a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from tpu_bootstrap_torch.workload import kernels

_NEG = -1e30


def supports(length: int, kv_heads: int, head_dim: int,
             num_heads: int | None = None) -> bool:
    """Whether K5 takes this cache geometry. The port's own rule, from the
    kernel's limits (the reference's Mosaic tiling rules do not apply):
    any length >= 1, head_dim a multiple of 16 (16-byte loads), and a
    split of ``kernels.decode_plan`` whose shared memory, for a query
    group of ``num_heads / kv_heads`` heads (1 when not given), fits a
    CTA."""
    group = (num_heads // kv_heads) if num_heads else 1
    return length >= 1 and kernels.decode_plan(
        length, kv_heads, group, head_dim) is not None


def decode_attention_int8_plain(q, kq, ks, vq, vs, valid) -> torch.Tensor:
    """K5's function in plain PyTorch: dequantize in f32, zero the values
    at masked positions (so garbage there cannot reach the result), f32
    softmax of (q * D^-0.5) . k with masked scores at -1e30, then p . v in
    q.dtype."""
    b, h, d = q.shape
    _, length, hk, _ = kq.shape
    g = h // hk
    vmask = valid[None, :, None, None]
    zero = torch.zeros((), device=q.device)
    k = torch.where(vmask, kq.float() * ks.float()[..., None], zero)
    v = torch.where(vmask, vq.float() * vs.float()[..., None], zero)
    qg = q.float().reshape(b, hk, g, d) * (d ** -0.5)
    s = torch.einsum("bkgd,blkd->bkgl", qg, k)
    s = s.masked_fill(~valid[None, None, None, :], _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", p, v)
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_int8(q: torch.Tensor, kq: torch.Tensor,
                          ks: torch.Tensor, vq: torch.Tensor,
                          vs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Single-position attention over a contiguous quantized cache.

    q: (B, H, D), any float dtype the kernel takes (bf16, f32);
    kq/vq: (B, L, Hk, D) int8; ks/vs: (B, L, Hk) f32 per-vector scales
    (``decode.init_cache(quantized=True)``'s layout, H % Hk == 0);
    valid: (L,) bool, the cache slots every row's query may see. Returns
    (B, H, D) in q.dtype: kernel K5 on the card, the plain version on the
    CPU. The contract covers masks with at least one valid slot (every
    mask ``generate`` and the speculative draft build: slot 0 is always
    valid). An all-masked row gives zeros in both versions (the
    reference's kernel gives the mean of the row's values there)."""
    b, h, d = q.shape
    length, hk = kq.shape[1], kq.shape[2]
    if not supports(length, hk, d, h):
        raise ValueError(
            f"cache (length={length}, kv_heads={hk}, head_dim={d}, "
            f"heads={h}) is outside the kernel's limits; see supports")
    if q.is_cuda:
        return kernels.decode_attention(q, kq, ks, vq, vs, valid)
    if q.device.type != "cpu":
        raise ValueError(f"decode attention: no kernel for device {q.device}")
    return decode_attention_int8_plain(q, kq, ks, vq, vs, valid)


def paged_supports(block_size: int, kv_heads: int, head_dim: int,
                   num_heads: int | None = None) -> bool:
    """Whether K2 takes this pool geometry. The port's own rule, from the
    kernel's limits: head_dim a multiple of 16 (16-byte loads), and a
    split of ``kernels.paged_plan`` (a chunk per block of ``block_size``
    positions) whose shared memory, for a query group of ``num_heads /
    kv_heads`` heads (1 when not given), fits a CTA."""
    group = (num_heads // kv_heads) if num_heads else 1
    return block_size >= 1 and kernels.paged_plan(
        block_size, kv_heads, group, head_dim) is not None


def paged_decode_attention_int8_plain(q, kq, ks, vq, vs, block_tables,
                                      lengths) -> torch.Tensor:
    """K2's function in plain PyTorch: gather each row's blocks through
    its table, dequantize in f32, mask positions at or past the row's
    length (their values are zeroed, so garbage there cannot reach the
    result), f32 softmax of (q * D^-0.5) . k, then p . v in q.dtype."""
    b, h, d = q.shape
    _, bs, hk, _ = kq.shape
    nb = block_tables.shape[1]
    g = h // hk
    bt = block_tables.long()
    valid = (torch.arange(nb * bs, device=q.device)[None, :]
             < lengths.long()[:, None])  # (B, L)
    vmask = valid[:, :, None, None]
    k = (kq[bt].float() * ks[bt].float()[..., None]).reshape(b, nb * bs, hk, d)
    v = (vq[bt].float() * vs[bt].float()[..., None]).reshape(b, nb * bs, hk, d)
    k = torch.where(vmask, k, torch.zeros((), device=q.device))
    v = torch.where(vmask, v, torch.zeros((), device=q.device))
    qg = q.float().reshape(b, hk, g, d) * (d ** -0.5)
    s = torch.einsum("bkgd,blkd->bkgl", qg, k)
    s = s.masked_fill(~valid[:, None, None, :], _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", p, v)
    return out.reshape(b, h, d).to(q.dtype)


def paged_decode_attention_int8(q: torch.Tensor, kq: torch.Tensor,
                                ks: torch.Tensor, vq: torch.Tensor,
                                vs: torch.Tensor, block_tables: torch.Tensor,
                                lengths: torch.Tensor) -> torch.Tensor:
    """Single-position attention over a block-paged quantized cache.

    q: (B, H, D); kq/vq: (N, bs, Hk, D) int8; ks/vs: (N, bs, Hk) f32;
    block_tables: (B, nb) int32, row b's j-th logical block lives in
    physical block block_tables[b, j] (tables may alias blocks across
    rows; they are only read); lengths: (B,) int32, row b attends
    exactly to its positions [0, lengths[b]), each at least 1. Returns
    (B, H, D) in q.dtype: kernel K2 on the card, the plain version on
    the CPU."""
    b, h, d = q.shape
    _, bs, hk, _ = kq.shape
    if not paged_supports(bs, hk, d, h):
        raise ValueError(
            f"KV block (block_size={bs}, kv_heads={hk}, head_dim={d}, "
            f"heads={h}) is outside the kernel's limits; see paged_supports")
    if q.is_cuda:
        return kernels.paged_attention(q, kq, ks, vq, vs, block_tables,
                                       lengths)
    if q.device.type != "cpu":
        raise ValueError(f"paged attention: no kernel for device {q.device}")
    return paged_decode_attention_int8_plain(q, kq, ks, vq, vs, block_tables,
                                             lengths)
