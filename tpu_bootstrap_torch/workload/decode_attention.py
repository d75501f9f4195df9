"""Single-query attention over the block-paged int8 KV pool, the
counterpart of ``tpu_bootstrap/workload/decode_attention.py`` (paged
half).

A decode step's attention reads every cached vector of the row to score
one query, so it streams the cache. ``paged_decode_attention_int8`` runs
kernel K2 (``csrc/paged_attention.cu``, the port of the reference's
``_paged_kernel``) on the card: each row reads only its own blocks
through its block table, dequantizes them in registers and keeps an
online softmax in f32. On a CPU tensor it runs
``paged_decode_attention_int8_plain``, the same function in plain
PyTorch; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from tpu_bootstrap_torch.workload import kernels

_NEG = -1e30


def paged_supports(block_size: int, kv_heads: int, head_dim: int,
                   num_heads: int | None = None) -> bool:
    """Whether K2 takes this pool geometry. The port's own rule, from the
    kernel's limits: head_dim a multiple of 16 (16-byte loads), and the
    kernel's shared memory for one block of ``block_size`` positions and
    a query group of ``num_heads / kv_heads`` heads (1 when not given)
    within 48 KB."""
    group = (num_heads // kv_heads) if num_heads else 1
    return (block_size >= 1 and head_dim % 16 == 0
            and kernels.paged_attention_smem_bytes(block_size, head_dim, group)
            <= kernels.PAGED_SMEM_LIMIT)


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
