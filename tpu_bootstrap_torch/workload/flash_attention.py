"""Flash attention on kernels K3 and K4, the counterpart of
``tpu_bootstrap/workload/flash_attention.py``.

The public functions take the reference's layouts: q (batch, seq, heads,
head_dim), k/v (batch, seq, kv_heads, head_dim) with native GQA (query
head h reads KV head h // (heads // kv_heads)), and return the output in
q's layout and dtype plus, from ``flash_attention_with_lse``, the per-row
logsumexp of the scaled scores, (batch, seq, heads) float32.

``_Flash`` is a ``torch.autograd.Function`` over (out, lse), both
differentiable, as the reference's ``custom_vjp`` is: its backward forms
``delta' = rowsum(dO * O) - dlse`` in f32 and runs dq and dk/dv from it, so
an lse consumer (the ring's logaddexp merge) gets the right gradients.

On a CUDA tensor the forward launches ``kernels.flash_fwd`` and the
backward ``kernels.flash_dq`` and ``kernels.flash_dkv``: bf16 inputs run
the tensor-core kernels (``csrc/flash_attention_sm90.cu``, P and dS rounded
to bf16 before their second products), f32 inputs the CUDA-core kernels
(``csrc/flash_attention.cu``, all f32). They raise on what they do not take
and nothing falls back. On a CPU tensor the plain versions below run: dense
masked f32 attention and its hand-written backward, the same arithmetic in
whole-matrix form. The kernels mask the ragged edge themselves, so no
sequence padding is made on either path.

``block_size`` and ``block_k`` are validated exactly as the reference
validates them (same errors, same messages), but they do not change the
tiling: the CUDA kernels choose their own tiles (``kernels.flash_tiles``),
and the plain versions have none. The reference's ``interpret`` switch has no
counterpart.
"""

from __future__ import annotations

import torch

from tpu_bootstrap_torch.workload import kernels

_NEG = -1e30  # finite stand-in for -inf, as in the reference


def _scores(q: torch.Tensor, k: torch.Tensor, sm_scale: float,
            causal: bool) -> torch.Tensor:
    """(b, h, s, s) f32 scores of q (already f32) against k, GQA k repeated
    over its contiguous query group, masked to -1e30."""
    h = q.shape[2]
    k = torch.repeat_interleave(k.float(), h // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q * sm_scale, k)
    if causal:
        n = q.shape[1]
        keep = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG)
    return s


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float, causal: bool) -> tuple:
    """Kernel K3's plain version: (out (b, s, h, d) in q.dtype, lse
    (b, s, h) f32), every operand in f32."""
    qf = q.float()
    s = _scores(qf, k, sm_scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    vf = torch.repeat_interleave(v.float(), q.shape[2] // v.shape[2], dim=2)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype), lse.transpose(1, 2).contiguous()


def _probs_and_ds(q, k, v, dout, lse, delta, sm_scale, causal) -> tuple:
    """p = exp(s - lse) and ds = p * (dO v^T - delta'), (b, h, s, s) f32,
    recomputed by each half of the backward as each kernel does."""
    p = torch.exp(_scores(q.float(), k, sm_scale, causal)
                  - lse.transpose(1, 2)[..., None])
    vf = torch.repeat_interleave(v.float(), q.shape[2] // v.shape[2], dim=2)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vf)
    return p, p * (dp - delta.transpose(1, 2)[..., None])


def attention_dq_plain(q, k, v, dout, lse, delta, sm_scale: float,
                       causal: bool) -> torch.Tensor:
    """The plain version of K4's dq kernel: dq = ds k * sm_scale, from dO,
    lse and delta' = rowsum(dO * O) - dlse ((b, s, h) f32)."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, sm_scale, causal)
    kf = torch.repeat_interleave(k.float(), q.shape[2] // k.shape[2], dim=2)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kf) * sm_scale).to(q.dtype)


def attention_dkv_plain(q, k, v, dout, lse, delta, sm_scale: float,
                        causal: bool) -> tuple:
    """The plain version of K4's dkv kernel: dk = ds^T (q * sm_scale) and
    dv = p^T dO, each summed over its KV head's query group in f32."""
    b, n, h, d = q.shape
    hk = k.shape[2]
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, sm_scale, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float() * sm_scale)
    dk = dk.reshape(b, n, hk, h // hk, d).sum(dim=3)
    dv = dv.reshape(b, n, hk, h // hk, d).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_plain(q, k, v, dout, lse, delta, sm_scale: float,
                        causal: bool) -> tuple:
    """Kernel K4's plain version: (dq, dk, dv)."""
    dq = attention_dq_plain(q, k, v, dout, lse, delta, sm_scale, causal)
    return (dq, *attention_dkv_plain(q, k, v, dout, lse, delta, sm_scale,
                                     causal))


def _fwd(q, k, v, sm_scale, causal):
    if q.is_cuda:
        return kernels.flash_fwd(q, k, v, sm_scale, causal)
    return attention_plain(q, k, v, sm_scale, causal)


def _bwd(q, k, v, dout, lse, delta, sm_scale, causal):
    if q.is_cuda:
        dq = kernels.flash_dq(q, k, v, dout, lse, delta, sm_scale, causal)
        dk, dv = kernels.flash_dkv(q, k, v, dout, lse, delta, sm_scale,
                                   causal)
        return dq, dk, dv
    return attention_bwd_plain(q, k, v, dout, lse, delta, sm_scale, causal)


class _Flash(torch.autograd.Function):
    """(out, lse) with gradients through both outputs."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal):
        out, lse = _fwd(q, k, v, sm_scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale, ctx.causal = sm_scale, causal
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        # d lse_i / d s_ij = p_ij, so the lse cotangent folds into delta.
        delta = (dout.float() * out.float()).sum(dim=-1) - dlse.float()
        dq, dk, dv = _bwd(q, k, v, dout, lse, delta.contiguous(),
                          ctx.sm_scale, ctx.causal)
        return dq, dk, dv, None, None


def _check(q, k, v, block_size: int, block_k: int | None) -> None:
    """The reference's argument checks (``_flash_folded``), same messages."""
    if (q.shape[:2] != k.shape[:2] or q.shape[3:] != k.shape[3:]
            or k.shape != v.shape):
        raise ValueError(f"q/k/v shapes incompatible: {tuple(q.shape)}/"
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    s, h = q.shape[1], q.shape[2]
    kv_h = k.shape[2]
    if h % kv_h != 0:
        raise ValueError(f"kv heads ({kv_h}) must divide q heads ({h})")
    if block_size % 8 != 0:
        raise ValueError(
            f"block_size must be a multiple of 8, got {block_size}")
    if block_k is not None and (block_k < 8 or block_k % 8 != 0):
        raise ValueError(
            f"block_k must be a positive multiple of 8, got {block_k}")
    if block_k is not None:
        bq = min(block_size, -(-s // 8) * 8)
        if block_k > block_size:
            raise ValueError(
                f"block_k ({block_k}) must not exceed block_size "
                f"({block_size})")
        if bq % min(block_k, bq) != 0:
            raise ValueError(
                f"block_k ({block_k}) must divide the effective q block "
                f"({bq}, from block_size={block_size} and seq={s})")


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             sm_scale: float | None = None,
                             block_size: int = 512,
                             block_k: int | None = None) -> tuple:
    """(out (b, s, h, d) in q.dtype, lse (b, s, h) f32), differentiable in
    both. ``sm_scale`` defaults to head_dim ** -0.5."""
    _check(q, k, v, block_size, block_k)
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    return _Flash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                        float(sm_scale), bool(causal))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    block_size: int = 512,
                    block_k: int | None = None) -> torch.Tensor:
    """Flash attention over model-layout tensors; returns q's shape and
    dtype. A drop-in for the ``attn_fn`` hook of ``model._attention``."""
    return flash_attention_with_lse(q, k, v, causal=causal,
                                    sm_scale=sm_scale, block_size=block_size,
                                    block_k=block_k)[0]


def make_flash_attn_fn(*, block_size: int = 512, block_k: int | None = None):
    """An ``attn_fn`` for ``model.forward``/``loss_fn`` backed by K3/K4."""

    def attn_fn(q, k, v):
        return flash_attention(q, k, v, causal=True, block_size=block_size,
                               block_k=block_k)

    return attn_fn


__all__ = ["flash_attention", "flash_attention_with_lse",
           "make_flash_attn_fn", "attention_plain", "attention_dq_plain",
           "attention_dkv_plain", "attention_bwd_plain"]
