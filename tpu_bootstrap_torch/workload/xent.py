"""Chunked cross-entropy head, the counterpart of
``tpu_bootstrap/workload/xent.py``: the LM loss without materializing the
(batch, seq, vocab) logits.

The forward streams vocab chunks: each chunk's logits come from
``model.head_logits`` (operands rounded to x's dtype, products and sums in
f32, the dense head's recipe), fold into a running max and sum, and the
target logit is picked when it falls in the chunk; then the chunk is
dropped. The backward recomputes each chunk's logits and forms
``dlogits = g * (softmax - onehot)`` one chunk at a time, with the
reference's rounding: dlogits is cast to x's dtype before both products,
which accumulate in f32. The reference has no Pallas kernel here; these
are plain torch ops on every device.
"""

from __future__ import annotations

import torch

from tpu_bootstrap_torch.workload.model import head_logits


def _check_chunk(vocab: int, chunk: int) -> None:
    if chunk < 1 or vocab % chunk != 0:
        raise ValueError(
            f"vocab_chunk ({chunk}) must be a positive divisor of the "
            f"vocab size ({vocab})")


class _ChunkedNLL(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, embed, targets, chunk):
        _check_chunk(embed.shape[0], chunk)
        b, s, _ = x.shape
        m = torch.full((b, s), -torch.inf, device=x.device)
        acc = torch.zeros((b, s), device=x.device)
        tgt = torch.full((b, s), -torch.inf, device=x.device)
        for off in range(0, embed.shape[0], chunk):
            logits = head_logits(x, embed[off:off + chunk])
            m_new = torch.maximum(m, logits.amax(dim=-1))
            # exp(-inf - m) == 0 on the first chunk: acc starts empty.
            acc = acc * torch.exp(m - m_new) + torch.exp(
                logits - m_new[..., None]).sum(dim=-1)
            idx = torch.clamp(targets - off, 0, chunk - 1)
            val = torch.gather(logits, -1, idx[..., None])[..., 0]
            tgt = torch.where((targets >= off) & (targets < off + chunk),
                              val, tgt)
            m = m_new
        lse = m + torch.log(acc)
        ctx.save_for_backward(x, embed, targets, lse)
        ctx.chunk = chunk
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        x, embed, targets, lse = ctx.saved_tensors
        chunk = ctx.chunk
        xf = x.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        demb = torch.empty(embed.shape, dtype=torch.float32,
                           device=embed.device)
        cols = torch.arange(chunk, device=x.device)
        for off in range(0, embed.shape[0], chunk):
            emb_c = embed[off:off + chunk]
            probs = torch.exp(head_logits(x, emb_c) - lse[..., None])
            onehot = (targets[..., None] == off + cols).float()
            dlogits = (g[..., None] * (probs - onehot)).to(x.dtype).float()
            dx += torch.einsum("bsv,ve->bse", dlogits,
                               emb_c.to(x.dtype).float())
            demb[off:off + chunk] = torch.einsum("bsv,bse->ve", dlogits, xf)
        return dx.to(x.dtype), demb.to(embed.dtype), None, None


def chunked_nll(x: torch.Tensor, embed: torch.Tensor, targets: torch.Tensor,
                chunk: int) -> torch.Tensor:
    """Per-position negative log-likelihood (B, S) f32 of ``targets`` under
    the tied-embedding head, streamed over vocab chunks. x (B, S, E) in the
    compute dtype, embed (V, E) float master weights with V % chunk == 0,
    targets (B, S) integer."""
    return _ChunkedNLL.apply(x, embed, targets.long(), int(chunk))


def chunked_mean_xent(x: torch.Tensor, embed: torch.Tensor,
                      targets: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean token cross-entropy over all positions."""
    return chunked_nll(x, embed, targets, chunk).mean()


__all__ = ["chunked_nll", "chunked_mean_xent"]
