"""Weight-only int8 quantization for serving, the counterpart of
``tpu_bootstrap/workload/quant.py`` (int8 dense half).

Decode at small batch is weight streaming: each step reads every
weight once for a handful of tokens. Block projections and the logits
head are stored as int8 with one f32 scale per output channel, and
``int8_matmul`` runs them through kernel K1 (``csrc/int8_matmul.cu``,
the port of the reference's ``_matmul_kernel``): the int8 weight is read
once at 1 byte per element and widened in registers, the activations
are rounded to bf16 exactly as the reference rounds them, products are
summed in f32 and the channel scale is applied once after the sum.

On a CPU tensor ``int8_matmul`` runs ``int8_matmul_plain``, the same
arithmetic in plain PyTorch; on a CUDA tensor it launches the kernel or
raises. Every launch ticks the reference's byte counters
``quant_<kernel>_{calls,weight_bytes,activation_bytes,bytes}_total``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import kernels


@dataclasses.dataclass
class QuantizedWeight:
    """int8 values + per-output-channel f32 scales in 2-D matmul layout;
    ``shape`` is the original weight's logical shape."""

    q: torch.Tensor  # int8 (K, N)
    s: torch.Tensor  # f32 (N,)
    shape: tuple


def quantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """w: (K, N) float -> int8 with symmetric per-output-channel scales
    over the contraction axis K (bit-equal to the reference's)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=0)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    # A transposed input (the embedding as head) would hand its strides
    # on; the kernel reads row-major (K, N).
    return QuantizedWeight(q=q.contiguous(), s=scale, shape=tuple(w.shape))


def dequantize_weight(qw: QuantizedWeight) -> torch.Tensor:
    return qw.q.float() * qw.s


def is_quantized(w) -> bool:
    return isinstance(w, QuantizedWeight)


def _account(name: str, weight_bytes: int, act_bytes: int,
             out_bytes: int) -> None:
    m = telemetry.metrics()
    m.inc(f"quant_{name}_calls_total")
    m.inc(f"quant_{name}_weight_bytes_total", int(weight_bytes))
    m.inc(f"quant_{name}_activation_bytes_total", int(act_bytes))
    m.inc(f"quant_{name}_bytes_total",
          int(weight_bytes + act_bytes + out_bytes))


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """K1's arithmetic in plain PyTorch: x rounded to bf16, int8 widened
    (both exact in f32), f32 product, scale after the sum, x.dtype out."""
    acc = x.to(torch.bfloat16).float() @ q.float()
    return (acc * s).to(x.dtype)


def int8_matmul(x: torch.Tensor, qw: QuantizedWeight,
                tag: str = "") -> torch.Tensor:
    """x (T, K) @ dequant(qw) (K, N) -> (T, N) in x.dtype: kernel K1 on
    the card, ``int8_matmul_plain`` on the CPU."""
    t, k = x.shape
    if k != qw.q.shape[0]:
        raise ValueError(f"contraction mismatch: x has K={k}, weight has "
                         f"K={qw.q.shape[0]}")
    n = qw.q.shape[1]
    elt = x.element_size()
    _account("int8_matmul" + (f"_{tag}" if tag else ""),
             weight_stream_bytes(qw), t * k * elt, t * n * elt)
    if x.is_cuda:
        return kernels.int8_matmul(x.contiguous(), qw.q, qw.s)
    if x.device.type != "cpu":
        raise ValueError(f"int8_matmul: no kernel for device {x.device}")
    return int8_matmul_plain(x, qw.q, qw.s)


def quantized_matmul(x2: torch.Tensor, w, tag: str = "") -> torch.Tensor:
    """The single dispatch ``decode._linear`` calls for quantized
    weights."""
    if not isinstance(w, QuantizedWeight):
        raise NotImplementedError(
            f"{type(w).__name__} weights are not ported yet (ROADMAP queue "
            "1 item 9: int4 and MoE)")
    return int8_matmul(x2, w, tag=tag)


def weight_stream_bytes(w) -> int:
    """Bytes one launch streams for the weight side: int8 values plus
    f32 scales for a quantized weight, plain bytes for a float one."""
    if is_quantized(w):
        return int(w.q.numel() * w.q.element_size()
                   + w.s.numel() * w.s.element_size())
    return int(w.numel() * w.element_size())


def _nbytes(leaf) -> int:
    if is_quantized(leaf):
        return weight_stream_bytes(leaf)
    return int(leaf.numel() * leaf.element_size())


def decode_stream_bytes(params: dict) -> int:
    """Bytes a decode step streams: the fused wqkv/w_gateup copies
    replace the per-projection reads, the int8 head replaces the float
    embedding (which is only gathered by row)."""
    total = 0
    for b in params["blocks"]:
        leaves = dict(b)
        if "wqkv" in leaves:
            for n2 in ("wq", "wk", "wv"):
                leaves.pop(n2, None)
        if "w_gateup" in leaves:
            for n2 in ("w_gate", "w_up"):
                leaves.pop(n2, None)
        total += sum(_nbytes(v) for v in leaves.values())
    head = params.get("lm_head")
    total += _nbytes(head) if head is not None else _nbytes(params["embed"])
    total += _nbytes(params["final_norm"])
    return int(total)


def _q2d(w: torch.Tensor, contract_rank: int) -> QuantizedWeight:
    """Flatten a projection to (K, N) with the contraction axes first and
    quantize; the logical shape rides along."""
    k = math.prod(w.shape[:contract_rank])
    qw = quantize_weight(w.reshape(k, -1))
    return dataclasses.replace(qw, shape=tuple(w.shape))


def _fuse_n(parts: list, shape: tuple) -> QuantizedWeight:
    """Concatenate along output channels into one launch (exact: scales
    are per channel)."""
    return QuantizedWeight(q=torch.cat([p.q for p in parts], dim=-1),
                           s=torch.cat([p.s for p in parts], dim=-1),
                           shape=shape)


_DENSE_PROJECTIONS = (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 2),
                      ("w_up", 1), ("w_down", 1))


def quantize_block(block: dict) -> dict:
    """Quantize one dense block's projections and add the fused ``wqkv``
    (and, gated, ``w_gateup``) decode copies."""
    if "router" in block:
        raise NotImplementedError(
            "MoE blocks are not ported yet (ROADMAP queue 1 item 9: int4 "
            "and MoE)")
    out = dict(block)
    for name, contract_rank in _DENSE_PROJECTIONS:
        out[name] = _q2d(block[name], contract_rank)
    if "w_gate" in block:
        out["w_gate"] = _q2d(block["w_gate"], 1)
    k = block["wq"].shape[0]
    nq = sum(out[n2].q.shape[-1] for n2 in ("wq", "wk", "wv"))
    out["wqkv"] = _fuse_n([out[n2] for n2 in ("wq", "wk", "wv")], (k, nq))
    if "w_gate" in block:
        f2 = out["w_gate"].q.shape[-1] + out["w_up"].q.shape[-1]
        out["w_gateup"] = _fuse_n([out["w_gate"], out["w_up"]], (k, f2))
    return out


def quantize_params(params: dict, *, head: bool = True) -> dict:
    """Params -> the same tree with dense block projections int8; with
    ``head`` also ``lm_head``, the embedding transposed to (embed, vocab)
    and quantized (the float embedding stays for row gathers)."""
    out = {**params, "blocks": [quantize_block(b) for b in params["blocks"]]}
    if head:
        out["lm_head"] = quantize_weight(params["embed"].T)
    return out
