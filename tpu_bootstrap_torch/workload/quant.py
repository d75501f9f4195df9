"""Weight-only int8/int4 quantization for serving, the counterpart of
``tpu_bootstrap/workload/quant.py``.

Decode at small batch is weight streaming: each step reads every
weight once for a handful of tokens. Block projections and the logits
head are stored as int8 with one f32 scale per output channel, or as
nibble-packed int4 with one f32 scale per (K group, output channel);
MoE blocks store their (E, K, N) expert stacks the same way with one
more leading axis, and keep the router float. Every quantized product
runs through a hand-written CUDA kernel on the card:

* ``int8_matmul`` and ``int8_expert_matmul``: kernel K1 and its expert
  form K1e (``csrc/int8_matmul_sm90.cu``, the port of the reference's
  ``_matmul_kernel``): the activations are rounded to bf16, the int8
  weight is widened exactly, products are summed in f32 and the channel
  scale is applied once after the sum;
* ``int4_matmul`` and ``int4_expert_matmul``: kernel K6 and its expert
  form K6e (``csrc/int4_matmul_sm90.cu``, the port of ``_matmul4_kernel``):
  each nibble is widened, scaled by its group's f32 scale and rounded to
  bf16 BEFORE the product (the reference's order), products are summed
  in f32 and no scale follows the sum.

Both run one tensor-core kernel (``csrc/quant_matmul_sm90.cuh``), its
contraction split by ``kernels.int8_plan`` / ``int4_plan``.

On a CPU tensor each of them runs its plain PyTorch version (the same
arithmetic, ``*_plain``); on a CUDA tensor it launches the kernel or
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


@dataclasses.dataclass
class Quantized4Weight:
    """int4 values nibble-packed two per byte along the contraction axis
    (low nibble = even k, value = nibble - 8), with f32 scales per
    (K group, output channel). Storage is padded to whole groups;
    ``kdim`` is the true contraction extent (0 = the storage extent) and
    ``shape`` the original logical shape."""

    q: torch.Tensor  # uint8 (Ks/2, N) or (E, Ks/2, N)
    s: torch.Tensor  # f32 (Ks/group, N) or (E, Ks/group, N)
    group: int
    shape: tuple
    kdim: int = 0


def _k4(qw: Quantized4Weight) -> int:
    """Logical contraction extent of an int4 weight."""
    return qw.kdim or 2 * qw.q.shape[-2]


def _check_group(group: int) -> None:
    if group < 2 or group % 2 != 0:
        raise ValueError(f"int4 group must be even and >= 2, got {group}")


def _pack4(w: torch.Tensor, group: int) -> tuple:
    """(..., K, N) float -> (packed (..., Kp/2, N) uint8, scales
    (..., Kp/g, N) f32), K zero-padded to whole groups Kp (bit-equal to
    the reference's packing)."""
    _check_group(group)
    *lead, k, n = w.shape
    kp = -(-k // group) * group
    wf = torch.nn.functional.pad(w.float(), (0, 0, 0, kp - k))
    wf = wf.reshape(*lead, kp // group, group, n)
    absmax = wf.abs().amax(dim=-2, keepdim=True)  # (..., Kp/g, 1, N)
    scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int32)
    u = (q.reshape(*lead, kp, n) + 8).to(torch.uint8)  # nibbles in [1, 15]
    packed = u[..., 0::2, :] | (u[..., 1::2, :] << 4)
    return packed.contiguous(), scale[..., 0, :].contiguous()


def quantize_weight4(w: torch.Tensor, group: int = 64) -> Quantized4Weight:
    """w: (K, N) float -> nibble-packed int4 with symmetric per-(group,
    channel) scales; ``group`` even, K anything (a tail group is
    zero-padded in storage, ``kdim`` records the true K)."""
    q, s = _pack4(w, group)
    return Quantized4Weight(q=q, s=s, group=group, shape=tuple(w.shape),
                            kdim=w.shape[0])


def quantize_expert_weight(w: torch.Tensor) -> QuantizedWeight:
    """Expert stack (E, K, N) float -> int8 with per-(expert, output
    channel) scales, stored as s (E, 1, N)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QuantizedWeight(q=q.contiguous(), s=scale, shape=tuple(w.shape))


def quantize_expert_weight4(w: torch.Tensor,
                            group: int = 64) -> Quantized4Weight:
    """Expert stack (E, K, N) float -> nibble-packed int4 with
    per-(expert, K group, output channel) scales, s (E, Kp/g, N)."""
    q, s = _pack4(w, group)
    return Quantized4Weight(q=q, s=s, group=group, shape=tuple(w.shape),
                            kdim=w.shape[1])


def _unpack4(q: torch.Tensor, s: torch.Tensor, group: int,
             kdim: int) -> torch.Tensor:
    """f32 weights (..., kdim, N) from packed nibbles and group scales:
    widen, subtract 8, times the group's scale (one f32 rounding)."""
    lo = (q & 0xF).to(torch.int32) - 8
    hi = (q >> 4).to(torch.int32) - 8
    *lead, k2, n = q.shape
    w = torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * k2, n).float()
    w = w.reshape(*lead, -1, group, n) * s[..., :, None, :]
    return w.reshape(*lead, 2 * k2, n)[..., :kdim, :]


def dequantize_weight4(qw: Quantized4Weight) -> torch.Tensor:
    """f32 reconstruction at the logical K, for the dense (Ks/2, N) and
    the expert (E, Ks/2, N) layouts (bit-equal to the reference's)."""
    return _unpack4(qw.q, qw.s, qw.group, _k4(qw))


def dequantize_any(w) -> torch.Tensor:
    """f32 reconstruction of either quantized format."""
    if isinstance(w, Quantized4Weight):
        return dequantize_weight4(w)
    return dequantize_weight(w)


def is_quantized(w) -> bool:
    return isinstance(w, (QuantizedWeight, Quantized4Weight))


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


def int8_expert_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                             s: torch.Tensor) -> torch.Tensor:
    """K1e's arithmetic: K1's per expert, x (E, T, K), q (E, K, N),
    s (E, 1, N) -> (E, T, N)."""
    return int8_matmul_plain(x, q, s)


def int4_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      group: int, kdim: int) -> torch.Tensor:
    """K6's (and, with a leading E axis, K6e's) arithmetic in plain
    PyTorch: each weight widened, scaled in f32 and rounded to bf16, x
    rounded to bf16, f32 product (exact per term, summed in f32), x.dtype
    out."""
    w = _unpack4(q, s, group, kdim).to(torch.bfloat16).float()
    return (x.to(torch.bfloat16).float() @ w).to(x.dtype)


def int4_expert_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                             s: torch.Tensor, group: int,
                             kdim: int) -> torch.Tensor:
    """K6e's arithmetic: K6's per expert, x (E, T, K) -> (E, T, N)."""
    return int4_matmul_plain(x, q, s, group, kdim)


def _launch(name: str, x: torch.Tensor, qw, tag: str, kernel, plain,
            *meta) -> torch.Tensor:
    """Account one launch under the reference's counter name and run it:
    the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    expert = x.ndim == 3
    e = x.shape[0] if expert else 1
    t, k = x.shape[-2:]
    n = qw.q.shape[-1]
    elt = x.element_size()
    _account(name + (f"_{tag}" if tag else ""), weight_stream_bytes(qw),
             x.numel() * elt, e * t * n * elt)
    if x.is_cuda:
        return kernel(x.contiguous(), qw.q, qw.s, *meta)
    if x.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return plain(x, qw.q, qw.s, *meta)


def _check_dense(x: torch.Tensor, k_weight: int) -> None:
    if x.ndim != 2 or x.shape[1] != k_weight:
        raise ValueError(f"contraction mismatch: x {tuple(x.shape)}, weight "
                         f"has K={k_weight}")


def _check_expert(x: torch.Tensor, e: int, k_weight: int) -> None:
    if x.ndim != 3 or (x.shape[0], x.shape[2]) != (e, k_weight):
        raise ValueError(f"expert/contraction mismatch: x {tuple(x.shape)}, "
                         f"weight has E={e}, K={k_weight}")


def int8_matmul(x: torch.Tensor, qw: QuantizedWeight,
                tag: str = "") -> torch.Tensor:
    """x (T, K) @ dequant(qw) (K, N) -> (T, N) in x.dtype: kernel K1 on
    the card, ``int8_matmul_plain`` on the CPU."""
    _check_dense(x, qw.q.shape[0])
    return _launch("int8_matmul", x, qw, tag, kernels.int8_matmul,
                   int8_matmul_plain)


def int8_expert_matmul(x: torch.Tensor, qw: QuantizedWeight,
                       tag: str = "") -> torch.Tensor:
    """Per-expert x (E, T, K) @ dequant(qw) (E, K, N) -> (E, T, N) in
    x.dtype: kernel K1e on the card, ``int8_expert_matmul_plain`` on the
    CPU."""
    _check_expert(x, qw.q.shape[0], qw.q.shape[1])
    return _launch("int8_expert_matmul", x, qw, tag,
                   kernels.int8_expert_matmul, int8_expert_matmul_plain)


def int4_matmul(x: torch.Tensor, qw: Quantized4Weight,
                tag: str = "") -> torch.Tensor:
    """x (T, K) @ dequant(qw) (K, N) -> (T, N) in x.dtype, the weight
    streamed at half a byte per element: kernel K6 on the card,
    ``int4_matmul_plain`` on the CPU."""
    _check_dense(x, _k4(qw))
    return _launch("int4_matmul", x, qw, tag, kernels.int4_matmul,
                   int4_matmul_plain, qw.group, _k4(qw))


def int4_expert_matmul(x: torch.Tensor, qw: Quantized4Weight,
                       tag: str = "") -> torch.Tensor:
    """Per-expert x (E, T, K) @ dequant(qw) (E, K, N) -> (E, T, N):
    kernel K6e on the card, ``int4_expert_matmul_plain`` on the CPU."""
    _check_expert(x, qw.q.shape[0], _k4(qw))
    return _launch("int4_expert_matmul", x, qw, tag,
                   kernels.int4_expert_matmul, int4_expert_matmul_plain,
                   qw.group, _k4(qw))


def quantized_matmul(x2: torch.Tensor, w, tag: str = "") -> torch.Tensor:
    """The single dispatch ``decode._linear`` calls for quantized
    weights: int8 through K1, int4 through K6."""
    if isinstance(w, Quantized4Weight):
        return int4_matmul(x2, w, tag=tag)
    if isinstance(w, QuantizedWeight):
        return int8_matmul(x2, w, tag=tag)
    raise TypeError(f"quantized_matmul takes a QuantizedWeight or "
                    f"Quantized4Weight, got {type(w).__name__}")


def quantized_expert_matmul(x3: torch.Tensor, w,
                            tag: str = "") -> torch.Tensor:
    """The expert-stack dispatch ``moe._expert_linear`` calls: int8
    stacks through K1e, int4 stacks through K6e."""
    if isinstance(w, Quantized4Weight):
        return int4_expert_matmul(x3, w, tag=tag)
    if isinstance(w, QuantizedWeight):
        return int8_expert_matmul(x3, w, tag=tag)
    raise TypeError(f"quantized_expert_matmul takes a QuantizedWeight or "
                    f"Quantized4Weight, got {type(w).__name__}")


def weight_stream_bytes(w) -> int:
    """Bytes one launch streams for the weight side: packed values plus
    f32 scales for a quantized weight (1 byte per element int8, half a
    byte int4), plain bytes for a float one."""
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


def _q2d(w: torch.Tensor, contract_rank: int,
         quantize=None) -> QuantizedWeight | Quantized4Weight:
    """Flatten a projection to (K, N) with the contraction axes first and
    quantize (``quantize`` picks the format, int8 by default); the
    logical shape rides along."""
    k = math.prod(w.shape[:contract_rank])
    qw = (quantize or quantize_weight)(w.reshape(k, -1))
    return dataclasses.replace(qw, shape=tuple(w.shape))


def _fuse_n(parts: list, shape: tuple):
    """Concatenate along output channels into one launch (exact for both
    formats: scales are per channel, or per (group, channel)). int4 parts
    must share K and group."""
    first = parts[0]
    if isinstance(first, Quantized4Weight) and any(
            p.group != first.group or _k4(p) != _k4(first) for p in parts[1:]):
        raise ValueError("fused int4 parts must share K and group")
    q = torch.cat([p.q for p in parts], dim=-1)
    s = torch.cat([p.s for p in parts], dim=-1)
    if isinstance(first, Quantized4Weight):
        return Quantized4Weight(q=q, s=s, group=first.group, shape=shape,
                                kdim=_k4(first))
    return QuantizedWeight(q=q, s=s, shape=shape)


_DENSE_PROJECTIONS = (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 2),
                      ("w_up", 1), ("w_down", 1))


def _quantize_block_common(block: dict, q2d, expert_quantize) -> dict:
    """The block skeleton both formats share. MoE blocks: wq/wk/wv/wo
    through ``q2d`` (no fused copy), the expert stacks through the
    format's expert quantizer, the router float. Dense blocks: every
    projection through ``q2d`` plus the fused ``wqkv`` (and, gated,
    ``w_gateup``) decode copies."""
    out = dict(block)
    if "router" in block:
        for name in ("wq", "wk", "wv"):
            out[name] = q2d(block[name], 1)
        out["wo"] = q2d(block["wo"], 2)
        out["w_up"] = expert_quantize(block["w_up"])
        out["w_down"] = expert_quantize(block["w_down"])
        return out
    for name, contract_rank in _DENSE_PROJECTIONS:
        out[name] = q2d(block[name], contract_rank)
    if "w_gate" in block:
        out["w_gate"] = q2d(block["w_gate"], 1)
    k = block["wq"].shape[0]
    nq = sum(out[n2].q.shape[-1] for n2 in ("wq", "wk", "wv"))
    out["wqkv"] = _fuse_n([out[n2] for n2 in ("wq", "wk", "wv")], (k, nq))
    if "w_gate" in block:
        f2 = out["w_gate"].q.shape[-1] + out["w_up"].q.shape[-1]
        out["w_gateup"] = _fuse_n([out["w_gate"], out["w_up"]], (k, f2))
    return out


def quantize_block(block: dict) -> dict:
    """int8: one block's projections (and a MoE block's expert stacks)."""
    return _quantize_block_common(block, _q2d, quantize_expert_weight)


def quantize_block4(block: dict, group: int = 64) -> dict:
    """int4 counterpart of ``quantize_block``: the same structure and
    fused copies, group-wise scales."""
    def q4(w):
        return quantize_weight4(w, group=group)

    return _quantize_block_common(
        block, lambda w, rank: _q2d(w, rank, quantize=q4),
        lambda w: quantize_expert_weight4(w, group=group))


def quantize_params(params: dict, *, head: bool = True) -> dict:
    """Params -> the same tree with block projections int8; with
    ``head`` also ``lm_head``, the embedding transposed to (embed, vocab)
    and quantized (the float embedding stays for row gathers)."""
    out = {**params, "blocks": [quantize_block(b) for b in params["blocks"]]}
    if head:
        out["lm_head"] = quantize_weight(params["embed"].T)
    return out


def quantize_params4(params: dict, *, group: int = 64,
                     head: str | bool = "int8") -> dict:
    """Params -> block projections int4. ``head`` picks the logits head:
    "int8" (default) the int8 copy, "int4" an int4 copy, False the float
    embedding. ``head`` is checked before any packing; booleans are
    matched by type, since ``1 in (True,)`` holds and would let the
    integer typos 1 and 0 through."""
    if not (head in ("int8", "int4") or isinstance(head, bool)):
        raise ValueError(f"head must be 'int8', 'int4', or False, got {head!r}")
    out = {**params, "blocks": [quantize_block4(b, group)
                                for b in params["blocks"]]}
    if head == "int4":
        out["lm_head"] = quantize_weight4(params["embed"].T, group=group)
    elif head == "int8" or head is True:
        out["lm_head"] = quantize_weight(params["embed"].T)
    return out
