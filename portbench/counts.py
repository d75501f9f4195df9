"""Operations and bytes of the work a slice did, from the configuration's
shapes and the slice's tokens and contexts alone (never from a kernel's
launch arguments), so a roofline reads the same work whatever computes
it. Shared by the per-layer readers in ``metrics/``.

Conventions: 2 operations a multiply-add; weights int8 with one float32
scale per output channel; activations bf16 (the head's output float32);
KV int8 with one float32 scale per vector; every input byte read once and
every output byte written once.
"""

from __future__ import annotations

from portbench.common import PEAK_BYTES, PEAK_FLOPS

# The port's kernels, by fragments of their demangled names.
K1 = ("quant_matmul_sm90_kernel<8, ", ", false, ")
K2 = ("paged_attention_kernel",)
K3 = ("flash_fwd_sm90_kernel",)
K4 = (("flash_dq_sm90_kernel",), ("flash_dkv_sm90_kernel",))


def least(ops: float, nbytes: float) -> float:
    """Seconds the card needs at least: the larger of the two bounds."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def moe(p: dict) -> bool:
    return p.get("num_experts", 0) > 0


def attn_projections(p: dict) -> list:
    """(K, N) of one layer's attention projections."""
    e, h, hk, d = p["embed_dim"], p["num_heads"], p["num_kv_heads"], p["head_dim"]
    return [(e, h * d), (e, hk * d), (e, hk * d), (h * d, e)]


def mlp_projections(p: dict) -> list:
    """(K, N) of one layer's dense FFN (none for a MoE layer)."""
    if moe(p):
        return []
    e, f = p["embed_dim"], p["mlp_dim"]
    return ([(e, f)] if p.get("mlp_gated") else []) + [(e, f), (f, e)]


def expert_projections(p: dict) -> list:
    """(K, N) of one expert's two matrices."""
    return [(p["embed_dim"], p["mlp_dim"]), (p["mlp_dim"], p["embed_dim"])]


def head(p: dict) -> tuple:
    return (p["embed_dim"], p["vocab_size"])


def k1_shapes(p: dict, with_head: bool) -> list:
    """Every projection K1 computes for one token, all layers."""
    out = (attn_projections(p) + mlp_projections(p)) * p["num_layers"]
    return out + ([head(p)] if with_head else [])


def int8_bytes(shapes: list) -> int:
    return sum(k * n + 4 * n for k, n in shapes)


def matmul_ops(shapes: list, tokens: int) -> float:
    return 2.0 * tokens * sum(k * n for k, n in shapes)


def act_bytes(shapes: list, tokens: int, head_out: bool) -> float:
    """bf16 inputs and outputs of the projections (the head's out f32)."""
    b = sum(2 * k + 2 * n for k, n in shapes) * tokens
    if head_out:
        b += 2 * shapes[-1][1] * tokens
    return b


def token_flops(p: dict, with_head: bool) -> float:
    """Matmul FLOPs of one token's forward, without attention's scores."""
    per_layer = sum(k * n for k, n in attn_projections(p) + mlp_projections(p))
    if moe(p):
        per_layer += p["expert_top_k"] * sum(
            k * n for k, n in expert_projections(p))
        per_layer += p["embed_dim"] * p["num_experts"]  # router
    flops = 2.0 * per_layer * p["num_layers"]
    if with_head:
        flops += 2.0 * p["embed_dim"] * p["vocab_size"]
    return flops


def attn_flops(p: dict, ctx: int) -> float:
    """Scores and values of one query over ``ctx`` positions, all layers."""
    return 4.0 * p["num_heads"] * p["head_dim"] * ctx * p["num_layers"]


def kv_bytes_per_pos(p: dict) -> int:
    """int8 K and V and their float32 scales of one position, all layers."""
    return p["num_layers"] * 2 * p["num_kv_heads"] * (p["head_dim"] + 4)


def train_param_count(p: dict) -> float:
    """Parameters a training token multiplies by (the head counted once)."""
    return token_flops(p, with_head=True) / 2.0
