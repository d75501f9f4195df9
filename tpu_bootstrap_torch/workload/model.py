"""Decoder-only transformer LM in PyTorch, the counterpart of
``tpu_bootstrap/workload/model.py``.

Params are a plain nested dict (``embed``, ``final_norm``, ``blocks``)
with the reference's key names and layouts: ``wq``/``wk``/``wv`` are
``(embed, heads, head_dim)``, ``wo`` is ``(heads, head_dim, embed)``,
activations are ``(batch, seq, heads, head_dim)``. The numerics follow
the reference op for op where the two frameworks differ by default:
tanh-approximated gelu, interleaved-pair rotary with f32 angles,
``rsqrt`` cast to the activation dtype before the multiply, f32 softmax
cast back before the value product.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from tpu_bootstrap_torch.workload.moe import moe_mlp

Params = dict[str, Any]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without CUDA the caller must ask for the
    CPU explicitly: nothing silently runs on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the host")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 256
    num_layers: int = 2
    num_heads: int = 4
    head_dim: int = 16
    embed_dim: int = 64
    mlp_dim: int = 256
    max_seq_len: int = 128
    compute_dtype: Any = torch.float32
    num_kv_heads: int | None = None
    num_experts: int = 0
    expert_top_k: int = 2
    expert_capacity_factor: float = 2.0
    moe_aux_coef: float = 0.01
    vocab_chunk: int = 0
    mlp_gated: bool = False

    @property
    def qkv_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_heads(self) -> int:
        kv = self.num_kv_heads if self.num_kv_heads is not None else self.num_heads
        if not 1 <= kv <= self.num_heads or self.num_heads % kv != 0:
            raise ValueError(
                f"num_kv_heads ({kv}) must divide num_heads ({self.num_heads})")
        return kv


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Float32 params drawn from a seeded ``torch.Generator`` on
    ``device``: the reference's shapes and scales (normal / sqrt(fan_in),
    embed * 0.02), not its numbers. Tests carry the reference's own
    params over with ``bridge.params_from_numpy`` instead. MoE configs
    (``num_experts > 0``) get a float ``router`` (embed, E) and expert
    stacks ``w_up`` (E, embed, mlp), ``w_down`` (E, mlp, embed) in place
    of the dense FFN."""
    if cfg.mlp_gated and cfg.num_experts > 0:
        raise ValueError("mlp_gated applies to the dense FFN only "
                         "(MoE experts keep the ungated two-matmul FFN)")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)

    def dense(shape, fan_in):
        return normal(shape) / math.sqrt(fan_in)

    e = cfg.embed_dim
    params: Params = {
        "embed": normal((cfg.vocab_size, e)) * 0.02,
        "final_norm": torch.ones(e, device=device),
        "blocks": [],
    }
    for _ in range(cfg.num_layers):
        block = {
            "attn_norm": torch.ones(e, device=device),
            "wq": dense((e, cfg.num_heads, cfg.head_dim), e),
            "wk": dense((e, cfg.kv_heads, cfg.head_dim), e),
            "wv": dense((e, cfg.kv_heads, cfg.head_dim), e),
            "wo": dense((cfg.num_heads, cfg.head_dim, e), cfg.qkv_dim),
            "mlp_norm": torch.ones(e, device=device),
        }
        if cfg.num_experts > 0:
            n_exp = cfg.num_experts
            block["router"] = dense((e, n_exp), e)
            block["w_up"] = dense((n_exp, e, cfg.mlp_dim), e)
            block["w_down"] = dense((n_exp, cfg.mlp_dim, e), cfg.mlp_dim)
        else:
            if cfg.mlp_gated:
                block["w_gate"] = dense((e, cfg.mlp_dim), e)
            block["w_up"] = dense((e, cfg.mlp_dim), e)
            block["w_down"] = dense((cfg.mlp_dim, e), cfg.mlp_dim)
        params["blocks"].append(block)
    return params


def flops_model(cfg: ModelConfig) -> dict:
    """One token's forward FLOPs by kind, the reference's price list
    (matmul terms, 2 FLOPs per MAC, attention at half the window)."""
    e, h, d, hk = cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.kv_heads
    proj = 2 * e * (h * d) + 2 * e * (2 * hk * d) + 2 * (h * d) * e
    ctx = max(1, cfg.max_seq_len // 2)
    attn = 2 * 2 * h * d * ctx
    if cfg.num_experts > 0:
        mlp = cfg.expert_top_k * 2 * 2 * e * cfg.mlp_dim
        mlp += 2 * e * cfg.num_experts
    else:
        mats = 3 if cfg.mlp_gated else 2
        mlp = mats * 2 * e * cfg.mlp_dim
    layer = proj + attn + mlp
    body = cfg.num_layers * layer
    head = 2 * e * cfg.vocab_size
    per_layer_params = (proj + (mlp if cfg.num_experts == 0
                                else mlp - 2 * e * cfg.num_experts)) // 2
    params = cfg.num_layers * per_layer_params + e * cfg.vocab_size
    return {
        "prefill": float(body),
        "decode": float(body + head),
        "verify": float(body + head),
        "train": 3.0 * (body + head),
        "params": float(params),
    }


def kv_bytes_per_token(cfg: ModelConfig, kv_quant: bool = False) -> int:
    """KV bytes one token position occupies across every layer."""
    per_pos = cfg.kv_heads * cfg.head_dim
    if kv_quant:
        per_layer = 2 * (per_pos + 4 * cfg.kv_heads)
    else:
        itemsize = torch.empty((), dtype=cfg.compute_dtype).element_size()
        per_layer = 2 * per_pos * itemsize
    return cfg.num_layers * per_layer


def _rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale.to(x.dtype)


def _rotary(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary embedding on (..., seq, heads, head_dim), rotating
    interleaved pairs (even, odd) as the reference does."""
    head_dim = x.shape[-1]
    freqs = torch.exp(
        -math.log(10000.0)
        * torch.arange(0, head_dim, 2, dtype=torch.float32, device=x.device)
        / head_dim)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :].to(x.dtype)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    x1, x2 = x[..., ::2], x[..., 1::2]
    rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.reshape(x.shape)


def repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(..., kv_heads, d) -> (..., num_heads, d), each KV head repeated
    over its contiguous query group."""
    kv_heads = k.shape[-2]
    if kv_heads == num_heads:
        return k
    if num_heads % kv_heads != 0:
        raise ValueError(f"kv heads ({kv_heads}) must divide q heads ({num_heads})")
    return torch.repeat_interleave(k, num_heads // kv_heads, dim=-2)


def dense_attn_core(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention on (batch, seq, heads, head_dim)."""
    num_heads, head_dim, seq = q.shape[-2], q.shape[-1], q.shape[1]
    dtype = q.dtype
    k = repeat_kv(k, num_heads)
    v = repeat_kv(v, num_heads)
    scale = torch.sqrt(torch.tensor(head_dim, dtype=torch.float32)).to(dtype)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / scale.to(q.device)
    causal = torch.tril(torch.ones(seq, seq, dtype=torch.bool,
                                   device=q.device))
    scores = scores.masked_fill(~causal, -1e30)
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _attention(block: Params, x: torch.Tensor, cfg: ModelConfig,
               attn_fn=None,
               positions: torch.Tensor | None = None) -> torch.Tensor:
    """Causal attention of x (batch, seq, embed). ``attn_fn(q, k, v)``
    (q (batch, seq, heads, head_dim), k/v with kv_heads) replaces the
    attention core when given: the hook the flash kernels plug into."""
    dtype = cfg.compute_dtype
    seq = x.shape[1]
    if positions is None:
        positions = torch.arange(seq, device=x.device)
    h = _rms_norm(x, block["attn_norm"])
    q = torch.einsum("bse,ehd->bshd", h, block["wq"].to(dtype))
    k = torch.einsum("bse,ehd->bshd", h, block["wk"].to(dtype))
    v = torch.einsum("bse,ehd->bshd", h, block["wv"].to(dtype))
    q = _rotary(q, positions)
    k = _rotary(k, positions)
    out = (attn_fn or dense_attn_core)(q, k, v)
    return torch.einsum("bshd,hde->bse", out, block["wo"].to(dtype))


def _default_linear(x: torch.Tensor, w, contract_rank: int, dtype,
                    tag: str = "") -> torch.Tensor:
    """Plain projection of x's trailing dims against w's leading dims."""
    k = math.prod(w.shape[:contract_rank])
    y = x.reshape(-1, k).to(dtype) @ w.to(dtype).reshape(k, -1)
    return y.reshape(*x.shape[: x.ndim - contract_rank],
                     *w.shape[contract_rank:])


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    return F.gelu(x, approximate="tanh")


def _mlp(block: Params, x: torch.Tensor, cfg: ModelConfig,
         linear=_default_linear) -> torch.Tensor:
    """Dense FFN; ``linear`` is the seam decode routes through int8
    weights. Gated blocks compute gelu(gate) * up, from the fused
    ``w_gateup`` launch when the tree carries one."""
    dtype = cfg.compute_dtype
    h = _rms_norm(x, block["mlp_norm"])
    if "w_gate" in block:
        fused = block.get("w_gateup")
        if fused is not None:
            gu = linear(h, fused, 1, dtype, tag="gateup")
            f = gu.shape[-1] // 2
            g, u = gu[..., :f], gu[..., f:]
        else:
            g = linear(h, block["w_gate"], 1, dtype)
            u = linear(h, block["w_up"], 1, dtype)
        h = _gelu(g) * u
    else:
        h = _gelu(linear(h, block["w_up"], 1, dtype))
    return linear(h, block["w_down"], 1, dtype)


def hidden_with_aux(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                    attn_fn=None) -> tuple:
    """tokens (batch, seq) -> (final-normed hidden states (batch, seq,
    embed), aux): the model up to the head. ``aux`` is the mean MoE
    load-balancing loss over blocks, 0 for the dense model."""
    x = params["embed"][tokens].to(cfg.compute_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in params["blocks"]:
        x = x + _attention(block, x, cfg, attn_fn)
        if cfg.num_experts > 0:
            out, aux_b = moe_mlp(block, _rms_norm(x, block["mlp_norm"]), cfg)
            x = x + out
            aux = aux + aux_b / len(params["blocks"])
        else:
            x = x + _mlp(block, x, cfg)
    return _rms_norm(x, params["final_norm"]), aux


def hidden(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
           attn_fn=None) -> torch.Tensor:
    """tokens (batch, seq) -> final-normed hidden states (batch, seq,
    embed)."""
    return hidden_with_aux(params, tokens, cfg, attn_fn)[0]


def head_logits(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Tied-embedding head: operands rounded to x's dtype, products and
    sums in f32 (the reference's preferred_element_type=f32)."""
    w = embed.to(x.dtype).float()
    return torch.einsum("bse,ve->bsv", x.float(), w)


def forward_with_aux(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                     attn_fn=None) -> tuple:
    """tokens (batch, seq) -> (logits (batch, seq, vocab) f32, aux)."""
    x, aux = hidden_with_aux(params, tokens, cfg, attn_fn)
    return head_logits(x, params["embed"]), aux


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            attn_fn=None) -> torch.Tensor:
    """tokens (batch, seq) -> logits (batch, seq, vocab) in f32."""
    return forward_with_aux(params, tokens, cfg, attn_fn)[0]


def loss_from_inputs(params: Params, inputs: torch.Tensor,
                     targets: torch.Tensor, cfg: ModelConfig,
                     attn_fn=None) -> torch.Tensor:
    """Mean cross-entropy of ``targets`` under the model run on
    ``inputs``, plus ``moe_aux_coef`` times the MoE aux loss when the
    model has experts. ``cfg.vocab_chunk > 0`` streams the head over vocab
    chunks (``xent.py``) without materializing the (batch, seq, vocab)
    logits."""
    if cfg.vocab_chunk > 0:
        from tpu_bootstrap_torch.workload.xent import chunked_mean_xent

        x, aux = hidden_with_aux(params, inputs, cfg, attn_fn)
        loss = chunked_mean_xent(x, params["embed"], targets, cfg.vocab_chunk)
    else:
        logits, aux = forward_with_aux(params, inputs, cfg, attn_fn)
        logprobs = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logprobs, -1, targets[..., None].long())[..., 0]
        loss = nll.mean()
    if cfg.num_experts > 0:
        loss = loss + cfg.moe_aux_coef * aux
    return loss


def loss_fn(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            attn_fn=None) -> torch.Tensor:
    """Next-token cross-entropy averaged over all positions."""
    return loss_from_inputs(params, tokens[:, :-1], tokens[:, 1:], cfg,
                            attn_fn)
