"""A configuration's weights, made from the run's seed on the device.

One ``torch.Generator`` on the device draws the embedding in one call and
then each block in one call (a flat float32 buffer cut into the block's
leaves): the embedding N(0, 0.02^2), every projection and router
N(0, 1/fan_in), norms 1. The leaves carry the port's names and layouts
(``wq`` (embed, heads, head_dim), ``wo`` (heads, head_dim, embed), expert
stacks (experts, in, out)). The program and the reference both take these
float32 weights; whatever either derives from them (int8 copies, scales)
each works out for itself.
"""

from __future__ import annotations

import math

from portbench.generator import _SEED_MASK


def block_layout(p: dict) -> list:
    """(name, shape, fan_in) of one block's random leaves, in draw order,
    for the configuration's ``port`` sizes."""
    e, h, d = p["embed_dim"], p["num_heads"], p["head_dim"]
    hk, f = p["num_kv_heads"], p["mlp_dim"]
    out = [("wq", (e, h, d), e), ("wk", (e, hk, d), e),
           ("wv", (e, hk, d), e), ("wo", (h, d, e), h * d)]
    if p.get("num_experts", 0) > 0:
        n = p["num_experts"]
        out += [("router", (e, n), e), ("w_up", (n, e, f), e),
                ("w_down", (n, f, e), f)]
    else:
        if p.get("mlp_gated"):
            out.append(("w_gate", (e, f), e))
        out += [("w_up", (e, f), e), ("w_down", (f, e), f)]
    return out


class Weights:
    """Draws a configuration's weights in order: ``embed()`` first, then
    ``block()`` once per layer. ``final_norm`` and each block's norms are
    ones."""

    def __init__(self, torch, p: dict, seed: int, device):
        self.torch, self.p, self.device = torch, p, device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed & _SEED_MASK)
        self.layout = block_layout(p)

    def embed(self):
        t = self.torch
        e = t.randn((self.p["vocab_size"], self.p["embed_dim"]),
                    generator=self.gen, device=self.device,
                    dtype=t.float32)
        return e.mul_(0.02)

    def ones(self):
        return self.torch.ones(self.p["embed_dim"], device=self.device)

    def block(self) -> dict:
        t = self.torch
        total = sum(math.prod(shape) for _, shape, _ in self.layout)
        flat = t.randn(total, generator=self.gen, device=self.device,
                       dtype=t.float32)
        out, off = {"attn_norm": self.ones()}, 0
        for name, shape, fan_in in self.layout:
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape).mul_(
                1.0 / math.sqrt(fan_in))
            off += n
            if name == "wo":
                out["mlp_norm"] = self.ones()
        return out


def float_params(torch, p: dict, seed: int, device) -> dict:
    """The whole float32 tree, as training holds it (each leaf its own
    storage)."""
    w = Weights(torch, p, seed, device)
    params = {"embed": w.embed(), "final_norm": w.ones(), "blocks": []}
    for _ in range(p["num_layers"]):
        params["blocks"].append({k: v.clone() for k, v in w.block().items()})
    return params


def serve_params(torch, quant, p: dict, seed: int, device) -> dict:
    """The serving tree: each block drawn in float32 and quantized to int8
    by the program's ``quant.quantize_block`` before the next is drawn; the
    head by ``quant.quantize_params`` (the int8 copy of the embedding,
    beside the float embedding that decode gathers rows from)."""
    w = Weights(torch, p, seed, device)
    base = {"embed": w.embed(), "final_norm": w.ones(), "blocks": []}
    params = quant.quantize_params(base)
    for _ in range(p["num_layers"]):
        block = quant.quantize_block(w.block())
        # A float leaf left a view (the router) would keep the whole drawn
        # block alive.
        params["blocks"].append({k: v.clone() if torch.is_tensor(v)
                                 and v._base is not None else v
                                 for k, v in block.items()})
    return params
