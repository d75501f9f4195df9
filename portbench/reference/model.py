"""The plain reference of both configurations, in float32 PyTorch with
TF32 off. It imports nothing of the program: it takes the float32
weights the benchmark draws from the seed (``portbench.weights``) and
works out again whatever the program derives from them.

Serving (``serve_logits``): the configuration as the port serves it,
departures included: pre-norm blocks, interleaved rotary at base 10000,
int8 weights with one float32 scale per output channel (expert stacks per
expert and channel, the router float), keys and values rounded to int8
with one scale per vector before attention reads them, causal softmax
attention, the gated gelu MLP or the top-k MoE (softmax router, top k by
a stable sort, gates renormalized, no token dropped), the tied head on
the int8 copy of the embedding. It runs layer by layer over every
sequence it is given, drawing each block's weights as it reaches it.

Training (``train_steps``): the float32 model on float32 weights (no
quantization), the mean next-token cross-entropy over the full
vocabulary, autograd gradients, one block at a time recomputed in the
backward (``torch.utils.checkpoint``), and AdamW as the port configures
it: clip by global norm, b1 0.9, b2 0.999, eps 1e-8 outside the root,
decoupled weight decay on every leaf, a constant learning rate.

``act`` rounds every matmul's activation operand (and, in training,
``wround`` every weight operand): None keeps float32; ``fp8_rows`` is the
control, float8 e4m3 with one scale per row (per output channel for a
weight).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.weights import Weights

F8_MAX = 448.0


def strict_float32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per row (its last axis),
    back in float32; the gradient passes straight through."""
    s = x.detach().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / F8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


def fp8_cols(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) weight rounded to e4m3 with one scale per output column."""
    return fp8_rows(w.transpose(-1, -2)).transpose(-1, -2)


def _same(x):
    return x


# ---- what the program derives, worked out again ---------------------------

def int8_cols(w: torch.Tensor) -> torch.Tensor:
    """(..., K, N) -> its int8 reconstruction, one scale per output column
    (per leading index too): absmax over K / 127, round half to even."""
    absmax = w.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    return torch.clamp(torch.round(w / scale), -127, 127) * scale


def int8_vectors(x: torch.Tensor) -> torch.Tensor:
    """Keys or values rounded to int8 with one scale per vector (the last
    axis): absmax / 127, floored at 1e-8."""
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    return torch.round(x / scale) * scale


# ---- the shared layer equations -------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def rotary(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Interleaved pairs (even, odd) of x (seq, heads, head_dim) rotated by
    position * 10000^(-2i/head_dim)."""
    d = x.shape[-1]
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def causal_attention(q, k, v):
    """q (S, H, D), k/v (S, Hk, D): causal softmax attention in float32."""
    s, h, d = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v)


def _mm(x, w, act, wround=_same):
    """x (..., K) @ w (K, N) with the operands rounded as asked."""
    return act(x) @ wround(w)


def attention_half(b: dict, x, positions, act, wround=_same,
                   kv_int8: bool = False):
    """x + the attention sublayer of block ``b`` over x (S, E)."""
    e = x.shape[-1]
    wq, wk, wv, wo = b["wq"], b["wk"], b["wv"], b["wo"]
    h, d = wq.shape[1], wq.shape[2]
    hk = wk.shape[1]
    n = rms_norm(x, b["attn_norm"])
    q = _mm(n, wq.reshape(e, h * d), act, wround).reshape(-1, h, d)
    k = _mm(n, wk.reshape(e, hk * d), act, wround).reshape(-1, hk, d)
    v = _mm(n, wv.reshape(e, hk * d), act, wround).reshape(-1, hk, d)
    q, k = rotary(q, positions), rotary(k, positions)
    if kv_int8:
        k, v = int8_vectors(k), int8_vectors(v)
    out = causal_attention(q, k, v).reshape(-1, h * d)
    return x + _mm(out, wo.reshape(h * d, e), act, wround)


def dense_mlp_half(b: dict, x, act, wround=_same):
    n = rms_norm(x, b["mlp_norm"])
    if "w_gate" in b:
        m = gelu(_mm(n, b["w_gate"], act, wround)) * _mm(n, b["w_up"], act,
                                                        wround)
    else:
        m = gelu(_mm(n, b["w_up"], act, wround))
    return x + _mm(m, b["w_down"], act, wround)


def capacity_keep(idx: torch.Tensor, n_exp: int, segments: list,
                  factor: float) -> torch.Tensor:
    """Which (token, choice) assignments an expert has a slot for. Each
    segment (start, length) of the sequence is routed on its own, as the
    program routes one prefill chunk or one decode token: an expert has
    ceil(length * k / n * factor) slots, handed out to all first choices in
    sequence order, then all second choices, and so on. Positions outside
    every segment keep all their assignments."""
    s, k = idx.shape
    keep = torch.ones(s, k, dtype=torch.bool, device=idx.device)
    for start, length in segments:
        if length == 1:
            continue  # a token's k experts differ: one slot each suffices
        cap = max(1, math.ceil(length * k / n_exp * factor))
        seg = idx[start:start + length]
        order = F.one_hot(seg.t().reshape(-1), n_exp)  # choice-major
        pos = torch.cumsum(order, dim=0).gather(
            1, seg.t().reshape(-1, 1))[:, 0] - 1
        keep[start:start + length] = (pos < cap).reshape(k, length).t()
    return keep


def moe_half(b: dict, x, top_k: int, act, wround=_same, segments=None,
             factor: float = 0.0):
    """x + the top-k MoE FFN: each token's k experts by a stable descending
    sort of its float32 softmax gates, the gates renormalized; with
    ``segments`` an assignment past its expert's capacity in its segment
    (``capacity_keep``) is dropped (its token rides the residual for that
    expert), else every routed token is computed."""
    n = rms_norm(x, b["mlp_norm"])
    gates = torch.softmax(n @ b["router"], dim=-1)
    g, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    g, idx = g[:, :top_k], idx[:, :top_k]
    g = g / g.sum(dim=-1, keepdim=True)
    if segments is not None:
        g = g * capacity_keep(idx, b["router"].shape[1], segments, factor)
    out = torch.zeros_like(x)
    for e in range(b["router"].shape[1]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = gelu(_mm(n[rows], b["w_up"][e], act, wround))
        y = _mm(y, b["w_down"][e], act, wround)
        out = out.index_add(0, rows, y * g[rows, slot][:, None])
    return x + out


def block_forward(b: dict, x, positions, p: dict, act, wround=_same,
                  kv_int8: bool = False, segments=None):
    x = attention_half(b, x, positions, act, wround, kv_int8)
    if p.get("num_experts", 0) > 0:
        return moe_half(b, x, p["expert_top_k"], act, wround, segments,
                        p.get("expert_capacity_factor", 0.0))
    return dense_mlp_half(b, x, act, wround)


# ---- serving --------------------------------------------------------------

def int8_block(b: dict) -> dict:
    """A block with every projection replaced by its int8 reconstruction,
    as the program quantizes it (the router stays float)."""
    out = dict(b)
    for name in ("wq", "wk", "wv"):
        out[name] = int8_cols(b[name].reshape(b[name].shape[0], -1)).reshape(
            b[name].shape)
    out["wo"] = int8_cols(b["wo"].reshape(-1, b["wo"].shape[-1])).reshape(
        b["wo"].shape)
    for name in ("w_gate", "w_up", "w_down"):
        if name in b:
            out[name] = int8_cols(b[name])
    return out


@torch.no_grad()
def serve_logits(p: dict, seed: int, device, seqs: list, spans: list,
                 act=None, segments=None) -> list:
    """Reference logits of each sequence (1-D token tensors) at the
    positions ``spans[i]`` = (start, stop): the float32 forward of the
    served configuration, layer by layer over all sequences. A MoE layer
    routes each of ``segments[i]`` (start, length) on its own with the
    configuration's expert capacity (the served prompt's prefill chunks,
    and each token after them alone, as decode routes it); None routes the
    whole sequence with no capacity. Returns one (stop - start, vocab)
    float32 tensor per sequence."""
    strict_float32()
    act = act or _same
    w = Weights(torch, p, seed, device)
    embed = w.embed()
    xs = [embed[s.to(device)] for s in seqs]
    pos = [torch.arange(s.numel(), device=device) for s in seqs]
    for _ in range(p["num_layers"]):
        b = int8_block(w.block())
        xs = [block_forward(b, x, ps, p, act, kv_int8=True,
                            segments=None if segments is None else sg)
              for x, ps, sg in zip(xs, pos, segments or [None] * len(xs))]
        del b
    head = int8_cols(embed.t().contiguous())
    ones = torch.ones(embed.shape[1], device=device)
    return [act(rms_norm(x[a:z], ones)) @ head for x, (a, z) in zip(xs, spans)]


# ---- training -------------------------------------------------------------

def _loss_row(params: dict, row: torch.Tensor, p: dict, act, wround):
    inputs, targets = row[:-1], row[1:]
    pos = torch.arange(inputs.numel(), device=row.device)
    x = params["embed"][inputs]
    for b in params["blocks"]:
        x = checkpoint(block_forward, b, x, pos, p, act, wround,
                       use_reentrant=False)
    x = rms_norm(x, params["final_norm"])
    logits = act(x) @ wround(params["embed"].t())
    return F.cross_entropy(logits, targets, reduction="mean")


def leaf_names(params: dict) -> list:
    """Leaf names in the program's tree order (dicts in key order)."""
    names = ["embed", "final_norm"]
    for i, b in enumerate(params["blocks"]):
        names += [f"blocks.{i}.{k}" for k in b]
    return names


def leaves(params: dict) -> list:
    out = [params["embed"], params["final_norm"]]
    for b in params["blocks"]:
        out += list(b.values())
    return out


def train_steps(p: dict, params: dict, batches: list, opt: dict, act=None,
                wround=None) -> dict:
    """Steps of the reference on ``params`` (float32 leaves, updated in
    place) over ``batches`` (rows, seq + 1): the losses, the first
    gradient's norm per leaf as AdamW receives it (after the clip), and
    the change of each leaf over all the steps, as norms."""
    strict_float32()
    act, wround = act or _same, wround or _same
    ls = leaves(params)
    start = [t.detach().clone() for t in ls]
    mu = [torch.zeros_like(t) for t in ls]
    nu = [torch.zeros_like(t) for t in ls]
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, g1 = [], None
    for step, batch in enumerate(batches):
        grads = [torch.zeros_like(t) for t in ls]
        total = 0.0
        for row in batch:
            for t in ls:
                t.requires_grad_(True)
            loss = _loss_row(params, row, p, act, wround) / batch.shape[0]
            for g, d in zip(grads, torch.autograd.grad(loss, ls)):
                g.add_(d)
            total += float(loss.detach())
            for t in ls:
                t.requires_grad_(False)
        losses.append(total)
        clip = opt.get("grad_clip_norm", 0.0)
        if clip > 0:
            norm = math.sqrt(sum(float(g.square().sum()) for g in grads))
            if norm >= clip:
                grads = [g * (clip / norm) for g in grads]
        if g1 is None:
            g1 = [float(g.norm()) for g in grads]
        count = step + 1
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        with torch.no_grad():
            for t, g, m, v in zip(ls, grads, mu, nu):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).add_(g.square(), alpha=1 - b2)
                u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                t.add_((u + opt["weight_decay"] * t) * -opt["learning_rate"])
    change = [float((t - s).norm()) for t, s in zip(ls, start)]
    return {"losses": losses, "grad1": g1, "change": change,
            "names": leaf_names(params)}
