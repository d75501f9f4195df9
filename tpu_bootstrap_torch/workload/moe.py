"""Mixture-of-experts MLP, the counterpart of
``tpu_bootstrap/workload/moe.py``.

The GShard/Switch formulation with static shapes, as in the reference:
an f32 router scores every token against every expert, each token takes
its top-k experts with renormalized gates, and each expert has a fixed
capacity C = ceil(k * S / E * cf) slots per batch row. Slots are handed
out in priority order (all first choices in sequence order, then all
second choices, ...) by one cumsum over a one-hot mask; tokens past an
expert's capacity are dropped for it and ride the residual. A one-hot
``dispatch`` (B, S, E, C) gathers the tokens into a dense (E, B, C, M)
expert batch, each expert runs the two-matmul FFN, and ``combine``
carries the gate weights back. The Switch load-balancing aux loss is
``E * sum_e f_e * p_e`` over top-1 assignments.

The expert FFN goes through ``_expert_linear``: quantized stacks launch
kernel K1e (int8) or K6e (int4) through ``quant.quantized_expert_matmul``
on the card, float stacks an einsum. Capacity competition is per batch
row and depends on the sequence length, so a sequence routed in one
chunk and the same sequence routed in pieces may keep different tokens:
MoE serving is held to the reference's own ``serve``, not to ``generate``.

Expert parallelism (``moe_mlp_manual`` with ``n_expert`` > 1): each rank
of the ``expert`` group holds E/n experts' stacks and routes its own rows
with the replicated router; an all-to-all hands every rank its experts'
slots of every member's rows, (E, b, C, M) -> (E/n, n b, C, M), and the
inverse brings the outputs home. Each is the other's backward.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_bootstrap_torch.workload import quant


def expert_capacity(seq: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots per expert per batch row."""
    return max(1, math.ceil(seq * top_k / num_experts * capacity_factor))


def _expert_linear(x: torch.Tensor, w, dtype, tag: str = "") -> torch.Tensor:
    """Per-expert projection x (E, B, C, K) @ w (E, K, N) -> (E, B, C, N),
    for float or int8/int4 expert stacks; ``tag`` labels the launch's
    byte counters."""
    if quant.is_quantized(w):
        e, b, c, k = x.shape
        y = quant.quantized_expert_matmul(
            x.reshape(e, b * c, k).to(dtype), w, tag=tag)
        return y.reshape(e, b, c, -1)
    return torch.einsum("ebck,ekn->ebcn", x, w.to(dtype))


def _route(block: dict, h: torch.Tensor, cfg, batch_mean=None) -> tuple:
    """Router and slot assignment: (dispatch (B, S, E, C), combine
    (B, S, E, C), aux scalar), per batch row. The aux loss's fractions and
    probabilities are means over the whole batch: on a mesh, where h holds
    a rank's rows, ``batch_mean`` averages them over the ranks."""
    n_exp, k = cfg.num_experts, cfg.expert_top_k
    if not 1 <= k <= n_exp:
        raise ValueError(
            f"expert_top_k must be in [1, num_experts], got {k}/{n_exp}")
    b, s, _ = h.shape
    cap = expert_capacity(s, n_exp, k, cfg.expert_capacity_factor)

    logits = torch.einsum("bsm,me->bse", h.float(), block["router"].float())
    gates = torch.softmax(logits, dim=-1)  # (B, S, E)
    # lax.top_k's order: larger first, and the lower index first among
    # equal gates. A stable descending sort gives exactly that.
    gate_k, idx_k = torch.sort(gates, dim=-1, descending=True, stable=True)
    gate_k, idx_k = gate_k[..., :k], idx_k[..., :k]
    gate_k = gate_k / gate_k.sum(dim=-1, keepdim=True)

    # Slot assignment: choice rank first, then sequence order, so one
    # cumsum over the flattened (k * S) axis hands out 0-based slots.
    mask = F.one_hot(idx_k, n_exp).float()  # (B, S, k, E)
    flat = mask.transpose(1, 2).reshape(b, k * s, n_exp)
    pos = torch.cumsum(flat, dim=1) - 1.0
    keep = (pos < cap) & (flat > 0)  # overflow -> dropped
    # One-hot over C; an index outside [0, C) is all zeros, as in
    # jax.nn.one_hot.
    slots = torch.arange(cap, device=h.device)
    disp = (pos.long()[..., None] == slots).float() * keep[..., None].float()
    disp = disp.reshape(b, k, s, n_exp, cap).transpose(1, 2)  # (B,S,k,E,C)
    combine = (disp * gate_k[..., None, None]).sum(dim=2)
    dispatch = disp.sum(dim=2)  # (B, S, E, C) 0/1

    top1 = mask[:, :, 0]  # (B, S, E)
    frac = top1.mean(dim=(0, 1))  # fraction routed to each expert
    prob = gates.mean(dim=(0, 1))  # mean router probability per expert
    if batch_mean is not None:
        frac, prob = batch_mean(frac), batch_mean(prob)
    aux = n_exp * (frac * prob).sum()
    return dispatch, combine, aux


def moe_mlp(block: dict, h: torch.Tensor, cfg) -> tuple:
    """Top-k MoE FFN over pre-normalized activations h (B, S, M): block
    holds ``router`` (M, E), ``w_up`` (E, M, F) and ``w_down`` (E, F, M).
    Returns (out (B, S, M), aux f32 scalar)."""
    return moe_mlp_manual(block, h, cfg)


def _all_to_all(x: torch.Tensor, group, split: int,
                concat: int) -> torch.Tensor:
    """The reference's tiled ``lax.all_to_all``: x cut in n chunks on
    ``split``, chunk j sent to member j, the chunks received concatenated
    on ``concat`` in member order."""
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=split)).contiguous()
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=group)
    return torch.cat(got.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    """``_all_to_all``; its backward is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _all_to_all(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        g = _all_to_all(g, ctx.group, ctx.concat, ctx.split)
        return g, None, None, None


def moe_mlp_manual(block: dict, h: torch.Tensor, cfg,
                   axis_name: str = "expert", n_expert: int = 1,
                   batch_mean=None, group=None) -> tuple:
    """``moe_mlp`` with the reference's expert-parallel signature: the
    same per-row routing on the local rows, and with ``n_expert`` > 1 the
    all-to-all pair over ``group``, the process group of ``axis_name``
    (``sharding.moe_layer`` passes the mesh's). ``block``'s
    ``w_up``/``w_down`` then hold this rank's E/n experts; the router is
    replicated."""
    dtype = cfg.compute_dtype
    dispatch, combine, aux = _route(block, h, cfg, batch_mean)
    expert_in = torch.einsum("bsec,bsm->ebcm", dispatch.to(dtype), h)
    if n_expert > 1:
        if group is None:
            raise ValueError(
                f"expert parallelism over {n_expert} ranks needs the "
                f"process group of {axis_name!r} (group)")
        held = (block["w_up"].q if quant.is_quantized(block["w_up"])
                else block["w_up"]).shape[0]
        if held * n_expert != cfg.num_experts:
            raise ValueError(
                f"expert stacks hold {held} experts on each of {n_expert} "
                f"ranks of {axis_name!r}, want {cfg.num_experts} in all")
        # (E, b, C, M) -> (E/n, b*n, C, M): each member keeps its own
        # experts' slots for every member's rows.
        expert_in = _AllToAll.apply(expert_in, group, 0, 1)
    # jax.nn.gelu's default is the tanh approximation.
    hidden = F.gelu(_expert_linear(expert_in, block["w_up"], dtype,
                                   tag="moe_up"), approximate="tanh")
    expert_out = _expert_linear(hidden, block["w_down"], dtype,
                                tag="moe_down")
    if n_expert > 1:
        # Inverse: (E/n, b*n, C, M) -> (E, b, C, M), rows home again.
        expert_out = _AllToAll.apply(expert_out, group, 1, 0)
    out = torch.einsum("bsec,ebcm->bsm", combine.to(dtype), expert_out)
    return out, aux


__all__ = ["moe_mlp", "moe_mlp_manual", "expert_capacity"]
