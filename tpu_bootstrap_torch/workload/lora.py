"""LoRA fine-tuning, the counterpart of ``tpu_bootstrap/workload/lora.py``:
low-rank adapters over a frozen base model.

Each targeted projection is reparameterized as w + (alpha / r) * A @ B,
A (in, r), B (r, out). The train step builds the effective params from
the frozen base and the adapters (``apply_lora``) and runs the same model
code as training (``model.loss_from_inputs``), so the dense core and the
flash kernels K3/K4 (an ``attn_fn``) both work under LoRA unchanged.
Gradients are taken with respect to the adapters alone: the base leaves
never require grad, and the optimizer state covers the adapters only.

The base may be quantized (int8 ``QuantizedWeight`` or int4
``Quantized4Weight``, the QLoRA recipe): each step dequantizes it with
``quant.dequantize_any`` in plain torch ops, as the reference does outside
any Pallas kernel, and the stored base is never written. B starts at zero,
so the adapted model starts equal to the base. ``merge_lora`` folds the
adapters in for serving (``decode.generate`` or ``quant.quantize_params``
on the result).

On a mesh the frozen base is placed by ``sharding.param_shardings``
before the step captures it (plain, int8 or int4 leaves) and gathered for
each step's compute; the adapters are replicated, and their gradients are
summed over ``sharding.GRAD_AXES`` as training's are (``train.descend``).
As in the reference, whose step cuts the batch only, every ``seq`` rank
runs its rows whole; an MoE base keeps each rank's E/n experts and runs
the expert all-to-all (``sharding.moe_layer``). A mesh with a pipe axis
raises the reference's ``ValueError``: as there, adapters do not take the
pipeline's stacked layout.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from tpu_bootstrap_torch.workload import quant, sharding
from tpu_bootstrap_torch.workload.model import (
    Params,
    loss_from_inputs,
    resolve_device,
)
from tpu_bootstrap_torch.workload.train import (
    descend,
    local_rows,
    make_optimizer,
    mesh_attention,
    place_state,
    resolve_mesh,
    tree_leaves,
)


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    # Which block projections get adapters: any of _FORWARD_LEAVES.
    targets: tuple = ("wq", "wv")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


# The projection leaves the model's forward reads.
_FORWARD_LEAVES = ("wq", "wk", "wv", "wo", "w_up", "w_down")


def init_lora(params: Params, lcfg: LoraConfig, seed: int = 0,
              device=None) -> Params:
    """Adapter tree mirroring params["blocks"]: per block, per target,
    {"a": (in, r) normal / sqrt(in), "b": (r, out) zeros}, f32, on
    ``device`` (None: the card), drawn from a ``torch.Generator`` seeded
    with ``seed``: the reference's shapes and scales, not its numbers.
    ``in`` is the weight's first logical axis (both of ``wo``'s), for
    plain and quantized leaves alike."""
    if lcfg.rank < 1:
        raise ValueError(f"rank must be >= 1, got {lcfg.rank}")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    blocks = []
    for block in params["blocks"]:
        adapters = {}
        for name in lcfg.targets:
            if name not in _FORWARD_LEAVES:
                # An adapter on any other key would never enter the
                # forward (zero gradients, a loss that never moves).
                raise ValueError(
                    f"LoRA target {name!r} is not an adaptable projection "
                    f"(valid: {list(_FORWARD_LEAVES)})")
            if "router" in block and name in ("w_up", "w_down"):
                raise ValueError(
                    "LoRA on MoE expert stacks is not supported (per-expert "
                    "adapters would need the (E, K, N) layout); target the "
                    "attention projections instead")
            shape = tuple(block[name].shape)  # logical, quantized or not
            k_in = shape[0] if name != "wo" else shape[0] * shape[1]
            n_out = math.prod(shape) // k_in
            a = torch.randn((k_in, lcfg.rank), generator=gen, device=device,
                            dtype=torch.float32)
            adapters[name] = {
                "a": a / math.sqrt(k_in),
                "b": torch.zeros((lcfg.rank, n_out), dtype=torch.float32,
                                 device=device),
            }
        blocks.append(adapters)
    return {"blocks": blocks}


def _effective(adapter: dict, w, scale: float) -> torch.Tensor:
    """base + (alpha/r) * A @ B in the base's logical shape. A quantized
    base is dequantized to f32 and the result takes the adapter's dtype;
    a plain base keeps its own dtype (the delta rounded to it first)."""
    if quant.is_quantized(w):
        shape, dtype = tuple(w.shape), adapter["a"].dtype
        base = quant.dequantize_any(w).reshape(shape)
    else:
        shape, dtype = tuple(w.shape), w.dtype
        base = w
    d = (adapter["a"] @ adapter["b"]) * scale
    return (base + d.reshape(shape).to(base.dtype)).to(dtype)


def apply_lora(params: Params, lora: Params, lcfg: LoraConfig) -> Params:
    """Effective params: base + adapter deltas on the targeted leaves.
    Untargeted quantized projections are dequantized plain (the training
    forward reads float tensors), and the fused ``wqkv`` / ``w_gateup``
    decode copies of the BASE are dropped from every block (they would
    serve stale logits next to adapted weights); re-derive them with
    ``quant.quantize_params`` after ``merge_lora``."""
    blocks = []
    for block, adapters in zip(params["blocks"], lora["blocks"]):
        eff = dict(block)
        eff.pop("wqkv", None)
        eff.pop("w_gateup", None)
        for name in _FORWARD_LEAVES:
            if name in adapters:
                eff[name] = _effective(adapters[name], block[name],
                                       lcfg.scale)
            elif name in block and quant.is_quantized(block[name]):
                w = block[name]
                eff[name] = quant.dequantize_any(w).reshape(tuple(w.shape))
        blocks.append(eff)
    return {**params, "blocks": blocks}


def merge_lora(params: Params, lora: Params, lcfg: LoraConfig) -> Params:
    """Fold the adapters in for serving: plain params for
    ``decode.generate`` / ``quant.quantize_params``."""
    return apply_lora(params, lora, lcfg)


def _strip_decode_copies(base: Params) -> Params:
    """The base without its decode-only leaves: the top-level int8
    ``lm_head`` (the training forward ties the head to ``embed``) and each
    block's fused ``wqkv`` / ``w_gateup``."""
    return {**{k: v for k, v in base.items() if k != "lm_head"},
            "blocks": [{k: v for k, v in b.items()
                        if k not in ("wqkv", "w_gateup")}
                       for b in base["blocks"]]}


def make_lora_train_step(cfg, mesh, base_params: Params, lcfg: LoraConfig,
                         attn_fn=None):
    """Returns (step(lora, opt_state, tokens) -> (lora, opt_state, loss),
    optimizer). ``cfg`` is a ``train.TrainConfig``; ``mesh`` a built mesh
    (``sharding.build_mesh``), or a ``MeshConfig`` (built when it spans
    several devices). The base is closed over frozen, without its
    decode-only copies; the optimizer (``train.make_optimizer(cfg)``)
    state exists only for the adapters, which the step updates in place
    and returns (on a mesh, adapters and moments not placed yet are
    replicated first: use the returned tree). ``cfg.remat`` recomputes the
    loss's activations in the backward (``torch.utils.checkpoint``)."""
    mesh_cfg = (mesh if isinstance(mesh, sharding.MeshConfig)
                else sharding.mesh_config(mesh))
    if mesh_cfg.pipe > 1:
        raise ValueError(
            "LoRA does not compose with pipeline meshes (adapters would "
            "need the stacked per-stage layout); use the GSPMD axes "
            "(data/fsdp/expert/seq/tensor)")
    mesh = resolve_mesh(mesh_cfg, None if isinstance(
        mesh, sharding.MeshConfig) else mesh)
    base = _strip_decode_copies(base_params)
    opt = make_optimizer(cfg)
    moe_fn = None
    if mesh is not None:
        # The frozen base committed to its shardings before the closure
        # captures it (the reference's residency rule, QLoRA's point).
        base = place_state(base, sharding.param_shardings(mesh, base))
        attn_fn = mesh_attention(mesh, attn_fn, cfg.model)
        moe_fn = sharding.moe_layer(mesh)

    def loss(lora, eff_base, inputs, targets):
        eff = apply_lora(eff_base, lora, lcfg)
        return loss_from_inputs(eff, inputs, targets, cfg.model,
                                attn_fn=attn_fn, moe_fn=moe_fn)

    if cfg.remat:
        plain = loss

        def loss(lora, eff_base, inputs, targets):
            return checkpoint(plain, lora, eff_base, inputs, targets,
                              use_reentrant=False)

    def step(lora, opt_state, tokens):
        if mesh is not None:
            lora = place_state(lora, sharding.replicated(mesh), opt_state)
            tokens = local_rows(tokens, mesh)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        loss_value = descend(opt, opt_state, tree_leaves(lora),
                             lambda view: loss(view(lora), view(base),
                                               inputs, targets), mesh)
        return lora, opt_state, loss_value

    return step, opt


__all__ = ["LoraConfig", "apply_lora", "init_lora", "make_lora_train_step",
           "merge_lora"]
