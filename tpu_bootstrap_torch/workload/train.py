"""Training, the counterpart of ``tpu_bootstrap/workload/train.py``.

A step is eager PyTorch: the loss (``model.loss_from_inputs``, through
kernels K3/K4 with ``attention="flash"``), its gradients, and an AdamW
update that matches optax's ``chain(clip_by_global_norm, adamw)`` with the
reference's warmup-cosine schedule update for update. The reference
donates params and optimizer state to its jitted step and gets new arrays
back; the port updates them IN PLACE (no second copy of the train state)
and returns them too, so callers written against the functional form keep
working.

On a mesh (``sharding.build_mesh``: one rank a device, the dcn, data,
fsdp, expert, seq and tensor axes) params and optimizer moments are
DTensors placed by ``sharding.param_shardings``, each rank reads its rows
of the batch, and a step computes on local tensors: the params gathered
over the axes that shard them (an expert stack keeps its ``expert``
shard), the attention core under ``local_map`` on the rank's rows and
heads (K3/K4 for flash), with ``seq`` > 1 on the rank's sequence shard
through the ring (``ring_attention``), the MoE layer over the expert
all-to-all (``sharding.moe_layer``), and the gradients summed over
``sharding.GRAD_AXES`` back onto each param's shard before the global clip
norm and the update (``descend``). With ``pipe`` above 1 the blocks are
stacked and cut by layers over ``pipe``, and a step runs the
``pipeline_schedule`` of ``pipeline.py`` (GPipe or 1F1B over
``num_microbatches``), whose grad function replaces autograd; the
optimizer half (``apply_update``) is shared.
``worker_main`` joins the process group from the JobSet's env
(``bootstrap_from_env``) or torchrun's, dispatches ``WORKLOAD_MODE=serve``
to ``serving.serve_demo_from_env`` and starts the metrics server on
``WORKLOAD_METRICS_PORT``.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload import sharding
from tpu_bootstrap_torch.workload.flash_attention import make_flash_attn_fn
from tpu_bootstrap_torch.workload.ring_attention import make_ring_attention
from tpu_bootstrap_torch.workload.model import (
    ModelConfig,
    dense_attn_core,
    flops_model,
    init_params,
    loss_from_inputs,
    resolve_device,
)
from tpu_bootstrap_torch.workload.sharding import MeshConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = ModelConfig()
    mesh: MeshConfig = MeshConfig()
    learning_rate: float = 3e-4
    # Linear warmup over warmup_steps, then cosine decay to zero at
    # total_steps; total_steps == 0 keeps a constant learning rate.
    warmup_steps: int = 0
    total_steps: int = 0
    grad_clip_norm: float = 0.0  # 0 = no clipping
    weight_decay: float = 1e-4
    # None = synthetic batches; a data.DataConfig reads a token file.
    data: Any = None
    remat: bool = False  # recompute the loss's activations in the backward
    attention: str = "dense"  # "dense" (einsums) or "flash" (K3/K4)
    attention_block: int = 512  # validated only: the kernels pick tiles
    # Microbatches per step when mesh.pipe > 1 (0 = 2x the stage count).
    num_microbatches: int = 0
    # "gpipe" (all forwards, then the backwards) or "1f1b" (PipeDream-flush:
    # at most pipe stage inputs held a stage); see pipeline.py.
    pipeline_schedule: str = "gpipe"


def mesh_device(mesh) -> torch.device:
    """The device a mesh's rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def resolve_mesh(mesh_cfg: MeshConfig, mesh=None, device=None):
    """The mesh a train entry runs on: ``mesh`` when given, else
    ``build_mesh(mesh_cfg)`` on ``device``'s type (None: the card) when the
    config spans more than one device, else None (the plain path)."""
    if mesh is None and mesh_cfg.size > 1:
        mesh = sharding.build_mesh(
            mesh_cfg, None if device is None else torch.device(device).type)
    return mesh


def make_schedule(cfg: TrainConfig):
    """count -> learning rate, optax's
    ``warmup_cosine_decay_schedule(0, lr, max(warmup, 1), total_steps)``
    in f32 when total_steps > 0, else the constant rate. The count starts
    at 0, so the first update has learning rate 0."""
    peak = np.float32(cfg.learning_rate)
    if cfg.total_steps <= 0:
        return lambda count: float(peak)
    warmup = max(cfg.warmup_steps, 1)
    decay = cfg.total_steps - warmup
    if not decay > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={decay}.")
    one = np.float32(1.0)

    def schedule(count: int) -> float:
        if count < warmup:
            frac = one - np.float32(max(count, 0)) / np.float32(warmup)
            return float(-peak * frac + peak)
        c = np.float32(min(count - warmup, decay))
        cosine = np.float32(0.5) * (one + np.cos(np.float32(math.pi) * c
                                                 / np.float32(decay)))
        return float(peak * cosine)

    return schedule


class AdamW:
    """optax ``adamw(schedule, weight_decay=wd)`` (b1 0.9, b2 0.999, eps
    1e-8 outside the square root, weight decay on every leaf), after
    ``clip_by_global_norm(clip)`` when clip > 0 (scale by clip / norm only
    when norm >= clip; no epsilon on the norm). The state is
    ``{"count", "mu", "nu"}`` over the param leaves in ``tree_leaves``
    order, each moment placed as its param is (a DTensor on a mesh);
    ``update`` advances it in place and returns the updates."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, schedule, weight_decay: float, clip: float = 0.0):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip = clip

    def init(self, params) -> dict:
        def zeros(p):
            z = torch.zeros_like(sharding.local(p), dtype=torch.float32)
            return sharding.like(p, z) if sharding.is_placed(p) else z

        leaves = tree_leaves(params)
        return {"count": 0, "mu": [zeros(p) for p in leaves],
                "nu": [zeros(p) for p in leaves]}

    def update(self, grads: list, state: dict, params: list,
               sq_norm: torch.Tensor | None = None) -> list:
        """``grads`` and ``params`` are the tensors a rank holds (a mesh
        step's local shards); ``sq_norm`` is the squared global norm of the
        gradients where they are shards of it."""
        if self.clip > 0:
            if sq_norm is None:
                sq_norm = sum(g.float().square().sum() for g in grads)
            g_norm = torch.sqrt(sq_norm)
            keep = g_norm < self.clip
            grads = [torch.where(keep, g, g / g_norm * self.clip)
                     for g in grads]
        lr = self.schedule(state["count"])
        count = state["count"] + 1
        bc1 = 1 - np.float32(self.b1) ** count
        bc2 = 1 - np.float32(self.b2) ** count
        updates = []
        for g, mu, nu, p in zip(grads, state["mu"], state["nu"], params):
            mu, nu = sharding.local(mu), sharding.local(nu)
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).add_(g.square(), alpha=1 - self.b2)
            u = (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + self.eps)
            u = u + self.weight_decay * p
            updates.append(u * -lr)
        state["count"] = count
        return updates


def make_optimizer(cfg: TrainConfig) -> AdamW:
    return AdamW(make_schedule(cfg), cfg.weight_decay, cfg.grad_clip_norm)


def tree_leaves(tree) -> list:
    """Tensors of a params tree, dicts in key order, lists in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def init_train_state(cfg: TrainConfig, seed: int = 0, device=None,
                     mesh=None) -> tuple:
    """(params, optimizer state) on ``device`` (None: the card), or on
    ``mesh`` (built from ``cfg.mesh`` when that spans several devices):
    every rank draws the same init and keeps its shards. With
    ``cfg.mesh.pipe`` > 1 the blocks are stacked (``pipeline``'s layout),
    each stage keeping its layers."""
    mesh = resolve_mesh(cfg.mesh, mesh, device)
    if cfg.mesh.pipe > 1 and cfg.model.num_layers % cfg.mesh.pipe != 0:
        raise ValueError(
            f"num_layers ({cfg.model.num_layers}) must divide evenly over "
            f"pipe stages ({cfg.mesh.pipe})")
    params = init_params(cfg.model, seed=seed, device=device if mesh is None
                         else mesh_device(mesh))
    if cfg.mesh.pipe > 1:
        from tpu_bootstrap_torch.workload.pipeline import stack_block_params

        params = {**params, "blocks": stack_block_params(params["blocks"])}
    if mesh is not None:
        params = sharding.shard_params(
            params, sharding.param_shardings(mesh, params))
    return params, make_optimizer(cfg).init(params)


def place_state(tree, shardings, opt_state: dict | None = None):
    """``tree`` (and its optimizer state's moments) with every leaf not
    placed yet distributed by ``shardings``: a tree of them
    (``param_shardings``) or one for every leaf (``replicated``); a moment
    goes as its leaf. Placed leaves stay as they are. Returns the tree; the
    moments are replaced in ``opt_state``."""
    n = len(tree_leaves(tree))
    per_leaf = ([shardings] * n if isinstance(shardings, sharding.Sharding)
                else tree_leaves(shardings))
    it = iter(per_leaf)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        sh = next(it)
        return t if sharding.is_placed(t) else sharding.shard_params(t, sh)

    tree = walk(tree)
    for key in ("mu", "nu") if opt_state is not None else ():
        opt_state[key] = [m if sharding.is_placed(m)
                          else sharding.shard_params(m, sh)
                          for m, sh in zip(opt_state[key], per_leaf)]
    return tree


def _seq_rule(cfg: TrainConfig, seq: int) -> None:
    shifted = cfg.model.max_seq_len - 1
    if shifted % seq != 0:
        raise ValueError(
            f"sequence parallelism needs (max_seq_len - 1) divisible by the "
            f"seq mesh axis: max_seq_len={cfg.model.max_seq_len} shifts to "
            f"{shifted}, seq={seq} (loss_fn drops one token; "
            f"pick max_seq_len = k*seq + 1)")


def _heads_rule(cfg: TrainConfig, mesh) -> None:
    mcfg = sharding.mesh_config(mesh)
    t = mcfg.tensor
    if ((cfg.attention == "flash" or mcfg.seq > 1)
            and cfg.model.num_heads % t != 0):
        raise ValueError(
            f"attention={cfg.attention!r} with sequence/flash shard_map "
            f"shards the heads axis over the tensor mesh axis: num_heads "
            f"({cfg.model.num_heads}) must be divisible by tensor "
            f"({t}). Pick a mesh (WORKLOAD_MESH / "
            f"TrainConfig.mesh) whose tensor extent divides num_heads, or "
            f"use attention='dense'.")


def mesh_attention(mesh, attn, cfg: ModelConfig, seq: bool = False):
    """The attention hook of a mesh step: ``attn`` (or the dense core) in
    ``sharding.attention_region``, split over the tensor axis by heads
    where it divides them (a dense core replicated over tensor
    otherwise); ``seq`` marks a step that splits the sequence (``attn``
    the ring)."""
    core = attn or dense_attn_core
    if cfg.num_heads % sharding.mesh_config(mesh).tensor != 0:
        return core
    return sharding.attention_region(mesh, core, cfg.num_heads,
                                     cfg.kv_heads, seq)


def local_rows(tokens, mesh) -> torch.Tensor:
    """This rank's rows of a token batch: a DTensor's local rows (it must
    be Shard(0) over BATCH_AXES), or the rank's slice of a whole batch."""
    if sharding.is_placed(tokens):
        want = sharding.batch_shardings(mesh).placements
        if tuple(tokens.placements) != tuple(want):
            raise ValueError(f"tokens placed {tokens.placements}, want "
                             f"{want}")
        return sharding.local(tokens)
    from tpu_bootstrap_torch.workload.data import host_rows

    return tokens[host_rows(tokens.shape[0],
                            *sharding.dp_coordinate(mesh))]


def make_train_step(cfg: TrainConfig, mesh=None):
    """Returns step(params, opt_state, tokens) -> (params, opt_state,
    loss): the loss of ``tokens`` (batch, max_seq_len) shifted by one, its
    gradients, and the optimizer update applied to params in place.
    ``remat`` recomputes the whole loss's activations in the backward
    (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint(loss)``. On a mesh (given, or built from
    ``cfg.mesh``) params are placed by ``init_train_state``, ``tokens``
    is the whole batch or a DTensor of it, and the loss is the whole
    batch's. With ``seq`` > 1 each rank takes its shard of the shifted
    inputs and targets, at their global positions, and attention runs
    the ring on ``cfg.attention``'s block core. With ``pipe`` > 1 the
    gradients come from the pipeline schedule ``cfg.pipeline_schedule``
    names (``pipeline.make_pipeline_step_grad``)."""
    if cfg.attention not in ("dense", "flash"):
        raise ValueError(f"unknown attention {cfg.attention!r}")
    mesh = resolve_mesh(cfg.mesh, mesh)
    opt = make_optimizer(cfg)
    if mesh is not None and sharding.mesh_config(mesh).pipe > 1:
        from tpu_bootstrap_torch.workload.pipeline import \
            make_pipeline_step_grad

        grad_fn = make_pipeline_step_grad(cfg, mesh)

        def pipelined(params, opt_state, tokens):
            rows = local_rows(tokens, mesh)
            loss_value, grads, _ = grad_fn(params, rows[:, :-1], rows[:, 1:],
                                           batch=tokens.shape[0])
            leaves = tree_leaves(params)
            apply_update(opt, opt_state, leaves,
                         [sharding.local(p) for p in leaves],
                         tree_leaves(grads), mesh)
            return params, opt_state, loss_value

        return pipelined
    attn = (make_flash_attn_fn(block_size=cfg.attention_block)
            if cfg.attention == "flash" else None)
    moe_fn = None
    seq = mesh is not None and sharding.mesh_config(mesh).seq > 1
    if mesh is not None:
        if seq:
            _seq_rule(cfg, sharding.mesh_config(mesh).seq)
            attn = make_ring_attention(mesh, head_axis="tensor",
                                       attention=cfg.attention,
                                       block_size=cfg.attention_block)
        _heads_rule(cfg, mesh)
        attn = mesh_attention(mesh, attn, cfg.model, seq)
        moe_fn = sharding.moe_layer(mesh, seq)

    def loss(params, inputs, targets, positions):
        return loss_from_inputs(params, inputs, targets, cfg.model,
                                attn_fn=attn, moe_fn=moe_fn,
                                positions=positions)

    if cfg.remat:
        plain = loss

        def loss(params, inputs, targets, positions):
            return checkpoint(plain, params, inputs, targets, positions,
                              use_reentrant=False)

    def step(params, opt_state, tokens):
        if mesh is not None:
            tokens = local_rows(tokens, mesh)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        positions = None
        if seq:
            inputs = sharding.seq_part(inputs, mesh)
            targets = sharding.seq_part(targets, mesh)
            positions = sharding.seq_positions(inputs.shape[1], mesh,
                                               inputs.device)
        loss_value = descend(opt, opt_state, tree_leaves(params),
                             lambda view: loss(view(params), inputs,
                                               targets, positions), mesh)
        return params, opt_state, loss_value

    return step


def descend(opt: AdamW, opt_state: dict, leaves: list, loss,
            mesh=None) -> torch.Tensor:
    """One optimizer step on ``leaves`` in place: ``loss(view)`` with grad
    enabled on them, its gradients with respect to them alone, and
    ``opt``'s update added to each. ``view(tree)`` is the tree to compute
    on: the tree itself, or on a mesh its leaves gathered
    (``sharding.gather_tree``, differentiable in the ``leaves``; expert
    stacks keep their ``expert`` shard for ``sharding.moe_layer``). On a
    mesh ``loss`` is the mean over the rank's rows (and its positions, when
    the step splits the sequence; whole rows on every ``seq`` rank
    otherwise): each rank descends on its share, the loss divided by
    ``sharding.grad_degree``, the gradients come back summed over
    ``sharding.GRAD_AXES`` onto each leaf's shard, and the clip norm is
    the global one. Returns the batch's (pre-update) loss, detached."""
    if mesh is None:
        held, view = leaves, lambda tree: tree
    else:
        held = [sharding.local(p) for p in leaves]
        grads_of = {id(p): t for p, t in zip(leaves, held)}

        def view(tree):
            return sharding.gather_tree(tree, grads_of, experts=False)
    with torch.enable_grad():
        for p in held:
            p.requires_grad_(True)
        loss_value = loss(view)
        if mesh is not None:
            loss_value = loss_value / sharding.grad_degree(mesh)
        grads = torch.autograd.grad(loss_value, held)
    apply_update(opt, opt_state, leaves, held, list(grads), mesh)
    loss_value = loss_value.detach()
    return loss_value if mesh is None else sharding.grad_sum(loss_value,
                                                             mesh)


def apply_update(opt: AdamW, opt_state: dict, leaves: list, held: list,
                 grads: list, mesh=None) -> None:
    """The optimizer half of a step: ``opt``'s update of the tensors
    ``held`` (each leaf's local storage on a mesh) from ``grads`` of them,
    added in place, the clip norm the global one over the mesh."""
    sq_norm = None
    if mesh is not None and opt.clip > 0:
        sq_norm = sharding.grad_sq_norm(list(grads), leaves)
    with torch.no_grad():
        for p, u in zip(held, opt.update(list(grads), opt_state, held,
                                         sq_norm)):
            p.requires_grad_(False)
            p.add_(u)


def global_batch_size(cfg: TrainConfig) -> int:
    """Rows of a step's token batch: 2 per data-parallel slot, times the
    microbatch count when pipelined (the reference's rule)."""
    m = cfg.mesh
    batch = max(2 * m.dcn * m.data * m.fsdp * m.expert, 2)
    if m.pipe > 1:
        batch *= cfg.num_microbatches or 2 * m.pipe
    return batch


def synthetic_batch(cfg: TrainConfig, step_index: int,
                    seed: int = 0) -> torch.Tensor:
    """Deterministic token batch of a step (host tensor): a resume sees
    exactly the data an uninterrupted run would have seen."""
    gen = torch.Generator()
    gen.manual_seed(seed * 1_000_003 + step_index)
    return torch.randint(0, cfg.model.vocab_size,
                         (global_batch_size(cfg), cfg.model.max_seq_len),
                         generator=gen)


def train_loop(cfg: TrainConfig, steps: int, *,
               checkpoint_dir: str | None = None, save_every: int = 10,
               seed: int = 0, profile_dir: str | None = None,
               log_every: int = 0, device=None, mesh=None) -> list:
    """Run (or resume) training to ``steps`` total steps on ``device``
    (None: the card), or on ``mesh`` (built from ``cfg.mesh`` on
    ``device``'s type when that spans several devices); returns the
    losses of the steps run by this call.

    With ``checkpoint_dir``, the latest checkpoint there is restored and
    training continues from it (the JobSet restart path), and a checkpoint
    is saved every ``save_every`` steps and at the last. ``profile_dir``
    records steps start+1..start+3 with ``torch.profiler`` into
    ``profile_dir/trace.json`` (Chrome trace; on a mesh every rank writes
    ``trace-<rank>.json``). ``log_every > 0`` prints loss and tokens/s
    every that many steps. Each step is a ``train.step`` span and sets
    the reference's ``workload_*`` gauges."""
    if save_every < 1:
        raise ValueError(f"save_every must be >= 1, got {save_every}")
    mesh = resolve_mesh(cfg.mesh, mesh, device)
    device = resolve_device(device) if mesh is None else mesh_device(mesh)
    reg = telemetry.metrics()
    mgr = latest = None
    if checkpoint_dir is not None:
        from tpu_bootstrap_torch.workload import checkpoint as ckpt

        mgr = ckpt.make_manager(checkpoint_dir)
        latest = ckpt.latest_step(mgr)
    start = 0
    if latest is not None:
        # Restart recovery: count it and time the restore.
        reg.inc("workload_restarts_total")
        reg.set_gauge("workload_resumed_from_step", latest)
        t_restore = time.monotonic()
        params, opt_state = ckpt.restore(mgr, latest, device, mesh=mesh)
        reg.observe("workload_checkpoint_restore_ms",
                    (time.monotonic() - t_restore) * 1e3)
        start = latest
    else:
        params, opt_state = init_train_state(cfg, seed, device, mesh=mesh)
    step_fn = make_train_step(cfg, mesh)

    losses: list = []
    tokens_per_step = global_batch_size(cfg) * (cfg.model.max_seq_len - 1)
    flops_per_step = flops_model(cfg.model)["train"] * tokens_per_step
    peak = telemetry.peak_tflops() if device.type == "cuda" else None
    t_loop = t_log = time.monotonic()
    last_logged, busy_s = start, 0.0
    prof = None
    trace = "trace.json" if mesh is None else f"trace-{dist.get_rank()}.json"

    def close_trace():
        nonlocal prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(profile_dir) / trace))
        prof = None

    def run_step(i, tokens):
        nonlocal params, opt_state, prof, t_log, last_logged, busy_s
        if profile_dir is not None:
            if i == start + 1 and prof is None:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            elif prof is not None and i == start + 4:
                close_trace()
        # The loss readback inside the span waits for the device, so the
        # span is the step's wall time.
        with telemetry.span("train.step", step=i) as rec:
            params, opt_state, loss_value = step_fn(params, opt_state, tokens)
            losses.append(float(loss_value))
        step_ms = rec["dur_ms"]
        busy_s += step_ms / 1e3
        reg.observe("workload_train_step_ms", step_ms)
        reg.inc("workload_train_steps_total")
        reg.set_gauge("workload_last_step", i + 1)
        reg.set_gauge("workload_train_loss", losses[-1])
        reg.set_gauge("workload_tokens_per_sec",
                      round(tokens_per_step / max(step_ms / 1e3, 1e-9), 1))
        reg.set_gauge("workload_goodput_frac", round(
            busy_s / max(time.monotonic() - t_loop, 1e-9), 4))
        if peak is not None:
            reg.set_gauge("workload_train_mfu", round(
                flops_per_step / (max(step_ms, 1e-6) * 1e-3 * peak * 1e12),
                9))
        telemetry.heartbeat(i + 1)
        if log_every > 0 and (i + 1) % log_every == 0:
            now = time.monotonic()
            tps = tokens_per_step * (i + 1 - last_logged) / max(now - t_log,
                                                                1e-9)
            t_log, last_logged = now, i + 1
            print(f"step {i + 1}/{steps}: loss {losses[-1]:.4f}, "
                  f"{tps:,.0f} tokens/s", flush=True)
        if mgr is not None and ((i + 1) % save_every == 0 or i + 1 == steps):
            t_save = time.monotonic()
            ckpt.save(mgr, i + 1, params, opt_state)
            reg.observe("workload_checkpoint_save_ms",
                        (time.monotonic() - t_save) * 1e3)

    try:
        if cfg.data is not None:
            from tpu_bootstrap_torch.workload.data import (make_batch_fn,
                                                           prefetched)

            batch_fn = make_batch_fn(cfg.data, cfg.model.max_seq_len,
                                     global_batch_size(cfg), device,
                                     mesh=mesh)
            for i, tokens in prefetched(batch_fn, start, steps):
                run_step(i, tokens)
        else:
            for i in range(start, steps):
                tokens = synthetic_batch(cfg, i, seed)
                if mesh is None:
                    run_step(i, tokens.to(device))
                else:  # only this rank's rows go to its device
                    run_step(i, sharding.place_rows(
                        local_rows(tokens, mesh).to(device), mesh))
    finally:
        # A step that raises still leaves its partial trace behind.
        if prof is not None:
            close_trace()
    return losses


def run_demo(num_devices: int | None = None, steps: int = 2, seed: int = 0,
             device=None) -> list:
    """A few steps of the default model over the process group's world
    (one device without one), on the ``for_device_count`` mesh: the
    function a JobSet worker ends in. ``device`` None is the card."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    cfg = TrainConfig(mesh=MeshConfig.for_device_count(num_devices or world))
    mesh = resolve_mesh(cfg.mesh, None, device)
    params, opt_state = init_train_state(cfg, seed, device, mesh=mesh)
    train_step = make_train_step(cfg, mesh)
    m = cfg.mesh
    gen = torch.Generator()
    gen.manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.model.vocab_size,
                           (max(m.dcn * m.data * m.fsdp * m.expert, 2),
                            cfg.model.max_seq_len), generator=gen)
    tokens = tokens.to(resolve_device(device) if mesh is None
                       else mesh_device(mesh))
    losses = []
    for _ in range(steps):
        params, opt_state, loss_value = train_step(params, opt_state, tokens)
        losses.append(float(loss_value))
    return losses


def bootstrap_from_env(environ=None) -> dict | None:
    """Multi-host rendezvous parameters from the env the controller's
    emitted JobSet injects, the reference's dict for dict:
    TPUBC_COORDINATOR_ADDRESS (worker 0's address and port),
    TPUBC_NUM_HOSTS (hosts a slice), TPUBC_NUM_SLICES (slices, absent 1),
    TPUBC_SLICE_ID (this pod's slice) and JOB_COMPLETION_INDEX (this host
    within its slice). The process space is slices x hosts, slice-major,
    so ``build_mesh`` puts whole slices in ``dcn`` rows. Returns
    {coordinator_address, num_processes, process_id}, or None outside a
    JobSet."""
    env = os.environ if environ is None else environ
    addr = env.get("TPUBC_COORDINATOR_ADDRESS")
    if not addr:
        return None
    hosts = int(env.get("TPUBC_NUM_HOSTS", "1"))
    slices = int(env.get("TPUBC_NUM_SLICES", "1"))
    slice_id = int(env.get("TPUBC_SLICE_ID", "0"))
    host_id = int(env.get("JOB_COMPLETION_INDEX", "0"))
    return {
        "coordinator_address": addr,
        "num_processes": hosts * slices,
        "process_id": slice_id * hosts + host_id,
    }


def rendezvous(environ=None) -> bool:
    """Join the process group a multi-process run needs, on the card
    ``cuda:{LOCAL_RANK or 0}`` with NCCL: from the JobSet's env
    (``bootstrap_from_env``, ``tcp://`` to the coordinator) or torchrun's
    (``WORLD_SIZE`` > 1, ``env://``). Returns whether it joined one.
    ``MEGASCALE_COORDINATOR_ADDRESS`` (the TPU's multislice discovery) has
    no counterpart and raises."""
    env = os.environ if environ is None else environ
    boot = bootstrap_from_env(env)
    if boot is not None and boot["num_processes"] > 1:
        kw = dict(init_method=f"tcp://{boot['coordinator_address']}",
                  world_size=boot["num_processes"], rank=boot["process_id"])
    elif int(env.get("WORLD_SIZE", "1")) > 1:
        kw = dict(init_method="env://")
    elif env.get("MEGASCALE_COORDINATOR_ADDRESS"):
        raise NotImplementedError(
            "MEGASCALE_COORDINATOR_ADDRESS is the TPU's multislice "
            "discovery and has no counterpart on the card: set "
            "TPUBC_COORDINATOR_ADDRESS (with TPUBC_NUM_HOSTS, "
            "TPUBC_NUM_SLICES, TPUBC_SLICE_ID, JOB_COMPLETION_INDEX)")
    else:
        return False
    resolve_device(None)  # the card, or the CPU's error
    torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl", **kw)
    return True


def _parse_env_terms(value: str, valid: set, env_name: str):
    """The WORKLOAD_MODEL / WORKLOAD_MESH grammar: comma-separated
    key=value terms; unknown and duplicate keys are rejected."""
    seen = set()
    for term in value.split(","):
        term = term.strip()
        if not term:
            continue
        if "=" not in term:
            raise ValueError(f"{env_name} term {term!r} is not key=value")
        k, v = term.split("=", 1)
        k = k.strip()
        if k not in valid:
            raise ValueError(
                f"{env_name} field {k!r} unknown (valid: {sorted(valid)})")
        if k in seen:
            raise ValueError(f"{env_name} field {k} specified twice")
        seen.add(k)
        yield k, v.strip()


def parse_model_env(value: str) -> ModelConfig:
    """WORKLOAD_MODEL, e.g. "embed_dim=1024,num_layers=8,vocab_size=32768":
    key=value terms onto ModelConfig fields (empty = all defaults), with
    the reference's validation and messages. compute_dtype takes
    bfloat16/float32/float16 (as torch dtypes); num_kv_heads takes "none"."""
    if not value.strip():
        return ModelConfig()
    valid = {f.name: f for f in dataclasses.fields(ModelConfig)}
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32,
              "float16": torch.float16}
    zero_ok = {"num_experts", "vocab_chunk", "moe_aux_coef"}
    fields: dict = {}
    for k, v in _parse_env_terms(value, set(valid), "WORKLOAD_MODEL"):
        if k == "compute_dtype":
            if v not in dtypes:
                raise ValueError(
                    f"WORKLOAD_MODEL compute_dtype {v!r} unknown "
                    f"(valid: {sorted(dtypes)})")
            fields[k] = dtypes[v]
            continue
        if k == "num_kv_heads" and v.lower() == "none":
            fields[k] = None
            continue
        if valid[k].type in ("float", float):
            num = float(v)
            if (not math.isfinite(num) or num < 0
                    or (num == 0 and k not in zero_ok)):
                raise ValueError(
                    f"WORKLOAD_MODEL {k} must be a finite value "
                    f"{'>= 0' if k in zero_ok else '> 0'}, got {v}")
        else:
            num = int(v)
            if num < (0 if k in zero_ok else 1):
                raise ValueError(
                    f"WORKLOAD_MODEL {k} must be >= "
                    f"{0 if k in zero_ok else 1}, got {v}")
        fields[k] = num
    cfg = ModelConfig(**fields)
    cfg.kv_heads  # noqa: B018 — divisibility check fails loudly here
    if cfg.vocab_chunk > 0 and cfg.vocab_size % cfg.vocab_chunk != 0:
        raise ValueError(
            f"WORKLOAD_MODEL vocab_chunk ({cfg.vocab_chunk}) must divide "
            f"vocab_size ({cfg.vocab_size})")
    return cfg


def parse_mesh_env(value: str, n_devices: int) -> MeshConfig:
    """WORKLOAD_MESH, e.g. "pipe=2,data=4" (unnamed axes 1), or empty for
    the ``for_device_count`` default; the reference's validation."""
    if not value.strip():
        return MeshConfig.for_device_count(n_devices)
    fields = {}
    valid = {f.name for f in dataclasses.fields(MeshConfig)}
    for k, v in _parse_env_terms(value, valid, "WORKLOAD_MESH"):
        extent = int(v)
        if extent < 1:
            raise ValueError(
                f"WORKLOAD_MESH axis {k} extent must be >= 1, got {extent}")
        fields[k] = extent
    cfg = MeshConfig(**fields)
    if cfg.size != n_devices:
        raise ValueError(
            f"WORKLOAD_MESH {value!r} needs {cfg.size} devices; this run "
            f"has {n_devices} (the product over ALL slices — multislice "
            f"meshes must include the dcn axis)")
    return cfg


def worker_main() -> None:
    """JobSet worker entry: ``python -m tpu_bootstrap_torch.workload.train``
    with ``WORKLOAD_MODE=train`` (the default), on the card. The
    reference's env: WORKLOAD_STEPS, WORKLOAD_SAVE_EVERY,
    WORKLOAD_CHECKPOINT_DIR, WORKLOAD_SEED, WORKLOAD_MODEL, WORKLOAD_MESH,
    WORKLOAD_ATTENTION (dense|flash), WORKLOAD_ATTENTION_BLOCK,
    WORKLOAD_REMAT, WORKLOAD_WARMUP_STEPS, WORKLOAD_TOTAL_STEPS,
    WORKLOAD_GRAD_CLIP, WORKLOAD_DATA_PATH / WORKLOAD_DATA_DTYPE,
    WORKLOAD_PROFILE_DIR and WORKLOAD_LOG_EVERY. WORKLOAD_METRICS_PORT
    (> 0, worker 0) serves the metrics registry
    (``telemetry.start_metrics_server``); WORKLOAD_MODE=serve runs
    ``serving.serve_demo_from_env`` instead of training (the synthetic
    demo, or the HTTP ingress on WORKLOAD_SERVE_PORT). A multi-process
    run joins its process group first (``rendezvous``: the JobSet's
    TPUBC_* env or torchrun's), WORKLOAD_MESH is parsed against its world
    size, and WORKLOAD_MICROBATCHES / WORKLOAD_SCHEDULE (gpipe|1f1b) set
    the pipeline of a mesh with a pipe axis."""
    env = os.environ
    rendezvous(env)
    # Worker 0's metrics endpoint: /metrics, /metrics.json, /healthz,
    # /statusz and /traces.json for the controller's workload scrape.
    metrics_port = int(env.get("WORKLOAD_METRICS_PORT", "0"))
    if metrics_port > 0 and int(env.get("JOB_COMPLETION_INDEX", "0")) == 0:
        httpd = telemetry.start_metrics_server(metrics_port)
        print(f"workload: metrics on :{httpd.server_address[1]}", flush=True)
    mode = env.get("WORKLOAD_MODE", "train")
    if mode == "serve":
        from tpu_bootstrap_torch.workload.serving import serve_demo_from_env

        serve_demo_from_env()
        return
    if mode != "train":
        raise ValueError(f"WORKLOAD_MODE must be train|serve, got {mode!r}")
    steps = int(env.get("WORKLOAD_STEPS", "100"))
    seed = int(env.get("WORKLOAD_SEED", "0"))
    data = None
    if env.get("WORKLOAD_DATA_PATH"):
        from tpu_bootstrap_torch.workload.data import DataConfig

        data = DataConfig(path=env["WORKLOAD_DATA_PATH"],
                          dtype=env.get("WORKLOAD_DATA_DTYPE", "uint16"),
                          seed=seed)
    # Unset: cosine decay over the run's steps; "0": constant rate.
    total_env = env.get("WORKLOAD_TOTAL_STEPS")
    cfg = TrainConfig(
        model=parse_model_env(env.get("WORKLOAD_MODEL", "")),
        mesh=parse_mesh_env(env.get("WORKLOAD_MESH", ""),
                            dist.get_world_size() if dist.is_initialized()
                            else 1),
        data=data,
        warmup_steps=int(env.get("WORKLOAD_WARMUP_STEPS", "0")),
        total_steps=steps if total_env is None else int(total_env),
        grad_clip_norm=float(env.get("WORKLOAD_GRAD_CLIP", "1.0")),
        attention=env.get("WORKLOAD_ATTENTION", "dense"),
        attention_block=int(env.get("WORKLOAD_ATTENTION_BLOCK", "512")),
        remat=env.get("WORKLOAD_REMAT", "").lower() in ("1", "true"),
        pipeline_schedule=env.get("WORKLOAD_SCHEDULE", "gpipe"),
        num_microbatches=int(env.get("WORKLOAD_MICROBATCHES", "0")),
    )
    with telemetry.span("workload.train", steps=steps,
                        mode=cfg.attention):
        losses = train_loop(
            cfg, steps, checkpoint_dir=env.get("WORKLOAD_CHECKPOINT_DIR") or None,
            save_every=int(env.get("WORKLOAD_SAVE_EVERY", "10")), seed=seed,
            profile_dir=env.get("WORKLOAD_PROFILE_DIR") or None,
            log_every=int(env.get("WORKLOAD_LOG_EVERY", "10")))
    if losses:
        print(f"train_loop done: ran {len(losses)} steps, "
              f"first={losses[0]:.4f} last={losses[-1]:.4f}")
    else:
        print("train_loop done: nothing to do (checkpoint already at target "
              "step)")


if __name__ == "__main__":
    worker_main()
