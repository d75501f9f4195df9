"""Single-device training, the counterpart of
``tpu_bootstrap/workload/train.py``.

A step is eager PyTorch: the loss (``model.loss_from_inputs``, through
kernels K3/K4 with ``attention="flash"``), its gradients, and an AdamW
update that matches optax's ``chain(clip_by_global_norm, adamw)`` with the
reference's warmup-cosine schedule update for update. The reference
donates params and optimizer state to its jitted step and gets new arrays
back; the port updates them IN PLACE (no second copy of the train state)
and returns them too, so callers written against the functional form keep
working.

The port trains on one device. A mesh of more than one device (data,
fsdp, tensor, expert, dcn, pipe, seq and so the ring) raises
``NotImplementedError`` naming ROADMAP queue 1 item 11. ``worker_main``
also dispatches ``WORKLOAD_MODE=serve`` to
``serving.serve_demo_from_env`` and starts the metrics server on
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
from torch.utils.checkpoint import checkpoint

from tpu_bootstrap_torch import telemetry
from tpu_bootstrap_torch.workload.flash_attention import make_flash_attn_fn
from tpu_bootstrap_torch.workload.model import (
    ModelConfig,
    flops_model,
    init_params,
    loss_from_inputs,
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The reference's mesh axes (``sharding.MeshConfig``); the port runs
    the one-device mesh only."""
    dcn: int = 1
    pipe: int = 1
    data: int = 1
    fsdp: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1

    @property
    def size(self) -> int:
        return (self.dcn * self.pipe * self.data * self.fsdp * self.expert
                * self.seq * self.tensor)

    @staticmethod
    def for_device_count(n: int) -> "MeshConfig":
        """The reference's default factorization: ``tensor`` up to 4, then
        ``fsdp`` up to 8, the rest to ``data`` (power-of-2 factors)."""

        def pow2(m: int, cap: int) -> int:
            f = 1
            while f < cap and m % (f * 2) == 0:
                f *= 2
            return f

        tensor = pow2(n, 4)
        rest = n // tensor
        fsdp = pow2(rest, 8)
        return MeshConfig(data=rest // fsdp, fsdp=fsdp, tensor=tensor)


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


def _single_device(cfg: TrainConfig) -> None:
    if cfg.mesh.size > 1:
        raise NotImplementedError(
            f"a {cfg.mesh.size}-device mesh ({cfg.mesh}) is not ported yet "
            "(ROADMAP queue 1 item 11: multi-device)")


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
    order; ``update`` advances it in place and returns the updates."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, schedule, weight_decay: float, clip: float = 0.0):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip = clip

    def init(self, params) -> dict:
        leaves = tree_leaves(params)
        return {"count": 0,
                "mu": [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
                "nu": [torch.zeros_like(p, dtype=torch.float32) for p in leaves]}

    def update(self, grads: list, state: dict, params: list) -> list:
        if self.clip > 0:
            g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            keep = g_norm < self.clip
            grads = [torch.where(keep, g, g / g_norm * self.clip)
                     for g in grads]
        lr = self.schedule(state["count"])
        count = state["count"] + 1
        bc1 = 1 - np.float32(self.b1) ** count
        bc2 = 1 - np.float32(self.b2) ** count
        updates = []
        for g, mu, nu, p in zip(grads, state["mu"], state["nu"], params):
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


def init_train_state(cfg: TrainConfig, seed: int = 0, device=None) -> tuple:
    """(params, optimizer state) on ``device`` (None: the card)."""
    _single_device(cfg)
    params = init_params(cfg.model, seed=seed, device=device)
    return params, make_optimizer(cfg).init(params)


def make_train_step(cfg: TrainConfig):
    """Returns step(params, opt_state, tokens) -> (params, opt_state,
    loss): the loss of ``tokens`` (batch, max_seq_len) shifted by one, its
    gradients, and the optimizer update applied to params in place.
    ``remat`` recomputes the whole loss's activations in the backward
    (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint(loss)``."""
    if cfg.attention not in ("dense", "flash"):
        raise ValueError(f"unknown attention {cfg.attention!r}")
    _single_device(cfg)
    opt = make_optimizer(cfg)
    attn = (make_flash_attn_fn(block_size=cfg.attention_block)
            if cfg.attention == "flash" else None)

    def loss(params, inputs, targets):
        return loss_from_inputs(params, inputs, targets, cfg.model,
                                attn_fn=attn)

    if cfg.remat:
        plain = loss

        def loss(params, inputs, targets):
            return checkpoint(plain, params, inputs, targets,
                              use_reentrant=False)

    def step(params, opt_state, tokens):
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        leaves = tree_leaves(params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss_value = loss(params, inputs, targets)
            grads = torch.autograd.grad(loss_value, leaves)
        with torch.no_grad():
            for p, u in zip(leaves, opt.update(list(grads), opt_state,
                                               leaves)):
                p.requires_grad_(False)
                p.add_(u)
        return params, opt_state, loss_value.detach()

    return step


def global_batch_size(cfg: TrainConfig) -> int:
    """Rows of a step's token batch: 2 per data-parallel slot (the
    reference's rule; the pipelined microbatch factor comes with ROADMAP
    queue 1 item 11)."""
    m = cfg.mesh
    return max(2 * m.dcn * m.data * m.fsdp * m.expert, 2)


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
               log_every: int = 0, device=None) -> list:
    """Run (or resume) training to ``steps`` total steps on ``device``
    (None: the card); returns the losses of the steps run by this call.

    With ``checkpoint_dir``, the latest checkpoint there is restored and
    training continues from it (the JobSet restart path), and a checkpoint
    is saved every ``save_every`` steps and at the last. ``profile_dir``
    records steps start+1..start+3 with ``torch.profiler`` into
    ``profile_dir/trace.json`` (Chrome trace). ``log_every > 0`` prints
    loss and tokens/s every that many steps. Each step is a ``train.step``
    span and sets the reference's ``workload_*`` gauges."""
    if save_every < 1:
        raise ValueError(f"save_every must be >= 1, got {save_every}")
    _single_device(cfg)
    device = resolve_device(device)
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
        params, opt_state = ckpt.restore(mgr, latest, device)
        reg.observe("workload_checkpoint_restore_ms",
                    (time.monotonic() - t_restore) * 1e3)
        start = latest
    else:
        params, opt_state = init_train_state(cfg, seed, device)
    step_fn = make_train_step(cfg)

    losses: list = []
    tokens_per_step = global_batch_size(cfg) * (cfg.model.max_seq_len - 1)
    flops_per_step = flops_model(cfg.model)["train"] * tokens_per_step
    peak = telemetry.peak_tflops() if device.type == "cuda" else None
    t_loop = t_log = time.monotonic()
    last_logged, busy_s = start, 0.0
    prof = None

    def close_trace():
        nonlocal prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
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
                                     global_batch_size(cfg), device)
            for i, tokens in prefetched(batch_fn, start, steps):
                run_step(i, tokens)
        else:
            for i in range(start, steps):
                run_step(i, synthetic_batch(cfg, i, seed).to(device))
    finally:
        # A step that raises still leaves its partial trace behind.
        if prof is not None:
            close_trace()
    return losses


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
    demo, or the HTTP ingress on WORKLOAD_SERVE_PORT). Not ported yet,
    raising NotImplementedError: multi-host rendezvous and meshes over
    several devices (item 11)."""
    env = os.environ
    processes = (int(env.get("TPUBC_NUM_HOSTS", "1"))
                 * int(env.get("TPUBC_NUM_SLICES", "1")))
    if (env.get("TPUBC_COORDINATOR_ADDRESS") and processes > 1) or env.get(
            "MEGASCALE_COORDINATOR_ADDRESS"):
        raise NotImplementedError(
            "multi-host training is not ported yet (ROADMAP queue 1 item "
            "11: multi-device)")
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
        mesh=parse_mesh_env(env.get("WORKLOAD_MESH", ""), 1),
        data=data,
        warmup_steps=int(env.get("WORKLOAD_WARMUP_STEPS", "0")),
        total_steps=steps if total_env is None else int(total_env),
        grad_clip_norm=float(env.get("WORKLOAD_GRAD_CLIP", "1.0")),
        attention=env.get("WORKLOAD_ATTENTION", "dense"),
        attention_block=int(env.get("WORKLOAD_ATTENTION_BLOCK", "512")),
        remat=env.get("WORKLOAD_REMAT", "").lower() in ("1", "true"),
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
