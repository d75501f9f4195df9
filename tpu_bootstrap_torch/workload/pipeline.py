"""Pipeline parallelism over the ``pipe`` mesh axis, the counterpart of
``tpu_bootstrap/workload/pipeline.py``: the GPipe and the 1F1B
(PipeDream-flush) microbatch schedules.

Layout: the blocks are stacked (``stack_block_params``: every block leaf
gains a leading num_layers axis) and ``sharding.param_specs`` puts ``pipe``
on that axis, so stage s holds layers [s L/P, (s+1) L/P) and their
optimizer moments. The embedding and the final norm are replicated over
``pipe``: stage 0 looks tokens up, stage P-1 runs the loss head.

Each stage's schedule is a generator that yields, once a tick, the
tensors it sends to the next stage and to the previous one (the
reference's two ppermutes, ``fperm``/``bperm``) and is sent what arrived
from each. On a mesh ``ring_attention._drive`` runs a rank's generator
with ``ring_attention.p2p_rotate`` over the ``pipe`` group (cyclic, global
peers, as the reference's perms); in one process
``ring_attention.lockstep`` steps every stage's generator together
(``pipeline_on_one_device``), the only way one card runs P stages.

Autograd cannot differentiate across a P2P hop, so both schedules take
their gradients by hand: a grad function ``(params, inputs, targets) ->
(loss, grads, stats)`` that ``train.make_train_step`` calls in place of
autograd. A stage computes on its layers gathered over the axes other than
``pipe`` (``sharding.stage_leaf``), as tensors it takes gradients of; each
microbatch's backward is ``torch.autograd.backward`` of the stage's output
with the cotangent that came back from stage s+1 (of the loss on stage
P-1), which accumulates into them; after the last tick every gradient is
summed over the ranks that share it and cut back to the rank's shard
(``sharding.stage_grad``): a block's over ``sharding.GRAD_AXES``, the
embedding's and the final norm's over ``pipe`` too.

- **GPipe** (``make_pipeline_grad``; ``make_pipeline_loss`` is its forward
  value): M + P - 1 forward ticks, stage s running microbatch t - s at
  tick t and keeping its autograd graph (M graphs a stage), then M + P - 1
  backward ticks in reverse microbatch order, cotangents one hop a tick.
- **1F1B** (``make_pipeline_1f1b_grad``): the reference's tick arithmetic
  (``f_turn``, T = 2M + 2(P-1)); F turns run under ``no_grad`` and stash the
  stage input in a P-slot ring, a B turn recomputes the stage with grad
  from the stash and backpropagates, so at most P inputs are held a stage.
  A stage after stage 0 banks each arriving activation in a P-slot ring
  keyed by m % P, since an F turn can run up to P - s ticks after its input
  arrives; stage 0 scatters its B turn's input cotangent into the
  embedding's gradient (the lookup's backward).

Bubble ticks compute nothing and send zeros. The MoE aux is the
reference's per-(microbatch, data shard) estimator: each layer's routing
means over the rank's microbatch rows, summed over the real microbatches
and the layers of every stage, divided by M L and averaged over the data
axes. ``remat`` recomputes each layer (``torch.utils.checkpoint``).

Inside a stage the port's mesh machinery stands in for the reference's
Megatron f/g pair (which repairs JAX's in-body AD): every rank of a stage
computes on whole layers, the attention core splits its heads over
``tensor`` in ``sharding.attention_region``, and an MoE layer exchanges
slots over ``expert`` (``moe.moe_mlp_manual``). With ``seq`` > 1 GPipe's
core is the ring (``ring_attention``, K3/K4 under flash) over the stage's
``seq`` group, and 1F1B's is ``_gathered_kv_attention``, as in the
reference. ``seq`` with an MoE model is refused, as the reference refuses
it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from tpu_bootstrap_torch.workload import moe, ring_attention, sharding
from tpu_bootstrap_torch.workload.model import (
    _attention,
    _mlp,
    _rms_norm,
    dense_attn_core,
    head_logits,
    repeat_kv,
)

SCHEDULES = ("gpipe", "1f1b")


def stack_block_params(blocks: list) -> dict:
    """A list of block dicts -> one dict whose leaves carry a leading
    (num_layers,) axis."""
    return {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}


def _gathered_kv_attention(q, k, v, *, mesh, n_shards: int):
    """The reference's 1F1B core under ``seq``: K/V gathered over the
    ``seq`` group (``sharding._SeqGather``: its backward sums the keys'
    gradients over ``seq`` and keeps this rank's), then this rank's query
    shard attends to the whole key space, masked on global positions, by
    an online softmax in f32 over the n_shards chunks, strictly future
    chunks skipped. The reference keeps this core because XLA's
    collective-permute inside a stage-divergent branch deadlocks; eager P2P
    does not, and the port keeps it for parity with the reference, whose
    ``dense`` and ``flash`` both run it without a kernel (torch ops here)."""
    block, heads, head_dim = q.shape[1], q.shape[2], q.shape[3]
    kf = sharding._SeqGather.apply(k.contiguous(), mesh)
    vf = sharding._SeqGather.apply(v.contiguous(), mesh)
    if kf.shape[2] != heads:
        kf, vf = repeat_kv(kf, heads), repeat_kv(vf, heads)
    idx = mesh.get_coordinate()[sharding.AXES.index("seq")]
    q_pos = idx * block + torch.arange(block, device=q.device)
    qf = q.float() * ring_attention._scale(head_dim)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((q.shape[0], heads, block), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    for j in range(min(idx + 1, n_shards)):  # later chunks: all masked
        k_pos = j * block + torch.arange(block, device=q.device)
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
        s = torch.einsum("bqhd,bkhd->bhqk", qf,
                         kf[:, j * block:(j + 1) * block].float())
        s = s.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]).masked_fill(~mask, 0.0)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p,
                          vf[:, j * block:(j + 1) * block].float())
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
    # Every causal row sees at least its own position, so l > 0.
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


def _apply_block(block: dict, x: torch.Tensor, cfg, attn_fn=None, *,
                 positions=None, moe_fn=None) -> tuple:
    """One transformer block: (x, aux), aux the MoE layer's load-balancing
    loss (``moe_fn``, default ``moe.moe_mlp_manual``) for a router block
    and 0 for a dense one."""
    x = x + _attention(block, x, cfg, attn_fn, positions)
    if "router" in block:
        m, aux = (moe_fn or moe.moe_mlp_manual)(
            block, _rms_norm(x, block["mlp_norm"]), cfg)
    else:
        m = _mlp(block, x, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + m, aux


def _tp_attn_setup(cfg, tp: int, attn_fn, mesh=None, seq: bool = False):
    """The tensor guards of both schedules, and the attention core split
    over ``tensor`` by heads (``sharding.attention_region``): the head and
    hidden dims must really shard, and a KV head count the tensor axis does
    not divide is expanded to the query heads before the split
    (expand-then-slice: each rank computes every KV head and keeps its
    query group's)."""
    if tp == 1:
        return attn_fn
    if cfg.num_heads % tp or cfg.mlp_dim % tp:
        raise ValueError(
            f"tensor parallelism inside the pipeline needs num_heads "
            f"({cfg.num_heads}) and mlp_dim ({cfg.mlp_dim}) divisible "
            f"by tensor={tp}")
    return sharding.attention_region(mesh, attn_fn or dense_attn_core,
                                     cfg.num_heads, cfg.kv_heads, seq)


def _spec_axis_positions(spec, axis_name: str) -> tuple:
    """Indices of a spec's dims sharded over ``axis_name``."""
    out = []
    for i, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (
            (entry,) if entry else ())
        if axis_name in names:
            out.append(i)
    return tuple(out)


def _check_pipeline_axes(mesh_cfg, allow_seq: bool = False,
                         allow_expert: bool = False) -> None:
    """The reference's construction-time guard: both schedules take every
    axis (callers allow seq and expert)."""
    axes = []
    if not allow_seq:
        axes.append("seq")
    if not allow_expert:
        axes.append("expert")
    allowed = "dcn/data/fsdp/tensor" + ("/seq" if allow_seq else "") + (
        "/expert" if allow_expert else "")
    for axis in axes:
        if getattr(mesh_cfg, axis) > 1:
            raise ValueError(
                f"this pipeline schedule composes with the {allowed} axes "
                f"only: mesh has {axis}={getattr(mesh_cfg, axis)}")


def _pipeline_layout(mesh_cfg, stacked_blocks: dict, *, n_stages: int,
                     M: int, batch: int, data_size: int) -> dict:
    """The guards both schedules share, and the blocks' specs
    (``sharding.param_specs`` of the stacked layout)."""
    num_layers = next(iter(stacked_blocks.values())).shape[0]
    if num_layers % n_stages != 0:
        raise ValueError(
            f"num_layers ({num_layers}) must divide evenly over "
            f"pipe stages ({n_stages})")
    if batch % M != 0:
        raise ValueError(f"batch {batch} must divide into {M} microbatches")
    if (batch // M) % data_size != 0:
        raise ValueError(
            f"microbatch size {batch // M} (batch {batch} / {M} "
            f"microbatches) must be divisible by the data-parallel extent "
            f"{data_size}")
    return sharding.param_specs(mesh_cfg,
                                {"blocks": stacked_blocks})["blocks"]


def _pipeline_attn_fn(cfg, n_seq: int = 1, mesh=None):
    """A stage's attention core: under GPipe with ``seq`` > 1 the ring's
    local bodies over the stage's ``seq`` group (K3/K4 a block under
    flash), else K3/K4 for flash and None (the dense core) for dense."""
    if n_seq > 1:
        return ring_attention.make_ring_attention(
            mesh, head_axis="tensor", attention=cfg.attention,
            block_size=cfg.attention_block)
    if cfg.attention == "flash":
        from tpu_bootstrap_torch.workload.flash_attention import \
            make_flash_attn_fn

        return make_flash_attn_fn(block_size=cfg.attention_block)
    return None


def _head_nll(y, final_norm, embed, targets, vocab_chunk: int = 0):
    """rms-norm, the tied-embedding head and the mean token nll, as
    ``model.loss_from_inputs`` computes them (``xent.chunked_mean_xent``
    when ``vocab_chunk`` > 0)."""
    h = _rms_norm(y, final_norm)
    if vocab_chunk > 0:
        from tpu_bootstrap_torch.workload.xent import chunked_mean_xent

        return chunked_mean_xent(h, embed, targets, vocab_chunk)
    logprobs = torch.log_softmax(head_logits(h, embed), dim=-1)
    return -torch.gather(logprobs, -1, targets[..., None].long())[..., 0] \
        .mean()


def _split_microbatches(a: torch.Tensor, M: int) -> torch.Tensor:
    """(batch, ...) -> (M, batch/M, ...), microbatch m the rows {i*M + m}.
    On a mesh ``a`` is the rank's contiguous rows, and its microbatch m,
    rows[m::M], is the reference's data shard of microbatch m."""
    return a.reshape(a.shape[0] // M, M, *a.shape[1:]).transpose(0, 1)


def f_turn(s: int, t: int, n_stages: int, M: int) -> tuple:
    """1F1B: (is_f, m) for stage s at tick t. Warm-up F_s(m) at tick s + m
    while m < P - s, then F_s(m) at tick 2m + s."""
    mw = t - s
    warm = 0 <= mw < min(n_stages - s, M)
    ms = mw // 2
    steady = mw >= 0 and mw % 2 == 0 and n_stages - s <= ms < M
    return warm or steady, min(max(mw if warm else ms, 0), M - 1)


def b_turn(s: int, t: int, n_stages: int, M: int) -> tuple:
    """1F1B: (is_b, m) for stage s at tick t: B_s(m) at tick
    2m + 2P - 1 - s."""
    roff = t - (2 * n_stages - 1 - s)
    return (roff >= 0 and roff % 2 == 0 and roff // 2 < M,
            min(max(roff // 2, 0), M - 1))


class _Stage:
    """One stage's share of a step: its layers and the embedding and final
    norm as tensors it takes gradients of (``grads``), its microbatches,
    the loss seeds and what it found."""

    def __init__(self, model, *, stage: int, n_stages: int, M: int,
                 blocks: dict, embed, final_norm, inputs, targets, attn_fn,
                 moe_fn, positions, remat: bool, degree: int):
        self.model = model
        self.s, self.P, self.M = stage, n_stages, M
        self.last = stage == n_stages - 1
        self.blocks, self.embed, self.final_norm = blocks, embed, final_norm
        self.inputs, self.targets = inputs, targets
        self.attn_fn, self.moe_fn, self.positions = attn_fn, moe_fn, positions
        self.remat = remat
        self.layers = next(iter(blocks.values())).shape[0]
        self.moe = model.num_experts > 0
        # The step's loss is the mean over the GRAD_AXES ranks of each
        # rank's sum over microbatches of loss_m / M (stage P-1) plus
        # coef * aux / (M L) (every stage): these seed the backward.
        self.head_seed = 1.0 / (M * degree)
        self.aux_scale = model.moe_aux_coef / (M * model.num_layers)
        self.degree = degree
        self.loss_sum = torch.zeros((), dtype=torch.float32,
                                    device=embed.device)
        self.active = self.peak = 0
        mb, seq = inputs.shape[1], inputs.shape[2]
        self.zeros = torch.zeros((mb, seq, model.embed_dim),
                                 dtype=model.compute_dtype,
                                 device=embed.device)

    def embed_in(self, m: int) -> torch.Tensor:
        return self.embed[self.inputs[m]].to(self.model.compute_dtype)

    def _one(self, blk, x):
        return _apply_block(blk, x, self.model, self.attn_fn,
                            positions=self.positions, moe_fn=self.moe_fn)

    def forward(self, x) -> tuple:
        """The stage's layers on x: (y, the layers' aux summed)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.layers):
            blk = {k: v[i] for k, v in self.blocks.items()}
            if self.remat and torch.is_grad_enabled():
                x, a = checkpoint(self._one, blk, x, use_reentrant=False)
            else:
                x, a = self._one(blk, x)
            aux = aux + a
        return x, aux

    def head(self, y, m: int):
        return _head_nll(y, self.final_norm, self.embed, self.targets[m],
                         self.model.vocab_chunk)

    def count(self, loss, aux) -> None:
        """Add microbatch m's share to the loss this stage reports."""
        if loss is not None:
            self.loss_sum += loss.detach().float() / self.M
        if self.moe:
            self.loss_sum += aux.detach() * self.aux_scale

    def backward(self, y, aux, loss, dy) -> None:
        """Microbatch m's backward through the stage: the loss head seeded
        on stage P-1, the cotangent that came back on the others, and the
        aux at its share of the loss."""
        outs, seeds = [], []
        if loss is not None:
            outs.append(loss)
            seeds.append(torch.full_like(loss, self.head_seed))
        else:
            outs.append(y)
            seeds.append(dy.to(y.dtype))
        if self.moe and aux.requires_grad:
            outs.append(aux)
            seeds.append(torch.full_like(aux, self.aux_scale / self.degree))
        torch.autograd.backward(outs, seeds)

    def local_loss(self) -> torch.Tensor:
        return self.loss_sum / self.degree


def _gpipe_body(st: _Stage, grads: bool):
    """GPipe on one stage: M + P - 1 forward ticks (stage s runs
    microbatch t - s at tick t, keeping its graph when ``grads``), then as
    many backward ticks, stage s running microbatch M - 1 - (u - (P-1-s))
    at tick u. Each phase's hops go one way; nothing is sent after a
    phase's last tick."""
    s, P, M = st.s, st.P, st.M
    T = M + P - 1
    kept, msg = {}, None
    for t in range(T):
        out, m = st.zeros, t - s
        if 0 <= m < M:
            with torch.set_grad_enabled(grads):
                x = (st.embed_in(m) if s == 0
                     else msg.detach().requires_grad_(grads))
                y, aux = st.forward(x)
                loss = st.head(y, m) if st.last else None
            st.count(loss, aux)
            st.active += 1
            if grads:
                kept[m] = (x, y, aux, loss)
                st.peak = max(st.peak, len(kept))
            out = y.detach()
        if t < T - 1:
            (msg,), _ = yield (out,), ()
    if not grads:
        return st
    msg = None
    for u in range(T):
        out, m = st.zeros, M - 1 - (u - (P - 1 - s))
        if 0 <= m < M:
            x, y, aux, loss = kept.pop(m)
            st.backward(y, aux, loss, msg)
            st.active += 1
            if s > 0:
                out = x.grad.to(st.model.compute_dtype)
        if u < T - 1:
            _, (msg,) = yield (), (out,)
    return st


def _1f1b_body(st: _Stage):
    """1F1B on one stage (the reference's PipeDream-flush, :854-965): one F
    or B turn a tick over T = 2M + 2(P-1) ticks, both hops every tick."""
    s, P, M = st.s, st.P, st.M
    T = 2 * M + 2 * (P - 1)
    in_buf, stash = {}, {}
    fwd_msg = bwd_msg = None
    for t in range(T):
        if s > 0:
            arrived, m_in = f_turn(s - 1, t - 1, P, M)
            if arrived:  # what stage s-1 ran at tick t-1
                in_buf[m_in % P] = fwd_msg
        is_f, m_f = f_turn(s, t, P, M)
        is_b, m_b = b_turn(s, t, P, M)
        y_out = dx_out = st.zeros
        if is_f:
            with torch.no_grad():
                x_in = (st.embed_in(m_f) if s == 0
                        else in_buf.pop(m_f % P))
                y_out, _ = st.forward(x_in)
            stash[m_f % P] = x_in
            st.peak = max(st.peak, len(stash))
        if is_b:
            x = stash.pop(m_b % P).detach().requires_grad_(True)
            with torch.enable_grad():
                y, aux = st.forward(x)
                loss = st.head(y, m_b) if st.last else None
            st.count(loss, aux)
            st.backward(y, aux, loss, bwd_msg)
            if s == 0:  # the lookup's backward: scatter into the embedding
                if st.embed.grad is None:
                    st.embed.grad = torch.zeros_like(st.embed)
                st.embed.grad.index_add_(
                    0, st.inputs[m_b].reshape(-1),
                    x.grad.reshape(-1, x.shape[-1]).to(st.embed.dtype))
            else:
                dx_out = x.grad.to(st.model.compute_dtype)
        st.active += int(is_f or is_b)
        if t < T - 1:
            (fwd_msg,), (bwd_msg,) = yield (y_out,), (dx_out,)
    return st


def _grad_of(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(t) if t.grad is None else t.grad


class _Pipeline:
    """A schedule's set-up from a TrainConfig and a mesh (or, with mesh
    None, ``stages`` stages in this process): the reference's
    construction guards, then ``run``."""

    def __init__(self, cfg, mesh, *, num_microbatches: int, remat: bool,
                 schedule: str, stages: int | None = None):
        model = cfg.model
        if mesh is None:
            self.mesh_cfg = sharding.MeshConfig(pipe=stages or 1)
        else:
            self.mesh_cfg = sharding.mesh_config(mesh)
        mc = self.mesh_cfg
        self.cfg, self.mesh, self.schedule, self.remat = (cfg, mesh,
                                                          schedule, remat)
        self.P, self.M = mc.pipe, num_microbatches
        if self.M < self.P:
            raise ValueError(
                f"num_microbatches ({self.M}) must be >= pipe stages "
                f"({self.P}) or stages sit idle an entire pass")
        _check_pipeline_axes(mc, allow_seq=True, allow_expert=True)
        tp, self.n_seq, n_ep = mc.tensor, mc.seq, mc.expert
        moe_model = model.num_experts > 0
        if self.n_seq > 1 and moe_model:
            raise ValueError(
                "pipeline seq parallelism does not compose with MoE "
                "(per-row routing would see only a sequence shard)")
        if n_ep > 1 and model.num_experts % n_ep != 0:
            raise ValueError(
                f"num_experts ({model.num_experts}) must divide over the "
                f"expert mesh axis ({n_ep}) for the pipeline's manual "
                f"all-to-all")
        if self.n_seq > 1 and schedule == "1f1b":
            core = (lambda q, k, v: _gathered_kv_attention(
                q, k, v, mesh=mesh, n_shards=self.n_seq))
        else:
            if (self.n_seq > 1 and tp > 1 and model.kv_heads % tp != 0):
                raise ValueError(
                    f"pipeline seq parallelism with tensor={tp} needs "
                    f"kv_heads ({model.kv_heads}) divisible by tensor (the "
                    f"ring rotates the sharded KV heads)")
            core = _pipeline_attn_fn(cfg, self.n_seq, mesh)
        self.attn_fn = _tp_attn_setup(model, tp, core, mesh, self.n_seq > 1)
        self.moe_fn = None
        if mesh is not None and n_ep > 1:
            group = sharding._group(mesh, "expert")
            self.moe_fn = (lambda block, h, c: moe.moe_mlp_manual(
                block, h, c, n_expert=n_ep, group=group))
        self.data_size = mc.dcn * mc.data * mc.fsdp * mc.expert
        self.ticks = (2 * self.M + 2 * (self.P - 1) if schedule == "1f1b"
                      else 2 * (self.M + self.P - 1))

    def _rows(self, x, batch):
        """This rank's rows of a whole batch (``batch`` None) or the rows
        given, and the batch's row count."""
        if self.mesh is None or batch is not None:
            return x, x.shape[0] if batch is None else batch
        from tpu_bootstrap_torch.workload.train import local_rows

        return local_rows(x, self.mesh), x.shape[0]

    def _check_seq(self, length: int) -> None:
        if length % self.n_seq != 0:
            raise ValueError(
                f"pipeline seq parallelism needs the (shifted) sequence "
                f"length {length} divisible by the seq mesh axis "
                f"{self.n_seq} (pick max_seq_len = k*seq + 1)")

    def run(self, params, inputs, targets, *, grads: bool = True,
            batch: int | None = None) -> tuple:
        """(loss, grads, stats): the step's loss on every rank; the
        gradients of the rank's shards (a tree like ``params``; None
        without ``grads``); stats {"active_ticks": F and B turns summed
        over the stages, "total_ticks": ticks times stages, "peak_stash":
        the most microbatch inputs or graphs a stage held for its
        backward}. ``inputs`` and ``targets`` are the whole batch, or with
        ``batch`` this rank's rows of a batch of that many rows."""
        blocks = params["blocks"]
        inputs, n_rows = self._rows(inputs, batch)
        targets, _ = self._rows(targets, batch)
        if self.schedule == "gpipe":
            self._check_seq(inputs.shape[1])
        specs = _pipeline_layout(self.mesh_cfg, blocks, n_stages=self.P,
                                 M=self.M, batch=n_rows,
                                 data_size=self.data_size)
        if self.schedule == "1f1b":
            self._check_seq(inputs.shape[1])
        expert = {k: bool(_spec_axis_positions(spec, "expert"))
                  for k, spec in specs.items()}
        mesh, positions = self.mesh, None
        if mesh is not None and self.n_seq > 1:
            inputs = sharding.seq_part(inputs, mesh)
            targets = sharding.seq_part(targets, mesh)
            positions = sharding.seq_positions(inputs.shape[1], mesh,
                                               inputs.device)
        inp = _split_microbatches(inputs, self.M)
        tgt = _split_microbatches(targets, self.M)

        def leaf(t, experts=True):
            return sharding.stage_leaf(t, experts).detach() \
                .requires_grad_(grads)

        held = {k: leaf(v, not expert[k]) for k, v in blocks.items()}
        embed, fnorm = leaf(params["embed"]), leaf(params["final_norm"])
        degree = sharding.grad_degree(mesh)

        def stage(s):
            if mesh is None:
                n = next(iter(held.values())).shape[0] // self.P
                mine = {k: v[s * n:(s + 1) * n] for k, v in held.items()}
            else:
                mine = held
            return _Stage(self.cfg.model, stage=s, n_stages=self.P, M=self.M,
                          blocks=mine, embed=embed, final_norm=fnorm,
                          inputs=inp, targets=tgt, attn_fn=self.attn_fn,
                          moe_fn=self.moe_fn, positions=positions,
                          remat=self.remat, degree=degree)

        def body(st):
            return (_1f1b_body(st) if self.schedule == "1f1b"
                    else _gpipe_body(st, grads))

        if mesh is None:
            done = ring_attention.lockstep(
                [body(stage(s)) for s in range(self.P)])
            loss = sum(st.local_loss() for st in done)
            active = sum(st.active for st in done)
            peak = max(st.peak for st in done)
        else:
            pipe = sharding._group(mesh, "pipe")
            s = mesh.get_coordinate()[sharding.AXES.index("pipe")]
            st = ring_attention._drive(body(stage(s)),
                                       ring_attention.p2p_rotate(pipe))
            loss = sharding._sum_over(st.local_loss().clone(), mesh,
                                      sharding.GRAD_AXES + ("pipe",))
            counts = torch.tensor([st.active, st.peak], dtype=torch.float32,
                                  device=embed.device)
            if self.P > 1:
                dist.all_reduce(counts[:1], group=pipe)
                dist.all_reduce(counts[1:], op=dist.ReduceOp.MAX, group=pipe)
            active, peak = int(counts[0]), int(counts[1])
        ticks = self.ticks if grads else self.M + self.P - 1
        stats = {"active_ticks": active, "total_ticks": ticks * self.P,
                 "peak_stash": peak}
        if not grads:
            return loss.detach(), None, stats
        out = {}
        for key in params:
            if key == "blocks":
                out[key] = {k: sharding.stage_grad(_grad_of(held[k]), v,
                                                   not expert[k])
                            for k, v in blocks.items()}
            else:
                t = embed if key == "embed" else fnorm
                out[key] = sharding.stage_grad(_grad_of(t), params[key],
                                               over_pipe=True)
        return loss.detach(), out, stats


def make_pipeline_apply(mesh, cfg, *, num_microbatches: int,
                        remat: bool = False, stages: int | None = None):
    """The GPipe schedule over ``mesh``'s ``pipe`` axis (with mesh None,
    ``stages`` stages in this process): the reference's construction
    guards (:481-526), and ``run(params, inputs, targets, grads=...,
    batch=None) -> (loss, grads, stats)``. ``cfg`` is a TrainConfig;
    params are the stacked layout (``train.init_train_state`` makes it
    when mesh.pipe > 1)."""
    return _Pipeline(cfg, mesh, num_microbatches=num_microbatches,
                     remat=remat, schedule="gpipe", stages=stages).run


def make_pipeline_loss(cfg, mesh, *, num_microbatches: int,
                       remat: bool = False, stages: int | None = None):
    """loss(params, inputs, targets) with the blocks pipelined under
    GPipe, forward only (no gradients): the step's loss on every rank, the
    mean token nll plus coef times the MoE aux."""
    run = make_pipeline_apply(mesh, cfg, num_microbatches=num_microbatches,
                              remat=remat, stages=stages)

    def loss(params, inputs, targets, batch: int | None = None):
        return run(params, inputs, targets, grads=False, batch=batch)[0]

    return loss


def make_pipeline_grad(cfg, mesh, *, num_microbatches: int,
                       remat: bool = False, stages: int | None = None):
    """GPipe's grad_fn(params, inputs, targets, batch=None) -> (loss,
    grads, stats): all M forwards keeping each microbatch's graph, then the
    M backwards in reverse, each seeded by the cotangent stage s+1 sent
    back. The reference takes this backward from AD of
    ``make_pipeline_loss``; autograd cannot cross the P2P hops."""
    run = make_pipeline_apply(mesh, cfg, num_microbatches=num_microbatches,
                              remat=remat, stages=stages)

    def grad_fn(params, inputs, targets, batch: int | None = None):
        return run(params, inputs, targets, grads=True, batch=batch)

    return grad_fn


def make_pipeline_1f1b_grad(cfg, mesh, *, num_microbatches: int,
                            remat: bool = False, stages: int | None = None):
    """1F1B (PipeDream-flush): grad_fn(params, inputs, targets,
    batch=None) -> (loss, grads, stats), at most P microbatch inputs held
    a stage (GPipe holds M graphs). ``grad_fn.schedule``: the ticks, the
    active turns a stage (2M) and the bubble fraction (P-1)/(M+P-1)."""
    pipe = _Pipeline(cfg, mesh, num_microbatches=num_microbatches,
                     remat=remat, schedule="1f1b", stages=stages)

    def grad_fn(params, inputs, targets, batch: int | None = None):
        return pipe.run(params, inputs, targets, grads=True, batch=batch)

    M, P = num_microbatches, pipe.P
    grad_fn.schedule = {"ticks": pipe.ticks, "active_per_stage": 2 * M,
                        "bubble_fraction": (P - 1) / (M + P - 1)}
    return grad_fn


def make_pipeline_step_grad(cfg, mesh, *, stages: int | None = None):
    """The grad function ``cfg.pipeline_schedule`` names, with
    ``cfg.num_microbatches`` (0: twice the stages) and ``cfg.remat``."""
    P = sharding.mesh_config(mesh).pipe if mesh is not None else stages
    M = cfg.num_microbatches or 2 * P
    make = {"gpipe": make_pipeline_grad,
            "1f1b": make_pipeline_1f1b_grad}.get(cfg.pipeline_schedule)
    if make is None:
        raise ValueError(
            f"unknown pipeline_schedule {cfg.pipeline_schedule!r} "
            "(expected 'gpipe' or '1f1b')")
    return make(cfg, mesh, num_microbatches=M, remat=cfg.remat,
                stages=stages)


def pipeline_on_one_device(cfg, params, inputs, targets, *, stages: int,
                           schedule: str | None = None,
                           num_microbatches: int | None = None) -> tuple:
    """Every stage of a ``stages``-stage pipeline in this process, stepped
    in lockstep (``ring_attention.lockstep``): (loss, grads, stats) of the
    stacked ``params`` (plain tensors on one device) on the whole batch.
    The launches are the mesh's: every stage's K3/K4 for every microbatch.
    ``schedule`` and ``num_microbatches`` default to the config's."""
    cfg = dataclasses.replace(
        cfg, pipeline_schedule=schedule or cfg.pipeline_schedule,
        num_microbatches=(cfg.num_microbatches if num_microbatches is None
                          else num_microbatches))
    return make_pipeline_step_grad(cfg, None, stages=stages)(
        params, inputs, targets)


__all__ = ["SCHEDULES", "make_pipeline_apply", "make_pipeline_loss",
           "make_pipeline_grad", "make_pipeline_1f1b_grad",
           "make_pipeline_step_grad", "pipeline_on_one_device",
           "stack_block_params"]
