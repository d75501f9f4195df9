"""Mesh and sharding rules for training, the counterpart of
``tpu_bootstrap/workload/sharding.py``.

The mesh has the reference's seven axes, slowest network outermost:
``dcn`` (data parallelism across slices), ``pipe``, ``data``, ``fsdp``
(data parallelism with parameters sharded along it, ZeRO-3), ``expert``,
``seq`` and ``tensor``. One process drives one device, so a mesh of n
devices is a process group of n ranks (NCCL on the card, gloo on the
CPU), and ``build_mesh`` lays the ranks out in rank order: with a
slice-major process space (``train.bootstrap_from_env``) whole slices fill
the ``dcn`` rows.

Parameters keep the reference's layout leaf by leaf (``param_specs``, the
reference's ``PartitionSpec`` as a tuple of axis names), placed as
DTensors (``param_shardings``, ``shard_params``): one placement a mesh
dimension, ``Shard(d)`` on every axis the spec names for tensor dim d.
The batch is ``Shard(0)`` over ``BATCH_AXES``.

The train step computes on each rank's local tensors inside
``torch.distributed.tensor.experimental.local_map`` regions with explicit
collectives (``gather``, ``batch_sum``), not through DTensor's operator
dispatch: DTensor's sharding propagation enumerates placements over every
mesh dimension, and on the seven-axis mesh one matmul of 8 gloo ranks did
not finish in 40 s on the CPU. A step gathers every parameter over the
axes that shard it (the ZeRO-3 all-gather), runs the model on the rank's
batch rows, and reduces each gradient over the batch axes back to the
parameter's own shard, so no partial gradient reaches the optimizer.

``seq`` splits a train step's sequence: each rank holds one shard of its
rows' positions, attention runs the ring (``ring_attention``) and the MoE
layer sees whole rows (``moe_layer``: gathered over ``seq`` and cut back).
LoRA and distillation, whose reference steps cut the batch only, run whole
rows on every ``seq`` rank. Either way params are replicated over ``seq``,
so a gradient sums over ``GRAD_AXES`` (the batch axes and ``seq``) and the
loss is divided by their degree. ``expert`` is a batch axis that also
shards the MoE expert stacks: a step keeps a rank's E/n experts (the
gathers skip ``expert``), and the layer exchanges slots by an all-to-all
pair over the ``expert`` group (``moe.moe_mlp_manual``), so those stacks'
gradients arrive whole and sum over the other axes only.

``pipe`` cuts the stacked blocks (the pipeline layout, ``param_specs``)
by layers: a step runs the schedules of ``pipeline.py``, which gather a
stage's layers over the other axes (``stage_leaf``, never over ``pipe``)
and reduce each gradient once a step (``stage_grad``): a block's over
``GRAD_AXES``, the embedding's and the final norm's over ``pipe`` too,
whose first and last stages hold their two halves.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from tpu_bootstrap_torch.workload import moe, quant
from tpu_bootstrap_torch.workload.model import ModelConfig, Params

AXES = ("dcn", "pipe", "data", "fsdp", "expert", "seq", "tensor")
BATCH_AXES = ("dcn", "data", "fsdp", "expert")
# Params are replicated over these and each rank computes a share of a
# step's loss on them: gradients and the loss sum over them.
GRAD_AXES = BATCH_AXES + ("seq",)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dcn: int = 1  # slices (multislice data parallelism)
    pipe: int = 1  # pipeline stages
    data: int = 1
    fsdp: int = 1
    expert: int = 1  # expert parallelism (MoE); a data axis elsewhere
    seq: int = 1
    tensor: int = 1

    @property
    def size(self) -> int:
        return (self.dcn * self.pipe * self.data * self.fsdp * self.expert
                * self.seq * self.tensor)

    @staticmethod
    def for_device_count(n: int) -> "MeshConfig":
        """The reference's default factorization: ``tensor`` up to 4, then
        ``fsdp`` up to 8, the rest to ``data`` (power-of-2 factors only;
        pipe, seq, expert and dcn are never defaulted)."""

        def pow2(m: int, cap: int) -> int:
            f = 1
            while f < cap and m % (f * 2) == 0:
                f *= 2
            return f

        tensor = pow2(n, 4)
        rest = n // tensor
        fsdp = pow2(rest, 8)
        return MeshConfig(data=rest // fsdp, fsdp=fsdp, tensor=tensor)


_MESH = None  # the mesh build_mesh made last: host_rows' default


def build_mesh(cfg: MeshConfig, device_type: str | None = None):
    """The process group's ranks as a DeviceMesh over the seven axes, in
    rank order. ``device_type`` None is the card (NCCL); "cpu" is gloo.
    Without a process group a size-1 ``cfg`` is the plain one-device path
    (None), and a larger one raises; a world of another size raises too."""
    global _MESH
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != cfg.size or (cfg.size > 1 and not dist.is_initialized()):
        raise ValueError(f"mesh needs {cfg.size} devices, have {world}")
    if not dist.is_initialized():
        return None
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device_type='cpu' for a gloo mesh "
            "on the host")
    from torch.distributed.device_mesh import init_device_mesh

    _MESH = init_device_mesh(
        device_type, tuple(getattr(cfg, a) for a in AXES),
        mesh_dim_names=AXES)
    return _MESH


def current_mesh():
    """The mesh ``build_mesh`` made last in this process, or None."""
    return _MESH


def degenerate_mesh(mesh) -> bool:
    """True for None only, the plain one-device path: a DeviceMesh, even
    of one device, is explicit placement, which is the point of it."""
    return mesh is None


def mesh_config(mesh) -> MeshConfig:
    """The extents of a built mesh (all 1 for None)."""
    if mesh is None:
        return MeshConfig()
    return MeshConfig(**{a: mesh.size(AXES.index(a)) for a in AXES})


def _spec_for(path: str, ndim: int) -> tuple:
    if path.endswith("embed"):
        return ("fsdp", "tensor")
    if path.endswith(("wq", "wk", "wv")):
        return ("fsdp", "tensor", None)
    if path.endswith("wo"):
        return ("tensor", None, "fsdp")
    if path.endswith("router"):
        return ("fsdp", None)
    if path.endswith(("w_up", "w_gate")):
        return (("expert", "fsdp", "tensor") if ndim == 3
                else ("fsdp", "tensor"))
    if path.endswith("w_down"):
        return (("expert", "tensor", "fsdp") if ndim == 3
                else ("tensor", "fsdp"))
    return (None,) * ndim  # norms: replicated


def _fit(spec: tuple, shape, cfg: MeshConfig) -> tuple:
    """Drop the mesh axes a dimension cannot tile evenly (MQA's single KV
    head against tensor > 1): replicating such a dimension is correct."""
    return tuple(None if name is None or dim % getattr(cfg, name) else name
                 for dim, name in zip(shape, spec))


def param_specs(mesh_cfg: MeshConfig, params: Params):
    """The reference's PartitionSpec of every leaf as a tuple of axis names
    (None: not sharded), from the config's extents alone. Quantized leaves
    give the same dataclass with the spec of ``q`` and ``s`` in their
    place; a stacked ``blocks`` dict (the pipeline layout) puts ``pipe``
    on the leading layer axis."""
    stacked = isinstance(params, dict) and isinstance(params.get("blocks"),
                                                      dict)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, path) for v in tree]
        if quant.is_quantized(tree):
            # The packed data's contraction dim over fsdp (and E over
            # expert); int8's per-column scales replicate, int4's group
            # scales shard like the contraction dim, expert scales over E.
            qspec = (("expert", "fsdp", None) if tree.q.ndim == 3
                     else ("fsdp", None))
            if tree.s.ndim == 3:
                sspec = ("expert", None, None)
            elif tree.s.ndim == 2:
                sspec = ("fsdp", None)
            else:
                sspec = (None,)
            return dataclasses.replace(
                tree, q=_fit(qspec, tree.q.shape, mesh_cfg),
                s=_fit(sspec, tree.s.shape, mesh_cfg))
        if stacked and path.startswith("/blocks"):
            spec = ("pipe", *_spec_for(path, tree.ndim - 1))
        else:
            spec = _spec_for(path, tree.ndim)
        return _fit(spec, tree.shape, mesh_cfg)

    return walk(params)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's placement: the mesh and one placement a mesh dimension."""
    mesh: object
    placements: tuple


def placements(spec: tuple) -> tuple:
    """A spec (axis name or None per tensor dim) as one placement per mesh
    dimension: Shard(d) on each axis the spec names for dim d."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(AXES)
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                out[AXES.index(name)] = Shard(d)
    return tuple(out)


def param_shardings(mesh, params: Params):
    """``param_specs`` on ``mesh``'s extents, as a ``Sharding`` a leaf (a
    quantized leaf: its dataclass with the ``q`` and ``s`` shardings)."""
    specs = param_specs(mesh_config(mesh), params)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if quant.is_quantized(tree):
            return dataclasses.replace(
                tree, q=Sharding(mesh, placements(tree.q)),
                s=Sharding(mesh, placements(tree.s)))
        return Sharding(mesh, placements(tree))

    return walk(specs)


def batch_shardings(mesh):
    """Token rows over every data-parallel axis (dcn and expert included);
    None on a degenerate mesh."""
    if degenerate_mesh(mesh):
        return None
    return Sharding(mesh, placements((BATCH_AXES, None)))


def replicated(mesh) -> Sharding:
    from torch.distributed.tensor import Replicate

    return Sharding(mesh, (Replicate(),) * len(AXES))


def _distribute(t: torch.Tensor, sh: Sharding):
    """``distribute_tensor`` from this rank's copy of the whole tensor
    (every rank holds the same one: a seeded init or a loaded file), so
    nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, sh.mesh, list(sh.placements),
                             src_data_rank=None)


def shard_params(params: Params, shardings) -> Params:
    """Each leaf placed by its sharding (quantized leaves: ``q`` and
    ``s``); a None sharding leaves the leaf as it is."""
    if isinstance(params, dict):
        return {k: shard_params(v, shardings[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [shard_params(v, s) for v, s in zip(params, shardings)]
    if shardings is None:
        return params
    if quant.is_quantized(params):
        return dataclasses.replace(params,
                                   q=_distribute(params.q, shardings.q),
                                   s=_distribute(params.s, shardings.s))
    return _distribute(params, shardings)


# -- the local side of a mesh step -----------------------------------------


def is_placed(t) -> bool:
    """A DTensor, or a quantized leaf whose data is one."""
    from torch.distributed.tensor import DTensor

    if quant.is_quantized(t):
        t = t.q
    return isinstance(t, DTensor)


def local(t) -> torch.Tensor:
    """The tensor this rank holds of a DTensor (its storage, not a copy);
    a plain tensor as it is."""
    if not is_placed(t):
        return t
    with torch.no_grad():
        return t.to_local()


def like(dt, local_tensor: torch.Tensor):
    """``local_tensor`` as a DTensor placed as ``dt`` is."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local_tensor, dt.device_mesh, dt.placements,
                              run_check=False, shape=dt.shape,
                              stride=dt.stride())


def place_rows(rows: torch.Tensor, mesh):
    """This rank's rows of a batch as the batch's DTensor (Shard(0) over
    BATCH_AXES)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(rows, mesh, batch_shardings(mesh).placements,
                              run_check=False)


def _group(mesh, axis: str):
    return mesh.get_group(AXES.index(axis))


def _size(mesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def dp_coordinate(mesh) -> tuple:
    """(this rank's index over BATCH_AXES, flattened with dcn outermost,
    the data-parallel degree): which rows of the global batch it holds."""
    if mesh is None:
        return 0, 1
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for axis in BATCH_AXES:
        n = _size(mesh, axis)
        index = index * n + coord[AXES.index(axis)]
        count *= n
    return index, count


def _sharded_axes(placements_, experts: bool = True,
                  pipe: bool = True) -> list:
    """(axis, tensor dim) of every mesh axis that shards the tensor, mesh
    order; ``experts`` False leaves ``expert`` out, ``pipe`` False
    ``pipe``."""
    return [(AXES[i], p.dim) for i, p in enumerate(placements_)
            if p.is_shard() and (experts or AXES[i] != "expert")
            and (pipe or AXES[i] != "pipe")]


def _all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = _size(mesh, axis)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=_group(mesh, axis))
    return torch.cat(parts, dim=dim)


def _own_part(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = _size(mesh, axis)
    if n == 1:
        return x
    return x.chunk(n, dim=dim)[mesh.get_coordinate()[AXES.index(axis)]]


def _sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    for axis in axes:
        if _size(mesh, axis) > 1:
            x = x.contiguous()
            dist.all_reduce(x, group=_group(mesh, axis))
    return x


def full(t, experts: bool = True, pipe: bool = True) -> torch.Tensor:
    """A DTensor gathered to the whole tensor on every rank (no autograd),
    or with ``experts`` False to its ``expert`` shard, with ``pipe`` False
    to its stage's layers; a plain tensor as it is."""
    if not is_placed(t):
        return t
    x = local(t)
    # Inner mesh axes first: the outer axis's chunks hold them whole.
    for axis, dim in reversed(_sharded_axes(t.placements, experts, pipe)):
        x = _all_gather(x, t.device_mesh, axis, dim)
    return x


class _Gather(torch.autograd.Function):
    """Forward: this rank's shard gathered over ``axes``. Backward: the
    gradient of the gathered tensor, which holds this rank's share of the
    loss only, summed over ``sums`` (the axes whose ranks hold other
    shares) and cut back to the rank's shard. The other axes (tensor)
    compute the same gradient on every rank, so they are cut, not
    summed."""

    @staticmethod
    def forward(ctx, x, mesh, axes, sums):
        ctx.mesh, ctx.axes, ctx.sums = mesh, axes, sums
        for axis, dim in reversed(axes):
            x = _all_gather(x, mesh, axis, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        g = _sum_over(g.clone(), ctx.mesh, ctx.sums)
        for axis, dim in ctx.axes:
            g = _own_part(g, ctx.mesh, axis, dim)
        return g.contiguous(), None, None, None


def gather(t, grad_leaf: torch.Tensor | None = None,
           experts: bool = True) -> torch.Tensor:
    """The whole tensor of DTensor ``t`` for this step's compute. With
    ``grad_leaf`` (``local(t)``, set to require grad) the gather is
    differentiable as ``_Gather`` says; without, it is a plain gather.
    ``experts`` False keeps an expert stack's ``expert`` shard (the rank's
    E/n experts): its gradient arrives whole through the MoE layer's
    all-to-all, so it sums over the other GRAD_AXES only. Quantized leaves
    gather ``q`` and ``s``."""
    if quant.is_quantized(t):
        return dataclasses.replace(t, q=full(t.q, experts),
                                   s=full(t.s, experts))
    if not is_placed(t):
        return t
    if grad_leaf is None:
        return full(t, experts)
    if t.device_mesh.size() == 1:
        return grad_leaf
    axes = _sharded_axes(t.placements, experts)
    kept = {a for a, _ in _sharded_axes(t.placements)} - {a for a, _ in axes}
    sums = tuple(a for a in GRAD_AXES if a not in kept)
    return _Gather.apply(grad_leaf, t.device_mesh, axes, sums)


def stage_leaf(t, experts: bool = True) -> torch.Tensor:
    """What a pipeline stage computes with of the DTensor ``t``: its
    layers (``pipe`` stays sharded) gathered over the other axes that
    shard it, ``expert`` too unless ``experts`` is False; no autograd (the
    schedules take gradients of this tensor and reduce them once a step,
    ``stage_grad``). A plain tensor as it is."""
    return full(t, experts, pipe=False)


def stage_grad(g: torch.Tensor, t, experts: bool = True,
               over_pipe: bool = False) -> torch.Tensor:
    """The gradient of ``stage_leaf(t, experts)`` this rank found, summed
    over the ranks that hold other shares of the loss and cut back to the
    rank's shard of ``t``, as ``_Gather``'s backward: over ``GRAD_AXES``
    less the axes that stay sharded (``expert`` for an expert stack), and
    over ``pipe`` with ``over_pipe`` (a leaf every stage holds whole whose
    gradient only some stages find: the embedding, the final norm)."""
    if not is_placed(t):
        return g
    mesh = t.device_mesh
    axes = _sharded_axes(t.placements, experts, pipe=False)
    kept = {a for a, _ in _sharded_axes(t.placements)} - {a for a, _ in axes}
    sums = tuple(a for a in GRAD_AXES if a not in kept)
    g = _sum_over(g.clone(), mesh, sums + (("pipe",) if over_pipe else ()))
    for axis, dim in axes:
        g = _own_part(g, mesh, axis, dim)
    return g.contiguous()


def gather_tree(tree, grads: dict | None = None, experts: bool = True):
    """``gather`` over a params tree; ``grads`` maps id(DTensor leaf) to
    the local leaf its gradient is taken with respect to."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, grads, experts) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_tree(v, grads, experts) for v in tree]
    return gather(tree, (grads or {}).get(id(tree)), experts)


class _BatchSum(torch.autograd.Function):
    """Sum over the batch axes, forward and backward: the gradient of a
    sum taken on every rank is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _sum_over(x.clone(), mesh, BATCH_AXES)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g.clone(), ctx.mesh, BATCH_AXES), None


def batch_mean(mesh):
    """x -> the mean of x over the ranks of the batch axes, differentiable
    (the MoE aux loss's global means), or None where there is one rank."""
    n = dp_coordinate(mesh)[1]
    if n == 1:
        return None
    return lambda x: _BatchSum.apply(x, mesh) / n


def grad_degree(mesh) -> int:
    """How many ranks share a step's loss: the product of GRAD_AXES."""
    if mesh is None:
        return 1
    return math.prod(_size(mesh, axis) for axis in GRAD_AXES)


def grad_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over GRAD_AXES (no autograd): the step's loss from the
    ranks' shares."""
    return _sum_over(x.detach().clone(), mesh, GRAD_AXES)


def grad_sq_norm(grads: list, leaves: list) -> torch.Tensor:
    """The squared global norm of gradients held as local shards of the
    DTensor ``leaves``: each rank counts its shard once over the ranks that
    hold a copy of it, and the world sums."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    mesh = None
    for g, p in zip(grads, leaves):
        mesh = p.device_mesh
        copies = mesh.size()
        for axis, _ in _sharded_axes(p.placements):
            copies //= _size(mesh, axis)
        total = total + g.float().square().sum() / copies
    if mesh is not None and mesh.size() > 1:
        dist.all_reduce(total)
    return total


def attention_region(mesh, core, num_heads: int, kv_heads: int,
                     seq: bool = False):
    """The attention core run under ``local_map`` over (BATCH_AXES, None,
    "tensor", None), or (BATCH_AXES, "seq", "tensor", None) where ``seq``
    says the step splits the sequence (the reference's ring spec), the
    counterpart of the reference's shard_map: each rank runs ``core``
    (K3/K4 for flash, the ring under ``seq``) on its batch rows, its
    positions and its share of the heads. q/k/v come in as the rank's
    rows with every head; a KV head count the tensor axis does not divide
    is expanded to the query heads first (the reference's repeat_kv rule).
    The output's heads are gathered back. With tensor 1 the region holds
    every head."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    from tpu_bootstrap_torch.workload.model import repeat_kv

    t = _size(mesh, "tensor")
    heads = placements((BATCH_AXES, "seq" if seq else None, "tensor",
                        None))
    # One output: its placements as a list (a tuple would read as one
    # placement list an output).
    region = local_map(core, out_placements=list(heads),
                       in_placements=(list(heads),) * 3, device_mesh=mesh)

    def attn(q, k, v):
        if t > 1:
            if kv_heads % t:
                k, v = repeat_kv(k, num_heads), repeat_kv(v, num_heads)
            q, k, v = (_Split.apply(x, mesh) for x in (q, k, v))
        args = [DTensor.from_local(x, mesh, heads, run_check=False)
                for x in (q, k, v)]
        out = region(*args).to_local()
        return _HeadGather.apply(out, mesh) if t > 1 else out

    return attn


class _Split(torch.autograd.Function):
    """This rank's heads (dim 2) over ``tensor``; backward gathers the
    heads' gradients, which every tensor rank then holds whole."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _own_part(x, mesh, "tensor", 2).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, "tensor", 2), None


class _HeadGather(torch.autograd.Function):
    """Every head gathered over ``tensor``; backward keeps this rank's
    heads of a gradient every tensor rank holds alike."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather(x, mesh, "tensor", 2)

    @staticmethod
    def backward(ctx, g):
        return _own_part(g, ctx.mesh, "tensor", 2).contiguous(), None


class _SeqGather(torch.autograd.Function):
    """Whole rows gathered over ``seq`` on dim 1; backward sums the rows'
    gradients over ``seq`` (each rank's share of the loss) and keeps this
    rank's positions."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_gather(x, mesh, "seq", 1)

    @staticmethod
    def backward(ctx, g):
        g = _sum_over(g.clone(), ctx.mesh, ("seq",))
        return _own_part(g, ctx.mesh, "seq", 1).contiguous(), None


def seq_part(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's shard of x's dim 1 (positions) over ``seq``."""
    return _own_part(x, mesh, "seq", 1)


def seq_positions(length: int, mesh, device) -> torch.Tensor:
    """The global positions of this rank's ``length`` positions."""
    start = length * mesh.get_coordinate()[AXES.index("seq")]
    return torch.arange(start, start + length, device=device)


def moe_layer(mesh, seq: bool = False):
    """The MoE layer of a mesh step, (block, h, cfg) -> (out, aux):
    ``moe.moe_mlp_manual`` with the aux's routing means over the batch
    (``batch_mean``), over the ``expert`` group's all-to-all pair where
    the config's stacks shard over ``expert`` (``_fit`` keeps it when
    ``expert`` divides num_experts; otherwise the stacks are whole and
    ``expert`` is only more batch). With ``seq`` (a step that splits the
    sequence) h is gathered to whole rows first, so routing and capacity
    are the reference's, and the output cut back to the rank's positions:
    every ``seq`` rank computes the same aux, which enters the loss once
    through the division by ``grad_degree``."""
    n_ep = _size(mesh, "expert")
    group = _group(mesh, "expert") if n_ep > 1 else None
    mean = batch_mean(mesh)
    seq = seq and _size(mesh, "seq") > 1

    def layer(block, h, cfg):
        n = n_ep if cfg.num_experts % n_ep == 0 else 1
        if seq:
            h = _SeqGather.apply(h, mesh)
        out, aux = moe.moe_mlp_manual(block, h, cfg, n_expert=n,
                                      batch_mean=mean, group=group)
        return (seq_part(out, mesh) if seq else out), aux

    return layer


__all__ = [
    "BATCH_AXES",
    "MeshConfig",
    "build_mesh",
    "degenerate_mesh",
    "param_shardings",
    "batch_shardings",
    "replicated",
    "shard_params",
    "ModelConfig",
]
