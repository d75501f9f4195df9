"""Ring attention: causal attention with the sequence sharded over the
``seq`` axis of a mesh, the counterpart of
``tpu_bootstrap/workload/ring_attention.py``.

Each rank holds one sequence shard of q, k and v (batch, block, heads,
head_dim) and the KV shards travel one hop a step around the ring of the
``seq`` group (rank i sends to i+1 and receives from i-1, a
``dist.batch_isend_irecv`` pair), so memory stays O(seq/n) a rank. Only
the KV heads rotate; each fold expands them against the rank's query
heads.

A rank's forward folds the shards in the reference's order: its own
(diagonal) shard causally, then each earlier shard as it arrives, and it
skips a shard that lies wholly in its future. Two block cores, as in the
reference:

- ``_ring_attention_local``, the dense fold: an einsum online softmax in
  f32 (running max, sum and accumulator) with the causal mask on global
  positions;
- ``_ring_attention_local_flash``: kernel K3 (``flash_attention._fwd``) a
  block, causal on the diagonal and non-causal on the earlier shards, each
  block's (out, lse) merged into an f32 running pair by ``logaddexp``.

The backward is written by hand (``_Ring``), because autograd would run no
backward for a rotation whose output reaches nothing that needs a gradient:
rank 0 skips every earlier shard, and a per-hop autograd graph would leave
its neighbours waiting on a receive that never comes. It is the flash
decomposition on the merged rows' global lse and delta = rowsum(dO * O):
every block's gradients are exact on their own, so the backward needs no
merge. It runs two rings, each with the same sends on every rank: the KV
shards rotate forward again and each rank adds dq of its visible blocks
(K4's ``flash_dq`` on the flash core), while (q, dO, lse, delta) rotate
the other way and each rank adds dk/dv of its own KV shard against every
later query shard (K4's ``flash_dkv``). So no gradient travels: each rank
ends with dq, dk and dv of its own shards. The dense core's backward runs
the same decomposition on the plain versions (``attention_dq_plain``,
``attention_dkv_plain``). A rank with ``idx`` i launches i+1 forward
blocks, i+1 dq blocks and n-i dkv blocks.

The local bodies take the rotation as an argument (``rotate``): the mesh's
P2P ring (``p2p_rotate``), or in one process ``lockstep``, which steps the
bodies of every shard together and hands shard i what shard i-1 sent, so
that shard i at forward hop s holds the original KV shard (i-s-1) mod n.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from tpu_bootstrap_torch.workload import flash_attention as fa

_NEG = -1e30  # finite "minus infinity", as in the reference

CORES = ("dense", "flash")


@functools.lru_cache(maxsize=None)
def _scale(head_dim: int) -> float:
    """1 / sqrt(head_dim) in f32, bit for bit the reference's
    ``1.0 / jnp.sqrt(jnp.asarray(head_dim, jnp.float32))``, as a Python
    float (exact in f32): computed once per head dim on the host."""
    return float(np.float32(1.0) / np.sqrt(np.float32(head_dim)))


def _expand(t: torch.Tensor, heads: int) -> torch.Tensor:
    """KV heads repeated over their contiguous query groups."""
    return torch.repeat_interleave(t, heads // t.shape[2], dim=2)


# -- the forward of one rank, as a generator over the ring's hops ---------
#
# Each body yields (tensors sent forward, tensors sent backward) at every
# hop and is sent back what arrived from rank i-1 and from rank i+1; it
# returns its results. Every rank yields the same number of times.


def _dense_forward(q, k, v, idx: int, n: int):
    """The reference's dense fold (:58-148), op for op: own shard first,
    then n-1 rotations, each shard folded if it is not in the future.
    Returns (out in q.dtype, lse (b, block, h) f32)."""
    batch, block, heads, head_dim = q.shape
    scale = _scale(head_dim)
    qf = q.float()
    q_pos = idx * block + torch.arange(block, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((batch, heads, block), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((batch, heads, block), dtype=torch.float32,
                    device=q.device)
    k_blk, v_blk = k, v
    for s in range(n):
        if s:
            (k_blk, v_blk), _ = yield (k_blk, v_blk), ()
        src = (idx - s) % n
        if src > idx:
            continue  # wholly in the future: no matmul
        k_pos = src * block + torch.arange(block, device=q.device)
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
        scores = torch.einsum("bqhd,bkhd->bhqk", qf,
                              _expand(k_blk, heads).float()) * scale
        scores = scores.masked_fill(~mask, _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None]).masked_fill(~mask, 0.0)
        correction = torch.exp(m - m_new)
        l = correction * l + p.sum(dim=-1)
        pv = torch.einsum("bhqk,bkhd->bqhd", p, _expand(v_blk, heads).float())
        acc = acc * correction.transpose(1, 2)[..., None] + pv
        m = m_new
    out = acc / l.transpose(1, 2)[..., None]
    lse = (m + torch.log(l)).transpose(1, 2).contiguous()
    return out.to(q.dtype), lse


def _flash_forward(q, k, v, idx: int, n: int):
    """The reference's flash fold (:151-196): one causal K3 call on the
    diagonal shard, then per hop a non-causal call on each earlier shard,
    merged into the running (o, lse) by logaddexp in f32."""
    scale = float(q.shape[-1]) ** -0.5
    o, lse = fa._fwd(q, k, v, scale, True)
    o = o.float()
    k_blk, v_blk = k, v
    for s in range(1, n):
        (k_blk, v_blk), _ = yield (k_blk, v_blk), ()
        if (idx - s) % n < idx:
            o_b, lse_b = fa._fwd(q, k_blk, v_blk, scale, False)
            lse_new = torch.logaddexp(lse, lse_b)
            o = (o * torch.exp(lse - lse_new)[..., None]
                 + o_b.float() * torch.exp(lse_b - lse_new)[..., None])
            lse = lse_new
    return o.to(q.dtype), lse


def _backward(q, k, v, out, lse, dout, idx: int, n: int, core: str):
    """dq, dk, dv of this rank's shards from the merged rows' lse and
    delta = rowsum(dO * O). Hop s: the KV shard of rank (idx-s) arrives
    from behind (dq of the block when it is not in the future) and the
    query side of rank (idx+s) from ahead (dk/dv of the own KV shard
    against it when it is not in the past); the diagonal block is causal.
    Blocks add up in f32 and round once."""
    scale = (float(q.shape[-1]) ** -0.5 if core == "flash"
             else _scale(q.shape[-1]))
    dq_of, dkv_of = ((fa._dq, fa._dkv) if core == "flash"
                     else (fa.attention_dq_plain, fa.attention_dkv_plain))
    dout = dout.to(q.dtype).contiguous()
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kv, rows = (k, v), (q, dout, lse, delta)
    for s in range(n):
        if s:
            kv, rows = yield kv, rows
        if s <= idx:  # KV of rank idx - s, in this rank's past
            dq += dq_of(q, *kv, dout, lse, delta, scale, s == 0).float()
        if idx + s < n:  # queries of rank idx + s, in this KV's future
            qb, dob, lseb, deltab = rows
            dk_b, dv_b = dkv_of(qb, k, v, dob, lseb, deltab, scale, s == 0)
            dk += dk_b.float()
            dv += dv_b.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _drive(steps, rotate):
    """Run one rank's body, ``rotate`` carrying each hop's sends."""
    try:
        sent = next(steps)
        while True:
            sent = steps.send(rotate(*sent))
    except StopIteration as done:
        return done.value


def lockstep(bodies: list) -> list:
    """Run the bodies of all n shards in one process, hop by hop: shard i
    receives what shard i-1 sent forward and what shard i+1 sent back.
    Returns each body's result (every body stops at the same hop)."""
    n = len(bodies)
    sent, results = [None] * n, [None] * n

    def advance(i, message) -> bool:
        try:
            sent[i] = (next(bodies[i]) if message is None
                       else bodies[i].send(message))
        except StopIteration as done:
            results[i] = done.value
            return True
        return False

    finished = [advance(i, None) for i in range(n)]
    while not all(finished):
        arrived = [(sent[(i - 1) % n][0], sent[(i + 1) % n][1])
                   for i in range(n)]
        finished = [advance(i, arrived[i]) for i in range(n)]
    return results


def p2p_rotate(group):
    """One hop around the ring of ``group``: the forward tensors go to rank
    i+1 and arrive from i-1, the backward ones go to i-1 and arrive from
    i+1, all in one ``batch_isend_irecv``. Peers are global ranks."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)

    def rotate(forward: tuple, backward: tuple) -> tuple:
        ops, fin, bin_ = [], [], []
        for tensors, to, frm, got in ((forward, nxt, prv, fin),
                                      (backward, prv, nxt, bin_)):
            for t in tensors:
                t = t.contiguous()
                got.append(torch.empty_like(t))
                ops += [dist.P2POp(dist.isend, t, to, group),
                        dist.P2POp(dist.irecv, got[-1], frm, group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return tuple(fin), tuple(bin_)

    return rotate


_FORWARD = {"dense": _dense_forward, "flash": _flash_forward}


class _Ring(torch.autograd.Function):
    """A rank's ring attention: out in q's dtype, the hand-written backward
    of the module's docstring (the same sends on every rank)."""

    @staticmethod
    def forward(ctx, q, k, v, core, idx, n, rotate):
        out, lse = _drive(_FORWARD[core](q, k, v, idx, n), rotate)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.core, ctx.idx, ctx.n, ctx.rotate = core, idx, n, rotate
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _drive(_backward(q, k, v, out, lse, dout, ctx.idx, ctx.n,
                                 ctx.core), ctx.rotate)
        return (*grads, None, None, None, None)


def _ring_attention_local(q, k, v, *, idx: int, n_shards: int, rotate):
    """A rank's body with the dense fold: q, k, v (batch, block, heads,
    head_dim) are shard ``idx`` of ``n_shards``; k/v may carry fewer (GQA)
    heads. ``rotate`` moves a hop's tensors (``p2p_rotate``)."""
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                       "dense", idx, n_shards, rotate)


def _ring_attention_local_flash(q, k, v, *, idx: int, n_shards: int, rotate,
                                block_size: int = 512):
    """A rank's body with K3/K4 as the block core; ``block_size`` is
    validated as ``flash_attention`` validates it."""
    fa._check(q, k, v, block_size, None)
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                       "flash", idx, n_shards, rotate)


def ring_on_one_device(qs: list, ks: list, vs: list, douts: list | None,
                       attention: str = "flash") -> tuple:
    """The ring's bodies for every shard in this process (``lockstep``):
    (outs, (dqs, dks, dvs)) with douts, else (outs, None). The launches are
    the mesh's: every shard's forward blocks, and with douts every shard's
    dq and dk/dv blocks."""
    if attention not in CORES:
        raise ValueError(f"unknown attention {attention!r}")
    n = len(qs)
    with torch.no_grad():
        fwd = lockstep([_FORWARD[attention](q, k, v, i, n)
                        for i, (q, k, v) in enumerate(zip(qs, ks, vs))])
        outs = [o for o, _ in fwd]
        if douts is None:
            return outs, None
        grads = lockstep([
            _backward(q, k, v, o, lse, do, i, n, attention)
            for i, (q, k, v, (o, lse), do) in enumerate(
                zip(qs, ks, vs, fwd, douts))])
    return outs, tuple(list(g) for g in zip(*grads))


def make_ring_attention(mesh, seq_axis: str = "seq", batch_axes=None,
                        head_axis: str | None = None,
                        attention: str = "dense", block_size: int = 512):
    """An attention function (q, k, v) -> out over this rank's shards of
    (batch, seq, heads, head_dim) tensors, the sequence sharded over
    ``seq_axis`` of ``mesh`` (a DeviceMesh). ``batch_axes`` and
    ``head_axis`` are the reference's names for how batch and heads are
    already sharded: the ring moves KV along ``seq_axis`` only and runs on
    whatever rows and heads the rank holds, so they do not enter.
    ``attention`` picks the block core: "dense" (the einsum fold) or
    "flash" (K3/K4)."""
    if attention not in CORES:
        raise ValueError(f"unknown attention {attention!r}")
    dim = mesh.mesh_dim_names.index(seq_axis)
    n, idx = mesh.size(dim), mesh.get_local_rank(dim)
    rotate = p2p_rotate(mesh.get_group(dim)) if n > 1 else None

    def attn(q, k, v):
        if attention == "flash":
            return _ring_attention_local_flash(
                q, k, v, idx=idx, n_shards=n, rotate=rotate,
                block_size=block_size)
        return _ring_attention_local(q, k, v, idx=idx, n_shards=n,
                                     rotate=rotate)

    return attn


def reference_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Unsharded attention with the ring's semantics, the test oracle:
    f32 scores and softmax, GQA k/v expanded, out in q's dtype."""
    if k.shape[-2] != q.shape[-2]:
        k, v = _expand(k, q.shape[-2]), _expand(v, q.shape[-2])
    seq = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * _scale(q.shape[-1])
    if causal:
        keep = torch.ones(seq, seq, dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~keep, _NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


__all__ = ["make_ring_attention", "reference_attention"]
