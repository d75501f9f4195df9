"""The rank programs of the port's spawned gloo worlds, and the spawner.

``tests/test_torch_mesh_train.py``, ``tests/test_torch_mesh_finetune.py``,
``tests/test_torch_ring_attention.py``, ``tests/test_torch_mesh_parallel.py``,
``tests/test_torch_pipeline.py`` and ``tests/test_torch_pipeline_1f1b.py``
compute the JAX reference's values
in their own process, write the inputs (params carried over by
``bridge.params_from_numpy``, tokens) to ``inputs.pt`` in a temporary
directory, and start a world of gloo ranks:

    python tests/test_torch_mesh_ranks.py <program> <rank> <world> <dir>

Each rank imports torch and the port only (no JAX), runs on one thread,
joins the group through a FileStore in <dir>, runs every case of its
program in order and writes what it found to <dir>/rank<r>.pt. This file
holds no tests of its own.
"""

from __future__ import annotations

import copy
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SPAWN_TIMEOUT_S = 300


def spawn_world(program: str, world: int, directory, inputs: dict,
                timeout: float = SPAWN_TIMEOUT_S) -> list:
    """Run ``program`` on ``world`` ranks; returns each rank's results. A
    rank that exits non-zero fails the call with its stderr, and every
    rank still running is killed on the way out."""
    import torch

    directory = Path(directory)
    torch.save(inputs, directory / "inputs.pt")
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        ("TPUBC_", "WORKLOAD_", "JOB_COMPLETION"))}
    env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    try:
        for rank in range(world):
            log = open(directory / f"rank{rank}.log", "w+b")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, __file__, program, str(rank), str(world),
                 str(directory)], env=env, cwd=str(ROOT), stdout=log,
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                r = failed[0] if failed else None
                tail = b""
                if r is not None:
                    logs[r].seek(0)
                    tail = logs[r].read()[-4000:]
                raise RuntimeError(
                    f"{program}: rank {r} failed" if failed else
                    f"{program}: world timed out after {timeout} s"
                ) from RuntimeError(tail.decode(errors="replace"))
            time.sleep(0.05)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                logs[r].seek(0)
                raise RuntimeError(f"{program}: rank {r} failed:\n"
                                   + logs[r].read()[-4000:].decode())
        return [torch.load(directory / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()


def _leaves_with_paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, f"{path}/{i}")
    else:
        yield path, tree


def _fresh(tree):
    return copy.deepcopy(tree)


def mesh_train(inp: dict) -> dict:
    import torch

    from tpu_bootstrap_torch.workload import model, sharding, train

    out = {}
    mcfg = model.ModelConfig(**inp["model"])
    tokens = inp["tokens"]
    # The reference's sharded-loss meshes (tests/test_workload.py:45-73):
    # one step's pre-update loss from the reference's params.
    for name, mc in inp["loss_meshes"].items():
        cfg = train.TrainConfig(model=mcfg, mesh=sharding.MeshConfig(**mc))
        mesh = sharding.build_mesh(cfg.mesh, "cpu")
        params = _fresh(inp["params"])
        shardings = sharding.param_shardings(mesh, params)
        params = sharding.shard_params(params, shardings)
        if name == "3d":
            out["local_shapes"] = {
                p: tuple(sharding.local(x).shape)
                for p, x in _leaves_with_paths(params)}
            out["placements"] = all(
                tuple(x.placements) == tuple(s.placements)
                for (_, x), (_, s) in zip(_leaves_with_paths(params),
                                          _leaves_with_paths(shardings)))
        step = train.make_train_step(cfg, mesh)
        _, _, loss = step(params, train.make_optimizer(cfg).init(params),
                          tokens)
        out[("loss", name)] = float(loss)
    mesh3 = dict(data=2, fsdp=2, tensor=2)
    # Five steps descend (tests/test_workload.py:86-99).
    cfg = train.TrainConfig(mesh=sharding.MeshConfig(**mesh3),
                            learning_rate=1e-2)
    mesh = sharding.build_mesh(cfg.mesh, "cpu")
    params, opt_state = train.init_train_state(cfg, seed=0, mesh=mesh)
    step = train.make_train_step(cfg, mesh)
    out["descend"] = []
    for _ in range(5):
        params, opt_state, loss = step(params, opt_state, inp["tokens64"])
        out["descend"].append(float(loss))
    # Remat against no remat (:108-120).
    out["remat"] = []
    for remat in (False, True):
        cfg = train.TrainConfig(mesh=sharding.MeshConfig(**mesh3),
                                remat=remat)
        params, opt_state = train.init_train_state(cfg, seed=0, mesh=mesh)
        _, _, loss = train.make_train_step(cfg, mesh)(params, opt_state,
                                                      tokens)
        out["remat"].append(float(loss))
    # Flash with MQA over tensor 2: the repeat_kv route.
    mqa = model.ModelConfig(**inp["mqa_model"])
    cfg = train.TrainConfig(model=mqa, attention="flash",
                            mesh=sharding.MeshConfig(tensor=2, data=4))
    mesh = sharding.build_mesh(cfg.mesh, "cpu")
    params = _fresh(inp["mqa_params"])
    params = sharding.shard_params(params,
                                   sharding.param_shardings(mesh, params))
    _, _, loss = train.make_train_step(cfg, mesh)(
        params, train.make_optimizer(cfg).init(params), tokens)
    out["flash_mqa"] = float(loss)
    # num_heads % tensor with the flash core.
    cfg = train.TrainConfig(model=mcfg, attention="flash",
                            mesh=sharding.MeshConfig(tensor=8))
    try:
        train.make_train_step(cfg, sharding.build_mesh(cfg.mesh, "cpu"))
        out["heads_error"] = None
    except ValueError as e:
        out["heads_error"] = str(e)
    out["run_demo"] = train.run_demo(steps=2, device="cpu")
    # Two steps of train_loop on the mesh (its own init and batches).
    cfg = train.TrainConfig(model=model.ModelConfig(**inp["loop_model"]),
                            mesh=sharding.MeshConfig(**mesh3),
                            grad_clip_norm=1.0, warmup_steps=1,
                            total_steps=4)
    out["loop"] = train.train_loop(cfg, 2, device="cpu")
    # MoE on a data x tensor mesh: the aux loss over the whole batch.
    moe = model.ModelConfig(**inp["moe_model"])
    cfg = train.TrainConfig(model=moe, learning_rate=1e-2,
                            mesh=sharding.MeshConfig(data=4, tensor=2))
    mesh = sharding.build_mesh(cfg.mesh, "cpu")
    params, opt_state = train.init_train_state(cfg, seed=3, mesh=mesh)
    step = train.make_train_step(cfg, mesh)
    out["moe"] = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, tokens)
        out["moe"].append(float(loss))
    out["dp"] = sharding.dp_coordinate(mesh)
    del torch
    return out


def mesh_finetune(inp: dict) -> dict:
    import torch

    from tpu_bootstrap_torch.workload import (checkpoint, data, distill,
                                              lora, model, quant, sharding,
                                              train)

    out = {}
    d = Path(inp["dir"])
    mesh_cfg = sharding.MeshConfig(data=2, fsdp=2, tensor=2)
    mesh = sharding.build_mesh(mesh_cfg, "cpu")
    # Checkpoint resume (tests/test_checkpoint.py).
    cfg = train.TrainConfig(model=model.ModelConfig(**inp["ckpt_model"]),
                            mesh=mesh_cfg)
    run = dict(device="cpu", mesh=mesh)
    out["full"] = train.train_loop(cfg, 6, checkpoint_dir=str(d / "full"),
                                   save_every=2, **run)
    out["first"] = train.train_loop(cfg, 3, checkpoint_dir=str(d / "part"),
                                    save_every=1, **run)
    out["resumed"] = train.train_loop(cfg, 6,
                                      checkpoint_dir=str(d / "part"),
                                      save_every=1, **run)
    out["again"] = train.train_loop(cfg, 6, checkpoint_dir=str(d / "part"),
                                    save_every=1, **run)
    params, opt_state = train.init_train_state(cfg, seed=0, mesh=mesh)
    mgr = checkpoint.make_manager(str(d / "ck"))
    checkpoint.save(mgr, 1, params, opt_state)
    r_params, r_opt = checkpoint.restore(mgr, 1, mesh=mesh)
    want = sharding.param_shardings(mesh, r_params)
    out["restored_equal"] = all(
        torch.equal(sharding.local(a), sharding.local(b))
        for a, b in zip(train.tree_leaves(r_params),
                        train.tree_leaves(params)))
    out["restored_placed"] = all(
        tuple(a.placements) == tuple(s.placements)
        for a, s in zip(train.tree_leaves(r_params),
                        train.tree_leaves(want)))
    out["moments_placed"] = all(
        tuple(m.placements) == tuple(p.placements)
        for m, p in zip(r_opt["mu"] + r_opt["nu"],
                        2 * train.tree_leaves(r_params)))
    # This rank's rows of a file batch (tests/test_data.py:69-75).
    get = data.make_batch_fn(data.DataConfig(path=inp["token_file"]), 16, 8,
                             "cpu", mesh=mesh)
    batch = get(5)
    out["rows"] = sharding.local(batch).clone()
    out["rows_placed"] = tuple(batch.placements) == tuple(
        sharding.batch_shardings(mesh).placements)
    out["dp"] = sharding.dp_coordinate(mesh)
    out["full_batch"] = sharding.full(batch).clone()
    # LoRA, QLoRA and LoRA's checkpoint resume (tests/test_lora.py:96,
    # :121, :218).
    lcfg = lora.LoraConfig(rank=4, alpha=8.0)
    tcfg = train.TrainConfig(model=model.ModelConfig(**inp["lora_model"]),
                             learning_rate=1e-2)
    for name, base in (("lora", inp["base"]),
                       ("qlora", quant.quantize_params(inp["base"]))):
        step, opt = lora.make_lora_train_step(tcfg, mesh, base, lcfg)
        adapters = lora.init_lora(base, lcfg, seed=2, device="cpu")
        opt_state = opt.init(adapters)
        out[name] = []
        for _ in range(3):
            adapters, opt_state, loss = step(adapters, opt_state,
                                             inp["lora_tokens"])
            out[name].append(float(loss))
    qbase = train.place_state(
        quant.quantize_params(inp["base"]),
        sharding.param_shardings(mesh, quant.quantize_params(inp["base"])))
    wq = qbase["blocks"][0]["wq"]
    out["qlora_wq"] = (tuple(wq.q.placements), tuple(
        sharding.local(wq.q).shape))
    step, opt = lora.make_lora_train_step(tcfg, mesh, inp["base"], lcfg)
    mgr = checkpoint.make_manager(str(d / "lora"), max_to_keep=4)
    adapters = lora.init_lora(inp["base"], lcfg, seed=2, device="cpu")
    opt_state = opt.init(adapters)
    out["lora_ckpt"] = []
    for i in range(4):
        adapters, opt_state, loss = step(adapters, opt_state,
                                         inp["lora_tokens"])
        out["lora_ckpt"].append(float(loss))
        checkpoint.save(mgr, i + 1, adapters, opt_state)
    adapters, opt_state = checkpoint.restore(mgr, 2, mesh=mesh)
    out["lora_resumed"] = []
    for _ in range(2):
        adapters, opt_state, loss = step(adapters, opt_state,
                                         inp["lora_tokens"])
        out["lora_resumed"].append(float(loss))
    # Distillation (tests/test_distill.py:158), the teacher captured and
    # passed.
    student_cfg = model.ModelConfig(**inp["student_model"])
    teacher_cfg = model.ModelConfig(**inp["teacher_model"])
    for as_arg in (False, True):
        step, opt = distill.make_distill_step(
            student_cfg, inp["teacher"], teacher_cfg, mesh,
            learning_rate=1e-2, teacher_as_arg=as_arg)
        student = _fresh(inp["student"])
        opt_state = opt.init(student)
        losses = []
        for i in range(3):
            args = (student, inp["teacher"]) if as_arg else (student,)
            student, opt_state, loss = step(*args, opt_state,
                                            inp["distill_tokens"][i])
            losses.append(float(loss))
        out[("distill", as_arg)] = losses
    out["student_placed"] = all(
        tuple(a.placements) == tuple(s.placements)
        for a, s in zip(train.tree_leaves(student), train.tree_leaves(
            sharding.param_shardings(mesh, student))))
    return out


def file_resume(inp: dict) -> dict:
    from tpu_bootstrap_torch.workload import data, model, sharding, train

    d = Path(inp["dir"])
    cfg = train.TrainConfig(
        model=model.ModelConfig(**inp["ckpt_model"]),
        mesh=sharding.MeshConfig(data=2, tensor=2),
        data=data.DataConfig(path=inp["token_file"]), grad_clip_norm=1.0,
        warmup_steps=2, total_steps=6)
    kw = dict(device="cpu")
    full = train.train_loop(cfg, 6, checkpoint_dir=str(d / "full"),
                            save_every=2, **kw)
    first = train.train_loop(cfg, 3, checkpoint_dir=str(d / "part"),
                             save_every=1, **kw)
    resumed = train.train_loop(cfg, 6, checkpoint_dir=str(d / "part"),
                               save_every=1, **kw)
    return {"full": full, "first": first, "resumed": resumed}


def dtensor_matmul(inp: dict) -> dict:
    """One einsum of a batch-sharded activation and a weight sharded as
    wq is, through DTensor's operator dispatch, on a mesh of the axes in
    ``inp["axes"]`` (the world's 8 ranks over data, fsdp and tensor)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    axes = inp["axes"]
    shape = tuple(2 if a in ("data", "fsdp", "tensor") else 1 for a in axes)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    w_place = [Replicate()] * len(axes)
    w_place[axes.index("fsdp")] = Shard(0)
    w_place[axes.index("tensor")] = Shard(1)
    x_place = [Replicate()] * len(axes)
    x_place[axes.index("data")] = x_place[axes.index("fsdp")] = Shard(0)
    gen = torch.Generator()
    gen.manual_seed(0)
    w = distribute_tensor(torch.randn(64, 4, 16, generator=gen), mesh,
                          w_place, src_data_rank=None)
    x = distribute_tensor(torch.randn(8, 32, 64, generator=gen), mesh,
                          x_place, src_data_rank=None)
    t0 = time.perf_counter()
    torch.einsum("bse,ehd->bshd", x, w)
    return {"einsum_s": time.perf_counter() - t0}


def _mesh_of(cache: dict, extents: dict):
    """build_mesh of ``extents`` on gloo, built once per world."""
    from tpu_bootstrap_torch.workload import sharding

    key = tuple(sorted(extents.items()))
    if key not in cache:
        cache[key] = sharding.build_mesh(sharding.MeshConfig(**extents),
                                         "cpu")
    return cache[key]


def ring(inp: dict) -> dict:
    """tests/test_torch_ring_attention.py: each case's ring on this rank's
    shards (the sequence over seq, heads over tensor with ``heads``), its
    output and, with ``grad``, the gradients of sum(out^2); ``model``
    cases the rank's share of the loss. ``lockstep`` cases also run
    ring_attention.ring_on_one_device on every shard, on rank 0."""
    import torch
    import torch.distributed as dist

    from tpu_bootstrap_torch.workload import model, ring_attention, sharding

    meshes, out = {}, {}
    for name, case in inp["cases"].items():
        mesh = _mesh_of(meshes, case["mesh"])
        coord = mesh.get_coordinate()
        n = case["mesh"]["seq"]
        seq_i = coord[sharding.AXES.index("seq")]

        def part(x, heads=case.get("heads")):
            x = sharding.seq_part(x, mesh)
            if heads:
                x = sharding._own_part(x, mesh, "tensor", 2)
            return x.contiguous()

        ring = ring_attention.make_ring_attention(
            mesh, batch_axes=(), head_axis="tensor" if case.get("heads")
            else None, attention=case["attention"],
            block_size=case.get("block_size", 512))
        if "model" in case:
            cfg = model.ModelConfig(**case["model"])
            tokens = case["tokens"]
            inputs, targets = (part(t) for t in (tokens[:, :-1],
                                                  tokens[:, 1:]))
            loss = model.loss_from_inputs(
                case["params"], inputs, targets, cfg, attn_fn=ring,
                positions=sharding.seq_positions(inputs.shape[1], mesh,
                                                 "cpu"))
            out[name] = {"loss_share": float(sharding.grad_sum(loss, mesh)
                                             / sharding.grad_degree(mesh))}
            continue
        q, k, v = (part(case[x]).requires_grad_(case.get("grad", False))
                   for x in "qkv")
        o = ring(q, k, v)
        rec = {"seq": seq_i, "tensor": coord[sharding.AXES.index("tensor")],
               "out": o.detach()}
        if case.get("grad"):
            rec["grads"] = torch.autograd.grad(o, (q, k, v), 2 * o)
        if case.get("lockstep") and dist.get_rank() == 0:
            shards = [list(case[x].chunk(n, dim=1)) for x in "qkv"]
            outs, _ = ring_attention.ring_on_one_device(
                *shards, None, case["attention"])
            rec["lockstep"] = ring_attention.ring_on_one_device(
                *shards, [2 * o_i for o_i in outs], case["attention"])
        out[name] = rec
    return out


def _train_losses(case: dict, meshes: dict, probe=None) -> list:
    """``case["steps"]`` steps of train.make_train_step on the case's mesh
    from its params, the whole batch each step."""
    from tpu_bootstrap_torch.workload import model, sharding, train

    cfg = train.TrainConfig(
        model=model.ModelConfig(**case["model"]),
        mesh=sharding.MeshConfig(**case["mesh"]),
        learning_rate=case.get("lr", 3e-4),
        attention=case.get("attention", "dense"),
        attention_block=case.get("block", 512),
        remat=case.get("remat", False))
    mesh = _mesh_of(meshes, case["mesh"])
    params = sharding.shard_params(
        _fresh(case["params"]),
        sharding.param_shardings(mesh, case["params"]))
    opt_state = train.make_optimizer(cfg).init(params)
    step = train.make_train_step(cfg, mesh)
    losses = []
    for i in range(case["steps"]):
        if probe is not None and i == 0:
            probe["local_w_up"] = tuple(sharding.local(
                params["blocks"][0]["w_up"]).shape)
            probe["gathers"] = []
            plain = sharding._all_gather

            def counted(x, mesh_, axis, dim):
                probe["gathers"].append(axis)
                return plain(x, mesh_, axis, dim)

            sharding._all_gather = counted
            try:
                params, opt_state, loss = step(params, opt_state,
                                               case["tokens"])
            finally:
                sharding._all_gather = plain
        else:
            params, opt_state, loss = step(params, opt_state,
                                           case["tokens"])
        losses.append(float(loss))
    return losses


def mesh_parallel(inp: dict) -> dict:
    """tests/test_torch_mesh_parallel.py: train steps on seq, expert and
    expert x seq meshes, a seq mesh's refusal, LoRA on a seq mesh and
    distillation from an MoE teacher on an expert x seq mesh."""
    from tpu_bootstrap_torch.workload import (distill, lora, model, sharding,
                                              train)

    meshes, out = {}, {}
    for name, case in inp["train"].items():
        probe = {} if name == inp["probe"] else None
        out[("train", name)] = _train_losses(case, meshes, probe)
        if probe is not None:
            out["probe"] = probe
    bad = inp["seq_error"]
    cfg = train.TrainConfig(model=model.ModelConfig(**bad["model"]),
                            mesh=sharding.MeshConfig(**bad["mesh"]))
    try:
        train.make_train_step(cfg, _mesh_of(meshes, bad["mesh"]))
        out["seq_error"] = None
    except ValueError as e:
        out["seq_error"] = str(e)
    case = inp["lora"]
    tcfg = train.TrainConfig(model=model.ModelConfig(**case["model"]),
                             learning_rate=case["lr"])
    step, opt = lora.make_lora_train_step(
        tcfg, _mesh_of(meshes, case["mesh"]), case["base"],
        lora.LoraConfig(**case["lcfg"]))
    adapters = _fresh(case["adapters"])
    opt_state = opt.init(adapters)
    out["lora"] = []
    for _ in range(case["steps"]):
        adapters, opt_state, loss = step(adapters, opt_state,
                                         case["tokens"])
        out["lora"].append(float(loss))
    case = inp["distill"]
    step, opt = distill.make_distill_step(
        model.ModelConfig(**case["student_model"]), case["teacher"],
        model.ModelConfig(**case["teacher_model"]),
        _mesh_of(meshes, case["mesh"]), learning_rate=case["lr"])
    student = _fresh(case["student"])
    opt_state = opt.init(student)
    out["distill"] = []
    for tokens in case["tokens"]:
        student, opt_state, loss = step(student, opt_state, tokens)
        out["distill"].append(float(loss))
    return out


def _pipe_cfg(case: dict):
    from tpu_bootstrap_torch.workload import model, sharding, train

    return train.TrainConfig(
        model=model.ModelConfig(**case["model"]),
        mesh=sharding.MeshConfig(**case["mesh"]),
        learning_rate=case.get("lr", 3e-4),
        attention=case.get("attention", "dense"),
        attention_block=case.get("block", 512),
        remat=case.get("remat", False), num_microbatches=case.get("M", 0),
        pipeline_schedule=case.get("schedule", "gpipe"),
        grad_clip_norm=case.get("clip", 0.0))


def _stacked(params):
    from tpu_bootstrap_torch.workload import pipeline

    params = _fresh(params)
    return {**params, "blocks": pipeline.stack_block_params(
        params["blocks"])}


def _whole(params, grads):
    """The whole gradient of every leaf from the rank's shards (every
    rank gathers; a collective)."""
    from tpu_bootstrap_torch.workload import sharding

    if isinstance(params, dict):
        return {k: _whole(params[k], grads[k]) for k in params}
    return sharding.full(sharding.like(params, grads)).clone()


def _pipe_case(case: dict, meshes: dict) -> dict:
    """One case of ``mesh_pipeline``: a pipelined loss (``value``), a
    grad function's loss, whole gradients and stats (``grad``), train steps
    (``train``), every stage on rank 0 alone (``one_device``) or a
    ``ValueError``'s message (``error``)."""
    import torch.distributed as dist

    from tpu_bootstrap_torch.workload import pipeline, sharding, train

    kind, cfg = case["kind"], _pipe_cfg(case)
    rank0 = dist.get_rank() == 0
    if kind == "one_device":
        if not rank0:
            return {}
        tokens = case["tokens"]
        loss, grads, stats = pipeline.pipeline_on_one_device(
            cfg, _stacked(case["params"]), tokens[:, :-1], tokens[:, 1:],
            stages=cfg.mesh.pipe)
        return {"loss": float(loss), "grads": grads, "stats": stats}
    mesh = _mesh_of(meshes, case["mesh"])
    if kind == "error":
        try:
            case_call = case["call"]
            if case_call == "init":
                train.init_train_state(cfg, seed=0, mesh=mesh)
            elif case_call == "step":
                train.make_train_step(cfg, mesh)
            else:
                make = {"loss": pipeline.make_pipeline_loss,
                        "1f1b": pipeline.make_pipeline_1f1b_grad}[case_call]
                fn = make(cfg, mesh, num_microbatches=case["M"])
                if "params" in case:
                    tokens = case["tokens"]
                    fn(_stacked(case["params"]), tokens[:, :-1],
                       tokens[:, 1:])
            return {"error": None}
        except ValueError as e:
            return {"error": str(e)}
    params = _stacked(case["params"])
    params = sharding.shard_params(params,
                                   sharding.param_shardings(mesh, params))
    tokens = case["tokens"]
    if kind == "train":
        opt_state = train.make_optimizer(cfg).init(params)
        step = train.make_train_step(cfg, mesh)
        losses = []
        for _ in range(case["steps"]):
            params, opt_state, loss = step(params, opt_state, tokens)
            losses.append(float(loss))
        return {"losses": losses}
    kw = dict(num_microbatches=case["M"], remat=cfg.remat)
    if kind == "value":
        loss = pipeline.make_pipeline_loss(cfg, mesh, **kw)(
            params, tokens[:, :-1], tokens[:, 1:])
        return {"loss": float(loss)}
    make = (pipeline.make_pipeline_1f1b_grad if cfg.pipeline_schedule
            == "1f1b" else pipeline.make_pipeline_grad)
    fn = make(cfg, mesh, **kw)
    loss, grads, stats = fn(params, tokens[:, :-1], tokens[:, 1:])
    whole = _whole(params, grads)
    return {"loss": float(loss), "stats": stats,
            "schedule": getattr(fn, "schedule", None),
            "grads": whole if rank0 else None}


def _worker(env: dict) -> dict:
    """train.worker_main with ``env`` on this world: the card's two seams
    stood in (the process group is the world's gloo group, and build_mesh
    lays its mesh on the CPU); what it printed and the pipeline schedules
    the steps were built with."""
    import contextlib
    import io

    from tpu_bootstrap_torch.workload import pipeline, sharding, train

    made, build, rendezvous = [], sharding.build_mesh, train.rendezvous
    make = pipeline.make_pipeline_step_grad

    def recorded(cfg, mesh, **kw):
        made.append((cfg.pipeline_schedule, cfg.num_microbatches))
        return make(cfg, mesh, **kw)

    saved = dict(os.environ)
    os.environ.update(env)
    sharding.build_mesh = lambda cfg, device_type=None: build(cfg, "cpu")
    train.rendezvous = lambda environ=None: True
    pipeline.make_pipeline_step_grad = recorded
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            train.worker_main()
    finally:
        os.environ.clear()
        os.environ.update(saved)
        sharding.build_mesh, train.rendezvous = build, rendezvous
        pipeline.make_pipeline_step_grad = make
    return {"printed": printed.getvalue(), "made": made}


def mesh_pipeline(inp: dict) -> dict:
    """tests/test_torch_pipeline.py and tests/test_torch_pipeline_1f1b.py:
    every case in order on this rank (``_pipe_case``), then a resume of
    train_loop (``resume``), worker_main (``worker``) and distillation
    (``distill``) where given."""
    from tpu_bootstrap_torch.workload import distill, model, train

    meshes, out = {}, {}
    for name, case in inp["cases"].items():
        out[name] = _pipe_case(case, meshes)
    if "resume" in inp:
        case, d = inp["resume"], Path(inp["dir"])
        cfg = _pipe_cfg(case)
        run = dict(device="cpu", mesh=_mesh_of(meshes, case["mesh"]))
        out["resume"] = {
            "full": train.train_loop(cfg, 4, checkpoint_dir=str(d / "full"),
                                     save_every=1, **run),
            "first": train.train_loop(cfg, 2,
                                      checkpoint_dir=str(d / "part"),
                                      save_every=1, **run),
            "resumed": train.train_loop(cfg, 4,
                                        checkpoint_dir=str(d / "part"),
                                        save_every=1, **run)}
    for name, env in inp.get("worker", {}).items():
        out[("worker", name)] = _worker(env)
    if "distill" in inp:
        case = inp["distill"]
        step, opt = distill.make_distill_step(
            model.ModelConfig(**case["student_model"]), case["teacher"],
            model.ModelConfig(**case["teacher_model"]),
            _mesh_of(meshes, case["mesh"]), learning_rate=case["lr"])
        student = _fresh(case["student"])
        opt_state = opt.init(student)
        out["distill"] = []
        for tokens in case["tokens"]:
            student, opt_state, loss = step(student, opt_state, tokens)
            out["distill"].append(float(loss))
    return out


PROGRAMS = {"mesh_train": mesh_train, "mesh_finetune": mesh_finetune,
            "file_resume": file_resume, "dtensor_matmul": dtensor_matmul,
            "ring": ring, "mesh_parallel": mesh_parallel,
            "mesh_pipeline": mesh_pipeline}


def dtensor_probe(timeout: float = 40.0) -> dict:
    """Why a mesh step computes on local tensors: the seconds one
    DTensor einsum takes on 8 gloo ranks over the three axes in use and
    over the reference's seven (axes of size 1 included), or None where
    the world did not finish within ``timeout``.

        python tests/test_torch_mesh_ranks.py --dtensor-probe
    """
    import tempfile

    out = {}
    for name, axes in (("3 axes", ("data", "fsdp", "tensor")),
                       ("7 axes", ("dcn", "pipe", "data", "fsdp", "expert",
                                   "seq", "tensor"))):
        with tempfile.TemporaryDirectory() as d:
            try:
                ranks = spawn_world("dtensor_matmul", 8, d, {"axes": axes},
                                    timeout=timeout)
                out[name] = max(r["einsum_s"] for r in ranks)
            except RuntimeError:
                out[name] = None
    return out


def _rank_main(program: str, rank: int, world: int, directory: str) -> None:
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store",
                            rank=rank, world_size=world)
    try:
        inp = torch.load(Path(directory) / "inputs.pt", weights_only=False)
        inp["dir"] = f"{directory}/shared"
        out = PROGRAMS[program](inp)
        torch.save(out, Path(directory) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "--dtensor-probe":
        sys.path.insert(0, str(ROOT))
        print(dtensor_probe())
    else:
        _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                   sys.argv[4])
