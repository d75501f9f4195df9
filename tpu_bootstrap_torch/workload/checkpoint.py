"""Checkpoint/resume for the port's training loop, the counterpart of
``tpu_bootstrap/workload/checkpoint.py`` with the same ``make_manager`` /
``save`` / ``restore`` / ``latest_step`` surface, in a native torch format.

Each step is a directory ``<step>/`` holding ``state.pt`` (``torch.save``
of ``{"params": ..., "opt_state": ...}``). A save writes into a hidden
temporary directory and renames it into place, so a half-written save is
never a step ``latest_step`` can return; then all but the newest
``max_to_keep`` steps are deleted. Saves are synchronous. The
``ckpt.save`` fault seam fires before anything is written. The port does
not read the reference's orbax checkpoints.

State placed on a mesh (DTensor leaves) is gathered to whole tensors on
every rank and rank 0 writes the same file a one-device run writes, while
every rank waits at a barrier; ``restore`` with a mesh places each leaf
by ``sharding.param_shardings`` (an optimizer moment as its param). So a
checkpoint written on a mesh resumes on one device, and the other way
round.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from tpu_bootstrap_torch.workload import faults, quant
from tpu_bootstrap_torch.workload.model import resolve_device

STATE_FILE = "state.pt"


@dataclasses.dataclass(frozen=True)
class CheckpointManager:
    directory: Path
    max_to_keep: int = 3


def make_manager(directory: str, max_to_keep: int = 3) -> CheckpointManager:
    path = Path(directory)
    path.mkdir(parents=True, exist_ok=True)
    return CheckpointManager(path, max_to_keep)


def steps(mgr: CheckpointManager) -> list:
    """The complete saved steps, ascending."""
    return sorted(int(p.name) for p in mgr.directory.iterdir()
                  if p.name.isdigit() and (p / STATE_FILE).is_file())


def latest_step(mgr: CheckpointManager):
    found = steps(mgr)
    return found[-1] if found else None


def _gathered(tree):
    from tpu_bootstrap_torch.workload import sharding

    if isinstance(tree, dict):
        return {k: _gathered(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_gathered(v) for v in tree]
    if isinstance(tree, torch.Tensor) or quant.is_quantized(tree):
        return sharding.gather(tree)
    return tree


def _placed(tree) -> bool:
    from tpu_bootstrap_torch.workload import sharding
    from tpu_bootstrap_torch.workload.train import tree_leaves

    return any(sharding.is_placed(t) for t in tree_leaves(tree))


def save(mgr: CheckpointManager, step: int, params, opt_state) -> None:
    # Injected write failure (a full disk): nothing is written, so the
    # previous checkpoint stays the latest.
    faults.fire("ckpt.save")
    placed = _placed(params)
    if placed:
        params, opt_state = _gathered(params), _gathered(opt_state)
        if dist.get_rank() != 0:
            dist.barrier()
            return
    try:
        _write(mgr, step, params, opt_state)
    finally:
        if placed:
            dist.barrier()


def _write(mgr: CheckpointManager, step: int, params, opt_state) -> None:
    final = mgr.directory / str(step)
    tmp = Path(tempfile.mkdtemp(prefix=f".{step}-", dir=mgr.directory))
    try:
        torch.save({"params": params, "opt_state": opt_state},
                   tmp / STATE_FILE)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old in steps(mgr)[:-mgr.max_to_keep]:
        shutil.rmtree(mgr.directory / str(old))


def restore(mgr: CheckpointManager, step: int, device=None,
            mesh=None) -> tuple:
    """(params, opt_state) saved at ``step``, loaded onto ``device``
    (None: the card), or read on every rank of ``mesh`` and placed by
    ``sharding.param_shardings`` (each optimizer moment as its param)."""
    from tpu_bootstrap_torch.workload import sharding

    if mesh is not None:
        from tpu_bootstrap_torch.workload.train import (mesh_device,
                                                        tree_leaves)

        device = mesh_device(mesh)
    state = torch.load(mgr.directory / str(step) / STATE_FILE,
                       map_location=resolve_device(device), weights_only=True)
    params, opt_state = state["params"], state["opt_state"]
    if mesh is None:
        return params, opt_state
    shardings = sharding.param_shardings(mesh, params)
    params = sharding.shard_params(params, shardings)
    per_leaf = tree_leaves(shardings)
    for key in ("mu", "nu"):
        opt_state[key] = [sharding.shard_params(m, sh)
                          for m, sh in zip(opt_state[key], per_leaf)]
    return params, opt_state


__all__ = ["make_manager", "save", "restore", "latest_step", "steps"]
