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
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from pathlib import Path

import torch

from tpu_bootstrap_torch.workload import faults
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


def save(mgr: CheckpointManager, step: int, params, opt_state) -> None:
    # Injected write failure (a full disk): nothing is written, so the
    # previous checkpoint stays the latest.
    faults.fire("ckpt.save")
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


def restore(mgr: CheckpointManager, step: int, device=None) -> tuple:
    """(params, opt_state) saved at ``step``, loaded onto ``device``
    (None: the card)."""
    state = torch.load(mgr.directory / str(step) / STATE_FILE,
                       map_location=resolve_device(device), weights_only=True)
    return state["params"], state["opt_state"]


__all__ = ["make_manager", "save", "restore", "latest_step", "steps"]
