"""The multiprocess sharded-train dryrun, the counterpart of
``tpu_bootstrap/workload/dryrun_mp.py``: the full sharded train step
across OS processes at toy scale, rendezvoused from the JobSet's env.

The port drives one device a process, so the reference's 8-device
``data=2, fsdp=4`` mesh is 8 CPU processes (``run``), each started as
``python -m tpu_bootstrap_torch.workload.dryrun_mp`` with the env a
JobSet injects (``TPUBC_COORDINATOR_ADDRESS`` on a free loopback port,
``TPUBC_NUM_HOSTS=8``, ``JOB_COMPLETION_INDEX``). Each joins a gloo
process group through ``train.bootstrap_from_env``, runs ``STEPS``
sharded steps on the same step-addressed batches as a one-process run
and prints its loss, which equals ``reference_loss()``: a data-parallel
step's loss does not depend on the mesh. A worker that fails surfaces
with its stderr, and the rest are reaped.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent

TINY_MODEL = dict(vocab_size=128, num_layers=2, num_heads=4, head_dim=16,
                  embed_dim=64, mlp_dim=128, max_seq_len=32)
MESH = dict(data=2, fsdp=4)
STEPS = 2
PROCESSES = 8  # one device a process: the mesh's size
GRACE_S = 10  # after a failure, for the other workers to exit


def _config():
    from tpu_bootstrap_torch.workload.model import ModelConfig
    from tpu_bootstrap_torch.workload.sharding import MeshConfig
    from tpu_bootstrap_torch.workload.train import TrainConfig

    return TrainConfig(model=ModelConfig(**TINY_MODEL),
                       mesh=MeshConfig(**MESH))


def worker_main() -> None:
    """One of the processes: rendezvous from the JobSet env contract over
    gloo, run STEPS sharded steps, print the (whole batch's) loss."""
    import torch
    import torch.distributed as dist

    from tpu_bootstrap_torch.workload import sharding
    from tpu_bootstrap_torch.workload.train import (
        bootstrap_from_env,
        init_train_state,
        local_rows,
        make_train_step,
        synthetic_batch,
    )

    torch.set_num_threads(1)
    boot = bootstrap_from_env()
    assert boot is not None and boot["num_processes"] == PROCESSES, boot
    dist.init_process_group(
        "gloo", init_method=f"tcp://{boot['coordinator_address']}",
        world_size=boot["num_processes"], rank=boot["process_id"])
    try:
        cfg = _config()
        mesh = sharding.build_mesh(cfg.mesh, "cpu")
        params, opt_state = init_train_state(cfg, seed=0, mesh=mesh)
        step = make_train_step(cfg, mesh)
        for i in range(STEPS):
            rows = local_rows(synthetic_batch(cfg, i, 0), mesh)
            params, opt_state, loss = step(params, opt_state,
                                           sharding.place_rows(rows, mesh))
        print("DRYRUN_MP_LOSS", float(loss), flush=True)
    finally:
        dist.destroy_process_group()


def reference_loss() -> float:
    """The one-process result on the same global batches (the mesh's
    global batch size, every row on one device)."""
    import dataclasses

    from tpu_bootstrap_torch.workload.sharding import MeshConfig
    from tpu_bootstrap_torch.workload.train import (
        init_train_state,
        make_train_step,
        synthetic_batch,
    )

    cfg = _config()
    plain = dataclasses.replace(cfg, mesh=MeshConfig())
    params, opt_state = init_train_state(plain, seed=0, device="cpu")
    step = make_train_step(plain)
    for i in range(STEPS):
        params, opt_state, loss = step(params, opt_state,
                                       synthetic_batch(cfg, i, 0))
    return float(loss)


def run(env_overrides: dict | None = None, timeout: int = 600) -> list:
    """Spawn the PROCESSES workers; returns their losses. The env names
    and meanings are the JobSet's; ``env_overrides`` substitutes an
    emitted JobSet's env block (the coordinator stays on loopback)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = {"TPUBC_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "TPUBC_NUM_HOSTS": str(PROCESSES),
            "TPUBC_JOBSET_NAME": "dryrun-mp"}
    base.update(env_overrides or {})
    base["TPUBC_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    procs, outputs = [], []
    try:
        for idx in range(PROCESSES):
            env = {**os.environ, **base, "JOB_COMPLETION_INDEX": str(idx),
                   "OMP_NUM_THREADS": "1"}
            # Files, not pipes: the workers wait on each other's
            # collectives, and one blocked on a full pipe would stall all.
            out_f, err_f = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            outputs.append((out_f, err_f))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __spec__.name], env=env,
                cwd=str(REPO), stdout=out_f, stderr=err_f))
        _wait_all(procs, timeout)
        # The first worker (by index) that failed is the one reported;
        # the others get a moment to fail or finish on their own.
        grace = time.monotonic() + GRACE_S
        for p in procs:
            try:
                p.wait(timeout=max(grace - time.monotonic(), 0))
            except subprocess.TimeoutExpired:
                pass
        for idx, p in enumerate(procs):
            if p.returncode not in (None, 0):
                outputs[idx][1].seek(0)
                raise RuntimeError(
                    f"dryrun_mp worker {idx} failed:\n"
                    f"{outputs[idx][1].read().decode()[-3000:]}")
        losses = []
        for out_f, _ in outputs:
            out_f.seek(0)
            line = [ln for ln in out_f.read().decode().splitlines()
                    if ln.startswith("DRYRUN_MP_LOSS")][0]
            losses.append(float(line.split()[1]))
        return losses
    finally:
        # A worker that failed leaves the others blocked in collectives
        # against it: kill every one still running on any way out.
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out_f, err_f in outputs:
            out_f.close()
            err_f.close()


def _wait_all(procs: list, timeout: float) -> None:
    """Wait until every process has exited or one has failed, at most
    ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if any(p.returncode not in (None, 0) for p in procs):
            return
        if time.monotonic() > deadline:
            raise subprocess.TimeoutExpired("dryrun_mp workers", timeout)
        time.sleep(0.05)


if __name__ == "__main__":
    worker_main()
