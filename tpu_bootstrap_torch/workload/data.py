"""Input pipeline for the port's training loop, the counterpart of
``tpu_bootstrap/workload/data.py``: memory-mapped token shards cut into
non-overlapping ``seq_len`` windows, read in a seeded permuted order
addressed by step (so a resume replays exactly the batches an
uninterrupted run would have seen), and a background thread that stages
the next batch while the current step runs.

The order is the reference's numpy permutation, so both packages read the
same batches byte for byte. On a mesh every rank computes the same global
order but reads only its rows (``host_rows``: its coordinate over the
batch axes), and the step's batch is the DTensor of those rows.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    path: str  # flat binary token file
    dtype: str = "uint16"  # token storage dtype (uint16 covers vocab < 65536)
    seed: int = 0


class TokenDataset:
    """Non-overlapping seq_len windows over a memory-mapped token file, in
    a seeded permuted order, addressable by (epoch-folded) step."""

    def __init__(self, cfg: DataConfig, seq_len: int):
        self.tokens = np.memmap(cfg.path, dtype=np.dtype(cfg.dtype), mode="r")
        self.seq_len = seq_len
        self.num_windows = len(self.tokens) // seq_len
        if self.num_windows < 1:
            raise ValueError(
                f"{cfg.path}: {len(self.tokens)} tokens is shorter than one "
                f"window of {seq_len}")
        self.perm = np.random.default_rng(cfg.seed).permutation(self.num_windows)

    def batch(self, step: int, batch_size: int, *,
              rows: slice | None = None) -> np.ndarray:
        """The global batch for ``step`` (or its ``rows`` sub-slice):
        (batch_size | len(rows), seq_len) int32, wrapping around the
        permutation at epoch boundaries."""
        if batch_size > self.num_windows:
            raise ValueError(
                f"batch size {batch_size} exceeds the file's {self.num_windows} "
                f"windows of {self.seq_len} tokens — every batch would repeat rows")
        idx = (step * batch_size + np.arange(batch_size)) % self.num_windows
        win = self.perm[idx]
        if rows is not None:
            win = win[rows]
        starts = win * self.seq_len
        gather = starts[:, None] + np.arange(self.seq_len)[None, :]
        return np.asarray(self.tokens[gather], dtype=np.int32)


def host_rows(batch_size: int, process_index: int | None = None,
              process_count: int | None = None) -> slice:
    """This process's contiguous row range of the global batch. The
    defaults are the rank's data-parallel coordinate on the mesh
    ``sharding.build_mesh`` made last and the data-parallel degree (0 of 1
    without one), so ranks that differ only along ``tensor`` read the same
    rows. The batch must divide evenly."""
    from tpu_bootstrap_torch.workload import sharding

    p, n = sharding.dp_coordinate(sharding.current_mesh())
    p = p if process_index is None else process_index
    n = n if process_count is None else process_count
    if batch_size % n != 0:
        raise ValueError(f"batch size {batch_size} must divide over {n} hosts")
    per = batch_size // n
    return slice(p * per, (p + 1) * per)


def make_batch_fn(cfg: DataConfig, seq_len: int, batch_size: int, device,
                  mesh=None):
    """step -> (batch_size, seq_len) int64 token tensor on ``device``; on
    ``mesh``, the rank reads only its rows and the batch is their DTensor
    (Shard(0) over the batch axes)."""
    from tpu_bootstrap_torch.workload import sharding

    ds = TokenDataset(cfg, seq_len)
    rows = host_rows(batch_size, *sharding.dp_coordinate(mesh))

    def get(step: int) -> torch.Tensor:
        local = torch.from_numpy(ds.batch(step, batch_size, rows=rows)).to(
            device=device, dtype=torch.long)
        return local if mesh is None else sharding.place_rows(local, mesh)

    return get


def prefetched(batch_fn, start: int, stop: int, depth: int = 2):
    """Iterate (step, batch_fn(step)) for start..stop with a background
    thread staging ``depth`` batches ahead. Exceptions in the worker
    surface on the consuming side; an abandoned iterator unblocks and joins
    the worker."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    cancel = threading.Event()
    _END, _ERR = object(), object()

    def offer(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for step in range(start, stop):
                if not offer((step, batch_fn(step))):
                    return
            offer(_END)
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer side
            offer((_ERR, e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, tuple) and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        cancel.set()
        while not q.empty():  # drop staged batches so the worker can exit
            q.get_nowait()
        t.join()


def write_token_file(path, tokens, dtype: str = "uint16") -> None:
    """Persist a token sequence as the flat binary format TokenDataset
    reads."""
    np.asarray(tokens).astype(np.dtype(dtype)).tofile(path)


__all__ = ["DataConfig", "TokenDataset", "host_rows", "make_batch_fn",
           "prefetched", "write_token_file"]
