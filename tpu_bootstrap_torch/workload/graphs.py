"""CUDA graphs of the decode loops: the port's counterpart of the
reference's compiled scans (``jax.jit`` of a ``lax.scan`` over one decode
step: ``serving._paged_chunk_kernel`` and ``decode.generate``).

A ``StepGraphs`` belongs to one owner (a ``PagedPool``, or one call of
``generate``) and holds one captured decode STEP per key (the pool's table
width ``nb``; ``generate`` has one key). The step reads and advances static
buffers its owner keeps -- the tokens, the positions, a step counter and the
output that each step writes its token into (``commit``) -- so a chunk of n
steps is n launches of the graph and one host read of the output.

* The first step of a key runs eagerly on a side stream: the warm-up that
  builds the kernel library and runs every lazy set-up of the C entries
  (function attributes, the driver's tensor-map encoder, the tensor maps of
  the weights) and of the libraries the step calls, before any capture.
* Then the step is captured with ``torch.cuda.graph`` into a memory pool
  that every graph of the owner shares (``torch.cuda.graph_pool_handle``):
  the replays run one after another on one stream, so their scratch may
  share memory. Whatever the step allocates lives in that pool as long as
  the graph; the tensors it reads (weights, KV pools, static buffers) must
  keep their addresses, which is why every write the step and its owner
  make to them is in place.
* Every later step is a replay.

Launch counts stay honest: a capture runs the kernel wrappers' Python,
which adds to ``kernels.LAUNCHES`` for launches that never ran, and a
replay runs no Python. So the launches counted during a capture are taken
back out and added again on every replay.

A capture or a replay that fails raises; nothing falls back to the eager
loop. ``for_device`` gives no graphs for a CPU device, where the owners run
their eager loops.
"""

from __future__ import annotations

import time

import torch

from tpu_bootstrap_torch.workload import kernels


def commit(nxt: torch.Tensor, tok: torch.Tensor, pos: torch.Tensor,
           out: torch.Tensor, step: torch.Tensor) -> None:
    """The end of a captured step, in place: token ``nxt`` (B,) into
    column ``step`` (a (1,) device counter) of ``out`` (B, C), then it
    becomes the next step's input ``tok``, and ``pos`` and ``step``
    advance by one."""
    out.index_copy_(1, step, nxt[:, None])
    tok.copy_(nxt)
    pos.add_(1)
    step.add_(1)


class _CudaGraphs:
    """The CUDA side of ``StepGraphs``: a side stream for the warm-up and
    the captures, and the memory pool all of the owner's graphs share."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()

    def warm_up(self, body) -> None:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            body()
        current.wait_stream(self.stream)

    def capture(self, body):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            body()
        return graph

    @staticmethod
    def replay(graph) -> None:
        graph.replay()


class StepGraphs:
    """One owner's captured steps, by key. ``backend`` does the CUDA work
    (``warm_up``, ``capture``, ``replay``); tests stand a CPU one in."""

    def __init__(self, backend):
        self._backend = backend
        self._graphs: dict = {}
        self._launches: dict = {}  # key -> launches one replay makes
        self.stats = {"captured": 0, "capture_s": 0.0, "replays": 0}

    def run(self, key, body, steps: int) -> None:
        """``steps`` steps of ``body`` (a function of no arguments that
        advances its owner's static buffers): a replay each, except that
        the first step of a key not seen yet is the eager warm-up and is
        followed by the capture."""
        graph = self._graphs.get(key)
        if graph is None and steps > 0:
            self._backend.warm_up(body)
            graph = self._capture(key, body)
            steps -= 1
        for _ in range(steps):
            self._backend.replay(graph)
            for name, n in self._launches[key].items():
                kernels.LAUNCHES[name] += n
        self.stats["replays"] += max(steps, 0)

    def _capture(self, key, body):
        before = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        try:
            graph = self._backend.capture(body)
        finally:
            delta = {name: kernels.LAUNCHES[name] - n
                     for name, n in before.items()}
            kernels.LAUNCHES.update(before)
        self.stats["capture_s"] += time.perf_counter() - t0
        self.stats["captured"] += 1
        self._graphs[key] = graph
        self._launches[key] = {name: n for name, n in delta.items() if n}
        return graph


def for_device(device: torch.device) -> StepGraphs | None:
    """The graphs of a new owner on ``device``: None off the card, where
    the owner runs its eager loop."""
    if device.type != "cuda":
        return None
    return StepGraphs(_CudaGraphs(device))
