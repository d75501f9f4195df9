"""The port's own small metrics registry and span recorder.

A copy of the subset of ``tpu_bootstrap.telemetry`` the port records
(that module is framework-free, but the port imports nothing of the JAX
package): named counters and gauges, fixed-bucket histograms, and
``span`` timing, the train loop's heartbeat, the MFU denominator and the
host-link rate the paged engine prices swaps with. Names are the
reference's, so a scrape of either package reads the same keys:
``quant_<kernel>_{calls,weight_bytes,activation_bytes,bytes}_total`` from
the quantized matmul seam, the ``kv_blocks_*`` pool gauges, the ``serve_*``
scheduler gauges (labelled series rendered ``name{k="v"}``) and the train
loop's ``workload_*`` gauges.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque

DEFAULT_BUCKETS = (1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
                   10000)


class _Histogram:
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        while i < len(self.bounds) and value > self.bounds[i]:
            i += 1
        self.counts[i] += 1
        self.sum += value
        self.count += 1

def _label_key(name: str, labels) -> str:
    """A labelled series' key, rendered as the reference renders it:
    ``name{k="v",...}`` with the keys sorted; no labels keep the bare
    name."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Counters, gauges and histograms (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: dict = {}      # guarded-by: _lock
        self._histograms: dict = {}  # guarded-by: _lock

    def inc(self, name: str, delta=1, labels=None) -> None:
        name = _label_key(name, labels)
        with self._lock:
            self._values[name] = self._values.get(name, 0) + delta

    def set_gauge(self, name: str, value) -> None:
        with self._lock:
            self._values[name] = value

    def observe(self, name: str, value: float, buckets=None,
                labels=None) -> None:
        """Record one observation; ``buckets`` fixes the bounds on the
        histogram's first observation."""
        name = _label_key(name, labels)
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = _Histogram(
                    buckets or DEFAULT_BUCKETS)
            h.observe(value)

    def to_json(self) -> dict:
        """Values by name; histograms as ``_count``/``_sum``."""
        with self._lock:
            out = dict(sorted(self._values.items()))
            for name in sorted(self._histograms):
                h = self._histograms[name]
                out[name + "_count"] = h.count
                out[name + "_sum"] = h.sum
            return out

    def reset(self) -> None:
        with self._lock:
            self._values.clear()
            self._histograms.clear()


_metrics = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-wide registry."""
    return _metrics


_spans: deque = deque(maxlen=4096)


def monotonic() -> float:
    """Monotonic seconds: the clock of queue waits and resume gaps."""
    return time.monotonic()


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a block on the host clock and keep the record in a bounded
    ring (``spans()``). Yields the record, whose ``dur_ms`` is set when the
    block exits. The caller synchronises the device inside the block where
    the span must cover device work."""
    rec = {"name": name, **attrs}
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        rec["dur_ms"] = (time.perf_counter() - t0) * 1e3
        _spans.append(rec)


def spans() -> list:
    return list(_spans)


# The denominator of workload_train_mfu, as in the reference: the operator
# sets it with TPUBC_PEAK_TFLOPS; otherwise it follows the card's name.
PEAK_TFLOPS_ENV = "TPUBC_PEAK_TFLOPS"
# Dense bf16 tensor-core peak of the H100 SXM (NVIDIA's data sheet). The
# PCIe and NVL parts run lower and are not assumed.
H100_SXM_BF16_TFLOPS = 989.0


def peak_tflops() -> float | None:
    """bf16 peak TFLOP/s of the card the port runs on: TPUBC_PEAK_TFLOPS
    when set, else the H100 SXM's when CUDA reports one, else None (an
    unknown part, or no card: no MFU is computed)."""
    try:
        return float(os.environ[PEAK_TFLOPS_ENV])
    except (KeyError, ValueError):
        pass
    import torch

    if torch.cuda.is_available():
        name = torch.cuda.get_device_name()
        if "H100" in name and "PCIe" not in name and "NVL" not in name:
            return H100_SXM_BF16_TFLOPS
    return None


# Host<->device transfer rate, GB/s: the seed of the paged engine's swap
# arm until it has timed a transfer of its own (the reference's name;
# TPUBC_HOST_XFER_GBPS overrides). The default is not the reference's TPU
# host figure: it is the rate chip_smoke.py's serve_host_tier phase
# measured for one pool block of the decode model (278,528 bytes in 32
# tensors) restored host to device on an NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit (PERF.md section 6).
HOST_XFER_ENV = "TPUBC_HOST_XFER_GBPS"
DEFAULT_HOST_XFER_GBPS = 0.27


def host_xfer_gbps() -> float:
    try:
        return float(os.environ.get(HOST_XFER_ENV, DEFAULT_HOST_XFER_GBPS))
    except ValueError:
        return DEFAULT_HOST_XFER_GBPS


# Train-loop heartbeat: the step loop stamps (step, monotonic time) after
# every step, so a wedged loop can be told from a slow one.
_beat_lock = threading.Lock()
_beat = {"t": None, "step": None}  # guarded-by: _beat_lock


def heartbeat(step: int | None = None) -> None:
    """Stamp liveness (the train step loop)."""
    with _beat_lock:
        _beat["t"] = time.monotonic()
        if step is not None:
            _beat["step"] = step


def record_kv_block_pool(total: int, used: int, free: int,
                         capacity_tokens: int, live_tokens: int,
                         peak_used: int, compactness: float,
                         cached: int = 0) -> None:
    """Block-pool gauges of the paged engine (reference names). ``used``
    counts live blocks; ``cached`` the prefix cache's zero-reference
    blocks (kv_blocks_cached), which ride in ``free``: reclaimable, not
    pressure."""
    reg = _metrics
    reg.set_gauge("kv_blocks_capacity", total)
    reg.set_gauge("kv_blocks_used", used)
    reg.set_gauge("kv_blocks_free", free)
    reg.set_gauge("kv_blocks_cached", cached)
    if total > 0:
        reg.set_gauge("kv_blocks_used_frac", round(used / total, 4))
        reg.set_gauge("kv_blocks_peak_frac", round(peak_used / total, 4))
    if capacity_tokens > 0:
        reg.set_gauge("kv_block_internal_frag",
                      round(1.0 - live_tokens / capacity_tokens, 4))
    reg.set_gauge("kv_blocks_compactness", round(compactness, 4))


def record_scheduler(queue_depth: int, expected_new: float, submitted: int,
                     admitted: int, preemptions: int) -> None:
    """Scheduler gauges (reference names): the waiting queue's depth, the
    expected-generated-length EMA overcommit admission reserves by, the
    admitted-over-submitted ratio and the pool's preemption count."""
    reg = _metrics
    reg.set_gauge("serve_sched_queue_depth", queue_depth)
    reg.set_gauge("serve_expected_new", round(float(expected_new), 2))
    if submitted > 0:
        reg.set_gauge("serve_admitted_ratio", round(admitted / submitted, 4))
    reg.set_gauge("serve_preemptions", preemptions)
