"""The port's own small metrics registry and span recorder.

A copy of the subset of ``tpu_bootstrap.telemetry`` the port records
(that module is framework-free, but the port imports nothing of the JAX
package): named counters and gauges, fixed-bucket histograms, and
``span`` timing. Names are the reference's, so a scrape of either
package reads the same keys: ``quant_<kernel>_{calls,weight_bytes,
activation_bytes,bytes}_total`` from the quantized matmul seam, the
``kv_blocks_*`` pool gauges and the ``serve_*`` scheduler gauges.
"""

from __future__ import annotations

import contextlib
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


class MetricsRegistry:
    """Counters, gauges and histograms (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values: dict = {}      # guarded-by: _lock
        self._histograms: dict = {}  # guarded-by: _lock

    def inc(self, name: str, delta=1) -> None:
        with self._lock:
            self._values[name] = self._values.get(name, 0) + delta

    def set_gauge(self, name: str, value) -> None:
        with self._lock:
            self._values[name] = value

    def observe(self, name: str, value: float, buckets=None) -> None:
        """Record one observation; ``buckets`` fixes the bounds on the
        histogram's first observation."""
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


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a block on the host clock and keep the record in a bounded
    ring (``spans()``). The caller synchronises the device inside the
    block where the span must cover device work."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _spans.append({"name": name,
                       "dur_ms": (time.perf_counter() - t0) * 1e3,
                       **attrs})


def spans() -> list:
    return list(_spans)


def record_kv_block_pool(total: int, used: int, free: int,
                         capacity_tokens: int, live_tokens: int,
                         peak_used: int, compactness: float) -> None:
    """Block-pool gauges of the paged engine (reference names)."""
    reg = _metrics
    reg.set_gauge("kv_blocks_capacity", total)
    reg.set_gauge("kv_blocks_used", used)
    reg.set_gauge("kv_blocks_free", free)
    if total > 0:
        reg.set_gauge("kv_blocks_used_frac", round(used / total, 4))
        reg.set_gauge("kv_blocks_peak_frac", round(peak_used / total, 4))
    if capacity_tokens > 0:
        reg.set_gauge("kv_block_internal_frag",
                      round(1.0 - live_tokens / capacity_tokens, 4))
    reg.set_gauge("kv_blocks_compactness", round(compactness, 4))


def record_scheduler(queue_depth: int, submitted: int,
                     admitted: int) -> None:
    """Scheduler gauges (reference names, without the overcommit EMA)."""
    reg = _metrics
    reg.set_gauge("serve_sched_queue_depth", queue_depth)
    if submitted > 0:
        reg.set_gauge("serve_admitted_ratio", round(admitted / submitted, 4))
