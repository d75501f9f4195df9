"""The port's own small metrics registry and span tracer.

A copy of the subset of ``tpu_bootstrap.telemetry`` the port records
(that module is framework-free, but the port imports nothing of the JAX
package): named counters and gauges, fixed-bucket histograms, the
injectable monotonic clock (``set_clock``), the span ``Tracer`` that
``span`` and the serving request log record into, ``RateWindow``, the
train loop's heartbeat, the MFU denominator and the host-link rate the
paged engine prices swaps with. Names are the reference's, so a scrape of
either package reads the same keys:
``quant_<kernel>_{calls,weight_bytes,activation_bytes,bytes}_total`` from
the quantized matmul seam, the ``kv_blocks_*`` pool gauges, the ``serve_*``
scheduler gauges (labelled series rendered ``name{k="v"}``) and the train
loop's ``workload_*`` gauges.
"""

from __future__ import annotations

import contextlib
import os
import secrets
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass, field

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

    def set_gauge(self, name: str, value, labels=None) -> None:
        name = _label_key(name, labels)
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


_WALL_BASE_US = int(time.time() * 1e6)
_MONO_BASE_NS = time.monotonic_ns()

# The one injectable monotonic clock the serving timings read (queue
# waits, deadlines, resume gaps, request-event stamps). None is the real
# time.monotonic; tests install a virtual clock to pin every such read.
_CLOCK = None


def set_clock(fn) -> None:
    """Install an injected monotonic clock (a callable returning seconds),
    or restore the real one with ``set_clock(None)``."""
    global _CLOCK
    _CLOCK = fn


def monotonic() -> float:
    """Monotonic seconds from the injectable clock."""
    fn = _CLOCK
    return time.monotonic() if fn is None else fn()


def now_us() -> int:
    """Wall-aligned monotonic microseconds: a wall base taken once plus
    monotonic deltas; under an injected clock, its time in microseconds."""
    fn = _CLOCK
    if fn is not None:
        return int(fn() * 1e6)
    return _WALL_BASE_US + (time.monotonic_ns() - _MONO_BASE_NS) // 1000


def new_trace_id() -> str:
    return secrets.token_hex(8)


def new_span_id() -> str:
    return secrets.token_hex(8)


@dataclass
class Span:
    trace_id: str
    span_id: str
    parent_id: str
    name: str
    start_us: int
    dur_us: int = 0
    attrs: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "start_us": self.start_us, "dur_us": self.dur_us,
                "attrs": dict(self.attrs)}


class Tracer:
    """Bounded in-process span buffer (thread-safe): ``TPUBC_TRACE_BUFFER``
    spans (default 4096), the oldest evicted and counted in ``dropped``."""

    def __init__(self, process: str = "tpu-bootstrap-workload",
                 capacity: int | None = None):
        if capacity is None:
            try:
                capacity = int(os.environ.get("TPUBC_TRACE_BUFFER", "4096"))
            except ValueError:
                capacity = 4096
        self.process = process
        self.capacity = max(capacity, 1)
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=self.capacity)  # guarded-by: _lock
        self.dropped = 0  # guarded-by: _lock

    def record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self.capacity:
                self.dropped += 1
            self._spans.append(span)

    def add_span(self, name: str, start_us: int, dur_us: int, *,
                 trace_id: str = "", parent_id: str = "", **attrs) -> Span:
        """Record a span after the fact (a serving request, whose start is
        known to be a span's only once it retires)."""
        span = Span(trace_id or root_trace_id(), new_span_id(), parent_id,
                    name, start_us, max(int(dur_us), 0),
                    {k: str(v) for k, v in attrs.items()})
        self.record(span)
        return span

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def to_json(self) -> dict:
        """The daemons' /traces.json shape; the spans and the drop count
        are read under one lock hold."""
        with self._lock:
            spans = list(self._spans)
            dropped = self.dropped
        return {"process": self.process, "dropped": dropped,
                "spans": [s.to_dict() for s in spans]}

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON, one row per trace id."""
        pid = os.getpid()
        events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                   "args": {"name": self.process}}]
        for s in self.spans():
            args = {"trace_id": s.trace_id, "span_id": s.span_id,
                    "parent_id": s.parent_id}
            args.update(s.attrs)
            events.append({"name": s.name, "cat": self.process, "ph": "X",
                           "ts": s.start_us, "dur": s.dur_us, "pid": pid,
                           "tid": _chrome_tid(s.trace_id), "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


def _chrome_tid(trace_id: str) -> int:
    if not trace_id:
        return 0
    # Stable across processes (str hashes are salted per process).
    return zlib.crc32(trace_id.encode()) & 0x7FFFFFFF


_tracer = Tracer()
_tls = threading.local()
_root_id: str | None = None


def tracer() -> Tracer:
    return _tracer


def root_trace_id() -> str:
    """The trace id spans root under: the propagated TPUBC_TRACE_ID, else
    a per-process random id."""
    global _root_id
    if _root_id is None:
        _root_id = os.environ.get("TPUBC_TRACE_ID", "") or new_trace_id()
    return _root_id


def current() -> Span | None:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


_spans: deque = deque(maxlen=4096)


@contextlib.contextmanager
def span(name: str, **attrs):
    """Time a block on the host clock. Yields a record dict, whose
    ``dur_ms`` is set when the block exits, kept in a bounded ring
    (``spans()``); the block is also a ``Span`` in the ``tracer()``,
    parented under the enclosing span of this thread. The caller
    synchronises the device inside the block where the span must cover
    device work."""
    rec = {"name": name, **attrs}
    parent = current()
    if parent is not None:
        tid, pid = parent.trace_id, parent.span_id
    else:
        tid, pid = root_trace_id(), ""
    s = Span(tid, new_span_id(), pid, name, now_us(),
             attrs={k: str(v) for k, v in attrs.items()})
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(s)
    t0 = time.perf_counter()
    t0_ns = time.monotonic_ns()
    try:
        yield rec
    finally:
        rec["dur_ms"] = (time.perf_counter() - t0) * 1e3
        _spans.append(rec)
        s.dur_us = (time.monotonic_ns() - t0_ns) // 1000
        stack.pop()
        _tracer.record(s)


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


def record_peak_provenance() -> None:
    """Publish the MFU and swap-price denominators and where they came
    from (1: the environment, 0: the built-in default). Without a known
    peak (no card, an unknown part) ``serve_peak_tflops`` is not set."""
    reg = _metrics
    peak = peak_tflops()
    if peak is not None:
        reg.set_gauge("serve_peak_tflops", peak)
    reg.set_gauge("serve_peak_tflops_from_env",
                  int(PEAK_TFLOPS_ENV in os.environ))
    reg.set_gauge("serve_host_xfer_gbps", host_xfer_gbps())
    reg.set_gauge("serve_host_xfer_gbps_from_env",
                  int(HOST_XFER_ENV in os.environ))


class RateWindow:
    """A rolling event rate: ``add`` counts events, ``per_sec`` reads
    events a second over the trailing window. Memory is bounded by the
    events in the window."""

    def __init__(self, window_secs: float = 60.0):
        self.window = window_secs
        self._lock = threading.Lock()
        self._events = deque()  # (t, weight)  # guarded-by: _lock

    def add(self, weight: float = 1.0, t: float | None = None) -> None:
        t = time.monotonic() if t is None else t
        with self._lock:
            self._events.append((t, weight))
            self._trim_locked(t)

    def per_sec(self, t: float | None = None) -> float:
        t = time.monotonic() if t is None else t
        with self._lock:
            self._trim_locked(t)
            return sum(w for _, w in self._events) / self.window

    def _trim_locked(self, t: float) -> None:
        cutoff = t - self.window
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()


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
